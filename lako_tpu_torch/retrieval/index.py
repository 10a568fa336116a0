"""Dense inner-product top-k with the corpus on the device: the port of
lako_tpu/retrieval/index.py.

At LaKo scale (300,600 x 256 float32, about 300 MB) the corpus fits on one
card, so search is a matmul and a top-k per query batch, over corpus chunks
with a running top-k merge (peak memory (Q, chunk) instead of (Q, N)).
Small-range re-rank rescores each example's own candidates.

Ties. ``lax.top_k`` puts equal scores lowest index first, and the JAX merge
concatenates ``[best, chunk]``, so across chunks too the lower row wins;
duplicate sentences in a real corpus give exactly equal scores, and the
boundary of the k kept can fall inside such a group. ``torch.topk``
promises no order among ties, so the top-k here runs on an int64 key per
score: the float32's bits mapped to an int32 of the same order (the total
order ``lax.top_k`` uses: -0.0 below +0.0), shifted up 32 bits, plus
``2**32 - 1 - row``. The keys are distinct, so ``torch.topk`` on them is
exact and deterministic on any device, and gives the JAX ids, ties
included. A top-k over int64 keys costs ~4x one over the float32 scores on
the card (``chip_smoke.py``), so each chunk first takes a float32 top-k and
only rows whose k-th score is tied past the k kept take the keys of the
whole row (:func:`chunk_top_keys`); the running merge is on keys.

Precision. ``"exact"`` and ``rerank`` compute their products in full
float32 on the card whatever the caller set for TF32 (the JAX package pins
``Precision.HIGHEST``). ``"fast"`` is the TPU's default precision there,
bfloat16 inputs with float32 accumulation: on the card the operands are
rounded to bfloat16 and multiplied on the TF32 tensor cores, which hold a
bfloat16 value exactly and accumulate in float32. On the CPU, as in XLA's
CPU default, ``"fast"`` is float32 and equals ``"exact"``. ``"approx"`` is
``lax.approx_max_k``, a TPU operation that returns the exact top-k on
other backends: here it is ``"fast"``'s scores with the same exact,
tie-ordered top-k, and takes no ``recall_target``.

Differences on purpose: the corpus is float32 on the device (the JAX
constructor's storage ``dtype`` is not taken), and ``ShardedDenseIndex``
raises until more than one device is ported (ROADMAP item 12).
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from lako_tpu_torch.core.device import resolve_device

Device = Optional[Union[str, torch.device]]
_LOW32 = 0xFFFFFFFF


@contextlib.contextmanager
def matmul_precision(mode: str):
    """cuBLAS float32 products in ``mode`` ("ieee": full float32, or "tf32")
    for the duration, whatever the caller set; the caller's setting is
    restored after. Uses the API the caller's torch has."""
    m = torch.backends.cuda.matmul
    if hasattr(m, "fp32_precision"):
        prev = m.fp32_precision
        m.fp32_precision = mode
        try:
            yield
        finally:
            m.fp32_precision = prev
    else:
        prev = m.allow_tf32
        m.allow_tf32 = mode == "tf32"
        try:
            yield
        finally:
            m.allow_tf32 = prev


def _keys(scores: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    bits = scores.contiguous().view(torch.int32)
    mono = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return mono.to(torch.int64) * (1 << 32) + (_LOW32 - rows)


def tie_keys(scores: torch.Tensor, first_row: int) -> torch.Tensor:
    """(Q, c) float32 scores of rows ``first_row..`` → int64 keys whose
    descending order is score descending, then row ascending."""
    return _keys(scores, torch.arange(first_row, first_row + scores.shape[1],
                                      device=scores.device))


def chunk_top_keys(scores: torch.Tensor, first_row: int, k: int) -> torch.Tensor:
    """The keys of each row's ``k`` best scores in a chunk (unordered), ties
    at the k-th score resolved to the lowest rows.

    A float32 top-k picks the k, and one pass counts the scores at or above
    the k-th: where that count is k, no tie crosses the boundary and the k
    are the row's exact k best. Only the rows where it is larger (equal
    scores at the boundary, or a -0.0/+0.0 pair, which compare equal here)
    take the int64 keys of the whole row and a top-k on them."""
    kk = min(k, scores.shape[1])
    vals, idx = scores.topk(kk, dim=1, sorted=False)
    tied = (scores >= vals.amin(dim=1, keepdim=True)).sum(dim=1) > kk
    keys = _keys(vals, idx + first_row)
    if tied.any():
        rows = tied.nonzero().squeeze(1)
        keys[rows] = tie_keys(scores[rows], first_row).topk(kk, dim=1).values
    return keys


def decode_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 keys → (float32 scores, int64 rows)."""
    mono = (keys >> 32).to(torch.int32)
    bits = mono ^ ((mono >> 31) & 0x7FFFFFFF)
    return bits.view(torch.float32), _LOW32 - (keys & _LOW32)


class RunningTopK:
    """The k largest keys seen so far, merged chunk by chunk."""

    def __init__(self, k: int):
        self.k = k
        self.best: Optional[torch.Tensor] = None

    def add(self, scores: torch.Tensor, first_row: int) -> None:
        keys = chunk_top_keys(scores, first_row, self.k)
        if self.best is not None:
            keys = torch.cat([self.best, keys], dim=1)
        self.best = keys.topk(min(self.k, keys.shape[1]), dim=1).values

    def result(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return decode_keys(self.best)


def as_queries(queries, device: torch.device) -> torch.Tensor:
    """(Q, d) queries, a numpy array or a tensor on any device, as float32 on
    ``device``."""
    if isinstance(queries, torch.Tensor):
        return queries.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(queries, np.float32)).to(device)


def _validate_k(k: int, n: int) -> None:
    if k > n:
        raise ValueError(
            f"k={k} exceeds the corpus size ({n}); retrieval cannot return "
            f"more facts than exist — pass k <= {n}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")


def _check_finite_corpus(embeddings: np.ndarray) -> None:
    if not np.isfinite(np.asarray(embeddings)).all():
        # NaN scores make the top-k silent no-ops downstream
        raise FloatingPointError(
            "index embeddings contain non-finite values; re-embed the "
            "corpus (see retrieval/embed.py's finite check)")


class DenseIndex:
    """Inner-product top-k over an embedding matrix kept on ``device`` (the
    CUDA card unless given). ``method``: "exact" (float32 scores), "fast"
    (bfloat16 inputs, float32 accumulation on the card) or "approx" (the
    same as "fast" off the TPU; see the module docstring)."""

    def __init__(self, embeddings: np.ndarray, ids: Optional[np.ndarray] = None,
                 chunk_size: int = 131072, method: str = "exact", device: Device = None):
        n, d = embeddings.shape
        if method not in ("exact", "fast", "approx"):
            raise ValueError(f"method must be exact|fast|approx, got {method!r}")
        _check_finite_corpus(embeddings)
        self.device = resolve_device(device)
        self.n, self.dim = n, d
        self.ids = np.arange(n, dtype=np.int64) if ids is None else np.asarray(ids)
        assert len(self.ids) == n
        self.chunk_size = min(chunk_size, n)
        self.method = method
        self._emb = torch.as_tensor(np.asarray(embeddings, np.float32)).to(self.device)
        # id → embedding-row lookup, built lazily on the first rerank
        # (identity when ids are positional, the common case)
        self._id_to_row: Optional[dict] = None
        self._ids_positional = bool(np.array_equal(self.ids, np.arange(n, dtype=self.ids.dtype)))

    def _rows_for_ids(self, candidate_ids: np.ndarray) -> np.ndarray:
        """Map external fact ids to embedding rows (search() returns
        self.ids, so rerank inverts that mapping)."""
        if self._ids_positional:
            return np.asarray(candidate_ids)
        if self._id_to_row is None:
            self._id_to_row = {int(i): r for r, i in enumerate(self.ids)}
        flat = np.asarray(candidate_ids).reshape(-1)
        try:
            rows = np.fromiter((self._id_to_row[int(i)] for i in flat), dtype=np.int64,
                               count=flat.size)
        except KeyError as e:
            raise KeyError(f"candidate id {e} not present in index ids") from None
        return rows.reshape(np.asarray(candidate_ids).shape)

    def _queries(self, queries) -> torch.Tensor:
        return as_queries(queries, self.device)

    def _search_batch(self, q: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        # fast/approx: bf16 operands, f32 sums on the card; f32 on the CPU
        reduced = self.method != "exact" and self.device.type == "cuda"
        if reduced:
            q = q.to(torch.bfloat16).float()
        top = RunningTopK(k)
        with matmul_precision("tf32" if reduced else "ieee"):
            for start in range(0, self.n, self.chunk_size):
                chunk = self._emb[start:start + self.chunk_size]
                if reduced:
                    chunk = chunk.to(torch.bfloat16).float()
                top.add(q @ chunk.T, start)
        return top.result()

    @torch.no_grad()
    def search(self, queries: np.ndarray, k: int,
               batch_size: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, d) queries → (ids (Q, k) int64, scores (Q, k) float32),
        sorted by score descending, ties lowest row first. ``k`` must not
        exceed the corpus size."""
        _validate_k(k, self.n)
        out_ids, out_scores = [], []
        for s in range(0, len(queries), batch_size):
            scores, rows = self._search_batch(self._queries(queries[s:s + batch_size]), k)
            out_scores.append(scores.cpu().numpy())
            out_ids.append(self.ids[rows.cpu().numpy()])
        return np.concatenate(out_ids), np.concatenate(out_scores)

    @torch.no_grad()
    def rerank(self, candidate_ids: np.ndarray, queries: np.ndarray,
               batch_size: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
        """Per-example candidate re-scoring in float32: (B, C) ids + (B, d)
        queries → (ids, scores) sorted descending per row, ties in candidate
        order (a stable sort)."""
        rows = np.asarray(self._rows_for_ids(candidate_ids))
        cand = np.asarray(candidate_ids)
        out_ids, out_scores = [], []
        for s in range(0, len(rows), batch_size):
            gathered = self._emb[torch.as_tensor(rows[s:s + batch_size]).to(self.device)]
            q = self._queries(queries[s:s + batch_size])
            with matmul_precision("ieee"):
                scores = torch.einsum("bcd,bd->bc", gathered, q)
            sorted_scores, order = torch.sort(scores, dim=-1, descending=True, stable=True)
            out_ids.append(np.take_along_axis(cand[s:s + batch_size], order.cpu().numpy(),
                                              axis=-1))
            out_scores.append(sorted_scores.cpu().numpy())
        return np.concatenate(out_ids), np.concatenate(out_scores)

    def save(self, dir_path: str) -> None:
        p = Path(dir_path)
        p.mkdir(parents=True, exist_ok=True)
        np.save(p / "embeddings.npy", self._emb.cpu().numpy())
        np.save(p / "ids.npy", self.ids)
        (p / "meta.json").write_text(json.dumps({"n": self.n, "dim": self.dim}))

    @classmethod
    def load(cls, dir_path: str, method: str = "exact", device: Device = None) -> "DenseIndex":
        p = Path(dir_path)
        return cls(np.load(p / "embeddings.npy"), np.load(p / "ids.npy"), method=method,
                   device=device)


class ShardedDenseIndex:
    """The corpus sharded over devices: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("ShardedDenseIndex (a corpus sharded over devices) is not "
                                  "ported yet (ROADMAP item 12); DenseIndex holds the corpus "
                                  "on one card")


def add_facts_to_examples(
    examples: Sequence[dict],
    ids: np.ndarray,
    scores: np.ndarray,
    id_to_sentence,
) -> None:
    """Attach retrieved facts to each example, in rank order."""
    assert len(examples) == len(ids)
    for ex, row_ids, row_scores in zip(examples, ids, scores):
        ex["fact"] = [
            {"sentence": id_to_sentence[int(i)], "id": int(i), "score": float(s)}
            for i, s in zip(row_ids, row_scores)
        ]
