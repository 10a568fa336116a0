"""Host-CPU search and BM25: the port of lako_tpu/retrieval/native.py.

``NativeIndex`` has :class:`~lako_tpu_torch.retrieval.index.DenseIndex`'s
``search`` / ``rerank`` interface over numpy arrays on the host, through the
C++ scan of ``csrc/host/mips.cpp`` (a byte-for-byte copy of the JAX
package's ``native/mips.cpp``; the faiss-cpu role of the reference,
src/index.py); ``HostIndex`` has the same interface over a chunked BLAS
matmul and a running top-k. The JAX docstring measured ``HostIndex`` ~15x
faster than the scan for batches of queries at LaKo's scale (300,600 x 256,
64 queries, top-500); ``chip_smoke.py`` measures both on the card's host.
``bm25_topn_native`` is the candidate miner's hot loop (reference
vqa2_deal.py:124-135).

The library is built with ``g++`` at first use (ops/_build.py
``load_host_library``); it never runs ``make`` in ``native/`` and never loads
the library built there. Pinned to the JAX classes by
tests/test_torch_native.py.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np

from lako_tpu_torch.ops._build import load_host_library


def _load() -> ctypes.CDLL:
    return load_host_library()


@functools.cache
def native_available() -> bool:
    """Whether the host library builds and loads, tried once per process
    (for the "auto" choices of the miner and the obj36 loader; everything
    else loads it and raises)."""
    try:
        _load()
        return True
    except Exception:   # no compiler, or a failed build
        return False


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def bm25_topn_native(docs_tokens: "list[list[int]]", query_tokens: "list[int]", n: int,
                     k1: float = 1.5, b: float = 0.75, epsilon: float = 0.25) -> np.ndarray:
    """BM25Okapi top-n document indices by the C++ engine (the formulas of
    retrieval/bm25.py's ``BM25Okapi``; equal scores in descending index
    order)."""
    lib = _load()
    offsets = np.zeros(len(docs_tokens) + 1, dtype=np.int64)
    for i, d in enumerate(docs_tokens):
        offsets[i + 1] = offsets[i] + len(d)
    flat = np.fromiter((t for d in docs_tokens for t in d), dtype=np.int64,
                       count=int(offsets[-1]))
    q = np.asarray(query_tokens, dtype=np.int64)
    out = np.empty(min(n, len(docs_tokens)), dtype=np.int64)
    wrote = lib.lako_bm25_topn(_iptr(flat), _iptr(offsets), len(docs_tokens), _iptr(q), len(q),
                               k1, b, epsilon, _iptr(out), len(out))
    if wrote < 0:
        raise RuntimeError("lako_bm25_topn failed")
    return out[:wrote]


class _IdRowMixin:
    """id → embedding-row inversion shared by the host index classes:
    ``search`` maps rows through ``self.ids`` on the way out, so ``rerank``
    inverts that mapping on the way in."""

    _id_to_row = None
    _ids_positional = None

    def _rows_for_ids(self, candidate_ids: np.ndarray) -> np.ndarray:
        if self._ids_positional is None:
            self._ids_positional = bool(np.array_equal(
                self.ids, np.arange(self.n, dtype=self.ids.dtype)))
        cand = np.asarray(candidate_ids, dtype=np.int64)
        if self._ids_positional:
            return cand
        if self._id_to_row is None:
            self._id_to_row = {int(i): r for r, i in enumerate(self.ids)}
        flat = cand.reshape(-1)
        try:
            rows = np.fromiter((self._id_to_row[int(i)] for i in flat),
                               dtype=np.int64, count=flat.size)
        except KeyError as e:
            raise KeyError(f"candidate id {e} not present in index ids") from None
        return rows.reshape(cand.shape)


class HostIndex(_IdRowMixin):
    """Exact MIPS on the host: a chunked BLAS matmul and a running top-k
    merge, O(Q x (chunk + k)) memory instead of the (Q, N) score matrix."""

    def __init__(self, embeddings: np.ndarray, ids: Optional[np.ndarray] = None,
                 chunk_size: int = 65536):
        self._emb = np.ascontiguousarray(embeddings, dtype=np.float32)
        self.n, self.dim = self._emb.shape
        self.ids = np.arange(self.n, dtype=np.int64) if ids is None \
            else np.asarray(ids, dtype=np.int64)
        self.chunk = chunk_size

    def search(self, queries: np.ndarray, k: int,
               batch_size: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        q = np.ascontiguousarray(queries, dtype=np.float32)
        Q = len(q)
        k = min(k, self.n)
        best_scores = np.full((Q, k), -np.inf, dtype=np.float32)
        best_idx = np.zeros((Q, k), dtype=np.int64)
        for s in range(0, self.n, self.chunk):
            block = self._emb[s: s + self.chunk]
            scores = q @ block.T  # BLAS GEMM
            kk = min(k, scores.shape[1])
            part = np.argpartition(-scores, kk - 1, axis=1)[:, :kk]
            part_scores = np.take_along_axis(scores, part, axis=1)
            cat_scores = np.concatenate([best_scores, part_scores], axis=1)
            cat_idx = np.concatenate([best_idx, part + s], axis=1)
            keep = np.argpartition(-cat_scores, k - 1, axis=1)[:, :k]
            best_scores = np.take_along_axis(cat_scores, keep, axis=1)
            best_idx = np.take_along_axis(cat_idx, keep, axis=1)
        order = np.argsort(-best_scores, axis=1)
        best_scores = np.take_along_axis(best_scores, order, axis=1)
        best_idx = np.take_along_axis(best_idx, order, axis=1)
        return self.ids[best_idx], best_scores

    def rerank(self, candidate_ids: np.ndarray, queries: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        cand = np.asarray(candidate_ids, dtype=np.int64)
        q = np.ascontiguousarray(queries, dtype=np.float32)
        gathered = self._emb[self._rows_for_ids(cand)]   # (B, C, d)
        scores = np.einsum("bcd,bd->bc", gathered, q)
        order = np.argsort(-scores, axis=1)
        return (np.take_along_axis(cand, order, axis=1),
                np.take_along_axis(scores, order, axis=1).astype(np.float32))


class NativeIndex(_IdRowMixin):
    """Exact MIPS on the host by the C++ scan (``n_threads`` 0: all cores)."""

    def __init__(self, embeddings: np.ndarray, ids: Optional[np.ndarray] = None,
                 n_threads: int = 0):
        self._emb = np.ascontiguousarray(embeddings, dtype=np.float32)
        self.n, self.dim = self._emb.shape
        self.ids = np.arange(self.n, dtype=np.int64) if ids is None \
            else np.asarray(ids, dtype=np.int64)
        self.n_threads = n_threads
        _load()

    def search(self, queries: np.ndarray, k: int,
               batch_size: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        q = np.ascontiguousarray(queries, dtype=np.float32)
        nq = len(q)
        k = min(k, self.n)
        out_ids = np.empty((nq, k), dtype=np.int64)
        out_scores = np.empty((nq, k), dtype=np.float32)
        rc = _load().lako_mips_topk(_fptr(self._emb), self.n, self.dim, _fptr(q), nq, k,
                                    _iptr(out_ids), _fptr(out_scores), self.n_threads)
        if rc != 0:
            raise RuntimeError(f"lako_mips_topk failed rc={rc}")
        return self.ids[out_ids], out_scores

    def rerank(self, candidate_ids: np.ndarray, queries: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        q = np.ascontiguousarray(queries, dtype=np.float32)
        rows = np.ascontiguousarray(self._rows_for_ids(candidate_ids), dtype=np.int64)
        nq, c = rows.shape
        out_rows = np.empty((nq, c), dtype=np.int64)
        out_scores = np.empty((nq, c), dtype=np.float32)
        rc = _load().lako_mips_rerank(_fptr(self._emb), self.n, self.dim, _fptr(q), nq,
                                      _iptr(rows), c, _iptr(out_rows), _fptr(out_scores),
                                      self.n_threads)
        if rc != 0:
            raise RuntimeError(f"lako_mips_rerank failed rc={rc}")
        return self.ids[out_rows], out_scores
