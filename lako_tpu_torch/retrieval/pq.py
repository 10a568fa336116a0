"""Product-quantized inner-product index: the port of lako_tpu/retrieval/pq.py.

The corpus is compressed to ``m`` codes per vector (a k-means codebook per
subspace) and queries score against the reconstruction:
score(q, x) = sum_m <q_m, book[m, code_m(x)]> = <q, x_hat>. The codes live on
the device; each corpus chunk is decompressed by one gather to (chunk, d)
float32 and scored by a full-float32 matmul into the running, tie-ordered
top-k of retrieval/index.py. At LaKo scale (300,600 x 256) PQ-32x8 holds 9.6
MB of codes and 0.26 MB of codebooks instead of 307 MB.

``_kmeans`` and ``_encode`` are numpy copies of the JAX package's, pinned to
them bitwise by tests/test_torch_retrieval.py. Codes wider than 8 bits
(``n_bits > 8``) are uint16 on the host; torch's uint16 has few operations
on the card, so the device keeps their bits as int16 and widens them with
``& 0xFFFF`` at decompression, exactly.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from lako_tpu_torch.core.device import resolve_device
from lako_tpu_torch.retrieval.index import (
    Device,
    RunningTopK,
    _validate_k,
    as_queries,
    matmul_precision,
)


def _kmeans(x: np.ndarray, k: int, iters: int, seed: int) -> np.ndarray:
    """Lloyd's k-means (k centroids over x), distances by the
    ``|x|^2 - 2x.c + |c|^2`` expansion (the ``|x|^2`` term dropped)."""
    rng = np.random.default_rng(seed)
    centroids = x[rng.choice(len(x), size=k, replace=len(x) < k)].copy()
    for _ in range(iters):
        d = (centroids ** 2).sum(1)[None, :] - 2.0 * (x @ centroids.T)
        assign = d.argmin(1)
        for j in range(k):
            members = x[assign == j]
            if len(members):
                centroids[j] = members.mean(0)
    return centroids


class PQIndex:
    """Train/encode/search with m subquantizers of 2^n_bits centroids each,
    the codes on ``device`` (the CUDA card unless given)."""

    def __init__(self, codebooks: np.ndarray, codes: np.ndarray,
                 ids: Optional[np.ndarray] = None, chunk_size: int = 65536,
                 device: Device = None):
        """codebooks: (m, k, dsub); codes: (n, m) uint8 (uint16 for k > 256)."""
        self.codebooks = np.asarray(codebooks, np.float32)
        self.codes = np.asarray(codes)
        self.m, self.k, self.dsub = self.codebooks.shape
        self.n = len(self.codes)
        self.dim = self.m * self.dsub
        self.ids = np.arange(self.n, dtype=np.int64) if ids is None else ids
        self.chunk_size = min(chunk_size, self.n)
        if self.codes.max(initial=0) >= self.k:
            raise ValueError(
                f"codes reference centroid {int(self.codes.max())} but "
                f"codebooks have only k={self.k} centroids per subspace")
        self.device = resolve_device(device)
        narrow = self.codes.astype(np.uint8) if self.k <= 256 else \
            self.codes.astype(np.uint16).view(np.int16)
        self._codes_dev = torch.from_numpy(np.ascontiguousarray(narrow)).to(self.device)
        # the books flattened to (m*k, dsub): subspace j's centroid c is row j*k + c
        self._books_dev = torch.from_numpy(
            self.codebooks.reshape(self.m * self.k, self.dsub)).to(self.device)
        self._offsets = torch.arange(self.m, device=self.device) * self.k

    @classmethod
    def train(cls, embeddings: np.ndarray, n_subquantizers: int = 32, n_bits: int = 8,
              ids: Optional[np.ndarray] = None, train_size: int = 16384, iters: int = 10,
              seed: int = 0, device: Device = None) -> "PQIndex":
        n, d = embeddings.shape
        m = n_subquantizers
        assert d % m == 0, (d, m)
        dsub, k = d // m, 2 ** n_bits
        rng = np.random.default_rng(seed)
        sample = embeddings[rng.choice(n, size=min(train_size, n), replace=False)]
        books = np.stack([
            _kmeans(sample[:, j * dsub:(j + 1) * dsub].astype(np.float32), k, iters, seed + j)
            for j in range(m)
        ])
        codes = cls._encode(embeddings, books)
        return cls(books, codes, ids, device=device)

    @staticmethod
    def _encode(x: np.ndarray, books: np.ndarray, row_batch: int = 65536) -> np.ndarray:
        """Nearest-centroid codes per subspace, batched over rows."""
        m, k, dsub = books.shape
        codes = np.empty((len(x), m), dtype=np.uint8 if k <= 256 else np.uint16)
        c_norm = (books ** 2).sum(-1)  # (m, k)
        for s in range(0, len(x), row_batch):
            xb = x[s:s + row_batch].astype(np.float32)
            for j in range(m):
                sub = xb[:, j * dsub:(j + 1) * dsub]
                d = c_norm[j][None, :] - 2.0 * (sub @ books[j].T)
                codes[s:s + row_batch, j] = d.argmin(1)
        return codes

    def decompress(self, start: int, stop: int) -> torch.Tensor:
        """Rows ``start:stop`` reconstructed, (stop - start, d) float32."""
        codes = self._codes_dev[start:stop].to(torch.int64)
        if self.k > 256:
            codes = codes & 0xFFFF
        return self._books_dev[codes + self._offsets].reshape(stop - start, self.dim)

    @torch.no_grad()
    def search(self, queries: np.ndarray, k: int,
               batch_size: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, d) queries → (ids, scores) sorted descending, ties lowest row
        first. Scores are float32 inner products with the reconstruction;
        the approximation comes only from quantization."""
        _validate_k(k, self.n)
        out_ids, out_scores = [], []
        for s in range(0, len(queries), batch_size):
            q = as_queries(queries[s:s + batch_size], self.device)
            top = RunningTopK(k)
            with matmul_precision("ieee"):
                for start in range(0, self.n, self.chunk_size):
                    stop = min(start + self.chunk_size, self.n)
                    top.add(q @ self.decompress(start, stop).T, start)
            scores, rows = top.result()
            out_scores.append(scores.cpu().numpy())
            out_ids.append(self.ids[rows.cpu().numpy()])
        return np.concatenate(out_ids), np.concatenate(out_scores)

    def nbytes(self) -> int:
        """Index payload (codes + codebooks)."""
        return self.codes.nbytes + self.codebooks.nbytes

    def save(self, dir_path: str) -> None:
        p = Path(dir_path)
        p.mkdir(parents=True, exist_ok=True)
        np.save(p / "codebooks.npy", self.codebooks)
        np.save(p / "codes.npy", self.codes)
        np.save(p / "ids.npy", self.ids)
        (p / "meta.json").write_text(json.dumps(
            {"m": self.m, "k": self.k, "dsub": self.dsub, "n": self.n}))

    @classmethod
    def load(cls, dir_path: str, device: Device = None) -> "PQIndex":
        p = Path(dir_path)
        return cls(np.load(p / "codebooks.npy"), np.load(p / "codes.npy"),
                   np.load(p / "ids.npy"), device=device)
