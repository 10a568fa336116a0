"""BM25 ranking (Okapi / L / Plus variants): a copy of
lako_tpu/retrieval/bm25.py, pinned to the original by
tests/test_torch_dataprep.py.

Score-identical to the vendored rank_bm25 of the original LaKo code, over
postings lists: per-term (doc_id, freq) arrays built once, so a query only
touches the documents that hold its terms. ``get_top_n`` keeps the
original's ``np.argsort(scores)[::-1]``, so ties fall the same way.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


class _BM25Base:
    def __init__(self, corpus: Sequence[Sequence[str]],
                 tokenizer: Optional[Callable] = None):
        if tokenizer:
            corpus = [tokenizer(doc) for doc in corpus]
        self.corpus_size = len(corpus)
        self.doc_len = np.array([len(doc) for doc in corpus], dtype=np.float64)
        self.avgdl = float(self.doc_len.sum()) / max(1, self.corpus_size)

        postings: Dict[str, List] = defaultdict(list)
        nd: Dict[str, int] = {}
        for i, doc in enumerate(corpus):
            freqs = Counter(doc)
            for word, f in freqs.items():
                postings[word].append((i, f))
                nd[word] = nd.get(word, 0) + 1
        self._postings = {
            w: (np.array([i for i, _ in lst], dtype=np.int64),
                np.array([f for _, f in lst], dtype=np.float64))
            for w, lst in postings.items()
        }
        self.idf: Dict[str, float] = {}
        self._calc_idf(nd)

    def _calc_idf(self, nd: Dict[str, int]) -> None:
        raise NotImplementedError

    def _term_scores(self, doc_ids: np.ndarray, q_freq: np.ndarray,
                     doc_len: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def get_scores(self, query: Sequence[str]) -> np.ndarray:
        score = np.zeros(self.corpus_size)
        for q in query:
            post = self._postings.get(q)
            if post is None or q not in self.idf:
                continue
            doc_ids, q_freq = post
            score[doc_ids] += self.idf[q] * self._term_scores(
                doc_ids, q_freq, self.doc_len[doc_ids]
            )
        score += self._zero_freq_offset(query)
        return score

    def _zero_freq_offset(self, query) -> float:
        return 0.0

    def get_batch_scores(self, query: Sequence[str], doc_ids: Sequence[int]) -> List[float]:
        full = self.get_scores(query)
        return full[np.asarray(doc_ids, dtype=np.int64)].tolist()

    def get_top_n(self, query: Sequence[str], documents: Sequence, n: int = 5) -> List:
        assert self.corpus_size == len(documents), \
            "The documents given don't match the index corpus!"
        scores = self.get_scores(query)
        top_n = np.argsort(scores)[::-1][:n]
        return [documents[i] for i in top_n]


class BM25Okapi(_BM25Base):
    def __init__(self, corpus, tokenizer=None, k1=1.5, b=0.75, epsilon=0.25):
        self.k1, self.b, self.epsilon = k1, b, epsilon
        super().__init__(corpus, tokenizer)

    def _calc_idf(self, nd):
        idf_sum = 0.0
        negative = []
        for word, freq in nd.items():
            idf = math.log(self.corpus_size - freq + 0.5) - math.log(freq + 0.5)
            self.idf[word] = idf
            idf_sum += idf
            if idf < 0:
                negative.append(word)
        self.average_idf = idf_sum / max(1, len(self.idf))
        eps = self.epsilon * self.average_idf
        for word in negative:
            self.idf[word] = eps

    def _term_scores(self, doc_ids, q_freq, doc_len):
        return q_freq * (self.k1 + 1) / (
            q_freq + self.k1 * (1 - self.b + self.b * doc_len / self.avgdl)
        )


class BM25L(_BM25Base):
    def __init__(self, corpus, tokenizer=None, k1=1.5, b=0.75, delta=0.5):
        self.k1, self.b, self.delta = k1, b, delta
        super().__init__(corpus, tokenizer)

    def _calc_idf(self, nd):
        for word, freq in nd.items():
            self.idf[word] = math.log(self.corpus_size + 1) - math.log(freq + 0.5)

    def _term_scores(self, doc_ids, q_freq, doc_len):
        ctd = q_freq / (1 - self.b + self.b * doc_len / self.avgdl)
        return q_freq * (self.k1 + 1) * (ctd + self.delta) / (self.k1 + ctd + self.delta)


class BM25Plus(_BM25Base):
    """Note BM25Plus adds delta*idf even for absent terms (reference
    rank_bm25.py:186-190 scores all docs); we add that constant per present query
    term with known idf, matching the dense implementation exactly."""

    def __init__(self, corpus, tokenizer=None, k1=1.5, b=0.75, delta=1):
        self.k1, self.b, self.delta = k1, b, delta
        super().__init__(corpus, tokenizer)

    def _calc_idf(self, nd):
        for word, freq in nd.items():
            self.idf[word] = math.log((self.corpus_size + 1) / freq)

    def _term_scores(self, doc_ids, q_freq, doc_len):
        # subtract the delta baseline added globally in _zero_freq_offset
        return (q_freq * (self.k1 + 1)) / (
            self.k1 * (1 - self.b + self.b * doc_len / self.avgdl) + q_freq
        )

    def _zero_freq_offset(self, query) -> float:
        return sum(self.delta * self.idf.get(q, 0.0) for q in query)
