"""Fixed-shape batch collation: a copy of lako_tpu/data/collator.py (its
package imports jax), pinned to the original by tests/test_torch_serve.py.

Produces numpy arrays (reader ``(B, N, L)`` passages, retriever question and
fact batches, flat corpus batches); the model moves them to its device. The fact-stream passage is built by concatenating per-piece token
ids, so per-fact token spans are exact by construction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from lako_tpu_torch.core.config import ReaderDataConfig
from lako_tpu_torch.text.tokenizer import BaseTokenizer


@dataclass
class ReaderBatch:
    index: np.ndarray          # (B,) int32 example indices
    passage_ids: np.ndarray    # (B, N, L) int32
    passage_mask: np.ndarray   # (B, N, L) bool
    labels: np.ndarray         # (B, T) int32, -100 on padding
    fact_spans: np.ndarray     # (B, n_context, 2) int32 [start, end) in fact passage
    n_facts: np.ndarray        # (B,) int32
    valid: np.ndarray          # (B,) bool — False for padding rows
    question_spans: np.ndarray = None  # (B, 2) int32: content span in passage 0


@dataclass
class RetrieverBatch:
    index: np.ndarray          # (B,) int32
    question_ids: np.ndarray   # (B, Lq) int32
    question_mask: np.ndarray  # (B, Lq) bool
    passage_ids: np.ndarray    # (B, n_ctx, Lp) int32
    passage_mask: np.ndarray   # (B, n_ctx, Lp) bool
    gold_scores: np.ndarray    # (B, n_ctx) float32
    n_facts: np.ndarray        # (B,) int32
    valid: np.ndarray          # (B,) bool


class ReaderCollator:
    """Formatted examples → ReaderBatch."""

    def __init__(self, cfg: ReaderDataConfig, tokenizer: BaseTokenizer):
        self.cfg = cfg
        self.tokenizer = tokenizer

    def _encode_fact_passage(self, item: dict):
        """Build the fact passage ids + per-fact spans by concatenation."""
        cfg = self.cfg
        tok = self.tokenizer
        L = cfg.text_maxlength
        ids: List[int] = list(tok.encode(cfg.fact_prefix, add_special=False))
        spans = np.zeros((cfg.n_context, 2), dtype=np.int32)
        for j, sent in enumerate(item["fact_sentences"][: cfg.n_context]):
            piece = tok.encode(sent, add_special=False)
            start = len(ids)
            ids.extend(piece)
            end = len(ids)
            # clamp into the truncated window; facts fully beyond L get (0, 0)
            start, end = min(start, L), min(end, L)
            if end > start:
                spans[j] = (start, end)
        if getattr(tok, "eos_id", None) is not None and tok.style == "t5":
            ids.append(tok.eos_id)
        return ids[:L], spans

    def __call__(self, items: Sequence[dict], pad_to: Optional[int] = None) -> ReaderBatch:
        cfg = self.cfg
        tok = self.tokenizer
        B = len(items)
        Bp = pad_to or B
        N = cfg.n_passages
        L = cfg.text_maxlength
        T = cfg.answer_maxlength

        passage_ids = np.full((Bp, N, L), tok.pad_id, dtype=np.int32)
        passage_mask = np.zeros((Bp, N, L), dtype=bool)
        labels = np.full((Bp, T), -100, dtype=np.int32)
        fact_spans = np.zeros((Bp, cfg.n_context, 2), dtype=np.int32)
        n_facts = np.zeros(Bp, dtype=np.int32)
        index = np.zeros(Bp, dtype=np.int32)
        valid = np.zeros(Bp, dtype=bool)
        question_spans = np.zeros((Bp, 2), dtype=np.int32)
        prefix_len = len(tok.encode(cfg.question_prefix, add_special=False))

        for i, item in enumerate(items):
            index[i] = item["index"]
            valid[i] = True
            n_facts[i] = len(item["fact_sentences"])

            if item["target"] is not None:
                t_ids = tok.encode(item["target"])[:T]
                labels[i, : len(t_ids)] = t_ids

            qc = item["question"] + " " + item["caption"]
            if item["fact"] is None:
                texts = [qc]
            elif isinstance(item["fact"], str):
                if cfg.stream == 1:
                    texts = [qc + " " + item["fact"]]
                else:
                    texts = [qc]  # fact passage handled below with spans
            else:
                texts = [qc] + list(item["fact"])

            for p, text in enumerate(texts[:N]):
                ids = tok.encode(text)[:L]
                passage_ids[i, p, : len(ids)] = ids
                passage_mask[i, p, : len(ids)] = True
                if p == 0:
                    question_spans[i] = (min(prefix_len, len(ids)), len(ids))

            if isinstance(item["fact"], str) and cfg.stream == 2:
                ids, spans = self._encode_fact_passage(item)
                passage_ids[i, 1, : len(ids)] = ids
                passage_mask[i, 1, : len(ids)] = True
                fact_spans[i] = spans

        return ReaderBatch(index, passage_ids, passage_mask, labels, fact_spans,
                           n_facts, valid, question_spans)


class RetrieverCollator:
    """question = question + caption; passages = fact sentences."""

    def __init__(self, tokenizer: BaseTokenizer, n_context: int,
                 question_maxlength: int = 130, passage_maxlength: int = 130):
        self.tokenizer = tokenizer
        self.n_context = n_context
        self.question_maxlength = question_maxlength
        self.passage_maxlength = passage_maxlength

    def __call__(self, items: Sequence[dict], pad_to: Optional[int] = None) -> RetrieverBatch:
        tok = self.tokenizer
        B = len(items)
        Bp = pad_to or B
        n_ctx, Lq, Lp = self.n_context, self.question_maxlength, self.passage_maxlength

        question_ids = np.full((Bp, Lq), tok.pad_id, dtype=np.int32)
        question_mask = np.zeros((Bp, Lq), dtype=bool)
        passage_ids = np.full((Bp, n_ctx, Lp), tok.pad_id, dtype=np.int32)
        passage_mask = np.zeros((Bp, n_ctx, Lp), dtype=bool)
        gold_scores = np.zeros((Bp, n_ctx), dtype=np.float32)
        n_facts = np.zeros(Bp, dtype=np.int32)
        index = np.zeros(Bp, dtype=np.int32)
        valid = np.zeros(Bp, dtype=bool)

        for i, item in enumerate(items):
            index[i] = item["index"]
            valid[i] = True
            q = item["question"] + " " + item["caption"]
            q_ids = tok.encode(q)[:Lq]
            question_ids[i, : len(q_ids)] = q_ids
            question_mask[i, : len(q_ids)] = True

            sents = item["fact_sentences"][:n_ctx]
            n_facts[i] = len(sents)
            for j, sent in enumerate(sents):
                p_ids = tok.encode(sent)[:Lp]
                passage_ids[i, j, : len(p_ids)] = p_ids
                passage_mask[i, j, : len(p_ids)] = True
            if item["score"] is not None:
                s = np.asarray(item["score"][:n_ctx], dtype=np.float32)
                gold_scores[i, : len(s)] = s

        return RetrieverBatch(index, question_ids, question_mask, passage_ids,
                              passage_mask, gold_scores, n_facts, valid)


class TextCollator:
    """Flat KG-sentence batches for corpus embedding: (fact ids, token ids,
    mask)."""

    def __init__(self, tokenizer: BaseTokenizer, maxlength: int = 100):
        self.tokenizer = tokenizer
        self.maxlength = maxlength

    def __call__(self, items: Sequence[dict], pad_to: Optional[int] = None):
        tok = self.tokenizer
        B = len(items)
        Bp = pad_to or B
        ids = np.full((Bp, self.maxlength), tok.pad_id, dtype=np.int32)
        mask = np.zeros((Bp, self.maxlength), dtype=bool)
        fact_ids = np.full(Bp, -1, dtype=np.int64)
        for i, item in enumerate(items):
            t_ids = tok.encode(item["sentence"])[: self.maxlength]
            ids[i, : len(t_ids)] = t_ids
            mask[i, : len(t_ids)] = True
            fact_ids[i] = int(item["id"])
        return fact_ids, ids, mask
