"""Decoder cross-attention → per-fact retrieval-supervision scores: the port
of lako_tpu/signal/aggregate.py.

The numpy functions are copies of the JAX package's, pinned to them by
tests/test_torch_signal.py; :func:`aggregate_fact_scores_device` is its
on-device aggregation in torch, so that only ``(B, n_context)`` floats leave
the card. The semantics, kept exactly:

- scores are the pre-softmax logits of the FIRST decode step only;
- masked key positions contribute 0;
- stream 2 splits the keys into the passage and fact halves and uses the
  fact half, summed over layers × heads;
- each fact's score is the mean, max or "21mean" (the mean of the top
  ``(e - s + 1) // 2`` values) over its token span ``[s, e)``, whose end
  includes the fact's period;
- facts that are missing get the pad score −5;
- the result, the −5 pad included, is divided by layers × heads, with the
  layer count read AFTER the last-half chunk: with
  ``use_last_half_layer_attention`` the divisor is
  ``(n_layers - n_layers // 2) × heads``;
- then an optional answer-hit bonus and a per-row softmax, or a plain
  softmax.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from lako_tpu_torch.core.config import AttentionSignalConfig
from lako_tpu_torch.text.metrics import includ_ems, stem_ems


def _require_stream2(cfg: AttentionSignalConfig) -> None:
    if cfg.stream != 2:
        raise ValueError(f"fact aggregation requires stream-2 batches, got stream={cfg.stream}")


def _style_aggregate(vals: np.ndarray, style: str) -> float:
    if style == "mean":
        return float(vals.mean())
    if style == "max":
        return float(vals.max())
    if style == "21mean":
        num = max(int((len(vals) + 1) / 2), 1)
        top = np.sort(vals)[::-1][:num]
        return float(top.mean())
    raise ValueError(f"unknown attention_score_style {style}")


def aggregate_fact_scores(
    cross_logits: np.ndarray,   # (B, layers, heads, K) first-step logits
    passage_mask: np.ndarray,   # (B, N, L) bool
    fact_spans: np.ndarray,     # (B, n_context, 2) spans in the fact passage
    cfg: AttentionSignalConfig,
) -> np.ndarray:
    """Returns (B, n_context) float scores (NOT yet softmaxed)."""
    _require_stream2(cfg)
    B, n_layers, n_heads, K = cross_logits.shape
    _, N, L = passage_mask.shape
    if K != N * L:
        raise ValueError(f"{K} keys for {N} passages of {L}")

    scores = np.asarray(cross_logits, dtype=np.float64).copy()
    mask = passage_mask.reshape(B, 1, 1, K)
    scores = np.where(mask, scores, 0.0)

    used = scores.reshape(B, n_layers, n_heads, N, L)
    n_used_layers = n_layers
    if cfg.use_last_half_layer_attention:
        used = used[:, n_layers // 2:, :, :, :]
        n_used_layers = n_layers - n_layers // 2
    # stream 2: the fact passage is index 1; sum over layers and heads
    fact_stream = used[:, :, :, 1, :].sum(axis=(1, 2))  # (B, L)

    out = np.full((B, cfg.n_context), cfg.pad_score, dtype=np.float64)
    for b in range(B):
        for j in range(cfg.n_context):
            s, e = int(fact_spans[b, j, 0]), int(fact_spans[b, j, 1])
            if e <= s:
                continue
            out[b, j] = _style_aggregate(fact_stream[b, s:e], cfg.attention_score_style)
    out = out / (n_used_layers * n_heads)
    return out.astype(np.float32)


def question_passage_score(
    cross_logits: np.ndarray,    # (B, layers, heads, K)
    passage_mask: np.ndarray,    # (B, N, L)
    question_spans: np.ndarray,  # (B, 2) [start, end) of the question in passage 0
    cfg: AttentionSignalConfig,
) -> np.ndarray:
    """Per-example attention score of the question span in the first
    passage (the reference's ``consider_context_attention`` signal)."""
    B, n_layers, n_heads, K = cross_logits.shape
    _, N, L = passage_mask.shape
    scores = np.where(passage_mask.reshape(B, 1, 1, K),
                      np.asarray(cross_logits, np.float64), 0.0)
    psg_stream = scores.reshape(B, n_layers, n_heads, N, L)[:, :, :, 0, :] \
        .sum(axis=(1, 2))  # (B, L)
    out = np.zeros(B, dtype=np.float64)
    for b in range(B):
        s, e = int(question_spans[b, 0]), int(question_spans[b, 1])
        if e > s:
            out[b] = _style_aggregate(psg_stream[b, s:e], cfg.attention_score_style)
    return (out / (n_layers * n_heads)).astype(np.float32)


def aggregate_fact_scores_device(
    cross_logits: torch.Tensor,   # (B, layers, heads, K) first-step logits
    passage_mask: torch.Tensor,   # (B, N, L) bool
    fact_spans: torch.Tensor,     # (B, n_context, 2) integer
    cfg: AttentionSignalConfig,
) -> torch.Tensor:
    """:func:`aggregate_fact_scores` on the logits' device: (B, n_context)
    float32, the same semantics without a host loop."""
    _require_stream2(cfg)
    B, n_layers, n_heads, K = cross_logits.shape
    _, N, L = passage_mask.shape
    scores = torch.where(passage_mask.reshape(B, 1, 1, K), cross_logits.float(), 0.0)
    used = scores.reshape(B, n_layers, n_heads, N, L)
    n_used_layers = n_layers
    if cfg.use_last_half_layer_attention:
        used = used[:, n_layers // 2:]
        n_used_layers = n_layers - n_layers // 2
    fact_stream = used[:, :, :, 1, :].sum(dim=(1, 2))        # (B, L)

    pos = torch.arange(L, device=cross_logits.device)[None, None, :]   # (1, 1, L)
    s = fact_spans[:, :, 0:1].long()                          # (B, C, 1)
    e = fact_spans[:, :, 1:2].long()
    width = (e - s)[..., 0]                                   # (B, C)
    member = (pos >= s) & (pos < e)                           # (B, C, L)
    stream = fact_stream[:, None, :]                          # (B, 1, L)
    style = cfg.attention_score_style
    if style == "mean":
        agg = torch.where(member, stream, 0.0).sum(dim=-1) / width.clamp(min=1).float()
    elif style == "max":
        agg = torch.where(member, stream, float("-inf")).amax(dim=-1)
    elif style == "21mean":
        vals = torch.where(member, stream, float("-inf")).sort(dim=-1, descending=True).values
        num = ((width + 1) // 2).clamp(min=1)                 # (B, C)
        take = pos < num[..., None]
        agg = torch.where(take, vals, 0.0).sum(dim=-1) / num.float()
    else:
        raise ValueError(style)
    agg = torch.where(width <= 0, torch.full_like(agg, cfg.pad_score), agg)
    # the divisor takes the post-chunk layer count
    return agg / (n_used_layers * n_heads)


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def apply_ans_attention_bonus(
    scores: np.ndarray,          # (B, n_context)
    examples: Sequence[dict],    # reader-format, aligned with rows
    n_context: int,
    ans_attention: bool,
) -> np.ndarray:
    """Answer-hit bonus and softmax.

    ans_attention=False: softmax over the whole row.
    ans_attention=True: add max(include-EM, stem-EM) of each fact sentence
    against the gold answers, then softmax over the first range_num entries
    only.
    """
    out = np.asarray(scores, dtype=np.float32).copy()
    if not ans_attention:
        return _softmax(out)
    for k, ex in enumerate(examples):
        gold = ex["answer"]
        range_num = min(n_context, len(ex["fact"]))
        if range_num == 0:
            continue
        bonus = np.array([
            max(includ_ems(f["sentence"], gold),
                stem_ems(f["sentence"], gold, dele_sw=True))
            for f in ex["fact"][:range_num]
        ], dtype=np.float32)
        out[k, :range_num] += bonus
        out[k, :range_num] = _softmax(out[k, :range_num][None])[0]
    return out


def attach_scores_to_examples(
    examples: Sequence[dict],
    scores: np.ndarray,
    n_context: int,
) -> None:
    """Write scores into example['fact'][j]['score']."""
    for k, ex in enumerate(examples):
        for j in range(min(n_context, len(ex["fact"]))):
            ex["fact"][j]["score"] = float(scores[k, j])
