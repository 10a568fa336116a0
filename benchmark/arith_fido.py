"""Operations and bytes a FiDO reader's work needs (``benchmark/arith.py``'s
count, for FiDO's decoder).

Counted from the configuration's sizes alone, for real rows and unmasked
tokens only, weights read once a pass in bfloat16; attention's score and
context products are left out, as ``arith`` leaves them out. Against
``arith``'s T5 count: the MLP has ``wi_0`` and ``wi_1`` where the
configuration gates it; only the layers that cross-attend carry a cross
block, whose K/V projections are ``d_kv`` wide under multi-query
attention; the output layer is the untied ``lm_head`` where there is one,
at the same ``vocab_size x d_model``.
"""

from __future__ import annotations

from typing import Dict, Sequence

from benchmark.arith import BF16, PEAK_BF16_FLOPS, PEAK_BYTES_PER_S
from benchmark.reference.fido_t5 import cross_layers


def fido_params(cfg: dict) -> Dict[str, int]:
    """Parameter counts: ``enc`` and ``dec`` stacks (norms and relative
    positions included), ``cross_kv`` (the decoder's cross K/V projections,
    part of ``dec``), ``head`` (the output layer) and ``n_cross``."""
    d, inner, ff = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"], cfg["d_ff"]
    kv_inner = cfg["d_kv"] if cfg.get("multiquery_cross_attention") else inner
    rel = cfg["relative_attention_num_buckets"] * cfg["num_heads"]
    attn = 4 * d * inner
    mlp = (3 if cfg["feed_forward_proj"].startswith("gated-") else 2) * d * ff
    n_cross = len(cross_layers(cfg))
    cross_kv = n_cross * 2 * d * kv_inner
    cross = n_cross * (2 * d * inner + d) + cross_kv
    enc = cfg["num_layers"] * (attn + mlp + 2 * d) + rel + d
    dec = cfg["num_decoder_layers"] * (attn + mlp + 2 * d) + cross + rel + d
    return {"enc": enc, "dec": dec, "cross_kv": cross_kv, "head": cfg["vocab_size"] * d,
            "n_cross": n_cross}


def read_flops(cfg: dict, enc_tokens: Sequence[int], steps: Sequence[int]) -> float:
    """Forward of one read: each real row's unmasked passage tokens through
    the encoder and the cross K/V projections, and its decode steps."""
    p = fido_params(cfg)
    return 2.0 * ((p["enc"] + p["cross_kv"]) * sum(enc_tokens)
                  + (p["dec"] - p["cross_kv"] + p["head"]) * sum(steps))


def replay_least_s(cfg: dict, enc_tokens: Sequence[int], steps: Sequence[int]) -> float:
    """The least time on the card of the decode steps after step 0 (those the
    engine's graph replays): for each step the answers need, the larger of
    its operations over the peak and the bytes it must read over the memory
    rate. The bytes: the decoder's weights without the cross K/V projections
    and the output layer, once, and for each row still decoding its cross
    K/V over its unmasked tokens and its self-attention cache so far."""
    p = fido_params(cfg)
    inner = cfg["num_heads"] * cfg["d_kv"]
    kv_inner = cfg["d_kv"] if cfg.get("multiquery_cross_attention") else inner
    layers = cfg["num_decoder_layers"]
    step_w = p["dec"] - p["cross_kv"] + p["head"]
    t = 0.0
    for s in range(1, max(steps, default=0)):
        live = [k for k, n in zip(enc_tokens, steps) if n > s]
        kv = sum((p["n_cross"] * 2 * kv_inner * k + layers * 2 * inner * (s + 1)) * BF16
                 for k in live)
        t += max(2.0 * step_w * len(live) / PEAK_BF16_FLOPS,
                 (step_w * BF16 + kv) / PEAK_BYTES_PER_S)
    return t
