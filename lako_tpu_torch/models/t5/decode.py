"""Decode entry points for the FiD reader.

Counterpart of lako_tpu/models/t5/decode.py. ``greedy_generate`` is the
layer-unrolled path: the model's own decoder blocks, one incremental step at
a time (``FiDT5.decode_step``), with per-layer self-attention caches and the
cross K/V projected once. It is the path for FiDO decoders
(``cross_attention_stride``), token elimination (``keep_tokens``) and
``early_exit``, a host loop that stops once every row has emitted EOS.
``make_best_generate_fn`` dispatches like the JAX function of the same
name: the stacked-weight engines (models/t5/engine.py greedy,
models/t5/beam_engine.py beam) where the model allows, the layer-unrolled
paths (this module, models/t5/beam.py) otherwise.

Step 0 runs on its own and returns the (B, layers, heads, N·L) pre-softmax
cross-attention logits when asked: the reference stores only the first
decode step's scores.

Not ported yet: ``make_generate_and_score_fn`` (it needs the attention
signal's aggregation, ROADMAP item 6).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from lako_tpu_torch.core.logging import get_logger
from lako_tpu_torch.models.t5.engine import engine_supported, make_engine_generate_fn
from lako_tpu_torch.models.t5.layers import top_k
from lako_tpu_torch.models.t5.model import FiDT5


def eliminate_tokens(enc: torch.Tensor, enc_mask: torch.Tensor, keep_tokens: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token elimination: keep only the ``keep_tokens`` encoder states of
    highest salience (L2 norm) per example before the decoder cross-attends.
    Masked positions have salience -inf; among equal saliences the lower
    position wins, as with ``lax.top_k``."""
    salience = torch.linalg.vector_norm(enc.float(), dim=-1)
    salience = torch.where(enc_mask, salience, torch.full_like(salience, float("-inf")))
    _, idx = top_k(salience, keep_tokens)                   # (B, K)
    kept = torch.gather(enc, 1, idx[:, :, None].expand(-1, -1, enc.shape[-1]))
    return kept, torch.gather(enc_mask, 1, idx)


@torch.inference_mode()
def greedy_generate(model: FiDT5, input_ids: torch.Tensor, mask: torch.Tensor,
                    max_length: int = 50, collect_cross_scores: bool = False,
                    early_exit: bool = False, keep_tokens: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Greedy decode on the layer-unrolled path. Returns (tokens (B,
    max_length-1) int32, first-step cross-attention logits (B, layers, heads,
    N·L) f32 or None).

    ``max_length`` counts the decoder-start token like HF generate.
    ``keep_tokens`` enables token elimination (incompatible with score
    capture: positions lose their collate-time span mapping)."""
    cfg = model.config
    B = input_ids.shape[0]
    steps = max_length - 1
    dec = model.t5.decoder
    enc, enc_mask = model.encode_passages(input_ids, mask)
    if keep_tokens is not None and keep_tokens < enc.shape[1]:
        if collect_cross_scores:
            raise ValueError("token elimination breaks fact-span mapping; "
                             "disable collect_cross_scores")
        enc, enc_mask = eliminate_tokens(enc, enc_mask, keep_tokens)
    caches, cross_kvs = dec.init_cache(B, steps, enc)
    self_bias_full, cross_bias = dec.decode_biases(enc_mask, steps)

    def one_step(tokens, step, collect):
        return model.decode_step(tokens, self_bias_full, cross_bias, caches, cross_kvs,
                                 step, steps, collect)

    start = torch.full((B,), cfg.decoder_start_token_id, dtype=torch.long,
                       device=enc.device)
    logits0, xl0 = one_step(start, 0, collect_cross_scores)
    tok = logits0.argmax(dim=-1)
    done = tok == cfg.eos_token_id
    tokens = torch.full((B, steps), cfg.pad_token_id, dtype=torch.long, device=enc.device)
    tokens[:, 0] = tok
    pad = torch.full_like(tok, cfg.pad_token_id)
    for step in range(1, steps):
        if early_exit and bool(done.all()):
            break
        logits, _ = one_step(tok, step, False)
        tok = torch.where(done, pad, logits.argmax(dim=-1))
        done = done | (tok == cfg.eos_token_id)
        tokens[:, step] = tok
    return tokens.to(torch.int32), xl0


def make_generate_fn(model: FiDT5, max_length: int = 50,
                     collect_cross_scores: bool = False, early_exit: bool = False,
                     keep_tokens: Optional[int] = None) -> Callable:
    """(input_ids, mask) → (tokens, cross_logits | None) on the
    layer-unrolled path."""

    def fn(input_ids, mask):
        return greedy_generate(model, input_ids, mask, max_length=max_length,
                               collect_cross_scores=collect_cross_scores,
                               early_exit=early_exit, keep_tokens=keep_tokens)

    return fn


def make_best_generate_fn(
    model: FiDT5, max_length: int = 50, collect_cross_scores: bool = False,
    keep_tokens: Optional[int] = None, backend: str = "auto",
    kv_dtype: str = "native", weights_dtype: str = "native",
    chunk_size: Optional[int] = None, early_exit: bool = False,
    num_beams: int = 1, length_penalty: float = 1.0,
    self_attn_impl: str = "allslots", fused_cross: bool = False,
) -> Callable:
    """(input_ids, mask) → (tokens (B, max_length-1), first-step cross logits
    | None), dispatched like the JAX function of the same name.

    backend: "auto" | "engine" | "flax". Token elimination (keep_tokens) and
    the early_exit loop belong to the layer-unrolled path; the engine covers
    early exit with ``chunk_size``. ``num_beams > 1`` selects beam search;
    score capture needs greedy decode. ``self_attn_impl`` is the beam
    engine's self-KV formulation (greedy ignores it). ``fused_cross`` is
    passed to the greedy engine: with ``kv_dtype="int8"`` it runs decode
    cross-attention through the CUDA kernel.
    """
    if num_beams > 1:
        if collect_cross_scores:
            raise ValueError("cross-attention score capture requires greedy decode")
        # features no beam path implements fail loudly rather than silently
        # change semantics (keep_tokens) or memory behavior (int8 dtypes)
        if keep_tokens is not None:
            raise ValueError(
                "keep_tokens (token elimination) is not supported with "
                "beam search; use greedy decode or drop keep_tokens")
        if kv_dtype != "native" or weights_dtype != "native":
            raise ValueError(
                "int8 decode dtypes are not supported with beam search (native only)")
        if early_exit or chunk_size is not None or fused_cross:
            get_logger().warning(
                "beam search ignores early_exit/chunk_size/fused_cross (greedy-only "
                "knobs); decoding the full %d steps", max_length - 1)
        beam_ok = engine_supported(model.config)
        if backend == "engine" and not beam_ok:
            raise ValueError(
                "decode_backend='engine' but the beam engine does not "
                "support this configuration (FiDO cross_attention_stride)")
        if backend != "flax" and beam_ok:
            from lako_tpu_torch.models.t5.beam_engine import make_beam_engine_generate_fn

            beam_fn = make_beam_engine_generate_fn(
                model, max_length=max_length, num_beams=num_beams,
                length_penalty=length_penalty, self_attn_impl=self_attn_impl)
        else:
            if self_attn_impl != "allslots":
                raise ValueError(
                    f"self_attn_impl={self_attn_impl!r} is a beam-engine "
                    "knob; the layer-unrolled beam path has no equivalent: drop it "
                    "or use backend='engine'")
            from lako_tpu_torch.models.t5.beam import make_beam_generate_fn

            beam_fn = make_beam_generate_fn(model, max_length=max_length,
                                            num_beams=num_beams,
                                            length_penalty=length_penalty)
        return lambda ids, mask: (beam_fn(ids, mask), None)

    if self_attn_impl != "allslots":
        get_logger().warning(
            "self_attn_impl=%r only affects beam search (num_beams>1); "
            "greedy decode ignores it", self_attn_impl)
    engine_ok = (engine_supported(model.config) and keep_tokens is None
                 and not early_exit)
    if backend == "engine" and not engine_ok:
        raise ValueError(
            "decode_backend='engine' but the engine does not support this "
            "configuration (FiDO stride / keep_tokens / early_exit)")
    if backend != "flax" and engine_ok:
        return make_engine_generate_fn(
            model, max_length=max_length,
            collect_cross_scores=collect_cross_scores, kv_dtype=kv_dtype,
            weights_dtype=weights_dtype, fused_cross=fused_cross,
            chunk_size=chunk_size)
    return make_generate_fn(model, max_length=max_length,
                            collect_cross_scores=collect_cross_scores,
                            early_exit=early_exit, keep_tokens=keep_tokens)


def make_generate_and_score_fn(model: FiDT5, signal_cfg, max_length: int = 50,
                               backend: str = "auto", kv_dtype: str = "native",
                               weights_dtype: str = "native", chunk_size=None) -> Callable:
    """Generate plus on-device fact-score aggregation: not ported yet."""
    raise NotImplementedError(
        "make_generate_and_score_fn needs the attention signal's aggregation "
        "(signal/aggregate.py), not ported yet (ROADMAP item 6)")
