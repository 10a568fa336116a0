"""Decode entry point for the FiD reader.

Counterpart of lako_tpu/models/t5/decode.py. Only the greedy route through the
stacked-weight engine (models/t5/engine.py) is ported. The layer-unrolled
greedy path (``greedy_generate``, which also carries token elimination and
the while-loop early exit) and beam search raise ``NotImplementedError``
until their ROADMAP items (3 and 10) land.
"""

from __future__ import annotations

from typing import Callable, Optional

from lako_tpu_torch.models.t5.engine import engine_supported, make_engine_generate_fn
from lako_tpu_torch.models.t5.model import FiDT5


def make_best_generate_fn(
    model: FiDT5, max_length: int = 50, collect_cross_scores: bool = False,
    keep_tokens: Optional[int] = None, backend: str = "auto",
    kv_dtype: str = "native", weights_dtype: str = "native",
    chunk_size: Optional[int] = None, early_exit: bool = False,
    num_beams: int = 1, fused_cross: bool = False,
) -> Callable:
    """(input_ids, mask) → (tokens (B, max_length-1), first-step cross logits
    | None), dispatched like the JAX function of the same name.

    backend: "auto" | "engine" | "flax". ``fused_cross`` is passed to the
    engine: with ``kv_dtype="int8"`` it runs decode cross-attention through
    the CUDA kernel.
    """
    if num_beams > 1:
        if collect_cross_scores:
            raise ValueError("cross-attention score capture requires greedy decode")
        raise NotImplementedError(
            f"beam search (num_beams={num_beams}) is not ported yet (ROADMAP item 10)")
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
    raise NotImplementedError(
        "the layer-unrolled greedy decode path (greedy_generate: FiDO stride, "
        "keep_tokens, early_exit, backend='flax') is not ported yet "
        "(ROADMAP item 3)")
