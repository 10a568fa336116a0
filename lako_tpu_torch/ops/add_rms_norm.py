"""A residual add and the RMS norm after it in one launch: K8.

K8 replaces no ``pallas_call``: the JAX engine's step is one jitted program,
which XLA fuses on the TPU. The port's decode step (models/t5/engine.py
``DecodeEngine._one_step``) meets the same pair at every norm site: the
block output ``delta`` joins the residual stream ``x``, and the sum is
normalised for the next block, T5's scale-only RMS norm with f32
statistics. In plain PyTorch that is nine launches a site
(:func:`add_rms_norm_reference`); on CUDA tensors :func:`add_rms_norm`
launches ``csrc/add_rms_norm.cu`` once for all rows, built as a library of
its own (``_build.LIBRARIES["norm"]``), so that a decode-only process
compiles this one source. On CPU tensors it runs the plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from lako_tpu_torch.ops import _build

# csrc/add_rms_norm.cu MAX_H, MAX_ROWS: 16 warps of 4 16-byte vectors a
# lane hold an f32 row of 8192; one block a row, rows on the grid
MAX_H = 8192
MAX_ROWS = 65535


def add_rms_norm_reference(x: torch.Tensor, delta: Optional[torch.Tensor],
                           weight: torch.Tensor, eps: float):
    """``x + delta`` (``x`` when ``delta`` is None) and its RMS norm times
    ``weight``: the statistics in f32, the normalised value and the weight
    rounded to ``x``'s dtype before their product."""
    if delta is not None:
        x = x + delta
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return x, (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


def _check(x, delta, weight):
    if x.dim() != 2:
        raise ValueError(f"x must be (B, H), got {tuple(x.shape)}")
    B, H = x.shape
    if x.dtype not in _build.DTYPE_CODES or weight.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"x and weight must be float32|bfloat16, got {x.dtype}, {weight.dtype}")
    if H % 8 or not 8 <= H <= MAX_H or B > MAX_ROWS:
        raise ValueError(f"add_rms_norm takes H a multiple of 8 up to {MAX_H} and at most "
                         f"{MAX_ROWS} rows, got ({B}, {H})")
    if tuple(weight.shape) != (H,):
        raise ValueError(f"weight must be ({H},), got {tuple(weight.shape)}")
    if delta is not None and (delta.shape != x.shape or delta.dtype != x.dtype):
        raise ValueError(f"delta must be {tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(delta.shape)} {delta.dtype}")
    tensors = (x, weight) if delta is None else (x, delta, weight)
    if any(t.device != x.device for t in tensors):
        raise ValueError("add_rms_norm inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("add_rms_norm inputs must be contiguous")
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError("add_rms_norm is inference only")
    return tensors


def add_rms_norm(x: torch.Tensor, delta: Optional[torch.Tensor], weight: torch.Tensor,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_new, xn): ``x_new = x + delta`` in x's dtype (``x`` itself when
    ``delta`` is None) and ``xn`` its RMS norm times ``weight``, rounded as
    :func:`add_rms_norm_reference` rounds; only the order of the f32 sum of
    squares differs on the card.

    x, delta: (B, H) float32 or bfloat16, H a multiple of 8 up to
    :data:`MAX_H`, B up to :data:`MAX_ROWS`. weight: (H,) float32 or
    bfloat16.
    """
    tensors = _check(x, delta, weight)
    if x.device.type == "cpu":
        return add_rms_norm_reference(x, delta, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"add_rms_norm: no kernel for device {x.device}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("add_rms_norm inputs must start on 16-byte boundaries")
    x_new = x if delta is None else torch.empty_like(x)
    xn = torch.empty_like(x)
    with torch.cuda.device(x.device):
        fn = _build.bind("lako_add_rms_norm", 5, 4, 0, 1, "norm")
        code = fn(x.data_ptr(), None if delta is None else delta.data_ptr(), weight.data_ptr(),
                  x_new.data_ptr(), xn.data_ptr(), x.shape[0], x.shape[1],
                  _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[weight.dtype], eps,
                  _build.stream_of(x))
    _build.check_launch(code, "add_rms_norm")
    add_rms_norm.launches += 1
    return x_new, xn


add_rms_norm.launches = 0
