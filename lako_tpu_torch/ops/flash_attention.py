"""Whole-block attention with a dense additive bias: the port of K4.

Counterpart of lako_tpu/ops/flash_attention.py. ``fused_attention`` computes
unscaled softmax attention ``(B,H,L,D) -> (B,H,L,D)`` with a bias
broadcastable to ``(B,H,L,Lk)`` that already holds the key masking (-1e9 at
masked keys). The encoder takes it where the JAX package takes its fused
Pallas kernel: ``use_flash_attention`` with ``L < flash_min_length`` and no
dropout in the way (models/t5/layers.py).

On CUDA tensors the wrapper launches the hand-written kernel in
``csrc/fused_attention.cu`` (any number of keys: above 512 a two-pass tier
streams them); on CPU tensors it runs
:func:`fused_attention_reference`, the JAX package's ``_xla_attention``.
Where an input requires grad it is a ``torch.autograd.Function``: the forward
is the kernel and the backward recomputes attention in plain PyTorch, as the
JAX ``custom_vjp`` recomputes it in XLA. Unlike the JAX backward, which
returns no bias gradient (so on its fused route the encoder's
relative-position embedding learns nothing from self-attention), this one
returns dq, dk, dv and dbias, dbias summed to the bias's own shape.

A row whose keys are all masked (the padding rows of ``collate(pad_to=B)``)
averages V over the real keys, as ``_xla_attention`` does; the JAX kernel
pads keys to 128 lanes with -1e9, so its padding keys share that row's weight.
"""

from __future__ import annotations

from typing import Optional

import torch

from lako_tpu_torch.ops import _build

MAX_HEAD_DIM = 128
_INT32_MAX = 2 ** 31 - 1


def fused_attention_reference(q, k, v, bias):
    """Plain PyTorch version (the JAX package's ``_xla_attention``)."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float()
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _check(q, k, v, bias):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q, k, v must be (B,H,L,D), (B,H,Lk,D), (B,H,Lk,D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, L, D = q.shape
    Lk = k.shape[2]
    if k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype in float32|bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("fused_attention q, k, v must be contiguous")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("fused_attention inputs lie on different devices")
    if bias is not None:
        if (bias.dim() != 4 or bias.dtype not in _build.DTYPE_CODES
                or bias.device != q.device):
            raise ValueError(f"bias must be a 4-d float32|bfloat16 tensor on q's device, "
                             f"got {tuple(bias.shape)} {bias.dtype} on {bias.device}")
        try:
            full = torch.broadcast_shapes(bias.shape, (B, H, L, Lk))
        except RuntimeError:
            full = None
        if full != (B, H, L, Lk):
            raise ValueError(f"bias {tuple(bias.shape)} does not broadcast to "
                             f"({B},{H},{L},{Lk})")


def _forward(q, k, v, bias):
    """The plain version on the CPU, else the K4 kernel."""
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: no kernel for device {q.device}")
    B, H, L, D = q.shape
    Lk = k.shape[2]
    if D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"fused_attention kernel takes head dims <= {MAX_HEAD_DIM} that "
                         f"are multiples of 8, got {D}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("fused_attention kernel needs 16-byte aligned q, k, v")
    if B * H > _INT32_MAX or L > 32 * 65535:
        raise ValueError(f"fused_attention grid too large: B={B}, H={H}, L={L}")
    strides, bias_code = (0, 0, 0, 0), _build.DTYPE_CODES[torch.float32]
    if bias is not None:
        strides = bias.expand(B, H, L, Lk).stride()
        bias_code = _build.DTYPE_CODES[bias.dtype]
        if sum((n - 1) * s for n, s in zip((B, H, L, Lk), strides)) > _INT32_MAX:
            raise ValueError("fused_attention bias too large for 32-bit strides")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        fn = _build.bind("lako_fused_attention", 5, 11)
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if bias is None else bias.data_ptr(), out.data_ptr(),
                  B, H, L, Lk, D, *strides, _build.DTYPE_CODES[q.dtype], bias_code,
                  _build.stream_of(q))
    _build.check_launch(code, "fused_attention")
    fused_attention.launches += 1
    return out


def fused_attention_bwd(q, k, v, bias, dout, need_bias_grad: bool = True):
    """``(dq, dk, dv, dbias | None)``: the gradients of the plain version,
    recomputed, as the JAX package's ``_bwd`` differentiates
    ``_xla_attention``; dbias takes the bias's shape and dtype."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with_bias = bias is not None and need_bias_grad
    if bias is not None:
        bias = bias.detach().requires_grad_(with_bias)
    with torch.enable_grad():
        out = fused_attention_reference(*leaves, bias)
        grads = torch.autograd.grad(out, leaves + ([bias] if with_bias else []), dout)
    return (*grads[:3], grads[3] if with_bias else None)


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return _forward(q, k, v, bias)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias = ctx.saved_tensors
        return fused_attention_bwd(q, k, v, bias, dout, ctx.needs_input_grad[3])


def fused_attention(q, k, v, bias: Optional[torch.Tensor]):
    """Softmax attention ``(B,H,L,D) -> (B,H,L,D)``, differentiable in q, k, v
    and bias. bias: None or broadcastable to ``(B,H,L,Lk)``, float32 or
    bfloat16, holding the key masking."""
    _check(q, k, v, bias)
    inputs = (q, k, v) if bias is None else (q, k, v, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _FusedAttention.apply(q, k, v, bias)
    return _forward(q, k, v, bias)


fused_attention.launches = 0
