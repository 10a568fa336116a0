"""K-streamed attention for the T5 encoder: the port of K1's forward.

Counterpart of lako_tpu/ops/flash_streamed.py. ``streamed_attention`` computes
unscaled softmax attention with a factored bias, a batch-free relative-position
block ``(H, L, Lk)`` plus a ``(B, Lk)`` key mask, so the ``(B, H, L, Lk)`` bias
never exists. On CUDA tensors it launches the hand-written kernel in
``csrc/flash_streamed_fwd.cu``; on CPU tensors it runs
:func:`streamed_attention_reference`, the plain version. The backward (the
JAX package's three-pass K2) is not ported yet, so inputs that require grad
are refused.
"""

from __future__ import annotations

import torch

from lako_tpu_torch.ops import _build

NEG_INF = -1e9
KERNEL_HEAD_DIMS = (64, 128)


def streamed_attention_reference(q, k, v, rel_bias, key_mask):
    """Plain PyTorch version (mirrors the JAX ``_xla_reference``)."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float()
    logits = logits + rel_bias.float()[None]
    logits = logits.masked_fill(~key_mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _check(q, k, v, rel_bias, key_mask):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q, k, v must be (B,H,L,D), (B,H,Lk,D), (B,H,Lk,D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, L, D = q.shape
    Lk = k.shape[2]
    if k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if tuple(rel_bias.shape) != (H, L, Lk) or rel_bias.dtype != torch.float32:
        raise ValueError(f"rel_bias must be ({H},{L},{Lk}) float32, got "
                         f"{tuple(rel_bias.shape)} {rel_bias.dtype}")
    if tuple(key_mask.shape) != (B, Lk) or key_mask.dtype != torch.bool:
        raise ValueError(f"key_mask must be ({B},{Lk}) bool, got "
                         f"{tuple(key_mask.shape)} {key_mask.dtype}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype in float32|bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    tensors = (q, k, v, rel_bias, key_mask)
    if any(t.device != q.device for t in tensors):
        raise ValueError("streamed_attention inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("streamed_attention inputs must be contiguous")
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "streamed_attention has no backward yet (the JAX package's K2 "
            "passes are still to port, ROADMAP kernel queue)")


def streamed_attention(q, k, v, rel_bias, key_mask):
    """Online-softmax attention ``(B,H,L,D) -> (B,H,L,D)``.

    rel_bias: ``(H, L, Lk)`` float32, shared by the batch. key_mask:
    ``(B, Lk)`` bool, True = attend. Masked keys get logit -1e9 (never
    -inf): a row with every key masked averages V over the real keys.
    """
    _check(q, k, v, rel_bias, key_mask)
    if q.device.type == "cpu":
        return streamed_attention_reference(q, k, v, rel_bias, key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"streamed_attention: no kernel for device {q.device}")
    B, H, L, D = q.shape
    Lk = k.shape[2]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"streamed_attention kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    if B > 65535 or H > 65535:
        raise ValueError(f"streamed_attention grid too large: B={B}, H={H}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("streamed_attention kernel needs 16-byte aligned q, k, v")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        fn = _build.bind("lako_flash_streamed_fwd", 6, 6)
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_bias.data_ptr(),
                  key_mask.data_ptr(), out.data_ptr(), B, H, L, Lk, D,
                  _build.DTYPE_CODES[q.dtype], _build.stream_of(q))
    _build.check_launch(code, "streamed_attention")
    streamed_attention.launches += 1
    return out


streamed_attention.launches = 0
