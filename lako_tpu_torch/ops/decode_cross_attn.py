"""Fused decode cross-attention on int8 K/V: the port of K3.

Counterpart of lako_tpu/ops/decode_cross_attn.py. One decode step of
cross-attention against int8 K/V laid out ``(B, h, d, K)`` with the key axis
minor (models/t5/engine.py ``_quantize_kv``). The per-(b,h,d) K scale folds
into q and the V scale into the output, so K/V stay int8 until they are in
registers. On CUDA tensors the wrapper launches ``csrc/decode_cross_attn.cu``
(any number of keys K; the keys of a (b, h) split over up to 8 blocks, merged
in the same launch); on CPU tensors it runs :func:`reference`, the plain
version.
"""

from __future__ import annotations

import torch

from lako_tpu_torch.ops import _build

# 16 warps of 32 keys' lanes, each over up to 3 groups of 16 output rows;
# shared memory holds a one-stage ring of int8 K/V tiles up to here
MAX_HEAD_DIM = 768


def reference(q, k_i8, k_scale, v_i8, v_scale, bias):
    """Dequantize-then-attend (mirrors the JAX ``xla_reference``)."""
    if k_scale.dim() == 3:
        k_scale = k_scale[..., None]
    if v_scale.dim() == 3:
        v_scale = v_scale[..., None]
    kf = k_i8.float() * k_scale.float()
    vf = v_i8.float() * v_scale.float()
    logits = torch.einsum("bhd,bhdk->bhk", q.float(), kf) + bias.float()
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhk,bhdk->bhd", p, vf)


def _check(q, k_i8, k_scale, v_i8, v_scale, bias):
    if k_i8.dim() != 4 or v_i8.shape != k_i8.shape:
        raise ValueError(f"k_i8/v_i8 must be (B,h,d,K), got {tuple(k_i8.shape)}, "
                         f"{tuple(v_i8.shape)}")
    B, h, d, K = k_i8.shape
    if tuple(q.shape) != (B, h, d):
        raise ValueError(f"q must be ({B},{h},{d}), got {tuple(q.shape)}")
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(s.shape) != (B, h, d) or s.dtype != torch.float32:
            raise ValueError(f"{name} must be ({B},{h},{d}[,1]) float32, got "
                             f"{tuple(s.shape)} {s.dtype}")
    if tuple(bias.shape) != (B, 1, K) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be ({B},1,{K}) float32, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if k_i8.dtype != torch.int8 or v_i8.dtype != torch.int8:
        raise ValueError(f"k_i8/v_i8 must be int8, got {k_i8.dtype}, {v_i8.dtype}")
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"q must be float32|bfloat16, got {q.dtype}")
    tensors = (q, k_i8, k_scale, v_i8, v_scale, bias)
    if any(t.device != q.device for t in tensors):
        raise ValueError("fused_decode_cross_attention inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_decode_cross_attention inputs must be contiguous")
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError("fused_decode_cross_attention is inference only")


def fused_decode_cross_attention(q, k_i8, k_scale, v_i8, v_scale, bias):
    """One decode step of cross attention against int8 K/V.

    q: (B, h, d) compute-dtype queries. k_i8, v_i8: (B, h, d, K) int8.
    k_scale, v_scale: (B, h, d) or (B, h, d, 1) float32. bias: (B, 1, K)
    float32 additive (0 | -1e9) key mask. Returns (B, h, d) float32
    attention outputs (before the o-projection).
    """
    if k_scale.dim() == 4:
        k_scale = k_scale[..., 0]
    if v_scale.dim() == 4:
        v_scale = v_scale[..., 0]
    _check(q, k_i8, k_scale, v_i8, v_scale, bias)
    if q.device.type == "cpu":
        return reference(q, k_i8, k_scale, v_i8, v_scale, bias)
    if q.device.type != "cuda":
        raise ValueError(f"fused_decode_cross_attention: no kernel for device {q.device}")
    B, h, d, K = k_i8.shape
    if d > MAX_HEAD_DIM or B > 65535 or h > 65535:
        raise ValueError(f"fused_decode_cross_attention kernel limits exceeded: "
                         f"B={B}, h={h}, d={d} (at most {MAX_HEAD_DIM})")
    out = torch.empty((B, h, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        fn = _build.bind("lako_decode_cross_attn", 7, 5)
        code = fn(q.data_ptr(), k_i8.data_ptr(), k_scale.data_ptr(),
                  v_i8.data_ptr(), v_scale.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), B, h, d, K, _build.DTYPE_CODES[q.dtype],
                  _build.stream_of(q))
    _build.check_launch(code, "fused_decode_cross_attention")
    fused_decode_cross_attention.launches += 1
    return out


fused_decode_cross_attention.launches = 0
