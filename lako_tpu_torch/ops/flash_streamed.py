"""K-streamed attention for the T5 encoder: the port of K1 and its backward K2.

Counterpart of lako_tpu/ops/flash_streamed.py. ``streamed_attention`` computes
unscaled softmax attention with a factored bias, a batch-free relative-position
block ``(H, L, Lk)`` plus a ``(B, Lk)`` key mask, so the ``(B, H, L, Lk)`` bias
never exists. Where an input requires grad it is a ``torch.autograd.Function``
(the JAX ``custom_vjp``): the forward also keeps per-row statistics, and the
backward runs the three streamed passes of the JAX package (K2a dK/dV, K2b dQ,
K2c drel), recomputing P from those statistics.

On CUDA tensors the wrappers launch the hand-written kernels in
``csrc/flash_streamed_fwd.cu`` and ``csrc/flash_streamed_bwd.cu``; on CPU
tensors they run the plain versions in this module:
:func:`streamed_attention_reference` (no statistics),
:func:`streamed_attention_fwd_reference`,
:func:`streamed_attention_bwd_reference` and one plain version for each
backward kernel (``streamed_attention_bwd_{dkdv,dq,drel}_reference``).

The statistics are ``(B, H, L, 2)`` float32: each row's max ``m`` and its sum
``l`` of ``exp(S - m)``, so that ``P = exp(S - m) / l``. The JAX kernel keeps
``lse = m + log(l)`` instead, which is wrong on a fully masked row (the
padding rows of ``collate(pad_to=B)``): every logit there is -1e9, an f32 ulp
at 1e9 is 64, so ``log(Lk)`` is lost and ``exp(S - lse)`` is 1 per key instead
of ``1/Lk``. With ``(m, l) = (-1e9, Lk)`` the pair is exact, and dS is zeroed
at masked keys, so such a row contributes ``dO/Lk`` to dV and nothing to dQ,
dK or drel, as the plain autograd gradient does.
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


def _logits(q, k, rel_bias, key_mask):
    """f32 logits from the inputs taken to f32, as the kernels compute them."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) + rel_bias.float()[None]
    return logits.masked_fill(~key_mask[:, None, None, :], NEG_INF)


def streamed_attention_fwd_reference(q, k, v, rel_bias, key_mask):
    """Plain forward with the row statistics: ``(out, stats)``, stats
    ``(B, H, L, 2)`` float32 holding each row's max and sum of exp(S - max)."""
    logits = _logits(q, k, rel_bias, key_mask)
    m = logits.amax(dim=-1)
    e = torch.exp(logits - m[..., None])
    l = e.sum(dim=-1)
    probs = (e / l[..., None]).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    return out, torch.stack([m, l], dim=-1)


def _p_ds(q, k, v, rel_bias, key_mask, stats, dvec, dout):
    """P from the statistics and dS = P (dP - D), zeroed at masked keys; f32."""
    logits = _logits(q, k, rel_bias, key_mask)
    p = torch.exp(logits - stats[..., 0, None]) / stats[..., 1, None]
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    ds = (p * (dp - dvec[..., None])).masked_fill(~key_mask[:, None, None, :], 0.0)
    return p, ds


# P is rounded to v's dtype before dV and dS to q's before dK and dQ, as the
# kernels (and the JAX package's) do; drel sums the f32 dS.
def _dk_dv(p, ds, q, k, v, dout):
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float()).to(k.dtype)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(v.dtype).float(), dout.float()).to(v.dtype)
    return dk, dv


def _dq(ds, q, k):
    return torch.einsum("bhqk,bhkd->bhqd", ds.to(q.dtype).float(), k.float()).to(q.dtype)


def streamed_attention_bwd_dkdv_reference(q, k, v, rel_bias, key_mask, stats, dvec, dout):
    """Plain K2a: ``(dk, dv)``."""
    p, ds = _p_ds(q, k, v, rel_bias, key_mask, stats, dvec, dout)
    return _dk_dv(p, ds, q, k, v, dout)


def streamed_attention_bwd_dq_reference(q, k, v, rel_bias, key_mask, stats, dvec, dout):
    """Plain K2b: dq."""
    return _dq(_p_ds(q, k, v, rel_bias, key_mask, stats, dvec, dout)[1], q, k)


def streamed_attention_bwd_drel_reference(q, k, v, rel_bias, key_mask, stats, dvec, dout):
    """Plain K2c: drel ``(H, L, Lk)`` float32."""
    return _p_ds(q, k, v, rel_bias, key_mask, stats, dvec, dout)[1].sum(dim=0)


def _dvec(out, dout):
    """D = rowsum(dO * O) in f32, the (B, H, L) term every pass reads."""
    return (dout.float() * out.float()).sum(dim=-1).contiguous()


def streamed_attention_bwd_reference(q, k, v, rel_bias, key_mask, out, stats, dout):
    """Plain backward: ``(dq, dk, dv, drel)``, drel ``(H, L, Lk)`` float32
    summed over the batch."""
    p, ds = _p_ds(q, k, v, rel_bias, key_mask, stats, _dvec(out, dout), dout)
    return (_dq(ds, q, k), *_dk_dv(p, ds, q, k, v, dout), ds.sum(dim=0))


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


def _check_kernel(q, what):
    """What only the CUDA kernels require; raises for any other device."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    B, H, _, D = q.shape
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head dims {KERNEL_HEAD_DIMS}, got {D}")
    if B > 65535 or H > 65535:
        raise ValueError(f"{what} grid too large: B={B}, H={H}")


def _check_bwd(q, k, v, rel_bias, key_mask, stats, dvec, dout):
    _check(q, k, v, rel_bias, key_mask)
    B, H, L, _ = q.shape
    if tuple(stats.shape) != (B, H, L, 2) or stats.dtype != torch.float32:
        raise ValueError(f"stats must be ({B},{H},{L},2) float32, got "
                         f"{tuple(stats.shape)} {stats.dtype}")
    if tuple(dvec.shape) != (B, H, L) or dvec.dtype != torch.float32:
        raise ValueError(f"dvec must be ({B},{H},{L}) float32, got "
                         f"{tuple(dvec.shape)} {dvec.dtype}")
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout must match q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(dout.shape)} {dout.dtype}")
    extra = (stats, dvec, dout)
    if any(t.device != q.device for t in extra) or not all(t.is_contiguous() for t in extra):
        raise ValueError("stats, dvec and dout must be contiguous, on q's device")


def _forward(q, k, v, rel_bias, key_mask, with_stats: bool):
    """(out, stats | None): the plain version on the CPU, else K1."""
    if q.device.type == "cpu":
        if with_stats:
            return streamed_attention_fwd_reference(q, k, v, rel_bias, key_mask)
        return streamed_attention_reference(q, k, v, rel_bias, key_mask), None
    _check_kernel(q, "streamed_attention")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("streamed_attention kernel needs 16-byte aligned q, k, v")
    B, H, L, D = q.shape
    Lk = k.shape[2]
    out = torch.empty_like(q)
    stats = (torch.empty(B, H, L, 2, dtype=torch.float32, device=q.device)
             if with_stats else None)
    with torch.cuda.device(q.device):
        fn = _build.bind("lako_flash_streamed_fwd", 7, 6)
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_bias.data_ptr(),
                  key_mask.data_ptr(), out.data_ptr(),
                  None if stats is None else stats.data_ptr(), B, H, L, Lk, D,
                  _build.DTYPE_CODES[q.dtype], _build.stream_of(q))
    _build.check_launch(code, "streamed_attention")
    streamed_attention.launches += 1
    return out, stats


def _launch_bwd(entry, n_pointers, q, k, v, rel_bias, key_mask, stats, dvec, dout,
                outputs, what):
    B, H, L, D = q.shape
    with torch.cuda.device(q.device):
        fn = _build.bind(entry, n_pointers, 6)
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_bias.data_ptr(),
                  key_mask.data_ptr(), stats.data_ptr(), dvec.data_ptr(),
                  dout.data_ptr(), *(t.data_ptr() for t in outputs), B, H, L,
                  k.shape[2], D, _build.DTYPE_CODES[q.dtype], _build.stream_of(q))
    _build.check_launch(code, what)


def streamed_attention_bwd_dkdv(q, k, v, rel_bias, key_mask, stats, dvec, dout):
    """K2a: ``(dk, dv)``. stats from the forward, dvec = rowsum(dO * O) f32."""
    _check_bwd(q, k, v, rel_bias, key_mask, stats, dvec, dout)
    if q.device.type == "cpu":
        return streamed_attention_bwd_dkdv_reference(q, k, v, rel_bias, key_mask, stats,
                                                     dvec, dout)
    _check_kernel(q, "streamed_attention_bwd_dkdv")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("lako_flash_streamed_bwd_dkdv", 10, q, k, v, rel_bias, key_mask, stats,
                dvec, dout, (dk, dv), "streamed_attention_bwd_dkdv")
    streamed_attention_bwd_dkdv.launches += 1
    return dk, dv


def streamed_attention_bwd_dq(q, k, v, rel_bias, key_mask, stats, dvec, dout):
    """K2b: dq."""
    _check_bwd(q, k, v, rel_bias, key_mask, stats, dvec, dout)
    if q.device.type == "cpu":
        return streamed_attention_bwd_dq_reference(q, k, v, rel_bias, key_mask, stats,
                                                   dvec, dout)
    _check_kernel(q, "streamed_attention_bwd_dq")
    dq = torch.empty_like(q)
    _launch_bwd("lako_flash_streamed_bwd_dq", 9, q, k, v, rel_bias, key_mask, stats,
                dvec, dout, (dq,), "streamed_attention_bwd_dq")
    streamed_attention_bwd_dq.launches += 1
    return dq


def streamed_attention_bwd_drel(q, k, v, rel_bias, key_mask, stats, dvec, dout):
    """K2c: drel ``(H, L, Lk)`` float32, dS summed over the batch."""
    _check_bwd(q, k, v, rel_bias, key_mask, stats, dvec, dout)
    if q.device.type == "cpu":
        return streamed_attention_bwd_drel_reference(q, k, v, rel_bias, key_mask, stats,
                                                     dvec, dout)
    _check_kernel(q, "streamed_attention_bwd_drel")
    drel = torch.empty(rel_bias.shape, dtype=torch.float32, device=q.device)
    _launch_bwd("lako_flash_streamed_bwd_drel", 9, q, k, v, rel_bias, key_mask, stats,
                dvec, dout, (drel,), "streamed_attention_bwd_drel")
    streamed_attention_bwd_drel.launches += 1
    return drel


def streamed_attention_bwd(q, k, v, rel_bias, key_mask, out, stats, dout):
    """``(dq, dk, dv, drel)``: the plain version on the CPU, else K2a, K2b, K2c."""
    if q.device.type == "cpu":
        return streamed_attention_bwd_reference(q, k, v, rel_bias, key_mask, out, stats, dout)
    # D = rowsum(dO * O) outside the kernels, as the JAX package computes it
    dvec = _dvec(out, dout)
    args = (q, k, v, rel_bias, key_mask, stats, dvec, dout)
    dk, dv = streamed_attention_bwd_dkdv(*args)
    return (streamed_attention_bwd_dq(*args), dk, dv, streamed_attention_bwd_drel(*args))


class _StreamedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rel_bias, key_mask):
        out, stats = _forward(q, k, v, rel_bias, key_mask, with_stats=True)
        ctx.save_for_backward(q, k, v, rel_bias, key_mask, out, stats)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, rel_bias, key_mask, out, stats = ctx.saved_tensors
        dq, dk, dv, drel = streamed_attention_bwd(q, k, v, rel_bias, key_mask, out, stats,
                                                  dout.contiguous())
        return dq, dk, dv, drel, None


def streamed_attention(q, k, v, rel_bias, key_mask):
    """Online-softmax attention ``(B,H,L,D) -> (B,H,L,D)``, differentiable in
    q, k, v and rel_bias.

    rel_bias: ``(H, L, Lk)`` float32, shared by the batch. key_mask:
    ``(B, Lk)`` bool, True = attend. Masked keys get logit -1e9 (never
    -inf): a row with every key masked averages V over the real keys.
    Without grad the forward skips the statistics.
    """
    _check(q, k, v, rel_bias, key_mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, rel_bias)):
        return _StreamedAttention.apply(q, k, v, rel_bias, key_mask)
    return _forward(q, k, v, rel_bias, key_mask, with_stats=False)[0]


streamed_attention.launches = 0
streamed_attention_bwd_dkdv.launches = 0
streamed_attention_bwd_dq.launches = 0
streamed_attention_bwd_drel.launches = 0
