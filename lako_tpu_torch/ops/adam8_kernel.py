"""One-pass 8-bit Adam update: the port of K5, and its fragment K6.

Counterparts of lako_tpu/ops/adam8_kernel.py ``fused_adam8_update`` (K5) and
of ``k_ema`` in scripts/bench_adam8_micro.py (K6). K5 reads a leaf's gradient
and its blocked 8-bit moments (train/optim8.py ``Moment8``), and writes the
Adam direction u and the requantized moments in one pass. K6 is K5 without
the requantization: it dequantizes, takes the two EMAs and writes u in
bfloat16. The JAX package measures K5 against it to show what the
requantization costs.

On CUDA tensors the wrappers launch the hand-written kernels in
``csrc/adam8.cu``; on CPU tensors they run :func:`fused_adam8_update_reference`
and :func:`adam8_ema_fragment_reference`, which follow the Pallas bodies'
evaluation order step by step, so that the kernels' codes and scales come
out bitwise equal to them.
"""

from __future__ import annotations

import torch

from lako_tpu_torch.ops import _build
from lako_tpu_torch.train.optim8 import (
    Moment8,
    _blocked,
    _dequant,
    _dither,
    _quant_signed,
    _quant_unsigned,
    _unblocked,
    f32,
    fma32,
    jax_layout,
    salt_hash,
    sqrt32,
)

BLOCK = 256
_INT32_MAX = 2 ** 31 - 1


def _ema(g2d, mq, ms, vq, vs, b1, b2, one_minus_b1, one_minus_b2):
    """Dequantized moments after one EMA step, in the Pallas body's order,
    ``b1*m + (1-b1)*g`` and ``b2*v + ((1-b2)*g)*g``, with the gradient's
    product fused into the add as XLA:CPU fuses it (optim8.py ``fma32``)."""
    m = fma32(f32(one_minus_b1), g2d, f32(b1) * _dequant(Moment8(mq, ms)))
    v = fma32(f32(one_minus_b2) * g2d, g2d, f32(b2) * _dequant(Moment8(vq, vs)))
    return m, v


def fused_adam8_update_reference(g, mq, ms, vq, vs, count: int, *, b1: float, b2: float,
                                 eps: float, correct_bias: bool, stochastic_round: bool,
                                 seed: int, leaf_salt: int, transposed: bool = False):
    """Plain version of K5 (the Pallas body ``_kernel``): ``(u, new_mq,
    new_ms, new_vq, new_vs)``, u shaped and typed like g."""
    gj = jax_layout(g, transposed)
    g2d = _blocked(gj, mq.shape[1])
    m, v = _ema(g2d, mq, ms, vq, vs, b1, b2, 1.0 - b1, 1.0 - b2)
    if correct_bias:
        c = torch.full((), float(count), device=g.device)

        def corr(b):
            return 1.0 - torch.exp(c * torch.log(torch.full((), f32(b), device=g.device)))

        u = (m / corr(b1)) / (sqrt32(v / corr(b2)) + f32(eps))
    else:
        u = m / (sqrt32(v) + f32(eps))
    k_m = k_v = None
    if stochastic_round:
        k_m = _dither(g2d.shape, count, seed + 2 * leaf_salt, g.device)
        k_v = _dither(g2d.shape, count, seed + 2 * leaf_salt + 1, g.device)
    qm, qv = _quant_signed(m, k_m), _quant_unsigned(v, k_v)
    u = jax_layout(_unblocked(u, gj.shape).to(g.dtype), transposed)
    return u, qm.q, qm.scale, qv.q, qv.scale


def _check_state(mq, ms, vq, vs, device):
    nb = mq.shape[0]
    if (mq.dim() != 2 or mq.shape[1] != BLOCK or mq.dtype != torch.int8
            or vq.shape != mq.shape or vq.dtype != torch.uint8):
        raise ValueError(f"codes must be (nb,{BLOCK}) int8 and uint8, got "
                         f"{tuple(mq.shape)} {mq.dtype}, {tuple(vq.shape)} {vq.dtype}")
    for s in (ms, vs):
        if tuple(s.shape) != (nb, 1) or s.dtype != torch.float32:
            raise ValueError(f"scales must be ({nb},1) float32, got {tuple(s.shape)} {s.dtype}")
    state = (mq, ms, vq, vs)
    if any(t.device != device for t in state) or not all(t.is_contiguous() for t in state):
        raise ValueError("the 8-bit state must be contiguous, on the gradient's device")


def fused_adam8_update(g, mq, ms, vq, vs, count: int, *, b1: float, b2: float, eps: float,
                       correct_bias: bool, stochastic_round: bool, seed: int,
                       leaf_salt: int, transposed: bool = False):
    """K5: one 8-bit Adam step of one leaf. g: the gradient in its own shape
    and dtype (float32 or bfloat16); with ``transposed`` a 2-d ``(out, in)``
    weight, blocked as the JAX package's ``(in, out)`` kernel. mq/vq:
    ``(nb, 256)`` int8/uint8 codes, ms/vs: ``(nb, 1)`` float32 scales, with
    ``nb = ceil(g.numel() / 256)``. Returns ``(u, new_mq, new_ms, new_vq,
    new_vs)``, u shaped and typed like g."""
    if g.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"g must be float32|bfloat16, got {g.dtype}")
    if transposed and g.dim() != 2:
        raise ValueError(f"a transposed leaf must be 2-d, got {tuple(g.shape)}")
    if mq.shape[0] != -(-g.numel() // BLOCK):
        raise ValueError(f"state of {mq.shape[0]} blocks for {g.numel()} elements")
    _check_state(mq, ms, vq, vs, g.device)
    if g.device.type == "cpu":
        return fused_adam8_update_reference(
            g, mq, ms, vq, vs, count, b1=b1, b2=b2, eps=eps, correct_bias=correct_bias,
            stochastic_round=stochastic_round, seed=seed, leaf_salt=leaf_salt,
            transposed=transposed)
    if g.device.type != "cuda":
        raise ValueError(f"fused_adam8_update: no kernel for device {g.device}")
    if not g.is_contiguous() or g.numel() > _INT32_MAX:
        raise ValueError("fused_adam8_update kernel needs a contiguous g of < 2**31 elements")
    rows, cols = g.shape if transposed else (0, 0)
    u = torch.empty_like(g)
    outs = (torch.empty_like(mq), torch.empty_like(ms), torch.empty_like(vq),
            torch.empty_like(vs))
    with torch.cuda.device(g.device):
        fn = _build.bind("lako_adam8_update", 10, 9, 2, 5)
        code = fn(g.data_ptr(), mq.data_ptr(), ms.data_ptr(), vq.data_ptr(), vs.data_ptr(),
                  u.data_ptr(), *(t.data_ptr() for t in outs), g.numel(), mq.shape[0],
                  rows, cols, int(transposed), count, int(correct_bias),
                  int(stochastic_round), _build.DTYPE_CODES[g.dtype],
                  salt_hash(count, seed + 2 * leaf_salt),
                  salt_hash(count, seed + 2 * leaf_salt + 1),
                  f32(b1), f32(b2), f32(1.0 - b1), f32(1.0 - b2), f32(eps),
                  _build.stream_of(g))
    _build.check_launch(code, "fused_adam8_update")
    fused_adam8_update.launches += 1
    return (u, *outs)


# k_ema's constants: b1, b2 and their complements written as literals
EMA_FRAGMENT_HYPER = dict(b1=0.9, b2=0.999, one_minus_b1=0.1, one_minus_b2=0.001, eps=1e-6)


def adam8_ema_fragment_reference(g2d, mq, ms, vq, vs):
    """Plain version of K6 (``k_ema``): u in bfloat16."""
    hp = EMA_FRAGMENT_HYPER
    m, v = _ema(g2d.float(), mq, ms, vq, vs, hp["b1"], hp["b2"], hp["one_minus_b1"],
                hp["one_minus_b2"])
    return (m / (sqrt32(v) + f32(hp["eps"]))).to(torch.bfloat16)


def adam8_ema_fragment(g2d, mq, ms, vq, vs):
    """K6: dequantize both moments, take the two EMAs with the blocked
    ``(nb, 256)`` gradient g2d (float32 or bfloat16) and write
    ``u = m / (sqrt(v) + 1e-6)`` in bfloat16; no requantization."""
    if g2d.dtype not in _build.DTYPE_CODES or g2d.shape != mq.shape:
        raise ValueError(f"g2d must be {tuple(mq.shape)} float32|bfloat16, got "
                         f"{tuple(g2d.shape)} {g2d.dtype}")
    _check_state(mq, ms, vq, vs, g2d.device)
    if g2d.device.type == "cpu":
        return adam8_ema_fragment_reference(g2d, mq, ms, vq, vs)
    if g2d.device.type != "cuda":
        raise ValueError(f"adam8_ema_fragment: no kernel for device {g2d.device}")
    if not g2d.is_contiguous():
        raise ValueError("adam8_ema_fragment kernel needs a contiguous g2d")
    u = torch.empty(g2d.shape, dtype=torch.bfloat16, device=g2d.device)
    hp = EMA_FRAGMENT_HYPER
    with torch.cuda.device(g2d.device):
        fn = _build.bind("lako_adam8_ema_fragment", 6, 2, 0, 5)
        code = fn(g2d.data_ptr(), mq.data_ptr(), ms.data_ptr(), vq.data_ptr(), vs.data_ptr(),
                  u.data_ptr(), mq.shape[0], _build.DTYPE_CODES[g2d.dtype],
                  *(f32(hp[k]) for k in ("b1", "b2", "one_minus_b1", "one_minus_b2", "eps")),
                  _build.stream_of(g2d))
    _build.check_launch(code, "adam8_ema_fragment")
    adam8_ema_fragment.launches += 1
    return u


fused_adam8_update.launches = 0
adam8_ema_fragment.launches = 0
