"""8-bit Adam: blockwise-quantized moments (int8 m, uint8 log-code v).

The port of lako_tpu/train/optim8.py. Both moments are stored at one byte per
parameter with one float32 scale per block of 256: m on a linear signed int8
code (scale = the block's absmax / 127), v on a log2 code,
``q = round((log2(blockmax) - log2(v)) * 8)`` with 255 reserved for exact
zero. Requantization rounds stochastically with a counter-based integer hash
of (element index, step, salt), so that the EMAs, which move ~0.1% a step,
track in expectation instead of freezing on the lattice. State: 2 bytes per
parameter plus 8 bytes per block, against 8 bytes for float32 AdamW.

``scale_by_adam_8bit`` takes the place of Adam in ``make_optimizer``'s chain
for ``optim="adamw8bit"``. ``use_kernel`` routes each leaf as the JAX package
does: "auto" sends CUDA tensors through the one-pass kernel K5
(ops/adam8_kernel.py, one launch over every leaf), each leaf in the rounding
order the JAX package gives it on its accelerator (the Pallas kernel's for a
leaf whose size is a multiple of 256 and at least 65536, :func:`kernel_route`,
the jnp formulation's otherwise), and CPU tensors through the jnp
formulation below, as the JAX transform does on the CPU; "never" always
takes the jnp formulation; "always" always takes K5's wrapper in the kernel's
order (its plain version on the CPU). The two orders differ where the JAX
package's paths do: ``(1-b2)*g*g`` and ``1 - exp(c*log(b))`` in the kernel
against ``(1-b2)*square(g)`` and ``1 - b**c`` here.

The state of all leaves lives in four flat buffers (codes and scales of both
moments, the leaves' rows stacked in ``leaf_order``); each leaf's ``Moment8``
is a view of its rows. An update writes four new buffers and leaves the old
state as it was, as the JAX transform does.

Two things keep the port's state the JAX package's, element for element:

- Layout. The state blocks each parameter in the JAX package's layout. A
  2-d leaf whose path ends in ``kernel`` is a dense weight of the port, whose
  ``(out, in)`` is the transpose of the flax kernel's ``(in, out)``
  (models/t5/convert.py); it is blocked transposed.
- Leaf salt. Each leaf's dither is salted with its index in
  ``jax.tree_util.tree_flatten`` order, which sorts the keys at every level of
  the tree: here the paths sorted by their ``/``-separated keys.
"""

from __future__ import annotations

import itertools
import struct
from collections.abc import Mapping
from typing import Dict, NamedTuple, Tuple

import torch

from lako_tpu_torch.train.optim import GradientTransformation

_LOG_STEPS_PER_OCTAVE = 8.0
# degree-4 fit of log2(m) on m in [1, 2), highest power first
_LOG2_P = (-0.08001089296345223, 0.6355112409058404, -2.0994026211478034,
           4.049617286121415, -2.5056148259511994)
_MASK32 = 0xFFFFFFFF


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python number: the value a weakly typed
    JAX scalar takes next to a float32 array."""
    return struct.unpack("f", struct.pack("f", x))[0]


def fma32(a, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in float32 with a single rounding, as an FMA instruction
    computes it. The product of two float32 values is exact in float64; the
    float64 sum is then rounded to float32, and the one case where that
    rounds twice, a float32 tie, is settled by the sum's exact error
    (Knuth's TwoSum)."""
    def f64(x):   # a float32 tensor, or a Python number that is a float32 value
        return x.double() if isinstance(x, torch.Tensor) else x

    p = f64(a) * f64(b)
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)          # p + c == s + err exactly
    r = s.float()
    d = s - r.double()
    other = torch.nextafter(r, torch.copysign(torch.full_like(r, torch.inf), d.float()))
    tie = (d != 0) & (2 * d == other.double() - r.double())
    return torch.where(tie & (err != 0) & ((err > 0) == (d > 0)), other, r)


class Moment8(NamedTuple):
    """One quantized moment: ``q`` (n_blocks, block) int8 or uint8, ``scale``
    (n_blocks, 1) float32, for a parameter zero-padded to a block multiple."""

    q: torch.Tensor
    scale: torch.Tensor


class FlatMoments(Mapping):
    """One moment of every leaf, in one flat state: ``q`` (NB, block) and
    ``scale`` (NB, 1) with the leaves' rows stacked; maps each path to its
    Moment8, a view of its rows ``rows[path] = (row0, nb)``, made when read."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, rows: Dict[str, Tuple[int, int]]):
        self.q, self.scale, self.rows = q, scale, rows

    def __getitem__(self, path: str) -> Moment8:
        row0, nb = self.rows[path]
        return Moment8(self.q[row0:row0 + nb], self.scale[row0:row0 + nb])

    def __iter__(self):
        return iter(self.rows)

    def __len__(self) -> int:
        return len(self.rows)


class ScaleByAdam8State(NamedTuple):
    count: int
    mu: Mapping[str, Moment8]   # int8, signed
    nu: Mapping[str, Moment8]   # uint8, log code


def is_transposed(path: str, x: torch.Tensor) -> bool:
    """True for a dense weight, held ``(out, in)`` where JAX holds ``(in, out)``."""
    return x.dim() == 2 and path.rsplit("/", 1)[-1] == "kernel"


def jax_layout(x: torch.Tensor, transposed: bool) -> torch.Tensor:
    return x.t() if transposed else x


def leaf_order(paths) -> list:
    """Paths in ``jax.tree_util.tree_flatten`` order of the nested tree."""
    return sorted(paths, key=lambda p: p.split("/"))


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64: torch's
    vectorized float32 sqrt on the CPU can be an ulp off)."""
    return torch.sqrt(x.double()).float()


def _blocked(x: torch.Tensor, block: int) -> torch.Tensor:
    n = x.numel()
    nb = -(-n // block)
    flat = x.reshape(-1).float()
    return torch.nn.functional.pad(flat, (0, nb * block - n)).reshape(nb, block)


def _unblocked(x2d: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    return x2d.reshape(-1)[:n].reshape(shape)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for int64 ``h`` in [0, 2**32), in two 16-bit halves
    of ``c`` so that no int64 product overflows."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _MASK32


def salt_hash(count: int, salt: int) -> int:
    """The step's and salt's part of the dither hash, mod 2**32."""
    return ((count * 0x9E3779B9) ^ (salt * 0x85EBCA6B)) & _MASK32


def bias_corrections(count: int, b1: float, b2: float, order: str) -> tuple:
    """``(1 - b1**count, 1 - b2**count)`` as float32 values, computed on the
    host in one of the JAX package's two orders: "kernel" (its Pallas body)
    ``1 - exp(c * log(b))``, "jnp" ``1 - b ** c``."""
    c = torch.full((), float(count))

    def corr(b):
        bt = torch.full((), f32(b))
        if order == "kernel":
            return (1.0 - torch.exp(c * torch.log(bt))).item()
        if order == "jnp":
            return (1 - bt ** c).item()
        raise ValueError(order)

    return corr(b1), corr(b2)


def kernel_route(g: torch.Tensor) -> bool:
    """True for a leaf that the JAX package's "auto" sends to its Pallas
    kernel on its accelerator: a size that is a multiple of 256, and at
    least 65536."""
    return g.numel() % 256 == 0 and g.numel() >= 65536


def _dither_from_idx(idx: torch.Tensor, count: int, salt: int) -> torch.Tensor:
    """Uniform [0, 1) float32 dither from a murmur-style hash of (absolute
    element index, step, salt): the JAX package's uint32 arithmetic, in int64
    masked to 32 bits."""
    h = idx ^ salt_hash(count, salt)
    h = _mul32(h, 0xCC9E2D51)
    h = _mul32(h ^ (h >> 15), 0x1B873593)
    h = h ^ (h >> 13)
    return (h >> 8).to(torch.int32).float() * 2.0 ** -24


def _dither(shape, count: int, salt: int, device=None) -> torch.Tensor:
    idx = torch.arange(shape[0] * shape[1], dtype=torch.int64, device=device).reshape(shape)
    return _dither_from_idx(idx, count, salt)


def _quant_signed(x2d: torch.Tensor, dither) -> Moment8:
    absmax = x2d.abs().amax(dim=1, keepdim=True)
    # absmax / 127, which XLA computes as a product with the reciprocal
    scale = torch.where(absmax > 0, absmax * f32(1 / 127), 1.0)
    y = x2d / scale
    if dither is not None:
        lo = torch.floor(y)
        y = lo + (dither < (y - lo)).float()
    return Moment8(q=torch.clamp(torch.round(y), -127, 127).to(torch.int8), scale=scale)


def _exp2_neg_code(q: torch.Tensor) -> torch.Tensor:
    """2^(-q/8) for int32 codes in [0, 255]: 2^-(q>>3) in the float32 exponent
    field times a product of three selected constants."""
    base = ((127 - (q >> 3)) << 23).to(torch.int32).view(torch.float32)
    b = q & 7
    one = torch.ones((), dtype=torch.float32, device=q.device)

    def pick(bit, value):
        return torch.where((b & bit) != 0, torch.full_like(one, f32(value)), one)

    return base * (pick(1, 2.0 ** -0.125) * pick(2, 2.0 ** -0.25) * pick(4, 2.0 ** -0.5))


def _log2_bits(x: torch.Tensor) -> torch.Tensor:
    """log2 of positive normal float32 values: exponent extraction plus a
    degree-4 polynomial of the mantissa, each step rounded to float32."""
    bits = x.float().contiguous().view(torch.int32)
    e = (bits >> 23) & 0xFF
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    p = torch.full_like(m, f32(_LOG2_P[0]))
    for c in _LOG2_P[1:]:
        p = fma32(p, m, torch.full_like(m, f32(c)))
    return (e - 127).float() + p


def _quant_unsigned(x2d: torch.Tensor, dither) -> Moment8:
    scale = x2d.amax(dim=1, keepdim=True)
    safe = torch.where(x2d > 0, x2d, 1.0)
    y = (_log2_bits(torch.where(scale > 0, scale, 1.0)) - _log2_bits(safe)) \
        * _LOG_STEPS_PER_OCTAVE
    if dither is not None:
        lo = torch.floor(y)
        y = lo + (dither < (y - lo)).float()
    q = torch.clamp(torch.round(y), 0, 254)
    q = torch.where((x2d <= 0) | (scale <= 0), 255.0, q)
    return Moment8(q=q.to(torch.int32).to(torch.uint8), scale=scale)


def _dequant(m: Moment8) -> torch.Tensor:
    if m.q.dtype == torch.uint8:      # log code (second moment)
        val = m.scale * _exp2_neg_code(m.q.to(torch.int32))
        return torch.where(m.q == 255, 0.0, val)
    return m.q.float() * m.scale


def _adam8_plain(g, mq: Moment8, vq: Moment8, count: int, i: int, *, b1, b2, eps,
                 correct_bias, stochastic_round, seed, transposed):
    """The JAX package's jnp formulation for one leaf."""
    gj = jax_layout(g, transposed)
    g2d = _blocked(gj, mq.q.shape[1])
    m = fma32(f32(1 - b1), g2d, f32(b1) * _dequant(mq))
    v = fma32(f32(1 - b2), torch.square(g2d), f32(b2) * _dequant(vq))
    if correct_bias:
        corr1, corr2 = (torch.full((), c, device=g.device)
                        for c in bias_corrections(count, b1, b2, "jnp"))
        u = (m / corr1) / (sqrt32(v / corr2) + f32(eps))
    else:
        u = m / (sqrt32(v) + f32(eps))
    k_m = k_v = None
    if stochastic_round:
        k_m = _dither(g2d.shape, count, seed + 2 * i, g.device)
        k_v = _dither(g2d.shape, count, seed + 2 * i + 1, g.device)
    u = jax_layout(_unblocked(u, gj.shape), transposed).to(g.dtype)
    return u, _quant_signed(m, k_m), _quant_unsigned(v, k_v)


def _on_card(updates) -> bool:
    return any(g.is_cuda for g in updates.values())


def scale_by_adam_8bit(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                       block: int = 256, correct_bias: bool = False,
                       stochastic_round: bool = True, seed: int = 0x8B17,
                       use_kernel: str = "auto") -> GradientTransformation:
    """Adam scaling with int8/uint8 blockwise moments; ``correct_bias`` True
    is torch's Adam, False HF's AdamW (raw moments), as in train/optim.py.
    The kernel K5 takes blocks of 256 (one warp a block). The state's
    moments are FlatMoments: one flat buffer per moment for all leaves."""
    if use_kernel not in ("auto", "never", "always"):
        raise ValueError(use_kernel)
    if use_kernel != "never" and block != 256:
        raise ValueError(f"the 8-bit Adam kernel takes blocks of 256, got {block}")
    hyper = dict(b1=b1, b2=b2, eps=eps, correct_bias=correct_bias,
                 stochastic_round=stochastic_round, seed=seed)
    layouts = {}   # (keys, shapes, plain) -> (paths, LeafLayout, rows)

    def layout_of(updates, plain: bool):
        """The leaves' order, K5's layout and each path's rows, once per tree."""
        from lako_tpu_torch.ops.adam8_kernel import LeafLayout

        key = (tuple(updates), tuple(g.shape for g in updates.values()), plain)
        if key not in layouts:
            paths = leaf_order(updates)
            gs = [updates[p] for p in paths]
            nbs = tuple(-(-g.numel() // block) for g in gs)
            layout = LeafLayout(tuple(range(len(paths))),
                                tuple(is_transposed(p, g) for p, g in zip(paths, gs)),
                                tuple(plain or (use_kernel == "auto" and not kernel_route(g))
                                      for g in gs), nbs)
            rows = dict(zip(paths, zip(itertools.accumulate(nbs, initial=0), nbs)))
            rows = {k: rows[k] for k in updates}   # the caller's key order
            layouts[key] = (paths, layout, rows)
        return layouts[key]

    def init(params):
        devices = {p.device for p in params.values()}
        if len(devices) > 1:
            raise ValueError(f"the 8-bit Adam state lies on one device, got {devices}")
        device = devices.pop() if devices else None
        _, layout, rows = layout_of(params, plain=False)
        nb = sum(layout.nbs)
        # log code: 255 is the reserved exact-zero symbol
        scale = torch.ones(nb, 1, dtype=torch.float32, device=device)
        return ScaleByAdam8State(
            0, FlatMoments(torch.zeros(nb, block, dtype=torch.int8, device=device), scale, rows),
            FlatMoments(torch.full((nb, block), 255, dtype=torch.uint8, device=device),
                        scale.clone(), rows))

    def update(updates, state: ScaleByAdam8State, params=None):
        from lako_tpu_torch.ops.adam8_kernel import (
            fused_adam8_update_leaves,
            fused_adam8_update_leaves_reference,
        )

        count = state.count + 1
        if not updates:
            return {}, ScaleByAdam8State(count, {}, {})
        plain = use_kernel == "never" or (use_kernel == "auto" and not _on_card(updates))
        paths, layout, rows = layout_of(updates, plain)
        if not all(isinstance(m, FlatMoments) and m.rows == rows for m in (state.mu, state.nu)):
            raise ValueError("the 8-bit state was not made by this transform for these leaves")
        grads = [updates[p].contiguous() for p in paths]
        flat = (state.mu.q, state.mu.scale, state.nu.q, state.nu.scale)
        run = fused_adam8_update_leaves_reference if plain else fused_adam8_update_leaves
        us, (mq, ms, vq, vs) = run(grads, flat, layout, count, **hyper)
        out_u = dict(zip(paths, us))
        return ({k: out_u[k] for k in updates},
                ScaleByAdam8State(count, FlatMoments(mq, ms, rows), FlatMoments(vq, vs, rows)))

    return GradientTransformation(init, update)


def moment_state_bytes(params, block: int = 256) -> tuple:
    """(8-bit state bytes, float32 Adam state bytes) for a dict of parameters,
    computed from their sizes."""
    q8 = full = 0
    for p in params.values():
        nb = -(-p.numel() // block)
        q8 += 2 * (nb * block + 4 * nb)   # two moments: codes + scales
        full += 8 * p.numel()
    return q8, full
