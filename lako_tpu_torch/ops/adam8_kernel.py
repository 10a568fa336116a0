"""One-pass 8-bit Adam update: the port of K5, and its fragment K6.

Counterparts of lako_tpu/ops/adam8_kernel.py ``fused_adam8_update`` (K5) and
of ``k_ema`` in scripts/bench_adam8_micro.py (K6). K5 reads a leaf's gradient
and its blocked 8-bit moments (train/optim8.py ``Moment8``), and writes the
Adam direction u and the requantized moments in one pass; one launch takes
every leaf of a tree (:func:`fused_adam8_update_leaves`), each in the
rounding order the JAX package gives it, and :func:`fused_adam8_update` is
its one-leaf call. K6 is K5 without the requantization: it dequantizes,
takes the two EMAs and writes u in bfloat16. The JAX package measures K5
against it to show what the requantization costs.

On CUDA tensors the wrappers launch the hand-written kernels in
``csrc/adam8.cu``; on CPU tensors they run the plain versions
(:func:`fused_adam8_update_leaves_reference`,
:func:`fused_adam8_update_reference`, :func:`adam8_ema_fragment_reference`),
which follow the JAX package's evaluation order step by step, so that the
kernels' codes and scales come out bitwise equal to them.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from lako_tpu_torch.ops import _build
from lako_tpu_torch.train.optim8 import (
    Moment8,
    _adam8_plain,
    _blocked,
    _dequant,
    _dither,
    _quant_signed,
    _quant_unsigned,
    _unblocked,
    bias_corrections,
    f32,
    fma32,
    jax_layout,
    sqrt32,
)

BLOCK = 256
_INT32_MAX = 2 ** 31 - 1
# state rows a block takes, or a tile's input columns in the tile tier: the
# launch hands it to csrc/adam8.cu, which refuses any other than its
# TILE_COLS (8 warps of two rows)
ROWS_PER_BLOCK = 16
# csrc/adam8.cu struct Leaf: one row of sixteen int64 a leaf
LEAF_FIELDS = ("g", "u", "mq", "ms", "vq", "vs", "n", "rows", "cols", "row0", "block0", "nb",
               "salt_m", "salt_v", "flags", "col_tiles")
_F = {name: i for i, name in enumerate(LEAF_FIELDS)}
# csrc/adam8.cu LeafFlags
FLAG_BF16, FLAG_TILE, FLAG_STRIDED, FLAG_JNP, FLAG_VECTOR = 1, 2, 4, 8, 16


class LeafLayout(NamedTuple):
    """What K5 needs to know of a tree besides its tensors, per leaf in the
    order of the state's rows: the salt of its dither (its index in
    ``leaf_order``), whether it is a dense weight held ``(out, in)`` and
    blocked as the JAX package's ``(in, out)`` kernel, its rounding order
    (``jnp_order``: the JAX package's jnp path, else its Pallas kernel's),
    and its state rows ``ceil(numel / 256)``."""

    salts: Tuple[int, ...]
    transposed: Tuple[bool, ...]
    jnp_order: Tuple[bool, ...]
    nbs: Tuple[int, ...]


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
    """Plain version of K5 in the Pallas body's order (``_kernel``):
    ``(u, new_mq, new_ms, new_vq, new_vs)``, u shaped and typed like g."""
    gj = jax_layout(g, transposed)
    g2d = _blocked(gj, mq.shape[1])
    m, v = _ema(g2d, mq, ms, vq, vs, b1, b2, 1.0 - b1, 1.0 - b2)
    if correct_bias:
        corr1, corr2 = (torch.full((), c, device=g.device)
                        for c in bias_corrections(count, b1, b2, "kernel"))
        u = (m / corr1) / (sqrt32(v / corr2) + f32(eps))
    else:
        u = m / (sqrt32(v) + f32(eps))
    k_m = k_v = None
    if stochastic_round:
        k_m = _dither(g2d.shape, count, seed + 2 * leaf_salt, g.device)
        k_v = _dither(g2d.shape, count, seed + 2 * leaf_salt + 1, g.device)
    qm, qv = _quant_signed(m, k_m), _quant_unsigned(v, k_v)
    u = jax_layout(_unblocked(u, gj.shape).to(g.dtype), transposed)
    return u, qm.q, qm.scale, qv.q, qv.scale


def fused_adam8_update_leaves_reference(grads: Sequence[torch.Tensor], state, layout: LeafLayout,
                                        count: int, *, b1: float, b2: float, eps: float,
                                        correct_bias: bool, stochastic_round: bool, seed: int):
    """Plain version of K5 over many leaves: each leaf by the plain version of
    its rounding order (:func:`fused_adam8_update_reference`, or the jnp
    path ``optim8._adam8_plain``) on its rows of the flat ``state`` ``(mq,
    ms, vq, vs)``. Returns ``(us, (mq, ms, vq, vs))``: u per leaf and the new
    flat state."""
    hyper = dict(b1=b1, b2=b2, eps=eps, correct_bias=correct_bias,
                 stochastic_round=stochastic_round, seed=seed)
    us, parts, row0 = [], [], 0
    for g, salt, transposed, jnp_order, nb in zip(grads, *layout):
        mq, ms, vq, vs = (t[row0:row0 + nb] for t in state)
        row0 += nb
        if jnp_order:
            u, qm, qv = _adam8_plain(g, Moment8(mq, ms), Moment8(vq, vs), count, salt,
                                     transposed=transposed, **hyper)
            out = (u, qm.q, qm.scale, qv.q, qv.scale)
        else:
            out = fused_adam8_update_reference(g, mq, ms, vq, vs, count, leaf_salt=salt,
                                               transposed=transposed, **hyper)
        us.append(out[0])
        parts.append(out[1:])
    flat = tuple(torch.cat([p[i] for p in parts]) if parts else state[i][:0].clone()
                 for i in range(4))
    return us, flat


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


class _Plan(NamedTuple):
    """The part of K5's descriptor table that the tree's shapes, dtypes and
    alignment fix: the static columns, u's offsets and views, the blocks."""

    table: np.ndarray            # (L, 16) int64, the static columns filled
    dtypes: Tuple[torch.dtype, ...]
    u_sizes: Dict[torch.dtype, int]
    u_views: Tuple[tuple, ...]   # (shape, stride, offset) of each u in its dtype's buffer
    u_offsets: np.ndarray        # the same offsets in bytes
    n_blocks: int


@functools.lru_cache(maxsize=16)
def _plan(layout: LeafLayout, dtypes, shapes, aligned: bytes) -> _Plan:
    table = np.zeros((len(shapes), len(LEAF_FIELDS)), dtype=np.int64)
    u_sizes: Dict[torch.dtype, int] = {}
    u_views = []
    row0 = block0 = 0
    for i, (dtype, shape, salt, transposed, jnp_order, nb) in enumerate(
            zip(dtypes, shapes, *layout)):
        if dtype not in _build.DTYPE_CODES:
            raise ValueError(f"g must be float32|bfloat16, got {dtype}")
        n = math.prod(shape)
        if nb != -(-n // BLOCK) or n > _INT32_MAX:
            raise ValueError(f"state of {nb} blocks for {n} elements")
        if transposed and len(shape) != 2:
            raise ValueError(f"a transposed leaf must be 2-d, got {tuple(shape)}")
        rows, cols = shape if transposed else (0, 0)
        flags = (FLAG_BF16 if dtype == torch.bfloat16 else 0) | (FLAG_JNP if jnp_order else 0)
        col_tiles = 0
        if not transposed:
            blocks = -(-nb // ROWS_PER_BLOCK)
            flags |= FLAG_VECTOR if aligned[i] else 0
        elif rows % BLOCK == 0 and cols % 8 == 0 and aligned[i]:
            flags |= FLAG_TILE
            col_tiles = -(-cols // ROWS_PER_BLOCK)
            blocks = rows // BLOCK * col_tiles
        else:
            flags |= FLAG_STRIDED
            blocks = -(-nb // ROWS_PER_BLOCK)
        table[i, _F["n"]:] = (n, rows, cols, row0, block0, nb, 0, 0, flags, col_tiles)
        # u's offsets are multiples of 256 elements in a buffer of its own,
        # so every u is 16-byte aligned
        start = u_sizes.get(dtype, 0)
        u_sizes[dtype] = start + nb * BLOCK
        stride = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))
        u_views.append((tuple(shape), stride, start))
        row0 += nb
        block0 += blocks
    if block0 > _INT32_MAX:
        raise ValueError(f"K5 launch of {block0} blocks")
    u_offsets = np.asarray([view[2] * (2 if dtype == torch.bfloat16 else 4)
                            for dtype, view in zip(dtypes, u_views)], dtype=np.int64)
    return _Plan(table, tuple(dtypes), u_sizes, tuple(u_views), u_offsets, block0)


def _salt_hashes(count: int, salts: np.ndarray) -> np.ndarray:
    """optim8.salt_hash of each salt, vectorized."""
    return ((count * 0x9E3779B9) ^ (salts * 0x85EBCA6B)) & 0xFFFFFFFF


class LeafTable(NamedTuple):
    """K5's launch over a tree: ``table``, an (L, 16) int64 array of
    :data:`LEAF_FIELDS`; the launch's ``n_blocks``; and ``flat_u``, the new
    buffer of u for each gradient dtype that the table points into."""

    table: np.ndarray
    n_blocks: int
    flat_u: Dict[torch.dtype, torch.Tensor]
    plan: _Plan

    def us(self) -> List[torch.Tensor]:
        """u of each leaf: a view of its dtype's buffer, shaped like its g."""
        return [self.flat_u[dtype].as_strided(*view)
                for dtype, view in zip(self.plan.dtypes, self.plan.u_views)]


def leaf_table(grads: Sequence[torch.Tensor], state, layout: LeafLayout, count: int,
               seed: int) -> LeafTable:
    """K5's descriptor table for ``grads`` and the flat ``state`` ``(mq, ms,
    vq, vs)``, with u's buffers allocated: leaf i's state at rows ``row0 ..
    row0 + nb`` of the flat old and new states, its blocks from ``block0``.
    A transposed leaf whose ``out`` is a multiple of 256, whose ``in`` is a
    multiple of 8 and whose g is 16-byte aligned takes the tile tier, one
    block for each 256 outputs by :data:`ROWS_PER_BLOCK` input columns;
    another transposed leaf the strided tier; the rest the contiguous tier,
    one block for each :data:`ROWS_PER_BLOCK` state rows (16-byte loads
    where g is aligned)."""
    device = grads[0].device
    ptrs = np.fromiter((g.data_ptr() for g in grads), dtype=np.int64, count=len(grads))
    plan = _plan(layout, tuple(g.dtype for g in grads), tuple(g.shape for g in grads),
                 (ptrs % 16 == 0).astype(np.uint8).tobytes())
    flat_u = {dtype: torch.empty(size, dtype=dtype, device=device)
              for dtype, size in plan.u_sizes.items()}
    u_ptrs = np.asarray([flat_u[dtype].data_ptr() for dtype in plan.dtypes],
                        dtype=np.int64) + plan.u_offsets
    table = plan.table.copy()
    row0 = table[:, _F["row0"]]
    mq, ms, vq, vs = state
    table[:, _F["g"]] = ptrs
    table[:, _F["u"]] = u_ptrs
    table[:, _F["mq"]] = mq.data_ptr() + BLOCK * row0
    table[:, _F["ms"]] = ms.data_ptr() + 4 * row0
    table[:, _F["vq"]] = vq.data_ptr() + BLOCK * row0
    table[:, _F["vs"]] = vs.data_ptr() + 4 * row0
    salts = seed + 2 * np.asarray(layout.salts, dtype=np.int64)
    table[:, _F["salt_m"]] = _salt_hashes(count, salts)
    table[:, _F["salt_v"]] = _salt_hashes(count, salts + 1)
    return LeafTable(table, plan.n_blocks, flat_u, plan)


def block_rows(table: np.ndarray, block: int):
    """The leaf and the state rows that ``block`` of K5's launch takes, as
    the kernel finds them (binary search over the leaves' first blocks):
    ``(leaf, [rows])``, rows local to the leaf."""
    lo, hi = 0, len(table) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if table[mid, _F["block0"]] <= block:
            lo = mid
        else:
            hi = mid - 1
    leaf = table[lo]
    tile = block - int(leaf[_F["block0"]])
    if leaf[_F["flags"]] & FLAG_TILE:
        col_tiles, per_col = int(leaf[_F["col_tiles"]]), int(leaf[_F["rows"]]) // BLOCK
        j, c0 = divmod(tile, col_tiles)
        c0 *= ROWS_PER_BLOCK
        rows = [(c0 + k) * per_col + j for k in range(ROWS_PER_BLOCK)
                if c0 + k < leaf[_F["cols"]]]
    else:
        rows = [r for r in range(tile * ROWS_PER_BLOCK, (tile + 1) * ROWS_PER_BLOCK)
                if r < leaf[_F["nb"]]]
    return lo, rows


def _launch(table: np.ndarray, n_blocks: int, outs, device, *, b1: float, b2: float,
            eps: float, correct_bias: bool, count: int, stochastic_round: bool) -> None:
    """One launch of K5 over the leaves of ``table``, the new state into the
    flat ``outs``. The table goes to the card through one pinned buffer and
    one asynchronous copy (none for a single leaf, whose descriptor is a
    kernel argument); nothing synchronizes."""
    stream = torch.cuda.current_stream(device).cuda_stream
    dev_table = None
    if len(table) > 1:
        block0 = table[:, _F["block0"]].astype(np.int32)
        host = torch.empty(table.nbytes + block0.nbytes, dtype=torch.uint8, pin_memory=True)
        buf = host.numpy()
        buf[:table.nbytes] = table.reshape(-1).view(np.uint8)
        buf[table.nbytes:] = block0.view(np.uint8)
        dev_table = host.to(device, non_blocking=True)
        if torch.cuda.is_current_stream_capturing():   # a replay copies from `host`
            _build.keep_for_graph(host, stream)
        else:
            _build.release_graph_buffers()
    corr = bias_corrections(count, b1, b2, "kernel") + bias_corrections(count, b1, b2, "jnp")
    with torch.cuda.device(device):
        fn = _build.bind("lako_adam8_update_leaves", 6, 5, 0, 9)
        code = fn(table.ctypes.data, None if dev_table is None else dev_table.data_ptr(),
                  *(t.data_ptr() for t in outs), len(table), n_blocks, ROWS_PER_BLOCK,
                  int(correct_bias), int(stochastic_round), f32(b1), f32(b2), f32(1.0 - b1),
                  f32(1.0 - b2), f32(eps), *corr, stream)
    _build.check_launch(code, "fused_adam8_update")


def _flat_state(nb: int, device):
    return (torch.empty(nb, BLOCK, dtype=torch.int8, device=device),
            torch.empty(nb, 1, dtype=torch.float32, device=device),
            torch.empty(nb, BLOCK, dtype=torch.uint8, device=device),
            torch.empty(nb, 1, dtype=torch.float32, device=device))


def fused_adam8_update_leaves(grads: Sequence[torch.Tensor], state, layout: LeafLayout,
                              count: int, *, b1: float, b2: float, eps: float,
                              correct_bias: bool, stochastic_round: bool, seed: int):
    """K5 over every leaf of a tree in one launch. grads: each leaf's
    gradient in its own shape and dtype (float32 or bfloat16), contiguous;
    state: the flat old state ``(mq, ms, vq, vs)``, ``(NB, 256)`` int8/uint8
    codes and ``(NB, 1)`` float32 scales with the leaves' rows stacked in
    order (``NB = sum(layout.nbs)``); layout: :class:`LeafLayout`. Returns
    ``(us, (mq, ms, vq, vs))``: u per leaf, shaped and typed like its g
    (views of one buffer per dtype), and the new flat state. The old state is
    left as it was."""
    if not grads or len(grads) != len(layout.nbs):
        raise ValueError(f"{len(grads)} gradients for a layout of {len(layout.nbs)} leaves")
    device = grads[0].device
    _check_state(*state, device)
    if state[0].shape[0] != sum(layout.nbs):
        raise ValueError(f"a state of {state[0].shape[0]} rows for {sum(layout.nbs)}")
    hyper = dict(b1=b1, b2=b2, eps=eps, correct_bias=correct_bias,
                 stochastic_round=stochastic_round, seed=seed)
    if device.type == "cpu":
        if any(g.device != device for g in grads):
            raise ValueError("the gradients lie on different devices")
        return fused_adam8_update_leaves_reference(grads, state, layout, count, **hyper)
    if device.type != "cuda":
        raise ValueError(f"fused_adam8_update_leaves: no kernel for device {device}")
    index = device.index
    if any(g.get_device() != index or not g.is_contiguous() for g in grads):
        raise ValueError("the K5 kernel needs contiguous gradients on the state's device")
    out = _run(grads, state, layout, count, **hyper)
    fused_adam8_update_leaves.launches += 1
    return out


def _run(grads, state, layout: LeafLayout, count: int, *, b1: float, b2: float, eps: float,
         correct_bias: bool, stochastic_round: bool, seed: int):
    """K5's launch over checked CUDA inputs: u per leaf and the new flat
    state."""
    launch = leaf_table(grads, state, layout, count, seed)
    outs = _flat_state(state[0].shape[0], grads[0].device)
    _launch(launch.table, launch.n_blocks, outs, grads[0].device, b1=b1, b2=b2, eps=eps,
            correct_bias=correct_bias, count=count, stochastic_round=stochastic_round)
    return launch.us(), outs   # u's views are made while the kernel runs


def fused_adam8_update(g, mq, ms, vq, vs, count: int, *, b1: float, b2: float, eps: float,
                       correct_bias: bool, stochastic_round: bool, seed: int,
                       leaf_salt: int, transposed: bool = False):
    """K5: one 8-bit Adam step of one leaf, in the Pallas body's order (the
    one-leaf call of the kernel of :func:`fused_adam8_update_leaves`). g:
    the gradient in its own shape and dtype (float32 or bfloat16); with
    ``transposed`` a 2-d ``(out, in)`` weight, blocked as the JAX package's
    ``(in, out)`` kernel. mq/vq: ``(nb, 256)`` int8/uint8 codes, ms/vs:
    ``(nb, 1)`` float32 scales, with ``nb = ceil(g.numel() / 256)``. Returns
    ``(u, new_mq, new_ms, new_vq, new_vs)``, u shaped and typed like g."""
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
    if not g.is_contiguous():
        raise ValueError("fused_adam8_update kernel needs a contiguous g")
    (u,), outs = _run([g], (mq, ms, vq, vs), LeafLayout((leaf_salt,), (transposed,), (False,),
                                                        (mq.shape[0],)),
                      count, b1=b1, b2=b2, eps=eps, correct_bias=correct_bias,
                      stochastic_round=stochastic_round, seed=seed)
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
fused_adam8_update_leaves.launches = 0
adam8_ema_fragment.launches = 0
