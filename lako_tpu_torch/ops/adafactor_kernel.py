"""Adafactor over every leaf of a tree in four launches: K7.

K7 replaces no ``pallas_call``. The JAX package's Adafactor is
``optax.adafactor`` behind a clip by the global norm
(lako_tpu/train/optim.py), a chain that XLA fuses on the TPU. The port's
eager chain (train/optim.py ``clipped_adafactor``) issues ~38 launches a
leaf and keeps several full-size copies of the tree alive. K7
(``csrc/adafactor.cu``) computes the same chain over a tree of float32
leaves on the card in four launches from one descriptor table, and writes
the update into the gradients' buffers and the new statistics into the
state's own tensors, in place. It is bound by bytes: 20 an element over
its passes (g and p read for the norms and the factored statistics' sums,
g for the block RMS, g read and written for the update; the source's
note), then ``apply_updates``' 12. The factored statistics are the clip's
scale squared times the sums of g^2, where the chain sums the squares of
the clipped g: a product rounded elsewhere.

The plan (:func:`plan`) is what the paths and shapes fix: for each leaf its
factored axes, decided by ``optim._factored_dims`` on the JAX leaf's shape
(a dense ``kernel`` is ``(in, out)`` there and ``(out, in)`` here), its
tiles, and its scratch. On CPU tensors :func:`fused_adafactor_update` runs
the plain version (:func:`fused_adafactor_update_reference`): the chain's
arithmetic leaf by leaf, read through the same plan and in place, as the
kernel works.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from lako_tpu_torch.ops import _build
from lako_tpu_torch.train.optim import (
    _EPSILON,
    _MIN_DIM_SIZE_TO_FACTOR,
    _MIN_PARAM_SCALE,
    _factored_dims,
)

TILE = 256          # a tile's rows and columns (csrc/adafactor.cu TILE)
FIN_CHUNK = 1024    # v_col entries a block of pass 2 takes
# csrc/adafactor.cu struct Leaf: one row of sixteen int64 a leaf
LEAF_FIELDS = ("g", "p", "va", "vb", "n", "rows", "cols", "tile0", "tiles_c", "rpart", "cpart",
               "frow", "fcol", "fin0", "flags", "vt_cols")
_F = {name: i for i, name in enumerate(LEAF_FIELDS)}
# csrc/adafactor.cu LeafFlags
FLAG_FACTORED, FLAG_ROW_STAT, FLAG_VECTOR, FLAG_V_TRANSPOSED = 1, 2, 4, 8


class Plan(NamedTuple):
    """K7's launch over a tree, from its paths and shapes alone.

    ``table``: (L, 16) int64 of :data:`LEAF_FIELDS` with every column but the
    pointers and :data:`FLAG_VECTOR` filled; ``first``: (2, L) int32, each
    leaf's first tile and its first block of pass 2; ``state_shapes``: the
    shapes of each leaf's ``v_row``, ``v_col`` and ``v`` (optax's
    ``FactoredState`` in the JAX orientation); ``scratch``: the float32
    scratch's length."""

    table: np.ndarray
    first: np.ndarray
    n_tiles: int
    n_fin: int
    scratch: int
    state_shapes: Tuple[Tuple[tuple, tuple, tuple], ...]


@functools.lru_cache(maxsize=16)
def plan(paths: Tuple[str, ...], shapes: Tuple[Tuple[int, ...], ...]) -> Plan:
    """The plan of a tree whose leaf ``paths[i]`` has the port's shape
    ``shapes[i]``. A factored leaf is a 2-d ``(rows, cols)``, its tiles
    256 x 256; another leaf is read flat, as ``(ceil(n / 256), 256)``. v_row's
    mean runs over the port's axis that the JAX leaf's largest axis (``d0``
    of ``_factored_dims``) is: over the columns (:data:`FLAG_ROW_STAT`, v_row
    one entry a row) or over the rows."""
    n_leaves = len(paths)
    table = np.zeros((n_leaves, len(LEAF_FIELDS)), dtype=np.int64)
    first = np.zeros((2, n_leaves), dtype=np.int32)
    state_shapes = []
    sizes = []   # each leaf's rpart, cpart, frow, fcol lengths
    tile0 = fin0 = 0
    for i, (path, shape) in enumerate(zip(paths, shapes)):
        shape = tuple(int(d) for d in shape)
        transposed = len(shape) == 2 and path.rsplit("/", 1)[-1] == "kernel"
        jax_shape = shape[::-1] if transposed else shape
        dims = _factored_dims(jax_shape, _MIN_DIM_SIZE_TO_FACTOR)
        n = math.prod(shape)
        flags, vt_cols, fin = 0, 0, 0
        if dims is None:
            rows, cols = -(-n // TILE), TILE
            if transposed:
                flags, vt_cols = FLAG_V_TRANSPOSED, shape[1]
            state_shapes.append(((1,), (1,), jax_shape))
        else:
            if len(shape) != 2:
                raise ValueError(f"{path}: a factored leaf of shape {shape}; the fused "
                                 "Adafactor update takes 2-d factored leaves")
            rows, cols = shape
            d0 = dims[1]
            row_stat = (1 - d0 if transposed else d0) == 1
            flags = FLAG_FACTORED | (FLAG_ROW_STAT if row_stat else 0)
            n_vrow, n_vcol = (rows, cols) if row_stat else (cols, rows)
            state_shapes.append(((n_vrow,), (n_vcol,), (1,)))
            fin = 1 + -(-n_vcol // FIN_CHUNK)
        tiles_c, tiles_r = -(-cols // TILE), -(-rows // TILE)
        factored = dims is not None
        sizes.append((tiles_c * rows, tiles_r * cols, rows, cols) if factored else (0, 0, 0, 0))
        table[i, _F["n"]:_F["tiles_c"] + 1] = (n, rows, cols, tile0, tiles_c)
        table[i, _F["fin0"]:] = (fin0, flags, vt_cols)
        first[:, i] = (tile0, fin0)
        tile0 += tiles_r * tiles_c
        fin0 += fin
    if tile0 > 2 ** 31 - 1 or fin0 > 2 ** 31 - 1:
        raise ValueError(f"a launch of {tile0} tiles")
    # the head: two sums a tile, three a leaf, the norm and two uint32 counters
    offset = -(-(2 * tile0 + 3 * n_leaves + 3) // 4) * 4
    for i, lengths in enumerate(sizes):
        for name, length in zip(("rpart", "cpart", "frow", "fcol"), lengths):
            table[i, _F[name]] = offset
            offset += length
    return Plan(table, first, tile0, fin0, offset, tuple(state_shapes))


def fused_adafactor_update_reference(paths: Sequence[str], grads: Sequence[torch.Tensor],
                                     params: Sequence[torch.Tensor], v_row, v_col, v, *,
                                     clip: float, values: torch.Tensor) -> List[torch.Tensor]:
    """Plain version of K7: the chain (clip by the global norm, factored
    RMS with decay ``decay`` and ``keep = 1 - decay``, clip by block RMS,
    ``lr``, parameter RMS, -1; ``values`` holds decay, keep and lr) in its
    arithmetic, leaf by leaf through the plan; the leaves' sums of squares
    are added as one tensor's sum, where the chain adds them one by one.
    Writes the update into ``grads`` and the statistics into ``v_row``,
    ``v_col`` and ``v``, in place; returns ``grads``."""
    decay, keep, lr = values.tolist()
    pl = plan(tuple(paths), tuple(tuple(g.shape) for g in grads))
    norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
    under = norm < clip
    for i, (g, p) in enumerate(zip(grads, params)):
        flags = int(pl.table[i, _F["flags"]])
        gc = torch.where(under, g, g / norm * clip)
        sq = gc * gc + _EPSILON
        if flags & FLAG_FACTORED:
            row_stat = bool(flags & FLAG_ROW_STAT)
            over_cols, over_rows = sq.mean(dim=1), sq.mean(dim=0)
            new_row = decay * v_row[i] + keep * (over_cols if row_stat else over_rows)
            new_col = decay * v_col[i] + keep * (over_rows if row_stat else over_cols)
            v_row[i].copy_(new_row)
            v_col[i].copy_(new_col)
            row_factor = (new_row / new_row.mean()) ** -0.5
            col_factor = new_col ** -0.5
            if row_stat:
                u = gc * row_factor[:, None] * col_factor[None, :]
            else:
                u = gc * row_factor[None, :] * col_factor[:, None]
        else:
            turn = (lambda t: t.t()) if flags & FLAG_V_TRANSPOSED else (lambda t: t)
            new_v = decay * v[i] + keep * turn(sq)
            v[i].copy_(new_v)
            u = gc * turn(new_v ** -0.5)
        u = u / torch.clamp(torch.sqrt(torch.mean(u * u)), min=1.0)
        u = u * lr
        rms = torch.sqrt(torch.mean(p * p))
        u = u * torch.where(rms <= _MIN_PARAM_SCALE, torch.full_like(rms, _MIN_PARAM_SCALE), rms)
        g.copy_(u * -1.0)
    return list(grads)


def _pointers(tensors) -> np.ndarray:
    return np.fromiter((t.data_ptr() for t in tensors), dtype=np.int64, count=len(tensors))


def leaf_table(pl: Plan, grads, params, v_row, v_col, v) -> np.ndarray:
    """The plan's table with the tensors' pointers and :data:`FLAG_VECTOR`
    (g and p 16-byte aligned, ``cols`` a multiple of 4) filled in. Raises
    unless every tensor is a contiguous float32 tensor on the gradients'
    device, shaped as the plan says."""
    device, index = grads[0].device, grads[0].get_device()
    for i, (g, p, vr, vc, vv) in enumerate(zip(grads, params, v_row, v_col, v)):
        want = (pl.table[i, _F["n"]],) + pl.state_shapes[i]
        for t in (g, p, vr, vc, vv):
            if t.get_device() != index or t.dtype is not torch.float32 or not t.is_contiguous():
                raise ValueError(f"the fused Adafactor update takes contiguous float32 "
                                 f"tensors on {device}, got {t.dtype} on {t.device} "
                                 f"(contiguous {t.is_contiguous()}) at leaf {i}")
        got = (g.numel(), tuple(vr.shape), tuple(vc.shape), tuple(vv.shape))
        if p.shape != g.shape or got != want:
            raise ValueError(f"leaf {i}: gradient {tuple(g.shape)}, parameter "
                             f"{tuple(p.shape)}, v_row/v_col/v {got[1:]}; the plan "
                             f"wants {want}")
    table = pl.table.copy()
    factored = (table[:, _F["flags"]] & FLAG_FACTORED) != 0
    g_ptr, p_ptr = _pointers(grads), _pointers(params)
    table[:, _F["g"]] = g_ptr
    table[:, _F["p"]] = p_ptr
    table[:, _F["va"]] = np.where(factored, _pointers(v_row), _pointers(v))
    table[:, _F["vb"]] = np.where(factored, _pointers(v_col), 0)
    aligned = ((g_ptr | p_ptr) % 16 == 0) & (table[:, _F["cols"]] % 4 == 0)
    table[:, _F["flags"]] |= np.where(aligned, FLAG_VECTOR, 0)
    return table


def _launch(pl: Plan, table: np.ndarray, device, *, clip: float, values: torch.Tensor) -> None:
    """K7's four launches: the table goes to the card through one pinned
    buffer and one asynchronous copy; the scratch is allocated here; nothing
    synchronizes."""
    stream = torch.cuda.current_stream(device).cuda_stream
    host = torch.empty(table.nbytes + pl.first.nbytes, dtype=torch.uint8, pin_memory=True)
    buf = host.numpy()
    buf[:table.nbytes] = table.reshape(-1).view(np.uint8)
    buf[table.nbytes:] = pl.first.reshape(-1).view(np.uint8)
    dev_table = host.to(device, non_blocking=True)
    if torch.cuda.is_current_stream_capturing():   # a replay copies from `host`
        _build.keep_for_graph(host, stream, "adafactor")
    else:
        _build.release_graph_buffers()
    scratch = torch.empty(pl.scratch, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        fn = _build.bind("lako_adafactor_update", 3, 3, 0, 3, "adafactor")
        code = fn(dev_table.data_ptr(), scratch.data_ptr(), values.data_ptr(), len(table),
                  pl.n_tiles, pl.n_fin, clip, _EPSILON, _MIN_PARAM_SCALE, stream)
    _build.check_launch(code, "fused_adafactor_update")


def step_values(values: torch.Tensor, decay: float, keep: float, lr: float) -> torch.Tensor:
    """Writes a step's ``decay``, ``keep`` and ``lr`` into ``values`` (three
    float32) by launches on the current stream; returns ``values``. Nothing
    synchronizes, and a CUDA graph that captured K7 reads them when it is
    replayed after these launches."""
    for i, x in enumerate((decay, keep, lr)):
        values[i].fill_(x)
    return values


def fused_adafactor_update(paths: Sequence[str], grads: Sequence[torch.Tensor],
                           params: Sequence[torch.Tensor], v_row, v_col, v, *, clip: float,
                           values: torch.Tensor) -> List[torch.Tensor]:
    """K7: one Adafactor step of every leaf (clip by the global norm
    ``clip``, factored RMS with ``decay`` and ``keep = 1 - decay``, clip by
    block RMS at 1, ``lr``, parameter RMS at least 1e-3, -1). ``paths[i]``
    names leaf i (a ``.../kernel`` of 2 dimensions is a dense weight held
    ``(out, in)``); ``grads``, ``params``: its gradient and parameter;
    ``v_row``, ``v_col``, ``v``: its statistics in the JAX orientation
    (optax's ``FactoredState``); ``values``: the step's decay, keep and lr,
    three float32 on the gradients' device (:func:`step_values`), which the
    kernel reads when it runs. Writes the update into ``grads`` and the new
    statistics into ``v_row``, ``v_col`` and ``v``, in place; returns
    ``grads``. CUDA tensors must be contiguous float32 on one card; CPU
    tensors take the plain version."""
    trees = (grads, params, v_row, v_col, v)
    if not grads or any(len(x) != len(paths) for x in trees):
        raise ValueError(f"{len(paths)} paths for {[len(x) for x in trees]} tensors")
    device = grads[0].device
    if values.device != device or values.dtype is not torch.float32 or values.numel() != 3:
        raise ValueError(f"values: three float32 on {device}, got {values.numel()} "
                         f"{values.dtype} on {values.device}")
    hyper = dict(clip=clip, values=values)
    if device.type == "cpu":
        if any(t.device != device for x in trees for t in x):
            raise ValueError("the tensors lie on different devices")
        return fused_adafactor_update_reference(paths, grads, params, v_row, v_col, v, **hyper)
    if device.type != "cuda":
        raise ValueError(f"fused_adafactor_update: no kernel for device {device}")
    pl = plan(tuple(paths), tuple(tuple(g.shape) for g in grads))
    table = leaf_table(pl, grads, params, v_row, v_col, v)
    _launch(pl, table, device, **hyper)
    fused_adafactor_update.launches += 3 + (pl.n_fin > 0)
    return list(grads)


fused_adafactor_update.launches = 0   # kernel launches: 4 an update with a factored leaf
