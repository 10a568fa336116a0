"""Checkpoints with best-metric / latest semantics: the port of
lako_tpu/core/checkpoint.py.

The same layout and policy: a save goes to ``<dir>/checkpoint/<name>/`` with
``meta.json`` (``step``, ``best_eval_metric`` and any extra fields), and the
``latest`` symlink is forced to the newest save. The files are the port's own
(the JAX package writes flax msgpack): ``params.pt`` and ``opt_state.pt``,
each a flat dict of CPU tensors and Python numbers written with
``torch.save`` and read with ``torch.load(weights_only=True)``, so no class is
pickled. A tree (dicts, tuples and NamedTuples, the 8-bit optimizer's
``FlatMoments``) is flattened to ``/``-joined key paths and restored into the
structure of a template, as ``flax.serialization.from_bytes`` restores into
its target. A key, kind or shape that differs from the template raises.
Tensors keep the checkpoint's dtype, as flax restores them; the caller casts.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

Flat = Dict[str, Any]


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def _flat_moments():
    from lako_tpu_torch.train.optim8 import FlatMoments

    return FlatMoments


def flatten_tree(tree: Any, prefix: str = "", out: Optional[Flat] = None) -> Flat:
    """Tree → ``{key path: tensor or number}``. The tensors are the tree's
    own (no copy). A FlatMoments contributes its two buffers; its rows come
    back from the template."""
    out = {} if out is None else out
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
    elif isinstance(tree, _flat_moments()):
        out[_join(prefix, "q")] = tree.q
        out[_join(prefix, "scale")] = tree.scale
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            flatten_tree(v, _join(prefix, k), out)
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            flatten_tree(v, _join(prefix, i), out)
    elif isinstance(tree, (bool, int, float)):
        out[prefix] = tree
    elif tree is not None:
        raise TypeError(f"cannot checkpoint {type(tree).__name__} at {prefix!r}")
    return out


def _take(flat: Flat, key: str, used: set):
    if key not in flat:
        raise ValueError(f"checkpoint has no entry {key!r} that the template holds")
    used.add(key)
    return flat[key]


def _tensor_like(t: torch.Tensor, v: Any, key: str) -> torch.Tensor:
    if not isinstance(v, torch.Tensor):
        raise ValueError(f"{key!r}: checkpoint holds {type(v).__name__}, the template a tensor")
    if v.shape != t.shape:
        raise ValueError(f"{key!r}: checkpoint shape {tuple(v.shape)}, "
                         f"template {tuple(t.shape)}")
    return v


def _restore(template: Any, flat: Flat, prefix: str, used: set) -> Any:
    if isinstance(template, torch.Tensor):
        return _tensor_like(template, _take(flat, prefix, used), prefix)
    flat_moments = _flat_moments()
    if isinstance(template, flat_moments):
        q, scale = (_tensor_like(t, _take(flat, _join(prefix, n), used), _join(prefix, n))
                    for t, n in ((template.q, "q"), (template.scale, "scale")))
        return flat_moments(q, scale, template.rows)
    if isinstance(template, Mapping):
        return {k: _restore(v, flat, _join(prefix, k), used) for k, v in template.items()}
    if isinstance(template, tuple):
        children = [_restore(v, flat, _join(prefix, i), used) for i, v in enumerate(template)]
        return type(template)(*children) if hasattr(template, "_fields") else tuple(children)
    if isinstance(template, (bool, int, float)):
        v = _take(flat, prefix, used)
        if isinstance(v, torch.Tensor) or not isinstance(v, (bool, int, float)):
            raise ValueError(f"{prefix!r}: checkpoint holds {type(v).__name__}, "
                             f"the template a number")
        return type(template)(v)
    if template is None:
        return None
    raise TypeError(f"cannot restore {type(template).__name__} at {prefix!r}")


def unflatten_tree(template: Any, flat: Flat) -> Any:
    """``flat`` (from :func:`flatten_tree`) in ``template``'s structure. Every
    key of the template must be in ``flat`` with the same kind and shape,
    and ``flat`` may hold no other key."""
    used: set = set()
    tree = _restore(template, flat, "", used)
    extra = sorted(set(flat) - used)
    if extra:
        raise ValueError(f"checkpoint entries the template does not hold: {extra[:5]}"
                         f"{' ...' if len(extra) > 5 else ''}")
    return tree


def _save_tree(tree: Any, path: Path) -> None:
    flat = {k: v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor) else v
            for k, v in flatten_tree(tree).items()}
    torch.save(flat, path)


def _load_tree(template: Any, path: Path) -> Any:
    return unflatten_tree(template, torch.load(path, map_location="cpu", weights_only=True))


def _symlink_force(target: str, link: str) -> None:
    try:
        os.symlink(target, link)
    except FileExistsError:
        os.remove(link)
        os.symlink(target, link)


def save_checkpoint(
    dir_path: str,
    name: str,
    params: Any,
    opt_state: Any = None,
    step: int = 0,
    best_eval_metric: float = 0.0,
    extra: Optional[dict] = None,
) -> str:
    path = Path(dir_path) / "checkpoint" / name
    path.mkdir(parents=True, exist_ok=True)
    _save_tree(params, path / "params.pt")
    if opt_state is not None:
        _save_tree(opt_state, path / "opt_state.pt")
    meta = {"step": int(step), "best_eval_metric": float(best_eval_metric)}
    if extra:
        meta.update(extra)
    (path / "meta.json").write_text(json.dumps(meta, indent=2))
    _symlink_force(str(path), str(Path(dir_path) / "checkpoint" / "latest"))
    return str(path)


def load_checkpoint(
    path: str,
    params_template: Any,
    opt_state_template: Any = None,
) -> Tuple[Any, Any, dict]:
    """(params, opt_state | None, meta) on the CPU, in the templates'
    structures. ``path`` is a save's directory, or a run's directory, which
    resolves to its ``checkpoint/latest``."""
    p = Path(path)
    if p.name != "latest" and not (p / "params.pt").exists() and (p / "checkpoint").exists():
        p = p / "checkpoint" / "latest"
    params = _load_tree(params_template, p / "params.pt")
    opt_state = None
    if opt_state_template is not None and (p / "opt_state.pt").exists():
        opt_state = _load_tree(opt_state_template, p / "opt_state.pt")
    meta = json.loads((p / "meta.json").read_text()) if (p / "meta.json").exists() else {}
    return params, opt_state, meta
