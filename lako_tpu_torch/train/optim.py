"""Optimizers and learning-rate schedules: the port of lako_tpu/train/optim.py.

The JAX package chains optax transformations. This module keeps that shape
without optax: a :class:`GradientTransformation` is an ``(init, update)``
pair over flat dicts that map each parameter's JAX path
(``t5/encoder/block_0/self_attn/q/kernel``, models/t5/convert.py
``jax_param_paths``) to a tensor. :func:`make_optimizer` chains the same
steps in the same order::

    clip by global norm -> Adam -> [layerwise scale] -> -lr(count)
        -> [HF decoupled weight decay]              [all inside MultiSteps]

What is kept from optax and HF on purpose:

- Clipping is optax's: ``g * clip / norm`` only when ``norm >= clip``, with
  no ``1e-6`` in the denominator (not ``torch.nn.utils.clip_grad_norm_``).
- Weight decay is HF AdamW's order, applied after the learning rate: the
  update ``u`` becomes ``u - lr * wd * (p + u)``, which decays the post-step
  parameters (not ``torch.optim.AdamW``'s decay of the pre-step ones).
- The schedule and the decay read their own step counts from 0, so under
  warmup the first update moves nothing (``lr(0) = 0``).
- The no-decay mask is computed on the JAX parameter paths, where dense
  weights are ``kernel`` and norm weights ``weight``.
- Scalars are rounded to each tensor's dtype before they multiply it, as
  optax casts them, so bf16 parameters keep bf16 moments and updates.

``optim="adamw8bit"`` swaps Adam for train/optim8.py's 8-bit moments (the
update kernel K5 on the card) in the same chain. ``optim="adafactor"`` is
the JAX package's ``optax.adafactor`` chain (:func:`adafactor`), without
weight decay, as the JAX package builds it::

    clip by global norm -> factored RMS -> clip by block RMS -> lr(count)
        -> x parameter RMS -> -1                     [all inside MultiSteps]

Its factored statistics are decided on the JAX leaf's shape: a dense
``kernel`` is ``(in, out)`` there and ``(out, in)`` here, so each kernel is
read transposed and its ``v_row`` / ``v_col`` are the JAX leaf's, square
matrices included.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from lako_tpu_torch.core.config import OptimConfig

Tree = Dict[str, torch.Tensor]
Schedule = Union[float, Callable[[int], float]]


class GradientTransformation(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[..., Tuple[Tree, Any]]   # (updates, state, params=None)


def _scalar(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded through float32 to ``dtype``, as a Python number: the
    value optax multiplies a tensor of that dtype by."""
    return float(torch.tensor(x, dtype=torch.float32).to(dtype))


def warmup_linear_schedule(base_lr: float, warmup_steps: int, scheduler_steps: int,
                           min_ratio: float = 0.0, fixed_lr: bool = False
                           ) -> Callable[[int], float]:
    """Linear warmup from ``min_ratio * base_lr`` to ``base_lr`` over
    ``warmup_steps``, then linear decay to ``min_ratio * base_lr`` at
    ``scheduler_steps`` (constant with ``fixed_lr``)."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * ((1 - min_ratio) * step / max(1, warmup_steps) + min_ratio)
        if fixed_lr:
            return base_lr
        return base_lr * max(0.0, 1.0 + (min_ratio - 1.0) * (step - warmup_steps)
                             / max(1.0, scheduler_steps - warmup_steps))

    return schedule


def _is_decay(keys: Sequence[str]) -> bool:
    joined = "/".join(keys)
    if keys and keys[-1] == "bias":
        return False
    if "ln" in joined or "norm" in joined.lower() or "layernorm" in joined.lower():
        return False
    if keys and keys[-1] == "weight" and len(keys) >= 2 and (
            "ln" in keys[-2] or "norm" in keys[-2].lower()):
        return False
    return True


def _no_decay_mask(params: Tree) -> Dict[str, bool]:
    """True where weight decay applies: not on biases or norm weights (T5/BERT
    convention), judged on the JAX parameter paths."""
    return {path: _is_decay(path.split("/")) for path in params}


def _layerwise_factor(path: str, decay: float, layer_key_prefix: str = "layer_") -> float:
    """``decay ** (7 - i)`` for a parameter whose path holds ``layer_{i}``,
    else 1."""
    for key in path.split("/"):
        if key.startswith(layer_key_prefix):
            try:
                i = int(key[len(layer_key_prefix):])
            except ValueError:
                continue
            return decay ** (7 - i)
    return 1.0


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update(updates: Tree, state, params=None):
        norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in updates.values()))
        keep = norm < max_norm
        return {k: torch.where(keep, g, g / norm.to(g.dtype) * max_norm)
                for k, g in updates.items()}, state

    return GradientTransformation(lambda params: (), update)


class AdamState(NamedTuple):
    count: int
    mu: Tree
    nu: Tree


def _scale_by_adam(correct_bias: bool, b1: float, b2: float,
                   eps: float) -> GradientTransformation:
    """Adam scaling. ``correct_bias=True`` is optax's ``scale_by_adam``;
    False is HF's ``AdamW(correct_bias=False)``: raw moments,
    ``m / (sqrt(v) + eps)``."""

    def init(params: Tree) -> AdamState:
        return AdamState(0, {k: torch.zeros_like(p) for k, p in params.items()},
                         {k: torch.zeros_like(p) for k, p in params.items()})

    def update(updates: Tree, state: AdamState, params=None):
        count = state.count + 1
        if correct_bias:
            mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in updates.items()}
            nu = {k: (1 - b2) * (g * g) + b2 * state.nu[k] for k, g in updates.items()}
            # 1 - decay**count in float32, then in the moment's dtype
            c1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** count)
            c2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** count)
            upd = {k: (mu[k] / _scalar(c1, mu[k].dtype))
                   / (torch.sqrt(nu[k] / _scalar(c2, nu[k].dtype)) + eps) for k in mu}
        else:
            mu = {k: b1 * state.mu[k] + (1 - b1) * g for k, g in updates.items()}
            nu = {k: b2 * state.nu[k] + (1 - b2) * (g * g) for k, g in updates.items()}
            upd = {k: mu[k] / (torch.sqrt(nu[k]) + eps) for k in mu}
        return upd, AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def _layerwise_scale(decay: float, layer_key_prefix: str = "layer_") -> GradientTransformation:
    def update(updates: Tree, state, params=None):
        return {k: u * _layerwise_factor(k, decay, layer_key_prefix)
                for k, u in updates.items()}, state

    return GradientTransformation(lambda params: (), update)


def scale_by_learning_rate(lr: Schedule, flip_sign: bool = True) -> GradientTransformation:
    """Multiply by ``-lr(count)`` (or ``-lr``; ``+`` without ``flip_sign``);
    the count starts at 0."""

    def update(updates: Tree, count: int, params=None):
        step = lr(count) if callable(lr) else lr
        step = -step if flip_sign else step
        return {k: u * _scalar(step, u.dtype) for k, u in updates.items()}, count + 1

    return GradientTransformation(lambda params: 0, update)


def _hf_decoupled_decay(weight_decay: float, lr_schedule: Schedule,
                        mask_fn: Callable[[Tree], Dict[str, bool]],
                        layerwise_decay: Optional[float] = None) -> GradientTransformation:
    """HF AdamW's decay after the learning-rate step: ``u - lr*wd*(p + u)``.
    With ``layerwise_decay`` the decay takes the layer's factor too, as HF's
    per-group learning rates do."""

    def update(updates: Tree, count: int, params: Optional[Tree] = None):
        if params is None:
            raise ValueError("params required for decoupled weight decay")
        lr = lr_schedule(count) if callable(lr_schedule) else lr_schedule
        mask = mask_fn(params)
        out = {}
        for k, u in updates.items():
            if not mask[k]:
                out[k] = u
                continue
            f = 1.0 if layerwise_decay is None else _layerwise_factor(k, layerwise_decay)
            out[k] = u - (lr * f) * weight_decay * (params[k] + u)
        return out, count + 1

    return GradientTransformation(lambda params: 0, update)


class FactoredState(NamedTuple):
    """optax's ``FactoredState``: per leaf, ``v_row`` and ``v_col`` for a
    factored leaf (``v`` a (1,) placeholder) or ``v`` (the others ``(1,)``),
    each in the JAX leaf's orientation."""
    count: int
    v_row: Tree
    v_col: Tree
    v: Tree


def _is_kernel(path: str, t: torch.Tensor) -> bool:
    """A dense ``kernel``: ``(in, out)`` in the JAX tree, ``(out, in)`` here."""
    return t.dim() == 2 and path.rsplit("/", 1)[-1] == "kernel"


def _jax_view(path: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` in its JAX leaf's orientation (a view; its own inverse)."""
    return t.t() if _is_kernel(path, t) else t


def _factored_dims(shape, min_dim_size_to_factor: int) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the two largest axes (by ``np.argsort``),
    when the smaller of them has ``min_dim_size_to_factor``."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


# optax.adafactor's defaults, the JAX package's values
_DECAY_RATE, _MIN_DIM_SIZE_TO_FACTOR, _EPSILON = 0.8, 128, 1e-30
_CLIPPING_THRESHOLD, _MIN_PARAM_SCALE = 1.0, 1e-3


def scale_by_factored_rms() -> GradientTransformation:
    """optax's ``scale_by_factored_rms`` (factored=True, no step offset):
    the second moment of a leaf whose two largest axes have 128 elements is
    kept as its row and column means, the rest whole; decay
    ``1 - (t+1)^-0.8``.
    The arithmetic follows optax's dtypes: the decays are float32 scalars, so
    the new statistics are formed in float32 and cast to the leaf's dtype."""

    def init(params: Tree) -> FactoredState:
        v_row, v_col, v = {}, {}, {}
        for k, p in params.items():
            shape = tuple(_jax_view(k, p).shape)
            one = torch.zeros(1, dtype=p.dtype, device=p.device)
            dims = _factored_dims(shape, _MIN_DIM_SIZE_TO_FACTOR)
            if dims is None:
                v_row[k], v_col[k], v[k] = one, one.clone(), torch.zeros(
                    shape, dtype=p.dtype, device=p.device)
                continue
            d1, d0 = dims
            v_row[k] = torch.zeros(tuple(np.delete(shape, d0)), dtype=p.dtype, device=p.device)
            v_col[k] = torch.zeros(tuple(np.delete(shape, d1)), dtype=p.dtype, device=p.device)
            v[k] = one
        return FactoredState(0, v_row, v_col, v)

    def update(updates: Tree, state: FactoredState, params: Optional[Tree] = None):
        if params is None:
            raise ValueError("params required for scale_by_factored_rms")
        t = torch.tensor(state.count + 1, dtype=torch.float32)
        decay = 1.0 - t ** (-_DECAY_RATE)
        keep = 1.0 - decay
        out, v_row, v_col, v = {}, {}, {}, {}
        for k, u in updates.items():
            g = _jax_view(k, u)
            dtype = params[k].dtype
            g_sq = g * g + _EPSILON
            dims = _factored_dims(tuple(g.shape), _MIN_DIM_SIZE_TO_FACTOR)
            if dims is None:
                new_v = (decay * state.v[k].float() + keep * g_sq.float()).to(dtype)
                upd = g * new_v ** -0.5
                v_row[k], v_col[k], v[k] = state.v_row[k], state.v_col[k], new_v
            else:
                d1, d0 = dims
                new_row = (decay * state.v_row[k].float()
                           + keep * g_sq.mean(dim=d0).float()).to(dtype)
                new_col = (decay * state.v_col[k].float()
                           + keep * g_sq.mean(dim=d1).float()).to(dtype)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (new_row / new_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
                col_factor = new_col ** -0.5
                upd = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
                v_row[k], v_col[k], v[k] = new_row, new_col, state.v[k]
            out[k] = _jax_view(k, upd)
        return out, FactoredState(state.count + 1, v_row, v_col, v)

    return GradientTransformation(init, update)


def clip_by_block_rms(threshold: float) -> GradientTransformation:
    """optax's ``clip_by_block_rms``: each leaf over ``max(1, rms / threshold)``."""

    def update(updates: Tree, state, params=None):
        return {k: u / torch.clamp(torch.sqrt(torch.mean(u * u)) / threshold, min=1.0)
                for k, u in updates.items()}, state

    return GradientTransformation(lambda params: (), update)


def scale_by_param_block_rms(min_scale: float = 1e-3) -> GradientTransformation:
    """optax's ``scale_by_param_block_rms``: each leaf times its parameter's
    RMS, at least ``min_scale``."""

    def update(updates: Tree, state, params: Optional[Tree] = None):
        if params is None:
            raise ValueError("params required for scale_by_param_block_rms")
        out = {}
        for k, u in updates.items():
            rms = torch.sqrt(torch.mean(params[k] * params[k]))
            out[k] = u * torch.where(rms <= min_scale, torch.full_like(rms, min_scale), rms)
        return out, state

    return GradientTransformation(lambda params: (), update)


def scale(factor: float) -> GradientTransformation:
    def update(updates: Tree, state, params=None):
        return {k: u * factor for k, u in updates.items()}, state

    return GradientTransformation(lambda params: (), update)


def adafactor(lr: Schedule) -> GradientTransformation:
    """``optax.adafactor(learning_rate=lr, multiply_by_parameter_scale=True,
    clipping_threshold=1.0)`` with its other defaults (no momentum, no
    weight decay)."""
    return chain(scale_by_factored_rms(), clip_by_block_rms(_CLIPPING_THRESHOLD),
                 scale_by_learning_rate(lr, flip_sign=False),
                 scale_by_param_block_rms(_MIN_PARAM_SCALE), scale(-1.0))


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params: Tree):
        return tuple(tx.init(params) for tx in txs)

    def update(updates: Tree, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


class MultiStepsState(NamedTuple):
    mini_step: int
    gradient_step: int
    inner_opt_state: Any
    acc_grads: Tree


def multi_steps(tx: GradientTransformation, every_k: int) -> GradientTransformation:
    """Gradient accumulation as ``optax.MultiSteps``: the running mean of k
    gradients goes through ``tx`` on every k-th call; the calls between
    return zero updates and leave ``tx``'s state as it was."""

    def init(params: Tree) -> MultiStepsState:
        return MultiStepsState(0, 0, tx.init(params),
                               {k: torch.zeros_like(p) for k, p in params.items()})

    def update(updates: Tree, state: MultiStepsState, params=None):
        n = state.mini_step
        acc = {k: a + (updates[k] - a) / (n + 1) for k, a in state.acc_grads.items()}
        if n == every_k - 1:
            final, inner = tx.update(acc, state.inner_opt_state, params)
            zeros = {k: torch.zeros_like(a) for k, a in acc.items()}
            return final, MultiStepsState(0, state.gradient_step + 1, inner, zeros)
        zeros = {k: torch.zeros_like(u) for k, u in updates.items()}
        return zeros, MultiStepsState(n + 1, state.gradient_step, state.inner_opt_state, acc)

    return GradientTransformation(init, update)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``p += u`` in place, in each parameter's dtype (optax's
    ``(p + u).astype(p.dtype)``); returns ``params``."""
    with torch.no_grad():
        for k, p in params.items():
            p.add_(updates[k])
    return params


def make_optimizer(cfg: OptimConfig) -> GradientTransformation:
    """The JAX package's ``make_optimizer`` chain for ``adam``, ``adamw``,
    ``adamw8bit`` and ``adafactor``."""
    scheduler_steps = cfg.scheduler_steps or cfg.total_steps
    if cfg.scheduler == "linear":
        lr: Schedule = warmup_linear_schedule(cfg.lr, cfg.warmup_steps, scheduler_steps,
                                              cfg.min_ratio, cfg.fixed_lr)
    else:
        lr = cfg.lr
    if cfg.optim == "adafactor":
        # cfg.weight_decay is not applied: optax applies adafactor's decay
        # rate after the learning rate (rate x p a step), so AdamW's 0.1
        # would shrink every parameter by 10% a step (the JAX package's note)
        tx = chain(clip_by_global_norm(cfg.clip), adafactor(lr))
        return multi_steps(tx, cfg.accumulation_steps) if cfg.accumulation_steps > 1 else tx
    steps = [clip_by_global_norm(cfg.clip)]
    if cfg.optim == "adam":
        # torch.optim.Adam bias-corrects
        correct = True if cfg.adam_correct_bias is None else cfg.adam_correct_bias
        steps.append(_scale_by_adam(correct, cfg.adam_b1, cfg.adam_b2, cfg.adam_eps))
    elif cfg.optim in ("adamw", "adamw8bit"):
        # HF AdamW(correct_bias=False); adamw8bit keeps its moments in 8 bits
        correct = False if cfg.adam_correct_bias is None else cfg.adam_correct_bias
        if cfg.optim == "adamw":
            steps.append(_scale_by_adam(correct, cfg.adam_b1, cfg.adam_b2, cfg.adam_eps))
        else:
            from lako_tpu_torch.train.optim8 import scale_by_adam_8bit

            steps.append(scale_by_adam_8bit(b1=cfg.adam_b1, b2=cfg.adam_b2,
                                            eps=cfg.adam_eps, correct_bias=correct))
    else:
        raise ValueError(cfg.optim)
    if cfg.layerwise_decay is not None:
        steps.append(_layerwise_scale(cfg.layerwise_decay))
    steps.append(scale_by_learning_rate(lr))
    if cfg.optim in ("adamw", "adamw8bit") and cfg.weight_decay > 0:
        steps.append(_hf_decoupled_decay(cfg.weight_decay, lr, _no_decay_mask,
                                         layerwise_decay=cfg.layerwise_decay))
    tx = chain(*steps)
    if cfg.accumulation_steps > 1:
        tx = multi_steps(tx, cfg.accumulation_steps)
    return tx
