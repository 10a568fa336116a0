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
update kernel K5 on the card) in the same chain. Adafactor is not ported yet
and raises.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

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


def scale_by_learning_rate(lr: Schedule) -> GradientTransformation:
    """Multiply by ``-lr(count)`` (or ``-lr``); the count starts at 0."""

    def update(updates: Tree, count: int, params=None):
        step = -(lr(count) if callable(lr) else lr)
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
    """The JAX package's ``make_optimizer`` chain for ``adam``, ``adamw`` and
    ``adamw8bit``."""
    scheduler_steps = cfg.scheduler_steps or cfg.total_steps
    if cfg.scheduler == "linear":
        lr: Schedule = warmup_linear_schedule(cfg.lr, cfg.warmup_steps, scheduler_steps,
                                              cfg.min_ratio, cfg.fixed_lr)
    else:
        lr = cfg.lr
    if cfg.optim == "adafactor":
        raise NotImplementedError("optim='adafactor' is not ported yet (ROADMAP item 13)")
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
