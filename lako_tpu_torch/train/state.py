"""Train state: step count, parameters and optimizer state (the port of
lako_tpu/train/state.py)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict

import torch

from lako_tpu_torch.core import profiling
from lako_tpu_torch.train.optim import GradientTransformation, apply_updates


@dataclass
class TrainState:
    """``params`` maps JAX parameter paths to the model's own parameter
    tensors. ``apply_gradients`` updates them in place, so the model trains
    without a copy (the JAX package returns new arrays instead), and returns
    the state with the next step and optimizer state. The optimizer's moments
    take the parameters' dtype, as ``tx.init`` does. The update is the stream
    span ``train.optimizer`` (core/profiling.py)."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Any
    tx: GradientTransformation

    @classmethod
    def create(cls, params: Dict[str, torch.Tensor], tx: GradientTransformation) -> "TrainState":
        return cls(step=0, params=params, opt_state=tx.init(params), tx=tx)

    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> "TrainState":
        device = next(iter(self.params.values())).device
        with torch.no_grad(), profiling.span("train.optimizer", device=device):
            updates, opt_state = self.tx.update(grads, self.opt_state, self.params)
            apply_updates(self.params, updates)
        return dataclasses.replace(self, step=self.step + 1, opt_state=opt_state)
