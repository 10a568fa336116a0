"""Train state: step count, parameters and optimizer state (the port of
lako_tpu/train/state.py)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from lako_tpu_torch.core import profiling
from lako_tpu_torch.train.optim import GradientTransformation, apply_updates


@dataclass
class TrainState:
    """``params`` maps JAX parameter paths to the model's own parameter
    tensors. ``apply_gradients`` updates them in place, so the model trains
    without a copy (the JAX package returns new arrays instead), and returns
    the state with the next step and optimizer state, as ``replay_update``
    does for an update a CUDA graph captured. The optimizer's moments take
    the parameters' dtype, as ``tx.init`` does. The update is the stream
    span ``train.optimizer`` (core/profiling.py)."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Any
    tx: GradientTransformation

    @classmethod
    def create(cls, params: Dict[str, torch.Tensor], tx: GradientTransformation) -> "TrainState":
        return cls(step=0, params=params, opt_state=tx.init(params), tx=tx)

    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> "TrainState":
        def update():
            updates, opt_state = self.tx.update(grads, self.opt_state, self.params)
            apply_updates(self.params, updates)
            return opt_state

        return self._advance(update)

    def load_update(self) -> Optional[Any]:
        """The host half of a captured update (``tx.load``): the next
        optimizer state, or None where this update cannot be captured."""
        return None if self.tx.load is None else self.tx.load(self.opt_state, self.params)

    def replay_update(self, replay: Callable[[], None], opt_state=None) -> "TrainState":
        """The state after the host half, unless its ``opt_state`` is given,
        and ``replay()`` of the captured device half (``tx.apply``)."""
        def update():
            loaded = self.load_update() if opt_state is None else opt_state
            replay()
            return loaded

        return self._advance(update)

    def _advance(self, update: Callable[[], Any]) -> "TrainState":
        """``update()`` updates the parameters and returns the next optimizer state."""
        device = next(iter(self.params.values())).device
        with torch.no_grad(), profiling.span("train.optimizer", device=device):
            opt_state = update()
        return dataclasses.replace(self, step=self.step + 1, opt_state=opt_state)
