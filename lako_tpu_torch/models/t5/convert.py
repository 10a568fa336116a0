"""Weights for the port's FiDT5: from a JAX param tree, or a fresh init.

``params_from_jax`` maps the JAX package's flax ``FiDT5`` param tree (any
nested mapping of arrays; ``jax`` is not imported) onto this package's
``state_dict``: module paths are kept (``t5.encoder.block_3.self_attn.q``),
flax ``kernel (in, out)`` becomes ``weight (out, in)``, and ``embedding``
becomes ``weight``.

``init_fid_t5`` draws the JAX package's init distributions from a
``torch.Generator``. The scales matter: a plain default init overflows
bfloat16 activations at t5-large.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from lako_tpu_torch.core.config import T5Config
from lako_tpu_torch.models.t5.layers import Dense, RelativePositionBias, RMSNorm
from lako_tpu_torch.models.t5.model import FiDT5

_LEAF_NAMES = {"kernel": "weight", "embedding": "weight",
               "rel_embedding": "rel_embedding.weight"}


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax FiDT5 param tree → ``state_dict`` of float32 CPU tensors."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
                continue
            arr = np.array(value, dtype=np.float32)
            if name == "kernel":
                arr = arr.T
            key = prefix + _LEAF_NAMES.get(name, name)
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(tree, "")
    return out


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    # flax's default Dense init: truncated normal (2 std) scaled to 1/fan_in
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


@torch.no_grad()
def init_fid_t5(cfg: T5Config, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> FiDT5:
    """A FiDT5 on ``generator.device`` with the JAX package's init
    distributions (layers.py ``_dense`` stds, relpos std d_model**-0.5,
    shared embedding std 1, norms 1), in eval mode."""
    with torch.device(generator.device):
        model = FiDT5(cfg, dtype)
    for module in model.modules():
        if isinstance(module, Dense):
            if module.init_std is None:
                _lecun_normal_(module.weight, generator)
            else:
                module.weight.normal_(0.0, module.init_std, generator=generator)
        elif isinstance(module, RMSNorm):
            module.weight.fill_(1.0)
        elif isinstance(module, RelativePositionBias):
            module.rel_embedding.weight.normal_(0.0, cfg.d_model ** -0.5,
                                                generator=generator)
    model.t5.shared.weight.normal_(0.0, 1.0, generator=generator)
    return model.eval()
