"""Weights for the port's FiDT5: from a JAX param tree, or a fresh init.

``params_from_jax`` maps the JAX package's flax ``FiDT5`` param tree (any
nested mapping of arrays; ``jax`` is not imported) onto this package's
``state_dict``: module paths are kept (``t5.encoder.block_3.self_attn.q``),
flax ``kernel (in, out)`` becomes ``weight (out, in)``, and ``embedding``
becomes ``weight``.

``jax_param_paths`` maps the other way, for code that reads the JAX paths.
``state_dict_from_hf_t5`` and ``t5_config_from_hf`` are the counterparts of
lako_tpu/models/t5/convert.py's ``params_from_torch_t5`` and
``t5_config_from_hf``: they read a local HF T5 state_dict and config (no
download, no ``transformers``). ``init_fid_t5`` draws the JAX package's
init distributions from a ``torch.Generator``. The scales matter: a plain
default init overflows bfloat16 activations at t5-large.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from lako_tpu_torch.core.config import T5Config
from lako_tpu_torch.models.hf_io import float32_copy
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


def jax_param_paths(model: nn.Module) -> Dict[str, str]:
    """This package's parameter names → the JAX package's parameter paths,
    ``/``-joined (``t5/encoder/block_0/self_attn/q/kernel``): the inverse of
    :func:`params_from_jax`'s renaming. The optimizer's no-decay mask and
    layerwise factors read these paths, as the JAX package's do."""
    paths: Dict[str, str] = {}
    for prefix, module in model.named_modules():
        for leaf, _ in module.named_parameters(recurse=False):
            path = prefix.split(".") if prefix else []
            if isinstance(module, Dense):
                path.append("kernel")
            elif isinstance(module, nn.Embedding):
                if path[-1] != "rel_embedding":
                    path.append("embedding")
            else:
                path.append(leaf)
            paths[f"{prefix}.{leaf}" if prefix else leaf] = "/".join(path)
    return paths


def _hf_names(cfg: T5Config) -> Dict[str, str]:
    """The port's ``T5`` parameter names → HF ``T5ForConditionalGeneration``'s."""
    mlp = ("wi_0", "wi_1", "wo") if cfg.is_gated_act else ("wi", "wo")
    names = {"shared.weight": "shared.weight"}
    for stack, n_layers, parts in (
            ("encoder", cfg.num_layers,
             (("ln_attn", "self_attn", "SelfAttention"), ("ln_mlp", "mlp", None))),
            ("decoder", cfg.num_decoder_layers,
             (("ln_self", "self_attn", "SelfAttention"), ("ln_cross", "cross_attn",
                                                          "EncDecAttention"),
              ("ln_mlp", "mlp", None)))):
        names[f"{stack}.relpos.rel_embedding.weight"] = (
            f"{stack}.block.0.layer.0.SelfAttention.relative_attention_bias.weight")
        names[f"{stack}.final_ln.weight"] = f"{stack}.final_layer_norm.weight"
        for i in range(n_layers):
            for j, (ln, ours, theirs) in enumerate(parts):
                hf = f"{stack}.block.{i}.layer.{j}"
                names[f"{stack}.block_{i}.{ln}.weight"] = f"{hf}.layer_norm.weight"
                for w in (mlp if theirs is None else ("q", "k", "v", "o")):
                    names[f"{stack}.block_{i}.{ours}.{w}.weight"] = (
                        f"{hf}.{theirs or 'DenseReluDense'}.{w}.weight")
    if not cfg.tie_word_embeddings:
        names["lm_head.weight"] = "lm_head.weight"
    return names


def state_dict_from_hf_t5(state_dict: Mapping, cfg: T5Config, fid: bool = True,
                          device: Union[str, torch.device] = "cpu") -> Dict[str, torch.Tensor]:
    """An HF T5 ``state_dict`` → the port's ``FiDT5`` state_dict (``T5``'s
    without ``fid``), float32 on ``device``. HF's Linear weights are already
    ``(out, in)``; the relative-position table is the first block's
    ``relative_attention_bias``; ``lm_head`` only when embeddings are untied."""
    prefix = "t5." if fid else ""
    return {prefix + ours: float32_copy(state_dict[theirs], device)
            for ours, theirs in _hf_names(cfg).items()}


def t5_config_from_hf(hf_config) -> T5Config:
    """A ``transformers.T5Config`` (or any object with its fields) → ours."""
    ff = getattr(hf_config, "feed_forward_proj", "relu")
    if ff == "gated-gelu":
        ff = ("gated-gelu_new" if getattr(hf_config, "dense_act_fn", "") == "gelu_new"
              else "gated-gelu")
    return T5Config(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.d_model,
        d_kv=hf_config.d_kv,
        d_ff=hf_config.d_ff,
        num_layers=hf_config.num_layers,
        num_decoder_layers=hf_config.num_decoder_layers,
        num_heads=hf_config.num_heads,
        relative_attention_num_buckets=hf_config.relative_attention_num_buckets,
        relative_attention_max_distance=getattr(hf_config, "relative_attention_max_distance",
                                                128),
        dropout_rate=hf_config.dropout_rate,
        layer_norm_epsilon=hf_config.layer_norm_epsilon,
        feed_forward_proj=ff,
        tie_word_embeddings=hf_config.tie_word_embeddings,
        pad_token_id=hf_config.pad_token_id,
        eos_token_id=hf_config.eos_token_id,
        decoder_start_token_id=hf_config.decoder_start_token_id,
    )


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    # flax's default Dense init: truncated normal (2 std) scaled to 1/fan_in
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


@torch.no_grad()
def init_fid_t5(cfg: T5Config, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, use_remat: bool = False,
                remat_policy: Optional[str] = None) -> FiDT5:
    """A FiDT5 on ``generator.device`` with the JAX package's init
    distributions (layers.py ``_dense`` stds, relpos std d_model**-0.5,
    shared embedding std 1, norms 1), in eval mode."""
    with torch.device(generator.device):
        model = FiDT5(cfg, dtype, use_remat, remat_policy)
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
