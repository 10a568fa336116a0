"""Weights for the port's BERT retriever: from a JAX param tree, from an HF
``BertModel`` state_dict, or a fresh init.

``params_from_jax`` maps the JAX package's flax ``Retriever`` (or
``BertEncoder``) param tree (any nested mapping of arrays; ``jax`` is not
imported) onto this package's ``state_dict``: module paths are kept
(``bert.layer_3.attention.query``), flax ``kernel (in, out)`` becomes
``weight (out, in)``, and ``embedding`` and LayerNorm ``scale`` become
``weight``. ``jax_param_paths`` maps the other way, for the optimizer's
no-decay mask.

``state_dict_from_hf_bert`` is the counterpart of
lako_tpu/models/bert/convert.py's ``params_from_torch_bert``: it reads a
local state_dict (no download, no ``transformers``). ``init_retriever``
draws the flax init.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from lako_tpu_torch.core.config import BertConfig, RetrieverConfig
from lako_tpu_torch.models.bert.model import Embedding, LayerNorm, Linear

_LEAF_NAMES = {"kernel": "weight", "embedding": "weight", "scale": "weight"}


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax Retriever / BertEncoder param tree → ``state_dict`` of float32
    CPU tensors."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
                continue
            arr = np.array(value, dtype=np.float32)
            if name == "kernel":
                arr = arr.T
            out[prefix + _LEAF_NAMES.get(name, name)] = torch.from_numpy(
                np.ascontiguousarray(arr))

    walk(tree, "")
    return out


def jax_param_paths(model: nn.Module) -> Dict[str, str]:
    """This package's parameter names → the JAX package's ``/``-joined paths
    (``bert/layer_0/attention/query/kernel``): the inverse of
    :func:`params_from_jax`'s renaming."""
    leaf = {Linear: {"weight": "kernel"}, Embedding: {"weight": "embedding"},
            LayerNorm: {"weight": "scale"}}
    paths: Dict[str, str] = {}
    for prefix, module in model.named_modules():
        for name, _ in module.named_parameters(recurse=False):
            path = (prefix.split(".") if prefix else [])
            path.append(leaf.get(type(module), {}).get(name, name))
            paths[f"{prefix}.{name}" if prefix else name] = "/".join(path)
    return paths


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def state_dict_from_hf_bert(state_dict: Mapping, config: BertConfig,
                            prefix: str = "") -> Dict[str, torch.Tensor]:
    """An HF ``BertModel`` state_dict (optionally under ``prefix``, e.g.
    ``"bert."``) → the port's ``BertEncoder`` state_dict. HF's Linear
    weights are already ``(out, in)``."""
    sd = {k[len(prefix):]: v for k, v in state_dict.items()} if prefix else dict(state_dict)
    out = {
        "embeddings.word_embeddings.weight": _t(sd["embeddings.word_embeddings.weight"]),
        "embeddings.position_embeddings.weight": _t(
            sd["embeddings.position_embeddings.weight"]),
        "embeddings.token_type_embeddings.weight": _t(
            sd["embeddings.token_type_embeddings.weight"]),
        "embeddings.layer_norm.weight": _t(sd["embeddings.LayerNorm.weight"]),
        "embeddings.layer_norm.bias": _t(sd["embeddings.LayerNorm.bias"]),
    }
    names = {"attention.query": "attention.self.query", "attention.key": "attention.self.key",
             "attention.value": "attention.self.value", "attention.out": "attention.output.dense",
             "attention.out_layer_norm": "attention.output.LayerNorm",
             "intermediate": "intermediate.dense", "output": "output.dense",
             "output_layer_norm": "output.LayerNorm"}
    for i in range(config.num_hidden_layers):
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                out[f"layer_{i}.{ours}.{leaf}"] = _t(sd[f"encoder.layer.{i}.{theirs}.{leaf}"])
    return out


@torch.no_grad()
def init_retriever(cfg: RetrieverConfig, generator: torch.Generator,
                   dtype: torch.dtype = torch.float32):
    """A Retriever on ``generator.device`` with the flax init: normal(0.02)
    for every Dense kernel and embedding table, zero biases, LayerNorm scale
    1 and bias 0; in eval mode."""
    from lako_tpu_torch.models.retriever import Retriever

    with torch.device(generator.device):
        model = Retriever(cfg, dtype)
    for module in model.modules():
        if isinstance(module, (Linear, Embedding)):
            module.weight.normal_(0.0, 0.02, generator=generator)
            if isinstance(module, Linear):
                module.bias.zero_()
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return model.eval()
