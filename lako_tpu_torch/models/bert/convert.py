"""Weights for the port's BERT retriever: from a JAX param tree, from an HF
``BertModel`` state_dict, or a fresh init.

``params_from_jax`` maps the JAX package's flax ``Retriever`` (or
``BertEncoder``) param tree (any nested mapping of arrays; ``jax`` is not
imported) onto this package's ``state_dict``: module paths are kept
(``bert.layer_3.attention.query``), flax ``kernel (in, out)`` becomes
``weight (out, in)``, and ``embedding`` and LayerNorm ``scale`` become
``weight``. ``jax_param_paths`` maps the other way, for the optimizer's
no-decay mask.

``state_dict_from_hf_bert``, ``retriever_state_dict_from_hf_bert`` and
``bert_config_from_hf`` are the counterparts of
lako_tpu/models/bert/convert.py's ``params_from_torch_bert``,
``retriever_params_from_torch_bert`` and ``bert_config_from_hf``: they read
a local state_dict and config (no download, no ``transformers``).
``init_retriever`` draws the flax init.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from lako_tpu_torch.core.config import BertConfig, RetrieverConfig
from lako_tpu_torch.models.hf_io import float32_copy
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


def state_dict_from_hf_bert(state_dict: Mapping, config: BertConfig,
                            prefix: str = "") -> Dict[str, torch.Tensor]:
    """An HF ``BertModel`` state_dict (optionally under ``prefix``, e.g.
    ``"bert."``) → the port's ``BertEncoder`` state_dict, float32 on the
    host. HF's Linear weights are already ``(out, in)``."""
    _t = float32_copy
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


def retriever_state_dict_from_hf_bert(state_dict: Mapping, retriever_config: RetrieverConfig,
                                     rng_seed: int = 0) -> Dict[str, torch.Tensor]:
    """The port's ``Retriever`` state_dict from an HF ``BertModel``
    state_dict: the BERT backbone converted, the projection head(s) drawn
    fresh as the JAX converter draws them (numpy ``default_rng(rng_seed)``,
    normal(0.02) kernels, zero biases, LayerNorm 1 and 0; the reference's
    ``initialize_wBERT=True`` path)."""
    cfg = retriever_config
    rng = np.random.default_rng(rng_seed)
    hidden, dim = cfg.bert.hidden_size, cfg.indexing_dimension
    out = {f"bert.{k}": v for k, v in state_dict_from_hf_bert(state_dict, cfg.bert).items()}

    def head(name: str) -> None:
        kernel = rng.normal(scale=0.02, size=(hidden, dim)).astype(np.float32)
        out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.T))
        out[f"{name}.bias"] = torch.zeros(dim)

    def norm(name: str) -> None:
        out[f"{name}.weight"], out[f"{name}.bias"] = torch.ones(dim), torch.zeros(dim)

    if cfg.projection:
        head("proj")
        norm("norm")
    elif cfg.asymmetric:
        head("proj_iq")
        head("proj_fact")
        norm("norm_iq")
        norm("norm_fact")
    return out


def bert_config_from_hf(hf_config) -> BertConfig:
    """A ``transformers.BertConfig`` (or any object with its fields) → ours."""
    return BertConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_hidden_layers=hf_config.num_hidden_layers,
        num_attention_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        hidden_act=hf_config.hidden_act,
        hidden_dropout_prob=hf_config.hidden_dropout_prob,
        attention_probs_dropout_prob=hf_config.attention_probs_dropout_prob,
        max_position_embeddings=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        layer_norm_eps=hf_config.layer_norm_eps,
        pad_token_id=hf_config.pad_token_id,
    )


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
