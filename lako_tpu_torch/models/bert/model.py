"""BERT encoder as torch ``nn.Module``s: the port of lako_tpu/models/bert/model.py.

Post-LayerNorm transformer with learned absolute positions, scaled
dot-product attention (1/sqrt(d)) and exact GELU. The module names are the
JAX package's (``embeddings``, ``layer_{i}``, ``attention.query``, ...), so
its flax param tree maps one to one (models/bert/convert.py).

Parameters are float32; each module computes in its ``dtype`` (bfloat16 on
the card in training) and casts its weights at use, as flax does. The
attention logits and softmax run in float32 and the probabilities are cast
back to the compute dtype; LayerNorm statistics are float32 (flax's
``E[x^2] - E[x]^2`` variance). Attention is plain matmul and softmax, not
``scaled_dot_product_attention``, so that the casts follow the JAX ones. The
key mask enters as an additive bias of ``NEG_INF = -1e9``.

Difference on purpose: flax's ``nn.Embed`` fills a position past the table
with NaN, which the embedding stage reports as non-finite. Here the same
lookup would raise an ``IndexError`` on the CPU and a device-side assert on
the card, so :class:`BertEmbeddings` checks the length first and raises the
``FloatingPointError`` the embedding stage would have raised.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lako_tpu_torch.core.config import BertConfig
from lako_tpu_torch.models.t5.layers import Dropout

NEG_INF = -1e9


class Linear(nn.Module):
    """flax ``nn.Dense``: weight ``(out, in)`` and bias float32, computed in
    ``dtype``."""

    def __init__(self, features_in: int, features_out: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features_out, features_in))
        self.bias = nn.Parameter(torch.zeros(features_out))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: float32 statistics with the variance as
    ``E[x^2] - E[x]^2`` clipped at 0, ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias``, the result cast to ``dtype``."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
        mul = torch.rsqrt(var.clamp_min(0.0) + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(self.dtype)


class Embedding(nn.Module):
    """flax ``nn.Embed``: a float32 table looked up and cast to ``dtype``."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim))
        self.dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight.to(self.dtype))


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.word_embeddings = Embedding(config.vocab_size, config.hidden_size, dtype)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             config.hidden_size, dtype)
        self.token_type_embeddings = Embedding(config.type_vocab_size, config.hidden_size,
                                               dtype)
        self.layer_norm = LayerNorm(config.hidden_size, config.layer_norm_eps, dtype)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        L = input_ids.shape[1]
        if L > self.config.max_position_embeddings:
            raise FloatingPointError(
                f"sequence length {L} exceeds bert.max_position_embeddings "
                f"({self.config.max_position_embeddings}): the position lookup would make "
                f"the embeddings non-finite (NaN in the JAX model); tokenize at most "
                f"{self.config.max_position_embeddings} tokens")
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        positions = torch.arange(L, device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids) + self.position_embeddings(positions)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        h = config.hidden_size
        self.query = Linear(h, h, dtype)
        self.key = Linear(h, h, dtype)
        self.value = Linear(h, h, dtype)
        self.out = Linear(h, h, dtype)
        self.out_layer_norm = LayerNorm(h, config.layer_norm_eps, dtype)
        self.attn_dropout = Dropout(config.attention_probs_dropout_prob)
        self.out_dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        h = self.config.num_attention_heads
        B, L, D = x.shape
        d = D // h

        def split(t):
            return t.reshape(B, L, h, d).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        logits = torch.matmul(q, k.transpose(-1, -2)).float()
        logits = logits / (d ** 0.5) + bias
        probs = self.attn_dropout(torch.softmax(logits, dim=-1).to(self.dtype))
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, D)
        out = self.out_dropout(self.out(ctx))
        return self.out_layer_norm(out + x)


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if config.hidden_act not in ("gelu", "relu"):
            raise ValueError(f"unsupported hidden_act {config.hidden_act!r}; have gelu, relu")
        self.config = config
        self.attention = BertSelfAttention(config, dtype)
        self.intermediate = Linear(config.hidden_size, config.intermediate_size, dtype)
        self.output = Linear(config.intermediate_size, config.hidden_size, dtype)
        self.output_layer_norm = LayerNorm(config.hidden_size, config.layer_norm_eps, dtype)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = self.attention(x, bias)
        inner = self.intermediate(x)
        # BERT's "gelu" is the exact erf form (jax.nn.gelu(approximate=False))
        act = F.gelu(inner) if self.config.hidden_act == "gelu" else F.relu(inner)
        h = self.dropout(self.output(act))
        return self.output_layer_norm(h + x)


class BertEncoder(nn.Module):
    """Returns the sequence of hidden states (HF BertModel.last_hidden_state)."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config, dtype)
        for i in range(config.num_hidden_layers):
            self.add_module(f"layer_{i}", BertLayer(config, dtype))

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.config.num_hidden_layers)]

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids, dtype=torch.bool)
        bias = torch.where(attention_mask[:, None, None, :].bool(), 0.0, NEG_INF)
        x = self.embeddings(input_ids, token_type_ids)
        for layer in self.layers():
            x = layer(x, bias)
        return x
