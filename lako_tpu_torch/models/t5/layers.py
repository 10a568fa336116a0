"""T5 building blocks as torch ``nn.Module``s.

Counterpart of lako_tpu/models/t5/layers.py, with the same module names so
the JAX parameter paths map one to one (models/t5/convert.py). Parameters are
float32; each module computes in its ``dtype`` (bfloat16 on the card) and
casts its weights at use, as flax does. Softmax and norm statistics stay in
float32. Attention is unscaled (T5 folds 1/sqrt(d) into the q init) and masks
additively with ``NEG_INF = -1e9``, never -inf.

Dropout sits where the JAX package has it, one :class:`Dropout` module per
application: attention probabilities on the plain path, the MLP's inner
activation, and each residual branch of the encoder (2) and decoder (3)
blocks. Each module is switched by ``self.training``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lako_tpu_torch.core.config import T5Config
from lako_tpu_torch.ops.flash_attention import fused_attention
from lako_tpu_torch.ops.flash_streamed import streamed_attention

NEG_INF = -1e9
_MASK64 = (1 << 64) - 1

# jax.nn names used by feed_forward_proj; jax.nn.gelu is the tanh approximation,
# which is also HF's "gelu_new" (T5 v1.1 and Flan-T5's dense_act_fn)
ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
}


def activation(name: str):
    if name not in ACTIVATIONS:
        raise ValueError(f"unsupported activation {name!r}; have {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]


def _mix(*values: int) -> int:
    """splitmix64 folded over ``values``: a 63-bit generator seed that
    changes with any of them."""
    h = 0
    for value in values:
        h = (h + (value & _MASK64) + 0x9E3779B97F4A7C15) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h >> 1


class Dropout(nn.Module):
    """Inverted dropout whose mask is a function of ``(seed, step, site)``.

    ``site`` numbers the model's Dropout modules (:func:`number_dropout_sites`)
    and :func:`set_dropout_key` sets ``(seed, step)`` before a training
    forward. Each application seeds a generator of its own from the three, so
    a recomputation under activation checkpointing draws the same mask:
    ``torch.utils.checkpoint`` restores only the default generators' states,
    and masks drawn from one shared custom generator would differ on the
    recompute and make the gradients silently wrong. This is the role of
    ``jax.random.fold_in`` in the JAX package; the bits differ from JAX's.
    Keeps ``1 - rate`` of the elements scaled by ``1 / (1 - rate)``, as flax's
    ``nn.Dropout``; the identity in eval mode or at rate 0.

    ``applied`` counts the applications since the key was set (two a site
    under remat: the forward and the recompute). A CUDA graph cannot make a
    generator while it captures, so a captured train step hands the module
    ``generators``, one an application, and seeds them before every replay
    (:meth:`seed_generators`, train/reader.py): each draws once from offset
    0, the bits of a fresh generator.
    """

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.site = 0
        self.key: Optional[Tuple[int, int]] = None
        self.applied = 0
        self.generators: Optional[List[torch.Generator]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = self.keep_mask(x)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros((), dtype=x.dtype,
                                                                     device=x.device))

    def keep_mask(self, x: torch.Tensor) -> torch.Tensor:
        """This application's mask: ``rand(x.shape) < 1 - rate`` from a
        generator seeded with ``_mix(seed, step, site)``."""
        if self.key is None:
            raise RuntimeError("dropout in training mode needs set_dropout_key(model, "
                               "seed, step) before the forward")
        if self.generators is None:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(_mix(*self.key, self.site))
        else:
            gen = self.generators[self.applied]
        self.applied += 1
        return torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - self.rate

    def seed_generators(self, generators: List[torch.Generator], seed: int, step: int) -> None:
        """Seeds each of ``generators`` as this module seeds the generator
        of its draws at ``(seed, step)``."""
        for gen in generators:
            gen.manual_seed(_mix(seed, step, self.site))


def number_dropout_sites(model: nn.Module) -> None:
    """Give each Dropout module of ``model`` its site number, in module order."""
    for site, module in enumerate(m for m in model.modules() if isinstance(m, Dropout)):
        module.site = site


def set_dropout_key(model: nn.Module, seed: int, step: int) -> None:
    """The ``(seed, step)`` every Dropout module of ``model`` draws its mask
    from until the next call (the JAX train step's ``fold_in(rng, step)``);
    each module's count of applications starts again."""
    for module in model.modules():
        if isinstance(module, Dropout):
            module.key = (seed, step)
            module.applied = 0


class Dense(nn.Module):
    """Bias-free linear layer, weight ``(out, in)`` float32, computed in ``dtype``.

    ``init_std`` is the normal init the JAX package uses for this layer
    (None = flax's lecun_normal); :func:`convert.init_fid_t5` reads it.
    """

    def __init__(self, features_in: int, features_out: int, dtype: torch.dtype,
                 init_std: Optional[float] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features_out, features_in))
        self.dtype = dtype
        self.init_std = init_std

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class RMSNorm(nn.Module):
    """T5 layer norm: scale-only RMS norm, no mean subtraction, f32 statistics;
    cast to the compute dtype before the weight multiply."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        y = (xf * torch.rsqrt(var + self.eps)).to(self.dtype)
        return y * self.weight.to(self.dtype)


def relative_position_bucket(relative_position: torch.Tensor, bidirectional: bool,
                             num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5 relative-position bucketing (log-spaced beyond max_exact), with the
    JAX package's float32 log formula."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(ret.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = val_if_large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large.to(n.dtype))


class RelativePositionBias(nn.Module):
    """Learned bias over bucketed relative positions, computed once per stack and
    shared by all its layers."""

    def __init__(self, config: T5Config, bidirectional: bool, dtype: torch.dtype):
        super().__init__()
        self.config = config
        self.bidirectional = bidirectional
        self.dtype = dtype
        self.rel_embedding = nn.Embedding(config.relative_attention_num_buckets,
                                          config.num_heads)
        self._on_device: Dict[Tuple[int, int, int, torch.device], torch.Tensor] = {}

    def buckets(self, qlen: int, klen: int, offset: int = 0) -> torch.Tensor:
        """(q, k) bucket ids, computed on the CPU so every device sees the
        same buckets."""
        cfg = self.config
        context = torch.arange(qlen)[:, None] + offset
        memory = torch.arange(klen)[None, :]
        return relative_position_bucket(
            memory - context, bidirectional=self.bidirectional,
            num_buckets=cfg.relative_attention_num_buckets,
            max_distance=cfg.relative_attention_max_distance)

    def device_buckets(self, qlen: int, klen: int, offset: int,
                       device: torch.device) -> torch.Tensor:
        """:meth:`buckets` copied to ``device`` once a shape: a CUDA graph
        cannot capture the copy from pageable host memory."""
        key = (qlen, klen, offset, device)
        if key not in self._on_device:
            self._on_device[key] = self.buckets(qlen, klen, offset).to(device)
        return self._on_device[key]

    def forward(self, qlen: int, klen: int, offset: int = 0) -> torch.Tensor:
        weight = self.rel_embedding.weight
        buckets = self.device_buckets(qlen, klen, offset, weight.device)
        values = F.embedding(buckets, weight)                # (q, k, heads)
        return values.permute(2, 0, 1)[None].to(self.dtype)  # (1, h, q, k)


class T5Attention(nn.Module):
    """Multi-head attention, T5 flavor: no 1/sqrt(d) scaling, f32 softmax,
    additive bias on the logits. ``forward`` returns ``(output, logits)``: the
    pre-softmax logits are the capture point for cross-attention
    distillation (None when an attention kernel ran)."""

    def __init__(self, config: T5Config, dtype: torch.dtype, multiquery: bool = False):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.multiquery = multiquery
        inner = cfg.num_heads * cfg.d_kv
        kv_inner = cfg.d_kv if multiquery else inner
        # q absorbs the absent 1/sqrt(d_kv) attention scaling
        self.q = Dense(cfg.d_model, inner, dtype, (cfg.d_model * cfg.d_kv) ** -0.5)
        self.k = Dense(cfg.d_model, kv_inner, dtype, cfg.d_model ** -0.5)
        self.v = Dense(cfg.d_model, kv_inner, dtype, cfg.d_model ** -0.5)
        self.o = Dense(inner, cfg.d_model, dtype, inner ** -0.5)
        self.dropout = Dropout(cfg.dropout_rate)   # attention probabilities

    def _split(self, x: torch.Tensor, heads: int) -> torch.Tensor:
        b, l, _ = x.shape
        return x.reshape(b, l, heads, self.config.d_kv).transpose(1, 2)

    def split_heads(self, x: torch.Tensor) -> torch.Tensor:
        return self._split(x, self.config.num_heads)

    def split_kv_heads(self, x: torch.Tensor) -> torch.Tensor:
        return self._split(x, 1 if self.multiquery else self.config.num_heads)

    @staticmethod
    def merge_heads(x: torch.Tensor) -> torch.Tensor:
        b, h, l, d = x.shape
        return x.transpose(1, 2).reshape(b, l, h * d)

    @staticmethod
    def _qk(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        if k.shape[1] == q.shape[1]:
            return torch.einsum("bhqd,bhkd->bhqk", q, k)
        return torch.einsum("bhqd,bkd->bhqk", q, k[:, 0])  # multiquery broadcast

    @staticmethod
    def _pv(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        if v.shape[1] == probs.shape[1]:
            return torch.einsum("bhqk,bhkd->bhqd", probs, v)
        return torch.einsum("bhqk,bkd->bhqd", probs, v[:, 0])

    def project_kv(self, enc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.split_kv_heads(self.k(enc)), self.split_kv_heads(self.v(enc))

    def _attend(self, q, k, v, bias):
        logits = self._qk(q, k).float()
        if bias is not None:
            logits = logits + bias.float()
        probs = torch.softmax(logits, dim=-1).to(self.dtype)
        return self.o(self.merge_heads(self._pv(probs, v))), logits

    def step_cached(self, hidden: torch.Tensor, cache: Tuple[torch.Tensor, torch.Tensor],
                    step: int, bias: torch.Tensor) -> torch.Tensor:
        """Incremental self-attention of one position: this step's k/v are
        written into ``cache`` ((B, h, max_len, d), in place) at ``step``,
        then q attends over the whole cache; ``bias`` masks the positions
        after ``step``."""
        ck, cv = cache
        ck[:, :, step:step + 1] = self.split_kv_heads(self.k(hidden))
        cv[:, :, step:step + 1] = self.split_kv_heads(self.v(hidden))
        return self._attend(self.split_heads(self.q(hidden)), ck, cv, bias)[0]

    def attend_cached(self, hidden: torch.Tensor,
                      cross_kv: Tuple[torch.Tensor, torch.Tensor],
                      bias: Optional[torch.Tensor]):
        """Cross-attention against precomputed K/V (incremental decode):
        returns (output, logits)."""
        return self._attend(self.split_heads(self.q(hidden)), *cross_kv, bias)

    def forward(self, hidden: torch.Tensor, kv: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                stream_parts: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                allow_fused: bool = False):
        """bias: additive logits bias (1|B, heads|1, q, k) that already holds
        the key masking. stream_parts: (rel_bias (h, q, k) f32, key_mask
        (B, k) bool), the factored bias of the K-streamed kernel; bias must
        be None then. allow_fused: take the whole-block kernel K4 under
        ``use_flash_attention`` unless dropout applies (no logits output)."""
        cfg = self.config
        q = self.split_heads(self.q(hidden))
        k, v = self.project_kv(hidden if kv is None else kv)
        if stream_parts is not None:
            assert bias is None
            rel, key_mask = stream_parts
            out = streamed_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                     rel, key_mask)
            return self.o(self.merge_heads(out)), None
        if (allow_fused and cfg.use_flash_attention
                and not (self.training and cfg.dropout_rate > 0.0)):
            out = fused_attention(q.contiguous(), k.contiguous(), v.contiguous(), bias)
            return self.o(self.merge_heads(out)), None
        logits = self._qk(q, k).float()
        if bias is not None:
            logits = logits + bias.float()
        probs = self.dropout(torch.softmax(logits, dim=-1).to(self.dtype))
        return self.o(self.merge_heads(self._pv(probs, v))), logits


class T5MLP(nn.Module):
    def __init__(self, config: T5Config, dtype: torch.dtype):
        super().__init__()
        cfg = config
        self.config = cfg
        wi_std = cfg.d_model ** -0.5
        if cfg.is_gated_act:
            self.wi_0 = Dense(cfg.d_model, cfg.d_ff, dtype, wi_std)
            self.wi_1 = Dense(cfg.d_model, cfg.d_ff, dtype, wi_std)
        else:
            self.wi = Dense(cfg.d_model, cfg.d_ff, dtype, wi_std)
        self.wo = Dense(cfg.d_ff, cfg.d_model, dtype, cfg.d_ff ** -0.5)
        self.dropout = Dropout(cfg.dropout_rate)   # inner activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if cfg.is_gated_act:
            act = activation(cfg.feed_forward_proj.removeprefix("gated-"))
            h = act(self.wi_0(x)) * self.wi_1(x)
        else:
            h = activation(cfg.feed_forward_proj)(self.wi(x))
        return self.wo(self.dropout(h))


class T5EncoderBlock(nn.Module):
    def __init__(self, config: T5Config, dtype: torch.dtype):
        super().__init__()
        cfg = config
        self.ln_attn = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype)
        self.self_attn = T5Attention(cfg, dtype)
        self.ln_mlp = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype)
        self.mlp = T5MLP(cfg, dtype)
        self.drop_attn = Dropout(cfg.dropout_rate)
        self.drop_mlp = Dropout(cfg.dropout_rate)

    def forward(self, x, bias, stream_parts=None):
        h, _ = self.self_attn(self.ln_attn(x), bias=bias, stream_parts=stream_parts,
                              allow_fused=True)
        x = x + self.drop_attn(h)
        return x + self.drop_mlp(self.mlp(self.ln_mlp(x)))


class T5DecoderBlock(nn.Module):
    def __init__(self, config: T5Config, dtype: torch.dtype, has_cross: bool = True):
        super().__init__()
        cfg = config
        self.has_cross = has_cross  # False under FiDO layer-sparse cross-attention
        self.ln_self = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype)
        self.self_attn = T5Attention(cfg, dtype)
        if has_cross:
            self.ln_cross = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype)
            self.cross_attn = T5Attention(cfg, dtype,
                                          multiquery=cfg.multiquery_cross_attention)
        self.ln_mlp = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype)
        self.mlp = T5MLP(cfg, dtype)
        self.drop_self = Dropout(cfg.dropout_rate)
        if has_cross:
            self.drop_cross = Dropout(cfg.dropout_rate)
        self.drop_mlp = Dropout(cfg.dropout_rate)

    def decode_step(self, x, self_bias, cross_bias, cache, cross_kv, step: int):
        """One incremental step (eval: no dropout). x: (B, 1, H); cache: this
        layer's self K/V, written at ``step``; cross_kv: the precomputed
        encoder K/V. Returns (x, cross_logits (B, h, 1, K) | None)."""
        x = x + self.self_attn.step_cached(self.ln_self(x), cache, step, self_bias)
        cross_logits = None
        if self.has_cross:
            h, cross_logits = self.cross_attn.attend_cached(self.ln_cross(x), cross_kv,
                                                            cross_bias)
            x = x + h
        return x + self.mlp(self.ln_mlp(x)), cross_logits

    def forward(self, x, enc, self_bias, cross_bias):
        """Teacher-forced block. Returns (x, cross_logits | None)."""
        h, _ = self.self_attn(self.ln_self(x), bias=self_bias)
        x = x + self.drop_self(h)
        cross_logits = None
        if self.has_cross:
            h, cross_logits = self.cross_attn(self.ln_cross(x), kv=enc, bias=cross_bias)
            x = x + self.drop_cross(h)
        return x + self.drop_mlp(self.mlp(self.ln_mlp(x))), cross_logits


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of ``x`` along its last axis, largest first,
    with ``lax.top_k``'s order among equal values: the lower index first
    (a stable descending sort; ``torch.topk`` promises no order for ties)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, k) boolean key mask → additive (B, 1, 1, k) float32 bias."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask[:, None, None, :], zero, NEG_INF)


def causal_bias(qlen: int, klen: int, device, offset: int = 0) -> torch.Tensor:
    q = torch.arange(qlen, device=device)[:, None] + offset
    k = torch.arange(klen, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(k <= q, zero, NEG_INF)[None, None]
