"""Typed configuration: the part of lako_tpu/core/config.py that serving,
reader training and the attention signal need.

A copy, not an import: ``lako_tpu.core`` pulls in jax when imported. Field
names and defaults equal the JAX package's (pinned by
tests/test_torch_serve.py), so a config written for one reads in the other.
Options the port does not run yet are kept as fields and raise where they are
used (ROADMAP items named there).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


class _ConfigBase:
    @classmethod
    def from_dict(cls, d: dict):
        """The config from a JSON dict; nested configs from nested dicts."""
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            t = globals().get(f.type) if isinstance(f.type, str) else f.type
            if isinstance(v, dict) and t is not None and dataclasses.is_dataclass(t):
                v = t.from_dict(v)
            kwargs[f.name] = v
        return cls(**kwargs)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class T5Config(_ConfigBase):
    """T5 architecture hyperparameters (HF-compatible naming for weight import).

    Defaults are t5-base. Size presets via :func:`t5_config_for_size`.
    """

    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 3072
    num_layers: int = 12
    num_decoder_layers: int = 12
    num_heads: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"  # t5 v1.0 uses relu; v1.1 uses gated-gelu
    tie_word_embeddings: bool = True
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0
    # Route encoder self-attention through a fused kernel. Sequences
    # >= flash_min_length take the K-streamed CUDA kernel
    # (ops/flash_streamed.py), shorter ones the whole-block kernel
    # (ops/flash_attention.py).
    use_flash_attention: bool = False
    flash_min_length: int = 512
    # Tile sizes of the JAX streamed kernel. Kept so that configs read the
    # same in both packages; the CUDA kernel uses its own fixed tile.
    flash_block_q: int = 512
    flash_block_k: int = 1024
    # FiDO-style decoder options (arXiv 2212.08153): both change the
    # architecture, so they are OFF for HF-checkpoint parity.
    # cross-attend only in every k-th decoder layer (None/1 = every layer)
    cross_attention_stride: Optional[int] = None
    # share one K/V head across all query heads in decoder cross-attention
    multiquery_cross_attention: bool = False

    def has_cross_attention(self, layer_idx: int) -> bool:
        stride = self.cross_attention_stride or 1
        # keep the LAST layer's cross-attention (FiDO keeps the topmost)
        return (self.num_decoder_layers - 1 - layer_idx) % stride == 0

    @property
    def d_inner(self) -> int:
        return self.num_heads * self.d_kv

    @property
    def is_gated_act(self) -> bool:
        return self.feed_forward_proj.startswith("gated-")


_T5_SIZES = {
    # name: (d_model, d_kv, d_ff, layers, heads)
    "tiny": (64, 16, 128, 2, 4),  # test-only size
    "small": (512, 64, 2048, 6, 8),
    "base": (768, 64, 3072, 12, 12),
    "large": (1024, 64, 4096, 24, 16),
    "3b": (1024, 128, 16384, 24, 32),
    "11b": (1024, 128, 65536, 24, 128),
}


def t5_config_for_size(size: str, **overrides) -> T5Config:
    """Preset matching HF ``t5-{size}`` configs."""
    d_model, d_kv, d_ff, layers, heads = _T5_SIZES[size]
    cfg = T5Config(
        d_model=d_model,
        d_kv=d_kv,
        d_ff=d_ff,
        num_layers=layers,
        num_decoder_layers=layers,
        num_heads=heads,
    )
    return cfg.replace(**overrides) if overrides else cfg


@dataclass(frozen=True)
class ReaderDataConfig(_ConfigBase):
    """Reader example construction + batching.

    stream=1 packs [question + caption + fact] into one passage; stream=2 builds
    two passages [question+caption, fact].
    """

    n_context: int = 10
    text_maxlength: int = 130
    answer_maxlength: int = 20
    stream: int = 2
    use_fact: bool = True
    fact_use_way: str = "concate"  # "concate" | "separate"
    question_prefix: str = "question:"
    caption_prefix: str = "context:"
    fact_prefix: str = "fact:"

    @property
    def n_passages(self) -> int:
        if not self.use_fact:
            return 1
        if self.fact_use_way == "concate":
            return self.stream
        return 1 + self.n_context


@dataclass(frozen=True)
class OptimConfig(_ConfigBase):
    """Optimizer + schedule (train/optim.py)."""

    optim: str = "adamw"  # "adam" | "adamw" | "adafactor" | "adamw8bit"
    lr: float = 1e-4
    weight_decay: float = 0.1
    clip: float = 1.0
    scheduler: str = "linear"  # "fixed" | "linear"
    warmup_steps: int = 1000
    total_steps: int = 1000
    scheduler_steps: Optional[int] = None
    min_ratio: float = 0.0
    fixed_lr: bool = False
    accumulation_steps: int = 1
    # Layerwise LR decay over encoder layers named layer_{i}: decay ** (7 - i).
    layerwise_decay: Optional[float] = None
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-6
    # None: Adam bias-corrects, AdamW (HF's correct_bias=False) does not.
    adam_correct_bias: Optional[bool] = None


@dataclass(frozen=True)
class MeshConfig(_ConfigBase):
    """Device layout: data-parallel, tensor-parallel and pipeline axes. The
    port trains on one device (ROADMAP item 12)."""

    data: int = -1  # -1: all devices on the data axis
    model: int = 1
    pipe: int = 1
    batch_axis: str = "data"
    model_axis: str = "model"
    pipe_axis: str = "pipe"


@dataclass(frozen=True)
class ReaderTrainConfig(_ConfigBase):
    """Reader training loop (train/reader.py)."""

    model_size: str = "base"
    per_device_batch_size: int = 8
    eval_batch_size: int = 8
    epochs: int = 20
    early_stop: int = 3
    # evaluate every k-th epoch; the final epoch always evaluates
    eval_every: int = 1
    seed: int = 0
    eval_max_length: int = 50
    warmup_fraction: float = 0.06
    use_remat: bool = True  # activation checkpointing of the encoder blocks
    remat_policy: Optional[str] = None  # None/'full' | 'dots'
    dtype: str = "bfloat16"
    # master-parameter (and so Adam-moment) dtype: "float32" | "bfloat16"
    param_dtype: str = "float32"
    profile_dir: Optional[str] = None
    decode_backend: str = "auto"
    # "flax" | "scan": one train step in the port (train/reader.py)
    train_backend: str = "flax"
    decode_kv_dtype: str = "native"
    decode_weights_dtype: str = "native"
    decode_chunk_size: Optional[int] = None
    decode_self_attn_impl: str = "allslots"
    pp_microbatches: int = 1
    pp_schedule: str = "gpipe"
    data: ReaderDataConfig = field(default_factory=ReaderDataConfig)
    optim: OptimConfig = field(default_factory=lambda: OptimConfig(lr=4e-5))
    mesh: MeshConfig = field(default_factory=MeshConfig)
    checkpoint_dir: str = "./checkpoint"
    name: str = "experiment"


@dataclass(frozen=True)
class AttentionSignalConfig(_ConfigBase):
    """Cross-attention score aggregation (signal/aggregate.py)."""

    attention_score_style: str = "mean"  # "mean" | "max" | "21mean"
    use_last_half_layer_attention: bool = False
    ans_attention: bool = False
    stream: int = 2
    n_context: int = 10
    pad_score: float = -5.0  # filler for missing facts
