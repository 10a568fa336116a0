"""Typed configuration: the part of lako_tpu/core/config.py that serving needs.

A copy, not an import: ``lako_tpu.core`` pulls in jax when imported. Field
names and defaults equal the JAX package's (pinned by
tests/test_torch_serve.py), so a config written for one reads in the other.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


class _ConfigBase:
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
    # (ops/flash_streamed.py); shorter ones would take the whole-block
    # kernel, which is not ported yet and raises on CUDA.
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
