"""T5 encoder/decoder stacks and the Fusion-in-Decoder reader.

Counterpart of lako_tpu/models/t5/model.py. FiD: the N passages of an example
are encoded independently as one ``(B*N, L)`` batch, then the decoder
cross-attends over the concatenated ``N*L`` encoder states. The
cross-attention logits are an optional output of the forward pass (the
distillation signal).

Encoder self-attention takes the K-streamed kernel (ops/flash_streamed.py)
when ``use_flash_attention`` is on and ``L >= flash_min_length``, as in the
JAX package. Shorter sequences would take the whole-block kernel K4, which is
not ported: on CUDA that case raises rather than run plain attention, and on
the CPU it runs plain attention, as the JAX package does off the TPU.

Dropout is not ported yet (it comes with the train step, ROADMAP item 2):
running a config with ``dropout_rate > 0`` in training mode raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lako_tpu_torch.core.config import T5Config
from lako_tpu_torch.models.t5.layers import (
    Dense,
    RelativePositionBias,
    RMSNorm,
    T5DecoderBlock,
    T5EncoderBlock,
    causal_bias,
    mask_to_bias,
)


def _no_dropout(module: nn.Module, cfg: T5Config) -> None:
    if module.training and cfg.dropout_rate > 0.0:
        raise NotImplementedError(
            "dropout is not ported yet (ROADMAP item 2); call .eval() or set "
            "dropout_rate=0.0")


class _Stack(nn.Module):
    """Blocks registered as ``block_{i}``, the JAX package's parameter paths."""

    def _add_blocks(self, blocks) -> None:
        self.num_blocks = len(blocks)
        for i, block in enumerate(blocks):
            self.add_module(f"block_{i}", block)

    @property
    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.num_blocks)]


class T5Encoder(_Stack):
    def __init__(self, config: T5Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.relpos = RelativePositionBias(cfg, bidirectional=True, dtype=dtype)
        self._add_blocks([T5EncoderBlock(cfg, dtype) for _ in range(cfg.num_layers)])
        self.final_ln = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype)

    def forward(self, embeds: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """embeds: (B, L, H) token embeddings; mask: (B, L) bool."""
        cfg = self.config
        _no_dropout(self, cfg)
        L = embeds.shape[1]
        x = embeds
        if cfg.use_flash_attention and L >= cfg.flash_min_length:
            # K-streamed kernel: factored bias, the (B,h,L,L) tensor never exists
            rel = self.relpos(L, L)[0].float().contiguous()   # (h, L, L)
            parts = (rel, mask.contiguous())
            for block in self.blocks:
                x = block(x, None, parts)
        else:
            if cfg.use_flash_attention and embeds.is_cuda:
                raise NotImplementedError(
                    f"use_flash_attention with L={L} < flash_min_length="
                    f"{cfg.flash_min_length} needs the whole-block kernel K4 "
                    "(ops/flash_attention.py), not ported yet (ROADMAP kernel "
                    "queue); set flash_min_length <= L or use_flash_attention=False")
            bias = self.relpos(L, L) + mask_to_bias(mask)
            for block in self.blocks:
                x = block(x, bias)
        return self.final_ln(x)


class T5Decoder(_Stack):
    def __init__(self, config: T5Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.relpos = RelativePositionBias(cfg, bidirectional=False, dtype=dtype)
        self._add_blocks([T5DecoderBlock(cfg, dtype, has_cross=cfg.has_cross_attention(i))
                          for i in range(cfg.num_decoder_layers)])
        self.final_ln = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype)

    def forward(self, embeds, enc, enc_mask, *, self_mask=None,
                collect_cross_logits: bool = False):
        """Teacher-forced decode. embeds: (B, T, H); enc: (B, K, H); enc_mask:
        (B, K) bool. Returns (hidden (B,T,H), cross_logits (B, layers, heads,
        T, K) or None)."""
        _no_dropout(self, self.config)
        T = embeds.shape[1]
        self_bias = self.relpos(T, T) + causal_bias(T, T, embeds.device)
        if self_mask is not None:
            self_bias = self_bias + mask_to_bias(self_mask)
        cross_bias = mask_to_bias(enc_mask)
        x = embeds
        cross_logits = []
        for block in self.blocks:
            x, xl = block(x, enc, self_bias, cross_bias)
            if collect_cross_logits and xl is not None:
                cross_logits.append(xl)
        x = self.final_ln(x)
        stacked = torch.stack(cross_logits, dim=1) if collect_cross_logits else None
        return x, stacked

    def init_cache(self, batch: int, max_len: int, enc: torch.Tensor):
        """Per-layer (self K/V buffers, cross K/V) for incremental decode; the
        cross K/V are projected once from the encoder states."""
        cfg = self.config
        shape = (batch, cfg.num_heads, max_len, cfg.d_kv)
        self_caches, cross_kvs = [], []
        for block in self.blocks:
            zeros = torch.zeros(shape, dtype=self.dtype, device=enc.device)
            self_caches.append((zeros, zeros.clone()))
            cross_kvs.append(block.cross_attn.project_kv(enc) if block.has_cross else None)
        return self_caches, cross_kvs

    def decode_biases(self, enc_mask: torch.Tensor, max_len: int):
        """Loop-invariant decode inputs: the (1, h, max_len, max_len)
        self-attention relpos bias and the cross-attention key-mask bias."""
        return self.relpos(max_len, max_len), mask_to_bias(enc_mask)


class T5(nn.Module):
    """Plain T5 conditional generation model (single passage)."""

    def __init__(self, config: T5Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = T5Encoder(cfg, dtype)
        self.decoder = T5Decoder(cfg, dtype)
        if not cfg.tie_word_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.vocab_size, dtype)

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.shared.weight).to(self.dtype)

    def logits_from_hidden(self, hidden: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if cfg.tie_word_embeddings:
            hidden = hidden * (cfg.d_model ** -0.5)
            return hidden @ self.shared.weight.to(self.dtype).T
        return self.lm_head(hidden)

    def encode(self, input_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.encoder(self.embed(input_ids), mask)

    def decode(self, decoder_input_ids, enc, enc_mask, *,
               collect_cross_logits: bool = False):
        hidden, xl = self.decoder(self.embed(decoder_input_ids), enc, enc_mask,
                                  collect_cross_logits=collect_cross_logits)
        return self.logits_from_hidden(hidden), xl

    def forward(self, input_ids, mask, decoder_input_ids, *,
                collect_cross_logits: bool = False):
        enc = self.encode(input_ids, mask)
        return self.decode(decoder_input_ids, enc, mask,
                           collect_cross_logits=collect_cross_logits)


def shift_right(labels: torch.Tensor, decoder_start_token_id: int,
                pad_id: int = 0) -> torch.Tensor:
    """Decoder inputs from labels (T5 convention); -100 label slots → pad."""
    shifted = torch.roll(labels, 1, dims=-1)
    shifted[:, 0] = decoder_start_token_id
    return torch.where(shifted == -100, torch.full_like(shifted, pad_id), shifted)


class FiDT5(nn.Module):
    """Fusion-in-Decoder T5 over fixed-shape (B, N, L) passage batches."""

    def __init__(self, config: T5Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.t5 = T5(config, dtype)

    def encode_passages(self, input_ids: torch.Tensor, mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, N, L) → encoder states (B, N·L, H) and flattened mask (B, N·L)."""
        B, N, L = input_ids.shape
        enc = self.t5.encode(input_ids.reshape(B * N, L), mask.reshape(B * N, L))
        return enc.reshape(B, N * L, enc.shape[-1]), mask.reshape(B, N * L)

    def forward(self, input_ids, mask, labels, *, collect_cross_logits: bool = False):
        """Returns (loss, logits, cross_logits | None). cross_logits: (B,
        layers, heads, T, N·L) pre-softmax decoder cross-attention logits."""
        cfg = self.config
        enc, enc_mask = self.encode_passages(input_ids, mask)
        dec_in = shift_right(labels, cfg.decoder_start_token_id, cfg.pad_token_id)
        logits, xl = self.t5.decode(dec_in, enc, enc_mask,
                                    collect_cross_logits=collect_cross_logits)
        valid = labels != -100
        safe_labels = torch.where(valid, labels, torch.zeros_like(labels))
        logp = torch.log_softmax(logits.float(), dim=-1)
        token_ll = torch.gather(logp, -1, safe_labels[..., None].long())[..., 0]
        # mean over valid tokens (torch CrossEntropyLoss(ignore_index=-100))
        loss = -(token_ll * valid).sum() / valid.sum().clamp_min(1)
        return loss, logits, xl


def model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device
