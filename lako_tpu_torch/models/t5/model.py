"""T5 encoder/decoder stacks and the Fusion-in-Decoder reader.

Counterpart of lako_tpu/models/t5/model.py. FiD: the N passages of an example
are encoded independently as one ``(B*N, L)`` batch, then the decoder
cross-attends over the concatenated ``N*L`` encoder states. The
cross-attention logits are an optional output of the forward pass (the
distillation signal).

Encoder self-attention takes the K-streamed kernel (ops/flash_streamed.py,
differentiable) when ``use_flash_attention`` is on and ``L >=
flash_min_length``, except in training with ``dropout_rate > 0``, exactly the
JAX package's ``_use_streamed_flash``. Under ``use_flash_attention`` with a
shorter sequence (the default ``flash_min_length`` is 512, so L=130 lands
here) and no dropout in the way, it takes the whole-block kernel K4
(ops/flash_attention.py) with the dense ``(B, h, L, L)`` bias, where the JAX
package takes its fused Pallas kernel; on CPU tensors K4's wrapper runs its
plain version.

Dropout follows ``self.training`` (layers.py ``Dropout``); the train step
sets its key with ``set_dropout_key``. ``use_remat`` checkpoints each
encoder block (never the decoder's, as in the JAX package) with
``torch.utils.checkpoint``, under ``remat_policy`` None/"full" (recompute
everything) or "dots" (keep the matmul outputs).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from lako_tpu_torch.core.config import T5Config
from lako_tpu_torch.models.t5.layers import (
    NEG_INF,
    Dense,
    Dropout,
    RelativePositionBias,
    RMSNorm,
    T5DecoderBlock,
    T5EncoderBlock,
    causal_bias,
    mask_to_bias,
    number_dropout_sites,
)

# matmuls without batch dimensions: the dense layers' products, not the
# attention's batched ones (jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def resolve_remat_policy(name):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a remat policy
    name: None/"full" recomputes everything in the backward, "dots" keeps
    the dense layers' matmul outputs and recomputes the rest."""
    if name in (None, "full"):
        return noop_context_fn
    if name == "dots":
        return functools.partial(create_selective_checkpoint_contexts, _save_dots)
    raise ValueError(f"unknown remat policy {name!r}")


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
    def __init__(self, config: T5Config, dtype: torch.dtype = torch.float32,
                 use_remat: bool = False, remat_policy: Optional[str] = None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.use_remat = use_remat
        self.remat_context = resolve_remat_policy(remat_policy)
        self.relpos = RelativePositionBias(cfg, bidirectional=True, dtype=dtype)
        self._add_blocks([T5EncoderBlock(cfg, dtype) for _ in range(cfg.num_layers)])
        self.final_ln = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, dtype)
        self.embed_dropout = Dropout(cfg.dropout_rate)
        self.final_dropout = Dropout(cfg.dropout_rate)

    def _use_streamed_flash(self, L: int) -> bool:
        cfg = self.config
        if not (cfg.use_flash_attention and L >= cfg.flash_min_length):
            return False
        return not (self.training and cfg.dropout_rate > 0.0)

    def _run_blocks(self, x, bias, parts):
        remat = self.use_remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                # masks come from Dropout's own (seed, step, site) generators,
                # never the global ones, so there is no RNG state to restore
                x = checkpoint(block, x, bias, parts, use_reentrant=False,
                               preserve_rng_state=False, context_fn=self.remat_context)
            else:
                x = block(x, bias, parts)
        return x

    def forward(self, embeds: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """embeds: (B, L, H) token embeddings; mask: (B, L) bool."""
        L = embeds.shape[1]
        x = self.embed_dropout(embeds)
        if self._use_streamed_flash(L):
            # K-streamed kernel: factored bias, the (B,h,L,L) tensor never exists
            rel = self.relpos(L, L)[0].float().contiguous()   # (h, L, L)
            x = self._run_blocks(x, None, (rel, mask.contiguous()))
        else:
            # (B, h, L, L) bias; under use_flash_attention the blocks take K4
            x = self._run_blocks(x, self.relpos(L, L) + mask_to_bias(mask), None)
        return self.final_dropout(self.final_ln(x))


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
        self.embed_dropout = Dropout(cfg.dropout_rate)
        self.final_dropout = Dropout(cfg.dropout_rate)

    def forward(self, embeds, enc, enc_mask, *, self_mask=None,
                collect_cross_logits: bool = False):
        """Teacher-forced decode. embeds: (B, T, H); enc: (B, K, H); enc_mask:
        (B, K) bool. Returns (hidden (B,T,H), cross_logits (B, layers, heads,
        T, K) or None)."""
        T = embeds.shape[1]
        self_bias = self.relpos(T, T) + causal_bias(T, T, embeds.device)
        if self_mask is not None:
            self_bias = self_bias + mask_to_bias(self_mask)
        cross_bias = mask_to_bias(enc_mask)
        x = self.embed_dropout(embeds)
        cross_logits = []
        for block in self.blocks:
            x, xl = block(x, enc, self_bias, cross_bias)
            if collect_cross_logits and xl is not None:
                cross_logits.append(xl)
        x = self.final_dropout(self.final_ln(x))
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

    def decode_step(self, embeds, self_bias_full, cross_bias, self_caches, cross_kvs,
                    step: int, max_len: int, collect_cross_logits: bool = False):
        """One incremental step (eval). embeds: (B, 1, H); the biases come
        from :meth:`decode_biases`, the caches from :meth:`init_cache` (the
        self K/V are written in place at ``step``). Returns (hidden (B,1,H),
        cross_logits (B, cross layers, heads, K) | None)."""
        row = self_bias_full[:, :, step:step + 1]                  # (1, h, 1, S)
        valid = torch.arange(max_len, device=row.device) <= step
        row = torch.where(valid, row, torch.full((), NEG_INF, dtype=row.dtype,
                                                 device=row.device))
        x = embeds
        cross_logits = []
        for block, cache, ckv in zip(self.blocks, self_caches, cross_kvs):
            x, xl = block.decode_step(x, row, cross_bias, cache, ckv, step)
            if collect_cross_logits and xl is not None:
                cross_logits.append(xl[:, :, 0, :])               # (B, heads, K)
        x = self.final_ln(x)
        stacked = torch.stack(cross_logits, dim=1) if collect_cross_logits else None
        return x, stacked


class T5(nn.Module):
    """Plain T5 conditional generation model (single passage)."""

    def __init__(self, config: T5Config, dtype: torch.dtype = torch.float32,
                 use_remat: bool = False, remat_policy: Optional[str] = None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = T5Encoder(cfg, dtype, use_remat, remat_policy)
        self.decoder = T5Decoder(cfg, dtype)
        if not cfg.tie_word_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.vocab_size, dtype)
        number_dropout_sites(self)

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
    """Fusion-in-Decoder T5 over fixed-shape (B, N, L) passage batches.
    Trains in training mode (dropout on), evaluates in eval mode."""

    def __init__(self, config: T5Config, dtype: torch.dtype = torch.float32,
                 use_remat: bool = False, remat_policy: Optional[str] = None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.t5 = T5(config, dtype, use_remat, remat_policy)

    def encode_passages(self, input_ids: torch.Tensor, mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, N, L) → encoder states (B, N·L, H) and flattened mask (B, N·L)."""
        B, N, L = input_ids.shape
        enc = self.t5.encode(input_ids.reshape(B * N, L), mask.reshape(B * N, L))
        return enc.reshape(B, N * L, enc.shape[-1]), mask.reshape(B, N * L)

    def decode_step(self, tokens: torch.Tensor, self_bias_full, cross_bias, self_caches,
                    cross_kvs, step: int, max_len: int, collect_cross_logits: bool = False):
        """One greedy/beam decode step of the layer-unrolled path: tokens (B,)
        → (logits (B, V), step cross logits (B, cross layers, heads, K) |
        None); the self caches are written in place (T5Decoder.decode_step)."""
        hidden, xl = self.t5.decoder.decode_step(
            self.t5.embed(tokens[:, None]), self_bias_full, cross_bias, self_caches,
            cross_kvs, step, max_len, collect_cross_logits)
        return self.t5.logits_from_hidden(hidden[:, 0]), xl

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
