"""Stacked-weight greedy decode engine: the serving decode path.

Counterpart of lako_tpu/models/t5/engine.py (``DecodeEngine``, greedy). The
decoder weights are stacked on a leading layer axis once, when the engine is
built, in the compute dtype (the engine keeps that snapshot: rebuild it after
the model's weights change). Per generate call the loop-invariant work is
hoisted out of the token loop: the cross-attention K/V projection of the
encoder states, the self-attention relative-position rows and the cross
key-mask bias. Each step then runs every layer on one token per row.

Layouts are the JAX engine's: the cross K/V are ``(layers, B, hk, d, K)``
with the key axis minor, the layout the int8 kernel reads, and the
self-attention cache is ``(layers, B, h, d, S)``. The cache is written in
place, one column per layer per step, after that layer has read it.

``kv_dtype="int8"`` stores the cross K/V as symmetric int8 with one scale per
(layer, row, head, channel). With ``fused_cross=True`` each step after the
score-capturing one runs cross-attention through the CUDA kernel
(ops/decode_cross_attn.py), which reads the int8 bytes directly; otherwise
the same int8 values go through plain dequantizing einsums.

Not ported yet (each raises ``NotImplementedError``; ROADMAP item 3):
``kv_dtype="int8mxu"``, ``weights_dtype="int8"`` and chunked early exit
(``chunk_size``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lako_tpu_torch.core.config import T5Config
from lako_tpu_torch.models.t5.layers import (
    NEG_INF,
    activation,
    relative_position_bucket,
)
from lako_tpu_torch.models.t5.model import FiDT5, model_device
from lako_tpu_torch.ops.decode_cross_attn import fused_decode_cross_attention


class StackedDecoder(NamedTuple):
    """Decoder weights stacked on a leading (num_decoder_layers,) axis; matmul
    weights are ``(in, out)`` so a step computes ``x @ w``."""

    ln_self: torch.Tensor      # (l, H)
    wqkv_self: torch.Tensor    # (l, H, 3*h*d): q/k/v fused into one matmul
    wo_self: torch.Tensor      # (l, h*d, H)
    ln_cross: torch.Tensor
    wq_cross: torch.Tensor
    wk_cross: torch.Tensor     # (l, H, hk*d)
    wv_cross: torch.Tensor
    wo_cross: torch.Tensor
    ln_mlp: torch.Tensor
    wi: Optional[torch.Tensor]       # (l, H, F): relu/simple act
    wi_0: Optional[torch.Tensor]     # gated act pair
    wi_1: Optional[torch.Tensor]
    wo_mlp: torch.Tensor             # (l, F, H)
    final_ln: torch.Tensor           # (H,) f32
    embedding: torch.Tensor          # (V, H)
    lm_head: Optional[torch.Tensor]  # (H, V); None when tie_word_embeddings
    relpos: torch.Tensor             # (buckets, h) f32


class Quantized(NamedTuple):
    values: torch.Tensor  # int8
    scale: torch.Tensor   # f32, size 1 on the quantized axis


def engine_supported(cfg: T5Config) -> bool:
    """True when every decoder layer cross-attends (no FiDO stride)."""
    return all(cfg.has_cross_attention(i) for i in range(cfg.num_decoder_layers))


@torch.no_grad()
def stack_decoder_params(model: FiDT5, dtype: torch.dtype) -> StackedDecoder:
    """Extract and stack the decoder weights, cast to the compute dtype."""
    cfg = model.config
    t5 = model.t5
    blocks = t5.decoder.blocks

    def stack(fn):
        return torch.stack([fn(b).to(dtype) for b in blocks]).contiguous()

    def w(dense):
        return dense.weight.T

    gated = cfg.is_gated_act
    return StackedDecoder(
        ln_self=stack(lambda b: b.ln_self.weight),
        # column concat is exact: each output column is computed on its own
        wqkv_self=stack(lambda b: torch.cat(
            [w(b.self_attn.q), w(b.self_attn.k), w(b.self_attn.v)], dim=-1)),
        wo_self=stack(lambda b: w(b.self_attn.o)),
        ln_cross=stack(lambda b: b.ln_cross.weight),
        wq_cross=stack(lambda b: w(b.cross_attn.q)),
        wk_cross=stack(lambda b: w(b.cross_attn.k)),
        wv_cross=stack(lambda b: w(b.cross_attn.v)),
        wo_cross=stack(lambda b: w(b.cross_attn.o)),
        ln_mlp=stack(lambda b: b.ln_mlp.weight),
        wi=None if gated else stack(lambda b: w(b.mlp.wi)),
        wi_0=stack(lambda b: w(b.mlp.wi_0)) if gated else None,
        wi_1=stack(lambda b: w(b.mlp.wi_1)) if gated else None,
        wo_mlp=stack(lambda b: w(b.mlp.wo)),
        final_ln=t5.decoder.final_ln.weight.detach().float().clone(),
        embedding=t5.shared.weight.detach().to(dtype).clone(),
        lm_head=None if cfg.tie_word_embeddings else w(t5.lm_head).to(dtype).contiguous(),
        relpos=t5.decoder.relpos.rel_embedding.weight.detach().float().clone(),
    )


def _rms(x, weight, eps: float, dtype):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * weight.to(dtype)


def _decode_relpos_rows(relpos: torch.Tensor, cfg: T5Config, steps: int) -> torch.Tensor:
    """(steps, h, steps) self-attention bias rows: row[s] is the bias of query
    position s against key positions 0..steps-1 (bidirectional=False)."""
    pos = torch.arange(steps)
    buckets = relative_position_bucket(
        pos[None, :] - pos[:, None], bidirectional=False,
        num_buckets=cfg.relative_attention_num_buckets,
        max_distance=cfg.relative_attention_max_distance)
    values = relpos[buckets.to(relpos.device)]            # (q, k, h)
    return values.permute(0, 2, 1).contiguous()           # (steps, h, steps)


def _quantize(x: torch.Tensor, dim: int) -> Quantized:
    """Symmetric int8 with an exact per-channel amax scale over ``dim``;
    torch.round rounds half to even, as jnp.round does."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return Quantized(q.to(torch.int8), scale)


def _quantize_kv(x: torch.Tensor) -> Quantized:
    """int8 over the key axis (minor), one scale per (l, b, h, d) channel."""
    return _quantize(x, -1)


class DecodeEngine:
    """Greedy FiD decode with stacked decoder weights.

    Usage::

        eng = DecodeEngine(model, max_length=50)
        tokens, cross_logits = eng.generate(input_ids, mask)
    """

    def __init__(self, model: FiDT5, max_length: int = 50,
                 collect_cross_scores: bool = False,
                 kv_dtype: str = "native",        # "native" | "int8"
                 weights_dtype: str = "native",   # "native"
                 fused_cross: bool = False,       # CUDA int8 cross-attention kernel
                 chunk_size: Optional[int] = None):
        cfg = model.config
        if not engine_supported(cfg):
            raise ValueError(
                "DecodeEngine requires homogeneous decoder layers "
                "(cross_attention_stride unset)")
        if kv_dtype == "int8mxu":
            raise NotImplementedError("kv_dtype='int8mxu' is not ported yet (ROADMAP item 3)")
        if kv_dtype not in ("native", "int8"):
            raise ValueError(f"kv_dtype must be native|int8, got {kv_dtype!r}")
        if weights_dtype != "native":
            raise NotImplementedError(
                f"weights_dtype={weights_dtype!r} (int8 weights) is not ported "
                "yet (ROADMAP item 3)")
        steps = max_length - 1
        # one chunk covering every step is the unchunked program
        if chunk_size is not None and chunk_size < steps:
            raise NotImplementedError(
                "chunked early-exit decode (chunk_size) is not ported yet "
                "(ROADMAP item 3)")
        device = model_device(model)
        if fused_cross and device.type == "cuda" and (
                kv_dtype != "int8" or cfg.multiquery_cross_attention):
            raise ValueError(
                "fused_cross runs the int8 kernel, which needs kv_dtype='int8' "
                "and one K/V head per query head (no multiquery)")
        self.model = model
        self.cfg = cfg
        self.max_length = max_length
        self.steps = steps
        self.collect = collect_cross_scores
        self.kv_dtype = kv_dtype
        self.fused_cross = fused_cross
        self.dtype = model.dtype
        self.sd = stack_decoder_params(model, self.dtype)

    # ---- setup: encoder + hoisted state ------------------------------------

    def _project_cross_kv(self, enc: torch.Tensor):
        """enc (B,K,H) → cross K/V stacked (l,B,hk,d,K), key axis minor."""
        d = self.cfg.d_kv
        B, K, _ = enc.shape

        def proj(w):
            kv = torch.einsum("bkh,lhe->lbke", enc, w)           # (l,B,K,hk*d)
            kv = kv.reshape(kv.shape[0], B, K, kv.shape[-1] // d, d)
            return kv.permute(0, 1, 3, 4, 2).contiguous()       # (l,B,hk,d,K)

        ck, cv = proj(self.sd.wk_cross), proj(self.sd.wv_cross)
        if self.kv_dtype == "int8":
            return _quantize_kv(ck), _quantize_kv(cv)
        return ck, cv

    # ---- one decode step ---------------------------------------------------

    def _cross_attention(self, i, qc, ck, cv, cross_bias, collect):
        """One layer's cross-attention for one step. qc (B,h,d) → (out (B,h,d)
        in dtype, logits (B,h,K) f32 | None)."""
        dtype = self.dtype
        int8 = self.kv_dtype == "int8"
        ckv = ck.values[i] if int8 else ck[i]      # (B, hk, d, K)
        cvv = cv.values[i] if int8 else cv[i]
        h = qc.shape[1]
        hk = ckv.shape[1]
        if self.fused_cross and int8 and hk == h and not collect:
            # score capture (the first step) keeps the einsum path, since the
            # kernel does not expose the logits
            co = fused_decode_cross_attention(qc, ckv, ck.scale[i], cvv, cv.scale[i],
                                              cross_bias)
            return co.to(dtype), None
        if hk == h:
            if int8:
                # fold the per-(b,h,d) K scale into q: q·(k_i8·s) = (q·s)·k_i8
                qq = (qc.float() * ck.scale[i][..., 0]).to(dtype)
            else:
                qq = qc
            cl = torch.einsum("bhd,bhdk->bhk", qq, ckv.to(dtype)).float()
        else:  # multiquery: one shared K/V head broadcast over the q heads
            kd = ckv[:, 0].to(dtype)                   # (B, d, K)
            if int8:
                qq = (qc.float() * ck.scale[i][:, 0, :, 0][:, None]).to(dtype)
            else:
                qq = qc
            cl = torch.einsum("bhd,bdk->bhk", qq, kd).float()
        cl = cl + cross_bias                            # (B,1,K) broadcast
        cp = torch.softmax(cl, dim=-1).to(dtype)
        if hk == h:
            co = torch.einsum("bhk,bhdk->bhd", cp, cvv.to(dtype))
            if int8:
                co = (co.float() * cv.scale[i][..., 0]).to(dtype)
        else:
            co = torch.einsum("bhk,bdk->bhd", cp, cvv[:, 0].to(dtype))
            if int8:
                co = (co.float() * cv.scale[i][:, 0, :, 0][:, None]).to(dtype)
        return co, (cl if collect else None)

    def _mlp(self, i, x):
        sd, cfg, dtype = self.sd, self.cfg, self.dtype
        xn = _rms(x, sd.ln_mlp[i], cfg.layer_norm_epsilon, dtype)
        if sd.wi is not None:
            act = activation(cfg.feed_forward_proj)(xn @ sd.wi[i])
        else:
            gact = activation(cfg.feed_forward_proj.removeprefix("gated-"))
            act = gact(xn @ sd.wi_0[i]) * (xn @ sd.wi_1[i])
        return x + act @ sd.wo_mlp[i]

    def _one_step(self, tok, step: int, state, collect: bool):
        """tok (B,) → (logits (B, V), cross logits (B, l, h, K) | None)."""
        cfg, sd, dtype = self.cfg, self.sd, self.dtype
        caches, (ck, cv), cross_bias, relpos_rows = state
        sk, sv = caches
        h, d = cfg.num_heads, cfg.d_kv
        eps = cfg.layer_norm_epsilon
        x = sd.embedding[tok]                                  # (B, H)
        B = x.shape[0]
        # positions after `step` are not written yet: additive NEG_INF
        self_bias = relpos_rows[step].clone()                  # (h, S)
        self_bias[:, step + 1:] = NEG_INF
        cross_logits = []
        for i in range(cfg.num_decoder_layers):
            # --- self-attention: cache holds steps 0..step-1; this step fresh
            xn = _rms(x, sd.ln_self[i], eps, dtype)
            qkv = (xn @ sd.wqkv_self[i]).reshape(B, 3, h, d)
            q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]
            logits = torch.einsum("bhd,bhds->bhs", q, sk[i]).float()
            logits[..., step] = (q * k_new).sum(dim=-1).float()
            probs = torch.softmax(logits + self_bias, dim=-1).to(dtype)
            out = torch.einsum("bhs,bhds->bhd", probs, sv[i])
            out = out + probs[..., step:step + 1] * v_new
            sk[i, ..., step] = k_new
            sv[i, ..., step] = v_new
            x = x + out.reshape(B, h * d) @ sd.wo_self[i]

            # --- cross-attention against the hoisted K/V
            xn = _rms(x, sd.ln_cross[i], eps, dtype)
            qc = (xn @ sd.wq_cross[i]).reshape(B, h, d)
            co, cl = self._cross_attention(i, qc, ck, cv, cross_bias, collect)
            if collect:
                cross_logits.append(cl)
            x = x + co.reshape(B, h * d) @ sd.wo_cross[i]
            x = self._mlp(i, x)

        x = _rms(x, sd.final_ln, eps, dtype)
        if sd.lm_head is not None:
            logits = x @ sd.lm_head
        else:
            logits = (x * (cfg.d_model ** -0.5)) @ sd.embedding.T
        xl = torch.stack(cross_logits, dim=1) if collect else None
        return logits, xl

    # ---- generate ----------------------------------------------------------

    @torch.inference_mode()
    def generate(self, input_ids: torch.Tensor, mask: torch.Tensor):
        """((B,N,L) ids, (B,N,L) bool mask) on the model's device →
        (tokens (B, max_length-1) int32, first-step cross logits
        (B, l, h, N·L) f32 | None)."""
        cfg = self.cfg
        enc, enc_mask = self.model.encode_passages(input_ids, mask)
        B = enc.shape[0]
        zero = torch.zeros((), dtype=torch.float32, device=enc.device)
        cross_bias = torch.where(enc_mask, zero, NEG_INF)[:, None, :]  # (B,1,K)
        shape = (cfg.num_decoder_layers, B, cfg.num_heads, cfg.d_kv, self.steps)
        caches = (torch.zeros(shape, dtype=self.dtype, device=enc.device),
                  torch.zeros(shape, dtype=self.dtype, device=enc.device))
        state = (caches, self._project_cross_kv(enc), cross_bias,
                 _decode_relpos_rows(self.sd.relpos, cfg, self.steps))

        start = torch.full((B,), cfg.decoder_start_token_id, dtype=torch.long,
                           device=enc.device)
        logits0, xl0 = self._one_step(start, 0, state, self.collect)
        tok = logits0.argmax(dim=-1)
        done = tok == cfg.eos_token_id
        tokens = [tok]
        for step in range(1, self.steps):
            logits, _ = self._one_step(tok, step, state, False)
            tok = logits.argmax(dim=-1)
            tok = torch.where(done, torch.full_like(tok, cfg.pad_token_id), tok)
            done = done | (tok == cfg.eos_token_id)
            tokens.append(tok)
        return torch.stack(tokens, dim=1).to(torch.int32), xl0


def make_engine_generate_fn(model: FiDT5, max_length: int = 50,
                            collect_cross_scores: bool = False,
                            kv_dtype: str = "native",
                            weights_dtype: str = "native",
                            fused_cross: bool = False,
                            chunk_size: Optional[int] = None):
    """(input_ids, mask) → (tokens, cross_logits | None) through the engine."""
    return DecodeEngine(model, max_length=max_length,
                        collect_cross_scores=collect_cross_scores,
                        kv_dtype=kv_dtype, weights_dtype=weights_dtype,
                        fused_cross=fused_cross, chunk_size=chunk_size).generate
