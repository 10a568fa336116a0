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
self-attention cache is ``(layers, B, h, d, S)`` (``self_cache_layout="ds"``)
or ``(layers, B, h, S, d)`` (``"sd"``). The cache is written in place, one
column per layer per step, after that layer has read it.

``kv_dtype="int8"`` stores the cross K/V as symmetric int8 with one scale per
(layer, row, head, channel). With ``fused_cross=True`` each step after the
score-capturing one runs cross-attention through the CUDA kernel
(ops/decode_cross_attn.py), which reads the int8 bytes directly; otherwise
the same int8 values go through plain dequantizing einsums.
``kv_dtype="int8mxu"`` keeps those K/V and also quantizes q (K scale folded
in) and the attention probabilities (one scale per row), so both products
take int8 operands; they are exact integer sums, as XLA's int32 dots are
(:func:`_int8_contract`). ``weights_dtype="int8"`` quantizes every per-step
matmul weight per output channel and the embedding per row (weight-only: the
activations stay in the compute dtype); the cross K/V projections and the
layer norms stay in the compute dtype.

The token loop is a prefill step followed by fixed-shape chunks. Step 0 runs
on its own because it captures the cross-attention scores; each chunk of
``n`` steps starting at step ``s`` then reads and writes the batch's buffers
in place. On the card each chunk is a CUDA graph, captured once per (batch
shape, s, n) and replayed for every later batch of that shape after its
prefill is copied into the buffers; on CPU tensors the same chunk runs
eagerly. Unchunked decode is one chunk of ``steps - 1`` steps; with
``chunk_size`` the host reads the all-rows-done flag once per chunk and stops
early (the JAX engine's ``_generate_chunked``).
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from lako_tpu_torch.core.config import T5Config
from lako_tpu_torch.core.logging import get_logger
from lako_tpu_torch.models.t5.layers import (
    NEG_INF,
    activation,
    relative_position_bucket,
)
from lako_tpu_torch.models.t5.model import FiDT5, model_device
from lako_tpu_torch.ops.decode_cross_attn import fused_decode_cross_attention

# The chunking cost model, from one run of chip_smoke.py's graphed decode at
# t5-large width (B=8, N=2, L=130, bf16, int8 K/V through K3) on an NVIDIA
# H100 80GB HBM3 at a 700 W power limit: the host's cost of one more chunk
# (a graph replay and the all-done read) beyond its device time, 0.2341 ms,
# and one step's device time, 3.3352 ms (PERF.md lists every reading). At
# these costs even chunk_size=1 adds at most 7%, so the warning below, the
# JAX engine's guard, does not fire on this card.
CHUNK_DISPATCH_COST_S = 0.00023
CHUNK_PER_STEP_COST_S = 0.0033

# A float32 sum of up to this many int8·int8 products is an exact integer:
# 127² · 1040 < 2^24.
EXACT_INT8_TERMS = 1040


def chunking_worst_case_overhead(steps: int, chunk_size: int) -> float:
    """Fractional slowdown vs unchunked if every row runs to max_length:
    (n_chunks - 1) dispatches over the unchunked step cost."""
    n_chunks = -(-steps // chunk_size)
    return ((n_chunks - 1) * CHUNK_DISPATCH_COST_S
            / max(steps * CHUNK_PER_STEP_COST_S, 1e-9))


class Quantized(NamedTuple):
    values: torch.Tensor  # int8
    scale: torch.Tensor   # f32, size 1 on the quantized axis


Weight = Union[torch.Tensor, Quantized]


class StackedDecoder(NamedTuple):
    """Decoder weights stacked on a leading (num_decoder_layers,) axis; matmul
    weights are ``(in, out)`` so a step computes ``x @ w``. Under int8
    weights the per-step matmul weights, the embedding and an untied lm_head
    are :class:`Quantized`."""

    ln_self: torch.Tensor      # (l, H)
    wqkv_self: Weight          # (l, H, 3*h*d): q/k/v fused into one matmul
    wo_self: Weight            # (l, h*d, H)
    ln_cross: torch.Tensor
    wq_cross: Weight
    wk_cross: torch.Tensor     # (l, H, hk*d)
    wv_cross: torch.Tensor
    wo_cross: Weight
    ln_mlp: torch.Tensor
    wi: Optional[Weight]       # (l, H, F): relu/simple act
    wi_0: Optional[Weight]     # gated act pair
    wi_1: Optional[Weight]
    wo_mlp: Weight             # (l, F, H)
    final_ln: torch.Tensor     # (H,) f32
    embedding: Weight          # (V, H)
    lm_head: Optional[Weight]  # (H, V); None when tie_word_embeddings
    relpos: torch.Tensor       # (buckets, h) f32


def engine_supported(cfg: T5Config) -> bool:
    """True when every decoder layer cross-attends (no FiDO stride)."""
    return all(cfg.has_cross_attention(i) for i in range(cfg.num_decoder_layers))


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


def _quantize_weight(w: torch.Tensor) -> Quantized:
    """int8 per OUTPUT channel for ``(..., in, out)`` matmul weights."""
    return _quantize(w, -2)


def _quantize_rows(e: torch.Tensor) -> Quantized:
    """int8 per ROW of the (V, H) embedding: it serves the token lookup and
    the tied logits matmul ``x @ E.T == (x @ E_i8.T) * scale.T``."""
    return _quantize(e, -1)


def _layer(w: Optional[Weight], i: int) -> Optional[Weight]:
    """Layer ``i`` of a stacked weight."""
    if w is None:
        return None
    if isinstance(w, Quantized):
        return Quantized(w.values[i], w.scale[i])
    return w[i]


def _take_embedding(emb: Weight, tok: torch.Tensor, dtype) -> torch.Tensor:
    """Token lookup for a native or row-quantized embedding table."""
    if isinstance(emb, Quantized):
        return (emb.values[tok].float() * emb.scale[tok]).to(dtype)
    return emb[tok]


def _mm(x: torch.Tensor, w: Weight, dtype) -> torch.Tensor:
    """x @ w for native or int8 weights. Weight-only: the int8 tensor is
    converted to the compute dtype, the f32 scale applies to the product."""
    if isinstance(w, Quantized):
        y = x @ w.values.to(dtype)
        return (y.float() * w.scale).to(dtype)
    return x @ w


def _logits(sd: StackedDecoder, cfg: T5Config, x: torch.Tensor, dtype) -> torch.Tensor:
    """Final-norm hidden (..., H) → vocabulary logits (..., V)."""
    if sd.lm_head is not None:
        return _mm(x, sd.lm_head, dtype)
    x = x * (cfg.d_model ** -0.5)
    if isinstance(sd.embedding, Quantized):
        return (x @ sd.embedding.values.T.to(dtype)).float() * sd.embedding.scale.T
    return x @ sd.embedding.T


@torch.no_grad()
def stack_decoder_params(model: FiDT5, dtype: torch.dtype,
                         weights_dtype: str = "native") -> StackedDecoder:
    """Extract and stack the decoder weights, cast to the compute dtype; with
    ``weights_dtype="int8"`` the per-step matmul weights are quantized."""
    cfg = model.config
    t5 = model.t5
    blocks = t5.decoder.blocks
    int8 = weights_dtype == "int8"

    def stack(fn):
        return torch.stack([fn(b).to(dtype) for b in blocks]).contiguous()

    def qstack(fn):
        w = stack(fn)
        return _quantize_weight(w) if int8 else w

    def w(dense):
        return dense.weight.T

    gated = cfg.is_gated_act
    emb = t5.shared.weight.detach().to(dtype).clone()
    lm_head = None
    if not cfg.tie_word_embeddings:
        lm_head = w(t5.lm_head).to(dtype).contiguous()
        lm_head = _quantize_weight(lm_head) if int8 else lm_head
    return StackedDecoder(
        ln_self=stack(lambda b: b.ln_self.weight),
        # column concat is exact: each output column is computed on its own
        wqkv_self=qstack(lambda b: torch.cat(
            [w(b.self_attn.q), w(b.self_attn.k), w(b.self_attn.v)], dim=-1)),
        wo_self=qstack(lambda b: w(b.self_attn.o)),
        ln_cross=stack(lambda b: b.ln_cross.weight),
        wq_cross=qstack(lambda b: w(b.cross_attn.q)),
        wk_cross=stack(lambda b: w(b.cross_attn.k)),
        wv_cross=stack(lambda b: w(b.cross_attn.v)),
        wo_cross=qstack(lambda b: w(b.cross_attn.o)),
        ln_mlp=stack(lambda b: b.ln_mlp.weight),
        wi=None if gated else qstack(lambda b: w(b.mlp.wi)),
        wi_0=qstack(lambda b: w(b.mlp.wi_0)) if gated else None,
        wi_1=qstack(lambda b: w(b.mlp.wi_1)) if gated else None,
        wo_mlp=qstack(lambda b: w(b.mlp.wo)),
        final_ln=t5.decoder.final_ln.weight.detach().float().clone(),
        embedding=_quantize_rows(emb) if int8 else emb,
        lm_head=lm_head,
        relpos=t5.decoder.relpos.rel_embedding.weight.detach().float().clone(),
    )


def _rms(x, weight, eps: float, dtype):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * weight.to(dtype)


def _mlp(sd: StackedDecoder, cfg: T5Config, i: int, x, dtype):
    xn = _rms(x, sd.ln_mlp[i], cfg.layer_norm_epsilon, dtype)
    if sd.wi is not None:
        act = activation(cfg.feed_forward_proj)(_mm(xn, _layer(sd.wi, i), dtype))
    else:
        gact = activation(cfg.feed_forward_proj.removeprefix("gated-"))
        act = gact(_mm(xn, _layer(sd.wi_0, i), dtype)) * _mm(xn, _layer(sd.wi_1, i), dtype)
    return x + _mm(act, _layer(sd.wo_mlp, i), dtype)


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


def _int8_contract(equation: str, a: torch.Tensor, b: torch.Tensor,
                   axis_a: int, axis_b: int) -> torch.Tensor:
    """``einsum(equation, a, b)`` of int8 tensors contracting ``a``'s axis
    ``axis_a`` with ``b``'s ``axis_b``, as the exact int32 result. The
    product runs in float32 (no int32 matmul exists on the card) over pieces
    of at most EXACT_INT8_TERMS terms, where every partial sum in any order
    is an exact integer; the pieces add in int32."""
    n = a.shape[axis_a]
    total = None
    for k0 in range(0, n, EXACT_INT8_TERMS):
        m = min(EXACT_INT8_TERMS, n - k0)
        part = torch.einsum(equation, a.narrow(axis_a, k0, m).float(),
                            b.narrow(axis_b, k0, m).float()).to(torch.int32)
        total = part if total is None else total + part
    return total


def _int8mxu_cross(qc, ck: Quantized, cv: Quantized, cross_bias, dtype):
    """One layer's cross-attention on int8 operands (the JAX engine's
    ``int8mxu`` branch): q·s_K quantized per row, int8·int8 logits, f32
    softmax, probabilities quantized per row, int8·int8 p·V."""
    qi, q_scale = _quantize(qc.float() * ck.scale[..., 0], -1)            # (B,h,d)
    cl = _int8_contract("bhd,bhdk->bhk", qi, ck.values, 2, 2)
    cl = cl.float() * q_scale + cross_bias
    cp = torch.softmax(cl, dim=-1)                                        # (B,h,K) f32
    pi, p_scale = _quantize(cp, -1)
    co = _int8_contract("bhk,bhdk->bhd", pi, cv.values, 2, 3)
    return (co.float() * p_scale * cv.scale[..., 0]).to(dtype)


class _Batch:
    """The buffers the token loop of one batch shape reads and writes in
    place: a captured chunk replays on them for every batch of that shape."""

    def __init__(self, caches, cross_kv, cross_bias, tok, done):
        self.caches = caches          # (sk, sv)
        self.cross_kv = cross_kv      # (ck, cv), native or Quantized
        self.cross_bias = cross_bias  # (B, 1, K) f32
        self.tok = tok                # (B,) the previous step's tokens
        self.done = done              # (B,) bool
        self.chunks: Dict[Tuple[int, int], "_Chunk"] = {}

    def load(self, cross_kv, cross_bias) -> None:
        """Start a batch: empty caches, this batch's cross K/V and key mask."""
        for c in self.caches:
            c.zero_()
        for mine, new in zip(self.cross_kv, cross_kv):
            if isinstance(new, Quantized):
                mine.values.copy_(new.values)
                mine.scale.copy_(new.scale)
            else:
                mine.copy_(new)
        self.cross_bias.copy_(cross_bias)


class _Chunk(NamedTuple):
    """A captured chunk: its graph and the outputs it writes."""

    graph: "torch.cuda.CUDAGraph"
    tokens: torch.Tensor      # (B, n)
    all_done: torch.Tensor    # () bool


class DecodeEngine:
    """Greedy FiD decode with stacked decoder weights.

    Usage::

        eng = DecodeEngine(model, max_length=50)
        tokens, cross_logits = eng.generate(input_ids, mask)

    ``cuda_graphs=False`` runs the chunks eagerly on the card too, for
    comparing graphs with the eager loop; the default replays graphs, and a
    capture that fails raises.
    """

    def __init__(self, model: FiDT5, max_length: int = 50,
                 collect_cross_scores: bool = False,
                 kv_dtype: str = "native",        # "native" | "int8" | "int8mxu"
                 weights_dtype: str = "native",   # "native" | "int8"
                 fused_cross: bool = False,       # CUDA int8 cross-attention kernel
                 chunk_size: Optional[int] = None,
                 self_cache_layout: str = "ds",   # "ds" (B,h,d,S) | "sd" (B,h,S,d)
                 cuda_graphs: bool = True):
        cfg = model.config
        if not engine_supported(cfg):
            raise ValueError(
                "DecodeEngine requires homogeneous decoder layers "
                "(cross_attention_stride unset); use models.t5.decode instead")
        if kv_dtype not in ("native", "int8", "int8mxu"):
            raise ValueError(f"kv_dtype must be native|int8|int8mxu, got {kv_dtype!r}")
        if weights_dtype not in ("native", "int8"):
            raise ValueError(f"weights_dtype must be native|int8, got {weights_dtype!r}")
        if self_cache_layout not in ("ds", "sd"):
            raise ValueError(f"self_cache_layout must be ds|sd, got {self_cache_layout!r}")
        device = model_device(model)
        if fused_cross and device.type == "cuda" and (
                kv_dtype != "int8" or cfg.multiquery_cross_attention):
            raise ValueError(
                "fused_cross runs the int8 kernel, which needs kv_dtype='int8' "
                "and one K/V head per query head (no multiquery)")
        self.model = model
        self.cfg = cfg
        self.max_length = max_length
        self.steps = max_length - 1
        self.collect = collect_cross_scores
        self.kv_dtype = kv_dtype
        self.weights_dtype = weights_dtype
        self.fused_cross = fused_cross
        self.self_cache_layout = self_cache_layout
        # one chunk that covers every step is the unchunked program
        if chunk_size is not None and chunk_size >= self.steps:
            chunk_size = None
        if chunk_size is not None:
            over = chunking_worst_case_overhead(self.steps, chunk_size)
            if over > 0.25:
                get_logger().warning(
                    "decode chunk_size=%d adds up to %d extra chunk dispatches "
                    "(~%.2f ms each, measured on an H100) if answers run to "
                    "max_length=%d: a worst-case +%.0f%% vs unchunked. "
                    "Chunking only pays when most answers finish within "
                    "~%d tokens; otherwise disable it.",
                    chunk_size, -(-self.steps // chunk_size) - 1,
                    CHUNK_DISPATCH_COST_S * 1e3, max_length, 100 * over, chunk_size)
        self.chunk_size = chunk_size
        self.graphed = cuda_graphs and device.type == "cuda"
        self.dtype = model.dtype
        self.sd = stack_decoder_params(model, self.dtype, weights_dtype)
        self.relpos_rows = _decode_relpos_rows(self.sd.relpos, cfg, self.steps)
        self._batches: Dict[Tuple[int, int], _Batch] = {}
        self._warmed = False
        # the token loop writes the batch shape's buffers in place: one
        # generate call at a time
        self._lock = threading.Lock()
        self.last_chunks = 0          # chunks the last generate call ran

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
        if self.kv_dtype in ("int8", "int8mxu"):
            return _quantize_kv(ck), _quantize_kv(cv)
        return ck, cv

    def _batch(self, cross_kv, cross_bias) -> _Batch:
        """The buffers of this batch shape, loaded with this batch."""
        cfg = self.cfg
        B, K = cross_bias.shape[0], cross_bias.shape[-1]
        st = self._batches.get((B, K))
        if st is None:
            l, h, d, S = cfg.num_decoder_layers, cfg.num_heads, cfg.d_kv, self.steps
            shape = (l, B, h, d, S) if self.self_cache_layout == "ds" else (l, B, h, S, d)
            dev = cross_bias.device
            caches = tuple(torch.zeros(shape, dtype=self.dtype, device=dev) for _ in range(2))
            st = _Batch(caches,
                        tuple(Quantized(torch.empty_like(c.values), torch.empty_like(c.scale))
                              if isinstance(c, Quantized) else torch.empty_like(c)
                              for c in cross_kv),
                        torch.empty_like(cross_bias),
                        torch.zeros(B, dtype=torch.long, device=dev),
                        torch.zeros(B, dtype=torch.bool, device=dev))
            self._batches[B, K] = st
        st.load(cross_kv, cross_bias)
        return st

    # ---- one decode step ---------------------------------------------------

    def _cross_attention(self, i, qc, st: _Batch, collect):
        """One layer's cross-attention for one step. qc (B,h,d) → (out (B,h,d)
        in dtype, logits (B,h,K) f32 | None)."""
        dtype = self.dtype
        ck, cv = (_layer(c, i) for c in st.cross_kv)      # (B, hk, d, K)
        cross_bias = st.cross_bias
        int8 = self.kv_dtype in ("int8", "int8mxu")
        ckv = ck.values if int8 else ck
        cvv = cv.values if int8 else cv
        h = qc.shape[1]
        hk = ckv.shape[1]
        if self.kv_dtype == "int8mxu" and hk == h and not collect:
            return _int8mxu_cross(qc, ck, cv, cross_bias, dtype), None
        if self.fused_cross and int8 and hk == h and not collect:
            # score capture (the first step) keeps the einsum path, since the
            # kernel does not expose the logits
            co = fused_decode_cross_attention(qc, ckv, ck.scale, cvv, cv.scale, cross_bias)
            return co.to(dtype), None
        if hk == h:
            if int8:
                # fold the per-(b,h,d) K scale into q: q·(k_i8·s) = (q·s)·k_i8
                qq = (qc.float() * ck.scale[..., 0]).to(dtype)
            else:
                qq = qc
            cl = torch.einsum("bhd,bhdk->bhk", qq, ckv.to(dtype)).float()
        else:  # multiquery: one shared K/V head broadcast over the q heads
            kd = ckv[:, 0].to(dtype)                   # (B, d, K)
            if int8:
                qq = (qc.float() * ck.scale[:, 0, :, 0][:, None]).to(dtype)
            else:
                qq = qc
            cl = torch.einsum("bhd,bdk->bhk", qq, kd).float()
        cl = cl + cross_bias                            # (B,1,K) broadcast
        cp = torch.softmax(cl, dim=-1).to(dtype)
        if hk == h:
            co = torch.einsum("bhk,bhdk->bhd", cp, cvv.to(dtype))
            if int8:
                co = (co.float() * cv.scale[..., 0]).to(dtype)
        else:
            co = torch.einsum("bhk,bdk->bhd", cp, cvv[:, 0].to(dtype))
            if int8:
                co = (co.float() * cv.scale[:, 0, :, 0][:, None]).to(dtype)
        return co, (cl if collect else None)

    def _one_step(self, tok, step: int, st: _Batch, collect: bool):
        """tok (B,) → (logits (B, V), cross logits (B, l, h, K) | None)."""
        cfg, sd, dtype = self.cfg, self.sd, self.dtype
        sk, sv = st.caches
        h, d = cfg.num_heads, cfg.d_kv
        eps = cfg.layer_norm_epsilon
        ds = self.self_cache_layout == "ds"
        x = _take_embedding(sd.embedding, tok, dtype)           # (B, H)
        B = x.shape[0]
        # positions after `step` are not written yet: additive NEG_INF
        self_bias = self.relpos_rows[step].clone()              # (h, S)
        self_bias[:, step + 1:] = NEG_INF
        cross_logits = []
        for i in range(cfg.num_decoder_layers):
            # --- self-attention: cache holds steps 0..step-1; this step fresh
            xn = _rms(x, sd.ln_self[i], eps, dtype)
            qkv = _mm(xn, _layer(sd.wqkv_self, i), dtype).reshape(B, 3, h, d)
            q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]
            if ds:
                logits = torch.einsum("bhd,bhds->bhs", q, sk[i]).float()
            else:
                logits = torch.einsum("bhd,bhsd->bhs", q, sk[i]).float()
            logits[..., step] = (q * k_new).sum(dim=-1).float()
            probs = torch.softmax(logits + self_bias, dim=-1).to(dtype)
            if ds:
                out = torch.einsum("bhs,bhds->bhd", probs, sv[i])
                sk[i, ..., step] = k_new
                sv[i, ..., step] = v_new
            else:
                out = torch.einsum("bhs,bhsd->bhd", probs, sv[i])
                sk[i, :, :, step] = k_new
                sv[i, :, :, step] = v_new
            out = out + probs[..., step:step + 1] * v_new
            x = x + _mm(out.reshape(B, h * d), _layer(sd.wo_self, i), dtype)

            # --- cross-attention against the hoisted K/V
            xn = _rms(x, sd.ln_cross[i], eps, dtype)
            qc = _mm(xn, _layer(sd.wq_cross, i), dtype).reshape(B, h, d)
            co, cl = self._cross_attention(i, qc, st, collect)
            if collect:
                cross_logits.append(cl)
            x = x + _mm(co.reshape(B, h * d), _layer(sd.wo_cross, i), dtype)
            x = _mlp(sd, cfg, i, x, dtype)

        x = _rms(x, sd.final_ln, eps, dtype)
        xl = torch.stack(cross_logits, dim=1) if collect else None
        return _logits(sd, cfg, x, dtype), xl

    # ---- the token loop ----------------------------------------------------

    def _run_chunk(self, st: _Batch, start: int, n: int):
        """Steps start..start+n-1 on the batch's buffers → (tokens (B, n),
        all rows done ())."""
        cfg = self.cfg
        pad = torch.full_like(st.tok, cfg.pad_token_id)
        columns = []
        for step in range(start, start + n):
            logits, _ = self._one_step(st.tok, step, st, False)
            tok = torch.where(st.done, pad, logits.argmax(dim=-1))
            st.done.logical_or_(tok == cfg.eos_token_id)
            st.tok.copy_(tok)
            columns.append(tok)
        return torch.stack(columns, dim=1), st.done.all()

    def _clear_column(self, st: _Batch, step: int) -> None:
        for c in st.caches:
            if self.self_cache_layout == "ds":
                c[..., step] = 0
            else:
                c[:, :, :, step] = 0

    def _capture(self, st: _Batch, start: int, n: int) -> _Chunk:
        """Capture the chunk (start, n) of this batch shape as a CUDA graph.
        Before the engine's first capture one step runs on a side stream
        (library handles, the kernel's first launch), and the cache column
        it wrote is cleared again. The kernel wrappers count the launches
        the capture records, once; a replay calls no wrapper."""
        device = st.tok.device
        if not self._warmed:
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                self._one_step(st.tok, start, st, False)
                self._clear_column(st, start)
            torch.cuda.current_stream(device).wait_stream(side)
            self._warmed = True
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            tokens, all_done = self._run_chunk(st, start, n)
        return _Chunk(graph, tokens, all_done)

    def _chunk(self, st: _Batch, start: int, n: int):
        if not self.graphed:
            return self._run_chunk(st, start, n)
        chunk = st.chunks.get((start, n))
        if chunk is None:
            chunk = st.chunks[start, n] = self._capture(st, start, n)
        chunk.graph.replay()
        return chunk.tokens, chunk.all_done

    @torch.inference_mode()
    def generate(self, input_ids: torch.Tensor, mask: torch.Tensor, chunked: bool = True):
        """((B,N,L) ids, (B,N,L) bool mask) on the model's device →
        (tokens (B, max_length-1) int32, first-step cross logits
        (B, l, h, N·L) f32 | None). ``chunked=False`` runs the full length
        as one chunk even when the engine has a ``chunk_size``."""
        with self._lock:
            return self._generate(input_ids, mask, self.chunk_size if chunked else None)

    def _generate(self, input_ids, mask, chunk_size):
        cfg = self.cfg
        enc, enc_mask = self.model.encode_passages(input_ids, mask)
        zero = torch.zeros((), dtype=torch.float32, device=enc.device)
        cross_bias = torch.where(enc_mask, zero, NEG_INF)[:, None, :]  # (B,1,K)
        st = self._batch(self._project_cross_kv(enc), cross_bias)

        start = torch.full_like(st.tok, cfg.decoder_start_token_id)
        logits0, xl0 = self._one_step(start, 0, st, self.collect)
        tok = logits0.argmax(dim=-1)
        st.tok.copy_(tok)
        torch.eq(tok, cfg.eos_token_id, out=st.done)
        columns = [tok[:, None]]
        step, chunk = 1, chunk_size or self.steps - 1
        self.last_chunks = 0
        while step < self.steps:
            n = min(chunk, self.steps - step)
            tokens, all_done = self._chunk(st, step, n)
            columns.append(tokens)
            step += n
            self.last_chunks += 1
            if chunk_size and bool(all_done):        # the host's one sync a chunk
                break
        if step < self.steps:                        # pad the early-exited output
            columns.append(torch.full((tok.shape[0], self.steps - step), cfg.pad_token_id,
                                      dtype=tok.dtype, device=tok.device))
        return torch.cat(columns, dim=1).to(torch.int32), xl0


def make_engine_generate_fn(model: FiDT5, max_length: int = 50,
                            collect_cross_scores: bool = False,
                            kv_dtype: str = "native",
                            weights_dtype: str = "native",
                            fused_cross: bool = False,
                            chunk_size: Optional[int] = None,
                            self_cache_layout: str = "ds"):
    """(input_ids, mask) → (tokens, cross_logits | None) through the engine."""
    return DecodeEngine(model, max_length=max_length,
                        collect_cross_scores=collect_cross_scores,
                        kv_dtype=kv_dtype, weights_dtype=weights_dtype,
                        fused_cross=fused_cross, chunk_size=chunk_size,
                        self_cache_layout=self_cache_layout).generate
