"""Ancestry-indexed beam search on the stacked-weight decode engine.

Counterpart of lako_tpu/models/t5/beam_engine.py. The layer-unrolled beam
path (models/t5/beam.py) repeats the encoder states per beam and reorders
every layer's self-attention cache along the beam axis each step. This
engine instead keeps the self-KV cache **append-only per beam slot** and an
ancestry matrix ``A (B, K, S)``: ``A[b, k, s]`` names the slot whose cache
row holds step ``s`` of beam ``k``'s history. Each step every slot writes its
fresh K/V into its own row at ``step`` and sets ``A[:, :, step]`` to the
identity; after the selection only ``A`` is gathered along the beam axis.
Self-attention reads the ancestor path through a one-hot of ``A``, and the
cross-attention K/V are one copy per example: the query carries the beam
axis.

``self_attn_impl`` takes the JAX engine's six values (``allslots``,
``gather``, ``flat``, ``packed``, ``stepmajor``, ``fusedkv``) and validates
them as it does, but every value runs the ``allslots`` formulation: logits
against every slot, (B, h, d, K, S), the ancestor path selected by the
one-hot afterwards. The other five are other cache layouts or gather orders
of the same function, chosen on the TPU; none is measured on the card yet,
and each gives allslots' tokens.

``select_impl`` picks the top-2K selection over K·V candidates: ``topk``
over the whole width, or ``blockwise`` (:func:`blockwise_top_m`, exact with
the same tie order); ``auto`` takes blockwise when ``select_block`` divides
the vocabulary into at least 2 blocks. The search itself is
models/t5/beam.py's (``BeamSearch``).
"""

from __future__ import annotations

import torch

from lako_tpu_torch.models.t5.beam import BeamSearch, top_candidates
from lako_tpu_torch.models.t5.engine import (
    _decode_relpos_rows,
    _layer,
    _logits,
    _mlp,
    _mm,
    _rms,
    _take_embedding,
    engine_supported,
    stack_decoder_params,
)
from lako_tpu_torch.models.t5.layers import NEG_INF, top_k
from lako_tpu_torch.models.t5.model import FiDT5

SELF_ATTN_IMPLS = ("allslots", "gather", "flat", "packed", "stepmajor", "fusedkv")


def blockwise_top_m(logits: torch.Tensor, scores: torch.Tensor, m: int,
                    block: int = 251):
    """Exact top-m of ``(scores[:, :, None] + log_softmax(logits)).reshape(
    B, K*V)`` without a selection over the full K·V width.

    1. block maxes of the candidate scores;
    2. the top-m blocks by block max;
    3. the final top-m over only the m gathered blocks.

    If x is in the global top-m (ties counted by lower index), fewer than m
    elements beat it, and every block ranked above x's block holds a
    distinct element that beats x: x's block is among the top-m blocks. The
    gathered blocks are put back in ascending order, so the final
    selection's positional tie-break is the global index order.
    log_softmax is a per-(b, k) constant ``scores - logsumexp(logits)``,
    reduced blockwise as the JAX function does.

    Returns (top_scores (B, m) f32, top_idx (B, m) into K·V).
    """
    B, K, V = logits.shape
    if V % block:
        raise ValueError(f"block {block} must divide vocab {V}")
    G = V // block
    lx = logits.reshape(B, K, G, block)
    lf = lx.float()
    bmax = lf.amax(dim=-1)                                 # (B, K, G)
    rowmax = bmax.amax(dim=-1)                             # (B, K)
    se = torch.exp(lf - rowmax[:, :, None, None]).sum(dim=-1)
    lse = rowmax + torch.log(se.sum(dim=-1))               # (B, K)
    adj = scores - lse                                     # (B, K)
    cand_bmax = (bmax + adj[:, :, None]).reshape(B, K * G)
    _, blk = top_k(cand_bmax, m)                           # (B, m)
    blk, _ = torch.sort(blk, dim=-1)                       # ascending block order
    gathered = torch.gather(lx.reshape(B, K * G, block), 1,
                            blk[:, :, None].expand(-1, -1, block)).float()
    adj_g = torch.gather(adj, 1, blk // G)                 # (B, m)
    gcand = gathered + adj_g[:, :, None]
    ts, pos = top_k(gcand.reshape(B, m * block), m)
    src_blk = torch.gather(blk, 1, pos // block)
    return ts, src_blk * block + pos % block


class BeamEngine:
    """Beam-search FiD decode with stacked decoder weights and an
    append-only, ancestry-indexed self-KV cache.

    Usage::

        eng = BeamEngine(model, max_length=50, num_beams=4)
        tokens = eng.generate(input_ids, mask)   # (B, max_length-1) int32
    """

    def __init__(self, model: FiDT5, max_length: int = 50, num_beams: int = 4,
                 length_penalty: float = 1.0, self_attn_impl: str = "allslots",
                 select_impl: str = "auto", select_block: int = 251):
        cfg = model.config
        if not engine_supported(cfg):
            raise ValueError(
                "BeamEngine requires homogeneous decoder layers "
                "(cross_attention_stride unset); use models.t5.beam instead")
        if num_beams < 1:
            raise ValueError("num_beams must be >= 1")
        if self_attn_impl not in SELF_ATTN_IMPLS:
            raise ValueError(
                f"self_attn_impl must be allslots|gather|flat|packed"
                f"|stepmajor|fusedkv, got {self_attn_impl!r}")
        if select_impl not in ("auto", "topk", "blockwise"):
            raise ValueError(
                f"select_impl must be auto|topk|blockwise, got {select_impl!r}")
        if select_impl == "auto":
            # blockwise needs block | vocab; plain top-k when the vocab
            # does not factor (e.g. tiny test vocabularies)
            select_impl = ("blockwise"
                           if cfg.vocab_size % select_block == 0
                           and cfg.vocab_size // select_block >= 2 else "topk")
        elif select_impl == "blockwise":
            if cfg.vocab_size % select_block != 0:
                raise ValueError(
                    f"select_block={select_block} does not divide "
                    f"vocab_size={cfg.vocab_size}; pick a divisor or use "
                    "select_impl='topk'")
            if cfg.vocab_size // select_block < 2:
                raise ValueError(
                    f"select_block={select_block} leaves "
                    f"{cfg.vocab_size // select_block} block(s) of "
                    f"vocab_size={cfg.vocab_size}; blockwise selection "
                    "needs >= 2 blocks (use select_impl='topk')")
        self.model = model
        self.cfg = cfg
        self.max_length = max_length
        self.steps = steps = max_length - 1
        self.num_beams = num_beams
        self.length_penalty = float(length_penalty)
        self.self_attn_impl = self_attn_impl
        self.select_impl = select_impl
        self.select_block = select_block
        self.dtype = model.dtype
        self.sd = stack_decoder_params(model, self.dtype)
        self.relpos_rows = _decode_relpos_rows(self.sd.relpos, cfg, steps)

    # ---- setup -------------------------------------------------------------

    def _project_cross_kv(self, enc: torch.Tensor):
        """enc (B,Ke,H) → cross K/V stacked (l,B,hk,d,Ke), one copy per
        example: the beams share it through the query axis."""
        d = self.cfg.d_kv
        B, Ke, _ = enc.shape

        def proj(w):
            kv = torch.einsum("bkh,lhe->lbke", enc, w)
            kv = kv.reshape(kv.shape[0], B, Ke, kv.shape[-1] // d, d)
            return kv.permute(0, 1, 3, 4, 2).contiguous()

        return proj(self.sd.wk_cross), proj(self.sd.wv_cross)

    def _caches(self, B: int, device):
        """Zeroed self K/V caches, (l, B, h, d, K, S)."""
        cfg = self.cfg
        shape = (cfg.num_decoder_layers, B, cfg.num_heads, cfg.d_kv, self.num_beams,
                 self.steps)
        return tuple(torch.zeros(shape, dtype=self.dtype, device=device) for _ in range(2))

    # ---- one decode step over all beams ------------------------------------

    def _self_attention(self, q, k_new, v_new, sk, sv, step, self_pos_bias, onehot):
        """q, k_new, v_new (B, K, h, d); sk/sv this layer's caches (B, h, d,
        K, S); onehot (B, Kq, Kc, S) → (B, K, h, d)."""
        logits_all = torch.einsum("bqhd,bhdcs->bqchs", q, sk).float()
        logits = (logits_all * onehot[:, :, :, None, :]).sum(dim=2)     # (B,K,h,S)
        S = logits.shape[-1]
        pos = torch.arange(S, device=q.device)
        logit_now = (q * k_new).sum(dim=-1).float()                    # (B,K,h)
        logits = torch.where(pos == step, logit_now[..., None], logits)
        bias = torch.where(pos <= step, self_pos_bias,
                           torch.full_like(self_pos_bias, NEG_INF))  # (h, S)
        probs = torch.softmax(logits + bias, dim=-1).to(self.dtype)    # (B,K,h,S)
        pw = probs[:, :, None] * onehot[:, :, :, None, :].to(self.dtype)
        out = torch.einsum("bqchs,bhdcs->bqhd", pw, sv)
        return out + probs[..., step:step + 1] * v_new

    def _one_step(self, tok, step: int, caches, ancestry, cross_kv, cross_bias):
        """tok (B,K) → logits (B,K,V); ``ancestry`` names this step's writer
        (the identity at ``step``) already."""
        cfg, sd, dtype = self.cfg, self.sd, self.dtype
        eps = cfg.layer_norm_epsilon
        h, d = cfg.num_heads, cfg.d_kv
        B, K = tok.shape
        H = cfg.d_model
        sk, sv = caches
        ck, cv = cross_kv
        slots = torch.arange(K, device=tok.device)
        # positions > step select slot 0: the causal bias masks them
        onehot = (ancestry[:, :, None, :] == slots[:, None]).float()      # (B,Kq,Kc,S)
        self_pos_bias = self.relpos_rows[step]
        x = _take_embedding(sd.embedding, tok, dtype)                    # (B,K,H)
        for i in range(cfg.num_decoder_layers):
            xn = _rms(x.reshape(B * K, H), sd.ln_self[i], eps, dtype)
            qkv = _mm(xn, _layer(sd.wqkv_self, i), dtype).reshape(B, K, 3, h, d)
            q, k_new, v_new = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            out = self._self_attention(q, k_new, v_new, sk[i], sv[i], step, self_pos_bias,
                                       onehot)
            # append this step's K/V, each slot into its own row
            sk[i, ..., step] = k_new.permute(0, 2, 3, 1)
            sv[i, ..., step] = v_new.permute(0, 2, 3, 1)
            x = x + _mm(out.reshape(B * K, h * d), _layer(sd.wo_self, i),
                        dtype).reshape(B, K, H)

            # cross-attention: per-example K/V, the beam axis rides the query
            xn = _rms(x.reshape(B * K, H), sd.ln_cross[i], eps, dtype)
            qc = _mm(xn, _layer(sd.wq_cross, i), dtype).reshape(B, K, h, d)
            if ck.shape[2] == h:
                cl = torch.einsum("bqhd,bhdk->bqhk", qc, ck[i]).float()
            else:   # multiquery: one shared K/V head
                cl = torch.einsum("bqhd,bdk->bqhk", qc, ck[i][:, 0]).float()
            cp = torch.softmax(cl + cross_bias, dim=-1).to(dtype)        # bias (B,1,1,Ke)
            if ck.shape[2] == h:
                co = torch.einsum("bqhk,bhdk->bqhd", cp, cv[i])
            else:
                co = torch.einsum("bqhk,bdk->bqhd", cp, cv[i][:, 0])
            x = x + _mm(co.reshape(B * K, h * d), _layer(sd.wo_cross, i),
                        dtype).reshape(B, K, H)
            x = _mlp(sd, cfg, i, x.reshape(B * K, H), dtype).reshape(B, K, H)
        x = _rms(x, sd.final_ln, eps, dtype)
        return _logits(sd, cfg, x.reshape(B * K, H), dtype).reshape(B, K, -1)

    # ---- beam search loop --------------------------------------------------

    @torch.inference_mode()
    def generate(self, input_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """((B,N,L) ids, (B,N,L) mask) → tokens (B, max_length-1) int32,
        padded after the first EOS (models/t5/beam.py's output)."""
        cfg = self.cfg
        K, steps = self.num_beams, self.steps
        enc, enc_mask = self.model.encode_passages(input_ids, mask)
        B, dev = enc.shape[0], enc.device
        cross_kv = self._project_cross_kv(enc)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        cross_bias = torch.where(enc_mask, zero, NEG_INF)[:, None, None, :]
        caches = self._caches(B, dev)
        ancestry = torch.zeros((B, K, steps), dtype=torch.long, device=dev)
        identity = torch.arange(K, device=dev)[None, :].expand(B, K)
        search = BeamSearch(B, K, steps, self.length_penalty, cfg.eos_token_id,
                            cfg.pad_token_id, dev)
        prev = torch.full((B, K), cfg.decoder_start_token_id, dtype=torch.long, device=dev)
        for step in range(steps):
            ancestry[:, :, step] = identity      # this step's rows: their own slots
            logits = self._one_step(prev, step, caches, ancestry, cross_kv, cross_bias)
            if self.select_impl == "blockwise":
                top_scores, top_idx = blockwise_top_m(logits, search.scores, 2 * K,
                                                      block=self.select_block)
            else:
                top_scores, top_idx = top_candidates(logits, search.scores, 2 * K)
            live_beam, prev = search.advance(step, top_scores, top_idx, cfg.vocab_size)
            # the whole cache reorder: B·K·S indices
            ancestry = torch.gather(ancestry, 1, live_beam[:, :, None].expand(-1, -1, steps))
        return search.best()


def make_beam_engine_generate_fn(model: FiDT5, max_length: int = 50, num_beams: int = 4,
                                 length_penalty: float = 1.0,
                                 self_attn_impl: str = "allslots",
                                 select_impl: str = "auto"):
    """(input_ids, mask) → tokens (B, max_length-1) through the beam engine."""
    return BeamEngine(model, max_length=max_length, num_beams=num_beams,
                      length_penalty=length_penalty, self_attn_impl=self_attn_impl,
                      select_impl=select_impl).generate
