"""Plain float32 FiDO reader: the reference the FiDO cells are held to.

FiDO (de Jong et al., "FiDO: Fusion-in-Decoder optimized for stronger
performance and faster inference", arXiv 2212.08153, section 3) changes
FiD's decoder in two ways, read here as the program under test reads them:

- layer-sparse cross-attention: only every ``cross_attention_stride``-th
  decoder layer cross-attends, counted from the top, so the topmost layer
  always does (with 24 layers and stride 6: layers 5, 11, 17 and 23); the
  other layers are self-attention and MLP only, without a cross norm;
- multi-query cross-attention (``multiquery_cross_attention``): one K/V head
  of ``d_kv`` serves every query head; self-attention stays multi-head.

The backbone is T5 v1.1 as google/t5-v1_1-* define it where the config says
so: a gated MLP (``feed_forward_proj`` ``"gated-gelu"``, GELU in its tanh
form, HF's ``gelu_new``: ``act(x wi_0) * (x wi_1)``) and an untied
``lm_head`` without the ``d_model ** -0.5`` rescale; ``"relu"`` and tied
embeddings give the v1.0 reader of :mod:`benchmark.reference.t5`, whose
encoder, norms, relative positions and attention this module reuses.

Parameter names are the program's ``FiDT5`` ``state_dict`` names
(:func:`param_schema`); every product runs in float32 with TF32 off. Only
the forward is covered, without dropout. It imports nothing of the program
under test.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from benchmark.reference.t5 import NEG, T5Reference, _rms, no_tf32  # noqa: F401

Spec = Tuple[str, Tuple[int, ...], Optional[float]]


def has_cross(cfg: dict, layer: int) -> bool:
    """Whether decoder ``layer`` cross-attends: every stride-th layer from
    the top (FiDO keeps the topmost)."""
    stride = cfg.get("cross_attention_stride") or 1
    return (cfg["num_decoder_layers"] - 1 - layer) % stride == 0


def cross_layers(cfg: dict) -> List[int]:
    return [i for i in range(cfg["num_decoder_layers"]) if has_cross(cfg, i)]


def _act(cfg: dict):
    name = cfg["feed_forward_proj"].removeprefix("gated-")
    if name == "relu":
        return torch.relu
    if name in ("gelu", "gelu_new"):
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(f"no reference activation {name!r}")


def param_schema(cfg: dict) -> List[Spec]:
    """``(name, shape, init std)`` of every parameter, in module order; a
    std of None is a norm weight (ones). The T5 init: q ``(d_model·d_kv)^-0.5``,
    k and v ``d_model^-0.5`` (multi-query cross K/V ``(d_kv, d_model)``), o
    ``(h·d_kv)^-0.5``, wi / wi_0 / wi_1 ``d_model^-0.5``, wo ``d_ff^-0.5``,
    relative positions ``d_model^-0.5``, the shared embedding
    ``embedding_std``, an untied ``lm_head`` ``d_model^-0.5`` (its logits
    then have the scale of the tied, rescaled head at std 1)."""
    d, dkv, h, dff = cfg["d_model"], cfg["d_kv"], cfg["num_heads"], cfg["d_ff"]
    inner = h * dkv
    gated = cfg["feed_forward_proj"].startswith("gated-")
    out: List[Spec] = [("t5.shared.weight", (cfg["vocab_size"], d), cfg["embedding_std"])]

    def attn(prefix, kv_inner=inner):
        return [(f"{prefix}.q.weight", (inner, d), (d * dkv) ** -0.5),
                (f"{prefix}.k.weight", (kv_inner, d), d ** -0.5),
                (f"{prefix}.v.weight", (kv_inner, d), d ** -0.5),
                (f"{prefix}.o.weight", (d, inner), inner ** -0.5)]

    def mlp(prefix):
        wi = ([(f"{prefix}.wi_0.weight", (dff, d), d ** -0.5),
               (f"{prefix}.wi_1.weight", (dff, d), d ** -0.5)] if gated
              else [(f"{prefix}.wi.weight", (dff, d), d ** -0.5)])
        return wi + [(f"{prefix}.wo.weight", (d, dff), dff ** -0.5)]

    buckets = (cfg["relative_attention_num_buckets"], h)
    out.append(("t5.encoder.relpos.rel_embedding.weight", buckets, d ** -0.5))
    for i in range(cfg["num_layers"]):
        p = f"t5.encoder.block_{i}"
        out += [(f"{p}.ln_attn.weight", (d,), None), *attn(f"{p}.self_attn"),
                (f"{p}.ln_mlp.weight", (d,), None), *mlp(f"{p}.mlp")]
    out.append(("t5.encoder.final_ln.weight", (d,), None))
    out.append(("t5.decoder.relpos.rel_embedding.weight", buckets, d ** -0.5))
    cross_inner = dkv if cfg.get("multiquery_cross_attention") else inner
    for i in range(cfg["num_decoder_layers"]):
        p = f"t5.decoder.block_{i}"
        out += [(f"{p}.ln_self.weight", (d,), None), *attn(f"{p}.self_attn")]
        if has_cross(cfg, i):
            out += [(f"{p}.ln_cross.weight", (d,), None),
                    *attn(f"{p}.cross_attn", cross_inner)]
        out += [(f"{p}.ln_mlp.weight", (d,), None), *mlp(f"{p}.mlp")]
    out.append(("t5.decoder.final_ln.weight", (d,), None))
    if not cfg["tie_word_embeddings"]:
        out.append(("t5.lm_head.weight", (cfg["vocab_size"], d), d ** -0.5))
    return out


class FidoReference(T5Reference):
    """The float32 FiDO reader over one state_dict (tensors on one device),
    with :class:`T5Reference`'s rounding hooks (``operand``, ``product``)
    for the controls."""

    def _attn(self, prefix, x, kv, bias, site):
        p, h, dkv = self.p, self.h, self.dkv
        q = self._mm(x, p[f"{prefix}.q.weight"].T)
        k = self._mm(kv, p[f"{prefix}.k.weight"].T)
        v = self._mm(kv, p[f"{prefix}.v.weight"].T)
        hk = k.shape[-1] // dkv                   # 1 under multi-query attention

        def heads(t, n):
            return t.reshape(t.shape[0], t.shape[1], n, dkv).transpose(1, 2)

        q, k, v = heads(q, h), heads(k, hk), heads(v, hk)
        probs = torch.softmax(self._mm(q, k.transpose(-1, -2)) + bias, dim=-1)
        out = self._mm(probs, v).transpose(1, 2).reshape(x.shape[0], x.shape[1], h * dkv)
        return self._mm(out, p[f"{prefix}.o.weight"].T)

    def _mlp(self, prefix, x, site):
        p, act = self.p, _act(self.cfg)
        if f"{prefix}.wi.weight" in p:
            inner = act(self._mm(x, p[f"{prefix}.wi.weight"].T))
        else:
            inner = (act(self._mm(x, p[f"{prefix}.wi_0.weight"].T))
                     * self._mm(x, p[f"{prefix}.wi_1.weight"].T))
        return self._mm(inner, p[f"{prefix}.wo.weight"].T)

    def logits(self, ids: torch.Tensor, mask: torch.Tensor, dec_in: torch.Tensor
               ) -> torch.Tensor:
        """(B, N, L) passages and (B, T) decoder inputs → (B, T, V) logits,
        teacher-forced."""
        cfg, p, eps = self.cfg, self.p, self.eps
        B, N, L = ids.shape
        enc = self.encode(ids.reshape(B * N, L), mask.reshape(B * N, L)).reshape(B, N * L, -1)
        emask = mask.reshape(B, N * L)
        T = dec_in.shape[1]
        pos = torch.arange(T, device=ids.device)
        self_bias = self._bias("decoder", T, T, False) + torch.where(
            pos[None, :] <= pos[:, None], 0.0, NEG)
        cross_bias = torch.where(emask[:, None, None, :], 0.0, NEG)
        x = p["t5.shared.weight"][dec_in]
        for i in range(cfg["num_decoder_layers"]):
            b = f"t5.decoder.block_{i}"
            xn = _rms(x, p[f"{b}.ln_self.weight"], eps)
            x = x + self._attn(f"{b}.self_attn", xn, xn, self_bias, None)
            if has_cross(cfg, i):
                xn = _rms(x, p[f"{b}.ln_cross.weight"], eps)
                x = x + self._attn(f"{b}.cross_attn", xn, enc, cross_bias, None)
            x = x + self._mlp(f"{b}.mlp", _rms(x, p[f"{b}.ln_mlp.weight"], eps), None)
        x = _rms(x, p["t5.decoder.final_ln.weight"], eps)
        if cfg["tie_word_embeddings"]:
            return self._mm(x * cfg["d_model"] ** -0.5, p["t5.shared.weight"].T)
        return self._mm(x, p["t5.lm_head.weight"].T)
