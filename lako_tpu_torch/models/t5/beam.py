"""Beam search for the FiD reader on the layer-unrolled path.

Counterpart of lako_tpu/models/t5/beam.py, with HF generate's semantics
(num_beams=k, length_penalty, early_stopping=False): at each step 2k
candidates are drawn; EOS candidates are banked into a finished pool, the
best k non-EOS candidates continue; at the end the live beams are banked too
and the best pooled hypothesis wins. The encoder states are repeated per
beam and the self-attention caches are reordered along the beam axis every
step. This is the beam path for FiDO decoders; models/t5/beam_engine.py is
the stacked-weight one.
"""

from __future__ import annotations

import torch

from lako_tpu_torch.models.t5.layers import top_k
from lako_tpu_torch.models.t5.model import FiDT5

NEG_INF = -1.0e7


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_softmax``'s formula over the last axis."""
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def gather_beams(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx[:, :, None...], axis=1)``: rows ``idx``
    (B, M) of x (B, K, ...) → (B, M, ...)."""
    index = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return torch.gather(x, 1, index)


class BeamSearch:
    """The search state of HF-style beam search over (B, K) beams: each
    ``advance`` takes the step's top-2K candidates and returns the beam each
    surviving hypothesis continues from."""

    def __init__(self, B: int, K: int, steps: int, length_penalty: float, eos: int,
                 pad: int, device):
        self.K, self.steps, self.lp, self.eos, self.pad = K, steps, length_penalty, eos, pad
        self.tokens = torch.full((B, K, steps), pad, dtype=torch.long, device=device)
        # beam 0 active, the others -inf so the first expansion comes from one beam
        self.scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=device)
        self.scores[:, 0] = 0.0
        self.fin_tokens = torch.full_like(self.tokens, pad)
        self.fin_scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=device)

    def advance(self, step: int, top_scores: torch.Tensor, top_idx: torch.Tensor,
                V: int):
        """top_scores/top_idx (B, 2K): the best candidates over K·V. Returns
        (live_beam (B, K), live_tok (B, K))."""
        src_beam = top_idx // V
        tok = top_idx % V
        is_eos = tok == self.eos

        # bank EOS candidates: the source beam's prefix with EOS at `step`;
        # the length's power is float32, as in the JAX search's loop
        length = torch.tensor(float(step + 1), device=top_scores.device) ** self.lp
        eos_scores = torch.where(is_eos, top_scores / length,
                                 torch.full_like(top_scores, NEG_INF))
        pool_scores = torch.cat([self.fin_scores, eos_scores], dim=1)
        eos_seq = gather_beams(self.tokens, src_beam)
        eos_seq[:, :, step] = self.eos
        pool_tokens = torch.cat([self.fin_tokens, eos_seq], dim=1)
        self.fin_scores, fin_idx = top_k(pool_scores, self.K)
        self.fin_tokens = gather_beams(pool_tokens, fin_idx)

        # continue with the best K non-EOS candidates
        cont_scores = torch.where(is_eos, torch.full_like(top_scores, NEG_INF), top_scores)
        self.scores, live_pos = top_k(cont_scores, self.K)
        live_beam = torch.gather(src_beam, 1, live_pos)
        live_tok = torch.gather(tok, 1, live_pos)
        self.tokens = gather_beams(self.tokens, live_beam)
        self.tokens[:, :, step] = live_tok
        return live_beam, live_tok

    def best(self) -> torch.Tensor:
        """Bank the live beams (length = steps) and return the best pooled
        hypothesis per row (B, steps) int32, padded after its first EOS."""
        # the JAX search takes this power in Python (float64), then divides in float32
        length = torch.tensor(float(self.steps) ** self.lp, device=self.scores.device)
        pool_scores = torch.cat([self.fin_scores, self.scores / length], dim=1)
        pool_tokens = torch.cat([self.fin_tokens, self.tokens], dim=1)
        best = pool_scores.argmax(dim=1)
        out = gather_beams(pool_tokens, best[:, None])[:, 0]
        after = torch.cumsum(torch.cumsum((out == self.eos).long(), dim=1), dim=1) > 1
        return torch.where(after, torch.full_like(out, self.pad), out).to(torch.int32)


def top_candidates(logits: torch.Tensor, scores: torch.Tensor, m: int):
    """Top-m of ``scores[:, :, None] + log_softmax(logits)`` over K·V:
    (values (B, m) f32, flat indices (B, m))."""
    B, K, V = logits.shape
    cand = scores[:, :, None] + log_softmax(logits.float())
    return top_k(cand.reshape(B, K * V), m)


@torch.inference_mode()
def beam_generate(model: FiDT5, input_ids: torch.Tensor, mask: torch.Tensor,
                  max_length: int = 50, num_beams: int = 4,
                  length_penalty: float = 1.0) -> torch.Tensor:
    """Best sequences (B, max_length-1) int32, padded after EOS."""
    cfg = model.config
    B = input_ids.shape[0]
    K = num_beams
    steps = max_length - 1
    dec = model.t5.decoder
    enc, enc_mask = model.encode_passages(input_ids, mask)
    # tile the encoder state across beams: (B*K, ...)
    enc = enc.repeat_interleave(K, dim=0)
    enc_mask = enc_mask.repeat_interleave(K, dim=0)
    caches, cross_kvs = dec.init_cache(B * K, steps, enc)
    self_bias_full, cross_bias = dec.decode_biases(enc_mask, steps)

    search = BeamSearch(B, K, steps, length_penalty, cfg.eos_token_id, cfg.pad_token_id,
                        enc.device)
    prev = torch.full((B, K), cfg.decoder_start_token_id, dtype=torch.long,
                      device=enc.device)
    rows = torch.arange(B, device=enc.device)[:, None] * K
    for step in range(steps):
        logits, _ = model.decode_step(prev.reshape(B * K), self_bias_full, cross_bias,
                                      caches, cross_kvs, step, steps)
        top_scores, top_idx = top_candidates(logits.reshape(B, K, -1), search.scores,
                                             2 * K)
        live_beam, prev = search.advance(step, top_scores, top_idx, cfg.vocab_size)
        flat = (live_beam + rows).reshape(B * K)
        caches = [(k.index_select(0, flat), v.index_select(0, flat)) for k, v in caches]
    return search.best()


def make_beam_generate_fn(model: FiDT5, max_length: int = 50, num_beams: int = 4,
                          length_penalty: float = 1.0):
    """(input_ids, mask) → tokens (B, max_length-1) by beam search."""

    def fn(input_ids, mask):
        return beam_generate(model, input_ids, mask, max_length=max_length,
                             num_beams=num_beams, length_penalty=length_penalty)

    return fn
