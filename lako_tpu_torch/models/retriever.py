"""BERT bi-encoder retriever with the cross-attention distillation loss: the
port of lako_tpu/models/retriever.py.

A shared projection + LayerNorm down to ``indexing_dimension`` (or
asymmetric question/fact heads), masked mean-pooling or CLS extraction,
inner-product scores scaled by 1/sqrt(dim), and the KL divergence between
the log-softmax of the scores and the gold (attention-derived)
probabilities with torch ``KLDivLoss``'s mean over all elements. The heads'
LayerNorms take flax's default epsilon, 1e-6 (``torch.nn.LayerNorm``'s
would be 1e-5); BERT's own take ``layer_norm_eps``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from lako_tpu_torch.core.config import RetrieverConfig
from lako_tpu_torch.models.bert.model import BertEncoder, LayerNorm, Linear
from lako_tpu_torch.models.t5.layers import number_dropout_sites

# flax nn.LayerNorm's default epsilon
HEAD_NORM_EPS = 1e-6


class Retriever(nn.Module):
    def __init__(self, config: RetrieverConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        hidden, dim = config.bert.hidden_size, config.indexing_dimension
        self.bert = BertEncoder(config.bert, dtype)
        if config.projection:
            self.proj = Linear(hidden, dim, dtype)
            self.norm = LayerNorm(dim, HEAD_NORM_EPS, dtype)
        elif config.asymmetric:
            self.proj_iq = Linear(hidden, dim, dtype)
            self.proj_fact = Linear(hidden, dim, dtype)
            self.norm_iq = LayerNorm(dim, HEAD_NORM_EPS, dtype)
            self.norm_fact = LayerNorm(dim, HEAD_NORM_EPS, dtype)
        number_dropout_sites(self)

    def embed_text(self, text_ids: torch.Tensor, text_mask: torch.Tensor,
                   text_type: str = "q", *, apply_mask: bool = True,
                   extract_cls: bool = False) -> torch.Tensor:
        """(B, L) ids → (B, D) embeddings."""
        cfg = self.config
        hidden = self.bert(text_ids, text_mask if apply_mask else None)
        if cfg.projection:
            hidden = self.norm(self.proj(hidden))
        elif cfg.asymmetric:
            if text_type == "q":
                hidden = self.norm_iq(self.proj_iq(hidden))
            else:
                hidden = self.norm_fact(self.proj_fact(hidden))
        if extract_cls:
            return hidden[:, 0]
        if apply_mask:
            m = text_mask[:, :, None].to(hidden.dtype)
            count = text_mask.sum(dim=1)[:, None].clamp_min(1).to(hidden.dtype)
            return (hidden * m).sum(dim=1) / count
        return hidden.mean(dim=1)

    def forward(
        self,
        question_ids: torch.Tensor,    # (B, Lq)
        question_mask: torch.Tensor,   # (B, Lq)
        passage_ids: torch.Tensor,     # (B, n, Lp)
        passage_mask: torch.Tensor,    # (B, n, Lp)
        gold_score: Optional[torch.Tensor] = None,  # (B, n) probabilities
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """Returns (question_emb, passage_emb, score, loss|None). When the
        questions and passages share the head, the mask policy and the
        length, they go through BERT as one batch, as in the JAX package."""
        cfg = self.config
        B, n, Lp = passage_ids.shape
        fuse = (not cfg.asymmetric and cfg.apply_question_mask == cfg.apply_passage_mask
                and question_ids.shape[1] == Lp)
        if fuse:
            all_ids = torch.cat([question_ids, passage_ids.reshape(B * n, Lp)], dim=0)
            all_mask = torch.cat([question_mask, passage_mask.reshape(B * n, Lp)], dim=0)
            all_emb = self.embed_text(all_ids, all_mask, "q", apply_mask=cfg.apply_question_mask,
                                      extract_cls=cfg.extract_cls)
            q_emb, p_emb = all_emb[:B], all_emb[B:]
        else:
            q_emb = self.embed_text(question_ids, question_mask, "q",
                                    apply_mask=cfg.apply_question_mask,
                                    extract_cls=cfg.extract_cls)
            p_emb = self.embed_text(passage_ids.reshape(B * n, Lp),
                                    passage_mask.reshape(B * n, Lp), "f",
                                    apply_mask=cfg.apply_passage_mask,
                                    extract_cls=cfg.extract_cls)
        score = torch.einsum("bd,bid->bi", q_emb, p_emb.reshape(B, n, -1))
        score = score / (q_emb.shape[-1] ** 0.5)
        loss = None if gold_score is None else kl_div_loss(score, gold_score)
        return q_emb, p_emb, score, loss


def kl_div_loss(score: torch.Tensor, gold: torch.Tensor) -> torch.Tensor:
    """torch.nn.KLDivLoss()(log_softmax(score), gold): elementwise
    ``gold * (log(gold) - log_p)`` with 0-target terms defined as 0, averaged
    over ALL elements (torch's 'mean' reduction): a padded fact with gold 0
    adds 0 but counts in the mean."""
    logp = torch.log_softmax(score.float(), dim=-1)
    gold = gold.float()
    pointwise = torch.where(gold > 0, gold * (torch.log(gold.clamp_min(1e-30)) - logp),
                            torch.zeros((), device=gold.device))
    return pointwise.mean()
