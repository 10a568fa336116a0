"""Batched corpus and question embedding with the retriever: the port of
lako_tpu/retrieval/embed.py.

The model's parameters decide the device: the batches go where they are.
Each returns float32 numpy arrays ready for :class:`DenseIndex`.
``maxlength`` defaults to the length the retriever was trained at
(``passage_maxlength`` / ``question_maxlength``): a different length is a
train/inference mismatch, and past the position table the BERT raises.
A token id past the vocabulary raises too, before the lookup: the JAX
model fills both lookups with NaN, which its finite check reports, where
torch would fail on the CPU with an ``IndexError`` and on the card with a
device-side assert.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lako_tpu_torch.data.collator import TextCollator
from lako_tpu_torch.models.retriever import Retriever


def make_embed_fn(model: Retriever, text_type: str = "f", to_host: bool = True) -> Callable:
    """``(ids, mask) numpy -> (B, D) float32 numpy`` through
    ``model.embed_text`` with the config's mask policy for ``text_type``,
    in eval mode, on the model's device (``to_host=False``: a float32
    tensor left on that device)."""
    cfg = model.config
    apply_mask = cfg.apply_passage_mask if text_type == "f" else cfg.apply_question_mask
    device = next(model.parameters()).device

    @torch.no_grad()
    def embed(ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        if ids.size and int(ids.max()) >= cfg.bert.vocab_size:
            raise FloatingPointError(
                f"token id {int(ids.max())} is past bert.vocab_size ({cfg.bert.vocab_size}): "
                f"the lookup would make the embeddings non-finite (NaN in the JAX model)")
        model.eval()
        emb = model.embed_text(torch.from_numpy(ids).to(device),
                               torch.from_numpy(mask).to(device), text_type,
                               apply_mask=apply_mask, extract_cls=cfg.extract_cls)
        return emb.float().cpu().numpy() if to_host else emb.float()

    return embed


def _check_finite(emb: np.ndarray, what: str) -> None:
    """NaN embeddings make every downstream score NaN, and a NaN score makes
    a sort a silent no-op: fail here, at the source, with a diagnosis."""
    if not np.isfinite(emb).all():
        raise FloatingPointError(
            f"{what} embeddings contain non-finite values "
            f"({np.isnan(emb).sum()} NaN / {np.isinf(emb).sum()} inf of "
            f"{emb.size}). Common cause: maxlength exceeds the retriever's "
            f"bert.max_position_embeddings (out-of-range position lookup "
            f"fills with NaN).")


def embed_corpus(
    model: Retriever,
    sentences: Sequence[dict],   # [{"sentence": str, "id": int}]
    tokenizer,
    batch_size: int = 512,
    maxlength: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (ids (n,), embeddings (n, dim) float32) in input order."""
    if maxlength is None:
        maxlength = model.config.passage_maxlength
    collator = TextCollator(tokenizer, maxlength=maxlength)
    embed = make_embed_fn(model, "f")
    all_ids: List[np.ndarray] = []
    all_emb: List[np.ndarray] = []
    for s in range(0, len(sentences), batch_size):
        fact_ids, ids, mask = collator(list(sentences[s:s + batch_size]))
        all_ids.append(fact_ids)
        all_emb.append(embed(ids, mask))
    out_ids, out_emb = np.concatenate(all_ids), np.concatenate(all_emb)
    _check_finite(out_emb, "corpus")
    return out_ids, out_emb


def embed_questions(
    model: Retriever,
    examples: Sequence[dict],    # reader-format: {"question", "caption", ...}
    tokenizer,
    batch_size: int = 512,
    maxlength: Optional[int] = None,
) -> np.ndarray:
    """Question+caption embeddings: ``question + " " + caption``, no prefix."""
    if maxlength is None:
        maxlength = model.config.question_maxlength
    embed = make_embed_fn(model, "q")
    out: List[np.ndarray] = []
    for s in range(0, len(examples), batch_size):
        texts = [ex["question"] + " " + ex["caption"] for ex in examples[s:s + batch_size]]
        out.append(embed(*tokenizer.batch_encode(texts, maxlength)))
    q_emb = np.concatenate(out)
    _check_finite(q_emb, "question")
    return q_emb
