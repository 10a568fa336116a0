"""Reader dataset: example formatting with question/caption/fact prefixes.

A copy of lako_tpu/data/dataset.py (its package imports jax). Examples are
dicts ``{question, target?, answers?, answer, img_id, caption, fact:
[{sentence, id, score?}, ...]}``, formatted into prefixed strings. Passage
packing by ``stream``: stream 1 → one passage [question caption fact];
stream 2 → two passages [question caption, fact].
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence

from lako_tpu_torch.core.config import ReaderDataConfig


class ReaderDataset:
    def __init__(self, data: Sequence[dict], cfg: ReaderDataConfig, seed: int = 0):
        self.data = list(data)
        self.cfg = cfg
        self._rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.data)

    def get_example(self, index: int) -> dict:
        return self.data[index]

    def get_target(self, example: dict) -> Optional[str]:
        # the tokenizers append EOS in encode(), so the bare string is returned
        if "target" in example:
            return example["target"]
        if "answers" in example:
            return self._rng.choice(example["answers"])
        return None

    def __getitem__(self, index: int) -> dict:
        cfg = self.cfg
        example = self.data[index]
        question = f"{cfg.question_prefix} {example['question']}"
        caption = f"{cfg.caption_prefix} {example['caption']}"
        target = self.get_target(example)

        fact = None
        fact_sentences: List[str] = []
        scores = None
        if cfg.use_fact:
            contexts = example["fact"][: cfg.n_context]
            fact_sentences = [c["sentence"] for c in contexts]
            if cfg.fact_use_way == "concate":
                fact = f"{cfg.fact_prefix} " + " ".join(fact_sentences) + " "
            else:
                fact = fact_sentences
            if contexts and "score" in contexts[0]:
                scores = [float(c["score"]) for c in contexts]

        return {
            "index": index,
            "question": question,
            "caption": caption,
            "target": target,
            "answer": example.get("answer"),
            "fact": fact,
            "fact_sentences": fact_sentences,
            "score": scores,
        }


def format_passages(item: dict, stream: int) -> List[str]:
    """Passage packing for one formatted item."""
    if item["fact"] is None:
        return [item["question"] + " " + item["caption"]]
    if isinstance(item["fact"], str):
        if stream == 1:
            return [item["question"] + " " + item["caption"] + " " + item["fact"]]
        return [item["question"] + " " + item["caption"], item["fact"]]
    # fact_use_way == "separate": one passage per fact sentence
    return [item["question"] + " " + item["caption"]] + list(item["fact"])
