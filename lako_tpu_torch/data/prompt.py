"""Oracle-prompt ablation transforms: a copy of lako_tpu/data/prompt.py,
pinned to the original by tests/test_torch_dataprep.py.

Three ablations inject gold-answer "facts" into the question to bound late
knowledge injection from above: 1: the best answer, 2: all answers sorted
by score, descending, 3: a random answer. Pure transforms over cache-format
rows ({sent, label, ...}); ``truncate_dataset`` keeps the first rows.
"""

from __future__ import annotations

import random
from typing import List, Sequence

SEP = "[SEP]"


def _apply(datum: dict, ans: str, split_segment: bool) -> dict:
    out = dict(datum)
    if not split_segment:
        out["sent"] = f"Fact: {ans}. {SEP} Question: {datum['sent']}"
        out["fact"] = ""
    else:
        out["sent"] = f"Question: {datum['sent']}"
        out["fact"] = f"Fact: {ans}."
    return out


def prompt_best_answer(data: Sequence[dict], split_segment: bool = False) -> List[dict]:
    """Ablation 1: highest-scored gold answer as the fact."""
    out = []
    for datum in data:
        if "label" in datum and datum["label"]:
            ans, _ = max(datum["label"].items(), key=lambda kv: kv[1])
            out.append(_apply(datum, ans, split_segment))
        else:
            out.append(dict(datum))
    return out


def prompt_all_answers(data: Sequence[dict], split_segment: bool = False) -> List[dict]:
    """Ablation 2: all gold answers, score-descending, comma-joined."""
    out = []
    for datum in data:
        if "label" in datum and datum["label"]:
            ordered = sorted(datum["label"].items(), key=lambda kv: kv[1],
                             reverse=True)
            ans = ", ".join(a for a, _ in ordered)
            out.append(_apply(datum, ans, split_segment))
        else:
            out.append(dict(datum))
    return out


def prompt_random_answer(data: Sequence[dict], split_segment: bool = False,
                         seed: int = 0) -> List[dict]:
    """Ablation 3: a uniformly random gold answer."""
    rng = random.Random(seed)
    out = []
    for datum in data:
        if "label" in datum and datum["label"]:
            ans = rng.choice(list(datum["label"].keys()))
            out.append(_apply(datum, ans, split_segment))
        else:
            out.append(dict(datum))
    return out


def truncate_dataset(data: Sequence[dict], keep: int) -> List[dict]:
    """Top-k truncation of a dataset (reference deal_vqa.py:1-28)."""
    return list(data[:keep])
