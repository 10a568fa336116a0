"""Reader metrics: copies of ``exact_match_score``, ``includ_match_score``,
``ems``, ``includ_ems`` and ``stem_ems`` from lako_tpu/text/metrics.py,
pinned to the originals by tests/test_torch_train.py and
tests/test_torch_signal.py. Ground truths are ``{answer: soft_score}``, so
each metric returns the best weighted match.
"""

from __future__ import annotations

from typing import Mapping

from lako_tpu_torch.text.normalize import normalize_answer
from lako_tpu_torch.text.stem import porter_stem, word_tokenize


def exact_match_score(prediction: str, ground_truth: str, value: float) -> float:
    return (normalize_answer(prediction) == normalize_answer(ground_truth)) * value


def includ_match_score(prediction: str, ground_truth: str, value: float) -> float:
    p = normalize_answer(prediction)
    g = normalize_answer(ground_truth)
    return ((p in g) or (g in p)) * value


def ems(prediction: str, ground_truths: Mapping[str, float]) -> float:
    return max(exact_match_score(prediction, k, v) for k, v in ground_truths.items())


def includ_ems(prediction: str, ground_truths: Mapping[str, float]) -> float:
    return max(includ_match_score(prediction, k, v) for k, v in ground_truths.items())


def stem_ems(prediction: str, ground_truths: Mapping[str, float],
             dele_sw: bool = False) -> float:
    """Porter-stemmed overlap EM: the value of the highest-valued ground
    truth that shares a stem with the prediction."""
    stem_ans = set(porter_stem(t) for t in word_tokenize(normalize_answer(prediction, dele_sw)))
    for ground_truth, value in sorted(ground_truths.items(), key=lambda x: x[1], reverse=True):
        if any(porter_stem(t) in stem_ans for t in word_tokenize(normalize_answer(ground_truth))):
            return value
    return 0.0
