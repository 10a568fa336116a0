"""Reader exact-match metrics: copies of ``exact_match_score`` and ``ems``
from lako_tpu/text/metrics.py, pinned to the originals by
tests/test_torch_train.py. Ground truths are ``{answer: soft_score}``, so
``ems`` returns the best weighted match.
"""

from __future__ import annotations

from typing import Mapping

from lako_tpu_torch.text.normalize import normalize_answer


def exact_match_score(prediction: str, ground_truth: str, value: float) -> float:
    return (normalize_answer(prediction) == normalize_answer(ground_truth)) * value


def ems(prediction: str, ground_truths: Mapping[str, float]) -> float:
    return max(exact_match_score(prediction, k, v) for k, v in ground_truths.items())
