from lako_tpu_torch.text.metrics import (
    calculate_matches,
    count_inversions,
    ems,
    exact_match_score,
    has_answer,
    includ_ems,
    includ_match_score,
    ranking_stats,
    stem_ems,
)
from lako_tpu_torch.text.normalize import STOP_WORDS, normalize_answer
from lako_tpu_torch.text.simple_tokenizer import SimpleTokenizer

__all__ = [
    "normalize_answer",
    "STOP_WORDS",
    "exact_match_score",
    "includ_match_score",
    "ems",
    "includ_ems",
    "stem_ems",
    "has_answer",
    "calculate_matches",
    "count_inversions",
    "ranking_stats",
    "SimpleTokenizer",
]
