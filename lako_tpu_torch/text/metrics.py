"""Reader and retriever metrics: copies of ``exact_match_score``,
``includ_match_score``, ``ems``, ``includ_ems``, ``stem_ems``, the DPR
answer matcher (``has_answer``, ``calculate_matches``),
``count_inversions`` and ``ranking_stats`` from lako_tpu/text/metrics.py,
pinned to the originals by tests/test_torch_train.py,
tests/test_torch_signal.py, tests/test_torch_retrieval.py and
tests/test_torch_native.py. Ground truths are ``{answer: soft_score}``, so
each answer metric returns the best weighted match.
"""

from __future__ import annotations

import unicodedata
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Iterable, List, Mapping, Sequence

import numpy as np

from lako_tpu_torch.text.normalize import normalize_answer
from lako_tpu_torch.text.simple_tokenizer import SimpleTokenizer
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


def _nfd(text: str) -> str:
    return unicodedata.normalize("NFD", text)


def has_answer(answers: Iterable[str], text: str, tokenizer: SimpleTokenizer) -> bool:
    """True if any answer appears as a token subsequence of the document
    (DPR's matcher, reference src/evaluation.py:59-125)."""
    text_toks = tokenizer.tokenize(_nfd(text), uncased=True)
    for answer in answers:
        ans_toks = tokenizer.tokenize(_nfd(answer), uncased=True)
        n = len(ans_toks)
        for i in range(0, len(text_toks) - n + 1):
            if ans_toks == text_toks[i: i + n]:
                return True
    return False


def _check_answer(example) -> List[bool]:
    tokenizer = SimpleTokenizer()
    return [False if doc["text"] is None else has_answer(example["answers"], doc["text"],
                                                          tokenizer)
            for doc in example["ctxs"]]


def calculate_matches(data: List[dict], workers_num: int = 1):
    """``(top_k_hits, questions_doc_hits)``: per question, each document's
    hit, and the cumulative top-k hit counts (the reference's QAMatchStats,
    src/evaluation.py:59-91)."""
    if workers_num > 1:
        with ProcessPoolExecutor(max_workers=workers_num) as pool:
            scores = list(pool.map(_check_answer, data))
    else:
        scores = [_check_answer(ex) for ex in data]
    top_k_hits = [0] * len(data[0]["ctxs"])
    for question_hits in scores:
        best_hit = next((i for i, x in enumerate(question_hits) if x), None)
        if best_hit is not None:
            top_k_hits[best_hit:] = [v + 1 for v in top_k_hits[best_hit:]]
    return top_k_hits, scores


def count_inversions(arr: Sequence[int]) -> int:
    """Number of pairs out of order, by an O(n log n) merge count."""
    a = list(arr)

    def _merge_count(lo, hi):
        if hi - lo <= 1:
            return 0
        mid = (lo + hi) // 2
        inv = _merge_count(lo, mid) + _merge_count(mid, hi)
        merged = []
        i, j = lo, mid
        while i < mid and j < hi:
            if a[i] <= a[j]:
                merged.append(a[i])
                i += 1
            else:
                inv += mid - i
                merged.append(a[j])
                j += 1
        merged.extend(a[i:mid])
        merged.extend(a[j:hi])
        a[lo:hi] = merged
        return inv

    return _merge_count(0, len(a))


def ranking_stats(
    scores: np.ndarray,
    inversions: list,
    avg_topk: Dict[int, list],
    idx_topk: Dict[int, list],
) -> None:
    """Accumulate inversion / top-k-overlap stats for a batch of predicted
    scores against gold rank order. ``scores[i]`` are predicted scores for
    passages already sorted by gold score descending, so ``argsort(-scores)``
    maps predicted rank → gold rank."""
    for s in np.asarray(scores):
        x = np.argsort(-s)
        inversions.append(count_inversions(x))
        for k in avg_topk:
            avg_topk[k].append((x[:k] < k).mean())
        for k in idx_topk:
            below_k = x < k
            idx_topk[k].append(len(x) - int(np.argmax(below_k[::-1])))
