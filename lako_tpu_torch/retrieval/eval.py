"""Retrieval quality: weighted hit@k with include-EM and stem-EM, and the
answer-bearing-first oracle order. A copy of lako_tpu/retrieval/eval.py on
the port's ``includ_ems`` / ``stem_ems``, pinned to the original by
tests/test_torch_retrieval.py.

Per question, walk the ranked facts accumulating the best include-EM /
stem-EM(dele_sw) score seen so far; record the running value at each cut
k in hitk; once both metrics saturate at 1.0 the remaining cuts take the
saturated values.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

from lako_tpu_torch.text.metrics import includ_ems, stem_ems

DEFAULT_HITK = (5, 10, 20, 50, 100, 150, 200, 300, 400, 500)


def answer_bearing_first(rows: Iterable[dict]) -> Tuple[list, int]:
    """Oracle re-ranking: each example's facts answer-bearing first (a fact
    bears the answer when `` {target}``, lowercased, appears in its
    sentence). Candidate sets are unchanged, only the order moves. Returns
    (new rows, number of examples with at least one answer-bearing fact)."""
    out, n_hit = [], 0
    for ex in rows:
        ans = f" {ex['target'].lower().strip()}"
        facts = [dict(f) for f in ex["fact"]]
        hit = [f for f in facts if ans in f["sentence"].lower()]
        miss = [f for f in facts if ans not in f["sentence"].lower()]
        n_hit += bool(hit)
        out.append({**ex, "fact": hit + miss})
    return out, n_hit


def hit_at_k(
    data: Iterable[dict],
    hitk: Sequence[int] = DEFAULT_HITK,
) -> Tuple[Dict[int, float], Dict[int, float]]:
    """Returns ({k: mean include score}, {k: mean stem score})."""
    hitk = sorted(hitk)
    max_k = max(hitk)
    sums = {k: 0.0 for k in hitk}
    sums_stem = {k: 0.0 for k in hitk}
    n = 0
    for example in data:
        n += 1
        gold = example["answer"]
        best_inc, best_stem = 0.0, 0.0
        cuts = {}
        for rank, fact in enumerate(example["fact"][:max_k], start=1):
            if best_inc < 1.0:
                best_inc = max(best_inc, includ_ems(fact["sentence"], gold))
            if best_stem < 1.0:
                best_stem = max(best_stem, stem_ems(fact["sentence"], gold, dele_sw=True))
            if rank in sums:
                cuts[rank] = (best_inc, best_stem)
            if best_inc >= 1.0 and best_stem >= 1.0:
                break
        for k in hitk:
            # cuts beyond the last examined rank inherit the final running best
            inc, st = cuts.get(k, (best_inc, best_stem))
            sums[k] += inc
            sums_stem[k] += st
    if n == 0:
        return {k: 0.0 for k in hitk}, {k: 0.0 for k in hitk}
    return ({k: v / n for k, v in sums.items()},
            {k: v / n for k, v in sums_stem.items()})
