"""Knowledge-graph triple → natural-language sentence verbalization: a copy
of lako_tpu/retrieval/verbalize.py, pinned to the original by
tests/test_torch_dataprep.py.

Relation templates from a mapping, comparative relations ``X#f`` → "is more
X than" and ``X#r`` → "is less X than", otherwise the raw relation string;
sentence = "s relation o".
"""

from __future__ import annotations

from typing import Iterable, List, Mapping, Sequence, Tuple


def relation_phrase(relation: str, relation2template: Mapping[str, str]) -> str:
    if relation in relation2template:
        return relation2template[relation]
    if len(relation) >= 2 and relation[-2] == "#":
        if relation[-1] == "f":
            return "is more " + relation[:-2] + " than"
        if relation[-1] == "r":
            return "is less " + relation[:-2] + " than"
    return relation


def triple_to_sentence(triple: Sequence[str],
                       relation2template: Mapping[str, str]) -> str:
    s, r, o = triple[0], triple[1], triple[2]
    return f"{s} {relation_phrase(r, relation2template)} {o}"


def verbalize_triples(
    triples: Iterable[Sequence[str]],
    relation2template: Mapping[str, str],
) -> List[Tuple[str, str, str, str]]:
    """[(s, r, o)] → [(s, r, o, sentence)] — the reference's ``four_tuple``
    (vqa2_deal.py:48-64). Index order is corpus fact-id order."""
    return [
        (t[0], t[1], t[2], triple_to_sentence(t, relation2template))
        for t in triples
    ]


def corpus_sentences(four_tuple: Sequence[Tuple[str, str, str, str]],
                     terminal_period: bool = True) -> List[str]:
    """Fact sentences as stored in example['fact'] (reference appends '.',
    vqa2_deal.py:138-141)."""
    return [(t[3] + ".") if terminal_period else t[3] for t in four_tuple]
