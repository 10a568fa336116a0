"""BM25 candidate mining over the verbalized KG: the port of
lako_tpu/retrieval/candidates.py, pinned to the original's Python path by
tests/test_torch_dataprep.py.

Per question: a stemmed, stop-word-filtered word set from question +
caption (+ OCR text); every triple whose subject or object shares a stemmed
word is a candidate (an inverted stem → fact-id index, built once); the
candidates are ranked by BM25 and the top ``k`` kept. The JAX package ranks
with its C++ BM25 when that library builds, whose ties fall in a stable
reversed order; this module has only the Python BM25, whose ties fall in
``np.argsort(scores)[::-1]`` order.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Set, Tuple

from lako_tpu_torch.retrieval.bm25 import BM25Okapi
from lako_tpu_torch.text.normalize import STOP_WORDS
from lako_tpu_torch.text.stem import porter_stem


def _question_word_set(question: str, caption_sentence: str) -> Set[str]:
    """Stemmed, stop-word-filtered word set (vqa2_deal.py:99-108)."""
    sentence = question + " " + caption_sentence
    sentence = sentence.replace("?", "").replace(".", "").replace(",", "")
    stems = {porter_stem(w) for w in sentence.split(" ")}
    return {w for w in stems if w not in STOP_WORDS}


def build_caption_sentence(captions: Sequence[str], ocr_text: str = "") -> str:
    """Join captions with terminal periods, OCR text first (vqa2_deal.py:86-98)."""
    out = ""
    if ocr_text:
        out += ocr_text + " "
    for i, cap in enumerate(captions):
        if cap and cap[-1] != ".":
            cap = cap + "."
        out += cap + (" " if i != len(captions) - 1 else "")
    return out.replace("..", ".").replace(". .", ".")


class CandidateMiner:
    """Inverted-index candidate mining + BM25 top-k."""

    def __init__(self, four_tuple: Sequence[Tuple[str, str, str, str]]):
        """four_tuple: [(s, r, o, sentence)] with positions as fact ids — the
        subject/object stems index the triple (vqa2_deal.py:113-114 matches on
        ``triple_stem[0] + " " + triple_stem[2]`` word sets)."""
        self.four_tuple = list(four_tuple)
        self.inverted: Dict[str, List[int]] = defaultdict(list)
        for i, (s, _, o, _) in enumerate(self.four_tuple):
            for w in set((s + " " + o).split(" ")):
                self.inverted[w].append(i)

    def candidate_ids(self, word_set: Set[str]) -> List[int]:
        seen: Set[int] = set()
        for w in word_set:
            seen.update(self.inverted.get(w, ()))
        return sorted(seen)

    def top_k(
        self,
        question: str,
        caption_sentence: str,
        k: int = 500,
    ) -> List[dict]:
        """Returns [{sentence, id}] top-k facts (sentence gets its terminal '.',
        matching vqa2_deal.py:138-141)."""
        words = _question_word_set(question, caption_sentence)
        cand = self.candidate_ids(words)
        if not cand:
            return []
        # dedup by sentence, last id wins (the reference's ``fact[sentence] = i``
        # dict build, vqa2_deal.py:112-116)
        fact: Dict[str, int] = {}
        for i in cand:
            fact[self.four_tuple[i][3]] = i
        docs = list(fact.keys())
        doc_tokens = [d.split(" ") for d in docs]

        # dedup caption words for the BM25 query (vqa2_deal.py:118-122)
        caption_words = list(dict.fromkeys(
            caption_sentence.replace(".", "").replace(",", "").split(" ")
        ))
        query_sentence = (question + " " + " ".join(caption_words)) \
            .replace("?", "").replace(".", "").replace(",", "")
        query = query_sentence.split(" ")

        n = min(k, len(docs))
        top = BM25Okapi(doc_tokens).get_top_n(query, docs, n=n)
        return [{"sentence": d + ".", "id": fact[d]} for d in top]

    def mine_dataset(
        self,
        examples: Iterable[dict],
        img2caption: Mapping[str, Sequence[str]],
        image2text: Optional[Mapping[str, str]] = None,
        k: int = 500,
    ) -> List[dict]:
        """Build reader-format examples from cache-format rows
        ({sent, label, img_id, ...} → {question, target, answer, img_id, caption,
        fact}), mirroring top_500kg (vqa2_deal.py:67-149)."""
        image2text = image2text or {}
        out = []
        for row in examples:
            targets = list(row["label"].keys())
            if not targets:
                continue
            img_id = str(row["img_id"])
            caption_sentence = build_caption_sentence(
                img2caption.get(img_id, []), image2text.get(img_id, "")
            )
            out.append({
                "question": row["sent"],
                "target": targets[0],
                "answer": row["label"],
                "img_id": row["img_id"],
                "caption": caption_sentence,
                "fact": self.top_k(row["sent"], caption_sentence, k=k),
            })
        return out
