"""BM25 candidate mining over the verbalized KG: the port of
lako_tpu/retrieval/candidates.py, pinned to the original's Python path by
tests/test_torch_dataprep.py and to its C++ path by
tests/test_torch_native.py.

Per question: a stemmed, stop-word-filtered word set from question +
caption (+ OCR text); every triple whose subject or object shares a stemmed
word is a candidate (an inverted stem → fact-id index, built once); the
candidates are ranked by BM25 and the top ``k`` kept. As in the JAX
package, the ranking takes the C++ BM25 (retrieval/native.py) when the host
library builds and loads, and the Python BM25 otherwise: the rule decides
which facts are mined, since the C++ ties fall in descending index order
and the Python ones in ``np.argsort(scores)[::-1]`` order. Unlike the JAX
package, the path taken is logged, and a failure of the C++ path after its
library loaded raises.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Set, Tuple

from lako_tpu_torch.core.logging import get_logger
from lako_tpu_torch.retrieval import native
from lako_tpu_torch.retrieval.bm25 import BM25Okapi
from lako_tpu_torch.text.normalize import STOP_WORDS
from lako_tpu_torch.text.stem import porter_stem


_logged_paths: Set[str] = set()


def bm25_backend() -> str:
    """"C++" when the host library loads, else "Python": the BM25 the
    miner ranks with (logged the first time each is taken)."""
    path = "C++" if native.native_available() else "Python"
    if path not in _logged_paths:
        _logged_paths.add(path)
        get_logger().info("candidate mining ranks with the %s BM25%s", path,
                          "" if path == "C++" else " (the host library does not build)")
    return path


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
        top = self._bm25_top_n(doc_tokens, query, docs, n)
        return [{"sentence": d + ".", "id": fact[d]} for d in top]

    @staticmethod
    def _bm25_top_n(doc_tokens, query, docs, n):
        """The C++ BM25 when the host library loads, Python otherwise."""
        if bm25_backend() == "Python":
            return BM25Okapi(doc_tokens).get_top_n(query, docs, n=n)
        vocab: Dict[str, int] = {}

        def ids(words):
            return [vocab.setdefault(w, len(vocab)) for w in words]

        doc_ids = [ids(d) for d in doc_tokens]
        q_ids = [vocab[w] for w in query if w in vocab]
        return [docs[i] for i in native.bm25_topn_native(doc_ids, q_ids, n)]

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
