"""Word-level tokenizer: the framework-free part of lako_tpu/text/tokenizer.py.

A copy, not an import: ``lako_tpu.text`` imports ``regex`` when imported.
``HFTokenizer`` (a ``tokenizers`` adapter) is not ported yet (ROADMAP item 9):
``load_tokenizer`` reads the word-vocab JSON only. Pinned to the original by
tests/test_torch_serve.py.
"""

from __future__ import annotations

import json
import re
from collections import Counter
from pathlib import Path
from typing import Iterable, List, Sequence, Tuple

import numpy as np

_WORD_RX = re.compile(r"\w+|[^\w\s]")


def _word_split(text: str) -> List[str]:
    return _WORD_RX.findall(text.lower())


class BaseTokenizer:
    """Common fixed-shape batching on top of a subclass ``encode``."""

    pad_id: int
    eos_id: int
    vocab_size: int

    def encode(self, text: str, add_special: bool = True) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        raise NotImplementedError

    def batch_encode(
        self, texts: Sequence[str], max_length: int, add_special: bool = True
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns int32 ``(B, max_length)`` ids and bool mask, truncated and padded."""
        ids = np.full((len(texts), max_length), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), max_length), dtype=bool)
        for i, t in enumerate(texts):
            toks = self.encode(t, add_special=add_special)[:max_length]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = True
        return ids, mask

    def batch_decode(self, batch_ids, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(list(map(int, row)), skip_special_tokens) for row in batch_ids]


class WordVocabTokenizer(BaseTokenizer):
    """Deterministic word-level tokenizer.

    style="t5":   ids 0=pad, 1=eos, 2=unk; ``encode`` appends EOS.
    style="bert": ids 0=pad, 100=unk, 101=[CLS], 102=[SEP]; encode wraps CLS..SEP.
    """

    def __init__(self, vocab: dict, style: str = "t5"):
        self.style = style
        self.vocab = dict(vocab)
        self.inv = {v: k for k, v in self.vocab.items()}
        if style == "t5":
            self.pad_id, self.eos_id, self.unk_id = 0, 1, 2
            self.cls_id = self.sep_id = None
            self._special = {self.pad_id, self.eos_id}
        elif style == "bert":
            self.pad_id, self.unk_id, self.cls_id, self.sep_id = 0, 100, 101, 102
            self.eos_id = self.sep_id
            self._special = {self.pad_id, self.cls_id, self.sep_id}
        else:
            raise ValueError(style)
        self.vocab_size = max(self.vocab.values(), default=0) + 1

    @classmethod
    def build(cls, corpus: Iterable[str], style: str = "t5", max_vocab: int = 32000):
        counts = Counter()
        for text in corpus:
            counts.update(_word_split(text))
        first_id = 3 if style == "t5" else 103
        vocab = {w: first_id + i
                 for i, (w, _) in enumerate(counts.most_common(max_vocab))}
        return cls(vocab, style=style)

    def encode(self, text: str, add_special: bool = True) -> List[int]:
        ids = [self.vocab.get(w, self.unk_id) for w in _word_split(text)]
        if add_special:
            if self.style == "t5":
                ids = ids + [self.eos_id]
            else:
                ids = [self.cls_id] + ids + [self.sep_id]
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        words = []
        for i in ids:
            if skip_special_tokens and i in self._special:
                continue
            words.append(self.inv.get(i, "<unk>"))
        return " ".join(words)

    def save(self, path: str) -> None:
        Path(path).write_text(json.dumps({"style": self.style, "vocab": self.vocab}))

    @classmethod
    def load(cls, path: str):
        d = json.loads(Path(path).read_text())
        return cls(d["vocab"], style=d["style"])


def load_tokenizer(path_or_dir: str, style: str = "t5") -> BaseTokenizer:
    """Load a saved tokenizer: a word-vocab JSON, or a directory holding
    ``word_vocab.json``. ``style`` is the JAX function's argument for HF
    tokenizers; a word vocabulary carries its own style."""
    p = Path(path_or_dir)
    if p.is_dir():
        for name in ("tokenizer.json", "word_vocab.json"):
            if (p / name).exists():
                p = p / name
                break
    d = json.loads(p.read_text())
    if "vocab" in d and "style" in d:
        return WordVocabTokenizer.load(str(p))
    raise NotImplementedError(f"{p} is not a word-vocab tokenizer; HF tokenizers are not "
                              "ported yet (ROADMAP item 9)")
