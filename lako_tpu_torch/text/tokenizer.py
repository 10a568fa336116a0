"""Tokenizers: the port of lako_tpu/text/tokenizer.py.

A copy, not an import: ``lako_tpu.text`` imports ``regex`` when imported.
``WordVocabTokenizer`` is pinned to the original by
tests/test_torch_serve.py. ``HFTokenizer`` reads and writes HF
``tokenizer.json`` files with the original's interface: through the
``tokenizers`` package when it imports, else through
text/tokenizer_json.py's plain reader of the two layouts this module's
trainers write (training needs the package). ``load_tokenizer`` logs which
reader it took. Both are held to ``tokenizers`` by
tests/test_torch_hf_tokenizer.py.
"""

from __future__ import annotations

import json
import re
from collections import Counter
from pathlib import Path
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from lako_tpu_torch.core.logging import get_logger

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


def _tokenizers():
    """The ``tokenizers`` package, or None where it does not import."""
    try:
        import tokenizers
    except ImportError:
        return None
    return tokenizers


def _require_tokenizers(what: str):
    tokenizers = _tokenizers()
    if tokenizers is None:
        raise ImportError(f"{what} needs the `tokenizers` package, which does not import "
                          "here; the plain tokenizer.json reader only reads files")
    return tokenizers


class HFTokenizer(BaseTokenizer):
    """Adapter over a ``tokenizers.Tokenizer`` or a
    :class:`~lako_tpu_torch.text.tokenizer_json.PlainTokenizer` (a local
    file or one trained in-process)."""

    def __init__(self, tk, style: str = "t5"):
        self._tk = tk
        self.style = style
        vocab = tk.get_vocab()
        self.vocab_size = tk.get_vocab_size()
        if style == "t5":
            self.pad_id = vocab.get("<pad>", 0)
            self.eos_id = vocab.get("</s>", 1)
            self.unk_id = vocab.get("<unk>", 2)
        else:
            self.pad_id = vocab.get("[PAD]", 0)
            self.unk_id = vocab.get("[UNK]", 100)
            self.cls_id = vocab.get("[CLS]", 101)
            self.sep_id = vocab.get("[SEP]", 102)
            self.eos_id = self.sep_id

    @property
    def reader(self) -> str:
        """``"tokenizers"`` or ``"plain"``: which reader encodes."""
        from lako_tpu_torch.text.tokenizer_json import PlainTokenizer

        return "plain" if isinstance(self._tk, PlainTokenizer) else "tokenizers"

    @classmethod
    def from_file(cls, path: str, style: str = "t5"):
        """Through ``tokenizers`` when it imports, else the plain reader."""
        from lako_tpu_torch.text.tokenizer_json import PlainTokenizer

        tokenizers = _tokenizers()
        tk = PlainTokenizer.from_file(path) if tokenizers is None \
            else tokenizers.Tokenizer.from_file(path)
        return cls(tk, style=style)

    @classmethod
    def train_unigram(cls, corpus: Iterable[str], vocab_size: int = 32000):
        """Train a T5-style Unigram tokenizer (sentencepiece-equivalent) in-process."""
        tokenizers = _require_tokenizers("training a unigram tokenizer")
        tk = tokenizers.Tokenizer(tokenizers.models.Unigram())
        tk.pre_tokenizer = tokenizers.pre_tokenizers.Metaspace(replacement="▁")
        tk.decoder = tokenizers.decoders.Metaspace(replacement="▁")
        trainer = tokenizers.trainers.UnigramTrainer(
            vocab_size=vocab_size,
            special_tokens=["<pad>", "</s>", "<unk>"],
            unk_token="<unk>",
        )
        tk.train_from_iterator(corpus, trainer=trainer)
        return cls(tk, style="t5")

    @classmethod
    def train_wordpiece(cls, corpus: Iterable[str], vocab_size: int = 30000):
        """Train a BERT-style WordPiece tokenizer in-process."""
        tokenizers = _require_tokenizers("training a wordpiece tokenizer")
        tk = tokenizers.Tokenizer(tokenizers.models.WordPiece(unk_token="[UNK]"))
        tk.normalizer = tokenizers.normalizers.BertNormalizer(lowercase=True)
        tk.pre_tokenizer = tokenizers.pre_tokenizers.BertPreTokenizer()
        trainer = tokenizers.trainers.WordPieceTrainer(
            vocab_size=vocab_size,
            special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"],
        )
        tk.train_from_iterator(corpus, trainer=trainer)
        return cls(tk, style="bert")

    def encode(self, text: str, add_special: bool = True) -> List[int]:
        ids = self._tk.encode(text, add_special_tokens=False).ids
        if add_special:
            if self.style == "t5":
                ids = ids + [self.eos_id]
            else:
                ids = [self.cls_id] + ids + [self.sep_id]
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tk.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def save(self, path: str) -> None:
        self._tk.save(path)


def load_tokenizer(path_or_dir: str, style: str = "t5") -> BaseTokenizer:
    """Load a saved tokenizer: a ``tokenizer.json`` (HF fast format) or a
    word-vocab JSON, or a directory holding either. ``style`` sets an HF
    tokenizer's special ids; a word vocabulary carries its own style."""
    p = Path(path_or_dir)
    if p.is_dir():
        for name in ("tokenizer.json", "word_vocab.json"):
            if (p / name).exists():
                p = p / name
                break
    d = json.loads(p.read_text())
    if "vocab" in d and "style" in d:
        return WordVocabTokenizer.load(str(p))
    tok = HFTokenizer.from_file(str(p), style=style)
    get_logger().info("load_tokenizer: %s read by %s", p, "the `tokenizers` package"
                      if tok.reader == "tokenizers" else "the plain tokenizer.json reader "
                      "(`tokenizers` does not import)")
    return tok
