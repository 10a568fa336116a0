"""A plain-Python reader of the two ``tokenizer.json`` layouts that
text/tokenizer.py's ``HFTokenizer.train_unigram`` and ``train_wordpiece``
write, for machines without the ``tokenizers`` package. It encodes and
decodes as ``tokenizers`` does for exactly these layouts:

- **Unigram** (T5 style): no normalizer; the ``Metaspace`` pre-tokenizer
  (``▁`` for spaces, ``prepend_scheme="always"``, split before each ``▁``);
  the Viterbi path over the pieces' log-probabilities, where a character
  no piece starts with costs ``min score - 10`` and adjacent unknown
  characters fuse into one unknown token; the ``Metaspace`` decoder.
- **WordPiece** (BERT style): ``BertNormalizer(lowercase=True)`` (control
  characters dropped, whitespace to spaces, CJK ideographs spaced, NFD
  accents stripped, lowercased character by character);
  ``BertPreTokenizer`` (split on whitespace, punctuation isolated); greedy
  longest match with ``##`` continuations, a word longer than
  ``max_input_chars_per_word`` or with no match being one unknown token;
  no decoder (tokens joined by spaces).

The character classes come from Python's ``unicodedata``. ``tokenizers``
reads controls, punctuation and non-spacing marks from older Unicode
tables (its ``unicode_categories`` crate): a few hundred characters
assigned since Unicode 9 (for instance U+2E43, U+0890, U+0898) are classed
differently there, and the WordPiece layout can tokenize text holding them
differently. The Unigram layout uses no character class.

Added tokens (the special tokens) are split out of the raw text first,
leftmost-longest, as ``tokenizers`` does for ``normalized: false`` tokens.
Any other component raises ``NotImplementedError`` naming it and the
``tokenizers`` package: real T5 and BERT files carry such components (the
``Precompiled`` normalizer, template post-processors), and this reader
never approximates them.
"""

from __future__ import annotations

import json
import re
import unicodedata
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence

METASPACE = "▁"
_UNK_PENALTY = 10.0
_METASPACE_JSON = {"type": "Metaspace", "replacement": METASPACE, "prepend_scheme": "always",
                   "split": True}
_BERT_NORMALIZER_JSON = {"type": "BertNormalizer", "clean_text": True,
                         "handle_chinese_chars": True, "strip_accents": None, "lowercase": True}
# Unicode's White_Space property (Rust's char::is_whitespace)
_WHITE_SPACE = frozenset(map(chr, [*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680,
                                   *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F,
                                   0x3000]))
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))
_ASCII_PUNCT = frozenset("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


class Encoding(NamedTuple):
    ids: List[int]
    tokens: List[str]


def _unsupported(where: str, component) -> NotImplementedError:
    kind = component.get("type") if isinstance(component, dict) else component
    return NotImplementedError(
        f"tokenizer.json {where} {kind!r} ({json.dumps(component)[:200]}) is not one this "
        "plain reader implements; it reads only the Unigram/Metaspace and "
        "WordPiece/BertNormalizer layouts that HFTokenizer.train_unigram and "
        "train_wordpiece write. Install the `tokenizers` package to read this file.")


def _is_cjk(c: str) -> bool:
    o = ord(c)
    return any(lo <= o <= hi for lo, hi in _CJK)


def _is_control(c: str) -> bool:
    """Cc, Cf, Co or Cs, but not tab, newline or return; unassigned code
    points (Cn) are kept, as ``tokenizers`` keeps them."""
    return c not in "\t\n\r" and unicodedata.category(c) in ("Cc", "Cf", "Co", "Cs")


def _is_bert_punct(c: str) -> bool:
    return c in _ASCII_PUNCT or unicodedata.category(c).startswith("P")


def bert_normalize(text: str) -> str:
    """``BertNormalizer(clean_text=True, handle_chinese_chars=True,
    strip_accents=None, lowercase=True)``."""
    text = "".join(" " if c in _WHITE_SPACE else c for c in text
                   if not (c in "\x00\ufffd" or _is_control(c)))
    text = "".join(f" {c} " if _is_cjk(c) else c for c in text)
    text = "".join(c for c in unicodedata.normalize("NFD", text)
                   if unicodedata.category(c) != "Mn")
    return "".join(c.lower() for c in text)


def bert_pre_tokenize(text: str) -> List[str]:
    """``BertPreTokenizer``: whitespace removed, punctuation isolated."""
    out: List[str] = []
    for word in "".join(" " if c in _WHITE_SPACE else c for c in text).split(" "):
        start = 0
        for i, c in enumerate(word):
            if _is_bert_punct(c):
                if i > start:
                    out.append(word[start:i])
                out.append(c)
                start = i + 1
        if start < len(word):
            out.append(word[start:])
    return out


def metaspace_pre_tokenize(text: str) -> List[str]:
    """``Metaspace(replacement="▁", prepend_scheme="always", split=True)``:
    spaces become ``▁``, one is prepended unless the text starts with it,
    and each ``▁`` starts a new piece."""
    text = text.replace(" ", METASPACE)
    if not text.startswith(METASPACE):
        text = METASPACE + text
    pieces, start = [], 0
    for i in range(1, len(text)):
        if text[i] == METASPACE:
            pieces.append(text[start:i])
            start = i
    pieces.append(text[start:])
    return pieces


class PlainTokenizer:
    """The ``tokenizers.Tokenizer`` interface that ``HFTokenizer`` uses
    (``encode``, ``decode``, ``get_vocab``, ``get_vocab_size``, ``save``),
    over one of the two layouts of the module docstring."""

    def __init__(self, spec: dict):
        self.spec = spec
        for key in ("truncation", "padding", "post_processor"):
            if spec.get(key) is not None:
                raise _unsupported(key, spec[key])
        model = spec.get("model") or {}
        kind = model.get("type")
        if kind == "Unigram":
            self._check(spec, normalizer=None, pre_tokenizer=_METASPACE_JSON,
                        decoder=_METASPACE_JSON)
            if model.get("byte_fallback"):
                raise _unsupported("model", {k: v for k, v in model.items() if k != "vocab"})
            self.pieces = [(str(p), float(s)) for p, s in model["vocab"]]
            self.unk_id: Optional[int] = model.get("unk_id")
            self.token_to_id = {p: i for i, (p, _) in enumerate(self.pieces)}
            self.min_score = min((s for _, s in self.pieces), default=0.0)
            self.max_piece = max((len(p) for p, _ in self.pieces), default=0)
            self.id_to_token = [p for p, _ in self.pieces]
        elif kind == "WordPiece":
            self._check(spec, normalizer=_BERT_NORMALIZER_JSON,
                        pre_tokenizer={"type": "BertPreTokenizer"}, decoder=None)
            self.token_to_id = {str(t): int(i) for t, i in model["vocab"].items()}
            self.unk_token = model["unk_token"]
            self.prefix = model.get("continuing_subword_prefix", "##")
            self.max_chars = int(model.get("max_input_chars_per_word", 100))
            self.id_to_token = {i: t for t, i in self.token_to_id.items()}
        else:
            raise _unsupported("model", {k: v for k, v in model.items() if k != "vocab"})
        self.kind = kind
        self.added: Dict[str, int] = {}
        self.special = set()
        for tok in spec.get("added_tokens") or []:
            if tok.get("single_word") or tok.get("lstrip") or tok.get("rstrip") \
                    or tok.get("normalized"):
                raise _unsupported("added token", tok)
            self.added[tok["content"]] = int(tok["id"])
            if tok.get("special"):
                self.special.add(tok["content"])
        self.added_by_id = {i: t for t, i in self.added.items()}
        self._added_rx = (re.compile("|".join(re.escape(t) for t in sorted(
            self.added, key=len, reverse=True))) if self.added else None)

    @staticmethod
    def _check(spec: dict, **want) -> None:
        for key, value in want.items():
            if spec.get(key) != value:
                raise _unsupported(key, spec.get(key))

    @classmethod
    def from_file(cls, path: str) -> "PlainTokenizer":
        return cls(json.loads(Path(path).read_text(encoding="utf-8")))

    def save(self, path: str) -> None:
        Path(path).write_text(json.dumps(self.spec, ensure_ascii=False, indent=2),
                              encoding="utf-8")

    def get_vocab(self) -> Dict[str, int]:
        vocab = dict(self.token_to_id)
        vocab.update(self.added)
        return vocab

    def get_vocab_size(self) -> int:
        return len(self.get_vocab())

    # -- encode ----------------------------------------------------------

    def encode(self, text: str, add_special_tokens: bool = False) -> Encoding:
        """``add_special_tokens`` adds nothing: neither layout has a
        post-processor."""
        ids: List[int] = []
        tokens: List[str] = []
        start = 0
        for m in (self._added_rx.finditer(text) if self._added_rx else ()):
            self._encode_section(text[start:m.start()], ids, tokens)
            ids.append(self.added[m.group()])
            tokens.append(m.group())
            start = m.end()
        self._encode_section(text[start:], ids, tokens)
        return Encoding(ids, tokens)

    def _encode_section(self, text: str, ids: List[int], tokens: List[str]) -> None:
        if not text:
            return
        if self.kind == "Unigram":
            for piece in metaspace_pre_tokenize(text):
                for tok in self._viterbi(piece):
                    tokens.append(tok)
                    ids.append(self._unigram_id(tok))
        else:
            for word in bert_pre_tokenize(bert_normalize(text)):
                for tok in self._wordpiece(word):
                    tokens.append(tok)
                    ids.append(self.token_to_id[tok])

    def _unigram_id(self, tok: str) -> int:
        i = self.token_to_id.get(tok)
        if i is None:
            if self.unk_id is None:
                raise ValueError(f"{tok!r} is not in the vocabulary and the model has no "
                                 "unk_id")
            return self.unk_id
        return i

    def _viterbi(self, s: str) -> List[str]:
        """The best segmentation of ``s``; runs of unknown characters fuse
        into one token (the unknown piece's id)."""
        n = len(s)
        unk_score = self.min_score - _UNK_PENALTY
        # per end position: (best score, start, is_unknown), start None = unreached
        score = [0.0] * (n + 1)
        start_at: List[Optional[int]] = [None] * (n + 1)
        unknown = [False] * (n + 1)
        for i in range(n):
            here = score[i]
            single = False
            for j in range(i + 1, min(n, i + self.max_piece) + 1):
                tid = self.token_to_id.get(s[i:j])
                if tid is None:
                    continue
                cand = self.pieces[tid][1] + here
                if start_at[j] is None or cand > score[j]:
                    score[j], start_at[j], unknown[j] = cand, i, tid == self.unk_id
                if j == i + 1:
                    single = True
            if not single:
                cand = unk_score + here
                if start_at[i + 1] is None or cand > score[i + 1]:
                    if self.unk_id is None:
                        raise ValueError(f"{s[i]!r} is not in the vocabulary and the model "
                                         "has no unk_id")
                    score[i + 1], start_at[i + 1], unknown[i + 1] = cand, i, True
        out: List[str] = []
        fused: List[str] = []
        end = n
        while end > 0:
            begin = start_at[end]
            if unknown[end]:
                fused.append(s[begin:end])
            else:
                if fused:
                    out.append("".join(reversed(fused)))
                    fused = []
                out.append(s[begin:end])
            end = begin
        if fused:
            out.append("".join(reversed(fused)))
        return out[::-1]

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk_token]
        out: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            found = None
            while start < end:
                sub = word[start:end] if start == 0 else self.prefix + word[start:end]
                if sub in self.token_to_id:
                    found = sub
                    break
                end -= 1
            if found is None:
                return [self.unk_token]
            out.append(found)
            start = end
        return out

    # -- decode ----------------------------------------------------------

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in ids:
            i = int(i)
            tok = self.added_by_id.get(i)
            if tok is None:
                if self.kind == "Unigram":
                    tok = self.id_to_token[i] if 0 <= i < len(self.id_to_token) else None
                else:
                    tok = self.id_to_token.get(i)
            if tok is None or (skip_special_tokens and tok in self.special):
                continue
            tokens.append(tok)
        if self.kind == "WordPiece":
            return " ".join(tokens)
        return "".join(tok.replace(METASPACE, "" if k == 0 else " ")
                       for k, tok in enumerate(tokens))
