"""DPR-style tokenizer for retrieval hit matching: the port of
lako_tpu/text/simple_tokenizer.py (reference src/evaluation.py:31-51).

The original matches ``[\\p{L}\\p{N}\\p{M}]+|[^\\p{Z}\\p{C}]`` with the
``regex`` package, which ``re`` cannot express and which the port does not
use. The same classes come here from ``unicodedata.category`` over code
points: a token is a run of letters, numbers and marks, or any one other
character that is neither a separator (Z*) nor "other" (C*: controls,
format characters, surrogates, private use, unassigned). Pinned to the
original by tests/test_torch_native.py on every code point that Python's
Unicode tables assign; ``regex`` may be built on a newer Unicode, whose
newly assigned characters are unassigned (separators) here.
"""

from __future__ import annotations

import unicodedata
from typing import List


def _kind(c: str) -> str:
    """"w" for a letter, number or mark; "s" for a separator or other; "p"
    for any other character."""
    major = unicodedata.category(c)[0]
    return "w" if major in "LNM" else "s" if major in "ZC" else "p"


class SimpleTokenizer:
    def tokenize(self, text: str, uncased: bool = False) -> List[str]:
        tokens: List[str] = []
        i, n = 0, len(text)
        while i < n:
            kind = _kind(text[i])
            j = i + 1
            if kind == "w":
                while j < n and _kind(text[j]) == "w":
                    j += 1
            if kind != "s":
                tokens.append(text[i:j].lower() if uncased else text[i:j])
            i = j
        return tokens
