"""Answer normalization for exact-match metrics: a copy of
lako_tpu/text/normalize.py, pinned to the original by
tests/test_torch_train.py. The one pattern, ``\\b(a|an|the)\\b``, runs on the
standard ``re`` module here (the original uses ``regex``, which the card's
machine lacks); both match word boundaries the same way for ``str``
patterns. The reference's substring stop-word removal is kept verbatim.
"""

from __future__ import annotations

import re
import string

# The reference's stop-word list (src/evaluation.py:21-28): question words, then a
# long tail of 2-char OCR noise tokens, then single characters. Order matters only
# for documentation; membership is what the metric uses.
STOP_WORDS = frozenset([
    "yes", "no", "which", "and", "this", "we", "what", "the", "can", "are",
    "likely", "you", "where", "does", "a", "he", "she", "is", "", "an", "it",
    "some", "that", "there", "how", "other", "or",
    "bu", "ha", "hi", "wa", "ga", "st", "am", "cd", "rv", "hp", "uk", "lo",
    "ft", "dc", "pm", "la", "th", "vw", "ly", "ox", "my", "lg", "dr", '"i',
    "'s", "mm", "rd", "3d", "ny", "ma", "aa", "re", "fo", "dy", "nd", "a ",
    "ii", "ex", "av", "ge", "dj", "tp", "gp", "os", "de", "wi", "un", "ct",
    "pf", "ot", "al", "co", "ye", "hu", "mt", "sa", "bp", "aw", "tx", "ca",
    "ne", "mr", "jp", "cb", "'a", "fe", "af", "ar", "du", "od", "vy", "fa",
    "bi", "ti", "si", "ac", "pa", "tw", "nw", "iv", "lb", "  ", " ", "ep",
    "op", "te", '"e', '"a', "hd", "oj", "rm", "a'", "o'", "ba", "f5", "ce",
    "yo", "#2", "mn", "og", "pt", "sb", "ds", "$1", "em", "sd", "ho", "di",
    "pn", "db", "ae", "4h", "cv", "el", "rc", "le", "v8", "kk", "na", "vh",
    "bt", "qr", "om", "kc", "ou", "ln", "b5", "pu", "mo", '"1', "ah", "kg",
    "ax", "pl", "li", "sw", "fc", "jr", "sk", "lf", "jt", "7,", "mu", "aq",
    "pj", "ky", "jc", "ab", "ol", "1.", "2.", "ay", "ms", "4,", "bc", "bo",
    "km", "ty", "ll", "hr", "oz", "fi", "cm", "yr", "pb", "su", "k9", "k2",
    "sr", "uv", "lu", "j'", "mg", "jk", "ri", "md", "â½", "hs", "ed", "eg",
    "fu", "gb", "e2", "sm", "jo", "'i", "fm", "xl", "bb", "5g", "da", "et",
    "ro", "a1", "io", "a2", "s8", "v1", "vx", "ta", "ww", "cy", "4'", "h4",
    "ie", "ki", "4e", "#1", "rt", "eu", "ag", "eo", "i3", "o2", "ea", "x3",
    "'o", "nn", "u-", "$2", "sl", ">>", "ec", "nj", "za", "ck", "mc", "ra",
    "ek", "$4", "4o", "po", "kw", "sq", "mj", 'e"', "nu", "xx", "b6", "ei",
    "5%", "1x", "cn", '"w', "m'", "i", "n", "t", "s", "o", ",", "m", '"',
    "&", "b", "w", "e", "c", "l", "y", "p", "-", "x", "d", "r", "v", "g",
    "k", "f", "#", "h", "u", "j", "/", "q", "!", "@", "(", "z", ":", "of",
    "with",
])

_ARTICLE_RE = re.compile(r"\b(a|an|the)\b")
_PUNCT = set(string.punctuation)


def _remove_stopwords(text: str) -> str:
    # Parity note: like the reference (src/evaluation.py:140-145) this removes each
    # stop word as a *substring* of the running text, not token-wise.
    for word in text.split():
        if word in STOP_WORDS:
            text = text.replace(word, "")
    return text


def normalize_answer(s: str, dele_sw: bool = False) -> str:
    """lower → strip punctuation → strip articles → (optional stop words) → squeeze ws."""
    text = s.lower()
    text = "".join(ch for ch in text if ch not in _PUNCT)
    text = _ARTICLE_RE.sub(" ", text)
    if dele_sw:
        text = _remove_stopwords(text)
    return " ".join(text.split())
