"""Word tokenization and Porter stemming for stem-EM and the answer bonus:
the port of lako_tpu/text/stem.py, without NLTK.

``word_tokenize`` is NLTK's ``WordPunctTokenizer`` (``\\w+|[^\\w\\s]+``) on
``re``. ``porter_stem`` is the Porter (1980) suffix stripper in NLTK's
default ``NLTK_EXTENSIONS`` mode, which the JAX package calls through
``nltk.stem.porter.PorterStemmer``: a table of irregular forms (``dying`` →
``die``, ``skies`` → ``sky``), words of two letters or fewer unchanged, and
the extensions to steps 1a, 1b, 1c and 2 marked below. Pinned to NLTK word
for word by tests/test_torch_signal.py. The JAX module falls back to an
identity stemmer without NLTK, which changes stem-EM and the bonus; this one
has no fallback to need.
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import Callable, List, Optional, Sequence, Tuple

_WORD_PUNCT = re.compile(r"\w+|[^\w\s]+")

_VOWELS = frozenset("aeiou")

_IRREGULAR = {
    "sky": ("sky", "skies"),
    "die": ("dying",),
    "lie": ("lying",),
    "tie": ("tying",),
    "news": ("news",),
    "inning": ("innings", "inning"),
    "outing": ("outings", "outing"),
    "canning": ("cannings", "canning"),
    "howe": ("howe",),
    "proceed": ("proceed",),
    "exceed": ("exceed",),
    "succeed": ("succeed",),
}
_POOL = {form: stem for stem, forms in _IRREGULAR.items() for form in forms}


def _consonant(w: str, i: int) -> bool:
    """A letter other than a vowel, and other than a ``y`` after a
    consonant; a run of ``y``s alternates, counted back from ``i``."""
    if w[i] in _VOWELS:
        return False
    if w[i] != "y":
        return True
    flip = False
    while i > 0 and w[i] == "y":
        flip = not flip
        i -= 1
    return (w[i] not in _VOWELS) != flip


def _measure(stem: str) -> int:
    """m in [C](VC){m}[V]."""
    kinds = "".join("c" if _consonant(stem, i) else "v" for i in range(len(stem)))
    return kinds.count("vc")


def _m_gt0(stem: str) -> bool:
    return _measure(stem) > 0


def _m_gt1(stem: str) -> bool:
    return _measure(stem) > 1


def _has_vowel(stem: str) -> bool:
    return any(not _consonant(stem, i) for i in range(len(stem)))


def _double_consonant(w: str) -> bool:
    return len(w) >= 2 and w[-1] == w[-2] and _consonant(w, len(w) - 1)


def _cvc(w: str) -> bool:
    """*o: consonant-vowel-consonant at the end, the last not w, x or y;
    (extension) or a two-letter vowel-consonant word."""
    n = len(w)
    if n >= 3 and _consonant(w, n - 3) and not _consonant(w, n - 2) \
            and _consonant(w, n - 1) and w[-1] not in "wxy":
        return True
    return n == 2 and not _consonant(w, 0) and _consonant(w, 1)


Rule = Tuple[str, str, Optional[Callable[[str], bool]]]


def _first_rule(w: str, rules: Sequence[Rule]) -> str:
    """Apply the rule of the first suffix that ``w`` ends with, if its
    condition holds of the stem; the later rules are not tried."""
    for suffix, repl, cond in rules:
        if w.endswith(suffix):
            stem = w[:len(w) - len(suffix)]
            return stem + repl if cond is None or cond(stem) else w
    return w


def _step1a(w: str) -> str:
    if w.endswith("ies") and len(w) == 4:                 # extension: ties -> tie
        return w[:-3] + "ie"
    return _first_rule(w, (("sses", "ss", None), ("ies", "i", None),
                           ("ss", "ss", None), ("s", "", None)))


def _step1b(w: str) -> str:
    if w.endswith("ied"):                                  # extension
        return w[:-3] + ("ie" if len(w) == 4 else "i")
    if w.endswith("eed"):
        stem = w[:-3]
        return stem + "ee" if _measure(stem) > 0 else w
    for suffix in ("ed", "ing"):
        if w.endswith(suffix) and _has_vowel(w[:-len(suffix)]):
            stem = w[:-len(suffix)]
            break
    else:
        return w
    for suffix, repl in (("at", "ate"), ("bl", "ble"), ("iz", "ize")):
        if stem.endswith(suffix):
            return stem[:-len(suffix)] + repl
    if _double_consonant(stem):
        return stem[:-1] if stem[-1] not in "lsz" else stem
    return stem + "e" if _measure(stem) == 1 and _cvc(stem) else stem


def _step1c(w: str) -> str:
    # extension: y -> i only after a consonant that is not the whole stem
    return _first_rule(w, (("y", "i", lambda s: len(s) > 1 and _consonant(s, len(s) - 1)),))


_STEP2 = (
    ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
    ("izer", "ize"), ("bli", "ble"), ("alli", "al"), ("entli", "ent"), ("eli", "e"),
    ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
    ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"), ("ousness", "ous"),
    ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"), ("fulli", "ful"),
)


def _step2(w: str) -> str:
    if w.endswith("alli") and _m_gt0(w[:-4]):              # extension
        return _step2(w[:-4] + "al")
    rules: List[Rule] = [(s, r, _m_gt0) for s, r in _STEP2]
    # extension: logi -> log when the word without its "ogi" has m > 0
    rules.append(("logi", "log", lambda stem: _m_gt0(w[:-3])))
    return _first_rule(w, rules)


def _step3(w: str) -> str:
    return _first_rule(w, tuple((s, r, _m_gt0) for s, r in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"), ("ical", "ic"),
        ("ful", ""), ("ness", ""))))


_STEP4 = ("al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement", "ment", "ent")
_STEP4_AFTER_ION = ("ou", "ism", "ate", "iti", "ous", "ive", "ize")


def _step4(w: str) -> str:
    rules: List[Rule] = [(s, "", _m_gt1) for s in _STEP4]
    rules.append(("ion", "", lambda stem: _m_gt1(stem) and stem[-1] in "st"))
    rules += [(s, "", _m_gt1) for s in _STEP4_AFTER_ION]
    return _first_rule(w, rules)


def _step5a(w: str) -> str:
    if w.endswith("e"):
        m = _measure(w[:-1])
        if m > 1 or (m == 1 and not _cvc(w[:-1])):
            return w[:-1]
    return w


def _step5b(w: str) -> str:
    return w[:-1] if w.endswith("ll") and _measure(w[:-1]) > 1 else w


@lru_cache(maxsize=1 << 20)
def porter_stem(word: str) -> str:
    w = word.lower()
    if w in _POOL:
        return _POOL[w]
    if len(word) <= 2:
        return w
    for step in (_step1a, _step1b, _step1c, _step2, _step3, _step4, _step5a, _step5b):
        w = step(w)
    return w


def word_tokenize(text: str) -> List[str]:
    return _WORD_PUNCT.findall(text)


def stem_set(text: str) -> set:
    """Stems of the whitespace tokens of ``text``."""
    return {porter_stem(w) for w in text.split(" ")}
