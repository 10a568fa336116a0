"""The port's HF tokenizers against the JAX package's and ``tokenizers``
(CPU).

``build-tokenizer --kind unigram|wordpiece`` through both CLIs writes equal
files; each file read by ``tokenizers`` and by the plain reader of
text/tokenizer_json.py gives equal ids and decodes on seeded ASCII,
accented, CJK, punctuation and unknown-character strings (special tokens
and stray ids included), and equal to the JAX ``load_tokenizer``'s; any
component the plain reader does not implement raises, naming it and the
package; without the package, training raises and ``load_tokenizer`` takes
the plain reader and says so.
"""

import contextlib
import io
import json
import logging

import numpy as np
import pytest

tokenizers = pytest.importorskip("tokenizers")

from lako_tpu.pipeline.cli import main as jax_cli
from lako_tpu.text.tokenizer import load_tokenizer as jax_load_tokenizer
from lako_tpu_torch.pipeline.cli import main as port_cli
from lako_tpu_torch.text import tokenizer as port_tokenizer
from lako_tpu_torch.text.tokenizer import HFTokenizer, load_tokenizer
from lako_tpu_torch.text.tokenizer_json import PlainTokenizer
from tests.fixtures import make_examples

WORDS = ["what", "sound", "does", "the", "cat", "make", "dog", "barn", "question:", "context:",
         "fact:", "Héllo", "wörld", "café", "naïve", "Ångström", "东京", "北京大学", "is", "big"]
CLASSES = {
    "ascii": list("abcdefghijklmnopqrstuvwxyz ABCXYZ 0123456789"),
    "accented": list("éèêëöüñçåÅÉØœŒ ſßİı ") + ["é", "ǅ", "Σ"],
    "cjk": list("东京北大学日本語한국어　 ") + ["𠀀", "豈"],
    "punctuation": list(".,?!'\"-:;()[]{}<>/\\@#$%^&*_+=~`|—–…«»¿¡ "),
    "unknown": ["\t", "\n", "\r", "\x00", "�", "​", "́", "­", "\x85", "😀",
                "\U0010ffff", "▁", "▁▁", "</s>", "<pad>", "<unk>", "[MASK]", "[CLS]", "[PAD]",
                "[SEP]", "zq", " ", "  "],
}

# the package loggers as collection found them, before any test ran
_LOGGERS = {n: (lg.handlers[:], lg.level, lg.propagate) for n in ("lako_tpu", "lako_tpu_torch")
            for lg in [logging.getLogger(n)]}


@pytest.fixture(autouse=True)
def _restore_loggers():
    yield
    for n, (handlers, level, propagate) in _LOGGERS.items():
        lg = logging.getLogger(n)
        lg.handlers[:], lg.level, lg.propagate = handlers, level, propagate


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """``build-tokenizer --kind unigram|wordpiece`` through each CLI, on the
    fixture's examples and a seeded mixed-script text file."""
    wd = tmp_path_factory.mktemp("hf_tok")
    rng = np.random.default_rng(0)
    (wd / "train.json").write_text(json.dumps(make_examples(16, n_facts=3)))
    (wd / "extra.txt").write_text("\n".join(" ".join(rng.choice(WORDS, size=8))
                                            for _ in range(200)))
    out = {}
    for kind in ("unigram", "wordpiece"):
        for side, main in (("jax", jax_cli), ("port", port_cli)):
            path = wd / f"{side}_{kind}.json"
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                main(["build-tokenizer", "--from-json", str(wd / "train.json"), "--from-text",
                      str(wd / "extra.txt"), "--kind", kind, "--vocab-size", "160",
                      "--out", str(path)])
            out[side, kind] = (path, json.loads(buf.getvalue().strip().splitlines()[-1]))
    return out


def _plain(path, style="t5"):
    return HFTokenizer(PlainTokenizer.from_file(str(path)), style=style)


def _fast(path, style="t5"):
    return HFTokenizer(tokenizers.Tokenizer.from_file(str(path)), style=style)


def _strings(cls, n=300, seed=0):
    rng = np.random.default_rng(seed)
    alphabet = CLASSES[cls]
    out = []
    for i in range(n):
        k = int(rng.integers(0, 24))
        parts = rng.choice(alphabet, size=k).tolist()
        if i % 2:   # words of the corpus among them
            parts += rng.choice(WORDS, size=int(rng.integers(0, 4))).tolist()
            rng.shuffle(parts)
            out.append(" ".join(parts))
        else:
            out.append("".join(parts))
    return out


def test_cli_files_are_the_trainers_layouts(files):
    """Each CLI's file (the trainers run the same ``tokenizers`` code, but
    not reproducibly: they order ties differently from one run to the next)
    is read by the plain reader, with the vocab size the CLI printed, and
    encodes as the JAX package's ``load_tokenizer`` does."""
    for (side, kind), (path, out) in files.items():
        style = "t5" if kind == "unigram" else "bert"
        plain = _plain(path, style)
        assert plain.vocab_size == out["vocab_size"], (side, kind)
        jax_tok = jax_load_tokenizer(str(path), style=style)
        for text in _strings("ascii", n=40) + _strings("accented", n=40):
            assert plain.encode(text) == jax_tok.encode(text), (side, kind, text)


@pytest.mark.parametrize("kind", ["unigram", "wordpiece"])
@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_plain_reader_matches_tokenizers(files, kind, cls):
    path = str(files["port", kind][0])
    style = "t5" if kind == "unigram" else "bert"
    fast, plain = _fast(path, style), _plain(path, style)
    assert (fast.reader, plain.reader) == ("tokenizers", "plain")
    assert plain.vocab_size == fast.vocab_size
    assert plain._tk.get_vocab() == fast._tk.get_vocab()
    for attr in ("pad_id", "eos_id", "unk_id"):
        assert getattr(plain, attr) == getattr(fast, attr), attr
    jax_tok = jax_load_tokenizer(path, style=style)
    rng = np.random.default_rng(1)
    for text in _strings(cls):
        ids = fast.encode(text)
        assert plain.encode(text) == ids == jax_tok.encode(text), text
        assert plain._tk.encode(text).tokens == fast._tk.encode(text).tokens, text
        noisy = ids + rng.integers(0, fast.vocab_size + 3, size=3).tolist()
        for skip in (True, False):
            assert plain.decode(noisy, skip) == fast.decode(noisy, skip) \
                == jax_tok.decode(noisy, skip), (text, noisy, skip)


def test_hand_made_unigram_vocabulary(tmp_path):
    """Viterbi ties, fused unknown runs and ``▁`` inside the first token,
    on a vocabulary written by hand in the unigram layout."""
    tokenizers = tokenizers = pytest.importorskip("tokenizers")
    vocab = [["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0], ["▁", -1.0], ["a", -2.0],
             ["b", -2.0], ["ab", -4.0], ["▁a", -3.0], ["▁ab", -5.0], ["ba", -4.0],
             ["▁▁", -1.5], ["c▁", -2.0], ["x", -9.0]]
    tk = tokenizers.Tokenizer(tokenizers.models.Unigram([tuple(v) for v in vocab], unk_id=2))
    tk.pre_tokenizer = tokenizers.pre_tokenizers.Metaspace(replacement="▁")
    tk.decoder = tokenizers.decoders.Metaspace(replacement="▁")
    tk.add_special_tokens(["<pad>", "</s>", "<unk>"])
    tk.save(str(tmp_path / "t.json"))
    plain = PlainTokenizer.from_file(str(tmp_path / "t.json"))
    rng = np.random.default_rng(2)
    for _ in range(400):
        text = "".join(rng.choice(list("abx yz▁c") + ["</s>"], size=int(rng.integers(0, 12))))
        want = tk.encode(text, add_special_tokens=False)
        assert plain.encode(text).ids == want.ids, text
        ids = want.ids + rng.integers(0, len(vocab), size=4).tolist()
        for skip in (True, False):
            assert plain.decode(ids, skip) == tk.decode(ids, skip_special_tokens=skip), ids


@pytest.mark.parametrize("where,component", [
    ("normalizer", {"type": "Precompiled", "precompiled_charsmap": "AAAA"}),
    ("post_processor", {"type": "TemplateProcessing", "single": [], "pair": [],
                        "special_tokens": {}}),
    ("pre_tokenizer", {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first",
                       "split": True}),
    ("decoder", {"type": "ByteLevel"}),
    ("model", {"type": "BPE"}),
    ("normalizer", {"type": "BertNormalizer", "clean_text": True, "handle_chinese_chars": True,
                    "strip_accents": True, "lowercase": False}),
    ("added_tokens", [{"id": 0, "content": "<pad>", "single_word": False, "lstrip": True,
                       "rstrip": False, "normalized": False, "special": True}]),
])
def test_unsupported_components_raise(files, tmp_path, where, component):
    kind = "wordpiece" if component.__class__ is dict and component.get(
        "type") == "BertNormalizer" else "unigram"
    spec = json.loads(files["port", kind][0].read_text())
    if where == "model":
        spec["model"] = component
    else:
        spec[where] = component
    (tmp_path / "t.json").write_text(json.dumps(spec))
    name = "lstrip" if where == "added_tokens" else component["type"]
    with pytest.raises(NotImplementedError, match=f"(?s){name}.*`tokenizers`"):
        _plain(tmp_path / "t.json")


def test_without_tokenizers(files, tmp_path, monkeypatch, caplog):
    """Training raises naming the package (the CLI too); load_tokenizer
    takes the plain reader and logs it."""
    fast = _fast(files["port", "unigram"][0])
    monkeypatch.setattr(port_tokenizer, "_tokenizers", lambda: None)
    with pytest.raises(ImportError, match="`tokenizers`"):
        HFTokenizer.train_unigram(["a b c"])
    with pytest.raises(ImportError, match="`tokenizers`"):
        HFTokenizer.train_wordpiece(["a b c"])
    with pytest.raises(ImportError, match="`tokenizers`"):
        port_cli(["build-tokenizer", "--from-text", str(files["port", "unigram"][0]),
                  "--kind", "unigram", "--out", str(tmp_path / "never.json")])
    for lg in ("lako_tpu", "lako_tpu_torch"):     # the CLI cut their propagation
        logging.getLogger(lg).propagate = True
    with caplog.at_level(logging.INFO, logger="lako_tpu_torch"):
        tok = load_tokenizer(str(files["port", "unigram"][0]))
    assert tok.reader == "plain"
    assert "plain tokenizer.json reader" in caplog.text
    assert tok.encode("the cat makes a sound") == fast.encode("the cat makes a sound")
    tok.save(str(tmp_path / "copy.json"))
    assert json.loads((tmp_path / "copy.json").read_text()) == \
        json.loads(files["port", "unigram"][0].read_text())
