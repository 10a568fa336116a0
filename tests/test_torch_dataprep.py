"""The port's data preparation against the JAX package's (CPU).

The copies of ``retrieval/verbalize.py``, ``retrieval/bm25.py``,
``retrieval/candidates.py``, ``text/vqa_answers.py``, ``data/prompt.py`` and
``text/dictionary.py`` pinned to their originals on seeded inputs, and the
``mine-candidates``, ``prep-answers``, ``truncate-data`` and
``prep-questions`` subcommands through both CLIs, their files equal (JSON
equal, ``.npy`` bitwise, the pickled tuple equal). Both miners rank with
their C++ BM25 when its library loads; here both are held to their Python
paths (``native_available`` patched to False on each side inside the test),
and tests/test_torch_native.py holds the two C++ paths to each other.
"""

import contextlib
import io
import json
import logging
import pickle

import numpy as np
import pytest

import lako_tpu.retrieval.native as jax_native
from lako_tpu.data import prompt as jax_prompt
from lako_tpu.pipeline.cli import main as jax_cli
from lako_tpu.retrieval import bm25 as jax_bm25
from lako_tpu.retrieval import candidates as jax_candidates
from lako_tpu.retrieval import verbalize as jax_verbalize
from lako_tpu.text import dictionary as jax_dictionary
from lako_tpu.text import vqa_answers as jax_vqa
from lako_tpu_torch.data import prompt
from lako_tpu_torch.pipeline.cli import main as port_cli
from lako_tpu_torch.retrieval import bm25, candidates, verbalize
from lako_tpu_torch.retrieval import native as port_native
from lako_tpu_torch.text import dictionary, vqa_answers
from tests.fixtures import ANIMALS, SOUNDS

PLACES = ["grass", "barn", "farm", "pond", "tree", "house", "field", "forest"]
RELATIONS = ["says", "lives in", "AtLocation", "HasA", "big#f", "loud#r", "IsA"]
TEMPLATES = {"AtLocation": "is at", "HasA": "has", "IsA": "is a"}
ANSWERS = ["Two dogs", "the Cat", "yes", "ten", "don't know", "3,000", "1.5", "N/A",
           "red, white", "a (big) cow", "it's 7.30", "wont", "none"]


# the package loggers as collection found them, before any test ran
_LOGGERS = {n: (lg.handlers[:], lg.level, lg.propagate) for n in ("lako_tpu", "lako_tpu_torch")
            for lg in [logging.getLogger(n)]}


@pytest.fixture(autouse=True)
def _restore_loggers():
    """cli.main's init_logger replaces the package loggers' handlers and
    stops their propagation; after each test, give later tests (caplog) the
    loggers as collection found them. (Saved here instead, the state would
    already be the CLI's when a module-scoped fixture ran it first.)"""
    yield
    for n, (handlers, level, propagate) in _LOGGERS.items():
        lg = logging.getLogger(n)
        lg.handlers[:], lg.level, lg.propagate = handlers, level, propagate


@pytest.fixture(autouse=True)
def _python_bm25(monkeypatch):
    """Each miner's Python BM25 path."""
    monkeypatch.setattr(jax_native, "native_available", lambda: False)
    monkeypatch.setattr(port_native, "native_available", lambda: False)


def _triples(n, seed=0):
    """Seeded KG triples over the fixture's animals, sounds and places, some
    of them repeated (equal sentences)."""
    rng = np.random.default_rng(seed)
    words = ANIMALS + SOUNDS + PLACES
    out = [[a, "says", s] for a, s in zip(ANIMALS, SOUNDS)]
    for _ in range(n - len(out)):
        out.append([str(rng.choice(ANIMALS)), str(rng.choice(RELATIONS)), str(rng.choice(words))])
    return out


def _rows(n, seed=1):
    """Cache-format rows {sent, label, img_id, question_id} (one without a
    label, which mining skips)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        a = int(rng.integers(len(ANIMALS)))
        label = {SOUNDS[a]: 1.0, str(rng.choice(SOUNDS)): 0.3} if i != 2 else {}
        rows.append({"sent": f"what sound does the {ANIMALS[a]} make?", "label": label,
                     "img_id": 100 + i, "question_id": 1000 + i})
    return rows


def _captions(rows, seed=2):
    rng = np.random.default_rng(seed)
    caps = {}
    for r in rows:
        where = [str(p) for p in rng.choice(PLACES, size=2)]
        caps[str(r["img_id"])] = [{"caption": f"a {r['sent'].split()[-2]} near the {where[0]}"},
                                  f"an animal in the {where[1]}."]
    return caps


def _annotations(n, seed=3):
    rng = np.random.default_rng(seed)
    anns = []
    for i in range(n):
        picks = rng.choice(ANSWERS, size=int(rng.integers(1, 10)))
        anns.append({"question_id": 1000 + i, "image_id": 100 + i, "answer_type": "other",
                     "question_type": "what", "multiple_choice_answer": str(picks[0]),
                     "answers": [{"answer": str(a)} for a in picks]})
    return anns


def _questions(n):
    return [{"question_id": 1000 + i, "image_id": 100 + i,
             "question": f"What's the {ANIMALS[i % 8]}'s sound, is it {SOUNDS[(3 * i) % 8]}?"}
            for i in range(n)]


def test_verbalize_matches_jax():
    triples = _triples(60)
    four = verbalize.verbalize_triples(triples, TEMPLATES)
    assert four == jax_verbalize.verbalize_triples(triples, TEMPLATES)
    assert {t[3].split()[1] for t in four} >= {"is", "says"}
    assert any("is more big than" in t[3] for t in four)
    assert any("is less loud than" in t[3] for t in four)
    for period in (True, False):
        assert verbalize.corpus_sentences(four, period) == \
            jax_verbalize.corpus_sentences(four, period)
    for rel in ("x#f", "x#r", "x#q", "#", "AtLocation", ""):
        assert verbalize.relation_phrase(rel, TEMPLATES) == \
            jax_verbalize.relation_phrase(rel, TEMPLATES)


@pytest.mark.parametrize("cls", ["BM25Okapi", "BM25L", "BM25Plus"])
def test_bm25_matches_jax(cls):
    """Scores bitwise on every document, batch scores, and the top n with
    the original's tie order on a corpus with repeated documents."""
    rng = np.random.default_rng(4)
    vocab = ANIMALS + SOUNDS + PLACES
    docs = [[str(w) for w in rng.choice(vocab, size=int(rng.integers(2, 9)))] for _ in range(80)]
    docs += docs[:10]                                      # exact ties
    ours, theirs = getattr(bm25, cls)(docs), getattr(jax_bm25, cls)(docs)
    names = [" ".join(d) for d in docs]
    for _ in range(20):
        query = [str(w) for w in rng.choice(vocab + ["unseen"], size=int(rng.integers(1, 6)))]
        np.testing.assert_array_equal(ours.get_scores(query), theirs.get_scores(query))
        assert ours.get_top_n(query, names, n=25) == theirs.get_top_n(query, names, n=25)
        assert ours.get_batch_scores(query, [0, 5, 81]) == \
            theirs.get_batch_scores(query, [0, 5, 81])
    assert ours.idf == theirs.idf


def test_candidates_match_jax_python_path():
    """mine_dataset on seeded rows, captions and OCR text: every example and
    its top-k facts (ids and sentences in rank order) equal."""
    four = verbalize.verbalize_triples(_triples(400, seed=5), TEMPLATES)
    rows = _rows(24)
    caps = {k: [c["caption"] if isinstance(c, dict) else c for c in v]
            for k, v in _captions(rows).items()}
    ocr = {str(rows[0]["img_id"]): "farm sign", str(rows[1]["img_id"]): "pond"}
    every = [len(ex["fact"]) for ex in
             candidates.CandidateMiner(four).mine_dataset(rows, caps, ocr, k=10**6)]
    assert max(every) > 5
    for k in (1, 5, 500):
        got = candidates.CandidateMiner(four).mine_dataset(rows, caps, ocr, k=k)
        want = jax_candidates.CandidateMiner(four).mine_dataset(rows, caps, ocr, k=k)
        assert got == want
        assert len(got) == len(rows) - 1
        assert [len(ex["fact"]) for ex in got] == [min(k, n) for n in every]
    for cap, text in ((["a cat.", "a dog"], ""), ([], "sign"), (["x..", ". ."], "o")):
        assert candidates.build_caption_sentence(cap, text) == \
            jax_candidates.build_caption_sentence(cap, text)
    assert candidates.CandidateMiner(four).top_k("zzz?", "", k=5) == []


def test_vqa_answers_match_jax():
    for a in ANSWERS + ["Yes.", "one, two", "0.5", "dont", "A cat; a dog", "x-ray/(c)"]:
        assert vqa_answers.preprocess_answer(a) == jax_vqa.preprocess_answer(a)
    assert [vqa_answers.get_score(c) for c in range(6)] == [jax_vqa.get_score(c)
                                                           for c in range(6)]
    anns = _annotations(40)
    id2q = {str(q["question_id"]): q["question"] for q in _questions(40)}
    for dataset in ("okvqa", "vqa2.0"):
        for min_occ in (1, 3):
            got = vqa_answers.create_ans2label(anns, dataset, min_occ)
            assert got == jax_vqa.create_ans2label(anns, dataset, min_occ)
            assert vqa_answers.compute_targets(anns, got[0], id2q) == \
                jax_vqa.compute_targets(anns, got[0], id2q)
    with pytest.raises(ValueError, match="unknown dataset"):
        vqa_answers.create_ans2label(anns, "gqa", 1)


def test_prompt_matches_jax():
    rows = _rows(12)
    for split in (False, True):
        assert prompt.prompt_best_answer(rows, split) == jax_prompt.prompt_best_answer(rows, split)
        assert prompt.prompt_all_answers(rows, split) == jax_prompt.prompt_all_answers(rows, split)
        for seed in (0, 3):
            assert prompt.prompt_random_answer(rows, split, seed) == \
                jax_prompt.prompt_random_answer(rows, split, seed)
    assert prompt.truncate_dataset(rows, 5) == jax_prompt.truncate_dataset(rows, 5)


def _glove(path, words, seed=6):
    rng = np.random.default_rng(seed)
    lines = [w + " " + " ".join(f"{x:.6f}" for x in rng.normal(size=5)) for w in words]
    path.write_text("\n".join(lines + ["", "broken"]) + "\n", encoding="utf-8")


def test_dictionary_matches_jax(tmp_path):
    """Dictionary tokenization and the pickled (word2idx, idx2word);
    WordVectors from a GloVe file written for each side, first parsed and
    then read back from its own cache, and the embedding matrix."""
    ours, theirs = dictionary.Dictionary(), jax_dictionary.Dictionary()
    for q in _questions(30):
        assert ours.tokenize(q["question"], add_word=True) == \
            theirs.tokenize(q["question"], add_word=True)
    assert ours.tokenize("the cat's unknown word?") == theirs.tokenize("the cat's unknown word?")
    assert (ours.ntoken, ours.padding_idx, len(ours)) == \
        (theirs.ntoken, theirs.padding_idx, len(theirs))
    ours.dump_to_file(str(tmp_path / "ours.pkl"))
    theirs.dump_to_file(str(tmp_path / "theirs.pkl"))
    with open(tmp_path / "ours.pkl", "rb") as f, open(tmp_path / "theirs.pkl", "rb") as g:
        assert pickle.load(f) == pickle.load(g)
    loaded = dictionary.Dictionary.load_from_file(str(tmp_path / "theirs.pkl"))
    assert (loaded.word2idx, loaded.idx2word) == (theirs.word2idx, theirs.idx2word)

    words = ours.idx2word[::2] + ["zebra", "élan"]
    for side in ("ours", "theirs"):
        _glove(tmp_path / f"{side}.txt", words)
    for _ in range(2):                              # parsed, then from each side's cache
        wv = dictionary.WordVectors(str(tmp_path / "ours.txt"))
        jwv = jax_dictionary.WordVectors(str(tmp_path / "theirs.txt"))
        assert wv.itos == list(jwv.itos) == words
        np.testing.assert_array_equal(wv.vectors, jwv.vectors)
        assert wv.dim == jwv.dim == 5
        np.testing.assert_array_equal(wv.embedding_matrix(ours), jwv.embedding_matrix(theirs))
        np.testing.assert_array_equal(wv["élan"], jwv["élan"])
        np.testing.assert_array_equal(wv["not-in-file"], jwv["not-in-file"])
    with np.load(tmp_path / "ours.npz", allow_pickle=False) as cache:
        assert cache["itos"].dtype.kind == "U"
    assert dictionary.build_id2question(_questions(5)) == \
        jax_dictionary.build_id2question(_questions(5))


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dataprep")
    rows = _rows(24)
    triples = _triples(300, seed=7)
    files = {
        "triples.json": triples,
        "triples_indexed.json": {str(i): t for i, t in enumerate(triples)},
        "templates.json": TEMPLATES,
        "rows.json": rows,
        "captions.json": _captions(rows),
        "ocr.json": {str(rows[3]["img_id"]): "farm"},
        "annotations.json": {"annotations": _annotations(40)},
        "questions.json": {"questions": _questions(40)},
        "questions_list.json": _questions(12),
    }
    for name, obj in files.items():
        (d / name).write_text(json.dumps(obj))
    for side in ("jax", "port"):
        (d / side).mkdir()
        _glove(d / side / "glove.txt", ["what's", "the", "cat's", "sound,", "is", "it", "zebra"])
    return d


SUBCOMMANDS = {
    "mine-candidates": lambda d, o: [
        "mine-candidates", "--triples", str(d / "triples.json"), "--templates",
        str(d / "templates.json"), "--data", str(d / "rows.json"), "--captions",
        str(d / "captions.json"), "--ocr", str(d / "ocr.json"), "--out", str(o / "mined.json"),
        "--corpus-out", str(o / "corpus.json"), "--k", "30"],
    "mine-candidates-corpus-only": lambda d, o: [
        "mine-candidates", "--triples", str(d / "triples_indexed.json"), "--corpus-out",
        str(o / "corpus_indexed.json")],
    "prep-answers": lambda d, o: [
        "prep-answers", "--annotations", str(d / "annotations.json"), "--questions",
        str(d / "questions.json"), "--min-occurence", "2", "--split", "val", "--out-dir",
        str(o / "answers")],
    "truncate-data": lambda d, o: [
        "truncate-data", "--data", str(d / "rows.json"), "--out", str(o / "kept.json"),
        "--keep", "7"],
    "prep-questions": lambda d, o: [
        "prep-questions", "--questions", str(d / "questions_list.json"), "--glove",
        str(o / "glove.txt"), "--out-dir", str(o / "questions")],
}


@pytest.mark.parametrize("name", sorted(SUBCOMMANDS))
def test_dataprep_cli_matches_jax(inputs, name):
    """Each subcommand through both CLIs: the printed JSON (but the paths)
    and every file written equal — JSON equal, .npy bitwise, the pickled
    tuple equal."""
    printed = {side: _cli(main, SUBCOMMANDS[name](inputs, inputs / side))
               for side, main in (("jax", jax_cli), ("port", port_cli))}
    strip = {k: v for k, v in printed["jax"].items() if k != "out"}
    assert {k: v for k, v in printed["port"].items() if k != "out"} == strip
    assert sorted(printed["port"]) == sorted(printed["jax"])
    jax_files = sorted(p.relative_to(inputs / "jax") for p in (inputs / "jax").rglob("*")
                       if p.is_file() and p.suffix != ".npz")
    port_files = sorted(p.relative_to(inputs / "port") for p in (inputs / "port").rglob("*")
                        if p.is_file() and p.suffix != ".npz")
    assert port_files == jax_files
    for rel in jax_files:
        a, b = inputs / "port" / rel, inputs / "jax" / rel
        if rel.suffix == ".json":
            assert json.loads(a.read_text()) == json.loads(b.read_text()), rel
        elif rel.suffix == ".npy":
            got, want = np.load(a), np.load(b)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), rel
        elif rel.suffix == ".pkl":
            with open(a, "rb") as f, open(b, "rb") as g:
                assert pickle.load(f) == pickle.load(g), rel
        else:
            assert a.read_bytes() == b.read_bytes(), rel
    if name == "mine-candidates":
        mined = json.loads((inputs / "port" / "mined.json").read_text())
        assert len(mined) == 23 and max(len(ex["fact"]) for ex in mined) == 30
        assert printed["port"]["examples"] == 23
