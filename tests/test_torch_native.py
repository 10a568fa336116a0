"""The port's host engines and the DPR answer matcher against the JAX
package's (CPU).

The C++ sources are byte-for-byte copies of ``native/``. The port's library
is built here with ``g++`` (``native/Makefile``'s flags) and the JAX
package's ctypes layer is pointed at it (``lako_tpu.retrieval.native._load``
patched), so the JAX code never runs ``make`` in ``native/``: both sides
then run the same machine code, and their results are compared exactly.
``NativeIndex`` / ``HostIndex`` search and rerank on small-integer data,
where ties decide the ids (positional and custom ids); ``bm25_topn_native``
and the candidate miner's C++ path; the obj36 loaders against the JAX
Python loader (malformed rows, CRLF, a missing final newline, filters, the
cache read across packages); ``SimpleTokenizer`` against its ``regex``
original on a mixed-script corpus, and ``has_answer`` /
``calculate_matches``.
"""

import base64
import filecmp
import logging
import unicodedata
from pathlib import Path

import numpy as np
import pytest

import lako_tpu.retrieval.native as jax_native
from lako_tpu.data import vision as jax_vision
from lako_tpu.retrieval import candidates as jax_candidates
from lako_tpu.retrieval.verbalize import verbalize_triples as jax_verbalize
from lako_tpu.text import metrics as jax_metrics
from lako_tpu.text.simple_tokenizer import SimpleTokenizer as JaxSimpleTokenizer
from lako_tpu_torch.data import vision, vision_native
from lako_tpu_torch.ops import _build
from lako_tpu_torch.retrieval import candidates, native
from lako_tpu_torch.retrieval.verbalize import verbalize_triples
from lako_tpu_torch.text import SimpleTokenizer, calculate_matches, has_answer

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _host_library():
    """Built (g++) inside a fixture, not while the module is imported."""
    if not native.native_available():
        pytest.skip("no host C++ compiler to build the host library")


@pytest.fixture
def jax_on_port_library(monkeypatch):
    """The JAX ctypes layer on the port's library (no make in native/)."""
    monkeypatch.setattr(jax_native, "_load", _build.load_host_library)


def test_host_sources_are_byte_copies():
    names = sorted(p.name for p in (REPO / "lako_tpu_torch/csrc/host").glob("*.cpp"))
    assert names == sorted(p.name for p in (REPO / "native").glob("*.cpp"))
    for name in names:
        assert filecmp.cmp(REPO / "lako_tpu_torch/csrc/host" / name, REPO / "native" / name,
                           shallow=False), name
    assert _build.HOST_CXXFLAGS == ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
                                    "-Wextra")
    assert _build.HOST_LDFLAGS == ("-shared", "-pthread")
    assert _build.host_library_path().parent == REPO / "build" / "lako_tpu_torch"


def test_host_build_raises_with_its_command(monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler -O3 -march=native .*mips.cpp"):
        _build.compile_host_library(tmp_path / "lib.so")
    assert not (tmp_path / "lib.so").exists()
    assert not list(tmp_path.glob("lib.so.*.d"))


def _int_data(n, d, q, seed):
    """Small integers: many exact ties, equal on any BLAS."""
    rng = np.random.default_rng(seed)
    emb = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
    emb[n // 2: n // 2 + 5] = emb[3]           # equal rows
    return emb, rng.integers(-2, 3, size=(q, d)).astype(np.float32)


@pytest.mark.parametrize("kind", ["native", "host"])
@pytest.mark.parametrize("custom_ids", [False, True])
def test_index_search_and_rerank_match_jax(jax_on_port_library, kind, custom_ids):
    emb, q = _int_data(3000, 12, 9, seed=1)
    ids = np.arange(1000, 4000, dtype=np.int64)[::-1].copy() if custom_ids else None
    port_cls = native.NativeIndex if kind == "native" else native.HostIndex
    jax_cls = jax_native.NativeIndex if kind == "native" else jax_native.HostIndex
    kw = {} if kind == "native" else {"chunk_size": 700}
    port, jax_idx = port_cls(emb, ids=ids, **kw), jax_cls(emb, ids=ids, **kw)
    for k in (1, 7, 64):
        got, want = port.search(q, k), jax_idx.search(q, k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[1], np.sort(q @ emb.T, axis=1)[:, ::-1][:, :k])
    cand = got[0][:, ::-1].copy()
    rg, rw = port.rerank(cand, q), jax_idx.rerank(cand, q)
    np.testing.assert_array_equal(rg[0], rw[0])
    np.testing.assert_array_equal(rg[1], rw[1])


def test_unknown_rerank_id_raises():
    idx = native.HostIndex(np.eye(4, dtype=np.float32), ids=np.arange(10, 14))
    with pytest.raises(KeyError, match="not present"):
        idx.rerank(np.array([[10, 99]]), np.ones((1, 4), np.float32))


def test_bm25_topn_matches_jax(jax_on_port_library):
    from lako_tpu.retrieval.bm25 import BM25Okapi

    rng = np.random.default_rng(11)
    for _ in range(20):
        docs = [rng.integers(0, 30, size=rng.integers(1, 12)).tolist()
                for _ in range(int(rng.integers(3, 60)))]
        query = rng.integers(0, 40, size=rng.integers(1, 8)).tolist()
        n = int(rng.integers(1, 70))
        got = native.bm25_topn_native(docs, query, n)
        np.testing.assert_array_equal(got, jax_native.bm25_topn_native(docs, query, n))
        scores = BM25Okapi([[str(t) for t in d] for d in docs]).get_scores(
            [str(t) for t in query])
        # equal scores in descending index order
        want = sorted(range(len(docs)), key=lambda i: (-scores[i], -i))[:n]
        np.testing.assert_allclose(scores[got], scores[want], rtol=1e-12)


def _miner_inputs(seed=0):
    rng = np.random.default_rng(seed)
    animals = ["cat", "dog", "cow", "duck", "owl", "bee"]
    places = ["barn", "pond", "tree", "field", "house"]
    rels = ["lives in", "AtLocation", "IsA", "HasA", "says"]
    triples = [(str(rng.choice(animals)), str(rng.choice(rels)),
                str(rng.choice(animals + places))) for _ in range(300)]
    rows = [{"sent": f"where does the {rng.choice(animals)} live?",
             "label": {str(rng.choice(places)): 1.0}, "img_id": str(i), "question_id": i}
            for i in range(24)]
    captions = {str(i): [f"a {rng.choice(animals)} near a {rng.choice(places)}."]
                for i in range(24)}
    return triples, rows, captions


def test_miner_cpp_path_matches_jax(jax_on_port_library, caplog):
    """Both miners on their C++ BM25 mine the same facts, in order."""
    triples, rows, captions = _miner_inputs()
    templates = {"AtLocation": "is at", "IsA": "is a", "HasA": "has"}
    assert jax_native.native_available()
    caplog.set_level(logging.INFO, logger="lako_tpu_torch")
    candidates._logged_paths.clear()
    got = candidates.CandidateMiner(verbalize_triples(triples, templates)).mine_dataset(
        rows, captions, k=20)
    want = jax_candidates.CandidateMiner(jax_verbalize(triples, templates)).mine_dataset(
        rows, captions, k=20)
    assert got == want
    assert candidates.bm25_backend() == "C++"
    assert "ranks with the C++ BM25" in caplog.text


def test_miner_takes_python_without_the_library_and_raises_after_it(monkeypatch, caplog):
    triples, rows, captions = _miner_inputs(1)
    miner = candidates.CandidateMiner(verbalize_triples(triples, {}))
    caplog.set_level(logging.INFO, logger="lako_tpu_torch")
    candidates._logged_paths.clear()
    monkeypatch.setattr(native, "native_available", lambda: False)
    python = miner.mine_dataset(rows, captions, k=20)
    jax_python = jax_candidates.CandidateMiner(jax_verbalize(triples, {}))
    monkeypatch.setattr(jax_native, "native_available", lambda: False)
    assert python == jax_python.mine_dataset(rows, captions, k=20)
    assert "ranks with the Python BM25" in caplog.text
    monkeypatch.setattr(native, "native_available", lambda: True)

    def broken(*args, **kwargs):
        raise RuntimeError("lako_bm25_topn failed")

    monkeypatch.setattr(native, "bm25_topn_native", broken)
    with pytest.raises(RuntimeError, match="lako_bm25_topn failed"):
        miner.mine_dataset(rows, captions, k=20)


def _b64(a):
    return base64.b64encode(a.tobytes()).decode()


def _write_tsv(path, n_rows=5, n_boxes=7, feat_dim=32, seed=0, newline="\n", final=True):
    rs = np.random.default_rng(seed)
    rows = []
    for i in range(n_rows):     # column order: OBJ36_FIELDNAMES
        rows.append("\t".join([
            f"img_{i}", "480", "640", _b64(rs.integers(0, 1600, n_boxes).astype(np.int64)),
            _b64(rs.random(n_boxes).astype(np.float32)),
            _b64(rs.integers(0, 400, n_boxes).astype(np.int64)),
            _b64(rs.random(n_boxes).astype(np.float32)), str(n_boxes),
            _b64(rs.uniform(0, 100, size=(n_boxes, 4)).astype(np.float32)),
            _b64(rs.standard_normal((n_boxes, feat_dim)).astype(np.float32))]))
    path.write_bytes((newline.join(rows) + (newline if final else "")).encode())
    return path


def _assert_rows_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert sorted(ra) == sorted(rb)
        for k in ra:
            if isinstance(ra[k], np.ndarray):
                assert ra[k].dtype == rb[k].dtype, k
                np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)
            else:
                assert ra[k] == rb[k] and type(ra[k]) is type(rb[k]), k


@pytest.mark.parametrize("newline,final", [("\n", True), ("\r\n", False)],
                         ids=["lf", "crlf-no-final-newline"])
def test_obj36_native_matches_jax_python(tmp_path, newline, final):
    tsv = _write_tsv(tmp_path / "f.tsv", n_rows=6, newline=newline, final=final)
    want = jax_vision.load_obj_tsv(str(_write_tsv(tmp_path / "ref.tsv", n_rows=6)),
                                   backend="python")
    got = vision_native.load_obj_tsv_native(str(tsv))
    _assert_rows_equal(want, got)
    assert not any(a.flags.writeable for r in got for a in r.values()
                   if isinstance(a, np.ndarray))
    _assert_rows_equal(want, vision.load_obj_tsv(str(tsv), backend="native"))
    _assert_rows_equal(want, vision.load_obj_tsv(str(tsv), backend="auto"))
    keep = {"img_1", "img_4"}
    _assert_rows_equal(jax_vision.load_obj_tsv(str(tmp_path / "ref.tsv"), img_list=keep,
                                               backend="python"),
                       vision_native.load_obj_tsv_native(str(tsv), img_list=keep))
    assert [r["img_id"] for r in vision_native.load_obj_tsv_native(str(tsv), topk=2)] == \
        ["img_0", "img_1"]
    assert [r["img_id"] for r in vision_native.load_obj_tsv_native(
        str(tsv), topk=1, img_list=keep)] == ["img_1"]


def test_obj36_python_path_cache_and_errors(tmp_path):
    tsv = _write_tsv(tmp_path / "f.tsv", n_rows=3, n_boxes=4, feat_dim=8, seed=3)
    want = jax_vision.load_obj_tsv(str(tsv), backend="python")
    _assert_rows_equal(want, vision.load_obj_tsv(str(tsv), backend="python"))
    # either package reads the other's cache
    vision.load_obj_tsv(str(tsv), backend="native", cache_path=str(tmp_path / "port.pkl"))
    _assert_rows_equal(want, jax_vision.load_obj_tsv("/nonexistent",
                                                     cache_path=str(tmp_path / "port.pkl")))
    jax_vision.load_obj_tsv(str(tsv), backend="python", cache_path=str(tmp_path / "jax.pkl"))
    _assert_rows_equal(want, vision.load_obj_tsv("/nonexistent",
                                                 cache_path=str(tmp_path / "jax.pkl")))
    bad = tmp_path / "bad.tsv"
    bad.write_text("img_0\t480\t640\tnot-base64!!!\n")
    with pytest.raises(ValueError, match="row 0"):
        vision_native.load_obj_tsv_native(str(bad))
    with pytest.raises(ValueError, match="unknown backend"):
        vision.load_obj_tsv(str(tsv), backend="gpu")
    boxes = want[0]["boxes"]
    np.testing.assert_array_equal(vision.normalize_boxes(boxes, 480, 640),
                                  jax_vision.normalize_boxes(boxes, 480, 640))
    label, a2l = {"red": 0.6, "blue": 1.0, "none": 0.3}, {"red": 0, "blue": 2}
    np.testing.assert_array_equal(vision.soft_target(label, a2l, 4),
                                  jax_vision.soft_target(label, a2l, 4))


def _mixed_text(rng, n):
    pools = ["the Cat sat", "naïve café", "éä", "東京タワー", "한국어", "مرحبا",
             "Ωμέγα", "٣٤٥", "½ ²", "—", "«»", "$5.00", "😀👍", " ", " ", " ",
             "　", "​", "­", "‍", "\t\n", "\x00", "", "\U000e0001",
             "i̇", "ﬁ", "ǅ", "'s", "don't", "U.S.A.", "x⃝"]
    return "".join(rng.choice(pools) + rng.choice(["", " ", "-", " "])
                   for _ in range(n))


def test_simple_tokenizer_matches_regex_original():
    rng = np.random.default_rng(5)
    port, original = SimpleTokenizer(), JaxSimpleTokenizer()
    texts = [_mixed_text(rng, int(rng.integers(0, 20))) for _ in range(300)]
    # every code point that Python's Unicode tables assign, once (``regex``
    # may be built on a newer Unicode, which assigns more)
    texts.append("".join(chr(c) for c in range(0x20, 0x110000)
                         if not 0xD800 <= c < 0xE000 and unicodedata.category(chr(c)) != "Cn"))
    for text in texts:
        for uncased in (False, True):
            assert port.tokenize(text, uncased) == original.tokenize(text, uncased)


def test_has_answer_and_calculate_matches_match_jax():
    rng = np.random.default_rng(6)
    words = ["the", "Cat", "café", "café", "東京", "New", "York", "new york", "U.S.",
             "42", "forty-two", "owl's"]
    data = []
    for _ in range(12):
        ctxs = [{"text": None if rng.random() < 0.1 else
                 " ".join(rng.choice(words, size=int(rng.integers(1, 9))))}
                for _ in range(6)]
        data.append({"answers": list(rng.choice(words, size=2)), "ctxs": ctxs})
    tok, jtok = SimpleTokenizer(), JaxSimpleTokenizer()
    for ex in data:
        for doc in ex["ctxs"]:
            if doc["text"] is not None:
                assert has_answer(ex["answers"], doc["text"], tok) == \
                    jax_metrics.has_answer(ex["answers"], doc["text"], jtok)
    got = calculate_matches(data)
    assert got == jax_metrics.calculate_matches(data)
    assert any(any(h) for h in got[1]) and not all(all(h) for h in got[1])
