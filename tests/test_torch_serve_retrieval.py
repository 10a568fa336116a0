"""Retrieval inside the port's LakoService against the JAX service's (f32, CPU).

Both services hold the same reader (one flax init through
``models.t5.params_from_jax``), the same BERT retriever (one flax init
through ``models.bert.params_from_jax``) and the same seeded fact index. A
request without facts gets the index's top ``n_context`` for its question
and caption: the ids equal the JAX service's, the scores within 1e-5, and
the answers equal. Also mixed batches, the micro-batcher, the HTTP endpoint
and the ``serve`` subcommand on the CPU, and its refusal without a card.
"""

import contextlib
import io
import json
import logging
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lako_tpu.core import config as jax_config
from lako_tpu.models.retriever import Retriever as JaxRetriever
from lako_tpu.models.t5.model import FiDT5 as JaxFiDT5
from lako_tpu.retrieval.index import DenseIndex as JaxDenseIndex
from lako_tpu.serve import LakoService as JaxLakoService
from lako_tpu.serve import ServiceConfig as JaxServiceConfig
from lako_tpu_torch import serve as serve_mod
from lako_tpu_torch.core import config as port_config
from lako_tpu_torch.core.checkpoint import save_checkpoint
from lako_tpu_torch.models import bert as port_bert
from lako_tpu_torch.models import t5 as port_t5
from lako_tpu_torch.models.retriever import Retriever
from lako_tpu_torch.pipeline.cli import main as port_cli
from lako_tpu_torch.retrieval.index import DenseIndex
from lako_tpu_torch.serve import LakoService, MicroBatcher, ServiceConfig
from lako_tpu_torch.text.tokenizer import WordVocabTokenizer
from tests.fixtures import corpus_sentences, make_examples, make_tokenizer

TINY = dict(d_model=32, d_kv=8, d_ff=64, num_layers=1, num_decoder_layers=2,
            num_heads=2, relative_attention_num_buckets=8, dropout_rate=0.0)
DATA = dict(n_context=3, text_maxlength=24, answer_maxlength=4, stream=2)
# the ServiceConfig fields the serve subcommand takes from a ReaderTrainConfig
READER = dict(eval_max_length=6, dtype="float32", decode_backend="engine",
              decode_kv_dtype="int8", data=DATA)
SERVICE = dict(batch_size=4, max_length=6, n_context=3, dtype="float32",
               decode_backend="engine", decode_kv_dtype="int8")
DIM = 16
# inside tiny BERT's 128 positions (the default 130 is past them)
LENGTHS = dict(question_maxlength=16, passage_maxlength=12)
SCORE_ATOL = 1e-5


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


def _port_tokenizer(style="t5"):
    corpus = corpus_sentences() + [
        "question: what sound does the animal make? context: a animal sitting on the grass. fact:",
    ]
    return WordVocabTokenizer.build(corpus, style=style)


def _corpus():
    """The fixture's eight facts and eight distractors."""
    extra = [f"the {a} is near the {b}." for a, b in zip(
        ["cat", "dog", "cow", "duck", "frog", "bee", "owl", "wolf"],
        ["barn", "tree", "pond", "grass", "river", "field", "house", "road"])]
    return corpus_sentences() + extra


def _questions(n, seed=0):
    """Requests without facts."""
    return [{"question": ex["question"], "caption": ex["caption"]}
            for ex in make_examples(n, n_facts=3, seed=seed)]


@pytest.fixture(scope="module")
def world():
    """(JAX service, port service, the weights and index they share)."""
    jtok, jbtok = make_tokenizer(), make_tokenizer(style="bert")
    t5 = dict(TINY, vocab_size=jtok.vocab_size)
    params = JaxFiDT5(jax_config.T5Config(**t5)).init(
        jax.random.PRNGKey(0), np.zeros((1, 2, 24), np.int32),
        np.ones((1, 2, 24), bool), np.zeros((1, 4), np.int32))["params"]
    # scaled down so that the random model's answers vary with the question
    params["t5"]["shared"]["embedding"] = params["t5"]["shared"]["embedding"] * 0.02
    rcfg = jax_config.RetrieverConfig(bert=jax_config.bert_config_tiny(), indexing_dimension=DIM,
                                      **LENGTHS)
    rparams = JaxRetriever(rcfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), bool),
        jnp.zeros((1, 1, 8), jnp.int32), jnp.ones((1, 1, 8), bool))["params"]
    sentences = _corpus()
    emb = np.random.default_rng(0).normal(size=(len(sentences), DIM)).astype(np.float32)
    id_to_sentence = dict(enumerate(sentences))
    jsvc = JaxLakoService(
        JaxServiceConfig(data=jax_config.ReaderDataConfig(**DATA), **SERVICE),
        jax_config.T5Config(**t5), params, jtok,
        retriever=JaxRetriever(rcfg), retriever_params=rparams, bert_tokenizer=jbtok,
        index=JaxDenseIndex(emb), id_to_sentence=id_to_sentence)
    prcfg = port_config.RetrieverConfig(bert=port_config.bert_config_tiny(),
                                        indexing_dimension=DIM, **LENGTHS)
    with torch.device("meta"):
        retriever = Retriever(prcfg)
    psvc = LakoService(
        ServiceConfig(data=port_config.ReaderDataConfig(**DATA), **SERVICE),
        port_config.T5Config(**t5), port_t5.params_from_jax(params), _port_tokenizer(),
        retriever=retriever, retriever_params=port_bert.params_from_jax(rparams),
        bert_tokenizer=_port_tokenizer("bert"), index=DenseIndex(emb, device="cpu"),
        id_to_sentence=id_to_sentence, device="cpu")
    return dict(jax=jsvc, port=psvc, params=params, rparams=rparams, emb=emb,
                sentences=sentences, t5=t5)


def _same_facts(got, want):
    """Per request: the fact ids and sentences equal, the scores within
    SCORE_ATOL."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [(f["id"], f["sentence"]) for f in g] == [(f["id"], f["sentence"]) for f in w]
        assert all(sorted(f) == ["id", "score", "sentence"] for f in g)
        np.testing.assert_allclose([f["score"] for f in g], [f["score"] for f in w],
                                   rtol=0, atol=SCORE_ATOL)


def test_retrieved_facts_match_jax(world):
    """Ten questions: each one's top n_context facts, ids in order equal,
    scores within 1e-5; the retriever lives on the service's device."""
    qs = _questions(10, seed=3)
    got = world["port"].retrieve_facts(qs)
    want = world["jax"].retrieve_facts(qs)
    _same_facts(got, want)
    assert all(len(g) == 3 for g in got)
    assert len({tuple(f["id"] for f in g) for g in got}) > 1
    assert next(world["port"].retriever.parameters()).device == torch.device("cpu")


def test_answers_with_retrieval_match_jax(world):
    """Six requests without facts at batch_size 4: the answers and the
    facts each answer cites equal the JAX service's; the answers equal those
    the port gives when the retrieved facts are passed in."""
    qs = _questions(6, seed=4)
    got = world["port"].answer_batch(qs)
    want = world["jax"].answer_batch(qs)
    assert [g["answer"] for g in got] == [w["answer"] for w in want]
    _same_facts([g["facts"] for g in got], [w["facts"] for w in want])
    explicit = [dict(q, fact=g["facts"]) for q, g in zip(qs, got)]
    assert [g["answer"] for g in world["port"].answer_batch(explicit)] == \
        [g["answer"] for g in got]


def test_mixed_batch_matches_jax(world):
    """Requests with and without facts in one batch: those with facts keep
    them, the others retrieve; answers and facts equal the JAX service's."""
    qs = _questions(5, seed=6)
    given = make_examples(5, n_facts=3, seed=6)
    reqs = [dict(q, fact=g["fact"]) if i % 2 else q for i, (q, g) in enumerate(zip(qs, given))]
    got = world["port"].answer_batch(reqs)
    want = world["jax"].answer_batch(reqs)
    assert [g["answer"] for g in got] == [w["answer"] for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        if i % 2:
            assert g["facts"] == w["facts"] == given[i]["fact"][:3]
        else:
            _same_facts([g["facts"]], [w["facts"]])


@pytest.mark.parametrize("kind", ["native", "host"])
def test_host_indexes_behind_the_service_match_jax(world, kind):
    """A NativeIndex or HostIndex over the same embeddings takes numpy
    queries on the host: the facts equal the JAX service's (DenseIndex)."""
    from lako_tpu_torch.retrieval import native

    if kind == "native" and not native.native_available():
        pytest.skip("no host C++ compiler to build the host library")
    cls = native.NativeIndex if kind == "native" else native.HostIndex
    svc, dense = world["port"], world["port"].index
    svc.index = cls(world["emb"])
    try:
        qs = _questions(10, seed=3)
        _same_facts(svc.retrieve_facts(qs), world["jax"].retrieve_facts(qs))
    finally:
        svc.index = dense


def test_k_is_capped_by_the_index(world):
    """An index smaller than n_context returns all its rows, as in JAX."""
    emb = world["emb"][:2]
    ids = {0: world["sentences"][0], 1: world["sentences"][1]}
    jsvc = JaxLakoService(world["jax"].cfg, jax_config.T5Config(**world["t5"]), world["params"],
                          make_tokenizer(), retriever=world["jax"].retriever,
                          retriever_params=world["rparams"], bert_tokenizer=make_tokenizer(
                              style="bert"), index=JaxDenseIndex(emb), id_to_sentence=ids)
    psvc = LakoService(world["port"].cfg, port_config.T5Config(**world["t5"]),
                       port_t5.params_from_jax(world["params"]), _port_tokenizer(),
                       retriever=world["port"].retriever, bert_tokenizer=_port_tokenizer("bert"),
                       index=DenseIndex(emb, device="cpu"), id_to_sentence=ids, device="cpu")
    qs = _questions(3, seed=8)
    got = psvc.retrieve_facts(qs)
    _same_facts(got, jsvc.retrieve_facts(qs))
    assert all(len(g) == 2 for g in got)
    assert [g["answer"] for g in psvc.answer_batch(qs)] == \
        [w["answer"] for w in jsvc.answer_batch(qs)]


def test_microbatcher_with_retrieval(world):
    """Concurrent submits without facts share answer_batch calls and each
    gets the JAX service's answer and facts."""
    psvc = world["port"]
    calls = []

    class Counting:
        cfg = psvc.cfg

        def answer_batch(self, reqs):
            calls.append(len(reqs))
            return psvc.answer_batch(reqs)

    mb = MicroBatcher(Counting(), max_batch=4, window_s=0.25)
    qs = _questions(4, seed=9)
    results = [None] * 4
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, mb.submit(qs[i])))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert sum(calls) == 4 and len(calls) < 4
    want = world["jax"].answer_batch(qs)
    assert [r["answer"] for r in results] == [w["answer"] for w in want]
    _same_facts([r["facts"] for r in results], [w["facts"] for w in want])


@pytest.fixture(scope="module")
def serve_files(world, tmp_path_factory):
    """The port's checkpoints, index, corpus, tokenizers and configs of the
    world's services, as the serve subcommand reads them."""
    d = tmp_path_factory.mktemp("torch_serve_cli")
    save_checkpoint(str(d / "reader"), "r", port_t5.params_from_jax(world["params"]))
    save_checkpoint(str(d / "retriever"), "r", port_bert.params_from_jax(world["rparams"]))
    DenseIndex(world["emb"], device="cpu").save(str(d / "index"))
    (d / "corpus.json").write_text(json.dumps(
        [{"sentence": s, "id": i} for i, s in enumerate(world["sentences"])]))
    _port_tokenizer().save(str(d / "tok.json"))
    _port_tokenizer("bert").save(str(d / "btok.json"))
    (d / "t5.json").write_text(json.dumps(world["t5"]))
    (d / "reader.json").write_text(json.dumps(READER))
    (d / "retriever.json").write_text(json.dumps(
        {"retriever": dict(bert=vars(port_config.bert_config_tiny()), indexing_dimension=DIM,
                       **LENGTHS)}))
    return d


def _serve_argv(d, *extra):
    return ["serve", "--config", str(d / "reader.json"), "--t5-config", str(d / "t5.json"),
            "--model-path", str(d / "reader" / "checkpoint" / "r"),
            "--tokenizer", str(d / "tok.json"),
            "--retriever-config", str(d / "retriever.json"),
            "--retriever-path", str(d / "retriever" / "checkpoint" / "r"),
            "--bert-tokenizer", str(d / "btok.json"), "--index", str(d / "index"),
            "--corpus", str(d / "corpus.json"), "--batch-size", "4", *extra]


def test_serve_subcommand_answers_like_jax(world, serve_files, monkeypatch):
    """``serve --device cpu --port 0`` in a thread: it prints its URL with the
    bound port, and one POST without facts gets the JAX service's answer and
    facts."""
    servers = []
    make = serve_mod.make_http_server

    def keep(*args, **kw):
        servers.append(make(*args, **kw))
        return servers[-1]

    monkeypatch.setattr(serve_mod, "make_http_server", keep)
    out = io.StringIO()

    def run():
        with contextlib.redirect_stdout(out):
            port_cli(_serve_argv(serve_files, "--port", "0", "--device", "cpu"))

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        for _ in range(600):
            if servers or not thread.is_alive():
                break
            threading.Event().wait(0.05)
        assert servers, "serve did not start"
        port = servers[0].server_address[1]
        req = _questions(1, seed=11)[0]
        http = urllib.request.Request(
            f"http://127.0.0.1:{port}/answer", data=json.dumps(req).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(http, timeout=60) as resp:
            got = json.loads(resp.read())
    finally:
        if servers:
            servers[0].shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()
    printed = json.loads(out.getvalue().strip().splitlines()[-1])
    assert printed == {"serving": f"http://127.0.0.1:{port}/answer"}
    want = world["jax"].answer_batch([req])
    assert [g["answer"] for g in got] == [w["answer"] for w in want]
    _same_facts([g["facts"] for g in got], [w["facts"] for w in want])


def test_serve_subcommand_refusals(serve_files, monkeypatch):
    """Without --device and without a card, serve raises as resolve_device
    does; --mesh-model 2 is refused as the service refuses it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(_serve_argv(serve_files))
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        port_cli(_serve_argv(serve_files, "--device", "cpu", "--mesh-model", "2"))
