"""The port's span and counter recorder (core/profiling.py) on the CPU.

A private ``Recorder`` for nesting, parents, ids, the rings' bounds and the
counters; the process's recorder for what the program records: the
micro-batcher's queue spans under concurrent ``submit_many``, and every
span and counter of a ``LakoService`` with retrieval (its decode engine on
stand-in graphs, as the card replays them) and of a reader train step. The
mirror into ``torch.profiler`` is tested with ``start_trace`` in
tests/test_torch_checkpoint.py.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from lako_tpu_torch.core import config as port_config
from lako_tpu_torch.core import profiling
from lako_tpu_torch.models.bert.convert import init_retriever
from lako_tpu_torch.models.t5 import init_fid_t5
from lako_tpu_torch.models.t5 import engine as engine_mod
from lako_tpu_torch.retrieval.index import DenseIndex
from lako_tpu_torch.serve import LakoService, MicroBatcher, ServiceConfig
from lako_tpu_torch.text.tokenizer import WordVocabTokenizer
from lako_tpu_torch.train.optim import make_optimizer
from lako_tpu_torch.train.reader import make_reader_train_step, model_params
from lako_tpu_torch.train.state import TrainState
from tests.fixtures import corpus_sentences, make_examples

TINY = dict(d_model=32, d_kv=8, d_ff=64, num_layers=1, num_decoder_layers=2,
            num_heads=2, relative_attention_num_buckets=8, dropout_rate=0.0)
DATA = dict(n_context=3, text_maxlength=24, answer_maxlength=4)
SERVICE = dict(batch_size=4, max_length=6, n_context=3, dtype="float32",
               decode_backend="engine", decode_chunk_size=2)
DIM = 16

SERVE_SPANS = {"serve.queue", "serve.batch", "serve.retrieve", "serve.collate", "serve.fetch",
               "serve.detokenize", "engine.prefill", "engine.replay"}
TRAIN_SPANS = {"train.fwd_bwd", "train.optimizer"}
COUNTERS = {"serve.batches", "serve.requests", "engine.captures", "engine.replays",
            "engine.cross_kv_bytes", "engine.cross_layers", "engine.norm_sites"}


def _since(t0):
    """The process recorder's spans that started at or after ``t0``."""
    return [s for s in profiling.snapshot()["spans"] if s["start_ns"] >= t0]


def _counted(t0):
    """The process recorder's counter increments at or after ``t0``, summed."""
    out = {}
    for t, name, n in profiling.snapshot()["counts"]:
        if t >= t0:
            out[name] = out.get(name, 0) + n
    return out


def test_nesting_parents_and_ids():
    rec = profiling.Recorder()
    with rec.span("outer", id=7) as outer:
        with rec.span("inner") as inner:
            pass
        with rec.span("inner", id=8):
            pass
    with rec.span("after"):
        pass
    spans = rec.snapshot()["spans"]
    assert [s["name"] for s in spans] == ["inner", "inner", "outer", "after"]
    by_name = {s["sid"]: s for s in spans}
    assert by_name[inner.sid]["parent"] == outer.sid
    assert [s["parent"] for s in spans] == [outer.sid, outer.sid, None, None]
    assert [s["id"] for s in spans] == [None, 8, 7, None]
    assert len({s["sid"] for s in spans}) == 4
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        assert s["stream_ms"] is None and not s["profiled"]
    assert spans[2]["start_ns"] <= spans[0]["start_ns"] <= spans[1]["end_ns"] <= spans[2]["end_ns"]


def test_span_records_when_its_block_raises():
    rec = profiling.Recorder()
    with pytest.raises(ValueError):
        with rec.span("fails"):
            raise ValueError("boom")
    with rec.span("next"):
        pass
    spans = rec.snapshot()["spans"]
    assert [s["name"] for s in spans] == ["fails", "next"]
    assert spans[1]["parent"] is None


def test_rings_are_bounded_and_counters_total():
    rec = profiling.Recorder(spans=4, counts=3)
    for i in range(10):
        with rec.span("s", id=i):
            pass
        assert rec.count("c", 2) == 2 * (i + 1)
    assert rec.count("d") == 1
    snap = rec.snapshot()
    assert [s["id"] for s in snap["spans"]] == [6, 7, 8, 9]
    assert [(name, n) for _, name, n in snap["counts"]] == [("c", 2), ("c", 2), ("d", 1)]
    stamps = [t for t, _, _ in snap["counts"]]
    assert stamps == sorted(stamps)


def test_recorded_spans_keep_their_stamps():
    """``record`` keeps a span from stamps taken elsewhere, with no parent
    even inside an open span, flagged only under a profiler."""
    rec = profiling.Recorder()
    t = profiling.now()
    with rec.span("batch") as batch:
        rec.record("q", t, t + 5, id=0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        rec.record("q", t + 1, t + 9, id=1)
    spans = rec.snapshot()["spans"]
    queued = [s for s in spans if s["name"] == "q"]
    assert [(s["id"], s["parent"], s["start_ns"], s["end_ns"], s["profiled"]) for s in queued] == [
        (0, None, t, t + 5, False), (1, None, t + 1, t + 9, True)]
    assert len({s["sid"] for s in spans}) == 3
    assert next(s for s in spans if s["name"] == "batch")["sid"] == batch.sid


def test_no_record_function_without_a_profiler(monkeypatch):
    """Outside a profiler session a span makes no ``record_function`` (it
    costs ~18 us even then); inside one it does, and is flagged."""
    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name) or real(name))
    rec = profiling.Recorder()
    with rec.span("plain"):
        pass
    assert made == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with rec.span("mirrored"):
            pass
    assert made == ["mirrored"]
    assert [s["profiled"] for s in rec.snapshot()["spans"]] == [False, True]


class _Event:
    """Stands in for ``torch.cuda.Event``: counts the CUDA calls made on it."""

    calls = []

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        _Event.calls.append("record")
        self.t = len(_Event.calls)

    def query(self):
        _Event.calls.append("query")
        return True

    def synchronize(self):
        _Event.calls.append("synchronize")

    def elapsed_time(self, end):
        _Event.calls.append("elapsed_time")
        return float(end.t - self.t)


def test_stream_spans_make_no_cuda_call_under_a_profiler(monkeypatch):
    """A stream span records its two events and reads them once they have
    passed; under a profiler, or when a session begins inside it, it makes
    no CUDA call, keeps no stream time and is flagged, and the in-flight
    spans wait for ``snapshot``."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(_Event, "calls", [])
    cuda = torch.device("cuda", 0)
    rec = profiling.Recorder()
    with rec.span("plain", device=cuda):
        pass
    assert _Event.calls == ["record", "record", "query", "elapsed_time"]
    monkeypatch.setattr(_Event, "query", lambda self: _Event.calls.append("query") or False)
    with rec.span("pending", device=cuda):
        pass
    del _Event.calls[:]
    with rec.span("across", device=cuda):
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        prof.start()
    with rec.span("inside", device=cuda):
        pass
    prof.stop()
    assert _Event.calls == ["record"]           # "across"'s start, before the session
    monkeypatch.setattr(_Event, "query", lambda self: True)
    spans = {s["name"]: s for s in rec.snapshot()["spans"]}
    assert spans["plain"]["stream_ms"] == 1.0 and not spans["plain"]["profiled"]
    assert spans["pending"]["stream_ms"] == 1.0
    for name in ("across", "inside"):
        assert spans[name]["stream_ms"] is None and spans[name]["profiled"], name
    assert len(rec._pool) == 3 and not rec._flight   # every event made, back in the pool


def test_stream_spans_make_no_cuda_call_once_a_profiler_prepares(monkeypatch):
    """The device tracer starts when a session prepares, before
    ``_is_profiler_enabled`` is set: from then until the session stops a
    stream span makes no CUDA call, and the preparation waits for a span's
    CUDA call in progress on another thread."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(_Event, "calls", [])
    cuda = torch.device("cuda", 0)
    rec = profiling.Recorder()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.prepare_trace()
    assert not torch.autograd.profiler._is_profiler_enabled
    with rec.span("prepared", device=cuda):
        pass
    prof.start_trace()
    prof.stop()
    assert _Event.calls == []
    with rec.span("after", device=cuda):
        pass
    assert _Event.calls == ["record", "record", "query", "elapsed_time"]

    entered, release = threading.Event(), threading.Event()

    def blocking_record(self, stream=None):
        entered.set()
        release.wait(10)
        _Event.calls.append("record")
        self.t = len(_Event.calls)

    monkeypatch.setattr(_Event, "record", blocking_record)
    del _Event.calls[:]
    worker = threading.Thread(target=lambda: rec.span("held", device=cuda).__enter__())
    worker.start()
    assert entered.wait(10)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    preparing = threading.Thread(target=prof.prepare_trace)
    preparing.start()
    preparing.join(0.2)
    assert preparing.is_alive()                 # waits for the span's record
    release.set()
    worker.join(10)
    preparing.join(10)
    assert not preparing.is_alive() and _Event.calls == ["record"]
    prof.start_trace()
    prof.stop()
    spans = {s["name"]: s for s in rec.snapshot()["spans"]}
    assert spans["prepared"]["profiled"] and spans["prepared"]["stream_ms"] is None
    assert spans["after"]["stream_ms"] == 1.0 and not spans["after"]["profiled"]


def test_clock_offset_pins_the_profiler_epoch():
    """On the CPU the profiler's event starts read ``time.time_ns()``'s
    epoch: a stamp converted now lies within 1 ms of it."""
    import time

    assert abs(profiling.profiler_ns(profiling.now()) - time.time_ns()) < 1_000_000


class _Service:
    """Answers each batch inside a ``serve.batch`` span and keeps its sid
    with the number of requests it took."""

    def __init__(self):
        self.batches = {}

    def answer_batch(self, requests):
        with profiling.span("serve.batch") as span:
            self.batches[span.sid] = len(requests)
            return [{"answer": r["question"]} for r in requests]


def test_micro_batcher_queue_spans_under_concurrent_clients():
    """Sixteen client threads submit 2-3 requests each, at once, with a
    short switch interval: each request gets one ``serve.queue`` span,
    ending after the batch ahead and before the ``serve.batch`` that
    answered it began, as many of them as that batch took; ids are the
    batcher's sequence numbers."""
    svc = _Service()
    batcher = MicroBatcher(svc, max_batch=4, window_s=0.002)
    t0 = profiling.now()
    answers, errors = {}, []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def client(c):
        try:
            reqs = [{"question": f"{c}-{i}"} for i in range(2 + c % 2)]
            answers[c] = [a["answer"] for a in batcher.submit_many(reqs, timeout=60)]
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    assert all(answers[c] == [f"{c}-{i}" for i in range(2 + c % 2)] for c in range(16))
    n = sum(2 + c % 2 for c in range(16))
    spans = _since(t0)
    queued = [s for s in spans if s["name"] == "serve.queue"]
    batches = sorted((s for s in spans if s["name"] == "serve.batch" and s["sid"] in svc.batches),
                     key=lambda s: s["start_ns"])
    assert sorted(s["id"] for s in queued) == list(range(n))
    assert {b["sid"] for b in batches} == set(svc.batches)
    assert all(s["parent"] is None and s["start_ns"] <= s["end_ns"] for s in queued)
    ahead = t0
    for b in batches:
        took = [s for s in queued if ahead <= s["end_ns"] <= b["start_ns"]]
        assert len(took) == svc.batches[b["sid"]], b
        ahead = b["end_ns"]


def _tokenizer(style="t5"):
    corpus = corpus_sentences() + [
        "question: what sound does the animal make? context: a animal sitting on the grass. fact:",
    ]
    return WordVocabTokenizer.build(corpus, style=style)


def _service():
    tok = _tokenizer()
    t5 = port_config.T5Config(**TINY, vocab_size=tok.vocab_size)
    reader = init_fid_t5(t5, torch.Generator().manual_seed(0))
    with torch.no_grad():
        reader.t5.shared.weight.mul_(0.02)
    rcfg = port_config.RetrieverConfig(bert=port_config.bert_config_tiny(), indexing_dimension=DIM,
                                       question_maxlength=16, passage_maxlength=12)
    retriever = init_retriever(rcfg, torch.Generator().manual_seed(1))
    sentences = corpus_sentences() * 2
    emb = np.random.default_rng(0).normal(size=(len(sentences), DIM)).astype(np.float32)
    return LakoService(ServiceConfig(data=port_config.ReaderDataConfig(**DATA), **SERVICE),
                       t5, reader.state_dict(), tok, retriever=retriever,
                       bert_tokenizer=_tokenizer("bert"), index=DenseIndex(emb, device="cpu"),
                       id_to_sentence=dict(enumerate(sentences)), device="cpu")


class _Graph:
    """Stands in for a captured chunk's CUDA graph: a replay reruns the
    chunk into the outputs the capture left."""

    def __init__(self, engine, st, start, n, tokens, all_done):
        self.args, self.out = (engine, st, start, n), (tokens, all_done)

    def replay(self):
        engine, st, start, n = self.args
        tokens, all_done = engine._run_chunk(st, start, n)
        self.out[0].copy_(tokens)
        self.out[1].copy_(all_done)


def _graphed(engine, monkeypatch):
    def capture(self, st, start, n):
        tokens = torch.zeros((st.tok.shape[0], n), dtype=st.tok.dtype)
        all_done = torch.zeros((), dtype=torch.bool)
        return engine_mod._Chunk(_Graph(self, st, start, n, tokens, all_done), tokens, all_done)

    monkeypatch.setattr(engine_mod.DecodeEngine, "_capture", capture)
    monkeypatch.setattr(engine, "graphed", True)


def test_service_and_train_step_record_every_span_and_counter(monkeypatch):
    """A LakoService with retrieval behind the micro-batcher, its engine on
    stand-in graphs, then a reader train step: every span and counter of
    the program's table is recorded, the service's spans under their batch,
    stream time None on the CPU; the answers are those of the same service
    decoding eagerly."""
    svc = _service()
    qs = [{"question": ex["question"], "caption": ex["caption"]}
          for ex in make_examples(6, n_facts=3, seed=5)]
    eager = [a["answer"] for a in svc.answer_batch(qs[:4])]
    engine = svc._generate.__self__
    _graphed(engine, monkeypatch)
    t0 = profiling.now()
    batcher = MicroBatcher(svc, max_batch=4, window_s=0.05)
    got = [a["answer"] for a in batcher.submit_many(qs[:4], timeout=120)]
    assert got == eager
    batcher.submit_many(qs[4:], timeout=120)

    tok = _tokenizer()
    t5 = port_config.T5Config(**TINY, vocab_size=tok.vocab_size)
    model = init_fid_t5(t5, torch.Generator().manual_seed(2))
    state = TrainState.create(model_params(model), make_optimizer(port_config.OptimConfig(
        optim="adamw", lr=1e-3, scheduler="fixed")))
    step = make_reader_train_step(model)
    ids = torch.randint(2, tok.vocab_size, (2, 2, 12))
    labels = torch.randint(2, tok.vocab_size, (2, 4))
    state, loss = step(state, ids, torch.ones_like(ids, dtype=torch.bool), labels, 0)
    assert torch.isfinite(loss) and state.step == 1

    spans = _since(t0)
    assert SERVE_SPANS | TRAIN_SPANS <= {s["name"] for s in spans}
    delta = _counted(t0)
    assert set(delta) == COUNTERS
    batches = [s for s in spans if s["name"] == "serve.batch"]
    assert delta["serve.batches"] == len(batches) >= 2
    assert delta["serve.requests"] == 6
    replays = [s for s in spans if s["name"] == "engine.replay"]
    assert delta["engine.replays"] == len(replays) >= 2
    assert delta["engine.captures"] >= 1
    prefills = [s for s in spans if s["name"] == "engine.prefill"]
    (st,) = engine._batches.values()
    assert delta["engine.cross_layers"] == len(prefills) * engine.cfg.num_decoder_layers
    assert delta["engine.cross_kv_bytes"] == len(prefills) * st.cross_kv_bytes > 0
    sids = {b["sid"] for b in batches}
    for s in spans:
        if s["name"] in SERVE_SPANS - {"serve.batch", "serve.queue"}:
            assert s["parent"] in sids, s
        assert s["stream_ms"] is None
        assert not s["profiled"]
    ids = sorted(s["id"] for s in batches)
    assert ids == list(range(ids[0], ids[0] + len(ids)))
