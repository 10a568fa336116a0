"""The port's serving path vs the JAX package's, plus the port's own contracts:
copied framework-free modules pinned to their originals, an import that pulls
in no JAX, and a kernel build that never falls back."""

import dataclasses
import json
import logging
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from lako_tpu.core import config as jax_config
from lako_tpu.data.collator import ReaderCollator as JaxReaderCollator
from lako_tpu.data.dataset import ReaderDataset as JaxReaderDataset
from lako_tpu.models.t5.model import FiDT5 as JaxFiDT5
from lako_tpu.serve import LakoService as JaxLakoService
from lako_tpu.serve import ServiceConfig as JaxServiceConfig
from lako_tpu_torch.core import config as port_config
from lako_tpu_torch.data import ReaderCollator, ReaderDataset
from lako_tpu_torch.models.t5 import params_from_jax
from lako_tpu_torch.ops import _build
from lako_tpu_torch.serve import LakoService, MicroBatcher, ServiceConfig, make_http_server
from lako_tpu_torch.text.tokenizer import WordVocabTokenizer
from tests.fixtures import corpus_sentences, make_examples, make_tokenizer

REPO = Path(__file__).resolve().parents[1]
TINY = dict(d_model=32, d_kv=8, d_ff=64, num_layers=1, num_decoder_layers=2,
            num_heads=2, relative_attention_num_buckets=8, dropout_rate=0.0)
DATA = dict(n_context=3, text_maxlength=24, answer_maxlength=4, stream=2)


def _port_tokenizer():
    corpus = corpus_sentences() + [
        "question: what sound does the animal make? context: a animal sitting on the grass. fact:",
    ]
    return WordVocabTokenizer.build(corpus)


def _requests(n, seed=0):
    return [{"question": ex["question"], "caption": ex["caption"], "fact": ex["fact"]}
            for ex in make_examples(n, n_facts=3, seed=seed)]


@pytest.fixture(scope="module")
def services():
    """(JAX service, port service) with the same weights, f32, int8 K/V."""
    jtok = make_tokenizer()
    t5 = dict(TINY, vocab_size=jtok.vocab_size)
    params = JaxFiDT5(jax_config.T5Config(**t5)).init(
        jax.random.PRNGKey(0), np.zeros((1, 2, 24), np.int32),
        np.ones((1, 2, 24), bool), np.zeros((1, 4), np.int32))["params"]
    # scaled down so that the random model's answers vary with the question
    params["t5"]["shared"]["embedding"] = params["t5"]["shared"]["embedding"] * 0.02
    common = dict(batch_size=4, max_length=6, n_context=3, dtype="float32",
                  decode_backend="engine", decode_kv_dtype="int8")
    jsvc = JaxLakoService(
        JaxServiceConfig(data=jax_config.ReaderDataConfig(**DATA), **common),
        jax_config.T5Config(**t5), params, jtok)
    psvc = LakoService(
        ServiceConfig(data=port_config.ReaderDataConfig(**DATA), **common),
        port_config.T5Config(**t5), params_from_jax(params), _port_tokenizer(), device="cpu")
    return jsvc, psvc, params


def test_answers_match_jax_service(services):
    """Six requests at batch_size 4 (one full batch, one partial): the port's
    answers equal the JAX service's; with the fused int8 cross-attention the
    tokens agree on >= 0.9 of positions."""
    jsvc, psvc, params = services
    reqs = _requests(6)
    want = jsvc.answer_batch(reqs)
    got = psvc.answer_batch(reqs)
    assert [g["answer"] for g in got] == [w["answer"] for w in want]
    assert len({g["answer"] for g in got}) > 1
    assert [g["facts"] for g in got] == [w["facts"] for w in want]

    fused = LakoService(dataclasses.replace(psvc.cfg, decode_fused_cross=True),
                        port_config.T5Config(**dict(TINY, vocab_size=psvc.tokenizer.vocab_size)),
                        params_from_jax(params), psvc.tokenizer, device="cpu")
    _, tok_plain = psvc.generate_tokens(reqs)
    _, tok_fused = fused.generate_tokens(reqs)
    assert tok_plain.shape == (6, 5)
    assert (tok_plain == tok_fused).mean() >= 0.9


def test_http_round_trip(services):
    _, psvc, _ = services
    server = make_http_server(psvc, "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = _requests(1, seed=5)[0]
        http = urllib.request.Request(
            f"http://127.0.0.1:{port}/answer", data=json.dumps(req).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(http, timeout=30) as resp:
            out = json.loads(resp.read())
        assert out == psvc.answer_batch([req])
        bad = urllib.request.Request(f"http://127.0.0.1:{port}/answer", data=b"not json")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=30)
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_microbatcher_coalesces_and_isolates(services):
    """Concurrent submits share answer_batch calls; a bad request gets its
    own error while its batch-mates keep their answers."""
    _, psvc, _ = services
    calls = []

    class Counting:
        cfg = psvc.cfg

        def answer_batch(self, reqs):
            calls.append(len(reqs))
            return psvc.answer_batch(reqs)

    mb = MicroBatcher(Counting(), max_batch=4, window_s=0.25)
    reqs = _requests(4, seed=7)
    results = [None] * 4
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, mb.submit(reqs[i])))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert results == psvc.answer_batch(reqs)
    assert sum(calls) == 4 and len(calls) < 4
    out = MicroBatcher(psvc, max_batch=4, window_s=0.05).submit_many(
        [reqs[0], {"no_question_key": True}, reqs[1]])
    assert out[0] == results[0] and out[2] == results[1]
    assert out[1]["index"] == 1 and "error" in out[1]


def test_unported_service_options_raise(services):
    """What the service still refuses: tensor-parallel serving (ROADMAP item
    11); retrieval is absent (no facts)."""
    _, psvc, params = services
    t5 = port_config.T5Config(**dict(TINY, vocab_size=psvc.tokenizer.vocab_size))
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        LakoService(dataclasses.replace(psvc.cfg, mesh_model=2), t5, params_from_jax(params),
                    psvc.tokenizer, device="cpu")
    assert psvc.retrieve_facts([{"question": "q"}]) == [[]]


@pytest.mark.parametrize("field,other,max_length", [
    ("decode_self_attn_impl", "gather", 10),
    ("policy_chunked_min_occupancy", 3, 11),
])
def test_reference_service_fields(services, field, other, max_length):
    """Every field of the JAX ServiceConfig exists in the port's with the same
    default. decode_self_attn_impl reaches the beam engine under beam search
    (greedy ignores it); policy_chunked_min_occupancy is the "auto" policy's
    threshold, and is checked under either policy."""
    _, psvc, params = services
    port_fields = {f.name: f.default for f in dataclasses.fields(ServiceConfig)}
    for f in dataclasses.fields(JaxServiceConfig):
        assert f.name in port_fields and port_fields[f.name] == f.default, f.name
    t5 = port_config.T5Config(**dict(TINY, vocab_size=psvc.tokenizer.vocab_size))
    sd = params_from_jax(params)
    cfg = dataclasses.replace(psvc.cfg, max_length=max_length, **{field: other})
    reqs = _requests(2)
    if field == "decode_self_attn_impl":
        greedy = LakoService(cfg, t5, sd, psvc.tokenizer, device="cpu")
        base = LakoService(dataclasses.replace(cfg, decode_self_attn_impl="allslots"),
                           t5, sd, psvc.tokenizer, device="cpu")
        assert greedy.answer_batch(reqs) == base.answer_batch(reqs)
        beam_cfg = dataclasses.replace(cfg, num_beams=2, decode_kv_dtype="native")
        beams = LakoService(beam_cfg, t5, sd, psvc.tokenizer, device="cpu")
        allslots = LakoService(dataclasses.replace(beam_cfg, decode_self_attn_impl="allslots"),
                               t5, sd, psvc.tokenizer, device="cpu")
        np.testing.assert_array_equal(beams.generate_tokens(reqs)[1],
                                      allslots.generate_tokens(reqs)[1])
    else:
        fixed = LakoService(cfg, t5, sd, psvc.tokenizer, device="cpu")
        assert fixed._policy_threshold == 3 and not fixed._policy
        fixed.answer_batch(reqs)
        assert list(fixed.policy_decisions) == []
        for bad, match in ((0, "must be >= 1"), (5, "can never be reached")):
            with pytest.raises(ValueError, match=match):
                LakoService(dataclasses.replace(cfg, **{field: bad}), t5, sd,
                            psvc.tokenizer, device="cpu")


def _policy_factories(policy="auto", threshold=3, batch_size=4, num_beams=1):
    """The JAX package's engine_policy test setup (tests/test_serve.py): the
    constructors of the JAX service and of the port's, with the same
    weights."""
    jtok = make_tokenizer()
    kw = dict(vocab_size=jtok.vocab_size, d_model=32, d_kv=8, d_ff=64, num_layers=1,
              num_decoder_layers=1, num_heads=2, relative_attention_num_buckets=8,
              dropout_rate=0.0)
    data = dict(n_context=2, text_maxlength=16, answer_maxlength=4, stream=2)
    params = JaxFiDT5(jax_config.T5Config(**kw)).init(
        jax.random.PRNGKey(0), np.zeros((1, 2, 16), np.int32), np.ones((1, 2, 16), bool),
        np.zeros((1, 4), np.int32))["params"]
    common = dict(batch_size=batch_size, max_length=6, n_context=2, dtype="float32",
                  engine_policy=policy, policy_chunked_min_occupancy=threshold,
                  decode_chunk_size=2, num_beams=num_beams)
    return (lambda: JaxLakoService(
                JaxServiceConfig(data=jax_config.ReaderDataConfig(**data), **common),
                jax_config.T5Config(**kw), params, jtok),
            lambda: LakoService(
                ServiceConfig(data=port_config.ReaderDataConfig(**data), **common),
                port_config.T5Config(**kw), params_from_jax(params), _port_tokenizer(),
                device="cpu"))


def _policy_services(**kw):
    return tuple(build() for build in _policy_factories(**kw))


def _port_warnings(caplog):
    return " ".join(r.getMessage() for r in caplog.records if r.name == "lako_tpu_torch")


POLICY_REQUESTS = [{"question": f"what sound does animal {i} make?", "caption": "an animal",
                    "fact": [{"sentence": "a cow says moo.", "id": 1}]} for i in range(4)]


def test_engine_policy_auto_matches_jax():
    """engine_policy="auto": full-length below the occupancy threshold,
    chunked at or above it; the decisions and the answers equal the JAX
    service's, and the "fixed" policy records none."""
    jsvc, psvc = _policy_services()
    engine = psvc._generate.__self__      # one engine runs both programs
    assert engine.chunk_size == 2
    for svc in (jsvc, psvc):
        svc.low = svc.answer_batch(POLICY_REQUESTS[:1])
        if svc is psvc:
            assert engine.last_chunks == 1    # full length: one chunk of 4 steps
        svc.high = svc.answer_batch(POLICY_REQUESTS)
    assert list(psvc.policy_decisions) == list(jsvc.policy_decisions) == [
        ("full", 1), ("chunked", 4)]
    assert psvc.low == jsvc.low and psvc.high == jsvc.high
    assert psvc.high[0]["answer"] == psvc.low[0]["answer"]
    fixed = _policy_factories("fixed")[1]()
    fixed.answer_batch(POLICY_REQUESTS)
    assert list(fixed.policy_decisions) == []


def test_engine_policy_validation_matches_jax(caplog):
    """The three validations, as the JAX service makes them: a threshold
    below 1 and an explicit threshold the batch size cannot reach raise with
    the JAX message; the default out of reach warns, citing no TPU number;
    an unknown policy raises; beam search under "auto" warns and runs."""
    for kw in (dict(threshold=0), dict(batch_size=8, threshold=32), dict(policy="adaptive")):
        build_jax, build_port = _policy_factories(**kw)
        with pytest.raises(ValueError) as want:
            build_jax()
        with pytest.raises(ValueError) as got:
            build_port()
        assert str(got.value) == str(want.value)
    with caplog.at_level(logging.WARNING):
        jsvc, psvc = _policy_services(threshold=None, batch_size=4)
    assert psvc._policy_threshold == jsvc._policy_threshold == 5
    assert "out of reach" in _port_warnings(caplog)
    assert "artifacts" not in _port_warnings(caplog)
    jsvc, psvc = _policy_services(threshold=None, batch_size=12)
    assert psvc._policy_threshold == jsvc._policy_threshold == 6
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        jsvc, psvc = _policy_services(num_beams=2)
    assert "runs the beam engine unconditionally" in _port_warnings(caplog)
    assert not psvc._policy
    assert psvc.answer_batch(POLICY_REQUESTS) == jsvc.answer_batch(POLICY_REQUESTS)
    assert list(psvc.policy_decisions) == []


@pytest.mark.parametrize("name", ["T5Config", "ReaderDataConfig", "OptimConfig",
                                  "MeshConfig", "ReaderTrainConfig", "AttentionSignalConfig"])
def test_copied_configs_match(name):
    """Same fields, in the same order, with the same defaults (nested
    default factories included)."""
    ours, theirs = getattr(port_config, name), getattr(jax_config, name)

    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert spec(ours) == spec(theirs)
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
    assert dataclasses.asdict(port_config.t5_config_for_size("large")) == \
        dataclasses.asdict(jax_config.t5_config_for_size("large"))


@pytest.mark.parametrize("data", [DATA, dict(DATA, stream=1),
                                  dict(DATA, fact_use_way="separate"),
                                  dict(DATA, use_fact=False)])
def test_copied_collator_matches(data):
    """Tokenizer, dataset and collator copies give identical ReaderBatch arrays."""
    jtok, ptok = make_tokenizer(), _port_tokenizer()
    assert ptok.vocab == jtok.vocab
    examples = make_examples(5, n_facts=4, seed=2)
    jds = JaxReaderDataset(examples, jax_config.ReaderDataConfig(**data))
    pds = ReaderDataset(examples, port_config.ReaderDataConfig(**data))
    jb = JaxReaderCollator(jds.cfg, jtok)([jds[i] for i in range(5)], pad_to=8)
    pb = ReaderCollator(pds.cfg, ptok)([pds[i] for i in range(5)], pad_to=8)
    for f in dataclasses.fields(jb):
        np.testing.assert_array_equal(getattr(pb, f.name), getattr(jb, f.name),
                                      err_msg=f.name)


def test_port_imports_no_jax():
    """Every module of the package imports without jax, flax, msgpack,
    regex, nltk, transformers or lako_tpu."""
    code = ("import importlib, pkgutil, sys, lako_tpu_torch; "
            "names = [m.name for m in pkgutil.walk_packages(lako_tpu_torch.__path__, "
            "'lako_tpu_torch.')]; "
            "[importlib.import_module(n) for n in names]; "
            "assert {'lako_tpu_torch.serve', 'lako_tpu_torch.ops.flash_attention', "
            "'lako_tpu_torch.ops.adam8_kernel', 'lako_tpu_torch.train.optim8', "
            "'lako_tpu_torch.models.t5.decode', 'lako_tpu_torch.models.t5.beam', "
            "'lako_tpu_torch.models.t5.beam_engine', 'lako_tpu_torch.pipeline.cli', "
            "'lako_tpu_torch.pipeline.stages', 'lako_tpu_torch.pipeline.__main__', "
            "'lako_tpu_torch.signal.aggregate', 'lako_tpu_torch.text.stem', "
            "'lako_tpu_torch.core.checkpoint', 'lako_tpu_torch.core.distributed', "
            "'lako_tpu_torch.core.preemption', 'lako_tpu_torch.core.profiling'} <= set(names), "
            "names; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'msgpack', 'lako_tpu', 'regex', 'nltk', 'transformers')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: the build raises with the command it could not run."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found.*-gencode arch=compute_90a,code=sm_90a"):
        _build.compile_library(tmp_path / "lib.so")
    assert not (tmp_path / "lib.so").exists()


def test_entry_points_run_on_the_card_by_default(monkeypatch, services):
    """Without a device the service, evaluate_reader and train_reader take
    the CUDA card; without a card they raise instead of falling back to the
    CPU, and device="cpu" asks for the CPU."""
    from lako_tpu_torch.core.device import resolve_device
    from lako_tpu_torch.train.reader import evaluate_reader, train_reader

    _, psvc, params = services
    t5 = port_config.T5Config(**dict(TINY, vocab_size=psvc.tokenizer.vocab_size))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        LakoService(psvc.cfg, t5, params_from_jax(params), psvc.tokenizer)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_reader(lambda ids, mask: None, [], None, psvc.tokenizer, 4)
    cfg = port_config.ReaderTrainConfig(model_size="tiny", data=port_config.ReaderDataConfig(**DATA))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_reader(cfg, make_examples(4), [], psvc.tokenizer, t5_config=t5,
                     save_checkpoints=False)
    assert psvc.device == torch.device("cpu")
