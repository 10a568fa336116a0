"""The port's serving path vs the JAX package's, plus the port's own contracts:
copied framework-free modules pinned to their originals, an import that pulls
in no JAX, and a kernel build that never falls back."""

import dataclasses
import json
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
        port_config.T5Config(**t5), params_from_jax(params), _port_tokenizer())
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
                        params_from_jax(params), psvc.tokenizer)
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
    _, psvc, params = services
    t5 = port_config.T5Config(**dict(TINY, vocab_size=psvc.tokenizer.vocab_size))
    sd = params_from_jax(params)
    for change, item in [({"mesh_model": 2}, "11"), ({"num_beams": 4}, "10"),
                         ({"engine_policy": "auto"}, "11")]:
        with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
            LakoService(dataclasses.replace(psvc.cfg, **change), t5, sd, psvc.tokenizer)
    assert psvc.retrieve_facts([{"question": "q"}]) == [[]]


@pytest.mark.parametrize("name", ["T5Config", "ReaderDataConfig"])
def test_copied_configs_match(name):
    """Same fields, in the same order, with the same defaults."""
    ours, theirs = getattr(port_config, name), getattr(jax_config, name)

    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert spec(ours) == spec(theirs)
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
    """Every module of the package imports without jax, flax, regex,
    transformers or lako_tpu."""
    code = ("import importlib, pkgutil, sys, lako_tpu_torch; "
            "names = [m.name for m in pkgutil.walk_packages(lako_tpu_torch.__path__, "
            "'lako_tpu_torch.')]; "
            "[importlib.import_module(n) for n in names]; "
            "assert 'lako_tpu_torch.serve' in names, names; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'lako_tpu', 'regex', 'transformers')]; "
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
