"""The port's ``full-loop`` against the JAX package's (f32, CPU).

Two iterations of reader training → scoring → retriever distillation →
corpus embedding → re-ranking → hit@k through each package's own
``cli.main``, with ``--fact-ablation``, on the fixture's examples and corpus.
Each side's ``--reader-init`` is one flax init written by its own
``save_checkpoint``; the JAX CLI's retriever takes no initial weights, so
each side's ``stages.train_retriever`` is handed one flax init. The JAX side
trains on its 8-device CPU mesh at batch 1 a device, the port on one device
at batch 8: the same batches. Also ``--warm-start-reader``, the port's
checkpoint hash, and the card default.
"""

import argparse
import contextlib
import io
import json
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lako_tpu.core.checkpoint import save_checkpoint as jax_save_checkpoint
from lako_tpu.core.config import RetrieverConfig as JaxRetrieverConfig
from lako_tpu.core.config import T5Config as JaxT5Config
from lako_tpu.models.retriever import Retriever as JaxRetriever
from lako_tpu.models.t5.model import FiDT5 as JaxFiDT5
from lako_tpu.pipeline import stages as jax_stages
from lako_tpu.pipeline.cli import main as jax_cli
from lako_tpu_torch.core.checkpoint import save_checkpoint
from lako_tpu_torch.models import bert as port_bert
from lako_tpu_torch.models import t5 as port_t5
from lako_tpu_torch.pipeline import stages
from lako_tpu_torch.pipeline.cli import main as port_cli
from lako_tpu_torch.pipeline.full_loop import _params_hash, run_full_loop
from tests.fixtures import corpus_sentences, make_examples

T5 = dict(d_model=32, d_kv=8, d_ff=64, num_layers=2, num_decoder_layers=2, num_heads=4,
          relative_attention_num_buckets=8, dropout_rate=0.0)
DATA = dict(n_context=2, text_maxlength=20, answer_maxlength=4, stream=2)
READER = dict(model_size="tiny", eval_batch_size=8, epochs=2, early_stop=2, eval_max_length=4,
              dtype="float32", use_remat=False, data=DATA,
              optim=dict(optim="adamw", lr=3e-3, weight_decay=0.0))
BERT = dict(vocab_size=200, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
RETRIEVER = dict(bert=BERT, indexing_dimension=16, question_maxlength=16, passage_maxlength=12)
RETRIEVER_TRAIN = dict(eval_batch_size=8, epochs=1, early_stop=1, n_context=2, dtype="float32",
                       retriever=RETRIEVER, optim=dict(optim="adamw", lr=1e-3, weight_decay=0.0))
SIDES = {"jax": (jax_cli, jax_stages, 1, []), "port": (port_cli, stages, 8, ["--device", "cpu"])}
EVAL_KEYS = ("em", "include_em", "stem_em", "total")        # answers_per_sec is a timing
FACT_RTOL = 1e-4


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


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _retriever_init():
    cfg = JaxRetrieverConfig.from_dict(RETRIEVER)
    return JaxRetriever(cfg).init(jax.random.PRNGKey(7), jnp.zeros((1, 8), jnp.int32),
                                  jnp.ones((1, 8), bool), jnp.zeros((1, 2, 8), jnp.int32),
                                  jnp.ones((1, 2, 8), bool))["params"]


def _run_loops(wd, *flags):
    """Each side's full-loop output and work directory."""
    (wd / "train.json").write_text(json.dumps(make_examples(16, n_facts=3)))
    (wd / "eval.json").write_text(json.dumps(make_examples(8, n_facts=3, seed=77)))
    corpus = [{"sentence": s, "id": i} for i, s in enumerate(corpus_sentences())]
    (wd / "corpus.json").write_text(json.dumps(corpus))
    rparams = _retriever_init()
    out = {}
    for side, (main, stage_module, batch, extra) in SIDES.items():
        d = wd / side
        d.mkdir()
        vocab = {style: _cli(main, ["build-tokenizer", "--from-json", str(wd / "train.json"),
                                    str(wd / "corpus.json"), "--out", str(d / f"{style}.json"),
                                    "--style", style])["vocab_size"]
                 for style in ("t5", "bert")}["t5"]
        (d / "t5_config.json").write_text(json.dumps(dict(T5, vocab_size=vocab)))
        (d / "reader.json").write_text(json.dumps(dict(READER, per_device_batch_size=batch)))
        (d / "retriever.json").write_text(json.dumps(dict(RETRIEVER_TRAIN,
                                                          per_device_batch_size=batch)))
        params = JaxFiDT5(JaxT5Config(**T5, vocab_size=vocab)).init(
            jax.random.PRNGKey(3), jnp.zeros((1, 2, 20), jnp.int32),
            jnp.ones((1, 2, 20), bool), jnp.zeros((1, 4), jnp.int32))["params"]
        if side == "jax":
            jax_save_checkpoint(str(d / "init"), "init", params)
            # host copies: the JAX trainer donates the arrays it is given
            rinit = jax.tree.map(np.asarray, rparams)
        else:
            save_checkpoint(str(d / "init"), "init", port_t5.params_from_jax(params))
            rinit = port_bert.params_from_jax(rparams)
        trainer = stage_module.train_retriever

        def train_from_init(*args, rinit=rinit, trainer=trainer, **kw):
            fresh = jax.tree.map(                      # each iteration from the init
                lambda x: x.clone() if isinstance(x, torch.Tensor) else x.copy(), rinit)
            return trainer(*args, init_params=fresh, **kw)

        stage_module.train_retriever = train_from_init
        try:
            printed = _cli(main, [
                "full-loop", "--workdir", str(d / "loop"),
                "--reader-config", str(d / "reader.json"),
                "--retriever-config", str(d / "retriever.json"),
                "--t5-config", str(d / "t5_config.json"), "--train-data", str(wd / "train.json"),
                "--eval-data", str(wd / "eval.json"), "--corpus", str(wd / "corpus.json"),
                "--tokenizer", str(d / "t5.json"), "--bert-tokenizer", str(d / "bert.json"),
                "--reader-init", str(d / "init" / "checkpoint" / "init"), "--iterations", "2",
                *flags, *extra])
        finally:
            stage_module.train_retriever = trainer
        out[side] = dict(out=printed, loop=d / "loop")
    return out


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    return _run_loops(tmp_path_factory.mktemp("torch_full_loop"), "--fact-ablation")


def _same_facts(got_rows, want_rows):
    """Each example's facts: ids and sentences in rank order equal, scores
    within FACT_RTOL (relative); the rest of the example equal."""
    assert len(got_rows) == len(want_rows)
    for g, w in zip(got_rows, want_rows):
        assert {k: v for k, v in g.items() if k != "fact"} == \
            {k: v for k, v in w.items() if k != "fact"}
        assert [(f["id"], f["sentence"]) for f in g["fact"]] == \
            [(f["id"], f["sentence"]) for f in w["fact"]]
        np.testing.assert_allclose([f.get("score", 0.0) for f in g["fact"]],
                                   [f.get("score", 0.0) for f in w["fact"]], rtol=FACT_RTOL)


def test_history_matches_jax(loops):
    """The history's schema, and every field but the checkpoint's path and
    hash equal (EM, inversions, hit@k, the diagnostics)."""
    j, p = loops["jax"]["out"], loops["port"]["out"]
    assert p["iterations"] == j["iterations"] == 2
    for jh, ph in zip(j["history"], p["history"]):
        assert sorted(ph) == sorted(jh)
        assert sorted(ph["diagnostics"]) == sorted(jh["diagnostics"])
        assert sorted(ph["eval"]) == sorted(jh["eval"])
        for key in EVAL_KEYS:
            assert ph["eval"][key] == jh["eval"][key], key
        for key in ("iteration", "reader_best_em", "retriever_best_inversions",
                    "hit_at_k_include"):
            assert ph[key] == jh[key], key
        pd, jd = ph["diagnostics"], jh["diagnostics"]
        for key in sorted(jd):
            if key not in ("reader_ckpt", "reader_ckpt_sha256"):
                assert pd[key] == jd[key], key
        assert pd["reader_ckpt"].split("/")[-3:] == jd["reader_ckpt"].split("/")[-3:]
        assert pd["fact_shuffle_ablation"]["em"] == jd["fact_shuffle_ablation"]["em"]
    second = p["history"][1]["diagnostics"]
    assert {"train_fact_diff_vs_prev", "answers_vs_prev", "fact_shuffle_ablation",
            "retriever_inversions_vs_v1_gold", "hit_conditioned"} <= set(second)
    assert "train_fact_diff_vs_prev" not in p["history"][0]["diagnostics"]
    saved = json.loads((loops["port"]["loop"] / "full_loop_history.json").read_text())
    assert saved == p["history"]


def test_loop_files_match_jax(loops):
    """The same files in both work directories; each iteration's scored,
    answered and re-ranked data equal (fact ids in order, scores within
    1e-4 relative), the fact indexes' ids equal."""
    jl, pl = loops["jax"]["loop"], loops["port"]["loop"]
    top = sorted(x.name for x in pl.iterdir())
    assert top == sorted(x.name for x in jl.iterdir())
    for v in ("v1", "v2"):
        for name in (f"train_scored_{v}", f"eval_scored_{v}", f"train_reranked_{v}",
                     f"eval_reranked_{v}", f"eval_factshuffle_{v}"):
            _same_facts(json.loads((pl / f"{name}.json").read_text()),
                        json.loads((jl / f"{name}.json").read_text()))
        p_ans = json.loads((pl / f"eval_answers_{v}.json").read_text())
        j_ans = json.loads((jl / f"eval_answers_{v}.json").read_text())
        assert [r["answer"] for r in p_ans] == [r["answer"] for r in j_ans]
        np.testing.assert_array_equal(np.load(pl / f"fact_index_{v}" / "ids.npy"),
                                      np.load(jl / f"fact_index_{v}" / "ids.npy"))
        reranked = json.loads((pl / f"train_reranked_{v}.json").read_text())
        for ex in reranked:
            scores = [f["score"] for f in ex["fact"]]
            assert scores == sorted(scores, reverse=True)


def test_checkpoint_hash(loops, tmp_path):
    """The port's hash: equal for byte-identical tensors whatever the file's
    framing, different after one training step, different between the two
    iterations' readers."""
    p = loops["port"]["out"]["history"]
    hashes = [h["diagnostics"]["reader_ckpt_sha256"] for h in p]
    assert all(isinstance(h, str) and len(h) == 16 for h in hashes)
    assert hashes[0] != hashes[1]
    for h, ckpt in zip(hashes, (x["diagnostics"]["reader_ckpt"] for x in p)):
        assert _params_hash(ckpt) == h
    init = loops["port"]["loop"].parent / "init" / "checkpoint" / "init"
    flat = torch.load(init / "params.pt", weights_only=True)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    torch.save(flat, tmp_path / "a" / "params.pt")
    torch.save(dict(reversed(list(flat.items()))), tmp_path / "b" / "params.pt")
    assert (tmp_path / "a" / "params.pt").read_bytes() != \
        (tmp_path / "b" / "params.pt").read_bytes()
    assert _params_hash(str(tmp_path / "a")) == _params_hash(str(tmp_path / "b")) == \
        _params_hash(str(init))
    assert _params_hash(str(init)) not in hashes
    assert _params_hash(str(tmp_path / "none")) is None


def test_warm_start_matches_jax(tmp_path):
    """--warm-start-reader: iteration 2's reader continues from iteration
    1's checkpoint; the two histories agree as above."""
    runs = _run_loops(tmp_path, "--warm-start-reader")
    j, p = runs["jax"]["out"], runs["port"]["out"]
    assert p["iterations"] == j["iterations"] == 2
    for jh, ph in zip(j["history"], p["history"]):
        for key in EVAL_KEYS:
            assert ph["eval"][key] == jh["eval"][key], key
        assert ph["hit_at_k_include"] == jh["hit_at_k_include"]
        assert ph["retriever_best_inversions"] == jh["retriever_best_inversions"]
        assert ph["diagnostics"]["hit_conditioned"] == jh["diagnostics"]["hit_conditioned"]
    for v in ("v1", "v2"):
        _same_facts(json.loads((runs["port"]["loop"] / f"eval_reranked_{v}.json").read_text()),
                    json.loads((runs["jax"]["loop"] / f"eval_reranked_{v}.json").read_text()))
    assert (runs["port"]["loop"] / "reader_v2" / "checkpoint").exists()


def test_full_loop_takes_the_card(loops, monkeypatch):
    """Without --device (or ``device``) and without a card, full-loop and
    run_full_loop raise as resolve_device does, before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = loops["port"]["loop"].parent
    argv = ["full-loop", "--workdir", str(d / "never"), "--train-data", "t.json",
            "--eval-data", "e.json", "--corpus", "c.json", "--tokenizer", "tok.json",
            "--bert-tokenizer", "btok.json"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_full_loop(argparse.Namespace(workdir=str(d / "never")))
    assert not (d / "never").exists()
