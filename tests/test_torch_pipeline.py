"""The port's reader CLI against the JAX package's (f32, CPU).

``build-tokenizer`` → ``train-reader`` (checkpoints, warm start) →
``eval-reader --write-results --write-crossattention-scores`` through each
package's own ``cli.main``, from the same flax init, written as each
package's warm-start checkpoint by its own ``save_checkpoint``. The JAX side
trains on its 8-device CPU mesh at batch 1 a device, the port on one device
at batch 8: the same batches.
"""

import contextlib
import io
import json
import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lako_tpu.core.checkpoint import save_checkpoint as jax_save_checkpoint
from lako_tpu.core.config import T5Config as JaxT5Config
from lako_tpu.models.t5.model import FiDT5 as JaxFiDT5
from lako_tpu.pipeline.cli import main as jax_cli
from lako_tpu_torch.core.checkpoint import save_checkpoint
from lako_tpu_torch.models.t5 import params_from_jax
from lako_tpu_torch.pipeline import stages
from lako_tpu_torch.pipeline.cli import build_parser
from lako_tpu_torch.pipeline.cli import main as port_cli
from tests.fixtures import make_examples

T5 = dict(d_model=32, d_kv=8, d_ff=64, num_layers=2, num_decoder_layers=2, num_heads=4,
          relative_attention_num_buckets=8, dropout_rate=0.0)
READER = dict(model_size="tiny", eval_batch_size=8, epochs=3, early_stop=3, eval_max_length=4,
              dtype="float32", use_remat=False,
              data=dict(n_context=2, text_maxlength=20, answer_maxlength=4, stream=2),
              optim=dict(optim="adamw", lr=3e-3, weight_decay=0.0))
SIDES = {"jax": (jax_cli, 1, []), "port": (port_cli, 8, ["--device", "cpu"])}


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each side's CLI outputs and files, from one work directory each."""
    wd = tmp_path_factory.mktemp("torch_pipeline")
    (wd / "train.json").write_text(json.dumps(make_examples(16, n_facts=2)))
    (wd / "eval.json").write_text(json.dumps(make_examples(8, n_facts=2, seed=9)))
    out = {}
    for side, (main, batch, extra) in SIDES.items():
        capture = []
        d = wd / side
        d.mkdir()

        def run(argv):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                main(argv)
            capture.append(json.loads(buf.getvalue().strip().splitlines()[-1]))

        run(["build-tokenizer", "--from-json", str(wd / "train.json"), "--out",
             str(d / "tok.json")])
        vocab = capture[0]["vocab_size"]
        (d / "t5.json").write_text(json.dumps(dict(T5, vocab_size=vocab)))
        (d / "cfg.json").write_text(json.dumps(dict(
            READER, per_device_batch_size=batch, checkpoint_dir=str(d / "ckpt"), name="r")))
        model = JaxFiDT5(JaxT5Config(**T5, vocab_size=vocab))
        params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 2, 20), jnp.int32),
                            jnp.ones((1, 2, 20), bool), jnp.zeros((1, 4), jnp.int32))["params"]
        if side == "jax":
            jax_save_checkpoint(str(d / "init"), "init", params)
        else:
            save_checkpoint(str(d / "init"), "init", params_from_jax(params))
        common = ["--config", str(d / "cfg.json"), "--t5-config", str(d / "t5.json"),
                  "--tokenizer", str(d / "tok.json")]
        run(["train-reader", *common, "--train-data", str(wd / "train.json"),
             "--eval-data", str(wd / "eval.json"), "--model-path", str(d / "init"), *extra])
        run(["eval-reader", *common, "--eval-data", str(wd / "eval.json"),
             "--model-path", str(d / "ckpt" / "r"), "--write-results", str(d / "results.json"),
             "--write-crossattention-scores", str(d / "scored.json"), *extra])
        out[side] = dict(tokenizer=capture[0], train=capture[1], eval=capture[2], dir=d,
                         results=json.loads((d / "results.json").read_text()),
                         scored=json.loads((d / "scored.json").read_text()))
    return out


def test_tokenizers_match(runs):
    j, p = (json.loads((runs[s]["dir"] / "tok.json").read_text()) for s in ("jax", "port"))
    assert p == j
    assert runs["port"]["tokenizer"]["vocab_size"] == runs["jax"]["tokenizer"]["vocab_size"]


def test_train_reader_cli_matches_jax(runs):
    """Same keys, steps and best EM; the losses within rtol 1e-5; the same
    checkpoints written (best_dev when an epoch's EM beat 0, last, latest)."""
    j, p = runs["jax"]["train"], runs["port"]["train"]
    assert sorted(p) == sorted(j)
    assert p["steps"] == j["steps"] == 6
    assert p["best_dev_em"] == j["best_dev_em"] > 0
    assert [sorted(h) for h in p["history"]] == [sorted(h) for h in j["history"]]
    assert [h["em"] for h in p["history"]] == [h["em"] for h in j["history"]]
    np.testing.assert_allclose([h["loss"] for h in p["history"]],
                               [h["loss"] for h in j["history"]], rtol=1e-5)
    for side in runs:
        ckpt = runs[side]["dir"] / "ckpt" / "r" / "checkpoint"
        assert sorted(x.name for x in ckpt.iterdir()) == ["best_dev", "last", "latest"]
        assert (ckpt / "latest").resolve() == (ckpt / "last").resolve()
    metas = [json.loads((runs[s]["dir"] / "ckpt/r/checkpoint/last/meta.json").read_text())
             for s in ("jax", "port")]
    assert metas[0] == metas[1]


def test_eval_reader_cli_matches_jax(runs):
    """The result keys, EM and every answer equal; the --write-results and
    --write-crossattention-scores files in the JAX schemas, fact scores
    within 1e-4, each example's scores a softmax."""
    j, p = runs["jax"]["eval"], runs["port"]["eval"]
    assert sorted(p) == sorted(j)
    for key in ("em", "include_em", "stem_em", "total"):
        assert p[key] == j[key], key
    jr, pr = runs["jax"]["results"], runs["port"]["results"]
    assert [sorted(r) for r in pr] == [sorted(r) for r in jr]
    assert [r["answer"] for r in pr] == [r["answer"] for r in jr]
    def unscored(rows):   # the fact dicts carry the scores, compared below
        return [dict(r, fact=[{k: v for k, v in f.items() if k != "score"} for f in r["fact"]])
                for r in rows]

    assert unscored(pr) == unscored(jr)
    js, ps = runs["jax"]["scored"], runs["port"]["scored"]
    assert len(ps) == len(js) == 8
    for je, pe in zip(js, ps):
        assert sorted(pe) == sorted(je)
        assert [sorted(f) for f in pe["fact"]] == [sorted(f) for f in je["fact"]]
        np.testing.assert_allclose([f["score"] for f in pe["fact"]],
                                   [f["score"] for f in je["fact"]], atol=1e-4)
        assert abs(sum(f["score"] for f in pe["fact"]) - 1.0) < 1e-5


def test_eval_reader_beam_and_its_refusal(runs):
    """num_beams > 1 decodes through the beam dispatch; with score writing
    it raises, as the JAX stage does."""
    from lako_tpu_torch.core.config import (
        AttentionSignalConfig,
        ReaderTrainConfig,
        T5Config,
    )
    from lako_tpu_torch.text.tokenizer import load_tokenizer

    d = runs["port"]["dir"]
    cfg = ReaderTrainConfig.from_dict(json.loads((d / "cfg.json").read_text()))
    t5 = T5Config.from_dict(json.loads((d / "t5.json").read_text()))
    tok = load_tokenizer(str(d / "tok.json"))
    args = (cfg, AttentionSignalConfig(n_context=2), str(d.parent / "eval.json"),
            str(d / "ckpt" / "r"), tok)
    out = stages.eval_reader_stage(*args, t5_config=t5, num_beams=2, device="cpu")
    assert out["total"] == 8 and 0.0 <= out["em"] <= 1.0
    with pytest.raises(ValueError, match="greedy"):
        stages.eval_reader_stage(*args, t5_config=t5, num_beams=2, device="cpu",
                                 write_crossattention_scores=str(d / "never.json"))


def test_unported_inputs_raise(runs, tmp_path, monkeypatch):
    """More than one process names ROADMAP item 12; --help names the item of
    each option left out, and no subcommand: every one is ported. (HF
    checkpoint directories and tokenizers, item 9, are ported:
    tests/test_torch_hf_io.py and tests/test_torch_hf_tokenizer.py.)"""
    from lako_tpu_torch.core.config import ReaderTrainConfig

    d = runs["port"]["dir"]
    args = (ReaderTrainConfig(), str(d.parent / "train.json"), str(d.parent / "eval.json"),
            None)
    monkeypatch.setattr(stages, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        stages.train_reader_stage(*args, device="cpu")
    assert build_parser().epilog in build_parser().format_help()
    epilog = " ".join(build_parser().epilog.split())
    for text in ("retrieve --sharded-index (12)", "serve --mesh-model > 1 (11)"):
        assert text in epilog, text
    for text in ("train-retriever (7)", "embed-facts, retrieve (8)", "eval-facts,",
                 "full-loop (9)", "mine-candidates", "prep-questions", "serve (11, with 9)",
                 "build-tokenizer", "(9)"):
        assert text not in epilog, text
