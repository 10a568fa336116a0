"""The port's retriever CLI against the JAX package's (f32, CPU).

``build-tokenizer --style bert`` → ``train-retriever`` (checkpoints) →
``embed-facts`` → ``retrieve`` (exact, fast, pq and ``--small-range``) →
``eval-facts`` through each package's own ``cli.main``, the retriever of
both sides trained from one flax init and written by each side's own
``save_checkpoint``. The JAX CLI's ``train-retriever`` takes no initial
weights, so the test hands each stage's ``train_retriever`` the same init.
The JAX side trains on its 8-device CPU mesh at batch 1 a device, the port
on one device at batch 8: the same batches. Also the PQ cache's fingerprint,
which the port extends past the JAX package's head and tail, and the
``--sharded-index`` refusal.
"""

import contextlib
import io
import json
import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lako_tpu.core.config import RetrieverConfig as JaxRetrieverConfig
from lako_tpu.models.retriever import Retriever as JaxRetriever
from lako_tpu.pipeline import stages as jax_stages
from lako_tpu.pipeline.cli import main as jax_cli
from lako_tpu.retrieval.pq import PQIndex as JaxPQIndex
from lako_tpu_torch.models.bert import params_from_jax
from lako_tpu_torch.pipeline import stages
from lako_tpu_torch.pipeline.cli import main as port_cli
from lako_tpu_torch.retrieval.pq import PQIndex
from tests.fixtures import corpus_sentences, make_examples

BERT = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
RETRIEVER = dict(bert=BERT, indexing_dimension=16, question_maxlength=16, passage_maxlength=12)
TRAIN = dict(eval_batch_size=8, epochs=3, early_stop=3, n_context=3, dtype="float32",
             retriever=RETRIEVER, optim=dict(optim="adamw", lr=1e-3, weight_decay=0.01))
SIDES = {"jax": (jax_cli, jax_stages, 1, []), "port": (port_cli, stages, 8, ["--device", "cpu"])}
METHODS = ("exact", "fast", "pq")


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


def _flax_init():
    cfg = JaxRetrieverConfig.from_dict(RETRIEVER)
    return JaxRetriever(cfg).init(jax.random.PRNGKey(7), jnp.zeros((1, 8), jnp.int32),
                                  jnp.ones((1, 8), bool), jnp.zeros((1, 2, 8), jnp.int32),
                                  jnp.ones((1, 2, 8), bool))["params"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each side's CLI outputs and files, from one work directory each."""
    wd = tmp_path_factory.mktemp("torch_retriever_pipeline")
    (wd / "train.json").write_text(json.dumps(make_examples(24, n_facts=3)))
    (wd / "eval.json").write_text(json.dumps(make_examples(10, n_facts=3, seed=99)))
    corpus = [{"sentence": s, "id": i} for i, s in enumerate(corpus_sentences())]
    corpus += [{"sentence": f"the {a} is near the {b}.", "id": 100 + i}
               for i, (a, b) in enumerate(zip(["cat", "dog", "cow", "owl"],
                                              ["barn", "tree", "pond", "grass"]))]
    (wd / "corpus.json").write_text(json.dumps(corpus))
    out = {}
    for side, (main, stage_module, batch, extra) in SIDES.items():
        d = wd / side
        d.mkdir()
        outputs = {}

        def run(name, argv):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                main(argv)
            outputs[name] = json.loads(buf.getvalue().strip().splitlines()[-1])

        params = _flax_init()
        init = params if side == "jax" else params_from_jax(params)
        trainer = stage_module.train_retriever

        def train_from_init(*args, **kw):
            return trainer(*args, init_params=init, **kw)

        run("tokenizer", ["build-tokenizer", "--from-json", str(wd / "train.json"),
                          str(wd / "corpus.json"), "--out", str(d / "btok.json"),
                          "--style", "bert"])
        (d / "cfg.json").write_text(json.dumps(dict(
            TRAIN, per_device_batch_size=batch, checkpoint_dir=str(d / "ckpt"), name="r")))
        common = ["--config", str(d / "cfg.json"), "--tokenizer", str(d / "btok.json")]
        stage_module.train_retriever = train_from_init
        try:
            run("train", ["train-retriever", *common, "--train-data", str(wd / "train.json"),
                          "--eval-data", str(wd / "eval.json"), *extra])
        finally:
            stage_module.train_retriever = trainer
        model = ["--model-path", str(d / "ckpt" / "r" / "checkpoint" / "best_dev")]
        run("embed", ["embed-facts", *common, *model, "--corpus", str(wd / "corpus.json"),
                      "--out", str(d / "index"), "--batch-size", "4", *extra])
        retrieve = ["retrieve", *common, *model, "--index", str(d / "index"),
                    "--corpus", str(wd / "corpus.json"), "--data", str(wd / "eval.json")]
        for method in METHODS:
            run(method, [*retrieve, "--out", str(d / f"{method}.json"), "--n-docs", "5",
                         "--index-method", method, *extra])
        run("rerank", [*retrieve, "--out", str(d / "rerank.json"), "--small-range", *extra])
        for name in (*METHODS, "rerank"):
            run(f"hits_{name}", ["eval-facts", "--data", str(d / f"{name}.json"),
                                 "--hitk", "1", "2", "5"])
        files = {name: json.loads((d / f"{name}.json").read_text())
                 for name in (*METHODS, "rerank")}
        out[side] = dict(outputs=outputs, files=files, dir=d)
    return out


def test_train_retriever_cli_matches_jax(runs):
    """Steps, best inversions and each epoch's inversions equal, the losses
    within rtol 1e-5, the same checkpoints with equal metadata."""
    j, p = runs["jax"]["outputs"]["train"], runs["port"]["outputs"]["train"]
    assert sorted(p) == sorted(j)
    assert p["steps"] == j["steps"] == 9
    assert p["best_inversions"] == j["best_inversions"]
    assert [sorted(h) for h in p["history"]] == [sorted(h) for h in j["history"]]
    assert [h["inversions"] for h in p["history"]] == [h["inversions"] for h in j["history"]]
    np.testing.assert_allclose([h["loss"] for h in p["history"]],
                               [h["loss"] for h in j["history"]], rtol=1e-5)
    metas = []
    for side in runs:
        ckpt = runs[side]["dir"] / "ckpt" / "r" / "checkpoint"
        assert sorted(x.name for x in ckpt.iterdir()) == ["best_dev", "last", "latest"]
        metas.append(json.loads((ckpt / "last" / "meta.json").read_text()))
    assert metas[0] == metas[1]


def test_embed_facts_cli_matches_jax(runs):
    """The result dict (but the path) and the index files: ids equal,
    embeddings within 1e-4 (after nine steps of training apart)."""
    j, p = runs["jax"]["outputs"]["embed"], runs["port"]["outputs"]["embed"]
    assert p == dict(j, index_path=str(runs["port"]["dir"] / "index"))
    assert p["n_facts"] == 12 and p["dim"] == 16
    jdir, pdir = runs["jax"]["dir"] / "index", runs["port"]["dir"] / "index"
    np.testing.assert_array_equal(np.load(pdir / "ids.npy"), np.load(jdir / "ids.npy"))
    np.testing.assert_allclose(np.load(pdir / "embeddings.npy"), np.load(jdir / "embeddings.npy"),
                               rtol=0, atol=1e-4)
    assert (pdir / "meta.json").read_text() == (jdir / "meta.json").read_text()


@pytest.mark.parametrize("name", [*METHODS, "rerank"])
def test_retrieve_and_eval_facts_cli_match_jax(runs, name):
    """Each retrieval's result dict, every example's fact ids and sentences
    in order, fact scores (inner products of size ~8) within 1e-4 relative,
    and hit@k equal."""
    j, p = runs["jax"], runs["port"]
    assert p["outputs"][name] == j["outputs"][name]
    jf, pf = j["files"][name], p["files"][name]
    assert len(pf) == len(jf) == 10
    for je, pe in zip(jf, pf):
        assert sorted(pe) == sorted(je)
        assert {k: v for k, v in pe.items() if k != "fact"} == \
            {k: v for k, v in je.items() if k != "fact"}
        assert [(f["id"], f["sentence"]) for f in pe["fact"]] == \
            [(f["id"], f["sentence"]) for f in je["fact"]]
        np.testing.assert_allclose([f["score"] for f in pe["fact"]],
                                   [f["score"] for f in je["fact"]], rtol=1e-4)
    assert p["outputs"][f"hits_{name}"] == j["outputs"][f"hits_{name}"]
    assert sorted(p["outputs"][f"hits_{name}"]) == ["include", "stem"]


def test_pq_cache_retrains_on_interior_change(tmp_path):
    """An embeddings file rewritten in its interior only: the JAX cache
    hashes the first and last 4 MB and serves the stale codes (the
    reference fault); the port's strided samples see the change and
    retrain. An unchanged file reuses the cache on both sides."""
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(196_608, 16)).astype(np.float32)     # 12 MiB of rows
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        np.save(tmp_path / side / "embeddings.npy", emb)
        np.save(tmp_path / side / "ids.npy", np.arange(len(emb)))
    kw = dict(n_subquantizers=2, n_bits=4)
    first = {"jax": jax_stages._load_or_train_pq(str(tmp_path / "jax"), **kw),
             "port": stages._load_or_train_pq(str(tmp_path / "port"), device="cpu", **kw)}
    np.testing.assert_array_equal(first["port"].codes, first["jax"].codes)
    again = stages._load_or_train_pq(str(tmp_path / "port"), device="cpu", **kw)
    np.testing.assert_array_equal(again.codes, first["port"].codes)
    changed = emb.copy()
    changed[90_000:92_000] = rng.normal(size=(2000, 16)) * 5      # ~6 MiB in: the interior
    for side in ("jax", "port"):
        np.save(tmp_path / side / "embeddings.npy", changed)
    stale = jax_stages._load_or_train_pq(str(tmp_path / "jax"), **kw)
    assert isinstance(stale, JaxPQIndex)
    np.testing.assert_array_equal(stale.codes, first["jax"].codes)
    source = tmp_path / "port" / "pq" / "source.json"
    before = json.loads(source.read_text())
    fresh = stages._load_or_train_pq(str(tmp_path / "port"), device="cpu", **kw)
    assert json.loads(source.read_text()) != before
    assert isinstance(fresh, PQIndex)
    want = PQIndex.train(changed, ids=np.arange(len(emb)), device="cpu", **kw)
    np.testing.assert_array_equal(fresh.codes, want.codes)
    assert not np.array_equal(fresh.codes[90_000:92_000], first["port"].codes[90_000:92_000])


def test_sharded_index_refused(runs):
    """--sharded-index names ROADMAP item 12 instead of running."""
    d = runs["port"]["dir"]
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        port_cli(["retrieve", "--config", str(d / "cfg.json"), "--tokenizer",
                  str(d / "btok.json"), "--model-path", str(d / "ckpt/r/checkpoint/best_dev"),
                  "--index", str(d / "index"), "--corpus", str(d.parent / "corpus.json"),
                  "--data", str(d.parent / "eval.json"), "--out", str(d / "never.json"),
                  "--sharded-index", "--device", "cpu"])
    assert not (d / "never.json").exists()


def test_eval_retriever_stage_matches_jax(runs):
    """Each side's checkpoint scored on the scored eval file: inversions,
    avg_topk, idx_topk and total equal, the inversions those of training."""
    from lako_tpu.core.config import RetrieverTrainConfig as JaxRetrieverTrainConfig
    from lako_tpu.text.tokenizer import load_tokenizer as jax_load_tokenizer
    from lako_tpu_torch.core.config import RetrieverTrainConfig
    from lako_tpu_torch.text.tokenizer import load_tokenizer

    def args(side, config_cls, load):
        d = runs[side]["dir"]
        return (config_cls.from_dict(json.loads((d / "cfg.json").read_text())),
                str(d.parent / "eval.json"), str(d / "ckpt" / "r" / "checkpoint" / "best_dev"),
                load(str(d / "btok.json"), style="bert"))

    want = jax_stages.eval_retriever_stage(*args("jax", JaxRetrieverTrainConfig,
                                                 jax_load_tokenizer))
    got = stages.eval_retriever_stage(*args("port", RetrieverTrainConfig, load_tokenizer),
                                      device="cpu")
    assert got == want
    assert got["total"] == 10
    assert got["inversions"] == runs["port"]["outputs"]["train"]["best_inversions"]
