"""The port's BERT retriever against the JAX package's (f32, CPU).

The encoder, every ``embed_text`` variant and the fused forward, the KL
loss, one train step's loss and gradients, ``train_retriever`` from one flax
init, the collators, the initializer, the HF state_dict converters and the
position-table check. Both sides start from one flax init through
``models.bert.params_from_jax``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lako_tpu.core import config as jax_config
from lako_tpu.data.collator import RetrieverCollator as JaxRetrieverCollator
from lako_tpu.data.collator import TextCollator as JaxTextCollator
from lako_tpu.data.dataset import ReaderDataset as JaxReaderDataset
from lako_tpu.models.bert.convert import params_from_torch_bert
from lako_tpu.models.bert.model import BertEncoder as JaxBertEncoder
from lako_tpu.models.retriever import Retriever as JaxRetriever
from lako_tpu.models.retriever import kl_div_loss as jax_kl_div_loss
from lako_tpu.train.retriever import evaluate_retriever as jax_evaluate_retriever
from lako_tpu.train.retriever import make_retriever_score_fn as jax_score_fn
from lako_tpu.train.retriever import sort_facts_by_gold as jax_sort_facts
from lako_tpu.train.retriever import train_retriever as jax_train_retriever
from lako_tpu_torch.core import config as port_config
from lako_tpu_torch.data import ReaderDataset, RetrieverCollator, TextCollator
from lako_tpu_torch.models.bert import (
    BertEncoder,
    init_retriever,
    jax_param_paths,
    params_from_jax,
    state_dict_from_hf_bert,
)
from lako_tpu_torch.models.retriever import Retriever, kl_div_loss
from lako_tpu_torch.retrieval.embed import embed_corpus, embed_questions
from lako_tpu_torch.text.tokenizer import WordVocabTokenizer
from lako_tpu_torch.train.retriever import (
    evaluate_retriever,
    make_retriever_score_fn,
    sort_facts_by_gold,
    train_retriever,
)
from tests.fixtures import make_examples, make_tokenizer

BERT = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
RETRIEVER = dict(indexing_dimension=16, question_maxlength=16, passage_maxlength=12)


def _configs(**retriever):
    kw = dict(RETRIEVER, **retriever)
    return (jax_config.RetrieverConfig(bert=jax_config.BertConfig(**BERT), **kw),
            port_config.RetrieverConfig(bert=port_config.BertConfig(**BERT), **kw))


def _ids(rng, shape):
    return rng.integers(1, BERT["vocab_size"], size=shape).astype(np.int32)


def _jax_retriever(jcfg, L=8, seed=0):
    model = JaxRetriever(jcfg)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, L), jnp.int32),
                        jnp.ones((1, L), bool), jnp.zeros((1, 2, L), jnp.int32),
                        jnp.ones((1, 2, L), bool))["params"]
    return model, params


def _port_retriever(pcfg, params):
    model = Retriever(pcfg)
    model.load_state_dict(params_from_jax(params))
    return model.eval()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _bert_tokenizers():
    jtok = make_tokenizer(style="bert")
    return jtok, WordVocabTokenizer(jtok.vocab, style="bert")


def test_bert_encoder_matches_flax():
    """Hidden states with padded rows and an all-masked row, max abs 1e-5."""
    cfg = jax_config.BertConfig(**BERT)
    rng = np.random.default_rng(0)
    B, L = 4, 10
    ids = _ids(rng, (B, L))
    mask = np.ones((B, L), bool)
    mask[1, 7:] = False
    mask[2, 3:] = False
    mask[3] = False
    jm = JaxBertEncoder(cfg)
    params = jm.init(jax.random.PRNGKey(1), ids, mask)["params"]
    want = np.asarray(jm.apply({"params": params}, ids, mask))
    model = BertEncoder(port_config.BertConfig(**BERT))
    model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        plain = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(plain, np.asarray(jm.apply({"params": params}, ids)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("variant", [
    dict(),                                            # projection, masked mean
    dict(apply_question_mask=False, apply_passage_mask=False),   # plain mean
    dict(extract_cls=True),
    dict(projection=False),                            # no head
    dict(projection=False, asymmetric=True),           # q and f heads
])
def test_embed_text_and_fused_forward_match_flax(variant):
    """embed_text for "q" and "f" within 1e-5; the forward (fused when the
    heads are shared) against separate embed_text calls and the JAX
    forward, scores within 1e-5; the loss within 1e-6."""
    jcfg, pcfg = _configs(**variant)
    jm, params = _jax_retriever(jcfg)
    model = _port_retriever(pcfg, params)
    rng = np.random.default_rng(2)
    B, n, L = 3, 4, 8
    q_ids, p_ids = _ids(rng, (B, L)), _ids(rng, (B, n, L))
    q_mask = rng.random((B, L)) < 0.7
    q_mask[:, 0] = True
    p_mask = rng.random((B, n, L)) < 0.7
    p_mask[..., 0] = True
    gold = rng.random((B, n)).astype(np.float32)
    gold[0, 1] = 0.0
    t = torch.from_numpy
    with torch.no_grad():
        for text_type in ("q", "f"):
            kw = dict(apply_mask=pcfg.apply_question_mask, extract_cls=pcfg.extract_cls)
            want = jm.apply({"params": params}, q_ids, q_mask, text_type,
                            method=JaxRetriever.embed_text, **kw)
            got = model.embed_text(t(q_ids), t(q_mask), text_type, **kw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
        q_emb, p_emb, score, loss = model(t(q_ids), t(q_mask), t(p_ids), t(p_mask), t(gold))
        kw = dict(apply_mask=pcfg.apply_passage_mask, extract_cls=pcfg.extract_cls)
        p_ref = model.embed_text(t(p_ids.reshape(B * n, L)), t(p_mask.reshape(B * n, L)), "f",
                                 **kw)
    np.testing.assert_allclose(p_emb.numpy(), p_ref.numpy(), rtol=0, atol=1e-5)
    jq, jp, jscore, jloss = jm.apply({"params": params}, q_ids, q_mask, p_ids, p_mask, gold)
    np.testing.assert_allclose(q_emb.numpy(), np.asarray(jq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(p_emb.numpy(), np.asarray(jp), rtol=0, atol=1e-5)
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), rtol=0, atol=1e-5)
    assert abs(float(loss) - float(jloss)) < 1e-6


def test_kl_div_loss_matches_jax():
    """Zero gold terms add 0 and count in the mean, as torch KLDivLoss does."""
    rng = np.random.default_rng(1)
    score = rng.normal(size=(4, 6)).astype(np.float32)
    gold = rng.random((4, 6)).astype(np.float32)
    gold /= gold.sum(-1, keepdims=True)
    gold[0, 3] = 0.0
    gold[2] = 0.0
    got = float(kl_div_loss(torch.from_numpy(score), torch.from_numpy(gold)))
    want = float(jax_kl_div_loss(jnp.asarray(score), jnp.asarray(gold)))
    assert abs(got - want) < 1e-6
    ref = float(torch.nn.KLDivLoss()(torch.log_softmax(torch.from_numpy(score), -1),
                                     torch.from_numpy(gold)))
    assert abs(got - ref) < 1e-6


def test_train_step_matches_jax_value_and_grad():
    """The loss and every parameter's gradient at dropout 0 against
    jax.value_and_grad, rtol 1e-4."""
    jcfg, pcfg = _configs()
    jm, params = _jax_retriever(jcfg, seed=3)
    model = Retriever(pcfg)
    model.load_state_dict(params_from_jax(params))
    rng = np.random.default_rng(4)
    B, n, L = 4, 3, 8
    args = [_ids(rng, (B, L)), rng.random((B, L)) < 0.8, _ids(rng, (B, n, L)),
            rng.random((B, n, L)) < 0.8]
    args[1][:, 0] = True
    args[3][..., 0] = True
    gold = rng.random((B, n)).astype(np.float32)
    gold /= gold.sum(-1, keepdims=True)

    def loss_fn(p):
        return jm.apply({"params": p}, *args, gold, deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(0)})[3]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    model.train()
    loss = model(*(torch.from_numpy(a) for a in args), torch.from_numpy(gold))[3]
    names = [n_ for n_, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    want = _flat(jax.tree_util.tree_map(np.asarray, jgrads))
    paths = jax_param_paths(model)
    assert sorted(paths.values()) == sorted(want)
    for name, g in zip(names, grads):
        path = paths[name]
        w = want[path].T if path.endswith("kernel") else want[path]
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6, err_msg=path)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train_retriever on each side from one flax init (dropout 0, AdamW
    with weight decay): the JAX package on its 8-device CPU mesh at 1 a
    device, the port on one device at 8, so the same batches."""
    wd = tmp_path_factory.mktemp("torch_retriever")
    jtok, ptok = _bert_tokenizers()
    common = dict(eval_batch_size=4, epochs=3, early_stop=3, n_context=4, dtype="float32",
                  seed=1, name="r")
    optim = dict(optim="adamw", lr=2e-3, weight_decay=0.1)
    jcfg_r, pcfg_r = _configs()
    jcfg = jax_config.RetrieverTrainConfig(
        per_device_batch_size=1, retriever=jcfg_r, optim=jax_config.OptimConfig(**optim),
        checkpoint_dir=str(wd / "jax"), **common)
    pcfg = port_config.RetrieverTrainConfig(
        per_device_batch_size=8, retriever=pcfg_r, optim=port_config.OptimConfig(**optim),
        checkpoint_dir=str(wd / "port"), **common)
    _, params = _jax_retriever(jcfg_r, seed=5)
    init = params_from_jax(params)   # before the JAX run, which donates its buffers
    train, evals = make_examples(24, n_facts=4), make_examples(10, n_facts=4, seed=7)
    jres = jax_train_retriever(jcfg, train, evals, jtok, init_params=params)
    pres = train_retriever(pcfg, train, evals, ptok, init_params=init, device="cpu")
    return dict(jax=jres, port=pres, jcfg=jcfg, pcfg=pcfg, jtok=jtok, ptok=ptok, evals=evals,
                dir=wd)


def test_train_retriever_matches_jax(trained):
    """Steps, per-epoch losses (rtol 1e-5) and inversions equal, the history
    keys alike, and the same best_dev / last saves with equal metadata."""
    j, p = trained["jax"], trained["port"]
    assert p.final_step == j.final_step == 9
    assert [sorted(h) for h in p.history] == [sorted(h) for h in j.history]
    np.testing.assert_allclose([h["loss"] for h in p.history],
                               [h["loss"] for h in j.history], rtol=1e-5)
    assert [h["inversions"] for h in p.history] == [h["inversions"] for h in j.history]
    assert p.best_inversions == j.best_inversions
    for side in ("jax", "port"):
        ckpt = trained["dir"] / side / "r" / "checkpoint"
        assert sorted(x.name for x in ckpt.iterdir()) == ["best_dev", "last", "latest"]
    metas = [json.loads((trained["dir"] / s / "r/checkpoint" / name / "meta.json").read_text())
             for name in ("best_dev", "last") for s in ("jax", "port")]
    assert metas[0] == metas[1] and metas[2] == metas[3]


def test_evaluate_retriever_matches_jax(trained):
    """The trained models' inversions, avg_topk and idx_topk equal."""
    jcfg, pcfg = trained["jcfg"], trained["pcfg"]
    jm = JaxRetriever(jcfg.retriever)
    jds = JaxReaderDataset(jax_sort_facts(trained["evals"]),
                           jax_config.ReaderDataConfig(n_context=4))
    jcol = JaxRetrieverCollator(trained["jtok"], 4, 16, 12)
    want = jax_evaluate_retriever(jax_score_fn(jm), trained["jax"].state.params, jds, jcol, 4)
    model = trained["port"]
    pds = ReaderDataset(sort_facts_by_gold(trained["evals"]),
                        port_config.ReaderDataConfig(n_context=4))
    pcol = RetrieverCollator(trained["ptok"], 4, 16, 12)
    port_model = Retriever(pcfg.retriever)
    with torch.no_grad():
        for name, p in port_model.named_parameters():
            p.copy_(model.state.params[jax_param_paths(port_model)[name]])
    got = evaluate_retriever(make_retriever_score_fn(port_model), pds, pcol, 4, device="cpu")
    assert got == want
    assert got["total"] == 10


@pytest.mark.parametrize("score", [True, False])
def test_copied_retriever_collators_match(score):
    """RetrieverCollator and TextCollator copies give identical arrays,
    padding rows and truncation included."""
    jtok, ptok = _bert_tokenizers()
    examples = make_examples(5, n_facts=6, seed=2)
    if not score:
        for ex in examples:
            for f in ex["fact"]:
                del f["score"]
    data = dict(n_context=4)
    jds = JaxReaderDataset(examples, jax_config.ReaderDataConfig(**data))
    pds = ReaderDataset(examples, port_config.ReaderDataConfig(**data))
    jb = JaxRetrieverCollator(jtok, 4, 9, 6)([jds[i] for i in range(5)], pad_to=8)
    pb = RetrieverCollator(ptok, 4, 9, 6)([pds[i] for i in range(5)], pad_to=8)
    for f in dataclasses.fields(jb):
        np.testing.assert_array_equal(getattr(pb, f.name), getattr(jb, f.name), err_msg=f.name)
    rows = [{"sentence": f["sentence"], "id": 10 + i} for i, f in enumerate(examples[0]["fact"])]
    for got, want in zip(TextCollator(ptok, 5)(rows, pad_to=8),
                         JaxTextCollator(jtok, 5)(rows, pad_to=8)):
        np.testing.assert_array_equal(got, want)


def test_init_retriever_statistics():
    """Every Dense kernel and embedding normal(0.02), biases 0, LayerNorms
    1/0, as the flax init; the same parameter names and shapes as the flax
    tree."""
    cfg = port_config.RetrieverConfig(bert=port_config.BertConfig(
        vocab_size=3000, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=256, max_position_embeddings=128), indexing_dimension=64)
    model = init_retriever(cfg, torch.Generator().manual_seed(0))
    assert not model.training
    jcfg = jax_config.RetrieverConfig(bert=jax_config.BertConfig(**dataclasses.asdict(cfg.bert)),
                                      indexing_dimension=64)
    _, params = _jax_retriever(jcfg)
    flax_sd = params_from_jax(params)
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in flax_sd.items()}
    paths = jax_param_paths(model)
    for name, value in sd.items():
        path, ref = paths[name], flax_sd[name]
        if path.endswith(("kernel", "embedding")):
            # five standard errors of the sample mean and std of normal(0.02)
            n = value.numel()
            assert abs(float(value.mean())) < 5 * 0.02 / n ** 0.5, path
            for std in (float(value.std()), float(ref.std())):
                assert abs(std - 0.02) < 5 * 0.02 / (2 * n) ** 0.5, path
        else:
            torch.testing.assert_close(value, ref, rtol=0, atol=0, msg=path)
    assert not torch.equal(sd["bert.layer_0.attention.query.weight"],
                           init_retriever(cfg, torch.Generator().manual_seed(1)).state_dict()[
                               "bert.layer_0.attention.query.weight"])


def _hf_state_dict(cfg, rng):
    """A random state_dict under HF BertModel's names and shapes."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    sd = {"embeddings.word_embeddings.weight": (cfg.vocab_size, h),
          "embeddings.position_embeddings.weight": (cfg.max_position_embeddings, h),
          "embeddings.token_type_embeddings.weight": (cfg.type_vocab_size, h),
          "embeddings.LayerNorm.weight": (h,), "embeddings.LayerNorm.bias": (h,)}
    for i in range(cfg.num_hidden_layers):
        p = f"encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key", "attention.self.value",
                     "attention.output.dense"):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = (h, h), (h,)
        sd[p + "intermediate.dense.weight"], sd[p + "intermediate.dense.bias"] = (f, h), (f,)
        sd[p + "output.dense.weight"], sd[p + "output.dense.bias"] = (h, f), (h,)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = (h,), (h,)
    return {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in sd.items()}


@pytest.mark.parametrize("prefix", ["", "bert."])
def test_hf_converter_matches_jax(prefix):
    """state_dict_from_hf_bert equals, bitwise, params_from_jax of the JAX
    converter's tree (with and without a key prefix), and loads into the
    port's BertEncoder."""
    jcfg, pcfg = _configs()
    sd = _hf_state_dict(pcfg.bert, np.random.default_rng(6))
    prefixed = {f"{prefix}{k}": v for k, v in sd.items()}
    got = state_dict_from_hf_bert(prefixed, pcfg.bert, prefix=prefix)
    want = params_from_jax(params_from_torch_bert(prefixed, jcfg.bert, prefix=prefix))
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    BertEncoder(pcfg.bert).load_state_dict(got)


def test_position_table_and_vocabulary_checks_raise():
    """Tokenizing past the position table raises FloatingPointError
    ("non-finite") before the lookup, where the JAX model's NaN reaches its
    finite check; so does a token id past the vocabulary. The trained
    lengths are the defaults and give finite embeddings."""
    _, pcfg = _configs()
    model = init_retriever(pcfg, torch.Generator().manual_seed(0))
    _, ptok = _bert_tokenizers()
    exs = [{"question": "what sound does the cat make?", "caption": "a cat sitting on the grass."}]
    q = embed_questions(model, exs, ptok, batch_size=4)
    assert np.isfinite(q).all() and q.shape == (1, 16)
    ids, emb = embed_corpus(model, [{"sentence": "cat says meow.", "id": 3}], ptok, batch_size=4)
    assert np.isfinite(emb).all() and list(ids) == [3]
    with pytest.raises(FloatingPointError, match="non-finite"):
        embed_questions(model, exs, ptok, batch_size=4, maxlength=130)
    with pytest.raises(FloatingPointError, match="non-finite"):
        model.bert(torch.zeros((1, 65), dtype=torch.int64))
    small = init_retriever(dataclasses.replace(
        pcfg, bert=dataclasses.replace(pcfg.bert, vocab_size=50)), torch.Generator())
    with pytest.raises(FloatingPointError, match="non-finite"):
        embed_corpus(small, [{"sentence": "cat says meow.", "id": 3}], ptok)


def test_train_retriever_refusals(monkeypatch):
    """Without a card it raises rather than falling back to the CPU; more
    than one device names ROADMAP item 12."""
    _, pcfg_r = _configs()
    cfg = port_config.RetrieverTrainConfig(retriever=pcfg_r, n_context=4)
    _, ptok = _bert_tokenizers()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_retriever(cfg, make_examples(4), [], ptok, save_checkpoints=False)
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        train_retriever(cfg.replace(mesh=port_config.MeshConfig(data=2)), make_examples(4), [],
                        ptok, save_checkpoints=False, device="cpu")
