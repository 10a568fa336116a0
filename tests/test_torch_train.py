"""The port's reader training against the JAX package's (f32, CPU).

Optimizer, schedule and no-decay mask against lako_tpu.train.optim; the
train step against ``make_reader_train_step`` from the same flax init and the
same batches (the JAX side runs its streamed Pallas kernels in interpret
mode, the port the plain versions of its CUDA kernels); ``train_reader`` on
the synthetic fixture; and the framework-free copies pinned to their
originals.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lako_tpu.core import config as jax_config
from lako_tpu.data.loader import batch_iterator as jax_batch_iterator
from lako_tpu.models.t5.model import FiDT5 as JaxFiDT5
from lako_tpu.text.metrics import ems as jax_ems
from lako_tpu.text.normalize import normalize_answer as jax_normalize
from lako_tpu.train import optim as jax_optim
from lako_tpu.train.reader import make_reader_train_step as jax_train_step
from lako_tpu.train.reader import train_reader as jax_train_reader
from lako_tpu.train.state import TrainState as JaxTrainState
from lako_tpu_torch.core import config as port_config
from lako_tpu_torch.data import batch_iterator
from lako_tpu_torch.models.t5 import FiDT5, jax_param_paths, params_from_jax
from lako_tpu_torch.text.metrics import ems
from lako_tpu_torch.text.normalize import normalize_answer
from lako_tpu_torch.train import optim
from lako_tpu_torch.train.reader import (
    _apply_param_dtype,
    make_reader_train_step,
    model_params,
    train_reader,
)
from lako_tpu_torch.train.state import TrainState
from lako_tpu_torch.text.tokenizer import WordVocabTokenizer
from tests.fixtures import corpus_sentences, make_examples, make_tokenizer

TINY = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2,
            num_decoder_layers=2, num_heads=4, relative_attention_num_buckets=8,
            dropout_rate=0.0)


def _port_tokenizer():
    """The port's copy of tests/fixtures.py make_tokenizer."""
    return WordVocabTokenizer.build(corpus_sentences() + [
        "question: what sound does the animal make? context: a animal sitting on the grass. fact:",
    ])


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "layer_3": {"attn": {"kernel": rng.normal(size=(4, 5)).astype(np.float32),
                             "bias": rng.normal(size=(5,)).astype(np.float32)}},
        "layer_6": {"ln_attn": {"weight": rng.normal(size=(5,)).astype(np.float32)}},
        "head": {"kernel": rng.normal(size=(5, 3)).astype(np.float32)},
        "final_norm": {"scale": rng.normal(size=(3,)).astype(np.float32)},
    }


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _port_layout(path, a):
    """A leaf as the port holds it: dense kernels transposed to (out, in)."""
    return np.ascontiguousarray(a.T) if path.endswith("kernel") else a.copy()


@pytest.mark.parametrize("optim_name,correct,layerwise,accum", [
    ("adamw", None, None, 1),
    ("adamw", True, 0.8, 1),
    ("adam", None, None, 1),
    ("adam", False, 0.8, 2),
    ("adamw", None, None, 2),
    ("adamw8bit", None, None, 1),
    ("adamw8bit", True, 0.8, 1),
    ("adamw8bit", None, None, 2),
])
def test_optimizer_matches_jax(optim_name, correct, layerwise, accum):
    """Updates and parameters over 3 updates (x accum calls), clipping
    engaged, warmup from lr 0, within 1e-6. The port holds dense kernels
    as (out, in); adamw8bit blocks them in the JAX layout, so its 8-bit
    codes, and with them the updates, are the JAX package's."""
    kw = dict(optim=optim_name, lr=1e-2, weight_decay=0.1, clip=0.5, warmup_steps=2,
              total_steps=10, adam_correct_bias=correct, layerwise_decay=layerwise,
              accumulation_steps=accum)
    jtx = jax_optim.make_optimizer(jax_config.OptimConfig(**kw))
    tx = optim.make_optimizer(port_config.OptimConfig(**kw))
    jparams = jax.tree_util.tree_map(jnp.asarray, _tree())
    params = {k: torch.from_numpy(_port_layout(k, v)) for k, v in _flat(_tree()).items()}
    jstate, state = jtx.init(jparams), tx.init(params)
    for i in range(3 * accum):
        grads = _tree(seed=10 + i)
        jupd, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = jax_optim.optax.apply_updates(jparams, jupd)
        upd, state = tx.update({k: torch.from_numpy(_port_layout(k, v))
                                for k, v in _flat(grads).items()}, state, params)
        optim.apply_updates(params, upd)
        for k, v in _flat(jax.tree_util.tree_map(np.asarray, jupd)).items():
            np.testing.assert_allclose(upd[k].numpy(), _port_layout(k, v), rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    for k, v in _flat(jax.tree_util.tree_map(np.asarray, jparams)).items():
        np.testing.assert_allclose(params[k].numpy(), _port_layout(k, v), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
        assert not np.array_equal(v, _flat(_tree())[k]), k   # every leaf moved


def test_warmup_linear_schedule_matches_jax():
    for args in [(1.0, 10, 110), (3e-4, 6, 100, 0.1), (2.0, 0, 50), (1.0, 5, 40, 0.2, True)]:
        jsched = jax_optim.warmup_linear_schedule(*args)
        sched = optim.warmup_linear_schedule(*args)
        got = [sched(s) for s in range(130)]
        np.testing.assert_allclose(got, [float(jsched(s)) for s in range(130)],
                                   rtol=1e-6, atol=1e-9)
    assert optim.warmup_linear_schedule(1.0, 10, 110)(0) == 0.0


def test_clip_is_optax_and_unported_optimizers_raise():
    """No clipping below the bound, exactly g*clip/norm above it; one
    Adafactor step (ported since ROADMAP item 13 was done) against optax's
    within rtol 1e-6 (tests/test_torch_adafactor.py has the rest)."""
    tx = optim.clip_by_global_norm(5.0)
    g = {"a": torch.tensor([3.0, 4.0])}
    assert torch.equal(tx.update(g, ())[0]["a"], g["a"])
    np.testing.assert_allclose(optim.clip_by_global_norm(1.0).update(g, ())[0]["a"].numpy(),
                               [0.6, 0.8], rtol=1e-7)
    cfg = dict(optim="adafactor", lr=1e-2, warmup_steps=0, total_steps=10)
    rng = np.random.default_rng(0)
    p = {"w/kernel": rng.standard_normal((128, 256)).astype(np.float32),
         "b": rng.standard_normal(7).astype(np.float32)}
    gr = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
    jtx = jax_optim._build_optimizer(jax_config.OptimConfig(**cfg))
    jp = {"w": {"kernel": jnp.asarray(p["w/kernel"])}, "b": jnp.asarray(p["b"])}
    ju, _ = jtx.update({"w": {"kernel": jnp.asarray(gr["w/kernel"])}, "b": jnp.asarray(gr["b"])},
                       jtx.init(jp), jp)
    tx = optim.make_optimizer(port_config.OptimConfig(**cfg))
    tp = {"w/kernel": torch.from_numpy(p["w/kernel"].T.copy()), "b": torch.from_numpy(p["b"])}
    u, _ = tx.update({"w/kernel": torch.from_numpy(gr["w/kernel"].T.copy()),
                      "b": torch.from_numpy(gr["b"])}, tx.init(tp), tp)
    np.testing.assert_allclose(u["w/kernel"].numpy().T, np.asarray(ju["w"]["kernel"]),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(u["b"].numpy(), np.asarray(ju["b"]), rtol=1e-6)


def _jax_model_and_params(seed=1, **overrides):
    kw = dict(TINY, **overrides)
    jm = JaxFiDT5(jax_config.T5Config(**kw), dtype=jnp.float32, use_remat=True)
    ids, mask, labels = _batches(1)[0]
    params = jm.init(jax.random.PRNGKey(seed), ids, mask, labels)["params"]
    return kw, jm, params


def test_decayed_parameters_match_no_decay_mask():
    """The set of decayed JAX paths is the JAX mask's, computed on the port's
    parameter names through jax_param_paths."""
    kw, _, params = _jax_model_and_params(tie_word_embeddings=False)
    jmask = _flat(jax.tree_util.tree_map(np.asarray, jax_optim._no_decay_mask(params)))
    model = FiDT5(port_config.T5Config(**kw))
    mask = optim._no_decay_mask(model_params(model))
    assert set(mask) == set(jmask)
    assert {k for k, v in mask.items() if v} == {k for k, v in jmask.items() if v}
    assert not mask["t5/encoder/block_0/ln_attn/weight"]
    assert mask["t5/encoder/block_0/self_attn/q/kernel"]
    assert jax_param_paths(model)["t5.shared.weight"] == "t5/shared/embedding"


def _batches(n, B=2, N=2, L=20, T=5, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(1, 64, size=(B, N, L)).astype(np.int32)
        mask = rng.random((B, N, L)) < 0.8
        mask[..., 0] = True
        labels = rng.integers(1, 64, size=(B, T)).astype(np.int32)
        labels[0, 3:] = -100
        out.append((ids, mask, labels))
    return out


@pytest.fixture(scope="module")
def three_steps():
    """Three train steps of the tiny model in both packages: flash route
    (flash_min_length <= L), remat on, f32, no dropout, AdamW with clipping.
    Returns (jax losses, jax params after, port losses, port model,
    jax grads of step 1, port grads of step 1)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LAKO_FLASH_INTERPRET", "1")
    try:
        kw, jm, params = _jax_model_and_params(use_flash_attention=True, flash_min_length=16)
        okw = dict(lr=1e-3, weight_decay=0.1, clip=1.0, warmup_steps=0, total_steps=10)
        model = FiDT5(port_config.T5Config(**kw), use_remat=True)
        model.load_state_dict(params_from_jax(params))
        state = TrainState.create(model_params(model),
                                  optim.make_optimizer(port_config.OptimConfig(**okw)))
        step = make_reader_train_step(model)

        batches = _batches(3)
        ids, mask, labels = batches[0]
        jgrads = jax.grad(lambda p: jm.apply({"params": p}, ids, mask, labels)[0])(params)
        model.train()
        loss = model(*(torch.from_numpy(a) for a in batches[0]))[0]
        grads = dict(zip(model_params(model), torch.autograd.grad(
            loss, list(model_params(model).values()))))

        jstate = JaxTrainState.create(params, jax_optim.make_optimizer(
            jax_config.OptimConfig(**okw)))
        jstep = jax_train_step(jm)
        jlosses, losses = [], []
        for ids, mask, labels in batches:
            jstate, jloss = jstep(jstate, ids, mask, labels, jax.random.PRNGKey(0))
            jlosses.append(float(jloss))
            state, loss = step(state, *(torch.from_numpy(a) for a in (ids, mask, labels)), 0)
            losses.append(float(loss))
        yield jlosses, jstate.params, losses, model, jgrads, grads
    finally:
        mp.undo()


def test_train_step_matches_jax(three_steps):
    """Loss at each step within rtol 1e-5; parameters after 3 steps within
    atol 1e-5."""
    jlosses, jparams, losses, model, _, _ = three_steps
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[2] != losses[0]
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


def test_relpos_gradient_through_streamed_bias(three_steps):
    """On the flash route the encoder's relative-position embedding is fed
    only through the streamed kernel's bias, so its gradient comes from drel
    (K2c): nonzero, and equal to JAX's within the train-step tolerance."""
    _, _, _, _, jgrads, grads = three_steps
    g = grads["t5/encoder/relpos/rel_embedding"]
    want = np.asarray(jgrads["t5"]["encoder"]["relpos"]["rel_embedding"])
    assert float(g.abs().max()) > 1e-4
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=1e-5)
    for path, g in grads.items():   # every other gradient agrees too
        want = _flat(jax.tree_util.tree_map(np.asarray, jgrads))[path]
        np.testing.assert_allclose(g.numpy(), want.T if path.endswith("kernel") else want,
                                   rtol=1e-4, atol=1e-5, err_msg=path)


def test_bf16_param_dtype_keeps_bf16_masters_and_moments():
    cfg = port_config.ReaderTrainConfig(param_dtype="bfloat16", dtype="bfloat16")
    model = _apply_param_dtype(cfg, FiDT5(port_config.T5Config(**TINY), torch.bfloat16),
                               logging.getLogger())
    tx = optim.make_optimizer(port_config.OptimConfig(lr=1e-3, warmup_steps=0))
    state = TrainState.create(model_params(model), tx)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.1)
    step = make_reader_train_step(model)
    before = {k: v.clone() for k, v in state.params.items()}
    state, loss = step(state, *(torch.from_numpy(a) for a in _batches(1)[0]), 0)
    assert torch.isfinite(loss)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    _, adam, *_ = state.opt_state
    assert {t.dtype for t in [*adam.mu.values(), *adam.nu.values()]} == {torch.bfloat16}
    assert any(not torch.equal(before[k], v) for k, v in state.params.items())
    with pytest.raises(ValueError, match="param_dtype"):
        _apply_param_dtype(port_config.ReaderTrainConfig(param_dtype="fp8"), model,
                           logging.getLogger())
    assert {p.dtype for p in _apply_param_dtype(port_config.ReaderTrainConfig(), model,
                                                logging.getLogger()).parameters()} == {torch.float32}


def _fixture_config(cfg_module, **overrides):
    t5 = cfg_module.T5Config(vocab_size=_port_tokenizer().vocab_size, d_model=32, d_kv=8,
                             d_ff=64, num_layers=2, num_decoder_layers=2, num_heads=4,
                             relative_attention_num_buckets=8, dropout_rate=0.0,
                             use_flash_attention=True, flash_min_length=16)
    cfg = cfg_module.ReaderTrainConfig(
        model_size="tiny", per_device_batch_size=4, eval_batch_size=8, epochs=3,
        early_stop=5, eval_max_length=4, use_remat=True, dtype="float32",
        data=cfg_module.ReaderDataConfig(n_context=2, text_maxlength=20,
                                         answer_maxlength=4, stream=2),
        optim=cfg_module.OptimConfig(optim="adamw", lr=3e-3, weight_decay=0.0),
        checkpoint_dir="/nonexistent", name="port", **overrides)
    return cfg, t5


def test_train_reader_on_fixture():
    """3 epochs on 16 examples: the loss falls, EM is a number in [0, 1],
    history entries carry the JAX function's keys (its run on one example
    per device of the 8-device CPU mesh gives them)."""
    tok = _port_tokenizer()
    cfg, t5 = _fixture_config(port_config)
    result = train_reader(cfg, make_examples(16, n_facts=2), make_examples(6, n_facts=2, seed=9),
                          tok, t5_config=t5, save_checkpoints=False, device="cpu")
    losses = [h["loss"] for h in result.history]
    assert losses[-1] < losses[0], losses
    assert all(0.0 <= h["em"] <= 1.0 for h in result.history)
    assert result.final_step == 3 * 4 and result.epochs_run == 3
    assert result.state.step == result.final_step

    jcfg, jt5 = _fixture_config(jax_config, eval_every=2)
    jcfg = jcfg.replace(per_device_batch_size=1, epochs=2, eval_max_length=2,
                        use_remat=False)
    jres = jax_train_reader(jcfg, make_examples(8, n_facts=2), make_examples(2, n_facts=2),
                            make_tokenizer(),
                            t5_config=jt5.replace(use_flash_attention=False),
                            save_checkpoints=False)
    port = train_reader(cfg.replace(eval_every=2, epochs=2), make_examples(8, n_facts=2),
                        make_examples(2, n_facts=2), tok, t5_config=t5,
                        save_checkpoints=False, device="cpu")
    assert [sorted(h) for h in port.history] == [sorted(h) for h in jres.history]
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(jres)]


@pytest.mark.parametrize("change,item", [
    (dict(cfg=dict(mesh=port_config.MeshConfig(pipe=2))), "item 12"),
    (dict(cfg=dict(mesh=port_config.MeshConfig(data=2))), "item 12"),
])
def test_train_reader_unported_options_raise(change, item):
    cfg, t5 = _fixture_config(port_config)
    kw = dict(save_checkpoints=False, device="cpu")
    kw.update({k: v for k, v in change.items() if k != "cfg"})
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        train_reader(cfg.replace(**change.get("cfg", {})), make_examples(4), [], _port_tokenizer(),
                     t5_config=t5, **kw)


@pytest.mark.parametrize("impl,warns", [("gather", True), ("allslots", False)])
def test_train_reader_passes_self_attn_impl(impl, warns, caplog):
    """train_reader hands decode_self_attn_impl to make_best_generate_fn, as
    the JAX function does: greedy eval warns that it ignores a value other
    than the default, in the JAX package's words, and stays silent at the
    default."""
    from lako_tpu.models.t5.decode import make_best_generate_fn as jax_best_generate_fn

    loggers = [logging.getLogger(n) for n in ("lako_tpu", "lako_tpu_torch")]
    for lg in loggers:     # a CLI run in this process may have cut propagation
        lg.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING):
            jcfg, jt5 = _fixture_config(jax_config)
            jax_best_generate_fn(JaxFiDT5(jt5), max_length=4, self_attn_impl=impl)
            cfg, t5 = _fixture_config(port_config, decode_self_attn_impl=impl)
            train_reader(cfg.replace(epochs=1), make_examples(4, n_facts=2),
                         make_examples(2, n_facts=2), _port_tokenizer(), t5_config=t5,
                         save_checkpoints=False, device="cpu")
    finally:
        for lg in loggers:
            lg.removeHandler(caplog.handler)
    said = {name: {r.getMessage() for r in caplog.records
                   if r.name == name and "self_attn_impl" in r.getMessage()}
            for name in ("lako_tpu", "lako_tpu_torch")}
    assert said["lako_tpu_torch"] == said["lako_tpu"]
    assert len(said["lako_tpu"]) == warns


@pytest.mark.parametrize("kw", [dict(), dict(shuffle=True, seed=3, drop_last=True),
                                dict(pad_final=False), dict(num_batches=5),
                                dict(shuffle=True, seed=1, prefetch=2)])
def test_batch_iterator_copy_matches(kw):
    data = list(range(11))

    def collate(items, pad_to=None):
        return (tuple(items), pad_to)

    assert list(batch_iterator(data, 4, collate, **kw)) == \
        list(jax_batch_iterator(data, 4, collate, **kw))


def test_normalize_and_ems_copies_match():
    answers = ["The Cat!", "an apple", "a", "theater", "A man, a plan", "  dog's  bowl ",
               "Yes", "the the", "Éclair the", "there an", "ok-vqa", "Wolf (gray)"]
    for a in answers:
        assert normalize_answer(a) == jax_normalize(a), a
        assert normalize_answer(a, dele_sw=True) == jax_normalize(a, dele_sw=True), a
        gold = {"cat": 1.0, "apple": 0.6, "man plan": 0.3, "dogs bowl": 0.9}
        assert ems(a, gold) == jax_ems(a, gold), a


@pytest.fixture(scope="module")
def three_steps_fused():
    """Three train steps of the tiny model in both packages on the
    whole-block route (use_flash_attention at the default flash_min_length
    512 > L, which the JAX package sends to its fused Pallas kernel on a TPU
    and to plain attention here; the port to K4's wrapper), remat on, f32,
    AdamW with 8-bit moments. Returns (jax losses, jax params after, port
    losses, port model, jax grads of step 1, port grads of step 1, K4 calls
    per step)."""
    from lako_tpu_torch.models.t5 import layers

    kw, jm, params = _jax_model_and_params(use_flash_attention=True)
    assert kw.get("flash_min_length", 512) > 20
    okw = dict(optim="adamw8bit", lr=1e-3, weight_decay=0.1, clip=1.0, warmup_steps=0,
               total_steps=10)
    model = FiDT5(port_config.T5Config(**kw), use_remat=True)
    model.load_state_dict(params_from_jax(params))
    state = TrainState.create(model_params(model),
                              optim.make_optimizer(port_config.OptimConfig(**okw)))
    step = make_reader_train_step(model)
    calls = []
    real = layers.fused_attention
    mp = pytest.MonkeyPatch()
    mp.setattr(layers, "fused_attention", lambda *a: calls.append(1) or real(*a))
    try:
        batches = _batches(3)
        ids, mask, labels = batches[0]
        jgrads = jax.grad(lambda p: jm.apply({"params": p}, ids, mask, labels)[0])(params)
        model.train()
        loss = model(*(torch.from_numpy(a) for a in batches[0]))[0]
        grads = dict(zip(model_params(model), torch.autograd.grad(
            loss, list(model_params(model).values()))))
        calls.clear()

        jstate = JaxTrainState.create(params, jax_optim.make_optimizer(
            jax_config.OptimConfig(**okw)))
        jstep = jax_train_step(jm)
        jlosses, losses = [], []
        for ids, mask, labels in batches:
            jstate, jloss = jstep(jstate, ids, mask, labels, jax.random.PRNGKey(0))
            jlosses.append(float(jloss))
            state, loss = step(state, *(torch.from_numpy(a) for a in (ids, mask, labels)), 0)
            losses.append(float(loss))
        yield jlosses, jstate.params, losses, model, jgrads, grads, len(calls) / len(batches)
    finally:
        mp.undo()


def test_fused_route_adamw8bit_train_step_matches_jax(three_steps_fused):
    """Loss at each step within rtol 1e-5, every encoder layer through K4's
    wrapper twice a step (forward and remat recompute). Parameters after 3
    steps within atol 1e-5, except where a stochastic-rounding decision of
    an 8-bit moment code flipped: the two frameworks' gradients differ by
    float32 ulps, and a dither that falls within an ulp of the fraction
    rounds the other way. Such elements are at most 1 in 1000, each within
    one learning rate (1e-3) of JAX's."""
    jlosses, jparams, losses, model, _, _, calls = three_steps_fused
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[2] != losses[0]
    assert calls == 2 * TINY["num_layers"]
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    off = total = 0
    for name, p in model.state_dict().items():
        diff = np.abs(p.numpy() - want[name].numpy())
        assert diff.max() <= 1e-3, name
        off, total = off + int((diff > 1e-5).sum()), total + diff.size
    assert off <= total // 1000, (off, total)


def test_relpos_gradient_through_fused_bias(three_steps_fused):
    """On the whole-block route the encoder's relative-position embedding
    learns through K4's bias gradient (which the JAX kernel's backward
    drops): nonzero and equal to JAX's plain-attention gradient."""
    _, _, _, _, jgrads, grads, _ = three_steps_fused
    g = grads["t5/encoder/relpos/rel_embedding"]
    want = np.asarray(jgrads["t5"]["encoder"]["relpos"]["rel_embedding"])
    assert float(g.abs().max()) > 1e-4
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=1e-5)
    for path, g in grads.items():
        want = _flat(jax.tree_util.tree_map(np.asarray, jgrads))[path]
        np.testing.assert_allclose(g.numpy(), want.T if path.endswith("kernel") else want,
                                   rtol=1e-4, atol=1e-5, err_msg=path)


def test_train_reader_adamw8bit_matches_jax():
    """train_reader with optim="adamw8bit" from the same init on the fixture:
    the port on one device at batch 8, the JAX package on its 8-device CPU
    mesh at 1 a device, so the same batches; the loss of each epoch within
    rtol 1e-5, and the history keys alike."""
    tok = _port_tokenizer()
    cfg, t5 = _fixture_config(port_config)
    cfg = cfg.replace(per_device_batch_size=8, epochs=2, eval_every=2, eval_max_length=2,
                      use_remat=False, optim=cfg.optim.replace(optim="adamw8bit"))
    jcfg, jt5 = _fixture_config(jax_config, eval_every=2)
    jcfg = jcfg.replace(per_device_batch_size=1, epochs=2, eval_max_length=2, use_remat=False,
                        optim=jcfg.optim.replace(optim="adamw8bit"))
    jt5 = jt5.replace(use_flash_attention=False)
    jm = JaxFiDT5(jt5, dtype=jnp.float32)
    ids, mask, labels = (np.zeros((2, 2, 20), np.int32), np.ones((2, 2, 20), bool),
                         np.zeros((2, 4), np.int32))
    params = jm.init(jax.random.PRNGKey(4), ids, mask, labels)["params"]
    train, evals = make_examples(16, n_facts=2), make_examples(2, n_facts=2)
    init = params_from_jax(params)   # before the JAX run, which donates its buffers
    jres = jax_train_reader(jcfg, train, evals, make_tokenizer(), init_params=params,
                            t5_config=jt5, save_checkpoints=False)
    port = train_reader(cfg, train, evals, tok, init_params=init,
                        t5_config=t5.replace(use_flash_attention=False),
                        save_checkpoints=False, device="cpu")
    assert port.final_step == jres.final_step == 4
    np.testing.assert_allclose([h["loss"] for h in port.history],
                               [h["loss"] for h in jres.history], rtol=1e-5)
    assert [sorted(h) for h in port.history] == [sorted(h) for h in jres.history]
