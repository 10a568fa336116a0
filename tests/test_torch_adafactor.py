"""The port's Adafactor against ``optax.adafactor`` as the JAX package
builds it (lako_tpu/train/optim.py), on the CPU.

Three updates (six calls under 2-step accumulation) of the same seeded
gradients through both chains, on a leaf set with square, wide, tall,
1-D and under-128 leaves (dense kernels stored transposed in the port, so
the factored axes must follow the JAX leaf) and on a t5 param tree wide
enough to factor: the factored statistics within rtol 1e-6 of optax's and
the parameters within rtol 1e-5 (summation orders differ between XLA and
torch). The state round-trips bitwise through ``opt_state.pt``, and a full
resume through ``train_reader`` continues as the uninterrupted run does,
bitwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lako_tpu.core import config as jax_config
from lako_tpu.models.t5.model import FiDT5 as JaxFiDT5
from lako_tpu.train import optim as jax_optim
from lako_tpu_torch.core import config as port_config
from lako_tpu_torch.core.checkpoint import flatten_tree, load_checkpoint, save_checkpoint
from lako_tpu_torch.models.t5 import init_fid_t5, jax_param_paths
from lako_tpu_torch.train import optim
from lako_tpu_torch.train import reader as port_reader
from lako_tpu_torch.train.reader import train_reader
from tests.fixtures import make_examples
from tests.test_torch_train import _fixture_config, _port_tokenizer

STATE_RTOL = 1e-6
PARAM_RTOL = 1e-5
# JAX leaf shapes: square, wide and tall kernels, a 1-D leaf, a kernel below
# the factoring size, an embedding (not transposed in the port)
LEAVES = {"sq/kernel": (256, 256), "wide/kernel": (128, 384), "tall/kernel": (512, 130),
          "ln/weight": (300,), "small/kernel": (64, 200), "emb/embedding": (300, 160)}
OPTIM = dict(optim="adafactor", lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)


def _jax_tree(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *heads, leaf = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = v
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _port(path, arr):
    """A JAX leaf as the port stores it (kernels transposed)."""
    arr = np.array(arr, np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr.T if path.endswith("kernel") else arr))


def _factored_states(state):
    """The FactoredState inside a chain (and MultiSteps), optax's or the port's."""
    if hasattr(state, "v_row"):
        return [state]
    if hasattr(state, "inner_opt_state"):
        return _factored_states(state.inner_opt_state)
    if isinstance(state, tuple):
        return [s for x in state for s in _factored_states(x)]
    return []


def _run_both(jax_params, accumulation, steps=3, seed=0):
    """Both chains over ``steps`` updates of the same seeded gradients;
    returns (jax params, jax FactoredState, port params, port FactoredState)."""
    cfg = dict(OPTIM, accumulation_steps=accumulation)
    jtx = jax_optim._build_optimizer(jax_config.OptimConfig(**cfg))
    tx = optim.make_optimizer(port_config.OptimConfig(**cfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, jax_params)
    params = {k: _port(k, v) for k, v in _flat(jax_params).items()}
    jstate, state = jtx.init(jparams), tx.init(params)

    @jax.jit
    def jax_step(grads, jstate, jparams):
        jupd, jstate = jtx.update(grads, jstate, jparams)
        return jax.tree_util.tree_map(lambda p, u: p + u, jparams, jupd), jstate

    rng = np.random.default_rng(seed)
    for _ in range(steps * accumulation):
        grads = {k: (rng.standard_normal(v.shape) * rng.uniform(0.01, 3)).astype(np.float32)
                 for k, v in _flat(jax_params).items()}
        jparams, jstate = jax_step(_jax_tree(grads), jstate, jparams)
        upd, state = tx.update({k: _port(k, g) for k, g in grads.items()}, state, params)
        optim.apply_updates(params, upd)
    (jfact,), (fact,) = _factored_states(jstate), _factored_states(state)
    assert isinstance(fact, optim.FactoredState)
    return jparams, jfact, params, fact


def _t5_params():
    """A t5 tree wide enough to factor: square q/k/v/o (128, 128), d_ff 256,
    the shared embedding (160, 128)."""
    t5 = jax_config.T5Config(vocab_size=160, d_model=128, d_kv=64, d_ff=256, num_layers=1,
                             num_decoder_layers=1, num_heads=2,
                             relative_attention_num_buckets=8, dropout_rate=0.0)
    return JaxFiDT5(t5, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), np.zeros((1, 2, 8), np.int32), np.ones((1, 2, 8), bool),
        np.zeros((1, 4), np.int32))["params"]


def _leaf_params():
    rng = np.random.default_rng(7)
    return _jax_tree({k: (rng.standard_normal(s) * 0.05).astype(np.float32)
                      for k, s in LEAVES.items()})


@pytest.mark.parametrize("tree,accumulation", [("leaves", 1), ("leaves", 2), ("t5", 1),
                                               ("t5", 2)])
def test_adafactor_matches_optax(tree, accumulation):
    jax_params = _leaf_params() if tree == "leaves" else _t5_params()
    jparams, jfact, params, fact = _run_both(jax_params, accumulation)
    assert fact.count == int(jfact.count) == 3
    jflat = _flat(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(params) == set(jflat)
    n_factored = 0
    for name, field in (("v_row", fact.v_row), ("v_col", fact.v_col), ("v", fact.v)):
        want = _flat(jax.tree_util.tree_map(np.asarray, getattr(jfact, name)))
        assert set(field) == set(want)
        for k, got in field.items():
            assert tuple(got.shape) == want[k].shape, (name, k)
            np.testing.assert_allclose(got.numpy(), want[k], rtol=STATE_RTOL, atol=0,
                                       err_msg=f"{name} {k}")
            n_factored += name == "v_row" and want[k].shape != (1,)
    for k, p in params.items():
        want = jflat[k].T if k.endswith("kernel") else jflat[k]
        np.testing.assert_allclose(p.numpy(), want, rtol=PARAM_RTOL, atol=1e-7, err_msg=k)
    # the square, wide and tall kernels and the embedding are factored (t5:
    # every q/k/v/o, wi/wo and the shared embedding)
    assert n_factored == (4 if tree == "leaves" else 4 * 3 + 2 * 2 + 1)


def test_square_kernel_statistics_follow_the_jax_leaf():
    """For a square kernel the port's v_row is the mean over the JAX out
    axis, i.e. over the port's rows: the JAX leaf's row statistics."""
    tx = optim.scale_by_factored_rms()
    g = torch.randn(256, 256, generator=torch.Generator().manual_seed(0))
    params = {"sq/kernel": torch.zeros(256, 256), "sq/embedding": torch.zeros(256, 256)}
    _, state = tx.update({k: g for k in params}, tx.init(params), params)
    keep = 1 - (1 - torch.tensor(1.0) ** -0.8)
    torch.testing.assert_close(state.v_row["sq/kernel"], keep * (g * g + 1e-30).mean(0),
                               rtol=0, atol=0)
    torch.testing.assert_close(state.v_row["sq/embedding"], keep * (g * g + 1e-30).mean(1),
                               rtol=0, atol=0)


@pytest.mark.parametrize("accumulation", [1, 2])
def test_adafactor_state_round_trips_bitwise(tmp_path, accumulation):
    """Save after two updates, load into a fresh template: every tensor and
    count bitwise, and the next update from the loaded state bitwise the
    next update from the saved one."""
    params = {k: _port(k, v) for k, v in _flat(_leaf_params()).items()}
    tx = optim.make_optimizer(port_config.OptimConfig(**OPTIM,
                                                      accumulation_steps=accumulation))
    state = tx.init(params)
    g = torch.Generator().manual_seed(1)
    grads = [{k: torch.randn(p.shape, generator=g) for k, p in params.items()}
             for _ in range(3)]
    for gr in grads[:2]:
        _, state = tx.update(gr, state, params)
    save_checkpoint(str(tmp_path), "s", params, state, step=2)
    template = {k: torch.zeros_like(p) for k, p in params.items()}
    _, loaded, _ = load_checkpoint(str(tmp_path / "checkpoint" / "s"), template,
                                   tx.init(template))
    fa, fb = flatten_tree(state), flatten_tree(loaded)
    assert sorted(fa) == sorted(fb) and type(loaded) is type(state)
    for k, v in fa.items():
        assert (torch.equal(v, fb[k]) and v.dtype == fb[k].dtype if isinstance(v, torch.Tensor)
                else v == fb[k]), k
    ua, _ = tx.update(grads[2], state, params)
    ub, _ = tx.update(grads[2], loaded, params)
    assert all(torch.equal(ua[k], ub[k]) for k in ua)


def test_full_resume_with_adafactor_continues_the_run(tmp_path, monkeypatch):
    """One epoch, saved, then a full resume for one more epoch: the same
    losses, steps and parameters, bitwise, as two uninterrupted epochs
    (each epoch's shuffle pinned to one seed, since a resumed run counts its
    epochs from 1)."""
    real = port_reader.batch_iterator
    monkeypatch.setattr(port_reader, "batch_iterator",
                        lambda ds, bs, collator, shuffle=False, seed=0, **kw:
                        real(ds, bs, collator, shuffle=shuffle, seed=11, **kw))
    cfg, t5 = _fixture_config(port_config)
    cfg = cfg.replace(checkpoint_dir=str(tmp_path), epochs=2, early_stop=5,
                      optim=cfg.optim.replace(optim="adafactor", lr=1e-2, scheduler_steps=40))
    train, evals, tok = make_examples(8, n_facts=2), make_examples(4, n_facts=2, seed=9), \
        _port_tokenizer()
    whole = train_reader(cfg.replace(name="whole"), train, evals, tok, t5_config=t5,
                         device="cpu")
    first = train_reader(cfg.replace(name="first", epochs=1), train, evals, tok, t5_config=t5,
                         device="cpu")
    resumed = train_reader(cfg.replace(name="resumed", epochs=1), train, evals, tok,
                           t5_config=t5, resume_from=str(tmp_path / "first"),
                           reset_params=False, device="cpu")
    assert whole.final_step == resumed.final_step == 4 and first.final_step == 2
    assert [h["loss"] for h in whole.history] == [first.history[0]["loss"],
                                                  resumed.history[0]["loss"]]
    for k, p in whole.state.params.items():
        assert torch.equal(p, resumed.state.params[k]), k
    fw = flatten_tree(whole.state.opt_state)
    fr = flatten_tree(resumed.state.opt_state)
    assert all(torch.equal(v, fr[k]) if isinstance(v, torch.Tensor) else v == fr[k]
               for k, v in fw.items())


def test_adafactor_ignores_weight_decay_and_reads_jax_paths():
    """weight_decay is not applied (the JAX chain's note), and the factored
    axes are decided on the JAX paths of the port's model."""
    t5 = port_config.T5Config(vocab_size=160, d_model=128, d_kv=64, d_ff=256, num_layers=1,
                              num_decoder_layers=1, num_heads=2,
                              relative_attention_num_buckets=8, dropout_rate=0.0)
    model = init_fid_t5(t5, torch.Generator().manual_seed(0))
    paths = jax_param_paths(model)
    params = {paths[n]: p.detach().clone() for n, p in model.named_parameters()}
    state = optim.make_optimizer(port_config.OptimConfig(**OPTIM)).init(params)
    (fact,) = _factored_states(state)
    assert fact.v_row["t5/encoder/block_0/mlp/wi/kernel"].shape == (128,)     # JAX (128, 256)
    assert fact.v_col["t5/encoder/block_0/mlp/wi/kernel"].shape == (256,)
    assert fact.v["t5/encoder/relpos/rel_embedding"].shape == (8, 2)
    zero = {k: torch.zeros_like(p) for k, p in params.items()}
    for name in ("adamw", "adafactor"):   # lr(0) = lr: AdamW decays, Adafactor does not
        tx = optim.make_optimizer(port_config.OptimConfig(
            **dict(OPTIM, optim=name, warmup_steps=0, weight_decay=0.1)))
        upd, _ = tx.update(zero, tx.init(params), params)
        moved = [k for k, u in upd.items() if not torch.equal(u, torch.zeros_like(u))]
        assert (name == "adamw") == bool(moved), name
