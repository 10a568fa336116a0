"""The port's Adafactor against ``optax.adafactor`` as the JAX package
builds it (lako_tpu/train/optim.py), on the CPU.

Three updates (six calls under 2-step accumulation) of the same seeded
gradients through both chains, on a leaf set with square, wide, tall,
1-D and under-128 leaves (dense kernels stored transposed in the port, so
the factored axes must follow the JAX leaf) and on a t5 param tree wide
enough to factor: the factored statistics within rtol 1e-6 of optax's and
the parameters within rtol 1e-5 (summation orders differ between XLA and
torch). The same holds for the route float32 trees on the card take, the
fused update K7 (ops/adafactor_kernel.py), through its plain version (the
card's route taken on CPU tensors by patching ``optim._on_card``). K7's
plan follows ``_factored_dims`` on every leaf of a t5-3b-shaped tree, built
from shapes alone; the fused route writes into the caller's buffers, a
mixed tree raises, and bf16 masters keep the chain. The fused route's
state is the chain's, node for node, and its update is its host half
``load`` and device half ``apply`` in turn, bitwise. The state round-trips
bitwise through ``opt_state.pt``, and a full resume through
``train_reader`` continues as the uninterrupted run does, bitwise.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lako_tpu.core import config as jax_config
from lako_tpu.models.t5.model import FiDT5 as JaxFiDT5
from lako_tpu.train import optim as jax_optim
from lako_tpu_torch.core import config as port_config
from lako_tpu_torch.core import profiling
from lako_tpu_torch.core.checkpoint import flatten_tree, load_checkpoint, save_checkpoint
from lako_tpu_torch.models.t5 import FiDT5, init_fid_t5, jax_param_paths
from lako_tpu_torch.ops import _build
from lako_tpu_torch.ops import adafactor_kernel as k7
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
    returns (jax params, jax FactoredState, port params, port FactoredState).
    The port's updates are applied to its parameters from the dict the
    update returns."""
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


def _card_route(monkeypatch):
    """Send CPU trees down the route of float32 trees on the card: the fused
    update's wrapper, which takes its plain version on CPU tensors."""
    monkeypatch.setattr(optim, "_on_card", lambda t: True)


def _fused_count(start):
    return sum(n for t, name, n in profiling.snapshot()["counts"]
               if name == "train.adafactor_fused" and t >= start)


CASES = [(tree, accumulation, route) for route in ("chain", "fused")
         for tree, accumulation in (("leaves", 1), ("leaves", 2), ("t5", 1), ("t5", 2))]


@pytest.mark.parametrize("tree,accumulation,route", [
    pytest.param(*case, id=f"{case[0]}-{case[1]}" + ("-fused" if case[2] == "fused" else ""))
    for case in CASES])
def test_adafactor_matches_optax(tree, accumulation, route, monkeypatch):
    """The chain (the CPU's route) and the fused update through its plain
    version (the route of float32 leaves on the card) against optax."""
    if route == "fused":
        _card_route(monkeypatch)
    jax_params = _leaf_params() if tree == "leaves" else _t5_params()
    start = profiling.now()
    jparams, jfact, params, fact = _run_both(jax_params, accumulation)
    assert _fused_count(start) == (3 if route == "fused" else 0)
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


def _t5_3b_shapes():
    """{JAX path: the port's shape} of every t5-3b parameter, from a model on
    the meta device: shapes only, no weights."""
    with torch.device("meta"):
        model = FiDT5(port_config.t5_config_for_size("3b"))
    paths = jax_param_paths(model)
    return {paths[name]: tuple(p.shape) for name, p in model.named_parameters()}


def test_fused_plan_follows_factored_dims_on_t5_3b():
    """K7's plan of t5-3b's 509 leaves: each leaf factored where
    ``_factored_dims`` of its JAX shape says so, v_row's mean over the port
    axis that the JAX leaf's largest axis (``d0``) is, the statistics shaped
    as ``scale_by_factored_rms`` makes them, tiles and scratch laid out
    without overlap, the scratch under 1% of the parameters and gradients."""
    shapes = _t5_3b_shapes()
    assert len(shapes) == 509
    paths = tuple(shapes)
    pl = k7.plan(paths, tuple(shapes.values()))
    f = {name: i for i, name in enumerate(k7.LEAF_FIELDS)}
    with torch.device("meta"):
        fact = optim.scale_by_factored_rms().init({k: torch.empty(s) for k, s in shapes.items()})
    n_factored, tile, fin = 0, 0, 0
    for i, path in enumerate(paths):
        shape, row = shapes[path], pl.table[i]
        transposed = path.endswith("/kernel") and len(shape) == 2
        jax_shape = shape[::-1] if transposed else shape
        dims = optim._factored_dims(jax_shape, 128)
        flags = int(row[f["flags"]])
        assert bool(flags & k7.FLAG_FACTORED) == (dims is not None), path
        assert pl.state_shapes[i] == (tuple(fact.v_row[path].shape),
                                     tuple(fact.v_col[path].shape),
                                     tuple(fact.v[path].shape)), path
        assert row[f["tile0"]] == pl.first[0, i] == tile and row[f["fin0"]] == pl.first[1, i]
        assert row[f["fin0"]] == fin
        tiles = -(-int(row[f["rows"]]) // 256) * int(row[f["tiles_c"]])
        tile += tiles
        if dims is None:
            assert (row[f["rows"]], row[f["cols"]]) == (-(-math.prod(shape) // 256), 256)
            continue
        n_factored += 1
        d1, d0 = dims
        port_d0 = 1 - d0 if transposed else d0
        assert bool(flags & k7.FLAG_ROW_STAT) == (port_d0 == 1), path
        assert (row[f["rows"]], row[f["cols"]]) == shape
        # v_row runs along the port axis that JAX's d1 is; its mean over d0
        assert fact.v_row[path].shape[0] == shape[1 - port_d0] == jax_shape[d1], path
        assert row[f["rpart"]] < row[f["cpart"]] < row[f["frow"]] < row[f["fcol"]]
        fin += 1 + -(-shape[port_d0] // k7.FIN_CHUNK)
    assert (pl.n_tiles, pl.n_fin) == (tile, fin)
    assert n_factored == 1 + 24 * 6 + 24 * 10      # embedding, encoder, decoder blocks
    offsets = pl.table[:, [f["rpart"], f["cpart"], f["frow"], f["fcol"]]]
    ends = np.concatenate([offsets[:, 1:], np.roll(offsets[:, :1], -1, axis=0)], axis=1)
    factored = (pl.table[:, f["flags"]] & k7.FLAG_FACTORED) != 0
    ends[np.flatnonzero(factored)[-1], 3] = pl.scratch
    assert (offsets[factored] <= ends[factored]).all()
    elements = sum(math.prod(s) for s in shapes.values())
    assert pl.scratch * 4 < 0.01 * 8 * elements


def test_fused_route_updates_in_the_callers_buffers(monkeypatch):
    """The fused route returns the gradients' own buffers holding the
    updates and updates the statistics' tensors in place; a gradient that
    is not contiguous, or shares another's buffer, is copied first, with the
    same result as the chain's."""
    _card_route(monkeypatch)
    params = {k: _port(k, v) for k, v in _flat(_leaf_params()).items()}
    tx = optim.clipped_adafactor(1.0, 1e-2)
    chain = optim.chain(optim.clip_by_global_norm(1.0), optim.adafactor(1e-2))
    state, chain_state = tx.init(params), chain.init(params)
    g = torch.Generator().manual_seed(3)
    grads = {k: torch.randn(p.shape, generator=g) for k, p in params.items()}
    grads["sq/kernel"] = torch.randn(256, 256, generator=g).t()          # not contiguous
    want, want_state = chain.update({k: v.clone() for k, v in grads.items()}, chain_state, params)
    (fact0,) = _factored_states(state)
    v_rows = dict(fact0.v_row)
    upd, state = tx.update(grads, state, params)
    (fact,) = _factored_states(state)
    (want_fact,) = _factored_states(want_state)
    for k, u in upd.items():
        assert (u is grads[k]) == (k != "sq/kernel"), k
        assert fact.v_row[k] is v_rows[k], k
        # the global norm's sum runs in another order than the chain's
        torch.testing.assert_close(u, want[k], rtol=PARAM_RTOL, atol=1e-9)
        torch.testing.assert_close(fact.v_col[k], want_fact.v_col[k], rtol=STATE_RTOL, atol=0)
    # two leaves handed one buffer: the second is copied, both get the update
    shared = torch.randn(300, generator=g)
    tree = {"a/weight": torch.zeros(300), "b/weight": torch.ones(300)}
    tx2 = optim.clipped_adafactor(1.0, 1e-2)
    upd, _ = tx2.update({"a/weight": shared, "b/weight": shared}, tx2.init(tree), tree)
    assert upd["a/weight"] is shared and upd["b/weight"] is not shared


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("clip", [1.0, 1e4], ids=["clip-fires", "clip-idle"])
def test_host_and_device_halves_are_the_update(clip, steps, monkeypatch):
    """The fused route's update as a CUDA graph runs it: the host half
    ``load`` (the step's values, the next state) and then the device half
    ``apply``, handed the first step's state every step as a graph captured
    it. Updates, statistics, counts and parameters bitwise those of
    ``update``, under a learning rate that moves every step, the clip
    firing or not, and ``train.adafactor_fused`` counted once an update."""
    _card_route(monkeypatch)
    params = {k: _port(k, v) for k, v in _flat(_leaf_params()).items()}
    g = torch.Generator().manual_seed(6)
    grads = [{k: torch.randn(p.shape, generator=g) for k, p in params.items()}
             for _ in range(steps)]
    norms = [math.sqrt(sum(float((x * x).sum()) for x in gr.values())) for gr in grads]
    assert all((norm >= clip) == (clip == 1.0) for norm in norms)
    runs = []
    for split in (True, False):
        tx = optim.clipped_adafactor(clip, optim.warmup_linear_schedule(1e-2, 0, 10))
        mine = {k: p.clone() for k, p in params.items()}
        state = first = tx.init(mine)
        start, updates = profiling.now(), []
        for gr in grads:
            gr = {k: v.clone() for k, v in gr.items()}
            if split:
                state = tx.load(state, mine)
                upd = tx.apply(gr, first, mine)
            else:
                upd, state = tx.update(gr, state, mine)
            updates.append({k: u.clone() for k, u in upd.items()})
            optim.apply_updates(mine, upd)
        assert _fused_count(start) == steps
        runs.append((updates, flatten_tree(state), mine))
    (got_u, got_s, got_p), (want_u, want_s, want_p) = runs
    assert [u.keys() for u in got_u] == [u.keys() for u in want_u]
    assert all(torch.equal(a[k], b[k]) for a, b in zip(got_u, want_u) for k in a)
    assert got_s.keys() == want_s.keys()
    assert all(torch.equal(v, want_s[k]) if isinstance(v, torch.Tensor) else v == want_s[k]
               for k, v in got_s.items())
    assert all(torch.equal(got_p[k], want_p[k]) for k in want_p)
    assert max(float(u.abs().max()) for u in got_u[-1].values()) > 0


def _node_types(tree):
    """The type of every tuple node of a state, depth first."""
    if isinstance(tree, tuple):
        return [type(tree)] + [t for child in tree for t in _node_types(child)]
    return []


def test_fused_route_keeps_the_chains_state(monkeypatch):
    """After two updates the fused route's state is the chain's: the same
    node types (the outer chain's tuple, adafactor's AdafactorState of
    named stages, the FactoredState), the same checkpoint keys, the same
    counts, statistics within STATE_RTOL."""
    params = {k: _port(k, v) for k, v in _flat(_leaf_params()).items()}
    g = torch.Generator().manual_seed(4)
    grads = [{k: torch.randn(p.shape, generator=g) for k, p in params.items()}
             for _ in range(2)]
    states = {}
    for route in ("chain", "fused"):
        if route == "fused":
            _card_route(monkeypatch)
        tx = optim.clipped_adafactor(1.0, 1e-2)
        mine = {k: p.clone() for k, p in params.items()}
        state = tx.init(mine)
        for gr in grads:
            upd, state = tx.update({k: v.clone() for k, v in gr.items()}, state, mine)
            optim.apply_updates(mine, upd)
        states[route] = state
    chain, fused = states["chain"], states["fused"]
    assert _node_types(fused) == _node_types(chain)
    assert isinstance(fused[1], optim.AdafactorState)
    assert fused[1].factored_rms.count == fused[1].learning_rate == 2
    fc, ff = flatten_tree(chain), flatten_tree(fused)
    assert ff.keys() == fc.keys()
    for k, v in ff.items():
        if isinstance(v, torch.Tensor):
            torch.testing.assert_close(v, fc[k], rtol=STATE_RTOL, atol=0, msg=k)
        else:
            assert v == fc[k], k


def test_mixed_tree_raises(monkeypatch):
    """A tree of float32 and bfloat16 leaves raises, on either route."""
    params = {"a/weight": torch.zeros(300), "b/weight": torch.zeros(300, dtype=torch.bfloat16)}
    grads = {k: torch.ones_like(p) for k, p in params.items()}
    for patch in (False, True):
        if patch:
            _card_route(monkeypatch)
        tx = optim.make_optimizer(port_config.OptimConfig(**OPTIM))
        with pytest.raises(ValueError, match="one device in one dtype"):
            tx.update(grads, tx.init(params), params)
    with pytest.raises(ValueError, match="float32"):
        k7.leaf_table(k7.plan(("a/weight",), ((300,),)), [torch.zeros(300, dtype=torch.bfloat16)],
                      [torch.zeros(300)], [torch.zeros(1)], [torch.zeros(1)], [torch.zeros(300)])


def test_bf16_masters_keep_the_chain(monkeypatch):
    """bfloat16 masters on the card's route take the chain, bitwise, have no
    host half for a graph (``load`` gives None) and count no fused
    update."""
    _card_route(monkeypatch)
    params = {k: _port(k, v).to(torch.bfloat16) for k, v in _flat(_leaf_params()).items()}
    tx = optim.clipped_adafactor(1.0, 1e-2)
    chain = optim.chain(optim.clip_by_global_norm(1.0), optim.adafactor(1e-2))
    state, chain_state = tx.init(params), chain.init(params)
    g = torch.Generator().manual_seed(5)
    start = profiling.now()
    assert tx.load(state, params) is None
    for _ in range(2):
        grads = {k: torch.randn(p.shape, generator=g).to(torch.bfloat16) for k, p in params.items()}
        upd, state = tx.update(grads, state, params)
        want, chain_state = chain.update(grads, chain_state, params)
        assert all(torch.equal(upd[k], want[k]) and upd[k].dtype == torch.bfloat16 for k in upd)
    assert flatten_tree(state).keys() == flatten_tree(chain_state).keys()
    assert all(torch.equal(v, flatten_tree(chain_state)[k]) if isinstance(v, torch.Tensor)
               else v == flatten_tree(chain_state)[k] for k, v in flatten_tree(state).items())
    assert _fused_count(start) == 0


def test_k7_builds_as_its_own_library(monkeypatch, tmp_path):
    """K7 is built into a library of its own, from adafactor.cu and
    common.cu, so a training run with Adafactor compiles nothing else;
    every other .cu goes into the kernels' library, each file into one."""
    cu = lambda lib: [s.name for s in _build._sources(lib) if s.suffix == ".cu"]
    assert cu("adafactor") == ["common.cu", "adafactor.cu"]
    named = {name for files in _build.LIBRARIES.values() if files for name in files}
    others = sorted(s.name for s in _build.CSRC_DIR.glob("*.cu")
                    if s.name != "common.cu" and s.name not in named)
    assert others and cu("kernels") == ["common.cu", *others]
    assert _build.library_path("adafactor").name.startswith("liblako_adafactor-")
    assert _build.library_path("kernels").name.startswith("liblako_kernels-")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found") as err:
        _build.compile_library(tmp_path / "k7.so", "adafactor")
    commands = str(err.value)
    assert "adafactor.cu" in commands and not any(name in commands for name in others)
