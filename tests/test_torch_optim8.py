"""The port's 8-bit AdamW against the JAX package's (CPU).

The update kernel's plain version (K5) against the interpreted Pallas kernel
and the requantization-free fragment (K6) against the script's ``k_ema``, both
with the quantized codes and scales exactly equal; ``scale_by_adam_8bit``
against the JAX transform on a multi-leaf tree (both paths, and the card's
"auto" routing leaf by leaf), which pins the leaf-salt order and the blocked
layout of transposed dense weights; the flat state, K5's descriptor table and
its block-to-leaf map; the exact arithmetic K5's requantization relies on;
the state size arithmetic. The optimizer chain, the train step and ``train_reader`` with
``optim="adamw8bit"`` are in tests/test_torch_train.py.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from lako_tpu.ops.adam8_kernel import fused_adam8_update as jax_fused_adam8
from lako_tpu.train import optim8 as jax_optim8
from lako_tpu_torch.ops import adam8_kernel as k5
from lako_tpu_torch.train import optim8

REPO = Path(__file__).resolve().parents[1]
HYPER = dict(b1=0.9, b2=0.999, eps=1e-6, stochastic_round=True, seed=0x8B17)


def _state(nb, rng):
    return (rng.integers(-127, 128, (nb, 256)).astype(np.int8),
            (np.abs(rng.normal(size=(nb, 1))) * 1e-2).astype(np.float32),
            rng.integers(0, 256, (nb, 256)).astype(np.uint8),
            (np.abs(rng.normal(size=(nb, 1))) * 1e-4).astype(np.float32))


@pytest.mark.parametrize("correct_bias", [False, True])
@pytest.mark.parametrize("shape,transposed", [((768,), False), ((1000,), False),
                                              ((5 * 256 + 17,), False), ((48, 40), True),
                                              ((512, 6), True)])
def test_k5_plain_matches_jax_kernel(shape, transposed, correct_bias):
    """Five chained steps of one leaf (ragged tails and transposed dense
    weights included): the int8/uint8 codes and both scales exactly equal to
    the interpreted Pallas kernel's, u within rtol 2e-6 (exp and log of the
    bias correction may differ by ulps) and bitwise without the correction."""
    rng = np.random.default_rng(3)
    n = int(np.prod(shape))
    nb = -(-n // 256)
    jstate = tuple(map(jnp.asarray, _state(nb, rng)))
    state = tuple(torch.from_numpy(np.array(a)) for a in jstate)
    for count in range(1, 6):
        g = (rng.normal(size=shape) * 10.0 ** rng.integers(-4, 0)).astype(np.float32)
        jg = g.T if transposed else g   # the JAX package's (in, out) kernel
        jout = jax_fused_adam8(jax_optim8._blocked(jnp.asarray(jg), 256), *jstate, count,
                               correct_bias=correct_bias, leaf_salt=4, interpret=True, **HYPER)
        out = k5.fused_adam8_update(torch.from_numpy(g), *state, count,
                                    correct_bias=correct_bias, leaf_salt=4,
                                    transposed=transposed, **HYPER)
        ju = np.asarray(jout[0]).ravel()[:n].reshape(jg.shape)
        u = out[0].numpy()
        assert u.shape == shape
        np.testing.assert_allclose(u.T if transposed else u, ju, rtol=2e-6, atol=1e-30)
        if not correct_bias:
            np.testing.assert_array_equal(u.T if transposed else u, ju)
        for name, a, b in zip(("mq", "ms", "vq", "vs"), out[1:], jout[1:]):
            assert a.dtype == getattr(torch, str(np.asarray(b).dtype)), name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{name} step {count}")
        jstate, state = tuple(jout[1:]), tuple(out[1:])
    assert k5.fused_adam8_update.launches == 0   # the CPU path launches nothing


def _k_ema():
    """``k_ema`` rebuilt from the body in scripts/bench_adam8_micro.py main()."""
    tree = ast.parse((REPO / "scripts" / "bench_adam8_micro.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    fn = next(n for n in ast.walk(main) if isinstance(n, ast.FunctionDef) and n.name == "k_ema")
    namespace = {"jnp": jnp}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "bench_adam8_micro.py", "exec"),
         namespace)
    return namespace["k_ema"]


def test_k6_plain_matches_k_ema():
    """Plain K6 vs the script's fragment through pl.pallas_call in interpret
    mode, bf16 gradient at (24, 256): u bitwise equal."""
    rng = np.random.default_rng(5)
    nb = 24
    g = (rng.normal(size=(nb, 256)) * 1e-3).astype(np.float32)
    state = _state(nb, rng)
    jg = jnp.asarray(g, jnp.bfloat16)
    row = pl.BlockSpec((8, 256), lambda i: (i, 0))
    scl = pl.BlockSpec((8, 1), lambda i: (i, 0))
    want = pl.pallas_call(_k_ema(), grid=(nb // 8,), in_specs=[row, row, scl, row, scl],
                          out_specs=row, out_shape=jax.ShapeDtypeStruct((nb, 256), jnp.bfloat16),
                          interpret=True)(jg, *map(jnp.asarray, state))
    got = k5.adam8_ema_fragment(torch.from_numpy(np.asarray(jg.astype(jnp.float32))).bfloat16(),
                                *map(torch.from_numpy, state))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert k5.adam8_ema_fragment.launches == 0


def _tree(seed):
    """A nested tree whose flatten order differs from insertion order, with a
    ragged leaf and dense kernels that the port holds transposed."""
    rng = np.random.default_rng(seed)
    return {"zeta": {"kernel": rng.normal(size=(24, 40)).astype(np.float32)},
            "block_10": {"w": rng.normal(size=(300,)).astype(np.float32)},
            "block_2": {"q": {"kernel": rng.normal(size=(16, 32)).astype(np.float32)},
                        "ln": {"weight": rng.normal(size=(9,)).astype(np.float32)}},
            "alpha": rng.normal(size=(3, 256)).astype(np.float32)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _port_layout(path, a):
    return np.ascontiguousarray(a.T) if path.endswith("kernel") else a


@pytest.mark.parametrize("use_kernel", ["always", "never"])
@pytest.mark.parametrize("correct_bias", [False, True])
def test_scale_by_adam_8bit_matches_jax(use_kernel, correct_bias):
    """Four steps on a multi-leaf tree: every code and scale equal to the JAX
    transform's (the leaf salts follow tree_flatten's sorted order, dense
    kernels are blocked in JAX's layout), u within rtol 2e-6."""
    jtx = jax_optim8.scale_by_adam_8bit(correct_bias=correct_bias, use_kernel=use_kernel)
    tx = optim8.scale_by_adam_8bit(correct_bias=correct_bias, use_kernel=use_kernel)
    jparams = jax.tree_util.tree_map(jnp.asarray, _tree(0))
    params = {k: torch.from_numpy(_port_layout(k, v)) for k, v in _flat(_tree(0)).items()}
    jstate, state = jtx.init(jparams), tx.init(params)
    update = jax.jit(jtx.update)
    for step in range(4):
        grads = jax.tree_util.tree_map(lambda a: a * 1e-2, _tree(10 + step))
        ju, jstate = update(jax.tree_util.tree_map(jnp.asarray, grads), jstate)
        updates = {k: torch.from_numpy(_port_layout(k, v)) for k, v in _flat(grads).items()}
        u, state = tx.update(dict(reversed(updates.items())), state)
        for path, want in _flat(jax.tree_util.tree_map(np.asarray, ju)).items():
            np.testing.assert_allclose(u[path].numpy(), _port_layout(path, want), rtol=2e-6,
                                       atol=1e-30, err_msg=path)
        for moments, jmoments in ((state.mu, jstate.mu), (state.nu, jstate.nu)):
            leaves = jax.tree_util.tree_leaves_with_path(
                jmoments, is_leaf=lambda x: isinstance(x, jax_optim8.Moment8))
            assert len(leaves) == len(moments)
            for keys, (q, scale) in leaves:
                path = "/".join(k.key for k in keys)
                np.testing.assert_array_equal(moments[path].q.numpy(), np.asarray(q), err_msg=path)
                np.testing.assert_array_equal(moments[path].scale.numpy(), np.asarray(scale),
                                              err_msg=path)
    assert state.count == int(jstate.count) == 4
    assert list(u) == list(reversed(updates))           # the caller's key order
    assert optim8.leaf_order(params)[:2] == ["alpha", "block_10/w"]


def _routed_tree(seed):
    """Leaves of every kind the card's routing meets (JAX layout): aligned
    and at least 65,536 elements (a dense kernel and a table), a small leaf,
    a large size that is not a multiple of 256, a dense kernel whose out is
    not a multiple of 256, and a small aligned one."""
    rng = np.random.default_rng(seed)
    return {"enc": {"wi": {"kernel": rng.normal(size=(64, 1024)).astype(np.float32)},
                    "q": {"kernel": rng.normal(size=(16, 40)).astype(np.float32)},
                    "ln": {"weight": rng.normal(size=(9,)).astype(np.float32)}},
            "emb": rng.normal(size=(300, 256)).astype(np.float32),
            "odd": rng.normal(size=(70001,)).astype(np.float32),
            "small": rng.normal(size=(4, 256)).astype(np.float32)}


@pytest.mark.parametrize("correct_bias", [False, True])
def test_card_routing_matches_jax_leaf_by_leaf(monkeypatch, correct_bias):
    """The port's "auto" update as it runs on the card (one K5 call over all
    leaves, each leaf's rounding order flagged by the JAX package's rule;
    here the kernel's plain versions), four steps: each leaf held to the JAX
    transform under "always" where the JAX package's "auto" takes its Pallas
    kernel on its accelerator (size % 256 == 0 and >= 65536), else under
    "never". A leaf's result depends only on its own salt, so one run of each
    covers the tree. Codes and scales bitwise, u within rtol 2e-6 and bitwise
    without the bias correction."""
    monkeypatch.setattr(optim8, "_on_card", lambda updates: True)
    tx = optim8.scale_by_adam_8bit(correct_bias=correct_bias, use_kernel="auto")
    jtxs = {mode: jax_optim8.scale_by_adam_8bit(correct_bias=correct_bias, use_kernel=mode)
            for mode in ("always", "never")}
    jparams = jax.tree_util.tree_map(jnp.asarray, _routed_tree(0))
    params = {k: torch.from_numpy(_port_layout(k, v)) for k, v in _flat(_routed_tree(0)).items()}
    state = tx.init(params)
    jstates = {mode: jtx.init(jparams) for mode, jtx in jtxs.items()}
    updates_fn = {mode: jax.jit(jtx.update) for mode, jtx in jtxs.items()}
    rule = {p: v.size % 256 == 0 and v.size >= 65536 for p, v in _flat(_routed_tree(0)).items()}
    assert sorted(rule.values()) == [False] * 4 + [True] * 2
    before = k5.fused_adam8_update_leaves.launches
    for step in range(4):
        grads = jax.tree_util.tree_map(lambda a: a * 1e-2, _routed_tree(10 + step))
        ju = {}
        for mode in jtxs:
            out, jstates[mode] = updates_fn[mode](jax.tree_util.tree_map(jnp.asarray, grads),
                                                  jstates[mode])
            ju[mode] = _flat(jax.tree_util.tree_map(np.asarray, out))
        updates = {k: torch.from_numpy(_port_layout(k, v)) for k, v in _flat(grads).items()}
        u, state = tx.update(updates, state)
        jmoments = {}
        for mode, jstate in jstates.items():
            for name, tree in (("mu", jstate.mu), ("nu", jstate.nu)):
                for keys, m in jax.tree_util.tree_leaves_with_path(
                        tree, is_leaf=lambda x: isinstance(x, jax_optim8.Moment8)):
                    jmoments[mode, name, "/".join(k.key for k in keys)] = m
        for path in updates:
            mode = "always" if rule[path] else "never"
            want = _port_layout(path, ju[mode][path])
            np.testing.assert_allclose(u[path].numpy(), want, rtol=2e-6, atol=1e-30,
                                       err_msg=path)
            if not correct_bias:
                np.testing.assert_array_equal(u[path].numpy(), want, err_msg=path)
            for name, moments in (("mu", state.mu), ("nu", state.nu)):
                q, scale = jmoments[mode, name, path]
                np.testing.assert_array_equal(moments[path].q.numpy(), np.asarray(q),
                                              err_msg=f"{path} {name} step {step + 1}")
                np.testing.assert_array_equal(moments[path].scale.numpy(), np.asarray(scale),
                                              err_msg=f"{path} {name} step {step + 1}")
    assert k5.fused_adam8_update_leaves.launches == before   # the CPU path launches nothing


def test_flat_state_views_and_leaf_table():
    """The state of all leaves in four flat buffers, each leaf's Moment8 a
    view of its rows in leaf order, as the per-leaf state was (zeros, 255,
    scales 1); an update writes new buffers and leaves the old state as it
    was. K5's descriptor table: each leaf's state pointers and rows, salts,
    tier and rounding order; its block-to-leaf map (binary search, ragged
    last rows, an empty leaf, tiles with a partial column group) takes every
    state row of every leaf exactly once."""
    shapes = {"a/kernel": (512, 40), "b/kernel": (40, 16), "c": (5 * 256 + 17,),
              "d": (0,), "e": (300, 256), "f/kernel": (256, 8)}
    params = {k: torch.zeros(s) for k, s in shapes.items()}
    tx = optim8.scale_by_adam_8bit(use_kernel="always")
    state = tx.init(params)
    order = optim8.leaf_order(params)
    nbs = [-(-params[p].numel() // 256) for p in order]
    assert list(state.mu) == list(params) and len(state.nu) == len(params)
    row = 0
    for path, nb in zip(order, nbs):
        for name, fill in (("mu", 0), ("nu", 255)):
            moments = getattr(state, name)
            m = moments[path]
            assert m.q.shape == (nb, 256) and m.scale.shape == (nb, 1)
            assert m.q.untyped_storage().data_ptr() == moments.q.untyped_storage().data_ptr()
            assert m.q.storage_offset() == 256 * row and m.scale.storage_offset() == row
            assert bool((m.q == fill).all()) and bool((m.scale == 1).all())
        row += nb
    assert state.mu.q.shape == (sum(nbs), 256) and state.nu.scale.shape == (sum(nbs), 1)

    rng = np.random.default_rng(1)
    grads = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    old = [t.clone() for t in (state.mu.q, state.mu.scale, state.nu.q, state.nu.scale)]
    _, new = tx.update(grads, state)
    assert all(torch.equal(a, b) for a, b in zip(
        old, (state.mu.q, state.mu.scale, state.nu.q, state.nu.scale)))
    assert new.mu.q.data_ptr() != state.mu.q.data_ptr() and list(new.mu) == list(grads)

    gs = [grads[p] for p in order]
    layout = k5.LeafLayout(tuple(range(len(order))),
                           tuple(optim8.is_transposed(p, g) for p, g in zip(order, gs)),
                           tuple(not optim8.kernel_route(g) for g in gs), tuple(nbs))
    flat = (state.mu.q, state.mu.scale, state.nu.q, state.nu.scale)
    launch = k5.leaf_table(gs, flat, layout, 3, 0x8B17)
    table, n_blocks, us = launch.table, launch.n_blocks, launch.us()
    for g, u in zip(gs, us):
        assert u.shape == g.shape and u.dtype == g.dtype and u.data_ptr() % 16 == 0
        assert u.untyped_storage().data_ptr() == us[0].untyped_storage().data_ptr()
    f = {name: i for i, name in enumerate(k5.LEAF_FIELDS)}
    assert table.shape == (len(order), 16)
    tiers = {"a/kernel": k5.FLAG_TILE, "b/kernel": k5.FLAG_STRIDED, "c": 0, "d": 0, "e": 0,
             "f/kernel": k5.FLAG_TILE}
    for i, (path, nb) in enumerate(zip(order, nbs)):
        t = table[i]
        assert t[f["row0"]] == sum(nbs[:i]) and t[f["nb"]] == nb
        assert t[f["g"]] == gs[i].data_ptr()
        assert t[f["u"]] == us[i].data_ptr() or us[i].numel() == 0, path
        for name in ("mq", "ms", "vq", "vs"):
            moments = state.mu if name[0] == "m" else state.nu
            view = moments[path].q if name[1] == "q" else moments[path].scale
            assert t[f[name]] == view.data_ptr() or view.numel() == 0, (path, name)
        assert t[f["n"]] == gs[i].numel()
        assert (t[f["rows"]], t[f["cols"]]) == (shapes[path] if path.endswith("kernel") else (0, 0))
        assert t[f["salt_m"]] == optim8.salt_hash(3, 0x8B17 + 2 * i)
        assert t[f["salt_v"]] == optim8.salt_hash(3, 0x8B17 + 2 * i + 1)
        assert t[f["flags"]] & (k5.FLAG_TILE | k5.FLAG_STRIDED) == tiers[path]
        assert bool(t[f["flags"]] & k5.FLAG_JNP) == (path != "e")
    taken = {p: [] for p in order}
    for block in range(n_blocks):
        leaf, rows = k5.block_rows(table, block)
        assert rows, block
        taken[order[leaf]] += rows
    for path, nb in zip(order, nbs):
        assert sorted(taken[path]) == list(range(nb)), path
    per_leaf = [shapes[p][0] // 256 * -(-shapes[p][1] // 16) if tiers[p] == k5.FLAG_TILE
                else -(-nb // 16) for p, nb in zip(order, nbs)]
    assert n_blocks == sum(per_leaf)
    assert list(table[:, f["block0"]]) == [sum(per_leaf[:i]) for i in range(len(order))]


def test_k5_exact_arithmetic():
    """The exact steps K5's requantization takes in place of slower ones
    (csrc/adam8.cu): the division by the row's new scale as the rounded
    product with its reciprocal corrected once (lako::div_rn) equals the
    quotient; floor and round half to even as additions of 1.5 * 2^23 over
    |y| <= 2,300; a code byte as the low bits of q + 1.5 * 2^23; e - 127 as
    (2^23 + e) - (2^23 + 127)."""
    rng = np.random.default_rng(0)
    amax = (10.0 ** rng.uniform(-30, 2, 4000)).astype(np.float32)
    m = (rng.uniform(-1, 1, (4000, 256)) * amax[:, None]).astype(np.float32)
    m[:, 0] = amax
    m[:, 1] = -amax
    s = (amax * np.float32(1 / 127)).astype(np.float32)[:, None] * np.ones((1, 256), np.float32)
    r = np.float32(1) / s
    q = m * r
    fm = lambda a, b, c: optim8.fma32(torch.from_numpy(a), torch.from_numpy(b),  # noqa: E731
                                     torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(fm(fm(-q, s, m), r, q), m / s)

    big = np.float32(12582912.0)
    y = np.concatenate([rng.uniform(-2300, 2300, 10 ** 6), np.arange(-4600, 4601) / 2,
                        [-0.0, 0.0, 2.0 ** -30, -(2.0 ** -30)]]).astype(np.float32)
    near = (y + big) - big
    np.testing.assert_array_equal(near, np.rint(y))
    np.testing.assert_array_equal(np.where(near > y, near - np.float32(1), near), np.floor(y))
    codes = np.arange(-127, 255).astype(np.float32)
    low = ((codes + big).view(np.int32) & 0xFF).astype(np.uint8)
    np.testing.assert_array_equal(low, codes.astype(np.int64).astype(np.uint8))
    e = np.arange(256, dtype=np.int32)
    np.testing.assert_array_equal((0x4B000000 | e).view(np.float32) - np.float32(8388735.0),
                                  (e - 127).astype(np.float32))


def test_moment_state_bytes_and_init_match_jax():
    params = {"a": np.zeros((1000, 256), np.float32), "b": np.zeros((300,), np.float32)}
    got = optim8.moment_state_bytes({k: torch.from_numpy(v) for k, v in params.items()})
    assert got == jax_optim8.moment_state_bytes(params)
    state = optim8.scale_by_adam_8bit().init({k: torch.from_numpy(v) for k, v in params.items()})
    real = sum(t.numel() * t.element_size() for m in (*state.mu.values(), *state.nu.values())
               for t in m)
    assert real == got[0] and got[0] * 3.8 < got[1]
    assert bool((state.nu["b"].q == 255).all()) and not state.mu["b"].q.any()


def test_adam8_micro_loops_chain_their_calls():
    """The micro-benchmark's loops at a tiny shape (the wrappers' plain
    versions on the CPU): n chained calls, each fed the previous output, as
    the timing needs; the bf16 Adam update as the JAX script writes it."""
    from lako_tpu_torch.bench import adam8_micro

    g, mq, ms, vq, vs = adam8_micro.make_inputs((6, 256), torch.device("cpu"))
    loops = adam8_micro.make_loops(g, mq, ms, vq, vs)
    assert set(loops) == {"fused_kernel_ms", "fused_kernel_no_dither_ms",
                          "requant_free_fragment_ms", "bf16_adam_ms"}
    state = (mq, ms, vq, vs)
    for _ in range(2):
        _, *state = k5.fused_adam8_update(g, *state, adam8_micro.COUNT, stochastic_round=True,
                                          **adam8_micro.HYPER)
    assert torch.equal(loops["fused_kernel_ms"](2), state[0])
    assert not torch.equal(loops["fused_kernel_no_dither_ms"](2), state[0])
    u = k5.adam8_ema_fragment(k5.adam8_ema_fragment(g, mq, ms, vq, vs), mq, ms, vq, vs)
    assert torch.equal(loops["requant_free_fragment_ms"](2), u)
    gf = g.float()
    want = ((0.1 * gf) / (torch.sqrt(0.001 * gf * gf) + 1e-6)).bfloat16()
    assert torch.equal(loops["bf16_adam_ms"](1), want)


def test_adam8_micro_times_only_the_card(monkeypatch):
    """The micro-benchmark refuses the CPU, and without a card it raises
    instead of falling back."""
    from lako_tpu_torch.bench import adam8_micro

    with pytest.raises(ValueError, match="times the CUDA card"):
        adam8_micro.run(torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        adam8_micro.run()


def test_fma32_rounds_once():
    """fma32 against exact rational arithmetic, ties between two float32
    values included."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a = rng.normal(size=2000).astype(np.float32)
    b = rng.normal(size=2000).astype(np.float32)
    c = rng.normal(size=2000).astype(np.float32)
    # cancellation: c = -round(a*b)
    c[:500] = (-(a[:500].astype(np.float64) * b[:500])).astype(np.float32)
    # (1 + 2**-12)**2 = 1 + 2**-11 + 2**-24 lies halfway between two float32
    # values: a tie, settled by a c far below float64's resolution
    a[500:503] = b[500:503] = np.float32(1 + 2 ** -12)
    c[500:503] = np.float32([0.0, 2.0 ** -60, -(2.0 ** -60)])
    got = optim8.fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for x, y, z, r in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        # the correctly rounded float32: compare distances exactly
        cand = [lo, np.nextafter(lo, np.float32(np.inf)), np.nextafter(lo, np.float32(-np.inf))]
        best = min(cand, key=lambda f: (abs(Fraction(float(f)) - exact),
                                        int(np.float32(f).view(np.int32)) & 1))
        assert r == best, (x, y, z, r, best)
    assert list(got[500:503]) == [np.float32(1 + 2 ** -11), np.float32(1 + 2 ** -11 + 2 ** -23),
                                  np.float32(1 + 2 ** -11)]
