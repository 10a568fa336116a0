"""The port's 8-bit AdamW against the JAX package's (CPU).

The update kernel's plain version (K5) against the interpreted Pallas kernel
and the requantization-free fragment (K6) against the script's ``k_ema``, both
with the quantized codes and scales exactly equal; ``scale_by_adam_8bit``
against the JAX transform on a multi-leaf tree (both paths), which pins the
leaf-salt order and the blocked layout of transposed dense weights; the state
size arithmetic. The optimizer chain, the train step and ``train_reader`` with
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
