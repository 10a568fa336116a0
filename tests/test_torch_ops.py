"""The port's kernel modules vs the JAX package's Pallas kernels.

On this CPU the port's wrappers run their plain PyTorch versions; the JAX side
runs its Pallas kernels in interpret mode and its XLA references. Inputs are
made with numpy from a seed and handed to both. The CUDA kernels themselves
are tested against the plain versions in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lako_tpu.ops.decode_cross_attn import (
    fused_decode_cross_attention as jax_fused_cross,
    xla_reference as jax_cross_reference,
)
from lako_tpu.ops.flash_attention import _xla_attention, fused_attention as jax_fused
from lako_tpu.ops.flash_streamed import (
    _streamed_fwd_impl,
    _xla_reference,
    streamed_attention as jax_streamed,
)
from lako_tpu_torch.ops import _build
from lako_tpu_torch.ops import decode_cross_attn as k3
from lako_tpu_torch.ops import flash_attention as k4
from lako_tpu_torch.ops import flash_streamed as k1


def _attn_inputs(B, H, L, Lk, D, seed=0, padding_row=True):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, L, D)).astype(np.float32)
    k = rng.normal(size=(B, H, Lk, D)).astype(np.float32)
    v = rng.normal(size=(B, H, Lk, D)).astype(np.float32)
    rel = rng.normal(size=(H, L, Lk)).astype(np.float32)
    mask = rng.random((B, Lk)) < 0.8
    mask[:, 0] = True
    if padding_row:
        mask[1] = False      # a padding row: every key masked
    return q, k, v, rel, mask


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("L,Lk", [(37, 37), (130, 130), (300, 330)])
def test_streamed_plain_matches_jax(L, Lk):
    """Plain K1 vs the XLA reference on every row, and vs the interpreted
    Pallas kernel on rows with a real key; atol/rtol 2e-4 (f32)."""
    q, k, v, rel, mask = _attn_inputs(3, 2, L, Lk, 16)
    out = k1.streamed_attention(*_torch(q, k, v, rel, mask)).numpy()
    ref = np.asarray(_xla_reference(*map(jnp.asarray, (q, k, v, rel, mask))))
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
    # a fully masked row is the uniform average of V over the real keys
    np.testing.assert_allclose(out[1], np.broadcast_to(v[1].mean(axis=1, keepdims=True),
                                                       out[1].shape),
                               rtol=2e-4, atol=2e-4)
    kern = np.asarray(jax_streamed(*map(jnp.asarray, (q, k, v, rel, mask)),
                                   128, 128, True))
    # The Pallas kernel pads keys to 128 lanes with additive -1e9, so on a
    # fully masked row its padding keys tie with the real ones and share the
    # weight; rows with a real key are unaffected by the padding.
    live = mask.any(axis=1)
    np.testing.assert_allclose(out[live], kern[live], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("L", [1, 16, 17])
@pytest.mark.parametrize("Lk", [7, 65])
def test_streamed_plain_stats_match_jax_kernel(L, Lk):
    """Plain K1 with its statistics, the reference the CUDA kernel is held to,
    against the interpreted Pallas kernel at the CUDA kernel's edges (one
    row, one and a bit of its 16-row warp tiles; keys short of an 8-key tile
    and one past a 64-key tile): out, and m + log(l) against the kernel's
    lse, on rows with a real key, atol/rtol 2e-4 (f32); a fully masked row
    has (m, l) = (-1e9, Lk) exactly."""
    q, k, v, rel, mask = _attn_inputs(2, 2, L, Lk, 8)
    out, stats = k1.streamed_attention_fwd_reference(*_torch(q, k, v, rel, mask))
    kern, lse = _streamed_fwd_impl(*map(jnp.asarray, (q, k, v, rel, mask)), 128, 128, True,
                                   with_stats=True)
    live = mask.any(axis=1)
    np.testing.assert_allclose(out.numpy()[live], np.asarray(kern)[live], rtol=2e-4, atol=2e-4)
    m, l = stats[..., 0].numpy(), stats[..., 1].numpy()
    np.testing.assert_allclose((m + np.log(l))[live], np.asarray(lse)[live, :, :L, 0],
                               rtol=2e-4, atol=2e-4)
    assert (m[~live] == -1e9).all() and (l[~live] == Lk).all()


@pytest.mark.parametrize("L", [1, 16, 17])
@pytest.mark.parametrize("Lk", [7, 65])
def test_streamed_plain_dkdv_matches_jax_kernel(L, Lk):
    """Plain K2a on the plain forward's statistics against dK and dV of
    jax.vjp through the interpreted Pallas kernel at the same edges, atol/rtol
    2e-4 (f32); no fully masked row (the JAX kernel's lse is wrong there)."""
    q, k, v, rel, mask = _attn_inputs(2, 2, L, Lk, 8, padding_row=False)
    g = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)
    tq, tk, tv, trel, tmask, tg = _torch(q, k, v, rel, mask, g)
    out, stats = k1.streamed_attention_fwd_reference(tq, tk, tv, trel, tmask)
    dk, dv = k1.streamed_attention_bwd_dkdv(tq, tk, tv, trel, tmask, stats,
                                            (tg * out).sum(-1), tg)
    _, vjp = jax.vjp(lambda *a: jax_streamed(*a, jnp.asarray(mask), 128, 128, True),
                     *map(jnp.asarray, (q, k, v, rel)))
    _, jdk, jdv, _ = vjp(jnp.asarray(g))
    np.testing.assert_allclose(dk.numpy(), np.asarray(jdk), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), rtol=2e-4, atol=2e-4)


def _port_grads(q, k, v, rel, mask, g, fn=None):
    """Gradients of sum(out * g) in q, k, v, rel through ``fn``."""
    fn = fn or k1.streamed_attention
    q, k, v, rel = (t.clone().requires_grad_() for t in _torch(q, k, v, rel))
    out = fn(q, k, v, rel, torch.from_numpy(mask))
    return [t.numpy() for t in torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                                   (q, k, v, rel))]


def _jax_grads(fn, q, k, v, rel, mask, g):
    return [np.asarray(t) for t in jax.grad(
        lambda *a: jnp.sum(fn(*a, jnp.asarray(mask)) * g), argnums=(0, 1, 2, 3))(
            *map(jnp.asarray, (q, k, v, rel)))]


def _assert_grads_close(got, want):
    for name, a, b in zip(["q", "k", "v", "rel"], got, want):
        if name == "rel":
            # drel sums dS over the batch: bounded by its own scale, as the
            # JAX package's test bounds it (tests/test_flash_streamed.py)
            assert np.abs(a - b).max() <= 3e-3 * np.abs(b).max(), name
        else:
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("B,H,L,Lk,D", [(3, 2, 300, 330, 16), (2, 2, 37, 45, 8),
                                         (5, 2, 130, 130, 8)])
def test_streamed_gradients_match_jax_kernel(B, H, L, Lk, D):
    """The backward (plain K2a/K2b/K2c on the CPU) against jax.grad of the
    interpreted Pallas kernel, on inputs without a fully masked row (the JAX
    kernel's logsumexp is wrong there; see the next test); an odd batch at
    the encoder's L = Lk = 130, the batch K2c sums drel over."""
    q, k, v, rel, mask = _attn_inputs(B, H, L, Lk, D, padding_row=False)
    g = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    kern = lambda *a: jax_streamed(*a, 128, 128, True)  # noqa: E731
    _assert_grads_close(_port_grads(q, k, v, rel, mask, g), _jax_grads(kern, q, k, v, rel, mask, g))


def test_streamed_gradients_on_padding_row():
    """With a fully masked row, against the gradients of the JAX XLA
    reference: that row adds nothing to dQ, dK or drel, and dO/Lk per key to
    dV."""
    q, k, v, rel, mask = _attn_inputs(3, 2, 40, 44, 8)
    g = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    got = _port_grads(q, k, v, rel, mask, g)
    _assert_grads_close(got, _jax_grads(_xla_reference, q, k, v, rel, mask, g))
    dq, dk, dv, _ = got
    assert not dq[1].any() and not dk[1].any()
    np.testing.assert_allclose(dv[1], np.broadcast_to(g[1].sum(axis=1, keepdims=True) / 44,
                                                      dv[1].shape), rtol=1e-5, atol=1e-6)
    # the batch without row 1 gives the same drel: that row's dS is 0
    keep = [0, 2]
    drel = _port_grads(q[keep], k[keep], v[keep], rel, mask[keep], g[keep])[3]
    np.testing.assert_allclose(got[3], drel, rtol=1e-5, atol=1e-6)


def test_bwd_reference_matches_autograd_of_plain_forward():
    """streamed_attention_bwd_reference (the kernels' plain version, from the
    row statistics) equals autograd of streamed_attention_reference, padding
    row included, at 1e-5; the statistics of that row are exactly
    (-1e9, Lk)."""
    q, k, v, rel, mask = _attn_inputs(2, 3, 33, 29, 8)
    g = np.random.default_rng(3).normal(size=q.shape).astype(np.float32)
    want = _port_grads(q, k, v, rel, mask, g, fn=k1.streamed_attention_reference)
    tq, tk, tv, trel, tmask, tg = _torch(q, k, v, rel, mask, g)
    out, stats = k1.streamed_attention_fwd_reference(tq, tk, tv, trel, tmask)
    torch.testing.assert_close(out, k1.streamed_attention_reference(tq, tk, tv, trel, tmask),
                               rtol=1e-6, atol=1e-6)
    assert stats[1, :, :, 0].eq(-1e9).all() and stats[1, :, :, 1].eq(29).all()
    got = k1.streamed_attention_bwd_reference(tq, tk, tv, trel, tmask, out, stats, tg)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)
    # the per-kernel wrappers give the same pieces on the CPU
    dvec = (tg * out).sum(-1)
    args = (tq, tk, tv, trel, tmask, stats, dvec, tg)
    dk, dv = k1.streamed_attention_bwd_dkdv(*args)
    for a, b in zip((k1.streamed_attention_bwd_dq(*args), dk, dv,
                     k1.streamed_attention_bwd_drel(*args)), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_streamed_wrapper_refuses_bad_inputs():
    q, k, v, rel, mask = _torch(*_attn_inputs(2, 2, 8, 8, 4))
    # inputs that require grad take the autograd Function, and its backward runs
    out = k1.streamed_attention(q.requires_grad_(), k, v, rel, mask)
    (dq,) = torch.autograd.grad(out.sum(), q)
    assert dq.shape == q.shape and bool(torch.isfinite(dq).all())
    q = q.detach()
    with pytest.raises(ValueError, match="rel_bias"):
        k1.streamed_attention(q, k, v, rel.double(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        k1.streamed_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, rel, mask)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        k1.streamed_attention(*(t.to("meta") for t in (q, k, v, rel, mask)))
    with pytest.raises(ValueError, match="stats"):
        k1.streamed_attention_bwd_dq(q, k, v, rel, mask, torch.zeros(2, 2, 8), (q * q).sum(-1), q)
    launches = (k1.streamed_attention, k1.streamed_attention_bwd_dkdv,
                k1.streamed_attention_bwd_dq, k1.streamed_attention_bwd_drel)
    assert all(f.launches == 0 for f in launches)   # the CPU path launches nothing


def _cross_inputs(B=2, h=4, d=16, K=37, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, h, d)).astype(np.float32)

    def quant(x):
        scale = np.maximum(np.abs(x).max(axis=-1, keepdims=True), 1e-8) / 127.0
        return (np.clip(np.round(x / scale), -127, 127).astype(np.int8),
                scale.astype(np.float32))

    k_i8, k_s = quant(rng.normal(size=(B, h, d, K)).astype(np.float32))
    v_i8, v_s = quant(rng.normal(size=(B, h, d, K)).astype(np.float32))
    mask = rng.random((B, K)) < 0.85
    mask[:, 0] = True
    bias = np.where(mask, 0.0, -1e9).astype(np.float32)[:, None, :]
    return q, k_i8, k_s, v_i8, v_s, bias


@pytest.mark.parametrize("K", [37, 128, 260])
def test_decode_cross_plain_matches_jax(K):
    """Plain K3 vs the interpreted Pallas kernel and the XLA reference, 1e-5."""
    arrays = _cross_inputs(K=K)
    out = k3.fused_decode_cross_attention(*_torch(*arrays)).numpy()
    jarrays = [jnp.asarray(a) for a in arrays]
    kern = np.asarray(jax_fused_cross(*jarrays, interpret=True))
    ref = np.asarray(jax_cross_reference(*jarrays))
    np.testing.assert_allclose(out, kern, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_decode_cross_scale_layouts_and_guards():
    """(B,h,d) and (B,h,d,1) scales give the same result; bad inputs raise."""
    q, k_i8, k_s, v_i8, v_s, bias = _torch(*_cross_inputs())
    a = k3.fused_decode_cross_attention(q, k_i8, k_s, v_i8, v_s, bias)
    b = k3.fused_decode_cross_attention(q, k_i8, k_s[..., 0], v_i8, v_s[..., 0], bias)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="int8"):
        k3.fused_decode_cross_attention(q, k_i8.float(), k_s, v_i8, v_s, bias)
    with pytest.raises(ValueError, match="bias"):
        k3.fused_decode_cross_attention(q, k_i8, k_s, v_i8, v_s, bias[:, 0])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        k3.fused_decode_cross_attention(*(t.to("meta") for t in (q, k_i8, k_s, v_i8, v_s, bias)))


def _dense_inputs(B, H, L, Lk, D, bias_shape, seed=0, padding_row=False):
    """q, k, v and a dense additive bias of ``bias_shape`` (None: no bias)
    holding a relative-position-like term and the key mask (-1e9)."""
    q, k, v, rel, mask = _attn_inputs(B, H, L, Lk, D, seed=seed, padding_row=padding_row)
    if bias_shape is None:
        return q, k, v, None
    full = rel[None] + np.where(mask[:, None, None, :], 0.0, -1e9).astype(np.float32)
    bias = full[tuple(slice(0, n) for n in bias_shape)]   # the broadcast axes keep row 0
    return q, k, v, np.ascontiguousarray(bias, dtype=np.float32)


def _maybe(a):
    return None if a is None else torch.from_numpy(a)


def _jmaybe(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("B,H,L,Lk,D,bias_shape", [
    (3, 2, 37, 45, 16, (3, 2, 37, 45)),
    (2, 4, 130, 130, 64, (2, 4, 130, 130)),
    (2, 3, 20, 20, 8, (1, 3, 20, 20)),
    (3, 2, 24, 31, 8, (3, 1, 24, 31)),
    (2, 2, 16, 16, 8, None),
    (2, 2, 20, 257, 8, (2, 2, 20, 257)),
    (2, 2, 12, 7, 8, (2, 1, 12, 7)),
])
def test_fused_attention_plain_matches_jax_kernel(B, H, L, Lk, D, bias_shape):
    """Plain K4 vs the interpreted Pallas kernel, full and broadcast biases
    and none, no fully masked row: within 1e-5. Lk = 257 lies past the key
    count up to which the CUDA kernel keeps the logits in registers (160),
    Lk = 7 below its 16-key padding."""
    q, k, v, bias = _dense_inputs(B, H, L, Lk, D, bias_shape)
    out = k4.fused_attention(*_torch(q, k, v), _maybe(bias)).numpy()
    want = np.asarray(jax_fused(*map(jnp.asarray, (q, k, v)), _jmaybe(bias), True))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


def test_fused_attention_padding_row_follows_xla():
    """A fully masked row averages V over the real keys, as _xla_attention
    does (the Pallas kernel's 128-lane key padding shares that row's
    weight, so it is held to the XLA function here)."""
    q, k, v, bias = _dense_inputs(3, 2, 30, 30, 8, (3, 2, 30, 30), padding_row=True)
    out = k4.fused_attention(*_torch(q, k, v, bias)).numpy()
    want = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v, bias))))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[1], np.broadcast_to(v[1].mean(axis=1, keepdims=True),
                                                       out[1].shape), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bias_shape", [(2, 3, 20, 26), (1, 3, 20, 26), (2, 1, 20, 26)])
def test_fused_attention_gradients_match_jax(bias_shape):
    """dq, dk, dv vs jax.grad through the interpreted Pallas kernel (its XLA
    backward); dbias, which the JAX custom_vjp drops, vs jax.grad of
    _xla_attention, summed to the bias's own (broadcast) shape. 1e-5."""
    q, k, v, bias = _dense_inputs(2, 3, 20, 26, 8, bias_shape)
    g = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)
    leaves = [t.requires_grad_() for t in _torch(q, k, v, bias)]
    got = torch.autograd.grad((k4.fused_attention(*leaves) * torch.from_numpy(g)).sum(), leaves)
    assert got[3].shape == bias_shape

    def loss(fn):
        return lambda *a: jnp.sum(fn(*a) * g)

    jq, jk, jv, jb = map(jnp.asarray, (q, k, v, bias))
    want = jax.grad(loss(lambda q, k, v: jax_fused(q, k, v, jb, True)), argnums=(0, 1, 2))(
        jq, jk, jv)
    want = list(want) + [jax.grad(loss(_xla_attention), argnums=3)(jq, jk, jv, jb)]
    assert jax.grad(loss(lambda b: jax_fused(jq, jk, jv, b, True)))(jb) is not None
    for name, a, b in zip(["q", "k", "v", "bias"], got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    assert float(got[3].abs().max()) > 1e-3


def test_fused_attention_wrapper_refuses_bad_inputs():
    q, k, v, bias = _torch(*_dense_inputs(2, 2, 8, 8, 4, (2, 2, 8, 8)))
    # no grad needed: the plain forward; bf16 bias accepted
    out = k4.fused_attention(q, k, v, bias.bfloat16())
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="broadcast"):
        k4.fused_attention(q, k, v, bias[:, :, :4])
    with pytest.raises(ValueError, match="4-d"):
        k4.fused_attention(q, k, v, bias[0])
    with pytest.raises(ValueError, match="dtype"):
        k4.fused_attention(q.double(), k, v, bias)
    with pytest.raises(ValueError, match="contiguous"):
        k4.fused_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, bias)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        k4.fused_attention(*(t.to("meta") for t in (q, k, v, bias)))
    assert k4.fused_attention.launches == 0   # the CPU path launches nothing


def test_corrected_reciprocal_quotient_is_the_ieee_quotient():
    """csrc/common.cuh div_rn: x / y as q = x r, r = 1/y rounded, corrected
    once, fma(fma(-q, y, x), r, q), equals the rounded f32 quotient for the
    values K4 and K2c divide (exp of logits <= 0 over row sums >= 1). float64
    stands in for the FMA (the product of two f32 is exact there)."""
    rng = np.random.default_rng(0)
    n = 2_000_000
    x = rng.random(n, dtype=np.float32) ** np.float32(3)
    y = (np.float32(1) + rng.random(n, dtype=np.float32) * np.float32(511)).astype(np.float32)

    def fma(a, b, c):
        return (a.astype(np.float64) * b + c).astype(np.float32)

    r = np.float32(1) / y
    q = x * r
    assert np.count_nonzero(q != x / y) > n // 10      # the rounded product alone is not
    np.testing.assert_array_equal(fma(fma(-q, y, x), r, q), x / y)


def test_build_signature_takes_floats_and_uint32():
    """The ctypes argument list of a C entry: pointers, ints, uint32s, floats,
    then the stream (no library is loaded)."""
    import ctypes

    sig = _build.signature(2, 1, 2, 3)
    assert sig == [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_uint32] * 2 + \
        [ctypes.c_float] * 3 + [ctypes.c_void_p]
    assert _build.signature(7, 6) == [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    # a hash constant above 2**31 passes as uint32, a float as float
    assert ctypes.c_uint32(0x85EBCA6B).value == 0x85EBCA6B
    assert ctypes.c_float(0.9).value == np.float32(0.9)
