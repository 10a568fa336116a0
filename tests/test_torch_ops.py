"""The port's kernel modules vs the JAX package's Pallas kernels.

On this CPU the port's wrappers run their plain PyTorch versions; the JAX side
runs its Pallas kernels in interpret mode and its XLA references. Inputs are
made with numpy from a seed and handed to both. The CUDA kernels themselves
are tested against the plain versions in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lako_tpu.ops.decode_cross_attn import (
    fused_decode_cross_attention as jax_fused_cross,
    xla_reference as jax_cross_reference,
)
from lako_tpu.ops.flash_streamed import _xla_reference, streamed_attention as jax_streamed
from lako_tpu_torch.ops import decode_cross_attn as k3
from lako_tpu_torch.ops import flash_streamed as k1


def _attn_inputs(B, H, L, Lk, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, L, D)).astype(np.float32)
    k = rng.normal(size=(B, H, Lk, D)).astype(np.float32)
    v = rng.normal(size=(B, H, Lk, D)).astype(np.float32)
    rel = rng.normal(size=(H, L, Lk)).astype(np.float32)
    mask = rng.random((B, Lk)) < 0.8
    mask[:, 0] = True
    mask[1] = False          # a padding row: every key masked
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


def test_streamed_wrapper_refuses_bad_inputs():
    q, k, v, rel, mask = _torch(*_attn_inputs(2, 2, 8, 8, 4))
    with pytest.raises(NotImplementedError, match="backward"):
        k1.streamed_attention(q.requires_grad_(), k, v, rel, mask)
    q = q.detach()
    with pytest.raises(ValueError, match="rel_bias"):
        k1.streamed_attention(q, k, v, rel.double(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        k1.streamed_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, rel, mask)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        k1.streamed_attention(*(t.to("meta") for t in (q, k, v, rel, mask)))
    assert k1.streamed_attention.launches == 0   # the CPU path launches nothing


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
