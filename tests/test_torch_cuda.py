"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it also runs where JAX is absent; there, skip the repository's
conftest (which sets JAX up):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from lako_tpu_torch.core.config import OptimConfig, T5Config
from lako_tpu_torch.models.t5 import init_fid_t5
from lako_tpu_torch.models.t5.engine import DecodeEngine, _quantize_kv
from lako_tpu_torch.ops import decode_cross_attn as k3
from lako_tpu_torch.ops import flash_streamed as k1
from lako_tpu_torch.train.optim import make_optimizer
from lako_tpu_torch.train.reader import make_reader_train_step, model_params
from lako_tpu_torch.train.state import TrainState

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _attn_inputs(B, H, L, Lk, D, dev, dtype, seed=0):
    rng = np.random.default_rng(seed)
    # q at the scale T5's init gives it (std d_kv**-0.5): logits ~N(0, 1)
    q = rng.normal(size=(B, H, L, D)) * D ** -0.5
    k, v = (rng.normal(size=(B, H, Lk, D)) for _ in range(2))
    rel = rng.normal(size=(H, L, Lk)) * 0.5
    mask = rng.random((B, Lk)) < 0.6
    mask[:, 0] = True
    mask[-1] = False             # a padding row: every key masked
    to = lambda a, t: torch.tensor(a, dtype=t, device=dev)  # noqa: E731
    return (to(q, dtype), to(k, dtype), to(v, dtype), to(rel, torch.float32),
            to(mask, torch.bool))


# bf16: both sides round P (and the plain side its logits) to bf16
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-4), (torch.bfloat16, 6e-2)])
@pytest.mark.parametrize("shape", [(16, 16, 130, 130, 64), (3, 2, 300, 330, 64),
                                   (2, 4, 130, 130, 128)])
def test_streamed_kernel_matches_plain(cuda_device, dtype, atol, shape):
    args = _attn_inputs(*shape, cuda_device, dtype)
    before = k1.streamed_attention.launches
    out = k1.streamed_attention(*args)
    torch.cuda.synchronize()
    assert k1.streamed_attention.launches == before + 1
    torch.testing.assert_close(out.float(), k1.streamed_attention_reference(*args).float(),
                               rtol=atol, atol=atol)


def _rel_err(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def _assert_bwd_close(got, want, dtype):
    """f32: 2e-4 absolute on dq, dk, dv and drel within 3e-3 of its max (as
    the JAX package's test bounds it); bf16: max error over max magnitude
    at most 3e-2 for each."""
    for name, a, b in zip(("dq", "dk", "dv", "drel"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if dtype == torch.float32 and name != "drel":
            torch.testing.assert_close(a, b, rtol=0, atol=2e-4, msg=name)
        else:
            assert _rel_err(a, b) <= (3e-3 if dtype == torch.float32 else 3e-2), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 16, 130, 130, 64), (3, 2, 300, 330, 64),
                                   (2, 4, 130, 130, 128)])
def test_streamed_backward_kernels_match_plain(cuda_device, dtype, shape):
    """K2a/K2b/K2c called directly on the plain forward's statistics, and the
    whole autograd Function (K1 with statistics, then K2), against
    streamed_attention_bwd_reference; a fully masked row included."""
    q, k, v, rel, mask = _attn_inputs(*shape, cuda_device, dtype)
    dout = torch.randn(q.shape, generator=torch.Generator(device=cuda_device).manual_seed(2),
                       device=cuda_device).to(dtype)
    out, stats = k1.streamed_attention_fwd_reference(q, k, v, rel, mask)
    want = k1.streamed_attention_bwd_reference(q, k, v, rel, mask, out, stats, dout)
    dvec = (dout.float() * out.float()).sum(-1)
    args = (q, k, v, rel, mask, stats, dvec, dout)
    counters = (k1.streamed_attention_bwd_dkdv, k1.streamed_attention_bwd_dq,
                k1.streamed_attention_bwd_drel)
    before = [f.launches for f in counters]
    dk, dv = k1.streamed_attention_bwd_dkdv(*args)
    got = (k1.streamed_attention_bwd_dq(*args), dk, dv, k1.streamed_attention_bwd_drel(*args))
    torch.cuda.synchronize()
    assert [f.launches for f in counters] == [n + 1 for n in before]
    _assert_bwd_close(got, want, dtype)

    leaves = [t.clone().requires_grad_() for t in (q, k, v, rel)]
    k1_before = k1.streamed_attention.launches
    out = k1.streamed_attention(*leaves, mask)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert k1.streamed_attention.launches == k1_before + 1
    assert [f.launches for f in counters] == [n + 2 for n in before]
    _assert_bwd_close(got, want, dtype)


def test_train_step_kernels_against_plain(cuda_device):
    """One train step of a tiny model (f32, remat) with the streamed kernels
    and one without, from the same weights and batch: equal loss and
    gradients within 1e-4 relative, K1 launched twice per encoder layer
    (forward and recompute) and each K2 kernel once."""
    base = dict(vocab_size=64, d_model=128, d_kv=64, d_ff=256, num_layers=2,
                num_decoder_layers=2, num_heads=2, relative_attention_num_buckets=8,
                dropout_rate=0.0, flash_min_length=16)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    ids = torch.randint(1, 64, (4, 2, 40), generator=gen, device=cuda_device)
    mask = torch.rand(4, 2, 40, generator=gen, device=cuda_device) < 0.8
    mask[..., 0] = True
    labels = torch.randint(1, 64, (4, 6), generator=gen, device=cuda_device)
    labels[0, 4:] = -100
    losses, grads = [], []
    counters = (k1.streamed_attention, k1.streamed_attention_bwd_dkdv,
                k1.streamed_attention_bwd_dq, k1.streamed_attention_bwd_drel)
    for flash in (True, False):
        cfg = T5Config(**base, use_flash_attention=flash)
        model = init_fid_t5(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                            use_remat=True)
        state = TrainState.create(model_params(model), make_optimizer(OptimConfig(lr=1e-3)))
        before = [f.launches for f in counters]
        model.train()
        loss = model(ids, mask, labels)[0]
        grads.append(torch.autograd.grad(loss, list(state.params.values())))
        losses.append(float(loss.detach()))
        state, _ = make_reader_train_step(model)(state, ids, mask, labels, 0)
        torch.cuda.synchronize()
        launched = [f.launches - n for f, n in zip(counters, before)]
        assert launched == ([8, 4, 4, 4] if flash else [0, 0, 0, 0]), launched
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
    for a, b in zip(*grads):
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-12


@pytest.mark.parametrize("B,K", [(8, 260), (3, 37), (128, 260)])
def test_decode_cross_kernel_matches_plain(cuda_device, B, K):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    h, d = 16, 64
    q = torch.randn(B, h, d, generator=gen, device=cuda_device).to(torch.bfloat16)
    ck = _quantize_kv(torch.randn(B, h, d, K, generator=gen, device=cuda_device))
    cv = _quantize_kv(torch.randn(B, h, d, K, generator=gen, device=cuda_device))
    mask = torch.rand(B, K, generator=gen, device=cuda_device) < 0.7
    mask[:, 0] = True
    bias = torch.where(mask, 0.0, -1e9).float()[:, None, :].contiguous()
    args = (q, ck.values, ck.scale, cv.values, cv.scale, bias)
    before = k3.fused_decode_cross_attention.launches
    out = k3.fused_decode_cross_attention(*args)
    torch.cuda.synchronize()
    assert k3.fused_decode_cross_attention.launches == before + 1
    torch.testing.assert_close(out, k3.reference(*args), rtol=1e-5, atol=1e-5)


def test_engine_kernels_on_the_card(cuda_device):
    """A tiny model on the card: the kernel configuration launches both
    kernels and agrees with the no-kernel one on >= 0.9 of the tokens; a
    short sequence under use_flash_attention raises (K4 is not ported)."""
    base = dict(vocab_size=64, d_model=128, d_kv=64, d_ff=256, num_layers=2,
                num_decoder_layers=2, num_heads=2, relative_attention_num_buckets=8,
                dropout_rate=0.0)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    on = init_fid_t5(T5Config(**base, use_flash_attention=True, flash_min_length=16), gen)
    off = init_fid_t5(T5Config(**base), torch.Generator(device=cuda_device).manual_seed(0))
    with torch.no_grad():   # scaled down so that the greedy tokens vary
        on.t5.shared.weight.mul_(0.02)
        off.t5.shared.weight.mul_(0.02)
    ids = torch.randint(1, 64, (4, 2, 20), generator=gen, device=cuda_device)
    mask = torch.rand(4, 2, 20, generator=gen, device=cuda_device) < 0.9
    mask[..., 0] = True
    k1_before, k3_before = k1.streamed_attention.launches, k3.fused_decode_cross_attention.launches
    t_on, _ = DecodeEngine(on, max_length=6, kv_dtype="int8", fused_cross=True).generate(ids, mask)
    assert k1.streamed_attention.launches == k1_before + 2
    assert k3.fused_decode_cross_attention.launches == k3_before + 2 * 5
    t_off, _ = DecodeEngine(off, max_length=6, kv_dtype="int8").generate(ids, mask)
    assert len(torch.unique(t_off)) > 1
    assert (t_on == t_off).float().mean() >= 0.9
    with pytest.raises(NotImplementedError, match="K4"):
        on.encode_passages(ids[..., :8], mask[..., :8])
    with pytest.raises(ValueError, match="fused_cross"):
        DecodeEngine(off, kv_dtype="native", fused_cross=True)
