"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it also runs where JAX is absent; there, skip the repository's
conftest (which sets JAX up):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import time

import numpy as np
import pytest
import torch

from lako_tpu_torch.core.config import OptimConfig, T5Config
from lako_tpu_torch.models.t5 import init_fid_t5
from lako_tpu_torch.models.t5.engine import DecodeEngine, _quantize_kv
from lako_tpu_torch.ops import adam8_kernel as k5
from lako_tpu_torch.ops import decode_cross_attn as k3
from lako_tpu_torch.ops import flash_attention as k4
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


def _attn_inputs(B, H, L, Lk, D, dev, dtype, seed=0, padding_row=True):
    rng = np.random.default_rng(seed)
    # q at the scale T5's init gives it (std d_kv**-0.5): logits ~N(0, 1)
    q = rng.normal(size=(B, H, L, D)) * D ** -0.5
    k, v = (rng.normal(size=(B, H, Lk, D)) for _ in range(2))
    rel = rng.normal(size=(H, L, Lk)) * 0.5
    mask = rng.random((B, Lk)) < 0.6
    mask[:, 0] = True
    if padding_row:
        mask[-1] = False         # a padding row: every key masked
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


# the bf16 kernels' edges: one row, one 16-row warp tile and one past it, a
# ragged 9-warp slab; keys short of an 8-key tile, one 16-key tile, one past a
# 64-key tile, a ragged 6-tile walk
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Lk", [7, 16, 65, 330])
@pytest.mark.parametrize("L", [1, 16, 17, 145])
def test_streamed_bf16_kernels_at_edges(cuda_device, L, Lk, D):
    """K1 with statistics and K2a in bf16 against their plain versions, with
    row 1 fully masked: out within 6e-2, (m, l) within 1e-4 relative ((-1e9,
    Lk) exactly on the masked row), dK and dV within 3e-2 of their largest
    magnitude; K2a bitwise the same in a second launch (no atomics)."""
    q, k, v, rel, mask = _attn_inputs(2, 3, L, Lk, D, cuda_device, torch.bfloat16)
    before = (k1.streamed_attention.launches, k1.streamed_attention_bwd_dkdv.launches)
    out, stats = k1._forward(q, k, v, rel, mask, with_stats=True)
    want_out, want_stats = k1.streamed_attention_fwd_reference(q, k, v, rel, mask)
    torch.testing.assert_close(out.float(), want_out.float(), rtol=6e-2, atol=6e-2)
    torch.testing.assert_close(stats, want_stats, rtol=1e-4, atol=1e-4)
    assert stats[1, ..., 0].eq(-1e9).all() and stats[1, ..., 1].eq(Lk).all()
    dout = torch.randn(q.shape, generator=torch.Generator(device=cuda_device).manual_seed(6),
                       device=cuda_device).to(torch.bfloat16)
    args = (q, k, v, rel, mask, want_stats, (dout.float() * want_out.float()).sum(-1), dout)
    first = k1.streamed_attention_bwd_dkdv(*args)
    second = k1.streamed_attention_bwd_dkdv(*args)
    torch.cuda.synchronize()
    assert (k1.streamed_attention.launches, k1.streamed_attention_bwd_dkdv.launches) == (
        before[0] + 1, before[1] + 2)
    for got, again, want in zip(first, second, k1.streamed_attention_bwd_dkdv_reference(*args)):
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert bool(torch.isfinite(got.float()).all())
        assert _rel_err(got, want) <= 3e-2
        assert torch.equal(got, again)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Lk", [7, 16, 65, 330])
@pytest.mark.parametrize("L", [1, 16, 17, 145])
def test_dq_bf16_kernel_at_edges(cuda_device, L, Lk, D):
    """K2b in bf16 on the tensor cores against its plain version at the same
    edges as K1 and K2a, row 1 fully masked (its dQ exactly 0): within 3e-2
    of the largest magnitude, and bitwise the same in a second launch (no
    atomics)."""
    q, k, v, rel, mask = _attn_inputs(2, 3, L, Lk, D, cuda_device, torch.bfloat16)
    out, stats = k1.streamed_attention_fwd_reference(q, k, v, rel, mask)
    dout = torch.randn(q.shape, generator=torch.Generator(device=cuda_device).manual_seed(8),
                       device=cuda_device).to(torch.bfloat16)
    args = (q, k, v, rel, mask, stats, (dout.float() * out.float()).sum(-1), dout)
    before = k1.streamed_attention_bwd_dq.launches
    first = k1.streamed_attention_bwd_dq(*args)
    second = k1.streamed_attention_bwd_dq(*args)
    torch.cuda.synchronize()
    assert k1.streamed_attention_bwd_dq.launches == before + 2
    want = k1.streamed_attention_bwd_dq_reference(*args)
    assert first.shape == want.shape and first.dtype == torch.bfloat16
    assert bool(torch.isfinite(first.float()).all())
    assert _rel_err(first, want) <= 3e-2
    assert not first[1].float().any()
    assert torch.equal(first, second)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L,Lk", [(17, 65), (145, 330), (130, 130)])
def test_streamed_bf16_kernels_one_batch_row(cuda_device, L, Lk, D):
    """B = 1, no fully masked row: K1, K2a and K2b against their plain
    versions."""
    q, k, v, rel, mask = _attn_inputs(1, 2, L, Lk, D, cuda_device, torch.bfloat16,
                                      padding_row=False)
    out, stats = k1._forward(q, k, v, rel, mask, with_stats=True)
    want_out, want_stats = k1.streamed_attention_fwd_reference(q, k, v, rel, mask)
    torch.testing.assert_close(out.float(), want_out.float(), rtol=6e-2, atol=6e-2)
    torch.testing.assert_close(stats, want_stats, rtol=1e-4, atol=1e-4)
    dout = torch.randn(q.shape, generator=torch.Generator(device=cuda_device).manual_seed(7),
                       device=cuda_device).to(torch.bfloat16)
    args = (q, k, v, rel, mask, want_stats, (dout.float() * want_out.float()).sum(-1), dout)
    for got, want in zip(k1.streamed_attention_bwd_dkdv(*args),
                         k1.streamed_attention_bwd_dkdv_reference(*args)):
        assert _rel_err(got, want) <= 3e-2
    assert _rel_err(k1.streamed_attention_bwd_dq(*args),
                    k1.streamed_attention_bwd_dq_reference(*args)) <= 3e-2


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


@pytest.mark.parametrize("B,H,L,Lk,D", [(1, 4, 130, 130, 64), (5, 4, 130, 130, 64),
                                         (3, 2, 37, 45, 64), (16, 16, 130, 130, 64),
                                         (5, 2, 130, 130, 128)])
def test_drel_kernel_edges_and_bitwise_repeat(cuda_device, B, H, L, Lk, D):
    """K2c in bf16 on the tensor cores: one batch row, an odd batch, a short
    ragged key edge, both head dims; within 3e-2 of the plain version's
    largest magnitude, and bitwise the same in a second launch (each element
    is summed over the batch in one fixed order, with no atomics). B=1 has no
    fully masked row, whose dS is 0 everywhere."""
    q, k, v, rel, mask = _attn_inputs(B, H, L, Lk, D, cuda_device, torch.bfloat16,
                                      padding_row=B > 1)
    dout = torch.randn(q.shape, generator=torch.Generator(device=cuda_device).manual_seed(5),
                       device=cuda_device).to(torch.bfloat16)
    out, stats = k1.streamed_attention_fwd_reference(q, k, v, rel, mask)
    dvec = (dout.float() * out.float()).sum(-1)
    args = (q, k, v, rel, mask, stats, dvec, dout)
    before = k1.streamed_attention_bwd_drel.launches
    first = k1.streamed_attention_bwd_drel(*args)
    second = k1.streamed_attention_bwd_drel(*args)
    torch.cuda.synchronize()
    assert k1.streamed_attention_bwd_drel.launches == before + 2
    want = k1.streamed_attention_bwd_drel_reference(*args)
    assert first.shape == want.shape == (H, L, Lk) and first.dtype == torch.float32
    assert bool(torch.isfinite(first).all())
    assert _rel_err(first, want) <= 3e-2
    assert torch.equal(first, second)


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


def _decode_cross_f64(q, k_i8, k_scale, v_i8, v_scale, bias):
    """K3's function in float64: the exact result to within float32's
    rounding."""
    kf = k_i8.double() * k_scale.double()[..., None]
    vf = v_i8.double() * v_scale.double()[..., None]
    p = torch.softmax(torch.einsum("bhd,bhdk->bhk", q.double(), kf) + bias.double(), dim=-1)
    return torch.einsum("bhk,bhdk->bhd", p, vf)


# past 16 warps of 16 rows: two row groups a warp and two ring stages at
# d = 320, one stage at 512, three groups at 768
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [37, 260, 3000])
@pytest.mark.parametrize("B,d", [(1, 320), (8, 320), (1, 512), (8, 512), (2, 768)])
def test_decode_cross_kernel_wide_heads(cuda_device, B, d, K, q_dtype):
    """K3 at head dims above 256, bitwise the same in a second launch. Its
    logits grow as sqrt(d) and their float32 sums round by ~3e-5 at d = 512
    in any order, so the kernel and its plain version (float32) are each
    held to the float64 result: the kernel within 1e-5 plus twice the plain
    version's own error."""
    args = _int8_cross_inputs(B, K, q_dtype, cuda_device, h=4, d=d)
    before = k3.fused_decode_cross_attention.launches
    out = k3.fused_decode_cross_attention(*args)
    again = k3.fused_decode_cross_attention(*args)
    torch.cuda.synchronize()
    assert k3.fused_decode_cross_attention.launches == before + 2
    assert torch.equal(out, again)
    exact = _decode_cross_f64(*args)
    err = float((out.double() - exact).abs().max())
    plain_err = float((k3.reference(*args).double() - exact).abs().max())
    assert err <= 1e-5 + 2 * plain_err, (err, plain_err)


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


def _int8_cross_inputs(B, K, q_dtype, dev, h=16, d=64, seed=0):
    """q, int8 K/V with random per-channel scales, and a (B,1,K) mask bias,
    made on the card without a float copy of K/V."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, h, d, generator=gen, device=dev).to(q_dtype)
    kv = [torch.randint(-127, 128, (B, h, d, K), generator=gen, device=dev, dtype=torch.int8)
          for _ in range(2)]
    scales = [torch.rand(B, h, d, generator=gen, device=dev) * 0.02 + 0.002 for _ in range(2)]
    mask = torch.rand(B, K, generator=gen, device=dev) < 0.7
    mask[:, 0] = True
    bias = torch.where(mask, 0.0, -1e9).float()[:, None, :].contiguous()
    return q, kv[0], scales[0], kv[1], scales[1], bias


# K past the parent's limit of ~12,160 keys; an odd K reads bytes, not words
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [37, 260, 12161, 25000])
@pytest.mark.parametrize("B", [1, 8, 128])
def test_decode_cross_kernel_split_keys(cuda_device, B, K, q_dtype):
    """K3 (the keys split over a cluster of blocks, merged in the launch)
    against its plain version within 1e-5 (f32 logits, softmax and output),
    the plain version on the whole batch (its f32 product sums the logits in
    an order that depends on the batch, and an ulp of a logit moves the
    output by ~1e-5); bitwise the same in a second launch (a fixed merge
    order, no atomics)."""
    args = _int8_cross_inputs(B, K, q_dtype, cuda_device)
    before = k3.fused_decode_cross_attention.launches
    out = k3.fused_decode_cross_attention(*args)
    again = k3.fused_decode_cross_attention(*args)
    torch.cuda.synchronize()
    assert k3.fused_decode_cross_attention.launches == before + 2
    assert torch.equal(out, again)
    torch.testing.assert_close(out, k3.reference(*args), rtol=1e-5, atol=1e-5)


def test_engine_kernels_on_the_card(cuda_device):
    """A tiny model on the card: the kernel configuration launches both
    kernels and agrees with the no-kernel one on >= 0.9 of the tokens; a
    sequence shorter than flash_min_length takes K4, once a layer."""
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
    # the wrapper's calls, per layer: step 0, one step before the engine's
    # first graph capture, and the 4 launches the capture records
    assert k3.fused_decode_cross_attention.launches == k3_before + 2 * 5 + 2
    t_off, _ = DecodeEngine(off, max_length=6, kv_dtype="int8").generate(ids, mask)
    assert len(torch.unique(t_off)) > 1
    assert (t_on == t_off).float().mean() >= 0.9
    k4_before, k1_before = k4.fused_attention.launches, k1.streamed_attention.launches
    short = on.encode_passages(ids[..., :8], mask[..., :8])[0]
    assert k4.fused_attention.launches == k4_before + 2
    assert k1.streamed_attention.launches == k1_before
    torch.testing.assert_close(short, off.encode_passages(ids[..., :8], mask[..., :8])[0],
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="fused_cross"):
        DecodeEngine(off, kv_dtype="native", fused_cross=True)


def _tiny_decode_model(dev, seed=0):
    cfg = T5Config(vocab_size=64, d_model=128, d_kv=64, d_ff=256, num_layers=2,
                   num_decoder_layers=3, num_heads=2, relative_attention_num_buckets=8,
                   dropout_rate=0.0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = init_fid_t5(cfg, gen)
    with torch.no_grad():   # scaled down so that the greedy tokens vary
        model.t5.shared.weight.mul_(0.02)
        # EOS where token 5 was a positive argmax: rows finish at different steps
        model.t5.shared.weight[1] = model.t5.shared.weight[5] * 1.05
    ids = torch.randint(2, 64, (4, 2, 20), generator=gen, device=dev)
    mask = torch.rand(4, 2, 20, generator=gen, device=dev) < 0.9
    mask[..., 0] = True
    return model, ids, mask


def _k3_runs(fn):
    """fn's result and the K3 kernels that ran on the card while it ran
    (torch.profiler, graph replays included)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum("decode_cross_kernel" in e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)


def _captured_steps(engine):
    """The decode steps in every chunk the engine has captured."""
    return sum(n for st in engine._batches.values() for _, n in st.chunks)


@pytest.mark.parametrize("chunk_size", [None, 2])
@pytest.mark.parametrize("kw", [dict(kv_dtype="int8", fused_cross=True), dict(),
                                dict(kv_dtype="int8mxu", weights_dtype="int8",
                                     self_cache_layout="sd")])
def test_graphed_chunks_equal_eager(cuda_device, kw, chunk_size):
    """The token loop as CUDA graphs gives the eager loop's tokens, with and
    without K3, unchunked and chunked, on a first batch and on a second one
    replayed through the same graphs. The graphs run K3 as often as the eager
    loop does (from a profiler trace); its wrapper counts the first batch's
    capture, and on the second batch only step 0 unless a new chunk is
    captured."""
    model, ids, mask = _tiny_decode_model(cuda_device)
    eager = DecodeEngine(model, max_length=10, chunk_size=chunk_size, cuda_graphs=False, **kw)
    graphed = DecodeEngine(model, max_length=10, chunk_size=chunk_size, **kw)
    assert graphed.graphed and not eager.graphed
    layers = model.config.num_decoder_layers
    for first, batch in ((True, [0, 1, 2, 3]), (False, [3, 1, 2, 0])):
        before = k3.fused_decode_cross_attention.launches
        (want, _), eager_runs = _k3_runs(lambda: eager.generate(ids[batch], mask[batch]))
        eager_k3 = k3.fused_decode_cross_attention.launches - before
        captured = _captured_steps(graphed)
        before = k3.fused_decode_cross_attention.launches
        (got, _), graphed_runs = _k3_runs(lambda: graphed.generate(ids[batch], mask[batch]))
        graphed_k3 = k3.fused_decode_cross_attention.launches - before
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert graphed.last_chunks == eager.last_chunks
        fused = bool(kw.get("fused_cross"))
        warm = layers if first and fused else 0   # one step before the first capture
        assert eager_runs == eager_k3 and (eager_k3 > 0) == fused
        assert graphed_runs == eager_k3 + warm
        new = _captured_steps(graphed) - captured
        assert graphed_k3 == warm + (layers * (1 + new) if fused else 0)
    assert len(torch.unique(want)) > 2


def test_int8mxu_products_exact_past_1040_keys(cuda_device):
    """int8mxu's q·K and p·V on the card are exact integers at 2500 keys,
    against an int64 product on the CPU, the largest sum included."""
    from lako_tpu_torch.models.t5.engine import _int8_contract

    gen = torch.Generator().manual_seed(0)
    p = torch.randint(-127, 128, (8, 16, 2500), generator=gen, dtype=torch.int8)
    v = torch.randint(-127, 128, (8, 16, 64, 2500), generator=gen, dtype=torch.int8)
    q = torch.randint(-127, 128, (8, 16, 64), generator=gen, dtype=torch.int8)
    p[0, 0] = 127
    v[0, 0] = -127
    got_pv = _int8_contract("bhk,bhdk->bhd", p.to(cuda_device), v.to(cuda_device), 2, 3)
    got_qk = _int8_contract("bhd,bhdk->bhk", q.to(cuda_device), v.to(cuda_device), 2, 2)
    want_pv = torch.einsum("bhk,bhdk->bhd", p.long(), v.long())
    want_qk = torch.einsum("bhd,bhdk->bhk", q.long(), v.long())
    assert int(want_pv.abs().max()) > 2 ** 24
    assert torch.equal(got_pv.cpu().long(), want_pv)
    assert torch.equal(got_qk.cpu().long(), want_qk)


def _dense_bias(rel, mask, shape):
    """rel (H,L,Lk) plus the key mask as -1e9, cut to a (broadcast) shape."""
    full = rel[None] + torch.where(mask[:, None, None, :], 0.0, -1e9)
    return full[tuple(slice(0, n) for n in shape)].contiguous()


# K1's tolerances: bf16 rounds the plain version's logits, the kernel's not
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-4), (torch.bfloat16, 6e-2)])
@pytest.mark.parametrize("shape,bias_shape", [
    ((16, 16, 130, 130, 64), (16, 16, 130, 130)),
    ((3, 2, 77, 200, 64), (1, 2, 77, 200)),
    ((2, 4, 130, 512, 128), (2, 1, 130, 512)),
    ((2, 3, 40, 56, 32), (2, 3, 40, 56)),
    ((2, 4, 130, 257, 64), (2, 4, 130, 257)),
    ((2, 4, 130, 512, 64), (1, 4, 130, 512)),
    ((2, 4, 130, 257, 128), (2, 4, 130, 257)),
    ((2, 3, 1, 40, 64), (1, 3, 1, 40)),
    ((2, 2, 24, 7, 128), (2, 1, 24, 7)),
])
def test_fused_attention_kernel_matches_plain(cuda_device, dtype, atol, shape, bias_shape):
    """K4 against its plain version, a fully masked row included, with full
    and broadcast (batch or head) f32 biases; a bf16 bias and none too; more
    than 512 keys (no bias) through the two-pass tier. bf16 at head dims 64 and 128 takes the tensor-core
    kernel (logits in registers up to 160 keys, in shared memory at 257 and
    512; odd Lk reads the bias one element at a time; L=1; Lk < 16), at 32
    the CUDA-core one."""
    q, k, v, rel, mask = _attn_inputs(*shape, cuda_device, dtype)
    bias = _dense_bias(rel, mask, bias_shape)
    before = k4.fused_attention.launches
    out = k4.fused_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert k4.fused_attention.launches == before + 1
    want = k4.fused_attention_reference(q, k, v, bias)
    torch.testing.assert_close(out.float(), want.float(), rtol=atol, atol=atol)
    out16 = k4.fused_attention(q, k, v, bias.bfloat16())
    torch.testing.assert_close(out16.float(), k4.fused_attention_reference(
        q, k, v, bias.bfloat16()).float(), rtol=atol, atol=atol)
    torch.testing.assert_close(k4.fused_attention(q, k, v, None).float(),
                               k4.fused_attention_reference(q, k, v, None).float(),
                               rtol=atol, atol=atol)
    # past 512 keys the two-pass tier takes the same call
    kk, vv = (torch.cat([t] * (512 // t.shape[2] + 1), 2) for t in (k, v))
    torch.testing.assert_close(k4.fused_attention(q, kk, vv, None).float(),
                               k4.fused_attention_reference(q, kk, vv, None).float(),
                               rtol=atol, atol=atol)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-4), (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("Lk", [513, 1000, 2048])
def test_fused_attention_beyond_512_keys(cuda_device, Lk, dtype, atol, D):
    """K4's two-pass tier (Lk > 512) against its plain version, a fully
    masked row included: a full f32 bias, a head-broadcast one, one read
    through an odd row stride (a slice of a wider tensor), one with the keys
    strided (a transposed copy) and a bf16 one; max abs error 2e-4 (f32) and
    1.6e-2 (bf16, the tensor-core tiers' bound)."""
    q, k, v, rel, mask = _attn_inputs(2, 3, 70, Lk, D, cuda_device, dtype)
    full = _dense_bias(rel, mask, (2, 3, 70, Lk))
    wide = torch.zeros(2, 3, 70, Lk + 1, device=cuda_device)
    wide[..., :Lk] = full
    biases = [full, _dense_bias(rel, mask, (2, 1, 70, Lk)), wide[..., :Lk],
              full.transpose(2, 3).contiguous().transpose(2, 3), full.bfloat16()]
    for bias in biases:
        before = k4.fused_attention.launches
        out = k4.fused_attention(q, k, v, bias)
        torch.cuda.synchronize()
        assert k4.fused_attention.launches == before + 1
        want = k4.fused_attention_reference(q, k, v, bias)
        assert out.shape == want.shape and out.dtype == dtype
        assert float((out.float() - want.float()).abs().max()) <= atol, bias.stride()


def test_fused_attention_gradients_on_the_card(cuda_device):
    """The autograd Function: K4 forward, the plain recomputed backward,
    dbias summed to a broadcast bias's shape, equal to autograd of the
    plain version within 2e-4 (f32)."""
    q, k, v, rel, mask = _attn_inputs(4, 3, 50, 50, 64, cuda_device, torch.float32)
    bias = _dense_bias(rel, mask, (1, 3, 50, 50))
    dout = torch.randn(q.shape, generator=torch.Generator(device=cuda_device).manual_seed(1),
                       device=cuda_device)
    grads = []
    for fn in (k4.fused_attention, k4.fused_attention_reference):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        grads.append(torch.autograd.grad(fn(*leaves), leaves, dout))
    for a, b in zip(*grads):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


def test_fused_attention_gradients_beyond_512_keys(cuda_device):
    """The autograd Function at Lk = 600 (the two-pass tier forward, the plain
    recomputed backward): equal to autograd of the plain version within 2e-4
    (f32), dbias summed to the head-broadcast bias's shape."""
    q, k, v, rel, mask = _attn_inputs(2, 3, 40, 600, 64, cuda_device, torch.float32)
    bias = _dense_bias(rel, mask, (2, 1, 40, 600))
    dout = torch.randn(q.shape, generator=torch.Generator(device=cuda_device).manual_seed(2),
                       device=cuda_device)
    grads = []
    for fn in (k4.fused_attention, k4.fused_attention_reference):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        before = k4.fused_attention.launches
        grads.append(torch.autograd.grad(fn(*leaves), leaves, dout))
        assert k4.fused_attention.launches == before + (fn is k4.fused_attention)
    for a, b in zip(*grads):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


def _adam8_inputs(nb, dev, g_dtype, seed=0):
    rng = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    g = to((rng.normal(size=(nb, 256)) * 1e-3).astype(np.float32)).to(g_dtype)
    return (g, to(rng.integers(-127, 128, (nb, 256)).astype(np.int8)),
            to((np.abs(rng.normal(size=(nb, 1))) * 1e-3).astype(np.float32)),
            to(rng.integers(0, 256, (nb, 256)).astype(np.uint8)),
            to((np.abs(rng.normal(size=(nb, 1))) * 1e-6).astype(np.float32)))


# the tiers: contiguous (ragged and aligned), tile (out % 256 == 0; a partial
# column group at in = 40, bf16 at 64), strided (out = 96)
@pytest.mark.parametrize("correct_bias", [False, True])
@pytest.mark.parametrize("n,shape,transposed,g_dtype", [
    (1000, (1000,), False, torch.float32),
    (4096 * 64, (4096, 64), True, torch.float32),
    (96 * 40, (96, 40), True, torch.bfloat16),
    (256 * 37, (37, 256), False, torch.bfloat16),
    (512 * 40, (512, 40), True, torch.float32),
    (256 * 64, (256, 64), True, torch.bfloat16),
])
def test_adam8_kernel_bitwise_matches_plain(cuda_device, n, shape, transposed, g_dtype,
                                            correct_bias):
    """K5 against its plain version on the card, steps 1 and 7: codes,
    scales and u bitwise equal (the bias corrections come from the host)."""
    nb = -(-n // 256)
    g, mq, ms, vq, vs = _adam8_inputs(nb, cuda_device, g_dtype)
    g = g.reshape(-1)[:n].reshape(shape).contiguous()
    hyper = dict(b1=0.9, b2=0.999, eps=1e-6, correct_bias=correct_bias,
                 stochastic_round=True, seed=0x8B17, leaf_salt=3, transposed=transposed)
    for count in (1, 7):
        before = k5.fused_adam8_update.launches
        got = k5.fused_adam8_update(g, mq, ms, vq, vs, count, **hyper)
        torch.cuda.synchronize()
        assert k5.fused_adam8_update.launches == before + 1
        want = k5.fused_adam8_update_reference(g, mq, ms, vq, vs, count, **hyper)
        assert got[0].shape == g.shape and got[0].dtype == g.dtype
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_adam8_ema_fragment_bitwise_matches_plain(cuda_device):
    g, mq, ms, vq, vs = _adam8_inputs(1000, cuda_device, torch.bfloat16)
    before = k5.adam8_ema_fragment.launches
    got = k5.adam8_ema_fragment(g, mq, ms, vq, vs)
    torch.cuda.synchronize()
    assert k5.adam8_ema_fragment.launches == before + 1
    assert torch.equal(got, k5.adam8_ema_fragment_reference(g, mq, ms, vq, vs))


def _adam8_tree(dev, seed=0):
    """Leaves of every tier and both orders, f32 and bf16 gradients in one
    update, with a mid-training flat state: (grads, state, layout)."""
    kinds = [((1024, 64), True, torch.float32, False),     # tile
             ((9,), False, torch.float32, True),           # small, jnp order
             ((0,), False, torch.float32, True),           # empty
             ((70001,), False, torch.bfloat16, True),      # ragged, bf16
             ((40, 16), True, torch.float32, True),        # out % 256 != 0: strided
             ((300, 256), False, torch.float32, False),    # contiguous, aligned
             ((512, 40), True, torch.bfloat16, False),     # tile, partial column group
             ((96, 40), True, torch.bfloat16, False),      # strided, bf16
             ((4, 256), False, torch.bfloat16, True)]
    rng = np.random.default_rng(seed)
    grads = [torch.from_numpy((rng.normal(size=shape) * 1e-3).astype(np.float32)).to(dev, dtype)
             for shape, _, dtype, _ in kinds]
    nbs = tuple(-(-g.numel() // 256) for g in grads)
    _, mq, ms, vq, vs = _adam8_inputs(sum(nbs), dev, torch.float32, seed=seed + 1)
    layout = k5.LeafLayout(tuple(3 * i + 1 for i in range(len(kinds))),
                           tuple(k[1] for k in kinds), tuple(k[3] for k in kinds), nbs)
    return grads, (mq, ms, vq, vs), layout


@pytest.mark.parametrize("correct_bias", [False, True])
def test_adam8_leaves_kernel_bitwise_matches_plain(cuda_device, correct_bias):
    """K5 over a tree of mixed leaves in one launch (every tier, both rounding
    orders, f32 and bf16 gradients, an empty leaf), steps 1 and 7: u of every
    leaf and the flat new state bitwise equal to the plain per-leaf
    versions; the old state untouched."""
    grads, state, layout = _adam8_tree(cuda_device)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-6, correct_bias=correct_bias,
                 stochastic_round=True, seed=0x8B17)
    old = [t.clone() for t in state]
    for count in (1, 7):
        before = k5.fused_adam8_update_leaves.launches
        us, flat = k5.fused_adam8_update_leaves(grads, state, layout, count, **hyper)
        torch.cuda.synchronize()
        assert k5.fused_adam8_update_leaves.launches == before + 1
        want_us, want_flat = k5.fused_adam8_update_leaves_reference(grads, state, layout, count,
                                                                    **hyper)
        for g, u, w in zip(grads, us, want_us):
            assert u.shape == g.shape and u.dtype == g.dtype
            assert torch.equal(u, w)
        for a, b in zip(flat, want_flat):
            assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(old, state))


def test_adam8_leaves_kernel_in_a_cuda_graph(cuda_device):
    """K5 over the mixed tree captured in a CUDA graph: each replay copies
    the descriptor table from the pinned buffer the capture kept and gives
    the eager launch's bits; once the graph is gone the buffer is freed."""
    from lako_tpu_torch.ops import _build

    grads, state, layout = _adam8_tree(cuda_device)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-6, correct_bias=True, stochastic_round=True,
                 seed=0x8B17)
    want_us, want_flat = k5.fused_adam8_update_leaves(grads, state, layout, 3, **hyper)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        held = len(_build._graph_buffers)
        with torch.cuda.graph(graph, stream=stream):
            us, flat = k5.fused_adam8_update_leaves(grads, state, layout, 3, **hyper)
        assert len(_build._graph_buffers) == held + 1
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(2):
        for t in (*us, *flat):
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(us, want_us))
        assert all(torch.equal(a, b) for a, b in zip(flat, want_flat))
    del graph, us, flat
    torch.cuda.synchronize()
    for _ in range(100):      # the graph's user object is released asynchronously
        _build.release_graph_buffers()
        if len(_build._graph_buffers) == held:
            break
        time.sleep(0.01)
    assert len(_build._graph_buffers) == held


def test_adam8_transform_launches_k5_once(cuda_device):
    """scale_by_adam_8bit("auto") on the card: one K5 launch an update over
    every leaf, each leaf bitwise equal to its plain version in the order
    the JAX package's rule gives it."""
    from lako_tpu_torch.train import optim8

    rng = np.random.default_rng(2)
    shapes = {"a/kernel": (1024, 64), "b": (9,), "c/kernel": (40, 16), "d": (300, 256)}
    grads = {k: torch.from_numpy((rng.normal(size=s) * 1e-3).astype(np.float32)).to(cuda_device)
             for k, s in shapes.items()}
    tx = optim8.scale_by_adam_8bit()
    state = tx.init(grads)
    for count in (1, 2):
        before = k5.fused_adam8_update_leaves.launches
        u, new = tx.update(grads, state)
        torch.cuda.synchronize()
        assert k5.fused_adam8_update_leaves.launches == before + 1
        for i, path in enumerate(optim8.leaf_order(grads)):
            g, mu, nu = grads[path], state.mu[path], state.nu[path]
            layout = k5.LeafLayout((i,), (optim8.is_transposed(path, g),),
                                   (not optim8.kernel_route(g),), (mu.q.shape[0],))
            (w,), flat = k5.fused_adam8_update_leaves_reference(
                [g], (mu.q, mu.scale, nu.q, nu.scale), layout, count, b1=0.9, b2=0.999,
                eps=1e-6, correct_bias=False, stochastic_round=True, seed=0x8B17)
            assert torch.equal(u[path], w)
            got = (new.mu[path].q, new.mu[path].scale, new.nu[path].q, new.nu[path].scale)
            assert all(torch.equal(a, b) for a, b in zip(got, flat)), path
        state = new


def test_adamw8bit_train_step_on_the_fused_route(cuda_device):
    """A tiny train step (f32, remat) on the whole-block route with AdamW8bit:
    K4 twice a layer, K5 once a step over every parameter tensor, and the same parameters as
    the step on the CPU path (the same kernels' plain versions) within 1e-4
    of the step's movement."""
    base = dict(vocab_size=64, d_model=128, d_kv=64, d_ff=256, num_layers=2,
                num_decoder_layers=2, num_heads=2, relative_attention_num_buckets=8,
                dropout_rate=0.0, use_flash_attention=True)
    gen = torch.Generator().manual_seed(3)
    ids = torch.randint(1, 64, (4, 2, 40), generator=gen)
    mask = torch.rand(4, 2, 40, generator=gen) < 0.8
    mask[..., 0] = True
    labels = torch.randint(1, 64, (4, 6), generator=gen)
    cfg = OptimConfig(optim="adamw8bit", lr=1e-3, warmup_steps=0)
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        model = init_fid_t5(T5Config(**base), torch.Generator(device=dev).manual_seed(0),
                            use_remat=True)
        if dev.type == "cpu":
            model.load_state_dict(init)
        init = {k: t.detach().cpu().clone() for k, t in model.state_dict().items()}
        state = TrainState.create(model_params(model), make_optimizer(cfg))
        before = (k4.fused_attention.launches, k5.fused_adam8_update_leaves.launches)
        state, loss = make_reader_train_step(model)(state, ids.to(dev), mask.to(dev),
                                                   labels.to(dev), 0)
        launched = (k4.fused_attention.launches - before[0],
                    k5.fused_adam8_update_leaves.launches - before[1])
        assert launched == ((4, 1) if dev.type == "cuda" else (0, 0))
        results.append({k: t.detach().cpu() for k, t in model.state_dict().items()})
    for name, a in results[0].items():
        moved = float((results[1][name] - init[name]).abs().max())
        assert float((a - results[1][name]).abs().max()) <= 1e-4 * max(moved, 1e-3) + 1e-6, name


def test_adam8_state_checkpoint_round_trip(cuda_device, tmp_path):
    """The K5 state after two updates on the card, saved and loaded into a
    fresh template, moved back to the card: every code and scale bitwise,
    the flat layout intact, and the next K5 update from it bitwise the next
    update from the state that was saved."""
    from lako_tpu_torch.core.checkpoint import flatten_tree, load_checkpoint, save_checkpoint
    from lako_tpu_torch.train.optim8 import FlatMoments
    from lako_tpu_torch.train.reader import _cast_opt_like

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    shapes = {"t5/encoder/block_0/self_attn/q/kernel": (256, 512),   # K5's route
              "t5/encoder/final_ln/weight": (512,), "t5/shared/embedding": (300, 40)}
    params = {k: torch.randn(s, generator=gen, device=cuda_device) for k, s in shapes.items()}
    tx = make_optimizer(OptimConfig(optim="adamw8bit", warmup_steps=0, total_steps=10))
    state = tx.init(params)
    before = k5.fused_adam8_update_leaves.launches
    for _ in range(2):
        grads = {k: torch.randn_like(p) for k, p in params.items()}
        _, state = tx.update(grads, state, params)
    assert k5.fused_adam8_update_leaves.launches == before + 2
    save_checkpoint(str(tmp_path), "k5", params, state, step=2)
    _, loaded, meta = load_checkpoint(str(tmp_path), params, tx.init(params))
    loaded = _cast_opt_like(state, loaded)
    assert meta["step"] == 2 and isinstance(loaded[1].mu, FlatMoments)
    want, got = flatten_tree(state), flatten_tree(loaded)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert got[k].device == v.device and torch.equal(got[k], v), k
        else:
            assert got[k] == v, k
    grads = {k: torch.randn_like(p) for k, p in params.items()}
    u1, s1 = tx.update(grads, state, params)
    u2, s2 = tx.update(grads, loaded, params)
    for k in u1:
        assert torch.equal(u1[k], u2[k]), k
    for a, b in zip(flatten_tree(s1).values(), flatten_tree(s2).values()):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_generate_and_score_on_the_card(cuda_device):
    """make_generate_and_score_fn on the card, engine route and
    layer-unrolled route: the tokens of make_best_generate_fn, and scores
    within rtol 1e-5 of the numpy aggregation of that function's own
    step-0 logits."""
    from lako_tpu_torch.core.config import AttentionSignalConfig
    from lako_tpu_torch.models.t5.decode import (
        make_best_generate_fn,
        make_generate_and_score_fn,
    )
    from lako_tpu_torch.signal import aggregate_fact_scores

    model, ids, mask = _tiny_decode_model(cuda_device)
    spans = torch.tensor([[[2, 6], [6, 11], [11, 20]], [[2, 9], [0, 0], [0, 0]],
                          [[3, 4], [4, 12], [12, 19]], [[2, 20], [0, 0], [0, 0]]],
                         dtype=torch.int32, device=cuda_device)
    for style in ("mean", "max", "21mean"):
        cfg = AttentionSignalConfig(attention_score_style=style, n_context=3)
        for backend in ("engine", "flax"):
            tokens, scores = make_generate_and_score_fn(model, cfg, max_length=6,
                                                        backend=backend)(ids, mask, spans)
            want_tokens, xl = make_best_generate_fn(model, max_length=6, backend=backend,
                                                    collect_cross_scores=True)(ids, mask)
            assert scores.device.type == "cuda" and scores.shape == (4, 3)
            assert torch.equal(tokens, want_tokens)
            want = aggregate_fact_scores(xl.cpu().numpy(), mask.cpu().numpy(),
                                         spans.cpu().numpy(), cfg)
            np.testing.assert_allclose(scores.cpu().numpy(), want, rtol=1e-5, atol=1e-6)


def _integer_corpus(n, d, seed=0):
    """Small integers: every score is an integer that any summation order,
    bfloat16 inputs and TF32 compute exactly, so equal scores tie exactly
    on every device; one row is copied 600 times and queried, so the
    boundary of k=500 falls inside the group."""
    rng = np.random.default_rng(seed)
    emb = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    group = rng.choice(np.arange(1, n), size=599, replace=False)
    emb[group] = emb[0]
    q = rng.integers(-4, 5, size=(37, d)).astype(np.float32)
    q[0] = emb[0]
    return emb, q


@pytest.mark.parametrize("method", ["exact", "fast", "approx"])
def test_dense_index_on_the_card_matches_the_cpu(cuda_device, method):
    """Ids and scores on the card equal the CPU path's, ties included (the
    lowest 500 rows of the copied group at the boundary), one chunk and
    several."""
    from lako_tpu_torch.retrieval.index import DenseIndex

    emb, q = _integer_corpus(20_000, 32)
    for chunk_size in (131072, 3000):
        card = DenseIndex(emb, chunk_size=chunk_size, method=method, device=cuda_device)
        assert card._emb.device.type == "cuda"
        cpu = DenseIndex(emb, chunk_size=chunk_size, method=method, device="cpu")
        got, want = card.search(q, 500), cpu.search(q, 500)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        group = np.flatnonzero((emb == emb[0]).all(1))
        np.testing.assert_array_equal(got[0][0], group[:500])
    cand = np.stack([np.random.default_rng(i).permutation(20_000)[:500] for i in range(len(q))])
    got, want = card.rerank(cand, q), cpu.rerank(cand, q)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_exact_search_ignores_tf32(cuda_device):
    """With TF32 turned on by the caller, "exact" and rerank still compute
    in float32 (the ids and scores of the run with it off), and the
    caller's setting is left as it was."""
    from lako_tpu_torch.retrieval.index import DenseIndex

    rng = np.random.default_rng(1)
    emb = rng.normal(size=(50_000, 256)).astype(np.float32)
    q = rng.normal(size=(64, 256)).astype(np.float32)
    index = DenseIndex(emb, chunk_size=16384, device=cuda_device)
    want = index.search(q, 100)
    want_rr = index.rerank(want[0], q)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = index.search(q, 100)
        got_rr = index.rerank(want[0], q)
        assert torch.backends.cuda.matmul.allow_tf32
        a = torch.randn(256, 256, device=cuda_device)
        tf32 = a @ a
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got_rr[1], want_rr[1])
    # the caller's TF32 was in force outside the index: its product differs
    assert not torch.equal(tf32, a @ a)


@pytest.mark.parametrize("n_bits", [8, 9])
def test_pq_index_on_the_card_matches_the_cpu(cuda_device, n_bits):
    """Codes on the card (uint8, or uint16 as int16 bits), decompressed
    bitwise, and the search's ids and scores equal the CPU path's."""
    from lako_tpu_torch.retrieval.pq import PQIndex

    emb, q = _integer_corpus(3000, 16, seed=2)
    m = 8 if n_bits == 8 else 2
    cpu = PQIndex.train(emb, n_subquantizers=m, n_bits=n_bits, train_size=3000, iters=3,
                        device="cpu")
    card = PQIndex(cpu.codebooks, cpu.codes, chunk_size=700, device=cuda_device)
    cpu.chunk_size = 700
    assert torch.equal(card.decompress(0, card.n).cpu(), cpu.decompress(0, cpu.n))
    got, want = card.search(q, 200), cpu.search(q, 200)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)


def test_bert_forward_on_the_card_matches_the_cpu(cuda_device):
    """The retriever's forward at f32 on the card within 1e-4 of the CPU's,
    padded rows included; with bf16 compute, whose scores (~5.5 here) are
    bf16 numbers, the scores within four bf16 ulps (0.125) of it."""
    from lako_tpu_torch.core.config import BertConfig, RetrieverConfig
    from lako_tpu_torch.models.bert import init_retriever

    cfg = RetrieverConfig(bert=BertConfig(num_hidden_layers=2), indexing_dimension=256)
    cpu = init_retriever(cfg, torch.Generator().manual_seed(0))
    card = init_retriever(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(3)
    q_ids = torch.from_numpy(rng.integers(1000, 30000, size=(4, 130)))
    p_ids = torch.from_numpy(rng.integers(1000, 30000, size=(4, 5, 130)))
    q_mask = torch.ones_like(q_ids, dtype=torch.bool)
    q_mask[1, 40:] = False
    p_mask = torch.ones_like(p_ids, dtype=torch.bool)
    p_mask[2, 3, 7:] = False
    gold = torch.softmax(torch.from_numpy(rng.normal(size=(4, 5))).float(), -1)
    args = (q_ids, q_mask, p_ids, p_mask, gold)
    with torch.no_grad():
        want = cpu(*args)
        got = card(*(a.to(cuda_device) for a in args))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0, atol=1e-4)
        bf16 = init_retriever(cfg, torch.Generator(device=cuda_device), torch.bfloat16)
        bf16.load_state_dict(cpu.state_dict())
        score = bf16(*(a.to(cuda_device) for a in args))[2]
    np.testing.assert_allclose(score.float().cpu().numpy(), want[2].numpy(), rtol=0, atol=0.125)
