"""The port's FiD T5 vs the JAX package's, on shared weights (f32, CPU).

Weights come from a flax init and reach the port through ``params_from_jax``;
inputs are numpy arrays from a seed. With ``use_flash_attention`` the JAX side
runs its streamed Pallas kernel in interpret mode and the port runs the plain
version of its CUDA kernel.
"""

import collections

import numpy as np
import pytest
import torch
from flax import linen as flax_nn
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from lako_tpu.core.config import T5Config as JaxT5Config
from lako_tpu.models.t5.layers import relative_position_bucket as jax_bucket
from lako_tpu.models.t5.model import FiDT5 as JaxFiDT5
from lako_tpu_torch.core.config import T5Config
from lako_tpu_torch.models.t5 import FiDT5, init_fid_t5, params_from_jax
from lako_tpu_torch.models.t5.layers import Dropout, relative_position_bucket, set_dropout_key

TINY = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2,
            num_decoder_layers=2, num_heads=4, relative_attention_num_buckets=8,
            dropout_rate=0.0)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (8, 20)])
def test_relative_position_bucket_identical(bidirectional, buckets, max_distance):
    rel = np.arange(-512, 513, dtype=np.int32)
    want = np.asarray(jax_bucket(jnp.asarray(rel), bidirectional, buckets, max_distance))
    got = relative_position_bucket(torch.from_numpy(rel).long(), bidirectional,
                                   buckets, max_distance).numpy()
    np.testing.assert_array_equal(got, want)


def _batch(B=2, N=2, L=20, T=5, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 64, size=(B, N, L)).astype(np.int32)
    mask = rng.random((B, N, L)) < 0.8
    mask[..., 0] = True
    labels = rng.integers(1, 64, size=(B, T)).astype(np.int32)
    labels[0, 3:] = -100
    return ids, mask, labels


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("ff", ["relu", "gated-gelu"])
def test_fid_t5_matches_jax(monkeypatch, flash, ff):
    """Encoder output, loss, logits and captured cross logits within 1e-4."""
    monkeypatch.setenv("LAKO_FLASH_INTERPRET", "1")
    kw = dict(TINY, feed_forward_proj=ff, use_flash_attention=flash,
              flash_min_length=16)
    ids, mask, labels = _batch()
    jm = JaxFiDT5(JaxT5Config(**kw))
    params = jm.init(jax.random.PRNGKey(1), ids, mask, labels)["params"]
    j_loss, j_logits, j_xl = jm.apply({"params": params}, ids, mask, labels,
                                      collect_cross_logits=True)
    j_enc, _ = jm.apply({"params": params}, ids, mask, method=JaxFiDT5.encode_passages)

    model = FiDT5(T5Config(**kw))
    model.load_state_dict(params_from_jax(params))
    model.eval()
    t = [torch.from_numpy(a) for a in (ids, mask, labels)]
    with torch.inference_mode():
        loss, logits, xl = model(*t, collect_cross_logits=True)
        enc, _ = model.encode_passages(t[0], t[1])
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(enc.numpy(), np.asarray(j_enc), **tol)
    np.testing.assert_allclose(float(loss), float(j_loss), **tol)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **tol)
    np.testing.assert_allclose(xl.numpy(), np.asarray(j_xl), **tol)


def test_decoder_cache_helpers_match_jax():
    """T5Decoder.init_cache (zero self caches, projected cross K/V) and
    decode_biases (relpos block, cross key-mask bias) equal the JAX ones."""
    ids, mask, labels = _batch()
    jm = JaxFiDT5(JaxT5Config(**TINY))
    params = jm.init(jax.random.PRNGKey(2), ids, mask, labels)["params"]
    enc, enc_mask = jm.apply({"params": params}, ids, mask,
                             method=JaxFiDT5.encode_passages)
    dec = lambda m: m.t5.decoder  # noqa: E731
    j_caches, j_cross = jm.apply({"params": params}, 2, 7, enc,
                                 method=lambda m, *a: dec(m).init_cache(*a))
    j_rel, j_bias = jm.apply({"params": params}, enc_mask, 7,
                             method=lambda m, *a: dec(m).decode_biases(*a))

    model = FiDT5(T5Config(**TINY))
    model.load_state_dict(params_from_jax(params))
    with torch.inference_mode():
        caches, cross = model.t5.decoder.init_cache(2, 7, torch.tensor(np.asarray(enc)))
        rel, bias = model.t5.decoder.decode_biases(torch.tensor(np.asarray(enc_mask)), 7)
    for (jk, jv), (k, v) in zip(j_caches, caches):
        assert k.shape == jk.shape and not k.any() and not v.any()
    for (jk, jv), (k, v) in zip(j_cross, cross):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(rel.numpy(), np.asarray(j_rel))
    np.testing.assert_array_equal(bias.numpy(), np.asarray(j_bias))


def test_params_from_jax_covers_every_parameter():
    """The converted tree loads strictly, in the port's parameter names."""
    cfg = dict(TINY, tie_word_embeddings=False, multiquery_cross_attention=True)
    ids, mask, labels = _batch()
    params = JaxFiDT5(JaxT5Config(**cfg)).init(jax.random.PRNGKey(0), ids, mask,
                                               labels)["params"]
    sd = params_from_jax(params)
    model = FiDT5(T5Config(**cfg))
    model.load_state_dict(sd, strict=True)
    assert "t5.encoder.block_1.self_attn.q.weight" in sd
    assert tuple(sd["t5.lm_head.weight"].shape) == (64, 32)
    w = np.asarray(params["t5"]["decoder"]["block_0"]["cross_attn"]["k"]["kernel"])
    np.testing.assert_array_equal(sd["t5.decoder.block_0.cross_attn.k.weight"].numpy(), w.T)


def test_init_fid_t5_distributions():
    """init_fid_t5 draws the flax init stds (layers.py _dense, relpos,
    shared), seeded by the generator."""
    cfg = T5Config(**dict(TINY, d_model=64, d_kv=16, d_ff=256, vocab_size=512))
    a = init_fid_t5(cfg, torch.Generator().manual_seed(3)).state_dict()
    b = init_fid_t5(cfg, torch.Generator().manual_seed(3)).state_dict()
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    inner = cfg.num_heads * cfg.d_kv
    want = {
        "t5.shared.weight": 1.0,
        "t5.encoder.relpos.rel_embedding.weight": cfg.d_model ** -0.5,
        "t5.encoder.block_0.self_attn.q.weight": (cfg.d_model * cfg.d_kv) ** -0.5,
        "t5.encoder.block_0.self_attn.k.weight": cfg.d_model ** -0.5,
        "t5.decoder.block_1.cross_attn.o.weight": inner ** -0.5,
        "t5.decoder.block_0.mlp.wi.weight": cfg.d_model ** -0.5,
        "t5.encoder.block_1.mlp.wo.weight": cfg.d_ff ** -0.5,
    }
    for key, std in want.items():
        assert abs(float(a[key].std()) / std - 1) < 0.1, key
    assert bool((a["t5.decoder.final_ln.weight"] == 1).all())


def test_dropout_in_training_mode_raises():
    """A training forward with dropout needs its (seed, step) key first;
    with it the model runs and the loss differs from eval mode's."""
    model = init_fid_t5(T5Config(**dict(TINY, dropout_rate=0.1)),
                        torch.Generator().manual_seed(0)).train()
    ids, mask, labels = (torch.from_numpy(a) for a in _batch())
    with pytest.raises(RuntimeError, match="set_dropout_key"):
        model(ids, mask, labels)
    set_dropout_key(model, seed=0, step=0)
    train_loss = model(ids, mask, labels)[0]
    with torch.no_grad():
        eval_loss = model.eval()(ids, mask, labels)[0]
    train_loss = train_loss.detach()
    assert torch.isfinite(train_loss) and float(train_loss) != float(eval_loss)


def _same_weights(cfg_a, cfg_b, **kw):
    a, b = FiDT5(cfg_a, **kw), FiDT5(cfg_b, **kw)
    init = init_fid_t5(cfg_a, torch.Generator().manual_seed(4)).state_dict()
    a.load_state_dict(init)
    b.load_state_dict(init)
    return a, b


@pytest.mark.parametrize("flash", [False, True])
def test_dropout_eval_equals_rate_zero(flash):
    kw = dict(TINY, use_flash_attention=flash, flash_min_length=16)
    a, b = _same_weights(T5Config(**dict(kw, dropout_rate=0.3)), T5Config(**kw))
    t = [torch.from_numpy(x) for x in _batch()]
    with torch.no_grad():
        la, lb = a.eval()(*t)[1], b.eval()(*t)[1]
    torch.testing.assert_close(la, lb, rtol=0, atol=0)


def test_dropout_keep_fraction_and_scale():
    """About 1 - rate of the elements survive, scaled by 1/(1 - rate); the
    mask is a function of (seed, step, site) alone."""
    drop = Dropout(0.25).train()
    drop.key = (7, 3)
    x = torch.ones(400, 500)
    y = drop(x)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert torch.equal(drop(x), y)
    other = Dropout(0.25).train()
    for key, site in [((7, 4), 0), ((8, 3), 0), ((7, 3), 1)]:
        other.key, other.site = key, site
        assert not torch.equal(other(x), y), (key, site)
    assert torch.equal(drop.eval()(x), x)


@pytest.mark.parametrize("flash", [False, True])
def test_dropout_masks_survive_remat(flash):
    """Same seed and step: use_remat True and False give identical
    gradients (the checkpoint recompute redraws the same masks). With flash
    on, training with dropout takes the plain attention path, as in JAX."""
    kw = dict(TINY, dropout_rate=0.2, use_flash_attention=flash, flash_min_length=16)
    cfg = T5Config(**kw)
    a = FiDT5(cfg, use_remat=True)
    b = FiDT5(cfg, use_remat=False)
    init = init_fid_t5(cfg, torch.Generator().manual_seed(5)).state_dict()
    a.load_state_dict(init)
    b.load_state_dict(init)
    t = [torch.from_numpy(x) for x in _batch()]
    grads = []
    for model in (a, b):
        model.train()
        set_dropout_key(model, seed=11, step=2)
        loss = model(*t)[0]
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for ga, gb in zip(*grads):
        torch.testing.assert_close(ga, gb, rtol=0, atol=0)
    set_dropout_key(b, seed=11, step=3)
    other = torch.autograd.grad(b(*t)[0], list(b.parameters()))
    assert any(not torch.equal(x, y) for x, y in zip(other, grads[1]))


def test_dropout_sites_match_jax():
    """Dropout applications per layer in one training forward: 4 per encoder
    block, 6 per decoder block, 2 per stack outside the blocks, as in the
    JAX model (counted through flax's method interceptor)."""
    ids, mask, labels = _batch()
    jm = JaxFiDT5(JaxT5Config(**dict(TINY, dropout_rate=0.1)))
    params = jm.init(jax.random.PRNGKey(0), ids, mask, labels)["params"]
    want = collections.Counter()

    def count(next_fun, args, kwargs, context):
        if (isinstance(context.module, flax_nn.Dropout) and context.method_name == "__call__"
                and kwargs.get("deterministic") is False):
            path = context.module.path
            want[(path[1], next((p for p in path if p.startswith("block_")), None))] += 1
        return next_fun(*args, **kwargs)

    with flax_nn.intercept_methods(count):
        jm.apply({"params": params}, ids, mask, labels, deterministic=False,
                 rngs={"dropout": jax.random.PRNGKey(1)})

    model = FiDT5(T5Config(**dict(TINY, dropout_rate=0.1))).train()
    set_dropout_key(model, seed=0, step=0)
    got = collections.Counter()
    for name, module in model.named_modules():
        if isinstance(module, Dropout):
            parts = name.split(".")
            key = (parts[1], next((p for p in parts if p.startswith("block_")), None))
            module.register_forward_hook(lambda *a, key=key: got.update([key]))
    model(*(torch.from_numpy(a) for a in (ids, mask, labels)))
    assert got == want and want[("encoder", "block_0")] == 4
    assert len({m.site for m in model.modules() if isinstance(m, Dropout)}) == sum(got.values())


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("flash", [False, True])
def test_remat_policies(flash):
    """use_remat under remat_policy None, "full" and "dots" gives the
    gradients of no remat; "full" recomputes the encoder's dense matmuls in
    the backward and "dots" keeps them (JAX's
    dots_with_no_batch_dims_saveable); an unknown policy raises."""
    cfg = T5Config(**dict(TINY, use_flash_attention=flash, flash_min_length=16))
    init = init_fid_t5(cfg, torch.Generator().manual_seed(6)).state_dict()
    t = [torch.from_numpy(x) for x in _batch()]
    grads, matmuls = {}, {}
    for remat, policy in [(False, None), (True, None), (True, "full"), (True, "dots")]:
        model = FiDT5(cfg, use_remat=remat, remat_policy=policy)
        model.load_state_dict(init)
        loss = model.train()(*t)[0]
        with _CountMatmuls() as counter:
            grads[remat, policy] = torch.autograd.grad(loss, list(model.parameters()))
        matmuls[remat, policy] = counter.count
    for key, g in grads.items():
        for a, b in zip(g, grads[False, None]):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(key))
    # "full" recomputes the blocks' dense layers (q, k, v, o, wi; the
    # checkpoint stops before wo, whose output the backward does not need)
    assert matmuls[True, "full"] >= matmuls[False, None] + 4 * cfg.num_layers
    assert matmuls[True, None] == matmuls[True, "full"]
    assert matmuls[True, "dots"] == matmuls[False, None]
    with pytest.raises(ValueError, match="remat policy"):
        FiDT5(cfg, use_remat=True, remat_policy="bogus")


def _count_fused(monkeypatch):
    """Count the encoder's calls of K4's wrapper."""
    from lako_tpu_torch.models.t5 import layers

    calls = []
    real = layers.fused_attention
    monkeypatch.setattr(layers, "fused_attention", lambda *a: calls.append(1) or real(*a))
    return calls


@pytest.mark.parametrize("ff", ["relu", "gated-gelu"])
def test_fid_t5_fused_route_matches_jax(monkeypatch, ff):
    """use_flash_attention at the default flash_min_length 512 > L: each
    encoder block of the port takes K4's wrapper (its plain version on the
    CPU), the JAX model plain attention off the TPU. Encoder output, loss,
    logits and cross logits within 1e-4."""
    kw = dict(TINY, feed_forward_proj=ff, use_flash_attention=True)
    assert T5Config(**kw).flash_min_length == 512
    ids, mask, labels = _batch()
    jm = JaxFiDT5(JaxT5Config(**kw))
    params = jm.init(jax.random.PRNGKey(1), ids, mask, labels)["params"]
    j_loss, j_logits, j_xl = jm.apply({"params": params}, ids, mask, labels,
                                      collect_cross_logits=True)
    j_enc, _ = jm.apply({"params": params}, ids, mask, method=JaxFiDT5.encode_passages)

    calls = _count_fused(monkeypatch)
    model = FiDT5(T5Config(**kw))
    model.load_state_dict(params_from_jax(params))
    model.eval()
    t = [torch.from_numpy(a) for a in (ids, mask, labels)]
    with torch.inference_mode():
        loss, logits, xl = model(*t, collect_cross_logits=True)
        enc, _ = model.encode_passages(t[0], t[1])
    assert len(calls) == 2 * TINY["num_layers"]
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(enc.numpy(), np.asarray(j_enc), **tol)
    np.testing.assert_allclose(float(loss), float(j_loss), **tol)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **tol)
    np.testing.assert_allclose(xl.numpy(), np.asarray(j_xl), **tol)


def test_fused_route_remat_and_dropout(monkeypatch):
    """On the whole-block route the gradients under remat None, "full" and
    "dots" equal those without remat, K4's wrapper runs twice a layer under
    remat (forward and recompute) and once without; training with dropout
    takes plain attention instead, as in the JAX package."""
    calls = _count_fused(monkeypatch)
    cfg = T5Config(**dict(TINY, use_flash_attention=True))
    init = init_fid_t5(cfg, torch.Generator().manual_seed(6)).state_dict()
    t = [torch.from_numpy(x) for x in _batch()]
    grads = {}
    for remat, policy in [(False, None), (True, None), (True, "full"), (True, "dots")]:
        model = FiDT5(cfg, use_remat=remat, remat_policy=policy)
        model.load_state_dict(init)
        calls.clear()
        loss = model.train()(*t)[0]
        grads[remat, policy] = torch.autograd.grad(loss, list(model.parameters()))
        assert len(calls) == (2 if remat else 1) * cfg.num_layers, (remat, policy)
    for key, g in grads.items():
        for a, b in zip(g, grads[False, None]):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(key))
    dropout = FiDT5(T5Config(**dict(TINY, use_flash_attention=True, dropout_rate=0.1)))
    set_dropout_key(dropout.train(), seed=0, step=0)
    calls.clear()
    dropout(*t)
    assert not calls
