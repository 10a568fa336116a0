"""The port's FiD T5 vs the JAX package's, on shared weights (f32, CPU).

Weights come from a flax init and reach the port through ``params_from_jax``;
inputs are numpy arrays from a seed. With ``use_flash_attention`` the JAX side
runs its streamed Pallas kernel in interpret mode and the port runs the plain
version of its CUDA kernel.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lako_tpu.core.config import T5Config as JaxT5Config
from lako_tpu.models.t5.layers import relative_position_bucket as jax_bucket
from lako_tpu.models.t5.model import FiDT5 as JaxFiDT5
from lako_tpu_torch.core.config import T5Config
from lako_tpu_torch.models.t5 import FiDT5, init_fid_t5, params_from_jax
from lako_tpu_torch.models.t5.layers import relative_position_bucket

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
    model = FiDT5(T5Config(**dict(TINY, dropout_rate=0.1)))
    ids, mask, labels = (torch.from_numpy(a) for a in _batch())
    with pytest.raises(NotImplementedError, match="dropout"):
        model(ids, mask, labels)
