"""The port's greedy DecodeEngine vs the JAX package's (f32, CPU).

Both engines get the same weights (``params_from_jax``) and the same numpy
batch. With int8 K/V and ``fused_cross`` the JAX engine runs its Pallas
kernel in interpret mode and the port runs the plain version of its kernel.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lako_tpu.core.config import T5Config as JaxT5Config
from lako_tpu.models.t5.engine import DecodeEngine as JaxDecodeEngine
from lako_tpu.models.t5.model import FiDT5 as JaxFiDT5
from lako_tpu_torch.core.config import T5Config
from lako_tpu_torch.models.t5 import FiDT5, params_from_jax
from lako_tpu_torch.models.t5.decode import make_best_generate_fn
from lako_tpu_torch.models.t5.engine import DecodeEngine


def _make(extra=None, seed=0, B=3, N=2, L=10):
    kw = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2,
              num_decoder_layers=3, num_heads=4, relative_attention_num_buckets=8,
              dropout_rate=0.0, **(extra or {}))
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 64, size=(B, N, L)).astype(np.int32)
    mask = rng.random((B, N, L)) < 0.9
    mask[..., 0] = True
    jm = JaxFiDT5(JaxT5Config(**kw), dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(seed), ids, mask,
                     np.zeros((B, 4), np.int32))["params"]
    # At unit std the random tied embedding keeps the start token dominant and
    # every greedy token repeats one id; scaled down, tokens vary with the input.
    params["t5"]["shared"]["embedding"] = params["t5"]["shared"]["embedding"] * 0.02
    model = FiDT5(T5Config(**kw))
    model.load_state_dict(params_from_jax(params))
    model.eval()
    return jm, params, model, ids, mask


def _run_port(model, ids, mask, **kw):
    tokens, xl = DecodeEngine(model, **kw).generate(torch.from_numpy(ids),
                                                    torch.from_numpy(mask))
    return tokens.numpy(), None if xl is None else xl.numpy()


@pytest.mark.parametrize("extra", [None, {"multiquery_cross_attention": True},
                                   {"feed_forward_proj": "gated-gelu"},
                                   {"tie_word_embeddings": False}])
def test_native_kv_tokens_identical(extra):
    """Native K/V: identical greedy tokens, and step-0 cross logits within 1e-4."""
    jm, params, model, ids, mask = _make(extra, seed=3)
    j_tok, j_xl = JaxDecodeEngine(jm, max_length=8, collect_cross_scores=True
                                  ).generate(params, ids, mask)
    tok, xl = _run_port(model, ids, mask, max_length=8, collect_cross_scores=True)
    assert len(np.unique(tok)) > 1
    np.testing.assert_array_equal(tok, np.asarray(j_tok))
    np.testing.assert_allclose(xl, np.asarray(j_xl), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fused,extra", [(False, None), (True, None),
                                         (False, {"multiquery_cross_attention": True})])
def test_int8_kv_matches_jax(monkeypatch, fused, extra):
    """int8 K/V, fused_cross off and on (the JAX kernel interprets): step-0
    cross logits within 1e-4 and tokens agreeing on >= 0.9 of positions."""
    monkeypatch.setenv("LAKO_FLASH_INTERPRET", "1")
    jm, params, model, ids, mask = _make(extra, seed=9)
    kw = dict(max_length=8, kv_dtype="int8", fused_cross=fused, collect_cross_scores=True)
    j_tok, j_xl = JaxDecodeEngine(jm, **kw).generate(params, ids, mask)
    tok, xl = _run_port(model, ids, mask, **kw)
    np.testing.assert_allclose(xl, np.asarray(j_xl), rtol=1e-4, atol=1e-4)
    assert (tok == np.asarray(j_tok)).mean() >= 0.9


def test_unported_options_raise():
    _, _, model, ids, mask = _make()
    with pytest.raises(NotImplementedError, match="int8mxu"):
        DecodeEngine(model, kv_dtype="int8mxu")
    with pytest.raises(NotImplementedError, match="int8 weights"):
        DecodeEngine(model, weights_dtype="int8")
    with pytest.raises(NotImplementedError, match="chunk"):
        DecodeEngine(model, max_length=8, chunk_size=2)
    DecodeEngine(model, max_length=8, chunk_size=7)    # one chunk = unchunked
    with pytest.raises(NotImplementedError, match="ROADMAP item 3"):
        make_best_generate_fn(model, backend="flax")
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        make_best_generate_fn(model, num_beams=4)
    with pytest.raises(ValueError, match="greedy"):
        make_best_generate_fn(model, num_beams=4, collect_cross_scores=True)
    fn = make_best_generate_fn(model, max_length=5, kv_dtype="int8", fused_cross=True)
    tokens, xl = fn(torch.from_numpy(ids), torch.from_numpy(mask))
    assert tokens.shape == (3, 4) and tokens.dtype == torch.int32 and xl is None
