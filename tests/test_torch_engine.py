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


def _eos_like(params, model, like):
    """Make EOS the argmax wherever token ``like`` was a positive one (its
    embedding row 1.05x ``like``'s), so that rows finish at different steps."""
    emb = params["t5"]["shared"]["embedding"]
    params["t5"]["shared"]["embedding"] = emb.at[1].set(emb[like] * 1.05)
    model.load_state_dict(params_from_jax(params))


@pytest.mark.parametrize("chunk_size", [1, 3])
def test_chunked_tokens_identical(chunk_size):
    """Chunked early exit: tokens identical to the port's unchunked engine and
    to the JAX chunked engine (max_length=10); every row emits EOS by step 4,
    so the loop stops before its last chunk."""
    jm, params, model, ids, mask = _make(seed=5)
    _eos_like(params, model, 26)
    j_tok, _ = JaxDecodeEngine(jm, max_length=10, chunk_size=chunk_size
                               ).generate(params, ids, mask)
    full, _ = _run_port(model, ids, mask, max_length=10)
    eng = DecodeEngine(model, max_length=10, chunk_size=chunk_size)
    tok, _ = eng.generate(torch.from_numpy(ids), torch.from_numpy(mask))
    assert (np.asarray(j_tok) == 1).any(axis=1).all() and len(np.unique(j_tok)) > 2
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))
    np.testing.assert_array_equal(tok.numpy(), full)
    assert eng.last_chunks == {1: 4, 3: 2}[chunk_size]    # of 9 and 3 chunks
    tok2, _ = eng.generate(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_array_equal(tok2.numpy(), full)     # the buffers reload per batch
    # the same engine's full-length program: one chunk of the 8 later steps
    tok3, _ = eng.generate(torch.from_numpy(ids), torch.from_numpy(mask), chunked=False)
    np.testing.assert_array_equal(tok3.numpy(), full)
    assert eng.last_chunks == 1


def test_chunking_guard_normalizes_and_warns(monkeypatch, caplog):
    """chunk_size >= steps is the unchunked program; the worst-case overhead
    is the JAX engine's arithmetic on the port's constants, and a chunk size
    past 25% of it warns (forced here with a 50 ms dispatch: at the port's
    measured costs nothing reaches it)."""
    import logging

    from lako_tpu_torch.models.t5 import engine

    _, _, model, _, _ = _make()
    assert DecodeEngine(model, max_length=10, chunk_size=64).chunk_size is None
    assert engine.chunking_worst_case_overhead(49, 49) == 0.0
    assert engine.chunking_worst_case_overhead(49, 1) == pytest.approx(
        48 * engine.CHUNK_DISPATCH_COST_S / (49 * engine.CHUNK_PER_STEP_COST_S))
    assert engine.chunking_worst_case_overhead(49, 1) < 0.25
    with caplog.at_level(logging.WARNING):
        DecodeEngine(model, max_length=50, chunk_size=4)
    assert "worst-case" not in caplog.text
    monkeypatch.setattr(engine, "CHUNK_DISPATCH_COST_S", 0.05)
    with caplog.at_level(logging.WARNING):
        DecodeEngine(model, max_length=50, chunk_size=4)
    assert "worst-case" in caplog.text and "12 extra chunk dispatches" in caplog.text


@pytest.mark.parametrize("kw", [dict(weights_dtype="int8"), dict(kv_dtype="int8mxu"),
                                dict(weights_dtype="int8", kv_dtype="int8mxu")])
def test_int8_modes_match_jax(kw):
    """int8 weights and int8mxu: step-0 cross logits within 1e-4 of the JAX
    engine's at the same setting, tokens agreeing on >= 0.9 of positions."""
    jm, params, model, ids, mask = _make(seed=7)
    j_tok, j_xl = JaxDecodeEngine(jm, max_length=8, collect_cross_scores=True, **kw
                                  ).generate(params, ids, mask)
    tok, xl = _run_port(model, ids, mask, max_length=8, collect_cross_scores=True, **kw)
    np.testing.assert_allclose(xl, np.asarray(j_xl), rtol=1e-4, atol=1e-4)
    assert (tok == np.asarray(j_tok)).mean() >= 0.9


@pytest.mark.parametrize("kw,err,agree", [(dict(weights_dtype="int8"), 0.1, 0.85),
                                          (dict(kv_dtype="int8"), 0.05, 0.9),
                                          (dict(kv_dtype="int8mxu"), 0.05, 0.9)])
def test_int8_modes_within_native_bounds(kw, err, agree):
    """The JAX package's own bounds against the native engine
    (tests/test_engine.py): int8 weights 0.1 x the logits' scale and >= 0.85
    of the tokens, int8 K/V 0.05 x and >= 0.9."""
    _, _, model, ids, mask = _make(seed=7)
    ref_tok, ref_xl = _run_port(model, ids, mask, max_length=8, collect_cross_scores=True)
    tok, xl = _run_port(model, ids, mask, max_length=8, collect_cross_scores=True, **kw)
    valid = mask.reshape(mask.shape[0], -1)[:, None, None, :]
    assert (np.abs(xl - ref_xl) * valid).max() <= err * np.abs(ref_xl * valid).max()
    assert (tok == ref_tok).mean() >= agree


def test_int8_quantization_bitwise_equal():
    """Codes and scales of the int8 weights (per output channel, the
    embedding per row, an untied lm_head) and of the int8 cross K/V are
    bitwise the JAX engine's: the same float32 amax, division and
    half-to-even rounding."""
    from lako_tpu.models.t5 import engine as jeng
    from lako_tpu_torch.models.t5 import engine as peng

    jm, params, model, ids, mask = _make({"tie_word_embeddings": False}, seed=4)
    jsd = jeng.stack_decoder_params(params, jm.config, jnp.float32, weights_dtype="int8")
    psd = peng.stack_decoder_params(model, torch.float32, weights_dtype="int8")
    for name in jsd._fields:
        want, got = getattr(jsd, name), getattr(psd, name)
        if want is None:
            assert got is None, name
            continue
        pairs = (zip(want, got) if isinstance(want, jeng._Quantized) else [(want, got)])
        for w, g in pairs:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    x = np.random.default_rng(0).normal(size=(2, 3, 4, 8, 300)).astype(np.float32) * 3
    for w, g in zip(jeng._quantize_kv(jnp.asarray(x)), peng._quantize_kv(torch.from_numpy(x))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_int8_contract_exact_past_1040_keys():
    """int8mxu's products are exact integers at any length: 2500 keys (past
    the 1040 terms an exact float32 sum holds) against an int64 product."""
    from lako_tpu_torch.models.t5.engine import _int8_contract

    gen = torch.Generator().manual_seed(0)
    p = torch.randint(-127, 128, (2, 3, 2500), generator=gen, dtype=torch.int8)
    v = torch.randint(-127, 128, (2, 3, 16, 2500), generator=gen, dtype=torch.int8)
    p[0, 0] = 127
    v[0, 0] = 127                                      # the largest sum there is
    got = _int8_contract("bhk,bhdk->bhd", p, v, 2, 3)
    want = torch.einsum("bhk,bhdk->bhd", p.long(), v.long())
    assert got.dtype == torch.int32 and int(want.abs().max()) > 2 ** 24
    torch.testing.assert_close(got.long(), want, rtol=0, atol=0)


def test_sd_cache_layout_tokens_identical():
    """self_cache_layout="sd": tokens identical to the JAX engine's and to
    the port's "ds" layout."""
    jm, params, model, ids, mask = _make(seed=3)
    j_tok, j_xl = JaxDecodeEngine(jm, max_length=8, self_cache_layout="sd",
                                  collect_cross_scores=True).generate(params, ids, mask)
    tok, xl = _run_port(model, ids, mask, max_length=8, self_cache_layout="sd",
                        collect_cross_scores=True)
    ds, _ = _run_port(model, ids, mask, max_length=8)
    np.testing.assert_array_equal(tok, np.asarray(j_tok))
    np.testing.assert_array_equal(tok, ds)
    np.testing.assert_allclose(xl, np.asarray(j_xl), rtol=1e-4, atol=1e-4)


def test_unported_options_raise():
    """What the port still refuses: make_generate_and_score_fn (ROADMAP item
    6), and the engine's invalid settings, as the JAX engine refuses them."""
    from lako_tpu_torch.models.t5.decode import make_generate_and_score_fn

    _, _, model, ids, mask = _make()
    with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
        make_generate_and_score_fn(model, None)
    with pytest.raises(ValueError, match="kv_dtype"):
        DecodeEngine(model, kv_dtype="int4")
    with pytest.raises(ValueError, match="weights_dtype"):
        DecodeEngine(model, weights_dtype="int4")
    with pytest.raises(ValueError, match="self_cache_layout"):
        DecodeEngine(model, self_cache_layout="dd")
    fido = FiDT5(T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=1,
                          num_decoder_layers=4, num_heads=4, cross_attention_stride=2))
    with pytest.raises(ValueError, match="homogeneous"):
        DecodeEngine(fido)
    assert DecodeEngine(model, max_length=8, chunk_size=7).chunk_size is None
    with pytest.raises(ValueError, match="greedy"):
        make_best_generate_fn(model, num_beams=4, collect_cross_scores=True)
    fn = make_best_generate_fn(model, max_length=5, kv_dtype="int8", fused_cross=True)
    tokens, xl = fn(torch.from_numpy(ids), torch.from_numpy(mask))
    assert tokens.shape == (3, 4) and tokens.dtype == torch.int32 and xl is None
