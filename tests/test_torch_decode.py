"""The port's layer-unrolled decode (greedy_generate, token elimination,
beam_generate) and the make_best_generate_fn dispatch vs the JAX package's
(f32, CPU, the same params_from_jax weights and numpy batches)."""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lako_tpu.models.t5 import beam as jax_beam
from lako_tpu.models.t5 import decode as jax_decode
from lako_tpu_torch.models.t5 import beam, decode, params_from_jax
from lako_tpu_torch.models.t5.beam_engine import BeamEngine
from lako_tpu_torch.models.t5.engine import DecodeEngine
from tests.test_torch_engine import _eos_like, _make


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _spread_salience(params, model, seed):
    """A random encoder final-norm scale: at the init's ones every encoder
    state has the same norm up to rounding, and token elimination's ranking
    would be decided by float rounding alone."""
    w = params["t5"]["encoder"]["final_ln"]["weight"]
    rng = np.random.default_rng(seed)
    params["t5"]["encoder"]["final_ln"]["weight"] = jnp.asarray(
        rng.uniform(0.5, 1.5, w.shape), jnp.float32)
    model.load_state_dict(params_from_jax(params))


@pytest.mark.parametrize("extra,kw", [
    (None, {}),
    ({"cross_attention_stride": 2}, {}),
    ({"cross_attention_stride": 2, "multiquery_cross_attention": True}, {}),
    (None, {"keep_tokens": 7}),
    (None, {"keep_tokens": 13, "duplicate": True}),
    (None, {"early_exit": True}),
], ids=["plain", "fido2", "fido2-multiquery", "keep7", "keep13-ties", "early-exit"])
def test_greedy_generate_matches_jax(extra, kw):
    """Tokens identical and step-0 cross logits within 1e-4 (no capture under
    token elimination). FiDO stride 2 keeps cross-attention in layers 0 and
    2 of 3. keep13-ties repeats passage 0 as passage 1: every kept state
    ties with its copy, and 13 of them split a pair, where the lower
    position wins."""
    kw = dict(kw)
    jm, params, model, ids, mask = _make(extra, seed=5)
    _eos_like(params, model, 26)
    if kw.pop("duplicate", False):
        ids[:, 1], mask[:, 1] = ids[:, 0], mask[:, 0]
    if "keep_tokens" in kw:
        _spread_salience(params, model, 5)
    collect = "keep_tokens" not in kw
    j_tok, j_xl = jax_decode.greedy_generate(jm, params, ids, mask, max_length=10,
                                             collect_cross_scores=collect, **kw)
    tok, xl = decode.greedy_generate(model, _t(ids), _t(mask), max_length=10,
                                     collect_cross_scores=collect, **kw)
    assert tok.dtype == torch.int32 and len(np.unique(j_tok)) > 2
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))
    if collect:
        np.testing.assert_allclose(xl.numpy(), np.asarray(j_xl), rtol=1e-4, atol=1e-4)
    else:
        assert xl is None and j_xl is None


def test_greedy_generate_equals_engine():
    """The layer-unrolled path and the stacked engine give the same tokens."""
    _, params, model, ids, mask = _make(seed=5)
    _eos_like(params, model, 26)
    tok, _ = decode.greedy_generate(model, _t(ids), _t(mask), max_length=10)
    eng, _ = DecodeEngine(model, max_length=10).generate(_t(ids), _t(mask))
    np.testing.assert_array_equal(tok.numpy(), eng.numpy())


def test_eliminate_tokens_ties_match_jax():
    """Indices identical to lax.top_k's on forced ties: integer states whose
    norms are exact (permuted entries tie), and masked positions (-inf) that
    fill the kept set once the valid ones run out."""
    rng = np.random.default_rng(0)
    base = rng.integers(-3, 4, size=(8,)).astype(np.float32)
    enc = np.stack([np.stack([rng.permutation(base) * (1 + (k % 3)) for k in range(12)])
                    for _ in range(3)]).astype(np.float32)        # (3, 12, 8)
    mask = rng.random((3, 12)) < 0.7
    mask[2, :] = False
    mask[2, 5] = True
    for keep in (4, 7, 11):
        j_kept, j_mask = jax_decode.eliminate_tokens(jnp.asarray(enc), jnp.asarray(mask), keep)
        kept, kmask = decode.eliminate_tokens(_t(enc), _t(mask), keep)
        np.testing.assert_array_equal(kept.numpy(), np.asarray(j_kept))
        np.testing.assert_array_equal(kmask.numpy(), np.asarray(j_mask))
    # the ranking itself: equal rows keep their order, lower index first
    _, idx = beam.top_k(torch.tensor([[1.0, 3.0, 3.0, float("-inf"), 3.0, float("-inf")]]), 5)
    assert idx.tolist() == [[1, 2, 4, 0, 3]]


@pytest.mark.parametrize("num_beams", [1, 2, 4])
@pytest.mark.parametrize("length_penalty", [0.5, 2.0])
def test_beam_generate_matches_jax(num_beams, length_penalty):
    """The layer-unrolled beam search: best sequences identical to the JAX
    beam_generate's, with EOS reachable so the finished pool fills."""
    jm, params, model, ids, mask = _make(seed=5)
    _eos_like(params, model, 26)
    want = jax_beam.beam_generate(jm, params, ids, mask, max_length=8,
                                  num_beams=num_beams, length_penalty=length_penalty)
    got = beam.beam_generate(model, _t(ids), _t(mask), max_length=8,
                             num_beams=num_beams, length_penalty=length_penalty)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_best_generate_fn_routes_like_jax(caplog):
    """make_best_generate_fn: the JAX dispatcher's routes, errors and
    warnings."""
    jm, params, model, ids, mask = _make(seed=5)
    fido = _make({"cross_attention_stride": 2}, seed=5)
    # FiDO under "auto" takes the layer-unrolled path (greedy and beam)
    j_tok, _ = jax_decode.make_best_generate_fn(fido[0], max_length=6)(fido[1], ids, mask)
    tok, _ = decode.make_best_generate_fn(fido[2], max_length=6)(_t(ids), _t(mask))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))
    j_tok, _ = jax_decode.make_best_generate_fn(fido[0], max_length=6, num_beams=2)(
        fido[1], ids, mask)
    tok, xl = decode.make_best_generate_fn(fido[2], max_length=6, num_beams=2)(
        _t(ids), _t(mask))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))
    assert xl is None
    # beam routes to the engine when the model allows
    fn = decode.make_best_generate_fn(model, max_length=6, num_beams=2, self_attn_impl="flat")
    np.testing.assert_array_equal(
        fn(_t(ids), _t(mask))[0].numpy(),
        BeamEngine(model, max_length=6, num_beams=2, self_attn_impl="flat").generate(
            _t(ids), _t(mask)).numpy())

    def errors(mod, m):
        out = []
        for kw in [dict(num_beams=2, collect_cross_scores=True),
                   dict(num_beams=2, keep_tokens=5),
                   dict(num_beams=2, kv_dtype="int8"),
                   dict(num_beams=2, weights_dtype="int8"),
                   dict(backend="engine", keep_tokens=5),
                   dict(backend="engine", early_exit=True)]:
            with pytest.raises(ValueError) as err:
                mod.make_best_generate_fn(m, **kw)
            out.append(str(err.value).split(";")[0])
        return out

    assert errors(decode, model) == errors(jax_decode, jm)
    for mod, m in ((decode, fido[2]), (jax_decode, fido[0])):
        with pytest.raises(ValueError, match="beam engine does not support"):
            mod.make_best_generate_fn(m, num_beams=2, backend="engine")
        with pytest.raises(ValueError, match="beam-engine knob"):
            mod.make_best_generate_fn(m, num_beams=2, self_attn_impl="gather")
    with caplog.at_level(logging.WARNING, logger="lako_tpu_torch"):
        decode.make_best_generate_fn(model, num_beams=2, chunk_size=4)
        decode.make_best_generate_fn(model, self_attn_impl="gather")
    assert "beam search ignores early_exit/chunk_size" in caplog.text
    assert "greedy decode ignores it" in caplog.text
