"""The port's ancestry-indexed BeamEngine and its blockwise selection vs the
JAX package's (f32, CPU, the same params_from_jax weights and numpy
batches)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lako_tpu.models.t5 import beam_engine as jax_be
from lako_tpu_torch.models.t5 import beam_engine
from tests.test_torch_engine import _eos_like, _make


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("select_impl", ["topk", "blockwise"])
@pytest.mark.parametrize("self_attn_impl", beam_engine.SELF_ATTN_IMPLS)
def test_beam_engine_matches_jax(self_attn_impl, select_impl):
    """Every self_attn_impl x select_impl: tokens identical to the JAX
    BeamEngine at the same setting (3 beams, EOS reachable, blockwise over
    4 blocks of 16 of the 64-token vocabulary)."""
    jm, params, model, ids, mask = _make(seed=5)
    _eos_like(params, model, 26)
    kw = dict(max_length=8, num_beams=3, self_attn_impl=self_attn_impl,
              select_impl=select_impl, select_block=16)
    want = jax_be.BeamEngine(jm, **kw).generate(params, ids, mask)
    eng = beam_engine.BeamEngine(model, **kw)
    assert eng.select_impl == select_impl
    got = eng.generate(_t(ids), _t(mask))
    assert (np.asarray(want) == 1).any() and len(np.unique(want)) > 2
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("extra", [{"multiquery_cross_attention": True},
                                   {"feed_forward_proj": "gated-gelu",
                                    "tie_word_embeddings": False}])
def test_beam_engine_variants_match_jax(extra):
    jm, params, model, ids, mask = _make(extra, seed=3)
    want = jax_be.BeamEngine(jm, max_length=8, num_beams=2, length_penalty=0.6
                             ).generate(params, ids, mask)
    got = beam_engine.BeamEngine(model, max_length=8, num_beams=2, length_penalty=0.6
                                 ).generate(_t(ids), _t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,block", [(6, 16), (8, 8)])
def test_blockwise_top_m_ties_match_jax(m, block):
    """Values and indices identical to the JAX function on forced ties: whole
    blocks of equal logits, the same logits in two beams, and a beam at the
    search's -1e7."""
    rng = np.random.default_rng(1)
    logits = rng.integers(-4, 3, size=(2, 3, 64)).astype(np.float32)
    logits[:, :, 16:32] = 2.0              # a block of ties
    logits[1, 2] = logits[1, 0]            # two beams alike
    scores = np.array([[0.0, -0.5, -1e7], [0.0, -0.25, 0.0]], np.float32)
    want = jax_be.blockwise_top_m(jnp.asarray(logits), jnp.asarray(scores), m, block=block)
    got = beam_engine.blockwise_top_m(_t(logits), _t(scores), m, block=block)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # and it is the full-width selection's answer
    cand = scores[:, :, None] + np.asarray(jax.nn.log_softmax(logits, axis=-1))
    _, full = jax.lax.top_k(jnp.asarray(cand.reshape(2, -1)), m)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(full))


def test_beam_engine_validation_matches_jax():
    """The same refusals as the JAX engine, with the same messages."""
    jm, _, model, _, _ = _make()
    fido = _make({"cross_attention_stride": 2})
    cases = [(jm, model, dict(num_beams=0)),
             (jm, model, dict(self_attn_impl="rows")),
             (jm, model, dict(select_impl="heap")),
             (jm, model, dict(select_impl="blockwise", select_block=10)),
             (jm, model, dict(select_impl="blockwise", select_block=64)),
             (fido[0], fido[2], {})]
    for j, p, kw in cases:
        with pytest.raises(ValueError) as want:
            jax_be.BeamEngine(j, **kw)
        with pytest.raises(ValueError) as got:
            beam_engine.BeamEngine(p, **kw)
        assert str(got.value).split(";")[0] == str(want.value).split(";")[0]
    assert beam_engine.BeamEngine(model, select_block=16).select_impl == "blockwise"
    assert beam_engine.BeamEngine(model).select_impl == "topk"      # 251 does not divide 64
