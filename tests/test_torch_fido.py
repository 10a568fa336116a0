"""FiDO decoders (arXiv 2212.08153: layer-sparse and multi-query
cross-attention) on the port's greedy DecodeEngine, at a tiny size in
float32 on the CPU: the engine against the layer-unrolled path and against
the benchmark's plain reference (benchmark/reference/fido_t5.py), the
service and the score route taking the engine, the beam routes still
refusing, the engine's counters; and T5 v1.1's ``gelu_new`` from an HF
config."""

import types

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import fido_t5
from benchmark.tap import LogitTap
from lako_tpu_torch.core import profiling
from lako_tpu_torch.core.config import AttentionSignalConfig, ReaderDataConfig, T5Config
from lako_tpu_torch.data import ReaderCollator, ReaderDataset
from lako_tpu_torch.models.t5 import FiDT5, decode
from lako_tpu_torch.models.t5.beam_engine import BeamEngine
from lako_tpu_torch.models.t5.convert import t5_config_from_hf
from lako_tpu_torch.models.t5.engine import DecodeEngine
from lako_tpu_torch.serve import LakoService, ServiceConfig
from tests.fixtures import make_examples, make_tokenizer

BACKBONES = {"relu-tied": dict(feed_forward_proj="relu", tie_word_embeddings=True),
             "gated-gelu-untied": dict(feed_forward_proj="gated-gelu",
                                       tie_word_embeddings=False)}
CASES = [(stride, mq, backbone) for stride in (2, 3) for mq in (True, False)
         for backbone in BACKBONES]
IDS = [f"stride{s}-{'mq' if m else 'mh'}-{b}" for s, m, b in CASES]

# Float32 on the CPU: the engine and the reference compute the same sums in
# other orders (stacked einsums against per-layer matmuls, fused q/k/v
# columns), so they agree to float32 rounding carried through 6 decoder
# layers: 0.9e-6 to 2.4e-6 of a logit's spread here; the bound leaves 40x.
LOGIT_TOL = 1e-4


def _config(stride, mq, backbone, vocab=64) -> dict:
    return dict(vocab_size=vocab, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                num_decoder_layers=6, num_heads=4, relative_attention_num_buckets=8,
                relative_attention_max_distance=16, dropout_rate=0.0,
                layer_norm_epsilon=1e-6, pad_token_id=0, eos_token_id=1,
                decoder_start_token_id=0, cross_attention_stride=stride,
                multiquery_cross_attention=mq, embedding_std=0.02, **BACKBONES[backbone])


def _model(cfg: dict, seed=2):
    port = T5Config(**{k: v for k, v in cfg.items() if k != "embedding_std"})
    state = weights.make_state(fido_t5.param_schema(cfg), seed, 1, "cpu")
    model = FiDT5(port)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    return model.eval(), state


def _batch(seed=0, B=3, N=2, L=10, vocab=64):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(3, vocab, size=(B, N, L)))
    mask = torch.from_numpy(rng.random((B, N, L)) < 0.85)
    mask[..., 0] = True
    return ids, mask


@pytest.mark.parametrize("stride,mq,backbone", CASES, ids=IDS)
def test_engine_equals_layer_unrolled(stride, mq, backbone):
    """Greedy tokens equal; step-0 cross logits (B, cross layers, h, N·L),
    in layer order, within LOGIT_TOL of the unrolled capture."""
    cfg = _config(stride, mq, backbone)
    model, _ = _model(cfg)
    ids, mask = _batch()
    n_cross = len(fido_t5.cross_layers(cfg))
    assert n_cross == -(-6 // stride)
    want_tok, want_xl = decode.greedy_generate(model, ids, mask, max_length=10,
                                               collect_cross_scores=True)
    tok, xl = DecodeEngine(model, max_length=10, collect_cross_scores=True).generate(ids, mask)
    assert len(np.unique(tok.numpy())) > 2
    np.testing.assert_array_equal(tok.numpy(), want_tok.numpy())
    assert xl.shape == want_xl.shape == (3, n_cross, 4, 20)
    np.testing.assert_allclose(xl.numpy(), want_xl.numpy(), rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("stride,mq,backbone", CASES, ids=IDS)
def test_engine_logits_match_reference(stride, mq, backbone):
    """Every step's logits of the engine against the reference's,
    teacher-forced on the engine's tokens: the largest gap within LOGIT_TOL
    of the position's logit standard deviation."""
    cfg = _config(stride, mq, backbone)
    model, state = _model(cfg)
    ids, mask = _batch(seed=1)
    tap = LogitTap().install()
    try:
        engine = DecodeEngine(model, max_length=10)
        tok, _ = engine.generate(ids, mask)
        got = tap.rows(range(ids.shape[0])).double()          # (B, steps, V)
    finally:
        tap.remove()
    fido_t5.no_tf32()
    dec_in = torch.cat([torch.zeros_like(tok[:, :1]), tok[:, :-1]], dim=1).long()
    with torch.no_grad():
        want = fido_t5.FidoReference(cfg, state).logits(ids, mask, dec_in).double()
    gap = ((got - want).abs().amax(-1) / want.std(-1)).max().item()
    assert gap < LOGIT_TOL, gap


@pytest.mark.parametrize("kw", [dict(kv_dtype="int8"), dict(weights_dtype="int8"),
                                dict(kv_dtype="int8mxu")],
                         ids=["int8-kv", "int8-weights", "int8mxu"])
@pytest.mark.parametrize("mq", [True, False], ids=["mq", "mh"])
def test_engine_modes_run_fido(kw, mq):
    """The engine's other modes under FiDO: the same cross-logit shape, step-0
    cross logits within int8's rounding of native K/V's, and most greedy
    tokens the same."""
    cfg = _config(3, mq, "gated-gelu-untied")
    model, _ = _model(cfg)
    ids, mask = _batch(seed=2)
    base_tok, base_xl = DecodeEngine(model, max_length=10,
                                     collect_cross_scores=True).generate(ids, mask)
    tok, xl = DecodeEngine(model, max_length=10, collect_cross_scores=True,
                           **kw).generate(ids, mask)
    assert xl.shape == base_xl.shape == (3, 2, 4, 20)
    tol = 0.05 * base_xl.abs().max().item()
    np.testing.assert_allclose(xl.numpy(), base_xl.numpy(), rtol=0, atol=tol)
    assert (tok == base_tok).float().mean() >= 0.7


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("mq", [True, False], ids=["mq", "mh"])
def test_engine_counts_its_cross_kv(kv_dtype, mq):
    """``engine.cross_kv_bytes`` counts the bytes of cross K/V the batch's
    buffers hold and ``engine.cross_layers`` the layers that cross-attend,
    once a generate call."""
    cfg = _config(3, mq, "relu-tied")
    model, _ = _model(cfg)
    ids, mask = _batch()
    engine = DecodeEngine(model, max_length=6, kv_dtype=kv_dtype)
    t0 = profiling.now()
    engine.generate(ids, mask)
    engine.generate(ids, mask)
    counts = [(k, n) for t, k, n in profiling.snapshot()["counts"] if t >= t0]
    hk = 1 if mq else 4
    elements = 2 * 3 * hk * 8 * 20                       # n_cross 2, B 3, d 8, K 20
    per_batch = (2 * elements * 4 if kv_dtype == "native"
                 else 2 * (elements + 2 * 3 * hk * 8 * 4))   # int8 values, f32 scales
    assert [n for k, n in counts if k == "engine.cross_kv_bytes"] == [per_batch] * 2
    assert [n for k, n in counts if k == "engine.cross_layers"] == [2, 2]


@pytest.mark.parametrize("backend", ["auto", "engine"])
def test_best_generate_fn_takes_the_engine_for_fido(backend):
    """Greedy FiDO decode routes to the engine; the layer-unrolled path under
    "flax" gives the same tokens."""
    model, _ = _model(_config(2, True, "gated-gelu-untied"))
    ids, mask = _batch()
    fn = decode.make_best_generate_fn(model, max_length=8, backend=backend)
    assert isinstance(fn.__self__, DecodeEngine)
    flax = decode.make_best_generate_fn(model, max_length=8, backend="flax")
    assert not isinstance(getattr(flax, "__self__", None), DecodeEngine)
    np.testing.assert_array_equal(fn(ids, mask)[0].numpy(), flax(ids, mask)[0].numpy())


def test_beam_routes_still_refuse_fido():
    """Beam search with FiDO: the beam engine refuses, "engine" raises, and
    "auto" takes the layer-unrolled beam path; the greedy engine's
    remaining refusals name only what they refuse."""
    model, _ = _model(_config(2, False, "relu-tied"))
    ids, mask = _batch()
    with pytest.raises(ValueError, match="homogeneous"):
        BeamEngine(model, num_beams=2)
    with pytest.raises(ValueError, match="beam engine does not support"):
        decode.make_best_generate_fn(model, num_beams=2, backend="engine")
    tokens, xl = decode.make_best_generate_fn(model, max_length=6, num_beams=2)(ids, mask)
    assert tokens.shape == (3, 5) and xl is None
    for kw in (dict(keep_tokens=5), dict(early_exit=True)):
        with pytest.raises(ValueError) as err:
            decode.make_best_generate_fn(model, backend="engine", **kw)
        assert "FiDO" not in str(err.value) and "keep_tokens / early_exit" in str(err.value)


def test_service_builds_a_decode_engine_for_fido():
    """LakoService with a FiDO reader decodes through DecodeEngine under
    "auto" and "engine" (so it takes the chunked early-exit route), with
    the answers of the layer-unrolled service."""
    tok = make_tokenizer()
    cfg = _config(3, True, "gated-gelu-untied", vocab=tok.vocab_size)
    _, state = _model(cfg)
    t5 = T5Config(**{k: v for k, v in cfg.items() if k != "embedding_std"})
    data = ReaderDataConfig(n_context=3, text_maxlength=24)
    requests = make_examples(5, n_facts=3, seed=3)
    answers = {}
    for backend in ("auto", "engine", "flax"):
        svc = LakoService(ServiceConfig(batch_size=4, max_length=6, n_context=3, data=data,
                                        dtype="float32", decode_backend=backend),
                          t5, state, tok, device="cpu")
        assert svc._takes_chunked == (backend != "flax")
        answers[backend] = svc.generate_tokens(requests)[1]
    np.testing.assert_array_equal(answers["auto"], answers["flax"])
    np.testing.assert_array_equal(answers["engine"], answers["flax"])


def test_generate_and_score_takes_the_engine_for_fido():
    """make_generate_and_score_fn on a FiDO reader: the engine's (B,
    n_context) fact scores from its (B, cross layers, h, K) capture equal
    the layer-unrolled route's within LOGIT_TOL, tokens equal."""
    tok = make_tokenizer()
    dcfg = ReaderDataConfig(n_context=3, text_maxlength=24, answer_maxlength=4, stream=2)
    ds = ReaderDataset(make_examples(4, 3, 11), dcfg)
    batch = ReaderCollator(dcfg, tok)([ds[i] for i in range(4)])
    cfg = _config(2, True, "gated-gelu-untied", vocab=tok.vocab_size)
    model, _ = _model(cfg)
    arrays = [torch.from_numpy(a) for a in (batch.passage_ids, batch.passage_mask,
                                            batch.fact_spans)]
    out, engine_calls = {}, {}
    for backend in ("auto", "flax"):
        fn = decode.make_generate_and_score_fn(model, AttentionSignalConfig(), max_length=4,
                                               backend=backend)
        t0 = profiling.now()
        out[backend] = fn(*arrays)
        engine_calls[backend] = sum(1 for t, k, _ in profiling.snapshot()["counts"]
                                    if t >= t0 and k == "engine.cross_layers")
    assert engine_calls == {"auto": 1, "flax": 0}
    assert out["auto"][1].shape == (4, 3)
    np.testing.assert_array_equal(out["auto"][0].numpy(), out["flax"][0].numpy())
    np.testing.assert_allclose(out["auto"][1].numpy(), out["flax"][1].numpy(),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_t5_v1_1_config_from_hf_runs_gelu_new():
    """An HF T5 v1.1 config (``gated-gelu``, ``dense_act_fn`` ``gelu_new``)
    builds a FiDT5 whose forward equals the port's ``gated-gelu`` (both the
    tanh GELU) on the same weights."""
    hf = types.SimpleNamespace(
        vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_decoder_layers=2,
        num_heads=4, relative_attention_num_buckets=8, relative_attention_max_distance=16,
        dropout_rate=0.0, layer_norm_epsilon=1e-6, feed_forward_proj="gated-gelu",
        dense_act_fn="gelu_new", tie_word_embeddings=False, pad_token_id=0, eos_token_id=1,
        decoder_start_token_id=0)
    cfg = t5_config_from_hf(hf)
    assert cfg.feed_forward_proj == "gated-gelu_new"
    v11 = FiDT5(cfg).eval()
    ref = dict(vars(hf), feed_forward_proj="gated-gelu", embedding_std=0.02)
    del ref["dense_act_fn"]
    plain, state = _model(ref)
    v11.load_state_dict(state)
    ids, mask = _batch()
    labels = torch.from_numpy(np.random.default_rng(0).integers(3, 64, size=(3, 5)))
    with torch.no_grad():
        loss, logits, _ = v11(ids, mask, labels)
        want_loss, want_logits, _ = plain(ids, mask, labels)
    assert torch.isfinite(loss)
    assert torch.equal(logits, want_logits) and torch.equal(loss, want_loss)
    tokens, _ = DecodeEngine(v11, max_length=6).generate(ids, mask)
    np.testing.assert_array_equal(tokens.numpy(),
                                  DecodeEngine(plain, max_length=6).generate(ids, mask)[0].numpy())
