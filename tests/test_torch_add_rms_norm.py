"""K8's plain version and the decode engines on it (CPU, no JAX).

``add_rms_norm`` on CPU tensors is bitwise the chain the engines ran before
it (``x + delta``, then the RMS norm in eight operations); the greedy
engine's tokens and step-0 cross logits are bitwise those of that chain's
step, spelled out below, on homogeneous and FiDO decoders; every norm site
of a step goes through the op, ``engine.norm_sites`` a generate call; and
what the kernel does not take raises on the CPU too.
"""

import pytest
import torch

from lako_tpu_torch.core import profiling
from lako_tpu_torch.core.config import T5Config
from lako_tpu_torch.models.t5 import engine as engine_mod
from lako_tpu_torch.models.t5 import init_fid_t5
from lako_tpu_torch.models.t5.beam_engine import BeamEngine
from lako_tpu_torch.models.t5.engine import DecodeEngine, _layer, _mm
from lako_tpu_torch.ops import _build
from lako_tpu_torch.ops import add_rms_norm as k8
from lako_tpu_torch.ops.add_rms_norm import add_rms_norm


def _rms(x, weight, eps, dtype):
    """The engines' norm before K8 (engine.py ``_rms``)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * weight.to(dtype)


def _rows(B, H, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(B, H, generator=gen) * 3).to(dtype)


@pytest.mark.parametrize("weight_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_delta", [True, False], ids=["delta", "no-delta"])
@pytest.mark.parametrize("H", [1024, 2048])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_op_is_the_unfused_chain(dtype, H, with_delta, weight_dtype):
    x, delta = _rows(8, H, dtype, 0), _rows(8, H, dtype, 1) if with_delta else None
    weight = (1 + 0.3 * torch.randn(H, generator=torch.Generator().manual_seed(2))
              ).to(weight_dtype)
    x_new, xn = add_rms_norm(x, delta, weight, 1e-6)
    want_x = x + delta if with_delta else x
    assert x_new.dtype == xn.dtype == dtype
    assert torch.equal(x_new, want_x)
    assert with_delta or x_new is x
    assert torch.equal(xn, _rms(want_x, weight, 1e-6, dtype))


class _ParentStep(DecodeEngine):
    """The greedy engine's step as it ran before K8: each residual add on its
    own, then ``_rms`` at the next site."""

    def _one_step(self, tok, step, st, collect):
        cfg, sd, dtype = self.cfg, self.sd, self.dtype
        sk, sv = st.caches
        h, d = cfg.num_heads, cfg.d_kv
        eps = cfg.layer_norm_epsilon
        x = engine_mod._take_embedding(sd.embedding, tok, dtype)
        B = x.shape[0]
        self_bias = self.relpos_rows[step].clone()
        self_bias[:, step + 1:] = engine_mod.NEG_INF
        cross_logits = []
        for i in range(cfg.num_decoder_layers):
            xn = _rms(x, sd.ln_self[i], eps, dtype)
            qkv = _mm(xn, _layer(sd.wqkv_self, i), dtype).reshape(B, 3, h, d)
            q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]
            logits = torch.einsum("bhd,bhds->bhs", q, sk[i]).float()
            logits[..., step] = (q * k_new).sum(dim=-1).float()
            probs = torch.softmax(logits + self_bias, dim=-1).to(dtype)
            out = torch.einsum("bhs,bhds->bhd", probs, sv[i])
            sk[i, ..., step] = k_new
            sv[i, ..., step] = v_new
            out = out + probs[..., step:step + 1] * v_new
            x = x + _mm(out.reshape(B, h * d), _layer(sd.wo_self, i), dtype)
            j = self.cross_slot.get(i)
            if j is not None:
                xn = _rms(x, sd.ln_cross[j], eps, dtype)
                qc = _mm(xn, _layer(sd.wq_cross, j), dtype).reshape(B, h, d)
                co, cl = self._cross_attention(j, qc, st, collect)
                if collect:
                    cross_logits.append(cl)
                x = x + _mm(co.reshape(B, h * d), _layer(sd.wo_cross, j), dtype)
            xn = _rms(x, sd.ln_mlp[i], eps, dtype)
            x = x + engine_mod._mlp(sd, cfg, i, xn, dtype)
        x = _rms(x, sd.final_ln, eps, dtype)
        xl = torch.stack(cross_logits, dim=1) if collect else None
        return engine_mod._logits(sd, cfg, x, dtype), xl


DECODERS = {
    "t5": {},
    "fido-mq-gated": dict(cross_attention_stride=3, multiquery_cross_attention=True,
                          feed_forward_proj="gated-gelu", tie_word_embeddings=False),
    "fido-mh-relu": dict(cross_attention_stride=2),
}


def _decoder(extra, dtype=torch.float32, seed=0):
    """A tiny reader with random norm weights, 6 decoder layers, and a batch."""
    cfg = T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                   num_decoder_layers=6, num_heads=4, relative_attention_num_buckets=8,
                   dropout_rate=0.0, **extra)
    gen = torch.Generator().manual_seed(seed)
    model = init_fid_t5(cfg, gen, dtype)
    with torch.no_grad():   # scaled down so that the greedy tokens vary
        model.t5.shared.weight.mul_(0.02)
        for name, p in model.named_parameters():
            if "ln" in name.split(".")[-2]:
                p.copy_(1 + 0.3 * torch.randn(p.shape, generator=gen))
    ids = torch.randint(2, 64, (3, 2, 10), generator=gen)
    mask = torch.rand(3, 2, 10, generator=gen) < 0.85
    mask[..., 0] = True
    return model, ids, mask


@pytest.mark.parametrize("kw", [{}, dict(kv_dtype="int8", weights_dtype="int8")],
                         ids=["native", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decoder", list(DECODERS))
def test_engine_step_is_the_parent_step_bitwise(decoder, dtype, kw):
    """Tokens and step-0 cross logits of the engine on K8 equal, bitwise,
    those of the step with its residual adds and norms apart."""
    model, ids, mask = _decoder(DECODERS[decoder], dtype)
    assert any(float((p.detach().float() - 1).abs().max()) > 0.1
               for n, p in model.named_parameters()
               if n.endswith("ln_mlp.weight"))
    tok, xl = DecodeEngine(model, max_length=8, collect_cross_scores=True, **kw).generate(
        ids, mask)
    want_tok, want_xl = _ParentStep(model, max_length=8, collect_cross_scores=True,
                                    **kw).generate(ids, mask)
    assert len(torch.unique(tok)) > 1
    assert torch.equal(tok, want_tok)
    assert torch.equal(xl, want_xl)


@pytest.mark.parametrize("decoder,sites", [("t5", 19), ("fido-mq-gated", 15),
                                           ("fido-mh-relu", 16)])
def test_every_norm_site_goes_through_the_op(monkeypatch, decoder, sites):
    """A step calls add_rms_norm once a site, 3 x layers + 1 less the layers
    without cross-attention (73 at t5-large, 53 at FiDO-XL), and
    ``engine.norm_sites`` counts that number once a generate call."""
    model, ids, mask = _decoder(DECODERS[decoder])
    engine = DecodeEngine(model, max_length=8)
    layers = model.config.num_decoder_layers
    assert sites == 3 * layers + 1 - (layers - len(engine.cross_slot)) == engine.norm_sites
    calls = []

    def counted(*args):
        calls.append(args[1] is None)
        return add_rms_norm(*args)

    monkeypatch.setattr(engine_mod, "add_rms_norm", counted)
    t0 = profiling.now()
    engine.generate(ids, mask)
    engine.generate(ids, mask)
    counts = [n for t, k, n in profiling.snapshot()["counts"]
              if t >= t0 and k == "engine.norm_sites"]
    assert counts == [sites, sites]
    # the CPU runs every step eagerly: 7 steps a call; only the first site
    # of a step (the embedding's) has no delta
    assert len(calls) == 2 * 7 * sites
    assert sum(calls) == 2 * 7


def test_beam_engine_on_the_op_is_its_parent_bitwise(monkeypatch):
    """The beam engine's beams with add_rms_norm's sites equal those with the
    parent's adds and norms (the op replaced by the unfused chain)."""
    model, ids, mask = _decoder({}, seed=3)
    got = BeamEngine(model, max_length=8, num_beams=3).generate(ids, mask)
    calls = []

    def unfused(x, delta, weight, eps):
        calls.append(1)
        x = x if delta is None else x + delta
        return x, _rms(x, weight, eps, x.dtype)

    monkeypatch.setattr("lako_tpu_torch.models.t5.beam_engine.add_rms_norm", unfused)
    want = BeamEngine(model, max_length=8, num_beams=3).generate(ids, mask)
    assert len(torch.unique(got)) > 2
    assert len(calls) == 7 * (3 * 6 + 1)
    assert torch.equal(got, want)


def _bad(case):
    x = torch.zeros(4, 64)
    w = torch.ones(64)
    return {
        "float16": (x.half(), None, w),
        "float64": (x.double(), None, w),
        "weight-float16": (x, None, w.half()),
        "H-not-a-multiple-of-8": (torch.zeros(4, 60), None, torch.ones(60)),
        "H-too-wide": (torch.zeros(1, k8.MAX_H + 8), None, torch.ones(k8.MAX_H + 8)),
        "too-many-rows": (torch.zeros(k8.MAX_ROWS + 1, 8), None, torch.ones(8)),
        "3-d": (x[None], None, w),
        "weight-shape": (x, None, torch.ones(32)),
        "delta-dtype": (x, x.bfloat16(), w),
        "delta-shape": (x, x[:2], w),
        "strided": (torch.zeros(64, 4).T, None, w),
    }[case]


@pytest.mark.parametrize("case", ["float16", "float64", "weight-float16",
                                  "H-not-a-multiple-of-8", "H-too-wide", "too-many-rows",
                                  "3-d", "weight-shape", "delta-dtype", "delta-shape",
                                  "strided"])
def test_what_the_kernel_does_not_take_raises(case):
    x, delta, weight = _bad(case)
    with pytest.raises(ValueError):
        add_rms_norm(x, delta, weight, 1e-6)


def test_no_kernel_for_another_device():
    x = torch.zeros(2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        add_rms_norm(x, None, torch.ones(16, device="meta"), 1e-6)


def test_k8_builds_as_its_own_library(monkeypatch, tmp_path):
    """K8 is built into a library of its own, from add_rms_norm.cu and
    common.cu, so a decode-only process compiles nothing else."""
    cu = [s.name for s in _build._sources("norm") if s.suffix == ".cu"]
    assert cu == ["common.cu", "add_rms_norm.cu"]
    assert "add_rms_norm.cu" not in [s.name for s in _build._sources("kernels")]
    assert _build.library_path("norm").name.startswith("liblako_norm-")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found") as err:
        _build.compile_library(tmp_path / "k8.so", "norm")
    assert "add_rms_norm.cu" in str(err.value) and "adafactor.cu" not in str(err.value)
