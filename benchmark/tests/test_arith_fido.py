"""FiDO's operation and byte counts against hand counts and the schema."""

import json

import pytest
import torch

from benchmark import arith, arith_fido
from benchmark.reference import fido_t5
from benchmark.tests.tiny import ROOT


def config(name):
    return json.loads((ROOT / "benchmark" / "configs" / name).read_text())


def test_fido_xl_parameters_by_hand():
    """T5 v1.1 XL's widths, gated MLP, cross blocks in 4 of 24 decoder
    layers with one 64-wide K/V head, untied head: 2.48B in all."""
    p = arith_fido.fido_params(config("fido-t5-xl.json"))
    layer = 4 * 2048 * 2048 + 3 * 2048 * 5120 + 2 * 2048
    cross = 4 * (2 * 2048 * 2048 + 2048 + 2 * 2048 * 64)
    assert p["n_cross"] == 4 and fido_t5.cross_layers(config("fido-t5-xl.json")) == [5, 11, 17,
                                                                                      23]
    assert p["enc"] == 24 * layer + 32 * 32 + 2048
    assert p["dec"] == 24 * layer + cross + 32 * 32 + 2048
    assert p["cross_kv"] == 4 * 2 * 2048 * 64
    assert p["head"] == 32128 * 2048
    assert cross == pytest.approx(34.6e6, rel=1e-3)
    total = p["enc"] + p["dec"] + 2 * p["head"]
    assert total == pytest.approx(2.48e9, rel=2e-3)


@pytest.mark.parametrize("name", ["lako-t5-large.json", "fid-t5-3b.json", "fido-t5-xl.json"])
def test_parameter_counts_match_the_schema(name):
    cfg = config(name)
    p = arith_fido.fido_params(cfg)
    schema = sum(torch.Size(shape).numel() for _, shape, _ in fido_t5.param_schema(cfg))
    embeddings = p["head"] * (1 if cfg["tie_word_embeddings"] else 2)
    assert schema == p["enc"] + p["dec"] + embeddings


@pytest.mark.parametrize("name", ["lako-t5-large.json", "fid-t5-3b.json"])
def test_homogeneous_configs_count_as_arith_does(name):
    """Without FiDO's options the count is ``arith``'s."""
    cfg = config(name)
    p, q = arith_fido.fido_params(cfg), arith.t5_params(cfg)
    assert (p["enc"], p["dec"], p["cross_kv"], p["head"]) == (q["enc"], q["dec"],
                                                               q["cross_kv"], q["vocab"])
    assert arith_fido.read_flops(cfg, [200, 180], [49, 12]) == arith.read_flops(
        cfg, [200, 180], [49, 12])


def test_read_flops_and_replay_least_s_by_hand():
    cfg = config("fido-t5-xl.json")
    p = arith_fido.fido_params(cfg)
    enc, steps = [250, 200], [49, 3]
    assert arith_fido.read_flops(cfg, enc, steps) == 2.0 * (
        (p["enc"] + p["cross_kv"]) * 450 + (p["dec"] - p["cross_kv"] + p["head"]) * 52)
    w = (p["dec"] - p["cross_kv"] + p["head"]) * 2
    hand = 0.0
    for s in range(1, 49):
        live = [k for k, n in zip(enc, steps) if n > s]
        kv = sum(4 * 2 * 64 * k * 2 + 24 * 2 * 2048 * (s + 1) * 2 for k in live)
        hand += (w + kv) / 3.35e12          # bytes bound every step at 2 rows
    assert arith_fido.replay_least_s(cfg, enc, steps) == pytest.approx(hand, rel=1e-12)
    # B=128 rows of N=2 x 130 tokens, 49 steps: 48 reads of 2.52 GB and more
    full = arith_fido.replay_least_s(cfg, [260] * 128, [49] * 128)
    assert 48 * 2.515e9 / 3.35e12 < full < 48 * 4e9 / 3.35e12


def test_cross_kv_bytes_of_a_batch():
    """The cross K/V a B=128 batch holds, bf16: (4, 128, 1, 64, 260) twice."""
    assert 4 * 128 * 1 * 64 * 260 * 2 * 2 / 1e6 == pytest.approx(34.08, abs=0.005)
