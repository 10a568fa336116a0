"""The FiDO cell's driver, readers, reference and controls at a tiny size on
the CPU: the harness's loop with FiDO's configuration, weights and
reference, every ``.fido`` reader on the run, and a fault the check must
see."""

import json

import pytest
import torch

from benchmark import common, controls, fido, run as bench_run
from benchmark.reference import fido_t5
from benchmark.reference import t5 as ref_t5
from benchmark.tests.tiny import ROOT

WORKLOAD = "eval-fido-xl-b128"
METRICS = ROOT / "benchmark" / "metrics"


def tiny_cell(seed=2_147_483_659, **over):
    cfg = json.loads((ROOT / "benchmark" / "configs" / "fido-t5-xl.json").read_text())
    cfg.update(vocab_size=8192, d_model=64, d_kv=16, d_ff=128, num_layers=2,
               num_decoder_layers=6, num_heads=4, cross_attention_stride=3)
    tr = json.loads((ROOT / "benchmark" / "traffic" / "eval-b128-fido.json").read_text())
    tr.update(batch_size=8, distinct_batches=2, trace_batches=1, **over)
    return common.Cell(WORKLOAD, cfg, tr, seed, 2.0, False, torch.device("cpu"))


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def limits():
    return json.loads((ROOT / "benchmark" / "limits" / f"{WORKLOAD}.json").read_text())


@pytest.fixture(scope="module")
def driven():
    cell = tiny_cell()
    driver = bench_run.load(ROOT / "benchmark" / "drivers" / f"{cell.traffic['driver']}.py")
    return cell, driver.run(cell)


def test_entries_name_the_cell_and_its_files():
    b = bench()
    (cell,) = [w for w in b["workloads"] if w["name"] == WORKLOAD]
    (conf,) = [c for c in b["configs"] if c["name"] == cell["config"]]
    assert cell["chips"] == 1 and conf["reduced"] == []
    assert (ROOT / conf["file"]).is_file()
    assert (ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json").is_file()
    ends = {m["name"] for m in bench_run.metric_names(b, WORKLOAD, False)}
    assert ends == {"answers_per_s", "setup_s"}
    mine = bench_run.metric_names(b, WORKLOAD, True)
    assert sorted(m["name"] for m in mine) == sorted(
        f"{n}.fido" for n in ("prefill_stream_ms", "replay_stream_ms", "decode_roofline",
                              "eval_mfu", "cross_kv_mb", "device_idle_share"))
    for m in mine:
        assert m["workloads"] == [WORKLOAD] and m["moves"] == "answers_per_s"
        assert (METRICS / f"{m['name']}.py").is_file()


def test_the_driver_runs_fido_and_puts_t5_back(driven):
    """The program decodes a FiDO reader through its engine; the check reads
    the served logits against FiDO's reference; afterwards the T5 cells'
    configuration, weights and reference are back in place."""
    cell, run = driven
    assert common.t5_config is not fido.t5_config and ref_t5.T5Reference is not \
        fido_t5.FidoReference
    assert run["attempted"] > 0 and run["failed"] == 0
    assert set(run["checks"]) == {"token_gap", "logit_err"}
    assert common.judge(run["checks"], limits()), run["checks"]
    assert all(len(w["steps"]) == 8 for w in run["records"]["work"])


def test_the_fido_readers(driven):
    """On the CPU: no stream times (so no roofline) and no trace; the cross
    K/V the engine held, the model's operations."""
    cell, run = driven
    cfg = cell.config
    got = {m["name"]: bench_run.load(METRICS / f"{m['name']}.py").read(run)
           for m in bench_run.metric_names(bench(), WORKLOAD, True)}
    assert got["prefill_stream_ms.fido"] is None and got["replay_stream_ms.fido"] is None
    assert got["decode_roofline.fido"] is None and got["device_idle_share.fido"] is None
    # (2 cross layers, B 8, 1 K/V head, d 16, K 2 x 130) twice, bf16
    assert got["cross_kv_mb.fido"] == 2 * 8 * 1 * 16 * 260 * 2 * 2 / 1e6
    assert 0 < got["eval_mfu.fido"] < 100


def test_readers_without_the_counter_read_none(driven, monkeypatch):
    """An older program counts no cross K/V: its reader gives None."""
    from lako_tpu_torch.core import profiling

    cell, run = driven
    reader = bench_run.load(METRICS / "cross_kv_mb.fido.py")
    snap = profiling.snapshot()
    monkeypatch.setattr(profiling, "snapshot", lambda: dict(snap, counts=[
        c for c in snap["counts"] if c[1] != "engine.cross_kv_bytes"]))
    assert reader.read(run) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert reader.read(run) is None


def test_the_check_sees_another_reader(monkeypatch):
    """A reference fed other weights than the program's (a fault the check
    must see) fails the cell's limits."""
    cell = tiny_cell()
    original, calls = fido.t5_state, []

    def second_other(cfg, seed, device):    # the program's weights, then the check's
        calls.append(seed)
        return original(cfg, seed + (len(calls) > 1), device)

    monkeypatch.setattr(fido, "t5_state", second_other)
    driver = bench_run.load(ROOT / "benchmark" / "drivers" / "offline_batches_fido.py")
    checks = driver.run(cell)["checks"]
    assert len(calls) == 2
    assert not common.judge(checks, limits()), checks


def test_serving_controls_run_on_the_fido_cell():
    """``benchmark/controls.py``'s lower-precision runs reach FiDO: the int8
    decode and the fp8 reference read above the sound run."""
    cell = tiny_cell()
    out = controls.judged(controls.serving_controls(cell), limits())
    sound = bench_run.run_cell(ROOT, WORKLOAD, cell, bench(), limits())["checks"]
    assert out["int8_tf32"]["logit_err"] > sound["logit_err"]["value"]
    assert out["fp8"]["logit_err"] > sound["logit_err"]["value"]
    assert out["fp8"]["token_gap"] > sound["token_gap"]["value"]
