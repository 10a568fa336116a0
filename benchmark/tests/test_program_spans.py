"""The readers of the program's own spans and counters on the CPU: each
cell's driver runs at a tiny size, then every metric of
``program_spans``'s sources in that cell reads the recorder the program
filled. Host times and counts are numbers, stream times None (no card);
an older program without a recorder reads None everywhere."""

import json
import math

import pytest

from benchmark import run as bench_run
from benchmark.tests import tiny

CELLS = {"serve-large-retrieve": ("lako-t5-large.json", "serve-retrieve",
                                  dict(rate_per_s=4.0)),
         "eval-large-b128": ("lako-t5-large.json", "eval-b128", {}),
         "train-3b-adafactor": ("fid-t5-3b.json", "train-adafactor", {})}
METRICS = tiny.ROOT / "benchmark" / "metrics"


def bench() -> dict:
    return json.loads((tiny.ROOT / "BENCHMARK.json").read_text())


def reads_the_recorder(m: dict) -> bool:
    path = METRICS / f"{m['name']}.py"
    return path.is_file() and "program_spans" in path.read_text()


def program_metrics(workload: str):
    return [m for m in bench()["per_layer"]
            if reads_the_recorder(m) and workload in m.get("workloads", [workload])]


def test_entries_name_cells_and_files():
    """Each entry read from the recorder names one cell that exists and
    reports the end-to-end metric it moves; its source is the program's."""
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    ends = {m["name"]: m for m in b["end_to_end"]}
    found = [m for m in b["per_layer"] if reads_the_recorder(m)]
    assert len(found) == 20
    assert all((METRICS / f"{m['name']}.py").is_file() for m in b["per_layer"])
    for m in found:
        assert len(m["workloads"]) == 1 and set(m["workloads"]) <= cells, m
        assert m["source"] in ("program_span", "program_counter"), m
        assert all(w in ends[m["moves"]]["workloads"] for w in m["workloads"]), m


@pytest.fixture(scope="module", params=sorted(CELLS))
def driven(request):
    """(cell name, the run's dict) after a tiny run of the cell's driver."""
    workload = request.param
    cfg, mix, over = CELLS[workload]
    cell = tiny.cell(workload, cfg, mix, seconds=6.0, **over)
    driver = bench_run.load(tiny.ROOT / "benchmark" / "drivers" / f"{cell.traffic['driver']}.py")
    return workload, driver.run(cell)


def test_every_reader_reads_the_program(driven):
    workload, run = driven
    metrics = program_metrics(workload)
    assert metrics
    for m in metrics:
        value = bench_run.load(METRICS / f"{m['name']}.py").read(run)
        if "_stream_" in m["name"]:
            assert value is None, m["name"]
        elif m["name"] in ("graph_captures.serve", "replays_per_batch.serve"):
            assert value == 0                   # nothing is graphed on the CPU
        else:
            assert isinstance(value, float) and math.isfinite(value) and value > 0, (m, value)


def test_readers_without_a_recorder_read_none(driven, monkeypatch):
    """A program without the recorder (an older tree) has no ``snapshot``:
    every reader gives None."""
    from lako_tpu_torch.core import profiling

    monkeypatch.delattr(profiling, "snapshot")
    workload, run = driven
    for m in program_metrics(workload):
        module = bench_run.load(METRICS / f"{m['name']}.py")
        assert module.read(run) is None, m["name"]


def test_window_and_batches(monkeypatch):
    """Spans count inside the window and unprofiled only; a batch counts
    whole; chunks group under the prefill they follow, a chunk before any
    prefill under none, other spans between them change nothing; counters
    count their increments in the window."""
    from benchmark import program_spans

    def span(sid, name, start, end, parent=None, profiled=False, stream=None):
        return {"sid": sid, "name": name, "start_ns": start, "end_ns": end, "parent": parent,
                "id": None, "profiled": profiled, "stream_ms": stream}

    spans = [span(1, "engine.replay", 5, 8),                       # before any prefill
             span(2, "engine.prefill", 10, 20, stream=1.0),
             span(3, "engine.replay", 21, 25, stream=2.0),
             span(4, "engine.replay", 26, 30, stream=3.0),
             span(5, "serve.collate", 31, 33, parent=9),
             span(6, "serve.collate", 34, 36, parent=9),
             span(7, "engine.prefill", 40, 50, stream=1.0),
             span(8, "engine.replay", 51, 60, profiled=True),      # its batch is dropped
             span(10, "engine.prefill", 90, 95),
             span(11, "engine.replay", 96, 120)]                   # ends past the window
    snap = {"spans": spans, "t0": 10, "t1": 100,
            "counts": [(5, "c", 1), (10, "c", 2), (100, "c", 3), (101, "c", 4)]}
    monkeypatch.setattr(program_spans, "snapshot", lambda run: snap)
    run = {}
    assert program_spans.per_batch(run, "engine.replay") == [8e-6]
    assert program_spans.per_batch(run, "engine.replay", program_spans.stream_ms) == [5.0]
    assert program_spans.values(run, "serve.collate") == [2e-6, 2e-6]
    assert program_spans.values(run, "engine.prefill", program_spans.stream_ms) == [1.0, 1.0,
                                                                                   None]
    assert program_spans.median([1.0, None]) is None and program_spans.median([]) is None
    assert program_spans.counted(run, "c") == 5
