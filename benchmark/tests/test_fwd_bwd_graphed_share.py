"""The reader of ``fwd_bwd_graphed_share.train`` on a synthetic snapshot:
the train step's counter ``train.graph_replays`` inside the window over the
driver's steps; without a count, or without a recorder, None."""

from benchmark import program_spans
from benchmark import run as bench_run
from benchmark.tests import tiny

READER = tiny.ROOT / "benchmark" / "metrics" / "fwd_bwd_graphed_share.train.py"


def test_fwd_bwd_graphed_share(monkeypatch):
    read = bench_run.load(READER).read
    counts = ([(5, "train.graph_captures", 1), (5, "train.graph_replays", 1)]
              + [(t, "train.graph_replays", 1) for t in (10, 40, 70, 100)])
    snap = {"spans": [], "t0": 10, "t1": 100, "counts": counts + [(50, "serve.batches", 1)]}
    monkeypatch.setattr(program_spans, "snapshot", lambda run: snap)
    assert read({"records": {"steps": 4}}) == 100.0
    assert read({"records": {"steps": 8}}) == 50.0
    snap["counts"] = [(50, "train.adafactor_fused", 1)]
    assert read({"records": {"steps": 4}}) is None
    monkeypatch.setattr(program_spans, "snapshot", lambda run: None)
    assert read({"records": {"steps": 4}}) is None
