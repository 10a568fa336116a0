"""Median over the window's batches of the cross K/V bytes the decode engine
loaded into a batch's buffers (counter ``engine.cross_kv_bytes``, one
increment a generate call), in MB (10^6 bytes); None where the program
counts none (benchmark/program_spans.py)."""

import numpy as np

from benchmark import program_spans


def read(run):
    snap = program_spans.snapshot(run)
    if snap is None:
        return None
    got = [n for t, k, n in snap["counts"]
           if k == "engine.cross_kv_bytes" and snap["t0"] <= t <= snap["t1"]]
    return float(np.median(got)) / 1e6 if got else None
