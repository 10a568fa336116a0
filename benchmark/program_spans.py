"""What the readers of the program's own spans and counters share
(``lako_tpu_torch.core.profiling``): the recorder's snapshot, taken in the
run's process after its driver returned, cut to the measured window.

A span counts when it starts at or after ``run["setup_end"]``, ends within
``run["window_s"]`` of it and was not recorded under ``torch.profiler``
(serving's traced last seconds, the traced units after the window); a
counter's increments count inside the same interval. Where the program
keeps no recorder, every reader gets None.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np


def snapshot(run) -> Optional[dict]:
    """The recorder's snapshot with the window's bounds in ns, or None."""
    try:
        from lako_tpu_torch.core import profiling
    except ImportError:
        return None
    take = getattr(profiling, "snapshot", None)
    if take is None:
        return None
    snap = take()
    t0 = round(run["setup_end"] * 1e9)
    return dict(snap, t0=t0, t1=t0 + round(run["window_s"] * 1e9))


def _kept(snap: dict, span: dict) -> bool:
    return (snap["t0"] <= span["start_ns"] and span["end_ns"] <= snap["t1"]
            and not span["profiled"])


def host_ms(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e6


def stream_ms(span: dict) -> Optional[float]:
    return span["stream_ms"]


def values(run, name: str, value: Callable = host_ms) -> Optional[List]:
    """``value`` of each kept span ``name``, or None without a recorder."""
    snap = snapshot(run)
    if snap is None:
        return None
    return [value(s) for s in snap["spans"] if s["name"] == name and _kept(snap, s)]


def per_batch(run, name: str, value: Callable = host_ms) -> Optional[List]:
    """``value`` summed over the kept spans ``name`` that follow each kept
    ``engine.prefill``, up to the next one: the chunks of one generate
    call, which run after its prefill under the engine's lock. A batch
    counts where every span of it was kept."""
    snap = snapshot(run)
    if snap is None:
        return None
    groups: Dict = defaultdict(list)
    anchor = None
    for s in sorted(snap["spans"], key=lambda s: s["start_ns"]):
        if s["name"] == "engine.prefill":
            anchor = s
        elif s["name"] == name and anchor is not None and _kept(snap, anchor):
            groups[anchor["sid"]].append(s)
    out = []
    for spans in groups.values():
        if all(_kept(snap, s) for s in spans):
            got = [value(s) for s in spans]
            out.append(None if None in got else sum(got))
    return out


def counted(run, name: str) -> Optional[int]:
    """The counter's increments inside the window, or None."""
    snap = snapshot(run)
    if snap is None:
        return None
    return sum(n for t, k, n in snap["counts"] if k == name and snap["t0"] <= t <= snap["t1"])


def median(vals: Optional[List]) -> Optional[float]:
    """The median, or None where there are no values or one is None (a
    stream time on the CPU)."""
    if not vals or any(v is None for v in vals):
        return None
    return float(np.median(vals))
