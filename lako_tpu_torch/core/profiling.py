"""The port's spans and counters, and its ``torch.profiler`` trace window.

A span is a named stretch of host time: its start and end on
``time.perf_counter_ns()``, the span that was open on the same thread when
it started (its parent), and an optional id (a request's or a batch's
number). A span opened with ``device=`` a CUDA device also records a pair
of CUDA events on that device's current stream, read only when the spans
are taken out: its stream time runs from the first work queued inside the
span to the last, the stream's idle bubbles included (``None`` on the
CPU). :func:`record` keeps a span whose stamps were taken elsewhere (a
request's wait in a queue). A counter is a plain integer keyed by name;
each increment is kept with its time, so that a reader can count inside a
window.

Everything stays in memory, in bounded rings, and :func:`snapshot` takes
it out; nothing is written to disk. The recorder is always on and is used
at batch and step granularity only: a span costs two clock reads and an
append (a stream span two event records more). While a ``torch.profiler``
session records, each span also opens a ``record_function`` range of its
name and is flagged ``profiled``, so traces name the host's time by the
program's spans; :func:`profiler_ns` puts a stamp on the profiler's clock.
A span that overlaps a profiler session keeps no stream time, and the
recorder makes no CUDA call from the moment a session prepares (the device
tracer starts there, before ``_is_profiler_enabled`` is set) until it has
stopped: CUDA events recorded on a second thread under the device tracer
crashed traced serving runs on an H100. To see that moment the recorder
wraps ``torch.autograd.profiler``'s ``_prepare_profiler`` and
``_disable_profiler``; the wrapper waits for a CUDA call of the recorder in
progress, so none overlaps the tracer's start.

:func:`start_trace` records host and CUDA activity until the function it
returns is called, which writes a Chrome trace (``chrome://tracing``,
Perfetto) into the profile directory and returns its path.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity

SPAN_RING = 1 << 15      # spans kept: minutes of a served stream at ~60 spans a second
COUNT_RING = 1 << 14     # counter increments kept with their times

now = time.perf_counter_ns


def profiler_ns(stamp: int) -> int:
    """A span stamp (``perf_counter_ns``) on ``torch.profiler``'s clock,
    ``time.time_ns()``'s epoch, by the two clocks' offset read now: the wall
    clock can step against ``perf_counter`` (a paused virtual machine), so
    an offset taken once goes stale."""
    return stamp + time.time_ns() - time.perf_counter_ns()


def _profiling() -> bool:
    return _autograd_profiler._is_profiler_enabled


# The recorder's CUDA calls run under ``_CUDA`` and only while no profiler
# session is prepared or running (``_traced()`` false); a session's
# preparation takes ``_CUDA`` before it starts the device tracer.
_CUDA = threading.Lock()
_sessions = [0]             # profiler sessions prepared and not yet stopped


def _traced() -> bool:
    return _sessions[0] > 0 or _profiling()


def _watch_profiler() -> None:
    prepare = getattr(_autograd_profiler, "_prepare_profiler", None)
    disable = getattr(_autograd_profiler, "_disable_profiler", None)
    if prepare is None or disable is None or getattr(prepare, "_lako_watch", False):
        return

    def _prepare_profiler(*args, **kwargs):
        with _CUDA:
            _sessions[0] += 1
        try:
            return prepare(*args, **kwargs)
        except BaseException:
            with _CUDA:
                _sessions[0] -= 1
            raise

    def _disable_profiler(*args, **kwargs):
        try:
            return disable(*args, **kwargs)
        finally:
            with _CUDA:
                _sessions[0] = max(0, _sessions[0] - 1)

    _prepare_profiler._lako_watch = _disable_profiler._lako_watch = True
    _autograd_profiler._prepare_profiler = _prepare_profiler
    _autograd_profiler._disable_profiler = _disable_profiler


_watch_profiler()


class _Local(threading.local):
    def __init__(self):
        self.stack: List["Span"] = []


class Span:
    """One span; a context manager that records it when it closes."""

    __slots__ = ("name", "id", "sid", "parent", "start_ns", "end_ns", "profiled",
                 "stream_ms", "_rec", "_device", "_range", "_events")

    def __init__(self, rec: "Recorder", name: str, id: Optional[int] = None,
                 device: Optional[torch.device] = None):
        self.name, self.id, self._rec = name, id, rec
        self._device = device if device is not None and device.type == "cuda" else None
        self.parent: Optional[int] = None
        self.profiled = False
        self.stream_ms: Optional[float] = None
        self._range = self._events = None
        self.start_ns = self.end_ns = 0

    def __enter__(self) -> "Span":
        rec = self._rec
        local = rec._local
        self.sid = next(rec._sids)
        if local.stack:
            self.parent = local.stack[-1].sid
        if _profiling():
            self.profiled = True
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        elif self._device is not None:
            with _CUDA:
                if _traced():
                    self.profiled = True
                else:
                    self._events = (rec._event(), None)
                    self._events[0].record(torch.cuda.current_stream(self._device))
        local.stack.append(self)
        self.start_ns = now()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = now()
        rec = self._rec
        rec._local.stack.pop()
        if self._events is not None:
            with _CUDA:
                if _traced():                   # a session began inside the span
                    rec._release(self._events[0])
                    self._events, self.profiled = None, True
                else:
                    end = rec._event()
                    end.record(torch.cuda.current_stream(self._device))
                    self._events = (self._events[0], end)
            if self._events is not None:
                rec._in_flight(self)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        rec._spans.append(self)

    def as_dict(self) -> dict:
        return {"sid": self.sid, "name": self.name, "parent": self.parent, "id": self.id,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "profiled": self.profiled, "stream_ms": self.stream_ms}


class Recorder:
    """Spans and counters in bounded rings; one per process (:data:`RECORDER`)
    for the program, others for tests."""

    def __init__(self, spans: int = SPAN_RING, counts: int = COUNT_RING):
        self._spans: deque = deque(maxlen=spans)
        self._counts: deque = deque(maxlen=counts)
        self._totals: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = _Local()
        self._sids = itertools.count(1)
        self._pool: List["torch.cuda.Event"] = []
        self._flight: deque = deque()     # stream spans whose events are unread

    def span(self, name: str, id: Optional[int] = None,
             device: Optional[torch.device] = None) -> Span:
        """``with recorder.span(name): ...``; ``device``, a CUDA device whose
        current stream takes the span's work, adds its stream time."""
        return Span(self, name, id, device)

    def record(self, name: str, start_ns: int, end_ns: int, id: Optional[int] = None) -> None:
        """Keep a finished span ``name`` from stamps taken elsewhere
        (``now()``), with no parent."""
        s = Span(self, name, id)
        s.sid, s.start_ns, s.end_ns, s.profiled = next(self._sids), start_ns, end_ns, _profiling()
        self._spans.append(s)

    def count(self, name: str, n: int = 1) -> int:
        """Add ``n`` to the counter ``name``; returns its new total."""
        t = now()
        with self._lock:
            total = self._totals[name] = self._totals.get(name, 0) + n
            self._counts.append((t, name, n))
        return total

    def snapshot(self) -> dict:
        """``{"spans": [span records, oldest first], "counts": [(time_ns,
        name, n)]}``. Waits for the device work of stream spans not read
        yet, unless a profiler session is prepared or records (their stream
        time then reads ``None``): not to be called while a CUDA graph is
        captured."""
        self._settle(wait=True)
        with self._lock:
            spans = self._spans.copy()
            counts = list(self._counts)
        return {"spans": [s.as_dict() for s in spans], "counts": counts}

    # -- internals -------------------------------------------------------------

    def _event(self) -> "torch.cuda.Event":
        with self._lock:
            if self._pool:
                return self._pool.pop()
        return torch.cuda.Event(enable_timing=True)

    def _release(self, *events: "torch.cuda.Event") -> None:
        # Every event made is kept: the pool holds as many as were ever in
        # flight at once, and no event is destroyed while a tracer runs.
        with self._lock:
            self._pool.extend(events)

    def _in_flight(self, span: Span) -> None:
        with self._lock:
            self._flight.append(span)
        self._settle(wait=False)

    def _settle(self, wait: bool) -> None:
        """Read the stream time of spans whose device work has ended (with
        ``wait``, of all of them) and put their events back in the pool;
        nothing while a profiler session is prepared or records."""
        with _CUDA:
            if _traced():
                return
            if wait:
                with self._lock:
                    ends = [s._events[1] for s in self._flight]
                for end in ends:
                    end.synchronize()
            freed = []
            with self._lock:
                while self._flight:
                    span = self._flight[0]
                    start, end = span._events
                    if not end.query():
                        break
                    span.stream_ms = start.elapsed_time(end)
                    span._events = None
                    self._flight.popleft()
                    freed += (start, end)
            self._release(*freed)


RECORDER = Recorder()
span = RECORDER.span
record = RECORDER.record
count = RECORDER.count
snapshot = RECORDER.snapshot


def start_trace(profile_dir: str) -> Callable[[], str]:
    """Start tracing the CPU and, where the build supports it, CUDA; returns
    the function that stops the trace and writes it into ``profile_dir``."""
    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in torch.profiler.supported_activities()]
    prof = torch.profiler.profile(activities=activities)
    prof.start()

    def stop() -> str:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        Path(profile_dir).mkdir(parents=True, exist_ok=True)
        path = str(Path(profile_dir) / f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        return path

    return stop
