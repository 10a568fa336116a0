"""Requests over batches of the window, from the service's counters
``serve.requests`` and ``serve.batches`` (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(run):
    batches = program_spans.counted(run, "serve.batches")
    return program_spans.counted(run, "serve.requests") / batches if batches else None
