"""CUDA graph replays of the decode engine over the service's batches in
the window, from the counters ``engine.replays`` and ``serve.batches``
(benchmark/program_spans.py): 1 where each batch decodes as one
full-length graph, more where the chunked early-exit route runs; 0 where
nothing is graphed (the CPU)."""

from benchmark import program_spans


def read(run):
    batches = program_spans.counted(run, "serve.batches")
    return program_spans.counted(run, "engine.replays") / batches if batches else None
