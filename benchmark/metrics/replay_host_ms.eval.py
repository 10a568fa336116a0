"""Median over the window's batches of the ``engine.replay`` spans' host
time, summed over a batch's chunks: the graph launches
(benchmark/program_spans.py)."""

from benchmark import program_spans


def read(run):
    return program_spans.median(program_spans.per_batch(run, "engine.replay"))
