"""Median over the window's batches of the ``engine.replay`` spans' time on
the card's stream, summed over a batch's chunks: FiDO's heterogeneous
decode steps after step 0 (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(run):
    return program_spans.median(program_spans.per_batch(
        run, "engine.replay", program_spans.stream_ms))
