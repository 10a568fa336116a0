"""Median over the window's batches of ``engine.prefill``'s time on the
card's stream: FiDO's encoder, its cross K/V (the cross layers only) and
step 0, from their first queued work to their last
(benchmark/program_spans.py)."""

from benchmark import program_spans


def read(run):
    return program_spans.median(program_spans.values(run, "engine.prefill",
                                                     program_spans.stream_ms))
