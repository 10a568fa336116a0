"""Median over the window's batches of ``engine.prefill``'s time on the
card's stream: the encoder, the cross K/V and step 0, from their first
queued work to their last (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(run):
    return program_spans.median(program_spans.values(run, "engine.prefill",
                                                     program_spans.stream_ms))
