"""Median over the window's steps of ``train.fwd_bwd``'s time on the card's
stream: the forward and ``autograd.grad``, from their first queued work to
their last (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(run):
    return program_spans.median(program_spans.values(run, "train.fwd_bwd",
                                                     program_spans.stream_ms))
