"""Median over the window's steps of ``train.fwd_bwd``'s host time: the
forward and ``autograd.grad`` (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(run):
    return program_spans.median(program_spans.values(run, "train.fwd_bwd"))
