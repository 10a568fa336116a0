"""Median over the window's steps of ``train.optimizer``'s host time:
``tx.update`` and ``apply_updates`` (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(run):
    return program_spans.median(program_spans.values(run, "train.optimizer"))
