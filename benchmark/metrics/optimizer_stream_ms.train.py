"""Median over the window's steps of ``train.optimizer``'s time on the
card's stream: ``tx.update`` and ``apply_updates``, from their first queued
work to their last (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(run):
    return program_spans.median(program_spans.values(run, "train.optimizer",
                                                     program_spans.stream_ms))
