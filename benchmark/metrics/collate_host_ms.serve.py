"""Median over the window's device batches of ``serve.collate`` (one a
batch: the batcher takes at most the service's batch size): the dataset,
the collator and the copy of the ids and mask to the card
(benchmark/program_spans.py)."""

from benchmark import program_spans


def read(run):
    return program_spans.median(program_spans.values(run, "serve.collate"))
