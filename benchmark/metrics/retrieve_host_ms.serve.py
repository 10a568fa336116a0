"""Median over the window's batches of ``serve.retrieve``: BERT
tokenizing, embedding, the index search and its ids and scores on the host
(benchmark/program_spans.py)."""

from benchmark import program_spans


def read(run):
    return program_spans.median(program_spans.values(run, "serve.retrieve"))
