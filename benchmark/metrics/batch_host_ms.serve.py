"""Median over the window's batches of ``serve.batch``: one
``answer_batch``, from its retrieval to its detokenized answers; a
request's latency is its ``serve.queue`` and this (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(run):
    return program_spans.median(program_spans.values(run, "serve.batch"))
