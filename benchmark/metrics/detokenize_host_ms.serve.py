"""Median over the window's batches of ``serve.detokenize``: the
tokenizer's ``batch_decode`` of a batch's answers on the host
(benchmark/program_spans.py)."""

from benchmark import program_spans


def read(run):
    return program_spans.median(program_spans.values(run, "serve.detokenize"))
