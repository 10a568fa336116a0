"""Median over the window's device batches of ``serve.fetch``: the tokens'
``.cpu().numpy()``, where the host waits for the card to finish the
batch's decode (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(run):
    return program_spans.median(program_spans.values(run, "serve.fetch"))
