"""The median over the window's requests of ``serve.queue``: from a
request's put into ``MicroBatcher`` to just before the ``answer_batch``
that takes it (benchmark/program_spans.py); steadier than the p95 beside
it, ``queue_wait_ms.serve``."""

from benchmark import program_spans


def read(run):
    return program_spans.median(program_spans.values(run, "serve.queue"))
