"""The 95th percentile over the window's requests of ``serve.queue``: from a
request's put into ``MicroBatcher`` to the start of the ``answer_batch``
that takes it (benchmark/program_spans.py)."""

import numpy as np

from benchmark import program_spans


def read(run):
    waits = program_spans.values(run, "serve.queue")
    return float(np.percentile(waits, 95)) if waits else None
