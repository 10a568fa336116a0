"""The replayed decode steps' least time on the card
(``arith_fido.replay_least_s``: the bytes they must read, or their
operations, over the card's peak), the median over the window's distinct
batches, over their measured time, ``replay_stream_ms.fido``."""

import numpy as np

from benchmark import arith_fido, program_spans


def read(run):
    measured = program_spans.median(program_spans.per_batch(
        run, "engine.replay", program_spans.stream_ms))
    if not measured:
        return None
    least = np.median([arith_fido.replay_least_s(run["config"], **w)
                       for w in run["records"]["work"]])
    return 100.0 * least / (measured / 1e3)
