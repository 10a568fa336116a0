"""Per cent of a traced batch's time in which no device activity ran: the
device's busy time a traced batch after the window against the window's
untraced seconds a batch (``torch.profiler``; benchmark/trace.py)."""

from benchmark import readers


def read(run):
    return readers.idle_share(run)
