"""Share of the window's train steps whose forward and backward replayed a
captured CUDA graph, from the step's counter ``train.graph_replays`` over
the steps the driver ran (benchmark/program_spans.py): 100 where every step
replays. A program without that counter (an older tree), or a run in which
no step replayed (the CPU), reads None."""

from benchmark import program_spans


def read(run):
    replays = program_spans.counted(run, "train.graph_replays")
    steps = run["records"]["steps"]
    return 100.0 * replays / steps if replays and steps else None
