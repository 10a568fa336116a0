"""Share of the window's train steps whose Adafactor update took the fused
kernel K7, from the optimizer's counter ``train.adafactor_fused`` over the
steps the driver ran (benchmark/program_spans.py): 100 where every update of
float32 leaves on the card is fused. A program without that counter (an
older tree), or a run in which no update took the kernel (the CPU), reads
None."""

from benchmark import program_spans


def read(run):
    fused = program_spans.counted(run, "train.adafactor_fused")
    steps = run["records"]["steps"]
    return 100.0 * fused / steps if fused and steps else None
