"""FiDO's model operations of the window's batches
(``arith_fido.read_flops``: the gated MLP, the 4 multi-query cross blocks,
the untied head, unmasked tokens) over the window's seconds and the bf16
peak."""

from benchmark import arith, arith_fido


def read(run):
    rec, cfg = run["records"], run["config"]
    flops = sum(arith_fido.read_flops(cfg, **rec["work"][b]) for b in rec["batches_run"])
    return 100.0 * flops / (run["window_s"] * arith.PEAK_BF16_FLOPS)
