"""8-bit Adam micro-benchmark and floor proof on the CUDA card.

The port of scripts/bench_adam8_micro.py. At one t5-large-scale leaf (46M
elements, blocked ``(179688, 256)``, a bfloat16 gradient and a random
mid-training 8-bit state, drawn on the card from a seed) it times:

- K5, ``fused_adam8_update``, with stochastic rounding on and off;
- K6, ``adam8_ema_fragment``: K5 without the requantization (dequantize both
  moments, the two EMAs, u). No 8-bit update can beat it, since the
  requantization is what keeps the state in 8 bits;
- the plain PyTorch Adam update with bfloat16 moments, the update that
  adamw8bit is held against.

Each op runs n times back to back, each call's output feeding the next (the
moments for K5, u as the next gradient for K6 and the bf16 update), captured
in a CUDA graph and replayed between CUDA events; the time per call is
``(t(N_HI) - t(N_LO)) / (N_HI - N_LO)``, so that fixed costs cancel, as in
the JAX script. The floor proof sets K5 against K6 (the requantization's
share) and against the bytes bound.

    python -m lako_tpu_torch.bench.adam8_micro     # prints one JSON object
"""

from __future__ import annotations

import json
from typing import Callable, Dict, Optional

import torch

from lako_tpu_torch.core.device import resolve_device
from lako_tpu_torch.ops.adam8_kernel import adam8_ema_fragment, fused_adam8_update

SHAPE = (179_688, 256)          # ~46M elements
N_LO, N_HI = 8, 40
T5_LARGE_PARAMS = 737.7e6       # counted from t5-large's shapes
PEAK_BYTES = 3.35e12            # H100 SXM data sheet, bytes/s
HYPER = dict(b1=0.9, b2=0.999, eps=1e-6, correct_bias=False, seed=7, leaf_salt=0)
COUNT = 3


def make_inputs(shape, device):
    """(g bf16, mq, ms, vq, vs): a gradient and an 8-bit state at the
    scales of a leaf in mid-training, drawn from seed 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    nb, c = shape
    g = (torch.randn(shape, generator=gen, device=device) * 1e-3).bfloat16()
    mq = torch.randint(-127, 128, shape, generator=gen, device=device, dtype=torch.int8)
    ms = torch.randn(nb, 1, generator=gen, device=device).abs() * 1e-3
    vq = torch.randint(0, 255, shape, generator=gen, device=device, dtype=torch.uint8)
    vs = torch.randn(nb, 1, generator=gen, device=device).abs() * 1e-6
    return g, mq, ms, vq, vs


def make_loops(g, mq, ms, vq, vs) -> Dict[str, Callable[[int], torch.Tensor]]:
    """Each measured op as ``loop(n)``: n chained calls, returning the last
    output."""
    def k5(stochastic_round):
        def loop(n):
            state = (mq, ms, vq, vs)
            for _ in range(n):
                _, *state = fused_adam8_update(g, *state, COUNT,
                                               stochastic_round=stochastic_round, **HYPER)
            return state[0]
        return loop

    def k6(n):
        x = g
        for _ in range(n):
            x = adam8_ema_fragment(x, mq, ms, vq, vs)
        return x

    def bf16_adam(n):
        m = torch.zeros_like(g)
        v = torch.zeros_like(g)
        x = g
        for _ in range(n):
            gf = x.float()
            mf = 0.9 * m.float() + 0.1 * gf
            vf = 0.999 * v.float() + 0.001 * gf * gf
            x = (mf / (torch.sqrt(vf) + 1e-6)).bfloat16()
            m, v = mf.bfloat16(), vf.bfloat16()
        return x

    return {"fused_kernel_ms": k5(True), "fused_kernel_no_dither_ms": k5(False),
            "requant_free_fragment_ms": k6, "bf16_adam_ms": bf16_adam}


def _ms_per_call(loop: Callable[[int], torch.Tensor]) -> float:
    """Device time per call: n chained calls captured in one CUDA graph, so
    that the host's cost of issuing them (the wrappers' Python) is not timed,
    as the JAX script's calls run inside one compiled loop."""
    def graph_of(n):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            loop(n)
        graph.replay()
        return graph

    def elapsed(graph):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    stream = torch.cuda.Stream()             # warm-up off the default stream, as capture needs
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        loop(1)
    torch.cuda.current_stream().wait_stream(stream)
    lo, hi = graph_of(N_LO), graph_of(N_HI)
    return (elapsed(hi) - elapsed(lo)) / (N_HI - N_LO)


def run(device: Optional[torch.device] = None) -> dict:
    """The measurements and the floor proof, as a dict. Times only the card:
    a CPU device raises."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"the 8-bit Adam micro-benchmark times the CUDA card, not {device}")
    g, mq, ms, vq, vs = make_inputs(SHAPE, device)
    out = {"device": torch.cuda.get_device_name(device), "elements": g.numel(),
           "shape": list(SHAPE),
           "method": f"CUDA events around a CUDA graph of n chained calls: "
                     f"(t({N_HI}) - t({N_LO})) / {N_HI - N_LO}"}
    for name, loop in make_loops(g, mq, ms, vq, vs).items():
        out[name] = _ms_per_call(loop)
    # K5 reads g, both codes and both scales and writes u, codes and scales
    k5_bytes = 2 * g.numel() * g.element_size() + 2 * (mq.numel() + vq.numel()) \
        + 2 * (ms.numel() + vs.numel()) * 4
    leaves = T5_LARGE_PARAMS / g.numel()
    out["floor_proof"] = {
        "requant_cost_ms": out["fused_kernel_ms"] - out["requant_free_fragment_ms"],
        "requant_share": 1 - out["requant_free_fragment_ms"] / out["fused_kernel_ms"],
        "dither_cost_ms": out["fused_kernel_ms"] - out["fused_kernel_no_dither_ms"],
        "k5_bytes_bound_ms": k5_bytes / PEAK_BYTES * 1e3,
        "t5_large_kernel_ms": out["fused_kernel_ms"] * leaves,
        "t5_large_requant_free_ms": out["requant_free_fragment_ms"] * leaves,
    }
    return out


def main() -> None:
    print(json.dumps(run(), indent=1))


if __name__ == "__main__":
    main()
