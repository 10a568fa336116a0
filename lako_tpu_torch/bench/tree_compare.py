"""Measurements that set two trees of the port side by side on one card.

Each run measures the tree whose ``lako_tpu_torch`` it imports, through
entry points that every tree of the port has, so one copy of this script
times an older tree as well as the current one. Run it from each tree's
root, in turns (parent, change, change, parent), in one call on the card:

    PYTHONPATH=. python3 /path/to/tree_compare.py --out A.json --k3-out A.pt
    python3 tree_compare.py --same A.pt B.pt      # K3's output bits of two runs

A run prints and writes one JSON object:

- ``k5_micro_ms``: K5 (``fused_adam8_update``) on one leaf at the JAX
  package's micro shape (179688, 256), bf16 g: device ms per call from a
  CUDA graph of 20 calls;
- ``path_*``: one whole AdamW8bit moment update (``scale_by_adam_8bit()``,
  "auto") over the gradients of every parameter of the training path's
  t5-large (f32, random, at the fixture's vocabulary): ``path_wall_ms``, the
  median of 5 on the host clock around the update and a synchronize;
  ``path_event_ms``, CUDA events around one warmed update; ``path_kernel_ms``,
  the device time of the update's kernels and copies in a ``torch.profiler``
  trace; ``path_k5_launches``; ``path_bytes_bound_ms``, the bytes of g, u and
  both states over 3.35 TB/s;
- ``k5_sass``: instructions of the tree's K5 kernels in ``cuobjdump -sass``
  of ``csrc/adam8.cu`` compiled with the tree's flags, and their
  quarter-rate ones;
- the card's name and power limit.

``--k3-out`` saves K3's output at the served shape (8, 16, 64, 260), inputs
from a numpy seed, so that two trees' bits can be compared with ``--same``.

``chip_smoke.py`` takes its device timer (:func:`device_ms`), the memory
rate, the training path's gradients (:func:`path_grads`) and the SASS count
(:func:`sass_counts`) from here.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

PEAK_BYTES = 3.35e12     # H100 SXM data sheet, bytes/s
MICRO = (179_688, 256)
VOCAB = 36               # chip_smoke.py's training fixture


def sass_counts(text: str, name: str) -> dict:
    """Instructions of each function of a ``cuobjdump -sass`` listing whose
    name holds ``name``: {function: (instructions, quarter-rate ones by
    opcode)}."""
    out = {}
    for part in text.split("Function : ")[1:]:
        fn = part.split()[0]
        if name not in fn:
            continue
        ops = [m.group(1) for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", part)]
        out[fn] = (len(ops), {k: sum(op.split(".")[0] == k for op in ops)
                              for k in ("MUFU", "I2F", "F2I", "FRND")})
    return out


def k5_sass() -> dict:
    """The tree's ``csrc/adam8.cu`` compiled to an object with its own flags,
    and the SASS of its K5 kernels."""
    from lako_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    tool = shutil.which("cuobjdump", path=str(Path(nvcc).parent)) if nvcc else None
    if tool is None:
        return {"error": "nvcc or cuobjdump not found"}
    obj = _build.BUILD_DIR / "tree_compare" / "adam8.o"
    obj.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(obj),
                    str(_build.CSRC_DIR / "adam8.cu")], check=True, timeout=600)
    text = subprocess.run([tool, "-sass", str(obj)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return {fn: {"instructions": n, "quarter_rate": slow}
            for fn, (n, slow) in sass_counts(text, "adam8_update").items()}


def device_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device ms per call: ``calls`` back-to-back calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def k5_counters():
    from lako_tpu_torch.ops import adam8_kernel as k5

    return [f for f in (getattr(k5, "fused_adam8_update_leaves", None), k5.fused_adam8_update)
            if f is not None]


def path_grads(dev, seed: int = 0, vocab: int = VOCAB):
    """Random f32 gradients at the shapes of every parameter of the training
    path's t5-large at a vocabulary of ``vocab``, keyed by the train state's
    paths."""
    from lako_tpu_torch.core.config import t5_config_for_size
    from lako_tpu_torch.models.t5 import jax_param_paths
    from lako_tpu_torch.models.t5.model import FiDT5

    cfg = t5_config_for_size("large", vocab_size=vocab, dropout_rate=0.0,
                             use_flash_attention=True)
    with torch.device("meta"):
        model = FiDT5(cfg)
    paths = jax_param_paths(model)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {paths[n]: torch.randn(p.shape, generator=gen, device=dev) * 1e-3
            for n, p in model.named_parameters()}


def measure_path(dev) -> dict:
    from lako_tpu_torch.train.optim8 import scale_by_adam_8bit

    grads = path_grads(dev)
    tx = scale_by_adam_8bit()
    state = tx.init(grads)
    _, state = tx.update(grads, state)       # a mid-training state, and warm
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        tx.update(grads, state)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    before = sum(f.launches for f in k5_counters())
    start.record()
    u, new = tx.update(grads, state)
    end.record()
    torch.cuda.synchronize()
    launches = sum(f.launches for f in k5_counters()) - before
    n_bytes = sum(t.numel() * t.element_size() for t in (
        *grads.values(), *u.values(),
        *(x for m in (*state.mu.values(), *state.nu.values(), *new.mu.values(),
                      *new.nu.values()) for x in m)))
    del u, new
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        tx.update(grads, state)
        torch.cuda.synchronize()
    # self_device_time_total, named self_cuda_time_total before torch 2.4
    kernel_us = sum(getattr(e, "self_device_time_total", None)
                    if hasattr(e, "self_device_time_total") else e.self_cuda_time_total
                    for e in prof.key_averages())
    return {"path_leaves": len(grads), "path_elements": sum(g.numel() for g in grads.values()),
            "path_wall_ms": sorted(walls)[2], "path_wall_runs": walls,
            "path_event_ms": start.elapsed_time(end), "path_kernel_ms": kernel_us / 1e3,
            "path_k5_launches": launches, "path_bytes": n_bytes,
            "path_bytes_bound_ms": n_bytes / PEAK_BYTES * 1e3}


def k3_served(dev) -> torch.Tensor:
    """K3 at the served shape (8, 16, 64, 260), inputs from numpy seed 0."""
    from lako_tpu_torch.ops.decode_cross_attn import fused_decode_cross_attention

    rng = np.random.default_rng(0)
    B, h, d, K = 8, 16, 64, 260
    to = lambda a, t: torch.from_numpy(a).to(dev, t)  # noqa: E731
    q = to(rng.normal(size=(B, h, d)).astype(np.float32), torch.bfloat16)
    kv = [to(rng.integers(-127, 128, (B, h, d, K)).astype(np.int8), torch.int8)
          for _ in range(2)]
    sc = [to((rng.random((B, h, d)) * 0.02 + 0.002).astype(np.float32), torch.float32)
          for _ in range(2)]
    mask = rng.random((B, K)) < 0.7
    mask[:, 0] = True
    bias = to(np.where(mask, 0.0, -1e9).astype(np.float32)[:, None, :], torch.float32)
    out = fused_decode_cross_attention(q, kv[0], sc[0], kv[1], sc[1], bias)
    torch.cuda.synchronize()
    return out.cpu()


def run(out_path: str, k3_path: str) -> dict:
    from lako_tpu_torch.bench.adam8_micro import make_inputs
    from lako_tpu_torch.ops.adam8_kernel import fused_adam8_update

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    result = {"tree": str(Path.cwd()), "card": smi}
    g, mq, ms, vq, vs = make_inputs(MICRO, dev)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-6, correct_bias=False, stochastic_round=True,
                 seed=7, leaf_salt=0)
    result["k5_micro_ms"] = device_ms(lambda: fused_adam8_update(g, mq, ms, vq, vs, 3, **hyper))
    del g, mq, ms, vq, vs
    result.update(measure_path(dev))
    result["k5_sass"] = k5_sass()
    torch.save(k3_served(dev), k3_path)
    result["k3_out"] = k3_path
    if not all(math.isfinite(v) for k, v in result.items() if k.endswith("_ms")):
        raise AssertionError(f"a time is not finite: {result}")
    Path(out_path).write_text(json.dumps(result))
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out")
    parser.add_argument("--k3-out")
    parser.add_argument("--same", nargs=2, metavar="K3_OUT")
    args = parser.parse_args()
    if args.same:
        a, b = (torch.load(p) for p in args.same)
        same = bool(torch.equal(a, b))
        print(json.dumps({"k3_served_bitwise_equal": same, "files": args.same,
                          "max_abs_diff": float((a - b).abs().max())}))
        return 0 if same else 1
    if not torch.cuda.is_available():
        print("tree_compare: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(run(args.out, args.k3_out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
