#!/usr/bin/env python3
"""Smoke test of the PyTorch port (lako_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit, torch's device name).
2. Builds the CUDA kernels from ``lako_tpu_torch/csrc`` with nvcc and, beside
   the build, prints the registers and spill bytes ptxas reports for each
   kernel of ``PTXAS_SOURCES`` (K1, K4, the streamed backward, K3, K5/K6),
   and K5's SASS instruction count (cuobjdump -sass).
3. Checks each kernel against its plain PyTorch version on the card, at the
   main path's shapes and in its working types, and times the kernel, the
   plain version and, where one exists, the one PyTorch call that computes
   the same function (``library_ms``; scaled_dot_product_attention with a
   float mask for the attention kernels), with CUDA graphs of back-to-back
   calls (device time per call, warm L2). Beside each time it computes the
   bound: the larger of the bytes moved over 3.35 TB/s and the operations
   over the type's peak (H100 SXM data sheet).
   K1 streamed attention and its backward K2a/K2b/K2c (directly and through
   the autograd Function; dq and drel bitwise equal in a second launch); K3
   int8 decode cross-attention at the served shape, at B=128 and at 25,000
   keys (bitwise equal in a second launch, scaled_dot_product_attention on
   bf16 K/V of the same shape printed as the native-KV read), and at head
   dims 320 and 512 (not timed); K4
   whole-block attention with a dense bias (full and broadcast, fully masked
   rows, 512 keys, and 1024 keys through its two-pass tier against
   scaled_dot_product_attention); achieved GB/s beside K1, K2a, K2b, K2c, K3
   and K4; K1 and K2a timed again at L = Lk = 512 against
   scaled_dot_product_attention (the shape where the JAX default
   flash_min_length=512 sends the encoder to K1); K5
   the one-pass 8-bit Adam update (codes, scales and u bitwise equal to the
   plain version, both bias corrections: one leaf at a t5-large embedding
   leaf, a dense kernel leaf and the JAX package's micro shape, timed at the
   micro shape; one launch over a tree of odd leaves; one launch over the
   training path's 509 leaves, each in its routed order, timed there and
   bounded by K5_OPS, its operation model, or its bytes); K6 its
   requantization-free fragment.
4. Floor proof: the port of the JAX package's 8-bit Adam micro-benchmark
   (``lako_tpu_torch.bench.adam8_micro``) times K5, K6 and the plain
   bf16-moment Adam update at the micro shape and prints the share of K5's
   time that the requantization takes.
5. Serving path: 20 requests through ``LakoService`` at the full width of
   t5-large (random weights from a seeded generator, bf16, int8 cross K/V,
   decode cross-attention through K3), one more over HTTP, first with the
   encoder on the streamed kernel K1 (flash_min_length=128), then on the
   whole-block kernel K4 (the default flash_min_length=512 > L=130, where
   the JAX package takes its fused Pallas kernel); each time checks that
   each kernel was launched the expected number of times, and that the
   greedy tokens, the next token under teacher forcing and the encoder
   states agree with the no-kernel service. Greedy decode runs its token
   loop as CUDA graphs (a prefill step, then captured chunks replayed).
   Decode modes, the same 20 requests on the streamed route: full-length
   and chunked (``decode_chunk_size=16``) service, each as CUDA graphs and
   as the eager loop, tokens identical to the served run and graphs to
   eager, the chunks each batch ran and the wrapper counts of K1 and K3 in
   the chunked run; a step's device time (CUDA events around the replay of the
   48-step graph) and a chunk's dispatch beyond its device time (host clock
   around a replay and the all-done read), the two numbers of
   ``engine.py``'s chunking cost model; ``engine_policy="auto"`` at
   occupancy 1 and 8 and its decisions; ``weights_dtype="int8"`` and
   ``kv_dtype="int8mxu"`` against native K/V and weights, held to the JAX
   package's bounds; beam-4 through ``LakoService``, and at 2 decoder
   layers of t5-large width in float32 its tokens against
   ``beam_generate`` (the layer-unrolled beam search); answers/s of each
   run.
6. Training path, at t5-large width (B=8, N=2, L=130, remat), on each of
   the two encoder routes:
   a. one train step's loss and gradients with the kernels against the
      same step without them, in float32 and in bfloat16 (bf16 gradients
      held to the float32 ones, no further than the plain bf16 run), the
      relative-position embedding's gradient included;
   b. (whole-block route) AdamW8bit updates of every parameter tensor from
      the same gradients, K5 once an update against the plain per-leaf
      versions in the same routing, both bias corrections; one update's
      device and wall time;
   c. ``train_reader`` for 2 epochs on a synthetic fixture with an eval at
      the end of each (AdamW on the streamed route, AdamW8bit on the
      whole-block route): the loss falls, EM is in [0, 1], the history has
      the JAX package's keys, and each kernel ran as often as expected;
   d. train-step examples/s with the kernels and without, and AdamW against
      AdamW8bit with its peak device memory (host clock, synchronized,
      first step excluded).
7. Reader pipeline, at t5-large width on the streamed route with AdamW8bit,
   through ``lako_tpu_torch.pipeline.cli.main`` in this process:
   ``build-tokenizer``; ``train-reader`` for 2 epochs with checkpoints and a
   profiler trace of steps 3-5 (the trace holds K1, K2a/K2b/K2c and K5; the
   wrapper counts are the 24 steps' and the evals'; ``last`` and ``latest``
   written, ``best_dev`` if and only if an epoch's EM beat 0; each save's GB
   and seconds); ``last`` loaded into fresh templates, params, 8-bit codes
   and scales bitwise the trained state's (GB/s of the load); a full resume
   and a warm start for 1 epoch (final steps 36 and 12); ``eval-reader
   --write-results --write-crossattention-scores`` (the JAX stage's keys,
   finite fact scores, each example's summing to 1 within 1e-5);
   ``make_generate_and_score_fn`` on the first eval batch against
   ``make_best_generate_fn``'s tokens and the numpy aggregation of its
   step-0 logits (rtol 1e-5); ``eval-reader`` answers/s over the 96 training
   examples with and without score capture.
8. After every timed phase, under torch.profiler: a new chunked service
   serves the 20 requests; the kernel wrappers' counts (the launches a
   capture records count once, a replay calls no wrapper) and the K3
   kernels that ran on the card, graph replays included, each against the
   count the batches' chunks imply; then the kernels of one decode step.
9. Prints the kernel summary as one JSON line, the nvidia-smi line again,
   and last ``{"ok": true, "device": {...}}``.

Any failure raises, so the exit code is not 0. Without a CUDA device it exits
with code 2 before printing any result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import importlib.util
import io
import json
import logging
import math
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from lako_tpu_torch.bench.tree_compare import PEAK_BYTES, device_ms, path_grads, sass_counts

SEED = 0
K1_TOL = dict(bf16=(6e-2, 5e-3), f32=(2e-4, 1e-5))   # (max abs, mean abs)
K3_TOL = 1e-5                                        # max abs and rel, f32 out
# K2: f32 max abs error on dq/dk/dv, drel's max error over its max (the JAX
# package's bound); bf16: max error over max magnitude, for all four
K2_TOL = dict(f32=(2e-4, 3e-3), bf16=3e-2)
# one train step, kernels vs plain attention: (loss relative error, worst
# per-tensor ||g_kernel - g_plain|| / ||g_plain||; float32 only)
STEP_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (1e-2, None)}
# bf16 gradients against the f32 plain ones: the kernel run's error at most
# this multiple of the plain bf16 run's
BF16_NOISE_RATIO = 1.5
TRAIN_EXAMPLES, EVAL_EXAMPLES, TRAIN_EPOCHS = 96, 8, 2
TIMED_STEPS = 5
TOKEN_AGREEMENT_MIN = 0.9
ENCODER_REL_ERR_MAX = 5e-2                           # bf16 through 24 layers
EMBEDDING_SCALE = 0.02
K5_DRAWS = (1, 7)                                    # step counts of the K5 checks
ADAM8_MICRO = (179_688, 256)                         # scripts/bench_adam8_micro.py
# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W): memory
# bytes/s (tree_compare.PEAK_BYTES), and operations/s by type ("f32" =
# CUDA-core float32)
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}
# K6's operations per element, counted in csrc/adam8.cu: ~16 float and ~6
# integer, bounded at the f32 peak
K6_OPS = 22
# K5's operation model: per element, what the bit-exact function needs, by
# the pipe that issues it, at that pipe's rate per SM per clock at compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instructions)
K5_OPS = {
    # fp32 add/mul/FMA: m dequant 1, v dequant 4 (2^-(q/8)'s fraction 2 and
    # exponent 1, the scale 1), the EMAs 5, u's square root 3 and division 3
    # (the Newton steps around MUFU) and + eps 1, m's requantization 6
    # (quotient and correction 3, fraction, dither scale, +1), v's 10
    # (log2 polynomial 5, difference and x8 2, fraction, dither scale, +1)
    "fp32": 33,
    # int32 arithmetic and logic, fp32 compare/min/max: v's code fields,
    # exponent, three selects and zero test 9; the two hashes 8 each; the
    # log2 fields 4 and zero tests 4; packing 2; |m| and v maxima 2; the two
    # dither compares and clamps 6
    "alu": 43,
    # conversions and MUFU: m's code byte, u's rsqrt and rcp, per moment a
    # floor, a dither and a code conversion, and log2's exponent
    "conv": 10,
    # shuffles: two 5-step row reductions per 256 elements
    "shfl": 10 / 256,
}
PIPE_RATE = {"fp32": 128, "alu": 64, "conv": 16, "shfl": 32}
SMS = 132
ANIMALS = ["cat", "dog", "cow", "duck", "frog", "bee", "owl", "wolf", "horse", "goat"]
SOUNDS = ["meow", "woof", "moo", "quack", "croak", "buzz", "hoot", "howl", "neigh", "bleat"]


# the sources whose kernels' registers and spills the run reports (ptxas -v)
# the name of K3's kernel function (csrc/decode_cross_attn.cu) in a profiler trace
K3_KERNEL = "decode_cross_kernel"
PTXAS_SOURCES = ("flash_streamed_fwd.cu", "fused_attention.cu", "flash_streamed_bwd.cu",
                 "decode_cross_attn.cu", "adam8.cu")


def log(*args) -> None:
    print(*args, flush=True)


def start_ptxas(build):
    """``nvcc -Xptxas -v`` on PTXAS_SOURCES, one process each, started beside
    the library's build; ptxas_report reads them."""
    nvcc = build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    out = build.BUILD_DIR / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    return [(src, subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(out / f"{src}.o"),
         str(build.CSRC_DIR / src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in PTXAS_SOURCES]


def ptxas_report(procs, nvcc_dir) -> None:
    """Each kernel's registers and spill bytes as ptxas reported them."""
    filt = shutil.which("cu++filt", path=str(nvcc_dir)) or shutil.which("c++filt")
    for src, proc in procs:
        text = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v {src} failed:\n{text}")
        entry, spills = None, (0, 0)
        for line in text.splitlines():
            if m := re.search(r"Compiling entry function '(\w+)'", line):
                entry, spills = m.group(1), (0, 0)
                if filt:
                    entry = subprocess.run([filt, entry], capture_output=True, text=True,
                                           timeout=60).stdout.strip()
                entry = entry.split(">(")[0] + ">" if ">(" in entry else entry
            elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
                spills = (int(m.group(1)), int(m.group(2)))
            elif (m := re.search(r"Used (\d+) registers", line)) and entry:
                log(f"  ptxas {src}: {entry}: {m.group(1)} registers, spill stores "
                    f"{spills[0]} B, spill loads {spills[1]} B")
                entry = None


def event_ms(fn, calls: int = 5) -> float:
    """Device time per call of a function too slow for a CUDA graph to help:
    ``calls`` calls between CUDA events, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, ops: float, kind: str):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the memory rate and the operations over the peak."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES * 1e3, ops / PEAK_OPS[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def k5_bound(n_bytes: float, elements: float, sm_mhz: float):
    """(bound_ms, bound_by, detail) of K5: the larger of the bytes over the
    memory rate and K5_OPS on the SMs at sm_mhz, where the ops take the
    larger of their busiest pipe and the issue slots (one instruction a
    clock on each of an SM's 4 schedulers: 128 lanes a clock)."""
    per_pipe = {p: n / PIPE_RATE[p] for p, n in K5_OPS.items()}
    issue = sum(K5_OPS.values()) / 128
    clocks = max(issue, *per_pipe.values())        # per element, on one SM
    by_ops = elements * clocks / SMS / (sm_mhz * 1e6) * 1e3
    by_bytes = n_bytes / PEAK_BYTES * 1e3
    detail = (f"ops {by_ops:.4f} ms ({clocks:.3f} SM clocks an element: "
              + ", ".join(f"{p} {c:.3f}" for p, c in per_pipe.items())
              + f", issue {issue:.3f}; {SMS} SMs at {sm_mhz:.0f} MHz), bytes {by_bytes:.4f} ms")
    return (by_bytes, "bytes", detail) if by_bytes >= by_ops else (by_ops, "operations", detail)


def entry(name, source, replaces, max_err, kern, plain, n_bytes, ops, kind, library,
          bound_ms=None, bound_by=None):
    if bound_ms is None:
        bound_ms, bound_by = bound(n_bytes, ops, kind)
    log(f"  {name}: bound {bound_ms:.4f} ms by {bound_by} ({n_bytes / 1e6:.1f} MB, "
        f"{ops / 1e9:.3f} G {'elements' if kind == 'k5' else 'operations'}), kernel "
        f"{kern / bound_ms:.1f}x the bound; "
        f"library call " + ("none" if library is None else f"{library:.4f} ms"))
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": max_err, "ms": kern, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library}


def dense_bias(rel, mask, dtype=torch.float32):
    """The (B,H,L,Lk) additive bias a dense-mask call needs: rel + -1e9 at
    masked keys."""
    return (rel[None] + torch.where(mask[:, None, None, :], 0.0, -1e9)).to(dtype).contiguous()


def sdpa(q, k, v, bias):
    """The library call: unscaled attention with a float mask."""
    return F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=1.0)


def compare(name, out, ref, max_tol, mean_tol=None):
    err = (out.float() - ref.float()).abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    finite = bool(torch.isfinite(out.float()).all())
    ok = finite and max_err <= max_tol and (mean_tol is None or mean_err <= mean_tol)
    log(f"  {name}: max_abs_err={max_err:.3e} mean_abs_err={mean_err:.3e} "
        f"tol max={max_tol:g}" + (f" mean={mean_tol:g}" if mean_tol else "")
        + f" finite={finite} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return max_err


def attn_inputs(gen, dev, B, H, L, Lk, D, dtype, masked_rows=0):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # q at the scale T5's init gives it (std d_kv**-0.5): logits ~N(0, 1)
    q = (rnd(B, H, L, D) * D ** -0.5).to(dtype)
    k, v = (rnd(B, H, Lk, D).to(dtype) for _ in range(2))
    rel = rnd(H, L, Lk) * 0.5
    mask = torch.rand(B, Lk, generator=gen, device=dev) < 0.6
    mask[:, 0] = True
    if masked_rows:
        mask[B - masked_rows:] = False   # padding rows of collate(pad_to=B)
    return q, k, v, rel, mask


def check_streamed(dev):
    from lako_tpu_torch.ops import flash_streamed as k1

    log("K1 streamed_attention (csrc/flash_streamed_fwd.cu) vs plain:")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}
    cases = [("(16,16,130,64) bf16, 4 fully masked rows", (16, 16, 130, 130, 64), torch.bfloat16, 4),
             ("(16,16,130,64) f32, 4 fully masked rows", (16, 16, 130, 130, 64), torch.float32, 4),
             ("(3,2,300,64) Lk=330 bf16", (3, 2, 300, 330, 64), torch.bfloat16, 1),
             ("(2,4,130,128) bf16", (2, 4, 130, 130, 128), torch.bfloat16, 1)]
    for label, shape, dtype, masked in cases:
        args = attn_inputs(gen, dev, *shape, dtype, masked)
        out = k1.streamed_attention(*args)
        ref = k1.streamed_attention_reference(*args)
        torch.cuda.synchronize()
        tol = K1_TOL["bf16" if dtype == torch.bfloat16 else "f32"]
        results[label] = (compare(label, out, ref, *tol), args)
    label = cases[0][0]
    max_err, args = results[label]
    q, k, v, rel, mask = args
    bias = dense_bias(rel, mask, q.dtype)
    plain = device_ms(lambda: k1.streamed_attention_reference(*args))
    kern = device_ms(lambda: k1.streamed_attention(*args))
    library = device_ms(lambda: sdpa(q, k, v, bias))
    plain = (plain + device_ms(lambda: k1.streamed_attention_reference(*args))) / 2
    n_bytes = nbytes(*args, q)
    log(f"  time at {label}: kernel {kern:.4f} ms ({n_bytes / kern / 1e6:.0f} GB/s achieved, "
        f"{n_bytes / 1e6:.1f} MB), plain {plain:.4f} ms, scaled_dot_product_attention with "
        f"the dense bf16 bias {library:.4f} ms (device time per call, CUDA graph of 20 calls)")
    B, H, L, D = q.shape
    return entry("streamed_attention", "lako_tpu_torch/csrc/flash_streamed_fwd.cu",
                 "lako_tpu/ops/flash_streamed.py:173", max_err, kern, plain,
                 n_bytes, 4 * B * H * L * k.shape[2] * D, "bf16", library)


def check_streamed_long(dev):
    """K1 and K2a at (16,16,512,64) bf16, where the JAX default
    flash_min_length=512 sends the encoder to K1: each against its plain
    version, then timed beside scaled_dot_product_attention (its forward for
    K1, its whole backward for K2a), with the bound computed as for the main
    rows. Logged only; the summary line keeps the main path's shapes."""
    from lako_tpu_torch.ops import flash_streamed as k1

    label = "(16,16,512,64) bf16, 4 fully masked rows"
    log(f"K1 and K2a at L = Lk = 512, {label}:")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    q, k, v, rel, mask = attn_inputs(gen, dev, 16, 16, 512, 512, 64, torch.bfloat16, 4)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    fwd_args = (q, k, v, rel, mask)
    out, stats = k1.streamed_attention_fwd_reference(*fwd_args)
    args = (q, k, v, rel, mask, stats, (dout.float() * out.float()).sum(-1), dout)
    compare(f"K1 at {label}", k1.streamed_attention(*fwd_args),
            k1.streamed_attention_reference(*fwd_args), *K1_TOL["bf16"])
    got, want = k1.streamed_attention_bwd_dkdv(*args), k1.streamed_attention_bwd_dkdv_reference(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dk", "dv"), got, want):
        err, scale = float((a.float() - b.float()).abs().max()), float(b.float().abs().max())
        ok = err <= K2_TOL["bf16"] * scale and bool(torch.isfinite(a.float()).all())
        log(f"  K2a {name} at {label}: max_abs_err={err:.3e} (max |plain| {scale:.3e}) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K2a {name} disagrees with its plain version at {label}")
    del got, want, out
    bias = dense_bias(rel, mask, q.dtype)
    leaves = [q.clone().requires_grad_(), k.clone().requires_grad_(),
              v.clone().requires_grad_(), bias.clone().requires_grad_()]
    k1_ms = device_ms(lambda: k1.streamed_attention(*fwd_args))
    sdpa_ms = device_ms(lambda: sdpa(q, k, v, bias))
    k2a_ms = device_ms(lambda: k1.streamed_attention_bwd_dkdv(*args))
    sdpa_bwd_ms = (device_ms(lambda: torch.autograd.grad(sdpa(*leaves), leaves, dout))
                   - device_ms(lambda: sdpa(*leaves)))
    B, H, L, D = q.shape
    work = B * H * L * k.shape[2] * D
    for name, ms, lib, n_bytes, ops in (
            ("K1", k1_ms, f"scaled_dot_product_attention {sdpa_ms:.4f} ms", nbytes(*fwd_args, q),
             4 * work),
            ("K2a", k2a_ms, f"the backward of scaled_dot_product_attention {sdpa_bwd_ms:.4f} ms",
             nbytes(*args, k, v), 8 * work)):
        bound_ms, bound_by = bound(n_bytes, ops, "bf16")
        log(f"  {name} at {label}: kernel {ms:.4f} ms ({n_bytes / ms / 1e6:.0f} GB/s achieved, "
            f"{n_bytes / 1e6:.1f} MB), {lib}; bound {bound_ms:.4f} ms by {bound_by} "
            f"({ops / 1e9:.3f} G operations), kernel {ms / bound_ms:.1f}x the bound "
            f"(device time per call, CUDA graph of 20 calls)")


def compare_bwd(label, got, want, dtype):
    """K2's outputs against their plain versions under K2_TOL; returns the
    max abs errors (dq, dk, dv, drel)."""
    errs = []
    for name, a, b in zip(("dq", "dk", "dv", "drel"), got, want):
        err = float((a.float() - b.float()).abs().max())
        scale = float(b.float().abs().max())
        if dtype == torch.float32:
            ok = err <= (K2_TOL["f32"][1] * scale if name == "drel" else K2_TOL["f32"][0])
        else:
            ok = err <= K2_TOL["bf16"] * scale
        ok = ok and bool(torch.isfinite(a.float()).all()) and a.shape == b.shape
        log(f"    {label} {name}: max_abs_err={err:.3e} (max |plain| {scale:.3e}) "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K2 {name} disagrees with its plain version at {label}")
        errs.append(err)
    return errs


def check_streamed_bwd(dev):
    from lako_tpu_torch.ops import flash_streamed as k1

    log("K2a/K2b/K2c streamed backward (csrc/flash_streamed_bwd.cu) vs plain, directly "
        "and through the autograd Function (K1 with statistics, then K2):")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    cases = [("(16,16,130,64) bf16, 4 fully masked rows", (16, 16, 130, 130, 64), torch.bfloat16, 4),
             ("(16,16,130,64) f32, 4 fully masked rows", (16, 16, 130, 130, 64), torch.float32, 4),
             ("(3,2,300,64) Lk=330 bf16", (3, 2, 300, 330, 64), torch.bfloat16, 1),
             ("(3,2,300,64) Lk=330 f32", (3, 2, 300, 330, 64), torch.float32, 1),
             ("(2,4,130,128) bf16", (2, 4, 130, 130, 128), torch.bfloat16, 1),
             ("(2,4,130,128) f32", (2, 4, 130, 130, 128), torch.float32, 1)]
    first = None
    for label, shape, dtype, masked in cases:
        q, k, v, rel, mask = attn_inputs(gen, dev, *shape, dtype, masked)
        dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
        out, stats = k1.streamed_attention_fwd_reference(q, k, v, rel, mask)
        dvec = (dout.float() * out.float()).sum(-1)
        args = (q, k, v, rel, mask, stats, dvec, dout)
        dk, dv = k1.streamed_attention_bwd_dkdv(*args)
        got = (k1.streamed_attention_bwd_dq(*args), dk, dv, k1.streamed_attention_bwd_drel(*args))
        torch.cuda.synchronize()
        want = k1.streamed_attention_bwd_reference(q, k, v, rel, mask, out, stats, dout)
        errs = compare_bwd(f"{label}, direct", got, want, dtype)
        again = (k1.streamed_attention_bwd_dq(*args), k1.streamed_attention_bwd_drel(*args))
        torch.cuda.synchronize()
        same = [bool(torch.equal(a, b)) for a, b in zip((got[0], got[3]), again)]
        log(f"    {label} dq and drel bitwise equal in a second launch: {same}")
        if not all(same):
            raise AssertionError(f"K2b or K2c is not repeatable at {label}")
        leaves = [t.clone().requires_grad_() for t in (q, k, v, rel)]
        got = torch.autograd.grad(k1.streamed_attention(*leaves, mask), leaves, dout)
        torch.cuda.synchronize()
        compare_bwd(f"{label}, autograd", got, want, dtype)
        if first is None:
            first = (errs, args, leaves, mask, dout)

    errs, args, leaves, mask, dout = first
    plains = {"dkdv": k1.streamed_attention_bwd_dkdv_reference,
              "dq": k1.streamed_attention_bwd_dq_reference,
              "drel": k1.streamed_attention_bwd_drel_reference}
    kernels = {"dkdv": k1.streamed_attention_bwd_dkdv, "dq": k1.streamed_attention_bwd_dq,
               "drel": k1.streamed_attention_bwd_drel}
    times = {}
    for name in kernels:   # plain, kernel, kernel, plain
        plain = device_ms(lambda: plains[name](*args))
        kern = device_ms(lambda: kernels[name](*args))
        kern = (kern + device_ms(lambda: kernels[name](*args))) / 2
        plain = (plain + device_ms(lambda: plains[name](*args))) / 2
        times[name] = (kern, plain)
        log(f"  time of {name} at (16,16,130,64) bf16: kernel {kern:.4f} ms, its plain "
            f"version {plain:.4f} ms (device time per call, CUDA graph of 20 calls)")
    for name, written in (("dkdv", nbytes(args[1], args[2])), ("dq", nbytes(args[0])),
                          ("drel", nbytes(args[3]))):
        moved = nbytes(*args) + written
        log(f"  {name}: {moved / times[name][0] / 1e6:.0f} GB/s achieved ({moved / 1e6:.1f} MB)")

    def k2_all():
        for fn in kernels.values():
            fn(*args)

    def plain_fwd():
        return k1.streamed_attention_reference(*leaves, mask)

    def plain_fwd_bwd():
        torch.autograd.grad(plain_fwd(), leaves, dout)

    def kernel_fwd_bwd():
        torch.autograd.grad(k1.streamed_attention(*leaves, mask), leaves, dout)

    q, k, v, rel = (t.detach() for t in leaves)
    lib_leaves = [q.clone().requires_grad_(), k.clone().requires_grad_(),
                  v.clone().requires_grad_(), dense_bias(rel, mask, q.dtype).requires_grad_()]

    def library_fwd():
        return sdpa(*lib_leaves)

    def library_fwd_bwd():
        torch.autograd.grad(library_fwd(), lib_leaves, dout)

    fwd = device_ms(plain_fwd)
    both = device_ms(plain_fwd_bwd)
    k2 = device_ms(k2_all)
    k_both = device_ms(kernel_fwd_bwd)
    library = device_ms(library_fwd_bwd) - device_ms(library_fwd)
    log(f"  K2a+K2b+K2c {k2:.4f} ms vs the plain autograd backward {both - fwd:.4f} ms "
        f"(plain forward+backward {both:.4f} ms less its forward {fwd:.4f} ms); forward+"
        f"backward through the Function (K1 with statistics + K2) {k_both:.4f} ms; the "
        f"backward of scaled_dot_product_attention (dq, dk, dv and the bias gradient) "
        f"{library:.4f} ms")
    B, H, L, D = q.shape
    work = B * H * L * k.shape[2] * D
    reads = nbytes(*args)
    entries = []
    for name, idx, replaces, writes, ops in (
            ("dkdv", (1, 2), ":289", nbytes(k, v), 8 * work),
            ("dq", (0,), ":319", nbytes(q), 6 * work),
            ("drel", (3,), ":344", nbytes(rel), 4 * work)):
        entries.append(entry(f"streamed_attention_bwd_{name}",
                             "lako_tpu_torch/csrc/flash_streamed_bwd.cu",
                             f"lako_tpu/ops/flash_streamed.py{replaces}",
                             max(errs[i] for i in idx), times[name][0], times[name][1],
                             reads + writes, ops, "bf16", library))
    return entries


def check_decode_cross(dev):
    """K3 at the served shape (8,16,64,260), at B=128 and at a long K past the
    parent's ~12,160-key limit: against its plain version, bitwise the same in
    a second launch, timed beside its bound and, at each shape, beside
    scaled_dot_product_attention on bf16 K/V of the same shape (the read of a
    native-KV decode step, printed as a reference; K3's library row stays
    none). Returns the summary entry of the served shape."""
    from lako_tpu_torch.models.t5.engine import _quantize_kv
    from lako_tpu_torch.ops import decode_cross_attn as k3

    log("K3 fused_decode_cross_attention (csrc/decode_cross_attn.cu) vs plain:")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    timed = {}
    h, d = 16, 64
    for B, K in ((8, 260), (128, 260), (2, 25_000)):
        q = torch.randn(B, h, d, generator=gen, device=dev).to(torch.bfloat16)
        kf = torch.randn(B, h, d, K, generator=gen, device=dev)
        vf = torch.randn(B, h, d, K, generator=gen, device=dev)
        ck, cv = _quantize_kv(kf), _quantize_kv(vf)
        mask = torch.rand(B, K, generator=gen, device=dev) < 0.7
        mask[:, 0] = True
        bias = torch.where(mask, 0.0, -1e9)[:, None, :].float().contiguous()
        args = (q, ck.values, ck.scale, cv.values, cv.scale, bias)
        out = k3.fused_decode_cross_attention(*args)
        again = k3.fused_decode_cross_attention(*args)
        ref = k3.reference(*args)
        torch.cuda.synchronize()
        label = f"({B},16,64,{K}) q bf16, int8 K/V"
        err = compare(label, out, ref, K3_TOL)
        torch.testing.assert_close(out, ref, rtol=K3_TOL, atol=K3_TOL)
        same = bool(torch.equal(out, again))
        log(f"  {label}: bitwise equal in a second launch: {same}")
        if not same:
            raise AssertionError(f"K3 is not repeatable at {label}")
        if B == 8:    # as the decode engine runs it: captured in a CUDA graph, replayed
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                replayed = k3.fused_decode_cross_attention(*args)
            graph.replay()
            torch.cuda.synchronize()
            same = bool(torch.equal(replayed, out))
            log(f"  {label}: bitwise equal replayed from a CUDA graph: {same}")
            if not same:
                raise AssertionError(f"K3 differs in a CUDA graph at {label}")
            del graph, replayed
        # the native-KV decode's read: bf16 K/V (B,h,K,d), one query row
        q4 = q[:, :, None, :]
        k16, v16 = (t.transpose(2, 3).to(torch.bfloat16).contiguous() for t in (kf, vf))
        mask16 = bias[:, :, None, :].to(torch.bfloat16)
        del kf, vf
        plain = device_ms(lambda: k3.reference(*args))
        kern = device_ms(lambda: k3.fused_decode_cross_attention(*args))
        native = device_ms(lambda: sdpa(q4, k16, v16, mask16))
        kern = (kern + device_ms(lambda: k3.fused_decode_cross_attention(*args))) / 2
        plain = (plain + device_ms(lambda: k3.reference(*args))) / 2
        n_bytes, ops = nbytes(*args, out), 4 * B * h * d * K
        bound_ms, bound_by = bound(n_bytes, ops, "bf16")
        log(f"  time at {label}: kernel {kern:.4f} ms ({n_bytes / kern / 1e6:.0f} GB/s achieved, "
            f"{n_bytes / 1e6:.1f} MB), {kern / bound_ms:.1f}x its bound {bound_ms:.4f} ms by "
            f"{bound_by}; plain {plain:.4f} ms; for reference, not K3's library call: "
            f"scaled_dot_product_attention on bf16 K/V of the same shape {native:.4f} ms "
            f"({nbytes(q4, k16, v16, mask16) / 1e6:.1f} MB) (device time per call, CUDA graph "
            f"of 20 calls)")
        timed[B, K] = (err, kern, plain, n_bytes, ops)
        del args, ck, cv, k16, v16, out, again, ref
    for d in (320, 512):   # past 16 warps of 16 rows: row groups, a ring that follows d
        q = torch.randn(8, 4, d, generator=gen, device=dev).to(torch.bfloat16)
        ck, cv = (_quantize_kv(torch.randn(8, 4, d, 260, generator=gen, device=dev))
                  for _ in range(2))
        bias = torch.where(torch.rand(8, 260, generator=gen, device=dev) < 0.7, 0.0,
                           -1e9)[:, None, :].float().contiguous()
        bias[..., 0] = 0.0
        args = (q, ck.values, ck.scale, cv.values, cv.scale, bias)
        out = k3.fused_decode_cross_attention(*args)
        ref = k3.reference(*args)
        torch.cuda.synchronize()
        # logits grow as sqrt(d): both float32 orders are held to float64
        kf, vf = (c.values.double() * c.scale.double() for c in (ck, cv))
        p = torch.softmax(torch.einsum("bhd,bhdk->bhk", q.double(), kf) + bias.double(), -1)
        exact = torch.einsum("bhk,bhdk->bhd", p, vf)
        err = float((out.double() - exact).abs().max())
        plain_err = float((ref.double() - exact).abs().max())
        ok = err <= K3_TOL + 2 * plain_err
        log(f"  (8,4,{d},260) q bf16, int8 K/V (head dim {d}): max abs error against float64 "
            f"{err:.3e}, the plain float32 version's {plain_err:.3e}; against plain "
            f"{float((out - ref).abs().max()):.3e}; bound {K3_TOL:g} + 2 x plain's -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K3 at head dim {d} is further from float64 than plain")
        del args, ck, cv, out, ref, kf, vf, p, exact
    err, kern, plain, n_bytes, ops = timed[8, 260]
    return entry("fused_decode_cross_attention", "lako_tpu_torch/csrc/decode_cross_attn.cu",
                 "lako_tpu/ops/decode_cross_attn.py:82", err, kern, plain, n_bytes, ops,
                 "bf16", None)


def check_fused(dev):
    from lako_tpu_torch.ops import flash_attention as k4

    log("K4 fused_attention (csrc/fused_attention.cu) vs plain:")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    cases = [("(16,16,130,64) bf16, f32 bias, 4 fully masked rows", (16, 16, 130, 130, 64),
              torch.bfloat16, 4, None),
             ("(16,16,130,64) f32, f32 bias, 4 fully masked rows", (16, 16, 130, 130, 64),
              torch.float32, 4, None),
             ("(3,2,77,64) Lk=200 bf16, broadcast (1,2,77,200) bias", (3, 2, 77, 200, 64),
              torch.bfloat16, 1, (1, 2, 77, 200)),
             ("(3,2,77,64) Lk=200 f32, broadcast (1,2,77,200) bias", (3, 2, 77, 200, 64),
              torch.float32, 1, (1, 2, 77, 200)),
             ("(2,4,130,64) Lk=512 bf16, f32 bias (logits in shared memory)",
              (2, 4, 130, 512, 64), torch.bfloat16, 1, None)]
    first = None
    for label, shape, dtype, masked, cut in cases:
        q, k, v, rel, mask = attn_inputs(gen, dev, *shape, dtype, masked)
        bias = dense_bias(rel, mask)
        if cut is not None:
            bias = bias[tuple(slice(0, n) for n in cut)].contiguous()
        out = k4.fused_attention(q, k, v, bias)
        ref = k4.fused_attention_reference(q, k, v, bias)
        torch.cuda.synchronize()
        err = compare(label, out, ref, *K1_TOL["bf16" if dtype == torch.bfloat16 else "f32"])
        if first is None:
            first = (err, q, k, v, bias)
    err, q, k, v, bias = first
    bias16 = bias.to(q.dtype)
    plain = device_ms(lambda: k4.fused_attention_reference(q, k, v, bias))
    kern = device_ms(lambda: k4.fused_attention(q, k, v, bias))
    kern = (kern + device_ms(lambda: k4.fused_attention(q, k, v, bias))) / 2
    library = device_ms(lambda: sdpa(q, k, v, bias16))
    plain = (plain + device_ms(lambda: k4.fused_attention_reference(q, k, v, bias))) / 2
    n_bytes = nbytes(q, k, v, bias, q)
    log(f"  time at {cases[0][0]}: kernel {kern:.4f} ms ({n_bytes / kern / 1e6:.0f} GB/s "
        f"achieved, {n_bytes / 1e6:.1f} MB), plain {plain:.4f} ms, "
        f"scaled_dot_product_attention with the bias in bf16 {library:.4f} ms (device time "
        f"per call, CUDA graph of 20 calls)")
    B, H, L, D = q.shape
    result = entry("fused_attention", "lako_tpu_torch/csrc/fused_attention.cu",
                   "lako_tpu/ops/flash_attention.py:81", err, kern, plain,
                   n_bytes, 4 * B * H * L * k.shape[2] * D, "bf16", library)
    check_fused_long(dev, gen)
    return result


def check_fused_long(dev, gen):
    """K4's two-pass tier at (16,16,1024,64) bf16 with a dense f32 bias:
    against its plain version, timed beside scaled_dot_product_attention and
    its bound. Logged only."""
    from lako_tpu_torch.ops import flash_attention as k4

    label = "(16,16,1024,64) bf16, f32 bias, 4 fully masked rows (the two-pass tier)"
    q, k, v, rel, mask = attn_inputs(gen, dev, 16, 16, 1024, 1024, 64, torch.bfloat16, 4)
    bias = dense_bias(rel, mask)
    compare(f"K4 at {label}", k4.fused_attention(q, k, v, bias),
            k4.fused_attention_reference(q, k, v, bias), *K1_TOL["bf16"])
    bias16 = bias.to(q.dtype)
    plain = device_ms(lambda: k4.fused_attention_reference(q, k, v, bias))
    kern = device_ms(lambda: k4.fused_attention(q, k, v, bias))
    library = device_ms(lambda: sdpa(q, k, v, bias16))
    kern = (kern + device_ms(lambda: k4.fused_attention(q, k, v, bias))) / 2
    plain = (plain + device_ms(lambda: k4.fused_attention_reference(q, k, v, bias))) / 2
    B, H, L, D = q.shape
    n_bytes, ops = nbytes(q, k, v, bias, q), 4 * B * H * L * k.shape[2] * D
    bound_ms, bound_by = bound(n_bytes, ops, "bf16")
    log(f"  K4 at {label}: kernel {kern:.4f} ms ({n_bytes / kern / 1e6:.0f} GB/s achieved, "
        f"{n_bytes / 1e6:.1f} MB), {kern / bound_ms:.1f}x its bound {bound_ms:.4f} ms by "
        f"{bound_by}; plain {plain:.4f} ms; scaled_dot_product_attention with the bias in bf16 "
        f"{library:.4f} ms (device time per call, CUDA graph of 20 calls)")


def adam8_state(gen, dev, n):
    """A mid-training 8-bit state for n elements: random codes and scales."""
    nb = -(-n // 256)
    mq = torch.randint(-127, 128, (nb, 256), generator=gen, device=dev, dtype=torch.int8)
    vq = torch.randint(0, 256, (nb, 256), generator=gen, device=dev, dtype=torch.uint8)
    ms = torch.rand(nb, 1, generator=gen, device=dev) * 1e-3
    vs = torch.rand(nb, 1, generator=gen, device=dev) * 1e-6
    return mq, ms, vq, vs


def compare_adam8(label, got, want):
    """K5's outputs against the plain version's: u, codes and scales bitwise
    (the bias corrections come from the host); returns u's max abs error."""
    same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
    log(f"  {label}: u, mq, ms, vq, vs bitwise equal {same} -> {'ok' if all(same) else 'FAIL'}")
    if not all(same):
        raise AssertionError(f"K5 disagrees with its plain version at {label}")
    return float((got[0].float() - want[0].float()).abs().max())


def compare_adam8_leaves(label, layout, got, want):
    """The multi-leaf K5 against its plain per-leaf versions: u of every leaf
    and the flat new state bitwise."""
    (us, flat), (want_us, want_flat) = got, want
    same_u = sum(bool(torch.equal(a, b)) for a, b in zip(us, want_us))
    same_state = [bool(torch.equal(a, b)) for a, b in zip(flat, want_flat)]
    ok = same_u == len(us) and all(same_state)
    jnp = sum(layout.jnp_order)
    log(f"  {label}: {len(us)} leaves in one launch ({len(us) - jnp} in the kernel's order, "
        f"{jnp} in the jnp order); u bitwise equal on {same_u}/{len(us)} leaves, the flat "
        f"state (mq, ms, vq, vs) {same_state} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K5 disagrees with its plain versions at {label}")


def adam8_tree(gen, dev, kinds):
    """(grads, flat state, layout) of K5 for leaves (shape, transposed,
    dtype, jnp order, salt): random gradients and a mid-training state."""
    from lako_tpu_torch.ops.adam8_kernel import LeafLayout

    grads = [(torch.randn(shape, generator=gen, device=dev) * 1e-3).to(dtype)
             for shape, _, dtype, _, _ in kinds]
    nbs = tuple(-(-g.numel() // 256) for g in grads)
    layout = LeafLayout(tuple(k[4] for k in kinds), tuple(k[1] for k in kinds),
                        tuple(k[3] for k in kinds), nbs)
    return grads, adam8_state(gen, dev, 256 * sum(nbs)), layout


def mixed_leaves(gen, dev):
    """A tree of odd leaves: every tier (tile, with a partial column group;
    strided; contiguous, ragged and aligned), both rounding orders, f32 and
    bf16 gradients and an empty leaf."""
    kinds = [((1024, 64), True, torch.float32, False), ((9,), False, torch.float32, True),
             ((0,), False, torch.float32, True), ((70001,), False, torch.bfloat16, True),
             ((40, 16), True, torch.float32, True), ((300, 256), False, torch.float32, False),
             ((512, 40), True, torch.bfloat16, False), ((96, 40), True, torch.bfloat16, False),
             ((4, 256), False, torch.bfloat16, True)]
    return adam8_tree(gen, dev, [(*k, 3 * i + 1) for i, k in enumerate(kinds)])


def path_leaves(gen, dev):
    """K5's leaves on the training path: random f32 gradients at the shapes of
    every parameter of the training path's t5-large (the fixture's
    vocabulary) in leaf order, each in the order scale_by_adam_8bit("auto")
    gives it on the card, with a mid-training state."""
    from lako_tpu_torch.ops.adam8_kernel import LeafLayout
    from lako_tpu_torch.train.optim8 import is_transposed, kernel_route, leaf_order

    grads = path_grads(dev, SEED + 5, train_fixture()[0].vocab_size)
    order = leaf_order(grads)
    gs = [grads[p] for p in order]
    layout = LeafLayout(tuple(range(len(order))),
                        tuple(is_transposed(p, g) for p, g in zip(order, gs)),
                        tuple(not kernel_route(g) for g in gs),
                        tuple(-(-g.numel() // 256) for g in gs))
    return gs, adam8_state(gen, dev, 256 * sum(layout.nbs)), layout


def sass_report(build, nvcc_dir) -> None:
    """The compiled K5's SASS (cuobjdump -sass of adam8.cu's object from the
    ptxas report): its instructions, the quarter-rate ones, and per element
    of a lane (the kernel inlines its row 8 times, 2 dtypes x 2 orders x 2
    tiers, 8 elements a lane each)."""
    tool = shutil.which("cuobjdump", path=str(nvcc_dir))
    if tool is None:
        log("  K5 SASS: cuobjdump not found beside nvcc; not counted")
        return
    text = subprocess.run([tool, "-sass", str(build.BUILD_DIR / "ptxas" / "adam8.cu.o")],
                          capture_output=True, text=True, timeout=300).stdout
    counts = sass_counts(text, "adam8_update_leaves_kernel")
    if not counts:
        raise AssertionError("cuobjdump -sass listed no adam8_update_leaves_kernel")
    for fn, (n, slow) in counts.items():
        log(f"  K5 SASS (cuobjdump -sass): {n} instructions, ~{n / 64:.0f} per element of a "
            f"lane over its 8 inlined rows; quarter-rate {slow}")


def check_adam8(dev, sm_mhz):
    from lako_tpu_torch.ops import adam8_kernel as k5

    log("K5 fused_adam8_update(_leaves) and K6 adam8_ema_fragment (csrc/adam8.cu) vs plain:")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-6, stochastic_round=True, seed=0x8B17)
    leaves = [("t5-large shared embedding (32128,1024) g f32", (32128, 1024), torch.float32,
               False),
              ("t5-large mlp/wi kernel (4096,1024) g f32, transposed", (4096, 1024),
               torch.float32, True),
              (f"micro {ADAM8_MICRO} g bf16", ADAM8_MICRO, torch.bfloat16, False)]
    micro = None
    for label, shape, dtype, transposed in leaves:
        g = (torch.randn(shape, generator=gen, device=dev) * 1e-3).to(dtype)
        state = adam8_state(gen, dev, g.numel())
        for count in K5_DRAWS:
            for correct in (False, True):
                args = (g, *state, count)
                kw = dict(hyper, correct_bias=correct, leaf_salt=7, transposed=transposed)
                got = k5.fused_adam8_update(*args, **kw)
                torch.cuda.synchronize()
                want = k5.fused_adam8_update_reference(*args, **kw)
                compare_adam8(f"{label}, step {count}, correct_bias={correct}", got, want)
                del got, want
        if shape == ADAM8_MICRO:
            micro = (g, state)
    mixed = mixed_leaves(gen, dev)
    for count in K5_DRAWS:
        for correct in (False, True):
            kw = dict(hyper, correct_bias=correct)
            got = k5.fused_adam8_update_leaves(*mixed, count, **kw)
            torch.cuda.synchronize()
            compare_adam8_leaves(f"mixed tree, step {count}, correct_bias={correct}", mixed[2],
                                 got, k5.fused_adam8_update_leaves_reference(*mixed, count, **kw))
    g, state = micro
    kw = dict(hyper, correct_bias=False, leaf_salt=7)
    u = k5.adam8_ema_fragment(g, *state)
    torch.cuda.synchronize()
    u_plain = k5.adam8_ema_fragment_reference(g, *state)
    k6_ok = bool(torch.equal(u, u_plain))
    k6_err = float((u.float() - u_plain.float()).abs().max())
    log(f"  K6 at {ADAM8_MICRO} g bf16: u bitwise equal to its plain version {k6_ok}")
    if not k6_ok:
        raise AssertionError("K6 disagrees with its plain version")

    def k5_call():
        return k5.fused_adam8_update(g, *state, 3, **kw)

    def k6_call():
        return k5.adam8_ema_fragment(g, *state)

    k5_ms = device_ms(k5_call)
    k6_ms = device_ms(k6_call)
    k6_plain = event_ms(lambda: k5.adam8_ema_fragment_reference(g, *state))
    k5_ms = (k5_ms + device_ms(k5_call)) / 2
    k6_ms = (k6_ms + device_ms(k6_call)) / 2
    n = g.numel()
    out5 = k5_call()
    micro_bytes = nbytes(g, *state) + nbytes(*out5)
    micro_bound, micro_by, detail = k5_bound(micro_bytes, n, sm_mhz)
    log(f"  time at {ADAM8_MICRO} g bf16 (one leaf): K5 {k5_ms:.4f} ms, {k5_ms / micro_bound:.2f}x "
        f"its bound {micro_bound:.4f} ms by {micro_by} ({detail}); K6 {k6_ms:.4f} ms (plain "
        f"{k6_plain:.4f} ms) (CUDA graph of 20 calls)")
    k6_bytes = nbytes(g, *state) + nbytes(u)
    del micro, g, state, u, u_plain, out5

    path = path_leaves(gen, dev)
    grads, state, layout = path
    elements = sum(g.numel() for g in grads)
    max_err = 0.0
    for correct in (False, True):
        kw = dict(hyper, correct_bias=correct)
        got = k5.fused_adam8_update_leaves(*path, 3, **kw)
        torch.cuda.synchronize()
        want = k5.fused_adam8_update_leaves_reference(*path, 3, **kw)
        compare_adam8_leaves(f"the training path's {len(grads)} leaves ({elements / 1e6:.1f}M "
                             f"elements, g f32), correct_bias={correct}", layout, got, want)
        max_err = max(max_err, *(float((a.float() - b.float()).abs().max())
                                 for a, b in zip(got[0], want[0]) if a.numel()))
        del got, want
    kw = dict(hyper, correct_bias=False)
    kern = device_ms(lambda: k5.fused_adam8_update_leaves(*path, 3, **kw), calls=5, replays=4)
    plain = event_ms(lambda: k5.fused_adam8_update_leaves_reference(*path, 3, **kw), calls=1)
    kern = (kern + device_ms(lambda: k5.fused_adam8_update_leaves(*path, 3, **kw), calls=5,
                             replays=4)) / 2
    us, flat = k5.fused_adam8_update_leaves(*path, 3, **kw)
    path_bytes = nbytes(*grads, *state, *us, *flat)
    bound_ms, bound_by, detail = k5_bound(path_bytes, elements, sm_mhz)
    log(f"  time over the path's {len(grads)} leaves (one launch): K5 {kern:.4f} ms "
        f"({path_bytes / kern / 1e6:.0f} GB/s achieved, {path_bytes / 1e9:.3f} GB), "
        f"{kern / bound_ms:.2f}x its bound {bound_ms:.4f} ms by {bound_by} ({detail}); plain "
        f"{plain:.1f} ms (device time per call: CUDA graph of 5 calls; plain: CUDA events "
        f"around 1 call)")
    del path, grads, state, us, flat
    return [entry("fused_adam8_update_leaves", "lako_tpu_torch/csrc/adam8.cu",
                  "lako_tpu/ops/adam8_kernel.py:147", max_err, kern, plain, path_bytes,
                  elements, "k5", None, bound_ms, bound_by),
            entry("adam8_ema_fragment", "lako_tpu_torch/csrc/adam8.cu",
                  "scripts/bench_adam8_micro.py:105", k6_err, k6_ms, k6_plain, k6_bytes,
                  K6_OPS * n, "f32", None)]


def run_floor_proof(dev):
    """The 8-bit Adam micro-benchmark (lako_tpu_torch.bench.adam8_micro), the
    path that runs K6: K5 with and without its dither against its
    requantization-free fragment K6 and the plain bf16-moment Adam update;
    returns its launches."""
    from lako_tpu_torch.bench import adam8_micro as micro

    log(f"floor proof: lako_tpu_torch.bench.adam8_micro at {micro.SHAPE}, g bf16")
    reset_counts()
    result = micro.run(dev)
    launches = {"micro": read_counts()}
    calls = 1 + micro.N_LO + micro.N_HI          # warm-up, then N_LO and N_HI chained calls
    check_counts("the floor proof", launches["micro"],
                 {"fused_adam8_update": 2 * calls, "adam8_ema_fragment": calls})
    fp = result["floor_proof"]
    log(f"  K5 {result['fused_kernel_ms']:.4f} ms (without the dither "
        f"{result['fused_kernel_no_dither_ms']:.4f} ms), K6 "
        f"{result['requant_free_fragment_ms']:.4f} ms, the bf16-moment Adam update in plain "
        f"PyTorch {result['bf16_adam_ms']:.4f} ms ({result['method']})")
    log(f"  the requantization's share of K5, (K5 - K6) / K5 = {fp['requant_share']:.3f}; the "
        f"dither's cost {fp['dither_cost_ms']:.4f} ms; K5 at "
        f"{result['fused_kernel_ms'] / fp['k5_bytes_bound_ms']:.2f}x its bytes bound "
        f"{fp['k5_bytes_bound_ms']:.4f} ms; scaled to t5-large's {micro.T5_LARGE_PARAMS / 1e6:.1f}M "
        f"parameters K5 {fp['t5_large_kernel_ms']:.2f} ms a step, K6 "
        f"{fp['t5_large_requant_free_ms']:.2f} ms")
    times = [v for k, v in result.items() if k.endswith("_ms")]
    if not all(math.isfinite(t) and t > 0 for t in times):
        raise AssertionError(f"the floor proof measured {times}")
    return launches


def make_requests(n: int):
    reqs = []
    for i in range(n):
        a = i % len(ANIMALS)
        facts = [{"sentence": f"{ANIMALS[(a + j) % len(ANIMALS)]} says "
                              f"{SOUNDS[(a + j) % len(SOUNDS)]}.",
                  "id": (a + j) % len(ANIMALS), "score": 1.0 / (j + 1)}
                 for j in range(10)]
        reqs.append({"question": f"what sound does the {ANIMALS[a]} make?",
                     "caption": f"a {ANIMALS[a]} standing in a field near a fence.",
                     "fact": facts})
    return reqs


def post(port: int, request: dict):
    http = urllib.request.Request(
        f"http://127.0.0.1:{port}/answer", data=json.dumps(request).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(http, timeout=300) as resp:
        return json.loads(resp.read())


def counters():
    """Every kernel wrapper, by the name the summary line gives it."""
    from lako_tpu_torch.ops import adam8_kernel as k5
    from lako_tpu_torch.ops import decode_cross_attn as k3
    from lako_tpu_torch.ops import flash_attention as k4
    from lako_tpu_torch.ops import flash_streamed as k1

    return {"streamed_attention": k1.streamed_attention,
            "streamed_attention_bwd_dkdv": k1.streamed_attention_bwd_dkdv,
            "streamed_attention_bwd_dq": k1.streamed_attention_bwd_dq,
            "streamed_attention_bwd_drel": k1.streamed_attention_bwd_drel,
            "fused_decode_cross_attention": k3.fused_decode_cross_attention,
            "fused_attention": k4.fused_attention,
            "fused_adam8_update_leaves": k5.fused_adam8_update_leaves,
            "fused_adam8_update": k5.fused_adam8_update,
            "adam8_ema_fragment": k5.adam8_ema_fragment}


def reset_counts() -> None:
    for c in counters().values():
        c.launches = 0


def read_counts() -> dict:
    return {n: c.launches for n, c in counters().items()}


def check_counts(what, launches, expected):
    """Every kernel's launches in a run against the expected counts (0 for
    a kernel the run must not reach)."""
    want = {n: expected.get(n, 0) for n in launches}
    log(f"  launches in {what}: {{{', '.join(f'{n}: {c}' for n, c in launches.items() if c)}}}"
        f"; expected {{{', '.join(f'{n}: {c}' for n, c in want.items() if c)}}}, 0 elsewhere")
    if launches != want:
        raise AssertionError(f"{what} did not run each kernel as expected")


def serving_t5(route: str):
    """t5-large at vocab 32128: encoder attention on the streamed kernel
    (flash_min_length=128 <= L), the whole-block kernel (the default
    flash_min_length=512 > L) or plain attention."""
    from lako_tpu_torch.core.config import t5_config_for_size

    t5 = t5_config_for_size("large", vocab_size=32128, dropout_rate=0.0,
                            use_flash_attention=route != "plain")
    return t5.replace(flash_min_length=128) if route == "streamed" else t5


def serving_setup(dev):
    """The served configuration (int8 K/V through K3), its weights (seeded),
    the 20 requests and their tokenizer."""
    from lako_tpu_torch.core.config import ReaderDataConfig
    from lako_tpu_torch.models.t5 import init_fid_t5
    from lako_tpu_torch.serve import ServiceConfig
    from lako_tpu_torch.text.tokenizer import WordVocabTokenizer

    cfg = ServiceConfig(batch_size=8, max_length=50, n_context=10,
                        data=ReaderDataConfig(), decode_backend="engine",
                        decode_kv_dtype="int8", decode_fused_cross=True)
    model = init_fid_t5(serving_t5("streamed"), torch.Generator(device=dev).manual_seed(SEED))
    # At the init's unit std the random tied embedding keeps the decoder start
    # token dominant in the residual stream and every greedy token is pad;
    # scaled down, the tokens depend on the passages.
    with torch.no_grad():
        model.t5.shared.weight.mul_(EMBEDDING_SCALE)
    requests = make_requests(20)
    corpus = [f"{r['question']} {r['caption']}" for r in requests] + [
        f["sentence"] for f in requests[0]["fact"]] + ["question: context: fact:"]
    return cfg, model.state_dict(), WordVocabTokenizer.build(corpus), requests


def run_slice(dev):
    """The serving path on both encoder routes; returns each route's launches."""
    from lako_tpu_torch.data import ReaderCollator, ReaderDataset
    from lako_tpu_torch.serve import LakoService, make_http_server

    t5 = serving_t5("streamed")
    t0 = time.perf_counter()
    cfg, params, tok, requests = serving_setup(dev)
    log(f"slice: t5-large ({t5.num_layers}+{t5.num_decoder_layers} layers, d_model "
        f"{t5.d_model}, {t5.num_heads} heads, d_kv {t5.d_kv}), bf16, B={cfg.batch_size}, "
        f"N={cfg.data.n_passages}, L={cfg.data.text_maxlength}, max_length={cfg.max_length}")
    service = LakoService(cfg, t5, params, tok, device=dev)
    log(f"  weights + service ready in {time.perf_counter() - t0:.1f} s")
    service.answer_batch(requests[:1])          # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()

    server = make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        reset_counts()
        t0 = time.perf_counter()
        examples, tokens = service.generate_tokens(requests)
        seconds = time.perf_counter() - t0
        answers = tok.batch_decode(tokens)
        over_http = post(server.server_address[1], requests[7])
        launches = {"streamed": read_counts()}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    batches = 3 + 1                              # 8 + 8 + 4 requests, then 1 over HTTP
    steps = cfg.max_length - 1
    log(f"  20 requests in {seconds:.3f} s: {20 / seconds:.2f} answers/s "
        f"(host clock, 3 batches, bf16, one request per answer)")
    # K3's wrapper runs at step 0; the warm-up captured the later steps'
    # graph, whose replays call no wrapper (their K3 runs: the last phase)
    check_counts("the served run (streamed route)", launches["streamed"],
                 {"streamed_attention": batches * t5.num_layers,
                  "fused_decode_cross_attention": batches * t5.num_decoder_layers})
    if tokens.shape != (20, steps) or tokens.min() < 0 or tokens.max() >= t5.vocab_size:
        raise AssertionError(f"bad token array {tokens.shape} "
                             f"[{tokens.min()}, {tokens.max()}]")
    if not (isinstance(over_http, list) and len(over_http) == 1
            and isinstance(over_http[0].get("answer"), str)):
        raise AssertionError(f"bad HTTP response {over_http!r}")
    log(f"  HTTP answer equals answer_batch's: {over_http[0]['answer'] == answers[7]}")
    log(f"  first answers: {answers[:2]!r}")

    plain_cfg = dataclasses.replace(cfg, decode_fused_cross=False)
    plain = LakoService(plain_cfg, serving_t5("plain"), params, tok, device=dev)
    reset_counts()
    _, plain_tokens = plain.generate_tokens(requests)
    check_counts("the no-kernel configuration", read_counts(), {})

    ds = ReaderDataset(examples, cfg.data)
    batch = ReaderCollator(cfg.data, tok)([ds[i] for i in range(cfg.batch_size)])
    ids = torch.from_numpy(batch.passage_ids).to(dev)
    pmask = torch.from_numpy(batch.passage_mask).to(dev)
    with torch.inference_mode():
        enc_plain = plain.model.encode_passages(ids, pmask)[0].float()

    first_labels = torch.from_numpy(plain_tokens[:cfg.batch_size]).long().to(dev)
    with torch.inference_mode():
        plain_next = plain.model(ids, pmask, first_labels)[1].argmax(-1)

    def agree(name, route_tokens, route_service):
        """The route's greedy tokens against the no-kernel service's; the
        next token under teacher forcing on the no-kernel tokens (first
        batch, the dense decoder on both sides, so only the encoder
        differs); the encoder states."""
        same = route_tokens == plain_tokens
        agreement = float(same.mean())
        first = [int(np.argmin(row)) if not row.all() else len(row) for row in same]
        with torch.inference_mode():
            enc = route_service.model.encode_passages(ids, pmask)[0].float()
            next_tok = route_service.model(ids, pmask, first_labels)[1].argmax(-1)
        forced = float((next_tok == plain_next).float().mean())
        rel = float((enc - enc_plain).abs().mean() / enc_plain.abs().mean())
        log(f"  {name}: greedy token agreement with the no-kernel configuration (same int8 "
            f"K/V): {agreement:.4f}; first position that differs, per request: {first}; "
            f"the tokens hold {len(np.unique(route_tokens))} distinct ids, "
            f"{float((route_tokens == t5.pad_token_id).mean()):.3f} of them pad (min "
            f"{TOKEN_AGREEMENT_MIN})")
        log(f"  {name}: next-token agreement under teacher forcing on the no-kernel tokens "
            f"({next_tok.numel()} positions): {forced:.4f} (min {TOKEN_AGREEMENT_MIN})")
        log(f"  {name}: encoder states ({t5.num_layers} layers, bf16), kernel vs plain "
            f"attention: mean abs err / mean abs = {rel:.3e} (max {ENCODER_REL_ERR_MAX}), "
            f"max abs err {float((enc - enc_plain).abs().max()):.3e}")
        if agreement < TOKEN_AGREEMENT_MIN or forced < TOKEN_AGREEMENT_MIN:
            raise AssertionError(f"{name}: kernel and no-kernel configurations disagree")
        if not (rel <= ENCODER_REL_ERR_MAX and bool(torch.isfinite(enc).all())):
            raise AssertionError(f"{name}: encoder states disagree with plain attention")

    agree("streamed route (K1)", tokens, service)
    del service

    # the reference kernel route: the JAX default flash_min_length sends L=130 to K4
    fused_t5 = serving_t5("fused")
    log(f"slice, whole-block route: use_flash_attention with flash_min_length="
        f"{fused_t5.flash_min_length} > L={cfg.data.text_maxlength}, so every encoder "
        f"layer takes K4 (csrc/fused_attention.cu)")
    fused = LakoService(cfg, fused_t5, params, tok, device=dev)
    fused.answer_batch(requests[:1])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    _, fused_tokens = fused.generate_tokens(requests)
    seconds = time.perf_counter() - t0
    launches["fused"] = read_counts()
    log(f"  20 requests in {seconds:.3f} s: {20 / seconds:.2f} answers/s (host clock, "
        f"3 batches)")
    check_counts("the served run (whole-block route)", launches["fused"],
                 {"fused_attention": 3 * fused_t5.num_layers,
                  "fused_decode_cross_attention": 3 * fused_t5.num_decoder_layers})
    log(f"  whole-block route (K4): token agreement with the streamed route (K1): "
        f"{float((fused_tokens == tokens).mean()):.4f}")
    agree("whole-block route (K4)", fused_tokens, fused)
    shared = dict(cfg=cfg, params=params, tok=tok, requests=requests, tokens=tokens,
                  ids=ids, pmask=pmask)
    return launches, shared


def served_run(service, requests):
    """(tokens, host seconds, chunks each batch ran) of one generate_tokens
    call; the seconds end with the tokens' copy to the host."""
    from lako_tpu_torch.models.t5.engine import DecodeEngine

    gen = service._generate
    engine = getattr(gen, "__self__", None)
    chunks = []

    def counted(ids, mask):
        out = gen(ids, mask)
        chunks.append(engine.last_chunks)
        return out

    if isinstance(engine, DecodeEngine):
        service._generate = counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        _, tokens = service.generate_tokens(requests)
    finally:
        service._generate = gen
    return tokens, time.perf_counter() - t0, chunks


def eager_twin(service):
    """A copy of the service whose greedy engine runs the token loop
    eagerly, for holding the CUDA graphs to the eager loop."""
    from lako_tpu_torch.models.t5.engine import DecodeEngine

    eng = service._generate.__self__
    twin = copy.copy(service)
    twin._generate = DecodeEngine(
        eng.model, max_length=eng.max_length, kv_dtype=eng.kv_dtype,
        weights_dtype=eng.weights_dtype, fused_cross=eng.fused_cross,
        chunk_size=eng.chunk_size, self_cache_layout=eng.self_cache_layout,
        cuda_graphs=False).generate
    return twin


def require_same(what, got, want):
    same = bool(np.array_equal(got, want))
    log(f"  {what}: tokens identical: {same}")
    if not same:
        raise AssertionError(f"{what}: tokens differ ({float((got == want).mean()):.4f} agree)")


def run_decode(dev, shared):
    """The decode modes of the serving path at t5-large width on the streamed
    route (K1): full-length and chunked decode as CUDA graphs against the
    eager loop, the chunking cost model's two numbers, engine_policy="auto",
    int8 weights and int8mxu against native K/V (held to the JAX package's
    bounds), beam-4 through LakoService, timed at full width and held to
    beam_generate at 2 decoder layers in float32. Returns the chunked run's
    launches."""
    from lako_tpu_torch.models.t5 import init_fid_t5
    from lako_tpu_torch.models.t5.beam import beam_generate
    from lako_tpu_torch.models.t5.engine import (
        CHUNK_DISPATCH_COST_S,
        CHUNK_PER_STEP_COST_S,
        DecodeEngine,
    )
    from lako_tpu_torch.serve import LakoService

    t5 = serving_t5("streamed")
    cfg, params, tok = shared["cfg"], shared["params"], shared["tok"]
    requests, served = shared["requests"], shared["tokens"]
    ids, pmask = shared["ids"], shared["pmask"]
    steps, layers, n = cfg.max_length - 1, t5.num_decoder_layers, len(requests)
    rates = {}

    def service(**change):
        return LakoService(dataclasses.replace(cfg, **change), t5, params, tok, device=dev)

    log(f"decode modes: t5-large, bf16, B={cfg.batch_size}, {n} requests, streamed route "
        f"(K1); greedy with int8 K/V through K3 unless stated")
    full = service()
    full.generate_tokens(requests)                 # captures the batch shape's graph
    tokens, seconds, chunks = served_run(full, requests)
    rates["full length, graphed"] = n / seconds
    require_same("full length, graphed, against the served run", tokens, served)
    eager = eager_twin(full)
    eager.generate_tokens(requests[:1])
    eager_tokens, seconds, _ = served_run(eager, requests)
    rates["full length, eager"] = n / seconds
    require_same("full length, graph replay against the eager loop", eager_tokens, tokens)
    engine = full._generate.__self__
    graph = next(iter(engine._batches.values())).chunks[1, steps - 1].graph
    step_ms = event_ms(graph.replay) / (steps - 1)
    log(f"  a step's device time: {step_ms:.4f} ms (CUDA events around the replay of the "
        f"{steps - 1}-step graph, 5 replays)")
    del eager, graph
    gc.collect()
    torch.cuda.empty_cache()

    chunked = service(decode_chunk_size=16)
    chunked.generate_tokens(requests)              # captures every chunk the requests run
    reset_counts()
    chunked_tokens, seconds, chunks = served_run(chunked, requests)
    launches = read_counts()
    rates["chunked (16), graphed"] = n / seconds
    log(f"  chunked (decode_chunk_size=16): chunks run per batch {chunks} (of "
        f"{-(-(steps - 1) // 16)} after the prefill step)")
    require_same("chunked against full length", chunked_tokens, served)
    check_counts("the chunked run (graphs captured before it)", launches,
                 {"streamed_attention": len(chunks) * t5.num_layers,
                  "fused_decode_cross_attention": len(chunks) * layers})
    eager = eager_twin(chunked)
    eager.generate_tokens(requests[:1])
    eager_tokens, seconds, eager_chunks = served_run(eager, requests)
    rates["chunked (16), eager"] = n / seconds
    require_same("chunked, graph replay against the eager loop", chunked_tokens, eager_tokens)
    if eager_chunks != chunks:
        raise AssertionError(f"eager chunks {eager_chunks} != graphed {chunks}")
    chunk = next(iter(chunked._generate.__self__._batches.values())).chunks[1, 16]
    chunk_ms = event_ms(chunk.graph.replay)
    walls = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk.graph.replay()
        bool(chunk.all_done)
        walls.append((time.perf_counter() - t0) * 1e3)
    dispatch_ms = float(np.median(walls)) - chunk_ms
    log(f"  a graphed chunk of 16 steps: device {chunk_ms:.4f} ms, host clock around replay "
        f"and the all-done read median {np.median(walls):.4f} ms of 20: dispatch "
        f"{dispatch_ms:.4f} ms beyond the device time (engine.py's CHUNK_DISPATCH_COST_S "
        f"{CHUNK_DISPATCH_COST_S * 1e3:g} ms, CHUNK_PER_STEP_COST_S "
        f"{CHUNK_PER_STEP_COST_S * 1e3:g} ms)")
    del chunked, eager, chunk
    gc.collect()
    torch.cuda.empty_cache()

    auto = service(engine_policy="auto")
    auto_one = auto.generate_tokens(requests[:1])[1]
    auto_eight = auto.generate_tokens(requests[:8])[1]
    decisions = list(auto.policy_decisions)
    log(f"  engine_policy='auto' (threshold max(8 // 2, 5) = {auto._policy_threshold}): "
        f"decisions at occupancy 1 and 8: {decisions}")
    if decisions != [("full", 1), ("chunked", 8)]:
        raise AssertionError(f"engine_policy='auto' decided {decisions}")
    require_same("auto, occupancy 1 and 8, against full length",
                 np.concatenate([auto_one, auto_eight]),
                 np.concatenate([served[:1], served[:8]]))
    del auto
    gc.collect()

    native = service(decode_kv_dtype="native", decode_fused_cross=False)
    native_tokens = served_run(native, requests)[0]
    with torch.inference_mode():
        _, ref_xl = DecodeEngine(native.model, collect_cross_scores=True).generate(ids, pmask)
    valid = pmask.reshape(pmask.shape[0], 1, 1, -1)
    scale = float((ref_xl.abs() * valid).max())
    for name, change, (xl_bound, agree_min) in (
            ("int8 weights", dict(decode_kv_dtype="native", decode_fused_cross=False,
                                  decode_weights_dtype="int8"), (0.1, 0.85)),
            ("int8mxu K/V", dict(decode_kv_dtype="int8mxu", decode_fused_cross=False),
             (0.05, 0.9))):
        svc = service(**change)
        mode_tokens = served_run(svc, requests)[0]
        eng = svc._generate.__self__
        _, xl = DecodeEngine(svc.model, collect_cross_scores=True, kv_dtype=eng.kv_dtype,
                             weights_dtype=eng.weights_dtype).generate(ids, pmask)
        err = float(((xl - ref_xl).abs() * valid).max()) / scale
        agreement = float((mode_tokens == native_tokens).mean())
        log(f"  {name} against native K/V and weights: step-0 cross logits max error / "
            f"scale {err:.4f} (max {xl_bound}), token agreement {agreement:.4f} (min "
            f"{agree_min}); the JAX package's bounds (tests/test_engine.py)")
        if not (bool(torch.isfinite(xl).all()) and mode_tokens.shape == native_tokens.shape):
            raise AssertionError(f"{name}: bad output")
        if not (err <= xl_bound and agreement >= agree_min):
            raise AssertionError(f"{name}: outside the JAX package's bounds")
        del svc, eng, xl
    del native, ref_xl
    gc.collect()
    torch.cuda.empty_cache()

    beam_change = dict(num_beams=4, decode_kv_dtype="native", decode_fused_cross=False)
    beam = service(**beam_change)
    beam.generate_tokens(requests[:1])
    beam_tokens, seconds, _ = served_run(beam, requests)
    rates["beam-4"] = n / seconds
    if (beam_tokens.shape != (n, steps) or beam_tokens.min() < 0
            or beam_tokens.max() >= t5.vocab_size):
        raise AssertionError(f"beam-4: bad tokens {beam_tokens.shape}")
    log(f"  beam-4 (beam engine, blockwise selection): first answers "
        f"{tok.batch_decode(beam_tokens[:2])!r}; token agreement with greedy on native K/V "
        f"{float((beam_tokens == native_tokens).mean()):.4f}")
    del beam
    gc.collect()
    torch.cuda.empty_cache()

    # beam-4 through LakoService against the layer-unrolled beam search
    # (models/t5/beam.py) on the same inputs, at 2 decoder layers in float32
    t5_2 = t5.replace(num_decoder_layers=2)
    model = init_fid_t5(t5_2, torch.Generator(device=dev).manual_seed(SEED))
    with torch.no_grad():
        model.t5.shared.weight.mul_(EMBEDDING_SCALE)
    small = LakoService(dataclasses.replace(cfg, dtype="float32", **beam_change), t5_2,
                        model.state_dict(), tok, device=dev)
    got = small.generate_tokens(requests[:cfg.batch_size])[1]
    want = beam_generate(model, ids, pmask, max_length=cfg.max_length, num_beams=4)
    log(f"  beam-4 at 2 decoder layers of t5-large width, f32, B={ids.shape[0]}: "
        f"LakoService (beam engine) against beam_generate (layer-unrolled), "
        f"{len(np.unique(want.cpu().numpy()))} distinct ids")
    require_same("beam-4, beam engine against beam_generate", got, want.cpu().numpy())
    del model, small

    card = torch.cuda.get_device_name(0)
    log(f"  answers/s ({n} requests, host clock, {card}): "
        + ", ".join(f"{k} {v:.2f}" for k, v in rates.items()))
    return {"chunked": launches}


def device_kernels(prof, name: str) -> int:
    """The kernels whose name holds ``name`` that ran on the card in a
    torch.profiler trace (CUDA graph replays included)."""
    return sum(name in e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def run_profiled(dev):
    """The chunked service (decode_chunk_size=16, int8 K/V through K3) built
    anew, serving the 20 requests under torch.profiler: the kernel wrappers'
    counts (step 0 of each batch, the warm-up step and the launches each
    capture records) and the K3 kernels that really ran, graph replays
    included; then the kernels of one decode step of its engine, run
    eagerly. The script's last phase, so that no timed phase runs after a
    profiler in the process. Returns the served run's launches."""
    from lako_tpu_torch.serve import LakoService

    cfg, params, tok, requests = serving_setup(dev)
    t5 = serving_t5("streamed")
    layers, steps = t5.num_decoder_layers, cfg.max_length - 1
    service = LakoService(dataclasses.replace(cfg, decode_chunk_size=16), t5, params, tok,
                          device=dev)
    engine = service._generate.__self__
    reset_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        chunks = served_run(service, requests)[2]
        torch.cuda.synchronize()
    launches = read_counts()
    k3_runs = device_kernels(prof, K3_KERNEL)
    st = next(iter(engine._batches.values()))
    captured = sum(n for _, n in st.chunks)
    check_counts("the chunked service's first 20 requests (profiled)", launches,
                 {"streamed_attention": len(chunks) * t5.num_layers,
                  "fused_decode_cross_attention": layers * (len(chunks) + 1 + captured)})
    run_steps = [1 + min(steps - 1, 16 * c) for c in chunks]
    want_runs = layers * (sum(run_steps) + 1)
    log(f"  K3 kernels that ran on the card in that run (torch.profiler trace, graph "
        f"replays included): {k3_runs}; expected {layers} layers x ({' + '.join(map(str, run_steps))}"
        f" steps of its {len(chunks)} batches + 1 warm-up step) = {want_runs}; the wrapper "
        f"counted {launches['fused_decode_cross_attention']} (step 0, the warm-up step and "
        f"the {captured} captured steps)")
    if k3_runs != want_runs:
        raise AssertionError(f"K3 ran {k3_runs} times on the card, expected {want_runs}")
    with torch.inference_mode(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        engine._run_chunk(st, 1, 1)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    log(f"one decode step of the served engine (t5-large, B={cfg.batch_size}, int8 K/V "
        f"through K3), run eagerly: {len(kernels)} kernels, "
        f"{sum(e.time_range.elapsed_us() for e in kernels) / 1e3:.4f} ms of kernel time "
        f"(torch.profiler)")
    return {"chunked": dict(launches, device_launches=k3_runs)}


def train_fixture():
    """The synthetic closed-world fixture of tests/fixtures.py (numpy only;
    loaded by path, since a site package may own the name ``tests``) and a
    word tokenizer over it."""
    from lako_tpu_torch.text.tokenizer import WordVocabTokenizer

    spec = importlib.util.spec_from_file_location(
        "lako_fixtures", Path(__file__).resolve().parent / "tests" / "fixtures.py")
    fixtures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixtures)
    corpus_sentences, make_examples = fixtures.corpus_sentences, fixtures.make_examples
    tok = WordVocabTokenizer.build(corpus_sentences() + [
        "question: what sound does the animal make? context: a animal sitting on the "
        "grass. fact:"])
    return tok, make_examples(TRAIN_EXAMPLES, n_facts=5, seed=SEED), \
        make_examples(EVAL_EXAMPLES, n_facts=5, seed=SEED + 100)


def train_t5(tok, route: str):
    """t5-large at the fixture's vocabulary, dropout 0, encoder attention on
    the streamed kernels (flash_min_length=128), the whole-block kernel K4 (the
    default 512) or plain attention."""
    from lako_tpu_torch.core.config import t5_config_for_size

    t5 = t5_config_for_size("large", vocab_size=tok.vocab_size, dropout_rate=0.0,
                            use_flash_attention=route != "plain")
    return t5.replace(flash_min_length=128) if route == "streamed" else t5


# the kernels each train step launches, per encoder layer, on each route
STEP_LAUNCHES = {"streamed": {"streamed_attention": 2, "streamed_attention_bwd_dkdv": 1,
                              "streamed_attention_bwd_dq": 1, "streamed_attention_bwd_drel": 1},
                 "fused": {"fused_attention": 2}}
ROUTE_NAMES = {"streamed": "streamed kernels K1, K2a/K2b/K2c (flash_min_length=128)",
               "fused": "whole-block kernel K4 (flash_min_length=512)"}


def first_batch(cfg, tok, examples, dev):
    from lako_tpu_torch.data import ReaderCollator, ReaderDataset

    ds = ReaderDataset(examples, cfg.data, seed=cfg.seed)
    batch = ReaderCollator(cfg.data, tok)([ds[i] for i in range(cfg.per_device_batch_size)])
    return tuple(torch.from_numpy(a).to(dev) for a in
                 (batch.passage_ids, batch.passage_mask, batch.labels))


def grad_errors(got, want):
    """Per-tensor ||got - want|| / ||want|| (tensors with a zero reference
    left out) and the same over all tensors at once."""
    rel, num, den = {}, 0.0, 0.0
    for name, w in want.items():
        d2 = float((got[name].float() - w.float()).square().sum())
        w2 = float(w.float().square().sum())
        num, den = num + d2, den + w2
        if w2 > 0:
            rel[name] = math.sqrt(d2 / w2)
    return rel, math.sqrt(num / den)


def step_grads(dev, tok, route, dtype, batch):
    """Loss and gradients of one train step from the seeded init, with its
    kernel launches."""
    from lako_tpu_torch.models.t5 import init_fid_t5
    from lako_tpu_torch.models.t5.layers import set_dropout_key
    from lako_tpu_torch.train.reader import model_params

    model = init_fid_t5(train_t5(tok, route), torch.Generator(device=dev).manual_seed(SEED),
                        dtype, use_remat=True)
    params = model_params(model)
    model.train()
    set_dropout_key(model, SEED, 0)
    reset_counts()
    loss = model(*batch)[0]
    grads = torch.autograd.grad(loss, list(params.values()))
    torch.cuda.synchronize()
    return float(loss.detach()), dict(zip(params, grads)), read_counts()


def check_train_step(dev, tok, batch, route):
    """One train step's loss and gradients, kernels vs plain attention, from
    the same init and batch. float32: the two must agree within STEP_TOL.
    bfloat16: the loss within STEP_TOL; the gradients are held to the float32
    plain gradients, and the kernel run may be no further from them than
    BF16_NOISE_RATIO times the plain bf16 run is (worst tensor and all
    tensors), since two bf16 runs that round in different places differ by
    bf16's own noise. The relative-position embedding, which only the
    attention kernel's bias gradient feeds, must get a nonzero gradient."""
    layers = train_t5(tok, route).num_layers
    per_step = {n: c * layers for n, c in STEP_LAUNCHES[route].items()}
    relpos = "t5/encoder/relpos/rel_embedding"
    reference = None   # the float32 plain gradients
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        lk, gk, launched = step_grads(dev, tok, route, dtype, batch)
        check_counts(f"the {dtype_name} train step", launched, per_step)
        lp, gp, launched = step_grads(dev, tok, "plain", dtype, batch)
        check_counts(f"the {dtype_name} plain train step", launched, {})
        loss_err = abs(lk - lp) / abs(lp)
        rel, total = grad_errors(gk, gp)
        worst = max(rel, key=rel.get)
        loss_tol, grad_tol = STEP_TOL[dtype_name]
        log(f"  {dtype_name}: loss kernels {lk:.6f} vs plain {lp:.6f} (rel err {loss_err:.3e}, "
            f"bound {loss_tol:g}); gradients kernels vs plain: worst tensor {rel[worst]:.3e} at "
            f"{worst}, all tensors {total:.3e}, {relpos} {rel[relpos]:.3e} (|g| kernels "
            f"{float(gk[relpos].float().norm()):.3e}, plain {float(gp[relpos].norm()):.3e}); "
            f"{len(rel)} tensors")
        ok = (loss_err <= loss_tol and math.isfinite(lk)
              and float(gk[relpos].float().norm()) > 0)
        if dtype == torch.float32:
            ok = ok and rel[worst] <= grad_tol
            reference = gp
        else:
            rk, tk = grad_errors(gk, reference)
            rp, tp = grad_errors(gp, reference)
            wk, wp = max(rk.values()), max(rp.values())
            log(f"  bfloat16 against the float32 plain gradients: kernels worst tensor {wk:.3e} "
                f"(at {max(rk, key=rk.get)}), all tensors {tk:.3e}, {relpos} {rk[relpos]:.3e}; "
                f"plain worst tensor {wp:.3e} (at {max(rp, key=rp.get)}), all tensors {tp:.3e}, "
                f"{relpos} {rp[relpos]:.3e}; bound: kernels <= {BF16_NOISE_RATIO:g} x plain")
            ok = ok and wk <= BF16_NOISE_RATIO * wp and tk <= BF16_NOISE_RATIO * tp
        if not ok:
            raise AssertionError(f"{dtype_name} train step: kernels disagree with plain attention")
        del gk, gp
        gc.collect()
        torch.cuda.empty_cache()
    return reference


def check_adam8_step(dev, grads):
    """AdamW8bit moment updates of every t5-large parameter tensor from the
    same gradients: scale_by_adam_8bit("auto") on the card, one K5 launch an
    update, against the plain per-leaf versions in the same routing (the
    kernel's order for the leaves the JAX package sends to its kernel, the
    jnp order for the rest): u, codes and scales bitwise, both bias
    corrections. Then one update's device time (CUDA graph) and wall time
    (host clock, synchronized), warmed."""
    from lako_tpu_torch.ops.adam8_kernel import LeafLayout, fused_adam8_update_leaves_reference
    from lako_tpu_torch.train.optim8 import (
        is_transposed,
        kernel_route,
        leaf_order,
        scale_by_adam_8bit,
    )

    hyper = dict(b1=0.9, b2=0.999, eps=1e-6, stochastic_round=True, seed=0x8B17)
    order = leaf_order(grads)
    n = sum(g.numel() for g in grads.values())
    jnp = sum(not kernel_route(grads[p]) for p in order)
    for correct in (False, True):
        tx = scale_by_adam_8bit(correct_bias=correct)
        state = tx.init(grads)
        for count in (1, 2):
            reset_counts()
            u, new = tx.update(grads, state)
            torch.cuda.synchronize()
            launched = read_counts()["fused_adam8_update_leaves"]
            same = 0
            for i, path in enumerate(order):
                g, mu, nu = grads[path], state.mu[path], state.nu[path]
                layout = LeafLayout((i,), (is_transposed(path, g),), (not kernel_route(g),),
                                    (mu.q.shape[0],))
                (w,), flat = fused_adam8_update_leaves_reference(
                    [g], (mu.q, mu.scale, nu.q, nu.scale), layout, count, correct_bias=correct,
                    **hyper)
                got = (u[path], new.mu[path].q, new.mu[path].scale, new.nu[path].q,
                       new.nu[path].scale)
                same += all(torch.equal(a, b) for a, b in zip(got, (w, *flat)))
            log(f"  AdamW8bit update {count}, correct_bias={correct}, of {len(order)} tensors "
                f"({n / 1e6:.1f}M elements; {len(order) - jnp} in the kernel's order, {jnp} in "
                f"the jnp order): K5 launched {launched} time(s); {same}/{len(order)} tensors "
                f"bitwise equal to the plain version (u, codes, scales)")
            if launched != 1 or same != len(order):
                raise AssertionError("the AdamW8bit update disagrees with its plain version")
            state = new
    del u, new
    device = device_ms(lambda: tx.update(grads, state), calls=5, replays=4)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tx.update(grads, state)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"  one AdamW8bit update of the {len(order)} tensors: device {device:.4f} ms (CUDA graph "
        f"of 5 updates), wall {sorted(walls)[2]:.2f} ms (median of 5, host clock around the "
        f"update and a synchronize; all {', '.join(f'{w:.2f}' for w in walls)})")
    q8 = nbytes(state.mu.q, state.mu.scale, state.nu.q, state.nu.scale)
    log(f"  8-bit moment state {q8 / 1e9:.3f} GB against {8 * n / 1e9:.3f} GB of float32 "
        f"moments (counted from the tensors)")


def run_train_reader(dev, cfg, tok, train, evals, route):
    """train_reader at t5-large width on one route; returns its launches."""
    from lako_tpu_torch.train.reader import train_reader

    t5 = train_t5(tok, route)
    log(f"train_reader: t5-large ({t5.num_layers}+{t5.num_decoder_layers} layers, d_model "
        f"{t5.d_model}, {t5.num_heads} heads, vocab {t5.vocab_size}), {ROUTE_NAMES[route]}, "
        f"dtype {cfg.dtype}, param_dtype {cfg.param_dtype}, remat, {cfg.optim.optim} lr "
        f"{cfg.optim.lr} wd {cfg.optim.weight_decay} clip {cfg.optim.clip}, "
        f"B={cfg.per_device_batch_size}, N={cfg.data.n_passages}, L={cfg.data.text_maxlength}, "
        f"{len(train)} train / {len(evals)} eval examples, {cfg.epochs} epochs")
    reset_counts()
    t0 = time.perf_counter()
    result = train_reader(cfg, train, evals, tok, t5_config=t5, save_checkpoints=False,
                          device=dev)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    steps = result.final_step
    eval_batches = -(-len(evals) // cfg.eval_batch_size) * len(result.history)
    expected = {n: c * t5.num_layers * steps for n, c in STEP_LAUNCHES[route].items()}
    attention = "streamed_attention" if route == "streamed" else "fused_attention"
    expected[attention] += t5.num_layers * eval_batches
    if cfg.optim.optim == "adamw8bit":
        expected["fused_adam8_update_leaves"] = steps   # one launch over every tensor
    log(f"  {steps} steps and {len(result.history)} evals in {seconds:.1f} s; history "
        f"{[{k: round(v, 4) for k, v in h.items()} for h in result.history]}")
    check_counts(f"train_reader ({route} route, {cfg.optim.optim})", launches, expected)
    losses = [h["loss"] for h in result.history]
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not fall: {losses}")
    if any(sorted(h) != ["em", "epoch", "loss", "seconds"] for h in result.history):
        raise AssertionError(f"history keys differ from the JAX package's: {result.history}")
    if not all(0.0 <= h["em"] <= 1.0 for h in result.history):
        raise AssertionError(f"EM out of [0, 1]: {result.history}")
    del result
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def train_rate(dev, cfg, tok, batch, route, optim_name):
    """(examples/s, peak device GB) of the train step (host clock around
    synchronized steps, the first step excluded; the peak over the model,
    its optimizer state and the steps)."""
    from lako_tpu_torch.models.t5 import init_fid_t5
    from lako_tpu_torch.train.optim import make_optimizer
    from lako_tpu_torch.train.reader import make_reader_train_step, model_params
    from lako_tpu_torch.train.state import TrainState

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = init_fid_t5(train_t5(tok, route), torch.Generator(device=dev).manual_seed(SEED),
                        torch.bfloat16, use_remat=True)
    tx = make_optimizer(cfg.optim.replace(optim=optim_name, warmup_steps=0, total_steps=100))
    state = TrainState.create(model_params(model), tx)
    step = make_reader_train_step(model)
    state, loss = step(state, *batch, SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        state, loss = step(state, *batch, SEED)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not math.isfinite(float(loss)):
        raise AssertionError("non-finite loss in the timed train steps")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    del model, state, step
    return cfg.per_device_batch_size * TIMED_STEPS / seconds, peak


def run_training(dev):
    """The training path on both routes; returns each route's launches."""
    from lako_tpu_torch.core.config import ReaderTrainConfig

    cfg = ReaderTrainConfig(model_size="large", per_device_batch_size=8, eval_batch_size=8,
                            epochs=TRAIN_EPOCHS, early_stop=TRAIN_EPOCHS, eval_max_length=20,
                            use_remat=True, dtype="bfloat16", param_dtype="float32", seed=SEED)
    tok, train, evals = train_fixture()
    batch = first_batch(cfg, tok, train, dev)
    launches = {}
    log("one train step at t5-large width (B=8, N=2, L=130, remat), streamed kernels "
        "(flash_min_length=128) vs plain attention, same init and batch:")
    check_train_step(dev, tok, batch, "streamed")
    launches["streamed"] = run_train_reader(dev, cfg, tok, train, evals, "streamed")
    rates = [train_rate(dev, cfg, tok, batch, route, "adamw")[0]
             for route in ("streamed", "plain", "streamed", "plain")]
    log(f"  train step examples/s (bf16 compute, f32 masters, remat, B=8, AdamW; host clock, "
        f"synchronized, {TIMED_STEPS} steps after the first): with the streamed kernels "
        f"{rates[0]:.2f}, {rates[2]:.2f}; without {rates[1]:.2f}, {rates[3]:.2f}")

    log("reference kernel route: one train step at t5-large width, whole-block kernel K4 "
        "(the default flash_min_length=512 > L=130) vs plain attention, same init and batch:")
    grads = check_train_step(dev, tok, batch, "fused")
    log("one AdamW8bit update at t5-large from the float32 gradients above, K5 vs plain:")
    check_adam8_step(dev, grads)
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    launches["fused"] = run_train_reader(
        dev, cfg.replace(optim=cfg.optim.replace(optim="adamw8bit")), tok, train, evals, "fused")
    runs = [(name, train_rate(dev, cfg, tok, batch, "fused", name))
            for name in ("adamw", "adamw8bit", "adamw8bit", "adamw")]
    log("  train step on the whole-block route (bf16 compute, f32 masters, remat, B=8; "
        f"{TIMED_STEPS} steps after the first), examples/s and peak device memory "
        "(torch.cuda.max_memory_allocated): "
        + "; ".join(f"{name} {rate:.2f} ex/s, {peak:.2f} GB" for name, (rate, peak) in runs))
    return launches


# the kernel functions (csrc/) each wrapper of the training path launches,
# as named in a profiler trace
TRACE_KERNELS = {"streamed_attention": "streamed_fwd_", "streamed_attention_bwd_dkdv": "bwd_dkdv",
                 "streamed_attention_bwd_dq": "bwd_dq", "streamed_attention_bwd_drel": "bwd_drel",
                 "fused_adam8_update_leaves": "adam8_update_leaves_kernel"}
RESULT_KEYS = ["answers_per_sec", "em", "include_em", "stem_em", "total"]    # stages.py
RESULT_ROW_KEYS = ["answer", "fact", "img_id", "include_score", "question", "real answers",
                   "score", "stem_score", "target"]
SCORE_SUM_TOL = 1e-5
SCORE_RTOL = 1e-5


def cli(argv):
    """``lako_tpu_torch.pipeline.cli.main(argv)`` in this process; returns
    the JSON object it prints last."""
    from lako_tpu_torch.pipeline.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    for handler in logging.getLogger("lako_tpu_torch").handlers:   # init_logger's, on buf
        handler.setStream(sys.stdout)
    out = buf.getvalue().strip().splitlines()
    log("\n".join(f"  | {line}" for line in out[:-1]))
    return json.loads(out[-1])


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in Path(path).iterdir())


def trace_kernels(trace_dir: Path) -> dict:
    """Kernel launches by wrapper name in the one Chrome trace of a directory."""
    (trace,) = list(trace_dir.iterdir())
    events = json.loads(trace.read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    return {w: sum(k in n for n in names) for w, k in TRACE_KERNELS.items()}


def same_tree(what, got, want) -> int:
    """Every tensor and number of two flattened trees equal (got on the CPU,
    want anywhere); returns the bytes compared."""
    from lako_tpu_torch.core.checkpoint import flatten_tree

    g, w = flatten_tree(got), flatten_tree(want)
    if sorted(g) != sorted(w):
        raise AssertionError(f"{what}: the loaded keys differ from the trained state's")
    n, bad = 0, []
    for k, v in w.items():
        if isinstance(v, torch.Tensor):
            n += v.numel() * v.element_size()
            if g[k].dtype != v.dtype or not torch.equal(g[k].to(v.device), v):
                bad.append(k)
        elif g[k] != v:
            bad.append(k)
    if bad:
        raise AssertionError(f"{what}: {len(bad)} entries differ, e.g. {bad[:3]}")
    return n


def run_reader_pipeline(dev):
    """The reader's two pipeline stages at t5-large width through the CLI
    (lako_tpu_torch.pipeline.cli.main in this process), in a temporary
    directory: build-tokenizer; train-reader (2 epochs, AdamW8bit, the
    streamed route, checkpoints, a profiler trace of steps 3-5); the
    ``last`` checkpoint loaded into fresh templates, bitwise; a full resume
    and a warm start; eval-reader with --write-results and
    --write-crossattention-scores; make_generate_and_score_fn on the first
    eval batch against make_best_generate_fn and the numpy aggregation of
    its step-0 logits; eval answers/s with and without score capture.
    Returns the train-reader run's launches."""
    from lako_tpu_torch.core import checkpoint as ckpt_mod
    from lako_tpu_torch.core.config import (
        AttentionSignalConfig,
        OptimConfig,
        ReaderDataConfig,
        ReaderTrainConfig,
    )
    from lako_tpu_torch.data import ReaderCollator, ReaderDataset
    from lako_tpu_torch.models.t5 import init_fid_t5, jax_param_paths
    from lako_tpu_torch.models.t5.decode import make_best_generate_fn, make_generate_and_score_fn
    from lako_tpu_torch.pipeline import stages
    from lako_tpu_torch.signal import aggregate_fact_scores
    from lako_tpu_torch.text.tokenizer import load_tokenizer
    from lako_tpu_torch.train import reader
    from lako_tpu_torch.train.optim import make_optimizer

    t_phase = time.perf_counter()
    _, train, evals = train_fixture()
    n_facts = len(train[0]["fact"])
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        (tmp / "train.json").write_text(json.dumps(train))
        (tmp / "eval.json").write_text(json.dumps(evals))
        out = cli(["build-tokenizer", "--from-json", str(tmp / "train.json"), "--out",
                   str(tmp / "tok.json")])
        tok = load_tokenizer(str(tmp / "tok.json"))
        t5 = train_t5(tok, "streamed")
        cfg = ReaderTrainConfig(
            model_size="large", per_device_batch_size=8, eval_batch_size=8,
            epochs=TRAIN_EPOCHS, early_stop=TRAIN_EPOCHS, eval_max_length=20, use_remat=True,
            dtype="bfloat16", param_dtype="float32", seed=SEED,
            data=ReaderDataConfig(n_context=n_facts), optim=OptimConfig(optim="adamw8bit"),
            profile_dir=str(tmp / "profile"), checkpoint_dir=str(tmp / "ckpt"), name="reader")
        (tmp / "t5.json").write_text(json.dumps(dataclasses.asdict(t5)))
        (tmp / "cfg.json").write_text(json.dumps(dataclasses.asdict(cfg)))
        common = ["--config", str(tmp / "cfg.json"), "--t5-config", str(tmp / "t5.json"),
                  "--tokenizer", str(tmp / "tok.json")]
        log(f"reader pipeline: build-tokenizer {out}; t5-large ({t5.num_layers}+"
            f"{t5.num_decoder_layers} layers, d_model {t5.d_model}, vocab {t5.vocab_size}), "
            f"streamed kernels (flash_min_length=128), B=8, N=2, L=130, bf16 compute, f32 "
            f"masters, remat, adamw8bit, {len(train)} train / {len(evals)} eval examples, "
            f"{cfg.epochs} epochs, eval_max_length {cfg.eval_max_length}, n_context {n_facts}")

        # train-reader, keeping the trained state and timing each save
        kept, saves = {}, []
        train_reader, save_checkpoint = stages.train_reader, reader.save_checkpoint

        def keep(*args, **kw):
            kept["result"] = train_reader(*args, **kw)
            return kept["result"]

        def timed_save(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = save_checkpoint(*args, **kw)
            saves.append((Path(path).name, dir_bytes(path), time.perf_counter() - t0))
            return path

        stages.train_reader, reader.save_checkpoint = keep, timed_save
        reset_counts()
        t0 = time.perf_counter()
        try:
            trained = cli(["train-reader", *common, "--train-data", str(tmp / "train.json"),
                           "--eval-data", str(tmp / "eval.json")])
        finally:
            stages.train_reader, reader.save_checkpoint = train_reader, save_checkpoint
        seconds = time.perf_counter() - t0
        launches = read_counts()
        result = kept.pop("result")
        steps = trained["steps"]
        log(f"  train-reader: {steps} steps, {len(trained['history'])} evals in "
            f"{seconds:.1f} s; best_dev_em {trained['best_dev_em']}; history "
            f"{[{k: round(v, 4) for k, v in h.items()} for h in trained['history']]}")
        if steps != TRAIN_EPOCHS * len(train) // cfg.per_device_batch_size:
            raise AssertionError(f"train-reader ran {steps} steps")
        eval_batches = -(-len(evals) // cfg.eval_batch_size) * len(trained["history"])
        expected = {n: c * t5.num_layers * steps for n, c in STEP_LAUNCHES["streamed"].items()}
        expected["streamed_attention"] += t5.num_layers * eval_batches
        expected["fused_adam8_update_leaves"] = steps
        check_counts("train-reader (streamed route, adamw8bit)", launches, expected)
        losses = [h["loss"] for h in trained["history"]]
        if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
            raise AssertionError(f"the loss did not fall: {losses}")
        ckpt = tmp / "ckpt" / "reader" / "checkpoint"
        names = sorted(p.name for p in ckpt.iterdir())
        want = sorted(["last", "latest"] + ["best_dev"] * any(
            h["em"] > 0 for h in trained["history"]))
        log(f"  checkpoints: {names} (latest -> {(ckpt / 'latest').resolve().name}); expected "
            f"{want}")
        if names != want or (ckpt / "latest").resolve() != (ckpt / "last").resolve():
            raise AssertionError("train-reader wrote other checkpoints than expected")
        for name, n_bytes, secs in saves:
            log(f"  save {name}: {n_bytes / 1e9:.3f} GB in {secs:.2f} s, "
                f"{n_bytes / 1e9 / secs:.2f} GB/s (host clock, torch.save to {tmp_dir})")
        traced = trace_kernels(tmp / "profile")
        per_step = {n: c * t5.num_layers for n, c in STEP_LAUNCHES["streamed"].items()}
        per_step["fused_adam8_update_leaves"] = 1
        log(f"  profiler trace of steps 3-5: kernels {traced}; 3 steps' wrapper calls "
            f"{ {n: 3 * c for n, c in per_step.items()} }")
        if any(traced[n] < 3 * c for n, c in per_step.items()):
            raise AssertionError("the trace lacks kernels of the training path")

        # the last save into fresh templates, bitwise
        fresh = init_fid_t5(t5, torch.Generator(device=dev).manual_seed(SEED + 1))
        fresh_opt = make_optimizer(cfg.optim).init(reader.model_params(fresh))
        t0 = time.perf_counter()
        params, opt, meta = ckpt_mod.load_checkpoint(str(ckpt / "last"), fresh.state_dict(),
                                                     fresh_opt)
        secs = time.perf_counter() - t0
        n_bytes = dir_bytes(ckpt / "last") - (ckpt / "last" / "meta.json").stat().st_size
        paths = jax_param_paths(fresh)
        del fresh, fresh_opt
        n_params = same_tree("params", {paths[k]: v for k, v in params.items()},
                             result.state.params)
        n_opt = same_tree("optimizer state", opt, result.state.opt_state)
        want_meta = {"step": steps, "best_eval_metric": trained["best_dev_em"]}
        log(f"  load last: {n_bytes / 1e9:.3f} GB in {secs:.2f} s, {n_bytes / 1e9 / secs:.2f} "
            f"GB/s (host clock, torch.load to the CPU); {len(params)} params "
            f"({n_params / 1e9:.3f} GB) and the optimizer state ({n_opt / 1e9:.3f} GB: the "
            f"8-bit codes and scales, counts) bitwise equal to the trained state; meta {meta}")
        if meta != want_meta:
            raise AssertionError(f"meta {meta}, expected {want_meta}")
        del params, opt, result
        gc.collect()
        torch.cuda.empty_cache()

        # a full resume and a warm start, one epoch each
        for reset, want_step in ((False, steps + steps // TRAIN_EPOCHS),
                                 (True, steps // TRAIN_EPOCHS)):
            t0 = time.perf_counter()
            run = reader.train_reader(cfg.replace(epochs=1, profile_dir=None), train, evals,
                                      tok, t5_config=t5, save_checkpoints=False,
                                      resume_from=str(tmp / "ckpt" / "reader"),
                                      reset_params=reset, device=dev)
            log(f"  resume (reset_params={reset}) for 1 epoch: final_step {run.final_step} "
                f"(expected {want_step}), optimizer count {run.state.opt_state[1].count}, "
                f"{time.perf_counter() - t0:.1f} s")
            if run.final_step != want_step or run.state.opt_state[1].count != want_step:
                raise AssertionError("the resumed run did not go on from the expected step")
            del run
            gc.collect()
            torch.cuda.empty_cache()

        # eval-reader with results and scores
        scored = cli(["eval-reader", *common, "--eval-data", str(tmp / "eval.json"),
                      "--model-path", str(tmp / "ckpt" / "reader" / "checkpoint" / "last"),
                      "--write-results", str(tmp / "results.json"),
                      "--write-crossattention-scores", str(tmp / "scored.json")])
        rows = json.loads((tmp / "results.json").read_text())
        examples = json.loads((tmp / "scored.json").read_text())
        sums = [sum(f["score"] for f in ex["fact"][:n_facts]) for ex in examples]
        finite = all(math.isfinite(f["score"]) for ex in examples
                     for f in ex["fact"][:min(n_facts, len(ex["fact"]))])
        log(f"  eval-reader: {scored}; {len(rows)} result rows, {len(examples)} scored "
            f"examples, score sums {min(sums):.7f}..{max(sums):.7f}")
        if (sorted(scored) != RESULT_KEYS or any(sorted(r) != RESULT_ROW_KEYS for r in rows)
                or len(examples) != len(evals) or not finite
                or max(abs(x - 1.0) for x in sums) > SCORE_SUM_TOL
                or any(sorted(ex) != sorted(ev) for ex, ev in zip(examples, evals))):
            raise AssertionError("eval-reader's outputs are not the JAX stage's")

        # the card's generate-and-score on the first eval batch
        model = init_fid_t5(t5, torch.Generator(device=dev).manual_seed(0), torch.bfloat16)
        model.load_state_dict(ckpt_mod.load_checkpoint(str(ckpt / "last"),
                                                       model.state_dict())[0])
        ds = ReaderDataset(evals, cfg.data, seed=cfg.seed)
        batch = ReaderCollator(cfg.data, tok)([ds[i] for i in range(cfg.eval_batch_size)])
        ids, mask, spans = (torch.from_numpy(a).to(dev) for a in (
            batch.passage_ids, batch.passage_mask, batch.fact_spans))
        signal_cfg = AttentionSignalConfig(n_context=n_facts)
        tokens, fact_scores = make_generate_and_score_fn(
            model, signal_cfg, max_length=cfg.eval_max_length)(ids, mask, spans)
        want_tokens, xl = make_best_generate_fn(model, max_length=cfg.eval_max_length,
                                                collect_cross_scores=True)(ids, mask)
        want = aggregate_fact_scores(xl.cpu().numpy(), batch.passage_mask, batch.fact_spans,
                                     signal_cfg)
        got = fact_scores.cpu().numpy()
        err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
        log(f"  make_generate_and_score_fn on the first eval batch: tokens "
            f"{'equal' if torch.equal(tokens, want_tokens) else 'DIFFER'} to "
            f"make_best_generate_fn's; scores {tuple(got.shape)} within rel {err:.3e} of the "
            f"numpy aggregation of the engine's step-0 logits (bound {SCORE_RTOL:g})")
        if not torch.equal(tokens, want_tokens) or err > SCORE_RTOL:
            raise AssertionError("make_generate_and_score_fn disagrees on the card")
        del model, xl
        gc.collect()
        torch.cuda.empty_cache()

        # eval answers/s on the 96 training examples, with and without scores
        rates = []
        for with_scores in (False, True, True, False):
            extra = ["--write-crossattention-scores", str(tmp / "s.json")] * with_scores
            out = cli(["eval-reader", *common, "--eval-data", str(tmp / "train.json"),
                       "--model-path", str(ckpt / "last"), *extra])
            rates.append(out["answers_per_sec"])
        log(f"  eval-reader answers/s over {len(train)} examples (host clock over the decode "
            f"loop, B=8, max_length 20, engine with CUDA graphs): without scores "
            f"{rates[0]:.2f}, {rates[3]:.2f}; with scores {rates[1]:.2f}, {rates[2]:.2f}")
    log(f"reader pipeline phase: {time.perf_counter() - t_phase:.1f} s wall")
    return launches


# the main-path run each kernel's launch count comes from: (phase, route)
LAUNCHES_FROM = {"streamed_attention": ("training", "streamed"),
                 "streamed_attention_bwd_dkdv": ("training", "streamed"),
                 "streamed_attention_bwd_dq": ("training", "streamed"),
                 "streamed_attention_bwd_drel": ("training", "streamed"),
                 "fused_decode_cross_attention": ("profiled", "chunked"),
                 "fused_attention": ("training", "fused"),
                 "fused_adam8_update_leaves": ("training", "fused"),
                 "adam8_ema_fragment": ("floor_proof", "micro")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from lako_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, "
        f"count {torch.cuda.device_count()}")

    sm_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                   "--format=csv,noheader,nounits"], capture_output=True,
                                  text=True, check=True, timeout=60).stdout.split()[0])
    log(f"SM clock, maximum: {sm_mhz:.0f} MHz (nvidia-smi clocks.max.sm)")

    t0 = time.perf_counter()
    ptxas = start_ptxas(_build)
    _build.load_library()
    log(f"build: {_build.library_path().name} in {time.perf_counter() - t0:.1f} s")
    nvcc_dir = Path(_build.find_nvcc()).parent
    ptxas_report(ptxas, nvcc_dir)
    sass_report(_build, nvcc_dir)

    kernels = [check_streamed(dev), *check_streamed_bwd(dev), check_decode_cross(dev),
               check_fused(dev), *check_adam8(dev, sm_mhz)]
    check_streamed_long(dev)
    gc.collect()
    torch.cuda.empty_cache()
    runs = {"floor_proof": run_floor_proof(dev)}   # K5 and K6
    gc.collect()
    torch.cuda.empty_cache()
    runs["serving"], shared = run_slice(dev)    # K1 or K4, and K3
    gc.collect()
    torch.cuda.empty_cache()
    runs["decode"] = run_decode(dev, shared)    # K1 and K3 in captured chunks
    del shared
    gc.collect()
    torch.cuda.empty_cache()
    runs["training"] = run_training(dev)        # K1 + K2a/K2b/K2c, or K4 + K5 (once a step)
    gc.collect()
    torch.cuda.empty_cache()
    runs["pipeline"] = run_reader_pipeline(dev)  # K1 + K2a/K2b/K2c + K5 through the CLI
    gc.collect()
    torch.cuda.empty_cache()
    runs["profiled"] = run_profiled(dev)         # K3 in captured chunks, from a trace
    for entry_ in kernels:
        phase, route = LAUNCHES_FROM[entry_["name"]]
        entry_["launches"] = runs[phase][route][entry_["name"]]
        if entry_["name"] == "fused_decode_cross_attention":
            entry_["device_launches"] = runs[phase][route]["device_launches"]
    log(f"launches: {({e['name']: e['launches'] for e in kernels})} (K1 and K2 from the "
        f"streamed route's train_reader run, K3 from the chunked service's profiled run, "
        f"with its device_launches from the trace, K4 and K5 from the whole-block route's "
        f"train_reader run, K6 from the floor proof)")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
