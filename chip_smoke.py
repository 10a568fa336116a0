#!/usr/bin/env python3
"""Smoke test of the PyTorch port (lako_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit, torch's device name).
2. Builds the CUDA kernels from ``lako_tpu_torch/csrc`` with nvcc and the
   host engines from ``lako_tpu_torch/csrc/host`` with g++ (a failed build
   fails the run) and, beside the build, prints the registers and spill bytes ptxas reports for each
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
8. Retriever pipeline (LaKo's second stage), at bert-base width (12 layers,
   hidden 768, vocab 30522, indexing_dimension 256, L=130), random weights
   from ``init_retriever`` (seed 0), through the CLI in this process:
   ``train-retriever`` with RetrieverTrainConfig's defaults (B=8,
   n_context 10, bf16 compute, f32 masters, AdamW, dropout 0.1) for 2 epochs
   on 96 synthetic examples (examples/s over the steps after the first, peak
   memory, losses, inversions, checkpoint size; a non-finite loss or a
   missing ``best_dev`` / ``last`` fails); ``embed-facts`` of a seeded
   corpus of 16,384 sentences in f32 (sentences/s); ``retrieve`` of 96
   questions with exact, fast and pq (n_docs 500) and ``--small-range``,
   then ``eval-facts`` (every output in the JAX stage's schema; exact's ids
   those of a DenseIndex built on the CPU from the same embeddings.npy and
   question embeddings); and the
   index at LaKo's scale, 300,600 x 256 seeded f32 rows with one row copied
   599 times and 2,000 rows copied once, 5,046 queries at k=500: exact held
   to a float64 oracle on the card (scores within 1e-5 relative, ids equal
   wherever the float64 scores differ by more than the float32 rounding,
   equal rows lowest first), bitwise the same with TF32 turned on, fast and
   approx recall@500 against it, PQ-32x8 held to its reconstruction's
   float64 inner products, queries/s and ms per 2,048-query batch of each,
   PQ's bytes and its k-means and encode seconds, rerank at 500
   candidates, and the device time of the tie-ordered top-k against a
   float32 ``torch.topk``. This path has no kernel of csrc/: every wrapper's
   count stays 0, and the run checks that.
9. LaKo served end to end (``run_served_retrieval``): ``LakoService`` at
   t5-large width on the whole-block route (K4) with int8 K/V through K3 on
   CUDA graphs retrieves each of the 20 requests' facts with a BERT-base
   retriever (RetrieverConfig's defaults, random weights) from an exact
   DenseIndex of 300,600 x 256 f32 rows (16,384 of them the retriever's own
   embeddings of a seeded corpus, the rest seeded normal rows at those
   norms): the facts against a float64 top-n_context of the same question
   embeddings, the answers against those with the retrieved facts passed
   in (tokens identical), K4's and K3's launches; answers/s with and
   without retrieval, retrieval ms a batch, peak memory, the card.
10. LaKo's loop through the CLI (``run_lako_loop``), t5-large's and
   bert-base's widths at 2 layers each: ``mine-candidates`` over 4,096
   seeded triples (64 train and 16 eval questions), ``build-tokenizer``,
   ``full-loop --iterations 2 --fact-ablation`` on the streamed route (K1,
   K2a/K2b/K2c counted against the steps and evaluations), the history's
   JSON schema with its diagnostics, the two readers' hashes different;
   then ``serve`` as a subprocess on the last iteration's reader,
   retriever, fact index and corpus, and one POST to it (an answer and
   n_context facts of the corpus).
11. Warm start from an HF checkpoint (``run_hf_warm_start``): whether
   ``tokenizers`` and ``safetensors`` are installed (not imported); t5-large
   at full width and depth (24+24 layers, vocab 32,128, relu, tied, dropout
   0) written by this script as an HF save_pretrained directory
   (config.json, one f32 model.safetensors under HF's tensor names) and read
   back by ``load_hf_t5`` onto the card, every tensor bitwise (GB/s); a
   unigram tokenizer.json from ``build-tokenizer --kind unigram`` (without
   ``tokenizers``: written here in the trainer's layout, the CLI raising
   naming the package), its ids by ``load_tokenizer``, the plain reader and
   ``tokenizers`` equal; ``train-reader --model-path <dir>`` with Adafactor,
   B=8, N=2, L=130, on the streamed route for 4 steps and one evaluation
   (K1, K2a/K2b/K2c counted), its first loss within 1e-5 of the same
   weights' loss in this process, and ``eval-reader --model-path <dir>``;
   examples/s, peak memory and optimizer-state bytes of Adafactor beside
   AdamW; ``NativeIndex`` and ``HostIndex`` at 300,600 x 256, 64 queries,
   k=500, against the exact DenseIndex (host ms a batch); a seeded obj36
   TSV (256 images x 36 boxes x 2048 features) by the C++ and the Python
   loader, arrays equal (rows/s). Phase 10's mine-candidates ranks with the
   C++ BM25.
12. After every timed phase, under torch.profiler: a new chunked service
   serves the 20 requests; the kernel wrappers' counts (the launches a
   capture records count once, a replay calls no wrapper) and the K3
   kernels that ran on the card, graph replays included, each against the
   count the batches' chunks imply; then the kernels of one decode step.
13. Prints the whole script's time, the kernel summary as one JSON line,
    the nvidia-smi line again,
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
import os
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


# filler kernels that end a profiler window whose kernels are counted
DRAIN_KERNELS = 32768
DRAIN_KERNEL = "spin_kernel"        # torch.cuda._sleep's kernel


def drain_trace() -> None:
    """End a profiler window with DRAIN_KERNELS filler kernels and a pause
    after the work it counts. A window can lose its last activity records at
    its close (CUPTI hands over only buffers whose records are complete): one
    full run of this script counted 3516 of the 3552 K3 kernels below, the
    wrapper counts and the next run exact. The filler takes the tail, and
    how many of it the trace holds is printed beside the count."""
    for _ in range(DRAIN_KERNELS):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()
    time.sleep(0.5)


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
        drain_trace()
    launches = read_counts()
    k3_runs = device_kernels(prof, K3_KERNEL)
    drained = device_kernels(prof, DRAIN_KERNEL)
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
        f"the {captured} captured steps); the trace's tail: {drained} of the {DRAIN_KERNELS} "
        f"filler kernels after the run")
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


# the retriever pipeline (run_retriever_pipeline)
RETRIEVER_EPOCHS = 2
CORPUS_SENTENCES = 16_384
RETRIEVE_QUESTIONS = 96
LAKO_FACTS, LAKO_DIM = 300_600, 256          # SURVEY.md: the KG corpus, 256-d embeddings
OKVQA_QUESTIONS, LAKO_K = 5046, 500          # the OK-VQA split VERDICT.md cites; n_docs
SEARCH_BATCH = 2048                          # DenseIndex.search's query batch
TIE_GROUP = 600                              # copies of one row in the scale index
TIE_PAIRS = 2000                             # rows copied once
SCORE_RTOL = 1e-5                            # exact and PQ scores against float64
# fast / approx against exact at k=500: bf16 rounding swaps a few rows at the
# boundary (recall ~0.99 expected); below this the search is broken, not rounded
RECALL_MIN = 0.95
SUBJECTS = ANIMALS + ["boy", "girl", "farmer", "car", "train", "boat", "clock", "chair",
                      "tree", "bird"]
RELATIONS = ["is near", "eats", "is bigger than", "lives in", "sounds like", "has",
             "is used for", "is part of"]
ADJECTIVES = ["red", "old", "small", "large", "wooden", "quiet", "wild", "green", "shiny",
              "wet", "cold", "tall"]
OBJECTS = ["barn", "river", "field", "house", "road", "forest", "kitchen", "garden", "city",
           "hill", "lake", "table", "fence", "bridge", "park", "school", "market", "tower",
           "beach", "cave"]
RETRIEVE_KEYS = {"retrieve": ["n_docs", "retrieved"], "rerank": ["reranked"]}
TRAIN_KEYS = ["best_inversions", "history", "steps"]
HISTORY_KEYS = ["epoch", "inversions", "loss", "seconds"]
EXAMPLE_KEYS = ["answer", "caption", "fact", "img_id", "question", "target"]
FACT_KEYS = ["id", "score", "sentence"]
PQ_FILES = ["codebooks.npy", "codes.npy", "ids.npy", "meta.json", "source.json"]


def synthetic_corpus(n: int, seed: int):
    """``n`` seeded KG-style sentences ``[{sentence, id}]``: the fixture's
    eight facts (cat says meow.) and random ``subject relation adjective
    object.`` sentences, some of them drawn more than once (exact ties)."""
    rng = np.random.default_rng(seed)
    facts = [f"{a} says {s}." for a, s in zip(ANIMALS[:8], SOUNDS[:8])]
    picks = [rng.integers(len(w), size=n) for w in (SUBJECTS, RELATIONS, ADJECTIVES, OBJECTS)]
    facts += [f"the {SUBJECTS[a]} {RELATIONS[b]} the {ADJECTIVES[c]} {OBJECTS[d]}."
              for a, b, c, d in zip(*picks)][:n - len(facts)]
    return [{"sentence": s, "id": i} for i, s in enumerate(facts)]


def near_tie_check(what, got_ids, got_s, want_ids, want_s, tol):
    """Rank by rank, the scores within ``tol`` (per row) and the ids equal
    wherever the two lists' scores at that rank differ by more than
    ``tol``: two sums of one dot product in another order may swap rows
    whose scores lie within their rounding. Returns the ranks swapped."""
    tol = np.broadcast_to(np.asarray(tol, np.float64).reshape(-1, 1), got_s.shape)
    gap = np.abs(got_s.astype(np.float64) - want_s.astype(np.float64))
    if (gap > tol).any():
        r, j = np.argwhere(gap > tol)[0]
        raise AssertionError(f"{what}: score {got_s[r, j]} at row {r} rank {j}, expected "
                             f"{want_s[r, j]} within {tol[r, j]:.3e}")
    return int((got_ids != want_ids).sum())


def timed_search(index, queries, k, repeat=2):
    """(ids, scores, seconds of each full search, seconds of one
    SEARCH_BATCH-query search): host clock, the results on the host."""
    index.search(queries[:SEARCH_BATCH], k)                     # warm-up
    full, batch = [], []
    for _ in range(repeat):
        t0 = time.perf_counter()
        ids, scores = index.search(queries, k)
        full.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        index.search(queries[:SEARCH_BATCH], k)
        batch.append(time.perf_counter() - t0)
    return ids, scores, full, batch


def float64_topk(dev, emb64, queries, k):
    """The float64 oracle on the card: (ids, scores) of the k+1 largest
    inner products per query, and a function giving the float64 score of
    any (query, row) pairs."""
    q64 = torch.as_tensor(queries, dtype=torch.float64, device=dev)
    ids, scores = [], []
    for s in range(0, len(q64), SEARCH_BATCH):
        top = torch.topk(q64[s:s + SEARCH_BATCH] @ emb64.T, k + 1, dim=1)
        ids.append(top.indices.cpu().numpy())
        scores.append(top.values.cpu().numpy())

    def exact64(rows):
        out = []
        for s in range(0, len(q64), SEARCH_BATCH):
            r = torch.as_tensor(rows[s:s + SEARCH_BATCH], device=dev)
            out.append(torch.einsum("qkd,qd->qk", emb64[r], q64[s:s + SEARCH_BATCH]).cpu())
        return torch.cat(out).numpy()

    return np.concatenate(ids), np.concatenate(scores), exact64


def check_against_oracle(what, ids, scores, oracle_ids, oracle_s, exact64):
    """A search's results against the float64 oracle: each score within
    SCORE_RTOL of the float64 score of its row, the ranks in float64 order,
    and the ids equal to the oracle's wherever the float64 scores at that
    rank differ by more than the float32 rounding (twice the largest float32
    error the row shows). Returns (ranks swapped within the rounding, worst
    relative error)."""
    k = ids.shape[1]
    s64 = exact64(ids)
    rel = np.abs(scores - s64) / np.abs(s64)
    if rel.max() > SCORE_RTOL:
        raise AssertionError(f"{what}: relative error {rel.max():.3e} > {SCORE_RTOL:g}")
    rounding = 2 * np.abs(scores - s64).max(axis=1)
    swapped = near_tie_check(what, ids, s64, oracle_ids[:, :k], oracle_s[:, :k], rounding)
    return swapped, float(rel.max())


def check_ties(what, ids, group, pairs, aligned):
    """Equal rows lowest first: the queries aligned with the copied row get
    the group's lowest rows in order; wherever a copy of a pair appears, the
    lower row appears too and before it. Returns the pairs seen together."""
    for r in aligned:
        if not np.array_equal(ids[r], group[:ids.shape[1]]):
            raise AssertionError(f"{what}: query {r} did not get the lowest {ids.shape[1]} "
                                 f"rows of the tied group in order")
    partner = np.full(LAKO_FACTS, -1)
    partner[pairs[:, 1]] = pairs[:, 0]
    lower = partner[ids]
    seen = np.argwhere(lower >= 0)
    for r, j in seen:
        if not (ids[r, :j] == lower[r, j]).any():
            raise AssertionError(f"{what}: row {ids[r, j]} ranks without, or before, its "
                                 f"equal row {lower[r, j]}")
    return len(seen)


def check_retrieved(what, rows, examples, n_facts):
    """A retrieve output file against the JAX stage's schema."""
    if len(rows) != len(examples) or any(
            sorted(r) != EXAMPLE_KEYS or len(r["fact"]) != n_facts
            or any(sorted(f) != FACT_KEYS or not math.isfinite(f["score"]) for f in r["fact"])
            or [f["score"] for f in r["fact"]] != sorted((f["score"] for f in r["fact"]),
                                                        reverse=True)
            for r in rows):
        raise AssertionError(f"{what}: the output is not the JAX stage's schema")


def run_retriever_pipeline(dev):
    """LaKo's second stage at bert-base width through the CLI
    (lako_tpu_torch.pipeline.cli.main in this process), in a temporary
    directory: train-retriever (RetrieverTrainConfig's defaults, 2 epochs,
    examples/s over the steps after the first, peak memory, checkpoints);
    embed-facts over a seeded corpus of CORPUS_SENTENCES sentences in f32
    (sentences/s); retrieve with exact, fast and pq and --small-range,
    exact held to a DenseIndex built on the CPU, then eval-facts; and the
    index at LaKo's scale (LAKO_FACTS x LAKO_DIM with tied rows, OKVQA_QUESTIONS
    queries at k=LAKO_K): exact held to a float64 oracle on the card and to
    its own ties, TF32 on for one exact search, fast/approx recall, PQ-32x8
    held to its reconstruction, queries/s of each, rerank at LAKO_K
    candidates, and the tie-ordered top-k's cost against a float32 top-k.
    No kernel of lako_tpu_torch/csrc is on this path: the launch counts stay
    0. Returns them."""
    from lako_tpu_torch.core.config import RetrieverTrainConfig
    from lako_tpu_torch.pipeline import stages
    from lako_tpu_torch.retrieval import pq as pq_mod
    from lako_tpu_torch.retrieval.index import DenseIndex, RunningTopK, tie_keys
    from lako_tpu_torch.train import retriever as retriever_mod

    t_phase = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "lako_fixtures", Path(__file__).resolve().parent / "tests" / "fixtures.py")
    fixtures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixtures)
    cfg = RetrieverTrainConfig(epochs=RETRIEVER_EPOCHS, seed=SEED)
    n_ctx, B = cfg.n_context, cfg.per_device_batch_size
    train = fixtures.make_examples(TRAIN_EXAMPLES, n_facts=n_ctx, seed=SEED)
    evals = fixtures.make_examples(EVAL_EXAMPLES, n_facts=n_ctx, seed=SEED + 100)
    questions = fixtures.make_examples(RETRIEVE_QUESTIONS, n_facts=n_ctx, seed=SEED + 200)
    corpus = synthetic_corpus(CORPUS_SENTENCES, SEED)
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        for name, data in (("train", train), ("eval", evals), ("questions", questions),
                           ("corpus", corpus)):
            (tmp / f"{name}.json").write_text(json.dumps(data))
        out = cli(["build-tokenizer", "--from-json", str(tmp / "train.json"),
                   str(tmp / "corpus.json"), "--out", str(tmp / "btok.json"), "--style", "bert"])
        cfg = cfg.replace(checkpoint_dir=str(tmp / "ckpt"), name="retriever")
        (tmp / "cfg.json").write_text(json.dumps(dataclasses.asdict(cfg)))
        bert = cfg.retriever.bert
        common = ["--config", str(tmp / "cfg.json"), "--tokenizer", str(tmp / "btok.json")]
        log(f"retriever pipeline: build-tokenizer {out}; BERT ({bert.num_hidden_layers} "
            f"layers, hidden {bert.hidden_size}, {bert.num_attention_heads} heads, FFN "
            f"{bert.intermediate_size}, vocab {bert.vocab_size}, {bert.max_position_embeddings} "
            f"positions), indexing_dimension {cfg.retriever.indexing_dimension}, L="
            f"{cfg.retriever.question_maxlength}/{cfg.retriever.passage_maxlength}, random "
            f"weights from init_retriever (seed {SEED}); B={B}, n_context {n_ctx}, {cfg.dtype} "
            f"compute, f32 masters, {cfg.optim.optim} lr {cfg.optim.lr}, dropout "
            f"{bert.hidden_dropout_prob}, {len(train)} train / {len(evals)} eval examples, "
            f"{cfg.epochs} epochs")

        # 1. train-retriever, each step synchronized and timed
        step_s = []
        make_step = retriever_mod.make_retriever_train_step

        def timed_step_maker(model):
            step = make_step(model)

            def timed(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                result = step(*args, **kw)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                return result

            return timed

        retriever_mod.make_retriever_train_step = timed_step_maker
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            trained = cli(["train-retriever", *common, "--train-data", str(tmp / "train.json"),
                           "--eval-data", str(tmp / "eval.json")])
        finally:
            retriever_mod.make_retriever_train_step = make_step
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        losses = [h["loss"] for h in trained["history"]]
        ckpt = tmp / "ckpt" / "retriever" / "checkpoint"
        names = sorted(p.name for p in ckpt.iterdir())
        rate = B * (len(step_s) - 1) / sum(step_s[1:])
        log(f"  train-retriever: {trained['steps']} steps in {seconds:.1f} s; "
            f"{rate:.2f} examples/s over steps 2-{len(step_s)} (host clock, each step "
            f"synchronized; step 1 {step_s[0] * 1e3:.1f} ms, then {min(step_s[1:]) * 1e3:.1f}-"
            f"{max(step_s[1:]) * 1e3:.1f} ms); peak memory {peak:.2f} GB; losses "
            f"{[round(x, 6) for x in losses]}; inversions "
            f"{[h['inversions'] for h in trained['history']]}; checkpoints {names}, best_dev "
            f"{dir_bytes(ckpt / 'best_dev') / 1e9:.3f} GB (params and AdamW state)")
        if (sorted(trained) != TRAIN_KEYS
                or any(sorted(h) != HISTORY_KEYS for h in trained["history"])
                or trained["steps"] != RETRIEVER_EPOCHS * (len(train) // B)
                or not all(math.isfinite(x) for x in losses)
                or not {"best_dev", "last", "latest"} <= set(names)):
            raise AssertionError("train-retriever: a loss is not finite, a checkpoint is "
                                 "missing, or the output is not the JAX stage's")
        model_path = ["--model-path", str(ckpt / "best_dev")]

        # 2. embed-facts in f32, the embedding timed alone
        kept, embed_corpus = {}, stages.embed_corpus

        def timed_embed(*args, **kw):
            t0 = time.perf_counter()
            kept["result"] = embed_corpus(*args, **kw)
            kept["seconds"] = time.perf_counter() - t0
            return kept["result"]

        stages.embed_corpus = timed_embed
        t0 = time.perf_counter()
        try:
            embedded = cli(["embed-facts", *common, *model_path, "--corpus",
                            str(tmp / "corpus.json"), "--out", str(tmp / "index")])
        finally:
            stages.embed_corpus = embed_corpus
        log(f"  embed-facts: {embedded}; {len(corpus)} sentences at L="
            f"{cfg.retriever.passage_maxlength}, batch 512, f32 (TF32 off): "
            f"{len(corpus) / kept['seconds']:.1f} sentences/s over the embedding "
            f"({kept['seconds']:.2f} s), the subcommand {time.perf_counter() - t0:.2f} s")
        if (sorted(embedded) != ["dim", "index_path", "n_facts"]
                or embedded["n_facts"] != len(corpus)
                or sorted(p.name for p in (tmp / "index").iterdir())
                != ["embeddings.npy", "ids.npy", "meta.json"]):
            raise AssertionError("embed-facts: the output is not the JAX stage's")

        # 3. retrieve: exact (held to a CPU index), fast, pq, --small-range; eval-facts
        q_kept, embed_questions = [], stages.embed_questions

        def keep_questions(*args, **kw):
            q_kept.append(embed_questions(*args, **kw))
            return q_kept[-1]

        retrieve = ["retrieve", *common, *model_path, "--index", str(tmp / "index"),
                    "--corpus", str(tmp / "corpus.json"), "--data",
                    str(tmp / "questions.json")]
        rows = {}
        stages.embed_questions = keep_questions
        try:
            for method in ("exact", "fast", "pq", "small-range"):
                extra = (["--small-range"] if method == "small-range"
                         else ["--index-method", method, "--n-docs", str(LAKO_K)])
                t0 = time.perf_counter()
                result = cli([*retrieve, "--out", str(tmp / f"{method}.json"), *extra])
                rows[method] = json.loads((tmp / f"{method}.json").read_text())
                hits = cli(["eval-facts", "--data", str(tmp / f"{method}.json")])
                log(f"  retrieve {method}: {result} in {time.perf_counter() - t0:.2f} s; "
                    f"eval-facts include {hits['include']}, stem {hits['stem']}")
                kind = "rerank" if method == "small-range" else "retrieve"
                check_retrieved(f"retrieve {method}", rows[method], questions,
                                n_ctx if method == "small-range" else LAKO_K)
                if (sorted(result) != RETRIEVE_KEYS[kind] or sorted(hits) != ["include", "stem"]
                        or not all(0.0 <= v <= 1.0 for part in hits.values()
                                   for v in part.values())):
                    raise AssertionError(f"retrieve {method}: the output is not the JAX "
                                         "stage's")
        finally:
            stages.embed_questions = embed_questions
        if sorted(p.name for p in (tmp / "index" / "pq").iterdir()) != PQ_FILES:
            raise AssertionError("retrieve pq: the cached codes are not the JAX layout")
        cpu_index = DenseIndex.load(str(tmp / "index"), device="cpu")
        want_ids, want_s = cpu_index.search(q_kept[0], LAKO_K)
        got_ids = np.array([[f["id"] for f in r["fact"]] for r in rows["exact"]])
        got_s = np.array([[f["score"] for f in r["fact"]] for r in rows["exact"]], np.float32)
        same = int((got_ids == want_ids).sum())
        log(f"  retrieve exact against a DenseIndex built on the CPU from embeddings.npy and "
            f"the same question embeddings: ids equal at {same} of {got_ids.size} ranks; "
            f"scores within {np.abs(got_s - want_s).max():.3e}")
        if same != got_ids.size:
            raise AssertionError("retrieve exact's ids differ from the CPU index's")
        del cpu_index
    launches = read_counts()
    check_counts("the retriever pipeline (no kernel of csrc/ on its path)", launches, {})
    gc.collect()
    torch.cuda.empty_cache()

    run_index_at_scale(dev, DenseIndex, RunningTopK, tie_keys, pq_mod)
    log(f"retriever pipeline phase: {time.perf_counter() - t_phase:.1f} s wall")
    return launches


def run_index_at_scale(dev, DenseIndex, RunningTopK, tie_keys, pq_mod):
    """The index at LaKo's scale: LAKO_FACTS x LAKO_DIM seeded f32 rows,
    one row copied TIE_GROUP - 1 times and TIE_PAIRS rows once, and
    OKVQA_QUESTIONS queries (four aligned with the copied row) at k=LAKO_K."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    emb_dev = torch.randn(LAKO_FACTS, LAKO_DIM, generator=gen, device=dev)
    rng = np.random.default_rng(SEED)
    group = np.sort(np.concatenate([[0], rng.choice(np.arange(1, LAKO_FACTS),
                                                    size=TIE_GROUP - 1, replace=False)]))
    rest = np.setdiff1d(np.arange(LAKO_FACTS), group)
    pairs = np.sort(rng.choice(rest, size=(TIE_PAIRS, 2), replace=False), axis=1)
    emb_dev[torch.as_tensor(group[1:], device=dev)] = emb_dev[0].clone()
    emb_dev[torch.as_tensor(pairs[:, 1], device=dev)] = emb_dev[torch.as_tensor(pairs[:, 0],
                                                                                device=dev)]
    q_dev = torch.randn(OKVQA_QUESTIONS, LAKO_DIM, generator=gen, device=dev)
    aligned = np.arange(4)
    q_dev[:4] = emb_dev[0]
    q_dev[4:8] = emb_dev[torch.as_tensor(pairs[:4, 0], device=dev)]
    emb, queries = emb_dev.cpu().numpy(), q_dev.cpu().numpy()
    emb64 = emb_dev.double()
    del emb_dev, q_dev
    oracle_ids, oracle_s, exact64 = float64_topk(dev, emb64, queries, LAKO_K)
    n_batches = -(-OKVQA_QUESTIONS // SEARCH_BATCH)
    log(f"index at LaKo scale: {LAKO_FACTS} x {LAKO_DIM} f32 rows (seeded, row 0 copied "
        f"{TIE_GROUP - 1} times, {TIE_PAIRS} rows copied once), {OKVQA_QUESTIONS} queries "
        f"({len(aligned)} equal to row 0) at k={LAKO_K}, {n_batches} batches of "
        f"{SEARCH_BATCH}; float64 oracle on the card")

    results, index = {}, None
    for method in ("exact", "fast", "approx"):
        index = DenseIndex(emb, method=method, device=dev)
        ids, scores, full, batch = timed_search(index, queries, LAKO_K)
        results[method] = ids
        line = (f"  {method}: {[round(OKVQA_QUESTIONS / t, 1) for t in full]} queries/s over "
                f"{OKVQA_QUESTIONS}, {[round(t * 1e3, 2) for t in batch]} ms per {SEARCH_BATCH}"
                f"-query batch (host clock, results on the host)")
        if method == "exact":
            swapped, rel = check_against_oracle("exact", ids, scores, oracle_ids, oracle_s,
                                                exact64)
            seen = check_ties("exact", ids, group, pairs, aligned)
            line += (f"; against float64: relative error {rel:.3e} (bound {SCORE_RTOL:g}), "
                     f"ids equal at {ids.size - swapped} of {ids.size} ranks, {swapped} swapped "
                     f"within the float32 rounding; ties: the {len(aligned)} aligned queries "
                     f"got the group's lowest {LAKO_K} rows in order, {seen} copied pairs "
                     f"ranked lower row first")
            exact_s = scores
        else:
            recall = np.mean([len(np.intersect1d(a, b)) / LAKO_K
                              for a, b in zip(ids, results["exact"])])
            line += f"; recall@{LAKO_K} against exact {recall:.5f} (bound {RECALL_MIN})"
            if recall < RECALL_MIN:
                raise AssertionError(f"{method}: recall {recall:.5f} < {RECALL_MIN}")
        log(line)
    exact_index = DenseIndex(emb, method="exact", device=dev)

    # TF32 on, as a caller may set it: exact stays float32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_ids, tf32_s = exact_index.search(queries, LAKO_K)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    same = np.array_equal(tf32_ids, results["exact"]) and np.array_equal(tf32_s, exact_s)
    log(f"  exact with torch.backends.cuda.matmul.allow_tf32 = True: ids and scores "
        f"{'bitwise equal' if same else 'DIFFER'} to the search with it off")
    if not same:
        raise AssertionError("exact search changed with TF32 on")

    # the tie-ordered top-k against a float32 top-k, one batch, device time
    q = torch.as_tensor(queries[:SEARCH_BATCH], device=dev)
    chunks = [exact_index._emb[s:s + exact_index.chunk_size]
              for s in range(0, LAKO_FACTS, exact_index.chunk_size)]
    score_chunks = [q @ c.T for c in chunks]

    def shipped():
        top = RunningTopK(LAKO_K)
        for i, sc in enumerate(score_chunks):
            top.add(sc, i * exact_index.chunk_size)
        return top.result()

    def keyed():
        best = None
        for i, sc in enumerate(score_chunks):
            keys = tie_keys(sc, i * exact_index.chunk_size)
            cat = keys if best is None else torch.cat([best, keys], dim=1)
            best = torch.topk(cat, LAKO_K, dim=1).values
        return best

    def plain():
        best = None
        for sc in score_chunks:
            cat = sc if best is None else torch.cat([best, sc], dim=1)
            best = torch.topk(cat, LAKO_K, dim=1).values
        return best

    def matmuls():
        return [q @ c.T for c in chunks]

    shipped_ms, keyed_ms, plain_ms, mm_ms = (event_ms(fn)
                                             for fn in (shipped, keyed, plain, matmuls))
    log(f"  one {SEARCH_BATCH}-query batch, device time (CUDA events, 5 calls): f32 matmuls "
        f"{mm_ms:.3f} ms; the tie-ordered top-k over {len(chunks)} chunks (RunningTopK: a "
        f"float32 top-k, int64 keys only for rows tied at the boundary) {shipped_ms:.3f} ms; "
        f"int64 keys of every score {keyed_ms:.3f} ms; torch.topk on the float32 scores "
        f"(ties unordered) {plain_ms:.3f} ms")
    del score_chunks

    # rerank at LAKO_K candidates: exact's ids, shuffled per row
    cand = results["exact"][:SEARCH_BATCH].copy()
    for row in cand:
        rng.shuffle(row)
    exact_index.rerank(cand[:64], queries[:64])
    t0 = time.perf_counter()
    rr_ids, rr_s = exact_index.rerank(cand, queries[:SEARCH_BATCH])
    rr_secs = time.perf_counter() - t0
    swapped = near_tie_check("rerank", rr_ids, rr_s, results["exact"][:SEARCH_BATCH],
                             exact_s[:SEARCH_BATCH], 2e-5 * np.abs(exact_s[:SEARCH_BATCH]).max(1))
    log(f"  rerank of {SEARCH_BATCH} queries x {LAKO_K} shuffled candidates: "
        f"{rr_secs * 1e3:.2f} ms (host clock), {SEARCH_BATCH / rr_secs:.1f} queries/s; the "
        f"exact order back at {rr_ids.size - swapped} of {rr_ids.size} ranks, {swapped} "
        f"swapped within 2e-5 (relative)")
    del exact_index, index
    gc.collect()
    torch.cuda.empty_cache()

    # PQ-32x8: train and encode on the host, codes on the card
    encode_s, encode = [], pq_mod.PQIndex._encode

    def timed_encode(*args, **kw):
        t0 = time.perf_counter()
        codes = encode(*args, **kw)
        encode_s.append(time.perf_counter() - t0)
        return codes

    pq_mod.PQIndex._encode = staticmethod(timed_encode)
    t0 = time.perf_counter()
    try:
        pq = pq_mod.PQIndex.train(emb, n_subquantizers=32, n_bits=8, device=dev)
    finally:
        pq_mod.PQIndex._encode = staticmethod(encode)
    train_s = time.perf_counter() - t0 - encode_s[0]
    ids, scores, full, batch = timed_search(pq, queries, LAKO_K)
    recon = pq.decompress(0, pq.n).double()
    pq_ids, pq_s, recon64 = float64_topk(dev, recon, queries, LAKO_K)
    swapped, rel = check_against_oracle("pq", ids, scores, pq_ids, pq_s, recon64)
    recall = np.mean([len(np.intersect1d(a, b)) / LAKO_K for a, b in zip(ids, results["exact"])])
    log(f"  pq-32x8: {pq.nbytes() / 1e6:.3f} MB of codes and codebooks (the f32 corpus "
        f"{emb.nbytes / 1e6:.1f} MB); k-means {train_s:.2f} s, encode {encode_s[0]:.2f} s "
        f"(numpy, host); {[round(OKVQA_QUESTIONS / t, 1) for t in full]} queries/s, "
        f"{[round(t * 1e3, 2) for t in batch]} ms per {SEARCH_BATCH}-query batch; scores "
        f"against the reconstruction's float64 inner products: relative error {rel:.3e}, ids "
        f"equal at {ids.size - swapped} of {ids.size} ranks; recall@{LAKO_K} against exact "
        f"{recall:.5f}")
    del pq, recon, emb64
    gc.collect()
    torch.cuda.empty_cache()


# LaKo served end to end: the retriever at bert-base width over an index at LaKo's scale
RETRIEVAL_CORPUS = 16_384                    # the retriever's own embeddings in the index
HISTORY_KEYS_LOOP = ["diagnostics", "eval", "hit_at_k_include", "iteration", "reader_best_em",
                     "retriever_best_inversions"]                      # full_loop.py
DIAGNOSTIC_KEYS = {1: ["fact_shuffle_ablation", "hit_conditioned", "reader_ckpt",
                       "reader_ckpt_sha256", "retriever_inversions_vs_v1_gold"]}
DIAGNOSTIC_KEYS[2] = sorted(DIAGNOSTIC_KEYS[1] + ["answers_vs_prev", "train_fact_diff_vs_prev"])
LOOP_TRIPLES, LOOP_TRAIN, LOOP_EVAL = 4096, 64, 16
LOOP_LAYERS, LOOP_BERT_LAYERS, LOOP_EPOCHS = 2, 2, 1
SERVE_START_S = 300                          # the serve subprocess's start-up, at most


def power_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def run_served_retrieval(dev):
    """LaKo served end to end on the whole-block route (K4) with int8 K/V
    through K3 on CUDA graphs: LakoService at t5-large width retrieves each
    request's facts with a BERT-base retriever (RetrieverConfig's defaults,
    random weights from init_retriever) from an exact DenseIndex of
    LAKO_FACTS x LAKO_DIM f32 rows (rows 0-RETRIEVAL_CORPUS-1 the retriever's
    own embeddings of a seeded corpus, the rest seeded normal rows scaled to
    the norms of those embeddings), then reads. Each request's facts are
    held to a float64 top-n_context of the same question embeddings over
    the index, the answers to those the service gives with the retrieved
    facts passed in, and K4's and K3's launches to run_slice's counts for 20
    requests. Prints answers/s with and without retrieval, retrieval ms a
    batch (embedding and search, CUDA events), peak memory and the card.
    Returns the served run's launches."""
    from lako_tpu_torch.core.config import RetrieverConfig
    from lako_tpu_torch.models.bert import init_retriever
    from lako_tpu_torch.retrieval.embed import embed_corpus, make_embed_fn
    from lako_tpu_torch.retrieval.index import DenseIndex
    from lako_tpu_torch.serve import LakoService
    from lako_tpu_torch.text.tokenizer import WordVocabTokenizer

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, tok, requests = serving_setup(dev)
    t5 = serving_t5("fused")
    questions = [{"question": r["question"], "caption": r["caption"]} for r in requests]
    rcfg = RetrieverConfig()
    retriever = init_retriever(rcfg, torch.Generator(device=dev).manual_seed(SEED))
    corpus = synthetic_corpus(RETRIEVAL_CORPUS, SEED)
    rest = synthetic_corpus(LAKO_FACTS - RETRIEVAL_CORPUS, SEED + 1)
    sentences = [r["sentence"] for r in corpus] + [r["sentence"] for r in rest]
    btok = WordVocabTokenizer.build(sentences[:RETRIEVAL_CORPUS] + [
        f"{q['question']} {q['caption']}" for q in questions], style="bert")
    t0 = time.perf_counter()
    _, own = embed_corpus(retriever, corpus, btok)
    embed_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    filler = rng.standard_normal((LAKO_FACTS - RETRIEVAL_CORPUS, LAKO_DIM)).astype(np.float32)
    norms = np.linalg.norm(own, axis=1)[rng.integers(RETRIEVAL_CORPUS, size=len(filler))]
    filler *= (norms / np.linalg.norm(filler, axis=1))[:, None]
    emb = np.concatenate([own, filler])
    index = DenseIndex(emb, device=dev)
    bert = rcfg.bert
    log(f"served retrieval: t5-large ({t5.num_layers}+{t5.num_decoder_layers} layers), bf16, "
        f"whole-block route K4 (flash_min_length={t5.flash_min_length} > L="
        f"{cfg.data.text_maxlength}), int8 K/V through K3 on CUDA graphs, B={cfg.batch_size}, "
        f"n_context {cfg.n_context}; retriever BERT ({bert.num_hidden_layers} layers, hidden "
        f"{bert.hidden_size}, {bert.num_attention_heads} heads), indexing_dimension "
        f"{rcfg.indexing_dimension}, question_maxlength {rcfg.question_maxlength}, f32, random "
        f"weights (init_retriever, seed {SEED}); exact DenseIndex {LAKO_FACTS} x {LAKO_DIM} f32 "
        f"({emb.nbytes / 1e6:.1f} MB): rows 0-{RETRIEVAL_CORPUS - 1} the retriever's "
        f"embeddings of synthetic_corpus({RETRIEVAL_CORPUS}, {SEED}) ({RETRIEVAL_CORPUS / embed_s:.1f} "
        f"sentences/s), the rest seeded normal rows at those norms; {len(requests)} requests "
        f"without facts")
    service = LakoService(cfg, t5, params, tok, retriever=retriever, bert_tokenizer=btok,
                          index=index, id_to_sentence=dict(enumerate(sentences)), device=dev)
    del retriever
    service.answer_batch(questions[:1])          # warm-up: cuBLAS, the graph capture
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    examples, tokens = service.generate_tokens(questions)
    with_s = time.perf_counter() - t0
    launches = read_counts()
    check_counts("the served run with retrieval (whole-block route)", launches,
                 {"fused_attention": 3 * t5.num_layers,
                  "fused_decode_cross_attention": 3 * t5.num_decoder_layers})

    # the facts against a float64 top-n_context of the same question embeddings
    k = cfg.n_context
    texts = [q["question"] + " " + q["caption"] for q in questions]
    q_emb = make_embed_fn(service.retriever, "q")(
        *btok.batch_encode(texts, rcfg.question_maxlength))
    emb64 = torch.as_tensor(emb, dtype=torch.float64, device=dev)
    oracle_ids, oracle_s, exact64 = float64_topk(dev, emb64, q_emb, k)
    got_ids = np.array([[f["id"] for f in ex["fact"]] for ex in examples])
    got_s = np.array([[f["score"] for f in ex["fact"]] for ex in examples], np.float32)
    if got_ids.shape != (len(questions), k) or any(
            f["sentence"] != sentences[f["id"]] for ex in examples for f in ex["fact"]):
        raise AssertionError("served retrieval: the facts are not n_context corpus rows")
    swapped, rel = check_against_oracle("served retrieval", got_ids, got_s, oracle_ids,
                                        oracle_s, exact64)
    own_rows = int((got_ids < RETRIEVAL_CORPUS).sum())
    del emb64

    # the same requests with the retrieved facts passed in, then each way again
    explicit = [dict(q, fact=ex["fact"]) for q, ex in zip(questions, examples)]
    seconds = {"with": [with_s], "without": []}
    for kind in ("without", "with", "without"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, again = service.generate_tokens(questions if kind == "with" else explicit)
        seconds[kind].append(time.perf_counter() - t0)
        require_same(f"answers {kind} retrieval against the first run's", again, tokens)
    retrieval_ms = event_ms(lambda: service.retrieve_facts(questions[:cfg.batch_size]))
    answers = tok.batch_decode(tokens)
    log(f"  facts against a float64 top-{k} of the same question embeddings: scores within "
        f"{rel:.3e} (relative; bound {SCORE_RTOL:g}), ids equal at {got_ids.size - swapped} of "
        f"{got_ids.size} ranks, {swapped} swapped within the float32 rounding; {own_rows} of "
        f"them embedded sentences, {got_ids.size - own_rows} filler rows")
    rates = {k: [round(len(questions) / s, 2) for s in v] for k, v in seconds.items()}
    log(f"  {len(questions)} requests (3 batches), answers/s in turns, host clock: with "
        f"retrieval {rates['with']}, with the retrieved facts passed in {rates['without']}; "
        f"retrieval {retrieval_ms:.3f} ms a batch of {cfg.batch_size} (embedding and search, "
        f"CUDA events, 5 calls); peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"first answers {[a[:40] for a in answers[:2]]!r}; {power_line()}")
    del service, index
    gc.collect()
    torch.cuda.empty_cache()
    log(f"served retrieval phase: {time.perf_counter() - t_phase:.1f} s wall")
    return {"fused": launches}


def loop_inputs(tmp: Path) -> None:
    """Seeded synthetic KG triples and cache-format questions about the
    fixture's animals, with captions: the inputs of mine-candidates."""
    rng = np.random.default_rng(SEED)
    triples = [[a, "says", s] for a, s in zip(ANIMALS, SOUNDS)]
    triples += [[str(SUBJECTS[a]), str(RELATIONS[b]), f"{ADJECTIVES[c]} {OBJECTS[d]}"]
                for a, b, c, d in zip(*(rng.integers(len(w), size=LOOP_TRIPLES - len(triples))
                                        for w in (SUBJECTS, RELATIONS, ADJECTIVES, OBJECTS)))]
    captions = {}
    for split, n in (("train", LOOP_TRAIN), ("eval", LOOP_EVAL)):
        rows = []
        for i in range(n):
            a = int(rng.integers(len(ANIMALS)))
            img = f"{split}{i}"
            rows.append({"sent": f"what sound does the {ANIMALS[a]} make?",
                         "label": {SOUNDS[a]: 1.0}, "img_id": img, "question_id": i})
            captions[img] = [f"a {ANIMALS[a]} near the {OBJECTS[int(rng.integers(len(OBJECTS)))]}",
                             {"caption": f"an animal in a {ADJECTIVES[int(rng.integers(12))]} "
                                         f"{OBJECTS[int(rng.integers(len(OBJECTS)))]}."}]
        (tmp / f"{split}_rows.json").write_text(json.dumps(rows))
    (tmp / "triples.json").write_text(json.dumps(triples))
    (tmp / "captions.json").write_text(json.dumps(captions))


def serve_and_post(argv, cwd: Path, log_path: Path, request: dict):
    """``python -m lako_tpu_torch.pipeline serve ... --port 0`` as a
    subprocess: waits for the URL it prints, POSTs ``request`` once and
    stops the process. Returns (the answer, seconds to start, seconds of
    the POST)."""
    import queue

    t0 = time.perf_counter()
    with open(log_path, "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", "lako_tpu_torch.pipeline", *argv,
                                 "--port", "0"], cwd=cwd, stdout=subprocess.PIPE, stderr=err,
                                text=True)
        try:
            lines: "queue.Queue" = queue.Queue()
            threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout] + [lines.put("")],
                             daemon=True).start()
            url = None
            while url is None:
                line = lines.get(timeout=max(1.0, SERVE_START_S - (time.perf_counter() - t0)))
                if not line:
                    raise AssertionError(f"serve ended with code {proc.wait()} before serving: "
                                         f"{log_path.read_text()[-2000:]}")
                if line.startswith("{"):
                    url = json.loads(line).get("serving")
            started = time.perf_counter() - t0
            t1 = time.perf_counter()
            http = urllib.request.Request(url, data=json.dumps(request).encode(),
                                          headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(http, timeout=300) as resp:
                answer = json.loads(resp.read())
            return answer, started, time.perf_counter() - t1
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def run_lako_loop(dev):
    """LaKo's CLI chain at full width and cut depth, in a temporary
    directory: mine-candidates over LOOP_TRIPLES seeded triples writes the
    corpus and each question's BM25 candidates (LOOP_TRAIN train and
    LOOP_EVAL eval questions); build-tokenizer for the reader and the
    retriever; full-loop --iterations 2 --fact-ablation with t5-large's
    widths at LOOP_LAYERS + LOOP_LAYERS layers on the streamed route (K1,
    K2a/K2b/K2c; flash_min_length=128) and bert-base's at LOOP_BERT_LAYERS
    layers; then serve, as a subprocess, on the last iteration's reader,
    retriever, fact index and corpus, and one POST to it. Checks the
    history's JSON schema and diagnostics, the two readers' hashes differ,
    hit@k, the training steps' kernel launches (STEP_LAUNCHES x steps, the
    evaluations' K1 beside them) and the POST's answer and facts. Returns
    the loop's launches."""
    from lako_tpu_torch.core.config import (
        OptimConfig,
        ReaderDataConfig,
        ReaderTrainConfig,
        RetrieverTrainConfig,
        t5_config_for_size,
    )
    from lako_tpu_torch.retrieval import candidates

    t_phase = time.perf_counter()
    # the card by default; a CPU rehearsal asks for its device
    device = [] if dev.type == "cuda" else ["--device", str(dev)]
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        loop_inputs(tmp)
        if dev.type == "cuda" and candidates.bm25_backend() != "C++":
            raise AssertionError("mine-candidates would rank with the Python BM25: the host "
                                 "library did not load")
        t0 = time.perf_counter()
        for split in ("train", "eval"):
            mined = cli(["mine-candidates", "--triples", str(tmp / "triples.json"), "--data",
                         str(tmp / f"{split}_rows.json"), "--captions", str(tmp / "captions.json"),
                         "--out", str(tmp / f"{split}.json"), "--corpus-out",
                         str(tmp / "corpus.json")])
            if mined != {"examples": {"train": LOOP_TRAIN, "eval": LOOP_EVAL}[split],
                         "out": str(tmp / f"{split}.json")}:
                raise AssertionError(f"mine-candidates: {mined}")
        corpus = json.loads((tmp / "corpus.json").read_text())
        train = json.loads((tmp / "train.json").read_text())
        n_cand = [len(ex["fact"]) for ex in train]
        mine_s = time.perf_counter() - t0
        tok_out = cli(["build-tokenizer", "--from-json", str(tmp / "train.json"),
                       str(tmp / "eval.json"), str(tmp / "corpus.json"), "--out",
                       str(tmp / "tok.json")])
        btok_out = cli(["build-tokenizer", "--from-json", str(tmp / "train.json"),
                        str(tmp / "eval.json"), str(tmp / "corpus.json"), "--out",
                        str(tmp / "btok.json"), "--style", "bert"])
        t5 = t5_config_for_size("large", vocab_size=tok_out["vocab_size"], dropout_rate=0.0,
                                use_flash_attention=True).replace(
            flash_min_length=128, num_layers=LOOP_LAYERS, num_decoder_layers=LOOP_LAYERS)
        reader = ReaderTrainConfig(
            model_size="large", per_device_batch_size=8, eval_batch_size=8, epochs=LOOP_EPOCHS,
            early_stop=LOOP_EPOCHS, eval_max_length=20, use_remat=True, dtype="bfloat16",
            param_dtype="float32", seed=SEED, data=ReaderDataConfig(),
            optim=OptimConfig(optim="adamw"))
        retriever = RetrieverTrainConfig(epochs=LOOP_EPOCHS, early_stop=LOOP_EPOCHS, seed=SEED)
        retriever = retriever.replace(retriever=retriever.retriever.replace(
            bert=retriever.retriever.bert.replace(num_hidden_layers=LOOP_BERT_LAYERS)))
        for name, obj in (("t5", t5), ("reader", reader), ("retriever", retriever)):
            (tmp / f"{name}_cfg.json").write_text(json.dumps(dataclasses.asdict(obj)))
        bert = retriever.retriever.bert
        log(f"LaKo loop: mine-candidates over {len(corpus)} triples with the "
            f"{candidates.bm25_backend()} BM25 ({mine_s:.2f} s): "
            f"{LOOP_TRAIN} train / {LOOP_EVAL} eval questions, {min(n_cand)}-{max(n_cand)} "
            f"BM25 candidates each; tokenizers {tok_out['vocab_size']} / "
            f"{btok_out['vocab_size']} words; reader t5-large widths (d_model {t5.d_model}, "
            f"{t5.num_heads} heads, d_kv {t5.d_kv}, d_ff {t5.d_ff}) cut to {t5.num_layers}+"
            f"{t5.num_decoder_layers} layers (of 24+24), streamed kernels "
            f"(flash_min_length=128), bf16, f32 masters, remat, AdamW, B=8, n_context "
            f"{reader.data.n_context}, {LOOP_EPOCHS} epoch; retriever bert-base widths (hidden "
            f"{bert.hidden_size}, {bert.num_attention_heads} heads) cut to "
            f"{bert.num_hidden_layers} layers (of 12), B={retriever.per_device_batch_size}, "
            f"{LOOP_EPOCHS} epoch; data cut to {LOOP_TRAIN} + {LOOP_EVAL} questions (of OK-VQA's "
            f"9,009 + 5,046) and {LOOP_TRIPLES} triples (of {LAKO_FACTS})")

        reset_counts()
        t0 = time.perf_counter()
        out = cli(["full-loop", "--workdir", str(tmp / "loop"),
                   "--reader-config", str(tmp / "reader_cfg.json"),
                   "--retriever-config", str(tmp / "retriever_cfg.json"),
                   "--t5-config", str(tmp / "t5_cfg.json"), "--train-data",
                   str(tmp / "train.json"), "--eval-data", str(tmp / "eval.json"),
                   "--corpus", str(tmp / "corpus.json"), "--tokenizer", str(tmp / "tok.json"),
                   "--bert-tokenizer", str(tmp / "btok.json"), "--iterations", "2",
                   "--fact-ablation", *device])
        loop_s = time.perf_counter() - t0
        launches = read_counts()
        history = out["history"]
        steps = [json.loads((Path(h["diagnostics"]["reader_ckpt"]).parent / "last" /
                             "meta.json").read_text())["step"] for h in history]
        eval_batches = sum(
            -(-n // reader.eval_batch_size)
            for n in (LOOP_EVAL,) * LOOP_EPOCHS + (LOOP_TRAIN, LOOP_EVAL, LOOP_EVAL)) * len(history)
        expected = {n: c * t5.num_layers * sum(steps)
                    for n, c in STEP_LAUNCHES["streamed"].items()}
        expected["streamed_attention"] += t5.num_layers * eval_batches
        log(f"  full-loop: 2 iterations in {loop_s:.1f} s; reader steps {steps}; history "
            + json.dumps([{k: v for k, v in h.items() if k != "diagnostics"} for h in history]))
        log(f"  diagnostics: {json.dumps([h['diagnostics'] for h in history])}")
        check_counts("full-loop (the training steps' STEP_LAUNCHES, and K1 in each evaluation "
                     f"batch: {eval_batches})", launches, expected)
        hashes = [h["diagnostics"]["reader_ckpt_sha256"] for h in history]
        if (out["iterations"] != 2 or [h["iteration"] for h in history] != ["v1", "v2"]
                or any(sorted(h) != HISTORY_KEYS_LOOP for h in history)
                or [sorted(h["diagnostics"]) for h in history] != [DIAGNOSTIC_KEYS[1],
                                                                    DIAGNOSTIC_KEYS[2]]
                or any(sorted(h["eval"]) != RESULT_KEYS for h in history)
                or any(not h["hit_at_k_include"] for h in history)
                or not all(isinstance(x, str) and len(x) == 16 for x in hashes)
                or hashes[0] == hashes[1]
                or json.loads((tmp / "loop" / "full_loop_history.json").read_text()) != history):
            raise AssertionError("full-loop: the history is not the JAX loop's, or the two "
                                 "iterations' readers hash equal")

        # serve the last iteration's reader, retriever, index and corpus
        loop = tmp / "loop"
        retriever_ckpt = loop / "retriever_v2" / "checkpoint"
        retriever_ckpt = retriever_ckpt / ("best_dev" if (retriever_ckpt / "best_dev").exists()
                                           else "last")
        request = {"question": "what sound does the owl make?",
                   "caption": "an owl in a tall tree near the barn."}
        answer, started, post_s = serve_and_post(
            ["serve", "--config", str(tmp / "reader_cfg.json"), "--t5-config",
             str(tmp / "t5_cfg.json"), "--model-path", history[1]["diagnostics"]["reader_ckpt"],
             "--tokenizer", str(tmp / "tok.json"), "--retriever-config",
             str(tmp / "retriever_cfg.json"), "--retriever-path", str(retriever_ckpt),
             "--bert-tokenizer", str(tmp / "btok.json"), "--index",
             str(loop / "fact_index_v2"), "--corpus", str(tmp / "corpus.json"), *device],
            Path(__file__).resolve().parent, tmp / "serve.log", request)
        ids = {r["id"] for r in corpus}
        log(f"  serve (a subprocess) on reader_v2, retriever_v2, fact_index_v2: up in "
            f"{started:.1f} s, one POST in {post_s * 1e3:.1f} ms: {json.dumps(answer)[:400]}")
        if not (isinstance(answer, list) and len(answer) == 1
                and isinstance(answer[0].get("answer"), str)
                and len(answer[0]["facts"]) == reader.data.n_context
                and all(f["id"] in ids and f["sentence"] == corpus[f["id"]]["sentence"]
                        for f in answer[0]["facts"])):
            raise AssertionError(f"serve: bad answer {answer!r}")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"LaKo loop phase: {time.perf_counter() - t_phase:.1f} s wall; {power_line()}")
    return {"streamed": launches}


# warm start from an HF checkpoint: t5-large in HF's layout, Adafactor, the host engines
HF_VOCAB = 32_128                            # t5-large's vocabulary
HF_STEPS = 4                                 # fine-tuning steps (8 examples each)
HF_LOSS_RTOL = 1e-5                          # the CLI's first loss against the in-process one
HOST_QUERIES, HOST_K = 64, 500               # the JAX docstring's host-index batch
OBJ36_IMAGES, OBJ36_BOXES, OBJ36_DIM = 256, 36, 2048
PACKAGES = ("tokenizers", "safetensors")


def package_line(name: str) -> str:
    """Whether ``name`` is importable here and its version, without
    importing it (the port reads safetensors files without the package)."""
    import importlib.metadata

    if importlib.util.find_spec(name) is None:
        return f"{name}: not installed"
    try:
        return f"{name} {importlib.metadata.version(name)}: importable"
    except importlib.metadata.PackageNotFoundError:
        return f"{name}: importable, no version metadata"


def hf_t5_names(cfg):
    """(this package's FiDT5 name, HF T5ForConditionalGeneration's name) for
    every tensor save_pretrained writes for a tied relu T5: the script's own
    table, written from HF's module layout."""
    pairs = [("t5.shared.weight", "shared.weight")]
    for stack, n, sub in (("encoder", cfg.num_layers, (("ln_attn", "self_attn", "SelfAttention"),
                                                       ("ln_mlp", "mlp", "DenseReluDense"))),
                          ("decoder", cfg.num_decoder_layers,
                           (("ln_self", "self_attn", "SelfAttention"),
                            ("ln_cross", "cross_attn", "EncDecAttention"),
                            ("ln_mlp", "mlp", "DenseReluDense")))):
        pairs.append((f"t5.{stack}.relpos.rel_embedding.weight",
                      f"{stack}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"))
        for i in range(n):
            for j, (ln, ours, theirs) in enumerate(sub):
                hf = f"{stack}.block.{i}.layer.{j}"
                pairs.append((f"t5.{stack}.block_{i}.{ln}.weight", f"{hf}.layer_norm.weight"))
                for w in (("wi", "wo") if theirs == "DenseReluDense" else "qkvo"):
                    pairs.append((f"t5.{stack}.block_{i}.{ours}.{w}.weight",
                                  f"{hf}.{theirs}.{w}.weight"))
        pairs.append((f"t5.{stack}.final_ln.weight", f"{stack}.final_layer_norm.weight"))
    return pairs


def write_hf_t5(path: Path, cfg, state) -> int:
    """An HF save_pretrained directory: config.json with t5-large's HF keys
    and one float32 model.safetensors (8-byte header length, JSON header,
    the raw tensors in header order). Returns the file's bytes."""
    path.mkdir()
    (path / "config.json").write_text(json.dumps({
        "architectures": ["T5ForConditionalGeneration"], "model_type": "t5",
        "d_model": cfg.d_model, "d_kv": cfg.d_kv, "d_ff": cfg.d_ff,
        "num_layers": cfg.num_layers, "num_decoder_layers": cfg.num_decoder_layers,
        "num_heads": cfg.num_heads, "vocab_size": cfg.vocab_size,
        "relative_attention_num_buckets": cfg.relative_attention_num_buckets,
        "relative_attention_max_distance": cfg.relative_attention_max_distance,
        "dropout_rate": cfg.dropout_rate, "layer_norm_epsilon": cfg.layer_norm_epsilon,
        "feed_forward_proj": "relu", "initializer_factor": 1.0, "is_encoder_decoder": True,
        "pad_token_id": 0, "eos_token_id": 1, "decoder_start_token_id": 0,
        "n_positions": 512, "tie_word_embeddings": True, "torch_dtype": "float32"}, indent=2))
    header, offset, tensors = {"__metadata__": {"format": "pt"}}, 0, []
    for ours, theirs in hf_t5_names(cfg):
        t = state[ours].detach().to("cpu", torch.float32).contiguous()
        header[theirs] = {"dtype": "F32", "shape": list(t.shape),
                          "data_offsets": [offset, offset + t.numel() * 4]}
        offset += t.numel() * 4
        tensors.append(t)
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path / "model.safetensors", "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw)
        for t in tensors:
            f.write(memoryview(t.numpy()).cast("B"))
    return 8 + len(raw) + offset


def write_unigram_layout(path: Path, texts) -> None:
    """A tokenizer.json in HFTokenizer.train_unigram's layout, for a machine
    without ``tokenizers``: the special pieces, ``▁``, each word with and
    without ``▁`` and each character, scored by their counts."""
    from collections import Counter

    counts = Counter()
    for text in texts:
        for word in text.split():
            counts["▁" + word] += 1
            counts[word] += 1
            counts.update(word)
    total = sum(counts.values())
    vocab = [["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0], ["▁", -2.0]]
    vocab += [[p, math.log(c / total)] for p, c in counts.most_common() if p != "▁"]
    metaspace = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                 "split": True}
    path.write_text(json.dumps({
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": c, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for i, c in enumerate(("<pad>", "</s>", "<unk>"))],
        "normalizer": None, "pre_tokenizer": metaspace, "post_processor": None,
        "decoder": metaspace,
        "model": {"type": "Unigram", "unk_id": 2, "vocab": vocab, "byte_fallback": False}}))


def cli_raises(argv, exc, match: str) -> str:
    """``cli(argv)`` must raise ``exc`` whose message holds ``match``."""
    from lako_tpu_torch.pipeline.cli import main as cli_main

    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli_main(argv)
    except exc as e:
        if match not in str(e):
            raise AssertionError(f"{argv[0]} raised without naming {match}: {e}") from None
        return str(e)
    finally:
        for handler in logging.getLogger("lako_tpu_torch").handlers:
            handler.setStream(sys.stdout)
    raise AssertionError(f"{argv[0]} did not raise {exc.__name__}")


def hf_train_rate(dev, t5, state_dict, batch, optim_name):
    """(examples/s, peak device GB, optimizer-state GB) of the warm-started
    train step (bf16 compute, f32 masters, remat; host clock around
    TIMED_STEPS synchronized steps after the first)."""
    from lako_tpu_torch.core.checkpoint import flatten_tree
    from lako_tpu_torch.core.config import OptimConfig
    from lako_tpu_torch.models.t5 import init_fid_t5
    from lako_tpu_torch.train.optim import make_optimizer
    from lako_tpu_torch.train.reader import make_reader_train_step, model_params
    from lako_tpu_torch.train.state import TrainState

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = init_fid_t5(t5, torch.Generator(device=dev).manual_seed(SEED), torch.bfloat16,
                        use_remat=True)
    model.load_state_dict(state_dict)
    model.to(torch.float32)
    tx = make_optimizer(OptimConfig(optim=optim_name, lr=1e-3, warmup_steps=0,
                                    total_steps=100))
    state = TrainState.create(model_params(model), tx)
    opt_gb = sum(v.numel() * v.element_size() for v in flatten_tree(state.opt_state).values()
                 if isinstance(v, torch.Tensor)) / 1e9
    step = make_reader_train_step(model)
    state, loss = step(state, *batch, SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        state, loss = step(state, *batch, SEED)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not math.isfinite(float(loss)):
        raise AssertionError(f"non-finite loss in the timed {optim_name} steps")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    del model, state, step
    return len(batch[0]) * TIMED_STEPS / seconds, peak, opt_gb


def check_host_indexes(dev):
    """NativeIndex and HostIndex at LaKo's scale against the exact DenseIndex
    on the card; host ms per HOST_QUERIES-query batch of each."""
    from lako_tpu_torch.retrieval.index import DenseIndex
    from lako_tpu_torch.retrieval.native import HostIndex, NativeIndex

    rng = np.random.default_rng(SEED + 7)
    emb = rng.standard_normal((LAKO_FACTS, LAKO_DIM), dtype=np.float32)
    queries = rng.standard_normal((HOST_QUERIES, LAKO_DIM), dtype=np.float32)
    want_ids, want_s = DenseIndex(emb, device=dev).search(queries, HOST_K)
    tol = 1e-5 * np.abs(want_s).max(axis=1)
    times = {}
    for name, index in (("NativeIndex", NativeIndex(emb)), ("HostIndex", HostIndex(emb))):
        index.search(queries[:4], HOST_K)                        # warm-up
        runs = []
        for _ in range(2):
            t0 = time.perf_counter()
            ids, scores = index.search(queries, HOST_K)
            runs.append(time.perf_counter() - t0)
        swapped = near_tie_check(name, ids, scores, want_ids, want_s, tol)
        times[name] = runs
        log(f"  {name}: {LAKO_FACTS:,} x {LAKO_DIM}, {HOST_QUERIES} queries, k={HOST_K}: "
            f"{', '.join(f'{s * 1e3:.1f}' for s in runs)} ms a batch (host clock); against "
            f"the exact DenseIndex on the card: scores within 1e-5 of each row's largest, "
            f"{swapped} of {ids.size} ranks swapped within it")
    ratio = min(times["NativeIndex"]) / min(times["HostIndex"])
    log(f"  HostIndex is {ratio:.2f}x as fast as NativeIndex for this batch on {os.cpu_count()} "
        f"host cores (the JAX docstring, lako_tpu/retrieval/native.py:7-11, claims ~15x)")


def check_obj36(tmp: Path):
    """A seeded obj36 TSV of OBJ36_IMAGES images decoded by the C++ and the
    Python loader: equal arrays; rows/s of each."""
    import base64

    from lako_tpu_torch.data.vision import load_obj_tsv

    rng = np.random.default_rng(SEED + 8)

    def b64(a):
        return base64.b64encode(a.tobytes()).decode()

    n = OBJ36_BOXES
    with open(tmp / "obj36.tsv", "w") as f:
        for i in range(OBJ36_IMAGES):
            f.write("\t".join([
                f"img_{i}", "480", "640", b64(rng.integers(0, 1600, n).astype(np.int64)),
                b64(rng.random(n, dtype=np.float32)),
                b64(rng.integers(0, 400, n).astype(np.int64)),
                b64(rng.random(n, dtype=np.float32)), str(n),
                b64(rng.uniform(0, 400, (n, 4)).astype(np.float32)),
                b64(rng.standard_normal((n, OBJ36_DIM), dtype=np.float32))]) + "\n")
    seconds, rows = {}, {}
    for backend in ("native", "python"):
        t0 = time.perf_counter()
        rows[backend] = load_obj_tsv(str(tmp / "obj36.tsv"), backend=backend)
        seconds[backend] = time.perf_counter() - t0
    if not len(rows["native"]) == len(rows["python"]) == OBJ36_IMAGES:
        raise AssertionError("obj36: row counts differ")
    for a, b in zip(rows["native"], rows["python"]):
        if sorted(a) != sorted(b) or any(
                not np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray) else a[k] != b[k]
                for k in a):
            raise AssertionError(f"obj36: the C++ and Python loaders differ at {a['img_id']}")
    size = (tmp / "obj36.tsv").stat().st_size / 1e6
    log(f"  obj36: {OBJ36_IMAGES} images x {n} boxes x {OBJ36_DIM} features ({size:.1f} MB "
        f"TSV), every array equal; C++ {OBJ36_IMAGES / seconds['native']:.1f} rows/s, Python "
        f"{OBJ36_IMAGES / seconds['python']:.1f} rows/s (host clock)")


def run_hf_warm_start(dev):
    """Fine-tuning the FiD reader from an HF save_pretrained directory, in a
    temporary directory: t5-large at full width and depth written in HF's
    layout (config.json, one f32 model.safetensors) from init_fid_t5 and
    read back by load_hf_t5 onto the card, bitwise; a unigram tokenizer.json
    (build-tokenizer --kind unigram, or the trainer's layout written here
    without ``tokenizers``), its ids by load_tokenizer, the plain reader and
    ``tokenizers``; train-reader --model-path <dir> with Adafactor on the
    streamed route (K1, K2a/b/c counted), its first loss against the same
    weights' in-process loss, then eval-reader --model-path <dir>;
    examples/s and peak memory of Adafactor beside AdamW; NativeIndex and
    HostIndex at LaKo's scale against the exact DenseIndex; the obj36
    loaders. Returns the launches of train-reader."""
    from lako_tpu_torch.core.config import OptimConfig, ReaderTrainConfig, t5_config_for_size
    from lako_tpu_torch.models.hf_io import load_hf_t5
    from lako_tpu_torch.models.t5 import init_fid_t5
    from lako_tpu_torch.models.t5.layers import set_dropout_key
    from lako_tpu_torch.text.tokenizer import HFTokenizer, _tokenizers, load_tokenizer
    from lako_tpu_torch.text.tokenizer_json import PlainTokenizer
    from lako_tpu_torch.train import reader as reader_mod

    t_phase = time.perf_counter()
    log("HF warm start: " + "; ".join(package_line(p) for p in PACKAGES))
    device = [] if dev.type == "cuda" else ["--device", str(dev)]
    # t5-large as HF configures it, but dropout 0: the encoder then takes the kernels
    arch = t5_config_for_size("large", vocab_size=HF_VOCAB, dropout_rate=0.0)
    route = arch.replace(use_flash_attention=True, flash_min_length=128)
    _, train, evals = train_fixture()
    train = train[:8 * HF_STEPS]
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        written = init_fid_t5(arch, torch.Generator(device=dev).manual_seed(SEED)).state_dict()
        t0 = time.perf_counter()
        n_bytes = write_hf_t5(tmp / "hf", arch, written)
        write_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cfg, loaded = load_hf_t5(str(tmp / "hf"), device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        bad = [k for k, v in written.items() if not torch.equal(loaded[k], v)]
        if sorted(loaded) != sorted(written) or bad or cfg != arch:
            raise AssertionError(f"load_hf_t5: {len(bad)} tensors differ from those written "
                                 f"(e.g. {bad[:3]}), or the config {cfg} is not {arch}")
        log(f"  t5-large ({arch.num_layers}+{arch.num_decoder_layers} layers, d_model "
            f"{arch.d_model}, d_ff {arch.d_ff}, {arch.num_heads} heads, vocab {arch.vocab_size}, "
            f"relu, tied) as an HF directory: {n_bytes / 1e9:.3f} GB model.safetensors written "
            f"in {write_s:.1f} s; load_hf_t5 onto the card {load_s:.2f} s "
            f"({n_bytes / 1e9 / load_s:.2f} GB/s, the file just written, so in the page cache); "
            f"{len(written)} tensors bitwise, the config field by field")
        del loaded

        for name, data in (("train", train), ("eval", evals)):
            (tmp / f"{name}.json").write_text(json.dumps(data))
        texts = [t for ex in train + evals
                 for t in [ex["question"], ex["caption"], *(f["sentence"] for f in ex["fact"])]]
        texts += ["Héllo wörld, café naïve", "东京 is big", "the cat's meow?!"]
        if _tokenizers() is not None:
            tok_out = cli(["build-tokenizer", "--from-json", str(tmp / "train.json"),
                           str(tmp / "eval.json"), "--kind", "unigram", "--vocab-size", "400",
                           "--out", str(tmp / "tok.json")])
            how = f"build-tokenizer --kind unigram ({tok_out['vocab_size']} pieces)"
        else:
            write_unigram_layout(tmp / "tok.json", texts)
            cli_raises(["build-tokenizer", "--from-json", str(tmp / "train.json"), "--kind",
                        "unigram", "--out", str(tmp / "never.json")], ImportError, "`tokenizers`")
            how = "in train_unigram's layout, written here (build-tokenizer raised naming " \
                  "`tokenizers`)"
        hf_tok = load_tokenizer(str(tmp / "tok.json"))
        readers = {"plain": HFTokenizer(PlainTokenizer.from_file(str(tmp / "tok.json")))}
        if _tokenizers() is not None:
            readers["tokenizers"] = HFTokenizer(
                _tokenizers().Tokenizer.from_file(str(tmp / "tok.json")))
        for name, other in readers.items():
            if any(other.encode(t) != hf_tok.encode(t) for t in texts):
                raise AssertionError(f"tokenizer ids: load_tokenizer ({hf_tok.reader}) and "
                                     f"the {name} reader differ")
        log(f"  tokenizer.json {how}; load_tokenizer took {hf_tok.reader}; ids on "
            f"{len(texts)} texts equal to {' and '.join(readers)}")

        reader = ReaderTrainConfig(
            model_size="large", per_device_batch_size=8, eval_batch_size=8, epochs=1,
            early_stop=1, eval_max_length=20, use_remat=True, dtype="bfloat16",
            param_dtype="float32", seed=SEED, checkpoint_dir=str(tmp / "ckpt"), name="hf",
            optim=OptimConfig(optim="adafactor", lr=1e-3))
        (tmp / "reader.json").write_text(json.dumps(dataclasses.asdict(reader)))
        (tmp / "route.json").write_text(json.dumps(dataclasses.asdict(route)))
        common = ["--config", str(tmp / "reader.json"), "--t5-config", str(tmp / "route.json"),
                  "--tokenizer", str(tmp / "tok.json"), "--model-path", str(tmp / "hf"), *device]
        first = []
        make_step = reader_mod.make_reader_train_step

        def recording(model, backend="flax"):
            step = make_step(model, backend)

            def run(state, ids, mask, labels, seed):
                state, loss = step(state, ids, mask, labels, seed)
                if not first:
                    first.append((ids.clone(), mask.clone(), labels.clone(), float(loss)))
                return state, loss

            return run

        reader_mod.make_reader_train_step = recording
        reset_counts()
        try:
            t0 = time.perf_counter()
            out = cli(["train-reader", *common, "--train-data", str(tmp / "train.json"),
                       "--eval-data", str(tmp / "eval.json")])
            train_s = time.perf_counter() - t0
        finally:
            reader_mod.make_reader_train_step = make_step
        launches = read_counts()
        eval_batches = -(-len(evals) // reader.eval_batch_size)
        expected = {n: c * arch.num_layers * out["steps"]
                    for n, c in STEP_LAUNCHES["streamed"].items()}
        expected["streamed_attention"] += arch.num_layers * eval_batches
        log(f"  train-reader --model-path <HF dir>, Adafactor lr {reader.optim.lr}, streamed "
            f"kernels, B=8, N={reader.data.n_passages}, L={reader.data.text_maxlength}, bf16, "
            f"f32 masters, remat: {out['steps']} steps and 1 evaluation in {train_s:.1f} s "
            f"(its checkpoint saves included); history {json.dumps(out['history'])}")
        check_counts("train-reader from the HF directory (STEP_LAUNCHES x steps, K1 in the "
                     f"evaluation's {eval_batches} batch)", launches, expected)
        if out["steps"] != HF_STEPS or not all(math.isfinite(h["loss"]) for h in out["history"]):
            raise AssertionError(f"train-reader: {out}")

        ids, mask, labels, cli_loss = first[0]
        model = init_fid_t5(route, torch.Generator(device=dev).manual_seed(SEED),
                            torch.bfloat16, use_remat=True)
        model.load_state_dict(load_hf_t5(str(tmp / "hf"), device=dev)[1])
        model.to(torch.float32).train()
        set_dropout_key(model, SEED, 0)
        own = float(model(ids, mask, labels)[0].detach())   # with grad, as a train step
        del model
        err = abs(cli_loss - own) / abs(own)
        log(f"  the first step's loss {cli_loss:.7f}; the same weights and batch in this "
            f"process {own:.7f} (rel err {err:.2e}, bound {HF_LOSS_RTOL:g})")
        if not err <= HF_LOSS_RTOL:
            raise AssertionError("the warm-started loss is not the HF weights' loss")

        reset_counts()
        t0 = time.perf_counter()
        ev = cli(["eval-reader", *common, "--eval-data", str(tmp / "eval.json")])
        eval_s = time.perf_counter() - t0
        check_counts("eval-reader from the HF directory", read_counts(),
                     {"streamed_attention": arch.num_layers * eval_batches})
        if ev["total"] != len(evals) or not 0.0 <= ev["em"] <= 1.0:
            raise AssertionError(f"eval-reader: {ev}")
        log(f"  eval-reader --model-path <HF dir>: {json.dumps(ev)} in {eval_s:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()

        batch = (ids, mask, labels)
        runs = [(name, hf_train_rate(dev, route, written, batch, name))
                for name in ("adafactor", "adamw", "adamw", "adafactor")]
        log(f"  warm-started train step (streamed kernels, bf16 compute, f32 masters, remat, "
            f"B=8; {TIMED_STEPS} steps after the first): "
            + "; ".join(f"{name} {rate:.2f} ex/s, peak {peak:.2f} GB, optimizer state "
                        f"{opt:.4f} GB" for name, (rate, peak, opt) in runs))
        del written, batch, ids, mask, labels
        gc.collect()
        torch.cuda.empty_cache()
        check_host_indexes(dev)
        check_obj36(tmp)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"HF warm-start phase: {time.perf_counter() - t_phase:.1f} s wall; {power_line()}")
    return {"streamed": launches}



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

    t_script = time.perf_counter()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = power_line()
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
    t0 = time.perf_counter()
    _build.load_host_library()                   # g++; a failed build fails the run
    log(f"host build: {_build.host_library_path().name} (csrc/host/*.cpp, g++ "
        f"{' '.join(_build.HOST_CXXFLAGS)}) in {time.perf_counter() - t0:.1f} s")
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
    runs["retriever"] = run_retriever_pipeline(dev)  # no kernel: the counts stay 0
    gc.collect()
    torch.cuda.empty_cache()
    runs["served_retrieval"] = run_served_retrieval(dev)  # K4 and K3, facts retrieved
    gc.collect()
    torch.cuda.empty_cache()
    runs["loop"] = run_lako_loop(dev)            # K1 + K2a/K2b/K2c through full-loop
    gc.collect()
    torch.cuda.empty_cache()
    runs["hf"] = run_hf_warm_start(dev)          # K1 + K2a/K2b/K2c from an HF directory
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
    log(f"the whole script: {time.perf_counter() - t_script:.1f} s wall")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
