#!/usr/bin/env python3
"""Smoke test of the PyTorch port (lako_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit, torch's device name).
2. Builds the CUDA kernels from ``lako_tpu_torch/csrc`` with nvcc.
3. Checks each kernel against its plain PyTorch version on the card, at the
   serving path's shapes and in its working types, and times both with CUDA
   graphs of back-to-back calls (device time per call, warm L2).
   The backward kernels (K2a/K2b/K2c) are checked directly and through the
   autograd Function, with fully masked rows, and timed against the plain
   autograd backward.
4. Serving path: 20 requests through ``LakoService`` at the full width of
   t5-large (random weights from a seeded generator, bf16, int8 cross K/V,
   the encoder through the streamed kernel and decode cross-attention through
   the int8 kernel), one more over HTTP; checks that each kernel was launched
   the expected number of times, then answers the same requests without the
   kernels and checks that the greedy tokens and the encoder states agree.
5. Training path, at t5-large width (B=8, N=2, L=130, remat, AdamW):
   a. one train step's loss and gradients with the streamed kernels against
      the same step without them, in float32 and in bfloat16 (bf16 gradients
      held to the float32 ones, no further than the plain bf16 run);
   b. ``train_reader`` for 2 epochs on a synthetic fixture with an eval at
      the end of each: the loss falls, EM is in [0, 1], the history has the
      JAX package's keys, and K1/K2a/K2b/K2c ran 48/24/24/24 times a step;
   c. train-step examples/s with the kernels and without (host clock,
      synchronized, first step excluded).
6. Prints the kernel summary as one JSON line, the nvidia-smi line again,
   and last ``{"ok": true, "device": {...}}``.

Any failure raises, so the exit code is not 0. Without a CUDA device it exits
with code 2 before printing any result.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

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
ANIMALS = ["cat", "dog", "cow", "duck", "frog", "bee", "owl", "wolf", "horse", "goat"]
SOUNDS = ["meow", "woof", "moo", "quack", "croak", "buzz", "hoot", "howl", "neigh", "bleat"]


def log(*args) -> None:
    print(*args, flush=True)


def device_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time per call: ``calls`` back-to-back calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events."""
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
    plain = device_ms(lambda: k1.streamed_attention_reference(*args))
    kern = device_ms(lambda: k1.streamed_attention(*args))
    plain = (plain + device_ms(lambda: k1.streamed_attention_reference(*args))) / 2
    log(f"  time at {label}: kernel {kern:.4f} ms, plain {plain:.4f} ms "
        f"(device time per call, CUDA graph of 20 calls)")
    return {"name": "streamed_attention", "route": "cuda",
            "source": "lako_tpu_torch/csrc/flash_streamed_fwd.cu",
            "replaces": "lako_tpu/ops/flash_streamed.py:173",
            "max_abs_err": max_err, "ms": kern, "plain_ms": plain}


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

    def k2_all():
        for fn in kernels.values():
            fn(*args)

    def plain_fwd():
        return k1.streamed_attention_reference(*leaves, mask)

    def plain_fwd_bwd():
        torch.autograd.grad(plain_fwd(), leaves, dout)

    def kernel_fwd_bwd():
        torch.autograd.grad(k1.streamed_attention(*leaves, mask), leaves, dout)

    fwd = device_ms(plain_fwd)
    both = device_ms(plain_fwd_bwd)
    k2 = device_ms(k2_all)
    k_both = device_ms(kernel_fwd_bwd)
    log(f"  K2a+K2b+K2c {k2:.4f} ms vs the plain autograd backward {both - fwd:.4f} ms "
        f"(plain forward+backward {both:.4f} ms less its forward {fwd:.4f} ms); forward+"
        f"backward through the Function (K1 with statistics + K2) {k_both:.4f} ms")
    entries = []
    for name, idx, replaces in (("dkdv", (1, 2), ":289"), ("dq", (0,), ":319"),
                                ("drel", (3,), ":344")):
        entries.append({"name": f"streamed_attention_bwd_{name}", "route": "cuda",
                        "source": "lako_tpu_torch/csrc/flash_streamed_bwd.cu",
                        "replaces": f"lako_tpu/ops/flash_streamed.py{replaces}",
                        "max_abs_err": max(errs[i] for i in idx),
                        "ms": times[name][0], "plain_ms": times[name][1]})
    return entries


def check_decode_cross(dev):
    from lako_tpu_torch.models.t5.engine import _quantize_kv
    from lako_tpu_torch.ops import decode_cross_attn as k3

    log("K3 fused_decode_cross_attention (csrc/decode_cross_attn.cu) vs plain:")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    timed = {}
    for B in (8, 128):
        h, d, K = 16, 64, 260
        q = torch.randn(B, h, d, generator=gen, device=dev).to(torch.bfloat16)
        ck = _quantize_kv(torch.randn(B, h, d, K, generator=gen, device=dev))
        cv = _quantize_kv(torch.randn(B, h, d, K, generator=gen, device=dev))
        mask = torch.rand(B, K, generator=gen, device=dev) < 0.7
        mask[:, 0] = True
        bias = torch.where(mask, 0.0, -1e9)[:, None, :].float().contiguous()
        args = (q, ck.values, ck.scale, cv.values, cv.scale, bias)
        out = k3.fused_decode_cross_attention(*args)
        ref = k3.reference(*args)
        torch.cuda.synchronize()
        label = f"({B},16,64,260) q bf16, int8 K/V"
        err = compare(label, out, ref, K3_TOL)
        torch.testing.assert_close(out, ref, rtol=K3_TOL, atol=K3_TOL)
        plain = device_ms(lambda: k3.reference(*args))
        kern = device_ms(lambda: k3.fused_decode_cross_attention(*args))
        plain = (plain + device_ms(lambda: k3.reference(*args))) / 2
        log(f"  time at {label}: kernel {kern:.4f} ms, plain {plain:.4f} ms "
            f"(device time per call, CUDA graph of 20 calls)")
        timed[B] = (err, kern, plain)
    err, kern, plain = timed[8]
    return {"name": "fused_decode_cross_attention", "route": "cuda",
            "source": "lako_tpu_torch/csrc/decode_cross_attn.cu",
            "replaces": "lako_tpu/ops/decode_cross_attn.py:82",
            "max_abs_err": err, "ms": kern, "plain_ms": plain}


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


def run_slice(dev):
    from lako_tpu_torch.core.config import ReaderDataConfig, t5_config_for_size
    from lako_tpu_torch.data import ReaderCollator, ReaderDataset
    from lako_tpu_torch.models.t5 import init_fid_t5
    from lako_tpu_torch.ops.decode_cross_attn import fused_decode_cross_attention
    from lako_tpu_torch.ops.flash_streamed import streamed_attention
    from lako_tpu_torch.serve import LakoService, ServiceConfig, make_http_server
    from lako_tpu_torch.text.tokenizer import WordVocabTokenizer

    t5 = t5_config_for_size("large", vocab_size=32128, dropout_rate=0.0,
                            use_flash_attention=True, flash_min_length=128)
    cfg = ServiceConfig(batch_size=8, max_length=50, n_context=10,
                        data=ReaderDataConfig(), decode_backend="engine",
                        decode_kv_dtype="int8", decode_fused_cross=True)
    log(f"slice: t5-large ({t5.num_layers}+{t5.num_decoder_layers} layers, d_model "
        f"{t5.d_model}, {t5.num_heads} heads, d_kv {t5.d_kv}), bf16, B={cfg.batch_size}, "
        f"N={cfg.data.n_passages}, L={cfg.data.text_maxlength}, max_length={cfg.max_length}")
    t0 = time.perf_counter()
    model = init_fid_t5(t5, torch.Generator(device=dev).manual_seed(SEED))
    # At the init's unit std the random tied embedding keeps the decoder start
    # token dominant in the residual stream and every greedy token is pad;
    # scaled down, the tokens depend on the passages.
    with torch.no_grad():
        model.t5.shared.weight.mul_(EMBEDDING_SCALE)
    params = model.state_dict()
    requests = make_requests(20)
    corpus = [f"{r['question']} {r['caption']}" for r in requests] + [
        f["sentence"] for f in requests[0]["fact"]] + ["question: context: fact:"]
    tok = WordVocabTokenizer.build(corpus)
    service = LakoService(cfg, t5, params, tok, device=dev)
    log(f"  weights + service ready in {time.perf_counter() - t0:.1f} s")
    service.answer_batch(requests[:1])          # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()

    server = make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        streamed_attention.launches = 0
        fused_decode_cross_attention.launches = 0
        t0 = time.perf_counter()
        examples, tokens = service.generate_tokens(requests)
        seconds = time.perf_counter() - t0
        answers = tok.batch_decode(tokens)
        over_http = post(server.server_address[1], requests[7])
        launches = {"streamed_attention": streamed_attention.launches,
                    "fused_decode_cross_attention": fused_decode_cross_attention.launches}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    batches = 3 + 1                              # 8 + 8 + 4 requests, then 1 over HTTP
    steps = cfg.max_length - 1
    expected = {"streamed_attention": batches * t5.num_layers,
                "fused_decode_cross_attention": batches * t5.num_decoder_layers * steps}
    log(f"  20 requests in {seconds:.3f} s: {20 / seconds:.2f} answers/s "
        f"(host clock, 3 batches, bf16, one request per answer)")
    log(f"  launches in the served run: {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError("the serving path did not run each kernel as expected")
    if tokens.shape != (20, steps) or tokens.min() < 0 or tokens.max() >= t5.vocab_size:
        raise AssertionError(f"bad token array {tokens.shape} "
                             f"[{tokens.min()}, {tokens.max()}]")
    if not (isinstance(over_http, list) and len(over_http) == 1
            and isinstance(over_http[0].get("answer"), str)):
        raise AssertionError(f"bad HTTP response {over_http!r}")
    log(f"  HTTP answer equals answer_batch's: {over_http[0]['answer'] == answers[7]}")
    log(f"  first answers: {answers[:2]!r}")

    plain_t5 = t5.replace(use_flash_attention=False)
    plain_cfg = dataclasses.replace(cfg, decode_fused_cross=False)
    plain = LakoService(plain_cfg, plain_t5, params, tok, device=dev)
    before = dict(launches)
    _, plain_tokens = plain.generate_tokens(requests)
    if (streamed_attention.launches, fused_decode_cross_attention.launches) != \
            tuple(before.values()):
        raise AssertionError("the no-kernel configuration launched a kernel")
    agreement = float((tokens == plain_tokens).mean())
    log(f"  token agreement with the no-kernel configuration (same int8 K/V): "
        f"{agreement:.4f} (min {TOKEN_AGREEMENT_MIN}); the tokens hold "
        f"{len(np.unique(tokens))} distinct ids, "
        f"{float((tokens == t5.pad_token_id).mean()):.3f} of them pad")
    if agreement < TOKEN_AGREEMENT_MIN:
        raise AssertionError("kernel and no-kernel configurations disagree")

    # The encoder states, which the K1 kernel produces, compared directly.
    ds = ReaderDataset(examples, cfg.data)
    batch = ReaderCollator(cfg.data, tok)([ds[i] for i in range(cfg.batch_size)])
    ids = torch.from_numpy(batch.passage_ids).to(dev)
    pmask = torch.from_numpy(batch.passage_mask).to(dev)
    with torch.inference_mode():
        enc_kernel = service.model.encode_passages(ids, pmask)[0].float()
        enc_plain = plain.model.encode_passages(ids, pmask)[0].float()
    rel = float((enc_kernel - enc_plain).abs().mean() / enc_plain.abs().mean())
    log(f"  encoder states ({t5.num_layers} layers, bf16), kernel vs plain attention: mean abs "
        f"err / mean abs = {rel:.3e} (max {ENCODER_REL_ERR_MAX}), max abs err "
        f"{float((enc_kernel - enc_plain).abs().max()):.3e}")
    if not (rel <= ENCODER_REL_ERR_MAX and bool(torch.isfinite(enc_kernel).all())):
        raise AssertionError("encoder states through K1 disagree with plain attention")
    return launches


def train_counters():
    from lako_tpu_torch.ops import flash_streamed as k1

    return {"streamed_attention": k1.streamed_attention,
            "streamed_attention_bwd_dkdv": k1.streamed_attention_bwd_dkdv,
            "streamed_attention_bwd_dq": k1.streamed_attention_bwd_dq,
            "streamed_attention_bwd_drel": k1.streamed_attention_bwd_drel}


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


def train_t5(tok, flash: bool):
    from lako_tpu_torch.core.config import t5_config_for_size

    return t5_config_for_size("large", vocab_size=tok.vocab_size, dropout_rate=0.0,
                              use_flash_attention=flash, flash_min_length=128)


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


def check_train_step(dev, cfg, tok, batch):
    """One train step's loss and gradients, streamed kernels vs plain
    attention, from the same init and batch. float32: the two must agree
    within STEP_TOL. bfloat16: the loss within STEP_TOL; the gradients are
    held to the float32 plain gradients, and the kernel run may be no
    further from them than BF16_NOISE_RATIO times the plain bf16 run is
    (worst tensor and all tensors), since two bf16 runs that round in
    different places differ by bf16's own noise."""
    from lako_tpu_torch.models.t5 import init_fid_t5
    from lako_tpu_torch.models.t5.layers import set_dropout_key
    from lako_tpu_torch.train.reader import model_params

    counters = train_counters()
    layers = train_t5(tok, True).num_layers
    relpos = "t5/encoder/relpos/rel_embedding"
    reference = None   # the float32 plain gradients
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        results = {}
        for flash in (True, False):
            model = init_fid_t5(train_t5(tok, flash), torch.Generator(device=dev).manual_seed(SEED),
                                dtype, use_remat=True)
            params = model_params(model)
            model.train()
            set_dropout_key(model, SEED, 0)
            before = {n: c.launches for n, c in counters.items()}
            loss = model(*batch)[0]
            grads = torch.autograd.grad(loss, list(params.values()))
            torch.cuda.synchronize()
            launched = {n: c.launches - before[n] for n, c in counters.items()}
            want = ([2 * layers] + [layers] * 3) if flash else [0] * 4
            if list(launched.values()) != want:
                raise AssertionError(f"train step launches {launched}, expected {want}")
            results[flash] = (float(loss.detach()), dict(zip(params, grads)))
            del model, params, loss, grads
        (lk, gk), (lp, gp) = results[True], results[False]
        loss_err = abs(lk - lp) / abs(lp)
        rel, total = grad_errors(gk, gp)
        worst = max(rel, key=rel.get)
        loss_tol, grad_tol = STEP_TOL[dtype_name]
        log(f"  {dtype_name}: loss kernels {lk:.6f} vs plain {lp:.6f} (rel err {loss_err:.3e}, "
            f"bound {loss_tol:g}); gradients kernels vs plain: worst tensor {rel[worst]:.3e} at "
            f"{worst}, all tensors {total:.3e}, {relpos} {rel[relpos]:.3e} (|g| "
            f"{float(gp[relpos].norm()):.3e}); {len(rel)} tensors; launches K1 {2 * layers}, "
            f"K2a/K2b/K2c {layers} each, as expected")
        ok = loss_err <= loss_tol and math.isfinite(lk)
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
        del results, gk, gp
        gc.collect()
        torch.cuda.empty_cache()


def run_train_reader(dev, cfg, tok, train, evals):
    """train_reader at t5-large width through the kernels; returns its launches."""
    from lako_tpu_torch.train.reader import train_reader

    counters = train_counters()
    t5 = train_t5(tok, True)
    log(f"train_reader: t5-large ({t5.num_layers}+{t5.num_decoder_layers} layers, d_model "
        f"{t5.d_model}, {t5.num_heads} heads, vocab {t5.vocab_size}), dtype {cfg.dtype}, "
        f"param_dtype {cfg.param_dtype}, remat, AdamW lr {cfg.optim.lr} wd "
        f"{cfg.optim.weight_decay} clip {cfg.optim.clip}, B={cfg.per_device_batch_size}, "
        f"N={cfg.data.n_passages}, L={cfg.data.text_maxlength}, {len(train)} train / "
        f"{len(evals)} eval examples, {cfg.epochs} epochs")
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    result = train_reader(cfg, train, evals, tok, t5_config=t5, save_checkpoints=False,
                          device=dev)
    seconds = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    steps = result.final_step
    eval_batches = -(-len(evals) // cfg.eval_batch_size) * len(result.history)
    expected = {n: t5.num_layers * (2 * steps + eval_batches) if n == "streamed_attention"
                else t5.num_layers * steps for n in counters}
    log(f"  {steps} steps and {len(result.history)} evals in {seconds:.1f} s; history "
        f"{[{k: round(v, 4) for k, v in h.items()} for h in result.history]}")
    log(f"  launches {launches}, expected {expected} (per step: K1 {2 * t5.num_layers}, "
        f"K2a/K2b/K2c {t5.num_layers}; plus K1 {t5.num_layers} per eval batch)")
    losses = [h["loss"] for h in result.history]
    if launches != expected:
        raise AssertionError("the training path did not run each kernel as expected")
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


def train_examples_per_s(dev, cfg, tok, batch, flash: bool) -> float:
    """Examples/s of the train step (host clock around synchronized steps,
    the first step excluded)."""
    from lako_tpu_torch.models.t5 import init_fid_t5
    from lako_tpu_torch.train.optim import make_optimizer
    from lako_tpu_torch.train.reader import make_reader_train_step, model_params
    from lako_tpu_torch.train.state import TrainState

    model = init_fid_t5(train_t5(tok, flash), torch.Generator(device=dev).manual_seed(SEED),
                        torch.bfloat16, use_remat=True)
    tx = make_optimizer(cfg.optim.replace(warmup_steps=0, total_steps=100))
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
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return cfg.per_device_batch_size * TIMED_STEPS / seconds


def run_training(dev):
    from lako_tpu_torch.core.config import ReaderTrainConfig

    cfg = ReaderTrainConfig(model_size="large", per_device_batch_size=8, eval_batch_size=8,
                            epochs=TRAIN_EPOCHS, early_stop=TRAIN_EPOCHS, eval_max_length=20,
                            use_remat=True, dtype="bfloat16", param_dtype="float32", seed=SEED)
    tok, train, evals = train_fixture()
    batch = first_batch(cfg, tok, train, dev)
    log("one train step at t5-large width (B=8, N=2, L=130, remat), streamed kernels "
        "(flash_min_length=128) vs plain attention, same init and batch:")
    check_train_step(dev, cfg, tok, batch)
    launches = run_train_reader(dev, cfg, tok, train, evals)
    rates = [train_examples_per_s(dev, cfg, tok, batch, flash)
             for flash in (True, False, True, False)]
    log(f"  train step examples/s (bf16 compute, f32 masters, remat, B=8; host clock, "
        f"synchronized, {TIMED_STEPS} steps after the first): with kernels "
        f"{rates[0]:.2f}, {rates[2]:.2f}; without {rates[1]:.2f}, {rates[3]:.2f}")
    return launches


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

    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {_build.library_path().name} in {time.perf_counter() - t0:.1f} s")

    kernels = [check_streamed(dev), *check_streamed_bwd(dev), check_decode_cross(dev)]
    launches = run_slice(dev)                 # the serving path: K1 and K3
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(run_training(dev))        # the training path: K1 and K2a/K2b/K2c
    log(f"launches in the training path's train_reader run (K1 there, K3 in the serving "
        f"run): {launches}")
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
