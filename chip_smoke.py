#!/usr/bin/env python3
"""Smoke test of the PyTorch port (lako_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit, torch's device name).
2. Builds the CUDA kernels from ``lako_tpu_torch/csrc`` with nvcc.
3. Checks each kernel against its plain PyTorch version on the card, at the
   serving path's shapes and in its working types, and times both with CUDA
   graphs of back-to-back calls (device time per call, warm L2).
4. Serves 20 requests through ``LakoService`` at the full width of t5-large
   (random weights from a seeded generator, bf16, int8 cross K/V, the encoder
   through the streamed kernel and decode cross-attention through the int8
   kernel), one more over HTTP, and checks that each kernel was launched the
   expected number of times. It then answers the same requests without the
   kernels and checks that the greedy tokens and the encoder states agree.
5. Prints the kernel summary as one JSON line, the nvidia-smi line again,
   and last ``{"ok": true, "device": {...}}``.

Any failure raises, so the exit code is not 0. Without a CUDA device it exits
with code 2 before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

SEED = 0
K1_TOL = dict(bf16=(6e-2, 5e-3), f32=(2e-4, 1e-5))   # (max abs, mean abs)
K3_TOL = 1e-5                                        # max abs and rel, f32 out
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


def check_streamed(dev):
    from lako_tpu_torch.ops import flash_streamed as k1

    log("K1 streamed_attention (csrc/flash_streamed_fwd.cu) vs plain:")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def inputs(B, H, L, Lk, D, dtype, masked_rows=0):
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

    results = {}
    cases = [("(16,16,130,64) bf16, 4 fully masked rows", (16, 16, 130, 130, 64), torch.bfloat16, 4),
             ("(16,16,130,64) f32, 4 fully masked rows", (16, 16, 130, 130, 64), torch.float32, 4),
             ("(3,2,300,64) Lk=330 bf16", (3, 2, 300, 330, 64), torch.bfloat16, 1),
             ("(2,4,130,128) bf16", (2, 4, 130, 130, 128), torch.bfloat16, 1)]
    for label, shape, dtype, masked in cases:
        args = inputs(*shape, dtype, masked)
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

    kernels = [check_streamed(dev), check_decode_cross(dev)]
    launches = run_slice(dev)
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
