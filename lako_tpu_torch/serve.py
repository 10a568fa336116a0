"""Serving: answer knowledge-based questions with the FiD reader.

Counterpart of lako_tpu/serve.py. ``LakoService.answer_batch`` collates the
requests into fixed ``(B, N, L)`` batches, encodes the passages and runs
greedy decode in the stacked-weight engine, under ``torch.inference_mode``.
A stdlib HTTP endpoint wraps it, optionally behind a micro-batcher.

Requests carry their own facts: retrieval is not ported yet, so
``retrieve_facts`` returns no facts, as the JAX service does without a
retriever. Not ported yet, and refused at construction: tensor-parallel
serving (``mesh_model > 1``), beam search (``num_beams > 1``) and
``engine_policy="auto"``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from lako_tpu_torch.core.config import ReaderDataConfig, T5Config
from lako_tpu_torch.core.device import resolve_device
from lako_tpu_torch.data import ReaderCollator, ReaderDataset
from lako_tpu_torch.models.t5.decode import make_best_generate_fn
from lako_tpu_torch.models.t5.model import FiDT5


@dataclass
class ServiceConfig:
    batch_size: int = 8
    max_length: int = 50
    n_context: int = 10
    data: ReaderDataConfig = field(default_factory=ReaderDataConfig)
    dtype: str = "bfloat16"
    num_beams: int = 1
    # token elimination: keep only this many encoder states for decode
    keep_tokens: Optional[int] = None
    decode_backend: str = "auto"     # "auto" | "engine" | "flax"
    decode_kv_dtype: str = "native"  # "native" | "int8"
    decode_weights_dtype: str = "native"
    decode_chunk_size: Optional[int] = None
    # the beam engine's self-KV formulation; only the default until beam
    # search is ported
    decode_self_attn_impl: str = "allslots"
    engine_policy: str = "fixed"     # "fixed" | "auto"
    # occupancy at which engine_policy="auto" picks chunked decode; only the
    # default until that policy is ported
    policy_chunked_min_occupancy: Optional[int] = None
    # micro-batching window of the HTTP server; 0 = one batch per request
    batch_window_ms: float = 0.0
    mesh_model: int = 1
    # int8 decode cross-attention through the CUDA kernel (needs
    # decode_kv_dtype="int8"); the JAX service has no such switch
    decode_fused_cross: bool = False


class LakoService:
    """The reader behind an ``answer_batch`` call.

    ``reader_params`` is a FiDT5 ``state_dict`` (for instance from
    ``models.t5.params_from_jax`` or ``init_fid_t5(...).state_dict()``); the
    service builds its own model on ``device`` (the CUDA card unless given;
    it raises without one) and loads it.
    """

    def __init__(self, cfg: ServiceConfig, t5_config: T5Config,
                 reader_params: Mapping[str, torch.Tensor], tokenizer,
                 device: Optional[torch.device] = None):
        if cfg.engine_policy not in ("fixed", "auto"):
            raise ValueError(
                f"engine_policy must be fixed|auto, got {cfg.engine_policy!r}")
        if cfg.engine_policy == "auto":
            raise NotImplementedError(
                "engine_policy='auto' needs chunked decode, not ported yet "
                "(ROADMAP item 11)")
        if cfg.mesh_model > 1:
            raise NotImplementedError(
                "tensor-parallel serving (mesh_model > 1) is not ported yet "
                "(ROADMAP item 11)")
        if cfg.num_beams > 1:
            raise NotImplementedError(
                "beam search (num_beams > 1) is not ported yet (ROADMAP item 10)")
        if cfg.decode_self_attn_impl != "allslots":
            raise NotImplementedError(
                f"decode_self_attn_impl={cfg.decode_self_attn_impl!r} belongs to the beam "
                "engine, not ported yet (ROADMAP item 10)")
        # checked whatever the engine policy, unlike the JAX service
        if cfg.policy_chunked_min_occupancy is not None:
            raise NotImplementedError(
                "policy_chunked_min_occupancy belongs to engine_policy='auto', not "
                "ported yet (ROADMAP item 11)")
        self.cfg = cfg
        self.device = resolve_device(device)
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        with torch.device(self.device):
            self.model = FiDT5(t5_config, dtype)
        self.model.load_state_dict(reader_params)
        self.model.eval().requires_grad_(False)
        self.tokenizer = tokenizer
        self._generate = make_best_generate_fn(
            self.model, max_length=cfg.max_length, keep_tokens=cfg.keep_tokens,
            backend=cfg.decode_backend, kv_dtype=cfg.decode_kv_dtype,
            weights_dtype=cfg.decode_weights_dtype,
            chunk_size=cfg.decode_chunk_size, fused_cross=cfg.decode_fused_cross)

    # -- retrieval -----------------------------------------------------------

    def retrieve_facts(self, questions: Sequence[dict]) -> List[List[dict]]:
        """No retriever is ported yet: every question gets no facts."""
        return [[] for _ in questions]

    # -- reading -------------------------------------------------------------

    @torch.inference_mode()
    def generate_tokens(self, requests: Sequence[dict]
                        ) -> Tuple[List[dict], np.ndarray]:
        """requests: [{question, caption, fact?: [{sentence, id, score?}]}] →
        (the examples built from them, (n, max_length-1) int32 token ids)."""
        requests = list(requests)
        need = [i for i, r in enumerate(requests) if not r.get("fact")]
        if need:
            retrieved = self.retrieve_facts([requests[i] for i in need])
            for i, facts in zip(need, retrieved):
                requests[i] = dict(requests[i], fact=facts)

        examples = [{
            "question": r["question"],
            "caption": r.get("caption", ""),
            "answer": {},
            "img_id": r.get("img_id", ""),
            "fact": r.get("fact", []),
            "target": None,
        } for r in requests]
        # empty fact lists break use_fact packing; degrade gracefully
        data_cfg = self.cfg.data
        if any(not e["fact"] for e in examples):
            data_cfg = data_cfg.replace(use_fact=False)
        ds = ReaderDataset(examples, data_cfg)
        collator = ReaderCollator(data_cfg, self.tokenizer)

        B = self.cfg.batch_size
        tokens = []
        for s in range(0, len(examples), B):
            chunk = [ds[i] for i in range(s, min(s + B, len(examples)))]
            batch = collator(chunk, pad_to=B)
            ids = torch.from_numpy(batch.passage_ids).to(self.device)
            pmask = torch.from_numpy(batch.passage_mask).to(self.device)
            out, _ = self._generate(ids, pmask)
            tokens.append(out[: len(chunk)].cpu().numpy())
        steps = self.cfg.max_length - 1
        return examples, (np.concatenate(tokens) if tokens
                          else np.zeros((0, steps), np.int32))

    def answer_batch(self, requests: Sequence[dict]) -> List[dict]:
        """requests: [{question, caption, fact?: [{sentence, id, score?}]}] →
        [{answer, facts}]."""
        examples, tokens = self.generate_tokens(requests)
        decoded = self.tokenizer.batch_decode(tokens)
        return [{"answer": answer, "facts": ex["fact"][: self.cfg.n_context]}
                for answer, ex in zip(decoded, examples)]

    def answer(self, question: str, caption: str = "",
               facts: Optional[List[dict]] = None) -> dict:
        req = {"question": question, "caption": caption}
        if facts:
            req["fact"] = facts
        return self.answer_batch([req])[0]


class MicroBatcher:
    """Dynamic micro-batching: merge concurrent requests into one device batch.

    A single worker thread drains a queue; after the first request of a batch
    arrives it keeps collecting until ``max_batch`` requests are in hand or
    ``window_s`` has elapsed, then runs ONE ``answer_batch`` for all of them.
    Clients block on a per-request event. A bad request poisons only its own
    slot (the batch is retried per request on error)."""

    def __init__(self, service: LakoService, max_batch: int, window_s: float):
        import queue
        import threading

        self._service = service
        self._max_batch = max_batch
        self._window = window_s
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, request: dict, timeout: float = 120.0) -> dict:
        out = self.submit_many([request], timeout=timeout)[0]
        if "error" in out:
            raise ValueError(out["error"])
        return out

    def submit_many(self, requests: Sequence[dict],
                    timeout: float = 120.0) -> List[dict]:
        """Enqueue all requests at once, then wait for all. A failed slot
        yields ``{"error": ..., "index": i}`` in place; the others keep their
        results."""
        import threading
        import time

        slots = [{"req": r, "ev": threading.Event()} for r in requests]
        for slot in slots:
            self._q.put(slot)
        deadline = time.monotonic() + timeout
        timed_out = False
        for slot in slots:
            if not slot["ev"].wait(timeout=max(0.0, deadline - time.monotonic())):
                timed_out = True
        if timed_out:
            raise TimeoutError("micro-batch worker did not respond in time")
        return [s["result"] if "error" not in s
                else {"error": s["error"], "index": i}
                for i, s in enumerate(slots)]

    def _loop(self):
        import queue
        import time

        while True:
            slots = [self._q.get()]
            deadline = time.monotonic() + self._window
            while len(slots) < self._max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    slots.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                results = self._service.answer_batch([s["req"] for s in slots])
                for s, r in zip(slots, results):
                    s["result"] = r
            except Exception:  # noqa: BLE001 — isolate the bad request(s)
                for s in slots:
                    try:
                        s["result"] = self._service.answer_batch([s["req"]])[0]
                    except Exception as e:  # noqa: BLE001
                        s["error"] = str(e)
            for s in slots:
                s["ev"].set()


def make_http_server(service: LakoService, host: str = "127.0.0.1", port: int = 8080):
    """Stdlib HTTP server for POST /answer {question, caption, fact?} (or a
    list of them). With ``cfg.batch_window_ms > 0`` it is threaded and
    concurrent requests share device batches through a MicroBatcher. The
    caller runs ``serve_forever`` and later ``shutdown``/``server_close``."""
    from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer

    window = service.cfg.batch_window_ms / 1e3
    batcher = (MicroBatcher(service, service.cfg.batch_size, window)
               if window > 0 else None)

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path != "/answer":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(length))
                if isinstance(payload, dict):
                    payload = [payload]
                if batcher is not None:
                    out = batcher.submit_many(payload)
                else:
                    out = service.answer_batch(payload)
            except TimeoutError as e:   # server-side stall, not a client error
                self._reply(503, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — report to the client
                self._reply(400, {"error": str(e)})
                return
            self._reply(200, out)

        def log_message(self, *a):
            pass

    server_cls = ThreadingHTTPServer if batcher is not None else HTTPServer
    return server_cls((host, port), Handler)


def run_http_server(service: LakoService, host: str = "127.0.0.1",
                    port: int = 8080) -> None:
    """Serve POST /answer until the process ends."""
    make_http_server(service, host, port).serve_forever()
