"""Serving: answer knowledge-based questions with the FiD reader.

Counterpart of lako_tpu/serve.py. ``LakoService.answer_batch`` retrieves
facts for the requests that carry none (the BERT retriever embeds
``question + " " + caption`` and the fact index returns the top
``n_context``), collates the requests into fixed ``(B, N, L)`` batches,
encodes the passages and decodes them (models/t5/decode.py
``make_best_generate_fn``: greedy or beam search, on the stacked-weight
engines or the layer-unrolled path), under ``torch.inference_mode``.
Retrieval runs before decoding starts, outside the decode engine's CUDA
graphs. A stdlib HTTP endpoint wraps it, optionally behind a micro-batcher.
Tensor-parallel serving (``mesh_model > 1``) is not ported yet and is
refused at construction.
"""

from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from lako_tpu_torch.core.config import ReaderDataConfig, T5Config
from lako_tpu_torch.core.device import resolve_device
from lako_tpu_torch.core.logging import get_logger
from lako_tpu_torch.data import ReaderCollator, ReaderDataset
from lako_tpu_torch.models.t5.decode import make_best_generate_fn
from lako_tpu_torch.models.t5.engine import DecodeEngine
from lako_tpu_torch.models.retriever import Retriever
from lako_tpu_torch.models.t5.model import FiDT5
from lako_tpu_torch.retrieval.embed import make_embed_fn
from lako_tpu_torch.retrieval.native import HostIndex, NativeIndex


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
    decode_kv_dtype: str = "native"  # "native" | "int8" | "int8mxu"
    decode_weights_dtype: str = "native"  # "native" | "int8" (weight-only)
    decode_chunk_size: Optional[int] = None
    # the beam engine's self-KV formulation (allslots | gather | flat |
    # packed | stepmajor | fusedkv); greedy ignores it
    decode_self_attn_impl: str = "allslots"
    # "fixed": decode_chunk_size as configured; "auto": chunked early-exit
    # decode for batches of at least policy_chunked_min_occupancy requests,
    # full-length below (greedy only)
    engine_policy: str = "fixed"
    # None = max(batch_size // 2, 5); a value batch_size cannot reach, or
    # below 1, is refused
    policy_chunked_min_occupancy: Optional[int] = None
    # micro-batching window of the HTTP server; 0 = one batch per request
    batch_window_ms: float = 0.0
    mesh_model: int = 1
    # int8 decode cross-attention through the CUDA kernel (needs
    # decode_kv_dtype="int8"); the JAX service has no such switch
    decode_fused_cross: bool = False


class LakoService:
    """The retriever and the reader behind an ``answer_batch`` call.

    ``reader_params`` is a FiDT5 ``state_dict`` (for instance from
    ``models.t5.params_from_jax`` or ``init_fid_t5(...).state_dict()``); the
    service builds its own model on ``device`` (the CUDA card unless given;
    it raises without one) and loads it. Likewise ``retriever`` (a
    ``Retriever``, on any device, the meta device included) gives the
    retriever's config and dtype and ``retriever_params`` its weights
    (default: the module's own); ``index`` is a ``DenseIndex`` or
    ``PQIndex`` over the fact embeddings, or a ``NativeIndex`` or
    ``HostIndex`` over them on the host (retrieval/native.py), and
    ``id_to_sentence`` maps its ids to fact sentences. Without a retriever or an index, requests without
    facts are answered without facts.

    ``engine_policy="auto"`` runs two greedy programs on one engine, the
    full-length one and a chunked early-exit one (``decode_chunk_size or
    16``), and picks per device batch by its real occupancy: chunked from
    ``policy_chunked_min_occupancy`` requests up (default
    ``max(batch_size // 2, 5)``), full-length below. Each decision is kept
    in ``policy_decisions``. Beam search has no chunked program and ignores
    the policy.
    """

    def __init__(self, cfg: ServiceConfig, t5_config: T5Config,
                 reader_params: Mapping[str, torch.Tensor], tokenizer,
                 retriever: Optional[Retriever] = None,
                 retriever_params: Optional[Mapping[str, torch.Tensor]] = None,
                 bert_tokenizer=None,
                 index=None,              # DenseIndex / PQIndex / NativeIndex / HostIndex
                 id_to_sentence: Optional[Dict[int, str]] = None,
                 device: Optional[torch.device] = None):
        if cfg.engine_policy not in ("fixed", "auto"):
            raise ValueError(
                f"engine_policy must be fixed|auto, got {cfg.engine_policy!r}")
        if cfg.mesh_model > 1:
            raise NotImplementedError(
                "tensor-parallel serving (mesh_model > 1) is not ported yet "
                "(ROADMAP item 11)")
        self._policy_threshold = (
            max(cfg.batch_size // 2, 5) if cfg.policy_chunked_min_occupancy is None
            else cfg.policy_chunked_min_occupancy)
        # an explicit threshold is checked under either policy, unlike the
        # JAX service, which checks it only under "auto"
        explicit = cfg.policy_chunked_min_occupancy is not None
        if (cfg.engine_policy == "auto" or explicit) and self._policy_threshold < 1:
            # <= 0 would run chunked decode on every batch, occupancy 1 included
            raise ValueError(
                f"policy_chunked_min_occupancy={self._policy_threshold} "
                "must be >= 1; engine_policy='auto' would silently run "
                "chunked decode on every batch")
        if self._policy_threshold > cfg.batch_size:
            if explicit:
                raise ValueError(
                    f"policy_chunked_min_occupancy={self._policy_threshold} can never "
                    f"be reached with batch_size={cfg.batch_size}; engine_policy='auto' "
                    "would silently always run full-length")
            if cfg.engine_policy == "auto":
                get_logger().warning(
                    "engine_policy='auto' with batch_size=%d: the default threshold "
                    "max(batch_size // 2, 5) = %d is out of reach, so every batch "
                    "will run the full-length engine", cfg.batch_size,
                    self._policy_threshold)
        self.cfg = cfg
        self.device = resolve_device(device)
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        with torch.device(self.device):
            self.model = FiDT5(t5_config, dtype)
        self.model.load_state_dict(reader_params)
        self.model.eval().requires_grad_(False)
        self.tokenizer = tokenizer
        greedy = cfg.num_beams == 1

        # num_beams > 1 routes to the beam engine when the model allows, the
        # layer-unrolled beam path otherwise
        def make_gen(chunk_size):
            return make_best_generate_fn(
                self.model, max_length=cfg.max_length,
                keep_tokens=cfg.keep_tokens if greedy else None,
                backend=cfg.decode_backend, kv_dtype=cfg.decode_kv_dtype,
                weights_dtype=cfg.decode_weights_dtype, chunk_size=chunk_size,
                num_beams=cfg.num_beams,
                self_attn_impl="allslots" if greedy else cfg.decode_self_attn_impl,
                fused_cross=cfg.decode_fused_cross and greedy)

        chunk_size = cfg.decode_chunk_size
        # "auto" picks per batch between full-length and chunked decode: one
        # greedy engine runs both (its graphs are keyed by chunk start and
        # length); the layer-unrolled path has no chunked program
        self._policy = cfg.engine_policy == "auto" and greedy
        if self._policy:
            chunk_size = chunk_size or 16
        elif cfg.engine_policy == "auto":
            get_logger().warning(
                "engine_policy='auto' applies to greedy decode only; "
                "num_beams=%d runs the beam engine unconditionally", cfg.num_beams)
        self._generate = make_gen(chunk_size)
        engine = getattr(self._generate, "__self__", None)
        self._takes_chunked = isinstance(engine, DecodeEngine)
        # ("chunked" | "full", occupancy) per device batch, bounded
        self.policy_decisions: Deque[tuple] = deque(maxlen=4096)

        self.retriever = None
        if retriever is not None:
            with torch.device(self.device):
                self.retriever = Retriever(retriever.config, retriever.dtype)
            self.retriever.load_state_dict(retriever.state_dict() if retriever_params is None
                                           else retriever_params)
            self.retriever.eval().requires_grad_(False)
            self._embed_q = make_embed_fn(self.retriever, "q", to_host=False)
        self.bert_tokenizer = bert_tokenizer
        self.index = index
        self.id_to_sentence = id_to_sentence or {}

    # -- retrieval -----------------------------------------------------------

    def retrieve_facts(self, questions: Sequence[dict]) -> List[List[dict]]:
        """questions: [{question, caption}] → per-question fact lists
        ``[{sentence, id, score}]``, the top ``min(n_context, index.n)``."""
        if self.index is None or self.retriever is None:
            return [[] for _ in questions]
        texts = [q["question"] + " " + q.get("caption", "") for q in questions]
        emb = self._embed_q(*self.bert_tokenizer.batch_encode(
            texts, self.retriever.config.question_maxlength))
        if isinstance(self.index, (NativeIndex, HostIndex)):   # they search numpy on the host
            emb = emb.cpu().numpy()
        k = min(self.cfg.n_context, getattr(self.index, "n", self.cfg.n_context))
        top_ids, scores = self.index.search(emb, k=k)
        return [[{"sentence": self.id_to_sentence.get(int(i), ""), "id": int(i),
                  "score": float(s)} for i, s in zip(row_ids, row_scores)]
                for row_ids, row_scores in zip(top_ids, scores)]

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
            kw = {}
            if self._policy:
                use_chunked = len(chunk) >= self._policy_threshold
                self.policy_decisions.append(("chunked" if use_chunked else "full",
                                              len(chunk)))
                if self._takes_chunked:
                    kw["chunked"] = use_chunked
            out, _ = self._generate(ids, pmask, **kw)
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
