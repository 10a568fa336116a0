"""Reader training and evaluation loops: the port of lako_tpu/train/reader.py.

One device. The train step runs FiDT5 in training mode
(dropout keyed by ``(seed, step)``, the encoder blocks rematerialized under
``use_remat``, encoder self-attention through the streamed kernels K1 and
K2a/K2b/K2c, or the whole-block kernel K4, when the config routes it there),
takes the gradient of the mean cross-entropy over labels that are not -100,
and applies clipping, Adam(W) (``adamw8bit``: 8-bit moments through the
kernel K5) or Adafactor (K7) and the linear warmup schedule
(train/optim.py). On the card, with Adafactor on float32 masters, the step
replays CUDA graphs of each input shape from the shape's second step on,
the forward and backward and then the update (:class:`_StepGraphs`); other
optimizers run eagerly. Each epoch ends with a greedy eval through
``make_best_generate_fn`` and exact match, with the graphs dropped first.
Both loops run on the CUDA card unless given another device.

The run loop is the JAX package's: ``best_dev`` saved on an improvement and
``last`` every evaluated epoch (core/checkpoint.py, main process only);
``resume_from`` with ``reset_params`` (weights only, or the optimizer, step
and best metric too); a ``preempted`` save and exit when the preemption flag
is up (core/preemption.py); and a ``torch.profiler`` trace of this process's
steps 3-5 into ``profile_dir`` (core/profiling.py).

Not ported yet; each raises ``NotImplementedError``: pipeline parallelism
(``mesh.pipe > 1``) and more than one device (ROADMAP item 12).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from lako_tpu_torch.core import preemption
from lako_tpu_torch.core.checkpoint import (
    flatten_tree,
    load_checkpoint,
    save_checkpoint,
    unflatten_tree,
)
from lako_tpu_torch.core.config import ReaderTrainConfig, t5_config_for_size
from lako_tpu_torch.core.device import resolve_device
from lako_tpu_torch.core.distributed import is_main
from lako_tpu_torch.core.logging import get_logger
from lako_tpu_torch.core import profiling
from lako_tpu_torch.core.profiling import start_trace
from lako_tpu_torch.data import ReaderCollator, ReaderDataset, batch_iterator
from lako_tpu_torch.models.t5 import FiDT5, init_fid_t5, jax_param_paths
from lako_tpu_torch.models.t5.decode import make_best_generate_fn
from lako_tpu_torch.models.t5.layers import Dropout, set_dropout_key
from lako_tpu_torch.text.metrics import ems
from lako_tpu_torch.train.optim import apply_updates, make_optimizer
from lako_tpu_torch.train.state import TrainState


def model_params(model: FiDT5) -> Dict[str, torch.Tensor]:
    """The model's parameters keyed by their JAX paths (the train state's
    ``params``; the optimizer's masks read these paths)."""
    paths = jax_param_paths(model)
    return {paths[name]: p for name, p in model.named_parameters()}


GRAPH_SHAPES = 4     # input shapes whose captured step a train step keeps


def _forward_backward(model: FiDT5, params: List[torch.Tensor], ids, mask, labels):
    """The step's loss and the gradient of every parameter (zeros for one
    the loss does not reach)."""
    loss, _, _ = model(ids, mask, labels)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss, [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def _apply_update(tx, opt_state, params: Dict[str, torch.Tensor], grads: List[torch.Tensor]):
    """``tx``'s device half (``tx.apply``) on ``params`` in place, as a graph
    captures it."""
    with torch.no_grad():
        apply_updates(params, tx.apply(dict(zip(params, grads)), opt_state, params))


def _eager_step(model: FiDT5, state: TrainState, ids, mask, labels):
    with profiling.span("train.fwd_bwd", device=ids.device):
        loss, grads = _forward_backward(model, list(state.params.values()), ids, mask, labels)
    return state.apply_gradients(dict(zip(state.params, grads))), loss.detach()


def _bindings(state: TrainState) -> tuple:
    """What a captured step works on besides its inputs: the optimizer, and
    the buffers of the parameters and of the optimizer's state."""
    tensors = [*state.params.values(), *(v for v in flatten_tree(state.opt_state).values()
                                         if isinstance(v, torch.Tensor))]
    return (id(state.tx), *((t.data_ptr(), t.dtype) for t in tensors))


class _Captured(NamedTuple):
    """One input shape's captured step."""

    forward_backward: "torch.cuda.CUDAGraph"
    update: "torch.cuda.CUDAGraph"
    inputs: Tuple[torch.Tensor, ...]      # the static ids, mask and labels
    loss: torch.Tensor
    dropout: List[Tuple[Dropout, List[torch.Generator]]]
    bindings: tuple                       # :func:`_bindings` at capture


class _StepGraphs:
    """The train step as two CUDA graphs an input shape (shapes and dtypes
    of ids, mask and labels) in one memory pool: the forward, loss and
    ``autograd.grad``; then the optimizer's update of the parameters and its
    state in place, for an optimizer whose update a graph can capture
    (``tx.load``, train/optim.py: Adafactor through K7 on float32 masters).
    For another the step stays eager (``__call__`` returns None).

    A shape's first call runs eagerly, its forward and backward on the
    graphs' stream (library handles, autograd's threads, the kernels'
    binding), and notes each Dropout module's applications. Its second
    captures both graphs, and it and every later call copy the inputs into
    the graph's buffers, seed the graph's dropout generators (one an
    application) from ``(seed, step)``, replay the forward and backward, and
    replay the update after its host half (``TrainState.replay_update``).
    The gradients are the first graph's outputs and the second's inputs, and
    no tensor holds them between the graphs' captures and replays: like the
    activations they are free blocks of the pool, which only a capture into
    the pool takes, and the allocator counts neither between steps, as for
    an eager step. The loss is a copy. A shape whose parameters or optimizer
    state no longer have the buffers it captured (a parameter rebound, as
    ``.to(dtype)`` does), or whose optimizer changed, is captured again. At
    most ``GRAPH_SHAPES`` shapes are kept, the oldest dropped first;
    :meth:`release` drops them all and the pool. Counters
    ``train.graph_captures`` and ``train.graph_replays``
    (core/profiling.py)."""

    def __init__(self, model: FiDT5):
        self.model = model
        # each warmed shape's Dropout modules and their applications a step
        self.applications: Dict[tuple, List[Tuple[Dropout, int]]] = {}
        self.graphs: Dict[tuple, _Captured] = {}
        self.stream = None
        self.pool = None

    def release(self) -> None:
        """Drops every captured graph and hands their pool's memory back to
        the device (the allocator's cache emptied); a shape captures again at
        its next call."""
        self.graphs.clear()
        self.pool = None
        torch.cuda.empty_cache()

    def __call__(self, state: TrainState, ids, mask, labels, seed: int):
        key = tuple((tuple(t.shape), t.dtype) for t in (ids, mask, labels))
        captured = self.graphs.get(key)
        if captured is not None and captured.bindings != _bindings(state):
            del self.graphs[key]
            captured = None
            if not self.graphs:   # the pool goes with its last graph
                self.pool = None
        opt_state = None
        if captured is None:
            if key not in self.applications:
                return self._warm_up(key, state, ids, mask, labels)
            opt_state = state.load_update()
            if opt_state is None:
                return None
        with profiling.span("train.fwd_bwd", device=ids.device):
            if captured is None:
                profiling.count("train.graph_captures")
                captured = self.graphs[key] = self._capture(key, state, ids, mask, labels)
                if len(self.graphs) > GRAPH_SHAPES:
                    del self.graphs[next(iter(self.graphs))]
            else:
                for mine, new in zip(captured.inputs, (ids, mask, labels)):
                    mine.copy_(new)
            for module, generators in captured.dropout:
                module.seed_generators(generators, seed, state.step)
            captured.forward_backward.replay()
            loss = captured.loss.detach().clone()
        state = state.replay_update(captured.update.replay, opt_state)
        profiling.count("train.graph_replays")
        return state, loss

    def _side_stream(self, device: torch.device):
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        return self.stream

    def _side_forward_backward(self, params: List[torch.Tensor], ids, mask, labels):
        """The forward and backward eagerly on the graphs' stream, their
        outputs freed on the current stream after their last use there."""
        main = torch.cuda.current_stream(ids.device)
        side = self._side_stream(ids.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            loss, grads = _forward_backward(self.model, params, ids, mask, labels)
        main.wait_stream(side)
        for t in (loss, *grads):
            t.record_stream(main)
        return loss, grads

    def _warm_up(self, key, state: TrainState, ids, mask, labels):
        with profiling.span("train.fwd_bwd", device=ids.device):
            loss, grads = self._side_forward_backward(list(state.params.values()),
                                                      ids, mask, labels)
        self.applications[key] = [(m, m.applied) for m in self.model.modules()
                                  if isinstance(m, Dropout) and m.applied]
        return state.apply_gradients(dict(zip(state.params, grads))), loss.detach()

    def _capture(self, key, state: TrainState, ids, mask, labels) -> _Captured:
        device, stream = ids.device, self._side_stream(ids.device)
        params = list(state.params.values())
        forward_backward, update = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        dropout = [(m, [torch.Generator(device=device) for _ in range(n)])
                   for m, n in self.applications[key]]
        for _, generators in dropout:
            for gen in generators:
                forward_backward.register_generator_state(gen)
        inputs = tuple(t.clone() for t in (ids, mask, labels))
        for module, generators in dropout:
            module.generators = generators
        try:
            with torch.cuda.graph(forward_backward, pool=self.pool, stream=stream):
                loss, grads = _forward_backward(self.model, params, *inputs)
        finally:
            for module, _ in dropout:
                module.generators = None
        if any(module.applied != len(generators) for module, generators in dropout):
            raise RuntimeError("the captured step applied dropout other than its eager "
                               "first step did")
        if self.pool is None:
            self.pool = forward_backward.pool()
        with torch.cuda.graph(update, pool=self.pool, stream=stream):
            _apply_update(state.tx, state.opt_state, state.params, grads)
        return _Captured(forward_backward, update, inputs, loss, dropout, _bindings(state))


def make_reader_train_step(model: FiDT5, cuda_graphs: bool = True) -> Callable:
    """``(state, ids, mask, labels, seed) -> (state, loss)``.

    ``state.params`` must be ``model``'s own parameters
    (:func:`model_params`); the step updates them in place. Dropout masks
    are drawn from ``(seed, state.step)``, as the JAX step folds the step
    into its key. On a CUDA device, for an optimizer whose update a CUDA
    graph can capture (``tx.load``), the step replays two graphs from a
    shape's second call on, the forward and backward and the update
    (:class:`_StepGraphs`; the same kernels and masks as the eager step);
    other optimizers, CPU tensors and ``cuda_graphs=False`` run the step
    eagerly. The forward and backward are the stream span ``train.fwd_bwd``,
    the update ``train.optimizer`` (core/profiling.py). The step's
    ``release()`` drops its graphs and their memory, as before an eval.
    """
    graphs = _StepGraphs(model) if cuda_graphs else None

    def train_step(state: TrainState, ids, mask, labels, seed: int):
        model.train()
        set_dropout_key(model, seed, state.step)
        if graphs is not None and ids.is_cuda and state.tx.load is not None:
            out = graphs(state, ids, mask, labels, seed)
            if out is not None:
                return out
        return _eager_step(model, state, ids, mask, labels)

    train_step.release = graphs.release if graphs is not None else lambda: None
    return train_step


def evaluate_reader(generate_fn: Callable, dataset: ReaderDataset,
                    collator: ReaderCollator, tokenizer, batch_size: int,
                    device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Greedy decode + weighted EM over a dataset, in one process.
    ``generate_fn(ids, mask)`` is bound to its model (make_best_generate_fn),
    so there are no params to pass. The final partial batch is padded with
    rows marked invalid, which are not scored. ``device``: where the batches
    go, the CUDA card unless given."""
    device = resolve_device(device)
    scores: List[float] = []
    answers: List[str] = []
    indices: List[int] = []
    for batch in batch_iterator(dataset, batch_size, collator, shuffle=False):
        ids = torch.from_numpy(batch.passage_ids).to(device)
        mask = torch.from_numpy(batch.passage_mask).to(device)
        tokens, _ = generate_fn(ids, mask)
        decoded = tokenizer.batch_decode(tokens.cpu().numpy())
        for k, ans in enumerate(decoded):
            if not batch.valid[k]:
                continue
            gold = dataset.get_example(int(batch.index[k]))["answer"]
            scores.append(ems(ans, gold))
            answers.append(ans)
            indices.append(int(batch.index[k]))
    return {"em": float(np.mean(scores)) if scores else 0.0, "total": len(scores),
            "answers": answers, "indices": indices}


def _apply_param_dtype(cfg: ReaderTrainConfig, model: FiDT5, logger) -> FiDT5:
    """Master-parameter dtype policy: "float32" keeps f32 masters, "bfloat16"
    casts them (and so the Adam moments, which take the params' dtype) to
    bf16. Both cast, whatever the parameters held before; a restore copies
    into these tensors, which casts the checkpoint's values to the policy."""
    if cfg.param_dtype in ("float32", "f32"):
        return model.to(torch.float32)
    if cfg.param_dtype not in ("bfloat16", "bf16"):
        raise ValueError(f"param_dtype must be float32|bfloat16, got {cfg.param_dtype!r}")
    logger.info("param_dtype=bfloat16: bf16 master params and moments")
    return model.to(torch.bfloat16)


def _cast_opt_like(template_opt, restored_opt):
    """The restored optimizer state on the template's device, its float
    tensors in the template's dtypes: a checkpoint keeps the dtype of the run
    that wrote it, and the param_dtype policy of this run decides."""
    template = flatten_tree(template_opt)

    def cast(key, v):
        if not isinstance(v, torch.Tensor):
            return v
        t = template[key]
        return v.to(device=t.device, dtype=t.dtype if v.is_floating_point() else v.dtype)

    return unflatten_tree(template_opt, {k: cast(k, v)
                                         for k, v in flatten_tree(restored_opt).items()})


@dataclass
class ReaderTrainResult:
    best_dev_em: float
    final_step: int
    epochs_run: int
    history: List[Dict[str, float]]
    state: TrainState


def _refuse_unported(cfg: ReaderTrainConfig, mesh) -> None:
    if cfg.train_backend not in ("flax", "scan"):
        raise ValueError(f"unknown train backend {cfg.train_backend!r}")
    if cfg.mesh.pipe > 1:
        raise NotImplementedError("mesh.pipe > 1: pipeline parallelism is not ported yet "
                                  "(ROADMAP item 12)")
    if mesh is not None or cfg.mesh.data > 1 or cfg.mesh.model > 1:
        raise NotImplementedError("training on more than one device is not ported yet "
                                  "(ROADMAP item 12); the port trains on one device "
                                  "(mesh.data=-1 means that device)")


def train_reader(
    cfg: ReaderTrainConfig,
    train_examples: Sequence[dict],
    eval_examples: Sequence[dict],
    tokenizer,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    t5_config=None,
    mesh=None,
    save_checkpoints: bool = True,
    resume_from: Optional[str] = None,
    reset_params: bool = True,
    device: Optional[torch.device] = None,
) -> ReaderTrainResult:
    """Train the FiD reader on ``device`` (the CUDA card unless given; it
    raises without one) for ``cfg.epochs`` epochs with early stopping on dev
    EM. ``init_params`` is a state_dict of the port's FiDT5
    (``params_from_jax`` gives one from a JAX tree); without it the model is
    drawn by ``init_fid_t5`` from a generator seeded with ``cfg.seed``.

    resume_from: a checkpoint directory (or a run's, for its ``latest``).
    ``reset_params=True`` restores the weights only and starts the optimizer
    fresh at step 0 (a warm start); False restores the optimizer state, step
    and best metric too (a crash or preemption resume). The restored values
    are copied into the model's own parameters, which the train state holds
    and the optimizer updates in place."""
    _refuse_unported(cfg, mesh)
    logger = get_logger()
    device = resolve_device(device)
    t5_cfg = t5_config or t5_config_for_size(cfg.model_size, vocab_size=tokenizer.vocab_size)
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    train_ds = ReaderDataset(train_examples, cfg.data, seed=cfg.seed)
    eval_ds = ReaderDataset(eval_examples, cfg.data, seed=cfg.seed)
    collator = ReaderCollator(cfg.data, tokenizer)

    batch_size = cfg.per_device_batch_size          # one device
    steps_per_epoch = len(train_ds) // batch_size
    total_steps = max(1, steps_per_epoch * cfg.epochs)
    warmup = int(total_steps * cfg.warmup_fraction)
    tx = make_optimizer(cfg.optim.replace(warmup_steps=warmup, total_steps=total_steps,
                                          scheduler="linear"))

    model = init_fid_t5(t5_cfg, torch.Generator(device=device).manual_seed(cfg.seed), dtype,
                        use_remat=cfg.use_remat, remat_policy=cfg.remat_policy)
    if init_params is not None:
        model.load_state_dict(init_params)
    model = _apply_param_dtype(cfg, model, logger)
    state = TrainState.create(model_params(model), tx)
    best_dev_em, step = 0.0, 0
    if resume_from is not None:
        live = model.state_dict()
        params, opt_state, meta = load_checkpoint(
            resume_from, live, None if reset_params else state.opt_state)
        with torch.no_grad():
            for name, value in params.items():
                live[name].copy_(value)
        if not reset_params and opt_state is not None:
            step = int(meta.get("step", 0))
            best_dev_em = float(meta.get("best_eval_metric", 0.0))
            state = dataclasses.replace(state, step=step,
                                        opt_state=_cast_opt_like(state.opt_state, opt_state))
        elif not reset_params:
            logger.warning("requested optimizer resume but checkpoint has no optimizer "
                           "state; starting fresh")
    train_step = make_reader_train_step(model)
    ckpt_dir = f"{cfg.checkpoint_dir}/{cfg.name}"

    def save(name: str) -> None:
        if save_checkpoints and is_main():
            save_checkpoint(ckpt_dir, name, model.state_dict(), state.opt_state, step,
                            best_dev_em)

    patience, epoch = 0, 0
    history: List[Dict[str, float]] = []
    # profile_dir: trace local steps 3-5 of this process, counted from the
    # process's first step, not from a restored step
    stop_trace, local_step = None, 0
    for epoch in range(1, cfg.epochs + 1):
        t0 = time.time()
        losses = []
        for batch in batch_iterator(train_ds, batch_size, collator, shuffle=True,
                                    seed=cfg.seed + epoch, drop_last=True, prefetch=2):
            if cfg.profile_dir is not None and local_step == 2:
                stop_trace = start_trace(cfg.profile_dir)
            ids, mask, labels = (torch.from_numpy(a).to(device) for a in (
                batch.passage_ids, batch.passage_mask, batch.labels))
            state, loss = train_step(state, ids, mask, labels, cfg.seed)
            losses.append(loss)
            step += 1
            local_step += 1
            if stop_trace is not None and local_step >= 5:
                stop_trace()
                stop_trace = None
            if preemption.preempted():
                preemption.handle_preemption(lambda: save("preempted"))
        train_loss = float(torch.stack(losses).float().mean()) if losses else float("nan")

        if epoch % cfg.eval_every and epoch != cfg.epochs:
            # the final epoch always evaluates; patience counts evaluated epochs
            history.append({"epoch": epoch, "loss": train_loss, "seconds": time.time() - t0})
            logger.info("epoch %d | step %d | train loss: %.3f | %.1fs",
                        epoch, step, train_loss, time.time() - t0)
            continue

        patience += 1
        train_step.release()   # the eval's working set takes the graphs' memory
        model.eval()
        # the engine stacks the decoder weights when it is built: build it anew
        generate_fn = make_best_generate_fn(
            model, max_length=cfg.eval_max_length, backend=cfg.decode_backend,
            kv_dtype=cfg.decode_kv_dtype, weights_dtype=cfg.decode_weights_dtype,
            chunk_size=cfg.decode_chunk_size, self_attn_impl=cfg.decode_self_attn_impl)
        ev = evaluate_reader(generate_fn, eval_ds, collator, tokenizer, cfg.eval_batch_size,
                             device)
        dev_em = ev["em"]
        history.append({"epoch": epoch, "loss": train_loss, "em": dev_em,
                        "seconds": time.time() - t0})
        logger.info("epoch %d | step %d | train loss: %.3f | evaluation: %.2fEM | %.1fs",
                    epoch, step, train_loss, 100 * dev_em, time.time() - t0)
        if dev_em > best_dev_em:
            patience = 0
            best_dev_em = dev_em
            save("best_dev")
        # refreshed every evaluated epoch for a crash or preemption resume
        save("last")
        if patience > cfg.early_stop:
            logger.info("early stop in epoch %d", epoch)
            break

    if stop_trace is not None:   # a run shorter than 5 steps
        stop_trace()
    return ReaderTrainResult(best_dev_em, step, epoch, history, state)
