"""Reader training and evaluation loops: the port of lako_tpu/train/reader.py.

One device, eager PyTorch. The train step runs FiDT5 in training mode
(dropout keyed by ``(seed, step)``, the encoder blocks rematerialized under
``use_remat``, encoder self-attention through the streamed kernels K1 and
K2a/K2b/K2c, or the whole-block kernel K4, when the config routes it there),
takes the gradient of the mean cross-entropy over labels that are not -100,
and applies clipping, Adam(W) (``adamw8bit``: 8-bit moments through the
kernel K5) and the linear warmup schedule (train/optim.py). Each epoch ends
with a greedy eval through ``make_best_generate_fn`` and exact match. Both
loops run on the CUDA card unless given another device.

Not ported yet; each raises ``NotImplementedError``: checkpoints
(``save_checkpoints=True``), ``resume_from`` and ``profile_dir`` (ROADMAP
item 4), pipeline parallelism (``mesh.pipe > 1``) and more than one device
(item 12).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from lako_tpu_torch.core.config import ReaderTrainConfig, t5_config_for_size
from lako_tpu_torch.core.device import resolve_device
from lako_tpu_torch.core.logging import get_logger
from lako_tpu_torch.data import ReaderCollator, ReaderDataset, batch_iterator
from lako_tpu_torch.models.t5 import FiDT5, init_fid_t5, jax_param_paths
from lako_tpu_torch.models.t5.decode import make_best_generate_fn
from lako_tpu_torch.models.t5.layers import set_dropout_key
from lako_tpu_torch.text.metrics import ems
from lako_tpu_torch.train.optim import make_optimizer
from lako_tpu_torch.train.state import TrainState


def model_params(model: FiDT5) -> Dict[str, torch.Tensor]:
    """The model's parameters keyed by their JAX paths (the train state's
    ``params``; the optimizer's masks read these paths)."""
    paths = jax_param_paths(model)
    return {paths[name]: p for name, p in model.named_parameters()}


def make_reader_train_step(model: FiDT5, backend: str = "flax") -> Callable:
    """``(state, ids, mask, labels, seed) -> (state, loss)``.

    ``state.params`` must be ``model``'s own parameters (:func:`model_params`);
    the step updates them in place. Dropout masks are drawn from ``(seed,
    state.step)``, as the JAX step folds the step into its key. backend:
    "flax" or "scan". In the JAX package "scan" is a compile-time layout
    (``lax.scan`` over stacked layers) with the same loss; eager PyTorch has
    nothing to compile, so both run this same step.
    """
    if backend not in ("flax", "scan"):
        raise ValueError(f"unknown train backend {backend!r}")

    def train_step(state: TrainState, ids, mask, labels, seed: int):
        model.train()
        set_dropout_key(model, seed, state.step)
        names = list(state.params)
        params = [state.params[n] for n in names]
        loss, _, _ = model(ids, mask, labels)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for n, p, g in zip(names, params, grads)}
        return state.apply_gradients(grads), loss.detach()

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
    bf16. Both cast, whatever the parameters held before."""
    if cfg.param_dtype in ("float32", "f32"):
        return model.to(torch.float32)
    if cfg.param_dtype not in ("bfloat16", "bf16"):
        raise ValueError(f"param_dtype must be float32|bfloat16, got {cfg.param_dtype!r}")
    logger.info("param_dtype=bfloat16: bf16 master params and moments")
    return model.to(torch.bfloat16)


@dataclass
class ReaderTrainResult:
    best_dev_em: float
    final_step: int
    epochs_run: int
    history: List[Dict[str, float]]
    state: TrainState


def _refuse_unported(cfg: ReaderTrainConfig, mesh, save_checkpoints: bool,
                     resume_from: Optional[str]) -> None:
    if save_checkpoints:
        raise NotImplementedError("checkpoints are not ported yet (ROADMAP item 4); "
                                  "pass save_checkpoints=False")
    if resume_from is not None:
        raise NotImplementedError("resume_from: checkpoints are not ported yet (ROADMAP item 4)")
    if cfg.profile_dir is not None:
        raise NotImplementedError("profile_dir (torch.profiler traces) is not ported yet "
                                  "(ROADMAP item 4)")
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
    device: Optional[torch.device] = None,
) -> ReaderTrainResult:
    """Train the FiD reader on ``device`` (the CUDA card unless given; it
    raises without one) for ``cfg.epochs``
    epochs with early stopping on dev EM. ``init_params`` is a state_dict of
    the port's FiDT5 (``params_from_jax`` gives one from a JAX tree); without
    it the model is drawn by ``init_fid_t5`` from a generator seeded with
    ``cfg.seed``."""
    _refuse_unported(cfg, mesh, save_checkpoints, resume_from)
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
    train_step = make_reader_train_step(model, backend=cfg.train_backend)

    best_dev_em, step, patience, epoch = 0.0, 0, 0, 0
    history: List[Dict[str, float]] = []
    for epoch in range(1, cfg.epochs + 1):
        t0 = time.time()
        losses = []
        for batch in batch_iterator(train_ds, batch_size, collator, shuffle=True,
                                    seed=cfg.seed + epoch, drop_last=True, prefetch=2):
            ids, mask, labels = (torch.from_numpy(a).to(device) for a in (
                batch.passage_ids, batch.passage_mask, batch.labels))
            state, loss = train_step(state, ids, mask, labels, cfg.seed)
            losses.append(loss)
            step += 1
        train_loss = float(torch.stack(losses).float().mean()) if losses else float("nan")

        if epoch % cfg.eval_every and epoch != cfg.epochs:
            # the final epoch always evaluates; patience counts evaluated epochs
            history.append({"epoch": epoch, "loss": train_loss, "seconds": time.time() - t0})
            logger.info("epoch %d | step %d | train loss: %.3f | %.1fs",
                        epoch, step, train_loss, time.time() - t0)
            continue

        patience += 1
        model.eval()
        # the engine stacks the decoder weights when it is built: build it anew
        generate_fn = make_best_generate_fn(
            model, max_length=cfg.eval_max_length, backend=cfg.decode_backend,
            kv_dtype=cfg.decode_kv_dtype, weights_dtype=cfg.decode_weights_dtype,
            chunk_size=cfg.decode_chunk_size)
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
        if patience > cfg.early_stop:
            logger.info("early stop in epoch %d", epoch)
            break
    return ReaderTrainResult(best_dev_em, step, epoch, history, state)
