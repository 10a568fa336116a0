"""Retriever distillation training: the port of lako_tpu/train/retriever.py.

Trains the bi-encoder on the KL divergence between its scores and the
reader's aggregated cross-attention scores, on one device, eager PyTorch:
dropout keyed by ``(seed, step)``, compute in the config's dtype (bf16 on the
card) over float32 master weights, and the JAX package's optimizer chain
(train/optim.py) with the linear schedule and 6% warmup. Evaluation reports
ranking inversions and top-k overlap against the gold order; eval batches
arrive with their facts sorted by gold score descending. ``best_dev`` is
saved on fewer inversions, ``last`` every epoch (core/checkpoint.py), and
the loop stops after ``early_stop`` epochs without a gain. It runs on the
CUDA card unless given another device.

Not ported yet; it raises ``NotImplementedError``: more than one device
(ROADMAP item 12).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from lako_tpu_torch.core.checkpoint import save_checkpoint
from lako_tpu_torch.core.config import ReaderDataConfig, RetrieverTrainConfig
from lako_tpu_torch.core.device import resolve_device
from lako_tpu_torch.core.distributed import is_main
from lako_tpu_torch.core.logging import get_logger
from lako_tpu_torch.data import ReaderDataset, RetrieverCollator, batch_iterator
from lako_tpu_torch.models.bert.convert import init_retriever, jax_param_paths
from lako_tpu_torch.models.retriever import Retriever
from lako_tpu_torch.models.t5.layers import set_dropout_key
from lako_tpu_torch.text.metrics import ranking_stats
from lako_tpu_torch.train.optim import make_optimizer
from lako_tpu_torch.train.state import TrainState


def model_params(model: Retriever) -> Dict[str, torch.Tensor]:
    """The model's parameters keyed by their JAX paths (the train state's
    ``params``; the optimizer's no-decay mask reads these paths)."""
    paths = jax_param_paths(model)
    return {paths[name]: p for name, p in model.named_parameters()}


def _tensors(batch, device: torch.device):
    return [torch.from_numpy(a).to(device) for a in (
        batch.question_ids, batch.question_mask, batch.passage_ids, batch.passage_mask)]


def make_retriever_train_step(model: Retriever) -> Callable:
    """``(state, q_ids, q_mask, p_ids, p_mask, gold, seed) -> (state, loss)``.

    ``state.params`` must be ``model``'s own parameters (:func:`model_params`);
    the step updates them in place. Dropout masks are drawn from ``(seed,
    state.step)``, as the JAX step folds the step into its key."""

    def train_step(state: TrainState, q_ids, q_mask, p_ids, p_mask, gold, seed: int):
        model.train()
        set_dropout_key(model, seed, state.step)
        names = list(state.params)
        params = [state.params[n] for n in names]
        _, _, _, loss = model(q_ids, q_mask, p_ids, p_mask, gold)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for n, p, g in zip(names, params, grads)}
        return state.apply_gradients(grads), loss.detach()

    return train_step


def make_retriever_score_fn(model: Retriever) -> Callable:
    """``(q_ids, q_mask, p_ids, p_mask) -> score (B, n)``, in eval mode and
    without gradients, bound to ``model``."""

    @torch.no_grad()
    def score_fn(q_ids, q_mask, p_ids, p_mask):
        model.eval()
        return model(q_ids, q_mask, p_ids, p_mask)[2]

    return score_fn


def sort_facts_by_gold(examples: Sequence[dict]) -> List[dict]:
    """Eval data is consumed with facts sorted by gold score descending."""
    out = []
    for ex in examples:
        ex = dict(ex)
        ex["fact"] = sorted(ex["fact"], key=lambda c: -float(c.get("score", 0.0)))
        out.append(ex)
    return out


def evaluate_retriever(
    score_fn: Callable,
    dataset: ReaderDataset,
    collator: RetrieverCollator,
    batch_size: int,
    avg_topk=(1, 2, 5),
    idx_topk=(1, 2, 5),
    device: Optional[torch.device] = None,
) -> Dict[str, Any]:
    """Inversions and top-k overlap of ``score_fn``'s ranking against the
    gold order. ``score_fn`` is bound to its model
    (:func:`make_retriever_score_fn`), so there are no params to pass;
    ``device``: where the batches go, the CUDA card unless given."""
    device = resolve_device(device)
    inversions: List[int] = []
    avg: Dict[int, list] = {k: [] for k in avg_topk}
    idx: Dict[int, list] = {k: [] for k in idx_topk}
    for batch in batch_iterator(dataset, batch_size, collator, shuffle=False):
        score = score_fn(*_tensors(batch, device)).float().cpu().numpy()
        for b in range(len(score)):
            if not batch.valid[b]:
                continue
            n = int(batch.n_facts[b])
            if n < 2:
                continue
            ranking_stats(score[None, b, :n], inversions, avg, idx)
    return {
        "inversions": float(np.mean(inversions)) if inversions else 0.0,
        "avg_topk": {k: float(np.mean(v)) if v else 0.0 for k, v in avg.items()},
        "idx_topk": {k: float(np.mean(v)) if v else 0.0 for k, v in idx.items()},
        "total": len(inversions),
    }


@dataclass
class RetrieverTrainResult:
    best_inversions: float
    final_step: int
    history: List[Dict[str, float]]
    state: TrainState


def train_retriever(
    cfg: RetrieverTrainConfig,
    train_examples: Sequence[dict],
    eval_examples: Sequence[dict],
    tokenizer,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    mesh=None,
    save_checkpoints: bool = True,
    device: Optional[torch.device] = None,
) -> RetrieverTrainResult:
    """Train the retriever on ``device`` (the CUDA card unless given; it
    raises without one) for ``cfg.epochs`` epochs with early stopping on
    eval inversions. ``init_params`` is a state_dict of the port's Retriever
    (``models.bert.params_from_jax`` gives one from a JAX tree); without it
    the model is drawn by ``init_retriever`` from a generator seeded with
    ``cfg.seed``. One device takes the JAX run's global batch:
    ``per_device_batch_size`` examples a step."""
    if mesh is not None or cfg.mesh.data > 1 or cfg.mesh.model > 1 or cfg.mesh.pipe > 1:
        raise NotImplementedError("training on more than one device is not ported yet "
                                  "(ROADMAP item 12); the port trains on one device "
                                  "(mesh.data=-1 means that device)")
    logger = get_logger()
    device = resolve_device(device)
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    data_cfg = ReaderDataConfig(n_context=cfg.n_context)
    train_ds = ReaderDataset(train_examples, data_cfg, seed=cfg.seed)
    eval_ds = ReaderDataset(sort_facts_by_gold(eval_examples), data_cfg, seed=cfg.seed)
    collator = RetrieverCollator(tokenizer, cfg.n_context, cfg.retriever.question_maxlength,
                                 cfg.retriever.passage_maxlength)

    global_batch = cfg.per_device_batch_size          # one device
    steps_per_epoch = max(1, len(train_ds) // global_batch)
    total_steps = steps_per_epoch * cfg.epochs
    tx = make_optimizer(cfg.optim.replace(total_steps=total_steps,
                                          warmup_steps=max(1, int(0.06 * total_steps)),
                                          scheduler="linear"))

    model = init_retriever(cfg.retriever, torch.Generator(device=device).manual_seed(cfg.seed),
                           dtype)
    if init_params is not None:
        model.load_state_dict(init_params)
    state = TrainState.create(model_params(model), tx)
    train_step = make_retriever_train_step(model)
    score_fn = make_retriever_score_fn(model)

    best_inversions, patience, step = float("inf"), 0, 0
    history: List[Dict[str, float]] = []
    ckpt_dir = f"{cfg.checkpoint_dir}/{cfg.name}"

    def save(name: str, metric: float) -> None:
        if save_checkpoints and is_main():
            save_checkpoint(ckpt_dir, name, model.state_dict(), state.opt_state, step, metric)

    for epoch in range(1, cfg.epochs + 1):
        t0 = time.time()
        losses = []
        for batch in batch_iterator(train_ds, global_batch, collator, shuffle=True,
                                    seed=cfg.seed + epoch, drop_last=True, prefetch=2):
            gold = torch.from_numpy(batch.gold_scores).to(device)
            state, loss = train_step(state, *_tensors(batch, device), gold, cfg.seed)
            losses.append(loss)
            step += 1
        train_loss = float(torch.stack(losses).float().mean()) if losses else float("nan")

        patience += 1
        ev = evaluate_retriever(score_fn, eval_ds, collator, cfg.eval_batch_size,
                                device=device)
        inv = ev["inversions"]
        history.append({"epoch": epoch, "loss": train_loss, "inversions": inv,
                        "seconds": time.time() - t0})
        logger.info("epoch %d | step %d | loss: %.4f | inversions: %.3f | %.1fs",
                    epoch, step, train_loss, inv, time.time() - t0)
        if inv < best_inversions:
            patience = 0
            best_inversions = inv
            save("best_dev", inv)
        save("last", best_inversions)
        if patience > cfg.early_stop:
            logger.info("early stop in epoch %d", epoch)
            break

    return RetrieverTrainResult(best_inversions, step, history, state)
