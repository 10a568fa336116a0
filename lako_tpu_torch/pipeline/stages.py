"""The reader's pipeline stages: the port of ``train_reader_stage`` and
``eval_reader_stage`` from lako_tpu/pipeline/stages.py, over the same JSON
schemas, so that the artifacts are drop-in compatible:

reader example: {question, target, answer: {str: float}, img_id, caption,
                 fact: [{sentence, id, score?}]}

``train_reader_stage`` trains the reader (with checkpoints); then
``eval_reader_stage`` scores it and, with ``write_crossattention_scores``,
writes the examples with a ``score`` on each fact: the retriever distills
from those. The retriever stages wait for ROADMAP items 7 and 8, warm starts
from an HF ``save_pretrained`` directory for item 9, and runs of more than
one process for item 12.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from lako_tpu_torch.core.checkpoint import load_checkpoint
from lako_tpu_torch.core.config import (
    AttentionSignalConfig,
    ReaderTrainConfig,
    T5Config,
    t5_config_for_size,
)
from lako_tpu_torch.core.device import resolve_device
from lako_tpu_torch.core.distributed import process_count
from lako_tpu_torch.core.logging import get_logger
from lako_tpu_torch.data import ReaderCollator, ReaderDataset, batch_iterator
from lako_tpu_torch.models.t5 import FiDT5, init_fid_t5
from lako_tpu_torch.models.t5.decode import make_best_generate_fn, make_generate_and_score_fn
from lako_tpu_torch.signal import apply_ans_attention_bonus, attach_scores_to_examples
from lako_tpu_torch.text.metrics import ems, includ_ems, stem_ems
from lako_tpu_torch.train.reader import train_reader

Device = Optional[Union[str, torch.device]]

# the files that make a directory an HF save_pretrained checkpoint
_HF_WEIGHTS = ("model.safetensors", "model.safetensors.index.json", "pytorch_model.bin",
               "pytorch_model.bin.index.json")


def _load_json(path: str):
    return json.loads(Path(path).read_text())


def _save_json(obj, path: str):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(obj))


def is_hf_checkpoint_dir(path: str) -> bool:
    """A copy of lako_tpu/models/hf_io.py's test for an HF checkpoint."""
    p = Path(path)
    if not (p / "config.json").exists():
        return False
    return any((p / f).exists() for f in _HF_WEIGHTS)


def _refuse_unported(model_path: Optional[str]) -> None:
    if process_count() > 1:
        raise NotImplementedError("the reader stages run in one process; more than one "
                                  "is not ported yet (ROADMAP item 12)")
    if model_path and is_hf_checkpoint_dir(model_path):
        raise NotImplementedError(f"{model_path} is an HF checkpoint directory; loading one "
                                  "is not ported yet (ROADMAP item 9)")


def _init_reader(t5_cfg: T5Config, device: torch.device,
                 dtype: torch.dtype = torch.float32) -> FiDT5:
    """The reader whose state_dict is the template of the port's checkpoints."""
    return init_fid_t5(t5_cfg, torch.Generator(device=device).manual_seed(0), dtype)


def train_reader_stage(
    cfg: ReaderTrainConfig,
    train_data: str,
    eval_data: str,
    tokenizer,
    t5_config: Optional[T5Config] = None,
    init_params_path: Optional[str] = None,
    maxload: int = -1,
    device: Device = None,
) -> Dict[str, Any]:
    """Train the reader on ``device`` (the card unless given), warm-started
    from the port's checkpoint at ``init_params_path`` if given."""
    _refuse_unported(init_params_path)
    device = resolve_device(device)
    train_examples = _load_json(train_data)
    eval_examples = _load_json(eval_data)
    if maxload > 0:  # small-data mode
        train_examples = train_examples[:maxload]
        eval_examples = eval_examples[:maxload]
    t5_cfg = t5_config or t5_config_for_size(cfg.model_size, vocab_size=tokenizer.vocab_size)
    init_params = None
    if init_params_path:
        template = _init_reader(t5_cfg, device).state_dict()
        init_params = load_checkpoint(init_params_path, template)[0]
        del template
    result = train_reader(cfg, train_examples, eval_examples, tokenizer,
                          init_params=init_params, t5_config=t5_cfg, device=device)
    return {"best_dev_em": result.best_dev_em, "steps": result.final_step,
            "history": result.history}


def eval_reader_stage(
    cfg: ReaderTrainConfig,
    signal_cfg: AttentionSignalConfig,
    eval_data: str,
    model_path: str,
    tokenizer,
    t5_config: Optional[T5Config] = None,
    write_results: Optional[str] = None,
    write_crossattention_scores: Optional[str] = None,
    num_beams: int = 1,
    device: Device = None,
) -> Dict[str, Any]:
    """Evaluate EM / include-EM / stem-EM on ``device`` (the card unless
    given) and optionally write the per-example results and the scored
    dataset for retriever distillation. ``num_beams > 1`` decodes with beam
    search; score writing needs greedy decode."""
    _refuse_unported(model_path)
    device = resolve_device(device)
    logger = get_logger()
    examples = _load_json(eval_data)
    t5_cfg = t5_config or t5_config_for_size(cfg.model_size, vocab_size=tokenizer.vocab_size)
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    model = _init_reader(t5_cfg, device, dtype)
    model.load_state_dict(load_checkpoint(model_path, model.state_dict())[0])

    collect = write_crossattention_scores is not None
    knobs = dict(max_length=cfg.eval_max_length, backend=cfg.decode_backend,
                 kv_dtype=cfg.decode_kv_dtype, weights_dtype=cfg.decode_weights_dtype,
                 chunk_size=cfg.decode_chunk_size)
    if num_beams > 1:
        if collect:
            raise ValueError("cross-attention score writing requires greedy decode")
        generate_fn = make_best_generate_fn(model, num_beams=num_beams,
                                            self_attn_impl=cfg.decode_self_attn_impl, **knobs)
    elif collect:
        generate_score_fn = make_generate_and_score_fn(model, signal_cfg, **knobs)
    else:
        generate_fn = make_best_generate_fn(model, collect_cross_scores=False, **knobs)

    ds = ReaderDataset(examples, cfg.data, seed=cfg.seed)
    collator = ReaderCollator(cfg.data, tokenizer)

    em_scores, inc_scores, stem_scores = [], [], []
    results_json: List[dict] = []
    t0 = time.time()
    n_decoded = 0
    for batch in batch_iterator(ds, cfg.eval_batch_size, collator, shuffle=False):
        ids = torch.from_numpy(batch.passage_ids).to(device)
        mask = torch.from_numpy(batch.passage_mask).to(device)
        if collect:
            tokens, raw = generate_score_fn(ids, mask,
                                            torch.from_numpy(batch.fact_spans).to(device))
            batch_examples = [ds.get_example(int(i)) for i in batch.index]
            scores = apply_ans_attention_bonus(raw.cpu().numpy(), batch_examples,
                                               signal_cfg.n_context, signal_cfg.ans_attention)
        else:
            tokens, _ = generate_fn(ids, mask)
        decoded = tokenizer.batch_decode(tokens.cpu().numpy())
        for k, ans in enumerate(decoded):
            if not batch.valid[k]:
                continue
            example = ds.get_example(int(batch.index[k]))
            gold = example["answer"]
            em = ems(ans, gold)
            inc = includ_ems(ans, gold)
            st = stem_ems(ans, gold, dele_sw=True)
            em_scores.append(em)
            inc_scores.append(inc)
            stem_scores.append(st)
            n_decoded += 1
            if write_results is not None:
                results_json.append({
                    "question": example["question"],
                    "img_id": example["img_id"],
                    "answer": ans,
                    "target": example.get("target"),
                    "real answers": gold,
                    "fact": example.get("fact", [])[:50],
                    "include_score": inc,
                    "score": em,
                    "stem_score": st,
                })
            if collect:
                attach_scores_to_examples([example], scores[k:k + 1], signal_cfg.n_context)

    metrics = {
        "em": float(np.mean(em_scores)) if em_scores else 0.0,
        "include_em": float(np.mean(inc_scores)) if inc_scores else 0.0,
        "stem_em": float(np.mean(stem_scores)) if stem_scores else 0.0,
        "total": n_decoded,
        "answers_per_sec": n_decoded / max(time.time() - t0, 1e-9),
    }
    logger.info("evaluation: %.2fEM | include: %.2fEM | stem: %.2fEM | total %d",
                100 * metrics["em"], 100 * metrics["include_em"],
                100 * metrics["stem_em"], n_decoded)
    if write_results is not None:
        _save_json(results_json, write_results)
    if write_crossattention_scores is not None:
        _save_json(examples, write_crossattention_scores)
    return metrics
