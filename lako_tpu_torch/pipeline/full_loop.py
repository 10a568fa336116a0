"""The iterative reader ↔ retriever loop: the port of
lako_tpu/pipeline/full_loop.py.

Per iteration, on one device (the CUDA card unless given):
1. train the reader on the current fact-ranked data;
2. evaluate it on the train and eval data, writing the aggregated
   cross-attention scores;
3. distill the retriever from those scores (KL);
4. embed the KG corpus with the best retriever;
5. re-rank every example's candidate facts (small range);
6. evaluate retrieval hit@k; the next iteration's reader trains on the
   re-ranked data.

Every iteration records the JAX loop's ``diagnostics`` block (checkpoint
hash, per-example answer drift, train-input fact diff, hit-conditioned
reader metrics, fact-shuffle ablation, fixed-gold retriever eval), and the
files in ``--workdir`` have the JAX loop's names. The checkpoint hash is the
port's own: the JAX loop hashes ``params.msgpack``, which the port never
writes, so ``reader_ckpt_sha256`` hashes the tensors of ``params.pt``
(:func:`_params_hash`) and differs from the JAX package's value.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import torch

from lako_tpu_torch.core.config import (
    AttentionSignalConfig,
    ReaderTrainConfig,
    RetrieverTrainConfig,
    T5Config,
)
from lako_tpu_torch.core.device import resolve_device
from lako_tpu_torch.core.logging import get_logger


def _best_or_last(run_dir: Path) -> str:
    """best_dev when the metric ever improved, else the per-epoch last."""
    best = run_dir / "checkpoint" / "best_dev"
    return str(best if best.exists() else run_dir / "checkpoint" / "last")


def _params_hash(ckpt_path: str) -> Optional[str]:
    """sha256 of the checkpoint's tensors, their raw bytes in sorted-name
    order, first 16 hex characters: two iterations whose readers are
    byte-identical (a selection bug) hash equal, whatever the framing of the
    file ``torch.save`` wrote."""
    p = Path(ckpt_path) / "params.pt"
    if not p.exists():
        return None
    flat = torch.load(p, map_location="cpu", weights_only=True)
    h = hashlib.sha256()
    for name in sorted(flat):
        h.update(torch.as_tensor(flat[name]).contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def _topn_fact_ids(path: str, n: int) -> List[tuple]:
    data = json.loads(Path(path).read_text())
    return [tuple(int(f["id"]) for f in ex.get("fact", [])[:n]) for ex in data]


def _fact_diff(prev_path: str, new_path: str, n: int) -> Dict[str, float]:
    """How much did the top-n training facts actually change between
    iterations? If the re-rank barely reorders the reader's input, iteration
    N+1 trains on (nearly) the same data and cannot be expected to differ."""
    prev, new = _topn_fact_ids(prev_path, n), _topn_fact_ids(new_path, n)
    assert len(prev) == len(new), "train files changed length across iterations"
    jac, set_changed, order_changed = [], 0, 0
    for a, b in zip(prev, new):
        sa, sb = set(a), set(b)
        denom = len(sa | sb)
        jac.append(len(sa & sb) / denom if denom else 1.0)
        if sa != sb:
            set_changed += 1
        elif a != b:
            order_changed += 1
    m = len(prev) or 1
    return {
        "mean_topn_jaccard": sum(jac) / m,
        "frac_fact_set_changed": set_changed / m,
        "frac_order_only_changed": order_changed / m,
    }


def _hit_conditioned(rows: Sequence[dict], n_context: int) -> Dict[str, Any]:
    """Reader metrics sliced by whether the answer is present (include-EM)
    in the top-n facts the reader actually saw. The loop's mechanism —
    better retrieval → better reader — can only show up on the hit slice."""
    from lako_tpu_torch.text.metrics import includ_ems

    hit_em, hit_inc, miss_em, miss_inc = [], [], [], []
    for r in rows:
        gold = r["real answers"]
        hit = any(includ_ems(f["sentence"], gold) >= 1.0
                  for f in r.get("fact", [])[:n_context])
        (hit_em if hit else miss_em).append(r["score"])
        (hit_inc if hit else miss_inc).append(r["include_score"])

    def _mean(v):
        return sum(v) / len(v) if v else None

    return {
        "n_hit": len(hit_em), "n_miss": len(miss_em),
        "em_hit": _mean(hit_em), "em_miss": _mean(miss_em),
        "include_hit": _mean(hit_inc), "include_miss": _mean(miss_inc),
    }


def _answers_changed(prev_rows: Sequence[dict],
                     rows: Sequence[dict]) -> Dict[str, float]:
    changed = sum(1 for a, b in zip(prev_rows, rows)
                  if a["answer"] != b["answer"])
    n = max(1, min(len(prev_rows), len(rows)))
    return {"frac_answers_changed": changed / n, "n": n}


def run_full_loop(args) -> Dict[str, Any]:
    """The loop of the JAX ``full-loop`` subcommand over ``args`` (its
    flags' names), on ``args.device`` (the CUDA card when absent or None;
    without a card it raises)."""
    from lako_tpu_torch.pipeline.stages import (
        embed_facts_stage,
        eval_facts_stage,
        eval_reader_stage,
        eval_retriever_stage,
        rerank_stage,
        train_reader_stage,
        train_retriever_stage,
    )
    from lako_tpu_torch.text.tokenizer import load_tokenizer

    device = resolve_device(getattr(args, "device", None))
    logger = get_logger()
    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)

    def _cfg(cls, path):
        if path is None:
            return cls()
        return cls.from_dict(json.loads(Path(path).read_text()))

    reader_cfg: ReaderTrainConfig = _cfg(ReaderTrainConfig, args.reader_config)
    retr_cfg: RetrieverTrainConfig = _cfg(RetrieverTrainConfig, args.retriever_config)
    t5_cfg = (T5Config.from_dict(json.loads(Path(args.t5_config).read_text()))
              if args.t5_config else None)
    tok = load_tokenizer(args.tokenizer)
    btok = load_tokenizer(args.bert_tokenizer, style="bert")

    train_data, eval_data = args.train_data, args.eval_data
    history = []
    prev_reader_ckpt = getattr(args, "reader_init", None)
    fact_ablation = getattr(args, "fact_ablation", False)
    prev_train_data: Optional[str] = None
    prev_answer_rows: Optional[list] = None
    first_scored_eval: Optional[str] = None  # iteration 1's gold order
    for it in range(1, args.iterations + 1):
        version = f"v{it}"
        logger.info("=== full-loop iteration %s ===", version)
        it_reader_cfg = reader_cfg.replace(
            checkpoint_dir=str(workdir), name=f"reader_{version}")
        it_retr_cfg = retr_cfg.replace(
            checkpoint_dir=str(workdir), name=f"retriever_{version}",
            n_context=reader_cfg.data.n_context)

        # 1. reader training. --warm-start-reader chains iterations (each
        # reader continues from the previous iteration's best — the
        # reference's load_path warm start, run_okvqa_train_full.sh:43-44);
        # otherwise every iteration starts from --reader-init when given
        # (the reference's model_path base: each iteration's reader begins
        # from the SAME pretrained t5 weights) or from scratch.
        if getattr(args, "warm_start_reader", False) and it > 1:
            init_path = prev_reader_ckpt
        else:
            init_path = getattr(args, "reader_init", None)
        reader_out = train_reader_stage(it_reader_cfg, train_data, eval_data, tok,
                                        t5_config=t5_cfg,
                                        init_params_path=init_path, device=device)
        reader_ckpt = _best_or_last(workdir / f"reader_{version}")
        prev_reader_ckpt = reader_ckpt

        # 2. attention generate on both splits
        signal_cfg = AttentionSignalConfig(
            attention_score_style=args.attention_score_style,
            use_last_half_layer_attention=args.use_last_half_layer_attention,
            ans_attention=args.ans_attention,
            stream=reader_cfg.data.stream,
            n_context=reader_cfg.data.n_context,
        )
        scored_train = str(workdir / f"train_scored_{version}.json")
        scored_eval = str(workdir / f"eval_scored_{version}.json")
        answers_path = str(workdir / f"eval_answers_{version}.json")
        eval_reader_stage(it_reader_cfg, signal_cfg, train_data, reader_ckpt, tok,
                          t5_config=t5_cfg,
                          write_crossattention_scores=scored_train, device=device)
        eval_metrics = eval_reader_stage(
            it_reader_cfg, signal_cfg, eval_data, reader_ckpt, tok,
            t5_config=t5_cfg, write_crossattention_scores=scored_eval,
            write_results=answers_path, device=device)
        if first_scored_eval is None:
            first_scored_eval = scored_eval

        # -- diagnostics: make cross-iteration reader claims checkable -------
        answer_rows = json.loads(Path(answers_path).read_text())
        diag: Dict[str, Any] = {
            "reader_ckpt": reader_ckpt,
            "reader_ckpt_sha256": _params_hash(reader_ckpt),
            "hit_conditioned": _hit_conditioned(
                answer_rows, reader_cfg.data.n_context),
        }
        if prev_train_data is not None:
            diag["train_fact_diff_vs_prev"] = _fact_diff(
                prev_train_data, train_data, reader_cfg.data.n_context)
        if prev_answer_rows is not None:
            diag["answers_vs_prev"] = _answers_changed(prev_answer_rows,
                                                       answer_rows)
        if fact_ablation:
            # fact-shuffle ablation: evaluate the SAME checkpoint with each
            # example's facts replaced by its neighbor's. If EM does not
            # drop, the reader is fact-blind and NO retrieval improvement
            # can move reader metrics — the mechanical root-cause test.
            eval_examples = json.loads(Path(eval_data).read_text())
            rotated = [dict(ex) for ex in eval_examples]
            facts = [ex.get("fact", []) for ex in eval_examples]
            for i, ex in enumerate(rotated):
                ex["fact"] = facts[(i + 1) % len(facts)]
            shuf_path = workdir / f"eval_factshuffle_{version}.json"
            shuf_path.write_text(json.dumps(rotated))
            shuf_metrics = eval_reader_stage(
                it_reader_cfg, signal_cfg, str(shuf_path), reader_ckpt, tok,
                t5_config=t5_cfg, device=device)
            diag["fact_shuffle_ablation"] = {
                "em": shuf_metrics["em"],
                "include_em": shuf_metrics["include_em"],
                "em_delta_vs_true_facts": eval_metrics["em"]
                - shuf_metrics["em"],
            }
        prev_answer_rows = answer_rows

        # 3. retriever distillation
        retr_out = train_retriever_stage(it_retr_cfg, scored_train, scored_eval, btok,
                                         device=device)
        retr_ckpt = _best_or_last(workdir / f"retriever_{version}")
        # Fixed-gold retriever eval: inversions against iteration 1's gold
        # order. The in-training eval above scores iteration N's retriever
        # against iteration N's reader attention — a DIFFERENT gold each
        # iteration, so those numbers are not comparable across N; this one,
        # evaluated on the same file every iteration, is.
        retr_fixed_gold = eval_retriever_stage(
            it_retr_cfg, first_scored_eval, retr_ckpt, btok, device=device)
        diag["retriever_inversions_vs_v1_gold"] = retr_fixed_gold["inversions"]

        # 4. corpus embedding
        index_path = str(workdir / f"fact_index_{version}")
        embed_facts_stage(it_retr_cfg.retriever, retr_ckpt, args.corpus,
                          index_path, btok, device=device)

        # 5. small-range re-rank both splits
        new_train = str(workdir / f"train_reranked_{version}.json")
        new_eval = str(workdir / f"eval_reranked_{version}.json")
        rerank_stage(it_retr_cfg.retriever, retr_ckpt, index_path, args.corpus,
                     [train_data, eval_data], [new_train, new_eval], btok,
                     device=device)

        # 6. retrieval quality
        n_facts_available = max(reader_cfg.data.n_context, 1)
        fact_metrics = eval_facts_stage(
            new_eval, hitk=[k for k in (1, 2, 5, 10, 20, 50, 100, 200, 500)
                            if k <= max(n_facts_available, 5)] or [1])

        history.append({
            "iteration": version,
            "reader_best_em": reader_out["best_dev_em"],
            "eval": eval_metrics,
            # NOT comparable across iterations (gold = this iteration's
            # reader attention); use diagnostics.retriever_inversions_vs_
            # v1_gold for cross-iteration comparison
            "retriever_best_inversions": retr_out["best_inversions"],
            "hit_at_k_include": fact_metrics["include"],
            "diagnostics": diag,
        })
        prev_train_data = train_data
        train_data, eval_data = new_train, new_eval

    (workdir / "full_loop_history.json").write_text(json.dumps(history, indent=2))
    return {"iterations": len(history), "history": history}
