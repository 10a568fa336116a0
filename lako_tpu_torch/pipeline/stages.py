"""The pipeline stages: the port of lako_tpu/pipeline/stages.py, over the same
JSON schemas, so that the artifacts are drop-in compatible:

reader example: {question, target, answer: {str: float}, img_id, caption,
                 fact: [{sentence, id, score?}]}
corpus row:     {sentence, id}

``train_reader_stage`` → ``eval_reader_stage`` (with
``write_crossattention_scores``: each fact gets a ``score``) →
``train_retriever_stage`` (distills from those scores) →
``embed_facts_stage`` (a DenseIndex directory) → ``retrieve_stage`` /
``rerank_stage`` → ``eval_facts_stage``. Every stage runs on the CUDA card
unless given a device. The reader stages also take an HF
``save_pretrained`` directory (models/hf_io.py) for their weights, with
its architecture; runs of more than one process or a corpus sharded over
devices wait for ROADMAP item 12.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from lako_tpu_torch.core.checkpoint import load_checkpoint
from lako_tpu_torch.core.config import (
    AttentionSignalConfig,
    ReaderDataConfig,
    ReaderTrainConfig,
    RetrieverConfig,
    RetrieverTrainConfig,
    T5Config,
    t5_config_for_size,
)
from lako_tpu_torch.core.device import resolve_device
from lako_tpu_torch.core.distributed import process_count
from lako_tpu_torch.core.logging import get_logger
from lako_tpu_torch.data import ReaderCollator, ReaderDataset, RetrieverCollator, batch_iterator
from lako_tpu_torch.models.bert import init_retriever
from lako_tpu_torch.models.hf_io import hf_t5_and_state, is_hf_checkpoint_dir
from lako_tpu_torch.models.retriever import Retriever
from lako_tpu_torch.models.t5 import FiDT5, init_fid_t5
from lako_tpu_torch.models.t5.decode import make_best_generate_fn, make_generate_and_score_fn
from lako_tpu_torch.retrieval.embed import embed_corpus, embed_questions
from lako_tpu_torch.retrieval.eval import hit_at_k
from lako_tpu_torch.retrieval.index import DenseIndex, add_facts_to_examples
from lako_tpu_torch.retrieval.pq import PQIndex
from lako_tpu_torch.signal import apply_ans_attention_bonus, attach_scores_to_examples
from lako_tpu_torch.text.metrics import ems, includ_ems, stem_ems
from lako_tpu_torch.train.reader import train_reader
from lako_tpu_torch.train.retriever import (
    evaluate_retriever,
    make_retriever_score_fn,
    sort_facts_by_gold,
    train_retriever,
)

Device = Optional[Union[str, torch.device]]

def _load_json(path: str):
    return json.loads(Path(path).read_text())


def _save_json(obj, path: str):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(obj))


def _refuse_unported() -> None:
    if process_count() > 1:
        raise NotImplementedError("the stages run in one process; more than one "
                                  "is not ported yet (ROADMAP item 12)")


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
    from ``init_params_path`` if given: the port's checkpoint, or an HF
    save_pretrained directory, whose config.json then gives the architecture
    (``t5_config`` only its kernel route: models/hf_io.py
    ``hf_t5_and_state``)."""
    _refuse_unported()
    device = resolve_device(device)
    train_examples = _load_json(train_data)
    eval_examples = _load_json(eval_data)
    if maxload > 0:  # small-data mode
        train_examples = train_examples[:maxload]
        eval_examples = eval_examples[:maxload]
    t5_cfg = t5_config or t5_config_for_size(cfg.model_size, vocab_size=tokenizer.vocab_size)
    init_params = None
    if init_params_path and is_hf_checkpoint_dir(init_params_path):
        # the reference's load_t5 path (src/model.py:79-82, train_reader.py:243-250)
        t5_cfg, init_params = hf_t5_and_state(init_params_path, t5_config)
    elif init_params_path:
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
    dataset for retriever distillation. ``model_path`` is the port's
    checkpoint or an HF save_pretrained directory, as in
    :func:`train_reader_stage`. ``num_beams > 1`` decodes with beam search;
    score writing needs greedy decode."""
    _refuse_unported()
    device = resolve_device(device)
    logger = get_logger()
    examples = _load_json(eval_data)
    t5_cfg = t5_config or t5_config_for_size(cfg.model_size, vocab_size=tokenizer.vocab_size)
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if is_hf_checkpoint_dir(model_path):
        t5_cfg, params = hf_t5_and_state(model_path, t5_config)
        model = _init_reader(t5_cfg, device, dtype)
    else:
        model = _init_reader(t5_cfg, device, dtype)
        params = load_checkpoint(model_path, model.state_dict())[0]
    model.load_state_dict(params)
    del params

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


# ---------------------------------------------------------------------------
# Retriever stages
# ---------------------------------------------------------------------------


def train_retriever_stage(
    cfg: RetrieverTrainConfig,
    train_data: str,
    eval_data: str,
    tokenizer,
    device: Device = None,
) -> Dict[str, Any]:
    """Distill the retriever from the scored data on ``device`` (the card
    unless given)."""
    _refuse_unported()
    result = train_retriever(cfg, _load_json(train_data), _load_json(eval_data), tokenizer,
                             device=resolve_device(device))
    return {"best_inversions": result.best_inversions, "steps": result.final_step,
            "history": result.history}


def eval_retriever_stage(
    cfg: RetrieverTrainConfig,
    data_path: str,
    model_path: str,
    tokenizer,
    device: Device = None,
) -> Dict[str, Any]:
    """Ranking eval (inversions + top-k overlap) of a checkpoint on a
    scored data file, so that retrievers of different iterations can be
    compared against one gold order."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    model = _load_retriever(cfg.retriever, model_path, dtype=dtype, device=device)
    ds = ReaderDataset(sort_facts_by_gold(_load_json(data_path)),
                       ReaderDataConfig(n_context=cfg.n_context), seed=cfg.seed)
    collator = RetrieverCollator(tokenizer, cfg.n_context, cfg.retriever.question_maxlength,
                                 cfg.retriever.passage_maxlength)
    return evaluate_retriever(make_retriever_score_fn(model), ds, collator,
                              cfg.eval_batch_size, device=device)


def _load_retriever(cfg: RetrieverConfig, model_path: str, dtype: torch.dtype = torch.float32,
                    device: Device = None) -> Retriever:
    """The Retriever of the port's checkpoint at ``model_path`` (its
    ``params.pt``) on ``device``, in eval mode."""
    _refuse_unported()
    device = resolve_device(device)
    model = init_retriever(cfg, torch.Generator(device=device).manual_seed(0), dtype)
    model.load_state_dict(load_checkpoint(model_path, model.state_dict())[0])
    return model


def embed_facts_stage(
    retriever_cfg: RetrieverConfig,
    model_path: str,
    corpus_path: str,        # [{sentence, id}]
    out_path: str,
    tokenizer,
    batch_size: int = 512,
    maxlength: Optional[int] = None,
    device: Device = None,
) -> Dict[str, Any]:
    """Embed the whole KG corpus in float32 into a DenseIndex directory.
    ``maxlength`` defaults to the retriever's trained passage_maxlength."""
    device = resolve_device(device)
    corpus = _load_json(corpus_path)
    model = _load_retriever(retriever_cfg, model_path, device=device)
    ids, emb = embed_corpus(model, corpus, tokenizer, batch_size=batch_size,
                            maxlength=maxlength)
    DenseIndex(emb, ids, device=device).save(out_path)
    return {"n_facts": len(ids), "dim": emb.shape[1], "index_path": out_path}


def _sampled_file_digest(path: Path, sample_bytes: int = 4 << 20,
                         stride: int = 256 << 10, piece: int = 4 << 10) -> str:
    """Content fingerprint: the first and last ``sample_bytes`` of a file
    and, between them, ``piece`` bytes every ``stride``.

    The JAX package hashes the head and tail only (a reference fault: an
    embeddings file rewritten in its interior keeps its fingerprint). The
    strided pieces catch any change that spans ``stride`` bytes, for about
    1/64 more reading; mtime is not used, so a same-size rewrite within one
    mtime tick invalidates and a byte-identical copy does not."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    size = path.stat().st_size
    with path.open("rb") as f:
        h.update(f.read(sample_bytes))
        tail = max(sample_bytes, size - sample_bytes)
        for offset in range(sample_bytes, tail, stride):
            f.seek(offset)
            h.update(f.read(min(piece, tail - offset)))
        if size > sample_bytes:
            f.seek(tail)
            h.update(f.read(sample_bytes))
    return h.hexdigest()


def _load_or_train_pq(index_path: str, n_subquantizers: int = 32, n_bits: int = 8,
                      device: Device = None) -> PQIndex:
    """PQ view of a dense index directory: codes live in ``<index_path>/pq``,
    trained once from ``embeddings.npy`` on first use and reused after. The
    cache records a fingerprint of the embeddings file; a changed file
    retrains the codes. A dimension not divisible by ``n_subquantizers``
    takes the largest power-of-two count that divides it."""
    emb_path = Path(index_path) / "embeddings.npy"
    pq_dir = Path(index_path) / "pq"
    src_meta = pq_dir / "source.json"
    have_cache = (pq_dir / "meta.json").exists()
    if not emb_path.exists():
        # a PQ-only index directory: the cache is the only source, its
        # staleness unverifiable
        if have_cache:
            return PQIndex.load(str(pq_dir), device=device)
        raise FileNotFoundError(f"{emb_path} is missing and {pq_dir} holds no trained codes; "
                                "run embed-facts first")
    fingerprint = {"size": emb_path.stat().st_size, "content": _sampled_file_digest(emb_path),
                   "n_subquantizers": n_subquantizers, "n_bits": n_bits}
    if have_cache:
        try:
            cached = json.loads(src_meta.read_text())
        except (OSError, json.JSONDecodeError):
            cached = None  # a missing or torn fingerprint is stale, not fatal
        if cached == fingerprint:
            return PQIndex.load(str(pq_dir), device=device)
        get_logger().info("PQ cache at %s is stale (embeddings.npy changed since codes were "
                          "trained) — retraining", pq_dir)
    emb = np.load(emb_path)
    ids = np.load(Path(index_path) / "ids.npy")
    m = n_subquantizers
    while m > 1 and emb.shape[1] % m:
        m //= 2
    pq = PQIndex.train(emb, n_subquantizers=m, n_bits=n_bits, ids=ids, device=device)
    pq.save(str(pq_dir))
    src_meta.write_text(json.dumps(fingerprint))
    get_logger().info("trained PQ-%dx%d over %d×%d: %.1f MB → %.2f MB", m, n_bits,
                      emb.shape[0], emb.shape[1], emb.nbytes / 1e6, pq.nbytes() / 1e6)
    return pq


def retrieve_stage(
    retriever_cfg: RetrieverConfig,
    model_path: str,
    index_path: str,
    corpus_path: str,
    data_paths: Sequence[str],
    out_paths: Sequence[str],
    tokenizer,
    n_docs: int = 500,
    sharded: bool = False,
    index_method: str = "exact",
    device: Device = None,
) -> Dict[str, Any]:
    """Full-corpus dense retrieval. ``index_method``: "exact" (float32
    scores) | "fast" (bfloat16 inputs on the card) | "approx" (the same as
    "fast" off the TPU) | "pq" (the product quantizer, trained once from the
    dense index directory and cached in ``<index_path>/pq``). ``sharded``
    raises: a corpus over devices is ROADMAP item 12."""
    if sharded:
        raise NotImplementedError("--sharded-index (the corpus sharded over devices) is not "
                                  "ported yet (ROADMAP item 12)")
    device = resolve_device(device)
    corpus = _load_json(corpus_path)
    id_to_sentence = {int(r["id"]): r["sentence"] for r in corpus}
    if n_docs > len(corpus):
        get_logger().warning("retrieve: n_docs=%d > corpus size %d; retrieving every fact",
                             n_docs, len(corpus))
        n_docs = len(corpus)
    if index_method == "pq":
        index = _load_or_train_pq(index_path, device=device)
    else:
        index = DenseIndex.load(index_path, method=index_method, device=device)
    model = _load_retriever(retriever_cfg, model_path, device=device)
    stats = {}
    for data_path, out_path in zip(data_paths, out_paths):
        examples = _load_json(data_path)
        q_emb = embed_questions(model, examples, tokenizer)
        ids, scores = index.search(q_emb, k=n_docs)
        add_facts_to_examples(examples, ids, scores, id_to_sentence)
        _save_json(examples, out_path)
        stats[data_path] = len(examples)
    return {"retrieved": stats, "n_docs": n_docs}


def rerank_stage(
    retriever_cfg: RetrieverConfig,
    model_path: str,
    index_path: str,
    corpus_path: str,
    data_paths: Sequence[str],
    out_paths: Sequence[str],
    tokenizer,
    device: Device = None,
) -> Dict[str, Any]:
    """Small-range re-rank of each example's existing candidate facts.
    Examples are grouped by candidate count, one batched call a group."""
    device = resolve_device(device)
    corpus = _load_json(corpus_path)
    id_to_sentence = {int(r["id"]): r["sentence"] for r in corpus}
    index = DenseIndex.load(index_path, device=device)
    model = _load_retriever(retriever_cfg, model_path, device=device)
    stats = {}
    for data_path, out_path in zip(data_paths, out_paths):
        examples = _load_json(data_path)
        q_emb = embed_questions(model, examples, tokenizer)
        groups: Dict[int, list] = {}
        for i, ex in enumerate(examples):
            groups.setdefault(len(ex["fact"]), []).append(i)
        for count, rows in groups.items():
            if count == 0:
                continue
            cand = np.asarray([[int(f["id"]) for f in examples[i]["fact"]] for i in rows],
                              dtype=np.int64)
            ids, scores = index.rerank(cand, q_emb[np.asarray(rows)])
            for r, row_ids, row_scores in zip(rows, ids, scores):
                examples[r]["fact"] = [
                    {"sentence": id_to_sentence[int(fid)], "id": int(fid), "score": float(s)}
                    for fid, s in zip(row_ids, row_scores)
                ]
        _save_json(examples, out_path)
        stats[data_path] = len(examples)
    return {"reranked": stats}


def eval_facts_stage(data_path: str, hitk=None) -> Dict[str, Any]:
    """Retrieval hit@k."""
    logger = get_logger()
    data = _load_json(data_path)
    kwargs = {"hitk": hitk} if hitk else {}
    inc, stem = hit_at_k(data, **kwargs)
    for k in sorted(inc):
        logger.info("top %d facts hits %.2f | stem %.2f", k, 100 * inc[k], 100 * stem[k])
    return {"include": inc, "stem": stem}
