"""lako on PyTorch: the port of lako_tpu/pipeline/cli.py.

Usage: python -m lako_tpu_torch.pipeline <subcommand> ...

Every subcommand of the JAX CLI, with its flags, its typed JSON configs and
its JSON artifacts in the JAX package's schemas. The ones that run a model
(``train-reader``, ``eval-reader``, ``train-retriever``, ``embed-facts``,
``retrieve``, ``serve`` and ``full-loop``) also take ``--device``: the CUDA
card unless given, ``--device cpu`` for the CPU. ``build-tokenizer``,
``eval-facts`` and the data preparation (``mine-candidates``,
``prep-answers``, ``truncate-data``, ``prep-questions``) run on the host.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from lako_tpu_torch.core.config import (
    AttentionSignalConfig,
    ReaderTrainConfig,
    RetrieverTrainConfig,
    T5Config,
)
from lako_tpu_torch.core.logging import init_logger

# the JAX CLI's options the port refuses, by the ROADMAP item that ports each
_NOT_PORTED = """\
not ported yet (ROADMAP item): retrieve --sharded-index (12); serve
--mesh-model > 1 (11)"""


def _load_cfg(cls, path):
    if path is None:
        return cls()
    return cls.from_dict(json.loads(Path(path).read_text()))


def _tokenizer(path: str, style: str = "t5"):
    from lako_tpu_torch.text.tokenizer import load_tokenizer

    return load_tokenizer(path, style=style)


def _t5_cfg(args):
    if getattr(args, "t5_config", None):
        return T5Config.from_dict(json.loads(Path(args.t5_config).read_text()))
    return None


def cmd_build_tokenizer(args):
    from lako_tpu_torch.text.tokenizer import HFTokenizer, WordVocabTokenizer

    corpus = []
    for p in args.from_json or []:
        data = json.loads(Path(p).read_text())
        for ex in data:
            if "sentence" in ex:
                corpus.append(ex["sentence"])
                continue
            corpus.append(ex.get("question", ""))
            corpus.append(ex.get("caption", ""))
            corpus.extend(f["sentence"] for f in ex.get("fact", []))
            corpus.extend(ex.get("answer", {}).keys())
    for p in args.from_text or []:
        corpus.extend(Path(p).read_text().splitlines())
    corpus = [c for c in corpus if c]
    # prefixes must be in-vocab
    corpus += ["question: context: fact:"] * 5
    if args.kind == "word":
        tok = WordVocabTokenizer.build(corpus, style=args.style, max_vocab=args.vocab_size)
    elif args.kind == "unigram":
        tok = HFTokenizer.train_unigram(corpus, vocab_size=args.vocab_size)
    else:
        tok = HFTokenizer.train_wordpiece(corpus, vocab_size=args.vocab_size)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    tok.save(args.out)
    print(json.dumps({"vocab_size": tok.vocab_size, "out": args.out}))


def cmd_train_reader(args):
    from lako_tpu_torch.pipeline.stages import train_reader_stage

    cfg = _load_cfg(ReaderTrainConfig, args.config)
    tok = _tokenizer(args.tokenizer)
    out = train_reader_stage(cfg, args.train_data, args.eval_data, tok,
                             t5_config=_t5_cfg(args), init_params_path=args.model_path,
                             maxload=args.maxload, device=args.device)
    print(json.dumps(out))


def cmd_eval_reader(args):
    from lako_tpu_torch.pipeline.stages import eval_reader_stage

    cfg = _load_cfg(ReaderTrainConfig, args.config)
    signal_cfg = AttentionSignalConfig(
        attention_score_style=args.attention_score_style,
        use_last_half_layer_attention=args.use_last_half_layer_attention,
        ans_attention=args.ans_attention,
        stream=cfg.data.stream,
        n_context=cfg.data.n_context,
    )
    tok = _tokenizer(args.tokenizer)
    out = eval_reader_stage(
        cfg, signal_cfg, args.eval_data, args.model_path, tok,
        t5_config=_t5_cfg(args),
        write_results=args.write_results,
        write_crossattention_scores=args.write_crossattention_scores,
        num_beams=args.num_beams,
        device=args.device,
    )
    print(json.dumps(out))


def cmd_train_retriever(args):
    from lako_tpu_torch.pipeline.stages import train_retriever_stage

    cfg = _load_cfg(RetrieverTrainConfig, args.config)
    tok = _tokenizer(args.tokenizer, style="bert")
    out = train_retriever_stage(cfg, args.train_data, args.eval_data, tok, device=args.device)
    print(json.dumps(out))


def cmd_embed_facts(args):
    from lako_tpu_torch.pipeline.stages import embed_facts_stage

    cfg = _load_cfg(RetrieverTrainConfig, args.config).retriever
    tok = _tokenizer(args.tokenizer, style="bert")
    out = embed_facts_stage(cfg, args.model_path, args.corpus, args.out, tok,
                            batch_size=args.batch_size, device=args.device)
    print(json.dumps(out))


def cmd_retrieve(args):
    from lako_tpu_torch.pipeline.stages import rerank_stage, retrieve_stage

    cfg = _load_cfg(RetrieverTrainConfig, args.config).retriever
    tok = _tokenizer(args.tokenizer, style="bert")
    fn = rerank_stage if args.small_range else retrieve_stage
    kwargs = {} if args.small_range else {"n_docs": args.n_docs,
                                          "sharded": args.sharded_index,
                                          "index_method": args.index_method}
    out = fn(cfg, args.model_path, args.index, args.corpus, args.data, args.out, tok,
             device=args.device, **kwargs)
    print(json.dumps(out))


def cmd_eval_facts(args):
    from lako_tpu_torch.pipeline.stages import eval_facts_stage

    out = eval_facts_stage(args.data, hitk=args.hitk)
    print(json.dumps(out))


def cmd_mine_candidates(args):
    from lako_tpu_torch.retrieval.candidates import CandidateMiner
    from lako_tpu_torch.retrieval.verbalize import verbalize_triples

    triples = json.loads(Path(args.triples).read_text())
    if isinstance(triples, dict):  # the original LaKo triplestemindex_database format
        triples = [triples[k] for k in sorted(triples, key=lambda x: int(x))]
    templates = json.loads(Path(args.templates).read_text()) if args.templates else {}
    four_tuple = verbalize_triples(triples, templates)
    if args.corpus_out:
        corpus = [{"sentence": t[3] + ".", "id": i} for i, t in enumerate(four_tuple)]
        Path(args.corpus_out).write_text(json.dumps(corpus))
    if args.data:
        miner = CandidateMiner(four_tuple)
        rows = json.loads(Path(args.data).read_text())
        img2caption = json.loads(Path(args.captions).read_text())
        # caption lists may hold {"caption": str} dicts
        img2caption = {k: [c["caption"] if isinstance(c, dict) else c for c in v]
                       for k, v in img2caption.items()}
        image2text = json.loads(Path(args.ocr).read_text()) if args.ocr else {}
        out = miner.mine_dataset(rows, img2caption, image2text, k=args.k)
        Path(args.out).write_text(json.dumps(out))
        print(json.dumps({"examples": len(out), "out": args.out}))
    else:
        print(json.dumps({"facts": len(four_tuple)}))


def cmd_prep_answers(args):
    from lako_tpu_torch.text.vqa_answers import compute_targets, create_ans2label

    annotations = json.loads(Path(args.annotations).read_text())
    if isinstance(annotations, dict):
        annotations = annotations["annotations"]
    questions = json.loads(Path(args.questions).read_text())
    if isinstance(questions, dict):
        questions = questions["questions"]
    id2question = {str(q["question_id"]): q["question"] for q in questions}
    ans2label, label2ans = create_ans2label(annotations, args.dataset, args.min_occurence)
    targets = compute_targets(annotations, ans2label, id2question)
    outdir = Path(args.out_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    (outdir / "trainval_ans2label.json").write_text(json.dumps(ans2label))
    (outdir / "trainval_label2ans.json").write_text(json.dumps(label2ans))
    (outdir / f"{args.split}.json").write_text(json.dumps(targets))
    print(json.dumps({"answers": len(ans2label), "examples": len(targets)}))


def cmd_serve(args):
    """Load the reader (and optionally the retriever, its index and the
    corpus) on ``--device`` and serve POST /answer until the process ends.
    The printed URL carries the bound port (``--port 0`` takes a free one)."""
    import torch

    from lako_tpu_torch.core.checkpoint import load_checkpoint
    from lako_tpu_torch.core.config import t5_config_for_size
    from lako_tpu_torch.core.device import resolve_device
    from lako_tpu_torch.models.t5 import FiDT5
    from lako_tpu_torch.pipeline.stages import _refuse_unported
    from lako_tpu_torch.serve import LakoService, ServiceConfig, make_http_server

    device = resolve_device(args.device)
    cfg = _load_cfg(ReaderTrainConfig, args.config)
    tok = _tokenizer(args.tokenizer)
    t5_cfg = _t5_cfg(args) or t5_config_for_size(cfg.model_size, vocab_size=tok.vocab_size)
    _refuse_unported()
    with torch.device("meta"):         # shapes only: the service builds the model
        template = FiDT5(t5_cfg).state_dict()
    params = load_checkpoint(args.model_path, template)[0]

    retriever = retriever_params = btok = index = None
    id_to_sentence = None
    if args.retriever_path and args.index and args.corpus:
        from lako_tpu_torch.models.retriever import Retriever
        from lako_tpu_torch.retrieval.index import DenseIndex

        rt_cfg = _load_cfg(RetrieverTrainConfig, args.retriever_config).retriever
        with torch.device("meta"):
            retriever = Retriever(rt_cfg)
        retriever_params = load_checkpoint(args.retriever_path, retriever.state_dict())[0]
        btok = _tokenizer(args.bert_tokenizer, style="bert")
        index = DenseIndex.load(args.index, device=device)
        corpus = json.loads(Path(args.corpus).read_text())
        id_to_sentence = {int(r["id"]): r["sentence"] for r in corpus}

    service = LakoService(
        ServiceConfig(batch_size=args.batch_size, max_length=cfg.eval_max_length,
                      n_context=cfg.data.n_context, data=cfg.data, dtype=cfg.dtype,
                      num_beams=args.num_beams, decode_backend=cfg.decode_backend,
                      decode_kv_dtype=cfg.decode_kv_dtype,
                      decode_weights_dtype=cfg.decode_weights_dtype,
                      decode_chunk_size=cfg.decode_chunk_size,
                      batch_window_ms=args.batch_window_ms, mesh_model=args.mesh_model,
                      engine_policy=args.engine_policy,
                      policy_chunked_min_occupancy=args.policy_chunked_min_occupancy),
        t5_cfg, params, tok, retriever=retriever, retriever_params=retriever_params,
        bert_tokenizer=btok, index=index, id_to_sentence=id_to_sentence, device=device)
    server = make_http_server(service, args.host, args.port)
    print(json.dumps({"serving": f"http://{args.host}:{server.server_address[1]}/answer"}),
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


def cmd_truncate_data(args):
    """Keep the first K examples."""
    from lako_tpu_torch.data.prompt import truncate_dataset

    data = json.loads(Path(args.data).read_text())
    out = truncate_dataset(data, args.keep)
    Path(args.out).write_text(json.dumps(out))
    print(json.dumps({"kept": len(out), "out": args.out}))


def cmd_prep_questions(args):
    """id2question, the question Dictionary and, with ``--glove``, the
    word-vector embedding matrix."""
    import numpy as np

    from lako_tpu_torch.text.dictionary import Dictionary, WordVectors, build_id2question

    questions = json.loads(Path(args.questions).read_text())
    if isinstance(questions, dict):
        questions = questions["questions"]
    id2q = build_id2question(questions)
    outdir = Path(args.out_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    (outdir / "id2question.json").write_text(json.dumps(id2q))

    d = Dictionary()
    for q in id2q.values():
        d.tokenize(q, add_word=True)
    d.dump_to_file(str(outdir / "qs_dictionary.pkl"))

    out = {"questions": len(id2q), "vocab": len(d)}
    if args.glove:
        mat = WordVectors(args.glove).embedding_matrix(d)
        np.save(outdir / "glove_init.npy", mat)
        out["glove_matrix"] = list(mat.shape)
    print(json.dumps(out))


def cmd_full_loop(args):
    from lako_tpu_torch.pipeline.full_loop import run_full_loop

    print(json.dumps(run_full_loop(args)))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lako", description=__doc__, epilog=_NOT_PORTED,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("build-tokenizer", help="train a tokenizer from data")
    t.add_argument("--from-json", nargs="*", help="reader/corpus JSON files")
    t.add_argument("--from-text", nargs="*", help="plain text files")
    t.add_argument("--out", required=True)
    t.add_argument("--style", default="t5", choices=["t5", "bert"])
    t.add_argument("--kind", default="word", choices=["word", "unigram", "wordpiece"],
                   help="word; unigram (T5) and wordpiece (BERT) train an HF "
                        "tokenizer.json and need the `tokenizers` package")
    t.add_argument("--vocab-size", type=int, default=32000)
    t.set_defaults(fn=cmd_build_tokenizer)

    t = sub.add_parser("train-reader", help="train the FiD reader")
    t.add_argument("--config", help="ReaderTrainConfig JSON")
    t.add_argument("--t5-config", help="T5Config JSON (else size preset)")
    t.add_argument("--train-data", required=True)
    t.add_argument("--eval-data", required=True)
    t.add_argument("--tokenizer", required=True)
    t.add_argument("--model-path", help="warm-start checkpoint dir, or an HF "
                                         "save_pretrained dir")
    t.add_argument("--maxload", type=int, default=-1,
                   help="small-data mode: cap loaded examples")
    t.add_argument("--device", help="torch device, e.g. cpu (default: the CUDA card)")
    t.set_defaults(fn=cmd_train_reader)

    t = sub.add_parser("eval-reader", help="evaluate reader / write attention scores")
    t.add_argument("--config")
    t.add_argument("--t5-config")
    t.add_argument("--eval-data", required=True)
    t.add_argument("--model-path", required=True)
    t.add_argument("--tokenizer", required=True)
    t.add_argument("--write-results")
    t.add_argument("--write-crossattention-scores")
    t.add_argument("--attention-score-style", default="mean",
                   choices=["mean", "max", "21mean"])
    t.add_argument("--use-last-half-layer-attention", action="store_true")
    t.add_argument("--ans-attention", action="store_true")
    t.add_argument("--num-beams", type=int, default=1)
    t.add_argument("--device", help="torch device, e.g. cpu (default: the CUDA card)")
    t.set_defaults(fn=cmd_eval_reader)

    t = sub.add_parser("train-retriever", help="distill retriever from attention")
    t.add_argument("--config")
    t.add_argument("--train-data", required=True)
    t.add_argument("--eval-data", required=True)
    t.add_argument("--tokenizer", required=True)
    t.add_argument("--device", help="torch device, e.g. cpu (default: the CUDA card)")
    t.set_defaults(fn=cmd_train_retriever)

    t = sub.add_parser("embed-facts", help="embed the KG corpus into an index")
    t.add_argument("--config")
    t.add_argument("--model-path", required=True)
    t.add_argument("--corpus", required=True)
    t.add_argument("--out", required=True)
    t.add_argument("--tokenizer", required=True)
    t.add_argument("--batch-size", type=int, default=512)
    t.add_argument("--device", help="torch device, e.g. cpu (default: the CUDA card)")
    t.set_defaults(fn=cmd_embed_facts)

    t = sub.add_parser("retrieve", help="dense retrieval (full or small-range)")
    t.add_argument("--config")
    t.add_argument("--model-path", required=True)
    t.add_argument("--index", required=True)
    t.add_argument("--corpus", required=True)
    t.add_argument("--data", nargs="+", required=True)
    t.add_argument("--out", nargs="+", required=True)
    t.add_argument("--tokenizer", required=True)
    t.add_argument("--n-docs", type=int, default=500)
    t.add_argument("--index-method", default="exact", choices=["exact", "fast", "approx", "pq"],
                   help="exact = float32 scores; fast = bfloat16 inputs with float32 "
                        "accumulation on the card (float32 on the CPU); approx = fast's "
                        "scores with the exact top-k (approx_max_k is a TPU operation); "
                        "pq = the product quantizer, trained and cached in <index>/pq")
    t.add_argument("--small-range", action="store_true",
                   help="re-rank each example's existing candidates")
    t.add_argument("--sharded-index", action="store_true",
                   help="shard the corpus over devices: not ported yet (ROADMAP item 12)")
    t.add_argument("--device", help="torch device, e.g. cpu (default: the CUDA card)")
    t.set_defaults(fn=cmd_retrieve)

    t = sub.add_parser("eval-facts", help="retrieval hit@k")
    t.add_argument("--data", required=True)
    t.add_argument("--hitk", nargs="*", type=int)
    t.set_defaults(fn=cmd_eval_facts)

    t = sub.add_parser("mine-candidates", help="verbalize KG + BM25 top-k facts")
    t.add_argument("--triples", required=True)
    t.add_argument("--templates")
    t.add_argument("--data", help="cache-format rows {sent,label,img_id}")
    t.add_argument("--captions", help="img_id -> captions JSON")
    t.add_argument("--ocr", help="img_id -> OCR text JSON")
    t.add_argument("--out")
    t.add_argument("--corpus-out", help="write verbalized corpus [{sentence,id}]")
    t.add_argument("--k", type=int, default=500)
    t.set_defaults(fn=cmd_mine_candidates)

    t = sub.add_parser("prep-answers", help="VQA answer vocab + soft targets")
    t.add_argument("--annotations", required=True)
    t.add_argument("--questions", required=True)
    t.add_argument("--dataset", default="okvqa", choices=["okvqa", "vqa2.0"])
    t.add_argument("--min-occurence", type=int, default=3)
    t.add_argument("--split", default="train")
    t.add_argument("--out-dir", required=True)
    t.set_defaults(fn=cmd_prep_answers)

    t = sub.add_parser("serve", help="HTTP QA service: retrieve + read")
    t.add_argument("--config")
    t.add_argument("--t5-config")
    t.add_argument("--model-path", required=True)
    t.add_argument("--tokenizer", required=True)
    t.add_argument("--retriever-config")
    t.add_argument("--retriever-path")
    t.add_argument("--bert-tokenizer")
    t.add_argument("--index")
    t.add_argument("--corpus")
    t.add_argument("--host", default="127.0.0.1")
    t.add_argument("--port", type=int, default=8080)
    t.add_argument("--batch-size", type=int, default=8)
    t.add_argument("--num-beams", type=int, default=1)
    t.add_argument("--batch-window-ms", type=float, default=0.0,
                   help="dynamic micro-batching window (0 = off): concurrent "
                        "requests within the window share one device batch")
    t.add_argument("--mesh-model", type=int, default=1,
                   help="tensor-parallel width: only 1 is ported (ROADMAP item 11)")
    t.add_argument("--engine-policy", default="fixed", choices=["fixed", "auto"],
                   help="auto = chunked early-exit decode only when the batch's "
                        "occupancy reaches the threshold; fixed = always the "
                        "configured chunk size")
    t.add_argument("--policy-chunked-min-occupancy", type=int, default=None,
                   help="occupancy at which engine-policy=auto switches to chunked "
                        "decode (default: max(batch_size//2, 5); must be <= batch-size)")
    t.add_argument("--device", help="torch device, e.g. cpu (default: the CUDA card)")
    t.set_defaults(fn=cmd_serve)

    t = sub.add_parser("truncate-data", help="keep the first K examples of a JSON dataset")
    t.add_argument("--data", required=True)
    t.add_argument("--out", required=True)
    t.add_argument("--keep", type=int, required=True)
    t.set_defaults(fn=cmd_truncate_data)

    t = sub.add_parser("prep-questions", help="id2question + dictionary + GloVe matrix")
    t.add_argument("--questions", required=True)
    t.add_argument("--glove", help="local GloVe-format txt (optional)")
    t.add_argument("--out-dir", required=True)
    t.set_defaults(fn=cmd_prep_questions)

    t = sub.add_parser("full-loop", help="iterative reader/retriever loop")
    t.add_argument("--workdir", required=True)
    t.add_argument("--reader-config")
    t.add_argument("--retriever-config")
    t.add_argument("--t5-config")
    t.add_argument("--train-data", required=True)
    t.add_argument("--eval-data", required=True)
    t.add_argument("--corpus", required=True)
    t.add_argument("--tokenizer", required=True)
    t.add_argument("--bert-tokenizer", required=True)
    t.add_argument("--iterations", type=int, default=2)
    t.add_argument("--warm-start-reader", action="store_true",
                   help="initialize each iteration's reader from the previous "
                        "iteration's best checkpoint")
    t.add_argument("--reader-init",
                   help="checkpoint dir every iteration's reader starts from; "
                        "--warm-start-reader overrides it from iteration 2 on")
    t.add_argument("--attention-score-style", default="mean")
    t.add_argument("--ans-attention", action="store_true")
    t.add_argument("--use-last-half-layer-attention", action="store_true")
    t.add_argument("--fact-ablation", action="store_true",
                   help="per iteration, also evaluate the reader with shuffled facts "
                        "(one extra eval pass)")
    t.add_argument("--device", help="torch device, e.g. cpu (default: the CUDA card)")
    t.set_defaults(fn=cmd_full_loop)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    init_logger()
    args.fn(args)


if __name__ == "__main__":
    main()
