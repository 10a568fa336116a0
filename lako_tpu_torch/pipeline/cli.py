"""lako on PyTorch: the reader's and the retriever's subcommands of
lako_tpu/pipeline/cli.py.

Usage: python -m lako_tpu_torch.pipeline <subcommand> ...

``build-tokenizer`` (word vocabularies), ``train-reader``, ``eval-reader``,
``train-retriever``, ``embed-facts``, ``retrieve`` and ``eval-facts`` take
the JAX CLI's flags and typed JSON configs, plus ``--device`` (the CUDA card
unless given; ``--device cpu`` runs on the CPU). Their JSON artifacts have
the JAX package's schemas.
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

# the JAX CLI's other subcommands, by the ROADMAP item that ports each
_NOT_PORTED = """\
not ported yet (ROADMAP item): mine-candidates, prep-answers, truncate-data,
prep-questions, full-loop (9); serve (11, with 9); retrieve --sharded-index
(12)"""


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
    from lako_tpu_torch.text.tokenizer import WordVocabTokenizer

    if args.kind != "word":
        raise SystemExit(f"--kind {args.kind}: HF tokenizers are not ported yet "
                         "(ROADMAP item 9)")
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
    tok = WordVocabTokenizer.build(corpus, style=args.style, max_vocab=args.vocab_size)
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
                   help="word; unigram and wordpiece are not ported yet (ROADMAP item 9)")
    t.add_argument("--vocab-size", type=int, default=32000)
    t.set_defaults(fn=cmd_build_tokenizer)

    t = sub.add_parser("train-reader", help="train the FiD reader")
    t.add_argument("--config", help="ReaderTrainConfig JSON")
    t.add_argument("--t5-config", help="T5Config JSON (else size preset)")
    t.add_argument("--train-data", required=True)
    t.add_argument("--eval-data", required=True)
    t.add_argument("--tokenizer", required=True)
    t.add_argument("--model-path", help="warm-start checkpoint dir")
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
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    init_logger()
    args.fn(args)


if __name__ == "__main__":
    main()
