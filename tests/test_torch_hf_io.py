"""The port's HF checkpoint reader against the JAX package's (CPU).

Tiny ``T5ForConditionalGeneration`` and ``BertModel`` directories are written
in-process by ``transformers`` (relu and gated-gelu, tied and untied, single
and sharded safetensors, single and sharded ``pytorch_model.bin``): the
port's state_dicts equal ``params_from_jax`` of the JAX loaders' trees
bitwise, and the configs field by field. The plain safetensors reader
equals ``safetensors.torch.load_file`` on a bf16 file and on every dtype it
takes, and malformed files raise. ``train-reader`` and ``eval-reader`` warm
start from an HF directory through both CLIs with Adafactor: losses within
rtol 1e-5, answers equal.
"""

import contextlib
import dataclasses
import io
import json
import logging
import struct

import numpy as np
import pytest
import torch

safetensors_torch = pytest.importorskip("safetensors.torch")
transformers = pytest.importorskip("transformers")

from lako_tpu.models import hf_io as jax_hf_io
from lako_tpu.models.bert.convert import retriever_params_from_torch_bert
from lako_tpu.pipeline.cli import main as jax_cli
from lako_tpu_torch.core import config as port_config
from lako_tpu_torch.models import hf_io
from lako_tpu_torch.models.bert import params_from_jax as bert_from_jax
from lako_tpu_torch.models.bert import retriever_state_dict_from_hf_bert
from lako_tpu_torch.models.t5 import init_fid_t5, params_from_jax
from lako_tpu_torch.pipeline import stages
from lako_tpu_torch.pipeline.cli import main as port_cli
from tests.fixtures import make_examples

LAYOUTS = {"safetensors": {}, "safetensors_sharded": {"max_shard_size": "20KB"},
           "bin": {"safe_serialization": False},
           "bin_sharded": {"safe_serialization": False, "max_shard_size": "20KB"}}
WEIGHT_FILE = {"safetensors": "model.safetensors",
               "safetensors_sharded": "model.safetensors.index.json",
               "bin": "pytorch_model.bin", "bin_sharded": "pytorch_model.bin.index.json"}

# the package loggers as collection found them, before any test ran
_LOGGERS = {n: (lg.handlers[:], lg.level, lg.propagate) for n in ("lako_tpu", "lako_tpu_torch")
            for lg in [logging.getLogger(n)]}


@pytest.fixture(autouse=True)
def _restore_loggers():
    """cli.main's init_logger replaces the package loggers' handlers; give
    later tests (caplog) the loggers as collection found them."""
    yield
    for n, (handlers, level, propagate) in _LOGGERS.items():
        lg = logging.getLogger(n)
        lg.handlers[:], lg.level, lg.propagate = handlers, level, propagate


def _hf_t5(ff="relu", tied=True, vocab=64, seed=0):
    cfg = transformers.T5Config(
        vocab_size=vocab, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_decoder_layers=3,
        num_heads=4, relative_attention_num_buckets=8, dropout_rate=0.0,
        feed_forward_proj=ff, tie_word_embeddings=tied, decoder_start_token_id=0)
    torch.manual_seed(seed)
    return transformers.T5ForConditionalGeneration(cfg).eval()


def _save(model, path, layout):
    model.save_pretrained(path, **LAYOUTS[layout])
    assert (path / WEIGHT_FILE[layout]).exists(), layout
    return path


def _assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k


def _assert_same_config(port_cfg, jax_cfg):
    jax_fields = dataclasses.asdict(jax_cfg)
    for name, value in dataclasses.asdict(port_cfg).items():
        assert value == jax_fields[name], name


@pytest.mark.parametrize("ff,tied,layout", [
    ("relu", True, "safetensors"), ("relu", True, "safetensors_sharded"),
    ("relu", True, "bin"), ("relu", True, "bin_sharded"),
    ("relu", False, "safetensors"), ("gated-gelu", True, "safetensors_sharded"),
    ("gated-gelu", False, "bin_sharded")])
def test_load_hf_t5_matches_jax(tmp_path, ff, tied, layout):
    path = _save(_hf_t5(ff, tied), tmp_path / "m", layout)
    assert hf_io.is_hf_checkpoint_dir(str(path))
    jcfg, jparams = jax_hf_io.load_hf_t5(str(path))
    cfg, sd = hf_io.load_hf_t5(str(path))
    _assert_same_config(cfg, jcfg)
    assert cfg.feed_forward_proj == ("relu" if ff == "relu" else "gated-gelu_new")
    assert ("t5.lm_head.weight" in sd) == (not tied)
    _assert_same_state(sd, params_from_jax(jparams))
    # the FiDT5 of that config takes it as is; fid=False gives T5's names
    init_fid_t5(cfg, torch.Generator().manual_seed(0)).load_state_dict(sd)
    _, plain = hf_io.load_hf_t5(str(path), fid=False)
    assert sorted(plain) == sorted(k[len("t5."):] for k in sd)


@pytest.mark.parametrize("prefixed", [False, True])
def test_load_hf_bert_and_retriever_match_jax(tmp_path, prefixed):
    cfg = transformers.BertConfig(vocab_size=100, hidden_size=32, num_hidden_layers=2,
                                  num_attention_heads=4, intermediate_size=64,
                                  max_position_embeddings=64, hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0)
    torch.manual_seed(1)
    model = (transformers.BertForPreTraining(cfg) if prefixed
             else transformers.BertModel(cfg, add_pooling_layer=False)).eval()
    model.save_pretrained(tmp_path / "b")
    jcfg, jparams = jax_hf_io.load_hf_bert(str(tmp_path / "b"))
    bcfg, sd = hf_io.load_hf_bert(str(tmp_path / "b"))
    _assert_same_config(bcfg, jcfg)
    _assert_same_state(sd, bert_from_jax(jparams))

    from lako_tpu.core import config as jax_config

    raw = hf_io.load_hf_state_dict(str(tmp_path / "b"))
    raw = {k[len("bert."):]: v for k, v in raw.items() if k.startswith("bert.")} or raw
    for projection, asymmetric in ((True, False), (False, True)):
        rcfg = port_config.RetrieverConfig(bert=bcfg, indexing_dimension=16,
                                           projection=projection, asymmetric=asymmetric)
        jrcfg = jax_config.RetrieverConfig(bert=jcfg, indexing_dimension=16,
                                           projection=projection, asymmetric=asymmetric)
        _assert_same_state(retriever_state_dict_from_hf_bert(raw, rcfg, rng_seed=3),
                           bert_from_jax(retriever_params_from_torch_bert(
                               {k: v.numpy() for k, v in raw.items()}, jrcfg, rng_seed=3)))


def test_bf16_and_every_dtype_equal_safetensors(tmp_path):
    """A bf16 save_pretrained file, and a file of every dtype the reader
    takes, read equal to ``safetensors.torch.load_file``; the T5 loader
    casts bf16 to float32 exactly."""
    path = tmp_path / "bf16"
    _hf_t5().to(torch.bfloat16).save_pretrained(path)
    want = safetensors_torch.load_file(str(path / "model.safetensors"))
    got = hf_io.load_hf_state_dict(str(path))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.bfloat16 and torch.equal(got[k], v), k
    _, sd = hf_io.load_hf_t5(str(path))
    assert torch.equal(sd["t5.shared.weight"], want["shared.weight"].float())

    g = torch.Generator().manual_seed(0)
    tensors = {"f32": torch.randn(3, 5, generator=g), "f16": torch.randn(7, generator=g).half(),
               "bf16": torch.randn(2, 2, 2, generator=g).bfloat16(),
               "i64": torch.randint(-2**40, 2**40, (4,), generator=g),
               "i32": torch.randint(-2**20, 2**20, (3, 1), generator=g).int(),
               "bool": torch.rand(5, generator=g) > 0.5, "empty": torch.zeros(0, 3),
               "scalar": torch.tensor(2.5)}
    safetensors_torch.save_file(tensors, str(tmp_path / "all.safetensors"),
                                metadata={"format": "pt"})
    got = hf_io.read_safetensors(tmp_path / "all.safetensors")
    want = safetensors_torch.load_file(str(tmp_path / "all.safetensors"))
    assert sorted(got) == sorted(want) == sorted(tensors)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v), k
    got["f32"].add_(1.0)    # copy-on-write: the file is unchanged
    assert torch.equal(hf_io.read_safetensors(tmp_path / "all.safetensors")["f32"],
                       want["f32"])


def _write(path, header, data: bytes, length=None):
    raw = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(raw) if length is None else length) + raw + data)
    return path


@pytest.mark.parametrize("case,match", [
    ("short", "too short"), ("length", "runs past the file"), ("json", "not JSON"),
    ("dtype", "F64"), ("size", "needs 16 bytes"), ("overlap", "overlaps"),
    ("gap", "leaves a gap"), ("past_end", "end at byte 24"), ("entry", "malformed")])
def test_malformed_safetensors_raise(tmp_path, case, match):
    f32 = {"dtype": "F32", "shape": [2, 2]}
    data = bytes(16)
    path = tmp_path / "x.safetensors"
    if case == "short":
        path.write_bytes(b"\x01\x00")
    elif case == "length":
        _write(path, {"a": dict(f32, data_offsets=[0, 16])}, data, length=10_000)
    elif case == "json":
        path.write_bytes(struct.pack("<Q", 4) + b"{{{{" + data)
    elif case == "dtype":
        _write(path, {"a": {"dtype": "F64", "shape": [2], "data_offsets": [0, 16]}}, data)
    elif case == "size":
        _write(path, {"a": dict(f32, data_offsets=[0, 12])}, data[:12])
    elif case == "overlap":
        _write(path, {"a": dict(f32, data_offsets=[0, 16]),
                      "b": dict(f32, data_offsets=[8, 24])}, bytes(24))
    elif case == "gap":
        _write(path, {"a": dict(f32, data_offsets=[0, 16]),
                      "b": dict(f32, data_offsets=[20, 36])}, bytes(36))
    elif case == "past_end":
        _write(path, {"a": dict(f32, data_offsets=[0, 16]),
                      "b": {"dtype": "F32", "shape": [2], "data_offsets": [16, 24]}}, data)
    else:
        _write(path, {"a": {"dtype": "F32", "data_offsets": [0, 16]}}, data)
    with pytest.raises(ValueError, match=match):
        hf_io.read_safetensors(path)


def test_no_weights_and_not_a_checkpoint(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    assert not hf_io.is_hf_checkpoint_dir(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        hf_io.load_hf_state_dict(str(tmp_path))


@pytest.fixture(scope="module")
def warm_runs(tmp_path_factory):
    """train-reader and eval-reader from one HF directory through each CLI
    (Adafactor; the JAX side on its 8-device CPU mesh at batch 1 a device,
    the port at batch 8: the same batches)."""
    wd = tmp_path_factory.mktemp("hf_warm")
    (wd / "train.json").write_text(json.dumps(make_examples(16, n_facts=2)))
    (wd / "eval.json").write_text(json.dumps(make_examples(8, n_facts=2, seed=9)))
    with contextlib.redirect_stdout(io.StringIO()):
        port_cli(["build-tokenizer", "--from-json", str(wd / "train.json"), "--out",
                  str(wd / "tok.json")])
    vocab = json.loads((wd / "tok.json").read_text())["vocab"]
    _hf_t5(vocab=max(vocab.values()) + 1, seed=5).save_pretrained(wd / "hf")
    out = {}
    for side, main, batch, extra in (("jax", jax_cli, 1, []),
                                     ("port", port_cli, 8, ["--device", "cpu"])):
        d = wd / side
        d.mkdir()
        (d / "cfg.json").write_text(json.dumps(dict(
            model_size="tiny", per_device_batch_size=batch, eval_batch_size=8, epochs=2,
            early_stop=2, eval_max_length=4, dtype="float32", use_remat=False,
            checkpoint_dir=str(d / "ckpt"), name="r",
            data=dict(n_context=2, text_maxlength=20, answer_maxlength=4, stream=2),
            optim=dict(optim="adafactor", lr=3e-2))))
        common = ["--config", str(d / "cfg.json"), "--tokenizer", str(wd / "tok.json"),
                  "--model-path", str(wd / "hf")]
        results = {}
        for cmd, args in (("train-reader", ["--train-data", str(wd / "train.json"),
                                            "--eval-data", str(wd / "eval.json")]),
                          ("eval-reader", ["--eval-data", str(wd / "eval.json"),
                                           "--write-results", str(d / "results.json")])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                main([cmd, *common, *args, *extra])
            results[cmd] = json.loads(buf.getvalue().strip().splitlines()[-1])
        results["rows"] = json.loads((d / "results.json").read_text())
        out[side] = results
    return out


def test_warm_start_from_hf_dir_matches_jax_cli(warm_runs):
    j, p = warm_runs["jax"]["train-reader"], warm_runs["port"]["train-reader"]
    assert p["steps"] == j["steps"] == 4
    assert p["best_dev_em"] == j["best_dev_em"]
    assert [h["em"] for h in p["history"]] == [h["em"] for h in j["history"]]
    np.testing.assert_allclose([h["loss"] for h in p["history"]],
                               [h["loss"] for h in j["history"]], rtol=1e-5)


def test_eval_from_hf_dir_matches_jax_cli(warm_runs):
    j, p = warm_runs["jax"]["eval-reader"], warm_runs["port"]["eval-reader"]
    for key in ("em", "include_em", "stem_em", "total"):
        assert p[key] == j[key], key
    assert [r["answer"] for r in warm_runs["port"]["rows"]] == \
        [r["answer"] for r in warm_runs["jax"]["rows"]]


def test_stage_keeps_the_kernel_route_of_its_t5_config(tmp_path):
    """An HF directory gives the architecture; a given T5Config only its
    kernel route (config.json has no field for it)."""
    path = _save(_hf_t5(), tmp_path / "m", "safetensors")
    route = port_config.T5Config(d_model=8, use_flash_attention=True, flash_min_length=16)
    cfg, _ = hf_io.hf_t5_and_state(str(path), route)
    assert (cfg.d_model, cfg.use_flash_attention, cfg.flash_min_length) == (32, True, 16)
    assert stages.is_hf_checkpoint_dir(str(path))
