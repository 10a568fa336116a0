"""Load HF ``save_pretrained`` checkpoint directories: the port of
lako_tpu/models/hf_io.py.

A directory is ``config.json`` plus one of: a single ``model.safetensors``,
sharded ``model-XXXXX-of-XXXXX.safetensors`` files with a
``model.safetensors.index.json``, or the legacy ``pytorch_model.bin``
(single or sharded, with ``pytorch_model.bin.index.json``). The tensors are
mapped onto the port's state_dicts by models/t5/convert.py and
models/bert/convert.py.

Safetensors files are read here in plain Python, never through the
``safetensors`` package: a file is an 8-byte little-endian header length,
a JSON header (``{name: {dtype, shape, data_offsets}}``, optionally
``__metadata__``) and the raw little-endian bytes, which become tensors over
an ``mmap`` of the file (``torch.frombuffer``). The header is checked as
the package checks it: the tensors' byte ranges must tile the data region
with no gap or overlap and end at the end of the file, and each range must
hold its shape's bytes. ``.bin`` files are read with ``torch.load(...,
weights_only=True)``.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

_SAFETENSORS_SINGLE = "model.safetensors"
_SAFETENSORS_INDEX = "model.safetensors.index.json"
_BIN_SINGLE = "pytorch_model.bin"
_BIN_INDEX = "pytorch_model.bin.index.json"
_WEIGHT_FILES = (_SAFETENSORS_SINGLE, _SAFETENSORS_INDEX, _BIN_SINGLE, _BIN_INDEX)

# the safetensors dtypes this reader takes
SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
                      "I64": torch.int64, "I32": torch.int32, "BOOL": torch.bool}
# the T5Config fields of the port's kernel route, which config.json lacks
_ROUTE_FIELDS = ("use_flash_attention", "flash_min_length", "flash_block_q", "flash_block_k")
# the safetensors package's own bound on the header
_MAX_HEADER_BYTES = 100_000_000

Device = Optional[Union[str, torch.device]]


def is_hf_checkpoint_dir(path: str) -> bool:
    p = Path(path)
    if not (p / "config.json").exists():
        return False
    return any((p / f).exists() for f in _WEIGHT_FILES)


def read_safetensors(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file → ``{name: tensor}`` on the CPU, in the
    file's dtypes. The tensors share a copy-on-write ``mmap`` of the file:
    reading them reads the file, writing them does not."""
    path = Path(path)
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        if size < 8:
            raise ValueError(f"{path}: {size} bytes, too short for a safetensors header")
        f.seek(0)
        (n,) = struct.unpack("<Q", f.read(8))
        if n > min(_MAX_HEADER_BYTES, size - 8):
            raise ValueError(f"{path}: header length {n} runs past the file ({size} bytes)")
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: the header is not JSON: {e}") from None
        if not isinstance(header, dict):
            raise ValueError(f"{path}: the header is not a JSON object")
        header.pop("__metadata__", None)
        data_bytes = size - 8 - n
        entries = []
        for name, info in header.items():
            try:
                dtype_name, shape = info["dtype"], [int(s) for s in info["shape"]]
                begin, end = (int(o) for o in info["data_offsets"])
            except (KeyError, TypeError, ValueError):
                raise ValueError(f"{path}: malformed header entry {name!r}: {info!r}") from None
            if dtype_name not in SAFETENSORS_DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {dtype_name}; this reader "
                                 f"takes {sorted(SAFETENSORS_DTYPES)}")
            dtype = SAFETENSORS_DTYPES[dtype_name]
            count = 1
            for s in shape:
                if s < 0:
                    raise ValueError(f"{path}: tensor {name!r} has shape {shape}")
                count *= s
            itemsize = torch.empty((), dtype=dtype).element_size()
            if end - begin != count * itemsize:
                raise ValueError(f"{path}: tensor {name!r} ({dtype_name} {shape}) needs "
                                 f"{count * itemsize} bytes, its offsets [{begin}, {end}) "
                                 f"hold {end - begin}")
            entries.append((begin, end, name, dtype, shape, count))
        entries.sort(key=lambda e: (e[0], e[1]))
        at = 0
        for begin, end, name, *_ in entries:
            if begin != at:
                what = "overlaps the tensor before it" if begin < at else "leaves a gap"
                raise ValueError(f"{path}: tensor {name!r} at [{begin}, {end}) {what} "
                                 f"(the previous tensor ends at {at})")
            at = end
        if at != data_bytes:
            raise ValueError(f"{path}: the tensors end at byte {at} of the data, the file "
                             f"holds {data_bytes} (offsets that run out of the file, or "
                             f"trailing bytes)")
        if data_bytes == 0:
            return {name: torch.empty(shape, dtype=dtype)
                    for _, _, name, dtype, shape, _ in entries}
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out: Dict[str, torch.Tensor] = {}
    for begin, _, name, dtype, shape, count in entries:
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                         offset=8 + n + begin).view(shape)
    return out


def float32_copy(x, device: Device = "cpu") -> torch.Tensor:
    """A float32 copy of ``x`` (a tensor or an array) on ``device``, sharing
    no memory with ``x`` (nor with a file ``x`` is mapped from)."""
    x = x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    out = x.to(device=device, dtype=torch.float32)
    return out.clone() if out.data_ptr() == x.data_ptr() else out


def _load_bin_file(path: Path) -> Dict[str, torch.Tensor]:
    return dict(torch.load(str(path), map_location="cpu", weights_only=True))


def _shards(p: Path, index_name: str):
    index = json.loads((p / index_name).read_text())
    return [p / shard for shard in sorted(set(index["weight_map"].values()))]


def load_hf_state_dict(dir_path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a save_pretrained directory, on the CPU in the file's
    dtypes: single or sharded safetensors, single or sharded ``.bin``."""
    p = Path(dir_path)
    if (p / _SAFETENSORS_SINGLE).exists():
        return read_safetensors(p / _SAFETENSORS_SINGLE)
    out: Dict[str, torch.Tensor] = {}
    if (p / _SAFETENSORS_INDEX).exists():
        for shard in _shards(p, _SAFETENSORS_INDEX):
            out.update(read_safetensors(shard))
        return out
    if (p / _BIN_SINGLE).exists():
        return _load_bin_file(p / _BIN_SINGLE)
    if (p / _BIN_INDEX).exists():
        for shard in _shards(p, _BIN_INDEX):
            out.update(_load_bin_file(shard))
        return out
    raise FileNotFoundError(f"no model weights found under {dir_path}")


def _config_ns(dir_path: str) -> SimpleNamespace:
    return SimpleNamespace(**json.loads((Path(dir_path) / "config.json").read_text()))


_T5_CONFIG_DEFAULTS = dict(
    feed_forward_proj="relu", dense_act_fn="", tie_word_embeddings=True,
    relative_attention_max_distance=128, pad_token_id=0, eos_token_id=1,
    decoder_start_token_id=0, num_decoder_layers=None,
)

_BERT_CONFIG_DEFAULTS = dict(
    hidden_act="gelu", hidden_dropout_prob=0.1,
    attention_probs_dropout_prob=0.1, max_position_embeddings=512,
    type_vocab_size=2, layer_norm_eps=1e-12, pad_token_id=0,
)


def _with_defaults(ns: SimpleNamespace, defaults: dict) -> SimpleNamespace:
    for k, v in defaults.items():
        if getattr(ns, k, None) is None:
            setattr(ns, k, v)
    return ns


def load_hf_t5(dir_path: str, fid: bool = True, device: Device = "cpu"):
    """(T5Config, state_dict) from a save_pretrained directory: the port's
    ``FiDT5`` state_dict (``t5.``-prefixed) with ``fid``, else ``T5``'s; float32
    tensors on ``device`` (the host unless given)."""
    from lako_tpu_torch.models.t5.convert import state_dict_from_hf_t5, t5_config_from_hf

    ns = _with_defaults(_config_ns(dir_path), _T5_CONFIG_DEFAULTS)
    if ns.num_decoder_layers in (None, 0):
        ns.num_decoder_layers = ns.num_layers
    cfg = t5_config_from_hf(ns)
    sd = load_hf_state_dict(dir_path)
    # tied checkpoints may omit lm_head and keep encoder.embed_tokens aliases
    if "shared.weight" not in sd and "encoder.embed_tokens.weight" in sd:
        sd["shared.weight"] = sd["encoder.embed_tokens.weight"]
    return cfg, state_dict_from_hf_t5(sd, cfg, fid=fid, device=device)


def load_hf_bert(dir_path: str, prefix: str = ""):
    """(BertConfig, the port's ``BertEncoder`` state_dict, float32 on the
    host) from a save_pretrained directory. ``prefix`` strips a wrapper namespace; a
    checkpoint with ``bert.``-prefixed names and no bare ``embeddings.`` is
    read under ``bert.`` without being told."""
    from lako_tpu_torch.models.bert.convert import bert_config_from_hf, state_dict_from_hf_bert

    cfg = bert_config_from_hf(_with_defaults(_config_ns(dir_path), _BERT_CONFIG_DEFAULTS))
    sd = load_hf_state_dict(dir_path)
    if prefix == "" and not any(k.startswith("embeddings.") for k in sd):
        if any(k.startswith("bert.") for k in sd):
            prefix = "bert."
    return cfg, state_dict_from_hf_bert(sd, cfg, prefix=prefix)


def hf_t5_and_state(path: str, t5_config=None) -> Tuple:
    """(T5Config, FiDT5 state_dict) of an HF directory for the pipeline
    stages. HF's ``config.json`` has no field for the port's kernel route,
    so ``t5_config``, when given, keeps its own ``use_flash_attention``,
    ``flash_min_length`` and ``flash_block_*``; the architecture is the
    directory's."""
    cfg, sd = load_hf_t5(path)
    if t5_config is not None:
        cfg = cfg.replace(**{k: getattr(t5_config, k) for k in _ROUTE_FIELDS})
    return cfg, sd
