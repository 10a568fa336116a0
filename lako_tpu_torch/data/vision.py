"""Visual feature ingestion, the Faster-RCNN obj36 TSV reader and box
normalization: a copy of lako_tpu/data/vision.py, pinned to it by
tests/test_torch_native.py.

Reference: data_process/data/utils.py:20-89 (base64-encoded per-image feature
rows) and data_process/data/vqa_data.py:185-193 (0..1 box normalization with
bounds asserts). Output is plain numpy dicts. The ``cache_path`` pickle is
the JAX file's format, so either package reads the other's cache.
"""

from __future__ import annotations

import base64
import csv
import pickle
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from lako_tpu_torch.core.logging import get_logger
from lako_tpu_torch.retrieval.native import native_available

OBJ36_FIELDNAMES = [
    "img_id", "img_h", "img_w", "objects_id", "objects_conf",
    "attrs_id", "attrs_conf", "num_boxes", "boxes", "features",
]


def load_obj_tsv(
    fname: str,
    topk: Optional[int] = None,
    img_list: Optional[set] = None,
    cache_path: Optional[str] = None,
    backend: str = "auto",
) -> List[dict]:
    """Load detection features from a TSV. Each row decodes base64 payloads into
    immutable numpy arrays: objects_id/conf (n,), attrs_id/conf (n,),
    boxes (n, 4) xyxy pixels, features (n, d).

    backend: "auto" uses the threaded C++ decoder (csrc/host/obj36.cpp,
    data/vision_native.py) when the host library builds, else this Python
    loop (the choice is logged); "python"/"native" force one path, and
    "native" raises if the library does not build.
    """
    if cache_path and Path(cache_path).exists():
        with open(cache_path, "rb") as fp:
            return pickle.load(fp)

    if backend not in ("auto", "python", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    # Selective filters route to the Python loop on "auto": it checks
    # img_id BEFORE any base64 decode and stops at topk kept rows, while
    # the native decoder must decode every payload up front — for a small
    # img_list over a 790 MB shard that is orders of magnitude more work
    # than the filter-then-decode loop.
    if backend == "auto" and img_list is not None:
        backend = "python"
    if backend == "auto":
        backend = "native" if native_available() else "python"
        get_logger().info("load_obj_tsv: the %s decoder", "C++" if backend == "native"
                          else "Python (the host library does not build)")
    if backend == "native":
        from lako_tpu_torch.data import vision_native

        data = vision_native.load_obj_tsv_native(fname, topk=topk, img_list=img_list)
        if cache_path:
            with open(cache_path, "wb") as fp:
                pickle.dump(data, fp)
        return data

    csv.field_size_limit(sys.maxsize)
    data: List[dict] = []
    with open(fname) as f:
        reader = csv.DictReader(f, OBJ36_FIELDNAMES, delimiter="\t")
        for item in reader:
            if img_list is not None and item["img_id"] not in img_list:
                continue
            for key in ("img_h", "img_w", "num_boxes"):
                item[key] = int(item[key])
            n = item["num_boxes"]
            decode = [
                ("objects_id", (n,), np.int64),
                ("objects_conf", (n,), np.float32),
                ("attrs_id", (n,), np.int64),
                ("attrs_conf", (n,), np.float32),
                ("boxes", (n, 4), np.float32),
                ("features", (n, -1), np.float32),
            ]
            for key, shape, dtype in decode:
                arr = np.frombuffer(base64.b64decode(item[key]), dtype=dtype)
                arr = arr.reshape(shape)
                arr.setflags(write=False)
                item[key] = arr
            data.append(item)
            if topk is not None and len(data) == topk:
                break
    if cache_path:
        with open(cache_path, "wb") as fp:
            pickle.dump(data, fp)
    return data


def normalize_boxes(boxes: np.ndarray, img_h: int, img_w: int) -> np.ndarray:
    """Pixel xyxy → 0..1, with the reference's bounds asserts
    (vqa_data.py:188-193)."""
    out = np.array(boxes, dtype=np.float32, copy=True)
    out[:, (0, 2)] /= img_w
    out[:, (1, 3)] /= img_h
    np.testing.assert_array_less(out, 1 + 1e-5)
    np.testing.assert_array_less(-out, 0 + 1e-5)
    return out


def soft_target(label: Dict[str, float], ans2label: Dict[str, int],
                num_answers: int) -> np.ndarray:
    """{answer: score} → dense soft-score vector (vqa_data.py:197-206)."""
    target = np.zeros(num_answers, dtype=np.float32)
    for ans, score in label.items():
        if ans in ans2label:
            target[ans2label[ans]] = score
    return target
