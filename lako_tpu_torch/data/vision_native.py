"""The C++ obj36 TSV decoder: a copy of lako_tpu/data/vision_native.py on
the port's host library (csrc/host/obj36.cpp, a byte-for-byte copy of
``native/obj36.cpp``, built by ops/_build.py ``load_host_library``).

``load_obj_tsv_native`` gives :func:`lako_tpu_torch.data.vision.load_obj_tsv`'s
output (the same list-of-dicts schema, reference
data_process/data/utils.py:20-89) but parses and base64-decodes rows
across a thread pool. Row payloads are decoded into C++-owned buffers and
copied into numpy arrays here, which keeps array lifetimes independent of
the native handle. Pinned to the JAX Python loader by
tests/test_torch_native.py.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

from lako_tpu_torch.ops._build import load_host_library

# payload field order of lako_obj36_field (native/obj36.cpp kPayloadFields)
_FIELDS = [
    ("objects_id", np.int64, None),
    ("objects_conf", np.float32, None),
    ("attrs_id", np.int64, None),
    ("attrs_conf", np.float32, None),
    ("boxes", np.float32, 4),
    ("features", np.float32, -1),
]


def load_obj_tsv_native(
    fname: str,
    topk: Optional[int] = None,
    img_list: Optional[set] = None,
    n_threads: Optional[int] = None,
) -> List[dict]:
    """Threaded native decode; same output as vision.load_obj_tsv.

    ``topk`` bounds the number of *kept* rows. Without an ``img_list``
    filter it also bounds the decode work (passed down as max_rows);
    with a filter every row must be decoded before filtering, matching
    the Python loader's semantics.
    """
    lib = load_host_library()
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 1)
    max_rows = -1 if (img_list is not None or topk is None) else topk
    handle = lib.lako_obj36_open(str(fname).encode(), int(n_threads),
                                 int(max_rows))
    if not handle:
        raise OSError(f"cannot read {fname}")
    try:
        n_rows = lib.lako_obj36_num_rows(handle)
        if n_rows == 0:
            err = lib.lako_obj36_error(handle).decode()
            if err:
                raise ValueError(f"{fname}: {err}")
        data: List[dict] = []
        meta = [ctypes.c_longlong() for _ in range(4)]
        for i in range(n_rows):
            img_id = lib.lako_obj36_img_id(handle, i).decode()
            if img_list is not None and img_id not in img_list:
                continue
            lib.lako_obj36_meta(handle, i, *(ctypes.byref(m) for m in meta))
            img_h, img_w, n_boxes, feat_dim = (m.value for m in meta)
            item = {"img_id": img_id, "img_h": img_h, "img_w": img_w,
                    "num_boxes": n_boxes}
            for f, (key, dtype, cols) in enumerate(_FIELDS):
                nbytes = lib.lako_obj36_field_size(handle, i, f)
                ptr = lib.lako_obj36_field(handle, i, f)
                arr = np.frombuffer(
                    (ctypes.c_char * nbytes).from_address(ptr), dtype=dtype
                ).copy()
                if cols is not None:
                    arr = arr.reshape(n_boxes, -1 if cols == -1 else cols)
                arr.setflags(write=False)
                item[key] = arr
            data.append(item)
            if topk is not None and len(data) == topk:
                break
        return data
    finally:
        lib.lako_obj36_close(handle)
