"""What the FiDO cells change in the T5 cells' harness: the program's
configuration with FiDO's two decoder options, the seeded weights of
``benchmark/reference/fido_t5.py``'s schema, and that reference in the
check that decides ``correct``.

The T5 cells' driver and check read their configuration, weights and
reference through ``common.t5_config``, ``common.t5_state`` and
``reference.t5.T5Reference``; :func:`in_place_of_t5` puts FiDO's in their
place for the length of a run, so a FiDO cell runs the same loop and the
same comparison (``common.reader_gaps``), and ``benchmark/controls.py``'s
lower-precision reference becomes FiDO's too.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from benchmark import common, weights
from benchmark.reference import fido_t5
from benchmark.reference import t5 as ref_t5

FIDO_KEYS = common.T5_KEYS + ("cross_attention_stride", "multiquery_cross_attention")


def t5_config(cfg: dict):
    from lako_tpu_torch.core.config import T5Config

    return T5Config(**{k: cfg[k] for k in FIDO_KEYS})


def t5_state(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return weights.make_state(fido_t5.param_schema(cfg), seed, common.SALT_T5, device)


@contextlib.contextmanager
def in_place_of_t5():
    """FiDO's configuration, weights and reference where the T5 cells' code
    looks them up, until the block ends."""
    swaps = ((common, "t5_config", t5_config), (common, "t5_state", t5_state),
             (ref_t5, "T5Reference", fido_t5.FidoReference))
    saved = [(module, name, getattr(module, name)) for module, name, _ in swaps]
    try:
        for module, name, value in swaps:
            setattr(module, name, value)
        yield
    finally:
        for module, name, value in saved:
            setattr(module, name, value)
