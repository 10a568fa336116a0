"""Offline batches of a FiDO reader: the loop of ``offline_batches`` (full
batches back to back through ``LakoService.generate_tokens``, the requests
carrying their facts) with FiDO's configuration, seeded weights and plain
reference in the T5 reader's place (``benchmark/fido.py``)."""

from __future__ import annotations

from benchmark import fido
from benchmark.drivers import offline_batches


def run(cell) -> dict:
    with fido.in_place_of_t5():
        return offline_batches.run(cell)
