"""Fixed-shape batching: a copy of ``batch_iterator`` from
lako_tpu/data/loader.py (numpy only; ``lako_tpu.data`` imports jax), pinned
to the original by tests/test_torch_train.py."""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np


def batch_iterator(
    dataset,
    batch_size: int,
    collate: Callable,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = False,
    pad_final: bool = True,
    prefetch: int = 0,
    num_batches: Optional[int] = None,
) -> Iterator:
    """Yield collated fixed-shape batches.

    Train: shuffle + drop_last (reference RandomSampler path, train_reader.py:40-48).
    Eval: sequential; the final partial batch is padded to full size with
    ``valid=False`` rows so the jitted step never recompiles.
    prefetch > 0 runs collation on a background thread with a bounded queue, so
    host tokenization overlaps device compute (the role of the reference's
    DataLoader num_workers, train_reader.py:46).

    ``num_batches`` forces EXACTLY that many batches, truncating extra data
    or emitting all-``valid=False`` padding batches past the end. Multi-host
    SPMD needs this: every process must join every compiled collective call,
    so per-process shard-size differences must not change the batch count.
    """
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)

    def produce() -> Iterator:
        produced = 0
        for start in range(0, n, batch_size):
            if num_batches is not None and produced >= num_batches:
                return
            idx = order[start : start + batch_size]
            if len(idx) < batch_size:
                if drop_last:
                    break
                if not pad_final:
                    yield collate([dataset[int(i)] for i in idx])
                    produced += 1
                    continue
            yield collate([dataset[int(i)] for i in idx], pad_to=batch_size)
            produced += 1
        while num_batches is not None and produced < num_batches:
            yield collate([], pad_to=batch_size)   # all rows valid=False
            produced += 1

    if prefetch <= 0:
        yield from produce()
        return

    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    _END = object()
    err: list = []

    def worker():
        try:
            for batch in produce():
                q.put(batch)
        except BaseException as e:  # surface worker errors to the consumer
            err.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            if err:
                raise err[0]
            return
        yield item
