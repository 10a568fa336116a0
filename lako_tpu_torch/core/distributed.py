"""Multi-process initialization and cross-process metric aggregation on
``torch.distributed``: the port of lako_tpu/core/distributed.py.

:func:`initialize` joins the process group named by the environment
(``WORLD_SIZE``/``RANK``/``MASTER_ADDR``/``MASTER_PORT``, or SLURM's), NCCL
on the card and gloo on the CPU. :func:`average_main` and
:func:`weighted_average` sum a few scalars over the processes with one
``all_reduce``, so every process gets the result, as the JAX package's psum
gives it; rank-0-only work goes through :func:`is_main`.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from lako_tpu_torch.core.device import resolve_device


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               device: Optional[Union[str, torch.device]] = None) -> None:
    """Join the process group. A no-op for one process. ``device``: the
    device this process computes on (the card unless given), which picks
    the backend: NCCL for CUDA, gloo otherwise."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", os.environ.get("SLURM_NTASKS", "1")))
    if world_size <= 1:
        return
    if rank is None:
        rank = int(os.environ.get("RANK", os.environ.get("SLURM_PROCID", "0")))
    if init_method is None:
        host = os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = os.environ.get("MASTER_PORT", "12355")
        init_method = f"tcp://{host}:{port}"
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def is_distributed() -> bool:
    return process_count() > 1


def _sum_scalars(values) -> torch.Tensor:
    """Sum a few float32 scalars over the processes (one all_reduce)."""
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    x = torch.tensor(values, dtype=torch.float32, device=device)
    dist.all_reduce(x)
    return x.cpu()


def average_main(x: float) -> float:
    """Mean of a scalar over the processes (loss logging)."""
    if not is_distributed():
        return float(x)
    return float(_sum_scalars([float(x)])[0]) / process_count()


def weighted_average(x: float, count: int) -> Tuple[float, int]:
    """Count-weighted mean over the processes (metric aggregation)."""
    if not is_distributed():
        return float(x), int(count)
    total = _sum_scalars([float(x) * count, float(count)])
    return float(total[0] / max(float(total[1]), 1.0)), int(total[1])
