"""The device the port's entry points run on."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` if given, else the CUDA card. Without a card this raises
    rather than falling back to the CPU: pass ``device="cpu"`` for that."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless asked "
                           "otherwise; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
