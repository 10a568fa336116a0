"""Logging (counterpart of lako_tpu/core/logging.py; stdlib only)."""

from __future__ import annotations

import logging


def get_logger(name: str = "lako_tpu_torch") -> logging.Logger:
    return logging.getLogger(name)
