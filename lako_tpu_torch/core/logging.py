"""Process-aware logging: the port of lako_tpu/core/logging.py (stdlib only).

INFO on the main process, WARNING elsewhere; an optional file handler; the
launch command line logged, so that a run can be reproduced from its log.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Optional


def init_logger(
    is_main: bool = True,
    filename: Optional[str] = None,
    name: str = "lako_tpu_torch",
) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.handlers.clear()
    logger.setLevel(logging.INFO if is_main else logging.WARNING)
    fmt = logging.Formatter(
        "[%(asctime)s] {%(filename)s:%(lineno)d} %(levelname)s - %(message)s",
        "%m/%d %H:%M:%S",
    )
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if filename is not None and is_main:
        Path(filename).parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(filename)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    if is_main:
        logger.info("COMMAND: %s", " ".join(sys.argv))
    return logger


def get_logger(name: str = "lako_tpu_torch") -> logging.Logger:
    return logging.getLogger(name)
