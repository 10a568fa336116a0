"""Preemption: checkpoint and requeue. The port of lako_tpu/core/preemption.py.

A signal sets a flag; the train loop polls it every step, saves a
``preempted`` checkpoint, runs the SLURM requeue command when there is one,
and exits. SIGUSR1 sets the flag (SLURM); SIGTERM is ignored unless trapped,
as the reference does.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
from typing import Callable, Optional

from lako_tpu_torch.core.logging import get_logger

_PREEMPTED = False


def preempted() -> bool:
    return _PREEMPTED


def reset() -> None:
    global _PREEMPTED
    _PREEMPTED = False


def install_handlers(trap_sigterm: bool = False) -> None:
    """SIGUSR1 (and, with ``trap_sigterm``, SIGTERM) set the flag; otherwise
    SIGTERM is ignored."""
    logger = get_logger()

    def _flag(signum, frame):
        global _PREEMPTED
        _PREEMPTED = True
        logger.warning("signal %s received: will checkpoint and exit", signum)

    signal.signal(signal.SIGUSR1, _flag)
    if trap_sigterm:
        signal.signal(signal.SIGTERM, _flag)
    else:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)


def requeue_command() -> Optional[list]:
    """``scontrol requeue <job>`` when running under SLURM as the main process."""
    job_id = os.environ.get("SLURM_JOB_ID")
    if job_id and os.environ.get("SLURM_PROCID", "0") == "0":
        return ["scontrol", "requeue", job_id]
    return None


def handle_preemption(save_fn: Callable[[], None], exit_code: int = 0) -> None:
    """Save, requeue if under SLURM, exit. Call when ``preempted()`` is True."""
    logger = get_logger()
    save_fn()
    cmd = requeue_command()
    if cmd:
        logger.warning("requeueing: %s", " ".join(cmd))
        try:
            subprocess.run(cmd, check=False)
        except FileNotFoundError:
            logger.warning("scontrol not available; skipping requeue")
    sys.exit(exit_code)
