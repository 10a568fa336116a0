"""Build the CUDA kernels under ``lako_tpu_torch/csrc`` at first use.

All ``csrc/*.cu`` files are compiled by one ``nvcc`` call into a shared
library with a plain C interface, which is loaded with ``ctypes``. The library
lands in ``build/lako_tpu_torch/`` at the repository root, named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one is
loaded as is. Nothing falls back: without ``nvcc`` a build raises with the
command it could not run.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from lako_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lako_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_library = []   # the loaded CDLL, once built


def find_nvcc():
    """``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc`` (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    return str(cand) if cand.is_file() else None


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblako_kernels-{h.hexdigest()[:16]}.so"


def compile_library(out: Path) -> float:
    """Run nvcc into ``out``; returns the seconds it took."""
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    nvcc = find_nvcc()
    cmd = [nvcc or "nvcc", *NVCC_FLAGS, "-o", str(tmp), *cu]
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH or in $CUDA_HOME/bin; cannot build the "
            "CUDA kernels. Command: " + " ".join(cmd))
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}: "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    seconds = time.perf_counter() - t0
    logger.info("built %s in %.1f s", out.name, seconds)
    return seconds


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if missing. Loaded once per
    process: later calls neither hash the sources nor touch the disk."""
    with _lock:
        if not _library:
            path = library_path()
            if not path.exists():
                compile_library(path)
            lib = ctypes.CDLL(str(path))
            lib.lako_cuda_error_string.argtypes = [ctypes.c_int]
            lib.lako_cuda_error_string.restype = ctypes.c_char_p
            _library.append(lib)
        return _library[0]


@functools.cache
def bind(name: str, n_pointers: int, n_ints: int):
    """C entry ``name``(n_pointers void*, n_ints int, cudaStream_t) -> int,
    with its ctypes signature set."""
    fn = getattr(load_library(), name)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check_launch(code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if code != 0:
        msg = load_library().lako_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream
