"""Build the CUDA kernels under ``lako_tpu_torch/csrc`` at first use.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain C
interface, which is loaded with ``ctypes``. The library lands in
``build/lako_tpu_torch/`` at the repository root, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
loaded as is. Nothing falls back: without ``nvcc`` a build raises with the
commands it could not run.

The host engines (``csrc/host/*.cpp``, byte-for-byte copies of the JAX
package's ``native/`` sources: the MIPS scan, BM25 and the obj36 decoder)
are built the same way by their own function, with ``g++`` and no
``nvcc``: ``native/Makefile``'s flags, since others change FMA contraction
and so the scores, into a library named by a hash of the sources, the flags
and the compiler's reading of ``-march=native`` (a build for another CPU is
not loaded). Each build compiles in a work directory of its own process and
moves the result into place with ``os.replace``; nothing runs ``make`` in
``native/`` or loads the library built there.
"""

from __future__ import annotations

import contextlib
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
              "-Xcompiler", "-fPIC")
# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

HOST_DIR = CSRC_DIR / "host"
# native/Makefile's CXXFLAGS and LDFLAGS
HOST_CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra")
HOST_LDFLAGS = ("-shared", "-pthread")

_lock = threading.Lock()
_library = []   # the loaded CDLL, once built
_host_library = []
# host buffers that captured CUDA graphs read at each replay, by the hold
# (csrc/common.cu lako_graph_hold) that says when their graph is gone
_graph_buffers: dict = {}


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
    """Compile every ``.cu`` source at once (one nvcc each), link them into
    ``out``; returns the seconds it took."""
    cu = [s for s in _sources() if s.suffix == ".cu"]
    work = out.with_name(f"{out.name}.{os.getpid()}.d")
    tmp = work / out.name
    found = find_nvcc()
    nvcc = found or "nvcc"
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(work / f"{src.stem}.o"), str(src)]
                for src in cu]
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
            *(str(work / f"{src.stem}.o") for src in cu)]
    if found is None:
        raise RuntimeError(
            "nvcc not found on PATH or in $CUDA_HOME/bin; cannot build the "
            "CUDA kernels. Commands: " + "; ".join(" ".join(c) for c in (*compiles, link)))
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        with contextlib.ExitStack() as stack:
            logs = [stack.enter_context(open(work / f"{src.stem}.log", "w+")) for src in cu]
            procs = [subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
                     for cmd, log in zip(compiles, logs)]
            try:
                for cmd, log, proc in zip(compiles, logs, procs):
                    if proc.wait() != 0:
                        log.seek(0)
                        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}: "
                                           f"{' '.join(cmd)}\n{log.read()}")
            finally:   # after a failure, stop the compiles still running
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                    proc.wait()
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}: "
                               f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        shutil.rmtree(work, ignore_errors=True)
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


def find_cxx() -> str:
    """``$CXX`` (as make reads it), else ``g++``."""
    return os.environ.get("CXX", "g++")


def _host_sources():
    return sorted(HOST_DIR.glob("*.cpp"))


def host_library_path() -> Path:
    cxx = find_cxx()
    h = hashlib.sha256(" ".join((cxx, *HOST_CXXFLAGS, *HOST_LDFLAGS)).encode())
    for args in (["--version"], ["-march=native", "-Q", "--help=target"]):
        try:
            h.update(subprocess.run([cxx, *args], capture_output=True, timeout=120).stdout)
        except OSError:
            pass   # no compiler: the build raises with its command
    for src in _host_sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblako_host-{h.hexdigest()[:16]}.so"


def compile_host_library(out: Path) -> float:
    """``g++`` the host sources into ``out`` (native/Makefile's command);
    returns the seconds it took."""
    work = out.with_name(f"{out.name}.{os.getpid()}.d")
    tmp = work / out.name
    cmd = [find_cxx(), *HOST_CXXFLAGS, *map(str, _host_sources()), "-o", str(tmp),
           *HOST_LDFLAGS]
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run the host compiler ({e}): {' '.join(cmd)}") from None
        if proc.returncode != 0:
            raise RuntimeError(f"the host build failed with exit code {proc.returncode}: "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t0
    logger.info("built %s in %.1f s", out.name, seconds)
    return seconds


def _bind_host(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C signatures of csrc/host/mips.cpp and obj36.cpp."""
    f32, i64 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)
    ll, vp = ctypes.c_longlong, ctypes.c_void_p
    for name, res, args in (
            ("lako_mips_topk", ctypes.c_int,
             [f32, ctypes.c_int64, ctypes.c_int64, f32, ctypes.c_int64, ctypes.c_int64, i64, f32,
              ctypes.c_int]),
            ("lako_mips_rerank", ctypes.c_int,
             [f32, ctypes.c_int64, ctypes.c_int64, f32, ctypes.c_int64, i64, ctypes.c_int64, i64,
              f32, ctypes.c_int]),
            ("lako_bm25_topn", ll,
             [i64, i64, ctypes.c_int64, i64, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
              ctypes.c_double, i64, ctypes.c_int64]),
            ("lako_obj36_open", vp, [ctypes.c_char_p, ctypes.c_int, ll]),
            ("lako_obj36_num_rows", ll, [vp]),
            ("lako_obj36_error", ctypes.c_char_p, [vp]),
            ("lako_obj36_img_id", ctypes.c_char_p, [vp, ll]),
            ("lako_obj36_meta", ctypes.c_int, [vp, ll] + [ctypes.POINTER(ll)] * 4),
            ("lako_obj36_field", vp, [vp, ll, ctypes.c_int]),
            ("lako_obj36_field_size", ll, [vp, ll, ctypes.c_int]),
            ("lako_obj36_close", None, [vp])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def load_host_library() -> ctypes.CDLL:
    """The host engines' shared library, built with ``g++`` first if missing;
    loaded once per process. Raises with the command it could not run."""
    with _lock:
        if not _host_library:
            path = host_library_path()
            if not path.exists():
                compile_host_library(path)
            _host_library.append(_bind_host(ctypes.CDLL(str(path))))
        return _host_library[0]


def signature(n_pointers: int, n_ints: int, n_uints: int = 0, n_floats: int = 0):
    """ctypes argtypes of a C entry taking n_pointers ``void*``, n_ints
    ``int``, n_uints ``uint32_t`` and n_floats ``float``, in that order, then
    the ``cudaStream_t``."""
    return ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
            + [ctypes.c_uint32] * n_uints + [ctypes.c_float] * n_floats + [ctypes.c_void_p])


@functools.cache
def bind(name: str, n_pointers: int, n_ints: int, n_uints: int = 0, n_floats: int = 0):
    """C entry ``name`` with the :func:`signature` of these counts, returning
    a cudaError_t code as ``int``."""
    fn = getattr(load_library(), name)
    fn.argtypes = signature(n_pointers, n_ints, n_uints, n_floats)
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


def release_graph_buffers() -> None:
    """Drop the host buffers of :func:`keep_for_graph` whose graphs are gone."""
    if _graph_buffers:
        lib = load_library()
        for hold in [h for h in _graph_buffers if lib.lako_graph_released(ctypes.c_void_p(h))]:
            del _graph_buffers[hold]


def keep_for_graph(buffer: torch.Tensor, stream) -> None:
    """Keep ``buffer``, the host source of a copy that ``stream`` is
    capturing into a CUDA graph, as long as that graph or an executable
    graph made from it exists."""
    release_graph_buffers()
    hold = ctypes.c_void_p()
    code = load_library().lako_graph_hold(ctypes.byref(hold), ctypes.c_void_p(stream))
    check_launch(code, "keep_for_graph")
    _graph_buffers[hold.value] = buffer
