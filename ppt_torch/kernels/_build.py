"""Build, load and count the port's CUDA kernels.

Each ``ppt_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C ABI under ``build/kernels/``
at the repository root (listed in ``.gitignore``), and loaded with
``ctypes``. A library is built at first use and rebuilt when its source
or a shared header (``csrc/*.cuh``) is newer than it. :func:`build_all` starts one ``nvcc``
per source, all at once, under a lock on ``build/kernels/.lock`` that every
process takes (``flock``): ranks that start at once wait for one build and
then load its libraries, and a library is only ever replaced whole
(``os.replace`` of a finished file).

Nothing here runs at import time: the CPU tests import every module and
this machine may have no ``nvcc``.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"
SOURCES = ("attention", "cloud", "group", "losses3d", "mini", "text", "vitblock")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# Launch counts per kernel entry point: each wrapper adds one where it
# launches its kernel on the card, and nowhere else.
LAUNCHES: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    LAUNCHES.clear()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the port's "
        "CUDA kernels cannot be built"
    )


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"libppt_{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


@contextlib.contextmanager
def _build_lock():
    """The cross-process build lock (the thread lock ``_lock`` guards one
    process's loads)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all(names: Iterable[str] = SOURCES, force: bool = False) -> Dict[str, float]:
    """Compile the named sources in parallel; returns seconds per source.
    Raises with nvcc's output when a build fails. Another process building
    meanwhile is waited for; what it built fresh is not built again."""
    with _build_lock():
        return _build(list(names), force)


def _build(names, force: bool) -> Dict[str, float]:
    names = [n for n in names if force or _stale(n)]
    if not names:
        return {}
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in names:
        tmp = BUILD_DIR / f"libppt_{n}.{os.getpid()}.tmp.so"
        cmd = [
            nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{n}.cu"),
        ]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    times, failures = {}, []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        times[n] = time.perf_counter() - t0
        (BUILD_DIR / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"--- {n}.cu (nvcc exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(n))
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.ppt_error_string.argtypes = [ctypes.c_int]
            lib.ppt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error after its launch."""
    if rc != 0:
        msg = lib.ppt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc} ({msg})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_tensors(name: str, *tensors: torch.Tensor) -> None:
    """The kernel path takes contiguous tensors, all on one card."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")


DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(name: str, dtype: torch.dtype) -> int:
    if dtype not in DTYPE_CODE:
        raise TypeError(f"{name}: compute dtype {dtype} not in (float32, bfloat16)")
    return DTYPE_CODE[dtype]
