"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source is compiled by nvcc for Hopper (sm_90a) into a shared library
with a plain C interface and bound with ctypes; no PyTorch headers are
compiled, so a build takes seconds.  Libraries land in build/kernels/ at
the repository root (listed in .gitignore) and are rebuilt when missing
or older than their source.  Nothing here runs at import time.

Every kernel entry point has the signature convention
    int pbccs_<name>(<device pointers>..., <ints>..., void* stream)
and returns cudaGetLastError() after its launch; the Python wrappers
raise on a non-zero return."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

#: nvcc flags: Hopper target with the `a` features, a plain-C shared
#: library, ptxas resource report; no FMA contraction, so each kernel
#: rounds like its plain torch version (separate multiply and add), and
#: float32 subnormals flushed to zero, as the TPU and XLA's CPU backend
#: do (ops.fwdbwd.ftz is the plain versions' counterpart).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-ftz=true", "-Xptxas", "-v"]

KERNELS = ("fill_scan", "dense_score")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: per-kernel build record: seconds, nvcc/ptxas output (filled by builds)
BUILD_LOG: dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card")


def _paths(name: str) -> tuple[str, str]:
    return (os.path.join(CSRC_DIR, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    return (not os.path.exists(lib)
            or os.path.getmtime(src) > os.path.getmtime(lib))


def build(names=KERNELS, force: bool = False) -> dict[str, dict]:
    """Compile the named kernels that are missing or stale (all of them
    with `force`), one nvcc process per source, all started together.
    Returns BUILD_LOG."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return BUILD_LOG
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        src, lib = _paths(name)
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            tmp, lib, time.monotonic())
    failed = []
    for name, (proc, tmp, lib, t0) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.monotonic() - t0,
                           "output": out.decode(errors="replace")}
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, lib)
    if failed:
        msg = "\n".join(f"--- {n}:\n{BUILD_LOG[n]['output']}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{msg}")
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of one kernel library, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_paths(name)[1])
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
