"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source is compiled by nvcc for Hopper (sm_90a) into a shared library
with a plain C interface and bound with ctypes; no PyTorch headers are
compiled, so a build takes seconds.  Libraries land in build/kernels/ at
the repository root (listed in .gitignore) and are rebuilt when missing
or older than their source or than any shared header (csrc/*.cuh).
Nothing here runs at import time.

Every kernel entry point has the signature convention
    int pbccs_<name>(<device pointers>..., <ints>..., void* stream)
and returns cudaGetLastError() after its launch; the Python wrappers
check their tensors (`check_tensor`) and raise on a non-zero return.
A failed build, load or launch raises KernelError, and a wrapper that
refuses its arguments before a launch (dtype, shape, alignment, a band
width that was not built) raises LaunchRefused, a KernelError: both are
faults of the card or of the program, never of one ZMW's data (the
pipeline re-raises them instead of isolating a poison ZMW).  Each
wrapper counts its launches in a `launches` attribute through
`count_launch`, under one lock, since the CLI's worker threads launch
concurrently.

build/kernels/ is the port's persistent compile cache, so its events are
counted under pbccs_tpu's compile-cache metric names (the perf ledger's
`compile` class): ``ccs_compiles_total`` once per nvcc build, and
``ccs_compile_cache_events_total{kind}`` once per library `load` first
asks for in a process -- a hit when a fresh library is already on disk,
a miss when it has to be built."""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

from pbccs_tpu_torch.obs.metrics import default_registry

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

KERNELS = ("arrow_fill", "quiver_fill", "dense_score")

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_reg = default_registry()
_m_compiles = _reg.counter("ccs_compiles_total",
                           "Kernel library builds (nvcc) by this process")
_m_cache = {kind: _reg.counter("ccs_compile_cache_events_total",
                               "Kernel build-cache lookups by outcome",
                               kind=kind) for kind in ("hit", "miss")}
#: per-kernel build record: seconds, nvcc/ptxas output (filled by builds)
BUILD_LOG: dict[str, dict] = {}


class KernelError(RuntimeError):
    """A kernel library failed to build or load, or a launch failed."""


class LaunchRefused(KernelError, ValueError, TypeError):
    """A kernel wrapper refused its arguments before the launch.  Also a
    ValueError and a TypeError, the kinds of a plain argument check."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise KernelError("nvcc not found: the CUDA kernels are built on the "
                      "machine with the card")


def _paths(name: str) -> tuple[str, str]:
    return (os.path.join(CSRC_DIR, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    if not os.path.exists(lib):
        return True
    deps = [src, *glob.glob(os.path.join(CSRC_DIR, "*.cuh"))]
    return max(map(os.path.getmtime, deps)) > os.path.getmtime(lib)


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
        _m_compiles.inc()
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
        raise KernelError(f"nvcc failed for {failed}:\n{msg}")
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of one kernel library, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _m_cache["miss" if _stale(name) else "hit"].inc()
            build([name])
            try:
                lib = ctypes.CDLL(_paths(name)[1])
            except OSError as e:
                raise KernelError(f"cannot load the {name} kernel: {e}") \
                    from e
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise KernelError(f"{what}: CUDA launch failed with error {err}")


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's launch count (thread-safe)."""
    with _count_lock:
        wrapper.launches += 1


def check_tensor(what: str, name: str, x, dtype, ndim: int) -> None:
    """Raise unless x is a contiguous `ndim`-d tensor of `dtype` (the
    kernels take raw pointers and fixed element types)."""
    if x.dtype != dtype:
        raise LaunchRefused(f"{what}: {name} must be {dtype}, got "
                            f"{x.dtype}")
    if x.dim() != ndim or not x.is_contiguous():
        raise LaunchRefused(f"{what}: {name} must be a contiguous {ndim}-d "
                            f"tensor, got shape {tuple(x.shape)}")
