"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source is compiled by nvcc for Hopper (sm_90a) into a shared library
with a plain C interface and bound with ctypes; no PyTorch headers are
compiled, so a build takes seconds.  Libraries land in the build cache
(runtime/cache.py: `--compileCache DIR`, else build/kernels/ of the
checkout, listed in .gitignore), each named after a hash of its source,
the shared headers (csrc/*.cuh) and NVCC_FLAGS, so a library is built
when no library of that name is there, and a directory shared by
several checkouts or replicas never serves one built from other
sources.  A build is staged under a per-process temp name, fsynced and
renamed into place, so replicas building the same library at once
publish it whole.  Nothing here runs at import time.

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

The build cache is the port's persistent compile cache, so its events are
counted under pbccs_tpu's compile-cache metric names (the perf ledger's
`compile` class): ``ccs_compiles_total`` once per nvcc build, and
``ccs_compile_cache_events_total{kind}`` once per library `load` (or
`load_all`) first asks for in a process -- a hit when the library is
already in the build cache, a miss when it has to be built."""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from pbccs_tpu_torch.obs.metrics import default_registry
from pbccs_tpu_torch.runtime import cache

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")

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


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def lib_path(name: str) -> str:
    """The library of kernel `name` in the build cache: lib<name>-<hash>
    .so, the hash over its source, the shared headers and NVCC_FLAGS."""
    h = hashlib.sha256()
    for path in (source_path(name),
                 *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))):
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + b"\0" + fh.read())
    h.update("\0".join(NVCC_FLAGS).encode())
    return os.path.join(cache.cache_dir(),
                        f"lib{name}-{h.hexdigest()[:16]}.so")


def _publish(tmp: str, lib: str) -> None:
    """Rename a built library into place once its bytes are on disk, and
    the rename itself after it (a crash never leaves a torn library
    under a name that says it is built)."""
    with open(tmp, "rb") as fh:
        os.fsync(fh.fileno())
    os.replace(tmp, lib)
    fd = os.open(os.path.dirname(lib), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def build(names=KERNELS, force: bool = False) -> dict[str, dict]:
    """Compile the named kernels whose library is not in the build cache
    (all of them with `force`), one nvcc process per source, all started
    together.  Returns BUILD_LOG."""
    todo = [n for n in names if force or not os.path.exists(lib_path(n))]
    if not todo:
        return BUILD_LOG
    os.makedirs(cache.cache_dir(), exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        src, lib = source_path(name), lib_path(name)
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
        _publish(tmp, lib)
    if failed:
        msg = "\n".join(f"--- {n}:\n{BUILD_LOG[n]['output']}" for n in failed)
        raise KernelError(f"nvcc failed for {failed}:\n{msg}")
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of one kernel library, built if needed."""
    return load_all([name])[0]


def load_all(names=KERNELS) -> list[ctypes.CDLL]:
    """The ctypes handles of the named kernel libraries; those not in the
    build cache are built first, all together (build)."""
    with _lock:
        todo = {n: lib_path(n) for n in names if n not in _libs}
        for path in todo.values():
            _m_cache["hit" if os.path.exists(path) else "miss"].inc()
        build(list(todo))
        for name, path in todo.items():
            try:
                _libs[name] = ctypes.CDLL(path)
            except OSError as e:
                raise KernelError(f"cannot load the {name} kernel: {e}") \
                    from e
        return [_libs[n] for n in names]


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
