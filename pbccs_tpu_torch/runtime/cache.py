"""The kernels' persistent build cache: where ops/cuda_lib builds its
libraries and loads them from (port of pbccs_tpu.runtime.cache).

The port's compiled artifacts are the nvcc-built kernel libraries, named
after a hash of their sources, the shared headers and the nvcc flags
(cuda_lib.lib_path), so one directory can serve several checkouts and
replicas without ever loading a library built from other sources.
`enable_compilation_cache(DIR)` is the `--compileCache DIR` flag of `ccs
serve`, `ccs warmup` and `ccs fleet`: every replica and warmup pointed
at the same DIR shares one library store, so a respawned replica loads
the warmed libraries instead of building them.  With no flag, the
checkout's build/kernels/ when the package runs from a writable source
tree (it has the repository's .gitignore, which lists build/), else
~/.cache/pbccs_tpu_torch/kernels.  Nothing here imports torch."""

from __future__ import annotations

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_cache_dir: str | None = None


def default_cache_dir() -> str:
    """build/kernels/ of a writable source tree, else the per-user
    cache directory (a pip install would put the first in
    site-packages, where libraries are lost on upgrade)."""
    build = os.path.join(_REPO, "build", "kernels")
    in_checkout = os.path.isfile(os.path.join(_REPO, ".gitignore"))
    probe = next(p for p in (build, os.path.dirname(build), _REPO)
                 if os.path.isdir(p))
    if in_checkout and os.access(probe, os.W_OK):
        return build
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "pbccs_tpu_torch", "kernels")


def enable_compilation_cache(cache_dir: str | None = None) -> str:
    """Point the kernel builds at `cache_dir` (the `--compileCache`
    flag), else at default_cache_dir(); returns the directory."""
    global _cache_dir
    _cache_dir = (os.path.abspath(cache_dir) if cache_dir
                  else default_cache_dir())
    return _cache_dir


def cache_dir() -> str:
    """The directory the kernel libraries are built into and loaded
    from: the last enable_compilation_cache's, else the default."""
    return _cache_dir or default_cache_dir()
