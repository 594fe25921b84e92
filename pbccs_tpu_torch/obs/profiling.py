"""Opt-in torch.profiler capture (the CLI's --profile-dir hook).

Port of pbccs_tpu.obs.profiling: where that one captures a jax.profiler
trace, this one records the run under torch.profiler with CPU and (when
a card is present) CUDA activities and exports a Chrome trace into the
directory, which names every kernel the card ran (the port's own
arrow_fill_kernel / dense_score_kernel / quiver_fill_kernel among them).
A profiler that cannot start, or an export that fails, degrades to a
logged warning: the capture never touches the work it wraps.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

TRACE_NAME = "pbccs_torch.{pid}.pt.trace.json"


def trace_path(profile_dir: str) -> str:
    """Where profile_capture exports this process's Chrome trace."""
    return os.path.join(profile_dir, TRACE_NAME.format(pid=os.getpid()))


@contextlib.contextmanager
def profile_capture(profile_dir: str | None) -> Iterator[None]:
    """Capture a torch.profiler trace of the enclosed block into
    profile_dir (Chrome trace JSON, trace_path).  No-op when profile_dir
    is falsy; never raises on profiler failure."""
    if not profile_dir:
        yield
        return
    from pbccs_tpu_torch.runtime.logging import Logger

    prof = None
    try:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    except Exception as e:  # noqa: BLE001 -- observability must not kill work
        Logger.default().warn(f"torch profiler capture unavailable: {e!r}")
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.stop()
                prof.export_chrome_trace(trace_path(profile_dir))
            except Exception as e:  # noqa: BLE001
                Logger.default().warn(f"torch profiler stop failed: {e!r}")
