"""Device resolution for the port's entry points.

Entry points run on the card unless the caller names another device:
`resolve_device(None)` is `cuda`, and asking for `cuda` on a machine
without one raises instead of quietly running on the CPU.  Tests pass
`device="cpu"` to run the plain versions of the kernels."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The torch device an entry point runs on (default: the card)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pbccs_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions")
    return dev


#: message marks of the RuntimeErrors torch raises for CUDA faults
_CUDA_ERROR_MARKS = ("CUDA error", "CUDA driver error", "CUDA out of memory",
                     "CUBLAS_STATUS", "cuDNN error", "device-side assert")


def is_device_error(exc: BaseException | None) -> bool:
    """Whether `exc` (or an exception in its cause chain) is a fault of
    the card or of the kernels rather than of one ZMW's data: a kernel
    build, load or launch failure (ops.cuda_lib.KernelError), a kernel
    wrapper's refusal of its arguments (cuda_lib.LaunchRefused, a
    KernelError) or a CUDA error from torch (illegal address, launch
    failure, out of memory).
    The pipeline re-raises these instead of isolating a poison ZMW."""
    from pbccs_tpu_torch.ops.cuda_lib import KernelError

    kinds = (KernelError, torch.cuda.OutOfMemoryError,
             *filter(None, [getattr(torch, "AcceleratorError", None)]))
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, kinds) or (
                isinstance(exc, RuntimeError)
                and any(m in str(exc) for m in _CUDA_ERROR_MARKS)):
            return True
        exc = exc.__cause__ or exc.__context__
    return False
