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
