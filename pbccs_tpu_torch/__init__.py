"""PyTorch/CUDA port of the pbccs_tpu CCS caller.

The module layout mirrors pbccs_tpu (models/arrow, models/quiver, ops,
parallel, poa, align, io, runtime, resilience, pipeline, cli), so each
module's counterpart is found under the same name.  The port never
imports jax or pbccs_tpu: host-stage modules that are plain numpy there
are kept here as copies.  Its three CUDA kernels (the banded Arrow fill,
the Quiver fill and the dense 9-slot mutation scorer) live in csrc/ and
are built with nvcc at first use on the card."""

from pbccs_tpu_torch.device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
