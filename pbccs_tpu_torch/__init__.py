"""PyTorch/CUDA port of the pbccs_tpu CCS caller.

The module layout mirrors pbccs_tpu (models/arrow, models/quiver, ops,
parallel, poa, align, io, runtime, resilience, obs, pipeline, cli,
contract), so each module's counterpart is found under the same name.
The port never imports jax or pbccs_tpu: host-stage modules that are
plain numpy there are kept here as copies.  Its three CUDA kernels (the
banded Arrow fill, the Quiver fill and the dense 9-slot mutation scorer)
live in csrc/ and are built with nvcc at first use on the card."""

__version__ = "0.1.0"
__all__ = ["resolve_device", "__version__"]


def __getattr__(name: str):
    # resolve_device imports torch on first use, so the package imports
    # without it (`python -m pbccs_tpu_torch.analysis.cli` needs no torch)
    if name == "resolve_device":
        from pbccs_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
