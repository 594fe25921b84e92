"""Banded fills and mutation scoring: plain torch versions and CUDA kernels."""
