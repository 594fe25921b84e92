"""Quiver model family of the port: the QV-feature consensus model, its
banded fills on the K2 kernel, and the per-ZMW multi-read scorer."""
