"""ctypes bindings for the native host library (native/pbccs_native.cpp):
the POA engine and sparse-DP seed chaining of the draft stage, and the
multithreaded BGZF codec of the CLI's BAM and .pbi output.

The library is optional: every entry point has a pure-Python equivalent
(poa.graph.PoaGraph, align.seeds.chain_seeds, io.bam's zlib path), so
a missing or
unbuildable .so degrades to the fallback.  It is the same library the
JAX package loads (`make -C native` builds it; the loader rebuilds it
once when it is missing or older than its source), and the same
PBCCS_NATIVE=0 switch turns it off, so both packages draft
identically."""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import weakref
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libpbccs_native.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False

_log = logging.getLogger(__name__)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("PBCCS_NATIVE", "").strip().lower() in (
            "0", "false", "off", "no"):
        return None
    src = os.path.join(_NATIVE_DIR, "pbccs_native.cpp")
    stale = (not os.path.exists(_LIB_PATH)
             or (os.path.exists(src)
                 and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)))
    if stale and os.path.exists(os.path.join(_NATIVE_DIR, "Makefile")):
        # a failed rebuild degrades to the pure-Python path, but says why
        try:
            proc = subprocess.run(["make", "-B", "-C", _NATIVE_DIR],
                                  capture_output=True, timeout=120,
                                  check=False)
            if proc.returncode != 0:
                stderr = proc.stderr.decode(errors="replace").strip()
                _log.warning("native library rebuild failed (make exit %d); "
                             "using pure-Python fallbacks. stderr:\n%s",
                             proc.returncode, stderr[-2000:])
        except subprocess.TimeoutExpired as e:
            _log.warning("native library rebuild timed out after %gs; "
                         "using pure-Python fallbacks", e.timeout)
        except OSError as e:
            _log.warning("native library rebuild could not run make (%s); "
                         "using pure-Python fallbacks", e)
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.pbccs_bgzf_compress.restype = ctypes.c_int64
    lib.pbccs_bgzf_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int64]
    lib.pbccs_bgzf_decompress.restype = ctypes.c_int64
    lib.pbccs_bgzf_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    lib.pbccs_chain_seeds.restype = ctypes.c_int32
    lib.pbccs_chain_seeds.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
    lib.pbccs_poa_new.restype = ctypes.c_void_p
    lib.pbccs_poa_new.argtypes = []
    lib.pbccs_poa_free.restype = None
    lib.pbccs_poa_free.argtypes = [ctypes.c_void_p]
    lib.pbccs_poa_orient_add.restype = ctypes.c_int32
    lib.pbccs_poa_orient_add.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_float,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
    lib.pbccs_poa_consensus.restype = ctypes.c_int32
    lib.pbccs_poa_consensus.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32]
    lib.pbccs_poa_vertex_count.restype = ctypes.c_int32
    lib.pbccs_poa_vertex_count.argtypes = [ctypes.c_void_p]
    lib.pbccs_poa_export.restype = ctypes.c_int32
    lib.pbccs_poa_export.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.pbccs_poa_edge_count.restype = ctypes.c_int32
    lib.pbccs_poa_edge_count.argtypes = [ctypes.c_void_p]
    lib.pbccs_poa_edges.restype = None
    lib.pbccs_poa_edges.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def bgzf_compress(data: bytes, level: int = 6,
                  nthreads: int | None = None) -> Optional[bytes]:
    """Multithreaded BGZF compression of `data` (no EOF block appended);
    None if the native library is unavailable or fails."""
    lib = _load()
    if lib is None:
        return None
    if not data:
        return b""
    nthreads = nthreads or min(8, os.cpu_count() or 1)
    cap = len(data) + (len(data) // (64 * 1024) + 2) * 1024 + 1024
    out = ctypes.create_string_buffer(cap)
    n = lib.pbccs_bgzf_compress(data, len(data), level, nthreads, out, cap)
    if n < 0:
        return None
    return out.raw[:n]


def bgzf_decompress(data: bytes,
                    expected_size: int | None = None) -> Optional[bytes]:
    """Decompress a concatenated-BGZF-block byte stream; None on failure."""
    lib = _load()
    if lib is None:
        return None
    if not data:
        return b""
    cap = expected_size if expected_size is not None \
        else max(len(data) * 6, 1 << 20)
    while True:
        out = ctypes.create_string_buffer(cap)
        n = lib.pbccs_bgzf_decompress(data, len(data), out, cap)
        if n >= 0:
            return out.raw[:n]
        if n != -2 or expected_size is not None or cap > (1 << 31):
            return None            # -1 = corrupt input; give up immediately
        cap *= 4                   # -2 = under-capacity; grow and retry


class NativePoa:
    """Handle-based native POA engine (behavior-identical to
    poa.graph.PoaGraph).  The None-returning factory `native_poa()` keeps
    the pure-Python fallback silent."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        self._h = lib.pbccs_poa_new()
        self.n_reads = 0
        self._finalizer = weakref.finalize(self, lib.pbccs_poa_free, self._h)

    def orient_add(self, read: np.ndarray, min_score: float = 0.0):
        """(path, reverse_complemented) or None when rejected."""
        from pbccs_tpu_torch.poa.banding import banding_enabled

        r = np.ascontiguousarray(read, np.int8)
        n = len(r)
        path = np.zeros(n, np.int32)
        rc = ctypes.c_uint8(0)
        added = self._lib.pbccs_poa_orient_add(
            self._h, r.ctypes.data_as(ctypes.c_void_p), n,
            ctypes.c_float(min_score), int(banding_enabled()),
            path.ctypes.data_as(ctypes.c_void_p), ctypes.byref(rc))
        if not added:
            return None
        self.n_reads += 1
        return path.tolist(), bool(rc.value)

    def consensus_path(self, min_coverage: int) -> list[int]:
        cap = max(self._lib.pbccs_poa_vertex_count(self._h), 1)
        out = np.zeros(cap, np.int32)
        m = self._lib.pbccs_poa_consensus(
            self._h, min_coverage, out.ctypes.data_as(ctypes.c_void_p), cap)
        if m < 0:
            raise RuntimeError("native POA consensus failed")
        return out[:m].tolist()

    def _export(self):
        n = self._lib.pbccs_poa_vertex_count(self._h)
        base = np.zeros(n, np.int8)
        nreads = np.zeros(n, np.int32)
        spanning = np.zeros(n, np.int32)
        score = np.zeros(n, np.float64)
        have = self._lib.pbccs_poa_export(
            self._h, base.ctypes.data_as(ctypes.c_void_p),
            nreads.ctypes.data_as(ctypes.c_void_p),
            spanning.ctypes.data_as(ctypes.c_void_p),
            score.ctypes.data_as(ctypes.c_void_p)) >= 0
        return base, nreads, spanning, score, have

    def bases(self) -> np.ndarray:
        """(V,) int8 per-vertex bases."""
        return self._export()[0]

    def export_graph(self):
        """Read-only PoaGraph snapshot."""
        from pbccs_tpu_torch.poa.graph import PoaGraph

        base, nreads, spanning, score, have = self._export()
        n = len(base)
        e = self._lib.pbccs_poa_edge_count(self._h)
        eu = np.zeros(e, np.int32)
        ev = np.zeros(e, np.int32)
        self._lib.pbccs_poa_edges(self._h,
                                  eu.ctypes.data_as(ctypes.c_void_p),
                                  ev.ctypes.data_as(ctypes.c_void_p))
        g = PoaGraph()
        g.base = base.tolist()
        g.nreads = nreads.tolist()
        g.spanning = spanning.tolist()
        g.preds = [[] for _ in range(n)]
        g.succs = [[] for _ in range(n)]
        for u, v in zip(eu.tolist(), ev.tolist()):
            g.succs[u].append(v)
            g.preds[v].append(u)
        g.n_reads = self.n_reads
        if have:
            g.vertex_score = score.astype(np.float32)
        return g


def native_poa() -> Optional[NativePoa]:
    lib = _load()
    return NativePoa(lib) if lib is not None else None


def chain_seeds(seeds: np.ndarray, k: int,
                match_reward: int = 3) -> Optional[np.ndarray]:
    """Native SDP chaining; same semantics as align.seeds.chain_seeds.
    None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(seeds)
    if n == 0:
        return np.zeros((0, 2), np.int32)
    h = np.ascontiguousarray(seeds[:, 0], np.int32)
    v = np.ascontiguousarray(seeds[:, 1], np.int32)
    out_h = np.zeros(n, np.int32)
    out_v = np.zeros(n, np.int32)
    m = lib.pbccs_chain_seeds(
        h.ctypes.data_as(ctypes.c_void_p), v.ctypes.data_as(ctypes.c_void_p),
        n, k, match_reward,
        out_h.ctypes.data_as(ctypes.c_void_p),
        out_v.ctypes.data_as(ctypes.c_void_p))
    return np.stack([out_h[:m], out_v[:m]], axis=1)
