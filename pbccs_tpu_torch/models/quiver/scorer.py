"""Quiver multi-read mutation scorer.

Port of pbccs_tpu.models.quiver.scorer (reference Quiver-namespace
MultiReadMutationScorer, ConsensusCore/include/ConsensusCore/Quiver/
MultiReadMutationScorer.hpp:55-246): per-read template windows on the
forward or reverse-complement template, the AddRead alpha/beta mating
gate, Score(mutation) = sum over active reads of LL(mutated) - LL(current),
and ApplyMutations with the window coordinate remap.  Move scores depend
on the template only through base identity, so a mutation is scored by
a full banded refill of each overlapping read's mutated window (K2 on
the card, in its log-likelihood-only mode).  The reads' move scores are
tabulated once (fill.emission_tables: the features never change while
polishing); a fill batch names its rows by (read, window) index, so a
group's mutated windows are uploaded once for all its reads.

The JAX package pads Jmax and the read count to powers of two to bound
its compiled-program menu; here every fill batch is sized to its own
longest window (columns past a read's window are dead, so the LLs do
not change), and batches are cut to a fixed memory budget (`_chunk`)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pbccs_tpu_torch.device import resolve_device
from pbccs_tpu_torch.models.arrow import mutations as mutlib
from pbccs_tpu_torch.models.arrow.params import revcomp
from pbccs_tpu_torch.models.quiver.fill import emission_tables, fill_lls
from pbccs_tpu_torch.models.quiver.params import QuiverConfig
from pbccs_tpu_torch.models.quiver.recursor import (feature_arrays,
                                                    stack_features)

ADD_SUCCESS, ADD_ALPHABETAMISMATCH = 0, 1
_AB_MISMATCH_TOL = 1e-3
#: Fill batch budgets.  On the card K2's log-likelihood mode writes no
#: (row, column, lane) tensor: a row costs its band offsets, log-scales
#: and the (row, column) temporaries of band_offsets and the
#: log-likelihood sum, about _ROW_COL_BYTES per column, and a batch is
#: cut to _CUDA_BATCH_BYTES.  The CPU's plain version materialises about
#: 30 float32 (rows x columns x lanes) planes: cut to _CPU_CELLS cells.
_CUDA_BATCH_BYTES = 1 << 31
_ROW_COL_BYTES = 40
_CPU_CELLS = 1 << 23


class QuiverMultiReadScorer:
    """Per-template Quiver polishing state over QV-feature reads, on
    `device` (default: the card; `device="cpu"` runs the plain scan)."""

    def __init__(self, tpl: np.ndarray, reads: Sequence, strands: Sequence[int],
                 tstarts: Sequence[int], tends: Sequence[int],
                 config: QuiverConfig | None = None, *, device=None):
        self.device = resolve_device(device)
        self.config = config or QuiverConfig()
        self.tpl = np.asarray(tpl, np.int8)
        self.n_reads = len(reads)
        self._strands = np.asarray(strands, np.int32)
        self._tstarts = np.asarray(tstarts, np.int32)
        self._tends = np.asarray(tends, np.int32)
        self._W = self.config.banding.band_width
        imax = max((len(f) for f in reads), default=1)
        self._tables = emission_tables(stack_features(
            [feature_arrays(f, imax, self.device) for f in reads]),
            self.config) if reads else None
        self._rlens = torch.as_tensor(np.asarray([len(f) for f in reads],
                                                 np.int32), device=self.device)
        self.statuses = np.zeros(self.n_reads, np.int32)
        self.active = np.zeros(self.n_reads, bool)
        self._rebuild(first=True)

    # ------------------------------------------------------------------ setup

    def _window_codes(self, r: int, tpl: np.ndarray) -> np.ndarray:
        """Read r's oriented template window of `tpl`."""
        win = tpl[int(self._tstarts[r]): int(self._tends[r])]
        return revcomp(win) if self._strands[r] == 1 else win

    def _windows(self, wins: Sequence[np.ndarray]):
        """Windows padded to the longest one (at least one column) as an
        (M, Jmax) int8 tensor on the scorer's device, and their lengths."""
        wlens = np.asarray([len(w) for w in wins], np.int32)
        tp = np.full((len(wins), max(int(wlens.max()), 1)), 4, np.int8)
        for i, w in enumerate(wins):
            tp[i, : len(w)] = w
        return (torch.as_tensor(tp, device=self.device),
                torch.as_tensor(wlens, device=self.device))

    def _chunk(self, n_cols: int) -> int:
        """Rows per fill batch for windows of up to n_cols columns."""
        if self.device.type == "cuda":
            return max(1, _CUDA_BATCH_BYTES // ((n_cols + 1) * _ROW_COL_BYTES))
        return max(1, _CPU_CELLS // ((n_cols + 1) * self._W))

    def _lls(self, tw, wl, read_idx, win_idx, backward=False) -> np.ndarray:
        """LLs of rows (read_idx[i], win_idx[i]) against windows tw, in
        batches of at most _chunk rows, as float64."""
        step = self._chunk(tw.shape[1])
        out = [fill_lls(self._tables, self._rlens, tw, wl,
                        read_idx[lo: lo + step], win_idx[lo: lo + step],
                        self.config, self._W, backward)
               for lo in range(0, len(read_idx), step)]
        return torch.cat(out).cpu().numpy().astype(np.float64)

    def _rebuild(self, first: bool) -> None:
        """Forward and backward fills of every read against its current
        window: baselines = forward LLs; the mating gate
        |1 - LL_a / LL_b| <= 1e-3 (both finite) sets the statuses on the
        first build and can only drop reads later."""
        if self.n_reads == 0:
            self.baselines = np.zeros(0)
            return
        tw, wl = self._windows([self._window_codes(r, self.tpl)
                                for r in range(self.n_reads)])
        idx = torch.arange(self.n_reads, dtype=torch.int32, device=self.device)
        ll_a = self._lls(tw, wl, idx, idx)
        ll_b = self._lls(tw, wl, idx, idx, backward=True)
        self.baselines = ll_a
        denom = np.where(ll_b == 0, 1.0, ll_b)
        mated = (np.abs(1.0 - ll_a / denom) <= _AB_MISMATCH_TOL) & \
            np.isfinite(ll_a) & np.isfinite(ll_b)
        if first:
            self.active = mated.copy()
            self.statuses = np.where(mated, ADD_SUCCESS, ADD_ALPHABETAMISMATCH)
        else:
            self.active &= mated

    # ---------------------------------------------------------------- scoring

    def baseline_total(self) -> float:
        return float(self.baselines[self.active].sum())

    def score_mutations(self, muts: Sequence[mutlib.Mutation]) -> np.ndarray:
        """score(m) = sum over active overlapping reads of
        (LL(T+m) - LL(T)) via full banded refills of the mutated windows.
        Reads sharing a window geometry (ts, te, strand) share the
        mutated windows, which are built once per group."""
        if not muts:
            return np.zeros(0)
        L = len(self.tpl)
        scores = np.zeros(len(muts))

        groups: dict[tuple[int, int, int], list[int]] = {}
        for r in range(self.n_reads):
            if self.active[r]:
                key = (int(self._tstarts[r]), int(self._tends[r]),
                       int(self._strands[r]))
                groups.setdefault(key, []).append(r)

        for (ts, te, strand), rds in groups.items():
            wins, idxs = [], []
            for k, m in enumerate(muts):
                overlap = (ts <= m.end) & (m.start <= te) \
                    if m.mtype == mutlib.INSERTION \
                    else (ts < m.end) & (m.start < te)
                if not overlap:
                    continue
                mt = mutlib.apply_mutations(self.tpl, [m])
                # window bounds remap: positions <= start unchanged; the
                # window end moves with the template length delta
                te_m = te + len(mt) - L if m.start < te else te
                win = mt[ts:te_m]
                wins.append(revcomp(win) if strand == 1 else win)
                idxs.append(k)
            if not wins:
                continue
            lls = self._fill_lls_group(rds, wins)
            scores[np.asarray(idxs)] += (
                lls - self.baselines[np.asarray(rds)][:, None]).sum(axis=0)
        return scores

    def _fill_lls_group(self, rds: Sequence[int],
                        wins: Sequence[np.ndarray]) -> np.ndarray:
        """(len(rds), M) absolute forward LLs of each read of a group
        against each mutated window: the M windows uploaded once, rows
        read-major (read g's windows at rows [g*M, (g+1)*M))."""
        G, M = len(rds), len(wins)
        tw, wl = self._windows(wins)
        read_idx = torch.as_tensor(np.repeat(np.asarray(rds, np.int32), M),
                                   device=self.device)
        win_idx = torch.arange(M, dtype=torch.int32,
                               device=self.device).repeat(G)
        return self._lls(tw, wl, read_idx, win_idx).reshape(G, M)

    # ------------------------------------------------------------------- QVs

    def consensus_qvs(self) -> np.ndarray:
        """Per-position QVs via the generic single-mutation sweep
        (models.arrow.refine.consensus_qvs; the reference templates
        ConsensusQVs over both scorer families, Consensus-inl.hpp:277-297)."""
        from pbccs_tpu_torch.models.arrow.refine import consensus_qvs

        return consensus_qvs(self)

    # --------------------------------------------------------------- mutation

    def apply_mutations(self, muts: Sequence[mutlib.Mutation]) -> None:
        """Apply `muts`, remap every read window through the old->new
        position map, and rebuild the fills."""
        if not muts:
            return
        L = len(self.tpl)
        mtp = mutlib.target_to_query_positions(muts, L)
        self.tpl = mutlib.apply_mutations(self.tpl, muts)
        self._tstarts = mtp[np.clip(self._tstarts, 0, L)].astype(np.int32)
        self._tends = mtp[np.clip(self._tends, 0, L)].astype(np.int32)
        self._rebuild(first=False)
