"""Batched ZMW polishing: many ZMWs per device program, in lockstep.

Port of pbccs_tpu.parallel.batch, single device.  Z bucketed ZMWs are
polished together: one (Z*R)-read fill per rebuild, and the whole
refinement loop plus the QV sweep run on the device
(parallel.device_refine), so the host fetches once at the end.  Per-ZMW
selection semantics are those of the JAX package's device loop
(favorability floor, greedy well-separated subset, template-hash cycle
trim); converged ZMWs drop out of the mutation workload.

Left out of the port (TPU or fleet devices): the mesh, the roofline
plane, the flight recorder, the straggler continuation and prebake
adoption.  The JAX package's host refinement loop is not ported either:
where the device loop bails to it, the port raises RefineBailout."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from pbccs_tpu_torch.device import resolve_device
from pbccs_tpu_torch.models.arrow.params import (
    ArrowConfig,
    effective_band_width,
    revcomp_padded,
    snr_to_transition_table_host,
    template_transition_params,
)
from pbccs_tpu_torch.models.arrow.refine import (RefineOptions, RefineResult,
                                                 favorability_threshold)
from pbccs_tpu_torch.models.arrow.scorer import (
    ADD_ALPHABETAMISMATCH,
    ADD_POOR_ZSCORE,
    ADD_SUCCESS,
    FillState,
    _read_moments,
    fill_alpha_beta_batch_zr,
    guided_fill_passes,
    mated_mask,
    oriented_window,
)
from pbccs_tpu_torch.parallel import device_refine as dr

# windows shorter than this cannot have their boundary mutations scored
# by the window-frame edge program (its two regimes would overlap)
MIN_FAST_EDGE_WLEN = 8


def pad_to(n: int, q: int) -> int:
    """Smallest multiple of q that is >= n (q >= 1)."""
    return ((n + q - 1) // q) * q


def _jmax_bucket(max_len: int) -> int:
    """Template-axis bucket: headroom proportional to length, because net
    insertions during refinement scale with template length."""
    return pad_to(max_len + max(16, max_len // 32), 64)


def _imax_bucket(raw_imax: int) -> int:
    """Read-axis bucket: granularity ~1/8th of the length, power-of-two
    steps, floor 64."""
    step = max(64, 1 << max(raw_imax - 1, 1).bit_length() - 3)
    return pad_to(raw_imax, step)


def effective_shapes(n_zmws: int, max_reads: int, max_read_len: int,
                     max_tpl_len: int, *,
                     buckets: tuple[int, int, int] | None = None
                     ) -> tuple[int, int, int, int]:
    """The (Imax, Jmax, R, Z) a BatchPolisher with these inputs runs at.
    `buckets` = (Imax, Jmax, R) lower bounds of a parent batch: a
    sub-batch (the 2x band retry) adopts the parent's Jmax exactly when
    its templates fit, so the two polish the same template bucket."""
    Z = n_zmws
    R = pad_to(max_reads, 4)
    Imax = _imax_bucket(max_read_len + 8)
    Jmax = _jmax_bucket(max_tpl_len)
    if buckets is not None:
        Imax = max(Imax, buckets[0])
        R = max(R, buckets[2])
        if max_tpl_len + 2 <= buckets[1]:
            Jmax = buckets[1]
        else:
            Jmax = max(Jmax, buckets[1])
    return Imax, Jmax, R, Z


@dataclasses.dataclass
class ZmwTask:
    """One ZMW's polish-stage inputs (draft template + mapped reads)."""

    id: str
    tpl: np.ndarray           # (L,) int8 draft consensus
    snr: np.ndarray           # (4,)
    reads: Sequence[np.ndarray]
    strands: Sequence[int]
    tstarts: Sequence[int]
    tends: Sequence[int]


@dataclasses.dataclass
class PrebakedBatch:
    """Bucket-shaped host marshalling of a ZmwTask batch: the padded numpy
    planes and the SNR transition tables (f64 host evaluation, cast to
    f32) that the device setup consumes."""

    shapes: tuple[int, int, int, int]   # (Imax, Jmax, R, Z)
    reads: np.ndarray
    rlens: np.ndarray
    strands: np.ndarray
    tstarts: np.ndarray
    tends: np.ndarray
    real_rows: np.ndarray
    host_tables: np.ndarray


def premarshal(tasks: Sequence[ZmwTask], *,
               buckets: tuple[int, int, int] | None = None
               ) -> PrebakedBatch:
    """Marshal a ZmwTask batch into its bucket-shaped numpy planes
    (effective_shapes geometry).  Pure host work."""
    if not tasks:
        raise ValueError("empty batch")
    Imax, Jmax, R, Z = effective_shapes(
        len(tasks),
        max(len(t.reads) for t in tasks),
        max((len(r) for t in tasks for r in t.reads), default=8),
        max(len(t.tpl) for t in tasks),
        buckets=buckets)

    snrs = np.full((Z, 4), 8.0)
    reads = np.full((Z, R, Imax), 4, np.int8)
    rlens = np.zeros((Z, R), np.int32)
    strands = np.zeros((Z, R), np.int32)
    tstarts = np.zeros((Z, R), np.int32)
    tends = np.zeros((Z, R), np.int32)
    n_reads = np.zeros(Z, np.int32)
    for z, t in enumerate(tasks):
        snrs[z] = t.snr
        n_reads[z] = len(t.reads)
        for i, rc in enumerate(t.reads):
            n = min(len(rc), Imax)
            reads[z, i, :n] = rc[:n]
            rlens[z, i] = n
        strands[z, : len(t.reads)] = t.strands
        tstarts[z, : len(t.reads)] = t.tstarts
        tends[z, : len(t.reads)] = t.tends
    # padding read rows (and whole padding ZMWs) get a trivial window
    for z in range(Z):
        L = len(tasks[z].tpl) if z < len(tasks) else 2
        nr = int(n_reads[z])
        reads[z, nr:, :2] = 0
        rlens[z, nr:] = 2
        tends[z, nr:] = min(2, L)

    real_rows = np.zeros((Z, R), bool)
    for z in range(len(tasks)):
        real_rows[z, : int(n_reads[z])] = True

    host_tables = np.stack(
        [snr_to_transition_table_host(snrs[z]) for z in range(Z)]
    ).astype(np.float32)
    return PrebakedBatch((Imax, Jmax, R, Z), reads, rlens, strands, tstarts,
                         tends, real_rows, host_tables)


class SetupOut(NamedTuple):
    """Per-ZMW template tracks, per-read windows and fills, and the
    AddRead moments of one batch setup; leaves (Z, ...)."""

    win_tpl: torch.Tensor
    win_trans: torch.Tensor
    wlens: torch.Tensor
    fill: FillState
    trans_f: torch.Tensor
    tpl_r: torch.Tensor
    trans_r: torch.Tensor
    mu: torch.Tensor
    var: torch.Tensor


def _batch_setup(tpls, tlens, tables, reads, rlens, strands, tstarts, tends,
                 width: int, guided_passes: int = 0) -> SetupOut:
    """Template tracks + per-read window fills + moments for a (Z, ...)
    batch.  tables are the per-ZMW (8, 4) SNR transition tables from the
    f64 host evaluation.  The fills run on the flattened (Z*R) read
    batch, one kernel launch per direction."""
    trans_f = template_transition_params(tpls, tables, tlens)
    tpl_r = revcomp_padded(tpls, tlens)
    trans_r = template_transition_params(tpl_r, tables, tlens)
    win_tpl, win_trans, wlens = oriented_window(strands, tstarts, tends,
                                                tpls, tpl_r, tlens, tables)
    mu, var = _read_moments(strands, tstarts, tends, trans_f, trans_r, tlens)
    fill = fill_alpha_beta_batch_zr(reads, rlens, win_tpl, win_trans, wlens,
                                    width, guided_passes=guided_passes)
    return SetupOut(win_tpl, win_trans, wlens, fill, trans_f, tpl_r,
                    trans_r, mu, var)


def _update_active(active, ll_a, ll_b, rlens, tstarts, tends):
    return active & mated_mask(ll_a, ll_b, rlens, tstarts, tends)


def _favorability_eps(baselines, active):
    """(Z,) per-round favorability floor from the current baselines and
    read-active mask (refine.favorability_threshold)."""
    return favorability_threshold(
        torch.where(active, baselines.abs(), 0.0).sum(1))


class BatchPolisher:
    """Z bucketed ZMWs polished in lockstep on one device.

    Per-ZMW semantics of the reference's ArrowMultiReadMutationScorer +
    RefineConsensus, with leading (Z,) batch axes.  Runs on `device`
    (default: the card; `device="cpu"` runs the kernels' plain
    versions)."""

    def __init__(self, tasks: Sequence[ZmwTask],
                 config: ArrowConfig | None = None,
                 min_zscore: float = float("nan"), *,
                 buckets: tuple[int, int, int] | None = None,
                 device=None):
        if not tasks:
            raise ValueError("empty batch")
        self.device = resolve_device(device)
        self.config = config or ArrowConfig()
        self.min_zscore = min_zscore
        self.n_zmws = len(tasks)
        self.tpls: list[np.ndarray] = [np.asarray(t.tpl, np.int8)
                                       for t in tasks]

        pb = premarshal(tasks, buckets=buckets)
        self._Imax, self._Jmax, self._R, self._Z = pb.shapes
        self._W = effective_band_width(self.config.banding, self._Jmax)
        self._reads = pb.reads
        self._rlens = pb.rlens
        self._strands = pb.strands
        self._tstarts = pb.tstarts
        self._tends = pb.tends
        self._real_rows = pb.real_rows
        self._host_tables = pb.host_tables
        self._stats_host = None   # lazily fetched AddRead statistics
        self._qv_cache = None     # (skip set, (Z, Jmax) QVs) of the last loop
        self._setup()

    # --------------------------------------------------- AddRead statistics

    def _ensure_stats(self) -> None:
        """Fetch the AddRead statistics in one transfer, on first access.
        Gate decisions (statuses) are the device's; z-score values are
        recomputed in f64 for reporting."""
        if self._stats_host is not None:
            return
        stats = self._addread_stats_dev.cpu().numpy().astype(np.float64)
        ll_a_h, ll_b_h, mu_h, var_h, statuses_f = stats
        statuses = statuses_f.astype(np.int32)
        real = self._real_rows
        mated = real & (statuses != ADD_ALPHABETAMISMATCH)
        z = (ll_b_h - mu_h) / np.sqrt(np.maximum(var_h, 1e-12))
        self._stats_host = {
            "baselines": ll_b_h,
            "ll_mu": mu_h,
            "ll_var": var_h,
            "zscores": np.where(mated, z, np.nan),
            "statuses": statuses,
            "active": real & (statuses == ADD_SUCCESS),
        }

    @property
    def baselines(self) -> np.ndarray:
        self._ensure_stats()
        return self._stats_host["baselines"]

    @property
    def _ll_mu(self) -> np.ndarray:
        self._ensure_stats()
        return self._stats_host["ll_mu"]

    @property
    def _ll_var(self) -> np.ndarray:
        self._ensure_stats()
        return self._stats_host["ll_var"]

    @property
    def zscores(self) -> np.ndarray:
        self._ensure_stats()
        return self._stats_host["zscores"]

    @property
    def statuses(self) -> np.ndarray:
        self._ensure_stats()
        return self._stats_host["statuses"]

    @property
    def active(self) -> np.ndarray:
        """AddRead-time active mask (host snapshot; the live refinement
        mask stays on the device)."""
        self._ensure_stats()
        return self._stats_host["active"]

    # ------------------------------------------------------------------ setup

    def _dev(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), device=self.device)

    def _template_arrays(self):
        Z = self._Z
        tl = np.full((Z, self._Jmax), 4, np.int8)
        tlens = np.full(Z, 2, np.int32)
        for z in range(self.n_zmws):
            L = len(self.tpls[z])
            if L > self._Jmax:
                raise ValueError("template outgrew bucket")
            tl[z, :L] = self.tpls[z]
            tlens[z] = L
        return tl, tlens

    def _setup(self) -> None:
        """Build every read's window fills and gate the reads on the
        device (mating test + Z-score read gate).  The device tensors
        the refinement loop carries are kept as one RefineLoopState
        (self._state), which refine() replaces with the loop's final
        state."""
        tl, tlens = self._template_arrays()
        self._reads_dev = self._dev(self._reads)
        self._rlens_dev = self._dev(self._rlens)
        self._strands_dev = self._dev(self._strands)
        self._tables_dev = self._dev(self._host_tables)
        self._real_dev = self._dev(self._real_rows)
        tpl, tlens_d = self._dev(tl), self._dev(tlens)
        tstarts, tends = self._dev(self._tstarts), self._dev(self._tends)
        s = _batch_setup(tpl, tlens_d, self._tables_dev, self._reads_dev,
                         self._rlens_dev, self._strands_dev, tstarts, tends,
                         self._W, guided_fill_passes(self._Jmax))
        ll_a, ll_b = s.fill.ll_a, s.fill.ll_b
        z32 = (ll_b - s.mu) / torch.sqrt(torch.clamp(s.var, min=1e-12))
        if np.isnan(self.min_zscore):
            ok_z = torch.ones_like(z32, dtype=torch.bool)
        else:
            ok_z = torch.isfinite(z32) & (
                z32 >= float(np.float32(self.min_zscore)))
        mated = mated_mask(ll_a, ll_b, self._rlens_dev, tstarts, tends)
        real = self._real_dev
        statuses = torch.where(
            ~real, -1,
            torch.where(~mated, ADD_ALPHABETAMISMATCH,
                        torch.where(~ok_z, ADD_POOR_ZSCORE, ADD_SUCCESS)))
        self._addread_stats_dev = torch.stack(
            [ll_a, ll_b, s.mu, s.var, statuses.to(ll_b.dtype)])
        self._stats_host = None

        Z, Jmax, dev = self._Z, self._Jmax, self.device
        zeros = torch.zeros(Z, dtype=torch.int32, device=dev)
        self._state = dr.RefineLoopState(
            tpl=tpl, tlens=tlens_d, tstarts=tstarts, tends=tends,
            win_tpl=s.win_tpl, win_trans=s.win_trans, wlens=s.wlens,
            alpha=s.fill.alpha, beta=s.fill.beta,
            a_prefix=s.fill.apre, b_suffix=s.fill.bsuf, baselines=ll_b,
            trans_f=s.trans_f, tpl_r=s.tpl_r, trans_r=s.trans_r,
            active=real & mated & ok_z,
            done=torch.zeros(Z, dtype=torch.bool, device=dev),
            converged=torch.zeros(Z, dtype=torch.bool, device=dev),
            iterations=zeros, n_tested=zeros, n_applied=zeros,
            allowed=torch.ones(Z, Jmax, dtype=torch.bool, device=dev),
            history=torch.zeros(Z, dr.HISTORY, dtype=torch.int64,
                                device=dev),
            hist_n=zeros)

    # ------------------------------------------------------------- refinement

    def _loop_state(self, skip=None) -> dr.RefineLoopState:
        """A fresh loop start from the current device state: ZMWs in
        `skip` and padding ZMWs start done, counters and filters reset."""
        st = self._state
        zeros = torch.zeros_like(st.iterations)
        return dataclasses.replace(
            st, done=self._skip_mask(skip),
            converged=torch.zeros_like(st.converged), iterations=zeros,
            n_tested=zeros, n_applied=zeros,
            allowed=torch.ones_like(st.allowed),
            history=torch.zeros_like(st.history), hist_n=zeros, it=0)

    def _skip_mask(self, skip) -> torch.Tensor:
        m = np.zeros(self._Z, bool)
        m[self.n_zmws:] = True
        for z in (skip or ()):
            m[z] = True
        return self._dev(m)

    def _qv_sweep(self, st: dr.RefineLoopState, skip) -> np.ndarray:
        """(Z, Jmax) int32 QVs of the state's templates (one fetch)."""
        qv = dr.run_qv_ints(st, self._reads_dev, self._rlens_dev,
                            self._strands_dev, self._tables_dev,
                            self._real_dev, self._skip_mask(skip),
                            min_fast_edge=MIN_FAST_EDGE_WLEN)
        return qv.cpu().numpy()

    def refine(self, opts: RefineOptions | None = None,
               skip=None) -> list[RefineResult]:
        """Lockstep greedy refinement of the batch on the device, then the
        QV sweep on the final templates (served later by consensus_qvs).

        ZMW indices in `skip` take no part (their RefineResult stays
        non-converged).  Raises dr.RefineBailout where the JAX package
        would fall back to its host loop."""
        opts = opts or RefineOptions()
        st = self._loop_state(skip)
        dr.run_refine_loop(
            st, self._reads_dev, self._rlens_dev, self._strands_dev,
            self._tables_dev, self._real_dev, width=self._W,
            max_iterations=opts.max_iterations,
            separation=opts.mutation_separation,
            neighborhood=opts.mutation_neighborhood,
            min_fast_edge=MIN_FAST_EDGE_WLEN,
            guided_passes=guided_fill_passes(self._Jmax))
        qv = self._qv_sweep(st, skip)

        self._state = st                 # the loop's final device state
        h = torch.cat([
            torch.stack([st.tlens, st.converged.to(torch.int32),
                         st.iterations, st.n_tested, st.n_applied], 1),
            st.tpl.to(torch.int32)], dim=1).cpu().numpy()
        for z in range(self.n_zmws):
            self.tpls[z] = h[z, 5: 5 + h[z, 0]].astype(np.int8)
        self._qv_cache = (frozenset(skip or ()), qv)
        return [RefineResult(converged=bool(h[z, 1]), n_tested=int(h[z, 3]),
                             n_applied=int(h[z, 4]), iterations=int(h[z, 2]))
                for z in range(self.n_zmws)]

    # ------------------------------------------------------------------- QVs

    def consensus_qvs(self, skip=None) -> list[np.ndarray]:
        """Per-ZMW per-position QVs (reference ConsensusQVs,
        Consensus-inl.hpp:277-297).  Served from refine()'s sweep when
        every ZMW live in this call was live in that sweep; otherwise one
        sweep now.  ZMWs in `skip` get empty arrays."""
        skip = set(skip or ())
        live = set(range(self.n_zmws)) - skip
        if self._qv_cache is not None and not live & self._qv_cache[0]:
            qv = self._qv_cache[1]
        else:
            qv = self._qv_sweep(self._loop_state(skip), skip)
        return [np.zeros(0, np.int32) if z in skip
                else qv[z, : len(self.tpls[z])].astype(np.int32)
                for z in range(self.n_zmws)]

    def global_zscores(self) -> np.ndarray:
        """(Z,) z-score of the summed log-likelihood per ZMW, from the
        AddRead-time (draft template) statistics, in f64."""
        out = np.full(self.n_zmws, np.nan)
        for z in range(self.n_zmws):
            act = self.active[z]
            if not act.any():
                continue
            var = self._ll_var[z][act].sum()
            if var <= 0:
                continue
            ll = self.baselines[z][act].sum()
            out[z] = (ll - self._ll_mu[z][act].sum()) / np.sqrt(var)
        return out
