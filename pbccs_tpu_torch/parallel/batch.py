"""Batched ZMW polishing: many ZMWs per device program, in lockstep.

Port of pbccs_tpu.parallel.batch.  Z bucketed ZMWs are polished
together: one (Z*R)-read fill per rebuild, and the whole refinement loop
plus the QV sweep run on the device (parallel.device_refine); the host
reads a few flags and sizes a round and fetches the results once at the
end.  With a mesh (parallel.mesh, a ('zmw' x 'read') grid of devices)
the batch splits into one (Z/nz, R/nr) block of reads per grid cell,
each on its cell's device: per-read work (fills, the read gate,
scoring) runs per block, per-ZMW work on the row's first device, and
the read-axis sums are gathered there in block order.  Per-ZMW
selection semantics are those of the JAX package's device loop
(favorability floor, greedy well-separated subset, template-hash cycle
trim); converged ZMWs drop out of the mutation workload.

Observability as in the JAX package: bucket fill counters and
histograms, the flight recorder's per-round records (rebuilt from the
device loop's fetched iteration counts), the refine loop's per-round
trace spans (device_refine) and the roofline plane's card, charge and
refine scope (obs/roofline.py; the card is counted from the shapes).

A batch's host marshalling (premarshal) may be built ahead of time on a
prepare thread of the device fleet's scheduled pipeline and adopted by
the polisher (`prebaked=`).  The JAX package's host refinement loop is
not ported: the device loop handles the two cases the JAX device loop
bails to it for (tiny read windows, a template outgrowing its bucket)
itself, with or without a mesh.

The straggler continuation (pbccs_tpu's): a lockstep round rebuilds every
read's fills and runs the edge programs over all Z * R reads however few
ZMWs are still live, so an unsharded loop stops once Z // 32 or fewer remain
(device_refine.run_refine_loop) and refine() finishes those stragglers
in a compact sub-batch at the parent's (Imax, Jmax, R) and band width,
Z = straggler_shape_min_z(), with the remaining round budget.  Unlike
pbccs_tpu's, the port's sub-batch starts from the stragglers' loop
state as the parent left it -- read windows, live read rows, the nearby
filter, the template-hash ring and the round counter -- so a straggler
runs exactly the rounds the uninterrupted loop would have run
(pbccs_tpu restarts the filter and the ring, which changes n_tested).
The sub-batch's templates and counters merge into the parent's results,
its QVs serve the stragglers (_Continuation), and a later refine() on
the parent first rebuilds its fills from the current templates.  The
exit and the continuation are one policy, straggler_exit_at: no exit
under a mesh, nor in a batch of no more ZMWs than the threshold."""

from __future__ import annotations

import dataclasses
import functools
import operator
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
from pbccs_tpu_torch.models.arrow.refine import RefineOptions, RefineResult
from pbccs_tpu_torch.models.arrow.scorer import (
    ADD_ALPHABETAMISMATCH,
    ADD_POOR_ZSCORE,
    ADD_SUCCESS,
    FillState,
    _read_moments,
    count_guided,
    fill_alpha_beta_batch_zr,
    guided_fill_passes,
    mated_mask,
    oriented_window,
)
from pbccs_tpu_torch.obs import flight as obs_flight
from pbccs_tpu_torch.obs import roofline as obs_roofline
from pbccs_tpu_torch.obs import trace as obs_trace
from pbccs_tpu_torch.obs.metrics import default_registry, log_buckets
from pbccs_tpu_torch.ops.fwdbwd_cuda import check_polisher_width
from pbccs_tpu_torch.parallel import device_refine as dr
from pbccs_tpu_torch.parallel.mesh import (READ_AXIS, ZMW_AXIS, Mesh,
                                           as_device, make_zmw_mesh, pad_to,
                                           shard_batch)
from pbccs_tpu_torch.runtime.timing import device_fetch
from pbccs_tpu_torch.utils import next_pow2

# bucket fill / padding-waste observability: padding of the (Z, R) axes is
# real device work, so the fill ratios say how much of a batch's work
# polishes actual reads
_reg = default_registry()
_m_polishes = _reg.counter("ccs_batch_polishes_total",
                           "BatchPolisher batches constructed")
_m_zmw_slots = _reg.counter("ccs_batch_slots_total",
                            "Padded batch slots by axis", axis="zmw")
_m_zmw_used = _reg.counter("ccs_batch_slots_used_total",
                           "Occupied batch slots by axis", axis="zmw")
_m_read_slots = _reg.counter("ccs_batch_slots_total", axis="read")
_m_read_used = _reg.counter("ccs_batch_slots_used_total", axis="read")
_FILL_BUCKETS = log_buckets(0.0625, 1.0, 2.0)
_m_zmw_fill = _reg.histogram("ccs_batch_fill_ratio",
                             "Used/padded slot ratio per batch by axis",
                             buckets=_FILL_BUCKETS, axis="zmw")
_m_read_fill = _reg.histogram("ccs_batch_fill_ratio",
                              buckets=_FILL_BUCKETS, axis="read")

# windows shorter than this cannot have their boundary mutations scored
# by the window-frame edge program (its two regimes would overlap)
MIN_FAST_EDGE_WLEN = 8


def _jmax_bucket(max_len: int) -> int:
    """Template-axis bucket: headroom proportional to length, because net
    insertions during refinement scale with template length."""
    return pad_to(max_len + max(16, max_len // 32), 64)


def _imax_bucket(raw_imax: int) -> int:
    """Read-axis bucket: granularity ~1/8th of the length, power-of-two
    steps, floor 64."""
    step = max(64, 1 << max(raw_imax - 1, 1).bit_length() - 3)
    return pad_to(raw_imax, step)


def straggler_exit_at(z: int, n_zmws: int, mesh: Mesh | None = None) -> int:
    """The live-ZMW count at or below which the refine loop of a Z-slot
    batch of n_zmws ZMWs stops and leaves the rest to the straggler
    continuation (device_refine.run_refine_loop, BatchPolisher.refine);
    0: no early exit.  pbccs_tpu's Z // 32, and 0 under any mesh, 1 x 1
    included (pbccs_tpu's sharded loop has no exit).  Also 0 when the
    batch holds no more ZMWs than that, as a quarantine bisection's part
    padded to its parent's Z can: its loop would stop before its first
    round with every ZMW a straggler, which pbccs_tpu leaves unrefined;
    here it polishes at its own Z."""
    if mesh is not None or n_zmws <= z // 32:
        return 0
    return z // 32


def straggler_sub_z(z: int) -> int:
    """The ZMW axis of the straggler sub-batches of a Z-slot batch
    (pbccs_tpu's): the loop exits once Z // 32 or fewer ZMWs are live,
    and the sub-batch pads to the next power of two of that bound, at
    least 4, so its shapes do not depend on the draw."""
    return next_pow2(max(z // 32, 1), 4)


def length_bucket(tpl_len: int, max_read_len: int) -> tuple[int, int]:
    """The (Jmax, Imax) shape bucket a ZMW of this geometry polishes in
    (pbccs_tpu's): the grouping key of the serving engine's dynamic
    batcher (serve/batcher.py), so the ZMWs of one flush share their
    template and read buckets."""
    return _jmax_bucket(tpl_len), _imax_bucket(max_read_len + 8)


def effective_shapes(n_zmws: int, max_reads: int, max_read_len: int,
                     max_tpl_len: int, *,
                     buckets: tuple[int, ...] | None = None,
                     zq: int = 1, rq: int = 1
                     ) -> tuple[int, int, int, int]:
    """The (Imax, Jmax, R, Z) a BatchPolisher with these inputs runs at.
    `buckets` = (Imax, Jmax, R[, Z]) lower bounds of a parent batch: a
    sub-batch (the 2x band retry, a quarantine sub-dispatch) adopts the
    parent's Jmax exactly when its templates fit, so the two polish the
    same template bucket.  A fourth element pins Z: the sub-batch is
    padded with empty ZMWs to the parent's Z, so every tensor op runs at
    the parent's shapes -- torch's CUDA reductions choose their summation
    order by shape, and only equal shapes give a surviving ZMW the
    parent's results bit for bit.  Under a mesh of zq x rq devices Z pads
    to a multiple of zq and R to one of max(4, rq), so each grid cell
    holds an equal block."""
    Z = n_zmws
    R = pad_to(max_reads, max(4, rq))
    Imax = _imax_bucket(max_read_len + 8)
    Jmax = _jmax_bucket(max_tpl_len)
    if buckets is not None:
        Imax = max(Imax, buckets[0])
        R = max(R, buckets[2])
        if max_tpl_len + 2 <= buckets[1]:
            Jmax = buckets[1]
        else:
            Jmax = max(Jmax, buckets[1])
        if len(buckets) > 3:
            Z = max(Z, buckets[3])
    return Imax, Jmax, R, pad_to(Z, zq)


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
    f32) that the device setup consumes.  Numpy only: a prepare thread of
    the scheduled pipeline builds it (pipeline.prebake_polish) and the
    device worker uploads it.  One code path: BatchPolisher without a
    prebake calls premarshal() itself, so prebaked and inline batches are
    equal by construction."""

    tasks: list
    shapes: tuple[int, int, int, int]   # (Imax, Jmax, R, Z)
    reads: np.ndarray
    rlens: np.ndarray
    strands: np.ndarray
    tstarts: np.ndarray
    tends: np.ndarray
    real_rows: np.ndarray
    host_tables: np.ndarray


def premarshal_nbytes(shapes: tuple[int, int, int, int]) -> int:
    """Host bytes a premarshal() of these effective (Imax, Jmax, R, Z)
    shapes holds -- the per-batch charge the HostBudget (--memBudget)
    gates the prepare threads on.  pbccs_tpu's count, plane by plane
    (its snrs and n_reads planes included, which the port derives
    instead of keeping), so a budget throttles both packages alike."""
    imax, _jmax, r, z = shapes
    return (z * r * imax          # reads int8
            + 4 * z * r * 4       # rlens/strands/tstarts/tends int32
            + z * 4 * 8           # snrs float64
            + z * 4               # n_reads int32
            + z * r               # real_rows bool
            + z * 8 * 4 * 4)      # host_tables float32 (8, 4) per ZMW


def premarshal(tasks: Sequence[ZmwTask], *,
               buckets: tuple[int, ...] | None = None,
               zq: int = 1, rq: int = 1) -> PrebakedBatch:
    """Marshal a ZmwTask batch into its bucket-shaped numpy planes
    (effective_shapes geometry; zq, rq: the mesh's axis sizes).  Pure
    host work."""
    if not tasks:
        raise ValueError("empty batch")
    Imax, Jmax, R, Z = effective_shapes(
        len(tasks),
        max(len(t.reads) for t in tasks),
        max((len(r) for t in tasks for r in t.reads), default=8),
        max(len(t.tpl) for t in tasks),
        buckets=buckets, zq=zq, rq=rq)

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
    return PrebakedBatch(list(tasks), (Imax, Jmax, R, Z), reads, rlens,
                         strands, tstarts, tends, real_rows, host_tables)


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


def _add_guided(acc, kept, real, passes: int):
    """acc, the (2, Zb) int32 guided refills run and kept per ZMW that the
    host has not fetched yet (None: none), with one fill's added over its
    real reads (`kept`: FillState.kept, None where it ran no guided
    pass)."""
    if kept is None:
        return acc
    add = torch.stack([real * passes, kept * real]).sum(2,
                                                         dtype=torch.int32)
    return add if acc is None else acc + add


def _row_record(row) -> torch.Tensor:
    """One ZMW row's end-of-refine record on its lead, (Zb, cols) int32:
    tlens, iterations, n_tested, n_applied, converged, the live read mask
    (R columns, the row's blocks in order), the template (Jmax columns)
    and, where guided refills are pending in the row (every row or none),
    their runs and kept last.  As many launches as the record without the
    mask took: the flags and the template share one conversion."""
    st, dev = row[0].st, row[0].device
    active = st.active if len(row) == 1 else torch.cat(
        [b.st.active.to(dev) for b in row], 1)
    flags = torch.cat([st.converged.view(torch.int8)[:, None],
                       active.view(torch.int8), st.tpl], 1)
    parts = [torch.stack([st.tlens, st.iterations, st.n_tested,
                          st.n_applied], 1), flags.to(torch.int32)]
    pending = [b.st.guided.to(dev) for b in row if b.st.guided is not None]
    if pending:
        parts.append(functools.reduce(operator.add, pending).T)
    return torch.cat(parts, 1)


class _Carry(NamedTuple):
    """Loop-state rows a straggler sub-batch starts from, in its row
    order: the parent loop's live read mask, nearby filter, template-hash
    ring and ring count at the early exit."""

    active: torch.Tensor       # (n, R) bool
    allowed: torch.Tensor      # (n, Jmax) bool
    history: torch.Tensor      # (n, HISTORY) int64
    hist_n: torch.Tensor       # (n,) int32


@dataclasses.dataclass
class _Continuation:
    """What a refine() leaves for the polisher's later calls (pbccs_tpu's
    _Continuation).

    * `sub_polishers` maps a parent ZMW -> (straggler sub-polisher, its
      row there).  Non-empty implies `stale_fills`: those parent rows'
      fills are the early exit's, so the next refine() rebuilds them
      from the current templates (begin_refine), and their QVs come from the sub-polisher
      (delegated_qvs), never from the parent's sweep.
    * `qv_cache` holds (skip set of the sweep, (Z, Jmax) int32 QVs) of
      the sweep refine() ran on the loop's final templates; it serves a
      consensus_qvs call iff no ZMW that call sweeps was skipped in it.
      begin_refine drops it."""

    stale_fills: bool = False
    qv_cache: tuple | None = None
    sub_polishers: dict = dataclasses.field(default_factory=dict)

    def begin_refine(self, polisher: "BatchPolisher") -> None:
        """Entering a new refinement: rebuild stale fills from the current
        templates, then drop what the previous loop's end left."""
        if self.stale_fills:
            polisher._rebuild_stale_fills()
            self.stale_fills = False
        self.sub_polishers = {}
        self.qv_cache = None

    def record_continuation(self, mapping: dict) -> None:
        """A straggler sub-batch finished these parent ZMWs."""
        self.sub_polishers.update(mapping)
        self.stale_fills = True

    def cached_qvs(self, n_zmws: int, skip: set, tpls) -> list | None:
        """QVs from the refine-time sweep if every ZMW live in this call
        was live in that sweep too, else None."""
        if self.qv_cache is None:
            return None
        cached_skip, qv = self.qv_cache
        if (set(range(n_zmws)) - skip) & cached_skip:
            return None
        return [np.zeros(0, np.int32) if z in skip
                else qv[z, : len(tpls[z])].astype(np.int32)
                for z in range(n_zmws)]

    def delegated_qvs(self, out: list, skip: set) -> list:
        """Overwrite the QVs of continuation-finished ZMWs from their
        sub-polishers, one consensus_qvs call per sub-polisher; a
        sub-polisher whose ZMWs are all skipped runs no sweep."""
        subs = self.sub_polishers
        for sub in {id(s): s for s, _ in subs.values()}.values():
            wanted = {i: z for z, (s, i) in subs.items()
                      if s is sub and z not in skip}
            if not wanted:
                continue
            sub_q = sub.consensus_qvs(skip={i for z, (s, i) in subs.items()
                                            if s is sub and z in skip})
            for i, z in wanted.items():
                out[z] = sub_q[i]
        return out


class BatchPolisher:
    """Z bucketed ZMWs polished in lockstep on one device or on a mesh.

    Per-ZMW semantics of the reference's ArrowMultiReadMutationScorer +
    RefineConsensus, with leading (Z,) batch axes.  Runs on `device`
    (default: the card; `device="cpu"` runs the kernels' plain
    versions), or over `mesh` (parallel.mesh.make_zmw_mesh); with a mesh,
    `device`, if given, must be the mesh's first device."""

    def __init__(self, tasks: Sequence[ZmwTask],
                 config: ArrowConfig | None = None,
                 min_zscore: float = float("nan"),
                 mesh: Mesh | None = None, *,
                 buckets: tuple[int, ...] | None = None,
                 device=None, prebaked: PrebakedBatch | None = None):
        """`prebaked`: a PrebakedBatch built ahead of time on a prepare
        thread (pipeline.prebake_polish), adopted only when it was built
        from THIS task batch (object identity) at this construction's
        effective shapes, else re-marshalled."""
        if not tasks:
            raise ValueError("empty batch")
        if mesh is None:
            self.device = resolve_device(device)
            self._mesh = make_zmw_mesh(1, 1, [self.device])
        else:
            self.device = mesh.devices[0, 0]
            if device is not None and as_device(device) != self.device:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {self.device}")
            self._mesh = mesh
        self.mesh = mesh
        self.config = config or ArrowConfig()
        self.min_zscore = min_zscore
        self.n_zmws = len(tasks)
        self._tasks = list(tasks)
        self.tpls: list[np.ndarray] = [np.asarray(t.tpl, np.int8)
                                       for t in tasks]

        zq, rq = self._mesh.shape[ZMW_AXIS], self._mesh.shape[READ_AXIS]
        pb = prebaked
        if pb is None or pb.shapes != effective_shapes(
                len(tasks), max(len(t.reads) for t in tasks),
                max((len(r) for t in tasks for r in t.reads), default=8),
                max(len(t.tpl) for t in tasks), buckets=buckets,
                zq=zq, rq=rq) \
                or len(pb.tasks) != len(tasks) \
                or any(a is not b for a, b in zip(pb.tasks, tasks)):
            pb = premarshal(tasks, buckets=buckets, zq=zq, rq=rq)
        self._Imax, self._Jmax, self._R, self._Z = pb.shapes
        self._W = effective_band_width(self.config.banding, self._Jmax)
        # refuse here, before any launch, not mid-refine
        for dev in self._mesh.distinct_devices():
            check_polisher_width(self._W, dev)
        self._reads = pb.reads
        self._rlens = pb.rlens
        self._strands = pb.strands
        self._tstarts = pb.tstarts
        self._tends = pb.tends
        self._real_rows = pb.real_rows
        self._host_tables = pb.host_tables
        self._stats_host = None   # lazily fetched AddRead statistics
        self._cont = _Continuation()
        # (n_zmws, R) bool: the reads live when the last refine() ended,
        # the straggler sub-batch's for the ZMWs it finished
        self.final_active: np.ndarray | None = None

        Z, R = self._Z, self._R
        n_reads_real = int(self._real_rows.sum())
        _m_polishes.inc()
        _m_zmw_slots.inc(Z)
        _m_zmw_used.inc(self.n_zmws)
        _m_read_slots.inc(Z * R)
        _m_read_used.inc(n_reads_real)
        _m_zmw_fill.observe(self.n_zmws / Z)
        _m_read_fill.observe(n_reads_real / (Z * R))
        # flight-recorder batch tag: first ZMW id + batch size names the
        # batch compactly in postmortem dumps
        self._flight_tag = f"{tasks[0].id}+{self.n_zmws}"
        # the bucket's roofline card before the first _setup, so its
        # execution charge finds the card; mesh runs skip it (the card
        # counts the unsharded program)
        if mesh is None:
            obs_roofline.note_bucket(
                imax=self._Imax, jmax=self._Jmax, r=self._R, z=self._Z,
                width=self._W, guided_passes=guided_fill_passes(self._Jmax),
                device=self.device)
        self._setup()

    # --------------------------------------------------- AddRead statistics

    def _ensure_stats(self) -> None:
        """Fetch the AddRead statistics in one transfer, on first access.
        Gate decisions (statuses) are the device's; z-score values are
        recomputed in f64 for reporting."""
        if self._stats_host is not None:
            return
        # one fetch per block, each (5, Zb, Rb), tiled back to (5, Z, R)
        stats = np.concatenate([
            np.concatenate([device_fetch(blk, np.float64) for blk in row],
                           axis=2)
            for row in self._addread_stats_dev], axis=1)
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
        device (mating test + Z-score read gate), block by block of the
        grid (one block without a mesh): self._grid holds each cell's
        device_refine.Block, which refine() replaces with the loop's
        final state."""
        tl, tlens = self._template_arrays()
        per_read = ("reads", "rlens", "strands", "tstarts", "tends", "real")
        planes = shard_batch(self._mesh, dict(
            tpl=tl, tlens=tlens, tables=self._host_tables,
            reads=self._reads, rlens=self._rlens, strands=self._strands,
            tstarts=self._tstarts, tends=self._tends, real=self._real_rows),
            read_axis_of=lambda path: 1 if path[0] in per_read else None)
        nz, nr = self._mesh.devices.shape
        self._grid, self._addread_stats_dev = [], []
        for i in range(nz):
            row = [self._setup_block({k: v[i][j] for k, v in planes.items()})
                   for j in range(nr)]
            self._grid.append([blk for blk, _ in row])
            self._addread_stats_dev.append([st for _, st in row])
        # charge this execution of the canonical program against the
        # bucket's card (no-op without one)
        obs_roofline.charge_execution(imax=self._Imax, jmax=self._Jmax,
                                      r=self._R, z=self._Z)
        self._stats_host = None

    def _setup_block(self, p: dict):
        """One grid cell's setup on its device: (device_refine.Block,
        (5, Zb, Rb) AddRead statistics)."""
        passes = guided_fill_passes(self._Jmax)
        s = _batch_setup(p["tpl"], p["tlens"], p["tables"], p["reads"],
                         p["rlens"], p["strands"], p["tstarts"], p["tends"],
                         self._W, passes)
        ll_a, ll_b = s.fill.ll_a, s.fill.ll_b
        z32 = (ll_b - s.mu) / torch.sqrt(torch.clamp(s.var, min=1e-12))
        if np.isnan(self.min_zscore):
            ok_z = torch.ones_like(z32, dtype=torch.bool)
        else:
            ok_z = torch.isfinite(z32) & (
                z32 >= float(np.float32(self.min_zscore)))
        mated = mated_mask(ll_a, ll_b, p["rlens"], p["tstarts"], p["tends"])
        real = p["real"]
        statuses = torch.where(
            ~real, -1,
            torch.where(~mated, ADD_ALPHABETAMISMATCH,
                        torch.where(~ok_z, ADD_POOR_ZSCORE, ADD_SUCCESS)))
        stats = torch.stack([ll_a, ll_b, s.mu, s.var,
                             statuses.to(ll_b.dtype)])

        tpl = p["tpl"]
        Zb, dev = tpl.shape[0], tpl.device
        zeros = torch.zeros(Zb, dtype=torch.int32, device=dev)
        st = dr.RefineLoopState(
            tpl=tpl, tlens=p["tlens"], tstarts=p["tstarts"],
            tends=p["tends"], win_tpl=s.win_tpl, win_trans=s.win_trans,
            wlens=s.wlens, alpha=s.fill.alpha, beta=s.fill.beta,
            a_prefix=s.fill.apre, b_suffix=s.fill.bsuf, baselines=ll_b,
            trans_f=s.trans_f, tpl_r=s.tpl_r, trans_r=s.trans_r,
            active=real & mated & ok_z,
            done=torch.zeros(Zb, dtype=torch.bool, device=dev),
            converged=torch.zeros(Zb, dtype=torch.bool, device=dev),
            iterations=zeros, n_tested=zeros, n_applied=zeros,
            allowed=torch.ones(Zb, self._Jmax, dtype=torch.bool,
                               device=dev),
            history=torch.zeros(Zb, dr.HISTORY, dtype=torch.int64,
                                device=dev),
            hist_n=zeros,
            guided=_add_guided(None, s.fill.kept, real, passes))
        return dr.Block(st, p["reads"], p["rlens"], p["strands"],
                        p["tables"], real), stats

    # ------------------------------------------------------------- refinement

    def _row_masks(self, skip) -> list[torch.Tensor]:
        """Per ZMW row, the (Zb,) mask of ZMWs in `skip` and padding ZMWs,
        on the row's lead."""
        m = np.zeros(self._Z, bool)
        m[self.n_zmws:] = True
        for z in (skip or ()):
            m[z] = True
        zb = self._Z // len(self._grid)
        return [torch.as_tensor(m[i * zb: (i + 1) * zb], device=row[0].device)
                for i, row in enumerate(self._grid)]

    def _loop_grid(self, skip=None, it0: int = 0,
                   carry: _Carry | None = None) -> list[list[dr.Block]]:
        """A loop start from the current device state: ZMWs in `skip` and
        padding ZMWs start done, counters reset, the round counter at
        `it0`.  The nearby filter and the hash ring start empty, except
        in the rows a straggler `carry` gives (a 1 x 1 grid's first
        rows), which also take the carried live read mask."""
        def fresh(st, done):
            zeros = torch.zeros_like(st.iterations)
            allowed = torch.ones_like(st.allowed)
            history = torch.zeros_like(st.history)
            hist_n, active = zeros.clone(), st.active
            if carry is not None:
                n = carry.hist_n.shape[0]
                active = active.clone()
                for plane, rows in ((active, carry.active),
                                    (allowed, carry.allowed),
                                    (history, carry.history),
                                    (hist_n, carry.hist_n)):
                    plane[:n] = rows
            return dataclasses.replace(
                st, done=done.to(st.tpl.device), active=active,
                converged=torch.zeros_like(st.converged), iterations=zeros,
                n_tested=zeros, n_applied=zeros, allowed=allowed,
                history=history, hist_n=hist_n, it=it0)

        return [[dataclasses.replace(blk, st=fresh(blk.st, m)) for blk in row]
                for row, m in zip(self._grid, self._row_masks(skip))]

    def _qv_sweep(self, grid, skip) -> np.ndarray:
        """(Z, Jmax) int32 QVs of the grid's templates (one fetch)."""
        return device_fetch(dr.run_qv_ints(grid, self._row_masks(skip),
                                           min_fast_edge=MIN_FAST_EDGE_WLEN))

    def refine(self, opts: RefineOptions | None = None,
               skip=None, budget: int | None = None) -> list[RefineResult]:
        """Lockstep greedy refinement of the batch on the device, then the
        QV sweep on the final templates (served later by consensus_qvs).

        ZMW indices in `skip` take no part (their RefineResult stays
        non-converged).  A template that outgrows the bucket re-buckets
        the batch (self._Jmax grows).  `budget` caps the rounds this call
        may run (default opts.max_iterations); the straggler continuation
        passes its sub-batch the rounds the parent left, so parent and
        sub together never run more than opts.max_iterations."""
        with obs_roofline.refine_scope(imax=self._Imax, jmax=self._Jmax,
                                       r=self._R):
            return self._refine_impl(opts, skip, budget)

    def _refine_impl(self, opts, skip, budget,
                     carry: _Carry | None = None) -> list[RefineResult]:
        opts = opts or RefineOptions()
        budget = opts.max_iterations if budget is None else budget
        it0 = opts.max_iterations - budget
        self._cont.begin_refine(self)
        grid = self._loop_grid(skip, it0, carry)
        exit_at = straggler_exit_at(self._Z, self.n_zmws, self.mesh)
        dr.run_refine_loop(
            grid, width=self._W, max_iterations=opts.max_iterations,
            separation=opts.mutation_separation,
            neighborhood=opts.mutation_neighborhood,
            min_fast_edge=MIN_FAST_EDGE_WLEN, exit_at=exit_at)

        self._grid = grid                # the loop's final device state
        self._Jmax = grid[0][0].st.tpl.shape[1]
        h = device_fetch(torch.cat([_row_record(row).to(self.device)
                                    for row in grid]))
        # columns: tlens, iterations, n_tested, n_applied, converged, the
        # R live read flags, the template, [guided runs, kept]
        tpl0 = 5 + self._R
        if h.shape[1] > tpl0 + self._Jmax:
            count_guided(int(h[:, -2].sum()), int(h[:, -1].sum()))
            for row in grid:
                for blk in row:
                    blk.st.guided = None     # counted
        self.final_active = h[: self.n_zmws, 5: tpl0] != 0
        for z in range(self.n_zmws):
            self.tpls[z] = h[z, tpl0: tpl0 + h[z, 0]].astype(np.int8)
        # flight recorder: the loop ran on the device and fetched only
        # flags and sizes per round, so its rounds are rebuilt from the
        # fetched iteration counts -- a ZMW with k iterations was live in
        # rounds it0..it0+k-1, exact for the lockstep loop
        iters = h[: self.n_zmws, 1]
        for rnd in range(int(iters.max(initial=0))):
            obs_flight.record_round(self._flight_tag, it0 + rnd,
                                    int((iters > rnd).sum()), self.n_zmws,
                                    self._Z, source="device")
        results = [RefineResult(converged=bool(h[z, 4]),
                                n_tested=int(h[z, 2]),
                                n_applied=int(h[z, 3]),
                                iterations=int(h[z, 1]))
                   for z in range(self.n_zmws)]

        # stragglers: live ZMWs the early exit left with budget to spend
        # (none where exit_at is 0: under a mesh the loop runs them to the
        # end).  The loop is lockstep and a ZMW leaves it only by
        # converging, so every straggler ran every round of this call.
        skipset = set(skip or ())
        stragglers = [
            z for z in range(self.n_zmws)
            if z not in skipset and not results[z].converged
            and results[z].iterations < budget]
        # the sweep skips the stragglers: the sub-batch scores their QVs
        qv_skip = frozenset(skipset | set(stragglers))
        self._cont.qv_cache = (qv_skip, self._qv_sweep(grid, qv_skip))
        if stragglers:
            sub, sub_res = self._continue(
                stragglers, opts, budget - results[stragglers[0]].iterations)
            for i, z in enumerate(stragglers):
                self.tpls[z] = sub.tpls[i]
                self.final_active[z] = sub.final_active[i]
                r, r0 = sub_res[i], results[z]
                results[z] = RefineResult(
                    converged=r.converged,
                    n_tested=r0.n_tested + r.n_tested,
                    n_applied=r0.n_applied + r.n_applied,
                    iterations=r0.iterations + r.iterations)
            self._cont.record_continuation(
                {z: (sub, i) for i, z in enumerate(stragglers)})
        return results

    # ----------------------------------------------- straggler continuation

    def straggler_shape_min_z(self) -> int:
        """The ZMW axis of this polisher's straggler sub-batches
        (straggler_sub_z of its Z)."""
        return straggler_sub_z(self._Z)

    def _straggler_sub(self, zmws: Sequence[int]) -> "BatchPolisher":
        """The straggler sub-batch of these parent ZMWs: their current
        templates, their reads, and their read windows as the loop left
        them (the device state, not the AddRead-time windows), at the
        parent's (Imax, Jmax, R) and band width and
        Z = straggler_shape_min_z(), on the parent's device.  It does not
        re-gate: min_zscore stays off and refine() carries the parent's
        live read rows in."""
        st = self._grid[0][0].st
        idx = torch.as_tensor(list(zmws), device=st.tstarts.device)
        ts, te = device_fetch(torch.stack([st.tstarts[idx], st.tends[idx]]))
        tasks = []
        for k, z in enumerate(zmws):
            rows = np.nonzero(self._real_rows[z])[0]
            tasks.append(ZmwTask(
                f"straggler/{self._tasks[z].id}", self.tpls[z].copy(),
                self._tasks[z].snr,
                [self._reads[z, r, : self._rlens[z, r]].copy()
                 for r in rows],
                [int(self._strands[z, r]) for r in rows],
                [int(ts[k, r]) for r in rows],
                [int(te[k, r]) for r in rows]))
        config = dataclasses.replace(
            self.config, banding=dataclasses.replace(
                self.config.banding, band_width=self._W))
        return BatchPolisher(
            tasks, config=config, device=self.device,
            buckets=(self._Imax, self._Jmax, self._R,
                     self.straggler_shape_min_z()))

    def _continue(self, zmws: list[int], opts: RefineOptions,
                  budget: int) -> tuple["BatchPolisher", list[RefineResult]]:
        """Finish the stragglers `zmws` in a sub-batch that starts from
        their loop state (_Carry) with `budget` rounds left and the
        parent's round counter, inside the parent's refine scope; returns
        (sub-polisher, its results).  Its rounds go to the flight
        recorder at their true round numbers under the tag
        straggler/<first straggler's id>+<count>, all inside the
        `polish.straggler` span (args `zmws`, `sub_z`)."""
        with obs_trace.span("polish.straggler", device=self.device,
                            zmws=len(zmws),
                            sub_z=self.straggler_shape_min_z()):
            st = self._grid[0][0].st
            idx = torch.as_tensor(zmws, device=st.tpl.device)
            carry = _Carry(st.active[idx], st.allowed[idx], st.history[idx],
                           st.hist_n[idx])
            sub = self._straggler_sub(zmws)
            return sub, sub._refine_impl(opts, None, budget, carry)

    def _rebuild_stale_fills(self) -> None:
        """After a continuation (pbccs_tpu's _setup(first=False)): put the
        current templates, the stragglers' from their sub-batches, on the
        device, re-bucket if one outgrew Jmax (the loop's rule), and
        rebuild every fill; the read windows and live reads stay as the
        parent's loop left them."""
        blk = self._grid[0][0]
        st = blk.st
        max_len = max(len(t) for t in self.tpls)
        if max_len + 2 > self._Jmax:
            self._Jmax = _jmax_bucket(max_len)
        tl, tlens = self._template_arrays()
        dev = st.tpl.device
        st.tpl = torch.as_tensor(tl, device=dev)
        st.tlens = torch.as_tensor(tlens, device=dev)
        st.allowed = torch.ones(self._Z, self._Jmax, dtype=torch.bool,
                                device=dev)
        dr.rebuild(st, blk.reads, blk.rlens, blk.strands, blk.table,
                   blk.real_rows, width=self._W)

    # ------------------------------------------------------------------- QVs

    def consensus_qvs(self, skip=None) -> list[np.ndarray]:
        """Per-ZMW per-position QVs (reference ConsensusQVs,
        Consensus-inl.hpp:277-297).  Served from refine()'s sweep when
        every ZMW this call sweeps was live in that sweep; otherwise one
        sweep now.  A ZMW a straggler sub-batch finished takes its QVs
        from that sub-polisher, never from this one's sweep.  ZMWs in
        `skip` get empty arrays."""
        skip = set(skip or ())
        sweep_skip = skip | set(self._cont.sub_polishers)
        out = self._cont.cached_qvs(self.n_zmws, sweep_skip, self.tpls)
        if out is None:
            qv = self._qv_sweep(self._loop_grid(sweep_skip), sweep_skip)
            out = [np.zeros(0, np.int32) if z in sweep_skip
                   else qv[z, : len(self.tpls[z])].astype(np.int32)
                   for z in range(self.n_zmws)]
        return self._cont.delegated_qvs(out, skip)

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
