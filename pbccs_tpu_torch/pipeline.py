"""Per-ZMW consensus pipeline: filter -> POA draft -> polish -> QV.

Port of pbccs_tpu.pipeline (reference include/pacbio/ccs/Consensus.h:
224-555).  The host stages (filter, POA draft, read mapping) run per ZMW
on the CPU.  With the Arrow model (the default) every surviving ZMW of
the batch then polishes in one lockstep BatchPolisher on the device,
with the 2x band retry for ZMWs whose reads failed the alpha/beta mating
test (polish_prepared_batch); a batch that fails is bisected down to its
poison ZMW(s), which get a serial rescue and are otherwise quarantined
(resilience.quarantine), a batch that runs out of device memory is split
at the same pinned shapes with its shape ceiling remembered
(resilience.resources), and a device error is re-raised.  Every
dispatch runs behind the polish.dispatch fault site, the hang watchdog
and the transient-error retry.  The serial
per-ZMW polish (polish_prepared, process_chunks(batch_polish=False))
runs ArrowMultiReadScorer; with the Quiver model
(ConsensusSettings.model = "quiver") each ZMW polishes on its own
through QuiverMultiReadScorer.  Both use the generic refine loop.  Yield
accounting keeps the reference's result categories (Consensus.h:155-208,
ccs.cpp:233-262).  Trace spans (filter, draft, polish, polish.setup,
polish.refine, polish.qv) and stage timers (draft, draft.poa, draft.map,
polish) carry pbccs_tpu's names."""

from __future__ import annotations

import dataclasses
import enum
import logging
import time
import traceback
from typing import Sequence

import numpy as np

from pbccs_tpu_torch.device import is_device_error, resolve_device
from pbccs_tpu_torch.obs import trace as obs_trace
from pbccs_tpu_torch.obs.metrics import default_registry
from pbccs_tpu_torch.models.arrow.params import decode_bases, encode_bases
from pbccs_tpu_torch.models.arrow.refine import (RefineOptions,
                                                 consensus_qvs,
                                                 predicted_accuracy,
                                                 refine_consensus)
from pbccs_tpu_torch.models.arrow.scorer import (ADD_ALPHABETAMISMATCH,
                                                 ADD_SUCCESS,
                                                 ArrowMultiReadScorer)
from pbccs_tpu_torch.poa.sparse import PoaAlignmentSummary, SparsePoa
from pbccs_tpu_torch.resilience import resources
from pbccs_tpu_torch.runtime import timing

_log = logging.getLogger(__name__)

# Local-context adapter flags (reference pbbam LocalContextFlags; a subread is
# a full pass iff it is flanked by adapter hits on both sides).
ADAPTER_BEFORE = 1
ADAPTER_AFTER = 2

_reg = default_registry()

# every entry into the batch-polish core (capacity splits and their
# parts re-enter)
_m_polish_dispatches = _reg.counter(
    "ccs_polish_dispatches_total",
    "polish_prepared_batch dispatches (incl. sub-dispatch re-entries)")


def record_zmw_failure(stage: str, exc: BaseException,
                       zmw: str | None = None) -> None:
    """Account one absorbed per-ZMW/per-batch exception: the class and
    traceback go to the log and ccs_zmw_failures_total{stage,exc}
    increments."""
    _reg.counter("ccs_zmw_failures_total",
                 "Exceptions absorbed by per-ZMW fault isolation",
                 stage=stage, exc=type(exc).__name__).inc()
    where = f"{stage}[{zmw}]" if zmw else stage
    tb = "".join(traceback.format_exception(type(exc), exc,
                                            exc.__traceback__))
    # strings only: a log record that kept `exc` would keep its traceback,
    # and with it the failed dispatch's tensors, for as long as a handler
    # holds the record
    _log.warning("%s: absorbed %s: %s\n%s", where, type(exc).__name__,
                 str(exc), tb)


@dataclasses.dataclass(frozen=True)
class ConsensusSettings:
    """Pipeline knobs, reference defaults
    (reference include/pacbio/ccs/Consensus.h:86-111)."""

    max_poa_coverage: int = 1024
    min_length: int = 10
    min_passes: int = 3
    min_snr: float = 4.0  # CLI-level gate in the reference (ccs.cpp:441)
    min_predicted_accuracy: float = 0.90
    min_zscore: float = -5.0
    max_drop_fraction: float = 0.34
    refine: RefineOptions = dataclasses.field(default_factory=RefineOptions)
    # polish model family: "arrow" (the ccs default) or "quiver" (the
    # QV-feature model; the reference carries both behind one templated
    # refine/QV implementation, Consensus.hpp:64-79).  Subreads carry no
    # QV tracks here, so Quiver polishes with flat default tracks.
    model: str = "arrow"
    # quarantined poison ZMWs (batch AND serial polish failed) emit a
    # draft-only consensus (capped QVs, `df` tag) instead of dropping as
    # Failure.OTHER (resilience.quarantine; off = reference parity)
    degrade_quarantined: bool = False


@dataclasses.dataclass
class Subread:
    """One subread of a ZMW (reference ReadType, Consensus.h:115-124)."""

    id: str
    seq: np.ndarray  # int8 base codes
    flags: int = ADAPTER_BEFORE | ADAPTER_AFTER
    read_accuracy: float = 0.8

    @classmethod
    def from_str(cls, id: str, seq: str, **kw) -> "Subread":
        return cls(id, encode_bases(seq), **kw)

    @property
    def is_full_pass(self) -> bool:
        return bool(self.flags & ADAPTER_BEFORE) and bool(self.flags & ADAPTER_AFTER)


@dataclasses.dataclass
class Chunk:
    """All subreads of one ZMW (reference ChunkType, Consensus.h:126-133)."""

    id: str
    reads: list[Subread]
    snr: np.ndarray  # (4,) per-channel SNR, ACGT order


class Failure(enum.Enum):
    """Yield categories (reference ResultType, Consensus.h:155-208)."""

    SUCCESS = "Success"
    POOR_SNR = "PoorSNR"
    NO_SUBREADS = "NoSubreads"
    TOO_SHORT = "TooShort"
    TOO_MANY_UNUSABLE = "TooManyUnusable"
    TOO_FEW_PASSES = "TooFewPasses"
    NON_CONVERGENT = "NonConvergent"
    POOR_QUALITY = "PoorQuality"
    OTHER = "Other"


@dataclasses.dataclass
class ConsensusResult:
    """One CCS read (reference ConsensusType, Consensus.h:135-153)."""

    id: str
    sequence: str
    qvs: np.ndarray
    num_passes: int
    predicted_accuracy: float
    global_zscore: float
    avg_zscore: float
    zscores: np.ndarray
    status_counts: list[int]
    mutations_tested: int
    mutations_applied: int
    snr: np.ndarray
    elapsed_ms: float
    # the unpolished POA draft of a quarantined ZMW (QVs capped)
    draft_only: bool = False

    @property
    def qualities(self) -> str:
        """Phred+33 ASCII, clamped to [0, 93]
        (reference QVsToASCII, Consensus.h:328-339)."""
        return "".join(chr(min(max(0, int(q)), 93) + 33) for q in self.qvs)


@dataclasses.dataclass
class ResultTally:
    """Mutable per-batch yield counters + results."""

    results: list[ConsensusResult] = dataclasses.field(default_factory=list)
    counts: dict[Failure, int] = dataclasses.field(
        default_factory=lambda: {f: 0 for f in Failure})

    def tally(self, failure: Failure) -> None:
        self.counts[failure] += 1

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def merge(self, other: "ResultTally") -> None:
        self.results.extend(other.results)
        for f, c in other.counts.items():
            self.counts[f] += c


def filter_reads(reads: Sequence[Subread], min_length: int
                 ) -> list[Subread | None]:
    """Median-length window filter + full-pass-first priority sort.

    Returns the reads (or None for dropped ones) sorted so that full-pass
    reads closest to the median length come first.  Parity: reference
    FilterReads (Consensus.h:224-292): median over full-pass lengths (else
    the longest read), drop reads >= 2*median, return nothing when the
    median itself is < min_length."""
    if not reads:
        return []

    lengths = [len(r.seq) for r in reads if r.is_full_pass]
    longest = max(len(r.seq) for r in reads)
    median = float(np.median(lengths)) if lengths else float(longest)
    max_len = 2.0 * median

    if median < float(min_length):
        return []

    def lex_key(r: Subread | None):
        if r is None:
            return (-1.0, -1.0)  # sorts last
        l = float(len(r.seq))  # noqa: E741
        v = min(l / median, median / l)
        return (v, 0.0) if r.is_full_pass else (0.0, v)

    # non-ACGT codes and empty reads are unusable (they desync sequence vs
    # QV lengths downstream, or divide by zero in the sort key)
    kept: list[Subread | None] = [
        r if 0 < len(r.seq) < max_len and bool((r.seq < 4).all()) else None
        for r in reads]
    kept.sort(key=lex_key, reverse=True)
    return kept


def poa_consensus(reads: Sequence[Subread | None], max_poa_coverage: int
                  ) -> tuple[np.ndarray, list[int], list[PoaAlignmentSummary]]:
    """Draft consensus via sparse POA: (consensus codes, per-read keys
    (-1 = unadded), summaries).  Parity: reference PoaConsensus
    (Consensus.h:352-390) including minCov = 1 if cov < 5 else
    (cov+1)/2 - 1."""
    poa = SparsePoa()
    keys: list[int] = []
    cov = 0
    for r in reads:
        if r is None:
            keys.append(-1)
            continue
        key = poa.orient_and_add_read(r.seq)
        keys.append(key)
        if key >= 0:
            cov += 1
            if cov >= max_poa_coverage:
                break
    min_cov = 1 if cov < 5 else (cov + 1) // 2 - 1
    css, summaries = poa.find_consensus(min_cov)
    return css, keys, summaries


@dataclasses.dataclass
class MappedRead:
    """A subread clipped to its POA extents, oriented onto the draft
    (reference ExtractMappedRead, Consensus.h:296-325)."""

    id: str
    seq: np.ndarray
    strand: int  # 0 = forward, 1 = reverse-complemented
    tpl_start: int
    tpl_end: int
    is_full_pass: bool


def extract_mapped_read(read: Subread, summary: PoaAlignmentSummary,
                        min_length: int) -> MappedRead | None:
    rs, re_ = summary.extent_on_read
    ts, te = summary.extent_on_consensus
    if rs > re_ or re_ - rs < min_length:
        return None
    if summary.reverse_complemented:
        # extents are in oriented-read (revcomp) coordinates; the scorer
        # aligns the NATIVE read against the reverse-complement template
        # window tpl_r[L-te : L-ts], whose native-frame slice is below
        n = len(read.seq)
        seq = read.seq[n - re_: n - rs]
        strand = 1
    else:
        seq = read.seq[rs:re_]
        strand = 0
    return MappedRead(read.id, seq, strand, ts, te, read.is_full_pass)


@dataclasses.dataclass
class PreparedZmw:
    """One ZMW past the filter/draft/mapping stages, ready to polish."""

    chunk: Chunk
    css: np.ndarray
    mapped: list[MappedRead]
    n_candidates: int
    n_unmappable: int
    prep_ms: float


def prepare_chunk(chunk: Chunk, settings: ConsensusSettings
                  ) -> tuple[Failure | None, PreparedZmw | None]:
    """Filter -> POA draft -> read mapping (the host stages of the per-ZMW
    pipeline, reference Consensus.h:396-434)."""
    t0 = time.monotonic()
    if float(np.min(chunk.snr)) < settings.min_snr:
        return Failure.POOR_SNR, None

    with obs_trace.span("filter", zmw=chunk.id):
        reads = filter_reads(chunk.reads, settings.min_length)
    if not reads or all(r is None for r in reads):
        return Failure.NO_SUBREADS, None

    with obs_trace.span("draft", zmw=chunk.id):
        with timing.stage("draft.poa"):
            css, keys, summaries = poa_consensus(reads,
                                                 settings.max_poa_coverage)
        if len(css) < settings.min_length:
            return Failure.TOO_SHORT, None

        mapped: list[MappedRead] = []
        n_unmappable = 0
        with timing.stage("draft.map"):
            for r, k in zip(reads, keys):
                if r is None or k < 0:
                    continue
                mr = extract_mapped_read(r, summaries[k],
                                         settings.min_length)
                if mr is None:
                    n_unmappable += 1
                    continue
                mapped.append(mr)

    n_candidates = sum(1 for k in keys if k >= 0)
    if not mapped:
        return Failure.NO_SUBREADS, None
    prep_ms = (time.monotonic() - t0) * 1e3
    return None, PreparedZmw(chunk, css, mapped, n_candidates, n_unmappable,
                             prep_ms)


def _read_gates(prep: PreparedZmw, statuses: np.ndarray,
                settings: ConsensusSettings
                ) -> tuple[Failure | None, list[int], int]:
    """Post-AddRead yield gates (reference Consensus.h:437-471): returns
    (failure or None, per-status counts, usable full passes)."""
    status_counts = [0] * 5
    n_passes = 0
    n_dropped = prep.n_unmappable
    for i, m in enumerate(prep.mapped):
        st = int(statuses[i])
        status_counts[st] += 1
        if st == ADD_SUCCESS and m.is_full_pass:
            n_passes += 1
        elif st != ADD_SUCCESS:
            n_dropped += 1

    if n_passes < settings.min_passes:
        return Failure.TOO_FEW_PASSES, status_counts, n_passes
    if prep.n_candidates > 0 and \
            n_dropped / prep.n_candidates > settings.max_drop_fraction:
        return Failure.TOO_MANY_UNUSABLE, status_counts, n_passes
    return None, status_counts, n_passes


def _finish_zmw(prep: PreparedZmw, settings: ConsensusSettings,
                tpl: np.ndarray, qvs: np.ndarray, refine,
                zscores: np.ndarray, global_z: float,
                status_counts: list[int], n_passes: int,
                elapsed_ms: float) -> tuple[Failure, ConsensusResult | None]:
    """Post-polish yield gates + result assembly
    (reference Consensus.h:497-553)."""
    if not refine.converged:
        return Failure.NON_CONVERGENT, None

    pred_acc = predicted_accuracy(qvs)
    if pred_acc < settings.min_predicted_accuracy:
        return Failure.POOR_QUALITY, None

    sequence = decode_bases(tpl)
    if len(sequence) != len(qvs):  # invalid bases reached the template
        return Failure.OTHER, None

    zs = zscores[np.isfinite(zscores)]
    avg_z = float(zs.mean()) if len(zs) else float("nan")
    return Failure.SUCCESS, ConsensusResult(
        id=prep.chunk.id,
        sequence=sequence,
        qvs=qvs,
        num_passes=n_passes,
        predicted_accuracy=pred_acc,
        global_zscore=global_z,
        avg_zscore=avg_z,
        zscores=zscores.copy(),
        status_counts=status_counts,
        mutations_tested=refine.n_tested,
        mutations_applied=refine.n_applied,
        snr=np.asarray(prep.chunk.snr),
        elapsed_ms=elapsed_ms)


def polish_prepared_quiver(prep: PreparedZmw, settings: ConsensusSettings,
                           device) -> tuple[Failure, ConsensusResult | None]:
    """Quiver-model polish of a prepared ZMW: gates -> refine -> QVs ->
    finish, through the generic refine loop and QV sweep over
    QuiverMultiReadScorer.  Quiver has no closed-form Z-score moments (an
    Arrow construct), so the z-score fields are NaN and the z-score gate
    is vacuous, as in the JAX package."""
    from pbccs_tpu_torch.models.quiver.features import flat_default_features
    from pbccs_tpu_torch.models.quiver.scorer import QuiverMultiReadScorer

    t0 = time.monotonic()
    scorer = QuiverMultiReadScorer(
        prep.css, [flat_default_features(m.seq) for m in prep.mapped],
        [m.strand for m in prep.mapped], [m.tpl_start for m in prep.mapped],
        [m.tpl_end for m in prep.mapped], device=device)

    failure, status_counts, n_passes = _read_gates(prep, scorer.statuses,
                                                   settings)
    if failure is not None:
        return failure, None

    refine = refine_consensus(scorer, settings.refine)
    if not refine.converged:
        return Failure.NON_CONVERGENT, None
    qvs = consensus_qvs(scorer)
    elapsed_ms = prep.prep_ms + (time.monotonic() - t0) * 1e3
    nan_zs = np.full(scorer.n_reads, np.nan)
    return _finish_zmw(prep, settings, scorer.tpl, qvs, refine, nan_zs,
                       float("nan"), status_counts, n_passes, elapsed_ms)


def polish_prepared(prep: PreparedZmw, settings: ConsensusSettings, *,
                    device=None) -> tuple[Failure, ConsensusResult | None]:
    """The serial polish half of the per-ZMW pipeline, given an already
    prepared ZMW: ArrowMultiReadScorer (which owns its 2x band retry) ->
    gates -> refine -> QVs -> finish, or the Quiver polish."""
    dev = resolve_device(device)
    if settings.model == "quiver":
        return polish_prepared_quiver(prep, settings, dev)
    t0 = time.monotonic()
    scorer = ArrowMultiReadScorer(
        prep.css, prep.chunk.snr, [m.seq for m in prep.mapped],
        [m.strand for m in prep.mapped], [m.tpl_start for m in prep.mapped],
        [m.tpl_end for m in prep.mapped], min_zscore=settings.min_zscore,
        device=dev)

    failure, status_counts, n_passes = _read_gates(prep, scorer.statuses,
                                                   settings)
    if failure is not None:
        return failure, None

    global_z = scorer.global_zscore()
    refine = refine_consensus(scorer, settings.refine)
    if not refine.converged:
        return Failure.NON_CONVERGENT, None
    qvs = scorer.consensus_qvs()
    elapsed_ms = prep.prep_ms + (time.monotonic() - t0) * 1e3
    return _finish_zmw(prep, settings, scorer.tpl, qvs, refine,
                       scorer.zscores, global_z, status_counts, n_passes,
                       elapsed_ms)


def process_chunk(chunk: Chunk, settings: ConsensusSettings | None = None, *,
                  device=None) -> tuple[Failure, ConsensusResult | None]:
    """The per-ZMW pipeline (reference Consensus, Consensus.h:396-553),
    serial polish."""
    settings = settings or ConsensusSettings()
    failure, prep = prepare_chunk(chunk, settings)
    if failure is not None:
        return failure, None
    return polish_prepared(prep, settings, device=device)


def _polish_tasks(preps: Sequence[PreparedZmw]) -> list:
    """The ZmwTask batch of a prepared ZMW sequence."""
    from pbccs_tpu_torch.parallel.batch import ZmwTask

    return [ZmwTask(p.chunk.id, p.css, np.asarray(p.chunk.snr),
                    [m.seq for m in p.mapped],
                    [m.strand for m in p.mapped],
                    [m.tpl_start for m in p.mapped],
                    [m.tpl_end for m in p.mapped]) for p in preps]


def prebake_polish(preps: Sequence[PreparedZmw]):
    """The polish's host marshalling of a prepared batch, built on the
    PREPARE side: its ZmwTask batch and bucket-shaped numpy planes
    (parallel.batch.premarshal).  The scheduled pipeline's prepare
    threads run this while the device worker polishes earlier batches;
    pass the result to polish_prepared_batch(prebaked=...).  Numpy only:
    no CUDA tensor is made off the device worker."""
    from pbccs_tpu_torch.parallel.batch import premarshal

    return premarshal(_polish_tasks(preps))


def _polish_batch_arrow(preps: Sequence[PreparedZmw],
                        settings: ConsensusSettings, device, *,
                        buckets: tuple[int, ...] | None = None,
                        prebaked=None
                        ) -> list[tuple[Failure, ConsensusResult | None]]:
    """One lockstep BatchPolisher over `preps` (shapes at least
    `buckets` = (Imax, Jmax, R[, Z])), outcomes ALIGNED with `preps`.  Raises
    on any batch-path failure: polish_prepared_batch handles it."""
    from pbccs_tpu_torch.parallel.batch import BatchPolisher

    t0 = time.monotonic()
    tasks = prebaked.tasks if prebaked is not None else _polish_tasks(preps)
    with obs_trace.span("polish.setup", zmws=len(preps)):
        polisher = BatchPolisher(tasks, min_zscore=settings.min_zscore,
                                 buckets=buckets, device=device,
                                 prebaked=prebaked)
    gate_info = [_read_gates(p, polisher.statuses[z], settings)
                 for z, p in enumerate(preps)]
    # ZMWs that shed reads to the alpha/beta mating gate retry in ONE
    # wider-band (2x) sub-batch.  Keep-better-width per ZMW: a ZMW polishes
    # at the wide band iff it MATES more reads there (status !=
    # ALPHABETAMISMATCH; the reference rebands to achieve alpha/beta
    # agreement first and applies the z-score gate to whatever mated,
    # SimpleRecursor.cpp:642-691).  Otherwise it stays in the narrow batch
    # with its drops.
    reband = sorted(z for z, p in enumerate(preps)
                    if (polisher.statuses[z, : len(p.mapped)]
                        == ADD_ALPHABETAMISMATCH).any())
    wide = None
    wide_pick: dict[int, int] = {}
    if reband:
        wcfg = dataclasses.replace(
            polisher.config,
            banding=dataclasses.replace(polisher.config.banding,
                                        band_width=2 * polisher._W))
        wide = BatchPolisher([tasks[z] for z in reband], config=wcfg,
                             min_zscore=settings.min_zscore,
                             buckets=(polisher._Imax, polisher._Jmax,
                                      polisher._R),
                             device=device)
        for i, z in enumerate(reband):
            nr = len(preps[z].mapped)
            n_narrow = int((polisher.statuses[z, :nr]
                            != ADD_ALPHABETAMISMATCH).sum())
            n_wide = int((wide.statuses[i, :nr]
                          != ADD_ALPHABETAMISMATCH).sum())
            if n_wide > n_narrow:
                wide_pick[z] = i
                gate_info[z] = _read_gates(preps[z], wide.statuses[i],
                                           settings)
        _log.debug("band retry: %d ZMW(s) had mating failures at W=%d; %d "
                   "adopted the 2x band", len(reband), polisher._W,
                   len(wide_pick))
    # gate-failed ZMWs take no part in refinement/QV
    gate_failed = {z for z, g in enumerate(gate_info) if g[0] is not None}
    skip = gate_failed | set(wide_pick)
    # z-score statistics describe the draft template (serial-path parity)
    global_zs = polisher.global_zscores()
    with obs_trace.span("polish.refine", zmws=len(preps) - len(skip)):
        refine_results = polisher.refine(settings.refine, skip=skip)
    wide_refine = wide_qvs = wide_gz = None
    if wide_pick:
        live_wide = {wi for z, wi in wide_pick.items() if z not in gate_failed}
        wide_skip = set(range(wide.n_zmws)) - live_wide
        wide_gz = wide.global_zscores()
        wide_refine = wide.refine(settings.refine, skip=wide_skip)
        wide_qvs = wide.consensus_qvs(
            skip=wide_skip | {i for i, r in enumerate(wide_refine)
                              if not r.converged})
    # non-converged ZMWs are discarded by _finish_zmw: no QVs for them
    skip = skip | {z for z, r in enumerate(refine_results)
                   if not r.converged}
    with obs_trace.span("polish.qv", zmws=len(preps) - len(skip)):
        qvs = polisher.consensus_qvs(skip=skip)
    polish_s = time.monotonic() - t0
    timing.add_stage("polish", polish_s)
    polish_ms = polish_s * 1e3 / max(len(preps), 1)

    outcomes: list[tuple[Failure, ConsensusResult | None]] = []
    for z, p in enumerate(preps):
        failure, status_counts, n_passes = gate_info[z]
        if failure is not None:
            outcomes.append((failure, None))
            continue
        nr = len(p.mapped)
        if z in wide_pick:
            i = wide_pick[z]
            outcomes.append(_finish_zmw(
                p, settings, wide.tpls[i], wide_qvs[i], wide_refine[i],
                wide.zscores[i, :nr], wide_gz[i], status_counts, n_passes,
                p.prep_ms + polish_ms))
        else:
            outcomes.append(_finish_zmw(
                p, settings, polisher.tpls[z], qvs[z], refine_results[z],
                polisher.zscores[z, :nr], global_zs[z], status_counts,
                n_passes, p.prep_ms + polish_ms))
    return outcomes


def prepare_batch(chunks: Sequence[Chunk],
                  settings: ConsensusSettings | None = None
                  ) -> tuple[ResultTally, list[PreparedZmw]]:
    """The host half of a batch: every chunk through filter -> POA draft
    -> mapping, with per-ZMW fault isolation (an exception is logged and
    tallied as Other, reference Consensus.h:543-548) and the prep.zmw
    fault site.  Returns (tally of prep-stage outcomes, survivors ready to
    polish)."""
    from pbccs_tpu_torch.resilience import faults

    settings = settings or ConsensusSettings()
    tally = ResultTally()
    preps: list[PreparedZmw] = []
    with timing.stage("draft"):
        for chunk in chunks:
            try:
                faults.maybe_fail("prep.zmw", keys=[chunk.id])
                failure, prep = prepare_chunk(chunk, settings)
            except Exception as e:  # noqa: BLE001 -- per-ZMW isolation
                record_zmw_failure("prepare", e, zmw=chunk.id)
                tally.tally(Failure.OTHER)
                continue
            if failure is not None:
                tally.tally(failure)
            else:
                preps.append(prep)
    return tally, preps


def _pinned_batch_shapes(preps: Sequence[PreparedZmw],
                         buckets: tuple[int, int, int] | None
                         ) -> tuple[int, int, int]:
    """The (Imax, Jmax, R) the full batch polishes at: quarantine
    sub-dispatches pin to these (and to the batch's Z), so (the band
    width being a function of the Jmax bucket) the surviving ZMWs come
    out byte-identical; capacity-split parts pin to these with a Z of
    their own, the memory relief."""
    from pbccs_tpu_torch.parallel.batch import effective_shapes

    imax, jmax, r, _ = effective_shapes(
        len(preps), max(len(p.mapped) for p in preps),
        max((len(m.seq) for p in preps for m in p.mapped), default=8),
        max(len(p.css) for p in preps), buckets=buckets)
    return imax, jmax, r


def _guarded_dispatch(preps: Sequence[PreparedZmw],
                      settings: ConsensusSettings, device, *,
                      buckets: tuple[int, ...] | None, prebaked=None
                      ) -> list[tuple[Failure, ConsensusResult | None]]:
    """One fault-domain batch dispatch: the chaos fault site
    ("polish.dispatch", keyed by ZMW ids so a spec can poison one ZMW)
    inside the hang watchdog (ambient deadline: --polishTimeout /
    PBCCS_WATCHDOG_S; off by default) inside a bounded retry on
    transient errors.  A watchdog timeout is never retried -- a hang is
    not transient; the quarantine path isolates it instead -- and no
    device error is (retry.is_transient_device_error)."""
    from pbccs_tpu_torch.resilience import faults, retry, watchdog

    ids = [p.chunk.id for p in preps]
    # only the scheduled pipeline's full-batch dispatch carries a prebake
    extra = {} if prebaked is None else {"prebaked": prebaked}

    def dispatch():
        # the fault site sits INSIDE the watchdog scope: an injected
        # delay exercises exactly the hung-dispatch recovery path
        faults.maybe_fail("polish.dispatch", keys=ids)
        return _polish_batch_arrow(preps, settings, device, buckets=buckets,
                                   **extra)

    def attempt():
        return watchdog.run_with_deadline(dispatch, site="polish.dispatch")

    return retry.DEVICE_RETRY.run(
        attempt,
        retry_on=lambda e: not isinstance(e, watchdog.WatchdogTimeout)
        and retry.is_transient_device_error(e),
        site="polish.dispatch")


ON_ERROR = ("bisect", "serial")


def polish_prepared_batch(preps: Sequence[PreparedZmw],
                          settings: ConsensusSettings | None = None, *,
                          device=None,
                          buckets: tuple[int, ...] | None = None,
                          on_error: str = "bisect",
                          raise_device_shaped: bool = False,
                          prebaked=None
                          ) -> list[tuple[Failure, ConsensusResult | None]]:
    """Polish prepared ZMWs in one lockstep BatchPolisher; outcomes
    ALIGNED with `preps`.

    The dispatch is guarded (_guarded_dispatch: fault site, watchdog,
    transient retry).  A failure is classified capacity first, then
    device, then task:

      * capacity (resources.is_capacity_error: a CUDA OOM, an injected
        `oom`): never retried at the same shape and never quarantined --
        the batch splits Z -> Z/2 at the parent's pinned (Imax, Jmax, R),
        the MemoryGovernor records a ceiling for this (device, bucket),
        and later batches of the bucket are pre-split at admission;
      * device (device.is_device_error: a kernel build, load or launch
        failure, a sticky CUDA error): re-raised;
      * task: recovered by `on_error` -- "bisect" (default) isolates the
        k poison ZMW(s) in O(k log Z) re-dispatches pinned to the
        parent's shapes, "serial" re-runs every ZMW through the serial
        polish.  Either way an isolated ZMW whose serial rescue fails
        too is quarantined (resilience.quarantine).

    `raise_device_shaped=True` (the device fleet's FIRST attempt at a
    batch) also re-raises a WatchdogTimeout or a RetriesExhausted instead
    of bisecting on the device that just hung, so the DevicePool can
    strike it and requeue the whole batch to a healthy one.

    `prebaked`: a PrebakedBatch from prebake_polish (built on a prepare
    thread), adopted by the full-batch dispatch only -- capacity parts,
    bisection sub-dispatches and serial rescues marshal their own.

    Quiver ZMWs polish one by one with per-ZMW isolation."""
    if on_error not in ON_ERROR:
        raise ValueError(f"on_error must be one of {ON_ERROR}, "
                         f"got {on_error!r}")
    settings = settings or ConsensusSettings()
    dev = resolve_device(device)
    if not preps:
        return []
    _m_polish_dispatches.inc()
    if settings.model == "quiver":
        return [_isolated(lambda p=p: polish_prepared(p, settings,
                                                      device=dev),
                          "polish.quiver", p.chunk.id) for p in preps]
    pin = _pinned_batch_shapes(preps, buckets)
    cap = resources.default_governor().cap(
        resources.shape_bucket(*pin), device=resources.current_device())
    if cap is not None and len(preps) > cap:
        # admission pre-split: the governor already learned this bucket
        # runs out of memory past `cap` ZMWs on this device -- dispatch
        # ceiling-sized parts pinned to the parent's (Imax, Jmax, R)
        # instead of paying the OOM again
        resources.note_presplit()
        _log.info("memory governor: pre-splitting batch of %d ZMW(s) at "
                  "ceiling %d (bucket %s)", len(preps), cap, pin)
        out: list[tuple[Failure, ConsensusResult | None]] = []
        start = 0
        for size in resources.split_sizes(len(preps), cap):
            out.extend(_polish_split_part(
                preps[start:start + size], settings, dev, pin,
                on_error=on_error, raise_device_shaped=raise_device_shaped))
            start += size
        return out
    return _polish_guarded(preps, settings, dev, buckets=buckets, pin=pin,
                           on_error=on_error,
                           raise_device_shaped=raise_device_shaped,
                           prebaked=prebaked)


def _polish_split_part(preps: Sequence[PreparedZmw],
                       settings: ConsensusSettings, device, pin, *,
                       on_error: str, raise_device_shaped: bool = False
                       ) -> list[tuple[Failure, ConsensusResult | None]]:
    """One part of a capacity split or an admission pre-split: pinned to
    the parent's (Imax, Jmax, R) bucket (the band width is the parent's;
    the smaller Z is the memory relief), with the full recovery (further
    capacity splits, quarantine, serial rescue)."""
    return _polish_guarded(preps, settings, device, buckets=pin, pin=pin,
                           on_error=on_error,
                           raise_device_shaped=raise_device_shaped)


def _capacity_split(preps: Sequence[PreparedZmw],
                    settings: ConsensusSettings, device, pin, *,
                    on_error: str, note: resources.CapacityError,
                    raise_device_shaped: bool = False
                    ) -> list[tuple[Failure, ConsensusResult | None]]:
    """Recovery from a capacity failure at batch size Z: record the
    governor ceiling (Z // 2 for this device and bucket) and re-dispatch
    the two halves at the pinned bucket shapes, each with the full
    recovery (further splits, quarantine).  A singleton that alone does
    not fit gets the serial rescue (its last chance), then quarantines
    -- never a same-shape retry, never a bisection tour over healthy
    ZMWs.  Called after the failed dispatch's exception is gone (`note`
    keeps its type and message), so the halves do not run beside the
    failed attempt's tensors."""
    from pbccs_tpu_torch.resilience import quarantine

    resources.default_governor().record_oom(
        resources.shape_bucket(*pin), len(preps))
    if len(preps) == 1:
        return [quarantine.serial_rescue(preps[0], settings, note,
                                         device=device)]
    resources.note_oom_split()
    mid = len(preps) // 2
    out: list[tuple[Failure, ConsensusResult | None]] = []
    for sub in (preps[:mid], preps[mid:]):
        out.extend(_polish_split_part(
            sub, settings, device, pin, on_error=on_error,
            raise_device_shaped=raise_device_shaped))
    return out


def _polish_guarded(preps: Sequence[PreparedZmw],
                    settings: ConsensusSettings, device, *,
                    buckets: tuple[int, ...] | None, pin,
                    on_error: str, raise_device_shaped: bool = False,
                    prebaked=None
                    ) -> list[tuple[Failure, ConsensusResult | None]]:
    """One guarded dispatch with the failure classification of
    polish_prepared_batch (capacity -> split, device -> re-raise,
    task -> quarantine bisection or the serial fallback).  Bisection
    sub-dispatches run at this dispatch's (Imax, Jmax, R) and Z, so the
    surviving ZMWs come out bit for bit as from this dispatch."""
    from pbccs_tpu_torch.resilience import quarantine, retry, watchdog

    def split(sub, note):
        return _capacity_split(sub, settings, device, pin,
                               on_error=on_error, note=note,
                               raise_device_shaped=raise_device_shaped)

    try:
        return _guarded_dispatch(preps, settings, device, buckets=buckets,
                                 prebaked=prebaked)
    except Exception as e:  # noqa: BLE001 -- classified below
        if resources.is_capacity_error(e):
            record_zmw_failure("polish.capacity", e,
                               zmw=f"batch[{len(preps)}]")
            note = resources.CapacityError.of(e)
        elif is_device_error(e) or (raise_device_shaped and isinstance(
                e, (watchdog.WatchdogTimeout, retry.RetriesExhausted))):
            raise
        elif on_error == "serial":
            record_zmw_failure("polish.batch", e, zmw=f"batch[{len(preps)}]")
            return [quarantine.serial_rescue(p, settings, e, device=device)
                    for p in preps]
        else:
            z = max(len(preps), buckets[3] if buckets and len(buckets) > 3
                    else 0)
            return quarantine.isolate(
                preps,
                lambda sub: _guarded_dispatch(sub, settings, device,
                                              buckets=(*pin, z)),
                settings, e, on_capacity=split, device=device)
    return split(preps, note)


def _isolated(fn, stage: str, zmw: str
              ) -> tuple[Failure, ConsensusResult | None]:
    """fn() with per-ZMW fault isolation: an exception is logged and
    tallied as Other (reference Consensus.h:543-548); a device error that
    is not memory exhaustion is re-raised."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 -- per-ZMW isolation
        if not resources.is_capacity_error(e) and is_device_error(e):
            raise
        record_zmw_failure(stage, e, zmw=zmw)
        return Failure.OTHER, None


def process_chunks(chunks: Sequence[Chunk],
                   settings: ConsensusSettings | None = None,
                   batch_polish: bool = True, on_error: str = "bisect", *,
                   device=None) -> ResultTally:
    """Process a batch of ZMWs on `device` (default: the card; raises when
    there is none; `device="cpu"` runs the kernels' plain versions).

    With batch_polish (the default) Arrow ZMWs run the host stages per
    ZMW, then one lockstep polish of every survivor
    (polish_prepared_batch, with `on_error` its batch-failure recovery).
    Without it, and with the Quiver model, each ZMW runs the per-ZMW
    pipeline on its own; an exception is logged and tallied as Other and
    the batch continues (reference Consensus.h:543-548).  A device error
    is re-raised in every mode."""
    dev = resolve_device(device)
    settings = settings or ConsensusSettings()
    if not batch_polish or settings.model == "quiver":
        tally = ResultTally()
        for chunk in chunks:
            failure, result = _isolated(
                lambda c=chunk: process_chunk(c, settings, device=dev),
                "zmw", chunk.id)
            tally.tally(failure)
            if result is not None:
                tally.results.append(result)
        return tally
    tally, preps = prepare_batch(chunks, settings)
    if not preps:
        return tally
    with obs_trace.span("polish", zmws=len(preps)):
        outcomes = polish_prepared_batch(preps, settings, device=dev,
                                         on_error=on_error)
    for failure, result in outcomes:
        tally.tally(failure)
        if result is not None:
            tally.results.append(result)
    return tally
