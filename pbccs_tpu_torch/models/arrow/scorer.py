"""Per-read windows, alpha/beta fills, read statistics and the serial
multi-read mutation scorer of the polish stage.

Port of pbccs_tpu.models.arrow.scorer: the oriented template window of
each read, the batched alpha/beta fills (ops.fwdbwd_cuda, optionally
re-centered by argmax-guided refills), the alpha/beta mating test and
the closed-form log-likelihood moments behind the Z-score read gate
(reference ArrowMultiReadMutationScorer, MultiReadMutationScorer.cpp),
which the lockstep batch polisher runs on tensors with leading (Z, R) or
flat read axes; and ArrowMultiReadScorer, the per-ZMW scorer of the
serial polish (pipeline.polish_prepared, the quarantine's rescue).  Its
fills run on K1, its interior mutation scores on K3 and its edge
mutations as full K1 forward refills of the mutated windows."""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from pbccs_tpu_torch.device import is_device_error, resolve_device
from pbccs_tpu_torch.models.arrow import mutations as mutlib
from pbccs_tpu_torch.models.arrow.expectations import \
    per_base_mean_and_variance
from pbccs_tpu_torch.models.arrow.params import (ArrowConfig,
                                                 effective_band_width,
                                                 revcomp_padded,
                                                 snr_to_transition_table_host,
                                                 template_transition_params,
                                                 transition_lookup)
from pbccs_tpu_torch.obs import trace as obs_trace
from pbccs_tpu_torch.obs.metrics import default_registry
from pbccs_tpu_torch.ops import dense_score_cuda as dsc
from pbccs_tpu_torch.ops.fwdbwd import (MAX_BAND_ADVANCE, BandedMatrix,
                                        guided_band_offsets)
from pbccs_tpu_torch.ops.fwdbwd_cuda import (backward_batch,
                                             backward_loglik_batch,
                                             forward_backward_batch,
                                             forward_batch,
                                             forward_loglik_batch)
from pbccs_tpu_torch.ops.mutation_score import (MutationPatch, make_patches,
                                                mutated_windows_per_pair,
                                                scale_prefix, scale_suffix)
from pbccs_tpu_torch.utils import next_pow2

# AddRead outcome codes (reference Arrow/MultiReadMutationScorer.hpp:60-61).
ADD_SUCCESS, ADD_ALPHABETAMISMATCH, ADD_MEM_FAIL, ADD_POOR_ZSCORE, ADD_OTHER = range(5)

_AB_MISMATCH_TOL = 1e-3  # reference SimpleRecursor.cpp:53
_MAX_BAND_SHIFT = MAX_BAND_ADVANCE

# The port's counters of the guided refills: plain host adds over real
# reads, made at fetches the polish makes anyway.  pbccs_tpu counts none,
# so DESIGN.md's metrics table (its contract) lists neither (REG001).
_reg = default_registry()
# ccs-analyze: ignore[REG001] -- the port's own counter
m_guided_reads = _reg.counter(
    "ccs_fill_guided_reads_total",
    "Argmax-guided forward refills run: real reads x guided passes")
# ccs-analyze: ignore[REG001] -- the port's own counter
m_guided_kept = _reg.counter(
    "ccs_fill_guided_kept_total",
    "Guided refills kept: log-likelihood at least the fill's before")


def mated_mask(ll_a, ll_b, rlens, tstarts, tends) -> torch.Tensor:
    """Reads whose alpha/beta fills mate: |1 - LL_a/LL_b| within
    tolerance, both finite, and the read no longer than
    MAX_BAND_ADVANCE times its template window (insert-junk the
    reference also sheds, SimpleRecursor.cpp:683-688).  Tensors of
    matching shape, on the device (the JAX package's host mated_mask
    and batch._mated_mask_dev in one)."""
    ratio = ll_a / torch.where(ll_b == 0, 1.0, ll_b)
    mated = (1.0 - ratio).abs() <= _AB_MISMATCH_TOL
    mated &= torch.isfinite(ll_a) & torch.isfinite(ll_b)
    mated &= rlens <= _MAX_BAND_SHIFT * (tends - tstarts).clamp(min=1)
    return mated


def oriented_window(strand, ts, te, tpl_f, tpl_r, L, table):
    """Each read's oriented template window (bases, transitions, length).

    strand, ts, te (Z, R); tpl_f, tpl_r (Z, Jmax) forward and
    reverse-complement templates; L (Z,); table (Z, 8, 4).  Returns
    win_tpl (Z, R, Jmax) int8, win_trans (Z, R, Jmax, 4), wlen (Z, R).
    The transition track is recomputed from the window itself (equal to
    the full-template track inside the window)."""
    Z, R = strand.shape
    Jmax = tpl_f.shape[1]
    ws = torch.where(strand == 0, ts, L[:, None] - te)
    wlen = te - ts
    idx = torch.arange(Jmax, device=tpl_f.device)
    src = (ws[..., None] + idx).clamp(0, Jmax - 1)              # (Z, R, Jmax)
    both = torch.cat([tpl_f, tpl_r], dim=1).to(torch.int64)    # (Z, 2*Jmax)
    pick = torch.where(strand[..., None] == 0, src, src + Jmax)
    base = torch.gather(both, 1, pick.reshape(Z, -1)).reshape(Z, R, Jmax)
    win_tpl = torch.where(idx < wlen[..., None], base, 4)
    nxt = torch.roll(win_tpl, -1, dims=-1)
    params = transition_lookup(win_tpl.reshape(Z, -1), nxt.reshape(Z, -1),
                               table).reshape(Z, R, Jmax, 4)
    win_trans = torch.where((idx < wlen[..., None] - 1)[..., None], params,
                            0.0)
    return win_tpl.to(torch.int8), win_trans, wlen


def guided_fill_passes(jmax: int) -> int:
    """Argmax-guided refill ("flip-flop") passes after the diagonal-band
    fill at this template bucket: none up to 3 kb (the path drifts well
    inside W/2), one up to 8 kb, three beyond (the JAX package's
    schedule, from its drift model std ~ sqrt(2 p_indel L) rows).

    Env override PBCCS_GUIDED: integer pass count, or 0 to disable."""
    env = os.environ.get("PBCCS_GUIDED")
    if env is not None:
        return max(0, int(env))
    if jmax <= 3072:
        return 0
    return 1 if jmax <= 8192 else 3


class FillState(NamedTuple):
    """Banded alpha/beta fills of a read batch with their log-likelihoods
    and scale prefix (alpha) / suffix (beta), leaves (R, ...); `kept`
    counts per read the guided refills kept (int32, on the device), None
    where no guided pass ran."""

    alpha: BandedMatrix
    beta: BandedMatrix
    ll_a: torch.Tensor
    ll_b: torch.Tensor
    apre: torch.Tensor
    bsuf: torch.Tensor
    kept: torch.Tensor | None = None


def _fill_alpha(reads, rlens, win_tpl, win_trans, wlens, width, offsets):
    alpha = forward_batch(reads, rlens, win_tpl, win_trans, wlens, width,
                          offsets=offsets)
    return alpha, forward_loglik_batch(alpha, rlens, wlens)


def fill_alpha_beta_batch(reads, rlens, win_tpl, win_trans, wlens,
                          width: int, guided_passes: int = 0) -> FillState:
    """Batched alpha/beta fills + log-likelihoods + scale prefixes over a
    flat read batch (leading axis R), on the diagonal band layout.

    `guided_passes` > 0 re-centers the band on the alpha argmax path
    (fwdbwd.guided_band_offsets) and refills that many times, keeping per
    read whichever alpha has the better log-likelihood (never trade down:
    the first fill may have locked onto the right ridge).  Beta then runs
    on alpha's band.  Without guided passes both fills run on the diagonal
    band, in one K1 launch on the card.

    The refill loop is the `fill.guided` span (args `reads`, the rows of
    the batch, padding included, and `passes`); the count of refills kept
    per read stays on the device (FillState.kept) for the caller to read
    at a fetch it makes anyway."""
    kept = None
    if not guided_passes:
        alpha, beta = forward_backward_batch(reads, rlens, win_tpl,
                                             win_trans, wlens, width)
        ll_a = forward_loglik_batch(alpha, rlens, wlens)
    else:
        alpha, ll_a = _fill_alpha(reads, rlens, win_tpl, win_trans, wlens,
                                  width, None)
        # ccs-analyze: ignore[REG010] -- the port's own span (PORT_ONLY_SPANS)
        with obs_trace.span("fill.guided", reads=int(rlens.shape[0]),
                            passes=guided_passes):
            for _ in range(guided_passes):
                g_off = guided_band_offsets(alpha.vals, alpha.offsets, rlens,
                                            wlens, width)
                alpha_g, ll_g = _fill_alpha(reads, rlens, win_tpl, win_trans,
                                            wlens, width, g_off)
                keep = ll_g >= ll_a
                alpha = BandedMatrix(
                    torch.where(keep[:, None, None], alpha_g.vals,
                                alpha.vals),
                    torch.where(keep[:, None], alpha_g.offsets,
                                alpha.offsets),
                    torch.where(keep[:, None], alpha_g.log_scales,
                                alpha.log_scales))
                ll_a = torch.where(keep, ll_g, ll_a)
                kept = keep.to(torch.int32) if kept is None else kept + keep
        beta = backward_batch(reads, rlens, win_tpl, win_trans, wlens, width,
                              offsets=alpha.offsets)
    ll_b = backward_loglik_batch(beta, wlens)
    return FillState(alpha, beta, ll_a, ll_b, scale_prefix(alpha.log_scales),
                     scale_suffix(beta.log_scales), kept)


def fill_alpha_beta_batch_zr(reads, rlens, win_tpl, win_trans, wlens,
                             width: int, guided_passes: int = 0) -> FillState:
    """(Z, R)-leading fills: flattens to the (Z*R,) read batch so each
    fill runs as one kernel launch, then restores the (Z, R) axes."""
    Z, R = reads.shape[:2]
    flat = lambda a: a.reshape((Z * R,) + a.shape[2:])  # noqa: E731
    out = fill_alpha_beta_batch(flat(reads), flat(rlens), flat(win_tpl),
                                flat(win_trans), flat(wlens), width,
                                guided_passes=guided_passes)
    unflat = lambda a: a.reshape((Z, R) + a.shape[1:])  # noqa: E731
    return FillState(BandedMatrix(*map(unflat, out.alpha)),
                     BandedMatrix(*map(unflat, out.beta)),
                     unflat(out.ll_a), unflat(out.ll_b), unflat(out.apre),
                     unflat(out.bsuf),
                     None if out.kept is None else unflat(out.kept))


def count_guided(runs: int, kept: int) -> None:
    """Add guided refills run (real reads x passes) and kept to their
    counters, once their counts have reached the host."""
    m_guided_reads.inc(runs)
    m_guided_kept.inc(kept)


def window_moments(strand, ts, te, mean_f, var_f, mean_r, var_r, L):
    """(mu, var) of E[log-lik] over each read's window of the oriented
    template (closed-form HMM moments, Expectations.hpp:45).  strand, ts,
    te (Z, R); mean_*/var_* (Z, Jmax); L (Z,).  Uses the read's window on
    the oriented template, as the JAX package does (a documented
    deviation from the reference's forward-frame indexing,
    MultiReadMutationScorer.cpp:299-317)."""
    Lc = L[:, None]
    s = torch.where(strand == 0, ts, Lc - te)[..., None]
    e = torch.where(strand == 0, te, Lc - ts)[..., None]
    pos = torch.arange(mean_f.shape[1], device=mean_f.device)
    m = (pos >= s) & (pos < e - 1)
    fwd = (strand == 0)[..., None]
    mu = torch.where(m, torch.where(fwd, mean_f[:, None], mean_r[:, None]),
                     0.0).sum(-1)
    v = torch.where(m, torch.where(fwd, var_f[:, None], var_r[:, None]),
                    0.0).sum(-1)
    return mu, v


def _read_moments(strands, tstarts, tends, trans_f, trans_r, L):
    """Per-read (mu, var) over each read's oriented window."""
    mean_f, var_f = per_base_mean_and_variance(trans_f)
    mean_r, var_r = per_base_mean_and_variance(trans_r)
    return window_moments(strands, tstarts, tends, mean_f, var_f, mean_r,
                          var_r, L)


#: edge-pair refills per K1 forward launch: bounds the (E, nc, W) band
#: values of the serial scorer's edge refills to ~256 MiB
_EDGE_FILL_BYTES = 1 << 28


class ArrowMultiReadScorer:
    """Per-ZMW polish state (MultiReadMutationScorer equivalent), on
    `device` (default: the card; `device="cpu"` runs the kernels' plain
    versions).

    Reads come pre-mapped (strand + [tstart, tend) template window from
    the draft stage).  AddRead gating (alpha/beta mating, then the
    Z-score, reference MultiReadMutationScorer.cpp:276-325) runs at
    construction; outcomes are in `statuses`.  A scorer with mating
    failures rebuilds once at twice the band width and keeps the wider
    band only when it mates more reads."""

    _RETRY_SNAPSHOT = (
        "tpl_f", "trans_f", "tpl_r", "trans_r", "win_tpl", "win_trans",
        "wlens", "alpha", "beta", "a_prefix", "b_suffix", "baselines",
        "_ll_mu", "_ll_var")

    def __init__(self, tpl: np.ndarray, snr: np.ndarray, read_codes,
                 strands, tstarts, tends, config: ArrowConfig | None = None,
                 min_zscore: float = float("nan"), imax: int | None = None,
                 jmax: int | None = None, *, device=None):
        self.device = resolve_device(device)
        self.config = config or ArrowConfig()
        self.snr = np.asarray(snr, np.float64)
        self.tpl = np.asarray(tpl, np.int8)
        self.n_reads = len(read_codes)
        self.min_zscore = min_zscore

        R = next_pow2(self.n_reads, 4)
        self._R = R
        self._Imax = imax or next_pow2(max(len(r) for r in read_codes) + 8,
                                       64)
        self._Jmax = jmax or next_pow2(len(tpl) + 8, 64)
        self._W = effective_band_width(self.config.banding, self._Jmax)

        reads = np.full((R, self._Imax), 4, np.int8)
        self._rlens = np.zeros(R, np.int32)
        for i, rc in enumerate(read_codes):
            n = min(len(rc), self._Imax)
            reads[i, :n] = rc[:n]
            self._rlens[i] = n
        self._strands = np.zeros(R, np.int32)
        self._strands[: self.n_reads] = strands
        self._tstarts = np.zeros(R, np.int32)
        self._tstarts[: self.n_reads] = tstarts
        self._tends = np.zeros(R, np.int32)
        self._tends[: self.n_reads] = tends
        # padding rows: a trivial window keeps the fills finite
        for i in range(self.n_reads, R):
            self._rlens[i] = 2
            reads[i, :2] = [0, 0]
            self._tends[i] = min(2, len(tpl))
        self._reads_dev = self._dev(reads)
        self._rlens_dev = self._dev(self._rlens)
        self._strands_dev = self._dev(self._strands)

        self.trans_table = self._dev(
            snr_to_transition_table_host(self.snr).astype(np.float32))
        self.active = np.zeros(R, bool)
        self.statuses = np.full(self.n_reads, ADD_OTHER, np.int32)
        self.zscores = np.full(self.n_reads, np.nan)
        self.band_retried = False
        self.n_band_retries = 0

        self._rebuild(first=True)
        failed = self.statuses == ADD_ALPHABETAMISMATCH
        if failed.any():
            # one escalation of the whole scorer to a 2x band, kept only
            # when it MATES more reads (a wider band can lose in-column
            # dynamic range and unmate reads the narrow band kept); the
            # first build is restored otherwise
            snap = {k: getattr(self, k) for k in self._RETRY_SNAPSHOT}
            gates = (self.statuses.copy(), self.active.copy(),
                     self.zscores.copy())
            w0 = self._W
            n0 = int((self.statuses != ADD_ALPHABETAMISMATCH).sum())
            try:  # a speculative build: its failure keeps the narrow band
                self._W *= 2
                self._reset_gates()
                self._rebuild(first=True)
                better = int((self.statuses
                              != ADD_ALPHABETAMISMATCH).sum()) > n0
            except Exception as e:  # noqa: BLE001 -- but not the card's
                if is_device_error(e):
                    raise
                better = False
            if better:
                self.band_retried = True
                self.n_band_retries = int(
                    (failed & (self.statuses != ADD_ALPHABETAMISMATCH)).sum())
            else:
                self._W = w0
                for k, v in snap.items():
                    setattr(self, k, v)
                self.statuses, self.active, self.zscores = gates

    # ------------------------------------------------------------------ setup

    def _dev(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), device=self.device)

    def _reset_gates(self) -> None:
        self.statuses[:] = ADD_OTHER
        self.active[:] = False
        self.zscores[:] = np.nan

    def _rebuild(self, first: bool = False) -> None:
        """(Re)build windows + alpha/beta for all reads against self.tpl.
        On the first build, gate reads (mating + Z-score); on rebuilds
        after apply_mutations only the mating check can deactivate reads
        (reference MultiReadMutationScorer.cpp:237-267).  Device tensors
        carry a leading axis of one ZMW."""
        L = len(self.tpl)
        padded = np.full((1, self._Jmax), 4, np.int8)
        padded[0, :L] = self.tpl
        Lt = self._dev([L])
        table = self.trans_table[None]
        self.tpl_f = self._dev(padded)
        self.trans_f = template_transition_params(self.tpl_f, table, Lt)
        self.tpl_r = revcomp_padded(self.tpl_f, Lt)
        self.trans_r = template_transition_params(self.tpl_r, table, Lt)
        geo = (self._strands_dev[None], self._dev(self._tstarts)[None],
               self._dev(self._tends)[None])
        win_tpl, win_trans, wlens = oriented_window(
            *geo, self.tpl_f, self.tpl_r, Lt, table)
        self.win_tpl, self.win_trans, self.wlens = (win_tpl[0], win_trans[0],
                                                    wlens[0])
        passes = guided_fill_passes(self._Jmax)
        fill = fill_alpha_beta_batch(self._reads_dev, self._rlens_dev,
                                     self.win_tpl, self.win_trans,
                                     self.wlens, self._W, passes)
        self.alpha, self.beta = fill.alpha, fill.beta
        self.a_prefix, self.b_suffix = fill.apre, fill.bsuf
        mu, var = _read_moments(*geo, self.trans_f, self.trans_r, Lt)
        rows = [fill.ll_a, fill.ll_b, mu[0], var[0]]
        if fill.kept is not None:       # the refills kept ride on the fetch
            rows.append(fill.kept.to(fill.ll_b.dtype))
        host = torch.stack(rows).cpu().double().numpy()
        ll_a, ll_b, mu_h, var_h = host[:4]
        if fill.kept is not None:
            count_guided(self.n_reads * passes,
                         int(host[4, : self.n_reads].sum()))
        self.baselines = ll_b
        self._ll_mu, self._ll_var = mu_h, var_h
        t = lambda a: torch.as_tensor(a)  # noqa: E731
        mated = mated_mask(t(ll_a), t(ll_b), t(self._rlens),
                           t(self._tstarts), t(self._tends)).numpy()

        if first:
            z = (ll_b - mu_h) / np.sqrt(np.maximum(var_h, 1e-12))
            for i in range(self.n_reads):
                if not mated[i]:
                    self.statuses[i] = ADD_ALPHABETAMISMATCH
                    self.active[i] = False
                    continue
                self.zscores[i] = z[i]
                if not np.isnan(self.min_zscore) and (
                        not np.isfinite(z[i]) or z[i] < self.min_zscore):
                    self.statuses[i] = ADD_POOR_ZSCORE
                    self.active[i] = False
                else:
                    self.statuses[i] = ADD_SUCCESS
                    self.active[i] = True
        else:
            self.active[: self.n_reads] &= mated[: self.n_reads]
        self.active[self.n_reads:] = False

    # ------------------------------------------------------------- scoring

    def baseline_total(self) -> float:
        return float(self.baselines[self.active].sum())

    def global_zscore(self) -> float:
        """Z-score of the summed log-likelihood over all active reads
        (reference MultiReadMutationScorer::ZScores global statistic,
        Arrow/MultiReadMutationScorer.hpp:174-263)."""
        act = self.active
        if not act.any():
            return float("nan")
        var = self._ll_var[act].sum()
        if var <= 0:
            return float("nan")
        ll = self.baselines[act].sum()
        return float((ll - self._ll_mu[act].sum()) / np.sqrt(var))

    def score_mutations(self, muts) -> np.ndarray:
        """Sum over active overlapping reads of (LL(mutated) -
        LL(current)), in float64 on the host (reference
        MultiReadMutationScorer::Score, MultiReadMutationScorer.cpp:
        339-368, without the serial FastScore early exit).

        A (read, mutation) pair is interior when its window-frame start
        is >= 3 and its end <= window length - 2; interior pairs read
        K3's slot grid, the others are refilled in full on K1."""
        if not muts:
            return np.zeros(0)
        pos = np.array([m.start for m in muts], np.int32)
        end = np.array([m.end for m in muts], np.int32)
        mtype = np.array([m.mtype for m in muts], np.int32)
        base = np.array([m.new_base for m in muts], np.int32)

        ts = self._tstarts[:, None]
        te = self._tends[:, None]
        strand = self._strands[:, None]
        ms, me = pos[None, :], end[None, :]
        is_ins = (mtype == mutlib.INSERTION)[None, :]
        overlap = np.where(is_ins, (ts <= me) & (ms <= te),
                           (ts < me) & (ms < te))
        p_w = np.where(strand == 0, ms - ts, te - me)
        e_w = np.where(strand == 0, me - ts, te - ms)
        interior = (p_w >= 3) & (e_w <= (te - ts) - 2)
        valid = self.active[:, None] & overlap
        int_mask = valid & interior
        edge_mask = valid & ~interior

        abs_ll = np.zeros(int_mask.shape)
        if int_mask.any():
            abs_ll[int_mask] = self._interior_scores(
                int_mask, p_w, pos, mutlib.mutation_slot(mtype, base))
        totals = np.where(int_mask, abs_ll - self.baselines[:, None],
                          0.0).sum(axis=0)
        er, em = np.nonzero(edge_mask)
        if len(er):
            edge_ll = self._edge_scores(er, em, p_w[er, em], muts)
            np.add.at(totals, em, edge_ll - self.baselines[er])
        return totals

    def _interior_scores(self, int_mask, p_w, pos, slot) -> np.ndarray:
        """Absolute LLs of the interior (read, mutation) pairs, in
        np.nonzero(int_mask) order: one K3 launch over the ZMW's reads
        with only the 64-position window blocks that hold a requested
        pair live, its window grid mapped to the template frame."""
        r_idx, m_idx = np.nonzero(int_mask)
        live = np.zeros((self._R, -(-self._Jmax // dsc.PB)), bool)
        live[r_idx, p_w[r_idx, m_idx] // dsc.PB] = True
        tables = self.trans_table[None].expand(self._R, 8, 4)
        grid = dsc.dense_interior_scores_batch(
            self._reads_dev, self._rlens_dev, self.win_tpl, self.win_trans,
            self.wlens, tables, self.alpha, self.beta, self.a_prefix,
            self.b_suffix, self._W, live=self._dev(live))
        tgrid = dsc.window_grid_to_template(
            grid, self._strands_dev, self._dev(self._tstarts),
            self._dev(self._tends), self._Jmax)
        got = tgrid[self._dev(r_idx), self._dev(pos[m_idx]),
                    self._dev(slot[m_idx])]
        return got.cpu().double().numpy()

    def _patches(self, muts, idx) -> tuple[MutationPatch, MutationPatch]:
        """Template-frame patches of muts[idx] on the forward and the
        reverse-complement template."""
        L = len(self.tpl)
        sel = [muts[i] for i in idx]
        rcm = [mutlib.reverse_complement_mutation(m, L) for m in sel]
        mtype = self._dev(np.array([m.mtype for m in sel], np.int32))
        out = []
        for tpl, trans, ms in ((self.tpl_f, self.trans_f, sel),
                               (self.tpl_r, self.trans_r, rcm)):
            out.append(make_patches(
                tpl[0], trans[0], self.trans_table, L,
                self._dev(np.array([m.start for m in ms], np.int32)), mtype,
                self._dev(np.array([m.new_base for m in ms], np.int32))))
        return out[0], out[1]

    def _edge_scores(self, er, em, pp, muts) -> np.ndarray:
        """Absolute LLs of the edge (read, mutation) pairs: each pair's
        mutated window (template-frame patch, mutated_windows_per_pair)
        filled forward on K1 at the scorer's band width, in chunks."""
        uniq, inv = np.unique(em, return_inverse=True)
        pf, pr = self._patches(muts, uniq)
        inv_d = self._dev(inv)
        fwd = self._dev(self._strands[er] == 0)
        patch = MutationPatch(
            torch.where(fwd[:, None], pf.bases[inv_d], pr.bases[inv_d]),
            torch.where(fwd[:, None, None], pf.trans[inv_d],
                        pr.trans[inv_d]),
            torch.where(fwd, pf.shift[inv_d], pr.shift[inv_d]))
        mtype = self._dev(np.array([muts[i].mtype for i in em], np.int32))
        er_d, pp_d = self._dev(er), self._dev(pp)
        step = max(1, _EDGE_FILL_BYTES // ((self._Jmax + 1) * self._W * 4))
        out = []
        for lo in range(0, len(er), step):
            sl = slice(lo, lo + step)
            rows = er_d[sl]
            bases, trans, new_lens = mutated_windows_per_pair(
                self.win_tpl[rows], self.win_trans[rows], self.wlens[rows],
                pp_d[sl], mtype[sl], MutationPatch(*(x[sl] for x in patch)))
            alpha = forward_batch(self._reads_dev[rows],
                                  self._rlens_dev[rows], bases, trans,
                                  new_lens, self._W)
            out.append(forward_loglik_batch(alpha, self._rlens_dev[rows],
                                            new_lens))
        return torch.cat(out).cpu().double().numpy()

    # ------------------------------------------------------------- mutation

    def apply_mutations(self, muts) -> None:
        """Splice mutations into the template, remap read windows, refill
        (reference MultiReadMutationScorer::ApplyMutations,
        MultiReadMutationScorer.cpp:237-267)."""
        if not muts:
            return
        L = len(self.tpl)
        mtp = mutlib.target_to_query_positions(muts, L)
        self.tpl = mutlib.apply_mutations(self.tpl, muts)
        self._Jmax = next_pow2(len(self.tpl) + 8, 64)
        self._tstarts = mtp[np.clip(self._tstarts, 0, L)].astype(np.int32)
        self._tends = mtp[np.clip(self._tends, 0, L)].astype(np.int32)
        self._rebuild(first=False)

    # ------------------------------------------------------------------- QVs

    def consensus_qvs(self) -> np.ndarray:
        """Per-position QVs from single-base mutation scores, via the
        generic sweep (models.arrow.refine.consensus_qvs; reference
        ConsensusQVs, Consensus-inl.hpp:277-297)."""
        from pbccs_tpu_torch.models.arrow.refine import consensus_qvs

        return consensus_qvs(self)
