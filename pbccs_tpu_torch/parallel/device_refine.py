"""Device-resident refinement: enumeration, scoring, selection and splice
of the lockstep polish loop, as tensor programs over a (Z, ...) batch.

Port of pbccs_tpu.parallel.device_refine.  Every round of the loop runs
on the device: enumerate the position-major 9-slot candidate grid, score
it (interior slots by the K3 kernel, edge slots by the window-frame edge
programs), pick a greedy well-separated subset of the favorable
mutations, splice the templates, and rebuild the fills (K1).  The host
reads a few flags per round (loop end, re-buckets) and fetches the results
once at the end.  The JAX package's lax.while_loop / lax.cond become a
Python loop over device tensors.

Parity targets (held by the port's tests against pbccs_tpu):
  * slot_candidates: the host enumeration order (subs by base, ins by
    base, del per position); invalid slots are masked, never reordered;
  * greedy_well_separated_posmajor: greedy max-score subset with starts
    more than `separation` apart, ties to the earlier slot;
  * splice_templates: mutations.apply_mutations +
    target_to_query_positions (mtp[j] = j - dels(<j) + ins(<=j)).

Where the JAX device loop bails to its host loop, this loop handles the
case itself, as the host loop does: edge slots in a read window too
short for the window-frame program are scored by full refills of the
mutated window (K1), and a template that outgrows its bucket re-buckets
(batch._jmax_bucket) and the loop carries on at the larger Jmax.  The
JAX loop's straggler early exit (a TPU compile-menu device) is not
ported: per-ZMW results do not depend on it.  The flags and sizes the
host reads each round are blocking device-to-host copies; they go
through runtime.timing.device_fetch, which times them as device wait."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbccs_tpu_torch.models.arrow.mutations import (_LN10, _SLOT_BASES,
                                                    _SLOT_ENDOFF,
                                                    _SLOT_TYPES, DELETION,
                                                    INSERTION, QV_SATURATED,
                                                    SUBSTITUTION)
from pbccs_tpu_torch.ops.fwdbwd import BandedMatrix
from pbccs_tpu_torch.runtime.timing import device_fetch

N_SLOTS = 9
HISTORY = 48     # template-hash ring depth (cycle detection)
_HASH_MULT = 2654435761  # Knuth multiplicative constant (uint32)
_U32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# candidates, selection, splice
# --------------------------------------------------------------------------


def slot_grid(jmax: int, device):
    """(start, end, mtype, base), each (Jmax * 9,): the ZMW-independent
    geometry of the position-major slot grid in host enumeration order."""
    pos = torch.arange(jmax, device=device).repeat_interleave(N_SLOTS)
    t = lambda a: torch.as_tensor(a, device=device).repeat(jmax)  # noqa: E731
    return (pos, pos + t(_SLOT_ENDOFF), t(_SLOT_TYPES), t(_SLOT_BASES))


def slot_candidates(tpl: torch.Tensor, tlen: torch.Tensor,
                    allowed_pos: torch.Tensor | None = None) -> torch.Tensor:
    """(Z, Jmax * 9) validity of every slot of each padded template: a
    substitution must change the base, an insertion must differ from the
    previous base, a deletion must not sit inside a homopolymer run
    (unique single-base mutations), positions < tlen, and, in rounds > 0,
    the nearby-window filter `allowed_pos` (Z, Jmax)."""
    Z, Jmax = tpl.shape
    dev = tpl.device
    t = tpl.to(torch.int32)
    prev = torch.cat([torch.full((Z, 1), -1, dtype=torch.int32, device=dev),
                      t[:, :-1]], dim=1)
    sb = torch.as_tensor(_SLOT_BASES, device=dev)
    pos = torch.arange(Jmax, device=dev)
    valid = torch.cat([sb[None, None, :4] != t[..., None],
                       sb[None, None, 4:8] != prev[..., None],
                       (t != prev)[..., None]], dim=2)
    valid &= (pos[None, :] < tlen[:, None])[..., None]
    if allowed_pos is not None:
        valid &= allowed_pos[..., None]
    return valid.reshape(Z, Jmax * N_SLOTS)


def _shift(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """y[..., i] = x[..., i + d] along the last axis, `fill` past the ends."""
    pad = torch.full(x.shape[:-1] + (abs(d),), fill, dtype=x.dtype,
                     device=x.device)
    if d > 0:
        return torch.cat([x[..., d:], pad], dim=-1)
    return torch.cat([pad, x[..., :d]], dim=-1)


def _lex_window_max(sc, sl, separation: int):
    """Windowed lexicographic max over positions (last axis): for each
    position p the (score desc, slot asc) best among [p-sep, p+sep]."""
    best_sc, best_sl = sc, sl
    imax = torch.iinfo(sl.dtype).max
    for d in range(1, separation + 1):
        for s in (d, -d):
            c_sc = _shift(sc, s, -float("inf"))
            c_sl = _shift(sl, s, imax)
            win = (c_sc > best_sc) | ((c_sc == best_sc) & (c_sl < best_sl))
            best_sc = torch.where(win, c_sc, best_sc)
            best_sl = torch.where(win, c_sl, best_sl)
    return best_sc, best_sl


def _window_or(mask, separation: int):
    """Positions within +-separation of any set position (last axis)."""
    out = mask
    for d in range(1, separation + 1):
        out = out | _shift(mask, d, False) | _shift(mask, -d, False)
    return out


def greedy_well_separated_posmajor(scores: torch.Tensor,
                                   favorable: torch.Tensor,
                                   separation: int, jmax: int
                                   ) -> torch.Tensor:
    """(Z, M) bool taken-mask over the position-major slot grid: the
    greedy max-score subset with starts more than `separation` apart
    (inclusive exclusion), ties to the earlier slot.

    Local-max peeling: each pass takes every live candidate that is the
    lexicographic (score desc, slot asc) maximum among live candidates
    within +-separation of its position, then blocks their
    neighbourhoods; the result equals the sequential greedy scan.
    separation must be >= 1 (RefineOptions' default is 10)."""
    Z, M = scores.shape
    ns = M // jmax
    dev = scores.device
    sc2 = scores.float().reshape(Z, jmax, ns)
    slot2 = torch.arange(M, dtype=torch.int32, device=dev).reshape(jmax, ns)
    taken = torch.zeros(Z, jmax, ns, dtype=torch.bool, device=dev)
    blocked = torch.zeros(Z, jmax, dtype=torch.bool, device=dev)
    alive = favorable.reshape(Z, jmax, ns).clone()
    ninf = torch.tensor(-float("inf"), device=dev)
    while bool(device_fetch(alive.any())):
        pos_sc = torch.where(alive, sc2, ninf).amax(dim=2)
        hit = alive & (sc2 == pos_sc[..., None])
        pos_sl = torch.where(hit, slot2, M).amin(dim=2)
        _, win_sl = _lex_window_max(pos_sc, pos_sl, separation)
        winner = alive & (win_sl[..., None] == slot2)
        taken |= winner
        blocked |= _window_or(winner.any(dim=2), separation)
        alive &= ~winner & ~blocked[..., None]
    return taken.reshape(Z, M)


def splice_templates(tpl, tlen, start, mtype, base, taken):
    """Apply each ZMW's well-separated taken set of single-base mutations.

    tpl (Z, Jmax) int8, tlen (Z,), start/mtype/base (M,), taken (Z, M).
    Returns (new_tpl (Z, Jmax), new_tlen (Z,), mtp (Z, Jmax+1)), mtp the
    old->new position map.  new_tlen is UNCLAMPED: bases past Jmax are
    dropped, so the caller must treat new_tlen > Jmax as an overflow."""
    Z, Jmax = tpl.shape
    dev = tpl.device
    i32 = torch.int32
    M = start.shape[0]
    idx = start.clamp(0, Jmax - 1).long().expand(Z, M)
    idx1 = start.clamp(0, Jmax).long().expand(Z, M)
    is_sub = taken & (mtype == SUBSTITUTION)
    is_ins = taken & (mtype == INSERTION)
    is_del = taken & (mtype == DELETION)

    def plane(n, index, vals):
        return torch.zeros(Z, n, dtype=i32, device=dev).scatter_reduce(
            1, index, vals.to(i32), "amax")

    sub_at = plane(Jmax, idx, is_sub) > 0
    sub_base = plane(Jmax, idx, torch.where(is_sub, base, 0))
    ins_at = plane(Jmax + 1, idx1, is_ins) > 0
    ins_base = plane(Jmax + 1, idx1, torch.where(is_ins, base, 0))
    del_at = plane(Jmax, idx, is_del) > 0

    # mtp[j] = j - dels(start < j) + ins(start <= j)
    dels_before = torch.cat([torch.zeros(Z, 1, dtype=torch.int64,
                                         device=dev),
                             torch.cumsum(del_at.long(), 1)], dim=1)
    ins_upto = torch.cumsum(ins_at.long(), 1)
    mtp = torch.arange(Jmax + 1, device=dev) - dels_before + ins_upto
    new_tlen = mtp.gather(1, tlen.long()[:, None])[:, 0]

    pos = torch.arange(Jmax, device=dev)
    edited = torch.where(sub_at, sub_base, tpl.to(i32))
    # one extra column takes every dropped write (deleted, padding, or
    # pushed past Jmax), then is cut off
    new_tpl = torch.full((Z, Jmax + 1), 4, dtype=i32, device=dev)
    keep = ~del_at & (pos < tlen[:, None]) & (mtp[:, :-1] < Jmax)
    dst = torch.where(keep, mtp[:, :-1], Jmax)
    new_tpl.scatter_(1, dst, edited)
    ins_ok = ins_at & (torch.arange(Jmax + 1, device=dev) <= tlen[:, None]) \
        & (mtp - 1 < Jmax)
    new_tpl.scatter_(1, torch.where(ins_ok, mtp - 1, Jmax), ins_base)
    return (new_tpl[:, :Jmax].to(tpl.dtype), new_tlen.to(torch.int32),
            mtp.to(torch.int32))


def _hash_powers(jmax: int) -> np.ndarray:
    """MULT^(j+1) mod 2^32 for j < jmax (uint32 wraparound powers)."""
    out = np.empty(jmax, np.int64)
    acc = 1
    for j in range(jmax):
        acc = (acc * _HASH_MULT) & _U32
        out[j] = acc
    return out


def template_hash(tpl: torch.Tensor, tlen: torch.Tensor) -> torch.Tensor:
    """(Z,) rolling uint32 hash of each live template prefix, held in
    int64 (cycle detection): sum_j (tpl[j] + 2) * MULT^(j+1) mod 2^32,
    xor tlen -- the JAX package's uint32 arithmetic."""
    Z, Jmax = tpl.shape
    powers = torch.as_tensor(_hash_powers(Jmax), device=tpl.device)
    live = torch.arange(Jmax, device=tpl.device)[None, :] < tlen[:, None]
    vals = torch.where(live, tpl.to(torch.int64) + 2, 0)
    return ((vals * powers).sum(1) & _U32) ^ tlen.to(torch.int64)


def nearby_allowed(fav_start, fav_end, fav_mask, neighborhood: int,
                   jmax: int) -> torch.Tensor:
    """(Z, Jmax) bool: positions within `neighborhood` of any favorable
    mutation's [start, end) (the unique_nearby window filter: each
    centre m allows candidate starts in [m.start - n, m.end + n))."""
    Z = fav_mask.shape[0]
    lo = torch.where(fav_mask, (fav_start - neighborhood).clamp(min=0), jmax)
    hi = torch.where(fav_mask, (fav_end + neighborhood).clamp(max=jmax), 0)
    one = fav_mask.to(torch.int32)
    diff = torch.zeros(Z, jmax + 1, dtype=torch.int32, device=fav_mask.device)
    diff.scatter_add_(1, lo.clamp(0, jmax).long(), one)
    diff.scatter_add_(1, hi.clamp(0, jmax).long(), -one)
    return torch.cumsum(diff[:, :-1], 1) > 0


# --------------------------------------------------------------------------
# loop state and slot-grid scoring
# --------------------------------------------------------------------------


@dataclasses.dataclass
class RefineLoopState:
    """State of the device-resident refinement loop (leaves on device)."""

    tpl: torch.Tensor          # (Z, Jmax) int8 forward template
    tlens: torch.Tensor        # (Z,) int32
    tstarts: torch.Tensor      # (Z, R) int32 read windows (fwd frame)
    tends: torch.Tensor
    win_tpl: torch.Tensor      # (Z, R, Jmax) oriented windows + fills
    win_trans: torch.Tensor
    wlens: torch.Tensor
    alpha: BandedMatrix        # leaves (Z, R, ...)
    beta: BandedMatrix
    a_prefix: torch.Tensor
    b_suffix: torch.Tensor
    baselines: torch.Tensor    # (Z, R)
    trans_f: torch.Tensor      # (Z, Jmax, 4)
    tpl_r: torch.Tensor        # (Z, Jmax) reverse-complement template
    trans_r: torch.Tensor
    active: torch.Tensor       # (Z, R) bool
    done: torch.Tensor         # (Z,) bool
    converged: torch.Tensor    # (Z,) bool
    iterations: torch.Tensor   # (Z,) int32
    n_tested: torch.Tensor     # (Z,) int32
    n_applied: torch.Tensor    # (Z,) int32
    allowed: torch.Tensor      # (Z, Jmax) bool candidate-position filter
    history: torch.Tensor      # (Z, HISTORY) int64 template-hash ring
    hist_n: torch.Tensor       # (Z,) int32
    it: int = 0


def slot_geometry(ts, te, strand, ms, me, is_ins):
    """Interior-vs-edge classification of mutation slots against read
    windows (all args broadcast); returns (overlap, interior, wlen)."""
    overlap = torch.where(is_ins, (ts <= me) & (ms <= te),
                          (ts < me) & (ms < te))
    p_w = torch.where(strand == 0, ms - ts, te - me)
    e_w = torch.where(strand == 0, me - ts, te - ms)
    wlen = te - ts
    interior = (p_w >= 3) & (e_w <= wlen - 2)
    return overlap, interior, wlen


def _refill_pairs(pairs, flat_reads, flat_rlens, f_wt, f_wtr, f_wl, tables,
                  strands, tstarts, tends, end, width: int) -> torch.Tensor:
    """(E,) absolute LLs of (z, r, slot) pairs by a full banded refill
    (K1) of each read's mutated window: the JAX host loop's tiny-window
    fallback (batch._batch_edge -> scorer._score_edge).  The template-
    frame slot maps to its window-frame slot (reverse reads: position
    te - end, base complemented), whose patch rows are built for that
    position alone (dense_patch_grids with the pair's position; tables
    (Z*R, 8, 4))."""
    from pbccs_tpu_torch.ops.dense_score_cuda import (_REV_PERM,
                                                      dense_patch_grids)
    from pbccs_tpu_torch.ops.fwdbwd_cuda import (forward_batch,
                                                 forward_loglik_batch)
    from pbccs_tpu_torch.ops.mutation_score import (make_window_patches,
                                                    mutated_windows_per_pair)

    ez, er, em = pairs
    R = strands.shape[1]
    zr = ez * R + er
    dev = strands.device
    fwd = strands[ez, er] == 0
    ts, te = tstarts[ez, er], tends[ez, er]
    k_t = em % N_SLOTS
    k_w = torch.where(fwd, k_t, torch.as_tensor(_REV_PERM, device=dev)[k_t])
    p = torch.where(fwd, em // N_SLOTS - ts, te - end[em])
    wt_e, wtr_e, wl_e = f_wt[zr], f_wtr[zr], f_wl[zr]
    mt = torch.as_tensor(_SLOT_TYPES, device=dev)[k_w]
    nb = torch.as_tensor(_SLOT_BASES, device=dev)[k_w]
    pt = dense_patch_grids(wt_e, wtr_e, tables[zr], wl_e, p[:, None])
    patch = make_window_patches(wt_e, pt[torch.arange(len(p), device=dev),
                                         0, k_w], p, mt, nb)
    bases, trans, new_len = mutated_windows_per_pair(wt_e, wtr_e, wl_e, p, mt,
                                                     patch)
    jcut = int(device_fetch(new_len.max())) + 1  # columns past every window
    alpha = forward_batch(flat_reads[zr], flat_rlens[zr], bases[:, :jcut],
                          trans[:, :jcut], new_len, width)
    return forward_loglik_batch(alpha, flat_rlens[zr], new_len)


#: names of score_slot_grid's stages, as torch.profiler ranges
#: (pbccs_tpu_torch/tools/profile_main_path.py reads their CUDA time)
STAGES = ("slot_grid.geometry", "slot_grid.k3", "slot_grid.edge",
          "slot_grid.splice_map", "slot_grid.refill")


def score_slot_grid(st: RefineLoopState, reads, rlens, strands, table,
                    real_rows, start, end, mtype, base, valid, *,
                    min_fast_edge: int) -> torch.Tensor:
    """(Z, M) slot-grid totals, summed over active reads of
    (mutated LL - baseline).

    Interior scores come from the K3 kernel over every (read, 64-position
    block) that holds a valid candidate; K3 builds its read windows and
    patch transitions itself.  Edge slots sit at static window-frame rows
    ({0,1,2} and {J-2,J-1,J}) and come from the window-frame edge
    program, spliced into the kernel grid before the orientation
    mapping, so the whole grid maps and reduces in one pass.  Edge slots
    of windows shorter than `min_fast_edge` (where the edge program's two
    regimes would overlap) take full-refill LLs instead (_refill_pairs),
    as the JAX host loop's fallback pairs do.  Each stage runs inside a
    torch.profiler range named in STAGES."""
    from torch.profiler import record_function

    from pbccs_tpu_torch.ops.dense_score_cuda import (
        PB, dense_interior_scores_batch, edge_window_scores_batch,
        splice_edge_rows, window_grid_to_template)

    Z, R = reads.shape[:2]
    jmax = st.tpl.shape[1]
    M = jmax * N_SLOTS
    flat = lambda a: a.reshape((Z * R,) + a.shape[2:])  # noqa: E731
    W = st.alpha.vals.shape[-1]
    f_reads, f_rlens = flat(reads), flat(rlens)
    f_wt, f_wtr, f_wl = flat(st.win_tpl), flat(st.win_trans), flat(st.wlens)
    alpha_f = BandedMatrix(*map(flat, st.alpha))
    beta_f = BandedMatrix(*map(flat, st.beta))
    f_apre, f_bsuf = flat(st.a_prefix), flat(st.b_suffix)

    with record_function(STAGES[0]):
        overlap, interior, wlen = slot_geometry(
            st.tstarts[:, :, None], st.tends[:, :, None],
            strands[:, :, None], start[None, None, :], end[None, None, :],
            (mtype == INSERTION)[None, None, :])
        geo = valid[:, None, :] & overlap & real_rows[:, :, None]
        score_mask = geo & st.active[:, :, None]
        fb = score_mask & ~interior & (wlen < min_fast_edge)
        tables = flat(table[:, None].expand((Z, R) + table.shape[1:]))

        # (read, position-block) live mask: a block is live iff a valid
        # candidate POSITION maps into its window rows (+-1 covers the
        # ins/sub-del row offset in the reverse frame)
        NB = -(-jmax // PB)
        pos_any = valid.reshape(Z, jmax, N_SLOTS).any(-1)
        pref = torch.cat([torch.zeros(Z, 1, dtype=torch.int64,
                                      device=reads.device),
                          torch.cumsum(pos_any.long(), 1)], dim=1)
        b = torch.arange(NB, device=reads.device)[None, None, :]
        ts3, te3 = st.tstarts[:, :, None], st.tends[:, :, None]
        fwd3 = strands[:, :, None] == 0
        lo = torch.where(fwd3, ts3 + b * PB, te3 - (b + 1) * PB - 1)
        hi = torch.where(fwd3, ts3 + (b + 1) * PB, te3 - b * PB + 1)
        lo = (lo - 1).clamp(0, jmax)
        hi = (hi + 1).clamp(0, jmax)
        take = lambda idx: torch.gather(  # noqa: E731
            pref, 1, idx.reshape(Z, -1).long()).reshape(Z, R, NB)
        live = (take(hi) - take(lo)) > 0
        live &= real_rows[:, :, None] & st.active[:, :, None]

    with record_function(STAGES[1]):
        grid_w = dense_interior_scores_batch(
            f_reads, f_rlens, f_wt, f_wtr, f_wl, tables, alpha_f, beta_f,
            f_apre, f_bsuf, W, live.reshape(Z * R, NB))
    with record_function(STAGES[2]):
        e6 = edge_window_scores_batch(f_reads, f_rlens, f_wt, f_wtr, f_wl,
                                      tables, alpha_f, beta_f, f_apre, f_bsuf,
                                      W)
    with record_function(STAGES[3]):
        grid_w = splice_edge_rows(grid_w, e6, f_wl)
        mapped = window_grid_to_template(grid_w, flat(strands),
                                         flat(st.tstarts), flat(st.tends),
                                         jmax).reshape(Z, R, M)
    with record_function(STAGES[4]):
        if bool(device_fetch(fb.any())):
            pairs = torch.nonzero(fb, as_tuple=True)
            mapped[pairs] = _refill_pairs(pairs, f_reads, f_rlens, f_wt,
                                          f_wtr, f_wl, tables, strands,
                                          st.tstarts, st.tends, end, W)
    with record_function(STAGES[3]):
        return torch.where(score_mask, mapped - st.baselines[:, :, None],
                           0.0).sum(1)


def qv_from_slot_grid(totals: torch.Tensor, valid: torch.Tensor
                      ) -> torch.Tensor:
    """(Z, Jmax) int32 per-position consensus QVs from slot-grid totals:
    per position t = logsumexp of the negative-scoring valid slots, QV =
    -10 (t - softplus(t)) / ln 10 = -10 log10(s / (1 + s)), s = sum of
    exp(score); positions with no negative slot saturate to QV_SATURATED
    (reference ConsensusQVs, Consensus-inl.hpp:277-297)."""
    Z, M = totals.shape
    sc = torch.where(valid & (totals < 0.0), totals.float(),
                     -float("inf")).reshape(Z, M // N_SLOTS, N_SLOTS)
    m = sc.amax(-1)
    any_neg = torch.isfinite(m)
    safe_m = torch.where(any_neg, m, 0.0)
    t = safe_m + torch.log(torch.exp(sc - safe_m[..., None]).sum(-1))
    qv = -10.0 * (t - torch.logaddexp(t, torch.zeros_like(t))) / _LN10
    return torch.where(any_neg, torch.round(qv),
                       float(QV_SATURATED)).to(torch.int32)


def run_qv_ints(st: RefineLoopState, reads, rlens, strands, table,
                real_rows, skip_mask, *, min_fast_edge: int) -> torch.Tensor:
    """The QV sweep: score the full slot grid of every non-skipped ZMW
    against its current template and reduce to (Z, Jmax) int32 QVs."""
    jmax = st.tpl.shape[1]
    start, end, mtype, base = slot_grid(jmax, reads.device)
    valid = slot_candidates(st.tpl, st.tlens) & ~skip_mask[:, None]
    totals = score_slot_grid(st, reads, rlens, strands, table, real_rows,
                             start, end, mtype, base, valid,
                             min_fast_edge=min_fast_edge)
    return qv_from_slot_grid(totals, valid)


# --------------------------------------------------------------------------
# the loop
# --------------------------------------------------------------------------


def rebuild(st: RefineLoopState, reads, rlens, strands, table, *,
            width: int) -> None:
    """Rebuild windows and fills against st's templates/windows in place,
    and drop reads whose new fills no longer mate from st.active.  The
    guided-refill schedule follows the state's bucket, as the JAX host
    loop's _setup does after a re-bucket."""
    from pbccs_tpu_torch.models.arrow.scorer import guided_fill_passes
    from pbccs_tpu_torch.parallel import batch as batchmod

    s = batchmod._batch_setup(st.tpl, st.tlens, table, reads, rlens,
                              strands, st.tstarts, st.tends, width,
                              guided_fill_passes(st.tpl.shape[1]))
    st.win_tpl, st.win_trans, st.wlens = s.win_tpl, s.win_trans, s.wlens
    st.alpha, st.beta = s.fill.alpha, s.fill.beta
    st.a_prefix, st.b_suffix = s.fill.apre, s.fill.bsuf
    st.baselines = s.fill.ll_b
    st.trans_f, st.tpl_r, st.trans_r = s.trans_f, s.tpl_r, s.trans_r
    st.active = batchmod._update_active(st.active, s.fill.ll_a, s.fill.ll_b,
                                        rlens, st.tstarts, st.tends)


def _pad_positions(x: torch.Tensor, jmax: int, jnew: int, fill):
    """Pad a (Z, jmax) position plane or a (Z, jmax * 9) slot plane to
    jnew positions with `fill`."""
    Z = x.shape[0]
    per = x.shape[1] // jmax
    pad = torch.full((Z, jnew - jmax, per), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x.reshape(Z, jmax, per), pad], 1).reshape(Z, -1)


def _splice_len(tlens, taken, mtype) -> torch.Tensor:
    """(Z,) template lengths after applying `taken` (unclamped)."""
    ins = (taken & (mtype == INSERTION)).sum(1)
    dels = (taken & (mtype == DELETION)).sum(1)
    return tlens + (ins - dels).to(tlens.dtype)


def run_refine_loop(st: RefineLoopState, reads, rlens, strands, table,
                    real_rows, *, width: int, max_iterations: int,
                    separation: int, neighborhood: int,
                    min_fast_edge: int) -> RefineLoopState:
    """Up to max_iterations rounds of enumerate -> score -> select ->
    splice -> rebuild over the batch, updating `st` in place.

    Semantics mirror the reference AbstractRefineConsensus
    (Consensus-inl.hpp:160-245) as the JAX package's loops do:
    favorable = score above the f32 noise floor (refine.
    favorability_threshold, per round), greedy well-separated subset, a
    multi-mutation subset whose result was already visited (48-deep hash
    ring) trimmed to its best single mutation, and rounds > 0 restricted
    to the neighbourhood of the previous round's favorable mutations.
    A round whose applied templates no longer fit the bucket (length + 2
    > Jmax) re-buckets to batch._jmax_bucket of the longest template and
    rebuilds the state there (the JAX host loop's apply_mutations); the
    final state may have a larger Jmax than the initial one."""
    from pbccs_tpu_torch.parallel import batch as batchmod

    Z, R = reads.shape[:2]
    jmax = st.tpl.shape[1]
    dev = reads.device
    start, end, mtype, base = slot_grid(jmax, dev)
    H = st.history.shape[1]
    zidx = torch.arange(Z, device=dev)
    while st.it < max_iterations and not bool(device_fetch(st.done.all())):
        # 1. candidates
        valid = slot_candidates(st.tpl, st.tlens, st.allowed) \
            & ~st.done[:, None]

        # 2. scores
        totals = score_slot_grid(st, reads, rlens, strands, table,
                                 real_rows, start, end, mtype, base, valid,
                                 min_fast_edge=min_fast_edge)
        scores = torch.where(valid, totals, -float("inf"))
        eps_z = batchmod._favorability_eps(st.baselines, st.active)
        favorable = valid & (scores > eps_z[:, None])
        fav_any = favorable.any(1)

        st.iterations = st.iterations + (~st.done).to(torch.int32)
        st.n_tested = st.n_tested + torch.where(
            st.done, 0, valid.sum(1, dtype=torch.int32))
        newly_converged = ~st.done & ~fav_any
        st.converged = st.converged | newly_converged
        done_now = st.done | newly_converged

        # 3. greedy selection + cycle trim (the candidate template is
        # spliced wide enough to hold every insertion, so its hash is
        # exact even when it outgrows the bucket)
        taken = greedy_well_separated_posmajor(
            scores, favorable & ~done_now[:, None], separation, jmax)
        jw = max(jmax, int(device_fetch(
            _splice_len(st.tlens, taken, mtype).max())))
        if jw > jmax:
            w_start, _, w_mtype, w_base = slot_grid(jw, dev)
            nxt_tpl, nxt_tlen, _ = splice_templates(
                _pad_positions(st.tpl, jmax, jw, 4), st.tlens, w_start,
                w_mtype, w_base, _pad_positions(taken, jmax, jw, False))
        else:
            nxt_tpl, nxt_tlen, _ = splice_templates(st.tpl, st.tlens, start,
                                                    mtype, base, taken)
        nxt_hash = template_hash(nxt_tpl, nxt_tlen)
        seen = ((st.history == nxt_hash[:, None])
                & (torch.arange(H, device=dev)[None, :]
                   < st.hist_n[:, None])).any(1)
        trim = seen & (taken.sum(1) > 1)
        top1 = torch.argmax(torch.where(taken, scores, -float("inf")), 1)
        only_top = torch.zeros_like(taken)
        only_top[zidx, top1] = True
        taken = torch.where(trim[:, None], only_top & taken, taken)

        # 4. history push (current template, pre-apply) where a round ran
        pushing = ~st.done & fav_any
        cur_hash = template_hash(st.tpl, st.tlens)
        slot = (st.hist_n % H).long()
        pushed = st.history.clone()
        pushed[zidx, slot] = cur_hash
        st.history = torch.where(pushing[:, None], pushed, st.history)
        st.hist_n = st.hist_n + pushing.to(torch.int32)

        # 5. re-bucket when an applied template outgrows Jmax, then apply
        new_len = torch.where(pushing, _splice_len(st.tlens, taken, mtype),
                              st.tlens)
        max_len = int(device_fetch(new_len.max()))
        if max_len + 2 > jmax:
            jnew = batchmod._jmax_bucket(max_len)
            st.tpl = _pad_positions(st.tpl, jmax, jnew, 4)
            st.allowed = _pad_positions(st.allowed, jmax, jnew, True)
            taken = _pad_positions(taken, jmax, jnew, False)
            favorable = _pad_positions(favorable, jmax, jnew, False)
            jmax = jnew
            start, end, mtype, base = slot_grid(jmax, dev)
        new_tpl, new_tlen, mtp = splice_templates(st.tpl, st.tlens, start,
                                                  mtype, base, taken)
        old_tlen = st.tlens.long()[:, None]
        ts_new = mtp.gather(1, st.tstarts.long().clamp(min=0).minimum(old_tlen))
        te_new = mtp.gather(1, st.tends.long().clamp(min=0).minimum(old_tlen))
        st.tpl = torch.where(pushing[:, None], new_tpl, st.tpl)
        st.tlens = torch.where(pushing, new_tlen, st.tlens)
        st.n_applied = st.n_applied + torch.where(
            pushing, taken.sum(1, dtype=torch.int32), 0)
        st.tstarts = torch.where(pushing[:, None], ts_new, st.tstarts)
        st.tends = torch.where(pushing[:, None], te_new, st.tends)
        st.done = done_now

        # 6. rebuild fills (skipped when no ZMW applied anything)
        if bool(device_fetch(pushing.any())):
            rebuild(st, reads, rlens, strands, table, width=width)

        # 7. next round's nearby filter from this round's favorables
        allowed = nearby_allowed(start[None, :], end[None, :], favorable,
                                 neighborhood, jmax)
        st.allowed = torch.where(fav_any[:, None], allowed, st.allowed)
        st.it += 1
    return st
