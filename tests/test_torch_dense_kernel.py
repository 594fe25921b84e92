"""K3 (csrc/dense_score.cu) on the CPU: the kernel's in-kernel operand
build transcribed lane by lane in torch and held bitwise against the
plain version's planes (band_read_windows, dense_patch_grids); the band
sums in the kernel's order; the column / position forms of the two
plane functions against slices of the full planes, and the edge programs and
the refill fallback that use them against their full-plane forms; the
stick / 3 divides routed through fwdbwd_cuda._third.

The kernel itself runs only on the card (tests/test_torch_gpu.py holds it
against the plain version there).  Inputs are simulated from numpy seeds.
Tolerance: bitwise everywhere."""

import numpy as np
import pytest
import torch

from pbccs_tpu_torch.models.arrow import params
from pbccs_tpu_torch.models.arrow.scorer import (fill_alpha_beta_batch,
                                                 oriented_window)
from pbccs_tpu_torch.ops import dense_score_cuda as ds
from pbccs_tpu_torch.ops import mutation_score as ms
from pbccs_tpu_torch.parallel import device_refine as dr
from pbccs_tpu_torch.simulate import simulate_zmw

# The suite runs as parallel worker processes (pytest-xdist): one torch
# intra-op thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

_ENDOFF = np.array([1, 1, 1, 1, 0, 0, 0, 0, 1])


def make_batch(seed: int, L: int, n_reads: int):
    """One simulated ZMW as a flat batch of oriented windows: every other
    read clipped at both ends, and the last read against a 7-base window
    (J = 7: only positions 3 and 4, and 5 for insertions, are interior; its
    read of 15 bases is shorter than every W).  Reads are cut to their
    window plus 8 bases.  Returns (reads (R, Imax) int8, rlens, win_tpl
    (R, Jmax) int8, win_trans (R, Jmax, 4), wlens, tables (R, 8, 4))."""
    rng = np.random.default_rng(seed)
    tpl, reads, strands, snr = simulate_zmw(rng, L, n_reads)
    Jmax = L + 7
    table = params.snr_to_transition_table_host(snr).astype(np.float32)
    ts = np.zeros(n_reads, np.int32)
    te = np.full(n_reads, L, np.int32)
    ts[1::2], te[1::2] = 3, L - 5
    ts[-1], te[-1] = 5, 12
    reads_p = np.full((n_reads, Jmax + 40), 4, np.int8)
    rlens = np.zeros(n_reads, np.int32)
    for i, r in enumerate(reads):
        r = np.asarray(r)[: te[i] - ts[i] + 8]
        reads_p[i, : len(r)] = r
        rlens[i] = len(r)
    tpl_p = np.full((1, Jmax), 4, np.int8)
    tpl_p[0, :L] = tpl
    t = torch.as_tensor
    tlen = t(np.array([L], np.int32))
    win_tpl, win_trans, wlens = oriented_window(
        t(np.asarray(strands, np.int32))[None], t(ts)[None], t(te)[None],
        t(tpl_p), params.revcomp_padded(t(tpl_p), tlen), tlen,
        t(table)[None])
    tables = t(np.broadcast_to(table, (n_reads, 8, 4)).copy())
    return (t(reads_p), t(rlens), win_tpl[0], win_trans[0].contiguous(),
            wlens[0].to(torch.int32), tables)


def _fills(batch, W: int, guided: bool):
    reads, rlens, wt, wtr, wl, _ = batch
    return fill_alpha_beta_batch(reads, rlens, wt, wtr, wl, W,
                                 guided_passes=1 if guided else 0)


# --------------------------------------------------------------------------
# transcriptions of the kernel's operand build
# --------------------------------------------------------------------------


def kernel_read_codes(reads, offsets, W: int):
    """csrc/dense_score.cu's CODES for every column j in [-2, nc + 2):
    (rbase, rnext) int32 (R, nc + 4, W), column j at index j + 2.  Lane L
    of column j holds band row o - (o mod W) + L (+ W when L < o mod W);
    rnext = read[row], rbase = read[row - 1], 0 outside [0, Imax) and for
    a column outside [0, nc) (its offset taken as 0)."""
    R, Imax = reads.shape
    nc = offsets.shape[1]
    lane = torch.arange(W, dtype=torch.int32)
    rb = torch.zeros(R, nc + 4, W, dtype=torch.int32)
    rn = torch.zeros_like(rb)
    rd = reads.to(torch.int32)
    for j in range(-2, nc + 2):
        ok = 0 <= j < nc
        o = offsets[:, j] if ok else torch.zeros(R, dtype=torch.int32)
        q = (o % W)[:, None]
        row = o[:, None] - q + lane + torch.where(lane < q, W, 0)
        got_n = rd.gather(1, row.clamp(0, Imax - 1).long())
        got_b = rd.gather(1, (row - 1).clamp(0, Imax - 1).long())
        rn[:, j + 2] = torch.where(ok & (row < Imax), got_n, 0)
        rb[:, j + 2] = torch.where(ok & (row >= 1) & (row <= Imax), got_b, 0)
    return rb, rn


def kernel_patch_rows(win_tpl, wlens, tables):
    """The kernel's patch rows at every position p: PT0 (R, Jm, 4, 4) (sub
    and ins b at p-1), PT1S and PT1I (sub b / ins b at p) and pt_del
    (R, Jm, 4): rows of the read's table by context min(next + 4 (cur !=
    next), 7) over the window bases p-1, p, p+1 clipped to the window,
    gated by p > 0, p + 1 < J, p < J and 0 < p < J - 1."""
    R, Jm = win_tpl.shape
    t = win_tpl.to(torch.int64)
    ar = torch.arange(R)[:, None]
    p = torch.arange(Jm)[None, :]
    L = wlens.to(torch.int64)[:, None]
    tb = lambda k: t[ar, (p + k).clamp(0, Jm - 1)]  # noqa: E731
    prev_b, cur_b, next_b = tb(-1), tb(0), tb(1)

    def row(cur, nxt, gate):
        ctx = torch.clamp(nxt + torch.where(cur != nxt, 4, 0), max=7)
        return torch.where(gate[..., None], tables[ar, ctx], 0.0)

    pt0, pt1s, pt1i = [], [], []
    for b in range(4):
        nb = torch.full_like(cur_b, b)
        pt0.append(row(prev_b, nb, (p > 0).expand(R, Jm)))
        pt1s.append(row(nb, next_b, p + 1 < L))
        pt1i.append(row(nb, cur_b, p < L))
    pt_del = row(prev_b, next_b, (p > 0) & (p < L - 1))
    return (torch.stack(pt0, 2), torch.stack(pt1s, 2), torch.stack(pt1i, 2),
            pt_del)


_CASES = [(W, guided) for W in (32, 64, 96, 128) for guided in (False, True)]


@pytest.mark.parametrize("W,guided", _CASES)
def test_read_windows_build_matches_planes(W, guided):
    """The kernel's read codes are bitwise band_read_windows' planes: rnext
    on every lane, rbase on every lane but a cut lane whose source row is
    outside the previous column's band (which every consumer masks), and
    zero for the columns outside [0, nc) the kernel reaches."""
    batch = make_batch(60 + W, 160, 5)
    reads, rlens = batch[:2]
    offs = _fills(batch, W, guided).alpha.offsets
    rb, rn = kernel_read_codes(reads, offs, W)
    rbase, rnext = ds.band_read_windows(reads, offs, W)
    nc = offs.shape[1]
    assert torch.equal(rn[:, 2:nc + 2].float(), rnext)
    o = offs[:, :, None]
    o_prev = torch.cat([torch.zeros_like(offs[:, :1]), offs[:, :-1]],
                       1)[:, :, None]
    lane = torch.arange(W)
    cut = (o % W) == lane
    rows = o - (o % W) + lane + torch.where(lane < (o % W), W, 0)
    unmasked = ~cut | ((rows - 1 >= o_prev) & (rows - 1 < o_prev + W))
    assert torch.equal(torch.where(unmasked, rb[:, 2:nc + 2].float(), 0.0),
                       torch.where(unmasked, rbase, 0.0))
    for j in (0, 1, nc + 2, nc + 3):
        assert not rb[:, j].any() and not rn[:, j].any()
    assert (rlens < W).any()
    if guided:
        assert not torch.equal(offs, _fills(batch, W, False).alpha.offsets)


@pytest.mark.parametrize("seed", [71, 72])
def test_patch_rows_build_matches_grid(seed):
    """The kernel's patch rows are bitwise dense_patch_grids' rows: sub
    and ins b at p-1 (the kernel takes one row for both), sub b and ins b
    at p, del at p-1 (the grid's del row at p is read by no interior
    slot)."""
    reads, rlens, wt, wtr, wl, tables = make_batch(seed, 80, 5)
    pt0, pt1s, pt1i, pt_del = kernel_patch_rows(wt, wl, tables)
    grid = ds.dense_patch_grids(wt, wtr, tables, wl)
    for b in range(4):
        assert torch.equal(pt0[:, :, b], grid[:, :, b, 0])
        assert torch.equal(pt0[:, :, b], grid[:, :, 4 + b, 0])
        assert torch.equal(pt1s[:, :, b], grid[:, :, b, 1])
        assert torch.equal(pt1i[:, :, b], grid[:, :, 4 + b, 1])
    assert torch.equal(pt_del, grid[:, :, 8, 0])
    assert int(wl.min()) == 7


@pytest.mark.parametrize("W,guided", [(32, True), (64, False), (96, True),
                                      (128, False)])
def test_scores_from_kernel_operands_equal_plain(W, guided):
    """The plain version's arithmetic on the kernel's operands (its read
    codes, its patch rows; the grid's del row at p, which no interior
    slot reads, set to NaN) gives bitwise the scores of the plain
    version's planes, interior slots of the J = 7 window included."""
    batch = make_batch(80 + W, 160, 5)
    reads, rlens, wt, wtr, wl, tables = batch
    fill = _fills(batch, W, guided)
    offs = fill.alpha.offsets
    nc = offs.shape[1]
    rb, rn = kernel_read_codes(reads, offs, W)
    pt0, pt1s, pt1i, pt_del = kernel_patch_rows(wt, wl, tables)
    R, Jm = wt.shape
    pt = torch.full((R, Jm, 9, 2, 4), float("nan"))
    pt[:, :, :4, 0] = pt0
    pt[:, :, 4:8, 0] = pt0
    pt[:, :, :4, 1] = pt1s
    pt[:, :, 4:8, 1] = pt1i
    pt[:, :, 8, 0] = pt_del
    args = (fill.alpha.vals, fill.beta.vals)
    tail = (offs, fill.apre, fill.bsuf, wt, wtr)
    got = ds._dense_rows_plain(*args, rb[:, 2:nc + 2].float(),
                               rn[:, 2:nc + 2].float(), *tail, pt, rlens,
                               ds._HIT, ds._MISS)
    live = torch.ones(R, -(-Jm // ds.PB), dtype=torch.int32)
    want = ds.dense_score_plain(*args, offs, fill.apre, fill.bsuf, reads,
                                rlens, wt, wl, wtr, tables, live)
    p = torch.arange(Jm)[None, :, None]
    interior = (p >= 3) & (p + torch.as_tensor(_ENDOFF)
                           <= wl[:, None, None].long() - 2)
    assert interior[-1].sum() == 22   # J = 7: sub, del at 3, 4; ins at 3..5
    assert torch.equal(got[interior], want[interior])


def test_band_sum_is_the_kernels_order():
    """band_sum adds each thread's slots in turn and then five xor-butterfly
    steps, as the kernel's link sums do; the plain version's nine link
    sums go through it."""
    rng = np.random.default_rng(90)
    for W in (32, 96, 160, 40):
        x = torch.as_tensor(rng.random((3, 7, W), np.float32) * 1e-3)
        xp = torch.nn.functional.pad(x, (0, -W % 32))
        NS = xp.shape[-1] // 32
        want = torch.empty(3, 7)
        for i in range(3):
            for k in range(7):
                v = [np.float32(xp[i, k, t]) for t in range(32)]
                for s in range(1, NS):
                    v = [np.float32(v[t] + xp[i, k, s * 32 + t])
                         for t in range(32)]
                for o in (16, 8, 4, 2, 1):
                    v = [np.float32(v[t] + v[t ^ o]) for t in range(32)]
                assert len(set(v)) == 1
                want[i, k] = float(v[0])
        assert torch.equal(ds.band_sum(x), want)
    calls = []
    orig = ds.band_sum
    batch = make_batch(91, 60, 3)
    reads, rlens, wt, wtr, wl, tables = batch
    fill = _fills(batch, 64, False)
    live = torch.ones(3, -(-wt.shape[1] // ds.PB), dtype=torch.int32)
    try:
        ds.band_sum = lambda v: calls.append(v.shape) or orig(v)
        ds.dense_score_plain(fill.alpha.vals, fill.beta.vals,
                             fill.alpha.offsets, fill.apre, fill.bsuf, reads,
                             rlens, wt, wl, wtr, tables, live)
    finally:
        ds.band_sum = orig
    assert len(calls) == 9


# --------------------------------------------------------------------------
# the column / position forms of the plane functions and their users
# --------------------------------------------------------------------------


@pytest.mark.parametrize("W", [32, 96])
def test_partial_planes_equal_full_slices(W):
    """band_read_windows on given columns and dense_patch_grids on given
    positions are bitwise the full planes at those places, column 0 and
    the last column and repeats included."""
    batch = make_batch(100 + W, 80, 5)
    reads, rlens, wt, wtr, wl, tables = batch
    offs = _fills(batch, W, True).alpha.offsets
    R, nc = offs.shape
    rng = np.random.default_rng(W)
    cols = torch.as_tensor(np.concatenate(
        [np.zeros((R, 1)), np.full((R, 1), nc - 1),
         rng.integers(0, nc, (R, 9))], 1).astype(np.int64))
    full = ds.band_read_windows(reads, offs, W)
    part = ds.band_read_windows(reads, offs, W, cols)
    ar = torch.arange(R)[:, None]
    for f, g in zip(full, part):
        assert torch.equal(g, f[ar, cols])
    Jm = wt.shape[1]
    pos = torch.as_tensor(np.concatenate(
        [np.zeros((R, 1)), np.full((R, 1), Jm - 1),
         rng.integers(0, Jm, (R, 7))], 1).astype(np.int64))
    grid = ds.dense_patch_grids(wt, wtr, tables, wl)
    assert torch.equal(ds.dense_patch_grids(wt, wtr, tables, wl, pos),
                       grid[ar, pos])


def _edge_scores_from_planes(batch, fill, W):
    """edge_window_scores_batch as it was built on the full planes:
    read-window columns sliced from band_read_windows' planes, patch rows
    from the full dense_patch_grids."""
    reads, rlens, wt, wtr, wl, tables = batch
    rbase, rnext = ds.band_read_windows(reads, fill.alpha.offsets, W)
    ptrans = ds.dense_patch_grids(wt, wtr, tables, wl)
    J = wl.to(torch.int32)
    rbase_pad = torch.cat([rbase, rbase[:, -1:], rbase[:, -1:]], dim=1)
    wins = torch.cat([rbase[:, 1:5], rnext[:, 4:5],
                      ds._window(rbase_pad, J - 3, 6)], dim=1)
    I, tpl = rlens.to(torch.int32), wt.to(torch.int32)
    aoffs = fill.alpha.offsets.to(torch.int32)
    nb = ds._edge_nb_read(wins, I, tpl, wtr, J, aoffs, fill.beta.vals,
                          fill.beta.offsets.to(torch.int32), fill.bsuf,
                          ptrans[:, :3], W=W)
    ne = ds._edge_ne_read(wins, I, tpl, wtr, J, fill.alpha.vals, aoffs,
                          fill.apre, ds._window(ptrans, J - 2, 3), W=W)
    R = reads.shape[0]
    return torch.cat([nb.reshape(R, 3, 9), ne.reshape(R, 3, 9)], dim=1)


@pytest.mark.parametrize("W,guided", [(32, False), (64, True)])
def test_edge_scores_equal_full_plane_form(W, guided):
    """The edge programs on the columns and rows they build give bitwise
    the scores of their full-plane form."""
    batch = make_batch(120 + W, 80, 5)
    reads, rlens, wt, wtr, wl, tables = batch
    fill = _fills(batch, W, guided)
    got = ds.edge_window_scores_batch(reads, rlens, wt, wtr, wl, tables,
                                      fill.alpha, fill.beta, fill.apre,
                                      fill.bsuf, W)
    want = _edge_scores_from_planes(batch, fill, W)
    assert torch.equal(got, want)


def test_refill_pairs_equal_full_plane_form():
    """_refill_pairs with patch rows built at each pair's position gives
    bitwise the LLs of the same refills fed from the full patch grid."""
    from pbccs_tpu_torch.models.arrow.mutations import (_SLOT_BASES,
                                                        _SLOT_ENDOFF,
                                                        _SLOT_TYPES)
    from pbccs_tpu_torch.ops.fwdbwd_cuda import (forward_batch,
                                                 forward_loglik_batch)

    W = 32
    reads, rlens, wt, wtr, wl, tables = make_batch(130, 40, 4)
    R, Jm = wt.shape
    strands = torch.tensor([[0, 1, 0, 1]])
    ts = torch.tensor([[0, 3, 0, 5]])
    te = ts + wl[None]
    end = torch.as_tensor(np.tile(_SLOT_ENDOFF, Jm)) \
        + torch.arange(Jm).repeat_interleave(9)
    # edge slots near each window's ends, every slot type
    ez, er, em = [], [], []
    for r in range(R):
        for P in (int(ts[0, r]), int(ts[0, r]) + 1, int(te[0, r]) - 2):
            for k in range(9):
                ez.append(0), er.append(r), em.append(P * 9 + k)
    pairs = tuple(torch.tensor(v) for v in (ez, er, em))
    got = dr._refill_pairs(pairs, reads, rlens, wt, wtr, wl, tables, strands,
                           ts, te, end, W)

    ptrans = ds.dense_patch_grids(wt, wtr, tables, wl)
    ez, er, em = pairs
    zr = ez * R + er
    fwd = strands[ez, er] == 0
    k_t = em % 9
    k_w = torch.where(fwd, k_t, torch.as_tensor(ds._REV_PERM)[k_t])
    p = torch.where(fwd, em // 9 - ts[ez, er], te[ez, er] - end[em])
    mt = torch.as_tensor(_SLOT_TYPES)[k_w]
    nb = torch.as_tensor(_SLOT_BASES)[k_w]
    patch = ms.make_window_patches(wt[zr], ptrans[zr, p, k_w], p, mt, nb)
    bases, trans, new_len = ms.mutated_windows_per_pair(
        wt[zr], wtr[zr], wl[zr], p, mt, patch)
    jcut = int(new_len.max()) + 1
    alpha = forward_batch(reads[zr], rlens[zr], bases[:, :jcut],
                          trans[:, :jcut], new_len, W)
    want = forward_loglik_batch(alpha, rlens[zr], new_len)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# stick / 3
# --------------------------------------------------------------------------


def test_stick_third_goes_through_third(monkeypatch):
    """K3's plain version and the edge programs' column extension divide
    stick by three through fwdbwd_cuda._third (a tensor divisor, an IEEE
    divide on every device); on the CPU their outputs are bitwise those
    of the Python-scalar divide they used before."""
    W = 64
    batch = make_batch(140, 80, 5)
    reads, rlens, wt, wtr, wl, tables = batch
    fill = _fills(batch, W, False)
    live = torch.ones(5, -(-wt.shape[1] // ds.PB), dtype=torch.int32)

    def run():
        dense = ds.dense_score_plain(fill.alpha.vals, fill.beta.vals,
                                     fill.alpha.offsets, fill.apre,
                                     fill.bsuf, reads, rlens, wt, wl, wtr,
                                     tables, live)
        edge = ds.edge_window_scores_batch(reads, rlens, wt, wtr, wl, tables,
                                           fill.alpha, fill.beta, fill.apre,
                                           fill.bsuf, W)
        return dense, edge

    calls = {"dense": 0, "edge": 0}
    third = ds._third

    def counting(key):
        def fn(x):
            calls[key] += 1
            return third(x)
        return fn

    monkeypatch.setattr(ds, "_third", counting("dense"))
    monkeypatch.setattr(ms, "_third", counting("edge"))
    now = run()
    assert calls["dense"] == 14 and calls["edge"] > 0
    monkeypatch.setattr(ds, "_third", lambda x: x / 3.0)
    monkeypatch.setattr(ms, "_third", lambda x: x / 3.0)
    before = run()
    for a, b in zip(now, before):
        assert torch.equal(a, b)
