"""K1 (csrc/arrow_fill.cu) on the CPU: the kernel's operand build
transcribed lane by lane in torch, held bitwise against the plain
version's coefficient planes; the fused alpha+beta call against the two
separate calls; the wrapper's CPU dispatch.

The kernel itself runs only on the card (tests/test_torch_gpu.py holds it
bitwise against the plain version there).  What the CPU can check is the
logic it adds over the plain version: the per-column data rolled through
registers from clamped loads, each lane's read base reloaded only when
the band moves its row, and the gates applied in _forward_coeffs' /
_backward_coeffs' order.  Inputs are simulated from numpy seeds.
Tolerance: bitwise everywhere."""

import numpy as np
import pytest
import torch

from pbccs_tpu_torch.models.arrow import params
from pbccs_tpu_torch.models.arrow.scorer import (fill_alpha_beta_batch,
                                                 oriented_window)
from pbccs_tpu_torch.ops import fwdbwd_cuda as fc
from pbccs_tpu_torch.ops.fwdbwd import (band_offsets, guided_band_offsets,
                                        in_band)
from pbccs_tpu_torch.simulate import simulate_zmw

# The suite runs as parallel worker processes (pytest-xdist): one torch
# intra-op thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

EPS = params.MISMATCH_PROBABILITY


def make_batch(seed: int, L: int, n_reads: int):
    """One simulated ZMW as a flat batch of oriented windows: every other
    read clipped at both ends, and the last read against a one-base window
    (J = 1, a 9-base read).  Returns reads (R, Imax) int8, rlens, win_tpl
    (R, Jmax) int8, win_trans (R, Jmax, 4) float32, wlens."""
    rng = np.random.default_rng(seed)
    tpl, reads, strands, snr = simulate_zmw(rng, L, n_reads)
    Jmax = L + 7
    table = params.snr_to_transition_table_host(snr).astype(np.float32)
    ts = np.zeros(n_reads, np.int32)
    te = np.full(n_reads, L, np.int32)
    ts[1::2], te[1::2] = 3, L - 5
    ts[-1], te[-1] = 5, 6
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
    return (t(reads_p), t(rlens), win_tpl[0], win_trans[0].contiguous(),
            wlens[0].to(torch.int32))


def kernel_operands(reads, I, tpls, trans, J, offsets, W: int, eps: float,
                    backward: bool):
    """csrc/arrow_fill.cu's fill_read, column by column, every read and
    lane at once: (cm, cd, cc) (R, nc, W), mask (R, nc), seed lane and seed
    column (R,).  j is the same for every read at a column, so the
    kernel's uniform registers are (R,) tensors here."""
    R, Imax = reads.shape
    Jmax = tpls.shape[1]
    nc = Jmax + 1
    dj = -1 if backward else 1
    ar = torch.arange(R)
    lane = torch.arange(W, dtype=torch.int32)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    hit, miss = f32(1.0 - eps), f32(eps / 3.0)

    def at(n, j):
        return min(max(j, 0), n - 1)

    off_at = lambda j: offsets[:, at(nc, j)]           # noqa: E731
    tpl_at = lambda j: tpls[:, at(Jmax, j)].int()      # noqa: E731
    tr_at = lambda j: trans[:, at(Jmax, j)]            # noqa: E731

    def band_row(o):
        q = (o % W)[:, None]
        return o[:, None] - q + lane + torch.where(lane < q, W, 0)

    def read_base(row):
        src = row if backward else row - 1
        return reads[ar[:, None], src.clamp(0, Imax - 1).long()].int()

    if backward:
        em_end = torch.where(reads[:, 0] == tpls[:, 0], hit, miss)
    else:
        em_end = torch.where(
            reads[ar, (I - 1).clamp(0, Imax - 1).long()]
            == tpls[ar, (J - 1).clamp(0, Jmax - 1).long()], hit, miss)
    j = Jmax if backward else 0
    o0, o1, on = off_at(j), off_at(j - dj), off_at(j + dj)
    tA, tB = tpl_at(j - 1), tpl_at(j)
    trp, trc = tr_at(j - 2), tr_at(j - 1)
    crow = band_row(o0)
    rb = read_base(crow)
    cm, cd, cc = (torch.empty(R, nc, W) for _ in range(3))
    mask = torch.empty(R, nc)
    Ic, Jc = I[:, None], J[:, None]
    for k in range(nc):
        dead = (j >= J) | (j < 0) if backward else (j == 0) | (j > J)
        pin = torch.full((R,), j == 0) if backward else j == J
        mask[:, k] = ((j >= 1) & (j < J)).float()
        stick3 = trc[:, 2] / 3.0
        t_em = tB if backward else tA
        row = crow
        valid = (row >= 1) & (row <= Ic - 1)
        em = torch.where(rb == t_em[:, None], hit, miss)
        ins = torch.where(rb == tB[:, None], trc[:, 1:2], stick3[:, None])
        if backward:
            last = (row == Ic - 1) & (j == Jc - 1)
            mfac = torch.where(row < Ic - 1, trc[:, 0:1],
                               torch.where(last, 1.0, 0.0))
            m = torch.where(valid & in_band(row + 1, o1[:, None], W),
                            em * mfac, 0.0)
            d = torch.where(valid & (j >= 1) & (j < Jc - 1)
                            & in_band(row, o1[:, None], W),
                            trc[:, 3:4], 0.0)
            x = torch.where(valid & (row < Ic - 1)
                            & (row < o0[:, None] + W - 1), ins, 0.0)
            pinned = torch.where((row == 0)
                                 & in_band(row + 1, o1[:, None], W),
                                 em_end[:, None], 0.0)
        else:
            if j == 1:
                mfac = torch.where(row == 1, 1.0, 0.0)
            else:
                mfac = torch.where(row == 1, 0.0, trp[:, 0:1])
            m = torch.where(valid & in_band(row - 1, o1[:, None], W),
                            em * mfac, 0.0)
            d = torch.where(valid & (j > 1) & in_band(row, o1[:, None], W),
                            trp[:, 3:4], 0.0)
            x = torch.where(valid & (row > 1) & (row > o0[:, None]), ins, 0.0)
            pinned = torch.where((row == Ic)
                                 & in_band(row - 1, o1[:, None], W),
                                 em_end[:, None], 0.0)
        m = torch.where(pin[:, None], pinned, m)
        no_dc = (pin | dead)[:, None]
        cm[:, k] = torch.where(dead[:, None], 0.0, m)
        cd[:, k] = torch.where(no_dc, 0.0, d)
        cc[:, k] = torch.where(no_dc, 0.0, x)
        # column k+1's reloads: only the lanes whose band row moved
        rw = band_row(on)
        moved = rw != crow
        rb = torch.where(moved, read_base(rw), rb)
        crow = torch.where(moved, rw, crow)
        # roll the uniform data one column on (the kernel loads it ahead)
        o1, o0, on = o0, on, off_at(j + 2 * dj)
        tA, tB = tB, tpl_at(j + dj)
        trp, trc = trc, tr_at(j - 1 + dj)
        j += dj
    seedcol = (Jmax - J) if backward else torch.zeros(R, dtype=torch.int32)
    seedlane = I % W if backward else torch.zeros(R, dtype=torch.int32)
    return cm, cd, cc, mask, seedlane, seedcol


def _offsets(batch, W: int, kind: str):
    reads, rlens, tpls, trans, wlens = batch
    nc = tpls.shape[1] + 1
    diag = band_offsets(rlens, wlens, nc, W)
    if kind == "diagonal":
        return diag
    alpha = fc.forward_batch(*batch, W)
    return guided_band_offsets(alpha.vals, alpha.offsets, rlens, wlens, W)


@pytest.mark.parametrize("W", [32, 64, 96, 192])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("offsets", ["diagonal", "guided"])
def test_operand_build_matches_planes(W, backward, offsets):
    """The kernel's operands, mask and seed are bitwise the plain
    version's planes: 60-base reads (shorter than W from W = 64 on), reads
    clipped at both window ends, a J = 1 window, diagonal and
    argmax-guided band offsets."""
    batch = make_batch(31 + W, 60, 5)
    reads, rlens, tpls, trans, wlens = batch
    offs = _offsets(batch, W, offsets)
    coeffs = fc._backward_coeffs if backward else fc._forward_coeffs
    want = coeffs(reads.int(), rlens, tpls.int(), trans, wlens, offs, W, EPS)
    got = kernel_operands(reads, rlens, tpls, trans, wlens, offs, W, EPS,
                          backward)
    for name, g, w in zip(("cm", "cd", "cc", "mask"), got, want):
        assert torch.equal(g, w), name
    seed_lane = want[4].argmax(1).int()
    assert torch.equal(got[4], seed_lane)
    assert torch.equal(want[4].sum(1), torch.ones(len(rlens)))
    assert torch.equal(got[5].int(), want[5])
    assert (rlens < W).any()
    assert int(wlens.min()) == 1


@pytest.mark.parametrize("W", [32, 96])
def test_fused_fill_equals_separate_fills(W):
    """arrow_fill with both directions gives bitwise what the one-direction
    calls give, and forward_backward_batch what forward_batch and
    backward_batch give."""
    batch = make_batch(40 + W, 60, 5)
    reads, rlens, tpls, trans, wlens = batch
    offs = band_offsets(rlens, wlens, tpls.shape[1] + 1, W)
    both = fc.arrow_fill(reads, rlens, tpls, trans, wlens, offs, W, EPS)
    alpha = fc.arrow_fill(reads, rlens, tpls, trans, wlens, offs, W, EPS,
                          beta=False)
    beta = fc.arrow_fill(reads, rlens, tpls, trans, wlens, offs, W, EPS,
                         alpha=False)
    assert alpha[1] is None and beta[0] is None
    for fused, single in ((both[0], alpha[0]), (both[1], beta[1])):
        for a, b in zip(fused, single):
            assert torch.equal(a, b)
    a2, b2 = fc.forward_backward_batch(*batch, W)
    for mine, one in ((a2, fc.forward_batch(*batch, W)),
                      (b2, fc.backward_batch(*batch, W))):
        for a, b in zip(mine, one):
            assert torch.equal(a, b)
    state = fill_alpha_beta_batch(*batch, W)
    assert torch.equal(state.alpha.vals, a2.vals)
    assert torch.equal(state.beta.log_scales, b2.log_scales)
    assert torch.equal(state.ll_b, fc.backward_loglik_batch(b2, wlens))


def test_wrapper_cpu_dispatch():
    """CPU tensors run the plain version (coefficient planes, then
    fill_scan_plain) and launch nothing; a tensor on another device than
    the offsets, or a device that is neither CPU nor CUDA, raises."""
    W = 64
    batch = make_batch(50, 60, 4)
    reads, rlens, tpls, trans, wlens = batch
    offs = band_offsets(rlens, wlens, tpls.shape[1] + 1, W)
    before = fc.arrow_fill.launches
    (va, la), (vb, lb) = fc.arrow_fill(reads, rlens, tpls, trans, wlens,
                                       offs, W, EPS)
    assert fc.arrow_fill.launches == before
    for backward, (v, s) in ((False, (va, la)), (True, (vb, lb))):
        coeffs = fc._backward_coeffs if backward else fc._forward_coeffs
        planes = [x.contiguous() for x in coeffs(
            reads.int(), rlens, tpls.int(), trans, wlens, offs, W, EPS)]
        pv, ps = fc.fill_scan_plain(*planes, backward)
        assert torch.equal(v, pv) and torch.equal(s, ps)
    assert torch.equal(va, fc.arrow_fill_plain(*batch[:3], trans, wlens,
                                               offs, W, EPS)[0][0])
    with pytest.raises(ValueError):
        fc.arrow_fill(reads.to("meta"), rlens, tpls, trans, wlens, offs, W)
    meta = [x.to("meta") for x in (reads, rlens, tpls, trans, wlens, offs)]
    with pytest.raises(ValueError):
        fc.arrow_fill(*meta, W)
