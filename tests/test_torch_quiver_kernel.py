"""K2's operands and log-likelihood modes on the CPU: the emission-table
selection (ops.quiver_fill_cuda) against the coefficient planes the port
built before it (copied below as the oracle) and the JAX Pallas
precompute; the log-likelihood-only fills, indexed rows and the gathered
final cell against the band-value path.

Tolerances: bitwise against the oracle and between the port's own paths
(the same float32 expressions, selected instead of recomputed per cell);
rtol 1e-6 against JAX (its windows are one-hot matmuls and XLA's exp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbccs_tpu.models.quiver import pallas_fill as jpf
from pbccs_tpu.models.quiver.params import (ALL_MOVES, BASIC_MOVES,
                                            BandingOptions, QuiverConfig)
from pbccs_tpu.models.quiver.recursor import QuiverFeatureArrays as JFeat
from pbccs_tpu.models.quiver.recursor import _move_params as j_move_params

from pbccs_tpu_torch import convert
from pbccs_tpu_torch.models.quiver import fill as tfill
from pbccs_tpu_torch.models.quiver.recursor import (QuiverFeatureArrays,
                                                    _move_params)
from pbccs_tpu_torch.ops import quiver_fill_cuda as qk
from pbccs_tpu_torch.ops.fwdbwd import (BandedMatrix, band_offsets,
                                        circ_rows, in_band)
from pbccs_tpu_torch.ops.fwdbwd_cuda import _clip_cols

from test_torch_quiver import _fixture

# one torch intra-op thread per pytest-xdist worker process
torch.set_num_threads(1)


# --------------------------------------------------------------------------
# the oracle: the Quiver coefficient precompute as the port had it before
# the emission tables (per-cell gathers of the feature tracks, then exp)
# --------------------------------------------------------------------------


def _gather_rows(xp: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """y[r, j, L] = xp[r, rows[r, j, L]], 0 past the end of xp (the
    circular window of ops.fwdbwd_cuda.window_rows_circ, on a row map
    the caller computed once)."""
    R, N = xp.shape
    got = torch.gather(xp, 1, rows.clamp(max=N - 1).reshape(R, -1).long())
    return torch.where(rows < N, got.reshape(rows.shape),
                       torch.zeros((), dtype=xp.dtype, device=xp.device))


def _win(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """y[r, j, L] = x[r, row] over the band rows, x padded with one back
    row repeating its last value (0 past that)."""
    return _gather_rows(torch.cat([x, x[:, -1:]], 1), rows)


def _win_m1(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """y[r, j, L] = x[r, row - 1], row 0 reading x's first value."""
    return _gather_rows(torch.cat([x[:, :1], x], 1), rows)


def _emissions(pp, rows, seq_w, subs_w, ins_w, dtag_w, dqv_w, mqv_w,
               tb_inc, tb_extra, tb_mrg, tb_mrg2, I, in_tpl, mrg_ok):
    """exp-space Incorporate / Delete / Extra / Merge planes over (R, nc,
    W) windows whose feature tracks were gathered at each plane's row
    index (see the callers); tb_* are (R, nc, 1) per-column template
    bases, so the Merge score is indexed by each column's base."""
    inc = torch.where(seq_w == tb_inc, pp["match"],
                      pp["mismatch"] + pp["mismatch_s"] * subs_w)

    tagged = (rows < I) & (dtag_w == tb_inc.float())
    dele = torch.where(tagged,
                       pp["deletion_with_tag"]
                       + pp["deletion_with_tag_s"] * dqv_w,
                       pp["deletion_n"])

    extra_match = in_tpl & (seq_w == tb_extra)
    extra = torch.where(extra_match, pp["branch"] + pp["branch_s"] * ins_w,
                        pp["nce"] + pp["nce_s"] * ins_w)

    good = mrg_ok & (seq_w == tb_mrg) & (tb_mrg == tb_mrg2)
    tb = tb_mrg.clamp(0, 3).long()
    merge = pp["merge"].to(seq_w.device)
    merge_s = pp["merge_s"].to(seq_w.device)
    mrg_score = merge[tb] + merge_s[tb] * mqv_w
    mrg = torch.where(good, torch.exp(mrg_score), 0.0)
    return torch.exp(inc), torch.exp(dele), torch.exp(extra), mrg


def _old_forward_coeffs(feat: QuiverFeatureArrays, I, tpls, J, offsets, W: int,
                    pp, use_merge: bool):
    """Per-column band coefficients of the Quiver alpha recurrence for a
    read batch, mirroring the JAX package's recursor column for column.
    feat leaves (R, Imax); I, J (R,) int32; tpls (R, Jmax); offsets
    (R, nc).  Returns cm, cd, cc, cg (R, nc, W), mask (R, nc), seed
    (R, W), seedcol (R,)."""
    R, nc = offsets.shape
    dev = offsets.device
    jr = torch.arange(nc, device=dev)
    j = jr.to(torch.int32)[None, :, None]
    o = offsets[:, :, None]
    om1 = _clip_cols(offsets, jr - 1)[:, :, None]
    om2 = _clip_cols(offsets, jr - 2)[:, :, None]
    I3, J3 = I[:, None, None], J[:, None, None]

    rows = circ_rows(offsets, W)
    valid = (rows >= 0) & (rows <= I3)

    # feature windows at row index rows-1 (Inc/Extra/Merge read base) and
    # rows (Del tag/qv)
    seq_m1 = _win_m1(feat.seq.float(), rows)
    subs_m1 = _win_m1(feat.subs_qv, rows)
    ins_m1 = _win_m1(feat.ins_qv, rows)
    mqv_m1 = _win_m1(feat.merge_qv, rows)
    dtag_0 = _win(feat.del_tag, rows)
    dqv_0 = _win(feat.del_qv, rows)

    tb_prev = _clip_cols(tpls, jr - 1)[:, :, None]      # template base j-1
    tb_cur = _clip_cols(tpls, jr)[:, :, None]           # template base j
    tb_prev2 = _clip_cols(tpls, jr - 2)[:, :, None]     # template base j-2

    inc, dele, extra, mrg = _emissions(
        pp, rows, seq_m1, subs_m1, ins_m1, dtag_0, dqv_0, mqv_m1,
        tb_inc=tb_prev, tb_extra=tb_cur, tb_mrg=tb_prev2, tb_mrg2=tb_prev,
        I=I3, in_tpl=j < J3, mrg_ok=(j >= 2) & use_merge)

    live = (j >= 1) & (j <= J3)
    cm = torch.where(valid & (rows >= 1) & live & in_band(rows - 1, om1, W),
                     inc, 0.0)
    cd = torch.where(valid & live & in_band(rows, om1, W), dele, 0.0)
    cg = torch.where(valid & (rows >= 1) & live & in_band(rows - 1, om2, W),
                     mrg, 0.0)
    # column 0 chains Extra below the alpha(0,0) impulse; dead columns
    # j > J have no in-column move; rows > o cuts the circular scan at the
    # band's first row
    cc = torch.where(valid & (rows >= 1) & (j <= J3) & (rows > o), extra, 0.0)

    mask = (j[:, :, 0] <= J[:, None]).float()
    seed = torch.zeros(R, W, device=dev)
    seed[:, 0] = 1.0
    seedcol = torch.zeros(R, dtype=torch.int32, device=dev)
    return cm, cd, cc, cg, mask, seed, seedcol


def _old_backward_coeffs(feat: QuiverFeatureArrays, I, tpls, J, offsets, W: int,
                     pp, use_merge: bool):
    """Beta coefficients in the kernel frame (kernel column k holds beta
    column j = Jmax - k, lanes in the shared circular layout; the
    backward scan rolls the other way), mirroring the JAX package's
    recursor column for column; conventions of _forward_coeffs."""
    R, nc = offsets.shape
    Jmax = tpls.shape[1]
    dev = offsets.device
    k = torch.arange(nc, device=dev)
    j = (Jmax - k).to(torch.int32)[None, :, None]
    o_jv = _clip_cols(offsets, Jmax - k)
    o_j = o_jv[:, :, None]
    o_j1 = _clip_cols(offsets, Jmax + 1 - k)[:, :, None]
    o_j2 = _clip_cols(offsets, Jmax + 2 - k)[:, :, None]
    I3, J3 = I[:, None, None], J[:, None, None]

    rows = circ_rows(o_jv, W)
    valid = (rows >= 0) & (rows <= I3)

    # every backward lookup is at row index `rows`
    seq_0 = _win(feat.seq.float(), rows)
    subs_0 = _win(feat.subs_qv, rows)
    ins_0 = _win(feat.ins_qv, rows)
    mqv_0 = _win(feat.merge_qv, rows)
    dtag_0 = _win(feat.del_tag, rows)
    dqv_0 = _win(feat.del_qv, rows)

    tb = _clip_cols(tpls, Jmax - k)[:, :, None]            # base j
    tb_next = _clip_cols(tpls, Jmax + 1 - k)[:, :, None]   # base j+1

    inc, dele, extra, mrg = _emissions(
        pp, rows, seq_0, subs_0, ins_0, dtag_0, dqv_0, mqv_0,
        tb_inc=tb, tb_extra=tb, tb_mrg=tb, tb_mrg2=tb_next,
        I=I3, in_tpl=j < J3, mrg_ok=(j + 1 < J3) & use_merge)

    live = (j >= 0) & (j < J3)
    cm = torch.where(valid & (rows < I3) & live & in_band(rows + 1, o_j1, W),
                     inc, 0.0)
    cd = torch.where(valid & live & in_band(rows, o_j1, W), dele, 0.0)
    cg = torch.where(valid & (rows < I3) & live & in_band(rows + 1, o_j2, W),
                     mrg, 0.0)
    # rows < o + W - 1 cuts the reverse circular scan at the band top
    cc = torch.where(valid & (rows < I3) & (j >= 0) & (j <= J3)
                     & (rows < o_j + W - 1), extra, 0.0)

    jj = j[:, :, 0]
    mask = ((jj >= 0) & (jj <= J[:, None])).float()
    seed = (torch.arange(W, device=dev)[None, :]
            == (I % W)[:, None]).float()
    seedcol = (Jmax - J).to(torch.int32)
    return cm, cd, cc, cg, mask, seed, seedcol


def _old_loglik(alpha: BandedMatrix, rlens, tlens) -> torch.Tensor:
    """The masked-sum log-likelihood the port had before the gather."""
    I = rlens.to(torch.int32)[:, None]
    J = tlens.to(torch.int32)[:, None]
    W = alpha.vals.shape[2]
    jcols = torch.arange(alpha.vals.shape[1], device=I.device)[None, :]
    at_J = (jcols == J)[:, :, None]
    rows = circ_rows(alpha.offsets, W)
    final = torch.where(at_J & (rows == I[:, :, None]), alpha.vals,
                        0.0).sum((1, 2))
    ls = torch.where(jcols <= J, alpha.log_scales, 0.0).sum(1)
    return torch.log(torch.clamp(final, min=1e-30)) + ls


# --------------------------------------------------------------------------
# fixtures
# --------------------------------------------------------------------------


def _case(seed: int, n: int = 6):
    """_fixture's draw (templates of 8..59 bases, noisy QV-feature reads,
    padded to Imax 128 / Jmax 64) plus one read against an empty window,
    as port tensors and the numpy arrays."""
    rng = np.random.default_rng(seed)
    _, stacked, tpls, tlens, rlens = _fixture(rng, n=n)
    tlens[-1] = 0
    tpls[-1] = 4
    feat = convert.quiver_features_from_numpy(stacked)
    t = torch.as_tensor
    return dict(np=(stacked, tpls, tlens, rlens), feat=feat,
                I=t(rlens), J=t(tlens), tpls=t(tpls).to(torch.int32))


def _cfg(merge: bool, W: int):
    return QuiverConfig(moves_available=ALL_MOVES if merge else BASIC_MOVES,
                        banding=BandingOptions(band_width=W))


@pytest.mark.parametrize("W", [16, 64])
@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("backward", [False, True])
def test_table_planes_match_todays_planes(backward, merge, W):
    """Selected from the emission tables, the seven K2 operands are
    bitwise the planes the per-cell precompute built, and within rtol
    1e-6 of the JAX Pallas precompute's (W = 64 is wider than most of
    these reads)."""
    c = _case(40 + W)
    jcfg = _cfg(merge, W)
    cfg = convert.quiver_config_from_jax(jcfg)
    R, Jmax = c["tpls"].shape
    offsets = band_offsets(c["I"], c["J"], Jmax + 1, W)
    tables = tfill.emission_tables(c["feat"], cfg)
    rows = torch.arange(R, dtype=torch.int32)
    new_fn = qk._backward_coeffs if backward else qk._forward_coeffs
    old_fn = _old_backward_coeffs if backward else _old_forward_coeffs
    new = new_fn(tables, rows, c["I"], c["tpls"], c["J"], offsets, W, merge)
    old = old_fn(c["feat"], c["I"], c["tpls"], c["J"], offsets, W,
                 _move_params(cfg.qv_params), merge)
    for a, b in zip(new, old):
        assert a.dtype == b.dtype and torch.equal(a, b)

    stacked, tpls, tlens, rlens = c["np"]
    jfn = jpf._backward_coeffs if backward else jpf._forward_coeffs
    pp = j_move_params(jcfg.qv_params)
    want = jax.vmap(lambda f, i, t, jl, o: jfn(
        f, i, t.astype(jnp.int32), jl, o, W, pp, merge, jnp.asarray(True),
        jnp.asarray(True)))(JFeat(*(jnp.asarray(x) for x in stacked)),
                            jnp.asarray(rlens), jnp.asarray(tpls),
                            jnp.asarray(tlens), jnp.asarray(offsets.numpy()))
    for a, b in zip(new[:4], want[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    for a, b in zip(new[4:], want[4:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("backward", [False, True])
def test_ll_only_equals_full_fill(backward):
    """fill_lls (K2's log-likelihood mode) is bitwise
    forward_batch / backward_batch followed by quiver_loglik_*."""
    c = _case(7)
    cfg = convert.quiver_config_from_jax(_cfg(True, 32))
    R = c["I"].shape[0]
    rows = torch.arange(R, dtype=torch.int32)
    tables = tfill.emission_tables(c["feat"], cfg)
    wins = c["tpls"].to(torch.int8)
    if backward:
        bm = tfill.backward_batch(c["feat"], c["I"], c["tpls"], c["J"], cfg,
                                  32)
        want = tfill.quiver_loglik_backward_batch(bm, c["J"])
        got = tfill.fill_lls(tables, c["I"], wins, c["J"], rows, rows, cfg,
                             32, backward=True)
    else:
        bm = tfill.forward_batch(c["feat"], c["I"], c["tpls"], c["J"], cfg,
                                 32)
        want = tfill.quiver_loglik_batch(bm, c["I"], c["J"])
        got = tfill.fill_lls(tables, c["I"], wins, c["J"], rows, rows, cfg,
                             32, backward=False)
    assert torch.isfinite(want[:-1]).all()
    assert torch.equal(got, want)
    _, ls, fin = qk.quiver_fill(tables, c["I"], wins, c["J"], rows, rows,
                                bm.offsets, 32, True, backward, vals=False)
    _, ls_a, fin_a = qk.quiver_fill(tables, c["I"], wins, c["J"], rows, rows,
                                    bm.offsets, 32, True, backward)
    assert torch.equal(ls, ls_a) and torch.equal(fin, fin_a)
    assert torch.equal(ls, bm.log_scales)


@pytest.mark.parametrize("backward", [False, True])
def test_indexed_rows_equal_replicated_rows(backward):
    """G reads x M windows named by (row_read, row_win) give bitwise the
    fills of the same rows written out (features and windows replicated
    per row), as the scorer's groups use them."""
    c = _case(8, n=5)
    cfg = convert.quiver_config_from_jax(_cfg(True, 32))
    tables = tfill.emission_tables(c["feat"], cfg)
    G, M = 3, 4
    reads = torch.tensor([0, 2, 3], dtype=torch.int32)
    row_read = reads.repeat_interleave(M)
    row_win = torch.arange(M, dtype=torch.int32).repeat(G)
    wins = c["tpls"][1:1 + M].to(torch.int8)
    wlens = c["J"][1:1 + M].to(torch.int32)
    I = c["I"].to(torch.int32)
    offsets = band_offsets(I[row_read.long()], wlens[row_win.long()],
                           wins.shape[1] + 1, 32)
    got = qk.quiver_fill(tables, I, wins, wlens, row_read, row_win,
                         offsets, 32, True, backward)
    rr, rw = row_read.long(), row_win.long()
    ident = torch.arange(G * M, dtype=torch.int32)
    want = qk.quiver_fill(tables[rr].contiguous(), I[rr], wins[rw],
                          wlens[rw], ident, ident, offsets, 32, True,
                          backward)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    lls = tfill.fill_lls(tables, I, wins, wlens, row_read, row_win, cfg, 32,
                         backward)
    feat = type(c["feat"])(*(x[rr] for x in c["feat"]))
    batch = tfill.backward_batch if backward else tfill.forward_batch
    bm = batch(feat, I[rr], wins[rw], wlens[rw], cfg, 32)
    ll = (tfill.quiver_loglik_backward_batch(bm, wlens[rw]) if backward
          else tfill.quiver_loglik_batch(bm, I[rr], wlens[rw]))
    assert torch.equal(lls, ll)


def test_gather_ll_equals_masked_sum_ll():
    """The gathered final cell gives bitwise the masked band sum's
    log-likelihood, on real fills and on random band matrices whose
    final row falls outside column J's band."""
    c = _case(9)
    cfg = convert.quiver_config_from_jax(_cfg(True, 16))
    bm = tfill.forward_batch(c["feat"], c["I"], c["tpls"], c["J"], cfg, 16)
    assert torch.equal(tfill.quiver_loglik_batch(bm, c["I"], c["J"]),
                       _old_loglik(bm, c["I"], c["J"]))
    rng = np.random.default_rng(3)
    R, nc, W = 40, 30, 16
    vals = torch.as_tensor(rng.random((R, nc, W)), dtype=torch.float32)
    offs = torch.as_tensor(np.sort(rng.integers(0, 60, (R, nc)), 1),
                           dtype=torch.int32)
    ls = torch.as_tensor(rng.normal(size=(R, nc)), dtype=torch.float32)
    I = torch.as_tensor(rng.integers(0, 80, R), dtype=torch.int32)
    J = torch.as_tensor(rng.integers(0, nc, R), dtype=torch.int32)
    rand = BandedMatrix(vals, offs, ls)
    inb = in_band(I, offs[torch.arange(R), J.long()], W)
    assert 0 < int(inb.sum()) < R
    assert torch.equal(tfill.quiver_loglik_batch(rand, I, J),
                       _old_loglik(rand, I, J))


def test_quiver_fill_cpu_dispatch_and_checks():
    """CPU tensors run the plain version without counting a launch; mixed
    devices raise; the LL-only mode returns no band values."""
    c = _case(10, n=3)
    cfg = convert.quiver_config_from_jax(_cfg(True, 32))
    tables = tfill.emission_tables(c["feat"], cfg)
    rows = torch.arange(3, dtype=torch.int32)
    wins = c["tpls"].to(torch.int8)
    J = c["J"].to(torch.int32)
    I = c["I"].to(torch.int32)
    offsets = band_offsets(I, J, wins.shape[1] + 1, 32)
    before = qk.quiver_fill.launches
    vals, ls, fin = qk.quiver_fill(tables, I, wins, J, rows, rows, offsets,
                                   32, True, False, vals=False)
    assert vals is None and ls.shape == offsets.shape and fin.shape == (3,)
    assert qk.quiver_fill.launches == before
    with pytest.raises(ValueError):
        qk.quiver_fill(tables, I, wins, J, rows, rows,
                       offsets.to("meta"), 32, True, False)
    # the table rows repeat the read's first and last positions at its ends
    assert torch.equal(tables[:, 0], tables[:, 1])
    assert torch.equal(tables[:, -1], tables[:, -2])
    assert tables.shape[2] == qk.N_COLS
