"""K2: the banded Quiver alpha/beta fills (csrc/quiver_fill.cu) and their
plain torch version.

Port of pbccs_tpu.ops.fwdbwd_pallas._fill_kernel with merge=True together
with the coefficient precompute that feeds it,
pbccs_tpu.models.quiver.pallas_fill._forward_coeffs / _backward_coeffs.
The Quiver move scores (reference QvEvaluator.hpp:160-207) depend on a
cell only through the read position (the QV tracks) and equality tests
between the read base and one or two template bases, so they are
tabulated once per read position (models.quiver.fill.emission_tables,
`N_COLS` float32 per row) and every cell's operands of the column
recurrence

    col[L] = cm[L] * roll(prev, t)[L]                (Incorporate)
           + cd[L] * prev[L]                         (Delete)
           + cg[L] * roll(prev2, t)[L] / scale_prev  (Merge, two columns back)
           + cc[L] * col[L - t circ]                 (Extra, in-column)

(t = +1 forward, -1 backward; fwdbwd.BandedMatrix's circular lanes) are
selected from those tables with the band masks.  A fill batch names its
rows by index: row r is read `row_read[r]` (a table) against window
`row_win[r]` of an (M, Jmax) int8 window tensor, so a group of reads
scored against many mutated windows uploads each window once.

`quiver_fill` launches the kernel on CUDA tensors (it builds the operands
itself and never writes an (R, nc, W) coefficient plane); on CPU tensors
it runs `quiver_fill_plain`: the same operands as planes
(`_forward_coeffs` / `_backward_coeffs`) and the scan
`ops.fwdbwd_cuda.fill_scan_merge_plain`.  Both return band values (or
None with vals=False), log-scales (R, nc) and the one cell the
log-likelihood needs (`final_cell`).  The backward fill runs kernel
columns k holding beta column j = Jmax - k, stored at output column j."""

from __future__ import annotations

import ctypes

import torch

from pbccs_tpu_torch.ops import cuda_lib
from pbccs_tpu_torch.ops.fwdbwd import circ_rows, in_band
from pbccs_tpu_torch.ops.fwdbwd_cuda import _clip_cols, fill_scan_merge_plain

#: columns of an emission-table row (row p of read r holds the features of
#: read position p - 1, position 0 at p = 0 and the last position again at
#: p = Imax + 1): the base code, exp of the Mismatch, Branch and
#: Nce scores, exp of the four per-base Merge scores, the deletion tag,
#: exp of the tagged-Deletion score, and the constants exp(Match) and
#: exp(DeletionN)
T_SEQ, T_MIS, T_BRANCH, T_NCE, T_MERGE = 0, 1, 2, 3, 4
T_DTAG, T_DELT, T_MATCH, T_DELN = 8, 9, 10, 11
N_COLS = 12
#: band widths the kernel is built for: 32 lanes per held slot
MAX_SLOTS = 4


def _picker(tables: torch.Tensor, row_read: torch.Tensor):
    """pick(p, col)[...] = tables[row_read[r], p, col] for index tensors
    p (R, ...) and col (broadcastable), one flat gather."""
    flat = tables.reshape(-1)
    P = tables.shape[1]
    base = row_read.long().reshape(-1, 1, 1) * P

    def pick(p, col):
        return flat[(base + p) * N_COLS + col]
    return pick


def _forward_coeffs(tables, row_read, I, tpls, J, offsets, W: int,
                    use_merge: bool):
    """The alpha recurrence's operands, selected from the emission tables
    (pbccs_tpu/models/quiver/pallas_fill.py:94, column for column).
    I, J (R,) int32; tpls (R, Jmax) int32; offsets (R, nc).  Returns cm,
    cd, cc, cg (R, nc, W), mask (R, nc), seed (R, W), seedcol (R,)."""
    R, nc = offsets.shape
    dev = offsets.device
    P = tables.shape[1]
    jr = torch.arange(nc, device=dev)
    j = jr.to(torch.int32)[None, :, None]
    o = offsets[:, :, None]
    om1 = _clip_cols(offsets, jr - 1)[:, :, None]
    om2 = _clip_cols(offsets, jr - 2)[:, :, None]
    I3, J3 = I[:, None, None], J[:, None, None]

    rows = circ_rows(offsets, W)
    valid = (rows >= 0) & (rows <= I3)
    pick = _picker(tables, row_read)
    at_m1 = rows.long().clamp(max=P - 1)        # features of row - 1
    at_0 = (rows.long() + 1).clamp(max=P - 1)   # features of row
    seq = pick(at_m1, T_SEQ)

    tb_prev = _clip_cols(tpls, jr - 1)[:, :, None]      # template base j-1
    tb_cur = _clip_cols(tpls, jr)[:, :, None]           # template base j
    tb_prev2 = _clip_cols(tpls, jr - 2)[:, :, None]     # template base j-2

    inc = torch.where(seq == tb_prev, tables[0, 0, T_MATCH],
                      pick(at_m1, T_MIS))
    tagged = (rows < I3) & (pick(at_0, T_DTAG) == tb_prev.float())
    dele = torch.where(tagged, pick(at_0, T_DELT), tables[0, 0, T_DELN])
    extra = torch.where((j < J3) & (seq == tb_cur), pick(at_m1, T_BRANCH),
                        pick(at_m1, T_NCE))
    good = ((j >= 2) & use_merge) & (seq == tb_prev2) & (tb_prev2 == tb_prev)
    mrg = torch.where(good, pick(at_m1, T_MERGE + tb_prev2.clamp(0, 3).long()),
                      0.0)

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


def _backward_coeffs(tables, row_read, I, tpls, J, offsets, W: int,
                     use_merge: bool):
    """Beta operands in the kernel frame (kernel column k holds beta
    column j = Jmax - k; the backward scan rolls the other way), selected
    from the emission tables (pbccs_tpu/models/quiver/pallas_fill.py:144,
    column for column); conventions of _forward_coeffs."""
    R, nc = offsets.shape
    Jmax = tpls.shape[1]
    dev = offsets.device
    P = tables.shape[1]
    k = torch.arange(nc, device=dev)
    j = (Jmax - k).to(torch.int32)[None, :, None]
    o_jv = _clip_cols(offsets, Jmax - k)
    o_j = o_jv[:, :, None]
    o_j1 = _clip_cols(offsets, Jmax + 1 - k)[:, :, None]
    o_j2 = _clip_cols(offsets, Jmax + 2 - k)[:, :, None]
    I3, J3 = I[:, None, None], J[:, None, None]

    rows = circ_rows(o_jv, W)
    valid = (rows >= 0) & (rows <= I3)
    pick = _picker(tables, row_read)
    at_0 = (rows.long() + 1).clamp(max=P - 1)   # every lookup: row's own
    seq = pick(at_0, T_SEQ)

    tb = _clip_cols(tpls, Jmax - k)[:, :, None]            # base j
    tb_next = _clip_cols(tpls, Jmax + 1 - k)[:, :, None]   # base j+1

    inc = torch.where(seq == tb, tables[0, 0, T_MATCH], pick(at_0, T_MIS))
    tagged = (rows < I3) & (pick(at_0, T_DTAG) == tb.float())
    dele = torch.where(tagged, pick(at_0, T_DELT), tables[0, 0, T_DELN])
    extra = torch.where((j < J3) & (seq == tb), pick(at_0, T_BRANCH),
                        pick(at_0, T_NCE))
    good = ((j + 1 < J3) & use_merge) & (seq == tb) & (tb == tb_next)
    mrg = torch.where(good, pick(at_0, T_MERGE + tb.clamp(0, 3).long()), 0.0)

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


def final_cell(vals, offsets, I, J, backward: bool) -> torch.Tensor:
    """(R,) the cell a fill's log-likelihood reads: alpha(I, J), lane
    I mod W of column J when o(J) <= I < o(J) + W and 0 otherwise, or
    beta(0, 0), lane 0 of column 0 (row 0 is always in column 0's band)."""
    if backward:
        return vals[:, 0, 0]
    W = vals.shape[2]
    ar = torch.arange(vals.shape[0], device=vals.device)
    Jl = J.long()
    o = offsets[ar, Jl]
    inb = (o <= I) & (I < o + W)
    return torch.where(inb, vals[ar, Jl, (I % W).long()], 0.0)


def quiver_fill_plain(tables, rlens, wins, wlens, row_read, row_win,
                      offsets, width: int, merge: bool, backward: bool,
                      vals: bool = True):
    """quiver_fill in plain torch: the operand planes selected from the
    tables, then fill_scan_merge_plain (every product, sum and quotient
    flushed to zero below F32_MIN_NORMAL, as the kernel's -ftz=true
    arithmetic does).  Returns (vals or None, log-scales, final cells)."""
    rr, rw = row_read.long(), row_win.long()
    I, J, tpls = rlens[rr], wlens[rw], wins[rw].to(torch.int32)
    coeffs = _backward_coeffs if backward else _forward_coeffs
    ops = coeffs(tables, row_read, I, tpls, J, offsets, width, merge)
    v, ls = fill_scan_merge_plain(*(x.contiguous() for x in ops), backward)
    return (v if vals else None), ls, final_cell(v, offsets, I, J, backward)


_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int]
             + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def quiver_fill(tables, rlens, wins, wlens, row_read, row_win, offsets,
                width: int, merge: bool, backward: bool, vals: bool = True):
    """The K2 Quiver fill of R rows: tables (n_reads, Imax + 2, N_COLS)
    float32 (models.quiver.fill.emission_tables), rlens (n_reads,) int32,
    wins (M, Jmax) int8 template windows with lengths wlens (M,) int32,
    row_read / row_win (R,) int32 indices into them (in range), offsets
    (R, Jmax + 1) int32 (ops.fwdbwd.band_offsets).  `merge` enables the
    Merge move.  Returns band values (R, Jmax + 1, W) or None with
    vals=False (log-likelihood-only mode: nothing of size nc x W is
    written), log-scales (R, Jmax + 1) and final_cell's (R,) cells, both
    bitwise the same in the two modes.  CPU tensors run quiver_fill_plain;
    CUDA tensors launch csrc/quiver_fill.cu on the current stream (no
    fallback)."""
    args = {"tables": (tables, torch.float32, 3),
            "rlens": (rlens, torch.int32, 1), "wins": (wins, torch.int8, 2),
            "wlens": (wlens, torch.int32, 1),
            "row_read": (row_read, torch.int32, 1),
            "row_win": (row_win, torch.int32, 1),
            "offsets": (offsets, torch.int32, 2)}
    dev = offsets.device
    for name, (x, dtype, ndim) in args.items():
        if x.device != dev:
            raise ValueError(f"quiver_fill: {name} is on {x.device}, "
                             f"offsets on {dev}")
    if dev.type == "cpu":
        return quiver_fill_plain(tables, rlens, wins, wlens, row_read,
                                 row_win, offsets, width, merge, backward,
                                 vals)
    if dev.type != "cuda":
        raise ValueError(f"quiver_fill: unsupported device {dev}")
    for name, (x, dtype, ndim) in args.items():
        cuda_lib.check_tensor("quiver_fill", name, x, dtype, ndim)
    R, nc = offsets.shape
    M, Jmax = wins.shape
    n, P, ncols = tables.shape
    if width % 32 or not 32 <= width <= 32 * MAX_SLOTS:
        raise ValueError(f"quiver_fill: band width {width} is not a "
                         f"multiple of 32 in [32, {32 * MAX_SLOTS}]")
    if ncols != N_COLS or P < 2 or tables.data_ptr() % 16:
        raise ValueError(f"quiver_fill: tables must be 16-byte aligned "
                         f"(n, >= 2, {N_COLS}), got {tuple(tables.shape)}")
    if Jmax < 1 or nc != Jmax + 1:
        raise ValueError(f"quiver_fill: offsets have {nc} columns for "
                         f"{Jmax}-column windows")
    if rlens.shape[0] != n or wlens.shape[0] != M \
            or row_read.shape[0] != R or row_win.shape[0] != R:
        raise ValueError("quiver_fill: index or length tensors do not "
                         "match the tables, windows or offsets")
    out = torch.empty(R, nc, width, device=dev) if vals else None
    ls = (torch.empty if vals else torch.zeros)(R, nc, device=dev)
    fin = torch.empty(R, device=dev)
    fn = cuda_lib.load("quiver_fill").pbccs_quiver_fill
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(tables.data_ptr(), P, rlens.data_ptr(), wins.data_ptr(),
                 wlens.data_ptr(), row_read.data_ptr(), row_win.data_ptr(),
                 offsets.data_ptr(), out.data_ptr() if vals else None,
                 ls.data_ptr(), fin.data_ptr(), R, Jmax, width, int(merge),
                 int(backward), stream)
    cuda_lib.check(err, "quiver_fill")
    quiver_fill.launches += 1
    return out, ls, fin


quiver_fill.launches = 0
