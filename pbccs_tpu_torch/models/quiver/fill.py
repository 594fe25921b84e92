"""Banded Quiver forward/backward fills on K2 (csrc/quiver_fill.cu).

Port of pbccs_tpu.models.quiver.pallas_fill.  The TPU builds per-column
circular-lane band coefficients of the Quiver recurrence (reference
ConsensusCore/src/C++/Quiver/SimpleRecursor.cpp:62-231, move scores
QvEvaluator.hpp:160-207) as (R, nc, W) planes and scans them; here the
move scores are tabulated once per read position (`emission_tables`:
they depend on a cell only through the read position and base-equality
tests) and K2 (ops.quiver_fill_cuda.quiver_fill) builds every cell's
operands from those tables and scans the columns with the two-column
Merge carry.  The backward (beta) fill runs kernel columns k holding
beta column j = Jmax - k, stored at output column j, so the returned
matrix is in natural column order.

Two kinds of call: `forward_batch` / `backward_batch` return the band
values (fwdbwd.BandedMatrix, for parity tests and diagnostics);
`fill_lls` returns only the log-likelihoods, and on
the card nothing of size nc x W is written.  Both give bitwise the same
log-likelihoods (`_loglik` over the same log-scales and final cell).

Layout: nc = Jmax + 1 (the TPU's 64-column and power-of-two padding
bounded its compiled-program menu and is not needed here: columns past a
read's template length are dead, so the LLs do not depend on Jmax or
Imax)."""

from __future__ import annotations

import torch

from pbccs_tpu_torch.models.quiver.params import MERGE, QuiverConfig
from pbccs_tpu_torch.models.quiver.recursor import (QuiverFeatureArrays,
                                                    _move_params)
from pbccs_tpu_torch.ops import quiver_fill_cuda as qk
from pbccs_tpu_torch.ops.fwdbwd import BandedMatrix, band_offsets

_TINY = 1e-30


def emission_tables(feat: QuiverFeatureArrays,
                    config: QuiverConfig) -> torch.Tensor:
    """(R, Imax + 2, qk.N_COLS) float32 per-read-position move scores in
    exp space, with the TPU precompute's expressions (pallas_fill.py:64
    `_emissions`, float32, so every value is bitwise the one its planes
    held): row p holds read position p - 1, position 0 at p = 0 (its
    `_win_m1` front pad) and the last position again at p = Imax + 1 (its
    `_win` back pad).  feat leaves (R, Imax)."""
    pp = _move_params(config.qv_params)
    seq = feat.seq.float()
    dev = seq.device
    merge = pp["merge"].to(dev)
    merge_s = pp["merge_s"].to(dev)
    mrg = torch.exp(merge + merge_s * feat.merge_qv[..., None])
    cols = [seq,
            torch.exp(pp["mismatch"] + pp["mismatch_s"] * feat.subs_qv),
            torch.exp(pp["branch"] + pp["branch_s"] * feat.ins_qv),
            torch.exp(pp["nce"] + pp["nce_s"] * feat.ins_qv),
            *mrg.unbind(-1),
            feat.del_tag,
            torch.exp(pp["deletion_with_tag"]
                      + pp["deletion_with_tag_s"] * feat.del_qv),
            torch.exp(torch.full_like(seq, pp["match"])),
            torch.exp(torch.full_like(seq, pp["deletion_n"]))]
    t = torch.stack(cols, -1)
    return torch.cat([t[:, :1], t, t[:, -1:]], 1).contiguous()


def _use_merge(config: QuiverConfig) -> bool:
    return bool(config.moves_available & MERGE)


def _fill(feat, rlens, tpls, tlens, config, width,
          backward: bool) -> BandedMatrix:
    tables = emission_tables(feat, config)
    R, Jmax = tpls.shape
    I = rlens.to(torch.int32)
    J = tlens.to(torch.int32)
    offsets = band_offsets(I, J, Jmax + 1, width)
    idx = torch.arange(R, dtype=torch.int32, device=I.device)
    vals, ls, _ = qk.quiver_fill(tables, I.contiguous(),
                                 tpls.to(torch.int8).contiguous(),
                                 J.contiguous(), idx, idx, offsets, width,
                                 _use_merge(config), backward)
    return BandedMatrix(vals, offsets, ls)


def forward_batch(feat: QuiverFeatureArrays, rlens, tpls, tlens,
                  config: QuiverConfig, width: int) -> BandedMatrix:
    """Batched banded Quiver alpha fills: feat leaves (R, Imax), tpls
    (R, Jmax), rlens/tlens (R,).  Returns leaves (R, Jmax+1, W) /
    (R, Jmax+1).  Counterpart of pallas_quiver_forward_batch."""
    return _fill(feat, rlens, tpls, tlens, config, width, backward=False)


def backward_batch(feat: QuiverFeatureArrays, rlens, tpls, tlens,
                   config: QuiverConfig, width: int) -> BandedMatrix:
    """Batched banded Quiver beta fills in natural column order
    (counterpart of pallas_quiver_backward_batch)."""
    return _fill(feat, rlens, tpls, tlens, config, width, backward=True)


def _loglik(final, log_scales, J) -> torch.Tensor:
    """log(final cell) + the log-scales of columns 0..J."""
    jcols = torch.arange(log_scales.shape[1], device=J.device)[None, :]
    ls = torch.where(jcols <= J.to(torch.int32)[:, None], log_scales,
                     0.0).sum(1)
    return torch.log(torch.clamp(final, min=_TINY)) + ls


def fill_lls(tables, rlens, wins, wlens, row_read, row_win,
             config: QuiverConfig, width: int,
             backward: bool) -> torch.Tensor:
    """(R,) Quiver log-likelihoods of rows (read row_read[r] against
    window row_win[r]) from K2's log-likelihood-only mode: tables from
    emission_tables, rlens (n_reads,) int32, wins (M, Jmax) int8, wlens
    (M,) int32, row_read / row_win (R,) int32.  Bitwise what
    forward_batch / backward_batch + quiver_loglik_* give."""
    I = rlens[row_read.long()]
    J = wlens[row_win.long()]
    offsets = band_offsets(I, J, wins.shape[1] + 1, width)
    _, ls, final = qk.quiver_fill(tables, rlens, wins, wlens, row_read,
                                  row_win, offsets, width,
                                  _use_merge(config), backward, vals=False)
    return _loglik(final, ls, J)


def quiver_loglik_batch(alpha: BandedMatrix, rlens, tlens) -> torch.Tensor:
    """LL[r] = log alpha(I, J) + the column log-scales; alpha(I, J) is one
    gathered cell (qk.final_cell), 0 where row I is outside column J's
    band -- what the TPU's masked band sum gives, adding zeros exactly."""
    I = rlens.to(torch.int32)
    J = tlens.to(torch.int32)
    return _loglik(qk.final_cell(alpha.vals, alpha.offsets, I, J, False),
                   alpha.log_scales, J)


def quiver_loglik_backward_batch(beta: BandedMatrix, tlens) -> torch.Tensor:
    """LL[r] = log beta(0, 0) + the column log-scales."""
    return _loglik(beta.vals[:, 0, 0], beta.log_scales, tlens)
