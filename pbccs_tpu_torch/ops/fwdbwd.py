"""Banded Arrow pair-HMM layout helpers: circular-lane band matrices.

Port of the layout half of pbccs_tpu.ops.fwdbwd.  The reference adapts
its band per column (ConsensusCore SimpleRecursor.cpp:62-296); here, as in
the JAX package, every column holds a STATIC band of W rows starting at
an integer offset, in CIRCULAR lane layout: matrix cell (i, j) lives at
lane i mod W whatever the column's offset, so aligning one column with
the next is a fixed lane roll plus an in-band mask.  The in-column
insertion recurrence v[L] = b[L] + c[L] * v[L-1] is solved as a
log2(W)-step Hillis-Steele affine scan over those lanes.

All functions take leading batch axes; offsets are int32."""

from __future__ import annotations

from typing import NamedTuple

import torch


class BandedMatrix(NamedTuple):
    """Batched column-banded DP matrices in circular lane layout.

    vals:       (R, nc, W) band values; vals[r, j, L] is matrix cell
                (i, j) for the in-band row i === L (mod W); each column
                rescaled so its max is 1.
    offsets:    (R, nc) int32 first row of each column's band.
    log_scales: (R, nc) float32 log column scale factors."""

    vals: torch.Tensor
    offsets: torch.Tensor
    log_scales: torch.Tensor

    @property
    def width(self) -> int:
        return self.vals.shape[-1]


def band_offsets(read_len: torch.Tensor, tpl_len: torch.Tensor,
                 n_cols: int, width: int) -> torch.Tensor:
    """(R, n_cols) diagonal band layout: column j covers rows
    [o(j), o(j)+W) with o(j) centered on i = j * I/J, clamped to the read
    (float32 arithmetic, as in the JAX package)."""
    dev = read_len.device
    j = torch.arange(n_cols, dtype=torch.float32, device=dev)
    ratio = read_len.float() / torch.clamp(tpl_len.float(), min=1.0)
    center = j[None, :] * ratio[:, None]
    off = torch.floor(center).to(torch.int32) - width // 2
    hi = torch.clamp(read_len.to(torch.int32) + 1 - width, min=0)
    return torch.minimum(torch.clamp(off, min=0), hi[:, None])


def circ_rows(offset: torch.Tensor, width: int) -> torch.Tensor:
    """(..., W) absolute row of each circular lane for columns with band
    offsets `offset` (any shape; a trailing lane axis is appended)."""
    offset = offset.to(torch.int32)[..., None]
    L = torch.arange(width, dtype=torch.int32, device=offset.device)
    q = offset % width
    return offset - q + L + torch.where(L < q, width, 0)


def circ_roll(x: torch.Tensor, t: int) -> torch.Tensor:
    """Circular lane roll: y[..., L] = x[..., (L - t) mod W].  t=+1 puts
    the previous row's value under each lane, t=-1 the next row's."""
    if t == 0:
        return x
    return torch.roll(x, t, dims=-1)


def in_band(rows: torch.Tensor, offset, width: int) -> torch.Tensor:
    """Mask: absolute row inside the band [offset, offset+W)."""
    return (rows >= offset) & (rows < offset + width)


#: Smallest normal float32.  The DP arithmetic flushes results below it
#: to zero, as the TPU and XLA's CPU backend do, so the port keeps the
#: reference's in-column dynamic range (~87 nats below the column max)
#: and gates the same reads: a read whose only path runs through
#: subnormal values fails the alpha/beta mating test in both.  The CUDA
#: kernels get the same behaviour from nvcc's -ftz=true.
F32_MIN_NORMAL = float(torch.finfo(torch.float32).tiny)


def ftz(x: torch.Tensor) -> torch.Tensor:
    """x with float32 subnormals flushed to zero (one rounding step of
    the kernels' flush-to-zero arithmetic)."""
    return torch.where(x.abs() < F32_MIN_NORMAL, 0.0, x)


def _affine_scan_circ(b: torch.Tensor, c: torch.Tensor,
                      reverse: bool = False) -> torch.Tensor:
    """Hillis-Steele solve of v[L] = b[L] + c[L] * v[L-1] over circular
    lanes (reverse: v[L] = b[L] + c[L] * v[L+1]), in the same association
    order as the kernels, each product and sum flushed to zero below
    F32_MIN_NORMAL.  Correct iff the caller zeroed c at the scan's cut
    lane (the band's first row forward / last row backward)."""
    W = b.shape[-1]
    t = -1 if reverse else 1
    d = 1
    while d < W:
        b = ftz(b + ftz(c * circ_roll(b, t * d)))
        c = ftz(c * circ_roll(c, t * d))
        d *= 2
    return b


#: Slope clamp of guided_band_offsets (rows of band advance per column).
MAX_BAND_ADVANCE = 7


def guided_band_offsets(alpha_vals: torch.Tensor,
                        alpha_offsets: torch.Tensor,
                        read_len: torch.Tensor, tpl_len: torch.Tensor,
                        width: int, n_cols: int | None = None,
                        smooth: int = 8) -> torch.Tensor:
    """(R, n_cols) band offsets re-centered on the alignment path of a
    prior alpha fill: per-column band argmax rows, boxcar-smoothed, made
    monotone, slope-clamped to MAX_BAND_ADVANCE and pinned to the corners
    (the JAX package's stand-in for the reference's guide-matrix
    rebanding, SimpleRecursor.cpp:642-757)."""
    R, ncA, _ = alpha_vals.shape
    n_cols = ncA if n_cols is None else n_cols
    W = width
    S = MAX_BAND_ADVANCE
    dev = alpha_vals.device
    I = read_len.to(torch.int32)[:, None]
    J = tpl_len.to(torch.int32)[:, None]
    j = torch.arange(ncA, dtype=torch.float32, device=dev)[None, :]

    lane = torch.argmax(alpha_vals, dim=-1).to(torch.int32)
    q = alpha_offsets % W
    c = (alpha_offsets - q + lane + torch.where(lane < q, W, 0)).float()
    If = I.float()
    c = torch.where(j <= J.float(), c, If)
    c = torch.minimum(c, If)
    if smooth:
        k = smooth
        cp = torch.cat([c[:, :1].expand(R, k), c, c[:, -1:].expand(R, k)],
                       dim=1)
        cs = torch.cumsum(cp, dim=1)
        lo = torch.cat([torch.zeros(R, 1, device=dev), cs[:, :-2 * k - 1]],
                       dim=1)
        c = (cs[:, 2 * k:] - lo) / (2 * k + 1)
    c = torch.cummax(c, dim=1).values
    o = torch.cummin(c - S * j, dim=1).values + S * j
    o = torch.minimum(o, 1.0 + S * torch.clamp(j - 1.0, min=0.0))
    off = torch.floor(o).to(torch.int32) - W // 2
    off = torch.minimum(torch.clamp(off, min=0),
                        torch.clamp(I + 1 - W, min=0))
    off = torch.cummax(off, dim=1).values
    if n_cols > ncA:
        off = torch.cat([off, off[:, -1:].expand(R, n_cols - ncA)], dim=1)
    return off[:, :n_cols].contiguous()
