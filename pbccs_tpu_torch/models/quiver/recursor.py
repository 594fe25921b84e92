"""Padded feature tensors and move parameters of the Quiver fills.

Port of the parts of pbccs_tpu.models.quiver.recursor that the fills
(models.quiver.fill) need: QuiverFeatureArrays, feature_arrays and
_move_params.  The JAX package's XLA recursor (quiver_forward /
quiver_backward) is its CPU path; the port's CPU path is K2's plain
version (ops.quiver_fill_cuda.quiver_fill_plain), so the recursor itself
is not ported."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pbccs_tpu_torch.models.quiver.params import QvModelParams


class QuiverFeatureArrays(NamedTuple):
    """Padded feature tracks of one read (Imax,) or a batch (R, Imax)."""

    seq: torch.Tensor       # int32 base codes, 4 past the read
    ins_qv: torch.Tensor    # f32
    subs_qv: torch.Tensor
    del_qv: torch.Tensor
    del_tag: torch.Tensor   # f32 base codes, 4 past the read
    merge_qv: torch.Tensor


def feature_arrays(feat, imax: int, device="cpu") -> QuiverFeatureArrays:
    """Pad one read's host features to (imax,) tensors: QVs pad with 0,
    the sequence and the del-tag with 4."""
    n = len(feat.seq)

    def pad(a, fill):
        out = np.full(imax, fill, np.float32)
        out[:min(n, imax)] = np.asarray(a, np.float32)[:imax]
        return torch.as_tensor(out, device=device)

    seq = np.full(imax, 4, np.int32)
    seq[:min(n, imax)] = np.asarray(feat.seq[:imax], np.int32)
    return QuiverFeatureArrays(
        torch.as_tensor(seq, device=device), pad(feat.ins_qv, 0),
        pad(feat.subs_qv, 0), pad(feat.del_qv, 0), pad(feat.del_tag, 4),
        pad(feat.merge_qv, 0))


def stack_features(feats) -> QuiverFeatureArrays:
    """(R, Imax) batch of per-read QuiverFeatureArrays."""
    return QuiverFeatureArrays(*(torch.stack([getattr(f, n) for f in feats])
                                 for n in QuiverFeatureArrays._fields))


def _move_params(params: QvModelParams) -> dict:
    """The move-score parameters as Python floats (scalar terms) and
    (4,) float32 tensors (the per-base Merge scores)."""
    return dict(
        match=params.match, mismatch=params.mismatch,
        mismatch_s=params.mismatch_s, branch=params.branch,
        branch_s=params.branch_s, deletion_n=params.deletion_n,
        deletion_with_tag=params.deletion_with_tag,
        deletion_with_tag_s=params.deletion_with_tag_s,
        nce=params.nce, nce_s=params.nce_s,
        merge=torch.tensor(params.merge, dtype=torch.float32),
        merge_s=torch.tensor(params.merge_s, dtype=torch.float32))
