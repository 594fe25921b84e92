"""QV feature tracks for the Quiver model.

Port of pbccs_tpu.models.quiver.features (reference
ConsensusCore/include/ConsensusCore/Features.hpp:50-123: QvSequenceFeatures
= sequence + InsQV, SubsQV, DelQV, DelTag, MergeQV)."""

from __future__ import annotations

import dataclasses

import numpy as np

from pbccs_tpu_torch.models.arrow.params import encode_bases


@dataclasses.dataclass
class QvSequenceFeatures:
    """One read's base codes + 5 per-base QV tracks.

    seq: int8 base codes (0..3; 4 = N); qv tracks: float32, one value per
    base.  del_tag is a base *code* track (the likely deleted base before
    each position), compared against template bases by the Delete move."""

    seq: np.ndarray
    ins_qv: np.ndarray
    subs_qv: np.ndarray
    del_qv: np.ndarray
    del_tag: np.ndarray
    merge_qv: np.ndarray

    def __post_init__(self) -> None:
        n = len(self.seq)
        for name in ("ins_qv", "subs_qv", "del_qv", "del_tag", "merge_qv"):
            if len(getattr(self, name)) != n:
                raise ValueError(f"feature track {name} length != sequence length")

    @classmethod
    def from_str(cls, seq: str, ins_qv=None, subs_qv=None, del_qv=None,
                 del_tag=None, merge_qv=None) -> "QvSequenceFeatures":
        codes = encode_bases(seq)
        n = len(codes)

        def track(x, fill):
            return np.asarray(x, np.float32) if x is not None \
                else np.full(n, fill, np.float32)

        return cls(codes, track(ins_qv, 0), track(subs_qv, 0),
                   track(del_qv, 0), track(del_tag, 4), track(merge_qv, 0))

    def __len__(self) -> int:
        return len(self.seq)


def flat_default_features(seq: np.ndarray) -> QvSequenceFeatures:
    """Features for a read WITHOUT QV tracks: zero QVs (param-only move
    scores) and an 'N' del-tag (never matches a template base) -- what
    the Quiver pipeline uses for plain-sequence subreads."""
    codes = np.asarray(seq, np.int8)
    n = len(codes)
    z = np.zeros(n, np.float32)
    return QvSequenceFeatures(codes, z, z, z, np.full(n, 4, np.float32), z)
