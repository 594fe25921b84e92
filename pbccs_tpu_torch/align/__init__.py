"""Host alignment helpers: numpy copies of pbccs_tpu.align (the draft
stage's seeds and chaining, and the exact pairwise aligners).

Parity targets: reference ConsensusCore/include/ConsensusCore/Align/
{AlignConfig,PairwiseAlignment,AffineAlignment,LinearAlignment}.hpp.
"""

from pbccs_tpu_torch.align.pairwise import (
    GLOBAL,
    LOCAL,
    SEMIGLOBAL,
    AlignConfig,
    AlignParams,
    PairwiseAlignment,
    align,
    target_to_query_positions,
)
from pbccs_tpu_torch.align.affine import (
    AffineAlignmentParams,
    align_affine,
    align_affine_iupac,
)
from pbccs_tpu_torch.align.linear import align_linear

__all__ = [
    "GLOBAL", "SEMIGLOBAL", "LOCAL",
    "AlignParams", "AlignConfig", "PairwiseAlignment",
    "align", "target_to_query_positions",
    "AffineAlignmentParams", "align_affine", "align_affine_iupac",
    "align_linear",
]
