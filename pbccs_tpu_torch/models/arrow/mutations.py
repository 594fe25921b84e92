"""The slot-grid tables and QV constants of the mutation algebra.

Port of the pieces of pbccs_tpu.models.arrow.mutations that the
device-resident refinement loop uses: the per-position slot order
(subs A/C/G/T, ins A/C/G/T, del -- the host enumeration order
UniqueSingleBaseMutationEnumerator produces, reference
MutationEnumerator.cpp:111-147) and the QV saturation constant."""

from __future__ import annotations

import numpy as np

SUBSTITUTION, INSERTION, DELETION = 0, 1, 2

_SLOT_BASES = np.array([0, 1, 2, 3, 0, 1, 2, 3, -1], np.int32)
_SLOT_TYPES = np.array([SUBSTITUTION] * 4 + [INSERTION] * 4 + [DELETION],
                       np.int32)
_SLOT_ENDOFF = np.array([1, 1, 1, 1, 0, 0, 0, 0, 1], np.int32)

_LN10 = float(np.log(10.0))
# Value the direct f64 aggregation yields when no negative-scoring mutation
# exists at a position (prob clamps to float64 tiny):
# round(-10*log10(2.225e-308)) == 3077.
QV_SATURATED = int(np.round(-10.0 * np.log10(np.finfo(np.float64).tiny)))
