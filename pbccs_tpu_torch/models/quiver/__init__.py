"""Quiver model family of the port: the QV-feature consensus model, its
banded fills on the K2 kernel, and the per-ZMW multi-read scorer.

Re-exports pbccs_tpu.models.quiver's names but its four per-read
recursors (quiver_forward, quiver_backward, quiver_loglik,
quiver_loglik_backward): the port fills reads in batches, through
fill.forward_batch / backward_batch and their log-likelihoods
fill.quiver_loglik_batch / quiver_loglik_backward_batch."""

from pbccs_tpu_torch.models.quiver.params import (  # noqa: F401
    ALL_MOVES,
    BASIC_MOVES,
    BandingOptions,
    QuiverConfig,
    QuiverConfigTable,
    QvModelParams,
)
from pbccs_tpu_torch.models.quiver.features import (  # noqa: F401
    QvSequenceFeatures,
)
from pbccs_tpu_torch.models.quiver.scorer import (  # noqa: F401
    QuiverMultiReadScorer,
)
