"""One-shot read-vs-template scoring convenience.

Port of pbccs_tpu.models.readscorer.  Parity: Arrow/Quiver ReadScorer
(reference ConsensusCore/include/ConsensusCore/Arrow/ReadScorer.hpp:
50-74, src/C++/Arrow/ReadScorer.cpp and the Quiver-namespace twin):
build the banded forward matrix of one (read, template) pair and return
the log-likelihood, without standing up a multi-read scorer.

The fills are the port's: `score_read` runs K1 (ops.fwdbwd_cuda
.forward_batch) and `score_read_quiver` K2 (models.quiver.fill
.forward_batch), each on the card unless `device` names another (the
CPU runs their plain versions).  The padding geometry is pbccs_tpu's
(power-of-two read and template axes, the band width of the template
bucket).  The fills are float32; the log-likelihood adds the final
cell's log and the column log-scales in float64, as the reference's
double-precision scaled matrices do (ScaledSparseMatrixD,
ScaledMatrix.hpp:36), so the card and the CPU, whose float32 reductions
add in different orders, return the same value: the kernels' cells and
log-scales are bitwise their plain versions'."""

from __future__ import annotations

import numpy as np
import torch

from pbccs_tpu_torch.device import resolve_device
from pbccs_tpu_torch.models.arrow.params import (
    ArrowConfig,
    effective_band_width,
    encode_bases,
    snr_to_transition_table_host,
    template_transition_params,
)
from pbccs_tpu_torch.ops.fwdbwd_cuda import forward_batch
from pbccs_tpu_torch.utils import next_pow2


def _codes(seq) -> np.ndarray:
    if isinstance(seq, str):
        return encode_bases(seq)
    return np.asarray(seq, np.int8)


def _loglik(final: torch.Tensor, log_scales: torch.Tensor, J: int) -> float:
    """log(final cell) + the log-scales of columns 0..J, in float64."""
    return float(torch.log(final.double().clamp(min=1e-30))
                 + log_scales[: J + 1].double().sum())


def _padded(codes: np.ndarray, n: int, dev) -> torch.Tensor:
    """(1, n) int8 tensor of `codes` padded with 4 (no base)."""
    out = np.full((1, n), 4, np.int8)
    out[0, : len(codes)] = codes
    return torch.as_tensor(out, device=dev)


def score_read(read, template, snr, config: ArrowConfig | None = None,
               device=None) -> float:
    """log P(read | template) under the Arrow pair-HMM
    (ReadScorer::Score, Arrow/ReadScorer.cpp), from one K1 forward
    fill."""
    config = config or ArrowConfig()
    dev = resolve_device(device)
    read_c, tpl_c = _codes(read), _codes(template)
    jmax = next_pow2(len(tpl_c) + 8)
    reads = _padded(read_c, next_pow2(len(read_c) + 8), dev)
    tpls = _padded(tpl_c, jmax, dev)
    rlens = torch.tensor([len(read_c)], dtype=torch.int32, device=dev)
    tlens = torch.tensor([len(tpl_c)], dtype=torch.int32, device=dev)
    table = torch.as_tensor(
        snr_to_transition_table_host(np.asarray(snr, np.float64)),
        dtype=torch.float32, device=dev)
    trans = template_transition_params(tpls, table, tlens)
    alpha = forward_batch(reads, rlens, tpls, trans, tlens,
                          effective_band_width(config.banding, jmax))
    # the final value is column J's band sum (pbccs_tpu's forward_loglik)
    J = len(tpl_c)
    return _loglik(alpha.vals[0, J].double().sum(), alpha.log_scales[0], J)


def score_read_quiver(features, template, config=None,
                      device=None) -> float:
    """log P(read | template) under the Quiver model
    (Quiver/ReadScorer.cpp), from one K2 forward fill."""
    from pbccs_tpu_torch.models.quiver import fill
    from pbccs_tpu_torch.models.quiver.params import QuiverConfig
    from pbccs_tpu_torch.models.quiver.recursor import (feature_arrays,
                                                        stack_features)
    from pbccs_tpu_torch.ops import quiver_fill_cuda as qk

    config = config or QuiverConfig()
    dev = resolve_device(device)
    tpl_c = _codes(template)
    feat = stack_features([feature_arrays(
        features, next_pow2(len(features) + 8), device=dev)])
    tpls = _padded(tpl_c, next_pow2(len(tpl_c) + 8), dev)
    rlens = torch.tensor([len(features)], dtype=torch.int32, device=dev)
    tlens = torch.tensor([len(tpl_c)], dtype=torch.int32, device=dev)
    alpha = fill.forward_batch(feat, rlens, tpls, tlens, config,
                               config.banding.band_width)
    final = qk.final_cell(alpha.vals, alpha.offsets, rlens, tlens, False)
    return _loglik(final[0], alpha.log_scales[0], len(tpl_c))
