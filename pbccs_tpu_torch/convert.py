"""Carry model parameters and DP state from numpy arrays into the port.

Parity tests hand both packages the same inputs as numpy arrays.  These
functions turn the JAX package's parameters and fill / loop state,
fetched with np.asarray, into the port's tensors, so a port function can
be run on exactly the state the JAX package computed.  They accept any
object with the same field names (NamedTuples of arrays); nothing here
imports the JAX package."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbccs_tpu_torch.models.arrow import params
from pbccs_tpu_torch.models.arrow.scorer import FillState
from pbccs_tpu_torch.ops.fwdbwd import BandedMatrix
from pbccs_tpu_torch.parallel.device_refine import RefineLoopState


@dataclasses.dataclass(frozen=True)
class ArrowParams:
    """The Arrow model constants: the (8, 3, 4) float64 SNR-polynomial
    coefficients and the miscall probability."""

    context_coeff: np.ndarray
    mismatch_probability: float

    def transition_table_host(self, snr) -> np.ndarray:
        """(8, 4) float64 transition table of one ZMW's SNRs."""
        return params.snr_to_transition_table_host(snr, self.context_coeff)


def arrow_params_from_numpy(context_coeff, mismatch_probability
                            ) -> ArrowParams:
    """ArrowParams from numpy arrays (e.g. the JAX package's CONTEXT_COEFF
    and MISMATCH_PROBABILITY), checked for shape and kept in float64."""
    coeff = np.array(context_coeff, dtype=np.float64)
    if coeff.shape != params.CONTEXT_COEFF.shape:
        raise ValueError(f"context coefficients have shape {coeff.shape}, "
                         f"expected {params.CONTEXT_COEFF.shape}")
    return ArrowParams(coeff, float(np.asarray(mismatch_probability,
                                               np.float64)))


def _t(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device).to(dtype)


def banded_from_numpy(bm, device="cpu") -> BandedMatrix:
    """A BandedMatrix (vals, offsets, log_scales) of arrays -> the port's
    BandedMatrix tensors (float32 / int32 / float32)."""
    return BandedMatrix(_t(bm.vals, torch.float32, device),
                        _t(bm.offsets, torch.int32, device),
                        _t(bm.log_scales, torch.float32, device))


def fill_from_numpy(fill, device="cpu") -> FillState:
    """A fill 6-tuple (alpha, beta, ll_a, ll_b, apre, bsuf), as
    fill_alpha_beta_batch returns it in either package -> FillState."""
    alpha, beta, ll_a, ll_b, apre, bsuf = fill
    f32 = torch.float32
    return FillState(banded_from_numpy(alpha, device),
                     banded_from_numpy(beta, device),
                     _t(ll_a, f32, device), _t(ll_b, f32, device),
                     _t(apre, f32, device), _t(bsuf, f32, device))


def state_from_numpy(st, device="cpu") -> RefineLoopState:
    """A refinement-loop state with the JAX package's RefineLoopState
    field names -> the port's RefineLoopState.  The template-hash history
    becomes int64 (the port's uint32 carrier); the round counter an int."""
    i32, f32 = torch.int32, torch.float32
    t = lambda name, dtype: _t(getattr(st, name), dtype, device)  # noqa: E731
    return RefineLoopState(
        tpl=t("tpl", torch.int8), tlens=t("tlens", i32),
        tstarts=t("tstarts", i32), tends=t("tends", i32),
        win_tpl=t("win_tpl", torch.int8), win_trans=t("win_trans", f32),
        wlens=t("wlens", i32),
        alpha=banded_from_numpy(st.alpha, device),
        beta=banded_from_numpy(st.beta, device),
        a_prefix=t("a_prefix", f32), b_suffix=t("b_suffix", f32),
        baselines=t("baselines", f32), trans_f=t("trans_f", f32),
        tpl_r=t("tpl_r", torch.int8), trans_r=t("trans_r", f32),
        active=t("active", torch.bool), done=t("done", torch.bool),
        converged=t("converged", torch.bool),
        iterations=t("iterations", i32), n_tested=t("n_tested", i32),
        n_applied=t("n_applied", i32), allowed=t("allowed", torch.bool),
        history=_t(np.asarray(st.history).astype(np.int64), torch.int64,
                   device),
        hist_n=t("hist_n", i32), it=int(np.asarray(st.it)))
