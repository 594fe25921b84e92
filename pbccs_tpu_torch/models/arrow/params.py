"""Arrow model parameters: SNR-conditioned dinucleotide transition model.

Port of pbccs_tpu.models.arrow.params.  The Arrow pair-HMM conditions its
per-template-position transition probabilities {Match, Branch, Stick,
Dark(=deletion)} on the dinucleotide context (current base, next base)
and the per-channel SNR of the ZMW: eight contexts (homopolymer AA/CC/GG/
TT, generic NA/NC/NG/NT), each a trained 3x4 coefficient matrix mapping
[1, snr, snr^2, snr^3] of the next base's channel through a
softmax-with-reference (reference ConsensusCore Arrow
ContextParameterProvider.cpp:23-113).

Host tables are float64 numpy; device tracks are float32 torch tensors
with leading batch axes."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from pbccs_tpu_torch.runtime import tuning as _tuning

# Base encoding used framework-wide: A=0 C=1 G=2 T=3, padding/invalid = 4.
BASE_A, BASE_C, BASE_G, BASE_T, BASE_PAD = 0, 1, 2, 3, 4
N_BASES = 4
BASES = "ACGT"

_BASE_LUT = np.full(256, BASE_PAD, dtype=np.int8)
for _i, _b in enumerate(BASES):
    _BASE_LUT[ord(_b)] = _i
    _BASE_LUT[ord(_b.lower())] = _i


def encode_bases(seq: str) -> np.ndarray:
    """ASCII sequence -> int8 codes (A=0 C=1 G=2 T=3, other=4)."""
    return _BASE_LUT[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


_BASE_CHARS = np.frombuffer(BASES.encode("ascii"), dtype=np.uint8)


def decode_bases(codes: np.ndarray) -> str:
    """int8 codes -> ASCII sequence. Pad codes (>=4) are dropped."""
    codes = np.asarray(codes)
    if codes.size == 0:  # [] reads as float64
        return ""
    valid = codes[(codes >= 0) & (codes < N_BASES)]
    return _BASE_CHARS[valid].tobytes().decode("ascii")


_COMPLEMENT = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of an int8 base vector (pads map to pad)."""
    return _COMPLEMENT[np.asarray(codes)[::-1]]


def revcomp_padded(tpl: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Reverse complement of the first `length` entries of padded
    templates: tpl (..., Jmax) int, length (...) int.  The tail stays
    padding (code 4)."""
    Jmax = tpl.shape[-1]
    ar = torch.arange(Jmax, device=tpl.device)
    idx = length[..., None].long() - 1 - ar
    src = torch.gather(tpl.long(), -1, idx.clamp(0, Jmax - 1))
    comp = torch.as_tensor(_COMPLEMENT, device=tpl.device).long()[src]
    return torch.where(idx >= 0, comp, 4).to(tpl.dtype)


# Transition-probability channel order used framework-wide.
TRANS_MATCH, TRANS_BRANCH, TRANS_STICK, TRANS_DARK = 0, 1, 2, 3

# Trained SNR-polynomial coefficients.  ctx index = next_base + 4*(cur != next)
# i.e. 0..3 = AA,CC,GG,TT ; 4..7 = NA,NC,NG,NT.   Per context: rows are the
# softmax numerators [Dark, Match, Stick] (Branch is the softmax reference),
# columns are [1, snr, snr^2, snr^3] of the next base's channel SNR.
# Values: reference ContextParameterProvider.cpp:23-66 (trained model data).
CONTEXT_COEFF = np.array(
    [
        [  # AA
            [3.76122480667588, -0.536010820176981, 0.0275375059387171, -0.000470200724345621],
            [3.57517725358548, -0.0257545295375707, -0.000163673803286944, 5.3256984681724e-06],
            [0.858421613302247, -0.0276654216841666, -8.85549766507732e-05, -4.85355908595337e-05],
        ],
        [  # CC
            [5.66725538674764, -1.10462196933913, 0.0879811093908922, -0.00259393800835979],
            [4.11682756767018, -0.124758322644639, 0.00659795177909886, -0.000361914629195461],
            [3.17103818507405, -0.729020290806687, 0.0749784690396837, -0.00262779517495421],
        ],
        [  # GG
            [3.81920778703052, -0.540309003502589, 0.0389569264893982, -0.000901245733796236],
            [3.31322216145728, 0.123514009118836, -0.00807401406655071, 0.000230843924466035],
            [2.06006877520527, -0.451486652688621, 0.0375212898173045, -0.000937676250926241],
        ],
        [  # TT
            [5.39308368236762, -1.32931568057267, 0.107844580241936, -0.00316462903462847],
            [4.21031404956015, -0.347546363361823, 0.0293839179303896, -0.000893802212450644],
            [2.33143889851302, -0.586068444099136, 0.040044954697795, -0.000957298861394191],
        ],
        [  # NA
            [2.35936060895653, -0.463630601682986, 0.0179206897766131, -0.000230839937063052],
            [3.22847830625841, -0.0886820214931539, 0.00555981712798726, -0.000137686231186054],
            [-0.101031042923432, -0.0138783767832632, -0.00153408019582419, 7.66780338484727e-06],
        ],
        [  # NC
            [5.956054206161, -1.71886470811695, 0.153315470604752, -0.00474488595513198],
            [3.89418464416296, -0.174182841558867, 0.0171719290275442, -0.000653629721359769],
            [2.40532887070852, -0.652606650098156, 0.0688783864119339, -0.00246479494650594],
        ],
        [  # NG
            [3.53508304630569, -0.788027301381263, 0.0469367803413207, -0.00106221924705805],
            [2.85440184222226, 0.166346531056167, -0.0166161828155307, 0.000439492705370092],
            [0.238188180807376, 0.0589443522886522, -0.0123401045958974, 0.000336854126836293],
        ],
        [  # NT
            [5.36199280681367, -1.46099908985536, 0.126755291030074, -0.0039102734460725],
            [3.41597143103046, -0.066984162951578, 0.0138944877787003, -0.000558939998921912],
            [1.37371376794871, -0.246963827944892, 0.0209674231346363, -0.000684856715039738],
        ],
    ],
    dtype=np.float64,
)

# Hard-coded trained miscall probability (reference Arrow/ArrowConfig.hpp:52).
MISMATCH_PROBABILITY = 0.00505052456472967


@dataclasses.dataclass(frozen=True)
class ModelParams:
    """Scalar emission parameters of the Arrow HMM
    (reference Arrow/ArrowConfig.hpp:85-113)."""

    pr_miscall: float = MISMATCH_PROBABILITY

    @property
    def pr_not_miscall(self) -> float:
        return 1.0 - self.pr_miscall

    @property
    def pr_third_of_miscall(self) -> float:
        return self.pr_miscall / 3.0


@dataclasses.dataclass(frozen=True)
class BandingOptions:
    """Banded-DP budget: a static band of `band_width` rows per column
    (None = the per-length-bucket schedule, effective_band_width);
    `score_diff` (nats) is kept for the reference's band-adequacy
    semantics (reference Consensus.h:438)."""

    score_diff: float = 12.5
    #: None = the per-length-bucket schedule (effective_band_width); an
    #: explicit width always wins (the 2x mating retry relies on this).
    band_width: int | None = None


def effective_band_width(banding: BandingOptions, jmax: int) -> int:
    """The band width of a bucket, by pbccs_tpu's ladder: an explicit
    band_width (the pipeline's 2x mating retry escalates through it),
    then PBCCS_BAND_W, then an applied `ccs tune` profile's band_w
    (runtime/tuning.py), then the per-length-bucket schedule: W=64 at
    buckets of <= 576 columns, 96 above."""
    if banding.band_width is not None:
        return banding.band_width
    env = os.environ.get("PBCCS_BAND_W")
    if env:
        return int(env)
    tuned = _tuning.knob_int("band_w")
    if tuned is not None:
        return tuned
    return 64 if jmax <= 576 else 96


@dataclasses.dataclass(frozen=True)
class ArrowConfig:
    """Parity: reference Arrow/ArrowConfig.hpp:112-129."""

    model: ModelParams = dataclasses.field(default_factory=ModelParams)
    banding: BandingOptions = dataclasses.field(default_factory=BandingOptions)
    fast_score_threshold: float = -12.5
    add_threshold: float = float("nan")


def snr_to_transition_table(snr, dtype=torch.float32,
                            device=None) -> torch.Tensor:
    """Per-ZMW (8, 4) table of transition probabilities from channel SNRs,
    evaluated in float32 on `device` (the JAX package's jnp form).

    Returns table[ctx, {match, branch, stick, dark}], natural scale
    (ContextParameterProvider::GetTransitionParameters)."""
    snr = torch.as_tensor(snr, dtype=torch.float32, device=device)
    coeff = torch.as_tensor(CONTEXT_COEFF, dtype=torch.float32,
                            device=snr.device)
    chan_snr = snr.repeat(2)
    powers = chan_snr[:, None] ** torch.arange(4, dtype=torch.float32,
                                               device=snr.device)
    xb = torch.exp(torch.einsum("crp,cp->cr", coeff, powers))
    denom = 1.0 + xb.sum(-1)
    return torch.stack([xb[:, 1] / denom, 1.0 / denom, xb[:, 2] / denom,
                        xb[:, 0] / denom], dim=-1).to(dtype)


def snr_to_transition_table_host(snr: np.ndarray,
                                 coeff: np.ndarray = CONTEXT_COEFF
                                 ) -> np.ndarray:
    """Float64 host evaluation of snr_to_transition_table.  The reference
    evaluates the SNR polynomial + softmax in double, and the f32 form is
    sensitive to op order, so the batch polisher feeds this table (cast
    to float32) to the device.  `coeff`: the (8, 3, 4) coefficients
    (convert.ArrowParams passes carried-over ones)."""
    snr = np.asarray(snr, np.float64)
    chan_snr = np.tile(snr, 2)  # (8,)
    powers = chan_snr[:, None] ** np.arange(4)  # (8, 4)
    xb = np.exp(np.einsum("crp,cp->cr", coeff, powers))  # Dark,Match,Stick
    denom = 1.0 + xb.sum(axis=-1)
    return np.stack(
        [xb[:, 1] / denom, 1.0 / denom, xb[:, 2] / denom, xb[:, 0] / denom],
        axis=-1,
    )


def context_index(cur_base: torch.Tensor, next_base: torch.Tensor
                  ) -> torch.Tensor:
    """Dinucleotide context id: next_base + 4 * (cur != next)."""
    return next_base + 4 * (cur_base != next_base).to(next_base.dtype)


def transition_lookup(cur_base: torch.Tensor, next_base: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """(..., 4) transition rows for dinucleotide contexts.

    `table` is (8, 4) or batched (B, 8, 4) with the bases' leading axis B;
    a plain gather (the TPU's one-hot matmul picks the same values)."""
    idx = context_index(cur_base.long(), next_base.long()).clamp(0, 7)
    table = table.float()
    if table.dim() == 2:
        return table[idx]
    B = table.shape[0]
    flat = idx.reshape(B, -1)
    rows = torch.gather(table, 1, flat[..., None].expand(-1, -1, 4))
    return rows.reshape(idx.shape + (4,))


def template_transition_params(tpl: torch.Tensor, trans_table: torch.Tensor,
                               length: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Per-position transition tracks for templates.

    tpl: (..., L) base codes (possibly padded); trans_table: (8, 4) or
    batched (B, 8, 4) matching tpl's leading axis; length: (...) actual
    lengths when padded.  Returns (..., L, 4); position i conditions on
    (tpl[i], tpl[i+1]); positions >= length-1 are zero (the reference's
    sentinel, TemplateParameterPair.cpp:56-58)."""
    L = tpl.shape[-1]
    nxt = torch.roll(tpl, -1, dims=-1)
    params = transition_lookup(tpl, nxt, trans_table)
    last = (L - 1) if length is None else (length.long()[..., None] - 1)
    pos = torch.arange(L, device=tpl.device)
    valid = pos < last
    return torch.where(valid[..., None], params, 0.0)
