"""Quiver model parameters and per-chemistry configuration table.

Port of pbccs_tpu.models.quiver.params (reference
ConsensusCore/include/ConsensusCore/Quiver/QuiverConfig.hpp:78-249,
src/C++/Quiver/QuiverConfig.cpp): the move flags, QvModelParams (log-scale
move scores, affine in the QV features), BandingOptions (the static band
width that replaces the reference's adaptive score-diff banding), the
QuiverConfig and the chemistry-name lookup table with alias and
fallback.  The default parameter set is the untrained one of the JAX
package, at the reference's test-fixture scale
(src/Tests/ParameterSettings.cpp:47-63)."""

from __future__ import annotations

import dataclasses
from typing import Iterator

# move flags (reference QuiverConfig.hpp:52-59)
INCORPORATE, EXTRA, DELETE, MERGE = 1, 2, 4, 8
BASIC_MOVES = INCORPORATE | EXTRA | DELETE
ALL_MOVES = BASIC_MOVES | MERGE

FALLBACK = "*"


@dataclasses.dataclass(frozen=True)
class QvModelParams:
    """Trained per-chemistry move-score parameters (log scale); affine in
    the QV features: score = param + param_slope * qv."""

    chemistry: str = "unknown"
    model: str = "default"
    match: float = 0.0
    mismatch: float = -10.0
    mismatch_s: float = -0.1
    branch: float = -5.0
    branch_s: float = -0.1
    deletion_n: float = -6.0
    deletion_with_tag: float = -7.0
    deletion_with_tag_s: float = -0.1
    nce: float = -8.0
    nce_s: float = -0.1
    merge: tuple[float, float, float, float] = (-2.0, -2.0, -2.0, -2.0)
    merge_s: tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class BandingOptions:
    """Static band width (the reference's adaptive ScoreDiff banding,
    QuiverConfig.hpp:60-75, is replaced by a fixed band); score_diff is
    kept for parity checks."""

    band_width: int = 96
    score_diff: float = 12.5


@dataclasses.dataclass(frozen=True)
class QuiverConfig:
    qv_params: QvModelParams = QvModelParams()
    moves_available: int = ALL_MOVES
    banding: BandingOptions = BandingOptions()
    fast_score_threshold: float = -12.5
    add_threshold: float = 1.0


class QuiverConfigTable:
    """Chemistry-name -> QuiverConfig with alias + fallback lookup
    (reference QuiverConfig.hpp:196-249, QuiverConfig.cpp:63-140)."""

    def __init__(self) -> None:
        self._table: list[tuple[str, QuiverConfig]] = []

    def _contains(self, name: str) -> bool:
        return any(k == name for k, _ in self._table)

    def insert_default(self, config: QuiverConfig) -> bool:
        return self.insert_as(FALLBACK, config)

    def insert(self, config: QuiverConfig) -> bool:
        name = config.qv_params.chemistry
        if not name:
            raise ValueError("config chemistry name is empty")
        return self.insert_as(name, config)

    def insert_as(self, name: str, config: QuiverConfig) -> bool:
        if self._contains(name):
            return False
        self._table.append((name, config))
        return True

    def at(self, name: str) -> QuiverConfig:
        for k, c in self._table:
            if k == name:
                return c
        for k, c in self._table:
            if k == FALLBACK:
                return c
        raise KeyError(f"no Quiver config for chemistry {name!r} and no default")

    def keys(self) -> list[str]:
        return [k for k, _ in self._table]

    def __len__(self) -> int:
        return len(self._table)

    def __iter__(self) -> Iterator[tuple[str, QuiverConfig]]:
        return iter(self._table)


def default_quiver_config_table() -> QuiverConfigTable:
    table = QuiverConfigTable()
    table.insert_default(QuiverConfig())
    return table
