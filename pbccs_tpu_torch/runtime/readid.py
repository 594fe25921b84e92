"""Subread identity: movie name + hole number + optional query interval.

Parity: ReadId (reference include/pacbio/ccs/ReadId.h:52-77,
src/ReadId.cpp): formats as `movie/zmw` or `movie/zmw/qstart_qend` and
parses the same forms back.

Copy of pbccs_tpu.runtime.readid."""

from __future__ import annotations

import dataclasses

from pbccs_tpu_torch.utils.intervals import Interval


@dataclasses.dataclass(frozen=True)
class ReadId:
    movie_name: str
    hole_number: int
    zmw_interval: Interval | None = None

    def __str__(self) -> str:
        if self.zmw_interval is None:
            return f"{self.movie_name}/{self.hole_number}"
        return (f"{self.movie_name}/{self.hole_number}/"
                f"{self.zmw_interval.left}_{self.zmw_interval.right}")

    @classmethod
    def parse(cls, text: str) -> "ReadId":
        parts = text.split("/")
        if len(parts) < 2:
            raise ValueError(f"not a read id: {text!r}")
        movie, hole = parts[0], int(parts[1])
        if len(parts) >= 3 and "_" in parts[2]:
            b, e = parts[2].split("_", 1)
            return cls(movie, hole, Interval(int(b), int(e)))
        return cls(movie, hole)
