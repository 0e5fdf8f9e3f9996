"""Capacity ladder — port of ``spark_rapids_tpu/compile/ladder.py``.

Batches live at fixed capacities: the smallest rung of a geometric
ladder at or above the row count. The port keeps the reference's
default ladder (powers of two from 128) so every capacity, and every
size derived from one (the dense join's ``4 x capacity`` table), is the
same in both packages. Fixed capacities are also what later lets a stage
be captured in a CUDA graph.
"""

from __future__ import annotations

import dataclasses

#: Capacity granularity (the reference's TPU lane width; kept so
#: capacities agree across the two packages).
LANE = 128


def _align_up(n: int, step: int = LANE) -> int:
    return -(-int(n) // step) * step


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """Immutable ladder policy; ``bucket`` is the hot call."""

    min_capacity: int = LANE
    growth: float = 2.0

    def __post_init__(self):
        if self.growth < 1.125:
            raise ValueError(f"ladder growth {self.growth} must be >= 1.125")
        if self.min_capacity < 1:
            raise ValueError("min_capacity must be positive")

    @property
    def base(self) -> int:
        return _align_up(max(self.min_capacity, LANE))

    def bucket(self, n: int, min_capacity: int = LANE) -> int:
        """Smallest rung >= n (and >= max(min_capacity, ladder base))."""
        n = max(int(n), 1)
        cap = max(self.base, _align_up(max(int(min_capacity), 1)))
        while cap < n:
            cap = max(_align_up(cap * self.growth), cap + LANE)
        return cap


DEFAULT_LADDER = BucketLadder()


def bucket_capacity(n: int, min_capacity: int = LANE) -> int:
    """Round ``n`` up onto the default ladder."""
    return DEFAULT_LADDER.bucket(n, min_capacity)


#: Byte counts (a string payload, a char-matrix width) climb the same
#: rungs as rows, floor 128, so a 2-byte string still gets ``W = 128``.
bucket_byte_capacity = bucket_capacity
