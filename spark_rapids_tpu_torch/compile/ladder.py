"""Capacity ladder — port of ``spark_rapids_tpu/compile/ladder.py``.

Batches live at fixed capacities: the smallest rung of a geometric
ladder at or above the row count. The port keeps the reference's
default ladder (powers of two from 128) so every capacity, and every
size derived from one (the dense join's ``4 x capacity`` table), is the
same in both packages. Fixed capacities are also what lets a fused
region be captured as one CUDA graph (:mod:`.executables`): a graph is
keyed by its inputs' shapes.

``tier_growth`` spaces the coarse *tier* ladder (:meth:`BucketLadder.
tier`; 4.0 merges about two power-of-two rungs per tier). Tiers are
always rungs themselves, so ``tier(tier(n)) == tier(n)``. The reference
pads a fused region's inputs onto tiers; the port does not (a graph's
key names the dictionaries and resident tables it reads, so a tier
would share no graph: :mod:`..exec.fusion`), and keeps ``tier``,
``next_up``, ``next_down`` and ``rungs`` for the warm-up that will
capture neighbouring rungs. ``max_capacity`` caps the ladder (an exact
lane-aligned fit above it) and ``enabled=False`` degrades it to bare
lane alignment, as in the reference.

The ladder is process-global (:func:`get_ladder`/:func:`set_ladder`):
capacities key the captured graphs, so two sessions with different
ladders would double the graph population.
"""

from __future__ import annotations

import dataclasses
from typing import List

from ..utils import lockdep

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
    max_capacity: int = 0  # 0 = unbounded ladder
    enabled: bool = True
    tier_growth: float = 4.0

    def __post_init__(self):
        if self.growth < 1.125:
            raise ValueError(f"ladder growth {self.growth} must be >= 1.125")
        if self.tier_growth < 1.125:
            raise ValueError(f"tier growth {self.tier_growth} must be >= "
                             "1.125")
        if self.min_capacity < 1:
            raise ValueError("min_capacity must be positive")

    @property
    def base(self) -> int:
        return _align_up(max(self.min_capacity, LANE))

    def bucket(self, n: int, min_capacity: int = LANE) -> int:
        """Smallest rung >= n (and >= max(min_capacity, ladder base))."""
        n = max(int(n), 1)
        cap = max(self.base, _align_up(max(int(min_capacity), 1)))
        if not self.enabled:
            return max(cap, _align_up(n))
        top = _align_up(self.max_capacity) if self.max_capacity > 0 else 0
        while cap < n:
            if top and cap >= top:
                return _align_up(n)
            cap = self._next(cap)
        return cap

    def bucket_bytes(self, n: int, min_capacity: int = LANE) -> int:
        """The byte-capacity variant: the same climb without the row
        floor and cap (a string payload or a dictionary's bytes)."""
        n = max(int(n), 1)
        cap = max(_align_up(max(int(min_capacity), 1)), LANE)
        if not self.enabled:
            return max(cap, _align_up(n))
        while cap < n:
            cap = self._next(cap)
        return cap

    def _next(self, cap: int) -> int:
        """The rung above ``cap`` (strictly greater, lane aligned)."""
        return max(_align_up(cap * self.growth), cap + LANE)

    def next_up(self, cap: int, steps: int = 1) -> int:
        """``steps`` rungs above the rung containing ``cap``."""
        cap = self.bucket(cap)
        for _ in range(max(steps, 0)):
            cap = self._next(cap)
        return cap

    def next_down(self, cap: int, steps: int = 1) -> int:
        """``steps`` rungs below the rung containing ``cap`` (floored at
        the ladder base)."""
        target = self.bucket(cap)
        for _ in range(max(steps, 0)):
            if target <= self.base:
                return self.base
            target = self._prev(target)
        return target

    def _prev(self, cap: int) -> int:
        lo, step = self.base, self.base
        while (nxt := self._next(step)) < cap:
            lo, step = step, nxt
        return lo if step >= cap else step

    def rungs(self, lo: int, hi: int) -> List[int]:
        """Every rung covering ``[lo, hi]`` (inclusive), ascending."""
        out = [cap := self.bucket(lo)]
        while cap < hi:
            cap = self._next(cap)
            out.append(cap)
        return out

    def tier(self, n: int, min_capacity: int = LANE) -> int:
        """The capacity tier containing ``n``: the smallest rung of the
        tier ladder (``tier_growth`` spacing from the base) at or above
        ``bucket(n)``. Above ``max_capacity`` and with the ladder off,
        the bucket itself."""
        cap = self.bucket(n, min_capacity)
        if not self.enabled:
            return cap
        if self.max_capacity > 0:
            top = self.bucket(self.max_capacity)
            if cap >= top:
                return cap
        t = self.base
        while t < cap:
            # bucket() snaps the geometric tier point onto a rung, which
            # keeps the mapping idempotent for any pair of growths
            t = self.bucket(max(_align_up(t * self.tier_growth), t + LANE))
        if self.max_capacity > 0:
            t = min(t, self.bucket(self.max_capacity))
        return t

    def tiers(self, lo: int, hi: int) -> List[int]:
        """Every tier covering ``[lo, hi]``, ascending (stopping at the
        ladder's top; only the endpoints with the ladder off)."""
        if not self.enabled:
            lo_t, hi_t = self.tier(lo), self.tier(max(hi, lo))
            return [lo_t] if hi_t <= lo_t else [lo_t, hi_t]
        if self.max_capacity > 0:
            hi = min(hi, self.bucket(self.max_capacity))
        out = [cap := self.tier(lo)]
        while cap < hi:
            nxt = self.tier(cap + LANE)
            if nxt <= cap:
                break
            out.append(cap := nxt)
        return out


DEFAULT_LADDER = BucketLadder()

_LOCK = lockdep.lock("ladder._LOCK")
_LADDER = DEFAULT_LADDER


def get_ladder() -> BucketLadder:
    return _LADDER


def set_ladder(ladder: BucketLadder) -> None:
    global _LADDER
    with _LOCK:
        _LADDER = ladder


def bucket_capacity(n: int, min_capacity: int = LANE) -> int:
    """Round ``n`` up onto the process ladder."""
    return _LADDER.bucket(n, min_capacity)


def bucket_byte_capacity(n: int, min_capacity: int = LANE) -> int:
    """Byte counts (a string payload, a char-matrix width) climb the same
    rungs as rows, floor 128, so a 2-byte string still gets ``W = 128``."""
    return _LADDER.bucket_bytes(n, min_capacity)
