"""Query deadlines — port of ``spark_rapids_tpu/utils/deadline.py``
(``QueryDeadlineExceeded``, ``Deadline`` with ``check``, ``bound``,
``cancel`` and ``site_times``).

``spark.rapids.tpu.query.deadlineSecs`` bounds one query's wall time: the
session makes one :class:`Deadline` per query (its escalation re-runs
included), it rides the ``ExecContext``, and every cooperative site —
the retry ladder's attempts and backoff sleeps (:mod:`..memory.retry`),
the pipeline's waits (:mod:`..exec.pipeline`, :mod:`.prefetch`) and the
session's dispatch — calls :meth:`Deadline.check`. An expired deadline
raises :class:`QueryDeadlineExceeded` naming the site that took the most
wall time; the retry taxonomy never retries it. Cancellation is
cooperative: work already launched on the card runs to its end, but no
new attempt, sleep or wait starts, and sleeps are bounded by the time
left.
"""

from __future__ import annotations

import time
from typing import Optional

from . import lockdep


class QueryDeadlineExceeded(RuntimeError):
    """The query ran past ``spark.rapids.tpu.query.deadlineSecs``; names
    where it was observed (``site``) and the site that took the most
    wall time (``slowest_site``)."""

    def __init__(self, limit_s: float, site: str,
                 slowest_site: Optional[str] = None,
                 slowest_s: float = 0.0, elapsed_s: float = 0.0):
        msg = (f"query exceeded its {limit_s:.3g}s deadline "
               f"(spark.rapids.tpu.query.deadlineSecs) after "
               f"{elapsed_s:.3g}s, observed at '{site}'")
        if slowest_site and slowest_site != site:
            msg += (f"; slowest site: '{slowest_site}' "
                    f"({slowest_s:.3g}s attributed)")
        elif slowest_site:
            msg += f" ({slowest_s:.3g}s attributed there)"
        super().__init__(msg)
        self.limit_s = limit_s
        self.site = site
        self.slowest_site = slowest_site
        self.slowest_s = slowest_s


class Deadline:
    """One query's wall-clock budget with per-site time attribution: the
    interval since the previous check anywhere in the query goes to the
    checking site (the work it just finished). Thread-safe."""

    def __init__(self, seconds: float):
        self.limit_s = float(seconds)
        self._t0 = time.monotonic()
        self._deadline = self._t0 + self.limit_s
        self._last = self._t0
        self._elapsed: dict = {}
        self._lock = lockdep.lock("Deadline._lock")
        self._cancelled = False

    @classmethod
    def maybe(cls, conf) -> Optional["Deadline"]:
        """A Deadline when the conf sets a positive deadlineSecs, else
        None (the default: the healthy path pays one None check)."""
        from ..config import QUERY_DEADLINE_SECS
        if conf is None:
            return None
        secs = float(conf.get(QUERY_DEADLINE_SECS))
        return cls(secs) if secs > 0 else None

    def remaining(self) -> float:
        """Seconds left (negative once expired)."""
        return self._deadline - time.monotonic()

    def bound(self, seconds: float) -> float:
        """Clamp a sleep or timeout to the remaining budget (>= 0)."""
        return max(0.0, min(float(seconds), self.remaining()))

    def cancel(self) -> None:
        """Expire now: every site's next :meth:`check` raises."""
        with self._lock:
            self._deadline = min(self._deadline, time.monotonic() - 1e-9)

    def check(self, site: str, ctx=None, node: Optional[str] = None) -> None:
        """Attribute the elapsed time to ``site``; raise
        :class:`QueryDeadlineExceeded` once expired (``ctx``/``node``
        record ``deadlineCancels`` on the first raise)."""
        now = time.monotonic()
        with self._lock:
            self._elapsed[site] = self._elapsed.get(site, 0.0) \
                + (now - self._last)
            self._last = now
            if now <= self._deadline:
                return
            first = not self._cancelled
            self._cancelled = True
            slowest = max(self._elapsed, key=self._elapsed.get)
            slowest_s = self._elapsed[slowest]
        if first and ctx is not None:
            ctx.metric(node or site.split(".", 1)[0], "deadlineCancels", 1)
        if first:
            # the flight recorder's snapshot of what the engine was doing
            # (a no-op with tracing off)
            from ..metrics import trace as TR
            TR.flight_dump("deadline_exceeded", site=site,
                           slowest_site=slowest, limit_s=self.limit_s)
        raise QueryDeadlineExceeded(self.limit_s, site, slowest, slowest_s,
                                    now - self._t0)

    def site_times(self) -> dict:
        """Per-site attributed seconds so far."""
        with self._lock:
            return dict(self._elapsed)
