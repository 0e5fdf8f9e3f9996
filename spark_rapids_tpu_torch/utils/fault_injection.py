"""Deterministic fault injection — port of
``spark_rapids_tpu/utils/fault_injection.py`` (``FaultInjector``,
``maybe_inject``, ``register_site``, ``known_sites``): the
``RmmSpark.forceRetryOOM`` analog.

Every :func:`~..memory.retry.with_retry` boundary and the session's
dispatch call the injector, which raises synthetic faults there on a
schedule read from the conf (``spark.rapids.tpu.test.faultInjection.``):

* ``sites`` — comma-separated site names or prefixes (``*`` = every
  site); empty turns injection off (the default: one ``None`` check);
* ``oomEveryN`` — every Nth visit of a matched site raises
  :class:`InjectedOutOfMemory`, an instance of ``torch.OutOfMemoryError``,
  so an injected fault takes the same classification as the allocator's
  own (:func:`..memory.retry.classify`); negative N faults the FIRST |N|
  visits, then the site heals (the schedule that drives a site through
  its retries into a split and still lets the query finish);
* ``transientEveryN`` — every Nth visit raises a transient fault, a
  helper race or a spill-disk ``OSError`` chosen from the seed and visit;
* ``seed`` — shifts which visit faults first and the transient flavor.

Same conf, same schedule: the counters are per injector, and the session
makes one injector a session. Site names are ``<node>.<boundary>``
(``ShuffledHashJoinExec.probe``, ``session.dispatch``, ...), and the
scans' units (:data:`IO_SITES`: a parquet row group, an ORC stripe, a
CSV file), where a fault makes that unit decode on the host;
:func:`known_sites` lists those visited so far in the process, and the
scans' from import on. The
reference's network, serving and mesh fault classes wait for the port's
net plane, serving layer and mesh failover.
"""

from __future__ import annotations

import zlib
from typing import Dict, Optional

import torch

from . import lockdep

_SITES_LOCK = lockdep.lock("fault_injection._SITES_LOCK")
_KNOWN_SITES: set = set()


def register_site(site: str) -> None:
    """Record a retry/injection site name (lock-free after the first
    visit of a site)."""
    if site in _KNOWN_SITES:
        return
    with _SITES_LOCK:
        _KNOWN_SITES.add(site)


#: The device scans' per-unit sites: a fault there decodes the unit on
#: the host (io/parquet_device.py, io/orc_device.py, io/csv_device.py).
IO_SITES = ("io.parquet.rowGroup", "io.orc.stripe", "io.csv.file")


def known_sites() -> list:
    """Every site name registered so far in this process, sorted."""
    with _SITES_LOCK:
        return sorted(_KNOWN_SITES)


for _site in IO_SITES:
    register_site(_site)


class InjectedFault(Exception):
    """Base of every synthetic fault (never raised by production code)."""


class InjectedOutOfMemory(InjectedFault, torch.OutOfMemoryError):
    """Synthetic device memory exhaustion: a ``torch.OutOfMemoryError``,
    classified OOM as the allocator's own failure is."""


class InjectedTransient(InjectedFault):
    """Synthetic helper race (classified transient by its message)."""


class InjectedDiskFault(InjectedFault, OSError):
    """Synthetic spill-disk I/O failure (an OSError: transient)."""


class FaultInjector:
    """Deterministic per-site fault schedule (see the module doc)."""

    def __init__(self, seed: int, sites: str, oom_every_n: int,
                 transient_every_n: int):
        self.seed = int(seed)
        self.patterns = [s.strip() for s in sites.split(",") if s.strip()]
        self.oom_every_n = int(oom_every_n)
        self.transient_every_n = int(transient_every_n)
        self._counters: Dict[str, int] = {}
        self._lock = lockdep.lock("FaultInjector._lock")
        #: injected faults by flavor
        self.injected = {"oom": 0, "transient": 0, "disk": 0}

    @classmethod
    def maybe(cls, conf) -> Optional["FaultInjector"]:
        """The conf's injector, or None when injection is off."""
        from ..config import (FAULT_INJECTION_OOM_EVERY_N,
                              FAULT_INJECTION_SEED, FAULT_INJECTION_SITES,
                              FAULT_INJECTION_TRANSIENT_EVERY_N)
        if conf is None:
            return None
        sites = conf.get(FAULT_INJECTION_SITES) or ""
        oom_n = int(conf.get(FAULT_INJECTION_OOM_EVERY_N))
        transient_n = int(conf.get(FAULT_INJECTION_TRANSIENT_EVERY_N))
        if not sites.strip() or (oom_n == 0 and transient_n == 0):
            return None
        return cls(int(conf.get(FAULT_INJECTION_SEED)), sites, oom_n,
                   transient_n)

    def matches(self, site: str) -> bool:
        return any(p in ("*", "all") or site == p or site.startswith(p)
                   for p in self.patterns)

    def visits(self) -> Dict[str, int]:
        """``{site: visits}`` of the matched sites so far."""
        with self._lock:
            return dict(self._counters)

    def _scheduled(self, n: int, every_n: int) -> bool:
        """Positive N: every Nth visit faults (phase shifted by the seed).
        Negative N: the first |N| visits fault, then the site heals."""
        if every_n < 0:
            return n <= -every_n
        return every_n > 0 and (n + self.seed) % every_n == 0

    def check(self, site: str) -> None:
        """Count one visit of ``site``; raise this visit's scheduled fault,
        if any (an OOM schedule wins a tie with a transient one)."""
        if not self.matches(site):
            return
        with self._lock:
            n = self._counters.get(site, 0) + 1
            self._counters[site] = n
            if self._scheduled(n, self.oom_every_n):
                flavor = "oom"
            elif self._scheduled(n, self.transient_every_n):
                flavor = "disk" if zlib.crc32(
                    f"{site}:{n}:{self.seed}".encode()) & 1 else "transient"
            else:
                return
            self.injected[flavor] += 1
        if flavor == "oom":
            raise InjectedOutOfMemory(
                f"CUDA out of memory: injected device memory exhaustion at "
                f"{site} (visit {n})")
        if flavor == "disk":
            raise InjectedDiskFault(
                f"injected spill-disk I/O failure at {site} (visit {n})")
        raise InjectedTransient(
            f"injected remote_compile helper race at {site} (visit {n})")


def maybe_inject(ctx, site: str) -> None:
    """Register ``site`` and raise its scheduled fault when the context
    carries an injector (the session's dispatch calls this)."""
    register_site(site)
    injector = getattr(ctx, "fault_injector", None)
    if injector is not None:
        injector.check(site)
