"""Task admission semaphore — port of ``spark_rapids_tpu/memory/
semaphore.py`` (``TpuSemaphore``, ``released``, ``SemaphoreTimeoutError``):
the ``GpuSemaphore`` analog.

``spark.rapids.sql.concurrentTpuTasks`` bounds the queries that hold the
card at once; the session acquires around each dispatch, reentrantly per
thread. ``spark.rapids.tpu.concurrentTpuTasks.acquireTimeout`` turns a
stuck or leaked holder into a :class:`SemaphoreTimeoutError` naming the
holding threads and their counts instead of a silent hang. The
serving layer's ``FairShareGate`` is not ported.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

from ..utils import lockdep


class SemaphoreTimeoutError(RuntimeError):
    """The admission acquire timed out: almost always a stuck or leaked
    holder. Fatal to the retry taxonomy."""


class TpuSemaphore:
    """Reentrant per-thread admission with a bounded wait."""

    def __init__(self, max_concurrent: int, acquire_timeout_s: float = 0.0):
        self.max_concurrent = int(max_concurrent)
        #: seconds to block in acquire before raising; 0 = forever
        self.acquire_timeout_s = float(acquire_timeout_s)
        self._sem = threading.Semaphore(self.max_concurrent)
        self._held: Dict[int, int] = {}
        self._names: Dict[int, str] = {}
        self._lock = lockdep.lock("TpuSemaphore._lock")
        #: lifetime nanoseconds threads spent blocked on acquire (the
        #: ``semaphoreWaitNs`` source; the profile takes deltas)
        self.wait_ns = 0

    def holders(self) -> Dict[int, int]:
        """``{thread ident: held count}``."""
        with self._lock:
            return dict(self._held)

    def _describe_holders(self) -> str:
        with self._lock:
            held = {t: (c, self._names.get(t, "?"))
                    for t, c in self._held.items()}
        return ", ".join(f"thread {t} ({name}) holds {c}"
                         for t, (c, name) in sorted(held.items())) \
            or "no recorded holders (a leak outside acquire_if_necessary?)"

    def _acquire_slot(self) -> bool:
        if self.acquire_timeout_s > 0:
            with lockdep.blocking("semaphore.acquire"):
                return self._sem.acquire(timeout=self.acquire_timeout_s)
        with lockdep.blocking("semaphore.acquire"):
            return self._sem.acquire()

    def acquire_if_necessary(self) -> None:
        """Reentrant acquire; raises :class:`SemaphoreTimeoutError` when
        ``acquire_timeout_s`` passes without a slot."""
        tid = threading.get_ident()
        with self._lock:
            if self._held.get(tid, 0) > 0:
                self._held[tid] += 1
                return
        t0 = time.perf_counter_ns()
        acquired = self._acquire_slot()
        with self._lock:
            self.wait_ns += time.perf_counter_ns() - t0
            if acquired:
                self._held[tid] = self._held.get(tid, 0) + 1
                self._names[tid] = threading.current_thread().name
                return
        raise SemaphoreTimeoutError(
            f"thread {tid} ({threading.current_thread().name}) could not "
            f"acquire the task semaphore within {self.acquire_timeout_s:g}s "
            f"(spark.rapids.tpu.concurrentTpuTasks.acquireTimeout); "
            f"{self.max_concurrent} slot(s) total, "
            f"{self._describe_holders()}")

    def release_if_necessary(self) -> None:
        tid = threading.get_ident()
        with self._lock:
            count = self._held.get(tid, 0)
            if count == 0:
                return
            if count > 1:
                self._held[tid] = count - 1
                return
            del self._held[tid]
            self._names.pop(tid, None)
        self._sem.release()

    def released(self) -> "_Released":
        """A context manager that gives back every slot this thread holds
        for its scope and takes the same count back on exit (the
        reference's release-while-blocked-on-IO discipline)."""
        return _Released(self)

    def __enter__(self):
        self.acquire_if_necessary()
        return self

    def __exit__(self, *exc):
        self.release_if_necessary()
        return False


class _Released:
    """Release the thread's one permit for a scope, then take it back and
    restore the reentrant count."""

    def __init__(self, sem: TpuSemaphore):
        self._sem = sem
        self._count = 0

    def __enter__(self):
        sem = self._sem
        tid = threading.get_ident()
        with sem._lock:
            self._count = sem._held.pop(tid, 0)
            sem._names.pop(tid, None)
        if self._count:
            sem._sem.release()
        return self

    def __exit__(self, *exc):
        sem = self._sem
        if not self._count:
            return False
        t0 = time.perf_counter_ns()
        acquired = sem._acquire_slot()
        tid = threading.get_ident()
        with sem._lock:
            sem.wait_ns += time.perf_counter_ns() - t0
            if acquired:
                sem._held[tid] = sem._held.get(tid, 0) + self._count
                sem._names[tid] = threading.current_thread().name
                return False
        raise SemaphoreTimeoutError(
            f"thread {tid} could not re-acquire the task semaphore within "
            f"{sem.acquire_timeout_s:g}s; {sem._describe_holders()}")
