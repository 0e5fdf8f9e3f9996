"""Decode-ahead for the scans — port of ``spark_rapids_tpu/exec/pipeline.py``
(``PipelinePool``, ``configure``, ``get_pool``, ``shutdown``, the decode
limiter, ``ordered_map_iter`` and ``unit_partitions``).

* :class:`PipelinePool` — one shared, elastic pool of daemon worker
  threads. ``submit`` hands a task to an idle worker when there is one
  and starts a new (reusable) thread otherwise, so a task never waits
  behind a busy worker; limits live at the call sites (the decode slots,
  the prefetch depth). :func:`shutdown` joins every worker
  (:meth:`..session.TorchSession.close` calls it).
* :func:`ordered_map_iter` / :func:`unit_partitions` — bounded
  decode-ahead: up to ``prefetchDepth`` units (the parquet scan's row
  groups) run on the pool while the consumer works on the current one,
  at most ``decodeThreads`` of them at once across the process, and the
  results come back in input order.

Results are bit for bit the same with the pipeline on or off: the pool
changes when work runs, never what it computes, and the consumer takes
the units in order. The context's host timers ``<node>.stall`` (the
time the consumer waited on a unit that was not ready) and
``<node>.busy`` (the time the workers spent in units; it sums thread
time, so it can exceed the wall time) are also the node's
``prefetchConsumerStallNs`` and ``decodeThreadBusyNs`` metrics.

Spans (with tracing on): ``pipeline.boundary`` for each unit the
consumer takes (index ``i``), ``pipeline.wait`` inside it when the
consumer blocks, and ``pipeline.decode`` for each unit on its worker
thread, parented by a fork of the span that submitted it.

:func:`submit_spill_io` is the spill catalog's IO lane
(:mod:`..memory.spill`): its copies run on the same pool, bounded by
the catalog's own slots. A live fault injector forces the serial path
(:func:`parallel_active`), so which visit of a site faults does not
depend on thread timing, and the query deadline bounds the consumer's
wait on a unit (``pipeline.wait:<node>``). Left for the fusion layer:
``materialize_boundaries``.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
import time
from concurrent.futures import CancelledError, Future
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Callable, Iterator, List, Optional, Sequence

from ..config import (PIPELINE_DECODE_THREADS, PIPELINE_ENABLED,
                      PIPELINE_PREFETCH_DEPTH)
from ..metrics import trace as TR
from ..utils import lockdep

_STOP = object()

#: Name prefix of the pool's worker threads.
THREAD_PREFIX = "torch-pipeline"


class PoolShutdownError(RuntimeError):
    """The shared pool was shut down under this caller (a concurrent
    :meth:`~..session.TorchSession.close`); the pool is made anew on its
    next use, so the query can be run again."""


class PipelinePool:
    """Shared elastic worker pool: ``submit`` never queues a task behind
    a busy worker; it wakes an idle one or starts a daemon thread."""

    def __init__(self, name: str = THREAD_PREFIX):
        self._name = name
        self._tasks: "queue.Queue" = queue.Queue()
        self._lock = lockdep.lock("PipelinePool._lock")
        self._threads: List[threading.Thread] = []
        self._idle = 0
        self._seq = 0
        self._closed = False
        #: Set when shutdown starts.
        self.shutting_down = threading.Event()

    def submit(self, fn: Callable, *args) -> Future:
        f: Future = Future()
        # Enqueue and start under the lock (the queue is unbounded, so
        # neither blocks): shutdown() lists the live threads under the
        # same lock, so a new worker is either in its list or this submit
        # saw _closed and raised.
        with self._lock:
            if self._closed:
                raise PoolShutdownError("pipeline pool is shut down")
            spawn = self._idle == 0
            if not spawn:
                self._idle -= 1
            self._tasks.put((f, fn, args))
            if spawn:
                t = threading.Thread(target=self._work,
                                     name=f"{self._name}-{self._seq}",
                                     daemon=True)
                self._seq += 1
                self._threads.append(t)
                t.start()
        return f

    def _work(self) -> None:
        while True:
            item = self._tasks.get()
            if item is _STOP:
                return
            f, fn, args = item
            ran = f.set_running_or_notify_cancel()
            result = exc = None
            if ran:
                try:
                    result = fn(*args)
                # handed to the future unchanged: the consumer's result()
                # raises it where the query runs
                except BaseException as e:  # noqa: BLE001
                    exc = e
            # Back to the idle count before the result is published: a
            # consumer that wakes on result() and submits at once must
            # find this worker idle, or every task would start a thread.
            with self._lock:
                closed = self._closed
                if not closed:
                    self._idle += 1
            if ran:
                if exc is not None:
                    f.set_exception(exc)
                else:
                    f.set_result(result)
            if closed:
                return

    def alive_threads(self) -> List[threading.Thread]:
        with self._lock:
            return [t for t in self._threads if t.is_alive()]

    def shutdown(self, timeout: float = 10.0) -> List[threading.Thread]:
        """Stop taking work, wake every worker and join them. Returns the
        threads that did not stop within ``timeout``."""
        self.shutting_down.set()
        with self._lock:
            self._closed = True
            threads = [t for t in self._threads if t.is_alive()]
        for _ in threads:
            self._tasks.put(_STOP)
        deadline = time.monotonic() + timeout
        leaked = []
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                leaked.append(t)
        # Cancel what is still queued, so no consumer waits forever on a
        # future that no worker will run.
        while True:
            try:
                item = self._tasks.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                item[0].cancel()
        return leaked


_LOCK = lockdep.lock("pipeline._LOCK")
_POOL: Optional[PipelinePool] = None
_DECODE_SLOTS: Optional[threading.BoundedSemaphore] = None
#: The confs of the last :func:`configure`; the defaults are the confs'.
_CONF = {"decode_threads": PIPELINE_DECODE_THREADS.default,
         "prefetch_depth": PIPELINE_PREFETCH_DEPTH.default}


def configure(conf) -> None:
    """Keep a session's pool sizes (a :class:`~..config.TorchConf`) for
    callers that pass no conf. The decode limiter is made anew at its
    next use, so a resize reaches new work and leaves running holders of
    the old one alone."""
    global _DECODE_SLOTS
    with _LOCK:
        _CONF["decode_threads"] = int(conf.get(PIPELINE_DECODE_THREADS))
        _CONF["prefetch_depth"] = int(conf.get(PIPELINE_PREFETCH_DEPTH))
        _DECODE_SLOTS = None


def get_pool() -> PipelinePool:
    """The process-wide pool, made at first use and again after a
    shutdown (closing one session only quiesces it)."""
    global _POOL
    with _LOCK:
        if _POOL is None or _POOL.shutting_down.is_set():
            _POOL = PipelinePool()
        return _POOL


def shutdown(timeout: float = 10.0) -> List[threading.Thread]:
    """Join every worker of the pool. Returns the threads that did not
    stop within ``timeout``."""
    global _POOL
    with _LOCK:
        pool, _POOL = _POOL, None
    if pool is None:
        return []
    return pool.shutdown(timeout)


def _auto_threads() -> int:
    return max(2, min(4, os.cpu_count() or 2))


def _conf_int(conf, entry, key: str) -> int:
    """The session's conf value when there is a conf, else the value of
    the last :func:`configure`."""
    return int(conf.get(entry)) if conf is not None else _CONF[key]


def _decode_limiter(conf=None) -> threading.BoundedSemaphore:
    """The process-wide decode slots, made anew when the effective size
    changes (holders of a resized limiter keep their own reference)."""
    global _DECODE_SLOTS
    n = _conf_int(conf, PIPELINE_DECODE_THREADS, "decode_threads")
    n = n if n > 0 else _auto_threads()
    with _LOCK:
        if _DECODE_SLOTS is None \
                or getattr(_DECODE_SLOTS, "_initial_value", None) != n:
            _DECODE_SLOTS = threading.BoundedSemaphore(n)
        return _DECODE_SLOTS


def prefetch_depth(conf=None) -> int:
    return max(1, _conf_int(conf, PIPELINE_PREFETCH_DEPTH, "prefetch_depth"))


def submit_spill_io(fn: Callable, *args) -> Optional[Future]:
    """Hand one spill copy or disk append to the shared pool (the
    catalog bounds the lane with its own slots inside ``fn``). None when
    the pool refuses it (a shutdown race): the caller runs it inline,
    since a spill must land even while a session closes."""
    try:
        return get_pool().submit(fn, *args)
    except PoolShutdownError:
        return None


def parallel_active(ctx) -> bool:
    """Whether the pipeline may run work on the pool for this execution:
    never under a live fault injector (the injection schedule is
    deterministic per site), else ``spark.rapids.tpu.pipeline.enabled``
    of the context's conf (on when the context has none)."""
    if getattr(ctx, "fault_injector", None) is not None:
        return False
    conf = getattr(ctx, "conf", None)
    return True if conf is None else bool(conf.get(PIPELINE_ENABLED))


def _result_or_shutdown(f: Future, timeout: Optional[float] = None):
    """``f.result(timeout)``, with a cancellation by the pool's shutdown
    raised as :class:`PoolShutdownError` (``CancelledError`` would pass
    every ``except Exception``)."""
    try:
        return f.result(timeout)
    except CancelledError:
        raise PoolShutdownError(
            "pipeline pool shut down while this unit was awaited (a "
            "concurrent TorchSession.close); the unit was cancelled unrun"
        ) from None


def _record(ctx, name: str, t0: float, metric: str) -> None:
    if ctx is not None:
        ctx.host_interval(name, t0, time.perf_counter(), metric)


def _stalled_result(f: Future, ctx, node: Optional[str]):
    """``f``'s result, the time spent waiting for it on ``<node>.stall``
    and ``prefetchConsumerStallNs`` (the sign that the workers are the
    bottleneck), in a ``pipeline.wait`` span. The query deadline bounds
    the wait: once it passes, the wait raises
    :class:`~..utils.deadline.QueryDeadlineExceeded` (the unit itself
    runs on and is dropped)."""
    if f.done():
        return _result_or_shutdown(f)
    deadline = getattr(ctx, "deadline", None)
    t0 = time.perf_counter()
    try:
        with TR.span(getattr(ctx, "trace", None), "pipeline.wait",
                     cat="pipeline", node=node or "prefetch"), \
                lockdep.blocking("pipeline.future_wait"):
            if deadline is None:
                return _result_or_shutdown(f)
            while True:
                try:
                    return _result_or_shutdown(
                        f, timeout=max(deadline.remaining(), 0.0))
                except FutureTimeout:
                    if f.done():  # the unit itself raised TimeoutError
                        return _result_or_shutdown(f)
                    deadline.check(f"pipeline.wait:{node or 'prefetch'}",
                                   ctx, node)
    finally:
        if node:
            _record(ctx, node + ".stall", t0, "prefetchConsumerStallNs")


def _decode_task(fn: Callable, item, ctx, node: Optional[str],
                 span_fork=None):
    """One unit on the pool: it holds one of the process's decode slots,
    and its time goes on ``<node>.busy`` and ``decodeThreadBusyNs``, in a
    ``pipeline.decode`` span parented by ``span_fork`` (the submitting
    span; the trace root without one)."""
    with _decode_limiter(getattr(ctx, "conf", None)):
        t0 = time.perf_counter()
        try:
            with TR.span(span_fork, "pipeline.decode", cat="decode",
                         node=node or "scan"):
                return fn(item)
        finally:
            if node:
                _record(ctx, node + ".busy", t0, "decodeThreadBusyNs")


def ordered_map_iter(fn: Callable, items: Sequence, ctx=None,
                     node: Optional[str] = None,
                     depth: Optional[int] = None) -> Iterator:
    """``fn`` over ``items`` with up to ``depth`` results computing ahead
    on the pool, yielded in input order; a plain map when the pipeline is
    off."""
    if not parallel_active(ctx):
        for item in items:
            yield fn(item)
        return
    pool = get_pool()
    if depth is None:
        depth = prefetch_depth(getattr(ctx, "conf", None))
    futs: "collections.deque[Future]" = collections.deque()
    try:
        for item in items:
            futs.append(pool.submit(_decode_task, fn, item, ctx, node,
                                    TR.fork(getattr(ctx, "trace", None))))
            if len(futs) >= max(depth, 1):
                yield _stalled_result(futs.popleft(), ctx, node)
        while futs:
            yield _stalled_result(futs.popleft(), ctx, node)
    finally:
        # abandoned early: running units finish and are dropped, queued
        # ones never run
        for f in futs:
            f.cancel()


class _UnitScheduler:
    """Decode-ahead over one partition per unit: partition i's generator
    waits on future i, and pulling it schedules units i .. i + depth - 1,
    so the next units decode while the consumer works on this one."""

    def __init__(self, fn: Callable, units: Sequence, ctx,
                 node: Optional[str]):
        self._fn = fn
        self._units = list(units)
        self._ctx = ctx
        self._node = node
        self._depth = prefetch_depth(getattr(ctx, "conf", None))
        self._pool = get_pool()
        self._futs: dict = {}
        self._lock = lockdep.lock("_UnitScheduler._lock")
        # An attempt that stops early (an error, an abandoned run) drops
        # its look-ahead when the session runs the context's cleanups.
        if hasattr(ctx, "add_cleanup"):
            ctx.add_cleanup(self._cancel_pending)

    def _ensure(self, i: int) -> Future:
        span_fork = TR.fork(getattr(self._ctx, "trace", None))
        with self._lock:
            for j in range(i, min(i + self._depth, len(self._units))):
                if j not in self._futs:
                    self._futs[j] = self._pool.submit(
                        _decode_task, self._fn, self._units[j], self._ctx,
                        self._node, span_fork)
            return self._futs[i]

    def _cancel_pending(self) -> None:
        with self._lock:
            for f in self._futs.values():
                f.cancel()

    def partition(self, i: int) -> Iterator:
        with _boundary_span(self._ctx, i, self._node):
            out = _stalled_result(self._ensure(i), self._ctx, self._node)
        # the future goes with its result: a scheduler that outlives the
        # read must not keep every unit's device batch alive
        with self._lock:
            self._futs.pop(i, None)
        yield out


def _boundary_span(ctx, i: int, node: Optional[str]):
    return TR.span(getattr(ctx, "trace", None), "pipeline.boundary",
                   cat="pipeline", index=i, node=node or "scan")


def _serial_unit(fn: Callable, unit, ctx, i: int,
                 node: Optional[str]) -> Iterator:
    with _boundary_span(ctx, i, node):
        out = fn(unit)
    yield out


def unit_partitions(fn: Callable, units: Sequence, ctx,
                    node: Optional[str] = None) -> List[Iterator]:
    """One single-item partition (a generator) per unit, in order, each
    yielding ``fn(unit)``: computed ahead on the pool when the pipeline
    is on, else when the partition is read. A consumer reads each
    partition once, in order."""
    units = list(units)
    if len(units) <= 1 or not parallel_active(ctx):
        return [_serial_unit(fn, u, ctx, i, node)
                for i, u in enumerate(units)]
    sched = _UnitScheduler(fn, units, ctx, node)
    return [sched.partition(i) for i in range(len(units))]
