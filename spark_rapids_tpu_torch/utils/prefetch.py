"""Background prefetch — port of ``spark_rapids_tpu/utils/prefetch.py``
(``prefetch_iter``).

Double buffering: a worker of the shared pipeline pool
(:mod:`..exec.pipeline`) pulls the next items of an iterator while the
consumer works on the current one, at most ``depth`` ahead. The
reference's callers (the exchange's overlapped reduce side, the
host-to-device and text readers) are not ported yet; the port's read
sides take it up as they come. Stalls on
either side of the bounded queue go to ``prefetchProducerStallNs`` and
``prefetchConsumerStallNs`` of ``node``; the query deadline bounds the
consumer's wait (``prefetch.wait:<node>``). An abandoned iteration (a
consumer that stops early) stops the worker and drops what it queued.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator, Optional

from . import lockdep

_STOP = object()
_PENDING = object()


def prefetch_iter(src: Iterable, depth: int = 2, ctx=None,
                  node: Optional[str] = None) -> Iterator:
    """Iterate ``src`` on a pool worker, up to ``depth`` items ready; an
    exception of ``src`` re-raises at the consumer's next ``next()``."""
    from ..exec import pipeline as _pipeline
    pool = _pipeline.get_pool()
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    cancelled = threading.Event()
    stalls = {"producer": 0}

    def put(item) -> bool:
        try:
            q.put_nowait(item)
            return True
        except queue.Full:
            pass
        t0 = time.perf_counter_ns()
        try:
            while not cancelled.is_set() \
                    and not pool.shutting_down.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False
        finally:
            stalls["producer"] += time.perf_counter_ns() - t0

    def work():
        try:
            try:
                for item in src:
                    if not put(item):
                        return
            # handed to the consumer, which re-raises it
            except BaseException as e:  # noqa: BLE001
                put((_STOP, e))
                return
            put((_STOP, None))
        finally:
            if ctx is not None and node and stalls["producer"]:
                ctx.metric(node, "prefetchProducerStallNs",
                           stalls["producer"])

    fut = pool.submit(work)
    consumer_stall = 0
    deadline = getattr(ctx, "deadline", None)
    try:
        while True:
            try:
                item = q.get_nowait()
            except queue.Empty:
                t0 = time.perf_counter_ns()
                item = _PENDING
                while item is _PENDING:
                    try:
                        with lockdep.blocking("prefetch.consumer_wait"):
                            item = q.get(timeout=0.5)
                    except queue.Empty:
                        if deadline is not None:
                            deadline.check(
                                f"prefetch.wait:{node or 'stream'}",
                                ctx, node)
                        if not fut.done():
                            continue
                        try:
                            item = q.get_nowait()
                        except queue.Empty:
                            # the pool shut down under a live iteration:
                            # fail loudly rather than truncate
                            raise _pipeline.PoolShutdownError(
                                "pipeline pool shut down while this "
                                "prefetch stream was still being consumed"
                            ) from None
                consumer_stall += time.perf_counter_ns() - t0
            if isinstance(item, tuple) and len(item) == 2 \
                    and item[0] is _STOP:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        cancelled.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        if ctx is not None and node and consumer_stall:
            ctx.metric(node, "prefetchConsumerStallNs", consumer_stall)
