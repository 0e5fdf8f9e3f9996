"""Profiler trace annotations — port of
``spark_rapids_tpu/utils/tracing.py``.

The reference wraps every operator phase in an NVTX range so Nsight shows
named spans; the JAX package's counterpart is a ``TraceAnnotation``.
Here :func:`trace_range` is ``torch.profiler.record_function`` (its span
shows in a ``torch.profiler`` trace) plus ``torch.cuda.nvtx.range`` once
CUDA is in use in the process, the NVTX range the reference names.

:class:`NanoTimer` couples a trace range with an accumulated nanosecond
metric (NvtxWithMetrics): the NANO_TIMING implementation of
:meth:`..metrics.registry.MetricsRegistry.timer`.
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace_range(name: str):
    """Named profiler span; also usable when no profiler is active. An
    NVTX range opens with it when CUDA is initialised in this process
    (the CPU build of PyTorch has no NVTX)."""
    nvtx = torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class NanoTimer:
    """Couples a trace range with an accumulated nanosecond metric.

    ``metrics`` is either a plain dict or any sink with an ``add(key,
    nanos)`` method (the registry's node adapter). Accumulation happens
    in a ``finally``, so an exception inside the ``with`` body still
    records the time spent before the raise, and a non-numeric existing
    value counts as 0 rather than raising mid-metric."""

    def __init__(self, name: str, metrics, key: str):
        self.name = name
        self.metrics = metrics
        self.key = key

    @contextlib.contextmanager
    def __call__(self):
        start = time.perf_counter_ns()
        try:
            with trace_range(self.name):
                yield
        finally:
            elapsed = time.perf_counter_ns() - start
            sink = self.metrics
            add = getattr(sink, "add", None)
            if callable(add):
                add(self.key, elapsed)
            else:
                prev = sink.get(self.key, 0)
                if not isinstance(prev, (int, float)) \
                        or isinstance(prev, bool):
                    prev = 0
                sink[self.key] = prev + elapsed
