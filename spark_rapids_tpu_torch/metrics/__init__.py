"""Query-profile layer — port of ``spark_rapids_tpu/metrics``: typed
leveled metrics, per-kernel launch and device-time attribution,
structured trace events, and metric-annotated EXPLAIN.

* :mod:`.registry` — ``TorchMetric``/``MetricsRegistry``: the GpuMetric
  analog; NANO_TIMING/SUM/PEAK/AVERAGE kinds, ESSENTIAL/MODERATE/DEBUG
  levels gated by ``spark.rapids.tpu.metrics.level``, and the standard
  taxonomy every layer reports into.
* :mod:`.profile` — ``QueryProfile``/``QueryProfiler``: the per-query
  operator-tree snapshot with the CUDA kernels' launches (and, under
  ``spark.rapids.tpu.metrics.deviceTiming``, device time) folded in,
  rendered by ``df.explain(metrics=True)``.
* :mod:`.eventlog` — crash-safe JSON-lines event log
  (``spark.rapids.tpu.metrics.eventLog.dir``), one line per query, with
  size-capped rotation.
* :mod:`.trace` — per-query span tracing
  (``spark.rapids.tpu.trace.enabled``): the span-tree engine, Chrome
  trace-event export, the wire encoding of a trace context, and the
  flight-recorder ring. Not re-exported here (call sites import the
  module directly — its disabled path is one None check).
"""

from .eventlog import EventLog
from .profile import (QueryProfile, QueryProfiler, compare_profiles,
                      dump_profiles, load_profiles)
from .registry import (DEBUG, ESSENTIAL, MODERATE, NONE, TAXONOMY,
                       MetricKind, MetricsRegistry, MetricSpec, TorchMetric,
                       level_name, parse_level, taxonomy_markdown)

__all__ = [
    "DEBUG", "ESSENTIAL", "MODERATE", "NONE", "TAXONOMY", "MetricKind",
    "MetricsRegistry", "MetricSpec", "TorchMetric", "level_name",
    "parse_level", "taxonomy_markdown", "QueryProfile", "QueryProfiler",
    "compare_profiles", "dump_profiles", "load_profiles", "EventLog",
]
