"""Typed, leveled operator metrics — port of
``spark_rapids_tpu/metrics/registry.py`` (the ``GpuMetric`` analog).

A per-query :class:`MetricsRegistry` holds :class:`TorchMetric`
accumulators keyed by (node name, metric name), with the reference's
standard taxonomy (:data:`TAXONOMY`): NANO_TIMING/SUM/PEAK/AVERAGE
kinds, ESSENTIAL/MODERATE/DEBUG levels gated by
``spark.rapids.tpu.metrics.level``. One ``QueryProfile``
(:mod:`.profile`) reads every layer's metrics from it.

Level gating happens at record time: a metric above the configured level
is dropped without allocation, and at level NONE the registry is inert.
Timing metrics are host wall time (:class:`..utils.tracing.NanoTimer`,
which doubles as a profiler range); device time comes from the CUDA
events the execution context already records, read at query end, and
only under ``spark.rapids.tpu.metrics.deviceTiming``.

The reference's legacy dict view of a registry is left out: the port has
no caller of it.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..config import METRICS_DEVICE_TIMING, METRICS_LEVEL
from ..utils import lockdep
from ..utils.tracing import NanoTimer, trace_range

# ---------------------------------------------------------------------------
# Levels (GpuMetric.scala: ESSENTIAL/MODERATE/DEBUG) and kinds.
# ---------------------------------------------------------------------------

NONE = 0
ESSENTIAL = 1
MODERATE = 2
DEBUG = 3

_LEVEL_NAMES = {"NONE": NONE, "ESSENTIAL": ESSENTIAL,
                "MODERATE": MODERATE, "DEBUG": DEBUG}
_LEVEL_STRS = {v: k for k, v in _LEVEL_NAMES.items()}


def parse_level(s: Optional[str]) -> int:
    """Parse a metrics level name; unknown values default to MODERATE (the
    reference's default for spark.rapids.sql.metrics.level)."""
    return _LEVEL_NAMES.get(str(s or "").strip().upper(), MODERATE)


def level_name(level: int) -> str:
    return _LEVEL_STRS.get(level, "MODERATE")


class MetricKind:
    SUM = "SUM"
    NANO_TIMING = "NANO_TIMING"
    PEAK = "PEAK"
    AVERAGE = "AVERAGE"


class MetricSpec:
    """Static description of one metric name: kind + level + doc. Frozen
    (shared across registries); accumulation state lives in
    TorchMetric."""

    __slots__ = ("name", "kind", "level", "doc")

    def __init__(self, name: str, kind: str, level: int, doc: str):
        self.name = name
        self.kind = kind
        self.level = level
        self.doc = doc


def _spec(name, kind, level, doc):
    return MetricSpec(name, kind, level, doc)


#: The standard metric taxonomy — the names every instrumented layer uses,
#: so profiles are comparable across operators and across runs, and the
#: same names as the reference's (tests/test_torch_metrics.py holds them
#: equal). Rendered as a table by taxonomy_markdown(). Names of
#: subsystems the port does not have yet (spill, semaphore, retry, the
#: net shuffle) are kept so a profile reads the same in both packages.
TAXONOMY: Dict[str, MetricSpec] = {s.name: s for s in [
    _spec("opTime", MetricKind.NANO_TIMING, ESSENTIAL,
          "Host-side wall time spent in the operator's dispatch path "
          "(device execution is async; see deviceTime for fenced time)."),
    _spec("deviceTime", MetricKind.NANO_TIMING, ESSENTIAL,
          "Device time of the operator's work on its stream, from the "
          "CUDA event pair around it, read at query end. Only recorded "
          "under spark.rapids.tpu.metrics.deviceTiming=true."),
    _spec("uploadBytes", MetricKind.SUM, ESSENTIAL,
          "Host->device bytes transferred (the scan's staged pages and "
          "run tables, the exchange's blocks)."),
    _spec("downloadBytes", MetricKind.SUM, ESSENTIAL,
          "Device->host bytes transferred (result downloads and the "
          "exchange's map-side downloads)."),
    _spec("numOutputRows", MetricKind.SUM, ESSENTIAL,
          "Rows produced, recorded only where the count is host-known "
          "(downloads, scans) — never via an extra device sync."),
    _spec("numOutputBatches", MetricKind.SUM, ESSENTIAL,
          "Batches produced by the operator."),
    _spec("numInputRows", MetricKind.SUM, MODERATE,
          "Rows consumed, where host-known."),
    _spec("numInputBatches", MetricKind.SUM, MODERATE,
          "Batches consumed."),
    _spec("spillBytes", MetricKind.SUM, ESSENTIAL,
          "Bytes pushed out of the device tier by the spill framework "
          "during the query (host + disk)."),
    _spec("semaphoreWaitNs", MetricKind.NANO_TIMING, MODERATE,
          "Time blocked acquiring the task-admission semaphore "
          "(spark.rapids.sql.concurrentTpuTasks)."),
    _spec("compileNs", MetricKind.NANO_TIMING, MODERATE,
          "Host time spent building kernels this query (the nvcc builds "
          "of ops/kernels/cuda/_build.py)."),
    _spec("shuffleBytesWritten", MetricKind.SUM, ESSENTIAL,
          "Serialized shuffle bytes written to the block catalog."),
    _spec("shuffleBytesRead", MetricKind.SUM, ESSENTIAL,
          "Serialized shuffle bytes read back on the reduce side."),
    _spec("buildTime", MetricKind.NANO_TIMING, MODERATE,
          "Join build-side accumulation wall time."),
    _spec("sortTime", MetricKind.NANO_TIMING, MODERATE,
          "Sort/top-k dispatch wall time."),
    _spec("concatTime", MetricKind.NANO_TIMING, DEBUG,
          "Batch-coalesce concat dispatch wall time."),
    _spec("serializationTime", MetricKind.NANO_TIMING, DEBUG,
          "Shuffle block serialization wall time."),
    _spec("deserializationTime", MetricKind.NANO_TIMING, DEBUG,
          "Shuffle block deserialization wall time."),
    _spec("writeTime", MetricKind.NANO_TIMING, MODERATE,
          "File-writer wall time (encode + filesystem)."),
    _spec("bytesWritten", MetricKind.SUM, ESSENTIAL,
          "Bytes written by the file writer."),
    _spec("numFiles", MetricKind.SUM, MODERATE,
          "Files produced by the file writer."),
    _spec("peakDeviceBytes", MetricKind.PEAK, MODERATE,
          "Peak device bytes observed (HBM watermark where the backend "
          "reports it)."),
    _spec("avgBatchRows", MetricKind.AVERAGE, DEBUG,
          "Average host-known rows per batch."),
    _spec("retryCount", MetricKind.SUM, ESSENTIAL,
          "Attempts re-run at the operator's retry sites after a "
          "classified OOM or transient fault (memory/retry.py; "
          "docs/fault-tolerance.md). Zero on a healthy run."),
    _spec("splitAndRetryCount", MetricKind.SUM, ESSENTIAL,
          "Input batches split in half by rows because retries alone "
          "could not fit the operator in device memory (the reference's "
          "splitSpillableInHalfByRows escalation)."),
    _spec("retryBlockTimeNs", MetricKind.NANO_TIMING, MODERATE,
          "Wall time spent blocked in retry backoff sleeps "
          "(spark.rapids.tpu.retry.backoffBaseMs ladder)."),
    _spec("retryWastedComputeNs", MetricKind.NANO_TIMING, MODERATE,
          "Wall time of failed attempts whose work was thrown away and "
          "re-run — the price of surviving the fault."),
    _spec("prefetchProducerStallNs", MetricKind.NANO_TIMING, ESSENTIAL,
          "Pipeline occupancy: time producers (prefetch workers, decode "
          "tasks) spent blocked on a full bounded prefetch queue — the "
          "consumer side is the bottleneck "
          "(spark.rapids.tpu.pipeline.prefetchDepth)."),
    _spec("prefetchConsumerStallNs", MetricKind.NANO_TIMING, ESSENTIAL,
          "Pipeline occupancy: time consumers spent blocked waiting for "
          "a prefetched batch or in-flight decode result — the producer "
          "side is the bottleneck."),
    _spec("decodeThreadBusyNs", MetricKind.NANO_TIMING, ESSENTIAL,
          "Total busy time of shared-pool decode tasks (file/row-group "
          "decode the pipeline layer overlapped with device work)."),
    _spec("boundaryOverlapNs", MetricKind.NANO_TIMING, ESSENTIAL,
          "Wall time saved by materializing independent fusion-boundary "
          "subtrees concurrently: the sum of per-boundary times minus "
          "elapsed time (spark.rapids.tpu.pipeline.boundaryParallelism)."),
    _spec("checksumFailures", MetricKind.SUM, ESSENTIAL,
          "Shuffle-block / spill-range CRC32C verifications that FAILED "
          "(utils/checksum.py; docs/fault-tolerance.md). Every failure "
          "was recovered by refetch or map recompute, or surfaced as a "
          "typed error — never as data. Zero on a healthy run."),
    _spec("shuffleBlocksRefetched", MetricKind.SUM, ESSENTIAL,
          "Shuffle blocks fetched again after a transport failure or "
          "checksum mismatch (only blocks not yet yielded re-fetch; "
          "shuffle/net.py). Zero on a healthy run."),
    _spec("mapTasksRecomputed", MetricKind.SUM, ESSENTIAL,
          "Map tasks deterministically re-executed from lineage because "
          "their shuffle blocks were lost or corrupt past refetch (the "
          "Spark stage-retry analog; shuffle/exchange.py "
          "MapOutputTracker). Zero on a healthy run."),
    _spec("deadlineCancels", MetricKind.SUM, ESSENTIAL,
          "Cooperative cancellations raised by the query deadline "
          "(spark.rapids.tpu.query.deadlineSecs): in-flight fetches, "
          "pipeline waits, and retry loops that observed an expired "
          "deadline and raised QueryDeadlineExceeded."),
    _spec("peersBlacklisted", MetricKind.SUM, ESSENTIAL,
          "Shuffle peers excluded for the session after repeated fetch "
          "failures (spark.rapids.tpu.shuffle.net.maxPeerFailures)."),
    _spec("hedgedFetches", MetricKind.SUM, ESSENTIAL,
          "Shuffle block fetches that exceeded the straggler threshold "
          "(spark.rapids.tpu.shuffle.hedge.quantileFactor x the peer's "
          "observed p50) and launched a duplicate request against a "
          "replica or the local recompute closure (shuffle/net.py). "
          "Zero on a healthy run."),
    _spec("hedgeWins", MetricKind.SUM, ESSENTIAL,
          "Hedged fetches where the DUPLICATE delivered first — the "
          "straggling primary was cancelled and the partition was "
          "served without waiting out its stall. Always <= "
          "hedgedFetches; the difference is hedge losses (wasted "
          "duplicate work)."),
    _spec("replicaReads", MetricKind.SUM, ESSENTIAL,
          "Shuffle blocks served by a replica "
          "(spark.rapids.tpu.shuffle.replication.factor) because the "
          "primary was dead, stalled, or blacklisted — each one a "
          "lineage recompute avoided. Zero on a healthy run."),
    _spec("meshFailovers", MetricKind.SUM, ESSENTIAL,
          "Mesh SPMD dispatches abandoned to the single-chip path after "
          "a device/host loss (MeshDegradedError) or a failed health "
          "probe (spark.rapids.tpu.mesh.health.probeEnabled): the query "
          "re-ran degraded instead of failing (exec/mesh.py, "
          "session.py). Zero on a healthy run."),
]}

#: Metrics recorded under names outside the taxonomy (operator-specific
#: counters like aqeOutputPartitions, stripeHostFallback) default to
#: SUM/MODERATE.
_AD_HOC_LEVEL = MODERATE


def taxonomy_markdown() -> str:
    """The taxonomy as a markdown table."""
    lines = ["Name | Kind | Level | Description",
             "-----|------|-------|------------"]
    for name in sorted(TAXONOMY):
        s = TAXONOMY[name]
        lines.append(f"`{name}`|{s.kind}|{level_name(s.level)}|{s.doc}")
    return "\n".join(lines) + "\n"


class TorchMetric:
    """One accumulator (the GpuMetric analog). Kind decides the merge:
    SUM/NANO_TIMING add, PEAK keeps the max, AVERAGE tracks (sum, count).
    Mutation is guarded by the owning registry's lock."""

    __slots__ = ("spec", "_sum", "_count", "_peak")

    def __init__(self, spec: MetricSpec):
        self.spec = spec
        self._sum = 0
        self._count = 0
        self._peak = 0

    def update(self, value) -> None:
        value = int(value) if not isinstance(value, float) else value
        if self.spec.kind == MetricKind.PEAK:
            self._peak = max(self._peak, value)
        elif self.spec.kind == MetricKind.AVERAGE:
            self._sum += value
            self._count += 1
        else:
            self._sum += value

    def set(self, value) -> None:
        """Overwrite (a value one site knows in full, such as the rows a
        query returned)."""
        if self.spec.kind == MetricKind.PEAK:
            self._peak = value
        else:
            self._sum = value
            self._count = 1

    @property
    def value(self):
        if self.spec.kind == MetricKind.PEAK:
            return self._peak
        if self.spec.kind == MetricKind.AVERAGE:
            return self._sum / self._count if self._count else 0
        return self._sum


class _NoopTimer:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_TIMER = _NoopTimer()


class MetricsRegistry:
    """Per-query metric store: (node name, metric name) -> TorchMetric.

    Thread-safe — the pipeline's workers report concurrently with the
    query's thread. Metrics are keyed by the exec's node_name(), so two
    instances of the same exec type in one plan share accumulators."""

    def __init__(self, level: int = MODERATE, device_timing: bool = False):
        self.level = level
        self.device_timing = device_timing and level > NONE
        self._lock = lockdep.lock("MetricsRegistry._lock")
        self._nodes: Dict[str, Dict[str, TorchMetric]] = {}

    @classmethod
    def for_conf(cls, conf) -> "MetricsRegistry":
        """Build from a :class:`~..config.TorchConf` (its
        ``spark.rapids.tpu.metrics.level`` and ``.deviceTiming``); no conf
        gives the defaults."""
        if conf is None:
            return cls()
        return cls(parse_level(conf.get(METRICS_LEVEL)),
                   bool(conf.get(METRICS_DEVICE_TIMING)))

    @property
    def enabled(self) -> bool:
        return self.level > NONE

    def _spec_for(self, name: str) -> MetricSpec:
        spec = TAXONOMY.get(name)
        if spec is None:
            spec = MetricSpec(name, MetricKind.SUM, _AD_HOC_LEVEL,
                              "operator-specific counter")
        return spec

    def records(self, name: str) -> bool:
        """Would a metric of this name be recorded at the current level?"""
        return self.level >= self._spec_for(name).level

    def _metric_locked(self, node: str, name: str) -> Optional[TorchMetric]:
        """The accumulator for (node, name), or None when gated. Caller
        holds the lock (one critical section per observation — this is the
        per-batch hot path)."""
        spec = self._spec_for(name)
        if self.level < spec.level:
            return None
        metrics = self._nodes.setdefault(node, {})
        m = metrics.get(name)
        if m is None:
            m = metrics[name] = TorchMetric(spec)
        return m

    def add(self, node: str, name: str, value) -> None:
        if self.level == NONE:  # inert: not even the lock
            return
        with self._lock:
            m = self._metric_locked(node, name)
            if m is not None:
                m.update(value)

    def set_value(self, node: str, name: str, value) -> None:
        if self.level == NONE:
            return
        with self._lock:
            m = self._metric_locked(node, name)
            if m is not None:
                m.set(value)

    def timer(self, node: str, name: str, trace: Optional[str] = None):
        """Exception-safe NANO_TIMING context manager, coupled with a
        profiler range (the NvtxWithMetrics analog). The range is opened
        regardless of the metrics level — profiler visibility must not
        depend on metric gating — but the clock reads and accumulation
        are skipped when the metric is gated."""
        if not self.records(name):
            if trace is None:
                return _NOOP_TIMER
            return trace_range(trace)
        return NanoTimer(trace or f"{node}.{name}",
                         _NodeSink(self, node), name)()

    # -- read side ----------------------------------------------------------
    def node_metrics(self, node: str) -> Dict[str, object]:
        with self._lock:
            return {n: m.value for n, m in self._nodes.get(node, {}).items()}

    def node_names(self):
        with self._lock:
            return list(self._nodes)

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        with self._lock:
            return {node: {n: m.value for n, m in metrics.items()}
                    for node, metrics in self._nodes.items()}


class _NodeSink:
    """Dict-shaped adapter binding NanoTimer to one node of a
    registry."""

    __slots__ = ("_registry", "_node")

    def __init__(self, registry: MetricsRegistry, node: str):
        self._registry = registry
        self._node = node

    def get(self, key, default=0):
        return self._registry.node_metrics(self._node).get(key, default)

    def __setitem__(self, key, value):
        self._registry.set_value(self._node, key, value)

    def add(self, key, value):
        self._registry.add(self._node, key, value)
