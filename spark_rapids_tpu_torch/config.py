"""Typed configuration — port of ``spark_rapids_tpu/config.py``.

Only the keys this package reads are registered. Keys keep the
reference's names, so a conf dict written for the JAX session means the
same here; an unknown ``spark.rapids.*`` key raises, as in the
reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

_REGISTRY: Dict[str, "ConfEntry"] = {}


@dataclasses.dataclass(frozen=True)
class ConfEntry:
    key: str
    default: Any
    doc: str
    conv: Callable[[str], Any]

    def get(self, conf: Dict[str, Any]) -> Any:
        if self.key in conf:
            v = conf[self.key]
            return self.conv(v) if isinstance(v, str) else v
        return self.default


def _register(key: str, default, doc: str, conv) -> ConfEntry:
    if key in _REGISTRY:
        raise ValueError(f"duplicate conf key {key}")
    e = ConfEntry(key, default, doc, conv)
    _REGISTRY[key] = e
    return e


def conf_int(key: str, default: int, doc: str) -> ConfEntry:
    return _register(key, default, doc, int)


def conf_bool(key: str, default: bool, doc: str) -> ConfEntry:
    return _register(key, default, doc,
                     lambda v: v.strip().lower() == "true")


def conf_str(key: str, default: str, doc: str) -> ConfEntry:
    return _register(key, default, doc, str)


TOPK_THRESHOLD = conf_int(
    "spark.rapids.tpu.sort.topKThreshold", 16384,
    "ORDER BY ... LIMIT n with n at or below this runs as the top-k exec "
    "instead of a global sort. 0 disables limit-into-sort.")

MESH_ENABLED = conf_bool(
    "spark.rapids.tpu.mesh.enabled", False,
    "Run mesh-capable queries as one partitioned program over the "
    "session's device mesh: sources shard row-wise, narrow operators run "
    "per shard, and aggregate, join and sort boundaries exchange rows "
    "between shards by murmur3 or by range (exec/mesh.py). Other plans "
    "run on the single-device path.")


PIPELINE_ENABLED = conf_bool(
    "spark.rapids.tpu.pipeline.enabled", True,
    "Decode the scans' units ahead on a shared pool of host threads "
    "(exec/pipeline.py): the parquet scan's next row groups read, parse "
    "and decompress while the query runs the current one. Results are "
    "bit for bit the same with the pipeline on or off.")

PIPELINE_DECODE_THREADS = conf_int(
    "spark.rapids.tpu.pipeline.decodeThreads", 0,
    "Units the pipeline decodes at once across the process. 0 = auto "
    "(min(4, cpu count), at least 2). Each unit in flight holds its row "
    "group's decompressed pages in host memory.")

PIPELINE_PREFETCH_DEPTH = conf_int(
    "spark.rapids.tpu.pipeline.prefetchDepth", 2,
    "Look-ahead of the scans: the units in flight from the one the "
    "consumer reads, that one included.")


PARQUET_REBASE_READ = conf_str(
    "spark.sql.legacy.parquet.datetimeRebaseModeInRead", "EXCEPTION",
    "Dates and timestamps of parquet files written with the legacy hybrid "
    "calendar (Spark 2.x): EXCEPTION raises when they may reach before "
    "the calendar switch, CORRECTED reads the raw values as proleptic, "
    "LEGACY raises (the reader does not rebase).")


METRICS_LEVEL = conf_str(
    "spark.rapids.tpu.metrics.level", "MODERATE",
    "Operator metrics level (metrics/registry.py): NONE turns the whole "
    "query-profile layer off (no metric recording, no QueryProfile), "
    "ESSENTIAL records the core taxonomy (rows, batches, bytes, opTime), "
    "MODERATE adds build, sort and pipeline timings, DEBUG adds "
    "serialization and concat internals. Answers are bit for bit the "
    "same at every level, and no level below DEBUG adds a device "
    "synchronisation.")

METRICS_DEVICE_TIMING = conf_bool(
    "spark.rapids.tpu.metrics.deviceTiming", False,
    "Attribute device time per query: each exec's CUDA event pair becomes "
    "its deviceTime metric, and a CUDA event pair around every kernel "
    "launch becomes the profile's per-family deviceTimeNs, all read at "
    "query end after the synchronisation the session does anyway.")

METRICS_EVENT_LOG_DIR = conf_str(
    "spark.rapids.tpu.metrics.eventLog.dir", None,
    "Directory for the structured query event log: every executed query "
    "appends its QueryProfile as one JSON line to query_profiles.jsonl "
    "(crash-safe append; torn lines are skipped on read). Unset disables "
    "the log.")

METRICS_EVENT_LOG_MAX_BYTES = conf_int(
    "spark.rapids.tpu.metrics.eventLog.maxBytes", 64 << 20,
    "Size cap of the event log: when an append would push "
    "query_profiles.jsonl past this many bytes, the file is renamed to "
    "query_profiles.jsonl.1 (one prior generation kept) and the append "
    "starts a fresh file. 0 disables rotation.")

TRACE_ENABLED = conf_bool(
    "spark.rapids.tpu.trace.enabled", False,
    "Per-query span tracing (metrics/trace.py): a span tree over the "
    "session's plan and dispatch attempts, the scans' pipeline workers "
    "and the exchange's map side, exported per query as Chrome "
    "trace-event JSON beside the event log. Off by default: the disabled "
    "path is no-op spans and bit-identical results. Read per session.")

TRACE_DIR = conf_str(
    "spark.rapids.tpu.trace.dir", None,
    "Directory for exported per-query trace files "
    "(trace_<trace_id>.json). Unset: traces land beside the event log "
    "(spark.rapids.tpu.metrics.eventLog.dir); with neither set, spans "
    "still feed the in-memory flight recorder but no file is written.")

TRACE_MAX_FILES = conf_int(
    "spark.rapids.tpu.trace.maxFiles", 256,
    "Retention bound on exported trace files: after each export the "
    "oldest trace_*.json beyond this count are removed from the trace "
    "directory. 0 disables pruning.")

TRACE_FLIGHT_SPANS = conf_int(
    "spark.rapids.tpu.trace.flightRecorder.spans", 4096,
    "Bound on the in-memory flight recorder: the ring keeps this many "
    "recent finished spans and engine events across all queries, dumped "
    "to JSON by trace.flight_dump and on SIGTERM once tracing is on.")

TRACE_FLIGHT_DIR = conf_str(
    "spark.rapids.tpu.trace.flightRecorder.dir", "artifacts",
    "Directory flight-recorder dumps are written to "
    "(flight_<reason>_<pid>_<n>.json; bounded per reason).")



def conf_float(key: str, default: float, doc: str) -> ConfEntry:
    return _register(key, default, doc, float)


# Memory and robustness (the reference's config.py, RapidsConf.scala:241-301)

SORT_EXTERNAL_THRESHOLD = conf_int(
    "spark.rapids.sql.sort.externalThresholdBytes", 0,
    "Accumulated input bytes above which a global sort takes the external "
    "merge sort (sorted runs through the spill catalog, a bounded device "
    "footprint; exec/external_sort.py). 0 = a quarter of the device spill "
    "budget.")

WINDOW_EXTERNAL_THRESHOLD = conf_int(
    "spark.rapids.sql.window.externalThresholdBytes", 0,
    "Window inputs above this many device bytes evaluate in bounded "
    "chunks: the input external-sorts by the shared partition-by keys "
    "through the spill catalog and complete key groups evaluate one chunk "
    "at a time. 0 = a quarter of the device spill budget. Chunked output "
    "rows arrive sorted by the partition keys instead of in input order.")

CONCURRENT_TPU_TASKS = conf_int(
    "spark.rapids.sql.concurrentTpuTasks", 2,
    "Queries that may hold the device at once (the task semaphore; the "
    "reference's spark.rapids.sql.concurrentGpuTasks).")

CONCURRENT_ACQUIRE_TIMEOUT = conf_float(
    "spark.rapids.tpu.concurrentTpuTasks.acquireTimeout", 0.0,
    "Seconds a query may wait for the task semaphore before failing with "
    "SemaphoreTimeoutError naming the holding threads. 0 waits forever.")

RETRY_MAX_RETRIES = conf_int(
    "spark.rapids.tpu.retry.maxRetries", 3,
    "In-place retries of an operator attempt after a classified OOM or "
    "transient fault (memory/retry.py) before escalating: OOMs split the "
    "input in half by rows (SplitAndRetryOOM at unsplittable sites), "
    "transients re-raise. Each OOM retry first synchronizes the device "
    "and spills every spillable buffer below on-deck priority.")

RETRY_BACKOFF_BASE_MS = conf_float(
    "spark.rapids.tpu.retry.backoffBaseMs", 10.0,
    "Base delay of the capped exponential retry backoff (doubles per "
    "attempt, deterministic jitter from the site name). 0 disables the "
    "sleep.")

RETRY_BACKOFF_MAX_MS = conf_float(
    "spark.rapids.tpu.retry.backoffMaxMs", 1000.0,
    "Ceiling on one retry backoff sleep, milliseconds.")

FAULT_INJECTION_SITES = conf_str(
    "spark.rapids.tpu.test.faultInjection.sites", "",
    "For tests: comma-separated retry-site names or prefixes ('*' = every "
    "site) where the deterministic fault injector raises synthetic faults "
    "(utils/fault_injection.py). Empty disables injection.")

FAULT_INJECTION_SEED = conf_int(
    "spark.rapids.tpu.test.faultInjection.seed", 0,
    "Phase and flavor seed of the fault injector: which visit of a site "
    "faults and which transient flavor is raised. Same seed, same "
    "schedule.")

FAULT_INJECTION_OOM_EVERY_N = conf_int(
    "spark.rapids.tpu.test.faultInjection.oomEveryN", 0,
    "Raise an injected torch.OutOfMemoryError at every Nth visit of each "
    "matched site; negative N faults the first |N| visits, then the site "
    "heals. 0 disables.")

FAULT_INJECTION_TRANSIENT_EVERY_N = conf_int(
    "spark.rapids.tpu.test.faultInjection.transientEveryN", 0,
    "Raise an injected transient fault (a helper race or a spill-disk "
    "OSError, chosen from the seed) at every Nth visit of each matched "
    "site; negative N faults the first |N| visits. 0 disables.")

HBM_ALLOC_FRACTION = conf_float(
    "spark.rapids.memory.tpu.allocFraction", 0.9,
    "Fraction of the card's memory the spill catalog's device store may "
    "hold (the reference's spark.rapids.memory.gpu.allocFraction).")

HOST_SPILL_STORAGE_SIZE = conf_int(
    "spark.rapids.memory.host.spillStorageSize", 1 << 30,
    "Bytes of host memory (pinned on the card) that hold spilled device "
    "buffers before they overflow to disk.")

SPILL_DIR = conf_str(
    "spark.rapids.memory.tpu.spillDir", None,
    "Directory of the disk spill tier; a fresh temporary directory by "
    "default.")

DEVICE_SPILL_BUDGET = conf_int(
    "spark.rapids.memory.tpu.spillBudgetBytes", 0,
    "Explicit byte budget of the device store; 0 derives it from "
    "allocFraction of the card's memory (torch.cuda.mem_get_info).")

SPILL_IO_THREADS = conf_int(
    "spark.rapids.tpu.spill.ioThreads", 2,
    "Concurrency of the spill-IO lane on the shared pipeline pool: "
    "device-host copies and spill-file appends run off the catalog lock "
    "with up to this many in flight. 0 runs them inline on the "
    "requesting thread (still off the lock).")

QUERY_DEADLINE_SECS = conf_float(
    "spark.rapids.tpu.query.deadlineSecs", 0.0,
    "Wall-clock budget of one query, seconds: retry loops, pipeline waits "
    "and the session's dispatch raise QueryDeadlineExceeded naming the "
    "slowest site once it is spent (never retried). 0 disables.")

SHUFFLE_CHECKSUM_ENABLED = conf_bool(
    "spark.rapids.tpu.shuffle.checksum.enabled", True,
    "Record a CRC32C of every shuffle block and verify it on every read, "
    "in host memory and on disk, so a corrupt block raises ChecksumError "
    "instead of becoming data.")

BATCH_SIZE_ROWS = conf_int(
    "spark.rapids.sql.batchSizeRows", 1 << 20,
    "Target rows of the batches a coalesce produces (exec/coalesce.py): "
    "small batches are concatenated up to this capacity before an "
    "aggregate, sort or top-k.")

FUSION_ENABLED = conf_bool(
    "spark.rapids.tpu.fusion.enabled", True,
    "Run a query's device region as one program (exec/fusion.py): its "
    "boundaries (scans, exchanges, windows, sorts, top-k) run first, the "
    "region then runs once eagerly, is captured as one CUDA graph on its "
    "second run and replayed from then on, and the result comes back in "
    "one device->host transfer. A region that synchronises with the host "
    "is refused (counted, with its site) and runs on the streaming "
    "path.")

FUSION_INLINE_JOINS = conf_bool(
    "spark.rapids.tpu.fusion.inlineJoins", True,
    "Inline shuffled hash joins into the fused region instead of making "
    "each one a boundary.")

COLLECT_GUESS_ROWS = conf_int(
    "spark.rapids.tpu.collect.guessRows", 1024,
    "Rows of a fused result that come back in its one head transfer; a "
    "larger result pays a second download of the full batch.")

UPLOAD_CACHE_BYTES = conf_int(
    "spark.rapids.tpu.uploadCache.maxBytes", 1 << 30,
    "Device bytes of the upload cache (data/upload_cache.py): an upload "
    "of read-only numpy arrays is kept and served again. 0 disables.")

PIPELINE_BOUNDARY_PARALLELISM = conf_int(
    "spark.rapids.tpu.pipeline.boundaryParallelism", 0,
    "Fusion boundaries materialised at once on the pipeline's pool "
    "before a fused dispatch. 0 = auto (min(4, cpu count), at least 2); "
    "1 materialises them one after another.")


class TorchConf:
    """Immutable snapshot of a conf dict with typed access."""

    def __init__(self, conf: Optional[Dict[str, Any]] = None):
        self._conf = dict(conf or {})
        for k in self._conf:
            if k.startswith("spark.rapids.") and k not in _REGISTRY:
                raise KeyError(f"unknown rapids conf key: {k}")

    def get(self, entry: ConfEntry) -> Any:
        return entry.get(self._conf)

    def as_dict(self) -> Dict[str, Any]:
        """The conf's keys and values as given."""
        return dict(self._conf)

    @property
    def metrics_event_log_dir(self) -> Optional[str]:
        return self.get(METRICS_EVENT_LOG_DIR) or None
