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


class TorchConf:
    """Immutable snapshot of a conf dict with typed access."""

    def __init__(self, conf: Optional[Dict[str, Any]] = None):
        self._conf = dict(conf or {})
        for k in self._conf:
            if k.startswith("spark.rapids.") and k not in _REGISTRY:
                raise KeyError(f"unknown rapids conf key: {k}")

    def get(self, entry: ConfEntry) -> Any:
        return entry.get(self._conf)
