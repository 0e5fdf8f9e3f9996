"""Per-query profiles — port of ``spark_rapids_tpu/metrics/profile.py``:
the operator tree annotated with its metrics.

A :class:`QueryProfile` snapshots, at query end:

* the physical operator tree (node names + describe strings) with each
  node's metrics from the query's :class:`~.registry.MetricsRegistry`;
* "extra" metric nodes that are not plan operators (``DeviceToHost``,
  the mesh path's shard and reduce steps);
* the engine section: per kernel family, the launches of the
  hand-written CUDA kernels over the query (the wrappers' ``launches``
  counts, :func:`..ops.kernels.cuda.stats`) and, under
  ``spark.rapids.tpu.metrics.deviceTiming``, their device time
  (``engine["cuda"]``, the reference's ``engine.pallas``); and the
  ``nvcc`` builds the query paid for (``engine["compile"]``, the
  reference's kernel-cache misses).

* ``planLint`` (what plan lint found: ``warns``, ``fallback``, ``ms``,
  ``memo``) and ``persistent_cache`` (the session's compile manifest's
  status, as the reference's ``compile_status`` has it);
* the memory sections (:mod:`..memory`), under the reference's key
  names: ``semaphoreWaitNs``, ``spillBytes`` (``spillBytesToHost`` +
  ``spillBytesToDisk``), ``diskSpillFileBytes``,
  ``spillThroughputBytesPerSec``, ``spillQueueDepth``,
  ``spillLockWaitNs``, ``deviceStoreBytes`` and the HBM watermarks
  (``hbmBytesInUse``, ``hbmPeakBytesInUse``: the caching allocator's
  bytes); ``spillTransitions`` (bytes and ns of each tier transition);
  ``retry`` (the retry metrics summed over the query's nodes); and
  ``durability`` (``checksumVerified``, ``checksumFailures``, from the
  process-wide checksum counters, and ``deadlineCancels``).

The reference's ``ml`` section and the durability counters of the
network plane (refetches, recomputes, hedges, replicas, mesh failovers)
are left out: their subsystems are not ported.

Profiles serialize to one JSON line in the event log (:mod:`.eventlog`),
render as a metric-annotated EXPLAIN tree (``df.explain(metrics=True)``,
``TorchSession.last_query_profile()``) and diff against an earlier run
(:func:`compare_profiles`).

Metrics are keyed by node_name(), so two instances of the same exec type
in one plan share accumulators; the render marks repeated names with
``*``.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import time
from typing import Dict, List, Optional

from ..config import METRICS_LEVEL
from ..ops.kernels import cuda as _cuda
from ..utils import checksum as _checksum
from .registry import NONE, MetricsRegistry, level_name, parse_level

#: Profile schema version (the reference's; the event-log layout is
#: shared).
VERSION = 1


def plan_profile_hash(plan_sig: tuple) -> str:
    """Short stable hash of a structural plan signature (the session's
    ``(tree_string, mesh)`` key) — lets explain(metrics=True) check that
    the last profile belongs to THIS query shape."""
    return hashlib.sha256(repr(plan_sig).encode()).hexdigest()[:16]


@dataclasses.dataclass
class QueryProfile:
    """One executed query's observability record."""

    query_id: int
    plan_hash: str
    wall_ns: int
    level: str
    #: nested {"name", "describe", "metrics": {..}, "children": [..]}
    tree: dict
    #: metric nodes with no plan operator: {node: {name: value}}
    extras: Dict[str, dict]
    #: engine counters: the cuda and compile sections
    engine: dict
    timestamp: str = ""
    version: int = VERSION

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "QueryProfile":
        """From a profile dict of either package (keys the port does not
        have, such as the reference's ``tenant``, are dropped)."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    # -- rendering ----------------------------------------------------------
    def render(self) -> str:
        """The metric-annotated EXPLAIN tree."""
        counts: Dict[str, int] = {}
        _count_names(self.tree, counts)
        lines = [f"== Query Profile #{self.query_id} "
                 f"(level={self.level}, wall={_fmt_ns(self.wall_ns)}) =="]
        _render_node(self.tree, 0, counts, lines)
        shared = sorted(n for n, c in counts.items() if c > 1)
        if shared:
            lines.append("(* metrics are keyed by node name and shared by "
                         f"repeated operators: {', '.join(shared)})")
        for node in sorted(self.extras):
            lines.append(f"+ {node}  {_fmt_metrics(self.extras[node])}")
        comp = self.engine.get("compile")
        if comp:
            lines.append(f"+ compile  {_fmt_metrics(comp)}")
        for section in ("retry", "durability"):
            vals = self.engine.get(section) or {}
            if any(vals.values()):
                lines.append(f"+ {section}  {_fmt_metrics(vals)}")
        if self.engine.get("spillBytes"):
            lines.append("+ spill  " + _fmt_metrics(
                {k: v for k, v in self.engine.items()
                 if k.startswith("spill") and not isinstance(v, dict)}))
        kernels = (self.engine.get("cuda") or {}).get("kernels") or {}
        if kernels:
            parts = []
            for k, m in sorted(kernels.items()):
                dev = m.get("deviceTimeNs")
                parts.append(f"{k}={m.get('launches', 0)}"
                             + ("" if dev is None else f"/{_fmt_ns(dev)}"))
            lines.append("+ cuda  [" + ", ".join(parts) + "]")
        return "\n".join(lines) + "\n"


def _count_names(node: dict, counts: Dict[str, int]) -> None:
    counts[node["name"]] = counts.get(node["name"], 0) + 1
    for c in node["children"]:
        _count_names(c, counts)


def _render_node(node: dict, indent: int, counts, lines: List[str]) -> None:
    star = "*" if counts.get(node["name"], 0) > 1 and node["metrics"] else ""
    tail = f"  {_fmt_metrics(node['metrics'])}{star}" if node["metrics"] \
        else ""
    lines.append("  " * indent + node["describe"] + tail)
    for c in node["children"]:
        _render_node(c, indent + 1, counts, lines)


def _fmt_ns(v) -> str:
    return f"{v / 1e6:.1f}ms"


def _fmt_metrics(metrics: dict) -> str:
    parts = []
    for name in sorted(metrics):
        v = metrics[name]
        if isinstance(v, dict):
            continue
        if (name.endswith("Ns") or name.endswith("Time")) \
                and isinstance(v, (int, float)):
            parts.append(f"{name}={_fmt_ns(v)}")
        elif isinstance(v, float):
            parts.append(f"{name}={v:.2f}")
        else:
            parts.append(f"{name}={v}")
    return "[" + ", ".join(parts) + "]"


# ---------------------------------------------------------------------------
# Collection
# ---------------------------------------------------------------------------


class QueryProfiler:
    """Brackets one query execution: captures the kernel counters at
    start, snapshots the registry and the deltas at finish. Made only
    when the metrics level is above NONE — at NONE nothing is measured.
    :meth:`finish` reads only host state and CUDA events that have
    completed (the session synchronised for ``QueryInfo.exec_ms``
    before), so it adds no device synchronisation."""

    def __init__(self, session=None):
        self._t0 = time.perf_counter_ns()
        self._cuda0 = _cuda.stats()
        self._ck0 = _checksum.stats()
        self._manifest = getattr(session, "manifest", None)
        self._dm = getattr(session, "device_manager", None)
        if self._dm is not None:
            self._spill0 = dict(self._dm.catalog.metrics)
            self._sem0 = self._dm.semaphore.wait_ns

    @classmethod
    def maybe(cls, session) -> Optional["QueryProfiler"]:
        """A profiler for a query of ``session``, or None at level NONE."""
        if parse_level(session.conf.get(METRICS_LEVEL)) == NONE:
            return None
        return cls(session)

    def finish(self, physical, ctx, plan_sig: tuple,
               query_id: int) -> QueryProfile:
        wall_ns = time.perf_counter_ns() - self._t0
        registry: MetricsRegistry = ctx.registry
        tree = _tree_of(physical, registry)
        tree_names: set = set()
        _collect_names(tree, tree_names)
        extras = {node: registry.node_metrics(node)
                  for node in registry.node_names()
                  if node not in tree_names}
        now = _cuda.stats()
        snapshot = registry.snapshot()
        ck = _checksum.stats()
        # the final attempt's launch events, complete since the session's
        # synchronisation for QueryInfo.exec_ms
        device_ns = _cuda.device_ns(ctx.kernel_events) \
            if registry.device_timing else None
        engine = {
            # the reference's kernel-cache misses and build time: the
            # nvcc builds this query started
            "compile": {
                "kernelCompiles": _delta(now["builds"], self._cuda0["builds"],
                                         "count"),
                "compileNs": _delta(now["builds"], self._cuda0["builds"],
                                    "ns"),
            },
            "cuda": {"kernels": _kernel_section(
                self._cuda0["launches"], now["launches"], device_ns)},
            "retry": {name: _registry_total(snapshot, name)
                      for name in RETRY_METRICS},
            "durability": {
                "checksumVerified": _delta(ck, self._ck0, "verified"),
                "checksumFailures": _delta(ck, self._ck0, "failures"),
                "deadlineCancels": _registry_total(snapshot,
                                                   "deadlineCancels"),
            },
        }
        if ctx.plan_lint is not None:
            engine["planLint"] = dict(ctx.plan_lint)
        from ..compile import persist
        engine["persistent_cache"] = persist.status(self._manifest)
        if self._dm is not None:
            engine.update(self._memory_sections())
        return QueryProfile(
            query_id=query_id,
            plan_hash=plan_profile_hash(plan_sig),
            wall_ns=wall_ns,
            level=level_name(registry.level),
            tree=tree,
            extras=extras,
            engine=engine,
            timestamp=datetime.datetime.now(datetime.timezone.utc)
            .isoformat(timespec="seconds"),
        )


    def _memory_sections(self) -> dict:
        """The spill, semaphore and HBM sections: per-query deltas of the
        device manager's process-wide counters."""
        dm = self._dm
        spill = dict(dm.catalog.metrics)
        base = self._spill0
        transitions = {}
        for t in ("device_to_host", "host_to_disk", "disk_to_device",
                  "host_to_device"):
            nbytes = _delta(spill, base, t + "_bytes")
            ns = _delta(spill, base, t + "_ns")
            if nbytes:
                transitions[t] = {"bytes": nbytes, "ns": ns,
                                  "GBps": nbytes / max(ns, 1)}
        return {
            "semaphoreWaitNs": dm.semaphore.wait_ns - self._sem0,
            "spillBytes": _delta(spill, base, "spill_bytes_to_host")
            + _delta(spill, base, "spill_bytes_to_disk"),
            "spillBytesToHost": _delta(spill, base, "spill_bytes_to_host"),
            "spillBytesToDisk": _delta(spill, base, "spill_bytes_to_disk"),
            "diskSpillFileBytes": int(spill.get("disk_spill_file_bytes", 0)),
            "spillThroughputBytesPerSec": _rate_per_sec(
                _delta(spill, base, "spill_io_bytes"),
                _delta(spill, base, "spill_io_ns")),
            "spillQueueDepth": int(spill.get("spill_queue_peak", 0)),
            "spillLockWaitNs": _delta(spill, base, "spill_lock_wait_ns"),
            "deviceStoreBytes": dm.catalog.device_bytes,
            "spillTransitions": transitions,
            **dm.hbm_watermarks(),
        }


#: The retry metrics the profile's ``retry`` section sums over nodes.
RETRY_METRICS = ("retryCount", "splitAndRetryCount", "retryBlockTimeNs",
                 "retryWastedComputeNs")


def _rate_per_sec(nbytes: int, ns: int) -> int:
    return int(nbytes * 1e9 / ns) if ns > 0 else 0


def _registry_total(snapshot: Dict[str, dict], name: str) -> int:
    """``name`` summed over every node of a registry snapshot."""
    return int(sum(m.get(name, 0) or 0 for m in snapshot.values()))


def _delta(now: dict, base: dict, key: str) -> int:
    return int(now.get(key, 0)) - int(base.get(key, 0))


def _kernel_section(base: Dict[str, int], now: Dict[str, int],
                    device_ns: Optional[Dict[str, int]]) -> dict:
    """``{family: {"launches": n[, "deviceTimeNs": ns]}}`` for the
    families that launched over the query: the delta of the wrappers'
    process-wide counts (so attempts the session discarded count too,
    as the reference's staged launches do); ``deviceTimeNs`` sums the
    final attempt's launch events, under deviceTiming only."""
    out = {}
    for fam in sorted(now):
        n = now[fam] - base.get(fam, 0)
        if n:
            out[fam] = {"launches": n}
            if device_ns is not None:
                out[fam]["deviceTimeNs"] = int(device_ns.get(fam, 0))
    return out


def _tree_of(plan, registry: MetricsRegistry) -> dict:
    return {
        "name": plan.node_name(),
        "describe": plan.describe(),
        "metrics": registry.node_metrics(plan.node_name()),
        "children": [_tree_of(c, registry) for c in plan.children],
    }


def _collect_names(node: dict, out: set) -> None:
    out.add(node["name"])
    for c in node["children"]:
        _collect_names(c, out)


# ---------------------------------------------------------------------------
# Comparison
# ---------------------------------------------------------------------------


def _flatten(node: dict, _path: str, out: Dict[str, dict]) -> None:
    # Keyed by node NAME, not tree position: metrics are shared by
    # node_name() across repeated operators (registry.py), so positional
    # keys would report the same shared accumulator once per duplicate and
    # inflate the regression count.
    out[node["name"]] = node["metrics"]
    for c in node["children"]:
        _flatten(c, _path, out)


def compare_profiles(old: dict, new: dict, threshold: float = 0.20,
                     min_ns: int = 1_000_000) -> List[dict]:
    """Per-operator regression diff of two profile dicts.

    Flags timing metrics (``*Time``/``*Ns``) that grew by more than
    ``threshold`` (default 20%) AND by more than ``min_ns`` (noise floor,
    default 1ms). Returns [{path, metric, old, new, ratio}] sorted by
    severity."""
    o_ops: Dict[str, dict] = {}
    n_ops: Dict[str, dict] = {}
    _flatten(old["tree"], "", o_ops)
    _flatten(new["tree"], "", n_ops)
    o_ops["<extras>"] = {k: v for m in old.get("extras", {}).values()
                         for k, v in m.items()}
    n_ops["<extras>"] = {k: v for m in new.get("extras", {}).values()
                         for k, v in m.items()}
    out: List[dict] = []
    for path, n_metrics in n_ops.items():
        o_metrics = o_ops.get(path)
        if o_metrics is None:
            continue
        for name, nv in n_metrics.items():
            if not (name.endswith("Time") or name.endswith("Ns")):
                continue
            ov = o_metrics.get(name)
            if not isinstance(ov, (int, float)) \
                    or not isinstance(nv, (int, float)) or ov <= 0:
                continue
            if nv - ov > min_ns and nv > ov * (1.0 + threshold):
                out.append({"path": path, "metric": name,
                            "old": ov, "new": nv,
                            "ratio": round(nv / ov, 3)})
    return sorted(out, key=lambda r: -r["ratio"])


def dump_profiles(path: str, profiles: Dict[str, QueryProfile]) -> None:
    """Write a {query name: profile dict} bundle."""
    import json
    data = {name: (p.to_dict() if isinstance(p, QueryProfile) else p)
            for name, p in profiles.items() if p is not None}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1, default=str)
        f.write("\n")


def load_profiles(path: str) -> Dict[str, dict]:
    import json
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if isinstance(data, dict) and "tree" in data:
        return {"query": data}  # a single bare profile
    return data
