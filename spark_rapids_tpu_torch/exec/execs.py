"""Physical operators — port of ``spark_rapids_tpu/exec/execs.py``, cut to
what the TPC-H, TPCxBB and TPC-DS queries run, over a hash exchange or
not: device source, filter, project, expand, hash aggregate (grouped
and global, partial per batch plus merge), shuffled hash join (inner,
left, right and full outer, semi and anti; direct-address modes, the
exact binary-search path and the general multi-key matcher; a residual
condition), union, top-k, sort, limit, and the device-to-host
transition. The nested-loop joins are in
:mod:`.joins`, the shuffle exchange in :mod:`..shuffle.exchange`.

Execution model, the reference's: every operator's ``execute(ctx)``
returns a list of partitions, each an iterable of :class:`ColumnarBatch`
on the device that a consumer reads once, partitions in order (a scan's
partitions are generators, decoded ahead by :mod:`.pipeline`). Narrow
operators (project, filter) map each batch lazily; the
aggregate reduces every batch to partial buffers and merges them; joins,
sort, top-k and limit accumulate their child into one batch first
(:func:`accumulate`, the reference's ``_accumulate_spillable``: each
batch is registered with the session's spill catalog while the child
runs, and the assembly runs under the OOM retry). A plan without an
exchange is one partition of one batch throughout, and
:func:`_coalesce_device` hands a single batch on untouched, so such a
plan does no extra copy.

Memory and robustness (:mod:`..memory`): the join's probe runs under
:func:`..memory.retry.with_retry` and splits in half by rows when
retries alone cannot fit it; a sort above
``spark.rapids.sql.sort.externalThresholdBytes`` takes the external
merge sort (:mod:`.external_sort`).

Optimistic operators (dense joins, the dense aggregate, the single-lane
top-k) take a *site* ordinal from the context, run in the mode the
session learned for that site, and report a device-side ``fail`` flag
into ``ctx.dense_fails``. The session reads all flags once after the run
and re-runs the query with the tripped sites escalated
(:meth:`..session.TorchSession.execute`).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from .. import types as T
from ..config import TorchConf
from ..data.batch import ColumnarBatch, HostBatch, empty_batch
from ..data.column import DeviceColumn, bucket_capacity
from ..metrics.registry import MetricsRegistry
from ..ops import aggregates as AGG
from ..ops import nondeterministic as ND
from ..ops.cast import cast_values
from ..ops.expression import (BoundReference, Expression, Literal,
                              make_column)
from ..ops.kernels import concat as KC
from ..ops.kernels import groupby as KG
from ..ops.kernels import join as KJ
from ..ops.kernels import rowops as KR
from ..ops import strings_util as SU
from ..utils import lockdep
from ..utils.tracing import trace_range


#: A bare context's catalog budget: no batch ever spills under it.
_NO_BUDGET = 1 << 62


class ExecContext:
    """Per-attempt state: the session's conf, the learned dense mode of
    each optimistic site, the fail flags this attempt raised,
    per-operator timings and counters, the query's metrics registry and
    span tracer, and the cleanups the session runs when the attempt
    ends. Timings and counters take a lock: the scan's host work on the
    pipeline's workers adds to them too.

    ``registry`` is this attempt's :class:`~..metrics.registry.
    MetricsRegistry` (``spark.rapids.tpu.metrics.level``; inert at NONE),
    ``trace`` the query's :class:`~..metrics.trace.Tracer` or None, and
    ``kernel_events`` the CUDA event pairs of this attempt's kernel
    launches under ``spark.rapids.tpu.metrics.deviceTiming``
    (:func:`..ops.kernels.cuda.device_timing`).

    The session's memory layer rides along: ``catalog`` (the spill
    catalog, :mod:`..memory.spill`; a bare context gets one of its own
    with no budget, which never spills), ``fault_injector``
    (:mod:`..utils.fault_injection`), ``semaphore``
    (:mod:`..memory.semaphore`), ``deadline`` (:mod:`..utils.deadline`)
    and ``qos`` (the query's :class:`~..memory.spill.QosTag`); the last
    four are None in a bare context.

    Whole-stage fusion (:mod:`.fusion`) adds ``in_fusion`` (True in the
    context a fused region runs in: no catalog registration, no retry,
    injection or deadline, no CUDA event pairs, sync-free operator
    variants), ``fused_inputs`` (the region's materialised boundaries),
    ``join_caps`` / ``join_growth`` (the output capacity of an inlined
    exact join: learned per site, else the probe's capacity times the
    growth) and the region's deferred observations ``overflow_flags``
    and ``join_totals``. Sites are numbered in execution order
    (``site_ids``, beside ``site_kinds``); a boundary materialised
    concurrently numbers its sites in a namespace of its own
    (:meth:`fork_for_boundary`), so the numbers do not depend on thread
    timing."""

    def __init__(self, device: torch.device,
                 dense_modes: Optional[Dict[int, int]] = None,
                 conf: Optional[TorchConf] = None, trace=None,
                 catalog=None, fault_injector=None, semaphore=None,
                 deadline=None, qos=None):
        self.device = device
        self.conf = conf if conf is not None else TorchConf()
        self.dense_modes = dict(dense_modes or {})
        self.dense_fails: List[Tuple[int, torch.Tensor]] = []
        self.site_kinds: List[str] = []
        #: (operator, start, end): CUDA events on the card, host seconds
        #: on the CPU or for host work. Read through :meth:`exec_ms`.
        self._marks: List[tuple] = []
        #: The exchanges' block store, made at the first exchange.
        self.shuffle_catalog = None
        #: name -> count (the scan's rows and decompressed bytes).
        self.counters: Dict[str, int] = {}
        self._lock = lockdep.lock("ExecContext._lock")
        self._cleanups: List[Callable[[], None]] = []
        #: :class:`ReusedExec` -> its partitions, made at its first read.
        self.reused: Dict[int, List[List[ColumnarBatch]]] = {}
        self.registry = MetricsRegistry.for_conf(self.conf)
        self.trace = trace
        self.kernel_events: List[tuple] = []
        if catalog is None:
            from ..memory.spill import BufferCatalog
            catalog = BufferCatalog(_NO_BUDGET, _NO_BUDGET, device=device)
        self.catalog = catalog
        self.fault_injector = fault_injector
        self.semaphore = semaphore
        self.deadline = deadline
        self.qos = qos
        self.in_fusion = False
        self.fused_inputs = None
        #: what the fused dispatch did (:func:`.fusion.fused_collect`)
        self.fusion: Optional[dict] = None
        self.join_caps: Dict[int, int] = {}
        self.join_growth = 1.0
        #: what plan lint found in the plan (``QueryInfo.lint``), set by
        #: the session on the attempt it keeps
        self.plan_lint: Optional[dict] = None
        self.overflow_flags: List[torch.Tensor] = []
        self.join_totals: List[Tuple[int, torch.Tensor]] = []
        #: the id of each site of ``site_kinds``, in the same order
        self.site_ids: List[int] = []
        self._site_seq = 0
        self._site_namespace = 0
        # guards ``reused`` across concurrently materialised boundaries;
        # held while a shared subplan runs, its pipeline waits included
        self._reuse_lock = lockdep.rlock("ExecContext._reuse_lock",
                                         io_ok=True)

    def next_site(self, kind: str) -> int:
        # under the lock: the overlapped download runs a device plan's
        # operators on a prefetch worker while this context is shared
        with self._lock:
            sid = self._site_namespace + self._site_seq
            self._site_seq += 1
            self.site_kinds.append(kind)
            self.site_ids.append(sid)
        return sid

    def _fork(self) -> "ExecContext":
        """A copy sharing the conf, registry, catalog, timers, counters,
        modes and shared subplans, with private observation lists."""
        sub = copy.copy(self)
        sub.dense_fails = []
        sub.site_kinds = []
        sub.site_ids = []
        sub.overflow_flags = []
        sub.join_totals = []
        sub._cleanups = []
        return sub

    def fork_for_boundary(self, ordinal: int) -> "ExecContext":
        """A context for one boundary materialised on a pool thread
        (:func:`.pipeline.materialize_boundaries`): private observation
        lists, merged back in boundary order by :meth:`absorb_boundary`,
        and the site namespace ``(ordinal + 1) << 20``, which the plan
        fixes, so learned modes key the same sites on every run."""
        sub = self._fork()
        sub._site_seq = 0
        sub._site_namespace = (ordinal + 1) << 20
        return sub

    def fork_for_region(self) -> "ExecContext":
        """The context a fused region runs in (the reference's fused
        ``ExecContext``): ``in_fusion``, no fault injector, deadline or
        semaphore, its sites continuing this context's numbering."""
        sub = self._fork()
        sub.in_fusion = True
        sub.fault_injector = None
        sub.deadline = None
        sub.semaphore = None
        return sub

    def absorb_boundary(self, sub: "ExecContext") -> None:
        """Merge a fork's observations back (in boundary order, after
        every worker finished)."""
        self.dense_fails.extend(sub.dense_fails)
        self.site_kinds.extend(sub.site_kinds)
        self.site_ids.extend(sub.site_ids)
        self.overflow_flags.extend(sub.overflow_flags)
        self.join_totals.extend(sub.join_totals)
        with self._lock:
            self._cleanups.extend(sub._cleanups)
        sub._cleanups = []

    def mode(self, site: int) -> int:
        return self.dense_modes.get(site, 0)

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to the counter ``name``."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def metric(self, node: str, name: str, value) -> None:
        """Record ``value`` into metric ``name`` of ``node`` (a no-op when
        the level gates it). ``value`` must already be on the host."""
        self.registry.add(node, name, value)

    def host_interval(self, name: str, t0: float, t1: float,
                      metric: Optional[str] = "opTime") -> None:
        """Add the host-clock interval ``[t0, t1]`` (seconds) to ``name``'s
        time, and to ``metric`` of the node ``name`` starts with."""
        with self._lock:
            self._marks.append((name, t0, t1))
        if metric is not None:
            self.registry.add(name.split(".", 1)[0], metric,
                              int((t1 - t0) * 1e9))

    def add_cleanup(self, fn: Callable[[], None]) -> None:
        """Have :meth:`run_cleanups` call ``fn`` when the attempt ends."""
        with self._lock:
            self._cleanups.append(fn)

    def run_cleanups(self) -> None:
        """Call the registered cleanups once each, newest first (the
        scan's look-ahead cancels what it has not started)."""
        with self._lock:
            fns, self._cleanups = self._cleanups[::-1], []
        for fn in fns:
            fn()

    def report(self, site: int, fail) -> None:
        """Record an optimistic site's device-side fail flag."""
        if fail is not None and fail is not False:
            self.dense_fails.append((site, fail))

    @contextlib.contextmanager
    def timed(self, name: str, host: bool = False, metric: str = "opTime"):
        """Time an operator's own work (its children run before this),
        labelled for ``torch.profiler`` (and NVTX on the card); ``host``
        times host work (the exchange's serialization) on the host clock.
        Times of one name add up across batches. The host wall time also
        goes to ``metric`` (``opTime`` unless named) of the node ``name``
        starts with (``HashAggregateExec.merge`` -> ``HashAggregateExec``);
        the CUDA events become its ``deviceTime`` at query end
        (:meth:`record_device_time`, under deviceTiming only)."""
        t_ns = time.perf_counter_ns()
        try:
            with trace_range(name):
                if self.in_fusion and self.device.type == "cuda":
                    # a capture cannot read events, and a replay runs no
                    # Python: the region's one event pair is the fused
                    # dispatch's deviceTime
                    yield
                elif self.device.type == "cuda" and not host:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    yield
                    end.record()
                    with self._lock:
                        self._marks.append((name, start, end))
                else:
                    t0 = time.perf_counter()
                    yield
                    self.host_interval(name, t0, time.perf_counter(), None)
        finally:
            self.registry.add(name.split(".", 1)[0], metric,
                              time.perf_counter_ns() - t_ns)

    def exec_ms(self) -> Dict[str, float]:
        """Milliseconds per operator (summed by name); synchronises."""
        out: Dict[str, float] = {}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        with self._lock:
            marks = list(self._marks)
        for name, a, b in marks:
            ms = a.elapsed_time(b) if isinstance(a, torch.cuda.Event) \
                else (b - a) * 1e3
            out[name] = out.get(name, 0.0) + ms
        return out

    def record_device_time(self) -> None:
        """Each exec's ``deviceTime`` from its CUDA event pairs, under
        ``spark.rapids.tpu.metrics.deviceTiming`` only. Call after
        :meth:`exec_ms`, whose synchronisation completed the events."""
        if not self.registry.device_timing:
            return
        with self._lock:
            marks = [m for m in self._marks
                     if isinstance(m[1], torch.cuda.Event)]
        for name, a, b in marks:
            self.registry.add(name.split(".", 1)[0], "deviceTime",
                              int(a.elapsed_time(b) * 1e6))


def _bind_all(exprs: List[Expression], schema: T.Schema) -> List[Expression]:
    return [e.bind(schema) for e in exprs]


class TorchExec:
    children: List["TorchExec"] = []
    #: True for a device exec (its partitions yield ColumnarBatch), False
    #: for a CPU operator (:mod:`..plan.physical`, HostBatch): Spark's
    #: ``supportsColumnar``, which the transitions follow.
    columnar = True

    @property
    def schema(self) -> T.Schema:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__

    def node_name(self) -> str:
        """The metrics registry's key for this exec: its type's name, so
        repeated execs of one type share accumulators (the reference's
        convention)."""
        return self.name

    def describe(self) -> str:
        return self.name

    #: Batch goals of the children (``"target"`` or ``"single"`` per
    #: child, :func:`.coalesce.insert_coalesce`), or None.
    children_coalesce_goals: Optional[List[Optional[str]]] = None

    def with_children(self, children: List["TorchExec"]) -> "TorchExec":
        """A shallow copy of this exec over ``children``."""
        out = copy.copy(self)
        out.children = list(children)
        return out

    def tree_string(self, indent: int = 0) -> str:
        out = "  " * indent + self.describe() + "\n"
        for c in self.children:
            out += c.tree_string(indent + 1)
        return out

    def execute(self, ctx: ExecContext) -> List[Iterable[ColumnarBatch]]:
        """The output partitions, each an iterable of device batches, to
        be read once, in order."""
        raise NotImplementedError


def _coalesce_device(batches: List[ColumnarBatch]) -> ColumnarBatch:
    """Concatenate device batches at the ladder rung of the sum of their
    capacities (a bound on the live rows that needs no host sync). A
    single batch comes back untouched, lazy or not."""
    if len(batches) == 1:
        return batches[0]
    cap = bucket_capacity(max(sum(b.capacity for b in batches), 1))
    return KC.concat_batches(batches, cap)


def accumulate(child: TorchExec, ctx: ExecContext,
               node: str = "Coalesce", site: str = "assemble"
               ) -> ColumnarBatch:
    """All of a child's batches as one (an empty batch of its schema when
    it has none): the input of joins, sort, top-k and limit, the
    reference's ``_accumulate_spillable``. Each batch is registered with
    the spill catalog as it arrives, so memory pressure can push earlier
    ones to host or disk, and the assembly (restore and concat,
    :func:`_pinned_concat`) runs under the OOM retry at site
    ``<node>.<site>`` without a split (its consumer takes ONE batch). A
    single batch that never spilled comes back as it is. A
    concatenation's time is ``node``'s ``concatTime`` (DEBUG)."""
    if ctx.in_fusion:
        # a fused region has no catalog and no retry (the reference's
        # fused context has neither)
        batches = [b for part in child.execute(ctx) for b in part]
        if not batches:
            return empty_batch(child.schema, ctx.device)
        return _coalesce_device(batches)
    catalog = ctx.catalog
    from ..memory import retry as R
    ids: List[int] = []
    try:
        _register_all(child, ctx, catalog, ids)
        if not ids:
            return empty_batch(child.schema, ctx.device)
        return R.with_retry(
            ctx, f"{node}.{site}", ids,
            lambda id_list: _pinned_concat(catalog, id_list, ctx, node),
            node=node)[0]
    finally:
        # freed even when the child raises mid-stream: a leaked entry
        # would shrink the session's budget
        for b in ids:
            catalog.free(b)


def _register_all(child: TorchExec, ctx: ExecContext, catalog,
                  ids: List[int]) -> int:
    """Register every batch of ``child`` with the catalog (their ids
    appended to ``ids``, so a failure mid-stream still frees them);
    returns their device bytes. The child's generators end here, so no
    frame keeps a batch alive past its spill."""
    from ..memory import spill as SP
    total = 0
    for part in child.execute(ctx):
        for b in part:
            size = SP.device_size_bytes(b)
            ids.append(catalog.register_batch(
                b, SP.ACTIVE_BATCHING_PRIORITY, owner=ctx.qos, size=size))
            total += size
    return total


def _pinned_concat(catalog, ids, ctx: ExecContext, node: str
                   ) -> ColumnarBatch:
    """Restore and concatenate catalog buffers, each pinned first so
    restoring one cannot spill another of the set; unpinned in a
    ``finally``, so a failed attempt leaves them spillable for the
    retry's drain."""
    for b in ids:
        catalog.pin(b)
    try:
        batches = [catalog.acquire_batch(b) for b in ids]
        if len(batches) == 1:
            return batches[0]
        with ctx.registry.timer(node, "concatTime"):
            return _coalesce_device(batches)
    finally:
        for b in ids:
            catalog.unpin(b)


class DeviceSourceExec(TorchExec):
    """A device-resident table (``create_dataframe`` uploaded it)."""

    def __init__(self, batch: ColumnarBatch):
        self.children = []
        self.batch = batch

    @property
    def schema(self):
        return self.batch.schema

    def describe(self):
        return f"DeviceSource [{', '.join(self.schema.names)}] " \
               f"cap={self.batch.capacity}"

    def execute(self, ctx):
        return [[self.batch]]


class ReusedExec(TorchExec):
    """A subplan that the query references more than once: it runs at
    its first read in an attempt, and every read gets its batches (the
    planner puts one of these where a logical node has several
    parents)."""

    def __init__(self, child: TorchExec):
        self.children = [child]

    @property
    def columnar(self):
        # on the side of what it shares: a host subplan's batches are
        # kept as host batches
        return self.children[0].columnar

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return "Reused"

    def execute(self, ctx):
        with ctx._reuse_lock:
            parts = ctx.reused.get(id(self))
            if parts is None:
                parts = [list(p) for p in self.children[0].execute(ctx)]
                ctx.reused[id(self)] = parts
        return [list(p) for p in parts]


class UnionExec(TorchExec):
    """``UNION ALL``: every child's partitions in turn, their batches
    relabelled to the union's schema (the reference's
    ``TpuUnionExec``). A consumer that accumulates them concatenates
    their dictionaries (:mod:`..ops.kernels.concat`)."""

    def __init__(self, children: List[TorchExec], schema: T.Schema):
        self.children = list(children)
        self._schema = schema

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return "Union"

    def execute(self, ctx):
        def relabel(part):
            for b in part:
                ctx.metric(self.name, "numOutputBatches", 1)
                yield ColumnarBatch(b.columns, b.n_rows, self._schema,
                                    live=b.live)
        return [relabel(p) for c in self.children for p in c.execute(ctx)]


class ProjectExec(TorchExec):
    def __init__(self, child: TorchExec, exprs: List[Expression]):
        self.children = [child]
        self.exprs = exprs

    @property
    def schema(self):
        return T.Schema([T.StructField(e.name, e.data_type, e.nullable)
                         for e in self.exprs])

    def describe(self):
        return "Project [" + ", ".join(str(e) for e in self.exprs) + "]"

    def execute(self, ctx):
        parts = self.children[0].execute(ctx)
        bound = _bind_all(self.exprs, self.children[0].schema)
        if any(ND.has_nondeterministic(e) for e in bound):
            return [self._numbered(ctx, bound, part, pid)
                    for pid, part in enumerate(parts)]

        def project(batch):
            with ctx.timed(self.name):
                cols = [e.eval_device(batch) for e in bound]
                out = batch.with_columns(cols, self.schema)
            ctx.metric(self.name, "numOutputBatches", 1)
            return out
        return [(project(b) for b in part) for part in parts]

    def _numbered(self, ctx, bound, part, pid: int):
        """The nondeterministic route (the reference's ``project_nd``):
        each batch made physical first, so positional expressions number
        its logical rows, and evaluated with the partition's index and
        the rows before it in the partition (a device count, no sync)."""
        row_base = torch.zeros((), dtype=torch.int64, device=ctx.device)
        for batch in part:
            with ctx.timed(self.name):
                batch = KR.physical(batch)
                with ND.eval_context(pid, row_base):
                    cols = [e.eval_device(batch) for e in bound]
                out = batch.with_columns(cols, self.schema)
                row_base = row_base + batch.n_rows
            ctx.metric(self.name, "numOutputBatches", 1)
            yield out


class ExpandExec(TorchExec):
    """Every input batch once per projection (rollup, cube and grouping
    sets; the reference's ``TpuExpandExec``): one output batch each, in
    projection order, lazy as its input. A projected column whose type
    differs from its field's is cast to the field's type. A null string
    literal (a grouping set's absent key) takes the dictionary of the
    same field in another projection, so the batches' key columns share
    one dictionary and the aggregate above merges them by codes
    (:mod:`..ops.kernels.concat`)."""

    def __init__(self, child: TorchExec, projections, schema: T.Schema):
        self.children = [child]
        self.projections = projections
        self._schema = schema

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return f"Expand [{len(self.projections)} projections]"

    def execute(self, ctx):
        parts = self.children[0].execute(ctx)
        bound = [_bind_all(p, self.children[0].schema)
                 for p in self.projections]

        def expand(batch):
            with ctx.timed(self.name):
                outs = []
                for proj in bound:
                    cols = []
                    for e, f in zip(proj, self._schema):
                        c = e.eval_device(batch)
                        if c.dtype.name != f.data_type.name:
                            c = make_column(cast_values(c.data, c.dtype,
                                                        f.data_type),
                                            c.validity, f.data_type)
                        cols.append(c)
                    outs.append(cols)
                for i in range(len(self._schema)):
                    real = next((o[i] for p, o in zip(bound, outs)
                                 if o[i].is_dict and not _null_literal(p[i])),
                                None)
                    for p, o in zip(bound, outs):
                        if real is not None and _null_literal(p[i]):
                            o[i] = real.replace_rows(
                                torch.zeros_like(real.validity),
                                torch.zeros_like(real.codes))
            ctx.metric(self.name, "numOutputBatches", len(outs))
            return [batch.with_columns(o, self._schema) for o in outs]
        return [(b for batch in part for b in expand(batch))
                for part in parts]


class GenerateExec(TorchExec):
    """``explode`` / ``posexplode`` and their ``_outer`` forms over the
    padded array layout (the reference's ``TpuGenerateExec``): the
    ``[rows, max_len]`` element matrix flattens to ``rows x max_len``
    output lanes, one gather repeats every parent column by lane (``row =
    lane // max_len``), and the output is compacted on the lanes that hold
    an element (plus, ``outer``, the first lane of a null or empty
    array's row, whose element is null). Output columns: the child's, then
    ``pos`` (``pos``), then the element.

    At most :attr:`TILE_LANES` output lanes an invocation: a batch whose
    ``capacity x max_len`` is larger explodes in tiles of rows, each its
    own output batch, the loop bounded by the live rows (one host read).
    A flat string parent's payload is sized from its longest gathered
    row (``lanes x`` that length rounded up to 8 bytes), not from ``lanes
    x max_bytes``, whose floor is 128."""

    #: Output lanes bound per invocation (the reference's).
    TILE_LANES = 1 << 22

    def __init__(self, child: TorchExec, generator: Expression,
                 outer: bool, pos: bool, schema: T.Schema):
        self.children = [child]
        self.generator = generator
        self.outer = outer
        self.pos = pos
        self._schema = schema

    @property
    def schema(self):
        return self._schema

    def describe(self):
        kind = "posexplode" if self.pos else "explode"
        return f"Generate [{kind}{'_outer' if self.outer else ''}" \
               f"({self.generator})]"

    def _explode(self, db: ColumnarBatch, arr: DeviceColumn, offset: int,
                 tile_rows: int) -> ColumnarBatch:
        """Rows ``[offset, offset + tile_rows)`` of ``db`` exploded."""
        cap, w = arr.data.shape
        dev = db.device
        lane = torch.arange(tile_rows * w, device=dev)
        flat_r = offset + torch.div(lane, w, rounding_mode="floor")
        flat_j = lane % w
        live = flat_r < db.n_rows
        src = flat_r.clamp(max=cap - 1)
        lens = arr.lengths[src]
        keep_elem = live & (flat_j < lens)
        keep = keep_elem
        if self.outer:
            keep = keep | (live & (flat_j == 0)
                           & (~arr.validity[src] | (lens == 0)))
        cols = list(KR.gather_columns(db.columns, src, keep, sized=True))
        if self.pos:
            cols.append(make_column(flat_j, keep_elem, T.INT))
        rows = slice(offset, offset + tile_rows)
        elem_dt = self._schema[len(self._schema) - 1].data_type
        data = arr.data[rows].reshape(-1)
        ev = arr.elem_validity[rows].reshape(-1)
        if data.shape[0] < lane.shape[0]:  # a tile past the capacity
            pad = lane.shape[0] - data.shape[0]
            data = torch.cat([data, data.new_zeros(pad)])
            ev = torch.cat([ev, ev.new_zeros(pad)])
        cols.append(make_column(data, ev & keep_elem, elem_dt))
        return ColumnarBatch(tuple(cols), keep.sum(), self._schema,
                             live=keep)

    def execute(self, ctx):
        parts = self.children[0].execute(ctx)
        bound = self.generator.bind(self.children[0].schema)

        def run(part):
            for db in part:
                with ctx.timed(self.name):
                    # explode liveness is positional (lane row < n_rows)
                    db = KR.physical(db)
                    arr = bound.eval_device(db)
                    cap, w = arr.data.shape
                    tile_rows = cap if cap * w <= self.TILE_LANES else \
                        bucket_capacity(max(self.TILE_LANES // w, 128))
                    live_rows = cap if tile_rows == cap else \
                        max(int(db.n_rows), 1)
                for off in range(0, live_rows, tile_rows):
                    with ctx.timed(self.name):
                        out = self._explode(db, arr, off, tile_rows)
                    ctx.metric(self.name, "numOutputBatches", 1)
                    yield out
        return [run(p) for p in parts]


def _null_literal(e: Expression) -> bool:
    return isinstance(e, Literal) and e.value is None


class FilterExec(TorchExec):
    """Lazy filter: the kept rows become the batch's ``live`` mask."""

    def __init__(self, child: TorchExec, condition: Expression):
        self.children = [child]
        self.condition = condition

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return f"Filter ({self.condition})"

    def execute(self, ctx):
        parts = self.children[0].execute(ctx)
        cond = self.condition.bind(self.schema)

        def keep(batch):
            with ctx.timed(self.name):
                m = cond.eval_device(batch)
                out = KR.compact(batch, m.data & m.validity)
            ctx.metric(self.name, "numOutputBatches", 1)
            return out
        return [(keep(b) for b in part) for part in parts]


class HashAggregateExec(TorchExec):
    """Grouped aggregation, the reference's partial/merge stack: every
    input batch is reduced to partial buffers (update mode), partials
    merge (merge mode, over their concatenation) when the newer one has
    caught up with the older in capacity, the rest merge at the end, and
    the final projection evaluates the buffers. One input batch is one
    partial and no merge. A sparse input to a grouped aggregation is
    compacted first (:func:`..ops.kernels.rowops.shrink_sparse`). The
    dense grouping path is optimistic: the fail flags of every partial
    and merge report under this one site, which escalates to the sort
    path. A partial whose groups fill at most a quarter of its capacity
    is cut to their ladder rung before it merges. Without grouping keys
    it is the global aggregate: one output row, also for no input."""

    def __init__(self, child: TorchExec, groupings: List[Expression],
                 aggregates: List[AGG.AggregateExpression]):
        self.children = [child]
        self.groupings = groupings
        self.aggregates = aggregates
        self.children_coalesce_goals = ["target"]

    @property
    def schema(self):
        fields = [T.StructField(g.name, g.data_type, g.nullable)
                  for g in self.groupings]
        fields += [T.StructField(a.name, a.func.data_type, a.func.nullable)
                   for a in self.aggregates]
        return T.Schema(fields)

    def describe(self):
        return ("HashAggregate [" + ", ".join(g.name for g in self.groupings)
                + "] [" + ", ".join(a.name for a in self.aggregates) + "]")

    def _buffer_schema(self) -> T.Schema:
        fields = [T.StructField(g.name, g.data_type, g.nullable)
                  for g in self.groupings]
        for i, a in enumerate(self.aggregates):
            for spec in a.func.buffers():
                fields.append(T.StructField(f"_buf{i}_{spec.suffix}",
                                            spec.dtype, True))
        return T.Schema(fields)

    def bind(self):
        """``(groupings, aggregates, buffer schema, key refs)`` bound to
        the child's schema; the key refs read the grouping keys of a
        buffer batch (merge mode)."""
        child_schema = self.children[0].schema
        groupings = _bind_all(self.groupings, child_schema)
        aggs = [AGG.AggregateExpression(a.func.bind(child_schema), a.name)
                for a in self.aggregates]
        buf_schema = self._buffer_schema()
        key_refs = [BoundReference(i, f.data_type, f.nullable)
                    for i, f in enumerate(buf_schema)][:len(groupings)]
        return groupings, aggs, buf_schema, key_refs

    def execute(self, ctx):
        parts = self.children[0].execute(ctx)
        site = ctx.next_site("aggregate")
        child_schema = self.children[0].schema
        groupings, aggs, buf_schema, key_refs = self.bind()
        n_keys = len(groupings)
        dense_mode = min(ctx.mode(site), 1)

        def partial(batch):
            # The grouping sort and every reduction cost the input's
            # capacity: a sparse lazy input (a filtered join output) moves
            # to its live bucket first. The global aggregate's masked
            # reductions need not.
            if self.groupings and not ctx.in_fusion:
                # (a fused region cannot read the live count: its input
                # stays lazy at its capacity, every operator reading the
                # row mask; the reference compacts it, physical(), at its
                # execs.py:625, which here would gather every column)
                batch = KR.shrink_sparse(batch)
            with ctx.timed(self.name):
                out, fail = aggregate_batch(batch, groupings, aggs,
                                            buf_schema, n_keys, True,
                                            dense_mode)
            ctx.report(site, fail)
            return out

        def merge(batches):
            # a partial holds its groups at the front of its input's
            # capacity: concatenating whole capacities would size the
            # merge (and a flat string key's char matrix) by the input
            batch = _coalesce_device(
                batches if ctx.in_fusion else
                [KR.shrink_sparse(b, physical=True) for b in batches])
            with ctx.timed(self.name + ".merge"):
                out, fail = aggregate_batch(batch, key_refs, aggs,
                                            buf_schema, n_keys, False,
                                            dense_mode)
            ctx.report(site, fail)
            return out

        # Merge two partials only when the newer has caught up with the
        # older in capacity: concatenation sizes by the capacities' sum,
        # so a running accumulator would re-group the whole state per
        # batch; the stack keeps the merge work O(N log N).
        stack: List[ColumnarBatch] = []
        for part in parts:
            for b in part:
                stack.append(partial(b))
                while len(stack) >= 2 and \
                        stack[-1].capacity >= stack[-2].capacity:
                    b2, b1 = stack.pop(), stack.pop()
                    stack.append(merge([b1, b2]))
        if not stack:  # no input batch: group an empty one
            stack.append(partial(empty_batch(child_schema, ctx.device)))
        state = stack.pop()
        while stack:
            state = merge([stack.pop(), state])
        with ctx.timed(self.name):
            out = self.finalize(state)
        ctx.metric(self.name, "numOutputBatches", 1)
        return [[out]]

    def finalize(self, b: ColumnarBatch) -> ColumnarBatch:
        """The aggregate's output from a buffer batch: the keys, then each
        aggregate's result expression over its buffers."""
        n_keys = len(self.groupings)
        cols = list(b.columns[:n_keys])
        bi = n_keys
        for a in self.aggregates:
            specs = a.func.buffers()
            refs = [BoundReference(bi + j, s.dtype, True)
                    for j, s in enumerate(specs)]
            bi += len(specs)
            cols.append(a.func.evaluate(refs).eval_device(b))
        return ColumnarBatch(tuple(cols), b.n_rows, self.schema, live=b.live)


def aggregate_batch(batch: ColumnarBatch, key_exprs: List[Expression],
                    aggs: List[AGG.AggregateExpression], buf_schema: T.Schema,
                    n_keys: int, update_mode: bool = True,
                    dense_mode: int = 1):
    """One grouping pass (``_aggregate_batch`` of the reference). Update
    mode: the inputs are rows; each aggregate's child is evaluated and
    reduced per group by its buffers' ``update_op``. Merge mode: the
    inputs are buffer batches (keys first, then the buffers in
    ``buf_schema`` order) and each buffer reduces by its ``merge_op``.
    Returns ``(buffer batch, fail)``; ``fail`` is ``None`` on the
    always-exact paths."""
    capacity = batch.capacity
    dev = batch.device
    live = batch.row_mask()
    keys = [e.eval_device(batch) for e in key_exprs]
    inputs = []
    decoders = {}  # input index -> the string column of its result lane
    bi = n_keys
    for a in aggs:
        specs = a.func.buffers()
        for j, spec in enumerate(specs):
            if not update_mode:
                c = batch.columns[bi + j]
                values, validity, op = c.data, c.validity, spec.merge_op
            elif a.func.child is None:  # count(*)
                values = torch.ones(capacity, dtype=torch.int64, device=dev)
                validity = torch.ones(capacity, dtype=torch.bool, device=dev)
                op = spec.update_op
            else:
                c = a.func.child.eval_device(batch)
                validity, op = c.validity, spec.update_op
                if op == "count":
                    # a count reads the child's validity alone: a
                    # dictionary string has no data lane, a flat one a
                    # byte payload
                    values = torch.ones(capacity, dtype=torch.int64,
                                        device=dev)
                elif spec.dtype is not T.STRING:
                    if c.is_string:
                        raise NotImplementedError(
                            f"{type(a.func).__name__} of a string column")
                    values = c.data.to(spec.dtype.torch_dtype)
            if spec.dtype is T.STRING:
                values, decode = string_agg_lane(c, op)
                decoders[len(inputs)] = decode
            inputs.append((values, validity, op, spec))
        bi += len(specs)
    triples = [(v, val, op) for v, val, op, _ in inputs]
    if keys:
        key_cols, results, n_groups, group_live, fail = \
            KG.grouped_aggregate(keys, live, triples, dense_mode=dense_mode)
    else:
        key_cols, results, n_groups, group_live = KG.global_aggregate(
            capacity, live, triples)
        fail = False
    out_cols = list(key_cols)
    for i, ((_, _, op, spec), (result, counts)) in enumerate(
            zip(inputs, results)):
        if spec.from_count:
            data = counts if op == "count" else result
            validity_out = group_live
        else:
            data = result
            validity_out = (counts > 0) & group_live
        if i in decoders:
            out_cols.append(decoders[i](data, validity_out))
        else:
            out_cols.append(make_column(data, validity_out, spec.dtype))
    return ColumnarBatch(tuple(out_cols), n_groups, buf_schema), \
        (None if fail is False else fail)


def string_agg_lane(c: DeviceColumn, op: str):
    """A string column as the int64 lane a min, max, first or last
    reduces, and ``decode(lane values, validity)``, which turns the
    reduced lane back into a string column of the group rows. ``min`` /
    ``max`` reduce a sorted dictionary's codes (the dictionary sorted
    first when it is not) or a flat column's byte-order ranks
    (:func:`..ops.strings_util.string_ranks`), each rank decoding to a
    row that holds its string; ``first`` / ``last`` reduce a dictionary's
    codes or a flat column's row numbers."""
    if c.is_dict:
        if op in ("min", "max") and not c.dict_sorted:
            c = KR.sorted_dictionary(c)

        def decode_codes(lane, validity):
            codes = torch.where(validity, lane, 0).to(torch.int32)
            return dataclasses.replace(c, codes=codes, validity=validity)
        return c.codes.long(), decode_codes
    rows = torch.arange(c.capacity, device=c.device)
    if op in ("min", "max"):
        rank = SU.string_ranks(c)
        # a valid row of each rank (a null row ranks as the empty string)
        row_of_rank = torch.zeros(c.capacity + 1, dtype=rows.dtype,
                                  device=c.device)
        row_of_rank.scatter_(0, torch.where(c.validity, rank, c.capacity),
                             rows)
    else:
        rank, row_of_rank = rows, rows

    def decode_rows(lane, validity):
        at = row_of_rank[lane.long().clamp(0, c.capacity - 1)]
        return KR.gather_column(c, at, validity)
    return rank, decode_rows


class ShuffledHashJoinExec(TorchExec):
    """Equi join (inner, left, right or full outer, left_semi or
    left_anti), left = probe, right = build. A single integer key tries
    the direct-address table first (mode 1: table over the build side;
    mode 2, inner joins only: over the probe side), each escalated by its
    fail flag; mode 3, and every other key set, takes the exact path
    (:func:`join_exact`). Semi and anti joins keep the probe's columns and
    mark its kept rows live; a left join keeps every probe row, with a
    null build side where it found no match. A right join is the left
    join with the sides swapped, its columns swapped back. A full join
    takes the general matcher, which also marks the build rows that
    matched (:func:`join_full`): the left join's rows, then, as a batch
    of their own, the unmatched build rows in build order with a null
    probe side.

    A residual ``condition`` (the join's non-equi terms, over the probe's
    then the build's columns) must also hold for a pair to match. An
    inner join filters its output by it, from the build-table mode or
    the exact path; every other type takes :func:`join_residual`, which
    evaluates it on the expanded pairs during matching. The pair count
    adds to the ``<name>.pairs`` counter; an inner join on the exact path
    adds its pairs to ``<name>.equi_pairs`` (read on the host to size
    the output, so counting costs no sync)."""

    def __init__(self, left: TorchExec, right: TorchExec, join_type: str,
                 left_keys: List[Expression], right_keys: List[Expression],
                 schema: T.Schema, condition: Optional[Expression] = None):
        self.children = [left, right]
        self.join_type = join_type
        self.left_keys = left_keys
        self.right_keys = right_keys
        self._schema = schema
        self.condition = condition

    @property
    def schema(self):
        return self._schema

    def describe(self):
        keys = ", ".join(f"{l}={r}" for l, r in
                         zip(self.left_keys, self.right_keys))
        cond = "" if self.condition is None else f" ({self.condition})"
        return f"ShuffledHashJoin {self.join_type} [{keys}]{cond}"

    def execute(self, ctx):
        left, right = self.children
        if self.join_type == "right":
            return self._mirrored_left(ctx)
        probe = accumulate(left, ctx, self.name, "streamed")
        with ctx.registry.timer(self.name, "buildTime"):
            build = accumulate(right, ctx, self.name)
        site = ctx.next_site("join")
        lkeys = _bind_all(self.left_keys, left.schema)
        rkeys = _bind_all(self.right_keys, right.schema)
        jt = self.join_type
        cond = None
        if self.condition is not None:
            cond = self.condition.bind(
                T.Schema(list(left.schema) + list(right.schema)))
        mode = 1 + ctx.mode(site)
        if cond is not None and jt != "inner":
            mode = 3  # the residual applies during matching
        elif mode == 2 and (jt != "inner" or cond is not None):
            # the swapped table exists for inner joins only, and its
            # build-order output would reorder a residual join's rows
            mode = 3

        def join_one(p: ColumnarBatch) -> List[ColumnarBatch]:
            with ctx.timed(self.name):
                return self._join(ctx, p, build, lkeys, rkeys, cond, mode,
                                  site)

        from ..memory import retry as R
        if ctx.in_fusion:
            outs = [join_one(probe)]
        else:
            # The probe splits in half by rows when retries alone cannot
            # fit it: each half joins the same build side, in probe
            # order. A full join's unmatched build rows need the whole
            # probe, so it only retries.
            outs = R.with_retry(
                ctx, f"{self.name}.probe", probe, join_one,
                split=None if jt == "full" else R.halve_by_rows,
                node=self.name)
        return [[b for out in outs for b in out]]

    def _join(self, ctx, probe, build, lkeys, rkeys, cond, mode: int,
              site: int) -> List[ColumnarBatch]:
        """One probe batch against the build side: the output batches."""
        jt = self.join_type
        pk = [e.eval_device(probe) for e in lkeys]
        bk = [e.eval_device(build) for e in rkeys]
        if jt == "full":
            out = join_full(probe, build, pk, bk, self._schema)
            ctx.metric(self.name, "numOutputBatches", len(out))
            return list(out)
        ctx.metric(self.name, "numOutputBatches", 1)
        if KJ.dense_joinable(jt, rkeys) and mode <= 2:
            if mode == 1:
                out, fail = KJ.dense_join(probe, build, pk[0], bk[0],
                                          self._schema, jt)
            else:
                out, fail = KJ.dense_join_swapped(probe, build, pk[0],
                                                  bk[0], self._schema)
            ctx.report(site, fail)
            return [_post_filter(out, cond)]
        if cond is not None:
            out, n_pairs = join_residual(jt, probe, build, pk, bk,
                                         self._schema, cond)
            ctx.count(self.name + ".pairs", n_pairs)
            return [out]
        if ctx.in_fusion and jt in ("inner", "left"):
            # sized without a host read: the learned capacity of this
            # site, else the probe's capacity times the growth; the
            # total and its overflow ride the fused head, and an
            # overflow re-runs the query with the learned capacity
            out_cap = ctx.join_caps.get(site) or bucket_capacity(
                max(int(probe.capacity * ctx.join_growth), 128))
            out, total = join_exact(jt, probe, build, pk, bk, self._schema,
                                    out_cap)
            ctx.overflow_flags.append(total > out_cap)
            ctx.join_totals.append((site, total))
            return [out]
        out, total = join_exact(jt, probe, build, pk, bk, self._schema)
        if jt == "inner":
            ctx.count(self.name + ".equi_pairs", total)
        return [out]

    def _mirrored_left(self, ctx):
        """A right join: the left join of the build side against the
        probe side, its columns swapped back into this join's order."""
        left, right = self.children
        n_left, n_right = len(left.schema), len(right.schema)
        fields = list(self._schema)
        mirror = ShuffledHashJoinExec(
            right, left, "left", self.right_keys, self.left_keys,
            T.Schema(fields[n_left:] + fields[:n_left]), self.condition)

        def reorder(part):
            for b in part:
                yield ColumnarBatch(b.columns[n_right:] + b.columns[:n_right],
                                    b.n_rows, self._schema, live=b.live)
        return [reorder(p) for p in mirror.execute(ctx)]


def _post_filter(batch: ColumnarBatch, cond: Optional[Expression]
                 ) -> ColumnarBatch:
    """An inner join's output kept where the residual holds (lazy; the
    reference's ``join_post_filter``)."""
    if cond is None:
        return batch
    m = cond.eval_device(batch)
    return KR.compact(batch, m.data & m.validity)


def join_exact(join_type: str, probe: ColumnarBatch, build: ColumnarBatch,
               pk, bk, out_schema: T.Schema, out_cap: Optional[int] = None):
    """The exact local equi join (the reference's ``hash_join_kernel``
    without a dense mode): match ranges from the build-side binary search
    (one integer key) or the general matcher (several keys, string or
    float keys), then expand them into output rows (inner; left, where an
    unmatched live probe row emits one row with a null build side), or
    keep the matched or unmatched probe rows live (semi, anti). Returns
    ``(batch, total)``. An inner or left join's output holds ``out_cap``
    rows, or, with no ``out_cap``, the ladder rung of the exact total,
    read on the host (one sync); ``total`` is the output row count: that
    host count when no ``out_cap`` was given, else on the device, where it
    may exceed ``out_cap`` (the caller re-runs bigger); None for semi and
    anti joins."""
    live_p = probe.row_mask()
    lo, counts, build_at_rank = _match_ranges(probe, build, pk, bk)
    if join_type in ("left_semi", "left_anti"):
        keep = counts > 0 if join_type == "left_semi" \
            else live_p & (counts == 0)
        return ColumnarBatch(probe.columns, keep.sum(), out_schema,
                             live=keep), None
    return _expand_pairs(join_type, probe, build, lo, counts, build_at_rank,
                         out_schema, out_cap)


def _expand_pairs(join_type: str, probe: ColumnarBatch, build: ColumnarBatch,
                  lo, counts, build_at_rank, out_schema: T.Schema,
                  out_cap: Optional[int]):
    """An inner, left or full join's matched pairs in probe order, each
    probe row's matches in build rank order; a left or full join's
    unmatched live probe row once, with a null build side. Returns
    ``(batch, total)`` as :func:`join_exact` does."""
    matched = counts > 0
    if join_type in ("left", "full"):
        counts = KJ.left_outer_counts(counts, probe.row_mask())
    n_host = None
    if out_cap is None:
        n_host = int(counts.sum())
        out_cap = bucket_capacity(max(n_host, 1))
    p_idx, b_idx, n_out, total = KJ.expand_matches_binsearch(
        lo, counts, build_at_rank, out_cap)
    out_live = torch.arange(out_cap, device=probe.device) < n_out
    pcols = KR.gather_columns(probe.columns, p_idx, out_live)
    bcols = KR.gather_columns(build.columns, b_idx, out_live & matched[p_idx])
    return ColumnarBatch(pcols + bcols, n_out, out_schema), \
        total if n_host is None else n_host


def join_full(probe: ColumnarBatch, build: ColumnarBatch, pk, bk,
              out_schema: T.Schema) -> List[ColumnarBatch]:
    """A full outer join (the reference's hash join with
    ``need_build_hits`` and ``unmatched_build_kernel``): the general
    matcher's ranges and build hit mask, then two batches, the left
    join's rows (every live probe row, with its matches or a null build
    side) and the live build rows that matched no probe row, in build
    order (lazy), with a null probe side. An empty build side leaves the
    second batch without rows; an empty probe side the first."""
    lo, counts, build_at_rank, hits = KJ.join_match(
        bk, pk, build.row_mask(), probe.row_mask(), need_build_hits=True)
    out, _ = _expand_pairs("full", probe, build, lo, counts, build_at_rank,
                           out_schema, None)
    keep = build.row_mask() & ~hits
    row0 = torch.zeros(build.capacity, dtype=torch.int64,
                       device=build.device)
    null_probe = KR.gather_columns(probe.columns, row0,
                                   torch.zeros_like(keep))
    tail = ColumnarBatch(null_probe + tuple(build.columns), keep.sum(),
                         out_schema, live=keep)
    return [out, tail]


def _match_ranges(probe: ColumnarBatch, build: ColumnarBatch, pk, bk):
    """``(lo, counts, build_at_rank)`` of every probe row (no matches for
    a dead one): the binary search for one integer key, else the general
    matcher."""
    live_p = probe.row_mask()
    if len(bk) == 1 and KJ.binsearch_joinable(bk[0]) \
            and KJ.binsearch_joinable(pk[0]):
        lo, counts, build_at_rank = KJ.join_match_binsearch(
            bk[0], pk[0], build.row_mask(), live_p)
    else:
        lo, counts, build_at_rank = KJ.join_match(
            bk, pk, build.row_mask(), live_p)
    return lo, torch.where(live_p, counts, 0), build_at_rank


def join_residual(join_type: str, probe: ColumnarBatch, build: ColumnarBatch,
                  pk, bk, out_schema: T.Schema, cond: Expression):
    """An equi join whose pairs must also pass ``cond`` (bound to the
    probe's then the build's columns). The equi keys give every probe row
    its match range; the ranges expand into (probe, build) pairs at the
    ladder rung of their exact count (one host read); ``cond`` runs on
    the gathered pairs; a scatter-add then counts each probe row's
    passing pairs. The rows come in the order of the reference's
    nested-loop join: an inner join's passing pairs, probe-major (build
    rows in their order); a semi join's probe rows with a passing pair,
    an anti join's live probe rows with none (both in place, lazy); a
    left join's passing pairs, then each live probe row with none,
    null-extended, in probe order. Returns ``(batch, pairs)``."""
    dev = probe.device
    live_p = probe.row_mask()
    lo, counts, build_at_rank = _match_ranges(probe, build, pk, bk)
    n_pairs = int(counts.sum())
    cap = bucket_capacity(max(n_pairs, 1))
    p_idx, b_idx, n_out, _ = KJ.expand_matches_binsearch(
        lo, counts, build_at_rank, cap)
    pair_live = torch.arange(cap, device=dev) < n_out
    pair_schema = T.Schema(list(probe.schema) + list(build.schema))
    pairs = ColumnarBatch(
        KR.gather_columns(probe.columns, p_idx, pair_live)
        + KR.gather_columns(build.columns, b_idx, pair_live),
        n_out, pair_schema)
    m = cond.eval_device(pairs)
    ok = m.data & m.validity & pair_live
    if join_type == "inner":
        return ColumnarBatch(pairs.columns, ok.sum(), out_schema,
                             live=ok), n_pairs
    passed = torch.zeros(probe.capacity, dtype=torch.int32, device=dev)
    passed = passed.index_add_(0, p_idx, ok.to(torch.int32)) > 0
    if join_type in ("left_semi", "left_anti"):
        keep = passed & live_p if join_type == "left_semi" \
            else live_p & ~passed
        return ColumnarBatch(probe.columns, keep.sum(), out_schema,
                             live=keep), n_pairs
    if join_type != "left":
        raise NotImplementedError(f"{join_type} join with a residual")
    sel = torch.nonzero(ok).squeeze(1)
    alone = torch.nonzero(live_p & ~passed).squeeze(1)
    n = sel.numel() + alone.numel()
    out_cap = bucket_capacity(max(n, 1))
    pad = torch.zeros(out_cap - n, dtype=torch.int64, device=dev)
    p_rows = torch.cat([p_idx[sel], alone, pad])
    b_rows = torch.cat([b_idx[sel], torch.zeros_like(alone), pad])
    live = torch.arange(out_cap, device=dev) < n
    b_live = torch.arange(out_cap, device=dev) < sel.numel()
    cols = KR.gather_columns(probe.columns, p_rows, live) \
        + KR.gather_columns(build.columns, b_rows, b_live)
    return ColumnarBatch(cols, torch.tensor(n, device=dev), out_schema), \
        n_pairs


class TopKExec(TorchExec):
    """ORDER BY ... LIMIT n as a top-k. A single float or int64 key rides
    one float64 lane whose exactness is data-dependent: its fail flag
    escalates this site to the exact lexsort."""

    def __init__(self, child: TorchExec, orders, n: int):
        self.children = [child]
        self.orders = orders
        self.n = n
        self.children_coalesce_goals = ["target"]

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return f"TopK n={self.n}"

    def execute(self, ctx):
        batch = accumulate(self.children[0], ctx, self.name)
        site = ctx.next_site("topk")
        key_exprs = [o.child.bind(self.schema) for o in self.orders]
        with ctx.timed(self.name):
            keys = [e.eval_device(batch) for e in key_exprs]
            with ctx.registry.timer(self.name, "sortTime"):
                top, ok = KR.topk_batch_by_columns(
                    batch, keys, [o.ascending for o in self.orders],
                    [o.effective_nulls_first for o in self.orders], self.n,
                    allow_data_fallback=ctx.mode(site) == 0)
            if ok is not True:
                ctx.report(site, ~ok)
        ctx.metric(self.name, "numOutputBatches", 1)
        return [[top]]


class SortExec(TorchExec):
    """Global sort (the reference's ``TpuSortExec``). With a spill catalog
    the child's batches are registered as they arrive; up to
    ``spark.rapids.sql.sort.externalThresholdBytes`` (0: a quarter of the
    device budget) they are assembled and sorted as one batch under the
    OOM retry (site ``SortExec.sort``, no split: two sorted halves are
    not a sorted whole); above it the external merge sort takes over
    (:mod:`.external_sort`): one sorted run per input batch, each
    generated under the retry and split in half by rows when it cannot
    fit (site ``SortExec.runGeneration``), then merged into a stream of
    sorted chunks (``externalSort`` 1)."""

    def __init__(self, child: TorchExec, orders):
        self.children = [child]
        self.orders = orders
        self.children_coalesce_goals = ["target"]

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return "Sort [" + ", ".join(
            f"{o.child} {'ASC' if o.ascending else 'DESC'}"
            for o in self.orders) + "]"

    def _sort_one(self, ctx, batch: ColumnarBatch) -> ColumnarBatch:
        key_exprs = [o.child.bind(self.schema) for o in self.orders]
        with ctx.timed(self.name):
            keys = [e.eval_device(batch) for e in key_exprs]
            with ctx.registry.timer(self.name, "sortTime"):
                return KR.sort_batch_by_columns(
                    batch, keys, [o.ascending for o in self.orders],
                    [o.effective_nulls_first for o in self.orders])

    def execute(self, ctx):
        return [self._spillable(ctx)]

    def _generate_run(self, ctx, catalog, sorter, bid: int) -> None:
        """One input batch into a sorted run of the external sort. The
        restore can OOM too; a run that cannot fit splits into two
        runs, which the merge absorbs. (A function of its own, so the
        batch dies with it.)"""
        from ..memory import retry as R
        name = self.name
        batch = R.with_retry(ctx, f"{name}.runGeneration", bid,
                             catalog.acquire_batch, node=name)[0]
        with ctx.timed(name), ctx.registry.timer(name, "sortTime"):
            R.with_retry(ctx, f"{name}.runGeneration", batch,
                         sorter.add_batch, split=R.halve_by_rows, node=name)
        catalog.free(bid)

    def _spillable(self, ctx):
        from ..config import SORT_EXTERNAL_THRESHOLD
        from ..memory import retry as R
        from .external_sort import ExternalSorter
        name = self.name
        catalog = ctx.catalog
        threshold = ctx.conf.get(SORT_EXTERNAL_THRESHOLD) or \
            catalog.device_budget // 4
        ids, sorter = [], None
        try:
            total = _register_all(self.children[0], ctx, catalog, ids)
            if not ids:
                ctx.metric(name, "numOutputBatches", 1)
                yield empty_batch(self.schema, ctx.device)
                return
            if total <= threshold:
                out = R.with_retry(
                    ctx, f"{name}.sort", ids,
                    lambda id_list: self._sort_one(
                        ctx, _pinned_concat(catalog, id_list, ctx, name)),
                    node=name)[0]
                ctx.metric(name, "numOutputBatches", 1)
                yield out
                return
            key_exprs = [o.child.bind(self.schema) for o in self.orders]
            # chunks of a quarter of the threshold bound a merge step's
            # device footprint
            sorter = ExternalSorter(self.orders, self.schema, catalog, ctx,
                                    key_exprs,
                                    chunk_bytes=max(threshold // 4, 1))
            for bid in ids:
                self._generate_run(ctx, catalog, sorter, bid)
            ids = []
            n_out = 0
            for chunk in sorter.sorted_chunks():
                n_out += 1
                yield chunk
            ctx.metric(name, "numOutputBatches", n_out)
            ctx.metric(name, "externalSort", 1)
            ctx.metric(name, "sortRuns", sorter.n_runs)
            ctx.metric(name, "mergeSteps", sorter.n_merge_steps)
        finally:
            for bid in ids:
                catalog.free(bid)
            if sorter is not None:
                sorter.release()


class LimitExec(TorchExec):
    """First ``n`` live rows, in row order."""

    def __init__(self, child: TorchExec, n: int):
        self.children = [child]
        self.n = n

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return f"Limit {self.n}"

    def execute(self, ctx):
        batch = accumulate(self.children[0], ctx, self.name)
        with ctx.timed(self.name):
            b = KR.physical(batch)
            cap = min(b.capacity, bucket_capacity(max(self.n, 1)))
            iota = torch.arange(cap, device=b.device)
            n_out = torch.clamp(b.n_rows, max=self.n)
            cols = KR.gather_columns(b.columns, iota, iota < n_out)
        ctx.metric(self.name, "numOutputBatches", 1)
        return [[ColumnarBatch(cols, n_out, b.schema)]]


class HostToDeviceExec(TorchExec):
    """Host-to-device transition (the reference's ``exec/execs.py:89``):
    a device consumer of a CPU operator reads it through this. The host
    batches of each partition upload in groups of about
    ``spark.rapids.sql.batchSizeRows`` rows (``goal_rows``), one device
    batch a group. Its time is ``HostToDevice`` in ``exec_ms``; its rows
    and bytes go to its ``numInputRows`` and ``uploadBytes``."""

    def __init__(self, child: TorchExec, goal_rows: int = 1 << 20):
        self.children = [child]
        self.goal_rows = max(int(goal_rows), 1)

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return "HostToDevice"

    def execute(self, ctx):
        def upload(group):
            with ctx.timed("HostToDevice", host=True):
                hb = HostBatch.concat(group)
                db = hb.to_device(ctx.device)
            ctx.metric(self.name, "numInputRows", hb.num_rows)
            ctx.metric(self.name, "uploadBytes", hb.nbytes)
            ctx.metric(self.name, "numOutputBatches", 1)
            ctx.count("HostToDevice.rows", hb.num_rows)
            ctx.count("HostToDevice.bytes", hb.nbytes)
            return db

        def run(part):
            group, rows = [], 0
            for hb in part:
                group.append(hb)
                rows += hb.num_rows
                if rows >= self.goal_rows:
                    yield upload(group)
                    group, rows = [], 0
            if group:
                yield upload(group)
        return [run(p) for p in self.children[0].execute(ctx)]


class DeviceToHostExec(TorchExec):
    """Device-to-host transition, the root the planner puts over every
    device plan (the reference's ``DeviceToHostExec``, ``plan/
    overrides.py:795,806``). ``execute`` yields the live rows of each
    device batch as a :class:`HostBatch`, partitions in order, each in
    row order:

    * ``run`` (the pipeline off): each batch downloaded when it arrives;
    * ``run_overlapped`` (the pipeline on): once a partition has shown
      a second batch, the rest are pulled on a pool worker
      (:func:`..utils.prefetch.prefetch_iter`, ``prefetchDepth`` ahead),
      so the next batch's operators dispatch while this thread
      downloads the previous one; a partition of one batch, which has
      nothing to overlap, downloads as ``run`` does. Each download is
      the serial one: a copy of every batch into one pinned buffer,
      queued before the host waited on the previous batch (the
      reference's ``to_arrow_begin``/``finish``), was slower on the card
      (its whole capacity pinned, then copied out on the host).

    The download's time is ``DeviceToHost`` in ``exec_ms``; the rows and
    host bytes go to the device root's ``numOutputRows`` and
    ``downloadBytes`` (the port's profile tree is the device plan)."""

    def __init__(self, child: TorchExec, mid_plan: bool = False):
        self.children = [child]
        #: a transition under a CPU operator (not the plan's root): its
        #: rows and bytes are the counters ``DeviceToHost.rows`` and
        #: ``.bytes``
        self.mid_plan = mid_plan

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return "DeviceToHost"

    def execute(self, ctx):
        from . import pipeline
        parts = self.children[0].execute(ctx)
        if not pipeline.parallel_active(ctx):
            return [self._run(ctx, p) for p in parts]
        depth = pipeline.prefetch_depth(ctx.conf)
        return [self._run_overlapped(ctx, p, depth) for p in parts]

    def _run_overlapped(self, ctx, part, depth: int):
        from ..utils.prefetch import prefetch_iter
        it = iter(part)
        first = next(it, None)
        if first is None:
            return
        second = next(it, None)
        if second is None:
            yield from self._run(ctx, (first,))
            return
        rest = prefetch_iter(it, depth=depth, ctx=ctx, node=self.name)
        yield from self._run(ctx, itertools.chain((first, second), rest))

    def _run(self, ctx, part):
        for db in part:
            with ctx.timed("DeviceToHost", host=True):
                hb = HostBatch.from_device(db)
            if self.mid_plan:
                ctx.count("DeviceToHost.rows", hb.num_rows)
                ctx.count("DeviceToHost.bytes", hb.nbytes)
            yield hb

    columnar = False

    def collect(self, ctx: ExecContext) -> HostBatch:
        """Run the plan and concatenate its host batches; the device
        root's ``numOutputRows`` is set to the answer's rows and its
        ``downloadBytes`` gets their host bytes."""
        hosts = [hb for part in self.execute(ctx) for hb in part]
        out = HostBatch.concat(hosts) if hosts else \
            HostBatch.empty(self.schema)
        node = self.children[0].node_name()
        ctx.registry.set_value(node, "numOutputRows", out.num_rows)
        ctx.metric(node, "downloadBytes", sum(h.nbytes for h in hosts))
        return out


def collect(root: TorchExec, ctx: ExecContext) -> HostBatch:
    """Run a device plan (or a :class:`DeviceToHostExec` over one) on the
    streaming path and download its result."""
    if not isinstance(root, DeviceToHostExec):
        root = DeviceToHostExec(root)
    return root.collect(ctx)
