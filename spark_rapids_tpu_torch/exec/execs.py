"""Physical operators — port of ``spark_rapids_tpu/exec/execs.py``, cut to
what TPC-H Q1, Q3, Q4, Q6 and Q22 run, over a hash exchange or not:
device source, filter, project, hash aggregate (grouped and global,
partial per batch plus merge), shuffled hash join (inner, left outer,
semi and anti; direct-address modes, the exact binary-search path and
the general multi-key matcher; a residual condition), union, top-k,
sort, limit, and the device-to-host transition. The nested-loop joins are in
:mod:`.joins`, the shuffle exchange in :mod:`..shuffle.exchange`.

Execution model, the reference's: every operator's ``execute(ctx)``
returns a list of partitions, each an iterable of :class:`ColumnarBatch`
on the device that a consumer reads once, partitions in order (a scan's
partitions are generators, decoded ahead by :mod:`.pipeline`). Narrow
operators (project, filter) map each batch lazily; the
aggregate reduces every batch to partial buffers and merges them; joins,
sort, top-k and limit accumulate their child into one batch first
(:func:`accumulate`, the reference's ``_accumulate_spillable`` without
its spill catalog). A plan without an exchange is one partition of one
batch throughout, and :func:`_coalesce_device` hands a single batch on
untouched, so such a plan does no extra copy.

Optimistic operators (dense joins, the dense aggregate, the single-lane
top-k) take a *site* ordinal from the context, run in the mode the
session learned for that site, and report a device-side ``fail`` flag
into ``ctx.dense_fails``. The session reads all flags once after the run
and re-runs the query with the tripped sites escalated
(:meth:`..session.TorchSession.execute`).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from .. import types as T
from ..config import TorchConf
from ..data.batch import ColumnarBatch, HostBatch, empty_batch
from ..data.column import bucket_capacity
from ..ops import aggregates as AGG
from ..ops.expression import BoundReference, Expression, make_column
from ..ops.kernels import concat as KC
from ..ops.kernels import groupby as KG
from ..ops.kernels import join as KJ
from ..ops.kernels import rowops as KR


class ExecContext:
    """Per-attempt state: the session's conf, the learned dense mode of
    each optimistic site, the fail flags this attempt raised,
    per-operator timings and counters, and the cleanups the session runs
    when the attempt ends. Timings and counters take a lock: the scan's
    host work on the pipeline's workers adds to them too."""

    def __init__(self, device: torch.device,
                 dense_modes: Optional[Dict[int, int]] = None,
                 conf: Optional[TorchConf] = None):
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
        self._lock = threading.Lock()
        self._cleanups: List[Callable[[], None]] = []
        #: :class:`ReusedExec` -> its partitions, made at its first read.
        self.reused: Dict[int, List[List[ColumnarBatch]]] = {}

    def next_site(self, kind: str) -> int:
        self.site_kinds.append(kind)
        return len(self.site_kinds) - 1

    def mode(self, site: int) -> int:
        return self.dense_modes.get(site, 0)

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to the counter ``name``."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def host_interval(self, name: str, t0: float, t1: float) -> None:
        """Add the host-clock interval ``[t0, t1]`` (seconds) to ``name``'s
        time."""
        with self._lock:
            self._marks.append((name, t0, t1))

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
    def timed(self, name: str, host: bool = False):
        """Time an operator's own work (its children run before this),
        labelled for ``torch.profiler``; ``host`` times host work (the
        exchange's serialization) on the host clock. Times of one name
        add up across batches."""
        with torch.profiler.record_function(name):
            if self.device.type == "cuda" and not host:
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
                self.host_interval(name, t0, time.perf_counter())

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


def _bind_all(exprs: List[Expression], schema: T.Schema) -> List[Expression]:
    return [e.bind(schema) for e in exprs]


class TorchExec:
    children: List["TorchExec"] = []

    @property
    def schema(self) -> T.Schema:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__

    def describe(self) -> str:
        return self.name

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


def accumulate(child: TorchExec, ctx: ExecContext) -> ColumnarBatch:
    """All of a child's batches as one (an empty batch of its schema when
    it has none): the input of joins, sort, top-k and limit."""
    batches = [b for part in child.execute(ctx) for b in part]
    if not batches:
        return empty_batch(child.schema, ctx.device)
    return _coalesce_device(batches)


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
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return "Reused"

    def execute(self, ctx):
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

        def project(batch):
            with ctx.timed(self.name):
                cols = [e.eval_device(batch) for e in bound]
                return batch.with_columns(cols, self.schema)
        return [(project(b) for b in part) for part in parts]


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
                return KR.compact(batch, m.data & m.validity)
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
    path. Without grouping keys it is the global aggregate: one output
    row, also for no input."""

    def __init__(self, child: TorchExec, groupings: List[Expression],
                 aggregates: List[AGG.AggregateExpression]):
        self.children = [child]
        self.groupings = groupings
        self.aggregates = aggregates

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
            if self.groupings:
                batch = KR.shrink_sparse(batch)
            with ctx.timed(self.name):
                out, fail = aggregate_batch(batch, groupings, aggs,
                                            buf_schema, n_keys, True,
                                            dense_mode)
            ctx.report(site, fail)
            return out

        def merge(batches):
            batch = _coalesce_device(batches)
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
            return [[self.finalize(state)]]

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
                else:
                    values = c.data.to(spec.dtype.torch_dtype)
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
    for (_, _, op, spec), (result, counts) in zip(inputs, results):
        if spec.from_count:
            data = counts if op == "count" else result
            validity_out = group_live
        else:
            data = result
            validity_out = (counts > 0) & group_live
        out_cols.append(make_column(data, validity_out, spec.dtype))
    return ColumnarBatch(tuple(out_cols), n_groups, buf_schema), \
        (None if fail is False else fail)


class ShuffledHashJoinExec(TorchExec):
    """Equi join (inner, left outer, left_semi or left_anti), left =
    probe, right = build. A single integer key tries the direct-address
    table first (mode 1: table over the build side; mode 2, inner joins
    only: over the probe side), each escalated by its fail flag; mode 3,
    and every other key set, takes the exact path (:func:`join_exact`).
    Semi and anti joins keep the probe's columns and mark its kept rows
    live; a left join keeps every probe row, with a null build side
    where it found no match.

    A residual ``condition`` (the join's non-equi terms, over the probe's
    then the build's columns) must also hold for a pair to match. An
    inner join filters its output by it, from the build-table mode or
    the exact path; every other type takes :func:`join_residual`, which
    evaluates it on the expanded pairs during matching. The pair count
    adds to the ``<name>.pairs`` counter."""

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
        probe = accumulate(left, ctx)
        build = accumulate(right, ctx)
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
        with ctx.timed(self.name):
            pk = [e.eval_device(probe) for e in lkeys]
            bk = [e.eval_device(build) for e in rkeys]
            if KJ.dense_joinable(jt, rkeys) and mode <= 2:
                if mode == 1:
                    out, fail = KJ.dense_join(probe, build, pk[0], bk[0],
                                              self._schema, jt)
                else:
                    out, fail = KJ.dense_join_swapped(probe, build, pk[0],
                                                      bk[0], self._schema)
                ctx.report(site, fail)
                return [[_post_filter(out, cond)]]
            if cond is not None:
                out, n_pairs = join_residual(jt, probe, build, pk, bk,
                                             self._schema, cond)
                ctx.count(self.name + ".pairs", n_pairs)
                return [[out]]
            out, _ = join_exact(jt, probe, build, pk, bk, self._schema)
            return [[out]]


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
    read on the host (one sync); ``total`` is the output row count on the
    device, which may exceed ``out_cap`` (the caller re-runs bigger), and
    None for semi and anti joins."""
    live_p = probe.row_mask()
    lo, counts, build_at_rank = _match_ranges(probe, build, pk, bk)
    if join_type in ("left_semi", "left_anti"):
        keep = counts > 0 if join_type == "left_semi" \
            else live_p & (counts == 0)
        return ColumnarBatch(probe.columns, keep.sum(), out_schema,
                             live=keep), None
    matched = counts > 0
    if join_type == "left":
        counts = KJ.left_outer_counts(counts, live_p)
    if out_cap is None:
        out_cap = bucket_capacity(max(int(counts.sum()), 1))
    p_idx, b_idx, n_out, total = KJ.expand_matches_binsearch(
        lo, counts, build_at_rank, out_cap)
    out_live = torch.arange(out_cap, device=probe.device) < n_out
    pcols = KR.gather_columns(probe.columns, p_idx, out_live)
    bcols = KR.gather_columns(build.columns, b_idx, out_live & matched[p_idx])
    return ColumnarBatch(pcols + bcols, n_out, out_schema), total


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

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return f"TopK n={self.n}"

    def execute(self, ctx):
        batch = accumulate(self.children[0], ctx)
        site = ctx.next_site("topk")
        key_exprs = [o.child.bind(self.schema) for o in self.orders]
        with ctx.timed(self.name):
            keys = [e.eval_device(batch) for e in key_exprs]
            top, ok = KR.topk_batch_by_columns(
                batch, keys, [o.ascending for o in self.orders],
                [o.effective_nulls_first for o in self.orders], self.n,
                allow_data_fallback=ctx.mode(site) == 0)
            if ok is not True:
                ctx.report(site, ~ok)
            return [[top]]


class SortExec(TorchExec):
    def __init__(self, child: TorchExec, orders):
        self.children = [child]
        self.orders = orders

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return "Sort [" + ", ".join(
            f"{o.child} {'ASC' if o.ascending else 'DESC'}"
            for o in self.orders) + "]"

    def execute(self, ctx):
        batch = accumulate(self.children[0], ctx)
        key_exprs = [o.child.bind(self.schema) for o in self.orders]
        with ctx.timed(self.name):
            keys = [e.eval_device(batch) for e in key_exprs]
            return [[KR.sort_batch_by_columns(
                batch, keys, [o.ascending for o in self.orders],
                [o.effective_nulls_first for o in self.orders])]]


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
        batch = accumulate(self.children[0], ctx)
        with ctx.timed(self.name):
            b = KR.physical(batch)
            cap = min(b.capacity, bucket_capacity(max(self.n, 1)))
            iota = torch.arange(cap, device=b.device)
            n_out = torch.clamp(b.n_rows, max=self.n)
            cols = KR.gather_columns(b.columns, iota, iota < n_out)
            return [[ColumnarBatch(cols, n_out, b.schema)]]


def collect(root: TorchExec, ctx: ExecContext) -> HostBatch:
    """Device-to-host transition: run the plan and download the live
    rows of its result, partitions in order, each in row order."""
    parts = root.execute(ctx)
    with ctx.timed("DeviceToHost"):
        hosts = [HostBatch.from_device(b) for part in parts for b in part]
    return HostBatch.concat(hosts) if hosts else HostBatch.empty(root.schema)
