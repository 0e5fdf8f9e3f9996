"""Physical operators — port of ``spark_rapids_tpu/exec/execs.py``, cut to
what TPC-H Q1, Q3, Q4, Q6 and Q22 run: device source, filter, project,
hash aggregate (grouped and global), shuffled hash join (inner, semi and
anti; direct-address modes and the exact binary-search path), top-k,
sort, limit, and the device-to-host transition. The nested-loop joins
are in :mod:`.joins`.

Execution model: every operator's ``execute(ctx)`` returns ONE
:class:`ColumnarBatch` holding its whole output on the device. The
reference streams batch iterators through fusion, spill, shuffle and pipelining; none of those
is ported yet, and one whole-relation batch is what they reduce to on a
single card that holds the data.

Optimistic operators (dense joins, the dense aggregate, the single-lane
top-k) take a *site* ordinal from the context, run in the mode the
session learned for that site, and report a device-side ``fail`` flag
into ``ctx.dense_fails``. The session reads all flags once after the run
and re-runs the query with the tripped sites escalated
(:meth:`..session.TorchSession.execute`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

from .. import types as T
from ..data.batch import ColumnarBatch, HostBatch
from ..data.column import bucket_capacity
from ..ops import aggregates as AGG
from ..ops.expression import BoundReference, Expression, make_column
from ..ops.kernels import groupby as KG
from ..ops.kernels import join as KJ
from ..ops.kernels import rowops as KR


class ExecContext:
    """Per-attempt state: the learned dense mode of each optimistic site,
    the fail flags this attempt raised, and per-operator timings."""

    def __init__(self, device: torch.device,
                 dense_modes: Optional[Dict[int, int]] = None):
        self.device = device
        self.dense_modes = dict(dense_modes or {})
        self.dense_fails: List[Tuple[int, torch.Tensor]] = []
        self.site_kinds: List[str] = []
        #: (operator, start, end): CUDA events on the card, host seconds
        #: on the CPU. Read through :meth:`exec_ms` after the run.
        self._marks: List[tuple] = []

    def next_site(self, kind: str) -> int:
        self.site_kinds.append(kind)
        return len(self.site_kinds) - 1

    def mode(self, site: int) -> int:
        return self.dense_modes.get(site, 0)

    def report(self, site: int, fail) -> None:
        """Record an optimistic site's device-side fail flag."""
        if fail is not None and fail is not False:
            self.dense_fails.append((site, fail))

    @contextlib.contextmanager
    def timed(self, name: str):
        """Time an operator's own work (its children run before this),
        labelled for ``torch.profiler``."""
        with torch.profiler.record_function(name):
            if self.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                yield
                end.record()
                self._marks.append((name, start, end))
            else:
                t0 = time.perf_counter()
                yield
                self._marks.append((name, t0, time.perf_counter()))

    def exec_ms(self) -> Dict[str, float]:
        """Milliseconds per operator (summed by name); synchronises."""
        out: Dict[str, float] = {}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for name, a, b in self._marks:
            ms = a.elapsed_time(b) if self.device.type == "cuda" \
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

    def execute(self, ctx: ExecContext) -> ColumnarBatch:
        raise NotImplementedError


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
        return self.batch


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
        batch = self.children[0].execute(ctx)
        bound = _bind_all(self.exprs, self.children[0].schema)
        with ctx.timed(self.name):
            cols = [e.eval_device(batch) for e in bound]
            return batch.with_columns(cols, self.schema)


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
        batch = self.children[0].execute(ctx)
        cond = self.condition.bind(self.schema)
        with ctx.timed(self.name):
            m = cond.eval_device(batch)
            return KR.compact(batch, m.data & m.validity)


class HashAggregateExec(TorchExec):
    """Grouped aggregation: one grouping pass over the whole input (the
    reference's partial/merge stack collapses to this for one batch),
    then the final buffer-evaluation projection. A sparse input to a
    grouped aggregation is compacted first
    (:func:`..ops.kernels.rowops.shrink_sparse`). The dense grouping path
    is optimistic; its fail flag escalates this site to the sort path.
    Without grouping keys it is the global aggregate: one output row."""

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

    def execute(self, ctx):
        batch = self.children[0].execute(ctx)
        site = ctx.next_site("aggregate")
        # The grouping sort and every reduction cost the input's capacity:
        # a sparse lazy input (a filtered join output) moves to its live
        # bucket first. The global aggregate's masked reductions need not.
        if self.groupings:
            batch = KR.shrink_sparse(batch)
        child_schema = self.children[0].schema
        groupings = _bind_all(self.groupings, child_schema)
        aggs = [AGG.AggregateExpression(a.func.bind(child_schema), a.name)
                for a in self.aggregates]
        buf_schema = self._buffer_schema()
        with ctx.timed(self.name):
            state, fail = aggregate_batch(batch, groupings, aggs, buf_schema,
                                          dense_mode=min(ctx.mode(site), 1))
            ctx.report(site, fail)
            return self._finalize(state)

    def _finalize(self, b: ColumnarBatch) -> ColumnarBatch:
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
                    dense_mode: int = 1):
    """One grouping pass in update mode (``_aggregate_batch`` of the
    reference): evaluate each aggregate's child, reduce it per group into
    its buffers. Returns ``(buffer batch, fail)``; ``fail`` is ``None``
    on the always-exact sort path."""
    capacity = batch.capacity
    dev = batch.device
    live = batch.row_mask()
    keys = [e.eval_device(batch) for e in key_exprs]
    inputs = []
    for a in aggs:
        for spec in a.func.buffers():
            if a.func.child is None:  # count(*)
                values = torch.ones(capacity, dtype=torch.int64, device=dev)
                validity = torch.ones(capacity, dtype=torch.bool, device=dev)
            else:
                c = a.func.child.eval_device(batch)
                values = c.data.to(spec.dtype.torch_dtype)
                validity = c.validity
            inputs.append((values, validity, spec.update_op, spec))
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
    """Equi join (inner, left_semi or left_anti), left = probe, right =
    build. A single integer key tries the direct-address table first
    (mode 1: table over the build side; mode 2, inner joins only: over
    the probe side), each escalated by its fail flag; mode 3, and every
    other key, takes the exact binary-search path. Semi and anti joins
    keep the probe's columns and mark its kept rows live."""

    def __init__(self, left: TorchExec, right: TorchExec, join_type: str,
                 left_keys: List[Expression], right_keys: List[Expression],
                 schema: T.Schema):
        self.children = [left, right]
        self.join_type = join_type
        self.left_keys = left_keys
        self.right_keys = right_keys
        self._schema = schema

    @property
    def schema(self):
        return self._schema

    def describe(self):
        keys = ", ".join(f"{l}={r}" for l, r in
                         zip(self.left_keys, self.right_keys))
        return f"ShuffledHashJoin {self.join_type} [{keys}]"

    def execute(self, ctx):
        left, right = self.children
        probe = left.execute(ctx)
        build = right.execute(ctx)
        site = ctx.next_site("join")
        lkeys = _bind_all(self.left_keys, left.schema)
        rkeys = _bind_all(self.right_keys, right.schema)
        mode = 1 + ctx.mode(site)
        if mode == 2 and self.join_type != "inner":
            mode = 3  # the swapped table exists for inner joins only
        with ctx.timed(self.name):
            pk = [e.eval_device(probe) for e in lkeys]
            bk = [e.eval_device(build) for e in rkeys]
            if KJ.dense_joinable(self.join_type, rkeys) and mode <= 2:
                if mode == 1:
                    out, fail = KJ.dense_join(probe, build, pk[0], bk[0],
                                              self._schema, self.join_type)
                else:
                    out, fail = KJ.dense_join_swapped(probe, build, pk[0],
                                                      bk[0], self._schema)
                ctx.report(site, fail)
                return out
            return self._exact(probe, build, pk, bk)

    def _exact(self, probe, build, pk, bk) -> ColumnarBatch:
        """Sort the build keys, binary-search every probe key, expand the
        match ranges. The output is sized from the exact match total,
        read on the host (one sync)."""
        if len(bk) != 1 or not (KJ.binsearch_joinable(bk[0])
                                and KJ.binsearch_joinable(pk[0])):
            raise NotImplementedError(
                "multi-key, string and float join keys need the general "
                "matcher, which is not ported yet")
        live_p = probe.row_mask()
        lo, counts, build_at_rank = KJ.join_match_binsearch(
            bk[0], pk[0], build.row_mask(), live_p)
        counts = torch.where(live_p, counts, 0)
        if self.join_type in ("left_semi", "left_anti"):
            keep = counts > 0 if self.join_type == "left_semi" \
                else live_p & (counts == 0)
            return ColumnarBatch(probe.columns, keep.sum(), self._schema,
                                 live=keep)
        total = int(counts.sum())
        out_cap = bucket_capacity(max(total, 1))
        p_idx, b_idx, n_out, _ = KJ.expand_matches_binsearch(
            lo, counts, build_at_rank, out_cap)
        out_live = torch.arange(out_cap, device=probe.device) < n_out
        pcols = KR.gather_columns(probe.columns, p_idx, out_live)
        bcols = KR.gather_columns(build.columns, b_idx, out_live)
        return ColumnarBatch(pcols + bcols, n_out, self._schema)


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
        batch = self.children[0].execute(ctx)
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
            return top


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
        batch = self.children[0].execute(ctx)
        key_exprs = [o.child.bind(self.schema) for o in self.orders]
        with ctx.timed(self.name):
            keys = [e.eval_device(batch) for e in key_exprs]
            return KR.sort_batch_by_columns(
                batch, keys, [o.ascending for o in self.orders],
                [o.effective_nulls_first for o in self.orders])


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
        batch = self.children[0].execute(ctx)
        with ctx.timed(self.name):
            b = KR.physical(batch)
            cap = min(b.capacity, bucket_capacity(max(self.n, 1)))
            iota = torch.arange(cap, device=b.device)
            n_out = torch.clamp(b.n_rows, max=self.n)
            cols = KR.gather_columns(b.columns, iota, iota < n_out)
            return ColumnarBatch(cols, n_out, b.schema)


def collect(root: TorchExec, ctx: ExecContext) -> HostBatch:
    """Device-to-host transition: run the plan and download the live
    rows of its result in row order."""
    batch = root.execute(ctx)
    with ctx.timed("DeviceToHost"):
        return HostBatch.from_device(batch)
