"""The CPU operators — port of ``spark_rapids_tpu/plan/physical.py:
282-1129``, over the port's :class:`~..data.batch.HostBatch` in numpy
(the reference's are pyarrow).

The planner (:mod:`.planner`) plans every logical node to one of these;
the overrides pass (:mod:`.overrides`) converts each node the device can
take into the port's device exec and keeps the rest here, with
transitions between (``exec/execs.py HostToDeviceExec`` and
``DeviceToHostExec``). With ``spark.rapids.sql.enabled`` off nothing is
converted: the whole plan runs here, the port's CPU oracle.

Execution model, the device execs': ``execute(ctx)`` returns a list of
partitions, each an iterable of :class:`HostBatch`. Every operator is
:class:`HostExec` (``columnar`` false); its time is ``ctx.timed(<name>,
host=True)``, so ``QueryInfo.exec_ms`` holds the host operators' time
beside the device's.

Semantics are the reference's oracle's:

* the aggregate groups float keys by their bits (``0.0`` and ``-0.0``
  apart, as pyarrow's ``group_by`` does) and takes Spark's float
  ``min``/``max`` (NaN is the greatest: a group's max is NaN when any
  value is, its min only when all are; ``:403-430``);
* the sort orders NaN greatest and places each key's nulls by its own
  ``nulls_first``;
* the equi join matches keys by value (a null key matches nothing) and
  applies a residual while it pairs rows, so an outer, semi or anti
  join keeps Spark's meaning, in time linear in its inputs and matches;
* the cross join pairs in chunks of at most :data:`NLJ_CHUNK_PAIRS`
  pairs, so no pair grid is made whole.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional

import numpy as np

from .. import types as T
from ..data.batch import HostBatch
from ..exec.execs import ExecContext, TorchExec, _bind_all
from ..ops import aggregates as AGG
from ..ops import nondeterministic as ND
from ..ops.expression import Expression, fixed_width, host_column

#: Pairs the nested-loop join evaluates its condition over at once.
NLJ_CHUNK_PAIRS = 1 << 20


class HostExec(TorchExec):
    """A CPU operator: its partitions yield :class:`HostBatch`."""

    columnar = False

    def collect(self, ctx: ExecContext) -> HostBatch:
        """Run the plan and concatenate its host batches (the root's
        ``numOutputRows`` is the answer's rows)."""
        hosts = [hb for part in self.execute(ctx) for hb in part]
        out = HostBatch.concat(hosts) if hosts else \
            HostBatch.empty(self.schema)
        ctx.registry.set_value(self.node_name(), "numOutputRows",
                               out.num_rows)
        return out


def _all_rows(plan: TorchExec, ctx: ExecContext) -> HostBatch:
    """Every batch of a host child as one."""
    hosts = [hb for part in plan.execute(ctx) for hb in part]
    return HostBatch.concat(hosts) if hosts else HostBatch.empty(plan.schema)


def take_rows(hb: HostBatch, idx: np.ndarray, schema: T.Schema = None
              ) -> HostBatch:
    """Rows ``idx`` of ``hb`` (an index of -1 gives a null row)."""
    schema = schema or hb.schema
    idx = np.asarray(idx, dtype=np.int64)
    miss = idx < 0
    safe = np.where(miss, 0, idx)
    pairs = []
    for i, f in enumerate(schema):
        v, ok = hb.column_at(i)
        if hb.num_rows == 0:  # every index is -1
            pairs.append(host_column(
                np.zeros(len(idx), f.data_type.np_dtype)
                if fixed_width(f.data_type) else [None] * len(idx),
                np.zeros(len(idx), bool), f.data_type))
            continue
        pairs.append(host_column(v[safe], ok[safe] & ~miss, f.data_type))
    return HostBatch.from_positional(schema, pairs)


def _joined(left: HostBatch, right: HostBatch, li: np.ndarray,
            ri: np.ndarray, schema: T.Schema) -> HostBatch:
    """Rows ``li`` of ``left`` beside rows ``ri`` of ``right`` (-1: nulls)
    under ``schema``."""
    lpart = take_rows(left, li)
    rpart = take_rows(right, ri)
    pairs = [lpart.column_at(i) for i in range(len(left.schema))] + \
        [rpart.column_at(i) for i in range(len(right.schema))]
    return HostBatch.from_positional(schema, pairs)


def key_codes(cols: List[tuple], dtypes: List[T.DataType],
              by_bits: bool) -> np.ndarray:
    """int64 codes ``[n, len(cols)]`` of key rows: equal rows, equal
    codes; a null its own code. ``by_bits`` tells floats apart by their
    bits (the aggregate's ``0.0``/``-0.0`` and NaN payloads, as the
    reference's oracle groups them); else by value, NaN equal to NaN."""
    n = len(cols[0][0]) if cols else 0
    out = np.zeros((n, len(cols)), dtype=np.int64)
    for j, ((v, ok), dt) in enumerate(zip(cols, dtypes)):
        ok = np.asarray(ok, dtype=bool)
        if not fixed_width(dt):
            if dt is T.STRING:
                codes, _ = factorize(v)
            else:  # arrays and structs: equal values, equal text
                codes, _ = factorize([repr(x) for x in v])
            codes = codes + 1
        elif dt.is_floating:
            f = np.asarray(v, dtype=np.float64)
            if by_bits:
                codes = f.view(np.int64)
                _, inv = np.unique(codes, return_inverse=True)
            else:
                f = np.where(f == 0, 0.0, f)  # -0.0 equals 0.0
                _, inv = np.unique(f, return_inverse=True)
            codes = inv.astype(np.int64) + 1
        else:
            codes = np.asarray(v).astype(np.int64)
            _, inv = np.unique(codes, return_inverse=True)
            codes = inv.astype(np.int64) + 1
        out[:, j] = np.where(ok, codes, 0)
    return out


def factorize(values) -> tuple:
    """``(codes, uniques)``: int64 codes of hashable values in
    first-appearance order (a dict pass: no sort of the values)."""
    seen: dict = {}
    codes = np.fromiter((seen.setdefault(x, len(seen)) for x in values),
                        dtype=np.int64, count=len(values))
    return codes, list(seen)


def group_rows(codes: np.ndarray):
    """``(gid, first_row)``: each row's group in first-appearance order
    and each group's first row."""
    if codes.shape[0] == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if codes.shape[1] == 0:
        return np.zeros(codes.shape[0], np.int64), np.zeros(1, np.int64)
    sizes = codes.max(axis=0).astype(np.float64) + 1
    if np.prod(sizes) < 2.0 ** 62:  # one int64 lane: a 1-d unique
        flat = np.ravel_multi_index(codes.T, sizes.astype(np.int64))
        _, first, inv = np.unique(flat, return_index=True,
                                  return_inverse=True)
    else:
        _, first, inv = np.unique(codes, axis=0, return_index=True,
                                  return_inverse=True)
    inv = inv.reshape(-1)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rank[inv].astype(np.int64), first[order].astype(np.int64)


def _order_key(x):
    """A sort key of one host value: strings by code point (UTF-8 byte
    order), arrays element by element (a null element first, a prefix
    before the longer array), structs field by field."""
    if isinstance(x, (list, tuple)):
        return tuple((0, None) if e is None else (1, _order_key(e))
                     for e in x)
    if isinstance(x, dict):
        return tuple((0, None) if e is None else (1, _order_key(e))
                     for e in x.values())
    return x


def _object_ranks(v, ok) -> np.ndarray:
    """Dense ranks of an object column's valid values in their order (0
    under a null)."""
    idx = [i for i, good in enumerate(ok) if good]
    keys = {i: _order_key(v[i]) for i in idx}
    order = sorted(idx, key=lambda i: keys[i])
    ranks = np.zeros(len(ok), dtype=np.int64)
    r, prev = -1, object()
    for i in order:
        if r < 0 or keys[i] != prev:
            r += 1
            prev = keys[i]
        ranks[i] = r
    return ranks


def sort_permutation(cols: List[tuple], dtypes: List[T.DataType],
                     orders) -> np.ndarray:
    """The stable permutation that sorts rows by ``cols`` under
    ``orders`` (NaN greatest, each key's nulls by its ``nulls_first``)."""
    keys = []
    for (v, ok), dt, o in zip(cols, dtypes, orders):
        ok = np.asarray(ok, dtype=bool)
        n = len(ok)
        if fixed_width(dt):
            vals = np.asarray(v)
            if dt.is_floating:
                vals = vals.astype(np.float64)
            # np.unique sorts NaN last (the greatest) and -0.0 with 0.0
            _, inv = np.unique(np.where(ok, vals, np.zeros((), vals.dtype)),
                               return_inverse=True)
        elif dt is T.STRING:
            codes, uniq = factorize(v)
            # code point order is UTF-8 byte order
            order = sorted(range(len(uniq)),
                           key=lambda i: uniq[i] or "")  # None: a null
            rank = np.empty(len(uniq), dtype=np.int64)
            rank[order] = np.arange(len(uniq))
            inv = rank[codes] if len(uniq) else codes
        else:
            inv = _object_ranks(v, ok)
        rank = inv.reshape(-1).astype(np.int64)
        if not o.ascending:
            rank = -rank
        null_first = o.effective_nulls_first
        bucket = np.where(ok, 1, 0) if null_first else np.where(ok, 0, 1)
        keys.append((bucket, np.where(ok, rank, 0)))
    if not keys:
        return np.arange(len(cols[0][1]) if cols else 0)
    lex = []
    for bucket, rank in reversed(keys):
        lex.extend([rank, bucket])
    return np.lexsort(lex)


class CpuProjectExec(HostExec):
    def __init__(self, child: TorchExec, exprs: List[Expression]):
        self.children = [child]
        self.exprs = exprs

    @property
    def schema(self):
        return T.Schema([T.StructField(e.name, e.data_type, e.nullable)
                         for e in self.exprs])

    def describe(self):
        return "CpuProject [" + ", ".join(str(e) for e in self.exprs) + "]"

    def execute(self, ctx):
        bound = _bind_all(self.exprs, self.children[0].schema)
        nondet = any(ND.has_nondeterministic(e) for e in bound)
        schema = self.schema

        def run(part, pid):
            row_base = 0
            for hb in part:
                with ctx.timed(self.name, host=True):
                    with ND.eval_context(pid, row_base):
                        pairs = [e.eval_host(hb) for e in bound]
                    row_base += hb.num_rows
                    out = HostBatch.from_positional(schema, pairs)
                yield out
        parts = self.children[0].execute(ctx)
        if nondet:
            return [run(p, i) for i, p in enumerate(parts)]
        return [run(p, 0) for p in parts]


class CpuFilterExec(HostExec):
    def __init__(self, child: TorchExec, condition: Expression):
        self.children = [child]
        self.condition = condition

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return f"CpuFilter ({self.condition})"

    def execute(self, ctx):
        cond = self.condition.bind(self.children[0].schema)

        def run(part):
            for hb in part:
                with ctx.timed(self.name, host=True):
                    v, ok = cond.eval_host(hb)
                    keep = np.nonzero(np.asarray(v, bool) & ok)[0]
                    out = take_rows(hb, keep)
                yield out
        return [run(p) for p in self.children[0].execute(ctx)]


class CpuHashAggregateExec(HostExec):
    """Complete-mode aggregation over all of the child's rows (the
    reference's oracle; ``physical.py:368``)."""

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
        return ("CpuHashAggregate [" + ", ".join(str(g)
                                                 for g in self.groupings)
                + "] [" + ", ".join(f"{a.func} AS {a.name}"
                                    for a in self.aggregates) + "]")

    def execute(self, ctx):
        child = self.children[0]
        hb = _all_rows(child, ctx)
        with ctx.timed(self.name, host=True):
            out = self._aggregate(hb, child.schema)
        return [[out]]

    def _aggregate(self, hb: HostBatch, child_schema: T.Schema
                   ) -> HostBatch:
        n = hb.num_rows
        keys = [g.bind(child_schema).eval_host(hb) for g in self.groupings]
        if self.groupings:
            gid, first = group_rows(key_codes(
                keys, [g.data_type for g in self.groupings], by_bits=True))
            n_groups = len(first)
        else:
            gid, first, n_groups = np.zeros(n, np.int64), None, 1
        pairs = []
        for (v, ok), g in zip(keys, self.groupings):
            pairs.append(host_column(v[first], ok[first], g.data_type))
        for a in self.aggregates:
            fn = a.func
            if fn.child is None:
                v, ok = np.ones(n, np.int64), np.ones(n, bool)
            else:
                v, ok = fn.child.bind(child_schema).eval_host(hb)
                v = np.asarray(v)
            pairs.append(fn.host_reduce(v, np.asarray(ok, bool), gid,
                                        n_groups))
        return HostBatch.from_positional(self.schema, pairs)


class CpuJoinExec(HostExec):
    """Equi join of every type (a residual ``condition`` applied while
    rows pair, so outer, semi and anti joins keep their meaning): the
    reference's ``CpuJoinExec`` (``physical.py:478``), whose planner
    raises for a right or full join with a residual."""

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
        return f"CpuJoin {self.join_type} [{keys}]{cond}"

    def _pair_schema(self) -> T.Schema:
        left, right = self.children
        return T.Schema(list(left.schema) + list(right.schema))

    def execute(self, ctx):
        left, right = self.children
        lhb, rhb = _all_rows(left, ctx), _all_rows(right, ctx)
        with ctx.timed(self.name, host=True):
            out = self._join(lhb, rhb)
        return [[out]]

    def _join(self, lhb: HostBatch, rhb: HostBatch) -> HostBatch:
        left, right = self.children
        lk = [k.bind(left.schema).eval_host(lhb) for k in self.left_keys]
        rk = [k.bind(right.schema).eval_host(rhb) for k in self.right_keys]
        nl, nr = lhb.num_rows, rhb.num_rows
        dts = [k.data_type for k in self.left_keys]
        both = [(np.concatenate([np.asarray(a, dtype=object if not
                                            fixed_width(dt) else None),
                                 np.asarray(b, dtype=object if not
                                            fixed_width(dt) else None)]),
                 np.concatenate([aok, bok]))
                for (a, aok), (b, bok), dt in zip(lk, rk, dts)]
        codes = key_codes(both, dts, by_bits=False)
        null_key = (codes == 0).any(axis=1)
        gid, _ = group_rows(codes)
        gid = np.where(null_key, -1, gid)
        lg, rg = gid[:nl], gid[nl:]
        order = np.argsort(rg, kind="stable")
        rs = rg[order]
        lo = np.searchsorted(rs, lg, "left")
        hi = np.searchsorted(rs, lg, "right")
        cnt = np.where(lg < 0, 0, hi - lo)
        li = np.repeat(np.arange(nl), cnt)
        starts = np.repeat(lo, cnt)
        within = np.arange(len(li)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        ri = order[starts + within] if len(li) else np.zeros(0, np.int64)
        if self.condition is not None and len(li):
            pairs = _joined(lhb, rhb, li, ri, self._pair_schema())
            v, ok = self.condition.bind(self._pair_schema()).eval_host(pairs)
            keep = np.asarray(v, bool) & ok
            li, ri = li[keep], ri[keep]
        return finish_join(self.join_type, lhb, rhb, li, ri, self.schema)


def finish_join(join_type: str, lhb: HostBatch, rhb: HostBatch,
                li: np.ndarray, ri: np.ndarray, schema: T.Schema
                ) -> HostBatch:
    """A join's output from its matching pairs ``(li, ri)``: the pairs,
    then the unmatched rows an outer join keeps; the probe rows with (or
    without) a match of a semi (anti) join."""
    nl, nr = lhb.num_rows, rhb.num_rows
    if join_type in ("left_semi", "left_anti"):
        hit = np.zeros(nl, bool)
        hit[li] = True
        keep = hit if join_type == "left_semi" else ~hit
        return take_rows(lhb, np.nonzero(keep)[0])
    parts_l, parts_r = [li], [ri]
    if join_type in ("left", "full"):
        miss = np.ones(nl, bool)
        miss[li] = False
        un = np.nonzero(miss)[0]
        parts_l.append(un)
        parts_r.append(np.full(len(un), -1, np.int64))
    if join_type in ("right", "full"):
        miss = np.ones(nr, bool)
        miss[ri] = False
        un = np.nonzero(miss)[0]
        parts_l.append(np.full(len(un), -1, np.int64))
        parts_r.append(un)
    return _joined(lhb, rhb, np.concatenate(parts_l).astype(np.int64),
                   np.concatenate(parts_r).astype(np.int64), schema)


class CpuNestedLoopJoinExec(HostExec):
    """A cross join, with or without a condition (the reference's
    ``physical.py:1035``, which expands the whole pair grid): the pairs
    of ``chunk`` probe rows at a time, at most :data:`NLJ_CHUNK_PAIRS` a
    chunk, the condition evaluated over each chunk's pairs."""

    def __init__(self, left: TorchExec, right: TorchExec,
                 condition: Optional[Expression], schema: T.Schema):
        self.children = [left, right]
        self.condition = condition
        self._schema = schema

    @property
    def schema(self):
        return self._schema

    def describe(self):
        cond = "" if self.condition is None else f" ({self.condition})"
        return f"CpuNestedLoopJoin cross{cond}"

    def execute(self, ctx):
        left, right = self.children
        lhb, rhb = _all_rows(left, ctx), _all_rows(right, ctx)
        with ctx.timed(self.name, host=True):
            out = self._join(lhb, rhb)
        return [[out]]

    def _join(self, lhb: HostBatch, rhb: HostBatch) -> HostBatch:
        left, right = self.children
        pair_schema = T.Schema(list(left.schema) + list(right.schema))
        cond = None if self.condition is None else \
            self.condition.bind(pair_schema)
        nl, nr = lhb.num_rows, rhb.num_rows
        chunk = max(1, NLJ_CHUNK_PAIRS // max(nr, 1))
        lis, ris = [], []
        for start in range(0, nl if nr else 0, chunk):
            rows = np.arange(start, min(nl, start + chunk))
            li = np.repeat(rows, nr)
            ri = np.tile(np.arange(nr), len(rows))
            if cond is not None:
                v, ok = cond.eval_host(_joined(lhb, rhb, li, ri,
                                               pair_schema))
                keep = np.asarray(v, bool) & ok
                li, ri = li[keep], ri[keep]
            lis.append(li)
            ris.append(ri)
        li = np.concatenate(lis) if lis else np.zeros(0, np.int64)
        ri = np.concatenate(ris) if ris else np.zeros(0, np.int64)
        return _joined(lhb, rhb, li.astype(np.int64), ri.astype(np.int64),
                       self.schema)


class CpuSortExec(HostExec):
    def __init__(self, child: TorchExec, orders):
        self.children = [child]
        self.orders = orders

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return "CpuSort [" + ", ".join(
            f"{o.child} {'ASC' if o.ascending else 'DESC'}"
            for o in self.orders) + "]"

    def execute(self, ctx):
        child = self.children[0]
        hb = _all_rows(child, ctx)
        with ctx.timed(self.name, host=True):
            out = sort_rows(hb, self.orders, child.schema)
        return [[out]]


def sort_rows(hb: HostBatch, orders, schema: T.Schema) -> HostBatch:
    cols = [o.child.bind(schema).eval_host(hb) for o in orders]
    perm = sort_permutation(cols, [o.child.data_type for o in orders],
                            orders)
    return take_rows(hb, perm)


def _limit_stream(batches, n: int):
    remaining = n
    for hb in batches:
        if remaining <= 0:
            return
        take = min(remaining, hb.num_rows)
        remaining -= take
        yield hb if take == hb.num_rows else take_rows(hb, np.arange(take))


class CpuLocalLimitExec(HostExec):
    """Per-partition limit (``physical.py:617``)."""

    def __init__(self, child: TorchExec, n: int):
        self.children = [child]
        self.n = n

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return f"CpuLocalLimit {self.n}"

    def execute(self, ctx):
        return [_limit_stream(p, self.n)
                for p in self.children[0].execute(ctx)]


class CpuLimitExec(HostExec):
    def __init__(self, child: TorchExec, n: int):
        self.children = [child]
        self.n = n

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        return f"CpuLimit {self.n}"

    def execute(self, ctx):
        def flat():
            for part in self.children[0].execute(ctx):
                yield from part
        return [_limit_stream(flat(), self.n)]


class CpuUnionExec(HostExec):
    def __init__(self, children: List[TorchExec], schema: T.Schema):
        self.children = list(children)
        self._schema = schema

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return "CpuUnion"

    def execute(self, ctx):
        def relabel(part):
            for hb in part:
                yield HostBatch.from_positional(
                    self._schema, [hb.column_at(i)
                                   for i in range(len(self._schema))])
        return [relabel(p) for c in self.children for p in c.execute(ctx)]


class CpuExpandExec(HostExec):
    def __init__(self, child: TorchExec, projections, schema: T.Schema):
        self.children = [child]
        self.projections = projections
        self._schema = schema

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return f"CpuExpand [{len(self.projections)} projections]"

    def execute(self, ctx):
        child_schema = self.children[0].schema
        bound = [_bind_all(p, child_schema) for p in self.projections]

        def run(part):
            for hb in part:
                for proj in bound:
                    with ctx.timed(self.name, host=True):
                        pairs = [host_column(*e.eval_host(hb), f.data_type)
                                 for e, f in zip(proj, self._schema)]
                        out = HostBatch.from_positional(self._schema, pairs)
                    yield out
        return [run(p) for p in self.children[0].execute(ctx)]


class CpuGenerateExec(HostExec):
    """``explode``/``posexplode`` row by row (``physical.py:734``)."""

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
        return f"CpuGenerate [{self.generator}]"

    def execute(self, ctx):
        gen = self.generator.bind(self.children[0].schema)
        n_child = len(self.children[0].schema)
        elem_dt = self._schema[len(self._schema) - 1].data_type

        def run(part):
            for hb in part:
                with ctx.timed(self.name, host=True):
                    arr, ok = gen.eval_host(hb)
                    idx, poss, elems = [], [], []
                    for i, (lst, good) in enumerate(zip(arr, ok)):
                        if not good or not lst:
                            if self.outer:
                                idx.append(i)
                                poss.append(None)
                                elems.append(None)
                            continue
                        for j, x in enumerate(lst):
                            idx.append(i)
                            poss.append(j)
                            elems.append(x)
                    base = take_rows(hb, np.array(idx, np.int64))
                    pairs = [base.column_at(i) for i in range(n_child)]
                    if self.pos:
                        pairs.append(host_column(
                            [0 if p is None else p for p in poss],
                            np.array([p is not None for p in poss], bool),
                            T.INT))
                    pairs.append(host_column(
                        [0 if e is None and fixed_width(elem_dt) else e
                         for e in elems],
                        np.array([e is not None for e in elems], bool),
                        elem_dt))
                    out = HostBatch.from_positional(self._schema, pairs)
                yield out
        return [run(p) for p in self.children[0].execute(ctx)]


def _pylist(v, ok) -> list:
    return [x if good else None for x, good in zip(np.asarray(v).tolist(),
                                                   np.asarray(ok).tolist())]


def _cmp_scalar(a, b) -> int:
    a_nan = isinstance(a, float) and math.isnan(a)
    b_nan = isinstance(b, float) and math.isnan(b)
    if a_nan and b_nan:
        return 0
    if a_nan:
        return 1
    if b_nan:
        return -1
    if a == b:
        return 0
    return -1 if a < b else 1


def _cmp_part(i, j, part_vals) -> int:
    for pv in part_vals:
        a, b = pv[i], pv[j]
        if (a is None) != (b is None):
            return -1 if a is None else 1
        if a is not None:
            c = _cmp_scalar(a, b)
            if c:
                return c
    return 0


class CpuWindowExec(HostExec):
    """Window functions over comparator-sorted partitions, row by row
    (the reference's oracle, ``physical.py:786``): all of the child's
    rows, each window expression appended as a column in input order."""

    def __init__(self, child: TorchExec, window_exprs, schema: T.Schema):
        self.children = [child]
        self.window_exprs = window_exprs
        self._schema = schema

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return "CpuWindow [" + ", ".join(n for n, _ in self.window_exprs) \
            + "]"

    def execute(self, ctx):
        child = self.children[0]
        hb = _all_rows(child, ctx)
        with ctx.timed(self.name, host=True):
            pairs = [hb.column_at(i) for i in range(len(child.schema))]
            for (_, we), f in zip(self.window_exprs,
                                  list(self._schema)[len(child.schema):]):
                out = self._eval(hb, we, child.schema)
                pairs.append(host_column(
                    [0 if o is None and fixed_width(f.data_type) else o
                     for o in out],
                    np.array([o is not None for o in out], bool),
                    f.data_type))
            out = HostBatch.from_positional(self._schema, pairs)
        return [[out]]

    def _eval(self, hb: HostBatch, we, schema: T.Schema) -> list:
        n = hb.num_rows
        spec = we.spec
        part_vals = [_pylist(*e.bind(schema).eval_host(hb))
                     for e in spec.partition_by]
        order_meta = [(_pylist(*o.child.bind(schema).eval_host(hb)),
                       o.ascending, o.effective_nulls_first)
                      for o in spec.order_by]
        child = we.func.children[0] if we.func.children else None
        vals = _pylist(*child.bind(schema).eval_host(hb)) \
            if child is not None else None

        def cmp_rows(i, j):
            c = _cmp_part(i, j, part_vals)
            if c:
                return c
            for ov, asc, nf in order_meta:
                a, b = ov[i], ov[j]
                if (a is None) != (b is None):
                    null_cmp = -1 if nf else 1
                    return null_cmp if a is None else -null_cmp
                if a is not None:
                    c = _cmp_scalar(a, b)
                    if c:
                        return c if asc else -c
            return 0

        idx = sorted(range(n), key=functools.cmp_to_key(cmp_rows))
        frame = spec.effective_frame()
        out = [None] * n
        s = 0
        while s < n:
            e = s + 1
            while e < n and _cmp_part(idx[s], idx[e], part_vals) == 0:
                e += 1
            self._eval_segment(idx, s, e, order_meta, frame, we, vals, out)
            s = e
        return out

    def _eval_segment(self, idx, s, e, order_meta, frame, we, vals, out):
        from ..ops import windows as W

        def order_tuple(p):
            return tuple(("NaN",) if isinstance(ov[idx[p]], float)
                         and math.isnan(ov[idx[p]]) else ov[idx[p]]
                         for ov, _, _ in order_meta)

        def peers(p):
            lo = p
            while lo > s and order_tuple(lo - 1) == order_tuple(p):
                lo -= 1
            hi = p + 1
            while hi < e and order_tuple(hi) == order_tuple(p):
                hi += 1
            return lo, hi

        peer_group = []
        g = 0
        for p in range(s, e):
            if p > s and order_tuple(p) != order_tuple(p - 1):
                g += 1
            peer_group.append(g)
        f = we.func
        for p in range(s, e):
            i = idx[p]
            if isinstance(f, W.RANKING_TYPES):
                out[i] = W.host_rank(f, p - s, peers(p)[0] - s,
                                     peer_group[p - s])
                continue
            lo, hi = self._frame(p, s, e, frame, order_meta, idx, peers)
            rows = [idx[q] for q in range(lo, hi)]
            out[i] = W.host_frame_value(
                f, None if vals is None else [vals[r] for r in rows],
                len(rows))

    @staticmethod
    def _frame(p, s, e, frame, order_meta, idx, peers):
        if frame.frame_type == "rows":
            lo = s if frame.lower.kind == "unbounded" else \
                max(s, min(e, p + (frame.lower.offset
                                   if frame.lower.kind == "offset" else 0)))
            hi = e if frame.upper.kind == "unbounded" else \
                max(s, min(e, p + (frame.upper.offset
                                   if frame.upper.kind == "offset" else 0)
                               + 1))
            return lo, max(hi, lo)
        need_peers = frame.lower.kind == "current" or \
            frame.upper.kind == "current"
        plo, phi = peers(p) if need_peers else (None, None)
        lo = s if frame.lower.kind == "unbounded" else plo
        hi = e if frame.upper.kind == "unbounded" else phi
        if frame.lower.kind == "offset" or frame.upper.kind == "offset":
            ov, asc, _ = order_meta[0]
            v = ov[idx[p]]
            if v is None:
                return peers(p)

            def bound(b, sign):
                if b.kind == "unbounded":
                    return None
                return v if b.kind == "current" else v + sign * b.offset
            if asc:
                lo_v, hi_v = bound(frame.lower, 1), bound(frame.upper, 1)
            else:
                lo_v, hi_v = bound(frame.upper, -1), bound(frame.lower, -1)

            def in_frame(q):
                vt = ov[idx[q]]
                if vt is None:
                    return False
                if lo_v is not None and vt < lo_v:
                    return False
                return not (hi_v is not None and vt > hi_v)
            members = [q for q in range(s, e) if in_frame(q)]
            if not members:
                return s, s
            lo, hi = members[0], members[-1] + 1
        return lo, max(hi, lo)
