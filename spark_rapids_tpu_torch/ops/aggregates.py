"""Aggregate functions — port of ``spark_rapids_tpu/ops/aggregates.py``.

Each aggregate declares its buffer columns: the segment reduction that
builds a buffer from input rows (``update_op``), the one that merges
partial buffers (``merge_op``), and a final projection over the merged
buffers (``evaluate``). The ops name reductions of
:mod:`..ops.kernels.groupby`.

``Min``, ``Max``, ``First`` and ``Last`` take fixed-width children
(integers, dates, bools, floats with Spark's NaN order) and strings of
either layout, which reduce as an int lane (``exec.execs.string_agg_lane``):
a sorted dictionary's codes, a flat column's byte-order ranks, or the row
numbers that first and last pick.

``host_reduce`` is the host side, which the CPU aggregate
(``plan/physical.py CpuHashAggregateExec``) runs: numpy over the rows'
group ids, Spark's semantics as the reference's oracle gives them (a
float ``max`` is NaN when any value is, a ``min`` only when all are; an
integral sum wraps in int64; a group with no valid row is null, its
count 0).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .. import types as T
from .arithmetic import Divide
from .cast import Cast
from .expression import Expression, HostValues, fixed_width, host_column


@dataclasses.dataclass(frozen=True)
class BufferSpec:
    """One partial-aggregation buffer column."""
    suffix: str
    update_op: str
    merge_op: str
    dtype: T.DataType
    #: count buffers are non-null; value buffers are null when count == 0
    from_count: bool = False


class AggregateFunction(Expression):
    def __init__(self, child: Optional[Expression] = None):
        self.children = [child] if child is not None else []

    @property
    def child(self) -> Optional[Expression]:
        return self.children[0] if self.children else None

    def with_children(self, children):
        return type(self)(children[0]) if children else type(self)()

    def buffers(self) -> List[BufferSpec]:
        raise NotImplementedError

    def evaluate(self, buffer_refs: List[Expression]) -> Expression:
        return buffer_refs[0]

    def host_reduce(self, v: np.ndarray, ok: np.ndarray, gid: np.ndarray,
                    n_groups: int) -> HostValues:
        """The function over each group of the host rows ``(v, ok)``
        (``gid``: each row's group in ``[0, n_groups)``)."""
        raise NotImplementedError(type(self).__name__)

    @property
    def nullable(self) -> bool:
        return True


class _SameType(AggregateFunction):
    """An aggregate whose result and one buffer have the child's type."""

    op = ""

    @property
    def data_type(self) -> T.DataType:
        return self.child.data_type

    def buffers(self):
        return [BufferSpec(self.op, self.op, self.op, self.data_type)]


    def host_reduce(self, v, ok, gid, n_groups):
        is_max = self.op == "max"
        g, x = gid[ok], v[ok]
        has = np.bincount(g, minlength=n_groups) > 0
        dt = self.data_type
        if fixed_width(dt) and dt.is_floating:
            x = x.astype(np.float64)
            if is_max:  # NaN is the greatest: any NaN makes the max NaN
                acc = np.full(n_groups, -np.inf)
                with np.errstate(invalid="ignore"):
                    np.maximum.at(acc, g, x)
            else:  # NaN only when every value is NaN
                acc = np.full(n_groups, np.inf)
                np.fmin.at(acc, g, x)
                real = np.bincount(g, weights=~np.isnan(x),
                                   minlength=n_groups)
                acc = np.where(has & (real == 0), np.nan, acc)
            return host_column(acc, has, dt)
        if fixed_width(dt):
            info = np.iinfo(np.int64)
            acc = np.full(n_groups, info.min if is_max else info.max,
                          np.int64)
            (np.maximum if is_max else np.minimum).at(acc, g,
                                                      x.astype(np.int64))
            return host_column(acc, has, dt)
        # strings: Python's order is code point order, UTF-8 byte order
        out = [None] * n_groups
        for gi, xi in zip(g.tolist(), x.tolist()):
            cur = out[gi]
            if cur is None or ((xi > cur) if is_max else (xi < cur)):
                out[gi] = xi
        return host_column(out, has, dt)


class Min(_SameType):
    op = "min"


class Max(_SameType):
    op = "max"


class _Positional(_SameType):
    """first/last(expr, ignoreNulls): the value of a group's first or
    last contributing row. The group-by reduces over valid rows only, so
    that row is the first or last non-null one whatever the flag, as in
    the reference, which keeps the flag for the plan's sake."""

    def __init__(self, child: Optional[Expression] = None,
                 ignore_nulls: bool = True):
        super().__init__(child)
        self.ignore_nulls = ignore_nulls

    def with_children(self, children):
        return type(self)(children[0], self.ignore_nulls)

    def host_reduce(self, v, ok, gid, n_groups):
        rows = np.flatnonzero(ok)  # valid rows, whatever the flag
        if self.op == "last":
            rows = rows[::-1]
        pick = np.full(n_groups, -1, np.int64)
        # the first occurrence of each group in ``rows``' order
        g = gid[rows]
        _, first = np.unique(g, return_index=True)
        pick[g[first]] = rows[first]
        got = pick >= 0
        if len(v) == 0:
            return host_column(np.zeros(n_groups, self.data_type.np_dtype)
                               if fixed_width(self.data_type)
                               else [None] * n_groups, got, self.data_type)
        return host_column(v[np.where(got, pick, 0)], got, self.data_type)


class First(_Positional):
    op = "first"


class Last(_Positional):
    op = "last"


class Sum(AggregateFunction):
    """Spark widens integral sums to bigint, float sums to double."""

    @property
    def data_type(self) -> T.DataType:
        return T.DOUBLE if self.child.data_type.is_floating else T.LONG

    def buffers(self):
        return [BufferSpec("sum", "sum", "sum", self.data_type)]

    def host_reduce(self, v, ok, gid, n_groups):
        g = gid[ok]
        has = np.bincount(g, minlength=n_groups) > 0
        if self.data_type is T.LONG:
            acc = np.zeros(n_groups, np.int64)
            with np.errstate(over="ignore"):
                np.add.at(acc, g, v[ok].astype(np.int64))
            return host_column(acc, has, T.LONG)
        acc = np.bincount(g, weights=v[ok].astype(np.float64),
                          minlength=n_groups)
        return host_column(acc, has, T.DOUBLE)


class Count(AggregateFunction):
    """count(expr) counts non-null rows; count(*) when child is None."""

    @property
    def data_type(self) -> T.DataType:
        return T.LONG

    @property
    def nullable(self) -> bool:
        return False

    def buffers(self):
        return [BufferSpec("count", "count", "sum", T.LONG, from_count=True)]

    def host_reduce(self, v, ok, gid, n_groups):
        return np.bincount(gid[ok], minlength=n_groups).astype(np.int64), \
            np.ones(n_groups, dtype=bool)


class Average(AggregateFunction):
    """avg = sum / count, carried as two buffers; the final divide gives
    null for an empty group (a zero count)."""

    @property
    def data_type(self) -> T.DataType:
        return T.DOUBLE

    def buffers(self):
        return [BufferSpec("sum", "sum", "sum", T.DOUBLE),
                BufferSpec("count", "count", "sum", T.LONG, from_count=True)]

    def evaluate(self, buffer_refs):
        return Divide(buffer_refs[0], Cast(buffer_refs[1], T.DOUBLE))

    def host_reduce(self, v, ok, gid, n_groups):
        g = gid[ok]
        cnt = np.bincount(g, minlength=n_groups)
        acc = np.bincount(g, weights=v[ok].astype(np.float64),
                          minlength=n_groups)
        with np.errstate(invalid="ignore", divide="ignore"):
            return host_column(acc / np.maximum(cnt, 1), cnt > 0, T.DOUBLE)


@dataclasses.dataclass
class AggregateExpression:
    """A named aggregate in an Aggregate node."""
    func: AggregateFunction
    name: str
