"""Aggregate functions — port of ``spark_rapids_tpu/ops/aggregates.py``.

Each aggregate declares its buffer columns: the segment reduction that
builds a buffer from input rows (``update_op``), the one that merges
partial buffers (``merge_op``), and a final projection over the merged
buffers (``evaluate``). The ops name reductions of
:mod:`..ops.kernels.groupby`.

``Min``, ``Max``, ``First`` and ``Last`` take fixed-width children
(integers, dates, bools, floats with Spark's NaN order). A string child
raises ``NotImplementedError``: string min and max need comparisons of
flat strings, which the port does not have yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from .. import types as T
from .arithmetic import Divide
from .cast import Cast
from .expression import Expression


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

    @property
    def nullable(self) -> bool:
        return True


class _SameType(AggregateFunction):
    """An aggregate whose result and one buffer have the child's type."""

    op = ""
    #: What a string child would need, which the port does not have yet.
    string_needs = "comparisons of flat strings"

    @property
    def data_type(self) -> T.DataType:
        return self.child.data_type

    def buffers(self):
        if self.child.data_type is T.STRING:
            raise NotImplementedError(
                f"{self.op} of a string column needs {self.string_needs}, "
                "which are not ported yet")
        return [BufferSpec(self.op, self.op, self.op, self.data_type)]


class Min(_SameType):
    op = "min"


class Max(_SameType):
    op = "max"


class _Positional(_SameType):
    """first/last(expr, ignoreNulls): the value of a group's first or
    last contributing row. The group-by reduces over valid rows only, so
    that row is the first or last non-null one whatever the flag, as in
    the reference, which keeps the flag for the plan's sake."""

    string_needs = "gathers of string rows into group rows"

    def __init__(self, child: Optional[Expression] = None,
                 ignore_nulls: bool = True):
        super().__init__(child)
        self.ignore_nulls = ignore_nulls

    def with_children(self, children):
        return type(self)(children[0], self.ignore_nulls)


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


@dataclasses.dataclass
class AggregateExpression:
    """A named aggregate in an Aggregate node."""
    func: AggregateFunction
    name: str
