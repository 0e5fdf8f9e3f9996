"""Window expressions — port of ``spark_rapids_tpu/ops/windows.py``.

The spec objects have the reference's shape: frame bounds (:class:`Bound`),
ROWS and RANGE frames (:class:`WindowFrame`), ``PARTITION BY`` / ``ORDER
BY`` / frame (:class:`WindowSpec`), the pyspark-style builder
(:class:`Window`), the ranking functions (:class:`RowNumber`,
:class:`Rank`, :class:`DenseRank`) and :class:`WindowExpression`, a
function over a spec. Evaluation is
:class:`~..exec.window_exec.WindowExec`'s: one sort per batch, frame
bounds as index arithmetic and binary searches, aggregates as prefix
sums and sparse tables (:mod:`.kernels.window`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from .. import types as T
from .aggregates import AggregateFunction, Average, Count, Max, Min, Sum
from .expression import Expression


# ---------------------------------------------------------------------------
# Frame boundaries (GpuSpecialFrameBoundary analog, GpuOverrides.scala:523)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Bound:
    kind: str  # "unbounded" | "current" | "offset"
    offset: int = 0  # signed; negative = preceding, positive = following

    def __post_init__(self):
        assert self.kind in ("unbounded", "current", "offset"), self.kind


UNBOUNDED_PRECEDING = Bound("unbounded")
UNBOUNDED_FOLLOWING = Bound("unbounded")
CURRENT_ROW = Bound("current")


def bound_of(v) -> Bound:
    if isinstance(v, Bound):
        return v
    return Bound("offset", int(v))


@dataclasses.dataclass(frozen=True)
class WindowFrame:
    """ROWS or RANGE frame (GpuSpecifiedWindowFrame analog)."""

    frame_type: str  # "rows" | "range"
    lower: Bound
    upper: Bound

    def __post_init__(self):
        assert self.frame_type in ("rows", "range")


#: Spark's default frame with an ORDER BY clause.
DEFAULT_ORDERED_FRAME = WindowFrame("range", UNBOUNDED_PRECEDING, CURRENT_ROW)
#: Spark's frame with no ORDER BY: the whole partition.
WHOLE_PARTITION_FRAME = WindowFrame("rows", UNBOUNDED_PRECEDING,
                                    UNBOUNDED_FOLLOWING)


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """partitionBy / orderBy / frame (WindowSpecDefinition analog)."""

    partition_by: tuple = ()
    order_by: tuple = ()  # tuple[SortOrder]
    frame: Optional[WindowFrame] = None

    def effective_frame(self) -> WindowFrame:
        if self.frame is not None:
            return self.frame
        return DEFAULT_ORDERED_FRAME if self.order_by else WHOLE_PARTITION_FRAME

    def __str__(self) -> str:
        parts = []
        if self.partition_by:
            parts.append("PARTITION BY " + ", ".join(
                str(e) for e in self.partition_by))
        if self.order_by:
            parts.append("ORDER BY " + ", ".join(
                f"{o.child} {'ASC' if o.ascending else 'DESC'}"
                for o in self.order_by))
        if self.frame is not None:
            f = self.frame
            def b(x, lower):
                if x.kind == "unbounded":
                    return "UNBOUNDED " + ("PRECEDING" if lower else "FOLLOWING")
                if x.kind == "current":
                    return "CURRENT ROW"
                return f"{abs(x.offset)} " + \
                    ("PRECEDING" if x.offset < 0 else "FOLLOWING")
            parts.append(f"{f.frame_type.upper()} BETWEEN "
                         f"{b(f.lower, True)} AND {b(f.upper, False)}")
        return " ".join(parts)


class Window:
    """pyspark-style spec builder: ``Window.partition_by("a").order_by("b")
    .rows_between(Window.unbounded_preceding, Window.current_row)``."""

    unbounded_preceding = UNBOUNDED_PRECEDING
    unbounded_following = UNBOUNDED_FOLLOWING
    current_row = CURRENT_ROW

    def __init__(self, spec: WindowSpec = WindowSpec()):
        self._spec = spec

    @staticmethod
    def partition_by(*cols) -> "Window":
        from ..plan.logical import _as_expr
        return Window(WindowSpec(partition_by=tuple(_as_expr(c) for c in cols)))

    partitionBy = partition_by

    def order_by(self, *orders) -> "Window":
        from ..plan.logical import SortOrder, _as_expr
        so = tuple(o if isinstance(o, SortOrder) else SortOrder(_as_expr(o))
                   for o in orders)
        return Window(dataclasses.replace(self._spec, order_by=so))

    orderBy = order_by

    def rows_between(self, lower, upper) -> "Window":
        frame = WindowFrame("rows", bound_of(lower), bound_of(upper))
        return Window(dataclasses.replace(self._spec, frame=frame))

    rowsBetween = rows_between

    def range_between(self, lower, upper) -> "Window":
        frame = WindowFrame("range", bound_of(lower), bound_of(upper))
        return Window(dataclasses.replace(self._spec, frame=frame))

    rangeBetween = range_between

    @property
    def spec(self) -> WindowSpec:
        return self._spec


# ---------------------------------------------------------------------------
# Window functions
# ---------------------------------------------------------------------------


class RowNumber(Expression):
    """row_number() (GpuRowNumber, GpuWindowExpression.scala + registration
    GpuOverrides.scala:573). Frame is ignored (always the partition prefix)."""

    children = ()

    @property
    def data_type(self) -> T.DataType:
        return T.INT

    @property
    def nullable(self) -> bool:
        return False

    def over(self, window) -> "WindowExpression":
        return WindowExpression(self, _spec_of(window))


class Rank(Expression):
    """rank(): 1 + count of rows strictly before the current peer group."""

    children = ()

    @property
    def data_type(self) -> T.DataType:
        return T.INT

    @property
    def nullable(self) -> bool:
        return False

    def over(self, window) -> "WindowExpression":
        return WindowExpression(self, _spec_of(window))


class DenseRank(Expression):
    """dense_rank(): 1 + number of distinct peer groups before this one."""

    children = ()

    @property
    def data_type(self) -> T.DataType:
        return T.INT

    @property
    def nullable(self) -> bool:
        return False

    def over(self, window) -> "WindowExpression":
        return WindowExpression(self, _spec_of(window))


#: functions evaluable over a frame: the windowed aggregates the reference
#: supports (count/sum/min/max/avg — GpuWindowExpression.scala:393) plus the
#: ranking trio above.
WINDOW_AGG_TYPES = (Min, Max, Sum, Count, Average)
RANKING_TYPES = (RowNumber, Rank, DenseRank)


def _spec_of(window) -> WindowSpec:
    if isinstance(window, Window):
        return window.spec
    assert isinstance(window, WindowSpec), window
    return window


class WindowExpression(Expression):
    """function OVER spec — one output column of a Window node."""

    def __init__(self, func: Expression, spec: WindowSpec):
        self.func = func
        self.spec = spec
        self.children = list(func.children)

    def with_children(self, children: List[Expression]):
        return WindowExpression(self.func.with_children(children), self.spec)

    @property
    def data_type(self) -> T.DataType:
        return self.func.data_type

    @property
    def nullable(self) -> bool:
        if isinstance(self.func, RANKING_TYPES) or isinstance(self.func, Count):
            return False
        return True

    def __str__(self) -> str:
        return f"{type(self.func).__name__}() OVER ({self.spec})"


def over(func, window) -> WindowExpression:
    """Attach a window spec to an aggregate function: ``over(Sum(col("x")),
    Window.partition_by("k").order_by("t"))``."""
    assert isinstance(func, WINDOW_AGG_TYPES + RANKING_TYPES), type(func)
    return WindowExpression(func, _spec_of(window))
