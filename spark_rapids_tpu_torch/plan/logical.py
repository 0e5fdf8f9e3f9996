"""Logical plans and the DataFrame API — port of
``spark_rapids_tpu/plan/logical.py``, cut to what the TPC-H queries run:
a device table or a parquet scan, ``select``, ``where``, ``with_column``
(a window expression appends a window column), ``with_windows``, equi
``join`` (inner, left, left_semi, left_anti; the terms of ``on`` that
are not ``left = right`` stay as the join's residual condition),
``cross_join`` (a keyless inner join is one, with its condition),
``group_by(...).agg`` (no keys: a global aggregate), ``distinct``,
``union``, ``sort``, ``limit``, ``repartition`` (hash on columns, or
round-robin) and ``collect``.

Analysis is eager, as in the reference: every node resolves attribute
types against its child's schema and inserts numeric coercion casts when
it is built, so every node knows its output schema.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from .. import types as T
from ..ops import aggregates as AGG
from ..ops import arithmetic as ARITH
from ..ops import predicates as PRED
from ..ops.expression import (Alias, AttributeReference, Expression, col,
                              coerce_binary, lit)


def resolve(expr: Expression, schema: T.Schema) -> Expression:
    """Fill in attribute types from ``schema`` and insert the numeric
    coercion casts of binary arithmetic and comparisons."""

    def fill(e):
        if isinstance(e, AttributeReference):
            f = schema.field_maybe(e.name)
            if f is None:
                raise KeyError(f"column '{e.name}' not found in {schema}")
            return AttributeReference(e.name, f.data_type, f.nullable)
        return None

    def coerce(e):
        if isinstance(e, (ARITH.BinaryArithmetic, PRED.Comparison)):
            l, r = e.children
            if l.data_type.is_numeric and r.data_type.is_numeric \
                    and l.data_type is not r.data_type:
                return type(e)(*coerce_binary(l, r))
        return None

    return expr.transform(fill).transform(coerce)


def _as_expr(c) -> Expression:
    if isinstance(c, Expression):
        return c
    if isinstance(c, str):
        return col(c)
    return lit(c)


@dataclasses.dataclass(frozen=True)
class SortOrder:
    child: Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None  # default: Spark's (first asc, last desc)

    @property
    def effective_nulls_first(self) -> bool:
        return self.ascending if self.nulls_first is None else self.nulls_first


class LogicalPlan:
    children: Sequence["LogicalPlan"] = ()

    @property
    def schema(self) -> T.Schema:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__

    def tree_string(self, indent: int = 0) -> str:
        out = "  " * indent + self.describe() + "\n"
        for c in self.children:
            out += c.tree_string(indent + 1)
        return out


class DeviceRelation(LogicalPlan):
    """A table already uploaded to the device (``create_dataframe``): the
    counterpart of the reference's cached device relation."""

    def __init__(self, batch):
        self.children = []
        self.batch = batch

    @property
    def schema(self) -> T.Schema:
        return self.batch.schema

    def describe(self):
        return f"DeviceRelation[{', '.join(self.schema.names)}]"


class Scan(LogicalPlan):
    """A file scan (``TorchSession.read.parquet``): the files the paths
    named, listed when the reader was called, and the schema of the
    first. The scan decodes every column of that schema, as the
    reference's does (its ``Scan.projected`` is never set): a
    ``Project`` above drops the rest."""

    def __init__(self, fmt: str, files: List[str], schema: T.Schema):
        self.children = []
        self.fmt = fmt
        self.files = list(files)
        self._schema = schema

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def describe(self):
        return f"Scan {self.fmt} [{', '.join(self._schema.names)}] " \
               f"files={len(self.files)}"


class Project(LogicalPlan):
    def __init__(self, child: LogicalPlan, exprs: List[Expression]):
        self.children = [child]
        self.exprs = [resolve(e, child.schema) for e in exprs]

    @property
    def schema(self) -> T.Schema:
        return T.Schema([T.StructField(e.name, e.data_type, e.nullable)
                         for e in self.exprs])

    def describe(self):
        return "Project [" + ", ".join(str(e) for e in self.exprs) + "]"


class Filter(LogicalPlan):
    def __init__(self, child: LogicalPlan, condition: Expression):
        self.children = [child]
        self.condition = resolve(condition, child.schema)
        if self.condition.data_type is not T.BOOLEAN:
            raise TypeError(f"filter condition must be boolean, got "
                            f"{self.condition.data_type}")

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    def describe(self):
        return f"Filter ({self.condition})"


class Aggregate(LogicalPlan):
    def __init__(self, child: LogicalPlan, groupings: List[Expression],
                 aggregates: List[AGG.AggregateExpression]):
        self.children = [child]
        self.groupings = [resolve(g, child.schema) for g in groupings]
        self.aggregates = [
            AGG.AggregateExpression(resolve(a.func, child.schema), a.name)
            for a in aggregates]

    @property
    def schema(self) -> T.Schema:
        fields = [T.StructField(g.name, g.data_type, g.nullable)
                  for g in self.groupings]
        fields += [T.StructField(a.name, a.func.data_type, a.func.nullable)
                   for a in self.aggregates]
        return T.Schema(fields)

    def describe(self):
        return ("Aggregate [" + ", ".join(str(g) for g in self.groupings)
                + "], [" + ", ".join(f"{a.func} AS {a.name}"
                                     for a in self.aggregates) + "]")


class Join(LogicalPlan):
    """Equi join (inner, left, left_semi, left_anti) or cross join (no
    keys): left is the probe side, right the build side. ``condition``,
    over both sides' columns, is a cross join's filter or an equi join's
    residual, which a matching pair must also pass. A left join's
    build-side fields are nullable."""

    TYPES = ("inner", "left", "left_semi", "left_anti", "cross")

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 join_type: str, left_keys: List[Expression],
                 right_keys: List[Expression],
                 condition: Optional[Expression] = None):
        if join_type not in self.TYPES:
            raise NotImplementedError(
                f"{join_type} joins are not ported yet")
        if (join_type == "cross") != (not left_keys):
            raise ValueError("a cross join takes no keys; every other join "
                             "needs them")
        self.children = [left, right]
        self.join_type = join_type
        lk, rk = [], []
        for l, r in zip(left_keys, right_keys):
            l, r = resolve(l, left.schema), resolve(r, right.schema)
            if l.data_type is not r.data_type:
                l, r = coerce_binary(l, r)
            lk.append(l)
            rk.append(r)
        self.left_keys, self.right_keys = lk, rk
        if condition is not None:
            condition = resolve(condition, T.Schema(list(left.schema)
                                                    + list(right.schema)))
        self.condition = condition

    @property
    def schema(self) -> T.Schema:
        left, right = self.children
        if self.join_type in ("left_semi", "left_anti"):
            return left.schema
        rf = [T.StructField(f.name, f.data_type,
                            f.nullable or self.join_type == "left")
              for f in right.schema]
        return T.Schema(list(left.schema) + rf)

    def describe(self):
        keys = ", ".join(f"{l}={r}" for l, r in
                         zip(self.left_keys, self.right_keys))
        return f"Join {self.join_type} [{keys}]"


class Union(LogicalPlan):
    """``UNION ALL`` of children with the same column types: the first
    child's names, each field nullable when it is in any child."""

    def __init__(self, children: List[LogicalPlan]):
        self.children = list(children)
        s0 = self.children[0].schema
        for c in self.children[1:]:
            if [f.data_type.name for f in c.schema] != \
                    [f.data_type.name for f in s0]:
                raise TypeError("union requires matching column types")

    @property
    def schema(self) -> T.Schema:
        first = self.children[0].schema
        nullable = [any(c.schema[i].nullable for c in self.children)
                    for i in range(len(first))]
        return T.Schema([T.StructField(f.name, f.data_type, n)
                         for f, n in zip(first, nullable)])


class WindowOp(LogicalPlan):
    """Append window-expression columns (Spark's Window node; planned as
    :class:`~..exec.window_exec.WindowExec`). ``window_exprs`` is a list
    of ``(name, WindowExpression)``; functions, partition keys and order
    keys resolve against the child's schema."""

    def __init__(self, child: LogicalPlan, window_exprs):
        from ..ops import windows as W
        self.children = [child]
        resolved = []
        for name, we in window_exprs:
            func = we.func
            if func.children:
                func = func.with_children(
                    [resolve(c, child.schema) for c in func.children])
            spec = W.WindowSpec(
                tuple(resolve(e, child.schema) for e in we.spec.partition_by),
                tuple(SortOrder(resolve(o.child, child.schema), o.ascending,
                                o.nulls_first) for o in we.spec.order_by),
                we.spec.frame)
            resolved.append((name, W.WindowExpression(func, spec)))
        self.window_exprs = resolved

    @property
    def schema(self) -> T.Schema:
        fields = list(self.children[0].schema)
        fields += [T.StructField(name, we.data_type, we.nullable)
                   for name, we in self.window_exprs]
        return T.Schema(fields)

    def describe(self):
        return "Window [" + ", ".join(n for n, _ in self.window_exprs) + "]"


class Sort(LogicalPlan):
    def __init__(self, child: LogicalPlan, orders: List[SortOrder]):
        self.children = [child]
        self.orders = [SortOrder(resolve(o.child, child.schema), o.ascending,
                                 o.nulls_first) for o in orders]

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    def describe(self):
        return "Sort [" + ", ".join(
            f"{o.child} {'ASC' if o.ascending else 'DESC'}"
            for o in self.orders) + "]"


class Repartition(LogicalPlan):
    """Redistribute rows over ``n_parts`` partitions: ``hash`` on ``keys``
    (Spark's murmur3 pmod n) or ``round_robin``."""

    def __init__(self, child: LogicalPlan, n_parts: int, mode: str,
                 keys: Optional[List[Expression]] = None):
        if mode not in ("hash", "round_robin"):
            raise NotImplementedError(f"{mode} repartitioning is not ported")
        if n_parts < 1:
            raise ValueError(f"repartition needs n_parts >= 1, got {n_parts}")
        self.children = [child]
        self.n_parts = n_parts
        self.mode = mode
        self.keys = [resolve(k, child.schema) for k in (keys or [])]

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    def describe(self):
        keys = ", ".join(str(k) for k in self.keys)
        return f"Repartition {self.mode} {self.n_parts} [{keys}]"


class Limit(LogicalPlan):
    def __init__(self, child: LogicalPlan, n: int):
        self.children = [child]
        self.n = n

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    def describe(self):
        return f"Limit {self.n}"


def split_join_condition(cond: Expression, lschema: T.Schema,
                         rschema: T.Schema):
    """Equi key pairs of a conjunction of ``left = right`` terms, and the
    conjunction of the other terms (None when there are none)."""
    conjuncts: List[Expression] = []

    def flatten(e):
        if isinstance(e, PRED.And):
            flatten(e.children[0])
            flatten(e.children[1])
        else:
            conjuncts.append(e)
    flatten(cond)
    lnames, rnames = set(lschema.names), set(rschema.names)
    lk, rk = [], []
    residual = None
    for c in conjuncts:
        if isinstance(c, PRED.EqualTo):
            a, b = c.children
            ar, br = set(a.references()), set(b.references())
            if ar and br and ar <= lnames and br <= rnames:
                lk.append(a)
                rk.append(b)
                continue
            if ar and br and ar <= rnames and br <= lnames:
                lk.append(b)
                rk.append(a)
                continue
        residual = c if residual is None else PRED.And(residual, c)
    return lk, rk, residual


class GroupedData:
    """``group_by(*keys)``; no keys makes ``agg`` a global aggregate."""

    def __init__(self, df: "DataFrame", keys: List[Expression]):
        self._df = df
        self._keys = keys

    def agg(self, *aggs: AGG.AggregateExpression) -> "DataFrame":
        return DataFrame(Aggregate(self._df._plan, self._keys, list(aggs)),
                         self._df._session)


class DataFrame:
    def __init__(self, plan: LogicalPlan, session):
        self._plan = plan
        self._session = session

    @property
    def schema(self) -> T.Schema:
        return self._plan.schema

    @property
    def columns(self) -> List[str]:
        return self._plan.schema.names

    def select(self, *cols) -> "DataFrame":
        exprs = []
        for c in cols:
            e = _as_expr(c)
            if not isinstance(e, (Alias, AttributeReference)):
                e = Alias(e, e.name)
            exprs.append(e)
        return DataFrame(Project(self._plan, exprs), self._session)

    def where(self, condition: Expression) -> "DataFrame":
        return DataFrame(Filter(self._plan, condition), self._session)

    def with_column(self, name: str, expr) -> "DataFrame":
        """Add or replace the column ``name``. A window expression appends
        a window column, whose name must be new."""
        from ..ops.windows import WindowExpression
        e = _as_expr(expr)
        if isinstance(e, WindowExpression):
            if name in self.columns:
                raise ValueError(
                    f"window column '{name}' must introduce a new name")
            return DataFrame(WindowOp(self._plan, [(name, e)]),
                             self._session)
        exprs = [col(n) for n in self.columns if n != name]
        exprs.append(Alias(e, name))
        return DataFrame(Project(self._plan, exprs), self._session)

    def with_windows(self, **name_to_window_expr) -> "DataFrame":
        """Append several window columns in one Window node."""
        return DataFrame(WindowOp(self._plan,
                                  list(name_to_window_expr.items())),
                         self._session)

    def group_by(self, *keys) -> GroupedData:
        return GroupedData(self, [_as_expr(k) for k in keys])

    def join(self, other: "DataFrame", on: Optional[Expression] = None,
             how: str = "inner") -> "DataFrame":
        """Equi join on the ``left = right`` terms of ``on``; its other
        terms are the join's residual condition. An inner join with no
        equi term is a cross join filtered by ``on``."""
        if on is None:
            jt = "cross" if how in ("inner", "cross") else how
            return DataFrame(Join(self._plan, other._plan, jt, [], []),
                             self._session)
        lk, rk, residual = split_join_condition(on, self.schema,
                                                other.schema)
        if not lk and how == "inner":
            plan = Join(self._plan, other._plan, "cross", [], [], residual)
        else:
            plan = Join(self._plan, other._plan, how, lk, rk, residual)
        return DataFrame(plan, self._session)

    def cross_join(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(Join(self._plan, other._plan, "cross", [], []),
                         self._session)

    def distinct(self) -> "DataFrame":
        """The distinct rows: an aggregate over every column with no
        aggregate expressions."""
        return DataFrame(
            Aggregate(self._plan, [col(n) for n in self.columns], []),
            self._session)

    def union(self, other: "DataFrame") -> "DataFrame":
        """``UNION ALL``: this frame's rows, then ``other``'s."""
        return DataFrame(Union([self._plan, other._plan]), self._session)

    def sort(self, *orders) -> "DataFrame":
        so = [o if isinstance(o, SortOrder) else SortOrder(_as_expr(o))
              for o in orders]
        return DataFrame(Sort(self._plan, so), self._session)

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(Limit(self._plan, n), self._session)

    def repartition(self, n_parts: int, *cols) -> "DataFrame":
        """Hash-repartition on columns, or round-robin without columns."""
        if cols:
            plan = Repartition(self._plan, n_parts, "hash",
                               keys=[_as_expr(c) for c in cols])
        else:
            plan = Repartition(self._plan, n_parts, "round_robin")
        return DataFrame(plan, self._session)

    def collect(self):
        """Run the query; returns a :class:`~..data.batch.HostBatch`
        (``columns`` and ``validity``, dicts of numpy arrays)."""
        return self._session.execute(self._plan)

    def explain(self) -> str:
        return self._session.explain(self._plan)
