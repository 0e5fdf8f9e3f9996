"""Logical plans and the DataFrame API — port of
``spark_rapids_tpu/plan/logical.py``, cut to what the TPC-H queries run:
a device table or a parquet scan, ``select``, ``where``, ``with_column``
(a window expression appends a window column), ``with_windows``, equi
``join`` (inner, left, right, full, left_semi, left_anti; the terms of
``on`` that are not ``left = right`` stay as the join's residual
condition; column names are SQL's ``USING``), ``cross_join`` (a
keyless inner join is one, with its condition), ``group_by(...).agg``
(no keys: a global aggregate), ``rollup``, ``cube`` and
``grouping_sets`` (Expand + Aggregate), ``distinct``, ``union``,
``sort``, ``limit``, ``repartition`` (hash on columns, or round-robin),
``explode`` (Generate) and ``collect``.

Analysis is eager, as in the reference: every node resolves attribute
types against its child's schema and inserts numeric coercion casts when
it is built, so every node knows its output schema.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from .. import types as T
from ..ops import aggregates as AGG
from ..ops import arithmetic as ARITH
from ..ops import predicates as PRED
from ..ops.expression import (Alias, AttributeReference, Expression,
                              Literal, col, coerce_binary, lit)


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
        from ..ops import complex as CPX
        if isinstance(e, CPX.CreateArray):
            return _coerce_array_elements(e)
        if isinstance(e, (ARITH.BinaryArithmetic, PRED.Comparison)):
            l, r = e.children
            if l.data_type.is_numeric and r.data_type.is_numeric \
                    and l.data_type is not r.data_type:
                return type(e)(*coerce_binary(l, r))
        return None

    return expr.transform(fill).transform(coerce)


def _coerce_array_elements(e):
    """``array(...)`` of mixed numeric elements with each cast to their
    promoted type (the reference's ``logical.py`` coercion); an element
    type without a device layout raises with the reference's reason."""
    from ..ops import complex as CPX
    from ..ops.cast import Cast
    types = [c.data_type for c in e.children]
    if any(not T.device_supported(T.ArrayType(t)) for t in types):
        raise NotImplementedError(
            f"array of {types[0]}: arrays hold fixed-width elements only "
            "(the reference's types.device_supported)")
    if len({t.name for t in types}) == 1:
        return None
    if not all(t.is_numeric for t in types):
        raise TypeError(f"array elements must share one type, got {types}")
    common = types[0]
    for t in types[1:]:
        common = T.numeric_promote(common, t)
    return CPX.CreateArray(*[c if c.data_type.name == common.name
                             else Cast(c, common) for c in e.children])


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
    """A file scan (``TorchSession.read.parquet``, ``.orc``, ``.csv``):
    the files the paths named, listed when the reader was called, the
    reader's options, and the schema of the first file followed by the
    hive partition columns (``n_part`` of them; ``part_values`` holds
    each file's). The scan decodes every column of that schema, as the
    reference's does (its ``Scan.projected`` is never set): a
    ``Project`` above drops the rest."""

    def __init__(self, fmt: str, files: List[str], schema: T.Schema,
                 options: Optional[dict] = None,
                 part_values: Optional[List[tuple]] = None,
                 n_part: int = 0):
        self.children = []
        self.fmt = fmt
        self.files = list(files)
        self._schema = schema
        self.options = dict(options or {})
        self.part_values = list(part_values or [() for _ in self.files])
        self.n_part = n_part
        #: Set by the input-file rewrite (``plan/input_file.py``): the
        #: schema ends in its three hidden per-file columns.
        self.emit_file_meta = False

    @property
    def schema(self) -> T.Schema:
        return self._schema

    def with_schema(self, schema: T.Schema) -> "Scan":
        """This scan with another schema (the input-file rewrite's)."""
        return Scan(self.fmt, self.files, schema, self.options,
                    self.part_values, self.n_part)

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
    """Equi join (inner, left, right, full, left_semi, left_anti) or
    cross join (no keys): left is the probe side, right the build side.
    ``condition``, over both sides' columns, is a cross join's filter or
    an equi join's residual, which a matching pair must also pass. An
    outer join makes the other side's fields nullable (both sides' for a
    full join)."""

    TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti",
             "cross")

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 join_type: str, left_keys: List[Expression],
                 right_keys: List[Expression],
                 condition: Optional[Expression] = None):
        if join_type not in self.TYPES:
            raise NotImplementedError(
                f"{join_type} joins are not ported yet")
        if join_type in ("right", "full") and not left_keys:
            raise NotImplementedError(
                f"non-equi {join_type} outer joins are not supported")
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
        jt = self.join_type
        lf = [T.StructField(f.name, f.data_type,
                            f.nullable or jt in ("right", "full"))
              for f in left.schema]
        rf = [T.StructField(f.name, f.data_type,
                            f.nullable or jt in ("left", "full"))
              for f in right.schema]
        return T.Schema(lf + rf)

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


class Expand(LogicalPlan):
    """Several projections of every input row, one output row each (the
    grouping sets of rollup, cube and ``grouping_sets``; Spark's Expand).
    Field ``i`` takes the first projection's type and is nullable when
    any projection's expression ``i`` is."""

    def __init__(self, child: LogicalPlan,
                 projections: List[List[Expression]], names: List[str]):
        self.children = [child]
        self.projections = [[resolve(e, child.schema) for e in proj]
                            for proj in projections]
        self.names = list(names)

    @property
    def schema(self) -> T.Schema:
        return T.Schema([
            T.StructField(name, self.projections[0][i].data_type,
                          any(p[i].nullable for p in self.projections))
            for i, name in enumerate(self.names)])

    def describe(self):
        return f"Expand [{len(self.projections)} projections]"


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


class Generate(LogicalPlan):
    """One input row to zero or more output rows from an array generator
    (``explode`` / ``posexplode``, the reference's ``Generate``): the
    child's columns, then ``pos`` when asked, then the element."""

    def __init__(self, child: LogicalPlan, generator: Expression,
                 elem_name: str = "col", outer: bool = False,
                 pos: bool = False, pos_name: str = "pos"):
        self.children = [child]
        self.generator = resolve(generator, child.schema)
        if not isinstance(self.generator.data_type, T.ArrayType):
            raise TypeError(f"explode needs an array column, got "
                            f"{self.generator.data_type}")
        self.elem_name = elem_name
        self.outer = outer
        self.pos = pos
        self.pos_name = pos_name

    @property
    def schema(self) -> T.Schema:
        fields = list(self.children[0].schema)
        if self.pos:
            fields.append(T.StructField(self.pos_name, T.INT, self.outer))
        at = self.generator.data_type
        fields.append(T.StructField(self.elem_name, at.element_type,
                                    at.contains_null or self.outer))
        return T.Schema(fields)

    def describe(self):
        kind = "posexplode" if self.pos else "explode"
        return f"Generate [{kind}{'_outer' if self.outer else ''}" \
               f"({self.generator})]"


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
    """``group_by(*keys)``; no keys makes ``agg`` a global aggregate.
    With ``sets`` (each a tuple of key positions) it is GROUPING SETS:
    an :class:`Expand` with one projection per set, the absent keys
    null, and a grouping-id column, under an Aggregate over the keys and
    that id. Spark's grouping id sets bit ``i`` when key ``i`` is absent,
    the first key the most significant bit; ``gid_name`` keeps it as an
    output column."""

    def __init__(self, df: "DataFrame", keys: List[Expression],
                 sets: Optional[List[Tuple[int, ...]]] = None,
                 gid_name: Optional[str] = None):
        self._df = df
        self._keys = keys
        self._sets = sets
        self._gid_name = gid_name

    def agg(self, *aggs: AGG.AggregateExpression) -> "DataFrame":
        if self._sets is None:
            return DataFrame(Aggregate(self._df._plan, self._keys,
                                       list(aggs)), self._df._session)
        return self._agg_grouping_sets(list(aggs))

    def _agg_grouping_sets(self, aggs) -> "DataFrame":
        child = self._df._plan
        keys = [resolve(k, child.schema) for k in self._keys]
        key_names = [k.name for k in keys]
        passthrough = [n for n in child.schema.names if n not in key_names]
        gid_name = self._gid_name or "__grouping_id"
        n = len(keys)
        projections = []
        for s in self._sets:
            member = set(s)
            proj = [k if i in member else Literal(None, k.data_type)
                    for i, k in enumerate(keys)]
            proj += [col(c) for c in passthrough]
            gid = sum((0 if i in member else 1) << (n - 1 - i)
                      for i in range(n))
            proj.append(Literal(gid, T.INT))
            projections.append(proj)
        expanded = Expand(child, projections,
                          key_names + passthrough + [gid_name])
        plan = Aggregate(expanded, [col(c) for c in key_names + [gid_name]],
                         aggs)
        out = DataFrame(plan, self._df._session)
        if self._gid_name is None:
            out = out.select(*[col(c) for c in plan.schema.names
                               if c != gid_name])
        return out


class WriteOp(LogicalPlan):
    """Write the child to files (the reference's ``WriteOp``, Spark's
    ``InsertIntoHadoopFsRelationCommand``); its output is the one-row
    write stats."""

    FORMATS = ("parquet", "orc", "csv")

    def __init__(self, child: LogicalPlan, fmt: str, path: str,
                 options: dict, partition_by: List[str], mode: str):
        from ..io.writers import MODES
        if fmt not in self.FORMATS:
            raise ValueError(f"unsupported write format '{fmt}'; choose "
                             f"from {self.FORMATS}")
        if mode not in MODES:
            raise ValueError(f"unknown save mode '{mode}'; choose from "
                             f"{MODES}")
        self.children = [child]
        self.fmt = fmt
        self.path = path
        self.options = dict(options)
        self.partition_by = list(partition_by)
        self.mode = mode
        for c in self.partition_by:
            if child.schema.field_maybe(c) is None:
                raise KeyError(f"partitionBy column '{c}' not in "
                               f"{child.schema}")

    @property
    def schema(self) -> T.Schema:
        from ..io.writers import STATS_SCHEMA
        return STATS_SCHEMA

    def describe(self):
        return f"WriteFiles {self.fmt} {self.path}"


class DataFrameWriter:
    """``df.write`` (Spark's ``DataFrameWriter``): ``mode``, ``option``,
    ``partitionBy``, then ``parquet``, ``orc`` or ``csv``, which run the
    write and return the stats row (a ``HostBatch``: files,
    partitions, rows, bytes)."""

    def __init__(self, df: "DataFrame"):
        self._df = df
        self._mode = "error"
        self._options: dict = {}
        self._partition_by: List[str] = []

    def mode(self, m: str) -> "DataFrameWriter":
        self._mode = m
        return self

    def option(self, key: str, value) -> "DataFrameWriter":
        self._options[key] = value
        return self

    def partition_by(self, *cols: str) -> "DataFrameWriter":
        self._partition_by = list(cols)
        return self

    partitionBy = partition_by

    def _write(self, fmt: str, path: str):
        plan = WriteOp(self._df._plan, fmt, path, self._options,
                       self._partition_by, self._mode)
        return self._df._session.execute(plan)

    def parquet(self, path: str):
        return self._write("parquet", path)

    def orc(self, path: str):
        return self._write("orc", path)

    def csv(self, path: str):
        return self._write("csv", path)


class DataFrame:
    def __init__(self, plan: LogicalPlan, session):
        self._plan = plan
        self._session = session

    @property
    def write(self) -> DataFrameWriter:
        return DataFrameWriter(self)

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

    def rollup(self, *keys, grouping_id: Optional[str] = None
               ) -> GroupedData:
        """GROUP BY ROLLUP: the grouping sets are every prefix of the
        keys, from all of them down to the grand total."""
        ks = [_as_expr(k) for k in keys]
        sets = [tuple(range(i)) for i in range(len(ks), -1, -1)]
        return GroupedData(self, ks, sets=sets, gid_name=grouping_id)

    def cube(self, *keys, grouping_id: Optional[str] = None) -> GroupedData:
        """GROUP BY CUBE: the grouping sets are every subset of the keys."""
        ks = [_as_expr(k) for k in keys]
        n = len(ks)
        sets = [tuple(i for i in range(n) if mask & (1 << i))
                for mask in range((1 << n) - 1, -1, -1)]
        return GroupedData(self, ks, sets=sets, gid_name=grouping_id)

    def grouping_sets(self, sets: List[List[str]], *keys,
                      grouping_id: Optional[str] = None) -> GroupedData:
        """GROUPING SETS over the named ``keys``; each set lists the key
        names present in it."""
        ks = [_as_expr(k) for k in keys]
        idx = {resolve(k, self.schema).name: i for i, k in enumerate(ks)}
        resolved = [tuple(sorted(idx[nm] for nm in s)) for s in sets]
        return GroupedData(self, ks, sets=resolved, gid_name=grouping_id)

    def join(self, other: "DataFrame", on=None,
             how: str = "inner") -> "DataFrame":
        """Equi join on the ``left = right`` terms of ``on``; its other
        terms are the join's residual condition. An inner join with no
        equi term is a cross join filtered by ``on``. A column name or a
        list of them is SQL's ``USING``: each name is the key on both
        sides, and both sides' key columns stay in the output (an inner,
        outer or right join yields the name twice; a later ``col(name)``
        reads the left one)."""
        if on is None:
            jt = "cross" if how in ("inner", "cross") else how
            return DataFrame(Join(self._plan, other._plan, jt, [], []),
                             self._session)
        if isinstance(on, str):
            on = [on]
        if isinstance(on, (list, tuple)):
            if not on or not all(isinstance(k, str) for k in on):
                raise TypeError(f"join on: expected column names, got {on!r}")
            keys = [col(k) for k in on]
            return DataFrame(Join(self._plan, other._plan, how, keys, keys),
                             self._session)
        if not isinstance(on, Expression):
            raise TypeError(f"unsupported join on: {on!r}")
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

    def explode(self, column, name: str = "col", outer: bool = False,
                pos: bool = False) -> "DataFrame":
        """One output row per array element (explode / posexplode, and
        their ``_outer`` forms); the other columns repeat. ``outer`` keeps
        a null or empty array's row with a null element; ``pos`` adds the
        element's position as ``pos``."""
        return DataFrame(Generate(self._plan, _as_expr(column),
                                  elem_name=name, outer=outer, pos=pos),
                         self._session)

    def collect(self):
        """Run the query; returns a :class:`~..data.batch.HostBatch`
        (``columns`` and ``validity``, dicts of numpy arrays)."""
        return self._session.execute(self._plan)

    def explain(self, metrics: bool = False) -> str:
        """The physical plan tree. ``metrics=True`` annotates every
        operator with the metrics of this session's last run of the same
        plan shape (run ``.collect()`` first)."""
        if metrics:
            return self._session.explain_metrics(self._plan)
        return self._session.explain(self._plan)
