"""Logical -> physical planning — port of the parts of
``spark_rapids_tpu/plan/planner.py`` and ``plan/overrides.py`` that the
port's TPC-H queries need. Every logical node maps to its device exec
directly (the port has no CPU operators to replace); a parquet scan
plans as :class:`~..io.parquet_device.ParquetScanExec`, which decodes on
the device (``planner.py:112`` and ``overrides`` in the reference); a
keyless join
plans as the nested-loop join (``planner.py:_plan_join``,
``overrides.py:_make_nlj``); an Expand (rollup, cube, grouping sets)
plans as :class:`~..exec.execs.ExpandExec`; ``ORDER BY ... LIMIT n``
with ``n`` at or below ``spark.rapids.tpu.sort.topKThreshold`` plans as
a top-k, as the reference's limit-into-sort rule does; a repartition
plans as the shuffle exchange (``planner.py:140-146`` plans it on the
CPU and ``overrides`` moves it to the device); a window node plans as
:class:`~..exec.window_exec.WindowExec` (``overrides.py:518``); a union
as :class:`~..exec.execs.UnionExec`. An equi join with a residual
condition keeps its keys and takes the condition into the hash join
(:func:`~..exec.execs.join_exact`), whatever its type but right and
full, which raise as the reference's planner does: the reference
plans a non-inner one as a nested-loop join on the CPU
(``planner.py:52-70``), whose pair grid a TPCxBB click-to-sale join
makes too large to run.

A Generate (``explode``) plans as :class:`~..exec.execs.GenerateExec`.
An array or struct grouping, join, sort or window key raises
``NotImplementedError`` with the reference's reason
(``overrides.py _no_complex_keys``), as does ``split`` (ARRAY<STRING>
has no device layout; ``overrides.py:164-170`` sends it to the host
path, which the port does not have).

A subplan that the query references more than once (Q15's revenue
view, Q22's filtered customers) plans once, as one
:class:`~..exec.execs.ReusedExec` that every reference reads (Spark's
exchange and subquery reuse): on the card its float sums add in atomic
order, so two evaluations could differ in their last bits, and a query
that compares one with the other (Q15's ``total_revenue =
max_revenue``) would lose rows. Tables and scans are read where they
are referenced.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

from .. import types as T
from ..config import (BATCH_SIZE_ROWS, PARQUET_REBASE_READ, TOPK_THRESHOLD,
                      TorchConf)
from ..exec import execs as E
from ..exec.coalesce import insert_coalesce
from ..io.parquet_device import ParquetScanExec
from ..exec.joins import NestedLoopJoinExec
from ..exec.window_exec import WindowExec
from ..shuffle.exchange import ShuffleExchangeExec
from ..shuffle.partitioners import partitioner_factory
from . import logical as L


def plan_physical(plan: L.LogicalPlan, conf: TorchConf
                  ) -> E.DeviceToHostExec:
    """The physical plan of ``plan``: its device plan with coalesce
    nodes where the operators' batch goals ask for them
    (:func:`..exec.coalesce.insert_coalesce` at
    ``spark.rapids.sql.batchSizeRows``, the reference's
    ``overrides.py:772-774``) under a :class:`~..exec.execs.
    DeviceToHostExec` root (``overrides.py:795,806``)."""
    device = insert_coalesce(_device_plan(plan, conf),
                             int(conf.get(BATCH_SIZE_ROWS)))
    return E.DeviceToHostExec(device)


def _device_plan(plan: L.LogicalPlan, conf: TorchConf) -> E.TorchExec:
    refs: Counter = Counter()

    def count(node):
        refs[id(node)] += 1
        if refs[id(node)] == 1:
            for c in node.children:
                count(c)
    count(plan)
    memo: Dict[int, E.TorchExec] = {}

    def build(node):
        if id(node) not in memo:
            ex = _plan_node(node, conf, build)
            if refs[id(node)] > 1 and not isinstance(
                    node, (L.DeviceRelation, L.Scan)):
                ex = E.ReusedExec(ex)
            memo[id(node)] = ex
        return memo[id(node)]
    return build(plan)


def _no_complex_keys(exprs, what: str) -> None:
    """Raise for an array or struct key, with the reference's reason
    (``plan/overrides.py _no_complex_keys``): its device path has no
    operator for one, and the port has no host path to hand it to."""
    for e in exprs:
        if T.is_complex(e.data_type):
            raise NotImplementedError(
                f"{what} of type {e.data_type} is not supported on the "
                "device (the reference's plan/overrides.py "
                "_no_complex_keys tags it off the device)")


def _no_string_split(exprs) -> None:
    """Raise for ``split``, whose ARRAY<STRING> has no device layout."""
    from ..ops.strings2 import StringSplit
    for e in exprs:
        if isinstance(e, StringSplit):
            raise NotImplementedError(StringSplit.REASON)
        _no_string_split(e.children)


def _node_keys(plan: L.LogicalPlan) -> None:
    """The key checks of one logical node (see :func:`_no_complex_keys`)."""
    if isinstance(plan, L.Aggregate):
        _no_complex_keys(plan.groupings, "grouping key")
    elif isinstance(plan, L.Join):
        _no_complex_keys(list(plan.left_keys) + list(plan.right_keys),
                         "join key")
    elif isinstance(plan, L.Sort):
        _no_complex_keys([o.child for o in plan.orders], "sort key")
    elif isinstance(plan, L.Limit) and isinstance(plan.children[0], L.Sort):
        _node_keys(plan.children[0])
    elif isinstance(plan, L.WindowOp):
        for _, we in plan.window_exprs:
            _no_complex_keys(we.spec.partition_by, "window partition key")
            _no_complex_keys([o.child for o in we.spec.order_by],
                             "window order-by key")
    elif isinstance(plan, L.Project):
        _no_string_split(plan.exprs)
    elif isinstance(plan, L.Filter):
        _no_string_split([plan.condition])


def _plan_node(plan: L.LogicalPlan, conf: TorchConf, sub) -> E.TorchExec:
    """One logical node's exec, its children planned by
    ``sub(child)``."""
    _node_keys(plan)
    if isinstance(plan, L.DeviceRelation):
        return E.DeviceSourceExec(plan.batch)
    if isinstance(plan, L.Scan):
        if plan.fmt != "parquet":
            raise NotImplementedError(f"{plan.fmt} scans are not ported")
        return ParquetScanExec(plan.files, plan.schema,
                               conf.get(PARQUET_REBASE_READ),
                               emit_file_meta=plan.emit_file_meta)
    if isinstance(plan, L.Project):
        return E.ProjectExec(sub(plan.children[0]),
                             plan.exprs)
    if isinstance(plan, L.Filter):
        return E.FilterExec(sub(plan.children[0]),
                            plan.condition)
    if isinstance(plan, L.Aggregate):
        return E.HashAggregateExec(sub(plan.children[0]),
                                   plan.groupings, plan.aggregates)
    if isinstance(plan, L.Join) and plan.join_type == "cross":
        return NestedLoopJoinExec(
            sub(plan.children[0]),
            sub(plan.children[1]), plan.condition,
            plan.schema)
    if isinstance(plan, L.Join):
        if plan.join_type in ("right", "full") and \
                plan.condition is not None:
            # the reference plans a non-inner join with a residual as a
            # nested-loop join, which takes no outer build side
            raise NotImplementedError(
                f"non-equi {plan.join_type} outer joins are not supported")
        return E.ShuffledHashJoinExec(
            sub(plan.children[0]),
            sub(plan.children[1]), plan.join_type,
            plan.left_keys, plan.right_keys, plan.schema, plan.condition)
    if isinstance(plan, L.Generate):
        return E.GenerateExec(sub(plan.children[0]), plan.generator,
                              plan.outer, plan.pos, plan.schema)
    if isinstance(plan, L.Union):
        return E.UnionExec([sub(c) for c in plan.children], plan.schema)
    if isinstance(plan, L.Expand):
        return E.ExpandExec(sub(plan.children[0]), plan.projections,
                            plan.schema)
    if isinstance(plan, L.WindowOp):
        return WindowExec(sub(plan.children[0]),
                          plan.window_exprs, plan.schema)
    if isinstance(plan, L.Repartition):
        return ShuffleExchangeExec(
            sub(plan.children[0]),
            partitioner_factory(plan.mode, plan.n_parts, keys=plan.keys),
            plan.n_parts)
    if isinstance(plan, L.Sort):
        return E.SortExec(sub(plan.children[0]), plan.orders)
    if isinstance(plan, L.Limit):
        child = plan.children[0]
        threshold = conf.get(TOPK_THRESHOLD)
        if isinstance(child, L.Sort) and 0 < plan.n <= threshold:
            return E.TopKExec(sub(child.children[0]),
                              child.orders, plan.n)
        return E.LimitExec(sub(child), plan.n)
    raise NotImplementedError(f"no physical plan for {type(plan).__name__}")
