"""Logical -> physical planning — port of the parts of
``spark_rapids_tpu/plan/planner.py`` and ``plan/overrides.py`` that the
port's TPC-H queries need. Every logical node maps to its device exec
directly (the port has no CPU operators to replace); a parquet scan
plans as :class:`~..io.parquet_device.ParquetScanExec`, which decodes on
the device (``planner.py:112`` and ``overrides`` in the reference); a
keyless join
plans as the nested-loop join (``planner.py:_plan_join``,
``overrides.py:_make_nlj``); ``ORDER BY ... LIMIT n`` with ``n`` at or
below ``spark.rapids.tpu.sort.topKThreshold`` plans as a top-k, as the
reference's limit-into-sort rule does; a repartition plans as the
shuffle exchange (``planner.py:140-146`` plans it on the CPU and
``overrides`` moves it to the device); a window node plans as
:class:`~..exec.window_exec.WindowExec` (``overrides.py:518``); a union
as :class:`~..exec.execs.UnionExec`. An equi join with a residual
condition keeps its keys and takes the condition into the hash join
(:func:`~..exec.execs.join_exact`), whatever its type: the reference
plans a non-inner one as a nested-loop join on the CPU
(``planner.py:52-70``), whose pair grid a TPCxBB click-to-sale join
makes too large to run.

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

from ..config import PARQUET_REBASE_READ, TOPK_THRESHOLD, TorchConf
from ..exec import execs as E
from ..io.parquet_device import ParquetScanExec
from ..exec.joins import NestedLoopJoinExec
from ..exec.window_exec import WindowExec
from ..shuffle.exchange import ShuffleExchangeExec
from ..shuffle.partitioners import partitioner_factory
from . import logical as L


def plan_physical(plan: L.LogicalPlan, conf: TorchConf) -> E.TorchExec:
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


def _plan_node(plan: L.LogicalPlan, conf: TorchConf, sub) -> E.TorchExec:
    """One logical node's exec, its children planned by
    ``sub(child)``."""
    if isinstance(plan, L.DeviceRelation):
        return E.DeviceSourceExec(plan.batch)
    if isinstance(plan, L.Scan):
        if plan.fmt != "parquet":
            raise NotImplementedError(f"{plan.fmt} scans are not ported")
        return ParquetScanExec(plan.files, plan.schema,
                               conf.get(PARQUET_REBASE_READ))
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
        return E.ShuffledHashJoinExec(
            sub(plan.children[0]),
            sub(plan.children[1]), plan.join_type,
            plan.left_keys, plan.right_keys, plan.schema, plan.condition)
    if isinstance(plan, L.Union):
        return E.UnionExec([sub(c) for c in plan.children], plan.schema)
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
