"""Logical -> physical planning — port of the parts of
``spark_rapids_tpu/plan/planner.py`` and ``plan/overrides.py`` that the
port's TPC-H queries need. Every logical node maps to its device exec
directly (the port has no CPU operators to replace); a keyless join
plans as the nested-loop join (``planner.py:_plan_join``,
``overrides.py:_make_nlj``); ``ORDER BY ... LIMIT n`` with ``n`` at or
below ``spark.rapids.tpu.sort.topKThreshold`` plans as a top-k, as the
reference's limit-into-sort rule does.
"""

from __future__ import annotations

from ..config import TOPK_THRESHOLD, TorchConf
from ..exec import execs as E
from ..exec.joins import NestedLoopJoinExec
from . import logical as L


def plan_physical(plan: L.LogicalPlan, conf: TorchConf) -> E.TorchExec:
    if isinstance(plan, L.DeviceRelation):
        return E.DeviceSourceExec(plan.batch)
    if isinstance(plan, L.Project):
        return E.ProjectExec(plan_physical(plan.children[0], conf),
                             plan.exprs)
    if isinstance(plan, L.Filter):
        return E.FilterExec(plan_physical(plan.children[0], conf),
                            plan.condition)
    if isinstance(plan, L.Aggregate):
        return E.HashAggregateExec(plan_physical(plan.children[0], conf),
                                   plan.groupings, plan.aggregates)
    if isinstance(plan, L.Join) and plan.join_type == "cross":
        return NestedLoopJoinExec(
            plan_physical(plan.children[0], conf),
            plan_physical(plan.children[1], conf), plan.condition,
            plan.schema)
    if isinstance(plan, L.Join):
        return E.ShuffledHashJoinExec(
            plan_physical(plan.children[0], conf),
            plan_physical(plan.children[1], conf), plan.join_type,
            plan.left_keys, plan.right_keys, plan.schema)
    if isinstance(plan, L.Sort):
        return E.SortExec(plan_physical(plan.children[0], conf), plan.orders)
    if isinstance(plan, L.Limit):
        child = plan.children[0]
        threshold = conf.get(TOPK_THRESHOLD)
        if isinstance(child, L.Sort) and 0 < plan.n <= threshold:
            return E.TopKExec(plan_physical(child.children[0], conf),
                              child.orders, plan.n)
        return E.LimitExec(plan_physical(child, conf), plan.n)
    raise NotImplementedError(f"no physical plan for {type(plan).__name__}")
