"""Logical -> CPU physical planning — port of
``spark_rapids_tpu/plan/planner.py:101-173``.

Every logical node plans to its CPU operator (:mod:`.physical`); the
overrides pass (:mod:`.overrides`) then converts what the device can
take into the port's device execs. The sources are the reference's
``HOST_SOURCE_NODES``: an uploaded table is a
:class:`~..exec.execs.DeviceSourceExec` (a CPU consumer reads it
through a ``DeviceToHostExec``), a file scan of any format a
:class:`~..io.files.CpuFileScanExec`, which the overrides pass swaps for
the device scan of its format where that takes the files. A write is a
:class:`~..io.writers.CpuWriteFilesExec`. A repartition plans as the
device's shuffle exchange (no CPU exchange is ported).

Joins follow the reference's ``_plan_join`` (``:47-81``): a cross join
is a nested-loop join; an equi join of every type is a
:class:`~.physical.CpuJoinExec` that keeps its residual and applies it
to the pairs it matches by key. The device's shuffled hash join does the
same for inner, left, semi and anti joins; a right or full join with a
residual is tagged and runs on the host (the reference raises for it).

``ORDER BY ... LIMIT n`` is a global limit over a local limit over the
sort, the reference's shape; the overrides pass folds it into the top-k.
A subplan that the query references more than once (Q15's revenue view,
Q22's customers) plans once, under one :class:`~..exec.execs.
ReusedExec` that every reference reads; tables and scans are read where
they are referenced.
"""

from __future__ import annotations

import time
import warnings
from collections import Counter
from typing import Dict, Optional

from ..config import TorchConf
from ..exec import execs as E
from ..io.files import CpuFileScanExec
from ..io.writers import CpuWriteFilesExec
from ..shuffle.exchange import ShuffleExchangeExec
from ..shuffle.partitioners import partitioner_factory
from . import logical as L
from . import physical as P


def plan_physical(plan: L.LogicalPlan, conf: TorchConf) -> E.TorchExec:
    """The CPU physical plan of ``plan``."""
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
                    ex, (E.DeviceSourceExec, CpuFileScanExec)):
                ex = E.ReusedExec(ex)
            # planning runs on the caller's thread: the analyzer reaches
            # this closure from workers only through data/batch.py's
            # build(), by name
            memo[id(node)] = ex  # concurrency: ignore (planning thread)
        return memo[id(node)]
    return build(plan)


def plan_and_verify(plan: L.LogicalPlan, conf: TorchConf,
                    lint_ns: Optional[list] = None, memo=None,
                    hits: Optional[list] = None) -> E.TorchExec:
    """The CPU physical plan of ``plan``, statically verified: the
    planner-side plan-lint hook (the reference's ``planner.py:83``; the
    session verifies again after the overrides pass). An error raises
    :class:`~..analysis.plan_lint.PlanLintError`; a warn is only warned
    here, since no rewritten plan exists yet to fall back from. The
    check's nanoseconds are added to ``lint_ns[0]`` when it is given;
    ``memo`` and ``hits`` go to :func:`~..analysis.plan_lint.verify_plan`."""
    from ..analysis.plan_lint import verify_plan
    physical = plan_physical(plan, conf)
    t0 = time.perf_counter_ns()
    try:
        warns = verify_plan(physical, conf, stage="planned", memo=memo,
                            hits=hits)
    finally:
        if lint_ns is not None:
            lint_ns[0] += time.perf_counter_ns() - t0
    for w in warns:
        warnings.warn(f"plan-lint: {w}", stacklevel=2)
    return physical


def _plan_join(plan: L.Join, sub) -> E.TorchExec:
    left, right = sub(plan.children[0]), sub(plan.children[1])
    if plan.join_type == "cross":
        return P.CpuNestedLoopJoinExec(left, right, plan.condition,
                                       plan.schema)
    return P.CpuJoinExec(left, right, plan.join_type, plan.left_keys,
                         plan.right_keys, plan.schema, plan.condition)


def _plan_node(plan: L.LogicalPlan, conf: TorchConf, sub) -> E.TorchExec:
    """One logical node's CPU operator (or source), its children planned
    by ``sub(child)``."""
    if isinstance(plan, L.DeviceRelation):
        return E.DeviceSourceExec(plan.batch)
    if isinstance(plan, L.Scan):
        return CpuFileScanExec(plan.fmt, plan.files, plan.schema,
                               plan.options, plan.part_values, plan.n_part,
                               plan.emit_file_meta)
    if isinstance(plan, L.WriteOp):
        return CpuWriteFilesExec(sub(plan.children[0]), plan.fmt, plan.path,
                                 plan.options, plan.partition_by, plan.mode)
    if isinstance(plan, L.Project):
        return P.CpuProjectExec(sub(plan.children[0]), plan.exprs)
    if isinstance(plan, L.Filter):
        return P.CpuFilterExec(sub(plan.children[0]), plan.condition)
    if isinstance(plan, L.Aggregate):
        return P.CpuHashAggregateExec(sub(plan.children[0]),
                                      plan.groupings, plan.aggregates)
    if isinstance(plan, L.Join):
        return _plan_join(plan, sub)
    if isinstance(plan, L.Generate):
        return P.CpuGenerateExec(sub(plan.children[0]), plan.generator,
                                 plan.outer, plan.pos, plan.schema)
    if isinstance(plan, L.Union):
        return P.CpuUnionExec([sub(c) for c in plan.children], plan.schema)
    if isinstance(plan, L.Expand):
        return P.CpuExpandExec(sub(plan.children[0]), plan.projections,
                               plan.schema)
    if isinstance(plan, L.WindowOp):
        return P.CpuWindowExec(sub(plan.children[0]), plan.window_exprs,
                               plan.schema)
    if isinstance(plan, L.Repartition):
        return ShuffleExchangeExec(
            sub(plan.children[0]),
            partitioner_factory(plan.mode, plan.n_parts, keys=plan.keys),
            plan.n_parts)
    if isinstance(plan, L.Sort):
        return P.CpuSortExec(sub(plan.children[0]), plan.orders)
    if isinstance(plan, L.Limit):
        return P.CpuLimitExec(P.CpuLocalLimitExec(sub(plan.children[0]),
                                                  plan.n), plan.n)
    raise NotImplementedError(f"no physical plan for {type(plan).__name__}")
