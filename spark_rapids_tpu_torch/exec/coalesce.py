"""Batch coalescing — port of ``spark_rapids_tpu/exec/coalesce.py`` (the
``GpuCoalesceBatches`` analog).

Operators that want large inputs (the aggregate, the sort and the top-k:
``"target"``; the window: ``"single"``) declare goals for their children
(``children_coalesce_goals``), and the planner inserts a
:class:`CoalesceBatchesExec` where a child does not already meet its
goal (:func:`insert_coalesce`). The exec concatenates its child's
batches until their capacities reach the goal's rows (capacity, not live
rows: it is known on the host without a synchronisation), so the 64
blocks of an exchange reach an aggregate as a few batches instead of 64
partials. While a batch waits it is registered with the spill catalog,
and each concatenation runs under the OOM retry at ``<node>.concat``,
split in half on a persistent OOM (:func:`..memory.retry.halve_list`).
Inside a fused region (``ctx.in_fusion``) it neither registers nor
retries, as in the reference.
"""

from __future__ import annotations

from typing import List, Optional

from .. import types as T
from ..data.batch import ColumnarBatch
from .execs import (DeviceSourceExec, HostToDeviceExec, TorchExec,
                    _coalesce_device,
                    _pinned_concat)


class CoalesceGoal:
    def satisfied_by(self, other: "CoalesceGoal") -> bool:
        """True when batches produced under ``other`` also meet this
        goal."""
        raise NotImplementedError


class TargetSize(CoalesceGoal):
    def __init__(self, rows: int):
        self.rows = rows

    def satisfied_by(self, other):
        if isinstance(other, RequireSingleBatch):
            return True
        return isinstance(other, TargetSize) and other.rows >= self.rows

    def __repr__(self):
        return f"TargetSize({self.rows})"


class RequireSingleBatch(CoalesceGoal):
    def satisfied_by(self, other):
        return isinstance(other, RequireSingleBatch)

    def __repr__(self):
        return "RequireSingleBatch"


class CoalesceBatchesExec(TorchExec):
    """Concatenate the child's batches, partition by partition, up to the
    goal (the reference's ``TpuCoalesceBatchesExec``)."""

    def __init__(self, child: TorchExec, goal: CoalesceGoal):
        self.children = [child]
        self.goal = goal

    @property
    def schema(self) -> T.Schema:
        return self.children[0].schema

    def describe(self):
        return f"CoalesceBatches ({self.goal!r})"

    def execute(self, ctx):
        from ..memory import retry as R
        from ..memory import spill as SP
        catalog = ctx.catalog
        single = isinstance(self.goal, RequireSingleBatch)
        target = None if single else self.goal.rows
        name = self.node_name()

        def run(part):
            pending: List[int] = []  # catalog buffer ids
            direct: List[ColumnarBatch] = []  # in a fused region
            pending_cap = 0

            def concat_ids(ids):
                with ctx.registry.timer(name, "concatTime",
                                        trace="coalesce.concat"):
                    return _pinned_concat(catalog, ids, ctx, name)

            def concat_direct(batches):
                with ctx.registry.timer(name, "concatTime",
                                        trace="coalesce.concat"):
                    return _coalesce_device(list(batches))

            def flush():
                nonlocal pending_cap
                ids, batches = list(pending), list(direct)
                pending.clear()
                direct.clear()
                pending_cap = 0
                if ids:
                    # on OOM the ids split in half: two smaller outputs
                    # instead of a failed query
                    try:
                        outs = R.with_retry(ctx, f"{name}.concat", ids,
                                            concat_ids, split=R.halve_list,
                                            node=name)
                    finally:
                        for b in ids:
                            catalog.free(b)
                elif batches:
                    outs = [concat_direct(batches)]
                else:
                    return []
                ctx.metric(name, "numInputBatches", len(ids) + len(batches))
                ctx.metric(name, "numOutputBatches", len(outs))
                return outs

            try:
                for db in part:
                    if db.capacity == 0:
                        continue
                    if ctx.in_fusion:
                        direct.append(db)
                    else:
                        pending.append(catalog.register_batch(
                            db, SP.ACTIVE_BATCHING_PRIORITY,
                            owner=ctx.qos))
                    pending_cap += db.capacity
                    if not single and pending_cap >= target:
                        yield from flush()
                yield from flush()
            finally:
                # a consumer that stops early leaves no entry behind
                for b in pending:
                    catalog.free(b)
        return [run(p) for p in self.children[0].execute(ctx)]


def insert_coalesce(plan: TorchExec, default_target_rows: int) -> TorchExec:
    """Insert coalesce nodes per the operators' declared child goals,
    skipping a child that already satisfies its goal and replacing a
    weaker coalesce instead of stacking two (the reference's
    ``GpuTransitionOverrides.optimizeCoalesce`` analog); a device
    source counts as the reference's upload, which already produces
    batches of the target size. A shared
    subplan (:class:`~.execs.ReusedExec`) is rebuilt once, so every
    reference still reads the same exec."""
    memo: dict = {}

    def goal_of(goal: str) -> CoalesceGoal:
        return RequireSingleBatch() if goal == "single" \
            else TargetSize(default_target_rows)

    def fix(node: TorchExec) -> TorchExec:
        if id(node) in memo:
            return memo[id(node)]
        new_children = [fix(c) for c in node.children]
        goals = node.children_coalesce_goals
        if goals:
            assert len(goals) == len(new_children), \
                (node.node_name(), goals, len(new_children))
            wrapped = []
            for c, goal in zip(new_children, goals):
                if goal is None:
                    wrapped.append(c)
                    continue
                goal = goal_of(goal)
                produced: Optional[CoalesceGoal] = None
                if isinstance(c, CoalesceBatchesExec):
                    produced = c.goal
                elif isinstance(c, (DeviceSourceExec, HostToDeviceExec)):
                    # an upload, as the reference's HostToDeviceExec
                    # (its goal rows are the batch size)
                    produced = TargetSize(default_target_rows)
                if produced is not None and goal.satisfied_by(produced):
                    wrapped.append(c)
                elif isinstance(c, CoalesceBatchesExec):
                    wrapped.append(CoalesceBatchesExec(c.children[0], goal))
                else:
                    wrapped.append(CoalesceBatchesExec(c, goal))
            new_children = wrapped
        out = node
        if any(a is not b for a, b in zip(new_children, node.children)):
            out = node.with_children(new_children)
        memo[id(node)] = out
        return out

    return fix(plan)
