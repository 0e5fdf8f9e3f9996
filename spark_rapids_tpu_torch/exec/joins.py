"""Joins without equi keys — port of ``spark_rapids_tpu/exec/joins.py``
(``TpuBroadcastNestedLoopJoinExec`` and ``TpuCartesianProductExec``), cut
to the cross join, with or without a condition.

The reference builds a pair grid of probe capacity x build CAPACITY and
gathers both sides over it. Here the build side is accumulated whole
first (as the reference does too), moved to the front of its batch, and
its live row count read once on the host; the grid is probe capacity x
build LIVE rows. TPC-H Q22 crosses ~150k customers with the one-row
average, which makes a grid the probe's size instead of 128 times it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import types as T
from ..data.batch import ColumnarBatch
from ..data.column import bucket_capacity
from ..ops.expression import Expression
from ..ops.kernels import rowops as KR
from .execs import TorchExec


class NestedLoopJoinExec(TorchExec):
    """Cross join, left = probe, right = build: every live (probe, build)
    pair in probe-major order, filtered by ``condition`` when there is
    one. The output stays lazy (live = the pairs kept) at the ladder rung
    of the pair count; its columns are the probe's, then the build's."""

    def __init__(self, left: TorchExec, right: TorchExec,
                 condition: Optional[Expression], schema: T.Schema):
        self.children = [left, right]
        self.condition = condition
        self._schema = schema

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return "NestedLoopJoin cross" + (
            f" ({self.condition})" if self.condition is not None else "")

    def execute(self, ctx):
        left, right = self.children
        probe = left.execute(ctx)
        build = right.execute(ctx)
        cond = None if self.condition is None \
            else self.condition.bind(self._schema)
        with ctx.timed(self.name):
            build = KR.physical(build)
            n_b = int(build.n_rows)
            n_pairs = probe.capacity * n_b
            cap = bucket_capacity(max(n_pairs, 1))
            k = torch.arange(cap, device=probe.device)
            width = max(n_b, 1)
            p_idx = (k // width).clamp(max=probe.capacity - 1)
            b_idx = k % width
            live = (k < n_pairs) & probe.row_mask()[p_idx]
            cols = KR.gather_columns(probe.columns, p_idx, live) \
                + KR.gather_columns(build.columns, b_idx, live)
            pairs = ColumnarBatch(cols, live.sum(), self._schema, live=live)
            if cond is None:
                return pairs
            m = cond.eval_device(pairs)
            return KR.compact(pairs, m.data & m.validity)
