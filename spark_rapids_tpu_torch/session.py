"""The session — port of ``spark_rapids_tpu/session.py:53 TpuSession``.

:class:`TorchSession` owns a device and a conf, uploads tables
(:meth:`create_dataframe`) and runs queries with the reference's
**dense-mode escalation** (``session.py:505-512``): optimistic operators
run first; after the run the session reads every site's ``fail`` flag in
one host transfer and, if any tripped, re-runs the query with those
sites one mode up (join: build table -> swapped table -> exact search;
aggregate: dense -> sort; top-k: single lane -> lexsort). The learned
modes are kept per plan shape, so a query that escalated once runs in
its final modes from then on. A tripped flag never changes a result: the
run that tripped it is discarded.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from . import types as T
from .config import TorchConf
from .data.batch import HostBatch
from .exec import execs as E
from .plan import logical as L
from .plan.planner import plan_physical

#: Escalation rounds before a query gives up. Every site has at most
#: three modes, so a query settles in at most three re-runs.
_MAX_ATTEMPTS = 4


@dataclasses.dataclass
class QueryInfo:
    """What the last :meth:`TorchSession.execute` did."""
    attempts: int
    #: site ordinal -> the mode the final run used (0 = optimistic).
    dense_modes: Dict[int, int]
    #: site ordinal -> "join" | "aggregate" | "topk", in execution order.
    site_kinds: List[str]
    #: operator name -> milliseconds of the final run.
    exec_ms: Dict[str, float]


def resolve_device(device=None) -> torch.device:
    """``device``, or the card when it is None; raises when the card is
    asked for and there is none, instead of running on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return device


class TorchSession:
    """Entry point of the port. ``device`` defaults to ``"cuda"``; without
    CUDA it raises instead of running on the CPU. Pass ``device="cpu"``
    to run the plain PyTorch versions of the kernels (tests)."""

    def __init__(self, conf: Optional[dict] = None, device=None):
        self.conf = TorchConf(conf)
        self.device = resolve_device(device)
        self._learned: Dict[str, Dict[int, int]] = {}
        self.last_query: Optional[QueryInfo] = None

    def create_dataframe(self, data, schema: Optional[T.Schema] = None
                         ) -> L.DataFrame:
        """Upload a table: a :class:`HostBatch`, or a dict of numpy arrays
        (with ``schema`` to type int32 arrays as DATE)."""
        host = data if isinstance(data, HostBatch) \
            else HostBatch.from_numpy(data, schema)
        return L.DataFrame(L.DeviceRelation(host.to_device(self.device)),
                           self)

    def plan(self, logical: L.LogicalPlan) -> E.TorchExec:
        return plan_physical(logical, self.conf)

    def explain(self, logical: L.LogicalPlan) -> str:
        return self.plan(logical).tree_string()

    def execute(self, logical: L.LogicalPlan) -> HostBatch:
        physical = self.plan(logical)
        sig = physical.tree_string()
        modes = dict(self._learned.get(sig, {}))
        for attempt in range(1, _MAX_ATTEMPTS + 1):
            ctx = E.ExecContext(self.device, modes)
            result = E.collect(physical, ctx)
            tripped = []
            if ctx.dense_fails:
                flags = torch.stack([f.reshape(()) for _, f in
                                     ctx.dense_fails]).cpu().tolist()
                tripped = [s for (s, _), f in zip(ctx.dense_fails, flags)
                           if f]
            if not tripped:
                self._learned[sig] = modes
                self.last_query = QueryInfo(
                    attempts=attempt,
                    dense_modes={s: modes.get(s, 0)
                                 for s in range(len(ctx.site_kinds))},
                    site_kinds=list(ctx.site_kinds),
                    exec_ms=ctx.exec_ms())
                return result
            for s in set(tripped):
                modes[s] = modes.get(s, 0) + 1
        raise RuntimeError(f"query did not settle in {_MAX_ATTEMPTS} runs; "
                           f"modes {modes}")
