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

With ``spark.rapids.tpu.mesh.enabled`` a mesh-capable plan runs as one
partitioned program over the session's mesh (:mod:`.exec.mesh`). Its
exchange buckets are bounded; when a run overflows one, the session
re-runs it with buckets 8x larger, up to 64x, and then runs the query on
the single-device path (the reference's non-learning growth escalation,
``session.py:523-529``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

import torch

from . import types as T
from .config import MESH_ENABLED, TorchConf
from .data.batch import HostBatch
from .exec import execs as E
from .exec import mesh as MX
from .exec import pipeline
from .io import parquet_device as PQ
from .io.parquet_meta import read_footer, schema_from_parquet
from .parallel.mesh import Mesh, make_mesh
from .plan import logical as L
from .plan.input_file import rewrite_input_file_exprs
from .plan.planner import plan_physical

#: Escalation rounds before a query gives up. Every site has at most
#: three modes, so a query settles in at most three re-runs.
_MAX_ATTEMPTS = 4

#: The mesh's bucket growth stops here; a run that still overflows goes
#: to the single-device path.
_MAX_MESH_GROWTH = 64.0


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
    #: "mesh" or "single": the path the final run took.
    path: str = "single"
    #: Shards of the final run (1 on the single-device path).
    shards: int = 1
    #: counter -> value of the final run (the scan's rows and bytes).
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)


def resolve_device(device=None) -> torch.device:
    """``device``, or the card when it is None; raises when the card is
    asked for and there is none, instead of running on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return device


class DataFrameReader:
    """``session.read``: file sources (the reference's
    ``session.py:26``). Only parquet is ported."""

    def __init__(self, session: "TorchSession"):
        self._session = session

    def parquet(self, *paths: str) -> L.DataFrame:
        """A DataFrame over parquet files or directories of them (their
        ``*.parquet`` files; names starting with ``_`` or ``.`` are
        skipped), typed by the first file's schema. It decodes on the
        session's device when collected."""
        files = PQ.scan_files(list(paths))
        if not files:
            raise FileNotFoundError(f"no parquet files under {paths}")
        schema = schema_from_parquet(read_footer(files[0]), files[0])
        return L.DataFrame(L.Scan("parquet", files, schema), self._session)


class TorchSession:
    """Entry point of the port. ``device`` defaults to ``"cuda"``; without
    CUDA it raises instead of running on the CPU. Pass ``device="cpu"``
    to run the plain PyTorch versions of the kernels (tests). ``mesh`` is
    the device mesh of the mesh path; by default every visible card
    (:func:`~.parallel.mesh.make_mesh`), made at the first mesh query."""

    def __init__(self, conf: Optional[dict] = None, device=None,
                 mesh: Optional[Mesh] = None):
        self.conf = TorchConf(conf)
        pipeline.configure(self.conf)
        self.device = resolve_device(device)
        self._mesh = mesh
        self._learned: Dict[tuple, Dict[int, int]] = {}
        self._mesh_capable: Dict[tuple, bool] = {}
        self.last_query: Optional[QueryInfo] = None

    def close(self) -> List[threading.Thread]:
        """Join every worker of the scans' shared pool
        (:func:`.exec.pipeline.shutdown`). Returns the threads that did
        not stop in time (none, normally). The pool is made anew at its
        next use, so the session keeps working after ``close``."""
        return pipeline.shutdown()

    @property
    def mesh(self) -> Mesh:
        if self._mesh is None:
            self._mesh = make_mesh()
        return self._mesh

    @property
    def read(self) -> DataFrameReader:
        return DataFrameReader(self)

    def create_dataframe(self, data, schema: Optional[T.Schema] = None
                         ) -> L.DataFrame:
        """Upload a table: a :class:`HostBatch`, or a dict of numpy arrays
        (with ``schema`` to type int32 arrays as DATE)."""
        host = data if isinstance(data, HostBatch) \
            else HostBatch.from_numpy(data, schema)
        return L.DataFrame(L.DeviceRelation(host.to_device(self.device)),
                           self)

    def plan(self, logical: L.LogicalPlan) -> E.TorchExec:
        """The physical plan, after the input-file rewrite
        (:mod:`.plan.input_file`)."""
        return plan_physical(rewrite_input_file_exprs(logical), self.conf)

    def explain(self, logical: L.LogicalPlan) -> str:
        return self.plan(logical).tree_string()

    def execute(self, logical: L.LogicalPlan) -> HostBatch:
        physical = self.plan(logical)
        mesh = self.mesh if self.conf.get(MESH_ENABLED) and \
            MX.mesh_capable(physical, self._mesh_capable) else None
        # Modes are learned per path: the mesh path numbers only the
        # sites of its single-device tail.
        sig = (physical.tree_string(), mesh is not None)
        modes = dict(self._learned.get(sig, {}))
        growth = 1.0
        attempts = rounds = 0
        while True:
            attempts += 1
            ctx = E.ExecContext(self.device, modes, self.conf)
            try:
                if mesh is not None:
                    result, overflowed = MX.mesh_collect(physical, ctx, mesh,
                                                         growth)
                else:
                    result, overflowed = E.collect(physical, ctx), False
            finally:
                # every attempt's look-ahead ends with it, re-runs included
                ctx.run_cleanups()
            if overflowed:
                if growth >= _MAX_MESH_GROWTH:
                    mesh = None
                    sig = (sig[0], False)
                    modes = dict(self._learned.get(sig, {}))
                else:
                    growth *= 8.0
                continue
            tripped = []
            if ctx.dense_fails:
                flags = torch.stack([f.reshape(()) for _, f in
                                     ctx.dense_fails]).cpu().tolist()
                tripped = [s for (s, _), f in zip(ctx.dense_fails, flags)
                           if f]
            if not tripped:
                self._learned[sig] = modes
                self.last_query = QueryInfo(
                    attempts=attempts,
                    dense_modes={s: modes.get(s, 0)
                                 for s in range(len(ctx.site_kinds))},
                    site_kinds=list(ctx.site_kinds),
                    exec_ms=ctx.exec_ms(),
                    path="single" if mesh is None else "mesh",
                    shards=1 if mesh is None else mesh.size,
                    counters=dict(ctx.counters))
                return result
            rounds += 1
            if rounds >= _MAX_ATTEMPTS:
                raise RuntimeError(f"query did not settle in "
                                   f"{_MAX_ATTEMPTS} runs; modes {modes}")
            for s in set(tripped):
                modes[s] = modes.get(s, 0) + 1
