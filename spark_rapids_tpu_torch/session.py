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

Memory and robustness (:mod:`.memory`, the reference's
``_run_with_retries``, ``session.py:345-470``): every attempt's
``ExecContext`` carries the session's spill catalog, fault injector, task
semaphore, the query's :class:`~.utils.deadline.Deadline` (one for the
whole query, its re-runs included) and its QoS tag. Each dispatch checks
the deadline, visits the ``session.dispatch`` injection site and holds
the task semaphore (``spark.rapids.sql.concurrentTpuTasks``). A fault
that escaped every operator-level retry is classified
(:func:`.memory.retry.classify`): a transient one re-runs the attempt in
place after the backoff; an OOM synchronizes the card, spills every
spillable buffer and re-runs; anything else raises. Every plan may
re-run: a write applies its save mode once and a re-run deletes the
files of the attempt before it (:mod:`.io.writers`). Retries of
discarded attempts are carried into the surviving attempt's profile
under ``TorchSession``.

Whole-stage fusion (:mod:`.exec.fusion`, the reference's
``session.py:621-629``): with ``spark.rapids.tpu.fusion.enabled``
(default) a single-device plan runs as its boundaries, then its region
as one CUDA graph (captured at its second run, replayed after), and one
head transfer that brings back the result and every dense-fail flag; an
inlined exact join sized without a host read reports its total and an
overflow flag there, and an overflowed run re-runs with the totals
learned as that site's capacity (kept per plan shape). Otherwise, and
for a region refused for synchronising with the host, the plan streams
(``session.stream_collect``). ``QueryInfo.fusion`` says what the fused
dispatch did.

Plan lint (:mod:`.analysis.plan_lint`, the reference's
``session.py:255-285``) verifies the CPU plan and the overrides pass's
result: an error raises before anything runs, a warn runs the CPU plan
instead (it raises in test mode and under ``planLint.failOnWarn``). The
session keeps each verdict by plan (:class:`~.analysis.plan_lint.
LintMemo`), so a plan it runs again is not checked again. With
``spark.rapids.tpu.compileCache.enabled`` the session's compile
manifest (:mod:`.compile.persist`) gives a plan this session has not run
the dense modes and join capacities an earlier process learned for it,
and keeps what this session learns.

Observability (:mod:`.metrics`): above metrics level NONE every query
leaves a :class:`~.metrics.profile.QueryProfile` of its final attempt
(:meth:`TorchSession.last_query_profile`, :meth:`query_profile`,
``df.explain(metrics=True)``), appended to the event log when
``spark.rapids.tpu.metrics.eventLog.dir`` is set. With
``spark.rapids.tpu.trace.enabled`` a query also leaves a span tree —
``session.query`` over ``session.plan`` and one ``session.dispatch`` per
attempt — exported as Chrome trace-event JSON
(:meth:`last_trace`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import warnings
from typing import Dict, List, Optional

import torch

from . import compile as _compile
from . import types as T
from .config import (FUSION_ENABLED, MESH_ENABLED,
                     METRICS_EVENT_LOG_MAX_BYTES, TorchConf)
from .data.batch import HostBatch
from .exec import execs as E
from .exec import fusion as FU
from .exec import mesh as MX
from .exec import pipeline
from .io import files as FILES
from .memory import retry as R
from .memory.device_manager import DeviceManager
from .memory.spill import QosTag
from .metrics import trace as TR
from .metrics.eventlog import EventLog
from .metrics.profile import QueryProfile, QueryProfiler, plan_profile_hash
from .ops.kernels import cuda as KCUDA
from .parallel.mesh import Mesh, make_mesh
from .plan import logical as L
from .plan.input_file import rewrite_input_file_exprs
from .plan.optimizer import prune_columns
from .analysis.plan_lint import LintMemo, PlanLintError, verify_plan
from .plan.overrides import TorchOverrides, finalize_plan
from .plan.physical import HostExec
from .plan.planner import plan_and_verify
from .compile import persist
from .compile.ladder import bucket_capacity
from .utils import lockdep
from .utils.deadline import Deadline
from .utils.fault_injection import (FaultInjector, InjectedFault,
                                    maybe_inject)

#: Escalation rounds before a query gives up. Every site has at most
#: three modes, so a query settles in at most three re-runs.
_MAX_ATTEMPTS = 4

#: The mesh's bucket growth stops here; a run that still overflows goes
#: to the single-device path.
_MAX_MESH_GROWTH = 64.0

#: Metrics of a discarded attempt carried into the surviving attempt's
#: profile (under the ``TorchSession`` node).
_CARRIED_METRICS = ("retryCount", "splitAndRetryCount", "retryBlockTimeNs",
                    "retryWastedComputeNs", "checksumFailures",
                    "deadlineCancels")


@dataclasses.dataclass
class QueryInfo:
    """What the last :meth:`TorchSession.execute` did."""
    attempts: int
    #: site position (in ``site_kinds``) -> the mode the final run used
    #: (0 = optimistic).
    dense_modes: Dict[int, int]
    #: "join" | "aggregate" | "topk" of each site, in execution order
    #: (a fused plan's boundaries first, then its region).
    site_kinds: List[str]
    #: operator name -> milliseconds of the final run.
    exec_ms: Dict[str, float]
    #: "mesh" or "single": the path the final run took.
    path: str = "single"
    #: Shards of the final run (1 on the single-device path).
    shards: int = 1
    #: counter -> value of the final run (the scan's rows and bytes).
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: What the fused dispatch of the final run did (None on the
    #: streaming and mesh paths): ``action`` ("eager", "capture",
    #: "replay", "refused", "head", "cpu", "trial" or "stream": a
    #: streaming run while the plan's path is being chosen, or after it
    #: was), ``chosen`` (the plan's path once chosen), ``site`` (a
    #: refusal's sync site), ``boundaries``, ``capture_ms``,
    #: ``pool_bytes``, ``head_bytes``, ``guess_miss``, ``host_us`` (the
    #: host's time by step: signature, boundaries, key, region, head).
    fusion: Optional[dict] = None
    #: What plan lint found in the query's plan (:mod:`.analysis.
    #: plan_lint`): ``warns`` (warn-severity violations after the
    #: overrides pass), ``fallback`` (the query ran its CPU plan for
    #: them), ``ms`` (the checks' time, key included) and ``memo`` (of
    #: the two checks, those whose verdict the session already held).
    lint: Dict[str, object] = dataclasses.field(default_factory=dict)
    #: The compile manifest's part (:mod:`.compile.persist`; empty while
    #: it is off): ``plan_hash``, ``seeded`` (the first run took modes
    #: or capacities an earlier process learned) and ``recorded`` (this
    #: query changed what the manifest holds).
    manifest: Dict[str, object] = dataclasses.field(default_factory=dict)


def _host_flags(pairs) -> List[bool]:
    """The flags of ``(site, flag)`` pairs on the host: as they are when
    the fused head brought them back, else in one transfer."""
    flags = [f for _, f in pairs]
    if all(isinstance(f, bool) for f in flags):
        return flags
    return [bool(v) for v in torch.stack(
        [torch.as_tensor(f).reshape(()) for f in flags]).cpu().tolist()]


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
    ``session.py:26``): ``option(key, value)``, then ``parquet``, ``orc``
    or ``csv`` over files or directories of them (a directory's files of
    the format, names starting with ``_`` or ``.`` skipped, hive
    ``key=value`` directories as partition columns), typed by the first
    file (:func:`.io.files.infer_schema`). Each decodes on the session's
    device when collected, on the host where the plan's gate says so
    (:mod:`.plan.overrides`)."""

    def __init__(self, session: "TorchSession"):
        self._session = session
        self._options: Dict[str, object] = {}

    def option(self, key: str, value) -> "DataFrameReader":
        self._options[key] = value
        return self

    def _scan(self, fmt: str, paths) -> L.DataFrame:
        listing = FILES.list_files(fmt, list(paths))
        if not listing.files:
            raise FileNotFoundError(f"no {fmt} files under {list(paths)}")
        schema = FILES.infer_schema(fmt, listing, self._options)
        return L.DataFrame(L.Scan(fmt, listing.files, schema, self._options,
                                  listing.part_values,
                                  len(listing.part_fields)), self._session)

    def parquet(self, *paths: str) -> L.DataFrame:
        return self._scan("parquet", paths)

    def orc(self, *paths: str) -> L.DataFrame:
        return self._scan("orc", paths)

    def csv(self, *paths: str) -> L.DataFrame:
        return self._scan("csv", paths)


class TorchSession:
    """Entry point of the port. ``device`` defaults to ``"cuda"``; without
    CUDA it raises instead of running on the CPU. Pass ``device="cpu"``
    to run the plain PyTorch versions of the kernels (tests). ``mesh`` is
    the device mesh of the mesh path; by default every visible card
    (:func:`~.parallel.mesh.make_mesh`), made at the first mesh query."""

    #: profiles kept per session before the oldest query ids are evicted
    _MAX_PROFILES = 256

    def __init__(self, conf: Optional[dict] = None, device=None,
                 mesh: Optional[Mesh] = None):
        self.conf = TorchConf(conf)
        pipeline.configure(self.conf)
        TR.configure(self.conf)
        _compile.configure(self.conf)
        #: this session's compile manifest (:mod:`.compile.persist`), or
        #: None while its conf leaves it off
        self.manifest = persist.configure(self.conf)
        #: plan-lint verdicts of the plans this session ran
        self._lint_memo = LintMemo()
        self.device = resolve_device(device)
        self._mesh = mesh
        #: guards what concurrent queries of this session learn and
        #: leave: ``_learned``, ``_join_caps`` and the ``last_*`` slots
        self._state_lock = lockdep.lock("TorchSession._state_lock")
        self._learned: Dict[tuple, Dict[int, int]] = {}
        #: plan shape -> inlined exact join site -> learned capacity
        self._join_caps: Dict[tuple, Dict[int, int]] = {}
        self._mesh_capable: Dict[tuple, bool] = {}
        self.last_query: Optional[QueryInfo] = None
        #: the explain text of the last plan (``spark.rapids.sql.explain``)
        self.last_explain = ""
        self._profiles_lock = lockdep.lock("TorchSession._profiles_lock")
        self._profiles: Dict[int, QueryProfile] = {}
        self._query_seq = 0
        self._last_profile: Optional[QueryProfile] = None
        self._last_tracer: Optional[TR.Tracer] = None
        self._event_log: Optional[EventLog] = None
        #: the spill catalog and task semaphore of this device and memory
        #: configuration (:mod:`.memory.device_manager`)
        self.device_manager = DeviceManager.get_or_create(self.conf,
                                                          self.device)
        #: None unless the conf turns fault injection on
        self._fault_injector = FaultInjector.maybe(self.conf)

    def set_conf(self, key: str, value) -> None:
        """Set one conf key for the queries this session runs from now on
        (Spark's ``spark.conf.set``): a memory key moves the session to
        the device manager of its new configuration, and the fault
        injector is made anew from the new conf."""
        self.conf = TorchConf({**self.conf.as_dict(), key: value})
        self.device_manager = DeviceManager.get_or_create(self.conf,
                                                          self.device)
        self._fault_injector = FaultInjector.maybe(self.conf)
        self.manifest = persist.configure(self.conf)
        # a verdict holds for the conf it was reached under
        self._lint_memo = LintMemo()

    def close(self) -> List[threading.Thread]:
        """Join every worker of the scans' shared pool
        (:func:`.exec.pipeline.shutdown`). Returns the threads that did
        not stop in time (none, normally). The pool is made anew at its
        next use, so the session keeps working after ``close``."""
        return pipeline.shutdown()

    def compile_status(self) -> dict:
        """The compile layer's state (the reference's ``session.py:189``):
        the ladder, this session's manifest (``persistent_cache``), the
        fused programs' statistics and the fused cache's size. The
        reference's ``warmup`` counters have no counterpart: the port
        captures a graph on the query thread."""
        from .compile import executables
        return {
            "ladder": dataclasses.asdict(_compile.get_ladder()),
            "persistent_cache": persist.status(self.manifest),
            "fused_programs": executables.stats(),
            "fused_cache_entries": FU.fused_cache_size(),
        }

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
        """The executable plan of ``logical`` (the reference's
        ``session.py:255``): the input-file rewrite
        (:mod:`.plan.input_file`), column pruning (:mod:`.plan.
        optimizer`), the CPU physical plan, verified
        (:func:`.plan.planner.plan_and_verify`), then the overrides pass
        (:mod:`.plan.overrides`), which tags every node, explains
        (``spark.rapids.sql.explain``; the text is also
        :attr:`last_explain`), converts what the device can run and
        inserts the transitions, and plan lint again over its result
        (:mod:`.analysis.plan_lint`): an error raises
        :class:`~.analysis.plan_lint.PlanLintError` before anything runs;
        a warn falls back to the CPU plan, or raises in test mode and
        under ``planLint.failOnWarn``. A plan whose root runs on the
        device comes back without its ``DeviceToHostExec`` root (the
        device plan); otherwise its root is a CPU operator."""
        return self.plan_with_lint(logical)[0]

    def plan_with_lint(self, logical: L.LogicalPlan):
        """:meth:`plan` and what plan lint did there: ``(plan, {"warns",
        "fallback", "ms", "memo"})``, which a query keeps as
        ``QueryInfo.lint``."""
        overrides = TorchOverrides(self.conf)
        lint_ns, hits = [0], [0]
        memo = self._lint_memo
        cpu = plan_and_verify(prune_columns(rewrite_input_file_exprs(
            logical)), self.conf, lint_ns, memo, hits)
        root = overrides.apply(cpu)
        with self._state_lock:
            self.last_explain = overrides.last_explain
        t0 = time.perf_counter_ns()
        try:
            warns = verify_plan(root, self.conf, stage="post-overrides",
                                memo=memo, hits=hits)
        finally:
            lint_ns[0] += time.perf_counter_ns() - t0
        if warns:
            if self.conf.test_enabled:
                # test mode promises no silent host fallback: a quiet one
                # here would compare the CPU plan with itself
                raise PlanLintError(warns)
            for w in warns:
                warnings.warn(f"plan-lint: {w}; falling back to the CPU "
                              "plan", stacklevel=3)
            # finalized as every plan is: transitions over the device
            # nodes the CPU plan holds (uploaded tables, exchanges)
            root = finalize_plan(cpu, self.conf)
        lint = {"warns": len(warns), "fallback": bool(warns),
                "ms": lint_ns[0] / 1e6, "memo": hits[0]}
        plan = root.children[0] if isinstance(root, E.DeviceToHostExec) \
            else root
        return plan, lint

    def explain(self, logical: L.LogicalPlan) -> str:
        return self.plan(logical).tree_string()

    def _signature(self, physical: E.TorchExec) -> tuple:
        """The plan's ``(tree_string, mesh)`` key: the learned modes' and
        the profile's ``plan_hash``."""
        mesh = self.conf.get(MESH_ENABLED) and physical.columnar and \
            MX.mesh_capable(physical, self._mesh_capable)
        return (physical.tree_string(), bool(mesh))

    def execute(self, logical: L.LogicalPlan) -> HostBatch:
        """Plan and run ``logical``, escalating tripped sites; a traced
        query's span tree is exported at its end (best-effort)."""
        tracer = TR.maybe_tracer(self.conf)
        try:
            with TR.span(tracer, "session.query", cat="session"):
                return self._execute(logical, tracer)
        finally:
            if tracer is not None:
                self._export_trace(tracer)

    def _execute(self, logical: L.LogicalPlan, tracer) -> HostBatch:
        with TR.span(tracer, "session.plan", cat="session"):
            physical, lint = self.plan_with_lint(logical)
            # Modes are learned per path: the mesh path numbers only the
            # sites of its single-device tail.
            sig = self._signature(physical)
        mesh = self.mesh if sig[1] else None
        profiler = QueryProfiler.maybe(self)
        manifest = self._seed_from_manifest(sig)
        modes = self._modes_of(sig)
        # one deadline spans the whole query, its re-runs included
        deadline = Deadline.maybe(self.conf)
        qos = QosTag(deadline=deadline, trace=tracer)
        carried: Dict[str, int] = {}
        growth = 1.0
        attempts = rounds = 0
        while True:
            attempts += 1
            ctx, result, overflowed, tripped = self._dispatch(
                physical, modes, mesh, growth, deadline, qos, tracer,
                attempts, carried, self._caps_of(sig))
            if overflowed and mesh is None:
                # an inlined exact join outgrew its output: its totals
                # are the capacities of the re-run
                self._carry(ctx, carried)
                learned = False
                with self._state_lock:
                    caps = self._join_caps.setdefault(sig, {})
                    for site, total in ctx.join_totals:
                        cap = bucket_capacity(max(int(total), 128))
                        if cap > caps.get(site, 0):
                            caps[site] = cap
                            learned = True
                if not learned:
                    growth *= 8.0
                rounds += 1
                if rounds >= 2 * _MAX_ATTEMPTS:
                    raise RuntimeError("inlined joins did not settle in "
                                       f"{2 * _MAX_ATTEMPTS} runs")
                continue
            if overflowed:
                self._carry(ctx, carried)
                if growth >= _MAX_MESH_GROWTH:
                    mesh = None
                    sig = (sig[0], False)
                    manifest = self._seed_from_manifest(sig)
                    modes = self._modes_of(sig)
                else:
                    growth *= 8.0
                continue
            if not tripped:
                for name, v in carried.items():
                    ctx.metric("TorchSession", name, v)
                with self._state_lock:
                    self._learned[sig] = modes
                self._record_in_manifest(sig, modes, manifest)
                ctx.plan_lint = lint
                info = QueryInfo(
                    attempts=attempts,
                    dense_modes={i: modes.get(s, 0)
                                 for i, s in enumerate(ctx.site_ids)},
                    site_kinds=list(ctx.site_kinds),
                    exec_ms=ctx.exec_ms(),
                    path="single" if mesh is None else "mesh",
                    shards=1 if mesh is None else mesh.size,
                    counters=dict(ctx.counters),
                    fusion=ctx.fusion, lint=dict(lint),
                    manifest=dict(manifest))
                with self._state_lock:
                    self.last_query = info
                if profiler is not None:
                    # exec_ms synchronised: the events are complete
                    ctx.record_device_time()
                    self._note_profile(profiler, physical, ctx, sig, tracer)
                return result
            self._carry(ctx, carried)
            rounds += 1
            if rounds >= _MAX_ATTEMPTS:
                raise RuntimeError(f"query did not settle in "
                                   f"{_MAX_ATTEMPTS} runs; modes {modes}")
            for s in set(tripped):
                modes[s] = modes.get(s, 0) + 1

    def _seed_from_manifest(self, sig: tuple) -> Dict[str, object]:
        """The manifest's part of a query (``QueryInfo.manifest``; empty
        while the manifest is off). A plan this session has not run yet
        takes the dense modes and join capacities an earlier process
        learned for it, so its first run here is already in its final
        modes."""
        m = self.manifest
        if m is None:
            return {}
        phash = persist.plan_hash(sig)
        out = {"plan_hash": phash, "seeded": False, "recorded": False}
        with self._state_lock:
            known = sig in self._learned
        got = None if known else m.learned_for(phash)
        if got is not None:
            modes, caps = got
            with self._state_lock:
                self._learned.setdefault(sig, modes)
                if caps:
                    self._join_caps.setdefault(sig, caps)
            out["seeded"] = True
        return out

    def _record_in_manifest(self, sig: tuple, modes: Dict[int, int],
                            manifest: Dict[str, object]) -> None:
        m = self.manifest
        if m is not None and manifest:
            manifest["recorded"] = m.record_learned(
                manifest["plan_hash"], modes, self._caps_of(sig))

    def _modes_of(self, sig: tuple) -> Dict[int, int]:
        """A copy of the dense modes learned for the plan ``sig``."""
        with self._state_lock:
            return dict(self._learned.get(sig, {}))

    def _caps_of(self, sig: tuple) -> Dict[int, int]:
        """A copy of the join capacities learned for the plan ``sig``."""
        with self._state_lock:
            return dict(self._join_caps.get(sig, {}))

    @staticmethod
    def _carry(ctx, carried: Dict[str, int]) -> None:
        """Add a discarded attempt's retry and durability metrics to
        ``carried``."""
        for metrics in ctx.registry.snapshot().values():
            for name in _CARRIED_METRICS:
                v = metrics.get(name)
                if v:
                    carried[name] = carried.get(name, 0) + int(v)

    def _dispatch(self, physical, modes, mesh, growth, deadline, qos,
                  tracer, attempt: int, carried: Dict[str, int],
                  caps: Dict[int, int]):
        """One escalation attempt, re-run in place while it fails with a
        transient fault or an OOM that escaped every operator (after a
        synchronization and a full spill), up to
        ``spark.rapids.tpu.retry.maxRetries`` times. Returns (ctx,
        result, overflowed, tripped sites)."""
        dm = self.device_manager
        policy = R.RetryPolicy.from_conf(self.conf)
        tries = 0
        while True:
            ctx = E.ExecContext(self.device, modes, self.conf, trace=tracer,
                                catalog=dm.catalog,
                                fault_injector=self._fault_injector,
                                semaphore=dm.semaphore, deadline=deadline,
                                qos=qos)
            if mesh is None:
                ctx.join_caps = dict(caps)
                ctx.join_growth = growth
            timing = KCUDA.device_timing(ctx.kernel_events) \
                if ctx.registry.device_timing else contextlib.nullcontext()
            try:
                if deadline is not None:
                    deadline.check("session.dispatch", ctx, "TorchSession")
                maybe_inject(ctx, "session.dispatch")
                with TR.span(tracer, "session.dispatch", cat="session",
                             attempt=attempt - 1, retry=tries,
                             path="single" if mesh is None else "mesh"), \
                        timing, dm.semaphore:
                    try:
                        root = physical if isinstance(physical, HostExec) \
                            else E.DeviceToHostExec(physical)
                        if mesh is not None:
                            result, overflowed = MX.mesh_collect(
                                physical, ctx, mesh, growth)
                        elif self.conf.get(FUSION_ENABLED) and \
                                FU.fusable(root, self.conf):
                            result, overflowed = FU.fused_collect(root, ctx)
                        else:
                            with TR.span(tracer, "session.stream_collect",
                                         cat="dispatch"):
                                result = root.collect(ctx)
                            overflowed = FU.any_overflow(ctx)
                    finally:
                        # every attempt's look-ahead and shuffle blocks
                        # end with it, re-runs included
                        ctx.run_cleanups()
                    tripped = []
                    if not overflowed and ctx.dense_fails:
                        tripped = [s for (s, _), f in zip(
                            ctx.dense_fails, _host_flags(ctx.dense_fails))
                            if f]
                return ctx, result, overflowed, tripped
            except Exception as e:  # noqa: BLE001 - classified below
                cls = R.classify(e)
                if cls == R.Classification.FATAL \
                        or tries >= policy.max_retries:
                    raise
                real = not isinstance(e, InjectedFault)
            # the failed attempt's frames (and tensors) are released here
            self._carry(ctx, carried)
            if cls == R.Classification.OOM:
                with R._OOM_RECOVERY_LOCK:
                    R.synchronize_device(ctx, collect=real)
                R.spill_device_below(ctx)
            carried["retryCount"] = carried.get("retryCount", 0) + 1
            t0 = time.perf_counter_ns()
            R.backoff_sleep(policy, "session.dispatch", tries, ctx,
                            "TorchSession")
            carried["retryBlockTimeNs"] = carried.get(
                "retryBlockTimeNs", 0) + time.perf_counter_ns() - t0
            tries += 1

    # -- query-profile layer (metrics/) ---------------------------------------

    def _note_profile(self, profiler: QueryProfiler, physical, ctx, sig,
                      tracer) -> None:
        """Snapshot the finished query into the session's profile map, the
        last-slot shim and the event log. Query ids are assigned under the
        profile lock, so concurrent queries each get their own."""
        with self._profiles_lock:
            self._query_seq += 1
            qid = self._query_seq
        if tracer is not None:
            # the profile's id in the trace header joins the two records
            tracer.query_id = qid
        prof = profiler.finish(physical, ctx, sig, qid)
        log_dir = self.conf.metrics_event_log_dir
        with self._profiles_lock:
            self._profiles[qid] = prof
            while len(self._profiles) > self._MAX_PROFILES:
                self._profiles.pop(next(iter(self._profiles)))
            self._last_profile = prof
            log = None
            if log_dir:
                if self._event_log is None or self._event_log.dir != log_dir:
                    self._event_log = EventLog(
                        log_dir, int(self.conf.get(
                            METRICS_EVENT_LOG_MAX_BYTES)))
                log = self._event_log
        if log is not None:
            log.append(prof)

    def _export_trace(self, tracer: TR.Tracer) -> None:
        """Keep a session-made tracer as :meth:`last_trace` and export it
        beside the event log (best-effort: an export failure never fails
        the query)."""
        with self._state_lock:
            self._last_tracer = tracer
        TR.export_chrome(tracer, TR.export_dir(self.conf))

    def query_profile(self, query_id: int) -> Optional[QueryProfile]:
        """The profile recorded for ``query_id`` on this session, or None
        (evicted, metrics level NONE, or never run)."""
        with self._profiles_lock:
            return self._profiles.get(query_id)

    def last_query_profile(self) -> Optional[QueryProfile]:
        """The profile of the most recent query this session ran, or None
        (metrics level NONE, or nothing run yet). ``.render()`` draws it,
        ``.to_dict()`` serialises it."""
        with self._profiles_lock:
            return self._last_profile

    def last_trace(self) -> Optional[TR.Tracer]:
        """The span tracer of the most recent traced query, or None."""
        with self._state_lock:
            return self._last_tracer

    def explain_metrics(self, logical: L.LogicalPlan) -> str:
        """The metric-annotated EXPLAIN tree (``df.explain(metrics=True)``):
        the last profile when it belongs to this plan's shape, else the
        plain tree with a note."""
        physical = self.plan(logical)
        prof = self.last_query_profile()
        if prof is not None and \
                prof.plan_hash == plan_profile_hash(self._signature(physical)):
            return prof.render()
        return (physical.tree_string()
                + "(no QueryProfile recorded for this plan shape yet — run "
                ".collect() first, with spark.rapids.tpu.metrics.level "
                "above NONE)\n")
