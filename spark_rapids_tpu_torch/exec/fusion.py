"""Whole-stage fusion — port of ``spark_rapids_tpu/exec/fusion.py``.

The reference traces a query's device subtree into one jitted program;
the port runs it as one CUDA graph (:mod:`..compile.executables`):

* :func:`fusable` — True when the plan root is a
  :class:`~.execs.DeviceToHostExec`. Execs outside :data:`_INLINE`
  (scans, device sources, exchanges, windows, sorts, top-k, generate,
  nested-loop joins, shared subplans) become **boundaries**: they run
  eagerly first (:func:`.pipeline.materialize_boundaries`) and feed the
  region as its inputs. The port's planner gives every plan a device
  root, so every single-device plan is fusable.
* The region is cached per structural plan signature, learned modes and
  capacities (:data:`_FUSED_CACHE`), and each :class:`~..compile.
  executables.FusedProgram` keys its graphs by its inputs' shapes,
  dictionaries and resident tables; a device source is read in place
  (the graph's key names its address). Boundary inputs are not padded
  onto capacity tiers as the reference pads them: a key names every
  dictionary and resident table it reads, so the same plan over other
  data gets a new key whatever its shapes, and a tier would share no
  graph while every replay copied its padding.
* On the card, replaying is kept only where it pays (:class:`_PathChoice`):
  once a region is captured, its plan's warm runs alternate between a
  replay and the streaming path until each has ``SAMPLES`` wall times,
  and the plan then keeps the path with the lower best time
  (``QueryInfo.fusion["chosen"]``). The eager and capturing runs are no
  samples. On the CPU the region always runs on the fused path.
* A region whose first run synchronises with the host is refused: that
  run finishes it on the streaming path (the same execs over the same
  inputs, with the catalog, retries and host reads), later runs stream
  the whole plan, and the refusal is
  counted (``WholeStageFusion.fusionRefusals``), named in the
  ``fusion.dispatch`` span (``refused=<site>``) and in
  ``QueryInfo.fusion``.
* The result comes back in ONE transfer into one pinned buffer, the
  **head**: the row count, the inlined joins' overflow flags and totals,
  every dense-fail flag of the attempt (the boundaries' too) and the
  result batch cut to ``spark.rapids.tpu.collect.guessRows``. A larger
  result downloads the full batch, still resident, in a second transfer.
* An overflowed inlined join (its output sized from the probe's capacity
  times the growth, or from the capacity learned for its site) returns
  no result: the session learns the totals and re-runs.

A region that is a bare boundary (its root is not inline: a top-k, a
sort, a window) has nothing to capture; it takes the fused path for its
head only. The device source is a boundary here as in the reference;
the planner differs in its roots, not in its split.
"""

from __future__ import annotations

import itertools
import time
from typing import List, Optional, Tuple

import torch

from ..compile.executables import FusedProgram, HashedTuple, key_flatten
from ..config import COLLECT_GUESS_ROWS, FUSION_INLINE_JOINS
from ..data.batch import (HostBatch, HostCopy, flat_payload_fits,
                          host_batch, shrink_batch)
from ..data.column import bucket_capacity
from ..metrics import trace as TR
from ..ops.kernels import rowops as KR
from ..utils import lockdep
from ..utils.kernel_cache import plan_signature as _plan_sig
from .coalesce import CoalesceBatchesExec
from .execs import (DeviceSourceExec, DeviceToHostExec, ExecContext,
                    ExpandExec, FilterExec, HashAggregateExec, LimitExec,
                    ProjectExec, ShuffledHashJoinExec, TopKExec, TorchExec,
                    UnionExec, _coalesce_device)

#: The profile node of the fused dispatch's metrics.
NODE = "WholeStageFusion"


class _NotFusable(Exception):
    pass


class FusedInputExec(TorchExec):
    """Leaf of a fused region: the partitions of boundary ``index``,
    materialised before the dispatch (``ctx.fused_inputs``)."""

    def __init__(self, index: int, schema):
        self.children = []
        self.index = index
        self._schema = schema

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return f"FusedInput #{self.index}"

    def execute(self, ctx):
        return [iter(list(p)) for p in ctx.fused_inputs[self.index]]


#: Execs whose execute() runs without a host synchronisation on its
#: fused branch (``ctx.in_fusion``): inlined into the region. Everything
#: else becomes a boundary input.
_INLINE = (ProjectExec, FilterExec, HashAggregateExec, CoalesceBatchesExec,
           ExpandExec, UnionExec, LimitExec, FusedInputExec)

#: The top-k stays a boundary, as in the reference: its child subtree
#: then runs on the streaming path, where sparse join outputs shrink to
#: their live rows between operators.
assert TopKExec not in _INLINE


def _inline_types():
    """The inline set with the shuffled hash join
    (``spark.rapids.tpu.fusion.inlineJoins``)."""
    return _INLINE + (ShuffledHashJoinExec,)


def _is_boundary(p, inline=None) -> bool:
    return not isinstance(p, inline or _INLINE)


def _split(plan, boundaries: List, inline=None) -> TorchExec:
    """The region with every boundary subtree replaced by a
    :class:`FusedInputExec` leaf; boundaries are appended to
    ``boundaries`` in traversal order (the region's input order)."""
    inline = inline or _INLINE
    if not isinstance(plan, TorchExec):
        raise _NotFusable(type(plan).__name__)
    if _is_boundary(plan, inline):
        boundaries.append(plan)
        return FusedInputExec(len(boundaries) - 1, plan.schema)
    kids = [_split(c, boundaries, inline) for c in plan.children]
    return plan.with_children(kids) if kids else plan


def _conf_inline(conf):
    return _inline_types() if conf is not None \
        and conf.get(FUSION_INLINE_JOINS) else _INLINE


def fusable(root, conf=None) -> bool:
    if not isinstance(root, DeviceToHostExec):
        return False
    try:
        _split(root.children[0], [], _conf_inline(conf))
    except _NotFusable:
        return False
    return True


_CACHE_LOCK = lockdep.lock("fusion._CACHE_LOCK")
_FUSED_CACHE: dict = {}
#: Programs (by signature) whose fused dispatch ran out of memory: they
#: stream from then on (``OOM_SITE`` is their refusal's site).
_OOM_PLANS: dict = {}
OOM_SITE = "fused path out of memory"
#: Programs kept; the oldest is dropped past this (its graphs with it).
_MAX_PROGRAMS = 512


def fused_cache_size() -> int:
    """Fused programs kept (:data:`_FUSED_CACHE`)."""
    with _CACHE_LOCK:
        return len(_FUSED_CACHE)


def clear_fused_cache() -> None:
    from ..compile import executables
    executables.release_all()
    with _CACHE_LOCK:
        _FUSED_CACHE.clear()
        _OOM_PLANS.clear()


class _PathChoice:
    """Replay or stream, per plan on the card, from the plan's own warm
    runs: their wall times (from the fused path's entry to the result on
    the host) are taken alternately, a replay then a streaming run,
    until each path has ``SAMPLES``; the path with the lower best time
    is then kept (``path``). A CUDA graph saves the launches' host time
    but adds the dispatch's (input key, copy-in, head), so which one wins
    depends on the plan."""

    SAMPLES = 2

    def __init__(self):
        self.fused: List[int] = []
        self.stream: List[int] = []
        self.path: Optional[str] = None

    def next(self) -> str:
        """``"fused"`` or ``"stream"``: the path of the next run."""
        if self.path is not None:
            return self.path
        return "stream" if len(self.stream) < len(self.fused) else "fused"

    def note(self, path: str, ns: int) -> None:
        """One sample of ``path`` (a replay's or a streaming run's)."""
        if self.path is not None:
            return
        (self.fused if path == "fused" else self.stream).append(ns)
        if min(len(self.fused), len(self.stream)) >= self.SAMPLES:
            self.path = "fused" if min(self.fused) <= min(self.stream) \
                else "stream"


def _choice_for(prog, ctx: ExecContext) -> Optional[_PathChoice]:
    """The plan's replay-or-stream choice; None on the CPU, where the
    region always runs on the fused path."""
    return prog.choice if ctx.device.type == "cuda" else None


def _region_outputs(fused_plan, guess_rows: int):
    """The region's callable: ``run(inputs, ictx)`` executes the region
    in the fused context ``ictx`` and returns its outputs: the result
    batch (physical; None without batches), its head cut, the deferred
    flags and totals, and the host metadata a replay cannot recompute
    (the sites it numbered)."""

    def run(inputs, ictx: ExecContext):
        ictx.fused_inputs = inputs
        outs = []
        for part in fused_plan.execute(ictx):
            outs.extend(part)
        meta = {"site_kinds": tuple(ictx.site_kinds),
                "site_ids": tuple(ictx.site_ids), "seq": ictx._site_seq,
                "fail_sites": tuple(s for s, _ in ictx.dense_fails),
                "total_sites": tuple(s for s, _ in ictx.join_totals)}
        res = {"meta": meta,
               "fails": [f.reshape(()) for _, f in ictx.dense_fails],
               "flags": [f.reshape(()) for f in ictx.overflow_flags],
               "totals": [t.reshape(()) for _, t in ictx.join_totals],
               "batch": None, "shrunk": None}
        if outs:
            batch = KR.physical(_coalesce_device(outs))
            guess_cap = min(batch.capacity, bucket_capacity(guess_rows))
            res["batch"] = batch
            res["shrunk"] = shrink_batch(batch, guess_cap)
        return res
    return run


class _Head:
    """What the head transfer brought back: ``n`` rows (None: no
    batch), the flags and totals as host values, the result, its bytes
    and whether the guess missed."""

    def __init__(self):
        self.n = None
        self.fails: List[bool] = []
        self.flags: List[bool] = []
        self.totals: List[int] = []
        self.boundary_fails: List[bool] = []
        self.result: Optional[HostBatch] = None
        self.nbytes = 0
        self.guess_miss = False


def _download_head(out: dict, boundary_fails: list, schema) -> _Head:
    """The head of a region's outputs in one transfer (plus the full
    batch when the guess missed)."""
    head = _Head()
    tree = {"n": None if out["batch"] is None else out["batch"].n_rows,
            "fails": out["fails"], "flags": out["flags"],
            "totals": out["totals"], "bfails": boundary_fails,
            "shrunk": out["shrunk"]}
    hc = HostCopy(tree).begin()
    with lockdep.blocking("fusion.head"):
        got = hc.finish()
    head.nbytes = hc.nbytes
    head.fails = [bool(f) for f in got["fails"]]
    head.flags = [bool(f) for f in got["flags"]]
    head.totals = [int(t) for t in got["totals"]]
    head.boundary_fails = [bool(f) for f in got["bfails"]]
    if got["n"] is None:
        return head
    head.n = int(got["n"])
    if head.flags and any(head.flags):
        return head  # discarded: the session re-runs
    shrunk = got["shrunk"]
    if head.n <= shrunk.capacity and flat_payload_fits(shrunk):
        head.result = host_batch(shrunk, schema)
        return head
    head.guess_miss = True
    # the rows are known now: they come lane by lane, as the streaming
    # path downloads (a pinned copy of a large result, copied out again
    # on the host, is the slower route)
    head.result = HostBatch.from_device(out["batch"])
    head.nbytes += head.result.nbytes
    return head


def fused_collect(root: DeviceToHostExec, ctx: ExecContext
                  ) -> Tuple[Optional[HostBatch], bool]:
    """Run a fusable plan: its boundaries, then its region as one CUDA
    graph (or eagerly, on its first run, on the CPU, or when refused),
    then the head transfer; or, where the plan's warm runs showed the
    streaming path faster (:class:`_PathChoice`), stream it. Returns
    ``(result, overflowed)``; the result is None when an inlined join
    overflowed and the session must re-run with the capacities learned
    into ``ctx.join_totals``. Leaves what it did in ``ctx.fusion``, with
    the host's time by step (``host_us``)."""
    t_start = time.perf_counter_ns()
    device_plan = root.children[0]
    conf = ctx.conf
    boundaries: List = []
    fused_plan = _split(device_plan, boundaries, _conf_inline(conf))
    reg = ctx.registry
    info = {"boundaries": len(boundaries), "action": "head", "site": "",
            "capture_ms": 0.0, "pool_bytes": 0, "head_bytes": 0,
            "guess_miss": False, "chosen": None, "host_us": {}}
    ctx.fusion = info
    guess_rows = int(conf.get(COLLECT_GUESS_ROWS))
    if isinstance(fused_plan, FusedInputExec):
        return _bare_boundary(root, ctx, boundaries[0], guess_rows)
    sig = HashedTuple((_plan_sig(fused_plan), float(ctx.join_growth),
                       guess_rows, tuple(sorted(ctx.join_caps.items())),
                       tuple(sorted(ctx.dense_modes.items())),
                       ctx._site_seq))
    info["host_us"]["signature"] = (time.perf_counter_ns() - t_start) / 1e3
    with _CACHE_LOCK:
        site = OOM_SITE if sig in _OOM_PLANS else None
        prog = _FUSED_CACHE.get(sig)
        if prog is None:
            prog = FusedProgram(_region_outputs(fused_plan, guess_rows),
                                label=type(device_plan).__name__)
            prog.choice = _PathChoice()
            _FUSED_CACHE[sig] = prog
            while len(_FUSED_CACHE) > _MAX_PROGRAMS:
                old = _FUSED_CACHE.pop(next(iter(_FUSED_CACHE)))
                for key in list(old._table):
                    old._drop(key)
        else:
            _FUSED_CACHE[sig] = _FUSED_CACHE.pop(sig)  # most recent last
    if site is None:
        site = prog.refused_site
    if site is not None:
        # the region synchronised with the host in an earlier run, or its
        # fused dispatch ran out of memory (its boundaries all held at
        # once, the graph's pool): the plan streams, batch by batch, from
        # then on
        info.update(action="refused", site=site)
        reg.add(NODE, "fusionRefusals", 1)
        return DeviceToHostExec(device_plan).collect(ctx), \
            any_overflow(ctx)
    choice = _choice_for(prog, ctx)
    if choice is not None and choice.next() == "stream":
        # a sample while the choice is open ("trial"), else the choice
        info["action"] = "trial" if choice.path is None else "stream"
        reg.add(NODE, "fusionStreamed", 1)
        result = DeviceToHostExec(device_plan).collect(ctx)
        overflowed = any_overflow(ctx)
        choice.note("stream", time.perf_counter_ns() - t_start)
        info["chosen"] = choice.path
        return result, overflowed
    try:
        got = _fused_dispatch(root, ctx, fused_plan, boundaries, prog)
    except torch.OutOfMemoryError:
        # the session's retry drains the card and re-runs the attempt,
        # which then streams this plan
        with _CACHE_LOCK:
            _OOM_PLANS[sig] = None
            while len(_OOM_PLANS) > _MAX_PROGRAMS:
                _OOM_PLANS.pop(next(iter(_OOM_PLANS)))
        raise
    if choice is not None and info["action"] == "replay":
        choice.note("fused", time.perf_counter_ns() - t_start)
        info["chosen"] = choice.path
    return got


def _fused_dispatch(root, ctx, fused_plan, boundaries, prog):
    device_plan = root.children[0]
    reg = ctx.registry
    tr = ctx.trace
    info = ctx.fusion
    host_us = info["host_us"]
    guess_rows = int(ctx.conf.get(COLLECT_GUESS_ROWS))
    from . import pipeline as _pipeline
    t = time.perf_counter_ns()
    with TR.span(tr, "fusion.boundaries", cat="dispatch",
                 n=len(boundaries)):
        inputs = _pipeline.materialize_boundaries(boundaries, ctx)
    t_dispatch = time.perf_counter_ns()
    host_us["boundaries"] = (t_dispatch - t) / 1e3
    # boundary fails ride the head too: one transfer for every flag
    bfails = [f.reshape(()) for _, f in ctx.dense_fails]
    bfail_sites = [s for s, _ in ctx.dense_fails]
    timed = reg.device_timing and ctx.device.type == "cuda"
    if timed:
        # under deviceTiming the region runs eagerly, so each launch
        # keeps its event pair (a graph's launches cannot be timed one by
        # one); the region's own pair is its deviceTime
        info["action"] = "eager"
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
        out = _region_outputs(fused_plan, guess_rows)(
            inputs, ctx.fork_for_region())
        events[1].record()
        with TR.span(tr, "fusion.download", cat="download"):
            head = _download_head(out, bfails, root.schema)
        reg.add(NODE, "deviceTime",
                int(events[0].elapsed_time(events[1]) * 1e6))
        return _finish(root, ctx, out["meta"], head, bfail_sites,
                       t_dispatch)
    # one pass over each boundary: the device sources' leaves are
    # resident
    flats = [key_flatten(b) for b in inputs]
    resident_ids = frozenset(
        id(t) for b, (leaves, _, _) in zip(boundaries, flats)
        if isinstance(b, DeviceSourceExec) for t in leaves)
    flat = ([t for leaves, _, _ in flats for t in leaves],
            ("seq", False, tuple(skey for _, skey, _ in flats)),
            [r for _, _, refs in flats for r in refs])
    key, refs = prog.key_of(inputs, resident_ids, flat)
    captured_before = prog.jit_compiled(key)
    t_key = time.perf_counter_ns()
    host_us["key"] = (t_key - t_dispatch) / 1e3

    def consume(out):
        if out is None:
            return None
        host_us["region"] = (time.perf_counter_ns() - t_key) / 1e3
        t_head = time.perf_counter_ns()
        with TR.span(tr, "fusion.download", cat="download"):
            head = _download_head(out, bfails, root.schema)
        host_us["head"] = (time.perf_counter_ns() - t_head) / 1e3
        return out, head

    with TR.span(tr, "fusion.dispatch", cat="dispatch") as sp, \
            lockdep.blocking("fusion.dispatch"):
        got = prog(inputs, ctx.fork_for_region(), consume,
                   resident_ids, key=key, refs=refs, flat=flat)
        last = prog.last
        info["action"] = last.get("action", "cpu")
        if sp is not None:
            if not captured_before and prog.jit_compiled(key):
                sp.annotate(compiled=True)
            if last.get("action") == "refused":
                sp.annotate(refused=last["site"])
    if last.get("action") == "capture":
        info["capture_ms"] = last["capture_ms"]
        info["pool_bytes"] = last["pool_bytes"]
        reg.add(NODE, "fusionCaptures", 1)
        TR.record_event("compile.fused", plan=prog.label,
                        secs=round(last["capture_ms"] / 1e3, 3))
    elif last.get("action") == "replay":
        info["pool_bytes"] = last["pool_bytes"]
        reg.add(NODE, "fusionReplays", 1)
    if "launches" in last:
        from ..ops.kernels import cuda as KCUDA
        info["graph_launches"] = KCUDA.by_family(last["launches"])
    if got is None:
        # refused: the region runs on the streaming path over the same
        # inputs, with the catalog, retries and host reads
        info["site"] = last["site"]
        reg.add(NODE, "fusionRefusals", 1)
        ctx.fused_inputs = inputs
        result = DeviceToHostExec(fused_plan).collect(ctx)
        node = device_plan.node_name()
        ctx.registry.set_value(node, "numOutputRows", result.num_rows)
        reg.add(NODE, "opTime", time.perf_counter_ns() - t_dispatch)
        return result, any_overflow(ctx)
    out, head = got
    return _finish(root, ctx, out["meta"], head, bfail_sites, t_dispatch)


class _Batches(TorchExec):
    """One partition of already-started batches (a boundary's stream)."""

    def __init__(self, batches, schema):
        self.children = []
        self.batches = batches
        self._schema = schema

    @property
    def schema(self):
        return self._schema

    def execute(self, ctx):
        return [self.batches]


def _bare_boundary(root, ctx: ExecContext, boundary, guess_rows: int):
    """A region that is one boundary (a top-k, sort or window root):
    nothing to capture. Its batches are pulled one by one; a single
    batch (or none) comes back through the head, with every flag in the
    same transfer; a stream of them (an external sort's chunks, a
    chunked window) is downloaded batch by batch as the streaming path
    does, never held on the card all at once."""
    t_dispatch = time.perf_counter_ns()
    with TR.span(ctx.trace, "fusion.boundaries", cat="dispatch", n=1):
        it = (b for part in boundary.execute(ctx) for b in part)
        first = next(it, None)
        second = next(it, None) if first is not None else None
    if second is not None:
        ctx.fusion["action"] = "stream"
        rest = itertools.chain((first, second), it)
        result = DeviceToHostExec(_Batches(rest, root.schema)).collect(ctx)
        node = root.children[0].node_name()
        ctx.registry.set_value(node, "numOutputRows", result.num_rows)
        ctx.registry.add(NODE, "opTime", time.perf_counter_ns() - t_dispatch)
        return result, any_overflow(ctx)
    inputs = (((first,),) if first is not None else ((),),)
    bfails = [f.reshape(()) for _, f in ctx.dense_fails]
    bfail_sites = [s for s, _ in ctx.dense_fails]
    region = FusedInputExec(0, root.schema)
    out = _region_outputs(region, guess_rows)(inputs, ctx.fork_for_region())
    with TR.span(ctx.trace, "fusion.download", cat="download"):
        head = _download_head(out, bfails, root.schema)
    return _finish(root, ctx, out["meta"], head, bfail_sites, t_dispatch)


def _finish(root, ctx: ExecContext, meta: dict, head: _Head,
            bfail_sites: list, t_dispatch: int):
    """Apply a head to the attempt: the region's sites and flags into
    ``ctx`` (as host values), its metrics, and the result."""
    info = ctx.fusion
    reg = ctx.registry
    ctx.site_kinds.extend(meta["site_kinds"])
    ctx.site_ids.extend(meta["site_ids"])
    ctx._site_seq = meta["seq"]
    ctx.dense_fails = list(zip(bfail_sites, head.boundary_fails)) + \
        list(zip(meta["fail_sites"], head.fails))
    ctx.join_totals = list(zip(meta["total_sites"], head.totals))
    ctx.overflow_flags = list(head.flags)
    info["head_bytes"] = head.nbytes
    info["guess_miss"] = head.guess_miss
    reg.add(NODE, "opTime", time.perf_counter_ns() - t_dispatch)
    reg.add(NODE, "downloadBytes", head.nbytes)
    if head.flags and any(head.flags):
        return None, True
    result = head.result if head.result is not None else \
        HostBatch.empty(root.schema)
    node = root.children[0].node_name()
    reg.add(NODE, "numOutputRows", result.num_rows)
    ctx.registry.set_value(node, "numOutputRows", result.num_rows)
    ctx.metric(node, "downloadBytes", result.nbytes)
    return result, False


def any_overflow(ctx: ExecContext) -> bool:
    """One deferred check of the streaming path's overflow flags (one
    transfer; False without flags)."""
    if not ctx.overflow_flags:
        return False
    flags = ctx.overflow_flags
    if all(isinstance(f, bool) for f in flags):
        return any(flags)
    return bool(torch.stack([torch.as_tensor(f).reshape(())
                             for f in flags]).any())
