"""Partitioned query execution over the device mesh — port of
``spark_rapids_tpu/exec/mesh.py``.

With ``spark.rapids.tpu.mesh.enabled`` the session runs a mesh-capable
plan as one partitioned program over a :class:`~..parallel.mesh.Mesh`:

    per shard: filter -> project -> partial aggregate   (single-device ops)
    exchange:  murmur3 pmod n (or a sampled range) -> all_to_all
    per shard: merge aggregate / local join / local sort -> finalize
    collect:   each shard's rows, in shard order

Sources shard row-wise; narrow operators run on each shard with the same
code as the single-device path; aggregate, join and sort boundaries
exchange rows (:mod:`..shuffle.ici`) so that rows with equal keys (or
one key range) meet on one shard, where the ordinary local operator
finishes the job. The program works on lists of per-shard batches, one
shard after another (:mod:`..parallel.mesh`).

Strings qualify only dictionary-encoded: the int32 codes shard and move
like any fixed-width lane, and each shard's columns carry the dictionary
and its device bytes (on the shard's device), so codes keep their
meaning after an exchange. An expression that produces a string is
refused, since it could give flat per-shard payloads.

Exchange buckets are bounded; every exchange and every join reports an
overflow flag, the program reads them all in one host transfer, and the
session re-runs an overflowed query with larger buckets. A node this
module has no story for raises :class:`NotMeshCapable`, and the query
runs on the single-device path: the cross join, outer joins, the
shuffle exchange, multi-key, string and float join keys, and windows.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import types as T
from ..data.batch import ColumnarBatch, HostBatch
from ..data.column import DeviceColumn, bucket_capacity
from ..ops.expression import Alias, AttributeReference, BoundReference
from ..ops.kernels import rowops as KR
from ..ops.kernels.groupby import _max_value, _min_value
from ..parallel import mesh as PM
from ..shuffle import ici
from ..shuffle.partitioning import pmod_partition, spark_hash_columns_device
from . import execs as E

Shards = List[ColumnarBatch]

#: Samples per shard for the range bounds of the sort: ``n_parts * 64``
#: candidates put a bound within 1/64 of a shard of its target, well
#: inside the sort's 2x bucket slack.
_SORT_SAMPLES = 64


class NotMeshCapable(Exception):
    pass


def _require(cond: bool, why: str) -> None:
    if not cond:
        raise NotMeshCapable(why)


@dataclasses.dataclass
class _Run:
    """One run of a compiled program: the mesh, the bucket growth, the
    execution context (timings), the overflow flags raised so far and
    the sharded sources by index."""
    mesh: PM.Mesh
    growth: float
    ctx: E.ExecContext
    flags: List[torch.Tensor]
    env: Dict[int, Shards]


Program = Callable[[_Run], Shards]


# --------------------------------------------------------------------------
# Exchange: partition each shard's rows and all_to_all them
# --------------------------------------------------------------------------


def _exchange_by_key(run: _Run, batches: Shards, key_exprs,
                     bucket_cap: int) -> Shards:
    """Rows move to the shard Spark's murmur3 of the keys pmod n names
    (string keys through the ``hash`` kernel)."""
    pids = []
    for b in batches:
        keys = [e.eval_device(b) for e in key_exprs]
        pids.append(pmod_partition(spark_hash_columns_device(keys),
                                   run.mesh.size))
    return _exchange_by_pid(run, batches, pids, bucket_cap)


def _exchange_by_pid(run: _Run, batches: Shards, pids, bucket_cap: int
                     ) -> Shards:
    """Rows move to the shard their ``pid`` names: the hash exchange of
    aggregates and joins, the range exchange of the sort. A dictionary
    column moves its codes; the receiving shard's own column supplies the
    dictionary. Appends each shard's overflow flag to ``run.flags``."""
    n_parts = run.mesh.size
    # A sender fills at most its capacity of one bucket, so a larger
    # bucket holds nothing more: shards that share a card would only
    # share more memory (the growth escalation multiplies every bucket).
    bucket_cap = min(bucket_cap, max(b.capacity for b in batches))
    sends, send_valids = [], []
    for b, pid in zip(batches, pids):
        payload = {}
        for i, c in enumerate(b.columns):
            payload[f"d{i}"] = c.lane
            payload[f"v{i}"] = c.validity
        send, send_valid, overflow = ici.build_send_buffers(
            payload, torch.ones(b.capacity, dtype=torch.bool,
                                device=b.device),
            pid, b.row_mask(), n_parts, bucket_cap)
        run.flags.append(overflow > 0)
        sends.append(send)
        send_valids.append(send_valid)
    recv, recv_valid = ici.exchange(run.mesh, sends, send_valids)
    out = []
    for b, r, rv in zip(batches, recv, recv_valid):
        flat, flat_valid, n_live = ici.flatten_received(r, rv)
        cols = []
        for i, c in enumerate(b.columns):
            validity = flat[f"v{i}"] & flat_valid
            lane = flat[f"d{i}"]
            lane = torch.where(validity, lane, torch.zeros(
                (), dtype=lane.dtype, device=lane.device))
            cols.append(c.replace_rows(validity, lane))
        out.append(ColumnarBatch(tuple(cols), n_live, b.schema))
    return out


# --------------------------------------------------------------------------
# Plan -> per-shard program
# --------------------------------------------------------------------------


def _is_column_ref(e) -> bool:
    inner = e.children[0] if isinstance(e, Alias) else e
    return isinstance(inner, (AttributeReference, BoundReference))


def _compile(node: E.TorchExec, sources: List[E.DeviceSourceExec]
             ) -> Program:
    """Translate a plan subtree into ``program(run) -> per-shard
    batches``; ``sources`` collects the source execs in visiting order,
    which indexes ``run.env``. Raises :class:`NotMeshCapable` for a node
    without a mesh story."""
    if isinstance(node, E.DeviceSourceExec):
        for c, f in zip(node.batch.columns, node.schema):
            if f.data_type is T.STRING:
                _require(c.is_dict, "flat (non-dictionary) string column "
                                    "in a mesh source")
        sources.append(node)
        idx = len(sources) - 1
        return lambda run: run.env[idx]

    if isinstance(node, E.ProjectExec):
        for e in node.exprs:
            if e.data_type is T.STRING:
                _require(_is_column_ref(e), "string-producing expression "
                                            "over the mesh")
        child = _compile(node.children[0], sources)
        bound = E._bind_all(node.exprs, node.children[0].schema)
        schema = node.schema

        def project(run):
            bs = child(run)
            with run.ctx.timed(node.name):
                return [b.with_columns([e.eval_device(b) for e in bound],
                                       schema) for b in bs]
        return project

    if isinstance(node, E.FilterExec):
        child = _compile(node.children[0], sources)
        cond = node.condition.bind(node.schema)

        def filt(run):
            bs = child(run)
            with run.ctx.timed(node.name):
                out = []
                for b in bs:
                    m = cond.eval_device(b)
                    out.append(KR.compact(b, m.data & m.validity))
                return out
        return filt

    if isinstance(node, E.HashAggregateExec):
        child = _compile(node.children[0], sources)
        if not node.groupings:
            return _compile_global_agg(node, child)
        for g in node.groupings:
            if g.data_type is T.STRING:
                _require(_is_column_ref(g), "computed string grouping key "
                                            "over the mesh")
        return _compile_grouped_agg(node, child)

    if isinstance(node, E.ShuffledHashJoinExec):
        return _compile_join(node, sources)

    if isinstance(node, E.SortExec):
        return _compile_sort(node, sources)

    raise NotMeshCapable(type(node).__name__)


def _compile_grouped_agg(node: E.HashAggregateExec, child: Program
                         ) -> Program:
    """Partial aggregate per shard, the hash exchange of the partials by
    their keys, the merge per shard, the final projection. Always the
    exact paths (dictionary or sort, ``dense_mode=1``): the mesh's growth
    retry cannot learn dense-mode flags."""
    groupings, aggs, buf_schema, key_refs = node.bind()
    n_keys = len(groupings)

    def agg(run):
        local = child(run)
        with run.ctx.timed(node.name):
            parts = [E.aggregate_batch(b, groupings, aggs, buf_schema,
                                       n_keys, True, dense_mode=1)[0]
                     for b in local]
        cap = max(max(p.capacity for p in parts) // run.mesh.size, 128)
        with run.ctx.timed(node.name + ".exchange"):
            shuffled = _exchange_by_key(run, parts, key_refs,
                                        bucket_capacity(int(cap * run.growth)))
        with run.ctx.timed(node.name + ".merge"):
            merged = [E.aggregate_batch(b, key_refs, aggs, buf_schema,
                                        n_keys, False, dense_mode=1)[0]
                      for b in shuffled]
            return [node.finalize(b) for b in merged]
    return agg


def _compile_global_agg(node: E.HashAggregateExec, child: Program
                        ) -> Program:
    """Aggregate without keys: partial buffers per shard, then one
    reduction over the shards per buffer (sum, min or max; a float min
    is NaN only when every shard's is, a float max when any shard's is,
    Spark's NaN order), and the one output row on shard 0 only."""
    _, aggs, buf_schema, _ = node.bind()
    merge_ops = [s.merge_op for a in aggs for s in a.func.buffers()]
    for op in merge_ops:
        _require(op in ("sum", "count", "min", "max"),
                 f"global-aggregate merge op {op!r} over the mesh")

    def gagg(run):
        local = child(run)
        mesh = run.mesh
        with run.ctx.timed(node.name):
            parts = [E.aggregate_batch(b, [], aggs, buf_schema, 0, True)[0]
                     for b in local]
        with run.ctx.timed("MeshReduce"):
            row0 = [torch.arange(p.capacity, device=p.device) == 0
                    for p in parts]
            cols: List[List[DeviceColumn]] = [[] for _ in parts]
            for ci, op in enumerate(merge_ops):
                cs = [p.columns[ci] for p in parts]
                valid = [c.validity & r for c, r in zip(cs, row0)]
                any_valid = PM.pmax(mesh, [v.to(torch.int32) for v in valid])
                if op in ("sum", "count"):
                    data = PM.psum(mesh, [torch.where(
                        v, c.data, torch.zeros((), dtype=c.data.dtype,
                                               device=c.device))
                        for c, v in zip(cs, valid)])
                else:
                    # A float shard's partial is NaN when all its values
                    # were (min) or any was (max): NaN partials sit out
                    # the reduction, and the answer is one canonical NaN
                    # when no partial is a number (min) or one is NaN
                    # (max), Spark's NaN order.
                    lo = op == "min"
                    dtype = cs[0].data.dtype
                    num = [v & ~torch.isnan(c.data) for c, v in zip(cs, valid)]
                    ident = _max_value(dtype) if lo else _min_value(dtype)
                    data = (PM.pmin if lo else PM.pmax)(mesh, [
                        torch.where(n, c.data, ident)
                        for c, n in zip(cs, num)])
                    if dtype.is_floating_point:
                        seen = PM.pmax(mesh, [
                            (n if lo else v & ~n).to(torch.int32)
                            for n, v in zip(num, valid)])
                        data = [torch.where((h == 0) if lo else (h > 0),
                                            float("nan"), d)
                                for h, d in zip(seen, data)]
                for s, c in enumerate(cs):
                    v = (any_valid[s] > 0) & row0[s]
                    d = torch.where(v, data[s], torch.zeros(
                        (), dtype=data[s].dtype, device=c.device))
                    cols[s].append(DeviceColumn(d, v, c.dtype))
            mine = PM.axis_index(mesh)
            merged = [ColumnarBatch(tuple(cs), (m == 0).to(torch.int64),
                                    buf_schema)
                      for cs, m in zip(cols, mine)]
        with run.ctx.timed(node.name):
            return [node.finalize(b) for b in merged]
    return gagg


def _compile_join(node: E.ShuffledHashJoinExec,
                  sources: List[E.DeviceSourceExec]) -> Program:
    """Co-partitioned equi join: both sides exchange by their keys, so
    equal keys meet on one shard and the local exact join is globally
    right (inner, semi and anti)."""
    jt = node.join_type
    _require(jt in ("inner", "left_semi", "left_anti"),
             f"{jt} join over the mesh")
    _require(len(node.left_keys) == 1,
             "multi-key join over the mesh")
    _require(node.condition is None,
             "join with a residual condition over the mesh")
    for k in node.left_keys + node.right_keys:
        _require(k.data_type is not T.STRING and not k.data_type.is_floating,
                 "string or float join key over the mesh")
    left, right = node.children
    lfn = _compile(left, sources)
    rfn = _compile(right, sources)
    lkeys = E._bind_all(node.left_keys, left.schema)
    rkeys = E._bind_all(node.right_keys, right.schema)
    schema = node.schema

    def join(run):
        probe = lfn(run)
        build = rfn(run)
        n_parts = run.mesh.size
        # The output holds the larger side's shard capacity times the
        # growth. The reference sizes it from the exchanged probe, whose
        # capacity already carries the growth (so its output grows with
        # the growth's square), and a small probe side with many matches
        # (Q3's customers) then overflows at growth 1 and re-runs the
        # whole query 8x larger. The larger side's capacity before the
        # exchange holds a foreign-key join's matches at growth 1 and
        # grows linearly, which shards sharing a card can hold.
        out_cap = bucket_capacity(max(
            int(max(probe[0].capacity, build[0].capacity) * run.growth),
            128))
        with run.ctx.timed(node.name + ".exchange"):
            pcap = bucket_capacity(max(
                int(probe[0].capacity * run.growth) // n_parts, 128))
            bcap = bucket_capacity(max(
                int(build[0].capacity * run.growth) // n_parts, 128))
            probe = _exchange_by_key(run, probe, lkeys, pcap)
            build = _exchange_by_key(run, build, rkeys, bcap)
        with run.ctx.timed(node.name):
            outs = []
            for p, b in zip(probe, build):
                pk = [e.eval_device(p) for e in lkeys]
                bk = [e.eval_device(b) for e in rkeys]
                out, total = E.join_exact(jt, p, b, pk, bk, schema, out_cap)
                if total is not None:
                    run.flags.append(total > out_cap)
                outs.append(out)
            return outs
    return join


def _sort_mesh_ok(node: E.SortExec) -> bool:
    """The range sort needs every string sort key to be a column."""
    return all(_is_column_ref(o.child) for o in node.orders
               if o.child.data_type is T.STRING)


def _compile_sort(node: E.SortExec, sources: List[E.DeviceSourceExec]
                  ) -> Program:
    """Distributed ORDER BY: each shard samples its first sort key, the
    samples all_gather into global range bounds, rows exchange to the
    shard that owns their range (ties share a shard, since bounds are
    values), and the local sort finishes each shard. Shard ``s`` then
    holds range ``s``, so the shards in order are the total order."""
    _require(_sort_mesh_ok(node), "computed string sort key over the mesh")
    child = _compile(node.children[0], sources)
    key_exprs = E._bind_all([o.child for o in node.orders], node.schema)
    asc = [o.ascending for o in node.orders]
    nfirst = [o.effective_nulls_first for o in node.orders]

    def rank_lane(col: DeviceColumn) -> torch.Tensor:
        """The first key as a lane in ascending rank space: codes of a
        sorted dictionary, the raw data otherwise; descending flips with
        bitwise NOT for integers (no overflow at the minimum, where
        negation wraps) and negation for floats."""
        if col.is_dict and not col.dict_sorted:
            raise ValueError("an unsorted dictionary reached the mesh sort")
        lane = col.lane
        if lane.dtype == torch.bool:
            lane = lane.to(torch.int32)
        if not asc[0]:
            lane = -lane if lane.is_floating_point() else ~lane
        return lane

    def sortfn(run):
        bs = [KR.physical(b) for b in child(run)]
        mesh = run.mesh
        n_parts = mesh.size
        with run.ctx.timed("MeshRangeBounds"):
            lanes, k0s, samples, sflags = [], [], [], []
            for b in bs:
                k0 = key_exprs[0].eval_device(b)
                lane = rank_lane(k0)
                pick = torch.arange(_SORT_SAMPLES, device=b.device)
                pos = (pick * b.n_rows) // _SORT_SAMPLES
                at = pos.clamp(0, lane.shape[0] - 1)
                samp = lane[at]
                ok = (pick < b.n_rows) & k0.validity[at]
                if lane.is_floating_point():
                    ok = ok & ~torch.isnan(samp)  # NaN routes apart, below
                lanes.append(lane)
                k0s.append(k0)
                samples.append(samp)
                sflags.append(ok)
            all_s = PM.all_gather(mesh, samples)[0].reshape(-1)
            all_f = PM.all_gather(mesh, sflags)[0].reshape(-1)
            hi = torch.finfo(all_s.dtype).max if all_s.is_floating_point() \
                else torch.iinfo(all_s.dtype).max
            ordered = torch.sort(torch.where(all_f, all_s, hi)).values
            total = all_f.sum()
            b_idx = (torch.arange(1, n_parts, device=total.device) * total) \
                // n_parts
            bounds = torch.where(
                total > 0, ordered[b_idx.clamp(0, ordered.shape[0] - 1)], hi)
            bounds = PM.replicate(mesh, bounds)
            pids = []
            for lane, k0, bnd in zip(lanes, k0s, bounds):
                pid = (lane[:, None] > bnd[None, :]).sum(1)
                if lane.is_floating_point():
                    # Spark: NaN is the largest value, so the last shard
                    # ascending and shard 0 descending.
                    pid = torch.where(torch.isnan(lane),
                                      n_parts - 1 if asc[0] else 0, pid)
                # Nulls first (in the ORDER BY's own direction) go to
                # shard 0; the direction is already folded into the lane.
                pid = torch.where(k0.validity, pid,
                                  0 if nfirst[0] else n_parts - 1)
                pids.append(pid.to(torch.int32))
        with run.ctx.timed(node.name + ".exchange"):
            bucket = bucket_capacity(max(
                int(2 * bs[0].capacity * run.growth) // n_parts, 128))
            shuffled = _exchange_by_pid(run, bs, pids, bucket)
        with run.ctx.timed(node.name):
            out = []
            for b in shuffled:
                keys = [e.eval_device(b) for e in key_exprs]
                out.append(KR.sort_batch_by_columns(b, keys, asc, nfirst))
            return out
    return sortfn


# --------------------------------------------------------------------------
# Capability, sources and the collect
# --------------------------------------------------------------------------


def _split_tail(plan: E.TorchExec):
    """``(tail, core)``: the single-device finishers above the last wide
    operator (top-k, limit, and the projections and non-mesh sorts
    between them) peel off the mesh core and run on its collected result,
    as the reference finishes a LIMIT on the driver. A sort the range
    sort can take stays in the core."""
    always = (E.TopKExec, E.LimitExec)

    def peelable(n):
        return isinstance(n, always + (E.ProjectExec,)) or (
            isinstance(n, E.SortExec) and not _sort_mesh_ok(n))

    def prefix_has_ordered(n):
        while peelable(n):
            if isinstance(n, always + (E.SortExec,)):
                return True
            n = n.children[0]
        return False

    tail = []
    node = plan
    while peelable(node) and prefix_has_ordered(node):
        tail.append(node)
        node = node.children[0]
    return tail, node


def _collect_sources(node: E.TorchExec, out: List) -> None:
    """Source execs in the order :func:`_compile` visits them."""
    if isinstance(node, E.DeviceSourceExec):
        out.append(node)
        return
    for c in node.children:
        _collect_sources(c, out)


def _encoding_fingerprint(root: E.TorchExec) -> tuple:
    """Per source, which string columns are dictionaries: it lives in the
    data, not in the plan's text, and capability depends on it."""
    sources: List[E.DeviceSourceExec] = []
    _collect_sources(root, sources)
    return tuple(tuple(c.is_dict if f.data_type is T.STRING else None
                       for c, f in zip(s.batch.columns, s.schema))
                 for s in sources)


def mesh_capable(root: E.TorchExec, cache: Optional[dict] = None) -> bool:
    """Whether the plan's core (below its peeled tail) compiles for the
    mesh. ``cache`` (the session's) keeps the answer per plan text and
    string encoding."""
    sig = (root.tree_string(), _encoding_fingerprint(root))
    if cache is not None and sig in cache:
        return cache[sig]
    try:
        _compile(_split_tail(root)[1], [])
        ok = True
    except NotMeshCapable:
        ok = False
    if cache is not None:
        cache[sig] = ok
    return ok


def _rows(x: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """Rows ``[lo, lo + n)`` of a lane, zero past its end."""
    part = x[lo:lo + n]
    if part.shape[0] == n:
        return part
    return torch.cat([part, torch.zeros(n - part.shape[0], dtype=x.dtype,
                                        device=x.device)])


def _shard_source(batch: ColumnarBatch, mesh: PM.Mesh) -> Shards:
    """Lay a source batch out over the mesh: shard ``s`` owns rows ``[s *
    shard_cap, (s + 1) * shard_cap)`` of the padded source, on
    ``mesh.devices[s]``, and its live count derives from ``n_rows`` on
    the device (no host sync). A dictionary column keeps its dictionary,
    with its bytes on the shard's device."""
    batch = KR.physical(batch)
    shard_cap = bucket_capacity(max(-(-batch.capacity // mesh.size), 128))
    out = []
    for s, dev in enumerate(mesh.devices):
        lo = s * shard_cap
        count = (batch.n_rows - lo).clamp(0, shard_cap).to(dev)
        live = torch.arange(shard_cap, device=dev) < count
        cols = []
        for c in batch.columns:
            validity = _rows(c.validity, lo, shard_cap).to(dev) & live
            lane = _rows(c.lane, lo, shard_cap).to(dev)
            lane = torch.where(validity, lane, torch.zeros(
                (), dtype=lane.dtype, device=dev))
            if c.is_dict:
                cols.append(dataclasses.replace(
                    c, validity=validity, codes=lane,
                    dict_bytes=tuple(t.to(dev) for t in c.dict_bytes)))
            else:
                cols.append(DeviceColumn(lane, validity, c.dtype))
        out.append(ColumnarBatch(tuple(cols), count, batch.schema))
    return out


def mesh_collect(root: E.TorchExec, ctx: E.ExecContext, mesh: PM.Mesh,
                 growth: float = 1.0) -> Tuple[Optional[HostBatch], bool]:
    """Run a mesh-capable plan over ``mesh`` with buckets grown by
    ``growth``. Returns ``(result, overflowed)``; an overflowed run has
    no result and the caller re-runs with a larger growth. A peeled tail
    finishes on the single-device path over the collected core."""
    tail, core = _split_tail(root)
    host, overflowed = _mesh_core_collect(core, ctx, mesh, growth)
    if overflowed or not tail:
        return host, overflowed
    # from_numpy turns the downloaded nulls of string columns (None) into
    # validity, as an upload needs.
    plan = E.DeviceSourceExec(HostBatch.from_numpy(
        host.columns, host.schema, host.validity).to_device(ctx.device))
    for op in reversed(tail):
        child, plan = plan, copy.copy(op)
        plan.children = [child]
    return E.collect(plan, ctx), False


def _mesh_core_collect(core: E.TorchExec, ctx: E.ExecContext,
                       mesh: PM.Mesh, growth: float
                       ) -> Tuple[Optional[HostBatch], bool]:
    sources: List[E.DeviceSourceExec] = []
    program = _compile(core, sources)
    with ctx.timed("MeshShard"):
        env = {i: _shard_source(s.batch, mesh) for i, s in enumerate(sources)}
    run = _Run(mesh, growth, ctx, [], env)
    outs = [KR.physical(b) for b in program(run)]
    if run.flags:  # every exchange's and join's flag, one host transfer
        flags = torch.stack([f.reshape(()).to(ctx.device)
                             for f in run.flags])
        if bool(flags.any()):
            return None, True
    with ctx.timed("DeviceToHost"):
        hosts = [HostBatch.from_device(b) for b in outs]
    return HostBatch.concat(hosts), False
