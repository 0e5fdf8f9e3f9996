"""Grouped aggregation — port of ``spark_rapids_tpu/ops/kernels/groupby.py``.

Four strategies, as in the reference:

* **Dictionary** (:func:`_dict_grouped_aggregate`): every key a sorted
  dictionary string whose code space (the product of ``dict_size + 1``)
  is at most ``_DICT_GROUP_LIMIT`` slots. The group id is the mixed-radix
  packed code; every reduction is one scatter into the slot table, and
  the occupied slots compact to the front in packed (= sorted key) order.
  Always exact.
* **Dense int** (:func:`_dense_int_aggregate`): int-like keys pack
  mixed-radix into one slot id of a ``2**21``-slot table; every reduction
  is one scatter. Optimistic: a ``fail`` flag (a device bool) trips when
  the observed key spans do not fit the table, and the session re-runs
  the site on the sort path.
* **Sort** (:func:`_sort_grouped_aggregate`): one stable lexicographic
  sort of the keys, segment boundaries where adjacent keys differ, and a
  segmented reduction per lane over the sorted, prefix-dense group ids.
  Eligible lanes (integer sums, min and max) run through the
  ``segmented`` CUDA kernel (:mod:`.cuda.segmented`); float sums and bool
  lanes take the plain segment sum, as the reference leaves them to XLA.
  A flat string key sorts on one operand per char-matrix column.
* **Global** (:func:`global_aggregate`): no keys; masked whole-lane
  reductions (sum, count, min, max, first, last) into one group.

Float sums in the scatters add in atomic order on the card, so their
last bits may vary from run to run.

Beside the strategies, the reference's row-space group-by primitives,
which the distributed group-by step (:mod:`...parallel.distributed`)
composes: :func:`group_ids` (dense segment ids from one stable sort of
the keys; a string key's adjacent rows compare through the ``strings``
rowwise-compare kernel, :mod:`.cuda.strings`), :func:`segment_reduce`
and :func:`gather_group_keys`.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ...data.column import DeviceColumn, bucket_capacity
from ..strings_util import char_matrix
from .cuda import segmented as SEG
from .cuda import strings as SG
from .rowops import (gather_column, lexsort, orderable_key, orderable_values,
                     sort_permutation, string_sort_keys)

#: Slot-table width of the dense path (the reference's ``_DENSE_AGG_SLOTS``).
_DENSE_AGG_SLOTS = 1 << 21

#: Largest packed code space the dictionary path takes (the reference's).
_DICT_GROUP_LIMIT = 4096

_REDUCE = {"min": "amin", "max": "amax"}


def _segment_scatter(x: torch.Tensor, ids: torch.Tensor,
                     num_segments: int, op: str) -> torch.Tensor:
    """``jax.ops.segment_{sum,min,max}(x, ids, num_segments)``: rows with
    an id outside ``[0, num_segments)`` are dropped and empty segments
    hold the identity. Plain PyTorch (``index_add_`` / ``scatter_reduce_``);
    a float sum on CUDA adds in atomic order, so its last bits vary run
    to run."""
    n = x.shape[0]
    ids = ids.long()
    idx = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    shape = (num_segments + 1,) + tuple(x.shape[1:])
    if op == "sum":
        out = torch.zeros(shape, dtype=x.dtype, device=x.device)
        out.index_add_(0, idx, x)
        return out[:num_segments]
    out = torch.full(shape, _identity(x.dtype, op), dtype=x.dtype,
                     device=x.device)
    idx2 = idx.view((n,) + (1,) * (x.dim() - 1)).expand(x.shape)
    out.scatter_reduce_(0, idx2, x, _REDUCE[op])
    return out[:num_segments]


def _identity(dtype: torch.dtype, op: str):
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    if dtype == torch.bool:
        return op == "min"
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _max_value(dtype: torch.dtype):
    """The largest value of ``dtype`` (inf for floats): min's identity."""
    return _identity(dtype, "min")


def _min_value(dtype: torch.dtype):
    """The smallest value of ``dtype`` (-inf for floats): max's identity."""
    return _identity(dtype, "max")


def _equal_adjacent(col: DeviceColumn, perm: torch.Tensor) -> torch.Tensor:
    """bool[capacity]: row i of the sorted order has the same key as row
    i - 1 (row 0 compares with itself). A string key compares its sorted
    char matrix with the same matrix one row back, as two row views of
    one buffer, through the ``strings`` rowwise compare."""
    sv = col.validity[perm]
    vprev = torch.cat([sv[:1], sv[:-1]])
    if col.is_string:
        m = char_matrix(col)[perm]
        data_eq = torch.ones(col.capacity, dtype=torch.bool, device=sv.device)
        data_eq[1:] = SG.ragged_row_equal(m[1:], m[:-1])
    else:
        # (bucket, key) pair equality: NaN rides the bucket with a zeroed
        # key and -0.0 canonicalizes, so this is Spark grouping equality.
        key, nb = orderable_key(col)
        k, b = key[perm], nb[perm]
        data_eq = (k == torch.cat([k[:1], k[:-1]])) \
            & (b == torch.cat([b[:1], b[:-1]]))
    both_null = ~sv & ~vprev
    return (data_eq & sv & vprev) | both_null


def group_ids(keys: Sequence[DeviceColumn], n_rows: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(seg, n_groups, firsts)``: int32 dense segment id per original
    row, the group count, and each group's first original row (int32
    ``[capacity]``). Groups number in key order (nulls first); rows past
    ``n_rows`` take the last live group's id and callers mask them."""
    capacity = keys[0].capacity
    dev = keys[0].device
    perm = sort_permutation(keys, n_rows)
    eq = torch.ones(capacity, dtype=torch.bool, device=dev)
    for k in keys:
        eq = eq & _equal_adjacent(k, perm)
    iota = torch.arange(capacity, device=dev)
    is_boundary = (~eq | (iota == 0)) & (iota < n_rows)
    seg_sorted = (torch.cumsum(is_boundary.to(torch.int32), 0,
                               dtype=torch.int32) - 1).clamp(min=0)
    n_groups = is_boundary.sum(dtype=torch.int32)
    seg = torch.zeros(capacity, dtype=torch.int32, device=dev)
    seg.scatter_(0, perm, seg_sorted)
    firsts = torch.zeros(capacity, dtype=torch.int32, device=dev)
    firsts.scatter_reduce_(0, seg_sorted.long(),
                           torch.where(is_boundary, perm, 0).to(torch.int32),
                           "amax")
    return seg, n_groups, firsts


def segment_reduce(values: torch.Tensor, validity: torch.Tensor,
                   seg: torch.Tensor, capacity: int, op: str,
                   live: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduce ``values`` per segment id ``seg`` (ids at or past
    ``capacity`` drop): ``(result[capacity], count[capacity])`` of the
    valid live contributions. ``op``: sum, min, max, count, first or
    last; an empty segment holds the identity (first and last: the row
    at the clamped position)."""
    contrib = validity & live
    counts = _segment_scatter(contrib.to(torch.int64), seg, capacity, "sum")
    n = values.shape[0]
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    if op == "sum":
        out = _segment_scatter(torch.where(contrib, values, zero), seg,
                               capacity, "sum")
    elif op in ("min", "max"):
        neutral = _max_value(values.dtype) if op == "min" \
            else _min_value(values.dtype)
        out = _segment_scatter(torch.where(contrib, values, neutral), seg,
                               capacity, op)
    elif op == "count":
        out = counts
    elif op in ("first", "last"):
        idx = torch.arange(n, dtype=torch.int32, device=values.device)
        pick = _segment_scatter(
            torch.where(contrib, idx, n if op == "first" else -1), seg,
            capacity, "min" if op == "first" else "max")
        out = values[pick.long().clamp(0, n - 1)]
    else:
        raise ValueError(op)
    return out, counts


def gather_group_keys(keys: Sequence[DeviceColumn], firsts: torch.Tensor,
                      n_groups: torch.Tensor) -> List[DeviceColumn]:
    """The group-key columns: each group's key from its first row."""
    live = torch.arange(keys[0].capacity, device=firsts.device) < n_groups
    return [gather_column(k, firsts, live) for k in keys]


def _minmax_strip_nan(values: torch.Tensor, op: str) -> torch.Tensor:
    """Spark float semantics for min/max: NaN orders greatest and
    -0.0 == 0.0. NaN becomes the op's identity so a plain reduction sees
    through it; :func:`_minmax_reinstate_nan` puts it back."""
    repl = float("-inf") if op == "max" else float("inf")
    v = torch.where(torch.isnan(values), repl, values)
    return torch.where(v == 0, torch.zeros((), dtype=v.dtype,
                                           device=v.device), v)


def _minmax_reinstate_nan(res, nan_cnt, cnt, op: str):
    """max is NaN when any contribution was NaN; min only when all were."""
    has_nan = (nan_cnt > 0) if op == "max" else (nan_cnt == cnt)
    return torch.where(has_nan & (cnt > 0), float("nan"), res)


def _dense_eligible(keys, inputs) -> bool:
    """The dense path applies to int-like keys (ints, dates, bools,
    dictionary codes) and 1-D numeric lanes."""
    if not keys or len(keys) > 6:
        return False
    for k in keys:
        if k.dtype.is_floating and not k.is_dict:
            return False
        if k.is_string and not (k.is_dict and k.dict_sorted):
            return False
    return all(v.dim() == 1 for v, _, _ in inputs)


def _key_lane(k: DeviceColumn) -> torch.Tensor:
    v64 = k.codes.long() if k.is_dict else \
        orderable_values(k.data, k.dtype.is_floating)
    return torch.where(k.validity, v64, 0)


def _compact_slots(occupied: torch.Tensor, capacity: int):
    """(n_groups, slot_of_group[capacity], group_live): occupied slots
    moved to the front in slot order (cumsum + scatter)."""
    dev = occupied.device
    n_groups = occupied.sum()
    pos = torch.cumsum(occupied.to(torch.int64), 0) - 1
    idx = torch.where(occupied, pos, capacity)
    slot_of_group = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    slot_of_group.scatter_(0, idx, torch.arange(occupied.shape[0],
                                                device=dev))
    group_live = torch.arange(capacity, device=dev) < n_groups
    return n_groups, slot_of_group[:capacity], group_live


def _apply_many(pre_many, lanes):
    """Apply a row-space map to many lanes, one 2-D pass per dtype."""
    out = [None] * len(lanes)
    groups = {}
    for i, lane in enumerate(lanes):
        groups.setdefault(lane.dtype, []).append(i)
    for idxs in groups.values():
        mapped = pre_many(torch.stack([lanes[i] for i in idxs], dim=1))
        for j, i in enumerate(idxs):
            out[i] = mapped[:, j]
    return out


def _segment_reduce_inputs(inputs, seg, iota, capacity, live, pre=None,
                           post=None, pre_many=None):
    """The per-op aggregate dispatch shared by both strategies (Spark NaN
    handling included): ``pre`` maps row-space lanes (the sort path's
    permutation gather), ``seg(x, op)`` reduces a row lane — [n] or a
    stack [n, L] of lanes with one op and dtype — into dense group rows,
    ``iota`` positions first/last in pre-space, ``post`` masks dead group
    rows. Returns ``[(result, count)]`` per input."""
    pre = pre or (lambda x: x)
    post = post or (lambda x: x)
    if pre_many is not None and inputs:
        pvals = _apply_many(pre_many, [v for v, _, _ in inputs])
        pvalid = _apply_many(pre_many, [val for _, val, _ in inputs])
    else:
        pvals = [pre(v) for v, _, _ in inputs]
        pvalid = [pre(val) for _, val, _ in inputs]

    reqs: list = []

    def want(lane, kind):
        reqs.append((lane, kind))
        return len(reqs) - 1

    plan = []
    for (v, val, op), v_p, val_p in zip(inputs, pvals, pvalid):
        contrib = val_p & live
        item = {"op": op, "v_p": v_p}
        item["cnt"] = want(contrib.to(torch.int64), "sum")
        if op == "sum":
            item["res"] = want(torch.where(
                contrib, v_p, torch.zeros((), dtype=v_p.dtype,
                                          device=v_p.device)), "sum")
        elif op in ("min", "max"):
            floating = v_p.is_floating_point()
            vv = _minmax_strip_nan(v_p, op) if floating else v_p
            neutral = _identity(vv.dtype, op)
            item["res"] = want(torch.where(contrib, vv, neutral), op)
            if floating:
                item["nan"] = want((torch.isnan(v_p) & contrib)
                                   .to(torch.int64), "sum")
        elif op == "first":
            item["pos"] = want(torch.where(contrib, iota, capacity), "min")
        elif op == "last":
            item["pos"] = want(torch.where(contrib, iota, -1), "max")
        elif op != "count":
            raise ValueError(op)
        plan.append(item)

    # One segmented reduction per (kind, dtype): lanes stack into [n, L].
    out: list = [None] * len(reqs)
    groups = {}
    for i, (lane, kind) in enumerate(reqs):
        groups.setdefault((kind, lane.dtype), []).append(i)
    for (kind, _), idxs in groups.items():
        if len(idxs) == 1:
            out[idxs[0]] = seg(reqs[idxs[0]][0], kind)
            continue
        red = seg(torch.stack([reqs[i][0] for i in idxs], dim=1), kind)
        for j, i in enumerate(idxs):
            out[i] = red[:, j]

    results = []
    for item in plan:
        op = item["op"]
        cnt = out[item["cnt"]]
        if op == "count":
            res = cnt
        elif op == "sum":
            res = out[item["res"]]
        elif op in ("min", "max"):
            res = out[item["res"]]
            if "nan" in item:
                res = _minmax_reinstate_nan(res, out[item["nan"]], cnt, op)
        else:
            pos = out[item["pos"]]
            res = item["v_p"][pos.long().clamp(0, capacity - 1)]
        results.append((post(res), post(cnt)))
    return results


def _dense_int_aggregate(keys, live, inputs):
    """Direct-offset grouping for int-like keys packed mixed-radix into
    one slot id (per key: value - min + 1, 0 = null). Packed order is the
    sort path's nulls-first ascending group order. ``fail`` trips when
    the observed span product exceeds the slot table."""
    S = _DENSE_AGG_SLOTS
    capacity = keys[0].capacity
    dev = live.device
    big = 2 ** 62
    packed = torch.zeros(capacity, dtype=torch.int64, device=dev)
    prod = torch.ones((), dtype=torch.int64, device=dev)
    fail = torch.zeros((), dtype=torch.bool, device=dev)
    for key in keys:
        v64 = _key_lane(key)
        lv = live & key.validity
        any_valid = lv.any()
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        vmin = torch.where(any_valid, torch.where(lv, v64, big).min(), zero)
        vmax = torch.where(any_valid, torch.where(lv, v64, -big).max(), zero)
        diff = vmax - vmin  # wraps negative when the span overflows int64
        fail = fail | (diff < 0) | (diff >= S - 1)
        span = diff.clamp(0, S - 1) + 2  # +1 bias, +1 null lane
        lane = torch.where(key.validity, (v64 - vmin + 1).clamp(0, S - 1), 0)
        packed = packed * span + lane
        prod = torch.clamp(prod * span, max=S + 1)
    fail = fail | (prod > S)
    slot = torch.where(live, packed.clamp(0, S - 1), S)
    rows_per_slot = _segment_scatter(live.to(torch.int32), slot, S + 1,
                                     "sum")[:S]
    n_groups, slot_of_group, group_live = _compact_slots(rows_per_slot > 0,
                                                         capacity)
    iota = torch.arange(capacity, dtype=torch.int32, device=dev)
    rep = _segment_scatter(torch.where(live, iota, capacity), slot, S + 1,
                           "min")[:S]
    rep_g = rep[slot_of_group].long().clamp(0, capacity - 1)
    key_cols = [gather_column(key, rep_g, group_live) for key in keys]

    def seg(x, op="sum"):
        full = _segment_scatter(x, slot, S + 1, op)[:S][slot_of_group]
        mask = group_live.view((-1,) + (1,) * (x.dim() - 1))
        return torch.where(mask, full, torch.zeros((), dtype=full.dtype,
                                                   device=dev))

    results = _segment_reduce_inputs(inputs, seg, iota, capacity, live)
    return key_cols, results, n_groups, group_live, fail


def grouped_aggregate(keys: Sequence[DeviceColumn], live: torch.Tensor,
                      inputs: Sequence[Tuple[torch.Tensor, torch.Tensor, str]],
                      dense_mode: int = 0):
    """Whole grouped aggregation of ``inputs`` (``(values[cap],
    validity[cap], op)``) by ``keys``. Returns ``(key_cols, [(result,
    count)], n_groups, group_live, fail)`` as dense group rows (row g =
    group g); ``fail`` is ``False`` on the always-exact sort path, else a
    device bool for the session's dense-mode escalation."""
    if all(k.is_dict and k.dict_sorted for k in keys):
        n_slots = 1
        for k in keys:
            n_slots *= k.dict_size + 1  # slot 0 = null
        if n_slots <= _DICT_GROUP_LIMIT:
            return _dict_grouped_aggregate(keys, live, inputs, n_slots) \
                + (False,)
    if dense_mode == 0 and _dense_eligible(keys, inputs):
        return _dense_int_aggregate(keys, live, inputs)
    return _sort_grouped_aggregate(keys, live, inputs) + (False,)


def _dict_grouped_aggregate(keys: Sequence[DeviceColumn], live: torch.Tensor,
                            inputs, n_slots: int):
    """Direct-indexed grouping for sorted-dictionary keys. Group id =
    mixed-radix packed (code + 1, or 0 for null) per key; packed ascending
    order is the sort path's nulls-first order, so groups come out in the
    same order. Output rows sit at ``bucket_capacity(n_slots)``."""
    capacity = keys[0].capacity
    dev = live.device
    gid = torch.zeros(capacity, dtype=torch.int64, device=dev)
    for k in keys:
        slot = torch.where(k.validity, k.codes.long() + 1, 0)
        gid = gid * (k.dict_size + 1) + slot
    gid = torch.where(live, gid, n_slots)  # dead rows: the spare slot
    rows_per_slot = _segment_scatter(live.to(torch.int32), gid, n_slots,
                                     "sum")
    out_cap = bucket_capacity(n_slots)
    occupied = torch.zeros(out_cap, dtype=torch.bool, device=dev)
    occupied[:n_slots] = rows_per_slot > 0
    n_groups, slot_of_group, group_live = _compact_slots(occupied, out_cap)

    key_cols: List[DeviceColumn] = []
    stride = 1
    for k in reversed(keys):
        slot = (slot_of_group // stride) % (k.dict_size + 1)
        validity = (slot > 0) & group_live
        codes = torch.where(validity, slot - 1, 0).to(torch.int32)
        key_cols.append(k.replace_rows(validity, codes))
        stride *= k.dict_size + 1
    key_cols.reverse()

    def seg(x, op="sum"):
        full = _segment_scatter(x, gid, n_slots, op)
        pad = torch.zeros((out_cap - n_slots,) + tuple(full.shape[1:]),
                          dtype=full.dtype, device=dev)
        return torch.cat([full, pad])[slot_of_group]

    def post(x):
        return torch.where(group_live.view((-1,) + (1,) * (x.dim() - 1)), x,
                           torch.zeros((), dtype=x.dtype, device=dev))

    iota = torch.arange(capacity, dtype=torch.int32, device=dev)
    results = _segment_reduce_inputs(inputs, seg, iota, capacity, live,
                                     post=post)
    return key_cols, results, n_groups, group_live


def global_aggregate(capacity: int, live: torch.Tensor, inputs):
    """Aggregation without keys: masked whole-lane reductions of the
    ``sum``, ``count``, ``min``, ``max``, ``first`` and ``last`` buffers.
    Always one group (count 0 and null values over an empty input), so
    no caller needs a host read to handle emptiness. Output rows sit at
    the smallest capacity, 128, instead of the input's. Float min and max
    follow Spark (NaN greatest, -0.0 equal to 0.0); first and last take
    the first and last contributing row."""
    dev = live.device
    out_cap = bucket_capacity(1)
    first = torch.arange(out_cap, device=dev) == 0
    results = []
    for v, val, op in inputs:
        contrib = val & live
        cnt = contrib.sum(dtype=torch.int64)
        if op == "count":
            res = cnt
        elif op == "sum":
            res = torch.where(contrib, v, torch.zeros(
                (), dtype=v.dtype, device=dev)).sum(dtype=v.dtype)
        elif op in ("min", "max"):
            floating = v.is_floating_point()
            vv = _minmax_strip_nan(v, op) if floating else v
            masked = torch.where(contrib, vv, _identity(vv.dtype, op))
            res = masked.amin() if op == "min" else masked.amax()
            if floating:
                nan_cnt = (torch.isnan(v) & contrib).sum(dtype=torch.int64)
                res = _minmax_reinstate_nan(res, nan_cnt, cnt, op)
        elif op in ("first", "last"):
            # the reference's argmax picks: row 0 (first) or the last row
            # (last) when nothing contributes, under a null either way
            hit = contrib.to(torch.uint8)
            idx = hit.argmax() if op == "first" \
                else capacity - 1 - hit.flip(0).argmax()
            res = v.index_select(0, idx.view(1))[0]  # no host read
        else:
            raise ValueError(op)
        zero = torch.zeros((), dtype=res.dtype, device=dev)
        results.append((torch.where(first, res, zero),
                        torch.where(first, cnt, 0)))
    return [], results, torch.ones((), dtype=torch.int64, device=dev), first


def _segment_lane(x: torch.Tensor, gid: torch.Tensor, capacity: int,
                  op: str) -> torch.Tensor:
    """The sort path's reduction of one lane (or lane stack): the
    ``segmented`` kernel where it is eligible, else the plain segment
    reduction (float sums, bool lanes)."""
    if SEG.eligible(x, op):
        return SEG.segment_reduce_sorted(x.contiguous(), gid, capacity, op)
    return _segment_scatter(x, gid, capacity, op)


def _sort_grouped_aggregate(keys: Sequence[DeviceColumn], live: torch.Tensor,
                            inputs):
    """The always-exact sort path (see :func:`grouped_aggregate`)."""
    capacity = keys[0].capacity
    dev = live.device
    iota = torch.arange(capacity, dtype=torch.int32, device=dev)
    # Every per-key null bucket folds into one leading bucket operand
    # (base 7, so it encodes the whole null pattern); the dead-row marker
    # 7**n_keys dominates any live bucket sum and sinks dead rows last.
    packed = len(keys) <= 20
    dead_marker = 7 ** len(keys) if packed else 1
    bucket = torch.where(live, 0, dead_marker).to(torch.int64)
    key_operands: List[torch.Tensor] = []
    for i, k in enumerate(keys):
        if k.is_string:
            null_bucket, *per_key = string_sort_keys(k)
        else:
            key, null_bucket = orderable_key(k)
            per_key = [key]
        if packed:
            bucket = bucket + (null_bucket.to(torch.int64) + 3) * (7 ** i)
        else:
            key_operands.append(null_bucket)
        key_operands.extend(per_key)
    operands = [bucket] + key_operands
    perm = lexsort(operands)

    eq = torch.ones(capacity, dtype=torch.bool, device=dev)
    for o in operands:
        s = o[perm]
        eq = eq & (s == torch.cat([s[:1], s[:-1]]))
    live_sorted = live[perm]
    boundary = (~eq | (iota == 0)) & live_sorted
    n_groups = boundary.sum()
    group_live = iota < n_groups
    gid = (torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32) - 1
           ).clamp(min=0)
    # Dead rows (a suffix after the sort) go to the spare id ``capacity``,
    # which every reduction drops, as the dense paths send them to their
    # spare slot. They contribute only identities, so the results are the
    # reference's; it keeps the group walk of the last live group short.
    gid = torch.where(live_sorted, gid, capacity).to(torch.int32)
    starts = _segment_scatter(torch.where(boundary, iota, capacity), gid,
                              capacity, "min")
    starts = torch.where(group_live, starts.clamp(max=capacity - 1), 0)

    orig_starts = perm[starts.long()]
    key_cols = [gather_column(k, orig_starts, group_live) for k in keys]

    def seg(x, op="sum"):
        return _segment_lane(x, gid, capacity, op)

    def post(x):
        return torch.where(group_live, x, torch.zeros((), dtype=x.dtype,
                                                      device=dev))

    results = _segment_reduce_inputs(
        inputs, seg, iota, capacity, live_sorted,
        pre=lambda x: x[perm], post=post, pre_many=lambda m: m[perm])
    return key_cols, results, n_groups, group_live

