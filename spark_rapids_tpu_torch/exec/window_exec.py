"""The window operator — port of ``spark_rapids_tpu/exec/window_exec.py``
(``TpuWindowExec``).

Each window expression is evaluated over the whole input as one batch
(:mod:`..ops.kernels.window` holds the formulation): one stable sort by
the partition and order keys, every row's frame as index arithmetic or
a binary search, reductions by prefix sums or sparse tables, and a
scatter of the results back to input row order. The output is the
input's columns followed by one column a window expression.

The evaluation runs under the OOM retry (site
``WindowExec.evaluate``, no split: a piece must hold whole partitions).
When every window expression shares one non-empty partition-by list and
the input passes ``spark.rapids.sql.window.externalThresholdBytes`` (0:
a quarter of the device budget), the bounded-memory route takes over
(:func:`_chunked_pieces`, the reference's): the input external-sorts by
the partition keys through the spill catalog and complete key groups
evaluate one piece at a time (``chunkedWindow``); rows then come out
sorted by the partition keys instead of in input order.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .. import types as T
from ..data.batch import ColumnarBatch
from ..data.column import DeviceColumn, bucket_capacity
from ..ops import aggregates as AGG
from ..ops import windows as W
from ..ops.expression import Expression
from ..ops.kernels import rowops as KR
from ..ops.kernels import window as KW
from ..ops.strings_util import char_matrix
from .execs import TorchExec, _coalesce_device


class WindowExec(TorchExec):
    """Append window columns: ``window_exprs`` is a list of ``(name,
    WindowExpression)`` resolved against the child's schema."""

    def __init__(self, child: TorchExec,
                 window_exprs: List[Tuple[str, W.WindowExpression]],
                 schema: T.Schema):
        self.children = [child]
        self.window_exprs = window_exprs
        self._schema = schema
        self.children_coalesce_goals = ["single"]

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return "Window [" + ", ".join(n for n, _ in self.window_exprs) + "]"

    def bind(self):
        """``[(name, func, partition keys, (order key, ascending,
        nulls_first) list, frame)]`` bound to the child's schema."""
        child_schema = self.children[0].schema
        bound = []
        for name, we in self.window_exprs:
            spec = we.spec
            part = [e.bind(child_schema) for e in spec.partition_by]
            orders = [(o.child.bind(child_schema), o.ascending,
                       o.effective_nulls_first) for o in spec.order_by]
            func = we.func.bind(child_schema) if we.func.children else we.func
            bound.append((name, func, part, orders, spec.effective_frame()))
        return bound

    def _window_all(self, ctx, bound, batches) -> ColumnarBatch:
        with ctx.timed(self.name):
            # Evaluation is positional (run bounds over sorted rows): a
            # lazy batch moves its live rows to the front first.
            batch = KR.physical(_coalesce_device(batches))
            cols = list(batch.columns)
            for _, func, part, orders, frame in bound:
                cols.append(eval_window(batch, func, part, orders, frame))
            return ColumnarBatch(tuple(cols), batch.n_rows, self._schema)

    def execute(self, ctx):
        bound = self.bind()
        batches = [b for part in self.children[0].execute(ctx) for b in part]
        if not batches:
            return [[]]
        catalog = ctx.catalog
        from ..config import WINDOW_EXTERNAL_THRESHOLD
        from ..memory import retry as R
        from ..memory.spill import device_size_bytes
        name = self.name
        parts = {tuple(str(e) for e in pt) for _, _, pt, _, _ in bound}
        common = bound[0][2] if len(parts) == 1 and bound[0][2] else None
        threshold = ctx.conf.get(WINDOW_EXTERNAL_THRESHOLD) or \
            catalog.device_budget // 4
        total = sum(device_size_bytes(b) for b in batches)
        if common is None or total <= threshold:
            ctx.metric(name, "numOutputBatches", 1)
            return [R.with_retry(
                ctx, f"{name}.evaluate", batches,
                lambda bs: self._window_all(ctx, bound, bs), node=name)]

        def chunked():
            for piece in _chunked_pieces(batches, common,
                                         self.children[0].schema, catalog,
                                         ctx, threshold):
                ctx.metric(name, "chunkedWindow", 1)
                ctx.metric(name, "numOutputBatches", 1)
                yield R.with_retry(
                    ctx, f"{name}.evaluate", [piece],
                    lambda bs: self._window_all(ctx, bound, bs),
                    node=name)[0]
        return [chunked()]


def _chunked_pieces(batches, part_exprs, child_schema, catalog, ctx,
                    threshold: int):
    """Complete partition-key groups under a bounded device footprint:
    the input external-sorted by the partition keys (its runs spill
    through the catalog), the sorted chunks walked with the last,
    possibly incomplete, key group carried into the next. Every piece
    but the last holds only complete groups."""
    from ..memory.spill import device_size_bytes
    from ..plan.logical import SortOrder
    from .external_sort import ExternalSorter, slice_rows
    orders = [SortOrder(e) for e in part_exprs]
    sorter = ExternalSorter(orders, child_schema, catalog, ctx,
                            key_exprs=list(part_exprs))
    try:
        for b in batches:
            # an oversized batch is re-sliced, so the runs (and the merged
            # chunks) stay within the threshold
            per_row = max(device_size_bytes(b) // max(b.capacity, 1), 1)
            rows_per = bucket_capacity(max(int(threshold // per_row), 128))
            if b.capacity <= rows_per:
                sorter.add_batch(b)
                continue
            b = KR.physical(b)
            n = int(b.n_rows)
            for off in range(0, n, rows_per):
                sorter.add_batch(slice_rows(b, off, min(rows_per, n - off)))

        carry = None
        chunks = iter(sorter.sorted_chunks())
        chunk = next(chunks, None)
        while chunk is not None:
            piece = _coalesce_device([carry, chunk]) \
                if carry is not None else chunk
            piece = KR.physical(piece)
            nxt = next(chunks, None)
            if nxt is None:
                yield piece
                return
            n = int(piece.n_rows)
            n_c = n - _last_group_rows(piece, part_exprs)
            if n_c > 0:
                yield slice_rows(piece, 0, n_c)
                carry = slice_rows(piece, n_c, n - n_c) if n > n_c \
                    else None
            else:
                carry = piece
            chunk = nxt
        if carry is not None:
            yield carry
    finally:
        sorter.release()


def _last_group_rows(piece: ColumnarBatch, part_exprs) -> int:
    """Rows of a physical, key-sorted piece whose partition keys equal
    its last row's, as :func:`..ops.kernels.window.change_flags` groups
    them (nulls equal nulls, NaN equals NaN, -0.0 equals 0.0)."""
    n = int(piece.n_rows)
    last = max(n - 1, 0)
    same = torch.arange(piece.capacity, device=piece.device) < n
    for e in part_exprs:
        k = e.eval_device(piece)
        vsame = k.validity == k.validity[last]
        if k.is_dict:
            dsame = k.codes == k.codes[last]
        elif k.is_string:
            m = char_matrix(k)
            dsame = (m == m[last]).all(1)
        else:
            data = KR.orderable_values(k.data, k.dtype.is_floating)
            dsame = data == data[last]
        same = same & vsame & (dsame | ~k.validity[last])
    return int(same.sum())


def eval_window(batch: ColumnarBatch, func: Expression,
                part: List[Expression],
                orders: List[Tuple[Expression, bool, bool]],
                frame: W.WindowFrame) -> DeviceColumn:
    """One window column over a physical batch (``_eval_window`` of the
    reference): the ranking functions, and Count, Sum, Average, Min and
    Max over ROWS and RANGE frames."""
    cap = batch.capacity
    n_rows = batch.n_rows
    dev = batch.device
    iota = torch.arange(cap, device=dev)
    live = iota < n_rows

    part_cols = [e.eval_device(batch) for e in part]
    order_cols = [e.eval_device(batch) for e, _, _ in orders]
    keys = part_cols + order_cols
    if keys:
        asc = [True] * len(part_cols) + [a for _, a, _ in orders]
        nf = [True] * len(part_cols) + [n for _, _, n in orders]
        perm = KR.sort_permutation(keys, n_rows, asc, nf)
    else:
        perm = iota

    sorted_parts = [KR.gather_column(c, perm) for c in part_cols]
    sorted_orders = [KR.gather_column(c, perm) for c in order_cols]
    new_seg = KW.change_flags(sorted_parts, cap, dev)
    seg_start, seg_end = KW.run_bounds(new_seg, n_rows)
    new_peer = KW.change_flags(sorted_parts + sorted_orders, cap, dev)
    peer_start, peer_end = KW.run_bounds(new_peer, n_rows)

    # ranking functions (frame-independent)
    if isinstance(func, W.RowNumber):
        return _scatter(iota - seg_start + 1, live, perm, T.INT)
    if isinstance(func, W.Rank):
        return _scatter(peer_start - seg_start + 1, live, perm, T.INT)
    if isinstance(func, W.DenseRank):
        ps = KW.exclusive_prefix((new_peer & live).to(torch.int64))
        return _scatter(ps[iota + 1] - ps[seg_start], live, perm, T.INT)

    lo, hi = frame_bounds(frame, iota, seg_start, seg_end, peer_start,
                          peer_end, sorted_orders, orders)

    if not isinstance(func, W.WINDOW_AGG_TYPES):
        raise NotImplementedError(
            f"{type(func).__name__} over a window is not supported")
    child = func.children[0].eval_device(batch) if func.children else None
    sv = KR.gather_column(child, perm) if child is not None else None

    if sv is not None:
        cnt = KW.range_sum(KW.exclusive_prefix(sv.validity.to(torch.int64)),
                           lo, hi)
    else:
        cnt = hi - lo

    if isinstance(func, AGG.Count):
        return _scatter(cnt, live, perm, T.LONG)
    if isinstance(func, AGG.Sum):
        acc = func.data_type  # LONG or DOUBLE, Spark's sum widening
        vals = torch.where(sv.validity, sv.data.to(acc.torch_dtype),
                           torch.zeros((), dtype=acc.torch_dtype,
                                       device=dev))
        s = KW.range_sum(KW.exclusive_prefix(vals), lo, hi)
        return _scatter(s, live & (cnt > 0), perm, acc)
    if isinstance(func, AGG.Average):
        vals = torch.where(sv.validity, sv.data.to(torch.float64),
                           torch.zeros((), dtype=torch.float64, device=dev))
        s = KW.range_sum(KW.exclusive_prefix(vals), lo, hi)
        avg = s / torch.clamp(cnt, min=1).to(torch.float64)
        return _scatter(avg, live & (cnt > 0), perm, T.DOUBLE)
    # Min and Max run over the canonical total order (int64): NaN ranks
    # greatest and -0.0 == 0.0, as in Spark.
    is_min = isinstance(func, AGG.Min)
    dtype = func.data_type
    neutral = KW.INT64_MAX if is_min else KW.INT64_MIN
    if dtype is T.STRING:
        return _string_min_max(sv, lo, hi, cnt, live, perm, is_min)
    keys = KR.orderable_values(sv.data, dtype.is_floating)
    masked = torch.where(sv.validity, keys, neutral)
    mm_key = KW.range_min_max(KW.sparse_table(masked, is_min), lo, hi,
                              is_min)
    return _scatter(KW.from_total_order(mm_key, dtype), live & (cnt > 0),
                    perm, dtype)


def _string_min_max(sv: DeviceColumn, lo, hi, cnt, live, perm,
                    is_min: bool) -> DeviceColumn:
    """Min or max of a string column over each frame: every row's string
    ranked (a sorted dictionary's codes are its rank; otherwise one sort
    of the string's operands), the packed ``(rank, row)`` key reduced
    over the frame, and the winning row's string gathered, so the
    column keeps its layout."""
    cap = sv.capacity
    iota = torch.arange(cap, device=sv.device)
    if sv.is_dict and sv.dict_sorted:
        rank = sv.codes.to(torch.int64)
    else:
        order = KR.lexsort(KR.string_sort_keys(sv))
        rank = torch.empty_like(order)
        rank[order] = iota
    packed = rank * cap + iota
    neutral = KW.INT64_MAX if is_min else KW.INT64_MIN
    masked = torch.where(sv.validity, packed, neutral)
    mm = KW.range_min_max(KW.sparse_table(masked, is_min), lo, hi, is_min)
    valid_sorted = live & (cnt > 0)
    win_row = torch.where(valid_sorted, mm % cap, 0)
    win_orig = torch.zeros(cap, dtype=torch.int64, device=sv.device)
    win_orig[perm] = win_row
    valid = torch.zeros(cap, dtype=torch.bool, device=sv.device)
    valid[perm] = valid_sorted
    return KR.gather_column(sv, win_orig, valid)


def frame_bounds(frame: W.WindowFrame, iota, seg_start, seg_end,
                 peer_start, peer_end, sorted_orders, orders):
    """Each sorted row's frame ``[lo, hi)`` (``_frame_bounds`` of the
    reference). ROWS: offsets clipped to the partition. RANGE: current
    and unbounded bounds are peer-run and partition bounds; a literal
    offset needs the single order key and a per-row binary search."""
    if frame.frame_type == "rows":
        if frame.lower.kind == "unbounded":
            lo = seg_start
        else:
            off = frame.lower.offset if frame.lower.kind == "offset" else 0
            lo = torch.minimum(torch.maximum(iota + off, seg_start), seg_end)
        if frame.upper.kind == "unbounded":
            hi = seg_end
        else:
            off = frame.upper.offset if frame.upper.kind == "offset" else 0
            hi = torch.minimum(torch.maximum(iota + off + 1, seg_start),
                               seg_end)
        return lo, torch.maximum(hi, lo)

    need_search = frame.lower.kind == "offset" \
        or frame.upper.kind == "offset"
    if need_search:
        if len(sorted_orders) != 1:
            raise ValueError("a range frame with offsets needs exactly one "
                             "order-by key")
        oc = sorted_orders[0]
        _, asc, nf = orders[0]
        bucket, key, raw, floating = KW.order_key_arrays(oc, asc, nf)

    def one(bound: W.Bound, is_lower: bool):
        if bound.kind == "unbounded":
            return seg_start if is_lower else seg_end
        if bound.kind == "current":
            return peer_start if is_lower else peer_end
        delta = bound.offset if asc else -bound.offset
        t_raw = KW.saturating_offset(raw, delta, floating)
        t_key = KW.transform_target(t_raw, floating, asc)
        # A null order value keeps its own (bucket, key): its frame is
        # the null peer run, as in Spark.
        t_key = torch.where(oc.validity, t_key, key)
        return KW.seg_search(bucket, key, bucket, t_key, seg_start, seg_end,
                             left=is_lower)

    lo = one(frame.lower, True)
    hi = one(frame.upper, False)
    return lo, torch.maximum(hi, lo)


def _scatter(data_sorted: torch.Tensor, valid_sorted: torch.Tensor,
             perm: torch.Tensor, dtype: T.DataType) -> DeviceColumn:
    """Sorted-order results back to input row order (null data zero)."""
    cap = perm.shape[0]
    data = torch.zeros(cap, dtype=data_sorted.dtype, device=perm.device)
    data[perm] = data_sorted
    valid = torch.zeros(cap, dtype=torch.bool, device=perm.device)
    valid[perm] = valid_sorted
    data = torch.where(valid, data, torch.zeros((), dtype=data.dtype,
                                                device=data.device))
    return DeviceColumn(data.to(dtype.torch_dtype), valid, dtype)
