"""Window frame kernels — port of ``spark_rapids_tpu/ops/kernels/window.py``:
segment scans, prefix sums, sparse tables and searches, in plain torch.

Every row's frame is computed at once:

* one multi-key sort puts partitions contiguous and ordered (the
  caller's :func:`..rowops.sort_permutation`);
* segment starts and ends come from a cumsum of the run-start flags
  and a table of the runs' first rows;
* ROWS frames are index arithmetic;
* RANGE frames are peer-run bounds, or, for literal offsets, a per-row
  binary search over the sorted order key (one gather a step);
* sum and count over a frame are differences of exclusive prefix sums;
* min and max over a frame read two overlapping power-of-two ranges of
  a sparse table.

Dead rows (index >= ``n_rows``) sort to the end and never reach a live
frame.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ... import types as T
from ...data.column import DeviceColumn
from ..strings_util import char_matrix
from .rowops import orderable_values

INT64_MIN = -0x8000000000000000
INT64_MAX = 0x7FFFFFFFFFFFFFFF


def _shift_down(x: torch.Tensor) -> torch.Tensor:
    """``x`` one row later: row i holds ``x[i - 1]``, row 0 its own."""
    return torch.cat([x[:1], x[:-1]])


def change_flags(sorted_cols: Sequence[DeviceColumn], capacity: int,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """bool[capacity]: row i differs from row i - 1 in any of the given
    (already sorted) key columns; row 0 is always True. With no key
    columns nothing changes (one run over all rows; ``device`` places
    it). Floats compare in their canonical total order (NaN == NaN,
    -0.0 == 0.0); a validity flip is a change and two nulls are equal."""
    diff = None
    for c in sorted_cols:
        if c.is_dict and c.dict_sorted:
            ne = c.codes != _shift_down(c.codes)
        elif c.is_string:
            m = char_matrix(c)
            ne = (m != _shift_down(m)).any(dim=1)
        else:
            data = orderable_values(c.data, c.dtype.is_floating)
            ne = data != _shift_down(data)
        ne = ne | (c.validity != _shift_down(c.validity))
        diff = ne if diff is None else (diff | ne)
    if diff is None:
        diff = torch.zeros(capacity, dtype=torch.bool, device=device)
    first = torch.arange(diff.shape[0], device=diff.device) == 0
    return diff | first


def run_of(new_run: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(run id, run starts)`` of flags that mark run starts in sorted
    order (``new_run[0]`` set): each row's run number, and
    ``starts[r]`` the first row of run ``r``, ``cap`` past the last run.
    A cumsum, a scatter and no host sync."""
    cap = new_run.shape[0]
    iota = torch.arange(cap, device=new_run.device)
    run = torch.cumsum(new_run.to(torch.int64), 0) - 1
    starts = torch.full((cap + 2,), cap, dtype=torch.int64,
                        device=new_run.device)
    starts.scatter_(0, torch.where(new_run, run, cap + 1), iota)
    return run, starts[:cap + 1]


def run_bounds(new_run: torch.Tensor, n_rows: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row ``[start, end)`` of the run each row belongs to, where
    ``new_run`` flags run starts in sorted order. Ends clip to
    ``n_rows``. int64 lanes."""
    run, starts = run_of(new_run)
    start = starts[run]
    end = torch.minimum(starts[run + 1], n_rows.to(torch.int64))
    return start, torch.maximum(end, start)


def exclusive_prefix(vals: torch.Tensor) -> torch.Tensor:
    """``[cap] -> [cap + 1]`` exclusive prefix sums: ``ps[j] =
    sum(vals[:j])``, in ``vals``' dtype."""
    return torch.cat([torch.zeros(1, dtype=vals.dtype, device=vals.device),
                      torch.cumsum(vals, 0, dtype=vals.dtype)])


def range_sum(ps: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
              ) -> torch.Tensor:
    return ps[hi] - ps[lo]


def sparse_table(vals: torch.Tensor, is_min: bool) -> torch.Tensor:
    """``[L, cap]`` table: ``table[k, i]`` = min or max of ``vals[i : i +
    2**k]`` (the last row repeats past the end)."""
    cap = vals.shape[0]
    combine = torch.minimum if is_min else torch.maximum
    levels = [vals]
    shift = 1
    while shift < cap:
        cur = levels[-1]
        shifted = torch.cat([cur[shift:], cur[-1:].expand(shift)])
        levels.append(combine(cur, shifted))
        shift <<= 1
    return torch.stack(levels)


def range_min_max(table: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  is_min: bool) -> torch.Tensor:
    """Query ``[lo, hi)`` ranges against a sparse table; undefined where
    ``hi <= lo``."""
    combine = torch.minimum if is_min else torch.maximum
    span = torch.clamp(hi - lo, min=1).to(torch.int64)
    # floor(log2(span)), corrected to be integer-exact
    k = torch.log2(span.to(torch.float64)).to(torch.int64)
    k = torch.where((torch.ones_like(k) << (k + 1)) <= span, k + 1, k)
    k = torch.where((torch.ones_like(k) << k.clamp(min=0)) > span, k - 1, k)
    k = k.clamp(0, table.shape[0] - 1)
    second = torch.maximum(hi - (torch.ones_like(k) << k), lo)
    return combine(table[k, lo], table[k, second])


def seg_search(bucket: torch.Tensor, key: torch.Tensor,
               t_bucket: torch.Tensor, t_key: torch.Tensor,
               lo0: torch.Tensor, hi0: torch.Tensor, left: bool
               ) -> torch.Tensor:
    """Per-row binary search over the lexicographic ``(bucket, key)``
    arrays, each row inside its ``[lo0, hi0)`` slice. Returns the
    insertion point (bisect_left when ``left``, else bisect_right)."""
    cap = bucket.shape[0]
    iters = max(cap.bit_length(), 1) + 1

    def lt(b1, k1, b2, k2):
        return (b1 < b2) | ((b1 == b2) & (k1 < k2))

    lo, hi = lo0, hi0
    for _ in range(iters):
        mid = (lo + hi) // 2
        midc = mid.clamp(0, cap - 1)
        b, k = bucket[midc], key[midc]
        if left:
            go_right = lt(b, k, t_bucket, t_key)
        else:
            go_right = ~lt(t_bucket, t_key, b, k)
        active = lo < hi
        lo, hi = (torch.where(active & go_right, mid + 1, lo),
                  torch.where(active & ~go_right, mid, hi))
    return lo


def widen_order(col: DeviceColumn) -> Tuple[torch.Tensor, bool]:
    """An order-by column's raw values widened to int64 or float64, so a
    literal frame offset adds without dtype plumbing."""
    if col.dtype.is_floating:
        return col.data.to(torch.float64), True
    return col.data.to(torch.int64), False


def saturating_offset(vals: torch.Tensor, offset: int,
                      floating: bool) -> torch.Tensor:
    """``vals + offset``, saturating at the int64 limits (float addition
    needs no care)."""
    if floating:
        return vals + float(offset)
    s = vals + offset  # wraps
    if offset > 0:
        s = torch.where(s < vals, INT64_MAX, s)
    elif offset < 0:
        s = torch.where(s > vals, INT64_MIN, s)
    return s


def order_key_arrays(col: DeviceColumn, ascending: bool, nulls_first: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                bool]:
    """``(bucket, key, widened raw, floating)`` for RANGE-offset searches:
    the lexicographic ``(bucket, key)`` ascends in sorted-row order."""
    raw, floating = widen_order(col)
    key = orderable_values(raw, floating)
    if not ascending:
        key = ~key
    bucket = torch.where(col.validity, 0, -1 if nulls_first else 1
                         ).to(torch.int8)
    return bucket, key, raw, floating


def transform_target(raw_target: torch.Tensor, floating: bool,
                     ascending: bool) -> torch.Tensor:
    key = orderable_values(raw_target, floating)
    return key if ascending else ~key


def from_total_order(key: torch.Tensor, dtype: T.DataType) -> torch.Tensor:
    """Invert :func:`..rowops.orderable_values`: a total-order int64 key
    back to a raw value of ``dtype`` (NaN and -0.0 come back canonical,
    which Spark treats as equal anyway). It lets min and max run on the
    total order, so NaN ranks greatest."""
    if not dtype.is_floating:
        return key.to(dtype.torch_dtype)
    bits = torch.where(key < 0, ~(key - INT64_MIN), key)
    # orderable_values widens every float to float64 bits
    return bits.view(torch.float64).to(dtype.torch_dtype)
