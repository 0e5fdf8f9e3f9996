"""Device batch concatenation — port of
``spark_rapids_tpu/ops/kernels/concat.py`` (the ``Table.concatenate``
replacement behind coalescing and join/sort input assembly).

Each input's live rows scatter into the output at the running sum of
the earlier inputs' row counts, which stays on the device: no host sync.
Dead rows scatter to a spare slot past the end, which is dropped.
Dictionary strings append their dictionaries WITHOUT dedupe (codes shift
by the earlier dictionaries' sizes), so the result is not
``dict_sorted``, unless every input holds the very same dictionary,
whose codes and order then carry over; flat strings concatenate through
the char matrix. An array column re-pads to the widest input's
``max_len``; a struct concatenates field by field.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ...data.batch import ColumnarBatch
from ...data.column import DeviceColumn, array_column, dictionary_column
from ..strings_util import PAD, char_matrix
from .rowops import physical, strings_from_matrix


def _targets(cols: Sequence[DeviceColumn], n_rows_list, out_capacity: int):
    """Per input column: (output slot of each row, the row is live), live
    rows at the running offset and the rest at the spare slot."""
    offset = torch.zeros((), dtype=torch.int64, device=cols[0].device)
    out = []
    for c, n in zip(cols, n_rows_list):
        idx = torch.arange(c.capacity, device=c.device)
        live = idx < n
        out.append((torch.where(live, idx + offset, out_capacity), live))
        offset = offset + n
    return out


def _scatter(lanes, targets, out_capacity: int, fill, dtype) -> torch.Tensor:
    out = torch.full((out_capacity + 1,), fill, dtype=dtype,
                     device=targets[0][0].device)
    for lane, (target, _) in zip(lanes, targets):
        out.scatter_(0, target, lane)
    return out[:out_capacity]


def _scatter_validity(cols, targets, out_capacity: int,
                      live_out: torch.Tensor) -> torch.Tensor:
    lanes = [c.validity & live for c, (_, live) in zip(cols, targets)]
    return _scatter(lanes, targets, out_capacity, False,
                    torch.bool) & live_out


def _concat_dict_columns(cols, targets, out_capacity: int,
                         out_valid: torch.Tensor) -> DeviceColumn:
    if all(c.dictionary is cols[0].dictionary for c in cols):
        # one dictionary (a table's column cut into batches, or Expand's
        # projections): the codes carry over, and so does its order
        lanes = [torch.where(live & c.validity, c.codes, 0)
                 for c, (_, live) in zip(cols, targets)]
        codes = _scatter(lanes, targets, out_capacity, 0, torch.int32)
        return cols[0].replace_rows(out_valid,
                                    torch.where(out_valid, codes, 0))
    lanes, base = [], 0
    for c, (_, live) in zip(cols, targets):
        lanes.append(torch.where(live & c.validity, c.codes + base, 0)
                     .to(torch.int32))
        base += c.dict_size
    codes = _scatter(lanes, targets, out_capacity, 0, torch.int32)
    codes = torch.where(out_valid, codes, 0)
    dictionary = np.concatenate([np.asarray(c.dictionary, dtype=object)
                                 for c in cols])
    return dictionary_column(codes, out_valid, dictionary, dict_sorted=False)


def _concat_array_columns(cols, targets, out_capacity: int,
                          out_valid: torch.Tensor) -> DeviceColumn:
    """Array columns re-padded to the widest ``max_len`` and scattered
    row-wise, as the reference's concatenation does."""
    w = max(c.max_len for c in cols)
    dev = cols[0].device
    data = torch.zeros((out_capacity + 1, w), dtype=cols[0].data.dtype,
                       device=dev)
    ev = torch.zeros((out_capacity + 1, w), dtype=torch.bool, device=dev)
    lengths = torch.zeros(out_capacity + 1, dtype=torch.int32, device=dev)
    for c, (target, live) in zip(cols, targets):
        pad = w - c.max_len
        data.index_copy_(0, target, F.pad(c.data, (0, pad)))
        ev.index_copy_(0, target, F.pad(c.elem_validity, (0, pad))
                       & live[:, None])
        lengths.index_copy_(0, target, torch.where(live & c.validity,
                                                   c.lengths, 0))
    return array_column(data[:out_capacity], ev[:out_capacity],
                        lengths[:out_capacity], out_valid, cols[0].dtype)


def concat_columns(cols: List[DeviceColumn], n_rows_list, out_capacity: int,
                   total_rows) -> DeviceColumn:
    """One column of the concatenation of physical batches."""
    dev = cols[0].device
    live_out = torch.arange(out_capacity, device=dev) < total_rows
    targets = _targets(cols, n_rows_list, out_capacity)
    out_valid = _scatter_validity(cols, targets, out_capacity, live_out)
    if cols[0].is_struct:
        return DeviceColumn(None, out_valid, cols[0].dtype, children=tuple(
            concat_columns([c.children[k] for c in cols], n_rows_list,
                           out_capacity, total_rows)
            for k in range(len(cols[0].children))))
    if cols[0].is_array:
        return _concat_array_columns(cols, targets, out_capacity, out_valid)
    if cols[0].is_string and all(c.is_dict for c in cols):
        return _concat_dict_columns(cols, targets, out_capacity, out_valid)
    if cols[0].is_string:
        w = max(max(c.max_bytes for c in cols), 1)
        out_m = torch.full((out_capacity + 1, w), PAD, dtype=torch.int16,
                           device=dev)
        for c, (target, live) in zip(cols, targets):
            m = torch.where(live[:, None], char_matrix(c, w), PAD)
            out_m.index_copy_(0, target, m)
        out_m = torch.where(out_valid[:, None], out_m[:out_capacity], PAD)
        return strings_from_matrix(out_m, out_valid, w)
    dtype = cols[0].data.dtype
    lanes = [torch.where(live & c.validity, c.data,
                         torch.zeros((), dtype=dtype, device=dev))
             for c, (_, live) in zip(cols, targets)]
    data = _scatter(lanes, targets, out_capacity, 0, dtype)
    data = torch.where(out_valid, data, torch.zeros((), dtype=dtype,
                                                    device=dev))
    return DeviceColumn(data, out_valid, cols[0].dtype)


def concat_batches(batches: List[ColumnarBatch],
                   out_capacity: int) -> ColumnarBatch:
    """Concatenate device batches of one schema into one of
    ``out_capacity``, which the caller sizes at or above the live rows
    (the sum of the capacities needs no sync)."""
    assert batches
    batches = [physical(b) for b in batches]
    if len(batches) == 1 and batches[0].capacity == out_capacity:
        return batches[0]
    n_list = [b.n_rows for b in batches]
    total = sum(n_list[1:], n_list[0])
    cols = [concat_columns([b.columns[ci] for b in batches], n_list,
                           out_capacity, total)
            for ci in range(len(batches[0].columns))]
    return ColumnarBatch(tuple(cols), total, batches[0].schema)
