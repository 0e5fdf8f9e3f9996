"""Device batch concatenation — port of
``spark_rapids_tpu/ops/kernels/concat.py`` (the ``Table.concatenate``
replacement behind coalescing and join/sort input assembly).

Each input's live rows scatter into the output at the running sum of
the earlier inputs' row counts, which stays on the device: no host sync.
Dead rows scatter to a spare slot past the end, which is dropped.
Dictionary strings append their dictionaries WITHOUT dedupe (codes shift
by the earlier dictionaries' sizes), so the result is not
``dict_sorted``; flat strings concatenate through the char matrix.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ...data.batch import ColumnarBatch
from ...data.column import DeviceColumn, dictionary_column
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


def concat_columns(cols: List[DeviceColumn], n_rows_list, out_capacity: int,
                   total_rows) -> DeviceColumn:
    """One column of the concatenation of physical batches."""
    dev = cols[0].device
    live_out = torch.arange(out_capacity, device=dev) < total_rows
    targets = _targets(cols, n_rows_list, out_capacity)
    out_valid = _scatter_validity(cols, targets, out_capacity, live_out)
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
