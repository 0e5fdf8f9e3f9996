"""Row rearrangement: gather, compact (filter), multi-key sort, top-k.

Port of ``spark_rapids_tpu/ops/kernels/rowops.py``. Float keys map to
order-preserving operands so NaN ordering (greatest) and -0.0 == 0.0
match Spark; nulls order through an explicit bucket operand.

Two hand-written kernels run here: a flat string column moves with the
``strings`` family's ragged gather over its own offsets and payload
(:func:`.cuda.strings.gather_strings`), and a single packable sort key
sorts as one int64 lane with the ``sortStep`` radix sort
(:mod:`.cuda.sort_steps`).

The reference sorts several operands at once with ``lax.sort(...,
num_keys=k)``. torch has no multi-operand sort, so :func:`lexsort` runs
one STABLE ``torch.sort`` per operand from the least significant up;
stability makes the passes compose into the same lexicographic order,
ties included, so group order and first/last positions match the
reference.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import types as T
from ...data.batch import ColumnarBatch
from ...data.column import (DeviceColumn, bucket_byte_capacity,
                            bucket_capacity, dictionary_column)
from ..strings_util import char_matrix
from .cuda import sort_steps as SS
from .cuda import strings as SG

_INT64_MIN = -0x8000000000000000
_CANON_NAN_BITS = 0x7FF8000000000000


def orderable_values(data: torch.Tensor, is_floating: bool) -> torch.Tensor:
    """Monotone int64 transform: ascending int order of the result is SQL
    ascending order of the values (NaN last, -0 == 0)."""
    if not is_floating:
        return data.to(torch.int64)
    bits = data.to(torch.float64).contiguous().view(torch.int64)
    bits = torch.where(torch.isnan(data), _CANON_NAN_BITS, bits)
    bits = torch.where(data == 0, 0, bits)
    return torch.where(bits < 0, ~bits + _INT64_MIN, bits)


def orderable_key(col: DeviceColumn, ascending: bool = True,
                  nulls_first: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(key, bucket): lexicographic (bucket, key) ascending order is the
    requested SQL order. Nulls ride the bucket as +/-3, NaN as +/-2;
    -0.0 canonicalizes to 0.0 and NaN keys zero, so (bucket, key)
    equality is Spark grouping equality. The bucket must sort as a more
    significant operand than the key."""
    assert not col.is_string, "string sort keys come from string_sort_keys"
    if col.dtype.is_floating:
        v = col.data
        nan = torch.isnan(v)
        v = torch.where(nan | (v == 0), torch.zeros((), dtype=v.dtype,
                                                    device=v.device), v)
        key = v if ascending else -v
        bucket = torch.where(nan, 2 if ascending else -2, 0)
    else:
        key = col.data if ascending else ~col.data
        bucket = torch.zeros(col.capacity, dtype=torch.int64,
                             device=col.device)
    bucket = torch.where(col.validity, bucket, -3 if nulls_first else 3)
    return key, bucket.to(torch.int8)


def string_sort_keys(col: DeviceColumn, ascending: bool = True,
                     nulls_first: bool = True) -> List[torch.Tensor]:
    """Sort operands of a string column: [null bucket, code] for a
    sorted dictionary (code order is byte order by construction), else
    [null bucket] + one int16 char operand per column of the char
    matrix."""
    null_bucket = torch.where(col.validity, 0, -1 if nulls_first else 1
                              ).to(torch.int8)
    if col.is_dict and col.dict_sorted:
        key = torch.where(col.validity, col.codes, 0)
        if not ascending:
            key = -key - 1
        return [null_bucket, key]
    m = char_matrix(col)
    cols = [m[:, i] for i in range(m.shape[1])]
    if not ascending:
        cols = [-(c.to(torch.int32) + 1) for c in cols]
    return [null_bucket] + cols


def lexsort(operands: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation ordering rows by ``operands`` (the first is the
    most significant), like ``lax.sort(operands + (iota,), num_keys=k,
    is_stable=True)[-1]``."""
    n = operands[0].shape[0]
    perm = torch.arange(n, device=operands[0].device)
    for op in reversed(operands):
        k = op[perm]
        if k.dtype in (torch.bool, torch.int8):
            k = k.to(torch.int32)
        perm = perm[torch.sort(k, stable=True).indices]
    return perm


def sort_operands(keys: Sequence[DeviceColumn], ascending: Sequence[bool],
                  nulls_first: Sequence[bool]) -> List[torch.Tensor]:
    """Bucket and key operands for each sort key, in significance order."""
    operands: List[torch.Tensor] = []
    for k, a, n in zip(keys, ascending, nulls_first):
        if k.is_string:
            operands.extend(string_sort_keys(k, a, n))
        else:
            key, bucket = orderable_key(k, a, n)
            operands.extend((bucket, key))
    return operands


def sort_permutation(keys: Sequence[DeviceColumn], n_rows: torch.Tensor,
                     ascending: Optional[Sequence[bool]] = None,
                     nulls_first: Optional[Sequence[bool]] = None
                     ) -> torch.Tensor:
    """Stable permutation ordering the live rows ``[0, n_rows)`` by
    ``keys`` (ascending and nulls first unless given); dead rows sink to
    the end. Returns int64[capacity]."""
    capacity = keys[0].capacity
    up = [True] * len(keys)
    dead = torch.arange(capacity, device=keys[0].device) >= n_rows
    return lexsort([dead.to(torch.int8)] + sort_operands(
        keys, ascending or up, nulls_first or up))


def gather_column(col: DeviceColumn, indices: torch.Tensor,
                  index_valid: Optional[torch.Tensor] = None) -> DeviceColumn:
    """Rows of ``col`` at ``indices``; fixed-width and dictionary columns
    both move one lane (a dictionary rides along untouched). Flat strings
    move with the ragged ``strings`` gather, which reads the column's
    offsets and payload and writes the gathered ones (each row clipped at
    the column's width, as its char matrix would be)."""
    safe = indices.clamp(0, col.capacity - 1).long()
    validity = col.validity[safe]
    if index_valid is not None:
        validity = validity & index_valid
    if col.is_flat:
        w = max(col.max_bytes, 1)
        m = safe.shape[0]
        payload, offsets = SG.gather_strings(
            col.data, col.offsets, safe.to(torch.int32), validity, w,
            bucket_byte_capacity(m * w))
        return DeviceColumn(payload, validity, T.STRING, offsets=offsets,
                            max_bytes=col.max_bytes)
    lane = col.lane[safe]
    lane = torch.where(validity, lane, torch.zeros((), dtype=lane.dtype,
                                                   device=lane.device))
    return col.replace_rows(validity, lane)


def strings_from_matrix(m: torch.Tensor, validity: torch.Tensor,
                        max_bytes: int) -> DeviceColumn:
    """Rebuild a flat string column (offsets + payload) from a char
    matrix whose rows end in PAD (:func:`.cuda.strings.pack_rows`, into
    the byte ladder's rung for the matrix's bytes)."""
    out_cap, w = m.shape
    payload, offsets = SG.pack_rows(m, bucket_byte_capacity(out_cap * w))
    return DeviceColumn(payload, validity, T.STRING, offsets=offsets,
                        max_bytes=max_bytes)


def gather_columns(columns, indices: torch.Tensor,
                   index_valid: Optional[torch.Tensor] = None) -> tuple:
    return tuple(gather_column(c, indices, index_valid) for c in columns)


def compact(batch: ColumnarBatch, keep: torch.Tensor) -> ColumnarBatch:
    """Filter, LAZY: record the kept-row mask instead of moving rows."""
    keep = keep & batch.row_mask()
    return ColumnarBatch(batch.columns, keep.sum(), batch.schema, live=keep)


def physical(batch: ColumnarBatch) -> ColumnarBatch:
    """Move live rows of a lazy batch to the front, keeping their order
    (a cumsum gives each its slot; one scatter builds the gather map)."""
    if batch.live is None:
        return batch
    cap = batch.capacity
    live = batch.live
    iota = torch.arange(cap, device=live.device)
    pos = torch.cumsum(live.to(torch.int64), 0) - 1
    src = torch.zeros(cap + 1, dtype=torch.int64, device=live.device)
    src.scatter_(0, torch.where(live, pos, cap), iota)
    cols = gather_columns(batch.columns, src[:cap], iota < batch.n_rows)
    return ColumnarBatch(cols, batch.n_rows, batch.schema)


def shrink_sparse(batch: ColumnarBatch) -> ColumnarBatch:
    """A lazy batch whose live rows fill at most a quarter of it, moved
    to the front of a batch at their own ladder rung, in row order (the
    reference's streaming-mode shrink of sparse join outputs). Costs one
    host read of the live count; any other batch comes back unchanged."""
    if batch.live is None or batch.capacity < 4 * 128:
        return batch
    n = int(batch.n_rows)
    cap = bucket_capacity(max(n, 1))
    if cap * 4 > batch.capacity:
        return batch
    src = torch.zeros(cap, dtype=torch.int64, device=batch.device)
    src[:n] = torch.nonzero(batch.live).squeeze(1)
    iota = torch.arange(cap, device=batch.device)
    cols = gather_columns(batch.columns, src, iota < n)
    return ColumnarBatch(cols, batch.n_rows, batch.schema)


def sorted_dictionary(col: DeviceColumn) -> DeviceColumn:
    """A dictionary string column with the same strings over a unique,
    byte-ordered dictionary: the entries ranked on the host, the codes
    remapped on the device (what the parquet scan does for a page
    dictionary). For a dictionary a concatenation appended unsorted."""
    raw = np.array([str(s).encode("utf-8") for s in col.dictionary],
                   dtype=object)
    if not len(raw):
        return dictionary_column(torch.zeros_like(col.codes), col.validity,
                                 np.zeros(0, object), dict_sorted=True)
    entries, rank = np.unique(raw, return_inverse=True)
    remap = torch.from_numpy(rank.astype(np.int32)).to(col.device)
    codes = torch.where(col.validity,
                        remap[col.codes.clamp(0, len(raw) - 1).long()], 0)
    return dictionary_column(codes, col.validity,
                             np.array([b.decode("utf-8") for b in entries],
                                      dtype=object), dict_sorted=True)


def merged_dictionary_codes(cols: Sequence[DeviceColumn]
                            ) -> Tuple[np.ndarray, List[torch.Tensor]]:
    """One sorted, unique dictionary over the entries of several
    dictionary string columns, and each column's codes remapped into it
    (zero under a null): codes of different dictionaries then compare
    as their strings do. The entries merge on the host, O(dictionary);
    the remap is one device gather a column."""
    entries = np.unique(np.concatenate(
        [np.asarray(c.dictionary, dtype=object).astype(str)
         for c in cols] + [np.zeros(0, dtype=str)]))
    out = []
    for c in cols:
        if c.dict_size:
            rank = np.searchsorted(entries, np.asarray(
                c.dictionary, dtype=object).astype(str))
            remap = torch.from_numpy(rank.astype(np.int32)).to(c.device)
            codes = remap[c.codes.long().clamp(0, c.dict_size - 1)]
        else:
            codes = torch.zeros_like(c.codes)
        out.append(torch.where(c.validity, codes, 0).to(torch.int32))
    return entries.astype(object), out


def packed_sort_lane(batch: ColumnarBatch, keys: Sequence[DeviceColumn],
                     ascending: Sequence[bool], nulls_first: Sequence[bool]
                     ) -> Optional[torch.Tensor]:
    """The sort operands packed into ONE unique int64 lane, or None when
    the keys cannot pack. Eligible: a single key of at most 32 bits that
    is not a float (ints, dates, bools, dictionary codes), at a capacity
    of at most ``2**27``. The reference packs sorted dictionaries only;
    here an unsorted one (row groups or batches concatenated) packs its
    codes' byte-order rank (:func:`sorted_dictionary`), the same order.
    Layout, high to low, the stable sort's operand order (dead flag, null
    bucket, key, row index), each field non-negative in its width:
    ``[bit63: 0][4: dead 8 / bucket + 4][32: key + 2**31][27: row]``."""
    if len(keys) != 1:
        return None
    k = keys[0]
    if k.is_string and not k.is_dict:
        return None
    if k.is_dict and not k.dict_sorted:
        k = sorted_dictionary(k)
    if not k.is_string and (k.dtype.is_floating
                            or k.data.element_size() > 4
                            or k.data.dtype == torch.uint8):
        return None
    capacity = batch.capacity
    if capacity > 1 << SS.INDEX_BITS:
        return None
    a, nf = ascending[0], nulls_first[0]
    if k.is_string:
        bucket, key = string_sort_keys(k, a, nf)
    else:
        key, bucket = orderable_key(k, a, nf)
    live = batch.row_mask()
    field = torch.where(live, bucket.to(torch.int64) + 4, 8)
    u = key.to(torch.int64) + (1 << 31)
    iota = torch.arange(capacity, dtype=torch.int64, device=live.device)
    return (field << (32 + SS.INDEX_BITS)) | (u << SS.INDEX_BITS) | iota


def sort_batch_by_columns(batch: ColumnarBatch,
                          keys: Sequence[DeviceColumn],
                          ascending: Sequence[bool],
                          nulls_first: Sequence[bool]) -> ColumnarBatch:
    """Sort a batch by evaluated key columns; dead rows (lazy or past
    ``n_rows``) sink to the tail through a leading dead-row operand.

    A single packable key sorts as one int64 lane through the ``sortStep``
    kernel (:func:`packed_sort_lane`); the lane is unique per row, so the
    order is the stable sort's. Other keys take the stable lexsort."""
    live = batch.row_mask()
    iota = torch.arange(batch.capacity, device=live.device)
    lane = packed_sort_lane(batch, keys, ascending, nulls_first)
    if lane is not None:
        perm = SS.packed_argsort(lane)
    else:
        perm = lexsort([(~live).to(torch.int8)]
                       + sort_operands(keys, ascending, nulls_first))
    cols = gather_columns(batch.columns, perm, iota < batch.n_rows)
    return ColumnarBatch(cols, batch.n_rows, batch.schema)


def _topk_single_lane(key: DeviceColumn, ascending: bool,
                      nulls_first: bool, live: torch.Tensor):
    """(enc, ok): one float64 lane whose DESCENDING order is the requested
    SQL order, with finite sentinel layers dead -1e308 < nulls-last
    -1e307 < NaN-last -1e306 < values < NaN-first 1e306 < nulls-first
    1e307. ``ok`` is True when the encoding is exact by type, else a
    device bool that is False when a live value cannot ride the lane
    (|v| > 1e305 or inf; int64 beyond float64's exact range)."""
    valid = key.validity
    nan = None
    if key.is_dict:
        vf = key.codes.to(torch.float64)
        ok = True
    elif key.dtype.is_floating:
        v = key.data.to(torch.float64)
        nan = torch.isnan(v)
        ok = ~(live & valid & ~nan & (v.abs() > 1e305)).any()
        vf = torch.where(nan, 0.0, v)
    else:
        vf = key.data.to(torch.float64)
        if key.data.dtype == torch.int64:
            exact = vf.to(torch.int64) == key.data
            ok = ~(live & valid & ~exact).any()
        else:
            ok = True
    enc = -vf if ascending else vf
    if nan is not None:
        enc = torch.where(nan, -1e306 if ascending else 1e306, enc)
    enc = torch.where(valid, enc, 1e307 if nulls_first else -1e307)
    enc = torch.where(live, enc, -1e308)
    return enc, ok


def topk_batch_by_columns(batch: ColumnarBatch,
                          keys: Sequence[DeviceColumn],
                          ascending: Sequence[bool],
                          nulls_first: Sequence[bool], k: int,
                          allow_data_fallback: bool = True):
    """First ``k`` rows in sort order, in a k-sized capacity bucket.
    Returns ``(batch, ok)``; ``ok`` False (a device bool) means the
    single-lane encoding was inexact and the caller must take the exact
    path (``allow_data_fallback=False``).

    Single orderable key: a stable descending sort of the float64 lane,
    whose tie order (lower row first) is ``lax.top_k``'s. Otherwise: the
    keys-only lexsort of (dead flag, key operands)."""
    cap = batch.capacity
    kcap = bucket_capacity(max(k, 1))
    live = batch.row_mask()
    n_out = torch.clamp(batch.n_rows, max=k)
    iota_out = torch.arange(kcap, device=live.device)
    live_out = iota_out < n_out
    k_take = min(kcap, cap)
    single = len(keys) == 1 and (not keys[0].is_string or (
        keys[0].is_dict and keys[0].dict_sorted))
    if single and not allow_data_fallback and not keys[0].is_string \
            and (keys[0].dtype.is_floating
                 or keys[0].data.dtype == torch.int64):
        single = False
    if single:
        enc, ok = _topk_single_lane(keys[0], ascending[0], nulls_first[0],
                                    live)
        idx = torch.sort(enc, descending=True, stable=True).indices[:k_take]
    else:
        operands = [(~live).to(torch.int8)] + sort_operands(
            keys, ascending, nulls_first)
        idx = lexsort(operands)[:k_take]
        ok = True
    if k_take < kcap:
        idx = torch.cat([idx, torch.zeros(kcap - k_take, dtype=idx.dtype,
                                          device=idx.device)])
    cols = gather_columns(batch.columns, idx, live_out)
    return ColumnarBatch(cols, n_out, batch.schema), ok
