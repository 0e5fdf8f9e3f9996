"""Device and host batches — port of ``spark_rapids_tpu/data/batch.py``.

A :class:`ColumnarBatch` is a tuple of :class:`DeviceColumn` at one
capacity plus ``n_rows``, a 0-d int64 tensor on the device (the count
of live rows, kept on the device so no operator needs a host sync).
Liveness has two forms, as in the reference:

* physical (``live is None``): rows ``[0, n_rows)`` are live;
* lazy (``live`` is a bool ``[capacity]`` mask): live rows sit at their
  original positions, e.g. after a filter or a dense join. Every
  operator reads :meth:`ColumnarBatch.row_mask`, never ``n_rows`` alone.

:class:`HostBatch` is the host side: a dict of numpy arrays, a schema
and per-column validity. It is what users hand in and what ``collect``
returns.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from .. import types as T
from .column import (DeviceColumn, bucket_byte_capacity, bucket_capacity,
                     dictionary_column)


@dataclasses.dataclass
class ColumnarBatch:
    columns: tuple
    n_rows: torch.Tensor
    schema: T.Schema
    live: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else 0

    @property
    def device(self) -> torch.device:
        return self.n_rows.device

    def column(self, key: Union[int, str]) -> DeviceColumn:
        if isinstance(key, str):
            key = self.schema.index_of(key)
        return self.columns[key]

    def with_columns(self, columns: Sequence[DeviceColumn],
                     schema: T.Schema) -> "ColumnarBatch":
        return ColumnarBatch(tuple(columns), self.n_rows, schema,
                             live=self.live)

    def row_mask(self) -> torch.Tensor:
        """bool[capacity]: True for live rows."""
        if self.live is not None:
            return self.live
        return torch.arange(self.capacity, device=self.device) < self.n_rows


def _pad(values: np.ndarray, capacity: int) -> np.ndarray:
    out = np.zeros(capacity, dtype=values.dtype)
    out[:len(values)] = values
    return out


def _flat_to_host(c: DeviceColumn, mask: torch.Tensor,
                  valid: np.ndarray) -> np.ndarray:
    """A flat string column's live rows as a numpy object array (None
    under a null), from its offsets and payload."""
    starts = c.offsets[:-1][mask].cpu().numpy()
    ends = c.offsets[1:][mask].cpu().numpy()
    hi = int(ends.max()) if len(ends) else 0
    payload = c.data[:hi].cpu().numpy().tobytes()
    out = np.empty(len(starts), dtype=object)
    for i, (a, b, ok) in enumerate(zip(starts, ends, valid)):
        out[i] = payload[a:b].decode("utf-8", errors="replace") if ok \
            else None
    return out


def _to_device(host: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(host)
    if device.type == "cuda":
        # Pinned staging lets the copy run as one DMA without a bounce
        # through pageable memory.
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclasses.dataclass
class HostBatch:
    """Host rows: ``columns`` name -> numpy values (strings as a numpy
    str/object array, dates as int32 days), ``validity`` name -> bool.
    Where the schema repeats a name (a ``USING`` join keeps both sides'
    keys), ``columns`` and ``validity`` hold the first column of that
    name, as ``col(name)`` reads it, and ``positional`` every column's
    (values, validity) in schema order (:meth:`column_at`)."""

    columns: Dict[str, np.ndarray]
    schema: T.Schema
    validity: Dict[str, np.ndarray]
    positional: Optional[list] = None

    @property
    def num_rows(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def column_at(self, i: int):
        """(values, validity) of the schema's ``i``-th column."""
        if self.positional is not None:
            return self.positional[i]
        name = self.schema.names[i]
        return self.columns[name], self.validity[name]

    @staticmethod
    def from_positional(schema: T.Schema, pairs: list) -> "HostBatch":
        """A batch of (values, validity) ``pairs`` in ``schema``'s order."""
        cols, valid = {}, {}
        for f, (v, ok) in zip(schema, pairs):
            cols.setdefault(f.name, v)
            valid.setdefault(f.name, ok)
        dup = len(cols) < len(pairs)
        return HostBatch(cols, schema, valid, list(pairs) if dup else None)

    @staticmethod
    def from_numpy(data: Dict[str, np.ndarray],
                   schema: Optional[T.Schema] = None,
                   validity: Optional[Dict[str, np.ndarray]] = None
                   ) -> "HostBatch":
        """Wrap numpy arrays. Without a schema, types come from the numpy
        dtypes (int32 -> INT; pass a schema for DATE). A ``None`` entry in
        an object array is a null."""
        cols, valid = {}, {}
        for name, arr in data.items():
            arr = np.asarray(arr)
            v = None if validity is None else validity.get(name)
            if arr.dtype == object:
                nulls = np.array([x is None for x in arr], dtype=bool)
                if nulls.any():
                    arr = np.where(nulls, "", arr)
                    v = ~nulls if v is None else (v & ~nulls)
            cols[name] = arr
            valid[name] = np.ones(len(arr), dtype=bool) if v is None \
                else np.asarray(v, dtype=bool)
        if schema is None:
            schema = T.Schema([T.StructField(n, T.from_numpy_dtype(a.dtype))
                               for n, a in cols.items()])
        return HostBatch(cols, schema, valid)

    def to_device(self, device, capacity: Optional[int] = None
                  ) -> ColumnarBatch:
        """Upload at ``capacity`` (default: the ladder rung of the row
        count). Strings are dictionary-encoded here with a sorted
        ``np.unique``, so codes order like the strings."""
        device = torch.device(device)
        n = self.num_rows
        cap = capacity or bucket_capacity(n)
        cols = []
        for f in self.schema:
            arr = self.columns[f.name]
            valid = _to_device(_pad(self.validity[f.name], cap), device)
            if f.data_type is T.STRING:
                dictionary, codes = np.unique(arr.astype(str),
                                              return_inverse=True)
                codes = np.where(self.validity[f.name], codes, 0)
                lane = _to_device(_pad(codes.astype(np.int32), cap), device)
                cols.append(dictionary_column(lane, valid,
                                              dictionary.astype(object),
                                              dict_sorted=True))
            else:
                vals = np.where(self.validity[f.name],
                                arr.astype(f.data_type.np_dtype),
                                np.zeros((), f.data_type.np_dtype))
                lane = _to_device(_pad(vals, cap), device)
                cols.append(DeviceColumn(lane, valid, f.data_type))
        n_rows = torch.tensor(n, dtype=torch.int64, device=device)
        return ColumnarBatch(tuple(cols), n_rows, self.schema)

    @staticmethod
    def empty(schema: T.Schema) -> "HostBatch":
        """No rows of ``schema``."""
        return HostBatch.from_positional(
            schema, [(np.zeros(0, f.data_type.np_dtype), np.zeros(0, bool))
                     for f in schema])

    @staticmethod
    def concat(batches: Sequence["HostBatch"]) -> "HostBatch":
        """Rows of ``batches`` (one schema) one after another."""
        first = batches[0]
        if len(batches) == 1:
            return first
        return HostBatch.from_positional(first.schema, [
            tuple(np.concatenate(part) for part in zip(
                *[b.column_at(i) for b in batches]))
            for i in range(len(first.schema.names))])

    @staticmethod
    def from_device(batch: ColumnarBatch) -> "HostBatch":
        """Download the live rows in row order (one host sync per lane)."""
        mask = batch.row_mask()
        pairs = []
        for c in batch.columns:
            v = c.validity[mask].cpu().numpy()
            if c.is_flat:
                pairs.append((_flat_to_host(c, mask, v), v))
                continue
            lane = c.lane[mask].cpu().numpy()
            if c.is_dict:
                vals = c.dictionary[np.clip(lane, 0, c.dict_size - 1)] \
                    if c.dict_size else np.full(len(lane), "", object)
                vals = np.where(v, vals, None)
            else:
                vals = lane
            pairs.append((vals, v))
        return HostBatch.from_positional(batch.schema, pairs)


# --------------------------------------------------------------------------
# Column lanes on the host: what the shuffle exchange downloads, splits,
# serializes and uploads again.
# --------------------------------------------------------------------------

#: Lanes start at multiples of this many bytes in a packed transfer
#: buffer, so every lane can be viewed in its own dtype.
_ALIGN = 8


@dataclasses.dataclass
class HostColumn:
    """One column's lanes on the host, in the device layout: ``validity``
    (bool ``[n]``) and either ``data`` (fixed width ``[n]``), ``codes``
    (int32 ``[n]``) plus ``dictionary`` (a dictionary string column; the
    dictionary travels whole, codes unchanged), or ``offsets`` (int32
    ``[n + 1]`` from 0) plus a uint8 payload in ``data`` (a flat string
    column). Data under a null is zero, as on the device."""

    dtype: T.DataType
    validity: np.ndarray
    data: Optional[np.ndarray] = None
    codes: Optional[np.ndarray] = None
    dictionary: Optional[np.ndarray] = None
    dict_sorted: bool = False
    offsets: Optional[np.ndarray] = None
    max_bytes: int = 0

    @property
    def num_rows(self) -> int:
        return len(self.validity)

    @property
    def is_dict(self) -> bool:
        return self.codes is not None

    @property
    def is_flat(self) -> bool:
        return self.offsets is not None

    def slice(self, start: int, stop: int) -> "HostColumn":
        """Rows ``[start, stop)`` (numpy views; a flat column's offsets are
        rebased to 0)."""
        if self.is_flat:
            off = self.offsets[start:stop + 1]
            return dataclasses.replace(
                self, validity=self.validity[start:stop],
                data=self.data[off[0]:off[-1]], offsets=off - off[0])
        if self.is_dict:
            return dataclasses.replace(self, validity=self.validity[start:stop],
                                       codes=self.codes[start:stop])
        return dataclasses.replace(self, validity=self.validity[start:stop],
                                   data=self.data[start:stop])


def _aligned(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


def download_columns(batch: ColumnarBatch, n: int,
                     extra: Sequence[torch.Tensor] = ()):
    """Rows ``[0, n)`` of a physical batch (and of each ``extra`` lane) as
    :class:`HostColumn` s, in ONE device-to-host copy: every lane is
    packed into one device byte buffer first, at 8-byte aligned offsets,
    and the host side views its lanes in place. On the card the copy lands
    in pinned memory. Returns ``(columns, extra host arrays)``."""
    assert batch.live is None, "download_columns takes a physical batch"
    dev = batch.device
    flat = [c for c in batch.columns if c.is_flat]
    ends = {}
    if flat:  # payload spans of the flat columns: one host read
        bounds = torch.stack([torch.stack([c.offsets[0], c.offsets[n]])
                              for c in flat]).tolist()
        ends = {id(c): b for c, b in zip(flat, bounds)}
    lanes: list = []  # device tensors in transfer order

    def add(t: torch.Tensor) -> int:
        lanes.append(t.contiguous())
        return len(lanes) - 1

    layout = []
    for c in batch.columns:
        entry = {"validity": add(c.validity[:n])}
        if c.is_flat:
            a, b = ends[id(c)]
            entry["offsets"] = add(c.offsets[:n + 1] - a)
            entry["data"] = add(c.data[a:b])
        elif c.is_dict:
            entry["codes"] = add(c.codes[:n])
        else:
            entry["data"] = add(c.data[:n])
        layout.append(entry)
    extra_at = [add(t[:n]) for t in extra]
    sizes = [t.numel() * t.element_size() for t in lanes]
    starts, total = [], 0
    for s in sizes:
        starts.append(total)
        total += _aligned(s)
    packed = torch.zeros(max(total, 1), dtype=torch.uint8, device=dev)
    for t, s, nb in zip(lanes, starts, sizes):
        if nb:
            packed[s:s + nb] = t.view(torch.uint8)
    host = torch.empty(packed.shape, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    host.copy_(packed)
    buf = host.numpy()
    views = [buf[s:s + nb].view(_np_of(t.dtype))
             for t, s, nb in zip(lanes, starts, sizes)]
    cols = []
    for c, entry in zip(batch.columns, layout):
        hc = HostColumn(c.dtype, views[entry["validity"]])
        if c.is_flat:
            hc.offsets = views[entry["offsets"]]
            hc.data = views[entry["data"]]
            hc.max_bytes = c.max_bytes
        elif c.is_dict:
            hc.codes = views[entry["codes"]]
            hc.dictionary = c.dictionary
            hc.dict_sorted = c.dict_sorted
        else:
            hc.data = views[entry["data"]]
        cols.append(hc)
    return cols, [views[i] for i in extra_at]


def _np_of(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def upload_columns(cols: Sequence[HostColumn], schema: T.Schema, device,
                   capacity: Optional[int] = None) -> ColumnarBatch:
    """A device batch of :class:`HostColumn` s at ``capacity`` (default:
    the ladder rung of the row count): each lane is copied from its
    numpy array straight into the front of its padded device lane. A
    dictionary column keeps its codes and its dictionary (no
    re-encoding); a flat column keeps its offsets and payload."""
    device = torch.device(device)
    n = cols[0].num_rows if cols else 0
    cap = capacity or bucket_capacity(n)

    def lane(a: np.ndarray, pad_to: int, fill=0) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(a))
        out = torch.full((pad_to,), fill, dtype=host.dtype, device=device)
        out[:len(a)].copy_(host)
        return out

    out_cols = []
    for c in cols:
        valid = lane(c.validity, cap, False)
        if c.is_flat:
            end = int(c.offsets[-1]) if len(c.offsets) else 0
            out_cols.append(DeviceColumn(
                lane(c.data, bucket_byte_capacity(max(end, 1))), valid,
                T.STRING, offsets=lane(c.offsets, cap + 1, end),
                max_bytes=c.max_bytes))
        elif c.is_dict:
            out_cols.append(dictionary_column(lane(c.codes, cap), valid,
                                              c.dictionary,
                                              dict_sorted=c.dict_sorted))
        else:
            out_cols.append(DeviceColumn(lane(c.data, cap), valid, c.dtype))
    n_rows = torch.tensor(n, dtype=torch.int64, device=device)
    return ColumnarBatch(tuple(out_cols), n_rows, schema)


def empty_batch(schema: T.Schema, device) -> ColumnarBatch:
    """A batch of ``schema`` with no live rows, at the smallest capacity
    (strings as empty dictionaries)."""
    cols = [HostColumn(f.data_type, np.zeros(0, bool),
                       codes=np.zeros(0, np.int32),
                       dictionary=np.zeros(0, object), dict_sorted=True)
            if f.data_type is T.STRING else
            HostColumn(f.data_type, np.zeros(0, bool),
                       data=np.zeros(0, f.data_type.np_dtype))
            for f in schema]
    return upload_columns(cols, schema, device)
