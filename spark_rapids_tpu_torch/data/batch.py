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
returns. An array column is a numpy object array of lists (``None`` for
a null array or element), a struct column an object array of dicts
keyed by field name (``None`` for a null struct), as the reference's
``to_pylist()`` gives them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from .. import types as T
from ..utils import lockdep
from .column import (DeviceColumn, array_column, bucket_byte_capacity,
                     bucket_capacity, dictionary_column, pow2_len)


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


def _host_values(c: DeviceColumn, mask: torch.Tensor) -> tuple:
    """(values, validity) of a column's live rows on the host: numpy
    lanes for fixed-width columns, object arrays (``None`` under a null)
    for strings, arrays and structs."""
    v = c.validity[mask].cpu().numpy()
    if c.is_struct:
        kids = [(kv.tolist() if kv.dtype != object else kv, kok)
                for kv, kok in (_host_values(k, mask) for k in c.children)]
        names = [f.name for f in c.dtype.fields]
        out = np.empty(len(v), dtype=object)
        for i, ok in enumerate(v):
            out[i] = {nm: (kv[i] if kok[i] else None)
                      for nm, (kv, kok) in zip(names, kids)} if ok else None
        return out, v
    if c.is_array:
        data = c.data[mask].cpu().numpy().tolist()
        ev = c.elem_validity[mask].cpu().numpy().tolist()
        lens = c.lengths[mask].cpu().numpy().tolist()
        out = np.empty(len(v), dtype=object)
        for i, ok in enumerate(v):
            out[i] = [x if e else None for x, e in
                      zip(data[i][:lens[i]], ev[i][:lens[i]])] if ok else None
        return out, v
    if c.is_flat:
        return _flat_to_host(c, mask, v), v
    lane = c.lane[mask].cpu().numpy()
    if c.is_dict:
        vals = c.dictionary[np.clip(lane, 0, c.dict_size - 1)] \
            if c.dict_size else np.full(len(lane), "", object)
        return np.where(v, vals, None), v
    return lane, v


def _nulls_of(arr: np.ndarray) -> np.ndarray:
    return np.array([x is None for x in arr], dtype=bool)


def _array_lanes(values: np.ndarray, valid: np.ndarray,
                 dtype: "T.ArrayType", capacity: int):
    """(data, elem_validity, lengths) numpy lanes of an array column at
    ``capacity`` from lists (``None`` for a null element)."""
    lens = np.array([len(x) if ok and x is not None else 0
                     for x, ok in zip(values, valid)], dtype=np.int64)
    width = pow2_len(int(lens.max()) if len(lens) else 1)
    flat = [x for lst, n in zip(values, lens) if n for x in lst]
    fnull = np.array([x is None for x in flat], dtype=bool)
    et = dtype.element_type.np_dtype
    fvals = np.array([0 if x is None else x for x in flat]).astype(et) \
        if flat else np.zeros(0, et)
    rows = np.repeat(np.arange(len(lens)), lens)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]) if len(lens) \
        else np.zeros(0, np.int64)
    cols = np.arange(len(flat)) - np.repeat(starts, lens)
    data = np.zeros((capacity, width), dtype=et)
    ev = np.zeros((capacity, width), dtype=bool)
    data[rows, cols] = np.where(fnull, np.zeros((), et), fvals)
    ev[rows, cols] = ~fnull
    return data, ev, _pad(lens.astype(np.int32), capacity)


def _column_to_device(arr: np.ndarray, valid: np.ndarray,
                      dtype: T.DataType, cap: int,
                      device: torch.device) -> DeviceColumn:
    """One host column (values and validity) as a device column at
    ``cap``; strings dictionary-encoded with a sorted ``np.unique``."""
    valid_dev = _to_device(_pad(valid, cap), device)
    if isinstance(dtype, T.StructType):
        kids = []
        for f in dtype.fields:
            vals = np.empty(len(arr), dtype=object)
            vals[:] = [x.get(f.name) if ok and x is not None else None
                       for x, ok in zip(arr, valid)]
            kids.append(_column_to_device(vals, ~_nulls_of(vals),
                                          f.data_type, cap, device))
        return DeviceColumn(None, valid_dev, dtype, children=tuple(kids))
    if isinstance(dtype, T.ArrayType):
        data, ev, lens = _array_lanes(arr, valid, dtype, cap)
        return array_column(_to_device(data, device), _to_device(ev, device),
                            _to_device(lens, device), valid_dev, dtype)
    if dtype is T.STRING:
        text = np.where(_nulls_of(arr), "", arr) if arr.dtype == object \
            else arr
        dictionary, codes = np.unique(text.astype(str), return_inverse=True)
        codes = np.where(valid, codes, 0)
        lane = _to_device(_pad(codes.astype(np.int32), cap), device)
        return dictionary_column(lane, valid_dev, dictionary.astype(object),
                                 dict_sorted=True)
    if arr.dtype == object:
        arr = np.where(valid, arr, 0)
    vals = np.where(valid, arr.astype(dtype.np_dtype),
                    np.zeros((), dtype.np_dtype))
    return DeviceColumn(_to_device(_pad(vals, cap), device), valid_dev, dtype)


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

    @property
    def nbytes(self) -> int:
        """Bytes of the value and validity arrays (an object array counts
        its pointers)."""
        pairs = self.positional if self.positional is not None else \
            [(self.columns[n], self.validity[n]) for n in self.columns]
        return sum(v.nbytes + ok.nbytes for v, ok in pairs)

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
        dtypes (int32 -> INT; pass a schema for DATE, arrays and structs).
        A ``None`` entry in an object array is a null."""
        cols, valid = {}, {}
        for name, arr in data.items():
            f = None if schema is None else schema.field_maybe(name)
            if f is not None and T.is_complex(f.data_type):
                vals = np.empty(len(arr), dtype=object)
                vals[:] = list(arr)
                arr = vals
            else:
                arr = np.asarray(arr)
            v = None if validity is None else validity.get(name)
            if arr.dtype == object:
                nulls = _nulls_of(arr)
                if nulls.any():
                    if f is None or not T.is_complex(f.data_type):
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
        ``np.unique``, so codes order like the strings. A column whose
        arrays are read-only comes from the upload cache when it was
        uploaded before (:mod:`.upload_cache`)."""
        from . import upload_cache
        device = torch.device(device)
        n = self.num_rows
        cap = capacity or bucket_capacity(n)
        cols = []
        for f in self.schema:
            values, valid = self.columns[f.name], self.validity[f.name]
            col = upload_cache.lookup(values, valid, f.data_type, cap,
                                      device)
            if col is None:
                col = _column_to_device(values, valid, f.data_type, cap,
                                        device)
                upload_cache.insert(values, valid, f.data_type, cap, device,
                                    col)
            cols.append(col)
        n_rows = torch.tensor(n, dtype=torch.int64, device=device)
        return ColumnarBatch(tuple(cols), n_rows, self.schema)

    def freeze(self) -> "HostBatch":
        """Make every array of the batch read-only (the caller promises
        not to write to them), so its uploads are cached
        (:mod:`.upload_cache`). Returns the batch."""
        pairs = self.positional if self.positional is not None else \
            [(self.columns[n], self.validity[n]) for n in self.columns]
        for v, ok in pairs:
            v.setflags(write=False)
            ok.setflags(write=False)
        return self

    @staticmethod
    def empty(schema: T.Schema) -> "HostBatch":
        """No rows of ``schema``."""
        return HostBatch.from_positional(
            schema, [(np.zeros(0, object if T.is_complex(f.data_type)
                               else f.data_type.np_dtype), np.zeros(0, bool))
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
        """Download the live rows in row order (one host sync per lane).
        A physical batch's live rows are its first ``n_rows``: a slice,
        read with one sync for the count, instead of a mask (whose
        indexing over the whole capacity dominates when the batch is
        already on the host, a :class:`HostCopy`'s)."""
        mask = slice(0, int(batch.n_rows)) if batch.live is None \
            else batch.row_mask()
        pairs = [_host_values(c, mask) for c in batch.columns]
        return HostBatch.from_positional(batch.schema, pairs)


def _move_column(c: DeviceColumn, device) -> DeviceColumn:
    move = lambda t: None if t is None else t.to(device)  # noqa: E731
    return dataclasses.replace(
        c, data=move(c.data), validity=move(c.validity), codes=move(c.codes),
        offsets=move(c.offsets), elem_validity=move(c.elem_validity),
        lengths=move(c.lengths),
        dict_bytes=None if c.dict_bytes is None
        else tuple(move(t) for t in c.dict_bytes),
        children=tuple(_move_column(k, device) for k in c.children))


def move_batch(batch: ColumnarBatch, device) -> ColumnarBatch:
    """``batch`` with every tensor on ``device`` (the scans' host
    fallback uploads what the host decoded this way)."""
    device = torch.device(device)
    if batch.device == device:
        return batch
    return ColumnarBatch(tuple(_move_column(c, device)
                               for c in batch.columns),
                         batch.n_rows.to(device), batch.schema,
                         live=None if batch.live is None
                         else batch.live.to(device))


def _grow_column(c: DeviceColumn, cap: int) -> DeviceColumn:
    """``c`` at the larger capacity ``cap``: every row lane padded with
    dead rows (zero, invalid); a flat column's offsets repeat their end,
    its payload is kept."""
    old = c.capacity

    def pad(t: torch.Tensor, fill=0) -> torch.Tensor:
        extra = torch.full((cap - old,) + tuple(t.shape[1:]), fill,
                           dtype=t.dtype, device=t.device)
        return torch.cat([t, extra])
    validity = pad(c.validity, False)
    if c.is_struct:
        return dataclasses.replace(c, validity=validity, children=tuple(
            _grow_column(k, cap) for k in c.children))
    if c.is_array:
        return dataclasses.replace(c, data=pad(c.data), validity=validity,
                                   elem_validity=pad(c.elem_validity, False),
                                   lengths=pad(c.lengths))
    if c.is_flat:
        tail = c.offsets[-1:].expand(cap - old)
        return dataclasses.replace(c, validity=validity,
                                   offsets=torch.cat([c.offsets, tail]))
    if c.is_dict:
        return dataclasses.replace(c, validity=validity, codes=pad(c.codes))
    return dataclasses.replace(c, data=pad(c.data), validity=validity)


def grow_batch(batch: ColumnarBatch, cap: int) -> ColumnarBatch:
    """``batch`` at the larger capacity ``cap`` (the reference's
    ``_grow_batch``): the new rows are dead, so every result is the
    same."""
    if cap <= batch.capacity or not batch.columns:
        return batch
    live = None if batch.live is None else torch.cat([
        batch.live, torch.zeros(cap - batch.capacity, dtype=torch.bool,
                                device=batch.device)])
    return ColumnarBatch(tuple(_grow_column(c, cap) for c in batch.columns),
                         batch.n_rows, batch.schema, live=live)


def _shrink_column(c: DeviceColumn, cap: int) -> DeviceColumn:
    """The first ``cap`` rows of ``c``; a flat column keeps the payload
    those rows can reach (``cap x max_bytes``), a dictionary column drops
    its device copy of the entries (the host ones decode it)."""
    if c.is_struct:
        return dataclasses.replace(c, validity=c.validity[:cap],
                                   children=tuple(_shrink_column(k, cap)
                                                  for k in c.children))
    if c.is_array:
        return dataclasses.replace(c, data=c.data[:cap],
                                   validity=c.validity[:cap],
                                   elem_validity=c.elem_validity[:cap],
                                   lengths=c.lengths[:cap])
    if c.is_flat:
        reach = bucket_byte_capacity(max(cap * max(c.max_bytes, 1), 1))
        return dataclasses.replace(c, data=c.data[:reach],
                                   validity=c.validity[:cap],
                                   offsets=c.offsets[:cap + 1])
    if c.is_dict:
        return dataclasses.replace(c, validity=c.validity[:cap],
                                   codes=c.codes[:cap], dict_bytes=None)
    return dataclasses.replace(c, data=c.data[:cap],
                               validity=c.validity[:cap])


def shrink_batch(batch: ColumnarBatch, cap: int) -> ColumnarBatch:
    """The first ``cap`` rows of a physical batch (the reference's
    ``_shrink_batch``), for the fused result's head: rows past ``cap``
    are lost, so the caller checks the row count."""
    assert batch.live is None, "shrink_batch takes a physical batch"
    if cap >= batch.capacity:
        return batch
    return ColumnarBatch(tuple(_shrink_column(c, cap) for c in batch.columns),
                         batch.n_rows, batch.schema)


def flat_payload_fits(batch: ColumnarBatch) -> bool:
    """Whether every flat string column of a host-side (CPU) batch holds
    the payload its live rows reach (a head cut at ``guessRows`` may
    not)."""
    n = int(batch.n_rows)
    for c in _flat_columns(batch.columns):
        if n and int(c.offsets[min(n, c.capacity)]) > c.data.shape[0]:
            return False
    return True


def _lane_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes as a flat uint8 lane (a bool lane as its bytes)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


class HostCopy:
    """An asynchronous device-to-host copy of a tree of batches, columns
    and tensors (a fused result's head: many small lanes) as ONE copy
    into one pinned buffer: the lanes are concatenated on the device (one
    kernel, each at an 8-byte aligned offset), :meth:`begin` queues the
    copy on the current stream and returns at once, :meth:`finish` waits
    for it and returns the same tree over CPU tensors (views of the
    buffer)."""

    def __init__(self, tree):
        from ..compile.executables import flatten
        self.leaves, self.spec = flatten(tree)
        self.shapes = [tuple(t.shape) for t in self.leaves]
        self.dtypes = [t.dtype for t in self.leaves]
        self.sizes = [t.numel() * t.element_size() for t in self.leaves]
        self.starts, total = [], 0
        for nb in self.sizes:
            self.starts.append(total)
            total += _aligned(nb)
        self.nbytes = total
        self.on_card = any(t.is_cuda for t in self.leaves)
        self.host = None
        self.event = None

    def begin(self) -> "HostCopy":
        if not self.on_card:
            return self
        dev = next(t.device for t in self.leaves if t.is_cuda)
        self.host = torch.empty(max(self.nbytes, 1), dtype=torch.uint8,
                                pin_memory=True)
        parts, pos = [], 0
        for t, s, nb in zip(self.leaves, self.starts, self.sizes):
            if not nb:
                continue
            if s > pos:
                parts.append(torch.zeros(s - pos, dtype=torch.uint8,
                                         device=dev))
            parts.append(_lane_bytes(t))
            pos = s + nb
        if parts:
            buf = torch.cat(parts)
            self.host[:buf.numel()].copy_(buf, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(dev))
        return self

    def finish(self):
        """The tree over CPU tensors (waits for the copy)."""
        from ..compile.executables import unflatten
        if not self.on_card:
            return unflatten(self.spec, self.leaves)
        with lockdep.blocking("HostCopy.wait"):
            self.event.synchronize()
        out = []
        for shape, dt, s, nb in zip(self.shapes, self.dtypes, self.starts,
                                    self.sizes):
            out.append(self.host[s:s + nb].view(dt).reshape(shape))
        return unflatten(self.spec, out)


def host_batch(batch: Optional[ColumnarBatch], schema: T.Schema
               ) -> "HostBatch":
    """The live rows of a batch whose tensors are on the host (a
    :class:`HostCopy`'s), in row order; no rows of ``schema`` for None."""
    if batch is None:
        return HostBatch.empty(schema)
    hb = HostBatch.from_device(batch)
    # a lane read by slice views the copy's (pinned) buffer: copy it out,
    # so the buffer goes back to the allocator's cache for the next copy
    return HostBatch.from_positional(hb.schema, [
        (v.copy() if v.base is not None else v,
         ok.copy() if ok.base is not None else ok)
        for v, ok in (hb.column_at(i) for i in range(len(hb.schema)))])


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
    dictionary travels whole, codes unchanged), ``offsets`` (int32
    ``[n + 1]`` from 0) plus a uint8 payload in ``data`` (a flat string
    column), ``data`` ``[n, max_len]`` with ``elem_validity`` and
    ``lengths`` (an array), or ``children`` (a struct's fields). Data
    under a null is zero, as on the device."""

    dtype: T.DataType
    validity: np.ndarray
    data: Optional[np.ndarray] = None
    codes: Optional[np.ndarray] = None
    dictionary: Optional[np.ndarray] = None
    dict_sorted: bool = False
    offsets: Optional[np.ndarray] = None
    max_bytes: int = 0
    elem_validity: Optional[np.ndarray] = None
    lengths: Optional[np.ndarray] = None
    children: Optional[list] = None

    @property
    def num_rows(self) -> int:
        return len(self.validity)

    @property
    def nbytes(self) -> int:
        """Bytes of the lanes (the dictionary, kept on the host, not
        counted)."""
        lanes = (self.validity, self.data, self.codes, self.offsets,
                 self.elem_validity, self.lengths)
        return sum(a.nbytes for a in lanes if a is not None) + sum(
            c.nbytes for c in self.children or ())

    @property
    def is_dict(self) -> bool:
        return self.codes is not None

    @property
    def is_flat(self) -> bool:
        return self.offsets is not None

    @property
    def is_array(self) -> bool:
        return self.lengths is not None

    @property
    def is_struct(self) -> bool:
        return self.children is not None

    def slice(self, start: int, stop: int) -> "HostColumn":
        """Rows ``[start, stop)`` (numpy views; a flat column's offsets are
        rebased to 0)."""
        validity = self.validity[start:stop]
        if self.is_struct:
            return dataclasses.replace(self, validity=validity, children=[
                c.slice(start, stop) for c in self.children])
        if self.is_array:
            return dataclasses.replace(
                self, validity=validity, data=self.data[start:stop],
                elem_validity=self.elem_validity[start:stop],
                lengths=self.lengths[start:stop])
        if self.is_flat:
            off = self.offsets[start:stop + 1]
            return dataclasses.replace(
                self, validity=validity,
                data=self.data[off[0]:off[-1]], offsets=off - off[0])
        if self.is_dict:
            return dataclasses.replace(self, validity=validity,
                                       codes=self.codes[start:stop])
        return dataclasses.replace(self, validity=validity,
                                   data=self.data[start:stop])


def _aligned(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


def _flat_columns(columns) -> list:
    """The flat string columns among ``columns`` and their struct
    children."""
    out = []
    for c in columns:
        if c.is_struct:
            out += _flat_columns(c.children)
        elif c.is_flat:
            out.append(c)
    return out


def download_columns(batch: ColumnarBatch, n: int,
                     extra: Sequence[torch.Tensor] = ()):
    """Rows ``[0, n)`` of a physical batch (and of each ``extra`` lane) as
    :class:`HostColumn` s viewing ONE host buffer: each lane is copied
    straight into its range, at 8-byte aligned offsets, with no device
    staging buffer (the spill runs when the card is out of memory). On
    the card the buffer is pinned and the copies queue on the current
    stream, which is waited on before the views are returned. Returns
    ``(columns, extra host arrays)``."""
    assert batch.live is None, "download_columns takes a physical batch"
    dev = batch.device
    flat = _flat_columns(batch.columns)
    ends = {}
    if flat:  # payload spans of the flat columns: one host read
        bounds = torch.stack([torch.stack([c.offsets[0], c.offsets[n]])
                              for c in flat]).tolist()
        ends = {id(c): b for c, b in zip(flat, bounds)}
    lanes: list = []  # device tensors in transfer order, flattened
    shapes: list = []

    def add(t: torch.Tensor) -> int:
        shapes.append(tuple(t.shape))
        lanes.append(t.contiguous().reshape(-1))
        return len(lanes) - 1

    def plan(c: DeviceColumn) -> dict:
        entry = {"validity": add(c.validity[:n])}
        if c.is_struct:
            entry["children"] = [plan(k) for k in c.children]
        elif c.is_array:
            entry["data"] = add(c.data[:n])
            entry["elem_validity"] = add(c.elem_validity[:n])
            entry["lengths"] = add(c.lengths[:n])
        elif c.is_flat:
            a, b = ends[id(c)]
            entry["offsets"] = add(c.offsets[:n + 1] - a)
            entry["data"] = add(c.data[a:b])
        elif c.is_dict:
            entry["codes"] = add(c.codes[:n])
        else:
            entry["data"] = add(c.data[:n])
        return entry

    layout = [plan(c) for c in batch.columns]
    extra_at = [add(t[:n]) for t in extra]
    sizes = [t.numel() * t.element_size() for t in lanes]
    starts, total = [], 0
    for s in sizes:
        starts.append(total)
        total += _aligned(s)
    on_card = dev.type == "cuda"
    host = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=on_card)
    for t, s, nb in zip(lanes, starts, sizes):
        if nb:
            host[s:s + nb].copy_(t.view(torch.uint8), non_blocking=on_card)
    if on_card:
        with lockdep.blocking("download_columns.wait"):
            torch.cuda.current_stream(dev).synchronize()
    buf = host.numpy()
    views = [buf[s:s + nb].view(_np_of(t.dtype)).reshape(shape)
             for t, s, nb, shape in zip(lanes, starts, sizes, shapes)]

    def build(c: DeviceColumn, entry: dict) -> HostColumn:
        hc = HostColumn(c.dtype, views[entry["validity"]])
        if c.is_struct:
            hc.children = [build(k, e)
                           for k, e in zip(c.children, entry["children"])]
        elif c.is_array:
            hc.data = views[entry["data"]]
            hc.elem_validity = views[entry["elem_validity"]]
            hc.lengths = views[entry["lengths"]]
        elif c.is_flat:
            hc.offsets = views[entry["offsets"]]
            hc.data = views[entry["data"]]
            hc.max_bytes = c.max_bytes
        elif c.is_dict:
            hc.codes = views[entry["codes"]]
            hc.dictionary = c.dictionary
            hc.dict_sorted = c.dict_sorted
        else:
            hc.data = views[entry["data"]]
        return hc

    cols = [build(c, e) for c, e in zip(batch.columns, layout)]
    return cols, [views[i] for i in extra_at]


def _np_of(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def upload_columns(cols: Sequence[HostColumn], schema: T.Schema, device,
                   capacity: Optional[int] = None) -> ColumnarBatch:
    """A device batch of :class:`HostColumn` s at ``capacity`` (default:
    the ladder rung of the row count): each lane is copied from its
    numpy array straight into the front of its padded device lane. A
    dictionary column keeps its codes and its dictionary (no
    re-encoding); a flat column keeps its offsets and payload; an array
    keeps its ``max_len``."""
    device = torch.device(device)
    n = cols[0].num_rows if cols else 0
    cap = capacity or bucket_capacity(n)

    def lane(a: np.ndarray, pad_to: int, fill=0) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(a))
        out = torch.full((pad_to,) + tuple(host.shape[1:]), fill,
                         dtype=host.dtype, device=device)
        out[:len(a)].copy_(host)
        return out

    def column(c: HostColumn) -> DeviceColumn:
        valid = lane(c.validity, cap, False)
        if c.is_struct:
            return DeviceColumn(None, valid, c.dtype, children=tuple(
                column(k) for k in c.children))
        if c.is_array:
            return DeviceColumn(lane(c.data, cap), valid, c.dtype,
                                elem_validity=lane(c.elem_validity, cap,
                                                   False),
                                lengths=lane(c.lengths, cap))
        if c.is_flat:
            end = int(c.offsets[-1]) if len(c.offsets) else 0
            return DeviceColumn(
                lane(c.data, bucket_byte_capacity(max(end, 1))), valid,
                T.STRING, offsets=lane(c.offsets, cap + 1, end),
                max_bytes=c.max_bytes)
        if c.is_dict:
            return dictionary_column(lane(c.codes, cap), valid, c.dictionary,
                                     dict_sorted=c.dict_sorted)
        return DeviceColumn(lane(c.data, cap), valid, c.dtype)

    out_cols = [column(c) for c in cols]
    n_rows = torch.tensor(n, dtype=torch.int64, device=device)
    return ColumnarBatch(tuple(out_cols), n_rows, schema)


def empty_host_column(dtype: T.DataType) -> HostColumn:
    """A :class:`HostColumn` of ``dtype`` with no rows (a string as an
    empty dictionary, an array of width 1)."""
    none = np.zeros(0, bool)
    if isinstance(dtype, T.StructType):
        return HostColumn(dtype, none, children=[
            empty_host_column(f.data_type) for f in dtype.fields])
    if isinstance(dtype, T.ArrayType):
        return HostColumn(dtype, none,
                          data=np.zeros((0, 1), dtype.np_dtype),
                          elem_validity=np.zeros((0, 1), bool),
                          lengths=np.zeros(0, np.int32))
    if dtype is T.STRING:
        return HostColumn(dtype, none, codes=np.zeros(0, np.int32),
                          dictionary=np.zeros(0, object), dict_sorted=True)
    return HostColumn(dtype, none, data=np.zeros(0, dtype.np_dtype))


def empty_batch(schema: T.Schema, device) -> ColumnarBatch:
    """A batch of ``schema`` with no live rows, at the smallest capacity
    (strings as empty dictionaries)."""
    return upload_columns([empty_host_column(f.data_type) for f in schema],
                          schema, device)
