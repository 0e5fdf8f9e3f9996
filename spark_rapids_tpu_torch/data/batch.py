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
from .column import DeviceColumn, bucket_capacity, dictionary_column


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
    str/object array, dates as int32 days), ``validity`` name -> bool."""

    columns: Dict[str, np.ndarray]
    schema: T.Schema
    validity: Dict[str, np.ndarray]

    @property
    def num_rows(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

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
    def from_device(batch: ColumnarBatch) -> "HostBatch":
        """Download the live rows in row order (one host sync per lane)."""
        mask = batch.row_mask()
        cols, valid = {}, {}
        for f, c in zip(batch.schema, batch.columns):
            v = c.validity[mask].cpu().numpy()
            if c.is_flat:
                cols[f.name] = _flat_to_host(c, mask, v)
                valid[f.name] = v
                continue
            lane = c.lane[mask].cpu().numpy()
            if c.is_dict:
                vals = c.dictionary[np.clip(lane, 0, c.dict_size - 1)] \
                    if c.dict_size else np.full(len(lane), "", object)
                vals = np.where(v, vals, None)
            else:
                vals = lane
            cols[f.name] = vals
            valid[f.name] = v
        return HostBatch(cols, batch.schema, valid)
