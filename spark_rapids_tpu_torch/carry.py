"""Carry column and batch states over from the reference package.

For a SQL engine the data takes the place of weights: to hold a module
of the port against its reference, both must start from the same column
states. These functions build the port's :class:`DeviceColumn` and
:class:`ColumnarBatch` from the reference's fields, handed over as numpy
arrays: the reference's ``DeviceColumn`` / ``ColumnarBatch`` fields
``data``, ``validity``, ``offsets``, ``codes``, ``max_bytes``,
``dict_sorted``, ``n_rows`` and ``live``, with a dictionary string
column's entries decoded to a numpy array. Nothing here imports the
reference.

Like :class:`..session.TorchSession`, they put the columns on the card
unless the caller names another device, and raise when there is none.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from . import types as T
from .data.batch import ColumnarBatch
from .data.column import DeviceColumn, dictionary_column
from .session import resolve_device


def column_from_reference(fields: Mapping[str, Optional[np.ndarray]],
                          dtype: T.DataType, device=None) -> DeviceColumn:
    """A port column from a reference column's fields: ``validity`` and
    either ``data`` (fixed width), ``codes`` and ``dictionary`` (a
    dictionary string column; ``dict_sorted`` when given, else checked),
    or ``offsets``, ``data`` (the payload) and ``max_bytes`` (a flat
    string column). Data under nulls is zeroed, the port's invariant."""
    device = resolve_device(device)
    valid_np = np.asarray(fields["validity"], dtype=bool)
    validity = torch.tensor(valid_np, device=device)
    codes = fields.get("codes")
    if codes is not None:
        codes = np.where(valid_np, np.asarray(codes), 0).astype(np.int32)
        sorted_flag = fields.get("dict_sorted")
        return dictionary_column(
            torch.tensor(codes, device=device), validity,
            fields["dictionary"],
            None if sorted_flag is None else bool(sorted_flag))
    if fields.get("offsets") is not None:
        return DeviceColumn(
            torch.tensor(np.asarray(fields["data"], dtype=np.uint8),
                         device=device), validity, T.STRING,
            offsets=torch.tensor(np.asarray(fields["offsets"],
                                            dtype=np.int32), device=device),
            max_bytes=int(fields["max_bytes"]))
    data = np.asarray(fields["data"]).astype(dtype.np_dtype)
    data = np.where(valid_np, data, np.zeros((), data.dtype))
    return DeviceColumn(torch.tensor(data, device=device), validity, dtype)


def batch_from_reference(columns: Sequence[Mapping[str, Optional[np.ndarray]]],
                         schema: T.Schema, n_rows: int,
                         live: Optional[np.ndarray] = None,
                         device=None) -> ColumnarBatch:
    """A port batch from the reference batch's column fields, its live
    row count and its lazy ``live`` mask (``None``: rows ``[0, n_rows)``
    are live)."""
    device = resolve_device(device)
    cols = tuple(column_from_reference(c, f.data_type, device)
                 for c, f in zip(columns, schema))
    n = torch.tensor(int(n_rows), dtype=torch.int64, device=device)
    mask = None if live is None else torch.tensor(
        np.asarray(live, dtype=bool), device=device)
    return ColumnarBatch(cols, n, schema, live=mask)
