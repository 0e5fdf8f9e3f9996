"""Carry column and batch states over from the reference package.

For a SQL engine the data takes the place of weights: to hold a module
of the port against its reference, both must start from the same column
states. These functions build the port's :class:`DeviceColumn` and
:class:`ColumnarBatch` from the reference's fields, handed over as numpy
arrays (the reference's ``DeviceColumn`` / ``ColumnarBatch`` fields
``data``, ``validity``, ``codes``, ``n_rows`` and ``live``, plus a
dictionary string column's entries decoded to a numpy array). Nothing
here imports the reference.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from . import types as T
from .data.batch import ColumnarBatch
from .data.column import DeviceColumn


def column_from_reference(fields: Mapping[str, Optional[np.ndarray]],
                          dtype: T.DataType, device="cpu") -> DeviceColumn:
    """A port column from a reference column's fields: ``validity`` and
    either ``data`` (fixed width) or ``codes`` and ``dictionary`` (a
    sorted-dictionary string column). Data under nulls is zeroed, the
    port's invariant."""
    device = torch.device(device)
    validity = torch.tensor(np.asarray(fields["validity"], dtype=bool),
                            device=device)
    codes = fields.get("codes")
    if codes is not None:
        codes = np.where(fields["validity"], np.asarray(codes), 0)
        dictionary = np.asarray(fields["dictionary"], dtype=object)
        return DeviceColumn(None, validity, dtype,
                            codes=torch.as_tensor(codes.astype(np.int32),
                                                  device=device),
                            dictionary=dictionary)
    data = np.asarray(fields["data"]).astype(dtype.np_dtype)
    data = np.where(fields["validity"], data, np.zeros((), data.dtype))
    return DeviceColumn(torch.as_tensor(data, device=device), validity, dtype)


def batch_from_reference(columns: Sequence[Mapping[str, Optional[np.ndarray]]],
                         schema: T.Schema, n_rows: int,
                         live: Optional[np.ndarray] = None,
                         device="cpu") -> ColumnarBatch:
    """A port batch from the reference batch's column fields, its live
    row count and its lazy ``live`` mask (``None``: rows ``[0, n_rows)``
    are live)."""
    device = torch.device(device)
    cols = tuple(column_from_reference(c, f.data_type, device)
                 for c, f in zip(columns, schema))
    n = torch.tensor(int(n_rows), dtype=torch.int64, device=device)
    mask = None if live is None else torch.tensor(
        np.asarray(live, dtype=bool), device=device)
    return ColumnarBatch(cols, n, schema, live=mask)
