"""Device columns — port of ``spark_rapids_tpu/data/column.py``.

A :class:`DeviceColumn` is one column of one batch at a fixed capacity:
a ``data`` lane of the type's torch dtype and a bool ``validity`` lane,
both ``[capacity]``. Data under a null or dead row is zero, so padding
never changes a result.

Strings are sorted-dictionary encoded, the reference's TPU-native string
layout: the device holds int32 ``codes`` and the dictionary (unique,
ascending) stays on the host as a numpy array. Because the dictionary is
sorted, code order and code equality are string order and string
equality, so sorts, group-bys and comparisons work on codes alone. Flat
strings (offsets + bytes) and the char matrix wait for the strings port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import types as T
from ..compile.ladder import bucket_capacity  # noqa: F401 (re-export)


@dataclasses.dataclass
class DeviceColumn:
    """One column: ``data`` (fixed width) or ``codes`` + ``dictionary``
    (strings), plus ``validity``."""

    data: Optional[torch.Tensor]
    validity: torch.Tensor
    dtype: T.DataType
    #: int32[capacity] dictionary codes (strings only).
    codes: Optional[torch.Tensor] = None
    #: Host numpy array of the unique, ascending dictionary entries.
    dictionary: Optional[np.ndarray] = None

    @property
    def capacity(self) -> int:
        return self.validity.shape[0]

    @property
    def device(self) -> torch.device:
        return self.validity.device

    @property
    def is_string(self) -> bool:
        return self.codes is not None

    @property
    def is_dict(self) -> bool:
        return self.codes is not None

    @property
    def dict_size(self) -> int:
        return 0 if self.dictionary is None else len(self.dictionary)

    @property
    def lane(self) -> torch.Tensor:
        """The device lane that moves with the rows (codes for strings)."""
        return self.codes if self.codes is not None else self.data

    def replace_rows(self, validity: torch.Tensor,
                     lane: torch.Tensor) -> "DeviceColumn":
        """Same type and dictionary, new rows."""
        if self.is_dict:
            return DeviceColumn(None, validity, self.dtype, codes=lane,
                                dictionary=self.dictionary)
        return DeviceColumn(lane, validity, self.dtype)


def scalar_column(value, dtype: T.DataType, capacity: int,
                  live: torch.Tensor) -> DeviceColumn:
    """Broadcast a literal into a column. ``live`` is the batch's row
    mask: the literal is valid exactly on live rows, as in the
    reference. A string literal is a one-entry dictionary."""
    device = live.device
    if value is None:
        z = torch.zeros(capacity, dtype=dtype.torch_dtype, device=device)
        off = torch.zeros(capacity, dtype=torch.bool, device=device)
        if dtype is T.STRING:
            return DeviceColumn(None, off, dtype, codes=z,
                                dictionary=np.array([""], dtype=object))
        return DeviceColumn(z, off, dtype)
    if dtype is T.STRING:
        codes = torch.zeros(capacity, dtype=torch.int32, device=device)
        return DeviceColumn(None, live, dtype, codes=codes,
                            dictionary=np.array([str(value)], dtype=object))
    full = torch.full((capacity,), value, dtype=dtype.torch_dtype,
                      device=device)
    data = torch.where(live, full, torch.zeros((), dtype=full.dtype,
                                               device=device))
    return DeviceColumn(data, live, dtype)
