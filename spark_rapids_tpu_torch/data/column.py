"""Device columns — port of ``spark_rapids_tpu/data/column.py``.

A :class:`DeviceColumn` is one column of one batch at a fixed capacity:
a ``data`` lane of the type's torch dtype and a bool ``validity`` lane,
both ``[capacity]``. Data under a null or dead row is zero, so padding
never changes a result.

Strings come in the reference's two layouts:

* **dictionary** (``codes`` set): int32 ``codes`` on the device index a
  dictionary that stays on the host as a numpy array. Uploads build it
  with a sorted ``np.unique`` (``dict_sorted``: unique and ascending in
  byte order), so code order and code equality are string order and
  string equality, and sorts, group-bys and comparisons work on codes
  alone. Character work on such a column (``char_matrix``) reads
  ``dict_bytes``, a device copy of the entries' bytes made when the
  column is built and shared by every column cut from it.
* **flat** (``offsets`` set, ``codes`` None): Arrow's layout, ``offsets``
  int32[capacity + 1] into a uint8 payload ``data`` of
  ``bucket_byte_capacity`` bytes. Only expressions build flat strings
  (``Substring``); ``max_bytes`` bounds one row's length and sets the
  char-matrix width ``W`` (at least 128, the ladder's floor).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import types as T
from ..compile.ladder import (bucket_byte_capacity,  # noqa: F401 (re-export)
                              bucket_capacity)


@dataclasses.dataclass
class DeviceColumn:
    """One column: ``data`` (fixed width, or a flat string's payload),
    ``codes`` + ``dictionary`` (dictionary strings), ``offsets`` (flat
    strings), plus ``validity``."""

    data: Optional[torch.Tensor]
    validity: torch.Tensor
    dtype: T.DataType
    #: int32[capacity] dictionary codes (dictionary strings only).
    codes: Optional[torch.Tensor] = None
    #: Host numpy array of the dictionary entries (dictionary strings).
    dictionary: Optional[np.ndarray] = None
    #: int32[capacity + 1] offsets into ``data`` (flat strings only).
    offsets: Optional[torch.Tensor] = None
    #: Bound on one string's byte length, on the byte ladder (strings).
    max_bytes: int = 0
    #: The dictionary is unique and ascending in byte order.
    dict_sorted: bool = False
    #: (uint8 payload, int32[dict_size + 1] offsets) of the dictionary's
    #: entries on the device (dictionary strings only).
    dict_bytes: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @property
    def capacity(self) -> int:
        return self.validity.shape[0]

    @property
    def device(self) -> torch.device:
        return self.validity.device

    @property
    def is_string(self) -> bool:
        return self.codes is not None or self.offsets is not None

    @property
    def is_dict(self) -> bool:
        return self.codes is not None

    @property
    def is_flat(self) -> bool:
        return self.offsets is not None and self.codes is None

    @property
    def dict_size(self) -> int:
        return 0 if self.dictionary is None else len(self.dictionary)

    @property
    def lane(self) -> torch.Tensor:
        """The device lane that moves with the rows (codes for dictionary
        strings; flat strings have none and move through
        :func:`..ops.kernels.rowops.gather_column`)."""
        assert not self.is_flat, "a flat string column has no single lane"
        return self.codes if self.codes is not None else self.data

    def replace_rows(self, validity: torch.Tensor,
                     lane: torch.Tensor) -> "DeviceColumn":
        """Same type and dictionary, new rows (not for flat strings)."""
        if self.is_dict:
            return dataclasses.replace(self, validity=validity, codes=lane)
        assert not self.is_flat
        return DeviceColumn(lane, validity, self.dtype)


def string_max_bytes(longest: int) -> int:
    """The ``max_bytes`` of a string column whose longest entry has
    ``longest`` bytes (the reference's ``bucket_byte_capacity(len, 8)``)."""
    return bucket_byte_capacity(max(int(longest), 1), 8)


def dictionary_column(codes: torch.Tensor, validity: torch.Tensor,
                      dictionary: np.ndarray,
                      dict_sorted: Optional[bool] = None) -> DeviceColumn:
    """A dictionary string column with its entries' bytes copied to the
    codes' device; ``max_bytes`` comes from the entries, and
    ``dict_sorted`` is checked on the host when not given."""
    dictionary = np.asarray(dictionary, dtype=object)
    raw = [str(s).encode("utf-8") for s in dictionary]
    if dict_sorted is None:
        dict_sorted = all(a < b for a, b in zip(raw, raw[1:]))
    raw = raw or [b""]  # an empty dictionary keeps one (unused) entry
    lens = np.array([len(b) for b in raw], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    payload = np.zeros(bucket_byte_capacity(max(int(offsets[-1]), 1)),
                       dtype=np.uint8)
    payload[:offsets[-1]] = np.frombuffer(b"".join(raw), dtype=np.uint8)
    dev = codes.device
    return DeviceColumn(None, validity, T.STRING, codes=codes,
                        dictionary=dictionary,
                        max_bytes=string_max_bytes(lens.max()),
                        dict_sorted=bool(dict_sorted),
                        dict_bytes=(torch.from_numpy(payload).to(dev),
                                    torch.from_numpy(offsets).to(dev)))


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
            return dictionary_column(z, off, np.array([""], dtype=object),
                                     dict_sorted=True)
        return DeviceColumn(z, off, dtype)
    if dtype is T.STRING:
        codes = torch.zeros(capacity, dtype=torch.int32, device=device)
        return dictionary_column(codes, live,
                                 np.array([str(value)], dtype=object),
                                 dict_sorted=True)
    full = torch.full((capacity,), value, dtype=dtype.torch_dtype,
                      device=device)
    data = torch.where(live, full, torch.zeros((), dtype=full.dtype,
                                               device=device))
    return DeviceColumn(data, live, dtype)
