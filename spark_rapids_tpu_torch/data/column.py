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

Complex columns take the reference's layouts:

* **array** (``lengths`` set): ``data`` is the ``[capacity, max_len]``
  element matrix, ``elem_validity`` its bool mask and ``lengths`` the
  int32 length of each row; ``max_len`` is a power of two, as the
  reference's ``array_from_arrow`` buckets it. Elements past a row's
  length, and every element of a null row, are zero and invalid.
* **struct** (``children`` set): one child column per field, at the
  struct's capacity, plus the struct's own ``validity``; ``data`` is
  None. A null struct keeps its children's values.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
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
    #: bool[capacity, max_len] element mask (arrays only).
    elem_validity: Optional[torch.Tensor] = None
    #: int32[capacity] element counts, 0 under a null (arrays only).
    lengths: Optional[torch.Tensor] = None
    #: One column per field (structs only).
    children: tuple = ()

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
    def is_array(self) -> bool:
        return self.lengths is not None

    @property
    def is_struct(self) -> bool:
        return isinstance(self.dtype, T.StructType)

    @property
    def is_complex(self) -> bool:
        return self.is_array or self.is_struct

    @property
    def max_len(self) -> int:
        assert self.is_array
        return self.data.shape[1]

    @property
    def dict_size(self) -> int:
        return 0 if self.dictionary is None else len(self.dictionary)

    @property
    def lane(self) -> torch.Tensor:
        """The device lane that moves with the rows (codes for dictionary
        strings; flat strings have none and move through
        :func:`..ops.kernels.rowops.gather_column`)."""
        assert not self.is_flat, "a flat string column has no single lane"
        assert not self.is_complex, "a complex column has no single lane"
        return self.codes if self.codes is not None else self.data

    def replace_rows(self, validity: torch.Tensor,
                     lane: torch.Tensor) -> "DeviceColumn":
        """Same type and dictionary, new rows (not for flat strings)."""
        if self.is_dict:
            return dataclasses.replace(self, validity=validity, codes=lane)
        assert not self.is_flat and not self.is_complex
        return DeviceColumn(lane, validity, self.dtype)


_CONST_LOCK = threading.Lock()
#: (device, dtype, shape, bytes) -> (device tensor, pinned host tensor)
_CONSTS: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
_CONST_BYTES = [0]
#: Bytes of device constants kept; the least recently used go first.
_CONST_MAX_BYTES = 64 << 20
#: Host arrays above this size are uploaded without being kept.
_CONST_MAX_ENTRY = 1 << 20
#: Per thread: the list a capture collects the constants it read into
#: (:func:`recording_constants`), or None.
_SINK = threading.local()


@contextlib.contextmanager
def recording_constants():
    """Collect every ``(device tensor, pinned host tensor)`` pair that
    :func:`device_constant` hands out in this thread inside the block,
    cached or not. A CUDA graph captured there reads those addresses at
    every replay, so its holder keeps the pairs as long as the graph: the
    cache may evict them meanwhile."""
    prev = getattr(_SINK, "held", None)
    held: list = []
    _SINK.held = held
    try:
        yield held
    finally:
        _SINK.held = prev


def device_constant(host, device, dtype=None) -> torch.Tensor:
    """A device copy of a small host array that an expression or kernel
    derived on the host (a literal's bytes, a dictionary's lookup table),
    READ-ONLY: on the card it is kept per content and device, so a fused
    region's later runs and its CUDA graph read the same tensor instead
    of uploading again (an upload from pageable memory synchronises, and
    a capture cannot run one). The pinned host copy the upload read from
    is kept with it. A larger array is uploaded from pinned memory
    without being kept. The cache evicts its least recently used entries,
    so a capture holds every pair it was handed
    (:func:`recording_constants`) until its graph is released. On the
    CPU it is a plain tensor."""
    host = np.ascontiguousarray(np.asarray(host, dtype=dtype))
    device = torch.device(device)
    sink = getattr(_SINK, "held", None)
    if device.type != "cuda":
        out = torch.from_numpy(host.copy())
        if sink is not None:
            sink.append((out, None))
        return out
    nbytes = host.nbytes
    small = nbytes <= _CONST_MAX_ENTRY
    if small:
        key = (str(device), host.dtype.str, host.shape, host.tobytes())
        with _CONST_LOCK:
            hit = _CONSTS.get(key)
            if hit is not None:
                _CONSTS.move_to_end(key)
        if hit is not None:
            if sink is not None:
                sink.append(hit)
            return hit[0]
    # A copy made while this thread captures a graph runs at the graph's
    # first replay, not now: such a constant is not shared, or another
    # thread could read it before it holds its value.
    if not small or torch.cuda.is_current_stream_capturing():
        pinned = torch.from_numpy(host.copy()).pin_memory()
        dev = pinned.to(device, non_blocking=True)
        if sink is not None:
            sink.append((dev, pinned))
        return dev
    pinned = torch.from_numpy(host.copy()).pin_memory()
    dev = pinned.to(device, non_blocking=True)
    with _CONST_LOCK:
        hit = _CONSTS.setdefault(key, (dev, pinned))
        if hit[0] is dev:
            _CONST_BYTES[0] += nbytes
            while _CONST_BYTES[0] > _CONST_MAX_BYTES \
                    and len(_CONSTS) > 1:
                _, (old, _) = _CONSTS.popitem(last=False)
                _CONST_BYTES[0] -= old.numel() * old.element_size()
    if sink is not None:
        sink.append(hit)
    return hit[0]


def pow2_len(n: int) -> int:
    """An array column's ``max_len``: the power of two at or above ``n``
    (at least 1), the reference's ``_pow2``."""
    out = 1
    while out < n:
        out <<= 1
    return out


def array_column(data: torch.Tensor, elem_validity: torch.Tensor,
                 lengths: torch.Tensor, validity: torch.Tensor,
                 dtype: "T.ArrayType") -> DeviceColumn:
    """An array column with the port's invariant restored: a null row has
    length 0, and an element past its row's length or under a null is
    invalid and zero."""
    lengths = torch.where(validity, lengths.to(torch.int32), 0)
    in_len = torch.arange(data.shape[1], device=data.device)[None, :] \
        < lengths[:, None]
    ev = elem_validity & in_len & validity[:, None]
    data = torch.where(ev, data, torch.zeros((), dtype=data.dtype,
                                             device=data.device))
    return DeviceColumn(data, validity, dtype, elem_validity=ev,
                        lengths=lengths)


def null_column(dtype: T.DataType, capacity: int,
                device: torch.device) -> DeviceColumn:
    """An all-null column of ``dtype`` (the reference's ``null_column``:
    an array of width 1, a struct of all-null children, a one-entry
    dictionary string)."""
    off = torch.zeros(capacity, dtype=torch.bool, device=device)
    if isinstance(dtype, T.ArrayType):
        return DeviceColumn(
            torch.zeros((capacity, 1), dtype=dtype.torch_dtype,
                        device=device), off, dtype,
            elem_validity=torch.zeros((capacity, 1), dtype=torch.bool,
                                      device=device),
            lengths=torch.zeros(capacity, dtype=torch.int32, device=device))
    if isinstance(dtype, T.StructType):
        return DeviceColumn(None, off, dtype, children=tuple(
            null_column(f.data_type, capacity, device) for f in dtype.fields))
    return scalar_column(None, dtype, capacity, off)


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
    # bytes that are not UTF-8 (a byte-wise transform of an entry) ride
    # in the host string as surrogates and come back unchanged
    raw = [str(s).encode("utf-8", "surrogateescape") for s in dictionary]
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
                        dict_bytes=(device_constant(payload, dev),
                                    device_constant(offsets, dev)))


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
