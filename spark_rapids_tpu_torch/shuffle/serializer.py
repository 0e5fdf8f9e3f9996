"""Shuffle block serialization — port of
``spark_rapids_tpu/shuffle/serializer.py``.

The reference writes a struct-packed header (``ShuffleTableMeta``)
followed by an Arrow IPC stream. The port writes the same kind of
header followed by each column's lanes as raw numpy bytes, because it
moves columns in their device layout (:class:`..data.batch.HostColumn`):

* header: magic, version, row count, codec, body sizes, and per field
  its name, type, nullability, layout (fixed, dictionary or flat),
  ``dict_sorted`` and ``max_bytes``, then the byte size of every lane;
* body (through the codec; only the pass-through one is ported): the
  lanes, each at an 8-byte aligned offset so the read side views them
  in place.

A dictionary column travels as its int32 code lane plus its dictionary
(entry offsets and bytes), so the read side rebuilds the column without
re-encoding its rows, and it keeps ``dict_sorted``. An array travels as
its lengths, element matrix and element mask (its ``max_len`` in the
field's ``max_bytes`` slot); a struct as its validity, then each field
in turn, the fields' header entries following the struct's (their count
in its ``max_bytes`` slot).
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np

from .. import types as T
from ..data.batch import HostColumn
from .codec import CopyCodec, get_codec

_MAGIC = b"TRCS"
_VERSION = 1
_ALIGN = 8
_FIXED, _DICT, _FLAT, _ARRAY, _STRUCT = 0, 1, 2, 3, 4


def _pad(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _dictionary_lanes(dictionary: np.ndarray) -> Tuple[np.ndarray,
                                                       np.ndarray]:
    raw = [str(s).encode("utf-8") for s in dictionary]
    offsets = np.zeros(len(raw) + 1, np.int64)
    offsets[1:] = np.cumsum([len(b) for b in raw])
    return offsets, np.frombuffer(b"".join(raw), np.uint8)


def _column_lanes(c: HostColumn) -> Tuple[int, List[np.ndarray]]:
    if c.is_struct:
        return _STRUCT, [c.validity]
    if c.is_array:
        return _ARRAY, [c.validity, c.lengths.astype(np.int32), c.data,
                        c.elem_validity]
    if c.is_flat:
        return _FLAT, [c.validity, c.offsets.astype(np.int32), c.data]
    if c.is_dict:
        return _DICT, [c.validity, c.codes.astype(np.int32),
                       *_dictionary_lanes(c.dictionary)]
    return _FIXED, [c.validity, c.data]


def _entries(cols: Sequence[HostColumn], fields) -> list:
    """(field, column, kind, lanes, slot) in header order: a struct, then
    its fields' entries. ``slot`` is the header's ``max_bytes`` value."""
    out = []
    for f, c in zip(fields, cols):
        kind, lanes = _column_lanes(c)
        slot = len(c.children) if kind == _STRUCT else \
            c.data.shape[1] if kind == _ARRAY else c.max_bytes
        out.append((f, c, kind, lanes, slot))
        if kind == _STRUCT:
            out += _entries(c.children, c.dtype.fields)
    return out


def serialize_block(cols: Sequence[HostColumn],
                    schema: T.Schema) -> np.ndarray:
    """One block, ``[header][body]``, as a uint8 array: one copy of every
    lane into one numpy allocation (numpy asks the kernel for huge pages
    on large arrays, so the fresh block faults in few pages), and
    writable, so the read side's lane views are too. The body goes
    through the pass-through codec, the only one ported."""
    n_rows = cols[0].num_rows if cols else 0
    entries = _entries(cols, schema)
    lanes = [np.ascontiguousarray(a).reshape(-1).view(np.uint8)
             for e in entries for a in e[3]]
    body_size = sum(_pad(a.nbytes) for a in lanes)
    head = [_MAGIC, struct.pack("<HqH", _VERSION, n_rows, len(cols))]
    codec_b = CopyCodec.name.encode()
    head += [struct.pack("<H", len(codec_b)), codec_b,
             struct.pack("<qq", body_size, body_size)]
    for f, c, kind, _, slot in entries:
        nb, tb = f.name.encode(), f.data_type.name.encode()
        head += [struct.pack("<HHBBBq", len(nb), len(tb), int(f.nullable),
                             kind, int(c.dict_sorted), slot), nb, tb]
    head.append(struct.pack("<H", len(lanes)))
    head.append(struct.pack(f"<{len(lanes)}q", *(a.nbytes for a in lanes)))
    header = np.frombuffer(b"".join(head), np.uint8)
    start = _pad(header.nbytes)
    out = np.empty(start + body_size, np.uint8)
    out[:header.nbytes] = header
    out[header.nbytes:start] = 0
    pos = start
    for a in lanes:
        out[pos:pos + a.nbytes] = a
        out[pos + a.nbytes:pos + _pad(a.nbytes)] = 0
        pos += _pad(a.nbytes)
    return out


def deserialize_block(payload) -> Tuple[T.Schema, List[HostColumn]]:
    """The schema and columns of one block (any bytes-like object); lanes
    are numpy views of the payload, writable when it is."""
    payload = memoryview(payload).cast("B")
    if payload[:4] != _MAGIC:
        raise ValueError("bad shuffle block magic")
    pos = 4
    version, n_rows, n_fields = struct.unpack_from("<HqH", payload, pos)
    pos += struct.calcsize("<HqH")
    if version != _VERSION:
        raise ValueError(f"shuffle block version {version}, expected "
                         f"{_VERSION}")
    (codec_len,) = struct.unpack_from("<H", payload, pos)
    pos += 2
    codec = get_codec(bytes(payload[pos:pos + codec_len]).decode())
    pos += codec_len
    csize, usize = struct.unpack_from("<qq", payload, pos)
    pos += 16
    at_head = [pos]

    def field_entry():
        """One header entry and, for a struct, its fields' entries:
        (field, kind, dict_sorted, max_bytes, children)."""
        p = at_head[0]
        nl, tl, nullable, kind, dict_sorted, max_bytes = struct.unpack_from(
            "<HHBBBq", payload, p)
        p += struct.calcsize("<HHBBBq")
        name = bytes(payload[p:p + nl]).decode()
        dtype = T.from_name(bytes(payload[p + nl:p + nl + tl]).decode())
        at_head[0] = p + nl + tl
        kids = [field_entry() for _ in range(max_bytes)] \
            if kind == _STRUCT else []
        if kids:
            dtype = T.StructType([k[0] for k in kids])
        return (T.StructField(name, dtype, bool(nullable)), kind,
                bool(dict_sorted), max_bytes, kids)

    entries = [field_entry() for _ in range(n_fields)]
    pos = at_head[0]
    (n_lanes,) = struct.unpack_from("<H", payload, pos)
    pos += 2
    sizes = struct.unpack_from(f"<{n_lanes}q", payload, pos)
    pos = _pad(pos + 8 * n_lanes)
    body = codec.decompress(payload[pos:pos + csize], usize)
    at = [0]

    def lane(dtype) -> np.ndarray:
        nb = sizes[len(at) - 1]
        start = at[-1]
        at.append(start + _pad(nb))
        return np.frombuffer(body, dtype, nb // np.dtype(dtype).itemsize,
                             start)

    def column(entry) -> HostColumn:
        f, kind, dict_sorted, max_bytes, kids = entry
        validity = lane(np.bool_)
        if kind == _STRUCT:
            return HostColumn(f.data_type, validity,
                              children=[column(k) for k in kids])
        if kind == _ARRAY:
            lengths = lane(np.int32)
            shape = (len(validity), max_bytes)
            return HostColumn(f.data_type, validity, lengths=lengths,
                              data=lane(f.data_type.np_dtype).reshape(shape),
                              elem_validity=lane(np.bool_).reshape(shape))
        if kind == _FLAT:
            return HostColumn(f.data_type, validity, offsets=lane(np.int32),
                              data=lane(np.uint8), max_bytes=max_bytes)
        if kind == _DICT:
            codes = lane(np.int32)
            offsets, raw = lane(np.int64), lane(np.uint8).tobytes()
            dictionary = np.array(
                [raw[a:b].decode("utf-8") for a, b in
                 zip(offsets[:-1], offsets[1:])], dtype=object)
            return HostColumn(f.data_type, validity, codes=codes,
                              dictionary=dictionary, dict_sorted=dict_sorted)
        return HostColumn(f.data_type, validity,
                          data=lane(f.data_type.np_dtype))

    cols = [column(e) for e in entries]
    if any(c.num_rows != n_rows for c in cols):
        raise ValueError(f"shuffle block of {n_rows} rows holds a column "
                         "of another length")
    return T.Schema([e[0] for e in entries]), cols
