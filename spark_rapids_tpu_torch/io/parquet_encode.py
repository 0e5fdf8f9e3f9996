"""The parquet writer — port of ``spark_rapids_tpu/io/parquet_encode.py``
(``write_device_batch``, ``:353``).

The work divides as in the reference, the scan's split in reverse:

* DEVICE, data-sized, in torch (the reference's ``_compact_columns``):
  per column, the definition levels in live-row order and the values
  (dictionary codes for a dictionary string) dense in non-null order,
  so page buffers leave the device already in encoding order.
* HOST, metadata-sized, in numpy: RLE/bit-pack the definition levels and
  dictionary codes, PLAIN-encode values and string dictionaries, frame
  pages, write thrift page headers and the ``FileMetaData`` footer.

Scope, the reference's: flat schemas; INT32/INT64/FLOAT/DOUBLE/BOOLEAN/
DATE/TIMESTAMP values PLAIN-encoded; dictionary strings as a PLAIN
dictionary page and an RLE_DICTIONARY data page; OPTIONAL columns with
RLE definition levels; one row group and one data page per column; pages
UNCOMPRESSED, SNAPPY (:mod:`.snappy`: the C++ routine for a batch on
the card) or GZIP (``zlib``, for the writer's ``compression`` option).
Anything else raises :class:`NotDeviceEncodable` before the
file is touched. An UNCOMPRESSED file is byte for byte the reference's
for the same batch.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import types as T
from ..data.batch import ColumnarBatch
from ..data.column import DeviceColumn
from . import snappy
from .thrift import (T_BINARY, T_I32, T_STRUCT, ThriftWriter, varint)


class NotDeviceEncodable(Exception):
    """A column, type or codec outside the writer's scope."""


_PQ_BOOLEAN, _PQ_INT32, _PQ_INT64, _PQ_FLOAT, _PQ_DOUBLE, _PQ_BYTE_ARRAY = \
    0, 1, 2, 4, 5, 6
_ENC_PLAIN, _ENC_RLE, _ENC_RLE_DICTIONARY = 0, 3, 8
_CODEC_UNCOMPRESSED, _CODEC_SNAPPY, _CODEC_GZIP = 0, 1, 2

#: type name -> (parquet physical type, converted type or None)
_PHYS: Dict[str, Tuple[int, Optional[int]]] = {
    "int": (_PQ_INT32, None),
    "bigint": (_PQ_INT64, None),
    "float": (_PQ_FLOAT, None),
    "double": (_PQ_DOUBLE, None),
    "boolean": (_PQ_BOOLEAN, None),
    "date": (_PQ_INT32, 6),            # DATE
    "timestamp": (_PQ_INT64, 10),      # TIMESTAMP_MICROS
    "smallint": (_PQ_INT32, 16),       # INT_16
    "tinyint": (_PQ_INT32, 15),        # INT_8
    "string": (_PQ_BYTE_ARRAY, 0),     # UTF8
}

#: PLAIN value width of each fixed-width physical type
_PHYS_NP: Dict[int, np.dtype] = {
    _PQ_INT32: np.dtype(np.int32),
    _PQ_INT64: np.dtype(np.int64),
    _PQ_FLOAT: np.dtype(np.float32),
    _PQ_DOUBLE: np.dtype(np.float64),
}

#: the footer's ``created_by``, the reference writer's
CREATED_BY = "spark-rapids-tpu device encoder"


def encoded_value_dtype(dtype: T.DataType) -> Optional[np.dtype]:
    """The numpy dtype of a type's PLAIN value stream: the declared
    physical width (tinyint and smallint lanes are int8/int16 on the
    device but INT32 in the file)."""
    if dtype.name not in _PHYS:
        return None
    return _PHYS_NP.get(_PHYS[dtype.name][0])


# -- device compaction ----------------------------------------------------------


def compact_columns(batch: ColumnarBatch):
    """Per column: (definition levels in live-row order, values dense in
    non-null order (codes for a dictionary string), non-null count), all
    on the device; and the live row count. Dead and null rows scatter to
    a spare slot past the end, which is dropped."""
    live = batch.row_mask()
    cap = batch.capacity
    spare = torch.full((cap,), cap, dtype=torch.int64, device=batch.device)
    live_pos = torch.where(live, torch.cumsum(live, 0) - 1, spare)
    outs = []
    for c in batch.columns:
        valid = c.validity & live
        defl = torch.zeros(cap + 1, dtype=torch.bool, device=batch.device)
        defl.scatter_(0, live_pos, c.validity)
        src = c.lane
        vals = torch.zeros(cap + 1, dtype=src.dtype, device=batch.device)
        vals.scatter_(0, torch.where(valid, torch.cumsum(valid, 0) - 1,
                                     spare), src)
        outs.append((defl[:cap], vals[:cap], valid.sum()))
    return outs, batch.n_rows


# -- host RLE / bit-pack framing --------------------------------------------------


def _rle_runs(values: np.ndarray, breaks: np.ndarray
              ) -> List[Tuple[int, int]]:
    """(run length, value) pairs of an int array whose runs start after
    ``breaks``."""
    n = len(values)
    if n == 0:
        return []
    starts = np.concatenate(([0], breaks))
    ends = np.concatenate((breaks, [n]))
    return [(int(e - s), int(values[s])) for s, e in zip(starts, ends)]


def _rle_encode(values: np.ndarray, bit_width: int) -> bytes:
    """The RLE/bit-pack hybrid: RLE runs, or one bit-packed run when runs
    are short (more than a quarter of the values). The runs are counted
    before they are listed, so a stream that bit-packs lists none."""
    byte_w = (bit_width + 7) // 8
    breaks = np.nonzero(values[1:] != values[:-1])[0] + 1
    n_runs = len(breaks) + 1 if len(values) else 0
    if bit_width and n_runs and n_runs > max(4, len(values) // 4):
        return _bitpack_encode(values, bit_width)
    out = bytearray()
    for count, value in _rle_runs(values, breaks):
        out += varint(count << 1)
        out += int(value).to_bytes(byte_w, "little") if byte_w else b""
    return bytes(out)


def _bitpack_encode(values: np.ndarray, bit_width: int) -> bytes:
    n = len(values)
    groups = (n + 7) // 8
    padded = np.zeros(groups * 8, np.uint64)
    padded[:n] = values.astype(np.uint64)
    # little-endian bit order within each group
    bits = ((padded[:, None] >> np.arange(bit_width, dtype=np.uint64))
            & 1).astype(np.uint8)
    packed = np.packbits(bits.reshape(-1), bitorder="little")
    return varint((groups << 1) | 1) + packed.tobytes()


def _length_prefixed(payload: bytes) -> bytes:
    return struct.pack("<I", len(payload)) + payload


def _compress(payload: bytes, codec: int, device) -> bytes:
    if codec == _CODEC_UNCOMPRESSED:
        return payload
    if codec == _CODEC_GZIP:
        c = zlib.compressobj(6, zlib.DEFLATED, 31)
        return c.compress(payload) + c.flush()
    return snappy.compress(payload, device)


# -- page assembly ----------------------------------------------------------------


def _page_header(page_type: int, uncomp: int, comp: int, num_values: int,
                 encoding: int) -> bytes:
    w = ThriftWriter()
    w.i32(1, page_type)
    w.i32(2, uncomp)
    w.i32(3, comp)
    if page_type == 0:        # data page v1
        w.struct_begin(5)
        w.i32(1, num_values)
        w.i32(2, encoding)
        w.i32(3, _ENC_RLE)    # definition levels
        w.i32(4, _ENC_RLE)    # repetition levels (none written: flat)
        w.struct_end()
    else:                     # dictionary page
        w.struct_begin(7)
        w.i32(1, num_values)
        w.i32(2, _ENC_PLAIN)
        w.struct_end()
    return w.done()


def _plain_values(vals: np.ndarray, dtype: T.DataType, n_valid: int) -> bytes:
    v = vals[:n_valid]
    if dtype is T.BOOLEAN:
        return np.packbits(v.astype(np.uint8), bitorder="little").tobytes()
    phys_np = encoded_value_dtype(dtype)
    if phys_np is not None and v.dtype != phys_np:
        v = v.astype(phys_np)   # widen tinyint/smallint to INT32
    return np.ascontiguousarray(v).tobytes()


def _string_dict_plain(col: DeviceColumn) -> Tuple[bytes, int]:
    """The dictionary's entries PLAIN-encoded (4-byte little-endian
    length, then the bytes), and their number."""
    raw = [str(s).encode("utf-8") for s in col.dictionary]
    return b"".join(struct.pack("<I", len(b)) + b for b in raw), len(raw)


class _ColumnPlan:
    __slots__ = ("name", "dtype", "phys", "conv", "nullable", "is_dict")

    def __init__(self, field: T.StructField, col: DeviceColumn):
        self.name = field.name
        self.dtype = field.data_type
        if self.dtype.name not in _PHYS:
            raise NotDeviceEncodable(f"type {self.dtype} not encodable")
        self.phys, self.conv = _PHYS[self.dtype.name]
        self.nullable = field.nullable
        self.is_dict = col.codes is not None
        if self.dtype is T.STRING and not self.is_dict:
            raise NotDeviceEncodable("flat (non-dictionary) string column")


def write_device_batch(batch: ColumnarBatch, path: str,
                       compression: Optional[str] = "snappy") -> int:
    """Write one batch as a one-row-group parquet file at ``path``;
    returns the bytes written. Raises :class:`NotDeviceEncodable` before
    the file is touched when a column or the codec is out of scope."""
    schema = batch.schema
    plans = [_ColumnPlan(f, c) for f, c in zip(schema, batch.columns)]
    if compression in (None, "none", "uncompressed"):
        codec = _CODEC_UNCOMPRESSED
    elif compression == "snappy":
        codec = _CODEC_SNAPPY
    elif compression == "gzip":
        codec = _CODEC_GZIP
    else:
        raise NotDeviceEncodable(f"codec {compression!r} not encodable")
    dev = batch.device

    compacted, n_rows_dev = compact_columns(batch)
    n_rows = int(n_rows_dev)

    chunks: List[bytes] = []
    metas: List[Dict] = []
    offset = 4  # after the magic
    for plan, col, (defl_dev, vals_dev, nv_dev) in zip(
            plans, batch.columns, compacted):
        defl = defl_dev[:n_rows].cpu().numpy()
        n_valid = int(nv_dev)
        vals = vals_dev[:n_valid].cpu().numpy()
        piece = bytearray()
        dict_off = None
        uncomp_total = 0
        encodings = [_ENC_RLE]
        if plan.is_dict:
            dict_plain, dict_n = _string_dict_plain(col)
            payload = _compress(dict_plain, codec, dev)
            dict_off = offset + len(piece)
            hdr = _page_header(2, len(dict_plain), len(payload), dict_n,
                               _ENC_PLAIN)
            piece += hdr
            piece += payload
            uncomp_total += len(hdr) + len(dict_plain)
            bw = max(int(dict_n - 1).bit_length(), 1)
            body = bytes([bw]) + _rle_encode(vals, bw)
            enc = _ENC_RLE_DICTIONARY
            encodings += [_ENC_PLAIN, _ENC_RLE_DICTIONARY]
        else:
            body = _plain_values(vals, plan.dtype, n_valid)
            enc = _ENC_PLAIN
            encodings += [_ENC_PLAIN]
        levels = _length_prefixed(_rle_encode(defl.astype(np.int64), 1)) \
            if plan.nullable else b""
        data_plain = levels + body
        payload = _compress(data_plain, codec, dev)
        data_off = offset + len(piece)
        hdr = _page_header(0, len(data_plain), len(payload), n_rows, enc)
        piece += hdr
        piece += payload
        uncomp_total += len(hdr) + len(data_plain)
        metas.append(dict(plan=plan, dict_off=dict_off, data_off=data_off,
                          encodings=encodings, n_values=n_rows,
                          total=len(piece), uncomp=uncomp_total,
                          start=offset))
        chunks.append(bytes(piece))
        offset += len(piece)

    footer = _file_metadata(plans, metas, n_rows, codec)
    with open(path, "wb") as f:
        f.write(b"PAR1")
        for ch in chunks:
            f.write(ch)
        f.write(footer)
        f.write(struct.pack("<I", len(footer)))
        f.write(b"PAR1")
    return 8 + sum(len(c) for c in chunks) + len(footer) + 4


def _file_metadata(plans: List[_ColumnPlan], metas: List[Dict], n_rows: int,
                   codec: int) -> bytes:
    w = ThriftWriter()
    w.i32(1, 1)                                   # version
    w.list_begin(2, T_STRUCT, len(plans) + 1)     # schema elements
    w.elem_struct_begin()                         # the root
    w.string(4, "schema")
    w.i32(5, len(plans))
    w.struct_end()
    for p in plans:
        w.elem_struct_begin()
        w.i32(1, p.phys)
        w.i32(3, 1 if p.nullable else 0)          # OPTIONAL / REQUIRED
        w.string(4, p.name)
        if p.conv is not None:
            w.i32(6, p.conv)
        w.struct_end()
    w.i64(3, n_rows)
    w.list_begin(4, T_STRUCT, 1)                  # one row group
    w.elem_struct_begin()
    w.list_begin(1, T_STRUCT, len(metas))         # its column chunks
    total = 0
    for m in metas:
        p = m["plan"]
        w.elem_struct_begin()
        w.i64(2, m["start"])                      # file_offset
        w.struct_begin(3)                         # ColumnMetaData
        w.i32(1, p.phys)
        w.list_begin(2, T_I32, len(m["encodings"]))
        for e in m["encodings"]:
            w.i32_elem(e)
        w.list_begin(3, T_BINARY, 1)
        w.binary_elem(p.name.encode())
        w.i32(4, codec)
        w.i64(5, m["n_values"])
        w.i64(6, m["uncomp"])                     # total_uncompressed_size
        w.i64(7, m["total"])                      # total_compressed_size
        w.i64(9, m["data_off"])
        if m["dict_off"] is not None:
            w.i64(11, m["dict_off"])
        w.struct_end()
        w.struct_end()
        total += m["total"]
    w.i64(2, total)
    w.i64(3, n_rows)
    w.struct_end()
    w.string(6, CREATED_BY)
    return w.done()
