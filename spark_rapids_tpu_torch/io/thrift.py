"""The thrift compact protocol, as parquet's footer and page headers use
it — port of ``_Thrift`` (``spark_rapids_tpu/io/parquet_device.py:51``)
and ``_ThriftWriter`` (``spark_rapids_tpu/io/parquet_encode.py:80``).

:class:`Thrift` reads a struct into ``{field id: value}``, nested
structs as dicts and lists as lists; it walks every type of the
protocol, so fields the reader never looks at (new footers carry size
statistics, column and offset index offsets, ...) are skipped by their
structure. :class:`ThriftWriter` writes just what parquet's metadata
needs.
"""

from __future__ import annotations

import struct
from typing import Dict

T_BOOL_TRUE = 1
T_BOOL_FALSE = 2
T_BYTE = 3
T_I16 = 4
T_I32 = 5
T_I64 = 6
T_DOUBLE = 7
T_BINARY = 8
T_LIST = 9
T_SET = 10
T_MAP = 11
T_STRUCT = 12


class ThriftError(ValueError):
    """Malformed compact-protocol bytes."""


class Thrift:
    """Compact-protocol reader over ``buf`` (bytes, or any buffer of
    bytes such as a uint8 numpy array) from ``pos``."""

    def __init__(self, buf, pos: int = 0):
        self.buf = buf if isinstance(buf, bytes) else memoryview(buf)
        self.pos = pos

    def _byte(self) -> int:
        if self.pos >= len(self.buf):
            raise ThriftError(f"thrift data ends at byte {self.pos}")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self._byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 70:
                raise ThriftError(f"varint too long at byte {self.pos}")

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def read_struct(self) -> Dict[int, object]:
        """Field id -> value, up to the struct's stop byte."""
        out: Dict[int, object] = {}
        field_id = 0
        while True:
            header = self._byte()
            if header == 0:
                return out
            delta = header >> 4
            ftype = header & 0x0F
            field_id = field_id + delta if delta else self.zigzag()
            out[field_id] = self._read_value(ftype)

    def _read_value(self, ftype: int, in_list: bool = False):
        if ftype in (T_BOOL_TRUE, T_BOOL_FALSE):
            # a field's bool is its type nibble; a list element's is a byte
            return self._byte() == 1 if in_list else ftype == T_BOOL_TRUE
        if ftype == T_BYTE:
            return self._byte()
        if ftype in (T_I16, T_I32, T_I64):
            return self.zigzag()
        if ftype == T_DOUBLE:
            if self.pos + 8 > len(self.buf):
                raise ThriftError(f"thrift data ends at byte {self.pos}")
            v = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if ftype == T_BINARY:
            n = self.varint()
            if self.pos + n > len(self.buf):
                raise ThriftError(f"binary of {n} bytes runs past the end")
            v = bytes(self.buf[self.pos: self.pos + n])
            self.pos += n
            return v
        if ftype in (T_LIST, T_SET):
            head = self._byte()
            size, etype = head >> 4, head & 0x0F
            if size == 15:
                size = self.varint()
            return [self._read_value(etype, True) for _ in range(size)]
        if ftype == T_MAP:
            size = self.varint()
            if not size:
                return {}
            types = self._byte()
            return {self._read_value(types >> 4, True):
                    self._read_value(types & 0x0F, True)
                    for _ in range(size)}
        if ftype == T_STRUCT:
            return self.read_struct()
        raise ThriftError(f"thrift compact type {ftype} at byte {self.pos}")


def varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def zigzag(v: int) -> bytes:
    return varint((v << 1) ^ (v >> 63))


class ThriftWriter:
    """Just enough of the compact protocol's writing side for parquet
    metadata. ``last_fid`` is the stack of the open structs' last field
    ids (deltas are per struct)."""

    def __init__(self):
        self.buf = bytearray()
        self.last_fid = [0]

    def _field(self, fid: int, ftype: int):
        delta = fid - self.last_fid[-1]
        if 1 <= delta <= 15:
            self.buf.append((delta << 4) | ftype)
        else:
            self.buf.append(ftype)
            self.buf += zigzag(fid)
        self.last_fid[-1] = fid

    def i32(self, fid: int, v: int):
        self._field(fid, T_I32)
        self.buf += zigzag(v)

    def i64(self, fid: int, v: int):
        self._field(fid, T_I64)
        self.buf += zigzag(v)

    def string(self, fid: int, s: str):
        self._field(fid, T_BINARY)
        raw = s.encode("utf-8")
        self.buf += varint(len(raw))
        self.buf += raw

    def struct_begin(self, fid: int):
        self._field(fid, T_STRUCT)
        self.last_fid.append(0)

    def struct_end(self):
        self.buf.append(0x00)
        self.last_fid.pop()

    def list_begin(self, fid: int, elem_type: int, size: int):
        self._field(fid, T_LIST)
        if size < 15:
            self.buf.append((size << 4) | elem_type)
        else:
            self.buf.append(0xF0 | elem_type)
            self.buf += varint(size)

    def elem_struct_begin(self):
        """A struct element of a list: no field header, a fresh frame."""
        self.last_fid.append(0)

    def i32_elem(self, v: int):
        self.buf += zigzag(v)

    def binary_elem(self, raw: bytes):
        self.buf += varint(len(raw))
        self.buf += raw

    def done(self) -> bytes:
        self.buf.append(0x00)   # terminate the top-level struct
        return bytes(self.buf)
