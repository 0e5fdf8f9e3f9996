"""The ORC scan: host stream walk, device run expansion — port of
``spark_rapids_tpu/io/orc_device.py`` (``_proto_fields``, ``read_tail``,
``parse_rlev2``, ``parse_byte_rle_bits``, ``decode_stripe``,
``device_decodable``, ``TpuOrcScanExec``).

The split is the parquet scan's (:mod:`.parquet_device`):

* HOST, metadata-sized (:func:`read_stripe_host`): the protobuf tail and
  stripe footer, the block decompression (ZLIB through ``zlib``, SNAPPY
  through :mod:`.snappy`), and the RLEv2 run HEADERS sliced into a run
  table of four lanes (kind, count, a, b) per run: a SHORT_REPEAT or a
  fixed-delta DELTA run is linear (``a + b * i``), a DIRECT run of at
  most 56 bits points into the uploaded stream (bit offset ``a``, width
  ``b``), and a PATCHED_BASE run, a DELTA run with varying deltas or a
  wider DIRECT run is unpacked on the host into a value block (``a`` its
  start). PRESENT streams and the BOOLEAN and BYTE data streams are
  byte-RLE, expanded on the host (PRESENT into packed bits the device
  unpacks). Every stream the device reads lands in one staging buffer,
  every table in a second.
* DEVICE, data-sized, in torch (:func:`decode_stripe_device`): each
  value finds its run by ``searchsorted``, a linear run computes it, a
  bit-packed one reads 8 big-endian bytes around its bit offset and
  shifts, masks and un-zigzags it; the PRESENT bits become the validity,
  whose cumsum gives each row its slot among the non-null values; a
  DICTIONARY_V2 string's codes gather the ranks of its host-sorted
  dictionary, a DIRECT_V2 string's lengths become the offsets of a flat
  column over its uploaded bytes.

The same functions on CPU tensors are the host stripe decoder: the
per-stripe fallback (site ``io.orc.stripe``) and the host scan
(:mod:`.files`) decode with it. Out of scope, raising
``NotImplementedError`` that names file and reason: ZSTD, LZ4 and LZO
compression, nested, decimal, timestamp and binary columns, and the
RLEv1 (DIRECT / DICTIONARY) column encodings.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import types as T
from ..data.batch import ColumnarBatch, move_batch
from ..data.column import (DeviceColumn, bucket_byte_capacity,
                           bucket_capacity, dictionary_column,
                           string_max_bytes)
from ..exec.execs import ExecContext, TorchExec
from ..exec.pipeline import unit_partitions
from . import snappy
from .parquet_device import _TablePack, _aligned

MAGIC = b"ORC"

#: type kinds (orc_proto.proto ``Type.Kind``)
_K_BOOL, _K_BYTE, _K_SHORT, _K_INT, _K_LONG = 0, 1, 2, 3, 4
_K_FLOAT, _K_DOUBLE, _K_STRING, _K_BINARY, _K_TIMESTAMP = 5, 6, 7, 8, 9
_K_LIST, _K_MAP, _K_STRUCT, _K_UNION, _K_DECIMAL = 10, 11, 12, 13, 14
_K_DATE, _K_VARCHAR, _K_CHAR = 15, 16, 17
#: stream kinds
_S_PRESENT, _S_DATA, _S_LENGTH, _S_DICT = 0, 1, 2, 3
#: column encodings
_E_DIRECT, _E_DICT, _E_DIRECT_V2, _E_DICT_V2 = 0, 1, 2, 3
#: compression kinds
_CODEC_NAMES = {0: "NONE", 1: "ZLIB", 2: "SNAPPY", 3: "LZO", 4: "LZ4",
                5: "ZSTD"}

_INT_KINDS = {_K_SHORT: T.SHORT, _K_INT: T.INT, _K_LONG: T.LONG,
              _K_DATE: T.DATE}
_TYPES = {**_INT_KINDS, _K_BOOL: T.BOOLEAN, _K_BYTE: T.BYTE,
          _K_FLOAT: T.FLOAT, _K_DOUBLE: T.DOUBLE, _K_STRING: T.STRING,
          _K_VARCHAR: T.STRING, _K_CHAR: T.STRING}
#: kinds the device decoder takes (the reference's ``_SUPPORTED_KINDS``);
#: BOOLEAN and BYTE decode on the host path only, as there
DEVICE_KINDS = frozenset(set(_INT_KINDS) | {_K_FLOAT, _K_DOUBLE, _K_STRING})

#: RLEv2 5-bit width code -> bit width (ORC's "closest fixed bits")
_WIDTH_TABLE = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
                17, 18, 19, 20, 21, 22, 23, 24, 26, 28, 30, 32, 40, 48,
                56, 64]
#: DIRECT runs up to this width stay packed for the device
_DEVICE_WIDTH = 56
#: run-table kinds
_LINEAR, _VALUES, _PACKED = 0, 1, 2

#: encodings met while parsing (the tests check each was exercised)
decode_stats = {"short_repeat": 0, "direct": 0, "delta": 0,
                "patched_base": 0}
_STATS_LOCK = threading.Lock()


class NotOrcDecodable(ValueError):
    """Malformed or truncated ORC input."""


def _refuse(path: str, reason: str) -> NotImplementedError:
    return NotImplementedError(f"{path}: {reason}")


# -- protobuf --------------------------------------------------------------------


def _varint(b, i: int) -> Tuple[int, int]:
    v = s = 0
    while True:
        if i >= len(b):
            raise NotOrcDecodable("varint runs past its buffer")
        x = b[i]
        i += 1
        v |= (x & 0x7F) << s
        s += 7
        if not x & 0x80:
            return v, i


def proto_fields(b: bytes) -> List[Tuple[int, int, object]]:
    """(field, wire type, value) of every field of one protobuf message:
    an int for varints and fixed widths, bytes for length-delimited."""
    out, i, n = [], 0, len(b)
    while i < n:
        tag, i = _varint(b, i)
        f, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _varint(b, i)
        elif wt == 2:
            ln, i = _varint(b, i)
            if i + ln > n:
                raise NotOrcDecodable("protobuf field runs past its message")
            v = bytes(b[i:i + ln])
            i += ln
        elif wt in (1, 5):
            w = 8 if wt == 1 else 4
            v = int.from_bytes(b[i:i + w], "little")
            i += w
        else:
            raise NotOrcDecodable(f"protobuf wire type {wt}")
        out.append((f, wt, v))
    return out


def _fields(b: bytes) -> Dict[int, object]:
    """The last value of each field of a message."""
    return {f: v for f, _, v in proto_fields(b)}


def _repeated_ints(fields, number: int) -> List[int]:
    """A repeated varint field, packed or not."""
    out = []
    for f, wt, v in fields:
        if f != number:
            continue
        if wt == 2:
            i = 0
            while i < len(v):
                x, i = _varint(v, i)
                out.append(x)
        else:
            out.append(v)
    return out


# -- the file tail -----------------------------------------------------------------


@dataclasses.dataclass
class StripeInfo:
    offset: int
    index_length: int
    data_length: int
    footer_length: int
    n_rows: int


@dataclasses.dataclass
class OrcTail:
    path: str
    compression: int
    block_size: int
    stripes: List[StripeInfo]
    #: type kind of every column id (0 is the root struct)
    kinds: List[int]
    #: root field names and their column ids
    names: List[str]
    column_ids: List[int]
    n_rows: int

    @property
    def codec(self) -> str:
        return _CODEC_NAMES.get(self.compression, str(self.compression))


def decompress(tail: OrcTail, raw: bytes, device=None) -> bytes:
    """Undo ORC's block framing (a 3-byte little-endian header a block:
    ``length << 1 | original``) and each block's codec. ``device`` picks
    the snappy routine (the C++ one for a scan on the card)."""
    if tail.compression == 0:
        return bytes(raw)
    device = device or "cpu"
    if tail.compression not in (1, 2):
        raise _refuse(tail.path, f"ORC compression {tail.codec} is not "
                      "supported (NONE, ZLIB and SNAPPY are)")
    out, i, n = [], 0, len(raw)
    while i + 3 <= n:
        hdr = raw[i] | (raw[i + 1] << 8) | (raw[i + 2] << 16)
        i += 3
        ln, original = hdr >> 1, hdr & 1
        if i + ln > n:
            raise NotOrcDecodable("compressed block runs past its stream")
        chunk = raw[i:i + ln]
        i += ln
        if original:
            out.append(bytes(chunk))
        elif tail.compression == 1:
            try:
                out.append(zlib.decompress(bytes(chunk), wbits=-15))
            except zlib.error as e:
                raise NotOrcDecodable(f"zlib block: {e}") from e
        else:
            src = np.frombuffer(bytes(chunk), np.uint8)
            size, _ = _varint(bytes(chunk[:10]), 0)
            dst = np.empty(max(size, 1), np.uint8)
            try:
                snappy.decompress_pages(
                    src, np.array([[0, len(src), 0, size]], np.int64), dst,
                    device)
            except (snappy.SnappyError, RuntimeError) as e:
                raise NotOrcDecodable(f"snappy block: {e}") from e
            out.append(dst[:size].tobytes())
    if i != n:
        raise NotOrcDecodable("truncated compression block header")
    return b"".join(out)


def read_tail(path: str) -> OrcTail:
    """The postscript, footer and types of an ORC file."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if size < 4:
            raise NotOrcDecodable(f"{path}: not an ORC file")
        f.seek(max(0, size - (1 << 16)))
        tail = f.read()
        ps_len = tail[-1]
        ps = _fields(tail[-1 - ps_len:-1])
        if ps.get(8000) != MAGIC:
            raise NotOrcDecodable(f"{path}: not an ORC file (no magic)")
        footer_len = ps.get(1, 0)
        need = 1 + ps_len + footer_len
        if need > len(tail):
            f.seek(size - need)
            tail = f.read()
        foot_raw = tail[-need:-1 - ps_len]
    t = OrcTail(path, ps.get(2, 0), ps.get(3, 1 << 18), [], [], [], [], 0)
    foot = proto_fields(decompress(t, foot_raw))
    types = []
    for fl, _, v in foot:
        if fl == 3:
            sv = _fields(v)
            t.stripes.append(StripeInfo(sv.get(1, 0), sv.get(2, 0),
                                        sv.get(3, 0), sv.get(4, 0),
                                        sv.get(5, 0)))
        elif fl == 4:
            types.append(proto_fields(v))
        elif fl == 6:
            t.n_rows = v
    t.kinds = [next((c for a, _, c in tf if a == 1), 0) for tf in types]
    if types:
        t.column_ids = _repeated_ints(types[0], 2)
        t.names = [c.decode() for a, _, c in types[0] if a == 3]
    return t


def schema_from_tail(tail: OrcTail) -> T.Schema:
    """The file's schema: its root struct's fields (the reference's
    ``pyarrow.orc`` schema through ``schema_from_arrow``)."""
    if not tail.kinds or tail.kinds[0] != _K_STRUCT:
        raise _refuse(tail.path, "the root type is not a struct")
    fields = []
    for name, cid in zip(tail.names, tail.column_ids):
        dt = _TYPES.get(tail.kinds[cid])
        if dt is None:
            raise _refuse(tail.path, f"column {name!r}: ORC type kind "
                          f"{tail.kinds[cid]} is not supported")
        fields.append(T.StructField(name, dt, True))
    return T.Schema(fields)


def device_decodable(tail: OrcTail, schema: T.Schema) -> Optional[str]:
    """None when the device decoder takes every column of ``schema`` in
    this file; else the reason it does not (the plan-time gate)."""
    if tail.compression not in (0, 1, 2):
        return f"ORC compression {tail.codec}"
    ids = dict(zip(tail.names, tail.column_ids))
    for f in schema:
        cid = ids.get(f.name)
        if cid is None:
            return f"column {f.name!r} is not in {tail.path}"
        if tail.kinds[cid] not in DEVICE_KINDS:
            return (f"column {f.name!r}: ORC type kind {tail.kinds[cid]} "
                    "decodes on the host")
    return None


# -- RLEv2 and byte-RLE -----------------------------------------------------------


def _unpack_be(b: bytes, i: int, count: int, width: int
               ) -> Tuple[np.ndarray, int]:
    """``count`` big-endian ``width``-bit values at byte ``i`` (uint64),
    and the byte after them."""
    nbytes = (count * width + 7) // 8
    if i + nbytes > len(b):
        raise NotOrcDecodable("packed values run past their stream")
    if count == 0:
        return np.zeros(0, np.uint64), i
    bits = np.unpackbits(np.frombuffer(b, np.uint8, nbytes, i))
    bits = bits[:count * width].reshape(count, width).astype(np.uint64)
    weights = np.uint64(1) << np.arange(width - 1, -1, -1, dtype=np.uint64)
    return (bits * weights).sum(axis=1, dtype=np.uint64), i + nbytes


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _unzigzag(vals: np.ndarray) -> np.ndarray:
    return ((vals >> np.uint64(1)).astype(np.int64)
            ^ -(vals & np.uint64(1)).astype(np.int64))


class Runs:
    """A run table under construction: int64 lanes kind, count, a, b per
    run (see the module doc), and the host-unpacked value blocks."""

    def __init__(self):
        self.rows: List[Tuple[int, int, int, int]] = []
        self.blocks: List[np.ndarray] = []
        self.n_values = 0

    def linear(self, count: int, base: int, delta: int = 0) -> None:
        self.rows.append((_LINEAR, count, base, delta))

    def values(self, vals: np.ndarray) -> None:
        self.rows.append((_VALUES, len(vals), self.n_values, 0))
        self.blocks.append(np.asarray(vals, np.int64))
        self.n_values += len(vals)

    def packed(self, count: int, bit_start: int, width: int) -> None:
        self.rows.append((_PACKED, count, bit_start, width))

    def table(self) -> np.ndarray:
        return np.array(self.rows, np.int64).reshape(-1, 4).T.copy()

    def value_block(self) -> np.ndarray:
        return np.concatenate(self.blocks) if self.blocks \
            else np.zeros(1, np.int64)


def _bump(kind: str) -> None:
    with _STATS_LOCK:
        decode_stats[kind] += 1


def parse_rlev2(b: bytes, signed: bool, expected: int, base: int,
                runs: Optional[Runs] = None) -> Runs:
    """Slice an RLEv2 stream into runs until ``expected`` values; ``base``
    is the stream's byte offset in the staging buffer, which packed runs
    point into."""
    runs = runs if runs is not None else Runs()
    i = produced = 0
    try:
        while produced < expected:
            if i >= len(b):
                raise NotOrcDecodable("RLEv2 stream ends early")
            hdr = b[i]
            enc = hdr >> 6
            if enc == 0:  # SHORT_REPEAT
                width = ((hdr >> 3) & 7) + 1
                count = (hdr & 7) + 3
                v = int.from_bytes(b[i + 1:i + 1 + width], "big")
                i += 1 + width
                runs.linear(count, _zigzag(v) if signed else v)
                _bump("short_repeat")
            elif enc == 1:  # DIRECT
                width = _WIDTH_TABLE[(hdr >> 1) & 0x1F]
                count = ((hdr & 1) << 8 | b[i + 1]) + 1
                i += 2
                nbytes = (count * width + 7) // 8
                if i + nbytes > len(b):
                    raise NotOrcDecodable("DIRECT run runs past its stream")
                if width <= _DEVICE_WIDTH:
                    runs.packed(count, (base + i) * 8,
                                -width if signed else width)
                    i += nbytes
                else:
                    vals, i = _unpack_be(b, i, count, width)
                    runs.values(_unzigzag(vals) if signed
                                else vals.astype(np.int64))
                _bump("direct")
            elif enc == 3:  # DELTA
                wcode = (hdr >> 1) & 0x1F
                width = _WIDTH_TABLE[wcode] if wcode else 0
                count = ((hdr & 1) << 8 | b[i + 1]) + 1
                i += 2
                first, i = _varint(b, i)
                first = _zigzag(first) if signed else first
                delta, i = _varint(b, i)
                delta = _zigzag(delta)
                if width == 0 or count <= 2:
                    runs.linear(count, first, delta)
                else:
                    steps, i = _unpack_be(b, i, count - 2, width)
                    vals = np.empty(count, np.int64)
                    vals[0] = first
                    vals[1] = first + delta
                    sign = 1 if delta >= 0 else -1
                    vals[2:] = vals[1] + np.cumsum(
                        steps.astype(np.int64) * sign)
                    runs.values(vals)
                _bump("delta")
            else:  # PATCHED_BASE
                width = _WIDTH_TABLE[(hdr >> 1) & 0x1F]
                count = ((hdr & 1) << 8 | b[i + 1]) + 1
                third, fourth = b[i + 2], b[i + 3]
                bw = ((third >> 5) & 7) + 1
                pw = _WIDTH_TABLE[third & 0x1F]
                pgw = ((fourth >> 5) & 7) + 1
                pll = fourth & 0x1F
                i += 4
                base_v = int.from_bytes(b[i:i + bw], "big")
                i += bw
                msb = 1 << (bw * 8 - 1)
                if base_v & msb:
                    base_v = -(base_v & (msb - 1))
                vals, i = _unpack_be(b, i, count, width)
                vals = vals.astype(np.int64)
                # patch entries pack at the closest fixed width of gap +
                # patch bits, as ORC's writers do
                pe_width = next(w for w in _WIDTH_TABLE if w >= pgw + pw)
                patches, i = _unpack_be(b, i, pll, pe_width)
                pos = 0
                for pc in patches.tolist():
                    pos += pc >> pw
                    vals[pos] |= (pc & ((1 << pw) - 1)) << width
                runs.values(vals + base_v)
                _bump("patched_base")
            produced += count
    except IndexError as e:
        raise NotOrcDecodable(f"RLEv2 stream truncated: {e!r}") from e
    if produced != expected:
        raise NotOrcDecodable(f"RLEv2 stream holds {produced} values, "
                              f"{expected} expected")
    return runs


def parse_byte_rle(b: bytes, n: int) -> np.ndarray:
    """The first ``n`` bytes a byte-RLE stream decodes to (uint8)."""
    out = np.empty(n, np.uint8)
    i = pos = 0
    try:
        while pos < n:
            ctrl = b[i]
            if ctrl < 128:   # a run of ctrl + 3 copies
                k = min(ctrl + 3, n - pos)
                out[pos:pos + k] = b[i + 1]
                i += 2
            else:            # 256 - ctrl literals
                k = min(256 - ctrl, n - pos)
                if i + 1 + k > len(b):
                    raise NotOrcDecodable("byte-RLE literals run past "
                                          "their stream")
                out[pos:pos + k] = np.frombuffer(b, np.uint8, k, i + 1)
                i += 1 + 256 - ctrl
            pos += k
    except IndexError as e:
        raise NotOrcDecodable("byte-RLE stream ends early") from e
    return out


def parse_bits(b: bytes, n: int) -> np.ndarray:
    """``n`` MSB-first bits of a byte-RLE bit stream, packed (uint8)."""
    return parse_byte_rle(b, (n + 7) // 8)


# -- host phase ---------------------------------------------------------------


@dataclasses.dataclass
class ColumnPlan:
    """What the device decode needs of one column of a stripe."""
    name: str
    dtype: T.DataType
    #: 'int', 'float', 'bool', 'byte', 'dict' or 'direct'
    shape: str
    n_valid: int
    #: staging handles (offset, bytes)
    present: Optional[Tuple[int, int]] = None
    data: Optional[Tuple[int, int]] = None
    #: table-pack handles
    runs: Optional[tuple] = None
    values: Optional[tuple] = None
    rank: Optional[tuple] = None
    lengths: Optional[tuple] = None
    #: sorted dictionary entries (DICTIONARY_V2)
    dictionary: Optional[np.ndarray] = None
    longest: int = 0


@dataclasses.dataclass
class HostStripe:
    """A stripe after the host phase: the streams the device reads in one
    staging buffer, the run tables in one int64 array, and the plans."""
    path: str
    stripe: int
    schema: T.Schema
    n_rows: int
    staging: torch.Tensor
    tables: torch.Tensor
    plans: List[ColumnPlan]
    read_bytes: int
    decompressed_bytes: int


SCAN = "OrcScanExec"


def _no_timer(name: str, host: bool = False):
    return contextlib.nullcontext()


def _lengths(b: bytes, n: int) -> np.ndarray:
    """``n`` unsigned RLEv2 lengths expanded on the host."""
    runs = parse_rlev2(b, False, n, 0)
    return _expand_host(runs, b, n)


def _expand_host(runs: Runs, stream: bytes, n: int) -> np.ndarray:
    """A run table over ``stream`` (its packed runs at base 0) expanded in
    numpy (the dictionary lengths, which the host needs itself)."""
    out = np.empty(n, np.int64)
    blocks = runs.value_block()
    pos = 0
    for kind, count, a, b in runs.rows:
        if kind == _LINEAR:
            out[pos:pos + count] = a + b * np.arange(count, dtype=np.int64)
        elif kind == _VALUES:
            out[pos:pos + count] = blocks[a:a + count]
        else:
            vals, _ = _unpack_be(stream, a // 8, count, abs(b))
            out[pos:pos + count] = _unzigzag(vals) if b < 0 \
                else vals.astype(np.int64)
        pos += count
    return out


def read_stripe_host(tail: OrcTail, stripe: int, schema: T.Schema,
                     device=None, ctx: Optional[ExecContext] = None
                     ) -> HostStripe:
    """The host phase of one stripe: read it, decompress its streams, and
    parse the run headers of every column of ``schema``. ``device``
    (``ctx``'s when given) picks the snappy routine and pins the staging
    buffers for the card. Timers ``OrcScanExec.read``, ``.decompress``
    and ``.parse`` (host clock)."""
    path = tail.path
    if ctx is not None:
        device, timed = ctx.device, ctx.timed
    else:
        device, timed = torch.device(device or "cpu"), _no_timer
    on_card = device.type == "cuda"
    si = tail.stripes[stripe]
    with timed(SCAN + ".read", host=True):
        with open(path, "rb") as f:
            f.seek(si.offset)
            raw = f.read(si.index_length + si.data_length + si.footer_length)
    if len(raw) != si.index_length + si.data_length + si.footer_length:
        raise NotOrcDecodable(f"{path}: stripe {stripe} runs past the file")
    with timed(SCAN + ".decompress", host=True):
        footer = proto_fields(decompress(
            tail, raw[si.index_length + si.data_length:], device))
    streams, encodings = [], []
    for fl, _, v in footer:
        if fl == 1:
            sv = _fields(v)
            streams.append((sv.get(1, 0), sv.get(2, 0), sv.get(3, 0)))
        elif fl == 2:
            encodings.append(_fields(v))
    where: Dict[Tuple[int, int], Tuple[int, int]] = {}
    pos = 0
    for kind, col, ln in streams:
        where[(kind, col)] = (pos, ln)
        pos += ln
    ids = dict(zip(tail.names, tail.column_ids))
    wanted = []
    for field in schema:
        cid = ids.get(field.name)
        if cid is None:
            raise NotOrcDecodable(f"{path}: no column {field.name!r}")
        wanted.append((field, cid))
    decompressed: Dict[Tuple[int, int], bytes] = {}
    with timed(SCAN + ".decompress", host=True):
        for field, cid in wanted:
            for kind in (_S_PRESENT, _S_DATA, _S_LENGTH, _S_DICT):
                loc = where.get((kind, cid))
                if loc is not None:
                    decompressed[(kind, cid)] = decompress(
                        tail, raw[loc[0]:loc[0] + loc[1]], device)
    # staging layout: each stream the device reads, 8-byte aligned
    staged: List[Tuple[int, bytes]] = []
    size = 0

    def stage(payload: bytes) -> Tuple[int, int]:
        nonlocal size
        at = size
        staged.append((at, payload))
        size += _aligned(max(len(payload), 1))
        return at, len(payload)

    pack = _TablePack()
    plans = []
    n_rows = si.n_rows
    with timed(SCAN + ".parse", host=True):
        for field, cid in wanted:
            kind = tail.kinds[cid]
            dtype = _TYPES.get(kind)
            if dtype is None:
                raise _refuse(path, f"column {field.name!r}: ORC type kind "
                              f"{kind} is not supported")
            enc = encodings[cid].get(1, _E_DIRECT) \
                if cid < len(encodings) else _E_DIRECT
            present = decompressed.get((_S_PRESENT, cid))
            data = decompressed.get((_S_DATA, cid), b"")
            plan = ColumnPlan(field.name, dtype, "", n_rows)
            if present is not None:
                bits = parse_bits(present, n_rows)
                plan.n_valid = int(np.unpackbits(bits)[:n_rows].sum())
                plan.present = stage(bits.tobytes())
            nv = plan.n_valid
            if kind in _INT_KINDS or (kind in (_K_STRING, _K_VARCHAR,
                                               _K_CHAR)):
                if enc not in (_E_DIRECT_V2, _E_DICT_V2):
                    raise _refuse(path, f"column {field.name!r}: RLEv1 "
                                  f"encoding {enc} is not supported")
            if kind in _INT_KINDS:
                plan.shape = "int"
                plan.data = stage(data)
                runs = parse_rlev2(data, True, nv, plan.data[0])
                plan.runs = pack.add(runs.table())
                plan.values = pack.add(runs.value_block())
            elif kind in (_K_FLOAT, _K_DOUBLE):
                plan.shape = "float"
                width = 4 if kind == _K_FLOAT else 8
                if len(data) < nv * width:
                    raise NotOrcDecodable(f"{path}: column {field.name!r}: "
                                          "float stream ends early")
                plan.data = stage(data[:nv * width])
            elif kind == _K_BOOL:
                plan.shape = "bool"
                plan.data = stage(parse_bits(data, nv).tobytes())
            elif kind == _K_BYTE:
                plan.shape = "byte"
                plan.data = stage(parse_byte_rle(data, nv).tobytes())
            elif enc == _E_DICT_V2:
                plan.shape = "dict"
                dsize = encodings[cid].get(2, 0)
                lens = _lengths(decompressed.get((_S_LENGTH, cid), b""),
                                dsize)
                blob = decompressed.get((_S_DICT, cid), b"")
                if int(lens.sum()) > len(blob) or (lens < 0).any():
                    raise NotOrcDecodable(f"{path}: column {field.name!r}: "
                                          "dictionary lengths overrun")
                offs = np.concatenate([[0], np.cumsum(lens)])
                entries = [blob[offs[k]:offs[k + 1]] for k in range(dsize)]
                uniq, rank = np.unique(np.array(entries, dtype=object),
                                       return_inverse=True) \
                    if entries else (np.zeros(0, object),
                                     np.zeros(0, np.int64))
                plan.dictionary = np.array(
                    [e.decode("utf-8", "replace") for e in uniq], object)
                plan.data = stage(data)
                runs = parse_rlev2(data, False, nv, plan.data[0])
                plan.runs = pack.add(runs.table())
                plan.values = pack.add(runs.value_block())
                plan.rank = pack.add(np.asarray(rank, np.int64)
                                     if len(rank) else np.zeros(1, np.int64))
            else:  # DIRECT_V2 string: lengths, then the bytes
                plan.shape = "direct"
                lens = _lengths(decompressed.get((_S_LENGTH, cid), b""), nv)
                if int(lens.sum()) > len(data) or (lens < 0).any():
                    raise NotOrcDecodable(f"{path}: column {field.name!r}: "
                                          "string lengths overrun")
                plan.longest = int(lens.max()) if nv else 0
                plan.data = stage(data[:int(lens.sum())])
                plan.lengths = pack.add(lens if nv else
                                        np.zeros(1, np.int64))
            plans.append(plan)
        staging = torch.empty(max(size, 8), dtype=torch.uint8,
                              pin_memory=on_card)
        host = staging.numpy()
        for at, payload in staged:
            host[at:at + len(payload)] = np.frombuffer(payload, np.uint8)
        tables = torch.from_numpy(pack.host())
        if on_card:
            tables = tables.pin_memory()
    return HostStripe(path, stripe, schema, n_rows, staging, tables, plans,
                      len(raw), size)


# -- device phase --------------------------------------------------------------


def expand_runs(table: torch.Tensor, values: torch.Tensor,
                staged: torch.Tensor, n_out: int) -> torch.Tensor:
    """Expand a run table (int64 ``[4, runs]``) into ``n_out`` int64
    values: linear runs compute ``a + b * i``, value runs gather the
    host-unpacked block, packed runs read the 8 big-endian staged bytes
    around bit ``a + i * |b|`` and un-zigzag when ``b < 0``."""
    dev = staged.device
    if table.shape[1] == 0 or n_out == 0:
        return torch.zeros(n_out, dtype=torch.int64, device=dev)
    kinds, counts, a, b = table.unbind(0)
    ends = torch.cumsum(counts, 0)
    i = torch.arange(n_out, dtype=torch.int64, device=dev)
    r = torch.searchsorted(ends, i, right=True).clamp_(max=table.shape[1] - 1)
    within = i - (ends - counts)[r]
    k, ar, br = kinds[r], a[r], b[r]
    linear = ar + br * within
    direct = values[(ar + within).clamp(0, values.shape[0] - 1)]
    width = br.abs()
    bit0 = ar + within * width
    byte0 = bit0 >> 3
    last = staged.shape[0] - 1
    word = torch.zeros(n_out, dtype=torch.int64, device=dev)
    for j in range(8):
        word |= staged[(byte0 + j).clamp_(0, last)].long() << (56 - 8 * j)
    shift = (64 - (bit0 & 7) - width).clamp_(min=0)
    mask = (torch.ones_like(width) << width.clamp(max=62)) - 1
    packed = (word >> shift) & mask
    packed = torch.where(br < 0, (packed >> 1) ^ -(packed & 1), packed)
    return torch.where(k == _LINEAR, linear,
                       torch.where(k == _VALUES, direct, packed))


def _validity(plan: ColumnPlan, staged: torch.Tensor, capacity: int,
              n_rows: int) -> torch.Tensor:
    dev = staged.device
    i = torch.arange(capacity, device=dev)
    live = i < n_rows
    if plan.present is None:
        return live
    at, n = plan.present
    bits = staged[at:at + n]
    byte = bits[(i >> 3).clamp(0, max(n - 1, 0))]
    return live & (((byte >> (7 - (i & 7)).to(torch.uint8)) & 1) == 1)


def _by_row(values: torch.Tensor, validity: torch.Tensor, n_valid: int
            ) -> torch.Tensor:
    """Non-null values, one a valid row, scattered to their rows (zero
    under a null)."""
    if n_valid == 0:
        return torch.zeros(validity.shape[0], dtype=values.dtype,
                           device=validity.device)
    slot = (torch.cumsum(validity, 0) - 1).clamp_(0, n_valid - 1)
    return torch.where(validity, values[slot],
                       torch.zeros((), dtype=values.dtype,
                                   device=validity.device))


def decode_column(plan: ColumnPlan, staged: torch.Tensor,
                  tables: torch.Tensor, capacity: int,
                  n_rows: int) -> DeviceColumn:
    """One column of a stripe from its uploaded streams and tables."""
    dev = staged.device
    validity = _validity(plan, staged, capacity, n_rows)
    nv = plan.n_valid
    get = lambda h: _TablePack.get(tables, h)  # noqa: E731
    if plan.shape in ("int", "dict"):
        vals = expand_runs(get(plan.runs), get(plan.values), staged, nv)
        if plan.shape == "dict":
            rank = get(plan.rank)
            codes = _by_row(rank[vals.clamp(0, rank.shape[0] - 1)],
                            validity, nv).to(torch.int32)
            return dictionary_column(codes, validity, plan.dictionary,
                                     dict_sorted=True)
        return DeviceColumn(_by_row(vals, validity, nv).to(
            plan.dtype.torch_dtype), validity, plan.dtype)
    at, n = plan.data
    raw = staged[at:at + n]
    if plan.shape == "float":
        vals = raw.view(torch.float32 if plan.dtype is T.FLOAT
                        else torch.float64)
        return DeviceColumn(_by_row(vals, validity, nv), validity,
                            plan.dtype)
    if plan.shape == "bool":
        j = torch.arange(nv, device=dev)
        vals = ((raw[(j >> 3).clamp(0, max(n - 1, 0))]
                 >> (7 - (j & 7)).to(torch.uint8)) & 1) == 1
        return DeviceColumn(_by_row(vals, validity, nv), validity,
                            plan.dtype)
    if plan.shape == "byte":
        return DeviceColumn(_by_row(raw.view(torch.int8), validity, nv),
                            validity, plan.dtype)
    # DIRECT_V2 string: a flat column over the stream's bytes
    lens = _by_row(get(plan.lengths)[:max(nv, 1)], validity, nv)
    offsets = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(lens, 0)
    payload = torch.zeros(bucket_byte_capacity(max(n, 1)),
                          dtype=torch.uint8, device=dev)
    payload[:n] = raw
    return DeviceColumn(payload, validity, T.STRING, offsets=offsets,
                        max_bytes=string_max_bytes(plan.longest))


def decode_stripe_device(host: HostStripe, device=None,
                         ctx: Optional[ExecContext] = None
                         ) -> ColumnarBatch:
    """The device phase: upload the staging buffer and the tables (one
    copy each) and decode every column in torch. Timers
    ``OrcScanExec.upload`` and ``.decode``; counters ``.rows``,
    ``.bytes`` (decompressed) and ``.read_bytes``."""
    if ctx is not None:
        device, timed = ctx.device, ctx.timed
    else:
        device, timed = torch.device(device or "cpu"), _no_timer
    non_blocking = device.type == "cuda"
    with timed(SCAN + ".upload"):
        staged = host.staging.to(device, non_blocking=non_blocking)
        tables = host.tables.to(device, non_blocking=non_blocking)
    capacity = bucket_capacity(max(host.n_rows, 1))
    with timed(SCAN + ".decode"):
        cols = [decode_column(p, staged, tables, capacity, host.n_rows)
                for p in host.plans]
        n_rows = torch.tensor(host.n_rows, dtype=torch.int64, device=device)
    if ctx is not None:
        ctx.count(SCAN + ".rows", host.n_rows)
        ctx.count(SCAN + ".bytes", host.decompressed_bytes)
        ctx.count(SCAN + ".read_bytes", host.read_bytes)
        ctx.metric(SCAN, "uploadBytes",
                   host.staging.nbytes + host.tables.nbytes)
    return ColumnarBatch(tuple(cols), n_rows, host.schema)


def decode_stripe(tail: OrcTail, stripe: int, schema: T.Schema,
                  device=None, host_device=None) -> ColumnarBatch:
    """One stripe of ``schema``'s columns decoded on ``device`` (the CPU
    by default: the host stripe decoder); ``host_device`` picks the host
    phase's snappy routine (``device`` unless given)."""
    return decode_stripe_device(
        read_stripe_host(tail, stripe, schema, host_device or device),
        device)


# -- the scan exec -------------------------------------------------------------


class OrcScanExec(TorchExec):
    """The ORC scan (the reference's ``TpuOrcScanExec``): one partition
    per (file, stripe) in file order, each one batch. The host phase of
    the next stripes runs ahead on the pipeline's pool; the device phase
    runs on the thread that reads the partition. A stripe whose decode
    fails with malformed input or a classified device fault (OOM,
    transient), or whose ``io.orc.stripe`` site is injected, decodes on
    the host instead and is uploaded (``hostFallbackStripes``; decoded
    ones count ``deviceDecodedStripes``)."""

    def __init__(self, files: List[str], schema: T.Schema,
                 tails: Optional[Dict[str, OrcTail]] = None):
        self.children = []
        self.files = list(files)
        self._schema = schema
        self._tails = dict(tails or {})

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return (f"OrcScan [{', '.join(self._schema.names)}] "
                f"files={len(self.files)}")

    def execute(self, ctx):
        from ..memory.retry import Classification, classify
        from ..utils.fault_injection import maybe_inject
        units = []
        for path in self.files:
            tail = self._tails.get(path)
            if tail is None:
                with ctx.timed(SCAN + ".parse", host=True):
                    tail = read_tail(path)
            units.extend((tail, k) for k in range(len(tail.stripes)))

        def read_unit(unit):
            return read_stripe_host(unit[0], unit[1], self._schema, ctx=ctx)

        def decode(part, unit):
            tail, k = unit
            try:
                hosts = list(part)
                maybe_inject(ctx, "io.orc.stripe")
                batch = decode_stripe_device(hosts[0], ctx=ctx)
                ctx.metric(SCAN, "deviceDecodedStripes", 1)
                ctx.count(SCAN + ".deviceDecodedStripes", 1)
            except Exception as e:  # noqa: BLE001 - classified below
                if not isinstance(e, NotOrcDecodable) \
                        and classify(e) == Classification.FATAL:
                    raise
                with ctx.timed(SCAN + ".hostFallback", host=True):
                    batch = move_batch(decode_stripe(
                        tail, k, self._schema, "cpu", ctx.device),
                        ctx.device)
                ctx.metric(SCAN, "hostFallbackStripes", 1)
                ctx.count(SCAN + ".hostFallbackStripes", 1)
            ctx.metric(SCAN, "numOutputRows", tail.stripes[k].n_rows)
            ctx.metric(SCAN, "numOutputBatches", 1)
            yield batch

        return [decode(part, unit) for part, unit in zip(
            unit_partitions(read_unit, units, ctx, SCAN), units)]

