"""The parquet scan: host page walk, device decode — port of
``spark_rapids_tpu/io/parquet_device.py`` (``ColumnChunkPlan``,
``_parse_hybrid``, ``_HybridRuns``, ``plan_column_chunk``,
``decode_chunk``, ``decode_row_group``, ``rebase_guard``,
``TpuParquetScanExec``, ``scan_files``).

The work splits as in the reference (and as cuDF's reader does):

* HOST, metadata-sized: the footer (:mod:`.parquet_meta`), the page
  headers (:mod:`.thrift`), decompression (:mod:`.snappy`: the C++
  routine for a scan on the card, one call per column chunk), and the
  RLE/bit-packed hybrid streams (definition levels, dictionary indices)
  sliced into RUN TABLES — (kind, count, value, bit offset, width) per
  run — without expanding a value (the C++ routine
  ``csrc/parquet_runs.cpp`` on the card, one call per stream). Every
  page of a row group lands, decompressed, in one staging buffer (pinned
  on the card) at an 8-byte aligned offset, and the run tables of all
  its columns in a second; each goes to the device in one copy. This
  phase (:func:`read_row_group_host`) touches no device, and the scan
  runs it ahead on the pipeline's workers.
* DEVICE, data-sized, in torch (:func:`decode_row_group_device`, on the
  thread that reads the partition): each output finds its run by
  ``searchsorted`` over the run ends; an RLE run broadcasts its value, a
  bit-packed run gathers the 4 bytes around the value's bit offset in
  the uploaded pages and shifts and masks; definition levels become the
  validity, whose cumsum gives each row its slot in the page's non-null
  values; dictionary indices gather the dictionary.

A string dictionary is sorted on the host by bytes (the rank of each
entry remaps the codes on the device), so the column lands as a
``dict_sorted`` dictionary column; PLAIN byte-array pages (a writer
without dictionaries, or one whose dictionary filled up) are walked on
the host and their values merged into that sorted dictionary, their
codes uploaded. A chunk whose dictionary fell back to PLAIN pages part
way decodes: each non-null slot reads from its own page's stream. PLAIN
(and RLE) booleans are one bit-packed run of width 1. v2 data pages
(levels stored uncompressed ahead of the values) and GZIP (``zlib``)
decode beside v1 pages, UNCOMPRESSED and SNAPPY. Out of scope, each
raising ``NotImplementedError`` that names the file, the column and the
reason: nested columns, INT96 and other unsupported physical or logical
types, DELTA encodings, dictionary bit widths over 24, and the LZ4,
ZSTD and BROTLI codecs.

:func:`device_decodable` is the plan's gate (the reference's, ``:740``):
a file it refuses is read by the host scan (:mod:`.files`), which
raises the same error. The same decode on CPU tensors is the host
reader (the host scan's, :func:`.files.host_rows`); the scan falls back
to it for one row group whose device decode meets a classified device
fault (an
OOM, a transient one) or whose ``io.parquet.rowGroup`` site is injected
(the reference's per-row-group fallback, ``:678-712``), counting
``hostFallbackRowGroups`` beside ``deviceDecodedRowGroups``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import datetime as _dt
import os
import struct
import threading
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import types as T
from ..data.batch import ColumnarBatch, move_batch
from ..data.column import (DeviceColumn, bucket_capacity, dictionary_column,
                           scalar_column)
from ..exec.execs import ExecContext, TorchExec
from ..exec.pipeline import unit_partitions
from ..ops.kernels.cuda import _build
from . import snappy
from .parquet_meta import (ColumnChunkMeta, FileMeta, ParquetFormatError,
                           read_footer, schema_from_parquet)
from .thrift import Thrift, ThriftError

PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
_PAGE_DATA, _PAGE_INDEX, _PAGE_DICT, _PAGE_DATA_V2 = 0, 1, 2, 3
_CODECS = ("UNCOMPRESSED", "SNAPPY", "GZIP")
#: PLAIN value width of each fixed-width physical type
_PHYS_NP = {"INT32": np.dtype(np.int32), "INT64": np.dtype(np.int64),
            "FLOAT": np.dtype(np.float32), "DOUBLE": np.dtype(np.float64)}
_TORCH = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
          np.dtype(np.float32): torch.float32,
          np.dtype(np.float64): torch.float64}
#: Staged pages and tables start at multiples of this many bytes, so a
#: PLAIN dictionary page can be viewed in its value type on the device.
_ALIGN = 8


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


# -- page headers -------------------------------------------------------------


@dataclasses.dataclass
class PageHeader:
    page_type: int
    uncompressed_size: int
    compressed_size: int
    #: offset of the page's payload in the column chunk
    payload_pos: int
    num_values: int = 0
    encoding: int = PLAIN
    def_encoding: int = RLE
    #: v2 data pages: bytes of the repetition and definition levels,
    #: stored uncompressed ahead of the values
    rep_len: int = 0
    def_len: int = 0
    compressed: bool = True

    @property
    def v2(self) -> bool:
        return self.page_type == _PAGE_DATA_V2


def parse_page_header(buf, pos: int) -> PageHeader:
    """The thrift ``PageHeader`` at ``buf[pos:]``."""
    t = Thrift(buf, pos)
    d = t.read_struct()
    ph = PageHeader(d[1], d[2], d[3], t.pos)
    if ph.page_type == _PAGE_DATA:
        ph.num_values = d[5][1]
        ph.encoding = d[5][2]
        ph.def_encoding = d[5][3]
    elif ph.page_type == _PAGE_DICT:
        ph.num_values = d[7][1]
        ph.encoding = d[7][2]
    elif ph.page_type == _PAGE_DATA_V2:
        v2 = d[8]
        ph.num_values = v2[1]
        ph.encoding = v2[4]
        ph.def_len = v2[5]
        ph.rep_len = v2[6]
        ph.compressed = bool(v2.get(7, True))
    return ph


# -- host run tables ------------------------------------------------------------


class HybridRuns:
    """Run table of RLE/bit-packed hybrid streams: per run its kind (1
    RLE, 0 bit-packed), count, value (RLE) and bit offset into the
    staging buffer (bit-packed), and its bit width (a dictionary's width
    grows across pages as it fills). The plain parse adds runs one by
    one; the C++ one adds a stream's runs as one block."""

    def __init__(self):
        self.kinds: List[int] = []
        self.counts: List[int] = []
        self.values: List[int] = []
        self.bit_starts: List[int] = []
        self.widths: List[int] = []
        #: int64 [5, k] blocks ahead of the runs in the lists
        self._blocks: List[np.ndarray] = []
        self._in_blocks = 0

    def __len__(self) -> int:
        return self._in_blocks + len(self.kinds)

    def add(self, kind: int, count: int, value: int, bit_start: int,
            width: int) -> None:
        self.kinds.append(kind)
        self.counts.append(count)
        self.values.append(value)
        self.bit_starts.append(bit_start)
        self.widths.append(width)

    def _lists(self) -> np.ndarray:
        return np.array([self.kinds, self.counts, self.values,
                         self.bit_starts, self.widths],
                        dtype=np.int64).reshape(5, -1)

    def extend(self, table: np.ndarray) -> None:
        """Append a block of runs (int64 ``[5, k]``)."""
        if self.kinds:
            self._blocks.append(self._lists())
            self._in_blocks += len(self.kinds)
            for lane in (self.kinds, self.counts, self.values,
                         self.bit_starts, self.widths):
                lane.clear()
        self._blocks.append(table)
        self._in_blocks += table.shape[1]

    def non_null_count(self, start_run: int, staged: np.ndarray) -> int:
        """Ones in a bit-width-1 (definition level) run suffix of the
        plain parse's runs: the non-null values of a page, which is how
        many entries its value stream holds."""
        total = 0
        for i in range(start_run - self._in_blocks, len(self.kinds)):
            if self.kinds[i] == 1:
                total += self.counts[i] * (self.values[i] & 1)
            else:
                b0, count = self.bit_starts[i], self.counts[i]
                chunk = staged[b0 // 8: (b0 % 8 + count + 7) // 8 + b0 // 8]
                bits = np.unpackbits(chunk, bitorder="little")
                total += int(bits[b0 % 8: b0 % 8 + count].sum())
        return total

    def array(self) -> np.ndarray:
        """int64 ``[5, runs]``: kinds, counts, values, bit starts,
        widths."""
        if not self._blocks:
            return self._lists()
        return np.concatenate(self._blocks + [self._lists()], axis=1)

    def all_valid(self) -> bool:
        """Whether every run is an RLE run of ones (definition levels
        that mark every row valid)."""
        a = self.array()
        return bool(np.all((a[0] == 1) & (a[2] == 1)))


def parse_hybrid(buf: bytes, pos: int, end: int, bit_width: int,
                 n_values: int, runs: HybridRuns, base: int,
                 pad_tail: bool = True) -> None:
    """Slice one hybrid stream, ``buf[pos:end]``, into runs; ``base`` is
    the byte offset of ``buf`` in the staging buffer, which bit-packed
    runs point into. Counts cap at the page's ``n_values``, so the
    padded last bit-packed group never leaks positions into the next
    page's runs; a stream that stops short ends in implicit zeros. The
    plain version of :func:`parse_hybrid_native`, which a CPU scan
    runs."""
    produced = 0
    t = Thrift(buf, pos)
    byte_w = (bit_width + 7) // 8
    while produced < n_values and t.pos < end:
        header = t.varint()
        if header & 1:  # bit-packed: (header >> 1) groups of 8 values
            groups = header >> 1
            count = min(groups * 8, n_values - produced)
            nbytes = groups * bit_width
            if t.pos + nbytes > end:
                raise ParquetFormatError("bit-packed run runs past its "
                                         "stream")
            runs.add(0, count, 0, (base + t.pos) * 8, bit_width)
            t.pos += nbytes
        else:
            count = min(header >> 1, n_values - produced)
            if t.pos + byte_w > end:
                raise ParquetFormatError("RLE run runs past its stream")
            runs.add(1, count, int.from_bytes(buf[t.pos:t.pos + byte_w],
                                              "little"), 0, bit_width)
            t.pos += byte_w
        produced += count
    if pad_tail and produced < n_values:
        runs.add(1, n_values - produced, 0, 0, bit_width)


_RUNS_COUNT_LOCK = threading.Lock()
_MORE_RUNS = 4  # csrc/parquet_runs.cpp kMoreRuns
#: Runs the first C++ call has room for.
_FIRST_RUNS = 4096


def _runs_lib():
    lib = _build.load("parquet_runs")
    if lib.srt_parse_hybrid.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        lib.srt_parse_hybrid.argtypes = [p, i64, i64, i64, i32, i64, i64,
                                         i32, p, i64, p, p]
        lib.srt_parse_hybrid.restype = ctypes.c_int
    return lib


def parse_hybrid_native(staged: np.ndarray, pos: int, end: int,
                        bit_width: int, n_values: int,
                        runs: HybridRuns) -> int:
    """:func:`parse_hybrid` of the stream ``staged[pos:end]`` through the
    host C++ routine (``csrc/parquet_runs.cpp``), which the scan on the
    card runs: the same runs, appended to ``runs`` as one block, without
    the GIL. Returns the stream's values equal to 1 when ``bit_width`` is
    1 (a page's non-null rows), else 0."""
    if staged.dtype != np.uint8 or not staged.flags.c_contiguous:
        raise ValueError("parse_hybrid_native takes a contiguous uint8 "
                         "staging buffer")
    lib = _runs_lib()
    n_runs, ones = ctypes.c_int64(0), ctypes.c_int64(0)
    # Room for a typical stream's runs first; a longer one parses again
    # into room for one run a value (plus the padded tail), then, past
    # runs of count 0, one run a byte of the stream.
    for cap in (min(end - pos, n_values, _FIRST_RUNS),
                min(end - pos, n_values), end - pos):
        out = np.empty((5, cap + 1), np.int64)
        rc = lib.srt_parse_hybrid(
            staged.ctypes.data, min(end, len(staged)), pos, end, bit_width,
            n_values, 0, 1, out.ctypes.data, out.shape[1],
            ctypes.byref(n_runs), ctypes.byref(ones))
        if rc != _MORE_RUNS:
            break
    if rc != 0:
        raise ParquetFormatError(lib.srt_error_string(rc).decode())
    with _RUNS_COUNT_LOCK:
        parse_hybrid_native.launches += 1
    runs.extend(out[:, :n_runs.value].copy())
    return ones.value


#: C++ calls since the last reset (a CPU scan takes the plain version and
#: does not count).
parse_hybrid_native.launches = 0


# -- host phase: one column chunk ----------------------------------------------


@dataclasses.dataclass
class ColumnChunkPlan:
    """What the device decode needs of one column chunk, prepared on the
    host from its page bytes."""

    name: str
    dtype: T.DataType
    n_rows: int
    #: definition levels; None for a REQUIRED column (every row valid)
    def_runs: Optional[HybridRuns]
    #: dictionary indices of the dictionary-encoded data pages, in order
    idx_runs: HybridRuns
    #: per data page with values: (1 dictionary-encoded / 0 PLAIN,
    #: non-null values, staging offset of its PLAIN values)
    pages: List[tuple]
    #: PLAIN value type of the physical type (None for strings)
    value_dtype: Optional[np.dtype]
    #: fixed width dictionary: (staging offset, entries)
    dict_values: Optional[tuple] = None
    #: string dictionary, sorted by bytes, and each page entry's rank
    dict_strings: Optional[np.ndarray] = None
    dict_rank: Optional[np.ndarray] = None
    #: the PLAIN byte-array values' codes into ``dict_strings``
    plain_codes: Optional[np.ndarray] = None
    #: a boolean chunk's values: bit-packed (PLAIN) or hybrid (RLE) runs
    bool_runs: Optional[HybridRuns] = None

    @property
    def uses_dict(self) -> bool:
        return any(kind and n for kind, n, _ in self.pages)

    @property
    def uses_plain(self) -> bool:
        return any(not kind and n for kind, n, _ in self.pages)


@dataclasses.dataclass
class _Chunk:
    """A column chunk between the page walk and decompression."""
    field: T.StructField
    meta: ColumnChunkMeta
    max_def_level: int
    raw: np.ndarray
    headers: List[PageHeader]
    #: staging offset of each page's decompressed payload
    dst: List[int] = dataclasses.field(default_factory=list)


def _refuse(path: str, column: str, reason: str) -> NotImplementedError:
    return NotImplementedError(f"{path}: column {column!r}: {reason}")


def _walk_pages(path: str, field: T.StructField, cm: ColumnChunkMeta,
                max_def_level: int, raw: np.ndarray) -> _Chunk:
    """The page headers of one column chunk's bytes, refusing what the
    decoder does not take."""
    if cm.codec not in _CODECS:
        raise _refuse(path, field.name, f"codec {cm.codec} is not "
                      "supported (UNCOMPRESSED, SNAPPY and GZIP are)")
    if max_def_level > 1:
        raise _refuse(path, field.name, "nested columns are not supported")
    headers = []
    pos, buf = 0, memoryview(raw)
    while pos < len(raw):
        try:
            ph = parse_page_header(buf, pos)
        except (ThriftError, KeyError) as e:
            raise ParquetFormatError(f"{path}: column {field.name!r}: "
                                     f"bad page header at chunk byte {pos}: "
                                     f"{e!r}") from e
        if ph.v2 and (ph.rep_len or ph.def_len < 0
                      or ph.def_len > ph.compressed_size):
            raise _refuse(path, field.name, "nested columns are not "
                          "supported (v2 page with repetition levels)")
        end = ph.payload_pos + ph.compressed_size
        if ph.compressed_size < 0 or ph.uncompressed_size < 0 \
                or end > len(raw):
            raise ParquetFormatError(f"{path}: column {field.name!r}: page "
                                     "runs past its column chunk")
        if cm.codec == "UNCOMPRESSED" and \
                ph.compressed_size != ph.uncompressed_size:
            raise ParquetFormatError(f"{path}: column {field.name!r}: "
                                     "uncompressed page sizes differ")
        if ph.page_type in (_PAGE_DATA, _PAGE_DICT, _PAGE_DATA_V2):
            headers.append(ph)
        pos = end
    return _Chunk(field, cm, max_def_level, raw, headers)


def _byte_array_values(payload: bytes, n: int, path: str, column: str,
                       what: str) -> List[bytes]:
    """The ``n`` PLAIN byte-array values (u32 length, bytes) at the start
    of ``payload``."""
    vals = []
    q = 0
    for _ in range(n):
        if q + 4 > len(payload):
            raise ParquetFormatError(f"{path}: column {column!r}: {what} "
                                     "ends early")
        (ln,) = struct.unpack_from("<I", payload, q)
        q += 4
        vals.append(payload[q:q + ln])
        q += ln
    if q > len(payload):
        raise ParquetFormatError(f"{path}: column {column!r}: {what} "
                                 "entry runs past its page")
    return vals


def _sorted_strings(vals: List[bytes]):
    """Byte strings sorted by bytes with duplicates merged: (sorted str
    array, the rank of each value)."""
    if not vals:
        return np.zeros(0, object), np.zeros(0, np.int64)
    uniq, rank = np.unique(np.array(vals, dtype=object), return_inverse=True)
    strings = np.array([b.decode("utf-8", "replace") for b in uniq],
                       dtype=object)
    return strings, rank.astype(np.int64)


def _hybrid(path: str, name: str, staged: np.ndarray, pos: int, end: int,
            bit_width: int, n_values: int, runs: HybridRuns,
            native: bool) -> int:
    """Slice ``staged[pos:end]`` into ``runs``; returns the ones among its
    values when ``bit_width`` is 1 (the plain parse counts them after)."""
    if native:
        return _native_runs(path, name, staged, pos, end, bit_width,
                            n_values, runs)
    first = len(runs)
    parse_hybrid(staged[pos:end].tobytes(), 0, end - pos, bit_width,
                 n_values, runs, pos)
    return runs.non_null_count(first, staged) if bit_width == 1 else 0


def _plan_chunk(path: str, ch: _Chunk, staged: np.ndarray,
                native: bool = False) -> ColumnChunkPlan:
    """Host phase for one decompressed column chunk: page payloads ->
    run tables (the reference's ``plan_column_chunk``), through the C++
    run slicer when ``native`` (a scan on the card), else the plain
    :func:`parse_hybrid`."""
    field, cm, name = ch.field, ch.meta, ch.field.name
    phys = cm.physical_type
    is_string = phys == "BYTE_ARRAY"
    is_bool = phys == "BOOLEAN"
    value_dtype = _PHYS_NP.get(phys)
    if value_dtype is None and not is_string and not is_bool:
        raise _refuse(path, name, f"physical type {phys} is not supported")
    def_runs = HybridRuns() if ch.max_def_level > 0 else None
    idx_runs = HybridRuns()
    plan = ColumnChunkPlan(name, field.data_type, 0, def_runs, idx_runs, [],
                           value_dtype)
    if is_bool:
        plan.bool_runs = HybridRuns()
    dict_seen = False
    dict_raw: List[bytes] = []
    plain_raw: List[bytes] = []
    for ph, dst in zip(ch.headers, ch.dst):
        size = ph.uncompressed_size
        if ph.page_type == _PAGE_DICT:
            if ph.encoding not in (PLAIN, PLAIN_DICTIONARY):
                raise _refuse(path, name, f"dictionary page encoding "
                              f"{ph.encoding}")
            if dict_seen:
                raise ParquetFormatError(f"{path}: column {name!r}: two "
                                         "dictionary pages")
            dict_seen = True
            if is_string:
                dict_raw = _byte_array_values(
                    staged[dst:dst + size].tobytes(), ph.num_values, path,
                    name, "dictionary page")
            else:
                if is_bool or \
                        ph.num_values * value_dtype.itemsize > size:
                    raise ParquetFormatError(f"{path}: column {name!r}: "
                                             "dictionary page ends early")
                plan.dict_values = (dst, ph.num_values)
            continue
        if ph.num_values == 0:
            continue
        p = dst
        end = dst + size
        if def_runs is not None:
            if ph.v2:
                def_len = ph.def_len
            else:
                if ph.def_encoding != RLE:
                    raise _refuse(path, name, "definition levels not RLE "
                                  "encoded")
                if size < 4:
                    raise ParquetFormatError(f"{path}: column {name!r}: "
                                             "data page ends in its levels")
                (def_len,) = struct.unpack_from("<I", staged, p)
                p += 4
            if p + def_len > end:
                raise ParquetFormatError(f"{path}: column {name!r}: "
                                         "definition levels run past the "
                                         "page")
            non_null = _hybrid(path, name, staged, p, p + def_len, 1,
                               ph.num_values, def_runs, native)
            p += def_len
        else:
            non_null = ph.num_values
            p += ph.def_len if ph.v2 else 0
        if ph.encoding in (PLAIN_DICTIONARY, RLE_DICTIONARY):
            if not dict_seen:
                raise ParquetFormatError(f"{path}: column {name!r}: "
                                         "dictionary-encoded page without "
                                         "a dictionary page")
            if p >= end and non_null:
                raise ParquetFormatError(f"{path}: column {name!r}: "
                                         "dictionary-encoded data page "
                                         "without its bit width")
            bw = int(staged[p]) if p < end else 0
            if bw > 24:
                raise _refuse(path, name, f"dictionary bit width {bw} is "
                              "over 24")
            p += 1
            _hybrid(path, name, staged, p, end, bw, non_null, idx_runs,
                    native)
            plan.pages.append((1, non_null, 0))
        elif is_bool and ph.encoding in (PLAIN, RLE):
            if ph.encoding == PLAIN:
                if p + (non_null + 7) // 8 > end:
                    raise ParquetFormatError(f"{path}: column {name!r}: "
                                             "PLAIN booleans run past the "
                                             "page")
                plan.bool_runs.add(0, non_null, 0, p * 8, 1)
            else:
                if p + 4 > end:
                    raise ParquetFormatError(f"{path}: column {name!r}: "
                                             "RLE booleans end early")
                (ln,) = struct.unpack_from("<I", staged, p)
                _hybrid(path, name, staged, p + 4, min(p + 4 + ln, end), 1,
                        non_null, plan.bool_runs, native)
            plan.pages.append((0, non_null, 0))
        elif ph.encoding == PLAIN and is_string:
            plain_raw += _byte_array_values(staged[p:end].tobytes(),
                                            non_null, path, name,
                                            "PLAIN byte-array page")
            plan.pages.append((0, non_null, 0))
        elif ph.encoding == PLAIN and not is_bool:
            if p + non_null * value_dtype.itemsize > end:
                raise ParquetFormatError(f"{path}: column {name!r}: PLAIN "
                                         "values run past the page")
            plan.pages.append((0, non_null, p))
        else:
            raise _refuse(path, name, f"data page encoding {ph.encoding} is "
                          "not supported")
        plan.n_rows += ph.num_values
    if is_string:
        plan.dict_strings, rank = _sorted_strings(dict_raw + plain_raw)
        plan.dict_rank = rank[:len(dict_raw)]
        if plain_raw:
            plan.plain_codes = rank[len(dict_raw):]
    if plan.uses_dict and (not dict_raw if is_string
                           else not plan.dict_values[1]):
        raise ParquetFormatError(f"{path}: column {name!r}: indices into "
                                 "an empty dictionary")
    return plan


def _gunzip(ch: _Chunk, page: tuple, host: np.ndarray, path: str) -> None:
    """One GZIP page into its staging range."""
    so, n, do, size = page
    try:
        out = zlib.decompress(ch.raw[so:so + n].tobytes(), 47)
    except zlib.error as e:
        raise ParquetFormatError(f"{path}: column {ch.field.name!r}: bad "
                                 f"GZIP page: {e}") from e
    if len(out) != size:
        raise ParquetFormatError(f"{path}: column {ch.field.name!r}: GZIP "
                                 "page size differs from its header")
    host[do:do + size] = np.frombuffer(out, np.uint8)


def _native_runs(path: str, column: str, staged: np.ndarray, pos: int,
                 end: int, bit_width: int, n_values: int,
                 runs: HybridRuns) -> int:
    try:
        return parse_hybrid_native(staged, pos, end, bit_width, n_values,
                                   runs)
    except ParquetFormatError as e:
        raise ParquetFormatError(f"{path}: column {column!r}: {e}") from e


class _TablePack:
    """Run tables of a row group's columns, packed into one int64 host
    array so they reach the device in one copy."""

    def __init__(self):
        self._parts: List[np.ndarray] = []
        self._size = 0

    def add(self, arr: np.ndarray) -> tuple:
        arr = np.ascontiguousarray(arr, dtype=np.int64)
        handle = (self._size, arr.shape)
        self._parts.append(arr.reshape(-1))
        self._size += arr.size
        return handle

    def host(self) -> np.ndarray:
        return np.concatenate(self._parts) if self._parts \
            else np.zeros(1, np.int64)

    @staticmethod
    def get(dev: torch.Tensor, handle: tuple) -> torch.Tensor:
        start, shape = handle
        n = int(np.prod(shape))
        return dev[start:start + n].view(shape)


def _all_valid(runs: Optional[HybridRuns]) -> bool:
    """Definition levels that mark every row valid (or none at all)."""
    return runs is None or runs.all_valid()


def expand_hybrid(table: torch.Tensor, staged: torch.Tensor,
                  n_out: int) -> torch.Tensor:
    """Expand a run table (int64 ``[5, runs]``) into ``n_out`` int64
    values: each output finds its run by ``searchsorted`` over the run
    ends; an RLE run broadcasts its value, a bit-packed run gathers the
    4 staged bytes around the value's bit offset and shifts and masks
    (widths are at most 24, so shift + width <= 31 stays inside them).
    Outputs past the runs' total are garbage for the caller to mask."""
    dev = staged.device
    if table.shape[1] == 0:
        return torch.zeros(n_out, dtype=torch.int64, device=dev)
    kinds, counts, values, bit_starts, widths = table.unbind(0)
    ends = torch.cumsum(counts, 0)
    i = torch.arange(n_out, dtype=torch.int64, device=dev)
    r = torch.searchsorted(ends, i, right=True).clamp_(max=table.shape[1] - 1)
    w = widths[r]
    bit0 = bit_starts[r] + (i - (ends - counts)[r]) * w
    byte0 = bit0 >> 3
    last = staged.shape[0] - 1
    word = torch.zeros(n_out, dtype=torch.int64, device=dev)
    for k in range(4):
        word |= staged[(byte0 + k).clamp_(0, last)].long() << (8 * k)
    packed = (word >> (bit0 & 7)) & ((1 << w) - 1)
    return torch.where(kinds[r] == 1, values[r], packed)


def _plain_values(plan: ColumnChunkPlan, staged: torch.Tensor
                  ) -> torch.Tensor:
    """The PLAIN pages' values, one after another, in the value type (a
    device copy makes them aligned)."""
    size = plan.value_dtype.itemsize
    ranges = [(a, n * size) for kind, n, a in plan.pages if not kind and n]
    if len(ranges) == 1 and ranges[0][0] % size == 0:
        a, nb = ranges[0]
        raw = staged[a:a + nb]
    else:
        raw = torch.cat([staged[a:a + nb] for a, nb in ranges])
    return raw.view(_TORCH[plan.value_dtype])


def decode_chunk(plan: ColumnChunkPlan, staged: torch.Tensor,
                 tables: torch.Tensor, handles: dict,
                 capacity: int) -> DeviceColumn:
    """Device decode of one column chunk (the reference's
    ``_decode_chunk_device``) from the uploaded staging buffer and run
    tables; ``handles`` locate the chunk's tables in ``tables``."""
    dev = staged.device
    live = torch.arange(capacity, device=dev) < plan.n_rows
    if "def" in handles:
        levels = expand_hybrid(_TablePack.get(tables, handles["def"]),
                               staged, capacity)
        validity = (levels == 1) & live
    else:
        validity = live
    n_vals = sum(n for _, n, _ in plan.pages)
    if n_vals == 0:  # every row null, or no rows
        if plan.dtype is T.STRING:
            zeros = torch.zeros(capacity, dtype=torch.int32, device=dev)
            return dictionary_column(zeros, validity, plan.dict_strings,
                                     dict_sorted=True)
        return DeviceColumn(torch.zeros(capacity, dtype=plan.dtype
                                        .torch_dtype, device=dev),
                            validity, plan.dtype)
    # values are stored for non-null rows only: a row's slot among them is
    # the count of valid rows before it
    slot = (torch.cumsum(validity, 0) - 1).clamp_(0, n_vals - 1)
    idx = expand_hybrid(_TablePack.get(tables, handles["idx"]), staged,
                        n_vals) if plan.uses_dict else None
    dict_vals = plain = None
    if plan.dtype is T.STRING:
        if plan.uses_dict:
            rank = _TablePack.get(tables, handles["rank"])
            dict_vals = rank[idx.clamp_(0, rank.shape[0] - 1)]
        if plan.uses_plain:
            plain = _TablePack.get(tables, handles["plain"])
    elif plan.bool_runs is not None:
        plain = expand_hybrid(_TablePack.get(tables, handles["bool"]),
                              staged, n_vals) == 1
    else:
        vdt = _TORCH[plan.value_dtype]
        if plan.uses_dict:
            off, count = plan.dict_values
            entries = staged[off:off + count * plan.value_dtype.itemsize]
            dict_vals = entries.view(vdt)[idx.clamp_(0, count - 1)]
        if plan.uses_plain:
            plain = _plain_values(plan, staged)
    if dict_vals is not None and plain is not None:
        # a dictionary that fell back to PLAIN part way: each slot reads
        # the stream of its own page
        kinds, counts = _TablePack.get(tables, handles["pages"]).unbind(0)
        s = torch.arange(n_vals, device=dev)
        page = torch.searchsorted(torch.cumsum(counts, 0), s, right=True)
        from_dict = kinds[page.clamp_(max=counts.shape[0] - 1)] == 1
        d_pos = (torch.cumsum(from_dict, 0) - 1).clamp_(
            0, dict_vals.shape[0] - 1)
        p_pos = (torch.cumsum(~from_dict, 0) - 1).clamp_(
            0, plain.shape[0] - 1)
        by_slot = torch.where(from_dict, dict_vals[d_pos], plain[p_pos])
    else:
        by_slot = dict_vals if dict_vals is not None else plain
    data = torch.where(validity, by_slot[slot],
                       torch.zeros((), dtype=by_slot.dtype, device=dev))
    if plan.dtype is T.STRING:
        return dictionary_column(data.to(torch.int32), validity,
                                 plan.dict_strings, dict_sorted=True)
    return DeviceColumn(data.to(plan.dtype.torch_dtype), validity,
                        plan.dtype)


SCAN = "ParquetScanExec"


def _no_timer(name: str, host: bool = False):
    return contextlib.nullcontext()


@dataclasses.dataclass
class HostRowGroup:
    """A row group after the host phase (:func:`read_row_group_host`):
    its decompressed pages in one staging buffer (pinned for a scan on
    the card), the run tables of all its columns in a second, and the
    plans the device decode follows."""
    path: str
    row_group: int
    schema: T.Schema
    n_rows: int
    staging: torch.Tensor
    tables: torch.Tensor
    plans: List[ColumnChunkPlan]
    #: per column, where its tables lie in ``tables``
    handles: List[dict]
    decompressed_bytes: int
    read_bytes: int
    snappy_chunks: int


def _timers(ctx: Optional[ExecContext], device):
    if ctx is not None:
        return ctx.device, ctx.timed
    return torch.device("cuda" if device is None else device), _no_timer


def read_row_group_host(path: str, row_group: int, schema: T.Schema,
                        meta: Optional[FileMeta] = None, device=None,
                        ctx: Optional[ExecContext] = None,
                        native_runs: Optional[bool] = None) -> HostRowGroup:
    """The host phase of :func:`decode_row_group`: read the row group's
    column chunks, walk their page headers, decompress every page into
    one staging buffer (the C++ snappy for a scan on the card) and slice
    the hybrid streams into run tables (the C++ slicer on the card, or
    as ``native_runs`` says). Touches no device, so the pipeline's
    workers run it; the timers are ``ParquetScanExec.read``, ``.parse``,
    ``.decompress`` and ``.runs`` (host clock, summed over threads)."""
    device, timed = _timers(ctx, device)
    on_card = device.type == "cuda"
    if native_runs is None:
        native_runs = on_card
    if meta is None:
        with timed(SCAN + ".parse", host=True):
            meta = read_footer(path)
    rgm = meta.row_groups[row_group]
    by_name = {c.path_in_schema: c for c in rgm.columns}
    levels = {leaf.name: leaf.max_definition_level for leaf in meta.leaves}
    chunks: List[_Chunk] = []
    with open(path, "rb") as f:
        for field in schema:
            cm = by_name.get(field.name)
            if cm is None:
                raise ParquetFormatError(f"{path}: row group {row_group} "
                                         f"has no column {field.name!r}")
            with timed(SCAN + ".read", host=True):
                f.seek(cm.start)
                raw = f.read(cm.total_compressed_size)
            if len(raw) != cm.total_compressed_size:
                raise ParquetFormatError(f"{path}: column {field.name!r} "
                                         "runs past the end of the file")
            with timed(SCAN + ".parse", host=True):
                chunks.append(_walk_pages(path, field, cm,
                                          levels[field.name],
                                          np.frombuffer(raw, np.uint8)))
    total = 0
    for ch in chunks:
        for ph in ch.headers:
            ch.dst.append(total)
            total += _aligned(ph.uncompressed_size)
    staging = torch.empty(max(total, _ALIGN), dtype=torch.uint8,
                          pin_memory=on_card)
    host = staging.numpy()
    with timed(SCAN + ".decompress", host=True):
        for ch in chunks:
            pages = []
            for ph, dst in zip(ch.headers, ch.dst):
                # a v2 page's levels are stored uncompressed ahead of its
                # values, and its values may be stored uncompressed too
                lv = ph.rep_len + ph.def_len if ph.v2 else 0
                so = ph.payload_pos
                host[dst:dst + lv] = ch.raw[so:so + lv]
                page = (so + lv, ph.compressed_size - lv, dst + lv,
                        ph.uncompressed_size - lv)
                if ch.meta.codec == "UNCOMPRESSED" or not ph.compressed:
                    if page[1] != page[3]:
                        raise ParquetFormatError(
                            f"{path}: column {ch.field.name!r}: "
                            "uncompressed page sizes differ")
                    host[page[2]:page[2] + page[1]] = \
                        ch.raw[page[0]:page[0] + page[1]]
                elif ch.meta.codec == "GZIP":
                    _gunzip(ch, page, host, path)
                else:
                    pages.append(page)
            if pages:
                snappy.decompress_pages(ch.raw, np.array(pages, np.int64),
                                        host, device)
    pack = _TablePack()
    handles = []
    with timed(SCAN + ".runs", host=True):
        plans = [_plan_chunk(path, ch, host, native_runs) for ch in chunks]
        for plan in plans:
            if plan.n_rows != rgm.num_rows:
                raise ParquetFormatError(
                    f"{path}: column {plan.name!r} holds {plan.n_rows} rows "
                    f"of row group {row_group}'s {rgm.num_rows}")
            h = {}
            if not _all_valid(plan.def_runs):
                h["def"] = pack.add(plan.def_runs.array())
            if plan.uses_dict:
                h["idx"] = pack.add(plan.idx_runs.array())
            if plan.dict_rank is not None and plan.uses_dict:
                h["rank"] = pack.add(plan.dict_rank)
            if plan.plain_codes is not None:
                h["plain"] = pack.add(plan.plain_codes)
            if plan.bool_runs is not None:
                h["bool"] = pack.add(plan.bool_runs.array())
            if plan.uses_dict and plan.uses_plain:
                h["pages"] = pack.add(np.array(
                    [[k for k, _, _ in plan.pages],
                     [n for _, n, _ in plan.pages]]))
            handles.append(h)
        tables = torch.from_numpy(pack.host())
        if on_card:
            tables = tables.pin_memory()
    return HostRowGroup(path, row_group, schema, rgm.num_rows, staging,
                        tables, plans, handles, total,
                        sum(len(ch.raw) for ch in chunks),
                        sum(ch.meta.codec == "SNAPPY" for ch in chunks))


def decode_row_group_device(host: HostRowGroup, device=None,
                            ctx: Optional[ExecContext] = None
                            ) -> ColumnarBatch:
    """The device phase of :func:`decode_row_group`: upload the staging
    buffer and the run tables (one copy each, ``non_blocking`` from
    pinned memory on the card) and decode every column in torch, on the
    calling thread's current stream. Timers ``ParquetScanExec.upload``
    and ``.decode`` (CUDA events on the card); counters ``.rows``,
    ``.bytes`` (decompressed), ``.read_bytes`` and ``.snappy_chunks``;
    metrics ``uploadBytes``, ``numOutputRows`` and ``numOutputBatches``.

    The pinned buffers may be freed as soon as this returns: a
    ``non_blocking`` copy from pinned memory records an event with
    PyTorch's caching host allocator, which reuses the block only after
    the copy has run."""
    device, timed = _timers(ctx, device)
    with timed(SCAN + ".upload"):
        non_blocking = device.type == "cuda"
        staged = host.staging.to(device, non_blocking=non_blocking)
        tables = host.tables.to(device, non_blocking=non_blocking)
    capacity = bucket_capacity(max(host.n_rows, 1))
    with timed(SCAN + ".decode"):
        cols = [decode_chunk(plan, staged, tables, h, capacity)
                for plan, h in zip(host.plans, host.handles)]
        n_rows = torch.tensor(host.n_rows, dtype=torch.int64, device=device)
    if ctx is not None:
        ctx.count(SCAN + ".rows", host.n_rows)
        ctx.count(SCAN + ".bytes", host.decompressed_bytes)
        ctx.count(SCAN + ".read_bytes", host.read_bytes)
        ctx.count(SCAN + ".snappy_chunks", host.snappy_chunks)
        ctx.metric(SCAN, "uploadBytes",
                   host.staging.nbytes + host.tables.nbytes)
        ctx.metric(SCAN, "numOutputRows", host.n_rows)
        ctx.metric(SCAN, "numOutputBatches", 1)
    return ColumnarBatch(tuple(cols), n_rows, host.schema)


def decode_row_group(path: str, row_group: int, schema: T.Schema,
                     meta: Optional[FileMeta] = None, device=None,
                     ctx: Optional[ExecContext] = None) -> ColumnarBatch:
    """Decode one row group of a parquet file into a batch on ``device``
    (the card by default; ``ctx``'s device when a context is given, whose
    timers then split the work into ``ParquetScanExec.read``, ``.parse``,
    ``.decompress``, ``.runs`` (host clock), ``.upload`` and ``.decode``
    (CUDA events on the card), and whose counters take the rows, the
    decompressed and the read bytes, and the SNAPPY chunks, one
    :func:`~.snappy.decompress_pages` call each). Every column of
    ``schema`` is decoded. It is :func:`read_row_group_host` then
    :func:`decode_row_group_device` on the calling thread."""
    return decode_row_group_device(
        read_row_group_host(path, row_group, schema, meta, device, ctx),
        device, ctx)


# -- datetime rebase -----------------------------------------------------------


class SparkUpgradeError(RuntimeError):
    """Ambiguous legacy-calendar datetimes (the SparkUpgradeException the
    reference raises via RebaseHelper.newRebaseExceptionInRead)."""


#: The proleptic / Julian switchover (RebaseDateTime's last switch day
#: and timestamp): dates before 1582-10-15 and timestamps before
#: 1900-01-01 differ between the hybrid and proleptic calendars.
JULIAN_SWITCH_DAYS = (_dt.date(1582, 10, 15) - _dt.date(1970, 1, 1)).days
JULIAN_SWITCH_MICROS = int((_dt.datetime(1900, 1, 1)
                            - _dt.datetime(1970, 1, 1)).total_seconds()
                           ) * 1_000_000
LEGACY_MARKER = b"org.apache.spark.legacyDateTime"


def rebase_guard(meta: FileMeta, schema: T.Schema, mode: str,
                 path: str) -> None:
    """The reference's ``rebase_guard`` (RebaseHelper.scala:60,82): a file
    written with the legacy hybrid calendar (the legacyDateTime key) whose
    date or timestamp statistics reach, or may reach (no statistics),
    below the switchover raises under the default EXCEPTION mode;
    CORRECTED reads the raw values as proleptic; LEGACY raises, since
    this reader never rebases."""
    mode = (mode or "EXCEPTION").upper()
    if mode == "CORRECTED" or LEGACY_MARKER not in meta.key_value_metadata:
        return
    if mode == "LEGACY":
        raise SparkUpgradeError(
            f"{path}: LEGACY datetime rebase is not supported by the parquet "
            "reader. Set spark.sql.legacy.parquet.datetimeRebaseModeInRead="
            "CORRECTED to read raw proleptic values.")
    bounds = {f.name: JULIAN_SWITCH_DAYS if f.data_type is T.DATE
              else JULIAN_SWITCH_MICROS for f in schema
              if f.data_type in (T.DATE, T.TIMESTAMP)}
    for rg in meta.row_groups:
        for c in rg.columns:
            if c.path_in_schema not in bounds:
                continue
            st = c.statistics
            ancient = True      # no statistics: conservative
            if st is not None and st.has_min_max:
                low = int.from_bytes(st.min, "little", signed=True)
                ancient = low < bounds[c.path_in_schema]
            if ancient:
                raise SparkUpgradeError(
                    f"{path}: reading dates before 1582-10-15 or timestamps "
                    "before 1900-01-01T00:00:00Z from parquet files written "
                    "with the legacy hybrid calendar is ambiguous "
                    "(SPARK-31404); this reader does not rebase. Set "
                    "spark.sql.legacy.parquet.datetimeRebaseModeInRead="
                    "CORRECTED to read the raw values as-is.")


# -- the scan exec -------------------------------------------------------------


class ParquetScanExec(TorchExec):
    """The parquet scan (the reference's ``TpuParquetScanExec``): one
    partition per (file, row group) in file order, each one batch decoded
    on the context's device. With ``spark.rapids.tpu.pipeline.enabled``
    (the default) the host phase of the next ``prefetchDepth`` row groups
    runs ahead on the pipeline's shared pool (:mod:`..exec.pipeline`);
    the wait for a row group is ``ParquetScanExec.stall``, the workers'
    time ``ParquetScanExec.busy``. Every column of the files' schema is
    decoded; a project above drops what the query does not read. With
    ``emit_file_meta`` (set by the input-file rewrite) the schema ends in
    the three hidden per-file columns, appended after the decode. A row
    group whose device decode meets a classified device fault, or whose
    ``io.parquet.rowGroup`` site is injected, decodes on the host
    (:func:`decode_row_group_device` on CPU tensors) and is uploaded; a
    file the decoder does not take raises, from the worker unchanged
    (the plan's gate, :func:`device_decodable`, sends such files to the
    host scan). ``footers`` are the files' footers the gate has read
    already (by path); a file without one has its footer read here."""

    def __init__(self, files: List[str], schema: T.Schema,
                 rebase_mode: str = "EXCEPTION",
                 emit_file_meta: bool = False,
                 footers: Optional[Dict[str, FileMeta]] = None):
        self.children = []
        self.files = list(files)
        self._schema = schema
        self.rebase_mode = rebase_mode
        self.emit_file_meta = emit_file_meta
        self.footers = dict(footers or {})

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return (f"ParquetScan [{', '.join(self._schema.names)}] "
                f"files={len(self.files)}")

    def execute(self, ctx):
        units = []
        n_meta = 3 if self.emit_file_meta else 0
        data_schema = T.Schema(list(self._schema)[:len(self._schema)
                                                  - n_meta])
        for path in self.files:
            meta = self.footers.get(path)
            if meta is None:
                with ctx.timed(SCAN + ".parse", host=True):
                    meta = read_footer(path)
            got = schema_from_parquet(meta, path)
            if got != data_schema:
                raise ValueError(f"{path}: schema {got} differs from the "
                                 f"scan's {data_schema}")
            # outside the row-group loop: the ambiguity error is raised
            # before any decode
            rebase_guard(meta, data_schema, self.rebase_mode, path)
            units.extend((path, meta, rg)
                         for rg in range(meta.num_row_groups))

        def read_unit(unit):
            path, meta, rg = unit
            return read_row_group_host(path, rg, data_schema, meta,
                                       ctx=ctx)

        def decode(part, unit):
            from ..memory.retry import Classification, classify
            from ..utils.fault_injection import maybe_inject
            path, meta, rg = unit
            hosts = []
            try:
                hosts = list(part)
                maybe_inject(ctx, "io.parquet.rowGroup")
                batch = decode_row_group_device(hosts[0], ctx=ctx)
                ctx.metric(SCAN, "deviceDecodedRowGroups", 1)
                ctx.count(SCAN + ".deviceDecodedRowGroups", 1)
            except Exception as e:  # noqa: BLE001 - classified below
                if classify(e) == Classification.FATAL:
                    raise
                with ctx.timed(SCAN + ".hostFallback", host=True):
                    host = hosts[0] if hosts else read_row_group_host(
                        path, rg, data_schema, meta, ctx.device)
                    batch = move_batch(decode_row_group_device(
                        host, torch.device("cpu")), ctx.device)
                ctx.metric(SCAN, "hostFallbackRowGroups", 1)
                ctx.count(SCAN + ".hostFallbackRowGroups", 1)
            yield self._with_file_meta(batch, path) if n_meta else batch

        # The host phase of the next row groups runs on the pipeline's
        # workers; the device phase runs here, on the thread that reads
        # the partition, so device work keeps one thread and one stream,
        # in partition order.
        return [decode(part, unit) for part, unit in zip(
            unit_partitions(read_unit, units, ctx, SCAN), units)]

    def _with_file_meta(self, batch: ColumnarBatch,
                        path: str) -> ColumnarBatch:
        """``batch`` with the input-file rewrite's three hidden columns
        (``plan/input_file.py``), constant for the file: its path as a
        one-entry dictionary, block start 0 and block length the file's
        size, as the reference's host scan gives them (the split is the
        whole file)."""
        live = batch.row_mask()
        try:
            size = os.path.getsize(path)
        except OSError:
            size = -1
        cols = batch.columns + (
            dictionary_column(torch.zeros(batch.capacity, dtype=torch.int32,
                                          device=live.device), live,
                              np.array([path], dtype=object),
                              dict_sorted=True),
            scalar_column(0, T.LONG, batch.capacity, live),
            scalar_column(size, T.LONG, batch.capacity, live))
        return ColumnarBatch(cols, batch.n_rows, self._schema,
                             live=batch.live)


def device_decodable(meta: FileMeta, schema: T.Schema,
                     path: str) -> Optional[str]:
    """None when the device decoder takes every column of ``schema`` in
    every row group of the file; else the reason (the plan's gate,
    metadata only: a page-level refusal still raises at decode)."""
    leaves = {leaf.name: leaf for leaf in meta.leaves}
    for f in schema:
        leaf = leaves.get(f.name)
        if leaf is None:
            return f"column {f.name!r} is not in {path}"
        if leaf.max_definition_level > 1 or leaf.max_repetition_level:
            return f"column {f.name!r} is nested"
    names = set(schema.names)
    for rg in meta.row_groups:
        for c in rg.columns:
            if c.path_in_schema not in names:
                continue
            if c.codec not in _CODECS:
                return f"column {c.path_in_schema!r}: codec {c.codec}"
            if c.physical_type not in _PHYS_NP and c.physical_type not in (
                    "BYTE_ARRAY", "BOOLEAN"):
                return (f"column {c.path_in_schema!r}: physical type "
                        f"{c.physical_type}")
            bad = [e for e in c.encodings if e.startswith("DELTA")
                   or e == "BYTE_STREAM_SPLIT"]
            if bad:
                return f"column {c.path_in_schema!r}: encoding {bad[0]}"
    return None


def scan_files(paths: List[str]) -> List[str]:
    """The parquet files behind a scan's paths: a file as it is, a
    directory's ``*.parquet`` files (recursively, sorted, skipping names
    that start with ``_`` or ``.``, as pyarrow's dataset does), hive
    ``key=value`` directories included (:func:`.files.list_files` gives
    their partition values)."""
    from .files import list_files
    return list_files("parquet", paths).files
