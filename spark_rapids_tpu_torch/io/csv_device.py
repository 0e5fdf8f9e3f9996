"""The CSV scan: host boundaries, device parse — port of
``spark_rapids_tpu/io/csv_device.py`` (``_boundaries``, the digit DP,
``decode_file``, ``device_decodable``, ``TpuCsvScanExec``), with the
port's own host reader and schema inference in place of the reference's
pyarrow ones.

* HOST, structure-sized (:func:`boundaries`): one vectorised numpy pass,
  cut into pieces searched on threads, finds the line and field
  boundaries (every separator by ``np.flatnonzero``, read as ``columns``
  a line; blank lines and one column count each line's delimiters by
  ``searchsorted``) without converting a value.
* DEVICE, data-sized, in torch (:func:`decode_file`): the file's bytes
  upload once; each column gathers its byte matrix from the boundaries
  and runs the digit DP: integers accumulate their digits, a double is
  its integer mantissa ``m`` over ``10^f`` (exact, so bit for bit
  strtod's, when ``m`` has at most 15 digits and ``f`` at most 22),
  booleans match pyarrow's spellings, ``YYYY-MM-DD`` dates go through
  the port's text-to-date parser (:mod:`..ops.cast_string`; the
  reference parses them on the host), and strings become a flat column
  over the uploaded bytes. Anything else (exponents, wider mantissas,
  bad digits, overflow, a malformed date) sets a ``bad`` flag, read once
  a batch: the file raises :class:`NotCsvDecodable` and the scan reads
  it on the host instead (site ``io.csv.file``).

Out of the device parse's scope, read on the host: quoted fields (a
quote byte anywhere in the file), ``nullValue``, escapes, ragged rows,
and timestamp columns. The host reader (:func:`read_host`) is
vectorised the same way, with quote parity masking the separators
inside quotes, one column a thread, numbers through the same digit DP
on CPU tensors (numpy's parser for the rest); it is the reference's
pyarrow reader's semantics: an empty field is null (a string's only
with ``nullValue``), blank lines are skipped, ``\\r\\n`` ends a line.
"""

from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import types as T
from ..data.batch import ColumnarBatch, HostBatch
from ..data.column import (DeviceColumn, bucket_byte_capacity,
                           bucket_capacity, string_max_bytes)
from ..exec.execs import TorchExec
from ..ops import cast_string as CS

SCAN = "CsvScanExec"
_INT_TYPES = {"bigint": T.LONG, "int": T.INT, "smallint": T.SHORT,
              "tinyint": T.BYTE}
DEVICE_TYPES = frozenset(set(_INT_TYPES) | {"double", "float", "boolean",
                                            "string", "date"})
#: bytes of the first file that schema inference reads (pyarrow's
#: default block size)
INFER_BYTES = 1 << 20
_TRUE = (b"true", b"True", b"TRUE", b"1")
_FALSE = (b"false", b"False", b"FALSE", b"0")


class NotCsvDecodable(Exception):
    """A file outside the device parse's scope; the scan reads it on the
    host."""


def _quote(options: dict) -> Optional[int]:
    q = options.get("quote", '"')
    return None if q in (False, None, "") else ord(str(q))


def _escape(options: dict) -> Optional[int]:
    e = options.get("escape")
    return ord(str(e)) if e not in (None, False, "") else None


def _header(options: dict) -> bool:
    h = options.get("header", True)
    return h if isinstance(h, bool) else str(h).lower() == "true"


def device_decodable(schema: T.Schema, options: dict) -> Optional[str]:
    """None when the device parse may take files of ``schema`` under
    ``options`` (data-dependent hazards fall back per file); else the
    reason it does not."""
    for f in schema:
        if f.data_type.name not in DEVICE_TYPES:
            return f"column {f.name!r} of type {f.data_type} parses on " \
                   "the host"
    if "nullValue" in options:
        return "the nullValue option parses on the host"
    if _escape(options) is not None:
        return "the escape option parses on the host"
    return None


# -- host: boundaries ---------------------------------------------------------

#: bytes of a file each thread of the separator search takes at least
_SCAN_CHUNK = 1 << 24


def _threads(n_bytes: int) -> int:
    return max(1, min(8, os.cpu_count() or 1, n_bytes // _SCAN_CHUNK))


def separators(buf: np.ndarray, delim: int, quote: Optional[int] = None
               ) -> Tuple[np.ndarray, int, bool]:
    """(every delimiter and newline position, the newlines' count,
    whether ``quote`` occurs): one pass over the bytes, cut into pieces
    searched on threads (numpy releases the GIL in these loops)."""
    def piece(lo: int, hi: int):
        c = buf[lo:hi]
        nl = c == 10
        pos = np.flatnonzero(nl | (c == delim)) + lo
        return (pos, int(np.count_nonzero(nl)),
                quote is not None and bool((c == quote).any()))
    k = _threads(len(buf))
    step = -(-len(buf) // k) if len(buf) else 1
    cuts = [(i * step, min(len(buf), (i + 1) * step)) for i in range(k)]
    if k == 1:
        parts = [piece(*cuts[0])]
    else:
        with ThreadPoolExecutor(k) as ex:
            parts = list(ex.map(lambda c: piece(*c), cuts))
    return (np.concatenate([p for p, _, _ in parts]),
            sum(k for _, k, _ in parts), any(q for _, _, q in parts))


def boundaries(buf: np.ndarray, delim: int, n_cols: int, header: bool,
               inside: Optional[np.ndarray] = None,
               seps: Optional[tuple] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(line starts ``[rows]``, field ends ``[rows, n_cols]``), int64, of
    the non-empty lines (a ``\\r`` before the newline trimmed), the first
    skipped under ``header``; ``inside`` masks bytes inside quotes. Field
    ``j > 0`` starts after field ``j - 1``'s end (:func:`field_starts`).
    One pass finds every separator (:func:`separators`, or ``seps``, its
    result, when the caller has it); when they fall ``n_cols`` a line,
    the last of each a newline and no other one a newline, they are the
    boundaries; otherwise (blank lines, one column) each line's
    delimiters are counted. Raises :class:`NotCsvDecodable` for a line
    of another field count."""
    n_bytes = len(buf)
    empty = (np.zeros(0, np.int64), np.zeros((0, n_cols), np.int64))
    if n_bytes == 0:
        return empty
    if inside is not None:
        sep = ((buf == 10) | (buf == delim)) & ~inside
        pos, newlines = np.flatnonzero(sep), None
    else:
        pos, newlines, _ = seps if seps is not None \
            else separators(buf, delim)
    body = 0
    if header:
        first_nl = np.flatnonzero(buf[pos[:1 << 16]] == 10)
        if not len(first_nl):
            first_nl = np.flatnonzero(buf[pos] == 10)
        if not len(first_nl):
            return empty
        body = int(pos[first_nl[0]]) + 1
        pos = pos[first_nl[0] + 1:]
        newlines = None if newlines is None else newlines - 1
    if buf[-1] != 10 or (inside is not None and inside[-1]):
        pos = np.append(pos, n_bytes)
        newlines = None if newlines is None else newlines + 1
    if n_cols > 1 and len(pos) and len(pos) % n_cols == 0:
        ends = pos.reshape(-1, n_cols)
        last = ends[:, -1]
        line_starts = np.concatenate(([body], last[:-1] + 1))
        # every line ends in a newline and holds no other one, so the
        # rest of its separators are delimiters
        if ((last == n_bytes)
                | (buf[np.minimum(last, n_bytes - 1)] == 10)).all() and \
                (newlines == len(ends) if newlines is not None
                 else (buf[ends[:, :-1]] == delim).all()):
            ends[:, -1] -= (last > line_starts) \
                & (buf[np.maximum(last - 1, 0)] == 13)
            return line_starts, ends
    return _counted_boundaries(buf, delim, n_cols, header, inside)


def _counted_boundaries(buf, delim, n_cols, header, inside):
    n_bytes = len(buf)
    is_nl = buf == 10
    is_dl = buf == delim
    if inside is not None:
        is_nl &= ~inside
        is_dl &= ~inside
    nl = np.flatnonzero(is_nl)
    line_starts = np.concatenate(([0], nl + 1))
    line_ends = np.concatenate((nl, [n_bytes]))
    # the \r goes before the blank-line filter, so "\r\n" is blank too
    crlf = (line_ends > line_starts) \
        & (buf[np.maximum(line_ends - 1, 0)] == 13)
    line_ends = line_ends - crlf
    live = line_starts < line_ends
    line_starts, line_ends = line_starts[live], line_ends[live]
    if header:
        line_starts, line_ends = line_starts[1:], line_ends[1:]
    n = len(line_starts)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros((0, n_cols), np.int64)
    dpos = np.flatnonzero(is_dl)
    first = np.searchsorted(dpos, line_starts)
    count = np.searchsorted(dpos, line_ends) - first
    if not (count == n_cols - 1).all():
        bad = int(np.flatnonzero(count != n_cols - 1)[0])
        raise NotCsvDecodable(f"ragged rows: a line holds "
                              f"{int(count[bad]) + 1} fields, the schema "
                              f"{n_cols}")
    ends = np.empty((n, n_cols), np.int64)
    for j in range(1, n_cols):
        ends[:, j - 1] = dpos[first + (j - 1)]
    ends[:, n_cols - 1] = line_ends
    return line_starts, ends


def field_starts(line_starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Each field's first byte: the line's start, then one past the
    field before."""
    starts = np.empty_like(ends)
    if len(ends):
        starts[:, 0] = line_starts
        starts[:, 1:] = ends[:, :-1] + 1
    return starts


# -- device: the digit DP -------------------------------------------------------


def _parse_int(mat, lens, w):
    neg = mat[:, 0] == 45
    skip = (neg | (mat[:, 0] == 43)).long()
    idx = torch.arange(w, device=mat.device)[None, :]
    digit_pos = (idx < lens[:, None]) & (idx >= skip[:, None])
    d = (mat - 48).long()
    bad_char = digit_pos & ((d < 0) | (d > 9))
    ndig = lens - skip
    has = lens > 0
    bad = bad_char.any(1) | (has & (ndig <= 0)) | (has & (ndig > 18))
    v = torch.zeros(mat.shape[0], dtype=torch.int64, device=mat.device)
    for k in range(w):
        v = torch.where(digit_pos[:, k], v * 10 + d[:, k], v)
    return torch.where(neg, -v, v), has, bad


def _parse_double(mat, lens, w):
    neg = mat[:, 0] == 45
    skip = (neg | (mat[:, 0] == 43)).long()
    idx = torch.arange(w, device=mat.device)[None, :]
    body = (idx < lens[:, None]) & (idx >= skip[:, None])
    is_dot = body & (mat == 46)
    d = (mat - 48).long()
    is_digit = body & (d >= 0) & (d <= 9)
    has = lens > 0
    any_dot = is_dot.any(1)
    dot_at = torch.where(any_dot, is_dot.int().argmax(1).long(), 0)
    frac = torch.where(any_dot, lens - 1 - dot_at, 0)
    ndig = is_digit.sum(1)
    bad = ((body & ~is_digit & ~is_dot).any(1) | (is_dot.sum(1) > 1)
           | (has & (ndig <= 0)) | (ndig > 15) | (frac > 22))
    m = torch.zeros(mat.shape[0], dtype=torch.int64, device=mat.device)
    for k in range(w):
        m = torch.where(is_digit[:, k], m * 10 + d[:, k], m)
    pow10 = torch.tensor([10.0 ** i for i in range(23)], dtype=torch.float64,
                         device=mat.device)
    v = m.double() / pow10[frac.clamp(0, 22)]
    return torch.where(neg, -v, v), has, bad & has


def _parse_bool(mat, lens, w):
    """pyarrow's spellings only: anything else is ``bad``."""
    n = mat.shape[0]

    def word(tokens) -> torch.Tensor:
        hit = torch.zeros(n, dtype=torch.bool, device=mat.device)
        for tok in tokens:
            if len(tok) > w:
                continue
            row = torch.tensor(list(tok), dtype=mat.dtype,
                               device=mat.device)
            hit |= (lens == len(tok)) & (mat[:, :len(tok)] == row).all(1)
        return hit
    t, f = word(_TRUE), word(_FALSE)
    has = lens > 0
    return t, has, has & ~(t | f)


def _parse_date(mat, lens, w):
    """Strict ``YYYY-MM-DD`` (pyarrow's date inference) through
    :func:`~..ops.cast_string.parse_date_matrix`."""
    has = lens > 0
    if w < 10:
        return torch.zeros_like(lens, dtype=torch.int32), has, has
    shape = torch.tensor([45 if k in (4, 7) else -2 for k in range(10)],
                         device=mat.device)
    head = mat[:, :10]
    digit = (head >= 48) & (head <= 57)
    form = torch.where(shape[None, :] == 45, head == 45, digit).all(1)
    days, ok = CS.parse_date_matrix(mat)
    return days, has, has & ~(form & (lens == 10) & ok)


def _decode_slice(dev_buf: torch.Tensor, line_starts: torch.Tensor,
                  ends: torch.Tensor, schema: T.Schema) -> ColumnarBatch:
    """One batch of rows from each line's start and its fields' ends (on
    the device); the fields' longest and total lengths, which size the
    matrices, come to the host in one read."""
    device = dev_buf.device
    n = ends.shape[0]
    cap = bucket_capacity(max(n, 1))
    n_cols = max(len(schema), 1)
    e = torch.zeros((cap, n_cols), dtype=torch.int64, device=device)
    e[:n] = ends
    starts = torch.zeros_like(e)
    starts[:n, 0] = line_starts
    starts[:, 1:] = e[:, :-1] + 1
    live = torch.arange(cap, device=device) < n
    all_lens = torch.where(live[:, None], e - starts, 0)
    longest, totals = torch.stack([all_lens.amax(0), all_lens.sum(0)]) \
        .tolist() if n else ([0] * n_cols, [0] * n_cols)
    last = dev_buf.shape[0] - 1
    cols, bads = [], []
    for j, f in enumerate(schema):
        s = starts[:, j]
        lens = all_lens[:, j]
        name = f.data_type.name
        if name == "string":
            total = totals[j]
            offsets = torch.zeros(cap + 1, dtype=torch.int32, device=device)
            offsets[1:] = torch.cumsum(lens, 0)
            payload = torch.zeros(bucket_byte_capacity(max(total, 1)),
                                  dtype=torch.uint8, device=device)
            if total:
                row = torch.repeat_interleave(
                    torch.arange(cap, device=device), lens,
                    output_size=total)
                pos = torch.arange(total, device=device) \
                    - (offsets[:-1].long())[row] + s[row]
                payload[:total] = dev_buf[pos]
            cols.append(DeviceColumn(payload, live, T.STRING,
                                     offsets=offsets,
                                     max_bytes=string_max_bytes(longest[j])))
            continue
        w = max(longest[j], 1)
        pos = s[:, None] + torch.arange(w, device=device)[None, :]
        in_field = torch.arange(w, device=device)[None, :] < lens[:, None]
        mat = torch.where(in_field, dev_buf[pos.clamp_(0, last)].to(
            torch.int16), torch.full((), CS.PAD, dtype=torch.int16,
                                     device=device))
        if name in _INT_TYPES:
            v, has, bad = _parse_int(mat, lens, w)
            if name != "bigint":
                info = np.iinfo(f.data_type.np_dtype)
                bad = bad | (has & ((v > info.max) | (v < info.min)))
        elif name in ("double", "float"):
            v, has, bad = _parse_double(mat, lens, w)
        elif name == "boolean":
            v, has, bad = _parse_bool(mat, lens, w)
        else:
            v, has, bad = _parse_date(mat, lens, w)
        valid = live & has
        bads.append((bad & live).any())
        cols.append(DeviceColumn(torch.where(valid, v, torch.zeros(
            (), dtype=v.dtype, device=device)).to(f.data_type.torch_dtype),
            valid, f.data_type))
    if bads and bool(torch.stack(bads).any()):  # one sync a batch
        raise NotCsvDecodable("a value outside the digit DP's exact range")
    n_rows = torch.tensor(n, dtype=torch.int64, device=device)
    return ColumnarBatch(tuple(cols), n_rows, schema)


def decode_file(path: str, schema: T.Schema, options: dict, device=None,
                max_rows: int = 1 << 20, ctx=None) -> List[ColumnarBatch]:
    """The file's rows parsed on ``device`` (``ctx``'s when given), one
    batch per ``max_rows``; raises :class:`NotCsvDecodable` when its data
    is out of scope. The bytes and the boundaries upload once each.
    Timers ``CsvScanExec.read``, ``.boundaries`` (host clock),
    ``.upload`` and ``.decode``."""
    from .parquet_device import _no_timer
    if ctx is not None:
        device, timed = ctx.device, ctx.timed
    else:
        device, timed = torch.device(device or "cpu"), _no_timer
    with timed(SCAN + ".read", host=True):
        buf = np.fromfile(path, dtype=np.uint8)
    delim = ord(str(options.get("delimiter", ",")))
    with timed(SCAN + ".boundaries", host=True):
        seps = separators(buf, delim, _quote(options))
        if seps[2]:
            raise NotCsvDecodable("quoted fields")
        line_starts, ends = boundaries(buf, delim, len(schema),
                                       _header(options), seps=seps)
    on_card = device.type == "cuda"
    with timed(SCAN + ".upload"):
        staged = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
            buf if len(buf) else np.zeros(1, np.uint8), line_starts, ends)]
        if on_card:
            staged = [t.pin_memory() for t in staged]
        dev_buf, dev_starts, dev_ends = [
            t.to(device, non_blocking=on_card) for t in staged]
    out = []
    n = len(ends)
    with timed(SCAN + ".decode"):
        for lo in range(0, max(n, 1), max_rows):
            hi = min(lo + max_rows, n)
            out.append(_decode_slice(dev_buf, dev_starts[lo:hi],
                                     dev_ends[lo:hi], schema))
    if ctx is not None:
        ctx.count(SCAN + ".rows", n)
        ctx.count(SCAN + ".read_bytes", len(buf))
        ctx.metric(SCAN, "uploadBytes", sum(t.nbytes for t in staged))
    return out


# -- host reader ---------------------------------------------------------------


def _split(buf: np.ndarray, n_cols: Optional[int], options: dict,
           header: bool):
    """(starts, ends, quoted) ``[rows, n_cols]`` of the host reader: the
    separators inside quotes masked by quote parity, a quoted field's
    quotes dropped. ``n_cols`` None takes the first line's count."""
    quote = _quote(options)
    delim = ord(str(options.get("delimiter", ",")))
    inside = None
    if quote is not None and len(buf):
        q = buf == quote
        esc = _escape(options)
        if esc is not None:
            q[1:] &= buf[:-1] != esc
        if q.any():
            inside = (np.cumsum(q) & 1).astype(bool)
    if n_cols is None:
        nl = np.flatnonzero(buf == 10) if inside is None \
            else np.flatnonzero((buf == 10) & ~inside)
        end = int(nl[0]) if len(nl) else len(buf)
        first = buf[:end]
        dl = first == delim
        if inside is not None:
            dl &= ~inside[:end]
        n_cols = int(dl.sum()) + 1
    try:
        line_starts, ends = boundaries(buf, delim, n_cols, header, inside)
    except NotCsvDecodable as e:
        raise ValueError(f"CSV parse error: {e}") from None
    starts = field_starts(line_starts, ends)
    quoted = np.zeros(starts.shape, bool)
    if inside is not None and starts.size:
        last = max(len(buf) - 1, 0)
        quoted = (ends - starts >= 2) & (buf[starts.clip(0, last)] == quote) \
            & (buf[(ends - 1).clip(0, last)] == quote)
        starts = starts + quoted
        ends = ends - quoted
    return starts, ends, quoted, n_cols


def _field_bytes(buf: np.ndarray, s: np.ndarray, e: np.ndarray,
                 quoted: np.ndarray, options: dict) -> np.ndarray:
    """One column's fields as a numpy bytes (``S``) array; a quoted
    field's doubled quotes and the escapes undone. ``buf`` ends in at
    least the longest field's length of zero bytes."""
    n = len(s)
    lens = e - s
    w = int(lens.max()) if n else 0
    if w == 0:
        return np.zeros(n, dtype="S1")
    # each field's w bytes from a sliding window over the buffer: one
    # copy of n x w bytes, no index matrix
    mat = np.lib.stride_tricks.sliding_window_view(buf, w)[s]
    mat[np.arange(w)[None, :] >= lens[:, None]] = 0
    out = mat.view(f"S{w}")[:, 0]
    quote, esc = _quote(options), _escape(options)
    fix = []
    if quote is not None:
        fix.append(quoted & (lens >= 2))
    if esc is not None:
        fix.append(lens > 0)
    rows = np.flatnonzero(np.any(fix, axis=0)) if fix else []
    if len(rows):
        out = out.astype(object)
        for r in rows:
            v = out[r]
            if quote is not None and quoted[r]:
                qq = bytes([quote])
                v = v.replace(qq + qq, qq)
            if esc is not None:
                v = re.sub(re.escape(bytes([esc])) + b"(.)", rb"\1", v)
            out[r] = v
        out = out.astype(bytes)
    return out


_INT_RE = re.compile(rb"^[+-]?\d+$")
_DATE_RE = re.compile(rb"^\d{4}-\d{2}-\d{2}$")
_TS_RE = re.compile(rb"^\d{4}-\d{2}-\d{2}[ T]\d{2}:\d{2}(:\d{2}(\.\d{1,9})?)?Z?$")


def _is_float(v: bytes) -> bool:
    try:
        float(v)
        return True
    except ValueError:
        return False


def _valid_date(v: bytes) -> bool:
    try:
        np.datetime64(v.decode(), "D")
        return True
    except ValueError:
        return False


def _infer_type(values: List[bytes]) -> T.DataType:
    """pyarrow's inference order over a column's non-null values: int64,
    boolean, date, timestamp, double, string (an all-null column reads as
    string)."""
    if not values:
        return T.STRING
    if all(_INT_RE.match(v) and -(1 << 63) <= int(v) < (1 << 63)
           for v in values):
        return T.LONG
    if all(v in _TRUE or v in _FALSE for v in values):
        return T.BOOLEAN
    if all(_DATE_RE.match(v) and _valid_date(v) for v in values):
        return T.DATE
    if all(_TS_RE.match(v) for v in values):
        return T.TIMESTAMP
    if all(_is_float(v) for v in values):
        return T.DOUBLE
    return T.STRING


def infer_schema(path: str, options: dict) -> T.Schema:
    """The schema of a CSV file as the reference's pyarrow reader infers
    it from the file's first block: the header's names (or ``f0``,
    ``f1``, ...), and each column's type over its non-null values."""
    with open(path, "rb") as f:
        head = f.read(INFER_BYTES)
        more = f.read(1)
    if more:
        cut = head.rfind(b"\n")
        head = head[:cut + 1] if cut >= 0 else head
    buf = np.frombuffer(head, np.uint8)
    header = _header(options)
    starts, ends, quoted, n_cols = _split(buf, None, options, False)
    buf = np.concatenate([buf, np.zeros(
        int((ends - starts).max()) + 1 if ends.size else 1, np.uint8)])
    names = [f"f{j}" for j in range(n_cols)]
    if header and len(starts):
        names = [_field_bytes(buf, starts[:1, j], ends[:1, j],
                              quoted[:1, j], options)[0].decode()
                 for j in range(n_cols)]
        starts, ends, quoted = starts[1:], ends[1:], quoted[1:]
    nulls = {b"", str(options["nullValue"]).encode()} \
        if "nullValue" in options else {b""}
    fields = []
    for j, name in enumerate(names):
        vals = _field_bytes(buf, starts[:, j], ends[:, j], quoted[:, j],
                            options)
        uniq = [v for v in set(vals.tolist()) if v not in nulls]
        fields.append(T.StructField(name, _infer_type(uniq), True))
    return T.Schema(fields)


def _convert(raw: np.ndarray, dtype: T.DataType, null: np.ndarray):
    """(values, validity) of one column's field bytes."""
    valid = ~null
    filled = np.where(valid, raw, b"0")
    name = dtype.name
    if name in _INT_TYPES or name in ("double", "float"):
        # the device parse's digit DP on CPU tensors, then numpy's parser
        # for the fields outside its exact range (exponents, wide
        # mantissas) or its syntax (which raise there)
        w = filled.dtype.itemsize
        mat = filled.view(np.uint8).reshape(-1, w)
        lens = torch.from_numpy((mat != 0).sum(1))
        m = torch.from_numpy(mat.astype(np.int16))
        m[m == 0] = CS.PAD
        floating = name in ("double", "float")
        v, _, bad = (_parse_double if floating else _parse_int)(m, lens, w)
        vals = v.numpy()
        bad = bad.numpy() & valid
        if bad.any():
            try:
                vals[bad] = filled[bad].astype(vals.dtype)
            except (ValueError, OverflowError) as e:
                raise ValueError(f"CSV conversion error to {dtype}: {e}") \
                    from None
        return vals.astype(dtype.np_dtype), valid
    if name == "boolean":
        t = np.isin(filled, _TRUE)
        if not (t | np.isin(filled, _FALSE) | null).all():
            raise ValueError("CSV conversion error to boolean")
        return t, valid
    if name == "date":
        days = np.where(valid, raw, b"1970-01-01").astype("datetime64[D]")
        return days.view(np.int64).astype(np.int32), valid
    if name == "timestamp":
        text = np.char.rstrip(np.where(valid, raw, b"1970-01-01"), b"Z")
        us = text.astype("datetime64[us]")
        return us.view(np.int64), valid
    # distinct values decoded once
    uniq, codes = np.unique(np.where(valid, raw, b""), return_inverse=True)
    text = np.array([u.decode("utf-8", "replace") for u in uniq.tolist()],
                    dtype=object)
    return text[codes.reshape(-1)], valid


def read_host(path: str, schema: T.Schema, options: dict) -> HostBatch:
    """The port's host CSV reader: every row of ``path`` as ``schema``'s
    columns (in file order), vectorised in numpy."""
    buf = np.fromfile(path, dtype=np.uint8)
    starts, ends, quoted, _ = _split(buf, len(schema), options,
                                     _header(options))
    longest = int((ends - starts).max()) if ends.size else 0
    buf = np.concatenate([buf, np.zeros(longest + 1, np.uint8)])
    null_value = options.get("nullValue")

    def column(j: int):
        f = schema[j]
        raw = _field_bytes(buf, starts[:, j], ends[:, j], quoted[:, j],
                           options)
        null = raw == b""
        if f.data_type is T.STRING:
            null = null & (null_value is not None)
        if null_value is not None:
            null = null | (raw == str(null_value).encode())
        return _convert(raw, f.data_type, null)
    # one column a thread: the byte gathers and conversions release the
    # GIL for most of their time
    with ThreadPoolExecutor(_threads(len(buf)) if len(schema) > 1
                            else 1) as ex:
        pairs = list(ex.map(column, range(len(schema))))
    if not len(starts):
        return HostBatch.empty(schema)
    return HostBatch.from_positional(schema, pairs)


# -- the scan exec -------------------------------------------------------------


class CsvScanExec(TorchExec):
    """The CSV scan (the reference's ``TpuCsvScanExec``): one partition
    per file, in file order, parsed on the context's device in batches of
    at most ``spark.rapids.sql.reader.batchSizeRows`` rows. A file the
    parse does not take (:class:`NotCsvDecodable`), that meets a
    classified device fault, or whose ``io.csv.file`` site is injected,
    is read on the host and uploaded (``hostFallbackFiles``; parsed ones
    count ``deviceDecodedFiles``)."""

    def __init__(self, files: List[str], schema: T.Schema, options: dict):
        self.children = []
        self.files = list(files)
        self._schema = schema
        self.options = dict(options)

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return (f"CsvScan [{', '.join(self._schema.names)}] "
                f"files={len(self.files)}")

    def execute(self, ctx):
        from ..config import MAX_READ_BATCH_SIZE_ROWS
        from ..memory.retry import Classification, classify
        from ..utils.fault_injection import maybe_inject
        max_rows = int(ctx.conf.get(MAX_READ_BATCH_SIZE_ROWS))

        def read(path):
            try:
                maybe_inject(ctx, "io.csv.file")
                batches = decode_file(path, self._schema, self.options,
                                      max_rows=max_rows, ctx=ctx)
                ctx.metric(SCAN, "deviceDecodedFiles", 1)
                ctx.count(SCAN + ".deviceDecodedFiles", 1)
            except Exception as e:  # noqa: BLE001 - classified below
                if not isinstance(e, NotCsvDecodable) \
                        and classify(e) == Classification.FATAL:
                    raise
                with ctx.timed(SCAN + ".hostFallback", host=True):
                    hb = read_host(path, self._schema, self.options)
                    batches = [hb.to_device(ctx.device)]
                ctx.metric(SCAN, "hostFallbackFiles", 1)
                ctx.count(SCAN + ".hostFallbackFiles", 1)
            for b in batches:
                ctx.metric(SCAN, "numOutputBatches", 1)
                yield b

        return [read(p) for p in self.files]

