"""File writers — port of ``spark_rapids_tpu/io/writers.py`` (the
reference's ``GpuFileFormatWriter`` stack analog): ``MODES``,
``prepare_target``, ``WriteStats``, ``STATS_SCHEMA``,
``_escape_path_name``, ``run_boundaries``, ``CpuWriteFilesExec`` and the
device writer, ``TpuWriteFilesExec`` here :class:`WriteFilesExec`.

A job applies its save mode once (error, overwrite, append, ignore),
writes one file per input batch (``part-<task>-<job>-<n>.<ext>``), a
``key=value`` directory per partition value under ``partitionBy`` (the
value escaped as Spark's ``escapePathName``, a null as
``__HIVE_DEFAULT_PARTITION__``), the ``_SUCCESS`` marker, and returns
one row: files, partitions, rows and bytes (the written files' sizes).

The encoders are the port's own:

* parquet: :func:`.parquet_encode.write_device_batch` (SNAPPY by
  default; ``compression`` none, snappy or gzip), on the card for the
  device writer;
* ORC: :func:`.orc_encode.write_orc` (``compression`` none, the
  reference's default, zlib or snappy);
* CSV: :func:`csv_text`, vectorised: a header (``header``, default on),
  the ``delimiter``, nulls as empty fields, integers and ISO dates,
  booleans as ``true``/``false``, and each double as the fewest decimals
  that read back to its bits (``m / 10^d``, exactly the device parse's
  arithmetic), else its shortest ``repr``; a string holding the
  delimiter, a quote or a newline is quoted, its quotes doubled.

The device writer's dynamic partitions sort by the partition keys on the
card (:func:`..ops.kernels.rowops.sort_batch_by_columns`: one dictionary
key sorts through ``sortStep``), read only the sorted keys back to find
the runs, and write each run: parquet slices the run on the card and
encodes it there, ORC and CSV encode the downloaded rows.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import types as T
from ..data.batch import ColumnarBatch, HostBatch
from ..plan.physical import HostExec
from .orc_encode import EncColumn, columns_from_host, write_orc

#: Spark's save modes.
MODES = ("error", "overwrite", "append", "ignore")
_EXT = {"parquet": "parquet", "orc": "orc", "csv": "csv"}
_PARQUET_CODECS = ("none", "uncompressed", "snappy", "gzip")
_ORC_CODECS = ("none", "uncompressed", "zlib", "snappy")
#: rows a CSV text chunk holds
CSV_CHUNK_ROWS = 1 << 20


@dataclasses.dataclass
class WriteStats:
    """The job's stats (``BasicColumnarWriteStatsTracker``)."""
    files: int = 0
    partitions: int = 0
    rows: int = 0
    bytes: int = 0

    def to_batch(self) -> HostBatch:
        return HostBatch.from_numpy(
            {k: np.array([getattr(self, k)], np.int64)
             for k in ("files", "partitions", "rows", "bytes")},
            STATS_SCHEMA)


STATS_SCHEMA = T.Schema([T.StructField("files", T.LONG, False),
                         T.StructField("partitions", T.LONG, False),
                         T.StructField("rows", T.LONG, False),
                         T.StructField("bytes", T.LONG, False)])

#: Characters Spark escapes in partition directory names
#: (``ExternalCatalogUtils.escapePathName``).
_ESCAPE_CHARS = set('"#%\'*/:=?\\{[]^\x7f') | {chr(c) for c in range(0x20)}


def _escape_path_name(s: str) -> str:
    return "".join(f"%{ord(c):02X}" if c in _ESCAPE_CHARS else c for c in s)


def _partition_dir_value(v, dtype: T.DataType) -> str:
    if v is None:
        return "__HIVE_DEFAULT_PARTITION__"
    if dtype is T.BOOLEAN:
        return "true" if v else "false"
    if dtype is T.DATE:
        return str(np.datetime64(int(v), "D"))
    if dtype.is_floating:
        return _escape_path_name(repr(float(v)))
    if dtype.is_integral:
        return str(int(v))
    return _escape_path_name(str(v))


def check_options(fmt: str, options: dict) -> None:
    """Refuse a codec the port's encoders do not write, before the save
    mode touches the target."""
    c = options.get("compression")
    if c is None:
        return
    allowed = {"parquet": _PARQUET_CODECS, "orc": _ORC_CODECS}.get(fmt)
    if allowed is not None and str(c).lower() not in allowed:
        raise NotImplementedError(
            f"{fmt} compression {c!r} is not supported (the port writes "
            f"{', '.join(allowed)})")


def prepare_target(path: str, mode: str) -> bool:
    """Apply the save mode; False when the write is skipped (``ignore``
    on an existing target)."""
    assert mode in MODES, mode
    exists = os.path.exists(path) and (not os.path.isdir(path)
                                       or bool(os.listdir(path)))
    if exists:
        if mode == "error":
            raise FileExistsError(
                f"path {path} already exists (SaveMode.ErrorIfExists)")
        if mode == "ignore":
            return False
        if mode == "overwrite":
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                os.remove(path)
    os.makedirs(path, exist_ok=True)
    return True


def run_boundaries(keys: List[tuple], n: int) -> List[int]:
    """Where any sorted partition-key column (``(values, validity)``)
    changes: ``[0, ..., n]``; two nulls are equal."""
    if n == 0:
        return [0]
    changed = np.zeros(n - 1, bool)
    for vals, ok in keys:
        vals, ok = np.asarray(vals), np.asarray(ok, bool)
        diff = (vals[1:] != vals[:-1]) & ok[1:] & ok[:-1]
        changed |= diff | (ok[1:] != ok[:-1])
    return [0] + (np.flatnonzero(changed) + 1).tolist() + [n]


# -- CSV text ---------------------------------------------------------------------
#
# A column's text is a list of pieces, each a uint8 matrix (a row's bytes
# in a fixed width) and a mask of the bytes to emit; a chunk's lines are
# every piece side by side, the masked bytes taken in row order.


def _digits(a: np.ndarray, width: int) -> np.ndarray:
    """uint8 ``[n, width]``: ``a`` (non-negative int64) in decimal, right
    aligned, zero padded."""
    out = np.empty((len(a), width), np.uint8)
    x = a.copy()
    for j in range(width - 1, -1, -1):
        out[:, j] = x % 10 + 48
        x //= 10
    return out


_POWERS = 10 ** np.arange(1, 19, dtype=np.int64)


def _n_digits(a: np.ndarray) -> np.ndarray:
    """Decimal digits of each non-negative int64 (at least 1)."""
    return np.searchsorted(_POWERS, a, side="right") + 1


def _right(a: np.ndarray, show: np.ndarray) -> tuple:
    """The piece of ``a``'s digits (non-negative), right aligned, shown
    where ``show``."""
    nd = _n_digits(a)
    w = int(nd.max()) if len(a) else 1
    idx = np.arange(w)[None, :]
    return _digits(a, w), show[:, None] & (idx >= (w - nd)[:, None])


def _full(mat: np.ndarray, show: np.ndarray) -> tuple:
    """The piece of every byte of ``mat``'s rows, shown where ``show``."""
    return mat, np.repeat(show[:, None], mat.shape[1], axis=1)


def _byte(ch: int, show: np.ndarray) -> tuple:
    return np.full((len(show), 1), ch, np.uint8), show[:, None]


def _texts(texts: List[bytes], show: np.ndarray) -> tuple:
    """The piece of one byte string a row (left aligned)."""
    lens = np.array([len(t) for t in texts], np.int64)
    w = max(int(lens.max()) if len(lens) else 1, 1)
    mat = np.array(texts, dtype=f"S{w}").view(np.uint8).reshape(-1, w)
    return mat, show[:, None] & (np.arange(w)[None, :] < lens[:, None])


def _int_pieces(v: np.ndarray, valid: np.ndarray) -> list:
    v = v.astype(np.int64)
    if len(v) and v.min() == np.iinfo(np.int64).min:
        return [_texts([str(x).encode() for x in v.tolist()], valid)]
    neg = v < 0
    return [_byte(45, valid & neg), _right(np.abs(v), valid)]


def _float_pieces(v: np.ndarray, valid: np.ndarray) -> list:
    """Each double as its fewest decimals ``d`` (1 to 15) with
    ``rint(x * 10^d) / 10^d == x`` (so the text's ``m / 10^d`` is its
    bits), else (NaN, infinities, -0.0, wider values) its ``repr``."""
    x = v.astype(np.float64)
    n = len(x)
    d = np.zeros(n, np.int64)
    c = np.zeros(n, np.int64)
    todo = np.isfinite(x) & ~((x == 0) & np.signbit(x))
    for k in range(1, 16):
        if not todo.any():
            break
        ck = np.rint(x[todo] * 10.0 ** k)
        ok = (np.abs(ck) < 2 ** 53) & (ck / 10.0 ** k == x[todo])
        rows = np.flatnonzero(todo)[ok]
        d[rows] = k
        c[rows] = ck[ok].astype(np.int64)
        todo[rows] = False
    fixed = valid & (d > 0)
    a = np.abs(c)
    p10 = 10 ** d
    frac = a % p10
    wf = max(int(d.max()), 1)
    idx = np.arange(wf)[None, :]
    pieces = [_byte(45, fixed & (c < 0)), _right(a // p10, fixed),
              _byte(46, fixed),
              (_digits(frac, wf), fixed[:, None] & (idx >= (wf - d)[:, None]))]
    wide = valid & (d == 0)
    if wide.any():
        texts = [b""] * n
        for r in np.flatnonzero(wide).tolist():
            texts[r] = repr(float(x[r])).encode()
        pieces.append(_texts(texts, wide))
    return pieces


def _civil(days: np.ndarray) -> tuple:
    """(year, month, day) of days since 1970-01-01, proleptic Gregorian
    (H. Hinnant's ``civil_from_days``)."""
    z = days + 719468
    era = np.floor_divide(z, 146097)
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = np.where(mp < 10, mp + 3, mp - 9)
    return yoe + era * 400 + (m <= 2), m, d


def _needs_quote(data: bytes, delim: bytes) -> bool:
    return any(c in data for c in (delim, b'"', b"\n", b"\r"))


def _quoted(data: bytes) -> bytes:
    return b'"' + data.replace(b'"', b'""') + b'"'


def _string_pieces(col: EncColumn, valid: np.ndarray, delim: bytes) -> list:
    if col.codes is None:
        specials = np.isin(col.payload, np.frombuffer(
            delim + b'"\n\r', np.uint8))
        if not specials.any():
            starts = col.offsets[:-1].astype(np.int64)
            lens = (col.offsets[1:] - col.offsets[:-1]).astype(np.int64)
            w = max(int(lens.max()) if len(lens) else 1, 1)
            padded = np.concatenate([col.payload, np.zeros(w, np.uint8)])
            mat = np.lib.stride_tricks.sliding_window_view(padded, w)[starts]
            return [(mat, valid[:, None]
                     & (np.arange(w)[None, :] < lens[:, None]))]
        col = col.as_dictionary()
    entries = [str(s).encode("utf-8", "surrogateescape")
               for s in col.dictionary] or [b""]
    entries = [_quoted(e) if _needs_quote(e, delim) else e for e in entries]
    emat, emask = _texts(entries, np.ones(len(entries), bool))
    codes = np.clip(np.asarray(col.codes, np.int64), 0, len(entries) - 1)
    return [(emat[codes], emask[codes] & valid[:, None])]


def _column_pieces(col: EncColumn, delim: bytes) -> list:
    """The pieces of one column's text; nulls are empty."""
    dt = col.dtype
    valid = np.asarray(col.valid, bool)
    if dt is T.STRING:
        return _string_pieces(col, valid, delim)
    vals = np.asarray(col.values)
    if dt is T.BOOLEAN:
        words, mask = _texts([b"false", b"true"], np.ones(2, bool))
        pick = vals.astype(bool).astype(np.int64)
        return [(words[pick], mask[pick] & valid[:, None])]
    if dt is T.DATE:
        y, m, d = _civil(vals.astype(np.int64))
        if len(y) and 0 <= y.min() and y.max() <= 9999:
            dash = _byte(45, valid)
            return [_full(_digits(y, 4), valid), dash,
                    _full(_digits(m, 2), valid), dash,
                    _full(_digits(d, 2), valid)]
    if dt in (T.DATE, T.TIMESTAMP):
        # ISO text; the width leaves room for a sign and a fifth year digit
        unit, w = ("D", 12) if dt is T.DATE else ("us", 28)
        text = vals.astype(np.int64).astype(f"datetime64[{unit}]").astype(
            f"S{w}")
        mat = text.view(np.uint8).reshape(-1, w)
        return [(mat, valid[:, None] & (mat != 0))]
    if dt.is_floating:
        return _float_pieces(vals, valid)
    return _int_pieces(vals, valid)


def csv_text(names: List[str], columns: List[EncColumn], header: bool,
             delimiter: str = ",") -> List[bytes]:
    """The CSV text of ``columns``, in pieces of at most
    :data:`CSV_CHUNK_ROWS` rows."""
    delim = delimiter.encode()
    out = []
    if header:
        out.append(delim.join(
            _quoted(n.encode()) if _needs_quote(n.encode(), delim)
            else n.encode() for n in names) + b"\n")
    n = len(columns[0]) if columns else 0

    def chunk(lo: int) -> bytes:
        hi = min(lo + CSV_CHUNK_ROWS, n)
        every = np.ones(hi - lo, bool)
        pieces = []
        for j, c in enumerate(columns):
            pieces += _column_pieces(c.slice(lo, hi), delim)
            pieces.append(_byte(delim[0] if j < len(columns) - 1 else 10,
                                every))
        mats = np.concatenate([m for m, _ in pieces], axis=1)
        masks = np.concatenate([k for _, k in pieces], axis=1)
        return mats[masks].tobytes()
    # chunks on threads (numpy releases the GIL in most of the work), in
    # order
    starts = list(range(0, n, CSV_CHUNK_ROWS))
    with ThreadPoolExecutor(max(1, min(len(starts), 8,
                                       os.cpu_count() or 1))) as ex:
        out += list(ex.map(chunk, starts))
    return out


# -- encoding one file ----------------------------------------------------------


def enc_columns(batch: ColumnarBatch) -> List[EncColumn]:
    """A device batch's live rows as :class:`EncColumn` on the host: one
    download a lane; a dictionary string keeps its dictionary and codes,
    a flat one its payload and offsets."""
    from ..ops.kernels import rowops as KR
    batch = KR.physical(batch)
    n = int(batch.n_rows)
    out = []
    for f, c in zip(batch.schema, batch.columns):
        ok = c.validity[:n].cpu().numpy()
        if c.is_dict:
            out.append(EncColumn(f.name, f.data_type, ok,
                                 dictionary=c.dictionary,
                                 codes=c.codes[:n].cpu().numpy()))
        elif c.is_flat:
            offsets = c.offsets[:n + 1].cpu().numpy().astype(np.int64)
            out.append(EncColumn(f.name, f.data_type, ok,
                                 payload=c.data[:int(offsets[-1])]
                                 .cpu().numpy(), offsets=offsets))
        elif c.is_complex:
            raise NotImplementedError(f"column {f.name!r}: type "
                                      f"{f.data_type} is not writable")
        else:
            out.append(EncColumn(f.name, f.data_type, ok,
                                 values=c.data[:n].cpu().numpy()))
    return out


def _write_enc(fmt: str, path: str, names: List[str],
               columns: List[EncColumn], options: dict, device) -> int:
    if fmt == "orc":
        return write_orc(path, columns, options.get("compression") or "none",
                         device=device)
    header = options.get("header", True)
    header = header if isinstance(header, bool) \
        else str(header).lower() == "true"
    with open(path, "wb") as f:
        for piece in csv_text(names, columns, header,
                              str(options.get("delimiter", ","))):
            f.write(piece)
    return os.path.getsize(path)


def _parquet_codec(options: dict) -> str:
    return str(options.get("compression") or "snappy").lower()


def _write_parquet(batch: ColumnarBatch, path: str, options: dict,
                   device) -> int:
    """``batch`` as one parquet file, encoded on ``device``: as it is when
    the encoder takes it, else through its host rows (a flat string
    column becomes a dictionary column)."""
    from .parquet_encode import NotDeviceEncodable, write_device_batch
    try:
        return write_device_batch(batch, path, _parquet_codec(options))
    except NotDeviceEncodable:
        hb = HostBatch.from_device(batch)
        return write_device_batch(hb.to_device(device), path,
                                  _parquet_codec(options))


class _WriteFilesBase(HostExec):
    """The job skeleton shared by the host and the device writer."""

    def __init__(self, child, fmt: str, path: str, options: Dict,
                 partition_by: List[str], mode: str):
        self.children = [child]
        self.fmt = fmt
        self.path = path
        self.options = dict(options)
        self.partition_by = list(partition_by)
        self.mode = mode
        # unique per job, so an append never meets an earlier job's names
        self._job_id = uuid.uuid4().hex[:8]
        self._prepared: Optional[bool] = None
        self._emitted: set = set()

    @property
    def schema(self):
        return STATS_SCHEMA

    def describe(self):
        extra = f" partitionBy={self.partition_by}" if self.partition_by \
            else ""
        return f"{self.node_name()} {self.fmt} {self.path}{extra}"

    def _prepare_once(self) -> bool:
        """Apply the save mode once per plan: a re-run attempt (a retry or
        a dense-mode escalation) deletes the files of the attempt before
        instead of applying the mode again."""
        check_options(self.fmt, self.options)
        if self._prepared is None:
            self._prepared = prepare_target(self.path, self.mode)
        elif self._prepared:
            for p in self._emitted:
                try:
                    os.remove(p)
                except OSError:
                    pass
            self._emitted.clear()
        return self._prepared

    @property
    def _data_names(self) -> List[str]:
        return [n for n in self.children[0].schema.names
                if n not in self.partition_by]

    def _target(self, task: int, file_no: int, subdir: str) -> str:
        os.makedirs(subdir, exist_ok=True)
        return os.path.join(subdir, f"part-{task:05d}-{self._job_id}-"
                            f"{file_no:03d}.{_EXT[self.fmt]}")

    def _subdir(self, key_values: tuple) -> str:
        dtypes = [self.children[0].schema[c].data_type
                  for c in self.partition_by]
        return os.path.join(self.path, *(
            f"{c}={_partition_dir_value(v, dt)}"
            for c, v, dt in zip(self.partition_by, key_values, dtypes)))

    def _done(self, target: str, nbytes: int, rows: int,
              stats: WriteStats) -> None:
        self._emitted.add(target)
        stats.files += 1
        stats.rows += rows
        stats.bytes += nbytes

    def _finish(self, stats: WriteStats, dirs: set, ctx) -> list:
        stats.partitions = len(dirs)
        open(os.path.join(self.path, "_SUCCESS"), "w").close()
        name = self.node_name()
        ctx.metric(name, "numOutputRows", stats.rows)
        ctx.metric(name, "bytesWritten", stats.bytes)
        ctx.metric(name, "numFiles", stats.files)
        return [iter([stats.to_batch()])]


def _key_tuple(keys: List[tuple], i: int) -> tuple:
    out = []
    for vals, ok in keys:
        v = vals[i]
        out.append(None if not ok[i] else
                   (v.item() if hasattr(v, "item") else v))
    return tuple(out)


class CpuWriteFilesExec(_WriteFilesBase):
    """The host writer job: one file per input batch (a file per
    partition value of it under ``partitionBy``, its rows grouped by a
    stable sort of the keys)."""

    def execute(self, ctx):
        stats = WriteStats()
        if not self._prepare_once():
            return [iter([stats.to_batch()])]
        dirs: set = set()
        task = 0
        for part in self.children[0].execute(ctx):
            for hb in part:
                if hb.num_rows == 0:
                    continue
                with ctx.timed(self.node_name(), host=True):
                    self._write_batch(hb, task, stats, dirs)
                task += 1
        return self._finish(stats, dirs, ctx)

    def _encode(self, hb: HostBatch, target: str) -> int:
        if self.fmt == "parquet":
            return _write_parquet(hb.to_device("cpu"), target, self.options,
                                  "cpu")
        return _write_enc(self.fmt, target, hb.schema.names,
                          columns_from_host(hb), self.options, "cpu")

    def _write_batch(self, hb: HostBatch, task: int, stats: WriteStats,
                     dirs: set) -> None:
        names = self._data_names
        data = HostBatch.from_positional(
            T.Schema([hb.schema[n] for n in names]),
            [(hb.columns[n], hb.validity[n]) for n in names])
        if not self.partition_by:
            target = self._target(task, 0, self.path)
            self._done(target, self._encode(data, target), hb.num_rows,
                       stats)
            return
        keys = [(hb.columns[c], hb.validity[c]) for c in self.partition_by]
        operands = []
        for v, ok in reversed(keys):
            ok = np.asarray(ok, bool)
            v = np.where(ok, v, "").astype(str) if v.dtype == object \
                else np.where(ok, v, np.zeros((), v.dtype))
            operands += [v, ok]
        order = np.lexsort(operands)
        keys = [(v[order], ok[order]) for v, ok in keys]
        bounds = run_boundaries(keys, hb.num_rows)
        for file_no, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
            idx = order[lo:hi]
            piece = HostBatch.from_positional(data.schema, [
                (v[idx], ok[idx]) for v, ok in
                (data.column_at(i) for i in range(len(names)))])
            subdir = self._subdir(_key_tuple(keys, lo))
            dirs.add(subdir)
            target = self._target(task, file_no, subdir)
            self._done(target, self._encode(piece, target), hi - lo, stats)


class WriteFilesExec(_WriteFilesBase):
    """The device writer (the reference's ``TpuWriteFilesExec``): it reads
    device batches and returns the host stats row. Under
    ``partitionBy`` each batch sorts by the keys on the card and each
    key run becomes a file of its directory; parquet encodes on the
    card, ORC and CSV from the downloaded rows. Its time is
    ``WriteFilesExec`` in ``exec_ms`` (with ``.sort`` and ``.encode``)."""

    #: consumes device batches (the transitions read this)
    children_columnar = True
    children_coalesce_goals = ["target"]

    def execute(self, ctx):
        from ..ops.kernels import rowops as KR
        name = self.node_name()
        stats = WriteStats()
        if not self._prepare_once():
            return [iter([stats.to_batch()])]
        schema = self.children[0].schema
        data_idx = [schema.index_of(n) for n in self._data_names]
        key_idx = [schema.index_of(c) for c in self.partition_by]
        data_schema = T.Schema([schema[i] for i in data_idx])
        dirs: set = set()
        task = 0
        for part in self.children[0].execute(ctx):
            for db in part:
                if int(db.n_rows) == 0:
                    continue
                if key_idx:
                    with ctx.timed(name + ".sort"):
                        keys = [db.columns[i] for i in key_idx]
                        db = KR.sort_batch_by_columns(
                            db, keys, [True] * len(keys), [True] * len(keys))
                with ctx.timed(name + ".encode", host=True):
                    self._write_device_batch(db, data_idx, key_idx,
                                             data_schema, task, stats, dirs,
                                             ctx.device)
                task += 1
        return self._finish(stats, dirs, ctx)

    def _write_device_batch(self, db, data_idx, key_idx, data_schema, task,
                            stats, dirs, device) -> None:
        data = ColumnarBatch(tuple(db.columns[i] for i in data_idx),
                             db.n_rows, data_schema, live=db.live)
        n = int(db.n_rows)
        if not key_idx:
            target = self._target(task, 0, self.path)
            self._done(target, self._encode(data, target, device), n, stats)
            return
        key_batch = ColumnarBatch(tuple(db.columns[i] for i in key_idx),
                                  db.n_rows, T.Schema(
                                      [db.schema[i] for i in key_idx]))
        kh = HostBatch.from_device(key_batch)
        keys = [kh.column_at(i) for i in range(len(key_idx))]
        bounds = run_boundaries(keys, n)
        cols = enc_columns(data) if self.fmt != "parquet" else None
        for file_no, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
            subdir = self._subdir(_key_tuple(keys, lo))
            dirs.add(subdir)
            target = self._target(task, file_no, subdir)
            if cols is None:
                nbytes = self._encode(_rows(data, lo, hi), target, device)
            else:
                nbytes = _write_enc(self.fmt, target, data_schema.names,
                                    [c.slice(lo, hi) for c in cols],
                                    self.options, device)
            self._done(target, nbytes, hi - lo, stats)

    def _encode(self, data: ColumnarBatch, target: str, device) -> int:
        if self.fmt == "parquet":
            return _write_parquet(data, target, self.options, device)
        return _write_enc(self.fmt, target, data.schema.names,
                          enc_columns(data), self.options, device)


def _rows(batch: ColumnarBatch, lo: int, hi: int) -> ColumnarBatch:
    """Rows ``[lo, hi)`` of a physical device batch, gathered on the
    device into a batch of their own."""
    from ..compile.ladder import bucket_capacity
    from ..ops.kernels import rowops as KR
    cap = bucket_capacity(max(hi - lo, 1))
    iota = torch.arange(cap, device=batch.device)
    cols = KR.gather_columns(batch.columns, lo + iota, iota < hi - lo)
    return ColumnarBatch(cols, torch.tensor(hi - lo, dtype=torch.int64,
                                            device=batch.device),
                         batch.schema)
