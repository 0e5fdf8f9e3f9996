"""File sources on the host — port of ``spark_rapids_tpu/io/files.py``
(``infer_schema``, ``_validate_csv_options``, ``CpuFileScanExec``),
without pyarrow.

:func:`list_files` lists a scan's files: a file as it is, a directory's
files of the format (recursively, sorted, names starting with ``_`` or
``.`` skipped), and a hive layout's ``key=value`` directories as
partition columns, typed as the reference's pyarrow dataset types them
(``int`` when every value is a 32-bit integer, else ``string``;
``__HIVE_DEFAULT_PARTITION__`` is null; values are percent-decoded).
:func:`infer_schema` types a scan from its first file: the parquet
footer, the ORC tail's types, or the CSV reader's inference
(:func:`.csv_device.infer_schema`), then the partition columns.

:class:`CpuFileScanExec` is the CPU plan's scan: one partition per file,
each yielding host batches of at most
``spark.rapids.sql.reader.batchSizeRows`` rows and about
``batchSizeBytes`` bytes, from the port's host readers (parquet row
groups and ORC stripes decoded on CPU tensors (the decoders of
:mod:`.parquet_device` and :mod:`.orc_device`, their dictionary strings
kept as numpy ``str`` arrays, :func:`host_rows`); CSV through
:func:`.csv_device.read_host`), with the partition columns and, under
``emit_file_meta``, the input-file columns appended; it counts the
files' sizes as ``CpuFileScanExec.read_bytes``. The overrides pass
(:mod:`..plan.overrides`) swaps it for the device scan of its format
when that takes every file. ``pushed_filters`` is kept as the
reference's field is; no planner fills it (ROADMAP A7).
"""

from __future__ import annotations

import dataclasses
import os
import re
import urllib.parse
from typing import List, Optional

import numpy as np

from .. import types as T
from ..data.batch import HostBatch
from ..plan.physical import HostExec

_EXT = {"parquet": ".parquet", "orc": ".orc", "csv": ".csv"}
HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"
_INT32 = re.compile(r"^-?\d+$")


@dataclasses.dataclass
class FileListing:
    """A scan's files and, for a hive layout, each file's partition
    values (in ``part_fields`` order)."""
    files: List[str]
    part_fields: List[T.StructField]
    part_values: List[tuple]


def _walk(root: str, ext: str, keys: tuple, out: list) -> None:
    for name in sorted(os.listdir(root)):
        if name.startswith(("_", ".")):
            continue
        full = os.path.join(root, name)
        if os.path.isdir(full):
            if "=" in name:
                k, v = name.split("=", 1)
                _walk(full, ext, keys + ((k, urllib.parse.unquote(v)),),
                      out)
            else:
                _walk(full, ext, keys, out)
        elif name.endswith(ext):
            out.append((full, keys))


def _partition_type(values) -> T.DataType:
    vals = [v for v in values if v is not None]
    if vals and all(_INT32.match(v) and -(1 << 31) <= int(v) < (1 << 31)
                    for v in vals):
        return T.INT
    return T.STRING


def list_files(fmt: str, paths: List[str]) -> FileListing:
    """The files of ``fmt`` behind ``paths`` (see the module doc)."""
    ext = _EXT[fmt]
    found = []
    for p in paths:
        if os.path.isdir(p):
            sub: list = []
            _walk(p, ext, (), sub)
            found.extend(sorted(sub))
        elif os.path.exists(p):
            found.append((p, ()))
        else:
            raise FileNotFoundError(p)
    # a file outside a key's directories has a null value for it
    names = []
    for _, keys in found:
        names += [k for k, _ in keys if k not in names]
    raw = [[dict(keys).get(k, HIVE_NULL) for k in names]
           for _, keys in found]
    fields, values = [], [[] for _ in found]
    for j, name in enumerate(names):
        col = [None if r[j] == HIVE_NULL else r[j] for r in raw]
        dt = _partition_type(col)
        fields.append(T.StructField(name, dt, True))
        for i, v in enumerate(col):
            values[i].append(None if v is None else
                             (int(v) if dt is T.INT else v))
    return FileListing([p for p, _ in found], fields,
                       [tuple(v) for v in values])


def validate_csv_options(options: dict) -> None:
    """The reference's ``_validate_csv_options`` (GpuCSVScan's gates):
    a one-character delimiter other than a newline or ``"``, a quote of
    one character that differs from it, no multiLine, UTF-8 only, an
    escape of one character."""
    delim = str(options.get("delimiter", ","))
    if len(delim) != 1:
        raise ValueError(f"CSV delimiter must be a single character, "
                         f"got {delim!r}")
    if delim in ("\n", "\r", '"'):
        raise ValueError(f"unsupported CSV delimiter {delim!r}")
    quote = options.get("quote", '"')
    if quote not in (False, None, ""):
        quote = str(quote)
        if len(quote) != 1:
            raise ValueError(f"CSV quote must be a single character, "
                             f"got {quote!r}")
        if quote == delim:
            raise ValueError("CSV quote and delimiter must differ")
    if str(options.get("multiLine", "false")).lower() == "true":
        raise ValueError("multiLine CSV is not supported "
                         "(reference GpuCSVScan rejects it too)")
    charset = str(options.get("charset", options.get("encoding", "UTF-8")))
    if charset.upper().replace("-", "") not in ("UTF8",):
        raise ValueError(f"unsupported CSV charset {charset} (UTF-8 only)")
    esc = options.get("escape")
    if esc is not None and len(str(esc)) != 1:
        raise ValueError(f"CSV escape must be a single character, got {esc!r}")


def infer_schema(fmt: str, listing: FileListing, options: dict) -> T.Schema:
    """The scan's schema: its first file's columns, then the partition
    columns."""
    if fmt == "csv":
        validate_csv_options(options)
    if not listing.files:
        raise FileNotFoundError(f"no {fmt} files to read")
    first = listing.files[0]
    if fmt == "parquet":
        from .parquet_meta import read_footer, schema_from_parquet
        schema = schema_from_parquet(read_footer(first), first)
    elif fmt == "orc":
        from .orc_device import read_tail, schema_from_tail
        schema = schema_from_tail(read_tail(first))
    elif fmt == "csv":
        from .csv_device import infer_schema as csv_schema
        schema = csv_schema(first, options)
    else:
        raise ValueError(f"unknown format {fmt}")
    return T.Schema(list(schema) + list(listing.part_fields))


def _constant(value, dtype: T.DataType, n: int):
    """A constant column; a string's as a numpy ``str`` array, which the
    upload dictionary-encodes faster than Python objects."""
    if dtype is T.STRING:
        text = "" if value is None else str(value)
        return (np.full(n, text, f"U{max(len(text), 1)}"),
                np.full(n, value is not None))
    if value is None:
        return np.zeros(n, dtype.np_dtype), np.zeros(n, bool)
    return np.full(n, value, dtype.np_dtype), np.ones(n, bool)


def host_rows(batch) -> HostBatch:
    """A decoded CPU batch's rows as host columns: a dictionary string as
    a numpy ``str`` array (its entries gathered by code, ``""`` under a
    null), every other layout as :meth:`HostBatch.from_device` gives
    it."""
    from ..data.batch import _host_values
    n = int(batch.n_rows)
    rows = slice(0, n)
    pairs = []
    for c in batch.columns:
        if c.is_dict:
            ok = c.validity[rows].numpy()
            entries = np.asarray(c.dictionary, dtype=str) \
                if c.dict_size else np.array([""])
            codes = np.clip(c.codes[rows].numpy(), 0, len(entries) - 1)
            pairs.append((np.where(ok, entries[codes], ""), ok))
        else:
            pairs.append(_host_values(c, rows))
    return HostBatch.from_positional(batch.schema, pairs)


class CpuFileScanExec(HostExec):
    """The host scan of parquet, ORC or CSV files (see the module doc)."""

    def __init__(self, fmt: str, files: List[str], schema: T.Schema,
                 options: Optional[dict] = None,
                 part_values: Optional[List[tuple]] = None,
                 n_part: int = 0, emit_file_meta: bool = False,
                 pushed_filters: Optional[list] = None):
        self.children = []
        self.fmt = fmt
        self.files = list(files)
        self._schema = schema
        self.options = dict(options or {})
        self.part_values = list(part_values or [() for _ in files])
        self.n_part = n_part
        self.emit_file_meta = emit_file_meta
        self.pushed_filters = list(pushed_filters or [])

    @property
    def schema(self):
        return self._schema

    @property
    def data_schema(self) -> T.Schema:
        """The columns read from the files."""
        cut = len(self._schema) - self.n_part - \
            (3 if self.emit_file_meta else 0)
        return T.Schema(list(self._schema)[:cut])

    def describe(self):
        return (f"CpuFileScan {self.fmt} [{', '.join(self._schema.names)}] "
                f"files={len(self.files)}")

    def _host_batches(self, path: str, ctx):
        schema = self.data_schema
        if self.fmt == "parquet":
            from .parquet_device import (decode_row_group_device,
                                         read_row_group_host)
            from .parquet_meta import read_footer
            meta = read_footer(path)
            for rg in range(meta.num_row_groups):
                yield host_rows(decode_row_group_device(
                    read_row_group_host(path, rg, schema, meta, ctx.device),
                    "cpu"))
        elif self.fmt == "orc":
            from .orc_device import decode_stripe, read_tail
            tail = read_tail(path)
            for k in range(len(tail.stripes)):
                yield host_rows(decode_stripe(tail, k, schema, "cpu",
                                              ctx.device))
        else:
            from .csv_device import read_host
            yield read_host(path, schema, self.options)

    def _append(self, hb: HostBatch, path: str, values: tuple) -> HostBatch:
        n = hb.num_rows
        pairs = [hb.column_at(i) for i in range(len(hb.schema))]
        tail = list(self._schema)[len(pairs):]
        consts = list(values)
        if self.emit_file_meta:
            try:
                size = os.path.getsize(path)
            except OSError:
                size = -1
            consts += [path, 0, size]
        pairs += [_constant(v, f.data_type, n)
                  for v, f in zip(consts, tail)]
        return HostBatch.from_positional(self._schema, pairs)

    def execute(self, ctx):
        from ..config import (MAX_READ_BATCH_SIZE_BYTES,
                              MAX_READ_BATCH_SIZE_ROWS)
        max_rows = max(int(ctx.conf.get(MAX_READ_BATCH_SIZE_ROWS)), 1)
        max_bytes = max(int(ctx.conf.get(MAX_READ_BATCH_SIZE_BYTES)), 1)
        name = self.node_name()

        def read(path, values):
            try:
                ctx.count(name + ".read_bytes", os.path.getsize(path))
            except OSError:
                pass
            it = self._host_batches(path, ctx)
            while True:
                with ctx.timed(name, host=True):
                    hb = next(it, None)
                    if hb is None:
                        return
                    hb = self._append(hb, path, values)
                n = hb.num_rows
                if not n:
                    continue
                step = min(max_rows, max(1, max_bytes * n
                                         // max(hb.nbytes, 1)))
                for lo in range(0, n, step):
                    piece = hb if step >= n else _slice(hb, lo, lo + step)
                    ctx.metric(name, "numOutputRows", piece.num_rows)
                    ctx.metric(name, "numOutputBatches", 1)
                    yield piece

        return [read(p, v) for p, v in zip(self.files, self.part_values)]


def _slice(hb: HostBatch, lo: int, hi: int) -> HostBatch:
    return HostBatch.from_positional(hb.schema, [
        (v[lo:hi], ok[lo:hi])
        for v, ok in (hb.column_at(i) for i in range(len(hb.schema)))])
