"""Parquet file metadata — the port's stand-in for what
``pyarrow.parquet`` gives the reference scan (``ParquetFile.metadata``
and ``.schema``, ``spark_rapids_tpu/io/parquet_device.py:535-539``) and
for ``io/files.py::infer_schema`` (``:29``).

:func:`read_footer` reads a file's footer (``... FileMetaData, its 4-byte
length, PAR1``) through :mod:`.thrift` into a :class:`FileMeta`: the
leaf columns with their ``max_definition_level``, the row groups with
their ``num_rows`` and column chunks (codec, encodings, page offsets,
sizes, min/max statistics), and the key-value metadata.
:func:`schema_from_parquet` maps the leaves' physical and logical types
onto the port's :mod:`..types`.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, List, Optional

from .. import types as T
from .thrift import Thrift, ThriftError

MAGIC = b"PAR1"

PHYSICAL = {0: "BOOLEAN", 1: "INT32", 2: "INT64", 3: "INT96", 4: "FLOAT",
            5: "DOUBLE", 6: "BYTE_ARRAY", 7: "FIXED_LEN_BYTE_ARRAY"}
CODECS = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO", 4: "BROTLI",
          5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
ENCODINGS = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
             5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
             7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY",
             9: "BYTE_STREAM_SPLIT"}
REQUIRED, OPTIONAL, REPEATED = 0, 1, 2

# converted types (parquet.thrift ConvertedType)
CT_UTF8, CT_DATE, CT_TIMESTAMP_MILLIS, CT_TIMESTAMP_MICROS = 0, 6, 9, 10
CT_INT_8, CT_INT_16, CT_INT_32, CT_INT_64 = 15, 16, 17, 18


class ParquetFormatError(ValueError):
    """Bytes that are not a parquet file, or a footer that does not
    parse."""


@dataclasses.dataclass
class LeafColumn:
    """One leaf of the file's schema tree (a column chunk per row
    group)."""
    path: tuple
    physical_type: str
    repetition: int
    converted_type: Optional[int]
    #: the schema element's ``logicalType`` union, ``{field id: value}``
    logical_type: Optional[dict]
    max_definition_level: int
    max_repetition_level: int

    @property
    def name(self) -> str:
        return ".".join(self.path)


@dataclasses.dataclass
class Statistics:
    """A column chunk's min/max, PLAIN-encoded bytes (``min_value`` /
    ``max_value``, or the deprecated ``min`` / ``max``)."""
    min: Optional[bytes]
    max: Optional[bytes]

    @property
    def has_min_max(self) -> bool:
        return self.min is not None and self.max is not None


@dataclasses.dataclass
class ColumnChunkMeta:
    path_in_schema: str
    physical_type: str
    codec: str
    encodings: List[str]
    num_values: int
    data_page_offset: int
    dictionary_page_offset: Optional[int]
    total_compressed_size: int
    total_uncompressed_size: int
    statistics: Optional[Statistics]

    @property
    def has_dictionary_page(self) -> bool:
        return self.dictionary_page_offset is not None

    @property
    def start(self) -> int:
        """File offset of the chunk's first page: the dictionary page's
        when it comes first, or when the data page offset is not a page's
        (pyarrow writes 0 for a chunk of no rows, bytes 0-3 being the
        magic)."""
        dp, dict_off = self.data_page_offset, self.dictionary_page_offset
        if dict_off is not None and dict_off >= len(MAGIC) \
                and (dict_off < dp or dp < len(MAGIC)):
            return dict_off
        return dp


@dataclasses.dataclass
class RowGroupMeta:
    num_rows: int
    columns: List[ColumnChunkMeta]


@dataclasses.dataclass
class FileMeta:
    num_rows: int
    leaves: List[LeafColumn]
    row_groups: List[RowGroupMeta]
    key_value_metadata: Dict[bytes, bytes]
    created_by: Optional[str]

    @property
    def num_row_groups(self) -> int:
        return len(self.row_groups)


def _leaves(elements: list) -> List[LeafColumn]:
    """Walk the flattened schema tree (depth first, ``num_children``
    per element) from its root: each leaf with its definition and
    repetition levels."""
    out: List[LeafColumn] = []
    pos = 1

    def walk(n_children: int, path: tuple, def_lv: int, rep_lv: int):
        nonlocal pos
        for _ in range(n_children):
            if pos >= len(elements):
                raise ParquetFormatError("schema ends inside a group")
            el = elements[pos]
            pos += 1
            rep = el.get(3, REQUIRED)
            d = def_lv + (rep != REQUIRED)
            r = rep_lv + (rep == REPEATED)
            name = el.get(4, b"").decode("utf-8")
            kids = el.get(5, 0)
            if kids:
                walk(kids, path + (name,), d, r)
            else:
                phys = el.get(1)
                if phys not in PHYSICAL:
                    raise ParquetFormatError(
                        f"leaf {name!r} has no physical type")
                out.append(LeafColumn(path + (name,), PHYSICAL[phys], rep,
                                      el.get(6), el.get(10), d, r))

    walk(elements[0].get(5, 0), (), 0, 0)
    return out


def _statistics(d: Optional[dict]) -> Optional[Statistics]:
    if d is None:
        return None
    return Statistics(d.get(6, d.get(2)), d.get(5, d.get(1)))


def _column_chunk(cc: dict) -> ColumnChunkMeta:
    md = cc.get(3)
    if md is None:
        raise ParquetFormatError("column chunk without ColumnMetaData "
                                 "(metadata in another file)")
    return ColumnChunkMeta(
        path_in_schema=".".join(p.decode("utf-8") for p in md[3]),
        physical_type=PHYSICAL.get(md[1], str(md[1])),
        codec=CODECS.get(md[4], str(md[4])),
        encodings=[ENCODINGS.get(e, str(e)) for e in md[2]],
        num_values=md[5], data_page_offset=md[9],
        dictionary_page_offset=md.get(11),
        total_compressed_size=md[7], total_uncompressed_size=md[6],
        statistics=_statistics(md.get(12)))


def parse_footer(raw: bytes) -> FileMeta:
    """A :class:`FileMeta` from the thrift-encoded ``FileMetaData``."""
    try:
        d = Thrift(raw).read_struct()
        return FileMeta(
            num_rows=d[3], leaves=_leaves(d[2]),
            row_groups=[RowGroupMeta(rg[3], [_column_chunk(c)
                                             for c in rg[1]])
                        for rg in d.get(4, [])],
            key_value_metadata={kv[1]: kv.get(2) for kv in d.get(5, [])},
            created_by=d[6].decode("utf-8", "replace") if 6 in d else None)
    except (ThriftError, KeyError, IndexError, TypeError) as e:
        raise ParquetFormatError(f"malformed parquet footer: {e!r}") from e


def read_footer(path: str) -> FileMeta:
    """Parse the footer of the parquet file at ``path``."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if size < 12:
            raise ParquetFormatError(f"{path}: {size} bytes is too short "
                                     "for a parquet file")
        f.seek(size - 8)
        tail = f.read(8)
        if tail[4:] != MAGIC:
            raise ParquetFormatError(f"{path}: no PAR1 magic at the end")
        (n,) = struct.unpack("<I", tail[:4])
        if n > size - 12:
            raise ParquetFormatError(f"{path}: footer length {n} exceeds "
                                     "the file")
        f.seek(size - 8 - n)
        raw = f.read(n)
    try:
        return parse_footer(raw)
    except ParquetFormatError as e:
        raise ParquetFormatError(f"{path}: {e}") from e


def _field_type(leaf: LeafColumn, path: str) -> T.DataType:
    """The port's type of one leaf, or NotImplementedError naming file,
    column and reason."""

    def refuse(reason: str):
        return NotImplementedError(
            f"{path}: column {leaf.name!r}: {reason}")

    if len(leaf.path) > 1 or leaf.max_repetition_level > 0:
        raise refuse("nested columns are not supported")
    lt = leaf.logical_type or {}
    ct = leaf.converted_type
    phys = leaf.physical_type
    if phys == "BOOLEAN":
        return T.BOOLEAN
    if phys == "INT32":
        if 6 in lt or ct == CT_DATE:
            return T.DATE
        if 10 in lt or ct in (CT_INT_8, CT_INT_16, CT_INT_32):
            width = lt[10].get(1, 32) if 10 in lt else \
                {CT_INT_8: 8, CT_INT_16: 16, CT_INT_32: 32}[ct]
            signed = lt[10].get(2, True) if 10 in lt else True
            if signed:
                return {8: T.BYTE, 16: T.SHORT, 32: T.INT}[width]
        elif not lt and ct is None:
            return T.INT
        raise refuse(f"INT32 with logical type {lt or ct} is not supported")
    if phys == "INT64":
        if 8 in lt or ct in (CT_TIMESTAMP_MILLIS, CT_TIMESTAMP_MICROS):
            unit = lt[8].get(2, {}) if 8 in lt else \
                {2: {}} if ct == CT_TIMESTAMP_MICROS else {1: {}}
            if 2 in unit:
                return T.TIMESTAMP
            raise refuse("timestamps are read in microseconds only")
        if (10 in lt and lt[10].get(2, True)) or ct == CT_INT_64 \
                or (not lt and ct is None):
            return T.LONG
        raise refuse(f"INT64 with logical type {lt or ct} is not supported")
    if phys == "FLOAT":
        return T.FLOAT
    if phys == "DOUBLE":
        return T.DOUBLE
    if phys == "BYTE_ARRAY" and (1 in lt or ct == CT_UTF8):
        return T.STRING
    raise refuse(f"physical type {phys}"
                 + (" without a UTF8 annotation" if phys == "BYTE_ARRAY"
                    else "") + " is not supported")


def schema_from_parquet(meta: FileMeta, path: str = "<parquet>"
                        ) -> T.Schema:
    """The port's schema of a file: one field per leaf, nullable unless
    the leaf is REQUIRED."""
    return T.Schema([T.StructField(leaf.name, _field_type(leaf, path),
                                   leaf.repetition != REQUIRED)
                     for leaf in meta.leaves])
