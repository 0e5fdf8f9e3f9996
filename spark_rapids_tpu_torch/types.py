"""Spark-SQL data types mapped onto torch dtypes.

Port of ``spark_rapids_tpu/types.py``, cut to the types the port runs:
every type knows the numpy dtype of its host values and the torch dtype
of its device lane. Dates are int32 days since the epoch, Spark's
internal representation, timestamps int64 microseconds; the byte,
short, float and timestamp types come from parquet files (the scan,
``io/``). Uploaded strings are dictionary-encoded on
the device (int32 codes) with the dictionary kept on the host, so their
device lane is int32; expressions may build flat strings (offsets and
a byte payload, ``data/column.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


class DataType:
    """Base class for the SQL data types (singletons, Spark style)."""

    name = ""
    np_dtype: Optional[np.dtype] = None
    torch_dtype: Optional[torch.dtype] = None
    is_numeric = False
    is_integral = False
    is_floating = False

    def __str__(self) -> str:
        return self.name

    def __repr__(self) -> str:
        return f"T.{type(self).__name__}"


class BooleanType(DataType):
    name = "boolean"
    np_dtype = np.dtype(np.bool_)
    torch_dtype = torch.bool


class ByteType(DataType):
    name = "tinyint"
    np_dtype = np.dtype(np.int8)
    torch_dtype = torch.int8
    is_numeric = is_integral = True


class ShortType(DataType):
    name = "smallint"
    np_dtype = np.dtype(np.int16)
    torch_dtype = torch.int16
    is_numeric = is_integral = True


class IntegerType(DataType):
    name = "int"
    np_dtype = np.dtype(np.int32)
    torch_dtype = torch.int32
    is_numeric = is_integral = True


class LongType(DataType):
    name = "bigint"
    np_dtype = np.dtype(np.int64)
    torch_dtype = torch.int64
    is_numeric = is_integral = True


class FloatType(DataType):
    name = "float"
    np_dtype = np.dtype(np.float32)
    torch_dtype = torch.float32
    is_numeric = is_floating = True


class DoubleType(DataType):
    name = "double"
    np_dtype = np.dtype(np.float64)
    torch_dtype = torch.float64
    is_numeric = is_floating = True


class DateType(DataType):
    """Days since the unix epoch, int32."""

    name = "date"
    np_dtype = np.dtype(np.int32)
    torch_dtype = torch.int32


class TimestampType(DataType):
    """Microseconds since the unix epoch (UTC), int64."""

    name = "timestamp"
    np_dtype = np.dtype(np.int64)
    torch_dtype = torch.int64


class StringType(DataType):
    """Strings: int32 dictionary codes, or a flat offsets + bytes layout."""

    name = "string"
    np_dtype = np.dtype(object)
    torch_dtype = torch.int32


BOOLEAN = BooleanType()
BYTE = ByteType()
SHORT = ShortType()
INT = IntegerType()
LONG = LongType()
FLOAT = FloatType()
DOUBLE = DoubleType()
DATE = DateType()
TIMESTAMP = TimestampType()
STRING = StringType()

_NUMERIC_ORDER = [BYTE, SHORT, INT, LONG, FLOAT, DOUBLE]
_BY_NAME = {t.name: t for t in (BOOLEAN, BYTE, SHORT, INT, LONG, FLOAT,
                                DOUBLE, DATE, TIMESTAMP, STRING)}


def from_name(name: str) -> DataType:
    """The type whose ``name`` this is (the shuffle block header's)."""
    return _BY_NAME[name]


def numeric_promote(a: DataType, b: DataType) -> DataType:
    """Spark's binary-arithmetic result type for two numeric inputs."""
    if not (a.is_numeric and b.is_numeric):
        raise TypeError(f"cannot promote {a} and {b}")
    return _NUMERIC_ORDER[max(_NUMERIC_ORDER.index(a),
                              _NUMERIC_ORDER.index(b))]


def from_numpy_dtype(dt: np.dtype) -> DataType:
    """The type a host numpy array of this dtype takes when no schema is
    given (int32 arrays are INT; pass a schema to make them DATE)."""
    dt = np.dtype(dt)
    if dt.kind in ("U", "O", "S"):
        return STRING
    if dt == np.bool_:
        return BOOLEAN
    if dt == np.int32:
        return INT
    if dt == np.int64:
        return LONG
    if dt == np.float64:
        return DOUBLE
    raise TypeError(f"no SQL type for numpy dtype {dt}")


@dataclasses.dataclass(frozen=True)
class StructField:
    name: str
    data_type: DataType
    nullable: bool = True


@dataclasses.dataclass(frozen=True)
class Schema:
    """An ordered list of named, typed, nullability-tracked columns."""

    fields: tuple

    def __init__(self, fields):
        object.__setattr__(self, "fields", tuple(fields))

    @property
    def names(self):
        return [f.name for f in self.fields]

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __getitem__(self, key) -> StructField:
        if isinstance(key, int):
            return self.fields[key]
        return self.fields[self.index_of(key)]

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def field_maybe(self, name: str) -> Optional[StructField]:
        for f in self.fields:
            if f.name == name:
                return f
        return None

    def __str__(self) -> str:
        inner = ", ".join(f"{f.name}: {f.data_type}" for f in self.fields)
        return f"[{inner}]"
