"""Casts between strings and other types (``ops/cast.py``,
``ops/cast_string.py``) and ``UnixTimestamp`` / ``FromUnixTime``
(``ops/datetime.py``) against the JAX package's ``eval_device``, the
port on the CPU, with the reference's cast gates on (the port has no
gates yet: it always takes these casts).

Text to numbers, dates, timestamps and booleans runs over a dictionary
column and its flat copy: invalid text, surrounding whitespace (space,
tab, newline), integral overflow at every width (null, not wrapped),
negative numbers, exponents, dates before 1970 and in year 1,
impossible days, timestamps with fractions and a ``T``, non-ASCII
digits. Numbers, dates, timestamps and booleans to text run over a
table with the extremes (``INT64_MIN``, dates before the epoch,
timestamps with fractions and before the epoch). A float to text, and
a time pattern outside the fixed-width subset, raise
``NotImplementedError``, where the reference goes to its CPU path.
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.data.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.ops import cast as RCA
from spark_rapids_tpu.ops import datetime as RD
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops import cast as CA
from spark_rapids_tpu_torch.ops import cast_string as CS
from spark_rapids_tpu_torch.ops import datetime as D
from spark_rapids_tpu_torch.ops.expression import col

from test_torch_casewhen import check_expr, expr_batches
from test_torch_ops import ref_fields

TEXT = np.array([
    "123", "  -42 ", "+7", "\t17\n", "9223372036854775807",
    "-9223372036854775808", "9223372036854775808", "000000000000000000123",
    "2147483648", "-2147483649", "-129", "127", "32768", "-32769", "1.5",
    "-0.25e3", ".5", "5.", "1e", "e5", "1E-5", "abc", "", "   ", "1_000",
    "NaN", "Infinity", "12a", "- 5", "--5", "٣", "2020-02-29",
    "2021-02-29", "1969-12-31", "0001-01-01", "2020-1-5", " 1999-04-31 ",
    "2020-01-01 12:34:56", "2020-01-01T00:00:00.123456",
    "1960-06-30 23:59:59.5", "2020-01-01 24:00:00", "2020-01-01 07",
    "2020-01-01 07:08", "true", "F", "yes", " N ", "1", "0", "maybe",
    "2020/03/04", "04.03.2020 10:11"])

_RT = {"bigint": RT.LONG, "int": RT.INT, "smallint": RT.SHORT,
       "tinyint": RT.BYTE, "double": RT.DOUBLE, "float": RT.FLOAT,
       "date": RT.DATE, "timestamp": RT.TIMESTAMP, "boolean": RT.BOOLEAN,
       "string": RT.STRING}
_PT = {"bigint": T.LONG, "int": T.INT, "smallint": T.SHORT,
       "tinyint": T.BYTE, "double": T.DOUBLE, "float": T.FLOAT,
       "date": T.DATE, "timestamp": T.TIMESTAMP, "boolean": T.BOOLEAN,
       "string": T.STRING}


@pytest.fixture(scope="module")
def text():
    return expr_batches(TEXT, n=320, seed=29)


#: (target type, layouts): the narrower integers share the long parser,
#: so they run over one layout each.
FROM_TEXT = [("bigint", "sf"), ("int", "f"), ("tinyint", "s"),
             ("double", "sf"), ("float", "f"), ("date", "sf"),
             ("timestamp", "sf"), ("boolean", "s")]


@pytest.mark.parametrize("to,layout", [(t, c) for t, cs in FROM_TEXT
                                       for c in cs])
def test_cast_from_string_matches_reference(text, to, layout):
    rb, pb = text
    got = check_expr(rb, pb, RCA.Cast(rcol(layout), _RT[to]),
                     CA.Cast(col(layout), _PT[to]))
    assert got.dtype is _PT[to]
    # some rows parse and some do not, so both outcomes are exercised
    live = pb.row_mask().numpy() & pb.column(layout).validity.numpy()
    ok = got.validity.numpy()[live]
    assert ok.any() and not ok.all()


def test_parses_the_edges_as_spark_does():
    """A few answers spelled out: overflow is null at each width, text
    is trimmed, dates check the calendar."""
    words = ["9223372036854775807", "9223372036854775808", " -128\t",
             "-129", "2020-02-29", "2021-02-29", "1969-12-31", ""]
    from spark_rapids_tpu_torch.data.batch import HostBatch
    pb = HostBatch.from_numpy({"w": np.array(words)}).to_device("cpu")

    def cast(to):
        out = CA.Cast(col("w"), to).bind(pb.schema).eval_device(pb)
        return [v.item() if ok else None for v, ok in
                zip(out.data[:len(words)], out.validity[:len(words)])]
    assert cast(T.LONG)[:4] == [2 ** 63 - 1, None, -128, -129]
    assert cast(T.BYTE)[:4] == [None, None, -128, None]
    assert cast(T.SHORT)[:4] == [None, None, -128, -129]
    assert cast(T.DATE)[4:] == [18321, None, -1, None]


@pytest.fixture(scope="module")
def values():
    """(reference batch, port batch) of the extremes to format."""
    longs = np.array([0, 7, -7, 2 ** 63 - 1, -2 ** 63, 10 ** 18, -10,
                      123456789, 2 ** 31, -2 ** 31 - 1], dtype=np.int64)
    days = np.array([0, -1, -719162, 2932896, 18321, -25567, 365, 59,
                     11016, -36524], dtype=np.int32)
    us = np.array([0, -1, 1, 1_500_000, -86_400_000_001, 1584662400123456,
                   -5_000_000_000_000, 999_999, 86_399_999_999, 10],
                  dtype=np.int64)
    n = len(longs)
    mask = np.zeros(n, bool)
    mask[4] = True  # one null in each column, away from the extremes
    rb = RBatch.from_arrow(pa.RecordBatch.from_arrays([
        pa.array(longs, pa.int64()),
        pa.array(longs.astype(np.int32), pa.int32(), mask=mask),
        pa.array(longs.astype(np.int16), pa.int16()),
        pa.array(longs.astype(np.int8), pa.int8()),
        pa.array(days, pa.date32(), mask=np.roll(mask, 1)),
        pa.array(us, pa.timestamp("us"), mask=np.roll(mask, 2)),
        pa.array(longs % 3 == 0, pa.bool_(), mask=np.roll(mask, 3)),
        pa.array(longs.astype(np.float64), pa.float64())],
        names=["l", "i", "h", "b", "d", "t", "o", "x"]))
    schema = T.Schema([T.StructField(f.name, _PT[f.data_type.name],
                                     f.nullable) for f in rb.schema])
    pb = carry.batch_from_reference([ref_fields(c) for c in rb.columns],
                                    schema, int(rb.n_rows), None,
                                    device="cpu")
    return rb, pb


@pytest.mark.parametrize("name", ["l", "i", "h", "b", "d", "t", "o"])
def test_cast_to_string_matches_reference(values, name):
    rb, pb = values
    got = check_expr(rb, pb, RCA.Cast(rcol(name), RT.STRING),
                     CA.Cast(col(name), T.STRING))
    assert got.dtype is T.STRING
    assert got.is_dict == (name == "o")
    # max_bytes sits on the byte ladder (at least 128), as every string
    # column's does: it is the width of the gathers that move the column
    assert got.max_bytes >= 128 and got.max_bytes % 128 == 0


def test_int64_min_and_fractions_format_exactly(values):
    _, pb = values
    from test_torch_casewhen import port_strings
    got = port_strings(pb, CA.Cast(col("l"), T.STRING).bind(
        pb.schema).eval_device(pb))
    assert got[3:5] == [b"9223372036854775807", b"-9223372036854775808"]
    ts = port_strings(pb, CA.Cast(col("t"), T.STRING).bind(
        pb.schema).eval_device(pb))
    assert ts[1] == b"1969-12-31 23:59:59.999999"
    assert ts[3] == b"1970-01-01 00:00:01.5"


def test_float_to_string_raises(values):
    _, pb = values
    for to in (T.DOUBLE, T.FLOAT):
        e = CA.Cast(CA.Cast(col("x"), to), T.STRING).bind(pb.schema)
        with pytest.raises(NotImplementedError, match="castFloatToString"):
            e.eval_device(pb)


@pytest.mark.parametrize("fmt,layout", [
    ("yyyy-MM-dd HH:mm:ss", "s"), ("yyyy-MM-dd HH:mm:ss", "f"),
    ("yyyy/MM/dd", "s"), ("dd.MM.yyyy HH:mm", "f")])
def test_unix_timestamp_of_text_matches_reference(text, fmt, layout):
    rb, pb = text
    check_expr(rb, pb, RD.UnixTimestamp(rcol(layout), fmt),
               D.UnixTimestamp(col(layout), fmt))


@pytest.mark.parametrize("name", ["d", "t"])
def test_unix_timestamp_of_dates_and_timestamps_matches_reference(
        values, name):
    rb, pb = values
    got = check_expr(rb, pb, RD.UnixTimestamp(rcol(name)),
                     D.UnixTimestamp(col(name)))
    if name == "t":  # floor, not truncation, before the epoch
        assert got.data[1].item() == -1


@pytest.mark.parametrize("fmt", ["yyyy-MM-dd HH:mm:ss", "HH:mm:ss dd/MM/yyyy"])
def test_from_unixtime_matches_reference(values, fmt):
    rb, pb = values
    from spark_rapids_tpu.ops.arithmetic import IntegralDivide as RDiv
    from spark_rapids_tpu.ops.expression import lit as rlit
    from spark_rapids_tpu_torch.ops.arithmetic import IntegralDivide
    from spark_rapids_tpu_torch.ops.expression import lit
    # seconds from year -1 to 9999, negative ones included
    check_expr(rb, pb, RD.FromUnixTime(RDiv(rcol("l"), rlit(40_000_000)),
                                       fmt),
               D.FromUnixTime(IntegralDivide(col("l"), lit(40_000_000)),
                              fmt))


def test_unsupported_time_patterns_raise(text, values):
    _, pb = text
    for fmt in ("yyyy-MM-dd'T'HH", "EEE, dd MMM yyyy", "HH:mm"):
        assert CS.compile_ts_pattern(fmt) is None
        e = D.UnixTimestamp(col("s"), fmt).bind(pb.schema)
        with pytest.raises(NotImplementedError, match="pattern"):
            e.eval_device(pb)
    _, vb = values
    e = D.FromUnixTime(col("l"), "yyyy-MM-dd EEE").bind(vb.schema)
    with pytest.raises(NotImplementedError, match="pattern"):
        e.eval_device(vb)
