"""The port's datetime expressions (``spark_rapids_tpu_torch/ops/
datetime.py``) against the JAX package's ``eval_device``: every
``DatePart`` (``Year``, ``Month``, ``DayOfMonth``, ``Quarter``,
``DayOfYear``, ``DayOfWeek``, ``WeekDay``, ``Hour``, ``Minute``,
``Second``), ``LastDay``, ``DateAdd``, ``DateSub`` and ``DateDiff``, on
dates drawn from a seed between the years -1000 and 3000 with
1969-12-31, 2000-02-29, 1900-02-28 and the days around year 0 among
them, timestamps before and after the epoch, and nulls, in a batch with
dead rows. Results are integers and must be equal; the civil parts are
also held against numpy's ``datetime64`` calendar.
"""

import numpy as np
import pyarrow as pa
import pytest

import jax.numpy as jnp

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.data.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.ops import datetime as RD
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.kernels import rowops as RKR
from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops import datetime as D
from spark_rapids_tpu_torch.ops.expression import col

from test_torch_ops import assert_column, ref_fields

N = 4000
US_PER_DAY = 86_400_000_000
SPECIAL_DATES = ["1969-12-31", "1970-01-01", "2000-02-29", "1900-02-28",
                 "1900-03-01", "1600-02-29", "1582-10-15", "0001-01-01",
                 "0000-03-01", "0000-02-29", "-0001-12-31", "-1000-01-01",
                 "3000-12-31", "2100-02-28", "1999-12-31", "2024-12-31"]


def _days(iso: str) -> int:
    return int(np.datetime64(iso, "D").astype(np.int64))


def table(seed: int = 11) -> pa.RecordBatch:
    rng = np.random.default_rng(seed)
    lo, hi = _days("-1000-01-01"), _days("3000-12-31")
    d = rng.integers(lo, hi + 1, N)
    d[:len(SPECIAL_DATES)] = [_days(s) for s in SPECIAL_DATES]
    d2 = rng.integers(lo, hi + 1, N)
    ts = rng.integers(-(1 << 55), 1 << 55, N)
    ts[:8] = [-1, 0, 1, -US_PER_DAY, -US_PER_DAY - 1, US_PER_DAY - 1,
              -3_600_000_001, 59_999_999]
    ts[8:24] = np.array([_days(s) for s in SPECIAL_DATES]) * US_PER_DAY \
        - rng.integers(0, US_PER_DAY, 16)
    n = rng.integers(-400_000, 400_000, N)
    return pa.RecordBatch.from_arrays([
        pa.array(d.astype(np.int32), pa.int32(),
                 mask=rng.random(N) < 0.08).cast(pa.date32()),
        pa.array(d2.astype(np.int32), pa.int32(),
                 mask=rng.random(N) < 0.08).cast(pa.date32()),
        pa.array(ts, pa.int64(), mask=rng.random(N) < 0.08).cast(
            pa.timestamp("us")),
        pa.array(n.astype(np.int32), pa.int32(), mask=rng.random(N) < 0.08),
    ], names=["d", "d2", "ts", "n"])


def _port_type(t):
    return T.from_name(t.name)


@pytest.fixture(scope="module")
def batches():
    rb = RBatch.from_arrow(table())
    keep = np.random.default_rng(12).random(rb.capacity) < 0.9
    rb = RKR.compact(rb, jnp.asarray(keep))
    schema = T.Schema([T.StructField(f.name, _port_type(f.data_type),
                                     f.nullable) for f in rb.schema])
    pb = carry.batch_from_reference([ref_fields(c) for c in rb.columns],
                                    schema, int(rb.n_rows),
                                    np.asarray(rb.live), device="cpu")
    assert rb.schema["ts"].data_type is RT.TIMESTAMP
    return rb, pb


PARTS = ["Year", "Month", "DayOfMonth", "Quarter", "DayOfYear",
         "DayOfWeek", "WeekDay"]
TIME_PARTS = ["Hour", "Minute", "Second"]


def _check(name, args, batches):
    rb, pb = batches
    want = getattr(RD, name)(*(rcol(a) for a in args)).bind(
        rb.schema).eval_device(rb)
    expr = getattr(D, name)(*(col(a) for a in args)).bind(pb.schema)
    got = expr.eval_device(pb)
    assert got.dtype is _port_type(
        getattr(RD, name)(*(rcol(a) for a in args)).bind(
            rb.schema).data_type)
    assert_column(got, want, rb.row_mask())
    return got


@pytest.mark.parametrize("column", ["d", "ts"])
@pytest.mark.parametrize("part", PARTS)
def test_date_parts_match_reference(part, column, batches):
    _check(part, [column], batches)


@pytest.mark.parametrize("part", TIME_PARTS)
def test_time_parts_match_reference(part, batches):
    got = _check(part, ["ts"], batches)
    data = got.data.numpy()[got.validity.numpy()]
    hi = {"Hour": 23, "Minute": 59, "Second": 59}[part]
    assert data.min() >= 0 and data.max() <= hi


@pytest.mark.parametrize("column", ["d", "ts"])
def test_last_day_matches_reference(column, batches):
    _check("LastDay", [column], batches)


@pytest.mark.parametrize("name,args", [
    ("DateAdd", ["d", "n"]), ("DateSub", ["d", "n"]),
    ("DateDiff", ["d", "d2"]), ("DateDiff", ["d2", "d"])])
def test_date_arithmetic_matches_reference(name, args, batches):
    _check(name, args, batches)


def test_civil_parts_match_numpy(batches):
    """Year, month and day of every live valid date against numpy's
    proleptic calendar (``datetime64``), which counts years below 1 as
    astronomical years, as the algorithm does."""
    _, pb = batches
    live = pb.row_mask().numpy()
    c = pb.column("d")
    valid = c.validity.numpy() & live
    days = c.data.numpy()[valid].astype("datetime64[D]")
    months = days.astype("datetime64[M]")
    want = {"Year": days.astype("datetime64[Y]").astype(np.int64) + 1970,
            "Month": months.astype(np.int64) % 12 + 1,
            "DayOfMonth": (days - months).astype(np.int64) + 1}
    for part, w in want.items():
        got = getattr(D, part)(col("d")).bind(pb.schema).eval_device(pb)
        np.testing.assert_array_equal(got.data.numpy()[valid], w,
                                      err_msg=part)
    last = D.LastDay(col("d")).bind(pb.schema).eval_device(pb)
    want_last = ((months + 1).astype("datetime64[D]") - 1).astype(np.int64)
    np.testing.assert_array_equal(last.data.numpy()[valid], want_last)
    specials = np.array([_days(s) for s in SPECIAL_DATES])
    assert np.isin(specials, c.data.numpy()[valid]).sum() >= 12
