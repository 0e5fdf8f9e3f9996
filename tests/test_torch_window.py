"""The port's window operator (``exec/window_exec.py WindowExec``) against
the reference's ``TpuWindowExec``, both through their sessions on the
CPU, on the same batches made from a numpy seed.

Covered: RowNumber, Rank and DenseRank; Count (of a column and of
rows), Sum, Average, Min and Max over ROWS frames (unbounded, offsets,
the current row) and RANGE frames (the default, current-row bounds,
literal offsets over an int and a float order key); null and tied
partition and order keys, descending orders with nulls last, one
partition, one row per partition, a string column's min and max, and
an empty batch. Results compare row for row in input order: integers
exactly, floats within the harness tolerance of ``tests/harness.py``.
"""

import math

import numpy as np
import pytest

from harness import DEVICE_FLOAT_TOL
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.ops import aggregates as RA
from spark_rapids_tpu.ops import windows as RW
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.plan.logical import SortOrder as RSortOrder
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.exec.window_exec import WindowExec
from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops import windows as W
from spark_rapids_tpu_torch.ops.expression import col
from spark_rapids_tpu_torch.plan.logical import SortOrder
from spark_rapids_tpu_torch.session import TorchSession

SCHEMA = {"k": T.LONG, "t": T.LONG, "v": T.LONG, "f": T.DOUBLE,
          "s": T.STRING}
U = "unbounded"
C = "current"


def _data(n: int = 300, kind: str = "default", seed: int = 0):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 8, n).astype(np.int64)
    if kind == "one row per partition":
        k = rng.permutation(n).astype(np.int64)
    data = {"k": k,
            "t": rng.integers(0, 40, n).astype(np.int64),
            "v": rng.integers(-100, 100, n).astype(np.int64),
            "f": np.array([0.0, -0.0, np.nan, 1.5, -2.25, 1e300])[
                rng.integers(0, 6, n)] * rng.integers(1, 4, n),
            "s": np.array(["b", "a", "ccc", "", "ab"])[rng.integers(0, 5, n)]}
    validity = {"k": rng.random(n) > 0.1, "t": rng.random(n) > 0.1,
                "v": rng.random(n) > 0.15, "f": rng.random(n) > 0.15,
                "s": rng.random(n) > 0.15}
    return data, validity


def _frames(data, validity):
    schema = T.Schema([T.StructField(n, t) for n, t in SCHEMA.items()])
    port = TorchSession(device="cpu").create_dataframe(
        HostBatch.from_numpy(data, schema, validity))
    ref_types = {T.LONG: RT.LONG, T.DOUBLE: RT.DOUBLE, T.STRING: RT.STRING}
    ref_schema = RT.Schema([RT.StructField(n, ref_types[t])
                            for n, t in SCHEMA.items()])
    ref = TpuSession({"spark.rapids.sql.enabled": True,
                      "spark.rapids.sql.test.enabled": True,
                      "spark.rapids.sql.variableFloatAgg.enabled": True}
                     ).create_dataframe(
        {n: [v.item() if ok else None
             for v, ok in zip(data[n], validity[n])] for n in SCHEMA},
        ref_schema)
    return port, ref


def _bound(x, lower: bool, W_):
    if x == U:
        return W_.Window.unbounded_preceding if lower \
            else W_.Window.unbounded_following
    if x == C:
        return W_.Window.current_row
    return x


def _window(pkg: str, part, orders, frame):
    """The same spec in either package: ``orders`` is a list of (column,
    ascending, nulls_first); ``frame`` is None or (kind, lower, upper)."""
    W_, SO, c = (W, SortOrder, col) if pkg == "port" \
        else (RW, RSortOrder, rcol)
    w = W_.Window.partition_by(*part) if part else W_.Window()
    if orders:
        w = w.order_by(*[SO(c(n), a, nf) for n, a, nf in orders])
    if frame is not None:
        kind, lo, hi = frame
        between = w.rows_between if kind == "rows" else w.range_between
        w = between(_bound(lo, True, W_), _bound(hi, False, W_))
    return w


def _funcs(pkg: str, names):
    A_, W_, c = (A, W, col) if pkg == "port" else (RA, RW, rcol)
    make = {"rn": lambda: W_.RowNumber(), "rank": lambda: W_.Rank(),
            "drank": lambda: W_.DenseRank(),
            "cnt_v": lambda: A_.Count(c("v")), "cnt": lambda: A_.Count(),
            "sum_v": lambda: A_.Sum(c("v")), "avg_v": lambda: A_.Average(
                c("v")), "min_v": lambda: A_.Min(c("v")),
            "max_v": lambda: A_.Max(c("v")), "sum_f": lambda: A_.Sum(c("f")),
            "avg_f": lambda: A_.Average(c("f")),
            "min_f": lambda: A_.Min(c("f")), "max_f": lambda: A_.Max(c("f")),
            "min_s": lambda: A_.Min(c("s")), "max_s": lambda: A_.Max(c("s"))}
    return {n: make[n]() for n in names}


def _run(data, validity, names, part, orders, frame):
    port, ref = _frames(data, validity)
    pw = _window("port", part, orders, frame)
    rw = _window("ref", part, orders, frame)
    got = port.with_windows(**{n: W.over(f, pw) if not isinstance(
        f, W.RANKING_TYPES) else f.over(pw)
        for n, f in _funcs("port", names).items()}).collect()
    want = ref.with_windows(**{n: RW.over(f, rw) if not isinstance(
        f, RW.RANKING_TYPES) else f.over(rw)
        for n, f in _funcs("ref", names).items()}).collect()
    n_rows = len(data["k"])
    assert got.num_rows == want.num_rows == n_rows
    for name in names:
        w = want.column(name).to_pylist()
        g = [(v.item() if hasattr(v, "item") else v) if ok else None
             for v, ok in zip(got.columns[name], got.validity[name])]
        for i, (a, b) in enumerate(zip(g, w)):
            assert _same(a, b), f"{name} row {i}: port {a!r}, ref {b!r}"
    return got


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(b, float):
        if math.isnan(b):
            return math.isnan(a)
        return math.isclose(a, b, rel_tol=DEVICE_FLOAT_TOL, abs_tol=1e-12)
    return a == b


AGGS = ["cnt_v", "cnt", "sum_v", "avg_v", "min_v", "max_v", "sum_f",
        "avg_f", "min_f", "max_f"]
BY_T = [("t", True, True)]


@pytest.mark.parametrize("orders", [
    BY_T, [("t", False, False)], [("t", True, True), ("v", False, True)]],
    ids=["t asc", "t desc nulls last", "t, v desc"])
def test_ranking_functions(orders):
    data, validity = _data()
    _run(data, validity, ["rn", "rank", "drank"], ["k"], orders, None)


@pytest.mark.parametrize("frame", [
    ("rows", -2, 1), ("rows", -5, 0), ("rows", 0, 3), ("rows", U, C),
    ("rows", C, U), ("rows", -1, U), ("rows", U, 2), ("rows", U, U),
    ("rows", 2, 5), ("rows", -4, -1)],
    ids=lambda f: f"{f[0]} {f[1]} {f[2]}")
def test_aggregates_over_rows_frames(frame):
    data, validity = _data(seed=1)
    _run(data, validity, AGGS, ["k"], BY_T + [("v", True, True)], frame)


@pytest.mark.parametrize("frame", [
    None, ("range", U, C), ("range", C, U), ("range", C, C),
    ("range", -5, 5), ("range", -10, 0), ("range", 3, U), ("range", U, -2)],
    ids=lambda f: "default" if f is None else f"{f[0]} {f[1]} {f[2]}")
def test_aggregates_over_range_frames(frame):
    data, validity = _data(seed=2)
    _run(data, validity, AGGS, ["k"], BY_T, frame)


@pytest.mark.parametrize("orders", [[("f", True, True)],
                                    [("f", False, False)]],
                         ids=["asc", "desc nulls last"])
def test_range_offsets_over_a_float_order_key(orders):
    data, validity = _data(seed=3)
    _run(data, validity, ["cnt", "sum_v", "min_v", "max_f"], ["k"], orders,
         ("range", -2, 1))


def test_descending_range_offsets_with_null_order_keys():
    data, validity = _data(seed=4)
    _run(data, validity, ["cnt", "sum_v", "avg_v", "max_v"], ["k"],
         [("t", False, False)], ("range", -3, 3))


def test_whole_partition_without_order():
    data, validity = _data(seed=5)
    _run(data, validity, AGGS, ["k"], [], None)


@pytest.mark.parametrize("frame", [None, ("rows", -3, 0)],
                         ids=["default", "rows -3 0"])
def test_one_partition(frame):
    data, validity = _data(seed=6)
    _run(data, validity, ["rn", "rank"] + AGGS, [], BY_T, frame)


def test_one_row_per_partition():
    data, validity = _data(kind="one row per partition", seed=7)
    validity["k"][:] = True
    _run(data, validity, ["rn", "drank"] + AGGS, ["k"], BY_T,
         ("rows", -2, 2))


@pytest.mark.parametrize("frame", [("rows", -2, 1), None],
                         ids=["rows -2 1", "default"])
def test_string_min_max(frame):
    data, validity = _data(seed=8)
    _run(data, validity, ["min_s", "max_s"], ["k"], BY_T, frame)


def test_partition_by_a_string_key():
    data, validity = _data(seed=9)
    _run(data, validity, ["rn", "sum_v", "max_f"], ["s"], BY_T,
         ("rows", U, C))


def test_empty_batch():
    data, validity = _data(n=0)
    got = _run(data, validity, ["rn", "cnt_v", "sum_v", "min_f"], ["k"],
               BY_T, None)
    assert got.num_rows == 0


def test_types_and_nullability_match_reference():
    data, validity = _data(n=10)
    port, ref = _frames(data, validity)
    pw, rw = _window("port", ["k"], BY_T, None), _window("ref", ["k"], BY_T,
                                                         None)
    names = ["rn", "drank", "cnt", "sum_v", "avg_v", "sum_f", "min_f"]
    got = port.with_windows(**{n: W.over(f, pw) if not isinstance(
        f, W.RANKING_TYPES) else f.over(pw)
        for n, f in _funcs("port", names).items()}).schema
    want = ref.with_windows(**{n: RW.over(f, rw) if not isinstance(
        f, RW.RANKING_TYPES) else f.over(rw)
        for n, f in _funcs("ref", names).items()}).schema
    assert [(f.name, f.data_type.name, f.nullable) for f in got] == \
        [(f.name, f.data_type.name, f.nullable) for f in want]


def test_window_plans_as_window_exec():
    data, validity = _data(n=10)
    port, _ = _frames(data, validity)
    df = port.with_column("rn", W.RowNumber().over(
        W.Window.partition_by("k").order_by("t")))
    plan = port._session.plan(df._plan)
    assert isinstance(plan, WindowExec)
    with pytest.raises(ValueError, match="new name"):
        port.with_column("k", W.RowNumber().over(W.Window.partition_by("k")))
