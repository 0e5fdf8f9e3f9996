"""The port's CPU operators (``plan/physical.py``), through a session with
``spark.rapids.sql.enabled`` off (every operator on the host), against
the reference's CPU session (``tests/harness.py cpu_session``, its
pyarrow oracle) on the same seeded tables.

Covered: project, filter, the hash aggregate (int, string, float and
null keys, ``0.0``/``-0.0`` and NaN keys grouped apart as the reference's
oracle groups them, Spark's NaN ``min``/``max``, count, sum, average,
first and last (over valid rows, as both packages' device paths take
them), a global aggregate over no rows), equi joins of every
type over one and two keys with null keys, inner, left, semi and anti
joins with a residual (the reference plans those as its nested-loop
join), right and full joins with a residual (the reference raises for
them; here held against the pairs by brute force), the sort (several
keys, descending, nulls first and last, NaN), limits, union, expand
(rollup), generate (explode, posexplode, outer), windows, the cross
join with a condition, and TPC-H q1, q3 and q6 at 2^13 lineitem rows.
Rows compare as multisets, in order where the query orders them:
integers, strings and dates exactly, floats to 1e-9 relative (the sums
add in another order).
"""

import math
import types

import numpy as np
import pyarrow as pa
import pytest

from harness import cpu_session

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.ops import aggregates as RA
from spark_rapids_tpu.ops import arithmetic as RAR
from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit
from spark_rapids_tpu.plan.logical import SortOrder as RSortOrder
from spark_rapids_tpu.workloads import tpch as rtpch
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops import arithmetic as AR
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.plan.logical import SortOrder
from spark_rapids_tpu_torch.plan.overrides import host_nodes
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.workloads import tpch

#: float columns' relative tolerance
RTOL = 1e-9

PORT = types.SimpleNamespace(A=A, AR=AR, P=P, col=col, lit=lit,
                             SO=SortOrder)
REF = types.SimpleNamespace(A=RA, AR=RAR, P=RP, col=rcol, lit=rlit,
                            SO=RSortOrder)
OFF = {"spark.rapids.sql.enabled": False}

_TYPES = {"k": (T.LONG, RT.LONG), "g": (T.LONG, RT.LONG),
          "v": (T.LONG, RT.LONG), "f": (T.DOUBLE, RT.DOUBLE),
          "s": (T.STRING, RT.STRING), "d": (T.DATE, RT.DATE)}


def _table(n: int, seed: int, names=("k", "g", "v", "f", "s", "d")):
    rng = np.random.default_rng(seed)
    data = {"k": rng.integers(0, 12, n).astype(np.int64),
            "g": rng.integers(0, 3, n).astype(np.int64),
            "v": rng.integers(-100, 100, n).astype(np.int64),
            "f": np.array([0.0, -0.0, np.nan, 1.5, -2.25, 3.0, np.inf])[
                rng.integers(0, 7, n)],
            "s": np.array(["b", "a", "ccc", "", "ab", "z z"])[
                rng.integers(0, 6, n)],
            "d": rng.integers(0, 20000, n).astype(np.int32)}
    valid = {c: rng.random(n) > 0.12 for c in data}
    return {c: data[c] for c in names}, {c: valid[c] for c in names}


def frames(data, valid, ref_session=None):
    """(port frame on the host-only session, reference CPU frame)."""
    schema = T.Schema([T.StructField(c, _TYPES[c][0]) for c in data])
    port = TorchSession(OFF, device="cpu").create_dataframe(
        HostBatch.from_numpy(data, schema, valid))
    rschema = RT.Schema([RT.StructField(c, _TYPES[c][1]) for c in data])
    arrays = []
    for c, v in data.items():
        py = [(x.item() if hasattr(x, "item") else x) if ok else None
              for x, ok in zip(v, valid[c])]
        t = pa.int32() if c == "d" else RT.to_arrow_type(_TYPES[c][1])
        arrays.append(pa.array(py, type=t).cast(
            RT.to_arrow_type(_TYPES[c][1])))
    ref = (ref_session or cpu_session()).create_dataframe(
        pa.RecordBatch.from_arrays(arrays, names=list(data)), rschema)
    return port, ref


def _canon(v):
    if isinstance(v, np.generic):
        v = v.item()
    if hasattr(v, "toordinal") and not isinstance(v, (int, float)):
        import datetime
        return (v - datetime.date(1970, 1, 1)).days
    if isinstance(v, float):
        if math.isnan(v):
            return ("NaN",)
        return 0.0 if v == 0.0 else v
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    return v


def port_rows(hb) -> list:
    cols = [[_canon(x) if ok else None for x, ok in zip(*hb.column_at(i))]
            for i in range(len(hb.schema))]
    return list(zip(*cols)) if cols else []


def ref_rows(table) -> list:
    cols = [[_canon(x) for x in table.column(i).to_pylist()]
            for i in range(table.num_columns)]
    return list(zip(*cols)) if cols else []


def _key(row):
    return tuple((x is None, repr(x)) for x in row)


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) and isinstance(b, float):
        return a == b or abs(a - b) <= RTOL * max(abs(a), abs(b))
    return a == b


def assert_same(got, want, ordered: bool = False):
    g, w = port_rows(got), ref_rows(want)
    assert [f.name for f in got.schema] == want.column_names
    if not ordered:
        g, w = sorted(g, key=_key), sorted(w, key=_key)
    assert len(g) == len(w), (len(g), len(w))
    for i, (a, b) in enumerate(zip(g, w)):
        assert len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b)), \
            (i, a, b)


def run_both(build, data=None, ordered=False, seed=0, n=400):
    data, valid = data or _table(n, seed)
    port, ref = frames(data, valid)
    pdf, rdf = build(PORT, port), build(REF, ref)
    assert host_nodes(port._session.plan(pdf._plan)), "nothing on the host"
    assert_same(pdf.collect(), rdf.collect(), ordered)


def _agg(m, fn, c, name):
    return m.A.AggregateExpression(getattr(m.A, fn)(
        m.col(c)) if c else getattr(m.A, fn)(), name)


CASES = {
    "project": lambda m, d: d.select(
        m.col("k"), m.AR.Multiply(m.col("v"), m.lit(3)).alias("v3"),
        m.AR.Add(m.col("f"), m.lit(1.0)).alias("f1"), m.col("s")),
    "filter": lambda m, d: d.where(m.P.And(
        m.P.GreaterThan(m.col("v"), m.lit(-20)),
        m.P.NotEqual(m.col("s"), m.lit("a")))),
    "agg int key": lambda m, d: d.group_by(m.col("k")).agg(
        _agg(m, "Sum", "v", "sv"), _agg(m, "Count", "v", "cv"),
        _agg(m, "Count", None, "n"), _agg(m, "Average", "v", "av"),
        _agg(m, "Min", "v", "mn"), _agg(m, "Max", "v", "mx")),
    "agg string key": lambda m, d: d.group_by(m.col("s"), m.col("g")).agg(
        _agg(m, "Sum", "f", "sf"), _agg(m, "Min", "d", "md"),
        _agg(m, "Max", "s", "ms")),
    "agg float key": lambda m, d: d.group_by(m.col("f")).agg(
        _agg(m, "Count", None, "n"), _agg(m, "Sum", "v", "sv")),
    "agg nan minmax": lambda m, d: d.group_by(m.col("g")).agg(
        _agg(m, "Min", "f", "mn"), _agg(m, "Max", "f", "mx")),
    "agg first last": lambda m, d: d.group_by(m.col("g")).agg(
        _agg(m, "First", "v", "fv"), _agg(m, "Last", "s", "ls"),
        _agg(m, "First", "f", "ff")),
    "global agg": lambda m, d: d.group_by().agg(
        _agg(m, "Sum", "v", "sv"), _agg(m, "Count", None, "n"),
        _agg(m, "Max", "f", "mx")),
    "global agg over nothing": lambda m, d: d.where(m.P.GreaterThan(
        m.col("v"), m.lit(10 ** 6))).group_by().agg(
        _agg(m, "Sum", "v", "sv"), _agg(m, "Count", None, "n")),
    "distinct": lambda m, d: d.select(m.col("g"), m.col("s")).distinct(),
    "sort": lambda m, d: d.sort(m.SO(m.col("s")),
                                m.SO(m.col("f"), False),
                                m.SO(m.col("v"), True, False),
                                m.SO(m.col("k")), m.SO(m.col("d"))),
    "sort nulls": lambda m, d: d.sort(m.SO(m.col("f"), True, False),
                                      m.SO(m.col("v"), False, True),
                                      m.SO(m.col("k")), m.SO(m.col("d")),
                                      m.SO(m.col("s"))),
    "topk": lambda m, d: d.sort(m.SO(m.col("v"), False), m.SO(m.col("k")),
                                m.SO(m.col("d")), m.SO(m.col("s")),
                                m.SO(m.col("f"))).limit(17),
    "limit": lambda m, d: d.where(m.P.IsNotNull(m.col("v"))).group_by(
        m.col("v")).agg(_agg(m, "Count", None, "n")).sort(
        m.SO(m.col("v"))).limit(5),
    "union": lambda m, d: d.select(m.col("k"), m.col("s")).union(
        d.where(m.P.GreaterThan(m.col("v"), m.lit(0))).select(
            m.col("g"), m.col("s"))),
    "rollup": lambda m, d: d.rollup(m.col("g"), m.col("s")).agg(
        _agg(m, "Sum", "v", "sv"), _agg(m, "Count", None, "n")),
}

ORDERED = {"sort", "sort nulls", "topk", "limit"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_operator_matches_reference_cpu(case):
    run_both(CASES[case], ordered=case in ORDERED)


def _join_frames(seed: int, ref_session=None):
    (ld, lv), (rd, rv) = _table(300, seed), _table(90, seed + 1)
    rd = {("r" + c): v for c, v in rd.items()}
    rv = {("r" + c): v for c, v in rv.items()}
    for c in list(rd):
        _TYPES.setdefault(c, _TYPES[c[1:]])
    lp, lr = frames(ld, lv, ref_session)
    rp, rr = frames(rd, rv, ref_session)
    return (lp, lr), (rp, rr)


@pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                 "left_semi", "left_anti"])
@pytest.mark.parametrize("keys", ["one", "two"])
def test_equi_join_matches_reference_cpu(how, keys):
    (lp, lr), (rp, rr) = _join_frames(3)

    def on(m):
        eq = m.P.EqualTo(m.col("k"), m.col("rk"))
        return eq if keys == "one" else m.P.And(
            eq, m.P.EqualTo(m.col("s"), m.col("rs")))
    got = lp.join(rp, on=on(PORT), how=how)
    assert "CpuJoinExec" in host_nodes(got._session.plan(got._plan))
    assert_same(got.collect(), lr.join(rr, on=on(REF), how=how).collect())


@pytest.mark.parametrize("how", ["inner", "left", "left_semi",
                                 "left_anti"])
def test_residual_join_matches_reference_cpu(how):
    """Its residual applies while rows pair (the reference's nested-loop
    join on the CPU)."""
    (lp, lr), (rp, rr) = _join_frames(5)

    def on(m):
        return m.P.And(m.P.EqualTo(m.col("k"), m.col("rk")),
                       m.P.LessThan(m.col("v"), m.col("rv")))
    assert_same(lp.join(rp, on=on(PORT), how=how).collect(),
                lr.join(rr, on=on(REF), how=how).collect())


@pytest.mark.parametrize("how", ["right", "full"])
def test_outer_residual_join_by_brute_force(how):
    """Right and full joins with a residual (the reference raises): the
    host's equi join, which applies the residual to the pairs it matches
    by key, against every pair."""
    (ld, lv), (rd, rv) = _table(120, 9), _table(50, 10)
    rd = {("r" + c): v for c, v in rd.items()}
    rv = {("r" + c): v for c, v in rv.items()}
    lp, _ = frames(ld, lv)
    rp, _ = frames(rd, rv)
    df = lp.join(rp, on=P.And(P.EqualTo(col("k"), col("rk")),
                              P.LessThan(col("v"), col("rv"))), how=how)
    assert "CpuJoinExec" in host_nodes(df._session.plan(df._plan))
    got = port_rows(df.collect())

    def val(d, v, c, i):
        x = d[c][i]
        return _canon(x) if v[c][i] else None
    L = [tuple(val(ld, lv, c, i) for c in ld) for i in range(120)]
    R = [tuple(val(rd, rv, c, j) for c in rd) for j in range(50)]
    pairs = [(i, j) for i in range(120) for j in range(50)
             if L[i][0] is not None and L[i][0] == R[j][0]
             and L[i][2] is not None and R[j][2] is not None
             and L[i][2] < R[j][2]]
    want = [L[i] + R[j] for i, j in pairs]
    hit_r = {j for _, j in pairs}
    want += [(None,) * 6 + R[j] for j in range(50) if j not in hit_r]
    if how == "full":
        hit_l = {i for i, _ in pairs}
        want += [L[i] + (None,) * 6 for i in range(120) if i not in hit_l]
    assert sorted(got, key=_key) == sorted(want, key=_key)


def test_cross_join_with_condition_matches_reference_cpu():
    (lp, lr), (rp, rr) = _join_frames(7)
    got = lp.join(rp, on=P.LessThan(col("v"), col("rv"))).select(
        col("k"), col("rk"))
    want = lr.join(rr, on=RP.LessThan(rcol("v"), rcol("rv"))).select(
        rcol("k"), rcol("rk"))
    assert_same(got.collect(), want.collect())


def test_cross_join_pairs_in_chunks(monkeypatch):
    """The host's cross join evaluates its condition 64 pairs at a time
    (hundreds of chunks) and gives the reference's answer."""
    import spark_rapids_tpu_torch.plan.physical as PH
    monkeypatch.setattr(PH, "NLJ_CHUNK_PAIRS", 64)
    (lp, lr), (rp, rr) = _join_frames(8)
    got = lp.join(rp, on=P.LessThan(col("v"), col("rv"))).select(
        col("k"), col("rk"))
    assert "CpuNestedLoopJoinExec" in host_nodes(
        got._session.plan(got._plan))
    want = lr.join(rr, on=RP.LessThan(rcol("v"), rcol("rv"))).select(
        rcol("k"), rcol("rk"))
    assert_same(got.collect(), want.collect())


@pytest.mark.parametrize("outer,pos", [(False, False), (True, False),
                                       (False, True), (True, True)])
def test_generate_matches_reference_cpu(outer, pos):
    rng = np.random.default_rng(2)
    arrs = [None if rng.random() < 0.15 else
            [None if rng.random() < 0.1 else int(x)
             for x in rng.integers(0, 9, rng.integers(0, 4))]
            for _ in range(80)]
    keys = list(range(80))
    port = TorchSession(OFF, device="cpu").create_dataframe(
        HostBatch.from_numpy({"k": np.array(keys, dtype=np.int64),
                              "a": np.array(arrs + [None], dtype=object)[
                                  :80]},
                             T.Schema([T.StructField("k", T.LONG),
                                       T.StructField("a",
                                                     T.ArrayType(T.LONG))])))
    ref = cpu_session().create_dataframe(pa.RecordBatch.from_arrays(
        [pa.array(keys, pa.int64()), pa.array(arrs, pa.list_(pa.int64()))],
        names=["k", "a"]))
    got = port.explode(col("a"), name="e", outer=outer, pos=pos)
    want = ref.explode(rcol("a"), name="e", outer=outer, pos=pos)
    assert "CpuGenerateExec" in host_nodes(got._session.plan(got._plan))
    assert_same(got.collect(), want.collect())


@pytest.mark.parametrize("names,frame", [
    (["rn", "rank", "drank"], None),
    (["sum_v", "cnt", "min_f", "max_f"], ("rows", -2, 1)),
    (["avg_v", "max_v", "cnt_v"], ("range", "unbounded", "current")),
])
def test_window_matches_reference_cpu(names, frame):
    from test_torch_window import _data, _funcs, _window
    from spark_rapids_tpu.ops import windows as RW
    from spark_rapids_tpu_torch.ops import windows as W
    data, validity = _data()
    schema = T.Schema([T.StructField(n, t) for n, t in
                       {"k": T.LONG, "t": T.LONG, "v": T.LONG,
                        "f": T.DOUBLE, "s": T.STRING}.items()])
    port = TorchSession(OFF, device="cpu").create_dataframe(
        HostBatch.from_numpy(data, schema, validity))
    ref_types = {T.LONG: RT.LONG, T.DOUBLE: RT.DOUBLE, T.STRING: RT.STRING}
    ref = cpu_session().create_dataframe(
        {n: [v.item() if ok else None for v, ok in zip(data[n],
                                                        validity[n])]
         for n in data},
        RT.Schema([RT.StructField(f.name, ref_types[f.data_type])
                   for f in schema]))
    orders = [("t", True, None), ("v", False, None)]
    pw = _window("port", ["k"], orders, frame)
    rw = _window("ref", ["k"], orders, frame)
    got = port.with_windows(**{n: W.over(f, pw) if not isinstance(
        f, W.RANKING_TYPES) else f.over(pw)
        for n, f in _funcs("port", names).items()})
    want = ref.with_windows(**{n: RW.over(f, rw) if not isinstance(
        f, RW.RANKING_TYPES) else f.over(rw)
        for n, f in _funcs("ref", names).items()})
    assert "CpuWindowExec" in host_nodes(got._session.plan(got._plan))
    assert_same(got.collect(), want.collect())


@pytest.fixture(scope="module")
def tpch_tables():
    return tpch.gen_tables(1 << 13, seed=4), rtpch.gen_tables(1 << 13,
                                                             seed=4)


@pytest.mark.parametrize("q", ["q1", "q3", "q6"])
def test_tpch_on_the_host_matches_reference_cpu(tpch_tables, q):
    port_t, ref_t = tpch_tables
    s = TorchSession(OFF, device="cpu")
    got = tpch.QUERIES[q](tpch.load(s, port_t))
    plan = s.plan(got._plan)
    assert not plan.columnar and len(host_nodes(plan)) >= 3
    want = rtpch.QUERIES[q](rtpch.load(cpu_session(), ref_t)).collect()
    assert_same(got.collect(), want, ordered=q == "q3")
