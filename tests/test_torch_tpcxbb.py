"""The bench suite's TPCxBB entries end to end — ``q01``, ``q05`` and
``q30`` — and the pieces this slice added for them (``distinct``,
``Coalesce``), the port against the JAX package at 2^14 clicks, seed 23.

The port's generator must give the reference's tables value for value,
nulls included. The queries run through ``TorchSession`` on the CPU (the
kernels take their plain versions) and through the reference's
``TpuSession`` with ``variableFloatAgg`` on, its Pallas gate on
(interpret mode) and off. Every answer is an integer, so they compare
exactly, row for row in the queries' order.
"""

import numpy as np
import pytest
import torch

from spark_rapids_tpu.ops import conditional as RC
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.workloads import tpcxbb as rxbb
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.ops.arithmetic import Add
from spark_rapids_tpu_torch.ops.conditional import Coalesce
from spark_rapids_tpu_torch.ops.expression import Alias, col, lit
from spark_rapids_tpu_torch.ops.kernels.cuda import join_probe as JP
from spark_rapids_tpu_torch.ops.kernels.cuda import segmented as SEG
from spark_rapids_tpu_torch.parallel.mesh import make_mesh
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.workloads import tpcxbb

N_CLICKS = 1 << 14
SEED = 23
QUERIES = ["q01", "q05", "q30"]
REF_CONFS = {
    "pallas on": {"spark.rapids.tpu.pallas.enabled": True},
    "pallas off": {"spark.rapids.tpu.pallas.enabled": False},
}


@pytest.fixture(scope="module")
def tables():
    return rxbb.gen_tables(N_CLICKS, seed=SEED), \
        tpcxbb.gen_tables(N_CLICKS, seed=SEED)


@pytest.fixture(scope="module")
def ref_dfs(tables):
    out = {}
    for name, conf in REF_CONFS.items():
        s = TpuSession({"spark.rapids.sql.enabled": True,
                        "spark.rapids.sql.variableFloatAgg.enabled": True,
                        **conf})
        out[name] = rxbb.load(s, tables[0])
    return out


@pytest.fixture(scope="module")
def port_results(tables):
    """Each query's result on the CPU, with the calls of the ``joinProbe``
    and ``segmented`` wrappers counted."""
    calls = {"joinProbe": 0, "segmented": 0}
    jp, seg = JP.dense_build_probe, SEG.segment_reduce_sorted

    def count(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    dfs = tpcxbb.load(TorchSession(device="cpu"), tables[1])
    results = {}
    JP.dense_build_probe = count("joinProbe", jp)
    SEG.segment_reduce_sorted = count("segmented", seg)
    try:
        for q in QUERIES:
            before = dict(calls)
            out = tpcxbb.QUERIES[q](dfs).collect()
            results[q] = (out, {k: calls[k] - before[k] for k in calls})
    finally:
        JP.dense_build_probe, SEG.segment_reduce_sorted = jp, seg
    return results


def _ref_rows(table) -> dict:
    return {name: table.column(name).to_pylist()
            for name in table.column_names}


def _port_rows(hb) -> dict:
    return {name: [_py(v) if ok else None
                   for v, ok in zip(hb.columns[name], hb.validity[name])]
            for name in hb.columns}


def _py(v):
    """A numpy scalar as its Python value."""
    return v.item() if hasattr(v, "item") else v


@pytest.mark.parametrize("name", list(rxbb.gen_tables(256, seed=SEED)))
def test_gen_tables_equal_the_reference(tables, name):
    ref, port = tables[0][name], tables[1][name]
    assert ref.schema.names == list(port.columns)
    for i, c in enumerate(ref.schema.names):
        arr = ref.column(i)
        valid = ~np.asarray(arr.is_null())
        np.testing.assert_array_equal(port.validity[c], valid, err_msg=c)
        want = np.asarray(arr.to_pylist(), dtype=object)[valid]
        got = np.asarray(port.columns[c])[valid]
        assert got.dtype.kind in "iufU", c
        assert list(got) == list(want), c
    if name == "web_clickstreams":
        assert 0.08 < 1 - port.validity["wcs_user_sk"].mean() < 0.12
        assert 0.93 < 1 - port.validity["wcs_sales_sk"].mean() < 0.97


@pytest.mark.parametrize("conf", list(REF_CONFS))
@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_reference(q, conf, ref_dfs, port_results):
    want = _ref_rows(rxbb.QUERIES[q](ref_dfs[conf]).collect())
    got = _port_rows(port_results[q][0])
    assert list(got) == list(want)
    assert len(next(iter(want.values()))) > 0
    for name in want:
        assert got[name] == want[name], name


@pytest.mark.parametrize("q", QUERIES)
def test_query_path_calls_the_kernel_wrappers(q, port_results):
    """On the card the same calls launch the kernels; here the wrappers
    take their plain versions. q05's and q30's item joins and q05's left
    join build direct-address tables; q01's self-join on a repeated
    ticket number leaves them for the exact search, and at this scale its
    pair table fits the dense aggregate, so no aggregate takes the sort
    path's kernel. q30's two sides read one evaluation of its sessionized
    clicks (the planner's ``ReusedExec``), so its item join builds once."""
    calls = port_results[q][1]
    assert calls["joinProbe"] == {"q01": 2, "q05": 3, "q30": 1}[q]
    assert calls["segmented"] == 0


def _frames(data, schema_types, validity=None):
    schema = T.Schema([T.StructField(n, t) for n, t in schema_types.items()])
    port = TorchSession(device="cpu").create_dataframe(
        HostBatch.from_numpy(data, schema, validity))
    ref_data = {}
    for n, v in data.items():
        ok = np.ones(len(v), bool) if not validity or n not in validity \
            else validity[n]
        ref_data[n] = [_py(x) if good else None for x, good in zip(v, ok)]
    ref = TpuSession({"spark.rapids.sql.enabled": True}).create_dataframe(
        ref_data)
    return port, ref


def _distinct_data(kind: str):
    rng = np.random.default_rng(7)
    n = 3000
    if kind == "dictionary strings":
        data = {"a": np.array(["x", "yy", "z", ""])[rng.integers(0, 4, n)],
                "b": np.array(["p", "q"])[rng.integers(0, 2, n)]}
        return data, {"a": T.STRING, "b": T.STRING}, \
            {"a": rng.random(n) > 0.1}
    if kind == "dense ints":
        data = {"a": rng.integers(0, 40, n).astype(np.int64),
                "b": rng.integers(-3, 3, n).astype(np.int64)}
        return data, {"a": T.LONG, "b": T.LONG}, {"b": rng.random(n) > 0.1}
    if kind == "wide ints (sort path)":
        data = {"a": rng.integers(0, 1 << 40, 50)[rng.integers(0, 50, n)],
                "b": rng.integers(0, 1 << 40, 3)[rng.integers(0, 3, n)]}
        return data, {"a": T.LONG, "b": T.LONG}, {"a": rng.random(n) > 0.1}
    data = {"a": np.array([0.0, -0.0, 1.5, np.nan])[rng.integers(0, 4, n)],
            "b": rng.integers(0, 5, n).astype(np.int64)}
    return data, {"a": T.DOUBLE, "b": T.LONG}, {"a": rng.random(n) > 0.1}


def _canon(v):
    if isinstance(v, float):
        if v != v:
            return ("NaN",)
        return 0.0 if v == 0 else v
    return v


@pytest.mark.parametrize("kind", ["dictionary strings", "dense ints",
                                  "wide ints (sort path)",
                                  "floats (sort path)"])
def test_distinct_matches_reference(kind):
    data, types, validity = _distinct_data(kind)
    port, ref = _frames(data, types, validity)
    got = _port_rows(port.distinct().collect())
    want = _ref_rows(ref.distinct().collect())

    def rows(d):
        return sorted((tuple(_canon(v) for v in r)
                       for r in zip(d["a"], d["b"])), key=repr)
    assert rows(got) == rows(want)
    assert len(got["a"]) == len(set(rows(got)))


def test_distinct_keeps_every_column_and_counts_nothing():
    data, types, validity = _distinct_data("dense ints")
    port, _ = _frames(data, types, validity)
    df = port.distinct()
    assert df.columns == ["a", "b"]
    assert df._plan.aggregates == []


@pytest.mark.parametrize("kind", ["ints", "floats", "int and long",
                                  "dictionary strings"])
def test_coalesce_matches_reference(kind):
    rng = np.random.default_rng(3)
    n = 1000
    if kind == "dictionary strings":
        data = {"a": np.array(["b", "d", "a"])[rng.integers(0, 3, n)],
                "b": np.array(["c", "a", "e", "zz"])[rng.integers(0, 4, n)]}
        types = {"a": T.STRING, "b": T.STRING}
    elif kind == "floats":
        data = {"a": rng.normal(size=n), "b": rng.normal(size=n)}
        types = {"a": T.DOUBLE, "b": T.DOUBLE}
    elif kind == "int and long":
        data = {"a": rng.integers(0, 9, n).astype(np.int32),
                "b": rng.integers(0, 9, n).astype(np.int64)}
        types = {"a": T.INT, "b": T.LONG}
    else:
        data = {"a": rng.integers(0, 9, n).astype(np.int64),
                "b": rng.integers(0, 9, n).astype(np.int64)}
        types = {"a": T.LONG, "b": T.LONG}
    validity = {"a": rng.random(n) > 0.4, "b": rng.random(n) > 0.4}
    port, ref = _frames(data, types, validity)
    default = "x" if kind == "dictionary strings" else 0
    got = _port_rows(port.select(
        Coalesce(col("a"), col("b"), lit(default)).alias("c"),
        Coalesce(col("a"), col("b")).alias("d")).collect())
    want = _ref_rows(ref.select(
        RC.Coalesce(rcol("a"), rcol("b"), rlit(default)).alias("c"),
        RC.Coalesce(rcol("a"), rcol("b")).alias("d")).collect())
    assert got == want


def test_coalesce_refuses_flat_strings():
    """``Coalesce`` over a flat string, which this test once saw refused,
    now gives the reference's rows."""
    from spark_rapids_tpu.ops.strings import Substring as RSubstring
    from spark_rapids_tpu_torch.ops.strings import Substring
    rng = np.random.default_rng(5)
    data = {"a": np.array(["abc", "de", "f"] * 10)}
    port, ref = _frames(data, {"a": T.STRING},
                        {"a": rng.random(30) > 0.3})
    got = _port_rows(port.select(Coalesce(
        Substring(col("a"), lit(1), lit(2)), lit("z")).alias("c")
    ).collect())
    want = _ref_rows(ref.select(RC.Coalesce(
        RSubstring(rcol("a"), rlit(1), rlit(2)), rlit("z")).alias("c")
    ).collect())
    assert got == want and "z" in got["c"]


def test_alias_names_the_expression():
    e = Add(col("a"), lit(1))
    a = e.alias("b")
    assert isinstance(a, Alias) and a.name == "b" and a.child is e


@pytest.mark.parametrize("q", ["q05", "q30"])
def test_mesh_session_runs_left_joins_and_windows_on_the_single_path(
        q, tables, port_results):
    """A mesh-enabled session takes a plan with a left join or a window
    to the single path, with the same answer."""
    session = TorchSession({"spark.rapids.tpu.mesh.enabled": True},
                           device="cpu",
                           mesh=make_mesh(devices=[torch.device("cpu")] * 4))
    got = tpcxbb.QUERIES[q](tpcxbb.load(session, tables[1])).collect()
    assert session.last_query.path == "single"
    want = port_results[q][0]
    assert _port_rows(got) == _port_rows(want)


def test_sessionized_schema_matches_reference(tables, ref_dfs):
    """Row numbers are INT, the boundary flag INT, the running sum of it
    LONG, and the left join's build side nullable, as in the reference."""
    got = tpcxbb._sessionized(tpcxbb.load(TorchSession(device="cpu"),
                                          tables[1])).schema
    want = rxbb._sessionized(ref_dfs["pallas off"]).schema
    assert [(f.name, f.data_type.name, f.nullable) for f in got] == \
        [(f.name, f.data_type.name, f.nullable) for f in want]
    assert got.field_maybe("session_id").data_type is T.LONG
