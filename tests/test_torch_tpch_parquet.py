"""The bench suite's TPC-H queries (``bench.py:341``: q1, q3, q4, q5, q6,
q12, q14, q19 and ``xbb_score``) over parquet: the port's
``TorchSession.read.parquet`` frames against the JAX package's
``TpuSession`` reading the same files, at 16,384 lineitem rows.

The tables are the reference generator's, written by pyarrow as
``bench.py:226`` writes them (SNAPPY, dictionary pages), with lineitem in
row groups of 4,096 rows, so its four batches concatenate on the way
into the joins and merge through the partial aggregates. The port runs
on the CPU (its kernels take their plain versions, its snappy the plain
Python version). The reference runs with ``variableFloatAgg`` on, so its
float aggregates take its device path, as in
``tests/test_torch_tpch_bench.py``, whose tolerances hold here: keys,
strings, counts and dates equal, in the order the query sets (Q1, Q5,
Q12 and ``xbb_score`` have no ORDER BY: their rows compare in key
order); float sums and averages to rtol 1e-12, ``max_score`` to 1e-15.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import torch

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.workloads import tpch as rtpch
from spark_rapids_tpu_torch.ops.kernels.cuda import join_probe as JP
from spark_rapids_tpu_torch.ops.kernels.cuda import sort_steps as SS
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.workloads import tpch

ROWS = 1 << 14
#: (key columns, exact columns, float columns, rtol of the floats)
COLUMNS = {
    "q1": (["l_returnflag", "l_linestatus"], ["count_order"],
           ["sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
            "avg_qty", "avg_disc"], 1e-12),
    "q3": (["o_orderkey", "o_orderdate"], [], ["revenue"], 1e-12),
    "q4": (["o_orderpriority"], ["order_count"], [], 0.0),
    "q5": (["n_name"], [], ["revenue"], 1e-12),
    "q6": ([], [], ["revenue"], 1e-12),
    "q12": (["l_shipmode"], ["high_line_count", "low_line_count"], [],
            0.0),
    "q14": ([], [], ["promo", "total"], 1e-12),
    "q19": ([], [], ["revenue"], 1e-12),
    "xbb_score": (["l_returnflag"], ["n"], ["avg_score", "max_score"],
                  1e-12),
}
QUERIES = list(COLUMNS)
UNORDERED = ("q1", "q5", "q12", "xbb_score")
DENSE_JOINS = ("q3", "q4", "q5", "q12", "q14", "q19")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpch_parquet")
    out = {}
    for name, rb in rtpch.gen_tables(ROWS).items():
        out[name] = str(d / f"{name}.parquet")
        pq.write_table(pa.Table.from_batches([rb]), out[name],
                       row_group_size=4096)
    return out


@pytest.fixture(scope="module")
def ref_results(paths):
    s = TpuSession({"spark.rapids.sql.enabled": True,
                    "spark.rapids.sql.variableFloatAgg.enabled": True})
    dfs = {n: s.read.parquet(p) for n, p in paths.items()}
    return {q: rtpch.QUERIES[q](dfs).collect() for q in QUERIES}


@pytest.fixture(scope="module")
def port_results(paths):
    """Each query's result on the CPU over parquet frames, with the
    ``joinProbe`` and ``sortStep`` wrappers' calls counted."""
    calls = {"joinProbe": 0, "sortStep": 0}
    jp, ss = JP.dense_build_probe, SS.packed_argsort

    def count_jp(*a, **k):
        calls["joinProbe"] += 1
        return jp(*a, **k)

    def count_ss(*a, **k):
        calls["sortStep"] += 1
        return ss(*a, **k)

    session = TorchSession(device="cpu")
    dfs = {n: session.read.parquet(p) for n, p in paths.items()}
    results = {}
    JP.dense_build_probe, SS.packed_argsort = count_jp, count_ss
    try:
        for q in QUERIES:
            before = dict(calls)
            out = tpch.QUERIES[q](dfs).collect()
            results[q] = (out, {k: calls[k] - before[k] for k in calls},
                          session.last_query.counters)
    finally:
        JP.dense_build_probe, SS.packed_argsort = jp, ss
    return results


def _ref_columns(table) -> dict:
    out = {}
    for name in table.column_names:
        c = table.column(name)
        if pa.types.is_string(c.type):
            out[name] = np.array(c.to_pylist(), dtype=object)
        elif pa.types.is_date32(c.type):
            out[name] = c.cast(pa.int32()).to_numpy()
        else:
            out[name] = c.to_numpy()
    return out


def _in_key_order(cols: dict, keys) -> dict:
    order = np.lexsort([np.asarray(cols[k]).astype(str)
                        for k in reversed(keys)])
    return {k: np.asarray(v)[order] for k, v in cols.items()}


@pytest.mark.parametrize("q", QUERIES)
def test_query_over_parquet_matches_reference(q, ref_results,
                                              port_results):
    want = _ref_columns(ref_results[q])
    got_batch = port_results[q][0]
    keys, exact, floats, rtol = COLUMNS[q]
    assert set(got_batch.columns) == set(want)
    n = len(next(iter(want.values())))
    assert n > 0
    for name in got_batch.columns:
        assert got_batch.validity[name].all(), name
        assert len(got_batch.columns[name]) == n, name
    got = dict(got_batch.columns)
    if q in UNORDERED:
        got, want = _in_key_order(got, keys), _in_key_order(want, keys)
    for name in keys:
        np.testing.assert_array_equal(np.asarray(got[name]).astype(str),
                                      want[name].astype(str), err_msg=name)
    for name in exact:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in floats:
        tol = 1e-15 if name == "max_score" else rtol
        np.testing.assert_allclose(got[name], want[name], rtol=tol, atol=0,
                                   err_msg=name)


@pytest.mark.parametrize("q", QUERIES)
def test_query_over_parquet_scans_and_joins(q, paths, port_results):
    """Every run decodes the files it reads (the scan's counters), and
    the joining queries build direct-address tables (``joinProbe``)."""
    _, kernel_calls, counters = port_results[q]
    assert counters["ParquetScanExec.rows"] >= ROWS
    assert counters["ParquetScanExec.bytes"] > 0
    if q in DENSE_JOINS:
        assert kernel_calls["joinProbe"] >= 1
    else:
        assert kernel_calls["joinProbe"] == 0
    # Q4's ORDER BY o_orderpriority sorts a dictionary its row groups'
    # concatenation left unsorted: it still packs into sortStep's lane
    assert (kernel_calls["sortStep"] >= 1) == (q == "q4")


@pytest.mark.parametrize("ascending", [True, False])
def test_unsorted_dictionary_sorts_through_the_packed_lane(ascending):
    """Two batches whose dictionaries overlap, concatenated (dictionary
    appended, not sorted), sort through ``sortStep``'s packed lane in the
    order the lexsort over the strings' characters gives."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.data.batch import ColumnarBatch, HostBatch
    from spark_rapids_tpu_torch.ops.kernels import concat as KC
    from spark_rapids_tpu_torch.ops.kernels import rowops as KR
    schema = T.Schema([T.StructField("s", T.STRING),
                       T.StructField("k", T.LONG)])
    a = HostBatch.from_numpy({"s": np.array(["pear", None, "fig", "apple",
                                             "fig"], dtype=object),
                              "k": np.arange(5)}, schema).to_device("cpu")
    b = HostBatch.from_numpy({"s": np.array(["kiwi", "apple", "", "pear"],
                                            dtype=object),
                              "k": np.arange(5, 9)}, schema).to_device("cpu")
    batch = KC.concat_batches([a, b], 128)
    col = batch.column("s")
    assert not col.dict_sorted
    lane = KR.packed_sort_lane(batch, [col], [ascending], [True])
    assert lane is not None
    got = HostBatch.from_device(KR.sort_batch_by_columns(
        batch, [col], [ascending], [True]))
    want_perm = KR.lexsort([(~batch.row_mask()).to(torch.int8)]
                           + KR.sort_operands([col], [ascending], [True]))
    want = HostBatch.from_device(ColumnarBatch(
        KR.gather_columns(batch.columns, want_perm,
                          torch.arange(128) < batch.n_rows),
        batch.n_rows, schema))
    assert list(got.columns["k"]) == list(want.columns["k"])
    assert list(got.columns["s"]) == list(want.columns["s"])


def test_lineitem_arrives_in_row_groups(paths):
    df = TorchSession(device="cpu").read.parquet(paths["lineitem"])
    plan = df._session.plan(df._plan)
    assert plan.describe().startswith("ParquetScan [l_orderkey")
    assert pq.ParquetFile(paths["lineitem"]).metadata.num_row_groups == 4
