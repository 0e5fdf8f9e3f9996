"""TPC-H Q1, Q4, Q6 and Q22 end to end: the port's session against the JAX
package's.

The port runs on the CPU, so its kernels take their plain versions. The
reference runs with its Pallas gate on (interpret mode) and off; with
the default conf it plans the float aggregates on its CPU path, and with
``variableFloatAgg`` on it runs them on its device path, so the
reference's dictionary aggregate and global aggregate answer too.

Keys, strings, counts and dates must be equal, in the order the query
sets (Q1 has no ORDER BY: its rows compare sorted by key). Float sums
and averages are held to rtol 1e-12: both packages add a group's rows in
row order on the CPU, and the bound only leaves room for a different
association of the additions.
"""

import numpy as np
import pytest

import torch

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.workloads import tpch as rtpch
from spark_rapids_tpu_torch.ops.kernels.cuda import sort_steps as SS
from spark_rapids_tpu_torch.ops.kernels.cuda import strings as SG
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.workloads import tpch

ROWS = 1 << 14
QUERIES = ["q1", "q4", "q6", "q22"]
#: (key columns, exact columns, float columns) of each query's result.
COLUMNS = {
    "q1": (["l_returnflag", "l_linestatus"], ["count_order"],
           ["sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
            "avg_qty", "avg_disc"]),
    "q4": (["o_orderpriority"], ["order_count"], []),
    "q6": ([], [], ["revenue"]),
    "q22": (["cntrycode"], ["numcust"], ["totacctbal"]),
}
REF_CONFS = {
    "pallas on": {"spark.rapids.tpu.pallas.enabled": True},
    "pallas off": {"spark.rapids.tpu.pallas.enabled": False},
    "pallas on, device float aggregates": {
        "spark.rapids.tpu.pallas.enabled": True,
        "spark.rapids.sql.variableFloatAgg.enabled": True},
}


@pytest.fixture(scope="module")
def ref_dfs():
    tables = rtpch.gen_tables(ROWS)
    out = {}
    for name, conf in REF_CONFS.items():
        s = TpuSession({"spark.rapids.sql.enabled": True, **conf})
        out[name] = rtpch.load(s, tables)
    return out


@pytest.fixture(scope="module")
def port_results():
    """Each query's result on the CPU, with the calls of the two new
    kernels' wrappers counted."""
    calls = {"sortStep": 0, "strings": 0}
    ss, sg = SS.packed_argsort, SG.ragged_gather

    def count_ss(*a):
        calls["sortStep"] += 1
        return ss(*a)

    def count_sg(*a):
        calls["strings"] += 1
        return sg(*a)

    session = TorchSession(device="cpu")
    dfs = tpch.load(session, tpch.gen_tables(ROWS))
    results = {}
    SS.packed_argsort, SG.ragged_gather = count_ss, count_sg
    try:
        for q in QUERIES:
            before = dict(calls)
            out = getattr(tpch, q)(dfs).collect()
            results[q] = (out, {k: calls[k] - before[k] for k in calls},
                          session.last_query)
    finally:
        SS.packed_argsort, SG.ragged_gather = ss, sg
    return results


def _ref_columns(table) -> dict:
    out = {}
    for name in table.column_names:
        c = table.column(name)
        if str(c.type) == "string":
            out[name] = np.array(c.to_pylist(), dtype=object)
        else:
            out[name] = c.to_numpy()
    return out


def _ordered(cols: dict, keys, q: str) -> dict:
    if q != "q1":
        return cols
    order = np.lexsort([np.asarray(cols[k]).astype(str)
                        for k in reversed(keys)])
    return {k: np.asarray(v)[order] for k, v in cols.items()}


@pytest.mark.parametrize("conf", list(REF_CONFS))
@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_reference(q, conf, ref_dfs, port_results):
    want = _ref_columns(getattr(rtpch, q)(ref_dfs[conf]).collect())
    got_batch = port_results[q][0]
    keys, exact, floats = COLUMNS[q]
    assert set(got_batch.columns) == set(want)
    for name in got_batch.columns:
        assert got_batch.validity[name].all(), name
    got = _ordered(dict(got_batch.columns), keys, q)
    want = _ordered(want, keys, q)
    assert len(next(iter(got.values()))) == len(next(iter(want.values())))
    for name in keys:
        np.testing.assert_array_equal(got[name].astype(str),
                                      want[name].astype(str), err_msg=name)
    for name in exact:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in floats:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-12,
                                   atol=0, err_msg=name)


def test_q4_sorts_through_sort_step_and_q22_gathers_strings(port_results):
    """On the card the same calls launch the kernels; here the wrappers
    take their plain versions."""
    assert port_results["q4"][1]["sortStep"] == 1
    assert port_results["q22"][1]["strings"] >= 2
    for q in ("q1", "q6"):
        assert port_results[q][1] == {"sortStep": 0, "strings": 0}
    assert SS.packed_argsort.launches == 0 or torch.cuda.is_available()
    assert SG.ragged_gather.launches == 0 or torch.cuda.is_available()


def test_plans_take_the_dictionary_and_global_aggregates(port_results):
    for q in ("q1", "q6"):
        info = port_results[q][2]
        assert info.attempts == 1 and info.site_kinds == ["aggregate"]
    q4 = port_results["q4"][2]
    assert q4.site_kinds == ["join", "aggregate"] and q4.attempts == 1
    q22 = port_results["q22"][2]
    assert q22.site_kinds == ["aggregate", "join", "aggregate"]
    assert "NestedLoopJoinExec" in q22.exec_ms

