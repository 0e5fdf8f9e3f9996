"""The other eleven TPC-H queries end to end — Q2, Q7, Q8, Q9, Q11 and Q13
here, Q15, Q16, Q17, Q20 and Q21 in ``tests/test_torch_tpch_rest2.py`` —
the port's session against the JAX package's, at 16,384 lineitem rows.

They reach what the bench suite barely touches: ``Year`` (Q7, Q8, Q9),
``EndsWith`` (Q2), ``Contains`` (Q9, Q13, Q16), a two-key join with a
float key (Q2's ``ps_supplycost = min_cost``), a two-key join of
partsupp (Q9, Q20), a left outer join counting a nullable column (Q13),
cross joins of a one-row aggregate (Q11, Q15), ``distinct``, semi and
anti joins (Q16, Q20, Q21).

The port runs on the CPU, so its kernels take their plain versions. The
reference runs with ``variableFloatAgg`` on, so its float aggregates
take its device path (see ``tests/test_torch_tpch_more.py``), with its
Pallas gate off, and on (interpret mode) for one query a file
(``DEVICE``): the others are held against its CPU-oracle session there
instead (``ref_cases``). Keys, strings, counts and dates
must be equal, in the order the query sets (every one of these has an
ORDER BY, or one row); float sums to rtol 1e-12.
"""

import functools

import numpy as np
import pytest

import chip_smoke as CS

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.workloads import tpch as rtpch
from spark_rapids_tpu_torch.ops.kernels.cuda import join_probe as JP
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.workloads import tpch

ROWS = 1 << 14
#: (exact columns, float columns) of each query's answer
COLUMNS = {
    "q2": (["s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
            "ps_supplycost"], []),
    "q7": (["supp_nation", "cust_nation", "l_year"], ["revenue"]),
    "q8": (["o_year"], ["mkt_share"]),
    "q9": (["n_name", "o_year"], ["sum_profit"]),
    "q11": (["ps_partkey"], ["value"]),
    "q13": (["c_count", "custdist"], []),
    "q15": (["s_suppkey", "s_name"], ["total_revenue"]),
    "q16": (["p_brand", "p_type", "p_size", "supplier_cnt"], []),
    "q17": ([], ["avg_yearly"]),
    "q20": (["s_name"], []),
    "q21": (["s_name", "numwait"], []),
}
#: this file's queries; ``tests/test_torch_tpch_rest2.py`` takes the
#: rest (Q15 alone costs the reference about 90 s a conf here)
QUERIES = ["q2", "q7", "q8", "q9", "q11", "q13"]
REF_CONFS = {
    "pallas on": {"spark.rapids.tpu.pallas.enabled": True},
    "pallas off": {"spark.rapids.tpu.pallas.enabled": False},
    # the reference's CPU-oracle session (``spark.rapids.sql.enabled``
    # off): the same answers, in a fraction of its device path's time
    "cpu oracle": {"spark.rapids.sql.enabled": False},
}
#: The query of this file held against the reference's device path with
#: its Pallas gate on and off; the others against its CPU oracle instead
#: (its device path takes 14-60 s a query here once the gate-on path no
#: longer compiles their pieces first), and against ``chip_smoke.py``'s
#: numpy reference by the card's own check (``check_query``).
DEVICE = ["q2"]


def ref_cases(queries, device) -> list:
    """``(q, conf)`` of each query's two comparisons: with the Pallas gate
    on and off for ``device``, else the CPU oracle and the numpy
    reference."""
    return [(q, "pallas on" if q in device else "cpu oracle")
            for q in queries] + [(q, "pallas off" if q in device else "numpy")
                                 for q in queries]


def load_reference():
    tables = rtpch.gen_tables(ROWS)
    out = {}
    for name, conf in REF_CONFS.items():
        s = TpuSession({"spark.rapids.sql.enabled": True,
                        "spark.rapids.sql.variableFloatAgg.enabled": True,
                        **conf})
        out[name] = rtpch.load(s, tables)
    return out


def run_port(queries) -> dict:
    """Each query's result on the CPU, with the ``joinProbe`` wrapper's
    calls counted."""
    calls = [0]
    jp = JP.dense_build_probe

    def count_jp(*a, **k):
        calls[0] += 1
        return jp(*a, **k)

    session = TorchSession(device="cpu")
    dfs = tpch.load(session, tpch.gen_tables(ROWS))
    results = {}
    JP.dense_build_probe = count_jp
    try:
        for q in queries:
            before = calls[0]
            out = tpch.QUERIES[q](dfs).collect()
            results[q] = (out, calls[0] - before)
    finally:
        JP.dense_build_probe = jp
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


@pytest.fixture(scope="module")
def ref_dfs():
    return load_reference()


@pytest.fixture(scope="module")
def port_results():
    return run_port(QUERIES)


@functools.lru_cache(maxsize=1)
def port_tables() -> dict:
    return tpch.gen_tables(ROWS)


def check_query(q, conf, ref_dfs, port_results) -> None:
    """The port's answer against the reference's ``conf`` session, or,
    for ``"numpy"``, against ``chip_smoke.py``'s numpy reference of the
    query by the card's own check (``rest_check``: exact keys, float sums
    to its 1e-9, Q11 as a top-n)."""
    got_batch = port_results[q][0]
    if conf == "numpy":
        ref = CS.NUMPY_REFS[q](port_tables())
        assert len(next(iter(ref.values()))) > 0
        CS.rest_check(q, {q: ref})(got_batch)
        return
    want = _ref_columns(rtpch.QUERIES[q](ref_dfs[conf]).collect())
    exact, floats = COLUMNS[q]
    assert set(got_batch.columns) == set(want) == set(exact + floats)
    n = len(next(iter(want.values())))
    assert n > 0
    for name in got_batch.columns:
        assert got_batch.validity[name].all(), name
        assert len(got_batch.columns[name]) == n, name
    got = got_batch.columns
    for name in exact:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        if w.dtype == object:
            g, w = g.astype(str), w.astype(str)
        np.testing.assert_array_equal(g, w, err_msg=name)
    for name in floats:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-12,
                                   atol=0, err_msg=name)


@pytest.mark.parametrize("q,conf", ref_cases(QUERIES, DEVICE))
def test_query_matches_reference(q, conf, ref_dfs, port_results):
    check_query(q, conf, ref_dfs, port_results)


@pytest.mark.parametrize("q", QUERIES)
def test_query_path_calls_the_join_wrapper(q, port_results):
    """Every one of these queries has a single-int-key join whose build
    side the direct-address table takes, so ``joinProbe`` is on its path
    (here its plain version)."""
    assert port_results[q][1] >= 1
