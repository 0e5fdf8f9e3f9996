"""TPC-H Q3 end to end: the port's session against the JAX package's.

At ``lineitem_rows=1<<14`` the orders keys span ~4k values and the order
dates ~2.3k days, so the dense aggregate's slot table (2**21) overflows:
its fail flag trips and both sessions re-run the group-by on the sort
path. The port runs on the CPU, so its kernels take their plain
versions; the reference runs with its Pallas gate on (interpret mode)
and off.

Keys, dates and order must be equal. Revenue is held to rtol 1e-12: it
is a float sum per group, and both packages add a group's rows in row
order on the CPU, so the sums agree up to the association of a scatter.
"""

import numpy as np
import pyarrow as pa
import pytest

import torch

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.workloads import tpch as rtpch
from spark_rapids_tpu_torch.ops.kernels.cuda import join_probe as JP
from spark_rapids_tpu_torch.ops.kernels.cuda import segmented as SEG
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.workloads import tpch

ROWS = 1 << 14


@pytest.fixture(scope="module")
def ref_tables():
    return rtpch.gen_tables(ROWS)


@pytest.fixture(scope="module")
def port_tables():
    return tpch.gen_tables(ROWS)


def _ref_q3(tables, pallas: bool) -> dict:
    s = TpuSession({"spark.rapids.sql.enabled": True,
                    "spark.rapids.tpu.pallas.enabled": pallas})
    out = rtpch.q3(rtpch.load(s, tables)).collect()
    return {"o_orderkey": out.column("o_orderkey").to_numpy(),
            "o_orderdate": out.column("o_orderdate").cast("int32").to_numpy(),
            "revenue": out.column("revenue").to_numpy()}


@pytest.fixture(scope="module")
def ref_q3_pallas(ref_tables):
    return _ref_q3(ref_tables, True)


@pytest.fixture(scope="module")
def ref_q3_plain(ref_tables):
    return _ref_q3(ref_tables, False)


@pytest.fixture(scope="module")
def port_q3(port_tables):
    """The port's Q3 on the CPU, with the kernel wrappers' calls counted."""
    calls = {"joinProbe": 0, "segmented": 0}
    jp, seg = JP.dense_build_probe, SEG.segment_reduce_sorted

    def count_jp(*a):
        calls["joinProbe"] += 1
        return jp(*a)

    def count_seg(*a):
        calls["segmented"] += 1
        return seg(*a)

    session = TorchSession(device="cpu")
    dfs = tpch.load(session, port_tables)
    JP.dense_build_probe, SEG.segment_reduce_sorted = count_jp, count_seg
    try:
        first = tpch.q3(dfs).collect()
        first_info = session.last_query
        again = tpch.q3(dfs).collect()
    finally:
        JP.dense_build_probe, SEG.segment_reduce_sorted = jp, seg
    return first, first_info, again, session.last_query, calls


def test_gen_tables_equal_reference(ref_tables, port_tables):
    assert set(ref_tables) == set(port_tables)
    for name, rb in ref_tables.items():
        hb = port_tables[name]
        assert rb.schema.names == hb.schema.names, name
        for i, cname in enumerate(rb.schema.names):
            arr = rb.column(i)
            got = hb.columns[cname]
            if arr.type.equals(pa.date32()):
                want = arr.cast("int32").to_numpy()
                assert hb.schema[cname].data_type.name == "date"
            elif got.dtype.kind == "U":
                want = np.asarray(arr.to_pylist())
            else:
                want = arr.to_numpy()
            assert got.dtype == want.dtype or got.dtype.kind == "U", cname
            np.testing.assert_array_equal(got, want, err_msg=cname)


def _assert_q3_equal(got, want):
    for k in ("o_orderkey", "o_orderdate"):
        np.testing.assert_array_equal(got.columns[k], want[k], err_msg=k)
    np.testing.assert_allclose(got.columns["revenue"], want["revenue"],
                               rtol=1e-12, atol=0)
    assert len(got.columns["revenue"]) == 10


def test_q3_matches_reference_pallas_interpret(port_q3, ref_q3_pallas):
    _assert_q3_equal(port_q3[0], ref_q3_pallas)


def test_q3_matches_reference_pallas_off(port_q3, ref_q3_plain):
    _assert_q3_equal(port_q3[0], ref_q3_plain)


def test_q3_runs_sort_path_aggregate_after_dense_trip(port_q3):
    first, info, again, info2, calls = port_q3
    assert info.site_kinds == ["join", "join", "aggregate", "topk"]
    agg = info.site_kinds.index("aggregate")
    # the dense aggregate tripped and the query re-ran on the sort path
    assert info.attempts > 1 and info.dense_modes[agg] == 1
    # the learned modes stick: the second run settles in one attempt
    assert info2.attempts == 1 and info2.dense_modes == info.dense_modes
    # both joins stayed on the direct-address table (modes 1 or 2)
    assert all(info.dense_modes[s] <= 1 for s in (0, 1))
    assert calls["joinProbe"] > 0 and calls["segmented"] > 0
    for k in ("o_orderkey", "o_orderdate", "revenue"):
        np.testing.assert_array_equal(again.columns[k], first.columns[k])


def test_q3_plan_shape(port_tables):
    s = TorchSession(device="cpu")
    tree = s.explain(tpch.q3(tpch.load(s, port_tables))._plan)
    ops = [line.split()[0] for line in tree.splitlines()]
    # the planner puts a coalesce under the top-k and the aggregate
    assert ops[:6] == ["TopK", "CoalesceBatches", "HashAggregate",
                       "CoalesceBatches", "Project", "ShuffledHashJoin"]
    assert ops.count("ShuffledHashJoin") == 2 and ops.count("Filter") == 3


def test_cpu_run_launches_no_kernel(port_q3):
    assert isinstance(port_q3[0].columns["revenue"], np.ndarray)
    assert JP.dense_build_probe.launches == 0 or torch.cuda.is_available()
    assert SEG.segment_reduce_sorted.launches == 0 \
        or torch.cuda.is_available()
