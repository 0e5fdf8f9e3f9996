"""Batch coalescing (``exec/coalesce.py``) against the JAX package's:
the goal algebra, where the planners insert coalesce nodes, and an
exchange of 64 blocks (two hash repartitions of 8) into an aggregate,
whose coalesce takes 64 blocks in and hands 8 batches on (one a
partition), with the reference's answer. Both sessions run their
streaming paths for the metric comparison (the reference records no
metric inside a fused program); the port's fused path gives the same
answer.
"""

import numpy as np
import pytest
import pyarrow as pa

from harness import tpu_session
from spark_rapids_tpu.exec import coalesce as RC
from spark_rapids_tpu.ops import aggregates as RA
from spark_rapids_tpu.ops import windows as RW
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.plan.logical import SortOrder as RSortOrder
from spark_rapids_tpu_torch.exec import coalesce as PC
from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops import windows as W
from spark_rapids_tpu_torch.ops.expression import col
from spark_rapids_tpu_torch.plan.logical import SortOrder
from spark_rapids_tpu_torch.session import TorchSession

N = 5000


def _goals(mod):
    return [mod.TargetSize(10), mod.TargetSize(100), mod.RequireSingleBatch()]


def test_satisfied_by_matrix_equals_reference():
    want = [[a.satisfied_by(b) for b in _goals(RC)] for a in _goals(RC)]
    got = [[a.satisfied_by(b) for b in _goals(PC)] for a in _goals(PC)]
    assert got == want
    assert [repr(g) for g in _goals(PC)] == [repr(g) for g in _goals(RC)]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    return {"k": rng.integers(0, 40, N), "v": rng.integers(-9, 9, N),
            "t": rng.integers(0, 1000, N)}


def _frames(data, fusion=True):
    port = TorchSession({"spark.rapids.tpu.fusion.enabled": fusion},
                        device="cpu")
    ref = tpu_session(**{"spark.rapids.sql.variableFloatAgg.enabled": True,
                         "spark.rapids.tpu.fusion.enabled": fusion})
    return (port, port.create_dataframe(data)), \
        (ref, ref.create_dataframe(pa.table(data)))


def _queries(side, df):
    c = col if side == "port" else rcol
    Ag = A if side == "port" else RA
    Wn = W if side == "port" else RW
    SO = SortOrder if side == "port" else RSortOrder
    agg = Ag.AggregateExpression(Ag.Sum(c("v")), "s")
    return {
        "aggregate_after_exchange":
            df.repartition(8).repartition(8, c("k")).group_by(c("k"))
            .agg(agg),
        "window": df.with_windows(rn=Wn.RowNumber().over(
            Wn.Window.partition_by("k").order_by("t"))),
        "top_k": df.sort(SO(c("t"), ascending=False)).limit(7),
    }


def _coalesce_goals(plan, cls):
    out = []

    def walk(p):
        if isinstance(p, cls):
            out.append(repr(p.goal))
        for ch in p.children:
            walk(ch)
    walk(plan)
    return out


@pytest.mark.parametrize("query", ["aggregate_after_exchange", "window",
                                   "top_k"])
def test_insert_coalesce_goals_equal_reference(data, query):
    (ps, pdf), (rs, rdf) = _frames(data)
    got = _coalesce_goals(ps.plan(_queries("port", pdf)[query]._plan),
                          PC.CoalesceBatchesExec)
    want = _coalesce_goals(rs.plan(_queries("ref", rdf)[query]._plan),
                           RC.TpuCoalesceBatchesExec)
    assert got == want


def test_insert_coalesce_replaces_a_weaker_goal(data):
    (ps, pdf), _ = _frames(data)
    plan = ps.plan(_queries("port", pdf)["aggregate_after_exchange"]._plan)
    again = PC.insert_coalesce(plan, 1 << 20)
    assert _coalesce_goals(again, PC.CoalesceBatchesExec) == \
        ["TargetSize(1048576)"]
    small = PC.insert_coalesce(plan, 1 << 21)
    assert _coalesce_goals(small, PC.CoalesceBatchesExec) == \
        ["TargetSize(2097152)"]


def _sorted_rows(cols, names):
    order = np.lexsort([np.asarray(cols[n]) for n in names[::-1]])
    return {n: np.asarray(cols[n])[order] for n in names}


@pytest.mark.parametrize("fusion", [False, True])
def test_exchange_of_64_blocks_coalesces_to_8(data, fusion):
    (ps, pdf), (rs, rdf) = _frames(data, fusion=False)
    if fusion:
        ps = TorchSession(device="cpu")
        pdf = ps.create_dataframe(data)
    got = _queries("port", pdf)["aggregate_after_exchange"].collect()
    want = _queries("ref", rdf)["aggregate_after_exchange"].collect()
    g = _sorted_rows(got.columns, ["k", "s"])
    w = _sorted_rows({n: want.column(n).to_numpy() for n in ("k", "s")},
                     ["k", "s"])
    for n in ("k", "s"):
        np.testing.assert_array_equal(g[n], w[n])
    port_m = ps.last_query_profile().to_dict()
    ref_m = rs.last_query_profile().to_dict()

    def coalesce_metrics(tree, name):
        if tree["name"] == name:
            return tree["metrics"]
        for c in tree["children"]:
            m = coalesce_metrics(c, name)
            if m is not None:
                return m
    pm = coalesce_metrics(port_m["tree"], "CoalesceBatchesExec")
    rm = coalesce_metrics(ref_m["tree"], "TpuCoalesceBatchesExec")
    assert (pm["numInputBatches"], pm["numOutputBatches"]) == \
        (rm["numInputBatches"], rm["numOutputBatches"]) == (64, 8)


def test_coalesce_frees_its_catalog_entries(data):
    (ps, pdf), _ = _frames(data, fusion=False)
    _queries("port", pdf)["aggregate_after_exchange"].collect()
    assert ps.device_manager.catalog.device_bytes == 0
