"""The overrides pass (``plan/overrides.py``) against the reference's
(``spark_rapids_tpu/plan/overrides.py``).

* Every exec rule's switch (``spark.rapids.sql.exec.<Name>`` false) sends
  that operator to the host, with the reference's reason in the explain
  text, and the answer equals the reference's under the same switch (its
  session in test mode with ``allowedNonTpu`` naming the operator, as
  ``tests/test_queries.py:243-272`` does; the reference's conf refuses
  the per-operator keys, so the test sets it on the session's conf).
  An expression switch does the same for the operator that holds it.
* Test mode raises ``FallbackOnTpuError`` for an operator on the host
  unless ``allowedNonTpu`` names it.
* The NOT_ON_TPU explain lines equal the reference's, word for word.
* Every TPC-H, TPCxBB and TPC-DS query of ``workloads/`` plans with no
  host node in test mode (2^12-row tables on the CPU).

Answers compare as row multisets: integers and strings exactly, floats
to 1e-9 relative.
"""

import numpy as np
import pyarrow as pa
import pytest

from harness import tpu_session

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.ops import aggregates as RA
from spark_rapids_tpu.ops import arithmetic as RAR
from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops import strings2 as RS2
from spark_rapids_tpu.ops import windows as RW
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit
from spark_rapids_tpu.plan.logical import SortOrder as RSortOrder
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import TorchConf
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops import arithmetic as AR
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops import strings2 as S2
from spark_rapids_tpu_torch.ops import windows as W
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.plan import overrides as O
from spark_rapids_tpu_torch.plan.logical import SortOrder
from spark_rapids_tpu_torch.session import TorchSession

from test_torch_cpu_exec import assert_same

N = 300


def _data(seed: int = 1):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 10, N).astype(np.int64),
            "v": rng.integers(-50, 50, N).astype(np.int64),
            "s": np.array(["a,b", "c", "d,e,f", ""])[rng.integers(0, 4, N)]}


def _port_frames(conf):
    s = TorchSession(conf, device="cpu")
    d = _data()
    other = {"rk": np.arange(10, dtype=np.int64),
             "w": np.arange(10, dtype=np.int64) * 7}
    return s, s.create_dataframe(d), s.create_dataframe(other)


def _ref_frames(conf: dict, key: str):
    s = tpu_session(**conf)
    s.conf._conf[key] = False  # the reference's conf refuses the key
    d = _data()
    t = s.create_dataframe(pa.RecordBatch.from_arrays(
        [pa.array(d["k"]), pa.array(d["v"]), pa.array(d["s"])],
        names=["k", "v", "s"]))
    o = s.create_dataframe(pa.RecordBatch.from_arrays(
        [pa.array(np.arange(10, dtype=np.int64)),
         pa.array(np.arange(10, dtype=np.int64) * 7)], names=["rk", "w"]))
    return s, t, o


def _q(pkg):
    """The queries by the rule they exercise: (build(t, o), the CPU
    operator names the switch sends to the host)."""
    A_, AR_, P_, c, l_, SO, W_ = (
        (A, AR, P, col, lit, SortOrder, W) if pkg == "port"
        else (RA, RAR, RP, rcol, rlit, RSortOrder, RW))
    agg = A_.AggregateExpression
    return {
        "Project": (lambda t, o: t.select(
            c("k"), AR_.Add(c("v"), l_(1)).alias("v1")),
            ["CpuProjectExec"]),
        "Filter": (lambda t, o: t.where(P_.GreaterThan(c("v"), l_(0))),
                   ["CpuFilterExec"]),
        "HashAggregate": (lambda t, o: t.group_by(c("k")).agg(
            agg(A_.Sum(c("v")), "sv"), agg(A_.Count(), "n")),
            ["CpuHashAggregateExec"]),
        "ShuffledHashJoin": (lambda t, o: t.join(
            o, on=P_.EqualTo(c("k"), c("rk"))),
            ["CpuJoinExec", "CpuBroadcastHashJoinExec"]),
        "BroadcastNestedLoopJoin": (lambda t, o: t.join(
            o, on=P_.LessThan(c("v"), c("w"))),
            ["CpuNestedLoopJoinExec"]),
        "Sort": (lambda t, o: t.sort(SO(c("v")), SO(c("k")), SO(c("s"))),
                 ["CpuSortExec"]),
        "GlobalLimit": (lambda t, o: t.sort(SO(c("v")), SO(c("k")),
                                            SO(c("s"))).limit(7),
                        ["CpuLimitExec"]),
        "LocalLimit": (lambda t, o: t.sort(SO(c("v")), SO(c("k")),
                                           SO(c("s"))).limit(7),
                       ["CpuLocalLimitExec"]),
        "Union": (lambda t, o: t.select(c("k")).union(o.select(c("rk"))),
                  ["CpuUnionExec"]),
        "Expand": (lambda t, o: t.rollup(c("k")).agg(
            agg(A_.Count(), "n")), ["CpuExpandExec"]),
        "Window": (lambda t, o: t.with_windows(rn=W_.RowNumber().over(
            W_.Window.partition_by("k").order_by(
                SO(c("v")), SO(c("s"))))), ["CpuWindowExec"]),
    }


RULES = sorted(_q("port"))
ORDERED = {"Sort", "GlobalLimit", "LocalLimit"}


@pytest.mark.parametrize("rule", RULES)
def test_exec_switch_sends_the_operator_to_the_host(rule):
    key = TorchConf.operator_conf_key("exec", rule)
    build, names = _q("port")[rule]
    allowed = ",".join(names)
    conf = {key: False, "spark.rapids.sql.test.enabled": True,
            "spark.rapids.sql.test.allowedNonTpu": allowed,
            "spark.rapids.sql.explain": "NOT_ON_TPU"}
    s, t, o = _port_frames(conf)
    df = build(t, o)
    plan = s.plan(df._plan)
    assert set(O.host_nodes(plan)) <= set(names) and O.host_nodes(plan)
    assert f"{key} is disabled" in s.last_explain
    rconf = {"spark.rapids.sql.test.allowedNonTpu": allowed,
             "spark.rapids.sql.variableFloatAgg.enabled": True}
    rs, rt, ro = _ref_frames(rconf, key)
    if rule == "ShuffledHashJoin":
        rs.conf._conf[TorchConf.operator_conf_key(
            "exec", "BroadcastHashJoin")] = False
    rbuild, _ = _q("ref")[rule]
    assert_same(df.collect(), rbuild(rt, ro).collect(),
                ordered=rule in ORDERED)


def test_generate_switch_sends_explode_to_the_host():
    key = TorchConf.operator_conf_key("exec", "Generate")
    s = TorchSession({key: False, "spark.rapids.sql.explain": "ALL"},
                     device="cpu")
    df = s.create_dataframe(
        HostBatch.from_numpy({"k": np.arange(5, dtype=np.int64),
                              "a": np.array([[1, 2], [], None, [3], [4, 5]],
                                            dtype=object)},
                             T.Schema([T.StructField("k", T.LONG),
                                       T.StructField("a",
                                                     T.ArrayType(T.LONG))])))
    got = df.explode(col("a"), name="e").collect()
    assert "CpuGenerateExec" in O.host_nodes(s.plan(df.explode(
        col("a"), name="e")._plan))
    assert f"! CpuGenerateExec cannot run on TPU because {key} is " \
           "disabled" in s.last_explain
    assert list(got.columns["k"]) == [0, 0, 3, 4, 4]
    assert list(got.columns["e"]) == [1, 2, 3, 4, 5]


def test_expression_switch_sends_its_operator_to_the_host():
    key = TorchConf.operator_conf_key("expression", "Add")
    s, t, o = _port_frames({key: False,
                            "spark.rapids.sql.explain": "NOT_ON_TPU"})
    df = t.select(col("k"), AR.Add(col("v"), lit(1)).alias("v1"))
    assert O.host_nodes(s.plan(df._plan)) == ["CpuProjectExec"]
    assert f"{key} is disabled" in s.last_explain
    got = df.collect()
    d = _data()
    assert list(got.columns["v1"]) == list(d["v"] + 1)


def test_test_mode_raises_for_a_host_operator():
    key = TorchConf.operator_conf_key("exec", "Filter")
    s, t, o = _port_frames({key: False,
                            "spark.rapids.sql.test.enabled": True})
    df = t.where(P.GreaterThan(col("v"), lit(0)))
    with pytest.raises(O.FallbackOnTpuError, match="CpuFilterExec"):
        df.collect()
    s2, t2, _ = _port_frames({
        key: False, "spark.rapids.sql.test.enabled": True,
        "spark.rapids.sql.test.allowedNonTpu": "CpuFilterExec"})
    assert t2.where(P.GreaterThan(col("v"), lit(0))).collect().num_rows == \
        int((_data()["v"] > 0).sum())


def test_an_unknown_operator_key_raises():
    conf = TorchConf({"spark.rapids.sql.exec.NoSuchExec": False})
    with pytest.raises(KeyError, match="NoSuchExec"):
        O.TorchOverrides(conf)
    with pytest.raises(KeyError, match="NoSuchExpr"):
        O.TorchOverrides(TorchConf(
            {"spark.rapids.sql.expression.NoSuchExpr": True}))
    O.TorchOverrides(TorchConf({"spark.rapids.sql.exec.Filter": False,
                                "spark.rapids.sql.expression.Add": True}))


def _explain_lines(text: str) -> list:
    return sorted(line.strip() for line in text.splitlines()
                  if line.strip().startswith("!"))


@pytest.mark.parametrize("case", ["float sum", "split", "switch"])
def test_explain_reasons_match_the_reference(case):
    """The NOT_ON_TPU lines (node and reasons) of one plan, the port's and
    the reference's, word for word."""
    explain = {"spark.rapids.sql.explain": "NOT_ON_TPU"}
    if case == "float sum":
        pconf = {**explain, "spark.rapids.sql.variableFloatAgg.enabled":
                 False}
        rconf = dict(pconf)
    elif case == "switch":
        key = TorchConf.operator_conf_key("exec", "HashAggregate")
        pconf = {**explain, key: False}
        rconf = {**explain,
                 "spark.rapids.sql.variableFloatAgg.enabled": True}
    else:
        pconf = rconf = explain
    s = TorchSession(pconf, device="cpu")
    d = _data()
    x = np.linspace(-1, 1, N)
    t = s.create_dataframe({"k": d["k"], "x": x, "s": d["s"]})
    from spark_rapids_tpu.session import TpuSession
    rs = TpuSession({**rconf, "spark.rapids.sql.enabled": True})
    if case == "switch":
        rs.conf._conf[key] = False
    rt = rs.create_dataframe(pa.RecordBatch.from_arrays(
        [pa.array(d["k"]), pa.array(x), pa.array(d["s"])],
        names=["k", "x", "s"]))
    if case == "split":
        pdf = t.select(col("k"), S2.StringSplit(col("s"), ",").alias("p"))
        rdf = rt.select(rcol("k"), RS2.StringSplit(rcol("s"), ",").alias(
            "p"))
    else:
        pdf = t.group_by(col("k")).agg(A.AggregateExpression(
            A.Sum(col("x")), "sx"))
        rdf = rt.group_by(rcol("k")).agg(RA.AggregateExpression(
            RA.Sum(rcol("x")), "sx"))
    s.plan(pdf._plan)
    rs.plan(rdf._plan)
    got = _explain_lines(s.last_explain)
    assert got and got == _explain_lines(rs._overrides.last_explain)


def _sweep(session, queries, frames) -> int:
    from spark_rapids_tpu_torch.plan.logical import DataFrame
    bound = {k: DataFrame(v._plan, session) for k, v in frames.items()}
    hosts = 0
    for fn in queries.values():
        hosts += len(O.host_nodes(session.plan(fn(bound)._plan)))
    return hosts


@pytest.mark.parametrize("workload", ["tpch", "tpcxbb", "tpcds"])
def test_every_workload_query_plans_on_the_device(workload):
    """In test mode, with the default confs and the streaming path's, no
    query of the workload plans a host node (a host node would raise
    ``FallbackOnTpuError``)."""
    import importlib
    wl = importlib.import_module(
        f"spark_rapids_tpu_torch.workloads.{workload}")
    for conf in ({}, {"spark.rapids.tpu.fusion.enabled": False}):
        s = TorchSession({**conf, "spark.rapids.sql.test.enabled": True},
                         device="cpu")
        frames = wl.load(s, wl.gen_tables(1 << 12, seed=3))
        assert _sweep(s, wl.QUERIES, frames) == 0


def test_host_nodes_are_boundaries_of_the_device_machinery():
    """A host node (its transitions) is a boundary of fusion (the region
    above it reads its upload as an input), keeps the plan off the mesh,
    appears in the profile's node walk, and changes the plan signature;
    the answer is the host-only session's."""
    from spark_rapids_tpu_torch.exec import fusion as FU
    from spark_rapids_tpu_torch.exec import mesh as MX
    key = TorchConf.operator_conf_key("exec", "HashAggregate")
    s, t, _ = _port_frames({key: False,
                            "spark.rapids.tpu.mesh.enabled": True})
    df = t.where(P.GreaterThan(col("v"), lit(0))).group_by(col("k")).agg(
        A.AggregateExpression(A.Sum(col("v")), "sv")).sort(SortOrder(
            col("k"))).limit(5)
    plan = s.plan(df._plan)
    assert plan.columnar and O.host_nodes(plan) == ["CpuHashAggregateExec"]
    boundaries = []
    FU._split(plan, boundaries, FU._inline_types())
    assert any(b.node_name() == "HostToDeviceExec" or any(
        "HostToDevice" in line for line in b.tree_string().splitlines())
        for b in boundaries)
    assert not MX.mesh_capable(plan)
    got = df.collect()
    assert s.last_query.path == "single"
    names = []

    def walk(node):
        names.append(node["name"])
        for c in node["children"]:
            walk(c)
    walk(s.last_query_profile().tree)
    assert "CpuHashAggregateExec" in names and "HostToDeviceExec" in names
    plain, pt, _ = _port_frames({})
    assert s._signature(plan) != plain._signature(plain.plan(
        pt.where(P.GreaterThan(col("v"), lit(0))).group_by(col("k")).agg(
            A.AggregateExpression(A.Sum(col("v")), "sv")).sort(SortOrder(
                col("k"))).limit(5)._plan))
    off, ot, _ = _port_frames({"spark.rapids.sql.enabled": False})
    want = ot.where(P.GreaterThan(col("v"), lit(0))).group_by(
        col("k")).agg(A.AggregateExpression(A.Sum(col("v")), "sv")).sort(
            SortOrder(col("k"))).limit(5).collect()
    assert list(got.columns["k"]) == list(want.columns["k"])
    assert list(got.columns["sv"]) == list(want.columns["sv"])
