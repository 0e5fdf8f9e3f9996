"""Plan lint of the port (``spark_rapids_tpu_torch/analysis/plan_lint.py``)
against the reference's (``spark_rapids_tpu/analysis/plan_lint.py``):
the same corrupted plan in each checked dimension (schema, cast,
transition, partitioning, writer width), built in both packages, gives
the same violations as sets of (check, severity), with the port's class
names in its node paths; ``legal_cast`` agrees on every pair of types both
packages have; every query of the port's workloads plans clean; and the
session verifies every plan, falls a warn back to the CPU plan with the
same answer, and raises in test mode and under ``failOnWarn``.
"""

import warnings

import numpy as np
import pyarrow as pa
import pytest

from harness import cpu_session, tpu_session

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.analysis import plan_lint as RL
from spark_rapids_tpu.exec import execs as RE
from spark_rapids_tpu.ops.expression import AttributeReference as RAttr
from spark_rapids_tpu.ops.expression import BoundReference as RBound
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.plan import physical as RP
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.workloads import tpch as rtpch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.analysis import plan_lint as PL
from spark_rapids_tpu_torch.analysis.plan_lint import (PlanLintError,
                                                       lint_plan, verify_plan)
from spark_rapids_tpu_torch.config import TorchConf
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.exec import execs as E
from spark_rapids_tpu_torch.io.writers import WriteFilesExec
from spark_rapids_tpu_torch.ops.cast import Cast
from spark_rapids_tpu_torch.ops.expression import (AttributeReference,
                                                   BoundReference, Literal,
                                                   col)
from spark_rapids_tpu_torch.ops.predicates import EqualTo, IsNull
from spark_rapids_tpu_torch.plan import physical as P
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.shuffle.exchange import ShuffleExchangeExec
from spark_rapids_tpu_torch.shuffle.partitioners import partitioner_factory
from spark_rapids_tpu_torch.workloads import mortgage, tpcds, tpch, tpcxbb

_PORT_TYPES = {"boolean": T.BOOLEAN, "tinyint": T.BYTE, "smallint": T.SHORT,
               "int": T.INT, "bigint": T.LONG, "float": T.FLOAT,
               "double": T.DOUBLE, "date": T.DATE, "timestamp": T.TIMESTAMP,
               "string": T.STRING}
_REF_TYPES = {"boolean": RT.BOOLEAN, "tinyint": RT.BYTE, "smallint": RT.SHORT,
              "int": RT.INT, "bigint": RT.LONG, "float": RT.FLOAT,
              "double": RT.DOUBLE, "date": RT.DATE, "timestamp": RT.TIMESTAMP,
              "string": RT.STRING}


def _keys(vs):
    return {(v.check, v.severity) for v in vs}


# -- leaves of both packages --------------------------------------------------


def _values(dt_name, n):
    if dt_name == "string":
        return np.array([f"v{i}" for i in range(n)], dtype=object)
    if dt_name == "boolean":
        return np.arange(n) % 2 == 0
    return np.arange(n)


def _device_source(schema_dict, n=4):
    """An uploaded table of the port (a device node)."""
    fields = [T.StructField(k, _PORT_TYPES[v], True)
              for k, v in schema_dict.items()]
    schema = T.Schema(fields)
    data = {k: _values(v, n).astype(_PORT_TYPES[v].np_dtype)
            if v != "string" else _values(v, n)
            for k, v in schema_dict.items()}
    hb = HostBatch.from_numpy(data, schema)
    import torch
    return E.DeviceSourceExec(hb.to_device(torch.device("cpu")))


def _scan(schema_dict, n=4):
    """A host leaf of the port: an uploaded table's download."""
    return E.DeviceToHostExec(_device_source(schema_dict, n), mid_plan=True)


def _rscan(schema_dict, n=4):
    """The reference's host leaf (its test's ``_scan``)."""
    arrays, fields = [], []
    for name, tname in schema_dict.items():
        dt = _REF_TYPES[tname]
        at = RT.to_arrow_type(dt)
        if dt is RT.STRING:
            arrays.append(pa.array([f"v{i}" for i in range(n)], at))
        elif dt is RT.BOOLEAN:
            arrays.append(pa.array([i % 2 == 0 for i in range(n)], at))
        else:
            arrays.append(pa.array(list(range(n)), pa.int64()).cast(at))
        fields.append(RT.StructField(name, dt, True))
    schema = RT.Schema(fields)
    rb = pa.RecordBatch.from_arrays(arrays,
                                    schema=RT.schema_to_arrow(schema))
    return RP.CpuLocalScanExec([rb], schema)


def _both(stage, port_plan, ref_plan):
    """Both packages' violations of one injected fault."""
    port, ref = lint_plan(port_plan, stage), RL.lint_plan(ref_plan, stage)
    assert _keys(port) == _keys(ref)
    return port, ref


# -- clean plans --------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch_tables():
    return tpch.gen_tables(1 << 10, seed=7)


def test_reference_tpch_plans_clean():
    tables = rtpch.gen_tables(1 << 10, seed=7)
    for query in ("q1", "q6", "q19"):
        for s in (cpu_session(), tpu_session(**{
                "spark.rapids.sql.variableFloatAgg.enabled": True})):
            df = rtpch.QUERIES[query](rtpch.load(s, tables, cache=False))
            assert RL.lint_plan(s.plan(df._plan)) == []


@pytest.mark.parametrize("conf", [
    {}, {"spark.rapids.sql.enabled": False},
    {"spark.rapids.tpu.fusion.enabled": False}], ids=["device", "cpu",
                                                       "stream"])
def test_every_tpch_plan_clean(tpch_tables, conf):
    s = TorchSession(conf, device="cpu")
    d = tpch.load(s, tpch_tables)
    for name, fn in tpch.QUERIES.items():
        phys, lint = s.plan_with_lint(fn(d)._plan)
        assert lint["warns"] == 0 and not lint["fallback"], name
        root = phys if not phys.columnar else E.DeviceToHostExec(phys)
        assert lint_plan(root) == [], name


def _plans_clean(s, queries, frames):
    bad = {}
    for name, fn in queries.items():
        phys = s.plan(fn(frames)._plan)
        root = phys if not phys.columnar else E.DeviceToHostExec(phys)
        found = lint_plan(root)
        if found:
            bad[name] = [str(v) for v in found]
    return bad


def test_every_tpcds_plan_clean():
    s = TorchSession(device="cpu")
    d = tpcds.load(s, tpcds.gen_tables(1 << 11, seed=11))
    assert _plans_clean(s, tpcds.QUERIES, d) == {}


def test_every_tpcxbb_and_mortgage_plan_clean():
    s = TorchSession(device="cpu")
    d = tpcxbb.load(s, tpcxbb.gen_tables(1 << 11, seed=23))
    assert _plans_clean(s, tpcxbb.QUERIES, d) == {}
    m = mortgage.load(s, mortgage.gen_tables(1 << 10, seed=7))
    assert _plans_clean(s, {"etl": mortgage.etl,
                            "features": mortgage.ml_features}, m) == {}


def test_session_plan_runs_the_verifier(tpch_tables, monkeypatch):
    s = TorchSession(device="cpu")
    d = tpch.load(s, tpch_tables)
    calls = []
    real = PL.lint_plan

    def spy(plan, stage="post-overrides"):
        calls.append(stage)
        return real(plan, stage)
    monkeypatch.setattr(PL, "lint_plan", spy)
    s.plan(tpch.q1(d)._plan)
    assert calls == ["planned", "post-overrides"]
    calls.clear()
    off = TorchSession({"spark.rapids.tpu.planLint.enabled": False},
                       device="cpu")
    off.plan(tpch.q1(tpch.load(off, tpch_tables))._plan)
    assert calls == []


# -- dimension 1: schema ------------------------------------------------------


def test_missing_column_reference():
    port, _ = _both(
        "planned",
        P.CpuFilterExec(_scan({"a": "bigint"}),
                        IsNull(AttributeReference("nope", T.LONG))),
        RP.CpuFilterExec(_rscan({"a": "bigint"}),
                         RAttr("nope", RT.LONG).is_null()))
    assert any(v.check == "schema" and "nope" in v.message for v in port)
    assert any(v.node_path.startswith("CpuFilterExec") for v in port)


def test_join_output_dtype_mismatch():
    corrupt = T.Schema([T.StructField("a", T.LONG, True),
                        T.StructField("b", T.STRING, True)])
    rcorrupt = RT.Schema([RT.StructField("a", RT.LONG, True),
                          RT.StructField("b", RT.STRING, True)])
    port, _ = _both(
        "planned",
        P.CpuJoinExec(_scan({"a": "bigint"}), _scan({"b": "bigint"}),
                      "inner", [col("a")], [col("b")], corrupt),
        RP.CpuJoinExec(_rscan({"a": "bigint"}), _rscan({"b": "bigint"}),
                       "inner", [rcol("a")], [rcol("b")], rcorrupt))
    assert any("join output column 1" in v.message for v in port)


def test_union_arity_mismatch():
    one, two = _scan({"a": "bigint"}), _scan({"a": "bigint", "b": "bigint"})
    rone = _rscan({"a": "bigint"})
    port, _ = _both(
        "planned", P.CpuUnionExec([one, two], one.schema),
        RP.CpuUnionExec([rone, _rscan({"a": "bigint", "b": "bigint"})],
                        rone.schema))
    assert any("union child 1" in v.message for v in port)


def test_bound_ordinal_out_of_range():
    port, _ = _both(
        "planned",
        P.CpuFilterExec(_scan({"a": "bigint"}),
                        IsNull(BoundReference(3, T.LONG))),
        RP.CpuFilterExec(_rscan({"a": "bigint"}),
                         RBound(3, RT.LONG).is_null()))
    assert any("ordinal 3 out of range" in v.message for v in port)


def test_device_union_and_window_paths():
    # the device execs carry the same checks as the CPU operators
    one, two = _device_source({"a": "bigint"}), \
        _device_source({"a": "bigint", "b": "bigint"})
    found = lint_plan(E.UnionExec([one, two], one.schema), "planned")
    assert _keys(found) == {("schema", "error")}
    assert found[0].node_path == "UnionExec"


# -- dimension 2: casts -------------------------------------------------------


def _port_types():
    out = dict(_PORT_TYPES)
    out["array<int>"] = T.ArrayType(T.INT)
    out["array<double>"] = T.ArrayType(T.DOUBLE)
    out["struct"] = T.StructType([T.StructField("x", T.INT),
                                  T.StructField("y", T.STRING)])
    return out


def _ref_types():
    out = dict(_REF_TYPES)
    out["array<int>"] = RT.ArrayType(RT.INT)
    out["array<double>"] = RT.ArrayType(RT.DOUBLE)
    out["struct"] = RT.StructType([RT.StructField("x", RT.INT),
                                   RT.StructField("y", RT.STRING)])
    return out


def test_legal_cast_equals_reference_on_every_pair():
    port, ref = _port_types(), _ref_types()
    assert set(port) == set(ref)
    for a in port:
        for b in port:
            assert PL.legal_cast(port[a], port[b]) == \
                RL.legal_cast(ref[a], ref[b]), (a, b)


def test_illegal_cast_rejected_at_plan_time():
    s = TorchSession(device="cpu")
    df = s.create_dataframe({"b": np.array([True, False])})
    bad = df.select(Cast(col("b"), T.DATE).alias("d"))
    with pytest.raises(PlanLintError, match="illegal cast") as e:
        s.plan(bad._plan)
    assert _keys(e.value.violations) == {("cast", "error")}
    rs = cpu_session()
    rbad = rs.create_dataframe({"b": [True, False]}).select(
        rcol("b").cast(RT.DATE).alias("d"))
    with pytest.raises(RL.PlanLintError) as re_:
        rs.plan(rbad._plan)
    assert _keys(re_.value.violations) == _keys(e.value.violations)


def test_legal_casts_pass():
    s = TorchSession(device="cpu")
    df = s.create_dataframe({"i": np.array([1, 2]),
                             "s": np.array(["1", "2"], dtype=object)})
    ok = df.select(Cast(col("i"), T.DOUBLE).alias("d"),
                   Cast(col("s"), T.INT).alias("n"),
                   Cast(col("i"), T.STRING).alias("t"))
    phys, lint = s.plan_with_lint(ok._plan)
    assert lint["warns"] == 0
    assert lint_plan(E.DeviceToHostExec(phys)) == []


# -- dimension 3: transitions -------------------------------------------------


def test_device_exec_over_host_child():
    a = AttributeReference("a", T.LONG)
    ra = RAttr("a", RT.LONG)
    scan = _scan({"a": "bigint"})
    port, _ = _both(
        "post-overrides",
        P.CpuProjectExec(E.ProjectExec(scan, [a]), [a]),
        RP.CpuProjectExec(RE.TpuProjectExec(_rscan({"a": "bigint"}), [ra]),
                          [ra]))
    trans = [v for v in port if v.check == "transition"]
    assert any("HostToDeviceExec" in v.message for v in trans)
    assert any("DeviceToHostExec" in v.message for v in trans)
    assert all("ProjectExec" in v.node_path for v in trans)


def test_columnar_root_rejected():
    a = AttributeReference("a", T.LONG)
    plan = E.ProjectExec(E.HostToDeviceExec(_scan({"a": "bigint"})), [a])
    rplan = RE.TpuProjectExec(RE.HostToDeviceExec(_rscan({"a": "bigint"})),
                              [RAttr("a", RT.LONG)])
    port, _ = _both("post-overrides", plan, rplan)
    assert any(v.check == "transition" and "root" in v.message
               for v in port)
    # the same tree is a legal device subtree before the rewrite
    assert lint_plan(plan, "planned") == []
    assert RL.lint_plan(rplan, "planned") == []


def test_writer_over_device_child_is_legal():
    plan = WriteFilesExec(_device_source({"a": "int"}), "csv", "/unused",
                          {}, [], "overwrite")
    assert lint_plan(plan) == []


# -- dimension 4: partitioning ------------------------------------------------


def _exchange(child, keys, n):
    return ShuffleExchangeExec(child, partitioner_factory("hash", n,
                                                          keys=keys), n)


def _rexchange(child, keys, n):
    from spark_rapids_tpu.shuffle.exchange import CpuShuffleExchangeExec
    from spark_rapids_tpu.shuffle.partitioners import \
        partitioner_factory as rfactory
    return CpuShuffleExchangeExec(child, rfactory("hash", n, keys=keys), n)


def _join_pair(lcols, lkey, ln, rn, on=("a", "b")):
    out = T.Schema([T.StructField(c, T.LONG, True)
                    for c in list(lcols) + ["b"]])
    rout = RT.Schema([RT.StructField(c, RT.LONG, True)
                      for c in list(lcols) + ["b"]])
    port = P.CpuJoinExec(
        _exchange(_scan({c: "bigint" for c in lcols}), [col(lkey)], ln),
        _exchange(_scan({"b": "bigint"}), [col("b")], rn), "inner",
        [col(on[0])], [col(on[1])], out)
    ref = RP.CpuJoinExec(
        _rexchange(_rscan({c: "bigint" for c in lcols}), [rcol(lkey)], ln),
        _rexchange(_rscan({"b": "bigint"}), [rcol("b")], rn), "inner",
        [rcol(on[0])], [rcol(on[1])], rout)
    return port, ref


def test_copartition_count_mismatch_is_warn():
    port_plan, ref_plan = _join_pair(["a"], "a", 4, 8)
    port, _ = _both("planned", port_plan, ref_plan)
    bad = [v for v in port if v.check == "partitioning"]
    assert bad and bad[0].severity == "warn" and "4 vs 8" in bad[0].message
    assert bad[0].node_path == "CpuJoinExec"
    with pytest.raises(PlanLintError, match="4 vs 8"):
        verify_plan(port_plan, TorchConf({
            "spark.rapids.tpu.planLint.failOnWarn": True}), stage="planned")


def test_key_mismatch_is_warn():
    port_plan, ref_plan = _join_pair(["a", "k"], "k", 4, 4)
    _both("planned", port_plan, ref_plan)
    warns = verify_plan(port_plan, TorchConf(), stage="planned")
    assert [v.severity for v in warns] == ["warn"]
    assert "joined on" in warns[0].message
    with pytest.raises(PlanLintError):
        verify_plan(port_plan, TorchConf({
            "spark.rapids.tpu.planLint.failOnWarn": True}), stage="planned")


def test_matching_copartition_passes():
    port_plan, ref_plan = _join_pair(["a"], "a", 4, 4)
    assert lint_plan(port_plan, "planned") == []
    assert RL.lint_plan(ref_plan, "planned") == []


def test_device_join_partitioning():
    # the shuffled hash join the overrides pass makes carries the check
    out = T.Schema([T.StructField("a", T.LONG, True),
                    T.StructField("b", T.LONG, True)])
    plan = E.ShuffledHashJoinExec(
        _exchange(_device_source({"a": "bigint"}), [col("a")], 4),
        _exchange(_device_source({"b": "bigint"}), [col("b")], 2),
        "inner", [col("a")], [col("b")], out)
    found = lint_plan(plan, "planned")
    assert _keys(found) == {("partitioning", "warn")}
    assert found[0].node_path == "ShuffledHashJoinExec"


# -- the session's warn fallback ----------------------------------------------


def _mismatched(s, create, c, parts=(4, 4), keys=("k", "m")):
    left = create({"a": np.array([1, 2, 3]), "k": np.array([1, 1, 2])})
    right = create({"b": np.array([1, 2, 3]), "m": np.array([1, 2, 2])})
    return left.repartition(parts[0], c(keys[0])).join(
        right.repartition(parts[1], c(keys[1])), on=EqualTo(col("a"),
                                                            col("b"))
        if c is col else c("a").eq(c("b")))


def _names(n):
    yield type(n).__name__
    for c in n.children:
        yield from _names(c)


@pytest.mark.parametrize("parts,keys", [((4, 4), ("k", "m")),
                                        ((4, 8), ("a", "b"))],
                         ids=["keys", "counts"])
def test_warn_falls_back_to_cpu_plan_and_answers(parts, keys):
    s = TorchSession(device="cpu")
    df = _mismatched(s, s.create_dataframe, col, parts, keys)
    with pytest.warns(UserWarning, match="plan-lint"):
        plan, lint = s.plan_with_lint(df._plan)
    assert lint["fallback"] and lint["warns"] >= 1
    assert "ShuffledHashJoinExec" not in set(_names(plan))
    assert "CpuJoinExec" in set(_names(plan))
    with pytest.warns(UserWarning, match="plan-lint"):
        out = df.collect()
    assert s.last_query.lint["fallback"]
    assert s.last_query_profile().engine["planLint"]["fallback"]
    rs = TpuSession({"spark.rapids.sql.enabled": True,
                     "spark.rapids.sql.autoBroadcastJoinRows": -1})
    rdf = _mismatched(rs, lambda d: rs.create_dataframe(
        {k: v.tolist() for k, v in d.items()}), rcol, parts, keys)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = rdf.collect().to_pydict()
    got = sorted(zip(*(out.columns[n].tolist() for n in out.schema.names)))
    assert got == sorted(zip(*(ref[n] for n in out.schema.names)))


def test_warn_raises_in_test_mode_and_under_fail_on_warn():
    for conf in ({"spark.rapids.sql.test.enabled": True},
                 {"spark.rapids.tpu.planLint.failOnWarn": True}):
        s = TorchSession(conf, device="cpu")
        with pytest.raises(PlanLintError, match="joined on"):
            s.plan(_mismatched(s, s.create_dataframe, col)._plan)
    rs = TpuSession({"spark.rapids.sql.enabled": True,
                     "spark.rapids.sql.test.enabled": True,
                     "spark.rapids.sql.autoBroadcastJoinRows": -1})
    with pytest.raises(RL.PlanLintError, match="joined on"):
        rs.plan(_mismatched(rs, lambda d: rs.create_dataframe(
            {k: v.tolist() for k, v in d.items()}), rcol)._plan)


def _spy_lint(monkeypatch):
    calls = []
    real = PL.lint_plan

    def spy(plan, stage="post-overrides"):
        calls.append(stage)
        return real(plan, stage)
    monkeypatch.setattr(PL, "lint_plan", spy)
    return calls


def test_repeated_plan_takes_the_memo(tpch_tables, monkeypatch):
    s = TorchSession(device="cpu")
    d = tpch.load(s, tpch_tables)
    calls = _spy_lint(monkeypatch)
    first = tpch.q3(d).collect()
    assert s.last_query.lint["memo"] == 0
    assert calls == ["planned", "post-overrides"]
    again = tpch.q3(d).collect()  # a new DataFrame, the same plan
    assert s.last_query.lint["memo"] == 2
    assert calls == ["planned", "post-overrides"]  # no walk
    assert s.last_query_profile().engine["planLint"]["memo"] == 2
    for n in first.schema.names:
        np.testing.assert_array_equal(again.columns[n], first.columns[n])
    # a verdict holds for the conf it was reached under
    s.set_conf("spark.rapids.tpu.planLint.failOnWarn", True)
    tpch.q3(d).collect()
    assert s.last_query.lint["memo"] == 0 and len(calls) == 4


def test_memo_keeps_the_warn_fallback(monkeypatch):
    s = TorchSession(device="cpu")
    df = _mismatched(s, s.create_dataframe, col, (4, 8), ("a", "b"))
    with pytest.warns(UserWarning, match="plan-lint"):
        first = df.collect()
    calls = _spy_lint(monkeypatch)
    with pytest.warns(UserWarning, match="plan-lint"):
        again = df.collect()
    assert calls == [] and s.last_query.lint["memo"] == 2
    assert s.last_query.lint["fallback"]
    for n in first.schema.names:
        assert sorted(again.columns[n].tolist()) == \
            sorted(first.columns[n].tolist())


def test_memo_key_sees_types_and_never_keeps_an_error(monkeypatch):
    s = TorchSession(device="cpu")
    df = s.create_dataframe({"i": np.array([1, 2])})
    ok = df.select(Cast(Literal(0), T.LONG).alias("x"))
    bad = df.select(Cast(Literal(0, T.DATE), T.LONG).alias("x"))
    # the same text: a literal prints its value only
    assert s.explain(ok._plan) == s.explain(ok._plan)
    s.plan(ok._plan)
    calls = _spy_lint(monkeypatch)
    for _ in range(2):  # an error is checked again, not kept
        with pytest.raises(PlanLintError, match="illegal cast"):
            s.plan(bad._plan)
    assert calls == ["planned", "planned"]
    ints = s.create_dataframe({"i": np.array([1, 2], dtype=np.int32)})
    longs = s.create_dataframe({"i": np.array([1, 2], dtype=np.int64)})
    k32 = PL.plan_key(s.plan(ints.select(col("i"))._plan))
    k64 = PL.plan_key(s.plan(longs.select(col("i"))._plan))
    assert k32 != k64  # a column's type is in the key


def test_memo_bounded_least_recently_used_first(monkeypatch):
    monkeypatch.setattr(PL.LintMemo, "MAX_ENTRIES", 4)
    memo = PL.LintMemo()
    for i in range(4):
        memo.put(("planned", i), [])
    assert memo.get(("planned", 0)) == ()  # used: kept
    memo.put(("planned", 4), [])
    assert len(memo) == 4
    assert memo.get(("planned", 1)) is None
    assert memo.get(("planned", 0)) == () and memo.get(("planned", 4)) == ()


def test_device_node_over_host_child_raises_before_any_launch(monkeypatch):
    # a broken transition rule: the overrides pass's flips left out
    from spark_rapids_tpu_torch.plan import overrides as OV
    s = TorchSession(device="cpu")
    df = s.create_dataframe({"a": np.array([1, 2, 3])})
    q = df.where(EqualTo(col("a"), col("a")))
    monkeypatch.setattr(OV, "insert_transitions",
                        lambda plan, goal_rows=0: plan)
    with pytest.raises(PlanLintError) as e:
        q.collect()
    assert ("transition", "error") in _keys(e.value.violations)
    assert s.last_query is None


# -- dimension 5: parquet writer widths ---------------------------------------


def _writer_plan(tmp_path):
    import torch
    schema = T.Schema([T.StructField("s16", T.SHORT), T.StructField("s8",
                                                                   T.BYTE),
                       T.StructField("i", T.INT)])
    hb = HostBatch.from_numpy({"s16": np.arange(4, dtype=np.int16),
                               "s8": np.arange(4, dtype=np.int8),
                               "i": np.arange(4, dtype=np.int32)}, schema)
    src = E.DeviceSourceExec(hb.to_device(torch.device("cpu")))
    return WriteFilesExec(src, "parquet", str(tmp_path / "out"), {}, [],
                          "overwrite")


def test_writer_clean(tmp_path):
    assert lint_plan(_writer_plan(tmp_path)) == []


def test_narrow_serialization_is_rejected(tmp_path, monkeypatch):
    from spark_rapids_tpu_torch.io import parquet_encode as PE
    monkeypatch.setattr(PE, "encoded_value_dtype",
                        lambda dt: np.dtype(dt.np_dtype))
    bad = [v for v in lint_plan(_writer_plan(tmp_path))
           if v.check == "writer-width"]
    assert len(bad) == 2  # s16 and s8; the int column is 4 bytes anyway
    assert all("truncated stream" in v.message for v in bad)
    assert all(v.node_path == "WriteFilesExec" for v in bad)


def test_swapped_converted_types_are_rejected(tmp_path, monkeypatch):
    from spark_rapids_tpu_torch.io import parquet_encode as PE
    phys = dict(PE._PHYS)
    phys["smallint"] = (phys["smallint"][0], 15)
    phys["tinyint"] = (phys["tinyint"][0], 16)
    monkeypatch.setattr(PE, "_PHYS", phys)
    bad = [v for v in lint_plan(_writer_plan(tmp_path))
           if v.check == "writer-width"]
    assert len(bad) == 2
    assert all("ConvertedType" in v.message for v in bad)


def test_spec_constants_agree_with_reference():
    assert PL._SPEC_PHYS_WIDTH == RL._SPEC_PHYS_WIDTH
    assert PL._SPEC_CONVERTED == RL._SPEC_CONVERTED
