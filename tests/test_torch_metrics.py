"""The port's metrics layer (``spark_rapids_tpu_torch/metrics``) against the
JAX package's on the same inputs: the taxonomy, the registry's level
gating and snapshots, the event log's line format (each package reads the
other's lines, torn lines skipped, one rotated generation kept),
``compare_profiles`` and the profile's round trip. Then the port's
profiles of TPC-H q6 and TPC-DS q3 at 2^12 rows (and q6 over parquet
files that the port's writer wrote), at ``ESSENTIAL`` with an event-log
directory: the profile tree is the physical plan node for node, the
root's ``numOutputRows`` is the answer's row count, the transfer byte
counts are over 0, the last event-log line carries the plan hash, and
the answer equals the level-``NONE`` answer and the reference's
CPU-oracle answer.
"""

import json
import os
import sys
import threading

import numpy as np
import pytest

import chip_smoke as CS
from spark_rapids_tpu.metrics import eventlog as ref_eventlog
from spark_rapids_tpu.metrics import profile as ref_profile
from spark_rapids_tpu.metrics import registry as ref_registry
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.workloads import tpcds as rds
from spark_rapids_tpu.workloads import tpch as rtpch
from spark_rapids_tpu_torch.io.parquet_encode import write_device_batch
from spark_rapids_tpu_torch.metrics import eventlog, profile, registry
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.workloads import tpcds, tpch
from test_torch_tpcds_base import assert_same_answer, ref_rows

ROWS = 1 << 12
LEVELS = ["NONE", "ESSENTIAL", "MODERATE", "DEBUG"]
#: One program of registry calls: (call, node, metric, value).
PROGRAM = [
    ("add", "ScanExec", "numOutputRows", 100),
    ("add", "ScanExec", "numOutputRows", 28),
    ("add", "ScanExec", "uploadBytes", 4096),
    ("add", "JoinExec", "numInputRows", 7),
    ("add", "JoinExec", "peakDeviceBytes", 10),
    ("add", "JoinExec", "peakDeviceBytes", 30),
    ("add", "JoinExec", "peakDeviceBytes", 20),
    ("add", "JoinExec", "avgBatchRows", 3),
    ("add", "JoinExec", "avgBatchRows", 6),
    ("add", "JoinExec", "customCounter", 5),
    ("set", "JoinExec", "numOutputBatches", 9),
    ("set", "SortExec", "peakDeviceBytes", 4),
    ("add", "ExchangeExec", "shuffleBytesWritten", 512),
    ("add", "ExchangeExec", "concatTime", 1000),
    ("timer", "SortExec", "sortTime", None),
    ("timer", "ExchangeExec", "serializationTime", None),
    ("timer", "ScanExec", "opTime", None),
]


def _run_program(reg) -> None:
    for call, node, name, value in PROGRAM:
        if call == "add":
            reg.add(node, name, value)
        elif call == "set":
            reg.set_value(node, name, value)
        else:
            with reg.timer(node, name):
                pass


#: The metrics ``PROGRAM`` times with the clock.
TIMED = {name for call, _, name, _ in PROGRAM if call == "timer"}


def _without_timings(snap: dict) -> dict:
    """The snapshot with clock-timed values replaced by their presence."""
    return {node: {n: "timed" if n in TIMED else v for n, v in m.items()}
            for node, m in snap.items()}


def test_taxonomy_equals_the_reference():
    got = {n: (s.kind, s.level) for n, s in registry.TAXONOMY.items()}
    want = {n: (s.kind, s.level) for n, s in ref_registry.TAXONOMY.items()}
    assert got == want
    assert [registry.parse_level(x) for x in LEVELS + ["bogus", None]] == \
        [ref_registry.parse_level(x) for x in LEVELS + ["bogus", None]]
    assert [registry.level_name(i) for i in range(5)] == \
        [ref_registry.level_name(i) for i in range(5)]
    assert registry.taxonomy_markdown().count("\n") == \
        ref_registry.taxonomy_markdown().count("\n")


@pytest.mark.parametrize("level", LEVELS)
def test_registry_snapshot_equals_the_reference(level):
    port = registry.MetricsRegistry(registry.parse_level(level))
    ref = ref_registry.MetricsRegistry(ref_registry.parse_level(level))
    _run_program(port)
    _run_program(ref)
    assert _without_timings(port.snapshot()) == \
        _without_timings(ref.snapshot())
    for node in ("ScanExec", "JoinExec", "SortExec", "NotANode"):
        assert set(port.node_metrics(node)) == set(ref.node_metrics(node))
    assert port.enabled == ref.enabled == (level != "NONE")
    if level == "NONE":
        assert port.snapshot() == {} and port.node_names() == []
        assert port.timer("n", "opTime") is registry._NOOP_TIMER
    else:
        assert port.snapshot()["ScanExec"]["numOutputRows"] == 128
    for name in registry.TAXONOMY:
        assert port.records(name) == ref.records(name)


def test_registry_device_timing_needs_a_level():
    assert registry.MetricsRegistry(registry.ESSENTIAL, True).device_timing
    assert not registry.MetricsRegistry(registry.NONE, True).device_timing
    assert not registry.MetricsRegistry(registry.DEBUG).device_timing


def test_registry_thread_hammer():
    """More threads than cores adding to the same metrics, the switch
    interval shortened: no update is lost."""
    reg = registry.MetricsRegistry(registry.DEBUG)
    n_threads, n_adds = 16, 1000

    def hammer(i):
        for k in range(n_adds):
            reg.add("Hot", "numOutputRows", 1)
            reg.add("Hot", "peakDeviceBytes", i * n_adds + k)
            reg.add(f"Node{i}", "numOutputBatches", 2)
            with reg.timer("Hot", "opTime"):
                pass
    threads = [threading.Thread(target=hammer, args=(i,))
               for i in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = reg.snapshot()
    assert snap["Hot"]["numOutputRows"] == n_threads * n_adds
    assert snap["Hot"]["peakDeviceBytes"] == n_threads * n_adds - 1
    assert snap["Hot"]["opTime"] > 0
    for i in range(n_threads):
        assert snap[f"Node{i}"] == {"numOutputBatches": 2 * n_adds}


def _profile_dict(qid: int, op_ns: int) -> dict:
    return {"query_id": qid, "plan_hash": "abc", "wall_ns": 5_000_000,
            "level": "ESSENTIAL", "timestamp": "2026-01-01T00:00:00+00:00",
            "version": 1, "extras": {"DeviceToHost": {"opTime": op_ns}},
            "engine": {"cuda": {"kernels": {"joinProbe": {"launches": 2}}}},
            "tree": {"name": "SortExec", "describe": "Sort [k ASC]",
                     "metrics": {"opTime": op_ns, "numOutputRows": 3},
                     "children": [{"name": "FilterExec",
                                   "describe": "Filter (k > 1)",
                                   "metrics": {"opTime": 2 * op_ns},
                                   "children": []}]}}


@pytest.mark.parametrize("direction", ["port writes", "reference writes"])
def test_event_log_lines_cross_read(tmp_path, direction):
    writer, reader = (eventlog, ref_eventlog) if direction == "port writes" \
        else (ref_eventlog, eventlog)
    log = writer.EventLog(str(tmp_path))
    recs = [_profile_dict(i, 1_000_000 * i) for i in (1, 2, 3)]
    assert log.append(recs[0])
    assert log.append(profile.QueryProfile.from_dict(recs[1]))
    assert log.append(recs[2])
    assert writer.FILENAME == reader.FILENAME
    got = reader.read_all(str(tmp_path))
    assert [r["query_id"] for r in got] == [1, 2, 3]
    assert got[1]["tree"] == recs[1]["tree"]
    assert reader.read(reader.log_path(str(tmp_path)))[2] == recs[2]
    assert ref_profile.QueryProfile.from_dict(got[0]).query_id == 1


def test_event_log_torn_lines_and_rotation(tmp_path):
    log = eventlog.EventLog(str(tmp_path), max_bytes=600)
    path = eventlog.log_path(str(tmp_path))
    assert log.append({"query_id": 1})
    with open(path, "ab") as f:
        f.write(b'{"query_id": 2, "torn')  # a crash mid-append
    assert log.append({"query_id": 3})
    assert [r["query_id"] for r in eventlog.read(path)] == [1, 3]
    assert [r["query_id"] for r in ref_eventlog.read(path)] == [1, 3]
    big = {"pad": "x" * 400}
    for q in range(4, 8):
        assert log.append(dict(big, query_id=q))
    assert os.path.getsize(path) <= 600
    assert os.path.exists(path + ".1")
    assert not os.path.exists(path + ".2")
    ids = [r["query_id"] for r in eventlog.read_all(str(tmp_path))]
    assert ids == [r["query_id"] for r in
                   ref_eventlog.read_all(str(tmp_path))]
    assert ids == [6, 7]
    other = eventlog.EventLog(str(tmp_path / "sub"))
    assert other.append({"query_id": 8, "value": np.int64(3)})
    assert eventlog.read_all(str(tmp_path / "sub")) == [
        {"query_id": 8, "value": 3}]
    assert eventlog.read(str(tmp_path / "missing")) == []


def test_compare_profiles_and_round_trip():
    old, new = _profile_dict(1, 10_000_000), _profile_dict(2, 10_000_000)
    new["tree"]["metrics"]["opTime"] = 15_000_000      # +50 %: flagged
    new["tree"]["children"][0]["metrics"]["opTime"] = 20_500_000  # +2.5 %
    new["extras"]["DeviceToHost"]["opTime"] = 40_000_000
    for kw in ({}, {"threshold": 0.01}, {"min_ns": 10 ** 9}):
        assert profile.compare_profiles(old, new, **kw) == \
            ref_profile.compare_profiles(old, new, **kw)
    assert [r["path"] for r in profile.compare_profiles(old, new)] == \
        ["<extras>", "SortExec"]
    p = profile.QueryProfile.from_dict(dict(new, tenant="ignored"))
    assert profile.QueryProfile.from_dict(
        json.loads(json.dumps(p.to_dict()))) == p
    assert "joinProbe=2" in p.render()
    assert profile.plan_profile_hash(("x", False)) == \
        ref_profile.plan_profile_hash(("x", False))


def test_dump_and_load_profiles(tmp_path):
    path = str(tmp_path / "profiles.json")
    p = profile.QueryProfile.from_dict(_profile_dict(1, 5))
    profile.dump_profiles(path, {"q": p, "none": None})
    assert profile.load_profiles(path) == {"q": p.to_dict()}
    assert ref_profile.load_profiles(path) == {"q": p.to_dict()}


# -- profiles of real queries ---------------------------------------------


def _assert_tree_is_plan(node: dict, plan) -> int:
    """The profile tree equals the physical plan node for node; returns
    the nodes."""
    assert node["name"] == plan.node_name()
    assert node["describe"] == plan.describe()
    assert len(node["children"]) == len(plan.children)
    return 1 + sum(_assert_tree_is_plan(c, p)
                   for c, p in zip(node["children"], plan.children))


def _essential(log_dir) -> TorchSession:
    return TorchSession({"spark.rapids.tpu.metrics.level": "ESSENTIAL",
                         "spark.rapids.tpu.metrics.eventLog.dir":
                             str(log_dir)}, device="cpu")


def _check_profile(session, df, answer, log_dir):
    prof = session.last_query_profile()
    plan = session.plan(df._plan)
    assert _assert_tree_is_plan(prof.tree, plan) > 1
    assert prof.level == "ESSENTIAL"
    root = prof.tree["metrics"]
    assert root["numOutputRows"] == answer.num_rows
    assert root["downloadBytes"] > 0
    assert prof.engine["cuda"] == {"kernels": {}}  # the CPU launches none
    last = eventlog.read_all(str(log_dir))[-1]
    assert last["plan_hash"] == prof.plan_hash == profile.plan_profile_hash(
        (plan.tree_string(), False))
    assert last["query_id"] == prof.query_id
    return prof


def _tpch_q6(tmp_path, frames):
    s = _essential(tmp_path / "log")
    df = tpch.QUERIES["q6"](frames(s))
    got = df.collect()
    _check_profile(s, df, got, tmp_path / "log")
    none = TorchSession({"spark.rapids.tpu.metrics.level": "NONE"},
                        device="cpu")
    want = tpch.QUERIES["q6"](frames(none)).collect()
    assert none.last_query_profile() is None
    assert got.columns["revenue"].tobytes() == \
        want.columns["revenue"].tobytes()
    return s, got


def _ref_q6():
    ref = rtpch.QUERIES["q6"](rtpch.load(
        TpuSession({"spark.rapids.sql.enabled": False}),
        rtpch.gen_tables(ROWS))).collect()
    return ref.column("revenue").to_pylist()


def test_tpch_q6_profile(tmp_path):
    tables = tpch.gen_tables(ROWS)
    s, got = _tpch_q6(tmp_path, lambda sess: tpch.load(sess, tables))
    np.testing.assert_allclose(got.columns["revenue"], _ref_q6(), rtol=1e-9)


def test_tpch_q6_profile_over_parquet(tmp_path):
    """Over two parquet files of lineitem that the port's writer wrote,
    the scan's ``uploadBytes`` and rows are in the profile."""
    tables = tpch.gen_tables(ROWS)
    d = tmp_path / "lineitem"
    d.mkdir()
    batch = tables["lineitem"].to_device("cpu")
    for i in range(2):
        write_device_batch(batch, str(d / f"part-{i}.parquet"))
    s, got = _tpch_q6(tmp_path, lambda sess: {
        "lineitem": sess.read.parquet(str(d))})
    scan = _find(s.last_query_profile().tree, "ParquetScanExec")
    assert scan["metrics"]["uploadBytes"] > 0
    assert scan["metrics"]["numOutputRows"] == 2 * ROWS
    assert scan["metrics"]["numOutputBatches"] == 2
    np.testing.assert_allclose(got.columns["revenue"],
                               [2 * v for v in _ref_q6()], rtol=1e-9)


def _find(node: dict, name: str) -> dict:
    if node["name"] == name:
        return node
    for c in node["children"]:
        found = _find(c, name)
        if found is not None:
            return found
    return None


def test_tpcds_q3_profile(tmp_path):
    tables = tpcds.gen_tables(ROWS, seed=11)
    s = _essential(tmp_path / "log")
    df = tpcds.QUERIES["q3"](tpcds.load(s, tables))
    got = df.collect()
    prof = _check_profile(s, df, got, tmp_path / "log")
    assert _find(prof.tree, "ShuffledHashJoinExec")["metrics"]["opTime"] > 0
    none = TorchSession({"spark.rapids.tpu.metrics.level": "NONE"},
                        device="cpu")
    want = tpcds.QUERIES["q3"](tpcds.load(none, tables)).collect()
    assert CS.ds_host_rows(got) == CS.ds_host_rows(want)
    ref = rds.QUERIES["q3"](rds.load(
        TpuSession({"spark.rapids.sql.enabled": False}),
        rds.gen_tables(ROWS, seed=11))).collect()
    assert len(ref) > 0
    assert_same_answer(CS.ds_host_rows(got), ref_rows(ref), "q3")


def test_explain_metrics_before_and_after_collect(tmp_path):
    s = _essential(tmp_path / "log")
    df = tpch.QUERIES["q6"](tpch.load(s, tpch.gen_tables(1 << 10)))
    before = df.explain(metrics=True)
    assert "no QueryProfile recorded" in before
    assert before.startswith(df.explain())
    df.collect()
    after = df.explain(metrics=True)
    assert after.startswith("== Query Profile #1 (level=ESSENTIAL")
    assert "numOutputRows=1" in after and "opTime=" in after
    other = tpch.QUERIES["q1"](tpch.load(s, tpch.gen_tables(1 << 10)))
    assert "no QueryProfile recorded" in other.explain(metrics=True)
