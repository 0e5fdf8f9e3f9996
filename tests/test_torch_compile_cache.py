"""The port's compile manifest (``compile/persist.py``) against the
reference's (``spark_rapids_tpu/compile/persist.py``): off by default
and on with its directory, per session (a session that leaves it off
changes nothing for one that sets it), record and reload, a corrupt or
unwritable file, the plan-count bound fed the same sequence as the
reference's per-plan entries, an atomic flush, process-stable plan
hashes, and the replay that gives a new process the dense modes and join
capacities an earlier one learned, so a query that took two attempts
takes one.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from spark_rapids_tpu.compile import persist as RPERSIST

from spark_rapids_tpu_torch.compile import persist
from spark_rapids_tpu_torch.config import TorchConf
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.workloads import tpch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_compile_layer():
    yield
    persist.reset_for_tests()


def _conf(tmp_path, **extra):
    return {"spark.rapids.tpu.compileCache.enabled": True,
            "spark.rapids.tpu.compileCache.dir": str(tmp_path / "cache"),
            **extra}


# -- configuration ------------------------------------------------------------


def test_disabled_by_default():
    assert persist.configure(TorchConf()) is None
    status = persist.status(None)
    assert status["enabled"] is False and status["reason"]
    s = TorchSession(device="cpu")
    assert s.manifest is None
    assert s.compile_status()["persistent_cache"]["enabled"] is False


def test_enabled_path_creates_dir_and_manifest(tmp_path):
    m = persist.configure(TorchConf(_conf(tmp_path)))
    status = m.status()
    assert status["enabled"] is True and status["reason"] == ""
    assert os.path.isdir(status["dir"])
    assert m.path == os.path.join(status["dir"], persist.MANIFEST_NAME)
    # sessions naming one directory share one manifest
    assert persist.configure(TorchConf(_conf(tmp_path))) is m


def test_default_session_leaves_an_enabled_one_on(tmp_path):
    tables = tpch.gen_tables(1 << 10, seed=7)
    on = TorchSession(_conf(tmp_path), device="cpu")
    off = TorchSession(device="cpu")  # made after, with the keys unset
    assert off.manifest is None
    assert on.compile_status()["persistent_cache"]["enabled"] is True
    tpch.q3(tpch.load(on, tables)).collect()
    assert on.last_query.attempts == 2
    assert on.last_query.manifest["recorded"]
    tpch.q3(tpch.load(off, tables)).collect()
    assert off.last_query.manifest == {}
    status = on.compile_status()["persistent_cache"]
    assert status["enabled"] is True and status["plans"] >= 1
    # a third session reads what the first wrote
    again = TorchSession(_conf(tmp_path), device="cpu")
    tpch.q3(tpch.load(again, tables)).collect()
    assert again.last_query.attempts == 1
    assert again.last_query.manifest["seeded"]


def test_uncreatable_dir_degrades_to_disabled(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    s = TorchSession({"spark.rapids.tpu.compileCache.enabled": True,
                      "spark.rapids.tpu.compileCache.dir":
                          str(blocker / "cache")}, device="cpu")
    status = s.compile_status()["persistent_cache"]
    assert status["enabled"] is False
    assert "cannot create" in status["reason"]
    out = tpch.q6(tpch.load(s, tpch.gen_tables(1 << 10, seed=7))).collect()
    assert out.num_rows == 1 and not s.last_query.manifest["recorded"]


def test_unwritable_manifest_degrades_to_disabled(tmp_path, monkeypatch):
    m = persist.configure(TorchConf(_conf(tmp_path)))

    def refuse(src, dst):
        raise PermissionError("read-only")
    monkeypatch.setattr(os, "replace", refuse)
    assert m.record_learned("p", {1: 1}, {}) is True  # the query goes on
    status = m.status()
    assert status["enabled"] is False and "cannot write" in status["reason"]
    assert m.learned_for("p") is None
    assert m.record_learned("q", {1: 1}, {}) is False
    assert not [p for p in os.listdir(tmp_path / "cache")
                if p.endswith(".json")]


# -- the manifest -------------------------------------------------------------


def test_record_and_reload(tmp_path):
    path = str(tmp_path / persist.MANIFEST_NAME)
    m = persist.CompileManifest(path)
    assert m.record_learned("abcd", {}, {}) is False  # nothing learned
    assert m.record_learned("abcd", {3: 1, 4: 0}, {7: 1024}) is True
    assert m.record_learned("abcd", {3: 1}, {7: 1024}) is False
    assert m.record_learned("abcd", {3: 2}, {7: 1024}) is True
    m2 = persist.CompileManifest(path)
    assert m2.learned_for("abcd") == ({3: 2}, {7: 1024})
    assert m2.learned_for("unknown") is None
    assert m2.status()["plans"] == 1 and m2.status()["bytes"] > 0


def test_corrupt_file_loads_empty_with_a_reason(tmp_path):
    os.makedirs(tmp_path / "cache")
    path = tmp_path / "cache" / persist.MANIFEST_NAME
    path.write_text("{not json")
    m = persist.CompileManifest(str(path))
    assert m.learned_for("x") is None
    assert m.load_error
    m = persist.configure(TorchConf(_conf(tmp_path)))
    status = m.status()
    assert status["enabled"] is True
    assert "unreadable" in status["reason"]
    assert m.record_learned("x", {5: 1}, {}) is True  # and rewrites
    with open(path) as f:
        assert json.load(f)["learned"] == {
            "x": {"modes": {"5": 1}, "join_caps": {}}}


def test_bounds_keep_the_reference_entries(tmp_path):
    # the learned state is bounded and evicted as the reference's
    # per-plan split levels are: the same sequence keeps the same plans
    port = persist.CompileManifest(str(tmp_path / "port.json"))
    ref = RPERSIST.CompileManifest(str(tmp_path / "ref.json"))
    rng = np.random.default_rng(5)
    for i in range(700):
        plan = f"p{int(rng.integers(0, 300))}"
        assert port.record_learned(plan, {1: i + 1}, {}) is True
        ref.record_split_level(plan, i + 1)
    assert list(port._learned) == list(ref._levels)
    assert len(port._learned) == persist._MAX_PLANS == RPERSIST._MAX_PLANS
    assert {h: m[1] for h, (m, _) in port._learned.items()} == ref._levels


def test_learned_state_bounded(tmp_path):
    m = persist.CompileManifest(str(tmp_path / persist.MANIFEST_NAME))
    for i in range(persist._MAX_PLANS + 10):
        m.record_learned(f"p{i}", {1: 1}, {})
    assert len(m._learned) == persist._MAX_PLANS
    assert m.learned_for("p0") is None
    assert m.learned_for(f"p{persist._MAX_PLANS + 9}") == ({1: 1}, {})


def test_flush_is_valid_json_and_atomic(tmp_path, monkeypatch):
    path = str(tmp_path / persist.MANIFEST_NAME)
    m = persist.CompileManifest(path)
    m.record_learned("p", {2: 1}, {9: 2048})
    with open(path) as f:
        data = json.load(f)
    assert data["learned"]["p"] == {"modes": {"2": 1},
                                    "join_caps": {"9": 2048}}
    assert os.listdir(tmp_path) == [persist.MANIFEST_NAME]
    # a write that dies before its rename leaves the old file whole
    seen = []
    real = os.replace

    def crash(src, dst):
        seen.append(src)
        with open(src) as f:
            json.load(f)  # the temporary file is complete
        raise OSError("crash before the rename")
    monkeypatch.setattr(os, "replace", crash)
    m.record_learned("q", {1: 1}, {})
    monkeypatch.setattr(os, "replace", real)
    assert seen and seen[0] != path
    with open(path) as f:
        assert json.load(f) == data


def test_plan_hash_deterministic():
    sig = ("Project [a]\n  DeviceSource [a] cap=128\n", False)
    assert persist.plan_hash(sig) == persist.plan_hash(sig)
    assert persist.plan_hash(sig) != persist.plan_hash((sig[0], True))
    assert persist.plan_hash(sig) == RPERSIST.plan_hash(sig)


# -- the replay across processes ----------------------------------------------

_RUN = textwrap.dedent("""
    import json, sys
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.workloads import tpch
    s = TorchSession({"spark.rapids.tpu.compileCache.enabled": True,
                      "spark.rapids.tpu.compileCache.dir": sys.argv[1]},
                     device="cpu")
    d = tpch.load(s, tpch.gen_tables(1 << 10, seed=7))
    out = {}
    for q in ("q3", "q14"):
        hb = tpch.QUERIES[q](d).collect()
        out[q] = {"attempts": s.last_query.attempts,
                  "manifest": s.last_query.manifest,
                  "rows": [hb.columns[n].tolist() for n in hb.schema.names]}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("manifest"))
    env = dict(os.environ, PYTHONPATH=REPO)
    runs = []
    for _ in range(2):
        r = subprocess.run([sys.executable, "-c", _RUN, cache], cwd=REPO,
                           env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stderr
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    return runs


def test_plan_hash_equal_across_fresh_processes(two_processes):
    a, b = two_processes
    for q in ("q3", "q14"):
        assert a[q]["manifest"]["plan_hash"] == b[q]["manifest"]["plan_hash"]


def test_new_process_replays_the_learned_modes(two_processes):
    a, b = two_processes
    for q in ("q3", "q14"):
        assert a[q]["attempts"] == 2 and not a[q]["manifest"]["seeded"]
        assert a[q]["manifest"]["recorded"]
        assert b[q]["attempts"] == 1 and b[q]["manifest"]["seeded"]
        assert b[q]["rows"] == a[q]["rows"]


def test_fresh_session_replays_in_process(tmp_path):
    conf = {"spark.rapids.tpu.compileCache.enabled": True,
            "spark.rapids.tpu.compileCache.dir": str(tmp_path / "cache")}
    tables = tpch.gen_tables(1 << 10, seed=7)
    s = TorchSession(conf, device="cpu")
    first = tpch.q3(tpch.load(s, tables)).collect()
    assert s.last_query.attempts == 2
    # a new session has learned nothing: the manifest is all it reads
    s2 = TorchSession(conf, device="cpu")
    again = tpch.q3(tpch.load(s2, tables)).collect()
    assert s2.last_query.attempts == 1
    assert s2.last_query.manifest["seeded"]
    for n in first.schema.names:
        np.testing.assert_array_equal(again.columns[n], first.columns[n])
    status = s2.compile_status()["persistent_cache"]
    assert status["enabled"] and status["plans"] >= 1
    prof = s2.last_query_profile()
    assert prof.engine["persistent_cache"]["enabled"]


def test_corrupt_manifest_never_fails_a_query(tmp_path):
    os.makedirs(tmp_path / "cache")
    (tmp_path / "cache" / persist.MANIFEST_NAME).write_text("[1, 2")
    s = TorchSession({"spark.rapids.tpu.compileCache.enabled": True,
                      "spark.rapids.tpu.compileCache.dir":
                          str(tmp_path / "cache")}, device="cpu")
    out = tpch.q6(tpch.load(s, tpch.gen_tables(1 << 10, seed=7))).collect()
    assert out.num_rows == 1
    assert "unreadable" in s.compile_status()["persistent_cache"]["reason"]
