"""The port's span tracer (``spark_rapids_tpu_torch/metrics/trace.py``) and
lockdep (``utils/lockdep.py``) against the JAX package's: the reference's
``TestTracerCore`` cases run on the port's module, one span program gives
the same Chrome export in both packages (timestamps, pids and tids
aside), the wire encoding, the flight-recorder ring and its dump. Then
traced queries of the port: bench q1 and q3 answer bit for bit as
untraced ones, an untraced session holds no tracer, the scan pipeline's
spans (over parquet files that the port's writer wrote) parent inside the
query's tree, the reference's ``tools/trace_report.py`` finds a critical
path in the port's export, and the port's lockdep records no violation
over these queries, while a two-lock inversion is recorded as the
reference records it.
"""

import inspect
import json
import threading

import pytest

import test_trace as REF
import tools.trace_report as trace_report
from spark_rapids_tpu.metrics import trace as ref_trace
from spark_rapids_tpu.utils import lockdep as ref_lockdep
from spark_rapids_tpu_torch.io.parquet_encode import write_device_batch
from spark_rapids_tpu_torch.metrics import trace as TR
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.utils import lockdep
from spark_rapids_tpu_torch.workloads import tpch

ROWS = 1 << 11
CORE_CASES = sorted(n for n in dir(REF.TestTracerCore)
                    if n.startswith("test_"))


@pytest.fixture
def port_trace_state():
    TR.reset_for_tests()
    yield
    TR.reset_for_tests()


@pytest.mark.parametrize("case", CORE_CASES)
def test_reference_tracer_core_case_on_the_port(case, port_trace_state,
                                                monkeypatch, tmp_path):
    """``tests/test_trace.py``'s ``TestTracerCore.<case>`` with its ``TR``
    bound to the port's module."""
    monkeypatch.setattr(REF, "TR", TR)
    method = getattr(REF.TestTracerCore(), case)
    kwargs = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    method(**{k: kwargs[k] for k in inspect.signature(method).parameters})


def _span_program(mod):
    t = mod.Tracer("same-program")
    with mod.span(t, "root", cat="session", query=1):
        with mod.span(t, "stage", cat="pipeline", index=0):
            fk = mod.fork(t)
            th = threading.Thread(target=_worker, args=(mod, fk),
                                  name="lane-1")
            th.start()
            th.join()
        with pytest.raises(KeyError):
            with mod.span(t, "failing"):
                raise KeyError("x")
        with mod.span(t, "annotated") as sp:
            sp.annotate(rows=7)
    t.assert_balanced()
    return t


def _worker(mod, fk):
    with mod.span(fk, "worker", cat="decode"):
        pass


def _strip(chrome: dict) -> dict:
    events = [{k: v for k, v in e.items()
               if k not in ("ts", "dur", "pid", "tid")}
              for e in chrome["traceEvents"]]
    return dict(chrome, traceEvents=events)


def test_same_span_program_same_chrome_export(port_trace_state):
    port = _strip(_span_program(TR).to_chrome())
    ref = _strip(_span_program(ref_trace).to_chrome())
    assert port == ref
    names = [e["name"] for e in port["traceEvents"] if e["ph"] == "X"]
    assert names == ["root", "stage", "worker", "failing", "annotated"]


def test_wire_ring_and_flight_dump(port_trace_state, tmp_path):
    from spark_rapids_tpu_torch.config import TorchConf
    TR.configure(TorchConf({
        "spark.rapids.tpu.trace.enabled": True,
        "spark.rapids.tpu.trace.flightRecorder.dir": str(tmp_path),
        "spark.rapids.tpu.trace.flightRecorder.spans": 3}))
    assert TR.enabled()
    t = TR.Tracer("wire-1")
    with TR.span(t, "outer"):
        wire = TR.format_wire(t)
        assert TR.parse_wire(wire) == ref_trace.parse_wire(wire)
        tid, parent = TR.parse_wire(wire)
        assert tid == "wire-1"
        assert t.wire_context() == (TR.wire_hash("wire-1"), parent)
    assert TR.wire_hash("wire-1") == ref_trace.wire_hash("wire-1")
    assert TR.adopt("wire-1") is t  # the live tracer, in process
    sib = TR.adopt("wire-peer", parent_span_id=41)
    with TR.span(sib, "server"):
        pass
    sib.assert_balanced()
    assert sib.spans[0]["parent"] == 41 and sib.spans[0]["id"] > 41
    for i in range(4):
        TR.record_event("kernel.build", n=i)
    ring = TR.ring_snapshot()
    assert len(ring) == 3  # bounded by flightRecorder.spans
    assert [r["args"]["n"] for r in ring] == [1, 2, 3]
    path = TR.flight_dump("test", why="a dump")
    with open(path, encoding="utf-8") as f:
        dumped = json.load(f)
    assert dumped["reason"] == "test" and dumped["recent"] == ring
    assert dumped["context"] == {"why": "a dump"}
    TR.reset_for_tests()
    assert TR.flight_dump("test") is None and TR.ring_snapshot() == []


def _answer(hb) -> dict:
    return {n: (hb.columns[n].tobytes() if hb.columns[n].dtype != object
                else hb.columns[n].tolist(), hb.validity[n].tobytes())
            for n in hb.columns}


@pytest.fixture(scope="module")
def tables():
    return tpch.gen_tables(ROWS, seed=5)


@pytest.mark.parametrize("q", ["q1", "q3"])
def test_traced_answers_equal_untraced(q, tables, tmp_path,
                                       port_trace_state):
    plain = TorchSession(device="cpu")
    want = tpch.QUERIES[q](tpch.load(plain, tables)).collect()
    traced = TorchSession({"spark.rapids.tpu.trace.enabled": True,
                           "spark.rapids.tpu.trace.dir": str(tmp_path)},
                          device="cpu")
    got = tpch.QUERIES[q](tpch.load(traced, tables)).collect()
    assert _answer(got) == _answer(want)
    assert plain.last_trace() is None
    tr = traced.last_trace()
    tr.assert_balanced()
    root = [s for s in tr.spans if s["parent"] == 0]
    assert [s["name"] for s in root] == ["session.query"]
    exported = list(tmp_path.glob("trace_*.json"))
    assert len(exported) == 1
    data = REF.validate_chrome_trace(str(exported[0]))
    assert data["otherData"]["query_id"] == \
        traced.last_query_profile().query_id
    rep = trace_report.summarize(data)
    assert rep["critical_path"][0]["name"] == "session.query"
    assert any(h["name"] == "session.dispatch" for h in rep["critical_path"])
    assert not lockdep.violations()


def _ancestors(span: dict, by_id: dict) -> list:
    out = []
    while span["parent"]:
        span = by_id[span["parent"]]
        out.append(span["name"])
    return out


def test_pipeline_spans_parent_inside_the_tree(tables, tmp_path,
                                               port_trace_state):
    d = tmp_path / "lineitem"
    d.mkdir()
    batch = tables["lineitem"].to_device("cpu")
    for i in range(3):
        write_device_batch(batch, str(d / f"part-{i}.parquet"))
    s = TorchSession({"spark.rapids.tpu.trace.enabled": True}, device="cpu")
    got = tpch.QUERIES["q6"]({"lineitem": s.read.parquet(str(d))}).collect()
    assert got.num_rows == 1
    tr = s.last_trace()
    tr.assert_balanced()
    by_id = {sp["id"]: sp for sp in tr.spans}
    boundaries = [sp for sp in tr.spans if sp["name"] == "pipeline.boundary"]
    decodes = [sp for sp in tr.spans if sp["name"] == "pipeline.decode"]
    assert sorted(sp["args"]["index"] for sp in boundaries) == [0, 1, 2]
    assert len(decodes) == 3
    for sp in boundaries + decodes:
        chain = _ancestors(sp, by_id)
        assert chain[-2:] == ["session.dispatch", "session.query"], chain
    for sp in decodes:
        assert sp["tid"].startswith("torch-pipeline-")
        assert by_id[sp["parent"]]["name"] == "pipeline.boundary"
    for sp in tr.spans:
        if sp["name"] == "pipeline.wait":
            assert by_id[sp["parent"]]["name"] == "pipeline.boundary"
    prof = s.last_query_profile()
    scan = prof.tree
    while scan["name"] != "ParquetScanExec":
        scan = scan["children"][0]
    assert scan["metrics"]["decodeThreadBusyNs"] > 0
    assert not lockdep.violations()
    s.close()


def _inversion(mod, tag: str):
    a = mod.lock(f"{tag}.A")
    b = mod.lock(f"{tag}.B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    return [(v.kind, v.locks) for v in mod.drain_violations(
        lambda v: any(n.startswith(tag) for n in v.locks))]


def test_lockdep_records_the_reference_inversion(monkeypatch):
    monkeypatch.setattr(lockdep, "_ENABLED", True)
    monkeypatch.setattr(ref_lockdep, "_ENABLED", True)
    got = _inversion(lockdep, "inv")
    want = _inversion(ref_lockdep, "inv")
    assert got == want == [("lock-order-inversion",
                            ("inv.A", "inv.B"))]
    assert isinstance(lockdep.lock("plain"), lockdep._DepLock)
    monkeypatch.setattr(lockdep, "_ENABLED", False)
    assert not isinstance(lockdep.lock("plain"), lockdep._DepLock)


def test_lockdep_self_deadlock_raises(monkeypatch):
    monkeypatch.setattr(lockdep, "_ENABLED", True)
    lk = lockdep.lock("selfdl")
    with lk:
        with pytest.raises(RuntimeError, match="self-deadlock"):
            lk.acquire()
        assert not lk.acquire(blocking=False)
    got = lockdep.drain_violations(lambda v: v.locks == ("selfdl",))
    assert [v.kind for v in got] == ["self-deadlock"]
