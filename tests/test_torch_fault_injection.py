"""The port's fault injector (``spark_rapids_tpu_torch/utils/
fault_injection.py``) against the JAX package's, on the CPU.

The schedule is a pure function of (seed, N, visit): every Nth visit
with the seed's phase shift, the first |N| visits for a negative N, the
same transient flavors for the same seed and site, the same site
matching; and an injected OOM is a ``torch.OutOfMemoryError``. Then the
reference's ``test_fault_injection.py`` join query end to end: the
first visit of every site faulting (``oomEveryN=-1``), the probe
faulting four times with one retry allowed (so it splits,
``splitAndRetryCount`` > 0), transient faults at the dispatch, and no
injection — each giving the reference's rows (``TpuSession`` with
fusion off) with the expected retry counters, and with injection off,
no retry counter at all. A live injector keeps the scans' pipeline off
(``parallel_active``), so the schedule does not depend on threads.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.utils import fault_injection as rfi
from spark_rapids_tpu_torch.config import TorchConf
from spark_rapids_tpu_torch.exec import execs as E
from spark_rapids_tpu_torch.exec import pipeline
from spark_rapids_tpu_torch.ops import aggregates as AGG
from spark_rapids_tpu_torch.ops.expression import col
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.utils import fault_injection as FI


def _visits(inj, site, n=24):
    out = []
    for i in range(1, n + 1):
        try:
            inj.check(site)
        except Exception as e:  # noqa: BLE001 - both packages' faults
            assert "Injected" in type(e).__name__
            out.append(i)
    return out


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("every", [1, 3, 7, -1, -3, -30])
def test_oom_schedule_equals_the_reference(seed, every):
    got = _visits(FI.FaultInjector(seed, "*", every, 0), "s")
    want = _visits(rfi.FaultInjector(seed, "*", every, 0), "s")
    assert got == want
    inj = FI.FaultInjector(seed, "*", every, 0)
    assert [inj._scheduled(n, every) for n in range(1, 40)] == \
        [rfi.FaultInjector(seed, "*", every, 0)._scheduled(n, every)
         for n in range(1, 40)]


@pytest.mark.parametrize("seed", [0, 3])
def test_transient_flavors_equal_the_reference(seed):
    for site in ("a", "ShuffledHashJoinExec.probe", "session.dispatch"):
        got = FI.FaultInjector(seed, "*", 0, -8)
        want = rfi.FaultInjector(seed, "*", 0, -8)
        _visits(got, site)
        _visits(want, site)
        assert got.injected == {k: want.injected[k]
                                for k in ("oom", "transient", "disk")}


def test_matching_and_the_oom_type():
    patterns = "io.parquet, SortExec.sort"
    got = FI.FaultInjector(0, patterns, -1, 0)
    want = rfi.FaultInjector(0, patterns, -1, 0)
    for site in ("io.parquet.rowGroup", "SortExec.sort", "io.orc.stripe",
                 "SortExec.sortX", "x"):
        assert got.matches(site) == want.matches(site)
    with pytest.raises(torch.OutOfMemoryError, match="SortExec.sort"):
        got.check("SortExec.sort")
    assert FI.FaultInjector.maybe(TorchConf({})) is None
    assert TorchSession(device="cpu")._fault_injector is None


def test_injector_forces_the_serial_pipeline():
    ctx = E.ExecContext(torch.device("cpu"))
    assert pipeline.parallel_active(ctx)
    ctx.fault_injector = FI.FaultInjector(0, "*", 1, 0)
    assert not pipeline.parallel_active(ctx)


def _inject_conf(sites="*", oom=0, transient=0, **extra):
    return {"spark.rapids.tpu.retry.backoffBaseMs": 0.0,
            "spark.rapids.tpu.test.faultInjection.sites": sites,
            "spark.rapids.tpu.test.faultInjection.oomEveryN": oom,
            "spark.rapids.tpu.test.faultInjection.transientEveryN": transient,
            **extra}


def _tables():
    rng = np.random.default_rng(3)
    probe = {"k": rng.integers(0, 500, 6000).astype(np.int64),
             "v": rng.integers(0, 100, 6000).astype(np.int64)}
    build = {"k": np.arange(500, dtype=np.int64),
             "w": np.arange(500, dtype=np.int64) * 10}
    return probe, build


def _port_answer(conf):
    s = TorchSession(conf, device="cpu")
    probe, build = _tables()
    got = (s.create_dataframe(probe)
           .join(s.create_dataframe(build), on="k", how="inner")
           .select(col("v"), col("w")).group_by(col("v"))
           .agg(AGG.AggregateExpression(AGG.Sum(col("w")), "sw"),
                AGG.AggregateExpression(AGG.Count(), "c"))).collect()
    order = np.argsort(got.columns["v"])
    return {n: got.columns[n][order].tolist() for n in ("v", "sw", "c")}, s


@pytest.fixture(scope="module")
def reference_answer():
    from spark_rapids_tpu.ops import aggregates as RAGG
    from spark_rapids_tpu.ops.expression import col as rcol
    s = TpuSession({"spark.rapids.sql.enabled": True,
                    "spark.rapids.tpu.fusion.enabled": False})
    probe, build = _tables()
    got = (s.create_dataframe(pa.RecordBatch.from_pydict(probe))
           .join(s.create_dataframe(pa.RecordBatch.from_pydict(build)),
                 on="k", how="inner")
           .select(rcol("v"), rcol("w")).group_by(rcol("v"))
           .agg(RAGG.AggregateExpression(RAGG.Sum(rcol("w")), "sw"),
                RAGG.AggregateExpression(RAGG.Count(), "c"))
           ).collect().sort_by("v")
    return {n: got.column(n).to_pylist() for n in ("v", "sw", "c")}


#: The operator retry sites of a join run on the streaming path: a fused
#: region has no retry and no injector (the reference's fused context has
#: neither), so the cases that count them pin fusion off.
NO_FUSION = {"spark.rapids.tpu.fusion.enabled": False}


def test_oom_at_every_site(reference_answer):
    got, s = _port_answer(_inject_conf(oom=-1, **NO_FUSION))
    assert got == reference_answer
    inj = s._fault_injector
    visited = sorted(k for k, v in inj.visits().items() if v)
    assert inj.injected["oom"] == len(visited) >= 4, visited
    assert {"ShuffledHashJoinExec.assemble", "ShuffledHashJoinExec.probe",
            "session.dispatch"} <= set(visited)
    eng = s.last_query_profile().engine
    assert eng["retry"]["retryCount"] >= len(visited), eng["retry"]
    assert set(visited) <= set(FI.known_sites())


def test_split_and_retry_escalation(reference_answer):
    got, s = _port_answer(_inject_conf(
        sites="ShuffledHashJoinExec.probe", oom=-4,
        **{"spark.rapids.tpu.retry.maxRetries": 1}, **NO_FUSION))
    assert got == reference_answer
    eng = s.last_query_profile().engine["retry"]
    assert eng["splitAndRetryCount"] > 0 and eng["retryCount"] > 0, eng


def test_oom_at_every_site_of_the_fused_path(reference_answer):
    """On the fused path only the dispatch is a retry site: the join is
    inlined, and its assembly and probe run without a retry."""
    got, s = _port_answer(_inject_conf(oom=-1))
    assert got == reference_answer
    inj = s._fault_injector
    visited = sorted(k for k, v in inj.visits().items() if v)
    assert "session.dispatch" in visited
    assert not {"ShuffledHashJoinExec.assemble",
                "ShuffledHashJoinExec.probe"} & set(visited)
    assert s.last_query.fusion["boundaries"] == 2
    assert s.last_query_profile().engine["retry"]["retryCount"] >= 1


def test_transient_dispatch_faults_are_retried(reference_answer):
    got, s = _port_answer(_inject_conf(sites="session.dispatch",
                                       transient=-2))
    assert got == reference_answer
    flavors = s._fault_injector.injected
    assert flavors["transient"] + flavors["disk"] == 2
    prof = s.last_query_profile()
    assert prof.extras["TorchSession"]["retryCount"] == 2


def test_injection_off_counters_read_zero(reference_answer):
    got, s = _port_answer({})
    assert got == reference_answer
    assert not any(s.last_query_profile().engine["retry"].values())


def test_every_site_of_a_sort_and_a_window(tmp_path):
    """The sort's and the window's sites under a first-visit fault, on
    the external paths (a tiny budget), against the uninjected answer."""
    from spark_rapids_tpu_torch.ops import windows as W
    from spark_rapids_tpu_torch.plan.logical import SortOrder
    rng = np.random.default_rng(9)
    parts = [{"g": rng.integers(0, 40, 3000).astype(np.int64),
              "v": rng.integers(0, 10**6, 3000).astype(np.int64)}
             for _ in range(3)]
    tiny = {"spark.rapids.memory.tpu.spillBudgetBytes": 1 << 16,
            "spark.rapids.memory.tpu.spillDir": str(tmp_path)}

    def run(conf):
        s = TorchSession(conf, device="cpu")
        df = s.create_dataframe(parts[0])
        for p in parts[1:]:
            df = df.union(s.create_dataframe(p))
        w = W.WindowSpec(partition_by=(col("g"),),
                         order_by=(SortOrder(col("v")),))
        out = df.with_column("rn", W.WindowExpression(W.RowNumber(), w)) \
            .sort(SortOrder(col("g")), SortOrder(col("v"))).collect()
        return {n: out.columns[n].tolist() for n in ("g", "v", "rn")}, s
    want, _ = run(tiny)
    got, s = run({**tiny, **_inject_conf(oom=-1)})
    assert got == want
    visited = set(s._fault_injector.visits())
    assert {"SortExec.runGeneration", "ExternalSorter.mergeStep",
            "WindowExec.evaluate"} <= visited, visited
    prof = s.last_query_profile()
    assert prof.engine["spillBytes"] > 0
