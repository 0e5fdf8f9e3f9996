"""Whole-stage fusion (``exec/fusion.py``) against the JAX package's.

* The boundaries of TPC-H and TPC-DS plans, in order, against the
  reference's ``_split``. One planner difference: the reference puts a
  broadcast exchange over a small join build side; the port has none,
  its build side is the device source itself (:data:`PLANNER_NAMES`).
* Fused, streaming (``fusion.enabled=false``) and reference answers
  agree; the reference's own fused path runs on three small queries only,
  since XLA compiles each on the CPU.
* A result larger than ``collect.guessRows`` (a guess miss), an inlined
  join whose output overflows the capacity it was sized at (its total
  rides the head, and the session re-runs with it learned), and a dense
  join's fail flag coming back through the head.
* A device source is a boundary of its own, read in place: nothing is
  padded onto capacity tiers (the reference pads; the port's graph keys
  name dictionaries and resident tables, so a tier would share no graph).
* An OOM on the fused path makes the plan stream; a bare boundary (a
  sort root) downloads its batches one by one when it yields several.

On the CPU the region runs directly, with no graph; the card's capture
and replay are held against eager in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from harness import tpu_session
from spark_rapids_tpu.exec import fusion as RF
from spark_rapids_tpu.workloads import tpcds as rtpcds
from spark_rapids_tpu.workloads import tpch as rtpch
from spark_rapids_tpu_torch.exec import execs as E
from spark_rapids_tpu_torch.exec import fusion as PF
from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.workloads import tpcds, tpch

ROWS = 1 << 12
SS_ROWS = 1 << 12
#: The reference's boundary type names in the port's terms.
PLANNER_NAMES = {"TpuBroadcastExchangeExec": "DeviceSourceExec"}
TPCH_SPLIT = ["q1", "q3", "q5", "q6", "q12", "q14", "q17", "q19"]
TPCDS_SPLIT = ["q3", "q13", "q48", "q96"]
OFF = {"spark.rapids.tpu.fusion.enabled": False}


def _ref_session(**conf):
    return tpu_session(**{"spark.rapids.sql.variableFloatAgg.enabled": True,
                          **conf})


@pytest.fixture(scope="module")
def tpch_frames():
    port = TorchSession(device="cpu")
    off = TorchSession(OFF, device="cpu")
    ref = _ref_session()
    t = tpch.gen_tables(ROWS, seed=3)
    return (port, tpch.load(port, t)), (off, tpch.load(off, t)), \
        (ref, rtpch.load(ref, rtpch.gen_tables(ROWS, seed=3)))


@pytest.fixture(scope="module")
def tpcds_frames():
    port = TorchSession(device="cpu")
    off = TorchSession(OFF, device="cpu")
    ref = _ref_session()
    t = tpcds.gen_tables(SS_ROWS, seed=11)
    return (port, tpcds.load(port, t)), (off, tpcds.load(off, t)), \
        (ref, rtpcds.load(ref, rtpcds.gen_tables(SS_ROWS, seed=11)))


def _boundary_names(split, plan, inline):
    bs = []
    split(plan, bs, inline)
    names = [type(b).__name__.replace("Tpu", "", 1)
             if type(b).__name__.startswith("Tpu") else type(b).__name__
             for b in bs]
    return [PLANNER_NAMES.get("Tpu" + n, n) for n in names]


def _check_split(frames, queries, rqueries, q):
    (port, pdfs), _, (ref, rdfs) = frames
    rplan = ref.plan(rqueries[q](rdfs)._plan).children[0]
    pplan = port.plan(queries[q](pdfs)._plan)
    want = _boundary_names(RF._split, rplan, RF._conf_inline(ref.conf))
    got = _boundary_names(PF._split, pplan, PF._conf_inline(port.conf))
    assert got == want


@pytest.mark.parametrize("q", TPCH_SPLIT)
def test_tpch_boundaries_equal_reference(tpch_frames, q):
    _check_split(tpch_frames, tpch.QUERIES, rtpch.QUERIES, q)


@pytest.mark.parametrize("q", TPCDS_SPLIT)
def test_tpcds_boundaries_equal_reference(tpcds_frames, q):
    _check_split(tpcds_frames, tpcds.QUERIES, rtpcds.QUERIES, q)


def _host_equal(a, b, rtol=0.0):
    assert list(a.columns) == list(b.columns)
    assert a.num_rows == b.num_rows
    for k in a.columns:
        x, y = np.asarray(a.columns[k]), np.asarray(b.columns[k])
        np.testing.assert_array_equal(a.validity[k], b.validity[k])
        if x.dtype.kind == "f" and rtol:
            np.testing.assert_allclose(x, y, rtol=rtol)
        else:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("q", ["q1", "q5", "q6", "q12", "q14", "q19",
                               "xbb_score"])
def test_fused_equals_streaming_tpch(tpch_frames, q):
    (port, pdfs), (off, odfs), _ = tpch_frames
    got = tpch.QUERIES[q](pdfs).collect()
    info = port.last_query.fusion
    assert info is not None and info["action"] == "cpu"
    want = tpch.QUERIES[q](odfs).collect()
    assert off.last_query.fusion is None
    # the same operators add in the same order on the CPU
    _host_equal(got, want)


@pytest.mark.parametrize("q", ["q96", "q13", "q48", "q3"])
def test_fused_equals_streaming_tpcds(tpcds_frames, q):
    (port, pdfs), (off, odfs), _ = tpcds_frames
    got = tpcds.QUERIES[q](pdfs).collect()
    want = tpcds.QUERIES[q](odfs).collect()
    _host_equal(got, want)


@pytest.mark.parametrize("q", ["q6", "q14", "q19"])
def test_fused_equals_reference_fused(tpch_frames, q):
    """The reference's default (fused) path: one XLA compile each."""
    (port, pdfs), _, (ref, rdfs) = tpch_frames
    got = tpch.QUERIES[q](pdfs).collect()
    want = rtpch.QUERIES[q](rdfs).collect()
    assert got.num_rows == want.num_rows == 1
    for k in want.column_names:
        np.testing.assert_allclose(np.asarray(got.columns[k], np.float64),
                                   want.column(k).to_numpy(), rtol=1e-12)


def test_head_only_region(tpch_frames):
    """A top-k root is a boundary: the fused path only downloads."""
    (port, pdfs), (off, odfs), _ = tpch_frames
    got = tpch.QUERIES["q3"](pdfs).collect()
    assert port.last_query.fusion["action"] == "head"
    assert port.last_query.fusion["boundaries"] == 1
    _host_equal(got, tpch.QUERIES["q3"](odfs).collect())


def test_guess_miss_downloads_the_full_batch():
    rng = np.random.default_rng(8)
    data = {"a": rng.integers(0, 1000, 6000), "b": rng.integers(0, 9, 6000)}
    small = TorchSession({"spark.rapids.tpu.collect.guessRows": 128},
                         device="cpu")
    off = TorchSession(OFF, device="cpu")

    def q(s):
        return s.create_dataframe(data).where(
            P.LessThan(col("a"), lit(500))).select(col("a"), col("b"))
    got = q(small).collect()
    info = small.last_query.fusion
    assert info["guess_miss"] and got.num_rows > 128
    _host_equal(got, q(off).collect())
    fits = TorchSession({"spark.rapids.tpu.collect.guessRows": 8192},
                        device="cpu")
    again = q(fits).collect()
    assert not fits.last_query.fusion["guess_miss"]
    assert fits.last_query.fusion["head_bytes"] > info["head_bytes"] / 4
    _host_equal(again, got)


def _dup_join(s, dup: int):
    """An inner join on two keys (the general matcher, an exact path)
    whose build side repeats every key pair ``dup`` times."""
    rng = np.random.default_rng(21)
    probe = {"k1": rng.integers(0, 50, 3000), "k2": rng.integers(0, 3, 3000),
             "v": rng.integers(0, 100, 3000)}
    keys = np.array([(a, b) for a in range(50) for b in range(3)] * dup)
    build = {"b1": keys[:, 0], "b2": keys[:, 1],
             "w": np.arange(len(keys)) % 7}
    j = s.create_dataframe(probe).join(
        s.create_dataframe(build),
        on=P.And(P.EqualTo(col("k1"), col("b1")),
                 P.EqualTo(col("k2"), col("b2"))))
    return j.group_by(col("k2")).agg(
        A.AggregateExpression(A.Count(), "n"),
        A.AggregateExpression(A.Sum(col("w")), "sw"))


def _sorted(hb, key):
    order = np.argsort(hb.columns[key])
    return {k: np.asarray(v)[order] for k, v in hb.columns.items()}


def test_join_overflow_rides_the_head_and_is_learned():
    port = TorchSession(device="cpu")
    got = _dup_join(port, 6).collect()
    first = port.last_query
    # 3000 probe rows x 6 matches outgrow the probe's 4096-row capacity
    assert first.attempts == 2 and first.fusion["action"] == "cpu"
    want = _dup_join(TorchSession(OFF, device="cpu"), 6).collect()
    g, w = _sorted(got, "k2"), _sorted(want, "k2")
    for k in w:
        np.testing.assert_array_equal(g[k], w[k])
    assert int(g["n"].sum()) == 3000 * 6
    # the learned capacity keys the plan shape: no overflow again
    _dup_join(port, 6).collect()
    assert port.last_query.attempts == 1


def test_dense_fail_rides_the_head():
    """Duplicate build keys trip the dense join's fail flag; the head
    brings it back with the result and the session re-runs the site on
    the exact path."""
    rng = np.random.default_rng(4)
    probe = {"k": rng.integers(0, 100, 2000), "v": rng.integers(0, 9, 2000)}
    build = {"b": np.repeat(np.arange(100), 2), "w": np.arange(200)}

    def q(s):
        return s.create_dataframe(probe).join(
            s.create_dataframe(build), on=P.EqualTo(col("k"), col("b"))
        ).group_by().agg(A.AggregateExpression(A.Count(), "n"),
                         A.AggregateExpression(A.Sum(col("w")), "sw"))
    port = TorchSession(device="cpu")
    got = q(port).collect()
    info = port.last_query
    assert info.attempts >= 2 and "join" in info.site_kinds
    assert info.dense_modes[info.site_kinds.index("join")] >= 1
    want = q(TorchSession(OFF, device="cpu")).collect()
    _host_equal(got, want)
    assert int(got.columns["n"][0]) == 4000


def test_device_sources_are_not_padded():
    rng = np.random.default_rng(2)
    data = {"a": rng.integers(0, 100, 3000)}
    s = TorchSession(device="cpu")
    s.create_dataframe(data).group_by().agg(
        A.AggregateExpression(A.Sum(col("a")), "s")).collect()
    info = s.last_query.fusion
    assert info["boundaries"] == 1 and "pad_rows" not in info
    assert "polymorphicPadRows" not in s.last_query_profile().extras[PF.NODE]


def test_cpu_runs_keep_the_fused_path_and_time_the_host_steps():
    """The replay-or-stream choice is made on the card only: on the CPU
    every run of a region takes the fused path; each leaves the host's
    time by step."""
    rng = np.random.default_rng(8)
    s = TorchSession(device="cpu")
    df = s.create_dataframe({"a": rng.integers(0, 100, 1000),
                             "b": rng.integers(0, 5, 1000)})
    for _ in range(6):
        df.group_by(col("b")).agg(
            A.AggregateExpression(A.Sum(col("a")), "s")).collect()
        info = s.last_query.fusion
        assert info["action"] == "cpu" and info["chosen"] is None
        assert set(info["host_us"]) == {"signature", "boundaries", "key",
                                        "region", "head"}
        assert all(v >= 0 for v in info["host_us"].values())


def test_fused_runs_keep_no_table_alive():
    """Nothing on the fused path (programs, keys, the session) keeps a
    dropped frame's device table: a loop over fresh tables frees each."""
    import gc
    import weakref
    s = TorchSession(device="cpu")
    rng = np.random.default_rng(12)
    refs = []
    for _ in range(3):
        df = s.create_dataframe({"a": rng.integers(0, 100, 2000),
                                 "b": rng.integers(0, 5, 2000)})
        for _ in range(3):
            df.where(P.GreaterThan(col("a"), lit(10))).group_by(
                col("b")).agg(A.AggregateExpression(A.Sum(col("a")),
                                                    "s")).collect()
        refs += [weakref.ref(c.data) for c in df._plan.batch.columns]
        del df
    gc.collect()
    assert refs and not any(r() is not None for r in refs)


def test_fusion_metrics_and_spans():
    rng = np.random.default_rng(6)
    s = TorchSession({"spark.rapids.tpu.trace.enabled": True}, device="cpu")
    df = s.create_dataframe({"a": rng.integers(0, 100, 1000)})
    got = df.group_by().agg(A.AggregateExpression(A.Sum(col("a")),
                                                  "s")).collect()
    prof = s.last_query_profile()
    m = prof.extras[PF.NODE]
    assert m["numOutputRows"] == got.num_rows == 1
    assert m["downloadBytes"] > 0 and m["opTime"] > 0
    names = {sp["name"] for sp in s.last_trace().spans}
    assert {"fusion.boundaries", "fusion.dispatch", "fusion.download",
            "fusion.boundary"} <= names
    assert "session.stream_collect" not in names
    off = TorchSession({**OFF, "spark.rapids.tpu.trace.enabled": True},
                       device="cpu")
    off.create_dataframe({"a": np.arange(10)}).collect()
    assert "session.stream_collect" in {
        sp["name"] for sp in off.last_trace().spans}


def test_fusable_needs_a_device_to_host_root(tpch_frames):
    (port, pdfs), _, _ = tpch_frames
    plan = port.plan(tpch.q6(pdfs)._plan)
    assert not PF.fusable(plan)
    assert PF.fusable(E.DeviceToHostExec(plan))


def test_out_of_memory_on_the_fused_path_streams_the_plan(monkeypatch):
    """An OOM on the fused path (here in the head download) reaches the
    session's retry, which drains and re-runs; the re-run, and every
    later run of the plan, streams."""
    rng = np.random.default_rng(9)
    data = {"a": rng.integers(0, 100, 3000), "b": rng.integers(0, 5, 3000)}
    PF.clear_fused_cache()
    real = PF._download_head
    calls = []

    def oom_once(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return real(*a, **k)
    monkeypatch.setattr(PF, "_download_head", oom_once)
    s = TorchSession({"spark.rapids.tpu.retry.backoffBaseMs": 0.0},
                     device="cpu")

    def q():
        return s.create_dataframe(data).group_by(col("b")).agg(
            A.AggregateExpression(A.Sum(col("a")), "s")).collect()
    got = q()
    info = s.last_query.fusion
    assert info["action"] == "refused" and info["site"] == PF.OOM_SITE
    assert s.last_query_profile().extras["TorchSession"]["retryCount"] == 1
    assert q().num_rows == got.num_rows and len(calls) == 1
    want = TorchSession(OFF, device="cpu").create_dataframe(data).group_by(
        col("b")).agg(A.AggregateExpression(A.Sum(col("a")), "s")).collect()
    _host_equal(got, want)
    PF.clear_fused_cache()


def test_a_bare_boundary_streams_its_batches():
    """A sort root past the external threshold yields sorted chunks: the
    fused path downloads them one by one instead of holding them all."""
    from spark_rapids_tpu_torch.plan.logical import SortOrder
    rng = np.random.default_rng(14)
    data = {"a": rng.integers(0, 10**6, 20_000), "b": rng.integers(0, 9,
                                                                 20_000)}
    conf = {"spark.rapids.memory.tpu.spillBudgetBytes": 1 << 20,
            "spark.rapids.sql.sort.externalThresholdBytes": 1 << 16}
    s = TorchSession(conf, device="cpu")
    got = s.create_dataframe(data).sort(SortOrder(col("a"))).collect()
    assert s.last_query.fusion["action"] == "stream"
    np.testing.assert_array_equal(got.columns["a"], np.sort(data["a"]))
    one = TorchSession(device="cpu")
    small = one.create_dataframe(data).sort(SortOrder(col("a"))).collect()
    assert one.last_query.fusion["action"] == "head"
    _host_equal(small, got)
