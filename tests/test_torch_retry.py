"""The port's retry layer (``spark_rapids_tpu_torch/memory/retry.py``,
``memory/semaphore.py``, ``utils/deadline.py``) against the JAX
package's, on the CPU.

Pure functions must equal the reference's on the same inputs: the
taxonomy's classification of each exception kind, the backoff's
deterministic delays, the rows ``halve_by_rows`` hands each half, and a
deadline's site attribution and typed error. Then the combinator itself
(retries, the split escalation, an unsplittable site raising
``SplitAndRetryOOM`` naming it, a CUDA error that is not an allocation
failure never retried), the semaphore's timeout naming its holder, the
session's dispatch retries and deadline, and TPC-H q1, q3 and q6 at
2^10 rows with every site faulting once (``oomEveryN=-1``) against the
reference's ``TpuSession`` with fusion off, floats to rtol 1e-12.
"""

import datetime
import threading
import time
from concurrent.futures import CancelledError

import numpy as np
import pytest
import torch

from spark_rapids_tpu.memory import retry as rretry
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.utils import deadline as rdeadline
from spark_rapids_tpu.workloads import tpch as rtpch
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.exec import execs as E
from spark_rapids_tpu_torch.memory import retry as R
from spark_rapids_tpu_torch.memory.semaphore import (SemaphoreTimeoutError,
                                                     TpuSemaphore)
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.utils import deadline as D
from spark_rapids_tpu_torch.utils.fault_injection import InjectedOutOfMemory
from spark_rapids_tpu_torch.workloads import tpch

RTOL = 1e-12
NO_BACKOFF = {"spark.rapids.tpu.retry.backoffBaseMs": 0}
INJECT_ONCE = {"spark.rapids.tpu.test.faultInjection.sites": "*",
               "spark.rapids.tpu.test.faultInjection.oomEveryN": -1,
               **NO_BACKOFF}


def _kinds(mod, deadline_mod):
    """One exception of each kind the taxonomy buckets, from ``mod``."""
    return [
        mod.RetryOOM("x"),
        mod.SplitAndRetryOOM("site"),
        deadline_mod.QueryDeadlineExceeded(1.0, "s"),
        CancelledError(),
        RuntimeError("RESOURCE_EXHAUSTED: out of HBM"),
        RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
        OSError("disk hiccup"),
        FileNotFoundError("gone"),
        PermissionError("no"),
        RuntimeError("remote_compile helper race"),
        RuntimeError("pipeline pool shut down while waiting"),
        ValueError("bad input"),
        KeyError("k"),
    ]


def test_classify_equals_the_reference():
    got = [R.classify(e) for e in _kinds(R, D)]
    want = [rretry.classify(e) for e in _kinds(rretry, rdeadline)]
    assert got == want


@pytest.mark.parametrize("msg", [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: unspecified launch failure",
    "CUDA error: device-side assert triggered",
    "sortStep launch: CUDA error 700: an illegal memory access was "
    "encountered",
    "CUDA error: misaligned address",
])
def test_cuda_errors_other_than_allocation_are_fatal(msg):
    assert R.classify(RuntimeError(msg)) == R.Classification.FATAL


@pytest.mark.parametrize("exc", [
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 8 GiB"),
    InjectedOutOfMemory("injected"),
    RuntimeError("CUDA error: out of memory"),
    RuntimeError("joinProbe launch: CUDA error 2: out of memory"),
])
def test_allocation_failures_are_oom(exc):
    assert R.classify(exc) == R.Classification.OOM


@pytest.mark.parametrize("base,cap", [(10.0, 1000.0), (3.5, 40.0),
                                      (0.0, 10.0)])
def test_backoff_equals_the_reference(base, cap):
    got = R.RetryPolicy(3, base, cap)
    want = rretry.RetryPolicy(3, base, cap)
    for site in ("session.dispatch", "ShuffledHashJoinExec.probe", "x"):
        for attempt in range(8):
            assert got.delay_seconds(site, attempt) == \
                want.delay_seconds(site, attempt)


@pytest.mark.parametrize("n", [2, 3, 128, 1000, 4097])
def test_halve_by_rows_rows(n):
    """Each half holds the rows the reference's halves hold."""
    import jax.numpy as jnp
    import pyarrow as pa

    from spark_rapids_tpu.data.batch import ColumnarBatch as RBatch
    rng = np.random.default_rng(n)
    v = rng.integers(-10**9, 10**9, n)
    keep = rng.random(n) < 0.7
    keep[:2] = True
    host = HostBatch.from_numpy({"v": v})
    batch = host.to_device("cpu")
    live = torch.from_numpy(np.pad(keep, (0, batch.capacity - n)))
    lazy = E.KR.compact(batch, live)
    got = [HostBatch.from_device(h).columns["v"].tolist()
           for h in R.halve_by_rows(lazy)]
    rb = RBatch.from_arrow(pa.RecordBatch.from_pydict({"v": v}))
    rlive = jnp.asarray(np.pad(keep, (0, rb.capacity - n)))
    rlazy = RBatch(rb.columns, jnp.sum(rlive).astype(jnp.int32), rb.schema,
                   live=rlive)
    want = [h.to_arrow().column("v").to_pylist()
            for h in rretry.halve_by_rows(rlazy)]
    assert got == want


def test_halve_by_rows_refuses_one_row():
    batch = HostBatch.from_numpy({"v": np.array([5])}).to_device("cpu")
    with pytest.raises(R.SplitAndRetryOOM):
        R.halve_by_rows(batch)


def test_deadline_attribution_equals_the_reference():
    """The same check program attributes time to the same slowest site and
    raises naming the same sites."""
    def program(mod):
        d = mod.Deadline(0.05)
        for site, pause in (("a", 0.001), ("slow", 0.03), ("b", 0.001),
                            ("slow", 0.03)):
            time.sleep(pause)
            try:
                d.check(site)
            except mod.QueryDeadlineExceeded as e:
                times = d.site_times()
                return e.site, e.slowest_site, max(times, key=times.get)
        return None
    assert program(D) == program(rdeadline) == ("slow", "slow", "slow")
    d = D.Deadline(10)
    assert d.bound(100) <= 10 and d.bound(-1) == 0.0
    d.cancel()
    with pytest.raises(D.QueryDeadlineExceeded, match="observed at 'x'"):
        d.check("x")


class _Ctx:
    """A bare context: what ``with_retry`` reads."""

    def __init__(self, conf=None, catalog=None):
        from spark_rapids_tpu_torch.config import TorchConf
        self.conf = TorchConf({**NO_BACKOFF, **(conf or {})})
        self.device = torch.device("cpu")
        self.catalog = catalog
        self.metrics = {}

    def metric(self, node, name, value):
        key = (node, name)
        self.metrics[key] = self.metrics.get(key, 0) + value


def test_with_retry_retries_then_splits():
    ctx = _Ctx({"spark.rapids.tpu.retry.maxRetries": 2})
    batch = HostBatch.from_numpy({"v": np.arange(10)}).to_device("cpu")
    seen = []

    def attempt(b):
        n = int(b.n_rows)
        seen.append(n)
        if n > 5:
            raise torch.OutOfMemoryError("CUDA out of memory (test)")
        return HostBatch.from_device(b).columns["v"].tolist()

    out = R.with_retry(ctx, "Test.site", batch, attempt,
                       split=R.halve_by_rows)
    assert out == [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]]
    assert seen == [10, 10, 10, 5, 5]
    assert ctx.metrics[("Test", "retryCount")] == 2
    assert ctx.metrics[("Test", "splitAndRetryCount")] == 1


def test_split_tracker_records_a_split():
    ctx = _Ctx({"spark.rapids.tpu.retry.maxRetries": 0})
    tracker = R.SplitTracker(R.halve_by_rows)
    batch = HostBatch.from_numpy({"v": np.arange(6)}).to_device("cpu")

    def attempt(b):
        if not tracker.split_happened:
            raise torch.OutOfMemoryError("CUDA out of memory (test)")
        return int(b.n_rows)
    assert R.with_retry(ctx, "Test.tracked", batch, attempt,
                        split=tracker) == [3, 3]
    assert tracker.split_happened


def test_unsplittable_site_names_itself():
    ctx = _Ctx({"spark.rapids.tpu.retry.maxRetries": 1})

    def attempt(_):
        raise torch.OutOfMemoryError("CUDA out of memory (test)")
    with pytest.raises(R.SplitAndRetryOOM, match="'Test.noSplit'"):
        R.with_retry(ctx, "Test.noSplit", None, attempt)


def test_fatal_cuda_error_is_not_retried():
    ctx = _Ctx()
    calls = []

    def attempt(_):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        R.with_retry(ctx, "Test.fatal", None, attempt)
    assert len(calls) == 1 and not ctx.metrics


def test_transient_retries_in_place_then_raises():
    ctx = _Ctx({"spark.rapids.tpu.retry.maxRetries": 2})
    calls = []

    def attempt(_):
        calls.append(1)
        raise OSError("spill disk hiccup")
    with pytest.raises(OSError):
        R.with_retry(ctx, "Test.transient", None, attempt,
                     split=R.halve_by_rows)
    assert len(calls) == 3
    assert ctx.metrics[("Test", "retryCount")] == 2
    assert ("Test", "splitAndRetryCount") not in ctx.metrics


def test_semaphore_timeout_names_the_holder():
    sem = TpuSemaphore(1, acquire_timeout_s=0.05)
    held = threading.Event()
    done = threading.Event()

    def holder():
        with sem:
            held.set()
            done.wait(5)
    t = threading.Thread(target=holder, name="slot-holder")
    t.start()
    held.wait(5)
    try:
        with pytest.raises(SemaphoreTimeoutError, match="slot-holder"):
            sem.acquire_if_necessary()
        assert sem.wait_ns > 0
    finally:
        done.set()
        t.join()
    # reentrant, and released() gives the slot back for its scope
    with sem:
        with sem:
            assert list(sem.holders().values()) == [2]
            with sem.released():
                assert sem.holders() == {}
            assert list(sem.holders().values()) == [2]
    assert sem.holders() == {}


TABLES = tpch.gen_tables(1 << 10, seed=11)


def _port(conf, q):
    s = TorchSession(conf, device="cpu")
    got = tpch.QUERIES[q](tpch.load(s, TABLES)).collect()
    return got, s


def test_session_deadline_raises_naming_a_site():
    s = TorchSession({"spark.rapids.tpu.query.deadlineSecs": 1e-9},
                     device="cpu")
    with pytest.raises(D.QueryDeadlineExceeded, match="session.dispatch"):
        tpch.q6(tpch.load(s, TABLES)).collect()


def test_session_dispatch_retries_transient_faults():
    got, s = _port({"spark.rapids.tpu.test.faultInjection.sites":
                    "session.dispatch",
                    "spark.rapids.tpu.test.faultInjection.transientEveryN":
                    -2, **NO_BACKOFF}, "q6")
    want, _ = _port({}, "q6")
    assert got.columns["revenue"].tolist() == want.columns["revenue"].tolist()
    prof = s.last_query_profile()
    assert prof.engine["retry"]["retryCount"] == 2


def test_no_retry_or_spill_on_the_default_path():
    for q in ("q1", "q3", "q6"):
        _, s = _port({}, q)
        eng = s.last_query_profile().engine
        assert not any(eng["retry"].values()), (q, eng["retry"])
        assert eng["spillBytes"] == 0 and eng["durability"][
            "checksumFailures"] == 0, q


def _ref_columns(table) -> dict:
    """The reference's columns as lists, dates as days since the epoch
    (the port's DATE)."""
    epoch = datetime.date(1970, 1, 1)
    return {n: [(v - epoch).days if isinstance(v, datetime.date) else v
                for v in table.column(n).to_pylist()]
            for n in table.column_names}


@pytest.mark.parametrize("q", ["q1", "q3", "q6"])
def test_tpch_under_injection_equals_the_reference(q):
    got, s = _port(INJECT_ONCE, q)
    assert s.last_query_profile().engine["retry"]["retryCount"] > 0
    ref = TpuSession({"spark.rapids.sql.enabled": True,
                      "spark.rapids.tpu.fusion.enabled": False})
    want = _ref_columns(rtpch.QUERIES[q](rtpch.load(
        ref, rtpch.gen_tables(1 << 10, seed=11))).collect())
    got_cols = {n: got.columns[n].tolist() for n in got.columns}
    assert list(got_cols) == list(want)
    keys = [n for n, v in want.items() if v and isinstance(v[0], str)]
    order_g = sorted(range(len(got_cols[list(want)[0]])),
                     key=lambda i: tuple(got_cols[k][i] for k in keys))
    order_w = sorted(range(len(want[list(want)[0]])),
                     key=lambda i: tuple(want[k][i] for k in keys))
    for n in want:
        g = [got_cols[n][i] for i in order_g]
        w = [want[n][i] for i in order_w]
        assert len(g) == len(w), n
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == b or abs(a - b) <= RTOL * abs(b), (n, a, b)
            else:
                assert a == b or str(a) == str(b), (n, a, b)


def test_prefetch_iter_order_errors_and_deadline():
    """``prefetch_iter`` yields in order from a pool worker, re-raises the
    source's error at the consumer, and a query deadline ends a wait on
    a stalled source naming ``prefetch.wait``."""
    from spark_rapids_tpu_torch.utils.prefetch import prefetch_iter
    assert list(prefetch_iter(iter(range(50)), depth=3)) == list(range(50))

    def broken():
        yield 1
        raise ValueError("source failed")
    it = prefetch_iter(broken())
    assert next(it) == 1
    with pytest.raises(ValueError, match="source failed"):
        next(it)
    ctx = E.ExecContext(torch.device("cpu"))
    ctx.deadline = D.Deadline(0.2)
    release = threading.Event()

    def stalled():
        yield 0
        release.wait(10)
        yield 1
    it = prefetch_iter(stalled(), ctx=ctx, node="Test")
    assert next(it) == 0
    t0 = time.monotonic()
    with pytest.raises(D.QueryDeadlineExceeded, match="prefetch.wait:Test"):
        next(it)
    assert time.monotonic() - t0 < 2.0
    release.set()
    it.close()
