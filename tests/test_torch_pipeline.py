"""The port's decode-ahead pipeline (``spark_rapids_tpu_torch/exec/
pipeline.py``) on the CPU: the shared pool (submit, reuse, shutdown, a
future cancelled by the shutdown), ``ordered_map_iter`` and
``unit_partitions`` in input order and equal with the pipeline on and
off, the parquet scan through it (1, 2 and 7 row groups, and a directory
of files: bit for bit the same on and off, and equal to the JAX
package's ``TpuSession`` reading the same files), a decode error raised
from a worker unchanged, ``ExecContext``'s counters and timers under
threads, the session's cleanups after every attempt, and
``TorchSession.close()`` leaving no worker of the port's pool alive
(``tests/conftest.py`` checks only the reference's pool).

No timing is asserted: the tests run beside other test processes.
"""

import datetime
import threading
import time
from concurrent.futures import Future

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import torch

from spark_rapids_tpu.exec import pipeline as RPL
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.config import TorchConf
from spark_rapids_tpu_torch.exec import execs as E
from spark_rapids_tpu_torch.exec import pipeline as PL
from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.session import TorchSession

ON = {"spark.rapids.tpu.pipeline.enabled": True}
OFF = {"spark.rapids.tpu.pipeline.enabled": False}
ROWS = 7 * 600
_EPOCH = datetime.date(1970, 1, 1)


def _port_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(PL.THREAD_PREFIX) and t.is_alive()]


def _ctx(conf=ON):
    return E.ExecContext(torch.device("cpu"), conf=TorchConf(conf))


# -- the pool ----------------------------------------------------------------


def test_pool_submit_reuses_idle_workers_and_shuts_down():
    pool = PL.PipelinePool("torch-pipeline-test")
    for i in range(20):
        assert pool.submit(lambda x: x * 2, i).result() == 2 * i
    # each task found the last one's worker idle
    assert len(pool.alive_threads()) == 1
    gate = threading.Event()
    busy = [pool.submit(gate.wait) for _ in range(3)]
    assert len(pool.alive_threads()) == 3  # no task queued behind another
    gate.set()
    assert all(f.result() for f in busy)
    assert pool.shutdown(timeout=10.0) == []
    assert pool.alive_threads() == []
    with pytest.raises(PL.PoolShutdownError):
        pool.submit(lambda: None)


def test_pool_shutdown_cancels_queued_futures():
    """A task that reached the queue after the pool closed (a submit that
    raced the shutdown) is cancelled, and waiting on it raises
    ``PoolShutdownError``, as the reference's does."""
    for mod in (PL, RPL):
        pool = mod.PipelinePool("torch-pipeline-test")
        gate = threading.Event()
        running = pool.submit(gate.wait)
        late = Future()
        with pool._lock:
            pool._tasks.put((late, lambda: 1, ()))
        stopper = threading.Thread(target=pool.shutdown, args=(10.0,))
        stopper.start()
        while not pool.shutting_down.is_set():
            time.sleep(0.001)
        gate.set()
        stopper.join()
        assert running.result() is True
        assert late.cancelled()
        with pytest.raises(mod.PoolShutdownError):
            mod._result_or_shutdown(late)
        assert pool.alive_threads() == []


def test_get_pool_is_made_anew_after_shutdown():
    first = PL.get_pool()
    assert PL.get_pool() is first
    assert PL.shutdown() == []
    second = PL.get_pool()
    assert second is not first
    assert second.submit(lambda: 7).result() == 7
    assert PL.shutdown() == []
    assert _port_threads() == []


def test_confs_keep_the_reference_keys_and_defaults():
    from spark_rapids_tpu import config as RC
    from spark_rapids_tpu_torch import config as C
    for mine, ref in ((C.PIPELINE_ENABLED, RC.PIPELINE_ENABLED),
                      (C.PIPELINE_DECODE_THREADS,
                       RC.PIPELINE_DECODE_THREADS),
                      (C.PIPELINE_PREFETCH_DEPTH,
                       RC.PIPELINE_PREFETCH_DEPTH)):
        assert (mine.key, mine.default) == (ref.key, ref.default)
    assert PL._auto_threads() == RPL._auto_threads()
    conf = TorchConf({"spark.rapids.tpu.pipeline.decodeThreads": "3",
                      "spark.rapids.tpu.pipeline.prefetchDepth": 5})
    assert PL._decode_limiter(conf)._initial_value == 3
    assert PL.prefetch_depth(conf) == 5
    assert PL._decode_limiter(TorchConf())._initial_value \
        == PL._auto_threads()
    assert PL.parallel_active(_ctx(ON)) and not PL.parallel_active(_ctx(OFF))


# -- ordered maps and unit partitions ----------------------------------------


def _slow_square(x):
    time.sleep(0.002 * ((x * 7) % 5))  # later units may finish first
    return x * x


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_ordered_map_iter_keeps_input_order(depth):
    items = list(range(40))
    want = [x * x for x in items]
    ctx = _ctx(ON)
    got = list(PL.ordered_map_iter(_slow_square, items, ctx, "T", depth))
    assert got == want
    assert list(RPL.ordered_map_iter(_slow_square, items, None, None,
                                     depth)) == want
    assert list(PL.ordered_map_iter(_slow_square, items, _ctx(OFF),
                                    "T")) == want
    assert "T.busy" in ctx.exec_ms()


@pytest.mark.parametrize("n", [0, 1, 2, 9])
def test_unit_partitions_on_equals_off(n):
    units = list(range(n))
    got = {}
    for name, conf in (("on", ON), ("off", OFF)):
        ctx = _ctx(conf)
        parts = PL.unit_partitions(_slow_square, units, ctx, "T")
        assert len(parts) == n
        got[name] = [list(p) for p in parts]
        ctx.run_cleanups()
    assert got["on"] == got["off"] == [[u * u] for u in units]


def test_unit_partitions_look_ahead_is_bounded_and_cancelled():
    """Pulling partition i schedules units i .. i + depth - 1 only; the
    context's cleanup cancels the look-ahead of an abandoned scan."""
    started = []
    gate = threading.Event()

    def unit(i):
        started.append(i)
        gate.wait(10)
        return i

    ctx = _ctx({**ON, "spark.rapids.tpu.pipeline.prefetchDepth": 2})
    parts = PL.unit_partitions(unit, list(range(6)), ctx, "T")
    assert started == []  # nothing runs before a partition is read
    first = iter(parts[0])
    t = threading.Thread(target=lambda: started.append(("got", next(first))))
    t.start()
    while len(started) < 2:
        time.sleep(0.001)
    time.sleep(0.05)
    assert sorted(started) == [0, 1]
    ctx.run_cleanups()
    gate.set()
    t.join()
    assert ("got", 0) in started
    assert not [s for s in started if s not in (0, 1, ("got", 0))]


# -- the parquet scan through the pipeline -----------------------------------


def _table(n: int, seed: int = 5) -> pa.Table:
    rng = np.random.default_rng(seed)
    ints = rng.integers(-1000, 1000, n)
    words = np.array(["alpha", "beta", "gamma", "delta", "epsilon"])
    return pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "i": pa.array(ints, mask=rng.random(n) < 0.2),
        "x": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.1),
        "d": pa.array(rng.integers(-20000, 20000, n).astype(np.int32),
                      type=pa.int32()).cast(pa.date32()),
        "s": pa.array(words[rng.integers(0, 5, n)].tolist(),
                      mask=rng.random(n) < 0.15),
    })


@pytest.fixture(scope="module")
def scan_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    tbl = _table(ROWS)
    out = {}
    for groups in (1, 2, 7):
        path = str(d / f"rg{groups}.parquet")
        pq.write_table(tbl, path, row_group_size=-(-ROWS // groups))
        assert pq.ParquetFile(path).metadata.num_row_groups == groups
        out[groups] = path
    many = d / "many"
    many.mkdir()
    for i in range(3):
        pq.write_table(_table(900, seed=10 + i),
                       str(many / f"part-{i}.parquet"), row_group_size=300)
    out["dir"] = str(many)
    return out


def _host_equal(a, b) -> None:
    assert list(a.columns) == list(b.columns)
    for name in a.columns:
        va, vb = np.asarray(a.validity[name]), np.asarray(b.validity[name])
        np.testing.assert_array_equal(va, vb, err_msg=name)
        ga, gb = np.asarray(a.columns[name]), np.asarray(b.columns[name])
        if ga.dtype.kind == "f":
            ga, gb = ga.view(np.int64), gb.view(np.int64)  # bit for bit
        elif ga.dtype == object:
            ga = np.array([v if ok else None for v, ok in zip(ga, va)],
                          dtype=object)
            gb = np.array([v if ok else None for v, ok in zip(gb, vb)],
                          dtype=object)
        np.testing.assert_array_equal(ga, gb, err_msg=name)


def _ref_scan(path) -> dict:
    tbl = TpuSession({"spark.rapids.sql.enabled": True}).read.parquet(
        path).collect()
    return {n: tbl.column(n).to_pylist() for n in tbl.column_names}


@pytest.mark.parametrize("which", [1, 2, 7, "dir"])
def test_scan_on_equals_off_and_the_reference(which, scan_files):
    path = scan_files[which]
    got = {}
    for name, conf in (("on", ON), ("off", OFF)):
        s = TorchSession(conf, device="cpu")
        got[name] = s.read.parquet(path).collect()
        got[name + "_ms"] = s.last_query.exec_ms
    _host_equal(got["on"], got["off"])
    n_units = 3 * 3 if which == "dir" else which
    assert ("ParquetScanExec.busy" in got["on_ms"]) == (n_units > 1)
    assert "ParquetScanExec.busy" not in got["off_ms"]
    want = _ref_scan(path)
    h = got["on"]
    assert list(h.columns) == list(want)
    for name, values in want.items():
        mine = [v if ok else None for v, ok in zip(
            np.asarray(h.columns[name]).tolist(), h.validity[name])]
        if name == "d":
            values = [None if v is None else (v - _EPOCH).days
                      for v in values]
        assert mine == values, name


def test_scan_query_on_equals_off(scan_files):
    """A filter and an aggregate over the 7-row-group scan."""
    out = {}
    for name, conf in (("on", ON), ("off", OFF)):
        df = TorchSession(conf, device="cpu").read.parquet(scan_files[7])
        out[name] = (df.where(P.GreaterThan(col("i"), lit(0)))
                     .group_by(col("s"))
                     .agg(A.AggregateExpression(A.Count(), "n"),
                          A.AggregateExpression(A.Sum(col("x")), "sx"))
                     .collect())
    _host_equal(out["on"], out["off"])


def test_decode_error_reaches_the_consumer_unchanged(tmp_path):
    """A column the decoder does not take (a GZIP chunk) raises the same
    ``NotImplementedError``, naming file, column and reason, with the
    pipeline on (raised on a worker) and off."""
    path = str(tmp_path / "gzip.parquet")
    tbl = _table(900)
    pq.write_table(tbl, path, row_group_size=300,
                   compression={"k": "snappy", "i": "snappy", "x": "gzip",
                                "d": "snappy", "s": "snappy"})
    errors = {}
    for name, conf in (("on", ON), ("off", OFF)):
        with pytest.raises(NotImplementedError) as e:
            TorchSession(conf, device="cpu").read.parquet(path).collect()
        errors[name] = str(e.value)
    assert errors["on"] == errors["off"]
    assert path in errors["on"] and "'x'" in errors["on"] \
        and "GZIP" in errors["on"]


def test_scan_partitions_are_generators_read_once(scan_files):
    ctx = _ctx(ON)
    df = TorchSession(ON, device="cpu").read.parquet(scan_files[7])
    scan = df._session.plan(df._plan)
    parts = scan.execute(ctx)
    assert len(parts) == 7
    rows = [int(b.n_rows) for part in parts for b in part]
    assert rows == [600] * 7
    assert [list(p) for p in parts] == [[]] * 7  # each read once
    ctx.run_cleanups()
    assert ctx.counters["ParquetScanExec.rows"] == ROWS


# -- ExecContext under threads, cleanups, close -------------------------------


def test_concurrent_counts_sum_exactly():
    ctx = _ctx(ON)
    n_threads, per = 8, 5000
    barrier = threading.Barrier(n_threads)

    def work(k):
        barrier.wait()
        for _ in range(per):
            ctx.count("c", k)
            t = time.perf_counter()
            ctx.host_interval("t", t, t)

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(1, n_threads + 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ctx.counters["c"] == per * sum(range(1, n_threads + 1))
    assert len(ctx._marks) == per * n_threads


def test_session_runs_cleanups_after_every_attempt(scan_files, monkeypatch):
    """A join whose build side repeats its key trips the dense table and
    re-runs; every attempt's cleanups run, the re-runs' included."""
    ran = []
    real = E.ExecContext.run_cleanups

    def counting(self):
        ran.append(len(self._cleanups))
        real(self)
    monkeypatch.setattr(E.ExecContext, "run_cleanups", counting)
    s = TorchSession(ON, device="cpu")
    scan = s.read.parquet(scan_files[7])
    build = s.create_dataframe({"i": np.array([1, 1, 2, 3], np.int64),
                                "w": np.array([10, 11, 12, 13], np.int64)})
    got = scan.join(build.select(col("i").alias("bi"), col("w")),
                    on=P.EqualTo(col("i"), col("bi")), how="inner").collect()
    attempts = s.last_query.attempts
    assert attempts >= 2
    assert len(ran) == attempts
    assert all(n >= 1 for n in ran)  # the scan's look-ahead registered
    off = TorchSession(OFF, device="cpu")
    want = off.read.parquet(scan_files[7]).join(
        off.create_dataframe({"i": np.array([1, 1, 2, 3], np.int64),
                              "w": np.array([10, 11, 12, 13], np.int64)})
        .select(col("i").alias("bi"), col("w")),
        on=P.EqualTo(col("i"), col("bi")), how="inner").collect()
    _host_equal(got, want)


def test_close_leaves_no_worker_alive(scan_files):
    s = TorchSession(ON, device="cpu")
    s.read.parquet(scan_files[7]).collect()
    assert _port_threads()  # the scan ran on the pool
    assert s.close() == []
    assert _port_threads() == []
    # the pool is made anew: the session keeps working after close
    assert s.read.parquet(scan_files[2]).collect().num_rows == ROWS
    assert s.close() == []
    assert _port_threads() == []


# -- fusion boundaries and the overlapped download ---------------------------


class _Boundary(E.TorchExec):
    """A boundary stand-in: one batch of ``value`` after ``delay`` s,
    reporting a fail flag at a site of its own."""

    name = "_Boundary"

    def __init__(self, value: int, delay: float):
        self.children = []
        self.value, self.delay = value, delay

    @property
    def schema(self):
        from spark_rapids_tpu_torch import types as T
        return T.Schema([T.StructField("v", T.LONG)])

    def execute(self, ctx):
        from spark_rapids_tpu_torch.data.batch import HostBatch
        time.sleep(self.delay)
        site = ctx.next_site("join")
        ctx.report(site, torch.tensor(self.value % 2 == 1))
        return [[HostBatch.from_numpy(
            {"v": np.full(3, self.value, np.int64)}).to_device("cpu")]]


@pytest.mark.parametrize("conf", [ON, OFF,
                                  {**ON, "spark.rapids.tpu.pipeline."
                                   "boundaryParallelism": 1}])
def test_materialize_boundaries_order_and_sites(conf):
    # later boundaries finish first when run at once
    bs = [_Boundary(i, 0.02 * (4 - i)) for i in range(4)]
    ctx = _ctx(conf)
    out = PL.materialize_boundaries(bs, ctx)
    assert [int(p[0][0].columns[0].data[0]) for p in out] == [0, 1, 2, 3]
    assert ctx.site_kinds == ["join"] * 4
    parallel = conf is ON
    # forks number their sites in namespaces the boundary order fixes
    want = [(i + 1) << 20 for i in range(4)] if parallel else [0, 1, 2, 3]
    assert ctx.site_ids == want
    assert [s for s, _ in ctx.dense_fails] == want
    assert [bool(f) for _, f in ctx.dense_fails] == [False, True] * 2
    overlap = ctx.registry.snapshot().get("WholeStageFusion", {}).get(
        "boundaryOverlapNs", 0)
    assert (overlap > 0) == parallel


def test_materialize_boundaries_raises_after_every_worker():
    class Bad(_Boundary):
        def execute(self, ctx):
            raise RuntimeError("boundary failed")
    ctx = _ctx()
    bs = [_Boundary(0, 0.05), Bad(1, 0), _Boundary(2, 0.05)]
    with pytest.raises(RuntimeError, match="boundary failed"):
        PL.materialize_boundaries(bs, ctx)
    # the good forks were absorbed before the error re-raised
    assert len(ctx.site_kinds) == 2


def test_overlapped_download_equals_serial(scan_files):
    def run(conf):
        s = TorchSession({**conf, "spark.rapids.tpu.fusion.enabled": False},
                         device="cpu")
        df = s.read.parquet(scan_files[7])
        return df.where(P.LessThan(col("k"), lit(10**9))).collect()
    on, off = run(ON), run(OFF)
    _host_equal(on, off)
    assert on.num_rows == ROWS
    # seven row groups: seven batches downloaded, in order
    ctx = _ctx(ON)
    s = TorchSession({"spark.rapids.tpu.fusion.enabled": False},
                     device="cpu")
    plan = s.plan(s.read.parquet(scan_files[7])._plan)
    parts = E.DeviceToHostExec(plan).execute(ctx)
    hosts = [hb for p in parts for hb in p]
    assert len(hosts) == 7
    assert sum(h.num_rows for h in hosts) == ROWS
