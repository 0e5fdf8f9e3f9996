"""The mesh path against the JAX package: the exchange (``shuffle/ici``),
the distributed group-by step and ``TorchSession`` with
``spark.rapids.tpu.mesh.enabled``.

The port runs on ``make_mesh(devices=[cpu] * n)``, its shards one after
another on the CPU; the reference on its 8-device virtual CPU mesh
(``tests/conftest.py``). Keys, strings, counts, dates and row order must
be equal; float sums are held to ``tests/harness.py``'s
``DEVICE_FLOAT_TOL`` (partials per shard add in another order).

TPC-H Q1 and Q6 compare mesh against mesh. The reference's mesh Q3 and
Q4 take several seconds each to compile here, so the port's mesh answer
for them is held against the reference's single-device ``TpuSession``,
as are the range sorts and the overflow retry (against the reference's
CPU oracle session, which the reference's own mesh tests use).
"""

import numpy as np
import pyarrow as pa
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec

from spark_rapids_tpu.ops import aggregates as RAGG
from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.parallel import distributed as RD
from spark_rapids_tpu.parallel.mesh import PART_AXIS
from spark_rapids_tpu.parallel.mesh import make_mesh as ref_make_mesh
from spark_rapids_tpu.parallel.mesh import shard_map
from spark_rapids_tpu.plan.logical import SortOrder as RSortOrder
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.shuffle import ici as RICI
from spark_rapids_tpu.workloads import tpch as rtpch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec import execs as E
from spark_rapids_tpu_torch.exec import mesh as MX
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.ops import aggregates as AGG
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops.expression import col
from spark_rapids_tpu_torch.parallel import distributed as D
from spark_rapids_tpu_torch.parallel import mesh as PM
from spark_rapids_tpu_torch.plan.logical import SortOrder
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.shuffle import ici
from spark_rapids_tpu_torch.workloads import tpch
from harness import DEVICE_FLOAT_TOL
from test_torch_tpch_more import COLUMNS, _ordered, _ref_columns

MESH_CONF = {"spark.rapids.tpu.mesh.enabled": True}


def cpu_mesh(n: int) -> PM.Mesh:
    return PM.make_mesh(devices=[torch.device("cpu")] * n)


def mesh_session(n: int = 8) -> TorchSession:
    return TorchSession(MESH_CONF, device="cpu", mesh=cpu_mesh(n))


# --------------------------------------------------------------------------
# the exchange
# --------------------------------------------------------------------------


def _ref_route(vals, pids, n_rows, n, cap, bucket):
    mesh = ref_make_mesh(n)

    def inner(vals, pids, n_rows):
        live = jnp.arange(cap, dtype=jnp.int32) < n_rows[0]
        send, sv, ovf = RICI.build_send_buffers(
            {"v": vals}, jnp.ones(cap, jnp.bool_), pids, live, n, bucket)
        recv, rv = RICI.exchange(send, sv)
        flat, fv, n_recv = RICI.flatten_received(recv, rv)
        return flat["v"], fv, jnp.full(1, n_recv, jnp.int32)
    spec = PartitionSpec(PART_AXIS)
    v, fv, nr = jax.jit(shard_map(inner, mesh=mesh, in_specs=(spec,) * 3,
                                  out_specs=(spec,) * 3))(
        jnp.asarray(vals), jnp.asarray(pids), jnp.asarray(n_rows))
    return (np.asarray(v).reshape(n, -1), np.asarray(fv).reshape(n, -1),
            np.asarray(nr))


def _port_route(vals, pids, n_rows, n, cap, bucket):
    mesh = cpu_mesh(n)
    sends, valids = [], []
    for s in range(n):
        rows = slice(s * cap, (s + 1) * cap)
        live = torch.arange(cap) < int(n_rows[s])
        send, sv, _ = ici.build_send_buffers(
            {"v": torch.tensor(vals[rows])}, torch.ones(cap, dtype=bool),
            torch.tensor(pids[rows]), live, n, bucket)
        sends.append(send)
        valids.append(sv)
    recv, rvalid = ici.exchange(mesh, sends, valids)
    out = [ici.flatten_received(r, rv) for r, rv in zip(recv, rvalid)]
    return (np.stack([o[0]["v"].numpy() for o in out]),
            np.stack([o[1].numpy() for o in out]),
            np.array([int(o[2]) for o in out]))


@pytest.mark.parametrize("seed", [0, 1])
def test_exchange_routes_rows_like_reference(seed):
    """Rows land on the shard their id names, grouped by sender and in
    send order, as the reference's all_to_all delivers them."""
    n, cap, bucket = 4, 16, 8
    rng = np.random.default_rng(seed)
    vals = rng.integers(-1000, 1000, n * cap).astype(np.int64)
    pids = rng.integers(0, n, n * cap).astype(np.int32)
    n_rows = rng.integers(0, 9, n).astype(np.int32)
    gv, gf, gn = _port_route(vals, pids, n_rows, n, cap, bucket)
    wv, wf, wn = _ref_route(vals, pids, n_rows, n, cap, bucket)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(gf, wf)
    for d in range(n):
        np.testing.assert_array_equal(gv[d][:gn[d]], wv[d][:wn[d]])
    expect = {p: sorted(vals[s * cap + i] for s in range(n)
                        for i in range(n_rows[s]) if pids[s * cap + i] == p)
              for p in range(n)}
    assert {d: sorted(gv[d][:gn[d]].tolist()) for d in range(n)} == expect


def test_exchange_counts_overflow_like_reference():
    cap = 8
    vals = np.arange(cap, dtype=np.int64)
    live = np.ones(cap, bool)
    pids = np.zeros(cap, np.int32)  # every row to bucket 0
    _, _, want = RICI.build_send_buffers(
        {"v": jnp.asarray(vals)}, jnp.asarray(live), jnp.asarray(pids),
        jnp.asarray(live), n_parts=4, bucket_cap=4)
    send, sv, got = ici.build_send_buffers(
        {"v": torch.tensor(vals)}, torch.tensor(live), torch.tensor(pids),
        torch.tensor(live), n_parts=4, bucket_cap=4)
    assert int(got) == int(want) == 4
    assert send["v"].shape == (4, 4) and int(sv.sum()) == 4
    np.testing.assert_array_equal(send["v"][0].numpy(), vals[:4])


def test_all_to_all_across_listed_devices():
    """The list all_to_all: receiver d gets row d of each sender."""
    mesh = cpu_mesh(3)
    xs = [torch.arange(6).reshape(3, 2) + 10 * s for s in range(3)]
    got = PM.all_to_all(mesh, xs)
    for d in range(3):
        np.testing.assert_array_equal(
            got[d].numpy(), np.stack([x[d].numpy() for x in xs]))
    assert [int(v) for v in PM.psum(mesh, [torch.tensor(s) for s in
                                          range(3)])] == [3, 3, 3]
    assert [int(i) for i in PM.axis_index(mesh)] == [0, 1, 2]


def test_make_mesh_needs_the_cards_it_names():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="CUDA devices"):
        PM.make_mesh(have + 1)
    assert PM.make_mesh(devices=["cpu"] * 2).size == 2
    assert PM.is_device_loss(RuntimeError(
        "CUDA error: all CUDA-capable devices are busy or unavailable"))
    assert not PM.is_device_loss(RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    assert PM.probe_devices(["cpu", "cpu"]) == []
    err = PM.MeshDegradedError("probe failed", ["cuda:1"])
    assert err.failed_devices == ["cuda:1"] and "cuda:1" in str(err)


# --------------------------------------------------------------------------
# the distributed group-by step
# --------------------------------------------------------------------------


def _sum_by_key_case(n_parts: int, shard_cap: int, seed: int, kind: str):
    rng = np.random.default_rng(seed)
    total = n_parts * shard_cap
    n_rows = rng.integers(10, shard_cap, n_parts).astype(np.int32)
    keys = rng.integers(-6, 12, total).astype(np.int64)
    if kind == "skewed":
        keys[rng.random(total) < 0.85] = 7
    kv = rng.random(total) > (0.15 if kind == "null keys" else 0.0)
    vals = rng.integers(-100, 100, total).astype(np.int64)
    vv = rng.random(total) > 0.1
    for s in range(n_parts):  # dead rows hold junk the step must ignore
        dead = slice(s * shard_cap + n_rows[s], (s + 1) * shard_cap)
        keys[dead], kv[dead] = 99, True
    return keys, kv, vals, vv, n_rows


@pytest.mark.parametrize("kind", ["plain", "null keys", "skewed"])
@pytest.mark.parametrize("n_parts", [4, 8])
def test_distributed_sum_by_key_matches_reference(n_parts, kind):
    shard_cap = 64
    keys, kv, vals, vv, n_rows = _sum_by_key_case(n_parts, shard_cap,
                                                  n_parts, kind)
    want = RD.distributed_sum_by_key(
        ref_make_mesh(n_parts), jnp.asarray(keys), jnp.asarray(kv),
        jnp.asarray(vals), jnp.asarray(vv), jnp.asarray(n_rows))
    got = D.distributed_sum_by_key(
        cpu_mesh(n_parts), torch.tensor(keys), torch.tensor(kv),
        torch.tensor(vals), torch.tensor(vv), torch.tensor(n_rows))
    gk, gkv, gs, gc, gn = (g.numpy() for g in got)
    wk, wkv, ws, wc, wn = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(gn, wn)
    for d in range(n_parts):
        rows = slice(d * shard_cap, d * shard_cap + int(gn[d]))
        for g, w in ((gkv, wkv), (gs, ws), (gc, wc)):
            np.testing.assert_array_equal(g[rows], w[rows])
        ok = gkv[rows]
        np.testing.assert_array_equal(gk[rows][ok], wk[rows][ok])
    # and against numpy: one row per key (nulls one group), on one shard
    expect = {}
    for s in range(n_parts):
        for i in range(n_rows[s]):
            r = s * shard_cap + i
            k = int(keys[r]) if kv[r] else None
            tot, cnt = expect.get(k, (0, 0))
            expect[k] = (tot + (int(vals[r]) if vv[r] else 0),
                         cnt + int(vv[r]))
    seen = {}
    for d in range(n_parts):
        for i in range(int(gn[d])):
            r = d * shard_cap + i
            k = int(gk[r]) if gkv[r] else None
            assert k not in seen, f"key {k} on shards {seen.get(k)} and {d}"
            seen[k] = (int(gs[r]), int(gc[r]))
    assert seen == expect


# --------------------------------------------------------------------------
# TorchSession over the mesh: TPC-H
# --------------------------------------------------------------------------

ROWS = 1 << 13


@pytest.fixture(scope="module")
def tpch_tables():
    return tpch.gen_tables(ROWS)


@pytest.fixture(scope="module")
def port_mesh(tpch_tables):
    session = mesh_session(8)
    dfs = tpch.load(session, tpch_tables)
    out = {}
    for q in ("q1", "q3", "q4", "q6"):
        res = getattr(tpch, q)(dfs).collect()
        out[q] = (res, session.last_query)
    plans = {q: session.plan(getattr(tpch, q)(dfs)._plan)
             for q in ("q1", "q3", "q4", "q6", "q22")}
    return out, plans, session, dfs


#: (key columns, exact columns, float columns) of each query's result.
QUERY_COLUMNS = {**COLUMNS,
                 "q3": (["o_orderkey", "o_orderdate"], [], ["revenue"])}


def _assert_query(q, got_batch, want):
    keys, exact, floats = QUERY_COLUMNS[q]
    assert set(got_batch.columns) == set(want)
    for name in got_batch.columns:
        assert got_batch.validity[name].all(), name
    got = _ordered(dict(got_batch.columns), keys, q)
    want = {k: v.astype("datetime64[D]").astype(np.int64)
            if v.dtype.kind == "M" else v for k, v in want.items()}
    want = _ordered(want, keys, q)
    assert len(next(iter(got.values()))) == len(next(iter(want.values())))
    for name in got:
        if name in floats:
            np.testing.assert_allclose(got[name], want[name],
                                       rtol=DEVICE_FLOAT_TOL, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(np.asarray(got[name]).astype(str),
                                          np.asarray(want[name]).astype(str),
                                          err_msg=name)


@pytest.mark.parametrize("q", ["q1", "q6"])
def test_mesh_query_matches_reference_mesh(q, port_mesh):
    # The float aggregates run on the reference's device path, as its own
    # mesh TPC-H test sets.
    s = TpuSession({"spark.rapids.sql.enabled": True,
                    "spark.rapids.tpu.mesh.enabled": True,
                    "spark.rapids.sql.variableFloatAgg.enabled": True})
    want = _ref_columns(getattr(rtpch, q)(
        rtpch.load(s, rtpch.gen_tables(ROWS))).collect())
    got, info = port_mesh[0][q]
    assert info.path == "mesh" and info.shards == 8
    _assert_query(q, got, want)


@pytest.mark.parametrize("q", ["q3", "q4"])
def test_mesh_query_matches_reference_single_device(q, port_mesh):
    s = TpuSession({"spark.rapids.sql.enabled": True})
    want = _ref_columns(getattr(rtpch, q)(
        rtpch.load(s, rtpch.gen_tables(ROWS))).collect())
    got, info = port_mesh[0][q]
    assert info.path == "mesh" and info.shards == 8
    _assert_query(q, got, want)


def test_mesh_capability_of_the_queries(port_mesh):
    _, plans, session, dfs = port_mesh
    for q in ("q1", "q3", "q4", "q6"):
        assert MX.mesh_capable(plans[q]), q
    assert not MX.mesh_capable(plans["q22"])
    with pytest.raises(MX.NotMeshCapable, match="NestedLoopJoinExec"):
        MX._compile(MX._split_tail(plans["q22"])[1], [])
    # Q22 still answers, on the single-device path
    tpch.q22(dfs).collect()
    assert session.last_query.path == "single"
    assert session.last_query.shards == 1
    # Q3's top-k finishes on the collected core; Q4's sort stays in it
    tail, core = MX._split_tail(plans["q3"])
    assert [type(t) for t in tail] == [E.TopKExec]
    assert MX._split_tail(plans["q4"]) == ([], plans["q4"])


def test_mesh_capability_cache():
    session = mesh_session(2)
    df = session.create_dataframe({"k": np.arange(10), "v": np.arange(10)})
    plan = session.plan(df.group_by(col("k")).agg(
        AGG.AggregateExpression(AGG.Sum(col("v")), "s"))._plan)
    cache = {}
    assert MX.mesh_capable(plan, cache) and list(cache.values()) == [True]
    cache[next(iter(cache))] = False  # a cached answer is returned as is
    assert not MX.mesh_capable(plan, cache)


# --------------------------------------------------------------------------
# the range sort and the overflow retry
# --------------------------------------------------------------------------


def _oracle():
    return TpuSession({"spark.rapids.sql.enabled": False})


def _sorted_both(data: dict, orders, n_shards: int = 8):
    """(port mesh result, its QueryInfo, the reference oracle's table) of
    a sort of ``data`` (numpy arrays, None masks as nulls)."""
    session = mesh_session(n_shards)
    arrays, masks, schema = {}, {}, []
    for name, (values, mask) in data.items():
        arrays[name] = values
        masks[name] = ~mask
        schema.append(T.StructField(name, T.from_numpy_dtype(values.dtype)))
    df = session.create_dataframe(HostBatch.from_numpy(
        arrays, T.Schema(schema), masks))
    plan = session.plan(df.sort(*orders)._plan)
    tail, core = MX._split_tail(plan)
    assert tail == [] and isinstance(core, E.SortExec)
    got = df.sort(*orders).collect()
    rb = pa.RecordBatch.from_arrays(
        [pa.array(v, mask=m) for v, m in data.values()], names=list(data))
    rorders = [RSortOrder(rcol(o.child.name), o.ascending, o.nulls_first)
               for o in orders]
    want = _oracle().create_dataframe(rb).sort(*rorders).collect()
    return got, session.last_query, want


def _assert_order(got, want):
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        w = want.column(name).to_pylist()
        g = [None if not ok else (x.item() if hasattr(x, "item") else x)
             for x, ok in zip(got.columns[name], got.validity[name])]
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a == b or (a != a and b != b), f"column {name} order"


SORT_CASES = ["large int asc", "desc with nulls last", "nulls first asc",
              "string key", "NaN asc", "NaN desc", "INT64_MIN desc",
              "skewed keys"]


def sort_case(name: str):
    rng = np.random.default_rng(SORT_CASES.index(name))
    n = 6_000
    none = np.zeros(n, bool)
    uid = (np.arange(n, dtype=np.int64), none)
    if name == "large int asc":
        k = rng.integers(-10 ** 9, 10 ** 9, n).astype(np.int64)
        return {"k": (k, none), "uid": uid}, [True, None]
    if name == "desc with nulls last":
        k = rng.integers(0, 1000, n).astype(np.float64)
        return {"k": (k, rng.random(n) < 0.05), "uid": uid}, [False, False]
    if name == "nulls first asc":
        k = rng.integers(0, 50, n).astype(np.int64)
        return {"k": (k, rng.random(n) < 0.1), "uid": uid}, [True, True]
    if name == "string key":
        words = np.array([f"w{i:04d}" for i in range(300)])
        k = words[rng.integers(0, 300, n)]
        return {"k": (k, rng.random(n) < 0.05), "uid": uid}, [True, None]
    if name.startswith("NaN"):
        k = rng.normal(size=n)
        k[rng.random(n) < 0.03] = np.nan
        return {"k": (k, none), "uid": uid}, [name.endswith("asc"), None]
    if name == "INT64_MIN desc":
        k = rng.integers(-10 ** 18, 10 ** 18, n).astype(np.int64)
        k[:5] = np.iinfo(np.int64).min
        k[5:10] = np.iinfo(np.int64).max
        return {"k": (k, none), "uid": uid}, [False, None]
    k = np.where(rng.random(n) < 0.9, 7,
                 rng.integers(0, 10 ** 6, n)).astype(np.int64)
    return {"k": (k, none), "uid": uid}, [True, None]


@pytest.mark.parametrize("name", SORT_CASES)
def test_range_sort_matches_reference(name):
    data, (asc, nulls_first) = sort_case(name)
    orders = [SortOrder(col("k"), asc, nulls_first), SortOrder(col("uid"))]
    got, info, want = _sorted_both(data, orders)
    assert info.path == "mesh" and info.shards == 8
    if name == "skewed keys":  # the heavy key overflows its bucket
        assert info.attempts > 1
    _assert_order(got, want)


def test_skewed_join_overflow_retry_keeps_the_answer():
    """Every row hashes to one shard: the exchange buckets overflow at
    growth 1, and the session re-runs larger with the same answer."""
    n = 4_096
    probe = {"k": np.zeros(n, np.int64), "v": np.arange(n, dtype=np.int64)}
    build = {"bk": np.zeros(4, np.int64), "w": np.arange(4, dtype=np.int64)}
    session = mesh_session(4)
    got = (session.create_dataframe(probe)
           .join(session.create_dataframe(build),
                 on=P.EqualTo(col("k"), col("bk")), how="inner")
           .group_by(col("w"))
           .agg(AGG.AggregateExpression(AGG.Count(), "c"))).collect()
    info = session.last_query
    assert info.path == "mesh" and info.attempts > 1
    oracle = _oracle()
    want = (oracle.create_dataframe(pa.RecordBatch.from_pydict(probe))
            .join(oracle.create_dataframe(pa.RecordBatch.from_pydict(build)),
                  on=RP.EqualTo(rcol("k"), rcol("bk")), how="inner")
            .group_by(rcol("w"))
            .agg(RAGG.AggregateExpression(RAGG.Count(), "c"))).collect()
    order = np.argsort(got.columns["w"])
    worder = np.argsort(want.column("w").to_numpy())
    np.testing.assert_array_equal(got.columns["w"][order],
                                  want.column("w").to_numpy()[worder])
    np.testing.assert_array_equal(got.columns["c"][order],
                                  want.column("c").to_numpy()[worder])


def test_overflow_past_the_growth_limit_runs_on_the_single_path():
    """A join whose matches outgrow the buckets even at 64x: three mesh
    runs overflow (growth 1, 8, 64), then the query runs on the
    single-device path (with its own escalation runs) and answers."""
    n = 512
    probe = {"k": np.zeros(n, np.int64), "v": np.arange(n, dtype=np.int64)}
    build = {"bk": np.zeros(n, np.int64), "w": np.arange(n, dtype=np.int64)}
    session = mesh_session(2)
    got = (session.create_dataframe(probe)
           .join(session.create_dataframe(build),
                 on=P.EqualTo(col("k"), col("bk")), how="inner")
           .group_by(col("w"))
           .agg(AGG.AggregateExpression(AGG.Count(), "c"))).collect()
    info = session.last_query
    assert (info.path, info.shards) == ("single", 1) and info.attempts >= 4
    order = np.argsort(got.columns["w"])
    np.testing.assert_array_equal(got.columns["w"][order], np.arange(n))
    np.testing.assert_array_equal(got.columns["c"][order], np.full(n, n))
