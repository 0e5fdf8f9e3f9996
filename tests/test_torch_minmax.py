"""Min, Max, First and Last, and the engine's entry stage, against the JAX
package.

One seeded table goes through both packages' ``aggregate_batch`` (the
reference's ``_aggregate_batch``) on the CPU: int64, date, bool and
float64 values (NaN, +0.0 and -0.0, nulls, a group whose values are all
null) under a dictionary string key (the dictionary path), an int key on
the dense path (``dense_mode=0``) and on the sort path (``dense_mode=1``,
where the port's ``segmented`` wrapper takes its plain version), and no
key (the global path); in update mode over rows and in merge mode over a
buffer batch; over a live batch and over one with no live row. The
reference runs with its Pallas gate on (interpret mode) and off.

Everything is bit for bit: min and max do not round, and first and last
pick rows. Floats compare by their bits, so a NaN must be where the
reference puts it, and -0.0 apart from 0.0.

Then ``spark_rapids_tpu_torch.entry.entry()`` against
``__graft_entry__.entry()``'s ``forward`` under JAX: at the defaults, and
at 16,384 rows with 50 and with 1,500,000 keys (the latter through the
reference's ``forward`` over the same columns).
"""

import numpy as np
import pyarrow as pa
import pytest

import jax.numpy as jnp
import torch

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.data.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.data.batch import HostBatch as RHostBatch
from spark_rapids_tpu.exec.execs import _aggregate_batch
from spark_rapids_tpu.ops import aggregates as RA
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.kernels import pallas as PAL
from spark_rapids_tpu.ops.kernels import rowops as RKR

import __graft_entry__ as GRAFT
from spark_rapids_tpu_torch import entry as ENTRY
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.exec.execs import aggregate_batch
from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops.expression import col
from spark_rapids_tpu_torch.ops.kernels import rowops as KR
from spark_rapids_tpu_torch.ops.kernels.cuda import segmented as SEG
from test_torch_ops import port_schema, ref_fields, to_port

VALUES = ("i", "d", "bo", "f")
FUNCS = ("Min", "Max", "First", "Last")
#: (value, function) pairs held against the reference: its min and max
#: refuse a bool lane (``jnp.iinfo(bool)``), so bool min and max are held
#: against numpy instead (:func:`test_bool_min_max_match_numpy`)
PAIRS = [(v, fn) for v in VALUES for fn in FUNCS
         if not (v == "bo" and fn in ("Min", "Max"))]
#: key columns and dense_mode of each path
PATHS = {"dictionary": (["s"], 1), "dense int": (["k"], 0),
         "sort": (["k"], 1), "global": ([], 1)}
#: the key value (and string key) whose values are all null
NULL_GROUP = 7


def table(n: int = 700, seed: int = 11) -> pa.RecordBatch:
    rng = np.random.default_rng(seed)
    k = rng.integers(0, NULL_GROUP + 1, n)
    words = np.array(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP",
                      "TRUCK", "ZZ"])
    i = rng.integers(-1000, 1000, n)
    d = rng.integers(8000, 11000, n).astype(np.int32)
    bo = rng.random(n) < 0.5
    f = np.round(rng.normal(0, 50, n), 1)
    f[rng.random(n) < 0.04] = np.nan
    f[rng.random(n) < 0.05] = 0.0
    f[rng.random(n) < 0.05] = -0.0
    f[k == 3] = np.nan  # a group where every valid value is NaN
    all_null = k == NULL_GROUP

    def mask():
        return (rng.random(n) < 0.1) | all_null

    return pa.RecordBatch.from_arrays([
        pa.array(k, pa.int64(), mask=rng.random(n) < 0.03),
        pa.array(words[k], pa.string(), mask=rng.random(n) < 0.03),
        pa.array(i, pa.int64(), mask=mask()),
        pa.array(d, pa.date32(), mask=mask()),
        pa.array(bo, pa.bool_(), mask=mask()),
        pa.array(f, pa.float64(), mask=mask()),
    ], names=["k", "s", *VALUES])


def _batches(empty: bool):
    rb = RBatch.from_arrow(table())
    keep = np.random.default_rng(5).random(rb.capacity) < 0.85
    if empty:
        keep[:] = False
    rb = RKR.compact(rb, jnp.asarray(keep))
    return rb, to_port(rb)


def _aggs(port: bool, merge: bool, schema, pairs=PAIRS):
    """One aggregate of each function over each value column; in merge
    mode each reads its own buffer column, named after it."""
    mod, c = (A, col) if port else (RA, rcol)
    out = []
    for v, fn in pairs:
        name = f"{fn}_{v}"
        child = c(name if merge else v)
        out.append(mod.AggregateExpression(
            getattr(mod, fn)(child).bind(schema), name))
    return out


def _buffer_schema(keys, fields, port: bool, pairs=PAIRS):
    types_mod = T if port else RT
    ftype = {f.name: f.data_type for f in fields}
    out = [types_mod.StructField(k, ftype[k], True) for k in keys]
    for v, fn in pairs:
        out.append(types_mod.StructField(f"{fn}_{v}", ftype[v], True))
    return types_mod.Schema(out)


def _merge_input(rb, keys):
    """A buffer batch: the key columns, then one column a buffer, each a
    copy of its value column (the same rows, nulls and NaNs)."""
    by_name = {f.name: (c, f) for c, f in zip(rb.columns, rb.schema)}
    cols = [by_name[k][0] for k in keys]
    fields = [by_name[k][1] for k in keys]
    for v, fn in PAIRS:
        c, f = by_name[v]
        cols.append(c)
        fields.append(RT.StructField(f"{fn}_{v}", f.data_type, True))
    return RBatch(tuple(cols), rb.n_rows, RT.Schema(fields), live=rb.live)


def _assert_bits(got, want, live) -> None:
    n = len(live)  # the global path keeps its one group at capacity 128
    gv = got.validity.numpy()[live]
    wv = np.asarray(want.validity)[:n][live]
    np.testing.assert_array_equal(gv, wv)
    g, w = got.data.numpy()[live][gv], np.asarray(want.data)[:n][live][wv]
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    if g.dtype.kind == "f":
        g, w = g.view(np.int64), w.view(np.int64)
    np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def batches():
    return {empty: _batches(empty) for empty in (False, True)}


@pytest.mark.parametrize("empty", [False, True], ids=["rows", "empty"])
@pytest.mark.parametrize("pallas", [True, False],
                         ids=["pallas on", "pallas off"])
@pytest.mark.parametrize("mode", ["update", "merge"])
@pytest.mark.parametrize("path", list(PATHS))
def test_min_max_first_last_match_reference(path, mode, pallas, empty,
                                            batches):
    keys, dense_mode = PATHS[path]
    rows, _ = batches[empty]
    rbuf = _buffer_schema(keys, list(rows.schema), port=False)
    pbuf = _buffer_schema(keys, list(port_schema(rows.schema)), port=True)
    merge = mode == "merge"
    rb = _merge_input(rows, keys) if merge else rows
    pb = to_port(rb)
    rschema, pschema = rb.schema, port_schema(rb.schema)
    rout, rfail = _aggregate_batch(
        rb, [rcol(k).bind(rschema) for k in keys],
        _aggs(False, merge, rschema), rbuf, len(keys), not merge,
        dense_mode=dense_mode, pallas=PAL.PallasConf(enabled=pallas))
    calls = []
    plain = SEG.segment_reduce_sorted

    def counted(*a):
        calls.append(a[-1])
        return plain(*a)

    SEG.segment_reduce_sorted = counted
    try:
        pout, pfail = aggregate_batch(
            pb, [col(k).bind(pschema) for k in keys],
            _aggs(True, merge, pschema), pbuf, len(keys), not merge,
            dense_mode=dense_mode)
    finally:
        SEG.segment_reduce_sorted = plain
    assert (rfail is None) == (pfail is None)
    if pfail is not None:
        assert bool(pfail) == bool(rfail)
    assert int(pout.n_rows) == int(rout.n_rows)
    assert int(pout.n_rows) == (1 if not keys else 0 if empty else 9)
    live = np.asarray(rout.row_mask())
    if not keys:
        assert pout.capacity == 128 and not live[128:].any()
        live = live[:128]
    np.testing.assert_array_equal(pout.row_mask().numpy(), live)
    for g, w in zip(pout.columns[:len(keys)], rout.columns[:len(keys)]):
        np.testing.assert_array_equal(g.validity.numpy()[live],
                                      np.asarray(w.validity)[live])
    for g, w in zip(pout.columns[len(keys):], rout.columns[len(keys):]):
        _assert_bits(g, w, live)
    # the sort path reduces int and date min/max through segmented; the
    # bool and float lanes and the other paths do not reach it
    if path == "sort":
        assert {"min", "max"} <= set(calls)
    else:
        assert calls == []


def test_all_null_group_is_null_and_nan_group_is_nan(batches):
    rb, pb = batches[False]
    schema = pb.schema
    out, _ = aggregate_batch(pb, [col("k").bind(schema)],
                             _aggs(True, False, schema),
                             _buffer_schema(["k"], list(schema), True), 1,
                             True)
    host = HostBatch.from_device(out)
    row = list(host.columns["k"]).index(NULL_GROUP)
    for v, fn in PAIRS:
        assert not host.validity[f"{fn}_{v}"][row], (fn, v)
    row3 = list(host.columns["k"]).index(3)
    for fn in FUNCS:
        assert np.isnan(host.columns[f"{fn}_f"][row3]), fn


@pytest.mark.parametrize("path", list(PATHS))
def test_bool_min_max_match_numpy(path, batches):
    """Spark's min and max of a boolean: false < true (and, or)."""
    keys, dense_mode = PATHS[path]
    _, pb = batches[False]
    pairs = [("bo", "Min"), ("bo", "Max")]
    schema = pb.schema
    out, _ = aggregate_batch(pb, [col(k).bind(schema) for k in keys],
                             _aggs(True, False, schema, pairs),
                             _buffer_schema(keys, list(schema), True, pairs),
                             len(keys), True, dense_mode=dense_mode)
    host = HostBatch.from_device(out)
    live = pb.row_mask().numpy()
    bo, bv = pb.column("bo").data.numpy(), pb.column("bo").validity.numpy()
    gkey = pb.column(keys[0]).lane.numpy() if keys else np.zeros_like(bo)
    gval = pb.column(keys[0]).validity.numpy() if keys else live
    for g in range(int(out.n_rows)):
        if keys:
            kcol = out.columns[0]
            in_g = (gkey == kcol.lane[g].item()) & gval if kcol.validity[g] \
                else ~gval
        else:
            in_g = np.ones_like(live)
        vals = bo[in_g & live & bv]
        for fn, want in (("Min", vals.all()), ("Max", vals.any())):
            name = f"{fn}_bo"
            assert host.validity[name][g] == (len(vals) > 0), (g, fn)
            if len(vals):
                assert host.columns[name][g] == want, (g, fn)


@pytest.mark.parametrize("fn", FUNCS)
def test_string_child_raises(fn):
    """A string child, which this test once saw refused, now declares a
    string buffer reduced by the aggregate's own op (the reductions are
    held against the reference in ``tests/test_torch_string_aggs.py``)."""
    schema = T.Schema([T.StructField("s", T.STRING)])
    agg = getattr(A, fn)(col("s")).bind(schema)
    assert agg.data_type is T.STRING
    [spec] = agg.buffers()
    assert spec.dtype is T.STRING
    assert spec.update_op == spec.merge_op == fn.lower()


# --------------------------------------------------------------------------
# the entry stage
# --------------------------------------------------------------------------


def _ref_forward_on(cols: dict):
    """The reference's ``forward`` from ``__graft_entry__.entry()`` and its
    input: the reference's own batch at the defaults, else ``cols``
    uploaded through the reference's ``HostBatch``."""
    forward, (batch,) = GRAFT.entry()
    if cols is not None:
        batch = RHostBatch.from_pydict(
            {k: v.tolist() for k, v in cols.items()}).to_device()
    return forward, batch


@pytest.mark.parametrize("n,key_range", [(None, None), (16_384, 50),
                                         (16_384, 1_500_000)],
                         ids=["defaults", "16384 rows, 50 keys",
                              "16384 rows, 1500000 keys"])
def test_entry_matches_reference(n, key_range):
    kwargs = {} if n is None else {"n": n, "key_range": key_range}
    forward, (batch,) = ENTRY.entry(device="cpu", **kwargs)
    calls = []
    plain = SEG.segment_reduce_sorted

    def counted(*a):
        calls.append((tuple(a[0].shape), a[-1]))
        return plain(*a)

    SEG.segment_reduce_sorted = counted
    try:
        out, fail = forward(batch)
    finally:
        SEG.segment_reduce_sorted = plain
    rforward, rbatch = _ref_forward_on(
        None if n is None else ENTRY.entry_columns(**kwargs))
    if n is None:
        want_in = ENTRY.entry_columns()
        for name, c in zip(("k", "q", "p"), rbatch.columns):
            np.testing.assert_array_equal(
                np.asarray(c.data)[:len(want_in[name])], want_in[name])
    rout, rfail = rforward(rbatch)
    assert fail is None and rfail is None
    assert out.capacity == rout.capacity == batch.capacity
    assert int(out.n_rows) == int(rout.n_rows)
    assert out.schema.names == [f.name for f in rout.schema]
    live = np.asarray(rout.row_mask())
    np.testing.assert_array_equal(out.row_mask().numpy(), live)
    for g, w in zip(out.columns, rout.columns):
        _assert_bits(g, w, live)
    # the sort path: sum lanes, min and max through the segmented wrapper
    kinds = sorted(op for _, op in calls)
    assert kinds == ["max", "min", "sum"], calls
    if n == 16_384 and key_range == 50:
        assert int(out.n_rows) == 50


def test_entry_numbers_its_groups_in_key_order():
    forward, (batch,) = ENTRY.entry(n=5000, key_range=300, seed=3,
                                    device="cpu")
    out, _ = forward(batch)
    want = ENTRY.entry_reference(ENTRY.entry_columns(5000, 300, 3))
    host = HostBatch.from_device(out)
    assert list(host.columns) == list(want)
    for name, w in want.items():
        assert host.validity[name].all()
        assert host.columns[name].dtype == np.int64
        np.testing.assert_array_equal(host.columns[name], w, err_msg=name)


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY.entry()


# --------------------------------------------------------------------------
# the mesh path
# --------------------------------------------------------------------------


def _mesh_table(n: int = 512, seed: int = 4) -> HostBatch:
    """Rows for a 4-shard mesh (128 rows a shard): ``f`` is NaN on every
    row of shard 0 and on one key's rows, -0.0 and 0.0 elsewhere."""
    rng = np.random.default_rng(seed)
    f = np.round(rng.normal(0, 10, n), 1)
    f[rng.random(n) < 0.1] = -0.0
    f[rng.random(n) < 0.1] = 0.0
    k = rng.integers(0, 6, n)
    f[:128] = np.nan
    f[k == 5] = np.nan
    cols = {"k": k.astype(np.int64),
            "i": rng.integers(-99, 99, n).astype(np.int64),
            "d": rng.integers(9000, 9500, n).astype(np.int32),
            "f": f}
    valid = {name: rng.random(n) > 0.05 for name in cols}
    valid["k"] = np.ones(n, bool)
    schema = T.Schema([T.StructField("k", T.LONG), T.StructField("i", T.LONG),
                       T.StructField("d", T.DATE),
                       T.StructField("f", T.DOUBLE)])
    return HostBatch.from_numpy(cols, schema, valid)


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "global"])
def test_mesh_min_max_match_single_path(grouped):
    """The mesh path merges the shards' min and max buffers (the grouped
    path through the merge aggregate, the global one through a reduction
    over the shards) to the single path's answer: a float min is NaN only
    when every value is NaN, a max when any is."""
    from spark_rapids_tpu_torch.parallel import mesh as PM
    from spark_rapids_tpu_torch.session import TorchSession

    host = _mesh_table()
    aggs = [A.AggregateExpression(getattr(A, fn)(col(v)), f"{fn}_{v}")
            for v in ("i", "d", "f") for fn in ("Min", "Max")]
    results = {}
    for path, session in (
            ("single", TorchSession(device="cpu")),
            ("mesh", TorchSession({"spark.rapids.tpu.mesh.enabled": True},
                                  device="cpu",
                                  mesh=PM.make_mesh(
                                      devices=[torch.device("cpu")] * 4)))):
        df = session.create_dataframe(host)
        keys = [col("k")] if grouped else []
        results[path] = df.group_by(*keys).agg(*aggs).collect()
        assert session.last_query.path == path
    got, want = results["mesh"], results["single"]
    order_g = np.argsort(got.columns["k"]) if grouped else [0]
    order_w = np.argsort(want.columns["k"]) if grouped else [0]
    for name in want.columns:
        np.testing.assert_array_equal(got.validity[name][order_g],
                                      want.validity[name][order_w], name)
        g = np.asarray(got.columns[name])[order_g]
        w = np.asarray(want.columns[name])[order_w]
        if g.dtype.kind == "f":
            g, w = g.view(np.int64), w.view(np.int64)
        np.testing.assert_array_equal(g, w, err_msg=name)
    f = host.columns["f"][host.validity["f"]]
    if not grouped:
        assert want.columns["Min_f"][0] == np.nanmin(f)
        assert np.isnan(want.columns["Max_f"][0])
