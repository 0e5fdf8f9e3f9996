"""The port's operators against the JAX package on the same column states.

Each test uploads one seeded numpy table into the reference package,
carries the reference's column fields over with
``spark_rapids_tpu_torch.carry``, runs the same operation in both packages
(the port on the CPU, so its kernels take their plain versions) and
compares the live rows. Integers, dates, codes and validity must be
equal. Float results must be equal too, except the float sums of the
group-by, held to rtol 1e-12: both packages add in row order on the CPU,
and the bound only leaves room for a different association in a scatter.
"""

import numpy as np
import pyarrow as pa
import pytest

import jax.numpy as jnp
import torch

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.data.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.ops import arithmetic as RAR
from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit
from spark_rapids_tpu.ops.kernels import groupby as RKG
from spark_rapids_tpu.ops.kernels import join as RKJ
from spark_rapids_tpu.ops.kernels import pallas as PAL
from spark_rapids_tpu.ops.kernels import rowops as RKR
from spark_rapids_tpu.plan import logical as RL

from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops import arithmetic as AR
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.ops.kernels import groupby as KG
from spark_rapids_tpu_torch.ops.kernels import join as KJ
from spark_rapids_tpu_torch.ops.kernels import rowops as KR
from spark_rapids_tpu_torch.plan import logical as L

_TYPES = {"bigint": T.LONG, "double": T.DOUBLE, "date": T.DATE,
          "string": T.STRING, "int": T.INT, "boolean": T.BOOLEAN}


def ref_fields(c) -> dict:
    """A reference column's fields as numpy arrays (dictionary decoded)."""
    f = {"validity": np.asarray(c.validity)}
    if c.is_dict:
        data, off = np.asarray(c.data), np.asarray(c.offsets)
        f["codes"] = np.asarray(c.codes)
        f["dictionary"] = np.array(
            [bytes(data[off[i]:off[i + 1]]).decode()
             for i in range(len(off) - 1)], dtype=object)
        f["dict_sorted"] = c.dict_sorted
    elif c.is_string:
        f.update(data=np.asarray(c.data), offsets=np.asarray(c.offsets),
                 max_bytes=c.max_bytes)
    else:
        f["data"] = np.asarray(c.data)
    return f


def port_schema(schema) -> T.Schema:
    return T.Schema([T.StructField(f.name, _TYPES[f.data_type.name],
                                   f.nullable) for f in schema])


def to_port(rb: RBatch) -> "ColumnarBatch":  # noqa: F821
    live = None if rb.live is None else np.asarray(rb.live)
    return carry.batch_from_reference([ref_fields(c) for c in rb.columns],
                                      port_schema(rb.schema),
                                      int(rb.n_rows), live, device="cpu")


def table(n: int = 600, seed: int = 3) -> pa.RecordBatch:
    rng = np.random.default_rng(seed)
    a = rng.integers(-40, 40, n)
    b = np.round(rng.normal(0, 10, n), 1)
    b[rng.random(n) < 0.05] = np.nan
    b[rng.random(n) < 0.05] = 0.0
    b[rng.random(n) < 0.05] = -0.0
    d = rng.integers(9000, 9400, n).astype(np.int32)
    s = np.array(["BUILDING", "AUTOMOBILE", "MACHINERY", "ÄRGER"])[
        rng.integers(0, 4, n)]
    k = rng.integers(0, 25, n)
    return pa.RecordBatch.from_arrays([
        pa.array(a, pa.int64(), mask=rng.random(n) < 0.1),
        pa.array(b, pa.float64(), mask=rng.random(n) < 0.1),
        pa.array(d, pa.date32(), mask=rng.random(n) < 0.05),
        pa.array(s, pa.string(), mask=rng.random(n) < 0.1),
        pa.array(k, pa.int64()),
    ], names=["a", "b", "d", "s", "k"])


def both_batches(n: int = 600, seed: int = 3, lazy: bool = True):
    rb = RBatch.from_arrow(table(n, seed))
    if lazy:
        keep = np.random.default_rng(seed + 1).random(rb.capacity) < 0.8
        rb = RKR.compact(rb, jnp.asarray(keep))
    return rb, to_port(rb)


def assert_column(got, want, live, rtol: float = 0.0) -> None:
    live = np.asarray(live)
    gv, wv = got.validity.numpy()[live], np.asarray(want.validity)[live]
    np.testing.assert_array_equal(gv, wv)
    if want.is_dict:
        w = ref_fields(want)
        gl = got.dictionary[got.codes.numpy()[live][gv]]
        wl = w["dictionary"][w["codes"][live][wv]]
        np.testing.assert_array_equal(gl.astype(str), wl.astype(str))
        return
    g = got.data.numpy()[live][gv]
    w = np.asarray(want.data)[live][wv].astype(g.dtype)
    if g.dtype.kind == "f" and rtol:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0)
    elif g.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_array_equal(g[~np.isnan(g)].view(np.int64),
                                      w[~np.isnan(w)].view(np.int64))
    else:
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------
# expressions
# --------------------------------------------------------------------------


def _exprs(Pm, ARm, c, li, dtype_date):
    return {
        "eq string": Pm.EqualTo(c("s"), li("BUILDING")),
        "lt date": Pm.LessThan(c("d"), li(9204, dtype_date)),
        "gt date": Pm.GreaterThan(c("d"), li(9204, dtype_date)),
        "le/ge": Pm.And(Pm.LessThanOrEqual(c("a"), li(10)),
                        Pm.GreaterThanOrEqual(c("b"), li(-3.5))),
        "ne or": Pm.Or(Pm.NotEqual(c("a"), li(0)), Pm.IsNull(c("b"))),
        "not/isnotnull": Pm.And(Pm.Not(Pm.EqualTo(c("k"), li(3))),
                                Pm.IsNotNull(c("s"))),
        "revenue": ARm.Multiply(c("b"), ARm.Subtract(li(1.0), c("a"))),
        "add mixed": ARm.Add(c("a"), c("b")),
        "int arith": ARm.Subtract(ARm.Multiply(c("a"), c("k")), li(7)),
    }


@pytest.mark.parametrize("name", list(_exprs(P, AR, col, lit, T.DATE)))
def test_expression_matches_reference(name):
    rb, pb = both_batches()
    want_e = RL.resolve(_exprs(RP, RAR, rcol, rlit, RT.DATE)[name],
                        rb.schema).bind(rb.schema)
    got_e = L.resolve(_exprs(P, AR, col, lit, T.DATE)[name],
                      pb.schema).bind(pb.schema)
    assert got_e.data_type.name == want_e.data_type.name
    assert_column(got_e.eval_device(pb), want_e.eval_device(rb),
                  rb.row_mask())


def test_filter_compact_and_physical_match_reference():
    rb, pb = both_batches()
    cond_r = RL.resolve(RP.GreaterThan(rcol("d"), rlit(9204, RT.DATE)),
                        rb.schema).bind(rb.schema).eval_device(rb)
    cond_p = L.resolve(P.GreaterThan(col("d"), lit(9204, T.DATE)),
                       pb.schema).bind(pb.schema).eval_device(pb)
    rf = RKR.physical(RKR.compact(rb, cond_r.data & cond_r.validity))
    pf = KR.physical(KR.compact(pb, cond_p.data & cond_p.validity))
    assert int(pf.n_rows) == int(rf.n_rows)
    for g, w in zip(pf.columns, rf.columns):
        assert_column(g, w, rf.row_mask())


# --------------------------------------------------------------------------
# rowops
# --------------------------------------------------------------------------


def test_orderable_values_match_reference():
    v = np.array([np.nan, -np.inf, -1.5, -0.0, 0.0, 2.0, np.inf, -np.nan])
    got = KR.orderable_values(torch.as_tensor(v), True).numpy()
    want = np.asarray(RKR.orderable_values(jnp.asarray(v), True))
    np.testing.assert_array_equal(got, want)
    i = np.array([-5, 0, 2 ** 40], dtype=np.int64)
    np.testing.assert_array_equal(
        KR.orderable_values(torch.as_tensor(i), False).numpy(),
        np.asarray(RKR.orderable_values(jnp.asarray(i), False)))


SORTS = {
    "a asc, b desc": (["a", "b"], [True, False], [True, False]),
    "b asc nulls last": (["b"], [True], [False]),
    "s desc, d asc": (["s", "d"], [False, True], [False, True]),
}


@pytest.mark.parametrize("name", list(SORTS))
def test_sort_batch_matches_reference(name):
    names, asc, nf = SORTS[name]
    rb, pb = both_batches()
    rs = RKR.sort_batch_by_columns(rb, [rb.column(n) for n in names], asc, nf)
    ps = KR.sort_batch_by_columns(pb, [pb.column(n) for n in names], asc, nf)
    assert int(ps.n_rows) == int(rs.n_rows)
    for g, w in zip(ps.columns, rs.columns):
        assert_column(g, w, rs.row_mask())


@pytest.mark.parametrize("name,fast", [
    ("b desc fast", True), ("b desc exact", False), ("a asc, b desc", True),
    ("s desc", True)])
def test_topk_matches_reference(name, fast):
    names = {"b desc fast": ["b"], "b desc exact": ["b"],
             "a asc, b desc": ["a", "b"], "s desc": ["s"]}[name]
    asc = [n == "a" for n in names]
    nf = [n == "a" for n in names]
    rb, pb = both_batches()
    rt, rok = RKR.topk_batch_by_columns(rb, [rb.column(n) for n in names],
                                        asc, nf, 10, allow_data_fallback=fast)
    pt, pok = KR.topk_batch_by_columns(pb, [pb.column(n) for n in names],
                                       asc, nf, 10, allow_data_fallback=fast)
    assert bool(pok) == bool(rok)
    assert pt.capacity == rt.capacity and int(pt.n_rows) == int(rt.n_rows)
    for g, w in zip(pt.columns, rt.columns):
        assert_column(g, w, rt.row_mask())


# --------------------------------------------------------------------------
# grouped aggregate: dense path (mode 0) and sort path (mode 1)
# --------------------------------------------------------------------------


def _agg_inputs(batch, ones):
    a, b = batch.column("a"), batch.column("b")
    return [(b.data, b.validity, "sum"), (a.data, a.validity, "min"),
            (b.data, b.validity, "max"), (b.data, b.validity, "min"),
            (a.data, a.validity, "sum"), (ones, ones, "count")]


@pytest.mark.parametrize("keys", [["k", "d"], ["a"], ["s", "k"]])
@pytest.mark.parametrize("dense_mode", [0, 1])
@pytest.mark.parametrize("pallas", [False, True])
def test_grouped_aggregate_matches_reference(keys, dense_mode, pallas):
    rb, pb = both_batches()
    cap = rb.capacity
    ref_in = _agg_inputs(rb, jnp.ones(cap, jnp.bool_))
    ref_in[-1] = (jnp.ones(cap, jnp.int64), ref_in[-1][1], "count")
    port_in = _agg_inputs(pb, torch.ones(cap, dtype=torch.bool))
    port_in[-1] = (torch.ones(cap, dtype=torch.int64), port_in[-1][1],
                   "count")
    conf = PAL.PallasConf(enabled=pallas)
    rk, rres, rn, rlive, rfail = RKG.grouped_aggregate(
        [rb.column(k) for k in keys], rb.row_mask(), ref_in,
        dense_mode=dense_mode, pallas=conf)
    pk, pres, pn, plive, pfail = KG.grouped_aggregate(
        [pb.column(k) for k in keys], pb.row_mask(), port_in,
        dense_mode=dense_mode)
    assert bool(pfail) == bool(rfail)
    assert int(pn) == int(rn)
    live = np.asarray(rlive)
    np.testing.assert_array_equal(plive.numpy(), live)
    for g, w in zip(pk, rk):
        assert_column(g, w, live)
    for i, ((gr, gc), (wr, wc)) in enumerate(zip(pres, rres)):
        np.testing.assert_array_equal(gc.numpy()[live], np.asarray(wc)[live])
        g, w = gr.numpy()[live], np.asarray(wr)[live]
        if i == 0:  # float sum
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
        elif g.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_array_equal(g[~np.isnan(g)].view(np.int64),
                                          w[~np.isnan(w)].view(np.int64))
        else:
            np.testing.assert_array_equal(g, w)


def test_dense_aggregate_trips_on_wide_spans_like_reference():
    rb, pb = both_batches(n=300)
    # a span product of ~2**40 cannot fit the 2**21-slot table
    wide = np.arange(rb.capacity, dtype=np.int64) * (1 << 20)
    rcol_ = rb.column("k").__class__(data=jnp.asarray(wide),
                                     validity=rb.column("k").validity,
                                     dtype=RT.LONG)
    pcol_ = carry.column_from_reference(ref_fields(rcol_), T.LONG,
                                        device="cpu")
    ones_r = jnp.ones(rb.capacity, jnp.int64)
    ones_p = torch.ones(rb.capacity, dtype=torch.int64)
    rfail = RKG.grouped_aggregate(
        [rcol_, rb.column("d")], rb.row_mask(),
        [(ones_r, rb.column("k").validity, "count")], dense_mode=0)[-1]
    pfail = KG.grouped_aggregate(
        [pcol_, pb.column("d")], pb.row_mask(),
        [(ones_p, pb.column("k").validity, "count")], dense_mode=0)[-1]
    assert bool(rfail) and bool(pfail)


# --------------------------------------------------------------------------
# joins
# --------------------------------------------------------------------------


def _join_sides(dup: bool = False):
    rng = np.random.default_rng(5)
    nb, np_ = 300, 900
    bkeys = rng.permutation(1000)[:nb].astype(np.int64)
    if dup:
        bkeys[1] = bkeys[0]
    build = pa.RecordBatch.from_arrays([
        pa.array(bkeys, pa.int64(), mask=rng.random(nb) < 0.05),
        pa.array(rng.normal(size=nb), pa.float64()),
        pa.array(np.array(["x", "y", "z"])[rng.integers(0, 3, nb)])],
        names=["bk", "bv", "bs"])
    probe = pa.RecordBatch.from_arrays([
        pa.array(rng.integers(-5, 1300, np_), pa.int64(),
                 mask=rng.random(np_) < 0.05),
        pa.array(rng.integers(0, 9, np_), pa.int64())],
        names=["pk", "pv"])
    rb_b, rb_p = RBatch.from_arrow(build), RBatch.from_arrow(probe)
    rb_p = RKR.compact(rb_p, jnp.asarray(
        rng.random(rb_p.capacity) < 0.9))
    return (rb_p, rb_b), (to_port(rb_p), to_port(rb_b))


def _schema(left, right):
    return left.schema, right.schema


@pytest.mark.parametrize("mode,dup", [(1, False), (1, True), (2, False)])
def test_dense_join_matches_reference(mode, dup):
    (rp, rb), (pp, pb) = _join_sides(dup)
    if mode == 2:  # swapped: the unique side probes
        rp, rb, pp, pb = rb, rp, pb, pp
        pkn, bkn = "bk", "pk"
    else:
        pkn, bkn = "pk", "bk"
    rsch = RT.Schema(list(rp.schema) + list(rb.schema))
    psch = T.Schema(list(pp.schema) + list(pb.schema))
    if mode == 1:
        rout, rfail = RKJ.dense_join("inner", rp, rb, rp.column(pkn),
                                     rb.column(bkn), rsch)
        pout, pfail = KJ.dense_join(pp, pb, pp.column(pkn), pb.column(bkn),
                                    psch)
    else:
        rout, rfail = RKJ.dense_join_swapped(rp, rb, rp.column(pkn),
                                             rb.column(bkn), rsch)
        pout, pfail = KJ.dense_join_swapped(pp, pb, pp.column(pkn),
                                            pb.column(bkn), psch)
    assert bool(pfail) == bool(rfail) == dup
    if dup:
        return
    live = np.asarray(rout.row_mask())
    np.testing.assert_array_equal(pout.row_mask().numpy(), live)
    assert int(pout.n_rows) == int(rout.n_rows) > 0
    for g, w in zip(pout.columns, rout.columns):
        assert_column(g, w, live)


def test_binsearch_join_matches_reference():
    (rp, rb), (pp, pb) = _join_sides(dup=True)
    rlo, rcnt, rrank = RKJ.join_match_binsearch(
        rb.column("bk"), rp.column("pk"), rb.row_mask(), rp.row_mask())
    plo, pcnt, prank = KJ.join_match_binsearch(
        pb.column("bk"), pp.column("pk"), pb.row_mask(), pp.row_mask())
    np.testing.assert_array_equal(pcnt.numpy(), np.asarray(rcnt))
    usable = np.asarray(rcnt) > 0
    np.testing.assert_array_equal(plo.numpy()[usable],
                                  np.asarray(rlo)[usable])
    out_cap = 1024
    rpi, rbi, rn, rt = RKJ.expand_matches_binsearch(rlo, rcnt, rrank,
                                                    out_cap)
    ppi, pbi, pn, pt = KJ.expand_matches_binsearch(plo, pcnt, prank, out_cap)
    assert int(pn) == int(rn) and int(pt) == int(rt) > 0
    n = int(rn)
    np.testing.assert_array_equal(ppi.numpy()[:n], np.asarray(rpi)[:n])
    np.testing.assert_array_equal(pbi.numpy()[:n], np.asarray(rbi)[:n])


def test_shrink_sparse_keeps_live_rows_in_order():
    rb, pb = both_batches(n=2000)
    keep = np.zeros(rb.capacity, bool)
    keep[::17] = True
    rs = RKR.physical(RKR.compact(rb, jnp.asarray(keep)))
    ps = KR.shrink_sparse(KR.compact(pb, torch.as_tensor(keep)))
    assert ps.live is None and ps.capacity == 128
    assert int(ps.n_rows) == int(rs.n_rows)
    live = np.asarray(rs.row_mask())[:ps.capacity]
    for g, w in zip(ps.columns, rs.columns):
        assert_column(g, w.__class__(**{**w.__dict__, **{
            k: getattr(w, k)[:ps.capacity] for k in ("validity", "codes")
            if getattr(w, k) is not None}, **({} if w.is_dict else {
                "data": w.data[:ps.capacity]})}), live)
    # a dense batch comes back unchanged
    assert KR.shrink_sparse(pb) is pb


# --------------------------------------------------------------------------
# the DataFrame API: group-by with Sum and Count through both sessions
# --------------------------------------------------------------------------


def test_session_group_by_sum_count_matches_reference():
    from spark_rapids_tpu.ops import aggregates as RA
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu_torch.data.batch import HostBatch
    from spark_rapids_tpu_torch.ops import aggregates as A
    from spark_rapids_tpu_torch.session import TorchSession

    rbt = table()
    rs = TpuSession({"spark.rapids.sql.enabled": True})
    want = (rs.create_dataframe(rbt).group_by(rcol("k"))
            .agg(RA.AggregateExpression(RA.Sum(rcol("a")), "sa"),
                 RA.AggregateExpression(RA.Sum(rcol("b")), "sb"),
                 RA.AggregateExpression(RA.Count(rcol("a")), "ca"),
                 RA.AggregateExpression(RA.Count(), "n"))
            .sort(rcol("k")).collect())
    cols = {n: rbt.column(n) for n in ("k", "a", "b")}
    host = HostBatch.from_numpy(
        {n: c.fill_null(0).to_numpy() for n, c in cols.items()},
        T.Schema([T.StructField("k", T.LONG), T.StructField("a", T.LONG),
                  T.StructField("b", T.DOUBLE)]),
        {n: c.is_valid().to_numpy(zero_copy_only=False)
         for n, c in cols.items()})
    ps = TorchSession(device="cpu")
    got = (ps.create_dataframe(host).group_by(col("k"))
           .agg(A.AggregateExpression(A.Sum(col("a")), "sa"),
                A.AggregateExpression(A.Sum(col("b")), "sb"),
                A.AggregateExpression(A.Count(col("a")), "ca"),
                A.AggregateExpression(A.Count(), "n"))
           .sort(col("k")).collect())
    for name in ("k", "sa", "ca", "n"):
        w = want.column(name)
        np.testing.assert_array_equal(got.validity[name],
                                      w.is_valid().to_numpy(), err_msg=name)
        np.testing.assert_array_equal(
            got.columns[name][got.validity[name]],
            w.drop_null().to_numpy(), err_msg=name)
    # float sums: rtol 1e-12, see the module doc
    sb = want.column("sb")
    np.testing.assert_array_equal(got.validity["sb"], sb.is_valid().to_numpy())
    np.testing.assert_allclose(got.columns["sb"][got.validity["sb"]],
                               sb.drop_null().to_numpy(), rtol=1e-12, atol=0)
