"""The dictionary and global aggregates, the semi and anti joins and the
cross join against the JAX package, on carried column states (see
``tests/test_torch_ops.py``) or through both sessions.

Counts, codes, validity and integer results must be equal; float sums
are held to rtol 1e-12 (both packages add in row order on the CPU, the
bound leaves room for the association of a scatter).
"""

import numpy as np
import pyarrow as pa
import pytest

import jax.numpy as jnp
import torch

from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit
from spark_rapids_tpu.ops.kernels import groupby as RKG
from spark_rapids_tpu.ops.kernels import join as RKJ
from spark_rapids_tpu.session import TpuSession

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.exec import execs as E
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.ops.kernels import groupby as KG
from spark_rapids_tpu_torch.ops.kernels import join as KJ
from spark_rapids_tpu_torch.session import TorchSession
from test_torch_ops import _join_sides, assert_column, both_batches


def _inputs(batch, ones_r, ones_p, port: bool):
    a, b = batch.column("a"), batch.column("b")
    ones = ones_p if port else ones_r
    return [(b.data, b.validity, "sum"), (a.data, a.validity, "min"),
            (b.data, b.validity, "max"), (a.data, a.validity, "sum"),
            (b.data, b.validity, "first"), (a.data, a.validity, "last"),
            (ones, ones.bool() if port else ones.astype(bool), "count")]


def _sum_count_inputs(batch, ones_r, ones_p, port: bool):
    return [x for x in _inputs(batch, ones_r, ones_p, port)
            if x[2] in ("sum", "count")]


def _assert_results(pres, rres, live_p, live_r) -> None:
    for i, ((gr, gc), (wr, wc)) in enumerate(zip(pres, rres)):
        gc, wc = gc.numpy()[live_p], np.asarray(wc)[live_r]
        np.testing.assert_array_equal(gc, wc)
        g, w = gr.numpy()[live_p], np.asarray(wr)[live_r]
        ok = gc > 0
        if i == 0:  # float sum
            np.testing.assert_allclose(g[ok], w[ok], rtol=1e-12, atol=0)
        elif g.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(g[ok]), np.isnan(w[ok]))
            np.testing.assert_array_equal(g[ok][~np.isnan(g[ok])],
                                          w[ok][~np.isnan(w[ok])])
        else:
            np.testing.assert_array_equal(g[ok], w[ok])


@pytest.mark.parametrize("lazy", [False, True])
def test_dictionary_aggregate_matches_reference(lazy):
    rb, pb = both_batches(lazy=lazy)
    cap = rb.capacity
    ones_r, ones_p = jnp.ones(cap, jnp.int64), torch.ones(cap,
                                                          dtype=torch.int64)
    rk, rres, rn, rlive, rfail = RKG.grouped_aggregate(
        [rb.column("s")], rb.row_mask(), _inputs(rb, ones_r, ones_p, False))
    pk, pres, pn, plive, pfail = KG.grouped_aggregate(
        [pb.column("s")], pb.row_mask(), _inputs(pb, ones_r, ones_p, True))
    assert rfail is False and pfail is False
    assert int(pn) == int(rn) == 5  # four words and the null group
    live = np.asarray(rlive)
    assert plive.shape[0] == live.shape[0] == 128
    np.testing.assert_array_equal(plive.numpy(), live)
    assert_column(pk[0], rk[0], live)
    _assert_results(pres, rres, live, live)


@pytest.mark.parametrize("lazy", [False, True])
def test_global_aggregate_matches_reference(lazy):
    rb, pb = both_batches(lazy=lazy)
    cap = rb.capacity
    ones_r, ones_p = jnp.ones(cap, jnp.int64), torch.ones(cap,
                                                          dtype=torch.int64)
    # the buffers Sum, Count and Average give it
    rk, rres, rn, rlive = RKG.global_aggregate(
        cap, rb.row_mask(), _sum_count_inputs(rb, ones_r, ones_p, False))
    pk, pres, pn, plive = KG.global_aggregate(
        cap, pb.row_mask(), _sum_count_inputs(pb, ones_r, ones_p, True))
    assert rk == pk == [] and int(pn) == int(rn) == 1
    # one live group in row 0; the port keeps it at capacity 128
    assert plive.shape[0] == 128 and plive.numpy().tolist() == \
        [True] + [False] * 127
    _assert_results(pres, rres, plive.numpy(), np.asarray(rlive))


def test_global_aggregate_of_nothing_is_one_empty_group():
    _, pb = both_batches()
    none = torch.zeros(pb.capacity, dtype=torch.bool)
    b = pb.column("b")
    _, res, n, live = KG.global_aggregate(
        pb.capacity, none, [(b.data, b.validity, "sum"),
                            (b.data, b.validity, "count")])
    assert int(n) == 1 and bool(live[0])
    assert int(res[0][1][0]) == 0 and int(res[1][0][0]) == 0


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("jt", ["left_semi", "left_anti"])
def test_semi_anti_dense_join_matches_reference(jt, dup):
    (rp, rb), (pp, pb) = _join_sides(dup)
    rout, rfail = RKJ.dense_join(jt, rp, rb, rp.column("pk"),
                                 rb.column("bk"), rp.schema)
    pout, pfail = KJ.dense_join(pp, pb, pp.column("pk"), pb.column("bk"),
                                pp.schema, jt=jt)
    # duplicates do not trip a membership test
    assert not bool(rfail) and not bool(pfail)
    live = np.asarray(rout.row_mask())
    np.testing.assert_array_equal(pout.row_mask().numpy(), live)
    assert int(pout.n_rows) == int(rout.n_rows) > 0
    for g, w in zip(pout.columns, rout.columns):
        assert_column(g, w, live)


@pytest.mark.parametrize("jt", ["left_semi", "left_anti"])
def test_semi_anti_exact_path_matches_dense_path(jt):
    """Mode 3 (the binary-search path) keeps the rows mode 1 keeps."""
    (_, _), (pp, pb) = _join_sides(dup=True)
    schema = pp.schema
    join = E.ShuffledHashJoinExec(E.DeviceSourceExec(pp),
                                  E.DeviceSourceExec(pb), jt, [col("pk")],
                                  [col("bk")], schema)
    dense = join.execute(E.ExecContext(torch.device("cpu")))
    exact = join.execute(E.ExecContext(torch.device("cpu"), {0: 2}))
    np.testing.assert_array_equal(dense.row_mask().numpy(),
                                  exact.row_mask().numpy())
    assert int(dense.n_rows) == int(exact.n_rows) > 0


def _cross_tables():
    rng = np.random.default_rng(12)
    left = pa.RecordBatch.from_arrays([
        pa.array(rng.integers(0, 100, 300), pa.int64()),
        pa.array(np.round(rng.normal(size=300), 2), pa.float64())],
        names=["a", "x"])
    right = pa.RecordBatch.from_arrays([
        pa.array(rng.integers(0, 100, 6), pa.int64()),
        pa.array(np.array(["p", "q", "r", "s", "t", "u"]), pa.string())],
        names=["b", "tag"])
    return left, right


def _port_df(session, rb: pa.RecordBatch):
    cols = {n: rb.column(n).to_numpy(zero_copy_only=False)
            for n in rb.schema.names}
    return session.create_dataframe(HostBatch.from_numpy(cols))


@pytest.mark.parametrize("case", ["plain", "condition", "filtered build"])
def test_cross_join_matches_reference(case):
    left, right = _cross_tables()
    rs = TpuSession({"spark.rapids.sql.enabled": True})
    ps = TorchSession(device="cpu")
    rl, rr = rs.create_dataframe(left), rs.create_dataframe(right)
    pl, pr = _port_df(ps, left), _port_df(ps, right)
    if case == "filtered build":
        rr = rr.where(RP.GreaterThan(rcol("b"), rlit(40)))
        pr = pr.where(P.GreaterThan(col("b"), lit(40)))
    if case == "condition":
        want = rl.join(rr, on=RP.LessThan(rcol("a"), rcol("b"))).collect()
        got = pl.join(pr, on=P.LessThan(col("a"), col("b"))).collect()
    else:
        want = rl.cross_join(rr).collect()
        got = pl.cross_join(pr).collect()
    assert len(got.columns["a"]) == want.num_rows > 0
    for name in ("a", "x", "b"):
        np.testing.assert_array_equal(got.columns[name],
                                      want.column(name).to_numpy(),
                                      err_msg=name)
    np.testing.assert_array_equal(got.columns["tag"].astype(str),
                                  np.array(want.column("tag").to_pylist()))


def test_cross_join_grid_is_probe_by_live_build_rows():
    left, right = _cross_tables()
    ps = TorchSession(device="cpu")
    pl = _port_df(ps, left)
    pr = _port_df(ps, right).where(P.GreaterThan(col("b"), lit(40)))
    n_b = int((right.column("b").to_numpy() > 40).sum())
    plan = ps.plan(pl.cross_join(pr)._plan)
    out = plan.execute(E.ExecContext(torch.device("cpu")))
    assert out.capacity == max(128, 1 << (512 * n_b - 1).bit_length())
    assert int(out.n_rows) == 300 * n_b
    assert T.STRING is out.schema["tag"].data_type
