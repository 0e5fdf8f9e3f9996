"""Equi joins with a residual condition, and ``union``, through
``TorchSession`` on the CPU against the JAX package's ``TpuSession``.

A residual (the join condition's terms that are not ``left = right``)
rides on inner, left, left semi and left anti joins. The reference
filters an inner join's output by it and plans every other type as a
nested-loop join on the CPU; the port keeps the equi keys, expands each
probe row's matches into pairs, evaluates the residual on them and
reduces per probe row (``exec/execs.py join_residual``). Rows and their
order must be the reference's, with repeated build keys, unique build
keys (the port's direct-address inner join, filtered), two keys, an
expression key, a string residual, null keys, and probe rows whose keys
match but whose every pair fails the residual.

``union`` relabels both sides to one schema (nullability ORed over the
children); dictionaries from both sides meet in the consumer.
"""

import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.ops import aggregates as RA
from spark_rapids_tpu.ops import arithmetic as RAR
from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit
from spark_rapids_tpu.plan.logical import SortOrder as RSortOrder
from spark_rapids_tpu.session import TpuSession

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.exec import execs as E
from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops import arithmetic as AR
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.ops.kernels import join as KJ
from spark_rapids_tpu_torch.plan.logical import SortOrder
from spark_rapids_tpu_torch.session import TorchSession

WORDS = np.array(["AIR", "FOB", "MAIL", "", "REG AIR", "ÄRGER", "SHIP"])
HOWS = ["inner", "left", "left_semi", "left_anti"]


def _tables(unique_build: bool, seed: int = 5):
    """Probe (``pk``, ``pk2``, ``a``, ``ps``) and build (``bk``, ``bk2``,
    ``b``, ``bs``) columns with validity. Probe row 0 matches build keys
    but its ``a`` fails every ``a < b`` / ``a <= b`` residual."""
    rng = np.random.default_rng(seed)
    n_p, n_b = 300, 120
    bk = rng.permutation(200)[:n_b] if unique_build \
        else rng.integers(0, 60, n_b)
    probe = {"pk": rng.integers(0, 70, n_p), "pk2": rng.integers(0, 3, n_p),
             "a": rng.integers(0, 100, n_p), "ps": WORDS[rng.integers(0, 7,
                                                                     n_p)]}
    build = {"bk": bk, "bk2": rng.integers(0, 3, n_b),
             "b": rng.integers(0, 100, n_b), "bs": WORDS[rng.integers(1, 7,
                                                                     n_b)]}
    probe["pk"][0] = bk[0]
    probe["a"][0] = 10 ** 6
    pvalid = {"pk": rng.random(n_p) > 0.08, "ps": rng.random(n_p) > 0.08}
    bvalid = {"bk": rng.random(n_b) > (0 if unique_build else 0.08)}
    pvalid["pk"][0] = bvalid["bk"][0] = True
    for d in (probe, build):
        for k, v in d.items():
            if v.dtype.kind == "i":
                d[k] = v.astype(np.int64)
    return (probe, pvalid), (build, bvalid)


def _port_df(session, data, valid):
    schema = T.Schema([T.StructField(n, T.STRING if a.dtype.kind == "U"
                                     else T.LONG) for n, a in data.items()])
    return session.create_dataframe(HostBatch.from_numpy(data, schema, valid))


def _ref_df(session, data, valid):
    schema = RT.Schema([RT.StructField(n, RT.STRING if a.dtype.kind == "U"
                                       else RT.LONG)
                        for n, a in data.items()])
    return session.create_dataframe(
        {n: [v.item() if valid.get(n, np.ones(len(a), bool))[i] else None
             for i, v in enumerate(a)] for n, a in data.items()}, schema)


CASES = {
    "repeated keys, int residual": (False, lambda Pm, ARm, c, li: Pm.And(
        Pm.EqualTo(c("pk"), c("bk")), Pm.LessThan(c("a"), c("b")))),
    "repeated keys, string residual": (False, lambda Pm, ARm, c, li: Pm.And(
        Pm.EqualTo(c("pk"), c("bk")), Pm.NotEqual(c("ps"), c("bs")))),
    "unique keys, band": (True, lambda Pm, ARm, c, li: Pm.And(
        Pm.EqualTo(c("pk"), c("bk")),
        Pm.And(Pm.LessThanOrEqual(c("a"), c("b")),
               Pm.GreaterThan(c("a"), ARm.Subtract(c("b"), li(40)))))),
    "two keys, residual": (False, lambda Pm, ARm, c, li: Pm.And(
        Pm.EqualTo(c("pk"), c("bk")),
        Pm.And(Pm.EqualTo(c("pk2"), c("bk2")),
               Pm.LessThan(c("a"), c("b"))))),
    "expression key, residual": (False, lambda Pm, ARm, c, li: Pm.And(
        Pm.EqualTo(ARm.Add(c("pk"), li(1)), c("bk")),
        Pm.LessThanOrEqual(c("a"), c("b")))),
}


def _rows(columns: dict) -> list:
    return list(zip(*columns.values()))


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("case", list(CASES))
def test_residual_join_matches_reference(case, how):
    unique, on = CASES[case]
    (probe, pvalid), (build, bvalid) = _tables(unique)
    session = TorchSession(device="cpu")
    df = _port_df(session, probe, pvalid).join(
        _port_df(session, build, bvalid), on=on(P, AR, col, lit), how=how)
    plan = session.explain(df._plan)
    assert "NestedLoopJoin" not in plan and "ShuffledHashJoin" in plan
    got = df.collect()
    info = session.last_query

    rs = TpuSession({"spark.rapids.sql.enabled": True})
    want = _ref_df(rs, probe, pvalid).join(
        _ref_df(rs, build, bvalid), on=on(RP, RAR, rcol, rlit),
        how=how).collect()
    got_cols = {n: [(v.item() if hasattr(v, "item") else v) if ok else None
                    for v, ok in zip(got.columns[n], got.validity[n])]
                for n in got.columns}
    want_cols = {n: want.column(n).to_pylist() for n in want.column_names}
    assert list(got_cols) == list(want_cols)
    assert _rows(got_cols) == _rows(want_cols)
    n = len(_rows(want_cols))
    assert 0 < n < len(probe["pk"]) * 4
    if how != "inner" or not unique:
        # the pairs the equi keys gave, before the residual
        assert info.counters["ShuffledHashJoinExec.pairs"] > 0
    # probe row 0 matches build keys, but none of its pairs passes an
    # ``a``-residual
    if "string" not in case and how != "inner":
        kept = 10 ** 6 in got_cols["a"]
        assert kept == (how != "left_semi")
        if how == "left":
            assert got_cols["bk"][got_cols["a"].index(10 ** 6)] is None


def test_inner_residual_filters_the_direct_address_output():
    """Unique build keys keep the inner join on the build table (mode 1);
    the residual filters its output, and the result is the exact path's
    bit for bit."""
    unique, on = CASES["unique keys, band"]
    (probe, pvalid), (build, bvalid) = _tables(unique)
    session = TorchSession(device="cpu")
    df = _port_df(session, probe, pvalid).join(
        _port_df(session, build, bvalid), on=on(P, AR, col, lit))
    calls = []
    dense = KJ.dense_join
    KJ.dense_join = lambda *a, **k: calls.append(1) or dense(*a, **k)
    try:
        got = df.collect()
    finally:
        KJ.dense_join = dense
    assert calls and session.last_query.attempts == 1
    exact = E.collect(session.plan(df._plan),
                      E.ExecContext(torch.device("cpu"), {0: 2}))
    for name in got.columns:
        np.testing.assert_array_equal(got.columns[name], exact.columns[name])
        np.testing.assert_array_equal(got.validity[name],
                                      exact.validity[name])


def test_residual_join_refuses_the_mesh():
    from spark_rapids_tpu_torch.exec import mesh as MX
    unique, on = CASES["repeated keys, int residual"]
    (probe, pvalid), (build, bvalid) = _tables(unique)
    session = TorchSession(device="cpu")
    df = _port_df(session, probe, pvalid).join(
        _port_df(session, build, bvalid), on=on(P, AR, col, lit),
        how="left_semi")
    assert not MX.mesh_capable(session.plan(df._plan))


# --------------------------------------------------------------------------
# union
# --------------------------------------------------------------------------


def _union_sides(rng):
    """Two sides with one column type each but different nullability and
    different dictionaries: left ``k`` never null, ``s`` over the first
    words; right ``k`` with nulls, ``s`` over the last."""
    n1, n2 = 90, 130
    left = ({"k": rng.integers(0, 20, n1).astype(np.int64),
             "s": WORDS[rng.integers(0, 4, n1)],
             "v": rng.normal(0, 1, n1)}, {})
    right = ({"k": rng.integers(10, 30, n2).astype(np.int64),
              "s": WORDS[rng.integers(3, 7, n2)],
              "v": rng.normal(0, 1, n2)},
             {"k": rng.random(n2) > 0.1, "s": rng.random(n2) > 0.1})
    return left, right


def _frames(session, sides, ref: bool):
    out = []
    for (data, valid), nullable in zip(sides, (False, True)):
        if ref:
            schema = RT.Schema([RT.StructField(n, t, nullable) for n, t in
                                (("k", RT.LONG), ("s", RT.STRING),
                                 ("v", RT.DOUBLE))])
            out.append(session.create_dataframe(
                {n: [v.item() if valid.get(n, np.ones(len(a), bool))[i]
                     else None for i, v in enumerate(a)]
                 for n, a in data.items()}, schema))
        else:
            schema = T.Schema([T.StructField(n, t, nullable) for n, t in
                               (("k", T.LONG), ("s", T.STRING),
                                ("v", T.DOUBLE))])
            out.append(session.create_dataframe(
                HostBatch.from_numpy(data, schema, valid)))
    return out


UNIONS = {
    "rows": lambda df, m, c, li, so: df,
    "filtered": lambda df, m, c, li, so: df.where(
        m[0].GreaterThan(c("k"), li(12))),
    "grouped by string": lambda df, m, c, li, so: df.group_by(c("s")).agg(
        m[1].AggregateExpression(m[1].Count(), "n"),
        m[1].AggregateExpression(m[1].Sum(c("k")), "sk")).sort(so(c("s"))),
    "distinct": lambda df, m, c, li, so: df.select(c("s"), c("k"))
    .distinct().sort(so(c("s")), so(c("k"))),
}


@pytest.mark.parametrize("shape", list(UNIONS))
def test_union_matches_reference(shape):
    sides = _union_sides(np.random.default_rng(9))
    session = TorchSession(device="cpu")
    a, b = _frames(session, sides, ref=False)
    u = a.union(b)
    assert [f.nullable for f in u.schema] == [True, True, True]
    assert [f.nullable for f in a.schema] == [False, False, False]
    got = UNIONS[shape](u, (P, A), col, lit, SortOrder).collect()
    rs = TpuSession({"spark.rapids.sql.enabled": True,
                     "spark.rapids.sql.variableFloatAgg.enabled": True})
    ra, rb = _frames(rs, sides, ref=True)
    want = UNIONS[shape](ra.union(rb), (RP, RA), rcol, rlit,
                         RSortOrder).collect()
    got_cols = {n: [(v.item() if hasattr(v, "item") else v) if ok else None
                    for v, ok in zip(got.columns[n], got.validity[n])]
                for n in got.columns}
    want_cols = {n: want.column(n).to_pylist() for n in want.column_names}
    assert list(got_cols) == list(want_cols)
    assert _rows(got_cols) == _rows(want_cols)
    assert len(_rows(got_cols)) > 0


def test_union_refuses_mismatched_types():
    session = TorchSession(device="cpu")
    a = session.create_dataframe({"k": np.arange(3, dtype=np.int64)})
    b = session.create_dataframe({"k": np.arange(3, dtype=np.float64)})
    with pytest.raises(TypeError, match="matching column types"):
        a.union(b)
