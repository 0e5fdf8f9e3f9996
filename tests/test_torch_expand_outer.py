"""Rollup, cube and grouping sets (Expand + Aggregate), full and right
outer joins, and string comparisons of any layout, through
``TorchSession`` on the CPU against the JAX package's ``TpuSession``.

Grouping sets: one Expand projection per set, the absent keys null, and
Spark's grouping id (bit ``i`` set when key ``i`` is absent, the first
key the most significant) as a grouping key, kept as a column when it
is named. The keys are ints with nulls (a real null must stay apart
from the null of an absent key), dictionary strings and flat strings
(``Substring``); the answers are sorted the same way on both sides and
must be equal row for row, sums bit for bit (integer) and averages to
rtol 1e-9.

Full and right joins on one and two keys: a key in both sides,
duplicate keys on either side, null keys on either side (they match
nothing and still come out), an empty build side, an empty probe side,
and a probe side of two batches (a union). The rows and their order
must be the reference's: the probe rows in probe order, each followed
by its matches, then the unmatched build rows in build order. A right
or full join with a residual condition raises, as the reference's
planner does. ``join_match``'s build hit mask is held against the
reference's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.ops import aggregates as RA
from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops import strings as RS
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit
from spark_rapids_tpu.ops.kernels import join as RKJ
from spark_rapids_tpu.plan.logical import SortOrder as RSortOrder
from spark_rapids_tpu.session import TpuSession

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.exec import execs as E
from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops import strings as S
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.ops.kernels import join as KJ
from spark_rapids_tpu_torch.plan.logical import SortOrder
from spark_rapids_tpu_torch.session import TorchSession

WORDS = np.array(["AIR", "FOB", "MAIL", "", "REG AIR", "ÄRGER", "SHIP",
                  "RAIL"])
RTOL = 1e-9


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


def _ref_session(device: bool = True):
    """The reference's session: its device path, or its CPU oracle."""
    return TpuSession({"spark.rapids.sql.enabled": device,
                       "spark.rapids.sql.variableFloatAgg.enabled": True})


def _nullable(data, valid, name) -> list:
    ok = valid.get(name, np.ones(len(data[name]), bool))
    return [v.item() if good else None for v, good in zip(data[name], ok)]


def host_nodes_of(session, df) -> list:
    from spark_rapids_tpu_torch.plan.overrides import host_nodes
    return host_nodes(session.plan(df._plan))


def _port_rows(hb) -> dict:
    return {n: [(v.item() if hasattr(v, "item") else v) if ok else None
                for v, ok in zip(hb.columns[n], hb.validity[n])]
            for n in hb.columns}


def _ref_rows(table) -> dict:
    return {n: table.column(n).to_pylist() for n in table.column_names}


def _assert_same(got: dict, want: dict, floats=()) -> None:
    assert list(got) == list(want)
    for n, w in want.items():
        g = got[n]
        assert len(g) == len(w), (n, len(g), len(w))
        if n in floats:
            for a, b in zip(g, w):
                assert (a is None) == (b is None), n
                assert a is None or a == b or abs(a - b) <= RTOL * abs(b), \
                    (n, a, b)
        else:
            assert g == w, n


# ---- grouping sets ---------------------------------------------------------

def _facts(seed: int = 3, n: int = 400):
    """``k`` int with nulls, ``s`` dictionary strings, ``w`` (for the flat
    key ``substring(w, 1, 2)``), ``v`` int and ``x`` float values."""
    rng = np.random.default_rng(seed)
    data = {"k": rng.integers(0, 6, n).astype(np.int64),
            "s": WORDS[rng.integers(0, len(WORDS), n)],
            "w": WORDS[rng.integers(0, len(WORDS), n)],
            "v": rng.integers(-50, 50, n).astype(np.int64),
            "x": np.round(rng.uniform(-10, 10, n), 2)}
    valid = {"k": rng.random(n) > 0.1, "s": rng.random(n) > 0.1}
    return data, valid


def _port_facts(session, data, valid):
    schema = T.Schema([T.StructField(n, {"i": T.LONG, "U": T.STRING,
                                         "f": T.DOUBLE}[a.dtype.kind])
                       for n, a in data.items()])
    return session.create_dataframe(HostBatch.from_numpy(data, schema, valid))


def _ref_facts(session, data, valid):
    schema = RT.Schema([RT.StructField(n, {"i": RT.LONG, "U": RT.STRING,
                                           "f": RT.DOUBLE}[a.dtype.kind])
                        for n, a in data.items()])
    return session.create_dataframe(
        {n: [v.item() if valid.get(n, np.ones(len(a), bool))[i] else None
             for i, v in enumerate(a)] for n, a in data.items()}, schema)


#: (DataFrame method, its key columns, extra arguments) of each case; the
#: flat key is ``substring(w, 1, 2)`` named ``f``.
GROUPINGS = {
    "rollup dictionary, flat, int": ("rollup", ["s", "f", "k"], ()),
    "cube int, dictionary": ("cube", ["k", "s"], ()),
    "cube dictionary, flat": ("cube", ["s", "f"], ()),
    "grouping sets": ("grouping_sets", ["k", "s", "f"],
                      ([["k", "s"], ["f"], []],)),
    "rollup one key": ("rollup", ["s"], ()),
}
#: The grouping held against the reference's device path; the others
#: against its CPU-oracle session, whose device path takes 10-35 s a
#: case here.
DEVICE_GROUPINGS = ("rollup one key",)


def _grouped(df, method, keys, extra, gid, mods):
    Pm, Am, c, Srt, Str, li = mods
    df = df.with_column("f", Str.Substring(c("w"), li(1), li(2)))
    kwargs = {"grouping_id": "gid"} if gid else {}
    grouped = getattr(df, method)(*extra, *keys, **kwargs)
    out = grouped.agg(Am.AggregateExpression(Am.Sum(c("v")), "sv"),
                      Am.AggregateExpression(Am.Average(c("x")), "ax"),
                      Am.AggregateExpression(Am.Count(), "n"))
    order = ([Srt(c("gid"))] if gid else []) + [Srt(c(k)) for k in keys] \
        + [Srt(c("sv")), Srt(c("n"))]
    return out.sort(*order)


@pytest.mark.parametrize("gid", [False, True], ids=["no id", "grouping id"])
@pytest.mark.parametrize("case", list(GROUPINGS))
def test_grouping_sets_match_reference(case, gid):
    method, keys, extra = GROUPINGS[case]
    data, valid = _facts()
    session = TorchSession(device="cpu")
    got = _grouped(_port_facts(session, data, valid), method, keys, extra,
                   gid, (P, A, col, SortOrder, S, lit))
    plan = session.explain(got._plan)
    assert "Expand" in plan
    rs = _ref_session(case in DEVICE_GROUPINGS)
    want = _grouped(_ref_facts(rs, data, valid), method, keys, extra, gid,
                    (RP, RA, rcol, RSortOrder, RS, rlit))
    got_rows = _port_rows(got.collect())
    _assert_same(got_rows, _ref_rows(want.collect()), floats=("ax",))
    n_sets = {"rollup": len(keys) + 1, "cube": 2 ** len(keys),
              "grouping_sets": len(extra[0]) if extra else 0}[method]
    if gid:
        assert len(set(got_rows["gid"])) == n_sets


def test_grouping_id_bits_and_null_groups():
    """Spark's grouping id over (k, s): 0 for both keys, 1 for k alone,
    3 for the grand total; a real null key stays a group of its own
    beside the absent key's null."""
    data = {"k": np.array([1, 1, 2, 2], np.int64),
            "s": np.array(["a", "b", "a", "a"]),
            "w": np.array(["x", "x", "x", "x"]),
            "v": np.array([1, 2, 3, 4], np.int64),
            "x": np.array([0.5, 1.5, 2.5, 3.5])}
    valid = {"k": np.array([True, True, False, True])}
    session = TorchSession(device="cpu")
    df = _port_facts(session, data, valid).rollup(
        "k", "s", grouping_id="gid").agg(
        A.AggregateExpression(A.Sum(col("v")), "sv"))
    rows = _port_rows(df.sort(SortOrder(col("gid")), SortOrder(col("k")),
                              SortOrder(col("s"))).collect())
    assert list(zip(rows["k"], rows["s"], rows["gid"], rows["sv"])) == [
        (None, "a", 0, 3), (1, "a", 0, 1), (1, "b", 0, 2), (2, "a", 0, 4),
        (None, None, 1, 3), (1, None, 1, 3), (2, None, 1, 4),
        (None, None, 3, 10)]


def test_expand_casts_a_projection_to_its_field_type():
    """A projection whose expression differs in type from the field (an
    INT literal under a LONG field) is cast to the field's type."""
    from spark_rapids_tpu_torch.plan import logical as L
    data, valid = _facts(n=20)
    session = TorchSession(device="cpu")
    df = _port_facts(session, data, valid)
    plan = L.Expand(df._plan, [[col("v")], [lit(7)]], ["v"])
    [[a, b]] = session.plan(plan).execute(E.ExecContext(torch.device("cpu")))
    assert a.columns[0].dtype is T.LONG and b.columns[0].dtype is T.LONG
    assert b.columns[0].data.dtype == torch.int64
    assert b.columns[0].data[:20].tolist() == [7] * 20


# ---- full and right outer joins --------------------------------------------

def _join_tables(case: str, seed: int = 7):
    """Probe (``pk``, ``pk2``, ``a``) and build (``bk``, ``bk2``, ``b``)
    columns with validity for one case."""
    rng = np.random.default_rng(seed)
    n_p, n_b = 200, 90
    probe = {"pk": rng.integers(0, 60, n_p), "pk2": rng.integers(0, 3, n_p),
             "a": rng.integers(0, 1000, n_p)}
    build = {"bk": rng.integers(20, 90, n_b), "bk2": rng.integers(0, 3, n_b),
             "b": rng.integers(0, 1000, n_b)}
    if case == "unique build keys":
        build["bk"] = rng.permutation(120)[:n_b]
    pvalid = {"pk": rng.random(n_p) > 0.1, "pk2": rng.random(n_p) > 0.05}
    bvalid = {"bk": rng.random(n_b) > 0.1, "bk2": rng.random(n_b) > 0.05}
    if case == "empty build":
        build = {k: v[:0] for k, v in build.items()}
        bvalid = {k: v[:0] for k, v in bvalid.items()}
    if case == "empty probe":
        probe = {k: v[:0] for k, v in probe.items()}
        pvalid = {k: v[:0] for k, v in pvalid.items()}
    cast = {k: v.astype(np.int64) for k, v in probe.items()}, \
        {k: v.astype(np.int64) for k, v in build.items()}
    return (cast[0], pvalid), (cast[1], bvalid)


JOIN_CASES = ["duplicate keys", "unique build keys", "empty build",
              "empty probe", "probe in two batches"]


def _outer_join(left, right, how, keys, Pm, c):
    on = Pm.EqualTo(c("pk"), c("bk"))
    if keys == 2:
        on = Pm.And(on, Pm.EqualTo(c("pk2"), c("bk2")))
    return left.join(right, on=on, how=how)


def _sides(session, tables, case, make):
    (probe, pvalid), (build, bvalid) = tables
    if case == "probe in two batches":
        h = len(probe["pk"]) // 2
        first = make(session, {k: v[:h] for k, v in probe.items()},
                     {k: v[:h] for k, v in pvalid.items()})
        left = first.union(make(session, {k: v[h:] for k, v in probe.items()},
                                {k: v[h:] for k, v in pvalid.items()}))
    else:
        left = make(session, probe, pvalid)
    return left, make(session, build, bvalid)


@pytest.mark.parametrize("keys", [1, 2], ids=["one key", "two keys"])
@pytest.mark.parametrize("how", ["full", "right"])
@pytest.mark.parametrize("case", JOIN_CASES)
def test_outer_join_matches_reference(case, how, keys):
    tables = _join_tables(case)
    session = TorchSession(device="cpu")
    got = _outer_join(*_sides(session, tables, case, _port_df), how, keys,
                      P, col)
    rs = _ref_session()
    want = _outer_join(*_sides(rs, tables, case, _ref_df), how, keys, RP,
                       rcol)
    got_rows = _port_rows(got.collect())
    want_rows = _ref_rows(want.collect())
    _assert_same(got_rows, want_rows)
    if case == "duplicate keys":
        # unmatched build rows came out with a null probe side, and a full
        # join's unmatched probe rows with a null build side
        assert None in got_rows["a"] and None in got_rows["pk"]
        assert (None in got_rows["b"]) == (how == "full")


def test_full_join_emits_unmatched_build_rows_last():
    """The left join's rows in probe order, then the build rows that no
    probe row matched (null keys among them), in build order."""
    probe = ({"pk": np.array([3, 1, 3, 7], np.int64),
              "a": np.array([10, 11, 12, 13], np.int64)},
             {"pk": np.array([True, True, True, False])})
    build = ({"bk": np.array([5, 3, 9, 3, 1], np.int64),
              "b": np.array([20, 21, 22, 23, 24], np.int64)},
             {"bk": np.array([True, True, True, True, False])})
    session = TorchSession(device="cpu")
    df = _port_df(session, *probe).join(
        _port_df(session, *build), on=P.EqualTo(col("pk"), col("bk")),
        how="full")
    rows = _port_rows(df.collect())
    assert list(zip(rows["a"], rows["b"])) == [
        (10, 21), (10, 23), (11, None), (12, 21), (12, 23), (13, None),
        (None, 20), (None, 22), (None, 24)]
    assert session.last_query.site_kinds == ["join"]


@pytest.mark.parametrize("how", ["full", "right"])
def test_outer_join_with_a_residual_raises(how):
    (probe, pvalid), (build, bvalid) = _join_tables("duplicate keys")
    session = TorchSession(device="cpu")
    df = _port_df(session, probe, pvalid).join(
        _port_df(session, build, bvalid),
        on=P.And(P.EqualTo(col("pk"), col("bk")),
                 P.LessThan(col("a"), col("b"))), how=how)
    # the residual applies while rows pair: the host's equi join now,
    # held against the pairs by brute force
    got = _port_rows(df.collect())
    pk, a = _nullable(probe, pvalid, "pk"), probe["a"].tolist()
    bk, b = _nullable(build, bvalid, "bk"), build["b"].tolist()
    pairs = [(i, j) for i in range(len(pk)) for j in range(len(bk))
             if pk[i] is not None and pk[i] == bk[j] and a[i] < b[j]]
    rows = [(a[i], b[j]) for i, j in pairs]
    hit_b = {j for _, j in pairs}
    rows += [(None, b[j]) for j in range(len(bk)) if j not in hit_b]
    if how == "full":
        hit_p = {i for i, _ in pairs}
        rows += [(a[i], None) for i in range(len(pk)) if i not in hit_p]
    assert sorted(zip(got["a"], got["b"]), key=repr) == sorted(rows, key=repr)
    assert any(n == "CpuJoinExec" for n in host_nodes_of(session, df))
    with pytest.raises(NotImplementedError, match=f"non-equi {how} outer"):
        _port_df(session, probe, pvalid).join(
            _port_df(session, build, bvalid),
            on=P.LessThan(col("a"), col("b")), how=how)


def test_join_match_build_hits_match_reference():
    rng = np.random.default_rng(4)
    n_b, n_p = 150, 260
    bk = rng.integers(0, 80, n_b).astype(np.int64)
    pk = rng.integers(40, 140, n_p).astype(np.int64)
    bv, pv = rng.random(n_b) > 0.1, rng.random(n_p) > 0.1
    live_b, live_p = rng.random(n_b) > 0.1, rng.random(n_p) > 0.1
    from spark_rapids_tpu.data.column import DeviceColumn as RDC
    from spark_rapids_tpu_torch.data.column import DeviceColumn
    lo, counts, at_rank, hits = KJ.join_match(
        [DeviceColumn(torch.as_tensor(bk), torch.as_tensor(bv), T.LONG)],
        [DeviceColumn(torch.as_tensor(pk), torch.as_tensor(pv), T.LONG)],
        torch.as_tensor(live_b), torch.as_tensor(live_p),
        need_build_hits=True)
    _, rcounts, _, rhits = RKJ.join_match(
        [RDC(jnp.asarray(bk), jnp.asarray(bv), RT.LONG)],
        [RDC(jnp.asarray(pk), jnp.asarray(pv), RT.LONG)],
        jnp.asarray(live_b), jnp.asarray(live_p), need_build_hits=True)
    np.testing.assert_array_equal(hits.numpy(), np.asarray(rhits))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rcounts))
    usable_p = pv & live_p
    want = bv & live_b & np.isin(bk, pk[usable_p])
    np.testing.assert_array_equal(hits.numpy(), want)
    assert hits.any() and (~hits.numpy() & bv & live_b).any()


# ---- string comparisons of any layout --------------------------------------

COMPARISONS = ["EqualTo", "NotEqual", "LessThan", "LessThanOrEqual",
               "GreaterThan", "GreaterThanOrEqual"]


@pytest.mark.parametrize("layout", ["flat, flat", "flat, dictionary",
                                    "dictionary, dictionary"])
@pytest.mark.parametrize("op", COMPARISONS)
def test_string_comparison_matches_reference(op, layout):
    """A flat side (``substring``) compares row by row over the char
    matrices; so must two dictionaries, when forced past the entry-pair
    limit, and every answer is the reference's."""
    rng = np.random.default_rng(9)
    n = 300
    words = np.array(["AIRBUS", "AIR", "", "A", "ÄRGER", "ZULU", "AIRS",
                      "ÄR", "B"])
    data = {"l": words[rng.integers(0, len(words), n)],
            "r": words[rng.integers(0, len(words), n)]}
    valid = {"l": rng.random(n) > 0.1, "r": rng.random(n) > 0.1}

    def side(c, Str, li, name, flat):
        return Str.Substring(c(name), li(1), li(4)) if flat else c(name)
    lf, rf = {"flat, flat": (True, True), "flat, dictionary": (True, False),
              "dictionary, dictionary": (False, False)}[layout]
    session = TorchSession(device="cpu")
    df = _port_df(session, data, valid).select(getattr(P, op)(
        side(col, S, lit, "l", lf), side(col, S, lit, "r", rf)).alias("c"))
    rs = _ref_session()
    rdf = _ref_df(rs, data, valid).select(getattr(RP, op)(
        side(rcol, RS, rlit, "l", lf), side(rcol, RS, rlit, "r", rf)
    ).alias("c"))
    want = _ref_rows(rdf.collect())
    assert _port_rows(df.collect()) == want
    if layout == "dictionary, dictionary":
        saved = P._MAX_DICT_PAIRS
        P._MAX_DICT_PAIRS = 0
        try:
            assert _port_rows(df.collect()) == want
        finally:
            P._MAX_DICT_PAIRS = saved


def test_expand_batches_share_each_key_dictionary():
    """The absent key's null column takes the real key's dictionary, so
    the aggregate's merge concatenates one dictionary: its codes and
    sorted order carry over (no appended copies)."""
    from spark_rapids_tpu_torch.ops.kernels import concat as KC
    data, valid = _facts(n=50)
    session = TorchSession(device="cpu")
    df = _port_facts(session, data, valid)
    plan = df.rollup("s", "k")._agg_grouping_sets([])._plan
    expand = plan.children[0].children[0]
    assert type(expand).__name__ == "Expand"
    batches = [b for part in session.plan(expand).execute(
        E.ExecContext(torch.device("cpu"))) for b in part]
    assert len(batches) == 3
    dicts = {id(b.columns[0].dictionary) for b in batches}
    assert len(dicts) == 1 and batches[0].columns[0].dict_sorted
    assert not batches[2].columns[0].validity.any()
    cat = KC.concat_batches(batches, 256)
    s = cat.columns[0]
    assert s.dictionary is batches[0].columns[0].dictionary and s.dict_sorted
    host = [s.dictionary[c] if ok else None
            for c, ok in zip(s.codes.tolist(), s.validity.tolist())]
    want = []
    for b in batches:
        c = b.columns[0]
        rows = b.row_mask().tolist()
        want += [(c.dictionary[x] if ok else None)
                 for x, ok, r in zip(c.codes.tolist(), c.validity.tolist(),
                                     rows) if r]
    assert host[:len(want)] == want
