"""Generate (``explode``, ``posexplode`` and their ``_outer`` forms)
through ``TorchSession`` on the CPU against the JAX package's
``TpuSession`` device path, on the same seeded inputs, row for row.

As the reference's ``tests/test_complex_types.py TestGenerate``: each
``outer`` x ``pos`` form over arrays with null and empty rows and null
elements, random arrays, explode then aggregate, the array column kept
beside its elements; then the chip script's shapes at test size: the
posexplode of an ``array(...)`` built in the query, repeating a flat
string parent, and an uploaded per-key array joined to a fact table and
``explode_outer``-ed. Tiling (``GenerateExec.TILE_LANES``, cut here so
a small batch takes several tiles) gives the untiled rows, and a flat
string parent's payload is sized from its longest gathered row.
"""

import numpy as np
import pytest

from spark_rapids_tpu.ops import aggregates as RA
from spark_rapids_tpu.ops import complex as RCPX
from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops import strings as RS
from spark_rapids_tpu.ops.cast import Cast as RCast
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec import execs as E
from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops import complex as CPX
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops import strings as S
from spark_rapids_tpu_torch.ops.cast import Cast
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.ops.kernels import rowops as KR

from test_torch_complex import (STRUCT_AB, check_same, frames, rand_arrays,
                                rand_frames, rand_structs, small)


def _cols(pos: bool, c):
    return [c("k"), c("pos"), c("x")] if pos else [c("k"), c("x")]


@pytest.mark.parametrize("outer", [False, True])
@pytest.mark.parametrize("pos", [False, True])
def test_explode(outer, pos):
    pdf, rdf = small()
    check_same(
        pdf.explode(col("arr"), name="x", outer=outer, pos=pos).select(
            *_cols(pos, col)),
        rdf.explode(rcol("arr"), name="x", outer=outer, pos=pos).select(
            *_cols(pos, rcol)))


@pytest.mark.parametrize("outer", [False, True])
def test_explode_random(outer):
    pdf, rdf = rand_frames(n=300, seed=11)
    check_same(pdf.explode(col("arr"), name="x", outer=outer).select(
                   col("k"), col("x")),
               rdf.explode(rcol("arr"), name="x", outer=outer).select(
                   rcol("k"), rcol("x")))


def test_explode_then_aggregate():
    pdf, rdf = rand_frames(n=300, seed=12)
    check_same(
        pdf.explode(col("arr"), name="x").group_by(col("k")).agg(
            A.AggregateExpression(A.Sum(col("x")), "sx"),
            A.AggregateExpression(A.Count(), "c")),
        rdf.explode(rcol("arr"), name="x").group_by(rcol("k")).agg(
            RA.AggregateExpression(RA.Sum(rcol("x")), "sx"),
            RA.AggregateExpression(RA.Count(), "c")), ordered=False)


def test_explode_keeps_array_column():
    pdf, rdf = small()
    check_same(pdf.explode(col("arr"), name="x"),
               rdf.explode(rcol("arr"), name="x"))


def test_explode_after_filter():
    """A lazily filtered batch is made physical first (explode liveness
    is positional)."""
    pdf, rdf = rand_frames(n=300, seed=13)
    check_same(
        pdf.where(P.GreaterThan(col("k"), lit(0))).explode(
            col("arr"), name="x", pos=True).select(col("k"), col("pos"),
                                                   col("x")),
        rdf.where(rcol("k") > 0).explode(rcol("arr"), name="x",
                                         pos=True).select(
            rcol("k"), rcol("pos"), rcol("x")))


def _fact(n: int, seed: int):
    """A fact-like frame: key ``k``, four doubles, a flat string ``tag``
    (built in the query, as the chip cell's) and a struct ``st``."""
    rng = np.random.default_rng(seed)
    schema = T.Schema([T.StructField("k", T.LONG, False),
                       T.StructField("w", T.DOUBLE),
                       T.StructField("p", T.DOUBLE),
                       T.StructField("st", STRUCT_AB)])
    w = np.round(rng.uniform(0, 100, n), 2).tolist()
    p = [None if rng.random() < 0.05 else float(v)
         for v in np.round(rng.uniform(0, 100, n), 2)]
    return frames({"k": rng.integers(0, 40, n).tolist(), "w": w, "p": p,
                   "st": rand_structs(rng, n)}, schema)


def _tagged(df, M, S_, CA, c, l, ty):
    tag = S_.ConcatStrings(CA(c("k"), ty.STRING), l("-"),
                           M.GetStructField(c("st"), "b"))
    return df.select(c("k"), c("w"), c("p"), c("st"),
                     S_.Substring(tag, l(1), l(12)).alias("tag"))


@pytest.mark.parametrize("tiles", [False, True])
def test_posexplode_built_array_with_flat_parent(tiles, monkeypatch):
    """``posexplode(array(w, p, w, p))`` repeating a flat string parent and
    a struct, grouped by (pos, k): sum, count, max(tag). With ``tiles``
    the lane bound is cut to 512, so the 2^9-row batch of width 4 takes
    4 tiles."""
    if tiles:
        monkeypatch.setattr(E.GenerateExec, "TILE_LANES", 512)
    pdf, rdf = _fact(400, 14)
    p = _tagged(pdf, CPX, S, Cast, col, lit, T).with_column(
        "arr", CPX.array(col("w"), col("p"), col("w"), col("p")))
    r = _tagged(rdf, RCPX, RS, RCast, rcol, rlit, RT).with_column(
        "arr", RCPX.array(rcol("w"), rcol("p"), rcol("w"), rcol("p")))
    pe = p.explode(col("arr"), name="x", pos=True)
    re_ = r.explode(rcol("arr"), name="x", pos=True)
    check_same(pe.select(col("k"), col("tag"), col("st"), col("pos"),
                         col("x")),
               re_.select(rcol("k"), rcol("tag"), rcol("st"), rcol("pos"),
                          rcol("x")))
    # the grouped reduction against the reference's exploded rows (its
    # device path fails on a string max)
    got = pe.group_by(col("pos"), col("k")).agg(
        A.AggregateExpression(A.Sum(col("x")), "s"),
        A.AggregateExpression(A.Count(col("x")), "n"),
        A.AggregateExpression(A.Max(col("tag")), "mx")).collect()
    rows = sorted(zip(*[got.columns[c].tolist() for c in
                        ("pos", "k", "s", "n", "mx")]))
    want = re_.select(rcol("pos"), rcol("k"), rcol("x"),
                      rcol("tag")).collect().to_pydict()
    groups = {}
    for pos, k, x, tag in zip(want["pos"], want["k"], want["x"],
                              want["tag"]):
        g = groups.setdefault((pos, k), [0.0, 0, None])
        if x is not None:
            g[0] += x
            g[1] += 1
        if tag is not None and (g[2] is None or tag.encode() > g[2].encode()):
            g[2] = tag
    assert [r[:2] for r in rows] == sorted(groups)
    for pos, k, s, n, mx in rows:
        want_s, want_n, want_mx = groups[(pos, k)]
        assert n == want_n and mx == want_mx
        assert abs(s - want_s) <= 1e-9 * max(abs(want_s), 1.0)


def test_flat_parent_payload_is_sized_by_its_rows():
    """The explode's flat ``tag`` payload holds ``lanes x`` its longest
    gathered row rounded up to 8 bytes, not ``lanes x max_bytes``."""
    pdf, _ = _fact(400, 15)
    p = _tagged(pdf, CPX, S, Cast, col, lit, T).with_column(
        "arr", CPX.array(col("w"), col("p")))
    plan = p.explode(col("arr"), name="x")._plan
    session = pdf._session
    [part] = session.plan(plan).execute(E.ExecContext(session.device))
    [batch] = list(part)
    tag = batch.column("tag")
    lens = (tag.offsets[1:] - tag.offsets[:-1])[batch.live]
    longest = -(-int(lens.max()) // 8) * 8
    assert tag.max_bytes >= 128 and longest <= 16
    assert tag.data.numel() == KR.bucket_byte_capacity(batch.capacity
                                                       * longest)
    assert int(batch.live.sum()) == 800


def test_explode_outer_of_joined_arrays():
    """The chip cell's part (b) at test size: a per-customer array (0-8
    elements, null and empty arrays, null elements) joined to a fact
    table, then ``explode_outer``-ed and counted by element."""
    rng = np.random.default_rng(16)
    n_c = 120
    arrays = rand_arrays(rng, n_c, max_len=8, null_rows=0.05,
                         null_elems=0.05)
    for i in rng.choice(n_c, 6, replace=False):
        arrays[i] = []
    cschema = T.Schema([T.StructField("c", T.LONG, False),
                        T.StructField("arr", T.ArrayType(T.LONG))])
    pc, rc = frames({"c": list(range(n_c)), "arr": arrays}, cschema)
    fschema = T.Schema([T.StructField("fc", T.LONG, False),
                        T.StructField("v", T.LONG)])
    pf, rf = frames({"fc": rng.integers(0, n_c, 700).tolist(),
                     "v": rng.integers(0, 9, 700).tolist()}, fschema)
    pj = pf.join(pc, on=P.EqualTo(col("fc"), col("c")))
    rj = rf.join(rc, on=RP.EqualTo(rcol("fc"), rcol("c")))
    check_same(pj.explode(col("arr"), name="e", outer=True).select(
                   col("fc"), col("v"), col("e")),
               rj.explode(rcol("arr"), name="e", outer=True).select(
                   rcol("fc"), rcol("v"), rcol("e")))
    check_same(
        pj.explode(col("arr"), name="e", outer=True).group_by(col("e")).agg(
            A.AggregateExpression(A.Count(), "n"),
            A.AggregateExpression(A.Sum(col("v")), "sv")),
        rj.explode(rcol("arr"), name="e", outer=True).group_by(
            rcol("e")).agg(RA.AggregateExpression(RA.Count(), "n"),
                           RA.AggregateExpression(RA.Sum(rcol("v")), "sv")),
        ordered=False)


def test_explode_needs_an_array():
    pdf, _ = small()
    with pytest.raises(TypeError, match="array"):
        pdf.explode(col("k"))
