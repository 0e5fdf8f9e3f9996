"""``CaseWhen``, ``NaNvl``, ``If`` and ``Coalesce`` (``ops/conditional.py``)
against the JAX package's ``eval_device``, the port on the CPU.

One seeded batch with dead rows and nulls holds a dictionary string
column ``s``, a flat one ``f`` built from it by the reference
(``substring(s, 1, 64)``), integers ``k`` and doubles ``x`` with NaN.
Fixed-width branches, dictionary and literal string branches (whose
result must stay one sorted dictionary, as Mortgage's score band needs),
flat string branches (a flat result built from the chosen rows' bytes),
a missing ELSE and null conditions give the reference's values row for
row.

The helpers here (:func:`expr_batches`, :func:`check_expr`) serve the
other expression files of this slice.
"""

import numpy as np
import pyarrow as pa
import pytest

import jax.numpy as jnp

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.data.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.ops import conditional as RC
from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops import strings as RS
from spark_rapids_tpu.ops import strings_util as RSU
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit
from spark_rapids_tpu.ops.kernels import rowops as RKR
from spark_rapids_tpu.plan import logical as RL
from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops import conditional as C
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops import strings_util as SU
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.plan import logical as L

from test_torch_ops import port_schema, ref_fields

WORDS = np.array(["  ab c ", "abc", "", "xyz", "naïve café", "Ärger", "aaaa",
                  " 12 ", "a.b.c", "hello world foo", "SUBPRIME", "b"])


def expr_batches(words=WORDS, n: int = 400, seed: int = 3):
    """(reference batch, port batch): a dictionary column ``s`` over
    ``words`` (10 % null), its flat copy ``f``, int64 ``k`` in [-50, 50)
    (5 % null) and float64 ``x`` with NaN (5 % null); about 15 % of the
    rows dead (a lazy batch)."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.normal(0, 10, n), 1)
    x[rng.random(n) < 0.15] = np.nan
    rb = RBatch.from_arrow(pa.RecordBatch.from_arrays([
        pa.array(np.asarray(words)[rng.integers(0, len(words), n)],
                 pa.string(), mask=rng.random(n) < 0.1),
        pa.array(rng.integers(-50, 50, n), pa.int64(),
                 mask=rng.random(n) < 0.05),
        pa.array(x, pa.float64(), mask=rng.random(n) < 0.05)],
        names=["s", "k", "x"]))
    rb = RKR.compact(rb, jnp.asarray(rng.random(rb.capacity) < 0.85))
    flat = RL.resolve(RS.Substring(rcol("s"), rlit(1), rlit(64)),
                      rb.schema).bind(rb.schema).eval_device(rb)
    assert flat.is_string and not flat.is_dict
    rb = RBatch(rb.columns + (flat,), rb.n_rows,
                RT.Schema(list(rb.schema) + [RT.StructField("f",
                                                            RT.STRING)]),
                live=rb.live)
    pb = carry.batch_from_reference([ref_fields(c) for c in rb.columns],
                                    port_schema(rb.schema), int(rb.n_rows),
                                    np.asarray(rb.live), device="cpu")
    return rb, pb


def ref_strings(rb, c) -> list:
    """Live rows of a reference string column: bytes, None for a null."""
    m = np.asarray(RSU.char_matrix(c))
    v = np.asarray(c.validity)
    return [bytes(m[i][m[i] >= 0].astype(np.uint8)) if v[i] else None
            for i in np.flatnonzero(np.asarray(rb.row_mask()))]


def port_strings(pb, c) -> list:
    """Live rows of a port string column (either layout), read from its
    own layout: bytes, None for a null."""
    payload, starts, lens = SU.row_layout(c)
    raw = payload.numpy().tobytes()
    st, ln, v = starts.numpy(), lens.numpy(), c.validity.numpy()
    return [raw[st[i]:st[i] + ln[i]] if v[i] else None
            for i in np.flatnonzero(pb.row_mask().numpy())]


def fixed_values(batch, c, ref: bool) -> list:
    """Live rows of a fixed-width column: Python values, None for a null
    (floats as their bit patterns, so NaN compares)."""
    if ref:
        d, v = np.asarray(c.data), np.asarray(c.validity)
        live = np.asarray(batch.row_mask())
    else:
        d, v = c.data.numpy(), c.validity.numpy()
        live = batch.row_mask().numpy()
    if d.dtype.kind == "f":
        d = d.astype(np.float64).view(np.int64)
    return [d[i].item() if v[i] else None for i in np.flatnonzero(live)]


def evaluate(rb, pb, rexpr, pexpr, host: bool = False):
    """(reference column or host array, port column) of one expression;
    ``host``: the reference's CPU path (``eval_host``) instead."""
    rbound = RL.resolve(rexpr, rb.schema).bind(rb.schema)
    got = L.resolve(pexpr, pb.schema).bind(pb.schema).eval_device(pb)
    if host:
        from spark_rapids_tpu.data.batch import HostBatch as RHost
        live = np.asarray(rb.row_mask())
        table = RHost.from_device(rb)
        assert table.num_rows == int(live.sum())
        return rbound.eval_host(table), got
    return rbound.eval_device(rb), got


def check_expr(rb, pb, rexpr, pexpr, host: bool = False):
    """The port's column equals the reference's on every live row (a
    string by its bytes, whatever the two layouts); returns the port's
    column."""
    want, got = evaluate(rb, pb, rexpr, pexpr, host)
    if host:
        w = [None if v is None else (v.encode() if isinstance(v, str)
                                     else v) for v in want.to_pylist()]
        g = port_strings(pb, got) if got.is_string \
            else fixed_values(pb, got, False)
        assert g == w
    elif want.is_string:
        assert got.is_string
        assert port_strings(pb, got) == ref_strings(rb, want)
    else:
        assert fixed_values(pb, got, False) == fixed_values(rb, want, True)
    return got


@pytest.fixture(scope="module")
def both():
    return expr_batches()


#: name -> the expression, made from (conditional module, predicates
#: module, col, lit)
CASES = {
    "ints, else": lambda Cm, Pm, c, li: Cm.CaseWhen(
        [(Pm.LessThan(c("k"), li(-20)), li(1)),
         (Pm.LessThan(c("k"), li(0)), c("k"))], li(99)),
    "ints, no else": lambda Cm, Pm, c, li: Cm.CaseWhen(
        [(Pm.GreaterThan(c("k"), li(10)), c("k"))]),
    "doubles, null conditions": lambda Cm, Pm, c, li: Cm.CaseWhen(
        [(Pm.GreaterThan(c("x"), li(0.0)), c("x")),
         (Pm.LessThan(c("k"), li(0)), li(-1.5))], li(0.25)),
    "string literals (score band)": lambda Cm, Pm, c, li: Cm.CaseWhen(
        [(Pm.LessThan(c("k"), li(-25)), li("SUBPRIME")),
         (Pm.LessThan(c("k"), li(0)), li("FAIR")),
         (Pm.LessThan(c("k"), li(25)), li("GOOD"))], li("EXCELLENT")),
    "dictionary column and literals": lambda Cm, Pm, c, li: Cm.CaseWhen(
        [(Pm.GreaterThan(c("k"), li(20)), c("s")),
         (Pm.EqualTo(c("s"), li("abc")), li("ABC"))]),
    "flat branch": lambda Cm, Pm, c, li: Cm.CaseWhen(
        [(Pm.LessThan(c("k"), li(0)), c("f")),
         (Pm.LessThan(c("k"), li(20)), li("mid"))], c("s")),
    "flat else, null conditions": lambda Cm, Pm, c, li: Cm.CaseWhen(
        [(Pm.GreaterThan(c("x"), li(1.0)), c("s"))], c("f")),
}


@pytest.mark.parametrize("name", list(CASES))
def test_casewhen_matches_reference(both, name):
    rb, pb = both
    got = check_expr(rb, pb, CASES[name](RC, RP, rcol, rlit),
                     CASES[name](C, P, col, lit))
    if "flat" in name:
        assert got.is_flat
    elif got.is_string:
        assert got.is_dict and got.dict_sorted


def test_score_band_keeps_one_sorted_dictionary(both):
    _, pb = both
    e = CASES["string literals (score band)"](C, P, col, lit)
    out = L.resolve(e, pb.schema).bind(pb.schema).eval_device(pb)
    assert list(out.dictionary) == ["EXCELLENT", "FAIR", "GOOD", "SUBPRIME"]


@pytest.mark.parametrize("right", ["lit", "k"])
def test_nanvl_matches_reference(both, right):
    rb, pb = both
    r_arg = rlit(-7.5) if right == "lit" else rcol("k")
    p_arg = lit(-7.5) if right == "lit" else col("k")
    from spark_rapids_tpu.ops.cast import Cast as RCast
    from spark_rapids_tpu_torch.ops.cast import Cast
    if right == "k":
        r_arg, p_arg = RCast(r_arg, RT.DOUBLE), Cast(p_arg, T.DOUBLE)
    got = check_expr(rb, pb, RC.NaNvl(rcol("x"), r_arg),
                     C.NaNvl(col("x"), p_arg))
    assert not np.isnan(got.data.numpy()[got.validity.numpy()]).any()


IF_CASES = {
    "flat and literal": lambda Cm, Pm, c, li: Cm.If(
        Pm.GreaterThan(c("k"), li(3)), c("f"), li("x")),
    "dictionary and flat": lambda Cm, Pm, c, li: Cm.If(
        Pm.GreaterThan(c("x"), li(0.0)), c("s"), c("f")),
    "flat and flat, null predicate": lambda Cm, Pm, c, li: Cm.If(
        Pm.EqualTo(c("s"), li("abc")), c("f"), c("f")),
}


@pytest.mark.parametrize("name", list(IF_CASES))
def test_if_with_flat_branches_matches_reference(both, name):
    rb, pb = both
    got = check_expr(rb, pb, IF_CASES[name](RC, RP, rcol, rlit),
                     IF_CASES[name](C, P, col, lit))
    assert got.is_flat


@pytest.mark.parametrize("args", [("f", "s", "z"), ("s", "f"), ("f", "f")])
def test_coalesce_over_flat_strings_matches_reference(both, args):
    rb, pb = both

    def build(c, li):
        return [c(a) if a in ("s", "f") else li(a) for a in args]
    got = check_expr(rb, pb, RC.Coalesce(*build(rcol, rlit)),
                     C.Coalesce(*build(col, lit)))
    assert got.is_flat


def test_flat_result_builds_no_char_matrix(both, monkeypatch):
    """A flat CaseWhen reads its branches' layouts: no char matrix."""
    _, pb = both

    def refuse(*a, **k):
        raise AssertionError("a char matrix was built")
    monkeypatch.setattr(SU, "char_matrix", refuse)
    monkeypatch.setattr(SU, "_matrix_from_offsets", refuse)
    e = CASES["flat branch"](C, P, col, lit)
    L.resolve(e, pb.schema).bind(pb.schema).eval_device(pb)


def test_nanvl_over_strings_raises(both):
    """``nanvl`` takes numbers; the reference's device path fails on a
    string too (it has no data lane to test for NaN)."""
    rb, pb = both
    with pytest.raises(Exception):
        RC.NaNvl(rcol("s"), rcol("s")).bind(rb.schema).eval_device(rb)
    with pytest.raises(NotImplementedError, match="strings"):
        C.NaNvl(col("f"), lit(1.0)).bind(pb.schema).eval_device(pb)
