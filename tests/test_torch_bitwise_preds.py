"""``ops/bitwise.py`` and the predicates ``EqualNullSafe``, ``IsNaN`` and
``AtLeastNNonNulls`` (``ops/predicates.py``) against the JAX package's
``eval_device``, the port on the CPU, in a batch with nulls and dead
rows.

Shifts take amounts of 0, 31, 32, 63, 64, -1 and a column of
-70..70, over bigint and int values (the amount masked to 63 or 31, as
Java does); the unsigned right shift of negative values included.
``EqualNullSafe`` compares ints, doubles with NaN, dictionary strings,
flat strings and the two layouts against each other. A bitwise
operator over a float raises in both packages.
"""

import pytest

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.ops import bitwise as RB
from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops.cast import Cast as RCast
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops import bitwise as B
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops.cast import Cast
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.plan import logical as L

from test_torch_casewhen import check_expr, expr_batches


@pytest.fixture(scope="module")
def both():
    return expr_batches(n=300, seed=41)


def _int(M, c):
    """``k`` as an INT (the int-width shifts)."""
    return (RCast if M is RB else Cast)(c("k"), RT.INT if M is RB else T.INT)


SHIFTS = [0, 31, 32, 63, 64, -1]


@pytest.mark.parametrize("cls", ["ShiftLeft", "ShiftRight",
                                 "ShiftRightUnsigned"])
@pytest.mark.parametrize("width", ["bigint", "int"])
def test_shifts_match_reference(both, cls, width):
    rb, pb = both
    for amount in SHIFTS + ["column"]:
        def build(M, c, li):
            v = c("k") if width == "bigint" else _int(M, c)
            # a column of amounts in [-70, 70): k doubled plus a little
            sh = li(amount) if amount != "column" else _int(M, c)
            return getattr(M, cls)(v, sh)
        got = check_expr(rb, pb, build(RB, rcol, rlit), build(B, col, lit))
        assert got.dtype is (T.LONG if width == "bigint" else T.INT)


@pytest.mark.parametrize("cls", ["BitwiseAnd", "BitwiseOr", "BitwiseXor"])
def test_binary_bitwise_matches_reference(both, cls):
    rb, pb = both
    for other in (0x5A5A, -1, "k"):
        def build(M, c, li):
            o = c("k") if other == "k" else li(other)
            return getattr(M, cls)(c("k"), o)
        check_expr(rb, pb, build(RB, rcol, rlit), build(B, col, lit))
    # int with bigint promotes to bigint
    got = check_expr(rb, pb, getattr(RB, cls)(_int(RB, rcol), rcol("k")),
                     getattr(B, cls)(_int(B, col), col("k")))
    assert got.dtype is T.LONG


@pytest.mark.parametrize("width", ["bigint", "int"])
def test_bitwise_not_matches_reference(both, width):
    rb, pb = both
    r = rcol("k") if width == "bigint" else _int(RB, rcol)
    p = col("k") if width == "bigint" else _int(B, col)
    check_expr(rb, pb, RB.BitwiseNot(r), B.BitwiseNot(p))


def test_bitwise_over_a_float_raises_in_both(both):
    rb, pb = both
    with pytest.raises(Exception):
        RB.BitwiseAnd(rcol("x"), rcol("x")).bind(rb.schema).eval_device(rb)
    e = L.resolve(B.BitwiseAnd(col("x"), col("x")), pb.schema)
    with pytest.raises(Exception):
        e.bind(pb.schema).eval_device(pb)


EQ_NULL_SAFE = {
    "ints": lambda c, li: (c("k"), li(3)),
    "ints, both null": lambda c, li: (c("k"), c("k")),
    "doubles with NaN": lambda c, li: (c("x"), c("x")),
    "dictionary and literal": lambda c, li: (c("s"), li("abc")),
    "flat and literal": lambda c, li: (c("f"), li("abc")),
    "flat and dictionary": lambda c, li: (c("f"), c("s")),
    "flat and flat": lambda c, li: (c("f"), c("f")),
}


@pytest.mark.parametrize("name", list(EQ_NULL_SAFE))
def test_equal_null_safe_matches_reference(both, name):
    rb, pb = both
    got = check_expr(rb, pb, RP.EqualNullSafe(*EQ_NULL_SAFE[name](rcol,
                                                                 rlit)),
                     P.EqualNullSafe(*EQ_NULL_SAFE[name](col, lit)))
    live = pb.row_mask().numpy()
    assert got.validity.numpy()[live].all()  # never null


@pytest.mark.parametrize("arg", ["x", "k"])
def test_isnan_matches_reference(both, arg):
    rb, pb = both
    got = check_expr(rb, pb, RP.IsNaN(rcol(arg)), P.IsNaN(col(arg)))
    assert got.data.numpy().any() == (arg == "x")


@pytest.mark.parametrize("n", [0, 1, 2, 4, 5])
def test_at_least_n_non_nulls_matches_reference(both, n):
    rb, pb = both
    cols = ["s", "k", "x", "f"]
    check_expr(rb, pb, RP.AtLeastNNonNulls(n, *[rcol(c) for c in cols]),
               P.AtLeastNNonNulls(n, *[col(c) for c in cols]))
