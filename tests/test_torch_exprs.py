"""``If``, ``StartsWith``, ``Exp`` and ``UnaryMinus`` against the JAX
package's ``eval_device`` on the same column states (see
``tests/test_torch_ops.py``), the port on the CPU.

Validity and data must be equal bit for bit (floats by their bits, so
-0.0 stays apart from 0.0 and NaN where the reference puts it), except
``Exp``, held to rtol 1e-15: numpy's and PyTorch's ``exp`` may differ in
the last bit.
"""

import numpy as np
import pytest

import torch

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.ops import arithmetic as RAR
from spark_rapids_tpu.ops import conditional as RC
from spark_rapids_tpu.ops import math as RM
from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops import strings as RS
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit
from spark_rapids_tpu.plan import logical as RL

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops import arithmetic as AR
from spark_rapids_tpu_torch.ops import conditional as C
from spark_rapids_tpu_torch.ops import math as M
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops import strings as S
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.plan import logical as L
from test_torch_ops import assert_column, both_batches
from test_torch_strings import batches as string_batches


def _exprs(Pm, ARm, Cm, Mm, c, li, date):
    """Expressions over ``test_torch_ops.table()``: ``a`` int64, ``b``
    double (NaN, +/-0.0), ``d`` date, ``k`` int64 without nulls, all but
    ``k`` with nulls."""
    return {
        "if int literals": Cm.If(Pm.GreaterThan(c("a"), li(0)), li(1),
                                 li(0)),
        "if null predicate": Cm.If(Pm.LessThan(c("b"), li(0.0)), c("a"),
                                   c("k")),
        "if doubles": Cm.If(Pm.EqualTo(c("s"), li("BUILDING")), c("b"),
                            ARm.Multiply(c("b"), li(2.0))),
        "if dates": Cm.If(Pm.IsNull(c("a")), c("d"), li(9204, date)),
        "if bools": Cm.If(Pm.GreaterThan(c("k"), li(12)),
                          Pm.IsNull(c("b")), Pm.LessThan(c("a"), li(5))),
        "if nested": Cm.If(Pm.GreaterThan(c("k"), li(20)), li(0.5),
                           Cm.If(Pm.IsNotNull(c("b")), c("b"), li(-1.0))),
        "exp double": Mm.Exp(c("b")),
        "exp long": Mm.Exp(ARm.Multiply(c("a"), li(-0.25))),
        "exp int column": Mm.Exp(c("k")),
        "minus long": ARm.UnaryMinus(c("a")),
        "minus double": ARm.UnaryMinus(c("b")),
        "minus int literal sum": ARm.UnaryMinus(ARm.Add(c("k"), li(3))),
        "sigmoid": ARm.Divide(li(1.0), ARm.Add(li(1.0), Mm.Exp(
            ARm.UnaryMinus(ARm.Multiply(c("b"), li(0.37)))))),
    }


def _bound(name, mods, batch, resolve):
    expr = _exprs(*mods)[name]
    return resolve(expr, batch.schema).bind(batch.schema)


REF = (RP, RAR, RC, RM, rcol, rlit, RT.DATE)
PORT = (P, AR, C, M, col, lit, T.DATE)


@pytest.fixture(scope="module")
def both():
    return both_batches()


@pytest.mark.parametrize("name", list(_exprs(*PORT)))
def test_expression_matches_reference(name, both):
    rb, pb = both
    want_e = _bound(name, REF, rb, RL.resolve)
    got_e = _bound(name, PORT, pb, L.resolve)
    assert got_e.data_type.name == want_e.data_type.name
    got, want = got_e.eval_device(pb), want_e.eval_device(rb)
    assert got.data.numpy().dtype == np.asarray(want.data).dtype
    rtol = 1e-15 if name.startswith(("exp", "sigmoid")) else 0.0
    assert_column(got, want, rb.row_mask(), rtol=rtol)


def test_minus_keeps_signed_zero_and_wraps_the_minimum():
    from spark_rapids_tpu_torch.data.batch import HostBatch
    host = HostBatch.from_numpy(
        {"x": np.array([0.0, -0.0, 1.5, np.nan]),
         "n": np.array([np.iinfo(np.int64).min, 0, 7, -7])})
    batch = host.to_device("cpu")
    x = AR.UnaryMinus(col("x")).bind(host.schema).eval_device(batch)
    n = AR.UnaryMinus(col("n")).bind(host.schema).eval_device(batch)
    got = x.data.numpy()[:4]
    assert np.signbit(got[0]) and not np.signbit(got[1]) and got[2] == -1.5
    assert np.isnan(got[3])
    assert n.data.numpy()[:4].tolist() == [np.iinfo(np.int64).min, 0, -7, 7]


def test_if_refuses_string_branches(both):
    """A flat string branch raises (dictionary branches are taken, see
    ``tests/test_torch_like_if.py``)."""
    _, pb = both
    e = C.If(P.GreaterThan(col("k"), lit(3)),
             S.Substring(col("s"), lit(1), lit(2)), lit("x"))
    with pytest.raises(NotImplementedError, match="flat string"):
        L.resolve(e, pb.schema).bind(pb.schema).eval_device(pb)


# --------------------------------------------------------------------------
# StartsWith over dictionary and flat columns
# --------------------------------------------------------------------------

#: Needles over ``test_torch_strings``' words: empty, one and several
#: bytes, a whole word, one byte past it, a multi-byte character, longer
#: than every dictionary entry, and longer than the flat column's width.
NEEDLES = ["", "1", "13", "13-4", "23-555-0199", "23-555-0199x", "ÄR",
           "phone", "x" * 20, "y" * 200]


@pytest.fixture(scope="module")
def strings():
    return string_batches()


@pytest.mark.parametrize("column", ["s", "f"],
                         ids=["dictionary", "flat"])
@pytest.mark.parametrize("needle", NEEDLES,
                         ids=[f"needle {len(n.encode())} bytes {i}"
                              for i, n in enumerate(NEEDLES)])
def test_starts_with_matches_reference(needle, column, strings):
    rb, pb = strings
    assert pb.column(column).is_dict == (column == "s")
    want = RS.StartsWith(rcol(column), needle).bind(rb.schema) \
        .eval_device(rb)
    got = S.StartsWith(col(column), needle).bind(pb.schema).eval_device(pb)
    assert_column(got, want, rb.row_mask())
    live = rb.row_mask()
    # the answers are the plain Python ones, nulls staying null
    from spark_rapids_tpu_torch.data.batch import HostBatch
    values = HostBatch.from_device(pb.with_columns(
        [pb.column(column)], T.Schema([T.StructField("v", T.STRING)])))
    got_host = got.data.numpy()[np.asarray(live)]
    valid = values.validity["v"]
    expect = np.array([str(v).encode().startswith(needle.encode())
                       for v in values.columns["v"]])
    np.testing.assert_array_equal(got_host[valid], expect[valid])
    assert not got.validity.numpy()[np.asarray(live)][~valid].any()


def test_flat_starts_with_builds_no_char_matrix(strings, monkeypatch):
    from spark_rapids_tpu_torch.ops import strings_util as SU
    _, pb = strings

    def refuse(*a, **k):
        raise AssertionError("a char matrix was built")

    monkeypatch.setattr(S, "char_matrix", refuse)
    monkeypatch.setattr(SU, "char_matrix", refuse)
    monkeypatch.setattr(SU, "_matrix_from_offsets", refuse)
    out = S.StartsWith(col("f"), "13").bind(pb.schema).eval_device(pb)
    assert out.data.dtype == torch.bool
