"""``IntegralDivide``, ``Remainder``, ``Pmod``, ``Abs``, every function of
``ops/math.py`` and ``Cast`` between non-string types: the port on the
CPU against the JAX package on the same seeded columns, edge values
included (zero and -1 divisors, ``Long.MIN_VALUE``, NaN, +/-inf, +/-0.0,
floats at and past every integral type's bounds, negative timestamps).

Validity must be equal, and data equal bit for bit (floats by their
bits, NaN where the reference puts it), against the reference's
``eval_device``, except:

* the transcendental functions, ``Pow`` and ``Atan2``: within 2 units
  in the last place of the reference's host kernel (numpy, Java's
  accuracy), and within rtol 1e-13 of its ``eval_device``;
* float ``Remainder``/``Pmod`` and ``Cbrt``: against the reference's host
  kernel (``np.fmod``, ``np.cbrt``) alone, bit for bit and within 2 ulp.
  Its device kernels compute ``l - trunc(l / r) * r``, which is not
  Java's ``%`` for large quotients or an infinite divisor, and XLA's
  CPU ``cbrt`` is float32-accurate (``ROADMAP.md`` C).

The inputs hold no subnormal number: XLA's CPU backend flushes them to
zero.
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.data.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.ops import arithmetic as RAR
from spark_rapids_tpu.ops import cast as RCA
from spark_rapids_tpu.ops import math as RM
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit
from spark_rapids_tpu.plan import logical as RL

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.ops import arithmetic as AR
from spark_rapids_tpu_torch.ops import cast as CA
from spark_rapids_tpu_torch.ops import math as M
from spark_rapids_tpu_torch.ops import expression as EX
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.plan import logical as L

_MIN, _MAX = np.iinfo(np.int64).min, np.iinfo(np.int64).max
_N = 480


def _columns():
    rng = np.random.default_rng(12)
    k = _N - 40
    i = np.concatenate([[0, 1, -1, 7, -7, 9, -9, _MIN, _MAX, _MIN + 1,
                         2 ** 31, -2 ** 31 - 1, 100, -100, _MIN, _MAX],
                        rng.integers(-1000, 1000, _N - 16)])
    j = np.concatenate([[0, -1, 3, -3, 2, -2, 4, -1, -1, 0, 7, -7, -3, 3,
                         1, 1], rng.integers(-5, 6, _N - 16)])
    x = np.concatenate([[np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, 1.5,
                         2.5, -2.5, -0.5, 1e300, -1e300, 9.3e18, -9.3e18,
                         2.0 ** 63, -2.0 ** 63, 2.0 ** 31 - 0.5, 2.0 ** 31,
                         -2.0 ** 31 - 1.0, 127.9, 128.0, -129.0, 32767.5,
                         5.3, -5.3, 7.25, 27.0, -8.0, 1e-30, 0.999,
                         -0.999, 3.0, 1e6, -1e6, 40.0, 88.7, 700.0, 1.0,
                         -1.0, 0.1],
                        rng.normal(0, 100, k)])
    y = np.concatenate([[3.0, -3.0, 0.0, -0.0, np.inf, -np.inf, np.nan,
                         2.0, -2.0, 1e-3, 1e300, np.inf, 3.0, -3.0, 1.0,
                         0.5, 2.0, -7.0, 0.25, 4.0],
                        np.round(rng.normal(0, 5, _N - 20), 1)])
    n32 = np.concatenate([[2 ** 31 - 1, -2 ** 31, 0, 200, -200, 70000,
                           -70000, 128, -129, 32768],
                          rng.integers(-100000, 100000, _N - 10)]
                         ).astype(np.int32)
    small = np.concatenate([[0, 1, -1, 300, -300, 27, -8],
                            rng.integers(-300, 301, _N - 7)])
    cols = {"i": i.astype(np.int64), "j": j.astype(np.int64), "x": x,
            "s": small.astype(np.int64),
            "y": y, "n": n32, "b": rng.random(_N) < 0.5,
            "d": rng.integers(-1000, 30000, _N).astype(np.int32),
            "t": rng.integers(-10 ** 15, 10 ** 15, _N).astype(np.int64)}
    valid = {c: rng.random(_N) >= 0.08 for c in cols}
    for v in valid.values():
        v[:40] = True  # the edge values
    return cols, valid


_TYPES = {"i": (T.LONG, RT.LONG, pa.int64()),
          "s": (T.LONG, RT.LONG, pa.int64()),
          "j": (T.LONG, RT.LONG, pa.int64()),
          "x": (T.DOUBLE, RT.DOUBLE, pa.float64()),
          "y": (T.DOUBLE, RT.DOUBLE, pa.float64()),
          "n": (T.INT, RT.INT, pa.int32()),
          "b": (T.BOOLEAN, RT.BOOLEAN, pa.bool_()),
          "d": (T.DATE, RT.DATE, pa.date32()),
          "t": (T.TIMESTAMP, RT.TIMESTAMP, pa.timestamp("us"))}


@pytest.fixture(scope="module")
def both():
    cols, valid = _columns()
    schema = T.Schema([T.StructField(c, _TYPES[c][0]) for c in cols])
    port = HostBatch.from_numpy(cols, schema, valid).to_device("cpu")
    arrays = []
    for c, v in cols.items():
        pa_type = _TYPES[c][2]
        raw = v.view(np.int64) if c == "t" else v
        arrays.append(pa.array(raw, mask=~valid[c]).cast(pa_type)
                      if c in ("d", "t") else
                      pa.array(v, type=pa_type, mask=~valid[c]))
    ref = RBatch.from_arrow(pa.RecordBatch.from_arrays(arrays,
                                                       names=list(cols)))
    return ref, port, cols, valid


def _eval(expr_r, expr_p, both):
    rb, pb = both[0], both[1]
    want_e = RL.resolve(expr_r, rb.schema).bind(rb.schema)
    got_e = L.resolve(expr_p, pb.schema).bind(pb.schema)
    assert got_e.data_type.name == want_e.data_type.name
    want, got = want_e.eval_device(rb), got_e.eval_device(pb)
    wv = np.asarray(want.validity)[:_N]
    gv = got.validity.numpy()[:_N]
    np.testing.assert_array_equal(gv, wv)
    w = np.asarray(want.data)[:_N][wv]
    g = got.data.numpy()[:_N][gv]
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    return g, w, gv


def _same_bits(g, w):
    if g.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        ok = ~np.isnan(g)
        np.testing.assert_array_equal(
            g[ok].view(np.uint64 if g.itemsize == 8 else np.uint32),
            w[ok].view(np.uint64 if w.itemsize == 8 else np.uint32))
    else:
        np.testing.assert_array_equal(g, w)


def _within_ulps(g, w, ulps: float = 2.0):
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    ok = ~np.isnan(g) & ~np.isinf(w)
    np.testing.assert_array_equal(g[np.isinf(w)], w[np.isinf(w)])
    err = np.abs(g[ok] - w[ok])
    assert np.all(err <= ulps * np.spacing(np.abs(w[ok]))), \
        float(np.max(err / np.spacing(np.abs(w[ok]))))


def _pair(fn):
    """``fn(AR/M/CA module set, col, lit, types)`` for both packages."""
    return (fn((RAR, RM, RCA), rcol, rlit, RT), fn((AR, M, CA), col, lit, T))


# --------------------------------------------------------------------------
# arithmetic
# --------------------------------------------------------------------------

ARITH = {
    "div long": lambda m, c, li, t: m[0].IntegralDivide(c("i"), c("j")),
    "div literal": lambda m, c, li, t: m[0].IntegralDivide(c("i"), li(90)),
    "div int by long": lambda m, c, li, t: m[0].IntegralDivide(c("n"),
                                                               c("j")),
    "div int literal": lambda m, c, li, t: m[0].IntegralDivide(c("n"),
                                                               li(-7)),
    "rem long": lambda m, c, li, t: m[0].Remainder(c("i"), c("j")),
    "rem int": lambda m, c, li, t: m[0].Remainder(c("n"), li(-3)),
    "rem by zero literal": lambda m, c, li, t: m[0].Remainder(c("i"),
                                                              li(0)),
    "pmod long": lambda m, c, li, t: m[0].Pmod(c("i"), c("j")),
    "pmod literal": lambda m, c, li, t: m[0].Pmod(c("i"), li(10)),
    "pmod int negative": lambda m, c, li, t: m[0].Pmod(c("n"), li(-7)),
    "abs long": lambda m, c, li, t: m[0].Abs(c("i")),
    "abs int": lambda m, c, li, t: m[0].Abs(c("n")),
    "abs double": lambda m, c, li, t: m[0].Abs(c("x")),
}


@pytest.mark.parametrize("name", list(ARITH))
def test_arithmetic_matches_reference(name, both):
    g, w, _ = _eval(*_pair(ARITH[name]), both)
    _same_bits(g, w)


def test_zero_divisors_give_null_and_min_div_minus_one_wraps(both):
    _, pb, cols, valid = both
    for cls in (AR.IntegralDivide, AR.Remainder, AR.Pmod):
        e = L.resolve(cls(col("i"), col("j")), pb.schema).bind(pb.schema)
        out = e.eval_device(pb)
        v = out.validity.numpy()[:_N]
        np.testing.assert_array_equal(
            v, valid["i"] & valid["j"] & (cols["j"] != 0))
    div = L.resolve(AR.IntegralDivide(col("i"), col("j")), pb.schema
                    ).bind(pb.schema).eval_device(pb).data.numpy()
    # rows 7 and 8: MIN div -1 and MAX div -1
    assert div[7] == _MIN and div[8] == -_MAX
    rem = L.resolve(AR.Remainder(col("i"), col("j")), pb.schema
                    ).bind(pb.schema).eval_device(pb).data.numpy()
    assert rem[7] == 0 and rem[3] == 1 and rem[4] == -1  # 7 % -3, -7 % 2
    pm = L.resolve(AR.Pmod(col("i"), col("j")), pb.schema
                   ).bind(pb.schema).eval_device(pb).data.numpy()
    # pmod(-7, 2), pmod(9, -2), pmod(-9, 4)
    assert pm[4] == 1 and pm[5] == -1 and pm[6] == 3


@pytest.mark.parametrize("cls", ["Remainder", "Pmod"])
def test_float_remainder_and_pmod_match_reference_host_kernel(cls, both):
    """Java's float ``%`` (``fmod``): NaN and +/-inf operands, zero and
    infinite divisors, against the reference's host kernel."""
    rb, pb, cols, valid = both
    e = L.resolve(getattr(AR, cls)(col("x"), col("y")), pb.schema
                  ).bind(pb.schema)
    out = e.eval_device(pb)
    ok = valid["x"] & valid["y"]
    ref = RL.resolve(getattr(RAR, cls)(rcol("x"), rcol("y")), rb.schema)
    with np.errstate(all="ignore"):
        want, zero = ref.np_kernel(cols["x"], cols["y"])
    np.testing.assert_array_equal(out.validity.numpy()[:_N], ok & ~zero)
    keep = ok & ~zero
    _same_bits(out.data.numpy()[:_N][keep], want[keep])
    if cls == "Remainder":
        # -1e300 % inf is -1e300 (the reference's device kernel gives NaN)
        assert out.data.numpy()[11] == -1e300


# --------------------------------------------------------------------------
# math
# --------------------------------------------------------------------------

UNARY = ["Sin", "Cos", "Tan", "Asin", "Acos", "Atan", "Sinh", "Cosh", "Tanh",
         "Exp", "Expm1", "Log", "Log2", "Log10", "Log1p", "Sqrt", "Cbrt",
         "Rint", "ToDegrees", "ToRadians", "Signum"]
_EXACT = {"Rint", "Signum", "ToDegrees", "ToRadians"}


@pytest.mark.parametrize("name", UNARY)
@pytest.mark.parametrize("arg", ["x", "s"])
def test_math_unary_matches_reference(name, arg, both):
    rb, pb, cols, valid = both
    got_e = L.resolve(getattr(M, name)(col(arg)), pb.schema).bind(pb.schema)
    out = got_e.eval_device(pb)
    assert out.dtype is T.DOUBLE
    np.testing.assert_array_equal(out.validity.numpy()[:_N], valid[arg])
    g = out.data.numpy()[:_N][valid[arg]]
    with np.errstate(all="ignore"):
        host = getattr(RM, name).np_fn(cols[arg].astype(np.float64)
                                       )[valid[arg]]
    if name == "Signum":
        # as values: numpy's sign gives 0.0 for -0.0, where the
        # reference's device kernel (held bit for bit below) and Java's
        # signum keep -0.0
        np.testing.assert_array_equal(np.isnan(g), np.isnan(host))
        np.testing.assert_array_equal(g[~np.isnan(g)], host[~np.isnan(g)])
    elif name in _EXACT:
        _same_bits(g, host)
    else:
        _within_ulps(g, host)
    if name == "Cbrt":
        return
    g, w, _ = _eval(getattr(RM, name)(rcol(arg)), getattr(M, name)(col(arg)),
                    both)
    if name in _EXACT:
        _same_bits(g, w)
    else:
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        ok = ~np.isnan(g)
        np.testing.assert_allclose(g[ok], w[ok], rtol=1e-13, atol=0)


def test_sqrt_of_negative_is_nan_and_signum_keeps_zero_sign(both):
    _, pb, cols, valid = both
    sq = L.resolve(M.Sqrt(col("x")), pb.schema).bind(pb.schema)
    v = sq.eval_device(pb)
    neg = valid["x"] & (cols["x"] < 0)
    assert neg.any() and np.all(np.isnan(v.data.numpy()[:_N][neg]))
    sg = L.resolve(M.Signum(col("x")), pb.schema).bind(pb.schema
                                                       ).eval_device(pb)
    s = sg.data.numpy()[:_N]
    assert np.isnan(s[0]) and s[3] == 0 and np.signbit(s[4])


@pytest.mark.parametrize("name", ["Floor", "Ceil"])
@pytest.mark.parametrize("arg", ["x", "i", "n"])
def test_floor_ceil_match_reference(name, arg, both):
    g, w, _ = _eval(getattr(RM, name)(rcol(arg)), getattr(M, name)(col(arg)),
                    both)
    _same_bits(g, w)


@pytest.mark.parametrize("name", ["Pow", "Atan2"])
@pytest.mark.parametrize("args", [("x", "y"), ("y", "s"), ("s", "y")])
def test_math_binary_matches_reference(name, args, both):
    rb, pb, cols, valid = both
    a, b = args
    g, w, gv = _eval(getattr(RM, name)(rcol(a), rcol(b)),
                     getattr(M, name)(col(a), col(b)), both)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    ok = ~np.isnan(g) & np.isfinite(w)
    np.testing.assert_allclose(g[ok], w[ok], rtol=1e-13, atol=0)
    with np.errstate(all="ignore"):
        fn = np.power if name == "Pow" else np.arctan2
        host = fn(cols[a].astype(np.float64), cols[b].astype(np.float64))[gv]
    _within_ulps(g, host)


# --------------------------------------------------------------------------
# Cast
# --------------------------------------------------------------------------

CASTS = [("x", "LONG"), ("x", "INT"), ("x", "SHORT"), ("x", "BYTE"),
         ("x", "BOOLEAN"), ("x", "FLOAT"), ("x", "DOUBLE"), ("y", "LONG"),
         ("i", "INT"), ("i", "SHORT"), ("i", "BYTE"), ("i", "DOUBLE"),
         ("i", "FLOAT"), ("i", "BOOLEAN"), ("n", "LONG"), ("n", "BYTE"),
         ("n", "SHORT"), ("n", "DOUBLE"), ("b", "INT"), ("b", "LONG"),
         ("b", "DOUBLE"), ("d", "TIMESTAMP"), ("t", "DATE"),
         ("t", "LONG"), ("i", "LONG")]


@pytest.mark.parametrize("arg,to", CASTS)
def test_cast_matches_reference(arg, to, both):
    g, w, _ = _eval(RCA.Cast(rcol(arg), getattr(RT, to)),
                    CA.Cast(col(arg), getattr(T, to)), both)
    _same_bits(g, w)


def test_float_to_long_saturates_and_nan_is_zero(both):
    _, pb, cols, valid = both
    out = L.resolve(CA.Cast(col("x"), T.LONG), pb.schema).bind(pb.schema
                                                               ).eval_device(pb)
    d, v = out.data.numpy(), out.validity.numpy()
    want = {0: 0, 1: _MAX, 2: _MIN, 4: 0, 8: -2, 12: _MAX, 13: _MIN,
            14: _MAX, 15: _MIN, 16: 2 ** 31 - 1}
    for row, value in want.items():
        assert v[row] and d[row] == value, (row, d[row])
    out = L.resolve(CA.Cast(col("x"), T.BYTE), pb.schema).bind(pb.schema
                                                               ).eval_device(pb)
    # 127.9 -> 127, 128.0 -> 127 (clamped, not wrapped), -129.0 -> -128
    assert out.data.numpy()[19:22].tolist() == [127, 127, -128]


def test_cast_to_or_from_string_raises(both):
    """Casts from and to strings, which this test once saw refused, now
    give the reference's values (``tests/test_torch_cast_string.py``
    holds them fully); only a float to a string still raises, as the
    reference's device path does."""
    rb, pb, _, _ = both
    from test_torch_casewhen import fixed_values, port_strings, ref_strings
    got = CA.Cast(col("i"), T.STRING).bind(pb.schema).eval_device(pb)
    want = RCA.Cast(rcol("i"), RT.STRING).bind(rb.schema).eval_device(rb)
    assert port_strings(pb, got) == ref_strings(rb, want)
    back = CA.Cast(CA.Cast(col("i"), T.STRING), T.LONG).bind(pb.schema)
    assert fixed_values(pb, back.eval_device(pb), False) == \
        fixed_values(rb, RCA.Cast(rcol("i"), RT.LONG).bind(
            rb.schema).eval_device(rb), True)
    for e in (CA.Cast(col("x"), T.STRING), CA.Cast(col("y"), T.STRING)):
        with pytest.raises(NotImplementedError, match="castFloatToString"):
            e.bind(pb.schema).eval_device(pb)


def test_coercion_inserts_the_cast_class(both):
    _, pb, _, _ = both
    e = L.resolve(AR.Add(col("n"), col("x")), pb.schema)
    assert isinstance(e.children[0], CA.Cast)
    assert EX.coerce_binary(col("n").bind(pb.schema), lit(1.5))[0].to \
        is T.DOUBLE
