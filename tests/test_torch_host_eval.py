"""Host evaluation (``eval_host``) of every expression family of the port
against the reference's ``eval_host`` (its pyarrow CPU oracle) on the
same seeded batch.

One batch of 300 rows holds int64 ``i`` and ``j`` (``j`` in [-5, 5], so
zero divisors), float64 ``x`` and ``y`` with NaN, -0.0, 0.0, +/-inf and
nulls, float32 ``f``, dates ``d`` (days -1000 to 30000), timestamps
``t`` (micros, before the epoch too), booleans ``b``, ASCII strings
``s`` and ``csv`` (for ``split``), and ``arr`` (ARRAY<BIGINT> with null
arrays and null elements); every column has nulls. Each case builds the
same expression in both packages and compares row for row: integers,
booleans, strings, dates and arrays exactly; floats exactly (NaN equal
to NaN) except the transcendental functions, within 4 units in the last
place (the port runs torch's CPU kernels, the reference numpy's).

The string functions count bytes in the port (ROADMAP C); the reference's
host path counts characters, so non-ASCII text is held against the
port's own device path instead (``test_non_ascii_host_equals_device``).
"""

import datetime
import math
import types

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.data.batch import HostBatch as RHost
from spark_rapids_tpu.ops import arithmetic as RA
from spark_rapids_tpu.ops import bitwise as RB
from spark_rapids_tpu.ops import cast as RCA
from spark_rapids_tpu.ops import complex as RX
from spark_rapids_tpu.ops import conditional as RC
from spark_rapids_tpu.ops import datetime as RD
from spark_rapids_tpu.ops import math as RMA
from spark_rapids_tpu.ops import nondeterministic as RN
from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops import strings as RS
from spark_rapids_tpu.ops import strings2 as RS2
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import host_to_array
from spark_rapids_tpu.ops.expression import lit as rlit
from spark_rapids_tpu.plan import logical as RL
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.ops import arithmetic as A
from spark_rapids_tpu_torch.ops import bitwise as B
from spark_rapids_tpu_torch.ops import cast as CA
from spark_rapids_tpu_torch.ops import complex as X
from spark_rapids_tpu_torch.ops import conditional as C
from spark_rapids_tpu_torch.ops import datetime as D
from spark_rapids_tpu_torch.ops import math as MA
from spark_rapids_tpu_torch.ops import nondeterministic as N
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops import strings as S
from spark_rapids_tpu_torch.ops import strings2 as S2
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.plan import logical as L

N_ROWS = 300
#: units in the last place allowed for the transcendental functions
ULPS = 4

PORT = types.SimpleNamespace(A=A, B=B, CA=CA, X=X, C=C, D=D, MA=MA, N=N,
                             P=P, S=S, S2=S2, T=T, col=col, lit=lit)
REF = types.SimpleNamespace(A=RA, B=RB, CA=RCA, X=RX, C=RC, D=RD, MA=RMA,
                            N=RN, P=RP, S=RS, S2=RS2, T=RT, col=rcol,
                            lit=rlit)

WORDS = ["  ab c ", "abc", "", "xyz", "a.b.c", "hello world foo", "SUB",
         "b", "Mixed Case", "x_y%z"]
CSV = ["a,b,,c", "", ",", "x", "1,2,3,4,5", ",,", "one"]


def _data(seed: int = 5):
    rng = np.random.default_rng(seed)
    n = N_ROWS
    special = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -2.25])
    x = np.round(rng.normal(0, 50, n), 2)
    y = np.round(rng.normal(0, 5, n), 3)
    pick = rng.random(n) < 0.2
    x[pick] = special[rng.integers(0, len(special), pick.sum())]
    pick = rng.random(n) < 0.2
    y[pick] = special[rng.integers(0, len(special), pick.sum())]
    arr = []
    for _ in range(n):
        r = rng.random()
        if r < 0.1:
            arr.append(None)
        else:
            arr.append([None if rng.random() < 0.1 else int(v)
                        for v in rng.integers(-5, 5, rng.integers(0, 5))])
    cols = {
        "i": rng.integers(-1000, 1000, n).astype(np.int64),
        "j": rng.integers(-5, 6, n).astype(np.int64),
        "x": x, "y": y,
        "f": rng.normal(0, 3, n).astype(np.float32),
        "d": rng.integers(-1000, 30000, n).astype(np.int32),
        "t": rng.integers(-10 ** 15, 10 ** 15, n).astype(np.int64),
        "b": rng.random(n) < 0.5,
        "s": np.array(WORDS, dtype=object)[rng.integers(0, len(WORDS), n)],
        "csv": np.array(CSV, dtype=object)[rng.integers(0, len(CSV), n)],
        "arr": arr,
    }
    valid = {k: rng.random(n) > 0.1 for k in cols}
    valid["arr"] = np.array([a is not None for a in arr])
    return cols, valid


_PORT_TYPES = {"i": T.LONG, "j": T.LONG, "x": T.DOUBLE, "y": T.DOUBLE,
               "f": T.FLOAT, "d": T.DATE, "t": T.TIMESTAMP, "b": T.BOOLEAN,
               "s": T.STRING, "csv": T.STRING, "arr": T.ArrayType(T.LONG)}
_ARROW = {"i": pa.int64(), "j": pa.int64(), "x": pa.float64(),
          "y": pa.float64(), "f": pa.float32(), "d": pa.date32(),
          "t": pa.timestamp("us"), "b": pa.bool_(), "s": pa.string(),
          "csv": pa.string(), "arr": pa.list_(pa.int64())}


@pytest.fixture(scope="module")
def batches():
    cols, valid = _data()
    arrays = []
    for k, v in cols.items():
        ok = valid[k]
        py = [(v[i].item() if hasattr(v[i], "item") else v[i])
              if ok[i] else None for i in range(N_ROWS)]
        arrays.append(pa.array(py, type=pa.int32() if k == "d" else
                               pa.int64() if k == "t" else _ARROW[k])
                      .cast(_ARROW[k]))
    rhost = RHost(pa.RecordBatch.from_arrays(arrays, names=list(cols)))
    schema = T.Schema([T.StructField(k, _PORT_TYPES[k]) for k in cols])
    data = {k: (np.array(v, dtype=object) if k == "arr" else v)
            for k, v in cols.items()}
    phost = HostBatch.from_numpy(data, schema, valid)
    return rhost, phost


def _canon(v):
    if isinstance(v, datetime.datetime):
        epoch = datetime.datetime(1970, 1, 1)
        d = v - epoch
        return (d.days * 86400 + d.seconds) * 10 ** 6 + d.microseconds
    if isinstance(v, datetime.date):
        return (v - datetime.date(1970, 1, 1)).days
    if isinstance(v, (list, tuple)):
        return [_canon(e) for e in v]
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, bytes):
        return v.decode("utf-8", "surrogateescape")
    return v


def _same(a, b, ulps: int = 0) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) or isinstance(b, float):
        a, b = float(a), float(b)
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if a == b:
            return True
        return ulps > 0 and abs(a - b) <= ulps * math.ulp(max(abs(a),
                                                            abs(b)))
    return a == b


def host_rows(e, batch: HostBatch) -> list:
    """The port's host values of ``e`` over ``batch``: Python values,
    None for a null."""
    v, ok = L.resolve(e, batch.schema).bind(batch.schema).eval_host(batch)
    assert len(v) == len(ok) == batch.num_rows
    return [_canon(x) if good else None for x, good in zip(v, ok)]


def ref_rows(e, batch: RHost) -> list:
    out = RL.resolve(e, batch.schema).bind(batch.schema).eval_host(batch)
    return [_canon(x) for x in host_to_array(out, batch.num_rows)
            .to_pylist()]


def check(batches, build, ulps: int = 0):
    rhost, phost = batches
    got = host_rows(build(PORT), phost)
    want = ref_rows(build(REF), rhost)
    assert len(got) == len(want)
    bad = [(i, g, w) for i, (g, w) in enumerate(zip(got, want))
           if not _same(g, w, ulps)]
    assert not bad, bad[:5]


def _cases():
    def bin_(mod, name, a, b):
        return lambda m: getattr(getattr(m, mod), name)(m.col(a), m.col(b))

    def un_(mod, name, a):
        return lambda m: getattr(getattr(m, mod), name)(m.col(a))
    cases = {}
    for name in ("Add", "Subtract", "Multiply", "Divide", "IntegralDivide",
                 "Remainder", "Pmod"):
        for a, b in (("i", "j"), ("x", "y")):
            if name == "IntegralDivide" and a == "x":
                continue
            cases[f"{name}[{a},{b}]"] = bin_("A", name, a, b)
    for name in ("UnaryMinus", "Abs"):
        for a in ("i", "x"):
            cases[f"{name}[{a}]"] = un_("A", name, a)
    for name in ("EqualTo", "NotEqual", "LessThan", "LessThanOrEqual",
                 "GreaterThan", "GreaterThanOrEqual", "EqualNullSafe"):
        for a, b in (("i", "j"), ("x", "y"), ("s", "csv")):
            cases[f"{name}[{a},{b}]"] = bin_("P", name, a, b)
    cases["And"] = lambda m: m.P.And(m.col("b"), m.P.GreaterThan(
        m.col("i"), m.lit(0)))
    cases["Or"] = lambda m: m.P.Or(m.col("b"), m.P.LessThan(
        m.col("x"), m.lit(0.0)))
    cases["Not"] = un_("P", "Not", "b")
    for a in ("i", "x", "s", "arr"):
        cases[f"IsNull[{a}]"] = un_("P", "IsNull", a)
        cases[f"IsNotNull[{a}]"] = un_("P", "IsNotNull", a)
    cases["IsNaN"] = un_("P", "IsNaN", "x")
    cases["In[i]"] = lambda m: m.P.In(m.col("j"), [1, -2, 3])
    cases["In[s]"] = lambda m: m.P.In(m.col("s"), ["abc", "", "b"])
    cases["AtLeastNNonNulls"] = lambda m: m.P.AtLeastNNonNulls(
        2, m.col("i"), m.col("x"), m.col("s"))
    for name in ("BitwiseAnd", "BitwiseOr", "BitwiseXor", "ShiftLeft",
                 "ShiftRight", "ShiftRightUnsigned"):
        cases[name] = bin_("B", name, "i", "j")
    cases["BitwiseNot"] = un_("B", "BitwiseNot", "i")
    for name in ("Floor", "Ceil", "Signum", "Rint", "ToDegrees",
                 "ToRadians"):
        cases[name] = un_("MA", name, "x")
    cases["Sqrt"] = un_("MA", "Sqrt", "x")
    cases["If"] = lambda m: m.C.If(m.col("b"), m.col("i"), m.col("j"))
    cases["If[s]"] = lambda m: m.C.If(m.col("b"), m.col("s"), m.lit("zz"))
    cases["CaseWhen"] = lambda m: m.C.CaseWhen(
        [(m.P.GreaterThan(m.col("i"), m.lit(100)), m.lit(1)),
         (m.col("b"), m.lit(2))], m.lit(3))
    cases["CaseWhen[no else]"] = lambda m: m.C.CaseWhen(
        [(m.P.GreaterThan(m.col("x"), m.lit(0.0)), m.col("y"))])
    cases["Coalesce"] = lambda m: m.C.Coalesce(m.col("i"), m.col("j"),
                                               m.lit(7))
    cases["Coalesce[s]"] = lambda m: m.C.Coalesce(m.col("s"), m.col("csv"))
    cases["NaNvl"] = lambda m: m.C.NaNvl(m.col("x"), m.col("y"))
    for a, to in (("i", "DOUBLE"), ("x", "LONG"), ("x", "INT"),
                  ("f", "DOUBLE"), ("d", "TIMESTAMP"), ("t", "DATE"),
                  ("b", "LONG"), ("i", "BOOLEAN"), ("i", "STRING"),
                  ("b", "STRING"), ("x", "STRING"), ("f", "STRING"),
                  ("d", "STRING")):
        cases[f"Cast[{a}->{to}]"] = (
            lambda m, a=a, to=to: m.CA.Cast(m.col(a), getattr(m.T, to)))
    for name in ("Year", "Month", "DayOfMonth", "Quarter", "DayOfYear",
                 "DayOfWeek", "WeekDay", "LastDay"):
        cases[f"{name}[d]"] = un_("D", name, "d")
    for name in ("Hour", "Minute", "Second"):
        cases[f"{name}[t]"] = un_("D", name, "t")
    cases["DateAdd"] = lambda m: m.D.DateAdd(m.col("d"), m.col("j"))
    cases["DateSub"] = lambda m: m.D.DateSub(m.col("d"), m.col("j"))
    cases["DateDiff"] = lambda m: m.D.DateDiff(m.col("d"), m.D.DateAdd(
        m.col("d"), m.col("j")))
    for name in ("Length", "Upper", "Lower", "StringTrim", "StringTrimLeft",
                 "StringTrimRight"):
        cases[f"{name}[s]"] = un_("S", name, "s")
    for name, needle in (("StartsWith", "a"), ("EndsWith", "c"),
                         ("Contains", "b")):
        cases[name] = (lambda m, name=name, needle=needle:
                       getattr(m.S, name)(m.col("s"), needle))
    cases["Substring"] = lambda m: m.S.Substring(m.col("s"), m.lit(2),
                                                 m.lit(3))
    cases["Substring[neg]"] = lambda m: m.S.Substring(m.col("s"), m.lit(-3),
                                                      m.lit(2))
    cases["ConcatStrings"] = lambda m: m.S.ConcatStrings(m.col("s"),
                                                         m.lit("-"),
                                                         m.col("csv"))
    cases["Like"] = lambda m: m.S.Like(m.col("s"), "%b%")
    cases["Like[_]"] = lambda m: m.S.Like(m.col("s"), "a_c")
    cases["StringReplace"] = lambda m: m.S2.StringReplace(m.col("s"), "b",
                                                          "XY")
    cases["RegExpReplace[literal]"] = lambda m: m.S2.RegExpReplace(
        m.col("s"), "ab", "_")
    for pat in ("a.c", "^ ", "[a-c]+", "o$", "l{2}"):
        cases[f"RegExpReplace[{pat}]"] = (
            lambda m, pat=pat: m.S2.RegExpReplace(m.col("s"), pat, "#"))
    cases["LPad"] = lambda m: m.S2.LPad(m.col("s"), 6, "*")
    cases["RPad"] = lambda m: m.S2.RPad(m.col("s"), 4, "-=")
    cases["StringLocate"] = lambda m: m.S2.StringLocate("b", m.col("s"))
    cases["InitCap"] = un_("S2", "InitCap", "s")
    cases["SubstringIndex"] = lambda m: m.S2.SubstringIndex(m.col("csv"),
                                                            ",", 2)
    cases["SubstringIndex[neg]"] = lambda m: m.S2.SubstringIndex(
        m.col("csv"), ",", -1)
    cases["Reverse"] = un_("S2", "Reverse", "s")
    cases["StringRepeat"] = lambda m: m.S2.StringRepeat(m.col("csv"), 2)
    cases["StringSplit"] = lambda m: m.S2.StringSplit(m.col("csv"), ",")
    cases["StringSplit[limit 2]"] = lambda m: m.S2.StringSplit(
        m.col("csv"), ",", 2)
    cases["StringSplit[space]"] = lambda m: m.S2.StringSplit(m.col("s"),
                                                             " ")
    cases["CreateArray"] = lambda m: m.X.CreateArray(m.col("i"),
                                                     m.col("j"))
    cases["GetArrayItem"] = lambda m: m.X.GetArrayItem(m.col("arr"),
                                                       m.lit(1))
    cases["Size"] = un_("X", "Size", "arr")
    cases["ArrayContains"] = lambda m: m.X.ArrayContains(m.col("arr"),
                                                         m.lit(2))
    cases["GetArrayItem[split]"] = lambda m: m.X.GetArrayItem(
        m.S2.StringSplit(m.col("csv"), ","), m.lit(1))
    cases["Size[split]"] = lambda m: m.X.Size(m.S2.StringSplit(
        m.col("csv"), ","))
    cases["CreateNamedStruct"] = lambda m: m.X.CreateNamedStruct(
        ["a", "b"], [m.col("i"), m.col("s")])
    cases["GetStructField"] = lambda m: m.X.GetStructField(
        m.X.CreateNamedStruct(["a", "b"], [m.col("i"), m.col("s")]), "b")
    for name in ("InputFileName", "InputFileBlockStart",
                 "InputFileBlockLength"):
        cases[name] = (lambda m, name=name: getattr(m.N, name)())
    cases["SparkPartitionID"] = lambda m: m.N.SparkPartitionID()
    cases["MonotonicallyIncreasingID"] = \
        lambda m: m.N.MonotonicallyIncreasingID()
    return cases


CASES = _cases()
TRANSCENDENTAL = {"Sqrt", "ToDegrees", "ToRadians"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_eval_matches_reference(batches, case):
    check(batches, CASES[case], ULPS if case in TRANSCENDENTAL else 0)


@pytest.mark.parametrize("name", ["Exp", "Log", "Sin", "Atan", "Cbrt",
                                  "Log1p", "Tanh"])
def test_transcendental_host_eval_matches_reference(batches, name):
    """The transcendental functions within 4 units in the last place."""
    check(batches, lambda m: getattr(m.MA, name)(m.col("y")), ULPS)


@pytest.mark.parametrize("seed,pid,base", [(0, 0, 0), (7, 3, 100),
                                           (-2, 1, 1 << 40)])
def test_rand_host_equals_reference_and_device(batches, seed, pid, base):
    """``rand(seed)`` on the host: the reference's hash counter bit for
    bit, and the port's own device path's bits."""
    rhost, phost = batches
    with N.eval_context(pid, base), RN.eval_context(pid, base):
        got = host_rows(N.Rand(seed), phost)
        want = ref_rows(RN.Rand(seed), rhost)
        dev = N.Rand(seed).eval_device(phost.to_device("cpu"))
    bits = np.array(got, dtype=np.float64).view(np.int64)
    assert np.array_equal(bits, np.array(want, np.float64).view(np.int64))
    assert np.array_equal(np.array(got), dev.data[:N_ROWS].numpy())


def test_float_to_string_is_the_reference_host_text(batches):
    """``cast(x as string)`` of doubles and floats: the reference's host
    text (Python's ``str`` of the value as a double), character for
    character, NaN, infinities and -0.0 included."""
    rhost, phost = batches
    for c in ("x", "y", "f"):
        got = host_rows(CA.Cast(col(c), T.STRING), phost)
        assert got == ref_rows(RCA.Cast(rcol(c), RT.STRING), rhost)
        assert "nan" in got or c == "f"


def test_non_ascii_host_equals_device():
    """Over non-ASCII text the port's host path gives its device path's
    bytes (``Length`` and ``locate`` count bytes, the case maps touch
    ASCII only; ROADMAP C), where the reference's host path counts
    characters."""
    words = np.array(["naïve café", "Ärger", "日本", "", "abc",
                      " é é ", "çaé,bé,,é"], dtype=object)
    hb = HostBatch.from_numpy({"u": words})
    db = hb.to_device("cpu")
    for e in (S.Length(col("u")), S.Upper(col("u")), S.Lower(col("u")),
              S2.Reverse(col("u")), S2.LPad(col("u"), 8, "."),
              S.Substring(col("u"), lit(2), lit(3)),
              S.StringTrim(col("u")), S.StartsWith(col("u"), "ç"),
              S.EndsWith(col("u"), "é"), S.Contains(col("u"), "é "),
              S.ConcatStrings(col("u"), lit("ü")),
              S2.StringReplace(col("u"), "é", "e"),
              S2.InitCap(col("u")), S2.SubstringIndex(col("u"), ",", -2),
              S2.StringRepeat(col("u"), 2), S2.StringLocate("é", col("u"))):
        bound = L.resolve(e, hb.schema).bind(hb.schema)
        v, ok = bound.eval_host(hb)
        dev = HostBatch.from_device(type(db)(
            (bound.eval_device(db),), db.n_rows,
            T.Schema([T.StructField("r", bound.data_type)]))).column_at(0)
        assert [x for x in v] == [x for x in dev[0]], e


@pytest.mark.parametrize("name", ["Year", "Month", "DayOfMonth", "Quarter",
                                  "DayOfYear", "DayOfWeek", "WeekDay",
                                  "LastDay"])
def test_date_parts_host_equal_device_over_wide_years(name):
    """numpy's ``datetime64`` civil dates against the port's own device
    algorithm (Hinnant's, floor division) from year -1000 to 3000, and
    the time parts of timestamps before and after the epoch."""
    rng = np.random.default_rng(8)
    days = rng.integers(-1_085_000, 376_000, 2000).astype(np.int32)
    micros = rng.integers(-(1 << 60), 1 << 60, 2000)
    hb = HostBatch.from_numpy({"d": days, "t": micros},
                              T.Schema([T.StructField("d", T.DATE),
                                        T.StructField("t", T.TIMESTAMP)]))
    db = hb.to_device("cpu")
    for c in ("d", "t"):
        e = getattr(D, name)(col(c)).bind(hb.schema)
        v, ok = e.eval_host(hb)
        dev = e.eval_device(db).data[:2000].numpy()
        np.testing.assert_array_equal(v, dev)
    for part in ("Hour", "Minute", "Second"):
        e = getattr(D, part)(col("t")).bind(hb.schema)
        np.testing.assert_array_equal(
            e.eval_host(hb)[0], e.eval_device(db).data[:2000].numpy())
