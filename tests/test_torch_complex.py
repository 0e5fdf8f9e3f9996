"""ARRAY and STRUCT columns and the complex-type expressions
(``ops/complex.py``) through ``TorchSession`` on the CPU against the JAX
package's ``TpuSession`` device path (``spark.rapids.sql.test.enabled``:
nothing of the reference may fall back to its host path), on the same
seeded numpy inputs, row for row and bit for bit.

The cases mirror the reference's ``tests/test_complex_types.py``: the
array extractors (an ordinal in and out of range, ``size`` of a null,
``array_contains`` with null elements), ``array(...)`` with numeric
coercion, random arrays of three element types, arrays and structs
through a filter, a union (differing dictionaries in a struct's string
field), a join to a dimension table, a top-k and both repartitions
(Spark's hash folded element by element and field by field, a struct's
flat string field through the ``hash`` kernel's ragged entry). An array
grouping, join or sort key, and ``split``, raise with the reference's
reason. ``carry`` takes arrays and structs from the reference's columns.

The helpers here (:func:`frames`, :func:`check_same`) serve the other
files of this slice.
"""

import math

import numpy as np
import pyarrow as pa
import pytest

import jax.numpy as jnp

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.ops import aggregates as RA
from spark_rapids_tpu.ops import complex as RCPX
from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops import strings as RS
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit
from spark_rapids_tpu.plan.logical import SortOrder as RSortOrder

from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.exec import mesh as MX
from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops import arithmetic as AR
from spark_rapids_tpu_torch.ops import complex as CPX
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops import strings as S
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.ops.strings2 import StringSplit
from spark_rapids_tpu_torch.plan.logical import SortOrder
from spark_rapids_tpu_torch.session import TorchSession

from harness import cpu_session, tpu_session

WORDS = ["AIR", "FOB", "MAIL", "", "REG AIR", "ÄRGER", "SHIP", "truck"]

#: port type -> (reference type, arrow type)
_TYPES = {"bigint": (RT.LONG, pa.int64()), "int": (RT.INT, pa.int32()),
          "double": (RT.DOUBLE, pa.float64()),
          "string": (RT.STRING, pa.string()),
          "boolean": (RT.BOOLEAN, pa.bool_())}


def ref_type(dt):
    """The reference's type for a port type."""
    if isinstance(dt, T.ArrayType):
        return RT.ArrayType(ref_type(dt.element_type), dt.contains_null)
    if isinstance(dt, T.StructType):
        return RT.StructType([RT.StructField(f.name, ref_type(f.data_type),
                                             f.nullable) for f in dt.fields])
    return _TYPES[dt.name][0]


def arrow_type(dt):
    if isinstance(dt, T.ArrayType):
        return pa.list_(arrow_type(dt.element_type))
    if isinstance(dt, T.StructType):
        return pa.struct([pa.field(f.name, arrow_type(f.data_type))
                          for f in dt.fields])
    return _TYPES[dt.name][1]


def rand_arrays(rng, n: int, elem: str = "bigint", max_len: int = 6,
                null_rows: float = 0.1, null_elems: float = 0.1) -> list:
    """``n`` lists of 0..max_len elements (``None`` rows and elements)."""
    out = []
    for _ in range(n):
        if rng.random() < null_rows:
            out.append(None)
            continue
        k = int(rng.integers(0, max_len + 1))
        if elem == "double":
            vals = np.round(rng.normal(0, 10, k), 2)
            vals[rng.random(k) < 0.1] = 0.0
            vals = vals.tolist()
        else:
            vals = rng.integers(-20, 20, k).tolist()
        out.append([None if rng.random() < null_elems else v for v in vals])
    return out


def rand_structs(rng, n: int, null_rows: float = 0.1) -> list:
    """``n`` dicts ``{a: bigint, b: string}`` (``None`` rows and fields)."""
    out = []
    for _ in range(n):
        if rng.random() < null_rows:
            out.append(None)
            continue
        out.append({"a": None if rng.random() < 0.1
                    else int(rng.integers(-50, 50)),
                    "b": None if rng.random() < 0.1
                    else WORDS[int(rng.integers(0, len(WORDS)))]})
    return out


STRUCT_AB = T.StructType([T.StructField("a", T.LONG),
                          T.StructField("b", T.STRING)])


def frames(data: dict, schema: T.Schema, port_session=None,
           ref_session=None):
    """(port frame, reference frame) over the same rows: ``data`` maps a
    column to a list of python values (``None`` for a null)."""
    port_session = port_session or TorchSession(device="cpu")
    ref_session = ref_session or tpu_session()
    arrays = [pa.array(data[f.name], type=arrow_type(f.data_type))
              for f in schema]
    rb = pa.RecordBatch.from_arrays(arrays, names=schema.names)
    pdf = port_session.create_dataframe(
        HostBatch.from_numpy({k: _obj(v) for k, v in data.items()},
                             schema))
    return pdf, ref_session.create_dataframe(rb)


def _obj(values: list) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def _py(v):
    if isinstance(v, np.generic):
        return v.item()
    return v


def port_rows(hb) -> list:
    cols = []
    for i in range(len(hb.schema)):
        vals, ok = hb.column_at(i)
        cols.append([_py(v) if o else None for v, o in zip(vals, ok)])
    return list(zip(*cols))


def ref_rows(table) -> list:
    return list(zip(*[table.column(i).to_pylist()
                      for i in range(table.num_columns)]))


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or \
            np.float64(a).tobytes() == np.float64(b).tobytes()
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b if a is not None and b is not None \
        else a is None and b is None


def _key(row):
    return repr(row)


def check_same(port_df, ref_df, ordered: bool = True) -> list:
    """Collect both; the same column names and rows (in order unless
    ``ordered`` is False), floats bit for bit. Returns the port's rows."""
    got = port_df.collect()
    want = ref_df.collect()
    assert list(got.schema.names) == list(want.column_names)
    g, w = port_rows(got), ref_rows(want)
    if not ordered:
        g, w = sorted(g, key=_key), sorted(w, key=_key)
    assert len(g) == len(w), (len(g), len(w))
    for i, (a, b) in enumerate(zip(g, w)):
        assert _same(a, b), f"row {i}: {a} vs {b}"
    return g


ARR = [[1, 2, 3], [], None, [4, None], [5], None, [6, 7]]
KEYS = [1, 2, 3, 4, 5, 6, 7]
SMALL = T.Schema([T.StructField("k", T.LONG, False),
                  T.StructField("arr", T.ArrayType(T.LONG))])


def small():
    return frames({"k": KEYS, "arr": ARR}, SMALL)


def rand_frames(elem: str = "bigint", n: int = 257, seed: int = 0):
    rng = np.random.default_rng(seed)
    et = {"bigint": T.LONG, "double": T.DOUBLE, "int": T.INT}[elem]
    schema = T.Schema([T.StructField("k", T.LONG, False),
                       T.StructField("arr", T.ArrayType(et))])
    return frames({"k": rng.integers(-100, 100, n).tolist(),
                   "arr": rand_arrays(rng, n, elem)}, schema)


def struct_frames(n: int = 129, seed: int = 0, ref_session=None):
    rng = np.random.default_rng(seed)
    schema = T.Schema([T.StructField("k", T.LONG, False),
                       T.StructField("st", STRUCT_AB)])
    return frames({"k": rng.integers(-100, 100, n).tolist(),
                   "st": rand_structs(rng, n)}, schema,
                  ref_session=ref_session)


# --------------------------------------------------------------------------
# arrays
# --------------------------------------------------------------------------

ARRAY_CASES = {
    "get_array_item": lambda C, c, l: [
        c("k"), C.GetArrayItem(c("arr"), l(1)).alias("x")],
    "get_array_item_out_of_range": lambda C, c, l: [
        C.GetArrayItem(c("arr"), l(9)).alias("x")],
    "get_array_item_negative": lambda C, c, l: [
        C.GetArrayItem(c("arr"), l(-1)).alias("x")],
    "size": lambda C, c, l: [c("k"), C.Size(c("arr")).alias("n")],
    "array_contains": lambda C, c, l: [
        c("k"), C.ArrayContains(c("arr"), l(4)).alias("c")],
    "array_contains_absent": lambda C, c, l: [
        C.ArrayContains(c("arr"), l(99)).alias("c")],
    "create_array": lambda C, c, l: [
        c("k"), C.array(c("k"), c("k"), l(0)).alias("a")],
    "create_then_extract": lambda C, c, l: [
        C.GetArrayItem(C.array(c("k"), c("k")), 1).alias("x")],
    "create_array_coerced": lambda C, c, l: [
        C.array(c("k"), l(0.5)).alias("a")],
    "raw": lambda C, c, l: [c("arr")],
}


@pytest.mark.parametrize("case", list(ARRAY_CASES))
def test_array_expressions(case):
    pdf, rdf = small()
    build = ARRAY_CASES[case]
    check_same(pdf.select(*build(CPX, col, lit)),
               rdf.select(*build(RCPX, rcol, rlit)))


@pytest.mark.parametrize("elem", ["bigint", "double", "int"])
def test_random_arrays_roundtrip(elem):
    pdf, rdf = rand_frames(elem)
    check_same(
        pdf.select(col("k"), col("arr"), CPX.Size(col("arr")).alias("n"),
                   CPX.GetArrayItem(col("arr"), lit(0)).alias("head")),
        rdf.select(rcol("k"), rcol("arr"), RCPX.Size(rcol("arr")).alias("n"),
                   RCPX.GetArrayItem(rcol("arr"), rlit(0)).alias("head")))


def test_array_contains_double_zero():
    """``array_contains(arr, 0.0)`` over doubles with 0.0 elements and
    nulls: hits, misses and the null rule."""
    pdf, rdf = rand_frames("double", seed=4)
    rows = check_same(
        pdf.select(CPX.ArrayContains(col("arr"), lit(0.0)).alias("c")),
        rdf.select(RCPX.ArrayContains(rcol("arr"), rlit(0.0)).alias("c")))
    seen = {r[0] for r in rows}
    assert seen == {True, False, None}


def test_array_through_filter():
    pdf, rdf = rand_frames()
    check_same(
        pdf.where(P.GreaterThan(col("k"), lit(0))).select(
            col("arr"), CPX.Size(col("arr")).alias("n")),
        rdf.where(rcol("k") > 0).select(rcol("arr"),
                                        RCPX.Size(rcol("arr")).alias("n")))


def test_array_through_union():
    """Two frames whose arrays bucket to different ``max_len`` (4 and 8):
    the union re-pads to the wider."""
    rng = np.random.default_rng(1)
    schema = T.Schema([T.StructField("arr", T.ArrayType(T.LONG))])
    a = {"arr": rand_arrays(rng, 60, max_len=3)}
    b = {"arr": rand_arrays(rng, 90, max_len=7)}
    pa_, ra_ = frames(a, schema)
    pb, rb = frames(b, schema)
    check_same(pa_.union(pb).select(col("arr")),
               ra_.union(rb).select(rcol("arr")))


@pytest.mark.parametrize("key", ["arr", "k"])
def test_repartition_by_array(key):
    pdf, rdf = rand_frames()
    check_same(pdf.repartition(4, col(key)).select(col("k"), col("arr")),
               rdf.repartition(4, rcol(key)).select(rcol("k"), rcol("arr")))


def test_array_join_to_dimension():
    """An array column carried through a join to a dimension table (the
    build side unique: the direct-address join)."""
    pdf, rdf = rand_frames(n=300, seed=2)
    dim = {"d": list(range(-100, 100, 3)),
           "name": [WORDS[i % len(WORDS)] for i in range(0, 200, 3)]}
    dschema = T.Schema([T.StructField("d", T.LONG, False),
                        T.StructField("name", T.STRING)])
    pd_, rd_ = frames(dim, dschema)
    check_same(
        pdf.join(pd_, on=P.EqualTo(col("k"), col("d"))).select(
            col("k"), col("arr"), col("name")),
        rdf.join(rd_, on=RP.EqualTo(rcol("k"), rcol("d"))).select(
            rcol("k"), rcol("arr"), rcol("name")))


def test_array_topk():
    pdf, rdf = rand_frames(n=200, seed=3)
    check_same(pdf.sort(SortOrder(col("k"), False)).limit(15).select(
                   col("k"), col("arr")),
               rdf.sort(RSortOrder(rcol("k"), False)).limit(15).select(
                   rcol("k"), rcol("arr")), ordered=False)


@pytest.mark.parametrize("what", ["group_by", "join", "sort", "distinct",
                                  "topk"])
def test_array_keys_raise(what):
    """An array grouping, join or sort key no longer raises: the
    operator is tagged to the host with the reference's reason
    (``overrides.py _no_complex_keys``) and its answer is the rows'
    own (arrays ordered element by element, a null element first)."""
    pdf, _ = small()
    other = pdf.select(col("arr").alias("arr2"), col("k").alias("k2"))
    build = {
        "group_by": lambda: pdf.group_by(col("arr")).agg(
            A.AggregateExpression(A.Count(), "n")),
        "join": lambda: pdf.join(other, on=P.EqualTo(col("arr"),
                                                     col("arr2"))),
        "sort": lambda: pdf.sort(col("arr")),
        "distinct": lambda: pdf.distinct(),
        "topk": lambda: pdf.sort(col("arr")).limit(3),
    }[what]
    session = pdf._session
    session.set_conf("spark.rapids.sql.explain", "NOT_ON_TPU")
    got = build().collect()
    assert "is not supported on TPU" in session.last_explain
    assert "_no_complex_keys" not in session.last_explain
    rows = list(zip(*[[v if ok else None for v, ok in zip(*got.column_at(i))]
                      for i in range(len(got.schema))]))
    pairs = list(zip(KEYS, ARR))

    def key(a):
        return (a is not None, [(e is not None, e) for e in a or []])
    if what == "group_by":
        want = {}
        for a in ARR:
            t = None if a is None else tuple(a)
            want[t] = want.get(t, 0) + 1
        assert {(None if a is None else tuple(a)): n for a, n in rows} == want
    elif what == "join":
        want = sorted((k, k2) for k, a in pairs for k2, b in pairs
                      if a is not None and b is not None and a == b)
        assert sorted((r[0], r[3]) for r in rows) == want
    elif what == "distinct":
        assert sorted(rows, key=repr) == sorted(pairs, key=repr)
    else:
        order = [a for _, a in sorted(pairs, key=lambda p: key(p[1]))]
        if what == "topk":
            order = order[:3]
        assert [list(r[1]) if r[1] is not None else None
                for r in rows] == order


def test_string_split_raises():
    """``split`` gives ARRAY<STRING>, which has no device layout: its
    project runs on the host with the reference's reason, as the
    reference sends it to its host path."""
    session = TorchSession({"spark.rapids.sql.explain": "NOT_ON_TPU"},
                           device="cpu")
    df = session.create_dataframe({"s": np.array(["a,b", "c", ",x,"])})
    got = df.select(StringSplit(col("s"), ",").alias("parts")).collect()
    assert list(got.columns["parts"]) == [["a", "b"], ["c"], ["", "x", ""]]
    assert "ARRAY<STRING> has no device layout" in session.last_explain


def test_array_of_strings_raises():
    session = TorchSession(device="cpu")
    df = session.create_dataframe({"s": np.array(["a", "b"])})
    with pytest.raises(NotImplementedError, match="fixed-width"):
        df.select(CPX.array(col("s"), col("s")).alias("a")).collect()


# --------------------------------------------------------------------------
# structs
# --------------------------------------------------------------------------

def test_struct_roundtrip():
    pdf, rdf = struct_frames()
    check_same(pdf.select(col("st")), rdf.select(rcol("st")))


def test_get_struct_field():
    pdf, rdf = struct_frames()
    check_same(
        pdf.select(col("k"), CPX.GetStructField(col("st"), "a").alias("a"),
                   CPX.GetStructField(col("st"), "b").alias("b")),
        rdf.select(rcol("k"), RCPX.GetStructField(rcol("st"), "a").alias("a"),
                   RCPX.GetStructField(rcol("st"), "b").alias("b")))


def test_create_named_struct():
    pdf, rdf = struct_frames()
    check_same(
        pdf.select(CPX.struct(x=col("k"), y=AR.Multiply(col("k"), lit(2)),
                              b=CPX.GetStructField(col("st"), "b"))
                   .alias("made")),
        rdf.select(RCPX.struct(x=rcol("k"), y=rcol("k") * 2,
                               b=RCPX.GetStructField(rcol("st"), "b"))
                   .alias("made")))


def test_struct_through_filter():
    pdf, rdf = struct_frames()
    check_same(
        pdf.where(P.EqualTo(AR.Remainder(col("k"), lit(2)), lit(0)))
        .select(col("st")),
        rdf.where((rcol("k") % 2).eq(rlit(0))).select(rcol("st")))


def _flat_struct(C, S_, c, l):
    """A struct with a flat string field (a substring builds it)."""
    return C.struct(a=C.GetStructField(c("st"), "a"),
                    f=S_.Substring(C.GetStructField(c("st"), "b"),
                                   l(1), l(3)))


def test_struct_with_flat_field_through_filter_and_union():
    """A struct whose string field is flat: compaction gathers it with
    the ragged ``strings`` gather; the union concatenates it."""
    pdf, rdf = struct_frames(seed=5)
    p = pdf.select(col("k"), _flat_struct(CPX, S, col, lit).alias("fs"))
    r = rdf.select(rcol("k"), _flat_struct(RCPX, RS, rcol, rlit).alias("fs"))
    pf = p.where(P.GreaterThan(col("k"), lit(0)))
    rf = r.where(rcol("k") > 0)
    check_same(pf.union(p).select(col("fs")), rf.union(r).select(rcol("fs")))


@pytest.mark.parametrize("flat", [False, True])
def test_repartition_by_struct(flat):
    """Spark's hash folded field by field; the flat string field through
    the ``hash`` kernel's ragged entry."""
    pdf, rdf = struct_frames(n=200, seed=6)
    if flat:
        pdf = pdf.select(col("k"), _flat_struct(CPX, S, col, lit).alias("st"))
        rdf = rdf.select(rcol("k"),
                         _flat_struct(RCPX, RS, rcol, rlit).alias("st"))
    check_same(pdf.repartition(8, col("st")).select(col("k"), col("st")),
               rdf.repartition(8, rcol("st")).select(rcol("k"), rcol("st")))


def test_struct_union_merges_dictionaries():
    """Two frames whose struct string fields hold different dictionaries,
    through a union and a string max of the field. Against the
    reference's CPU-oracle session: its device path fails on a string
    max."""
    rs = cpu_session()
    pa_, ra_ = struct_frames(n=80, seed=7, ref_session=rs)
    pb, rb = struct_frames(n=90, seed=8, ref_session=rs)
    check_same(
        pa_.union(pb).group_by().agg(A.AggregateExpression(
            A.Max(CPX.GetStructField(col("st"), "b")), "mx"),
            A.AggregateExpression(A.Count(), "n")),
        ra_.union(rb).group_by().agg(
            RA.AggregateExpression(RA.Max(
                RCPX.GetStructField(rcol("st"), "b")), "mx"),
            RA.AggregateExpression(RA.Count(), "n")))


def test_struct_and_array_refuse_the_mesh():
    """A plan that carries a struct or an array column stays off the
    mesh (a projection of plain columns over a table plans as a source
    of those columns, so the complex column is selected too)."""
    pdf, _ = struct_frames()
    session = pdf._session
    assert not MX.mesh_capable(session.plan(
        pdf.select(col("k"), col("st"))._plan))
    assert not MX.mesh_capable(session.plan(
        small()[0].select(col("k"), col("arr"))._plan))


# --------------------------------------------------------------------------
# carry
# --------------------------------------------------------------------------

def _ref_column_fields(c) -> dict:
    """A reference column's fields as numpy arrays, arrays and structs
    included (dictionary strings decoded)."""
    from test_torch_ops import ref_fields
    if c.is_struct:
        return {"validity": np.asarray(c.validity),
                "children": [_ref_column_fields(k) for k in c.children]}
    if c.is_array:
        return {"validity": np.asarray(c.validity),
                "data": np.asarray(c.data),
                "elem_validity": np.asarray(c.elem_validity),
                "lengths": np.asarray(c.lengths)}
    return ref_fields(c)


@pytest.mark.parametrize("kind", ["array", "struct"])
def test_carry_complex_columns(kind):
    """``carry.batch_from_reference`` builds the port's array and struct
    columns from the reference's (uploaded and evaluated ones, a lazy
    batch), and the port downloads the reference's rows."""
    from spark_rapids_tpu.data.batch import ColumnarBatch as RBatch
    from spark_rapids_tpu.ops.kernels import rowops as RKR
    rng = np.random.default_rng(9)
    n = 150
    if kind == "array":
        dt = T.ArrayType(T.DOUBLE)
        values = rand_arrays(rng, n, "double")
    else:
        dt = STRUCT_AB
        values = rand_structs(rng, n)
    rb = RBatch.from_arrow(pa.RecordBatch.from_arrays(
        [pa.array(values, type=arrow_type(dt))], names=["c"]))
    keep = rng.random(rb.capacity) < 0.7
    rb = RKR.compact(rb, jnp.asarray(keep))
    pb = carry.batch_from_reference(
        [_ref_column_fields(c) for c in rb.columns],
        T.Schema([T.StructField("c", dt)]), int(rb.n_rows),
        np.asarray(rb.live), device="cpu")
    got = HostBatch.from_device(pb)
    want = [v for v, k in zip(values, keep) if k]
    rows = [r[0] for r in port_rows(got)]
    assert len(rows) == len(want)
    for a, b in zip(rows, want):
        assert _same(a, b), (a, b)
