"""``Like`` and ``If`` over dictionary strings (``ops/strings.py``,
``ops/conditional.py``) against the JAX package's ``eval_device``, the
port on the CPU.

``Like`` runs on a dictionary column and on a flat column built from it
by the reference (``substring(s, 1, 64)``), in a batch with dead rows
and nulls: the simple forms (``%x%``, ``x%``, ``%x``, ``x``), ``_``
over multi-byte UTF-8 characters, ``%`` runs, escapes (the default
backslash and another character, a trailing escape), literal ``%`` and
``_`` in the data, the empty string and pattern, and a pattern longer
than every string. Every answer is also the plain Python one (a regular
expression over characters). On a flat column the walk reads the
column's offsets and payload: no char matrix is built.

``If`` with dictionary string branches (literals and columns, the
shapes of TPCxBB q27 and q28) gives the reference's strings row for
row; its result is one sorted dictionary.
"""

import re

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
from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.ops import conditional as C
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops import strings as S
from spark_rapids_tpu_torch.ops import strings_util as SU
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.plan import logical as L

from test_torch_ops import assert_column, port_schema, ref_fields
from test_torch_strings import rbind

WORDS = np.array(["ab", "abc", "", "xyz", "a_b", "a%b", "50%_off",
                  "naïve café", "Ärger", "special requests",
                  "requests are special", "PROMO BRUSHED", "b", "cab",
                  "terrible quality, cheaper at acme retail",
                  "saw it on zenith", "aXc"])
#: (pattern, escape)
PATTERNS = [("%", "\\"), ("", "\\"), ("%%", "\\"), ("ab", "\\"),
            ("a%", "\\"), ("%b", "\\"), ("%ab%", "\\"), ("%acme%", "\\"),
            ("_", "\\"), ("__", "\\"), ("___", "\\"), ("a_", "\\"),
            ("_b", "\\"), ("a_c", "\\"), ("%a_c%", "\\"), ("%é%", "\\"),
            ("na_ve%", "\\"), ("_rger", "\\"), ("Ä%", "\\"), ("%é", "\\"),
            ("%f_", "\\"), ("50\\%%", "\\"), ("%\\_%", "\\"),
            ("a\\%b", "\\"), ("a\\_b", "\\"), ("%special%requests%", "\\"),
            ("%requests", "\\"), ("s%s", "\\"), ("_%_", "\\"),
            ("%_%_%", "\\"), ("x" * 70, "\\"), ("%zz%", "\\"),
            ("P_OMO%", "\\"), ("a!_b", "!"), ("a!%b%", "!"), ("ab\\", "\\"),
            ("%on zenith", "\\")]
_IDS = [f"{i}:{p!r}" for i, (p, _) in enumerate(PATTERNS)]


def _table(n: int = 700, seed: int = 31) -> pa.RecordBatch:
    rng = np.random.default_rng(seed)
    s = WORDS[rng.integers(0, len(WORDS), n)]
    mask = rng.random(n) < 0.1
    return pa.RecordBatch.from_arrays(
        [pa.array(s, pa.string(), mask=mask),
         pa.array(rng.integers(0, 50, n), pa.int64())], names=["s", "k"])


@pytest.fixture(scope="module")
def strings():
    rb = RBatch.from_arrow(_table())
    keep = np.random.default_rng(32).random(rb.capacity) < 0.85
    rb = RKR.compact(rb, jnp.asarray(keep))
    flat = rbind(RS.Substring(rcol("s"), rlit(1), rlit(64)), rb.schema)
    fcol = flat.eval_device(rb)
    assert fcol.is_string and not fcol.is_dict
    rb = RBatch(rb.columns + (fcol,), rb.n_rows,
                RT.Schema(list(rb.schema) + [RT.StructField("f",
                                                            RT.STRING)]),
                live=rb.live)
    pb = carry.batch_from_reference([ref_fields(c) for c in rb.columns],
                                    port_schema(rb.schema), int(rb.n_rows),
                                    np.asarray(rb.live), device="cpu")
    return rb, pb


def py_like(value: str, pattern: str, escape: str) -> bool:
    """SQL LIKE over characters, as a regular expression."""
    rx, i = "", 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == escape and i + 1 < len(pattern):
            rx += re.escape(pattern[i + 1])
            i += 2
            continue
        rx += ".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
        i += 1
    return re.fullmatch(rx, value, re.S) is not None


def _port_strings(pb, c) -> tuple:
    """The live rows of a port string column: (values, validity)."""
    host = HostBatch.from_device(pb.with_columns(
        [c], T.Schema([T.StructField("v", T.STRING)])))
    return np.asarray(host.columns["v"]).astype(str), host.validity["v"]


def _ref_strings(rb, c) -> list:
    """The live rows of a reference string column, None for a null."""
    m = np.asarray(RSU.char_matrix(c))
    live = np.flatnonzero(np.asarray(rb.row_mask()))
    valid = np.asarray(c.validity)
    return [bytes(m[i][m[i] >= 0].astype(np.uint8)).decode()
            if valid[i] else None for i in live]


@pytest.mark.parametrize("column", ["s", "f"], ids=["dictionary", "flat"])
@pytest.mark.parametrize("pattern,escape", PATTERNS, ids=_IDS)
def test_like_matches_reference(pattern, escape, column, strings):
    rb, pb = strings
    assert pb.column(column).is_dict == (column == "s")
    want = RS.Like(rcol(column), pattern, escape).bind(rb.schema) \
        .eval_device(rb)
    got = S.Like(col(column), pattern, escape).bind(pb.schema) \
        .eval_device(pb)
    assert got.dtype is T.BOOLEAN
    assert_column(got, want, rb.row_mask())
    values, valid = _port_strings(pb, pb.column(column))
    live = np.asarray(rb.row_mask())
    expect = np.array([py_like(v, pattern, escape) for v in values])
    g = got.data.numpy()[live]
    np.testing.assert_array_equal(g[valid], expect[valid])
    assert not got.validity.numpy()[live][~valid].any()


def test_like_covers_every_token_kind(strings):
    """The general walk (neither a simple form nor the reference's
    ``EqualTo``) runs for ``_``, escapes and inner ``%``; every pattern
    matches something or is meant to match nothing."""
    kinds = {S.Like(col("s"), p, e).simple_form() is None
             for p, e in PATTERNS}
    assert kinds == {True, False}
    _, pb = strings
    hits = {p: bool(S.Like(col("s"), p, e).bind(pb.schema).eval_device(pb)
                    .data.any()) for p, e in PATTERNS}
    assert not hits["%zz%"] and not hits["x" * 70]
    assert all(hits[p] for p in ("_rger", "na_ve%", "a\\_b", "50\\%%",
                                 "a!_b", "%f_", "_%_"))


def test_like_on_a_flat_column_builds_no_char_matrix(strings, monkeypatch):
    _, pb = strings

    def refuse(*a, **k):
        raise AssertionError("a char matrix was built")
    monkeypatch.setattr(SU, "char_matrix", refuse)
    monkeypatch.setattr(SU, "_matrix_from_offsets", refuse)
    monkeypatch.setattr(S, "char_matrix", refuse)
    shapes = []
    walk = S._like_dp

    def spy(n, w, byte_at, toks, device):
        shapes.extend(t.shape for j in range(w) for t in byte_at(j))
        return walk(n, w, byte_at, toks, device)
    monkeypatch.setattr(S, "_like_dp", spy)
    for p, e in PATTERNS:
        if S.Like(col("f"), p, e).simple_form() is None:
            S.Like(col("f"), p, e).bind(pb.schema).eval_device(pb)
    # the walk reads one [capacity] lane of bytes a position
    assert shapes and set(shapes) == {(pb.capacity,)}


# --------------------------------------------------------------------------
# If over dictionary strings
# --------------------------------------------------------------------------

IFS = {
    "literals (q27)": lambda Cm, Pm, Sm, c, li: Cm.If(
        Sm.Like(c("s"), "%acme%"), li("acme"), li("zenith")),
    "literals (q28)": lambda Cm, Pm, Sm, c, li: Cm.If(
        Pm.EqualTo(c("k"), li(0)), li("test"), li("train")),
    "column and literal": lambda Cm, Pm, Sm, c, li: Cm.If(
        Pm.GreaterThan(c("k"), li(25)), c("s"), li("zz top")),
    "literal and column, null predicate": lambda Cm, Pm, Sm, c, li: Cm.If(
        Pm.EqualTo(c("s"), li("ab")), li("AB"), c("s")),
    "nested": lambda Cm, Pm, Sm, c, li: Cm.If(
        Pm.LessThan(c("k"), li(10)), li("low"),
        Cm.If(Pm.LessThan(c("k"), li(30)), c("s"), li("high"))),
}


@pytest.mark.parametrize("name", list(IFS))
def test_if_over_dictionary_strings_matches_reference(name, strings):
    rb, pb = strings
    want = rbind(IFS[name](RC, RP, RS, rcol, rlit), rb.schema
                 ).eval_device(rb)
    got = L.resolve(IFS[name](C, P, S, col, lit), pb.schema
                    ).bind(pb.schema).eval_device(pb)
    assert got.is_dict and got.dict_sorted
    assert list(got.dictionary) == sorted(set(got.dictionary))
    values, valid = _port_strings(pb, got)
    port = [v if ok else None for v, ok in zip(values, valid)]
    assert port == _ref_strings(rb, want)
