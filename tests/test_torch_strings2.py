"""The rest of ``ops/strings.py`` (``Length``, ``Upper``, ``Lower``,
``ConcatStrings``, the trims) and ``ops/strings2.py`` without
``StringSplit`` against the JAX package's ``eval_device``, the port on
the CPU, over a dictionary column and its flat copy.

Words cover the empty string, strings of spaces, non-ASCII bytes
(``naïve café``, ``Ärger``), overlapping needles (``aaaa``), and
delimiters at either end; the batch has nulls and dead rows. Pads and
repeats that give empty strings (length 0 or below, a count of 0 or
below) are among the cases. A dictionary input keeps its codes and
transforms its entries once; a flat input builds no char matrix.

An empty pad differs from the reference's device path on purpose: that
path swaps it for a space, while its CPU path (and Spark) only cut, as
the port does; it is held to the byte rule itself. A regular expression
pattern raises ``NotImplementedError``, where the reference falls back
to its CPU path.
"""

import numpy as np
import pytest

from spark_rapids_tpu.ops import strings as RS
from spark_rapids_tpu.ops import strings2 as RS2
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit
from spark_rapids_tpu_torch.ops import strings as S
from spark_rapids_tpu_torch.ops import strings2 as S2
from spark_rapids_tpu_torch.ops import strings_util as SU
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.plan import logical as L

from test_torch_casewhen import (check_expr, expr_batches, port_strings,
                                 ref_strings)

WORDS = np.array(["  ab c ", "abc", "", "xyz", "naïve café", "Ärger", "aaaa",
                  "   ", ".a.b.c.", "hello world foo", "éé", "b", "aXaXa",
                  "MiXeD cAsE wOrds"])

#: name -> the expression, made from (strings module, strings2 module,
#: column, lit)
CASES = {
    "length": lambda M, M2, c, li: M.Length(c),
    "upper": lambda M, M2, c, li: M.Upper(c),
    "lower": lambda M, M2, c, li: M.Lower(c),
    "trim": lambda M, M2, c, li: M.StringTrim(c),
    "ltrim": lambda M, M2, c, li: M.StringTrimLeft(c),
    "rtrim": lambda M, M2, c, li: M.StringTrimRight(c),
    "replace overlapping": lambda M, M2, c, li: M2.StringReplace(
        c, "aa", "X"),
    "replace to empty": lambda M, M2, c, li: M2.StringReplace(c, "a", ""),
    "replace non-ASCII": lambda M, M2, c, li: M2.StringReplace(
        c, "é", "e"),
    "replace empty search": lambda M, M2, c, li: M2.StringReplace(
        c, "", "y"),
    "regexp literal": lambda M, M2, c, li: M2.RegExpReplace(c, "aX", "_"),
    "lpad": lambda M, M2, c, li: M2.LPad(c, 8, "xy"),
    "lpad cuts": lambda M, M2, c, li: M2.LPad(c, 3, "-"),
    "rpad non-ASCII pad": lambda M, M2, c, li: M2.RPad(c, 12, "ü"),
    "rpad to -2": lambda M, M2, c, li: M2.RPad(c, -2, "x"),
    "locate": lambda M, M2, c, li: M2.StringLocate("a", c),
    "locate from 3": lambda M, M2, c, li: M2.StringLocate("a", c, 3),
    "locate non-ASCII": lambda M, M2, c, li: M2.StringLocate("é", c),
    "locate pos 0": lambda M, M2, c, li: M2.StringLocate("a", c, 0),
    "locate empty": lambda M, M2, c, li: M2.StringLocate("", c, 2),
    "initcap": lambda M, M2, c, li: M2.InitCap(c),
    "substring_index 2": lambda M, M2, c, li: M2.SubstringIndex(c, ".", 2),
    "substring_index -2": lambda M, M2, c, li: M2.SubstringIndex(
        c, ".", -2),
    "substring_index overlapping": lambda M, M2, c, li: M2.SubstringIndex(
        c, "aa", 1),
    "substring_index 0": lambda M, M2, c, li: M2.SubstringIndex(c, ".", 0),
    "substring_index empty delim": lambda M, M2, c, li: M2.SubstringIndex(
        c, "", 1),
    "reverse": lambda M, M2, c, li: M2.Reverse(c),
    "repeat 3": lambda M, M2, c, li: M2.StringRepeat(c, 3),
    "repeat 0": lambda M, M2, c, li: M2.StringRepeat(c, 0),
}


#: Cases run once: a concatenation of both layouts and a literal, and a
#: replace that lengthens the strings (flat).
MIXED = {
    "concat": lambda M, M2, c, li: M.ConcatStrings(c("s"), li("-"), c("f")),
    "replace longer": lambda M, M2, c, li: M2.StringReplace(
        c("f"), ".", "<=>"),
}


@pytest.fixture(scope="module")
def both():
    return expr_batches(WORDS, n=300, seed=17)


#: The edge variants of a function run over one layout each, alternating
#: (a dictionary transforms its entries with the flat code); the first
#: case of each function runs over both.
EDGES = ["replace to empty", "replace non-ASCII", "replace empty search",
         "lpad cuts", "rpad to -2", "locate from 3", "locate non-ASCII",
         "locate pos 0", "locate empty", "substring_index -2",
         "substring_index overlapping", "substring_index 0",
         "substring_index empty delim", "repeat 0"]
LAYOUT_CASES = [(name, layout) for name in CASES if name not in EDGES
                for layout in ("s", "f")] + [
    (name, "sf"[i % 2]) for i, name in enumerate(EDGES)]


@pytest.mark.parametrize("name,layout", LAYOUT_CASES,
                         ids=[f"{n}-{'dictionary' if c == 's' else 'flat'}"
                              for n, c in LAYOUT_CASES])
def test_string_function_matches_reference(both, name, layout):
    rb, pb = both
    got = check_expr(rb, pb, CASES[name](RS, RS2, rcol(layout), rlit),
                     CASES[name](S, S2, col(layout), lit))
    if got.is_string:
        # a dictionary input keeps its codes; a flat one stays flat
        assert got.is_dict == (layout == "s")
        if got.is_dict:
            assert got.codes is pb.column("s").codes


@pytest.mark.parametrize("name", list(MIXED))
def test_mixed_layouts_match_reference(both, name):
    rb, pb = both
    got = check_expr(rb, pb, MIXED[name](RS, RS2, rcol, rlit),
                     MIXED[name](S, S2, col, lit))
    assert got.is_flat


@pytest.mark.parametrize("layout", ["s", "f"], ids=["dictionary", "flat"])
@pytest.mark.parametrize("pad", ["lpad", "rpad"])
def test_empty_pad_only_cuts(both, pad, layout):
    """An empty pad cuts each string to its first 3 bytes and pads
    nothing, as the reference's CPU path and Spark do (its device path
    pads with a space instead)."""
    rb, pb = both
    cls = S2.LPad if pad == "lpad" else S2.RPad
    got = L.resolve(cls(col(layout), 3, ""), pb.schema).bind(
        pb.schema).eval_device(pb)
    source = port_strings(pb, pb.column(layout))
    assert port_strings(pb, got) == [None if v is None else v[:3]
                                     for v in source]
    assert source == ref_strings(rb, rb.column(layout))


def test_regular_expression_raises(both):
    _, pb = both
    for pattern in ("a.b", "^a", "a*", "(x)", "a|b", "\\d"):
        e = S2.RegExpReplace(col("s"), pattern, "_").bind(pb.schema)
        with pytest.raises(NotImplementedError, match="regular"):
            e.eval_device(pb)


def test_flat_inputs_build_no_char_matrix(both, monkeypatch):
    _, pb = both

    def refuse(*a, **k):
        raise AssertionError("a char matrix was built")
    for mod, names in ((SU, ("char_matrix", "_matrix_from_offsets",
                             "rows_matrix")),
                       (S, ("char_matrix",))):
        for n in names:
            monkeypatch.setattr(mod, n, refuse)
    for name, build in CASES.items():
        if name != "length":
            L.resolve(build(S, S2, col("f"), lit), pb.schema).bind(
                pb.schema).eval_device(pb)
    for build in MIXED.values():
        L.resolve(build(S, S2, col, lit), pb.schema).bind(
            pb.schema).eval_device(pb)
