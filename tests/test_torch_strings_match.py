"""``EndsWith`` and ``Contains`` (``spark_rapids_tpu_torch/ops/strings.py``)
against the JAX package's ``eval_device``, on a dictionary column and on
a flat column built from it by the reference (``substring(s, 1, 64)``),
in a batch with dead rows and nulls: the empty needle, one byte, whole
words, multi-byte UTF-8, a match at byte 0 and at the last byte, a
needle that spans two rows' payloads (it must not count: rows
``"xxab"``, ``"cdyy"`` lie next to each other in the flat payload), and
needles longer than each column's ``max_bytes``. Every answer is also
the plain Python one, and on a flat column neither builds a char matrix.
"""

import numpy as np
import pyarrow as pa
import pytest

import jax.numpy as jnp
import torch

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.data.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.ops import strings as RS
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit
from spark_rapids_tpu.ops.kernels import rowops as RKR
from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops import strings as S
from spark_rapids_tpu_torch.ops import strings_util as SU
from spark_rapids_tpu_torch.ops.expression import col

from test_torch_ops import assert_column, port_schema, ref_fields
from test_torch_strings import rbind

WORDS = np.array(["xxab", "cdyy", "", "ab", "abcd", "special requests",
                  "requests are special", "Customer Complaints", "Ärger",
                  "naïve café", "b", "cab", "yy", "PROMO BRUSHED"])
#: rows 0-3 lie next to each other in the payload: "xxab" + "cdyy" holds
#: "abcd" and "xabc" across the row boundary only
FIRST = ["xxab", "cdyy", "abcd", "cab"]
NEEDLES = ["", "a", "b", "ab", "abcd", "xabc", "bcdy", "yy", "x",
           "special", "requests", "Complaints", "Ä", "é", "ïve", "café",
           "BRUSHED", "special requests", "z" * 40, "q" * 100]


def table(n: int = 800, seed: int = 21) -> pa.RecordBatch:
    rng = np.random.default_rng(seed)
    s = WORDS[rng.integers(0, len(WORDS), n)]
    s[:len(FIRST)] = FIRST
    mask = rng.random(n) < 0.1
    mask[:len(FIRST)] = False
    return pa.RecordBatch.from_arrays(
        [pa.array(s, pa.string(), mask=mask),
         pa.array(rng.integers(0, 50, n), pa.int64())], names=["s", "k"])


@pytest.fixture(scope="module")
def strings():
    rb = RBatch.from_arrow(table())
    keep = np.random.default_rng(22).random(rb.capacity) < 0.85
    keep[:len(FIRST)] = True
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


def _plain(pb, column: str, name: str, needle: str):
    """The plain Python answer of every live row, and its validity."""
    host = HostBatch.from_device(pb.with_columns(
        [pb.column(column)], T.Schema([T.StructField("v", T.STRING)])))
    raw = needle.encode()
    fn = {"EndsWith": lambda b: b.endswith(raw),
          "Contains": lambda b: raw in b}[name]
    return (np.array([fn(str(v).encode()) for v in host.columns["v"]]),
            host.validity["v"])


@pytest.mark.parametrize("column", ["s", "f"], ids=["dictionary", "flat"])
@pytest.mark.parametrize("needle", NEEDLES,
                         ids=[f"{len(n.encode())} bytes {i}"
                              for i, n in enumerate(NEEDLES)])
@pytest.mark.parametrize("name", ["EndsWith", "Contains"])
def test_match_equals_reference(name, needle, column, strings):
    rb, pb = strings
    assert pb.column(column).is_dict == (column == "s")
    want = getattr(RS, name)(rcol(column), needle).bind(rb.schema) \
        .eval_device(rb)
    got = getattr(S, name)(col(column), needle).bind(pb.schema) \
        .eval_device(pb)
    assert got.dtype is T.BOOLEAN
    assert_column(got, want, rb.row_mask())
    live = np.asarray(rb.row_mask())
    expect, valid = _plain(pb, column, name, needle)
    got_live = got.data.numpy()[live]
    if len(needle.encode()) <= pb.column(column).max_bytes:
        np.testing.assert_array_equal(got_live[valid], expect[valid])
    else:
        assert not got_live.any()
    assert not got.validity.numpy()[live][~valid].any()


@pytest.mark.parametrize("name,needle,want", [
    ("Contains", "abcd", [False, False, True, False]),
    ("Contains", "xabc", [False, False, False, False]),
    ("Contains", "bcdy", [False, False, False, False]),
    ("Contains", "xx", [True, False, False, False]),   # at byte 0
    ("Contains", "yy", [False, True, False, False]),   # at the last byte
    ("EndsWith", "ab", [True, False, False, True]),
    ("EndsWith", "abcd", [False, False, True, False]),
    ("EndsWith", "bcdyy", [False, False, False, False]),
])
def test_flat_rows_next_to_each_other(name, needle, want, strings):
    """The first four rows lie next to each other in the flat payload: a
    needle across two of them matches neither."""
    _, pb = strings
    f = pb.column("f")
    assert f.offsets[:5].tolist() == [0, 4, 8, 12, 15]
    got = getattr(S, name)(col("f"), needle).bind(pb.schema).eval_device(pb)
    assert got.data[:4].tolist() == want


@pytest.mark.parametrize("name", ["EndsWith", "Contains", "StartsWith"])
def test_flat_match_builds_no_char_matrix(name, strings, monkeypatch):
    """Like ``check_no_char_matrix`` on the card: every function of the
    package that builds a char matrix refuses while a flat column is
    matched."""
    _, pb = strings

    def refuse(*a, **k):
        raise AssertionError("a char matrix was built")

    for mod in (S, SU):
        for fn in ("char_matrix", "_matrix_from_offsets"):
            if hasattr(mod, fn):
                monkeypatch.setattr(mod, fn, refuse)
    for needle in ("ab", "special", "é"):
        out = getattr(S, name)(col("f"), needle).bind(pb.schema) \
            .eval_device(pb)
        assert out.data.dtype == torch.bool
        assert out.data.shape == (pb.capacity,)
