"""``DataFrame.join(on=<column name or names>)``, SQL's ``USING`` form,
against the JAX package on the CPU.

Each name is the key on both sides. Both sides' key columns stay in the
output, as the reference keeps them: an inner or left join yields each
key name twice (the left column first), and a later ``col(name)`` reads
the left one. Keys of every kind the TPC-DS queries join on this way:
an int, a dictionary string (the two sides with different
dictionaries), a flat string (``Substring``), a DATE, and q38's triple
of two dictionary strings and a DATE; each with nulls (a null key
matches nothing: the semi join drops its row, the anti join keeps it)
and duplicate keys on both sides. Inner, left, left semi and left anti
joins, ``on="k"`` and ``on=["k"]``: the same column names in the same
order and the same rows as the reference. All inputs come from a numpy
seed.
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit
from spark_rapids_tpu.ops.strings import Substring as RSubstring
from spark_rapids_tpu.session import TpuSession

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.ops.strings import Substring
from spark_rapids_tpu_torch.session import TorchSession
from test_torch_joins_general import _rows_of

HOWS = ["inner", "left", "left_semi", "left_anti"]
#: case -> the key names it joins on
CASES = {"int": ["k"], "dictionary string": ["s"], "flat string": ["fs"],
         "date": ["d"], "two strings and a date": ["s", "s2", "d"]}
#: The case held against the reference's device path (with its
#: ``test.enabled`` check that the join ran there); the others against
#: its CPU-oracle session, whose device path takes 5-36 s a case here.
DEVICE_CASES = ("int",)
NAMES = np.array(["Smith", "Johnson", "Brown", "Jones", "Miller", "Davis",
                  "", "Ünal"])


def _side(rng, n: int, names: np.ndarray, tag: str) -> dict:
    """One side: keys with duplicates and about 10 % nulls, and a value
    column ``v_<tag>`` (its row number)."""
    return {
        "k": (rng.integers(0, 25, n).astype(np.int64), rng.random(n) > 0.1),
        "s": (names[rng.integers(0, len(names), n)], rng.random(n) > 0.1),
        "s2": (names[rng.integers(0, 4, n)], rng.random(n) > 0.1),
        "d": (rng.integers(10_000, 10_012, n).astype(np.int32),
              rng.random(n) > 0.1),
        f"v_{tag}": (np.arange(n, dtype=np.int64), np.ones(n, bool)),
    }


TYPES = {"k": T.LONG, "s": T.STRING, "s2": T.STRING, "d": T.DATE}


def _port_df(session, data: dict):
    schema = T.Schema([T.StructField(n, TYPES.get(n, T.LONG)) for n in data])
    df = session.create_dataframe(HostBatch.from_numpy(
        {n: v for n, (v, _) in data.items()}, schema,
        {n: ok for n, (_, ok) in data.items()}))
    return df.select(*[col(n) for n in data],
                     Substring(col("s"), lit(1), lit(100)).alias("fs"))


def _ref_df(session, data: dict):
    arrow = {"k": pa.int64(), "s": pa.string(), "s2": pa.string(),
             "d": pa.date32()}
    rb = pa.RecordBatch.from_arrays(
        [pa.array(v, arrow.get(n, pa.int64()), mask=~ok)
         for n, (v, ok) in data.items()], names=list(data))
    df = session.create_dataframe(rb)
    return df.select(*[rcol(n) for n in data],
                     RSubstring(rcol("s"), rlit(1), rlit(100)).alias("fs"))


def _port_columns(hb) -> tuple:
    """(names, positional columns as lists, ``None`` for a null)."""
    cols = []
    for i in range(len(hb.schema.names)):
        values, valid = hb.column_at(i)
        cols.append([(v.item() if hasattr(v, "item") else v) if ok else None
                     for v, ok in zip(values, valid)])
    return hb.schema.names, cols


def _ref_columns(table) -> tuple:
    cols = []
    for i in range(table.num_columns):
        c = table.column(i)
        if pa.types.is_date32(c.type):
            c = c.cast(pa.int32())
        cols.append(c.to_pylist())
    return table.column_names, cols


def _answers(case: str, how: str, on):
    rng = np.random.default_rng(len(case) * 7 + len(how))
    left = _side(rng, 300, NAMES, "l")
    right = _side(rng, 120, NAMES[2:], "r")
    session = TorchSession(device="cpu")
    got = _port_df(session, left).join(_port_df(session, right), on=on,
                                       how=how).collect()
    rs = TpuSession({"spark.rapids.sql.enabled": True,
                     "spark.rapids.sql.test.enabled": True}
                    if case in DEVICE_CASES
                    else {"spark.rapids.sql.enabled": False})
    want = _ref_df(rs, left).join(_ref_df(rs, right), on=on,
                                  how=how).collect()
    return _port_columns(got), _ref_columns(want)


FORMS = [(case, how, "list") for case in CASES for how in HOWS] + \
    [(case, how, "name") for case, keys in CASES.items() if len(keys) == 1
     for how in HOWS]


@pytest.mark.parametrize("case,how,form", FORMS)
def test_using_join_matches_reference(case, how, form):
    keys = CASES[case]
    on = keys[0] if form == "name" else list(keys)
    (names, cols), (want_names, want_cols) = _answers(case, how, on)
    assert names == want_names
    if how in ("inner", "left"):
        for k in keys:  # both sides' key columns are kept
            assert names.count(k) == 2
    assert _rows_of(dict(enumerate(cols))) == \
        _rows_of(dict(enumerate(want_cols)))
    assert len(cols[0]) > 0
    if how == "left_anti":
        # rows whose key is null survive the anti join
        lead = names.index(keys[0])
        assert None in cols[lead]


@pytest.mark.parametrize("how", ["inner", "left"])
def test_a_later_column_reads_the_left_key(how):
    """After an inner or left ``USING`` join, ``col(name)`` reads the
    left side's key column (for a left join, never null-extended), as in
    the reference."""
    rng = np.random.default_rng(5)
    left = _side(rng, 200, NAMES, "l")
    right = _side(rng, 80, NAMES[2:], "r")
    got = _port_df(TorchSession(device="cpu"), left).join(
        _port_df(TorchSession(device="cpu"), right), on=["k", "s"],
        how=how).select(col("k"), col("s"), col("v_r")).collect()
    rs = TpuSession({"spark.rapids.sql.enabled": True})
    want = _ref_df(rs, left).join(_ref_df(rs, right), on=["k", "s"],
                                  how=how).select(
        rcol("k"), rcol("s"), rcol("v_r")).collect()
    names, cols = _port_columns(got)
    want_names, want_cols = _ref_columns(want)
    assert names == want_names == ["k", "s", "v_r"]
    assert _rows_of(dict(enumerate(cols))) == \
        _rows_of(dict(enumerate(want_cols)))


def test_duplicate_names_survive_collect_and_concat():
    """A batch whose schema repeats a name keeps every column by position
    (``HostBatch.column_at``) through ``concat``; ``columns`` holds the
    first column of each name."""
    schema = T.Schema([T.StructField("k", T.LONG), T.StructField("k", T.LONG)])
    a = HostBatch.from_positional(schema, [
        (np.array([1, 2]), np.array([True, True])),
        (np.array([7, 8]), np.array([True, False]))])
    b = HostBatch.from_positional(schema, [
        (np.array([3]), np.array([True])), (np.array([9]), np.array([True]))])
    both = HostBatch.concat([a, b])
    assert both.column_at(0)[0].tolist() == [1, 2, 3]
    assert both.column_at(1)[0].tolist() == [7, 8, 9]
    assert both.column_at(1)[1].tolist() == [True, False, True]
    assert both.columns["k"].tolist() == [1, 2, 3]
    assert HostBatch.empty(schema).column_at(1)[0].tolist() == []


@pytest.mark.parametrize("on", [[], [1], "k k".split() + [None]])
def test_bad_using_keys_raise(on):
    session = TorchSession(device="cpu")
    data = _side(np.random.default_rng(0), 8, NAMES, "l")
    df = _port_df(session, data)
    with pytest.raises(TypeError):
        df.join(df, on=on)
