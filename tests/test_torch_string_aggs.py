"""String ``Min``, ``Max``, ``First`` and ``Last`` (``ops/aggregates.py``,
``exec/execs.py string_agg_lane``) on every group-by path of the port,
against the JAX package's answers, the port on the CPU.

The reference's device path does not take string aggregates (its
segment reductions meet a dictionary's payload lane and fail), so the
answers come from its CPU-oracle session (``spark.rapids.sql.enabled``
off), the same frames through pyarrow. The children are a dictionary
column with nulls, its flat copy (``substring``) and an unsorted
dictionary with repeated entries (``upper`` of the entries); the groups come from a sorted
dictionary key (the dictionary path), an int key (the dense path), a
flat key (the sort path), no key (the global path), and an int key
after a round-robin repartition into 3 batches (partials merged). Each
run must take the path it names.
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.ops import aggregates as RA
from spark_rapids_tpu.ops import strings as RS
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops import strings as S
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.ops.kernels import groupby as KG
from spark_rapids_tpu_torch.session import TorchSession

WORDS = np.array(["b", "a", "", "ab", "abc", "zz", "Ärger", "a b", "abd",
                  "naïve", "B", "~"])
N = 1500


def _data():
    rng = np.random.default_rng(61)
    s = WORDS[rng.integers(0, len(WORDS), N)]
    s_null = rng.random(N) < 0.2
    k = rng.integers(0, 9, N)
    k[:40] = 8  # group 8: mostly nulls
    s_null[:40] = True
    s_null[40] = False
    g = np.array(["g1", "g2", "g3", "g4"])[rng.integers(0, 4, N)]
    return s, s_null, k, g


@pytest.fixture(scope="module")
def frames():
    s, s_null, k, g = _data()
    port = TorchSession(device="cpu").create_dataframe(HostBatch.from_numpy(
        {"s": s, "k": k, "g": g}, validity={"s": ~s_null}))
    ref = TpuSession({"spark.rapids.sql.enabled": False}).create_dataframe(
        pa.RecordBatch.from_arrays(
            [pa.array(s, pa.string(), mask=s_null), pa.array(k),
             pa.array(g)], names=["s", "k", "g"]))
    port = port.with_column("f", S.Substring(col("s"), lit(1), lit(64))) \
        .with_column("r", S.Upper(col("s"))) \
        .with_column("gf", S.Substring(col("g"), lit(1), lit(8)))
    ref = ref.with_column("f", RS.Substring(rcol("s"), rlit(1), rlit(64))) \
        .with_column("r", RS.Upper(rcol("s"))) \
        .with_column("gf", RS.Substring(rcol("g"), rlit(1), rlit(8)))
    return port, ref


def _aggs(M, c, child):
    return [M.AggregateExpression(M.Min(c(child)), "mn"),
            M.AggregateExpression(M.Max(c(child)), "mx"),
            M.AggregateExpression(M.First(c(child)), "fi"),
            M.AggregateExpression(M.Last(c(child)), "la")]


def _rows(cols: dict, key) -> list:
    n = len(next(iter(cols.values())))
    rows = [tuple(cols[c][i] for c in [key] + ["mn", "mx", "fi", "la"]
                  if c is not None) for i in range(n)]
    return sorted(rows, key=repr)


#: path -> (grouping key or None, the port's kernel it must take,
#: repartition first)
PATHS = {
    "dictionary": ("g", "_dict_grouped_aggregate", False),
    "dense": ("k", "_dense_int_aggregate", False),
    "sort": ("gf", "_sort_grouped_aggregate", False),
    "global": (None, "global_aggregate", False),
    "merged partials": ("k", "_dense_int_aggregate", True),
}


@pytest.mark.parametrize("child", ["s", "f", "r"],
                         ids=["dictionary", "flat", "unsorted dictionary"])
@pytest.mark.parametrize("path", list(PATHS))
def test_string_aggregates_match_reference(frames, path, child, monkeypatch):
    port, ref = frames
    key, kernel, repart = PATHS[path]
    calls = []
    fn = getattr(KG, kernel)

    def spy(*a, **k):
        calls.append(kernel)
        return fn(*a, **k)
    monkeypatch.setattr(KG, kernel, spy)
    if repart:
        port = port.repartition(3)
        ref = ref.repartition(3)
    if key is None:
        got = port.group_by().agg(*_aggs(A, col, child)).collect()
        want = ref.group_by().agg(*_aggs(RA, rcol, child)).collect()
    else:
        got = port.group_by(col(key)).agg(*_aggs(A, col, child)).collect()
        want = ref.group_by(rcol(key)).agg(
            *_aggs(RA, rcol, child)).collect()
    assert calls, f"the {path} path was not taken"
    g = {name: [v if ok else None for v, ok in
                zip(got.columns[name], got.validity[name])]
         for name in got.columns}
    g = {name: [v.item() if hasattr(v, "item") else v for v in vals]
         for name, vals in g.items()}
    w = {name: want.column(name).to_pylist() for name in want.column_names}
    assert _rows(g, key) == _rows(w, key)


def test_unsorted_dictionary_child_is_unsorted(frames):
    port, _ = frames
    from spark_rapids_tpu_torch.exec import execs as E
    [[batch]] = port._session.plan(port._plan).execute(
        E.ExecContext(port._session.device))
    r = batch.column("r")
    assert r.is_dict and not r.dict_sorted
    assert len(set(r.dictionary)) < r.dict_size  # "b" and "B" both "B"
    assert batch.column("f").is_flat


def test_empty_groups_give_null_strings(frames):
    """Group 8 holds one valid string among nulls; a filter that keeps
    only null strings gives a null min, max, first and last."""
    port, _ = frames
    from spark_rapids_tpu_torch.ops import predicates as P
    out = port.where(P.IsNull(col("s"))).group_by(col("k")).agg(
        *_aggs(A, col, "f")).collect()
    assert len(out.columns["k"]) > 0
    for name in ("mn", "mx", "fi", "la"):
        assert not out.validity[name].any()


def test_sum_of_a_string_raises(frames):
    """Only min, max, first, last and count take strings; the
    reference's CPU oracle refuses a string sum too."""
    port, ref = frames
    with pytest.raises(NotImplementedError, match="Sum of a string"):
        port.group_by(col("k")).agg(
            A.AggregateExpression(A.Sum(col("f")), "x")).collect()
    with pytest.raises(Exception):
        ref.group_by(rcol("k")).agg(
            RA.AggregateExpression(RA.Sum(rcol("s")), "x")).collect()
