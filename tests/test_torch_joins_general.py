"""The general equi-join matcher (``join_match``) and the join types it
serves — inner, left outer, left semi and left anti — against the JAX
package on the CPU.

``join_match`` is held against the reference's on the same key columns:
two int keys, a float key (NaN joins NaN, -0.0 joins 0.0), a string key
over two dictionaries, a flat string key, and a string and an int key,
with null keys, dead rows, duplicate build keys and probe keys that
match nothing; every probe row's count and its build rows, in order,
must be equal. Then each join type through both sessions (the
reference's ``hash_join_kernel`` path) on one int key (the port's
direct-address route, and its exact route forced), two int keys of
mixed width, a string key and a float key: the row sets must be equal.
All inputs come from a numpy seed.
"""

import numpy as np
import pyarrow as pa
import pytest

import jax.numpy as jnp
import torch

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.data.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.kernels import join as RKJ
from spark_rapids_tpu.session import TpuSession

from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.exec import execs as E
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops.expression import col
from spark_rapids_tpu_torch.ops.kernels import join as KJ
from spark_rapids_tpu_torch.session import TorchSession
from test_torch_groupids import _flat
from test_torch_ops import ref_fields

WORDS = np.array(["AIR", "FOB", "MAIL", "", "REG AIR", "ÄRGER", "x" * 20,
                  "ZZ"])
MATCH_CASES = ["two int keys", "float key", "dictionary string key",
               "flat string key", "string and int keys"]
HOWS = ["inner", "left", "left_semi", "left_anti"]


def _side(rng, n: int, words: np.ndarray, lo: int, hi: int):
    """One side's arrow batch: int keys ``a`` (nullable) and ``b``, a
    float key ``f`` with NaN and -0.0, a string key ``s``."""
    f = np.array([0.0, -0.0, np.nan, 1.5, 2.5, -7.0])[rng.integers(0, 6, n)]
    s = words[rng.integers(0, len(words), n)]
    smask = rng.random(n) < 0.1
    rb = RBatch.from_arrow(pa.RecordBatch.from_arrays([
        pa.array(rng.integers(lo, hi, n), pa.int64(),
                 mask=rng.random(n) < 0.1),
        pa.array(rng.integers(0, 3, n), pa.int64()),
        pa.array(f, pa.float64(), mask=rng.random(n) < 0.1),
        pa.array(s, pa.string(), mask=smask),
    ], names=["a", "b", "f", "s"]))
    return rb, _flat(s, smask, rb.capacity)


def _keys(name: str, rb, flat):
    ref = {"two int keys": [rb.column(0), rb.column(1)],
           "float key": [rb.column(2)],
           "dictionary string key": [rb.column(3)],
           "flat string key": [flat],
           "string and int keys": [rb.column(3), rb.column(1)]}[name]
    types = [T.STRING if c.is_string else
             T.DOUBLE if name == "float key" else T.LONG for c in ref]
    port = [carry.column_from_reference(ref_fields(c), t, device="cpu")
            for c, t in zip(ref, types)]
    return ref, port


@pytest.mark.parametrize("name", MATCH_CASES)
def test_join_match_matches_reference(name):
    rng = np.random.default_rng(len(name))
    # two dictionaries with different entries; probe int keys reach past
    # the build's range, so some probe rows match nothing
    brb, bflat = _side(rng, 200, WORDS[:6], 0, 40)
    prb, pflat = _side(rng, 300, WORDS[2:], 20, 80)
    rbk, bk = _keys(name, brb, bflat)
    rpk, pk = _keys(name, prb, pflat)
    live_b = rng.random(brb.capacity) < 0.9
    live_p = rng.random(prb.capacity) < 0.9
    lo, counts, at_rank = KJ.join_match(bk, pk, torch.as_tensor(live_b),
                                        torch.as_tensor(live_p))
    rlo, rcounts, rat_rank, _ = RKJ.join_match(rbk, rpk, jnp.asarray(live_b),
                                               jnp.asarray(live_p))
    lo, counts, at_rank = lo.numpy(), counts.numpy(), at_rank.numpy()
    rlo, rcounts, rat_rank = (np.asarray(x) for x in (rlo, rcounts, rat_rank))
    np.testing.assert_array_equal(counts, rcounts)
    assert counts.sum() > 0 and (counts[live_p] == 0).any()
    assert (counts > 1).any()  # duplicate build keys
    for i in np.flatnonzero(counts):
        assert list(at_rank[lo[i]:lo[i] + counts[i]]) == \
            list(rat_rank[rlo[i]:rlo[i] + rcounts[i]]), i


def test_join_match_refuses_build_hits():
    rng = np.random.default_rng(1)
    rb, flat = _side(rng, 20, WORDS, 0, 5)
    _, keys = _keys("two int keys", rb, flat)
    live = torch.ones(rb.capacity, dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="full and right"):
        KJ.join_match(keys, keys, live, live, need_build_hits=True)


JOIN_CASES = ["one int key (dense)", "one int key (exact)",
              "two int keys of mixed width", "string key", "float key"]


def _join_data(case: str, seed: int = 0):
    """Probe and build tables as numpy columns with validity, and their
    SQL types (``pk2`` is INT against the build's LONG ``bk2``)."""
    rng = np.random.default_rng(seed)
    n_p, n_b = 400, 150
    if case == "one int key (dense)":
        bk = rng.permutation(200)[:n_b].astype(np.int64)  # unique
    else:
        bk = rng.integers(0, 120, n_b).astype(np.int64)   # duplicates
    probe = {"pk": rng.integers(0, 200, n_p).astype(np.int64),
             "pk2": rng.integers(0, 3, n_p).astype(np.int32),
             "pf": np.array([0.0, -0.0, np.nan, 1.5, 3.0])[
                 rng.integers(0, 5, n_p)],
             "ps": WORDS[rng.integers(1, 8, n_p)],
             "pv": np.arange(n_p, dtype=np.int64)}
    build = {"bk": bk, "bk2": rng.integers(0, 3, n_b).astype(np.int64),
             "bf": np.array([0.0, np.nan, 1.5, 2.0])[rng.integers(0, 4, n_b)],
             "bs": WORDS[rng.integers(0, 6, n_b)],
             "bv": np.arange(n_b, dtype=np.int64)}
    pvalid = {k: rng.random(n_p) > 0.1 for k in ("pk", "pf", "ps")}
    bvalid = {k: rng.random(n_b) > 0.1 for k in ("bk", "bf", "bs")}
    if case == "one int key (dense)":
        bvalid["bk"][:] = True
    types = {"pk": T.LONG, "pk2": T.INT, "pf": T.DOUBLE, "ps": T.STRING,
             "pv": T.LONG, "bk": T.LONG, "bk2": T.LONG, "bf": T.DOUBLE,
             "bs": T.STRING, "bv": T.LONG}
    return (probe, pvalid), (build, bvalid), types


def _on(case: str, P_, c):
    if case.startswith("one int key"):
        return P_.EqualTo(c("pk"), c("bk"))
    if case == "two int keys of mixed width":
        return P_.And(P_.EqualTo(c("pk"), c("bk")),
                      P_.EqualTo(c("pk2"), c("bk2")))
    if case == "string key":
        return P_.EqualTo(c("ps"), c("bs"))
    return P_.EqualTo(c("pf"), c("bf"))


def _rows_of(columns: dict) -> list:
    def canon(v):
        if isinstance(v, float) and v != v:
            return "NaN"
        return 0.0 if isinstance(v, float) and v == 0 else v
    names = list(columns)
    return sorted((tuple(canon(v) for v in r)
                   for r in zip(*(columns[n] for n in names))), key=repr)


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("case", JOIN_CASES)
def test_join_types_match_reference(case, how):
    (probe, pvalid), (build, bvalid), types = _join_data(case)
    rtypes = {T.LONG: RT.LONG, T.INT: RT.INT, T.DOUBLE: RT.DOUBLE,
              T.STRING: RT.STRING}

    def port_df(session, data, valid):
        schema = T.Schema([T.StructField(n, types[n]) for n in data])
        return session.create_dataframe(
            HostBatch.from_numpy(data, schema, valid))

    def ref_df(session, data, valid):
        schema = RT.Schema([RT.StructField(n, rtypes[types[n]])
                            for n in data])
        return session.create_dataframe(
            {n: [v.item() if valid.get(n, np.ones(len(a), bool))[i]
                 else None for i, v in enumerate(a)]
             for n, a in data.items()}, schema)

    session = TorchSession(device="cpu")
    df = port_df(session, probe, pvalid).join(
        port_df(session, build, bvalid), on=_on(case, P, col), how=how)
    calls = {"dense": 0}
    dense = KJ.dense_join

    def count(*a, **k):
        calls["dense"] += 1
        return dense(*a, **k)

    KJ.dense_join = count
    try:
        if case == "one int key (exact)":
            # the join is site 0; mode 2 takes every join type to the
            # exact search
            got = E.collect(session.plan(df._plan),
                            E.ExecContext(torch.device("cpu"), {0: 2}))
        else:
            got = df.collect()
    finally:
        KJ.dense_join = dense
    assert calls["dense"] == (1 if case == "one int key (dense)" else 0)

    rs = TpuSession({"spark.rapids.sql.enabled": True,
                     "spark.rapids.sql.test.enabled": True})
    want = ref_df(rs, probe, pvalid).join(
        ref_df(rs, build, bvalid), on=_on(case, RP, rcol),
        how=how).collect()
    got_cols = {n: [(v.item() if hasattr(v, "item") else v) if ok else None
                    for v, ok in zip(got.columns[n], got.validity[n])]
                for n in got.columns}
    want_cols = {n: want.column(n).to_pylist() for n in want.column_names}
    assert list(got_cols) == list(want_cols)
    assert _rows_of(got_cols) == _rows_of(want_cols)
    if how == "left":
        assert got.num_rows >= len(probe["pk"])
        assert not all(got.validity["bv"])  # unmatched rows null-extended
    assert got.num_rows > 0
