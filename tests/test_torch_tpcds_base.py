"""The TPC-DS slice, first part: the generator and the reference's
default-tier queries but q36 (q1, q3, q6, q44, q51, q88, q98), the port
against the JAX package at the reference's own test scale, 2^13
store_sales rows, seed 11 (``tests/test_tpcds.py``). The other parts
are ``test_torch_tpcds_rollup.py`` and ``test_torch_tpcds_star1.py`` to
``star3.py``, and the second 33 queries' ``test_torch_tpcds_using.py``,
``_empty.py``, ``_returns.py``, ``_q47.py``, ``_q57.py``,
``_windows.py``, ``_q67.py``, ``_yoy.py`` and ``_exists.py``, and the
last 33's ``test_torch_tpcds_scalar.py``, ``_buckets.py``, ``_q54.py``,
``_q56.py``, ``_q64.py``, ``_q66.py`` and ``_q76.py``, split by the
reference's cost so that ``--dist loadfile`` spreads them; this file
holds the helpers.

The port's ``gen_tables`` equals the reference's bit for bit: every
table's columns, types, values, validity and dates. Each query runs
through ``TorchSession`` on the CPU (the kernels take their plain
versions, their wrappers counted) and through the reference's
``TpuSession`` with ``variableFloatAgg`` on. Each file holds one query
(its ``DEVICE``) against the reference's device path with its Pallas
gate on (interpret mode); the others against its CPU-oracle session
(``"cpu oracle"``: ``spark.rapids.sql.enabled`` off, ``ref_conf``),
which gives the same answers in under a second where the device path
takes 5-170 s a query here; and, where the budget allows (``GATE_OFF``),
every query against the device path with the gate off. q9 and q28,
whose device path takes the reference 97-264 s, meet it in the ``slow``
tier only. The table variants (``check_variant``) are held against
the CPU oracle too. Integer, string and date
columns are equal row for row in the query's order, nulls included;
float columns agree to rtol 1e-9. ``chip_smoke.py``'s numpy reference
of each query (``DS_REFS``) is held against the reference's answer by
the card's own check (``check_ds``: the ORDER BY's runs of equal keys
as sets), so a wrong numpy reference shows here and not on the card.
q1 and q68 also run over ``chip_smoke.ds_tn_stores``'s stores, the
card's ``ds_q1_tn`` and ``ds_q68_tn`` cells (``check_variant``, which
the other ``chip_smoke.DS_VARIANTS`` take too).
"""

import numpy as np
import pyarrow as pa
import pytest

import chip_smoke as CS
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.workloads import tpcds as rds
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops.kernels.cuda import hashing as HK
from spark_rapids_tpu_torch.ops.kernels.cuda import join_probe as JP
from spark_rapids_tpu_torch.ops.kernels.cuda import segmented as SEG
from spark_rapids_tpu_torch.ops.kernels.cuda import sort_steps as SS
from spark_rapids_tpu_torch.ops.kernels.cuda import strings as SG
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.workloads import tpcds

N_SS = 1 << 13
SEED = 11
REF_CONFS = {
    "pallas on": {"spark.rapids.tpu.pallas.enabled": True},
    "pallas off": {"spark.rapids.tpu.pallas.enabled": False},
    # the reference's CPU-oracle session (``tests/test_tpcds.py``'s ``cpu``)
    "cpu oracle": {"spark.rapids.sql.enabled": False},
}
#: The queries whose path calls no kernel wrapper: q9 and q28 aggregate
#: store_sales alone into one row under cross joins, q41 is a
#: ``distinct`` over item.
NO_KERNEL = {"q9", "q28", "q41"}
#: The kernel wrappers a query's path may call, by module and name.
WRAPPERS = [(JP, "dense_build_probe"), (SEG, "segment_reduce_sorted"),
            (SS, "packed_argsort"), (SG, "gather_strings"),
            (HK, "murmur3_string_rows"), (SG, "ragged_row_equal")]
RTOL = 1e-9


def ref_session(conf: dict) -> TpuSession:
    return TpuSession({"spark.rapids.sql.enabled": True,
                       "spark.rapids.sql.variableFloatAgg.enabled": True,
                       **conf})


class Ds:
    """One test module's TPC-DS run: both packages' tables at ``N_SS``,
    the port's answers with their kernel-wrapper calls, and the
    reference's answers, each computed once."""

    def __init__(self, queries):
        self.queries = list(queries)
        self.ref_tables = rds.gen_tables(N_SS, seed=SEED)
        self.port_tables = tpcds.gen_tables(N_SS, seed=SEED)
        self._ref_dfs, self._ref = {}, {}
        self.port = port_answers(self.port_tables, self.queries)

    def ref(self, q: str, conf: str = "pallas on") -> dict:
        if (q, conf) not in self._ref:
            if conf not in self._ref_dfs:
                self._ref_dfs[conf] = rds.load(ref_session(REF_CONFS[conf]),
                                               self.ref_tables)
            self._ref[q, conf] = ref_rows(
                rds.QUERIES[q](self._ref_dfs[conf]).collect())
        return self._ref[q, conf]


def port_answers(tables, queries) -> dict:
    """``{q: (rows, kernel-wrapper calls)}`` of the port on the CPU."""
    calls = {"n": 0}
    saved = [getattr(m, a) for m, a in WRAPPERS]

    def counting(fn):
        def wrapper(*a, **k):
            calls["n"] += 1
            return fn(*a, **k)
        return wrapper
    for (m, a), fn in zip(WRAPPERS, saved):
        setattr(m, a, counting(fn))
    try:
        dfs = tpcds.load(TorchSession(device="cpu"), tables)
        out = {}
        for q in queries:
            before = calls["n"]
            out[q] = (CS.ds_host_rows(tpcds.QUERIES[q](dfs).collect()),
                      calls["n"] - before)
    finally:
        for (m, a), fn in zip(WRAPPERS, saved):
            setattr(m, a, fn)
    return out


def ref_rows(table) -> dict:
    return {n: table.column(n).to_pylist() for n in table.column_names}


def assert_same_answer(got: dict, want: dict, q: str) -> None:
    """Columns and rows in order: floats (``CS.DS_FLOATS``) to ``RTOL``,
    everything else equal."""
    assert list(got) == list(want)
    floats = CS.DS_FLOATS.get(q, ())
    for n, w in want.items():
        g = got[n]
        assert len(g) == len(w), (n, len(g), len(w))
        if n in floats:
            for a, b in zip(g, w):
                assert (a is None) == (b is None), n
                assert a is None or a == b or abs(a - b) <= RTOL * abs(b), \
                    (n, a, b)
        else:
            assert g == w, n


def check_query(ds: Ds, q: str, conf: str) -> None:
    """The port's answer against the reference's ``conf`` session, or,
    for ``"numpy"``, against ``chip_smoke.py``'s numpy reference by the
    card's own check (``check_ds``)."""
    got, _ = ds.port[q]
    if conf == "numpy":
        n = len(next(iter(got.values())))
        assert CS.check_ds(q, got, CS.DS_REFS[q](ds.port_tables), q) == n
        return
    assert_same_answer(got, ds.ref(q, conf), q)


def ref_conf(q: str, device) -> str:
    """The reference session ``q`` is held against: its device path with
    the Pallas gate on (interpret mode) when ``q`` is one of ``device``,
    else its CPU-oracle session, which gives the same answers in a
    fraction of the time (the device path takes 5-170 s a query here)."""
    return "pallas on" if q in device else "cpu oracle"


def ref_cases(queries, device) -> list:
    """``(conf, q)`` of each query's comparison with the reference
    (:func:`ref_conf`)."""
    return [(ref_conf(q, device), q) for q in queries]


def gate_off_cases(gate_off, numpy) -> list:
    """``(conf, q)`` of the second comparison of each query of
    ``gate_off``: against the reference's device path with its Pallas gate
    off, or, for the queries of ``numpy`` (whose gate-off path takes over
    5 s here once the gate-on path no longer compiles their pieces first),
    against ``chip_smoke.py``'s numpy reference (:func:`check_query`)."""
    return [("numpy" if q in numpy else "pallas off", q) for q in gate_off]


def check_numpy_reference(ds: Ds, q: str, conf: str = "pallas on") -> None:
    want = ds.ref(q, conf)
    assert CS.check_ds(q, want, CS.DS_REFS[q](ds.port_tables), q) \
        == len(next(iter(want.values())))


def check_wrapper_calls(ds: Ds) -> None:
    """Every query's path calls a kernel wrapper (its dimension joins
    take the direct-address ``joinProbe`` at least), but those of
    ``NO_KERNEL``, which call none."""
    assert {q: n > 0 for q, (_, n) in ds.port.items()} \
        == {q: q not in NO_KERNEL for q in ds.port}


def check_variant(ds: Ds, variant: str, conf: str = "cpu oracle") -> None:
    """The query of ``chip_smoke.DS_VARIANTS[variant]`` over that
    variant's tables (the card's ``ds_<variant>`` cell): the port, the
    reference (its ``conf`` session: the CPU oracle unless named) and the
    numpy reference agree, with rows."""
    q, make = CS.DS_VARIANTS[variant]
    port_tables = make(ds.port_tables)
    ref_tables = dict(ds.ref_tables, **{
        n: _to_arrow(hb) for n, hb in port_tables.items()
        if hb is not ds.port_tables[n]})
    got = CS.ds_host_rows(tpcds.QUERIES[q](tpcds.load(
        TorchSession(device="cpu"), port_tables)).collect())
    want = ref_rows(rds.QUERIES[q](rds.load(
        ref_session(REF_CONFS[conf]), ref_tables)).collect())
    assert len(next(iter(want.values()))) > 0
    assert_same_answer(got, want, q)
    assert CS.check_ds(variant, want, CS.DS_REFS[variant](ds.port_tables),
                       variant) > 0


QUERIES = ["q1", "q3", "q6", "q44", "q51", "q88", "q98"]
#: Held against the reference's device path with the Pallas gate on (and,
#: as every query here, off); the rest against its CPU oracle.
DEVICE = ["q3"]
#: Their gate-off comparison against the numpy reference instead.
NUMPY = ["q1", "q6", "q44", "q51", "q88", "q98"]


@pytest.fixture(scope="module")
def ds():
    return Ds(QUERIES)


@pytest.mark.parametrize("name", list(rds.gen_tables(64, seed=1)))
def test_generator_matches_reference(name, ds):
    """Every column of ``name``: the reference's names and order, the
    same SQL type (``d_date`` DATE), values and validity bit for bit."""
    rb, hb = ds.ref_tables[name], ds.port_tables[name]
    assert rb.schema.names == list(hb.columns)
    for field in rb.schema:
        arr = rb.column(field.name)
        want_type = {pa.int64(): T.LONG, pa.float64(): T.DOUBLE,
                     pa.string(): T.STRING, pa.date32(): T.DATE}[field.type]
        assert hb.schema[field.name].data_type is want_type, field.name
        valid = ~np.asarray(arr.is_null())
        np.testing.assert_array_equal(hb.validity[field.name], valid)
        got = hb.columns[field.name][valid]
        arr = arr.drop_null()
        if field.type == pa.date32():
            arr = arr.cast(pa.int32())
        want = arr.to_numpy(zero_copy_only=False)
        if field.type == pa.string():
            assert got.tolist() == want.tolist(), field.name
        else:
            assert got.dtype == want.dtype, field.name
            assert got.tobytes() == want.tobytes(), field.name


@pytest.mark.parametrize("conf,q", ref_cases(QUERIES, DEVICE)
                         + gate_off_cases(QUERIES, NUMPY))
def test_query_matches_reference(q, conf, ds):
    check_query(ds, q, conf)


@pytest.mark.parametrize("q", QUERIES)
def test_numpy_reference_matches_reference(q, ds):
    check_numpy_reference(ds, q, ref_conf(q, DEVICE))


def test_query_paths_call_the_kernel_wrappers(ds):
    check_wrapper_calls(ds)


def _to_arrow(hb) -> pa.RecordBatch:
    return pa.RecordBatch.from_arrays(
        [pa.array(hb.columns[n], mask=~hb.validity[n],
                  type=pa.date32() if hb.schema[n].data_type is T.DATE
                  else None) for n in hb.columns],
        names=list(hb.columns))


@pytest.mark.parametrize("q", ["q1", "q68"])
def test_query_over_tn_stores(q, ds):
    """q1 and q68 over stores 0, 4 and 8 moved to Oak Grove, TN (the
    card's ``ds_q1_tn`` and ``ds_q68_tn``): the port, the reference and
    the numpy reference agree, with rows."""
    check_variant(ds, f"{q}_tn")
