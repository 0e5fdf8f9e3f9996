"""The TPCxBB queries beyond the bench suite's three, first part: q02,
q03, q04, q06, q07, q08 and q09, the port against the JAX package at
2^14 clicks, seed 23 (the other parts are ``test_torch_tpcxbb_rest2.py``
to ``rest4.py``, split so that ``--dist loadfile`` spreads them).

Each query runs through ``TorchSession`` on the CPU (the kernels take
their plain versions, their wrappers counted) and through the
reference's ``TpuSession`` with ``variableFloatAgg`` on: its device path
with the Pallas gate on (interpret mode) for a file's ``DEVICE`` queries
(those whose device path takes under about 5 s here, and one more),
its CPU-oracle session (``spark.rapids.sql.enabled`` off) for the
others, and its device path with the gate off for the queries whose path
calls a kernel wrapper. Integer, string and date columns are equal row
for row in the query's order; float columns agree to rtol 1e-9.
``chip_smoke.py``'s numpy reference of each query is held against the
same reference answer, so a wrong numpy reference shows here and not on
the card.

This part also runs q02 over ``chip_smoke.q02_pivot_clicks``'s tables
(at this scale and seed q02 finds three rows; at 2^22 clicks, seed 42,
none), and q07, which returns no row at 2^14 clicks, over the item
table of 2^17.
"""

import numpy as np
import pyarrow as pa
import pytest

import chip_smoke as CS
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.workloads import tpcxbb as rxbb
from spark_rapids_tpu_torch.ops.kernels.cuda import hashing as HK
from spark_rapids_tpu_torch.ops.kernels.cuda import join_probe as JP
from spark_rapids_tpu_torch.ops.kernels.cuda import segmented as SEG
from spark_rapids_tpu_torch.ops.kernels.cuda import sort_steps as SS
from spark_rapids_tpu_torch.ops.kernels.cuda import strings as SG
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.workloads import tpcxbb

N_CLICKS = 1 << 14
SEED = 23
REF_CONFS = {
    "pallas on": {"spark.rapids.tpu.pallas.enabled": True},
    "pallas off": {"spark.rapids.tpu.pallas.enabled": False},
    # the reference's CPU-oracle session (``spark.rapids.sql.enabled``
    # off): the same answers in a fraction of its device path's time
    "cpu oracle": {"spark.rapids.sql.enabled": False},
}
#: The kernel wrappers a query's path may call, by module and name.
WRAPPERS = [(JP, "dense_build_probe"), (SEG, "segment_reduce_sorted"),
            (SS, "packed_argsort"), (SG, "gather_strings"),
            (HK, "murmur3_string_rows"), (SG, "ragged_row_equal")]
RTOL = 1e-9


def ref_session(conf: dict) -> TpuSession:
    return TpuSession({"spark.rapids.sql.enabled": True,
                       "spark.rapids.sql.variableFloatAgg.enabled": True,
                       **conf})


class Xbb:
    """One test module's TPCxBB run: both packages' tables at
    ``N_CLICKS``, the port's answers with their kernel-wrapper calls,
    and the reference's answers, each computed once."""

    def __init__(self, queries):
        self.queries = list(queries)
        self.ref_tables = rxbb.gen_tables(N_CLICKS, seed=SEED)
        self.port_tables = tpcxbb.gen_tables(N_CLICKS, seed=SEED)
        self._ref_dfs, self._ref = {}, {}
        self.port = port_answers(self.port_tables, self.queries)

    def ref(self, q: str, conf: str = "pallas on"):
        if (q, conf) not in self._ref:
            if conf not in self._ref_dfs:
                self._ref_dfs[conf] = rxbb.load(ref_session(REF_CONFS[conf]),
                                                self.ref_tables)
            self._ref[q, conf] = rxbb.QUERIES[q](self._ref_dfs[conf]
                                                 ).collect()
        return self._ref[q, conf]


def port_answers(tables, queries) -> dict:
    """``{q: (answer, kernel-wrapper calls)}`` of the port on the CPU."""
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
        dfs = tpcxbb.load(TorchSession(device="cpu"), tables)
        out = {}
        for q in queries:
            before = calls["n"]
            out[q] = (tpcxbb.QUERIES[q](dfs).collect(), calls["n"] - before)
    finally:
        for (m, a), fn in zip(WRAPPERS, saved):
            setattr(m, a, fn)
    return out


def port_rows(hb) -> dict:
    return {n: [(v.item() if hasattr(v, "item") else v) if ok else None
                for v, ok in zip(hb.columns[n], hb.validity[n])]
            for n in hb.columns}


def numpy_rows(ref: dict, q: str) -> dict:
    out = dict(ref)
    out.pop(CS.XBB_AUX.get(q, ""), None)
    return {n: [v.item() if hasattr(v, "item") else v
                for v in np.asarray(c)] for n, c in out.items()}


def assert_same_answer(got: dict, want, q: str) -> None:
    """Columns and rows in order: floats (``CS.XBB_FLOATS``) to
    ``RTOL``, everything else equal. ``want`` is a reference table or a
    dict of row lists (:func:`numpy_rows`)."""
    if not isinstance(want, dict):
        want = {n: want.column(n).to_pylist() for n in want.column_names}
    assert list(got) == list(want)
    floats = CS.XBB_FLOATS.get(q, ())
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


def check_query(xbb: Xbb, q: str, conf: str) -> None:
    """The port's answer against the reference's ``conf`` session, or,
    for ``"numpy"``, against ``chip_smoke.py``'s numpy reference."""
    answer, _ = xbb.port[q]
    want = numpy_rows(CS.XBB_REFS[q](xbb.port_tables), q) \
        if conf == "numpy" else xbb.ref(q, conf)
    assert_same_answer(port_rows(answer), want, q)


def check_numpy_reference(xbb: Xbb, q: str, conf: str = "pallas on") -> None:
    got = CS.XBB_REFS[q](xbb.port_tables)
    assert_same_answer(numpy_rows(got, q), xbb.ref(q, conf), q)


def ref_conf(q: str, device) -> str:
    """The reference session ``q`` is held against: its device path with
    the Pallas gate on when ``q`` is one of ``device`` (the queries whose
    device path takes under about 5 s here, and one more), else its CPU
    oracle, which gives the same answers in a fraction of the time."""
    return "pallas on" if q in device else "cpu oracle"


def ref_cases(queries, device, gate_off, numpy=()) -> list:
    """``(conf, q)`` of each query's comparisons (:func:`ref_conf`), and
    with the Pallas gate off for ``gate_off``, but for the queries of
    ``numpy`` (whose gate-off path takes over 5 s here once the gate-on
    path no longer compiles their pieces first), held against the numpy
    reference instead."""
    return [(ref_conf(q, device), q) for q in queries] \
        + [("numpy" if q in numpy else "pallas off", q) for q in gate_off]


def check_wrapper_calls(xbb: Xbb, kernel_queries) -> None:
    """The queries that call a kernel wrapper on this path are exactly
    ``kernel_queries`` (the ones held with the Pallas gate off too)."""
    calling = {q for q, (_, n) in xbb.port.items() if n}
    assert calling == set(kernel_queries)


QUERIES = ["q02", "q03", "q04", "q06", "q07", "q08", "q09"]
KERNEL_QUERIES = ["q03", "q06", "q07", "q08", "q09"]
#: Held against the reference's device path with its Pallas gate on; the
#: others against its CPU oracle (``ref_conf``).
DEVICE = ["q04", "q07", "q08", "q09"]
#: Their gate-off comparison against the numpy reference instead.
NUMPY = ["q03", "q06"]


@pytest.fixture(scope="module")
def xbb():
    return Xbb(QUERIES)


@pytest.mark.parametrize("conf,q",
                         ref_cases(QUERIES, DEVICE, KERNEL_QUERIES, NUMPY))
def test_query_matches_reference(q, conf, xbb):
    check_query(xbb, q, conf)


@pytest.mark.parametrize("q", QUERIES)
def test_numpy_reference_matches_reference(q, xbb):
    check_numpy_reference(xbb, q, ref_conf(q, DEVICE))


def test_query_paths_call_the_kernel_wrappers(xbb):
    check_wrapper_calls(xbb, KERNEL_QUERIES)


def _to_arrow(hb) -> pa.RecordBatch:
    return pa.RecordBatch.from_arrays(
        [pa.array(hb.columns[n], mask=~hb.validity[n]) for n in hb.columns],
        names=list(hb.columns))


def test_q02_on_pivot_clicks(xbb):
    """q02 over clicks on item 10 added beside every 1,000th identified
    click (``chip_smoke.q02_pivot_clicks``, the card's ``bb_q02_pivot``):
    the port, the reference's CPU oracle and the numpy reference agree,
    with rows."""
    port_tables = CS.q02_pivot_clicks(xbb.port_tables)
    ref_tables = dict(xbb.ref_tables,
                      web_clickstreams=_to_arrow(
                          port_tables["web_clickstreams"]))
    got = tpcxbb.q02(tpcxbb.load(TorchSession(device="cpu"), port_tables)
                     ).collect()
    want = rxbb.q02(rxbb.load(ref_session(REF_CONFS["cpu oracle"]),
                              ref_tables)).collect()
    assert want.num_rows > 3
    assert_same_answer(port_rows(got), want, "q02")
    assert_same_answer(numpy_rows(CS.numpy_bb_q02_pivot(xbb.port_tables),
                                  "q02"), want, "q02")


def test_q07_with_rows_at_2_17_clicks():
    """q07 reads the item table alone; at 2^17 clicks it keeps rows (held
    against the reference's CPU oracle)."""
    ref_item = rxbb.gen_tables(1 << 17, seed=SEED)["item"]
    port_tables = {"item": tpcxbb.gen_tables(1 << 17, seed=SEED)["item"]}
    got = tpcxbb.q07(tpcxbb.load(TorchSession(device="cpu"), port_tables)
                     ).collect()
    want = rxbb.q07(rxbb.load(ref_session(REF_CONFS["cpu oracle"]),
                              {"item": ref_item})).collect()
    assert want.num_rows > 0
    assert_same_answer(port_rows(got), want, "q07")
    assert_same_answer(numpy_rows(CS.numpy_bb_q07(port_tables), "q07"),
                       want, "q07")
