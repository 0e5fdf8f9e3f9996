"""Mortgage (``workloads/mortgage.py``) against the JAX package at 2^13
performance records, seed 7 (the reference's own test scale).

The port's generator gives the reference's tables value for value, the
seller and servicer strings decoded from their dictionaries. ``etl`` and
``ml_features`` run through ``TorchSession`` on the CPU and through the
reference's ``TpuSession`` with ``variableFloatAgg`` on (as
``tests/test_mortgage.py`` runs it): keys, strings and counts equal,
float columns to rtol 1e-9, rows compared in key order. ``etl``'s
(seller, score band) group-by must stay on the dictionary path, which
``CaseWhen``'s dictionary result makes possible. ``chip_smoke.py``'s
numpy references of both queries equal the reference's answers.
"""

import datetime

import numpy as np
import pytest

import chip_smoke as CSM
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.workloads import mortgage as rmort
from spark_rapids_tpu_torch.ops.kernels import groupby as KG
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.workloads import mortgage

PERF_ROWS = 1 << 13
SEED = 7
RTOL = 1e-9
#: query -> the columns its rows are ordered by
KEYS = {"etl": ["seller", "score_band"], "ml_features": ["loan_id"]}
FLOATS = {"risk_upb", "avg_rate", "recent_upb", "orig_rate"}


@pytest.fixture(scope="module")
def tables():
    return rmort.gen_tables(PERF_ROWS, seed=SEED), \
        mortgage.gen_tables(PERF_ROWS, seed=SEED)


@pytest.fixture(scope="module")
def ref_answers(tables):
    s = TpuSession({"spark.rapids.sql.enabled": True,
                    "spark.rapids.sql.variableFloatAgg.enabled": True})
    dfs = rmort.load(s, tables[0], cache=False)
    return {q: getattr(rmort, q)(dfs).collect() for q in KEYS}


@pytest.fixture(scope="module")
def port_answers(tables):
    session = TorchSession(device="cpu")
    dfs = mortgage.load(session, tables[1])
    paths = []
    fn = KG._dict_grouped_aggregate

    def spy(*a, **k):
        paths.append("dictionary")
        return fn(*a, **k)
    KG._dict_grouped_aggregate = spy
    try:
        out = {q: getattr(mortgage, q)(dfs).collect() for q in KEYS}
    finally:
        KG._dict_grouped_aggregate = fn
    return out, paths


def _ref_columns(table) -> dict:
    return {n: table.column(n).to_pylist() for n in table.column_names}


def _port_columns(hb) -> dict:
    return {n: [v.item() if hasattr(v, "item") else v
                for v in np.asarray(hb.columns[n], dtype=object)]
            for n in hb.columns}


def _ordered(cols: dict, keys) -> dict:
    order = sorted(range(len(cols[keys[0]])),
                   key=lambda i: tuple(cols[k][i] for k in keys))
    return {n: [v[i] for i in order] for n, v in cols.items()}


def _assert_same(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for name, w in want.items():
        g = got[name]
        assert len(g) == len(w), (what, name)
        if name in FLOATS:
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64),
                                       rtol=RTOL, atol=0, err_msg=name)
        else:
            assert list(g) == list(w), (what, name)


@pytest.mark.parametrize("name", ["acquisition", "performance"])
def test_gen_tables_equal_the_reference(tables, name):
    ref, port = tables[0][name], tables[1][name]
    assert ref.schema.names == port.schema.names
    assert port.num_rows == ref.num_rows
    for i, c in enumerate(ref.schema.names):
        want = ref.column(i).to_pylist()
        if isinstance(want[0], datetime.date):
            want = [(d - datetime.date(1970, 1, 1)).days for d in want]
        got = port.values(c)
        assert got.tolist() == want, c
        hc = port.columns[i]
        if hc.is_dict:  # a dictionary straight from the draw
            assert hc.dict_sorted and hc.codes.dtype == np.int32
    assert 20 < tables[1]["performance"].num_rows / \
        tables[1]["acquisition"].num_rows < 28


@pytest.mark.parametrize("q", list(KEYS))
def test_query_equals_the_reference(ref_answers, port_answers, q):
    got = _ordered(_port_columns(port_answers[0][q]), KEYS[q])
    want = _ordered(_ref_columns(ref_answers[q]), KEYS[q])
    assert len(want[KEYS[q][0]]) > 0
    _assert_same(got, want, q)


def test_etl_groups_on_the_dictionary_path(port_answers):
    """The (seller, score band) group-by of ``etl`` takes the dictionary
    path, both keys being sorted dictionaries; ``ml_features`` has no
    such group-by."""
    assert port_answers[1] == ["dictionary"]


@pytest.mark.parametrize("q,ref_q", [("etl", "etl"),
                                     ("features", "ml_features")])
def test_chip_smoke_numpy_references(tables, ref_answers, q, ref_q):
    got = CSM.MORT_REFS[q](tables[1])
    got = _ordered({n: list(np.asarray(v).tolist()) for n, v in got.items()},
                   KEYS[ref_q])
    want = _ordered(_ref_columns(ref_answers[ref_q]), KEYS[ref_q])
    _assert_same(got, {n: want[n] for n in got}, q)


def test_score_report_waits_for_the_ml_package():
    """``score_report`` reads a ``ModelScore`` column, which the port's
    ``ml/`` package (not ported yet) makes: the port has no such
    query, and asking for it fails."""
    assert hasattr(rmort, "score_report")
    with pytest.raises(AttributeError):
        mortgage.score_report
