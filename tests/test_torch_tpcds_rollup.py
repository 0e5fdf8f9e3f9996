"""The TPC-DS slice, the rollups through Expand: q18 (rollup over four
string keys, four averages), q22 (rollup over the item hierarchy of
inventory), q36 and q86 (rollup, then ``Rank`` over the grouping id with
``If``).
The port against the JAX package at 2^13 store_sales rows, seed 11, and
``chip_smoke.py``'s numpy reference of each query against the
reference's answer, as ``tests/test_torch_tpcds_base.py`` (which holds
the helpers) describes.
The reference takes 17-23 s a conf for q18 and q22 and about 10 s for
q86 here, so only q36 also runs with its Pallas gate off.
"""

import pytest

from test_torch_tpcds_base import (Ds, check_numpy_reference, check_query,
                                   check_wrapper_calls, ref_cases, ref_conf)

QUERIES = ["q18", "q22", "q36", "q86"]
#: Held against the reference's device path (Pallas on); the others
#: against its CPU-oracle session (``ref_conf``).
DEVICE = ["q36"]
#: The queries also held against the reference with its Pallas gate off.
GATE_OFF = ["q36"]


@pytest.fixture(scope="module")
def ds():
    return Ds(QUERIES)


@pytest.mark.parametrize("conf,q", ref_cases(QUERIES, DEVICE)
                         + [("pallas off", q) for q in GATE_OFF])
def test_query_matches_reference(q, conf, ds):
    check_query(ds, q, conf)


@pytest.mark.parametrize("q", QUERIES)
def test_numpy_reference_matches_reference(q, ds):
    check_numpy_reference(ds, q, ref_conf(q, DEVICE))


def test_query_paths_call_the_kernel_wrappers(ds):
    check_wrapper_calls(ds)
