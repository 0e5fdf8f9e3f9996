"""The TPC-DS slice, second star-join part: q5 (three channels unioned),
q7, q13, q15, q19, q25, q26 and q27.
The port against the JAX package at 2^13 store_sales rows, seed 11, and
``chip_smoke.py``'s numpy reference of each query against the
reference's answer, as ``tests/test_torch_tpcds_base.py`` (which holds
the helpers) describes.
The reference takes about 17 s a conf for q5 here, so q5 runs with
its Pallas gate on only.
"""

import pytest

from test_torch_tpcds_base import (Ds, check_numpy_reference, check_query,
                                   check_wrapper_calls, gate_off_cases,
                                   ref_cases, ref_conf)

QUERIES = ["q5", "q7", "q13", "q15", "q19", "q25", "q26", "q27"]
#: Held against the reference's device path (Pallas on); the others
#: against its CPU-oracle session (``ref_conf``).
DEVICE = ["q13"]
#: The queries also held against the reference with its Pallas gate off.
GATE_OFF = ["q7", "q13", "q15", "q19", "q25", "q26", "q27"]
#: Their gate-off comparison against the numpy reference instead
#: (``gate_off_cases``).
NUMPY = ["q7", "q15", "q19", "q25", "q26", "q27"]


@pytest.fixture(scope="module")
def ds():
    return Ds(QUERIES)


@pytest.mark.parametrize("conf,q", ref_cases(QUERIES, DEVICE)
                         + gate_off_cases(GATE_OFF, NUMPY))
def test_query_matches_reference(q, conf, ds):
    check_query(ds, q, conf)


@pytest.mark.parametrize("q", QUERIES)
def test_numpy_reference_matches_reference(q, ds):
    check_numpy_reference(ds, q, ref_conf(q, DEVICE))


def test_query_paths_call_the_kernel_wrappers(ds):
    check_wrapper_calls(ds)
