"""The TPCxBB queries beyond the bench suite's three, third part:
q18, q19, q20, q21, q22 and q23.
The port against the JAX package at 2^14 clicks, seed 23, and
``chip_smoke.py``'s numpy reference of each query against the
reference's answer, as ``tests/test_torch_tpcxbb_rest1.py`` (which
holds the helpers) describes.
"""

import pytest

from test_torch_tpcxbb_rest1 import (Xbb, check_numpy_reference,
                                     check_query, check_wrapper_calls,
                                     ref_cases, ref_conf)

QUERIES = ["q18", "q19", "q20", "q21", "q22", "q23"]
KERNEL_QUERIES = ["q18", "q19", "q20", "q22"]
#: Held against the reference's device path with its Pallas gate on;
#: the others against its CPU oracle (``ref_conf``).
DEVICE = ["q23"]
#: Their gate-off comparison against the numpy reference instead.
NUMPY = ["q18", "q19", "q20", "q22"]


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
