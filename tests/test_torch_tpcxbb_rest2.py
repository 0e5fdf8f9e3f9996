"""The TPCxBB queries beyond the bench suite's three, second part:
q10, q11, q12, q13, q14, q15, q16, q17 and q26.
The port against the JAX package at 2^14 clicks, seed 23, and
``chip_smoke.py``'s numpy reference of each query against the
reference's answer, as ``tests/test_torch_tpcxbb_rest1.py`` (which
holds the helpers) describes.
"""

import pytest

from test_torch_tpcxbb_rest1 import (Xbb, check_numpy_reference,
                                     check_query, check_wrapper_calls)

QUERIES = ["q10", "q11", "q12", "q13", "q14", "q15", "q16", "q17", "q26"]
KERNEL_QUERIES = ["q10", "q11", "q12", "q13", "q14", "q15", "q16", "q17", "q26"]


@pytest.fixture(scope="module")
def xbb():
    return Xbb(QUERIES)


@pytest.mark.parametrize("conf,q", [("pallas on", q) for q in QUERIES]
                         + [("pallas off", q) for q in KERNEL_QUERIES])
def test_query_matches_reference(q, conf, xbb):
    check_query(xbb, q, conf)


@pytest.mark.parametrize("q", QUERIES)
def test_numpy_reference_matches_reference(q, xbb):
    check_numpy_reference(xbb, q)


def test_query_paths_call_the_kernel_wrappers(xbb):
    check_wrapper_calls(xbb, KERNEL_QUERIES)
