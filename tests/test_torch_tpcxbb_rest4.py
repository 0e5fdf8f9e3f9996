"""The TPCxBB queries beyond the bench suite's three, fourth part:
q24, q25, q27, q28 and q29.
The port against the JAX package at 2^14 clicks, seed 23, and
``chip_smoke.py``'s numpy reference of each query against the
reference's answer, as ``tests/test_torch_tpcxbb_rest1.py`` (which
holds the helpers) describes.

This part also holds ``chip_smoke.py``'s numpy references of the bench
suite's three entries (q01, q05, q30) against the reference.
"""

import pytest

from test_torch_tpcxbb_rest1 import (Xbb, check_numpy_reference,
                                     check_query, check_wrapper_calls)

QUERIES = ["q24", "q25", "q27", "q28", "q29"]
KERNEL_QUERIES = ["q24", "q25", "q29"]


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


#: The bench suite's three entries, whose port answers
#: ``tests/test_torch_tpcxbb.py`` holds: here their numpy references.
BENCH = ["q01", "q05", "q30"]


@pytest.fixture(scope="module")
def bench():
    return Xbb([])


@pytest.mark.parametrize("q", BENCH)
def test_bench_numpy_reference_matches_reference(q, bench):
    check_numpy_reference(bench, q)
