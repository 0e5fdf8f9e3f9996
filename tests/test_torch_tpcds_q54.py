"""The TPC-DS slice's third part, averages and deviations joined back:
q30 and q81 (customers' returns above 1.2 times their state's average),
q17 and q39 (a standard deviation as ``Sqrt`` of a variance built from
sums, with ``Cast`` to DOUBLE), q78 (unreturned store and web lines by
customer and item) and q54 (customers' store revenue in $50 segments,
``Cast(revenue / 50, INT)``, over ``distinct`` customers). The
reference takes about 16 s for q54 here, the other five 6-8 s each.

The port against the JAX package at 2^13 store_sales rows, seed 11, and
``chip_smoke.py``'s numpy reference of each query against the
reference's answer, as ``tests/test_torch_tpcds_base.py`` (which holds
the helpers) describes.
"""

import pytest

from test_torch_tpcds_base import (Ds, check_numpy_reference, check_query,
                                   check_wrapper_calls)

QUERIES = ["q30", "q81", "q17", "q39", "q78", "q54"]


@pytest.fixture(scope="module")
def ds():
    return Ds(QUERIES)


@pytest.mark.parametrize("conf,q", [("pallas on", q) for q in QUERIES])
def test_query_matches_reference(q, conf, ds):
    check_query(ds, q, conf)


@pytest.mark.parametrize("q", QUERIES)
def test_numpy_reference_matches_reference(q, ds):
    check_numpy_reference(ds, q)


def test_query_paths_call_the_kernel_wrappers(ds):
    check_wrapper_calls(ds)
