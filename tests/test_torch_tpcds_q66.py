"""The TPC-DS slice's third part, q66: twelve monthly ``If`` sums per
warehouse over the web and catalog channels, unioned and summed again.
The reference takes about 56 s here, so q66 has a file of its own.

The port against the JAX package at 2^13 store_sales rows, seed 11, and
``chip_smoke.py``'s numpy reference of each query against the
reference's answer, as ``tests/test_torch_tpcds_base.py`` (which holds
the helpers) describes.
"""

import pytest

from test_torch_tpcds_base import (Ds, check_numpy_reference, check_query,
                                   check_wrapper_calls)

QUERIES = ["q66"]


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
