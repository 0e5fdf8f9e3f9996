"""The TPC-DS slice's third part, star joins with ``If`` buckets and
``Substring``: q43 (store sales by day name), q50, q62 and q99 (return
and shipping latencies counted in 30-day buckets; q62 and q99 group by
``substring(w_warehouse_name, 1, 20)``), q45 (a zip prefix through
``Substring`` or a listed item), q73 (households with 1-5 items a
ticket) and q85 (web returns under paired demographics).

The port against the JAX package at 2^13 store_sales rows, seed 11, and
``chip_smoke.py``'s numpy reference of each query against the
reference's answer, as ``tests/test_torch_tpcds_base.py`` (which holds
the helpers) describes.
"""

import pytest

from test_torch_tpcds_base import (Ds, check_numpy_reference, check_query,
                                   check_wrapper_calls)

QUERIES = ["q43", "q50", "q62", "q99", "q45", "q73", "q85"]


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
