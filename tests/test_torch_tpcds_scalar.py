"""The TPC-DS slice's third part, the one-table and scalar-ratio queries:
q9 and q28 (bucketed global aggregates of store_sales under cross joins
of one-row frames), q90 (the ratio of two web counts), q32 and q92
(discounts above 1.3 times their item's average, joined back), q41 (a
``distinct`` over item under a sibling semi join) and q84 (a dimension
chain to income_band). q9, q28 and q41 call no kernel wrapper
(``test_torch_tpcds_base.NO_KERNEL``).

The reference's device path takes 97-264 s for q9 and q28 here, so in
this tier they, and their numpy references, are held against the
reference's CPU-oracle session (``spark.rapids.sql.enabled`` off, the
``cpu`` side of ``tests/test_tpcds.py``), which answers them in a
fraction of a second; their comparison with the device path is marked
``slow``, as the reference marks its own long tail. The rest as
``tests/test_torch_tpcds_base.py`` (which holds the helpers) describes:
the port against the JAX package at 2^13 store_sales rows, seed 11.
"""

import pytest

from test_torch_tpcds_base import (Ds, check_numpy_reference, check_query,
                                   check_wrapper_calls)

QUERIES = ["q9", "q28", "q90", "q32", "q92", "q41", "q84"]
#: Held against the reference's CPU-oracle session here, against its
#: device path in the ``slow`` tier.
ORACLE = ["q9", "q28"]


@pytest.fixture(scope="module")
def ds():
    return Ds(QUERIES)


@pytest.mark.parametrize(
    "conf,q", [("pallas on", q) for q in QUERIES if q not in ORACLE]
    + [("cpu oracle", q) for q in ORACLE]
    + [pytest.param("pallas on", q, marks=pytest.mark.slow)
       for q in ORACLE])
def test_query_matches_reference(q, conf, ds):
    check_query(ds, q, conf)


@pytest.mark.parametrize("q", QUERIES)
def test_numpy_reference_matches_reference(q, ds):
    check_numpy_reference(ds, q, "cpu oracle" if q in ORACLE
                          else "pallas on")


def test_query_paths_call_the_kernel_wrappers(ds):
    check_wrapper_calls(ds)
