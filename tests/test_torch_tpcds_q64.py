"""The TPC-DS slice's third part, q64 (store sales with a return and a
catalog re-sale clearing the refund, two years of cross sales
self-joined on item, store and zip: the widest join graph of the suite)
and q75 (year over year per item identity over three channels, with
``Coalesce`` of left-joined returns), beside q37 and q82 (items with
stock on hand that a channel sold). The reference takes about 25 s for
q64 and 14 s for q75 here.

The port against the JAX package at 2^13 store_sales rows, seed 11, and
``chip_smoke.py``'s numpy reference of each query against the
reference's answer, as ``tests/test_torch_tpcds_base.py`` (which holds
the helpers) describes.
"""

import pytest

from test_torch_tpcds_base import (Ds, check_numpy_reference, check_query,
                                   check_wrapper_calls, ref_cases, ref_conf)

QUERIES = ["q64", "q75", "q37", "q82"]
#: Held against the reference's device path (Pallas on); the others
#: against its CPU-oracle session (``ref_conf``).
DEVICE = ["q82"]


@pytest.fixture(scope="module")
def ds():
    return Ds(QUERIES)


@pytest.mark.parametrize("conf,q", ref_cases(QUERIES, DEVICE))
def test_query_matches_reference(q, conf, ds):
    check_query(ds, q, conf)


@pytest.mark.parametrize("q", QUERIES)
def test_numpy_reference_matches_reference(q, ds):
    check_numpy_reference(ds, q, ref_conf(q, DEVICE))


def test_query_paths_call_the_kernel_wrappers(ds):
    check_wrapper_calls(ds)
