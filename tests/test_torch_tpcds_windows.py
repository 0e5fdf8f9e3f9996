"""The TPC-DS slice's second part, the other windowed queries: q53, q63
and q89 (a sum's deviation from its average over a partition), q12 and
q20 (a revenue share of its class), q49 (``Rank`` over return ratios,
three channels unioned) and q70 (a rollup over state and county kept
to the top-5 states by a ``Rank`` window). q20 also runs with the
reference's Pallas gate off, for the sort-path aggregate's
``segmented`` (the cheapest query that calls it). q53 returns no row
at the card's scale, so it also runs over ``chip_smoke.DS_VARIANTS``'
``q53_quarters`` tables here and there.

The port against the JAX package at 2^13 store_sales rows, seed 11, and
``chip_smoke.py``'s numpy reference of each query against the
reference's answer, as ``tests/test_torch_tpcds_base.py`` (which holds
the helpers) describes.
"""

import pytest

from test_torch_tpcds_base import (Ds, check_numpy_reference, check_query,
                                   check_variant, check_wrapper_calls,
                                   ref_cases, ref_conf)

QUERIES = ["q53", "q63", "q89", "q12", "q20", "q49", "q70"]
#: Held against the reference's device path (Pallas on); the others
#: against its CPU-oracle session (``ref_conf``).
DEVICE = ["q20"]
#: The queries also held against the reference with its Pallas gate off.
GATE_OFF = ["q20"]
#: ``chip_smoke.DS_VARIANTS`` run here.
VARIANTS = ["q53_quarters"]


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


@pytest.mark.parametrize("variant", VARIANTS)
def test_query_over_variant_tables(variant, ds):
    check_variant(ds, variant)
