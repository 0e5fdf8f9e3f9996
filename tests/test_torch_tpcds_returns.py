"""The TPC-DS slice's second part, returns across channels: q83 (one
item's returns in all three channels) and q91 (call-center return
losses of one demographic segment), both empty at this scale and so
also over the ``chip_smoke.DS_VARIANTS`` tables that give them rows
(``ds_q83_item``, ``ds_q91_returners``); q77 and q80 (each channel's
sales left-joined to its returns, unioned, then a rollup over channel
and id).

The port against the JAX package at 2^13 store_sales rows, seed 11, and
``chip_smoke.py``'s numpy reference of each query against the
reference's answer, as ``tests/test_torch_tpcds_base.py`` (which holds
the helpers) describes.
"""

import pytest

from test_torch_tpcds_base import (Ds, check_numpy_reference, check_query,
                                   check_variant, check_wrapper_calls,
                                   ref_cases, ref_conf)

QUERIES = ["q83", "q91", "q77", "q80"]
#: Held against the reference's device path (Pallas on); the others
#: against its CPU-oracle session (``ref_conf``).
DEVICE = ["q91"]
#: ``chip_smoke.DS_VARIANTS`` run here.
VARIANTS = ["q83_item", "q91_returners"]


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


@pytest.mark.parametrize("variant", VARIANTS)
def test_query_over_variant_tables(variant, ds):
    check_variant(ds, variant)
