"""The TPC-DS slice's second part, the queries that return no row at
this scale: q8 (a zip prefix with more than 10 preferred customers, the
stores' zips through ``Substring``), q58 (one item's revenue within 10 %
across the three channels in one week) and q71 (brands of manager 1 at
meal times), each also over the ``chip_smoke.DS_VARIANTS`` tables that
give it rows (``ds_q8_zips``, ``ds_q58_week``, ``ds_q71_managers``).
q8 also runs with the reference's Pallas gate off: its flat strings
gather (``gather_strings``) no cheaper query of this part calls.

The port against the JAX package at 2^13 store_sales rows, seed 11, and
``chip_smoke.py``'s numpy reference of each query against the
reference's answer, as ``tests/test_torch_tpcds_base.py`` (which holds
the helpers) describes.
"""

import pytest

from test_torch_tpcds_base import (Ds, check_numpy_reference, check_query,
                                   check_variant, check_wrapper_calls,
                                   ref_cases, ref_conf)

QUERIES = ["q8", "q58", "q71"]
#: Held against the reference's device path (Pallas on); the others
#: against its CPU-oracle session (``ref_conf``).
DEVICE = ["q8"]
#: The queries also held against the reference with its Pallas gate off.
GATE_OFF = ["q8"]
#: ``chip_smoke.DS_VARIANTS`` run here.
VARIANTS = ["q8_zips", "q58_week", "q71_managers"]


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
