"""The TPC-DS slice's third part, q76 (sales with a null foreign key
counted per channel: the legs filter on ``IsNull``), q72 (catalog sales
joined to the inventory of their item, about 25 rows an item, then
filtered on the week and the quantity on hand; ``DateAdd``; two left
tails), q21 (inventory before and after a date, ratio-banded) and q40
(catalog sales net of returns before and after a date, ``Coalesce`` on
its left join). The reference takes about 27 s for q76 and 14 s for q72
here. q72's inventory join counts its equi pairs
(``ShuffledHashJoinExec.equi_pairs``), which the card's ``ds_q72`` cell
prints, and the count is held against numpy's.

The port against the JAX package at 2^13 store_sales rows, seed 11, and
``chip_smoke.py``'s numpy reference of each query against the
reference's answer, as ``tests/test_torch_tpcds_base.py`` (which holds
the helpers) describes.
"""

import chip_smoke as CS
import pytest

from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.workloads import tpcds
from test_torch_tpcds_base import (Ds, check_numpy_reference, check_query,
                                   check_wrapper_calls, ref_cases, ref_conf)

QUERIES = ["q76", "q72", "q21", "q40"]
#: Held against the reference's device path (Pallas on); the others
#: against its CPU-oracle session (``ref_conf``).
DEVICE = ["q40"]


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


def test_q72_counts_its_inventory_join_pairs(ds):
    """The exact inner join's pairs, the inventory join's alone in q72,
    equal numpy's count of catalog sales and inventory rows of one item."""
    session = TorchSession(device="cpu")
    tpcds.q72(tpcds.load(session, ds.port_tables)).collect()
    want = len(CS.q72_pairs(ds.port_tables)[0])
    assert want > 0
    assert session.last_query.counters == {
        "ShuffledHashJoinExec.equi_pairs": want}
