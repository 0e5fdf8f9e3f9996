"""Q15, Q16, Q17, Q20 and Q21 end to end, the port's session against the
JAX package's at 16,384 lineitem rows: the second half of
``tests/test_torch_tpch_rest.py`` (same inputs, confs and tolerances),
split off because the reference takes about 90 s a conf over Q15 here.
"""

import pytest

from test_torch_tpch_rest import (check_query, load_reference, ref_cases,
                                  run_port)

QUERIES = ["q15", "q16", "q17", "q20", "q21"]
#: Held against the reference's device path with its Pallas gate on and
#: off; the others against its CPU oracle and the numpy reference
#: (``ref_cases``; Q15's device path takes 90-260 s a conf here).
DEVICE = ["q17"]


@pytest.fixture(scope="module")
def ref_dfs():
    return load_reference()


@pytest.fixture(scope="module")
def port_results():
    return run_port(QUERIES)


@pytest.mark.parametrize("q,conf", ref_cases(QUERIES, DEVICE))
def test_query_matches_reference(q, conf, ref_dfs, port_results):
    check_query(q, conf, ref_dfs, port_results)


@pytest.mark.parametrize("q", QUERIES)
def test_query_path_calls_the_join_wrapper(q, port_results):
    """As in the first half: ``joinProbe`` is on every query's path."""
    assert port_results[q][1] >= 1


def test_q15_reads_one_evaluation_of_its_revenue_view(monkeypatch):
    """Q15 keeps the suppliers whose revenue equals the max of the same
    revenues. On the card a float sum adds in atomic order, so two
    evaluations of that aggregate may differ in their last bits, and the
    card's first SF1 run found no equal pair. Here every evaluation's
    float sums move one ulp from the last one's: the planner runs the
    view once (a ``ReusedExec`` read by both references), so Q15 still
    returns its supplier, the one of an unperturbed run."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.exec import execs as E
    from spark_rapids_tpu_torch.ops.kernels import groupby as KG
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.workloads import tpch

    session = TorchSession(device="cpu")
    dfs = tpch.load(session, tpch.gen_tables(1 << 14))
    want = tpch.q15(dfs).collect()
    plan = session.plan(tpch.q15(dfs)._plan)
    assert plan.tree_string().count("Reused") == 2  # one node, two parents
    real = KG._segment_scatter
    calls = [0]

    def drifting(x, ids, num_segments, op):
        out = real(x, ids, num_segments, op)
        if op == "sum" and out.is_floating_point():
            calls[0] += 1
            direction = torch.full_like(out, np.inf if calls[0] % 2
                                        else -np.inf)
            out = torch.nextafter(out, direction)
        return out
    monkeypatch.setattr(KG, "_segment_scatter", drifting)
    got = tpch.q15(dfs).collect()
    assert calls[0] > 0
    assert got.num_rows == want.num_rows == 1
    assert list(got.columns["s_suppkey"]) == list(want.columns["s_suppkey"])
    # the same query with the view planned twice loses its row
    monkeypatch.setattr(E, "ReusedExec", lambda child: child)
    assert tpch.q15(dfs).collect().num_rows == 0
