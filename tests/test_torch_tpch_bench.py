"""The bench suite's other TPC-H queries end to end — Q5, Q12, Q14, Q19 and
``xbb_score``, with Q10 and Q18 — the port's session against the JAX
package's, at 16,384 lineitem rows.

The port runs on the CPU, so its kernels take their plain versions. The
reference runs with ``variableFloatAgg`` on, so its float aggregates take
its device path (see ``tests/test_torch_tpch_more.py``), with its Pallas
gate on (interpret mode) and off.

Keys, strings, counts and dates must be equal, in the order the query
sets (Q5, Q12 and ``xbb_score`` have no ORDER BY: their rows compare in
key order). Float sums and averages are held to rtol 1e-12, ``max_score``
(a max of ``1 / (1 + exp(-z))``) to rtol 1e-15: PyTorch's and XLA's
``exp`` may differ in the last bit.
"""

import numpy as np
import pytest

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.workloads import tpch as rtpch
from spark_rapids_tpu_torch.ops.kernels.cuda import join_probe as JP
from spark_rapids_tpu_torch.ops.kernels.cuda import segmented as SEG
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.workloads import tpch

ROWS = 1 << 14
#: (key columns, exact columns, float columns, rtol of the floats)
COLUMNS = {
    "q5": (["n_name"], [], ["revenue"], 1e-12),
    "q10": (["c_custkey", "n_name"], [], ["revenue"], 1e-12),
    "q12": (["l_shipmode"], ["high_line_count", "low_line_count"], [],
            0.0),
    "q14": ([], [], ["promo", "total"], 1e-12),
    "q18": (["c_custkey"], ["n_orders", "total_qty"], [], 0.0),
    "q19": ([], [], ["revenue"], 1e-12),
    "xbb_score": (["l_returnflag"], ["n"], ["avg_score", "max_score"],
                  1e-12),
}
QUERIES = list(COLUMNS)
UNORDERED = ("q5", "q12", "xbb_score")
REF_CONFS = {
    "pallas on": {"spark.rapids.tpu.pallas.enabled": True},
    "pallas off": {"spark.rapids.tpu.pallas.enabled": False},
}
#: queries whose every join is a single int key the direct-address
#: ``joinProbe`` table takes
DENSE_JOINS = ("q5", "q10", "q12", "q14", "q18", "q19")


@pytest.fixture(scope="module")
def ref_dfs():
    tables = rtpch.gen_tables(ROWS)
    out = {}
    for name, conf in REF_CONFS.items():
        s = TpuSession({"spark.rapids.sql.enabled": True,
                        "spark.rapids.sql.variableFloatAgg.enabled": True,
                        **conf})
        out[name] = rtpch.load(s, tables)
    return out


@pytest.fixture(scope="module")
def port_results():
    """Each query's result on the CPU, with the calls of the ``joinProbe``
    and ``segmented`` wrappers counted."""
    calls = {"joinProbe": 0, "segmented": 0}
    jp, seg = JP.dense_build_probe, SEG.segment_reduce_sorted

    def count_jp(*a, **k):
        calls["joinProbe"] += 1
        return jp(*a, **k)

    def count_seg(*a, **k):
        calls["segmented"] += 1
        return seg(*a, **k)

    session = TorchSession(device="cpu")
    dfs = tpch.load(session, tpch.gen_tables(ROWS))
    results = {}
    JP.dense_build_probe, SEG.segment_reduce_sorted = count_jp, count_seg
    try:
        for q in QUERIES:
            before = dict(calls)
            out = tpch.QUERIES[q](dfs).collect()
            results[q] = (out, {k: calls[k] - before[k] for k in calls})
    finally:
        JP.dense_build_probe, SEG.segment_reduce_sorted = jp, seg
    return results


def _ref_columns(table) -> dict:
    out = {}
    for name in table.column_names:
        c = table.column(name)
        if str(c.type) == "string":
            out[name] = np.array(c.to_pylist(), dtype=object)
        else:
            out[name] = c.to_numpy()
    return out


def _in_key_order(cols: dict, keys) -> dict:
    order = np.lexsort([np.asarray(cols[k]).astype(str)
                        for k in reversed(keys)])
    return {k: np.asarray(v)[order] for k, v in cols.items()}


@pytest.mark.parametrize("conf", list(REF_CONFS))
@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_reference(q, conf, ref_dfs, port_results):
    want = _ref_columns(rtpch.QUERIES[q](ref_dfs[conf]).collect())
    got_batch = port_results[q][0]
    keys, exact, floats, rtol = COLUMNS[q]
    assert set(got_batch.columns) == set(want)
    n = len(next(iter(want.values())))
    assert n > 0
    for name in got_batch.columns:
        assert got_batch.validity[name].all(), name
        assert len(got_batch.columns[name]) == n, name
    got = dict(got_batch.columns)
    if q in UNORDERED:
        got, want = _in_key_order(got, keys), _in_key_order(want, keys)
    for name in keys:
        np.testing.assert_array_equal(got[name].astype(str),
                                      want[name].astype(str), err_msg=name)
    for name in exact:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in floats:
        tol = 1e-15 if name == "max_score" else rtol
        np.testing.assert_allclose(got[name], want[name], rtol=tol, atol=0,
                                   err_msg=name)


@pytest.mark.parametrize("q", QUERIES)
def test_query_path_calls_the_kernel_wrappers(q, port_results):
    """On the card the same calls launch the kernels; here the wrappers
    take their plain versions. Every join of Q5, Q10, Q12, Q14, Q18 and
    Q19 builds a direct-address table; ``xbb_score`` joins nothing and
    groups on the dictionary path."""
    got = port_results[q][1]
    if q in DENSE_JOINS:
        assert got["joinProbe"] >= 1
    else:
        assert got == {"joinProbe": 0, "segmented": 0}


def _probe_exp(alone: int = 0) -> dict:
    """One process of the probe for the rare ``avg_score`` failures of
    this file (``ROADMAP.md`` C): the port's ``Exp`` over this file's
    16,384 rows is held bit for bit against ``np.exp`` at every call
    while both packages load their tables and the port runs the seven
    queries; a wrong call is retried 5 times on the same input. With
    ``alone``, ``torch.exp`` runs that many times on a 16,384-row input
    instead, with nothing of the JAX package run. Returns the counts
    and, per wrong call, the 2,048-element chunks that differ and the
    largest relative error."""
    import os

    import jax
    import torch

    from spark_rapids_tpu_torch.ops import math as M

    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    jax.config.update("jax_platforms", "cpu")
    out = {"calls": 0, "wrong": []}

    def differing_chunks(x, y):
        d = np.flatnonzero(y.numpy().view(np.int64)
                           != np.exp(x.numpy()).view(np.int64))
        return sorted(set((d // 2048).tolist()))

    def rel_err(x, y):
        want = np.exp(x.numpy())
        return float(np.max(np.abs(y.numpy() - want) / np.abs(want)))

    if alone:
        x = torch.from_numpy(np.random.default_rng(0).uniform(-6, 6, ROWS))
        for _ in range(alone):
            out["calls"] += 1
            chunks = differing_chunks(x, torch.exp(x))
            if chunks:
                out["wrong"].append({"chunks": chunks})
        return out
    exp = M.Exp.torch_fn

    def checked(x):
        y = exp(x)
        if x.numel() == ROWS:
            out["calls"] += 1
            chunks = differing_chunks(x, y)
            if chunks:
                out["wrong"].append({
                    "chunks": chunks, "max_rel_err": rel_err(x, y),
                    "retries_wrong": sum(
                        bool(differing_chunks(x, exp(x.clone())))
                        for _ in range(5))})
        return y

    M.Exp.torch_fn = staticmethod(checked)
    try:
        tables = rtpch.gen_tables(ROWS)
        for conf in REF_CONFS.values():
            rtpch.load(TpuSession({
                "spark.rapids.sql.enabled": True,
                "spark.rapids.sql.variableFloatAgg.enabled": True,
                **conf}), tables)
        dfs = tpch.load(TorchSession(device="cpu"), tpch.gen_tables(ROWS))
        for q in QUERIES:
            tpch.QUERIES[q](dfs).collect()
    finally:
        M.Exp.torch_fn = staticmethod(exp)
    return out


if __name__ == "__main__":
    # One probe process a run; the failure is rare per process:
    #   for i in $(seq 120); do python tests/test_torch_tpch_bench.py; done
    #   python tests/test_torch_tpch_bench.py --alone 20000
    import json
    import sys
    alone = int(sys.argv[2]) if sys.argv[1:2] == ["--alone"] else 0
    print(json.dumps(_probe_exp(alone)))
