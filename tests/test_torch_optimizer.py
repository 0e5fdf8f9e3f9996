"""Column pruning (``plan/optimizer.py prune_columns``) against the
reference's (``spark_rapids_tpu/plan/optimizer.py:51``).

For every TPC-H query and the TPC-DS queries below, over 2^12-row tables,
the pruned logical plan of each package is walked in pre-order and each
node's kind and output column names compared (the sources: the port's
uploaded table, the reference's cached relation). A query whose plan
reads one subplan twice (Q11's, Q15's revenue view, Q22's customers) is
pruned once here, with the union of what its readers need, where the
reference prunes each reader's copy: those queries plan exactly one
``ReusedExec`` for it, read by both references. Their answers after
pruning are held against the reference's CPU session in
``test_torch_cpu_exec.py`` and the query files.

Two differences of shape are documented (ROADMAP C) and normalised in
both trees before they are compared, so the column sets are what is
held: the port narrows an uploaded table to a relation of the needed
columns where the reference puts a selection (a ``Project`` of plain
columns) over it, and puts no selection under an aggregate.
"""

from collections import Counter

import pytest

from spark_rapids_tpu.plan import logical as RL
from spark_rapids_tpu.plan.optimizer import prune_columns as ref_prune
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.workloads import tpcds as rtpcds
from spark_rapids_tpu.workloads import tpch as rtpch
from spark_rapids_tpu_torch.exec import execs as E
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.optimizer import prune_columns
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.workloads import tpcds
from spark_rapids_tpu_torch.workloads import tpch

SHARED = {"q11", "q15", "q22"}
DS_QUERIES = ("q3", "q7", "q19", "q42", "q52", "q55", "q96", "q98")


def _is_selection(node) -> bool:
    return type(node).__name__ == "Project" and all(
        type(e).__name__ == "AttributeReference" for e in node.exprs)


def _signature(plan, source_types) -> list:
    """Each node's kind and output names in pre-order; a selection over a
    source is that source, narrowed, and a selection under an aggregate
    is skipped."""
    out = []

    def walk(node, parent_kind=None):
        if _is_selection(node) and isinstance(node.children[0],
                                              source_types):
            out.append(("Source", tuple(node.schema.names)))
            return
        if _is_selection(node) and parent_kind == "Aggregate":
            walk(node.children[0], parent_kind)
            return
        kind = "Source" if isinstance(node, source_types) \
            else type(node).__name__
        out.append((kind, tuple(node.schema.names)))
        for c in node.children:
            walk(c, kind)
    walk(plan)
    return out


def _shared(plan) -> int:
    """The subplans read more than once (a table read twice is a source
    each time it is read, so it does not count)."""
    refs: Counter = Counter()
    inner = set()

    def walk(node):
        refs[id(node)] += 1
        if node.children:
            inner.add(id(node))
        if refs[id(node)] == 1:
            for c in node.children:
                walk(c)
    walk(plan)
    return sum(1 for k, v in refs.items() if v > 1 and k in inner)


@pytest.fixture(scope="module")
def sessions():
    port = TorchSession(device="cpu")
    ref = TpuSession({"spark.rapids.sql.enabled": False})
    return (port, tpch.load(port, tpch.gen_tables(1 << 12, seed=2)),
            ref, rtpch.load(ref, rtpch.gen_tables(1 << 12, seed=2)))


@pytest.mark.parametrize("q", sorted(tpch.QUERIES))
def test_tpch_pruned_columns_match_reference(sessions, q):
    """A query without a shared subplan: the reference's pruned tree; one
    with (Q11's, Q15's, Q22's): its subplan stays shared."""
    port, pdfs, ref, rdfs = sessions
    logical = tpch.QUERIES[q](pdfs)._plan
    got = prune_columns(logical)
    if _shared(logical):
        assert _shared(got) == _shared(logical)
        return
    want = ref_prune(rtpch.QUERIES[q](rdfs)._plan)
    assert _signature(got, (L.DeviceRelation,)) == _signature(
        want, (RL.CachedRelation, RL.LocalRelation))


@pytest.mark.parametrize("q", DS_QUERIES)
def test_tpcds_pruned_columns_match_reference(q):
    port = TorchSession(device="cpu")
    ref = TpuSession({"spark.rapids.sql.enabled": False})
    got = prune_columns(tpcds.QUERIES[q](tpcds.load(
        port, tpcds.gen_tables(1 << 12, seed=2)))._plan)
    want = ref_prune(rtpcds.QUERIES[q](rtpcds.load(
        ref, rtpcds.gen_tables(1 << 12, seed=2)))._plan)
    assert _signature(got, (L.DeviceRelation,)) == _signature(
        want, (RL.CachedRelation, RL.LocalRelation))


@pytest.mark.parametrize("q", sorted(SHARED))
def test_shared_subplan_is_pruned_once(sessions, q):
    port, pdfs, _, _ = sessions
    logical = tpch.QUERIES[q](pdfs)._plan
    assert _shared(logical) >= 1
    pruned = prune_columns(logical)
    assert _shared(pruned) == _shared(logical)
    plan = port.plan(logical)
    reused = []

    def walk(node, seen):
        if id(node) in seen:
            return
        seen.add(id(node))
        if isinstance(node, E.ReusedExec):
            reused.append(node)
        for c in node.children:
            walk(c, seen)
    walk(plan, set())
    assert len(reused) == 1
    assert plan.tree_string().count("Reused") == 2  # one node, two parents
