"""Column pruning — port of ``spark_rapids_tpu/plan/optimizer.py:51
prune_columns``.

The pass threads the set of column names each node's consumers need
from the root down, drops the projections nobody reads, and puts a
narrowing ``Project`` under filters, sorts, joins and unions where the
child carries more columns than that set (``None``: every column, at the
root and under the nodes it does not model). Nodes whose schema repeats
a name are left alone: narrowing by name would be ambiguous.

Where the port differs from the reference (ROADMAP C): an uploaded table
(``DeviceRelation``) is narrowed to a relation of the needed columns
alone, the same tensors selected when the plan is made, instead of a
``Project`` over it, and so is a projection of its plain columns; an
aggregate gets no narrowing ``Project`` over any other child, since it
reads its inputs by name and outputs only what it computes (a
``Project`` there is one more operator on the card with nothing to do).

A logical node the query references more than once (Q15's revenue view,
Q22's customers) is pruned once, with the union of what its references
need, and stays one node, so the planner still plans it as one
``ReusedExec`` (two evaluations of a float sum can differ in their last
bits on the card). The reference rebuilds such a node once per
reference. Each reference narrows the shared node to its own need with
a ``Project`` above it.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, FrozenSet, List, Optional

from .. import types as T
from ..data.batch import ColumnarBatch
from ..ops.expression import AttributeReference, col
from . import logical as L

_Req = Optional[FrozenSet[str]]


def _refs(exprs) -> FrozenSet[str]:
    out = set()
    for e in exprs:
        out.update(e.references())
    return frozenset(out)


def _has_dup_names(schema) -> bool:
    names = schema.names
    return len(set(names)) != len(names)


def _selected(rel: L.DeviceRelation, names: List[str]) -> L.DeviceRelation:
    """The uploaded table ``rel`` as a relation of the columns ``names``
    alone, in that order: the same tensors."""
    b = rel.batch
    idx = [b.schema.index_of(n) for n in names]
    return L.DeviceRelation(ColumnarBatch(
        tuple(b.columns[i] for i in idx), b.n_rows,
        T.Schema([b.schema[i] for i in idx]), live=b.live))


def _narrow(plan: L.LogicalPlan, req: _Req, project: bool = True
            ) -> L.LogicalPlan:
    """``plan`` cut to the columns in ``req``, when that is strictly
    narrower: an uploaded table as a relation of those columns, another
    node under a ``Project`` of them (only with ``project``)."""
    if req is None or _has_dup_names(plan.schema):
        return plan
    names = plan.schema.names
    keep = [n for n in names if n in req]
    if not keep or len(keep) == len(names):
        return plan
    if isinstance(plan, L.DeviceRelation):
        return _selected(plan, keep)
    return L.Project(plan, [col(n) for n in keep]) if project else plan


def _union(a: _Req, b: _Req) -> _Req:
    return None if a is None or b is None else a | b


def _child_needs(plan: L.LogicalPlan, req: _Req) -> List[_Req]:
    """What ``plan`` needs of each child when its consumers need
    ``req``."""
    if isinstance(plan, L.Project):
        return [_refs(_kept_exprs(plan, req))]
    if isinstance(plan, L.Filter):
        return [None if req is None else req | _refs([plan.condition])]
    if isinstance(plan, L.Aggregate):
        return [_refs(plan.groupings + [a.func for a in plan.aggregates])]
    if isinstance(plan, L.Sort):
        return [None if req is None else
                req | _refs([o.child for o in plan.orders])]
    if isinstance(plan, L.Limit):
        return [req]
    if isinstance(plan, L.Join):
        left, right = plan.children
        if req is None:
            return [None, None]
        cond = _refs([plan.condition]) if plan.condition is not None \
            else frozenset()
        return [frozenset((req | cond) & set(left.schema.names))
                | _refs(plan.left_keys),
                frozenset((req | cond) & set(right.schema.names))
                | _refs(plan.right_keys)]
    if isinstance(plan, L.Union):
        if req is None or _has_dup_names(plan.schema):
            return [None] * len(plan.children)
        idxs = [i for i, n in enumerate(plan.schema.names) if n in req]
        return [frozenset(c.schema.names[i] for i in idxs)
                for c in plan.children]
    return [None] * len(plan.children)


def _kept_exprs(plan: L.Project, req: _Req):
    if req is None:
        return plan.exprs
    kept = [e for e in plan.exprs if e.name in req]
    return kept or plan.exprs[:1]  # never project to zero columns


def prune_columns(plan: L.LogicalPlan) -> L.LogicalPlan:
    """``plan`` with the columns nobody reads dropped."""
    parents: Counter = Counter()
    order: List[L.LogicalPlan] = []

    def visit(node):
        parents[id(node)] += 1
        if parents[id(node)] == 1:
            for c in node.children:
                visit(c)
            order.append(node)
    visit(plan)
    # Requirements flow root-down: a node's is complete once every one
    # of its parents has been handled, i.e. in reverse post-order.
    need: Dict[int, _Req] = {id(plan): None}
    seen_req: Dict[int, bool] = {}
    demands: Dict[tuple, _Req] = {}
    for node in reversed(order):
        req = need[id(node)]
        for i, (c, creq) in enumerate(zip(node.children,
                                          _child_needs(node, req))):
            demands[(id(node), i)] = creq
            if not seen_req.get(id(c)):
                need[id(c)] = creq
                seen_req[id(c)] = True
            else:
                need[id(c)] = _union(need[id(c)], creq)
    built: Dict[int, L.LogicalPlan] = {}
    for node in order:  # children before parents
        built[id(node)] = _rebuild(node, need[id(node)], built, demands)
    return built[id(plan)]


def _rebuild(plan: L.LogicalPlan, req: _Req, built, demands
             ) -> L.LogicalPlan:
    kids = [built[id(c)] for c in plan.children]

    def narrowed(i, project=True):
        # a shared child is narrowed to this parent's own demand
        return _narrow(kids[i], demands[(id(plan), i)], project)

    if isinstance(plan, L.Project):
        exprs = _kept_exprs(plan, req)
        names = [e.name for e in exprs]
        if isinstance(kids[0], L.DeviceRelation) and len(set(names)) == \
                len(names) and all(type(e) is AttributeReference
                                   for e in exprs):
            return _selected(kids[0], names)
        return L.Project(kids[0], exprs)
    if isinstance(plan, L.Filter):
        return L.Filter(narrowed(0), plan.condition)
    if isinstance(plan, L.Aggregate):
        return L.Aggregate(narrowed(0, project=False), plan.groupings,
                           plan.aggregates)
    if isinstance(plan, L.Sort):
        return L.Sort(narrowed(0), plan.orders)
    if isinstance(plan, L.Limit):
        return L.Limit(kids[0], plan.n)
    if isinstance(plan, L.Join):
        return L.Join(narrowed(0), narrowed(1), plan.join_type,
                      plan.left_keys, plan.right_keys, plan.condition)
    if isinstance(plan, L.Union):
        return L.Union([narrowed(i) for i in range(len(kids))])
    # Unmodeled nodes (windows, expand, generate, exchanges, sources):
    # every column below; with an unchanged child schema a shallow copy
    # keeps what the node derived from it valid.
    if any(a is not b for a, b in zip(kids, plan.children)):
        import copy
        plan = copy.copy(plan)
        plan.children = kids
    return plan
