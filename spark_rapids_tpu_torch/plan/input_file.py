"""The plan-time rewrite of the ``input_file_name()`` family — port of
``spark_rapids_tpu/plan/input_file.py``.

The file scan emits three hidden columns, constant per file (the path,
a one-entry dictionary; the split's start, 0; its length, the file's
size), and every ``InputFileName()``, ``InputFileBlockStart()`` and
``InputFileBlockLength()`` in a projection or filter becomes a reference
to its column. A plan without a file scan takes Spark's no-file
constants ('' and -1), and so does a plan with more than one scan,
whose two sets of hidden columns would share their names above a join.
The rewrite runs on the logical plan before planning (the reference's
``session.py:257-260``), and the result is projected back to the
plan's own columns, so the hidden ones never reach the answer.
"""

from __future__ import annotations

import copy
from typing import List

from .. import types as T
from ..ops.expression import Alias, Literal, col
from ..ops.nondeterministic import (InputFileBlockLength,
                                    InputFileBlockStart, InputFileName)
from . import logical as L

FILE_NAME_COL = "__input_file_name"
FILE_START_COL = "__input_file_block_start"
FILE_LENGTH_COL = "__input_file_block_length"

META_FIELDS = [T.StructField(FILE_NAME_COL, T.STRING, False),
               T.StructField(FILE_START_COL, T.LONG, False),
               T.StructField(FILE_LENGTH_COL, T.LONG, False)]

_COL_OF = {InputFileName: FILE_NAME_COL,
           InputFileBlockStart: FILE_START_COL,
           InputFileBlockLength: FILE_LENGTH_COL}


def _contains_input_file(e) -> bool:
    return isinstance(e, tuple(_COL_OF)) or any(
        _contains_input_file(c) for c in e.children)


def _node_exprs(plan: L.LogicalPlan) -> List:
    if isinstance(plan, L.Project):
        return plan.exprs
    if isinstance(plan, L.Filter):
        return [plan.condition]
    return []


def _has_any(plan: L.LogicalPlan) -> bool:
    return any(_contains_input_file(e) for e in _node_exprs(plan)) \
        or any(_has_any(c) for c in plan.children)


def _scan_count(plan: L.LogicalPlan) -> int:
    return int(isinstance(plan, L.Scan)) + sum(_scan_count(c)
                                               for c in plan.children)


def _substitute(e, use_cols: bool):
    cls = type(e)
    if cls in _COL_OF:
        return col(_COL_OF[cls]) if use_cols \
            else Literal(e.NO_FILE, e.data_type)
    if not e.children or not _contains_input_file(e):
        return e
    return e.with_children([_substitute(c, use_cols) for c in e.children])


def _keep_name(orig, sub):
    """``sub`` under ``orig``'s output name."""
    if sub is not orig and not isinstance(sub, Alias):
        return Alias(sub, orig.name)
    return sub


def _with_children(plan: L.LogicalPlan, children) -> L.LogicalPlan:
    if children == list(plan.children):
        return plan
    new = copy.copy(plan)
    new.children = children
    return new


def _rewrite(plan: L.LogicalPlan, use_cols: bool) -> L.LogicalPlan:
    """``plan`` with the family substituted: hidden-column references
    where ``use_cols`` and the scan is below (the scan then emits the
    columns, and every projection above it passes them on), else the
    no-file constants."""
    children = [_rewrite(c, use_cols) for c in plan.children]
    here = use_cols and _scan_count(plan) > 0
    if isinstance(plan, L.Scan) and use_cols:
        new = plan.with_schema(T.Schema(list(plan.schema) + META_FIELDS))
        new.emit_file_meta = True
        return new
    if isinstance(plan, L.Project):
        exprs = [_keep_name(e, _substitute(e, here)) for e in plan.exprs]
        if here:
            have = {e.name for e in exprs}
            exprs += [col(f.name) for f in META_FIELDS if f.name not in have]
        return L.Project(children[0], exprs)
    if isinstance(plan, L.Filter):
        return L.Filter(children[0], _substitute(plan.condition, here))
    return _with_children(plan, children)


def rewrite_input_file_exprs(plan: L.LogicalPlan) -> L.LogicalPlan:
    """``plan`` unchanged unless it uses the family; else rewritten (see
    the module doc) and projected back to its own columns."""
    if not _has_any(plan):
        return plan
    names = plan.schema.names
    new = _rewrite(plan, _scan_count(plan) == 1)
    if new.schema.names != names:
        new = L.Project(new, [col(n) for n in names])
    return new
