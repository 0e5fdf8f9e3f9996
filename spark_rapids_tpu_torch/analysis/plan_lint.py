"""Plan lint — port of ``spark_rapids_tpu/analysis/plan_lint.py``: a
static schema and partitioning verifier for the port's physical plans.

The overrides pass (:mod:`..plan.overrides`) proves every node
convertible before it runs; nothing re-verified the plan the rewrite
produced, so a wrong rule, or an encoder declaring one physical width
and writing another, became a wrong answer. This walk checks, per node:

* **schema consistency**: a node that stores its schema rather than
  deriving it (unions, joins, windows, expand, generate) against its
  children (type, nullability direction, field order); every
  ``AttributeReference`` names a column of the node's input, and every
  ``BoundReference``'s ordinal and type agree with the field it points
  at;
* **cast legality**: every ``Cast`` in the plan is a pair the port's
  cast matrix (:mod:`..ops.cast`) implements, so an illegal cast fails
  at plan time, not mid-query;
* **host/device transitions**: a node consumes device batches exactly
  when its children produce them; ``HostToDeviceExec`` and
  ``DeviceToHostExec`` are the only flips, and the plan's root is on the
  host;
* **partitioning**: when both inputs of a shuffled join are
  hash-partitioned exchanges, they agree on the partition count and are
  partitioned on the join keys (both warn: a join here reads whole
  sides, so a broken contract costs work, not rows);
* **writer widths**: the parquet physical width each column declares is
  the width the device encoder writes, and its ConvertedType is the
  spec's. The spec constants are copied here on purpose, independent of
  :mod:`..io.parquet_encode`: the verifier re-derives, it does not trust.

Violations carry the node path, by the port's class names. Error
severity raises :class:`PlanLintError`; warn severity is returned to the
caller (``TorchSession.plan`` warns and falls back to the CPU plan).
Keys: ``spark.rapids.tpu.planLint.enabled`` and
``spark.rapids.tpu.planLint.failOnWarn``. The reference's model-score
check waits for the port's ML slice.

A session keeps each verdict in a :class:`LintMemo` under the plan's
:func:`plan_key`, so a plan it runs again is not walked again.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Tuple

from .. import types as T
from ..ops.cast import Cast
from ..ops.expression import (AttributeReference, BoundReference, Expression,
                              Literal)
from ..utils import lockdep

ERROR = "error"
WARN = "warn"


@dataclasses.dataclass(frozen=True)
class PlanLintViolation:
    #: schema | cast | transition | partitioning | writer-width
    #: | internal (a check itself could not run)
    check: str
    severity: str   # error | warn
    node_path: str  # e.g. "DeviceToHostExec/ProjectExec[0]"
    message: str

    def __str__(self) -> str:
        return f"[{self.severity}] {self.check} at {self.node_path}: " \
               f"{self.message}"


class PlanLintError(Exception):
    """One or more error-severity plan-lint violations."""

    def __init__(self, violations: List[PlanLintViolation]):
        self.violations = list(violations)
        super().__init__(
            "plan verification failed:\n  "
            + "\n  ".join(str(v) for v in violations))


# ---------------------------------------------------------------------------
# Cast lattice (what ops/cast.py implements, on the device or the host)
# ---------------------------------------------------------------------------

_NUMERIC_ISH = frozenset(
    ["boolean", "tinyint", "smallint", "int", "bigint", "float", "double"])
_STRING_PARSE_TARGETS = _NUMERIC_ISH | {"date", "timestamp"}
_STRING_FORMAT_SOURCES = _NUMERIC_ISH | {"date", "timestamp"}
#: the name of a null literal's type (the port types a null literal by
#: its context, so only a foreign plan carries it)
_NULL = "null"


def legal_cast(src: T.DataType, to: T.DataType) -> bool:
    """True when the port's cast matrix implements ``src -> to``."""
    if isinstance(src, (T.ArrayType, T.StructType)) \
            or isinstance(to, (T.ArrayType, T.StructType)):
        return src.name == to.name
    if src.name == to.name or src.name == _NULL:
        return True
    if src.name in _NUMERIC_ISH and to.name in _NUMERIC_ISH:
        return True
    if src.name == "string" and to.name in _STRING_PARSE_TARGETS:
        return True
    if to.name == "string" and src.name in _STRING_FORMAT_SOURCES:
        return True
    return {src.name, to.name} == {"date", "timestamp"}


# ---------------------------------------------------------------------------
# Parquet spec constants: independent copies (see the module doc)
# ---------------------------------------------------------------------------

#: physical type code -> PLAIN value width in bytes (None: bit- or
#: length-coded)
_SPEC_PHYS_WIDTH = {0: None, 1: 4, 2: 8, 4: 4, 5: 8, 6: None}
#: type name -> the ConvertedType the parquet spec assigns it
_SPEC_CONVERTED = {"int": None, "bigint": None, "float": None, "double": None,
                   "boolean": None, "date": 6, "timestamp": 10,
                   "smallint": 16, "tinyint": 15, "string": 0}


# ---------------------------------------------------------------------------
# Walking the plan
# ---------------------------------------------------------------------------


def _node_path(path: List[str]) -> str:
    return "/".join(path) if path else "<root>"


def _expr_sites(node):
    """``(expression, side)`` of one node: the input each expression
    resolves against, ``"child"`` (the first child), ``"both"`` (the
    two children's columns, a join condition), ``"left"`` or
    ``"right"``. The CPU operators and the device execs share their
    attribute names, so one sweep covers both sides of every rule."""
    two = len(node.children) == 2
    for e in getattr(node, "exprs", []) or []:
        yield e, "child"
    cond = getattr(node, "condition", None)
    if isinstance(cond, Expression):
        yield cond, "both" if two else "child"
    for g in getattr(node, "groupings", []) or []:
        yield g, "child"
    for a in getattr(node, "aggregates", []) or []:
        fn = getattr(a, "func", None)
        if isinstance(fn, Expression):
            yield fn, "child"
    if two:
        for k in getattr(node, "left_keys", []) or []:
            yield k, "left"
        for k in getattr(node, "right_keys", []) or []:
            yield k, "right"
    for o in getattr(node, "orders", []) or []:
        yield o.child, "child"
    for _, we in getattr(node, "window_exprs", []) or []:
        for c in we.func.children:
            yield c, "child"
        for e in we.spec.partition_by:
            yield e, "child"
        for o in we.spec.order_by:
            yield o.child, "child"
    for proj in getattr(node, "projections", []) or []:
        for e in proj:
            yield e, "child"
    gen = getattr(node, "generator", None)
    if isinstance(gen, Expression):
        yield gen, "child"
    factory = getattr(node, "partitioner_factory", None)
    if factory is not None:
        for k in getattr(factory, "keys", None) or []:
            yield k, "child"
        for o in getattr(factory, "orders", None) or []:
            yield o.child, "child"


def _expr_lists(node) -> List[Tuple[Expression, Optional[T.Schema]]]:
    """``(expression, the input schema it resolves against)`` pairs of
    one node (:func:`_expr_sites`)."""
    schemas = {"child": node.children[0].schema if node.children else None}
    if len(node.children) == 2:
        left = node.children[0].schema
        right = node.children[1].schema
        schemas.update(left=left, right=right,
                       both=T.Schema(list(left) + list(right)))
    return [(e, schemas[side]) for e, side in _expr_sites(node)]


def _walk_expr(e: Expression):
    yield e
    for c in e.children:
        yield from _walk_expr(c)


def _nullable_ok(child_field: T.StructField, out_field: T.StructField) -> bool:
    """Nullability may widen across a node, never narrow: a nullable
    input under a non-nullable declared output can produce nulls where
    the schema promises none."""
    return out_field.nullable or not child_field.nullable


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------


def _check_expressions(node, path, out: List[PlanLintViolation]):
    for expr, schema in _expr_lists(node):
        for e in _walk_expr(expr):
            if isinstance(e, Cast):
                try:
                    src = e.child.data_type
                except Exception:
                    continue  # an unresolved subtree: nothing to judge
                if src is not None and not legal_cast(src, e.to):
                    out.append(PlanLintViolation(
                        "cast", ERROR, _node_path(path),
                        f"illegal cast {src} -> {e.to} in {expr}"))
            elif isinstance(e, AttributeReference) and schema is not None:
                if schema.field_maybe(e._name) is None:
                    out.append(PlanLintViolation(
                        "schema", ERROR, _node_path(path),
                        f"column {e._name!r} referenced by {expr} is not "
                        f"in the input schema {schema}"))
            elif isinstance(e, BoundReference) and schema is not None:
                if not 0 <= e.ordinal < len(schema):
                    out.append(PlanLintViolation(
                        "schema", ERROR, _node_path(path),
                        f"bound ordinal {e.ordinal} out of range for input "
                        f"schema of {len(schema)} columns"))
                elif schema[e.ordinal].data_type.name != e.data_type.name \
                        and e.data_type.name != _NULL:
                    out.append(PlanLintViolation(
                        "schema", ERROR, _node_path(path),
                        f"bound ordinal {e.ordinal} declares "
                        f"{e.data_type} but the input column "
                        f"{schema[e.ordinal].name!r} is "
                        f"{schema[e.ordinal].data_type}"))


def _check_schema(node, path, out: List[PlanLintViolation]):
    name = type(node).__name__
    try:
        schema = node.schema
    except Exception as e:  # a schema must always derive statically
        out.append(PlanLintViolation(
            "schema", ERROR, _node_path(path),
            f"output schema is not derivable: {e!r}"))
        return
    if "UnionExec" in name:
        for i, c in enumerate(node.children):
            cs = c.schema
            if len(cs) != len(schema):
                out.append(PlanLintViolation(
                    "schema", ERROR, _node_path(path),
                    f"union child {i} has {len(cs)} columns, output "
                    f"declares {len(schema)}"))
                continue
            for cf, of in zip(cs, schema):
                if not legal_cast(cf.data_type, of.data_type):
                    out.append(PlanLintViolation(
                        "schema", ERROR, _node_path(path),
                        f"union child {i} column {cf.name!r}: "
                        f"{cf.data_type} cannot cast to declared "
                        f"{of.data_type}"))
        return
    if _is_equi_join(node) or "NestedLoopJoin" in name:
        jt = getattr(node, "join_type", "inner")
        left, right = node.children[0].schema, node.children[1].schema
        expect = list(left) if jt in ("left_semi", "left_anti") \
            else list(left) + list(right)
        if len(schema) != len(expect):
            out.append(PlanLintViolation(
                "schema", ERROR, _node_path(path),
                f"{jt} join declares {len(schema)} output columns, "
                f"children supply {len(expect)}"))
            return
        for i, (cf, of) in enumerate(zip(expect, schema)):
            if cf.data_type.name != of.data_type.name:
                out.append(PlanLintViolation(
                    "schema", ERROR, _node_path(path),
                    f"join output column {i} ({of.name!r}) declares "
                    f"{of.data_type} but the child supplies "
                    f"{cf.data_type}"))
            elif not _nullable_ok(cf, of):
                out.append(PlanLintViolation(
                    "schema", ERROR, _node_path(path),
                    f"join output column {i} ({of.name!r}) declares "
                    f"non-nullable but the child column is nullable"))
        return
    if "WindowExec" in name:
        child = node.children[0].schema
        if len(schema) < len(child):
            out.append(PlanLintViolation(
                "schema", ERROR, _node_path(path),
                f"window output drops child columns ({len(schema)} < "
                f"{len(child)})"))
            return
        for i, (cf, of) in enumerate(zip(child, schema)):
            if cf.data_type.name != of.data_type.name \
                    or not _nullable_ok(cf, of):
                out.append(PlanLintViolation(
                    "schema", ERROR, _node_path(path),
                    f"window pass-through column {i} ({of.name!r}) "
                    f"declares {of.data_type} but the child supplies "
                    f"{cf.data_type}"))
        return
    if "ExpandExec" in name:
        for pi, proj in enumerate(getattr(node, "projections", []) or []):
            if len(proj) != len(schema):
                out.append(PlanLintViolation(
                    "schema", ERROR, _node_path(path),
                    f"expand projection {pi} has {len(proj)} expressions, "
                    f"output declares {len(schema)} columns"))
                continue
            for e, of in zip(proj, schema):
                try:
                    dt = e.data_type
                except Exception:
                    continue
                if not legal_cast(dt, of.data_type):
                    out.append(PlanLintViolation(
                        "schema", ERROR, _node_path(path),
                        f"expand projection {pi} column {of.name!r}: "
                        f"{dt} cannot cast to declared {of.data_type}"))
        return
    if "GenerateExec" in name:
        child = node.children[0].schema
        for i, (cf, of) in enumerate(zip(child, schema)):
            if cf.data_type.name != of.data_type.name:
                out.append(PlanLintViolation(
                    "schema", ERROR, _node_path(path),
                    f"generate pass-through column {i} ({of.name!r}) "
                    f"declares {of.data_type} but the child supplies "
                    f"{cf.data_type}"))
        return


def _check_transitions(node, path, parent_wants: Optional[bool],
                       out: List[PlanLintViolation]):
    name = type(node).__name__
    columnar = bool(getattr(node, "columnar", False))
    if parent_wants is not None and columnar != parent_wants:
        want = "device (columnar)" if parent_wants else "host"
        have = "device" if columnar else "host"
        out.append(PlanLintViolation(
            "transition", ERROR, _node_path(path),
            f"parent consumes {want} batches but this node produces "
            f"{have} batches — missing "
            f"{'HostToDeviceExec' if parent_wants else 'DeviceToHostExec'}"))
    if name == "HostToDeviceExec":
        wants = False
    elif name == "DeviceToHostExec":
        wants = True
    else:
        wants = bool(getattr(node, "children_columnar", columnar))
    for i, c in enumerate(node.children):
        _check_transitions(c, path + [f"{type(c).__name__}[{i}]"], wants, out)


def _is_equi_join(node) -> bool:
    """An equi join; every one of the port's is a shuffled join (it has
    no broadcast hash join)."""
    return type(node).__name__ in ("CpuJoinExec", "ShuffledHashJoinExec")


#: nodes that pass their single child's partitioning through unchanged
_PARTITION_PRESERVING = (
    "CpuFilterExec", "FilterExec", "CpuLocalLimitExec",
    "CoalesceBatchesExec", "HostToDeviceExec", "DeviceToHostExec",
    "ReusedExec",
)


def _expr_name(e) -> str:
    return getattr(e, "_name", None) or getattr(e, "name", None) or str(e)


def _partitioning(node):
    """The output partitioning, bottom-up: ``("hash", key names,
    n_parts)``, ``("single",)`` or None."""
    name = type(node).__name__
    if name == "ShuffleExchangeExec":
        factory = node.partitioner_factory
        mode = getattr(factory, "mode", None)
        if mode == "hash":
            keys = tuple(_expr_name(k)
                         for k in (getattr(factory, "keys", None) or []))
            return ("hash", keys, node.n_parts)
        if mode == "single":
            return ("single",)
        return None
    if name in _PARTITION_PRESERVING and node.children:
        return _partitioning(node.children[0])
    if name in ("CpuProjectExec", "ProjectExec"):
        child = _partitioning(node.children[0])
        if child is not None and child[0] == "hash":
            names = {_expr_name(e) for e in node.exprs}
            if all(k in names for k in child[1]):
                return child
        return None
    return None


def _check_partitioning(node, path, out: List[PlanLintViolation]):
    if not _is_equi_join(node) or not getattr(node, "left_keys", None):
        return
    lp = _partitioning(node.children[0])
    rp = _partitioning(node.children[1])
    if lp is None or rp is None or lp[0] != "hash" or rp[0] != "hash":
        return
    # Both are warns: a join reads its whole sides, so a broken
    # co-partitioning contract costs shuffle work but loses no row, and
    # left.repartition(4).join(right.repartition(8)) is a legal shape
    # that must keep answering. planLint.failOnWarn promotes them.
    if lp[2] != rp[2]:
        out.append(PlanLintViolation(
            "partitioning", WARN, _node_path(path),
            f"shuffled join inputs are hash-partitioned into {lp[2]} vs "
            f"{rp[2]} partitions — co-partitioning contract broken"))
    lkeys = tuple(_expr_name(k) for k in node.left_keys)
    rkeys = tuple(_expr_name(k) for k in node.right_keys)
    if lp[1] != lkeys or rp[1] != rkeys:
        out.append(PlanLintViolation(
            "partitioning", WARN, _node_path(path),
            f"shuffled join inputs are hash-partitioned on {lp[1]}/{rp[1]} "
            f"but joined on {lkeys}/{rkeys}; rows with equal join keys may "
            f"land in different partitions"))


def _check_writer(node, path, out: List[PlanLintViolation]):
    if type(node).__name__ != "WriteFilesExec" \
            or getattr(node, "fmt", None) != "parquet":
        return
    from ..io import parquet_encode as PE
    part_cols = set(getattr(node, "partition_by", []) or [])
    for f in node.children[0].schema:
        if f.name in part_cols or f.data_type.name not in PE._PHYS:
            continue
        phys, conv = PE._PHYS[f.data_type.name]
        spec_width = _SPEC_PHYS_WIDTH.get(phys)
        emitted = PE.encoded_value_dtype(f.data_type)
        if spec_width is not None and (emitted is None
                                       or emitted.itemsize != spec_width):
            have = "nothing" if emitted is None \
                else f"{emitted.itemsize}-byte {emitted} values"
            out.append(PlanLintViolation(
                "writer-width", ERROR, _node_path(path),
                f"column {f.name!r} ({f.data_type}) declares a "
                f"{spec_width}-byte parquet physical type but the device "
                f"encoder serializes {have} — readers would see a "
                f"truncated stream"))
        spec_conv = _SPEC_CONVERTED.get(f.data_type.name)
        if conv != spec_conv:
            out.append(PlanLintViolation(
                "writer-width", ERROR, _node_path(path),
                f"column {f.name!r} ({f.data_type}) annotates "
                f"ConvertedType {conv} but the parquet spec assigns "
                f"{spec_conv}"))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def lint_plan(plan, stage: str = "post-overrides"
              ) -> List[PlanLintViolation]:
    """Every check over ``plan``; returns every violation (pure). A node
    shared by several parents (a ``ReusedExec``) is checked once."""
    out: List[PlanLintViolation] = []
    seen = set()

    def guarded(check, node, path):
        # the verifier never raises out of its own checks: a check that
        # trips over an underivable child schema (the child's own visit
        # reports why) becomes a violation
        try:
            check(node, path, out)
        except Exception as e:
            out.append(PlanLintViolation(
                "internal", ERROR, _node_path(path),
                f"{check.__name__} could not run: {e!r}"))

    def walk(node, path):
        if id(node) in seen:
            return
        seen.add(id(node))
        guarded(_check_schema, node, path)
        guarded(_check_expressions, node, path)
        guarded(_check_partitioning, node, path)
        guarded(_check_writer, node, path)
        for i, c in enumerate(node.children):
            walk(c, path + [f"{type(c).__name__}[{i}]"])

    root_path = [type(plan).__name__]
    walk(plan, root_path)
    # The transitions are an invariant of the rewritten plan: the CPU
    # plan holds device nodes (uploaded tables, the exchange) under host
    # parents until the overrides pass inserts the flips.
    if stage == "post-overrides":
        _check_transitions(plan, root_path, None, out)
        if getattr(plan, "columnar", False):
            out.append(PlanLintViolation(
                "transition", ERROR, _node_path(root_path),
                "plan root produces device batches; the root must be "
                "host-side (missing DeviceToHostExec)"))
    return out


def plan_key(plan) -> tuple:
    """What the checks read of ``plan``, as a key its verdict can be kept
    under: the tree's text, the schema (names, types, nullability) of
    every leaf, and the type of every literal (a literal prints its value
    only). Every other node's schema follows from these; a plan built
    again from the same query and inputs has the same key."""
    leaves, lits = [], []

    def walk(node):
        if not node.children:
            leaves.append(tuple((f.name, str(f.data_type), f.nullable)
                                for f in node.schema))
        for expr, _ in _expr_sites(node):
            lits.extend(str(e.data_type) for e in _walk_expr(expr)
                        if isinstance(e, Literal))
        for c in node.children:
            walk(c)

    walk(plan)
    return plan.tree_string(), tuple(leaves), tuple(lits)


class LintMemo:
    """A session's plan-lint verdicts by ``(stage, plan_key)``: the warns
    of a plan that raised no error (a plan that raised is checked again
    when it comes again). Bounded; the least recently used verdict goes
    first. The session drops it when its conf changes."""

    #: two verdicts a plan: 512 plans, each key a few KB of plan text
    MAX_ENTRIES = 1024

    def __init__(self):
        self._lock = lockdep.lock("LintMemo._lock")
        self._verdicts: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()

    def get(self, key) -> Optional[tuple]:
        with self._lock:
            got = self._verdicts.get(key)
            if got is not None:
                self._verdicts.move_to_end(key)
            return got

    def put(self, key, warns: List[PlanLintViolation]) -> None:
        with self._lock:
            self._verdicts[key] = tuple(warns)
            while len(self._verdicts) > self.MAX_ENTRIES:
                self._verdicts.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._verdicts)


def verify_plan(plan, conf=None, stage: str = "post-overrides",
                memo: Optional[LintMemo] = None,
                hits: Optional[list] = None) -> List[PlanLintViolation]:
    """The gated entry: raises :class:`PlanLintError` on error-severity
    violations (on any violation under ``planLint.failOnWarn``) and
    returns the warns for the caller's fallback decision. Returns [] when
    ``planLint.enabled`` is off. With ``memo``, a plan whose
    :func:`plan_key` holds a verdict takes it without a walk (and adds
    one to ``hits[0]``, when given)."""
    from ..config import PLAN_LINT_ENABLED, PLAN_LINT_FAIL_ON_WARN
    if conf is not None and not conf.get(PLAN_LINT_ENABLED):
        return []
    key = None
    if memo is not None:
        try:
            key = (stage, plan_key(plan))
        except Exception:  # noqa: BLE001 - the walk below reports why
            key = None
        got = None if key is None else memo.get(key)
        if got is not None:
            if hits is not None:
                hits[0] += 1
            return list(got)
    violations = lint_plan(plan, stage)
    fail_on_warn = conf is not None and conf.get(PLAN_LINT_FAIL_ON_WARN)
    errors = [v for v in violations
              if v.severity == ERROR or fail_on_warn]
    if errors:
        raise PlanLintError(errors)
    warns = [v for v in violations if v.severity == WARN]
    if key is not None:
        memo.put(key, warns)
    return warns
