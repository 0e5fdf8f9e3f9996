"""The plan-rewrite pass — port of ``spark_rapids_tpu/plan/overrides.py``
(the reference's ``GpuOverrides``).

The planner (:mod:`.planner`) plans every logical node to a CPU operator
(:mod:`.physical`). :class:`TorchOverrides` wraps that plan in a tree of
:class:`ExecMeta`, tags each node with the reasons it cannot run on the
device (its exec rule missing or switched off, an expression without a
rule or switched off, a type the device has no layout for, a rule's own
check), prints the explain text (``spark.rapids.sql.explain``), converts
every node that carries no reason into the port's device exec, and
inserts the transitions and the coalesce nodes (:func:`finalize_plan`).

Each rule converts to exactly the exec the port's planner built before
the rewrite existed: a limit over a sort of at most
``spark.rapids.tpu.sort.topKThreshold`` rows becomes the top-k, a local
limit under a global one is one ``LimitExec``, an equi join with a
residual keeps it inside the shuffled hash join (inner, left, semi and
anti joins; a right or full one with a residual is tagged and stays the
host's equi join), and a subplan the query reads twice stays one
:class:`~..exec.execs.ReusedExec`.

Rules that differ from the reference's (ROADMAP C): the port's
``variableFloatAgg``, ``castStringToFloat`` and
``castStringToTimestamp`` default to true, so the default path keeps the
float sums and the string parsers on the device, as it always ran them;
a non-inner join's residual is not a reason (the device applies it while
matching); an uploaded table (``DeviceSourceExec``) and the shuffle
exchange are device nodes in the CPU plan already (no CPU exchange is
ported); a parquet scan with the input-file columns decodes on the
device (the reference reads it on the host).

The file scan's rule (``FileSourceScan``, the reference's
``_device_scan_or_none``, ``overrides.py:690-760``) swaps the host scan
(:class:`~..io.files.CpuFileScanExec`) for the device scan of its
format, :class:`~..io.parquet_device.ParquetScanExec`,
:class:`~..io.orc_device.OrcScanExec` or
:class:`~..io.csv_device.CsvScanExec`, unless its
``spark.rapids.sql.<format>.deviceDecode.enabled`` is false, the layout
is hive-partitioned, an ORC or CSV scan emits the input-file columns,
or a file is out of the device's scope (the format's
``device_decodable``); the reason shows in the explain, and the host
scan is a legitimate host node in test mode, as there. The writer's
rule (``DataWritingCommand``, ``:568-577``) swaps the host writer for
:class:`~..io.writers.WriteFilesExec`, which reads device batches.

A node reaches the host only here, by its tag: no device exec, kernel or
launch falls back to the host at run time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Type

from .. import types as T
from ..config import (BATCH_SIZE_ROWS, CSV_DEVICE_DECODE,
                      OPERATOR_KEY_PREFIXES, ORC_DEVICE_DECODE,
                      PARQUET_DEVICE_DECODE, PARQUET_REBASE_READ,
                      REPLACE_SORT_MERGE_JOIN, TOPK_THRESHOLD,
                      VARIABLE_FLOAT_AGG, TorchConf)
from ..exec import execs as E
from ..exec.execs import ReusedExec
from ..exec.joins import NestedLoopJoinExec
from ..exec.window_exec import WindowExec
from ..io.files import CpuFileScanExec
from ..io.writers import CpuWriteFilesExec, WriteFilesExec
from ..ops import aggregates as AGG
from ..ops import complex as CPX
from ..ops import datetime as DT
from ..ops import nondeterministic as ND
from ..ops import strings as STR
from ..ops import strings2 as STR2
from ..ops import windows as W
from ..ops.cast import Cast
from ..ops.expression import Expression, Literal
from . import physical as P


# ---------------------------------------------------------------------------
# Expression rules (the reference's ExprRule registry, overrides.py:46-230)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ExprRule:
    name: str
    #: extra check: a reason string, or None
    tag: Optional[Callable[[Expression, TorchConf], Optional[str]]] = None


EXPR_RULES: Dict[Type[Expression], ExprRule] = {}


def _expr(cls, tag=None):
    EXPR_RULES[cls] = ExprRule(cls.__name__, tag)


def _cast_tag(e: Cast, conf: TorchConf) -> Optional[str]:
    from ..config import CAST_STRING_TO_FLOAT, CAST_STRING_TO_TIMESTAMP
    src, to = e.child.data_type, e.to
    if src is T.STRING and to.is_floating \
            and not conf.get(CAST_STRING_TO_FLOAT):
        return ("string->float cast differs on edge cases; set "
                "spark.rapids.sql.castStringToFloat.enabled=true")
    if src is T.STRING and to is T.TIMESTAMP \
            and not conf.get(CAST_STRING_TO_TIMESTAMP):
        return ("string->timestamp cast supports fixed formats only; set "
                "spark.rapids.sql.castStringToTimestamp.enabled=true")
    if src.is_floating and to is T.STRING:
        return ("float->string cast is not supported on the device "
                "(reference gates it behind castFloatToString)")
    return None


def _like_tag(e: STR.Like, conf: TorchConf) -> Optional[str]:
    if len(e.tokens()) > 48:
        return ("LIKE pattern longer than 48 tokens runs on CPU (compiled "
                "wildcard-DP program size)")
    return None


def _substring_tag(e: STR.Substring, conf: TorchConf) -> Optional[str]:
    if not isinstance(e.children[1], Literal) or \
            not isinstance(e.children[2], Literal):
        return "substring with non-literal pos/len is not supported on device"
    return None


def _regexp_tag(e: STR2.RegExpReplace, conf: TorchConf) -> Optional[str]:
    if not e.is_literal_pattern:
        return ("regexp_replace with regex metacharacters runs on CPU "
                "(the reference lowers only literal patterns, "
                "GpuStringReplace rule)")
    return None


def _string_split_tag(e, conf: TorchConf) -> Optional[str]:
    return ("ARRAY<STRING> has no device layout; split(str, delim) "
            "evaluates on the host path (reference GpuStringSplit gates "
            "to literal patterns, stringFunctions.scala:862)")


def _input_file_tag(e, conf: TorchConf) -> Optional[str]:
    # rewritten into hidden scan columns before planning
    # (plan/input_file.py); one surviving here sits where the rewrite
    # does not reach
    return ("input_file expressions are only supported in projections and "
            "filters (rewritten to scan metadata columns)")


def _unix_ts_tag(e, conf: TorchConf) -> Optional[str]:
    if e.children[0].data_type is T.STRING and \
            not DT._supported_format(e.fmt):
        return (f"timestamp pattern {e.fmt!r} is outside the fixed-width "
                "yyyy/MM/dd[/HH/mm/ss] family the device parses "
                "(reference fixed-format stance)")
    return None


def _from_unixtime_tag(e, conf: TorchConf) -> Optional[str]:
    if not DT._supported_format(e.fmt):
        return (f"timestamp pattern {e.fmt!r} is outside the fixed-width "
                "yyyy/MM/dd[/HH/mm/ss] family the device parses "
                "(reference fixed-format stance)")
    return None


def _get_array_item_tag(e: CPX.GetArrayItem, conf: TorchConf
                        ) -> Optional[str]:
    if not isinstance(e.children[1], Literal):
        return ("GetArrayItem with a non-literal ordinal is not supported "
                "(reference complexTypeExtractors.scala limits to literal "
                "ordinals)")
    return None


_TAGS = {
    Cast: _cast_tag, STR.Like: _like_tag, STR.Substring: _substring_tag,
    STR2.RegExpReplace: _regexp_tag, STR2.StringSplit: _string_split_tag,
    ND.InputFileName: _input_file_tag, ND.InputFileBlockStart:
    _input_file_tag, ND.InputFileBlockLength: _input_file_tag,
    DT.UnixTimestamp: _unix_ts_tag, DT.FromUnixTime: _from_unixtime_tag,
    CPX.GetArrayItem: _get_array_item_tag,
}


def _register_expressions() -> None:
    """A rule for every expression class of the port (its modules are
    imported above), with the reference's tag where it has one."""
    from ..ops import (arithmetic, bitwise, conditional, math,  # noqa: F401
                       predicates)
    seen = set()
    todo = list(Expression.__subclasses__())
    while todo:
        cls = todo.pop()
        if cls in seen:
            continue
        seen.add(cls)
        todo.extend(cls.__subclasses__())
        if cls.__name__.startswith("_"):
            continue
        _expr(cls, tag=_TAGS.get(cls))


_register_expressions()


# ---------------------------------------------------------------------------
# The meta tree (the reference's ExecMeta, overrides.py:234-323)
# ---------------------------------------------------------------------------


class ExecMeta:
    """One physical node and why it cannot be replaced."""

    def __init__(self, node: E.TorchExec, rule: Optional["ExecRule"],
                 children: List["ExecMeta"]):
        self.node = node
        self.rule = rule
        self.children = children
        self.reasons: List[str] = []
        self._converted = None
        self._tagged = False

    def will_not_work(self, reason: str) -> None:
        if reason not in self.reasons:
            self.reasons.append(reason)

    @property
    def can_replace(self) -> bool:
        return not self.reasons

    @property
    def passthrough(self) -> bool:
        """A node the CPU plan already holds as it runs: a source, the
        exchange, a shared subplan's wrapper."""
        return self.rule is None and _is_kept(self.node)

    # -- tagging ------------------------------------------------------------
    def tag(self, conf: TorchConf) -> None:
        if self._tagged:  # a shared subplan, reached again
            return
        self._tagged = True
        for c in self.children:
            c.tag(conf)
        if self.passthrough:
            return
        if self.rule is None:
            self.will_not_work(
                f"no TPU replacement rule for {self.node.node_name()}")
            return
        key = TorchConf.operator_conf_key("exec", self.rule.name)
        if not conf.is_operator_enabled(key):
            self.will_not_work(f"{key} is disabled")
        # every input column must have a device layout: a host child's
        # whole output crosses the upload (the reference's
        # RapidsMeta.tagForGpu:186-213)
        for child in self.node.children:
            for f in child.schema:
                if not T.device_supported(f.data_type):
                    self.will_not_work(
                        f"input column {f.name}: type {f.data_type} is "
                        "not supported on TPU")
        for expr in self.rule.exprs_of(self.node):
            self._tag_expr(expr, conf)
        if self.rule.tag is not None:
            self.rule.tag(self, conf)

    def _tag_expr(self, expr: Expression, conf: TorchConf) -> None:
        rule = EXPR_RULES.get(type(expr))
        if rule is None:
            self.will_not_work(
                f"expression {type(expr).__name__} is not supported on TPU")
        else:
            key = TorchConf.operator_conf_key("expression", rule.name)
            if not conf.is_operator_enabled(key):
                self.will_not_work(f"{key} is disabled")
            if rule.tag is not None:
                reason = rule.tag(expr, conf)
                if reason:
                    self.will_not_work(reason)
            try:
                dt = expr.data_type
            except (RuntimeError, NotImplementedError):
                dt = None
            if dt is not None and not T.device_supported(dt):
                self.will_not_work(f"type {dt} is not supported on TPU")
        for c in expr.children:
            self._tag_expr(c, conf)

    # -- conversion ---------------------------------------------------------
    def convert(self, conf: TorchConf) -> E.TorchExec:
        """The node's exec over its converted children; a shared node
        converts once."""
        if self._converted is not None:
            return self._converted
        kids = [c.convert(conf) for c in self.children]
        node = self.node
        if self.passthrough or not self.can_replace:
            out = node if all(a is b for a, b in zip(kids, node.children)) \
                else node.with_children(kids)
        else:
            out = self.rule.convert(node, kids, conf)
        self._converted = out
        return out

    # -- explain (the reference's RapidsMeta.explain) -----------------------
    def explain(self, all_nodes: bool, indent: int = 0) -> str:
        marker = "*" if self.can_replace else "!"
        line = ""
        if all_nodes or not self.can_replace:
            reason = "" if self.can_replace else \
                " cannot run on TPU because " + "; ".join(self.reasons)
            line = ("  " * indent + f"{marker} {self.node.node_name()}"
                    + reason + "\n")
        for c in self.children:
            line += c.explain(all_nodes, indent + 1)
        return line


@dataclasses.dataclass
class ExecRule:
    """The replacement rule of one CPU operator class (the reference's
    ``ExecRule``, ``overrides.py:326``)."""

    name: str
    exprs_of: Callable[[E.TorchExec], List[Expression]]
    convert: Callable[[E.TorchExec, List[E.TorchExec], TorchConf],
                      E.TorchExec]
    tag: Optional[Callable[[ExecMeta, TorchConf], None]] = None


def _agg_exprs(node: P.CpuHashAggregateExec) -> List[Expression]:
    return list(node.groupings) + [a.func for a in node.aggregates]


def _no_complex_keys(meta: ExecMeta, exprs, what: str) -> None:
    for e in exprs:
        if T.is_complex(e.data_type):
            meta.will_not_work(
                f"{what} of type {e.data_type} is not supported on TPU")


def _agg_tag(meta: ExecMeta, conf: TorchConf) -> None:
    node: P.CpuHashAggregateExec = meta.node
    _no_complex_keys(meta, node.groupings, "grouping key")
    if not conf.get(VARIABLE_FLOAT_AGG):
        for a in node.aggregates:
            if isinstance(a.func, (AGG.Sum, AGG.Average)) \
                    and a.func.child is not None \
                    and a.func.child.data_type.is_floating:
                meta.will_not_work(
                    "float sum/average can differ from CPU due to reduction "
                    "order; set spark.rapids.sql.variableFloatAgg.enabled=true")


def _window_exprs(node: P.CpuWindowExec) -> List[Expression]:
    out: List[Expression] = []
    for _, we in node.window_exprs:
        out.extend(we.func.children)
        out.extend(we.spec.partition_by)
        out.extend(o.child for o in we.spec.order_by)
    return out


def _window_tag(meta: ExecMeta, conf: TorchConf) -> None:
    """The reference's ``_window_tag`` (``overrides.py:375``)."""
    for _, we in meta.node.window_exprs:
        f = we.func
        if not isinstance(f, W.WINDOW_AGG_TYPES + W.RANKING_TYPES):
            meta.will_not_work(
                f"window function {type(f).__name__} is not supported on TPU")
            continue
        if isinstance(f, (AGG.Sum, AGG.Average)) and f.children and \
                f.children[0].data_type.is_floating and \
                not conf.get(VARIABLE_FLOAT_AGG):
            meta.will_not_work(
                "windowed float sum/average can differ from CPU due to "
                "reduction order; set "
                "spark.rapids.sql.variableFloatAgg.enabled=true")
        frame = we.spec.effective_frame()
        if frame.frame_type == "range" and not isinstance(f, W.RANKING_TYPES):
            if frame.lower.kind == "offset" or frame.upper.kind == "offset":
                if len(we.spec.order_by) != 1:
                    meta.will_not_work("range frames with offsets require "
                                       "exactly one order-by key")
                else:
                    okt = we.spec.order_by[0].child.data_type
                    if okt in (T.STRING, T.BOOLEAN):
                        meta.will_not_work(
                            f"range frame offsets on {okt} order-by are not "
                            "supported (reference limits range frames to "
                            "timestamp order-by, GpuWindowExec.scala:92)")
        for e in we.spec.partition_by:
            if e.data_type not in T.DEFAULT_DEVICE_TYPES:
                meta.will_not_work(
                    f"partition key type {e.data_type} not supported")
        _no_complex_keys(meta, [o.child for o in we.spec.order_by],
                         "window order-by key")


def _join_tag(meta: ExecMeta, conf: TorchConf) -> None:
    """The reference's ``_join_tag`` (``overrides.py:416``) without its
    inner-only residual rule: the device applies a left, semi or anti
    join's residual while it matches."""
    node: P.CpuJoinExec = meta.node
    if not node.left_keys:
        meta.will_not_work("hash join requires equi keys")
    _no_complex_keys(meta, list(node.left_keys) + list(node.right_keys),
                     "join key")
    if node.condition is not None and node.join_type in ("right", "full"):
        meta.will_not_work(
            f"conditions are not supported for {node.join_type} joins "
            "(reference limits join conditions to inner joins)")
    if not conf.get(REPLACE_SORT_MERGE_JOIN):
        meta.will_not_work(
            "spark.rapids.sql.replaceSortMergeJoin.enabled=false keeps "
            "sort-merge-shaped (non-broadcast) equi joins on the CPU "
            "(reference GpuSortMergeJoinMeta, RapidsConf.scala:384)")


def _sort_tag(meta: ExecMeta, conf: TorchConf) -> None:
    _no_complex_keys(meta, [o.child for o in meta.node.orders], "sort key")


def _global_limit(n: P.CpuLimitExec, ch, conf: TorchConf) -> E.TorchExec:
    """A global limit over the device's local one (``LimitExec``) is that
    limit; over a device sort of at most ``topKThreshold`` rows, the
    top-k (the reference's limit-into-sort, ``overrides.py:522``)."""
    inner = ch[0]
    if isinstance(inner, E.LimitExec) and inner.n == n.n:
        below = inner.children[0]
        if isinstance(below, E.SortExec) and \
                0 < n.n <= conf.get(TOPK_THRESHOLD):
            return E.TopKExec(below.children[0], below.orders, n.n)
        return inner
    return E.LimitExec(inner, n.n)


_DECODE_KEYS = {"parquet": PARQUET_DEVICE_DECODE, "orc": ORC_DEVICE_DECODE,
                "csv": CSV_DEVICE_DECODE}


def _scan_gate(node: CpuFileScanExec, conf: TorchConf):
    """(device scan, None), or (None, the reason the files stay on the
    host scan); computed once a node."""
    cached = getattr(node, "_gate", None)
    if cached is not None:
        return cached
    node._gate = out = _device_scan(node, conf)
    return out


def _device_scan(node: CpuFileScanExec, conf: TorchConf):
    entry = _DECODE_KEYS[node.fmt]
    if not conf.get(entry):
        return None, f"{entry.key} is false"
    if node.n_part:
        return None, ("hive-partitioned layout: the host scan adds the "
                      "partition columns")
    schema = node.data_schema
    if node.fmt == "parquet":
        from ..io import parquet_device as PD
        from ..io.parquet_meta import read_footer
        footers = {}
        for f in node.files:
            footers[f] = read_footer(f)
            reason = PD.device_decodable(footers[f], schema, f)
            if reason:
                return None, f"{f}: {reason}"
        return PD.ParquetScanExec(node.files, node.schema,
                                  conf.get(PARQUET_REBASE_READ),
                                  emit_file_meta=node.emit_file_meta,
                                  footers=footers), None
    if node.emit_file_meta:
        return None, ("input_file_name() columns are added by the host "
                      "scan")
    if node.fmt == "orc":
        from ..io import orc_device as OD
        tails = {}
        for f in node.files:
            tails[f] = OD.read_tail(f)
            reason = OD.device_decodable(tails[f], schema)
            if reason:
                return None, f"{f}: {reason}"
        return OD.OrcScanExec(node.files, node.schema, tails), None
    from ..io import csv_device as CD
    reason = CD.device_decodable(schema, node.options)
    if reason:
        return None, reason
    return CD.CsvScanExec(node.files, node.schema, node.options), None


def _scan_tag(meta: ExecMeta, conf: TorchConf) -> None:
    _, reason = _scan_gate(meta.node, conf)
    if reason:
        meta.will_not_work(reason)


EXEC_RULES: Dict[type, ExecRule] = {
    CpuFileScanExec: ExecRule(
        "FileSourceScan", lambda n: [],
        lambda n, ch, conf: _scan_gate(n, conf)[0], tag=_scan_tag),
    CpuWriteFilesExec: ExecRule(
        "DataWritingCommand", lambda n: [],
        lambda n, ch, conf: WriteFilesExec(ch[0], n.fmt, n.path, n.options,
                                           n.partition_by, n.mode)),
    P.CpuProjectExec: ExecRule(
        "Project", lambda n: n.exprs,
        lambda n, ch, conf: E.ProjectExec(ch[0], n.exprs)),
    P.CpuFilterExec: ExecRule(
        "Filter", lambda n: [n.condition],
        lambda n, ch, conf: E.FilterExec(ch[0], n.condition)),
    P.CpuHashAggregateExec: ExecRule(
        "HashAggregate", _agg_exprs,
        lambda n, ch, conf: E.HashAggregateExec(ch[0], n.groupings,
                                                n.aggregates),
        tag=_agg_tag),
    P.CpuJoinExec: ExecRule(
        "ShuffledHashJoin",
        lambda n: list(n.left_keys) + list(n.right_keys)
        + ([n.condition] if n.condition is not None else []),
        lambda n, ch, conf: E.ShuffledHashJoinExec(
            ch[0], ch[1], n.join_type, n.left_keys, n.right_keys, n.schema,
            n.condition),
        tag=_join_tag),
    P.CpuNestedLoopJoinExec: ExecRule(
        "BroadcastNestedLoopJoin",
        lambda n: [n.condition] if n.condition is not None else [],
        lambda n, ch, conf: NestedLoopJoinExec(ch[0], ch[1], n.condition,
                                               n.schema)),
    P.CpuSortExec: ExecRule(
        "Sort", lambda n: [o.child for o in n.orders],
        lambda n, ch, conf: E.SortExec(ch[0], n.orders), tag=_sort_tag),
    P.CpuLimitExec: ExecRule("GlobalLimit", lambda n: [], _global_limit),
    P.CpuLocalLimitExec: ExecRule(
        "LocalLimit", lambda n: [],
        lambda n, ch, conf: E.LimitExec(ch[0], n.n)),
    P.CpuUnionExec: ExecRule(
        "Union", lambda n: [],
        lambda n, ch, conf: E.UnionExec(ch, n.schema)),
    P.CpuExpandExec: ExecRule(
        "Expand", lambda n: [e for proj in n.projections for e in proj],
        lambda n, ch, conf: E.ExpandExec(ch[0], n.projections, n.schema)),
    P.CpuGenerateExec: ExecRule(
        "Generate", lambda n: [n.generator],
        lambda n, ch, conf: E.GenerateExec(ch[0], n.generator, n.outer,
                                           n.pos, n.schema)),
    P.CpuWindowExec: ExecRule(
        "Window", _window_exprs,
        lambda n, ch, conf: WindowExec(ch[0], n.window_exprs, n.schema),
        tag=_window_tag),
}


#: The per-operator switches, one a rule.
OPERATOR_KEYS = frozenset(
    [TorchConf.operator_conf_key("exec", r.name)
     for r in EXEC_RULES.values()]
    + [TorchConf.operator_conf_key("expression", r.name)
       for r in EXPR_RULES.values()])


def check_operator_keys(conf: TorchConf) -> None:
    """Raise ``KeyError`` for a per-operator switch that names no rule
    (``TorchConf`` accepts those keys by their prefix)."""
    for k in conf._conf:
        if k.startswith(OPERATOR_KEY_PREFIXES) and k not in OPERATOR_KEYS:
            raise KeyError(f"unknown rapids conf key: {k}")

#: Nodes that stay on the host legitimately (the reference's
#: ``HOST_SOURCE_NODES``, ``overrides.py:624``).
HOST_SOURCE_NODES = ("DeviceSourceExec", "CpuFileScanExec")


def _is_kept(node: E.TorchExec) -> bool:
    """A node that needs no rule: a device node of the CPU plan (a
    source, the exchange) or a shared subplan's wrapper."""
    return isinstance(node, ReusedExec) or not isinstance(node, P.HostExec)


class FallbackOnTpuError(AssertionError):
    """Raised in test mode (``spark.rapids.sql.test.enabled``) when an
    operator stayed on the host (the reference's
    ``overrides.py:628``)."""


class TorchOverrides:
    """The rewrite pass: :meth:`apply` tags, explains, converts and
    finalizes."""

    def __init__(self, conf: TorchConf):
        check_operator_keys(conf)
        self.conf = conf
        self.last_explain = ""

    def wrap(self, node: E.TorchExec, memo: Optional[dict] = None
             ) -> ExecMeta:
        """The meta tree of ``node``; a node reached twice (a shared
        subplan) gets one meta."""
        memo = {} if memo is None else memo
        if id(node) not in memo:
            kids = [self.wrap(c, memo) for c in node.children]
            memo[id(node)] = ExecMeta(node, EXEC_RULES.get(type(node)),
                                      kids)
        return memo[id(node)]

    def apply(self, plan: E.TorchExec) -> E.TorchExec:
        """The executable plan of the CPU plan ``plan``: converted where
        the device can take a node (nowhere with
        ``spark.rapids.sql.enabled`` off), with transitions and coalesce
        nodes; its root is a ``DeviceToHostExec`` or a CPU operator."""
        if not self.conf.sql_enabled:
            return finalize_plan(plan, self.conf)
        meta = self.wrap(plan)
        meta.tag(self.conf)
        explain = self.conf.explain
        if explain in ("ALL", "NOT_ON_TPU"):
            self.last_explain = meta.explain(all_nodes=(explain == "ALL"))
            if self.last_explain:
                print(self.last_explain, end="")
        converted = finalize_plan(meta.convert(self.conf), self.conf)
        if self.conf.test_enabled:
            self._assert_on_device(converted)
        return converted

    def _assert_on_device(self, plan: E.TorchExec) -> None:
        allowed = set(self.conf.allowed_non_tpu) | set(HOST_SOURCE_NODES) \
            | {"HostToDeviceExec", "DeviceToHostExec", "ReusedExec"}
        bad: List[str] = []

        def check(node):
            # a writer reads device batches and returns a host row
            consumes_device = getattr(node, "children_columnar",
                                      node.columnar)
            if not consumes_device and node.node_name() not in allowed:
                bad.append(node.node_name())
            for c in node.children:
                check(c)
        check(plan)
        if bad:
            raise FallbackOnTpuError(
                f"ops fell back to CPU: {bad}; allowed={sorted(allowed)}")


def host_nodes(plan: E.TorchExec) -> List[str]:
    """The CPU operators of an executable plan, each shared node once."""
    seen, out = set(), []

    def walk(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        if isinstance(node, P.HostExec):
            out.append(node.node_name())
        for c in node.children:
            walk(c)
    walk(plan)
    return out


def finalize_plan(plan: E.TorchExec, conf: TorchConf) -> E.TorchExec:
    """Transitions where the columnar side flips and a
    ``DeviceToHostExec`` over a device root, then the coalesce nodes
    (the reference's ``overrides.py:767``)."""
    from ..exec.coalesce import insert_coalesce
    goal = int(conf.get(BATCH_SIZE_ROWS))
    return insert_coalesce(insert_transitions(plan, goal), goal)


def insert_transitions(plan: E.TorchExec, goal_rows: int = 1 << 20
                       ) -> E.TorchExec:
    """``HostToDeviceExec``/``DeviceToHostExec`` where a consumer's side
    differs from its child's, and a host root (the reference's
    ``overrides.py:777``). A shared node is fixed once."""
    memo: dict = {}

    def fix(node: E.TorchExec) -> E.TorchExec:
        if id(node) in memo:
            return memo[id(node)]
        kids = []
        # a writer reads device batches and returns a host row
        wants = getattr(node, "children_columnar", node.columnar)
        for c in node.children:
            c = fix(c)
            if wants and not c.columnar:
                c = E.HostToDeviceExec(c, goal_rows)
            elif not wants and c.columnar:
                c = E.DeviceToHostExec(c, mid_plan=True)
            kids.append(c)
        out = node
        if any(a is not b for a, b in zip(kids, node.children)):
            out = node.with_children(kids)
        memo[id(node)] = out
        return out

    root = fix(plan)
    return E.DeviceToHostExec(root) if root.columnar else root
