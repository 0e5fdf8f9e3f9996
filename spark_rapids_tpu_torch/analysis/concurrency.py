"""Static concurrency analysis — port of
``spark_rapids_tpu/analysis/concurrency.py``, the zero-schedule twin of
runtime lockdep (:mod:`..utils.lockdep`).

(concurrency: skip-file — this analyzer is a development tool; none of
its code runs on the port's threads, so it leaves itself out of its own
scan.)

Where lockdep learns the lock-order graph from the schedules a run
happens to take, this module derives the same model from the SOURCE:
one stdlib-``ast`` pass over the port's package finds every lock object,
every acquisition site and an approximate call graph across functions,
then reports

* ``lock-cycle`` — a cycle in the static lock-order graph (two functions
  that nest the same locks in opposite orders can deadlock, whether or
  not a test interleaves them). An RLock taken again by its holder is
  no cycle.
* ``hold-across-blocking`` — a lock scope that (directly, or through a
  chain of calls it can resolve) reaches a blocking call: a device sync
  (``synchronize``), a device-to-host download (``item``, ``tolist``,
  ``cpu``), a ``Future.result`` wait, ``time.sleep``, a thread join, a
  child process's ``communicate`` (the ``nvcc`` build), socket or file
  I/O. A lock declared ``io_ok=True`` at its ``lockdep`` construction is
  exempt: that is the reviewed claim "this lock exists to serialise this
  I/O".
* ``unguarded-shared-write`` — a write to shared state from code a
  worker thread may run (the functions handed to ``submit``,
  ``submit_spill_io``, ``ordered_map_iter``, ``unit_partitions``,
  ``prefetch_iter`` or ``materialize_boundaries``, and what they
  call) with no lock held: writes to module globals, to
  variables a closure captured, and to ``self`` attributes of a class
  that owns a lock, outside it.

The analysis is approximate on purpose: calls resolve by name (same
class, then same module, then a name unique in the tree); ``with`` is
the only acquisition it tracks; a function called under a lock at every
call site it resolves inherits that lock. A call through a callable held
in an attribute or passed in (a fused region's function) is declared on
its line with ``# concurrency: calls NAME``, which resolves to every
function of that name. It can miss a fault (runtime lockdep covers the
rest); a false finding is suppressed on its line with
``# concurrency: ignore`` and the reason. The port's baseline
(``concurrency_baseline.json`` beside this file) is empty and stays so.

Standalone: the standard library only, so it runs without torch::

    python -m spark_rapids_tpu_torch.analysis.concurrency            # gate
    python -m spark_rapids_tpu_torch.analysis.concurrency --list
    python -m spark_rapids_tpu_torch.analysis.concurrency --inventory
    python -m spark_rapids_tpu_torch.analysis.concurrency --update-baseline
    python -m spark_rapids_tpu_torch.analysis.concurrency --root DIR \\
        --baseline FILE
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

#: call names that hand work to worker threads: their function-valued
#: arguments (and the functions those wrap) run on worker threads.
WORKER_ENTRY_CALLS = frozenset({
    "submit", "submit_spill_io", "ordered_map_iter", "unit_partitions",
    "prefetch_iter", "materialize_boundaries",
})

#: bare call names treated as blocking, with the wait they imply.
BLOCKING_CALLS: Dict[str, str] = {
    "result": "future wait",
    "synchronize": "device sync",
    "item": "device->host download",
    "tolist": "device->host download",
    "cpu": "device->host download",
    "communicate": "child process wait",
    "sleep": "sleep",
    "join": "thread join",
    "recv": "socket read",
    "_recv_exact": "socket read",
    "sendall": "socket write",
    "accept": "socket accept",
    "create_connection": "socket connect",
    "fetch_one": "network fetch",
    "open": "file open",
}

#: methods whose writes are lifecycle bookkeeping, not shared-state races
_WRITE_EXEMPT_FUNCS = frozenset({"__init__", "__post_init__", "__enter__",
                                 "__exit__", "close", "reset", "clear"})

#: bare names too generic for STRICT call resolution: `f.read(n)` on a
#: file object must not resolve to `SpillFile.read` just because they
#: share a name. A `self.<name>()` call with a same-class match still
#: resolves (that one IS the method). Worker-reachability (generous
#: mode) also ignores these — `q.get()` tainting every `get` would make
#: reachability meaningless.
_GENERIC_CALL_NAMES = frozenset({
    "read", "write", "get", "put", "open", "close", "clear", "append",
    "pop", "popitem", "update", "copy", "add", "remove", "discard",
    "items", "keys", "values", "sort", "extend", "insert", "send",
    "flush", "seek", "devices", "result", "join", "acquire", "release",
    "wait", "notify", "notify_all", "set", "start", "cancel", "run",
    "free", "next", "tell", "name", "setdefault",
    # tensor and array methods: `t.cpu()` on a tensor must not resolve to
    # a function of the port that happens to share the name
    "item", "tolist", "cpu", "numpy", "cuda", "to", "synchronize",
    "record", "wait_event", "wait_stream", "replay",
    # str and bytes methods: `s.encode()` is not a module's encode()
    "encode", "decode",
})

IGNORE_MARKER = "concurrency: ignore"
#: ``# concurrency: calls NAME[, NAME]`` on a line declares what a call
#: there reaches that no name resolution can see (a callable held in an
#: attribute or passed in): each NAME is a call from that line, resolved
#: to every function of that name
CALLS_MARKER = "concurrency: calls "
#: the receiver of a call a CALLS_MARKER declares
_HINT = "<declared>"
#: a file whose first lines carry this marker is excluded from analysis
#: (dev-only modules that never run in the engine process)
SKIP_FILE_MARKER = "concurrency: skip-file"

_RULES = ("lock-cycle", "hold-across-blocking", "unguarded-shared-write")


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LockDef:
    lock_id: str       # "memory/spill.py::SpillFile._lock"
    path: str
    owner: str         # class name, "" for module scope
    attr: str          # attribute / global name
    lineno: int
    kind: str          # lock | rlock | condition
    io_ok: bool
    declared: str      # the lockdep name string, "" when raw/unnamed


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    rule: str
    lineno: int
    message: str

    @property
    def key(self) -> str:
        return f"{self.path}::{self.rule}"

    def __str__(self) -> str:
        return f"{self.path}:{self.lineno}: [{self.rule}] {self.message}"


# Raw (unresolved) lock references collected during the per-function walk.
# ("self", attr) | ("name", name) | ("attr", base, attr)
_RawRef = Tuple[str, ...]


@dataclasses.dataclass
class _CallEvent:
    name: str                      # bare callee name
    recv: Optional[str]            # "self", receiver name, or None
    lineno: int
    held: Tuple[_RawRef, ...]      # raw refs held at the call site
    fn_args: Tuple[str, ...]       # bare names of function-valued args


@dataclasses.dataclass
class _AcquireEvent:
    ref: _RawRef
    lineno: int
    held: Tuple[_RawRef, ...]      # refs already held (outer scopes)


@dataclasses.dataclass
class _BlockEvent:
    kind: str
    lineno: int
    held: Tuple[_RawRef, ...]
    suppressed: bool


@dataclasses.dataclass
class _WriteEvent:
    desc: str                      # human-readable target
    base: str                      # base name being written through
    is_self_attr: bool
    attr: str                      # attribute written (self/global writes)
    lineno: int
    held: Tuple[_RawRef, ...]
    suppressed: bool


@dataclasses.dataclass
class _FuncInfo:
    func_id: str                   # "path::Cls.meth" / "path::f.<locals>.g"
    path: str
    bare: str
    cls: str                       # enclosing class name ("" if none)
    lineno: int
    locals: Set[str] = dataclasses.field(default_factory=set)
    parent: Optional[str] = None   # enclosing function id (closures)
    acquires: List[_AcquireEvent] = dataclasses.field(default_factory=list)
    calls: List[_CallEvent] = dataclasses.field(default_factory=list)
    blocks: List[_BlockEvent] = dataclasses.field(default_factory=list)
    writes: List[_WriteEvent] = dataclasses.field(default_factory=list)
    has_yield: bool = False
    #: names the function declared `global` — never locals, and plain
    #: rebinds of them are module-state writes
    globals_decl: Set[str] = dataclasses.field(default_factory=set)


class Model:
    """Everything the three passes share, built by :func:`analyze_tree`."""

    def __init__(self):
        self.locks: Dict[str, LockDef] = {}
        self.funcs: Dict[str, _FuncInfo] = {}
        #: bare name -> [func_id] (call resolution index)
        self.by_bare: Dict[str, List[str]] = {}
        #: path -> set of module-global names
        self.globals: Dict[str, Set[str]] = {}
        #: path -> names bound by plain `import X [as Y]` (module aliases)
        self.module_imports: Dict[str, Set[str]] = {}
        #: path -> module globals holding threading.local() instances
        #: (attribute writes through them are per-thread by construction)
        self.thread_locals: Dict[str, Set[str]] = {}
        #: path -> names referenced as VALUES (not direct-call targets):
        #: a nested function absent from here that is only ever called
        #: inline (and has no yield) cannot escape to another thread
        self.value_loads: Dict[str, Set[str]] = {}
        #: lock attr/name -> [lock_id] (reference resolution index)
        self.by_attr: Dict[str, List[str]] = {}
        #: lock-order digraph: lock_id -> {succ lock_id: site string}
        self.edges: Dict[str, Dict[str, str]] = {}
        self.findings: List[Finding] = []
        #: acquisitions that could not be resolved to a LockDef
        self.unresolved: List[Tuple[str, int, str]] = []
        self.worker_reachable: Set[str] = set()

    # -- reference resolution (documented approximation) -------------------
    def resolve_ref(self, ref: _RawRef, path: str, cls: str
                    ) -> Optional[str]:
        """self.X -> this class's lock; bare NAME -> this module's
        module-level lock; other.X -> unique same-module, else unique
        repo-wide match by attribute name. Ambiguity resolves to None
        (recorded as unresolved, never guessed)."""
        kind = ref[0]
        if kind == "self":
            attr = ref[1]
            lid = f"{path}::{cls}.{attr}"
            if lid in self.locks:
                return lid
            cands = [i for i in self.by_attr.get(attr, ())]
            return cands[0] if len(cands) == 1 else None
        if kind == "name":
            name = ref[1]
            lid = f"{path}::{name}"
            if lid in self.locks:
                return lid
            cands = self.by_attr.get(name, ())
            return cands[0] if len(cands) == 1 else None
        if kind == "attr":
            attr = ref[2]
            same_mod = [i for i in self.by_attr.get(attr, ())
                        if self.locks[i].path == path]
            if len(same_mod) == 1:
                return same_mod[0]
            cands = self.by_attr.get(attr, ())
            return cands[0] if len(cands) == 1 else None
        return None

    def resolve_held(self, held: Sequence[_RawRef], path: str, cls: str
                     ) -> List[str]:
        out = []
        for r in held:
            lid = self.resolve_ref(r, path, cls)
            if lid is not None and lid not in out:
                out.append(lid)
        return out

    def resolve_call(self, ev: _CallEvent, caller: _FuncInfo,
                     generous: bool = False) -> List[str]:
        """Callee candidates for a call event. Strict mode (lock edges,
        blocking chains): same class, else same module, else a UNIQUE
        repo-wide bare-name match. Generous mode (worker reachability
        only): all bare-name matches — ``b.execute(...)`` from a worker
        must taint every ``execute`` because boundary workers really do
        run arbitrary exec subtrees. Guards against the classic
        approximate-callgraph traps: calls through a plain-``import``
        module alias (``torch.cuda(...)``) and container/file method
        names (``_GENERIC_CALL_NAMES``) resolve only to a same-class
        method on an explicit ``self`` receiver."""
        cands = self.by_bare.get(ev.name, ())
        if not cands:
            return []
        if ev.recv == _HINT:
            return list(cands)
        if ev.recv == "self" and caller.cls:
            same_cls = [c for c in cands
                        if self.funcs[c].path == caller.path
                        and self.funcs[c].cls == caller.cls]
            if same_cls:
                return same_cls
        if ev.recv is not None \
                and ev.recv in self.module_imports.get(caller.path, ()):
            return []
        if ev.name in _GENERIC_CALL_NAMES:
            return []
        if generous:
            return list(cands)
        same_mod = [c for c in cands if self.funcs[c].path == caller.path]
        if same_mod:
            return same_mod
        return list(cands) if len(cands) == 1 else []


# ---------------------------------------------------------------------------
# Phase 1: per-file collection
# ---------------------------------------------------------------------------


def _lock_ctor_kind(call: ast.Call) -> Optional[Tuple[str, bool]]:
    """(kind, io_ok) when ``call`` constructs a lock: threading.Lock /
    RLock / Condition (raw) or lockdep.lock / rlock / condition."""
    f = call.func
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None)
    kind = {"Lock": "lock", "RLock": "rlock", "Condition": "condition",
            "lock": "lock", "rlock": "rlock",
            "condition": "condition"}.get(name or "")
    if kind is None:
        return None
    if name in ("lock", "rlock", "condition"):
        # only the lockdep factories, not arbitrary .lock() calls
        if not (isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id == "lockdep"):
            return None
    io_ok = any(kw.arg == "io_ok" and isinstance(kw.value, ast.Constant)
                and bool(kw.value.value) for kw in call.keywords)
    return kind, io_ok


def _declared_name(call: ast.Call) -> str:
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return ""


def _ref_of(expr: ast.expr) -> Optional[_RawRef]:
    """The raw lock reference of a ``with`` context expression."""
    if isinstance(expr, ast.Name):
        return ("name", expr.id)
    if isinstance(expr, ast.Attribute):
        base = expr.value
        if isinstance(base, ast.Name):
            if base.id == "self":
                return ("self", expr.attr)
            return ("attr", base.id, expr.attr)
    return None


def _line_suppressed(lines: List[str], lineno: int) -> bool:
    line = lines[lineno - 1] if 0 < lineno <= len(lines) else ""
    return IGNORE_MARKER in line


def _declared_calls(lines: List[str], lineno: int) -> List[str]:
    """The names a ``# concurrency: calls`` marker on the line declares."""
    line = lines[lineno - 1] if 0 < lineno <= len(lines) else ""
    at = line.find(CALLS_MARKER)
    if at < 0:
        return []
    return [n.strip() for n in line[at + len(CALLS_MARKER):].split(",")
            if n.strip().isidentifier()]


class _FileCollector(ast.NodeVisitor):
    def __init__(self, relpath: str, lines: List[str], model: Model):
        self.path = relpath
        self.lines = lines
        self.model = model
        self._cls: List[str] = []
        self._funcs: List[_FuncInfo] = []
        self._held: List[_RawRef] = []
        self._module_globals: Set[str] = set()
        model.globals[relpath] = self._module_globals
        self._module_imports: Set[str] = set()
        model.module_imports[relpath] = self._module_imports
        self._thread_locals: Set[str] = set()
        model.thread_locals[relpath] = self._thread_locals
        #: module classes that subclass threading.local: their instances
        #: are per-thread too
        self._local_classes: Set[str] = set()
        self._value_loads: Set[str] = set()
        model.value_loads[relpath] = self._value_loads
        #: id()s of Name nodes that are direct-call targets (not values)
        self._call_func_nodes: Set[int] = set()
        #: lines whose declared calls are recorded
        self._hinted: Set[int] = set()

    def visit_Import(self, node: ast.Import):
        for alias in node.names:
            self._module_imports.add(alias.asname
                                     or alias.name.split(".")[0])

    # -- scope bookkeeping --------------------------------------------------
    def _cur(self) -> Optional[_FuncInfo]:
        return self._funcs[-1] if self._funcs else None

    def _func_path_name(self, name: str) -> str:
        parts = []
        if self._funcs:
            parts.append(self._funcs[-1].func_id.split("::", 1)[1]
                         + ".<locals>")
        elif self._cls:
            parts.append(self._cls[-1])
        parts.append(name)
        return f"{self.path}::{'.'.join(parts)}"

    def visit_ClassDef(self, node: ast.ClassDef):
        if self._funcs:
            self.generic_visit(node)  # class inside a function: rare; walk
            return
        for base in node.bases:
            bname = base.attr if isinstance(base, ast.Attribute) else (
                base.id if isinstance(base, ast.Name) else None)
            if bname == "local":
                self._local_classes.add(node.name)
        self._cls.append(node.name)
        # class-level lock attributes (DeviceManager._lock style)
        for stmt in node.body:
            if isinstance(stmt, ast.Assign) \
                    and isinstance(stmt.value, ast.Call):
                info = _lock_ctor_kind(stmt.value)
                if info:
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            self._add_lock(node.name, t.id, stmt.lineno,
                                           info, stmt.value)
        self.generic_visit(node)
        self._cls.pop()

    def _add_lock(self, owner: str, attr: str, lineno: int,
                  info: Tuple[str, bool], call: ast.Call):
        kind, io_ok = info
        lid = f"{self.path}::{owner + '.' if owner else ''}{attr}"
        if lid in self.model.locks:
            return
        d = LockDef(lid, self.path, owner, attr, lineno, kind, io_ok,
                    _declared_name(call))
        self.model.locks[lid] = d
        self.model.by_attr.setdefault(attr, []).append(lid)

    def _visit_func(self, node):
        fid = self._func_path_name(node.name)
        info = _FuncInfo(fid, self.path, node.name,
                         self._cls[-1] if self._cls and not self._funcs
                         else "", node.lineno,
                         parent=self._funcs[-1].func_id if self._funcs
                         else None)
        args = node.args
        for a in [*args.posonlyargs, *args.args, *args.kwonlyargs] \
                + ([args.vararg] if args.vararg else []) \
                + ([args.kwarg] if args.kwarg else []):
            info.locals.add(a.arg)
        self.model.funcs[fid] = info
        self.model.by_bare.setdefault(node.name, []).append(fid)
        self._funcs.append(info)
        held_before = list(self._held)
        self._held = []           # held sets do not cross a def boundary
        self.generic_visit(node)
        self._held = held_before
        self._funcs.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # -- assignments (lock discovery, local binding, write events) ---------
    def _note_local(self, target: ast.expr):
        cur = self._cur()
        if cur is None:
            return
        for n in ast.walk(target):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store) \
                    and n.id not in cur.globals_decl:
                cur.locals.add(n.id)

    def visit_Global(self, node: ast.Global):
        # names declared global are module bindings, not locals — and
        # they stay that way (a later `x = v` rebind must register as a
        # module-state write, not re-enter the locals set)
        cur = self._cur()
        if cur is not None:
            cur.locals.difference_update(node.names)
            cur.globals_decl.update(node.names)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign):
        self._handle_assign(node, node.targets, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None:
            self._handle_assign(node, [node.target], node.value)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._handle_assign(node, [node.target], node.value, aug=True)
        self.generic_visit(node)

    def _handle_assign(self, node, targets, value, aug: bool = False):
        cur = self._cur()
        if cur is None:
            # module scope: record globals; discover module-level locks
            for t in targets:
                if isinstance(t, ast.Name):
                    self._module_globals.add(t.id)
            if isinstance(value, ast.Call):
                info = _lock_ctor_kind(value)
                if info:
                    for t in targets:
                        if isinstance(t, ast.Name) and not self._cls:
                            self._add_lock("", t.id, node.lineno, info,
                                           value)
                f = value.func
                lname = f.attr if isinstance(f, ast.Attribute) else (
                    f.id if isinstance(f, ast.Name) else None)
                if lname == "local" or lname in self._local_classes:
                    for t in targets:
                        if isinstance(t, ast.Name):
                            self._thread_locals.add(t.id)
            return
        # inside a function
        if isinstance(value, ast.Call):
            info = _lock_ctor_kind(value)
            if info:
                for t in targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self" and self._cls:
                        self._add_lock(self._cls[-1], t.attr, node.lineno,
                                       info, value)
        for t in targets:
            if not aug:
                self._note_local(t)
            self._note_write(t, node.lineno)

    def _note_write(self, target: ast.expr, lineno: int):
        """Record attribute/subscript writes (plain local rebinds are not
        shared-state hazards; mutation THROUGH a name is)."""
        cur = self._cur()
        if cur is None:
            return
        desc = None
        base = ""
        attr = ""
        is_self = False
        t = target
        if isinstance(t, ast.Subscript):
            t = t.value
        if isinstance(t, ast.Attribute):
            if isinstance(t.value, ast.Name):
                base = t.value.id
                attr = t.attr
                is_self = base == "self"
                desc = f"{base}.{attr}"
        elif isinstance(t, ast.Name) and isinstance(target, ast.Subscript):
            base = t.id
            attr = t.id
            desc = f"{base}[...]"
        elif isinstance(t, ast.Name) and isinstance(target, ast.Name) \
                and t.id not in cur.locals:
            # plain Name rebind of a non-local (needs `global`/`nonlocal`)
            base = t.id
            attr = t.id
            desc = base
        if desc is None:
            return
        cur.writes.append(_WriteEvent(
            desc, base, is_self, attr, lineno, tuple(self._held),
            _line_suppressed(self.lines, lineno)))

    # -- with / calls -------------------------------------------------------
    def visit_With(self, node: ast.With):
        cur = self._cur()
        pushed = 0
        for item in node.items:
            expr = item.context_expr
            # lockdep.blocking("kind") regions are explicit block markers
            if isinstance(expr, ast.Call) \
                    and isinstance(expr.func, ast.Attribute) \
                    and expr.func.attr == "blocking":
                if cur is not None:
                    kind = "blocking region"
                    if expr.args and isinstance(expr.args[0], ast.Constant):
                        kind = str(expr.args[0].value)
                    cur.blocks.append(_BlockEvent(
                        kind, expr.lineno, tuple(self._held),
                        _line_suppressed(self.lines, expr.lineno)))
                continue
            ref = _ref_of(expr)
            if ref is None:
                # Not a lock ref: VISIT the context expression — `with
                # lock: with open(p):` must record the open() blocking
                # call, and `with helper():` its call-graph edge.
                self.visit(expr)
                if item.optional_vars is not None:
                    self._note_local(item.optional_vars)
                continue
            # Only track refs that look like locks (resolution happens in
            # phase 2; unknown names simply resolve to nothing).
            if cur is not None:
                cur.acquires.append(_AcquireEvent(
                    ref, expr.lineno, tuple(self._held)))
            self._held.append(ref)
            pushed += 1
            if item.optional_vars is not None:
                self._note_local(item.optional_vars)
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(pushed):
            self._held.pop()

    def visit_For(self, node: ast.For):
        self._note_local(node.target)
        self.generic_visit(node)

    def visit_comprehension(self, node):
        self._note_local(node.target)
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name):
        if isinstance(node.ctx, ast.Load) \
                and id(node) not in self._call_func_nodes:
            self._value_loads.add(node.id)
        self.generic_visit(node)

    def _visit_yield(self, node):
        cur = self._cur()
        if cur is not None:
            cur.has_yield = True
        self.generic_visit(node)

    visit_Yield = _visit_yield
    visit_YieldFrom = _visit_yield

    def visit_Call(self, node: ast.Call):
        if isinstance(node.func, ast.Name):
            self._call_func_nodes.add(id(node.func))
        cur = self._cur()
        if cur is not None:
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            recv = None
            if isinstance(f, ast.Attribute) \
                    and isinstance(f.value, ast.Name):
                recv = f.value.id
            if name:
                fn_args: List[str] = []
                if name in WORKER_ENTRY_CALLS:
                    for a in list(node.args) + [kw.value
                                                for kw in node.keywords]:
                        if isinstance(a, ast.Name):
                            fn_args.append(a.id)
                        elif isinstance(a, ast.Attribute):
                            fn_args.append(a.attr)
                        elif isinstance(a, ast.Call):
                            inner = a.func
                            if isinstance(inner, ast.Name):
                                fn_args.append(inner.id)
                            elif isinstance(inner, ast.Attribute):
                                fn_args.append(inner.attr)
                        elif isinstance(a, ast.Lambda):
                            for sub in ast.walk(a.body):
                                if isinstance(sub, ast.Call):
                                    inner = sub.func
                                    if isinstance(inner, ast.Name):
                                        fn_args.append(inner.id)
                                    elif isinstance(inner, ast.Attribute):
                                        fn_args.append(inner.attr)
                cur.calls.append(_CallEvent(name, recv, node.lineno,
                                            tuple(self._held),
                                            tuple(fn_args)))
                # a marker on any line of the call (its last, when the
                # call wraps)
                for ln in range(node.lineno,
                                (node.end_lineno or node.lineno) + 1):
                    if ln in self._hinted:
                        continue
                    for hint in _declared_calls(self.lines, ln):
                        self._hinted.add(ln)
                        cur.calls.append(_CallEvent(
                            hint, _HINT, node.lineno, tuple(self._held),
                            ()))
                block_kind = BLOCKING_CALLS.get(name)
                # "join" is blocking only in its zero-arg thread-join
                # shape: str.join/os.path.join always take arguments and
                # must not trip the rule under a lock.
                if name == "join" and (node.args or node.keywords):
                    block_kind = None
                if block_kind is not None:
                    cur.blocks.append(_BlockEvent(
                        block_kind, node.lineno, tuple(self._held),
                        _line_suppressed(self.lines, node.lineno)))
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# Phase 2: inter-procedural passes
# ---------------------------------------------------------------------------


def _transitive_locks(model: Model, fid: str,
                      memo: Dict[str, Set[str]],
                      visiting: Set[str]) -> Set[str]:
    """Locks a call into ``fid`` may acquire (resolved; bounded by the
    strict call-resolution rules)."""
    if fid in memo:
        return memo[fid]
    if fid in visiting:
        return set()
    visiting.add(fid)
    info = model.funcs[fid]
    out: Set[str] = set()
    for acq in info.acquires:
        lid = model.resolve_ref(acq.ref, info.path, info.cls)
        if lid is not None:
            out.add(lid)
    for ev in info.calls:
        for callee in model.resolve_call(ev, info):
            out |= _transitive_locks(model, callee, memo, visiting)
    visiting.discard(fid)
    memo[fid] = out
    return out


def _transitive_blocking(model: Model, fid: str,
                         memo: Dict[str, Optional[Tuple[str, str]]],
                         visiting: Set[str]
                         ) -> Optional[Tuple[str, str]]:
    """(kind, where) when calling ``fid`` may block, directly or through
    its strict-resolution callees (the finding is attributed to whichever
    caller holds a lock across the call chain)."""
    if fid in memo:
        return memo[fid]
    if fid in visiting:
        return None
    visiting.add(fid)
    info = model.funcs[fid]
    found: Optional[Tuple[str, str]] = None
    for b in info.blocks:
        if not b.suppressed:
            found = (b.kind, f"{info.path}:{b.lineno}")
            break
    if found is None:
        for ev in info.calls:
            for callee in model.resolve_call(ev, info):
                sub = _transitive_blocking(model, callee, memo, visiting)
                if sub is not None:
                    found = sub
                    break
            if found is not None:
                break
    visiting.discard(fid)
    memo[fid] = found
    return found


def _always_held(model: Model) -> Dict[str, Set[str]]:
    """For each function, the locks held at EVERY resolved call site
    (meet-over-call-sites fixpoint, TOP = all locks). A locked class's
    private helpers — only ever called under the class lock — inherit it,
    so the write rule doesn't flood on them."""
    top = set(model.locks)
    state: Dict[str, Set[str]] = {f: set(top) for f in model.funcs}
    # call-site index: callee -> [(caller, resolved held at site)]
    sites: Dict[str, List[Tuple[str, List[str]]]] = {}
    callers: Set[str] = set()
    for fid, info in model.funcs.items():
        for ev in info.calls:
            for callee in model.resolve_call(ev, info):
                held = model.resolve_held(ev.held, info.path, info.cls)
                sites.setdefault(callee, []).append((fid, held))
                callers.add(callee)
    for fid in model.funcs:
        if fid not in callers:
            state[fid] = set()   # entry point: nothing held on arrival
    for _ in range(len(model.funcs)):
        changed = False
        for fid, callsites in sites.items():
            acc: Optional[Set[str]] = None
            for caller, held in callsites:
                s = state[caller] | set(held)
                acc = s if acc is None else (acc & s)
            acc = acc or set()
            if acc != state[fid]:
                state[fid] = acc
                changed = True
        if not changed:
            break
    return state


def _worker_reachable(model: Model) -> Set[str]:
    """Functions that may run on pipeline workers: seeds are the
    function-valued arguments of WORKER_ENTRY_CALLS sites, closed over
    the call graph with GENEROUS resolution (dynamic dispatch like
    ``b.execute(...)`` must taint every ``execute``)."""
    seeds: Set[str] = set()
    for fid, info in model.funcs.items():
        for ev in info.calls:
            if ev.name in WORKER_ENTRY_CALLS:
                for bare in ev.fn_args:
                    seeds.update(model.by_bare.get(bare, ()))
    out = set(seeds)
    frontier = list(seeds)
    while frontier:
        fid = frontier.pop()
        info = model.funcs[fid]
        # a worker runs this function, so it runs its nested closures too
        for other, oinfo in model.funcs.items():
            if oinfo.parent == fid and other not in out:
                out.add(other)
                frontier.append(other)
        for ev in info.calls:
            for callee in model.resolve_call(ev, info, generous=True):
                if callee not in out:
                    out.add(callee)
                    frontier.append(callee)
    return out


def _ancestor_locals(model: Model, info: _FuncInfo) -> Set[str]:
    out: Set[str] = set()
    parent = info.parent
    while parent is not None:
        pinfo = model.funcs[parent]
        out |= pinfo.locals
        parent = pinfo.parent
    return out


# ---------------------------------------------------------------------------
# Findings
# ---------------------------------------------------------------------------


def _build_edges(model: Model) -> None:
    lock_memo: Dict[str, Set[str]] = {}
    for fid, info in model.funcs.items():
        for acq in info.acquires:
            inner = model.resolve_ref(acq.ref, info.path, info.cls)
            if inner is None:
                model.unresolved.append(
                    (info.path, acq.lineno, "/".join(map(str, acq.ref))))
                continue
            for outer in model.resolve_held(acq.held, info.path, info.cls):
                if outer != inner:
                    model.edges.setdefault(outer, {}).setdefault(
                        inner, f"{info.path}:{acq.lineno}")
                elif model.locks[inner].kind not in ("rlock", "condition"):
                    # same-lock nesting: an RLock re-entry is fine, and
                    # lockdep.condition() is RLock-backed (matching raw
                    # threading.Condition); a plain Lock would
                    # self-deadlock (the runtime twin raises) — surface
                    # as a one-lock cycle.
                    model.edges.setdefault(outer, {}).setdefault(
                        inner, f"{info.path}:{acq.lineno}")
        for ev in info.calls:
            held = model.resolve_held(ev.held, info.path, info.cls)
            if not held:
                continue
            for callee in model.resolve_call(ev, info):
                for inner in _transitive_locks(model, callee, lock_memo,
                                               set()):
                    for outer in held:
                        if outer == inner:
                            if model.locks[inner].kind in ("rlock",
                                                           "condition"):
                                continue
                        model.edges.setdefault(outer, {}).setdefault(
                            inner,
                            f"{info.path}:{ev.lineno} via {ev.name}()")


def _find_cycles(model: Model) -> None:
    """Tarjan SCCs over the lock-order digraph; every SCC with more than
    one lock (or a non-reentrant self-loop) is one ``lock-cycle``
    finding, attributed to the first lock's file."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    stack: List[str] = []
    on: Set[str] = set()
    counter = [0]
    sccs: List[List[str]] = []

    def strong(v: str):
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        for w in model.edges.get(v, ()):
            if w not in index:
                strong(w)
                low[v] = min(low[v], low[w])
            elif w in on:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on.discard(w)
                comp.append(w)
                if w == v:
                    break
            sccs.append(comp)

    for v in sorted(set(model.edges)
                    | {s for d in model.edges.values() for s in d}):
        if v not in index:
            strong(v)
    for comp in sccs:
        comp = sorted(comp)
        self_loop = len(comp) == 1 and comp[0] in model.edges.get(
            comp[0], {})
        if len(comp) < 2 and not self_loop:
            continue
        sites = []
        for a in comp:
            for b, site in sorted(model.edges.get(a, {}).items()):
                if b in comp:
                    sites.append(f"{a} -> {b} at {site}")
        first = model.locks[comp[0]]
        model.findings.append(Finding(
            first.path, "lock-cycle", first.lineno,
            "lock-order cycle among {%s}: %s — concurrent threads taking "
            "these orders can deadlock; pick one order and document it in "
            "the port's README" % (", ".join(comp), "; ".join(sites))))


def _find_hold_across_blocking(model: Model) -> None:
    block_memo: Dict[str, Optional[Tuple[str, str]]] = {}
    seen: Set[Tuple[str, str, int]] = set()
    for fid, info in model.funcs.items():
        events: List[Tuple[Tuple[str, str], int, Tuple[_RawRef, ...]]] = []
        for b in info.blocks:
            if not b.suppressed and b.held:
                events.append(((b.kind, f"{info.path}:{b.lineno}"),
                               b.lineno, b.held))
        for ev in info.calls:
            if not ev.held or ev.name in BLOCKING_CALLS:
                continue
            for callee in model.resolve_call(ev, info):
                sub = _transitive_blocking(model, callee, block_memo,
                                           set())
                if sub is not None:
                    events.append((sub, ev.lineno, ev.held))
                    break
        for (kind, where), lineno, held in events:
            for lid in model.resolve_held(held, info.path, info.cls):
                if model.locks[lid].io_ok:
                    continue
                key = (lid, kind, lineno)
                if key in seen:
                    continue
                seen.add(key)
                model.findings.append(Finding(
                    info.path, "hold-across-blocking", lineno,
                    f"'{lid}' held across {kind} ({where}) — every "
                    "thread contending on it serializes behind the "
                    "wait; release before blocking, or declare io_ok "
                    "at the lockdep construction if guarding this I/O "
                    "is the lock's purpose"))


def _find_unguarded_writes(model: Model) -> None:
    always = _always_held(model)
    model.worker_reachable = _worker_reachable(model)
    #: classes that own at least one lock: their self-writes are shared
    locked_classes = {(d.path, d.owner) for d in model.locks.values()
                      if d.owner}
    for fid in sorted(model.worker_reachable):
        info = model.funcs[fid]
        if info.bare in _WRITE_EXEMPT_FUNCS:
            continue
        anc_locals = _ancestor_locals(model, info) if info.parent else set()
        for w in info.writes:
            if w.suppressed:
                continue
            if w.held or always.get(fid):
                continue  # some lock is held — treated as guarded
            flag = None
            if w.base in model.thread_locals.get(info.path, ()):
                continue  # threading.local(): per-thread by construction
            if info.parent and w.base in anc_locals \
                    and w.base not in info.locals:
                # A nested function whose name is never used as a value
                # and that has no yield runs inline on its creator's
                # thread — its captured-variable writes cannot race.
                escapes = info.has_yield or info.bare in \
                    model.value_loads.get(info.path, ())
                if escapes:
                    flag = (f"write to closure-shared '{w.desc}' "
                            "(captured from the enclosing scope)")
            elif w.is_self_attr and (info.path, info.cls) in locked_classes:
                # skip the lock attributes themselves
                if f"{info.path}::{info.cls}.{w.attr}" not in model.locks:
                    flag = (f"write to shared '{w.desc}' of lock-owning "
                            f"class {info.cls} outside its lock")
            elif not w.is_self_attr \
                    and w.base in model.globals.get(info.path, ()) \
                    and w.base not in info.locals:
                flag = f"write to module-global '{w.desc}'"
            if flag:
                model.findings.append(Finding(
                    info.path, "unguarded-shared-write", w.lineno,
                    f"{flag} from worker-reachable {fid.split('::')[1]} "
                    "with no lock held — concurrent pipeline workers "
                    "lose updates here; guard it with a lockdep lock "
                    "(utils/lockdep.py) or move it off the worker path"))


# ---------------------------------------------------------------------------
# Entry points: the analysis, the gate and the command line
# ---------------------------------------------------------------------------


def analyze_tree(root: str) -> Model:
    """Build the concurrency model for every .py file under ``root``."""
    model = Model()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "_build"))
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, root).replace(os.sep, "/")
            with open(full, encoding="utf-8") as f:
                src = f.read()
            if SKIP_FILE_MARKER in "\n".join(src.splitlines()[:12]):
                continue
            try:
                tree = ast.parse(src, filename=full)
            except SyntaxError as e:
                model.findings.append(Finding(rel, "parse-error",
                                              e.lineno or 0, str(e)))
                continue
            _FileCollector(rel, src.splitlines(), model).visit(tree)
    _build_edges(model)
    _find_cycles(model)
    _find_hold_across_blocking(model)
    _find_unguarded_writes(model)
    model.findings.sort(key=lambda f: (f.path, f.rule, f.lineno))
    return model


# -- ratchet ----------------------------------------------------------------


def counts_of(findings: List[Finding]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.key] = counts.get(f.key, 0) + 1
    return counts


def compare_to_baseline(findings: List[Finding], baseline: Dict[str, int]
                        ) -> Tuple[List[Finding], List[str]]:
    by_key: Dict[str, List[Finding]] = {}
    for f in findings:
        by_key.setdefault(f.key, []).append(f)
    new: List[Finding] = []
    for key, fs in sorted(by_key.items()):
        allowed = baseline.get(key, 0)
        if len(fs) > allowed:
            new.extend(fs[allowed:])
    counts = counts_of(findings)
    improved = sorted(k for k, n in baseline.items()
                      if counts.get(k, 0) < n)
    return new, improved


def load_baseline(path: str) -> Dict[str, int]:
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return {}
    with open(path, encoding="utf-8") as f:
        return dict(json.load(f).get("counts", {}))


def write_baseline(path: str, findings: List[Finding]) -> None:
    data = {
        "comment": "Static concurrency findings per (file, rule) of "
                   "spark_rapids_tpu_torch (analysis/concurrency.py). It "
                   "is empty and stays empty: fix a finding, or suppress "
                   "a false one on its line with '# concurrency: ignore' "
                   "and the reason. Regenerate with `python -m "
                   "spark_rapids_tpu_torch.analysis.concurrency "
                   "--update-baseline`.",
        "counts": dict(sorted(counts_of(findings).items())),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2)
        f.write("\n")


# -- docs generation --------------------------------------------------------


def inventory_markdown(model: Model) -> str:
    """The lock inventory (``--inventory``, kept in the port's README):
    every lock, and the acquisition order seen in the source."""
    out = ["| Lock | Kind | io_ok | Defined at |",
           "|------|------|-------|------------|"]
    for lid in sorted(model.locks):
        d = model.locks[lid]
        name = d.declared or f"{d.owner + '.' if d.owner else ''}{d.attr}"
        out.append(f"| `{name}` | {d.kind} | "
                   f"{'yes' if d.io_ok else 'no'} | "
                   f"`{d.path}:{d.lineno}` |")
    out.append("")
    out.append("Statically observed acquisition order (outer → inner; "
               "cycles would fail the `lock-cycle` gate):")
    out.append("")
    edges = sorted((a, b) for a, d in model.edges.items() for b in d)
    if not edges:
        out.append("*(no nested acquisitions observed)*")
    for a, b in edges:
        da, db = model.locks[a], model.locks[b]
        na = da.declared or f"{da.owner + '.' if da.owner else ''}{da.attr}"
        nb = db.declared or f"{db.owner + '.' if db.owner else ''}{db.attr}"
        out.append(f"- `{na}` → `{nb}` (at `{model.edges[a][b]}`)")
    out.append("")
    return "\n".join(out) + "\n"


#: the tree the CLI analyses by default: the port's package
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: its baseline (empty)
BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "concurrency_baseline.json")


def run(root: str = PACKAGE_ROOT, baseline_path: str = BASELINE_PATH,
        update: bool = False, list_all: bool = False) -> int:
    """The gate: 0 when no finding is above the baseline, else 1."""
    import sys
    model = analyze_tree(root)
    findings = [f for f in model.findings]
    if update:
        write_baseline(baseline_path, findings)
        print(f"concurrency baseline updated: {len(findings)} finding(s) "
              f"across {len(counts_of(findings))} (file, rule) key(s)")
        return 0
    if list_all:
        for f in findings:
            print(f)
    baseline = load_baseline(baseline_path)
    new, improved = compare_to_baseline(findings, baseline)
    for k in improved:
        print(f"note: {k} is below its concurrency baseline — tighten "
              "with --update-baseline")
    if new:
        print(f"{len(new)} NEW concurrency finding(s) above the baseline:",
              file=sys.stderr)
        for f in new:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(f"concurrency analysis clean: {len(model.locks)} lock(s), "
          f"{sum(len(d) for d in model.edges.values())} order edge(s), "
          f"{len(findings)} baselined finding(s), 0 new")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_tpu_torch.analysis.concurrency",
        description="Static lock-order, hold-across-blocking and "
                    "shared-write analysis of a Python tree.")
    ap.add_argument("--root", default=PACKAGE_ROOT,
                    help="the tree to analyse (default: the port's "
                         "package)")
    ap.add_argument("--baseline", default=None,
                    help="the baseline file (default: the port's, for "
                         "its own tree; none for another root)")
    ap.add_argument("--list", action="store_true",
                    help="print every finding")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write the current findings as the baseline")
    ap.add_argument("--inventory", action="store_true",
                    help="print the lock inventory and order edges as "
                         "markdown")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    baseline = args.baseline
    if baseline is None:
        baseline = BASELINE_PATH if root == PACKAGE_ROOT else os.devnull
    if args.inventory:
        model = analyze_tree(root)
        print(inventory_markdown(model), end="")
        print(f"{len(model.locks)} lock(s), "
              f"{sum(len(d) for d in model.edges.values())} order "
              f"edge(s), {len(model.findings)} finding(s)")
        return 0
    return run(root, baseline, update=args.update_baseline,
               list_all=args.list)


if __name__ == "__main__":
    raise SystemExit(main())
