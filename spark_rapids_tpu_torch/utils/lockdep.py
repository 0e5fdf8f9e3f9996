"""Runtime lockdep: named locks with lock-order tracking — port of
``spark_rapids_tpu/utils/lockdep.py``, same semantics.

Every lock of the port's metrics and tracing layer (and of the session's
execution context and the scans' pipeline) is made through the
factories here. With ``TPU_LOCKDEP=1`` in the environment each
acquisition feeds a process-wide *observed lock-order graph*, so one
good schedule proves facts about every schedule:

* **Lock-order inversion** — acquiring B while holding A adds the edge
  A->B; if B can already reach A in the graph, two threads can deadlock
  even though this run did not. Recorded with both acquisition sites.
* **Self-deadlock** — a blocking acquire of a non-reentrant lock the
  same thread already holds would hang forever; lockdep raises instead
  (the only case where instrumentation changes behavior).
* **Hold-across-blocking** — known-blocking sites mark themselves with
  :func:`blocking`; entering one while holding a lock not declared
  ``io_ok`` serializes every sibling thread behind the wait. Locks that
  guard I/O on purpose (the event log) declare ``io_ok=True``.

With ``TPU_LOCKDEP`` unset (the default) the factories return raw
``threading`` primitives: no wrapper, no cost per acquire. The gate is
read when a lock is made, so it must be set before the package is
imported; ``tests/conftest.py`` sets it for the whole test run.

Violations are recorded, not raised (but self-deadlock):
:func:`violations` and :func:`assert_clean` surface them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import threading
from typing import Callable, Dict, List, Optional, Tuple


def _env_on(val: Optional[str]) -> bool:
    return (val or "").strip().lower() in ("1", "true", "yes", "on")


#: Process-wide gate, read at lock CONSTRUCTION time (see module doc).
_ENABLED = _env_on(os.environ.get("TPU_LOCKDEP"))


def enabled() -> bool:
    """True when locks constructed *now* would be instrumented."""
    return _ENABLED


# ---------------------------------------------------------------------------
# Global instrumentation state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LockdepViolation:
    #: lock-order-inversion | self-deadlock | hold-across-blocking
    kind: str
    locks: Tuple[str, ...]
    message: str

    def __str__(self) -> str:
        return f"[{self.kind}] {' -> '.join(self.locks)}: {self.message}"


class _TLS(threading.local):
    def __init__(self):
        #: innermost-last stack of live acquisitions on this thread
        self.held: List["_Held"] = []


@dataclasses.dataclass
class _Held:
    lock: object   # the instrumented wrapper instance
    name: str
    io_ok: bool


_tls = _TLS()

#: Guards the graph + violation list (raw lock: lockdep must not
#: instrument itself).
_GUARD = threading.Lock()
#: name -> {successor name -> "siteA -> siteB" of the first observation}
_EDGES: Dict[str, Dict[str, str]] = {}
_VIOLATIONS: List[LockdepViolation] = []
_SEEN: set = set()
#: every lock name ever constructed while enabled (inventory/diagnostics)
_KNOWN_LOCKS: Dict[str, str] = {}   # name -> kind ("lock"/"rlock"/"condition")
#: frames to skip when attributing a site: lockdep itself plus the
#: stdlib wrappers acquisitions route through (contextlib's
#: contextmanager __enter__ for blocking(), threading's Condition
#: __enter__/__exit__) — a violation must name the engine's line.
_SITE_SKIP_MODULES = frozenset({__name__, "contextlib", "threading"})


def _call_site() -> str:
    """file:lineno of the nearest caller frame outside this module and
    the stdlib wrappers (_SITE_SKIP_MODULES)."""
    f = sys._getframe(1)
    while f is not None \
            and f.f_globals.get("__name__") in _SITE_SKIP_MODULES:
        f = f.f_back
    if f is None:  # pragma: no cover - defensive
        return "<unknown>"
    path = f.f_code.co_filename
    for marker in ("spark_rapids_tpu_torch", "tests"):
        i = path.find(os.sep + marker + os.sep)
        if i >= 0:
            path = path[i + 1:]
            break
    return f"{path.replace(os.sep, '/')}:{f.f_lineno}"


def _record(kind: str, locks: Tuple[str, ...], message: str) -> None:
    key = (kind, locks)
    with _GUARD:
        if key in _SEEN:
            return
        _SEEN.add(key)
        _VIOLATIONS.append(LockdepViolation(kind, locks, message))


def _reachable(src: str, dst: str) -> Optional[List[str]]:
    """A path src -> ... -> dst in the observed-order graph (caller holds
    _GUARD), or None."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for succ in _EDGES.get(node, ()):
            if succ == dst:
                return path + [dst]
            if succ not in seen:
                seen.add(succ)
                stack.append((succ, path + [succ]))
    return None


def _note_order(held_name: str, new_name: str, site: str) -> None:
    """Record the observed edge held_name -> new_name; flag inversions
    (new_name already reaches held_name) and same-name nesting (the
    graph cannot order two instances of one lock class)."""
    existing = _EDGES.get(held_name, {}).get(new_name)
    if existing is not None:
        return  # edge known; it was checked when first observed
    with _GUARD:
        succs = _EDGES.setdefault(held_name, {})
        if new_name in succs:
            return
        succs[new_name] = site
    if new_name == held_name:
        _record("lock-order-inversion", (held_name, new_name),
                f"two instances of '{held_name}' nested at {site}; the "
                "order graph cannot prove an ordering between instances "
                "of one lock class — define an explicit instance order "
                "or split the lock names")
        return
    with _GUARD:
        path = _reachable(new_name, held_name)
        back_site = _EDGES.get(new_name, {}).get(held_name)
    if path is not None:
        detail = f" (reverse order first observed at {back_site})" \
            if back_site else ""
        _record("lock-order-inversion", tuple(path),
                f"acquired '{new_name}' while holding '{held_name}' at "
                f"{site}, but '{new_name}' already reaches "
                f"'{held_name}' via {' -> '.join(path)}{detail}; two "
                "threads taking these orders concurrently deadlock")


def _note_acquired(wrapper, name: str, io_ok: bool,
                   record_order: bool = True) -> None:
    held = _tls.held
    if record_order and held:
        site = _call_site()
        seen_names = set()
        for h in held:
            if h.lock is wrapper or h.name in seen_names:
                continue  # reentrant hold / duplicate holder name
            seen_names.add(h.name)
            _note_order(h.name, name, site)
    held.append(_Held(wrapper, name, io_ok))


def _note_released(wrapper) -> None:
    held = _tls.held
    for i in range(len(held) - 1, -1, -1):
        if held[i].lock is wrapper:
            del held[i]
            return


# ---------------------------------------------------------------------------
# Instrumented primitives
# ---------------------------------------------------------------------------


class _DepLock:
    """Instrumented non-reentrant lock (drop-in for ``threading.Lock``)."""

    _reentrant = False

    def __init__(self, name: str, io_ok: bool = False):
        self.name = name
        self.io_ok = io_ok
        self._inner = self._make_inner()

    @staticmethod
    def _make_inner():
        return threading.Lock()

    def _held_by_me(self) -> bool:
        return any(h.lock is self for h in _tls.held)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not self._reentrant and self._held_by_me():
            if not blocking:
                # A trylock probe of an already-held lock (the pattern
                # threading.Condition._is_owned uses) is legitimate —
                # report "not acquired", never a violation.
                return False
            _record("self-deadlock", (self.name,),
                    f"blocking re-acquire of non-reentrant '{self.name}' "
                    f"by its holding thread at {_call_site()}")
            raise RuntimeError(
                f"lockdep: self-deadlock on '{self.name}' — the thread "
                "already holds this non-reentrant lock and a blocking "
                f"re-acquire at {_call_site()} would hang forever")
        ok = self._inner.acquire(blocking, timeout) if timeout != -1 \
            else self._inner.acquire(blocking)
        if ok:
            # Trylocks cannot deadlock; record order only for blocking
            # acquires so opportunistic probes don't poison the graph.
            _note_acquired(self, self.name, self.io_ok,
                           record_order=blocking)
        return ok

    def release(self) -> None:
        _note_released(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):  # pragma: no cover - diagnostics only
        return f"<DepLock {self.name!r}>"


class _DepRLock(_DepLock):
    """Instrumented reentrant lock (drop-in for ``threading.RLock``).

    Re-entrant holds by one thread are a single logical acquisition for
    order purposes (no self-edges, no self-deadlock)."""

    _reentrant = True

    @staticmethod
    def _make_inner():
        return threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        reentry = self._held_by_me()
        ok = self._inner.acquire(blocking, timeout) if timeout != -1 \
            else self._inner.acquire(blocking)
        if ok:
            _note_acquired(self, self.name, self.io_ok,
                           record_order=blocking and not reentry)
        return ok

    # threading.Condition(RLock) support
    def _release_save(self):
        count = 0
        for h in list(_tls.held):
            if h.lock is self:
                count += 1
                _note_released(self)
        state = self._inner._release_save()
        return (state, count)

    def _acquire_restore(self, saved):
        state, count = saved
        self._inner._acquire_restore(state)
        for _ in range(count):
            _note_acquired(self, self.name, self.io_ok, record_order=False)

    def _is_owned(self):
        return self._inner._is_owned()


def _register(name: str, kind: str) -> None:
    # _record takes _GUARD itself — call it only after releasing (the
    # static pass flagged the nested version as a one-lock cycle).
    with _GUARD:
        prev = _KNOWN_LOCKS.get(name)
        _KNOWN_LOCKS[name] = kind
    if prev is not None and prev != kind:  # pragma: no cover
        _record("lock-order-inversion", (name,),
                f"lock name '{name}' constructed as both {prev} and "
                f"{kind} — names must identify one lock class")


def lock(name: str, *, io_ok: bool = False):
    """A named engine lock: raw ``threading.Lock`` when lockdep is off,
    instrumented otherwise. ``io_ok=True`` declares that this lock
    intentionally guards blocking I/O (exempt from hold-across-blocking)."""
    if not _ENABLED:
        return threading.Lock()
    _register(name, "lock")
    return _DepLock(name, io_ok)


def rlock(name: str, *, io_ok: bool = False):
    """A named reentrant engine lock (see :func:`lock`)."""
    if not _ENABLED:
        return threading.RLock()
    _register(name, "rlock")
    return _DepRLock(name, io_ok)


def condition(name: str, *, io_ok: bool = False):
    """A named condition variable. The underlying lock is an instrumented
    RLOCK — a bare ``threading.Condition()`` defaults to an RLock, so the
    instrumented variant must keep identical reentrancy semantics (a
    non-reentrant wrapper would raise a false self-deadlock on legal
    condition re-entry). Waits release it correctly through Condition's
    ``_release_save`` protocol, which :class:`_DepRLock` implements, so
    the held-stack stays truthful across a wait."""
    if not _ENABLED:
        return threading.Condition()
    _register(name, "condition")
    return threading.Condition(_DepRLock(name, io_ok))


def condition_on(lock):
    """A condition variable over an EXISTING lockdep lock: a wait
    releases that lock for its duration and notifiers take the same
    lock. No new lock is made, so the order graph is unchanged; ``lock``
    must be a (reentrant) lockdep rlock or a raw RLock —
    :class:`_DepRLock` implements Condition's release/restore protocol so
    the held-stack stays truthful across the wait."""
    return threading.Condition(lock)


# ---------------------------------------------------------------------------
# Blocking-site markers
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def blocking(kind: str):
    """Mark a known-blocking region (a pipeline future wait, a device
    synchronisation). Entering one while holding any non-``io_ok``
    lockdep lock records a hold-across-blocking violation: every thread
    needing that lock now waits out the stall. Near-free when lockdep is
    off (one flag check)."""
    if _ENABLED:
        offenders = tuple(sorted({h.name for h in _tls.held
                                  if not h.io_ok}))
        if offenders:
            _record("hold-across-blocking", offenders + (kind,),
                    f"blocking region '{kind}' entered at {_call_site()} "
                    f"while holding {', '.join(repr(n) for n in offenders)}"
                    " — threads contending on those locks serialize "
                    "behind this wait (declare io_ok only for locks that "
                    "exist to guard I/O)")
    yield


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------


def edges() -> Dict[str, List[str]]:
    """The observed lock-order graph: lock name -> the names taken while
    it was held."""
    with _GUARD:
        return {a: sorted(d) for a, d in _EDGES.items()}


def violations() -> List[LockdepViolation]:
    with _GUARD:
        return list(_VIOLATIONS)


def drain_violations(select: Optional[Callable[[LockdepViolation], bool]]
                     = None) -> List[LockdepViolation]:
    """Return AND clear recorded violations. With ``select``, only the
    matching ones are drained (their dedup keys re-arm); the rest stay
    recorded — tests that provoke violations on purpose drain only their
    own lock names, so a real violation recorded earlier stays."""
    with _GUARD:
        if select is None:
            out = list(_VIOLATIONS)
            _VIOLATIONS.clear()
            _SEEN.clear()
            return out
        out = [v for v in _VIOLATIONS if select(v)]
        _VIOLATIONS[:] = [v for v in _VIOLATIONS if not select(v)]
        for v in out:
            _SEEN.discard((v.kind, v.locks))
        return out


def reset() -> None:
    """Clear the order graph and violations (test isolation). Held
    stacks are per-thread and self-correcting; they are not touched."""
    with _GUARD:
        _EDGES.clear()
        _VIOLATIONS.clear()
        _SEEN.clear()


def assert_clean() -> None:
    vs = violations()
    if vs:
        raise AssertionError(
            "lockdep recorded %d violation(s):\n%s"
            % (len(vs), "\n".join(f"  {v}" for v in vs)))
