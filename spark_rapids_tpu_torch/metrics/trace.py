"""Per-query span tracing — port of ``spark_rapids_tpu/metrics/trace.py``.

The profile layer (:mod:`.profile`) answers "how much"; this module
answers "when": one :class:`Tracer` per query collects a tree of timed
spans over the layers the query touches — the session's plan and
dispatch attempts, the scans' pipeline workers, the exchange's map side
— and exports it as Chrome trace-event JSON (Perfetto-loadable) beside
the event log.

Design rules, the reference's:

* **Zero-cost default.** Tracing is off unless
  ``spark.rapids.tpu.trace.enabled`` is set; disabled call sites pay one
  ``None`` check and receive the shared :data:`NOOP_SPAN` context
  manager — no allocation, no synchronisation, bit-identical results.
* **Named internals.** The tracer's own locks come from the lockdep
  factories; span bookkeeping never blocks on I/O.
* **Thread stitching.** Each tracer keeps a per-thread stack of open
  spans, so nested ``with span(...)`` calls parent naturally. Work that
  hops threads (the pipeline's decode tasks) carries a :class:`SpanCtx`
  fork or falls back to parenting under the trace root, so worker spans
  always land inside the tree.
* **Wire propagation.** :func:`format_wire`/:func:`parse_wire` and
  :func:`adopt` carry a trace context across a process boundary; the
  port's net plane, their caller in the reference, is not ported yet.
* **Flight recorder.** A bounded process-wide ring keeps the most recent
  finished spans and engine events; :func:`flight_dump` writes it to
  ``<flightRecorder.dir>/`` (and on SIGTERM, once tracing is configured).

``tools/trace_report.py`` of the reference reads the exported files
(critical path, top self-time spans, overlap efficiency).
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
import weakref
import zlib
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..config import (TRACE_DIR, TRACE_ENABLED, TRACE_FLIGHT_DIR,
                      TRACE_FLIGHT_SPANS, TRACE_MAX_FILES)
from ..utils import lockdep

#: Trace-file schema version (Chrome trace-event JSON "otherData").
VERSION = 1


# ---------------------------------------------------------------------------
# Process-wide configuration (the lockdep configure idiom)
# ---------------------------------------------------------------------------

_STATE_LOCK = lockdep.lock("trace._STATE_LOCK")
_ENABLED = False
_TRACE_DIR: Optional[str] = None
_FLIGHT_DIR = "artifacts"
#: exported trace_*.json kept per directory (oldest pruned past this)
_MAX_FILES = 256
#: bounded ring of recent span/event dicts (flight recorder)
_RING: deque = deque(maxlen=4096)
#: dumps written this process, per reason (bounded so a crash loop
#: cannot flood the artifacts directory)
_DUMPS: Dict[str, int] = {}
_MAX_DUMPS_PER_REASON = 8
_DUMP_SEQ = [0]
#: live tracers by trace id AND by wire hash (weakrefs: an abandoned
#: query's tracer must not be pinned by the registry)
_LIVE: "weakref.WeakValueDictionary[object, Tracer]" = \
    weakref.WeakValueDictionary()
_TRACE_SEQ = [0]
_SIGTERM_INSTALLED = [False]


def configure(conf) -> None:
    """Snapshot the ``spark.rapids.tpu.trace.*`` keys into process state
    (``TorchSession`` init). Enable-only: a session with tracing off
    leaves the process state alone (per-session gating in
    :func:`maybe_tracer` already keeps it untraced), so an untraced
    session can never un-configure a traced sibling mid-query. Near-free
    and idempotent; never raises on bare test confs. Disable with
    :func:`reset_for_tests`."""
    global _ENABLED, _TRACE_DIR, _FLIGHT_DIR, _RING, _MAX_FILES
    try:
        enabled = bool(conf.get(TRACE_ENABLED))
        tdir = conf.get(TRACE_DIR)
        fdir = conf.get(TRACE_FLIGHT_DIR)
        ring = int(conf.get(TRACE_FLIGHT_SPANS))
        max_files = int(conf.get(TRACE_MAX_FILES))
    except (AttributeError, TypeError, ValueError):
        return
    if not enabled:
        return
    with _STATE_LOCK:
        _ENABLED = True
        _TRACE_DIR = tdir or None
        _FLIGHT_DIR = fdir or "artifacts"
        _MAX_FILES = max_files
        if ring > 0 and _RING.maxlen != ring:
            _RING = deque(_RING, maxlen=ring)
    _install_sigterm_dump()


def enabled() -> bool:
    return _ENABLED


def next_trace_seq() -> int:
    with _STATE_LOCK:
        _TRACE_SEQ[0] += 1
        return _TRACE_SEQ[0]


def wire_hash(trace_id: str) -> int:
    """Stable non-zero u64 of a trace id — the wire encoding (0 is
    reserved for "no trace context")."""
    h = (zlib.crc32(trace_id.encode()) << 32) \
        | zlib.crc32(trace_id[::-1].encode())
    return (h & 0xFFFFFFFFFFFFFFFF) or 1


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


class _NoopSpan:
    """Shared do-nothing span: the disabled path's context manager.
    One module-level instance, reused — entering it allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class _Span:
    """One open span handle (context manager). Closed spans are stored as
    plain dicts on the tracer; the handle itself is transient."""

    __slots__ = ("tracer", "name", "cat", "span_id", "parent_id",
                 "t0_ns", "args")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 span_id: int, parent_id: int, args: Optional[dict]):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0_ns = 0
        self.args = args

    def __enter__(self):
        self.t0_ns = time.perf_counter_ns()
        self.tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            # Error spans keep their timing and are tagged — a failed
            # fetch/dispatch must stay visible on the timeline.
            a = dict(self.args or {})
            a["error"] = type(exc).__name__
            self.args = a
        self.tracer._pop(self, time.perf_counter_ns())
        return False

    def annotate(self, **kv) -> None:
        """Attach args to an already-open span."""
        a = dict(self.args or {})
        a.update(kv)
        self.args = a


class SpanCtx:
    """A forked span context: (tracer, parent span id) captured on one
    thread and adopted on another — the cross-thread (and, through
    :meth:`Tracer.wire_context`, cross-process) parenting handle."""

    __slots__ = ("tracer", "parent_id")

    def __init__(self, tracer: "Tracer", parent_id: int):
        self.tracer = tracer
        self.parent_id = parent_id


class Tracer:
    """One query's span tree. Thread-safe: the pipeline's workers and the
    dispatching thread record concurrently. Bounded: past ``max_spans``
    spans the tracer records only a drop counter (observability must not
    hold the query's memory hostage)."""

    def __init__(self, trace_id: str, tenant: str = "",
                 max_spans: int = 100_000):
        self.trace_id = trace_id
        self.tenant = tenant
        self.query_id: Optional[int] = None
        self.max_spans = max_spans
        self.t0_ns = time.perf_counter_ns()
        self.spans: List[dict] = []
        self.dropped = 0
        self._seq = 0
        self._root_id = 0
        #: nonzero on an adopted cross-process sibling tracer: the wire
        #: parent's span id, valid as a parent even though no local span
        #: carries it (assert_balanced honors it)
        self._remote_root = 0
        self._open: Dict[int, _Span] = {}
        self._lock = lockdep.lock("Tracer._lock")
        self._tls = threading.local()
        with _STATE_LOCK:
            _LIVE[trace_id] = self
            _LIVE[wire_hash(trace_id)] = self

    # -- recording ----------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def span(self, name: str, cat: str = "engine",
             fallback_parent: Optional[int] = None, **args):
        """Open a span (context manager). Parent = this thread's
        innermost open span, else ``fallback_parent`` (a fork's captured
        parent), else the trace root."""
        st = self._stack()
        if st:
            parent = st[-1].span_id
        elif fallback_parent is not None:
            parent = fallback_parent
        else:
            parent = self._root_id
        with self._lock:
            self._seq += 1
            sid = self._seq
            if self._root_id == 0:
                self._root_id = sid
        return _Span(self, name, cat, sid, 0 if sid == parent else parent,
                     args or None)

    def _push(self, s: _Span) -> None:
        self._stack().append(s)
        with self._lock:
            self._open[s.span_id] = s

    def _pop(self, s: _Span, t1_ns: int) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] is s:
                del st[i]
                break
        rec = {"name": s.name, "cat": s.cat, "id": s.span_id,
               "parent": s.parent_id, "t0_ns": s.t0_ns, "t1_ns": t1_ns,
               "tid": threading.current_thread().name}
        if s.args:
            rec["args"] = s.args
        with self._lock:
            self._open.pop(s.span_id, None)
            if len(self.spans) < self.max_spans:
                self.spans.append(rec)
            else:
                self.dropped += 1
        _ring_append({"kind": "span", "trace_id": self.trace_id, **rec})

    # -- forking / wire -----------------------------------------------------
    def fork(self) -> SpanCtx:
        """Capture this thread's current span as the parent for work that
        will record from another thread (the boundary-fork idiom)."""
        st = self._stack()
        return SpanCtx(self, st[-1].span_id if st else self._root_id)

    def wire_context(self) -> Tuple[int, int]:
        """(trace64, span64) to stamp on an outgoing wire request."""
        st = self._stack()
        return (wire_hash(self.trace_id),
                st[-1].span_id if st else self._root_id)

    # -- introspection ------------------------------------------------------
    def assert_balanced(self) -> None:
        """Every opened span closed; every parent id valid (0/root or a
        recorded span); no span ends before it starts."""
        with self._lock:
            if self._open:
                raise AssertionError(
                    f"trace {self.trace_id}: {len(self._open)} span(s) "
                    f"left open: {[s.name for s in self._open.values()]}")
            ids = {s["id"] for s in self.spans}
            if self._remote_root:
                ids.add(self._remote_root)
            for s in self.spans:
                if s["parent"] and s["parent"] not in ids:
                    raise AssertionError(
                        f"trace {self.trace_id}: span {s['name']!r} has "
                        f"unknown parent {s['parent']}")
                if s["t1_ns"] < s["t0_ns"]:
                    raise AssertionError(
                        f"trace {self.trace_id}: span {s['name']!r} ends "
                        "before it starts")

    # -- export -------------------------------------------------------------
    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable): complete ``X``
        events in microseconds, one thread lane per recording thread,
        span args preserved; trace metadata in ``otherData``."""
        with self._lock:
            spans = list(self.spans)
            dropped = self.dropped
        tids: Dict[str, int] = {}
        events: List[dict] = []
        for s in sorted(spans, key=lambda r: r["t0_ns"]):
            tid = tids.setdefault(s["tid"], len(tids) + 1)
            ev = {"name": s["name"], "cat": s["cat"], "ph": "X",
                  "ts": (s["t0_ns"] - self.t0_ns) / 1e3,
                  "dur": (s["t1_ns"] - s["t0_ns"]) / 1e3,
                  "pid": os.getpid(), "tid": tid,
                  "args": {"id": s["id"], "parent": s["parent"],
                           **(s.get("args") or {})}}
            events.append(ev)
        for name, tid in tids.items():
            events.append({"ph": "M", "name": "thread_name",
                           "pid": os.getpid(), "tid": tid,
                           "args": {"name": name}})
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"trace_id": self.trace_id, "tenant": self.tenant,
                          "query_id": self.query_id, "version": VERSION,
                          "dropped_spans": dropped},
        }


# ---------------------------------------------------------------------------
# Call-site helpers (the one-liner every instrumented layer uses)
# ---------------------------------------------------------------------------


def span(owner, name: str, cat: str = "engine", **args):
    """The instrumentation one-liner: ``with trace.span(ctx.trace,
    "shuffle.map"):``. ``owner`` is None (disabled — returns the shared
    no-op), a :class:`Tracer`, or a :class:`SpanCtx` fork."""
    if owner is None:
        return NOOP_SPAN
    if isinstance(owner, SpanCtx):
        return owner.tracer.span(name, cat,
                                 fallback_parent=owner.parent_id, **args)
    return owner.span(name, cat, **args)


def fork(owner) -> Optional[SpanCtx]:
    """Fork the current span context for another thread; None stays
    None (disabled path)."""
    if owner is None:
        return None
    if isinstance(owner, SpanCtx):
        return owner
    return owner.fork()


def tracer_of(owner) -> Optional[Tracer]:
    if isinstance(owner, SpanCtx):
        return owner.tracer
    return owner if isinstance(owner, Tracer) else None


def maybe_tracer(conf, tenant: str = "") -> Optional[Tracer]:
    """A fresh per-query tracer when THIS conf sets
    ``spark.rapids.tpu.trace.enabled``, else None — the one lookup the
    default path pays. Gating is per session: a traced session never
    turns tracing on for an untraced sibling."""
    try:
        if not conf.get(TRACE_ENABLED):
            return None
    except (AttributeError, TypeError):
        return None
    if not _ENABLED:
        configure(conf)
        if not _ENABLED:
            return None
    tid = f"{tenant or 'default'}-{os.getpid()}-{next_trace_seq()}"
    return Tracer(tid, tenant)


def adopt(trace_id: str, parent_span_id: int = 0,
          tenant: str = "") -> Optional[Tracer]:
    """Join an incoming wire trace context: the live tracer when this
    process owns it (loopback peers stitch into one tree), else a
    sibling tracer under the same trace id (cross-process; stitched by
    id at analysis time). None when tracing is disabled here."""
    if not _ENABLED:
        return None
    with _STATE_LOCK:
        live = _LIVE.get(trace_id)
    if live is not None:
        return live
    t = Tracer(trace_id, tenant)
    t._root_id = parent_span_id or 0
    t._remote_root = parent_span_id or 0
    # Local span ids start ABOVE the remote parent id: the sibling's
    # sids share a number space with the origin's, and a collision
    # would both trip the self-parent guard and make parents ambiguous
    # when the two halves are stitched by id at analysis time.
    t._seq = max(t._seq, parent_span_id or 0)
    return t


def live_tracer(key) -> Optional[Tracer]:
    """Live-trace registry lookup by trace id or wire hash (the stitch
    path for in-process peers)."""
    with _STATE_LOCK:
        return _LIVE.get(key)


def parse_wire(s: Optional[str]) -> Tuple[Optional[str], int]:
    """Parse the wire trace field ``"<trace_id>/<parent_span>"``."""
    if not s or not isinstance(s, str):
        return None, 0
    tid, _, parent = s.partition("/")
    try:
        return (tid or None), int(parent or 0)
    except ValueError:
        return (tid or None), 0


def format_wire(tracer: Optional[Tracer]) -> Optional[str]:
    """The wire trace-field encoding of a tracer's current context."""
    if tracer is None:
        return None
    st = tracer._stack()
    parent = st[-1].span_id if st else tracer._root_id
    return f"{tracer.trace_id}/{parent}"


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------


def export_dir(conf=None) -> Optional[str]:
    """Where trace files land: the CALLER's ``spark.rapids.tpu.trace.dir``
    (per-session, so two traced sessions can export to different
    places), else the process snapshot, else the caller's event-log dir
    (traces sit beside the event log), else None."""
    if conf is not None:
        try:
            d = conf.get(TRACE_DIR)
            if d:
                return d
        except (AttributeError, TypeError):
            pass
    if _TRACE_DIR:
        return _TRACE_DIR
    try:
        return conf.metrics_event_log_dir if conf is not None else None
    except AttributeError:
        return None


def export_chrome(tracer: Tracer, directory: Optional[str]) -> Optional[str]:
    """Write one query's Chrome trace-event JSON as
    ``trace_<trace_id>.json`` under ``directory`` — an adopted
    cross-process sibling adds a ``.peer<pid>`` discriminator, so the
    two halves of a stitched trace exported to one shared directory
    never clobber each other. The directory is retention-bounded
    (``spark.rapids.tpu.trace.maxFiles``: oldest pruned). Best-effort:
    tracing is an aid, never a failure path — any error returns None."""
    if directory is None:
        return None
    safe = "".join(c if c.isalnum() or c in "-_." else "_"
                   for c in tracer.trace_id)
    if tracer._remote_root:
        safe = f"{safe}.peer{os.getpid()}"
    path = os.path.join(directory, f"trace_{safe}.json")
    try:
        os.makedirs(directory, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(tracer.to_chrome(), f, separators=(",", ":"),
                      default=str)
            f.write("\n")
        os.replace(tmp, path)  # atomic: a reader never sees a torn file
        _prune_trace_dir(directory)
        return path
    except (OSError, TypeError, ValueError):
        return None


def _prune_trace_dir(directory: str) -> None:
    """Drop the oldest ``trace_*.json`` past the retention cap — a
    long-lived process exports one file per query, and traces must not
    fill the disk the event log's maxBytes rotation already guards."""
    cap = _MAX_FILES
    if cap <= 0:
        return
    try:
        entries = [(e.stat().st_mtime, e.path)
                   for e in os.scandir(directory)
                   if e.name.startswith("trace_")
                   and e.name.endswith(".json")]
    except OSError:
        return
    if len(entries) <= cap:
        return
    for _, victim in sorted(entries)[:len(entries) - cap]:
        try:
            os.remove(victim)
        except OSError:
            pass  # concurrent exporter pruned it first


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------


def _ring_append(rec: dict) -> None:
    if _ENABLED:
        _RING.append(rec)  # deque append is atomic; maxlen bounds it


def record_event(name: str, **args) -> None:
    """Record one engine event (a kernel build, a crash) into the
    flight-recorder ring. Near-free when tracing is off."""
    if not _ENABLED:
        return
    _RING.append({"kind": "event", "name": name,
                  "ts_ns": time.perf_counter_ns(),
                  "thread": threading.current_thread().name,
                  **({"args": args} if args else {})})


def flight_dump(reason: str, _signal_safe: bool = False,
                **context) -> Optional[str]:
    """Dump the flight-recorder ring to
    ``<flightDir>/flight_<reason>_<pid>_<n>.json`` (on SIGTERM, and for
    any caller that wants the post-mortem); bounded per reason so a
    crash loop cannot flood the directory. Best-effort, never raises.

    ``_signal_safe`` is set ONLY by the SIGTERM handler: a signal lands
    between bytecodes on the main thread, which may already hold
    ``_STATE_LOCK`` (every tracer construction takes it) — acquiring it
    from the handler would self-deadlock the shutdown path. The
    signal-safe variant reads the state unsynchronized instead
    (GIL-atomic container ops; a raced counter at process death is
    acceptable, a hung SIGTERM is not)."""
    if not _ENABLED:
        return None
    if _signal_safe:
        # Deliberately lock-free (see docstring): runs only inside the
        # SIGTERM handler on the main thread, where taking _STATE_LOCK
        # could self-deadlock. A torn counter at process death is fine.
        n = _DUMPS.get(reason, 0)
        if n >= _MAX_DUMPS_PER_REASON:
            return None
        _DUMPS[reason] = n + 1  # concurrency: ignore
        _DUMP_SEQ[0] += 1  # concurrency: ignore
        seq = _DUMP_SEQ[0]
        directory = _FLIGHT_DIR
        ring = list(_RING)
    else:
        with _STATE_LOCK:
            n = _DUMPS.get(reason, 0)
            if n >= _MAX_DUMPS_PER_REASON:
                return None
            _DUMPS[reason] = n + 1
            _DUMP_SEQ[0] += 1
            seq = _DUMP_SEQ[0]
            directory = _FLIGHT_DIR
            ring = list(_RING)
    payload = {
        "reason": reason,
        "context": {k: str(v) for k, v in context.items()},
        "pid": os.getpid(),
        "ts_ns": time.perf_counter_ns(),
        "version": VERSION,
        "recent": ring,
    }
    path = os.path.join(directory, f"flight_{reason}_{os.getpid()}_{seq}.json")
    try:
        os.makedirs(directory, exist_ok=True)
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, separators=(",", ":"), default=str)
            f.write("\n")
        os.replace(tmp, path)
        return path
    except (OSError, TypeError, ValueError):
        return None


def _install_sigterm_dump() -> None:
    """Chain a SIGTERM handler that dumps the flight recorder before the
    previous disposition runs (main thread only; best-effort)."""
    with _STATE_LOCK:
        if _SIGTERM_INSTALLED[0]:
            return
        _SIGTERM_INSTALLED[0] = True
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            flight_dump("sigterm", _signal_safe=True)
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)
        signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError, RuntimeError):
        # Not the main thread, or signals unavailable: the other dump
        # triggers still fire.
        with _STATE_LOCK:
            _SIGTERM_INSTALLED[0] = False


def ring_snapshot() -> List[dict]:
    """Current flight-recorder contents (tests/diagnostics)."""
    return list(_RING)


def reset_for_tests() -> None:
    """Clear process trace state (test isolation): ring, dump budgets,
    and the enabled flag (configure() re-arms it)."""
    global _ENABLED, _TRACE_DIR
    with _STATE_LOCK:
        _ENABLED = False
        _TRACE_DIR = None
        _RING.clear()
        _DUMPS.clear()
