"""Fused programs as CUDA graphs — port of
``spark_rapids_tpu/compile/executables.py`` (``FusedProgram``,
``aval_signature``; ``abstract_like`` waits with the warm-up).

The reference's fused region is one ``jax.jit`` callable, specialised
per input aval signature. The port's counterpart is one
``torch.cuda.CUDAGraph`` per region and **key**, the signature of its
inputs (:func:`aval_signature`): for every input lane its shape, dtype
and column kind, plus the static host data a column carries (its
``max_bytes``, ``dict_sorted`` and the identity of a dictionary's host
entries, the aux data of the reference's columns). A replay re-runs no
Python, so everything the region computed on the host during its
capture (a dictionary lookup, a merged dictionary, a capacity) is fixed
in the graph; the key must therefore hold every input that host work
read. The fused path keys the program itself by the plan, the learned
modes and capacities (:mod:`..exec.fusion`).

On the card, for each key:

1. the first call runs the region eagerly under
   ``torch.cuda.set_sync_debug_mode("error")``: a region that
   synchronises with the host (``.item()``, ``nonzero``, a pageable
   upload) raises there and is **refused** — its site is kept, and the
   caller runs the region on the streaming path from then on;
2. the second call captures the region on a side stream, reading static
   input tensors (each a copy of the call's input, or the input itself
   when the caller marks it resident: a table uploaded once, which the
   key then names by address) and writing static outputs, then replays
   it once;
3. every later call copies its inputs into the static ones and replays.

A key never keeps a resident table alive: the entry holds no reference
to it (an output that is the input itself is taken from the call), and
a finalizer on each resident tensor drops every key that names it, its
graph with it, at the next call, release or statistics of any program
(:func:`_drain_dead`). A graph does read such a table in place, but only
a call whose inputs sit at exactly those addresses replays it. The
small host-derived constants a capture read
(:func:`..data.column.device_constant`, a cache that evicts) are held by
the entry until its graph is released.

On the CPU a call runs the region directly: there is nothing to
capture, as a kernel wrapper takes its plain version there.

The outputs of a replay are overwritten by the next one, so each
program holds a lock (``FusedProgram._run_lock``) from copy-in through
replay to the caller's consumption of the outputs (the head download).
Each captured graph has a private memory pool; its bytes, with the
static inputs, count against the spill catalog's device budget
(:func:`graph_bytes`): graphs are released least recently used first
when the catalog is over budget (:func:`release_lru`), and all of them
by the OOM drain (:func:`release_all`). Pools are never shared between
graphs, so releasing one cannot free memory another replays into. A
released key is dropped with its graph: its next call starts again at
step 1. A capture that runs
out of memory is tried once more with every other graph released; a
second OOM marks the program refused (``refused_site``) and propagates
to the session's retry, whose re-run streams the plan. Any other error
of a capture or a replay propagates as it is.

Launch counts: the kernel wrappers count their launches in Python, and
a replay runs none; each graph keeps the launches its capturing thread
counted (:func:`..ops.kernels.cuda.recording_launches`) and adds them to
the wrappers' counts at every replay
(:func:`..ops.kernels.cuda.add_launches`).
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import os
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import lockdep

#: Every live FusedProgram (diagnostics); weak, as in the reference.
_REGISTRY: "weakref.WeakSet[FusedProgram]" = weakref.WeakSet()

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------------------
# Trees of batches: tensor leaves and a static spec
# --------------------------------------------------------------------------


def _tree_classes():
    from ..data.batch import ColumnarBatch
    from ..data.column import DeviceColumn
    return (ColumnarBatch, DeviceColumn)


#: dataclass -> its field names (``dataclasses.fields`` is slow per call)
_FIELDS: Dict[type, tuple] = {}
_LEAF = ("T",)


def flatten(tree) -> Tuple[List[torch.Tensor], tuple]:
    """``(leaves, spec)`` of a tree of batches, columns, tuples, lists
    and dicts: the tensors in a fixed order, and everything else in the
    spec. :func:`unflatten` inverts it."""
    leaves: List[torch.Tensor] = []
    classes = _tree_classes()
    tensor = torch.Tensor

    def rec(x):
        if isinstance(x, tensor):
            leaves.append(x)
            return _LEAF
        if isinstance(x, (tuple, list)):
            return ("seq", type(x) is list, tuple(rec(v) for v in x))
        if isinstance(x, dict):
            keys = tuple(x)
            return ("dict", keys, tuple(rec(x[k]) for k in keys))
        if isinstance(x, classes):
            cls = type(x)
            names = _FIELDS.get(cls)
            if names is None:
                names = _FIELDS.setdefault(cls, tuple(
                    f.name for f in dataclasses.fields(cls)))
            return ("dc", cls, tuple((n, rec(getattr(x, n)))
                                     for n in names))
        return ("S", x)
    return leaves, rec(tree)


def unflatten(spec: tuple, leaves) -> object:
    it = iter(leaves)

    def rec(s):
        kind = s[0]
        if kind == "T":
            return next(it)
        if kind == "seq":
            vals = [rec(c) for c in s[2]]
            return vals if s[1] else tuple(vals)
        if kind == "dict":
            return {k: rec(c) for k, c in zip(s[1], s[2])}
        if kind == "dc":
            return s[1](**{name: rec(c) for name, c in s[2]})
        return s[1]
    return rec(spec)


def _static_key(v, refs: list):
    if isinstance(v, np.ndarray):
        # a dictionary's host entries, by identity: the entry that holds
        # this key keeps the array alive, so the id is not reused
        refs.append(v)
        return ("nd", id(v))
    try:
        hash(v)
        return v
    except TypeError:
        return ("repr", type(v).__qualname__, repr(v))


def key_flatten(tree) -> Tuple[List[torch.Tensor], tuple, list]:
    """``(leaves, skey, refs)`` in one pass: :func:`flatten`'s leaves, a
    hashable key of the tree's structure and static data (a dictionary's
    host entries by identity), and the host objects that key names by
    identity, which its holder must keep alive."""
    leaves: List[torch.Tensor] = []
    refs: list = []
    classes = _tree_classes()
    tensor = torch.Tensor

    def rec(x):
        if isinstance(x, tensor):
            leaves.append(x)
            return _LEAF
        if isinstance(x, (tuple, list)):
            return ("seq", type(x) is list, tuple(rec(v) for v in x))
        if isinstance(x, dict):
            keys = tuple(x)
            return ("dict", keys, tuple(rec(x[k]) for k in keys))
        if isinstance(x, classes):
            cls = type(x)
            names = _FIELDS.get(cls)
            if names is None:
                names = _FIELDS.setdefault(cls, tuple(
                    f.name for f in dataclasses.fields(cls)))
            return ("dc", cls, tuple((n, rec(getattr(x, n)))
                                     for n in names))
        return ("S", _static_key(x, refs))
    skey = rec(tree)
    return leaves, skey, refs


class HashedTuple(tuple):
    """A tuple whose (deep) hash is computed once: a program's key and a
    plan's signature are looked up several times a call."""

    def __new__(cls, parts):
        self = super().__new__(cls, parts)
        self._hash = tuple.__hash__(self)
        return self

    def __hash__(self):
        return self._hash

    def __reduce__(self):
        return (HashedTuple, (tuple(self),))


def aval_signature(tree, resident: frozenset = frozenset(), flat=None):
    """``(key, refs)``: the hashable key of a tree of inputs (its
    structure and static data, then each leaf's shape, dtype and device,
    and, for a leaf whose id is in ``resident``, its address) and the
    host objects the key names by identity, which its holder must keep
    alive. A resident leaf is named by address and not kept: its holder
    drops the key when the leaf dies (:meth:`FusedProgram.__call__`).
    ``flat`` is the tree's :func:`key_flatten`, when the caller has it."""
    leaves, skey, refs = flat if flat is not None else key_flatten(tree)
    if resident:
        lanes = tuple(
            (t.shape, t.dtype, t.device, "R", t.data_ptr())
            if id(t) in resident else (t.shape, t.dtype, t.device)
            for t in leaves)
    else:
        lanes = tuple((t.shape, t.dtype, t.device) for t in leaves)
    return HashedTuple((skey, lanes)), refs


# --------------------------------------------------------------------------
# Sync detection
# --------------------------------------------------------------------------


class RegionRefused(Exception):
    """A region synchronised with the host during its first, eager run;
    ``site`` names the port's innermost frame that did."""

    def __init__(self, site: str, message: str):
        super().__init__(f"{site}: {message}")
        self.site = site


def _is_sync_error(e: BaseException) -> bool:
    return isinstance(e, RuntimeError) and \
        "synchronizing CUDA operation" in str(e)


def _sync_site(tb) -> str:
    """``path:line func`` of the innermost frame of the port (outside
    this module) in ``tb``."""
    site = "?"
    while tb is not None:
        code = tb.tb_frame.f_code
        path = os.path.abspath(code.co_filename)
        if path.startswith(_PKG_ROOT) and path != os.path.abspath(__file__):
            rel = os.path.relpath(path, os.path.dirname(_PKG_ROOT))
            site = f"{rel}:{tb.tb_lineno} {code.co_name}"
        tb = tb.tb_next
    return site


def run_sync_checked(fn: Callable, *args):
    """``fn(*args)`` with every synchronising CUDA operation raising;
    a synchronisation becomes :class:`RegionRefused`. Kernel-launch
    event timing is off inside, as in a capture."""
    from ..ops.kernels import cuda as KCUDA
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with KCUDA.device_timing(None):
            return fn(*args)
    except RuntimeError as e:
        if _is_sync_error(e):
            raise RegionRefused(_sync_site(e.__traceback__),
                                str(e).splitlines()[0]) from None
        raise
    finally:
        torch.cuda.set_sync_debug_mode(prev)


# --------------------------------------------------------------------------
# Programs and their graphs
# --------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class _Entry:
    """One key of one program: ``state`` is ``eager`` (ran once, no
    synchronisation), ``captured`` or ``refused``. ``refs`` are the host
    objects its key names by identity; ``finalizers`` drop it when a
    resident input dies; ``consts`` are the device constants (and their
    pinned sources) its graph reads."""
    state: str
    refs: list
    site: str = ""
    finalizers: list = dataclasses.field(default_factory=list)
    graph: Optional[object] = None
    static_in: Optional[List[Optional[torch.Tensor]]] = None
    copy_in: Optional[List[bool]] = None
    out_leaves: Optional[List[Optional[torch.Tensor]]] = None
    #: per output leaf: the index of the input leaf it is (a resident
    #: table passed through, taken from the call), else None
    out_from_in: Optional[List[Optional[int]]] = None
    out_spec: Optional[tuple] = None
    consts: Optional[list] = None
    launches: Optional[dict] = None
    pool_bytes: int = 0
    capture_ms: float = 0.0
    replays: int = 0


_LIVE_LOCK = lockdep.lock("executables._LIVE_LOCK")
#: captured (program, key) -> entry, least recently replayed first
_LIVE: "collections.OrderedDict[tuple, Tuple[FusedProgram, tuple]]" = \
    collections.OrderedDict()
#: the pool bytes of every graph in _LIVE
_LIVE_BYTES = [0]
_RELEASED = {"graphs": 0, "bytes": 0, "dead_keys": 0}
#: sync site -> keys refused there since the process started (kept when
#: the programs themselves are dropped)
_REFUSAL_SITES: "collections.Counter[str]" = collections.Counter()
#: (weak program, key) pairs whose resident input died, to be dropped
#: (a finalizer only queues: it may run in any thread, under any lock)
_DEAD: "collections.deque[tuple]" = collections.deque()


def _queue_dead(prog_ref, key) -> None:
    _DEAD.append((prog_ref, key))


def _drain_dead() -> int:
    """Drop every key whose resident input died. Returns the keys
    dropped; a key whose program is in use stays queued."""
    dropped = 0
    retry = []
    while True:
        try:
            prog_ref, key = _DEAD.popleft()
        except IndexError:
            break
        prog = prog_ref()
        if prog is None:
            continue
        got = prog._drop(key, blocking=False)
        if got is None:
            retry.append((prog_ref, key))
        elif got:
            dropped += 1
    _DEAD.extend(retry)
    if dropped:
        with _LIVE_LOCK:
            _RELEASED["dead_keys"] += dropped
    return dropped


class FusedProgram:
    """One fused region: ``fn(inputs, ctx) -> outputs`` plus its table
    of keys (:class:`_Entry`). Call it as ``program(inputs, ctx,
    consume)``: ``consume(outputs)`` runs under the program's lock and
    its value is returned; ``outputs`` is None when the region was
    refused (``program.last`` then says why)."""

    def __init__(self, fn: Callable, label: str = ""):
        self.fn = fn
        self.label = label
        self._table: Dict[tuple, _Entry] = {}
        self._lock = lockdep.lock("FusedProgram._lock")
        # guards static inputs and outputs from copy-in to consumption;
        # it exists to be held across that device I/O
        self._run_lock = lockdep.lock("FusedProgram._run_lock", io_ok=True)
        self._stats = {"calls": 0, "eager_calls": 0, "captures": 0,
                       "replays": 0, "refusals": 0, "compile_seconds": 0.0}
        #: the sync site of the first key refused (None: none was); the
        #: fused path streams the program's plan once it is set
        self.refused_site: Optional[str] = None
        #: what the last call did: {"action": "eager" | "capture" |
        #: "replay" | "refused" | "cpu", "site", "capture_ms",
        #: "pool_bytes", "launches"}
        self.last: dict = {}
        _REGISTRY.add(self)

    def key_of(self, inputs, resident: frozenset = frozenset(), flat=None):
        return aval_signature(inputs, resident, flat)

    def seen(self, key) -> bool:
        with self._lock:
            return key in self._table

    def jit_compiled(self, key) -> bool:
        """True when a graph is captured for exactly this key (the
        reference's "the jit path compiled this signature")."""
        with self._lock:
            e = self._table.get(key)
            return e is not None and e.state == "captured"

    def refusal(self, key) -> Optional[str]:
        with self._lock:
            e = self._table.get(key)
            return e.site if e is not None and e.state == "refused" \
                else None

    def __call__(self, inputs, ctx, consume: Callable,
                 resident: frozenset = frozenset(), key=None, refs=None,
                 flat=None):
        """``flat`` is the inputs' :func:`key_flatten`, when the caller
        has it (with ``key`` and ``refs``, their :func:`aval_signature`)."""
        flat = flat if flat is not None else key_flatten(inputs)
        if key is None:
            key, refs = self.key_of(inputs, resident, flat)
        if _DEAD:
            _drain_dead()
        with self._lock:
            self._stats["calls"] += 1
            entry = self._table.get(key)
        on_card = any(t.is_cuda for t in flat[0])
        with self._run_lock:
            if not on_card:
                self.last = {"action": "cpu"}
                with self._lock:
                    self._stats["eager_calls"] += 1
                # the region runs its plan's operators (fusion.py)
                out = self.fn(inputs, ctx)  # concurrency: calls execute
                return consume(out)
            if entry is None:
                return self._first(inputs, ctx, consume, key, refs, flat[0])
            if entry.state == "refused":
                self.last = {"action": "refused", "site": entry.site}
                return consume(None)
            if entry.state == "eager":
                return self._capture_or_refuse(inputs, ctx, consume, key,
                                               entry)
            return self._replay(flat[0], consume, key, entry)

    def _add_entry(self, key, entry: _Entry, leaves) -> None:
        """Enter ``key``, with a finalizer on each resident leaf that
        queues the key's drop when the leaf dies."""
        me = weakref.ref(self)
        for t, lane in zip(leaves, key[1]):
            if len(lane) > 3:
                entry.finalizers.append(
                    weakref.finalize(t, _queue_dead, me, key))
        with self._lock:
            self._table[key] = entry

    def _drop(self, key, blocking: bool = True) -> Optional[bool]:
        """Remove ``key`` and its graph. Returns True when it was there,
        False when not, None when (without ``blocking``) a call holds the
        program."""
        if not self._run_lock.acquire(blocking=blocking):
            return None
        try:
            with self._lock:
                e = self._table.pop(key, None)
        finally:
            self._run_lock.release()
        if e is None:
            return False
        for f in e.finalizers:
            f.detach()
        if e.state == "captured":
            with _LIVE_LOCK:
                if _LIVE.pop((id(self), key), None) is not None:
                    _LIVE_BYTES[0] -= e.pool_bytes
                _RELEASED["graphs"] += 1
                _RELEASED["bytes"] += e.pool_bytes
        return True

    def _capture_or_refuse(self, inputs, ctx, consume, key, entry):
        """Capture, with room made first. A capture that runs out of
        memory is tried once more after every other graph is released; a
        second failure marks the program refused for memory and re-raises
        the OOM to the session's retry, whose re-run then streams the
        plan (its operators spill and retry there)."""
        dev = flatten(inputs)[0][0].device
        _make_room(dev, CAPTURE_FREE)
        try:
            return self._capture(inputs, ctx, consume, key, entry)
        except torch.OutOfMemoryError:
            pass
        # the failed capture's frames are gone: its memory can go too
        # (this program's own graphs are skipped: it is held here)
        gc.collect()
        release_lru(1 << 62)
        torch.cuda.empty_cache()
        try:
            return self._capture(inputs, ctx, consume, key, entry)
        except torch.OutOfMemoryError:
            site = "capture out of memory"
            with self._lock:
                entry.state, entry.site = "refused", site
                self._stats["refusals"] += 1
                if self.refused_site is None:
                    self.refused_site = site
            with _LIVE_LOCK:
                _REFUSAL_SITES[site] += 1
            raise

    def _first(self, inputs, ctx, consume, key, refs, leaves):
        try:
            out = run_sync_checked(
                self.fn, inputs, ctx)  # concurrency: calls execute
        except RegionRefused as r:
            self._add_entry(key, _Entry("refused", refs, site=r.site),
                            leaves)
            with self._lock:
                self._stats["refusals"] += 1
                if self.refused_site is None:
                    self.refused_site = r.site
            with _LIVE_LOCK:
                _REFUSAL_SITES[r.site] += 1
            self.last = {"action": "refused", "site": r.site}
            return consume(None)
        self._add_entry(key, _Entry("eager", refs), leaves)
        with self._lock:
            self._stats["eager_calls"] += 1
        self.last = {"action": "eager"}
        return consume(out)

    def _capture(self, inputs, ctx, consume, key, entry: _Entry):
        from ..data.column import recording_constants
        from ..ops.kernels import cuda as KCUDA
        leaves, spec = flatten(inputs)
        dev = leaves[0].device
        # resident leaves (named by address in the key) are read in
        # place and not kept; the rest get a static copy the replays
        # copy into
        copy_in = [len(lane) == 3 for lane in key[1]]
        t0 = time.perf_counter()
        reserved0 = torch.cuda.memory_reserved(dev)
        static_in = [t.clone() if c else None
                     for t, c in zip(leaves, copy_in)]
        static_inputs = unflatten(spec, [s if c else t for s, t, c in zip(
            static_in, leaves, copy_in)])
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), KCUDA.device_timing(None), \
                recording_constants() as consts, \
                KCUDA.recording_launches() as launches:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = self.fn(static_inputs, ctx)  # concurrency: calls execute
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is invalid; the first error wins
                raise
            graph.capture_end()
        del static_inputs
        torch.cuda.current_stream(dev).wait_stream(side)
        out_leaves, out_spec = flatten(out)
        del out
        # an output that is a resident input itself is taken from each
        # call: kept here, it would keep the table alive
        resident_at = {id(t): i for i, (t, c) in enumerate(
            zip(leaves, copy_in)) if not c}
        out_from_in = [resident_at.get(id(t)) for t in out_leaves]
        out_leaves = [None if j is not None else t
                      for t, j in zip(out_leaves, out_from_in)]
        graph.replay()
        capture_ms = (time.perf_counter() - t0) * 1e3
        pool = torch.cuda.memory_reserved(dev) - reserved0
        entry.graph = graph
        entry.static_in = static_in
        entry.copy_in = copy_in
        entry.out_leaves = out_leaves
        entry.out_from_in = out_from_in
        entry.out_spec = out_spec
        entry.consts = consts
        entry.launches = launches
        entry.pool_bytes = max(pool, 0) + sum(
            t.numel() * t.element_size() for t in static_in if t is not None)
        entry.capture_ms = capture_ms
        entry.state = "captured"
        with self._lock:
            self._stats["captures"] += 1
            self._stats["compile_seconds"] += capture_ms / 1e3
        with _LIVE_LOCK:
            _LIVE[(id(self), key)] = (self, key)
            _LIVE_BYTES[0] += entry.pool_bytes
        self.last = {"action": "capture", "capture_ms": capture_ms,
                     "pool_bytes": entry.pool_bytes,
                     "launches": dict(launches)}
        _keep_headroom(dev, exclude=(id(self), key))
        return consume(unflatten(out_spec, _outputs(entry, leaves)))

    def _replay(self, leaves, consume, key, entry: _Entry):
        from ..ops.kernels import cuda as KCUDA
        for dst, src, c in zip(entry.static_in, leaves, entry.copy_in):
            if c:
                dst.copy_(src)
        entry.graph.replay()
        KCUDA.add_launches(entry.launches)
        entry.replays += 1
        with self._lock:
            self._stats["replays"] += 1
        with _LIVE_LOCK:
            _LIVE.move_to_end((id(self), key), last=True)
        self.last = {"action": "replay", "launches": dict(entry.launches),
                     "pool_bytes": entry.pool_bytes}
        return consume(unflatten(entry.out_spec, _outputs(entry, leaves)))

    def release(self, key, blocking: bool = True) -> int:
        """Drop the graph of ``key`` with its entry (its next call runs
        eagerly again, then captures). Returns the bytes it held; 0 when
        it had none or, without ``blocking``, when a call holds the
        program."""
        with self._lock:
            e = self._table.get(key)
            if e is None or e.state != "captured":
                return 0
        freed = e.pool_bytes
        return freed if self._drop(key, blocking) else 0

    def stats(self) -> dict:
        with self._lock:
            s = dict(self._stats)
            s["graphs"] = sum(e.state == "captured"
                              for e in self._table.values())
            s["pool_bytes"] = sum(e.pool_bytes for e in self._table.values())
        # the reference's names: a capture is this port's compile
        s["jit_compiles"] = s["captures"]
        return s


def _outputs(entry: _Entry, leaves) -> list:
    """A captured entry's output leaves for a call with input ``leaves``
    (an output that is a resident input is that input)."""
    return [t if j is None else leaves[j]
            for t, j in zip(entry.out_leaves, entry.out_from_in)]


#: After a capture, older graphs are released until this share of the
#: card's memory is free again: a graph's pool holds every intermediate
#: of its region, and the tables the graphs read are not in the spill
#: catalog's accounting.
HEADROOM = 1 / 8
#: Before a capture, graphs are released (and the allocator's cached
#: blocks returned) until this share is free: a capture allocates its
#: region's whole working set in a pool of its own, which cannot reuse
#: the blocks the allocator keeps cached for other tensors.
CAPTURE_FREE = 1 / 8


def _keep_headroom(dev, exclude=None) -> None:
    free, total = torch.cuda.mem_get_info(dev)
    want = int(total * HEADROOM)
    if free < want:
        release_lru(want - free, exclude=exclude)


def _make_room(dev, share: float) -> None:
    free, total = torch.cuda.mem_get_info(dev)
    want = int(total * share)
    if free >= want:
        return
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info(dev)
    if free < want:
        release_lru(want - free)


def graph_bytes() -> int:
    """Device bytes held by every captured graph (pools and static
    inputs): a running total, since the spill catalog reads it at every
    registration."""
    if _DEAD:
        _drain_dead()
    return _LIVE_BYTES[0]


def release_lru(n_bytes: int, exclude=None) -> int:
    """Release captured graphs, least recently replayed first, until
    ``n_bytes`` are freed; a graph whose program is in use (or whose
    ``(id(program), key)`` is ``exclude``) is skipped. Returns the bytes
    freed."""
    if _DEAD:
        _drain_dead()
    freed = 0
    with _LIVE_LOCK:
        order = [v for k, v in _LIVE.items() if k != exclude]
    for prog, key in order:
        if freed >= n_bytes:
            break
        freed += prog.release(key, blocking=False)
    if freed and torch.cuda.is_available():
        torch.cuda.empty_cache()
    return freed


def release_all() -> int:
    """Release every captured graph (the OOM drain). Returns the bytes
    freed."""
    if _DEAD:
        _drain_dead()
    freed = 0
    with _LIVE_LOCK:
        order = list(_LIVE.values())
    for prog, key in order:
        freed += prog.release(key)
    if freed and torch.cuda.is_available():
        torch.cuda.empty_cache()
    return freed


def stats() -> dict:
    """Totals over every live program: calls, eager calls, captures
    (``jit_compiles``, the reference's name), replays, refusals,
    capture seconds, live graphs and their bytes; and, over the process,
    the graphs released so far (``dead_keys``: the keys dropped because
    a resident input died) and the refusals by sync site."""
    if _DEAD:
        _drain_dead()
    total = {"programs": 0, "calls": 0, "eager_calls": 0, "captures": 0,
             "replays": 0, "refusals": 0, "compile_seconds": 0.0,
             "graphs": 0, "pool_bytes": 0}
    for prog in list(_REGISTRY):
        s = prog.stats()
        total["programs"] += 1
        for k in total:
            if k != "programs":
                total[k] += s[k]
    total["jit_compiles"] = total["captures"]
    total["compile_seconds"] = round(total["compile_seconds"], 6)
    total["released_graphs"] = _RELEASED["graphs"]
    total["released_bytes"] = _RELEASED["bytes"]
    total["dead_keys"] = _RELEASED["dead_keys"]
    with _LIVE_LOCK:
        total["refusal_sites"] = dict(_REFUSAL_SITES)
    return total
