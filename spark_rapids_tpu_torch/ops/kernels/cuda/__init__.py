"""Hand-written CUDA kernels for Hopper (``sm_90a``) — the port of
``spark_rapids_tpu/ops/kernels/pallas``.

One module per kernel family, each holding the wrapper (which launches
the kernel for CUDA tensors and bumps its ``launches`` count), the plain
PyTorch version (taken for CPU tensors, and the kernel's yardstick on
the card) and nothing else:

* :mod:`.join_probe` — ``joinProbe``, the direct-address join table;
* :mod:`.segmented` — ``segmented``, the sort-path group-by reductions;
* :mod:`.sort_steps` — ``sortStep``, the argsort of a packed single-key
  lane;
* :mod:`.strings` — ``strings``, the gather of flat-string rows (from
  the column's offsets and payload on the path; of char-matrix rows, the
  Pallas kernel's counterpart) and the rowwise compare of two char
  matrices (``group_ids``);
* :mod:`.hashing` — ``hash``, Spark's murmur3 of string rows (the hash
  exchange's partition ids).

:mod:`.strings_cases` holds the ragged gather's edge cases (numpy only),
for the tests and ``chip_smoke.py``.

Sources are in ``csrc/``; :mod:`._build` compiles them with ``nvcc`` at
first use and loads them with ``ctypes``.
"""

import contextlib
import importlib
import threading
from typing import Dict

from . import _build

#: Kernel family (the names of ``PERF.md``'s kernel table) -> the
#: wrappers that launch it, as (module, attribute owning the count).
#: ``strings`` and ``hash`` count both entries of their module; the
#: char-matrix ones are off the path.
FAMILIES = {
    "joinProbe": (("join_probe", "_COUNTED"),),
    "segmented": (("segmented", "_COUNTED"),),
    "sortStep": (("sort_steps", "_COUNTED"),),
    "strings": (("strings", "_GATHER_COUNTED"), ("strings", "_COUNTED")),
    "stringsEqual": (("strings", "_COUNTED_EQUAL"),),
    "hash": (("hashing", "_STRING_COUNTED"), ("hashing", "_COUNTED")),
}


def stats() -> dict:
    """Process-wide ``{"launches": {family: n}, "builds": {"count": n,
    "ns": ns}}``: the wrappers' ``launches`` counts summed per family,
    and the ``nvcc`` builds of :mod:`._build`. The query profile takes
    their deltas over a query."""
    launches = {}
    for fam, owners in FAMILIES.items():
        launches[fam] = sum(
            getattr(importlib.import_module(f"{__name__}.{mod}"),
                    attr).launches for mod, attr in owners)
    return {"launches": launches, "builds": _build.build_stats()}


def _owners():
    """``{(module, attr): the wrapper owning the count}`` of every
    family's entries."""
    return {(mod, attr): getattr(importlib.import_module(
        f"{__name__}.{mod}"), attr)
        for owners in FAMILIES.values() for mod, attr in owners}


#: Guards the wrappers' ``launches`` counts: kernels launch from the
#: query thread and the pipeline's workers, of one query or of several.
_COUNT_LOCK = threading.Lock()


class _Recording(threading.local):
    #: ``{id(owner): launches}`` of the capture open on this thread, or
    #: None
    sink = None


_RECORDING = _Recording()


def count_launch(owner) -> None:
    """Count one launch of the wrapper ``owner``: its ``launches`` count,
    and the recording of a capture open on this thread
    (:func:`recording_launches`)."""
    with _COUNT_LOCK:
        owner.launches += 1
    sink = _RECORDING.sink
    if sink is not None:
        sink[id(owner)] = sink.get(id(owner), 0) + 1


@contextlib.contextmanager
def recording_launches():
    """While open, the launches this thread counts are also recorded;
    yields a dict that holds them afterwards as ``{(module, attr): n}``
    per owner: what a CUDA graph's capture recorded. Launches of other
    threads (a pipeline worker, another query) are not in it."""
    prev, _RECORDING.sink = _RECORDING.sink, {}
    out: dict = {}
    try:
        yield out
    finally:
        sink, _RECORDING.sink = _RECORDING.sink, prev
        out.update({k: sink[id(fn)] for k, fn in _owners().items()
                    if id(fn) in sink})


def by_family(delta: dict) -> Dict[str, int]:
    """A capture's recorded launches (:func:`recording_launches`) summed
    per kernel family."""
    out: Dict[str, int] = {}
    for fam, owners in FAMILIES.items():
        n = sum(delta.get(o, 0) for o in owners)
        if n:
            out[fam] = n
    return out


def add_launches(delta: dict) -> None:
    """Add a captured graph's launches (:func:`recording_launches`) to
    the wrappers' counts: a replay launches every kernel the capture
    recorded, and runs none of the wrappers' Python."""
    owners = _owners()
    with _COUNT_LOCK:
        for k, n in delta.items():
            owners[k].launches += n


class _Timing(threading.local):
    #: list of (family, start event, end event), or None: off
    sink = None


_TIMING = _Timing()


@contextlib.contextmanager
def device_timing(sink: list):
    """While open, every kernel launch of this thread records a CUDA
    event pair around it into ``sink`` as ``(family, start, end)``. The
    events are read later (:func:`device_ns`); nothing here waits on the
    device."""
    prev, _TIMING.sink = _TIMING.sink, sink
    try:
        yield
    finally:
        _TIMING.sink = prev


@contextlib.contextmanager
def launch_events(family: str):
    """Wrap one launch on the current stream: a CUDA event pair into this
    thread's :func:`device_timing` sink when one is open, else nothing
    (one attribute read)."""
    sink = _TIMING.sink
    if sink is None:
        yield
        return
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    sink.append((family, start, end))


def device_ns(sink: list) -> Dict[str, int]:
    """``{family: nanoseconds}`` summed over ``sink``'s event pairs. Every
    end event must have completed (the caller synchronised)."""
    out: Dict[str, int] = {}
    for fam, start, end in sink:
        out[fam] = out.get(fam, 0) + int(start.elapsed_time(end) * 1e6)
    return out
