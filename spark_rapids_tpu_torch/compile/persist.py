"""The compile manifest — port of ``spark_rapids_tpu/compile/persist.py``.

The reference keeps two things across processes: XLA executables (the
JAX persistent cache) and a manifest of what each plan shape ran with.
A CUDA graph cannot be kept: its key names every resident table by its
device address (:func:`.executables.aval_signature`), which no later
process shares. So the port keeps the manifest only, and holds in it,
per process-stable plan hash (:func:`plan_hash` of the session's
``(tree_string, mesh)`` signature), the **learned state** in place of
executables: the dense mode of each site that escalated (the session's
``_learned``) and the exact capacity of each inlined join that
overflowed (``_join_caps``). A new process that finds its plan here runs
it in its final modes from the first attempt, where the process that
learned them took two or three. The reference's capacity vectors are not
kept: it maps them onto padded capacity tiers, and the port pads to none.

The manifest is ``torch_compile_manifest.json`` in
``spark.rapids.tpu.compileCache.dir``; a session whose conf sets
``spark.rapids.tpu.compileCache.enabled`` holds it (:func:`configure`).
The keys are a session's own: a session that leaves them off gets no
manifest and changes nothing for the others, and sessions that name one
directory share one :class:`CompileManifest`. Writes are atomic (a
temporary file, then a rename) under a lock that exists to serialise
that I/O. A corrupt file loads empty, with the reason in
:meth:`CompileManifest.status`, and the next write replaces it; a
directory that cannot be made or written turns that manifest off with
the reason. Nothing here fails a query. The reference's
``minCompileSecs``, split levels and ``JAX_ENABLE_COMPILATION_CACHE``
switch belong to XLA and its compile budget and have no counterpart.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional, Tuple

from ..utils import lockdep

#: Guards :data:`_OPEN`; held while a directory is made and a manifest
#: first read (I/O, which is what it serialises).
_LOCK = lockdep.lock("persist._LOCK", io_ok=True)
#: manifest path -> the manifest every session naming it shares
_OPEN: Dict[str, "CompileManifest"] = {}

#: Plans the manifest holds at most, so it stays a small index and not a
#: log (the oldest goes first).
_MAX_PLANS = 256

MANIFEST_NAME = "torch_compile_manifest.json"

#: The status of a session whose conf leaves the manifest off.
OFF = {"enabled": False, "reason": "disabled by conf"}


def default_cache_dir() -> str:
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "spark_rapids_tpu_torch")


def configure(conf) -> Optional["CompileManifest"]:
    """The manifest a session's conf asks for, or None when
    ``compileCache.enabled`` is off. Sessions naming one directory share
    one manifest; a directory that cannot be made gives a manifest that
    is off, with the reason in its :meth:`~CompileManifest.status`."""
    from ..config import COMPILE_CACHE_DIR, COMPILE_CACHE_ENABLED
    if not conf.get(COMPILE_CACHE_ENABLED):
        return None
    cache_dir = conf.get(COMPILE_CACHE_DIR) or default_cache_dir()
    path = os.path.join(cache_dir, MANIFEST_NAME)
    with _LOCK:
        m = _OPEN.get(path)
        if m is not None:
            return m
        try:
            os.makedirs(cache_dir, exist_ok=True)
        except OSError as e:
            # not kept: a later session may find the directory makeable
            return CompileManifest(path, off=f"cannot create {cache_dir}: "
                                             f"{e}")
        m = _OPEN[path] = CompileManifest(path)
        return m


def status(m: Optional["CompileManifest"]) -> Dict[str, object]:
    """A session's manifest's :meth:`~CompileManifest.status`, or
    :data:`OFF` when it has none."""
    return dict(OFF) if m is None else m.status()


def plan_hash(plan_sig: tuple) -> str:
    """A short hash of a plan signature built of strings, numbers and
    tuples of them, the same in every process."""
    return hashlib.sha256(repr(plan_sig).encode()).hexdigest()[:16]


def _int_map(d) -> Dict[int, int]:
    return {int(k): int(v) for k, v in dict(d).items()}


class CompileManifest:
    """A small crash-safe index: plan hash -> the dense modes and join
    capacities it learned. Writes are atomic; a corrupt or missing file
    loads empty (``load_error`` says why a file that was there did not
    load). A manifest that is off (``off``: why) serves and keeps
    nothing."""

    def __init__(self, path: str, off: str = ""):
        self.path = path
        self._lock = lockdep.lock("CompileManifest._lock", io_ok=True)
        #: plan hash -> (site -> dense mode, join site -> capacity)
        self._learned: Dict[str, Tuple[Dict[int, int], Dict[int, int]]] = {}
        self._off = off
        self.load_error = ""
        self._bytes = 0
        if not off:
            self._load()

    def _load(self) -> None:
        try:
            with open(self.path, encoding="utf-8") as f:
                raw = f.read()
        except FileNotFoundError:
            return
        except OSError as e:
            self.load_error = repr(e)
            return
        try:
            data = json.loads(raw)
            learned = {str(h): (_int_map(e.get("modes", {})),
                                _int_map(e.get("join_caps", {})))
                       for h, e in data.get("learned", {}).items()}
        except (ValueError, TypeError, AttributeError) as e:
            self.load_error = repr(e)
            return
        self._learned = learned
        self._bytes = len(raw.encode())

    def learned_for(self, plan_hash_: str
                    ) -> Optional[Tuple[Dict[int, int], Dict[int, int]]]:
        """``(dense modes by site, capacities by inlined join site)`` an
        earlier run of the plan learned, or None."""
        with self._lock:
            got = None if self._off else self._learned.get(plan_hash_)
            return None if got is None else (dict(got[0]), dict(got[1]))

    def record_learned(self, plan_hash_: str, modes: Dict[int, int],
                       join_caps: Dict[int, int]) -> bool:
        """Remember what a plan learned (only its escalated sites and its
        learned capacities). Returns True (and flushes) when that
        changed what the manifest held."""
        entry = ({int(s): int(m) for s, m in modes.items() if m},
                 {int(s): int(c) for s, c in join_caps.items()})
        with self._lock:
            old = self._learned.get(plan_hash_)
            if self._off or old == entry or \
                    (old is None and entry == ({}, {})):
                return False
            self._learned[plan_hash_] = entry
            while len(self._learned) > _MAX_PLANS:
                self._learned.pop(next(iter(self._learned)))
            self._flush_locked()
            return True

    def status(self) -> Dict[str, object]:
        """``{"enabled", "reason", "dir", "path", "plans", "bytes"}``:
        whether the manifest is on (``reason``: why not, or why it
        started empty), its file, the plans it holds and the file's size
        as last read or written."""
        with self._lock:
            reason = self._off or (
                f"manifest unreadable ({self.load_error}); started empty"
                if self.load_error else "")
            return {"enabled": not self._off, "reason": reason,
                    "dir": os.path.dirname(self.path), "path": self.path,
                    "plans": len(self._learned), "bytes": self._bytes}

    def _flush_locked(self) -> None:
        data = {
            "comment": "Compile manifest of spark_rapids_tpu_torch: per "
                       "plan hash, the dense modes and join capacities it "
                       "learned; a new process replays them "
                       "(compile/persist.py).",
            "learned": {h: {"modes": {str(s): m for s, m in modes.items()},
                            "join_caps": {str(s): c
                                          for s, c in caps.items()}}
                        for h, (modes, caps) in self._learned.items()},
        }
        text = json.dumps(data, indent=1)
        tmp = f"{self.path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(text)
            os.replace(tmp, self.path)
        except OSError as e:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            # the manifest saves attempts; it never fails the query
            self._off = f"cannot write {self.path}: {e}"
            return
        self._bytes = len(text.encode())


def reset_for_tests() -> None:
    """Forget every open manifest (the files stay)."""
    with _LOCK:
        _OPEN.clear()
