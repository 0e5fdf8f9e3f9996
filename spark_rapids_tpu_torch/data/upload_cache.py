"""Upload cache — port of ``spark_rapids_tpu/data/upload_cache.py``
(``set_budget``, ``lookup``, ``insert``, ``shrink_by``, ``clear``,
``cache_bytes``).

An upload (:meth:`..data.batch.HostBatch.to_device`) that sees the same
host column again serves the device column it made the first time: a
re-created DataFrame over the same host tables, a benchmark loop. The
reference keys pyarrow buffers, which are immutable. numpy arrays are
not, so the port keys a column only when its values and validity arrays
are read-only down their whole ``base`` chain (:func:`frozen`; a
writable base could still change them): such an array cannot be written
to while the cache holds it, so its address identifies its content. A
writable array is never cached (:meth:`HostBatch.freeze` makes a batch's
arrays read-only). Each entry keeps a strong reference to its arrays,
so an address is not reused while it is cached.

Eviction is LRU under ``spark.rapids.tpu.uploadCache.maxBytes`` of
device bytes. The spill catalog counts the cache's bytes against its
device budget and evicts from it first (``BufferCatalog.
enforce_budgets``); the OOM drain empties it
(:func:`..memory.retry.spill_device_below`).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np

from ..utils import lockdep

#: byte budget for cached device columns (set from the conf by the
#: session, :func:`..compile.configure`)
_budget_bytes = 1 << 30
_lock = lockdep.lock("upload_cache._lock")
_entries: "OrderedDict[tuple, tuple]" = OrderedDict()  # key -> (col, refs, nb)
_bytes = 0
stats = {"hits": 0, "misses": 0, "evictions": 0}


def set_budget(n_bytes: int) -> None:
    global _budget_bytes
    with _lock:
        _budget_bytes = int(n_bytes)
    _trim()


def frozen(arr: np.ndarray) -> bool:
    """Whether ``arr`` and every array it views are read-only."""
    a = arr
    while isinstance(a, np.ndarray):
        if a.flags.writeable:
            return False
        a = a.base
    return a is None or isinstance(a, bytes)


def _key(values: np.ndarray, validity: np.ndarray, dtype, capacity: int,
         device) -> Optional[tuple]:
    if not (frozen(values) and frozen(validity)):
        return None
    return (repr(dtype), capacity, str(device),
            tuple((a.__array_interface__["data"][0], a.shape, a.strides,
                   a.dtype.str) for a in (values, validity)))


def lookup(values: np.ndarray, validity: np.ndarray, dtype, capacity: int,
           device):
    """The cached device column of this host column, or None."""
    if _budget_bytes <= 0:
        return None
    k = _key(values, validity, dtype, capacity, device)
    if k is None:
        return None
    with _lock:
        ent = _entries.get(k)
        if ent is None:
            stats["misses"] += 1
            return None
        _entries.move_to_end(k)
        stats["hits"] += 1
        return ent[0]


def column_bytes(col) -> int:
    """Device bytes of a column's lanes (the dictionary's device bytes
    included)."""
    total = 0
    for t in (col.data, col.validity, col.codes, col.offsets,
              col.elem_validity, col.lengths):
        if t is not None:
            total += t.numel() * t.element_size()
    if col.dict_bytes is not None:
        total += sum(t.numel() * t.element_size() for t in col.dict_bytes)
    return total + sum(column_bytes(k) for k in col.children)


def insert(values: np.ndarray, validity: np.ndarray, dtype, capacity: int,
           device, col) -> None:
    global _bytes
    if _budget_bytes <= 0:
        return
    k = _key(values, validity, dtype, capacity, device)
    if k is None:
        return
    nb = column_bytes(col)
    if nb > _budget_bytes:
        return
    with _lock:
        if k in _entries:
            return
        # the strong references pin the arrays' addresses
        _entries[k] = (col, (values, validity), nb)
        _bytes += nb
    _trim()


def _trim() -> None:
    global _bytes
    with _lock:
        while _bytes > _budget_bytes and _entries:
            _, (_, _, nb) = _entries.popitem(last=False)
            _bytes -= nb
            stats["evictions"] += 1


def shrink_by(n_bytes: int) -> int:
    """Evict least recently used entries until ``n_bytes`` are freed (or
    the cache is empty); returns the bytes freed."""
    global _bytes
    freed = 0
    with _lock:
        while freed < n_bytes and _entries:
            _, (_, _, nb) = _entries.popitem(last=False)
            _bytes -= nb
            freed += nb
            stats["evictions"] += 1
    return freed


def clear() -> None:
    global _bytes
    with _lock:
        _entries.clear()
        _bytes = 0


def cache_bytes() -> int:
    return _bytes
