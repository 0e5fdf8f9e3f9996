"""Process-lifetime cache of built device callables — port of
``spark_rapids_tpu/utils/kernel_cache.py``.

The reference keeps one ``jax.jit`` wrapper alive per (operator kind,
structural signature), so re-running a query never re-traces. The port
has no jit: :func:`cached_kernel` keeps the callable a builder returns
per structural key (counting hits, misses and the build's host time),
and :func:`plan_signature` is the structural key of a physical plan —
node types and static parameters (expressions, schemas, goals), not
input shapes. The fused path (:mod:`..exec.fusion`) keys its programs by
it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Dict

import numpy as np
import torch

from ..types import Schema, StructField
from . import lockdep

#: Frozen dataclasses whose signature is kept on the instance.
_MEMO_TYPES = (Schema, StructField)

_CACHE: Dict[tuple, Callable] = {}
_LOCK = lockdep.lock("kernel_cache._LOCK")
#: build_ns: host time spent building callables on cache misses.
_STATS = {"hits": 0, "misses": 0, "build_ns": 0}


def kernel_key(*parts) -> tuple:
    """A hashable structural signature of expressions, schemas, dtypes,
    dataclasses, and plain containers and primitives."""
    return tuple(_sig_value(p) for p in parts)


_EXPRESSION: list = []
#: Schema or field -> its signature, by value (bounded: cleared when
#: full).
_SIG_MEMO: dict = {}
_SIG_MEMO_MAX = 1 << 14
_PLAIN = frozenset({type(None), bool, int, float, str, bytes})


def _expression_class():
    # late import: the expressions import the data layer, which must not
    # import this module at load
    if not _EXPRESSION:
        from ..ops.expression import Expression
        _EXPRESSION.append(Expression)
    return _EXPRESSION[0]


def _sig_value(v) -> tuple:
    if type(v) in _PLAIN:
        return (type(v).__name__, v)
    if isinstance(v, _expression_class()):
        return _expr_signature(v)
    if isinstance(v, _MEMO_TYPES):
        # schemas and their fields are frozen, and equal ones recur in
        # every node of a plan and in every run: each is walked once
        # (they make most of a plan signature's work otherwise)
        sig = _SIG_MEMO.get(v)
        if sig is None:
            sig = (type(v).__qualname__,) + tuple(
                (f.name, _sig_value(getattr(v, f.name)))
                for f in dataclasses.fields(v))
            if len(_SIG_MEMO) >= _SIG_MEMO_MAX:
                _SIG_MEMO.clear()
            _SIG_MEMO[v] = sig
        return sig
    if isinstance(v, (list, tuple)):
        return ("seq",) + tuple(_sig_value(x) for x in v)
    if isinstance(v, (bool, int, float, str, bytes)):
        return (type(v).__name__, v)
    if isinstance(v, frozenset):
        return ("fset",) + tuple(sorted(map(_sig_value, v)))
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__qualname__,) + tuple(
            (f.name, _sig_value(getattr(v, f.name)))
            for f in dataclasses.fields(v))
    if isinstance(v, dict):
        return ("dict",) + tuple(
            (k, _sig_value(x)) for k, x in sorted(v.items()))
    if isinstance(v, np.ndarray):
        # by content: numpy truncates the repr of a large array
        data = tuple(v.tolist()) if v.dtype == object else \
            hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()
        return ("nd", v.dtype.str, v.shape, data)
    if isinstance(v, torch.Tensor):
        return ("tensor", id(v))  # data, never structure: by identity
    if hasattr(v, "__dict__") and not isinstance(v, type):
        # a plain object by its attributes: its default repr would hold
        # its address, which differs between two equal plans
        return ("obj", type(v).__qualname__) + tuple(sorted(
            (k, _sig_value(x)) for k, x in vars(v).items()))
    return ("repr", type(v).__qualname__, repr(v))


def _expr_signature(e) -> tuple:
    extras = tuple(
        (k, _sig_value(v)) for k, v in sorted(e.__dict__.items())
        if k != "children")
    return ("expr", type(e).__qualname__, extras,
            tuple(_expr_signature(c) for c in e.children))


#: Exec attributes that are per-instance data, not structure. A device
#: source's batch is data: the fused path sees it as a boundary input.
PLAN_SIG_SKIP_ATTRS = frozenset({"children", "partitions", "batch"})


def plan_signature(p) -> tuple:
    """Structural signature of a physical plan: node types and static
    parameters, not input shapes (the fused program keys those itself,
    :func:`..compile.executables.aval_signature`)."""
    extras = tuple(sorted(
        (k, _sig_value(v)) for k, v in vars(p).items()
        if k not in PLAN_SIG_SKIP_ATTRS))
    return (type(p).__name__, extras,
            tuple(plan_signature(c) for c in p.children))


def cached_kernel(kind: str, key: tuple, builder: Callable[[], Callable]
                  ) -> Callable:
    """The process-wide callable for ``(kind, key)``, built by
    ``builder()`` on first use."""
    k = (kind, key)
    with _LOCK:
        fn = _CACHE.get(k)
        if fn is not None:
            _STATS["hits"] += 1
            return fn
    t0 = time.perf_counter_ns()
    built = builder()
    build_ns = time.perf_counter_ns() - t0
    with _LOCK:
        fn = _CACHE.setdefault(k, built)
        if fn is built:
            _STATS["misses"] += 1
            _STATS["build_ns"] += build_ns
        else:
            _STATS["hits"] += 1
    return fn


def cache_stats() -> dict:
    with _LOCK:
        return dict(_STATS, entries=len(_CACHE))


def clear_cache() -> None:
    with _LOCK:
        _CACHE.clear()
        _STATS["hits"] = _STATS["misses"] = _STATS["build_ns"] = 0
