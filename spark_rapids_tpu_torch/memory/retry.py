"""OOM retry and split — port of ``spark_rapids_tpu/memory/retry.py``
(``classify``, ``RetryPolicy``, ``spill_device_below``, ``halve_by_rows``,
``SplitTracker``, ``with_retry``): the ``RmmRapidsRetryIterator`` analog.

The memory-hungry operator boundaries run their work through
:func:`with_retry`, which classifies what an attempt raised:

* :data:`Classification.OOM` — ``torch.OutOfMemoryError`` (what the
  caching allocator raises when it cannot find memory, and what the
  fault injector raises), :class:`RetryOOM`, and a CUDA error whose
  message says the allocation failed. The retry synchronizes the device
  (``torch.cuda.synchronize``), spills every spillable catalog buffer
  below on-deck priority (:func:`spill_device_below`; their device
  memory goes back to the allocator; the failed attempt's own tensors
  are collected first, :func:`synchronize_device`) and runs the attempt
  again after a capped exponential backoff with deterministic jitter.
  After
  ``spark.rapids.tpu.retry.maxRetries`` it splits the input in half by
  rows (:func:`halve_by_rows`) and runs each half; a site that cannot
  split raises :class:`SplitAndRetryOOM` naming the site. Work never
  moves to the CPU.
* :data:`Classification.TRANSIENT` — helper races and spill-disk
  ``OSError`` s: retried in place with the same backoff, never spilled
  or split.
* :data:`Classification.FATAL` — everything else, among it every other
  CUDA error ("an illegal memory access", a launch failure, a device
  assert): such an error poisons the CUDA context, so it is never
  retried.

The success path adds no synchronization. Metrics, under the wrapping
node's name: ``retryCount``, ``splitAndRetryCount``, ``retryBlockTimeNs``
and ``retryWastedComputeNs``.
"""

from __future__ import annotations

import dataclasses
import gc
import logging
import re
import time
import zlib
from typing import Callable, List, Optional

import torch

from ..metrics import trace as TR
from ..utils import lockdep

_LOG = logging.getLogger(__name__)

#: Serializes the device synchronizations of concurrent OOM recoveries;
#: the spill that follows needs no lock (the catalog reserves each
#: victim once).
_OOM_RECOVERY_LOCK = lockdep.rlock("retry._OOM_RECOVERY_LOCK", io_ok=True)

#: Ceiling on the attempts of one ``with_retry`` call over all its
#: fragments (a runaway fault schedule's backstop).
_MAX_ATTEMPTS_PER_CALL = 256

#: Fewest rows :func:`halve_by_rows` splits.
_MIN_SPLIT_ROWS = 2


class Classification:
    """The error taxonomy's three buckets."""

    OOM = "oom"
    TRANSIENT = "transient"
    FATAL = "fatal"


class RetryOOM(MemoryError):
    """Device memory exhaustion an operator boundary may survive by
    spilling and retrying (the reference's ``RetryOOM``)."""


class SplitAndRetryOOM(RetryOOM):
    """Retries alone could not fit the attempt and its input cannot be
    split further; the message names the site."""

    def __init__(self, site: Optional[str] = None, detail: str = ""):
        self.site = site
        msg = "retries exhausted and the input cannot be split"
        if site:
            msg += f" at retry site '{site}'"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


#: Messages of a failed device allocation. Narrow on purpose: every other
#: CUDA error is fatal.
_OOM_MESSAGE = re.compile(
    r"CUDA out of memory|CUDA error: out of memory|"
    r"cudaErrorMemoryAllocation|CUDA error \d+: out of memory|"
    r"CUBLAS_STATUS_ALLOC_FAILED|RESOURCE_EXHAUSTED")

#: Any other CUDA error: the context may be poisoned, never retry.
_CUDA_ERROR = re.compile(r"CUDA error|CUDA kernel errors|device-side assert"
                         r"|cudaError|CUBLAS_STATUS|CUDNN_STATUS")

#: Transient races: the remote-compile helper's failure modes, and the
#: pipeline pool shut down under a live query (it is made anew at its
#: next use).
_TRANSIENT_MARKERS = ("remote_compile", "tpu_compile_helper",
                      "pool is shut down", "pool shut down while")

#: OSErrors that are deterministic user errors, not I/O flakiness.
_DETERMINISTIC_OS_ERRORS = (FileNotFoundError, PermissionError,
                            FileExistsError, IsADirectoryError,
                            NotADirectoryError)


def classify(exc: BaseException) -> str:
    """The retry taxonomy's bucket of ``exc`` (see the module doc)."""
    from ..utils.deadline import QueryDeadlineExceeded
    if isinstance(exc, QueryDeadlineExceeded):
        # a user contract, not a fault
        return Classification.FATAL
    if isinstance(exc, (RetryOOM, torch.OutOfMemoryError)):
        return Classification.OOM
    from concurrent.futures import CancelledError
    if isinstance(exc, CancelledError):
        return Classification.TRANSIENT
    msg = str(exc)
    if _OOM_MESSAGE.search(msg):
        return Classification.OOM
    if _CUDA_ERROR.search(msg):
        return Classification.FATAL
    if isinstance(exc, OSError) \
            and not isinstance(exc, _DETERMINISTIC_OS_ERRORS):
        return Classification.TRANSIENT
    if any(m in msg for m in _TRANSIENT_MARKERS):
        return Classification.TRANSIENT
    return Classification.FATAL


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry count and backoff shape, from the conf."""

    max_retries: int = 3
    backoff_base_ms: float = 10.0
    backoff_max_ms: float = 1000.0

    @classmethod
    def from_conf(cls, conf) -> "RetryPolicy":
        from ..config import (RETRY_BACKOFF_BASE_MS, RETRY_BACKOFF_MAX_MS,
                              RETRY_MAX_RETRIES)
        if conf is None:
            return cls()
        return cls(int(conf.get(RETRY_MAX_RETRIES)),
                   float(conf.get(RETRY_BACKOFF_BASE_MS)),
                   float(conf.get(RETRY_BACKOFF_MAX_MS)))

    def delay_seconds(self, site: str, attempt: int) -> float:
        """Capped exponential backoff with DETERMINISTIC jitter (a hash of
        site and attempt), so a re-run sleeps identically."""
        if self.backoff_base_ms <= 0:
            return 0.0
        raw = min(self.backoff_base_ms * (2.0 ** attempt),
                  self.backoff_max_ms)
        frac = (zlib.crc32(f"{site}:{attempt}".encode()) % 1000) / 1000.0
        return raw * (0.5 + 0.5 * frac) / 1000.0


def _policy_of(ctx) -> RetryPolicy:
    policy = getattr(ctx, "_retry_policy", None)
    if policy is None:
        policy = RetryPolicy.from_conf(getattr(ctx, "conf", None))
        ctx._retry_policy = policy
    return policy


def synchronize_device(ctx=None, collect: bool = True) -> None:
    """Make a failed attempt's device memory reusable before the retry:
    with ``collect``, collect cyclic garbage first (a traceback through a
    generator leaves the attempt's frames, and the tensors they hold, in
    reference cycles that only the collector frees; an injected fault is
    raised before its attempt starts, so it leaves none), then drain the
    card's queued work (``torch.cuda.synchronize``). A no-op off the
    card."""
    device = getattr(ctx, "device", None)
    if device is not None and torch.device(device).type == "cuda":
        if collect:
            gc.collect()
        with lockdep.blocking("retry.synchronize"):
            torch.cuda.synchronize(device)


def spill_device_below(ctx, priority_ceiling: Optional[int] = None) -> int:
    """Push every unpinned catalog buffer below ``priority_ceiling``
    (default: everything under on-deck priority) off the device, the
    requesting query's own buffers first. Returns the device bytes
    moved."""
    from . import spill as SP
    if priority_ceiling is None:
        priority_ceiling = SP.ACTIVE_ON_DECK_PRIORITY
    catalog = getattr(ctx, "catalog", None)
    if catalog is None:
        return 0
    return catalog.spill_below(priority_ceiling,
                               requester=getattr(ctx, "qos", None))


def backoff_sleep(policy: RetryPolicy, site: str, attempt: int,
                  ctx=None, node: Optional[str] = None) -> None:
    """Sleep this attempt's backoff (bounded by the query deadline, which
    is checked first), its time going to ``retryBlockTimeNs``."""
    delay = policy.delay_seconds(site, attempt)
    deadline = getattr(ctx, "deadline", None)
    if deadline is not None:
        deadline.check(site, ctx, node)
        delay = deadline.bound(delay)
    if delay <= 0:
        return
    t0 = time.perf_counter_ns()
    with TR.span(getattr(ctx, "trace", None), "retry.backoff", cat="retry",
                 site=site, attempt=attempt), \
            lockdep.blocking("retry.backoff_sleep"):
        time.sleep(delay)
    if ctx is not None and node is not None:
        ctx.metric(node, "retryBlockTimeNs", time.perf_counter_ns() - t0)


def halve_by_rows(batch):
    """The batch's live rows as two batches, the first half and the rest
    (``splitSpillableInHalfByRows``). Raises :class:`SplitAndRetryOOM`
    under two rows."""
    from ..exec.external_sort import slice_rows
    from ..ops.kernels import rowops as KR
    batch = KR.physical(batch)
    n = int(batch.n_rows)
    if n < _MIN_SPLIT_ROWS:
        raise SplitAndRetryOOM(detail=f"a {n}-row batch cannot be halved")
    k = n // 2
    return [slice_rows(batch, 0, k), slice_rows(batch, k, n - k)]


class SplitTracker:
    """A split function that remembers whether it ran."""

    def __init__(self, split: Callable):
        self._split = split
        self.split_happened = False

    def __call__(self, item):
        self.split_happened = True
        return self._split(item)


def with_retry(ctx, site: str, inputs, attempt: Callable,
               split: Optional[Callable] = None,
               node: Optional[str] = None) -> List:
    """Run ``attempt(inputs)``, surviving classified OOM and transient
    faults (``withRetry`` / ``withRetryNoSplit``). Returns the results:
    one normally, one a fragment after a split (each fragment has a fresh
    retry budget). ``split=None`` marks the site unsplittable. ``node``
    keys the metrics (default: the site up to its first dot)."""
    if node is None:
        node = site.split(".", 1)[0]
    from ..utils.fault_injection import InjectedFault, register_site
    register_site(site)
    injector = getattr(ctx, "fault_injector", None)
    deadline = getattr(ctx, "deadline", None)
    policy = _policy_of(ctx)
    work: List = [inputs]
    results: List = []
    attempts_total = 0
    while work:
        item = work.pop(0)
        retries = 0
        while True:
            attempts_total += 1
            if attempts_total > _MAX_ATTEMPTS_PER_CALL:
                raise RetryOOM(
                    f"retry site '{site}' exceeded {_MAX_ATTEMPTS_PER_CALL} "
                    "attempts (runaway fault schedule or unrecoverable "
                    "memory pressure)")
            t0 = time.perf_counter_ns()
            try:
                if deadline is not None:
                    deadline.check(site, ctx, node)
                if injector is not None:
                    injector.check(site)
                results.append(attempt(item))
                break
            except Exception as e:  # noqa: BLE001 - classified below
                cls = classify(e)
                if cls == Classification.FATAL or (
                        cls == Classification.TRANSIENT
                        and retries >= policy.max_retries):
                    raise
                ctx.metric(node, "retryWastedComputeNs",
                           time.perf_counter_ns() - t0)
                detail = str(e)
                real = not isinstance(e, InjectedFault)
            # Recovery runs after the except block: the exception's
            # traceback holds the failed attempt's frames, and with them
            # its tensors, until the block exits.
            if cls == Classification.OOM:
                with TR.span(getattr(ctx, "trace", None),
                             "retry.oom_recovery", cat="retry", site=site):
                    with _OOM_RECOVERY_LOCK:
                        synchronize_device(ctx, collect=real)
                    spill_device_below(ctx)
                if retries >= policy.max_retries:
                    if split is None:
                        raise SplitAndRetryOOM(site, detail)
                    try:
                        halves = split(item)
                    except SplitAndRetryOOM as se:
                        raise SplitAndRetryOOM(site, str(se)) from se
                    except Exception as se:  # noqa: BLE001
                        if classify(se) == Classification.OOM:
                            raise SplitAndRetryOOM(
                                site, f"splitting itself hit OOM: {se}"
                            ) from se
                        raise
                    _LOG.info("retry site %s: splitting input after %d OOM "
                              "retries", site, retries)
                    ctx.metric(node, "splitAndRetryCount", 1)
                    work[:0] = halves
                    break
            ctx.metric(node, "retryCount", 1)
            backoff_sleep(policy, site, retries, ctx, node)
            retries += 1
    return results
