"""Spillable buffers: device -> host -> disk — port of
``spark_rapids_tpu/memory/spill.py`` (``BufferCatalog``, ``SpillFile``,
``QosTag``, the priorities), the ``RapidsBufferCatalog`` analog.

Every registered batch is a state machine

    DEVICE -> SPILLING -> HOST / DISK -> RESTORING -> DEVICE

and the catalog lock is held only to reserve a transition (pick victims,
mark their state) and to publish its result (install the copy, update
the byte accounting, wake waiters). The copies themselves run off the
lock, on the spill-IO lane of the shared pipeline pool
(:func:`..exec.pipeline.submit_spill_io`, ``spark.rapids.tpu.spill.
ioThreads`` wide), so a spill never stalls threads that touch other
buffers, and a reader of a buffer in flight waits on that buffer's own
condition, which releases the catalog lock.

The tiers, in PyTorch's idiom:

* device -> host: the batch's live rows (a lazy batch moved to the front
  first), each lane copied straight into its range of one pinned host
  tensor (:func:`..data.batch.download_columns`: no device staging
  buffer, since a spill runs when the card is out of memory), on a side
  CUDA stream ordered after the current one and waited on; the host
  tier holds the
  :class:`~..data.batch.HostColumn` views of that tensor. Never a
  pageable copy.
* host -> disk: the columns serialized by the shuffle's own
  :func:`~..shuffle.serializer.serialize_block` (every layout the port
  has: fixed, dictionary, flat, array, struct) and appended to one
  :class:`SpillFile` with a CRC32C (:mod:`..utils.checksum`; the C++
  routine for a card's catalog) checked on every read.
* back to the device: the disk range read into a pinned buffer,
  deserialized in place, and uploaded at the batch's own capacity
  (:func:`~..data.batch.upload_columns`). The restored batch holds the
  same rows, bit for bit, as a physical batch.

The device store keeps a byte budget (``spark.rapids.memory.tpu.
spillBudgetBytes``, else ``allocFraction`` of the card's memory): a
registration that would pass it spills lower-priority buffers first, in
QoS order (:meth:`BufferCatalog._victim_key`); the host tier's budget
(``spark.rapids.memory.host.spillStorageSize``) cascades to disk. The
OOM retry (:mod:`.retry`) drains everything below on-deck priority with
:meth:`BufferCatalog.spill_below`. The serving layer's tenant budgets
are not ported.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import types as T
from ..data.batch import ColumnarBatch, download_columns, upload_columns
from ..utils import lockdep
from ..utils.tracing import trace_range

_LOG = logging.getLogger(__name__)

# Spill priorities (SpillPriorities.scala:26): LOWER values spill FIRST.
#: Shuffle outputs spill before anything else.
OUTPUT_FOR_SHUFFLE_PRIORITY = -10_000_000
#: Buffers parked by operators between batches (accumulations, runs).
ACTIVE_BATCHING_PRIORITY = 0
#: Buffers an operator is actively using; the OOM drain leaves them.
ACTIVE_ON_DECK_PRIORITY = 10_000_000


class StorageTier:
    DEVICE = "device"
    HOST = "host"
    DISK = "disk"
    #: a device->host or host->disk copy is in flight on the IO lane
    SPILLING = "spilling"
    #: a host/disk->device restore is in flight
    RESTORING = "restoring"


TRANSITIONAL_TIERS = (StorageTier.SPILLING, StorageTier.RESTORING)


@dataclasses.dataclass
class QosTag:
    """Identity of one executing query for victim selection: the tenant
    and the query's deadline (None without one); one per query, so "own
    buffer" means "same query"."""

    tenant: str = ""
    deadline: object = None
    #: the query's span tracer (spill-IO spans land in its trace)
    trace: object = None

    def slack(self) -> float:
        """Seconds of deadline headroom; +inf without a deadline."""
        if self.deadline is None:
            return math.inf
        return float(self.deadline.remaining())


def device_size_bytes(batch: ColumnarBatch) -> int:
    """Device bytes a spill of the batch frees: every lane of every
    column (a child's too) and the live mask. A dictionary column's entry
    bytes are left out: its columns share them, and a restore uploads
    them anew. It runs at every registration, so it reads only each
    tensor's ``nbytes``."""
    total = 0 if batch.live is None else batch.live.nbytes
    stack = list(batch.columns)
    while stack:
        c = stack.pop()
        for t in (c.data, c.validity, c.codes, c.offsets, c.elem_validity,
                  c.lengths):
            if t is not None:
                total += t.nbytes
        stack.extend(c.children)
    return total


@dataclasses.dataclass
class TableMeta:
    """What restores a batch on its device (MetaUtils' TableMeta)."""

    schema: T.Schema
    capacity: int
    size_bytes: int
    device: torch.device


@dataclasses.dataclass
class HostPayload:
    """A spilled batch in host memory: its live rows as host columns
    (views of one pinned buffer on the card)."""

    columns: list


@dataclasses.dataclass
class _Entry:
    buffer_id: int
    priority: int
    meta: TableMeta
    tier: str
    device_batch: Optional[ColumnarBatch] = None
    host_batch: Optional[HostPayload] = None
    disk_range: Optional[Tuple[int, int]] = None  # (offset, length)
    freed: bool = False
    owner: Optional[QosTag] = None
    #: the settled tier a SPILLING/RESTORING transition left from
    moving_from: str = ""
    #: wait channel for in-flight transitions (over the catalog lock)
    cond: object = None
    #: the catalog's compaction generation when a RESTORING entry was
    #: freed: the restore worker frees its disk range only if no
    #: compaction moved it since
    freed_gen: int = -1


#: Compact the shared spill file once this fraction of it is dead.
DISK_COMPACT_FRACTION = 0.5


class SpillFileClosedError(RuntimeError):
    """A SpillFile operation raced ``close()``: the file is gone."""


def _pinned_buffer(n: int, device: torch.device) -> np.ndarray:
    """A writable uint8 host buffer of ``n`` bytes: pinned for a card's
    catalog, so the restore's upload is a DMA."""
    if device.type == "cuda":
        return torch.empty(n, dtype=torch.uint8, pin_memory=True).numpy()
    return np.empty(n, np.uint8)


class SpillFile:
    """The shared spill file (the disk block manager's file): appends
    payloads with their CRC32C, verifies it on every read, tracks freed
    ranges and rewrites itself without them when its owner asks.
    Every operation is atomic under the file's own ``io_ok`` lock;
    range staleness across a :meth:`compact` is the owner's to handle.
    ``device`` picks the CRC implementation (:mod:`..utils.checksum`)."""

    def __init__(self, spill_dir: Optional[str] = None, verify: bool = True,
                 device="cpu"):
        self._owns_dir = spill_dir is None
        self.dir = spill_dir or tempfile.mkdtemp(prefix="torch_spill_")
        os.makedirs(self.dir, exist_ok=True)
        fd, self.path = tempfile.mkstemp(prefix="spill_", suffix=".bin",
                                         dir=self.dir)
        os.close(fd)
        self.device = torch.device(device)
        self._offset = 0
        self._freed = 0
        #: offset -> (length, crc32c) of every live range
        self._crcs: Dict[int, Tuple[int, int]] = {}
        self.verify = verify
        self._closed = False
        self._lock = lockdep.lock("SpillFile._lock", io_ok=True)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            try:
                os.remove(self.path)
            except OSError:
                pass
        if self._owns_dir:
            shutil.rmtree(self.dir, ignore_errors=True)

    def append(self, payload) -> Tuple[int, int]:
        from ..utils import checksum as CK
        crc = CK.crc32c(payload, device=self.device)
        n = memoryview(payload).nbytes
        with self._lock:
            if self._closed:
                raise SpillFileClosedError(self.path)
            offset = self._offset
            with open(self.path, "ab") as f:
                f.write(memoryview(payload).cast("B"))
            self._offset += n
            self._crcs[offset] = (n, crc)
            return offset, n

    def read_with_crc(self, offset: int, length: int
                      ) -> Tuple[np.ndarray, Optional[int]]:
        """(payload in a fresh host buffer, recorded crc32c or None when
        the range has none or verification is off), unverified."""
        out = _pinned_buffer(length, self.device)
        with self._lock:
            if self._closed:
                raise SpillFileClosedError(self.path)
            with open(self.path, "rb", buffering=0) as f:
                f.seek(offset)
                got = f.readinto(memoryview(out))
            rec = self._crcs.get(offset)
        if got != length:
            raise OSError(f"short read of spill range [{offset}:"
                          f"{offset + length}) of {self.path}: {got} bytes")
        if self.verify and rec is not None and rec[0] == length:
            return out, rec[1]
        return out, None

    def read(self, offset: int, length: int, ctx=None,
             node: Optional[str] = None) -> np.ndarray:
        """The range's bytes, its CRC32C verified off the lock (a
        mismatch raises :class:`~..utils.checksum.ChecksumError`)."""
        from ..utils import checksum as CK
        payload, crc = self.read_with_crc(offset, length)
        if crc is not None:
            CK.verify(payload, crc, f"spill range [{offset}:"
                      f"{offset + length}) of {self.path}", ctx, node,
                      device=self.device)
        return payload

    @property
    def size_bytes(self) -> int:
        with self._lock:
            return self._offset

    @property
    def freed_bytes(self) -> int:
        with self._lock:
            return self._freed

    @property
    def live_bytes(self) -> int:
        with self._lock:
            return self._offset - self._freed

    def free_range(self, offset: int, length: int) -> None:
        """Mark ``[offset, offset + length)`` dead; reclaimed at the next
        :meth:`compact`."""
        with self._lock:
            self._freed += length
            rec = self._crcs.get(offset)
            if rec is not None and rec[0] == length:
                del self._crcs[offset]

    def freed_fraction(self) -> float:
        with self._lock:
            return self._freed / self._offset if self._offset else 0.0

    def compact(self, live_ranges: Dict) -> Dict:
        """Rewrite the file keeping only ``live_ranges`` (``{key: (offset,
        length)}``), verifying each range as it moves; returns the keys'
        new ranges."""
        from ..utils import checksum as CK
        with self._lock:
            if self._closed:
                raise SpillFileClosedError(self.path)
            fd, tmp = tempfile.mkstemp(prefix="spill_compact_",
                                       suffix=".bin", dir=self.dir)
            try:
                new_ranges: Dict = {}
                new_crcs: Dict[int, Tuple[int, int]] = {}
                pos = 0
                with os.fdopen(fd, "wb") as out, \
                        open(self.path, "rb") as src:
                    for key, (offset, length) in sorted(
                            live_ranges.items(), key=lambda kv: kv[1][0]):
                        src.seek(offset)
                        payload = src.read(length)
                        rec = self._crcs.get(offset)
                        if rec is not None and rec[0] == length:
                            if self.verify:
                                CK.verify(payload, rec[1],
                                          f"spill range [{offset}:"
                                          f"{offset + length}) of "
                                          f"{self.path} during compaction",
                                          device=self.device)
                            new_crcs[pos] = (length, rec[1])
                        else:
                            new_crcs[pos] = (length, CK.crc32c(
                                payload, device=self.device))
                        out.write(payload)
                        new_ranges[key] = (pos, length)
                        pos += length
                os.replace(tmp, self.path)
            except BaseException:
                # a failed rewrite must not leak its temporary file
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            self._offset = pos
            self._freed = 0
            self._crcs = new_crcs
            return new_ranges


def _side_stream(device: torch.device):
    """One side stream per card for the device->host copies."""
    with _STREAMS_LOCK:
        s = _STREAMS.get(device.index)
        if s is None:
            s = _STREAMS[device.index] = torch.cuda.Stream(device)
        return s


_STREAMS: Dict[Optional[int], object] = {}
_STREAMS_LOCK = lockdep.lock("spill._STREAMS_LOCK")


def to_host(batch: ColumnarBatch) -> HostPayload:
    """The batch's live rows in host memory, every lane copied straight
    into its range of one host buffer (no device staging buffer: a spill
    must not need device memory); on the card into pinned memory, on a
    side stream ordered after the current one (the download waits on
    it)."""
    from ..ops.kernels import rowops as KR
    batch = KR.physical(batch)
    n = int(batch.n_rows)
    dev = batch.device
    if dev.type != "cuda":
        cols, _ = download_columns(batch, n)
        return HostPayload(cols)
    side = _side_stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        cols, _ = download_columns(batch, n)
    return HostPayload(cols)


def to_device(host: HostPayload, meta: TableMeta) -> ColumnarBatch:
    """A host payload back on its device at its own capacity."""
    return upload_columns(host.columns, meta.schema, meta.device,
                          capacity=meta.capacity)


def serialize_host(host: HostPayload, schema: T.Schema) -> np.ndarray:
    from ..shuffle.serializer import serialize_block
    return serialize_block(host.columns, schema)


def deserialize_host(payload) -> HostPayload:
    from ..shuffle.serializer import deserialize_block
    _, cols = deserialize_block(payload)
    return HostPayload(cols)


#: wait tick of transition and compaction waiters (workers always
#: notify; the timeout only guards a worker dying mid-publish)
_WAIT_TICK_S = 1.0
#: how long close() waits for in-flight spill IO
_CLOSE_DRAIN_DEADLINE_S = 10.0


class BufferCatalog:
    """id -> tiered buffer, with budget-driven spill through the state
    machine of the module doc. ``register_batch`` returns with the budget
    met and ``spill_below`` with the bytes moved, as the reference's
    synchronous contract says, but the waiting happens with the catalog
    lock released and the copies overlapped on the IO lane."""

    def __init__(self, device_budget_bytes, host_budget_bytes: int,
                 spill_dir: Optional[str] = None, io_threads: int = 2,
                 device="cpu"):
        #: int, or a 0-argument callable resolved at the first budget
        #: check (the device manager's fraction of the card's memory)
        self._device_budget = device_budget_bytes
        self.host_budget = int(host_budget_bytes)
        self.device = torch.device(device)
        self._entries: Dict[int, _Entry] = {}
        self.device_bytes = 0
        self.host_bytes = 0
        #: bytes reserved by copies in flight (still counted above)
        self._spilling_device_bytes = 0
        self._spilling_host_bytes = 0
        self._next_id = 0
        self._lock = lockdep.rlock("BufferCatalog._lock")
        self._state_cond = lockdep.condition_on(self._lock)
        self._compacting = False
        self._closed = False
        #: disk appends in flight: a compaction now would miss them
        self._disk_appends = 0
        #: bumped by each compaction (stale-offset guard)
        self._compact_gen = 0
        self._spill_dir = spill_dir
        self._spill_file: Optional[SpillFile] = None
        self._pinned: set = set()
        self._io_threads = max(0, int(io_threads))
        self._io_slots = threading.BoundedSemaphore(self._io_threads) \
            if self._io_threads > 0 else None
        self._io_pending = 0
        self._io_running = 0
        self.metrics = {"spilled_to_host": 0, "spilled_to_disk": 0,
                        "reloaded_from_host": 0, "reloaded_from_disk": 0,
                        "spill_bytes_to_host": 0, "spill_bytes_to_disk": 0,
                        "disk_spill_file_bytes": 0,
                        "disk_spill_file_compactions": 0,
                        # wall ns and bytes of each transition
                        "device_to_host_ns": 0, "device_to_host_bytes": 0,
                        "host_to_disk_ns": 0, "host_to_disk_bytes": 0,
                        "disk_to_device_ns": 0, "disk_to_device_bytes": 0,
                        "host_to_device_ns": 0, "host_to_device_bytes": 0,
                        "spill_io_ns": 0, "spill_io_bytes": 0,
                        "spill_queue_peak": 0, "spill_concurrent_peak": 0,
                        "spill_lock_wait_ns": 0}

    @property
    def device_budget(self) -> int:
        b = self._device_budget
        if callable(b):
            val = b()
            with self._lock:
                if self._device_budget is b:
                    self._device_budget = val
                b = self._device_budget
            if callable(b):
                b = val
        return b

    def _disk(self) -> SpillFile:
        f = self._spill_file
        if f is None:
            with self._lock:
                if self._closed:
                    raise SpillFileClosedError("spill catalog is closed")
                if self._spill_file is None:
                    self._spill_file = SpillFile(self._spill_dir,
                                                 device=self.device)
                f = self._spill_file
        return f

    def _note_lock_wait(self, t0_ns: int) -> None:
        self.metrics["spill_lock_wait_ns"] += time.perf_counter_ns() - t0_ns

    def _entry_cond(self, entry: _Entry):
        if entry.cond is None:
            entry.cond = lockdep.condition_on(self._lock)
        return entry.cond

    def _count(self, name: str, ns: int, nbytes: int) -> None:
        """Add one transition's time and bytes (caller holds the lock)."""
        self.metrics[name + "_ns"] += ns
        self.metrics[name + "_bytes"] += nbytes

    # -- registration ---------------------------------------------------------
    def register_batch(self, batch: ColumnarBatch,
                       priority: int = ACTIVE_BATCHING_PRIORITY,
                       owner: Optional[QosTag] = None,
                       size: Optional[int] = None) -> int:
        """Track a device batch as spillable; may spill lower-priority
        buffers to stay within the device budget. ``size`` is its
        :func:`device_size_bytes` when the caller has it already."""
        if size is None:
            size = device_size_bytes(batch)
        meta = TableMeta(batch.schema, batch.capacity, size, batch.device)
        t0 = time.perf_counter_ns()
        with self._lock:
            self._note_lock_wait(t0)
            bid = self._next_id
            self._next_id += 1
            self._entries[bid] = _Entry(bid, priority, meta,
                                        StorageTier.DEVICE,
                                        device_batch=batch, owner=owner)
            self.device_bytes += size
        self.enforce_budgets(requester=owner)
        return bid

    # -- access ---------------------------------------------------------------
    def acquire_batch(self, buffer_id: int) -> ColumnarBatch:
        """The batch on its device, restored through the tiers when it
        spilled; a buffer in flight is waited out on its own condition."""
        while True:
            reserved = False
            t0 = time.perf_counter_ns()
            with self._lock:
                self._note_lock_wait(t0)
                entry = self._entries[buffer_id]
                assert not entry.freed, f"buffer {buffer_id} already freed"
                tier = entry.tier
                if tier == StorageTier.DEVICE:
                    return entry.device_batch
                if tier in TRANSITIONAL_TIERS:
                    cond = self._entry_cond(entry)
                    while entry.tier in TRANSITIONAL_TIERS \
                            and not entry.freed and not self._closed:
                        cond.wait(timeout=_WAIT_TICK_S)
                else:
                    src = tier
                    entry.tier = StorageTier.RESTORING
                    entry.moving_from = src
                    self._entry_cond(entry)
                    host = entry.host_batch
                    reserved = True
            if reserved:
                return self._restore_entry(entry, src, host)

    def _release_freed_restore_range(self, entry: _Entry, src: str) -> bool:
        """The deferred ``free_range`` of a disk entry freed while it was
        RESTORING (caller holds the lock); returns whether this thread
        claimed the follow-up compaction."""
        if src == StorageTier.DISK and entry.disk_range is not None \
                and self._spill_file is not None \
                and not self._compacting \
                and entry.freed_gen == self._compact_gen:
            self._spill_file.free_range(*entry.disk_range)
            entry.disk_range = None
            return self._claim_compact()
        return False

    def _restore_entry(self, entry: _Entry, src: str,
                       host: Optional[HostPayload]) -> ColumnarBatch:
        """Off-lock restore of a RESTORING entry, published under the
        lock."""
        size = entry.meta.size_bytes
        t0 = time.perf_counter_ns()
        try:
            if src == StorageTier.DISK:
                host = deserialize_host(self._read_disk_payload(entry))
            with trace_range("spill.reload_to_device"):
                batch = to_device(host, entry.meta)
        except BaseException:
            # revert and re-raise unchanged: the acquiring site's retry
            # classifies it
            compact_ready = False
            with self._lock:
                if entry.freed:
                    compact_ready = \
                        self._release_freed_restore_range(entry, src)
                else:
                    entry.tier = src
                    entry.moving_from = ""
                entry.cond.notify_all()
            if compact_ready:
                self._compact_now()
            raise
        io_ns = time.perf_counter_ns() - t0
        compact_ready = False
        closed = False
        with self._lock:
            self.metrics["spill_io_ns"] += io_ns
            self.metrics["spill_io_bytes"] += size
            self._count("disk_to_device" if src == StorageTier.DISK
                        else "host_to_device", io_ns, size)
            freed = entry.freed
            if not freed and self._closed:
                closed = True
                entry.cond.notify_all()
            elif freed:
                compact_ready = self._release_freed_restore_range(entry,
                                                                  src)
                entry.cond.notify_all()
            else:
                if src == StorageTier.DISK:
                    if entry.disk_range is not None \
                            and self._spill_file is not None \
                            and not self._compacting:
                        self._spill_file.free_range(*entry.disk_range)
                    entry.disk_range = None
                    self.metrics["reloaded_from_disk"] += 1
                    compact_ready = self._claim_compact()
                else:
                    self.host_bytes -= size
                    self.metrics["reloaded_from_host"] += 1
                entry.host_batch = None
                entry.device_batch = batch
                entry.tier = StorageTier.DEVICE
                entry.moving_from = ""
                self.device_bytes += size
                self.metrics["disk_spill_file_bytes"] = \
                    self._spill_file.live_bytes if self._spill_file else 0
                entry.cond.notify_all()
        if compact_ready:
            self._compact_now()
        if freed:
            raise KeyError(entry.buffer_id)
        if closed:
            return batch
        self.enforce_budgets(requester=entry.owner,
                              exclude=entry.buffer_id)
        return batch

    def _read_disk_payload(self, entry: _Entry) -> np.ndarray:
        """Read a RESTORING entry's disk range off the lock, standing
        aside while a compaction runs and re-validating the range after
        the read."""
        while True:
            with self._lock:
                while self._compacting:
                    self._state_cond.wait(timeout=_WAIT_TICK_S)
                rng = entry.disk_range
            payload = self._disk().read(*rng)
            with self._lock:
                if not self._compacting and entry.disk_range == rng:
                    return payload

    def tier_of(self, buffer_id: int) -> str:
        with self._lock:
            return self._entries[buffer_id].tier

    def disk_range_of(self, buffer_id: int) -> Optional[Tuple[int, int]]:
        """The buffer's (offset, length) in the spill file, if on disk."""
        with self._lock:
            return self._entries[buffer_id].disk_range

    @property
    def spill_file(self) -> Optional[SpillFile]:
        return self._spill_file

    def free(self, buffer_id: int) -> None:
        compact_ready = False
        t0 = time.perf_counter_ns()
        with self._lock:
            self._note_lock_wait(t0)
            entry = self._entries.pop(buffer_id, None)
            self._pinned.discard(buffer_id)
            if entry is None or entry.freed:
                return
            entry.freed = True
            size = entry.meta.size_bytes
            tier = entry.tier
            if tier == StorageTier.DEVICE:
                self.device_bytes -= size
                entry.device_batch = None
            elif tier == StorageTier.HOST:
                self.host_bytes -= size
                entry.host_batch = None
            elif tier == StorageTier.DISK:
                if entry.disk_range is not None \
                        and self._spill_file is not None \
                        and not self._compacting:
                    self._spill_file.free_range(*entry.disk_range)
                    entry.disk_range = None
                    compact_ready = self._claim_compact()
            elif tier == StorageTier.SPILLING:
                # the worker owns the payload; account the source now
                if entry.moving_from == StorageTier.DEVICE:
                    self.device_bytes -= size
                else:
                    self.host_bytes -= size
            elif tier == StorageTier.RESTORING:
                entry.freed_gen = self._compact_gen
                if entry.moving_from == StorageTier.HOST:
                    self.host_bytes -= size
            if entry.cond is not None:
                entry.cond.notify_all()
        if compact_ready:
            self._compact_now()

    def pin(self, buffer_id: int) -> None:
        """Keep a buffer on the device while an operator uses it."""
        with self._lock:
            self._pinned.add(buffer_id)

    def unpin(self, buffer_id: int) -> None:
        with self._lock:
            self._pinned.discard(buffer_id)

    def leak_report(self) -> list:
        """``[(buffer_id, tier, bytes)]`` of buffers never freed."""
        with self._lock:
            return [(bid, e.tier, e.meta.size_bytes)
                    for bid, e in self._entries.items() if not e.freed]

    def close(self) -> None:
        with self._lock:
            deadline = time.monotonic() + _CLOSE_DRAIN_DEADLINE_S
            while self._io_pending > 0 and time.monotonic() < deadline:
                self._state_cond.wait(timeout=_WAIT_TICK_S)
            self._closed = True
            for e in self._entries.values():
                if e.cond is not None:
                    e.cond.notify_all()
            if self._io_pending > 0:
                _LOG.warning("spill catalog closed with %d IO unit(s) in "
                             "flight", self._io_pending)
            leaks = self.leak_report()
            if leaks:
                _LOG.warning("spill catalog closed with %d leaked "
                             "buffer(s), %d bytes", len(leaks),
                             sum(b for _, _, b in leaks))
            self._entries.clear()
            self._pinned.clear()
            self.device_bytes = self.host_bytes = 0
            if self._spill_file is not None:
                self._spill_file.close()
                self._spill_file = None

    # -- spilling -------------------------------------------------------------
    def synchronous_spill(self, target_device_bytes: int,
                          requester: Optional[QosTag] = None) -> None:
        """Spill device buffers (QoS order) until usage <= the target;
        returns once the copies have landed."""
        t0 = time.perf_counter_ns()
        with self._lock:
            self._note_lock_wait(t0)
            jobs = self._reserve_device_victims(target_device_bytes,
                                                requester)
        self._run_spill_jobs(jobs, requester)

    def spill_below(self, priority_ceiling: int,
                    requester: Optional[QosTag] = None) -> int:
        """Spill every unpinned device buffer below ``priority_ceiling``
        (cascading to disk through the host budget): the OOM retry's
        drain. Returns the device bytes moved."""
        t0 = time.perf_counter_ns()
        with self._lock:
            self._note_lock_wait(t0)
            jobs = self._reserve_device_victims(
                0, requester, ceiling=priority_ceiling)
        moved = sum(e.meta.size_bytes for e in jobs)
        self._run_spill_jobs(jobs, requester)
        return moved

    def enforce_budgets(self, requester: Optional[QosTag] = None,
                        exclude: Optional[int] = None) -> None:
        """Bring device and host usage back under their budgets (a host
        budget lowered at run time cascades to disk); returns once the
        copies have landed. The upload cache's and the captured graphs'
        device bytes count against the device budget and are evicted
        first."""
        budget = self.device_budget  # resolves the callable off the lock
        # the upload cache and the fused graphs count against the budget
        # too; as pure caches they go first (LRU), before a real buffer
        # spills
        from ..compile import executables
        from ..data import upload_cache
        over = self.device_bytes + upload_cache.cache_bytes() \
            + executables.graph_bytes() - budget
        if over > 0:
            over -= upload_cache.shrink_by(over)
        if over > 0:
            executables.release_lru(over)
        t0 = time.perf_counter_ns()
        with self._lock:
            self._note_lock_wait(t0)
            jobs = self._reserve_device_victims(budget, requester,
                                                exclude=exclude)
            jobs += self._reserve_host_victims(requester)
        self._run_spill_jobs(jobs, requester)

    def _victim_key(self, entry: _Entry, requester: Optional[QosTag]):
        """Victim order: spill priority first; within a band, the
        requester's own buffers, then its tenant's, then other tenants'
        by descending deadline slack, then larger buffers, then older."""
        owner = entry.owner
        if requester is None:
            return (entry.priority, 0, 0.0, 0, entry.buffer_id)
        if owner is requester:
            cls = 0
        elif owner is not None and owner.tenant == requester.tenant:
            cls = 1
        else:
            cls = 2
        slack = owner.slack() if owner is not None else math.inf
        return (entry.priority, cls, -slack, -entry.meta.size_bytes,
                entry.buffer_id)

    def _reserve_device_victims(self, target: int,
                                requester: Optional[QosTag],
                                exclude: Optional[int] = None,
                                ceiling: Optional[int] = None
                                ) -> List[_Entry]:
        """Reserve DEVICE->SPILLING transitions (caller holds the lock)
        until settled-plus-in-flight device usage fits ``target``."""
        usage = self.device_bytes - self._spilling_device_bytes
        if usage <= target:
            return []
        # a batch with no columns stays: its row count lives in no lane
        cands = [e for e in self._entries.values()
                 if e.tier == StorageTier.DEVICE and not e.freed
                 and e.device_batch.columns
                 and e.buffer_id != exclude
                 and e.buffer_id not in self._pinned
                 and (ceiling is None or e.priority < ceiling)]
        cands.sort(key=lambda e: self._victim_key(e, requester))
        jobs: List[_Entry] = []
        for e in cands:
            if usage <= target:
                break
            e.tier = StorageTier.SPILLING
            e.moving_from = StorageTier.DEVICE
            self._entry_cond(e)
            self._spilling_device_bytes += e.meta.size_bytes
            usage -= e.meta.size_bytes
            jobs.append(e)
        return jobs

    def _reserve_host_victims(self, requester: Optional[QosTag]
                              ) -> List[_Entry]:
        """Reserve HOST->SPILLING (to disk) transitions (caller holds the
        lock) until host usage fits the host budget."""
        if self.host_bytes - self._spilling_host_bytes <= self.host_budget:
            return []
        cands = [e for e in self._entries.values()
                 if e.tier == StorageTier.HOST and not e.freed
                 and e.buffer_id not in self._pinned]
        cands.sort(key=lambda e: self._victim_key(e, requester))
        jobs: List[_Entry] = []
        for e in cands:
            if self.host_bytes - self._spilling_host_bytes \
                    <= self.host_budget:
                break
            e.tier = StorageTier.SPILLING
            e.moving_from = StorageTier.HOST
            self._entry_cond(e)
            self._spilling_host_bytes += e.meta.size_bytes
            jobs.append(e)
        return jobs

    # -- the spill-IO lane ----------------------------------------------------
    def _run_spill_jobs(self, jobs: List[_Entry],
                        requester: Optional[QosTag]) -> None:
        """Run reserved transitions off the lock: on the lane when
        ioThreads > 0 and there are several, inline otherwise; waits for
        every publish with no lock held, and lets every job settle
        (publish or revert) before the first failure propagates."""
        if not jobs:
            return
        if self._io_slots is None or len(jobs) == 1:
            err0: Optional[BaseException] = None
            for e in jobs:
                try:
                    self._spill_job(e, requester)
                except BaseException as exc:
                    err0 = err0 or exc
            if err0 is not None:
                raise err0
            return
        from ..exec import pipeline
        from ..metrics import trace as TR
        submitted = []
        for e in jobs:
            with self._lock:
                self._io_pending += 1
                if self._io_pending > self.metrics["spill_queue_peak"]:
                    self.metrics["spill_queue_peak"] = self._io_pending
            f = pipeline.submit_spill_io(self._io_task, e, requester)
            if f is None:  # pool torn down: run inline
                self._io_finished()
                self._spill_job(e, requester)
            else:
                submitted.append((f, e))
        err: Optional[BaseException] = None
        for f, e in submitted:
            try:
                with TR.span(requester.trace if requester is not None
                             else None, "spill.io_wait", cat="spill"), \
                        lockdep.blocking("spill.io_wait"):
                    f.result()
            except BaseException as exc:
                from concurrent.futures import CancelledError
                if isinstance(exc, CancelledError):
                    # never started: its finally never ran
                    self._io_finished()
                    self._spill_job(e, requester)
                else:
                    err = err or exc
        if err is not None:
            raise err

    def _io_task(self, entry: _Entry, requester: Optional[QosTag]) -> None:
        with self._io_slots:
            try:
                self._spill_job(entry, requester)
            finally:
                self._io_finished()

    def _io_finished(self) -> None:
        with self._lock:
            self._io_pending -= 1
            self._state_cond.notify_all()

    def _spill_job(self, entry: _Entry,
                   requester: Optional[QosTag]) -> None:
        """One reserved SPILLING transition, the host->disk cascade it
        causes included."""
        with self._lock:
            self._io_running += 1
            if self._io_running > self.metrics["spill_concurrent_peak"]:
                self.metrics["spill_concurrent_peak"] = self._io_running
        from ..metrics import trace as TR
        try:
            with TR.span(requester.trace if requester is not None else None,
                         "spill.io", cat="spill",
                         tier=entry.moving_from or entry.tier,
                         bytes=entry.meta.size_bytes):
                if entry.moving_from == StorageTier.DEVICE:
                    self._spill_device_job(entry, requester)
                else:
                    self._spill_host_job(entry)
        finally:
            with self._lock:
                self._io_running -= 1

    def _spill_device_job(self, entry: _Entry,
                          requester: Optional[QosTag]) -> None:
        size = entry.meta.size_bytes
        t0 = time.perf_counter_ns()
        try:
            with trace_range("spill.device_to_host"):
                host = to_host(entry.device_batch)
        except BaseException:
            with self._lock:
                self._spilling_device_bytes -= size
                if not entry.freed:
                    entry.tier = StorageTier.DEVICE
                    entry.moving_from = ""
                entry.cond.notify_all()
            raise
        io_ns = time.perf_counter_ns() - t0
        cascade: List[_Entry] = []
        with self._lock:
            self._spilling_device_bytes -= size
            self.metrics["spill_io_ns"] += io_ns
            self.metrics["spill_io_bytes"] += size
            self._count("device_to_host", io_ns, size)
            if self._closed:
                entry.device_batch = None
                entry.cond.notify_all()
                self._state_cond.notify_all()
                return
            if entry.freed:
                entry.device_batch = None
                entry.cond.notify_all()
            else:
                entry.host_batch = host
                entry.device_batch = None
                entry.tier = StorageTier.HOST
                entry.moving_from = ""
                self.device_bytes -= size
                self.host_bytes += size
                self.metrics["spilled_to_host"] += 1
                self.metrics["spill_bytes_to_host"] += size
                entry.cond.notify_all()
                cascade = self._reserve_host_victims(requester)
        err: Optional[BaseException] = None
        for victim in cascade:
            try:
                self._spill_host_job(victim)
            except BaseException as exc:
                err = err or exc
        if err is not None:
            raise err

    def _spill_host_job(self, entry: _Entry) -> None:
        size = entry.meta.size_bytes
        with self._lock:
            while self._compacting:
                self._state_cond.wait(timeout=_WAIT_TICK_S)
            if self._closed:
                self._spilling_host_bytes -= size
                entry.host_batch = None
                if entry.cond is not None:
                    entry.cond.notify_all()
                return
            self._disk_appends += 1
        t0 = time.perf_counter_ns()
        try:
            with trace_range("spill.host_to_disk"):
                payload = serialize_host(entry.host_batch, entry.meta.schema)
                rng = self._disk().append(payload)
        except SpillFileClosedError:
            with self._lock:
                self._disk_appends -= 1
                self._spilling_host_bytes -= size
                entry.host_batch = None
                entry.cond.notify_all()
                self._state_cond.notify_all()
            return
        except BaseException:
            with self._lock:
                self._disk_appends -= 1
                self._spilling_host_bytes -= size
                if not entry.freed:
                    entry.tier = StorageTier.HOST
                    entry.moving_from = ""
                entry.cond.notify_all()
            raise
        io_ns = time.perf_counter_ns() - t0
        compact_ready = False
        with self._lock:
            self._disk_appends -= 1
            self._spilling_host_bytes -= size
            self.metrics["spill_io_ns"] += io_ns
            self.metrics["spill_io_bytes"] += rng[1]
            self._count("host_to_disk", io_ns, rng[1])
            if self._closed:
                entry.host_batch = None
                entry.cond.notify_all()
                self._state_cond.notify_all()
                return
            if entry.freed:
                self._disk().free_range(*rng)
                entry.host_batch = None
                compact_ready = self._claim_compact()
            else:
                entry.disk_range = rng
                entry.host_batch = None
                entry.tier = StorageTier.DISK
                entry.moving_from = ""
                self.host_bytes -= size
                self.metrics["spilled_to_disk"] += 1
                self.metrics["spill_bytes_to_disk"] += rng[1]
                compact_ready = self._claim_compact()
            self.metrics["disk_spill_file_bytes"] = self._disk().live_bytes
            entry.cond.notify_all()
        if compact_ready:
            self._compact_now()

    # -- disk compaction ------------------------------------------------------
    def _claim_compact(self) -> bool:
        """Whether the spill file crossed DISK_COMPACT_FRACTION dead bytes
        and this caller claimed the one compaction slot (caller holds the
        lock and must call :meth:`_compact_now` after releasing it)."""
        f = self._spill_file
        if f is None or self._compacting or self._disk_appends > 0:
            if f is not None:
                self.metrics["disk_spill_file_bytes"] = f.live_bytes
            return False
        if f.freed_bytes == 0 or f.freed_fraction() < DISK_COMPACT_FRACTION:
            self.metrics["disk_spill_file_bytes"] = f.live_bytes
            return False
        self._compacting = True
        return True

    def _compact_now(self) -> None:
        """Rewrite the spill file without its dead ranges, off the catalog
        lock (snapshot and install under it)."""
        f = self._spill_file
        with self._lock:
            if self._closed or f is None:
                self._compacting = False
                self._state_cond.notify_all()
                return
            live = {bid: e.disk_range for bid, e in self._entries.items()
                    if e.disk_range is not None and not e.freed}
        try:
            with trace_range("spill.compact_disk"):
                new_ranges = f.compact(live)
        except SpillFileClosedError:
            with self._lock:
                self._compacting = False
                self._state_cond.notify_all()
            return
        except BaseException:
            with self._lock:
                self._compacting = False
                self._state_cond.notify_all()
            raise
        with self._lock:
            for bid, rng in new_ranges.items():
                e = self._entries.get(bid)
                if e is None or e.freed or e.disk_range is None:
                    f.free_range(*rng)
                else:
                    e.disk_range = rng
            self._compacting = False
            self._compact_gen += 1
            self.metrics["disk_spill_file_compactions"] += 1
            self.metrics["disk_spill_file_bytes"] = f.live_bytes
            self._state_cond.notify_all()
