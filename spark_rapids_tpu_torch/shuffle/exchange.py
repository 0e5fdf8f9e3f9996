"""The shuffle exchange — port of the core of
``spark_rapids_tpu/shuffle/exchange.py`` (``ShuffleBufferCatalog`` and
``TpuShuffleExchangeExec``).

Map side, per input batch (one map task each):

1. device partition ids (:mod:`.partitioners`); dead rows get id ``n``;
2. a stable sort of the id lane (``torch.sort(stable=True)``; the
   reference uses ``lax.sort``, not a Pallas kernel) and a gather of every
   column in that order, so each partition's rows are contiguous and
   keep their input order, dead rows last;
3. ONE download of the live rows and their ids
   (:func:`..data.batch.download_columns`);
4. ``np.searchsorted`` over the sorted ids cuts the rows into one block
   per partition, each serialized (:mod:`.serializer`) into the catalog
   under (shuffle, map, reduce).

Read side, per reduce partition: its blocks in map order, each
deserialized (lanes viewed in place) and uploaded lane by lane as one
batch (:func:`..data.batch.upload_columns`). An empty partition yields no
batch, as in the reference.

Memory and robustness: steps 1-3 of a map task run under
:func:`..memory.retry.with_retry` (site
``ShuffleExchangeExec.partitionSplit``) and split the input in half by
rows when retries cannot fit it, each half a map task of its own (the
rows reach the same partitions). The catalog keeps blocks in host memory
up to ``spark.rapids.memory.host.spillStorageSize`` and appends the rest
to a :class:`~..memory.spill.SpillFile`; with
``spark.rapids.tpu.shuffle.checksum.enabled`` every block's CRC32C is
recorded when it is added and verified on every read, in memory and on
disk, and a mismatch raises :class:`~..utils.checksum.ChecksumError`.

Metrics, at the reference's sites: the map side's ``downloadBytes``,
``serializationTime`` and ``shuffleBytesWritten``; the read side's
``shuffleBytesRead``, ``deserializationTime``, ``uploadBytes``,
``numOutputRows`` and ``numOutputBatches`` (all host-known). Each map
task is a ``shuffle.map`` span when the query is traced.

Not ported yet: the network plane, replication, hedged fetches, lineage
recompute, adaptive (AQE) read planning and the pipelined overlap of
serialization with device work (ROADMAP.md A, items 3 and 8). Blocks
live for the one exchange that wrote them, and the context's cleanups
close the catalog (and its spill file). The reference's read-side
overlap (``prefetch_iter`` over the reduce partitions) comes with the
pipelined read side.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..data.batch import ColumnarBatch, download_columns, upload_columns
from ..exec.execs import ExecContext, TorchExec
from ..metrics import trace as TR
from ..ops.kernels import rowops as KR
from ..utils import checksum as CK
from ..utils import lockdep
from .partitioners import RoundRobinPartitioner
from .serializer import deserialize_block, serialize_block


class ShuffleBufferCatalog:
    """Serialized blocks keyed (shuffle, map, reduce) for the exchanges of
    one query run: in host memory up to ``host_budget`` bytes, then on a
    :class:`~..memory.spill.SpillFile`. ``verify`` records each block's
    CRC32C when it is added and checks it on every read (``device`` picks
    the CRC routine: the C++ one for a card's query)."""

    def __init__(self, host_budget: int = 1 << 30, spill_dir=None,
                 verify: bool = True, device="cpu"):
        self.host_budget = int(host_budget)
        self.verify = verify
        self.device = torch.device(device)
        self._blocks: Dict[Tuple[int, int, int], object] = {}
        self._crcs: Dict[Tuple[int, int, int], int] = {}
        self._host_bytes = 0
        self._spill_dir = spill_dir
        self._spill_file = None
        self._next_id = 0
        self._lock = lockdep.lock("ShuffleBufferCatalog._lock")
        self.metrics = {"blocks": 0, "bytes_written": 0, "disk_blocks": 0,
                        "disk_bytes": 0}

    def new_shuffle_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id - 1

    def _disk(self):
        from ..memory.spill import SpillFile
        with self._lock:
            if self._spill_file is None:
                self._spill_file = SpillFile(self._spill_dir,
                                             verify=self.verify,
                                             device=self.device)
            return self._spill_file

    def add_block(self, shuffle_id: int, map_id: int, reduce_id: int,
                  payload: np.ndarray) -> None:
        key = (shuffle_id, map_id, reduce_id)
        crc = CK.crc32c(payload, device=self.device) if self.verify \
            else None
        with self._lock:
            to_disk = self._host_bytes + payload.nbytes > self.host_budget
            if not to_disk:
                self._blocks[key] = payload
                self._host_bytes += payload.nbytes
        if to_disk:
            # the append's CRC is the file's own, verified on its read
            rng = self._disk().append(payload)
            with self._lock:
                self._blocks[key] = rng
                self.metrics["disk_blocks"] += 1
                self.metrics["disk_bytes"] += rng[1]
        with self._lock:
            if crc is not None:
                self._crcs[key] = crc
            self.metrics["blocks"] += 1
            self.metrics["bytes_written"] += payload.nbytes

    def _payload(self, key, ctx=None, node=None) -> np.ndarray:
        with self._lock:
            block = self._blocks[key]
            crc = self._crcs.get(key)
        if isinstance(block, tuple):
            return self._disk().read(*block, ctx=ctx, node=node)
        if crc is not None:
            CK.verify(block, crc, f"shuffle block {key}", ctx, node,
                      device=self.device)
        return block

    def blocks_for_reduce(self, shuffle_id: int, reduce_id: int, ctx=None,
                          node=None) -> Iterator[np.ndarray]:
        """One reduce partition's blocks, in map order, each verified as
        it is read."""
        with self._lock:
            keys = sorted(k for k in self._blocks
                          if k[0] == shuffle_id and k[2] == reduce_id)
        for k in keys:
            yield self._payload(k, ctx, node)

    def block_location(self, key) -> object:
        """A block's payload in memory, or its (offset, length) on disk."""
        with self._lock:
            return self._blocks[key]

    @property
    def spill_file(self):
        return self._spill_file

    def unregister_shuffle(self, shuffle_id: int) -> None:
        with self._lock:
            keys = [k for k in self._blocks if k[0] == shuffle_id]
            for k in keys:
                block = self._blocks.pop(k)
                self._crcs.pop(k, None)
                if isinstance(block, tuple):
                    self._spill_file.free_range(*block)
                else:
                    self._host_bytes -= block.nbytes

    def close(self) -> None:
        with self._lock:
            self._blocks.clear()
            self._crcs.clear()
            self._host_bytes = 0
            spill_file, self._spill_file = self._spill_file, None
        if spill_file is not None:
            spill_file.close()


def _catalog_of(ctx: ExecContext) -> ShuffleBufferCatalog:
    """The context's shuffle catalog, made at its first exchange and
    closed with the attempt's cleanups."""
    if ctx.shuffle_catalog is None:
        from ..config import (HOST_SPILL_STORAGE_SIZE,
                              SHUFFLE_CHECKSUM_ENABLED, SPILL_DIR)
        ctx.shuffle_catalog = ShuffleBufferCatalog(
            ctx.conf.get(HOST_SPILL_STORAGE_SIZE), ctx.conf.get(SPILL_DIR),
            verify=ctx.conf.get(SHUFFLE_CHECKSUM_ENABLED),
            device=ctx.device)
        ctx.add_cleanup(ctx.shuffle_catalog.close)
    return ctx.shuffle_catalog


def partition_sort(batch, partitioner, n_parts: int):
    """(the batch's rows stably sorted by partition id, dead rows last, as
    a physical batch; the sorted id lane)."""
    if isinstance(partitioner, RoundRobinPartitioner):
        # Round-robin ids are positional: live rows move to the front
        # first, so they cycle over the partitions in row order.
        batch = KR.physical(batch)
    ids = partitioner.device_ids(batch)
    ids = torch.where(batch.row_mask(), ids, n_parts)
    sorted_ids, perm = torch.sort(ids, stable=True)
    iota = torch.arange(batch.capacity, device=batch.device)
    cols = KR.gather_columns(batch.columns, perm, iota < batch.n_rows)
    return ColumnarBatch(cols, batch.n_rows, batch.schema), sorted_ids


class ShuffleExchangeExec(TorchExec):
    """Repartition the child's rows into ``n_parts`` partitions through
    serialized host blocks (see the module doc)."""

    def __init__(self, child: TorchExec, partitioner_factory, n_parts: int):
        self.children = [child]
        self.partitioner_factory = partitioner_factory
        self.n_parts = n_parts

    @property
    def schema(self):
        return self.children[0].schema

    def describe(self):
        mode = getattr(self.partitioner_factory, "mode", "?")
        keys = getattr(self.partitioner_factory, "keys", None) or []
        return (f"ShuffleExchange {mode} n={self.n_parts}"
                + (" [" + ", ".join(str(k) for k in keys) + "]"
                   if keys else ""))

    def execute(self, ctx: ExecContext):
        from ..memory import retry as R
        parts = self.children[0].execute(ctx)
        partitioner = self.partitioner_factory(self.children[0])
        catalog = _catalog_of(ctx)
        shuffle_id = catalog.new_shuffle_id()
        name = self.name
        map_id = 0
        try:
            for part in parts:
                for batch in part:
                    # a split batch writes two map tasks: each row reaches
                    # the same partition either way
                    for split in R.with_retry(
                            ctx, f"{name}.partitionSplit", batch,
                            lambda b: self._partition_split(ctx, b,
                                                            partitioner),
                            split=R.halve_by_rows, node=name):
                        if split is None:
                            continue
                        with TR.span(ctx.trace, "shuffle.map",
                                     cat="shuffle", shuffle=shuffle_id,
                                     map=map_id):
                            self._write_map(ctx, catalog, split, shuffle_id,
                                            map_id)
                        map_id += 1
            return [list(self._read_partition(ctx, catalog, shuffle_id, p))
                    for p in range(self.n_parts)]
        finally:
            catalog.unregister_shuffle(shuffle_id)

    def _read_partition(self, ctx: ExecContext, catalog, shuffle_id: int,
                        p: int):
        name = self.name
        for payload in catalog.blocks_for_reduce(shuffle_id, p, ctx, name):
            ctx.metric(name, "shuffleBytesRead", len(payload))
            with ctx.timed(name + ".read", host=True,
                           metric="deserializationTime"):
                block_schema, cols = deserialize_block(payload)
            with ctx.timed(name + ".upload", host=True):
                batch = upload_columns(cols, block_schema, ctx.device)
            ctx.metric(name, "uploadBytes", sum(c.nbytes for c in cols))
            ctx.metric(name, "numOutputRows",
                       cols[0].num_rows if cols else 0)
            ctx.metric(name, "numOutputBatches", 1)
            yield batch

    def _partition_split(self, ctx: ExecContext, batch, partitioner):
        """Steps 1-3 of a map task, the exchange's memory hazard: the
        batch's rows sorted by partition and downloaded. None for a batch
        with no live row. Side-effect free, so the retry may re-run it."""
        name, n_parts = self.name, self.n_parts
        with ctx.timed(name + ".partition"):
            sorted_batch, ids = partition_sort(batch, partitioner, n_parts)
            # the live row count sizes the download: one host read, which
            # also leaves the card idle for the host-clock timings below
            n = int(sorted_batch.n_rows)
        if n == 0:
            return None
        with ctx.timed(name + ".download", host=True):
            cols, (ids_np,) = download_columns(sorted_batch, n, [ids])
        ctx.metric(name, "downloadBytes",
                   sum(c.nbytes for c in cols) + ids_np.nbytes)
        return cols, ids_np, n

    def _write_map(self, ctx: ExecContext, catalog, split, shuffle_id: int,
                   map_id: int) -> None:
        """Step 4: one block per partition, serialized into the
        catalog."""
        cols, ids_np, n = split
        name, n_parts = self.name, self.n_parts
        with ctx.timed(name + ".serialize", host=True,
                       metric="serializationTime"):
            bounds = np.searchsorted(ids_np, np.arange(n_parts + 1))
            for p in range(n_parts):
                a, b = int(bounds[p]), int(bounds[p + 1])
                if b > a:
                    payload = serialize_block(
                        [c.slice(a, b) for c in cols], self.schema)
                    ctx.metric(name, "shuffleBytesWritten", len(payload))
                    catalog.add_block(shuffle_id, map_id, p, payload)
