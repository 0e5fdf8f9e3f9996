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

Metrics, at the reference's sites: the map side's ``downloadBytes``,
``serializationTime`` and ``shuffleBytesWritten``; the read side's
``shuffleBytesRead``, ``deserializationTime``, ``uploadBytes``,
``numOutputRows`` and ``numOutputBatches`` (all host-known). Each map
task is a ``shuffle.map`` span when the query is traced.

Not ported yet: retry and split of the map side, spill of blocks to
disk, the network plane, replication, hedged fetches, lineage recompute,
adaptive (AQE) read planning and the pipelined overlap of serialization
with device work (ROADMAP.md A, items 4, 3 and 8). Blocks live in host
memory for the one query that wrote them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..data.batch import ColumnarBatch, download_columns, upload_columns
from ..exec.execs import ExecContext, TorchExec
from ..metrics import trace as TR
from ..ops.kernels import rowops as KR
from .partitioners import RoundRobinPartitioner
from .serializer import deserialize_block, serialize_block


class ShuffleBufferCatalog:
    """Serialized blocks in host memory, keyed (shuffle, map, reduce), for
    the exchanges of one query run (single-threaded: the map side writes
    every block before the read side starts)."""

    def __init__(self):
        self._blocks: Dict[Tuple[int, int, int], np.ndarray] = {}
        self._next_id = 0

    def new_shuffle_id(self) -> int:
        self._next_id += 1
        return self._next_id - 1

    def add_block(self, shuffle_id: int, map_id: int, reduce_id: int,
                  payload: np.ndarray) -> None:
        self._blocks[(shuffle_id, map_id, reduce_id)] = payload

    def blocks_for_reduce(self, shuffle_id: int, reduce_id: int
                          ) -> List[np.ndarray]:
        """One reduce partition's blocks, in map order."""
        keys = sorted(k for k in self._blocks
                      if k[0] == shuffle_id and k[2] == reduce_id)
        return [self._blocks[k] for k in keys]

    def unregister_shuffle(self, shuffle_id: int) -> None:
        for k in [k for k in self._blocks if k[0] == shuffle_id]:
            del self._blocks[k]


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
        parts = self.children[0].execute(ctx)
        partitioner = self.partitioner_factory(self.children[0])
        if ctx.shuffle_catalog is None:
            ctx.shuffle_catalog = ShuffleBufferCatalog()
        catalog = ctx.shuffle_catalog
        shuffle_id = catalog.new_shuffle_id()
        n_parts = self.n_parts
        name = self.name
        map_id = 0
        try:
            for part in parts:
                for batch in part:
                    with TR.span(ctx.trace, "shuffle.map", cat="shuffle",
                                 shuffle=shuffle_id, map=map_id):
                        written = self._map_task(ctx, catalog, batch,
                                                 partitioner, shuffle_id,
                                                 map_id)
                    map_id += written
            out = []
            for p in range(n_parts):
                batches = []
                for payload in catalog.blocks_for_reduce(shuffle_id, p):
                    ctx.metric(name, "shuffleBytesRead", len(payload))
                    with ctx.timed(name + ".read", host=True,
                                   metric="deserializationTime"):
                        block_schema, cols = deserialize_block(payload)
                    with ctx.timed(name + ".upload", host=True):
                        batches.append(upload_columns(cols, block_schema,
                                                      ctx.device))
                    ctx.metric(name, "uploadBytes",
                               sum(c.nbytes for c in cols))
                    ctx.metric(name, "numOutputRows",
                               cols[0].num_rows if cols else 0)
                    ctx.metric(name, "numOutputBatches", 1)
                out.append(batches)
            return out
        finally:
            catalog.unregister_shuffle(shuffle_id)

    def _map_task(self, ctx: ExecContext, catalog, batch, partitioner,
                  shuffle_id: int, map_id: int) -> int:
        """One input batch into blocks (a map task). Returns 1 when it
        wrote blocks, 0 for a batch with no live row."""
        name, n_parts = self.name, self.n_parts
        with ctx.timed(name + ".partition"):
            sorted_batch, ids = partition_sort(batch, partitioner, n_parts)
            # the live row count sizes the download: one host read, which
            # also leaves the card idle for the host-clock timings below
            n = int(sorted_batch.n_rows)
        if n == 0:
            return 0
        with ctx.timed(name + ".download", host=True):
            cols, (ids_np,) = download_columns(sorted_batch, n, [ids])
        ctx.metric(name, "downloadBytes",
                   sum(c.nbytes for c in cols) + ids_np.nbytes)
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
        return 1
