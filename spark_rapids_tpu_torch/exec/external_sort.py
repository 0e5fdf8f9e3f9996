"""External merge sort over the spill catalog — port of
``spark_rapids_tpu/exec/external_sort.py`` (``ExternalSorter``,
``_merge_step_kernel``, ``_TrackingCatalog``, ``sorted_chunks``).

1. **Run generation** — each input batch is sorted on the device
   (:func:`..ops.kernels.rowops.sort_batch_by_columns`: one ``sortStep``
   launch for a single packable key) and registered with the spill
   catalog, so runs move device -> host -> disk under pressure. A run is
   a FIFO of sorted chunks (one, or chunks of about ``chunk_bytes``: the
   sort's threshold bounds them as the window's re-slicing bounds its
   runs); each chunk's first key rides along on the host (one small read
   a chunk).
2. **Binary merge tree** — runs merge pairwise. A merge step holds at
   most the carry, one pulled chunk and a one-row SENTINEL on the device:
   their union is sorted once (a stable multi-operand sort, ``torch.sort``
   passes as :func:`..ops.kernels.rowops.lexsort` does), the sentinel
   carrying the smaller of the two runs' next heads and ordered after
   equal keys; the rows before it are ``<=`` every row still to come and
   go out as sorted chunks of the runs' chunk capacity, the rest carry.
3. The final run streams out chunk by chunk, in global order.

Every device allocation of the merge tree (restoring a chunk, the
sentinel's row, the merged union and the chunks cut from it) runs under
:func:`..memory.retry.with_retry` (spill and retry only: a merge step
cannot split), site ``ExternalSorter.mergeStep``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from .. import types as T
from ..data.batch import ColumnarBatch
from ..data.column import bucket_capacity
from ..memory import spill as SP
from ..ops.kernels import concat as KC
from ..ops.kernels import rowops as KR
from ..utils.tracing import trace_range


def slice_rows(batch: ColumnarBatch, start: int, count: int,
               capacity: Optional[int] = None) -> ColumnarBatch:
    """Rows ``[start, start + count)`` of a physical batch as a physical
    batch at ``capacity`` (default: the ladder rung of ``count``)."""
    cap = capacity or bucket_capacity(max(count, 1))
    dev = batch.device
    iota = torch.arange(cap, device=dev)
    idx = (start + iota).clamp(max=max(batch.capacity - 1, 0))
    cols = KR.gather_columns(batch.columns, idx, iota < count)
    return ColumnarBatch(cols, torch.tensor(count, dtype=torch.int64,
                                            device=dev), batch.schema)


def _head_key_values(batch: ColumnarBatch, key_exprs) -> tuple:
    """Row 0's key values as a host tuple (None for a null; a string as
    its bytes)."""
    out = []
    for e in key_exprs:
        c = e.eval_device(batch)
        if not bool(c.validity[0]):
            out.append(None)
        elif c.is_dict:
            out.append(str(c.dictionary[int(c.codes[0])]).encode(
                "utf-8", "surrogateescape"))
        elif c.is_string:
            a, b = c.offsets[:2].tolist()
            out.append(bytes(c.data[a:b].cpu().numpy()))
        else:
            out.append(c.data[0].item())
    return tuple(out)


def _key_less(a: tuple, b: tuple, orders) -> bool:
    """Host comparator of head tuples, honoring ascending and nulls
    first (NaN sorts greatest)."""
    for av, bv, o in zip(a, b, orders):
        nf = o.effective_nulls_first
        if av is None or bv is None:
            if av is None and bv is None:
                continue
            return nf if av is None else not nf
        if av == bv or (isinstance(av, float) and isinstance(bv, float)
                        and math.isnan(av) and math.isnan(bv)):
            continue
        if isinstance(av, float) and math.isnan(av):
            return not o.ascending
        if isinstance(bv, float) and math.isnan(bv):
            return o.ascending
        return (av < bv) == o.ascending
    return False


class _Run:
    """FIFO of sorted catalog chunks with their head keys."""

    def __init__(self):
        self.chunks: List[Tuple[int, tuple, int]] = []  # (id, head, cap)

    def head(self) -> Optional[tuple]:
        return self.chunks[0][1] if self.chunks else None

    def max_cap(self) -> int:
        return max((c for _, _, c in self.chunks), default=128)

    def pop(self, catalog) -> ColumnarBatch:
        """The next chunk, its catalog entry released (the batch keeps its
        tensors alive). The chunk leaves the run only once restored, so a
        restore that fails can be retried."""
        bid = self.chunks[0][0]
        batch = catalog.acquire_batch(bid)
        self.chunks.pop(0)
        catalog.free(bid)
        return batch

    def peek_head_row(self, catalog) -> ColumnarBatch:
        """The next chunk's first row as a one-row batch (the sentinel)."""
        return slice_rows(catalog.acquire_batch(self.chunks[0][0]), 0, 1)


def merge_step(carry: ColumnarBatch, chunk: ColumnarBatch,
               sent: Optional[ColumnarBatch], key_exprs, asc, nf
               ) -> Tuple[ColumnarBatch, int]:
    """(the union of ``carry`` and ``chunk`` in sort order, the number of
    its leading rows that sort strictly before ``sent``): the reference's
    ``_merge_step_kernel``. Without a sentinel every row is emitted."""
    parts = [carry, chunk] + ([sent] if sent is not None else [])
    n_data = int(carry.n_rows) + int(chunk.n_rows)
    total = sum(p.capacity for p in parts)
    merged = KC.concat_batches(parts, bucket_capacity(total))
    cap = merged.capacity
    keys = [e.eval_device(merged) for e in key_exprs]
    iota = torch.arange(cap, device=merged.device)
    # concat_batches packs live rows to the front: the sentinel sits at
    # the data's row count
    operands = [(iota >= n_data + (sent is not None)).to(torch.int8)] \
        + KR.sort_operands(keys, asc, nf)
    if sent is not None:
        operands.append((iota == n_data).to(torch.int8))
    perm = KR.lexsort(operands)
    n_emit = n_data
    if sent is not None:
        n_emit = int(torch.nonzero(perm == n_data)[0, 0])
        perm = torch.cat([perm[:n_emit], perm[n_emit + 1:n_data + 1]])
    out_cap = bucket_capacity(max(n_data, 1))
    idx = torch.zeros(out_cap, dtype=perm.dtype, device=perm.device)
    idx[:n_data] = perm[:n_data]
    out_iota = torch.arange(out_cap, device=merged.device)
    cols = KR.gather_columns(merged.columns, idx, out_iota < n_data)
    return ColumnarBatch(cols, torch.tensor(n_data, dtype=torch.int64,
                                            device=merged.device),
                         merged.schema), n_emit


class _TrackingCatalog:
    """Catalog proxy that remembers the chunk ids this sorter still owns,
    so an abandoned chunk stream frees every registration."""

    def __init__(self, catalog, owner=None):
        self._c = catalog
        self._owner = owner
        self.live = set()

    def register_batch(self, batch, priority):
        bid = self._c.register_batch(batch, priority, owner=self._owner)
        self.live.add(bid)
        return bid

    def free(self, bid):
        self.live.discard(bid)
        self._c.free(bid)

    def acquire_batch(self, bid):
        return self._c.acquire_batch(bid)

    def release_all(self):
        for bid in list(self.live):
            self._c.free(bid)
        self.live.clear()


class ExternalSorter:
    """Streaming global sort: :meth:`add_batch` each input, then iterate
    :meth:`sorted_chunks`."""

    def __init__(self, orders, schema: T.Schema, catalog, ctx,
                 key_exprs=None, chunk_bytes: Optional[int] = None):
        self.orders = orders
        self.schema = schema
        self.catalog = _TrackingCatalog(catalog, owner=ctx.qos)
        self.key_exprs = key_exprs or [o.child.bind(schema) for o in orders]
        self.asc = [o.ascending for o in orders]
        self.nf = [o.effective_nulls_first for o in orders]
        self._runs: List[_Run] = []
        self._ctx = ctx
        #: a sorted run larger than this is cut into chunks of about this
        #: many bytes, so a merge step's device footprint stays bounded
        #: by it and not by the input batches' size (None: one chunk a run)
        self.chunk_bytes = chunk_bytes
        #: runs generated and merge steps run (the profile reads them)
        self.n_runs = 0
        self.n_merge_steps = 0

    def _retry_step(self, tag: str, fn):
        """One merge-tree step under the retry combinator (spill and
        retry only)."""
        from ..memory import retry as R
        return R.with_retry(self._ctx, f"ExternalSorter.{tag}", None, fn,
                            node="ExternalSorter")[0]

    def release(self) -> None:
        """Free every chunk still registered (a no-op after a full run)."""
        self._runs = []
        self.catalog.release_all()

    def add_batch(self, batch: ColumnarBatch) -> None:
        """Sort one batch into a run: one chunk, or chunks of about
        ``chunk_bytes`` when it is larger."""
        keys = [e.eval_device(batch) for e in self.key_exprs]
        sdb = KR.sort_batch_by_columns(batch, keys, self.asc, self.nf)
        n = int(sdb.n_rows)
        if n == 0:
            return
        rows = n
        if self.chunk_bytes:
            per_row = max(SP.device_size_bytes(sdb) // max(sdb.capacity, 1),
                          1)
            rows = bucket_capacity(max(self.chunk_bytes // per_row, 128))
        parts = [sdb] if rows >= n else \
            [slice_rows(sdb, a, min(rows, n - a), rows)
             for a in range(0, n, rows)]
        del sdb
        run = _Run()
        for part in parts:
            run.chunks.append((self.catalog.register_batch(
                part, SP.ACTIVE_BATCHING_PRIORITY),
                _head_key_values(part, self.key_exprs), part.capacity))
        self._runs.append(run)
        self.n_runs += 1

    def _merge_two(self, r1: _Run, r2: _Run) -> _Run:
        """Two-run merge with bounded device residency; emission is
        bounded by the smaller of BOTH runs' next heads (the carry can
        hold rows above the pulled run's own next chunk), and emitted rows
        re-chunk at the runs' chunk capacity."""
        out = _Run()
        catalog = self.catalog
        base_cap = max(r1.max_cap(), r2.max_cap())

        def cut(batch, start, n):
            """Rows [start, start + n) as chunks of the runs' capacity."""
            out_chunks = []
            for off in range(start, start + n, base_cap):
                take = min(base_cap, start + n - off)
                out_chunks.append(slice_rows(
                    batch, off, take, base_cap if take == base_cap else None))
            return out_chunks

        def emit(chunks):
            for chunk in chunks:
                out.chunks.append((catalog.register_batch(
                    chunk, SP.ACTIVE_BATCHING_PRIORITY),
                    _head_key_values(chunk, self.key_exprs),
                    chunk.capacity))

        def smaller_head_run():
            h1, h2 = r1.head(), r2.head()
            if h1 is None:
                return r2
            if h2 is None:
                return r1
            return r1 if _key_less(h1, h2, self.orders) else r2

        def merge_and_cut(carry, chunk, sent):
            """(the emitted rows as chunks, the new carry): every device
            allocation of a step, so the retry covers them all; the
            chunks register with the catalog after it returns, once."""
            merged, n = merge_step(carry, chunk, sent, self.key_exprs,
                                   self.asc, self.nf)
            rest = int(merged.n_rows) - n
            return cut(merged, 0, n), \
                slice_rows(merged, n, rest) if rest > 0 else None

        step = self._retry_step
        carry = None
        while r1.chunks or r2.chunks or carry is not None:
            if carry is None:
                src = smaller_head_run()
                carry = step("mergeStep", lambda _: src.pop(catalog))
                continue
            if not (r1.chunks or r2.chunks):
                emit(step("mergeStep", lambda _: cut(
                    carry, 0, int(carry.n_rows))))
                carry = None
                continue
            src = smaller_head_run()
            chunk = step("mergeStep", lambda _: src.pop(catalog))
            sent = None
            if r1.chunks or r2.chunks:
                bound = smaller_head_run()
                sent = step("mergeStep",
                            lambda _: bound.peek_head_row(catalog))
            emitted, carry = step("mergeStep", lambda _: merge_and_cut(
                carry, chunk, sent))
            self.n_merge_steps += 1
            emit(emitted)
            # the next step must not find this one's batches still alive
            emitted = chunk = sent = None
        return out

    def sorted_chunks(self):
        """Merge every run; yield the final run's chunks in order (each
        acquired from the catalog and released as it is handed out)."""
        with trace_range("extsort.merge"):
            runs = self._runs
            while len(runs) > 1:
                nxt = [self._merge_two(runs[i], runs[i + 1])
                       for i in range(0, len(runs) - 1, 2)]
                if len(runs) % 2:
                    nxt.append(runs[-1])
                runs = nxt
            self._runs = runs
        if not runs:
            return
        last = runs[0]
        while last.chunks:
            yield self._retry_step("mergeStep",
                                   lambda _: last.pop(self.catalog))
