"""Partitioners — port of ``spark_rapids_tpu/shuffle/partitioners.py``
(GpuSinglePartitioning, GpuRoundRobinPartitioning, GpuHashPartitioning).

Each partitioner gives every row of a device batch an int32 partition
id; the exchange turns ids into contiguous per-partition blocks. Range
partitioning (sampled bounds) is not ported yet, and its factory mode
raises.
"""

from __future__ import annotations

from typing import List

import torch

from .. import types as T
from ..data.batch import ColumnarBatch
from ..ops.expression import Expression
from .partitioning import pmod_partition, spark_hash_columns_device


class Partitioner:
    """Produces per-row partition ids on the device."""

    n_parts: int

    def device_ids(self, batch: ColumnarBatch) -> torch.Tensor:
        raise NotImplementedError


class SinglePartitioner(Partitioner):
    """Everything to partition 0."""

    def __init__(self):
        self.n_parts = 1

    def device_ids(self, batch):
        return torch.zeros(batch.capacity, dtype=torch.int32,
                           device=batch.device)


class RoundRobinPartitioner(Partitioner):
    """Rows cycle over the partitions by position. ``start`` stands for
    Spark's random per-task start, fixed so runs distribute alike. Ids are
    positional, so the exchange hands this partitioner a physical batch
    (live rows at the front)."""

    def __init__(self, n_parts: int, start: int = 0):
        self.n_parts = n_parts
        self.start = start % n_parts

    def device_ids(self, batch):
        iota = torch.arange(batch.capacity, dtype=torch.int32,
                            device=batch.device)
        return (iota + self.start) % self.n_parts


class HashPartitioner(Partitioner):
    """Spark murmur3 of the key columns, pmod ``n_parts``."""

    def __init__(self, keys: List[Expression], n_parts: int,
                 child_schema: T.Schema):
        self.n_parts = n_parts
        self._bound = [k.bind(child_schema) for k in keys]

    def device_ids(self, batch):
        cols = [e.eval_device(batch) for e in self._bound]
        return pmod_partition(spark_hash_columns_device(cols), self.n_parts)


def partitioner_factory(mode: str, n_parts: int, keys=None):
    """Factory handed to the exchange exec, called with its child (the
    range mode would sample it)."""

    def make(child) -> Partitioner:
        if mode == "single":
            return SinglePartitioner()
        if mode == "round_robin":
            return RoundRobinPartitioner(n_parts)
        if mode == "hash":
            return HashPartitioner(list(keys), n_parts, child.schema)
        if mode == "range":
            raise NotImplementedError(
                "range partitioning is not ported yet")
        raise ValueError(f"unknown partitioning mode '{mode}'")
    make.mode = mode
    make.keys = keys
    return make
