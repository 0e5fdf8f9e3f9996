"""The distributed group-by step — port of
``spark_rapids_tpu/parallel/distributed.py``.

One aggregation step over the mesh, the shape of a Spark stage boundary:

    per shard:  local group-by (group_ids + segment_reduce)
    exchange:   murmur3 pmod n of each group's key -> all_to_all
    per shard:  merge group-by of the received partials

The reference runs it as one ``shard_map`` program; here it is a loop
over the mesh's shards with the list collectives of :mod:`.mesh`.
"""

from __future__ import annotations

from typing import List

import torch

from .. import types as T
from ..data.column import DeviceColumn
from ..ops.kernels import groupby as KG
from ..shuffle import ici
from ..shuffle.partitioning import pmod_partition, spark_hash_columns_device
from .mesh import Mesh


def _groupby_sum_count(key, key_valid, val, val_valid, live, n_rows,
                       key_dtype):
    """Local sort-based group-by: ``(group key, its validity, sum, count,
    n_groups, group_live)`` as dense group rows at the input's
    capacity."""
    cap = key.shape[0]
    kcol = DeviceColumn(torch.where(live, key, 0), key_valid & live,
                        key_dtype)
    seg, n_groups, firsts = KG.group_ids([kcol], n_rows)
    gsum, counts = KG.segment_reduce(val, val_valid & live, seg, cap, "sum",
                                     live)
    gkeys = KG.gather_group_keys([kcol], firsts, n_groups)[0]
    group_live = torch.arange(cap, device=key.device) < n_groups
    return gkeys.data, gkeys.validity, gsum, counts, n_groups, group_live


def _fit(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` cut or zero-padded to ``n`` rows."""
    if x.shape[0] >= n:
        return x[:n]
    return torch.cat([x, torch.zeros(n - x.shape[0], dtype=x.dtype,
                                     device=x.device)])


def distributed_sum_by_key(mesh: Mesh, key, key_valid, val, val_valid,
                           n_rows_per_shard, key_dtype=T.LONG):
    """Sum and count of ``val`` per ``key`` over the mesh.

    The inputs are global lanes whose leading dimension is the total
    capacity, split into ``mesh.size`` equal shards in order (shard ``s``
    owns rows ``[s * shard_cap, (s + 1) * shard_cap)``, as
    ``PartitionSpec(PART_AXIS)`` splits them); ``n_rows_per_shard`` holds
    each shard's live count. Every group lands on the shard that Spark's
    murmur3 of its key pmod ``mesh.size`` names. Returns ``(keys,
    key_validity, sums, counts, n_groups)``: the first four are global
    lanes laid out like the inputs (shard ``s``'s groups first in its
    rows), the last an int32 ``[mesh.size]``; all on the mesh's first
    device."""
    n_parts = mesh.size
    shard_cap = key.shape[0] // n_parts
    sends, send_valids = [], []
    for s, dev in enumerate(mesh.devices):
        rows = slice(s * shard_cap, (s + 1) * shard_cap)
        k, kv, v, vv = (t[rows].to(dev)
                        for t in (key, key_valid, val, val_valid))
        n = n_rows_per_shard[s].to(dev)
        live = torch.arange(shard_cap, device=dev) < n
        gk, gkv, gs, gc, _, group_live = _groupby_sum_count(
            k, kv, v, vv, live, n, key_dtype)
        kvalid = gkv & group_live
        h = spark_hash_columns_device([DeviceColumn(gk, kvalid, key_dtype)])
        send, send_valid, _ = ici.build_send_buffers(
            {"k": gk, "kv": kvalid, "s": gs, "c": gc},
            torch.ones(shard_cap, dtype=torch.bool, device=dev),
            pmod_partition(h, n_parts), group_live, n_parts, shard_cap)
        sends.append(send)
        send_valids.append(send_valid)
    recv, recv_valid = ici.exchange(mesh, sends, send_valids)

    outs: List[tuple] = []
    for r, rv in zip(recv, recv_valid):
        flat, _, n_recv = ici.flatten_received(r, rv)
        rcap = flat["k"].shape[0]
        rlive = torch.arange(rcap, device=rv.device) < n_recv
        kcol = DeviceColumn(flat["k"], flat["kv"] & rlive, key_dtype)
        seg, out_groups, firsts = KG.group_ids([kcol], n_recv)
        fsum, _ = KG.segment_reduce(flat["s"], rlive, seg, rcap, "sum",
                                    rlive)
        fcnt, _ = KG.segment_reduce(flat["c"], rlive, seg, rcap, "sum",
                                    rlive)
        out_keys = KG.gather_group_keys([kcol], firsts, out_groups)[0]
        out_live = torch.arange(rcap, device=rv.device) < out_groups
        outs.append((_fit(out_keys.data, shard_cap),
                     _fit(out_keys.validity & out_live, shard_cap),
                     _fit(fsum, shard_cap), _fit(fcnt, shard_cap),
                     out_groups.to(torch.int32).reshape(1)))
    dev0 = mesh.devices[0]
    return tuple(torch.cat([o[i].to(dev0) for o in outs]) for i in range(5))
