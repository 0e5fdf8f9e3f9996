"""The mesh exchange — port of ``spark_rapids_tpu/shuffle/ici.py``.

Every shard lays its rows out as ``[n_parts, bucket_cap]`` send buffers
by destination (:func:`build_send_buffers`), one all_to_all delivers
bucket ``d`` of every sender to shard ``d`` (:func:`exchange`), and each
receiver compacts what it got (:func:`flatten_received`). A bucket holds
at most ``bucket_cap`` rows per (sender, receiver) pair; rows past it are
counted as overflow, and the caller re-runs with larger buckets, the
join ladder's contract.

The buffers are dicts of lanes; lanes of one dtype move through one 2-D
scatter or gather (the reference's dtype batching).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from ..parallel.mesh import Mesh, all_to_all


def _dtype_batched(lanes: Sequence[torch.Tensor],
                   many: Callable[[torch.Tensor], torch.Tensor]
                   ) -> List[torch.Tensor]:
    """``many`` applied to ``[n, B]`` stacks of the 1-D ``lanes`` of one
    dtype; returns the per-lane results, in order."""
    out: List[torch.Tensor] = [None] * len(lanes)
    groups: Dict[torch.dtype, List[int]] = {}
    for i, lane in enumerate(lanes):
        groups.setdefault(lane.dtype, []).append(i)
    for idxs in groups.values():
        m = many(torch.stack([lanes[i] for i in idxs], dim=1))
        for j, i in enumerate(idxs):
            out[i] = m[..., j]
    return out


def build_send_buffers(values: Dict[str, torch.Tensor],
                       validity: torch.Tensor, part_id: torch.Tensor,
                       live: torch.Tensor, n_parts: int, bucket_cap: int):
    """Scatter rows into the ``[n_parts, bucket_cap]`` send layout:
    destination ``part_id``, rows in order within a bucket, dead rows
    dropped. ``values`` maps names to ``[cap]`` lanes. Returns ``(send
    values, send_valid, overflow)``: the lanes as ``[n_parts,
    bucket_cap]``, where a slot holds a row (and the row's ``validity``),
    and the count of live rows that did not fit (int64, on the device)."""
    cap = part_id.shape[0]
    dev = part_id.device
    pid = torch.where(live, part_id.to(torch.int64), n_parts)
    iota = torch.arange(cap, device=dev)
    sorted_pid, perm = torch.sort(pid, stable=True)
    # A row's rank in its bucket: its sorted position less where its
    # destination's run starts (the exclusive prefix sum of the bucket
    # sizes).
    sizes = torch.bincount(pid, minlength=n_parts + 1)
    starts = torch.cumsum(sizes, 0) - sizes
    rank = torch.empty(cap, dtype=torch.int64, device=dev)
    rank.scatter_(0, perm, iota - starts[sorted_pid])
    fits = live & (rank < bucket_cap)
    overflow = (live & ~fits).sum()
    slots = n_parts * bucket_cap
    target = torch.where(fits, pid * bucket_cap + rank, slots)

    def scatter(st: torch.Tensor) -> torch.Tensor:
        flat = torch.zeros((slots + 1, st.shape[1]), dtype=st.dtype,
                           device=dev)
        flat.index_copy_(0, target, st)
        return flat[:slots].reshape(n_parts, bucket_cap, st.shape[1])

    names = list(values)
    out = _dtype_batched([values[k] for k in names] + [validity & live],
                         scatter)
    send_valid = out.pop()
    return dict(zip(names, out)), send_valid, overflow


def exchange(mesh: Mesh, sends: Sequence[Dict[str, torch.Tensor]],
             send_valids: Sequence[torch.Tensor]):
    """All_to_all of every shard's send buffers: shard ``d`` receives row
    ``d`` of each sender's buffers, ``[n_parts (senders), bucket_cap]``.
    Returns ``(recv values per shard, recv_valid per shard)``."""
    names = list(sends[0])
    lanes = {k: all_to_all(mesh, [s[k] for s in sends]) for k in names}
    recv = [{k: lanes[k][d] for k in names} for d in range(mesh.size)]
    return recv, all_to_all(mesh, send_valids)


def flatten_received(recv: Dict[str, torch.Tensor],
                     recv_valid: torch.Tensor):
    """One shard's ``[n_parts, bucket_cap]`` received buffers as
    ``[n_parts * bucket_cap]`` lanes with the received rows first,
    grouped by sender in sender order, each sender's rows in their send
    order. Returns ``(lanes, valid, n_live)``; lanes past ``n_live`` are
    not meaningful and ``valid`` is false there."""
    valid = recv_valid.reshape(-1)
    cap = valid.shape[0]
    dev = valid.device
    pos = torch.cumsum(valid.to(torch.int64), 0) - 1
    src = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    src.scatter_(0, torch.where(valid, pos, cap),
                 torch.arange(cap, device=dev))
    src = src[:cap]
    n_live = valid.sum()
    names = list(recv)
    out = _dtype_batched([recv[k].reshape(-1) for k in names],
                         lambda st: st[src])
    valid_out = torch.arange(cap, device=dev) < n_live
    return dict(zip(names, out)), valid_out, n_live
