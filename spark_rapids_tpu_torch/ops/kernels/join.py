"""Equi-join kernels — port of ``spark_rapids_tpu/ops/kernels/join.py``.

Three paths, as in the reference:

* **Direct address** (:func:`dense_join`, :func:`dense_join_swapped`):
  a single integer key (unique on the table's side for an inner or left
  join; any for a semi or anti join) indexes a table of ``4 x capacity``
  slots; each probe row's match is two gathers. The table build and
  probe is the ``joinProbe`` CUDA kernel (:mod:`.cuda.join_probe`).
  Runtime conditions (unique keys, keys inside the table) are checked on
  the device and reported as a ``fail`` flag; the session re-runs a
  tripped site one mode up (build table -> swapped table -> exact path).
* **Exact, one key** (:func:`join_match_binsearch`): sort the build keys
  and binary-search every probe key for its match range.
* **Exact, general** (:func:`join_match`): several keys, string and
  float keys. One stable lexicographic sort of both sides, builds before
  probes inside a run of equal keys, gives every probe row its range of
  build ranks by prefix scans.

Both exact paths end in :func:`expand_matches_binsearch`, which expands
the ranges into (probe row, build row) pairs; :func:`left_outer_counts`
gives a left join's unmatched probe rows their one null-extended row.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ... import types as T
from ...data.batch import ColumnarBatch
from ...data.column import DeviceColumn
from ..strings_util import char_matrix
from .cuda import join_probe as JP
from .rowops import (gather_columns, lexsort, merged_dictionary_codes,
                     orderable_key)
from .window import run_of

#: Direct-address table size = key-side capacity x this factor.
_DENSE_TABLE_FACTOR = 4

_INT64_MAX = 2 ** 63 - 1


def _table_build_probe(slot: torch.Tensor, pslot: torch.Tensor, tbl: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Build the (count, first row) table over ``slot`` (pre-set to
    ``tbl`` for unusable rows) and probe it at ``pslot``. Returns
    ``(cnt_at_probe, row_at_probe, dup)``, ``dup`` the duplicate-key flag
    ``any(count > 1)``."""
    cnt_p, row_p, max_cnt = JP.dense_build_probe(
        slot.to(torch.int32).contiguous(), pslot.to(torch.int32).contiguous(),
        tbl)
    return cnt_p, row_p, max_cnt > 1


def dense_joinable(jt: str, keys) -> bool:
    """Static eligibility for the direct-address join: an inner, left,
    semi or anti join on a single fixed-width integer key (``keys`` are
    bound expressions)."""
    if jt not in ("inner", "left", "left_semi", "left_anti") \
            or len(keys) != 1:
        return False
    dt = keys[0].data_type
    return dt is not T.STRING and not dt.is_floating


def dense_join_swapped(probe: ColumnarBatch, build: ColumnarBatch,
                       pk: DeviceColumn, bk: DeviceColumn, out_schema):
    """Inner join, dense mode 2: the PROBE side's keys are unique, so the
    table builds over the probe and every build row gathers its single
    probe match. Output at build capacity, lazy, probe columns first."""
    cap_p = pk.capacity
    tbl = cap_p * _DENSE_TABLE_FACTOR
    usable_p = probe.row_mask() & pk.validity
    kp = pk.data.long()
    in_range_p = (kp >= 0) & (kp < tbl)
    slot = torch.where(usable_p & in_range_p, kp, tbl)

    usable_b = build.row_mask() & bk.validity
    kb = bk.data.long()
    in_range_b = usable_b & (kb >= 0) & (kb < tbl)
    bslot = torch.where(in_range_b, kb, 0)

    cnt_b, row_b, dup = _table_build_probe(slot, bslot, tbl)
    fail = (usable_p & ~in_range_p).any() | dup
    matched = in_range_b & (cnt_b > 0)
    pcols = gather_columns(probe.columns, row_b.clamp(0, cap_p - 1), matched)
    return ColumnarBatch(pcols + tuple(build.columns), matched.sum(),
                         out_schema, live=matched), fail


def dense_join(probe: ColumnarBatch, build: ColumnarBatch,
               pk: DeviceColumn, bk: DeviceColumn, out_schema,
               jt: str = "inner"):
    """Direct-address join, dense mode 1: the table builds over the build
    side and every probe row looks up its match. Output stays lazy at
    probe capacity. An inner or left join needs UNIQUE build keys and
    gathers the build row (inner: live = matched; left: every live probe
    row stays live, its build columns valid where it matched); a semi or
    anti join only tests membership, so duplicate build keys are fine
    there, and it keeps the probe columns (live = matched, or live and
    unmatched). Returns ``(batch, fail)``: ``fail`` is a device bool,
    true when build keys were outside the table or, for an inner or left
    join, duplicated."""
    cap_b = bk.capacity
    tbl = cap_b * _DENSE_TABLE_FACTOR
    usable_b = build.row_mask() & bk.validity
    kb = bk.data.long()
    in_range_b = (kb >= 0) & (kb < tbl)
    slot = torch.where(usable_b & in_range_b, kb, tbl)

    live_p = probe.row_mask()
    kp = pk.data.long()
    in_range_p = live_p & pk.validity & (kp >= 0) & (kp < tbl)
    pslot = torch.where(in_range_p, kp, 0)

    cnt_p, row_p, dup = _table_build_probe(slot, pslot, tbl)
    fail = (usable_b & ~in_range_b).any()
    matched = in_range_p & (cnt_p > 0)
    if jt in ("left_semi", "left_anti"):
        keep = matched if jt == "left_semi" else live_p & ~matched
        return ColumnarBatch(probe.columns, keep.sum(), out_schema,
                             live=keep), fail
    fail = fail | dup
    bcols = gather_columns(build.columns, row_p.clamp(0, cap_b - 1), matched)
    keep = matched if jt == "inner" else live_p
    return ColumnarBatch(tuple(probe.columns) + bcols, keep.sum(),
                         out_schema, live=keep), fail


def binsearch_joinable(key: DeviceColumn) -> bool:
    """A key qualifies for the binary-search path when it is fixed width,
    not a string (codes of two dictionaries do not compare) and not a
    float (NaN normalization needs the bucket operand)."""
    return not key.is_string and not key.dtype.is_floating


def join_match_binsearch(build_key: DeviceColumn, probe_key: DeviceColumn,
                         live_b: torch.Tensor, live_p: torch.Tensor):
    """Sort only the build keys and find every probe key's match range by
    two binary searches. Returns ``(lo, counts, build_at_rank)``: a probe
    row's matches are build rows ``build_at_rank[lo : lo + count]``.
    Unusable build rows carry an INT64_MAX sentinel and sort last (a
    usable flag as second operand keeps real INT64_MAX keys ahead of
    them); ranks clamp to the usable count."""
    kb, _ = orderable_key(build_key)
    kp, _ = orderable_key(probe_key)
    usable_b = live_b & build_key.validity
    kb = torch.where(usable_b, kb.long(), _INT64_MAX)
    n_usable = usable_b.sum()
    build_at_rank = lexsort([kb, (~usable_b).to(torch.int8)])
    sorted_kb = kb[build_at_rank].contiguous()
    kp64 = kp.long().contiguous()
    lo = torch.searchsorted(sorted_kb, kp64, side="left")
    hi = torch.searchsorted(sorted_kb, kp64, side="right")
    lo = torch.minimum(lo, n_usable)
    hi = torch.minimum(hi, n_usable)
    usable_p = live_p & probe_key.validity
    counts = torch.where(usable_p, hi - lo, 0)
    return lo, counts, build_at_rank


def expand_matches_binsearch(lo: torch.Tensor, counts: torch.Tensor,
                             build_at_rank: torch.Tensor, out_capacity: int):
    """(probe_idx, build_idx) for every match, by a binary search of each
    output slot over the cumulative counts. Returns ``(probe_idx[out_cap],
    build_idx[out_cap], n_out, total)``; ``total`` may exceed the
    capacity, and the caller re-runs bigger."""
    offsets = torch.cumsum(counts, 0)
    total = offsets[-1]
    starts = offsets - counts
    k = torch.arange(out_capacity, device=counts.device)
    probe_idx = torch.searchsorted(offsets.contiguous(), k, side="right")
    safe_probe = probe_idx.clamp(0, counts.shape[0] - 1)
    build_rank = lo[safe_probe] + (k - starts[safe_probe])
    build_idx = build_at_rank[build_rank.clamp(0, build_at_rank.shape[0] - 1)]
    n_out = torch.clamp(total, max=out_capacity)
    return safe_probe, build_idx, n_out, total


def left_outer_counts(counts: torch.Tensor, live_p: torch.Tensor
                      ) -> torch.Tensor:
    """A left join's expansion counts: an unmatched live probe row still
    emits one (null-extended) row."""
    return torch.where(live_p & (counts == 0), 1, counts)


def _join_operands(b: DeviceColumn, p: DeviceColumn) -> List[torch.Tensor]:
    """Sort operands of one key over the build rows then the probe rows,
    equal exactly where the keys are equal (null rows aside: they never
    match). Two dictionary strings remap into one merged dictionary (one
    code operand); other strings take one operand per char-matrix column
    at the wider side's width; a float key adds its NaN bucket (NaN joins
    NaN, -0.0 joins 0.0); an integer key's bucket marks only nulls, so
    it is left out."""
    if b.is_string:
        if b.is_dict and p.is_dict:
            _, (cb, cp) = merged_dictionary_codes([b, p])
            return [torch.cat([cb, cp])]
        w = max(b.max_bytes, p.max_bytes, 1)
        m = torch.cat([char_matrix(b, w), char_matrix(p, w)])
        return [m[:, i] for i in range(w)]
    kb, nbb = orderable_key(b)
    kp, nbp = orderable_key(p)
    keys = torch.cat([kb, kp])
    if not b.dtype.is_floating:
        return [keys]
    return [torch.cat([nbb, nbp]), keys]


def join_match(build_keys: Sequence[DeviceColumn],
               probe_keys: Sequence[DeviceColumn], live_b: torch.Tensor,
               live_p: torch.Tensor, need_build_hits: bool = False):
    """The general equi-join matcher: any number of keys, string and float
    keys included. One stable lexicographic sort of both sides (usable
    rows first, then the keys, builds before probes inside a run of
    equal keys) puts each probe row after exactly the build rows it
    matches, so prefix counts give its range: ``hi`` = builds at or
    before it, ``lo`` = builds before its run's start. A scatter routes
    the ranges back to probe order and the build rows to their ranks.

    Returns ``(lo, counts, build_at_rank)`` with the contract of
    :func:`join_match_binsearch`: a probe row's matches are build rows
    ``build_at_rank[lo : lo + count]``; null-keyed and dead rows match
    nothing. ``need_build_hits`` (full and right outer joins) is not
    ported and raises."""
    if need_build_hits:
        raise NotImplementedError(
            "full and right outer joins (the build rows' hit mask) are not "
            "ported yet")
    cap_b = build_keys[0].capacity
    cap_p = probe_keys[0].capacity
    total = cap_b + cap_p
    dev = live_b.device
    null_key = torch.zeros(total, dtype=torch.bool, device=dev)
    operands: List[torch.Tensor] = []
    for b, p in zip(build_keys, probe_keys):
        null_key = null_key | ~torch.cat([b.validity, p.validity])
        operands.extend(_join_operands(b, p))
    usable = torch.cat([live_b, live_p]) & ~null_key
    iota = torch.arange(total, device=dev)
    is_build = iota < cap_b
    unusable_flag = (~usable).to(torch.int8)
    perm = lexsort([unusable_flag] + operands
                   + [(~is_build).to(torch.int8)])
    # Runs break where a key changes or at the usable/unusable junction;
    # the side flag does not break them.
    eq = torch.ones(total, dtype=torch.bool, device=dev)
    for o in [unusable_flag] + operands:
        s = o[perm]
        eq[1:] &= s[1:] == s[:-1]
    run_start = ~eq
    run_start[0] = True
    usable_sorted = usable[perm]
    s_isbuild = perm < cap_b
    b_incl = torch.cumsum(s_isbuild.to(torch.int64), 0)
    # builds before each run's first row, read through its run number
    run, starts = run_of(run_start)
    lo_run = (b_incl - s_isbuild.to(torch.int64))[
        starts[run].clamp(max=total - 1)]
    probe_sorted = usable_sorted & ~s_isbuild
    lo_s = torch.where(probe_sorted, lo_run, 0)
    count_s = torch.where(probe_sorted, b_incl - lo_run, 0)
    # Route back: probe rows to their original positions, build rows to
    # their global rank (the sort's order of build rows).
    p_at = torch.where(s_isbuild, cap_p, perm - cap_b)
    lo_pad = torch.zeros(cap_p + 1, dtype=torch.int64, device=dev)
    cnt_pad = torch.zeros(cap_p + 1, dtype=torch.int64, device=dev)
    lo_pad.scatter_(0, p_at, lo_s)
    cnt_pad.scatter_(0, p_at, count_s)
    lo, counts = lo_pad[:cap_p], cnt_pad[:cap_p]
    rank = torch.where(s_isbuild, b_incl - 1, cap_b)
    rank_pad = torch.zeros(cap_b + 1, dtype=torch.int64, device=dev)
    rank_pad.scatter_(0, rank, perm)
    build_at_rank = rank_pad[:cap_b]
    return lo, counts, build_at_rank
