#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spark_rapids_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--lineitem-rows N] [--seed S] [--profile]

Phases; each one passes or the script exits non-zero:

1. build the CUDA kernels from ``spark_rapids_tpu_torch/ops/kernels/cuda/
   csrc`` (one ``nvcc`` per source, all at once); print the card's name and
   power limit;
2. hold each kernel against its plain PyTorch version on the card, on edge
   cases: for ``joinProbe`` duplicate keys, empty tables, one live row, all
   rows dead; for ``segmented`` int8 to int64 lanes (int8/int16 sums that
   wrap), float32 and float64 lanes with +/-0.0 and NaN, 1, 2, 3 and 8
   lanes, one group, one group per row, a group ending on a 1024-row tile
   boundary, one group over many tiles, ids above 0, negative leading
   ids, every row dead, no rows; for ``sortStep`` one lane, the
   single-block threshold (4096 lanes) and one below and above it, all
   lanes dead, random unique lanes up to 1,000,003, lanes where no digit
   varies, only the dead field varies, a date-shaped key, or the index
   bits are a permutation, up to 2^23 + 1 (the live radix passes printed
   from 2^20 lanes up); each call must count one launch; for
   the ``strings`` gather W 8 and 128, all or no rows valid, indices out of
   range on both sides, more and fewer rows out than in; for ``hash`` n 1,
   255, 256, 257 and 100,003 rows by W 4, 8, 128 and 1024, lengths 0-5
   and W, bytes >= 128, all-PAD rows and random per-row seeds; for the
   rowwise compare (``stringsEqual``) n 1, 7, 8,191 and 100,003 by W 8,
   12, 128 and 1,024, rows that differ only in their last char or only
   at a PAD position, all-PAD rows, chars above 127, and the row views
   ``m[1:]`` / ``m[:-1]`` of one matrix. Outputs equal bit for bit;
   ``hash`` also equals this script's own numpy murmur3;
3. TPC-H Q3, Q1, Q4, Q6 and Q22 at SF1 (6,001,215 lineitem rows by
   default), all of lineitem sorted by ``l_shipdate``, and Q1 over
   ``lineitem.repartition(16, l_returnflag, l_linestatus)`` (``q1_hash_str``)
   and over ``lineitem.repartition(4, l_orderkey)`` (``q1_hash_key``),
   through ``TorchSession`` on ``cuda``: each answer must match an
   independent numpy implementation written here, and the kernels of each
   query's path must have launched during it (counts set to 0 just
   before, read just after): ``joinProbe`` and ``segmented`` in Q3,
   ``sortStep`` in Q4 and the sort, the ``strings`` gather in Q22,
   ``hash`` and ``segmented`` (the merge aggregate) in ``q1_hash_str``.
   Then each exchange alone: every lineitem row must land in the
   partition this script's numpy murmur3 pmod n names. Then
   ``group_ids`` (with ``segment_reduce`` and ``gather_group_keys``) over
   lineitem's dictionary ``l_shipmode`` and Q22's flat ``cntrycode``:
   groups, keys and row counts equal to numpy's ``np.unique``, the
   rowwise compare (``stringsEqual``) launched. Then Q1, Q3, Q4 and Q6
   with ``spark.rapids.tpu.mesh.enabled`` over a mesh of four shards on
   the card (``[cuda:0] * 4``): the same numpy answers, every run on the
   mesh path over 4 shards, ``hash`` launched by Q1's and Q4's
   exchanges, ``sortStep`` by Q4's range sort, ``segmented`` by Q3's
   aggregate; Q6 once more on the session's default mesh (every visible
   card); and ``distributed_sum_by_key`` of ``l_partkey`` by
   ``l_suppkey`` over the 4 shards: sums and counts equal to numpy's,
   every group on the shard numpy murmur3 pmod 4 names;
4. at the shapes the queries gave each kernel: kernel vs plain version
   (equal bit for bit), median times over CUDA events with the L2 flushed
   between launches, the memory bound, and a PyTorch library yardstick;
   the sort exec's permutation of SF1 lineitem by ``l_shipdate`` through
   ``sortStep`` against the stable lexsort route; the rowwise compare at
   the ``group_ids`` shapes; and the char matrix that feeds ``hash``;
5. one JSON line with every kernel, then the last line
   ``{"ok": true, "device": {...}}``.

Without CUDA, or without the package beside it, it exits non-zero and
prints no result. Long build logs go to ``chiprun_out/``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

#: H100 SXM device memory rate (NVIDIA data sheet), bytes per second.
HBM_BYTES_PER_S = 3.35e12
#: Clock cycles of the spin ahead of each timed launch (~1 ms at 1.98 GHz).
SPIN_CYCLES = 2_000_000
D_1994_01_01 = 8766
D_1995_01_01 = 9131
D_1995_03_15 = 9204
D_1998_09_02 = 10471
Q22_CODES = ["13", "31", "23", "29", "30", "18", "17"]
#: Float sums and averages against numpy: the card adds in another order.
REV_RTOL = 1e-9
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"


#: Spark's murmur3 seed of a row hash (``HashPartitioning``).
SPARK_SEED = 42


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# --------------------------------------------------------------------------
# timing helpers
# --------------------------------------------------------------------------


def median_ms(torch, fn, flush, reps: int = 15) -> float:
    """Median device time of ``fn()`` over CUDA events, the L2 flushed
    (a 256 MB write, untimed) before every launch. A spin of about 1 ms
    queued behind the flush keeps the card busy while the host enqueues
    ``fn``, so the host's dispatch time (a wrapper's checks and
    allocations) stays out of the events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bits_equal(torch, a, b) -> bool:
    """Bit-for-bit equality (floats compared as their integer bits)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        width = {torch.float64: torch.int64, torch.float32: torch.int32}
        return torch.equal(a.contiguous().view(width[a.dtype]),
                           b.contiguous().view(width[b.dtype]))
    return torch.equal(a, b)


def max_abs_err(torch, a, b) -> float:
    """Largest |a - b| over the entries where neither side is NaN."""
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    d = d[~torch.isnan(d)]
    return float(d.max()) if d.numel() else 0.0


# --------------------------------------------------------------------------
# phase 2: edge cases
# --------------------------------------------------------------------------


def joinprobe_edge_cases(torch, JP, rng, dev):
    cases = {}
    cap_b, cap_p = 4096, 8192
    tbl = 4 * cap_b
    kb = rng.integers(0, tbl // 2, cap_b)
    kb[1] = kb[0]
    cases["duplicate keys"] = (kb, rng.integers(0, tbl, cap_p))
    cases["every probed slot empty"] = (
        rng.integers(0, tbl // 2, cap_b), rng.integers(tbl // 2, tbl, cap_p))
    one = np.full(cap_b, tbl)
    one[cap_b // 3] = 17
    cases["one live row"] = (one, rng.integers(0, tbl, cap_p))
    cases["all rows dead"] = (np.full(cap_b, tbl), rng.integers(0, tbl, cap_p))
    wild = rng.integers(-tbl, 2 * tbl, cap_b)
    cases["out-of-range slots"] = (wild, rng.integers(-5, tbl + 5, cap_p))
    for name, (b, p) in cases.items():
        bs = torch.as_tensor(b, dtype=torch.int32, device=dev)
        ps = torch.as_tensor(p, dtype=torch.int32, device=dev)
        got = JP.dense_build_probe(bs, ps, tbl)
        want = JP.dense_build_probe_plain(bs, ps, tbl)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("count", "row", "max")):
            check(bits_equal(torch, g, w),
                  f"joinProbe '{name}': {what} differs from the plain version")
        print(f"  joinProbe {name}: equal")


def segmented_gids(rng, n: int, cap: int) -> dict:
    """Sorted int32 group ids of the segmented edge cases, by name: the
    kernel works by 1024-row tiles, so several cases aim at tiles."""
    sizes = rng.integers(1, 9, n)
    g = np.repeat(np.arange(len(sizes)), sizes)[:n]
    r = np.arange(n)
    dead_tail = g.copy()
    dead_tail[-1000:] = cap  # the sort path's dead rows
    many = np.where(r < 100, g, g[100])
    many[n - 50:] = g[100] + 1 + np.arange(50) // 3
    gids = {"random groups": g, "dead tail": dead_tail,
            "one group": np.zeros(n, dtype=np.int64),
            "one group per row": np.arange(n),
            "tile boundary": 2 * (r // 1024) + (r % 1024 >= 1000),
            "one group over many tiles": many,
            "ids above 0": g + 5,
            "negative leading ids": np.where(
                r < 150, -3, np.where(r < 300, -1, g - g[300])),
            "all dead": np.full(n, cap),
            "no rows": np.zeros(0, dtype=np.int64)}
    return {k: v.astype(np.int32) for k, v in gids.items()}


def segmented_edge_cases(torch, SEG, rng, dev):
    n = 50_000
    cap = 65_536
    gids = segmented_gids(rng, n, cap)
    big = 2 ** 62
    lanes = {
        "int64 [n]": rng.integers(-big, big, n, dtype=np.int64),
        "int64 [n,3]": rng.integers(-big, big, (n, 3), dtype=np.int64),
        "int64 [n,8]": rng.integers(-big, big, (n, 8), dtype=np.int64),
        "int32 [n]": rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64
                                  ).astype(np.int32),
        "int8 [n] wrapping sums": rng.integers(60, 128, n).astype(np.int8),
        "int16 [n,8] wrapping sums": rng.integers(
            -32768, -20000, (n, 8)).astype(np.int16),
    }
    f = rng.normal(size=(n, 2))
    f[rng.random((n, 2)) < 0.05] = 0.0
    f[rng.random((n, 2)) < 0.05] = -0.0
    f[rng.random((n, 2)) < 0.01] = np.nan
    lanes["float64 [n,2] +/-0 NaN"] = f
    f32 = rng.normal(size=(n, 3)).astype(np.float32)
    f32[rng.random((n, 3)) < 0.05] = 0.0
    f32[rng.random((n, 3)) < 0.05] = -0.0
    f32[rng.random((n, 3)) < 0.01] = np.nan
    lanes["float32 [n,3] +/-0 NaN"] = f32
    lanes["float64 [n] +/-0"] = np.where(rng.random(n) < 0.5, 0.0, -0.0)
    for gname, g in gids.items():
        gt = torch.as_tensor(g, dtype=torch.int32, device=dev)
        for lname, x in lanes.items():
            xt = torch.as_tensor(x[:len(g)], device=dev)
            for op in ("sum", "min", "max"):
                if not SEG.eligible(xt, op):
                    continue
                before = SEG.segment_reduce_sorted.launches
                got = SEG.segment_reduce_sorted(xt, gt, cap, op)
                want = SEG.segment_reduce_sorted_plain(xt, gt, cap, op)
                torch.cuda.synchronize()
                check(SEG.segment_reduce_sorted.launches
                      == before + int(xt.is_cuda),
                      f"segmented {op} '{lname}' over '{gname}' did not "
                      "count one launch")
                check(bits_equal(torch, got, want),
                      f"segmented {op} '{lname}' over '{gname}' differs "
                      "from the plain version")
        print(f"  segmented {gname}: sum/min/max equal on every lane")


def packed_lanes(rng, n: int, dead: float = 0.2) -> np.ndarray:
    """Unique packed sortStep lanes: ``[field][key + 2**31][row index]``
    with random null buckets, dead rows and 32-bit keys."""
    field = rng.integers(1, 8, n)
    field[rng.random(n) < dead] = 8
    u = rng.integers(0, 2 ** 32, n)
    return (field.astype(np.int64) << 59) | (u.astype(np.int64) << 27) \
        | np.arange(n, dtype=np.int64)


def shaped_lanes(rng, n: int, shape: str) -> np.ndarray:
    """Packed lanes whose digits vary only where ``shape`` says: a
    constant key and field, only the dead/bucket field, a date-shaped key
    (~2,500 days, a fifth dead), or random keys over a permuted index."""
    iota = np.arange(n, dtype=np.int64)
    field = np.full(n, 4)
    u = np.full(n, 2 ** 31 + 9131)
    if shape in ("dead field", "date key"):
        field[rng.random(n) < 0.2] = 8
    if shape == "date key":
        u = 2 ** 31 + rng.integers(8036, 10_562, n)
    if shape == "index permutation":
        return (packed_lanes(rng, n) & ~((1 << 27) - 1)) \
            | rng.permutation(n).astype(np.int64)
    return (field.astype(np.int64) << 59) | (u.astype(np.int64) << 27) | iota


def sortstep_edge_cases(torch, SS, rng, dev):
    small = SS.SMALL_LANES
    cases = {"one lane": packed_lanes(rng, 1),
             f"single-block threshold ({small})": packed_lanes(rng, small),
             f"one below it ({small - 1})": packed_lanes(rng, small - 1),
             f"one above it ({small + 1})": packed_lanes(rng, small + 1),
             "all lanes dead": packed_lanes(rng, 3000, dead=1.0),
             "all lanes dead (100,000)": packed_lanes(rng, 100_000, dead=1.0)}
    for n in (1000, 4096, 4097, 1_000_003):
        cases[f"random unique {n}"] = packed_lanes(rng, n)
    for shape in ("constant lane", "dead field", "date key",
                  "index permutation"):
        for n in (100_000, 1 << 20):
            cases[f"{shape} {n}"] = shaped_lanes(rng, n, shape)
    cases["index permutation 2^23 + 1"] = shaped_lanes(
        rng, (1 << 23) + 1, "index permutation")
    for name, lane in cases.items():
        lt = torch.as_tensor(lane, device=dev)
        before = SS.packed_argsort.launches
        got = SS.packed_argsort(lt)
        check(SS.packed_argsort.launches == before + int(lt.is_cuda),
              f"sortStep '{name}' did not count one launch")
        want = SS.packed_argsort_plain(lt)
        torch.cuda.synchronize()
        check(bits_equal(torch, got, want),
              f"sortStep '{name}': permutation differs from the plain version")
        if lt.is_cuda and lt.numel() >= 1 << 20:
            got, passes = SS.packed_argsort_passes(lt)
            check(bits_equal(torch, got, want), f"sortStep '{name}': the "
                  "second call differs from the plain version")
            print(f"  sortStep {name}: equal, {passes} live radix passes")
        else:
            print(f"  sortStep {name}: equal")


def strings_edge_cases(torch, SG, rng, dev):
    for w in (8, 128):
        for name, (n, m) in {"all valid": (512, 512),
                             "none valid": (512, 512),
                             "indices out of range": (512, 512),
                             "more rows out than in": (300, 1000),
                             "fewer rows out than in": (1000, 300)}.items():
            lens = rng.integers(0, w + 1, n)
            mat = rng.integers(0, 256, (n, w)).astype(np.int16)
            mat[np.arange(w)[None, :] >= lens[:, None]] = -1
            idx = rng.integers(0, n, m)
            if name == "indices out of range":
                idx = rng.integers(-50, n + 50, m)
            valid = rng.random(m) < 0.8
            valid[:] = True if name == "all valid" else valid
            valid[:] = False if name == "none valid" else valid
            mt = torch.as_tensor(mat, device=dev)
            it = torch.as_tensor(idx.astype(np.int32), device=dev)
            vt = torch.as_tensor(valid, device=dev)
            got = SG.ragged_gather(mt, it, vt)
            want = SG.ragged_gather_plain(mt, it, vt)
            torch.cuda.synchronize()
            check(bits_equal(torch, got, want),
                  f"strings gather '{name}' W={w}: rows differ from the "
                  "plain version")
        print(f"  strings gather W={w}: every case equal")


def row_equal_pair(rng, n: int, w: int):
    """(a, b) int16 [n, W] char matrices of one rowwise-compare case:
    PAD-ended rows of bytes over the whole 0-255 range (chars above 127
    included), every fifth row all PAD in both; of the rest, rows of
    ``b`` that differ from ``a`` only in their last char, only at one
    PAD position (a PAD made a byte), or only by a byte made PAD."""
    lens = rng.integers(0, w + 1, n)
    lens[::5] = 0
    a = rng.integers(0, 256, (n, w)).astype(np.int16)
    a[np.arange(w)[None, :] >= lens[:, None]] = -1
    b = a.copy()
    kind = rng.integers(0, 4, n)
    rows = np.flatnonzero((kind == 1) & (lens > 0))
    b[rows, lens[rows] - 1] = (b[rows, lens[rows] - 1] + 1) % 256
    rows = np.flatnonzero((kind == 2) & (lens < w))
    b[rows, w - 1] = 7
    rows = np.flatnonzero((kind == 3) & (lens > 0))
    b[rows, 0] = -1
    return a, b


def row_equal_edge_cases(torch, SG, rng, dev):
    for w in (8, 12, 128, 1024):
        for n in (1, 7, 8191, 100_003):
            a, b = (torch.as_tensor(x, device=dev)
                    for x in row_equal_pair(rng, n, w))
            for x, y, what in ((a, b, "a vs b"), (a, a, "a vs a"),
                               (a[1:], a[:-1], "views m[1:] vs m[:-1]")):
                got = SG.ragged_row_equal(x, y)
                want = SG.ragged_row_equal_plain(x, y)
                torch.cuda.synchronize()
                check(bits_equal(torch, got, want),
                      f"strings compare n={n} W={w} {what}: differs from "
                      "the plain version")
            check(not bool(SG.ragged_row_equal(a, b).all()) or n < 8,
                  f"strings compare n={n} W={w}: no differing row found")
        print(f"  strings compare W={w}: n 1/7/8191/100003 equal to the "
              "plain version (a vs b, a vs a, the row views)")


def _np_rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _np_mix_k1(k):
    return _np_rotl(k * np.uint32(0xCC9E2D51), 15) * np.uint32(0x1B873593)


def _np_mix_h1(h, k):
    return _np_rotl(h ^ k, 13) * np.uint32(5) + np.uint32(0xE6546B64)


def _np_fmix(h, length):
    h = h ^ length
    h = (h ^ (h >> np.uint32(16))) * np.uint32(0x85EBCA6B)
    h = (h ^ (h >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def np_murmur3_bytes(raw: np.ndarray, lengths: np.ndarray,
                     seed: np.ndarray) -> np.ndarray:
    """Spark's ``Murmur3_x86_32.hashUnsafeBytes`` in numpy uint32, written
    here independently of the port: ``raw`` uint8 [n, W] (row r's bytes
    first), byte ``lengths`` [n], ``seed`` uint32 [n]. Whole 4-byte
    little-endian blocks, then each tail byte as a signed Java byte, then
    fmix with the length."""
    n, w = raw.shape
    lengths = np.asarray(lengths, np.int64)
    with np.errstate(over="ignore"):
        h = np.asarray(seed, np.uint32).copy()
        m = raw.astype(np.uint32)
        blocks = np.minimum(np.maximum(lengths, 0) // 4, w // 4)
        for b in range(w // 4):
            k = m[:, 4 * b] | (m[:, 4 * b + 1] << np.uint32(8)) \
                | (m[:, 4 * b + 2] << np.uint32(16)) \
                | (m[:, 4 * b + 3] << np.uint32(24))
            h = np.where(b < blocks, _np_mix_h1(h, _np_mix_k1(k)), h)
        end = np.clip(lengths, 0, w)
        rows = np.arange(n)
        for j in range(3):
            pos = blocks * 4 + j
            byte = raw[rows, np.minimum(pos, max(w - 1, 0))].astype(np.int32)
            k = np.where(byte > 127, byte - 256, byte).astype(np.uint32)
            h = np.where(pos < end, _np_mix_h1(h, _np_mix_k1(k)), h)
        return _np_fmix(h, lengths.astype(np.uint32))


def np_hash_strings(values: np.ndarray, seed: np.ndarray) -> np.ndarray:
    """Spark's murmur3 of each UTF-8 string of ``values`` (no nulls),
    ``seed`` uint32 [n]; encodes each distinct value once."""
    uniq, inv = np.unique(np.asarray(values).astype(str), return_inverse=True)
    enc = [u.encode("utf-8") for u in uniq]
    w = max(4, -(-max([len(e) for e in enc] + [1]) // 4) * 4)
    mat = np.zeros((len(enc), w), np.uint8)
    for i, e in enumerate(enc):
        mat[i, :len(e)] = np.frombuffer(e, np.uint8)
    lens = np.array([len(e) for e in enc], np.int64)
    return np_murmur3_bytes(mat[inv], lens[inv], seed)


def np_hash_longs(values: np.ndarray, seed: np.ndarray) -> np.ndarray:
    """Spark's murmur3 of int64 values: low word, high word, fmix 8."""
    v = np.asarray(values, np.int64).view(np.uint64)
    with np.errstate(over="ignore"):
        lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (v >> np.uint64(32)).astype(np.uint32)
        h = _np_mix_h1(np.asarray(seed, np.uint32), _np_mix_k1(lo))
        h = _np_mix_h1(h, _np_mix_k1(hi))
        return _np_fmix(h, np.uint32(8))


def np_pmod(h: np.ndarray, n_parts: int) -> np.ndarray:
    return np.mod(h.view(np.int32).astype(np.int64), n_parts)


def hash_case(rng, n: int, w: int):
    """(mat int16 [n, W] PAD-ended, lengths int32, seed uint32 bits as
    int32) of one ``hash`` edge case: lengths 0-5 and W and random,
    bytes over the whole 0-255 range, every eleventh row all PAD."""
    lengths = rng.integers(0, w + 1, n)
    pick = rng.random(n)
    for lo, hi, val in ((0.0, 0.3, None), (0.3, 0.4, w)):
        sel = (pick >= lo) & (pick < hi)
        lengths[sel] = rng.integers(0, 6, int(sel.sum())) if val is None \
            else val
    lengths = np.minimum(lengths, w)
    mat = rng.integers(0, 256, (n, w)).astype(np.int16)
    lengths[::11] = 0
    mat[np.arange(w)[None, :] >= lengths[:, None]] = -1
    seed = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    return mat, lengths.astype(np.int32), seed.view(np.int32)


def hash_edge_cases(torch, HK, rng, dev):
    for w in (4, 8, 128, 1024):
        for n in (1, 255, 256, 257, 100_003):
            mat, lengths, seed = hash_case(rng, n, w)
            mt, lt, st = (torch.as_tensor(a, device=dev)
                          for a in (mat, lengths, seed))
            got = HK.murmur3_bytes_rows(mt, lt, st)
            want = HK.murmur3_bytes_rows_plain(mt, lt, st)
            torch.cuda.synchronize()
            check(bits_equal(torch, got, want),
                  f"hash n={n} W={w}: differs from the plain version")
            raw = np.where(mat < 0, 0, mat).astype(np.uint8)
            ref = np_murmur3_bytes(raw, lengths, seed.view(np.uint32))
            check(np.array_equal(got.cpu().numpy().view(np.uint32), ref),
                  f"hash n={n} W={w}: differs from the numpy murmur3")
        print(f"  hash W={w}: n 1/255/256/257/100003 equal to the plain "
              "version and to numpy")


# --------------------------------------------------------------------------
# phase 3: Q3 and its numpy reference
# --------------------------------------------------------------------------


def numpy_q3(tables, k: int = 11):
    """Q3 in plain numpy, independent of the port: sorted-key joins by
    ``np.searchsorted``, a lexsort group-by, a stable descending sort.
    Returns the first ``k`` rows (orderkey, orderdate, revenue)."""
    c = tables["customer"].columns
    o = tables["orders"].columns
    li = tables["lineitem"].columns
    cust = np.sort(c["c_custkey"][c["c_mktsegment"] == "BUILDING"])
    om = o["o_orderdate"] < D_1995_03_15
    okey, ocust, odate = (o["o_orderkey"][om], o["o_custkey"][om],
                          o["o_orderdate"][om])
    pos = np.minimum(np.searchsorted(cust, ocust), max(len(cust) - 1, 0))
    hit = (len(cust) > 0) & (cust[pos] == ocust)
    okey, odate = okey[hit], odate[hit]
    lm = li["l_shipdate"] > D_1995_03_15
    lkey = li["l_orderkey"][lm]
    rev = li["l_extendedprice"][lm] * (1.0 - li["l_discount"][lm])
    order = np.argsort(okey, kind="stable")
    sk = okey[order]
    pos = np.minimum(np.searchsorted(sk, lkey), max(len(sk) - 1, 0))
    hit = (len(sk) > 0) & (sk[pos] == lkey)
    gkey, gdate, grev = lkey[hit], odate[order[pos[hit]]], rev[hit]
    srt = np.lexsort((gdate, gkey))
    gkey, gdate, grev = gkey[srt], gdate[srt], grev[srt]
    start = np.flatnonzero(np.r_[True, (gkey[1:] != gkey[:-1])
                                 | (gdate[1:] != gdate[:-1])])
    sums = np.add.reduceat(grev, start) if len(start) else grev[:0]
    top = np.argsort(-sums, kind="stable")[:k]
    return gkey[start][top], gdate[start][top], sums[top]


def check_q3(got, ref, n: int = 10) -> None:
    """Keys and dates exact, revenue to ``REV_RTOL``, order exact except
    inside runs of revenues equal to the tolerance, which compare as sets
    (a run that crosses rank ``n`` may contribute any of its members)."""
    gk, gd, gr = (got.columns["o_orderkey"], got.columns["o_orderdate"],
                  got.columns["revenue"])
    rk, rd, rr = ref
    check(len(gk) == min(n, len(rk)),
          f"Q3 returned {len(gk)} rows, expected {min(n, len(rk))}")
    ref_rev = {(int(a), int(b)): float(c) for a, b, c in zip(rk, rd, rr)}
    i = 0
    while i < len(gk):
        j = i + 1
        while j < len(rr) and abs(rr[j] - rr[j - 1]) <= REV_RTOL * abs(rr[j]):
            j += 1
        run = {(int(a), int(b)) for a, b in zip(rk[i:j], rd[i:j])}
        for r in range(i, min(j, len(gk))):
            key = (int(gk[r]), int(gd[r]))
            check(key in run, f"Q3 rank {r + 1}: {key} is not the "
                  f"reference's row there ({sorted(run)})")
            want = ref_rev[key]
            check(abs(gr[r] - want) <= REV_RTOL * abs(want),
                  f"Q3 rank {r + 1}: revenue {gr[r]!r} vs {want!r}")
        check(len({(int(a), int(b)) for a, b in
                   zip(gk[i:min(j, len(gk))], gd[i:min(j, len(gk))])})
              == min(j, len(gk)) - i, "Q3 returned a row twice")
        i = j


def _group_sums(keys, *values):
    """Sorted unique key tuples and, per value lane, its sum per group
    (numpy ``lexsort`` + ``reduceat``)."""
    order = np.lexsort(tuple(reversed(keys)))
    ks = [k[order] for k in keys]
    change = np.zeros(len(order), dtype=bool)
    if len(order):
        change[0] = True
        for k in ks:
            change[1:] |= k[1:] != k[:-1]
    start = np.flatnonzero(change)
    sums = [np.add.reduceat(v[order], start) if len(start) else v[:0]
            for v in values]
    return [k[start] for k in ks], sums


def numpy_q1(tables):
    li = tables["lineitem"].columns
    m = li["l_shipdate"] <= D_1998_09_02
    ep, disc, tax, qty = (li[c][m] for c in ("l_extendedprice", "l_discount",
                                             "l_tax", "l_quantity"))
    disc_price = ep * (1.0 - disc)
    keys, (s_qty, s_ep, s_dp, s_ch, s_disc, cnt) = _group_sums(
        [li["l_returnflag"][m], li["l_linestatus"][m]], qty, ep, disc_price,
        disc_price * (1.0 + tax), disc, np.ones(len(qty), dtype=np.int64))
    return {"l_returnflag": keys[0], "l_linestatus": keys[1],
            "sum_qty": s_qty, "sum_base_price": s_ep,
            "sum_disc_price": s_dp, "sum_charge": s_ch,
            "avg_qty": s_qty / cnt, "avg_disc": s_disc / cnt,
            "count_order": cnt}


def numpy_q4(tables):
    o = tables["orders"].columns
    li = tables["lineitem"].columns
    late = np.unique(li["l_orderkey"][li["l_commitdate"]
                                      < li["l_receiptdate"]])
    m = (o["o_orderdate"] >= D_1994_01_01) & (o["o_orderdate"]
                                               < D_1995_01_01)
    m &= np.isin(o["o_orderkey"], late)
    keys, (cnt,) = _group_sums([o["o_orderpriority"][m]],
                               np.ones(int(m.sum()), dtype=np.int64))
    return {"o_orderpriority": keys[0], "order_count": cnt}


def numpy_q6(tables):
    li = tables["lineitem"].columns
    sd, disc, qty = li["l_shipdate"], li["l_discount"], li["l_quantity"]
    m = (sd >= D_1994_01_01) & (sd < D_1995_01_01) & (disc >= 0.05) \
        & (disc <= 0.07) & (qty < 24.0)
    return {"revenue": np.array([np.sum(li["l_extendedprice"][m]
                                        * disc[m])])}


def numpy_q22(tables):
    c = tables["customer"].columns
    code = np.array([p.encode()[:2].decode() for p in c["c_phone"]])
    m = np.isin(code, Q22_CODES)
    bal = c["c_acctbal"]
    pos = m & (bal > 0.0)
    avg = bal[pos].sum() / pos.sum()
    m &= bal > avg
    m &= ~np.isin(c["c_custkey"], tables["orders"].columns["o_custkey"])
    keys, (cnt, tot) = _group_sums([code[m]],
                                   np.ones(int(m.sum()), dtype=np.int64),
                                   bal[m])
    return {"cntrycode": keys[0], "numcust": cnt, "totacctbal": tot}


def numpy_sort(tables):
    """All of lineitem by ``l_shipdate``, stable: ties keep table order."""
    li = tables["lineitem"].columns
    order = np.argsort(li["l_shipdate"], kind="stable")
    return {"l_orderkey": li["l_orderkey"][order],
            "l_shipdate": li["l_shipdate"][order]}


def sort_lineitem(dfs):
    """A sort exec over the fact table on one packable key: the path on
    which ``sortStep`` meets 2^23 lanes."""
    return dfs["lineitem"].select("l_orderkey", "l_shipdate") \
        .sort("l_shipdate")


def repartitioned(dfs, n_parts: int, *keys):
    """The tables with lineitem hash-repartitioned (``tools/chaos_bench.py``
    forces an exchange into Q1 this way)."""
    return {**dfs, "lineitem": dfs["lineitem"].repartition(n_parts, *keys)}


def check_placement(torch, session, tables, n_parts: int, keys) -> dict:
    """The exchange alone over ``lineitem.select(l_orderkey,
    l_returnflag, l_linestatus)``: every row must sit in the partition
    that this script's numpy murmur3 of ``keys`` pmod ``n_parts`` names,
    and the partitions must hold every lineitem row once."""
    from spark_rapids_tpu_torch.data.batch import HostBatch
    from spark_rapids_tpu_torch.exec import execs as E
    df = session.create_dataframe(HostBatch.from_numpy(
        {k: tables["lineitem"].columns[k]
         for k in ("l_orderkey", "l_returnflag", "l_linestatus")}))
    plan = session.plan(df.repartition(n_parts, *keys)._plan)
    ctx = E.ExecContext(session.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parts = plan.execute(ctx)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts, okeys = [], []
    for p, part in enumerate(parts):
        rows = [HostBatch.from_device(b) for b in part]
        n = sum(r.num_rows for r in rows)
        counts.append(n)
        if not n:
            continue
        cols = {k: np.concatenate([r.columns[k] for r in rows])
                for k in rows[0].columns}
        h = np.full(n, SPARK_SEED, np.uint32)
        for k in keys:
            h = np_hash_longs(cols[k], h) if k == "l_orderkey" \
                else np_hash_strings(cols[k], h)
        bad = int((np_pmod(h, n_parts) != p).sum())
        check(bad == 0, f"placement {keys}: {bad} rows of partition {p} "
              "belong elsewhere")
        okeys.append(cols["l_orderkey"])
    total = tables["lineitem"].num_rows
    check(sum(counts) == total, f"placement {keys}: {sum(counts)} rows, "
          f"expected {total}")
    check(np.array_equal(np.sort(np.concatenate(okeys)),
                         np.sort(tables["lineitem"].columns["l_orderkey"])),
          f"placement {keys}: the partitions do not hold lineitem's rows")
    print(f"  placement {n_parts} x {list(keys)}: all {total} rows where "
          f"numpy murmur3 pmod {n_parts} puts them; rows per partition "
          f"{counts}; exchange {wall:.1f} ms; per exec "
          + ", ".join(f"{k}={v:.3f}" for k, v in ctx.exec_ms().items()))
    return {"n_parts": n_parts, "keys": list(keys), "rows": counts,
            "exchange_ms": wall}


#: (key or exact columns, float columns) of each query's answer.
ANSWERS = {
    "q1": (["l_returnflag", "l_linestatus", "count_order"],
           ["sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
            "avg_qty", "avg_disc"]),
    "q4": (["o_orderpriority", "order_count"], []),
    "q6": ([], ["revenue"]),
    "q22": (["cntrycode", "numcust"], ["totacctbal"]),
    "sort": (["l_orderkey", "l_shipdate"], []),
}
NUMPY_REFS = {"q1": numpy_q1, "q4": numpy_q4, "q6": numpy_q6,
              "q22": numpy_q22, "sort": numpy_sort}


def check_answer(q: str, got, ref) -> None:
    """Keys, strings and counts exact, in the order the query sets (Q1,
    with no ORDER BY, in key order, which its dictionary group-by gives);
    float sums and averages to ``REV_RTOL``; no nulls."""
    exact, floats = ANSWERS[q]
    check(set(got.columns) == set(ref), f"{q}: columns {sorted(got.columns)}")
    n = len(next(iter(ref.values())))
    for name, v in got.columns.items():
        check(len(v) == n, f"{q}: {len(v)} rows of {name}, expected {n}")
        check(bool(np.all(got.validity[name])), f"{q}: null in {name}")
    for name in exact:
        g, w = got.columns[name], ref[name]
        if w.dtype.kind == "U":
            g, w = np.asarray(g).astype(str), w.astype(str)
        check(np.array_equal(g, w), f"{q}: {name} {list(g)[:8]} vs "
              f"{list(w)[:8]}")
    for name in floats:
        g, w = np.asarray(got.columns[name], dtype=np.float64), ref[name]
        check(bool(np.all(np.abs(g - w) <= REV_RTOL * np.abs(w))),
              f"{q}: {name} {g.tolist()} vs {w.tolist()}")


def in_key_order(got, keys):
    """The rows of ``got`` sorted by the ``keys`` columns: the order of a
    query with no ORDER BY whose rows come shard by shard."""
    order = np.lexsort([np.asarray(got.columns[k]).astype(str)
                        for k in reversed(keys)])
    return types.SimpleNamespace(
        columns={k: np.asarray(v)[order] for k, v in got.columns.items()},
        validity={k: np.asarray(v)[order] for k, v in got.validity.items()})


class Capture:
    """Wraps a kernel wrapper to keep a copy of every call's inputs
    (the launch count stays with the wrapped function)."""

    def __init__(self, module, attr: str):
        self.module, self.attr = module, attr
        self.fn = getattr(module, attr)
        self.calls = []

    def __enter__(self):
        def wrapper(*args):
            self.calls.append(tuple(a.clone() if hasattr(a, "clone") else a
                                    for a in args))
            return self.fn(*args)
        setattr(self.module, self.attr, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.fn)


def profile_query(torch, name, build, exec_ms) -> None:
    """Trace one warm run of a query: device time by kernel and by
    operator, and the device's busy share of the run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    labels = set(exec_ms)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        build().collect()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and e.name not in labels]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                      - e.time_range.start)
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / f"{name}_profile.txt", "w") as f:
        f.write(prof.key_averages().table(row_limit=60) + "\n")
        for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1]):
            f.write(f"{us:12.1f} us  {kname}\n")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"  {name} profile: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
          f"{len(kernels)} kernel launches; top: "
          + "; ".join(f"{n[:60]} {us / 1e3:.3f} ms" for n, us in top))


# --------------------------------------------------------------------------
# phase 3 driver and phase 4 timing
# --------------------------------------------------------------------------


class Wrappers:
    """The six kernel wrappers, their launch counts and capture."""

    def __init__(self, JP, SEG, SS, SG, HK):
        self.mods = {"joinProbe": (JP, "dense_build_probe"),
                     "segmented": (SEG, "segment_reduce_sorted"),
                     "sortStep": (SS, "packed_argsort"),
                     "strings": (SG, "ragged_gather"),
                     "hash": (HK, "murmur3_bytes_rows"),
                     "stringsEqual": (SG, "ragged_row_equal")}
        # the wrappers themselves, which own the counts while a Capture
        # stands in for them
        self.fns = {k: getattr(m, a) for k, (m, a) in self.mods.items()}

    def reset(self) -> None:
        for fn in self.fns.values():
            fn.launches = 0

    def counts(self) -> dict:
        return {name: fn.launches for name, fn in self.fns.items()}


def check_path(session, name: str, shards: int) -> None:
    """With ``shards``, the query's final run must have taken the mesh
    path over that many shards; without, the single-device path."""
    info = session.last_query
    want = ("mesh", shards) if shards else ("single", 1)
    check((info.path, info.shards) == want,
          f"{name} ran on the {info.path} path over {info.shards} shard(s), "
          f"expected {want[0]} over {want[1]}")


def run_query(torch, session, wrappers, name, build, check_fn, need,
              shards: int = 0):
    """Cold run (launch counts set to 0 just before, read just after),
    one captured warm run, then 3 timed warm runs; every run on the mesh
    path over ``shards`` shards when that is given, else on the single
    path. Returns (cold launch counts, captured calls by kernel, a
    summary dict with the cold run's peak device memory, the median
    run's per-exec ms)."""
    torch.cuda.reset_peak_memory_stats()
    wrappers.reset()
    t0 = time.perf_counter()
    got = build().collect()
    cold_s = time.perf_counter() - t0
    launches = wrappers.counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    info = session.last_query
    print(f"  {name} cold run: {cold_s * 1e3:.1f} ms, {info.attempts} "
          f"attempt(s), path {info.path} over {info.shards} shard(s), "
          f"sites {info.site_kinds}, modes {info.dense_modes}; "
          f"kernel launches {launches}; peak device memory "
          f"{peak_gib:.2f} GiB")
    check_path(session, name, shards)
    check_fn(got)
    for k in need:
        check(launches[k] > 0, f"{k} was not launched during {name}")
    caps = {k: Capture(*wrappers.mods[k]) for k in wrappers.mods}
    for c in caps.values():
        c.__enter__()
    try:
        before = wrappers.counts()
        got = build().collect()
        warm_launches = {k: v - before[k]
                         for k, v in wrappers.counts().items()}
    finally:
        for c in caps.values():
            c.__exit__()
    check_path(session, name, shards)
    check_fn(got)
    runs, per_exec = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        got = build().collect()
        runs.append((time.perf_counter() - t0) * 1e3)
        per_exec.append(session.last_query.exec_ms)
        check_path(session, name, shards)
        check_fn(got)
    e2e = statistics.median(runs)
    mid = per_exec[runs.index(e2e)]
    print(f"  {name} warm runs: {[round(r, 3) for r in runs]} ms, median "
          f"{e2e:.3f} ms; launches per warm run {warm_launches}")
    print(f"  {name} per exec (ms, median run): "
          + ", ".join(f"{k}={v:.3f}" for k, v in mid.items()))
    print(f"  {name} answer matches the numpy reference: " + json.dumps(
        {k: np.asarray(v).tolist()[:10] for k, v in got.columns.items()}))
    summary = {"cold_ms": cold_s * 1e3, "warm_median_ms": e2e,
               "warm_runs_ms": runs, "attempts": info.attempts,
               "path": info.path, "shards": info.shards,
               "peak_gib": peak_gib, "launches": launches,
               "per_exec_ms": mid}
    return launches, {k: c.calls for k, c in caps.items()}, summary, mid


def group_by_string_key(torch, KG, T, HostBatch, wrappers, name, col,
                        n_rows, values) -> dict:
    """``group_ids``, then ``segment_reduce`` (count) and
    ``gather_group_keys`` over one string key column, its launch counts
    set to 0 just before and read just after. The groups, each key and
    its row count must equal numpy's ``np.unique(values,
    return_counts=True)``; the rowwise-compare kernel must launch."""
    from spark_rapids_tpu_torch.data.batch import ColumnarBatch
    cap, dev = col.capacity, col.device
    wrappers.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seg, n_groups, firsts = KG.group_ids([col], n_rows)
    live = torch.arange(cap, device=dev) < n_rows
    counts, _ = KG.segment_reduce(
        torch.ones(cap, dtype=torch.int64, device=dev), col.validity, seg,
        cap, "count", live)
    [keys] = KG.gather_group_keys([col], firsts, n_groups)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = wrappers.counts()
    check(launches["stringsEqual"] > 0,
          f"stringsEqual was not launched by group_ids over {name}")
    ng = int(n_groups)
    got = HostBatch.from_device(ColumnarBatch(
        (keys,), n_groups, T.Schema([T.StructField("k", T.STRING)])))
    want_keys, want_counts = np.unique(np.asarray(values).astype(str),
                                       return_counts=True)
    check(ng == len(want_keys), f"group_ids over {name}: {ng} groups, "
          f"expected {len(want_keys)}")
    check(np.array_equal(got.columns["k"].astype(str), want_keys),
          f"group_ids over {name}: keys {list(got.columns['k'][:8])} vs "
          f"{list(want_keys[:8])}")
    check(np.array_equal(counts[:ng].cpu().numpy(), want_counts),
          f"group_ids over {name}: row counts differ from numpy's")
    print(f"  group_ids over {name} (capacity {cap}, W={col.max_bytes}, "
          f"{'dictionary' if col.is_dict else 'flat'}): {ng} groups equal to "
          f"numpy's np.unique, {ms:.1f} ms with segment_reduce and "
          f"gather_group_keys; kernel launches {launches}")
    return {"name": name, "capacity": cap, "width": col.max_bytes,
            "groups": ng, "ms": ms, "launches": launches}


def check_distributed(torch, D, mesh, dfs, tables) -> dict:
    """``distributed_sum_by_key`` of ``l_partkey`` by ``l_suppkey`` over
    ``mesh``: sums and counts per key must equal numpy's, and every group
    must sit on the shard that this script's numpy murmur3 pmod n
    names."""
    batch = dfs["lineitem"]._plan.batch
    key, val = batch.column("l_suppkey"), batch.column("l_partkey")
    n_parts = mesh.size
    shard_cap = batch.capacity // n_parts
    n_rows = (batch.n_rows - torch.arange(n_parts, device=key.device)
              * shard_cap).clamp(0, shard_cap).to(torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = D.distributed_sum_by_key(mesh, key.data, key.validity, val.data,
                                   val.validity, n_rows)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    gk, gkv, gs, gc, gn = (t.cpu().numpy() for t in out)
    li = tables["lineitem"].columns
    keys, vals = li["l_suppkey"], li["l_partkey"]
    n_keys = int(keys.max()) + 1
    sums = np.zeros(n_keys, np.int64)
    np.add.at(sums, keys, vals)
    cnts = np.bincount(keys, minlength=n_keys)
    seen = np.zeros(n_keys, bool)
    for d in range(n_parts):
        rows = slice(d * shard_cap, d * shard_cap + int(gn[d]))
        k = gk[rows]
        check(bool(gkv[rows].all()), "distributed_sum_by_key: a null key")
        check(not seen[k].any(), "distributed_sum_by_key: a key on two "
              "shards")
        seen[k] = True
        home = np_pmod(np_hash_longs(k, np.full(len(k), SPARK_SEED,
                                                np.uint32)), n_parts)
        check(bool((home == d).all()), f"distributed_sum_by_key: "
              f"{int((home != d).sum())} groups of shard {d} belong "
              "elsewhere")
        check(np.array_equal(gs[rows], sums[k]) and
              np.array_equal(gc[rows], cnts[k]),
              f"distributed_sum_by_key: shard {d}'s sums or counts differ "
              "from numpy's")
    check(np.array_equal(seen, cnts > 0), "distributed_sum_by_key: groups "
          "missing")
    print(f"  distributed_sum_by_key(l_suppkey -> sum(l_partkey)) over "
          f"{n_parts} shards: {int(gn.sum())} groups (per shard "
          f"{gn.tolist()}) equal to numpy, each on its murmur3 shard; "
          f"{ms:.1f} ms")
    return {"shards": n_parts, "groups_per_shard": gn.tolist(), "ms": ms}


def time_sortstep(torch, SS, lane, flush):
    """(kernel ms, plain ms, torch.sort ms, bound ms) of one lane."""
    ms = median_ms(torch, lambda: SS.packed_argsort(lane), flush)
    pms = median_ms(torch, lambda: SS.packed_argsort_plain(lane), flush)
    lib = median_ms(torch, lambda: torch.sort(lane), flush)
    return ms, pms, lib, 12 * lane.numel() / HBM_BYTES_PER_S * 1e3


def time_sort_routes(torch, KR, SS, dfs, flush) -> dict:
    """The sort exec's permutation of SF1 lineitem by ``l_shipdate``
    (ascending, nulls first) both ways: the packed lane through
    ``sortStep``, and the stable lexsort that keys which do not pack take.
    Both routes are timed with their operands built; they must agree."""
    batch = dfs["lineitem"]._plan.batch
    key = batch.column("l_shipdate")
    live = batch.row_mask()

    def packed():
        return SS.packed_argsort(KR.packed_sort_lane(batch, [key], [True],
                                                     [True]))

    def lex():
        return KR.lexsort([(~live).to(torch.int8)]
                          + KR.sort_operands([key], [True], [True]))

    lane = KR.packed_sort_lane(batch, [key], [True], [True])
    check(lane is not None, "l_shipdate does not pack into a sort lane")
    check(torch.equal(SS.packed_argsort(lane), SS.packed_argsort_plain(lane)),
          "sortStep differs from the plain version on the l_shipdate lane")
    n = int(batch.n_rows)
    check(torch.equal(packed()[:n].long(), lex()[:n].long()),
          "the sortStep and lexsort routes order l_shipdate differently")
    ms, pms, lib, bound = time_sortstep(torch, SS, lane, flush)
    passes = SS.packed_argsort_passes(lane)[1]
    route_ms = median_ms(torch, packed, flush)
    lex_ms = median_ms(torch, lex, flush)
    print(f"  sortStep l_shipdate lane n={lane.numel()} ({passes} live radix "
          f"passes): kernel {ms:.4f} ms, plain {pms:.4f} ms, torch.sort "
          f"{lib:.4f} ms, bound {bound:.4f} ms; with operands built: "
          f"sortStep route {route_ms:.4f} ms, lexsort route {lex_ms:.4f} ms")
    return {"n": lane.numel(), "live_radix_passes": passes, "ms": ms,
            "plain_ms": pms, "library_ms": lib, "bound_ms": bound,
            "sortstep_route_ms": route_ms, "lexsort_route_ms": lex_ms}


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lineitem-rows", type=int, default=6_001_215,
                    help="TPC-H lineitem rows (SF1 = 6,001,215)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm run of each query with "
                         "torch.profiler (tables in "
                         "chiprun_out/<query>_profile.txt)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available; this smoke run needs an NVIDIA GPU")
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.data.batch import HostBatch
    from spark_rapids_tpu_torch.exec import execs as E
    from spark_rapids_tpu_torch.ops.expression import col, lit
    from spark_rapids_tpu_torch.ops.kernels import groupby as KG
    from spark_rapids_tpu_torch.ops.kernels import rowops as KR
    from spark_rapids_tpu_torch.ops import strings_util as SU
    from spark_rapids_tpu_torch.ops.strings import Substring
    from spark_rapids_tpu_torch.ops.kernels.cuda import _build
    from spark_rapids_tpu_torch.ops.kernels.cuda import hashing as HK
    from spark_rapids_tpu_torch.ops.kernels.cuda import join_probe as JP
    from spark_rapids_tpu_torch.ops.kernels.cuda import segmented as SEG
    from spark_rapids_tpu_torch.ops.kernels.cuda import sort_steps as SS
    from spark_rapids_tpu_torch.ops.kernels.cuda import strings as SG
    from spark_rapids_tpu_torch.parallel import distributed as D
    from spark_rapids_tpu_torch.parallel.mesh import make_mesh
    from spark_rapids_tpu_torch.plan import logical as L
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.workloads import tpch

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: build --------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build_all()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "ptxas.txt").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in reports.items()))
    print(f"phase 1: built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s (ptxas report in "
          "chiprun_out/ptxas.txt)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    kind = torch.cuda.get_device_name(0)

    # -- phase 2: edge cases ---------------------------------------------
    print("phase 2: kernels vs plain versions on edge cases")
    rng = np.random.default_rng(args.seed)
    joinprobe_edge_cases(torch, JP, rng, dev)
    segmented_edge_cases(torch, SEG, rng, dev)
    sortstep_edge_cases(torch, SS, rng, dev)
    strings_edge_cases(torch, SG, rng, dev)
    hash_edge_cases(torch, HK, rng, dev)
    row_equal_edge_cases(torch, SG, rng, dev)

    # -- phase 3: the queries at SF1 -------------------------------------
    print(f"phase 3: TPC-H Q3, Q1, Q4, Q6, Q22, lineitem sorted by "
          f"l_shipdate, Q1 over two hash repartitions of lineitem, "
          f"group_ids over two string keys, Q1, Q3, Q4 and Q6 over a "
          f"4-shard mesh on the card, distributed_sum_by_key, "
          f"lineitem_rows={args.lineitem_rows}")
    t0 = time.perf_counter()
    tables = tpch.gen_tables(args.lineitem_rows, seed=args.seed)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref3 = numpy_q3(tables)
    refs = {q: fn(tables) for q, fn in NUMPY_REFS.items()}
    t_ref = time.perf_counter() - t0
    session = TorchSession(device="cuda")
    t0 = time.perf_counter()
    dfs = tpch.load(session, tables)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    print(f"  tables: generated {t_gen:.1f} s, uploaded {t_load:.1f} s; "
          f"numpy references {t_ref:.1f} s; rows "
          + ", ".join(f"{k}={v.num_rows}" for k, v in tables.items()))

    wrappers = Wrappers(JP, SEG, SS, SG, HK)
    queries = {
        "q3": (lambda: tpch.q3(dfs), lambda got: check_q3(got, ref3),
               ("joinProbe", "segmented")),
        "q1": (lambda: tpch.q1(dfs),
               lambda got: check_answer("q1", got, refs["q1"]), ()),
        "q4": (lambda: tpch.q4(dfs),
               lambda got: check_answer("q4", got, refs["q4"]),
               ("joinProbe", "sortStep")),
        "q6": (lambda: tpch.q6(dfs),
               lambda got: check_answer("q6", got, refs["q6"]), ()),
        "q22": (lambda: tpch.q22(dfs),
                lambda got: check_answer("q22", got, refs["q22"]),
                ("joinProbe", "strings")),
        "sort": (lambda: sort_lineitem(dfs),
                 lambda got: check_answer("sort", got, refs["sort"]),
                 ("sortStep",)),
        # 16 is spark.sql.shuffle.partitions' default
        "q1_hash_str": (lambda: tpch.q1(repartitioned(
            dfs, 16, "l_returnflag", "l_linestatus")),
            lambda got: check_answer("q1", got, refs["q1"]),
            ("hash", "segmented")),
        "q1_hash_key": (lambda: tpch.q1(repartitioned(dfs, 4, "l_orderkey")),
                        lambda got: check_answer("q1", got, refs["q1"]),
                        ("segmented",)),
    }
    launches = {k: 0 for k in wrappers.mods}
    calls = {k: [] for k in wrappers.mods}
    summaries = {}
    for q, (build, check_fn, need) in queries.items():
        got_launches, got_calls, summaries[q], mid = run_query(
            torch, session, wrappers, q.upper(), build, check_fn, need)
        for k in launches:
            launches[k] += got_launches[k]
            calls[k] += got_calls[k]
        if args.profile:
            profile_query(torch, q, build, mid)
    placement = [check_placement(torch, session, tables, 16,
                                 ("l_returnflag", "l_linestatus")),
                 check_placement(torch, session, tables, 4, ("l_orderkey",))]

    # group_ids over string keys: lineitem's dictionary l_shipmode and
    # Q22's flat cntrycode (substring(c_phone, 1, 2) over customer).
    li_batch = dfs["lineitem"]._plan.batch
    [[cust]] = session.plan(dfs["customer"].with_column(
        "cntrycode", Substring(col("c_phone"), lit(1), lit(2)))._plan
    ).execute(E.ExecContext(dev))
    code_values = np.array([p.encode()[:2].decode()
                            for p in tables["customer"].columns["c_phone"]])
    equal_keys = {"l_shipmode": (li_batch.column("l_shipmode"),
                                 li_batch.n_rows,
                                 tables["lineitem"].columns["l_shipmode"]),
                  "cntrycode": (cust.column("cntrycode"), cust.n_rows,
                                code_values)}
    group_ids_runs = []
    for name, (key_col, n_rows, values) in equal_keys.items():
        group_ids_runs.append(group_by_string_key(
            torch, KG, T, HostBatch, wrappers, name, key_col, n_rows, values))
        for k, v in group_ids_runs[-1]["launches"].items():
            launches[k] += v

    # The mesh path: four shards on the one card.
    mesh4 = make_mesh(devices=[dev] * 4)
    mesh_session = TorchSession({"spark.rapids.tpu.mesh.enabled": True},
                                device="cuda", mesh=mesh4)
    mesh_dfs = {k: L.DataFrame(v._plan, mesh_session) for k, v in dfs.items()}
    mesh_queries = {
        "mesh_q1": (lambda: tpch.q1(mesh_dfs),
                    lambda got: check_answer("q1", in_key_order(
                        got, ["l_returnflag", "l_linestatus"]), refs["q1"]),
                    ("hash",)),
        "mesh_q3": (lambda: tpch.q3(mesh_dfs),
                    lambda got: check_q3(got, ref3), ("segmented",)),
        "mesh_q4": (lambda: tpch.q4(mesh_dfs),
                    lambda got: check_answer("q4", got, refs["q4"]),
                    ("hash", "sortStep")),
        "mesh_q6": (lambda: tpch.q6(mesh_dfs),
                    lambda got: check_answer("q6", got, refs["q6"]), ()),
    }
    for q, (build, check_fn, need) in mesh_queries.items():
        got_launches, got_calls, summaries[q], mid = run_query(
            torch, mesh_session, wrappers, q.upper(), build, check_fn, need,
            shards=mesh4.size)
        for k in launches:
            launches[k] += got_launches[k]
            calls[k] += got_calls[k]
        if args.profile:
            profile_query(torch, q, build, mid)
    # The session's own mesh: every visible card.
    default_session = TorchSession({"spark.rapids.tpu.mesh.enabled": True},
                                   device="cuda")
    t0 = time.perf_counter()
    got = tpch.q6({k: L.DataFrame(v._plan, default_session)
                   for k, v in dfs.items()}).collect()
    default_ms = (time.perf_counter() - t0) * 1e3
    check_answer("q6", got, refs["q6"])
    check_path(default_session, "Q6 on the default mesh",
               torch.cuda.device_count())
    print(f"  Q6 on the session's default mesh ({default_session.mesh}): "
          f"path {default_session.last_query.path} over "
          f"{default_session.last_query.shards} shard(s), {default_ms:.1f} "
          "ms cold, answer matches the numpy reference")
    distributed = check_distributed(torch, D, mesh4, dfs, tables)

    # -- phase 4: kernels at the queries' shapes ---------------------------
    print("phase 4: kernels at the shapes the queries gave them")
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    rows = []
    jp = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "err": 0}
    for bslot, pslot, tbl in calls["joinProbe"]:
        got_k = JP.dense_build_probe(bslot, pslot, tbl)
        want = JP.dense_build_probe_plain(bslot, pslot, tbl)
        for g, w in zip(got_k, want):
            check(bits_equal(torch, g, w), "joinProbe differs from the "
                  f"plain version at shape {tuple(bslot.shape)}x"
                  f"{tuple(pslot.shape)}")
            jp["err"] = max(jp["err"], max_abs_err(torch, g, w))
        ms = median_ms(torch, lambda: JP.dense_build_probe(bslot, pslot,
                                                           tbl), flush)
        pms = median_ms(torch, lambda: JP.dense_build_probe_plain(
            bslot, pslot, tbl), flush)
        nbytes = 4 * bslot.numel() + 4 * pslot.numel() + 8 * pslot.numel() + 4
        print(f"  joinProbe cap_b={bslot.numel()} cap_p={pslot.numel()} "
              f"tbl={tbl}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
        jp["ms"] += ms
        jp["plain_ms"] += pms
        jp["bytes"] += nbytes
    rows.append({"name": "joinProbe", "route": "cuda",
                 "source": "spark_rapids_tpu_torch/ops/kernels/cuda/csrc/"
                           "join_probe.cu",
                 "replaces": "spark_rapids_tpu/ops/kernels/pallas/"
                             "join_probe.py:87",
                 "launches": launches["joinProbe"],
                 "max_abs_err": jp["err"], "ms": jp["ms"],
                 "plain_ms": jp["plain_ms"],
                 "bound_ms": jp["bytes"] / HBM_BYTES_PER_S * 1e3,
                 "bound_by": "bytes", "library_ms": None})

    sg = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "lib": 0.0, "err": 0}
    for x, gid, capacity, op in calls["segmented"]:
        got_k = SEG.segment_reduce_sorted(x, gid, capacity, op)
        want = SEG.segment_reduce_sorted_plain(x, gid, capacity, op)
        check(bits_equal(torch, got_k, want), "segmented differs from the "
              f"plain version at shape {tuple(x.shape)} {op}")
        sg["err"] = max(sg["err"], max_abs_err(torch, got_k, want))
        ms = median_ms(torch, lambda: SEG.segment_reduce_sorted(
            x, gid, capacity, op), flush)
        pms = median_ms(torch, lambda: SEG.segment_reduce_sorted_plain(
            x, gid, capacity, op), flush)
        # Yardstick: torch.segment_reduce has no integer kernel, so it
        # reduces the lane cast to float64 (exact for these counts), with
        # lengths from the group ids computed outside the timing.
        xf = x.to(torch.float64)
        lengths = torch.bincount(gid[gid < capacity].long(),
                                 minlength=capacity)
        lib = median_ms(torch, lambda: torch.segment_reduce(
            xf, op, lengths=lengths, unsafe=True), flush)
        nbytes = x.numel() * x.element_size() + 4 * gid.numel() \
            + capacity * (x.numel() // max(x.shape[0], 1)) * x.element_size()
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"  segmented {op} x={tuple(x.shape)} {x.dtype} "
              f"capacity={capacity}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
              f"torch.segment_reduce {lib:.4f} ms, bound {bound:.4f} ms "
              f"({ms / bound:.1f}x)")
        sg["ms"] += ms
        sg["plain_ms"] += pms
        sg["lib"] += lib
        sg["bytes"] += nbytes
    rows.append({"name": "segmented", "route": "cuda",
                 "source": "spark_rapids_tpu_torch/ops/kernels/cuda/csrc/"
                           "segmented.cu",
                 "replaces": "spark_rapids_tpu/ops/kernels/pallas/"
                             "segmented.py:97",
                 "launches": launches["segmented"],
                 "max_abs_err": sg["err"], "ms": sg["ms"],
                 "plain_ms": sg["plain_ms"],
                 "bound_ms": sg["bytes"] / HBM_BYTES_PER_S * 1e3,
                 "bound_by": "bytes", "library_ms": sg["lib"]})

    ss = {"ms": 0.0, "plain_ms": 0.0, "bound": 0.0, "lib": 0.0, "err": 0}
    for (lane,) in calls["sortStep"]:
        got_k = SS.packed_argsort(lane)
        want = SS.packed_argsort_plain(lane)
        check(bits_equal(torch, got_k, want), "sortStep differs from the "
              f"plain version at {lane.numel()} lanes")
        ss["err"] = max(ss["err"], max_abs_err(torch, got_k, want))
        ms, pms, lib, bound = time_sortstep(torch, SS, lane, flush)
        passes = ""
        if lane.numel() >= 1 << 20:
            passes = f", {SS.packed_argsort_passes(lane)[1]} live radix passes"
        print(f"  sortStep n={lane.numel()}: kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms, torch.sort {lib:.4f} ms, bound {bound:.6f} ms"
              f"{passes}")
        for k, v in zip(("ms", "plain_ms", "lib", "bound"),
                        (ms, pms, lib, bound)):
            ss[k] += v
    rows.append({"name": "sortStep", "route": "cuda",
                 "source": "spark_rapids_tpu_torch/ops/kernels/cuda/csrc/"
                           "sort_steps.cu",
                 "replaces": "spark_rapids_tpu/ops/kernels/pallas/"
                             "sort_steps.py:76",
                 "launches": launches["sortStep"], "max_abs_err": ss["err"],
                 "ms": ss["ms"], "plain_ms": ss["plain_ms"],
                 "bound_ms": ss["bound"], "bound_by": "bytes",
                 "library_ms": ss["lib"]})
    shipdate = time_sort_routes(torch, KR, SS, dfs, flush)

    st = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "lib": 0.0, "err": 0}
    for mat, idx, valid in calls["strings"]:
        n, w = mat.shape
        m = idx.shape[0]
        got_k = SG.ragged_gather(mat, idx, valid)
        want = SG.ragged_gather_plain(mat, idx, valid)
        check(bits_equal(torch, got_k, want), "strings gather differs from "
              f"the plain version at n={n} m={m} W={w}")
        st["err"] = max(st["err"], max_abs_err(torch, got_k, want))
        ms = median_ms(torch, lambda: SG.ragged_gather(mat, idx, valid),
                       flush)
        pms = median_ms(torch, lambda: SG.ragged_gather_plain(mat, idx,
                                                              valid), flush)
        safe = idx.long().clamp(0, n - 1)
        lib = median_ms(torch, lambda: torch.where(
            valid[:, None], mat.index_select(0, safe), -1), flush)
        # idx and valid read, the output written, and one read of each
        # distinct source row a valid output row takes (invalid rows read
        # no source)
        src_rows = torch.unique(idx.long().clamp(0, n - 1)[valid.bool()]
                                ).numel() if n else 0
        nbytes = 5 * m + 2 * m * w + 2 * w * src_rows
        print(f"  strings gather n={n} m={m} W={w} source rows read "
              f"{src_rows}: kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms, index_select {lib:.4f} ms, bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
        st["ms"] += ms
        st["plain_ms"] += pms
        st["lib"] += lib
        st["bytes"] += nbytes
    rows.append({"name": "strings", "route": "cuda",
                 "source": "spark_rapids_tpu_torch/ops/kernels/cuda/csrc/"
                           "strings.cu",
                 "replaces": "spark_rapids_tpu/ops/kernels/pallas/"
                             "strings.py:48",
                 "launches": launches["strings"], "max_abs_err": st["err"],
                 "ms": st["ms"], "plain_ms": st["plain_ms"],
                 "bound_ms": st["bytes"] / HBM_BYTES_PER_S * 1e3,
                 "bound_by": "bytes", "library_ms": st["lib"]})

    hs = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "err": 0}
    for mat, lengths, seed in calls["hash"]:
        n, w = mat.shape
        got_k = HK.murmur3_bytes_rows(mat, lengths, seed)
        want = HK.murmur3_bytes_rows_plain(mat, lengths, seed)
        check(bits_equal(torch, got_k, want), "hash differs from the plain "
              f"version at n={n} W={w}")
        hs["err"] = max(hs["err"], max_abs_err(torch, got_k, want))
        ms = median_ms(torch, lambda: HK.murmur3_bytes_rows(mat, lengths,
                                                            seed), flush)
        pms = median_ms(torch, lambda: HK.murmur3_bytes_rows_plain(
            mat, lengths, seed), flush, reps=5)
        # lengths, seed and the output (12 B a row) plus the 32-byte
        # sectors of chars each row's length needs
        chars = 2 * lengths.long().clamp(0, w)
        nbytes = 12 * n + int((32 * ((chars + 31) // 32)).sum())
        print(f"  hash n={n} W={w} (max length {int(lengths.max())}): "
              f"kernel {ms:.4f} ms, plain {pms:.4f} ms, no one PyTorch call, "
              f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
        hs["ms"] += ms
        hs["plain_ms"] += pms
        hs["bytes"] += nbytes
    rows.append({"name": "hash", "route": "cuda",
                 "source": "spark_rapids_tpu_torch/ops/kernels/cuda/csrc/"
                           "hashing.cu",
                 "replaces": "spark_rapids_tpu/ops/kernels/pallas/"
                             "hashing.py:69",
                 "launches": launches["hash"], "max_abs_err": hs["err"],
                 "ms": hs["ms"], "plain_ms": hs["plain_ms"],
                 "bound_ms": hs["bytes"] / HBM_BYTES_PER_S * 1e3,
                 "bound_by": "bytes", "library_ms": None})
    # The rowwise compare at the group_ids calls' shapes: the sorted char
    # matrix against itself one row back, as two views of one buffer.
    eq = {"ms": 0.0, "plain_ms": 0.0, "lib": 0.0, "bytes": 0, "err": 0}
    for name, (key_col, n_rows, _) in equal_keys.items():
        m = SU.char_matrix(key_col)[KR.sort_permutation([key_col], n_rows)]
        a, b = m[1:], m[:-1]
        n, w = a.shape
        got_k = SG.ragged_row_equal(a, b)
        want = SG.ragged_row_equal_plain(a, b)
        check(bits_equal(torch, got_k, want), "strings compare differs from "
              f"the plain version at {name}'s n={n} W={w}")
        eq["err"] = max(eq["err"], max_abs_err(torch, got_k, want))
        ms = median_ms(torch, lambda: SG.ragged_row_equal(a, b), flush)
        pms = median_ms(torch, lambda: SG.ragged_row_equal_plain(a, b),
                        flush)
        lib = median_ms(torch, lambda: (a == b).all(1), flush)
        # one read of the matrix both views share, one byte out a row
        nbytes = 2 * (n + 1) * w + n
        print(f"  strings compare at {name}'s group_ids n={n} W={w} (views "
              f"of one matrix): kernel {ms:.4f} ms, plain {pms:.4f} ms, "
              f"(a == b).all(1) {lib:.4f} ms, bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
        eq["ms"] += ms
        eq["plain_ms"] += pms
        eq["lib"] += lib
        eq["bytes"] += nbytes
        del m, a, b
    rows.append({"name": "stringsEqual", "route": "cuda",
                 "source": "spark_rapids_tpu_torch/ops/kernels/cuda/csrc/"
                           "strings.cu",
                 "replaces": "spark_rapids_tpu/ops/kernels/pallas/"
                             "strings.py:99",
                 "launches": launches["stringsEqual"],
                 "max_abs_err": eq["err"], "ms": eq["ms"],
                 "plain_ms": eq["plain_ms"],
                 "bound_ms": eq["bytes"] / HBM_BYTES_PER_S * 1e3,
                 "bound_by": "bytes", "library_ms": eq["lib"]})

    # The char matrix that feeds each hash call: a dictionary column's
    # [capacity, W] int16 matrix gathered by code.
    flag = dfs["lineitem"]._plan.batch.column("l_returnflag")
    cm_ms = median_ms(torch, lambda: SU.char_matrix(flag), flush, reps=5)
    print(f"  char_matrix of l_returnflag at capacity {flag.capacity}, W="
          f"{flag.max_bytes}: {cm_ms:.4f} ms (writes "
          f"{2 * flag.capacity * flag.max_bytes / 2 ** 30:.2f} GiB)")

    # -- phase 5: results --------------------------------------------------
    print(json.dumps({"queries_sf1": {
        "lineitem_rows": args.lineitem_rows, "card": smi,
        **{q: {k: v for k, v in s.items() if k != "per_exec_ms"}
           for q, s in summaries.items()},
        "sortStep_l_shipdate": shipdate, "placement": placement,
        "char_matrix_ms": cm_ms, "group_ids": group_ids_runs,
        "distributed_sum_by_key": distributed,
        "q6_default_mesh_ms": default_ms}}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
