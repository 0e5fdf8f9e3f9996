#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spark_rapids_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--lineitem-rows N] [--xbb-clicks N] [--seed S]
                          [--profile]

Phases; each one passes or the script exits non-zero:

1. build the CUDA kernels and the host snappy routine from
   ``spark_rapids_tpu_torch/ops/kernels/cuda/csrc`` (one ``nvcc`` per
   source, all at once); print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card, on edge
   cases: for ``joinProbe`` duplicate keys, empty tables, one live row, all
   rows dead, a table of one slot, no build rows, every build row
   unusable, one slot hit by every row (the max is the row count), only
   the last rows live, clustered keys (runs of 1-7 rows); for
   ``segmented`` int8 to int64 lanes (int8/int16 sums that
   wrap), float32 and float64 lanes with +/-0.0 and NaN, 1, 2, 3 and 8
   lanes, one group, one group per row, a group ending on a 1024-row tile
   boundary, one group over many tiles, ids above 0, negative leading
   ids, every row dead, no rows; for ``sortStep`` one lane, the
   single-block threshold (4096 lanes) and one below and above it, all
   lanes dead, random unique lanes up to 1,000,003, lanes where no digit
   varies, only the dead field varies, a date-shaped key, or the index
   bits are a permutation, up to 2^23 + 1 (the live radix passes printed
   from 2^20 lanes up); each call must count one launch; for
   the ``strings`` gather's ragged entry (a flat column's own offsets and
   payload, the path's) m 1, 255, 256, 257, one 1,024-row tile and either
   side of it, 8,192, 100,003 and 262,144 by W 8 and 128: lengths 0, W
   and past W, all or no rows valid, indices below 0 and past n, negative
   and int32-wrapped lengths, one source row, every source empty, entries
   at odd bytes, a payload ending at the last entry, no source rows, and
   W 2^21 over 5 rows (one launch a call); for its matrix entry (the
   Pallas kernel's counterpart) W 8 and 128, all or no rows valid,
   indices out of range on both sides, more and fewer rows out than in;
   for ``hash`` n 1, 255, 256, 257 and 100,003 rows by W 4, 8, 128 and
   1024, lengths 0-5 and W, bytes >= 128, all-PAD rows and random
   per-row seeds, and for its ragged entry (a column's own layout)
   dictionary and flat columns, codes out of range, lengths 0-5, W and
   past W, negative lengths, unaligned entry starts, n 1, 255, 256, 257
   and 100,003, and whole columns with null rows through
   ``spark_hash_columns_device``; for the
   rowwise compare (``stringsEqual``) n 1, 7, 8,191 and 100,003 by W 8,
   12, 128 and 1,024, rows that differ only in their last char or only
   at a PAD position, all-PAD rows, chars above 127, and the row views
   ``m[1:]`` / ``m[:-1]`` of one matrix. Outputs equal bit for bit;
   both ``hash`` entries also equal this script's own numpy murmur3.
   Then the host C++ snappy routine against its plain Python version:
   every tag kind (literals with 0-4 extra length bytes, copies with 1-,
   2- and 4-byte offsets, overlapping copies) decompressed as one page
   list, every malformed block refused, the compressor byte for byte the
   plain one's; the host C++ run slicer (``csrc/parquet_runs.cpp``)
   against the plain ``parse_hybrid`` on 400 hand-made hybrid streams
   (bit widths 0-24, runs of count 0, capped and padded counts, malformed
   streams raising in both); and the committed pyarrow file
   ``tests/data/lineitem_fixture.parquet`` (mixed dictionary/PLAIN
   chunks, nulls, several pages and row groups, an empty one) decoded on
   the card equal to its CPU decode, and its run tables equal between the
   two slicers;
3. TPC-H Q3, Q1, Q4, Q6 and Q22 at SF1 (6,001,215 lineitem rows by
   default), all of lineitem sorted by ``l_shipdate``, and Q1 over
   ``lineitem.repartition(16, l_returnflag, l_linestatus)`` (``q1_hash_str``)
   and over ``lineitem.repartition(4, l_orderkey)`` (``q1_hash_key``),
   through ``TorchSession`` on ``cuda``: each answer must match an
   independent numpy implementation written here, and the kernels of each
   query's path must have launched during it (counts set to 0 just
   before, read just after): ``joinProbe`` and ``segmented`` in Q3,
   ``sortStep`` in Q4 and the sort, the ``strings`` gather (its ragged
   entry) in Q22,
   ``hash`` (its ragged entry) and ``segmented`` (the merge aggregate) in
   ``q1_hash_str``. Then the rest of the bench suite's TPC-H entries, Q5,
   Q12, Q14, Q19 and ``xbb_score``, and Q10 and Q18, each against its own
   numpy implementation here (``xbb_score``'s ``max_score`` within 4 units
   in the last place, the largest difference printed; Q10's top 20 with
   runs of tied revenues compared as sets), ``joinProbe`` launched in all
   but ``xbb_score``. Then the other eleven TPC-H queries, Q2, Q7, Q8,
   Q9, Q11, Q13, Q15, Q16, Q17, Q20 and Q21, each against its own numpy
   implementation here (Q11, by a float value, as a top-n), ``joinProbe``
   launched in all but Q13. Then the SF1 tables written by the port's
   parquet writer (SNAPPY, 1,048,576 rows a file, into a temporary
   directory removed at exit), every page of them decompressed by the C++
   routine and by the plain version (worker processes) and equal, and the
   bench suite's nine TPC-H queries over ``session.read.parquet`` frames
   (``pq_q1`` ... ``pq_xbb_score``) with the scan's decode-ahead pipeline
   on (the default): the scan inside every run, each answer against the
   same numpy references, the C++ snappy and the queries' kernels
   launched, the scan's breakdown printed (file read, footer and
   page-header parse, snappy, run tables, upload, device decode, the
   run's wall, the consumer's ``stall`` and the workers' ``busy`` time,
   rows and bytes); ``pq_q1`` once more in a session with
   ``spark.rapids.tpu.pipeline.enabled`` false, its answer equal to the
   pipeline-on one bit for bit; every level and index stream of the SF1
   files through the C++ run slicer and the plain one, equal, with both
   times printed. Then all 30 TPCxBB queries, ``bb_q01`` ...
   ``bb_q30`` (among them the bench suite's three entries: ``bb_q01``, a
   self-join on the store ticket, a two-key count, top 100; ``bb_q05``,
   click features and a dense LEFT join to the buyers; ``bb_q30``,
   sessions by windows and a two-key left self-join, then a two-key
   self-join), over ``tpcxbb.gen_tables`` at 2^22 clicks by default
   (``--xbb-clicks``) uploaded to the card, and ``bb_q02_pivot``, q02
   over a copy of the clicks with a click on item 10 beside every
   1,000th identified one; the three entries also as ``pq_bb_*`` over
   bench.py's 2^17-click tables written by the port's writer: every
   answer equal to its numpy implementation here, row for row (float
   columns to 1e-9 relative), every cell's rows printed and not empty
   but ``bb_q02``'s, its device busy share from one traced warm run,
   ``joinProbe`` launched in ``bb_q05`` (its left join too) and
   ``bb_q30``, ``bb_q03``'s and ``bb_q12``'s residual joins through the
   equi matcher (their pair counts equal to numpy's, no nested-loop join
   in their plans); ``pq_bb_q30`` with the pipeline off equal to it on,
   bit for bit, and the ``pq_bb`` files' run tables equal between the
   two slicers. Then the engine's entry stage
   (``spark_rapids_tpu_torch.entry.entry``: filter, then the sort-path
   aggregate of sum, count, min and max) at its defaults (1,000 rows) and
   at SF1's 6,001,215 rows with 50 and with 1,500,000 keys: every group
   equal to numpy's, ``segmented`` launched for its sum, min and max.
   Q22's flat gathers, replayed through
   ``gather_column``, must build no char matrix and launch the ragged
   entry once a call. Then each exchange alone: every lineitem row must
   land in the partition this script's numpy murmur3 pmod n names; the
   partition step of ``q1_hash_str``'s exchange must build no char
   matrix. Then
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
   between launches, the memory bound, and a PyTorch library yardstick
   (``segmented``: every call of the queries and the entry stage, its
   sum, min and max, beside ``torch.segment_reduce``);
   ``joinProbe``'s table clear beside its bound, and Q3's direct-address
   joins and ``bb_q05``'s dense left join whole and their slot
   preparation; the sort exec's permutation
   of SF1 lineitem by ``l_shipdate`` through ``sortStep`` against the
   stable lexsort route; the ragged ``strings`` gather at Q22's and
   ``group_ids cntrycode``'s calls beside the char-matrix route it
   replaced, with the payload's tail clear beside the bound, and the
   matrix entry at the largest of them; the rowwise compare at the
   ``group_ids`` shapes; the ragged ``hash`` calls of the queries (also
   against numpy
   murmur3), and the matrix entry with its char matrix at
   ``q1_hash_str``'s shape; the host snappy routine over every page of
   the SF1 lineitem files beside the host's memory copy rate;
5. one JSON line with every kernel, then the last line
   ``{"ok": true, "device": {...}}``.

Without CUDA, or without the package beside it, it exits non-zero and
prints no result. Long build logs go to ``chiprun_out/``.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import hashlib
import json
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

#: H100 SXM device memory rate (NVIDIA data sheet), bytes per second.
HBM_BYTES_PER_S = 3.35e12
#: Clock cycles of the spin ahead of each timed launch (~1 ms at 1.98 GHz).
SPIN_CYCLES = 2_000_000
D_1994_01_01 = 8766
D_1995_01_01 = 9131
D_1995_03_15 = 9204
D_1995_09_01 = 9374
D_1995_10_01 = 9404
D_1998_09_02 = 10471
Q22_CODES = ["13", "31", "23", "29", "30", "18", "17"]
#: Float sums and averages against numpy: the card adds in another order.
REV_RTOL = 1e-9
#: ``xbb_score``'s ``max_score`` against numpy, in units in the last place:
#: it goes through ``exp``, whose CUDA and numpy versions may differ there.
MAX_SCORE_ULPS = 4
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
#: The script's start, for the elapsed times its progress lines print.
T_START = time.perf_counter()


def at() -> str:
    """Seconds since the script started, for progress lines."""
    return f"[{time.perf_counter() - T_START:.1f} s]"


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
    cases["duplicate keys"] = (kb, rng.integers(0, tbl, cap_p), tbl)
    cases["every probed slot empty"] = (
        rng.integers(0, tbl // 2, cap_b), rng.integers(tbl // 2, tbl, cap_p),
        tbl)
    one = np.full(cap_b, tbl)
    one[cap_b // 3] = 17
    cases["one live row"] = (one, rng.integers(0, tbl, cap_p), tbl)
    cases["all rows dead"] = (np.full(cap_b, tbl),
                              rng.integers(0, tbl, cap_p), tbl)
    wild = rng.integers(-tbl, 2 * tbl, cap_b)
    cases["out-of-range slots"] = (wild, rng.integers(-5, tbl + 5, cap_p),
                                   tbl)
    cases["a table of one slot"] = (rng.integers(-1, 3, cap_b),
                                    rng.integers(-2, 3, cap_p), 1)
    cases["no build rows"] = (np.zeros(0, np.int64),
                              rng.integers(0, tbl, cap_p), tbl)
    cases["every build row unusable"] = (
        np.where(rng.random(cap_b) < 0.5, rng.integers(-9, 0, cap_b),
                 rng.integers(tbl, tbl + 9, cap_b)),
        rng.integers(0, tbl, cap_p), tbl)
    every = np.full(1 << 20, 5)
    cases["one slot hit by every row"] = (every, rng.integers(0, 9, cap_p),
                                          tbl)
    last = np.full(1 << 20, tbl)
    last[-3:] = [7, 9, 7]
    cases["only the last rows live"] = (last, rng.integers(0, 12, cap_p), tbl)
    runs = np.repeat(np.arange(1 << 18), rng.integers(1, 8, 1 << 18))
    clustered = np.where(rng.random(len(runs)) < 0.4, tbl, runs % tbl)
    cases["clustered keys (runs of 1-7 rows)"] = (
        clustered, rng.integers(0, tbl, cap_p), tbl)
    for name, (b, p, t) in cases.items():
        bs = torch.as_tensor(b, dtype=torch.int32, device=dev)
        ps = torch.as_tensor(p, dtype=torch.int32, device=dev)
        want = JP.dense_build_probe_plain(bs, ps, t)
        before = JP.dense_build_probe.launches
        got = JP.dense_build_probe(bs, ps, t)
        torch.cuda.synchronize()
        check(JP.dense_build_probe.launches == before + int(bs.is_cuda),
              f"joinProbe '{name}' did not count one launch")
        for g, w, what in zip(got, want, ("count", "row", "max")):
            check(bits_equal(torch, g, w),
                  f"joinProbe '{name}': {what} differs from the plain version")
        print(f"  joinProbe {name}: equal (max {int(want[2])})")


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


def gather_strings_edge_cases(torch, SG, bucket_byte_capacity, seed, dev):
    """The ragged gather against its plain version, bit for bit, on every
    case of the package's ``strings_cases`` by every row count (one tile
    of 1,024 and either side of it; several tiles, so the look-back runs)
    by W 8 and 128, with no source rows, and at W 2^21 over 5 rows (the
    tile sums in int64); each call must count one launch."""
    from spark_rapids_tpu_torch.ops.kernels.cuda import strings_cases as SC

    def one(name, m, w, what, empty_source=False):
        payload, offsets, idx, valid = (
            torch.as_tensor(a, device=dev)
            for a in SC.gather_strings_case(name, m, w, seed))
        if empty_source:
            payload, offsets = payload[:0], offsets[:1]
        args = (payload, offsets, idx, valid, w,
                bucket_byte_capacity(idx.shape[0] * w))
        before = SG.gather_strings.launches
        got = SG.gather_strings(*args)
        check(SG.gather_strings.launches == before + 1,
              f"ragged gather {what}: not one launch")
        want = SG.gather_strings_plain(*args)
        torch.cuda.synchronize()
        check(bits_equal(torch, got[1], want[1]),
              f"ragged gather {what}: offsets differ from the plain version")
        check(bits_equal(torch, got[0], want[0]),
              f"ragged gather {what}: payload differs from the plain version")
    for w in SC.GATHER_WIDTHS:
        for name in SC.GATHER_CASES:
            for m in SC.GATHER_CARD_ROWS:
                one(name, m, w, f"'{name}' m={m} W={w}")
        one("mixed", 257, w, f"no source rows W={w}", empty_source=True)
        print(f"  ragged strings gather W={w}: {len(SC.GATHER_CASES)} cases "
              f"x m {SC.GATHER_CARD_ROWS} and no source rows equal to the "
              "plain version")
    wide = 1 << 21
    for name in ("mixed", "negative lengths", "wrapped lengths"):
        one(name, 5, wide, f"'{name}' m=5 W={wide}")
    print(f"  ragged strings gather W={wide}: 3 cases x m 5 equal to the "
          "plain version")


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


def ragged_hash_case(rng, kind: str, n: int, w: int):
    """(payload uint8, offsets int32, codes int32 or None, seed uint32
    bits as int32) of one ragged ``hash`` case: entry lengths 0-5, W and
    past W, bytes over 0-255, entries from unaligned payload bytes; a
    dictionary of a few dozen entries with codes out of range on both
    sides, a flat column of one entry a row, or a flat column whose
    offsets step back (negative lengths)."""
    m = 3 + min(n, 40) if kind == "dictionary" else n
    lens = rng.integers(0, w + 1, m)
    pick = rng.random(m)
    lens[pick < 0.3] = rng.integers(0, 6, int((pick < 0.3).sum()))
    lens[(pick >= 0.3) & (pick < 0.4)] = w
    past = (pick >= 0.4) & (pick < 0.5)
    lens[past] = w + rng.integers(1, 10, int(past.sum()))
    offsets = 1 + np.concatenate([[0], np.cumsum(lens)])
    if kind == "negative lengths":
        back = np.flatnonzero(rng.random(m) < 0.2) + 1
        offsets[back] = np.maximum(offsets[back - 1] - rng.integers(
            1, 4, len(back)), 0)
    payload = rng.integers(0, 256, int(offsets.max()) + 7).astype(np.uint8)
    codes = None
    if kind == "dictionary":
        codes = rng.integers(0, m, n)
        wild = rng.random(n) < 0.1
        codes[wild] = rng.integers(-5, m + 5, int(wild.sum()))
        codes = codes.astype(np.int32)
    seed = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    return payload, offsets.astype(np.int32), codes, seed.view(np.int32)


def np_hash_layout(payload, offsets, codes, w: int, seed) -> np.ndarray:
    """This script's numpy murmur3 of each row of a string layout: row r
    is entry ``codes[r]`` clamped into the dictionary (entry r without
    codes); its bytes are the entry's first ``min(length, W)`` (W a
    multiple of 4), read from the payload with positions clamped into
    it; the full length is folded in. The byte matrix is only as wide as
    the longest row needs."""
    offsets = np.asarray(offsets, np.int64)
    entries = len(offsets) - 1
    rows = np.arange(len(seed)) if codes is None \
        else np.clip(np.asarray(codes, np.int64), 0, entries - 1)
    start, lens = offsets[rows], (offsets[1:] - offsets[:-1])[rows]
    need = int(np.clip(lens, 0, w).max(initial=0))
    width = w if (lens > w).any() else max(4, -(-need // 4) * 4)
    pos = start[:, None] + np.arange(min(width, max(need, 1)))[None, :]
    raw = np.zeros((len(rows), width), np.uint8)
    raw[:, :pos.shape[1]] = np.asarray(payload)[np.clip(pos, 0,
                                                        len(payload) - 1)]
    raw[np.arange(width)[None, :] >= lens[:, None]] = 0
    return np_murmur3_bytes(raw, lens, np.asarray(seed).view(np.uint32))


def ragged_hash_edge_cases(torch, HK, T, DC, PN, rng, dev):
    """The ragged entry against its plain version and numpy on layouts,
    then whole columns with null rows through the row hash: a null row
    keeps the running hash."""
    from spark_rapids_tpu_torch.data.column import dictionary_column
    for kind in ("dictionary", "flat", "negative lengths"):
        for w in (4, 8, 128):
            for n in (1, 255, 256, 257, 100_003):
                payload, offsets, codes, seed = ragged_hash_case(rng, kind,
                                                                 n, w)
                args = [None if a is None else torch.as_tensor(a, device=dev)
                        for a in (payload, offsets, codes, seed)]
                before = HK.murmur3_string_rows.launches
                got = HK.murmur3_string_rows(*args[:3], w, args[3])
                want = HK.murmur3_string_rows_plain(*args[:3], w, args[3])
                torch.cuda.synchronize()
                check(HK.murmur3_string_rows.launches
                      == before + int(args[0].is_cuda),
                      f"ragged hash {kind} n={n} W={w}: not one launch")
                check(bits_equal(torch, got, want), f"ragged hash {kind} "
                      f"n={n} W={w}: differs from the plain version")
                check(np.array_equal(got.cpu().numpy().view(np.uint32),
                                     np_hash_layout(payload, offsets, codes,
                                                    w, seed)),
                      f"ragged hash {kind} n={n} W={w}: differs from the "
                      "numpy murmur3")
        print(f"  ragged hash {kind}: W 4/8/128, n 1/255/256/257/100003 "
              "equal to the plain version and to numpy")
    n = 100_003
    words = np.array(["", "A", "N", "R", "apple", "dragonfruit",
                      "\u00e9t\u00e9", "x" * 20])
    values = words[rng.integers(0, len(words), n)]
    valid = rng.random(n) < 0.8
    enc = [v.encode("utf-8") for v in values]
    offsets = np.concatenate([[0], np.cumsum([len(e) for e in enc])])
    flat = DC(torch.as_tensor(np.frombuffer(b"".join(enc) + b"\0", np.uint8)
                              .copy(), device=dev),
              torch.as_tensor(valid, device=dev), T.STRING,
              offsets=torch.as_tensor(offsets.astype(np.int32), device=dev),
              max_bytes=128)
    uniq, inv = np.unique(values, return_inverse=True)
    dic = dictionary_column(
        torch.as_tensor(np.where(valid, inv, 0).astype(np.int32), device=dev),
        torch.as_tensor(valid, device=dev), uniq)
    seed42 = np.full(n, SPARK_SEED, np.uint32)
    want1 = np.where(valid, np_hash_strings(values, seed42), seed42)
    want2 = np.where(valid, np_hash_strings(values, want1), want1)
    for name, cols in (("dictionary", [dic]), ("flat", [flat]),
                       ("flat then dictionary", [flat, dic])):
        before = HK.murmur3_string_rows.launches
        got = PN.spark_hash_columns_device(cols).cpu().numpy().view(
            np.uint32)
        check(HK.murmur3_string_rows.launches
              == before + len(cols) * int(dic.codes.is_cuda),
              f"row hash over {name}: not one ragged launch a column")
        check(np.array_equal(got, want1 if len(cols) == 1 else want2),
              f"row hash over {name} with null rows differs from numpy")
    print("  row hash of dictionary and flat columns with null rows: equal "
          "to numpy")


# --------------------------------------------------------------------------
# phase 3: Q3 and its numpy reference
# --------------------------------------------------------------------------


def numpy_q3(tables, k: int = 11):
    """Q3 in plain numpy, independent of the port: sorted-key joins by
    ``np.searchsorted``, a lexsort group-by, a stable descending sort.
    Returns the first ``k`` rows' columns."""
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
    return {"o_orderkey": gkey[start][top], "o_orderdate": gdate[start][top],
            "revenue": sums[top]}


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


def _lookup(build_keys, probe_keys):
    """(hit, row): each probe key's row in a table whose keys are unique
    (the build side of a direct-address join), and whether it has one."""
    order = np.argsort(build_keys, kind="stable")
    sk = build_keys[order]
    pos = np.minimum(np.searchsorted(sk, probe_keys), max(len(sk) - 1, 0))
    hit = (len(sk) > 0) & (sk[pos] == probe_keys)
    return hit, order[pos]


def _rev(li, m):
    return li["l_extendedprice"][m] * (1.0 - li["l_discount"][m])


def numpy_q5(tables):
    """Revenue per nation over customer, orders of 1994, lineitem,
    supplier and nation."""
    c, o, li = (tables[t].columns for t in ("customer", "orders",
                                            "lineitem"))
    s, n = tables["supplier"].columns, tables["nation"].columns
    hit_o, orow = _lookup(o["o_orderkey"], li["l_orderkey"])
    od = o["o_orderdate"][orow]
    m = hit_o & (od >= D_1994_01_01) & (od < D_1995_01_01)
    m &= _lookup(c["c_custkey"], o["o_custkey"][orow])[0]
    hit_s, srow = _lookup(s["s_suppkey"], li["l_suppkey"])
    m &= hit_s
    hit_n, nrow = _lookup(n["n_nationkey"], s["s_nationkey"][srow])
    m &= hit_n
    keys, (rev,) = _group_sums([n["n_name"][nrow][m]], _rev(li, m))
    return {"n_name": keys[0], "revenue": rev}


def numpy_q10(tables):
    """Revenue per customer of the returned items of 1994's orders, the
    top 30 by revenue, then by customer key (the query keeps 20)."""
    c, o, li = (tables[t].columns for t in ("customer", "orders",
                                            "lineitem"))
    n = tables["nation"].columns
    hit_o, orow = _lookup(o["o_orderkey"], li["l_orderkey"])
    od = o["o_orderdate"][orow]
    m = hit_o & (od >= D_1994_01_01) & (od < D_1995_01_01) \
        & (li["l_returnflag"] == "R")
    hit_c, crow = _lookup(c["c_custkey"], o["o_custkey"][orow])
    hit_n, nrow = _lookup(n["n_nationkey"], c["c_nationkey"][crow])
    m &= hit_c & hit_n
    keys, (rev,) = _group_sums([c["c_custkey"][crow][m],
                                n["n_name"][nrow][m]], _rev(li, m))
    top = np.lexsort((keys[0], -rev))[:30]  # ties may cross rank 20
    return {"c_custkey": keys[0][top], "n_name": keys[1][top],
            "revenue": rev[top]}


def numpy_q12(tables):
    """High- and low-priority line counts per ship mode."""
    o, li = tables["orders"].columns, tables["lineitem"].columns
    mode, rd = li["l_shipmode"], li["l_receiptdate"]
    m = ((mode == "MAIL") | (mode == "SHIP")) \
        & (li["l_commitdate"] < rd) & (li["l_shipdate"] < li["l_commitdate"]) \
        & (rd >= D_1994_01_01) & (rd < D_1995_01_01)
    hit, orow = _lookup(o["o_orderkey"], li["l_orderkey"])
    m &= hit
    prio = o["o_orderpriority"][orow][m]
    high = ((prio == "1-URGENT") | (prio == "2-HIGH")).astype(np.int64)
    keys, (hi, lo) = _group_sums([mode[m]], high, 1 - high)
    return {"l_shipmode": keys[0], "high_line_count": hi,
            "low_line_count": lo}


def numpy_q14(tables):
    """Promotional and total revenue of September 1995's line items."""
    p, li = tables["part"].columns, tables["lineitem"].columns
    sd = li["l_shipdate"]
    hit, prow = _lookup(p["p_partkey"], li["l_partkey"])
    m = hit & (sd >= D_1995_09_01) & (sd < D_1995_10_01)
    rev = _rev(li, m)
    promo = np.char.startswith(p["p_type"][prow][m].astype(str), "PROMO")
    return {"promo": np.array([np.where(promo, rev, 0.0).sum()]),
            "total": np.array([rev.sum()])}


def numpy_q18(tables):
    """Customers of the orders whose quantity sums above 150: order count
    and total quantity, the top 100 by quantity, then by customer key."""
    c, o, li = (tables[t].columns for t in ("customer", "orders",
                                            "lineitem"))
    (okeys,), (qty,) = _group_sums([li["l_orderkey"]], li["l_quantity"])
    big = qty > 150.0
    okeys, qty = okeys[big], qty[big]
    hit_o, orow = _lookup(o["o_orderkey"], okeys)
    cust = o["o_custkey"][orow]
    hit_c, _ = _lookup(c["c_custkey"], cust)
    m = hit_o & hit_c
    (ckeys,), (cnt, tot) = _group_sums([cust[m]],
                                       np.ones(int(m.sum()), np.int64),
                                       qty[m])
    top = np.lexsort((ckeys, -tot))[:100]
    return {"c_custkey": ckeys[top], "n_orders": cnt[top],
            "total_qty": tot[top]}


def numpy_q19(tables):
    """Revenue of the air-shipped line items in either quantity band of
    their part's type."""
    p, li = tables["part"].columns, tables["lineitem"].columns
    mode, qty = li["l_shipmode"], li["l_quantity"]
    hit, prow = _lookup(p["p_partkey"], li["l_partkey"])
    m = hit & ((mode == "AIR") | (mode == "REG AIR")) & (qty <= 30.0)
    ptype = p["p_type"][prow].astype(str)
    band = (np.char.startswith(ptype, "PROMO") & (qty <= 11.0)) \
        | (np.char.startswith(ptype, "STANDARD") & (qty >= 10.0)
           & (qty <= 20.0))
    m &= band
    return {"revenue": np.array([_rev(li, m).sum()])}


def numpy_xbb_score(tables):
    """The average and largest logistic score and the line count per
    return flag; the linear term adds in the query's association."""
    li = tables["lineitem"].columns
    z = (li["l_quantity"] * 0.37 + li["l_extendedprice"] * -0.00021) \
        + (li["l_discount"] * 14.2 + li["l_tax"] * -7.1)
    score = 1.0 / (1.0 + np.exp(-z))
    flag = li["l_returnflag"]
    keys, (total, cnt) = _group_sums([flag], score,
                                     np.ones(len(score), np.int64))
    order = np.argsort(flag, kind="stable")
    start = np.flatnonzero(np.r_[True, flag[order][1:] != flag[order][:-1]])
    return {"l_returnflag": keys[0], "avg_score": total / cnt,
            "max_score": np.maximum.reduceat(score[order], start),
            "n": cnt}


def numpy_sort(tables):
    """All of lineitem by ``l_shipdate``, stable: ties keep table order."""
    li = tables["lineitem"].columns
    order = np.argsort(li["l_shipdate"], kind="stable")
    return {"l_orderkey": li["l_orderkey"][order],
            "l_shipdate": li["l_shipdate"][order]}


D_1996_01_01 = 9496
D_1996_04_01 = 9587
D_1996_12_31 = 9861


def _year(days):
    """The proleptic Gregorian year of each day number (numpy's
    ``datetime64`` calendar)."""
    return days.astype("datetime64[D]").astype("datetime64[Y]").astype(
        np.int64) + 1970


def _order(*keys):
    """The permutation that sorts by ``keys``, the first the most
    significant (``np.lexsort`` takes them the other way round)."""
    return np.lexsort(tuple(reversed(keys)))


def _cols(d: dict, rows) -> dict:
    return {k: np.asarray(v)[rows] for k, v in d.items()}


def numpy_q2(tables):
    """The cheapest European suppliers of size-15/25/35/45 BRUSHED parts,
    the top 100 by account balance, then nation, supplier and part."""
    s, n, r = (tables[t].columns for t in ("supplier", "nation", "region"))
    ps, p = tables["partsupp"].columns, tables["part"].columns
    hit_n, nrow = _lookup(n["n_nationkey"], s["s_nationkey"])
    hit_r, rrow = _lookup(r["r_regionkey"], n["n_regionkey"][nrow])
    europe = hit_n & hit_r & (r["r_name"][rrow] == "EUROPE")
    hit_s, srow = _lookup(s["s_suppkey"], ps["ps_suppkey"])
    m = hit_s & europe[srow]
    pk, cost, srow = ps["ps_partkey"][m], ps["ps_supplycost"][m], srow[m]
    (keys,), _ = _group_sums([pk], np.zeros(len(pk)))
    order = _order(pk, cost)
    first = np.flatnonzero(np.r_[True, pk[order][1:] != pk[order][:-1]])
    min_cost = cost[order][first]
    is_min = cost == min_cost[np.searchsorted(keys, pk)]
    hit_p, prow = _lookup(p["p_partkey"], pk)
    size = p["p_size"][prow]
    keep = hit_p & is_min & np.isin(size, [15, 25, 35, 45]) & np.char.endswith(
        p["p_type"][prow].astype(str), "BRUSHED")
    out = {"s_acctbal": s["s_acctbal"][srow][keep],
           "s_name": s["s_name"][srow][keep],
           "n_name": n["n_name"][nrow[srow]][keep],
           "p_partkey": pk[keep], "p_mfgr": p["p_mfgr"][prow][keep],
           "ps_supplycost": cost[keep]}
    top = _order(-out["s_acctbal"], out["n_name"], out["s_name"],
                 out["p_partkey"])[:100]
    return _cols(out, top)


def numpy_q7(tables):
    """Shipping volume between FRANCE and GERMANY by supplier nation,
    customer nation and ship year (1995-1996)."""
    s, li, o, c, n = (tables[t].columns for t in (
        "supplier", "lineitem", "orders", "customer", "nation"))
    sd = li["l_shipdate"]
    m = (sd >= D_1995_01_01) & (sd <= D_1996_12_31)
    hit_s, srow = _lookup(s["s_suppkey"], li["l_suppkey"])
    hit_o, orow = _lookup(o["o_orderkey"], li["l_orderkey"])
    hit_c, crow = _lookup(c["c_custkey"], o["o_custkey"][orow])
    hit_n1, n1 = _lookup(n["n_nationkey"], s["s_nationkey"][srow])
    hit_n2, n2 = _lookup(n["n_nationkey"], c["c_nationkey"][crow])
    supp, cust = n["n_name"][n1], n["n_name"][n2]
    m &= hit_s & hit_o & hit_c & hit_n1 & hit_n2 & (
        ((supp == "FRANCE") & (cust == "GERMANY"))
        | ((supp == "GERMANY") & (cust == "FRANCE")))
    keys, (rev,) = _group_sums([supp[m], cust[m], _year(sd[m])],
                               _rev(li, m))
    return {"supp_nation": keys[0], "cust_nation": keys[1],
            "l_year": keys[2], "revenue": rev}


def numpy_q8(tables):
    """BRAZIL's share of AMERICA's STANDARD POLISHED volume per order
    year (1995-1996)."""
    p, li, s, o, c, n, r = (tables[t].columns for t in (
        "part", "lineitem", "supplier", "orders", "customer", "nation",
        "region"))
    hit_p, prow = _lookup(p["p_partkey"], li["l_partkey"])
    hit_s, srow = _lookup(s["s_suppkey"], li["l_suppkey"])
    hit_o, orow = _lookup(o["o_orderkey"], li["l_orderkey"])
    od = o["o_orderdate"][orow]
    hit_c, crow = _lookup(c["c_custkey"], o["o_custkey"][orow])
    hit_n1, n1 = _lookup(n["n_nationkey"], c["c_nationkey"][crow])
    hit_r, rrow = _lookup(r["r_regionkey"], n["n_regionkey"][n1])
    hit_n2, n2 = _lookup(n["n_nationkey"], s["s_nationkey"][srow])
    m = hit_p & hit_s & hit_o & hit_c & hit_n1 & hit_r & hit_n2 \
        & (p["p_type"][prow] == "STANDARD POLISHED") \
        & (od >= D_1995_01_01) & (od <= D_1996_12_31) \
        & (r["r_name"][rrow] == "AMERICA")
    rev = _rev(li, m)
    brazil = np.where(n["n_name"][n2][m] == "BRAZIL", rev, 0.0)
    (years,), (b, total) = _group_sums([_year(od[m])], brazil, rev)
    return {"o_year": years, "mkt_share": b / total}


def _pair_ranges(build_a, build_b, probe_a, probe_b):
    """Each probe pair's rows in the build side, which may repeat a pair
    (non-negative keys): (the build side's sorting permutation, each
    probe pair's first position in it, its number of rows)."""
    base = int(max(build_b.max(initial=0), probe_b.max(initial=0))) + 1
    bkey = build_a.astype(np.int64) * base + build_b
    pkey = probe_a.astype(np.int64) * base + probe_b
    order = np.argsort(bkey, kind="stable")
    lo = np.searchsorted(bkey[order], pkey)
    return order, lo, np.searchsorted(bkey[order], pkey, "right") - lo


def _expand(lo, cnt):
    """The positions ``lo[i] .. lo[i] + cnt[i] - 1`` of every i, in
    order."""
    first = np.cumsum(cnt) - cnt
    return np.repeat(lo, cnt) + np.arange(int(cnt.sum())) \
        - np.repeat(first, cnt)


def numpy_q9(tables):
    """Profit on "green" parts by supplier nation and order year."""
    p, li, s, ps, o, n = (tables[t].columns for t in (
        "part", "lineitem", "supplier", "partsupp", "orders", "nation"))
    green = np.flatnonzero(np.char.find(p["p_name"].astype(str),
                                        "green") >= 0)
    hit_p, _ = _lookup(p["p_partkey"][green], li["l_partkey"])
    rows = np.flatnonzero(hit_p)
    hit_s, srow = _lookup(s["s_suppkey"], li["l_suppkey"][rows])
    hit_o, orow = _lookup(o["o_orderkey"], li["l_orderkey"][rows])
    hit_n, nrow = _lookup(n["n_nationkey"], s["s_nationkey"][srow])
    keep = hit_s & hit_o & hit_n
    rows, srow, orow, nrow = rows[keep], srow[keep], orow[keep], nrow[keep]
    order, lo, cnt = _pair_ranges(ps["ps_partkey"], ps["ps_suppkey"],
                                  li["l_partkey"][rows],
                                  li["l_suppkey"][rows])
    rep = np.repeat(np.arange(len(rows)), cnt)
    psrow = order[_expand(lo, cnt)]
    r = rows[rep]
    amount = li["l_extendedprice"][r] * (1.0 - li["l_discount"][r]) \
        - ps["ps_supplycost"][psrow] * li["l_quantity"][r]
    name, year = n["n_name"][nrow[rep]], _year(o["o_orderdate"][orow[rep]])
    keys, (profit,) = _group_sums([name, year], amount)
    out = {"n_name": keys[0], "o_year": keys[1], "sum_profit": profit}
    return _cols(out, _order(out["n_name"], -out["o_year"]))


def numpy_q11(tables):
    """GERMANY's parts whose stock value exceeds 0.0001 of the total, by
    value descending, then part key."""
    ps, s, n = (tables[t].columns for t in ("partsupp", "supplier",
                                            "nation"))
    hit_s, srow = _lookup(s["s_suppkey"], ps["ps_suppkey"])
    hit_n, nrow = _lookup(n["n_nationkey"], s["s_nationkey"][srow])
    m = hit_s & hit_n & (n["n_name"][nrow] == "GERMANY")
    value = ps["ps_supplycost"][m] * ps["ps_availqty"][m]
    threshold = value.sum() * 0.0001
    (parts,), (by_part,) = _group_sums([ps["ps_partkey"][m]], value)
    keep = by_part > threshold
    out = {"ps_partkey": parts[keep], "value": by_part[keep]}
    return _cols(out, _order(-out["value"], out["ps_partkey"]))


def numpy_q13(tables):
    """How many customers have each count of orders whose comment is not
    "special ... requests"."""
    c, o = tables["customer"].columns, tables["orders"].columns
    comment = o["o_comment"].astype(str)
    special = (np.char.find(comment, "special") >= 0) \
        & (np.char.find(comment, "requests") >= 0)
    hit, crow = _lookup(c["c_custkey"], o["o_custkey"][~special])
    per_cust = np.bincount(crow[hit], minlength=len(c["c_custkey"]))
    counts, dist = np.unique(per_cust, return_counts=True)
    out = {"c_count": counts.astype(np.int64),
           "custdist": dist.astype(np.int64)}
    return _cols(out, _order(-out["custdist"], -out["c_count"]))


def numpy_q15(tables):
    """The suppliers with the largest revenue of 1996's first quarter."""
    li, s = tables["lineitem"].columns, tables["supplier"].columns
    sd = li["l_shipdate"]
    m = (sd >= D_1996_01_01) & (sd < D_1996_04_01)
    (supp,), (rev,) = _group_sums([li["l_suppkey"][m]], _rev(li, m))
    top = rev == rev.max()
    hit, srow = _lookup(s["s_suppkey"], supp[top])
    out = {"s_suppkey": supp[top][hit], "s_name": s["s_name"][srow][hit],
           "total_revenue": rev[top][hit]}
    return _cols(out, np.argsort(out["s_suppkey"], kind="stable"))


def numpy_q16(tables):
    """Suppliers without complaints per brand, type and size of the
    qualifying parts, counted once each."""
    p, ps, s = (tables[t].columns for t in ("part", "partsupp",
                                            "supplier"))
    hit, prow = _lookup(p["p_partkey"], ps["ps_partkey"])
    ptype = p["p_type"][prow].astype(str)
    complained = s["s_suppkey"][np.char.find(
        s["s_comment"].astype(str), "Complaints") >= 0]
    m = hit & (p["p_brand"][prow] != "Brand#45") \
        & ~np.char.startswith(ptype, "MEDIUM") \
        & np.isin(p["p_size"][prow], [3, 9, 14, 19, 23, 36, 45, 49]) \
        & ~np.isin(ps["ps_suppkey"], complained)
    distinct, _ = _group_sums([p["p_brand"][prow][m], p["p_type"][prow][m],
                               p["p_size"][prow][m], ps["ps_suppkey"][m]],
                              np.zeros(int(m.sum())))
    (brand, ptype, size), (cnt,) = _group_sums(
        distinct[:3], np.ones(len(distinct[0]), np.int64))
    out = {"p_brand": brand, "p_type": ptype, "p_size": size,
           "supplier_cnt": cnt}
    return _cols(out, _order(-out["supplier_cnt"], out["p_brand"],
                             out["p_type"], out["p_size"]))


def numpy_q17(tables):
    """The yearly average price of Brand#23 MED BOX lines with a quantity
    below 0.2 of their part's average."""
    p, li = tables["part"].columns, tables["lineitem"].columns
    pk, qty = li["l_partkey"], li["l_quantity"]
    (parts,), (total, cnt) = _group_sums([pk], qty,
                                         np.ones(len(pk), np.int64))
    limit = 0.2 * (total / cnt)
    hit_p, prow = _lookup(p["p_partkey"], pk)
    m = hit_p & (p["p_brand"][prow] == "Brand#23") \
        & (p["p_container"][prow] == "MED BOX")
    m &= qty < limit[np.searchsorted(parts, pk)]
    return {"avg_yearly": np.array([li["l_extendedprice"][m].sum() / 7.0])}


def numpy_q20(tables):
    """Suppliers of five nations with forest-part stock above half their
    1994-1995 shipments, by name."""
    p, ps, li, s, n = (tables[t].columns for t in (
        "part", "partsupp", "lineitem", "supplier", "nation"))
    sd = li["l_shipdate"]
    m = (sd >= D_1994_01_01) & (sd < D_1996_01_01)
    (sp, ss), (qty,) = _group_sums([li["l_partkey"][m],
                                    li["l_suppkey"][m]], li["l_quantity"][m])
    forest = p["p_partkey"][np.char.startswith(p["p_name"].astype(str),
                                               "forest")]
    f = np.flatnonzero(np.isin(ps["ps_partkey"], forest))
    order, lo, cnt = _pair_ranges(sp, ss, ps["ps_partkey"][f],
                                  ps["ps_suppkey"][f])
    found = cnt > 0
    half = 0.5 * qty[order[np.minimum(lo, max(len(order) - 1, 0))]]
    good = found & (ps["ps_availqty"][f] > half)
    qualifying = ps["ps_suppkey"][f][good]
    hit_n, nrow = _lookup(n["n_nationkey"], s["s_nationkey"])
    keep = hit_n & np.isin(n["n_name"][nrow], ["CANADA", "CHINA", "FRANCE",
                                               "GERMANY", "RUSSIA"]) \
        & np.isin(s["s_suppkey"], qualifying)
    return {"s_name": np.sort(s["s_name"][keep])}


def numpy_q21(tables):
    """SAUDI ARABIA's suppliers that alone kept a multi-supplier F order
    waiting: late lines per supplier, the top 100, then by name."""
    s, n, li, o = (tables[t].columns for t in ("supplier", "nation",
                                               "lineitem", "orders"))
    ok, sk = li["l_orderkey"], li["l_suppkey"]
    late = li["l_receiptdate"] > li["l_commitdate"]

    def distinct_per_order(mask):
        pairs = np.unique(ok[mask] * (int(sk.max()) + 1) + sk[mask])
        orders, cnt = np.unique(pairs // (int(sk.max()) + 1),
                                return_counts=True)
        return orders, cnt

    so, n_supp = distinct_per_order(np.ones(len(ok), bool))
    lo_, n_late = distinct_per_order(late)
    f_orders = o["o_orderkey"][o["o_orderstatus"] == "F"]
    hit_s, srow = _lookup(s["s_suppkey"], sk)
    hit_n, nrow = _lookup(n["n_nationkey"], s["s_nationkey"][srow])
    m = late & hit_s & hit_n & (n["n_name"][nrow] == "SAUDI ARABIA") \
        & np.isin(ok, f_orders)
    hit_a, arow = _lookup(so, ok)
    hit_b, brow = _lookup(lo_, ok)
    m &= hit_a & hit_b & (n_supp[arow] > 1) & (n_late[brow] == 1)
    (names,), (cnt,) = _group_sums([s["s_name"][srow][m]],
                                   np.ones(int(m.sum()), np.int64))
    out = {"s_name": names, "numwait": cnt}
    return _cols(out, _order(-out["numwait"], out["s_name"])[:100])


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


class CharMatrixWatch:
    """Counts, while it stands, every call of a package function that
    builds a char matrix (``char_matrix``, ``_matrix_from_offsets``, in
    every module that binds one)."""

    NAMES = ("char_matrix", "_matrix_from_offsets")

    def __enter__(self):
        from spark_rapids_tpu_torch.ops import strings as S
        from spark_rapids_tpu_torch.ops import strings_util as SU
        from spark_rapids_tpu_torch.ops.kernels import concat as KC
        from spark_rapids_tpu_torch.ops.kernels import groupby as KG
        from spark_rapids_tpu_torch.ops.kernels import rowops as KR
        from spark_rapids_tpu_torch.ops.kernels.cuda import strings as SG
        from spark_rapids_tpu_torch.shuffle import partitioning as PN
        self.built, self.patched = [], []
        for mod in (SU, S, KC, KG, KR, PN, SG):
            for name in self.NAMES:
                fn = getattr(mod, name, None)
                if fn is None:
                    continue

                def counting(*a, _fn=fn, _name=name, **k):
                    self.built.append(_name)
                    return _fn(*a, **k)
                self.patched.append((mod, name, fn))
                setattr(mod, name, counting)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.patched:
            setattr(mod, name, fn)


def check_no_char_matrix(torch, HK, batch, col) -> dict:
    """The partition step of ``q1_hash_str``'s exchange (the hash
    partitioner over ``l_returnflag, l_linestatus``, then the sort by
    id) on lineitem, with every function of the package that builds a
    char matrix counting its calls: none may run, and the ragged ``hash``
    entry must launch once a key column."""
    from spark_rapids_tpu_torch.shuffle import exchange as EX
    from spark_rapids_tpu_torch.shuffle import partitioners as PR
    with CharMatrixWatch() as watch:
        part = PR.HashPartitioner([col("l_returnflag"), col("l_linestatus")],
                                  16, batch.schema)
        before = HK.murmur3_string_rows.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        EX.partition_sort(batch, part, 16)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = HK.murmur3_string_rows.launches - before
    check(not watch.built,
          f"the hash partition step built a char matrix: {watch.built}")
    check(launched == 2, f"the hash partition step launched the ragged hash "
          f"{launched} times, expected 2")
    print(f"  q1_hash_str partition step over {batch.capacity} rows: no char "
          f"matrix built ({len(watch.patched)} functions watched), ragged "
          f"hash launched {launched} times, {ms:.3f} ms")
    return {"char_matrices": len(watch.built), "ragged_launches": launched,
            "ms": ms}


def check_flat_gathers(torch, SG, KR, T, DeviceColumn, gathers) -> dict:
    """Q22's captured flat-string gathers replayed through
    ``gather_column`` (each as a column whose rows are all valid, with the
    call's validity as the index validity), every char-matrix builder
    counting: none may run, the ragged entry must launch once a call, and
    the column must be the captured call's kernel output and validity."""
    launched = 0
    with CharMatrixWatch() as watch:
        for payload, offsets, idx, valid, width, byte_cap in gathers:
            n = offsets.numel() - 1
            col = DeviceColumn(payload, torch.ones(n, dtype=torch.bool,
                                                   device=payload.device),
                               T.STRING, offsets=offsets, max_bytes=width)
            before = SG.gather_strings.launches
            got = KR.gather_column(col, idx, valid)
            launched += SG.gather_strings.launches - before
            want = SG.gather_strings(payload, offsets, idx, valid, width,
                                     byte_cap)
            check(bits_equal(torch, got.offsets, want[1])
                  and bits_equal(torch, got.data, want[0])
                  and bits_equal(torch, got.validity, valid.bool()),
                  f"gather_column over Q22's flat gather m={idx.numel()} "
                  "differs from the ragged entry")
    check(not watch.built, f"Q22's flat gathers built a char matrix: "
          f"{watch.built}")
    check(launched == len(gathers), f"Q22's {len(gathers)} flat gathers "
          f"launched the ragged entry {launched} times through gather_column")
    print(f"  Q22's {len(gathers)} flat gathers through gather_column: no "
          f"char matrix built ({len(watch.patched)} functions watched), the "
          f"ragged entry launched once a call, columns equal")
    return {"calls": len(gathers), "char_matrices": len(watch.built),
            "ragged_launches": launched}


#: (key or exact columns, float columns) of each query's answer.
ANSWERS = {
    "q1": (["l_returnflag", "l_linestatus", "count_order"],
           ["sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
            "avg_qty", "avg_disc"]),
    "q4": (["o_orderpriority", "order_count"], []),
    "q6": ([], ["revenue"]),
    "q22": (["cntrycode", "numcust"], ["totacctbal"]),
    "sort": (["l_orderkey", "l_shipdate"], []),
    "q5": (["n_name"], ["revenue"]),
    "q12": (["l_shipmode", "high_line_count", "low_line_count"], []),
    "q14": ([], ["promo", "total"]),
    "q18": (["c_custkey", "n_orders", "total_qty"], []),
    "q19": ([], ["revenue"]),
    "xbb_score": (["l_returnflag", "n"], ["avg_score"]),
    "q2": (["s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
            "ps_supplycost"], []),
    "q7": (["supp_nation", "cust_nation", "l_year"], ["revenue"]),
    "q8": (["o_year"], ["mkt_share"]),
    "q9": (["n_name", "o_year"], ["sum_profit"]),
    "q13": (["c_count", "custdist"], []),
    "q15": (["s_suppkey", "s_name"], ["total_revenue"]),
    "q16": (["p_brand", "p_type", "p_size", "supplier_cnt"], []),
    "q17": ([], ["avg_yearly"]),
    "q20": (["s_name"], []),
    "q21": (["s_name", "numwait"], []),
}
NUMPY_REFS = {"q1": numpy_q1, "q4": numpy_q4, "q6": numpy_q6,
              "q22": numpy_q22, "sort": numpy_sort, "q5": numpy_q5,
              "q10": numpy_q10, "q12": numpy_q12, "q14": numpy_q14,
              "q18": numpy_q18, "q19": numpy_q19,
              "xbb_score": numpy_xbb_score, "q2": numpy_q2, "q7": numpy_q7,
              "q8": numpy_q8, "q9": numpy_q9, "q11": numpy_q11,
              "q13": numpy_q13, "q15": numpy_q15, "q16": numpy_q16,
              "q17": numpy_q17, "q20": numpy_q20, "q21": numpy_q21}
#: The other eleven TPC-H queries (the reference's ``workloads/tpch.py``
#: beyond the bench suite, Q10, Q18 and Q22).
REST_QUERIES = ("q2", "q7", "q8", "q9", "q11", "q13", "q15", "q16", "q17",
                "q20", "q21")


# --------------------------------------------------------------------------
# phase 3: the TPCxBB entries and their numpy references
# --------------------------------------------------------------------------

#: Click count of the TPCxBB tables the bench suite writes to parquet
#: (``bench.py``'s ``tpcxbb.gen_tables(1 << 17)``).
BENCH_XBB_CLICKS = 1 << 17
#: The TPCxBB tables the three entries read, plus customer.
XBB_TABLES = ("item", "customer", "web_clickstreams", "store_sales",
              "web_sales")
#: The bench suite's TPCxBB entries (``bench.py``), the ``pq_bb_*`` cells.
BENCH_XBB = ("q01", "q05", "q30")
#: The kernels a ``bb_*`` cell's cold run must launch.
XBB_NEED = {"q05": ("joinProbe",), "q30": ("joinProbe",)}
#: Counts a TPCxBB reference returns beside its answer: q01's self-join
#: rows, q30's sessions, and the equi pairs of q03's and q12's joins
#: with a residual condition.
XBB_AUX = {"q01": "join_rows", "q30": "sessions", "q03": "pairs",
           "q12": "pairs"}
SESSION_GAP = 3600


def _top_by_count(cnt, key_a, key_b, names, n: int) -> dict:
    """The first ``n`` rows by ``cnt`` descending, then the two keys
    ascending (the queries' ORDER BY)."""
    order = np.lexsort((key_b, key_a, -cnt))[:n]
    return {names[0]: key_a[order], names[1]: key_b[order],
            "cnt": cnt[order]}


def numpy_bb_q01(tables, n: int = 100) -> dict:
    """Basket analysis in numpy: every ordered pair of store_sales rows on
    one ticket (the self-join, enumerated ticket by ticket after a stable
    sort), kept where ``item_a < item_b``, counted per item pair, pairs
    seen at least 3 times, the top ``n`` by count then items."""
    ss = tables["store_sales"].columns
    order = np.argsort(ss["ss_ticket_number"], kind="stable")
    tick, item = ss["ss_ticket_number"][order], ss["ss_item_sk"][order]
    starts = np.flatnonzero(np.r_[True, tick[1:] != tick[:-1]])
    sizes = np.diff(np.r_[starts, len(tick)])
    row_size = np.repeat(sizes, sizes)
    a_idx = np.repeat(np.arange(len(tick)), row_size)
    within = np.arange(len(a_idx)) - np.repeat(np.cumsum(row_size)
                                               - row_size, row_size)
    b_idx = np.repeat(np.repeat(starts, sizes), row_size) + within
    ia, ib = item[a_idx], item[b_idx]
    keep = ia < ib
    base = int(item.max()) + 1
    pairs, cnt = np.unique(ia[keep] * base + ib[keep], return_counts=True)
    hot = cnt >= 3
    pairs, cnt = pairs[hot], cnt[hot].astype(np.int64)
    out = _top_by_count(cnt, pairs // base, pairs % base,
                        ("item_a", "item_b"), n)
    out["join_rows"] = len(a_idx)
    return out


def numpy_bb_q05(tables, n: int = 1000) -> dict:
    """Click features in numpy: per identified user, clicks per category
    0-5 and in all, the label 1 when the user bought (web sales) an item
    of category 3, the first ``n`` users in key order."""
    wcs = tables["web_clickstreams"]
    it = tables["item"].columns
    ws = tables["web_sales"].columns
    ident = wcs.validity["wcs_user_sk"]
    hit, row = _lookup(it["i_item_sk"], wcs.columns["wcs_item_sk"])
    m = ident & hit
    users, inv = np.unique(wcs.columns["wcs_user_sk"][m],
                           return_inverse=True)
    cat = it["i_category_id"][row[m]]
    out = {"wcs_user_sk": users}
    for c in range(6):
        out[f"f{c}"] = np.bincount(inv[cat == c], minlength=len(users)
                                   ).astype(np.int64)
    out["total_clicks"] = np.bincount(inv, minlength=len(users)
                                      ).astype(np.int64)
    bhit, brow = _lookup(it["i_item_sk"], ws["ws_item_sk"])
    bought = bhit & (it["i_category_id"][brow] == 3)
    buyers = np.unique(ws["ws_bill_customer_sk"][bought])
    out["label"] = np.isin(users, buyers).astype(np.int32)
    return {k: v[:n] for k, v in out.items()}


def numpy_bb_q30(tables, n: int = 100) -> dict:
    """Category affinity inside sessions in numpy: identified clicks
    lexsorted by (user, time); a session starts at a user's first click
    and after every gap over ``SESSION_GAP`` s; each session's set of item
    categories as a bit mask; every category pair ``a < b`` counted over
    the sessions holding both; the top ``n`` by count then categories."""
    wcs = tables["web_clickstreams"]
    it = tables["item"].columns
    c = wcs.columns
    ident = wcs.validity["wcs_user_sk"]
    user = c["wcs_user_sk"][ident]
    ts = c["wcs_click_date_sk"][ident] * 86400 + c["wcs_click_time_sk"][ident]
    order = np.lexsort((ts, user))
    user, ts = user[order], ts[order]
    hit, row = _lookup(it["i_item_sk"], c["wcs_item_sk"][ident][order])
    boundary = np.r_[True, (user[1:] != user[:-1])
                     | (ts[1:] - ts[:-1] > SESSION_GAP)]
    session = np.cumsum(boundary) - 1
    n_cat = int(it["i_category_id"].max()) + 1
    # the rows of a session are adjacent: OR their category bits
    bits = np.where(hit, np.left_shift(1, it["i_category_id"][row]), 0)
    masks = np.bitwise_or.reduceat(bits, np.flatnonzero(boundary)) \
        if len(bits) else np.zeros(0, np.int64)
    a, b, cnt = [], [], []
    for x in range(n_cat):
        for y in range(x + 1, n_cat):
            k = int(np.count_nonzero((masks >> x) & (masks >> y) & 1))
            if k:
                a.append(x)
                b.append(y)
                cnt.append(k)
    out = _top_by_count(np.array(cnt, dtype=np.int64),
                        np.array(a, dtype=np.int64),
                        np.array(b, dtype=np.int64), ("cat_a", "cat_b"), n)
    out["sessions"] = len(masks)
    return out




def _xbb_sessions(tables):
    """The identified clicks lexsorted by (user, time), as the
    sessionization's row numbers order them: (user, session ordinal over
    all users, item, whether the click has a sale). A session starts at
    a user's first click and after every gap over ``SESSION_GAP`` s; a
    tie in time puts no boundary between its clicks, so the sessions do
    not depend on how ties order."""
    wcs = tables["web_clickstreams"]
    c = wcs.columns
    ident = wcs.validity["wcs_user_sk"]
    user = c["wcs_user_sk"][ident]
    ts = c["wcs_click_date_sk"][ident] * 86400 + c["wcs_click_time_sk"][ident]
    order = np.lexsort((ts, user))
    user, ts = user[order], ts[order]
    boundary = np.r_[True, (user[1:] != user[:-1])
                     | (ts[1:] - ts[:-1] > SESSION_GAP)] if len(user) \
        else np.zeros(0, bool)
    return (user, np.cumsum(boundary) - 1, c["wcs_item_sk"][ident][order],
            wcs.validity["wcs_sales_sk"][ident][order])


def _key_ids(*keys):
    """One int64 id per row of the key tuples, equal exactly where every
    key is equal (mixed radix over each key's ``np.unique`` ranks)."""
    out = np.zeros(len(keys[0]), np.int64)
    for k in keys:
        u, inv = np.unique(k, return_inverse=True)
        out = out * max(len(u), 1) + inv.reshape(-1)
    return out


def _eq_join(lkeys, rkeys):
    """(left rows, right rows) of every pair whose key tuples are equal:
    left-major, each left row's partners in right-table order."""
    nl = len(lkeys[0])
    ids = _key_ids(*[np.concatenate([a, b]) for a, b in zip(lkeys, rkeys)])
    lid, rid = ids[:nl], ids[nl:]
    order = np.argsort(rid, kind="stable")
    lo = np.searchsorted(rid[order], lid)
    cnt = np.searchsorted(rid[order], lid, "right") - lo
    return np.repeat(np.arange(nl), cnt), order[_expand(lo, cnt)]


def _sorted_rows(d: dict, keys, n=None) -> dict:
    """The columns of ``d`` with rows in the order of ``keys`` (the first
    the most significant; negate a number for descending), the first
    ``n``."""
    rows = _order(*keys)[:n]
    return {k: np.asarray(v)[rows] for k, v in d.items()}


def _slopes(group, x, y):
    """Least squares per group, the queries' inlined formula over
    float64 sums: (groups, n, sx, sy, sxy, sxx, slope, has_slope); the
    slope is null (``has_slope`` false) where its divisor is 0."""
    keys, (n, sx, sy, sxy, sxx) = _group_sums(
        [group], np.ones(len(x), np.int64), x, y, x * y, x * x)
    nn = n.astype(np.float64)
    den = nn * sxx - sx * sx
    with np.errstate(divide="ignore", invalid="ignore"):
        slope = (nn * sxy - sx * sy) / np.where(den == 0, 1.0, den)
    return keys[0], n, sx, sy, slope, den != 0


def numpy_bb_q02(tables, n: int = 30, pivot: int = 10) -> dict:
    """Items clicked in the sessions that also hold a click of ``pivot``:
    clicks per item (the pivot's own left out), the top ``n`` by count
    then item."""
    _, session, item, _ = _xbb_sessions(tables)
    has = np.zeros(int(session.max(initial=-1)) + 1, bool)
    has[session[item == pivot]] = True
    m = has[session] & (item != pivot)
    items, cnt = np.unique(item[m], return_counts=True)
    return _sorted_rows({"item": items, "cnt": cnt.astype(np.int64)},
                        (-cnt, items), n)


def q02_pivot_clicks(tables, pivot: int = 10, every: int = 1000) -> dict:
    """``tables`` with web_clickstreams extended by a click on ``pivot``
    beside every ``every``-th identified click: the same user, date and
    time, no sale. A click at an existing click's time joins its
    session and moves no boundary, so q02 then has pivot sessions."""
    from spark_rapids_tpu_torch.data.batch import HostBatch
    wcs = tables["web_clickstreams"]
    src = np.flatnonzero(wcs.validity["wcs_user_sk"])[::every]
    cols = {k: np.concatenate([v, v[src]]) for k, v in wcs.columns.items()}
    cols["wcs_item_sk"][len(wcs.validity["wcs_user_sk"]):] = pivot
    valid = {k: np.concatenate([v, v[src]]) for k, v in wcs.validity.items()}
    valid["wcs_sales_sk"][len(wcs.validity["wcs_sales_sk"]):] = False
    cols["wcs_sales_sk"] = np.where(valid["wcs_sales_sk"],
                                    cols["wcs_sales_sk"], 0)
    out = dict(tables)
    out["web_clickstreams"] = HostBatch.from_numpy(cols, wcs.schema, valid)
    return out


def numpy_bb_q02_pivot(tables) -> dict:
    """q02 over :func:`q02_pivot_clicks`'s tables."""
    return numpy_bb_q02(q02_pivot_clicks(tables))


def numpy_bb_q03(tables, n: int = 100) -> dict:
    """Items an identified user clicked in the 10 days up to a store
    purchase of a category-3 item (click date in [sale date - 9, sale
    date]): one view per (sale, click) pair, the top ``n`` items by views
    then item. Also the equi join's pair count (``pairs``: sales x clicks
    of one user, before the date band)."""
    ss, it = tables["store_sales"].columns, tables["item"].columns
    hit, row = _lookup(it["i_item_sk"], ss["ss_item_sk"])
    m = hit & (it["i_category_id"][row] == 3)
    buyer, sd = ss["ss_customer_sk"][m], ss["ss_sold_date_sk"][m]
    wcs = tables["web_clickstreams"]
    ident = wcs.validity["wcs_user_sk"]
    clicker = wcs.columns["wcs_user_sk"][ident]
    cd = wcs.columns["wcs_click_date_sk"][ident]
    viewed = wcs.columns["wcs_item_sk"][ident]
    base = int(max(cd.max(initial=0), sd.max(initial=0))) + 1
    key = clicker * base + cd
    order = np.argsort(key, kind="stable")
    lo = np.searchsorted(key[order], buyer * base + np.maximum(sd - 9, 0))
    hi = np.searchsorted(key[order], buyer * base + sd, "right")
    views = np.bincount(viewed[order][_expand(lo, hi - lo)])
    items = np.flatnonzero(views)
    cnt = views[items].astype(np.int64)
    out = _sorted_rows({"viewed": items, "views_before_purchase": cnt},
                       (-cnt, items), n)
    per_user = np.bincount(clicker)
    out["pairs"] = int(per_user[buyer[buyer < len(per_user)]].sum())
    return out


def numpy_bb_q04(tables) -> dict:
    """Sessions, the ones with no converting click, and clicks per
    session."""
    _, session, _, sold = _xbb_sessions(tables)
    n_sess = int(session.max(initial=-1)) + 1
    conv = np.bincount(session, weights=sold.astype(np.float64),
                       minlength=n_sess)
    return {"sessions": np.array([n_sess]),
            "abandoned": np.array([int(np.count_nonzero(conv == 0))]),
            "avg_clicks": np.array([len(session) / n_sess])}


def _period_sums(cols, cust, date, paid, lo, hi):
    m = (cols[date] >= lo) & (cols[date] < hi)
    keys, (s,) = _group_sums([cols[cust][m]], cols[paid][m])
    return keys[0], s


def _at(keys, values, want):
    """``values`` of the sorted unique ``keys`` at ``want`` (all present)."""
    return values[np.searchsorted(keys, want)]


def numpy_bb_q06(tables, n: int = 100) -> dict:
    """Customers with store and web spend in both years whose web growth
    beats their store growth, the top ``n`` by web growth then
    customer."""
    ss, ws = tables["store_sales"].columns, tables["web_sales"].columns
    parts = [_period_sums(ss, "ss_customer_sk", "ss_sold_date_sk",
                          "ss_net_paid", 0, 365),
             _period_sums(ss, "ss_customer_sk", "ss_sold_date_sk",
                          "ss_net_paid", 365, 730),
             _period_sums(ws, "ws_bill_customer_sk", "ws_sold_date_sk",
                          "ws_net_paid", 0, 365),
             _period_sums(ws, "ws_bill_customer_sk", "ws_sold_date_sk",
                          "ws_net_paid", 365, 730)]
    cust = parts[0][0]
    for k, _ in parts[1:]:
        cust = np.intersect1d(cust, k)
    s1, s2, w1, w2 = (_at(k, v, cust) for k, v in parts)
    m = (s1 > 0) & (w1 > 0)
    cust, s1, s2, w1, w2 = cust[m], s1[m], s2[m], w1[m], w2[m]
    m = w2 / w1 > s2 / s1
    growth = (w2 / w1)[m]
    return _sorted_rows({"customer": cust[m], "web_growth": growth},
                        (-growth, cust[m]), n)


def numpy_bb_q07(tables, n: int = 100) -> dict:
    """Categories with at least 10 items priced above 1.2 times their
    category's average price, by that count then name."""
    it = tables["item"].columns
    cat, price = it["i_category_id"], it["i_current_price"]
    (cats,), (total, cnt) = _group_sums([cat], price,
                                        np.ones(len(cat), np.int64))
    avg = _at(cats, total / cnt, cat)
    names, pricey = np.unique(it["i_category"][price > 1.2 * avg],
                              return_counts=True)
    keep = pricey >= 10
    return _sorted_rows({"i_category": names[keep],
                         "pricey_items": pricey[keep].astype(np.int64)},
                        (-pricey[keep], names[keep]), n)


def numpy_bb_q08(tables) -> dict:
    """Web spend and orders of reviewers and of everyone else."""
    ws = tables["web_sales"].columns
    readers = np.isin(ws["ws_bill_customer_sk"],
                      tables["product_reviews"].columns["pr_user_sk"])
    paid = ws["ws_net_paid"]
    return {"reader_paid": np.array([paid[readers].sum()]),
            "reader_orders": np.array([int(readers.sum())]),
            "nonreader_paid": np.array([paid[~readers].sum()]),
            "nonreader_orders": np.array([int((~readers).sum())])}


def numpy_bb_q09(tables) -> dict:
    """Store revenue and rows under the demographic and price
    disjunction."""
    ss, c = tables["store_sales"].columns, tables["customer"].columns
    hit, row = _lookup(c["c_customer_sk"], ss["ss_customer_sk"])
    age, inc = c["c_age"][row], c["c_income"][row]
    ok = hit & (((age >= 40) & (inc > 1e5))
                | ((age < 30) & (ss["ss_quantity"] > 10))
                | (ss["ss_net_paid"] > 900.0))
    return {"revenue": np.array([ss["ss_net_paid"][ok].sum()]),
            "rows": np.array([int(ok.sum())])}


def numpy_bb_q10(tables, n: int = 100) -> dict:
    """Items with at least 3 reviews rated more than 0.5 below their
    category's average item rating, by rating then item."""
    pr, it = tables["product_reviews"].columns, tables["item"].columns
    rating = pr["pr_review_rating"]
    (items,), (rsum, rcnt) = _group_sums(
        [pr["pr_item_sk"]], rating.astype(np.float64),
        np.ones(len(rating), np.int64))
    hit, row = _lookup(it["i_item_sk"], items)
    items, rsum, rcnt, row = items[hit], rsum[hit], rcnt[hit], row[hit]
    item_rating = rsum / rcnt
    cat = it["i_category_id"][row]
    (cats,), (csum, ccnt) = _group_sums([cat], item_rating,
                                        np.ones(len(cat), np.int64))
    cat_rating = _at(cats, csum / ccnt, cat)
    m = (rcnt >= 3) & (item_rating < cat_rating - 0.5)
    return _sorted_rows({"pr_item_sk": items[m],
                         "i_category": it["i_category"][row][m],
                         "item_rating": item_rating[m],
                         "cat_rating": cat_rating[m]},
                        (item_rating[m], items[m]), n)


def numpy_bb_q11(tables) -> dict:
    """The correlation feed over items with reviews and web sales: count
    and the sums of x (reviews), y (revenue), xy, xx and yy."""
    pr, ws = tables["product_reviews"].columns, tables["web_sales"].columns
    ritems, nrev = np.unique(pr["pr_item_sk"], return_counts=True)
    (sitems,), (rev,) = _group_sums([ws["ws_item_sk"]], ws["ws_net_paid"])
    common = np.intersect1d(ritems, sitems)
    x = _at(ritems, nrev, common).astype(np.float64)
    y = _at(sitems, rev, common)
    return {"n": np.array([len(common)]), "sum_x": np.array([x.sum()]),
            "sum_y": np.array([y.sum()]), "sum_xy": np.array([(x * y).sum()]),
            "sum_xx": np.array([(x * x).sum()]),
            "sum_yy": np.array([(y * y).sum()])}


def numpy_bb_q12(tables, n: int = 100) -> dict:
    """Users who clicked an item of category 1, 3 or 5 and bought one of
    the same category in the store 1-90 days later, counted per
    category. Also the equi join's pair count (``pairs``: clicks x sales
    of one user and category)."""
    it = tables["item"].columns
    wcs = tables["web_clickstreams"]
    ss = tables["store_sales"].columns

    def side(item_sk, m):
        hit, row = _lookup(it["i_item_sk"], item_sk)
        cat = it["i_category_id"][row]
        return m & hit & np.isin(cat, [1, 3, 5]), cat
    cm, ccat = side(wcs.columns["wcs_item_sk"], wcs.validity["wcs_user_sk"])
    u, cd, ccat = wcs.columns["wcs_user_sk"][cm], \
        wcs.columns["wcs_click_date_sk"][cm], ccat[cm]
    sm, scat = side(ss["ss_item_sk"], np.ones(len(ss["ss_item_sk"]), bool))
    b, sd, scat = ss["ss_customer_sk"][sm], ss["ss_sold_date_sk"][sm], \
        scat[sm]
    base = 1 << 11  # above every date + 90
    ckey, skey = u * 16 + ccat, b * 16 + scat
    sk = np.sort(skey * base + sd)
    lo = np.searchsorted(sk, ckey * base + cd + 1)
    hi = np.searchsorted(sk, ckey * base + cd + 90, "right")
    conv = np.unique(ckey[hi > lo])
    cats, users = np.unique(conv % 16, return_counts=True)
    out = _sorted_rows({"cat": cats, "converting_users":
                        users.astype(np.int64)}, (cats,), n)
    keys, kcnt = np.unique(ckey, return_counts=True)
    skeys, scnt = np.unique(skey, return_counts=True)
    both, ia, ib = np.intersect1d(keys, skeys, return_indices=True)
    out["pairs"] = int((kcnt[ia] * scnt[ib]).sum())
    return out


def numpy_bb_q13(tables, n: int = 100) -> dict:
    """Customers with first-year spend in both channels whose web
    year-over-year ratio beats their store one, by web ratio then
    customer."""
    def channel(cols, cust, date, paid):
        first = cols[date] < 365
        keys, (y1, y2) = _group_sums(
            [cols[cust]], np.where(first, cols[paid], 0.0),
            np.where(~first, cols[paid], 0.0))
        m = y1 > 0
        return keys[0][m], y1[m], y2[m]
    sc, s1, s2 = channel(tables["store_sales"].columns, "ss_customer_sk",
                         "ss_sold_date_sk", "ss_net_paid")
    wc, w1, w2 = channel(tables["web_sales"].columns, "ws_bill_customer_sk",
                         "ws_sold_date_sk", "ws_net_paid")
    cust = np.intersect1d(np.intersect1d(sc, wc),
                          tables["customer"].columns["c_customer_sk"])
    rs = _at(sc, s2, cust) / _at(sc, s1, cust)
    rw = _at(wc, w2, cust) / _at(wc, w1, cust)
    m = rw > rs
    return _sorted_rows({"c_customer_sk": cust[m], "store_ratio": rs[m],
                         "web_ratio": rw[m]}, (-rw[m], cust[m]), n)


def numpy_bb_q14(tables) -> dict:
    """Morning over evening web sales to households with 5 dependants
    on pages of 5,000-6,000 characters (-1 without evening sales)."""
    ws = tables["web_sales"].columns
    hd = tables["household_demographics"].columns
    wp, td = tables["web_page"].columns, tables["time_dim"].columns
    h_hit, hrow = _lookup(hd["hd_demo_sk"], ws["ws_ship_hdemo_sk"])
    p_hit, prow = _lookup(wp["wp_web_page_sk"], ws["ws_web_page_sk"])
    t_hit, trow = _lookup(td["t_time_sk"], ws["ws_sold_time_sk"])
    chars = wp["wp_char_count"][prow]
    hour = td["t_hour"][trow]
    m = h_hit & (hd["hd_dep_count"][hrow] == 5) & p_hit & (chars >= 5000) \
        & (chars <= 6000) & t_hit & np.isin(hour, [7, 8, 19, 20])
    amc = int(np.count_nonzero(m & (hour <= 8)))
    pmc = int(np.count_nonzero(m & (hour >= 19)))
    return {"am_pm_ratio": np.array([amc / pmc if pmc > 0 else -1.0])}


def numpy_bb_q15(tables) -> dict:
    """Categories whose daily revenue in store 10 (days 180-545) has a
    least-squares slope at or below 0: slope and intercept by
    category."""
    ss, it = tables["store_sales"].columns, tables["item"].columns
    date = ss["ss_sold_date_sk"]
    hit, row = _lookup(it["i_item_sk"], ss["ss_item_sk"])
    m = (ss["ss_store_sk"] == 10) & (date >= 180) & (date <= 545) & hit
    (cat, day), (y,) = _group_sums([it["i_category_id"][row][m], date[m]],
                                   ss["ss_net_paid"][m])
    cats, n, sx, sy, slope, ok = _slopes(cat, day.astype(np.float64), y)
    m = ok & (slope <= 0.0)
    return {"cat": cats[m], "slope": slope[m],
            "intercept": (sy[m] - slope[m] * sx[m]) / n[m].astype(np.float64)}


def numpy_bb_q16(tables, n: int = 100) -> dict:
    """Web sales of days 335-395 less their refunds (every matching
    return a row; none: refund 0) before and after day 365, by warehouse
    state and item."""
    ws, wr = tables["web_sales"].columns, tables["web_returns"].columns
    it, wh = tables["item"].columns, tables["warehouse"].columns
    date = ws["ws_sold_date_sk"]
    sel = np.flatnonzero((date >= 335) & (date <= 395))
    li, ri = _eq_join([ws["ws_order_number"][sel], ws["ws_item_sk"][sel]],
                      [wr["wr_order_number"], wr["wr_item_sk"]])
    alone = np.setdiff1d(np.arange(len(sel)), li)
    rows = np.concatenate([sel[li], sel[alone]])
    refund = np.concatenate([wr["wr_refunded_cash"][ri],
                             np.zeros(len(alone))])
    i_hit, irow = _lookup(it["i_item_sk"], ws["ws_item_sk"][rows])
    w_hit, wrow = _lookup(wh["w_warehouse_sk"], ws["ws_warehouse_sk"][rows])
    m = i_hit & w_hit
    net = (ws["ws_sales_price"][rows] - refund)[m]
    before = date[rows][m] < 365
    (state, item), (sb, sa) = _group_sums(
        [wh["w_state"][wrow][m], it["i_item_sk"][irow][m]],
        np.where(before, net, 0.0), np.where(~before, net, 0.0))
    return {"w_state": state[:n], "i_item_sk": item[:n],
            "sales_before": sb[:n], "sales_after": sa[:n]}


def numpy_bb_q17(tables) -> dict:
    """Promotional (even ticket) and total store revenue of days 330-360
    in categories 0 and 5, and the promotional percentage."""
    ss, it = tables["store_sales"].columns, tables["item"].columns
    date = ss["ss_sold_date_sk"]
    hit, row = _lookup(it["i_item_sk"], ss["ss_item_sk"])
    m = (date >= 330) & (date <= 360) & hit \
        & np.isin(it["i_category_id"][row], [0, 5])
    paid = ss["ss_net_paid"]
    promo = paid[m & (ss["ss_ticket_number"] % 2 == 0)].sum()
    total = paid[m].sum()
    return {"promotional": np.array([promo]), "total": np.array([total]),
            "promo_percent": np.array([100.0 * promo / total
                                       if total > 0 else 0.0])}


def _contains(values, needle: str):
    return np.char.find(values.astype(str), needle) >= 0


def numpy_bb_q18(tables, n: int = 100) -> dict:
    """Stores whose daily revenue slopes down: per store, the reviews
    mentioning "terrible" of the items it sold."""
    ss, pr = tables["store_sales"].columns, tables["product_reviews"].columns
    (store, day), (y,) = _group_sums([ss["ss_store_sk"],
                                      ss["ss_sold_date_sk"]],
                                     ss["ss_net_paid"])
    stores, _, _, _, slope, ok = _slopes(store, day.astype(np.float64), y)
    declining = stores[ok & (slope < 0.0)]
    neg = np.bincount(pr["pr_item_sk"][_contains(pr["pr_review_content"],
                                                 "terrible")],
                      minlength=int(ss["ss_item_sk"].max(initial=0)) + 1)
    (item, sold_at), _ = _group_sums([ss["ss_item_sk"], ss["ss_store_sk"]])
    m = np.isin(sold_at, declining) & (item < len(neg))
    (st,), (cnt,) = _group_sums([sold_at[m]], neg[item[m]])
    keep = cnt > 0
    return {"sold_store": st[keep][:n],
            "negative_reviews": cnt[keep][:n].astype(np.int64)}


def numpy_bb_q19(tables, n: int = 100) -> dict:
    """Reviews mentioning "terrible" or "awful" of items returned at
    least 10 times: count and average rating by item."""
    sr, pr = tables["store_returns"].columns, tables["product_reviews"].columns
    (ritems,), (qty,) = _group_sums([sr["sr_item_sk"]],
                                    sr["sr_return_quantity"])
    content = pr["pr_review_content"]
    m = (_contains(content, "terrible") | _contains(content, "awful")) \
        & np.isin(pr["pr_item_sk"], ritems[qty >= 10])
    (items,), (cnt, rsum) = _group_sums(
        [pr["pr_item_sk"][m]], np.ones(int(m.sum()), np.int64),
        pr["pr_review_rating"][m].astype(np.float64))
    return {"pr_item_sk": items[:n], "neg_reviews": cnt[:n],
            "avg_rating": (rsum / cnt)[:n]}


def numpy_bb_q20(tables, n: int = 1000) -> dict:
    """Per store customer: returned tickets over tickets, returned items
    over items, refunds over spend (0 without returns), and returned
    tickets."""
    ss, sr = tables["store_sales"].columns, tables["store_returns"].columns
    pairs = np.unique(np.stack([ss["ss_customer_sk"],
                                ss["ss_ticket_number"]], 1), axis=0)
    cust, orders = np.unique(pairs[:, 0], return_counts=True)
    (_,), (items, money) = _group_sums(
        [ss["ss_customer_sk"]], np.ones(len(ss["ss_customer_sk"]), np.int64),
        ss["ss_net_paid"])
    rpairs = np.unique(np.stack([sr["sr_customer_sk"],
                                 sr["sr_ticket_number"]], 1), axis=0)
    rcust, rorders = np.unique(rpairs[:, 0], return_counts=True)
    (rc2,), (ritems, rmoney) = _group_sums(
        [sr["sr_customer_sk"]], np.ones(len(sr["sr_customer_sk"]), np.int64),
        sr["sr_return_amt"])
    has = np.isin(cust, rcust)
    pos = np.searchsorted(rcust, cust).clip(0, max(len(rcust) - 1, 0))
    pos2 = np.searchsorted(rc2, cust).clip(0, max(len(rc2) - 1, 0))
    ro = np.where(has, rorders[pos] if len(rcust) else 0, 0)
    ri = np.where(has, ritems[pos2] if len(rc2) else 0, 0)
    rm = np.where(has, rmoney[pos2] if len(rc2) else 0.0, 0.0)
    out = {"user_sk": cust,
           "orderRatio": np.where(has, ro / orders, 0.0),
           "itemsRatio": np.where(has, ri / items, 0.0),
           "monetaryRatio": np.where(has, rm / money, 0.0),
           "frequency": ro.astype(np.int64)}
    return {k: v[:n] for k, v in out.items()}


def numpy_bb_q21(tables, n: int = 100) -> dict:
    """Store purchases of days 0-90, returned by day 270 and bought again
    on the web by the same customer: quantities by item and store."""
    ss, sr = tables["store_sales"].columns, tables["store_returns"].columns
    ws = tables["web_sales"].columns
    s_sel = np.flatnonzero(ss["ss_sold_date_sk"] <= 90)
    r_sel = np.flatnonzero(sr["sr_returned_date_sk"] <= 270)
    ri, wi = _eq_join([sr["sr_item_sk"][r_sel], sr["sr_customer_sk"][r_sel]],
                      [ws["ws_item_sk"], ws["ws_bill_customer_sk"]])
    ri = r_sel[ri]
    ji, si = _eq_join([sr["sr_ticket_number"][ri], sr["sr_item_sk"][ri],
                       sr["sr_customer_sk"][ri]],
                      [ss["ss_ticket_number"][s_sel], ss["ss_item_sk"][s_sel],
                       ss["ss_customer_sk"][s_sel]])
    si = s_sel[si]
    (item, store), (q_ss, q_sr, q_ws) = _group_sums(
        [ss["ss_item_sk"][si], ss["ss_store_sk"][si]], ss["ss_quantity"][si],
        sr["sr_return_quantity"][ri[ji]], ws["ws_quantity"][wi[ji]])
    return {"ss_item_sk": item[:n], "ss_store_sk": store[:n],
            "store_sales_quantity": q_ss[:n],
            "store_returns_quantity": q_sr[:n],
            "web_sales_quantity": q_ws[:n]}


def numpy_bb_q22(tables, n: int = 100) -> dict:
    """Inventory of items priced 20-80 before and after day 365 (days
    305-425), by warehouse name and item, kept where after/before lies in
    [2/3, 1.5]."""
    inv, it = tables["inventory"].columns, tables["item"].columns
    wh = tables["warehouse"].columns
    date = inv["inv_date_sk"]
    i_hit, irow = _lookup(it["i_item_sk"], inv["inv_item_sk"])
    w_hit, wrow = _lookup(wh["w_warehouse_sk"], inv["inv_warehouse_sk"])
    price = it["i_current_price"][irow]
    m = (date >= 305) & (date <= 425) & i_hit & (price >= 20.0) \
        & (price <= 80.0) & w_hit
    qoh = inv["inv_quantity_on_hand"][m]
    before = date[m] < 365
    (name, item), (b, a) = _group_sums(
        [wh["w_warehouse_name"][wrow][m], inv["inv_item_sk"][m]],
        np.where(before, qoh, 0), np.where(~before, qoh, 0))
    keep = b > 0
    ratio = a[keep].astype(np.float64) / b[keep].astype(np.float64)
    ok = (ratio >= 2.0 / 3.0) & (ratio <= 1.5)
    return {k: v[keep][ok][:n] for k, v in (
        ("w_warehouse_name", name), ("inv_item_sk", item),
        ("inv_before", b), ("inv_after", a))}


def numpy_bb_q23(tables, n: int = 100) -> dict:
    """Inventory cells (warehouse, item, 90-day bucket of days 0-360) with
    a coefficient of variation of at least 0.4, each joined to the same
    item's next bucket, by warehouse, item and bucket. The float math is
    the query's, operation for operation."""
    inv = tables["inventory"].columns
    date = inv["inv_date_sk"]
    m = (date >= 0) & (date <= 360)
    q = inv["inv_quantity_on_hand"][m]
    qf = q.astype(np.float64)
    (wh, item, moy), (cnt, s_int, sumsq) = _group_sums(
        [inv["inv_warehouse_sk"][m], inv["inv_item_sk"][m], date[m] // 90],
        np.ones(len(q), np.int64), qf, qf * qf)
    nn = cnt.astype(np.float64)
    mean = s_int / nn
    with np.errstate(invalid="ignore", divide="ignore"):
        var = (sumsq - nn * (mean * mean)) / (nn - 1.0)
        cov = np.sqrt(var) / mean
    keep = (cnt > 1) & (mean > 0.0)
    keep[keep] = cov[keep] >= 0.4
    wh, item, moy, cov = wh[keep], item[keep], moy[keep], cov[keep]
    li, ri = _eq_join([wh, item, moy + 1], [wh, item, moy])
    out = {"wh1": wh[li], "it1": item[li], "moy1": moy[li], "cov1": cov[li],
           "wh2": wh[ri], "it2": item[ri], "moy2": moy[ri], "cov2": cov[ri]}
    return _sorted_rows(out, (out["wh1"], out["it1"], out["moy1"]), n)


def numpy_bb_q24(tables) -> dict:
    """Cross-price elasticity of items 0-7 over both channels: for each
    competitor price (item, imp), the quantities in its window and the
    window before, summed per channel; the average over an item's
    prices."""
    imp, it = tables["item_marketprices"].columns, tables["item"].columns
    hit, row = _lookup(it["i_item_sk"], imp["imp_item_sk"])
    m = hit & (it["i_item_sk"][row] < 8)
    tsk = it["i_item_sk"][row][m]
    cur_price = it["i_current_price"][row][m]
    pc = (imp["imp_competitor_price"][m] - cur_price) / cur_price
    start = imp["imp_start_date"][m]
    ndays = imp["imp_end_date"][m] - start

    def quant(fact, item_col, date_col, qty_col):
        cols = tables[fact].columns
        fi, ci = _eq_join([cols[item_col]], [tsk])
        d, qty = cols[date_col][fi], cols[qty_col][fi]
        s, nd = start[ci], ndays[ci]
        cur = np.where((d >= s) & (d < s + nd), qty, 0)
        prev = np.where((d >= s - nd) & (d < s), qty, 0)
        return (np.bincount(ci, minlength=len(tsk)) > 0,
                np.bincount(ci, weights=cur, minlength=len(tsk)),
                np.bincount(ci, weights=prev, minlength=len(tsk)))
    w_has, w_cur, w_prev = quant("web_sales", "ws_item_sk",
                                 "ws_sold_date_sk", "ws_quantity")
    s_has, s_cur, s_prev = quant("store_sales", "ss_item_sk",
                                 "ss_sold_date_sk", "ss_quantity")
    prev = (s_prev + w_prev).astype(np.int64)
    m = w_has & s_has & (prev > 0)
    num = ((s_cur + w_cur).astype(np.int64) - prev).astype(np.float64)
    den = prev.astype(np.float64) * pc
    m &= den != 0
    (items,), (esum, ecnt) = _group_sums(
        [tsk[m]], num[m] / den[m], np.ones(int(m.sum()), np.int64))
    return {"w_sk": items, "cross_price_elasticity": esum / ecnt}


def numpy_bb_q25(tables, n: int = 1000) -> dict:
    """RFM over both channels after day 500: per customer the latest
    purchase (recency 1.0 within 60 days of day 730), distinct orders
    summed over the channels, and spend."""
    def channel(cols, cust, order, date, paid):
        m = cols[date] > 500
        pairs = np.unique(np.stack([cols[cust][m], cols[order][m]], 1),
                          axis=0)
        keys, freq = np.unique(pairs[:, 0], return_counts=True)
        order_ = np.lexsort((cols[date][m], cols[cust][m]))
        c_sorted = cols[cust][m][order_]
        last_row = np.r_[c_sorted[1:] != c_sorted[:-1], True] \
            if len(c_sorted) else np.zeros(0, bool)
        latest = cols[date][m][order_][last_row]
        (_,), (amount,) = _group_sums([cols[cust][m]], cols[paid][m])
        return keys, freq, latest, amount
    parts = [channel(tables["store_sales"].columns, "ss_customer_sk",
                     "ss_ticket_number", "ss_sold_date_sk", "ss_net_paid"),
             channel(tables["web_sales"].columns, "ws_bill_customer_sk",
                     "ws_order_number", "ws_sold_date_sk", "ws_net_paid")]
    cid = np.concatenate([p[0] for p in parts])
    freq = np.concatenate([p[1] for p in parts]).astype(np.int64)
    latest = np.concatenate([p[2] for p in parts])
    amount = np.concatenate([p[3] for p in parts])
    (keys,), (f, a) = _group_sums([cid], freq, amount)
    last = np.full(len(keys), -1, np.int64)
    np.maximum.at(last, np.searchsorted(keys, cid), latest)
    recency = np.where(730 - last < 60, 1.0, 0.0)
    return {"cid": keys[:n], "recency": recency[:n], "frequency": f[:n],
            "totalspend": a[:n]}


def numpy_bb_q26(tables, n: int = 1000) -> dict:
    """Store customers with more than 5 purchases of "Books" items:
    purchases per class id 1-15 and in all."""
    ss, it = tables["store_sales"].columns, tables["item"].columns
    hit, row = _lookup(it["i_item_sk"], ss["ss_item_sk"])
    m = hit & (it["i_category"][row] == "Books")
    cls = it["i_class_id"][row][m]
    lanes = [(cls == k).astype(np.int64) for k in range(1, 16)]
    (cust,), sums = _group_sums([ss["ss_customer_sk"][m]], *lanes,
                                np.ones(len(cls), np.int64))
    keep = sums[-1] > 5
    out = {"ss_customer_sk": cust[keep][:n]}
    for k in range(1, 16):
        out[f"id{k}"] = sums[k - 1][keep][:n]
    out["n_items"] = sums[-1][keep][:n]
    return out


def numpy_bb_q27(tables, n: int = 200) -> dict:
    """Reviews naming a competitor ("acme" first, else "zenith"),
    counted by item and competitor."""
    pr = tables["product_reviews"].columns
    content = pr["pr_review_content"]
    acme, zenith = _contains(content, "acme"), _contains(content, "zenith")
    m = acme | zenith
    comp = np.where(acme, "acme", "zenith")[m]
    (items, names), (cnt,) = _group_sums(
        [pr["pr_item_sk"][m], comp], np.ones(int(m.sum()), np.int64))
    return {"pr_item_sk": items[:n], "competitor": names[:n],
            "mentions": cnt[:n]}


def numpy_bb_q28(tables) -> dict:
    """Reviews per split ("test": review key divisible by 10, else
    "train") and rating."""
    pr = tables["product_reviews"].columns
    split = np.where(pr["pr_review_sk"] % 10 == 0, "test", "train")
    (s, rating), (cnt,) = _group_sums(
        [split, pr["pr_review_rating"]],
        np.ones(len(split), np.int64))
    return {"split": s, "pr_review_rating": rating, "n_reviews": cnt}


def numpy_bb_q29(tables, n: int = 100) -> dict:
    """Category pairs ``a < b`` bought in one web order, counted over the
    orders, the top ``n`` by count then categories."""
    ws, it = tables["web_sales"].columns, tables["item"].columns
    hit, row = _lookup(it["i_item_sk"], ws["ws_item_sk"])
    orders, inv = np.unique(ws["ws_order_number"][hit], return_inverse=True)
    masks = np.zeros(len(orders), np.int64)
    np.bitwise_or.at(masks, inv.reshape(-1),
                     np.left_shift(1, it["i_category_id"][row[hit]]))
    n_cat = int(it["i_category_id"].max()) + 1
    a, b, cnt = [], [], []
    for x in range(n_cat):
        for y in range(x + 1, n_cat):
            k = int(np.count_nonzero((masks >> x) & (masks >> y) & 1))
            if k:
                a.append(x)
                b.append(y)
                cnt.append(k)
    return _top_by_count(np.array(cnt, dtype=np.int64),
                         np.array(a, dtype=np.int64),
                         np.array(b, dtype=np.int64), ("cat_a", "cat_b"), n)


#: Every TPCxBB query's numpy reference, and q02 over
#: :func:`q02_pivot_clicks`'s tables (``q02_pivot``).
XBB_REFS = {q: globals()[f"numpy_bb_{q}"] for q in
            [f"q{i:02d}" for i in range(1, 31)]}
XBB_REFS["q02_pivot"] = numpy_bb_q02_pivot
#: The float columns of each TPCxBB answer (held to ``REV_RTOL``); every
#: other column is exact.
XBB_FLOATS = {
    "q04": ["avg_clicks"], "q06": ["web_growth"],
    "q08": ["reader_paid", "nonreader_paid"], "q09": ["revenue"],
    "q10": ["item_rating", "cat_rating"],
    "q11": ["sum_x", "sum_y", "sum_xy", "sum_xx", "sum_yy"],
    "q13": ["store_ratio", "web_ratio"], "q14": ["am_pm_ratio"],
    "q15": ["slope", "intercept"], "q16": ["sales_before", "sales_after"],
    "q17": ["promotional", "total", "promo_percent"],
    "q19": ["avg_rating"],
    "q20": ["orderRatio", "itemsRatio", "monetaryRatio"],
    "q23": ["cov1", "cov2"], "q24": ["cross_price_elasticity"],
    "q25": ["recency", "totalspend"]}


#: One worker process's generated tables, by (workload, size, seed).
_WORKER_TABLES = {}


def reference_answer(task):
    """One numpy reference answer, computed in a worker process from the
    tables it generates itself (the same seed gives the same tables):
    ``task`` is (workload, size, seed, query). Returns (task, answer)."""
    workload, size, seed, q = task
    key = (workload, size, seed)
    if key not in _WORKER_TABLES:
        if workload == "tpch":
            from spark_rapids_tpu_torch.workloads import tpch as wl
        else:
            from spark_rapids_tpu_torch.workloads import tpcxbb as wl
        _WORKER_TABLES.clear()
        _WORKER_TABLES[key] = wl.gen_tables(size, seed=seed)
    tables = _WORKER_TABLES[key]
    if workload == "tpch":
        fn = numpy_q3 if q == "q3" else NUMPY_REFS[q]
    else:
        fn = XBB_REFS[q]
    return task, fn(tables)


def start_references(args):
    """Every numpy reference of phase 3, started in worker processes
    while the kernels build and phase 2 runs: (the executor, ``{task:
    future}``)."""
    ex = ProcessPoolExecutor(max_workers=4,
                             mp_context=multiprocessing.get_context("spawn"))
    atexit.register(ex.shutdown, wait=False, cancel_futures=True)
    tasks = [("tpch", args.lineitem_rows, args.seed, q)
             for q in ["q3"] + list(NUMPY_REFS)]
    tasks += [("xbb", args.xbb_clicks, args.seed, q) for q in XBB_REFS]
    tasks += [("xbb", BENCH_XBB_CLICKS, args.seed, q) for q in BENCH_XBB]
    return ex, {t: ex.submit(reference_answer, t) for t in tasks}


def reference(futures, workload: str, size: int, seed: int, q: str):
    """The answer of one started reference (waits for it)."""
    return futures[(workload, size, seed, q)].result()[1]


def check_exact(q: str, got, ref, floats=()) -> None:
    """Every column equal to the reference's, row for row, but the
    ``floats`` columns, which agree to ``REV_RTOL``; no nulls."""
    want = {k: v for k, v in ref.items() if k in got.columns}
    check(set(got.columns) == set(want),
          f"{q}: columns {sorted(got.columns)} vs {sorted(want)}")
    for name, w in want.items():
        g = np.asarray(got.columns[name])
        w = np.asarray(w)
        check(bool(np.all(got.validity[name])), f"{q}: null in {name}")
        if name in floats:
            same = len(g) == len(w) and bool(np.all(
                np.abs(g.astype(np.float64) - w) <= REV_RTOL * np.abs(w)))
        else:
            if w.dtype.kind == "U":
                g = g.astype(str)
            same = len(g) == len(w) and np.array_equal(g, w)
        at_ = 0
        if not same and len(g) == len(w):
            at_ = int(np.argmax(g != w if name not in floats else
                                np.abs(g - w) > REV_RTOL * np.abs(w)))
        lo = max(at_ - 3, 0)
        check(same, f"{q}: {name} ({len(g)} rows) rows {lo}.. "
              f"{g.tolist()[lo:lo + 8]} vs ({len(w)} rows) "
              f"{w.tolist()[lo:lo + 8]}")


class LeftJoinWatch:
    """Counts the direct-address LEFT joins (``KJ.dense_join`` with
    ``jt="left"``) and the launches that ``probe``, the ``joinProbe``
    wrapper, counts inside them."""

    def __init__(self, KJ, probe):
        self.KJ, self.probe = KJ, probe
        self.joins = self.launches = 0

    def __enter__(self):
        self.fn = self.KJ.dense_join

        def wrapper(*args, **kwargs):
            jt = kwargs.get("jt", args[5] if len(args) > 5 else "inner")
            before = self.probe.launches
            out = self.fn(*args, **kwargs)
            if jt == "left":
                self.joins += 1
                self.launches += self.probe.launches - before
            return out
        self.KJ.dense_join = wrapper
        return self

    def __exit__(self, *exc):
        self.KJ.dense_join = self.fn


def run_tpcxbb(torch, ctx, session, wrappers, xbb_clicks: int, seed: int,
               pq_dir: str, profile: bool, futures: dict):
    """The TPCxBB cells: all 30 queries (``bb_q01`` ... ``bb_q30``) over
    tables uploaded from ``tpcxbb.gen_tables(xbb_clicks)``, and q02 once
    more over :func:`q02_pivot_clicks`'s clicks (``bb_q02_pivot``); then
    the bench suite's three entries as ``pq_bb_*`` over bench.py's
    ``BENCH_XBB_CLICKS`` tables written by the port's writer (the scan
    in every run). Each answer against its numpy reference (exact, floats
    to ``REV_RTOL``), its rows printed and not empty (but ``bb_q02``'s,
    which holds no pivot session at the default scale); each cell's
    device busy share from one traced warm run (two with ``profile``);
    ``joinProbe`` launched in ``bb_q05`` (its dense LEFT join included)
    and ``bb_q30``; q03's and q12's residual joins through the equi
    matcher, their pair counts equal to numpy's, no nested-loop join in
    their plans. Then ``pq_bb_q30`` with the pipeline off (into
    ``ctx.pipeline_off``) and the run tables of the ``pq_bb`` files
    through both slicers (into ``ctx.runs_check``). Returns (summaries,
    launches, captured calls, the dense left joins' calls of one warm
    ``bb_q05`` run)."""
    tpcxbb, KJ, JP = ctx.tpcxbb, ctx.KJ, ctx.JP
    summaries, launches, calls = {}, {}, {k: [] for k in wrappers.mods}
    answers = {}
    left_calls = []
    for label, clicks in (("bb", xbb_clicks), ("pq_bb", BENCH_XBB_CLICKS)):
        t0 = time.perf_counter()
        tables = tpcxbb.gen_tables(clicks, seed=seed)
        t_gen = time.perf_counter() - t0
        cells = list(XBB_REFS) if label == "bb" else list(BENCH_XBB)
        t0 = time.perf_counter()
        refs = {q: dict(reference(futures, "xbb", clicks, seed, q))
                for q in cells}
        aux = {q: refs[q].pop(XBB_AUX[q]) for q in cells if q in XBB_AUX}
        t_ref = time.perf_counter() - t0
        t0 = time.perf_counter()
        if label == "bb":
            dfs = {k: session.create_dataframe(v) for k, v in tables.items()}
            pivot = session.create_dataframe(
                q02_pivot_clicks(tables)["web_clickstreams"])
            torch.cuda.synchronize()
            nbytes = sum(c.validity.numel() + (
                c.data.numel() * c.data.element_size() if c.data is not None
                else c.codes.numel() * 4)
                for df in dfs.values() for c in df._plan.batch.columns)
            where = f"uploaded {nbytes / 1e9:.3f} GB"
        else:
            up = {k: session.create_dataframe(v) for k, v in tables.items()}
            written = write_sf1_parquet(torch, ctx.PE, ctx.ColumnarBatch,
                                        tables, up, pq_dir, "TPCxBB")
            dfs = {k: session.read.parquet(d)
                   for k, d in written["dirs"].items()}
            where = f"written to {len(written['files'])} parquet files"
        print(f"  TPCxBB tables at {clicks} clicks: generated {t_gen:.1f} s, "
              f"{where} in {time.perf_counter() - t0:.1f} s; waited "
              f"{t_ref:.1f} s for the numpy references; rows " + ", ".join(
                  f"{k}={v.num_rows}" for k, v in tables.items())
              + f"; q01's self-join {aux['q01']} rows, q30's sessions "
              f"{aux['q30']}")
        for q in cells:
            cell = f"{label}_{q}"
            qdfs = dict(dfs, web_clickstreams=pivot) \
                if q == "q02_pivot" else dfs
            query = tpcxbb.QUERIES[q[:3]]
            build = (lambda query=query, qdfs=qdfs: query(qdfs))
            floats = XBB_FLOATS.get(q[:3], ())
            with LeftJoinWatch(KJ, wrappers.fns["joinProbe"]) as watch:
                got_launches, got_calls, summaries[cell], mid = run_query(
                    torch, session, wrappers, cell.upper(), build,
                    keep_answer(answers, cell, lambda got, q=q, cell=cell,
                                floats=floats: check_exact(
                                    cell, got, refs[q], floats)),
                    XBB_NEED.get(q, ()))
            n_rows = len(next(iter(refs[q].values())))
            check(q == "q02" or n_rows > 0, f"{cell} returned no row")
            summaries[cell]["rows"] = n_rows
            sorted_aggs = got_launches["segmented"] > 0
            print(f"  {cell.upper()}: {n_rows} rows, equal to numpy; "
                  f"segmented (sort-path aggregates) "
                  f"{'launched' if sorted_aggs else 'not launched'}"
                  + (f"; {watch.joins} dense left join(s) in its 5 runs, "
                     f"over {watch.launches} joinProbe launch(es)"
                     if q == "q05" else ""))
            if q == "q05":
                check(watch.joins > 0 and watch.launches >= watch.joins,
                      f"{cell}: the left join did not launch joinProbe")
            if q in ("q03", "q12"):
                plan = session.explain(build()._plan)
                pairs = summaries[cell]["counters"].get(
                    "ShuffledHashJoinExec.pairs")
                check("NestedLoopJoin" not in plan,
                      f"{cell} planned a nested-loop join:\n{plan}")
                check(pairs == aux[q], f"{cell}: the residual join "
                      f"expanded {pairs} pairs, numpy counts {aux[q]}")
                summaries[cell]["residual_pairs"] = pairs
                print(f"  {cell.upper()}: the residual join expanded "
                      f"{pairs} equi pairs (numpy {aux[q]}) through the "
                      "equi matcher; no nested-loop join in the plan")
            if label == "pq_bb":
                print_scan(cell.upper(), summaries[cell])
            for k in wrappers.mods:
                launches[k] = launches.get(k, 0) + got_launches[k]
                calls[k] += got_calls[k]
            if profile:
                summaries[cell]["busy"] = profile_query(torch, cell, build,
                                                        mid)
            elif label == "bb":
                summaries[cell]["busy"] = busy_share(torch, cell.upper(),
                                                     build, mid)
        if label == "pq_bb":
            # pq_bb_q30 once more with the pipeline off, and every level
            # and index stream of these files through both run slicers
            off_dfs = {k: ctx.off_session.read.parquet(d)
                       for k, d in written["dirs"].items()}

            def run_off_q30():
                got = tpcxbb.q30(off_dfs).collect()
                return got, ctx.off_session.last_query
            ctx.pipeline_off["pq_bb_q30"] = pipeline_off_run(
                torch, "PQ_BB_Q30", run_off_q30, answers["pq_bb_q30"],
                summaries["pq_bb_q30"])
            ctx.pipeline_off["pq_bb_scans"] = scans_on_off(
                session, ctx.off_session, written["dirs"], XBB_TABLES,
                "pq_bb")
            ctx.runs_check["pq_bb"] = check_runs(
                torch, ctx.E, ctx.PD, ctx.M, written["files"], "pq_bb")
        if label == "bb":
            with Capture(KJ, "dense_join") as dj:
                tpcxbb.q05(dfs).collect()
            left_calls = [c for c in dj.calls if len(c) > 5
                          and c[5] == "left"]
            del dfs, pivot
    return summaries, launches, calls, left_calls


def rest_check(q: str, refs: dict):
    """The check of one of ``REST_QUERIES``: Q11 (by value descending,
    whose sums may round apart from numpy's) as a top-n, the rest exact
    keys with float sums to ``REV_RTOL``."""
    if q == "q11":
        return lambda got: check_top("q11", got, refs["q11"], ["ps_partkey"],
                                     "value", len(refs["q11"]["value"]))
    return lambda got: check_answer(q, got, refs[q])


def keep_answer(answers: dict, cell: str, check_fn):
    """``check_fn`` that also keeps every answer it checked, in
    ``answers[cell]``."""
    def keep(got):
        check_fn(got)
        answers.setdefault(cell, []).append(got)
    return keep


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


def check_top(q: str, got, ref, keys, value: str, n: int) -> None:
    """A top-``n`` by ``value`` (descending, then by ``keys``): keys exact,
    ``value`` to ``REV_RTOL``, the order exact except inside runs of values
    equal to the tolerance, which compare as sets (a run that crosses rank
    ``n`` may contribute any of its members), no nulls."""
    check(set(got.columns) == set(ref), f"{q}: columns {sorted(got.columns)}")
    for name in got.columns:
        check(bool(np.all(got.validity[name])), f"{q}: null in {name}")
    gk = list(zip(*(np.asarray(got.columns[k]).astype(str) for k in keys)))
    rk = list(zip(*(np.asarray(ref[k]).astype(str) for k in keys)))
    gv, rv = np.asarray(got.columns[value]), np.asarray(ref[value])
    check(len(gk) == min(n, len(rk)),
          f"{q} returned {len(gk)} rows, expected {min(n, len(rk))}")
    want = dict(zip(rk, rv))
    i = 0
    while i < len(gk):
        j = i + 1
        while j < len(rv) and abs(rv[j] - rv[j - 1]) <= REV_RTOL * abs(rv[j]):
            j += 1
        run = set(rk[i:j])
        for r in range(i, min(j, len(gk))):
            check(gk[r] in run, f"{q} rank {r + 1}: {gk[r]} is not the "
                  f"reference's row there ({sorted(run)[:4]})")
            check(abs(gv[r] - want[gk[r]]) <= REV_RTOL * abs(want[gk[r]]),
                  f"{q} rank {r + 1}: {value} {gv[r]!r} vs {want[gk[r]]!r}")
        check(len(set(gk[i:min(j, len(gk))])) == min(j, len(gk)) - i,
              f"{q} returned a row twice")
        i = j


def check_xbb_score(got, ref) -> float:
    """``xbb_score``: keys and counts exact, ``avg_score`` to ``REV_RTOL``,
    ``max_score`` within ``MAX_SCORE_ULPS`` units in the last place.
    Returns the largest difference in those units."""
    check_answer("xbb_score", got, ref)
    g = np.asarray(got.columns["max_score"], dtype=np.float64)
    w = ref["max_score"]
    ulps = float(np.max(np.abs(g - w) / np.spacing(np.abs(w))))
    check(ulps <= MAX_SCORE_ULPS, f"xbb_score: max_score {g.tolist()} vs "
          f"{w.tolist()}, {ulps} ulp apart")
    return ulps


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


def trace_run(torch, build, labels):
    """One traced warm run of ``build().collect()``: (wall us, the
    device spans, the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        build().collect()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and e.name not in labels]
    return wall_us, kernels, prof


def _busy_us(kernels) -> float:
    """Device-busy microseconds of a trace: its kernel and copy spans
    merged where they overlap."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def busy_share(torch, name, build, exec_ms) -> dict:
    """One traced warm run of a query: its wall time, the device's busy
    time and share of it, and its launches."""
    wall_us, kernels, _ = trace_run(torch, build, set(exec_ms))
    busy = _busy_us(kernels)
    print(f"  {name} traced warm run: wall {wall_us / 1e3:.3f} ms, device "
          f"busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
          f"{len(kernels)} launches")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "share": busy / wall_us, "launches": len(kernels)}


def profile_query(torch, name, build, exec_ms) -> dict:
    """Trace two warm runs of a query: device time by kernel and by
    operator, and the device's busy share of the run's wall time, from
    the trace that holds more device spans. A trace can lose spans (one
    of Q6 showed 37 launches where the next showed 137), so both counts
    are printed and a gap of more than 1 % is named. Returns what
    :func:`busy_share` does."""
    labels = set(exec_ms)
    traces = [trace_run(torch, build, labels) for _ in range(2)]
    counts = [len(t[1]) for t in traces]
    wall_us, kernels, prof = max(traces, key=lambda t: len(t[1]))
    busy = _busy_us(kernels)
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
    lost = max(counts) - min(counts) > 0.01 * max(counts)
    print(f"  {name} profile: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
          f"{len(kernels)} kernel launches (traces: {counts[0]}, "
          f"{counts[1]}{'; one trace lost spans' if lost else ''}); top: "
          + "; ".join(f"{n[:60]} {us / 1e3:.3f} ms" for n, us in top))
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "share": busy / wall_us, "launches": len(kernels)}


# --------------------------------------------------------------------------
# phase 3 driver and phase 4 timing
# --------------------------------------------------------------------------


class Wrappers:
    """The six kernel wrappers, their launch counts and capture (``hash``
    and ``strings`` are their ragged entries, the ones the path takes)."""

    def __init__(self, JP, SEG, SS, SG, HK):
        self.mods = {"joinProbe": (JP, "dense_build_probe"),
                     "segmented": (SEG, "segment_reduce_sorted"),
                     "sortStep": (SS, "packed_argsort"),
                     "strings": (SG, "gather_strings"),
                     "hash": (HK, "murmur3_string_rows"),
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


def drive_runs(torch, wrappers, run, verify):
    """The measured sequence of a query or stage: a cold ``run()`` with
    the launch counts set to 0 just before and read just after (and the
    peak device memory reset), one warm run capturing every wrapper's
    calls, then 3 timed warm runs; ``verify`` checks every run's result
    and returns what the caller keeps of it. Returns (cold ms, cold
    launch counts, peak GiB, launches per warm run, captured calls by
    kernel, the 3 warm ms, ``verify``'s values: the cold run's first,
    then the captured run's and the timed runs')."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers.reset()
    t0 = time.perf_counter()
    got = run()
    cold_ms = (time.perf_counter() - t0) * 1e3
    launches = wrappers.counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    kept = [verify(got)]
    caps = {k: Capture(*wrappers.mods[k]) for k in wrappers.mods}
    for c in caps.values():
        c.__enter__()
    try:
        before = wrappers.counts()
        got = run()
        warm_launches = {k: v - before[k]
                         for k, v in wrappers.counts().items()}
    finally:
        for c in caps.values():
            c.__exit__()
    kept.append(verify(got))
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = run()
        runs.append((time.perf_counter() - t0) * 1e3)
        kept.append(verify(got))
    return (cold_ms, launches, peak_gib, warm_launches,
            {k: c.calls for k, c in caps.items()}, runs, kept)


def run_query(torch, session, wrappers, name, build, check_fn, need,
              shards: int = 0):
    """A query through :func:`drive_runs`: every run on the mesh path
    over ``shards`` shards when that is given, else on the single path,
    and checked by ``check_fn``; each kernel of ``need`` must launch in
    the cold run. Returns (cold launch counts, captured calls by kernel,
    a summary dict with the cold run's peak device memory, the median
    run's per-exec ms)."""
    last = {}

    def verify(got):
        info = session.last_query
        check_path(session, name, shards)
        check_fn(got)
        last["got"] = got
        return info

    cold_ms, launches, peak_gib, warm_launches, calls, runs, infos = \
        drive_runs(torch, wrappers, lambda: build().collect(), verify)
    info = infos[0]
    print(f"  {name} {at()} cold run: {cold_ms:.1f} ms, {info.attempts} "
          f"attempt(s), path {info.path} over {info.shards} shard(s), "
          f"sites {info.site_kinds}, modes {info.dense_modes}; "
          f"kernel launches {launches}; peak device memory "
          f"{peak_gib:.2f} GiB")
    for k in need:
        check(launches[k] > 0, f"{k} was not launched during {name}")
    e2e = statistics.median(runs)
    mid_info = infos[2 + runs.index(e2e)]
    mid = mid_info.exec_ms
    print(f"  {name} warm runs: {[round(r, 3) for r in runs]} ms, median "
          f"{e2e:.3f} ms; launches per warm run {warm_launches}")
    print(f"  {name} per exec (ms, median run): "
          + ", ".join(f"{k}={v:.3f}" for k, v in mid.items()))
    print(f"  {name} answer matches the numpy reference: " + json.dumps(
        {k: np.asarray(v).tolist()[:10]
         for k, v in last["got"].columns.items()}))
    summary = {"cold_ms": cold_ms, "warm_median_ms": e2e,
               "warm_runs_ms": runs, "attempts": info.attempts,
               "path": info.path, "shards": info.shards,
               "peak_gib": peak_gib, "launches": launches,
               "per_exec_ms": mid, "counters": mid_info.counters}
    return launches, calls, summary, mid


def group_by_string_key(torch, KG, T, HostBatch, wrappers, name, col,
                        n_rows, values):
    """``group_ids``, then ``segment_reduce`` (count) and
    ``gather_group_keys`` over one string key column, timed, its launch
    counts set to 0 just before and read just after. The groups, each key
    and its row count must equal numpy's ``np.unique(values,
    return_counts=True)``; the rowwise-compare kernel must launch. A
    second, untimed run records the ``strings`` gather's calls. Returns
    (a summary dict, those calls)."""
    from spark_rapids_tpu_torch.data.batch import ColumnarBatch
    cap, dev = col.capacity, col.device

    def run():
        seg, n_groups, firsts = KG.group_ids([col], n_rows)
        live = torch.arange(cap, device=dev) < n_rows
        counts, _ = KG.segment_reduce(
            torch.ones(cap, dtype=torch.int64, device=dev), col.validity,
            seg, cap, "count", live)
        [keys] = KG.gather_group_keys([col], firsts, n_groups)
        return n_groups, counts, keys

    wrappers.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_groups, counts, keys = run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = wrappers.counts()
    # the kernels' calls, recorded in a second run outside the timed one
    with Capture(*wrappers.mods["strings"]) as captured:
        run()
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
            "groups": ng, "ms": ms, "launches": launches}, captured.calls


def run_entry_stage(torch, ENTRY, HostBatch, wrappers, name, profile,
                    **kwargs):
    """The engine's entry stage (``spark_rapids_tpu_torch.entry.entry``)
    at ``kwargs`` through :func:`drive_runs` (and, with ``profile``,
    :func:`profile_query`'s traced runs): every run's groups (key, sum,
    count, min, max) must equal ``entry_reference``'s exactly, and
    ``segmented`` must have launched its min and max in the cold run.
    Returns (cold launch counts, captured ``segmented`` calls, a summary
    dict)."""
    forward, (batch,) = ENTRY.entry(**kwargs)
    cols = ENTRY.entry_columns(**{k: v for k, v in kwargs.items()
                                  if k != "device"})
    want = ENTRY.entry_reference(cols)

    def run():
        out, fail = forward(batch)
        return fail, HostBatch.from_device(out)

    def verify(result) -> None:
        fail, got = result
        check(fail is None, f"{name}: the sort path reported a fail flag")
        for col_name, w in want.items():
            g = got.columns[col_name]
            check(bool(np.all(got.validity[col_name])),
                  f"{name}: null in {col_name}")
            check(len(g) == len(w) and np.array_equal(g, w),
                  f"{name}: {col_name} {list(g[:6])} vs {list(w[:6])}")

    cold_ms, launches, peak_gib, _, calls, runs, _ = drive_runs(
        torch, wrappers, run, verify)
    ops = sorted(c[-1] for c in calls["segmented"])
    check(launches["segmented"] > 0 and {"min", "max"} <= set(ops),
          f"{name}: segmented launched {launches['segmented']} time(s), "
          f"ops {ops}")
    if profile:
        profile_query(torch, name.lower(),
                      lambda: types.SimpleNamespace(collect=run), {})
    groups = len(want["k"])
    print(f"  {name} (n={len(cols['k'])}, capacity {batch.capacity}, "
          f"{groups} groups): cold {cold_ms:.1f} ms, warm runs "
          f"{[round(r, 3) for r in runs]} ms, median "
          f"{statistics.median(runs):.3f} ms; kernel launches {launches}, "
          f"segmented ops {ops}; peak device memory {peak_gib:.2f} GiB; "
          "every group equals numpy's")
    return launches, calls["segmented"], {
        "rows": len(cols["k"]), "capacity": batch.capacity,
        "groups": groups, "cold_ms": cold_ms, "warm_runs_ms": runs,
        "warm_median_ms": statistics.median(runs), "peak_gib": peak_gib,
        "launches": launches, "segmented_ops": ops}


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


def join_slots(torch, swapped, probe, build, pk, bk):
    """The slots ``ops/kernels/join.py``'s direct-address joins compute
    ahead of ``joinProbe``, as they compute them: the table side's
    (unusable rows to ``tbl``) and the other side's (unusable rows to 0),
    both cast to int32."""
    key, key_batch = (pk, probe) if swapped else (bk, build)
    other, other_batch = (bk, build) if swapped else (pk, probe)
    tbl = key.capacity * 4
    k = key.data.long()
    usable = key_batch.row_mask() & key.validity
    slot = torch.where(usable & (k >= 0) & (k < tbl), k, tbl)
    o = other.data.long()
    reach = other_batch.row_mask() & other.validity & (o >= 0) & (o < tbl)
    oslot = torch.where(reach, o, 0)
    return (slot.to(torch.int32).contiguous(),
            oslot.to(torch.int32).contiguous(), tbl)


def time_q3_joins(torch, KJ, JP, dfs, flush) -> list:
    """Q3's direct-address joins (one warm run captured): each whole
    ``dense_join`` call, its slot preparation and its ``joinProbe``
    call, with the L2 flushed; the prepared slots must be the kernel's
    captured inputs."""
    from spark_rapids_tpu_torch.workloads import tpch
    with Capture(KJ, "dense_join") as d1, \
            Capture(KJ, "dense_join_swapped") as d2, \
            Capture(JP, "dense_build_probe") as kp:
        tpch.q3(dfs).collect()
    joins = [(False, c) for c in d1.calls] + [(True, c) for c in d2.calls]
    check(len(joins) == len(kp.calls), "Q3's direct-address joins and "
          "joinProbe calls do not pair up")
    out = []
    for swapped, args in joins:
        probe, build, pk, bk = args[:4]
        slot, oslot, tbl = join_slots(torch, swapped, probe, build, pk, bk)
        check(any(torch.equal(slot, b) and torch.equal(oslot, p) and tbl == t
                  for b, p, t in kp.calls),
              "the mirrored slot preparation differs from the join's")
        fn = KJ.dense_join_swapped if swapped else KJ.dense_join
        whole = median_ms(torch, lambda: fn(*args), flush)
        prep = median_ms(torch, lambda: join_slots(torch, swapped, probe,
                                                   build, pk, bk), flush)
        kern = median_ms(torch, lambda: JP.dense_build_probe(slot, oslot,
                                                             tbl), flush)
        print(f"  Q3 {'swapped ' if swapped else ''}dense join, table "
              f"side {slot.numel()} rows, other side {oslot.numel()}: whole "
              f"call {whole:.4f} ms, slot preparation {prep:.4f} ms, "
              f"joinProbe {kern:.4f} ms")
        out.append({"swapped": swapped, "table_rows": slot.numel(),
                    "other_rows": oslot.numel(), "whole_ms": whole,
                    "slot_prep_ms": prep, "joinprobe_ms": kern})
    return out


def time_left_joins(torch, KJ, JP, left_calls, flush) -> list:
    """``bb_q05``'s direct-address LEFT joins (one warm run captured):
    each whole ``dense_join`` call, its slot preparation and its
    ``joinProbe`` call, with the L2 flushed."""
    out = []
    for args in left_calls:
        probe, build, pk, bk = args[:4]
        slot, oslot, tbl = join_slots(torch, False, probe, build, pk, bk)
        whole = median_ms(torch, lambda: KJ.dense_join(*args), flush)
        prep = median_ms(torch, lambda: join_slots(torch, False, probe,
                                                   build, pk, bk), flush)
        kern = median_ms(torch, lambda: JP.dense_build_probe(slot, oslot,
                                                             tbl), flush)
        live = int(((slot >= 0) & (slot < tbl)).sum())
        print(f"  BB_Q05 dense left join, table side {slot.numel()} rows "
              f"({live} live), probe side {oslot.numel()}: whole call "
              f"{whole:.4f} ms, slot preparation {prep:.4f} ms, joinProbe "
              f"{kern:.4f} ms")
        out.append({"table_rows": slot.numel(), "live_b": live,
                    "other_rows": oslot.numel(), "whole_ms": whole,
                    "slot_prep_ms": prep, "joinprobe_ms": kern})
    return out


def time_matrix_hash(torch, HK, SU, dfs, rng, flush) -> dict:
    """The matrix entry of ``hash`` at ``q1_hash_str``'s shape (lineitem's
    ``l_returnflag``, random seeds), beside the char matrix it needs and
    the ragged entry on the same column: the route each exchange took
    before the ragged entry, and the one it takes now. Both entries must
    give the same hashes."""
    flag = dfs["lineitem"]._plan.batch.column("l_returnflag")
    n, w = flag.capacity, max(flag.max_bytes, 1)
    seed = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, n).astype(
        np.int32), device=flag.device)
    mat, lens = SU.char_matrix(flag), SU.lengths(flag)
    payload, offsets = flag.dict_bytes
    ragged = HK.murmur3_string_rows(payload, offsets, flag.codes, w, seed)
    check(bits_equal(torch, HK.murmur3_bytes_rows(mat, lens, seed), ragged),
          "the matrix and ragged hash entries differ on l_returnflag")
    ms = median_ms(torch, lambda: HK.murmur3_bytes_rows(mat, lens, seed),
                   flush)
    del mat
    cm_ms = median_ms(torch, lambda: SU.char_matrix(flag), flush, reps=5)
    ragged_ms = median_ms(torch, lambda: HK.murmur3_string_rows(
        payload, offsets, flag.codes, w, seed), flush)
    # lengths, seed and output plus the 32-byte sectors of chars each
    # row's length needs
    chars = 2 * lens.long().clamp(0, w)
    nbytes = 12 * n + int((32 * ((chars + 31) // 32)).sum())
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  hash matrix entry at l_returnflag n={n} W={w}: kernel "
          f"{ms:.4f} ms, bound {bound:.4f} ms; its char matrix {cm_ms:.4f} "
          f"ms (writes {2 * n * w / 2 ** 30:.2f} GiB); the ragged entry on "
          f"the same column {ragged_ms:.4f} ms")
    return {"n": n, "width": w, "ms": ms, "bound_ms": bound,
            "char_matrix_ms": cm_ms, "ragged_ms": ragged_ms}


def time_joinprobe(torch, JP, jp_call_args, n_launches, flush):
    """``joinProbe`` at each captured call: equal to the plain version,
    timed, with the table clear beside the bound. Returns (the
    kernels-line row, per-call dicts)."""
    jp = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "err": 0, "clear": 0}
    jp_calls = []
    for bslot, pslot, tbl in jp_call_args:
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
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        clear = 8 * tbl
        clear_ms = clear / HBM_BYTES_PER_S * 1e3
        live = int(((bslot >= 0) & (bslot < tbl)).sum())
        print(f"  joinProbe cap_b={bslot.numel()} ({live} live) "
              f"cap_p={pslot.numel()} tbl={tbl}: kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms, bound "
              f"{bound:.4f} ms, table clear {clear} B {clear_ms:.4f} ms, "
              f"bound + clear {bound + clear_ms:.4f} ms "
              f"({ms / (bound + clear_ms):.2f}x)")
        jp_calls.append({"cap_b": bslot.numel(), "live_b": live,
                         "cap_p": pslot.numel(), "tbl": tbl, "ms": ms,
                         "plain_ms": pms,
                         "bound_ms": bound, "clear_ms": clear_ms})
        jp["ms"] += ms
        jp["plain_ms"] += pms
        jp["bytes"] += nbytes
        jp["clear"] += clear
    print(f"  joinProbe summed over {len(jp_call_args)} calls: "
          f"{jp['ms']:.4f} ms, bound "
          f"{jp['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms + table clear "
          f"{jp['clear'] / HBM_BYTES_PER_S * 1e3:.4f} ms")
    return {"name": "joinProbe", "route": "cuda",
            "source": "spark_rapids_tpu_torch/ops/kernels/cuda/csrc/"
                      "join_probe.cu",
            "replaces": "spark_rapids_tpu/ops/kernels/pallas/"
                        "join_probe.py:87",
            "launches": n_launches,
            "max_abs_err": jp["err"], "ms": jp["ms"],
            "plain_ms": jp["plain_ms"],
            "bound_ms": jp["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None}, jp_calls


def time_ragged_hash(torch, HK, hash_call_args, n_launches, flush):
    """The ragged ``hash`` entry at each captured call: equal to the plain
    version and to numpy murmur3, timed, with its bound. Returns (the
    kernels-line row, per-call dicts)."""
    hs = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "err": 0}
    hash_calls = []
    for payload, offsets, codes, width, seed in hash_call_args:
        n = seed.numel()
        got_k = HK.murmur3_string_rows(payload, offsets, codes, width, seed)
        want = HK.murmur3_string_rows_plain(payload, offsets, codes, width,
                                            seed)
        kind = "flat" if codes is None else "dictionary"
        check(bits_equal(torch, got_k, want), "ragged hash differs from the "
              f"plain version at n={n} W={width} ({kind})")
        check(np.array_equal(
            got_k.cpu().numpy().view(np.uint32), np_hash_layout(
                payload.cpu().numpy(), offsets.cpu().numpy(),
                None if codes is None else codes.cpu().numpy(), width,
                seed.cpu().numpy())),
            f"ragged hash differs from the numpy murmur3 at n={n} W={width}")
        hs["err"] = max(hs["err"], max_abs_err(torch, got_k, want))
        ms = median_ms(torch, lambda: HK.murmur3_string_rows(
            payload, offsets, codes, width, seed), flush)
        pms = median_ms(torch, lambda: HK.murmur3_string_rows_plain(
            payload, offsets, codes, width, seed), flush, reps=5)
        # the code (dictionary) or offset (flat), seed and output of each
        # row, plus each entry's bytes (up to W) and a dictionary's
        # offsets, read once
        entry_bytes = int((offsets[1:] - offsets[:-1]).clamp(0, width).sum())
        nbytes = 12 * n + entry_bytes \
            + (4 * offsets.numel() if codes is not None else 0)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"  ragged hash n={n} W={width} ({kind}, "
              f"{offsets.numel() - 1} entries): kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms, no one PyTorch call, bound {bound:.4f} ms "
              f"({ms / bound:.1f}x)")
        hash_calls.append({"n": n, "width": width, "kind": kind, "ms": ms,
                           "plain_ms": pms, "bound_ms": bound})
        hs["ms"] += ms
        hs["plain_ms"] += pms
        hs["bytes"] += nbytes
    return {"name": "hash", "route": "cuda",
            "source": "spark_rapids_tpu_torch/ops/kernels/cuda/csrc/"
                      "hashing.cu",
            "replaces": "spark_rapids_tpu/ops/kernels/pallas/"
                        "hashing.py:69",
            "launches": n_launches, "max_abs_err": hs["err"],
            "ms": hs["ms"], "plain_ms": hs["plain_ms"],
            "bound_ms": hs["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None}, hash_calls


def gather_bound_bytes(torch, payload, offsets, idx, valid, width,
                       bytes_out):
    """(bytes, distinct source rows) the ragged gather must move at one
    call: idx and valid of every row; for each distinct source row a
    valid row takes, its offsets entries (neighbours share one) and its
    clipped bytes, read once; the output offsets and the gathered bytes,
    written once. Rows that are not valid read no source; the payload
    past the gathered bytes is the clear beside the bound."""
    n, m = offsets.numel() - 1, idx.numel()
    nbytes = 5 * m + 4 * (m + 1) + bytes_out
    if n == 0:
        return nbytes, 0
    src = torch.unique(idx.long().clamp(0, n - 1)[valid.bool()])
    entries = torch.unique(torch.cat([src, src + 1])).numel()
    lens = (offsets[src + 1].long() - offsets[src].long()).clamp(0, width)
    return nbytes + 4 * entries + int(lens.sum()), src.numel()


def time_gather_strings(torch, SG, gathers, n_launches, flush):
    """The ragged ``strings`` gather at each captured call: offsets and
    payload equal to the plain version and to the char-matrix route it
    replaced (``_matrix_from_offsets`` + ``ragged_gather`` +
    ``pack_rows``) bit for bit, then the three timed, with the bound and
    the payload's tail clear beside them. Returns (the kernels-line row,
    per-call dicts)."""
    from spark_rapids_tpu_torch.ops import strings_util as SU

    def matrix_route(payload, offsets, idx, valid, width, byte_cap):
        mat = SU._matrix_from_offsets(payload, offsets, width)
        return SG.pack_rows(SG.ragged_gather(mat, idx, valid), byte_cap)

    st = {"ms": 0.0, "plain_ms": 0.0, "route_ms": 0.0, "bytes": 0,
          "tail": 0, "err": 0}
    per_call = []
    for args in gathers:
        payload, offsets, idx, valid, width, byte_cap = args
        n, m = offsets.numel() - 1, idx.numel()
        got = SG.gather_strings(*args)
        for what, want in (("plain version", SG.gather_strings_plain(*args)),
                           ("char-matrix route", matrix_route(*args))):
            check(bits_equal(torch, got[1], want[1])
                  and bits_equal(torch, got[0], want[0]),
                  f"ragged strings gather n={n} m={m} W={width} differs "
                  f"from the {what}")
            st["err"] = max(st["err"], max_abs_err(torch, got[0], want[0]),
                            max_abs_err(torch, got[1], want[1]))
        ms = median_ms(torch, lambda: SG.gather_strings(*args), flush)
        route_ms = median_ms(torch, lambda: matrix_route(*args), flush)
        pms = median_ms(torch, lambda: SG.gather_strings_plain(*args),
                        flush)
        nbytes_out = int(got[1][-1])
        nbytes, src_rows = gather_bound_bytes(torch, *args[:5], nbytes_out)
        tail = byte_cap - nbytes_out
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        tail_ms = tail / HBM_BYTES_PER_S * 1e3
        print(f"  ragged strings gather n={n} m={m} W={width} "
              f"({int(valid.sum())} valid rows, {src_rows} source rows, "
              f"{nbytes_out} bytes gathered, byte_cap {byte_cap}): kernel "
              f"{ms:.4f} ms, char-matrix route {route_ms:.4f} ms, plain "
              f"{pms:.4f} ms, no one PyTorch call, bound {bound:.6f} ms, "
              f"tail clear {tail} B {tail_ms:.4f} ms, bound + clear "
              f"{bound + tail_ms:.4f} ms ({ms / (bound + tail_ms):.2f}x)")
        per_call.append({"n": n, "m": m, "width": width,
                         "valid_rows": int(valid.sum()),
                         "source_rows": src_rows,
                         "bytes_out": nbytes_out, "byte_cap": byte_cap,
                         "ms": ms, "route_ms": route_ms, "plain_ms": pms,
                         "bound_ms": bound, "tail_ms": tail_ms})
        st["ms"] += ms
        st["plain_ms"] += pms
        st["route_ms"] += route_ms
        st["bytes"] += nbytes
        st["tail"] += tail
    print(f"  ragged strings gather summed over {len(gathers)} calls: "
          f"{st['ms']:.4f} ms, char-matrix route {st['route_ms']:.4f} ms, "
          f"plain {st['plain_ms']:.4f} ms, bound "
          f"{st['bytes'] / HBM_BYTES_PER_S * 1e3:.6f} ms + tail clear "
          f"{st['tail'] / HBM_BYTES_PER_S * 1e3:.4f} ms")
    return {"name": "strings", "route": "cuda",
            "source": "spark_rapids_tpu_torch/ops/kernels/cuda/csrc/"
                      "strings.cu",
            "replaces": "spark_rapids_tpu/ops/kernels/pallas/strings.py:48",
            "launches": n_launches, "max_abs_err": st["err"],
            "ms": st["ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None}, per_call


def time_matrix_gather(torch, SG, SU, gathers, flush) -> dict:
    """The matrix entry of the ``strings`` gather (the Pallas kernel's
    counterpart, off the path) at the largest captured call's shape: its
    char matrix built from the call's layout, the entry against its plain
    version bit for bit, timed beside its ``index_select`` + ``where``
    yardstick, with its bound."""
    payload, offsets, idx, valid, width, _ = max(
        gathers, key=lambda a: a[2].numel() * a[4])
    mat = SU._matrix_from_offsets(payload, offsets, width)
    n, w = mat.shape
    m = idx.numel()
    got = SG.ragged_gather(mat, idx, valid)
    check(bits_equal(torch, got, SG.ragged_gather_plain(mat, idx, valid)),
          f"strings matrix gather differs from the plain version at n={n} "
          f"m={m} W={w}")
    ms = median_ms(torch, lambda: SG.ragged_gather(mat, idx, valid), flush)
    pms = median_ms(torch, lambda: SG.ragged_gather_plain(mat, idx, valid),
                    flush)
    safe = idx.long().clamp(0, n - 1)
    lib = median_ms(torch, lambda: torch.where(
        valid[:, None], mat.index_select(0, safe), -1), flush)
    # idx and valid read, the output written, and one read of each distinct
    # source row a valid output row takes
    src_rows = torch.unique(safe[valid.bool()]).numel()
    bound = (5 * m + 2 * m * w + 2 * w * src_rows) / HBM_BYTES_PER_S * 1e3
    print(f"  strings matrix gather (off the path) at n={n} m={m} W={w}, "
          f"{src_rows} source rows read: kernel {ms:.4f} ms, plain "
          f"{pms:.4f} ms, index_select + where {lib:.4f} ms, bound "
          f"{bound:.4f} ms")
    return {"n": n, "m": m, "width": w, "ms": ms, "plain_ms": pms,
            "library_ms": lib, "bound_ms": bound}


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
# the parquet scan: snappy, the fixture, the SF1 files
# --------------------------------------------------------------------------

#: Rows of one SF1 file the script writes: pyarrow's default row group
#: (lineitem lands in 6 files, as the bench's pyarrow files hold 6 row
#: groups; orders in 2).
PQ_ROWS_PER_FILE = 1 << 20
FIXTURE = Path(__file__).resolve().parent / "tests" / "data" / \
    "lineitem_fixture.parquet"


def snappy_edge_cases(SN, SC) -> None:
    """The C++ snappy routine against the plain Python version: every tag
    kind and overlapping copy decompressed as one page list (and equal to
    the expected bytes), every malformed block refused, and the
    compressor byte for byte the plain one's, round trip included."""
    src, pages, size, wants = SC.page_batch(SC.valid_cases())
    got = np.zeros(size, np.uint8)
    plain = np.zeros(size, np.uint8)
    SN.decompress_pages(src, pages, got, "cuda")
    SN.decompress_pages(src, pages, plain, "cpu")
    check(np.array_equal(got, plain), "snappy: C++ and plain differ")
    for (_, _, d, n), want in zip(pages.tolist(), wants):
        check(got[d:d + n].tobytes() == want, "snappy: a page differs from "
              "its expected bytes")
    for name, raw in SC.malformed_cases().items():
        n = SN._varint(raw, 0)[0] if raw and raw[0] != 0xFF else 5
        out = np.zeros(max(n, 1), np.uint8)
        try:
            SN.decompress_pages(np.frombuffer(raw, np.uint8),
                                np.array([[0, len(raw), 0, n]]), out, "cuda")
        except SN.SnappyError:
            continue
        fail(f"snappy: malformed input ({name}) was not refused")
    for name, data in SC.compress_inputs().items():
        c = SN.compress(data, "cuda")
        check(c == SN.compress_plain(data), f"snappy compress ({name}) "
              "differs from the plain version")
        back = np.zeros(len(data), np.uint8)
        SN.decompress_pages(np.frombuffer(c, np.uint8),
                            np.array([[0, len(c), 0, len(data)]]), back,
                            "cuda")
        check(back.tobytes() == data, f"snappy round trip ({name})")
    print(f"  snappy: {len(wants)} tag-kind cases, "
          f"{len(SC.malformed_cases())} malformed blocks refused, "
          f"{len(SC.compress_inputs())} compressions byte for byte the "
          "plain version's and round trip")


def _column_bits_equal(a, b, name: str) -> bool:
    """Column ``name`` of two HostBatches: equal validity, and equal
    values where valid (floats bit for bit)."""
    va, vb = a.validity[name], b.validity[name]
    if not np.array_equal(va, vb):
        return False
    x, y = np.asarray(a.columns[name]), np.asarray(b.columns[name])
    if x.dtype == object:
        return list(x[va]) == list(y[vb])
    if x.dtype.kind == "f":
        return np.array_equal(x[va].view(f"i{x.itemsize}"),
                              y[vb].view(f"i{y.itemsize}"))
    return np.array_equal(x[va], y[vb])


def host_columns_equal(a, b, what: str) -> None:
    """Two HostBatches with equal validity and equal values where valid
    (floats bit for bit)."""
    check(list(a.columns) == list(b.columns), f"{what}: columns differ")
    for name in a.columns:
        check(_column_bits_equal(a, b, name), f"{what}: {name} differs")


def check_fixture_decode(PD, M, HostBatch) -> dict:
    """Every row group of the committed pyarrow file (the layouts the
    port's writer never produces) decoded on the card and on the CPU:
    equal column by column."""
    path = str(FIXTURE)
    meta = M.read_footer(path)
    schema = M.schema_from_parquet(meta, path)
    rows = 0
    for rg in range(meta.num_row_groups):
        card = HostBatch.from_device(PD.decode_row_group(
            path, rg, schema, meta, device="cuda"))
        cpu = HostBatch.from_device(PD.decode_row_group(
            path, rg, schema, meta, device="cpu"))
        host_columns_equal(card, cpu, f"fixture row group {rg}")
        rows += card.num_rows
    print(f"  fixture {FIXTURE.name}: {meta.num_row_groups} row groups, "
          f"{rows} rows, {len(schema)} columns decoded on the card equal "
          "the CPU decode")
    return {"row_groups": meta.num_row_groups, "rows": rows}


def device_rows(torch, ColumnarBatch, batch, a: int, b: int):
    """Rows ``[a, b)`` of a physical device batch: views of its lanes,
    dictionaries shared."""
    cols = [dataclasses.replace(c, validity=c.validity[a:b],
                                codes=c.codes[a:b]) if c.is_dict else
            dataclasses.replace(c, data=c.data[a:b],
                                validity=c.validity[a:b])
            for c in batch.columns]
    return ColumnarBatch(tuple(cols), torch.clamp(batch.n_rows - a, 0, b - a),
                         batch.schema)


def write_sf1_parquet(torch, PE, ColumnarBatch, tables, dfs,
                      out_dir: str, label: str = "SF1") -> dict:
    """Every table through the port's writer (SNAPPY, one row group a
    file, ``PQ_ROWS_PER_FILE`` rows a file) into
    ``out_dir/<label>/<table>/``, from the tables already uploaded to
    the card. Returns the directories and what was written."""
    t0 = time.perf_counter()
    dirs, files, nbytes = {}, [], 0
    for name, hb in tables.items():
        d = Path(out_dir) / label / name
        d.mkdir(parents=True)
        dirs[name] = str(d)
        batch = dfs[name]._plan.batch
        for i, a in enumerate(range(0, max(hb.num_rows, 1),
                                    PQ_ROWS_PER_FILE)):
            part = device_rows(torch, ColumnarBatch, batch, a,
                               a + PQ_ROWS_PER_FILE)
            path = str(d / f"part-{i:05d}.parquet")
            nbytes += PE.write_device_batch(part, path)
            files.append(path)
    secs = time.perf_counter() - t0
    print(f"  wrote the {label} tables with the port's writer (SNAPPY): "
          f"{len(files)} files, {nbytes / 1e6:.1f} MB in {secs:.1f} s")
    return {"dirs": dirs, "files": files, "bytes": nbytes, "seconds": secs}


def plain_page_digest(task) -> bytes:
    """SHA-256 of one page decompressed by the plain Python snappy (run
    in a worker process)."""
    from spark_rapids_tpu_torch.io import snappy as SN
    raw, size = task
    return hashlib.sha256(SN.decompress_plain(raw, size)).digest()


def column_chunks(PD, M, files):
    """Every column chunk of ``files``: (its bytes, its pages as rows of
    (payload offset, compressed bytes, output offset, output bytes), the
    output size), the pages laid out back to back."""
    for path in files:
        raw = Path(path).read_bytes()
        for rg in M.read_footer(path).row_groups:
            for c in rg.columns:
                chunk = np.frombuffer(raw, np.uint8, c.total_compressed_size,
                                      c.start)
                pos, pages, dst = 0, [], 0
                while pos < len(chunk):
                    ph = PD.parse_page_header(chunk, pos)
                    pages.append((ph.payload_pos, ph.compressed_size, dst,
                                  ph.uncompressed_size))
                    dst += ph.uncompressed_size
                    pos = ph.payload_pos + ph.compressed_size
                yield chunk, np.array(pages, np.int64), dst


def check_sf1_pages(SN, PD, M, files) -> dict:
    """Every page of the SF1 files decompressed by the C++ routine (one
    call a column chunk) and by the plain version (spread over worker
    processes, compared by SHA-256 of the output)."""
    t0 = time.perf_counter()
    tasks, native, out_bytes = [], [], 0
    for chunk, pages, size in column_chunks(PD, M, files):
        out = np.zeros(size, np.uint8)
        SN.decompress_pages(chunk, pages, out, "cuda")
        for so, sn, d, n in pages.tolist():
            tasks.append((chunk[so:so + sn].tobytes(), n))
            native.append(hashlib.sha256(out[d:d + n]).digest())
        out_bytes += size
    t_native = time.perf_counter() - t0
    workers = min(8, os.cpu_count() or 1)
    with ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn")) as ex:
        plain = list(ex.map(plain_page_digest, tasks))
    bad = [i for i, (a, b) in enumerate(zip(native, plain)) if a != b]
    check(len(plain) == len(native) and not bad,
          f"snappy: C++ and plain differ on {len(bad)} SF1 pages")
    secs = time.perf_counter() - t0
    print(f"  snappy: all {len(tasks)} pages of the SF1 files "
          f"({out_bytes / 1e6:.1f} MB out) equal between the C++ routine "
          f"and the plain version ({workers} worker processes; "
          f"{secs:.1f} s, of which the C++ pass {t_native:.1f} s)")
    return {"pages": len(tasks), "bytes_out": out_bytes, "seconds": secs}


def print_scan(name: str, summary: dict) -> None:
    """A parquet cell's scan breakdown (median run), with the run's wall
    time, the consumer's wait for row groups (``stall``) and the decode
    workers' time (``busy``, summed over threads, as the host-phase
    timers are)."""
    ms = summary["per_exec_ms"]
    c = summary["counters"]
    part = {k: ms.get(f"ParquetScanExec.{k}", 0.0) for k in (
        "read", "parse", "decompress", "runs", "upload", "decode", "stall",
        "busy")}
    print(f"  {name} scan (median run): file read {part['read']:.3f} ms, "
          f"footer and page-header parse {part['parse']:.3f} ms, snappy "
          f"{part['decompress']:.3f} ms, run tables {part['runs']:.3f} ms "
          f"(host clock, summed over threads); upload {part['upload']:.3f} "
          f"ms, device decode {part['decode']:.3f} ms (CUDA events); wall "
          f"{summary['warm_median_ms']:.3f} ms, stall {part['stall']:.3f} "
          f"ms, decode workers busy {part['busy']:.3f} ms; "
          f"{c.get('ParquetScanExec.rows', 0)} rows, "
          f"{c.get('ParquetScanExec.read_bytes', 0)} bytes read, "
          f"{c.get('ParquetScanExec.bytes', 0)} bytes decompressed, "
          f"{c.get('ParquetScanExec.snappy_chunks', 0)} snappy calls")
    summary["scan_ms"] = part


def same_bits(a, b) -> bool:
    """Whether two answers are equal bit for bit (floats included)."""
    return list(a.columns) == list(b.columns) and all(
        _column_bits_equal(a, b, name) for name in a.columns)


def answers_match(got, want, what: str, floats=()) -> None:
    """``got`` equal to ``want``: bit for bit, except the ``floats``
    columns (sums the card adds in atomic order), which must have the
    same validity and agree to ``REV_RTOL``."""
    exact = [k for k in want.columns if k not in floats]
    pick = lambda hb, ks: types.SimpleNamespace(  # noqa: E731
        columns={k: hb.columns[k] for k in ks},
        validity={k: hb.validity[k] for k in ks})
    host_columns_equal(pick(got, exact), pick(want, exact), what)
    for k in floats:
        check(np.array_equal(got.validity[k], want.validity[k]),
              f"{what}: {k} validity differs")
        g, w = (np.asarray(x.columns[k], np.float64) for x in (got, want))
        check(bool(np.all(np.abs(g - w) <= REV_RTOL * np.abs(w))),
              f"{what}: {k} {g.tolist()} vs {w.tolist()}")


def pipeline_off_run(torch, name: str, run_off, on_answers, on_summary,
                     floats=()) -> dict:
    """A parquet cell again with ``spark.rapids.tpu.pipeline.enabled``
    false: ``run_off()`` collects it in a session of that conf (a cold
    run that learns its modes, then a timed warm one). Both answers must
    equal the pipeline-on ones: bit for bit, but for the ``floats``
    columns (sums in atomic order, whose last bits vary from run to run
    with the pipeline on or off), which agree to ``REV_RTOL``; whether
    the pipeline-on runs themselves agreed bit for bit is printed. Prints
    the warm run's wall and scan breakdown beside the pipeline-on
    median."""
    outs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, info = run_off()
        outs.append(((time.perf_counter() - t0) * 1e3, info, got))
        answers_match(got, on_answers[-1], f"{name} with the pipeline off",
                      floats)
    wall, info, got = outs[1]
    on_same = all(same_bits(a, on_answers[0]) for a in on_answers)
    off_same = same_bits(got, on_answers[-1])
    summary = {"warm_median_ms": wall, "per_exec_ms": info.exec_ms,
               "counters": info.counters, "attempts": info.attempts,
               "cold_ms": outs[0][0], "bits_equal_to_on": off_same,
               "on_runs_bits_equal": on_same}
    on_ms = on_summary["warm_median_ms"]
    print(f"  {name} with the pipeline off: cold {outs[0][0]:.1f} ms, warm "
          f"{wall:.3f} ms (pipeline on: median {on_ms:.3f} ms); answers "
          f"equal to the pipeline-on answer ("
          + ("bit for bit" if off_same else
             f"{', '.join(floats)} to rtol {REV_RTOL}, the rest bit for "
             "bit") + f"); the {len(on_answers)} pipeline-on answers "
          + ("equal bit for bit" if on_same else
             "differ among themselves in the last bits of their sums"))
    print_scan(name + " (pipeline off)", summary)
    return {k: v for k, v in summary.items() if k != "per_exec_ms"}


def scans_on_off(on_session, off_session, dirs: dict, names, label: str
                 ) -> dict:
    """The tables ``names`` of ``dirs`` collected straight from the scan
    with the pipeline on and off: equal bit for bit."""
    rows = 0
    t0 = time.perf_counter()
    for name in names:
        on = on_session.read.parquet(dirs[name]).collect()
        off = off_session.read.parquet(dirs[name]).collect()
        host_columns_equal(on, off, f"{label} {name} scan, pipeline on vs "
                           "off")
        rows += on.num_rows
    print(f"  {label} scans of {', '.join(names)} ({rows} rows) with the "
          f"pipeline on and off: equal bit for bit "
          f"({time.perf_counter() - t0:.1f} s)")
    return {"tables": list(names), "rows": rows}


def _uvarint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def parquet_runs_edge_cases(PD, seed: int) -> None:
    """The C++ run slicer (``csrc/parquet_runs.cpp``) against the plain
    ``parse_hybrid`` on hand-made hybrid streams at bit widths 0-24: RLE
    and bit-packed runs, runs of count 0, streams longer than the page's
    values (counts capped) and shorter (an RLE tail of zeros), streams at
    odd staging offsets; equal run tables, and the width-1 streams' ones
    equal to the plain non-null count. Truncated streams (a bit-packed
    run or an RLE value past the end, a header past the end) must raise
    in both."""
    rng = np.random.default_rng(seed)
    n_cases = n_bad = 0
    for case in range(400):
        bw = int(rng.integers(0, 25)) if case % 4 else 1
        byte_w = (bw + 7) // 8
        stream, total = bytearray(), 0
        for _ in range(int(rng.integers(1, 12))):
            if rng.random() < 0.5:
                count = int(rng.integers(0, 70))
                stream += _uvarint(count << 1)
                stream += int(rng.integers(0, 1 << max(bw, 1))).to_bytes(
                    4, "little")[:byte_w]
            else:
                groups = int(rng.integers(0, 9))
                count = 8 * groups
                stream += _uvarint((groups << 1) | 1)
                stream += rng.integers(0, 256, groups * bw,
                                       dtype=np.uint8).tobytes()
            total += count
        n_values = max(total + int(rng.integers(-12, 13)), 0)
        if case % 10 == 9:
            # malformed: more values wanted than the stream holds, and it
            # ends inside a run header or inside its last run
            n_values = total + 1 + int(rng.integers(0, 12))
            stream = stream + b"\x80" if case % 20 == 9 else stream[:-1]
        pos = int(rng.integers(0, 9))
        staged = np.zeros(pos + len(stream) + 8, np.uint8)
        staged[pos:pos + len(stream)] = np.frombuffer(bytes(stream),
                                                      np.uint8)
        end = pos + len(stream)
        plain, native = PD.HybridRuns(), PD.HybridRuns()
        errors = []
        try:
            PD.parse_hybrid(staged[pos:end].tobytes(), 0, end - pos, bw,
                            n_values, plain, pos)
        except Exception as e:  # noqa: BLE001 - compared below
            errors.append(type(e).__name__)
        try:
            ones = PD.parse_hybrid_native(staged, pos, end, bw, n_values,
                                          native)
        except Exception as e:  # noqa: BLE001 - compared below
            errors.append(type(e).__name__)
        if errors:
            check(len(errors) == 2, f"parse_hybrid case {case}: only one "
                  f"version raised ({errors})")
            n_bad += 1
            continue
        check(np.array_equal(plain.array(), native.array()),
              f"parse_hybrid case {case} (width {bw}, {n_values} values): "
              f"C++ runs {native.array().tolist()} vs plain "
              f"{plain.array().tolist()}")
        if bw == 1:
            check(ones == plain.non_null_count(0, staged),
                  f"parse_hybrid case {case}: ones {ones}")
        n_cases += 1
    check(n_bad >= 20, f"only {n_bad} malformed parse_hybrid cases")
    print(f"  parse_hybrid (host C++) equal to the plain version on "
          f"{n_cases} hand-made streams; {n_bad} malformed ones raise in "
          "both")


def check_runs(torch, E, PD, M, files, label: str, dev="cuda") -> dict:
    """Every definition-level and dictionary-index stream of ``files``
    sliced by the C++ routine and by the plain ``parse_hybrid`` (each row
    group's host phase twice): the packed run tables equal, byte for
    byte. Prints the ``.runs`` time of both (host clock, one thread)."""
    ms = {False: 0.0, True: 0.0}
    before = PD.parse_hybrid_native.launches
    groups = runs = 0
    for path in files:
        meta = M.read_footer(path)
        schema = M.schema_from_parquet(meta, path)
        for rg in range(meta.num_row_groups):
            got = {}
            for native in (False, True):
                ctx = E.ExecContext(torch.device(dev))
                got[native] = PD.read_row_group_host(
                    path, rg, schema, meta, ctx=ctx, native_runs=native)
                ms[native] += ctx.exec_ms()["ParquetScanExec.runs"]
            a, b = got[False], got[True]
            check(a.handles == b.handles and torch.equal(a.tables, b.tables),
                  f"{label} {path} row group {rg}: C++ and plain run "
                  "tables differ")
            runs += sum(len(r) for p in b.plans for r in (p.def_runs,
                                                           p.idx_runs)
                        if r is not None)
            groups += 1
    streams = PD.parse_hybrid_native.launches - before
    print(f"  run tables of the {label} files: {streams} level and index "
          f"streams ({runs} runs, {groups} row groups) equal between the "
          f"C++ routine and the plain version; .runs {ms[False]:.3f} ms "
          f"plain, {ms[True]:.3f} ms C++ (host clock, one thread)")
    return {"streams": streams, "runs": runs, "row_groups": groups,
            "plain_ms": ms[False], "native_ms": ms[True]}


def time_snappy(SN, PD, M, files) -> dict:
    """The C++ snappy on every page of the SF1 lineitem files (one call a
    column chunk, host clock, median of 3) beside its bound: the bytes it
    writes at this host's memory copy rate, and that rate measured by a
    numpy copy of 1 GiB and by reading the files from the page cache."""
    chunks = [(chunk, pages, np.empty(size, np.uint8))
              for chunk, pages, size in column_chunks(PD, M, files)]
    bytes_in = sum(len(c) for c, _, _ in chunks)
    bytes_out = sum(len(o) for _, _, o in chunks)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for chunk, pages, out in chunks:
            SN.decompress_pages(chunk, pages, out, "cuda")
        times.append((time.perf_counter() - t0) * 1e3)
    src = np.ones(1 << 30, np.uint8)
    dst = np.empty_like(src)
    copies = []
    for _ in range(3):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        copies.append(time.perf_counter() - t0)
    copy_gbs = src.nbytes / min(copies) / 1e9
    del src, dst
    total = sum(Path(p).stat().st_size for p in files)
    buf = bytearray(max(Path(p).stat().st_size for p in files))
    reads = []
    for _ in range(3):
        t0 = time.perf_counter()
        for p in files:
            with open(p, "rb", buffering=0) as f:
                f.readinto(buf)
        reads.append(time.perf_counter() - t0)
    read_gbs = total / min(reads) / 1e9
    ms = statistics.median(times)
    bound = bytes_out / (copy_gbs * 1e9) * 1e3
    print(f"  snappy (host C++) over the SF1 lineitem files: {len(chunks)} "
          f"calls, {bytes_in / 1e6:.1f} MB in, {bytes_out / 1e6:.1f} MB "
          f"out: {ms:.3f} ms ({bytes_out / ms / 1e6:.2f} GB/s out; runs "
          f"{[round(t, 3) for t in times]}); host memory copy "
          f"{copy_gbs:.2f} GB/s (numpy, 1 GiB), page-cache read "
          f"{read_gbs:.2f} GB/s; bound {bound:.3f} ms at the copy rate")
    return {"calls": len(chunks), "bytes_in": bytes_in,
            "bytes_out": bytes_out, "ms": ms, "runs_ms": times,
            "copy_gbs": copy_gbs, "page_cache_read_gbs": read_gbs,
            "bound_ms": bound}



# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lineitem-rows", type=int, default=6_001_215,
                    help="TPC-H lineitem rows (SF1 = 6,001,215)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--xbb-clicks", type=int, default=1 << 22,
                    help="clicks of the TPCxBB tables the bb_* cells "
                         "upload (the pq_bb_* cells keep bench.py's 2^17)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace two warm runs of each query and "
                         "entry stage with torch.profiler (tables in "
                         "chiprun_out/<query>_profile.txt)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available; this smoke run needs an NVIDIA GPU")
    from spark_rapids_tpu_torch import entry as ENTRY
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.data.batch import ColumnarBatch, HostBatch
    from spark_rapids_tpu_torch.exec import execs as E
    from spark_rapids_tpu_torch.ops.expression import col, lit
    from spark_rapids_tpu_torch.ops.kernels import groupby as KG
    from spark_rapids_tpu_torch.ops.kernels import rowops as KR
    from spark_rapids_tpu_torch.ops import strings_util as SU
    from spark_rapids_tpu_torch.ops.strings import Substring
    from spark_rapids_tpu_torch.ops.kernels.cuda import _build
    from spark_rapids_tpu_torch.data.column import (DeviceColumn,
                                                    bucket_byte_capacity)
    from spark_rapids_tpu_torch.ops.kernels import join as KJ
    from spark_rapids_tpu_torch.ops.kernels.cuda import hashing as HK
    from spark_rapids_tpu_torch.ops.kernels.cuda import join_probe as JP
    from spark_rapids_tpu_torch.ops.kernels.cuda import segmented as SEG
    from spark_rapids_tpu_torch.ops.kernels.cuda import sort_steps as SS
    from spark_rapids_tpu_torch.ops.kernels.cuda import strings as SG
    from spark_rapids_tpu_torch.parallel import distributed as D
    from spark_rapids_tpu_torch.parallel.mesh import make_mesh
    from spark_rapids_tpu_torch.plan import logical as L
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.shuffle import partitioning as PN
    from spark_rapids_tpu_torch.workloads import tpch
    from spark_rapids_tpu_torch.workloads import tpcxbb
    from spark_rapids_tpu_torch.io import parquet_device as PD
    from spark_rapids_tpu_torch.io import parquet_encode as PE
    from spark_rapids_tpu_torch.io import parquet_meta as M
    from spark_rapids_tpu_torch.io import snappy as SN
    from spark_rapids_tpu_torch.io import snappy_cases as SC

    ref_workers, futures = start_references(args)
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
    print(f"phase 2 {at()}: kernels vs plain versions on edge cases")
    rng = np.random.default_rng(args.seed)
    joinprobe_edge_cases(torch, JP, rng, dev)
    segmented_edge_cases(torch, SEG, rng, dev)
    sortstep_edge_cases(torch, SS, rng, dev)
    strings_edge_cases(torch, SG, rng, dev)
    gather_strings_edge_cases(torch, SG, bucket_byte_capacity, args.seed,
                              dev)
    hash_edge_cases(torch, HK, rng, dev)
    ragged_hash_edge_cases(torch, HK, T, DeviceColumn, PN, rng, dev)
    row_equal_edge_cases(torch, SG, rng, dev)
    snappy_edge_cases(SN, SC)
    parquet_runs_edge_cases(PD, args.seed)
    fixture = check_fixture_decode(PD, M, HostBatch)
    runs_check = {"fixture": check_runs(torch, E, PD, M, [str(FIXTURE)],
                                        "fixture")}

    # -- phase 3: the queries at SF1 -------------------------------------
    print(f"phase 3 {at()}: TPC-H Q3, Q1, Q4, Q6, Q22, lineitem sorted by "
          f"l_shipdate, Q1 over two hash repartitions of lineitem, Q5, "
          f"Q12, Q14, Q19, xbb_score, Q10, Q18, Q2, Q7, Q8, Q9, Q11, Q13, "
          f"Q15, Q16, Q17, Q20, Q21, the nine bench queries over SF1 "
          f"parquet (pq_q1 also with the pipeline off), the 30 TPCxBB "
          f"queries bb_q01 ... bb_q30 and bb_q02_pivot "
          f"at {args.xbb_clicks} clicks, bb_q01, bb_q05 and bb_q30 over "
          f"parquet at {BENCH_XBB_CLICKS}, the entry stage, "
          f"group_ids over two string keys, Q1, Q3, Q4 and Q6 over a "
          f"4-shard mesh on the card, distributed_sum_by_key, "
          f"lineitem_rows={args.lineitem_rows}")
    t0 = time.perf_counter()
    tables = tpch.gen_tables(args.lineitem_rows, seed=args.seed)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref3 = reference(futures, "tpch", args.lineitem_rows, args.seed, "q3")
    refs = {q: reference(futures, "tpch", args.lineitem_rows, args.seed, q)
            for q in NUMPY_REFS}
    t_ref = time.perf_counter() - t0
    session = TorchSession(device="cuda")
    t0 = time.perf_counter()
    dfs = tpch.load(session, tables)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    print(f"  tables: generated {t_gen:.1f} s, uploaded {t_load:.1f} s; "
          f"waited {t_ref:.1f} s for the numpy references (4 worker "
          f"processes, started before phase 1); rows "
          + ", ".join(f"{k}={v.num_rows}" for k, v in tables.items()))

    wrappers = Wrappers(JP, SEG, SS, SG, HK)
    queries = {
        "q3": (lambda: tpch.q3(dfs), lambda got: check_top(
            "Q3", got, ref3, ["o_orderkey", "o_orderdate"], "revenue", 10),
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
        # the rest of the bench suite's TPC-H entries, then Q10 and Q18
        "q5": (lambda: tpch.q5(dfs),
               lambda got: check_answer("q5", got, refs["q5"]),
               ("joinProbe",)),
        "q12": (lambda: tpch.q12(dfs),
                lambda got: check_answer("q12", got, refs["q12"]),
                ("joinProbe",)),
        "q14": (lambda: tpch.q14(dfs),
                lambda got: check_answer("q14", got, refs["q14"]),
                ("joinProbe",)),
        "q19": (lambda: tpch.q19(dfs),
                lambda got: check_answer("q19", got, refs["q19"]),
                ("joinProbe",)),
        "xbb_score": (lambda: tpch.xbb_score(dfs),
                      lambda got: xbb_ulps.append(
                          check_xbb_score(got, refs["xbb_score"])), ()),
        "q10": (lambda: tpch.q10(dfs),
                lambda got: check_top("q10", got, refs["q10"],
                                      ["c_custkey", "n_name"], "revenue",
                                      20), ("joinProbe",)),
        "q18": (lambda: tpch.q18(dfs),
                lambda got: check_answer("q18", got, refs["q18"]),
                ("joinProbe",)),
    }
    # the other eleven TPC-H queries; Q13's one join (a left join whose
    # build side repeats its key) settles on the exact path
    for q in REST_QUERIES:
        queries[q] = (lambda q=q: tpch.QUERIES[q](dfs), rest_check(q, refs),
                      () if q == "q13" else ("joinProbe",))
    xbb_ulps = []
    launches = {k: 0 for k in wrappers.mods}
    calls = {k: [] for k in wrappers.mods}
    summaries = {}
    for q, (build, check_fn, need) in queries.items():
        got_launches, got_calls, summaries[q], mid = run_query(
            torch, session, wrappers, q.upper(), build, check_fn, need)
        for k in launches:
            launches[k] += got_launches[k]
            calls[k] += got_calls[k]
        if q == "q22":
            q22_gathers = got_calls["strings"]
        if args.profile:
            profile_query(torch, q, build, mid)
    print(f"  XBB_SCORE max_score: at most {max(xbb_ulps)} ulp from numpy's "
          f"over {len(xbb_ulps)} runs (limit {MAX_SCORE_ULPS})")

    # The bench suite's TPC-H queries over parquet: the SF1 tables written
    # by the port's writer, every collect scanning them (the scan inside
    # every timed run).
    pq_dir = tempfile.mkdtemp(prefix="chip_smoke_parquet_")
    atexit.register(shutil.rmtree, pq_dir, True)
    written = write_sf1_parquet(torch, PE, ColumnarBatch, tables, dfs,
                                pq_dir)
    sf1_pages = check_sf1_pages(SN, PD, M, written["files"])
    pq_dfs = {name: session.read.parquet(d)
              for name, d in written["dirs"].items()}
    unordered = {"q1": ["l_returnflag", "l_linestatus"], "q5": ["n_name"],
                 "q12": ["l_shipmode"], "xbb_score": ["l_returnflag"]}

    def pq_check(q):
        def check_fn(got):
            if q in unordered:
                got = in_key_order(got, unordered[q])
            if q == "xbb_score":
                xbb_ulps.append(check_xbb_score(got, refs["xbb_score"]))
            elif q == "q3":
                check_top("Q3", got, ref3, ["o_orderkey", "o_orderdate"],
                          "revenue", 10)
            else:
                check_answer(q, got, refs[q])
        return check_fn

    pq_need = {"q3": ("joinProbe", "segmented"),
               "q4": ("joinProbe", "sortStep"), "q5": ("joinProbe",),
               "q12": ("joinProbe",), "q14": ("joinProbe",),
               "q19": ("joinProbe",)}
    pq_answers = {}
    for q in ("q1", "q3", "q4", "q5", "q6", "q12", "q14", "q19",
              "xbb_score"):
        cell = f"pq_{q}"
        build = (lambda q=q: tpch.QUERIES[q](pq_dfs))
        sn_before = SN.decompress_pages.launches
        got_launches, got_calls, summaries[cell], mid = run_query(
            torch, session, wrappers, cell.upper(), build,
            keep_answer(pq_answers, cell, pq_check(q)), pq_need.get(q, ()))
        sn_calls = SN.decompress_pages.launches - sn_before
        check(sn_calls > 0 and summaries[cell]["counters"].get(
            "ParquetScanExec.snappy_chunks", 0) > 0,
            f"{cell}: the C++ snappy did not run in the scan")
        summaries[cell]["snappy_calls"] = sn_calls
        print_scan(cell.upper(), summaries[cell])
        for k in launches:
            launches[k] += got_launches[k]
            calls[k] += got_calls[k]
        if args.profile:
            profile_query(torch, cell, build, mid)
    # pq_q1 once more with the pipeline off, and every level and index
    # stream of the SF1 files through both run slicers
    off_session = TorchSession({"spark.rapids.tpu.pipeline.enabled": False},
                               device="cuda")
    off_dfs = {name: off_session.read.parquet(d)
               for name, d in written["dirs"].items()}

    def run_off_q1():
        got = tpch.q1(off_dfs).collect()
        return got, off_session.last_query
    pipeline_off = {"pq_q1": pipeline_off_run(
        torch, "PQ_Q1", run_off_q1, pq_answers["pq_q1"], summaries["pq_q1"],
        ANSWERS["q1"][1])}
    pipeline_off["sf1_scans"] = scans_on_off(
        session, off_session, written["dirs"], ("lineitem", "orders"), "SF1")
    runs_check["sf1"] = check_runs(torch, E, PD, M, written["files"], "SF1")

    # The bench suite's TPCxBB entries, on uploaded tables and over the
    # port's parquet files.
    xbb_ctx = types.SimpleNamespace(tpcxbb=tpcxbb, KJ=KJ, JP=JP, PE=PE,
                                    ColumnarBatch=ColumnarBatch, E=E, PD=PD,
                                    M=M, off_session=off_session,
                                    pipeline_off=pipeline_off,
                                    runs_check=runs_check)
    xbb_summaries, xbb_launches, xbb_calls, left_calls = run_tpcxbb(
        torch, xbb_ctx, session, wrappers, args.xbb_clicks, args.seed,
        pq_dir, args.profile, futures)
    ref_workers.shutdown()
    summaries.update(xbb_summaries)
    for k in launches:
        launches[k] += xbb_launches[k]
        calls[k] += xbb_calls[k]

    # The engine's entry stage (filter -> aggregate on the sort path): at
    # entry()'s defaults, then at SF1's lineitem rows with entry()'s 50
    # keys and with orders' 1,500,000.
    entry_runs = {}
    for name, kwargs in (
            ("entry", {}),
            ("entry_sf1_keys50", {"n": args.lineitem_rows, "key_range": 50}),
            ("entry_sf1_keys1500000", {"n": args.lineitem_rows,
                                       "key_range": 1_500_000})):
        got_launches, got_calls, entry_runs[name] = run_entry_stage(
            torch, ENTRY, HostBatch, wrappers, name.upper(), args.profile,
            device="cuda", **kwargs)
        for k in launches:
            launches[k] += got_launches[k]
        calls["segmented"] += got_calls
    flat_gathers = check_flat_gathers(torch, SG, KR, T, DeviceColumn,
                                      q22_gathers)
    no_matrix = check_no_char_matrix(torch, HK, dfs["lineitem"]._plan.batch,
                                     col)
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
        run, gathers = group_by_string_key(
            torch, KG, T, HostBatch, wrappers, name, key_col, n_rows, values)
        group_ids_runs.append(run)
        calls["strings"] += gathers
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
                    lambda got: check_top(
                        "Q3", got, ref3, ["o_orderkey", "o_orderdate"],
                        "revenue", 10), ("segmented",)),
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
    with Capture(*wrappers.mods["hash"]) as cap:
        wrappers.reset()
        distributed = check_distributed(torch, D, mesh4, dfs, tables)
        launches["hash"] += wrappers.counts()["hash"]
        calls["hash"] += cap.calls

    # -- phase 4: kernels at the queries' shapes ---------------------------
    print(f"phase 4 {at()}: kernels at the shapes the queries gave them")
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    rows = []
    row, jp_calls = time_joinprobe(torch, JP, calls["joinProbe"],
                                   launches["joinProbe"], flush)
    rows.append(row)
    q3_joins = time_q3_joins(torch, KJ, JP, dfs, flush)
    left_joins = time_left_joins(torch, KJ, JP, left_calls, flush)
    del left_calls

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
        # The least traffic: gid read whole, x read only at the rows whose
        # gid lies in [0, capacity) (the rest, such as the sort path's dead
        # tail, need not be read), and out written whole (the identity
        # fills the groups with no rows).
        row_bytes = (x.numel() // max(x.shape[0], 1)) * x.element_size()
        live = int(((gid >= 0) & (gid < capacity)).sum().item())
        nbytes = row_bytes * live + 4 * gid.numel() + capacity * row_bytes
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        groups = int((gid[gid < capacity].max() + 1).item()) \
            if bool((gid < capacity).any()) else 0
        print(f"  segmented {op} x={tuple(x.shape)} {x.dtype} "
              f"capacity={capacity} groups={groups} live rows={live}: "
              f"kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms, "
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

    row, gather_calls = time_gather_strings(torch, SG, calls["strings"],
                                            launches["strings"], flush)
    rows.append(row)
    matrix_gather = time_matrix_gather(torch, SG, SU, calls["strings"],
                                       flush)

    row, hash_calls = time_ragged_hash(torch, HK, calls["hash"],
                                       launches["hash"], flush)
    rows.append(row)
    matrix_hash = time_matrix_hash(torch, HK, SU, dfs, rng, flush)
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

    snappy_row = time_snappy(SN, PD, M, [
        f for f in written["files"]
        if Path(f).parent.name == "lineitem"])

    # -- phase 5: results --------------------------------------------------
    print(json.dumps({"queries_sf1": {
        "lineitem_rows": args.lineitem_rows, "card": smi,
        **{q: {k: v for k, v in s.items() if k != "per_exec_ms"}
           for q, s in summaries.items()},
        "sortStep_l_shipdate": shipdate, "placement": placement,
        "matrix_hash": matrix_hash, "hash_calls": hash_calls,
        "gather_calls": gather_calls, "matrix_gather": matrix_gather,
        "flat_gathers": flat_gathers,
        "group_ids": group_ids_runs,
        "hash_partition_step": no_matrix, "joinProbe_calls": jp_calls,
        "q3_dense_joins": q3_joins, "bb_q05_left_joins": left_joins,
        "xbb_clicks": args.xbb_clicks,
        "distributed_sum_by_key": distributed,
        "q6_default_mesh_ms": default_ms, "entry_stage": entry_runs,
        "xbb_score_max_score_ulps": max(xbb_ulps),
        "pipeline_off": pipeline_off, "run_tables": runs_check,
        "parquet": {"fixture": fixture, "sf1_pages": sf1_pages,
                    "write": {k: v for k, v in written.items()
                              if k in ("bytes", "seconds")},
                    "files": len(written["files"]),
                    "snappy": snappy_row}}}))
    print(f"phase 5 {at()}: results")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
