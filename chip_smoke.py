#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spark_rapids_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--lineitem-rows N] [--xbb-clicks N]
                          [--ds-ss-rows N] [--mort-perf-rows N]
                          [--seed S] [--profile]

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
   two slicers. Then the TPC-DS cells: the port's 66 queries
   (``ds_q1`` ... ``ds_q98``: star joins, q5's three unioned channels,
   the rollups q14, q18, q22, q36, q67, q70, q77, q80 and q86 through
   Expand, ``Rank`` over the grouping id or a category, the full outer
   joins of q51 and q97, q44's and q49's global ranks, q88's eight
   cross-joined counts, INTERSECT and EXCEPT as semi and anti joins
   ``USING`` three keys in q14, q38 and q87, q47's and q57's row-number
   self joins, the year-over-year self joins of q2, q4, q11, q31 and
   q74, EXISTS and NOT EXISTS in q10, q16, q35, q69, q94 and q95, and
   the scalar thresholds of q23 and q24) over
   ``tpcds.gen_tables(2,880,404)`` (TPC-DS SF1's store_sales rows,
   ``--ds-ss-rows``) uploaded to the card, and q1, q68, q8, q58, q71,
   q53, q83 and q91 once more over the tables of ``DS_VARIANTS`` that
   give them rows (``ds_q1_tn`` ... ``ds_q91_returners``; at the tests'
   scale or this one the generator's tables give them none): every answer
   equal to its numpy implementation here (the ORDER BY's runs of equal
   keys compared as sets, floats to 1e-9 relative), its rows, warm and
   cold times, peak memory, two largest execs, shared subplans and a
   traced warm run's busy share printed; an ``ExpandExec`` in every
   rollup's run, a full join in q51's and q97's plans, a shared subplan
   (``ReusedExec``) in ``DS_REUSE``'s; ``joinProbe``, ``segmented`` and
   the ``strings`` gather launched over the cells (``sortStep`` is not
   on their path: every sort is a top-k or on several keys). Then the
   ``expr_*`` cells over the same uploaded tables: each family of the
   expression library (``CaseWhen``/``NaNvl``/``If``/``Coalesce``, the
   predicates, bitwise, ``ops/strings.py``, the string casts, the Unix
   time functions, ``ops/strings2.py``, string min/max/first/last on
   the dictionary, dense and sort group-by paths) over store_sales
   joined to customer and customer_address, with dictionary strings and
   flat strings built on the card (``CAST(ss_ticket_number AS
   STRING)`` and a concatenation) at the fact table's length, reduced to
   a few rows, each equal to its numpy reference. Then
   ``pq_ds_q5`` (BASELINE configuration 1): q5 over the ten tables it
   reads, written by the port's writer and scanned through
   ``session.read.parquet`` with the pipeline on, its answer equal to
   the same numpy reference and its scan lines printed as the ``pq_*``
   cells print theirs. Then Mortgage's ``mort_etl`` and
   ``mort_features`` over ``mortgage.gen_tables`` at 2^24 performance
   records (``--mort-perf-rows``; 699,050 loans, the generator's seed
   7), each equal to its numpy reference (``np.bincount`` per loan, the
   join, the band), its rows, the path each join takes and a traced
   run's busy share printed; ``joinProbe`` launched in
   ``mort_features``. Then the engine's entry stage
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
   every group on the shard numpy murmur3 pmod 4 names.
   Every query runs on the port's default path: whole-stage fusion, its
   region captured as one CUDA graph at its second run and replayed
   after (``exec/fusion.py``). The **fusion phase** (after the TPC-H
   queries, its TPC-DS, TPCxBB and Mortgage cells beside theirs) runs
   each of its cells with the region's programs dropped first: the SF1
   entry stage (1,500,000 keys, sort path), q6, q14, q19 and ds_q96 must
   go eager, capture, replay, trial (a streaming sample), replay, trial,
   then the path the plan chose from those samples, every answer equal
   to numpy and to the streaming path (``fusion.enabled=false``;
   integers and strings bit for bit); q3 and ds_q3 (top-k roots) only
   download their boundary; q1, bb_q30 and expr_complex print what they
   do. Each prints a ``FUSION`` line: the chosen path, warm ms of the
   replays, the trials and the streaming session, the host's time by
   step of a replay (signature, boundaries, key, region, head), the
   host's launch calls and the device's busy share of a traced warm run
   of each path (the fused one replaying), graphs captured and replayed,
   capture ms, pool bytes, the launches a replay re-issues (``joinProbe``
   in q14, q19 and ds_q96; ``segmented`` in the entry stage),
   boundaries, head bytes, guess misses and refusals with their sync
   site. ``FUSION_COALESCE`` holds expr_complex's 64
   exchanged blocks against 8 coalesced batches, ``FUSION_PIPELINE``
   times sort and mort_features with the pipeline on and off on both
   paths, ``FUSION_UPLOAD_CACHE`` uploads a frozen orders table twice
   (a hit) and drains it, and ``FUSION_PHASE`` sums the phase, every
   refusal of the run by sync site, the paths the run's plans chose and
   the keys dropped because their resident table died;
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
import collections
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


def generate_edge_case(torch, E, GC, TorchSession, SG) -> None:
    """``posexplode_outer`` over a table with a flat string column and a
    struct with a flat string field, across tile boundaries (the lane
    bound lowered so 3,000 rows take three tiles), on the card against
    the same plan on the CPU, bit for bit; the parents must move with the
    ragged ``strings`` gather."""
    bound = E.GenerateExec.TILE_LANES
    E.GenerateExec.TILE_LANES = GC.TILE_LANES
    try:
        table = GC.generate_table()
        before = SG.gather_strings.launches
        got = GC.generate_query(TorchSession(device="cuda"), table).collect()
        launched = SG.gather_strings.launches - before
        want = GC.generate_query(TorchSession(device="cpu"), table).collect()
    finally:
        E.GenerateExec.TILE_LANES = bound
    check(launched > 0, "the explode edge case launched no strings gather")
    check(got.schema.names == want.schema.names,
          f"explode edge case: columns {got.schema.names}")
    for name in got.schema.names:
        same = np.array_equal(got.validity[name], want.validity[name]) and \
            [repr(v) for v in got.columns[name].tolist()] == \
            [repr(v) for v in want.columns[name].tolist()]
        check(same, f"explode edge case: {name} differs between the card "
              "and the CPU")
    print(f"  explode edge case: {got.num_rows} rows from {GC.ROWS} across "
          f"tiles of {GC.TILE_LANES} lanes, card equal to the CPU bit for "
          f"bit; {launched} strings gathers")


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


# --------------------------------------------------------------------------
# TPC-DS numpy references: each query's answer as ``{column: list}``
# (``None`` for a null), every row of it in the query's ORDER BY (Spark's
# null order), before its LIMIT; ``check_ds`` cuts and compares.
# --------------------------------------------------------------------------


# --------------------------------------------------------------------------
# Mortgage (``workloads/mortgage.py``): numpy references of ``etl`` and
# ``ml_features``
# --------------------------------------------------------------------------

#: The generator's own seed and the default scale of the mort_* cells
#: (2^24 performance records, about 24 a loan: 699,050 loans).
MORT_SEED = 7
MORT_PERF_ROWS = 1 << 24
#: ``_score_band``'s bands, in the sorted order of their names.
MORT_BANDS = np.array(["EXCELLENT", "FAIR", "GOOD", "SUBPRIME"])
MORT_QUERIES = ("etl", "features")


def _mort_loans(tables) -> dict:
    """Per loan with a cleaned performance record (the inner join): its
    acquisition attributes, ``np.bincount`` aggregates of its records and
    its score band's index into ``MORT_BANDS``."""
    a, p = tables["acquisition"], tables["performance"]
    n = a.num_rows
    upb = p.values("current_upb")
    keep = upb > 0
    loan = p.values("loan_id")[keep]
    status = p.values("delinq_status")[keep]
    n_records = np.bincount(loan, minlength=n)
    has = n_records > 0
    seller = a.columns[a.schema.index_of("seller")].codes
    score = a.values("credit_score")
    band = np.select([score < 580, score < 670, score < 740], [3, 1, 2], 0)
    out = {
        "loan_id": a.values("loan_id"), "seller": seller, "band": band,
        "n_records": n_records,
        "months_delinq": np.bincount(loan, weights=status >= 1,
                                     minlength=n).astype(np.int64),
        "months_serious": np.bincount(loan, weights=status >= 3,
                                      minlength=n).astype(np.int64),
        "recent_upb": np.bincount(loan, weights=np.where(
            p.values("month")[keep] >= 36, upb[keep], 0.0), minlength=n),
        "orig_rate": a.values("orig_rate"), "orig_upb": a.values("orig_upb"),
        "credit_score": score}
    return {k: v[has] for k, v in out.items()}


def numpy_mort_etl(tables) -> dict:
    """``mortgage.etl``: per (seller, score band) in key order, the loan
    count, the delinquent months, the risk UPB (the loans with a
    seriously delinquent month) and the average rate."""
    lo = _mort_loans(tables)
    key = lo["seller"] * len(MORT_BANDS) + lo["band"]
    size = len(mortgage_sellers()) * len(MORT_BANDS)
    cnt = np.bincount(key, minlength=size)
    risk = np.where(lo["months_serious"] > 0, lo["orig_upb"], 0)
    g = np.flatnonzero(cnt)
    return {"seller": mortgage_sellers()[g // len(MORT_BANDS)].astype(str),
            "score_band": MORT_BANDS[g % len(MORT_BANDS)],
            "n_loans": cnt[g].astype(np.int64),
            "total_delinq_months": np.bincount(
                key, weights=lo["months_delinq"], minlength=size)[g]
            .astype(np.int64),
            "risk_upb": np.bincount(key, weights=risk.astype(np.float64),
                                    minlength=size)[g],
            "avg_rate": np.bincount(key, weights=lo["orig_rate"],
                                    minlength=size)[g] / cnt[g]}


def numpy_mort_features(tables) -> dict:
    """``mortgage.ml_features``: one row per loan in ``loan_id`` order."""
    lo = _mort_loans(tables)
    return {"loan_id": lo["loan_id"],
            "seller": mortgage_sellers()[lo["seller"]].astype(str),
            "score_band": MORT_BANDS[lo["band"]],
            "n_records": lo["n_records"].astype(np.int64),
            "months_delinq": lo["months_delinq"],
            "recent_upb": lo["recent_upb"], "orig_rate": lo["orig_rate"],
            "orig_upb": lo["orig_upb"], "credit_score": lo["credit_score"],
            "serious_flag": (lo["months_serious"] > 0).astype(np.int32)}


def mortgage_sellers() -> np.ndarray:
    from spark_rapids_tpu_torch.workloads import mortgage
    return mortgage._SELLERS


MORT_REFS = {"etl": numpy_mort_etl, "features": numpy_mort_features}
#: Float columns held to ``REV_RTOL`` (sums in atomic order on the card).
MORT_FLOATS = {"etl": ("risk_upb", "avg_rate"), "features": ("recent_upb",)}


# --------------------------------------------------------------------------
# The expression cells (``expr_*``): each family of the scalar expression
# library over the SF1 TPC-DS tables, at store_sales' length. Every cell
# joins store_sales to customer (and customer_address), so the dictionary
# strings c_first_name, c_last_name, c_birth_country and ca_zip come at
# the fact table's length, and builds the flat strings tix =
# CAST(ss_ticket_number AS STRING) and tag = tix || '-' ||
# CAST(ss_sold_date_sk AS STRING) on the card; then it reduces to a few
# rows, each against its numpy reference.
# --------------------------------------------------------------------------

EXPR_CELLS = ("conditional", "predicates", "bitwise", "strings", "casts",
              "datetime", "strings2", "string_aggs_dict",
              "string_aggs_dense", "string_aggs_sort")
#: cell -> the columns its rows are ordered by (none: one row)
EXPR_KEYS = {"conditional": ["band"], "bitwise": ["k"], "strings": ["len"],
             "strings2": ["country"], "string_aggs_dict": ["country"],
             "string_aggs_dense": ["store"], "string_aggs_sort": ["head"]}
#: cell -> float columns, held to ``REV_RTOL``
EXPR_FLOATS = {"conditional": ("nv",), "casts": ("half",)}
#: 10,000 days before the epoch, the first day of the cells' dates
EXPR_DAY0 = -10_000


def expr_queries(M, dfs) -> dict:
    """``{cell: build()}``: the port's query of each expression cell.
    ``M`` holds the port's modules (``C``, ``P``, ``B``, ``S``, ``S2``,
    ``CA``, ``D``, ``A``, ``AR``, ``MA``, ``T``) and ``col``, ``lit``."""
    C, P, B, S, S2, CA, D, A, AR, T = (M.C, M.P, M.B, M.S, M.S2, M.CA, M.D,
                                       M.A, M.AR, M.T)
    col, lit = M.col, M.lit

    def agg(fn, e, name):
        return A.AggregateExpression(fn(e), name)

    def count_true(e, name):
        return agg(A.Sum, CA.Cast(e, T.LONG), name)

    def base():
        ss = dfs["store_sales"].join(dfs["customer"], on=P.EqualTo(
            col("ss_customer_sk"), col("c_customer_sk"))).join(
            dfs["customer_address"], on=P.EqualTo(col("c_current_addr_sk"),
                                                  col("ca_address_sk")))
        tix = CA.Cast(col("ss_ticket_number"), T.STRING)
        return ss.with_column("tix", tix).with_column(
            "tag", S.ConcatStrings(col("tix"), lit("-"), CA.Cast(
                col("ss_sold_date_sk"), T.STRING)))

    promo = P.IsNotNull(col("ss_promo_sk"))
    nan_root = M.MA.Sqrt(AR.Subtract(col("ss_net_paid"), lit(500.0)))
    day = D.DateAdd(lit(EXPR_DAY0, T.DATE),
                    CA.Cast(col("ss_sold_date_sk"), T.INT))
    dtext = CA.Cast(day, T.STRING)
    stamp = S.ConcatStrings(dtext, lit(" 12:34:56"))

    def conditional():
        band = C.CaseWhen([
            (P.LessThan(col("ss_net_paid"), lit(100.0)), lit("low")),
            (P.LessThan(col("ss_net_paid"), lit(1000.0)), lit("mid")),
            (P.LessThan(col("ss_net_paid"), lit(5000.0)), lit("high"))],
            lit("top"))
        cw = C.CaseWhen([
            (P.GreaterThan(col("ss_quantity"), lit(90)), col("tag")),
            (P.LessThan(col("ss_quantity"), lit(10)), col("c_first_name"))])
        return base().with_column("band", band).group_by(col("band")).agg(
            A.AggregateExpression(A.Count(), "n"),
            agg(A.Sum, C.NaNvl(nan_root, lit(-1.0)), "nv"),
            agg(A.Sum, S.Length(C.If(P.GreaterThan(col("ss_quantity"),
                                                   lit(50)), col("tix"),
                                     col("c_last_name"))), "fl"),
            agg(A.Count, cw, "cw"),
            agg(A.Sum, S.Length(C.Coalesce(cw, lit("none"))), "co"))

    def predicates():
        return base().group_by().agg(
            A.AggregateExpression(A.Count(), "n"),
            count_true(P.EqualNullSafe(col("ss_promo_sk"), lit(5)), "a"),
            count_true(P.EqualNullSafe(
                C.CaseWhen([(promo, col("ss_quantity"))]),
                C.CaseWhen([(P.GreaterThan(col("ss_quantity"), lit(50)),
                             col("ss_quantity"))])), "b"),
            count_true(P.EqualNullSafe(
                S.ConcatStrings(col("c_first_name"), lit("")),
                C.CaseWhen([(P.GreaterThan(col("ss_quantity"), lit(20)),
                             col("c_first_name"))])), "c"),
            count_true(P.IsNaN(nan_root), "d"),
            count_true(P.AtLeastNNonNulls(
                2, col("ss_promo_sk"),
                C.CaseWhen([(P.GreaterThan(col("ss_quantity"), lit(50)),
                             col("tix"))]),
                C.CaseWhen([(P.LessThan(col("ss_quantity"), lit(30)),
                             col("c_last_name"))])), "e"))

    def bitwise():
        t = col("ss_ticket_number")
        return base().with_column("k", B.BitwiseAnd(t, lit(7))).group_by(
            col("k")).agg(
            agg(A.Sum, B.BitwiseXor(t, col("ss_customer_sk")), "s1"),
            agg(A.Sum, B.ShiftLeft(col("ss_item_sk"), lit(40)), "s2"),
            agg(A.Sum, B.ShiftRightUnsigned(AR.UnaryMinus(t), lit(33)),
                "s3"),
            agg(A.Sum, B.ShiftRight(col("ss_customer_sk"), lit(64)), "s4"),
            agg(A.Sum, B.ShiftLeft(CA.Cast(t, T.INT), lit(29)), "s5"),
            agg(A.Sum, B.BitwiseNot(B.BitwiseOr(col("ss_item_sk"), lit(1))),
                "s6"))

    def strings():
        return base().with_column("len", S.Length(col("tag"))).group_by(
            col("len")).agg(
            A.AggregateExpression(A.Count(), "n"),
            agg(A.Sum, S.Length(S.Upper(S.ConcatStrings(
                lit("x"), col("c_last_name"), col("tag")))), "up"),
            agg(A.Max, S.Lower(col("c_last_name")), "lo"),
            agg(A.Sum, S.Length(S.StringTrim(S.ConcatStrings(
                lit("  "), col("tag"), lit(" ")))), "tr"),
            agg(A.Min, S.StringTrimLeft(S.ConcatStrings(
                lit(" "), col("c_first_name"))), "lt"),
            agg(A.Max, S.StringTrimRight(S.ConcatStrings(
                col("tag"), lit("  "))), "rt"),
            agg(A.Max, S.Upper(S.StringTrim(S.ConcatStrings(
                lit(" "), col("c_first_name"), lit(" ")))), "uf"))

    def casts():
        return base().group_by().agg(
            agg(A.Sum, CA.Cast(col("tix"), T.LONG), "tl"),
            agg(A.Sum, CA.Cast(S.ConcatStrings(lit(" "), col("tix"),
                                               lit("\t")), T.INT), "ti"),
            agg(A.Count, CA.Cast(col("tag"), T.LONG), "bad"),
            agg(A.Sum, CA.Cast(CA.Cast(dtext, T.DATE), T.LONG), "days"),
            agg(A.Max, CA.Cast(CA.Cast(dtext, T.TIMESTAMP), T.STRING), "ts"),
            count_true(CA.Cast(CA.Cast(P.GreaterThan(
                col("ss_quantity"), lit(50)), T.STRING), T.BOOLEAN), "yes"),
            agg(A.Sum, CA.Cast(S.ConcatStrings(col("tix"), lit(".5")),
                               T.DOUBLE), "half"),
            agg(A.Sum, CA.Cast(col("ca_zip"), T.INT), "zip"),
            agg(A.Max, CA.Cast(CA.Cast(col("ca_zip"), T.SHORT), T.STRING),
                "zs"))

    def datetime():
        secs = D.UnixTimestamp(stamp)
        dict_stamp = C.CaseWhen(
            [(P.LessThan(col("ss_quantity"), lit(50)),
              lit("2001-02-03 04:05:06"))], lit("1969-12-31 23:59:59"))
        return base().group_by().agg(
            agg(A.Sum, secs, "secs"),
            agg(A.Sum, D.UnixTimestamp(day), "day_secs"),
            agg(A.Sum, D.UnixTimestamp(dict_stamp), "dict_secs"),
            agg(A.Max, D.FromUnixTime(secs), "mx"),
            agg(A.Min, D.FromUnixTime(secs, "dd.MM.yyyy"), "mn"),
            agg(A.Sum, D.UnixTimestamp(D.FromUnixTime(secs, "yyyy/MM/dd"),
                                       "yyyy/MM/dd"), "round"))

    def strings2():
        return base().group_by(col("c_birth_country").alias("country")).agg(
            A.AggregateExpression(A.Count(), "n"),
            agg(A.Sum, S.Length(S2.StringReplace(col("tag"), "1", "<>")),
                "rep"),
            agg(A.Max, S2.StringReplace(col("c_last_name"), "a", "4"),
                "rep_d"),
            agg(A.Max, S2.RegExpReplace(col("c_first_name"), "e", "3"), "rx"),
            agg(A.Min, S2.LPad(col("tix"), 8, "0"), "lp"),
            agg(A.Max, S2.RPad(col("c_first_name"), 12, "*"), "rp"),
            agg(A.Sum, S2.StringLocate("-", col("tag")), "loc"),
            agg(A.Sum, S2.StringLocate("a", col("c_last_name"), 2), "loc_d"),
            agg(A.Max, S2.InitCap(S.Lower(S.ConcatStrings(
                col("c_first_name"), lit(" "), col("c_last_name")))), "ic"),
            agg(A.Max, S2.SubstringIndex(col("tag"), "-", -1), "si"),
            agg(A.Min, S2.Reverse(col("tix")), "rv"),
            agg(A.Sum, S.Length(S2.StringRepeat(col("c_first_name"), 3)),
                "rr"))

    def string_aggs(key):
        def build():
            frame = base()
            if key == "head":
                frame = frame.with_column("head", M.S.Substring(
                    col("tag"), lit(1), lit(2)))
            elif key == "store":
                frame = frame.with_column("store", col("ss_store_sk"))
            else:
                frame = frame.with_column("country", col("c_birth_country"))
            return frame.group_by(col(key)).agg(
                agg(A.Min, C.CaseWhen([(promo, col("c_last_name"))]), "mn"),
                agg(A.Max, col("tag"), "mx"),
                agg(A.First, C.CaseWhen([(promo, col("tix"))]), "fi"),
                agg(A.Last, col("c_first_name"), "la"))
        return build

    return {"conditional": conditional, "predicates": predicates,
            "bitwise": bitwise, "strings": strings, "casts": casts,
            "datetime": datetime, "strings2": strings2,
            "string_aggs_dict": string_aggs("country"),
            "string_aggs_dense": string_aggs("store"),
            "string_aggs_sort": string_aggs("head")}


def _expr_base(tables) -> dict:
    """The numpy side of the cells' base frame, at store_sales' length."""
    ss, cu, ca = (tables[n] for n in ("store_sales", "customer",
                                      "customer_address"))
    cust = ss.columns["ss_customer_sk"]
    addr = cu.columns["c_current_addr_sk"][cust]
    tix = ss.columns["ss_ticket_number"].astype(str)
    date_sk = ss.columns["ss_sold_date_sk"]
    return {"cust": cust, "promo": ss.validity["ss_promo_sk"],
            "promo_sk": ss.columns["ss_promo_sk"],
            "qty": ss.columns["ss_quantity"], "paid": ss.columns["ss_net_paid"],
            "ticket": ss.columns["ss_ticket_number"],
            "item": ss.columns["ss_item_sk"], "store": ss.columns["ss_store_sk"],
            "date_sk": date_sk, "tix": tix,
            "tag": np.char.add(np.char.add(tix, "-"), date_sk.astype(str)),
            "first": cu.columns["c_first_name"][cust].astype(str),
            "last": cu.columns["c_last_name"][cust].astype(str),
            "country": cu.columns["c_birth_country"][cust].astype(str),
            "zip": ca.columns["ca_zip"][addr].astype(str)}


def _slen(a) -> np.ndarray:
    """Byte lengths of a numpy string array (UTF-8)."""
    return np.char.str_len(np.char.encode(a, "utf-8")).astype(np.int64)


def _by_group(keys, values, reduce):
    """``{key: reduce(values of the key's rows)}`` over sorted keys."""
    order = np.argsort(keys, kind="stable")
    k, v = keys[order], values[order]
    bounds = np.flatnonzero(np.r_[True, k[1:] != k[:-1], True])
    return {k[a]: reduce(v[a:b]) for a, b in zip(bounds[:-1], bounds[1:])}


def _str_extreme(values, pick):
    """The byte-order max or min of a numpy string array."""
    raw = np.sort(np.char.encode(values, "utf-8"))
    return (raw[-1] if pick == "max" else raw[0]).decode("utf-8")


def numpy_expr_conditional(tables) -> dict:
    b = _expr_base(tables)
    paid, qty = b["paid"], b["qty"]
    band = np.select([paid < 100.0, paid < 1000.0, paid < 5000.0],
                     ["low", "mid", "high"], "top")
    with np.errstate(invalid="ignore"):
        nv = np.where(paid >= 500.0, np.sqrt(paid - 500.0), -1.0)
    fl = np.where(qty > 50, _slen(b["tix"]), _slen(b["last"]))
    cw_valid = (qty > 90) | (qty < 10)
    cw_len = np.where(qty > 90, _slen(b["tag"]),
                      np.where(qty < 10, _slen(b["first"]), 4))
    keys = np.unique(band)
    idx = np.searchsorted(keys, band)
    size = len(keys)
    return {"band": keys, "n": np.bincount(idx, minlength=size),
            "nv": np.bincount(idx, weights=nv, minlength=size),
            "fl": np.bincount(idx, weights=fl, minlength=size)
            .astype(np.int64),
            "cw": np.bincount(idx, weights=cw_valid, minlength=size)
            .astype(np.int64),
            "co": np.bincount(idx, weights=cw_len, minlength=size)
            .astype(np.int64)}


def numpy_expr_predicates(tables) -> dict:
    b = _expr_base(tables)
    qty, promo = b["qty"], b["promo"]
    with np.errstate(invalid="ignore"):
        nan = np.isnan(np.sqrt(b["paid"] - 500.0))
    big = qty > 50
    return {"n": np.array([len(qty)]),
            "a": np.array([np.sum(promo & (b["promo_sk"] == 5))]),
            "b": np.array([np.sum((promo & big) | (~promo & ~big))]),
            "c": np.array([np.sum(qty > 20)]),
            "d": np.array([np.sum(nan)]),
            "e": np.array([np.sum(promo.astype(int) + big + (qty < 30)
                                  >= 2)])}


def numpy_expr_bitwise(tables) -> dict:
    b = _expr_base(tables)
    t, cust, item = b["ticket"], b["cust"], b["item"]
    k = t & 7
    with np.errstate(over="ignore"):
        lanes = {
            "s1": t ^ cust, "s2": item << 40,
            "s3": ((-t).view(np.uint64) >> np.uint64(33)).view(np.int64),
            "s4": cust,
            "s5": ((t << 29) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
            .astype(np.int64),
            "s6": ~(item | 1)}
    keys = np.unique(k)
    out = {"k": keys}
    for name, v in lanes.items():
        sums = np.zeros(len(keys), dtype=np.int64)
        np.add.at(sums, np.searchsorted(keys, k), v)
        out[name] = sums
    return out


def numpy_expr_strings(tables) -> dict:
    b = _expr_base(tables)
    tag, last, first = b["tag"], b["last"], b["first"]
    ln = _slen(tag)
    keys = np.unique(ln)
    idx = np.searchsorted(keys, ln)
    size = len(keys)

    def per(values, pick):
        got = _by_group(idx, values, lambda v: _str_extreme(v, pick))
        return np.array([got[i] for i in range(size)])
    upper_len = 1 + _slen(last) + ln
    return {"len": keys.astype(np.int32),
            "n": np.bincount(idx, minlength=size),
            "up": np.bincount(idx, weights=upper_len, minlength=size)
            .astype(np.int64),
            "lo": per(np.char.lower(last), "max"),
            "tr": np.bincount(idx, weights=ln, minlength=size)
            .astype(np.int64),
            "lt": per(first, "min"), "rt": per(tag, "max"),
            "uf": per(np.char.upper(first), "max")}


def _days_text(days) -> np.ndarray:
    return np.datetime_as_string(days.astype("datetime64[D]"), unit="D")


def numpy_expr_casts(tables) -> dict:
    b = _expr_base(tables)
    t = b["ticket"]
    days = EXPR_DAY0 + b["date_sk"]
    zips = b["zip"].astype(np.int64)
    return {"tl": np.array([t.sum()]), "ti": np.array([t.sum()]),
            "bad": np.array([0]), "days": np.array([days.sum()]),
            "ts": np.array([_days_text(np.array([days.max()]))[0]
                            + " 00:00:00"]),
            "yes": np.array([np.sum(b["qty"] > 50)]),
            "half": np.array([np.sum(t + 0.5)]),
            "zip": np.array([zips.sum()]),
            "zs": np.array([str(zips[zips <= 32767].max())])}


def numpy_expr_datetime(tables) -> dict:
    b = _expr_base(tables)
    days = EXPR_DAY0 + b["date_sk"]
    secs = days * 86400 + 12 * 3600 + 34 * 60 + 56
    latest = np.datetime_as_string(np.datetime64(int(secs.max()), "s"),
                                   unit="s").replace("T", " ")
    # dd.MM.yyyy orders by day of month first: over every day's text
    dd = [f"{t[8:10]}.{t[5:7]}.{t[:4]}" for t in _days_text(np.unique(days))]
    return {"secs": np.array([secs.sum()]),
            "day_secs": np.array([(days * 86400).sum()]),
            "dict_secs": np.array([np.where(b["qty"] < 50, 981173106,
                                            -1).sum()]),
            "mx": np.array([latest]), "mn": np.array([min(dd)]),
            "round": np.array([(days * 86400).sum()])}


def numpy_expr_strings2(tables) -> dict:
    b = _expr_base(tables)
    country = b["country"]
    keys = np.unique(country)
    idx = np.searchsorted(keys, country)
    size = len(keys)
    tag, tix, first, last = b["tag"], b["tix"], b["first"], b["last"]

    def per(values, pick):
        got = _by_group(idx, values, lambda v: _str_extreme(v, pick))
        return np.array([got[i] for i in range(size)])

    def sums(values):
        return np.bincount(idx, weights=values, minlength=size).astype(
            np.int64)
    loc_d = np.char.find(np.char.encode(last, "utf-8"), b"a", 1)
    initcap = np.array([" ".join(w[:1].upper() + w[1:] for w in s.split(" "))
                        for s in np.char.lower(np.char.add(
                            np.char.add(first, " "), last)).tolist()])
    return {"country": keys, "n": np.bincount(idx, minlength=size),
            "rep": sums(_slen(np.char.replace(tag, "1", "<>"))),
            "rep_d": per(np.char.replace(last, "a", "4"), "max"),
            "rx": per(np.char.replace(first, "e", "3"), "max"),
            "lp": per(np.char.rjust(tix, 8, "0"), "min"),
            "rp": per(np.array([s[:12] if len(s.encode()) >= 12
                                else s + "*" * (12 - len(s.encode()))
                                for s in first.tolist()]), "max"),
            "loc": sums(np.char.find(tag, "-") + 1),
            "loc_d": sums(np.where(loc_d >= 0, loc_d + 1, 0)),
            "ic": per(initcap, "max"),
            "si": per(b["date_sk"].astype(str), "max"),
            "rv": per(np.array([s[::-1] for s in tix.tolist()]), "min"),
            "rr": sums(3 * _slen(first))}


def _numpy_string_aggs(tables, key: str) -> dict:
    b = _expr_base(tables)
    if key == "head":
        k = np.array([s[:2] for s in b["tag"].tolist()])
    elif key == "store":
        k = b["store"]
    else:
        k = b["country"]
    keys = np.unique(k)
    idx = np.searchsorted(keys, k)
    rows = np.arange(len(idx))
    promo = b["promo"]
    mn = _by_group(idx[promo], b["last"][promo],
                   lambda v: _str_extreme(v, "min"))
    mx = _by_group(idx, b["tag"], lambda v: _str_extreme(v, "max"))
    fi = _by_group(idx[promo], rows[promo], lambda v: v.min())
    la = _by_group(idx, rows, lambda v: v.max())
    size = len(keys)
    return {key: keys, "mn": np.array([mn[i] for i in range(size)]),
            "mx": np.array([mx[i] for i in range(size)]),
            "fi": b["tix"][[fi[i] for i in range(size)]],
            "la": b["first"][[la[i] for i in range(size)]]}


EXPR_REFS = {
    "conditional": numpy_expr_conditional,
    "predicates": numpy_expr_predicates,
    "bitwise": numpy_expr_bitwise, "strings": numpy_expr_strings,
    "casts": numpy_expr_casts, "datetime": numpy_expr_datetime,
    "strings2": numpy_expr_strings2,
    "string_aggs_dict": lambda t: _numpy_string_aggs(t, "country"),
    "string_aggs_dense": lambda t: _numpy_string_aggs(t, "store"),
    "string_aggs_sort": lambda t: _numpy_string_aggs(t, "head"),
}


# --------------------------------------------------------------------------
# The complex-type, Generate, nondeterministic and input-file cells over
# the same tables: ``expr_complex`` (a struct and an array through a
# filter, a union, the item join and both repartitions, reduced per
# store; 1,000 top-k rows of the raw columns), ``expr_explode`` (the
# price array posexploded beside the flat ``tag``; an uploaded
# per-customer array joined and explode_outer-ed), ``expr_nondeterministic``
# (rand, monotonic ids and partition ids after an 8-way hash
# repartition; an order-sensitive rand filter) and ``pq_input_file``
# (input_file_name() and the block family over pq_ds_q5's store_sales
# files).
# --------------------------------------------------------------------------

#: The cells' numpy references that run in the reference workers (each as
#: an ``("ds", n, seed, "expr_<name>")`` task).
COMPLEX_REFS = ("complex", "complex_topk", "explode", "explode_outer",
                "nondeterministic", "nondet_filter", "input_file")
#: The references that take ``--seed`` beside the tables.
SEEDED_REFS = ("explode_outer",)
PRICES = ("ss_wholesale_cost", "ss_list_price", "ss_sales_price",
          "ss_coupon_amt")
#: Rows the ``expr_complex`` top-k keeps.
COMPLEX_TOPK = 1000
#: The per-customer arrays: up to 8 elements in [0, 64).
CUST_ARRAY_LEN = 8
CUST_ARRAY_VALUES = 64
_U64 = (1 << 64) - 1


def customer_arrays(n_cust: int, seed: int):
    """The per-customer arrays of ``expr_explode``'s part (b), from
    ``seed``: (lengths, elements ``[n, 8]``, element valid, array valid),
    0-8 elements, about 5 % null arrays, 5 % empty ones and 5 % null
    elements."""
    rng = np.random.default_rng(seed + 17)
    lens = rng.integers(0, CUST_ARRAY_LEN + 1, n_cust)
    lens[rng.random(n_cust) < 0.05] = 0
    valid = rng.random(n_cust) >= 0.05
    elems = rng.integers(0, CUST_ARRAY_VALUES, (n_cust, CUST_ARRAY_LEN))
    ev = (rng.random((n_cust, CUST_ARRAY_LEN)) >= 0.05) \
        & (np.arange(CUST_ARRAY_LEN)[None, :] < lens[:, None]) \
        & valid[:, None]
    return np.where(valid, lens, 0), elems, ev, valid


def customer_array_table(HostBatch, T, n_cust: int, seed: int):
    """:func:`customer_arrays` as a table ``(ca_c, ca_arr)`` to upload."""
    lens, elems, ev, valid = customer_arrays(n_cust, seed)
    arrays = np.empty(n_cust, dtype=object)
    el = elems.tolist()
    evl = ev.tolist()
    for i in range(n_cust):
        arrays[i] = [v if ok else None for v, ok in
                     zip(el[i][:lens[i]], evl[i][:lens[i]])] \
            if valid[i] else None
    schema = T.Schema([T.StructField("ca_c", T.LONG, False),
                       T.StructField("ca_arr", T.ArrayType(T.LONG))])
    return HostBatch.from_numpy({"ca_c": np.arange(n_cust, dtype=np.int64),
                                 "ca_arr": arrays}, schema)


def np_rand(seed: int, pid: int, n: int) -> np.ndarray:
    """The port's (and the reference's) ``rand(seed)`` of rows ``[0, n)``
    of partition ``pid``: splitmix64 of the row index XOR the salt, top
    53 bits over 2^53."""
    salt = (seed * 0x9E3779B97F4A7C15 + pid * 0xD1B54A32D192ED03) & _U64
    with np.errstate(over="ignore"):
        x = np.arange(n, dtype=np.uint64) ^ np.uint64(salt)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return (x >> np.uint64(11)).astype(np.float64) / float(1 << 53)


def complex_queries(M, dfs, cust_arrays) -> dict:
    """``{name: build()}``: the port's queries of the complex cells over
    the uploaded TPC-DS tables ``dfs`` and the uploaded per-customer
    arrays. ``M`` holds the port's modules (as for
    :func:`expr_queries`, plus ``CPX``, ``ND`` and ``SortOrder``)."""
    A, P, S, CA, C, T, CPX, ND = (M.A, M.P, M.S, M.CA, M.C, M.T, M.CPX,
                                  M.ND)
    col, lit = M.col, M.lit

    def agg(fn, e, name):
        return A.AggregateExpression(fn(e), name)

    def count_true(e, name):
        return agg(A.Sum, CA.Cast(e, T.LONG), name)

    def tagged(frame):
        tix = CA.Cast(col("ss_ticket_number"), T.STRING)
        return frame.with_column("tag", S.ConcatStrings(
            tix, lit("-"), CA.Cast(col("ss_sold_date_sk"), T.STRING)))

    def prices():
        return CPX.array(*[col(c) for c in PRICES])

    def complex_frame():
        base = tagged(dfs["store_sales"].join(dfs["customer"], on=P.EqualTo(
            col("ss_customer_sk"), col("c_customer_sk"))).join(
            dfs["customer_address"], on=P.EqualTo(col("c_current_addr_sk"),
                                                  col("ca_address_sk"))))
        return base.select(
            col("ss_store_sk").alias("store"),
            col("ss_ticket_number").alias("ticket"),
            col("ss_item_sk").alias("item"),
            CPX.struct(item=col("ss_item_sk"), city=col("ca_city"),
                       tag=col("tag")).alias("st"),
            prices().alias("arr"))

    def complex_():
        x = complex_frame()
        odd = P.EqualTo(M.AR.Remainder(col("ticket"), lit(2)), lit(1))
        halves = x.where(odd).union(x.where(P.Not(odd)))
        joined = halves.join(dfs["item"].select(col("i_item_sk"),
                                                col("i_brand_id")),
                             on=P.EqualTo(col("item"), col("i_item_sk")))
        moved = joined.repartition(8, col("arr")).select(
            col("store"), col("st"), col("arr"), col("i_brand_id"))
        moved = moved.repartition(8, col("st"))
        return moved.group_by(col("store")).agg(
            A.AggregateExpression(A.Count(), "n"),
            agg(A.Sum, CPX.GetArrayItem(col("arr"), 1), "e1"),
            count_true(CPX.ArrayContains(col("arr"), lit(0.0)), "zero"),
            agg(A.Count, CPX.GetArrayItem(col("arr"), 7), "e7"),
            agg(A.Sum, CPX.Size(col("arr")), "size"),
            agg(A.Sum, CPX.GetStructField(col("st"), "item"), "items"),
            agg(A.Count, CPX.GetStructField(col("st"), "city"), "cities"),
            agg(A.Max, CPX.GetStructField(col("st"), "tag"), "tag"),
            agg(A.Sum, col("i_brand_id"), "brands"))

    def complex_topk():
        return complex_frame().sort(
            M.SortOrder(col("ticket"), False),
            M.SortOrder(col("item"))).limit(COMPLEX_TOPK)

    def explode():
        frame = tagged(dfs["store_sales"]).select(
            col("ss_store_sk").alias("store"), col("tag"),
            prices().alias("arr"))
        return frame.explode(col("arr"), name="x", pos=True).group_by(
            col("pos"), col("store")).agg(
            agg(A.Sum, col("x"), "s"), agg(A.Count, col("x"), "n"),
            agg(A.Max, col("tag"), "tag"))

    def explode_outer():
        joined = dfs["store_sales"].join(cust_arrays, on=P.EqualTo(
            col("ss_customer_sk"), col("ca_c")))
        return joined.explode(col("ca_arr"), name="e", outer=True).group_by(
            C.Coalesce(col("e"), lit(-1, T.LONG)).alias("e")).agg(
            A.AggregateExpression(A.Count(), "n"),
            agg(A.Sum, col("ss_quantity"), "qty"))

    def nondeterministic():
        frame = dfs["store_sales"].repartition(8, col("ss_ticket_number"))
        frame = frame.with_column("r", ND.Rand(42)).with_column(
            "m", ND.MonotonicallyIncreasingID()).with_column(
            "p", ND.SparkPartitionID())
        return frame.group_by(col("p")).agg(
            A.AggregateExpression(A.Count(), "n"),
            agg(A.Min, col("m"), "lo"), agg(A.Max, col("m"), "hi"),
            agg(A.Sum, col("r"), "r"),
            count_true(P.LessThan(col("r"), lit(0.1)), "few"))

    def nondet_filter():
        frame = dfs["store_sales"].with_column("r", ND.Rand(7))
        return frame.where(P.LessThan(col("r"), lit(0.01))).group_by().agg(
            A.AggregateExpression(A.Count(), "n"),
            agg(A.Sum, col("ss_net_profit"), "profit"))

    return {"complex": complex_, "complex_topk": complex_topk,
            "explode": explode, "explode_outer": explode_outer,
            "nondeterministic": nondeterministic,
            "nondet_filter": nondet_filter}


def input_file_query(M, scan):
    """``pq_input_file``: the three input-file columns over a store_sales
    scan, grouped by file: rows and ``sum(ss_net_profit)``."""
    A, ND, col = M.A, M.ND, M.col
    return scan.select(ND.InputFileName().alias("f"),
                       ND.InputFileBlockStart().alias("start"),
                       ND.InputFileBlockLength().alias("length"),
                       col("ss_net_profit")).group_by(
        col("f"), col("start"), col("length")).agg(
        A.AggregateExpression(A.Count(), "n"),
        A.AggregateExpression(A.Sum(col("ss_net_profit")), "profit"))


def _tags(ss) -> np.ndarray:
    tix = ss.columns["ss_ticket_number"].astype(str)
    return np.char.add(np.char.add(tix, "-"),
                       ss.columns["ss_sold_date_sk"].astype(str))


def _by_key_max(keys, values) -> dict:
    """``{key: byte-order max of values}``."""
    order = np.lexsort((np.char.encode(values, "utf-8"), keys))
    k, v = keys[order], values[order]
    last = np.flatnonzero(np.r_[k[1:] != k[:-1], True])
    return dict(zip(k[last].tolist(), v[last].tolist()))


def numpy_expr_complex(tables) -> dict:
    ss, it = tables["store_sales"], tables["item"]
    store = ss.columns["ss_store_sk"]
    item = ss.columns["ss_item_sk"]
    keys = np.unique(store)
    idx = np.searchsorted(keys, store)
    m = len(keys)
    p = np.stack([ss.columns[c] for c in PRICES], axis=1)
    tag = _by_key_max(store, _tags(ss))
    return {"store": keys,
            "n": np.bincount(idx, minlength=m),
            "e1": np.bincount(idx, p[:, 1], minlength=m),
            "zero": np.bincount(idx, (p == 0.0).any(1), minlength=m)
            .astype(np.int64),
            "e7": np.zeros(m, np.int64),
            "size": 4 * np.bincount(idx, minlength=m),
            "items": np.bincount(idx, item, minlength=m).astype(np.int64),
            "cities": np.bincount(idx, minlength=m),
            "tag": np.array([tag[k] for k in keys.tolist()]),
            "brands": np.bincount(idx, it.columns["i_brand_id"][item],
                                  minlength=m).astype(np.int64)}


def numpy_expr_complex_topk(tables) -> dict:
    """The top-k rows of the raw columns, as python values."""
    ss, cu, ca = (tables[n] for n in ("store_sales", "customer",
                                      "customer_address"))
    ticket = ss.columns["ss_ticket_number"]
    item = ss.columns["ss_item_sk"]
    order = np.lexsort((item, -ticket))[:COMPLEX_TOPK]
    addr = cu.columns["c_current_addr_sk"][ss.columns["ss_customer_sk"]]
    city = ca.columns["ca_city"][addr]
    tag = _tags(ss)
    p = np.stack([ss.columns[c] for c in PRICES], axis=1)
    return {"store": ss.columns["ss_store_sk"][order].tolist(),
            "ticket": ticket[order].tolist(), "item": item[order].tolist(),
            "st": [{"item": int(item[r]), "city": str(city[r]),
                    "tag": str(tag[r])} for r in order],
            "arr": p[order].tolist()}


def numpy_expr_explode(tables) -> dict:
    ss = tables["store_sales"]
    store = ss.columns["ss_store_sk"]
    keys = np.unique(store)
    idx = np.searchsorted(keys, store)
    m = len(keys)
    tag = _by_key_max(store, _tags(ss))
    out = {"pos": [], "store": [], "s": [], "n": [], "tag": []}
    for pos, c in enumerate(PRICES):
        out["pos"] += [pos] * m
        out["store"] += keys.tolist()
        out["s"] += np.bincount(idx, ss.columns[c], minlength=m).tolist()
        out["n"] += np.bincount(idx, minlength=m).tolist()
        out["tag"] += [tag[k] for k in keys.tolist()]
    return {k: np.array(v) for k, v in out.items()}


def numpy_expr_explode_outer(tables, seed: int) -> dict:
    ss, cu = tables["store_sales"], tables["customer"]
    n_cust = cu.num_rows
    lens, elems, ev, valid = customer_arrays(n_cust, seed)
    cust = ss.columns["ss_customer_sk"]
    rows = np.bincount(cust, minlength=n_cust)
    qty = np.bincount(cust, ss.columns["ss_quantity"], minlength=n_cust)
    # a null element, and a null or empty array's one outer row, count
    # under -1
    value = np.where(ev, elems, -1)
    in_len = np.arange(CUST_ARRAY_LEN)[None, :] < lens[:, None]
    outer = lens == 0
    keys = np.concatenate([value[in_len], np.full(int(outer.sum()), -1)])
    w_rows = np.concatenate([np.broadcast_to(rows[:, None], value.shape)[
        in_len], rows[outer]])
    w_qty = np.concatenate([np.broadcast_to(qty[:, None], value.shape)[
        in_len], qty[outer]])
    uniq = np.unique(keys)
    at = np.searchsorted(uniq, keys)
    n = np.bincount(at, w_rows, minlength=len(uniq)).astype(np.int64)
    q = np.bincount(at, w_qty, minlength=len(uniq))
    keep = n > 0
    return {"e": uniq[keep], "n": n[keep],
            "qty": np.round(q[keep]).astype(np.int64)}


def _ss_partitions(tables, n_parts: int) -> np.ndarray:
    """Each store_sales row's partition under ``repartition(n_parts,
    ss_ticket_number)``: Spark's murmur3, seed 42, pmod n."""
    t = tables["store_sales"].columns["ss_ticket_number"]
    return np_pmod(np_hash_longs(t, np.full(len(t), SPARK_SEED, np.uint32)),
                   n_parts)


def numpy_expr_nondeterministic(tables) -> dict:
    part = _ss_partitions(tables, 8)
    out = {"p": [], "n": [], "lo": [], "hi": [], "r": [], "few": []}
    for p in range(8):
        n = int((part == p).sum())
        if not n:
            continue
        r = np_rand(42, p, n)
        out["p"].append(p)
        out["n"].append(n)
        out["lo"].append(p << 33)
        out["hi"].append((p << 33) + n - 1)
        out["r"].append(float(r.sum()))
        out["few"].append(int((r < 0.1).sum()))
    return {k: np.array(v) for k, v in out.items()}


def numpy_expr_nondet_filter(tables) -> dict:
    ss = tables["store_sales"]
    keep = np_rand(7, 0, ss.num_rows) < 0.01
    return {"n": np.array([int(keep.sum())]),
            "profit": np.array([ss.columns["ss_net_profit"][keep].sum()])}


def numpy_expr_input_file(tables) -> dict:
    """Rows and ``sum(ss_net_profit)`` of each store_sales file the
    writer makes (``PQ_ROWS_PER_FILE`` rows a file, in order)."""
    profit = tables["store_sales"].columns["ss_net_profit"]
    starts = range(0, len(profit), PQ_ROWS_PER_FILE)
    return {"n": np.array([len(profit[a:a + PQ_ROWS_PER_FILE])
                           for a in starts]),
            "profit": np.array([profit[a:a + PQ_ROWS_PER_FILE].sum()
                                for a in starts])}


EXPR_REFS.update({
    "complex": numpy_expr_complex, "complex_topk": numpy_expr_complex_topk,
    "explode": numpy_expr_explode, "explode_outer": numpy_expr_explode_outer,
    "nondeterministic": numpy_expr_nondeterministic,
    "nondet_filter": numpy_expr_nondet_filter,
    "input_file": numpy_expr_input_file})


def _ds_rows(cols: dict, keys) -> dict:
    """The columns as lists (``None`` for a null), rows sorted by
    ``keys`` (``(name, ascending)``, the first the most significant)
    with Spark's null order: first when ascending, last when
    descending."""
    lists = {k: (v.tolist() if isinstance(v, np.ndarray) else list(v))
             for k, v in cols.items()}
    idx = list(range(len(next(iter(lists.values())))))
    for name, asc in reversed(keys):
        v = lists[name]
        idx.sort(key=lambda i: (0, 0) if v[i] is None else (1, v[i]),
                 reverse=not asc)
    return {k: [v[i] for i in idx] for k, v in lists.items()}


def _groups(keys, *values):
    """``_group_sums`` with a row count last."""
    n = len(keys[0])
    return _group_sums(keys, *values, np.ones(n, np.int64))


def _ds_dims(tables):
    return {t: tables[t].columns for t in tables}


def _between(x, lo, hi):
    return (x >= lo) & (x <= hi)


def numpy_ds_q3(tables):
    c = _ds_dims(tables)
    ss, d, it = c["store_sales"], c["date_dim"], c["item"]
    dk, ik = ss["ss_sold_date_sk"], ss["ss_item_sk"]
    m = (d["d_moy"][dk] == 11) & _between(it["i_manufact_id"][ik], 20, 45)
    (yr, bid, br), (s,) = _group_sums(
        [d["d_year"][dk][m], it["i_brand_id"][ik][m], it["i_brand"][ik][m]],
        ss["ss_ext_sales_price"][m])
    return _ds_rows({"d_year": yr, "i_brand_id": bid, "i_brand": br,
                     "sum_agg": s},
                    [("d_year", True), ("sum_agg", False),
                     ("i_brand_id", True)])


def _q5_channel(fact, ret, dim_ids, channel):
    """One channel of q5: sales and returns in days 400-413 by the
    dimension's id."""
    fk, fd, fs, fp = fact
    rk, rd, ra, rl = ret
    mf = _between(fd, 400, 413)
    mr = _between(rd, 400, 413)
    ids = np.concatenate([dim_ids[fk[mf]], dim_ids[rk[mr]]])
    zf, zr = np.zeros(mf.sum()), np.zeros(mr.sum())
    sales = np.concatenate([fs[mf], zr])
    returns = np.concatenate([zf, ra[mr]])
    profit = np.concatenate([fp[mf], -rl[mr]])
    (u,), (s, r, p) = _group_sums([ids], sales, returns, profit)
    return {"channel": [channel] * len(u), "id": u.tolist(),
            "sales": s.tolist(), "returns_": r.tolist(),
            "profit": p.tolist()}


def numpy_ds_q5(tables):
    c = _ds_dims(tables)
    ss, sr = c["store_sales"], c["store_returns"]
    cs, cr = c["catalog_sales"], c["catalog_returns"]
    ws, wr = c["web_sales"], c["web_returns"]
    parts = [
        _q5_channel((ss["ss_store_sk"], ss["ss_sold_date_sk"],
                     ss["ss_ext_sales_price"], ss["ss_net_profit"]),
                    (sr["sr_store_sk"], sr["sr_returned_date_sk"],
                     sr["sr_return_amt"], sr["sr_net_loss"]),
                    c["store"]["s_store_id"], "store channel"),
        _q5_channel((cs["cs_catalog_page_sk"], cs["cs_sold_date_sk"],
                     cs["cs_ext_sales_price"], cs["cs_net_profit"]),
                    (cr["cr_catalog_page_sk"], cr["cr_returned_date_sk"],
                     cr["cr_return_amount"], cr["cr_net_loss"]),
                    c["catalog_page"]["cp_catalog_page_id"],
                    "catalog channel"),
        _q5_channel((ws["ws_web_site_sk"], ws["ws_sold_date_sk"],
                     ws["ws_ext_sales_price"], ws["ws_net_profit"]),
                    (wr["wr_web_site_sk"], wr["wr_returned_date_sk"],
                     wr["wr_return_amt"], wr["wr_net_loss"]),
                    c["web_site"]["web_site_id"], "web channel")]
    cols = {k: sum((p[k] for p in parts), []) for k in parts[0]}
    return _ds_rows(cols, [("channel", True), ("id", True)])


def numpy_ds_q6(tables):
    c = _ds_dims(tables)
    ss, d, it = c["store_sales"], c["date_dim"], c["item"]
    cat = it["i_category_id"]
    (cats,), (tot, cnt) = _groups([cat], it["i_current_price"])
    item_ok = it["i_current_price"] > 1.2 * _at(cats, tot / cnt, cat)
    m = _between(d["d_month_seq"][ss["ss_sold_date_sk"]], 12, 18) \
        & item_ok[ss["ss_item_sk"]]
    addr = c["customer"]["c_current_addr_sk"][ss["ss_customer_sk"][m]]
    st, n = np.unique(c["customer_address"]["ca_state"][addr],
                      return_counts=True)
    keep = n >= 3
    return _ds_rows({"ca_state": st[keep], "cnt": n[keep].astype(np.int64)},
                    [("cnt", True), ("ca_state", True)])


def _demo_avgs(fact, prefix, m, keys, names):
    """Averages of quantity, list price, coupon and sales price over the
    rows ``m`` by ``keys`` (q7, q26, q27)."""
    (*ks,), (q, lp, cp, sp, n) = _groups(
        [k[m] for k in keys], fact[prefix + "quantity"][m].astype(np.int64),
        fact[prefix + "list_price"][m], fact[prefix + "coupon_amt"][m],
        fact[prefix + "sales_price"][m])
    out = dict(zip(names, ks))
    out.update(agg1=q / n, agg2=lp / n, agg3=cp / n, agg4=sp / n)
    return out


def _cd_ok(cd, gender, marital, edu):
    return (cd["cd_gender"] == gender) & (cd["cd_marital_status"] == marital) \
        & (cd["cd_education_status"] == edu)


def numpy_ds_q7(tables):
    c = _ds_dims(tables)
    ss, d, it, p = c["store_sales"], c["date_dim"], c["item"], c["promotion"]
    cd_ok = _cd_ok(c["customer_demographics"], "F", "W", "Primary")
    promo_ok = (p["p_channel_email"] == "N") | (p["p_channel_event"] == "N")
    pk = ss["ss_promo_sk"]
    pv = tables["store_sales"].validity["ss_promo_sk"]
    m = cd_ok[ss["ss_cdemo_sk"]] \
        & (d["d_year"][ss["ss_sold_date_sk"]] == 1998) \
        & pv & promo_ok[np.where(pv, pk, 0)]
    out = _demo_avgs(ss, "ss_", m, [it["i_item_id"][ss["ss_item_sk"]]],
                     ["i_item_id"])
    return _ds_rows(out, [("i_item_id", True)])


def _q13_q48_rows(c, year, cd_terms, ca_terms):
    ss, d = c["store_sales"], c["date_dim"]
    cd, ca = c["customer_demographics"], c["customer_address"]
    ck, ak = ss["ss_cdemo_sk"], ss["ss_addr_sk"]
    ms, es = cd["cd_marital_status"][ck], cd["cd_education_status"][ck]
    price, profit = ss["ss_sales_price"], ss["ss_net_profit"]
    state = ca["ca_state"][ak]
    cd_ok = np.zeros(len(ck), bool)
    for mar, edu, lo, hi in cd_terms:
        cd_ok |= (ms == mar) & (es == edu) & _between(price, lo, hi)
    ca_ok = np.zeros(len(ck), bool)
    for states, lo, hi in ca_terms:
        ca_ok |= np.isin(state, states) & _between(profit, lo, hi)
    return (d["d_year"][ss["ss_sold_date_sk"]] == year) & cd_ok & ca_ok


_CA_TERMS = [(["CA", "GA", "TX"], 0.0, 2000.0),
             (["AL", "KY", "MN"], 150.0, 3000.0),
             (["NC", "OH", "VA"], 50.0, 25000.0)]


def numpy_ds_q13(tables):
    c = _ds_dims(tables)
    ss = c["store_sales"]
    m = _q13_q48_rows(c, 2001, [("M", "College", 10.0, 60.0),
                                ("S", "Primary", 20.0, 80.0),
                                ("W", "2 yr Degree", 30.0, 100.0)],
                      _CA_TERMS)
    n = int(m.sum())
    cost = ss["ss_ext_wholesale_cost"][m]

    def avg(v):
        return [float(v.sum()) / n if n else None]
    return {"avg_qty": avg(ss["ss_quantity"][m]),
            "avg_sales": avg(ss["ss_ext_sales_price"][m]),
            "avg_cost": avg(cost),
            "sum_cost": [float(cost.sum()) if n else None]}


def numpy_ds_q15(tables):
    c = _ds_dims(tables)
    cs, d, ca = c["catalog_sales"], c["date_dim"], c["customer_address"]
    addr = c["customer"]["c_current_addr_sk"][cs["cs_bill_customer_sk"]]
    zp, st = ca["ca_zip"][addr], ca["ca_state"][addr]
    dk = cs["cs_sold_date_sk"]
    m = (d["d_qoy"][dk] == 2) & (d["d_year"][dk] == 2000) & (
        np.isin(np.array([z[:2] for z in zp]), ["85", "86", "88"])
        | np.isin(st, ["CA", "WA", "GA"]) | (cs["cs_sales_price"] > 500.0))
    (z,), (s,) = _group_sums([zp[m]], cs["cs_sales_price"][m])
    return _ds_rows({"ca_zip": z, "sum_sales": s}, [("ca_zip", True)])


def _rollup(keys, names, values, finish, gid_name=None):
    """Rows of a rollup over ``keys``: for each prefix of them (all down
    to none) the groups of the present keys, the absent ones ``None``;
    ``finish(sums)`` maps each group's sums of ``values`` to output
    columns. With ``gid_name``, Spark's grouping id as a column."""
    out = {nm: [] for nm in names + ([gid_name] if gid_name else [])}
    k = len(keys)
    for present in range(k, -1, -1):
        if present:
            ks, sums = _group_sums(list(keys[:present]), *values)
            n_g = len(ks[0])
        else:
            ks, sums = [], [np.array([v.sum()]) for v in values]
            n_g = 1 if len(values[0]) else 0
        for i, nm in enumerate(names[:k]):
            out[nm] += ks[i].tolist() if i < present else [None] * n_g
        if gid_name:
            out[gid_name] += [(1 << (k - present)) - 1] * n_g
        for nm, v in finish(sums).items():
            out[nm] += np.asarray(v).tolist()
    return out


def numpy_ds_q18(tables):
    c = _ds_dims(tables)
    cs, d, it = c["catalog_sales"], c["date_dim"], c["item"]
    cu, ca = c["customer"], c["customer_address"]
    cd_ok = ((c["customer_demographics"]["cd_gender"] == "F")
             & (c["customer_demographics"]["cd_education_status"]
                == "College"))
    cust = cs["cs_bill_customer_sk"]
    m = cd_ok[cs["cs_bill_cdemo_sk"]] \
        & np.isin(cu["c_birth_month"][cust], [1, 3, 7, 11]) \
        & (d["d_year"][cs["cs_sold_date_sk"]] == 1998)
    addr = cu["c_current_addr_sk"][cust[m]]
    keys = [it["i_item_id"][cs["cs_item_sk"][m]], ca["ca_country"][addr],
            ca["ca_state"][addr], ca["ca_county"][addr]]
    names = ["i_item_id", "ca_country", "ca_state", "ca_county",
             "agg1", "agg2", "agg3", "agg4"]
    vals = [cs["cs_quantity"][m].astype(np.int64), cs["cs_list_price"][m],
            cs["cs_coupon_amt"][m], cs["cs_sales_price"][m],
            np.ones(int(m.sum()), np.int64)]

    def finish(s):
        return {"agg1": s[0] / s[4], "agg2": s[1] / s[4],
                "agg3": s[2] / s[4], "agg4": s[3] / s[4]}
    return _ds_rows(_rollup(keys, names, vals, finish),
                    [("ca_country", True), ("ca_state", True),
                     ("ca_county", True), ("i_item_id", True)])


def numpy_ds_q19(tables):
    c = _ds_dims(tables)
    ss, d, it = c["store_sales"], c["date_dim"], c["item"]
    dk, ik = ss["ss_sold_date_sk"], ss["ss_item_sk"]
    addr = c["customer"]["c_current_addr_sk"][ss["ss_customer_sk"]]
    m = (d["d_moy"][dk] == 11) & (d["d_year"][dk] == 1999) \
        & _between(it["i_manager_id"][ik], 1, 30) \
        & (np.array([z[:5] for z in c["customer_address"]["ca_zip"]])[addr]
           != np.array([z[:5] for z in c["store"]["s_zip"]])[
               ss["ss_store_sk"]])
    (bid, br, mf), (s,) = _group_sums(
        [it["i_brand_id"][ik][m], it["i_brand"][ik][m],
         it["i_manufact_id"][ik][m]], ss["ss_ext_sales_price"][m])
    return _ds_rows({"i_brand_id": bid, "i_brand": br, "i_manufact_id": mf,
                     "ext_price": s},
                    [("ext_price", False), ("i_brand_id", True),
                     ("i_manufact_id", True)])


def _sale_return_rebuy(c, d1, d2, d3):
    """q25 and q29's chain: (store sale rows, store return rows, catalog
    sale rows) of every match, each leg's date in its set."""
    ss, sr, cs = c["store_sales"], c["store_returns"], c["catalog_sales"]
    s_rows = np.flatnonzero(d1[ss["ss_sold_date_sk"]])
    r_rows = np.flatnonzero(d2[sr["sr_returned_date_sk"]])
    c_rows = np.flatnonzero(d3[cs["cs_sold_date_sk"]])
    li, ri = _eq_join(
        [ss[k][s_rows] for k in ("ss_customer_sk", "ss_item_sk",
                                 "ss_ticket_number")],
        [sr[k][r_rows] for k in ("sr_customer_sk", "sr_item_sk",
                                 "sr_ticket_number")])
    s_rows, r_rows = s_rows[li], r_rows[ri]
    li, ci = _eq_join([sr["sr_customer_sk"][r_rows], sr["sr_item_sk"][r_rows]],
                      [cs["cs_bill_customer_sk"][c_rows],
                       cs["cs_item_sk"][c_rows]])
    return s_rows[li], r_rows[li], c_rows[ci]


def _chain_sums(c, rows, values, names):
    ss, st, it = c["store_sales"], c["store"], c["item"]
    s_rows = rows[0]
    ik, sk = ss["ss_item_sk"][s_rows], ss["ss_store_sk"][s_rows]
    (iid, isk, sid, sname), sums = _group_sums(
        [it["i_item_id"][ik], ik, st["s_store_id"][sk],
         st["s_store_name"][sk]],
        *[c[t][col][rows[leg]] for t, col, leg in values])
    out = {"i_item_id": iid, "i_item_sk": isk, "s_store_id": sid,
           "s_store_name": sname}
    out.update(zip(names, sums))
    return _ds_rows(out, [("i_item_id", True), ("i_item_sk", True),
                          ("s_store_id", True), ("s_store_name", True)])


def numpy_ds_q25(tables):
    c = _ds_dims(tables)
    d = c["date_dim"]
    y2000 = d["d_year"] == 2000
    rows = _sale_return_rebuy(c, y2000 & (d["d_moy"] == 4),
                              y2000 & _between(d["d_moy"], 4, 10),
                              y2000 & _between(d["d_moy"], 4, 10))
    return _chain_sums(c, rows, [("store_sales", "ss_net_profit", 0),
                                 ("store_returns", "sr_net_loss", 1),
                                 ("catalog_sales", "cs_net_profit", 2)],
                       ["store_sales_profit", "store_returns_loss",
                        "catalog_sales_profit"])


def numpy_ds_q26(tables):
    c = _ds_dims(tables)
    cs, d, it, p = c["catalog_sales"], c["date_dim"], c["item"], \
        c["promotion"]
    cd_ok = _cd_ok(c["customer_demographics"], "M", "S", "College")
    promo_ok = (p["p_channel_email"] == "N") | (p["p_channel_event"] == "N")
    m = cd_ok[cs["cs_bill_cdemo_sk"]] \
        & (d["d_year"][cs["cs_sold_date_sk"]] == 2000) \
        & promo_ok[cs["cs_promo_sk"]]
    out = _demo_avgs(cs, "cs_", m, [it["i_item_id"][cs["cs_item_sk"]]],
                     ["i_item_id"])
    return _ds_rows(out, [("i_item_id", True)])


def numpy_ds_q27(tables):
    c = _ds_dims(tables)
    ss, d, it, st = c["store_sales"], c["date_dim"], c["item"], c["store"]
    cd_ok = _cd_ok(c["customer_demographics"], "F", "D", "Secondary")
    state = st["s_state"][ss["ss_store_sk"]]
    m = cd_ok[ss["ss_cdemo_sk"]] \
        & (d["d_year"][ss["ss_sold_date_sk"]] == 1999) \
        & np.isin(state, ["CA", "TX", "OH", "WA"])
    out = _demo_avgs(ss, "ss_", m, [it["i_item_id"][ss["ss_item_sk"]], state],
                     ["i_item_id", "s_state"])
    return _ds_rows(out, [("i_item_id", True), ("s_state", True)])


def numpy_ds_q29(tables):
    c = _ds_dims(tables)
    d = c["date_dim"]
    y1999 = d["d_year"] == 1999
    rows = _sale_return_rebuy(c, y1999 & (d["d_moy"] == 9),
                              y1999 & _between(d["d_moy"], 9, 12),
                              np.isin(d["d_year"], [1999, 2000, 2001]))
    return _chain_sums(c, rows, [("store_sales", "ss_quantity", 0),
                                 ("store_returns", "sr_return_quantity", 1),
                                 ("catalog_sales", "cs_quantity", 2)],
                       ["store_sales_quantity", "store_returns_quantity",
                        "catalog_sales_quantity"])


def numpy_ds_q34(tables):
    c = _ds_dims(tables)
    ss, d, st, hd = c["store_sales"], c["date_dim"], c["store"], \
        c["household_demographics"]
    dom = d["d_dom"]
    d_ok = (_between(dom, 1, 3) | _between(dom, 25, 28)) \
        & np.isin(d["d_year"], [1999, 2000, 2001])
    hd_ok = np.isin(hd["hd_buy_potential"], [">10000", "Unknown"]) \
        & (hd["hd_vehicle_count"] > 0)
    m = d_ok[ss["ss_sold_date_sk"]] & hd_ok[ss["ss_hdemo_sk"]] \
        & np.isin(st["s_state"][ss["ss_store_sk"]], ["CA", "TX", "OH", "WA"])
    (tk, cust), (n,) = _group_sums(
        [ss["ss_ticket_number"][m], ss["ss_customer_sk"][m]],
        np.ones(int(m.sum()), np.int64))
    keep = _between(n, 1, 20)
    cu = c["customer"]
    cust = cust[keep]
    return _ds_rows({"c_last_name": cu["c_last_name"][cust],
                     "c_first_name": cu["c_first_name"][cust],
                     "ss_ticket_number": tk[keep], "cnt": n[keep]},
                    [("c_last_name", True), ("c_first_name", True),
                     ("cnt", False), ("ss_ticket_number", True)])


def numpy_ds_q42(tables):
    c = _ds_dims(tables)
    ss, d, it = c["store_sales"], c["date_dim"], c["item"]
    dk, ik = ss["ss_sold_date_sk"], ss["ss_item_sk"]
    m = (d["d_moy"][dk] == 11) & (d["d_year"][dk] == 2000)
    (yr, cid, cat), (s,) = _group_sums(
        [d["d_year"][dk][m], it["i_category_id"][ik][m],
         it["i_category"][ik][m]], ss["ss_ext_sales_price"][m])
    return _ds_rows({"d_year": yr, "i_category_id": cid, "i_category": cat,
                     "total_sales": s},
                    [("total_sales", False), ("d_year", True),
                     ("i_category_id", True), ("i_category", True)])


def _city_tickets(c, m, values, names, out_names, keys):
    """q46 and q68: per (ticket, customer, bought city) sums over the
    rows ``m``, joined to the customer and their current address, kept
    where the current city differs from the bought one."""
    ss, ca, cu = c["store_sales"], c["customer_address"], c["customer"]
    bought = ca["ca_city"][ss["ss_addr_sk"][m]]
    (tk, cust, bc), sums = _group_sums(
        [ss["ss_ticket_number"][m], ss["ss_customer_sk"][m], bought],
        *[ss[v][m] for v in values])
    city = ca["ca_city"][cu["c_current_addr_sk"][cust]]
    keep = city != bc
    out = {"c_last_name": cu["c_last_name"][cust][keep],
           "c_first_name": cu["c_first_name"][cust][keep],
           "ca_city": city[keep], "bought_city": bc[keep],
           "ss_ticket_number": tk[keep]}
    out.update({nm: s[keep] for nm, s in zip(names, sums)})
    return _ds_rows({k: out[k] for k in out_names}, keys)


def numpy_ds_q46(tables):
    c = _ds_dims(tables)
    ss, d, st, hd = c["store_sales"], c["date_dim"], c["store"], \
        c["household_demographics"]
    hd_ok = (hd["hd_dep_count"] == 4) | (hd["hd_vehicle_count"] == 3)
    d_ok = np.isin(d["d_day_name"], ["Saturday", "Sunday"]) \
        & np.isin(d["d_year"], [1999, 2000, 2001])
    m = d_ok[ss["ss_sold_date_sk"]] & hd_ok[ss["ss_hdemo_sk"]] \
        & np.isin(st["s_city"][ss["ss_store_sk"]], ["Fairview", "Midway"])
    return _city_tickets(
        c, m, ["ss_coupon_amt", "ss_net_profit"], ["amt", "profit"],
        ["c_last_name", "c_first_name", "ca_city", "bought_city",
         "ss_ticket_number", "amt", "profit"],
        [("c_last_name", True), ("c_first_name", True), ("ca_city", True),
         ("bought_city", True), ("ss_ticket_number", True)])


def numpy_ds_q48(tables):
    c = _ds_dims(tables)
    m = _q13_q48_rows(c, 1999, [("M", "4 yr Degree", 10.0, 60.0),
                                ("D", "Secondary", 20.0, 80.0),
                                ("S", "College", 30.0, 100.0)], _CA_TERMS)
    q = c["store_sales"]["ss_quantity"][m]
    return {"total_qty": [int(q.sum()) if len(q) else None]}


def _brand_month(c, moy, year, item_ok=None):
    ss, d, it = c["store_sales"], c["date_dim"], c["item"]
    dk, ik = ss["ss_sold_date_sk"], ss["ss_item_sk"]
    m = (d["d_moy"][dk] == moy) & (d["d_year"][dk] == year)
    if item_ok is not None:
        m &= item_ok[ik]
    return d["d_year"][dk][m], it["i_brand_id"][ik][m], \
        it["i_brand"][ik][m], ss["ss_ext_sales_price"][m]


def numpy_ds_q52(tables):
    c = _ds_dims(tables)
    yr, bid, br, price = _brand_month(c, 12, 1998)
    (yr, bid, br), (s,) = _group_sums([yr, bid, br], price)
    return _ds_rows({"d_year": yr, "i_brand_id": bid, "i_brand": br,
                     "ext_price": s},
                    [("d_year", True), ("ext_price", False),
                     ("i_brand_id", True)])


def numpy_ds_q55(tables):
    c = _ds_dims(tables)
    _, bid, br, price = _brand_month(
        c, 11, 1999, _between(c["item"]["i_manager_id"], 28, 35))
    (bid, br), (s,) = _group_sums([bid, br], price)
    return _ds_rows({"i_brand_id": bid, "i_brand": br, "ext_price": s},
                    [("ext_price", False), ("i_brand_id", True)])


_DAYS = ["sun", "mon", "tue", "wed", "thu", "fri", "sat"]
_DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
              "Friday", "Saturday"]


def numpy_ds_q59(tables):
    c = _ds_dims(tables)
    ss, d = c["store_sales"], c["date_dim"]
    dk = ss["ss_sold_date_sk"]
    day = d["d_day_name"][dk]
    price = ss["ss_sales_price"]
    (wk, st), sums = _group_sums(
        [d["d_week_seq"][dk], ss["ss_store_sk"]],
        *[np.where(day == nm, price, 0.0) for nm in _DAY_NAMES])
    y1 = np.flatnonzero(_between(wk, 1462, 1487))
    y2 = np.flatnonzero(_between(wk, 1514, 1539))
    li, ri = _eq_join([st[y1], wk[y1]], [st[y2], wk[y2] - 52])
    a, b = y1[li], y2[ri]
    out = {"s_store_name": c["store"]["s_store_name"][st[a]],
           "week1": wk[a]}
    for nm, s in zip(_DAYS, sums):
        den = s[b]
        out[f"r_{nm}"] = [x / y if y != 0 else None
                          for x, y in zip(s[a].tolist(), den.tolist())]
    return _ds_rows(out, [("s_store_name", True), ("week1", True)])


def numpy_ds_q61(tables):
    c = _ds_dims(tables)
    ss, d, it, st = c["store_sales"], c["date_dim"], c["item"], c["store"]
    ca, cu, p = c["customer_address"], c["customer"], c["promotion"]
    dk = ss["ss_sold_date_sk"]
    addr = cu["c_current_addr_sk"][ss["ss_customer_sk"]]
    m = (st["s_gmt_offset"][ss["ss_store_sk"]] == -5.0) \
        & (d["d_year"][dk] == 1998) & (d["d_moy"][dk] == 11) \
        & (it["i_category"][ss["ss_item_sk"]] == "Jewelry") \
        & (ca["ca_gmt_offset"][addr] == -5.0)
    promo_ok = (p["p_channel_dmail"] == "Y") | (p["p_channel_email"] == "Y") \
        | (p["p_channel_event"] == "Y")
    pv = tables["store_sales"].validity["ss_promo_sk"]
    mp = m & pv & promo_ok[np.where(pv, ss["ss_promo_sk"], 0)]
    price = ss["ss_ext_sales_price"]
    promos = float(price[mp].sum()) if mp.any() else None
    total = float(price[m].sum()) if m.any() else None
    pct = None if promos is None or total is None or total == 0 \
        else promos / total * 100.0
    return {"promotions": [promos], "total": [total], "pct": [pct]}


def numpy_ds_q65(tables):
    c = _ds_dims(tables)
    ss, d = c["store_sales"], c["date_dim"]
    m = _between(d["d_month_seq"][ss["ss_sold_date_sk"]], 24, 35)
    (st, it), (rev,) = _group_sums([ss["ss_store_sk"][m],
                                    ss["ss_item_sk"][m]],
                                   ss["ss_sales_price"][m])
    (sts,), (tot, n) = _groups([st], rev)
    ave = _at(sts, tot / n, st)
    keep = rev <= 0.1 * ave
    return _ds_rows({"s_store_name": c["store"]["s_store_name"][st[keep]],
                     "i_item_id": c["item"]["i_item_id"][it[keep]],
                     "revenue": rev[keep], "ave": ave[keep]},
                    [("s_store_name", True), ("i_item_id", True)])


def numpy_ds_q68(tables):
    c = _ds_dims(tables)
    ss, d, st, hd = c["store_sales"], c["date_dim"], c["store"], \
        c["household_demographics"]
    hd_ok = (hd["hd_dep_count"] == 2) | (hd["hd_vehicle_count"] == 1)
    d_ok = _between(d["d_dom"], 1, 2) \
        & np.isin(d["d_year"], [1998, 1999, 2000])
    m = d_ok[ss["ss_sold_date_sk"]] & hd_ok[ss["ss_hdemo_sk"]] \
        & np.isin(st["s_city"][ss["ss_store_sk"]],
                  ["Centerville", "Oak Grove"])
    return _city_tickets(
        c, m, ["ss_ext_sales_price", "ss_ext_list_price",
               "ss_ext_discount_amt"],
        ["extended_price", "list_price", "extended_tax"],
        ["c_last_name", "c_first_name", "ca_city", "bought_city",
         "ss_ticket_number", "extended_price", "extended_tax",
         "list_price"],
        [("c_last_name", True), ("ss_ticket_number", True)])


def numpy_ds_q79(tables):
    c = _ds_dims(tables)
    ss, d, st, hd = c["store_sales"], c["date_dim"], c["store"], \
        c["household_demographics"]
    hd_ok = (hd["hd_dep_count"] == 6) | (hd["hd_vehicle_count"] > 2)
    d_ok = (d["d_day_name"] == "Monday") \
        & np.isin(d["d_year"], [1998, 1999, 2000])
    m = d_ok[ss["ss_sold_date_sk"]] & hd_ok[ss["ss_hdemo_sk"]]
    (tk, cust, city), (amt, profit) = _group_sums(
        [ss["ss_ticket_number"][m], ss["ss_customer_sk"][m],
         st["s_city"][ss["ss_store_sk"][m]]],
        ss["ss_coupon_amt"][m], ss["ss_net_profit"][m])
    cu = c["customer"]
    return _ds_rows({"c_last_name": cu["c_last_name"][cust],
                     "c_first_name": cu["c_first_name"][cust],
                     "city30": np.array([s[:30] for s in city.tolist()]),
                     "ss_ticket_number": tk, "amt": amt, "profit": profit},
                    [("c_last_name", True), ("c_first_name", True),
                     ("city30", True), ("profit", True),
                     ("ss_ticket_number", True)])


def numpy_ds_q96(tables):
    c = _ds_dims(tables)
    ss, hd, tm = c["store_sales"], c["household_demographics"], \
        c["time_dim"]
    tk = ss["ss_sold_time_sk"]
    m = (hd["hd_dep_count"][ss["ss_hdemo_sk"]] == 7) \
        & (tm["t_hour"][tk] == 20) & (tm["t_minute"][tk] >= 30)
    return {"cnt": [int(m.sum())]}


def numpy_ds_q98(tables):
    c = _ds_dims(tables)
    ss, it = c["store_sales"], c["item"]
    ik = ss["ss_item_sk"]
    m = _between(ss["ss_sold_date_sk"], 760, 790) \
        & np.isin(it["i_category"][ik], ["Sports", "Books", "Home"])
    ik = ik[m]
    (iid, cat, cls, price), (rev,) = _group_sums(
        [it["i_item_id"][ik], it["i_category"][ik], it["i_class"][ik],
         it["i_current_price"][ik]], ss["ss_ext_sales_price"][m])
    (classes,), (class_rev,) = _group_sums([cls], rev)
    return _ds_rows({"i_item_id": iid, "i_category": cat, "i_class": cls,
                     "i_current_price": price, "itemrevenue": rev,
                     "revenueratio": rev * 100.0
                     / _at(classes, class_rev, cls)},
                    [("i_category", True), ("i_class", True),
                     ("i_item_id", True), ("revenueratio", True)])


def numpy_ds_q1(tables):
    c = _ds_dims(tables)
    sr, d = c["store_returns"], c["date_dim"]
    m = d["d_year"][sr["sr_returned_date_sk"]] == 2000
    (cust, st), (tot,) = _group_sums([sr["sr_customer_sk"][m],
                                      sr["sr_store_sk"][m]],
                                     sr["sr_return_amt"][m])
    (sts,), (s, n) = _groups([st], tot)
    keep = (tot > 1.2 * _at(sts, s / n, st)) \
        & (c["store"]["s_state"][st] == "TN")
    return _ds_rows({"c_customer_id":
                     c["customer"]["c_customer_id"][cust[keep]]},
                    [("c_customer_id", True)])


def numpy_ds_q22(tables):
    c = _ds_dims(tables)
    inv, d, it = c["inventory"], c["date_dim"], c["item"]
    m = _between(d["d_month_seq"][inv["inv_date_sk"]], 12, 23)
    ik = inv["inv_item_sk"][m]
    keys = [it[k][ik] for k in ("i_product_name", "i_brand", "i_class",
                                "i_category")]
    names = ["i_product_name", "i_brand", "i_class", "i_category", "qoh"]
    vals = [inv["inv_quantity_on_hand"][m].astype(np.int64),
            np.ones(int(m.sum()), np.int64)]
    return _ds_rows(_rollup(keys, names, vals,
                            lambda s: {"qoh": s[0] / s[1]}),
                    [("qoh", True), ("i_product_name", True),
                     ("i_brand", True), ("i_class", True),
                     ("i_category", True)])


def _rank_within_parent(rows, value, ascending):
    """Spark's ``rank()`` over partitions (lochierarchy, the category when
    lochierarchy is 1 else '') ordered by ``value``."""
    part = [(g, cat if g == 1 else "")
            for g, cat in zip(rows["lochierarchy"], rows["i_category"])]
    rank = [0] * len(part)
    by = {}
    for i, p in enumerate(part):
        by.setdefault(p, []).append(i)
    for idx in by.values():
        idx.sort(key=lambda i: value[i], reverse=not ascending)
        for pos, i in enumerate(idx):
            prev = idx[pos - 1] if pos else None
            rank[i] = rank[prev] if pos and value[i] == value[prev] \
                else pos + 1
    return rank


def numpy_ds_q36(tables):
    c = _ds_dims(tables)
    ss, d, it, st = c["store_sales"], c["date_dim"], c["item"], c["store"]
    ik = ss["ss_item_sk"]
    m = (d["d_year"][ss["ss_sold_date_sk"]] == 1998) \
        & np.isin(st["s_state"][ss["ss_store_sk"]], ["TN", "CA", "TX", "OH"])
    rows = _rollup([it["i_category"][ik][m], it["i_class"][ik][m]],
                   ["i_category", "i_class", "profit", "sales"],
                   [ss["ss_net_profit"][m], ss["ss_ext_sales_price"][m]],
                   lambda s: {"profit": s[0], "sales": s[1]},
                   gid_name="lochierarchy")
    margin = [p / s for p, s in zip(rows["profit"], rows["sales"])]
    out = {"gross_margin": margin, "i_category": rows["i_category"],
           "i_class": rows["i_class"], "lochierarchy": rows["lochierarchy"],
           "rank_within_parent": _rank_within_parent(rows, margin, True)}
    return _ds_rows(out, [("lochierarchy", False), ("i_category", True),
                          ("rank_within_parent", True)])


def numpy_ds_q44(tables):
    c = _ds_dims(tables)
    ss, it = c["store_sales"], c["item"]
    m = ss["ss_store_sk"] == 4
    (items,), (s, n) = _groups([ss["ss_item_sk"][m]], ss["ss_net_profit"][m])
    avg = s / n

    def ranks(desc):
        v = -avg if desc else avg
        order = np.argsort(v, kind="stable")
        sv = v[order]
        first = np.searchsorted(sv, sv, "left") + 1
        r = np.empty(len(v), np.int64)
        r[order] = first
        return r
    best, worst = ranks(True), ranks(False)
    bi, wi = np.flatnonzero(best <= 10), np.flatnonzero(worst <= 10)
    li, ri = _eq_join([best[bi]], [worst[wi]])
    name = it["i_product_name"]
    return _ds_rows({"rnk": best[bi][li],
                     "best_performing": name[items[bi][li]],
                     "worst_performing": name[items[wi][ri]]},
                    [("rnk", True)])


def _running(fact, item, date, price, d_ok):
    m = d_ok[fact[date]]
    (it, dt), (s,) = _group_sums([fact[item][m], fact[date][m]],
                                 fact[price][m])
    run = np.cumsum(s)
    start = np.r_[0, np.flatnonzero(it[1:] != it[:-1]) + 1]
    base = np.repeat(run[start] - s[start], np.diff(np.r_[start, len(s)]))
    return it, dt, run - base


def numpy_ds_q51(tables):
    c = _ds_dims(tables)
    d_ok = _between(c["date_dim"]["d_month_seq"], 12, 18)
    wi, wd, wc = _running(c["web_sales"], "ws_item_sk", "ws_sold_date_sk",
                          "ws_sales_price", d_ok)
    si, sd, sc = _running(c["store_sales"], "ss_item_sk", "ss_sold_date_sk",
                          "ss_sales_price", d_ok)
    keys = {}
    for i, dd, v in zip(wi.tolist(), wd.tolist(), wc.tolist()):
        keys[(i, dd)] = [v, 0.0]
    for i, dd, v in zip(si.tolist(), sd.tolist(), sc.tolist()):
        keys.setdefault((i, dd), [0.0, 0.0])[1] = v
    rows = [(k[0], k[1], w, s) for k, (w, s) in keys.items() if w > s]
    return _ds_rows({"item_sk": [r[0] for r in rows],
                     "d_date": [r[1] for r in rows],
                     "web_sales": [r[2] for r in rows],
                     "store_sales": [r[3] for r in rows]},
                    [("item_sk", True), ("d_date", True)])


def numpy_ds_q86(tables):
    c = _ds_dims(tables)
    ws, it = c["web_sales"], c["item"]
    m = _between(c["date_dim"]["d_month_seq"][ws["ws_sold_date_sk"]], 12, 23)
    ik = ws["ws_item_sk"][m]
    rows = _rollup([it["i_category"][ik], it["i_class"][ik]],
                   ["i_category", "i_class", "total_sum"],
                   [ws["ws_net_paid"][m]], lambda s: {"total_sum": s[0]},
                   gid_name="lochierarchy")
    out = {"i_category": rows["i_category"], "i_class": rows["i_class"],
           "lochierarchy": rows["lochierarchy"],
           "total_sum": rows["total_sum"],
           "rank_within_parent": _rank_within_parent(
               rows, rows["total_sum"], False)}
    return _ds_rows(out, [("lochierarchy", False), ("i_category", True),
                          ("rank_within_parent", True)])


def numpy_ds_q88(tables):
    c = _ds_dims(tables)
    ss, hd, tm, st = c["store_sales"], c["household_demographics"], \
        c["time_dim"], c["store"]
    tk = ss["ss_sold_time_sk"]
    m = ((hd["hd_dep_count"] == 3) | (hd["hd_vehicle_count"] == 1))[
        ss["ss_hdemo_sk"]] & (st["s_store_name"] == "able0")[
        ss["ss_store_sk"]]
    out = {}
    for i, (h, mi) in enumerate([(8, 30), (9, 0), (9, 30), (10, 0), (10, 30),
                                 (11, 0), (11, 30), (12, 0)], 1):
        slot = (tm["t_hour"][tk] == h) & _between(tm["t_minute"][tk], mi,
                                                  mi + 29)
        out[f"h{i}"] = [int((m & slot).sum())]
    return out


def numpy_ds_q97(tables):
    c = _ds_dims(tables)
    d_ok = _between(c["date_dim"]["d_month_seq"], 12, 23)

    def pairs(t, date, cust, item):
        f = c[t]
        m = d_ok[f[date]]
        return set(zip(f[cust][m].tolist(), f[item][m].tolist()))
    s = pairs("store_sales", "ss_sold_date_sk", "ss_customer_sk",
              "ss_item_sk")
    k = pairs("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk",
              "cs_item_sk")
    return {"store_only": [len(s - k)], "catalog_only": [len(k - s)],
            "store_and_catalog": [len(s & k)]}


# --------------------------------------------------------------------------
# The second 33 TPC-DS queries (q2 ... q95), each from the query's text
# alone, as the first 33 above are.
# --------------------------------------------------------------------------


def _rank_desc(part, value):
    """Spark's ``rank()`` over the partitions ``part`` (int codes),
    ordered by ``value`` descending: one more than the rows of the
    partition with a greater value."""
    order = np.lexsort((-value, part))
    p, v = part[order], value[order]
    pos = np.arange(len(order))
    new_part = np.ones(len(order), bool)
    new_part[1:] = p[1:] != p[:-1]
    new_val = new_part.copy()
    new_val[1:] |= v[1:] != v[:-1]
    part_start = np.maximum.accumulate(np.where(new_part, pos, 0))
    val_start = np.maximum.accumulate(np.where(new_val, pos, 0))
    rank = np.empty(len(order), np.int64)
    rank[order] = val_start - part_start + 1
    return rank


def _ratio(a, b):
    """Spark's ``a / b`` on doubles: null for a zero divisor."""
    return None if b == 0 else a / b


def _channels(c, cols):
    """``(fact, prefix, cust)`` of the three sales channels, store first,
    with the columns ``cols`` (suffixes after the prefix) as arrays."""
    out = []
    for t, p, cust in (("store_sales", "ss", "ss_customer_sk"),
                       ("catalog_sales", "cs", "cs_bill_customer_sk"),
                       ("web_sales", "ws", "ws_bill_customer_sk")):
        f = c[t]
        out.append((f, p, f[cust], [f[f"{p}_{k}"] for k in cols]))
    return out


def _name_date_sets(c):
    """q38 and q87: each channel's distinct (last name, first name, date)
    of its customers' purchases in months 12-23, as ids shared by the
    three channels (store, catalog, web)."""
    d, cu = c["date_dim"], c["customer"]
    d_ok = _between(d["d_month_seq"], 12, 23)
    legs = []
    for f, _, cust, (dk,) in _channels(c, ["sold_date_sk"]):
        m = d_ok[dk]
        k = cust[m]
        legs.append((cu["c_last_name"][k], cu["c_first_name"][k],
                     d["d_date"][dk[m]]))
    ids = _key_ids(*[np.concatenate(parts) for parts in zip(*legs)])
    ends = np.cumsum([len(leg[0]) for leg in legs])
    return [np.unique(part) for part in np.split(ids, ends[:-1])]


def numpy_ds_q38(tables):
    ss, cs, ws = _name_date_sets(_ds_dims(tables))
    return {"cnt": [len(np.intersect1d(np.intersect1d(ss, cs), ws))]}


def numpy_ds_q87(tables):
    ss, cs, ws = _name_date_sets(_ds_dims(tables))
    return {"num_cool": [len(np.setdiff1d(np.setdiff1d(ss, cs), ws))]}


def numpy_ds_q14(tables):
    c = _ds_dims(tables)
    d, it = c["date_dim"], c["item"]
    years = _between(d["d_year"], 1998, 2000)
    nov = (d["d_year"] == 2000) & (d["d_moy"] == 11)
    triple = _key_ids(it["i_brand_id"], it["i_class_id"], it["i_category_id"])
    legs = _channels(c, ["sold_date_sk", "item_sk", "quantity",
                         "list_price"])
    common, amts = None, []
    for _, _, _, (dk, ik, qty, price) in legs:
        m = years[dk]
        sold = np.unique(triple[ik[m]])
        common = sold if common is None else np.intersect1d(common, sold)
        amts.append(qty[m].astype(np.float64) * price[m])
    amt = np.concatenate(amts)
    average = amt.sum() / len(amt)
    cross = np.isin(triple, common)
    ch, brand, sales, number = [], [], [], []
    for label, (_, _, _, (dk, ik, qty, price)) in zip(
            ["store", "catalog", "web"], legs):
        m = nov[dk] & cross[ik]
        (b,), (s, n) = _groups([it["i_brand_id"][ik[m]]],
                               qty[m].astype(np.float64) * price[m])
        keep = s > average
        ch += [label] * int(keep.sum())
        brand.append(b[keep])
        sales.append(s[keep])
        number.append(n[keep])
    rows = _rollup([np.array(ch, dtype=str), np.concatenate(brand)],
                   ["channel", "ci_brand", "sum_sales", "sum_number_sales"],
                   [np.concatenate(sales), np.concatenate(number)],
                   lambda s: {"sum_sales": s[0], "sum_number_sales": s[1]},
                   gid_name="lochierarchy")
    return _ds_rows({k: rows[k] for k in (
        "channel", "ci_brand", "lochierarchy", "sum_sales",
        "sum_number_sales")},
        [("lochierarchy", False), ("channel", True), ("ci_brand", True)])


def numpy_ds_q8(tables):
    c = _ds_dims(tables)
    cu, ca, st, ss, d = c["customer"], c["customer_address"], c["store"], \
        c["store_sales"], c["date_dim"]
    pref = cu["c_preferred_cust_flag"] == "Y"
    zip5 = [z[:5] for z in ca["ca_zip"][cu["c_current_addr_sk"][pref]]]
    z5, n = np.unique(np.array(zip5, dtype=str), return_counts=True)
    zip2 = {z[:2] for z in z5[n > 10].tolist()}
    store_ok = np.array([z[:2] in zip2 for z in st["s_zip"].tolist()])
    dk, sk = ss["ss_sold_date_sk"], ss["ss_store_sk"]
    m = (d["d_qoy"][dk] == 2) & (d["d_year"][dk] == 1998) & store_ok[sk]
    (name,), (p,) = _group_sums([st["s_store_name"][sk[m]]],
                                ss["ss_net_profit"][m])
    return _ds_rows({"s_store_name": name, "profit": p},
                    [("s_store_name", True)])


def _item_id_sums(c, fact, date, item, value, lo, hi):
    """``{i_item_id: sum of value}`` over the rows of days ``lo``-``hi``."""
    f = c[fact]
    m = _between(f[date], lo, hi)
    (ids,), (s,) = _group_sums([c["item"]["i_item_id"][f[item][m]]],
                               f[value][m].astype(np.float64))
    return dict(zip(ids.tolist(), s.tolist()))


def numpy_ds_q58(tables):
    c = _ds_dims(tables)
    ss, cs, ws = [_item_id_sums(c, t, f"{p}_sold_date_sk", f"{p}_item_sk",
                                f"{p}_ext_sales_price", 740, 747)
                  for t, p in (("store_sales", "ss"), ("catalog_sales", "cs"),
                               ("web_sales", "ws"))]

    def band(a, b):
        return 0.9 * b <= a <= 1.1 * b
    rows = [(k, a, cs[k], ws[k]) for k, a in ss.items()
            if k in cs and k in ws and band(a, cs[k]) and band(a, ws[k])
            and band(cs[k], a) and band(ws[k], a)]
    return _ds_rows({n: [r[i] for r in rows] for i, n in enumerate(
        ["item_id", "ss_rev", "cs_rev", "ws_rev"])},
        [("item_id", True), ("ss_rev", True)])


def numpy_ds_q71(tables):
    c = _ds_dims(tables)
    d, tm, it = c["date_dim"], c["time_dim"], c["item"]
    d_ok = (d["d_moy"] == 12) & (d["d_year"] == 1998)
    t_ok = np.isin(tm["t_hour"], [8, 9, 17, 18])
    i_ok = it["i_manager_id"] == 1
    ik, tk, price = [], [], []
    for _, _, _, (dk, i, t, p) in _channels(
            c, ["sold_date_sk", "item_sk", "sold_time_sk",
                "ext_sales_price"]):
        m = d_ok[dk] & i_ok[i] & t_ok[t]
        ik.append(i[m])
        tk.append(t[m])
        price.append(p[m])
    ik, tk = np.concatenate(ik), np.concatenate(tk)
    (bid, br, h, mi), (s,) = _group_sums(
        [it["i_brand_id"][ik], it["i_brand"][ik], tm["t_hour"][tk],
         tm["t_minute"][tk]], np.concatenate(price))
    return _ds_rows({"i_brand_id": bid, "i_brand": br, "t_hour": h,
                     "t_minute": mi, "ext_price_sum": s},
                    [("ext_price_sum", False), ("i_brand_id", True),
                     ("t_hour", True), ("t_minute", True)])


def numpy_ds_q83(tables):
    c = _ds_dims(tables)
    sr, cr, wr = [_item_id_sums(c, t, f"{p}_returned_date_sk",
                                f"{p}_item_sk", f"{p}_return_quantity",
                                720, 750)
                  for t, p in (("store_returns", "sr"),
                               ("catalog_returns", "cr"),
                               ("web_returns", "wr"))]
    rows = []
    for k, a in sr.items():
        if k in cr and k in wr:
            total = a + cr[k] + wr[k]
            dev = _ratio(a, total)
            rows.append((k, a, cr[k], wr[k],
                         None if dev is None else dev * 100.0, total / 3.0))
    return _ds_rows({n: [r[i] for r in rows] for i, n in enumerate(
        ["item_id", "sr_qty", "cr_qty", "wr_qty", "sr_dev", "average"])},
        [("item_id", True), ("sr_qty", True)])


def numpy_ds_q91(tables):
    c = _ds_dims(tables)
    cr, d, cc, cu = c["catalog_returns"], c["date_dim"], c["call_center"], \
        c["customer"]
    cd, hd, ca = c["customer_demographics"], c["household_demographics"], \
        c["customer_address"]
    cd_ok = ((cd["cd_marital_status"] == "M")
             & (cd["cd_education_status"] == "Unknown")) \
        | ((cd["cd_marital_status"] == "W")
           & (cd["cd_education_status"] == "Advanced Degree"))
    dk = cr["cr_returned_date_sk"]
    cust = cr["cr_returning_customer_sk"]
    hd_ok = hd["hd_buy_potential"] == "Unknown"
    m = (d["d_year"][dk] == 1999) & (d["d_moy"][dk] == 11) \
        & cd_ok[cu["c_current_cdemo_sk"][cust]] \
        & hd_ok[cu["c_current_hdemo_sk"][cust]] \
        & (ca["ca_gmt_offset"] == -7.0)[cu["c_current_addr_sk"][cust]]
    ck = cr["cr_call_center_sk"][m]
    demo = cu["c_current_cdemo_sk"][cust[m]]
    (cid, name, mgr, ms, es), (s,) = _group_sums(
        [cc["cc_call_center_id"][ck], cc["cc_name"][ck], cc["cc_manager"][ck],
         cd["cd_marital_status"][demo], cd["cd_education_status"][demo]],
        cr["cr_net_loss"][m])
    return _ds_rows({"cc_call_center_id": cid, "cc_name": name,
                     "cc_manager": mgr, "cd_marital_status": ms,
                     "cd_education_status": es, "returns_loss": s},
                    [("returns_loss", False), ("cc_call_center_id", True)])


def _monthly_deviation(parts, names, year, moy, price):
    """q47 and q57: monthly sums by the ``parts`` keys in 1998-1999, each
    with its partition-year's average and the sums of the month before
    and after it within the partition (rows in (year, month) order); the
    1999 months off their average by more than 10 %."""
    (*pk, yr, mo), (s,) = _group_sums(list(parts) + [year, moy], price)
    n = len(s)
    same_part = np.ones(max(n - 1, 0), bool)
    for k in pk:
        same_part &= k[1:] == k[:-1]
    new_year = np.ones(n, bool)
    new_year[1:] = ~same_part | (yr[1:] != yr[:-1])
    gid = np.cumsum(new_year) - 1
    avg = (np.bincount(gid, weights=s) / np.bincount(gid))[gid]
    has_prev, has_next = np.zeros(n, bool), np.zeros(n, bool)
    has_prev[1:] = same_part
    has_next[:-1] = same_part
    with np.errstate(divide="ignore", invalid="ignore"):
        keep = has_prev & has_next & (yr == 1999) & (avg > 0) \
            & (np.abs(s - avg) / avg > 0.1)
    idx = np.flatnonzero(keep)
    out = {nm: k[idx] for nm, k in zip(names, pk)}
    out.update(d_year=yr[idx], d_moy=mo[idx], sum_sales=s[idx],
               avg_monthly_sales=avg[idx], psum=s[idx - 1], nsum=s[idx + 1])
    out["__key"] = s[idx] - avg[idx]
    rows = _ds_rows(out, [("__key", True)] + [(nm, True) for nm in names]
                    + [("d_moy", True)])
    del rows["__key"]
    return rows


def numpy_ds_q47(tables):
    c = _ds_dims(tables)
    ss, d, it, st = c["store_sales"], c["date_dim"], c["item"], c["store"]
    dk, ik, sk = ss["ss_sold_date_sk"], ss["ss_item_sk"], ss["ss_store_sk"]
    m = np.isin(d["d_year"][dk], [1998, 1999])
    return _monthly_deviation(
        [it["i_category"][ik[m]], it["i_brand"][ik[m]],
         st["s_store_name"][sk[m]]],
        ["i_category", "i_brand", "s_store_name"], d["d_year"][dk[m]],
        d["d_moy"][dk[m]], ss["ss_sales_price"][m])


def numpy_ds_q57(tables):
    c = _ds_dims(tables)
    cs, d, it, cc = c["catalog_sales"], c["date_dim"], c["item"], \
        c["call_center"]
    dk, ik, ck = cs["cs_sold_date_sk"], cs["cs_item_sk"], \
        cs["cs_call_center_sk"]
    m = np.isin(d["d_year"][dk], [1998, 1999])
    return _monthly_deviation(
        [it["i_category"][ik[m]], it["i_brand"][ik[m]], cc["cc_name"][ck[m]]],
        ["i_category", "i_brand", "cc_name"], d["d_year"][dk[m]],
        d["d_moy"][dk[m]], cs["cs_sales_price"][m])


def _deviating(keys, part, price):
    """q53, q63 and q89: sums of ``price`` by ``keys``, each with the
    average of those sums over its partition (the columns ``part`` of
    ``keys``), kept where the average is positive and the sum off it by
    more than 10 %: (keys, sums, averages)."""
    ks, (s,) = _group_sums(keys, price)
    pid = _key_ids(*[ks[i] for i in part])
    _, inv, cnt = np.unique(pid, return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    avg = (np.bincount(inv, weights=s) / cnt)[inv]
    with np.errstate(divide="ignore", invalid="ignore"):
        keep = (avg > 0) & (np.abs(s - avg) / avg > 0.1)
    return [k[keep] for k in ks], s[keep], avg[keep]


def _month_store_sales(c, item_ok):
    """Store sales of months 12-23 of items ``item_ok``: (items, dates,
    sales prices)."""
    ss, d = c["store_sales"], c["date_dim"]
    ik = ss["ss_item_sk"]
    m = _between(d["d_month_seq"][ss["ss_sold_date_sk"]], 12, 23) \
        & item_ok[ik]
    return ik[m], ss["ss_sold_date_sk"][m], ss["ss_sales_price"][m]


def numpy_ds_q53(tables):
    c = _ds_dims(tables)
    it, d = c["item"], c["date_dim"]
    ik, dk, price = _month_store_sales(
        c, _between(it["i_manufact_id"], 20, 60))
    (mf, _), s, avg = _deviating([it["i_manufact_id"][ik], d["d_qoy"][dk]],
                                 [0], price)
    return _ds_rows({"i_manufact_id": mf, "sum_sales": s,
                     "avg_quarterly": avg},
                    [("avg_quarterly", True), ("sum_sales", True),
                     ("i_manufact_id", True)])


def numpy_ds_q63(tables):
    c = _ds_dims(tables)
    it, d = c["item"], c["date_dim"]
    ik, dk, price = _month_store_sales(
        c, _between(it["i_manager_id"], 20, 60))
    (mg, _), s, avg = _deviating([it["i_manager_id"][ik], d["d_moy"][dk]],
                                 [0], price)
    return _ds_rows({"i_manager_id": mg, "sum_sales": s, "avg_monthly": avg},
                    [("i_manager_id", True), ("avg_monthly", True),
                     ("sum_sales", True)])


def numpy_ds_q89(tables):
    c = _ds_dims(tables)
    ss, d, it, st = c["store_sales"], c["date_dim"], c["item"], c["store"]
    cat, cls = it["i_category"], it["i_class"]
    item_ok = (np.isin(cat, ["Books", "Electronics", "Sports"])
               & np.isin(cls, ["fiction", "portable", "football"])) \
        | (np.isin(cat, ["Men", "Jewelry", "Women"])
           & np.isin(cls, ["accent", "diamonds", "dresses"]))
    dk, ik, sk = ss["ss_sold_date_sk"], ss["ss_item_sk"], ss["ss_store_sk"]
    m = (d["d_year"][dk] == 1998) & item_ok[ik]
    ik, sk, dk = ik[m], sk[m], dk[m]
    names = ["i_category", "i_class", "i_brand", "s_store_name",
             "s_company_id", "d_moy"]
    ks, s, avg = _deviating(
        [cat[ik], cls[ik], it["i_brand"][ik], st["s_store_name"][sk],
         st["s_company_id"][sk], d["d_moy"][dk]], [0, 2, 3, 4],
        ss["ss_sales_price"][m])
    out = dict(zip(names, ks))
    out.update(sum_sales=s, avg_monthly_sales=avg, __key=s - avg)
    rows = _ds_rows(out, [("__key", True), ("s_store_name", True),
                          ("i_category", True), ("i_class", True),
                          ("i_brand", True), ("d_moy", True)])
    del rows["__key"]
    return rows


def _class_share(c, fact, p):
    """q12 and q20: item revenue of days 730-760 in three categories, with
    its class's revenue and its share of it."""
    f, it = c[fact], c["item"]
    ik = f[f"{p}_item_sk"]
    m = _between(f[f"{p}_sold_date_sk"], 730, 760) \
        & np.isin(it["i_category"][ik], ["Sports", "Books", "Home"])
    ik = ik[m]
    (iid, cat, cls, price), (rev,) = _group_sums(
        [it["i_item_id"][ik], it["i_category"][ik], it["i_class"][ik],
         it["i_current_price"][ik]], f[f"{p}_ext_sales_price"][m])
    (classes,), (class_rev,) = _group_sums([cls], rev)
    crev = _at(classes, class_rev, cls)
    return _ds_rows({"i_item_id": iid, "i_category": cat, "i_class": cls,
                     "i_current_price": price, "itemrevenue": rev,
                     "classrevenue": crev,
                     "revenueratio": rev * 100.0 / crev},
                    [("i_category", True), ("i_class", True),
                     ("i_item_id", True), ("revenueratio", True)])


def numpy_ds_q12(tables):
    return _class_share(_ds_dims(tables), "web_sales", "ws")


def numpy_ds_q20(tables):
    return _class_share(_ds_dims(tables), "catalog_sales", "cs")


def numpy_ds_q49(tables):
    c = _ds_dims(tables)
    d = c["date_dim"]
    d_ok = (d["d_year"] == 1998) & (d["d_moy"] == 12)
    out = {k: [] for k in ("channel", "item", "return_ratio", "return_rank",
                           "currency_rank")}
    for label, (fact, s, order), (ret, r, r_order, r_amt) in (
            ("web", ("web_sales", "ws", "ws_order_number"),
             ("web_returns", "wr", "wr_order_number", "wr_return_amt")),
            ("catalog", ("catalog_sales", "cs", "cs_order_number"),
             ("catalog_returns", "cr", "cr_order_number",
              "cr_return_amount")),
            ("store", ("store_sales", "ss", "ss_ticket_number"),
             ("store_returns", "sr", "sr_ticket_number", "sr_return_amt"))):
        f, rt = c[fact], c[ret]
        rows = np.flatnonzero((f[f"{s}_net_paid"] > 0.0)
                              & d_ok[f[f"{s}_sold_date_sk"]])
        li, ri = _eq_join([f[f"{s}_item_sk"][rows], f[order][rows]],
                          [rt[f"{r}_item_sk"], rt[r_order]])
        sr = rows[li]
        (items,), (rq, sq, ra, sa) = _group_sums(
            [f[f"{s}_item_sk"][sr]],
            rt[f"{r}_return_quantity"][ri].astype(np.float64),
            f[f"{s}_quantity"][sr].astype(np.float64), rt[r_amt][ri],
            f[f"{s}_net_paid"][sr])
        one = np.zeros(len(items), np.int64)
        return_rank = _rank_desc(one, rq / sq)
        currency_rank = _rank_desc(one, ra / sa)
        keep = (return_rank <= 10) | (currency_rank <= 10)
        out["channel"] += [label] * int(keep.sum())
        out["item"] += items[keep].tolist()
        out["return_ratio"] += (rq / sq)[keep].tolist()
        out["return_rank"] += return_rank[keep].tolist()
        out["currency_rank"] += currency_rank[keep].tolist()
    return _ds_rows(out, [("channel", True), ("return_rank", True),
                          ("currency_rank", True), ("item", True)])


def numpy_ds_q67(tables):
    c = _ds_dims(tables)
    ss, d, it, st = c["store_sales"], c["date_dim"], c["item"], c["store"]
    dk, ik, sk = ss["ss_sold_date_sk"], ss["ss_item_sk"], ss["ss_store_sk"]
    m = _between(d["d_month_seq"][dk], 12, 23)
    dk, ik, sk = dk[m], ik[m], sk[m]
    keys = [it["i_category"][ik], it["i_class"][ik], it["i_brand"][ik],
            it["i_product_name"][ik], d["d_year"][dk], d["d_qoy"][dk],
            d["d_moy"][dk], st["s_store_id"][sk]]
    names = ["i_category", "i_class", "i_brand", "i_product_name", "d_year",
             "d_qoy", "d_moy", "s_store_id"]
    amt = ss["ss_quantity"][m].astype(np.float64) * ss["ss_sales_price"][m]
    levels = []
    for present in range(len(keys), -1, -1):
        if present:
            ks, (s,) = _group_sums(keys[:present], amt)
        else:
            ks, s = [], np.array([amt.sum()]) if len(amt) else amt
        levels.append((ks, s))
    # rank() over i_category (the grand total's null its own partition)
    cats = np.concatenate([ks[0] if ks else np.full(len(s), "")
                           for ks, s in levels])
    part = np.unique(cats, return_inverse=True)[1].reshape(-1)
    part[len(cats) - len(levels[-1][1]):] = -1
    rank = _rank_desc(part, np.concatenate([s for _, s in levels]))
    out = {nm: [] for nm in names + ["sumsales", "rk"]}
    at_ = 0
    for ks, s in levels:
        keep = np.flatnonzero(rank[at_:at_ + len(s)] <= 10)
        for i, nm in enumerate(names):
            out[nm] += ks[i][keep].tolist() if i < len(ks) \
                else [None] * len(keep)
        out["sumsales"] += s[keep].tolist()
        out["rk"] += rank[at_ + keep].tolist()
        at_ += len(s)
    return _ds_rows(out, [("i_category", True), ("rk", True),
                          ("sumsales", False), ("i_product_name", True),
                          ("s_store_id", True), ("i_class", True),
                          ("i_brand", True), ("d_year", True),
                          ("d_qoy", True), ("d_moy", True)])


def numpy_ds_q70(tables):
    c = _ds_dims(tables)
    ss, d, st = c["store_sales"], c["date_dim"], c["store"]
    m = _between(d["d_month_seq"][ss["ss_sold_date_sk"]], 12, 23)
    sk = ss["ss_store_sk"][m]
    state, county, profit = st["s_state"][sk], st["s_county"][sk], \
        ss["ss_net_profit"][m]
    (states,), (sp,) = _group_sums([state], profit)
    top = states[_rank_desc(np.zeros(len(sp), np.int64), sp) <= 5]
    keep = np.isin(state, top)
    rows = _rollup([state[keep], county[keep]],
                   ["s_state", "s_county", "total_sum"], [profit[keep]],
                   lambda s: {"total_sum": s[0]}, gid_name="lochierarchy")
    return _ds_rows({k: rows[k] for k in ("s_state", "s_county",
                                          "lochierarchy", "total_sum")},
                    [("lochierarchy", False), ("s_state", True),
                     ("s_county", True), ("total_sum", True)])


def _channel_rollup(legs):
    """q77 and q80: the rollup over (channel, id) of the channels' rows,
    ``legs`` a list of (channel, ids, sales, returns, profit)."""
    rows = _rollup(
        [np.array(sum(([ch] * len(ids) for ch, ids, *_ in legs), []),
                  dtype=str), np.concatenate([leg[1] for leg in legs])],
        ["channel", "id", "sales_sum", "returns_sum", "profit_sum"],
        [np.concatenate([leg[i] for leg in legs]) for i in (2, 3, 4)],
        lambda s: {"sales_sum": s[0], "returns_sum": s[1],
                   "profit_sum": s[2]})
    return _ds_rows(rows, [("channel", True), ("id", True),
                           ("sales_sum", True)])


def numpy_ds_q77(tables):
    c = _ds_dims(tables)

    def sums(t, date, key, a, b):
        f = c[t]
        m = _between(f[date], 730, 760)
        (k,), (x, y) = _group_sums([f[key][m]], f[a][m], f[b][m])
        return k, x, y
    legs = []
    for label, sale, ret in (
            ("store channel",
             ("store_sales", "ss_sold_date_sk", "ss_store_sk",
              "ss_ext_sales_price", "ss_net_profit"),
             ("store_returns", "sr_returned_date_sk", "sr_store_sk",
              "sr_return_amt", "sr_net_loss")),
            ("catalog channel",
             ("catalog_sales", "cs_sold_date_sk", "cs_call_center_sk",
              "cs_ext_sales_price", "cs_net_profit"),
             ("catalog_returns", "cr_returned_date_sk", "cr_call_center_sk",
              "cr_return_amount", "cr_net_loss")),
            ("web channel",
             ("web_sales", "ws_sold_date_sk", "ws_web_page_sk",
              "ws_ext_sales_price", "ws_net_profit"),
             ("web_returns", "wr_returned_date_sk", "wr_web_page_sk",
              "wr_return_amt", "wr_net_loss"))):
        k, sales, profit = sums(*sale)
        rk, amt, loss = sums(*ret)
        # the left join: a key without returns reads the appended 0.0
        hit, row = _lookup(rk, k) if len(rk) else (False, 0)
        row = np.where(hit, row, len(rk))
        legs.append((label, k, sales, np.r_[amt, 0.0][row],
                     profit - np.r_[loss, 0.0][row]))
    return _channel_rollup(legs)


def numpy_ds_q80(tables):
    c = _ds_dims(tables)
    item_ok = c["item"]["i_current_price"] > 50.0
    promo_ok = c["promotion"]["p_channel_email"] == "N"
    legs = []
    for label, fact, p, key, order, ret, r, r_order, r_amt in (
            ("store channel", "store_sales", "ss", "ss_store_sk",
             "ss_ticket_number", "store_returns", "sr", "sr_ticket_number",
             "sr_return_amt"),
            ("catalog channel", "catalog_sales", "cs", "cs_catalog_page_sk",
             "cs_order_number", "catalog_returns", "cr", "cr_order_number",
             "cr_return_amount"),
            ("web channel", "web_sales", "ws", "ws_web_site_sk",
             "ws_order_number", "web_returns", "wr", "wr_order_number",
             "wr_return_amt")):
        f, rt = c[fact], c[ret]
        pv = tables[fact].validity[f"{p}_promo_sk"]
        rows = np.flatnonzero(
            _between(f[f"{p}_sold_date_sk"], 730, 760)
            & item_ok[f[f"{p}_item_sk"]] & pv
            & promo_ok[np.where(pv, f[f"{p}_promo_sk"], 0)])
        li, ri = _eq_join([f[order][rows], f[f"{p}_item_sk"][rows]],
                          [rt[r_order], rt[f"{r}_item_sk"]])
        alone = np.ones(len(rows), bool)
        alone[li] = False
        s_rows = np.concatenate([rows[li], rows[alone]])
        zero = np.zeros(int(alone.sum()))
        amt = np.concatenate([rt[r_amt][ri], zero])
        loss = np.concatenate([rt[f"{r}_net_loss"][ri], zero])
        (k,), (sales, rets, profit) = _group_sums(
            [f[key][s_rows]], f[f"{p}_ext_sales_price"][s_rows], amt,
            f[f"{p}_net_profit"][s_rows] - loss)
        legs.append((label, k, sales, rets, profit))
    return _channel_rollup(legs)


def numpy_ds_q2(tables):
    c = _ds_dims(tables)
    d = c["date_dim"]
    dk = np.concatenate([c["web_sales"]["ws_sold_date_sk"],
                         c["catalog_sales"]["cs_sold_date_sk"]])
    price = np.concatenate([c["web_sales"]["ws_ext_sales_price"],
                            c["catalog_sales"]["cs_ext_sales_price"]])
    day = d["d_day_name"][dk]
    (wk,), sums = _group_sums(
        [d["d_week_seq"][dk]],
        *[np.where(day == nm, price, 0.0) for nm in _DAY_NAMES])
    a = np.flatnonzero(np.isin(wk, d["d_week_seq"][d["d_year"] == 1998]))
    b = np.flatnonzero(np.isin(wk, d["d_week_seq"][d["d_year"] == 1999]))
    li, ri = _eq_join([wk[a]], [wk[b] - 52])
    a, b = a[li], b[ri]
    out = {"wk1": wk[a]}
    for nm, s in zip(_DAYS, sums):
        out[f"r_{nm}"] = [_ratio(x, y) for x, y in zip(s[a].tolist(),
                                                        s[b].tolist())]
    return _ds_rows(out, [("wk1", True)])


def _year_sums(c, fact, cust, date, value, year):
    """``{customer: sum of value}`` over the fact's rows of ``year``."""
    f = c[fact]
    m = c["date_dim"]["d_year"][f[date]] == year
    (k,), (s,) = _group_sums([f[cust][m]], value[m])
    return dict(zip(k.tolist(), s.tolist()))


def _growth_customers(c, value, legs, keep, names):
    """q4, q11 and q74: the customers with sums of ``value(fact, prefix)``
    in 1998 and 1999 in every leg (``legs``: (fact, prefix, customer
    column)) for whom ``keep({prefix_y1: ..., prefix_y2: ...})`` holds,
    with the customer columns ``names``, by customer id."""
    sums = {}
    for fact, p, cust in legs:
        v = value(c[fact], p)
        for y, year in ((1, 1998), (2, 1999)):
            sums[f"{p}_y{y}"] = _year_sums(c, fact, cust, f"{p}_sold_date_sk",
                                           v, year)
    first = sums[f"{legs[0][1]}_y1"]
    ks = [k for k in first if all(k in s for s in sums.values())
          and keep({n: s[k] for n, s in sums.items()})]
    cu = c["customer"]
    return _ds_rows({n: cu[n][np.array(ks, np.int64)] for n in names},
                    [("c_customer_id", True)])


def numpy_ds_q4(tables):
    def net(f, p):
        return (f[f"{p}_ext_list_price"] - f[f"{p}_ext_wholesale_cost"]
                - f[f"{p}_ext_discount_amt"] + f[f"{p}_ext_sales_price"]) \
            / 2.0

    def keep(s):
        if not (s["ss_y1"] > 0 and s["cs_y1"] > 0 and s["ws_y1"] > 0):
            return False
        g = s["cs_y2"] / s["cs_y1"]
        return g > s["ss_y2"] / s["ss_y1"] and g > s["ws_y2"] / s["ws_y1"]
    return _growth_customers(
        _ds_dims(tables), net,
        [("store_sales", "ss", "ss_customer_sk"),
         ("catalog_sales", "cs", "cs_bill_customer_sk"),
         ("web_sales", "ws", "ws_bill_customer_sk")], keep,
        ["c_customer_id", "c_first_name", "c_last_name",
         "c_preferred_cust_flag"])


def _web_beats_store(tables, column):
    """q11 (``ext_list_price``) and q74 (``net_paid``)."""
    def keep(s):
        return s["ss_y1"] > 0 and s["ws_y1"] > 0 \
            and s["ws_y2"] / s["ws_y1"] > s["ss_y2"] / s["ss_y1"]
    return _growth_customers(
        _ds_dims(tables), lambda f, p: f[f"{p}_{column}"],
        [("store_sales", "ss", "ss_customer_sk"),
         ("web_sales", "ws", "ws_bill_customer_sk")], keep,
        ["c_customer_id", "c_first_name", "c_last_name"])


def numpy_ds_q11(tables):
    return _web_beats_store(tables, "ext_list_price")


def numpy_ds_q74(tables):
    return _web_beats_store(tables, "net_paid")


def numpy_ds_q31(tables):
    c = _ds_dims(tables)
    d, ca = c["date_dim"], c["customer_address"]
    q = {}
    for p, fact, addr in (("ss", "store_sales", "ss_addr_sk"),
                          ("ws", "web_sales", "ws_bill_customer_sk")):
        f = c[fact]
        dk = f[f"{p}_sold_date_sk"]
        for qoy in (1, 2, 3):
            m = (d["d_qoy"][dk] == qoy) & (d["d_year"][dk] == 2000)
            (cty,), (s,) = _group_sums([ca["ca_county"][f[addr][m]]],
                                       f[f"{p}_ext_sales_price"][m])
            q[f"{p}{qoy}"] = dict(zip(cty.tolist(), s.tolist()))

    def grew_faster(v, a, b):
        """Web growth from quarter a to b above store growth (null, and
        so false, where a quarter's sum is 0)."""
        web = _ratio(v[f"ws{b}"], v[f"ws{a}"])
        store = _ratio(v[f"ss{b}"], v[f"ss{a}"])
        return web is not None and store is not None and web > store
    rows = []
    for k in q["ss1"]:
        if not all(k in s for s in q.values()):
            continue
        v = {n: s[k] for n, s in q.items()}
        if v["ss1"] > 0 and v["ws1"] > 0 and grew_faster(v, 1, 2) \
                and grew_faster(v, 2, 3):
            rows.append((k, v["ws2"] / v["ws1"], v["ss2"] / v["ss1"]))
    return _ds_rows({n: [r[i] for r in rows] for i, n in enumerate(
        ["county", "web_g1", "store_g1"])}, [("county", True)])


def _active(c, d_ok, legs):
    """The distinct customers of the channels ``legs`` (from
    :func:`_channels`) with a sale on a day ``d_ok``."""
    return np.unique(np.concatenate([cust[d_ok[dk]]
                                     for _, _, cust, (dk,) in legs]))


def _store_and_web_or_catalog(c, d_ok):
    """q10 and q35: whether each customer bought in the store and on the
    web or by catalog on a day ``d_ok``."""
    store, catalog, web = _channels(c, ["sold_date_sk"])
    sk = c["customer"]["c_customer_sk"]
    return np.isin(sk, _active(c, d_ok, [store])) \
        & np.isin(sk, _active(c, d_ok, [catalog, web]))


def numpy_ds_q10(tables):
    c = _ds_dims(tables)
    d, cu, ca, cd = c["date_dim"], c["customer"], c["customer_address"], \
        c["customer_demographics"]
    m = _store_and_web_or_catalog(
        c, (d["d_year"] == 1999) & (d["d_moy"] <= 4)) \
        & np.isin(ca["ca_city"][cu["c_current_addr_sk"]],
                  ["Fairview", "Midway", "Riverside"])
    demo = cu["c_current_cdemo_sk"][m]
    names = ["cd_gender", "cd_marital_status", "cd_education_status",
             "cd_dep_count"]
    ks, (n,) = _group_sums([cd[k][demo] for k in names],
                           np.ones(len(demo), np.int64))
    out = dict(zip(names, ks))
    out["cnt1"] = n
    return _ds_rows(out, [(k, True) for k in names])


def numpy_ds_q35(tables):
    c = _ds_dims(tables)
    d, cu, ca, cd = c["date_dim"], c["customer"], c["customer_address"], \
        c["customer_demographics"]
    m = _store_and_web_or_catalog(c, (d["d_year"] == 1999) & (d["d_qoy"] <= 3))
    demo = cu["c_current_cdemo_sk"][m]
    (st, g, ms, dep), (n,) = _group_sums(
        [ca["ca_state"][cu["c_current_addr_sk"][m]], cd["cd_gender"][demo],
         cd["cd_marital_status"][demo], cd["cd_dep_count"][demo]],
        np.ones(len(demo), np.int64))
    x = dep.astype(np.float64)
    return _ds_rows({"ca_state": st, "cd_gender": g, "cd_marital_status": ms,
                     "cd_dep_count": dep, "cnt1": n, "min_dep": x,
                     "max_dep": x, "avg_dep": x},
                    [("ca_state", True), ("cd_gender", True),
                     ("cd_marital_status", True), ("cd_dep_count", True)])


def numpy_ds_q69(tables):
    c = _ds_dims(tables)
    d, cu, ca, cd = c["date_dim"], c["customer"], c["customer_address"], \
        c["customer_demographics"]
    d_ok = (d["d_year"] == 1999) & (d["d_qoy"] <= 2)
    store, catalog, web = _channels(c, ["sold_date_sk"])
    sk = cu["c_customer_sk"]
    m = np.isin(ca["ca_state"][cu["c_current_addr_sk"]], ["KY", "GA", "NM"]) \
        & np.isin(sk, _active(c, d_ok, [store])) \
        & ~np.isin(sk, _active(c, d_ok, [web])) \
        & ~np.isin(sk, _active(c, d_ok, [catalog]))
    demo = cu["c_current_cdemo_sk"][m]
    names = ["cd_gender", "cd_marital_status", "cd_education_status"]
    ks, (n,) = _group_sums([cd[k][demo] for k in names],
                           np.ones(len(demo), np.int64))
    out = dict(zip(names, ks))
    out["cnt"] = n
    return _ds_rows(out, [(k, True) for k in names])


def _multi_warehouse_orders(f, order, wh):
    """The orders shipped from two or more warehouses."""
    pairs = np.unique(np.stack([f[order], f[wh]], 1), axis=0)
    orders, n = np.unique(pairs[:, 0], return_counts=True)
    return orders[n >= 2]


def _order_totals(orders, ship, profit):
    """q16, q94 and q95's one row: distinct orders, ship cost and profit."""
    return {"order_count": [len(np.unique(orders))],
            "total_ship": [float(ship.sum()) if len(ship) else None],
            "total_profit": [float(profit.sum()) if len(profit) else None]}


def numpy_ds_q16(tables):
    c = _ds_dims(tables)
    cs, ca = c["catalog_sales"], c["customer_address"]
    av = tables["catalog_sales"].validity["cs_ship_addr_sk"]
    order = cs["cs_order_number"]
    m = _between(cs["cs_ship_date_sk"], 750, 810) & av \
        & (ca["ca_state"][np.where(av, cs["cs_ship_addr_sk"], 0)] == "GA") \
        & np.isin(order, _multi_warehouse_orders(cs, "cs_order_number",
                                                 "cs_warehouse_sk")) \
        & ~np.isin(order, c["catalog_returns"]["cr_order_number"])
    return _order_totals(order[m], cs["cs_ext_ship_cost"][m],
                         cs["cs_net_profit"][m])


def _web_ca_orders(c):
    """q94 and q95's base: web sales shipped on days 400-460 to CA."""
    ws, ca = c["web_sales"], c["customer_address"]
    return _between(ws["ws_ship_date_sk"], 400, 460) \
        & (ca["ca_state"][ws["ws_ship_addr_sk"]] == "CA")


def numpy_ds_q94(tables):
    c = _ds_dims(tables)
    ws = c["web_sales"]
    order = ws["ws_order_number"]
    m = _web_ca_orders(c) \
        & np.isin(order, _multi_warehouse_orders(ws, "ws_order_number",
                                                 "ws_warehouse_sk")) \
        & ~np.isin(order, c["web_returns"]["wr_order_number"])
    return _order_totals(order[m], ws["ws_ext_ship_cost"][m],
                         ws["ws_net_profit"][m])


def numpy_ds_q95(tables):
    c = _ds_dims(tables)
    ws = c["web_sales"]
    order = ws["ws_order_number"]
    multi = _multi_warehouse_orders(ws, "ws_order_number", "ws_warehouse_sk")
    returned = c["web_returns"]["wr_order_number"]
    m = _web_ca_orders(c) & np.isin(order, multi) \
        & np.isin(order, returned[np.isin(returned, multi)])
    return _order_totals(order[m], ws["ws_ext_ship_cost"][m],
                         ws["ws_net_profit"][m])


def numpy_ds_q23(tables):
    c = _ds_dims(tables)
    ss, d = c["store_sales"], c["date_dim"]
    m = _between(d["d_year"], 1998, 2000)[ss["ss_sold_date_sk"]]
    items, n = np.unique(ss["ss_item_sk"][m], return_counts=True)
    frequent = items[n > 4]
    (cust,), (spend,) = _group_sums(
        [ss["ss_customer_sk"][m]],
        ss["ss_quantity"][m].astype(np.float64) * ss["ss_sales_price"][m])
    best = cust[spend > 0.5 * spend.max()] if len(spend) else cust
    d_ok = (d["d_year"] == 2000) & (d["d_moy"] == 3)
    sales = []
    for _, _, cust_k, (dk, ik, qty, price) in _channels(
            c, ["sold_date_sk", "item_sk", "quantity", "list_price"])[1:]:
        mm = d_ok[dk] & np.isin(ik, frequent) & np.isin(cust_k, best)
        sales.append(qty[mm].astype(np.float64) * price[mm])
    s = np.concatenate(sales)
    return {"total": [float(s.sum()) if len(s) else None]}


def numpy_ds_q24(tables):
    c = _ds_dims(tables)
    ss, sr, st, it, cu, ca = c["store_sales"], c["store_returns"], \
        c["store"], c["item"], c["customer"], c["customer_address"]
    li, _ = _eq_join([ss["ss_ticket_number"], ss["ss_item_sk"]],
                     [sr["sr_ticket_number"], sr["sr_item_sk"]])
    sk, ik, ck = ss["ss_store_sk"][li], ss["ss_item_sk"][li], \
        ss["ss_customer_sk"][li]
    keep = ca["ca_zip"][cu["c_current_addr_sk"][ck]] != st["s_zip"][sk]
    sk, ik, ck = sk[keep], ik[keep], ck[keep]
    (ln, fn, sn, mf), (paid,) = _group_sums(
        [cu["c_last_name"][ck], cu["c_first_name"][ck],
         st["s_store_name"][sk], it["i_manufact"][ik]],
        ss["ss_net_paid"][li][keep])
    big = paid > 0.05 * (paid.sum() / len(paid)) if len(paid) else \
        np.zeros(0, bool)
    return _ds_rows({"c_last_name": ln[big], "c_first_name": fn[big],
                     "s_store_name": sn[big], "i_manufact": mf[big],
                     "netpaid": paid[big]},
                    [("c_last_name", True), ("c_first_name", True),
                     ("s_store_name", True), ("i_manufact", True)])


# -- the last 33 TPC-DS queries ---------------------------------------------

#: q9's quantity buckets: (low, high, the row count above which the
#: bucket reports its average discount rather than its average net paid).
_Q9_BUCKETS = [(1, 20, 74129), (21, 40, 122840), (41, 60, 56580),
               (61, 80, 10097), (81, 100, 165306)]
#: q28's bands: (quantity low, high, list price low, high).
_Q28_BANDS = [(0, 5, 11, 16), (6, 10, 91, 96), (11, 15, 66, 71),
              (16, 20, 142, 147), (21, 25, 135, 140), (26, 30, 28, 33)]


def _mean(values):
    """Spark's ``avg``: null over no row."""
    return float(values.sum()) / len(values) if len(values) else None


def numpy_ds_q9(tables):
    ss = tables["store_sales"].columns
    # the rows of reason 1, the one-row frame the buckets cross-join
    anchor = int((tables["reason"].columns["r_reason_sk"] == 1).sum())
    out = {}
    for i, (lo, hi, above) in enumerate(_Q9_BUCKETS, 1):
        m = _between(ss["ss_quantity"], lo, hi)
        pick = "ss_ext_discount_amt" if m.sum() > above else "ss_net_paid"
        out[f"bucket{i}"] = [_mean(ss[pick][m])] * anchor
    return out


def numpy_ds_q28(tables):
    ss = tables["store_sales"].columns
    lp = ss["ss_list_price"]
    out = {}
    for i, (qlo, qhi, plo, phi) in enumerate(_Q28_BANDS, 1):
        m = _between(ss["ss_quantity"], qlo, qhi) & (
            _between(lp, plo, phi)
            | _between(ss["ss_coupon_amt"], plo * 10.0, plo * 10.0 + 1000.0)
            | _between(ss["ss_wholesale_cost"], qlo, qlo + 20.0))
        out.update({f"b{i}_lp": [_mean(lp[m])], f"b{i}_cnt": [int(m.sum())],
                    f"b{i}_cntd": [len(np.unique(lp[m]))]})
    return out


def numpy_ds_q90(tables):
    c = _ds_dims(tables)
    ws = c["web_sales"]
    hour = c["time_dim"]["t_hour"][ws["ws_sold_time_sk"]]
    ok = (c["household_demographics"]["hd_dep_count"][
        ws["ws_bill_hdemo_sk"]] == 3) & _between(
        c["web_page"]["wp_char_count"][ws["ws_web_page_sk"]], 2500, 5500)
    am = float((ok & _between(hour, 8, 9)).sum())
    pm = float((ok & _between(hour, 19, 20)).sum())
    return {"am_pm_ratio": [_ratio(am, pm)]}


def _excess_discount(c, fact, p):
    """q32 and q92: the discounts above 1.3 times their item's average
    over the channel's sales in days 700-790 of manufacturers 20-40."""
    f = c[fact]
    ik = f[f"{p}_item_sk"]
    m = _between(f[f"{p}_sold_date_sk"], 700, 790) \
        & _between(c["item"]["i_manufact_id"][ik], 20, 40)
    ik, disc = ik[m], f[f"{p}_ext_discount_amt"][m]
    (items,), (s, n) = _groups([ik], disc)
    keep = disc > 1.3 * _at(items, s / n, ik)
    return {"excess_discount": [float(disc[keep].sum()) if keep.any()
                                else None]}


def numpy_ds_q32(tables):
    return _excess_discount(_ds_dims(tables), "catalog_sales", "cs")


def numpy_ds_q92(tables):
    return _excess_discount(_ds_dims(tables), "web_sales", "ws")


def numpy_ds_q41(tables):
    it = tables["item"].columns
    siblings = it["i_manufact"][np.isin(it["i_category"],
                                        ["Women", "Men", "Shoes"])]
    m = _between(it["i_manufact_id"], 40, 80) \
        & np.isin(it["i_manufact"], siblings)
    return _ds_rows({"i_product_name": np.unique(it["i_product_name"][m])},
                    [("i_product_name", True)])


def numpy_ds_q84(tables):
    c = _ds_dims(tables)
    cu, ib = c["customer"], c["income_band"]
    band = c["household_demographics"]["hd_income_band_sk"][
        cu["c_current_hdemo_sk"]]
    m = (c["customer_address"]["ca_city"][cu["c_current_addr_sk"]]
         == "Midway") & (ib["ib_lower_bound"][band] >= 20000) \
        & (ib["ib_upper_bound"][band] <= 70000) \
        & np.isin(cu["c_customer_sk"], c["store_returns"]["sr_customer_sk"])
    return _ds_rows({k: cu[k][m] for k in ("c_customer_id", "c_first_name",
                                           "c_last_name")},
                    [("c_customer_id", True)])


def numpy_ds_q43(tables):
    c = _ds_dims(tables)
    ss, d, st = c["store_sales"], c["date_dim"], c["store"]
    dk = ss["ss_sold_date_sk"]
    m = d["d_year"][dk] == 1998
    day, price = d["d_day_name"][dk[m]], ss["ss_sales_price"][m]
    (sk,), sums = _group_sums([ss["ss_store_sk"][m]], *[
        np.where(day == name, price, 0.0) for name in _DAY_NAMES])
    out = {"s_store_name": st["s_store_name"][sk],
           "s_store_id": st["s_store_id"][sk]}
    out.update({f"{d}_sales": s for d, s in zip(_DAYS, sums)})
    return _ds_rows(out, [("s_store_name", True), ("s_store_id", True)])


def _latency_buckets(lat):
    """q50, q62 and q99's day counts: up to 30, 31-60, 61-90, 91-120 and
    more than 120."""
    return [(lat <= 30).astype(np.int64),
            ((lat > 30) & (lat <= 60)).astype(np.int64),
            ((lat > 60) & (lat <= 90)).astype(np.int64),
            ((lat > 90) & (lat <= 120)).astype(np.int64),
            (lat > 120).astype(np.int64)]


_LATENCY = ["d30", "d60", "d90", "d120", "d120plus"]


def numpy_ds_q50(tables):
    c = _ds_dims(tables)
    ss, sr, d, st = c["store_sales"], c["store_returns"], c["date_dim"], \
        c["store"]
    rd = sr["sr_returned_date_sk"]
    rm = np.flatnonzero((d["d_year"][rd] == 2000) & (d["d_moy"][rd] == 8))
    ri, si = _eq_join([sr[k][rm] for k in ("sr_ticket_number", "sr_item_sk",
                                           "sr_customer_sk")],
                      [ss[k] for k in ("ss_ticket_number", "ss_item_sk",
                                       "ss_customer_sk")])
    lat = rd[rm][ri] - ss["ss_sold_date_sk"][si]
    (sk,), counts = _group_sums([ss["ss_store_sk"][si]],
                                *_latency_buckets(lat))
    out = {k: st[k][sk] for k in ("s_store_name", "s_store_id", "s_city",
                                  "s_county", "s_state", "s_zip")}
    out.update(zip(_LATENCY, counts))
    return _ds_rows(out, [("s_store_name", True), ("s_store_id", True)])


def _shipping_latency(c, fact, p, site_col, site_table, name_col):
    """q62 and q99: the channel's sales shipped in months 12-23, their
    latency buckets by warehouse, ship mode type and site or center."""
    f, d = c[fact], c["date_dim"]
    m = _between(d["d_month_seq"][f[f"{p}_ship_date_sk"]], 12, 23)
    lat = f[f"{p}_ship_date_sk"][m] - f[f"{p}_sold_date_sk"][m]
    (wh, sm, site), counts = _group_sums(
        [c["warehouse"]["w_warehouse_name"][f[f"{p}_warehouse_sk"][m]],
         c["ship_mode"]["sm_type"][f[f"{p}_ship_mode_sk"][m]],
         c[site_table][name_col][f[site_col][m]]], *_latency_buckets(lat))
    out = {"wh": wh, "sm_type": sm, name_col: site}
    out.update(zip(_LATENCY, counts))
    return _ds_rows(out, [("wh", True), ("sm_type", True),
                          (name_col, True)])


def numpy_ds_q62(tables):
    return _shipping_latency(_ds_dims(tables), "web_sales", "ws",
                             "ws_web_site_sk", "web_site", "web_name")


def numpy_ds_q99(tables):
    return _shipping_latency(_ds_dims(tables), "catalog_sales", "cs",
                             "cs_call_center_sk", "call_center", "cc_name")


def numpy_ds_q45(tables):
    c = _ds_dims(tables)
    ws, d, ca = c["web_sales"], c["date_dim"], c["customer_address"]
    dk = ws["ws_sold_date_sk"]
    addr = c["customer"]["c_current_addr_sk"][ws["ws_bill_customer_sk"]]
    zip5 = np.array([z[:5] for z in ca["ca_zip"].tolist()])
    m = (d["d_qoy"][dk] == 2) & (d["d_year"][dk] == 2000) & (
        np.isin(zip5, ["85669", "86197", "88274", "83405", "86475"])[addr]
        | np.isin(ws["ws_item_sk"], [2, 3, 5, 7, 11, 13, 17, 19, 23, 29]))
    (z, city), (s,) = _group_sums([ca["ca_zip"][addr[m]],
                                   ca["ca_city"][addr[m]]],
                                  ws["ws_sales_price"][m])
    return _ds_rows({"ca_zip": z, "ca_city": city, "web_sales": s},
                    [("ca_zip", True), ("ca_city", True)])


def numpy_ds_q73(tables):
    c = _ds_dims(tables)
    ss, d, hd, cu = c["store_sales"], c["date_dim"], \
        c["household_demographics"], c["customer"]
    hk = ss["ss_hdemo_sk"]
    m = np.isin(d["d_year"][ss["ss_sold_date_sk"]], [1998, 1999]) \
        & np.isin(hd["hd_buy_potential"][hk], [">10000", "Unknown"]) \
        & (hd["hd_vehicle_count"][hk] > 0) \
        & np.isin(c["store"]["s_county"][ss["ss_store_sk"]],
                  ["Fairview County", "Midway County", "Riverside County"])
    (tick, cust), (n,) = _groups([ss["ss_ticket_number"][m],
                                  ss["ss_customer_sk"][m]])
    keep = _between(n, 1, 5)
    ck = cust[keep]
    out = {k: cu[k][ck] for k in ("c_last_name", "c_first_name",
                                  "c_salutation", "c_preferred_cust_flag")}
    out.update(ss_ticket_number=tick[keep], cnt=n[keep])
    return _ds_rows(out, [("cnt", False), ("c_last_name", True),
                          ("ss_ticket_number", True)])


def _stocked_items(c, sold, price_lo, price_hi, mf_lo, mf_hi):
    """q37 and q82: items of a price and manufacturer band with 100-500
    on hand in days 700-760 that a channel sold (``sold``: its item
    keys), at their price."""
    it, inv = c["item"], c["inventory"]
    stocked = inv["inv_item_sk"][
        _between(inv["inv_quantity_on_hand"], 100, 500)
        & _between(inv["inv_date_sk"], 700, 760)]
    m = _between(it["i_current_price"], price_lo, price_hi) \
        & _between(it["i_manufact_id"], mf_lo, mf_hi) \
        & np.isin(it["i_item_sk"], stocked) & np.isin(it["i_item_sk"], sold)
    return _ds_rows({"i_item_id": it["i_item_id"][m],
                     "min_price": it["i_current_price"][m]},
                    [("i_item_id", True)])


def numpy_ds_q37(tables):
    c = _ds_dims(tables)
    return _stocked_items(c, c["catalog_sales"]["cs_item_sk"], 20.0, 50.0,
                          30, 70)


def numpy_ds_q82(tables):
    c = _ds_dims(tables)
    return _stocked_items(c, c["store_sales"]["ss_item_sk"], 30.0, 60.0,
                          10, 50)


def numpy_ds_q85(tables):
    c = _ds_dims(tables)
    ws, wr, cd = c["web_sales"], c["web_returns"], c["customer_demographics"]
    si, ri = _eq_join([ws["ws_order_number"], ws["ws_item_sk"]],
                      [wr["wr_order_number"], wr["wr_item_sk"]])
    c1, c2 = wr["wr_refunded_cdemo_sk"][ri], wr["wr_returning_cdemo_sk"][ri]
    keep = (c["date_dim"]["d_year"][ws["ws_sold_date_sk"][si]] == 1998) \
        & np.isin(c["customer_address"]["ca_state"][
            wr["wr_refunded_addr_sk"][ri]], ["CA", "TX", "OH"]) \
        & (cd["cd_marital_status"][c1] == cd["cd_marital_status"][c2]) \
        & (cd["cd_education_status"][c1] == cd["cd_education_status"][c2])
    si, ri = si[keep], ri[keep]
    (reason,), (q, cash, fee, n) = _groups(
        [c["reason"]["r_reason_desc"][wr["wr_reason_sk"][ri]]],
        ws["ws_quantity"][si], wr["wr_refunded_cash"][ri], wr["wr_fee"][ri])
    return _ds_rows({"r_reason_desc": reason, "avg_qty": q / n,
                     "avg_refund": cash / n, "avg_fee": fee / n},
                    [("r_reason_desc", True)])


def _left_join(lkeys, rkeys):
    """(left rows, right rows) of a left join: the pairs whose key tuples
    are equal, then every left row with none, its right row -1."""
    li, ri = _eq_join(lkeys, rkeys)
    lone = np.setdiff1d(np.arange(len(lkeys[0])), li)
    return np.concatenate([li, lone]), \
        np.concatenate([ri, np.full(len(lone), -1)])


def _returns_above_state_avg(c, ret, p, amount, addr_col, names):
    """q30 and q81: each returning customer's year-2000 returns by the
    return address's state, kept above 1.2 times the state's average."""
    r, d, ca, cu = c[ret], c["date_dim"], c["customer_address"], \
        c["customer"]
    m = d["d_year"][r[f"{p}_returned_date_sk"]] == 2000
    (cust, state), (tot,) = _group_sums(
        [r[f"{p}_returning_customer_sk"][m], ca["ca_state"][r[addr_col][m]]],
        r[amount][m])
    (states,), (s, n) = _groups([state], tot)
    keep = tot > 1.2 * _at(states, s / n, state)
    out = {k: cu[k][cust[keep]] for k in names}
    out["ctr_total"] = tot[keep]
    return _ds_rows(out, [("c_customer_id", True), ("ctr_total", True)])


def numpy_ds_q30(tables):
    return _returns_above_state_avg(
        _ds_dims(tables), "web_returns", "wr", "wr_return_amt",
        "wr_refunded_addr_sk",
        ["c_customer_id", "c_salutation", "c_first_name", "c_last_name"])


def numpy_ds_q81(tables):
    return _returns_above_state_avg(
        _ds_dims(tables), "catalog_returns", "cr", "cr_return_amount",
        "cr_returning_addr_sk",
        ["c_customer_id", "c_first_name", "c_last_name"])


def _stdev(n, mean, sumsq):
    """The queries' sample deviation from the sums, null for one row:
    ``sqrt((sumsq - n * (mean * mean)) / (n - 1))``."""
    nf = n.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        sd = np.sqrt((sumsq - nf * (mean * mean)) / (nf - 1.0))
    return [None if k == 1 else v for k, v in zip(n.tolist(), sd.tolist())]


def numpy_ds_q17(tables):
    c = _ds_dims(tables)
    ss, sr, cs, d = c["store_sales"], c["store_returns"], \
        c["catalog_sales"], c["date_dim"]
    sm = np.flatnonzero((d["d_year"][ss["ss_sold_date_sk"]] == 1998)
                        & (d["d_qoy"][ss["ss_sold_date_sk"]] == 1))
    si, ri = _eq_join([ss[k][sm] for k in ("ss_ticket_number", "ss_item_sk",
                                           "ss_customer_sk")],
                      [sr[k] for k in ("sr_ticket_number", "sr_item_sk",
                                       "sr_customer_sk")])
    si = sm[si]
    rd = sr["sr_returned_date_sk"][ri]
    keep = (d["d_year"][rd] == 1998) & (d["d_qoy"][rd] <= 3)
    si, ri = si[keep], ri[keep]
    pi, ci = _eq_join([sr["sr_customer_sk"][ri], sr["sr_item_sk"][ri]],
                      [cs["cs_bill_customer_sk"], cs["cs_item_sk"]])
    si, ri = si[pi], ri[pi]
    qty = [ss["ss_quantity"][si], sr["sr_return_quantity"][ri],
           cs["cs_quantity"][ci]]
    lanes = []
    for q in qty:
        qd = q.astype(np.float64)
        lanes += [q, qd * qd]
    (item, state), sums = _groups(
        [c["item"]["i_item_id"][ss["ss_item_sk"][si]],
         c["store"]["s_state"][ss["ss_store_sk"][si]]], *lanes)
    n = sums[-1]
    out = {"i_item_id": item, "s_state": state}
    for k, p in enumerate(("ss", "sr", "cs")):
        mean = sums[2 * k] / n
        out.update({f"{p}_count": n, f"{p}_mean": mean,
                    f"{p}_stdev": _stdev(n, mean, sums[2 * k + 1])})
    return _ds_rows(out, [("i_item_id", True), ("s_state", True)])


def numpy_ds_q39(tables):
    c = _ds_dims(tables)
    inv, d = c["inventory"], c["date_dim"]
    moy = d["d_moy"][inv["inv_date_sk"]]
    m = moy <= 5
    q = inv["inv_quantity_on_hand"][m]
    qd = q.astype(np.float64)
    (wh, it, mo), (s, sq, n) = _groups(
        [inv["inv_warehouse_sk"][m], inv["inv_item_sk"][m], moy[m]], q,
        qd * qd)
    mean = s / n
    keep = (n > 1) & (mean > 0.0)
    wh, it, mo, n, mean, sq = (a[keep] for a in (wh, it, mo, n, mean, sq))
    nf = n.astype(np.float64)
    cov = np.sqrt((sq - nf * (mean * mean)) / (nf - 1.0)) / mean
    keep = cov > 0.5
    wh, it, mo, cov = wh[keep], it[keep], mo[keep], cov[keep]
    a, b = _eq_join([wh, it, mo + 1], [wh, it, mo])
    return _ds_rows({"wh1": wh[a], "it1": it[a], "moy1": mo[a],
                     "cov1": cov[a], "moy2": mo[b], "cov2": cov[b]},
                    [("wh1", True), ("it1", True), ("moy1", True)])


def numpy_ds_q21(tables):
    c = _ds_dims(tables)
    inv, it = c["inventory"], c["item"]
    dk, ik = inv["inv_date_sk"], inv["inv_item_sk"]
    m = _between(it["i_current_price"][ik], 5.0, 25.0) \
        & _between(dk, 550, 910)
    q, before = inv["inv_quantity_on_hand"][m], dk[m] < 730
    (wh, item), (b, a) = _group_sums(
        [c["warehouse"]["w_warehouse_name"][inv["inv_warehouse_sk"][m]],
         it["i_item_id"][ik[m]]], np.where(before, q, 0),
        np.where(before, 0, q))
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = a.astype(np.float64) / b.astype(np.float64)
    keep = (b > 0) & (ratio >= 2.0 / 3.0) & (ratio <= 1.5)
    return _ds_rows({"w_warehouse_name": wh[keep], "i_item_id": item[keep],
                     "inv_before": b[keep], "inv_after": a[keep]},
                    [("w_warehouse_name", True), ("i_item_id", True)])


def numpy_ds_q40(tables):
    c = _ds_dims(tables)
    cs, cr, it = c["catalog_sales"], c["catalog_returns"], c["item"]
    dk = cs["cs_sold_date_sk"]
    sm = np.flatnonzero(_between(it["i_current_price"][cs["cs_item_sk"]],
                                 0.99, 1.49) & _between(dk, 700, 760))
    si, ri = _left_join([cs["cs_order_number"][sm], cs["cs_item_sk"][sm]],
                        [cr["cr_order_number"], cr["cr_item_sk"]])
    si = sm[si]
    cash = np.where(ri >= 0, cr["cr_refunded_cash"][ri], 0.0)
    net = cs["cs_sales_price"][si] - cash
    before = dk[si] < 730
    (state, item), (b, a) = _group_sums(
        [c["warehouse"]["w_state"][cs["cs_warehouse_sk"][si]],
         it["i_item_id"][cs["cs_item_sk"][si]]],
        np.where(before, net, 0.0), np.where(before, 0.0, net))
    return _ds_rows({"w_state": state, "i_item_id": item,
                     "sales_before": b, "sales_after": a},
                    [("w_state", True), ("i_item_id", True)])


def numpy_ds_q93(tables):
    c = _ds_dims(tables)
    ss, sr = c["store_sales"], c["store_returns"]
    rm = np.flatnonzero(c["reason"]["r_reason_desc"][sr["sr_reason_sk"]]
                        == "reason 28")
    si, ri = _left_join([ss["ss_ticket_number"], ss["ss_item_sk"]],
                        [sr["sr_ticket_number"][rm], sr["sr_item_sk"][rm]])
    qty = ss["ss_quantity"][si]
    left = np.where(ri >= 0, qty - sr["sr_return_quantity"][rm][ri], qty)
    (cust,), (s,) = _group_sums([ss["ss_customer_sk"][si]],
                                left.astype(np.float64)
                                * ss["ss_sales_price"][si])
    return _ds_rows({"ss_customer_sk": cust, "sumsales": s},
                    [("sumsales", True), ("ss_customer_sk", True)])


def _channel_item_sales(c, d_ok, item_ok, addr_ok=None):
    """q33, q56 and q60: (item rows, extended sales price) of the three
    channels' sales on the days ``d_ok`` of the items ``item_ok`` (and
    to the addresses ``addr_ok``: store, bill and ship address)."""
    items, prices = [], []
    for fact, p, addr in (("store_sales", "ss", "ss_addr_sk"),
                          ("catalog_sales", "cs", "cs_bill_addr_sk"),
                          ("web_sales", "ws", "ws_ship_addr_sk")):
        f = c[fact]
        ik = f[f"{p}_item_sk"]
        m = d_ok[f[f"{p}_sold_date_sk"]] & item_ok[ik]
        if addr_ok is not None:
            m &= addr_ok[f[addr]]
        items.append(ik[m])
        prices.append(f[f"{p}_ext_sales_price"][m])
    return np.concatenate(items), np.concatenate(prices)


def _month(d, year, moy):
    return (d["d_year"] == year) & (d["d_moy"] == moy)


def numpy_ds_q33(tables):
    c = _ds_dims(tables)
    it = c["item"]
    ik, price = _channel_item_sales(c, _month(c["date_dim"], 1998, 5),
                                    it["i_category"] == "Books")
    (mf,), (s,) = _group_sums([it["i_manufact_id"][ik]], price)
    return _ds_rows({"i_manufact_id": mf, "total": s},
                    [("total", True), ("i_manufact_id", True)])


def numpy_ds_q56(tables):
    c = _ds_dims(tables)
    it = c["item"]
    ids = it["i_item_id"][np.isin(it["i_class"],
                                  ["bedding", "classical", "football"])]
    ik, price = _channel_item_sales(
        c, _month(c["date_dim"], 1999, 2), np.isin(it["i_item_id"], ids),
        c["customer_address"]["ca_gmt_offset"] == -5.0)
    (iid,), (s,) = _group_sums([it["i_item_id"][ik]], price)
    return _ds_rows({"i_item_id": iid, "total": s},
                    [("total", True), ("i_item_id", True)])


def numpy_ds_q60(tables):
    c = _ds_dims(tables)
    it = c["item"]
    ik, price = _channel_item_sales(c, _month(c["date_dim"], 1998, 9),
                                    it["i_category"] == "Music")
    (iid,), (s,) = _group_sums([it["i_item_id"][ik]], price)
    return _ds_rows({"i_item_id": iid, "total": s},
                    [("i_item_id", True), ("total", True)])


_WAREHOUSE = ["w_warehouse_name", "w_warehouse_sq_ft", "w_city", "w_county",
              "w_state", "w_country"]


def numpy_ds_q66(tables):
    c = _ds_dims(tables)
    d, wh = c["date_dim"], c["warehouse"]
    sm_ok = np.isin(c["ship_mode"]["sm_carrier"], ["UPS", "DHL"])
    hour_ok = _between(c["time_dim"]["t_hour"], 8, 16)
    whs, moys, values = [], [], []
    for fact, p in (("web_sales", "ws"), ("catalog_sales", "cs")):
        f = c[fact]
        dk = f[f"{p}_sold_date_sk"]
        m = (d["d_year"][dk] == 1998) & hour_ok[f[f"{p}_sold_time_sk"]] \
            & sm_ok[f[f"{p}_ship_mode_sk"]]
        whs.append(f[f"{p}_warehouse_sk"][m])
        moys.append(d["d_moy"][dk[m]])
        values.append(f[f"{p}_quantity"][m].astype(np.float64)
                      * f[f"{p}_ext_sales_price"][m])
    moy, v = np.concatenate(moys), np.concatenate(values)
    (wk,), sums = _group_sums([np.concatenate(whs)], *[
        np.where(moy == k, v, 0.0) for k in range(1, 13)])
    out = {k: wh[k][wk] for k in _WAREHOUSE}
    out.update({f"tot_m{k}": s for k, s in enumerate(sums, 1)})
    return _ds_rows(out, [("w_warehouse_name", True)])


def numpy_ds_q76(tables):
    c = _ds_dims(tables)
    d, it = c["date_dim"], c["item"]
    parts = []
    for fact, p, null_col, channel in (
            ("store_sales", "ss", "ss_promo_sk", "store"),
            ("web_sales", "ws", "ws_ship_customer_sk", "web"),
            ("catalog_sales", "cs", "cs_ship_addr_sk", "catalog")):
        f = c[fact]
        m = ~tables[fact].validity[null_col]
        dk = f[f"{p}_sold_date_sk"][m]
        n = int(m.sum())
        parts.append((np.full(n, channel), np.full(n, null_col),
                      d["d_year"][dk], d["d_qoy"][dk],
                      it["i_category"][f[f"{p}_item_sk"][m]],
                      f[f"{p}_ext_sales_price"][m]))
    cols = [np.concatenate(k) for k in zip(*parts)]
    (ch, cn, yr, qoy, cat), (s, n) = _groups(cols[:5], cols[5])
    keys = ["channel", "col_name", "d_year", "d_qoy", "i_category"]
    out = dict(zip(keys, (ch, cn, yr, qoy, cat)))
    out.update(sales_cnt=n, sales_amt=s)
    return _ds_rows(out, [(k, True) for k in keys])


def numpy_ds_q54(tables):
    c = _ds_dims(tables)
    d, it, ss = c["date_dim"], c["item"], c["store_sales"]
    sold = _month(d, 1999, 3)
    target = (it["i_category"] == "Women") & (it["i_class"] == "dresses")
    custs = [c[f][cust][sold[c[f][date]] & target[c[f][item]]]
             for f, date, item, cust in (
                 ("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                  "cs_bill_customer_sk"),
                 ("web_sales", "ws_sold_date_sk", "ws_item_sk",
                  "ws_bill_customer_sk"))]
    mine = np.zeros(len(c["customer"]["c_customer_sk"]), bool)
    mine[np.concatenate(custs)] = True
    state_ok = np.isin(c["customer_address"]["ca_state"][
        c["customer"]["c_current_addr_sk"]], c["store"]["s_state"])
    ck = ss["ss_customer_sk"]
    m = mine[ck] & state_ok[ck] \
        & _between(d["d_month_seq"][ss["ss_sold_date_sk"]], 15, 17)
    _, (revenue,) = _group_sums([ck[m]], ss["ss_ext_sales_price"][m])
    seg, n = np.unique(np.trunc(revenue / 50.0).astype(np.int64),
                       return_counts=True)
    return _ds_rows({"segment": seg, "num_customers": n.astype(np.int64),
                     "segment_base": seg * 50},
                    [("segment", True), ("num_customers", True)])


def _unreturned_year_sums(c, fact, p, cust_col, order_col, ret, r_order,
                          r_item):
    """q78: the channel's 1998 sales of lines with no return, by customer
    and item: (customer, item, quantity, wholesale cost, sales price)
    sums."""
    f, rt = c[fact], c[ret]
    li, _ = _eq_join([f[order_col], f[f"{p}_item_sk"]],
                     [rt[r_order], rt[r_item]])
    m = c["date_dim"]["d_year"][f[f"{p}_sold_date_sk"]] == 1998
    m[li] = False
    (cust, item), sums = _group_sums(
        [f[cust_col][m], f[f"{p}_item_sk"][m]],
        f[f"{p}_quantity"][m].astype(np.float64),
        f[f"{p}_wholesale_cost"][m], f[f"{p}_sales_price"][m])
    return cust, item, sums


def numpy_ds_q78(tables):
    c = _ds_dims(tables)
    s_cust, s_item, (s_qty, s_wc, s_sp) = _unreturned_year_sums(
        c, "store_sales", "ss", "ss_customer_sk", "ss_ticket_number",
        "store_returns", "sr_ticket_number", "sr_item_sk")
    w_cust, w_item, (w_qty, _, _) = _unreturned_year_sums(
        c, "web_sales", "ws", "ws_bill_customer_sk", "ws_order_number",
        "web_returns", "wr_order_number", "wr_item_sk")
    a, b = _eq_join([s_cust, s_item], [w_cust, w_item])
    keep = w_qty[b] > 0.0
    a, b = a[keep], b[keep]
    return _ds_rows({"ss_cust": s_cust[a], "ss_item": s_item[a],
                     "ratio": s_qty[a] / w_qty[b], "ss_qty": s_qty[a],
                     "ss_wc": s_wc[a], "ss_sp": s_sp[a]},
                    [("ss_qty", False), ("ss_wc", True), ("ss_cust", True),
                     ("ss_item", True)])


_Q75_ATTRS = ["i_brand_id", "i_class_id", "i_category_id", "i_manufact_id"]


def numpy_ds_q75(tables):
    c = _ds_dims(tables)
    it, d = c["item"], c["date_dim"]
    books = it["i_category"] == "Books"
    parts = []
    for fact, p, order, ret, r, r_order, r_qty in (
            ("store_sales", "ss", "ss_ticket_number", "store_returns", "sr",
             "sr_ticket_number", "sr_return_quantity"),
            ("catalog_sales", "cs", "cs_order_number", "catalog_returns",
             "cr", "cr_order_number", "cr_return_quantity"),
            ("web_sales", "ws", "ws_order_number", "web_returns", "wr",
             "wr_order_number", "wr_return_quantity")):
        f, rt = c[fact], c[ret]
        sm = np.flatnonzero(books[f[f"{p}_item_sk"]])
        si, ri = _left_join([f[f"{p}_item_sk"][sm], f[order][sm]],
                            [rt[f"{r}_item_sk"], rt[r_order]])
        si = sm[si]
        hit = ri >= 0
        ik = f[f"{p}_item_sk"][si]
        parts.append(
            [d["d_year"][f[f"{p}_sold_date_sk"][si]]]
            + [it[a][ik] for a in _Q75_ATTRS]
            + [f[f"{p}_quantity"][si].astype(np.float64)
               - np.where(hit, rt[r_qty][ri], 0).astype(np.float64)])
    cols = [np.concatenate(k) for k in zip(*parts)]
    (year, *attrs), (cnt,) = _group_sums(cols[:5], cols[5])
    cur, prev = np.flatnonzero(year == 1999), np.flatnonzero(year == 1998)
    a, b = _eq_join([k[cur] for k in attrs], [k[prev] for k in attrs])
    a, b = cur[a], prev[b]
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = cnt[a] / cnt[b]
    keep = (cnt[b] != 0) & (ratio < 0.9)
    a, b = a[keep], b[keep]
    out = {k: v[a] for k, v in zip(_Q75_ATTRS, attrs)}
    out.update(prev_cnt=cnt[b], curr_cnt=cnt[a],
               sales_cnt_diff=cnt[a] - cnt[b])
    return _ds_rows(out, [("sales_cnt_diff", True), ("i_brand_id", True)])


def _q64_year(c, ui_ok, year, suffix):
    """One year of q64's cross sales: store sales with a return, of items
    whose catalog sales clear their refunds, to customers whose current
    marital status differs from the sale's, by product, item, store and
    zip."""
    ss, sr, cd = c["store_sales"], c["store_returns"], \
        c["customer_demographics"]
    it = c["item"]
    sm = np.flatnonzero(
        ui_ok[ss["ss_item_sk"]]
        & (c["date_dim"]["d_year"][ss["ss_sold_date_sk"]] == year)
        & _between(it["i_current_price"][ss["ss_item_sk"]], 5.0, 85.0)
        & (cd["cd_marital_status"][ss["ss_cdemo_sk"]]
           != cd["cd_marital_status"][c["customer"]["c_current_cdemo_sk"][
               ss["ss_customer_sk"]]]))
    si, _ = _eq_join([ss["ss_ticket_number"][sm], ss["ss_item_sk"][sm]],
                     [sr["sr_ticket_number"], sr["sr_item_sk"]])
    si = sm[si]
    ik, sk = ss["ss_item_sk"][si], ss["ss_store_sk"][si]
    st = c["store"]
    (pn, isk, sn, z), (s1, s2, s3, n) = _groups(
        [it["i_product_name"][ik], ik, st["s_store_name"][sk],
         st["s_zip"][sk]],
        ss["ss_wholesale_cost"][si], ss["ss_list_price"][si],
        ss["ss_coupon_amt"][si])
    return {f"pn{suffix}": pn, f"isk{suffix}": isk, f"sn{suffix}": sn,
            f"zip{suffix}": z, f"cnt{suffix}": n, f"s1{suffix}": s1,
            f"s2{suffix}": s2, f"s3{suffix}": s3}


def numpy_ds_q64(tables):
    c = _ds_dims(tables)
    cs, cr = c["catalog_sales"], c["catalog_returns"]
    si, ri = _eq_join([cs["cs_item_sk"], cs["cs_order_number"]],
                      [cr["cr_item_sk"], cr["cr_order_number"]])
    (items,), (sale, refund) = _group_sums(
        [cs["cs_item_sk"][si]], cs["cs_ext_list_price"][si],
        cr["cr_refunded_cash"][ri] + cr["cr_net_loss"][ri])
    ui_ok = np.zeros(len(c["item"]["i_item_sk"]), bool)
    ui_ok[items[sale > refund]] = True
    y1, y2 = _q64_year(c, ui_ok, 1998, "_1"), _q64_year(c, ui_ok, 1999, "_2")
    a, b = _eq_join([y1["isk_1"], y1["sn_1"], y1["zip_1"]],
                    [y2["isk_2"], y2["sn_2"], y2["zip_2"]])
    keep = y2["cnt_2"][b] <= y1["cnt_1"][a]
    a, b = a[keep], b[keep]
    out = {k: y1[k][a] for k in ("pn_1", "isk_1", "sn_1", "zip_1", "cnt_1",
                                 "s1_1", "s2_1", "s3_1")}
    out.update({k: y2[k][b] for k in ("cnt_2", "s1_2", "s2_2", "s3_2")})
    return _ds_rows(out, [("pn_1", True), ("isk_1", True), ("sn_1", True),
                          ("cnt_2", True)])


def q72_pairs(tables):
    """q72's catalog sales (1999, shipped more than 5 days after the
    sale, households with more than 10000 to spend, divorced buyers)
    against the inventory of their item: (sales rows, inventory rows) of
    every equi pair, the inventory join's pairs."""
    c = _ds_dims(tables)
    cs, d, inv = c["catalog_sales"], c["date_dim"], c["inventory"]
    dk = cs["cs_sold_date_sk"]
    sm = np.flatnonzero(
        (d["d_year"][dk] == 1999)
        & (d["d_date"][cs["cs_ship_date_sk"]] > d["d_date"][dk] + 5)
        & (c["household_demographics"]["hd_buy_potential"][
            cs["cs_bill_hdemo_sk"]] == ">10000")
        & (c["customer_demographics"]["cd_marital_status"][
            cs["cs_bill_cdemo_sk"]] == "D"))
    si, vi = _eq_join([cs["cs_item_sk"][sm]], [inv["inv_item_sk"]])
    return sm[si], vi


def numpy_ds_q72(tables):
    c = _ds_dims(tables)
    cs, d, inv = c["catalog_sales"], c["date_dim"], c["inventory"]
    si, vi = q72_pairs(tables)
    week = d["d_week_seq"][cs["cs_sold_date_sk"][si]]
    keep = (week == d["d_week_seq"][inv["inv_date_sk"][vi]]) \
        & (inv["inv_quantity_on_hand"][vi] < cs["cs_quantity"][si])
    si, vi, week = si[keep], vi[keep], week[keep]
    cr = c["catalog_returns"]
    pi, _ = _left_join([cs["cs_item_sk"][si], cs["cs_order_number"][si]],
                       [cr["cr_item_sk"], cr["cr_order_number"]])
    promo = np.isin(cs["cs_promo_sk"][si[pi]], c["promotion"]["p_promo_sk"])
    (name, wh, wk), (no_promo, with_promo, n) = _groups(
        [c["item"]["i_product_name"][cs["cs_item_sk"][si[pi]]],
         c["warehouse"]["w_warehouse_name"][inv["inv_warehouse_sk"][vi[pi]]],
         week[pi]], (~promo).astype(np.int64), promo.astype(np.int64))
    return _ds_rows({"i_product_name": name, "w_warehouse_name": wh,
                     "d1_week": wk, "no_promo": no_promo,
                     "promo": with_promo, "total_cnt": n},
                    [("total_cnt", False), ("i_product_name", True),
                     ("w_warehouse_name", True), ("d1_week", True)])


def _with(tables, name, **cols) -> dict:
    """The tables with ``name``'s columns ``cols`` replaced."""
    hb = tables[name]
    return dict(tables, **{name: type(hb)(dict(hb.columns, **cols),
                                          hb.schema, dict(hb.validity))})


def ds_tn_stores(tables) -> dict:
    """The tables with every fourth store (0, 4, 8) in Oak Grove, TN: at
    the card's scale and seed no store is in TN (q1) and none in
    Centerville or Oak Grove (q68), so both queries return no row there;
    over these stores they keep rows (the ``ds_q1_tn`` and ``ds_q68_tn``
    cells)."""
    st = tables["store"].columns
    four = np.arange(len(st["s_state"])) % 4 == 0
    return _with(tables, "store", s_state=np.where(four, "TN", st["s_state"]),
                 s_city=np.where(four, "Oak Grove", st["s_city"]))


def ds_q8_zips(tables) -> dict:
    """The tables with every eighth customer preferred and living at an
    address in store 0's zip: q8 keeps the stores of zip prefixes with
    more than 10 preferred customers, which no prefix has at the tests'
    scale (the ``ds_q8_zips`` cell)."""
    cu, ca = tables["customer"].columns, tables["customer_address"].columns
    eighth = np.arange(len(cu["c_customer_sk"])) % 8 == 0
    zips = ca["ca_zip"].copy()
    zips[cu["c_current_addr_sk"][eighth]] = tables["store"].columns[
        "s_zip"][0]
    out = _with(tables, "customer", c_preferred_cust_flag=np.where(
        eighth, "Y", cu["c_preferred_cust_flag"]))
    return _with(out, "customer_address", ca_zip=zips)


def ds_q58_week(tables) -> dict:
    """The tables with the first sale of each channel moved to day 743, in
    q58's week (days 740-747), of store sale 0's item, at an extended
    price of 100.0, and that item's other sales of the week moved to the
    next item: each channel sells it once that week for the same revenue,
    which q58 asks for and no item does at the tests' scale (the
    ``ds_q58_week`` cell)."""
    item = int(tables["store_sales"].columns["ss_item_sk"][0])
    n_item = len(tables["item"].columns["i_item_sk"])
    out = tables
    for t, p in (("store_sales", "ss"), ("catalog_sales", "cs"),
                 ("web_sales", "ws")):
        f = tables[t].columns
        ik = f[f"{p}_item_sk"].copy()
        dk = f[f"{p}_sold_date_sk"].copy()
        price = f[f"{p}_ext_sales_price"].copy()
        ik[_between(dk, 740, 747) & (ik == item)] = (item + 1) % n_item
        ik[0], dk[0], price[0] = item, 743, 100.0
        out = _with(out, t, **{f"{p}_item_sk": ik, f"{p}_sold_date_sk": dk,
                               f"{p}_ext_sales_price": price})
    return out


def ds_q71_managers(tables) -> dict:
    """The tables with every fourth item managed by manager 1, whose
    brands q71 sums (the ``ds_q71_managers`` cell)."""
    it = tables["item"].columns
    return _with(tables, "item", i_manager_id=np.where(
        np.arange(len(it["i_item_sk"])) % 4 == 0, 1, it["i_manager_id"]))


def ds_q53_quarters(tables) -> dict:
    """The tables with the days of the second quarter of months 12-23
    counted in the first quarter: at the card's scale every
    manufacturer's quarterly sums lie within 10 % of their average, so
    q53 returns no row there; over these days its first quarter holds
    half the year (the ``ds_q53_quarters`` cell)."""
    d = tables["date_dim"].columns
    second = _between(d["d_month_seq"], 12, 23) & (d["d_qoy"] == 2)
    return _with(tables, "date_dim", d_qoy=np.where(second, 1, d["d_qoy"]))


def ds_q83_item(tables) -> dict:
    """The tables with the first return of each channel moved to day 735,
    in q83's days (720-750), and to store return 0's item: each channel
    then returns that item in those days, which q83 asks for and no item
    is at the tests' scale (the ``ds_q83_item`` cell)."""
    item = int(tables["store_returns"].columns["sr_item_sk"][0])
    out = tables
    for t, p in (("store_returns", "sr"), ("catalog_returns", "cr"),
                 ("web_returns", "wr")):
        f = tables[t].columns
        ik = f[f"{p}_item_sk"].copy()
        dk = f[f"{p}_returned_date_sk"].copy()
        ik[0], dk[0] = item, 735
        out = _with(out, t, **{f"{p}_item_sk": ik,
                               f"{p}_returned_date_sk": dk})
    return out


def ds_q91_returners(tables) -> dict:
    """The tables with every customer who returned a catalog item in
    November 1999 moved to demographics 0 (married, education unknown),
    household 0 (buy potential unknown) and address 0 (GMT -7), the
    segment q91 reports (the ``ds_q91_returners`` cell)."""
    cr, d = tables["catalog_returns"].columns, tables["date_dim"].columns
    dk = cr["cr_returned_date_sk"]
    nov = (d["d_year"][dk] == 1999) & (d["d_moy"][dk] == 11)
    cu = tables["customer"].columns
    moved = np.isin(cu["c_customer_sk"], cr["cr_returning_customer_sk"][nov])
    out = _with(tables, "customer", **{
        k: np.where(moved, 0, cu[k]) for k in (
            "c_current_cdemo_sk", "c_current_hdemo_sk", "c_current_addr_sk")})
    cd = tables["customer_demographics"].columns
    out = _with(out, "customer_demographics",
                cd_marital_status=np.r_[["M"], cd["cd_marital_status"][1:]],
                cd_education_status=np.r_[["Unknown"],
                                          cd["cd_education_status"][1:]])
    hd = tables["household_demographics"].columns
    out = _with(out, "household_demographics", hd_buy_potential=np.r_[
        ["Unknown"], hd["hd_buy_potential"][1:]])
    ca = tables["customer_address"].columns
    return _with(out, "customer_address",
                 ca_gmt_offset=np.r_[[-7.0], ca["ca_gmt_offset"][1:]])


DS_QUERIES = ("q1", "q3", "q5", "q6", "q7", "q13", "q15", "q18", "q19",
              "q22", "q25", "q26", "q27", "q29", "q34", "q36", "q42", "q44",
              "q46", "q48", "q51", "q52", "q55", "q59", "q61", "q65", "q68",
              "q79", "q86", "q88", "q96", "q97", "q98",
              "q38", "q87", "q14", "q8", "q58", "q71", "q83", "q91", "q47",
              "q57", "q53", "q63", "q89", "q12", "q20", "q49", "q67", "q70",
              "q77", "q80", "q2", "q4", "q11", "q31", "q74", "q10", "q16",
              "q35", "q69", "q94", "q95", "q23", "q24",
              "q9", "q28", "q90", "q32", "q92", "q41", "q84", "q43", "q50",
              "q62", "q99", "q45", "q73", "q37", "q82", "q85", "q30", "q81",
              "q17", "q39", "q21", "q40", "q93", "q33", "q56", "q60", "q66",
              "q76", "q54", "q78", "q75", "q64", "q72")
#: The queries that return no row over the generator's tables at the
#: tests' or the card's scale, once more over tables that give them rows:
#: cell suffix -> (query, the function that makes those tables).
DS_VARIANTS = {"q1_tn": ("q1", ds_tn_stores),
               "q68_tn": ("q68", ds_tn_stores),
               "q8_zips": ("q8", ds_q8_zips),
               "q58_week": ("q58", ds_q58_week),
               "q71_managers": ("q71", ds_q71_managers),
               "q53_quarters": ("q53", ds_q53_quarters),
               "q83_item": ("q83", ds_q83_item),
               "q91_returners": ("q91", ds_q91_returners)}
DS_REFS = {q: globals()[f"numpy_ds_{q}"] for q in DS_QUERIES}
DS_REFS.update({v: (lambda tables, q=q, fn=fn: DS_REFS[q](fn(tables)))
                for v, (q, fn) in DS_VARIANTS.items()})
#: Each TPC-DS query's ORDER BY, as (column, ascending), and its LIMIT
#: (None: none).
DS_ORDER = {
    "q1": ([("c_customer_id", True)], 100),
    "q3": ([("d_year", True), ("sum_agg", False), ("i_brand_id", True)], 100),
    "q5": ([("channel", True), ("id", True)], 100),
    "q6": ([("cnt", True), ("ca_state", True)], 100),
    "q7": ([("i_item_id", True)], 100),
    "q13": ([], None),
    "q15": ([("ca_zip", True)], 100),
    "q18": ([("ca_country", True), ("ca_state", True), ("ca_county", True),
             ("i_item_id", True)], 100),
    "q19": ([("ext_price", False), ("i_brand_id", True),
             ("i_manufact_id", True)], 100),
    "q22": ([("qoh", True), ("i_product_name", True), ("i_brand", True),
             ("i_class", True), ("i_category", True)], 100),
    "q25": ([("i_item_id", True), ("i_item_sk", True), ("s_store_id", True),
             ("s_store_name", True)], 100),
    "q26": ([("i_item_id", True)], 100),
    "q27": ([("i_item_id", True), ("s_state", True)], 100),
    "q29": ([("i_item_id", True), ("i_item_sk", True), ("s_store_id", True),
             ("s_store_name", True)], 100),
    "q34": ([("c_last_name", True), ("c_first_name", True), ("cnt", False),
             ("ss_ticket_number", True)], 100),
    "q36": ([("lochierarchy", False), ("i_category", True),
             ("rank_within_parent", True)], 100),
    "q42": ([("total_sales", False), ("d_year", True),
             ("i_category_id", True), ("i_category", True)], 100),
    "q44": ([("rnk", True)], 100),
    "q46": ([("c_last_name", True), ("c_first_name", True), ("ca_city", True),
             ("bought_city", True), ("ss_ticket_number", True)], 100),
    "q48": ([], None),
    "q51": ([("item_sk", True), ("d_date", True)], 100),
    "q52": ([("d_year", True), ("ext_price", False), ("i_brand_id", True)],
            100),
    "q55": ([("ext_price", False), ("i_brand_id", True)], 100),
    "q59": ([("s_store_name", True), ("week1", True)], 100),
    "q61": ([], None),
    "q65": ([("s_store_name", True), ("i_item_id", True)], 100),
    "q68": ([("c_last_name", True), ("ss_ticket_number", True)], 100),
    "q79": ([("c_last_name", True), ("c_first_name", True), ("city30", True),
             ("profit", True), ("ss_ticket_number", True)], 100),
    "q86": ([("lochierarchy", False), ("i_category", True),
             ("rank_within_parent", True)], 100),
    "q88": ([], None),
    "q96": ([], None),
    "q97": ([], None),
    "q98": ([("i_category", True), ("i_class", True), ("i_item_id", True),
             ("revenueratio", True)], 100),
    "q38": ([], None), "q87": ([], None),
    "q14": ([("lochierarchy", False), ("channel", True), ("ci_brand", True)],
            100),
    "q8": ([("s_store_name", True)], 100),
    "q58": ([("item_id", True), ("ss_rev", True)], 100),
    "q71": ([("ext_price_sum", False), ("i_brand_id", True), ("t_hour", True),
             ("t_minute", True)], 100),
    "q83": ([("item_id", True), ("sr_qty", True)], 100),
    "q91": ([("returns_loss", False), ("cc_call_center_id", True)], 100),
    "q47": ([("sum_sales-avg_monthly_sales", True), ("i_category", True),
             ("i_brand", True), ("s_store_name", True), ("d_moy", True)], 100),
    "q57": ([("sum_sales-avg_monthly_sales", True), ("i_category", True),
             ("i_brand", True), ("cc_name", True), ("d_moy", True)], 100),
    "q53": ([("avg_quarterly", True), ("sum_sales", True),
             ("i_manufact_id", True)], 100),
    "q63": ([("i_manager_id", True), ("avg_monthly", True),
             ("sum_sales", True)], 100),
    "q89": ([("sum_sales-avg_monthly_sales", True), ("s_store_name", True),
             ("i_category", True), ("i_class", True), ("i_brand", True),
             ("d_moy", True)], 100),
    "q12": ([("i_category", True), ("i_class", True), ("i_item_id", True),
             ("revenueratio", True)], 100),
    "q20": ([("i_category", True), ("i_class", True), ("i_item_id", True),
             ("revenueratio", True)], 100),
    "q49": ([("channel", True), ("return_rank", True),
             ("currency_rank", True), ("item", True)], 100),
    "q67": ([("i_category", True), ("rk", True), ("sumsales", False),
             ("i_product_name", True), ("s_store_id", True),
             ("i_class", True), ("i_brand", True), ("d_year", True),
             ("d_qoy", True), ("d_moy", True)], 100),
    "q70": ([("lochierarchy", False), ("s_state", True), ("s_county", True),
             ("total_sum", True)], 100),
    "q77": ([("channel", True), ("id", True), ("sales_sum", True)], 100),
    "q80": ([("channel", True), ("id", True), ("sales_sum", True)], 100),
    "q2": ([("wk1", True)], 100),
    "q4": ([("c_customer_id", True)], 100),
    "q11": ([("c_customer_id", True)], 100),
    "q31": ([("county", True)], 100),
    "q74": ([("c_customer_id", True)], 100),
    "q10": ([("cd_gender", True), ("cd_marital_status", True),
             ("cd_education_status", True), ("cd_dep_count", True)], 100),
    "q16": ([], None),
    "q35": ([("ca_state", True), ("cd_gender", True),
             ("cd_marital_status", True), ("cd_dep_count", True)], 100),
    "q69": ([("cd_gender", True), ("cd_marital_status", True),
             ("cd_education_status", True)], 100),
    "q94": ([], None), "q95": ([], None), "q23": ([], None),
    "q24": ([("c_last_name", True), ("c_first_name", True),
             ("s_store_name", True), ("i_manufact", True)], None),
    "q9": ([], None), "q28": ([], None), "q90": ([], None),
    "q32": ([], None), "q92": ([], None),
    "q41": ([("i_product_name", True)], 100),
    "q84": ([("c_customer_id", True)], 100),
    "q43": ([("s_store_name", True), ("s_store_id", True)], 100),
    "q50": ([("s_store_name", True), ("s_store_id", True)], 100),
    "q62": ([("wh", True), ("sm_type", True), ("web_name", True)], 100),
    "q99": ([("wh", True), ("sm_type", True), ("cc_name", True)], 100),
    "q45": ([("ca_zip", True), ("ca_city", True)], 100),
    "q73": ([("cnt", False), ("c_last_name", True),
             ("ss_ticket_number", True)], 100),
    "q37": ([("i_item_id", True)], 100), "q82": ([("i_item_id", True)], 100),
    "q85": ([("r_reason_desc", True)], 100),
    "q30": ([("c_customer_id", True), ("ctr_total", True)], 100),
    "q81": ([("c_customer_id", True), ("ctr_total", True)], 100),
    "q17": ([("i_item_id", True), ("s_state", True)], 100),
    "q39": ([("wh1", True), ("it1", True), ("moy1", True)], 100),
    "q21": ([("w_warehouse_name", True), ("i_item_id", True)], 100),
    "q40": ([("w_state", True), ("i_item_id", True)], 100),
    "q93": ([("sumsales", True), ("ss_customer_sk", True)], 100),
    "q33": ([("total", True), ("i_manufact_id", True)], 100),
    "q56": ([("total", True), ("i_item_id", True)], 100),
    "q60": ([("i_item_id", True), ("total", True)], 100),
    "q66": ([("w_warehouse_name", True)], 100),
    "q76": ([("channel", True), ("col_name", True), ("d_year", True),
             ("d_qoy", True), ("i_category", True)], 100),
    "q54": ([("segment", True), ("num_customers", True)], 100),
    "q78": ([("ss_qty", False), ("ss_wc", True), ("ss_cust", True),
             ("ss_item", True)], 100),
    "q75": ([("sales_cnt_diff", True), ("i_brand_id", True)], 100),
    "q64": ([("pn_1", True), ("isk_1", True), ("sn_1", True),
             ("cnt_2", True)], None),
    "q72": ([("total_cnt", False), ("i_product_name", True),
             ("w_warehouse_name", True), ("d1_week", True)], 100),
}
#: The float columns of each TPC-DS answer (held to ``REV_RTOL``).
DS_FLOATS = {
    "q3": ["sum_agg"], "q5": ["sales", "returns_", "profit"],
    "q7": ["agg1", "agg2", "agg3", "agg4"],
    "q13": ["avg_qty", "avg_sales", "avg_cost", "sum_cost"],
    "q15": ["sum_sales"], "q18": ["agg1", "agg2", "agg3", "agg4"],
    "q19": ["ext_price"], "q22": ["qoh"],
    "q25": ["store_sales_profit", "store_returns_loss",
            "catalog_sales_profit"],
    "q26": ["agg1", "agg2", "agg3", "agg4"],
    "q27": ["agg1", "agg2", "agg3", "agg4"], "q36": ["gross_margin"],
    "q42": ["total_sales"], "q46": ["amt", "profit"],
    "q51": ["web_sales", "store_sales"], "q52": ["ext_price"],
    "q55": ["ext_price"],
    "q59": [f"r_{d}" for d in _DAYS], "q61": ["promotions", "total", "pct"],
    "q65": ["revenue", "ave"],
    "q68": ["extended_price", "extended_tax", "list_price"],
    "q79": ["amt", "profit"], "q86": ["total_sum"],
    "q98": ["i_current_price", "itemrevenue", "revenueratio"],
    "q14": ["sum_sales"], "q8": ["profit"],
    "q58": ["ss_rev", "cs_rev", "ws_rev"], "q71": ["ext_price_sum"],
    "q83": ["sr_qty", "cr_qty", "wr_qty", "sr_dev", "average"],
    "q91": ["returns_loss"],
    "q47": ["sum_sales", "avg_monthly_sales", "psum", "nsum"],
    "q57": ["sum_sales", "avg_monthly_sales", "psum", "nsum"],
    "q53": ["sum_sales", "avg_quarterly"], "q63": ["sum_sales", "avg_monthly"],
    "q89": ["sum_sales", "avg_monthly_sales"],
    "q12": ["i_current_price", "itemrevenue", "classrevenue", "revenueratio"],
    "q20": ["i_current_price", "itemrevenue", "classrevenue", "revenueratio"],
    "q49": ["return_ratio"], "q67": ["sumsales"], "q70": ["total_sum"],
    "q77": ["sales_sum", "returns_sum", "profit_sum"],
    "q80": ["sales_sum", "returns_sum", "profit_sum"],
    "q2": [f"r_{d}" for d in _DAYS], "q31": ["web_g1", "store_g1"],
    "q35": ["min_dep", "max_dep", "avg_dep"],
    "q16": ["total_ship", "total_profit"],
    "q94": ["total_ship", "total_profit"],
    "q95": ["total_ship", "total_profit"], "q23": ["total"],
    "q24": ["netpaid"],
    "q9": [f"bucket{i}" for i in range(1, 6)],
    "q28": [f"b{i}_lp" for i in range(1, 7)], "q90": ["am_pm_ratio"],
    "q32": ["excess_discount"], "q92": ["excess_discount"],
    "q43": [f"{d}_sales" for d in _DAYS], "q45": ["web_sales"],
    "q37": ["min_price"], "q82": ["min_price"],
    "q85": ["avg_qty", "avg_refund", "avg_fee"],
    "q30": ["ctr_total"], "q81": ["ctr_total"],
    "q17": [f"{p}_{k}" for p in ("ss", "sr", "cs") for k in ("mean",
                                                            "stdev")],
    "q39": ["cov1", "cov2"], "q40": ["sales_before", "sales_after"],
    "q93": ["sumsales"], "q33": ["total"], "q56": ["total"],
    "q60": ["total"], "q66": [f"tot_m{k}" for k in range(1, 13)],
    "q76": ["sales_amt"],
    "q78": ["ratio", "ss_qty", "ss_wc", "ss_sp"],
    "q75": ["prev_cnt", "curr_cnt", "sales_cnt_diff"],
    "q64": ["s1_1", "s2_1", "s3_1", "s1_2", "s2_2", "s3_2"]}


def check_ds(cell: str, got: dict, ref: dict, q: str) -> int:
    """A TPC-DS answer against its numpy reference, both ``{column: list}``
    with ``None`` for a null: the same columns; as many rows as the
    query's LIMIT leaves of the reference's; and, in every run of rows
    whose ORDER BY keys are equal (floats to ``REV_RTOL``), the same rows
    in any order (a run that the LIMIT cuts: rows of the reference's
    run). The keys after the first float key do not split a run: two
    floats that tie in exact arithmetic order by their last bits, which
    differ with the order of the additions (q57's rows 14-15 and 64-65
    at the tests' scale). An ORDER BY key ``"a-b"`` is the float
    ``a - b`` (q47, q57 and q89 order by ``sum_sales -
    avg_monthly_sales``). Keys, strings, counts and dates exact;
    ``DS_FLOATS`` to ``REV_RTOL``. Returns the rows."""
    keys, limit = DS_ORDER[q.split("_")[0]]
    floats = set(DS_FLOATS.get(q.split("_")[0], ()))
    floats |= {k for k, _ in keys if k not in ref}
    run_keys = []
    for k, _ in keys:
        run_keys.append(k)
        if k in floats:
            break
    names = list(ref)
    check(list(got) == names, f"{cell}: columns {list(got)} vs {names}")
    n_ref = len(ref[names[0]])
    n = n_ref if limit is None else min(limit, n_ref)
    n_got = len(got[names[0]])
    check(n_got == n, f"{cell}: {n_got} rows, expected {n}")

    def same(a, b, name):
        if a is None or b is None:
            return a is None and b is None
        if name in floats:
            return a == b or abs(a - b) <= REV_RTOL * abs(b)
        return a == b
    def key(k, r):
        if k in ref:
            return ref[k][r]
        a, b = (ref[c][r] for c in k.split("-"))
        return None if a is None or b is None else a - b
    i = 0
    while i < n:
        j = i + 1
        while j < n_ref and all(same(key(k, j), key(k, j - 1), k)
                                for k in run_keys):
            j += 1
        pool = [[ref[k][r] for k in names] for r in range(i, j)]
        for r in range(i, min(j, n)):
            row = [got[k][r] for k in names]
            hit = next((p for p, want in enumerate(pool)
                        if all(same(a, b, k)
                               for a, b, k in zip(row, want, names))), None)
            check(hit is not None, f"{cell} row {r}: {row} is not among the "
                  f"reference's rows {i}..{j - 1} ({pool[:2]})")
            pool.pop(hit)
        i = j
    return n


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
        elif workload == "ds":
            from spark_rapids_tpu_torch.workloads import tpcds as wl
        elif workload == "mort":
            from spark_rapids_tpu_torch.workloads import mortgage as wl
        else:
            from spark_rapids_tpu_torch.workloads import tpcxbb as wl
        _WORKER_TABLES.clear()
        _WORKER_TABLES[key] = wl.gen_tables(size, seed=seed)
    tables = _WORKER_TABLES[key]
    if workload == "tpch":
        fn = numpy_q3 if q == "q3" else NUMPY_REFS[q]
    elif workload == "ds":
        fn = EXPR_REFS[q[5:]] if q.startswith("expr_") else DS_REFS[q]
        if q[5:] in SEEDED_REFS:
            return task, fn(tables, seed)
    elif workload == "mort":
        fn = MORT_REFS[q]
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
    tasks += [("ds", args.ds_ss_rows, args.seed, q) for q in DS_REFS]
    tasks += [("ds", args.ds_ss_rows, args.seed, f"expr_{c}")
              for c in EXPR_CELLS + COMPLEX_REFS]
    tasks += [("mort", args.mort_perf_rows, MORT_SEED, q)
              for q in MORT_QUERIES]
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
            # on the streaming path: a replayed graph calls no Python
            F = ctx.fusion
            with Capture(KJ, "dense_join") as dj:
                tpcxbb.q05(rebind(F.L, dfs, F.stream)).collect()
            left_calls = [c for c in dj.calls if len(c) > 5
                          and c[5] == "left"]
            t0 = time.perf_counter()
            F.results["bb_q30"] = fusion_cell(
                torch, F, "bb_q30", "any",
                lambda s: tpcxbb.q30(rebind(F.L, dfs, s)),
                lambda got: check_exact("bb_q30", got, refs["q30"],
                                        XBB_FLOATS.get("q30", ())), True)
            F.t_phase += time.perf_counter() - t0
            del dfs, pivot
    return summaries, launches, calls, left_calls


#: The TPC-DS cells whose plan must hold an Expand (rollups) and a full
#: outer join.
DS_EXPAND = ("q18", "q22", "q36", "q86", "q14", "q67", "q70", "q77", "q80")
DS_FULL = ("q51", "q97")
#: The TPC-DS cells that read one subplan from several places, which the
#: planner must plan once (``ReusedExec``).
DS_REUSE = ("q2", "q16", "q23", "q24", "q47", "q57", "q94", "q95", "q28",
            "q90", "q32", "q92", "q30", "q81", "q39", "q56", "q66", "q54",
            "q78", "q75", "q64")
#: The kernels the TPC-DS cells together must launch (no cell sorts on
#: one key without a LIMIT, so none reaches ``sortStep``).
DS_NEED = ("joinProbe", "segmented", "strings")
#: The tables TPC-DS q5 reads (the ``pq_ds_q5`` cell's files).
DS_Q5_TABLES = ("store_sales", "store_returns", "catalog_sales",
                "catalog_returns", "web_sales", "web_returns", "date_dim",
                "store", "catalog_page", "web_site")


def ds_host_rows(hb) -> dict:
    """A collected answer as ``{column: list}``, ``None`` for a null."""
    return {n: [v if ok else None for v, ok in zip(
        np.asarray(hb.columns[n]).tolist(),
        np.asarray(hb.validity[n]).tolist())] for n in hb.columns}


def reused_subplans(plan) -> int:
    """The shared subplans (``ReusedExec`` nodes) of a physical plan."""
    found = set()

    def walk(node):
        if type(node).__name__ == "ReusedExec":
            if id(node) in found:
                return
            found.add(id(node))
        for child in node.children:
            walk(child)
    walk(plan)
    return len(found)


def fusion_ds_cells(torch, ctx, dfs, refs, ss_rows: int, seed: int,
                    futures: dict, n_cust: int) -> None:
    """The fusion phase's TPC-DS cells over the resident tables:
    ``ds_q96`` (must capture; its joins inline), ``ds_q3`` (a top-k
    root: head only) and ``expr_complex`` with its coalesce."""
    F = ctx.fusion
    t0 = time.perf_counter()
    tpcds, L = ctx.tpcds, F.L
    for q, kind in (("q96", "capture"), ("q3", "head")):
        cell = f"ds_{q}"
        F.results[cell] = fusion_cell(
            torch, F, cell, kind,
            lambda s, q=q: tpcds.QUERIES[q](rebind(L, dfs, s)),
            lambda got, q=q, cell=cell: check_ds(
                cell, ds_host_rows(got), refs[q], q), True)
    check(F.results["ds_q96"]["graph_launches"].get("joinProbe", 0) > 0,
          "ds_q96: joinProbe does not replay inside its graph")
    M = ctx.M
    cust = F.session.create_dataframe(customer_array_table(
        M.HostBatch, M.T, n_cust, seed))
    ref = reference(futures, "ds", ss_rows, seed, "expr_complex")

    def build(s):
        return complex_queries(M, rebind(L, dfs, s),
                               L.DataFrame(cust._plan, s))["complex"]()

    def verify(got):
        check_exact("expr_complex", rows_in_order(got, ["store"]), ref,
                    ("e1",))
    F.FU.clear_fused_cache()
    F.results["expr_complex_coalesce"] = fusion_coalesce(
        torch, F, "expr_complex", build, verify)
    F.results["expr_complex"] = fusion_cell(
        torch, F, "expr_complex", "any", build, verify, True)
    F.t_phase += time.perf_counter() - t0


def run_tpcds(torch, ctx, session, wrappers, ss_rows: int, seed: int,
              pq_dir: str, profile: bool, futures: dict):
    """The TPC-DS cells: the port's 99 queries (``ds_q1`` ... ``ds_q99``)
    over tables uploaded from ``tpcds.gen_tables(ss_rows)``, and the
    queries of ``DS_VARIANTS`` once more over their variant tables
    (``ds_q1_tn`` ... ``ds_q91_returners``: only the tables a variant
    changes are uploaded again, for its cell). Each answer against its
    numpy reference (:func:`check_ds`), its rows printed and not empty
    (but those of a query with a variant, whose variant keeps rows);
    each cell's device busy share from one traced warm run (two with
    ``profile``); an Expand in the rollups' per-exec times, a full join
    in q51's and q97's plans, a shared subplan in ``DS_REUSE``'s; q72's
    inventory join's equi pairs (``ShuffledHashJoinExec.equi_pairs``)
    against numpy's count; ``DS_NEED`` launched over the cells; the
    geometric means of the 99 query cells' warm medians and cold times
    (the ``DS_GEOMEAN`` line). Then ``pq_ds_q5``: q5 over the
    ten tables it reads, written by the port's writer into ``pq_dir``
    and scanned with the pipeline on, against the same reference, with
    its scan lines. Returns (summaries, launches, captured calls)."""
    tpcds = ctx.tpcds
    check(sorted(DS_QUERIES) == sorted(tpcds.QUERIES),
          "DS_QUERIES is not the port's TPC-DS suite")
    summaries, launches = {}, {k: 0 for k in wrappers.mods}
    calls = {k: [] for k in wrappers.mods}
    t0 = time.perf_counter()
    tables = tpcds.gen_tables(ss_rows, seed=seed)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    refs = {q: reference(futures, "ds", ss_rows, seed, q) for q in DS_REFS}
    t_ref = time.perf_counter() - t0
    t0 = time.perf_counter()
    dfs = tpcds.load(session, tables)
    torch.cuda.synchronize()
    nbytes = sum(c.validity.numel() + (
        c.data.numel() * c.data.element_size() if c.data is not None
        else c.codes.numel() * 4)
        for df in dfs.values() for c in df._plan.batch.columns)
    print(f"  TPC-DS tables at {ss_rows} store_sales rows: generated "
          f"{t_gen:.1f} s, uploaded {nbytes / 1e9:.3f} GB in "
          f"{time.perf_counter() - t0:.1f} s; waited {t_ref:.1f} s for the "
          f"numpy references; rows " + ", ".join(
              f"{k}={v.num_rows}" for k, v in tables.items()))
    with_variant = {base for base, _ in DS_VARIANTS.values()}
    empty = []
    # the metrics phase's star-join cell, over these resident tables
    ctx.metrics_cells["ds_q3"] = (
        tpcds.QUERIES["q3"](dfs), lambda got: check_ds(
            "ds_q3", ds_host_rows(got), refs["q3"], "q3"), None)

    def record(got_launches, got_calls):
        for k in wrappers.mods:
            launches[k] += got_launches[k]
            calls[k] += got_calls[k]

    for q in DS_REFS:
        cell = f"ds_{q}"
        base = q.split("_")[0]
        query = tpcds.QUERIES[base]
        qdfs = dfs
        if q in DS_VARIANTS:
            vt = DS_VARIANTS[q][1](tables)
            qdfs = dict(dfs, **{n: session.create_dataframe(vt[n])
                                for n in vt if vt[n] is not tables[n]})
            del vt
        build = (lambda query=query, qdfs=qdfs: query(qdfs))
        got_launches, got_calls, summaries[cell], mid = run_query(
            torch, session, wrappers, cell.upper(), build,
            lambda got, q=q, cell=cell: check_ds(cell, ds_host_rows(got),
                                                 refs[q], q), ())
        keys, limit = DS_ORDER[base]
        n_ref = len(next(iter(refs[q].values())))
        n_rows = n_ref if limit is None else min(limit, n_ref)
        if n_rows == 0 and q not in with_variant:
            empty.append(cell)
        top = sorted(mid.items(), key=lambda kv: -kv[1])[:2]
        reused = reused_subplans(session.plan(build()._plan))
        summaries[cell].update(rows=n_rows, top_execs=top, reused=reused)
        print(f"  {cell.upper()}: {n_rows} rows, equal to numpy; largest "
              "execs " + ", ".join(f"{k} {v:.3f} ms" for k, v in top)
              + f"; {reused} shared subplan(s), each run once")
        if base in DS_EXPAND:
            check("ExpandExec" in mid, f"{cell}: no ExpandExec ran")
        if base in DS_FULL:
            plan = session.explain(build()._plan)
            check("ShuffledHashJoin full" in plan,
                  f"{cell} planned no full join:\n{plan}")
        if base in DS_REUSE:
            check(reused > 0, f"{cell} planned its shared subplan twice")
        if q == "q72":
            pairs = summaries[cell]["counters"].get(
                "ShuffledHashJoinExec.equi_pairs")
            want = len(q72_pairs(tables)[0])
            check(pairs == want, f"{cell}: the inventory join expanded "
                  f"{pairs} equi pairs, numpy counts {want}")
            summaries[cell]["equi_pairs"] = pairs
            print(f"  {cell.upper()}: the inventory join expanded {pairs} "
                  f"equi pairs (numpy {want}) before its week and "
                  "quantity filter")
        record(got_launches, got_calls)
        if profile:
            summaries[cell]["busy"] = profile_query(torch, cell, build, mid)
        else:
            summaries[cell]["busy"] = busy_share(torch, cell.upper(), build,
                                                 mid)
        del qdfs, build
    check(not empty, f"{', '.join(empty)} returned no row")
    for k in DS_NEED:
        check(launches[k] > 0, f"{k} was not launched by the TPC-DS cells")
    print(f"  TPC-DS cells' kernel launches (cold runs): {launches}")
    geomean = {"queries": len(DS_QUERIES)}
    for key, name in (("warm_median_ms", "warm_ms"), ("cold_ms", "cold_ms")):
        geomean[name] = float(np.exp(np.mean(np.log(
            [summaries[f"ds_{q}"][key] for q in DS_QUERIES]))))
    summaries["ds_geomean"] = geomean
    print("DS_GEOMEAN " + json.dumps(geomean))

    # the expression library's cells over the same uploaded tables
    expr_summaries, expr_launches, expr_calls = run_exprs(
        torch, ctx, session, wrappers, ss_rows, seed, dfs, profile, futures)
    summaries.update(expr_summaries)
    record(expr_launches, expr_calls)
    cx_summaries, cx_launches, cx_calls = run_complex_cells(
        torch, ctx, session, wrappers, ss_rows, seed, dfs,
        tables["customer"].num_rows, profile, futures)
    summaries.update(cx_summaries)
    record(cx_launches, cx_calls)
    fusion_ds_cells(torch, ctx, dfs, refs, ss_rows, seed, futures,
                    tables["customer"].num_rows)

    # q5 over parquet (BASELINE configuration 1): the ten tables it reads
    # through the port's writer, every collect scanning them.
    t0 = time.perf_counter()
    written = write_sf1_parquet(
        torch, ctx.PE, ctx.ColumnarBatch,
        {n: tables[n] for n in DS_Q5_TABLES}, dfs, pq_dir, "TPC-DS")
    del tables, dfs
    pq_dfs = {n: session.read.parquet(d) for n, d in written["dirs"].items()}
    cell = "pq_ds_q5"
    build = (lambda: tpcds.q5(pq_dfs))
    sn_before = ctx.SN.decompress_pages.launches
    got_launches, got_calls, summaries[cell], mid = run_query(
        torch, session, wrappers, cell.upper(), build,
        lambda got: check_ds(cell, ds_host_rows(got), refs["q5"], "q5"),
        ("joinProbe",))
    sn_calls = ctx.SN.decompress_pages.launches - sn_before
    check(sn_calls > 0 and summaries[cell]["counters"].get(
        "ParquetScanExec.snappy_chunks", 0) > 0,
        f"{cell}: the C++ snappy did not run in the scan")
    top = sorted(mid.items(), key=lambda kv: -kv[1])[:2]
    summaries[cell].update(rows=min(100, len(refs["q5"]["id"])),
                           top_execs=top, snappy_calls=sn_calls,
                           written_s=time.perf_counter() - t0)
    print_scan(cell.upper(), summaries[cell])
    record(got_launches, got_calls)
    if profile:
        summaries[cell]["busy"] = profile_query(torch, cell, build, mid)
    else:
        summaries[cell]["busy"] = busy_share(torch, cell.upper(), build, mid)

    # input_file_name() and the block family over the same store_sales
    # files, grouped by file
    cell = "pq_input_file"
    ss_dir = written["dirs"]["store_sales"]
    paths = sorted(str(p) for p in Path(ss_dir).glob("*.parquet"))
    split = reference(futures, "ds", ss_rows, seed, "expr_input_file")
    want = {"f": np.array(paths), "start": np.zeros(len(paths), np.int64),
            "length": np.array([os.path.getsize(p) for p in paths]),
            **split}
    build = (lambda: input_file_query(ctx.M, session.read.parquet(ss_dir)))
    got_launches, got_calls, summaries[cell], mid = run_query(
        torch, session, wrappers, cell.upper(), build,
        lambda got: check_exact(cell, rows_in_order(got, ["f"]), want,
                                ("profit",)), ())
    record(got_launches, got_calls)
    print_scan(cell.upper(), summaries[cell])
    cell_report(torch, session, cell, build, summaries[cell], mid,
                len(paths), profile,
                extra=f"; {len(paths)} files, block lengths "
                      f"{want['length'].tolist()}")
    return summaries, launches, calls


def rows_in_order(got, keys):
    """The rows of ``got`` sorted by the ``keys`` columns, each by its own
    values (numbers as numbers); without keys, as they are."""
    if not keys:
        return got
    cols = [np.asarray(got.columns[k]) for k in keys]
    order = np.lexsort([c.astype(str) if c.dtype == object else c
                        for c in reversed(cols)])
    return types.SimpleNamespace(
        columns={k: np.asarray(v)[order] for k, v in got.columns.items()},
        validity={k: np.asarray(v)[order] for k, v in got.validity.items()})


def cell_report(torch, session, cell, build, summary, mid, n_rows, profile,
                extra=""):
    """Print a cell's rows, two largest execs and a traced warm run's
    busy share (two traces with ``profile``), into ``summary``."""
    top = sorted(mid.items(), key=lambda kv: -kv[1])[:2]
    summary.update(rows=n_rows, top_execs=top)
    print(f"  {cell.upper()}: {n_rows} rows, equal to numpy; largest "
          "execs " + ", ".join(f"{k} {v:.3f} ms" for k, v in top) + extra)
    if profile:
        summary["busy"] = profile_query(torch, cell, build, mid)
    else:
        summary["busy"] = busy_share(torch, cell.upper(), build, mid)


def run_exprs(torch, ctx, session, wrappers, ss_rows: int, seed: int, dfs,
              profile: bool, futures: dict):
    """The ``expr_*`` cells (:data:`EXPR_CELLS`) over the uploaded TPC-DS
    tables ``dfs``: each family of the expression library at store_sales'
    length over dictionary and flat strings, reduced to a few rows held
    to its numpy reference (exact; ``EXPR_FLOATS`` to ``REV_RTOL``).
    Returns (summaries, launches, captured calls)."""
    queries = expr_queries(ctx.M, dfs)
    summaries, launches = {}, {k: 0 for k in wrappers.mods}
    calls = {k: [] for k in wrappers.mods}
    for name in EXPR_CELLS:
        cell = f"expr_{name}"
        ref = reference(futures, "ds", ss_rows, seed, cell)
        keys = EXPR_KEYS.get(name, [])
        floats = EXPR_FLOATS.get(name, ())
        got_launches, got_calls, summaries[cell], mid = run_query(
            torch, session, wrappers, cell.upper(), queries[name],
            lambda got, cell=cell, ref=ref, keys=keys, floats=floats:
            check_exact(cell, rows_in_order(got, keys), ref, floats), ())
        for k in wrappers.mods:
            launches[k] += got_launches[k]
            calls[k] += got_calls[k]
        cell_report(torch, session, cell, queries[name], summaries[cell],
                    mid, len(next(iter(ref.values()))), profile)
    print(f"  expression cells' kernel launches (cold runs): {launches}")
    return summaries, launches, calls


def check_topk_rows(cell: str, got, ref: dict) -> int:
    """The top-k rows of raw columns against the reference's python
    values, row for row: arrays element by element, structs field by
    field, floats exact. Returns the rows."""
    names = list(ref)
    check(list(got.columns) == names, f"{cell}: columns "
          f"{list(got.columns)} vs {names}")
    n = len(ref[names[0]])
    for name in names:
        vals, ok = got.columns[name], got.validity[name]
        check(len(vals) == n and bool(np.all(ok)),
              f"{cell}: {name} has {len(vals)} rows or nulls, expected {n}")
        for r, (g, w) in enumerate(zip(vals.tolist(), ref[name])):
            check(g == w, f"{cell} row {r} {name}: {g!r} vs {w!r}")
    return n


def check_refusals(M, dfs, session) -> list:
    """On the card's session: an array grouping, join or sort key and
    ``split`` raise ``NotImplementedError`` with the reference's reason
    (nothing falls back). Returns the reasons."""
    A, P, CPX, col = M.A, M.P, M.CPX, M.col
    frame = dfs["store_sales"].select(
        col("ss_item_sk"), CPX.array(col("ss_quantity")).alias("arr"))
    other = frame.select(col("arr").alias("arr2"))
    cases = {
        "grouping key": lambda: frame.group_by(col("arr")).agg(
            A.AggregateExpression(A.Count(), "n")),
        "join key": lambda: frame.join(other, on=P.EqualTo(col("arr"),
                                                           col("arr2"))),
        "sort key": lambda: frame.sort(col("arr")),
        "split": lambda: dfs["customer"].select(M.StringSplit(
            col("c_first_name"), "a").alias("parts"))}
    reasons = []
    for what, build in cases.items():
        try:
            build().collect()
        except NotImplementedError as e:
            reasons.append(str(e))
            check(("_no_complex_keys" in str(e)) if what != "split"
                  else "ARRAY<STRING>" in str(e),
                  f"an array {what} raised without the reference's reason: "
                  f"{e}")
        else:
            fail(f"an array {what} ran on the card instead of raising")
    check(session.device.type == "cuda", "the refusals ran off the card")
    print(f"  refusals on the card: {len(reasons)} NotImplementedError with "
          "the reference's reason (an array grouping, join and sort key, "
          "split)")
    return reasons


def run_complex_cells(torch, ctx, session, wrappers, ss_rows: int,
                      seed: int, dfs, n_cust: int, profile: bool,
                      futures: dict):
    """The ``expr_complex``, ``expr_explode`` (parts a and b) and
    ``expr_nondeterministic`` cells over the uploaded TPC-DS tables, each
    against its numpy reference (exact; float sums to ``REV_RTOL``), and
    their one-run companions: ``expr_complex``'s 1,000 top-k rows of the
    raw array and struct, and ``expr_nondeterministic``'s order-sensitive
    ``rand(7)`` filter. Returns (summaries, launches, captured calls:
    one of each shape a cell, since ``expr_complex`` repeats its gathers
    over 64 exchanged blocks)."""
    M = ctx.M
    t0 = time.perf_counter()
    cust = session.create_dataframe(customer_array_table(
        M.HostBatch, M.T, n_cust, seed))
    print(f"  per-customer arrays: {n_cust} rows uploaded in "
          f"{time.perf_counter() - t0:.1f} s")
    queries = complex_queries(M, dfs, cust)
    refs = {c: reference(futures, "ds", ss_rows, seed, f"expr_{c}")
            for c in COMPLEX_REFS if c != "input_file"}
    summaries, launches = {}, {k: 0 for k in wrappers.mods}
    calls = {k: [] for k in wrappers.mods}
    cells = (("expr_complex", "complex", ["store"], ("e1",),
              ("joinProbe", "strings", "hash")),
             ("expr_explode", "explode", ["pos", "store"], ("s",),
              ("strings",)),
             ("expr_explode_outer", "explode_outer", ["e"], (),
              ("joinProbe",)),
             ("expr_nondeterministic", "nondeterministic", ["p"], ("r",),
              ()))
    for cell, name, keys, floats, need in cells:
        ref = refs[name]
        got_launches, got_calls, summaries[cell], mid = run_query(
            torch, session, wrappers, cell.upper(), queries[name],
            lambda got, cell=cell, ref=ref, keys=keys, floats=floats:
            check_exact(cell, rows_in_order(got, keys), ref, floats), need,
            distinct=True)
        for k in wrappers.mods:
            launches[k] += got_launches[k]
            calls[k] += got_calls[k]
        cell_report(torch, session, cell, queries[name], summaries[cell],
                    mid, len(next(iter(ref.values()))), profile)
    for cell, name, check_fn in (
            ("expr_complex_topk", "complex_topk",
             lambda got: check_topk_rows("expr_complex_topk", got,
                                         refs["complex_topk"])),
            ("expr_nondet_filter", "nondet_filter",
             lambda got: check_exact("expr_nondet_filter", got,
                                     refs["nondet_filter"], ("profit",)))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = queries[name]().collect()
        ms = (time.perf_counter() - t0) * 1e3
        check_fn(got)
        summaries[cell] = {"cold_ms": ms, "rows": got.num_rows}
        print(f"  {cell.upper()}: {got.num_rows} rows equal to numpy, one "
              f"run {ms:.1f} ms")
    summaries["refusals"] = {"reasons": check_refusals(M, dfs, session)}
    print(f"  complex cells' kernel launches (cold runs): {launches}; "
          "calls of distinct shapes captured for phase 4: "
          f"{ {k: len(v) for k, v in calls.items()} }")
    return summaries, launches, calls


class JoinPaths:
    """Records the path each join of a run takes: the direct-address
    table (``joinProbe``, built over either side), the binary search or
    the general matcher (``join_match``)."""

    PATHS = (("dense_join", "joinProbe"),
             ("dense_join_swapped", "joinProbe (swapped)"),
             ("join_match_binsearch", "binary search"),
             ("join_match", "join_match"))

    def __init__(self, KJ):
        self.KJ = KJ
        self.taken = []

    def __enter__(self):
        self.fns = {a: getattr(self.KJ, a) for a, _ in self.PATHS}
        for attr, label in self.PATHS:
            def wrapper(*args, fn=self.fns[attr], label=label, **kwargs):
                self.taken.append(label)
                return fn(*args, **kwargs)
            setattr(self.KJ, attr, wrapper)
        return self

    def __exit__(self, *exc):
        for attr, fn in self.fns.items():
            setattr(self.KJ, attr, fn)


def run_mortgage(torch, ctx, session, wrappers, perf_rows: int,
                 profile: bool, futures: dict):
    """The Mortgage cells ``mort_etl`` and ``mort_features`` over
    ``mortgage.gen_tables(perf_rows, MORT_SEED)`` uploaded to the card:
    each against its numpy reference (keys, strings and counts exact,
    floats to ``REV_RTOL``), its rows, two largest execs and a traced
    run's busy share printed, and the path each of its joins takes;
    ``mort_features``' join on ``EqualTo(loan_id, _fl_id)`` must launch
    ``joinProbe``. Returns (summaries, launches, captured calls)."""
    mortgage = ctx.mortgage
    t0 = time.perf_counter()
    tables = mortgage.gen_tables(perf_rows, seed=MORT_SEED)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    refs = {q: reference(futures, "mort", perf_rows, MORT_SEED, q)
            for q in MORT_QUERIES}
    t_ref = time.perf_counter() - t0
    t0 = time.perf_counter()
    dfs = mortgage.load(session, tables)
    torch.cuda.synchronize()
    nbytes = sum(c.validity.numel() + (
        c.data.numel() * c.data.element_size() if c.data is not None
        else c.codes.numel() * 4)
        for df in dfs.values() for c in df._plan.batch.columns)
    print(f"  Mortgage tables at {perf_rows} performance rows (seed "
          f"{MORT_SEED}): generated {t_gen:.1f} s, uploaded "
          f"{nbytes / 1e9:.3f} GB in {time.perf_counter() - t0:.1f} s; "
          f"waited {t_ref:.1f} s for the numpy references; rows "
          + ", ".join(f"{k}={v.num_rows}" for k, v in tables.items()))
    builds = {"etl": lambda: mortgage.etl(dfs),
              "features": lambda: mortgage.ml_features(dfs)}
    keys = {"etl": ["seller", "score_band"], "features": ["loan_id"]}
    summaries, launches = {}, {k: 0 for k in wrappers.mods}
    calls = {k: [] for k in wrappers.mods}
    for q in MORT_QUERIES:
        cell = f"mort_{q}"
        got_launches, got_calls, summaries[cell], mid = run_query(
            torch, session, wrappers, cell.upper(), builds[q],
            lambda got, q=q, cell=cell: check_exact(
                cell, rows_in_order(got, keys[q]), refs[q], MORT_FLOATS[q]),
            ("joinProbe",) if q == "features" else ())
        for k in wrappers.mods:
            launches[k] += got_launches[k]
            calls[k] += got_calls[k]
        # on the streaming path: a replayed graph calls no Python
        with JoinPaths(ctx.KJ) as paths:
            ctx.fusion.stream.execute(builds[q]()._plan)
        summaries[cell]["join_paths"] = paths.taken
        summaries[cell]["joinProbe_launches"] = got_launches["joinProbe"]
        kind = "USING loan_id" if q == "etl" else "EqualTo(loan_id, _fl_id)"
        cell_report(torch, session, cell, builds[q], summaries[cell], mid,
                    len(next(iter(refs[q].values()))), profile,
                    f"; its join ({kind}) took {paths.taken}, joinProbe "
                    f"launched {got_launches['joinProbe']} time(s) in the "
                    "cold run")
    F = ctx.fusion
    t0 = time.perf_counter()
    F.results["mort_features_pipeline"] = fusion_pipeline(
        torch, F, "mort_features",
        lambda s: mortgage.ml_features(rebind(F.L, dfs, s)), True)
    F.t_phase += time.perf_counter() - t0
    return summaries, launches, calls


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
    (the launch count stays with the wrapped function); with
    ``distinct``, of the first call of each shape (tensor shapes and
    dtypes, other arguments by value)."""

    def __init__(self, module, attr: str, distinct: bool = False):
        self.module, self.attr = module, attr
        self.fn = getattr(module, attr)
        self.calls = []
        self.distinct = distinct
        self.shapes = set()

    def __enter__(self):
        def wrapper(*args):
            if self.distinct:
                key = tuple((tuple(a.shape), str(a.dtype))
                            if hasattr(a, "shape") else a for a in args)
                keep = key not in self.shapes
                self.shapes.add(key)
            else:
                keep = True
            if keep:
                self.calls.append(tuple(a.clone() if hasattr(a, "clone")
                                        else a for a in args))
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


def drive_runs(torch, wrappers, run, verify, distinct: bool = False):
    """The measured sequence of a query or stage: a cold ``run()`` with
    the launch counts set to 0 just before and read just after (and the
    peak device memory reset), one warm run capturing every wrapper's
    calls (with ``distinct``, the first of each shape), then 3 timed warm
    runs; ``verify`` checks every run's result
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
    caps = {k: Capture(*wrappers.mods[k], distinct=distinct)
            for k in wrappers.mods}
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
              shards: int = 0, distinct: bool = False):
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
        drive_runs(torch, wrappers, lambda: build().collect(), verify,
                   distinct)
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


# ---------------------------------------------------------------------------
# The metrics phase: the query-profile and tracing layer over resident cells
# ---------------------------------------------------------------------------

#: cell -> (the kernel family it must launch, or None; span names its
#: trace must hold beyond the session's; whether its float columns are
#: sums the card adds in atomic order, whose last bits may vary from run
#: to run whatever the metrics level, and which are then held to
#: ``REV_RTOL``, as pq_q1's with the pipeline on and off).
METRICS_CELLS = {
    "ds_q3": ("joinProbe", (), True),
    "entry_sf1": ("segmented", (), False),
    "sort": ("sortStep", (), False),
    "q22": ("strings", (), True),
    "q1_hash_str": ("hash", ("shuffle.map",), True),
    "pq_q1": (None, ("pipeline.boundary", "pipeline.decode",
                     "pipeline.wait"), True),
}
#: The three levels the phase compares, run interleaved.
METRICS_LEVELS = ("none", "default", "essential")
#: Warm runs at each level (after one cold run each).
METRICS_RUNS = 5
#: Spans every traced query holds.
SESSION_SPANS = {"session.query", "session.plan", "session.dispatch"}


class SyncCounter:
    """Counts the calls of ``torch.cuda.synchronize`` while open (it wraps
    the function; ``QueryInfo.exec_ms`` calls it once a query)."""

    def __init__(self, torch):
        self.torch, self.n = torch, 0

    def __enter__(self):
        self.orig = self.torch.cuda.synchronize

        def counting(*a, **k):
            self.n += 1
            return self.orig(*a, **k)
        self.torch.cuda.synchronize = counting
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize = self.orig


def metrics_sessions(TorchSession, log_dir: str) -> dict:
    """The phase's three sessions: metrics level NONE; the defaults
    (MODERATE, no trace); ESSENTIAL with tracing, device timing, the event
    log and the trace files in ``log_dir``."""
    return {
        "none": TorchSession({"spark.rapids.tpu.metrics.level": "NONE"},
                             device="cuda"),
        "default": TorchSession(device="cuda"),
        "essential": TorchSession({
            "spark.rapids.tpu.metrics.level": "ESSENTIAL",
            "spark.rapids.tpu.metrics.deviceTiming": True,
            "spark.rapids.tpu.metrics.eventLog.dir": log_dir,
            "spark.rapids.tpu.trace.enabled": True,
            "spark.rapids.tpu.trace.dir": log_dir}, device="cuda")}


def same_answer(cell: str, got, want, atomic: bool) -> bool:
    """``got`` equals ``want`` column for column: validity, integers,
    dates and strings bit for bit, floats bit for bit or, in a cell whose
    float sums run in atomic order, to ``REV_RTOL``. Returns whether every
    column was bit-identical."""
    check(got.schema.names == want.schema.names,
          f"{cell}: columns {got.schema.names} vs {want.schema.names}")
    identical = True
    for i, name in enumerate(want.schema.names):
        g, g_ok = got.column_at(i)
        w, w_ok = want.column_at(i)
        check(len(g) == len(w) and np.array_equal(g_ok, w_ok),
              f"{cell}: {name}'s rows or nulls differ between levels")
        if w.dtype == object:
            check(g.tolist() == w.tolist(), f"{cell}: {name} differs")
        elif g.tobytes() != w.tobytes():
            check(atomic and w.dtype.kind == "f" and bool(np.all(
                np.abs(g - w) <= REV_RTOL * np.abs(w))),
                f"{cell}: {name} differs between metrics levels")
            identical = False
    return identical


def check_profile_tree(cell: str, node: dict, plan) -> int:
    """The profile's tree is the physical plan node for node (names,
    describe strings, children). Returns its nodes."""
    check(node["name"] == plan.node_name()
          and node["describe"] == plan.describe()
          and len(node["children"]) == len(plan.children),
          f"{cell}: profile node {node['name']} ({node['describe']}) does "
          f"not match the plan's {plan.node_name()} ({plan.describe()})")
    return 1 + sum(check_profile_tree(cell, c, p)
                   for c, p in zip(node["children"], plan.children))


def top_nodes(prof, n: int = 3) -> list:
    """The profile's ``n`` nodes (tree and extras) with the most opTime,
    as [name, ms]."""
    times = {}

    def walk(node):
        t = node["metrics"].get("opTime", 0)
        times[node["name"]] = max(times.get(node["name"], 0), t)
        for c in node["children"]:
            walk(c)
    walk(prof.tree)
    for name, m in prof.extras.items():
        times[name] = m.get("opTime", 0)
    top = sorted(times.items(), key=lambda kv: -kv[1])[:n]
    return [[k, round(v / 1e6, 3)] for k, v in top]


def check_trace(cell: str, tracer, log_dir: str, spans) -> int:
    """A traced run: its span tree balanced, holding the session's spans
    and ``spans``, and its exported Chrome file loads back with one
    complete event per span. Returns the spans."""
    tracer.assert_balanced()
    names = {s["name"] for s in tracer.spans}
    missing = (SESSION_SPANS | set(spans)) - names
    check(not missing, f"{cell}: the trace lacks {sorted(missing)}")
    path = Path(log_dir) / f"trace_{tracer.trace_id}.json"
    with open(path, encoding="utf-8") as f:
        chrome = json.load(f)
    xs = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
    check(len(xs) == len(tracer.spans) and chrome["otherData"]["trace_id"]
          == tracer.trace_id, f"{cell}: {path.name} does not load back")
    return len(tracer.spans)


def metrics_cell(torch, TorchSession, eventlog, wrappers, cell, plan, verify,
                 prepare, log_root: str) -> dict:
    """One cell of the metrics phase: a cold run, then ``METRICS_RUNS``
    warm runs, of each of :func:`metrics_sessions`' levels, interleaved.
    Each level's cold answer passes ``verify``, and every run's equals the
    level-NONE cold answer (:func:`same_answer`); at the profiled levels
    the profile tree is the plan, and its ``cuda`` launches equal the
    wrappers' counts over the run (set to 0 just before); at ESSENTIAL
    the trace checks
    (:func:`check_trace`), every launched family's device time above 0,
    and one event-log line per query carrying the profile's plan hash;
    the ``torch.cuda.synchronize`` calls equal at NONE and at the
    defaults. Returns the warm medians and the last ESSENTIAL profile's
    summary."""
    kernel, spans, atomic = METRICS_CELLS[cell]
    log_dir = os.path.join(log_root, cell)
    sessions = metrics_sessions(TorchSession, log_dir)
    if prepare is not None:
        for s in sessions.values():
            prepare(s, plan)
    times = {lv: [] for lv in METRICS_LEVELS}
    syncs = {lv: [] for lv in METRICS_LEVELS}
    want, identical, n_spans, logged = None, True, 0, 0
    for rep in range(1 + METRICS_RUNS):
        for lv in METRICS_LEVELS:
            s = sessions[lv]
            torch.cuda.synchronize()
            wrappers.reset()
            with SyncCounter(torch) as sc:
                t0 = time.perf_counter()
                got = s.execute(plan)
                ms = (time.perf_counter() - t0) * 1e3
            counts = {k: n for k, n in wrappers.counts().items() if n}
            if not rep:
                verify(got)
            if want is None:
                want = got
            identical &= same_answer(cell, got, want, atomic)
            syncs[lv].append(sc.n)
            if rep:
                times[lv].append(ms)
            prof = s.last_query_profile()
            if lv == "none":
                check(prof is None and s.last_trace() is None,
                      f"{cell}: level NONE left a profile or a trace")
                continue
            launched = {k: v["launches"] for k, v in
                        prof.engine["cuda"]["kernels"].items()}
            check(launched == counts, f"{cell} ({lv}): the profile's cuda "
                  f"launches {launched}, the wrappers' {counts}")
            check(kernel is None or counts.get(kernel, 0) > 0,
                  f"{cell}: {kernel} was not launched")
            check_profile_tree(cell, prof.tree, s.plan(plan))
            if lv != "essential":
                continue
            for fam, v in prof.engine["cuda"]["kernels"].items():
                check(v.get("deviceTimeNs", 0) > 0,
                      f"{cell}: {fam} has no device time: {v}")
            n_spans = check_trace(cell, s.last_trace(), log_dir, spans)
            logged += 1
            lines = eventlog.read_all(log_dir)
            check(len(lines) == logged
                  and lines[-1]["plan_hash"] == prof.plan_hash
                  and lines[-1]["query_id"] == prof.query_id,
                  f"{cell}: {len(lines)} event-log lines after {logged} "
                  "queries, or the last is not this query's")
            last = prof
    check(syncs["none"] == syncs["default"],
          f"{cell}: torch.cuda.synchronize calls per run at NONE "
          f"{syncs['none']}, at the defaults {syncs['default']}")
    medians = {f"{lv}_ms": statistics.median(times[lv])
               for lv in METRICS_LEVELS}
    profile = {"top": top_nodes(last), "cuda": last.engine["cuda"]["kernels"],
               "spans": n_spans, "bit_identical": identical}
    print(f"PROFILE {cell} " + json.dumps(profile))
    print(f"  {cell.upper()} at NONE / defaults / ESSENTIAL with trace and "
          f"deviceTiming, warm runs (ms): "
          + ", ".join(f"{lv} {[round(t, 3) for t in times[lv]]}"
                      for lv in METRICS_LEVELS)
          + f"; synchronize calls a run {syncs['none'][-1]} / "
          f"{syncs['default'][-1]} / {syncs['essential'][-1]}; answers "
          + ("bit-identical" if identical else
             f"equal, float sums to {REV_RTOL} (atomic order)"))
    for s in sessions.values():
        s.close()
    return {**medians, "profile": profile,
            "synchronize_per_run": {lv: syncs[lv][-1]
                                    for lv in METRICS_LEVELS}}


def entry_stage_frame(ENTRY, T, HostBatch, A, P, col, lit, session, n: int,
                      key_range: int):
    """The entry stage as a query: the rows of ``entry_columns(n,
    key_range)`` with ``q < 90``, grouped by ``k`` with ``sum(q)``,
    ``count(*)``, ``min(p)`` and ``max(p)``, uploaded to ``session``'s
    device. Returns (the DataFrame, a verify function against
    ``entry_reference``)."""
    cols = ENTRY.entry_columns(n=n, key_range=key_range)
    schema = T.Schema([T.StructField(k, T.LONG) for k in cols])
    df = session.create_dataframe(HostBatch.from_numpy(cols, schema)) \
        .where(P.LessThan(col("q"), lit(90))).group_by("k").agg(
            A.AggregateExpression(A.Sum(col("q")), "_buf0_sum"),
            A.AggregateExpression(A.Count(), "_buf1_count"),
            A.AggregateExpression(A.Min(col("p")), "_buf2_min"),
            A.AggregateExpression(A.Max(col("p")), "_buf3_max"))
    want = ENTRY.entry_reference(cols)

    def verify(got):
        order = np.argsort(got.columns["k"], kind="stable")
        for name, w in want.items():
            g = got.columns[name][order]
            check(len(g) == len(w) and np.array_equal(g, w),
                  f"entry_sf1: {name} {list(g[:6])} vs {list(w[:6])}")
    return df, verify


def sort_path(session, plan) -> None:
    """Start ``plan``'s aggregate on the sort path, as ``entry()``'s
    forward runs it (``dense_mode=1``): the session takes a site's
    learned mode, so the only site is set to 1, as one escalation would
    leave it."""
    session._learned[session._signature(session.plan(plan))] = {0: 1}


def run_metrics_phase(torch, TorchSession, eventlog, wrappers,
                      cells: dict) -> dict:
    """The metrics phase over ``cells`` (cell -> (DataFrame, verify,
    prepare or None)), each through :func:`metrics_cell`; prints the
    ``METRICS_OVERHEAD`` line of warm medians. Trace files and event
    logs go to a temporary directory, removed at the end."""
    check(sorted(cells) == sorted(METRICS_CELLS),
          f"metrics cells {sorted(cells)}")
    log_root = tempfile.mkdtemp(prefix="chip_smoke_metrics_")
    out = {}
    try:
        for cell in METRICS_CELLS:
            df, verify, prepare = cells[cell]
            out[cell] = metrics_cell(torch, TorchSession, eventlog, wrappers,
                                     cell, df._plan, verify, prepare,
                                     log_root)
    finally:
        shutil.rmtree(log_root, True)
    print("METRICS_OVERHEAD " + json.dumps(
        {cell: {k: round(v, 3) for k, v in r.items() if k.endswith("_ms")}
         for cell, r in out.items()}))
    return out


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
# the memory phase
# --------------------------------------------------------------------------

#: The pq_sort_ext cell's budgets: the device store holds fewer than three
#: of lineitem's 1,048,576-row runs (about 90 MB each), the host tier
#: about one, so runs and merge chunks reach both tiers.
EXT_SPILL_BUDGET = 256 << 20
EXT_SORT_THRESHOLD = 64 << 20
EXT_HOST_STORAGE = 128 << 20
#: Buffers of the CRC32C check: (count, largest size + 1).
CRC_BUFFERS = (1000, 65_538)
#: The window threshold of oom_inject_bb_q30 (its window input passes it).
XBB_WINDOW_THRESHOLD = 1 << 22


def _gbps(nbytes: int, ns: int) -> float:
    return nbytes / ns if ns > 0 else 0.0


def _flip_byte(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x20]))


def memory_spill_roundtrip(torch, M, li_batch, spill_dir, smi) -> dict:
    """``spill_roundtrip``: all of lineitem as one batch through a catalog
    device -> host -> disk -> device, bit for bit, each transition's GB/s
    printed; a flipped byte of its disk range raises ChecksumError."""
    SP, CK, HostBatch = M.SP, M.CK, M.HostBatch
    want = HostBatch.from_device(li_batch)
    cat = SP.BufferCatalog(1 << 40, 1 << 40, spill_dir,
                           device=li_batch.device)
    bid = cat.register_batch(li_batch)
    torch.cuda.synchronize()
    # a first trip device -> host -> device: the cold copy (the pinned
    # buffer's first allocation) and the host tier's restore
    cat.spill_below(SP.ACTIVE_ON_DECK_PRIORITY)
    check(cat.tier_of(bid) == SP.StorageTier.HOST,
          "spill_roundtrip: the batch did not reach the host tier")
    host_columns_equal(HostBatch.from_device(cat.acquire_batch(bid)), want,
                       "spill_roundtrip device -> host -> device")
    m0 = dict(cat.metrics)
    out = {"device_bytes": SP.device_size_bytes(li_batch),
           "device_to_host_cold_GBps": _gbps(m0["device_to_host_bytes"],
                                             m0["device_to_host_ns"]),
           "host_to_device_GBps": _gbps(m0["host_to_device_bytes"],
                                        m0["host_to_device_ns"])}
    # then device -> host -> disk -> device
    cat.spill_below(SP.ACTIVE_ON_DECK_PRIORITY)
    cat.host_budget = 0
    cat.enforce_budgets()
    check(cat.tier_of(bid) == SP.StorageTier.DISK,
          "spill_roundtrip: the batch did not reach the disk tier")
    offset, length = cat.disk_range_of(bid)
    out["disk_bytes"] = length
    # the spilled payload, for the CRC's rate
    payload = np.fromfile(cat.spill_file.path, np.uint8, length, "", offset)
    back = cat.acquire_batch(bid)
    torch.cuda.synchronize()
    host_columns_equal(HostBatch.from_device(back), want,
                       "spill_roundtrip device -> host -> disk -> device")
    del back
    m = dict(cat.metrics)
    for t in ("device_to_host", "host_to_disk", "disk_to_device"):
        nbytes = m[t + "_bytes"] - m0[t + "_bytes"]
        ns = m[t + "_ns"] - m0[t + "_ns"]
        out[t + "_GBps"] = _gbps(nbytes, ns)
        out[t + "_ms"] = ns / 1e6
    cat.free(bid)
    cat.close()
    bad = SP.BufferCatalog(0, 0, spill_dir, device=li_batch.device)
    bid = bad.register_batch(li_batch)
    off, ln = bad.disk_range_of(bid)
    _flip_byte(bad.spill_file.path, off + ln // 2)
    try:
        bad.acquire_batch(bid)
        fail("spill_roundtrip: a flipped byte was read back without "
             "ChecksumError")
    except CK.ChecksumError as e:
        out["checksum_error"] = str(e)[:120]
    bad.free(bid)
    bad.close()
    print(f"  SPILL_ROUNDTRIP {at()}: lineitem's {len(li_batch.columns)} "
          f"columns "
          f"({out['device_bytes'] / 1e9:.3f} GB on the card, "
          f"{length / 1e9:.3f} GB on disk) device -> host "
          f"{out['device_to_host_GBps']:.2f} GB/s (pinned, side stream; "
          f"{out['device_to_host_cold_GBps']:.2f} GB/s the first time), "
          f"host -> disk {out['host_to_disk_GBps']:.2f} GB/s (serialize, "
          f"CRC32C, append), disk -> device "
          f"{out['disk_to_device_GBps']:.2f} GB/s (read, verify, upload), "
          f"host -> device {out['host_to_device_GBps']:.2f} GB/s; bit for "
          f"bit equal; a flipped byte raised ChecksumError; card {smi}")
    return out, payload


def memory_crc(M, payload, smi) -> dict:
    """The C++ CRC32C against the plain version on CRC_BUFFERS random
    buffers and the check vectors (its time there beside the plain
    version's and the host's read rate), then its GB/s over the spilled
    payload."""
    CK = M.CK
    rng = np.random.default_rng(7)
    n_buf, top = CRC_BUFFERS
    bufs = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(0, top, n_buf)]
    vectors = {b"": 0, b"123456789": 0xE3069283, bytes(32): 0x8A9136AA,
               bytes([0xFF] * 32): 0x62A8AB43,
               bytes(range(32)): 0x46DD794E}
    for data, crc in vectors.items():
        check(CK.crc32c_native(data) == crc == CK.crc32c_plain(data),
              f"crc32c check vector {data[:9]!r}")
    for b in bufs:
        check(CK.crc32c_native(b) == CK.crc32c_plain(b) ==
              CK.crc32c_native(b, tables_only=True),
              f"crc32c differs from the plain version at {len(b)} bytes")
    # from 8 MiB up the routine cuts the buffer into pieces on threads
    big = rng.integers(0, 256, 24_000_007, dtype=np.uint8)
    check(CK.crc32c_native(big, 7) == CK.crc32c_plain(big, 7),
          "crc32c differs from the plain version on 24,000,007 bytes")
    total = sum(len(b) for b in bufs)
    times, plain = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        for b in bufs:
            CK.crc32c_native(b)
        times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for b in bufs:
        CK.crc32c_plain(b)
    plain.append((time.perf_counter() - t0) * 1e3)
    big = np.ones(1 << 30, np.uint8)
    reads = []
    for _ in range(3):
        t0 = time.perf_counter()
        big.view(np.uint64).sum()
        reads.append(time.perf_counter() - t0)
    read_gbs = big.nbytes / min(reads) / 1e9
    del big
    out = {"buffers": n_buf, "bytes": total, "ms": statistics.median(times),
           "plain_ms": plain[0], "read_GBps": read_gbs,
           "bound_ms": total / (read_gbs * 1e9) * 1e3,
           "sse42": CK.hardware_path()}
    if payload is not None:
        pt = []
        for tables_only in (False, True):
            t0 = time.perf_counter()
            CK.crc32c_native(payload, tables_only=tables_only)
            pt.append(time.perf_counter() - t0)
        out["payload_bytes"] = int(payload.nbytes)
        out["payload_GBps"] = payload.nbytes / pt[0] / 1e9
        out["payload_tables_GBps"] = payload.nbytes / pt[1] / 1e9
    print(f"  CRC32C (host C++, {'SSE4.2' if out['sse42'] else 'tables'}) "
          f"equal to the plain version on {n_buf} buffers of 0-"
          f"{top - 1} bytes, one of 24,000,007 (threads) and "
          f"{len(vectors)} check vectors: "
          f"{out['ms']:.3f} ms over {total / 1e6:.1f} MB (plain "
          f"{out['plain_ms']:.1f} ms, bound {out['bound_ms']:.3f} ms at the "
          f"host's one-thread read rate {read_gbs:.2f} GB/s); over the "
          f"spilled payload ({out.get('payload_bytes', 0) / 1e9:.3f} GB, "
          f"threads) {out.get('payload_GBps', 0):.2f} GB/s, slicing-by-8 "
          f"on one thread {out.get('payload_tables_GBps', 0):.2f} GB/s; "
          f"card {smi}")
    return out


def _node_metric(tree: dict, name: str, metric: str):
    """``metric`` of the first node called ``name`` in a profile tree."""
    if tree["name"] == name:
        return tree["metrics"].get(metric)
    for c in tree["children"]:
        v = _node_metric(c, name, metric)
        if v is not None:
            return v
    return None


def _lineitem_row_order(cols) -> np.ndarray:
    """lineitem's rows ordered by (l_shipdate, l_orderkey, l_partkey,
    l_suppkey), two packed int64 keys (no l_linenumber is generated);
    rows tied on those four fall back to every numeric column."""
    a = {n: np.asarray(cols[n]).astype(np.int64) for n in
         ("l_shipdate", "l_orderkey", "l_partkey", "l_suppkey")}
    k1 = (a["l_shipdate"] << 32) | a["l_orderkey"]
    k2 = (a["l_partkey"] << 32) | a["l_suppkey"]
    order = np.lexsort([k2, k1])
    tied = (np.diff(k1[order]) == 0) & (np.diff(k2[order]) == 0)
    if not tied.any():
        return order
    numeric = [np.asarray(cols[n]) for n in cols
               if np.asarray(cols[n]).dtype.kind in "iuf"]
    return np.lexsort(numeric[::-1] + [k2, k1])


def _check_lineitem_rows(got, li, want, cell: str) -> None:
    """Every column of ``got`` equal to lineitem's (``li``) once both
    sides are ordered by :func:`_lineitem_row_order` (``want``: lineitem's
    columns in that order, made once): floats bit for bit, validity all
    true; ``l_shipdate`` non-decreasing in ``got``'s own order."""
    ship = np.asarray(got.columns["l_shipdate"])
    check(len(ship) == li.num_rows and bool(np.all(ship[1:] >= ship[:-1])),
          f"{cell}: l_shipdate decreases")
    g_order = _lineitem_row_order(got.columns)
    for n in li.columns:
        g = np.asarray(got.columns[n])[g_order]
        w = want[n]
        if w.dtype.kind in "OU":
            same = len(g) == len(w) and bool(np.all(g == w))
        elif w.dtype.kind == "f":
            same = np.array_equal(g.view(np.int64), w.view(np.int64))
        else:
            same = np.array_equal(g, w)
        check(same and bool(np.all(got.validity[n])),
              f"{cell}: column {n} differs from numpy's")


def _lineitem_want(li) -> dict:
    order = _lineitem_row_order(li.columns)
    return {n: np.asarray(li.columns[n])[order] for n in li.columns}


def memory_sort_ext(torch, M, wrappers, lineitem_dir, tables, spill_dir,
                    smi) -> dict:
    """``pq_sort_ext``: lineitem's parquet files (one run per row group)
    ordered by l_shipdate through the external sort, runs spilled to host
    and disk; equal to numpy's rows once both sides are ordered by
    :func:`_lineitem_row_order`."""
    conf = {"spark.rapids.memory.tpu.spillBudgetBytes": EXT_SPILL_BUDGET,
            "spark.rapids.sql.sort.externalThresholdBytes":
            EXT_SORT_THRESHOLD,
            "spark.rapids.memory.host.spillStorageSize": EXT_HOST_STORAGE,
            "spark.rapids.memory.tpu.spillDir": spill_dir}
    s = M.TorchSession(conf, device=M.device)
    li = tables["lineitem"]
    want = _lineitem_want(li)
    runs = []
    for label in ("cold", "warm"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2 ** 30
        wrappers.reset()
        t0 = time.perf_counter()
        got = s.read.parquet(lineitem_dir).sort("l_shipdate").collect()
        ms = (time.perf_counter() - t0) * 1e3
        launches = wrappers.counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = s.last_query_profile()
        eng = prof.engine
        n_runs = _node_metric(prof.tree, "SortExec", "sortRuns") or 0
        check(_node_metric(prof.tree, "SortExec", "externalSort") == 1,
              "pq_sort_ext did not take the external sort")
        check(eng["spillBytes"] > 0 and eng["spillBytesToDisk"] > 0
              and eng["spillBytesToHost"] > 0,
              f"pq_sort_ext: runs did not reach host and disk: {eng}")
        check(launches["sortStep"] >= n_runs > 1,
              f"pq_sort_ext: sortStep launched {launches['sortStep']} "
              f"times over {n_runs} runs")
        _check_lineitem_rows(got, li, want, "pq_sort_ext")
        runs.append({"ms": ms, "peak_gib": peak, "resident_gib": resident,
                     "runs": n_runs,
                     "merge_steps": _node_metric(prof.tree, "SortExec",
                                                 "mergeSteps"),
                     "sortStep_launches": launches["sortStep"],
                     "spill_bytes_to_host": eng["spillBytesToHost"],
                     "spill_bytes_to_disk": eng["spillBytesToDisk"],
                     "transitions": eng["spillTransitions"],
                     "retry": eng["retry"]})
        print(f"  PQ_SORT_EXT {label} {at()}: {ms:.1f} ms, "
              f"{li.num_rows} rows equal to numpy's, {n_runs} runs, "
              f"{runs[-1]['merge_steps']} merge steps, sortStep "
              f"{launches['sortStep']} launches, spilled "
              f"{eng['spillBytesToHost'] / 1e9:.3f} GB to host and "
              f"{eng['spillBytesToDisk'] / 1e9:.3f} GB to disk, peak "
              f"device memory {peak:.2f} GiB ({peak - resident:.2f} above "
              f"the {resident:.2f} GiB resident before it); transitions "
              + json.dumps({k: round(v["GBps"], 3) for k, v in
                            eng["spillTransitions"].items()}) + " GB/s")
    print(f"  PQ_SORT_EXT budgets: spillBudgetBytes={EXT_SPILL_BUDGET}, "
          f"externalThresholdBytes={EXT_SORT_THRESHOLD}, "
          f"spillStorageSize={EXT_HOST_STORAGE}; card {smi}")
    return {"cold": runs[0], "warm": runs[1],
            "spillBudgetBytes": EXT_SPILL_BUDGET,
            "externalThresholdBytes": EXT_SORT_THRESHOLD,
            "spillStorageSize": EXT_HOST_STORAGE}


INJECT = {"spark.rapids.tpu.test.faultInjection.sites": "*",
          "spark.rapids.tpu.test.faultInjection.oomEveryN": -1}


def memory_inject_cell(torch, M, wrappers, cell, conf, build, check_fn,
                       need, split: bool = False) -> dict:
    """One ``oom_inject_*`` cell: a session of its own (the injector
    counts visits per session), one run with the kernel counts set to 0
    just before and read just after; the answer checked, retries (and
    splits) recorded, ``need`` launched."""
    s = M.TorchSession(conf, device=M.device)
    wrappers.reset()
    t0 = time.perf_counter()
    got = build(s).collect()
    ms = (time.perf_counter() - t0) * 1e3
    launches = wrappers.counts()
    check_fn(got)
    prof = s.last_query_profile()
    retry = prof.engine["retry"]
    visits = s._fault_injector.visits()
    check(retry["retryCount"] > 0, f"{cell}: no retry was recorded")
    check(not split or retry["splitAndRetryCount"] > 0,
          f"{cell}: the probe never split")
    for k in need:
        check(launches[k] > 0, f"{cell}: {k} was not launched")
    chunked = _node_metric(prof.tree, "WindowExec", "chunkedWindow") or 0
    print(f"  {cell.upper()} {at()}: {ms:.1f} ms, answer equal to numpy's; "
          f"{len(visits)} sites visited ({sum(visits.values())} visits, "
          f"{s._fault_injector.injected['oom']} injected OOMs), retries "
          f"{retry['retryCount']}, splits {retry['splitAndRetryCount']}, "
          f"spilled {prof.engine['spillBytes']} bytes, chunked window "
          f"pieces {chunked}; launches "
          + json.dumps({k: v for k, v in launches.items() if v}))
    return {"ms": ms, "sites": sorted(visits), "visits": sum(visits.values()),
            "retry": retry, "launches": launches,
            "spill_bytes": prof.engine["spillBytes"],
            "chunked_windows": chunked}


def memory_real_oom(torch, M, lineitem_dir, tables, spill_dir, smi) -> dict:
    """``real_oom``: pq_sort_ext's external sort with a device budget that
    never spills on its own, run once uncapped (its peak printed), then
    again with a per-process allocator cap set when run generation
    starts, at the memory reserved then plus one input batch: below the
    uncapped peak and below what sorting that batch needs, so a real
    torch.OutOfMemoryError is raised inside a retry site (no injection),
    classified OOM and recovered by spilling the inputs. The cap is reset
    to 1.0 in a ``finally``."""
    R, SortExec = M.R, M.E.SortExec
    conf = {"spark.rapids.memory.tpu.spillBudgetBytes": 1 << 40,
            "spark.rapids.sql.sort.externalThresholdBytes":
            EXT_SORT_THRESHOLD,
            "spark.rapids.memory.host.spillStorageSize": 64 << 30,
            "spark.rapids.memory.tpu.spillDir": spill_dir,
            "spark.rapids.tpu.retry.backoffBaseMs": 0}
    s = M.TorchSession(conf, device=M.device)
    total = torch.cuda.mem_get_info()[1]
    real = {"n": 0}
    cap = {}
    classify, generate = R.classify, SortExec._generate_run

    def counting(exc):
        if isinstance(exc, torch.OutOfMemoryError) \
                and not isinstance(exc, M.FI.InjectedFault):
            real["n"] += 1
        return classify(exc)

    def capped_generate(self, ctx, catalog, sorter, bid):
        if not cap:
            batch_bytes = M.SP.device_size_bytes(catalog.acquire_batch(bid))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            cap["reserved"] = torch.cuda.memory_reserved()
            cap["batch"] = batch_bytes
            cap["bytes"] = cap["reserved"] + batch_bytes
            torch.cuda.set_per_process_memory_fraction(cap["bytes"] / total)
        return generate(self, ctx, catalog, sorter, bid)

    want = _lineitem_want(tables["lineitem"])

    def run():
        got = s.read.parquet(lineitem_dir).sort("l_shipdate").collect()
        _check_lineitem_rows(got, tables["lineitem"], want, "real_oom")
        return s.last_query_profile()

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_reserved()
    run()
    peak = torch.cuda.max_memory_reserved()
    R.classify, SortExec._generate_run = counting, capped_generate
    t0 = time.perf_counter()
    try:
        prof = run()
    finally:
        R.classify, SortExec._generate_run = classify, generate
        torch.cuda.set_per_process_memory_fraction(1.0)
    ms = (time.perf_counter() - t0) * 1e3
    retry = prof.engine["retry"]
    spilled = prof.engine["spillBytes"]
    # retries of the session's dispatch (a whole re-run) are not a site's
    at_sites = retry["retryCount"] - prof.extras.get(
        "TorchSession", {}).get("retryCount", 0)
    check(cap["bytes"] < peak, f"real_oom: the cap {cap['bytes']} is not "
          f"below the uncapped peak {peak}")
    check(real["n"] > 0 and at_sites > 0 and spilled > 0,
          f"real_oom: no real OOM was recovered at a retry site (OOMs "
          f"{real['n']}, {retry}, spilled {spilled})")
    print(f"  REAL_OOM {at()}: uncapped peak {peak / 2**30:.3f} GiB "
          f"reserved (resident before {resident / 2**30:.3f}); cap "
          f"{cap['bytes'] / 2**30:.3f} GiB = {cap['reserved'] / 2**30:.3f} "
          f"reserved when run generation starts + one input batch "
          f"({cap['batch'] / 2**30:.3f}): {real['n']} real "
          f"torch.OutOfMemoryError(s) classified OOM and recovered, "
          f"{at_sites} retries at the sort's retry sites "
          f"({retry['retryCount']} in all), spilled {spilled / 1e9:.3f} GB, "
          f"{ms:.1f} ms, answer sorted and equal to numpy's rows; card "
          f"{smi}")
    return {"uncapped_peak_reserved_bytes": peak,
            "resident_reserved_bytes": resident, "cap_bytes": cap["bytes"],
            "input_batch_bytes": cap["batch"], "real_ooms": real["n"],
            "site_retries": at_sites,
            "retry": retry, "spill_bytes": spilled, "ms": ms}


def run_real_oom_process(lineitem_dir, tables, seed: int) -> dict:
    """``real_oom`` in a process of its own (this script with
    ``--real-oom``), so the cap meets an allocator that earlier phases
    did not fragment; its report is the child's last line."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--real-oom",
         lineitem_dir, "--lineitem-rows", str(tables["lineitem"].num_rows),
         "--seed", str(seed)], capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line)
    check(proc.returncode == 0 and lines,
          f"real_oom: the child exited {proc.returncode}: "
          f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    out = json.loads(lines[-1])
    out["process_s"] = time.perf_counter() - t0
    return out


def real_oom_main(args) -> int:
    """``--real-oom DIR``: the real_oom cell alone over lineitem's files
    in DIR; its JSON report is the last line."""
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available; this smoke run needs an NVIDIA GPU")
    from spark_rapids_tpu_torch.workloads import tpch
    M = memory_modules()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    tables = {"lineitem": tpch.gen_tables(
        args.lineitem_rows, seed=args.seed)["lineitem"]}
    spill_dir = tempfile.mkdtemp(prefix="chip_smoke_spill_")
    try:
        out = memory_real_oom(torch, M, args.real_oom, tables, spill_dir,
                              smi)
    finally:
        shutil.rmtree(spill_dir, True)
    print(json.dumps(out))
    return 0


def memory_modules():
    """The port's modules the memory phase reads, as one namespace."""
    from spark_rapids_tpu_torch.data.batch import HostBatch
    from spark_rapids_tpu_torch.exec import execs as E
    from spark_rapids_tpu_torch.memory import retry as MR
    from spark_rapids_tpu_torch.memory import spill as MSP
    from spark_rapids_tpu_torch.memory.semaphore import SemaphoreTimeoutError
    from spark_rapids_tpu_torch.plan import logical as L
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.utils import checksum as MCK
    from spark_rapids_tpu_torch.utils import deadline as MD
    from spark_rapids_tpu_torch.utils import fault_injection as MFI
    from spark_rapids_tpu_torch.workloads import tpch, tpcxbb
    return types.SimpleNamespace(
        SP=MSP, CK=MCK, R=MR, D=MD, FI=MFI, E=E, HostBatch=HostBatch,
        TorchSession=TorchSession, tpch=tpch, tpcxbb=tpcxbb,
        SemaphoreTimeoutError=SemaphoreTimeoutError, device="cuda",
        rebind=lambda frames, s: {k: L.DataFrame(v._plan, s)
                                  for k, v in frames.items()})


def memory_deadline(torch, M, dfs, ref3) -> dict:
    """``deadline``: Q3 with a deadline far below its time raises
    QueryDeadlineExceeded naming a site within the deadline plus 1 s; the
    same session then runs Q3 to numpy's answer."""
    s = M.TorchSession({"spark.rapids.tpu.query.deadlineSecs": 0.002},
                       device=M.device)
    q3 = lambda: M.tpch.q3(M.rebind(dfs, s))  # noqa: E731
    t0 = time.perf_counter()
    try:
        q3().collect()
        fail("deadline: Q3 finished inside a 2 ms deadline")
    except M.D.QueryDeadlineExceeded as e:
        wall = time.perf_counter() - t0
        err = e
    check(wall <= 0.002 + 1.0 and err.site,
          f"deadline: raised after {wall:.3f} s at {err.site!r}")
    check(s.device_manager.semaphore.holders() == {},
          "deadline: the cancelled query kept its semaphore slot")
    s.set_conf("spark.rapids.tpu.query.deadlineSecs", 0.0)
    got = q3().collect()
    check_top("Q3", got, ref3, ["o_orderkey", "o_orderdate"], "revenue", 10)
    print(f"  DEADLINE {at()}: Q3 under a 2 ms deadline raised "
          f"QueryDeadlineExceeded after {wall * 1e3:.1f} ms at "
          f"'{err.site}' (slowest site '{err.slowest_site}'); the same "
          "session then answered Q3 equal to numpy's")
    return {"wall_ms": wall * 1e3, "site": err.site,
            "slowest_site": err.slowest_site}


def memory_semaphore(torch, M, dfs, refs) -> dict:
    """``semaphore``: two threads run Q6 through one slot, both correct,
    a profile with semaphoreWaitNs > 0; an acquireTimeout of 0.05 s
    against a held slot raises SemaphoreTimeoutError naming the
    holder."""
    import threading
    s = M.TorchSession({"spark.rapids.sql.concurrentTpuTasks": 1},
                       device=M.device)
    q6 = M.rebind(dfs, s)
    waits, errors = [], []
    barrier = threading.Barrier(2)

    def worker():
        try:
            barrier.wait()
            for _ in range(4):
                got = M.tpch.q6(q6).collect()
                check_answer("q6", got, refs["q6"])
                waits.append(s.last_query_profile().engine[
                    "semaphoreWaitNs"])
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=worker, name=f"q6-{i}")
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, f"semaphore: {errors}")
    check(max(waits) > 0, f"semaphore: no query waited: {waits}")
    to = M.TorchSession({"spark.rapids.sql.concurrentTpuTasks": 1,
                         "spark.rapids.tpu.concurrentTpuTasks."
                         "acquireTimeout": 0.05}, device=M.device)
    held, done = threading.Event(), threading.Event()

    def holder():
        with to.device_manager.semaphore:
            held.set()
            done.wait(30)
    h = threading.Thread(target=holder, name="slot-holder")
    h.start()
    held.wait(30)
    try:
        M.tpch.q6(M.rebind(dfs, to)).collect()
        fail("semaphore: a held slot did not time out")
    except M.SemaphoreTimeoutError as e:
        msg = str(e)
    finally:
        done.set()
        h.join()
    check("slot-holder" in msg, f"semaphore: the error names no holder: "
          f"{msg}")
    check_answer("q6", M.tpch.q6(M.rebind(dfs, to)).collect(), refs["q6"])
    print(f"  SEMAPHORE {at()}: two threads ran Q6 4 times each through "
          f"one slot, every answer equal to numpy's, waits "
          f"{[round(w / 1e6, 3) for w in waits]} ms; acquireTimeout 0.05 s "
          f"raised SemaphoreTimeoutError: {msg[:160]}")
    return {"wait_ms": [w / 1e6 for w in waits], "timeout_error": msg}


def run_memory_phase(torch, M, session, wrappers, dfs, tables, refs, ref3,
                     lineitem_dir, futures, seed: int, smi: str) -> dict:
    """The memory and robustness phase (see the module doc)."""
    spill_dir = tempfile.mkdtemp(prefix="chip_smoke_spill_")
    atexit.register(shutil.rmtree, spill_dir, True)
    out = {}
    t_phase = time.perf_counter()
    out["spill_roundtrip"], payload = memory_spill_roundtrip(
        torch, M, dfs["lineitem"]._plan.batch, spill_dir, smi)
    out["crc32c"] = memory_crc(M, payload, smi)
    del payload
    # the C++ CRC32C's calls on the path: the external sort's spill traffic
    crc0 = M.CK._COUNTED.launches
    out["pq_sort_ext"] = memory_sort_ext(torch, M, wrappers, lineitem_dir,
                                         tables, spill_dir, smi)
    out["crc32c_launches"] = M.CK._COUNTED.launches - crc0
    check(out["crc32c_launches"] > 0,
          "pq_sort_ext: the C++ CRC32C never ran on the spill path")
    cells = {
        "oom_inject_q3": (lambda s: M.tpch.q3(M.rebind(dfs, s)),
                          lambda got: check_top(
                              "Q3", got, ref3, ["o_orderkey", "o_orderdate"],
                              "revenue", 10), ("joinProbe", "segmented"),
                          INJECT),
        "oom_inject_q5": (lambda s: M.tpch.q5(M.rebind(dfs, s)),
                          lambda got: check_answer("q5", got, refs["q5"]),
                          ("joinProbe",), INJECT),
        "oom_inject_q22": (lambda s: M.tpch.q22(M.rebind(dfs, s)),
                           lambda got: check_answer("q22", got,
                                                    refs["q22"]),
                           ("strings",), INJECT),
        "oom_inject_q1_hash_str": (
            lambda s: M.tpch.q1(repartitioned(
                M.rebind(dfs, s), 16, "l_returnflag", "l_linestatus")),
            lambda got: check_answer("q1", got, refs["q1"]), ("hash",),
            INJECT),
    }
    for cell, (build, check_fn, need, conf) in cells.items():
        out[cell] = memory_inject_cell(torch, M, wrappers, cell, conf, build,
                                       check_fn, need)
    out["oom_inject_q3_split"] = memory_inject_cell(
        torch, M, wrappers, "oom_inject_q3_split",
        {"spark.rapids.tpu.test.faultInjection.sites":
         "ShuffledHashJoinExec.probe",
         "spark.rapids.tpu.test.faultInjection.oomEveryN": -4,
         "spark.rapids.tpu.retry.maxRetries": 1},
        cells["oom_inject_q3"][0], cells["oom_inject_q3"][1],
        ("joinProbe",), split=True)
    xbb = M.tpcxbb.gen_tables(BENCH_XBB_CLICKS, seed=seed)
    xbb_ref = dict(reference(futures, "xbb", BENCH_XBB_CLICKS, seed, "q30"))
    xbb_ref.pop(XBB_AUX["q30"], None)
    xbb_up = {k: session.create_dataframe(v) for k, v in xbb.items()}
    out["oom_inject_bb_q30"] = memory_inject_cell(
        torch, M, wrappers, "oom_inject_bb_q30",
        {**INJECT, "spark.rapids.sql.window.externalThresholdBytes":
         XBB_WINDOW_THRESHOLD},
        lambda s: M.tpcxbb.q30(M.rebind(xbb_up, s)),
        lambda got: check_exact("oom_inject_bb_q30", got, xbb_ref,
                                XBB_FLOATS.get("q30", ())), ("joinProbe",))
    check(out["oom_inject_bb_q30"]["chunked_windows"] > 0,
          "oom_inject_bb_q30: the window did not take _chunked_pieces")
    del xbb, xbb_up
    out["real_oom"] = run_real_oom_process(lineitem_dir, tables, seed)
    out["deadline"] = memory_deadline(torch, M, dfs, ref3)
    out["semaphore"] = memory_semaphore(torch, M, dfs, refs)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  memory phase: {out['seconds']:.1f} s")
    return out



# --------------------------------------------------------------------------
# The fusion phase: CUDA graphs per plan, the coalesce, the overlapped
# download and the upload cache
# --------------------------------------------------------------------------

#: Cells whose region must capture on its second run and replay after,
#: equal to numpy and to the streaming path (inline roots over joins and
#: aggregates), and cells expected to download a boundary's result only;
#: a cell's ``kind`` says which, ``"any"`` a cell whose region is only
#: printed.
FUSION_MUST_CAPTURE = ("entry", "q6", "q14", "q19", "ds_q96")
FUSION_HEAD_ONLY = ("q3", "ds_q3", "bb_q30", "expr_complex")
#: Runs of a fusion cell on the fused path: cold (eager), the capture,
#: then the plan's choice between replaying and streaming (a replay and
#: a streaming run, twice: ``exec/fusion.py`` ``_PathChoice``), then the
#: chosen path.
FUSION_RUNS = 7
#: The fused runs of a must-capture cell up to its last, chosen one.
FUSION_CAPTURE_SEQ = ["eager", "capture", "replay", "trial", "replay",
                      "trial"]
#: CUDA runtime calls that put work on the card, as the profiler names
#: their host events.
HOST_LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                        "cudaMemcpy", "cudaMemset")


def launch_profile(torch, run) -> dict:
    """One traced run of ``run()``: its wall time, the host's launch
    calls (kernels, graphs, copies, memsets), the device's kernel and
    copy spans and their busy share of the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    host = sum(1 for e in events if e.device_type == DeviceType.CPU
               and e.name.startswith(HOST_LAUNCH_PREFIXES))
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = _busy_us(dev)
    return {"wall_ms": wall_us / 1e3, "host_launches": host,
            "device_spans": len(dev), "busy_ms": busy / 1e3,
            "busy_share": busy / wall_us if wall_us else 0.0}


def canonical_rows(hb):
    """``hb`` with its rows sorted by every non-float column (validity
    first): two paths' answers to a query without a total ORDER BY (Q1
    has none) compare row for row."""
    keys = []
    for i in range(len(hb.schema)):
        v, ok = hb.column_at(i)
        if v.dtype.kind == "f":
            continue
        keys.append(ok)
        keys.append(np.array([str(x) for x in v]) if v.dtype == object
                    else v)
    if not keys or not hb.num_rows:
        return hb
    order = np.lexsort(keys[::-1])
    return type(hb).from_positional(hb.schema, [
        (v[order], ok[order]) for v, ok in (hb.column_at(i) for i in range(
            len(hb.schema)))])


def rebind(L, dfs: dict, session) -> dict:
    """The frames of ``dfs`` over ``session``."""
    return {k: L.DataFrame(v._plan, session) for k, v in dfs.items()}


def fusion_cell(torch, F, cell: str, kind: str, build, check_fn,
                atomic: bool, prepare=None) -> dict:
    """One fusion cell: ``build(session)`` (a DataFrame) on the streaming
    path (``F.stream``: 1 cold and 3 warm runs) and on the fused default
    (``F.session``: the region's programs dropped first, then
    ``FUSION_RUNS`` runs: eager, capture, then replays and streaming
    trials until the plan chooses its path), each answer checked and
    every fused one equal to the streaming one (integers and strings bit
    for bit, float sums to ``REV_RTOL``); a traced warm run of each path
    (the fused one replaying whatever the plan chose) counts the host's
    launch calls and the device's busy share. ``kind`` ``capture``: the
    runs must go ``FUSION_CAPTURE_SEQ`` and then the chosen path;
    ``head``: every run only downloads its boundary's result."""
    t_cell = time.perf_counter()
    if prepare is not None:
        for s in (F.session, F.stream):
            prepare(s, build(s)._plan)
    F.FU.clear_fused_cache()

    def run(s):
        return build(s).collect()
    want = run(F.stream)
    check_fn(want)
    stream_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run(F.stream)
        stream_ms.append((time.perf_counter() - t0) * 1e3)
    actions, fused_ms, infos, launches = [], [], [], []
    identical = True
    for i in range(FUSION_RUNS):
        torch.cuda.synchronize()
        F.wrappers.reset()
        t0 = time.perf_counter()
        got = run(F.session)
        fused_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({k: v for k, v in F.wrappers.counts().items() if v})
        info = dict(F.session.last_query.fusion or {})
        infos.append(info)
        actions.append(info.get("action"))
        check_fn(got)
        # raises unless integers and strings are equal bit for bit and
        # floats bit for bit or (atomic sums) to REV_RTOL
        identical &= same_answer(cell, canonical_rows(got),
                                 canonical_rows(want), atomic)
    chosen = infos[-1].get("chosen")
    if kind == "capture":
        n = len(FUSION_CAPTURE_SEQ)
        check(actions[:n] == FUSION_CAPTURE_SEQ and chosen in (
            "fused", "stream") and set(actions[n:]) == {
                "replay" if chosen == "fused" else "stream"},
              f"{cell}: fused runs went {actions} (chose {chosen}), not "
              f"{FUSION_CAPTURE_SEQ} then the chosen path")
    elif kind == "head":
        check(set(actions) == {"head"},
              f"{cell}: fused runs went {actions}, not head only")
    # the traced fused run replays, whichever path the plan chose
    chose_stream = [p for p in list(F.FU._FUSED_CACHE.values())
                    if p.choice.path == "stream"]
    for p in chose_stream:
        p.choice.path = "fused"
    try:
        prof_fused = launch_profile(torch, lambda: run(F.session))
    finally:
        for p in chose_stream:
            p.choice.path = "stream"
    prof_stream = launch_profile(torch, lambda: run(F.stream))
    cap = next((x for x in infos if x.get("action") == "capture"), {})
    replays = [i for i, x in enumerate(infos) if x.get("action") == "replay"]
    rep = infos[replays[-1]] if replays else infos[-1]
    trials = [fused_ms[i] for i, x in enumerate(infos)
              if x.get("action") == "trial"]
    out = {
        "kind": kind, "actions": actions, "chosen": chosen,
        "fused_warm_ms": statistics.median(
            [fused_ms[i] for i in replays] if replays else fused_ms[2:]),
        "fused_runs_ms": fused_ms,
        "trial_stream_ms": trials,
        "host_us": rep.get("host_us", {}),
        "stream_warm_ms": statistics.median(stream_ms),
        "host_launches": {"fused": prof_fused["host_launches"],
                          "stream": prof_stream["host_launches"]},
        "device_spans": {"fused": prof_fused["device_spans"],
                         "stream": prof_stream["device_spans"]},
        "busy_share": {"fused": prof_fused["busy_share"],
                       "stream": prof_stream["busy_share"]},
        "wrapper_launches": launches[replays[-1]] if replays
        else launches[-1],
        "graphs_captured": actions.count("capture"),
        "replays": actions.count("replay"),
        "capture_ms": cap.get("capture_ms", 0.0),
        "pool_bytes": rep.get("pool_bytes", 0),
        "graph_launches": rep.get("graph_launches", {}),
        "boundaries": rep.get("boundaries"),
        "head_bytes": rep.get("head_bytes"),
        "guess_misses": sum(bool(x.get("guess_miss")) for x in infos),
        "refusals": sorted({x["site"] for x in infos
                            if x.get("action") == "refused"}),
        "bit_identical_to_streaming": identical,
        "cell_s": time.perf_counter() - t_cell}
    print(f"FUSION {cell} " + json.dumps(out))
    return out


def fusion_coalesce(torch, F, cell: str, build, check_fn) -> dict:
    """``expr_complex``'s aggregate input: its exchanged blocks (8
    partitions of 8 or more), one partial each with coalescing off
    (``spark.sql.batchSizeRows`` 1: every block its own batch),
    coalesced to the goal (about one batch a partition) by default; the coalesce's batches in and out, the
    wrappers' launches and a traced run's host launches and busy share
    of each, with equal answers."""
    out = {}
    want = None
    for label, s in (("off", F.no_coalesce), ("on", F.session)):
        got = build(s).collect()  # cold
        check_fn(got)
        F.wrappers.reset()
        got = build(s).collect()
        wl = {k: v for k, v in F.wrappers.counts().items() if v}
        tree = s.last_query_profile().tree
        n_in = _node_metric(tree, "CoalesceBatchesExec", "numInputBatches")
        n_out = _node_metric(tree, "CoalesceBatchesExec", "numOutputBatches")
        prof = launch_profile(torch, lambda: build(s).collect())
        if want is None:
            want = got
        same_answer(cell, canonical_rows(got), canonical_rows(want), True)
        out[label] = {"input_batches": n_in, "output_batches": n_out,
                      "wrapper_launches": wl, **prof}
    on, off = out["on"], out["off"]
    # (the exchanges' block counts follow their input batches, so the
    # two plans need not see the same number of blocks)
    check(off["output_batches"] == off["input_batches"] >= 64
          and 8 <= on["output_batches"] <= on["input_batches"] // 4,
          f"{cell}: the coalesce took {on['input_batches']} blocks to "
          f"{on['output_batches']} batches (with batchSizeRows 1: "
          f"{off['input_batches']} to {off['output_batches']})")
    print(f"FUSION_COALESCE {cell} " + json.dumps(out))
    return out


def fusion_pipeline(torch, F, cell: str, build, atomic: bool) -> dict:
    """A cell on the fused and the streaming path with the pipeline on
    and off (the overlapped and the serial download on the streaming
    path): one cold and 3 warm runs each, equal answers."""
    out, want = {}, None
    for path in ("fused", "stream"):
        for pipe in ("on", "off"):
            s = F.pipeline_sessions[(path, pipe)]
            got = build(s).collect()
            if want is None:
                want = got
            same_answer(cell, canonical_rows(got), canonical_rows(want),
                        atomic)
            runs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                build(s).collect()
                runs.append((time.perf_counter() - t0) * 1e3)
            dl = s.last_query.exec_ms.get("DeviceToHost")
            out[f"{path}_pipeline_{pipe}"] = {
                "warm_ms": statistics.median(runs), "runs_ms": runs,
                "download_ms": dl}
    print(f"FUSION_PIPELINE {cell} " + json.dumps(out))
    return out


def fusion_upload_cache(torch, F, host_table) -> dict:
    """A repeated ``create_dataframe`` of a frozen copy of a host table:
    the first upload misses, the second hits and hands back the same
    device columns; the OOM drain then empties the cache and releases
    every graph."""
    HB, UC = F.HostBatch, F.UC
    hb = HB.from_positional(host_table.schema, [
        (v.copy(), ok.copy()) for v, ok in (host_table.column_at(i)
                                            for i in range(
                                                len(host_table.schema)))])
    hb.freeze()
    before = dict(UC.stats)
    times = []
    frames = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames.append(F.session.create_dataframe(hb))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    hits = UC.stats["hits"] - before["hits"]
    misses = UC.stats["misses"] - before["misses"]
    n_cols = len(hb.schema)
    check(misses == n_cols and hits == n_cols
          and all(a is b for a, b in zip(frames[0]._plan.batch.columns,
                                         frames[1]._plan.batch.columns)),
          f"upload cache: {misses} misses, {hits} hits over {n_cols} "
          "columns, or new device columns on the second upload")
    cached = UC.cache_bytes()
    graphs = F.EX.stats()["graphs"]
    del frames
    moved = F.R.spill_device_below(F.E.ExecContext(torch.device("cuda")))
    check(UC.cache_bytes() == 0 and F.EX.stats()["graphs"] == 0,
          "the OOM drain left the upload cache or a graph behind")
    out = {"rows": hb.num_rows, "columns": n_cols,
           "first_upload_ms": times[0], "cached_upload_ms": times[1],
           "cache_bytes": cached, "graphs_before_drain": graphs,
           "drained_bytes": moved}
    print("FUSION_UPLOAD_CACHE " + json.dumps(out))
    return out


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
    ap.add_argument("--ds-ss-rows", type=int, default=2_880_404,
                    help="store_sales rows of the TPC-DS tables the ds_* "
                         "cells upload (SF1 = 2,880,404)")
    ap.add_argument("--mort-perf-rows", type=int, default=MORT_PERF_ROWS,
                    help="performance records of the Mortgage tables the "
                         "mort_* cells upload (2^24: 699,050 loans)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace two warm runs of each query and "
                         "entry stage with torch.profiler (tables in "
                         "chiprun_out/<query>_profile.txt)")
    ap.add_argument("--real-oom", metavar="DIR",
                    help="run only the memory phase's real_oom cell over "
                         "lineitem's parquet files in DIR (the phase runs "
                         "it this way, in a process of its own)")
    args = ap.parse_args()
    if args.real_oom:
        return real_oom_main(args)

    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available; this smoke run needs an NVIDIA GPU")
    from spark_rapids_tpu_torch import entry as ENTRY
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.data.batch import ColumnarBatch, HostBatch
    from spark_rapids_tpu_torch.exec import execs as E
    from spark_rapids_tpu_torch.exec import generate_cases as GC
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
    from spark_rapids_tpu_torch.workloads import tpcds
    from spark_rapids_tpu_torch.workloads import tpcxbb
    from spark_rapids_tpu_torch.workloads import mortgage
    from spark_rapids_tpu_torch.ops import aggregates as A
    from spark_rapids_tpu_torch.ops import arithmetic as AR
    from spark_rapids_tpu_torch.ops import bitwise as B
    from spark_rapids_tpu_torch.ops import cast as CA
    from spark_rapids_tpu_torch.ops import conditional as C
    from spark_rapids_tpu_torch.ops import datetime as DT
    from spark_rapids_tpu_torch.ops import math as MA
    from spark_rapids_tpu_torch.ops import predicates as P
    from spark_rapids_tpu_torch.ops import strings as S
    from spark_rapids_tpu_torch.ops import strings2 as S2
    from spark_rapids_tpu_torch.ops import complex as CPX
    from spark_rapids_tpu_torch.ops import nondeterministic as ND
    from spark_rapids_tpu_torch.io import parquet_device as PD
    from spark_rapids_tpu_torch.io import parquet_encode as PE
    from spark_rapids_tpu_torch.io import parquet_meta as M
    from spark_rapids_tpu_torch.io import snappy as SN
    from spark_rapids_tpu_torch.io import snappy_cases as SC
    from spark_rapids_tpu_torch.metrics import eventlog as EL

    ref_workers, futures = start_references(args)
    mem_mods = memory_modules()
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
    generate_edge_case(torch, E, GC, TorchSession, SG)
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
          f"parquet at {BENCH_XBB_CLICKS}, the 66 TPC-DS queries ds_q1 "
          f"... ds_q98 with the {len(DS_VARIANTS)} table variants "
          f"{', '.join(f'ds_{v}' for v in DS_VARIANTS)} at "
          f"{args.ds_ss_rows} store_sales rows, pq_ds_q5 over parquet, "
          f"the entry stage, "
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

    # The fusion phase's TPC-H, entry-stage and upload-cache cells (its
    # TPC-DS, TPCxBB and Mortgage cells run beside theirs, through the
    # ``fusion`` namespace of those phases' contexts).
    from spark_rapids_tpu_torch.compile import executables as EX
    from spark_rapids_tpu_torch.data import upload_cache as UC
    from spark_rapids_tpu_torch.exec import fusion as FU
    from spark_rapids_tpu_torch.memory import retry as RT
    fusion_off = {"spark.rapids.tpu.fusion.enabled": False}
    F = types.SimpleNamespace(
        session=session, wrappers=wrappers, FU=FU, EX=EX, UC=UC, R=RT, E=E,
        HostBatch=HostBatch, L=L,
        stream=TorchSession(fusion_off, device="cuda"),
        no_coalesce=TorchSession({"spark.rapids.sql.batchSizeRows": 1},
                                 device="cuda"),
        pipeline_sessions={
            (path, pipe): TorchSession(
                {**({} if path == "fused" else fusion_off),
                 "spark.rapids.tpu.pipeline.enabled": pipe == "on"},
                device="cuda")
            for path in ("fused", "stream") for pipe in ("on", "off")},
        results={}, t0=time.perf_counter())
    print(f"fusion phase {at()}: the entry stage, q6, q14, q19 (must "
          "capture), q1, q3, sort's download with the pipeline on and "
          "off, the upload cache; ds_q96, ds_q3, expr_complex (and its "
          "coalesce), bb_q30 and mort_features with their phases")
    t_fusion = time.perf_counter()
    entry_df, entry_verify = entry_stage_frame(
        ENTRY, T, HostBatch, A, P, col, lit, session, args.lineitem_rows,
        1_500_000)
    F.results["entry"] = fusion_cell(
        torch, F, "entry", "capture",
        lambda s: L.DataFrame(entry_df._plan, s), entry_verify, False,
        prepare=sort_path)
    check(F.results["entry"]["graph_launches"].get("segmented", 0) > 0,
          "entry: segmented does not replay inside its graph")
    for q, cell_kind in (("q6", "capture"), ("q14", "capture"),
                         ("q19", "capture"), ("q1", "any"), ("q3", "head")):
        F.results[q] = fusion_cell(
            torch, F, q, cell_kind,
            lambda s, q=q: tpch.QUERIES[q](rebind(L, dfs, s)),
            queries[q][1], True)
        if q in ("q14", "q19"):
            check(F.results[q]["graph_launches"].get("joinProbe", 0) > 0,
                  f"{q}: joinProbe does not replay inside its graph")
    F.results["sort_pipeline"] = fusion_pipeline(
        torch, F, "sort", lambda s: sort_lineitem(rebind(L, dfs, s)), False)
    F.results["upload_cache"] = fusion_upload_cache(torch, F,
                                                    tables["orders"])
    F.t_phase = time.perf_counter() - t_fusion

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
                                    runs_check=runs_check, fusion=F)
    xbb_summaries, xbb_launches, xbb_calls, left_calls = run_tpcxbb(
        torch, xbb_ctx, session, wrappers, args.xbb_clicks, args.seed,
        pq_dir, args.profile, futures)
    summaries.update(xbb_summaries)
    for k in launches:
        launches[k] += xbb_launches[k]
        calls[k] += xbb_calls[k]

    # The TPC-DS queries at SF1's store_sales rows, on uploaded tables.
    expr_mods = types.SimpleNamespace(C=C, P=P, B=B, S=S, S2=S2, CA=CA,
                                      D=DT, A=A, AR=AR, MA=MA, T=T, col=col,
                                      lit=lit, CPX=CPX, ND=ND,
                                      SortOrder=L.SortOrder,
                                      HostBatch=HostBatch,
                                      StringSplit=S2.StringSplit)
    metrics_cells = {}
    ds_ctx = types.SimpleNamespace(tpcds=tpcds, PE=PE, SN=SN,
                                   ColumnarBatch=ColumnarBatch, M=expr_mods,
                                   metrics_cells=metrics_cells, fusion=F)
    ds_summaries, ds_launches, ds_calls = run_tpcds(
        torch, ds_ctx, session, wrappers, args.ds_ss_rows, args.seed,
        pq_dir, args.profile, futures)
    summaries.update(ds_summaries)
    for k in launches:
        launches[k] += ds_launches[k]
        calls[k] += ds_calls[k]

    # Mortgage's ETL and feature table at 2^24 performance records.
    mort_ctx = types.SimpleNamespace(mortgage=mortgage, KJ=KJ, fusion=F)
    mort_summaries, mort_launches, mort_calls = run_mortgage(
        torch, mort_ctx, session, wrappers, args.mort_perf_rows,
        args.profile, futures)
    ref_workers.shutdown()
    summaries.update(mort_summaries)
    for k in launches:
        launches[k] += mort_launches[k]
        calls[k] += mort_calls[k]

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

    # The query-profile and tracing layer over resident cells: the
    # answers, profiles, launches, traces, event log and synchronisations
    # at metrics level NONE, at the defaults and at ESSENTIAL with tracing
    # and device timing.
    print(f"metrics phase {at()}: {', '.join(METRICS_CELLS)} at NONE, the "
          "defaults and ESSENTIAL with trace and deviceTiming")
    metrics_cells["entry_sf1"] = entry_stage_frame(
        ENTRY, T, HostBatch, A, P, col, lit, session, args.lineitem_rows,
        1_500_000) + (sort_path,)
    for q in ("sort", "q22", "q1_hash_str"):
        metrics_cells[q] = (queries[q][0](), queries[q][1], None)
    metrics_cells["pq_q1"] = (tpch.q1(pq_dfs), pq_check("q1"), None)
    metrics = run_metrics_phase(torch, TorchSession, EL, wrappers,
                                metrics_cells)
    del metrics_cells

    # The memory and robustness phase: the spill catalog's tiers, CRC32C,
    # the external sort over parquet, OOM injection, a real OOM under an
    # allocator cap, the query deadline and the task semaphore.
    print(f"memory phase {at()}: spill_roundtrip, crc32c, pq_sort_ext, "
          f"oom_inject_* (Q3, Q5, Q22, q1_hash_str, the Q3 split, bb_q30), "
          f"real_oom, deadline, semaphore")
    memory = run_memory_phase(
        torch, mem_mods, session, wrappers, dfs, tables, refs, ref3,
        written["dirs"]["lineitem"], futures, args.seed, smi)

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
    crc = memory["crc32c"]
    rows.append({"name": "crc32c", "route": "cuda",
                 "source": "spark_rapids_tpu_torch/ops/kernels/cuda/csrc/"
                           "crc32c.cpp",
                 "replaces": "spark_rapids_tpu/utils/checksum.py:80 (host "
                             "routine, not a TPU kernel)",
                 "launches": memory["crc32c_launches"], "max_abs_err": 0,
                 "ms": crc["ms"], "plain_ms": crc["plain_ms"],
                 "bound_ms": crc["bound_ms"], "bound_by": "bytes",
                 "library_ms": None})

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
        "xbb_clicks": args.xbb_clicks, "ds_ss_rows": args.ds_ss_rows,
        "ds_launches": ds_launches,
        "mort_perf_rows": args.mort_perf_rows,
        "mort_launches": mort_launches,
        "distributed_sum_by_key": distributed,
        "q6_default_mesh_ms": default_ms, "entry_stage": entry_runs,
        "metrics": metrics, "memory": memory,
        "xbb_score_max_score_ulps": max(xbb_ulps),
        "pipeline_off": pipeline_off, "run_tables": runs_check,
        "parquet": {"fixture": fixture, "sf1_pages": sf1_pages,
                    "write": {k: v for k, v in written.items()
                              if k in ("bytes", "seconds")},
                    "files": len(written["files"]),
                    "snappy": snappy_row}}}))
    ex = EX.stats()
    print("FUSION_PHASE " + json.dumps({
        "seconds": F.t_phase, "cells": {
            k: {x: v[x] for x in ("actions", "chosen", "fused_warm_ms",
                                  "trial_stream_ms", "stream_warm_ms",
                                  "host_us", "host_launches",
                                  "busy_share", "capture_ms", "pool_bytes",
                                  "refusals")}
            for k, v in F.results.items() if "actions" in v},
        "chosen_paths": dict(collections.Counter(
            str(p.choice.path) for p in list(FU._FUSED_CACHE.values()))),
        "refusal_sites": ex["refusal_sites"],
        "programs": ex["programs"], "captures": ex["captures"],
        "replays": ex["replays"], "refusals": ex["refusals"],
        "graphs_live": ex["graphs"], "graph_bytes_live": ex["pool_bytes"],
        "graphs_released": ex["released_graphs"],
        "keys_dropped_with_their_table": ex["dead_keys"],
        "capture_seconds": ex["compile_seconds"]}))
    print(f"  fusion phase: {F.t_phase:.1f} s; whole run so far "
          f"{time.perf_counter() - T_START:.1f} s")
    print(f"phase 5 {at()}: results")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
