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
   rows dead; for ``segmented`` int64 and float64 lanes, +/-0.0, NaN, one
   group, one group per row; for ``sortStep`` one lane, a power of two and
   one past it, all lanes dead, random unique lanes up to 1,000,003; for
   the ``strings`` gather W 8 and 128, all or no rows valid, indices out of
   range on both sides, more and fewer rows out than in. Outputs equal bit
   for bit;
3. TPC-H Q3, Q1, Q4, Q6 and Q22 at SF1 (6,001,215 lineitem rows by
   default), and all of lineitem sorted by ``l_shipdate``, through
   ``TorchSession`` on ``cuda``: each answer must match an independent
   numpy implementation written here, and the kernels of each query's path
   must have launched during it (counts set to 0 just before, read just
   after): ``joinProbe`` and ``segmented`` in Q3, ``sortStep`` in Q4 and
   the sort, the ``strings`` gather in Q22;
4. at the shapes the queries gave each kernel: kernel vs plain version
   (equal bit for bit), median times over CUDA events with the L2 flushed
   between launches, the memory bound, and a PyTorch library yardstick;
   and the sort exec's permutation of SF1 lineitem by ``l_shipdate``
   through ``sortStep`` against the stable lexsort route;
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
from pathlib import Path

import numpy as np

#: H100 SXM device memory rate (NVIDIA data sheet), bytes per second.
HBM_BYTES_PER_S = 3.35e12
D_1994_01_01 = 8766
D_1995_01_01 = 9131
D_1995_03_15 = 9204
D_1998_09_02 = 10471
Q22_CODES = ["13", "31", "23", "29", "30", "18", "17"]
#: Float sums and averages against numpy: the card adds in another order.
REV_RTOL = 1e-9
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"


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
    (a 256 MB write, untimed) before every launch."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
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


def segmented_edge_cases(torch, SEG, rng, dev):
    n = 50_000
    cap = 65_536
    sizes = rng.integers(1, 9, n)
    gid_sorted = np.repeat(np.arange(len(sizes)), sizes)[:n]
    dead_tail = gid_sorted.copy()
    dead_tail[-1000:] = cap  # the sort path's dead rows
    gids = {"random groups": gid_sorted, "dead tail": dead_tail,
            "one group": np.zeros(n, dtype=np.int64),
            "one group per row": np.arange(n)}
    big = 2 ** 62
    lanes = {
        "int64 [n]": rng.integers(-big, big, n, dtype=np.int64),
        "int64 [n,3]": rng.integers(-big, big, (n, 3), dtype=np.int64),
        "int32 [n]": rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64
                                  ).astype(np.int32),
    }
    f = rng.normal(size=(n, 2))
    f[rng.random((n, 2)) < 0.05] = 0.0
    f[rng.random((n, 2)) < 0.05] = -0.0
    f[rng.random((n, 2)) < 0.01] = np.nan
    lanes["float64 [n,2] +/-0 NaN"] = f
    lanes["float64 [n] +/-0"] = np.where(rng.random(n) < 0.5, 0.0, -0.0)
    for gname, g in gids.items():
        gt = torch.as_tensor(g, dtype=torch.int32, device=dev)
        for lname, x in lanes.items():
            xt = torch.as_tensor(x, device=dev)
            for op in ("sum", "min", "max"):
                if not SEG.eligible(xt, op):
                    continue
                got = SEG.segment_reduce_sorted(xt, gt, cap, op)
                want = SEG.segment_reduce_sorted_plain(xt, gt, cap, op)
                torch.cuda.synchronize()
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


def sortstep_edge_cases(torch, SS, rng, dev):
    cases = {"one lane": packed_lanes(rng, 1),
             "power of two (4096)": packed_lanes(rng, 4096),
             "power of two plus one (4097)": packed_lanes(rng, 4097),
             "all lanes dead": packed_lanes(rng, 3000, dead=1.0)}
    for n in (1000, 4096, 4097, 1_000_003):
        cases[f"random unique {n}"] = packed_lanes(rng, n)
    for name, lane in cases.items():
        lt = torch.as_tensor(lane, device=dev)
        got = SS.packed_argsort(lt)
        want = SS.packed_argsort_plain(lt)
        torch.cuda.synchronize()
        check(bits_equal(torch, got, want),
              f"sortStep '{name}': permutation differs from the plain version")
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
    """The four kernel wrappers, their launch counts and capture."""

    def __init__(self, JP, SEG, SS, SG):
        self.mods = {"joinProbe": (JP, "dense_build_probe"),
                     "segmented": (SEG, "segment_reduce_sorted"),
                     "sortStep": (SS, "packed_argsort"),
                     "strings": (SG, "ragged_gather")}
        # the wrappers themselves, which own the counts while a Capture
        # stands in for them
        self.fns = {k: getattr(m, a) for k, (m, a) in self.mods.items()}

    def reset(self) -> None:
        for fn in self.fns.values():
            fn.launches = 0

    def counts(self) -> dict:
        return {name: fn.launches for name, fn in self.fns.items()}


def run_query(torch, session, wrappers, name, build, check_fn, need):
    """Cold run (launch counts set to 0 just before, read just after),
    one captured warm run, then 3 timed warm runs. Returns (cold launch
    counts, captured calls by kernel, a summary dict)."""
    wrappers.reset()
    t0 = time.perf_counter()
    got = build().collect()
    cold_s = time.perf_counter() - t0
    launches = wrappers.counts()
    info = session.last_query
    print(f"  {name} cold run: {cold_s * 1e3:.1f} ms, {info.attempts} "
          f"attempt(s), sites {info.site_kinds}, modes {info.dense_modes}; "
          f"kernel launches {launches}")
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
    check_fn(got)
    runs, per_exec = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        got = build().collect()
        runs.append((time.perf_counter() - t0) * 1e3)
        per_exec.append(session.last_query.exec_ms)
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
               "launches": launches, "per_exec_ms": mid}
    return launches, {k: c.calls for k, c in caps.items()}, summary, mid


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
    route_ms = median_ms(torch, packed, flush)
    lex_ms = median_ms(torch, lex, flush)
    print(f"  sortStep l_shipdate lane n={lane.numel()} (pads to "
          f"{1 << (lane.numel() - 1).bit_length()}): kernel {ms:.4f} ms, "
          f"plain {pms:.4f} ms, torch.sort {lib:.4f} ms, bound {bound:.4f} "
          f"ms; with operands built: sortStep route {route_ms:.4f} ms, "
          f"lexsort route {lex_ms:.4f} ms")
    return {"n": lane.numel(), "ms": ms, "plain_ms": pms,
            "library_ms": lib, "bound_ms": bound,
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
    from spark_rapids_tpu_torch.ops.kernels import rowops as KR
    from spark_rapids_tpu_torch.ops.kernels.cuda import _build
    from spark_rapids_tpu_torch.ops.kernels.cuda import join_probe as JP
    from spark_rapids_tpu_torch.ops.kernels.cuda import segmented as SEG
    from spark_rapids_tpu_torch.ops.kernels.cuda import sort_steps as SS
    from spark_rapids_tpu_torch.ops.kernels.cuda import strings as SG
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

    # -- phase 3: the queries at SF1 -------------------------------------
    print(f"phase 3: TPC-H Q3, Q1, Q4, Q6, Q22 and lineitem sorted by "
          f"l_shipdate, lineitem_rows={args.lineitem_rows}")
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

    wrappers = Wrappers(JP, SEG, SS, SG)
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
        print(f"  segmented {op} x={tuple(x.shape)} {x.dtype} "
              f"capacity={capacity}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
              f"torch.segment_reduce {lib:.4f} ms, bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
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
        print(f"  sortStep n={lane.numel()}: kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms, torch.sort {lib:.4f} ms, bound {bound:.6f} ms")
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

    # -- phase 5: results --------------------------------------------------
    print(json.dumps({"queries_sf1": {
        "lineitem_rows": args.lineitem_rows, "card": smi,
        **{q: {k: v for k, v in s.items() if k != "per_exec_ms"}
           for q, s in summaries.items()},
        "sortStep_l_shipdate": shipdate}}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
