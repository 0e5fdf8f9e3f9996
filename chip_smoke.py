#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spark_rapids_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--lineitem-rows N] [--seed S]

Phases; each one passes or the script exits non-zero:

1. build the CUDA kernels from ``spark_rapids_tpu_torch/ops/kernels/cuda/
   csrc`` (one ``nvcc`` per source, all at once); print the card's name and
   power limit;
2. hold each kernel against its plain PyTorch version on the card, on edge
   cases (duplicate keys, empty tables, one live row, all rows dead; int64
   and float64 lanes, +/-0.0, NaN, one group, one group per row): outputs
   equal bit for bit;
3. TPC-H Q3 at SF1 (6,001,215 lineitem rows by default) through
   ``TorchSession`` on ``cuda``: the answer must match an independent numpy
   implementation written here, and both kernels must have launched
   during the query (counts set to 0 just before, read just after);
4. at the shapes Q3 gave each kernel: kernel vs plain version (equal bit
   for bit), median times over CUDA events with the L2 flushed between
   launches, the memory bound, and a PyTorch library yardstick;
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
D_1995_03_15 = 9204
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


def profile_q3(torch, tpch, dfs, exec_ms) -> None:
    """Trace one warm Q3 run: device time by kernel and by operator, and
    the device's busy share of the run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    labels = set(exec_ms)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tpch.q3(dfs).collect()
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
    with open(OUT_DIR / "q3_profile.txt", "w") as f:
        f.write(prof.key_averages().table(row_limit=60) + "\n")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1]):
            f.write(f"{us:12.1f} us  {name}\n")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"  profile: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
          f"{len(kernels)} kernel launches; top: "
          + "; ".join(f"{n[:60]} {us / 1e3:.3f} ms" for n, us in top))


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lineitem-rows", type=int, default=6_001_215,
                    help="TPC-H lineitem rows (SF1 = 6,001,215)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm Q3 run with torch.profiler "
                         "(table in chiprun_out/q3_profile.txt)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available; this smoke run needs an NVIDIA GPU")
    from spark_rapids_tpu_torch.ops.kernels.cuda import _build
    from spark_rapids_tpu_torch.ops.kernels.cuda import join_probe as JP
    from spark_rapids_tpu_torch.ops.kernels.cuda import segmented as SEG
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

    # -- phase 3: Q3 at SF1 ----------------------------------------------
    print(f"phase 3: TPC-H Q3, lineitem_rows={args.lineitem_rows}")
    t0 = time.perf_counter()
    tables = tpch.gen_tables(args.lineitem_rows, seed=args.seed)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = numpy_q3(tables)
    t_ref = time.perf_counter() - t0
    session = TorchSession(device="cuda")
    t0 = time.perf_counter()
    dfs = tpch.load(session, tables)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    print(f"  tables: generated {t_gen:.1f} s, uploaded {t_load:.1f} s; "
          f"numpy reference {t_ref:.1f} s; rows "
          + ", ".join(f"{k}={v.num_rows}" for k, v in tables.items()))

    wrappers = {"joinProbe": JP.dense_build_probe,
                "segmented": SEG.segment_reduce_sorted}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    got = tpch.q3(dfs).collect()
    cold_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    info = session.last_query
    print(f"  cold run: {cold_s * 1e3:.1f} ms, {info.attempts} attempt(s), "
          f"sites {info.site_kinds}, modes {info.dense_modes}; "
          f"kernel launches {launches}")
    check_q3(got, ref)
    for k, n in launches.items():
        check(n > 0, f"{k} was not launched during Q3")
    print("  answer matches the numpy reference")

    with Capture(JP, "dense_build_probe") as cap_jp, \
            Capture(SEG, "segment_reduce_sorted") as cap_seg:
        before = {k: fn.launches for k, fn in wrappers.items()}
        got = tpch.q3(dfs).collect()
        warm_launches = {k: fn.launches - before[k]
                         for k, fn in wrappers.items()}
    check_q3(got, ref)
    runs, per_exec = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        got = tpch.q3(dfs).collect()
        runs.append((time.perf_counter() - t0) * 1e3)
        per_exec.append(session.last_query.exec_ms)
        check_q3(got, ref)
    e2e = statistics.median(runs)
    mid = per_exec[runs.index(e2e)]
    print(f"  warm runs: {[round(r, 3) for r in runs]} ms, median {e2e:.3f} "
          f"ms; launches per warm run {warm_launches}")
    print("  per exec (ms, median run): "
          + ", ".join(f"{k}={v:.3f}" for k, v in mid.items()))
    print("  result: " + json.dumps({
        "o_orderkey": got.columns["o_orderkey"].tolist(),
        "o_orderdate": got.columns["o_orderdate"].tolist(),
        "revenue": got.columns["revenue"].tolist()}))

    if args.profile:
        profile_q3(torch, tpch, dfs, mid)

    # -- phase 4: kernels at Q3's shapes -----------------------------------
    print("phase 4: kernels at the shapes Q3 gave them")
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    rows = []
    jp = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "err": 0}
    for bslot, pslot, tbl in cap_jp.calls:
        got_k = JP.dense_build_probe(bslot, pslot, tbl)
        want = JP.dense_build_probe_plain(bslot, pslot, tbl)
        for g, w in zip(got_k, want):
            check(bits_equal(torch, g, w), "joinProbe differs from the "
                  f"plain version at Q3 shape {tuple(bslot.shape)}x"
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
    for x, gid, capacity, op in cap_seg.calls:
        got_k = SEG.segment_reduce_sorted(x, gid, capacity, op)
        want = SEG.segment_reduce_sorted_plain(x, gid, capacity, op)
        check(bits_equal(torch, got_k, want), "segmented differs from the "
              f"plain version at Q3 shape {tuple(x.shape)} {op}")
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

    # -- phase 5: results --------------------------------------------------
    print(json.dumps({"q3_sf1": {"lineitem_rows": args.lineitem_rows,
                                 "cold_ms": cold_s * 1e3,
                                 "warm_median_ms": e2e, "card": smi}}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
