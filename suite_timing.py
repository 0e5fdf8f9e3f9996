"""Warm timings of the TPC-DS suite on the card, for comparing two
checkouts of the port in one call.

Generates ``tpcds.gen_tables(--ss-rows, --seed)`` (SF1's 2,880,404
store_sales rows by default), uploads it once, then runs every query of
``tpcds.QUERIES`` once cold and ``--runs`` times warm, host clock until
the answer is on the host. Prints one JSON line: the per-query warm
medians and their geometric mean (``chip_smoke.py``'s ``DS_GEOMEAN``
shape), with the card's name and power limit. ``--conf key=value``
passes session confs (a checkout that does not know a key refuses it);
``--warmup n`` runs each query n more times, untimed, before the timed
runs. ``paths`` counts what the last run of each query did on the fused
path (``QueryInfo.fusion``: its action, and the path a captured plan
chose), where the checkout has one; ``reserved_gb`` and ``gc_objects``
are the allocator's reserved device memory and the collector's tracked
objects after each query's runs. ``--profile q88,...`` traces one more
warm run of each named query after the suite (``torch.profiler``) and
prints its 20 costliest host events by self time (``host_events``);
``--cprofile q88,...`` runs each named query twice more under
``cProfile`` and prints its 25 costliest Python functions by own time
(``python_top``).

Compare two checkouts by running this file from the root of each in
turn (parent, change, change, parent), in one call, on one card:

    python3 suite_timing.py --conf spark.rapids.tpu.metrics.level=NONE
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ss-rows", type=int, default=2_880_404)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=0,
                    help="untimed runs between the cold run and the timed "
                         "ones (the fused path's first two runs of a plan "
                         "in its final modes run it eagerly and capture "
                         "its graph)")
    ap.add_argument("--conf", action="append", default=[],
                    help="a session conf as key=value (repeatable)")
    ap.add_argument("--label", default="")
    ap.add_argument("--profile", default="",
                    help="comma-separated queries to trace after the suite")
    ap.add_argument("--cprofile", default="",
                    help="comma-separated queries to run under cProfile "
                         "after the suite")
    args = ap.parse_args()

    import gc

    import torch
    if not torch.cuda.is_available():
        print("CUDA is not available; this timing needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.workloads import tpcds

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    conf = dict(kv.split("=", 1) for kv in args.conf)
    session = TorchSession(conf or None, device="cuda")
    dfs = tpcds.load(session, tpcds.gen_tables(args.ss_rows,
                                               seed=args.seed))
    torch.cuda.synchronize()
    warm, cold = {}, {}
    paths: dict = {}
    reserved, objects = {}, {}
    for q, query in tpcds.QUERIES.items():
        times = []
        for i in range(1 + args.warmup + args.runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            query(dfs).collect()
            times.append((time.perf_counter() - t0) * 1e3)
        cold[q] = times[0]
        warm[q] = statistics.median(times[1 + args.warmup:])
        info = getattr(getattr(session, "last_query", None), "fusion",
                       None) or {}
        path = f"{info.get('action')}/{info.get('chosen')}"
        paths[path] = paths.get(path, 0) + 1
        reserved[q] = round(torch.cuda.memory_reserved() / 2**30, 3)
        objects[q] = len(gc.get_objects())
    host_events = {}
    for q in filter(None, args.profile.split(",")):
        from torch.profiler import ProfilerActivity, profile
        tpcds.QUERIES[q](dfs).collect()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tpcds.QUERIES[q](dfs).collect()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        host_events[q] = {"wall_ms": wall, "top": [
            [e.key, e.count, round(e.self_cpu_time_total / 1e3, 3)]
            for e in top[:20]]}
    session.close()
    print(json.dumps({
        "label": args.label, "card": smi, "conf": conf,
        "ss_rows": args.ss_rows, "runs": args.runs,
        "warmup": args.warmup,
        "geomean_warm_ms": math.exp(statistics.mean(
            math.log(v) for v in warm.values())),
        "geomean_cold_ms": math.exp(statistics.mean(
            math.log(v) for v in cold.values())),
        "python_top": python_top(tpcds, dfs, torch, args.cprofile),
        "paths": paths, "reserved_gb": reserved, "gc_objects": objects,
        "host_events": host_events, "warm_ms": warm}))
    return 0


def python_top(tpcds, dfs, torch, names: str) -> dict:
    """Per named query: the 25 Python functions with the most own time
    over two warm runs under cProfile (``file:line(name)``, calls, ms)."""
    import cProfile
    import pstats
    out = {}
    for q in filter(None, names.split(",")):
        tpcds.QUERIES[q](dfs).collect()
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(2):
            tpcds.QUERIES[q](dfs).collect()
        torch.cuda.synchronize()
        prof.disable()
        st = pstats.Stats(prof).stats
        top = sorted(st.items(), key=lambda kv: -kv[1][2])[:25]
        out[q] = [[f"{f.rsplit('/', 1)[-1]}:{ln}({fn})", v[1],
                   round(v[2] * 1e3, 3)] for (f, ln, fn), v in top]
    return out


if __name__ == "__main__":
    sys.exit(main())
