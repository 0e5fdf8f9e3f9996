"""Warm timings of the TPC-DS suite on the card, for comparing two
checkouts of the port in one call.

Generates ``tpcds.gen_tables(--ss-rows, --seed)`` (SF1's 2,880,404
store_sales rows by default), uploads it once, then runs every query of
``tpcds.QUERIES`` once cold and ``--runs`` times warm, host clock until
the answer is on the host. Prints one JSON line: the per-query warm
medians and their geometric mean (``chip_smoke.py``'s ``DS_GEOMEAN``
shape), with the card's name and power limit. ``--conf key=value``
passes session confs (a checkout that does not know a key refuses it).

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
    ap.add_argument("--conf", action="append", default=[],
                    help="a session conf as key=value (repeatable)")
    ap.add_argument("--label", default="")
    args = ap.parse_args()

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
    for q, query in tpcds.QUERIES.items():
        times = []
        for i in range(1 + args.runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            query(dfs).collect()
            times.append((time.perf_counter() - t0) * 1e3)
        cold[q], warm[q] = times[0], statistics.median(times[1:])
    session.close()
    print(json.dumps({
        "label": args.label, "card": smi, "conf": conf,
        "ss_rows": args.ss_rows, "runs": args.runs,
        "geomean_warm_ms": math.exp(statistics.mean(
            math.log(v) for v in warm.values())),
        "geomean_cold_ms": math.exp(statistics.mean(
            math.log(v) for v in cold.values())),
        "warm_ms": warm}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
