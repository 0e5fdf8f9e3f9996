"""Warm timings of the exchange's block checksum and of its two
device-to-host copies, on the card, in one process.

Generates TPC-H (``tpch.gen_tables(--lineitem-rows, --seed)``, SF1's
6,001,215 lineitem rows by default), uploads it once, then runs Q1 over
lineitem hash-repartitioned into 16 partitions by (l_returnflag,
l_linestatus), ``chip_smoke.py``'s ``q1_hash_str`` cell, in three
variants, interleaved round by round (``--runs`` rounds after one cold
round), host clock until the answer is on the host:

* ``crc_on``: the defaults (``spark.rapids.tpu.shuffle.checksum.enabled``
  true: a CRC32C of every block when it is written, verified when it is
  read);
* ``crc_off``: the same query with the checksum key false;
* ``packed``: checksums on, the exchange's download through the route
  the port had before the spill catalog (:func:`packed_download`: every
  lane packed into one device staging buffer, then one copy to pinned
  memory) instead of ``download_columns``'s copy of each lane straight
  into the pinned buffer.

For each variant it prints the median of the warm rounds, the median
``exec_ms`` of each exchange step, and, over the warm rounds, the wall
time spent inside the checksum routine (writes and verifies apart), its
calls and bytes. The routine's own cost per call is timed on 64-byte
buffers. Every variant's answer must equal ``crc_on``'s (floats to
1e-9). One JSON line goes out last, with the card's name and power
limit:

    python3 shuffle_timing.py
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def packed_download(batch, n: int, extra=()):
    """``download_columns``'s result through a device staging buffer:
    every lane packed at 8-byte aligned offsets, one device-to-host copy
    into pinned memory, the host lanes viewed in place."""
    import torch
    from spark_rapids_tpu_torch.data import batch as B
    dev = batch.device
    flat = B._flat_columns(batch.columns)
    ends = {}
    if flat:
        bounds = torch.stack([torch.stack([c.offsets[0], c.offsets[n]])
                              for c in flat]).tolist()
        ends = {id(c): b for c, b in zip(flat, bounds)}
    lanes, shapes = [], []

    def add(t):
        shapes.append(tuple(t.shape))
        lanes.append(t.contiguous().reshape(-1))
        return len(lanes) - 1

    def plan(c):
        entry = {"validity": add(c.validity[:n])}
        if c.is_struct:
            entry["children"] = [plan(k) for k in c.children]
        elif c.is_array:
            entry["data"] = add(c.data[:n])
            entry["elem_validity"] = add(c.elem_validity[:n])
            entry["lengths"] = add(c.lengths[:n])
        elif c.is_flat:
            a, b = ends[id(c)]
            entry["offsets"] = add(c.offsets[:n + 1] - a)
            entry["data"] = add(c.data[a:b])
        elif c.is_dict:
            entry["codes"] = add(c.codes[:n])
        else:
            entry["data"] = add(c.data[:n])
        return entry

    layout = [plan(c) for c in batch.columns]
    extra_at = [add(t[:n]) for t in extra]
    sizes = [t.numel() * t.element_size() for t in lanes]
    starts, total = [], 0
    for size in sizes:
        starts.append(total)
        total += B._aligned(size)
    staging = torch.zeros(max(total, 1), dtype=torch.uint8, device=dev)
    for t, at, nb in zip(lanes, starts, sizes):
        if nb:
            staging[at:at + nb] = t.view(torch.uint8)
    host = torch.empty(staging.shape, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    host.copy_(staging)
    buf = host.numpy()
    views = [buf[at:at + nb].view(B._np_of(t.dtype)).reshape(shape)
             for t, at, nb, shape in zip(lanes, starts, sizes, shapes)]

    def build(c, entry):
        hc = B.HostColumn(c.dtype, views[entry["validity"]])
        if c.is_struct:
            hc.children = [build(k, e)
                           for k, e in zip(c.children, entry["children"])]
        elif c.is_array:
            hc.data = views[entry["data"]]
            hc.elem_validity = views[entry["elem_validity"]]
            hc.lengths = views[entry["lengths"]]
        elif c.is_flat:
            hc.offsets = views[entry["offsets"]]
            hc.data = views[entry["data"]]
            hc.max_bytes = c.max_bytes
        elif c.is_dict:
            hc.codes = views[entry["codes"]]
            hc.dictionary = c.dictionary
            hc.dict_sorted = c.dict_sorted
        else:
            hc.data = views[entry["data"]]
        return hc

    return ([build(c, e) for c, e in zip(batch.columns, layout)],
            [views[i] for i in extra_at])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lineitem-rows", type=int, default=6_001_215)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("CUDA is not available; this timing needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.shuffle import exchange as EX
    from spark_rapids_tpu_torch.utils import checksum as CK
    from spark_rapids_tpu_torch.workloads import tpch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    key = "spark.rapids.tpu.shuffle.checksum.enabled"
    session = TorchSession(device="cuda")
    dfs = tpch.load(session, tpch.gen_tables(args.lineitem_rows,
                                             seed=args.seed))
    torch.cuda.synchronize()

    crc = {"ns": 0, "calls": 0, "bytes": 0}
    plain_crc = CK._crc

    def timed_crc(data, value, device):
        t0 = time.perf_counter_ns()
        out = plain_crc(data, value, device)
        crc["ns"] += time.perf_counter_ns() - t0
        crc["calls"] += 1
        crc["bytes"] += memoryview(data).nbytes
        return out

    write_ns = {"ns": 0}
    plain_add = EX.ShuffleBufferCatalog.add_block

    def timed_add(self, *a):
        before = crc["ns"]
        plain_add(self, *a)
        write_ns["ns"] += crc["ns"] - before

    lanewise = EX.download_columns

    def query():
        lineitem = dfs["lineitem"].repartition(16, "l_returnflag",
                                               "l_linestatus")
        return tpch.q1({**dfs, "lineitem": lineitem})

    variants = {"crc_on": (True, lanewise), "crc_off": (False, lanewise),
                "packed": (True, packed_download)}
    rows = {v: [] for v in variants}
    answers = {}
    CK._crc = timed_crc
    EX.ShuffleBufferCatalog.add_block = timed_add
    try:
        for rnd in range(1 + args.runs):
            for v, (on, download) in variants.items():
                session.set_conf(key, on)
                EX.download_columns = download
                for c in crc:
                    crc[c] = 0
                write_ns["ns"] = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = query().collect()
                ms = (time.perf_counter() - t0) * 1e3
                answers.setdefault(v, got)
                steps = {k: t for k, t in session.last_query.exec_ms.items()
                         if k.startswith("ShuffleExchangeExec")}
                rows[v].append({"ms": ms, "steps": steps,
                                "crc_write_ms": write_ns["ns"] / 1e6,
                                "crc_read_ms": (crc["ns"] - write_ns["ns"])
                                / 1e6,
                                "crc_calls": crc["calls"],
                                "crc_bytes": crc["bytes"]})
    finally:
        CK._crc = plain_crc
        EX.ShuffleBufferCatalog.add_block = plain_add
        EX.download_columns = lanewise
        session.set_conf(key, True)

    base = answers["crc_on"]
    for v, got in answers.items():
        for n in base.columns:
            a, b = np.asarray(base.columns[n]), np.asarray(got.columns[n])
            if a.dtype.kind in "OU":
                same = bool(np.all(a == b))
            elif a.dtype.kind == "f":
                # the device's float sums may round in another order
                same = np.allclose(a, b, rtol=1e-9, atol=0, equal_nan=True)
            else:
                same = np.array_equal(a, b)
            if not same:
                print(f"{v}: column {n} differs from crc_on's",
                      file=sys.stderr)
                return 1

    small = np.zeros(64, np.uint8)
    n_small = 20000
    t0 = time.perf_counter_ns()
    for _ in range(n_small):
        CK.crc32c_native(small)
    per_call_us = (time.perf_counter_ns() - t0) / n_small / 1e3

    out = {}
    for v, rs in rows.items():
        warm = rs[1:]

        def med(f):
            return statistics.median(f(r) for r in warm)
        step_names = sorted({k for r in warm for k in r["steps"]})
        out[v] = {"warm_ms": med(lambda r: r["ms"]),
                  "cold_ms": rs[0]["ms"],
                  "runs_ms": [r["ms"] for r in rs],
                  "steps_ms": {k: med(lambda r: r["steps"].get(k, 0.0))
                               for k in step_names},
                  "crc_write_ms": med(lambda r: r["crc_write_ms"]),
                  "crc_read_ms": med(lambda r: r["crc_read_ms"]),
                  "crc_calls": warm[-1]["crc_calls"],
                  "crc_bytes": warm[-1]["crc_bytes"]}
    session.close()
    print(json.dumps({"card": smi, "lineitem_rows": args.lineitem_rows,
                      "runs": args.runs, "crc_call_us_64B": per_call_us,
                      "variants": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
