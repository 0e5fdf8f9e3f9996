"""The port's external merge sort (``spark_rapids_tpu_torch/exec/
external_sort.py``) and the window's chunked route (``exec/
window_exec.py``) against the JAX package's, on the CPU.

Four batches of 3,000 rows with nulls, NaN and many equal keys sort
under a 64 KiB device budget and a small external threshold, so
``SortExec`` generates one run a batch, the merge tree runs its sentinel
steps and the runs spill to host and disk: ascending with nulls first,
descending with nulls last, and two keys (a dictionary string, then a
double). The answer equals the reference's ``TpuSession`` (fusion off):
the key columns row for row, and each run of equal keys as a multiset of
rows (a merge may order equal keys differently). ``merge_step`` alone
equals a plain sort of the union on random runs. A window whose input
passes ``spark.rapids.sql.window.externalThresholdBytes`` evaluates in
chunks (``chunkedWindow``) and gives the reference's rows, and
``_chunked_pieces`` never cuts a partition group.
"""

import collections

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.plan.logical import SortOrder as RSortOrder
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.exec import external_sort as XS
from spark_rapids_tpu_torch.exec import window_exec as WX
from spark_rapids_tpu_torch.memory import spill as SP
from spark_rapids_tpu_torch.ops import aggregates as AGG
from spark_rapids_tpu_torch.ops import windows as W
from spark_rapids_tpu_torch.ops.expression import col
from spark_rapids_tpu_torch.plan.logical import SortOrder
from spark_rapids_tpu_torch.session import TorchSession

N_PARTS, ROWS = 4, 3000
BUDGET = 1 << 16
WORDS = ["ash", "birch", "cedar", "elm", "fir", "oak", "pine", "yew"]


def _obj(values) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def _parts():
    rng = np.random.default_rng(21)
    out = []
    for _ in range(N_PARTS):
        k = [None if rng.random() < 0.05 else int(x)
             for x in rng.integers(0, 300, ROWS)]
        d = rng.normal(size=ROWS).round(2)
        d[rng.random(ROWS) < 0.02] = np.nan
        out.append({"k": k,
                    "s": [None if rng.random() < 0.05
                          else WORDS[int(x)]
                          for x in rng.integers(0, len(WORDS), ROWS)],
                    "d": [None if rng.random() < 0.05 else float(x)
                          for x in d],
                    "id": list(range(len(out) * ROWS, (len(out) + 1) * ROWS))})
    return out


PARTS = _parts()
SCHEMA = T.Schema([T.StructField("k", T.LONG), T.StructField("s", T.STRING),
                   T.StructField("d", T.DOUBLE),
                   T.StructField("id", T.LONG, False)])
RSCHEMA = pa.schema([("k", pa.int64()), ("s", pa.string()),
                     ("d", pa.float64()), ("id", pa.int64())])
ORDERS = {
    "asc_nulls_first": [("k", True, True)],
    "desc_nulls_last": [("k", False, False)],
    "string_then_double": [("s", True, None), ("d", False, None)],
}


def _port_frame(conf):
    s = TorchSession(conf, device="cpu")
    df = None
    for p in PARTS:
        f = s.create_dataframe(HostBatch.from_numpy(
            {k: _obj(v) for k, v in p.items()}, SCHEMA))
        df = f if df is None else df.union(f)
    return df, s


def _norm(v):
    if isinstance(v, float) and np.isnan(v):
        return "nan"
    return v


def _runs(rows, keys):
    """Rows cut into runs of equal keys: [(key tuple, multiset)]."""
    out = []
    for r in rows:
        key = tuple(_norm(r[k]) for k in keys)
        if not out or out[-1][0] != key:
            out.append((key, collections.Counter()))
        out[-1][1][tuple(_norm(v) for v in r.values())] += 1
    return out


@pytest.mark.parametrize("name", list(ORDERS))
def test_external_sort_equals_the_reference(name, tmp_path):
    spec = ORDERS[name]
    df, s = _port_frame({"spark.rapids.memory.tpu.spillBudgetBytes": BUDGET,
                         "spark.rapids.memory.host.spillStorageSize": BUDGET,
                         "spark.rapids.sql.sort.externalThresholdBytes":
                         1 << 12,
                         "spark.rapids.memory.tpu.spillDir": str(tmp_path)})
    got = df.sort(*[SortOrder(col(k), a, nf) for k, a, nf in spec]) \
        .collect()
    prof = s.last_query_profile()
    sort_node = prof.tree
    while sort_node["name"] != "SortExec":
        sort_node = sort_node["children"][0]
    assert sort_node["metrics"]["externalSort"] == 1
    assert sort_node["metrics"]["sortRuns"] == N_PARTS
    assert prof.engine["spillBytesToHost"] > 0
    assert prof.engine["spillBytesToDisk"] > 0
    ref = TpuSession({"spark.rapids.sql.enabled": True,
                      "spark.rapids.tpu.fusion.enabled": False,
                      "spark.rapids.memory.tpu.spillBudgetBytes": BUDGET})
    tbl = pa.Table.from_batches([pa.RecordBatch.from_pydict(p, RSCHEMA)
                                 for p in PARTS])
    want = ref.create_dataframe(tbl).sort(
        *[RSortOrder(rcol(k), a, nf) for k, a, nf in spec]).collect()
    names = [f.name for f in SCHEMA]
    got_rows = [dict(zip(names, r)) for r in zip(*[
        [None if not ok else v.item() if hasattr(v, "item") else v
         for v, ok in zip(got.columns[n], got.validity[n])]
        for n in names])]
    want_rows = want.to_pylist()
    assert len(got_rows) == len(want_rows) == N_PARTS * ROWS
    keys = [k for k, _, _ in spec]
    assert _runs(got_rows, keys) == _runs(want_rows, keys)


def _sorted_run(rng, n):
    return HostBatch.from_numpy({"v": np.sort(rng.integers(0, 50, n))}) \
        .to_device("cpu")


@pytest.mark.parametrize("seed", range(3))
def test_merge_step_equals_a_plain_sort(seed):
    rng = np.random.default_rng(seed)
    key = [col("v").bind(T.Schema([T.StructField("v", T.LONG)]))]
    for _ in range(5):
        a = _sorted_run(rng, int(rng.integers(1, 300)))
        b = _sorted_run(rng, int(rng.integers(1, 300)))
        sent_v = int(rng.integers(0, 60))
        sent = HostBatch.from_numpy({"v": np.array([sent_v])}) \
            .to_device("cpu")
        merged, n = XS.merge_step(a, b, sent, key, [True], [True])
        got = HostBatch.from_device(merged).columns["v"].tolist()
        union = sorted(HostBatch.from_device(a).columns["v"].tolist()
                       + HostBatch.from_device(b).columns["v"].tolist())
        assert got == union
        # the sentinel orders after equal keys: rows <= it go out
        assert n == sum(1 for x in union if x <= sent_v)


def _window_rows(out, names):
    return sorted(zip(*[out[n] for n in names]))


def test_chunked_window_equals_the_reference(tmp_path):
    rng = np.random.default_rng(5)
    parts = [{"g": rng.integers(0, 60, 2500).astype(np.int64),
              "v": rng.integers(0, 10**6, 2500).astype(np.int64)}
             for _ in range(3)]
    s = TorchSession({"spark.rapids.memory.tpu.spillBudgetBytes": 1 << 20,
                      "spark.rapids.sql.window.externalThresholdBytes":
                      1 << 13,
                      "spark.rapids.memory.tpu.spillDir": str(tmp_path)},
                     device="cpu")
    df = None
    for p in parts:
        f = s.create_dataframe(p)
        df = f if df is None else df.union(f)
    spec = W.WindowSpec(partition_by=(col("g"),),
                        order_by=(SortOrder(col("v")),))
    out = df.with_windows(
        rn=W.WindowExpression(W.RowNumber(), spec),
        total=W.WindowExpression(AGG.Sum(col("v")), spec)).collect()
    prof = s.last_query_profile()
    win = prof.tree
    while win["name"] != "WindowExec":
        win = win["children"][0]
    assert win["metrics"]["chunkedWindow"] > 1
    from spark_rapids_tpu.ops import aggregates as RAGG
    from spark_rapids_tpu.ops import windows as RW
    ref = TpuSession({"spark.rapids.sql.enabled": True,
                      "spark.rapids.tpu.fusion.enabled": False})
    rdf = ref.create_dataframe(pa.Table.from_batches(
        [pa.RecordBatch.from_pydict(p) for p in parts]))
    rspec = RW.WindowSpec(partition_by=(rcol("g"),),
                          order_by=(RSortOrder(rcol("v")),))
    want = rdf.with_windows(
        rn=RW.WindowExpression(RW.RowNumber(), rspec),
        total=RW.WindowExpression(RAGG.Sum(rcol("v")), rspec)).collect()
    names = ["g", "v", "rn", "total"]
    got = _window_rows({n: out.columns[n].tolist() for n in names}, names)
    exp = _window_rows({n: want.column(n).to_pylist() for n in names}, names)
    assert got == exp


def test_chunked_pieces_hold_whole_groups(tmp_path):
    rng = np.random.default_rng(8)
    g = np.sort(rng.integers(0, 30, 4000))
    rng.shuffle(g)
    batch = HostBatch.from_numpy({"g": g, "i": np.arange(4000)}) \
        .to_device("cpu")
    schema = batch.schema
    cat = SP.BufferCatalog(1 << 40, 1 << 40, str(tmp_path))

    class Ctx:
        qos = None
        conf = None
        catalog = cat
        device = torch.device("cpu")

        def metric(self, *a):
            pass
    key = [col("g").bind(schema)]
    seen = []
    for piece in WX._chunked_pieces([batch], key, schema, cat, Ctx(), 4096):
        vals = HostBatch.from_device(piece).columns["g"].tolist()
        assert vals == sorted(vals)
        seen.append(vals)
    assert len(seen) > 1
    flat = [v for p in seen for v in p]
    assert sorted(flat) == sorted(g.tolist())
    for a, b in zip(seen, seen[1:]):
        assert a[-1] < b[0]  # no group spans two pieces
    assert cat.leak_report() == []
    cat.close()


def test_chunked_window_keeps_a_nan_partition_whole(tmp_path):
    """A float partition key whose NaN group spans several chunks: the
    chunked route evaluates it as ONE partition, as Spark groups NaN
    with NaN (numpy oracle; the reference splits such a group)."""
    rng = np.random.default_rng(13)
    n = 6000
    g = rng.choice(np.array([0.5, 1.5, 2.5, np.nan]), n,
                   p=[0.2, 0.2, 0.2, 0.4])
    v = rng.permutation(n).astype(np.int64)
    s = TorchSession({"spark.rapids.memory.tpu.spillBudgetBytes": 1 << 20,
                      "spark.rapids.sql.window.externalThresholdBytes":
                      1 << 13,
                      "spark.rapids.memory.tpu.spillDir": str(tmp_path)},
                     device="cpu")
    df = None
    for a in range(0, n, 2000):
        f = s.create_dataframe({"g": g[a:a + 2000], "v": v[a:a + 2000]})
        df = f if df is None else df.union(f)
    spec = W.WindowSpec(partition_by=(col("g"),),
                        order_by=(SortOrder(col("v")),))
    out = df.with_windows(
        rn=W.WindowExpression(W.RowNumber(), spec),
        total=W.WindowExpression(AGG.Sum(col("v")), spec)).collect()
    prof = s.last_query_profile()
    win = prof.tree
    while win["name"] != "WindowExec":
        win = win["children"][0]
    assert win["metrics"]["chunkedWindow"] > 2
    want = set()
    for key in (0.5, 1.5, 2.5, np.nan):
        sel = np.isnan(g) if np.isnan(key) else g == key
        vs = np.sort(v[sel])
        # the frame with an ORDER BY: RANGE UNBOUNDED PRECEDING to
        # CURRENT ROW, a running sum (v is unique)
        want |= {(_norm(float(key)), int(x), i + 1, int(c))
                 for i, (x, c) in enumerate(zip(vs, np.cumsum(vs)))}
    got = {(_norm(a), b, c, d) for a, b, c, d in zip(
        *[out.columns[k].tolist() for k in ("g", "v", "rn", "total")])}
    assert len(got) == n and got == want
