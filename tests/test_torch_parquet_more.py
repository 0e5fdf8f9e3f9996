"""Parquet files from other writers through the port's scan
(``spark_rapids_tpu_torch/io/parquet_device.py``, ``io/files.py``,
``plan/overrides.py``'s scan rule) against the JAX package's read of the
same files: PLAIN booleans, PLAIN byte arrays, v2 data pages and GZIP
decode on the device; hive layouts read on the host with their partition
columns; the plan-time gate sends a ZSTD file to the host scan (which
raises naming the codec) and shows its reason in the explain, and hands
the footers it read to the device scan; the reader batch sizes cut the
host scan's batches in each format; an
injected ``io.parquet.rowGroup`` fault decodes exactly that row group on
the host. Also ``input_file_name()`` over ORC and CSV, which the host
scan serves, and the committed ``tests/data/torch_io`` parquet files.

Tolerance: none. Reads equal the reference's bit for bit (doubles as
their bits); the input-file query counts and sums integers.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from harness import cpu_session
from test_torch_csv import (assert_same, plan_names, port_read,
                            port_session, ref_columns, ref_read)

from spark_rapids_tpu.ops import aggregates as RA
from spark_rapids_tpu.ops import nondeterministic as RND
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu_torch.config import TorchConf
from spark_rapids_tpu_torch.exec.execs import ExecContext
from spark_rapids_tpu_torch.io import parquet_device as PD
from spark_rapids_tpu_torch.io.files import CpuFileScanExec
from spark_rapids_tpu_torch.io.parquet_meta import read_footer
from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops import nondeterministic as ND
from spark_rapids_tpu_torch.ops.expression import col
from spark_rapids_tpu_torch import types as T


def _table(n=6000, seed=1):
    rng = np.random.default_rng(seed)
    return pa.table({
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
        "bb": rng.random(n) < 0.3,
        "s": pa.array([f"v{x}" for x in rng.integers(0, 50, n)],
                      mask=rng.random(n) < 0.2),
        "u": pa.array([f"u{x}" for x in rng.integers(0, 10 ** 9, n)]),
        "i": pa.array(rng.integers(0, 10 ** 6, n), mask=rng.random(n) < 0.1),
        "d": rng.normal(size=n),
        "day": pa.array(rng.integers(0, 20000, n).astype(np.int32),
                        pa.date32()),
    })


#: name -> pyarrow writer options of a layout the port's writer never makes
LAYOUTS = {
    "PLAIN booleans and byte arrays": dict(use_dictionary=False),
    "v2 data pages": dict(data_page_version="2.0"),
    "GZIP": dict(compression="gzip"),
    "v2 GZIP PLAIN": dict(data_page_version="2.0", compression="gzip",
                          use_dictionary=False),
    "v2 uncompressed": dict(data_page_version="2.0", compression="none"),
    "dictionary falling back to PLAIN": dict(dictionary_pagesize_limit=256,
                                             data_page_size=512),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_decodes_on_the_device(name, tmp_path):
    path = str(tmp_path / "x.parquet")
    pq.write_table(_table(), path, row_group_size=2500, **LAYOUTS[name])
    meta = read_footer(path)
    assert PD.device_decodable(meta, PD.schema_from_parquet(meta, path),
                               path) is None
    got, info = port_read("parquet", path)
    assert info.counters.get("ParquetScanExec.deviceDecodedRowGroups") == \
        meta.num_row_groups
    assert not info.counters.get("ParquetScanExec.hostFallbackRowGroups")
    assert_same(got, ref_read("parquet", path), name)


def test_hive_layout_reads_on_the_host(tmp_path):
    path = str(tmp_path / "hive")
    rng = np.random.default_rng(2)
    n = 300
    cpu_session().create_dataframe({
        "k": [int(x) for x in rng.integers(0, 4, n)],
        "p": [["a/b", "x=y", None][i % 3] for i in range(n)],
        "v": [float(x) for x in rng.normal(size=n)],
    }).write.partition_by("k", "p").parquet(path)
    s = port_session()
    df = s.read.parquet(path)
    assert [(f.name, f.data_type) for f in df.schema][-2:] == \
        [("k", T.INT), ("p", T.STRING)]
    assert "ParquetScanExec" not in plan_names(s, df)
    assert_same(df.collect(), ref_read("parquet", path), "hive", sort=True)


def test_gate_sends_zstd_to_the_host_scan(tmp_path):
    path = str(tmp_path / "z.parquet")
    pq.write_table(pa.table({"k": [1, 2], "x": [0.5, 1.5]}), path,
                   compression={"k": "snappy", "x": "zstd"})
    meta = read_footer(path)
    reason = PD.device_decodable(meta, PD.schema_from_parquet(meta, path),
                                 path)
    assert "codec ZSTD" in reason
    s = port_session(**{"spark.rapids.sql.explain": "NOT_ON_TPU"})
    df = s.read.parquet(path)
    assert "ParquetScanExec" not in plan_names(s, df)
    assert "CpuFileScanExec cannot run on TPU because" in s.last_explain \
        and "codec ZSTD" in s.last_explain
    with pytest.raises(NotImplementedError, match="codec ZSTD") as e:
        df.collect()
    assert path in str(e.value) and "'x'" in str(e.value)


def test_device_decode_switch(tmp_path):
    path = str(tmp_path / "x.parquet")
    pq.write_table(_table(2000), path)
    s = port_session(**{"spark.rapids.sql.parquet.deviceDecode.enabled":
                        False})
    df = s.read.parquet(path)
    assert "ParquetScanExec" not in plan_names(s, df)
    assert "CpuFileScanExec" in plan_names(s, df)
    assert_same(df.collect(), ref_read("parquet", path), "switch off")


def _find(plan, cls):
    while not isinstance(plan, cls):
        plan = plan.children[0]
    return plan


def test_gate_hands_its_footers_to_the_scan(tmp_path, monkeypatch):
    """The plan's gate reads each file's footer; the device scan takes
    them and reads none again."""
    d = tmp_path / "many"
    d.mkdir()
    for i in range(3):
        pq.write_table(_table(900, seed=i), str(d / f"p{i}.parquet"),
                       row_group_size=400)
    s = port_session()
    df = s.read.parquet(str(d))
    scan = _find(s.plan(df._plan), PD.ParquetScanExec)
    assert sorted(scan.footers) == scan.files and len(scan.files) == 3

    def no_read(path):
        raise AssertionError(f"footer of {path} read again")
    monkeypatch.setattr(PD, "read_footer", no_read)
    got, info = port_read("parquet", str(d), session=s)
    assert info.counters.get("ParquetScanExec.deviceDecodedRowGroups") == 9
    assert_same(got, ref_read("parquet", str(d)), "footers handed over")


@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv"])
def test_reader_batch_sizes_chunk_the_host_scan(fmt, tmp_path):
    """``spark.rapids.sql.reader.batchSizeRows`` and ``batchSizeBytes``
    cut the host scan's batches; the answer is the reference's, and the
    scan counts the files' sizes as ``CpuFileScanExec.read_bytes``."""
    path = str(tmp_path / fmt)
    rng = np.random.default_rng(6)
    for i, n in enumerate((500, 300)):
        part = port_session().create_dataframe({
            "k": [int(x) for x in rng.integers(0, 10 ** 6, n)],
            "v": [float(x) for x in rng.normal(size=n)],
            "s": [f"s{x}" for x in rng.integers(0, 40, n)]})
        getattr(part.write, fmt)(os.path.join(path, f"f{i}"))
    files = sorted(os.path.join(r, f) for r, _, fs in os.walk(path)
                   for f in fs if not f.startswith(("_", ".")))
    off = {f"spark.rapids.sql.{fmt}.deviceDecode.enabled": False}
    want = ref_read(fmt, path)
    for limit, cap in (({"spark.rapids.sql.reader.batchSizeRows": 64},
                        64),
                       ({"spark.rapids.sql.reader.batchSizeBytes": 2048},
                        None)):
        conf = {**off, **limit}
        s = port_session(**conf)
        df = getattr(s.read, fmt)(path)
        scan = _find(s.plan(df._plan), CpuFileScanExec)
        ctx = ExecContext(torch.device("cpu"), conf=TorchConf(conf))
        batches = [b for part in scan.execute(ctx) for b in part]
        rows = [b.num_rows for b in batches]
        assert sum(rows) == 800 and len(rows) > 2, (limit, rows)
        if cap:
            assert max(rows) <= cap
        else:
            assert max(b.nbytes for b in batches) <= 2048
        assert ctx.counters["CpuFileScanExec.read_bytes"] == \
            sum(os.path.getsize(f) for f in files)
        got, info = port_read(fmt, path, session=s)
        assert info.counters["CpuFileScanExec.read_bytes"] == \
            ctx.counters["CpuFileScanExec.read_bytes"]
        assert_same(got, want, f"{fmt} {limit}")


@pytest.mark.parametrize("pipeline", [True, False])
def test_injected_row_group_fault_falls_back_once(pipeline, tmp_path):
    path = str(tmp_path / "x.parquet")
    pq.write_table(_table(), path, row_group_size=1000)
    s = port_session(**{
        "spark.rapids.tpu.test.faultInjection.sites": "io.parquet.rowGroup",
        "spark.rapids.tpu.test.faultInjection.oomEveryN": -1,
        "spark.rapids.tpu.pipeline.enabled": pipeline})
    got, info = port_read("parquet", path, session=s)
    c = info.counters
    assert c.get("ParquetScanExec.hostFallbackRowGroups") == 1
    assert c.get("ParquetScanExec.deviceDecodedRowGroups") == 5
    assert_same(got, ref_read("parquet", path), "injected")


@pytest.mark.parametrize("fmt", ["orc", "csv"])
def test_input_file_name_over_orc_and_csv(fmt, tmp_path):
    path = str(tmp_path / fmt)
    rng = np.random.default_rng(4)
    os.makedirs(path)
    for i, n in enumerate((40, 70, 25)):
        part = cpu_session().create_dataframe({
            "k": [int(x) for x in rng.integers(0, 5, n)],
            "v": [int(x) for x in rng.integers(0, 100, n)]})
        getattr(part.write, fmt)(os.path.join(path, f"f{i}"))

    def q(s, ref):
        nd, c, agg = (RND, rcol, RA) if ref else (ND, col, A)
        return (getattr(s.read, fmt)(path)
                .with_column("f", nd.InputFileName())
                .group_by(c("f"))
                .agg(agg.AggregateExpression(agg.Count(), "n"),
                     agg.AggregateExpression(agg.Sum(c("v")), "sv"))
                .sort("f"))
    s = port_session()
    df = q(s, False)
    scan = "OrcScanExec" if fmt == "orc" else "CsvScanExec"
    assert scan not in plan_names(s, df)
    got = df.collect()
    assert_same(got, ref_columns(q(cpu_session(), True).collect()), fmt)
    assert len(got.columns["f"]) == 3


def test_committed_fixtures():
    here = os.path.join(os.path.dirname(__file__), "data", "torch_io")
    want = np.load(os.path.join(here, "expected.npz"))
    for name in ("plain.parquet", "v2_gzip.parquet"):
        path = os.path.join(here, name)
        got, info = port_read("parquet", path)
        assert not info.counters.get("ParquetScanExec.hostFallbackRowGroups")
        stored = {c: (want[f"{name}/{c}"], want[f"{name}/{c}/valid"])
                  for c in got.schema.names}
        assert_same(got, stored, name)
        assert_same(got, ref_read("parquet", path), name)
