"""``df.write`` through the port (``spark_rapids_tpu_torch/io/writers.py``,
``io/orc_encode.py``, the CSV text and the parquet encoder) against the
JAX package's writer (pyarrow's encoders) on the same rows.

Mirrors ``tests/test_writers.py``: the four save modes, ``partitionBy``
with special characters and nulls, ``_SUCCESS``, the ``compression``
option, the CSV option errors; round trips both ways (the port writes
and the reference's ``TpuSession.read`` reads the same rows; the
reference writes and the port reads them); the stats row's files,
partitions and rows equal to the reference's and its bytes equal to the
sizes on disk; the device writer (``WriteFilesExec``) and the host one
(``CpuWriteFilesExec``, with ``spark.rapids.sql.enabled`` off) writing
the same rows.

Tolerance: none; rows compare as sorted multisets, doubles as their
bits.
"""

import os

import numpy as np
import pyarrow.orc as orc
import pyarrow.parquet as pq
import pytest

from harness import cpu_session
from test_torch_csv import (assert_same, host_batch, port_read,
                            port_session, ref_read)

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.io import writers as W
from spark_rapids_tpu_torch.plan.logical import WriteOp

FORMATS = ["parquet", "orc", "csv"]
SCHEMA = T.Schema([T.StructField("k", T.LONG), T.StructField("v", T.LONG),
                   T.StructField("name", T.STRING),
                   T.StructField("x", T.DOUBLE)])


def _data(n=200, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "k": [int(x) for x in rng.integers(0, 5, n)],
        "v": [None if rng.random() < 0.1 else int(x)
              for x in rng.integers(-100, 100, n)],
        "name": [f"row_{i % 7}" for i in range(n)],
        "x": [round(float(x), 3) for x in rng.normal(size=n)],
    }


def _port_df(s, n=200, seed=0):
    return s.create_dataframe(host_batch(_data(n, seed), SCHEMA))


def _stats(hb) -> dict:
    return {k: int(v[0]) for k, v in hb.columns.items()}


def _ref_stats(tbl) -> dict:
    return {k: tbl.column(k).to_pylist()[0] for k in tbl.column_names}


def _disk_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs
               if not f.startswith(("_", ".")))


@pytest.mark.parametrize("fmt", FORMATS)
def test_round_trip_both_ways(fmt, tmp_path):
    p_ref, p_port = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_stats = _ref_stats(getattr(cpu_session().create_dataframe(
        _data()).write, fmt)(p_ref))
    port_stats = _stats(getattr(_port_df(port_session()).write, fmt)(p_port))
    assert os.path.exists(os.path.join(p_port, "_SUCCESS"))
    for k in ("files", "partitions", "rows"):
        assert port_stats[k] == ref_stats[k], k
    assert port_stats["bytes"] == _disk_bytes(p_port)
    # the reference reads what the port wrote; the port reads what the
    # reference wrote; every read is the same rows
    want = ref_read(fmt, p_ref)
    assert_same(port_read(fmt, p_ref)[0], want, f"port reads ref {fmt}",
                sort=True)
    assert_same(port_read(fmt, p_port)[0], want, f"port reads port {fmt}",
                sort=True)
    back = ref_read(fmt, p_port)
    assert_same(port_read(fmt, p_port)[0], back, f"ref reads port {fmt}",
                sort=True)
    assert sorted(map(str, back["v"][0][back["v"][1]])) == \
        sorted(map(str, want["v"][0][want["v"][1]]))


@pytest.mark.parametrize("fmt", FORMATS)
def test_partition_by_hive_layout_and_stats(fmt, tmp_path):
    p_ref, p_port = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_stats = _ref_stats(getattr(cpu_session().create_dataframe(
        _data()).write.partition_by("k"), fmt)(p_ref))
    port_stats = _stats(getattr(_port_df(port_session()).write
                                .partition_by("k"), fmt)(p_port))
    dirs = sorted(d for d in os.listdir(p_port) if d.startswith("k="))
    assert dirs == [f"k={i}" for i in range(5)]
    for k in ("files", "partitions", "rows"):
        assert port_stats[k] == ref_stats[k], k
    assert port_stats["bytes"] == _disk_bytes(p_port)
    want = ref_read(fmt, p_ref)
    assert_same(port_read(fmt, p_port)[0], want, fmt, sort=True)
    assert_same(port_read(fmt, p_ref)[0], ref_read(fmt, p_port), fmt,
                sort=True)
    one = os.path.join(p_port, "k=0", [f for f in os.listdir(
        os.path.join(p_port, "k=0"))][0])
    if fmt == "parquet":
        assert pq.ParquetFile(one).schema_arrow.names == ["v", "name", "x"]
    elif fmt == "orc":
        assert orc.ORCFile(one).schema.names == ["v", "name", "x"]


def test_partition_values_with_special_chars_and_nulls(tmp_path):
    vals = ["a/b", "x=y", "p%q", "plain", None]
    data = {"k": vals, "v": [1, 2, 3, 4, 5]}
    schema = T.Schema([T.StructField("k", T.STRING),
                       T.StructField("v", T.LONG)])
    path = str(tmp_path / "esc")
    port_session().create_dataframe(host_batch(data, schema)) \
        .write.partition_by("k").parquet(path)
    dirs = sorted(d for d in os.listdir(path) if d.startswith("k="))
    assert dirs == sorted(["k=a%2Fb", "k=x%3Dy", "k=p%25q", "k=plain",
                           "k=__HIVE_DEFAULT_PARTITION__"])
    ref_path = str(tmp_path / "ref")
    cpu_session().create_dataframe(data).write.partition_by("k") \
        .parquet(ref_path)
    assert sorted(os.listdir(ref_path)) == sorted(os.listdir(path))
    got, _ = port_read("parquet", path)
    assert_same(got, ref_read("parquet", path), "escapes", sort=True)
    assert_same(got, ref_read("parquet", ref_path), "escapes", sort=True)


def test_null_integer_partition(tmp_path):
    data = {"k": [1, None, 1], "v": [1, 2, 3]}
    schema = T.Schema([T.StructField("k", T.LONG),
                       T.StructField("v", T.LONG)])
    path = str(tmp_path / "nulls")
    port_session().create_dataframe(host_batch(data, schema)) \
        .write.partition_by("k").orc(path)
    assert "k=__HIVE_DEFAULT_PARTITION__" in os.listdir(path)
    assert_same(port_read("orc", path)[0], ref_read("orc", path), "nulls",
                sort=True)


@pytest.mark.parametrize("fmt", FORMATS)
def test_modes(fmt, tmp_path):
    s = port_session()
    path = str(tmp_path / "m")
    getattr(_port_df(s, 50).write, fmt)(path)
    with pytest.raises(FileExistsError):
        getattr(_port_df(s, 50).write, fmt)(path)
    getattr(_port_df(s, 30, seed=1).write.mode("overwrite"), fmt)(path)
    assert port_read(fmt, path)[0].num_rows == 30
    stats = getattr(_port_df(s, 99).write.mode("ignore"), fmt)(path)
    assert _stats(stats)["files"] == 0
    assert port_read(fmt, path)[0].num_rows == 30
    getattr(_port_df(s, 20, seed=2).write.mode("append"), fmt)(path)
    assert port_read(fmt, path)[0].num_rows == 50
    assert ref_read(fmt, path)["k"][0].shape == (50,)


def test_overwrite_replaces_a_plain_file(tmp_path):
    path = str(tmp_path / "plainfile")
    with open(path, "w") as f:
        f.write("junk")
    _port_df(port_session(), 7).write.mode("overwrite").parquet(path)
    assert port_read("parquet", path)[0].num_rows == 7


@pytest.mark.parametrize("fmt,codec,want", [
    ("parquet", "gzip", "GZIP"), ("parquet", "snappy", "SNAPPY"),
    ("parquet", "none", "UNCOMPRESSED"), ("orc", "zlib", "ZLIB"),
    ("orc", "snappy", "SNAPPY"), ("orc", None, "UNCOMPRESSED")])
def test_compression_option(fmt, codec, want, tmp_path):
    path = str(tmp_path / "c")
    w = _port_df(port_session()).write
    if codec is not None:
        w = w.option("compression", codec)
    getattr(w, fmt)(path)
    f = os.path.join(path, [x for x in os.listdir(path)
                            if x.endswith(fmt)][0])
    if fmt == "parquet":
        assert pq.ParquetFile(f).metadata.row_group(0).column(0) \
            .compression == want
    else:
        assert orc.ORCFile(f).compression == want
    assert_same(port_read(fmt, path)[0], ref_read(fmt, path), codec or "")


@pytest.mark.parametrize("fmt,codec", [("parquet", "zstd"),
                                       ("orc", "lz4")])
def test_unsupported_codec_raises_before_writing(fmt, codec, tmp_path):
    path = str(tmp_path / "c")
    with pytest.raises(NotImplementedError, match=codec):
        getattr(_port_df(port_session()).write.option("compression", codec),
                fmt)(path)
    assert not os.path.exists(path)


@pytest.mark.parametrize("option,value,match", [
    ("delimiter", "||", "single character"),
    ("multiLine", "true", "multiLine"),
    ("charset", "ISO-8859-1", "charset"),
    ("quote", ",", "differ"),
])
def test_csv_option_errors(option, value, match, tmp_path):
    path = str(tmp_path / "gate")
    _port_df(port_session(), 5).write.csv(path)
    with pytest.raises(ValueError, match=match):
        port_session().read.option(option, value).csv(path).collect()
    with pytest.raises(ValueError, match=match):
        cpu_session().read.option(option, value).csv(path).collect()


def test_csv_delimiter_and_header_options(tmp_path):
    path = str(tmp_path / "semi")
    _port_df(port_session()).write.option("delimiter", ";") \
        .option("header", False).csv(path)
    f = [x for x in os.listdir(path) if x.endswith(".csv")][0]
    first = open(os.path.join(path, f)).readline()
    assert ";" in first and not first.startswith("k")
    got, _ = port_read("csv", path, delimiter=";", header=False)
    assert_same(got, ref_read("csv", path, delimiter=";", header=False),
                "semicolons")


def test_device_plan_and_host_writer_write_the_same_rows(tmp_path):
    s = port_session(**{"spark.rapids.sql.test.enabled": True})
    df = _port_df(s)
    plan = s.plan(WriteOp(df._plan, "parquet", str(tmp_path / "x"), {},
                          ["k"], "error"))
    assert type(plan).__name__ == "WriteFilesExec"
    for fmt in FORMATS:
        dev, host = str(tmp_path / f"dev_{fmt}"), str(tmp_path / f"host_{fmt}")
        getattr(_port_df(s).write.partition_by("k"), fmt)(dev)
        off = port_session(**{"spark.rapids.sql.enabled": False})
        getattr(_port_df(off).write.partition_by("k"), fmt)(host)
        assert_same(port_read(fmt, dev)[0], ref_read(fmt, host), fmt,
                    sort=True)


def test_write_stats_and_helpers():
    assert W._escape_path_name("a/b=c%d") == "a%2Fb%3Dc%25d"
    assert W.run_boundaries([(np.array([1, 1, 2, 2, 2]),
                              np.array([0, 0, 1, 1, 1], bool))], 5) == \
        [0, 2, 5]
    assert W.run_boundaries([], 0) == [0]
    stats = W.WriteStats(2, 1, 10, 99).to_batch()
    assert stats.schema == W.STATS_SCHEMA
    assert _stats(stats) == {"files": 2, "partitions": 1, "rows": 10,
                             "bytes": 99}
    assert W.MODES == ("error", "overwrite", "append", "ignore")
