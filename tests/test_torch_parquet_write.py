"""The port's parquet writer (``spark_rapids_tpu_torch/io/parquet_encode.py``)
on the CPU, against the reference's ``write_device_batch``.

An UNCOMPRESSED file is held byte for byte to the reference's on the
same batch: the port's batch is built from the reference's lanes and
dictionaries (the two uploads order a string dictionary alike, but the
port's ``HostBatch`` keeps an entry for a null where the reference's does
not, so uploading the same host rows on each side would differ in the
dictionary page). SNAPPY pages are the port's own compressor's, not
pyarrow's, so SNAPPY files are held to their contents: read back through
pyarrow and through the port's scan, they equal the batch written.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import torch

from spark_rapids_tpu.data.batch import ColumnarBatch as RefBatch
from spark_rapids_tpu.io.parquet_encode import \
    write_device_batch as ref_write
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.batch import ColumnarBatch, HostBatch
from spark_rapids_tpu_torch.data.column import (DeviceColumn,
                                                dictionary_column)
from spark_rapids_tpu_torch.io import parquet_device as PD
from spark_rapids_tpu_torch.io.parquet_encode import (NotDeviceEncodable,
                                                      write_device_batch)
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.workloads import tpch

N = 2500


def _batches():
    rng = np.random.default_rng(3)
    words = np.array(["apple", "fig", "", "pear", "kiwi"], dtype=object)
    return {
        "every type, nulls": pa.RecordBatch.from_arrays([
            pa.array(rng.integers(-10 ** 9, 10 ** 9, N).astype(np.int32),
                     mask=rng.random(N) < 0.3),
            pa.array(rng.normal(size=N), mask=rng.random(N) < 0.05),
            pa.array(rng.integers(-10 ** 12, 10 ** 12, N)),
            pa.array(words[rng.integers(0, 5, N)], pa.string(),
                     mask=rng.random(N) < 0.2),
            pa.array(rng.integers(0, 20000, N).astype(np.int32))
            .cast(pa.date32()),
            pa.array(rng.random(N) < 0.5, mask=rng.random(N) < 0.1),
            pa.array(rng.integers(-100, 100, N).astype(np.int16)),
            pa.array(rng.integers(-100, 100, N).astype(np.int8)),
            pa.array(rng.normal(size=N).astype(np.float32)),
        ], names=["i", "d", "l", "s", "t", "b", "sm", "ti", "f"]),
        "required": pa.RecordBatch.from_arrays(
            [pa.array(np.arange(N, dtype=np.int64)),
             pa.array(words[np.arange(N) % 5], pa.string())],
            schema=pa.schema([pa.field("k", pa.int64(), nullable=False),
                              pa.field("s", pa.string(), nullable=False)])),
        "runs of codes": pa.RecordBatch.from_arrays(
            [pa.array(np.repeat(words, N // 5), pa.string()),
             pa.array(np.repeat(np.arange(5.0), N // 5))],
            names=["s", "x"]),
        "one row": pa.RecordBatch.from_arrays(
            [pa.array([7], pa.int64()), pa.array(["z"])], names=["k", "s"]),
    }


BATCHES = list(_batches())


def _port_batch(ref: RefBatch) -> ColumnarBatch:
    """The port's batch with the reference batch's lanes: same capacity,
    validity, values, codes and dictionary order."""
    fields, cols = [], []
    for f, c in zip(ref.schema, ref.columns):
        dtype = T.from_name(f.data_type.name)
        fields.append(T.StructField(f.name, dtype, f.nullable))
        valid = torch.from_numpy(np.asarray(c.validity).copy())
        if c.codes is not None:
            offs, data = np.asarray(c.offsets), np.asarray(c.data)
            entries = np.array([bytes(data[a:b]).decode() for a, b in
                                zip(offs[:-1], offs[1:])], dtype=object)
            cols.append(dictionary_column(
                torch.from_numpy(np.asarray(c.codes).copy()), valid,
                entries))
        else:
            cols.append(DeviceColumn(
                torch.from_numpy(np.asarray(c.data).copy()), valid, dtype))
    return ColumnarBatch(tuple(cols), torch.tensor(int(ref.n_rows)),
                         T.Schema(fields))


@pytest.mark.parametrize("name", BATCHES)
def test_uncompressed_file_is_the_references_byte_for_byte(name, tmp_path):
    rb = _batches()[name]
    ref = RefBatch.from_arrow(rb)
    ref_write(ref, str(tmp_path / "ref.parquet"), compression=None)
    n = write_device_batch(_port_batch(ref), str(tmp_path / "port.parquet"),
                           compression=None)
    want = (tmp_path / "ref.parquet").read_bytes()
    got = (tmp_path / "port.parquet").read_bytes()
    assert n == len(got)
    assert got == want


def _as_pylist(tbl: pa.Table) -> dict:
    return {n: tbl.column(n).to_pylist() for n in tbl.column_names}


@pytest.mark.parametrize("name", BATCHES)
def test_snappy_file_reads_back_through_pyarrow_and_the_port(name,
                                                             tmp_path):
    rb = _batches()[name]
    path = str(tmp_path / "s.parquet")
    batch = _port_batch(RefBatch.from_arrow(rb))
    write_device_batch(batch, path)
    meta = PD.read_footer(path)
    assert {c.codec for c in meta.row_groups[0].columns} == {"SNAPPY"}
    want = _as_pylist(pa.Table.from_batches([rb]))
    assert _as_pylist(pq.read_table(path)) == want
    got = TorchSession(device="cpu").read.parquet(path).collect()
    back = HostBatch.from_device(batch)
    for n in rb.schema.names:
        np.testing.assert_array_equal(got.validity[n], back.validity[n])
        assert list(got.columns[n]) == list(back.columns[n]), n


def test_lineitem_round_trip(tmp_path):
    """A TPC-H lineitem slice, as ``chip_smoke.py`` writes SF1's."""
    li = tpch.gen_tables(8192, seed=42)["lineitem"]
    path = str(tmp_path / "li.parquet")
    write_device_batch(li.to_device("cpu"), path)
    got = TorchSession(device="cpu").read.parquet(path).collect()
    for n, v in li.columns.items():
        assert list(got.columns[n]) == list(v), n
    tbl = pq.read_table(path)
    assert tbl.column("l_orderkey").to_pylist() == \
        li.columns["l_orderkey"].tolist()


def test_refuses_what_the_reference_refuses(tmp_path):
    li = tpch.gen_tables(1024, seed=1)["lineitem"].to_device("cpu")
    with pytest.raises(NotDeviceEncodable, match="codec"):
        write_device_batch(li, str(tmp_path / "x.parquet"),
                           compression="zstd")
    flat = DeviceColumn(torch.zeros(128, dtype=torch.uint8),
                        torch.ones(4, dtype=torch.bool), T.STRING,
                        offsets=torch.zeros(5, dtype=torch.int32))
    batch = ColumnarBatch((flat,), torch.tensor(4),
                          T.Schema([T.StructField("s", T.STRING)]))
    with pytest.raises(NotDeviceEncodable, match="flat"):
        write_device_batch(batch, str(tmp_path / "y.parquet"))
    assert not (tmp_path / "x.parquet").exists()
    assert not (tmp_path / "y.parquet").exists()
