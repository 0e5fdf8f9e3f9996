"""The port's ORC scan (``spark_rapids_tpu_torch/io/orc_device.py``) and
encoder (``io/orc_encode.py``) against the JAX package on the same
files.

Mirrors ``tests/test_orc_device.py``: uncompressed, ZLIB and SNAPPY
files, several stripes, all-null and empty strings, DIRECT_V2 strings
with duplicates, PATCHED_BASE outliers, a query differential; a ZSTD
file raises a clear error; a BOOLEAN column sends the scan to the host
at plan time, as the device decode switch does (with its explain
reason); an injected ``io.orc.stripe`` fault decodes that stripe on
the host. Files come from pyarrow (``pyarrow.orc.write_table``, the
reference's writer) and from the port's encoder, which pyarrow must
read back.

Tolerance: none. Reads equal the reference's bit for bit (doubles as
their bits); the queries here count and take minima, exact too.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.orc as orc
import pytest

from harness import cpu_session
from test_torch_csv import (assert_same, plan_names, port_read,
                            port_session, ref_columns, ref_read)

from spark_rapids_tpu.ops import aggregates as RA
from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops.expression import col as rcol, lit as rlit
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.io import orc_device as OD
from spark_rapids_tpu_torch.io import orc_encode as OE
from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops.expression import col, lit


def _write(tmp_path, table, name="t.orc", **kw):
    p = os.path.join(str(tmp_path), name)
    orc.write_table(table, p, **kw)
    return p


def _table(n=20_000, seed=3):
    rng = np.random.default_rng(seed)
    return pa.table({
        "i64": rng.integers(-10 ** 12, 10 ** 12, n),
        "seq": np.arange(n, dtype=np.int64),
        "const": np.full(n, 7, dtype=np.int64),
        "f64": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.07),
        "s": pa.array(np.array(["red", "green", "blue", "lime", "x"])[
            rng.integers(0, 5, n)]),
        "ni": pa.array(rng.integers(0, 50, n), mask=rng.random(n) < 0.15),
        "d": pa.array(rng.integers(0, 20000, n).astype(np.int32),
                      pa.date32()),
        "i32": rng.integers(-1000, 1000, n).astype(np.int32),
    })


def _check_stripes(path):
    """Every stripe decoded on CPU tensors equals pyarrow's rows; the scan
    equals the reference's read."""
    tail = OD.read_tail(path)
    schema = OD.schema_from_tail(tail)
    assert OD.device_decodable(tail, schema) is None
    parts = [HostBatch.from_device(OD.decode_stripe(tail, k, schema))
             for k in range(len(tail.stripes))]
    want = ref_read("orc", path)
    assert_same(HostBatch.concat(parts), want, path)
    got, info = port_read("orc", path)
    assert_same(got, want, path)
    assert info.counters.get("OrcScanExec.deviceDecodedStripes") == \
        len(tail.stripes)
    assert not info.counters.get("OrcScanExec.hostFallbackStripes")
    return tail


def test_uncompressed_single_stripe(tmp_path):
    _check_stripes(_write(tmp_path, _table(5000)))


@pytest.mark.parametrize("comp", ["zlib", "snappy"])
def test_compressed_multi_stripe(comp, tmp_path):
    p = _write(tmp_path, _table(30_000, seed=9), compression=comp,
               stripe_size=64 * 1024)
    tail = _check_stripes(p)
    assert len(tail.stripes) > 1, "the test needs several stripes"


def test_all_null_and_empty_strings(tmp_path):
    t = pa.table({"x": pa.array([None] * 64, type=pa.int64()),
                  "s": pa.array((["", "a", None, "bb"] * 16))})
    _check_stripes(_write(tmp_path, t))


def _group_query(ref: bool):
    c = rcol if ref else col
    agg = RA if ref else A
    return (lambda df: df.group_by(c("s")).agg(
        agg.AggregateExpression(agg.Count(), "c"),
        agg.AggregateExpression(agg.Sum(c("v")), "sv")).sort("s"))


def test_direct_v2_strings_with_duplicates(tmp_path):
    rng = np.random.default_rng(5)
    t = pa.table({
        "s": pa.array(np.array(["aa", "bb", "aa", "cc", "bb", "aa"])[
            rng.integers(0, 6, 4000)]),
        "v": rng.integers(0, 100, 4000),
    })
    p = _write(tmp_path, t, dictionary_key_size_threshold=0.0)
    _check_stripes(p)
    got = _group_query(False)(port_session().read.orc(p)).collect()
    want = ref_columns(_group_query(True)(cpu_session().read.orc(p))
                       .collect())
    assert_same(got, want, "group by a DIRECT_V2 string")


def test_patched_base_outliers(tmp_path):
    rng = np.random.default_rng(13)
    vals = rng.integers(0, 512, 50_000)
    out_idx = rng.choice(50_000, 600, replace=False)
    vals[out_idx] = rng.integers(2 ** 40, 2 ** 45, 600)
    t = pa.table({"v": vals, "seq": np.arange(50_000, dtype=np.int64)})
    before = OD.decode_stats["patched_base"]
    _check_stripes(_write(tmp_path, t))
    assert OD.decode_stats["patched_base"] > before, \
        "the data did not make PATCHED_BASE runs; the test is vacuous"


def test_every_rlev2_sub_encoding_is_met(tmp_path):
    before = dict(OD.decode_stats)
    t = _table(20_000, seed=2)
    _check_stripes(_write(tmp_path, t))
    for kind in ("short_repeat", "direct", "delta"):
        assert OD.decode_stats[kind] > before[kind], kind


def test_orc_query_differential(tmp_path):
    t = _table(20_000, seed=21)
    p = _write(tmp_path, t, compression="zlib", stripe_size=128 * 1024)

    def q(s, ref):
        c, lt = (rcol, rlit) if ref else (col, lit)
        agg, pr = (RA, RP) if ref else (A, P)
        return (s.read.orc(p).where(pr.GreaterThan(c("i64"), lt(0)))
                .group_by(c("s"))
                .agg(agg.AggregateExpression(agg.Count(), "c"),
                     agg.AggregateExpression(agg.Min(c("ni")), "mn"))
                .sort("s"))
    assert_same(q(port_session(), False).collect(),
                ref_columns(q(cpu_session(), True).collect()), "query")


def test_zstd_raises_a_clear_error(tmp_path):
    p = _write(tmp_path, _table(100), compression="zstd")
    with pytest.raises(NotImplementedError, match="ZSTD"):
        port_session().read.orc(p).collect()


def test_boolean_column_reads_on_the_host(tmp_path):
    t = pa.table({"b": pa.array([True, False, None] * 10),
                  "v": pa.array(range(30), type=pa.int64()),
                  "i8": pa.array(np.arange(30, dtype=np.int8))})
    p = _write(tmp_path, t)
    tail = OD.read_tail(p)
    assert OD.device_decodable(tail, OD.schema_from_tail(tail))
    s = port_session()
    df = s.read.orc(p)
    assert "OrcScanExec" not in plan_names(s, df)
    assert_same(df.collect(), ref_read("orc", p), "booleans")


def test_device_decode_switch_off_explains(tmp_path):
    path = _write(tmp_path, _table(3000), stripe_size=4096)
    key = "spark.rapids.sql.orc.deviceDecode.enabled"
    s = port_session(**{key: False, "spark.rapids.sql.explain": "NOT_ON_TPU"})
    df = s.read.orc(path)
    names = plan_names(s, df)
    assert "OrcScanExec" not in names and "CpuFileScanExec" in names
    assert "CpuFileScanExec cannot run on TPU because" in s.last_explain \
        and f"{key} is false" in s.last_explain
    assert_same(df.collect(), ref_read("orc", path), "switch off")


def test_injected_stripe_fault_falls_back_once(tmp_path):
    p = _write(tmp_path, _table(30_000, seed=4), compression="zlib",
               stripe_size=64 * 1024)
    n_stripes = len(OD.read_tail(p).stripes)
    s = port_session(**{
        "spark.rapids.tpu.test.faultInjection.sites": "io.orc.stripe",
        "spark.rapids.tpu.test.faultInjection.oomEveryN": -1})
    got, info = port_read("orc", p, session=s)
    assert info.counters.get("OrcScanExec.hostFallbackStripes") == 1
    assert info.counters.get("OrcScanExec.deviceDecodedStripes") == \
        n_stripes - 1
    assert_same(got, ref_read("orc", p), "injected")


@pytest.mark.parametrize("comp", ["none", "zlib", "snappy"])
def test_port_encoder_reads_back_through_pyarrow(comp, tmp_path):
    tail = OD.read_tail(_write(tmp_path, _table(3000, seed=8)))
    hb = HostBatch.from_device(OD.decode_stripe(tail, 0,
                                                OD.schema_from_tail(tail)))
    p = str(tmp_path / f"port_{comp}.orc")
    OE.write_orc(p, OE.columns_from_host(hb), comp, stripe_rows=1000)
    assert len(OD.read_tail(p).stripes) == 3
    want = ref_columns(orc.read_table(p))
    assert_same(hb, want, f"pyarrow reads the port's {comp} file")
    got, _ = port_read("orc", p)
    assert_same(got, want, f"the port reads its {comp} file")


def test_encoder_runs():
    """RLEv2 of the encoder round trips through the decoder's parse:
    DIRECT runs at every width and a SHORT_REPEAT tail."""
    rng = np.random.default_rng(1)
    for signed in (True, False):
        for width in (1, 7, 20, 33, 56, 63):
            lo = -(1 << (width - 1)) if signed else 0
            hi = (1 << (width - 1)) if signed else (1 << width)
            vals = rng.integers(lo, hi, 1030, dtype=np.int64)
            vals[-5:] = vals[-5]
            raw = OE.rlev2(vals, signed)
            runs = OD.parse_rlev2(raw, signed, len(vals), 0)
            np.testing.assert_array_equal(
                OD._expand_host(runs, raw, len(vals)), vals)


def test_committed_fixtures():
    here = os.path.join(os.path.dirname(__file__), "data", "torch_io")
    want = np.load(os.path.join(here, "expected.npz"))
    for name in ("rle_zlib.orc", "direct_snappy.orc"):
        path = os.path.join(here, name)
        got, info = port_read("orc", path)
        assert not info.counters.get("OrcScanExec.hostFallbackStripes")
        stored = {c: (want[f"{name}/{c}"], want[f"{name}/{c}/valid"])
                  for c in got.schema.names}
        assert_same(got, stored, name)
        assert_same(got, ref_read("orc", path), name)
