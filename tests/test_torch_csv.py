"""The port's CSV scan (``spark_rapids_tpu_torch/io/csv_device.py``,
``io/files.py``) against the JAX package's reader on the same files.

Mirrors ``tests/test_csv_device.py``: fuzzed ints, doubles, strings and
booleans; edge numerals; CRLF and no header; quoted fields, exponents
and wide mantissas falling back to the host reader; ``nullValue``;
blank lines; ``quote=False``; ragged rows; hive directories. Files come
from the reference's writer (pyarrow, which quotes every string, so the
port parses them on the host) and from the port's writer (no quotes:
the device parse takes them). The schema the port infers is the
reference's, and the option errors are its errors. The device decode
switch sends a file to the host scan with its explain reason, and the
reader's row limit cuts the device parse into slices.

Tolerance: none. A read adds nothing up, so every column equals the
reference's bit for bit (doubles compared as their int64 bits), rows in
file order (sorted by all columns for a hive layout, whose file order
the two listings may not share).
"""

import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from harness import cpu_session

from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops.expression import col as rcol, lit as rlit
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import TorchConf
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.exec.execs import ExecContext
from spark_rapids_tpu_torch.io import csv_device as CD
from spark_rapids_tpu_torch.io import files as FILES
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.session import TorchSession


# -- shared helpers (test_torch_orc, _parquet_more and _writers use them) -----


def port_session(**conf) -> TorchSession:
    return TorchSession(conf or None, device="cpu")


def ref_columns(tbl: pa.Table) -> dict:
    """name -> (numpy values, validity) of a reference answer: strings as
    objects, dates as int32 days, timestamps as int64 microseconds."""
    out = {}
    for name in tbl.column_names:
        arr = tbl.column(name).combine_chunks()
        valid = np.asarray(arr.is_valid()).astype(bool) if len(arr) \
            else np.zeros(0, bool)
        if pa.types.is_string(arr.type) or pa.types.is_null(arr.type):
            vals = np.array(["" if v is None else v
                             for v in arr.to_pylist()], dtype=object)
        else:
            if pa.types.is_date32(arr.type):
                arr = arr.cast(pa.int32())
            elif pa.types.is_timestamp(arr.type):
                arr = arr.cast(pa.timestamp("us")).cast(pa.int64())
            fill = False if pa.types.is_boolean(arr.type) else 0
            vals = np.asarray(arr.fill_null(fill).to_numpy(
                zero_copy_only=False))
        out[name] = (vals, valid)
    return out


def _canon(vals: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Values under a null zeroed; doubles as their bits."""
    vals = np.asarray(vals)
    if vals.dtype == object or vals.dtype.kind == "U":
        return np.where(valid, vals.astype(object), None)
    if vals.dtype.kind == "f":
        vals = vals.astype(np.float64).view(np.int64)
    return np.where(valid, vals, 0).astype(np.int64)


def assert_same(got: HostBatch, want: dict, what: str,
                sort: bool = False) -> None:
    """The port's rows equal the reference's, bit for bit."""
    assert got.schema.names == list(want), (what, got.schema.names,
                                            list(want))
    g = {n: _canon(*got.column_at(i)) for i, n in enumerate(want)}
    w = {n: _canon(*want[n]) for n in want}
    gv = {n: np.asarray(got.column_at(i)[1], bool)
          for i, n in enumerate(want)}
    if sort:
        def rows(cols, valid):
            return sorted(zip(*[[(bool(o), str(v)) for v, o in
                                 zip(cols[n], valid[n])] for n in want]))
        assert rows(g, gv) == rows(w, {n: want[n][1] for n in want}), what
        return
    for n in want:
        np.testing.assert_array_equal(gv[n], want[n][1],
                                      err_msg=f"{what}: {n} validity")
        assert list(g[n]) == list(w[n]), f"{what}: {n} values"


def ref_read(fmt: str, path: str, **options) -> dict:
    reader = cpu_session().read
    for k, v in options.items():
        reader = reader.option(k, v)
    return ref_columns(getattr(reader, fmt)(path).collect())


def port_read(fmt: str, path: str, session=None, **options):
    s = session or port_session()
    reader = s.read
    for k, v in options.items():
        reader = reader.option(k, v)
    got = getattr(reader, fmt)(path).collect()
    return got, s.last_query


def plan_names(session, df) -> list:
    out = []

    def walk(p):
        out.append(type(p).__name__)
        for c in p.children:
            walk(c)
    walk(session.plan(df._plan))
    return out


def host_batch(data: dict, schema: T.Schema) -> HostBatch:
    """Lists with ``None`` as a typed host batch."""
    cols, valid = {}, {}
    for f in schema:
        vals = data[f.name]
        ok = np.array([v is not None for v in vals])
        if f.data_type is T.STRING:
            arr = np.array(["" if v is None else v for v in vals], object)
        else:
            arr = np.array([0 if v is None else v for v in vals],
                           f.data_type.np_dtype)
        cols[f.name], valid[f.name] = arr, ok
    return HostBatch(cols, schema, valid)


def write_both(tmp_path, data: dict, schema: T.Schema, fmt: str = "csv"
               ) -> dict:
    """The same rows written by the reference's writer and the port's:
    {"ref": dir, "port": dir}."""
    ref = str(tmp_path / f"ref_{fmt}")
    port = str(tmp_path / f"port_{fmt}")
    getattr(cpu_session().create_dataframe(data).write, fmt)(ref)
    getattr(port_session().create_dataframe(host_batch(data, schema))
            .write, fmt)(port)
    return {"ref": ref, "port": port}


# -- the device parse against the reference's reader ------------------------------


def _fuzz(n=5000, seed=5):
    rng = np.random.default_rng(seed)
    data = {
        "a": [None if rng.random() < 0.1 else int(v)
              for v in rng.integers(-10 ** 12, 10 ** 12, n)],
        "b": [None if rng.random() < 0.1 else round(float(v), 6)
              for v in rng.normal(scale=1000, size=n)],
        "s": [f"tag_{int(v)}" for v in rng.integers(0, 30, n)],
        "f": [bool(v) for v in rng.integers(0, 2, n)],
    }
    schema = T.Schema([T.StructField("a", T.LONG), T.StructField("b", T.DOUBLE),
                       T.StructField("s", T.STRING),
                       T.StructField("f", T.BOOLEAN)])
    return data, schema


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_int_double_string_bool_fuzz(writer, tmp_path):
    data, schema = _fuzz()
    path = write_both(tmp_path, data, schema)[writer]
    got, info = port_read("csv", path)
    assert_same(got, ref_read("csv", path), f"fuzz written by {writer}")
    c = info.counters
    if writer == "port":   # no quote in the file: parsed on the device
        assert c.get("CsvScanExec.deviceDecodedFiles") == 1
        assert not c.get("CsvScanExec.hostFallbackFiles")
    else:                  # pyarrow quotes every string: the host reads it
        assert c.get("CsvScanExec.hostFallbackFiles") == 1


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_edge_numerals(writer, tmp_path):
    data = {"x": [0, -1, 1, None, 999999999999999999, -999999999999999999,
                  42],
            "y": [0.0, -0.5, 0.125, 123456.789012, None, 1.0, -7.0]}
    schema = T.Schema([T.StructField("x", T.LONG),
                       T.StructField("y", T.DOUBLE)])
    path = write_both(tmp_path, data, schema)[writer]
    got, _ = port_read("csv", path)
    assert_same(got, ref_read("csv", path), f"edge numerals by {writer}")


@pytest.mark.parametrize("writer", ["text", "port"])
def test_dates_parse_on_the_device(writer, tmp_path):
    path = str(tmp_path / "d.csv")
    days = np.random.default_rng(3).integers(-3000, 30000, 500)
    if writer == "port":   # the port's writer's ISO text
        path = str(tmp_path / "d")
        port_session().create_dataframe(host_batch(
            {"i": list(range(501)), "d": days.tolist() + [None]},
            T.Schema([T.StructField("i", T.LONG),
                      T.StructField("d", T.DATE)]))).write.csv(path)
    else:
        text = "".join(f"{i},{np.datetime64(int(d), 'D')}\n"
                       for i, d in enumerate(days))
        text = "i,d\n" + text + "500,\n"   # and one null date
        with open(path, "w") as f:
            f.write(text)
    got, info = port_read("csv", path)
    assert got.schema["d"].data_type is T.DATE
    assert info.counters.get("CsvScanExec.deviceDecodedFiles") == 1
    assert_same(got, ref_read("csv", path), "dates")


def test_crlf_and_no_header(tmp_path):
    path = str(tmp_path / "crlf.csv")
    with open(path, "wb") as f:
        f.write(b"1,2.5\r\n3,4.25\r\n5,\r\n")
    got, info = port_read("csv", path, header=False)
    assert info.counters.get("CsvScanExec.deviceDecodedFiles") == 1
    assert_same(got, ref_read("csv", path, header=False), "crlf")


@pytest.mark.parametrize("name,text", [
    ("mixed", "a,b,c,d\n1,2.5,x,true\n,,,\n-3,1.0,,False\n"),
    ("timestamps", "t,u\n2020-01-02 10:00:00,1\n2021-12-31T23:59:59,2\n"),
    ("strings that look numeric", "s\n1\nx\n"),
    ("all null", "a,b\n,1\n,2\n"),
])
def test_inferred_schema_is_the_reference(name, text, tmp_path):
    path = str(tmp_path / "s.csv")
    with open(path, "w") as f:
        f.write(text)
    ref = cpu_session().read.csv(path).schema
    got = port_session().read.csv(path).schema
    want = [(f.name, "string" if f.data_type.name == "null"
             else f.data_type.name) for f in ref]
    assert [(f.name, f.data_type.name) for f in got] == want, name
    if name != "all null":
        got_rows, _ = port_read("csv", path)
        assert_same(got_rows, ref_read("csv", path), name)


# -- fallbacks ------------------------------------------------------------------


def _decode(path, schema, options):
    return CD.decode_file(path, schema, options)


def test_quoted_fields_fall_back(tmp_path):
    path = str(tmp_path / "q.csv")
    with open(path, "w") as f:
        f.write('s,v\n"hello, world",1\nplain,2\n"say ""hi""",3\n')
    schema = T.Schema([T.StructField("s", T.STRING),
                       T.StructField("v", T.LONG)])
    with pytest.raises(CD.NotCsvDecodable):
        _decode(path, schema, {"header": True})
    s = port_session()
    got = s.read.csv(path).where(P.GreaterThan(col("v"), lit(0))).collect()
    assert s.last_query.counters.get("CsvScanExec.hostFallbackFiles") == 1
    want = ref_columns(cpu_session().read.csv(path).where(
        RP.GreaterThan(rcol("v"), rlit(0))).collect())
    assert_same(got, want, "quoted")


@pytest.mark.parametrize("text", ["x\n1e10\n2.5\n",
                                  "x\n0.12345678901234567890\n"])
def test_exponent_and_wide_mantissa_fall_back(text, tmp_path):
    path = str(tmp_path / "e.csv")
    with open(path, "w") as f:
        f.write(text)
    schema = T.Schema([T.StructField("x", T.DOUBLE)])
    with pytest.raises(CD.NotCsvDecodable):
        _decode(path, schema, {"header": True})
    got, info = port_read("csv", path)
    assert info.counters.get("CsvScanExec.hostFallbackFiles") == 1
    assert_same(got, ref_read("csv", path), text)


def test_null_value_option_stays_host(tmp_path):
    assert CD.device_decodable(T.Schema([T.StructField("x", T.LONG)]),
                               {"nullValue": "NA"})
    path = str(tmp_path / "nv.csv")
    with open(path, "w") as f:
        f.write("a,b,c\n1,NA,x\n2,y,NA\nNA,,z\n")
    s = port_session()
    df = s.read.option("nullValue", "NA").csv(path)
    assert "CsvScanExec" not in plan_names(s, df)
    assert_same(df.collect(), ref_read("csv", path, nullValue="NA"), "NA")


def test_blank_crlf_line_skipped(tmp_path):
    path = str(tmp_path / "blank.csv")
    with open(path, "wb") as f:
        f.write(b"x\r\n1\r\n\r\n2\r\n")
    schema = T.Schema([T.StructField("x", T.LONG)])
    [batch] = _decode(path, schema, {"header": True})
    assert int(batch.n_rows) == 2
    assert batch.columns[0].data[:2].tolist() == [1, 2]
    got, _ = port_read("csv", path)
    assert_same(got, ref_read("csv", path), "blank")


def test_quote_false_option(tmp_path):
    path = str(tmp_path / "nq.csv")
    with open(path, "w") as f:
        f.write('x,s\n1,a"b\n2,c\n')
    schema = T.Schema([T.StructField("x", T.LONG),
                       T.StructField("s", T.STRING)])
    [batch] = _decode(path, schema, {"header": True, "quote": False})
    assert int(batch.n_rows) == 2
    hb = HostBatch.from_device(batch)
    assert list(hb.columns["s"]) == ['a"b', "c"]


def test_ragged_rows(tmp_path):
    path = str(tmp_path / "r.csv")
    with open(path, "w") as f:
        f.write("a,b\n1,2\n3\n")
    schema = T.Schema([T.StructField("a", T.LONG),
                       T.StructField("b", T.LONG)])
    with pytest.raises(CD.NotCsvDecodable):
        _decode(path, schema, {"header": True})
    # the reference's host reader refuses the file; so does the port's
    with pytest.raises(Exception):
        cpu_session().read.csv(path).collect()
    with pytest.raises(ValueError, match="CSV parse error"):
        port_session().read.csv(path).collect()


def test_hive_partitioned_dir_stays_host(tmp_path):
    path = str(tmp_path / "hive")
    cpu_session().create_dataframe({"k": [0, 1, 0, 1], "v": [1, 2, 3, 4]}) \
        .write.partition_by("k").csv(path)
    s = port_session()
    df = s.read.csv(path)
    assert "CsvScanExec" not in plan_names(s, df)
    assert df.schema.names == ["v", "k"]
    assert_same(df.collect(), ref_read("csv", path), "hive", sort=True)


def test_injected_file_fault_falls_back_once(tmp_path):
    data, schema = _fuzz(800, seed=9)
    path = write_both(tmp_path, data, schema)["port"]
    s = port_session(**{
        "spark.rapids.tpu.test.faultInjection.sites": "io.csv.file",
        "spark.rapids.tpu.test.faultInjection.oomEveryN": -1})
    got, info = port_read("csv", path, session=s)
    assert info.counters.get("CsvScanExec.hostFallbackFiles") == 1
    assert not info.counters.get("CsvScanExec.deviceDecodedFiles")
    assert_same(got, ref_read("csv", path), "injected")


def test_device_decode_switch_off_explains(tmp_path):
    data, schema = _fuzz(600, seed=12)
    path = write_both(tmp_path, data, schema)["port"]
    key = "spark.rapids.sql.csv.deviceDecode.enabled"
    s = port_session(**{key: False, "spark.rapids.sql.explain": "NOT_ON_TPU"})
    df = s.read.csv(path)
    names = plan_names(s, df)
    assert "CsvScanExec" not in names and "CpuFileScanExec" in names
    assert "CpuFileScanExec cannot run on TPU because" in s.last_explain \
        and f"{key} is false" in s.last_explain
    assert_same(df.collect(), ref_read("csv", path), "switch off")


def test_device_parse_in_reader_sized_slices(tmp_path):
    """``spark.rapids.sql.reader.batchSizeRows`` cuts a file's device
    parse into slices of at most that many rows."""
    data, schema = _fuzz(700, seed=13)
    path = write_both(tmp_path, data, schema)["port"]
    conf = {"spark.rapids.sql.reader.batchSizeRows": 96}
    s = port_session(**conf)
    df = s.read.csv(path)
    scan = s.plan(df._plan)
    while not isinstance(scan, CD.CsvScanExec):
        scan = scan.children[0]
    ctx = ExecContext(torch.device("cpu"), conf=TorchConf(conf))
    rows = [int(b.n_rows) for part in scan.execute(ctx) for b in part]
    ctx.run_cleanups()
    assert sum(rows) == 700 and len(rows) >= 700 // 96 and max(rows) <= 96
    got, info = port_read("csv", path, session=s)
    assert not info.counters.get("CsvScanExec.hostFallbackFiles")
    assert_same(got, ref_read("csv", path), "slices")


@pytest.mark.parametrize("option,value,match", [
    ("delimiter", "||", "single character"),
    ("multiLine", "true", "multiLine"),
    ("charset", "ISO-8859-1", "charset"),
    ("quote", ",", "differ"),
])
def test_option_errors_are_the_reference(option, value, match, tmp_path):
    path = str(tmp_path / "gate.csv")
    with open(path, "w") as f:
        f.write("a,b\n1,x\n")
    with pytest.raises(ValueError, match=match):
        cpu_session().read.option(option, value).csv(path).collect()
    with pytest.raises(ValueError, match=match):
        port_session().read.option(option, value).csv(path).collect()
    with pytest.raises(ValueError, match=match):
        FILES.validate_csv_options({option: value})


def test_committed_fixtures(tmp_path):
    """``tests/data/torch_io``'s CSV files against their stored values
    and the reference's reads."""
    here = os.path.join(os.path.dirname(__file__), "data", "torch_io")
    want = np.load(os.path.join(here, "expected.npz"))
    for name, fallback in (("quoted_exp.csv", 1), ("crlf.csv", 0)):
        path = os.path.join(here, name)
        got, info = port_read("csv", path)
        assert info.counters.get("CsvScanExec.hostFallbackFiles", 0) \
            == fallback
        stored = {c: (want[f"{name}/{c}"], want[f"{name}/{c}/valid"])
                  for c in got.schema.names}
        assert_same(got, stored, name)
        assert_same(got, ref_read("csv", path), name)


def test_threaded_separator_search_matches_the_line_count(monkeypatch):
    """The separator search cut into pieces on threads finds the
    boundaries the per-line count finds."""
    rng = np.random.default_rng(12)
    lines = [",".join(str(v) for v in rng.integers(0, 10 ** 6, 4))
             for _ in range(5000)]
    buf = np.frombuffer(("a,b,c,d\r\n" + "\r\n".join(lines) + "\r\n")
                        .encode(), np.uint8)
    monkeypatch.setattr(CD, "_SCAN_CHUNK", 1 << 10)
    assert CD._threads(len(buf)) > 1
    seps = CD.separators(buf, ord(","), ord('"'))
    assert not seps[2] and seps[1] == 5001
    got = CD.boundaries(buf, ord(","), 4, True, seps=seps)
    want = CD._counted_boundaries(buf, ord(","), 4, True, None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
