"""The port's parquet scan (``spark_rapids_tpu_torch/io``) on the CPU: its
thrift reader and writer, its footer reader against
``pq.ParquetFile(...).metadata``, its plain snappy codec against
``pa.Codec("snappy")`` (every tag kind, overlapping copies, malformed
input), and its decode (``device="cpu"``) of pyarrow-written files
against ``pq.read_table`` and, where the layout is in its device scope,
the reference's ``decode_row_group``; every out-of-scope layout raises
naming the file, the column and the reason; ``rebase_guard`` against the
reference's.

Equality is exact: values, validity, dates as days, strings as text.
"""

import datetime
import struct
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import torch

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.io import parquet_device as RPD
from spark_rapids_tpu.io.parquet_device import _Thrift
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.io import parquet_device as PD
from spark_rapids_tpu_torch.io import parquet_meta as M
from spark_rapids_tpu_torch.io import snappy as S
from spark_rapids_tpu_torch.io import snappy_cases as SC
from spark_rapids_tpu_torch.io.thrift import (T_BINARY, T_I32, T_STRUCT,
                                              Thrift, ThriftWriter)
from spark_rapids_tpu_torch.session import TorchSession

FIXTURE = Path(__file__).resolve().parent / "data" / "lineitem_fixture.parquet"
N = 3000


# -- thrift -------------------------------------------------------------------


def test_thrift_round_trip():
    w = ThriftWriter()
    w.i32(1, -7)
    w.i64(3, -(1 << 40))
    w.string(4, "naïve")
    w.list_begin(5, T_I32, 20)
    for v in range(-10, 10):
        w.i32_elem(v)
    w.struct_begin(20)            # a field id jump past 15
    w.i32(1, 42)
    w.list_begin(2, T_BINARY, 2)
    w.binary_elem(b"a")
    w.binary_elem(b"")
    w.struct_end()
    w.list_begin(21, T_STRUCT, 2)
    for k in (1, 2):
        w.elem_struct_begin()
        w.i64(1, k)
        w.struct_end()
    raw = w.done()
    got = Thrift(raw).read_struct()
    assert got == {1: -7, 3: -(1 << 40), 4: "naïve".encode(),
                   5: list(range(-10, 10)), 20: {1: 42, 2: [b"a", b""]},
                   21: [{1: 1}, {1: 2}]}
    assert _Thrift(raw).read_struct() == got


def test_thrift_skips_fields_it_does_not_know():
    """Bools, doubles, maps, sets and nested structs parse structurally,
    so a reader looking only at field 9 still finds it."""
    raw = bytes([0x11, 0x22, 0x17]) + struct.pack("<d", 2.5) + bytes(
        [0x1B, 0x02, 0x55, 0x02, 0x03, 0x06, 0x06,   # map {1: -2, 3: 3}
         0x1A, 0x11, 0x01,                           # set {true}
         0x1C, 0x15, 0x08, 0x00,                     # struct {1: 4}
         0x15, 0x0E, 0x00])
    got = Thrift(raw).read_struct()
    assert got[1] is True and got[3] is False and got[4] == 2.5
    assert got[5] == {1: -2, 3: 3}
    assert got[6] == [True]
    assert got[7] == {1: 4}
    assert got[8] == 7


def test_page_headers_match_reference():
    """Every page header of a pyarrow file, read by the port and by the
    reference's ``_Thrift``."""
    raw = FIXTURE.read_bytes()
    meta = M.read_footer(str(FIXTURE))
    n = 0
    for rg in meta.row_groups:
        for c in rg.columns:
            pos = c.start
            while pos < c.start + c.total_compressed_size:
                ph = PD.parse_page_header(raw, pos)
                ref = RPD._parse_page_header(raw, pos)
                assert (ph.page_type, ph.uncompressed_size,
                        ph.compressed_size, ph.num_values, ph.encoding) == (
                    ref.page_type, ref.uncompressed_size,
                    ref.compressed_size, ref.num_values, ref.encoding)
                assert ph.payload_pos == pos + ref.header_len
                pos = ph.payload_pos + ph.compressed_size
                n += 1
    assert n > 100


# -- the footer -----------------------------------------------------------------


def _stat_int(raw: bytes) -> int:
    return int.from_bytes(raw, "little", signed=True)


@pytest.fixture(scope="module")
def layout_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("layouts")
    return {name: _write_layout(d, name) for name in LAYOUTS}


def test_footer_matches_pyarrow(layout_files):
    for path in [str(FIXTURE)] + list(layout_files.values()):
        got = M.read_footer(path)
        pf = pq.ParquetFile(path)
        want = pf.metadata
        assert got.num_rows == want.num_rows
        assert got.num_row_groups == want.num_row_groups
        assert got.created_by == want.created_by
        assert got.key_value_metadata == dict(want.metadata or {})
        assert [leaf.name for leaf in got.leaves] == pf.schema.names
        for i, leaf in enumerate(got.leaves):
            assert leaf.max_definition_level == \
                pf.schema.column(i).max_definition_level
            assert leaf.physical_type == pf.schema.column(i).physical_type
        for rg in range(want.num_row_groups):
            g, w = got.row_groups[rg], want.row_group(rg)
            assert g.num_rows == w.num_rows
            for ci in range(w.num_columns):
                gc, wc = g.columns[ci], w.column(ci)
                assert gc.path_in_schema == wc.path_in_schema
                assert gc.physical_type == wc.physical_type
                assert gc.codec == wc.compression
                assert tuple(gc.encodings) == tuple(wc.encodings)
                assert gc.data_page_offset == wc.data_page_offset
                assert gc.has_dictionary_page == wc.has_dictionary_page
                if wc.has_dictionary_page:
                    assert gc.dictionary_page_offset == \
                        wc.dictionary_page_offset
                assert gc.total_compressed_size == wc.total_compressed_size
                assert gc.total_uncompressed_size == \
                    wc.total_uncompressed_size
                assert gc.num_values == wc.num_values
                st = wc.statistics
                if st is not None and st.has_min_max and \
                        wc.physical_type == "INT64" and \
                        st.logical_type.type == "NONE":
                    assert _stat_int(gc.statistics.min) == st.min
                    assert _stat_int(gc.statistics.max) == st.max


def test_schema_from_parquet_maps_types(tmp_path):
    path = str(tmp_path / "types.parquet")
    tbl = pa.table({
        "b": pa.array([True, None]), "i8": pa.array([1, 2], pa.int8()),
        "i16": pa.array([1, 2], pa.int16()),
        "i32": pa.array([1, 2], pa.int32()),
        "i64": pa.array([1, 2], pa.int64()),
        "f32": pa.array([1, 2], pa.float32()),
        "f64": pa.array([1, 2], pa.float64()),
        "d": pa.array([1, 2], pa.int32()).cast(pa.date32()),
        "ts": pa.array([1, 2], pa.timestamp("us")),
        "s": pa.array(["a", None])})
    pq.write_table(tbl, path)
    schema = M.schema_from_parquet(M.read_footer(path), path)
    assert [(f.name, f.data_type) for f in schema] == [
        ("b", T.BOOLEAN), ("i8", T.BYTE), ("i16", T.SHORT), ("i32", T.INT),
        ("i64", T.LONG), ("f32", T.FLOAT), ("f64", T.DOUBLE), ("d", T.DATE),
        ("ts", T.TIMESTAMP), ("s", T.STRING)]
    assert all(f.nullable for f in schema)


def test_footer_rejects_non_parquet(tmp_path):
    path = tmp_path / "x.parquet"
    path.write_bytes(b"PAR1" + bytes(20) + b"XXXX")
    with pytest.raises(M.ParquetFormatError, match="PAR1"):
        M.read_footer(str(path))


# -- snappy -----------------------------------------------------------------------


CODEC = pa.Codec("snappy")


@pytest.mark.parametrize("name", list(SC.valid_cases()))
def test_snappy_tag_kinds_against_pyarrow(name):
    raw, want = SC.valid_cases()[name]
    assert CODEC.decompress(raw, decompressed_size=len(want)
                            ).to_pybytes() == want
    assert S.decompress_plain(raw, len(want)) == want


@pytest.mark.parametrize("name", list(SC.malformed_cases()))
def test_snappy_malformed_input_raises(name):
    raw = SC.malformed_cases()[name]
    with pytest.raises(S.SnappyError):
        S.decompress_plain(raw)
    size = S._varint(raw, 0)[0] if raw and raw[0] != 0xFF else 5
    with pytest.raises(Exception):
        CODEC.decompress(raw, decompressed_size=size)


def test_snappy_pages_into_one_buffer():
    src, pages, size, wants = SC.page_batch(SC.valid_cases())
    dst = np.zeros(size, np.uint8)
    S.decompress_pages(src, pages, dst, "cpu")
    for (_, _, d, n), want in zip(pages.tolist(), wants):
        assert dst[d:d + n].tobytes() == want
    bad = pages.copy()
    bad[0, 3] += 1      # a page size the preamble does not state
    with pytest.raises(S.SnappyError, match="preamble"):
        S.decompress_pages(src, bad, dst, "cpu")
    bad = pages.copy()
    bad[-1, 2] = size   # a destination range past the buffer
    with pytest.raises(S.SnappyError, match="outside"):
        S.decompress_pages(src, bad, dst, "cpu")


@pytest.mark.parametrize("name", list(SC.compress_inputs()))
def test_snappy_compress_round_trips_through_pyarrow(name):
    data = SC.compress_inputs()[name]
    ours = S.compress_plain(data)
    assert CODEC.decompress(ours, decompressed_size=len(data)
                            ).to_pybytes() == data
    assert S.decompress_plain(ours, len(data)) == data
    theirs = CODEC.compress(data).to_pybytes()
    assert S.decompress_plain(theirs, len(data)) == data
    assert S.compress(data, "cpu") == ours


def test_snappy_refuses_other_devices():
    with pytest.raises(ValueError, match="meta"):
        S.compress(b"abc", "meta")


# -- decode layouts -------------------------------------------------------------


def _base_table(n=N, seed=0):
    rng = np.random.default_rng(seed)
    null = rng.random(n) < 0.15
    return pa.table({
        "k": pa.array(rng.integers(0, 10 ** 9, n), pa.int64()),
        "q": pa.array(rng.integers(1, 51, n).astype(np.float64),
                      mask=null),
        "d": pa.array(rng.integers(-3000, 20000, n).astype(np.int32),
                      mask=rng.random(n) < 0.1).cast(pa.date32()),
        "s": pa.array(np.array(["", "AIR", "MAIL", "", "TRUCK"],
                               dtype=object)[rng.integers(0, 5, n)],
                      pa.string(), mask=rng.random(n) < 0.2),
        "c": pa.array(rng.integers(-5, 5, n).astype(np.int32)),
    })


def _typed_table(n=N, seed=1):
    rng = np.random.default_rng(seed)
    return pa.table({
        "i8": pa.array(rng.integers(-128, 128, n).astype(np.int8)),
        "i16": pa.array(rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16),
                        mask=rng.random(n) < 0.3),
        "f32": pa.array(rng.normal(size=n).astype(np.float32)),
        "f64": pa.array(np.where(rng.random(n) < 0.05, np.nan,
                                 rng.normal(size=n))),
        "ts": pa.array(rng.integers(-10 ** 15, 10 ** 15, n),
                       pa.timestamp("us")),
    })


def _growing_table(n=8000):
    """String codes whose dictionary fills as the pages go: the first
    page's codes need few bits, the last's 12."""
    keys = np.minimum(np.arange(n) // 2, 3999)
    return pa.table({"s": pa.array([f"v{k:05d}" for k in keys]),
                     "k": pa.array(keys.astype(np.int64))})


def _required(tbl):
    return tbl.cast(pa.schema([pa.field(f.name, f.type, nullable=False)
                               for f in tbl.schema]))


#: name -> (table, pq.write_table keywords, the reference's device
#: decoder takes it)
LAYOUTS = {
    "nulls": (_base_table, {}, True),
    "all null": (lambda: pa.table({
        "n": pa.nulls(N, pa.int64()), "s": pa.nulls(N, pa.string()),
        "k": pa.array(np.arange(N, dtype=np.int64))}), {}, True),
    "required": (lambda: _required(pa.table({
        "k": pa.array(np.arange(N, dtype=np.int64)),
        "s": pa.array(np.array(["a", "bb", ""], dtype=object)[
            np.arange(N) % 3], pa.string())})), {}, True),
    "pages and row groups": (_base_table, dict(row_group_size=700,
                                               data_page_size=1024), True),
    "dictionary falls back to PLAIN": (_base_table,
                                       dict(dictionary_pagesize_limit=512,
                                            data_page_size=1024), False),
    "bit widths grow across pages": (_growing_table,
                                     dict(data_page_size=512), True),
    "dates, empty strings, uncompressed": (_base_table,
                                           dict(compression="none"), True),
    "snappy": (_base_table, dict(compression="snappy"), True),
    "types": (_typed_table, dict(data_page_size=2048), True),
    "empty row group": (_base_table, "empty row group", False),
}


def _write_layout(d: Path, name: str) -> str:
    make, kw, _ = LAYOUTS[name]
    tbl = make()
    path = str(d / (name.replace(" ", "_").replace(",", "") + ".parquet"))
    if kw == "empty row group":
        with pq.ParquetWriter(path, tbl.schema) as w:
            w.write_table(tbl.slice(0, 1000))
            w.write_table(tbl.slice(0, 0))
            w.write_table(tbl.slice(1000, 500))
    else:
        pq.write_table(tbl, path, **kw)
    return path


def _arrow_columns(tbl: pa.Table) -> dict:
    """name -> (values with nulls as 0 or None, validity), dates as int32
    days and timestamps as int64 microseconds."""
    out = {}
    for name in tbl.column_names:
        arr = tbl.column(name).combine_chunks()
        valid = np.asarray(arr.is_valid()).astype(bool) if len(arr) \
            else np.zeros(0, bool)
        if pa.types.is_string(arr.type):
            vals = np.array(arr.to_pylist(), dtype=object)
        else:
            if pa.types.is_date32(arr.type):
                arr = arr.cast(pa.int32())
            elif pa.types.is_timestamp(arr.type):
                arr = arr.cast(pa.int64())
            elif pa.types.is_null(arr.type):
                arr = pa.array([0] * len(arr), pa.int64())
            fill = False if pa.types.is_boolean(arr.type) else 0
            vals = np.asarray(arr.fill_null(fill).to_numpy(
                zero_copy_only=False))
        out[name] = (vals, valid)
    return out


def _assert_equal(got: HostBatch, want: dict, what: str) -> None:
    assert list(got.columns) == list(want), what
    for name, (wv, wvalid) in want.items():
        gv, gvalid = np.asarray(got.columns[name]), got.validity[name]
        np.testing.assert_array_equal(gvalid, wvalid, err_msg=f"{what} "
                                      f"{name} validity")
        if wv.dtype == object:
            assert list(np.where(wvalid, gv, None)) == \
                list(np.where(wvalid, wv, None)), f"{what} {name}"
        else:
            np.testing.assert_array_equal(
                np.where(wvalid, gv, 0).astype(wv.dtype),
                np.where(wvalid, wv, 0), err_msg=f"{what} {name}")


def _port_read(path: str, **conf) -> HostBatch:
    return TorchSession(conf or None, device="cpu").read.parquet(path) \
        .collect()


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_decode_matches_pyarrow(name, layout_files):
    path = layout_files[name]
    _assert_equal(_port_read(path), _arrow_columns(pq.read_table(path)),
                  name)


@pytest.mark.parametrize("name", [n for n, (_, _, ref) in LAYOUTS.items()
                                  if ref])
def test_decode_matches_reference_decoder(name, layout_files):
    path = layout_files[name]
    pf = pq.ParquetFile(path)
    rschema = RT.schema_from_arrow(pf.schema_arrow)
    meta = M.read_footer(path)
    schema = M.schema_from_parquet(meta, path)
    for rg in range(meta.num_row_groups):
        want = RPD.decode_row_group(path, rg, rschema, pf=pf).to_arrow()
        got = HostBatch.from_device(PD.decode_row_group(
            path, rg, schema, meta, device="cpu"))
        _assert_equal(got, _arrow_columns(pa.Table.from_batches([want])),
                      f"{name} row group {rg}")


def _page_layouts(path: str) -> dict:
    """column -> [(page type, encoding, dictionary bit width or None)]
    over every row group, read through the port's page walk."""
    raw = Path(path).read_bytes()
    meta = M.read_footer(path)
    out = {}
    for rg in meta.row_groups:
        for c in rg.columns:
            pos = c.start
            while pos < c.start + c.total_compressed_size:
                ph = PD.parse_page_header(raw, pos)
                payload = raw[ph.payload_pos:ph.payload_pos
                              + ph.compressed_size]
                if c.codec == "SNAPPY":
                    payload = S.decompress_plain(payload,
                                                 ph.uncompressed_size)
                bw = None
                if ph.page_type == 0 and ph.encoding == 8 and ph.num_values:
                    skip = 0
                    leaf = next(x for x in meta.leaves
                                if x.name == c.path_in_schema)
                    if leaf.max_definition_level:
                        skip = 4 + struct.unpack_from("<I", payload)[0]
                    bw = payload[skip]
                out.setdefault(c.path_in_schema, []).append(
                    (ph.page_type, ph.encoding, bw))
                pos = ph.payload_pos + ph.compressed_size
    return out


def test_layouts_hold_what_they_name(layout_files):
    fallback = _page_layouts(layout_files["dictionary falls back to PLAIN"])
    assert any({(0, 8), (0, 0)} <= {p[:2] for p in pages}
               for pages in fallback.values())
    widths = [p[2] for p in _page_layouts(
        layout_files["bit widths grow across pages"])["s"] if p[2]]
    assert widths[0] < widths[-1] and widths == sorted(widths)
    meta = M.read_footer(layout_files["empty row group"])
    assert [rg.num_rows for rg in meta.row_groups] == [1000, 0, 500]


def test_fixture_matches_pyarrow():
    """The committed fixture (``tests/data/make_lineitem_fixture.py``),
    the file the card's decode is held to."""
    _assert_equal(_port_read(str(FIXTURE)),
                  _arrow_columns(pq.read_table(FIXTURE)), "fixture")


def test_fixture_holds_the_layouts_the_writer_lacks():
    pages = _page_layouts(str(FIXTURE))
    mixed = [c for c, ps in pages.items()
             if {(0, 8), (0, 0)} <= {p[:2] for p in ps}]
    assert {"l_orderkey", "l_partkey", "l_extendedprice"} <= set(mixed)
    assert max(len(ps) for ps in pages.values()) > 10
    meta = M.read_footer(str(FIXTURE))
    assert [rg.num_rows for rg in meta.row_groups] == [4096] * 4 + [0]
    assert all(c.codec == "SNAPPY" for c in meta.row_groups[0].columns)
    req = {leaf.name for leaf in meta.leaves if leaf.repetition == 0}
    assert req == {"l_orderkey", "l_shipdate"}
    tbl = pq.read_table(FIXTURE)
    assert tbl.column("l_null").null_count == tbl.num_rows
    assert 0 < tbl.column("l_discount").null_count < tbl.num_rows
    assert "" in tbl.column("l_comment").to_pylist()


def test_scan_emits_a_partition_per_row_group(layout_files):
    from spark_rapids_tpu_torch.exec.execs import ExecContext
    path = layout_files["pages and row groups"]
    df = TorchSession(device="cpu").read.parquet(path)
    scan = df._session.plan(df._plan)
    ctx = ExecContext(torch.device("cpu"))
    parts = scan.execute(ctx)
    assert len(parts) == M.read_footer(path).num_row_groups
    assert [int(b.n_rows) for [b] in parts] == [700] * 4 + [200]
    assert ctx.counters["ParquetScanExec.rows"] == N
    assert set(ctx.exec_ms()) >= {f"ParquetScanExec.{k}" for k in (
        "parse", "read", "decompress", "runs", "upload", "decode")}


def test_read_parquet_runs_queries(layout_files):
    from spark_rapids_tpu_torch.ops import aggregates as A
    from spark_rapids_tpu_torch.ops import predicates as P
    from spark_rapids_tpu_torch.ops.expression import col, lit
    path = layout_files["pages and row groups"]
    df = TorchSession(device="cpu").read.parquet(path)
    got = (df.where(P.GreaterThan(col("c"), lit(0)))
           .group_by(col("s"))
           .agg(A.AggregateExpression(A.Count(), "n"))).collect()
    tbl = pq.read_table(path).to_pandas()
    want = tbl[tbl.c > 0].groupby("s", dropna=False).size()
    got_map = dict(zip(got.columns["s"], got.columns["n"]))
    assert got_map == {(None if k != k else k): v
                       for k, v in want.items()}


# -- out of scope ---------------------------------------------------------------


def _bit_width_25(path: str) -> None:
    """A dictionary column whose data page states bit width 25 (the byte
    after the REQUIRED page's header, UNCOMPRESSED)."""
    pq.write_table(_required(pa.table({"s": pa.array(["x", "y"] * 10)})),
                   path, compression="none")
    meta = M.read_footer(path)
    c = meta.row_groups[0].columns[0]
    raw = bytearray(Path(path).read_bytes())
    ph = PD.parse_page_header(raw, c.data_page_offset)
    raw[ph.payload_pos] = 25
    Path(path).write_bytes(bytes(raw))


#: name -> (writer of the file, column the error names, reason pattern)
OUT_OF_SCOPE = {
    "PLAIN byte-array pages": (lambda p: pq.write_table(
        pa.table({"s": ["a", "b"]}), p, use_dictionary=False), "s",
        "PLAIN byte-array data pages"),
    "v2 data pages": (lambda p: pq.write_table(
        pa.table({"k": [1, 2]}), p, data_page_version="2.0"), "k",
        "v2 data pages"),
    "nested columns": (lambda p: pq.write_table(
        pa.table({"l": [[1, 2], [3]]}), p), "l.list.element", "nested"),
    "INT96": (lambda p: pq.write_table(
        pa.table({"t": pa.array([1, 2], pa.timestamp("ns"))}), p,
        use_deprecated_int96_timestamps=True), "t", "INT96"),
    "dictionary bit width over 24": (_bit_width_25, "s",
                                     "bit width 25 is over 24"),
    "PLAIN booleans": (lambda p: pq.write_table(
        pa.table({"b": [True, False]}), p), "b", "PLAIN booleans"),
    "LZ4": (lambda p: pq.write_table(pa.table({"k": [1, 2]}), p,
                                     compression="lz4"), "k", "codec LZ4"),
    "ZSTD": (lambda p: pq.write_table(pa.table({"k": [1, 2]}), p,
                                      compression="zstd"), "k", "codec ZSTD"),
    "GZIP": (lambda p: pq.write_table(pa.table({"k": [1, 2]}), p,
                                      compression="gzip"), "k", "codec GZIP"),
}


#: Layouts the decoder took in since (the scan's host reader and its
#: device decode read them): each reads as pyarrow does instead.
NOW_READ = ("PLAIN byte-array pages", "v2 data pages", "PLAIN booleans",
            "GZIP")


@pytest.mark.parametrize("name", list(OUT_OF_SCOPE))
def test_out_of_scope_layout_raises(name, tmp_path):
    write, column, reason = OUT_OF_SCOPE[name]
    path = str(tmp_path / "x.parquet")
    write(path)
    if name in NOW_READ:
        _assert_equal(_port_read(path), _arrow_columns(pq.read_table(path)),
                      name)
        return
    with pytest.raises(NotImplementedError, match=reason) as e:
        _port_read(path)
    assert path in str(e.value) and repr(column) in str(e.value)


def test_scan_files_lists_like_pyarrow(tmp_path):
    for rel in ("b.parquet", "a.parquet", "_SUCCESS", ".hidden.parquet",
                "_meta.parquet", "notes.txt", "sub/c.parquet",
                ".dir/d.parquet"):
        p = tmp_path / rel
        p.parent.mkdir(exist_ok=True)
        p.write_bytes(b"")
    got = PD.scan_files([str(tmp_path)])
    assert got == [str(tmp_path / r) for r in ("a.parquet", "b.parquet",
                                                "sub/c.parquet")]
    assert PD.scan_files([str(tmp_path / "b.parquet"), str(tmp_path)])[0] \
        == str(tmp_path / "b.parquet")
    # a hive directory's files are listed too (the host scan adds its
    # partition column)
    (tmp_path / "k=1").mkdir()
    (tmp_path / "k=1" / "e.parquet").write_bytes(b"")
    assert str(tmp_path / "k=1" / "e.parquet") in \
        PD.scan_files([str(tmp_path)])
    with pytest.raises(FileNotFoundError):
        PD.scan_files([str(tmp_path / "missing")])


def test_scan_refuses_files_of_another_schema(tmp_path):
    pq.write_table(pa.table({"k": [1, 2]}), tmp_path / "a.parquet")
    pq.write_table(pa.table({"k": [1.5]}), tmp_path / "b.parquet")
    with pytest.raises(ValueError, match="differs"):
        _port_read(str(tmp_path))


# -- rebase guard ---------------------------------------------------------------


def _dated(path: str, day: int, marker: bool, stats: bool = True) -> None:
    tbl = pa.table({"d": pa.array([day, 19000], pa.int32())
                    .cast(pa.date32()), "k": [1, 2]})
    if marker:
        tbl = tbl.replace_schema_metadata(
            {b"org.apache.spark.legacyDateTime": b""})
    pq.write_table(tbl, path, write_statistics=stats)


ANCIENT = (datetime.date(1500, 1, 1) - datetime.date(1970, 1, 1)).days
#: (first date, legacy marker, statistics, mode) -> raises
REBASE_CASES = [
    (ANCIENT, True, True, "EXCEPTION", True),
    (ANCIENT, True, True, "CORRECTED", False),
    (ANCIENT, True, True, "LEGACY", True),
    (ANCIENT, False, True, "EXCEPTION", False),
    (0, True, True, "EXCEPTION", False),
    (0, True, False, "EXCEPTION", True),   # no statistics: conservative
    (0, True, True, "LEGACY", True),
    (PD.JULIAN_SWITCH_DAYS, True, True, "EXCEPTION", False),
    (PD.JULIAN_SWITCH_DAYS - 1, True, True, "EXCEPTION", True),
]


@pytest.mark.parametrize("day,marker,stats,mode,raises", REBASE_CASES)
def test_rebase_guard_matches_reference(tmp_path, day, marker, stats, mode,
                                        raises):
    path = str(tmp_path / "d.parquet")
    _dated(path, day, marker, stats)
    meta = M.read_footer(path)
    schema = M.schema_from_parquet(meta, path)
    pf = pq.ParquetFile(path)
    rschema = RT.schema_from_arrow(pf.schema_arrow)
    for guard, args, err in (
            (PD.rebase_guard, (meta, schema), PD.SparkUpgradeError),
            (RPD.rebase_guard, (pf.metadata, rschema),
             RPD.SparkUpgradeError)):
        if raises:
            with pytest.raises(err):
                guard(*args, mode, path)
        else:
            guard(*args, mode, path)
    conf = {"spark.sql.legacy.parquet.datetimeRebaseModeInRead": mode}
    if raises:
        with pytest.raises(PD.SparkUpgradeError):
            _port_read(path, **conf)
    else:
        assert list(_port_read(path, **conf).columns["d"]) == [day, 19000]
