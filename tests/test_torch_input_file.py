"""``input_file_name()``, ``input_file_block_start()`` and
``input_file_block_length()`` (``ops/nondeterministic.py``,
``plan/input_file.py``) through ``TorchSession`` on the CPU against the
JAX package's ``TpuSession``, over parquet files written to ``tmp_path``.

The rewrite turns the family into the scan's three hidden per-file
columns (the path, 0 and the file's size), which flow through every
projection between the scan and their use and are projected away at the
end; the port's scan appends them after its device decode, the
reference's host scan synthesizes them. Covered: the three selected
beside data columns, a filter on the file name, a grouping by file with
a count and a sum, a chain of projections, the no-scan constants ('' and
-1) over an uploaded table, and a union of two scans (Spark's per-task
file context is not modelled: the constants, as in the reference).
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.ops import aggregates as RA
from spark_rapids_tpu.ops import nondeterministic as RND
from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit
from spark_rapids_tpu.session import TpuSession

from spark_rapids_tpu_torch.ops import aggregates as A
from spark_rapids_tpu_torch.ops import nondeterministic as ND
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.plan import input_file as IF
from spark_rapids_tpu_torch.session import TorchSession

from test_torch_complex import check_same

ROWS = (120, 90, 150)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Three parquet files of ``ROWS`` rows in one directory (one row
    group each, uncompressed)."""
    d = tmp_path_factory.mktemp("input_file")
    rng = np.random.default_rng(31)
    for i, n in enumerate(ROWS):
        pq.write_table(pa.table({
            "k": pa.array(rng.integers(0, 20, n), pa.int64()),
            "v": pa.array(np.round(rng.normal(0, 10, n), 2), pa.float64()),
        }), str(d / f"part-{i}.parquet"), compression="NONE")
    return str(d)


def _sessions():
    return TorchSession(device="cpu"), TpuSession(
        {"spark.rapids.sql.enabled": True})


def _meta(M):
    return [M.InputFileName().alias("f"),
            M.InputFileBlockStart().alias("s"),
            M.InputFileBlockLength().alias("n")]


def test_selected_beside_data(files):
    ps, rs = _sessions()
    rows = check_same(
        ps.read.parquet(files).select(col("k"), *_meta(ND)),
        rs.read.parquet(files).select(rcol("k"), *_meta(RND)))
    names = sorted(os.listdir(files))
    assert [r[1] for r in rows] == sum(
        ([os.path.join(files, f)] * n for f, n in zip(names, ROWS)), [])
    assert {r[2] for r in rows} == {0}
    assert {r[3] for r in rows} == {os.path.getsize(os.path.join(files, f))
                                    for f in names}


def test_grouped_by_file(files):
    ps, rs = _sessions()
    check_same(
        ps.read.parquet(files).select(ND.InputFileName().alias("f"),
                                      col("v")).group_by(col("f")).agg(
            A.AggregateExpression(A.Count(), "c"),
            A.AggregateExpression(A.Sum(col("v")), "sv")),
        rs.read.parquet(files).select(RND.InputFileName().alias("f"),
                                      rcol("v")).group_by(rcol("f")).agg(
            RA.AggregateExpression(RA.Count(), "c"),
            RA.AggregateExpression(RA.Sum(rcol("v")), "sv")),
        ordered=False)


def test_filter_on_file_name_through_projections(files):
    """A filter on the name, under two projections that must pass the
    hidden columns on, and the block length used above them."""
    ps, rs = _sessions()
    last = os.path.join(files, "part-2.parquet")
    check_same(
        ps.read.parquet(files).select(col("k"), col("v")).where(
            P.EqualTo(ND.InputFileName(), lit(last))).select(
            col("k"), ND.InputFileBlockLength().alias("n")),
        rs.read.parquet(files).select(rcol("k"), rcol("v")).where(
            RP.EqualTo(RND.InputFileName(), rlit(last))).select(
            rcol("k"), RND.InputFileBlockLength().alias("n")))


def test_no_scan_constants():
    ps, rs = _sessions()
    got = ps.create_dataframe({"a": np.arange(5)}).select(
        col("a"), *_meta(ND)).collect()
    want = rs.create_dataframe({"a": list(range(5))}).select(
        rcol("a"), *_meta(RND)).collect().to_pydict()
    assert got.columns["f"].tolist() == want["f"] == [""] * 5
    assert got.columns["s"].tolist() == want["s"] == [-1] * 5
    assert got.columns["n"].tolist() == want["n"] == [-1] * 5


def test_two_scans_take_the_constants(files):
    ps, rs = _sessions()
    check_same(
        ps.read.parquet(files).union(ps.read.parquet(files)).select(
            col("k"), ND.InputFileName().alias("f")).group_by(
            col("f")).agg(A.AggregateExpression(A.Count(), "c")),
        rs.read.parquet(files).union(rs.read.parquet(files)).select(
            rcol("k"), RND.InputFileName().alias("f")).group_by(
            rcol("f")).agg(RA.AggregateExpression(RA.Count(), "c")))


def test_rewrite_leaves_other_plans_alone(files):
    ps, _ = _sessions()
    plan = ps.read.parquet(files).select(col("k"))._plan
    assert IF.rewrite_input_file_exprs(plan) is plan
    rewritten = IF.rewrite_input_file_exprs(
        ps.read.parquet(files).select(ND.InputFileName().alias("f"))._plan)
    assert rewritten.schema.names == ["f"]
    assert "files=3" in ps.explain(ps.read.parquet(files).select(
        ND.InputFileName().alias("f"))._plan)
