"""Queries over the hash exchange: the port's session against the JAX
package's, on the CPU.

TPC-H Q1 runs over ``lineitem.repartition(16, l_returnflag,
l_linestatus)`` (string keys: the ``hash`` kernel's plain version) and
over ``lineitem.repartition(4, l_orderkey)`` (the shape
``tools/chaos_bench.py`` forces into Q1), and the string group-by of
``tests/test_pallas_kernels.py::test_string_shuffle_hash_query`` runs over
``repartition(4, "k")``. Answers compare as sorted rows under
``tests/harness.py``: integers and strings exact, floats to its device
tolerance. One exchange's partitions must hold exactly the rows the
reference's ``TpuShuffleExchangeExec`` puts in each, and the other
queries keep their answers over repartitioned tables.
"""

import datetime

import numpy as np
import pytest

import torch

from harness import DEVICE_FLOAT_TOL, _canonical_rows, _rows_equal
from spark_rapids_tpu.ops import aggregates as RAGG
from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops import strings as RS
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit
from spark_rapids_tpu.plan.physical import ExecContext as RExecContext
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.workloads import tpch as rtpch

from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.exec import execs as E
from spark_rapids_tpu_torch.ops import aggregates as AGG
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops import strings as S
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.ops.kernels.cuda import hashing as HK
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.workloads import tpch

ROWS = 1 << 13
REPARTITIONS = {"string keys": (16, "l_returnflag", "l_linestatus"),
                "bigint key": (4, "l_orderkey")}
REF_CONF = {"spark.rapids.sql.enabled": True,
            "spark.rapids.tpu.pallas.enabled": True,
            "spark.rapids.sql.variableFloatAgg.enabled": True}


@pytest.fixture(scope="module")
def sessions():
    ref = TpuSession(dict(REF_CONF))
    port = TorchSession(device="cpu")
    return ((ref, rtpch.load(ref, rtpch.gen_tables(ROWS))),
            (port, tpch.load(port, tpch.gen_tables(ROWS))))


def _port_rows(hb: HostBatch):
    cols = [hb.columns[n] for n in hb.schema.names]
    valid = [hb.validity[n] for n in hb.schema.names]
    rows = []
    for i in range(hb.num_rows):
        row = []
        for c, v in zip(cols, valid):
            x = c[i].item() if hasattr(c[i], "item") else c[i]
            row.append(x if v[i] else None)
        rows.append(tuple(row))
    return rows


def _ref_rows(table):
    """The reference's rows with dates as days since the epoch, the
    port's host form."""
    epoch = datetime.date(1970, 1, 1)
    return [tuple((x - epoch).days if isinstance(x, datetime.date) else x
                  for x in row) for row in _canonical_rows(table)]


def _sorted(rows):
    return sorted(rows, key=lambda r: tuple(str(x) for x in r))


def _assert_same_rows(got, want) -> None:
    got, want = _sorted(got), _sorted(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert _rows_equal(list(g), list(w), DEVICE_FLOAT_TOL), (g, w)


@pytest.mark.parametrize("shape", list(REPARTITIONS))
def test_q1_over_repartition_matches_reference(shape, sessions):
    (_, rdfs), (port, pdfs) = sessions
    spec = REPARTITIONS[shape]
    want = rtpch.q1({**rdfs, "lineitem": rdfs["lineitem"].repartition(*spec)}
                    ).collect()
    calls = []
    plain = HK.murmur3_string_rows

    def counting(*args):
        calls.append(args[0].shape)
        return plain(*args)
    HK.murmur3_string_rows = counting
    try:
        got = tpch.q1({**pdfs,
                       "lineitem": pdfs["lineitem"].repartition(*spec)}
                      ).collect()
    finally:
        HK.murmur3_string_rows = plain
    _assert_same_rows(_port_rows(got), _ref_rows(want))
    assert list(got.columns) == want.column_names
    # string keys hash through the kernel's ragged entry, one call per key
    assert len(calls) == (2 if shape == "string keys" else 0)
    info = port.last_query
    assert info.site_kinds == ["aggregate"] and info.attempts == 1
    assert {"ShuffleExchangeExec.partition", "ShuffleExchangeExec.serialize",
            "HashAggregateExec.merge"} <= set(info.exec_ms)


def test_string_shuffle_hash_query_matches_reference():
    """``test_string_shuffle_hash_query``'s data and aggregate, over a
    hash exchange of four partitions on the string key."""
    data = {"k": ["apple", "pear", "fig", "apple", "kiwi", "fig",
                  "dragonfruit", ""] * 40,
            "v": list(range(320))}
    ref = TpuSession(dict(REF_CONF))
    want = ref.create_dataframe(data).repartition(4, "k").group_by(
        rcol("k")).agg(RAGG.AggregateExpression(RAGG.Sum(rcol("v")), "s")
                       ).collect()
    port = TorchSession(device="cpu")
    got = port.create_dataframe(
        {"k": np.array(data["k"]), "v": np.array(data["v"], np.int64)}
    ).repartition(4, "k").group_by(col("k")).agg(
        AGG.AggregateExpression(AGG.Sum(col("v")), "s")).collect()
    assert _sorted(_port_rows(got)) == _sorted(_ref_rows(want))


def _exchange_of(plan):
    node = plan
    while not hasattr(node, "partitioner_factory"):
        node = node.children[0]
    return node


EXCHANGES = {
    "hash string keys": ((16, "l_returnflag", "l_linestatus"), False),
    "hash bigint key": ((4, "l_orderkey"), False),
    "hash date and bigint over a filter": ((5, "l_shipdate", "l_partkey"),
                                           True),
    "round robin over a filter": ((3,), True),
    "hash flat string key": ((6, "mode2"), False),
}


@pytest.mark.parametrize("case", list(EXCHANGES))
def test_exchange_partitions_match_reference(case, sessions):
    (ref, rdfs), (port, pdfs) = sessions
    spec, filtered = EXCHANGES[case]
    cols = ["l_orderkey", "l_partkey", "l_returnflag", "l_linestatus",
            "l_shipdate", "l_quantity", "l_shipmode"]
    rdf = rdfs["lineitem"].select(*cols).with_column(
        "mode2", RS.Substring(rcol("l_shipmode"), rlit(1), rlit(2)))
    pdf = pdfs["lineitem"].select(*cols).with_column(
        "mode2", S.Substring(col("l_shipmode"), lit(1), lit(2)))
    if filtered:
        rdf = rdf.where(RP.LessThan(rcol("l_quantity"), rlit(20.0)))
        pdf = pdf.where(P.LessThan(col("l_quantity"), lit(20.0)))
    rex = _exchange_of(ref.plan(rdf.repartition(*spec)._plan))
    rparts = rex.execute(RExecContext(ref.conf,
                                      catalog=ref.device_manager.catalog))
    want = [[row for db in it for row in _ref_rows(db.to_arrow())]
            for it in rparts]
    pex = _exchange_of(port.plan(pdf.repartition(*spec)._plan))
    pparts = pex.execute(E.ExecContext(torch.device("cpu")))
    got = [[row for b in part for row in _port_rows(HostBatch.from_device(b))]
           for part in pparts]
    assert len(got) == len(want) == spec[0]
    for p, (g, w) in enumerate(zip(got, want)):
        assert _sorted(g) == _sorted(w), f"partition {p}"
    assert sum(map(len, got)) > 0
    # empty partitions yield no batch
    assert all((len(part) == 0) == (not rows)
               for part, rows in zip(pparts, got))


@pytest.mark.parametrize("q", ["q3", "q4", "q6", "q22"])
def test_queries_over_repartitioned_tables_keep_their_answers(q, sessions):
    """Joins, sort, top-k and the global aggregate accumulate the
    partitions of an exchange into one batch: over repartitioned tables
    each query gives the rows it gives without an exchange."""
    _, (port, pdfs) = sessions
    want = getattr(tpch, q)(pdfs).collect()
    got = getattr(tpch, q)({
        **pdfs, "lineitem": pdfs["lineitem"].repartition(5, "l_orderkey"),
        "orders": pdfs["orders"].repartition(3),
        "customer": pdfs["customer"].repartition(2, "c_phone")}).collect()
    g, w = _port_rows(got), _port_rows(want)
    if q in ("q4", "q22"):  # ORDER BY unique keys: the same order too
        assert len(g) == len(w) > 0
        for a, b in zip(g, w):
            assert _rows_equal(list(a), list(b), DEVICE_FLOAT_TOL), (a, b)
    else:
        _assert_same_rows(g, w)


def test_collect_over_repartition_returns_every_row_once(sessions):
    (ref, rdfs), (port, pdfs) = sessions
    cols = ["l_orderkey", "l_returnflag", "l_shipdate"]
    got = pdfs["lineitem"].select(*cols).repartition(7, "l_returnflag") \
        .collect()
    want = rdfs["lineitem"].select(*cols).repartition(7, "l_returnflag") \
        .collect()
    assert _sorted(_port_rows(got)) == _sorted(_ref_rows(want))
    assert got.num_rows == ROWS
