"""TPC-H-shaped tables and queries — port of
``spark_rapids_tpu/workloads/tpch.py`` (``gen_tables``, ``q1``, ``q3``,
``q4``, ``q6`` and ``q22``).

:func:`gen_tables` is a numpy-only copy of the reference generator: the
same seed draws the same values in the same order, so both packages see
identical tables (``tests/test_torch_tpch_q3.py`` asserts it). Tables
come back as :class:`HostBatch` es; dates are int32 days since the epoch
(typed DATE by the schema), decimals are float64, strings are numpy
unicode arrays.
"""

from __future__ import annotations

import numpy as np

from .. import types as T
from ..data.batch import HostBatch
from ..ops import aggregates as A
from ..ops import predicates as P
from ..ops.arithmetic import Add, Multiply, Subtract
from ..ops.expression import col, lit
from ..ops.strings import Substring
from ..plan.logical import SortOrder

# days since the epoch of the queries' date literals
D_1994_01_01 = 8766
D_1995_01_01 = 9131
D_1995_03_15 = 9204
D_1998_09_02 = 10471

#: Q22's country codes.
Q22_CODES = ["13", "31", "23", "29", "30", "18", "17"]

_FLAGS = np.array(["A", "N", "R"])
_STATUS = np.array(["F", "O"])
_SEGMENTS = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD",
                      "MACHINERY"])
_MODES = np.array(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"])
_PRIORITIES = np.array(["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                        "5-LOW"])
_TYPES = np.array(["PROMO BRUSHED", "PROMO BURNISHED", "STANDARD POLISHED",
                   "SMALL PLATED", "MEDIUM ANODIZED", "ECONOMY BRUSHED"])
_REGIONS = np.array(["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"])
_BRANDS = np.array([f"Brand#{i}{j}" for i in range(1, 6)
                    for j in range(1, 6)])
_CONTAINERS = np.array(["SM CASE", "SM BOX", "MED BAG", "MED BOX", "LG CASE",
                        "LG BOX", "JUMBO PKG", "WRAP JAR"])
_NAME_WORDS = np.array(["almond", "antique", "azure", "beige", "bisque",
                        "blanched", "blush", "burnished", "chartreuse",
                        "chiffon", "chocolate", "cornflower", "cornsilk",
                        "firebrick", "floral", "forest", "frosted",
                        "goldenrod", "green", "honeydew", "indian", "ivory",
                        "khaki", "lavender"])
_S_COMMENTS = np.array(["quickly final deposits haggle",
                        "carefully regular packages wake",
                        "Customer Complaints were recorded",
                        "ironic accounts sleep furiously",
                        "blithely even requests nag"])
_O_COMMENTS = np.array(["furiously final deposits detect",
                        "special requests are pending",
                        "quickly ironic packages haggle",
                        "unusual special handling requests",
                        "slyly bold accounts use carefully"])
_STATUSES = np.array(["F", "O", "P"])
_NATIONS = np.array(["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT",
                     "ETHIOPIA", "FRANCE", "GERMANY", "INDIA", "INDONESIA",
                     "IRAN", "IRAQ", "JAPAN", "JORDAN", "KENYA", "MOROCCO",
                     "MOZAMBIQUE", "PERU", "CHINA", "ROMANIA", "SAUDI ARABIA",
                     "VIETNAM", "RUSSIA", "UNITED KINGDOM", "UNITED STATES"])

_TYPE_OF = {np.dtype(np.int64): T.LONG, np.dtype(np.float64): T.DOUBLE,
            np.dtype(np.int32): T.DATE}


def _table(columns: dict) -> HostBatch:
    """Every int32 column of the generator is a date."""
    schema = T.Schema([
        T.StructField(n, T.STRING if a.dtype.kind == "U"
                      else _TYPE_OF[a.dtype]) for n, a in columns.items()])
    return HostBatch.from_numpy(columns, schema)


def gen_tables(lineitem_rows: int = 1 << 20, seed: int = 42) -> dict:
    """TPC-H-shaped tables scaled off the lineitem row count (the other
    tables keep roughly TPC-H's relative sizes): ``{name: HostBatch}``."""
    rng = np.random.default_rng(seed)
    # Columns added to the reference after its first tables draw from a
    # second stream, so the first stream's values stay put.
    rng2 = np.random.default_rng(seed + 7919)
    n_li = lineitem_rows
    n_ord = max(n_li // 4, 64)
    n_cust = max(n_li // 40, 32)
    n_supp = max(n_li // 600, 50)
    n_part = max(n_li // 30, 32)
    n_ps = n_part * 4

    def date(lo, hi, n):
        return rng.integers(lo, hi, n).astype(np.int32)

    orderkeys = rng.integers(0, n_ord, n_li).astype(np.int64)
    shipdate = date(8400, 10700, n_li)
    lineitem = _table({
        "l_orderkey": orderkeys,
        "l_partkey": rng.integers(0, n_part, n_li).astype(np.int64),
        "l_suppkey": rng.integers(0, n_supp, n_li).astype(np.int64),
        "l_quantity": rng.integers(1, 51, n_li).astype(np.float64),
        "l_extendedprice": np.round(rng.uniform(900, 105000, n_li), 2),
        "l_discount": np.round(rng.uniform(0.0, 0.1, n_li), 2),
        "l_tax": np.round(rng.uniform(0.0, 0.08, n_li), 2),
        "l_returnflag": _FLAGS[rng.integers(0, 3, n_li)],
        "l_linestatus": _STATUS[rng.integers(0, 2, n_li)],
        "l_shipdate": shipdate,
        "l_commitdate": (shipdate + rng.integers(-30, 30, n_li)
                         ).astype(np.int32),
        "l_receiptdate": (shipdate + rng.integers(1, 31, n_li)
                          ).astype(np.int32),
        "l_shipmode": _MODES[rng.integers(0, len(_MODES), n_li)],
    })
    # A third of customers have no orders (custkey = 2 mod 3).
    ock = rng.integers(0, max(n_cust * 2 // 3, 1), n_ord)
    orders = _table({
        "o_orderkey": np.arange(n_ord, dtype=np.int64),
        "o_custkey": (ock + ock // 2).astype(np.int64),
        "o_orderdate": date(8300, 10600, n_ord),
        "o_orderpriority": _PRIORITIES[rng.integers(0, 5, n_ord)],
        "o_totalprice": np.round(rng.uniform(1000, 500000, n_ord), 2),
        "o_orderstatus": _STATUSES[rng2.integers(0, 3, n_ord)],
        "o_comment": _O_COMMENTS[rng2.integers(0, len(_O_COMMENTS), n_ord)],
    })
    cust_nation = rng.integers(0, 25, n_cust).astype(np.int64)
    customer = _table({
        "c_custkey": np.arange(n_cust, dtype=np.int64),
        "c_mktsegment": _SEGMENTS[rng.integers(0, 5, n_cust)],
        "c_nationkey": cust_nation,
        "c_acctbal": np.round(rng2.uniform(-999.99, 9999.99, n_cust), 2),
        "c_phone": np.char.add(
            np.char.add((cust_nation + 10).astype(np.str_), "-"),
            rng2.integers(100, 999, n_cust).astype(np.str_)),
    })
    supplier = _table({
        "s_suppkey": np.arange(n_supp, dtype=np.int64),
        "s_nationkey": rng.integers(0, 25, n_supp).astype(np.int64),
        "s_name": np.char.add("Supplier#", np.arange(n_supp).astype(np.str_)),
        "s_acctbal": np.round(rng2.uniform(-999.99, 9999.99, n_supp), 2),
        "s_comment": _S_COMMENTS[rng2.integers(0, len(_S_COMMENTS), n_supp)],
    })
    part = _table({
        "p_partkey": np.arange(n_part, dtype=np.int64),
        "p_type": _TYPES[rng.integers(0, len(_TYPES), n_part)],
        "p_brand": _BRANDS[rng2.integers(0, len(_BRANDS), n_part)],
        "p_size": rng2.integers(1, 51, n_part).astype(np.int64),
        "p_container": _CONTAINERS[rng2.integers(0, len(_CONTAINERS),
                                                 n_part)],
        "p_name": np.char.add(
            np.char.add(_NAME_WORDS[rng2.integers(0, len(_NAME_WORDS),
                                                  n_part)], " "),
            _NAME_WORDS[rng2.integers(0, len(_NAME_WORDS), n_part)]),
        "p_mfgr": np.char.add("Manufacturer#",
                              rng2.integers(1, 6, n_part).astype(np.str_)),
    })
    partsupp = _table({
        "ps_partkey": np.repeat(np.arange(n_part, dtype=np.int64), 4),
        "ps_suppkey": rng2.integers(0, n_supp, n_ps).astype(np.int64),
        "ps_availqty": rng2.integers(1, 10000, n_ps).astype(np.int64),
        "ps_supplycost": np.round(rng2.uniform(1.0, 1000.0, n_ps), 2),
    })
    nation = _table({
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_name": _NATIONS,
        "n_regionkey": (np.arange(25) % 5).astype(np.int64),
    })
    region = _table({
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": _REGIONS,
    })
    return {"lineitem": lineitem, "orders": orders, "customer": customer,
            "supplier": supplier, "part": part, "partsupp": partsupp,
            "nation": nation, "region": region}


def load(session, tables: dict) -> dict:
    """Upload every table: ``{name: DataFrame}``."""
    return {name: session.create_dataframe(hb) for name, hb in tables.items()}


def _rev():
    return Multiply(col("l_extendedprice"),
                    Subtract(lit(1.0), col("l_discount")))


def q1(t):
    """Pricing summary report (Q1): filter, two dictionary keys, sums,
    averages and a count."""
    return (t["lineitem"]
            .where(P.LessThanOrEqual(col("l_shipdate"),
                                     lit(D_1998_09_02, T.DATE)))
            .with_column("disc_price", _rev())
            .with_column("charge",
                         Multiply(_rev(), Add(lit(1.0), col("l_tax"))))
            .group_by(col("l_returnflag"), col("l_linestatus"))
            .agg(A.AggregateExpression(A.Sum(col("l_quantity")), "sum_qty"),
                 A.AggregateExpression(A.Sum(col("l_extendedprice")),
                                       "sum_base_price"),
                 A.AggregateExpression(A.Sum(col("disc_price")),
                                       "sum_disc_price"),
                 A.AggregateExpression(A.Sum(col("charge")), "sum_charge"),
                 A.AggregateExpression(A.Average(col("l_quantity")),
                                       "avg_qty"),
                 A.AggregateExpression(A.Average(col("l_discount")),
                                       "avg_disc"),
                 A.AggregateExpression(A.Count(), "count_order")))


def q3(t):
    """Shipping priority (Q3): 3-way join, grouped revenue, top-10."""
    cust = t["customer"].where(
        P.EqualTo(col("c_mktsegment"), lit("BUILDING")))
    orders = t["orders"].where(
        P.LessThan(col("o_orderdate"), lit(D_1995_03_15, T.DATE)))
    li = t["lineitem"].where(
        P.GreaterThan(col("l_shipdate"), lit(D_1995_03_15, T.DATE)))
    return (cust
            .join(orders, on=P.EqualTo(col("c_custkey"), col("o_custkey")),
                  how="inner")
            .join(li, on=P.EqualTo(col("o_orderkey"), col("l_orderkey")),
                  how="inner")
            .with_column("revenue", _rev())
            .group_by(col("o_orderkey"), col("o_orderdate"))
            .agg(A.AggregateExpression(A.Sum(col("revenue")), "revenue"))
            .sort(SortOrder(col("revenue"), ascending=False))
            .limit(10))


def q4(t):
    """Order priority checking (Q4): EXISTS as a left-semi join, then a
    count per priority in priority order."""
    late = t["lineitem"].where(
        P.LessThan(col("l_commitdate"), col("l_receiptdate")))
    orders = t["orders"].where(P.And(
        P.GreaterThanOrEqual(col("o_orderdate"), lit(D_1994_01_01, T.DATE)),
        P.LessThan(col("o_orderdate"), lit(D_1995_01_01, T.DATE))))
    return (orders
            .join(late, on=P.EqualTo(col("o_orderkey"), col("l_orderkey")),
                  how="left_semi")
            .group_by(col("o_orderpriority"))
            .agg(A.AggregateExpression(A.Count(), "order_count"))
            .sort(SortOrder(col("o_orderpriority"))))


def q6(t):
    """Forecasting revenue change (Q6): a selective filter and one global
    sum."""
    li = t["lineitem"].where(P.And(P.And(P.And(
        P.GreaterThanOrEqual(col("l_shipdate"), lit(D_1994_01_01, T.DATE)),
        P.LessThan(col("l_shipdate"), lit(D_1995_01_01, T.DATE))),
        P.And(P.GreaterThanOrEqual(col("l_discount"), lit(0.05)),
              P.LessThanOrEqual(col("l_discount"), lit(0.07)))),
        P.LessThan(col("l_quantity"), lit(24.0))))
    return (li.with_column("rev",
                           Multiply(col("l_extendedprice"),
                                    col("l_discount")))
            .group_by()
            .agg(A.AggregateExpression(A.Sum(col("rev")), "revenue")))


def q22(t):
    """Global sales opportunity (Q22): a substring country code, the
    scalar avg(acctbal) subquery as a cross join, NOT EXISTS as an anti
    join."""
    cust = (t["customer"]
            .with_column("cntrycode",
                         Substring(col("c_phone"), lit(1), lit(2)))
            .where(P.In(col("cntrycode"), Q22_CODES)))
    avg_bal = (cust.where(P.GreaterThan(col("c_acctbal"), lit(0.0)))
               .group_by()
               .agg(A.AggregateExpression(A.Average(col("c_acctbal")),
                                          "avg_bal")))
    return (cust.cross_join(avg_bal)
            .where(P.GreaterThan(col("c_acctbal"), col("avg_bal")))
            .join(t["orders"].select(col("o_custkey")),
                  on=P.EqualTo(col("c_custkey"), col("o_custkey")),
                  how="left_anti")
            .group_by(col("cntrycode"))
            .agg(A.AggregateExpression(A.Count(), "numcust"),
                 A.AggregateExpression(A.Sum(col("c_acctbal")),
                                       "totacctbal"))
            .sort(SortOrder(col("cntrycode"))))
