"""TPC-H-shaped tables and queries — port of
``spark_rapids_tpu/workloads/tpch.py``: ``gen_tables``, the 22 TPC-H
queries (the bench suite's ``q1``, ``q3``, ``q4``, ``q5``, ``q6``,
``q12``, ``q14`` and ``q19`` among them) and ``xbb_score``, each copied
node for node from the reference, and :data:`QUERIES` under the
reference's names.

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
from ..ops.arithmetic import Add, Divide, Multiply, Subtract, UnaryMinus
from ..ops.conditional import If
from ..ops.datetime import Year
from ..ops.expression import col, lit
from ..ops.math import Exp
from ..ops.strings import Contains, EndsWith, StartsWith, Substring
from ..plan.logical import SortOrder

# days since the epoch of the queries' date literals
D_1994_01_01 = 8766
D_1995_01_01 = 9131
D_1995_03_15 = 9204
D_1995_09_01 = 9374
D_1995_10_01 = 9404
D_1996_01_01 = 9496
D_1996_04_01 = 9587
D_1996_12_31 = 9861
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


def q5(t):
    """Local supplier volume (Q5): a 5-way join, revenue per nation."""
    orders = t["orders"].where(P.And(
        P.GreaterThanOrEqual(col("o_orderdate"), lit(D_1994_01_01, T.DATE)),
        P.LessThan(col("o_orderdate"), lit(D_1995_01_01, T.DATE))))
    return (t["customer"]
            .join(orders, on=P.EqualTo(col("c_custkey"), col("o_custkey")),
                  how="inner")
            .join(t["lineitem"],
                  on=P.EqualTo(col("o_orderkey"), col("l_orderkey")),
                  how="inner")
            .join(t["supplier"],
                  on=P.EqualTo(col("l_suppkey"), col("s_suppkey")),
                  how="inner")
            .join(t["nation"],
                  on=P.EqualTo(col("s_nationkey"), col("n_nationkey")),
                  how="inner")
            .with_column("revenue", _rev())
            .group_by(col("n_name"))
            .agg(A.AggregateExpression(A.Sum(col("revenue")), "revenue")))


def q12(t):
    """Shipping modes and order priority (Q12): a join and two
    conditional sums per ship mode."""
    li = t["lineitem"].where(P.And(P.And(
        P.Or(P.EqualTo(col("l_shipmode"), lit("MAIL")),
             P.EqualTo(col("l_shipmode"), lit("SHIP"))),
        P.And(P.LessThan(col("l_commitdate"), col("l_receiptdate")),
              P.LessThan(col("l_shipdate"), col("l_commitdate")))),
        P.And(P.GreaterThanOrEqual(col("l_receiptdate"),
                                   lit(D_1994_01_01, T.DATE)),
              P.LessThan(col("l_receiptdate"), lit(D_1995_01_01, T.DATE)))))
    high = If(P.Or(P.EqualTo(col("o_orderpriority"), lit("1-URGENT")),
                   P.EqualTo(col("o_orderpriority"), lit("2-HIGH"))),
              lit(1), lit(0))
    low = If(P.And(P.NotEqual(col("o_orderpriority"), lit("1-URGENT")),
                   P.NotEqual(col("o_orderpriority"), lit("2-HIGH"))),
             lit(1), lit(0))
    return (t["orders"]
            .join(li, on=P.EqualTo(col("o_orderkey"), col("l_orderkey")),
                  how="inner")
            .with_column("high_line", high)
            .with_column("low_line", low)
            .group_by(col("l_shipmode"))
            .agg(A.AggregateExpression(A.Sum(col("high_line")),
                                       "high_line_count"),
                 A.AggregateExpression(A.Sum(col("low_line")),
                                       "low_line_count")))


def q14(t):
    """Promotion effect (Q14): a join and a conditional global sum beside
    the total."""
    li = t["lineitem"].where(P.And(
        P.GreaterThanOrEqual(col("l_shipdate"), lit(D_1995_09_01, T.DATE)),
        P.LessThan(col("l_shipdate"), lit(D_1995_10_01, T.DATE))))
    promo = If(StartsWith(col("p_type"), "PROMO"), _rev(), lit(0.0))
    return (t["part"]
            .join(li, on=P.EqualTo(col("p_partkey"), col("l_partkey")),
                  how="inner")
            .with_column("promo_rev", promo)
            .with_column("rev", _rev())
            .group_by()
            .agg(A.AggregateExpression(A.Sum(col("promo_rev")), "promo"),
                 A.AggregateExpression(A.Sum(col("rev")), "total")))


def q10(t):
    """Returned item reporting (Q10): a 4-way join, revenue per customer,
    the top 20."""
    orders = t["orders"].where(P.And(
        P.GreaterThanOrEqual(col("o_orderdate"), lit(D_1994_01_01, T.DATE)),
        P.LessThan(col("o_orderdate"), lit(D_1995_01_01, T.DATE))))
    returned = t["lineitem"].where(
        P.EqualTo(col("l_returnflag"), lit("R")))
    return (t["customer"]
            .join(orders, on=P.EqualTo(col("c_custkey"), col("o_custkey")),
                  how="inner")
            .join(returned,
                  on=P.EqualTo(col("o_orderkey"), col("l_orderkey")),
                  how="inner")
            .join(t["nation"],
                  on=P.EqualTo(col("c_nationkey"), col("n_nationkey")),
                  how="inner")
            .with_column("rev", _rev())
            .group_by(col("c_custkey"), col("n_name"))
            .agg(A.AggregateExpression(A.Sum(col("rev")), "revenue"))
            .sort(SortOrder(col("revenue"), ascending=False),
                  SortOrder(col("c_custkey")))
            .limit(20))


def q18(t):
    """Large volume customer (Q18): HAVING as an aggregate then a filter;
    the qualifying orders join back to orders and customer."""
    big = (t["lineitem"]
           .group_by(col("l_orderkey"))
           .agg(A.AggregateExpression(A.Sum(col("l_quantity")), "sum_qty"))
           .where(P.GreaterThan(col("sum_qty"), lit(150.0))))
    return (t["orders"]
            .join(big, on=P.EqualTo(col("o_orderkey"), col("l_orderkey")),
                  how="inner")
            .join(t["customer"],
                  on=P.EqualTo(col("o_custkey"), col("c_custkey")),
                  how="inner")
            .group_by(col("c_custkey"))
            .agg(A.AggregateExpression(A.Count(), "n_orders"),
                 A.AggregateExpression(A.Sum(col("sum_qty")), "total_qty"))
            .sort(SortOrder(col("total_qty"), ascending=False),
                  SortOrder(col("c_custkey")))
            .limit(100))


def q19(t):
    """Discounted revenue (Q19): a join under a disjunction of band
    predicates, one global sum."""
    li = t["lineitem"].where(P.And(
        P.Or(P.EqualTo(col("l_shipmode"), lit("AIR")),
             P.EqualTo(col("l_shipmode"), lit("REG AIR"))),
        P.LessThanOrEqual(col("l_quantity"), lit(30.0))))
    joined = t["part"].join(
        li, on=P.EqualTo(col("p_partkey"), col("l_partkey")), how="inner")
    band = P.Or(
        P.And(StartsWith(col("p_type"), "PROMO"),
              P.LessThanOrEqual(col("l_quantity"), lit(11.0))),
        P.And(StartsWith(col("p_type"), "STANDARD"),
              P.And(P.GreaterThanOrEqual(col("l_quantity"), lit(10.0)),
                    P.LessThanOrEqual(col("l_quantity"), lit(20.0)))))
    return (joined.where(band)
            .with_column("rev", _rev())
            .group_by()
            .agg(A.AggregateExpression(A.Sum(col("rev")), "revenue")))


def xbb_score(t):
    """TPCxBB q05-shaped logistic scoring: the sigmoid of a linear
    combination of line item features, averaged and maximized per return
    flag."""
    z = Add(Add(Multiply(col("l_quantity"), lit(0.37)),
                Multiply(col("l_extendedprice"), lit(-0.00021))),
            Add(Multiply(col("l_discount"), lit(14.2)),
                Multiply(col("l_tax"), lit(-7.1))))
    sigmoid = Divide_safe(z)
    return (t["lineitem"]
            .with_column("score", sigmoid)
            .group_by(col("l_returnflag"))
            .agg(A.AggregateExpression(A.Average(col("score")), "avg_score"),
                 A.AggregateExpression(A.Max(col("score")), "max_score"),
                 A.AggregateExpression(A.Count(), "n")))


def Divide_safe(z):
    """``1 / (1 + exp(-z))``, the reference's sigmoid."""
    return Divide(lit(1.0), Add(lit(1.0), Exp(UnaryMinus(z))))


#: The ported queries under the reference's names.
def q2(t):
    """Minimum cost supplier (Q2): the correlated min(ps_supplycost)
    subquery becomes an aggregate + equi-join (TpchLikeSpark.scala Q2 uses
    the same DataFrame rewrite)."""
    europe_supp = (t["supplier"]
                   .join(t["nation"],
                         on=P.EqualTo(col("s_nationkey"),
                                      col("n_nationkey")), how="inner")
                   .join(t["region"].where(P.EqualTo(col("r_name"),
                                                     lit("EUROPE"))),
                         on=P.EqualTo(col("n_regionkey"),
                                      col("r_regionkey")), how="inner"))
    ps = t["partsupp"].join(
        europe_supp, on=P.EqualTo(col("ps_suppkey"), col("s_suppkey")),
        how="inner")
    min_cost = (ps.group_by(col("ps_partkey"))
                .agg(A.AggregateExpression(A.Min(col("ps_supplycost")),
                                           "min_cost"))
                .select(col("ps_partkey").alias("mc_partkey"),
                        col("min_cost")))
    parts = t["part"].where(P.And(P.In(col("p_size"), [15, 25, 35, 45]),
                                  EndsWith(col("p_type"), "BRUSHED")))
    return (ps
            .join(parts, on=P.EqualTo(col("ps_partkey"), col("p_partkey")),
                  how="inner")
            .join(min_cost,
                  on=P.And(P.EqualTo(col("ps_partkey"), col("mc_partkey")),
                           P.EqualTo(col("ps_supplycost"), col("min_cost"))),
                  how="inner")
            .select(col("s_acctbal"), col("s_name"), col("n_name"),
                    col("p_partkey"), col("p_mfgr"), col("ps_supplycost"))
            .sort(SortOrder(col("s_acctbal"), ascending=False),
                  SortOrder(col("n_name")), SortOrder(col("s_name")),
                  SortOrder(col("p_partkey")))
            .limit(100))


def q7(t):
    """Volume shipping (Q7): nation-pair disjunction over a 6-way join,
    grouped by supplier/customer nation and ship year."""
    n1 = t["nation"].select(col("n_nationkey").alias("n1_key"),
                            col("n_name").alias("supp_nation"))
    n2 = t["nation"].select(col("n_nationkey").alias("n2_key"),
                            col("n_name").alias("cust_nation"))
    li = t["lineitem"].where(P.And(
        P.GreaterThanOrEqual(col("l_shipdate"), lit(D_1995_01_01, T.DATE)),
        P.LessThanOrEqual(col("l_shipdate"), lit(D_1996_12_31, T.DATE))))
    df = (t["supplier"]
          .join(li, on=P.EqualTo(col("s_suppkey"), col("l_suppkey")),
                how="inner")
          .join(t["orders"],
                on=P.EqualTo(col("l_orderkey"), col("o_orderkey")),
                how="inner")
          .join(t["customer"],
                on=P.EqualTo(col("o_custkey"), col("c_custkey")),
                how="inner")
          .join(n1, on=P.EqualTo(col("s_nationkey"), col("n1_key")),
                how="inner")
          .join(n2, on=P.EqualTo(col("c_nationkey"), col("n2_key")),
                how="inner")
          .where(P.Or(
              P.And(P.EqualTo(col("supp_nation"), lit("FRANCE")),
                    P.EqualTo(col("cust_nation"), lit("GERMANY"))),
              P.And(P.EqualTo(col("supp_nation"), lit("GERMANY")),
                    P.EqualTo(col("cust_nation"), lit("FRANCE"))))))
    return (df.with_column("l_year", Year(col("l_shipdate")))
            .with_column("volume", _rev())
            .group_by(col("supp_nation"), col("cust_nation"), col("l_year"))
            .agg(A.AggregateExpression(A.Sum(col("volume")), "revenue"))
            .sort(SortOrder(col("supp_nation")),
                  SortOrder(col("cust_nation")), SortOrder(col("l_year"))))


def q8(t):
    """National market share (Q8): 8-way join, share = conditional sum over
    total per order year."""
    region = t["region"].where(P.EqualTo(col("r_name"), lit("AMERICA")))
    n1 = t["nation"].select(col("n_nationkey").alias("n1_key"),
                            col("n_regionkey").alias("n1_region"))
    n2 = t["nation"].select(col("n_nationkey").alias("n2_key"),
                            col("n_name").alias("supp_nation"))
    parts = t["part"].where(P.EqualTo(col("p_type"),
                                      lit("STANDARD POLISHED")))
    orders = t["orders"].where(P.And(
        P.GreaterThanOrEqual(col("o_orderdate"), lit(D_1995_01_01, T.DATE)),
        P.LessThanOrEqual(col("o_orderdate"), lit(D_1996_12_31, T.DATE))))
    df = (parts
          .join(t["lineitem"],
                on=P.EqualTo(col("p_partkey"), col("l_partkey")),
                how="inner")
          .join(t["supplier"],
                on=P.EqualTo(col("l_suppkey"), col("s_suppkey")),
                how="inner")
          .join(orders, on=P.EqualTo(col("l_orderkey"), col("o_orderkey")),
                how="inner")
          .join(t["customer"],
                on=P.EqualTo(col("o_custkey"), col("c_custkey")),
                how="inner")
          .join(n1, on=P.EqualTo(col("c_nationkey"), col("n1_key")),
                how="inner")
          .join(region, on=P.EqualTo(col("n1_region"), col("r_regionkey")),
                how="inner")
          .join(n2, on=P.EqualTo(col("s_nationkey"), col("n2_key")),
                how="inner"))
    brazil_vol = If(P.EqualTo(col("supp_nation"), lit("BRAZIL")),
                    _rev(), lit(0.0))
    return (df.with_column("o_year", Year(col("o_orderdate")))
            .with_column("volume", _rev())
            .with_column("brazil_volume", brazil_vol)
            .group_by(col("o_year"))
            .agg(A.AggregateExpression(A.Sum(col("brazil_volume")),
                                       "brazil"),
                 A.AggregateExpression(A.Sum(col("volume")), "total"))
            .with_column("mkt_share", Divide(col("brazil"), col("total")))
            .select(col("o_year"), col("mkt_share"))
            .sort(SortOrder(col("o_year"))))


def q9(t):
    """Product type profit (Q9): LIKE filter, 6-way join incl. the
    two-column partsupp key, profit grouped by nation and year."""
    parts = t["part"].where(Contains(col("p_name"), "green"))
    df = (parts
          .join(t["lineitem"],
                on=P.EqualTo(col("p_partkey"), col("l_partkey")),
                how="inner")
          .join(t["supplier"],
                on=P.EqualTo(col("l_suppkey"), col("s_suppkey")),
                how="inner")
          .join(t["partsupp"],
                on=P.And(P.EqualTo(col("l_suppkey"), col("ps_suppkey")),
                         P.EqualTo(col("l_partkey"), col("ps_partkey"))),
                how="inner")
          .join(t["orders"],
                on=P.EqualTo(col("l_orderkey"), col("o_orderkey")),
                how="inner")
          .join(t["nation"],
                on=P.EqualTo(col("s_nationkey"), col("n_nationkey")),
                how="inner"))
    amount = Subtract(_rev(),
                      Multiply(col("ps_supplycost"), col("l_quantity")))
    return (df.with_column("o_year", Year(col("o_orderdate")))
            .with_column("amount", amount)
            .group_by(col("n_name"), col("o_year"))
            .agg(A.AggregateExpression(A.Sum(col("amount")), "sum_profit"))
            .sort(SortOrder(col("n_name")),
                  SortOrder(col("o_year"), ascending=False)))


def q11(t):
    """Important stock identification (Q11): scalar subquery (global sum *
    fraction) as a cross join against the per-part aggregate."""
    german_ps = (t["partsupp"]
                 .join(t["supplier"],
                       on=P.EqualTo(col("ps_suppkey"), col("s_suppkey")),
                       how="inner")
                 .join(t["nation"].where(P.EqualTo(col("n_name"),
                                                   lit("GERMANY"))),
                       on=P.EqualTo(col("s_nationkey"), col("n_nationkey")),
                       how="inner")
                 .with_column("value", Multiply(col("ps_supplycost"),
                                                col("ps_availqty"))))
    total = (german_ps.group_by()
             .agg(A.AggregateExpression(A.Sum(col("value")), "total"))
             .select(Multiply(col("total"),
                              lit(0.0001)).alias("threshold")))
    by_part = (german_ps.group_by(col("ps_partkey"))
               .agg(A.AggregateExpression(A.Sum(col("value")), "value")))
    return (by_part.cross_join(total)
            .where(P.GreaterThan(col("value"), col("threshold")))
            .select(col("ps_partkey"), col("value"))
            .sort(SortOrder(col("value"), ascending=False),
                  SortOrder(col("ps_partkey"))))


def q13(t):
    """Customer distribution (Q13): left outer join + NOT LIKE, two-level
    aggregation (count per customer, then histogram of counts)."""
    orders = (t["orders"]
              .where(P.Not(P.And(Contains(col("o_comment"), "special"),
                                 Contains(col("o_comment"), "requests"))))
              .select(col("o_custkey"), col("o_orderkey")))
    per_cust = (t["customer"].select(col("c_custkey"))
                .join(orders,
                      on=P.EqualTo(col("c_custkey"), col("o_custkey")),
                      how="left")
                .group_by(col("c_custkey"))
                .agg(A.AggregateExpression(A.Count(col("o_orderkey")),
                                           "c_count")))
    return (per_cust.group_by(col("c_count"))
            .agg(A.AggregateExpression(A.Count(), "custdist"))
            .sort(SortOrder(col("custdist"), ascending=False),
                  SortOrder(col("c_count"), ascending=False)))


def q15(t):
    """Top supplier (Q15): the max-revenue view becomes an aggregate +
    cross-join equality filter."""
    li = t["lineitem"].where(P.And(
        P.GreaterThanOrEqual(col("l_shipdate"), lit(D_1996_01_01, T.DATE)),
        P.LessThan(col("l_shipdate"), lit(D_1996_04_01, T.DATE))))
    revenue = (li.with_column("rev", _rev())
               .group_by(col("l_suppkey"))
               .agg(A.AggregateExpression(A.Sum(col("rev")),
                                          "total_revenue")))
    top = revenue.group_by().agg(
        A.AggregateExpression(A.Max(col("total_revenue")), "max_revenue"))
    return (revenue.cross_join(top)
            .where(P.EqualTo(col("total_revenue"), col("max_revenue")))
            .join(t["supplier"],
                  on=P.EqualTo(col("l_suppkey"), col("s_suppkey")),
                  how="inner")
            .select(col("s_suppkey"), col("s_name"), col("total_revenue"))
            .sort(SortOrder(col("s_suppkey"))))


def q16(t):
    """Parts/supplier relationship (Q16): NOT IN subquery as an anti join,
    count(distinct) as distinct + count."""
    complained = (t["supplier"]
                  .where(Contains(col("s_comment"), "Complaints"))
                  .select(col("s_suppkey")))
    parts = t["part"].where(P.And(
        P.And(P.NotEqual(col("p_brand"), lit("Brand#45")),
              P.Not(StartsWith(col("p_type"), "MEDIUM"))),
        P.In(col("p_size"), [3, 9, 14, 19, 23, 36, 45, 49])))
    ps = (parts
          .join(t["partsupp"],
                on=P.EqualTo(col("p_partkey"), col("ps_partkey")),
                how="inner")
          .join(complained,
                on=P.EqualTo(col("ps_suppkey"), col("s_suppkey")),
                how="left_anti"))
    return (ps.select(col("p_brand"), col("p_type"), col("p_size"),
                      col("ps_suppkey"))
            .distinct()
            .group_by(col("p_brand"), col("p_type"), col("p_size"))
            .agg(A.AggregateExpression(A.Count(), "supplier_cnt"))
            .sort(SortOrder(col("supplier_cnt"), ascending=False),
                  SortOrder(col("p_brand")), SortOrder(col("p_type")),
                  SortOrder(col("p_size"))))


def q17(t):
    """Small-quantity-order revenue (Q17): correlated avg(l_quantity)
    subquery as a per-part aggregate joined back."""
    parts = t["part"].where(P.And(
        P.EqualTo(col("p_brand"), lit("Brand#23")),
        P.EqualTo(col("p_container"), lit("MED BOX"))))
    avg_qty = (t["lineitem"].group_by(col("l_partkey"))
               .agg(A.AggregateExpression(A.Average(col("l_quantity")),
                                          "avg_qty"))
               .select(col("l_partkey").alias("a_partkey"),
                       Multiply(lit(0.2), col("avg_qty")).alias(
                           "qty_limit")))
    return (parts
            .join(t["lineitem"],
                  on=P.EqualTo(col("p_partkey"), col("l_partkey")),
                  how="inner")
            .join(avg_qty,
                  on=P.EqualTo(col("p_partkey"), col("a_partkey")),
                  how="inner")
            .where(P.LessThan(col("l_quantity"), col("qty_limit")))
            .group_by()
            .agg(A.AggregateExpression(A.Sum(col("l_extendedprice")),
                                       "sum_price"))
            .select(Divide(col("sum_price"), lit(7.0)).alias("avg_yearly")))


def q20(t):
    """Potential part promotion (Q20): nested IN subqueries as a semi join
    (forest parts) + an aggregate join (half the shipped quantity)."""
    forest_parts = (t["part"].where(StartsWith(col("p_name"), "forest"))
                    .select(col("p_partkey")))
    shipped = (t["lineitem"]
               .where(P.And(P.GreaterThanOrEqual(col("l_shipdate"),
                                                 lit(D_1994_01_01, T.DATE)),
                            P.LessThan(col("l_shipdate"),
                                       lit(D_1996_01_01, T.DATE))))
               .group_by(col("l_partkey"), col("l_suppkey"))
               .agg(A.AggregateExpression(A.Sum(col("l_quantity")),
                                          "sum_qty"))
               .select(col("l_partkey"), col("l_suppkey"),
                       Multiply(lit(0.5), col("sum_qty")).alias(
                           "half_qty")))
    qualifying = (t["partsupp"]
                  .join(forest_parts,
                        on=P.EqualTo(col("ps_partkey"), col("p_partkey")),
                        how="left_semi")
                  .join(shipped,
                        on=P.And(P.EqualTo(col("ps_partkey"),
                                           col("l_partkey")),
                                 P.EqualTo(col("ps_suppkey"),
                                           col("l_suppkey"))),
                        how="inner")
                  .where(P.GreaterThan(col("ps_availqty"),
                                       col("half_qty")))
                  .select(col("ps_suppkey")))
    return (t["supplier"]
            .join(t["nation"].where(P.In(col("n_name"),
                                         ["CANADA", "CHINA", "FRANCE",
                                          "GERMANY", "RUSSIA"])),
                  on=P.EqualTo(col("s_nationkey"), col("n_nationkey")),
                  how="inner")
            .join(qualifying,
                  on=P.EqualTo(col("s_suppkey"), col("ps_suppkey")),
                  how="left_semi")
            .select(col("s_name"))
            .sort(SortOrder(col("s_name"))))


def q21(t):
    """Suppliers who kept orders waiting (Q21): the correlated EXISTS /
    NOT EXISTS pair becomes per-order distinct-supplier counts (exists
    another supplier <=> n_supp > 1; not exists another LATE supplier <=>
    n_late == 1)."""
    li = t["lineitem"]
    supp_per_order = (li.select(col("l_orderkey"), col("l_suppkey"))
                      .distinct()
                      .group_by(col("l_orderkey"))
                      .agg(A.AggregateExpression(A.Count(), "n_supp"))
                      .select(col("l_orderkey").alias("so_orderkey"),
                              col("n_supp")))
    late = li.where(P.GreaterThan(col("l_receiptdate"),
                                  col("l_commitdate")))
    late_per_order = (late.select(col("l_orderkey"), col("l_suppkey"))
                      .distinct()
                      .group_by(col("l_orderkey"))
                      .agg(A.AggregateExpression(A.Count(), "n_late"))
                      .select(col("l_orderkey").alias("lo_orderkey"),
                              col("n_late")))
    f_orders = (t["orders"]
                .where(P.EqualTo(col("o_orderstatus"), lit("F")))
                .select(col("o_orderkey")))
    return (t["supplier"]
            .join(t["nation"].where(P.EqualTo(col("n_name"),
                                              lit("SAUDI ARABIA"))),
                  on=P.EqualTo(col("s_nationkey"), col("n_nationkey")),
                  how="inner")
            .join(late, on=P.EqualTo(col("s_suppkey"), col("l_suppkey")),
                  how="inner")
            .join(f_orders,
                  on=P.EqualTo(col("l_orderkey"), col("o_orderkey")),
                  how="left_semi")
            .join(supp_per_order,
                  on=P.EqualTo(col("l_orderkey"), col("so_orderkey")),
                  how="inner")
            .join(late_per_order,
                  on=P.EqualTo(col("l_orderkey"), col("lo_orderkey")),
                  how="inner")
            .where(P.And(P.GreaterThan(col("n_supp"), lit(1)),
                         P.EqualTo(col("n_late"), lit(1))))
            .group_by(col("s_name"))
            .agg(A.AggregateExpression(A.Count(), "numwait"))
            .sort(SortOrder(col("numwait"), ascending=False),
                  SortOrder(col("s_name")))
            .limit(100))


QUERIES = {"q1": q1, "q2": q2, "q3": q3, "q4": q4, "q5": q5, "q6": q6,
           "q7": q7, "q8": q8, "q9": q9, "q10": q10, "q11": q11,
           "q12": q12, "q13": q13, "q14": q14, "q15": q15, "q16": q16,
           "q17": q17, "q18": q18, "q19": q19, "q20": q20, "q21": q21,
           "q22": q22, "xbb_score": xbb_score}
