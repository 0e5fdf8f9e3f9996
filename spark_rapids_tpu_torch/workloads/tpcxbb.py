"""TPCxBB-shaped tables and queries — port of
``spark_rapids_tpu/workloads/tpcxbb.py``: the generator and the
reference's 30 queries, among them the bench suite's three entries,
``q01`` (basket analysis: a self-join on the store ticket, a two-key
count, a HAVING filter and a top 100), ``q05`` (the per-user click
features and a left-joined buyer label) and ``q30`` (item-category
affinity inside clickstream sessions, which the shared
:func:`_sessionized` core builds with windows and a two-key
self-join). Each query is copied node for node from the reference;
:data:`QUERIES` holds them under the reference's names.

:func:`gen_tables` is a numpy-only copy of the reference generator: the
same seed draws the same values in the same order, so both packages see
identical tables, nulls included. Tables come back as
:class:`HostBatch` es: numpy values plus validity masks where the
reference builds ``pa.array(..., mask=...)`` (``wcs_user_sk`` is about
10 % null, ``wcs_sales_sk`` about 95 %); strings are numpy unicode
arrays.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .. import types as T
from ..data.batch import HostBatch
from ..ops import aggregates as A
from ..ops import predicates as P
from ..ops.arithmetic import (Add, Divide, IntegralDivide, Multiply, Pmod,
                              Subtract)
from ..ops.cast import Cast
from ..ops.conditional import Coalesce, If
from ..ops.expression import col, lit
from ..ops.math import Sqrt
from ..ops.strings import Like
from ..ops.windows import RowNumber, Window, over
from ..plan.logical import SortOrder

_CATEGORIES = np.array(["Books", "Electronics", "Home", "Jewelry", "Men",
                        "Music", "Shoes", "Sports", "Children", "Women"])

#: Seconds of inactivity that end a click session (the official
#: sessionize timeout).
SESSION_GAP = 3600

_SENT = np.array(["terrible quality would not buy again",
                  "great product works as described",
                  "awful support and terrible packaging",
                  "decent value for the price",
                  "excellent product great service",
                  "broken on arrival terrible experience"])
_COMP = np.array(["", " cheaper at acme retail", " saw it on zenith",
                  "", " better price from acme", ""])


def _table(columns: Dict[str, np.ndarray],
           validity: Optional[Dict[str, np.ndarray]] = None) -> HostBatch:
    """int64 columns are LONG, float64 DOUBLE, unicode STRING."""
    schema = T.Schema([T.StructField(n, T.from_numpy_dtype(a.dtype))
                       for n, a in columns.items()])
    return HostBatch.from_numpy(columns, schema, validity)


def gen_tables(n_clicks: int = 1 << 18, seed: int = 42) -> dict:
    """The TPCxBB-shaped tables scaled off the click count:
    ``{name: HostBatch}``, the reference's tables value for value."""
    rng = np.random.default_rng(seed)
    n_item = max(n_clicks // 100, 64)
    n_user = max(n_clicks // 50, 64)
    n_ss = max(n_clicks // 2, 128)
    n_ws = max(n_clicks // 4, 128)
    n_pr = max(n_clicks // 20, 64)
    n_dates = 365 * 2

    def ints(lo, hi, n, r=None):
        return (r or rng).integers(lo, hi, n).astype(np.int64)

    cat_idx = rng.integers(0, len(_CATEGORIES), n_item)
    item = {
        "i_item_sk": np.arange(n_item, dtype=np.int64),
        "i_category_id": cat_idx.astype(np.int64),
        "i_category": _CATEGORIES[cat_idx],
        "i_current_price": np.round(rng.uniform(0.5, 200.0, n_item), 2),
    }
    customer = {
        "c_customer_sk": np.arange(n_user, dtype=np.int64),
        "c_age": ints(18, 80, n_user),
        "c_income": np.round(rng.uniform(2e4, 2e5, n_user), 2),
    }

    # Clickstream: ~5 % of clicks convert to a sale (non-null sales sk);
    # ~10 % are anonymous (null user).
    wcs_user = ints(0, n_user, n_clicks)
    wcs_user_null = rng.random(n_clicks) < 0.10
    wcs_sales = ints(0, n_ws, n_clicks)
    wcs_sales_null = rng.random(n_clicks) >= 0.05
    web_clickstreams = {
        "wcs_click_date_sk": ints(0, n_dates, n_clicks),
        "wcs_click_time_sk": ints(0, 86400, n_clicks),
        "wcs_user_sk": wcs_user,
        "wcs_item_sk": ints(0, n_item, n_clicks),
        "wcs_sales_sk": wcs_sales,
    }
    wcs_valid = {"wcs_user_sk": ~wcs_user_null,
                 "wcs_sales_sk": ~wcs_sales_null}

    qty = ints(1, 20, n_ss)
    price = np.round(rng.uniform(1.0, 100.0, n_ss), 2)
    store_sales = {
        "ss_sold_date_sk": ints(0, n_dates, n_ss),
        "ss_customer_sk": ints(0, n_user, n_ss),
        "ss_item_sk": ints(0, n_item, n_ss),
        "ss_ticket_number": ints(0, max(n_ss // 5, 8), n_ss),
        "ss_quantity": qty,
        "ss_net_paid": np.round(price * qty, 2),
    }

    wqty = ints(1, 20, n_ws)
    wprice = np.round(rng.uniform(1.0, 100.0, n_ws), 2)
    web_sales = {
        "ws_sold_date_sk": ints(0, n_dates, n_ws),
        "ws_bill_customer_sk": ints(0, n_user, n_ws),
        "ws_item_sk": ints(0, n_item, n_ws),
        "ws_quantity": wqty,
        "ws_net_paid": np.round(wprice * wqty, 2),
    }

    product_reviews = {
        "pr_item_sk": ints(0, n_item, n_pr),
        "pr_user_sk": ints(0, n_user, n_pr),
        "pr_review_rating": ints(1, 6, n_pr),
        "pr_review_date_sk": ints(0, n_dates, n_pr),
    }

    # Columns added after the first tables draw from a second stream, so
    # the first stream's values stay put.
    rng2 = np.random.default_rng(seed + 4241)
    n_store = 12
    n_wh = 6
    n_hd = 60
    n_wp = 20
    n_sr = max(n_ss // 8, 32)
    n_wr = max(n_ws // 8, 32)
    n_inv = max(n_clicks, 256)
    n_imp = max(n_item * 3, 64)

    item["i_class_id"] = ints(1, 16, n_item, rng2)
    store_sales["ss_store_sk"] = ints(0, n_store, n_ss, rng2)
    web_sales["ws_order_number"] = ints(0, max(n_ws // 4, 8), n_ws, rng2)
    web_sales["ws_warehouse_sk"] = ints(0, n_wh, n_ws, rng2)
    web_sales["ws_sold_time_sk"] = ints(0, 1440, n_ws, rng2)
    web_sales["ws_ship_hdemo_sk"] = ints(0, n_hd, n_ws, rng2)
    web_sales["ws_web_page_sk"] = ints(0, n_wp, n_ws, rng2)
    web_sales["ws_sales_price"] = np.round(wprice, 2)

    sent_idx = rng2.integers(0, len(_SENT), n_pr)
    comp_idx = rng2.integers(0, len(_COMP), n_pr)
    product_reviews["pr_review_sk"] = np.arange(n_pr, dtype=np.int64)
    product_reviews["pr_review_content"] = np.char.add(_SENT[sent_idx],
                                                       _COMP[comp_idx])

    ridx = rng2.integers(0, n_ss, n_sr)
    store_returns = {
        "sr_ticket_number": store_sales["ss_ticket_number"][ridx],
        "sr_item_sk": store_sales["ss_item_sk"][ridx],
        "sr_customer_sk": store_sales["ss_customer_sk"][ridx],
        "sr_returned_date_sk": np.minimum(
            store_sales["ss_sold_date_sk"][ridx]
            + rng2.integers(1, 90, n_sr), n_dates - 1),
        "sr_return_quantity": ints(1, 10, n_sr, rng2),
        "sr_return_amt": np.round(rng2.uniform(1.0, 150.0, n_sr), 2),
    }

    widx = rng2.integers(0, n_ws, n_wr)
    web_returns = {
        "wr_order_number": web_sales["ws_order_number"][widx],
        "wr_item_sk": web_sales["ws_item_sk"][widx],
        "wr_return_quantity": ints(1, 10, n_wr, rng2),
        "wr_refunded_cash": np.round(rng2.uniform(1.0, 120.0, n_wr), 2),
    }

    warehouse = {
        "w_warehouse_sk": np.arange(n_wh, dtype=np.int64),
        "w_warehouse_name": np.char.add("Warehouse ",
                                        np.arange(n_wh).astype(np.str_)),
        "w_state": np.array(["CA", "TX", "OH", "GA", "WA", "TN"]),
    }

    inventory = {
        "inv_item_sk": ints(0, n_item, n_inv, rng2),
        "inv_warehouse_sk": ints(0, n_wh, n_inv, rng2),
        "inv_date_sk": (rng2.integers(0, n_dates // 7, n_inv)
                        * 7).astype(np.int64),
        "inv_quantity_on_hand": ints(0, 50, n_inv, rng2),
    }

    imp_start = ints(30, n_dates - 60, n_imp, rng2)
    item_marketprices = {
        "imp_sk": np.arange(n_imp, dtype=np.int64),
        "imp_item_sk": ints(0, n_item, n_imp, rng2),
        "imp_competitor_price": np.round(rng2.uniform(0.5, 220.0, n_imp), 2),
        "imp_start_date": imp_start,
        "imp_end_date": imp_start + rng2.integers(10, 60, n_imp),
    }

    web_page = {
        "wp_web_page_sk": np.arange(n_wp, dtype=np.int64),
        "wp_char_count": ints(1000, 9000, n_wp, rng2),
    }
    household_demographics = {
        "hd_demo_sk": np.arange(n_hd, dtype=np.int64),
        "hd_dep_count": (np.arange(n_hd) % 10).astype(np.int64),
    }
    time_dim = {
        "t_time_sk": np.arange(1440, dtype=np.int64),  # minute of the day
        "t_hour": (np.arange(1440) // 60).astype(np.int64),
    }

    tables = {"item": item, "customer": customer,
              "web_clickstreams": web_clickstreams,
              "store_sales": store_sales, "web_sales": web_sales,
              "product_reviews": product_reviews,
              "store_returns": store_returns, "web_returns": web_returns,
              "warehouse": warehouse, "inventory": inventory,
              "item_marketprices": item_marketprices, "web_page": web_page,
              "household_demographics": household_demographics,
              "time_dim": time_dim}
    return {name: _table(cols, wcs_valid if name == "web_clickstreams"
                         else None)
            for name, cols in tables.items()}


def load(session, tables: dict) -> dict:
    """Upload every table: ``{name: DataFrame}``."""
    return {name: session.create_dataframe(hb) for name, hb in tables.items()}


def _sum(e, name):
    return A.AggregateExpression(A.Sum(e), name)


def _avg(e, name):
    return A.AggregateExpression(A.Average(e), name)


def _cnt(name):
    return A.AggregateExpression(A.Count(), name)


def _eq(a, b):
    return P.EqualTo(a, b)


def _sessionized(t):
    """The shared sessionization core (official q2/q8/q30 machinery): the
    clicks of identified users get a per-user session id, the running
    count of gaps over :data:`SESSION_GAP`; a row-number self-join
    supplies each click's predecessor."""
    clicks = (t["web_clickstreams"]
              .where(P.IsNotNull(col("wcs_user_sk")))
              .select(col("wcs_user_sk").alias("user"),
                      Add(Multiply(col("wcs_click_date_sk"), lit(86400)),
                          col("wcs_click_time_sk")).alias("ts"),
                      col("wcs_item_sk").alias("item"),
                      col("wcs_sales_sk").alias("sales_sk")))
    rn_w = Window.partition_by("user").order_by(SortOrder(col("ts")))
    v = clicks.with_column("rn", over(RowNumber(), rn_w))
    prev = v.select(col("user").alias("p_user"), col("ts").alias("p_ts"),
                    col("rn").alias("p_rn"))
    flagged = (v.join(prev,
                      on=P.And(_eq(col("user"), col("p_user")),
                               _eq(col("rn"), Add(col("p_rn"), lit(1)))),
                      how="left")
               .with_column(
                   "boundary",
                   If(P.Or(P.IsNull(col("p_ts")),
                           P.GreaterThan(Subtract(col("ts"), col("p_ts")),
                                         lit(SESSION_GAP))),
                      lit(1), lit(0))))
    sess_w = (Window.partition_by("user").order_by(SortOrder(col("rn")))
              .rows_between(Window.unbounded_preceding,
                            Window.current_row))
    return flagged.with_column("session_id",
                               over(A.Sum(col("boundary")), sess_w))


def q01(t):
    """Q1: basket analysis — item pairs bought on the same store ticket,
    by pair frequency (official q01's self-join shape)."""
    a = t["store_sales"].select(col("ss_ticket_number").alias("t1"),
                                col("ss_item_sk").alias("item_a"))
    b = t["store_sales"].select(col("ss_ticket_number").alias("t2"),
                                col("ss_item_sk").alias("item_b"))
    return (a.join(b, on=_eq(col("t1"), col("t2")), how="inner")
            .where(P.LessThan(col("item_a"), col("item_b")))
            .group_by(col("item_a"), col("item_b"))
            .agg(_cnt("cnt"))
            .where(P.GreaterThanOrEqual(col("cnt"), lit(3)))
            .sort(SortOrder(col("cnt"), ascending=False),
                  SortOrder(col("item_a")), SortOrder(col("item_b")))
            .limit(100))


def q02(t):
    """Q2: items clicked in the same session as a pivot item
    (sessionized clickstream self-join)."""
    s = _sessionized(t).select(col("user"), col("session_id"),
                               col("item"))
    pivot = (s.where(_eq(col("item"), lit(10)))
             .select(col("user").alias("pv_user"),
                     col("session_id").alias("pv_sess")).distinct())
    return (s.join(pivot,
                   on=P.And(_eq(col("user"), col("pv_user")),
                            _eq(col("session_id"), col("pv_sess"))),
                   how="left_semi")
            .where(P.NotEqual(col("item"), lit(10)))
            .group_by(col("item"))
            .agg(_cnt("cnt"))
            .sort(SortOrder(col("cnt"), ascending=False),
                  SortOrder(col("item")))
            .limit(30))


def q03(t):
    """Q3: items viewed within 10 days before a purchase of a target
    category (click -> sale path join)."""
    sales = (t["store_sales"]
             .join(t["item"].where(_eq(col("i_category_id"), lit(3))),
                   on=_eq(col("ss_item_sk"), col("i_item_sk")),
                   how="inner")
             .select(col("ss_customer_sk").alias("buyer"),
                     col("ss_sold_date_sk").alias("sale_date"),
                     col("ss_item_sk").alias("bought")))
    clicks = (t["web_clickstreams"]
              .where(P.IsNotNull(col("wcs_user_sk")))
              .select(col("wcs_user_sk").alias("clicker"),
                      col("wcs_click_date_sk").alias("click_date"),
                      col("wcs_item_sk").alias("viewed")))
    return (sales
            .join(clicks,
                  on=P.And(_eq(col("buyer"), col("clicker")),
                           P.And(
                               P.LessThanOrEqual(col("click_date"),
                                                 col("sale_date")),
                               P.GreaterThan(col("click_date"),
                                             Subtract(col("sale_date"),
                                                      lit(10))))),
                  how="inner")
            .group_by(col("viewed"))
            .agg(_cnt("views_before_purchase"))
            .sort(SortOrder(col("views_before_purchase"),
                            ascending=False),
                  SortOrder(col("viewed")))
            .limit(100))


def q04(t):
    """Q4: shopping-cart abandonment — sessions whose clicks never
    convert, as a share per category."""
    s = _sessionized(t)
    sess = (s.group_by(col("user"), col("session_id"))
            .agg(_cnt("clicks"),
                 _sum(If(P.IsNotNull(col("sales_sk")), lit(1), lit(0)),
                      "conversions")))
    return (sess
            .group_by()
            .agg(_cnt("sessions"),
                 _sum(If(_eq(col("conversions"), lit(0)), lit(1), lit(0)),
                      "abandoned"),
                 _avg(col("clicks"), "avg_clicks")))


def q05(t):
    """Q5: logistic-regression feature build — per-user category click
    counts and a label (bought in the category), the ML-handoff shape."""
    clicks = (t["web_clickstreams"]
              .where(P.IsNotNull(col("wcs_user_sk")))
              .join(t["item"],
                    on=_eq(col("wcs_item_sk"), col("i_item_sk")),
                    how="inner"))
    feats = []
    for cid in range(6):
        feats.append(_sum(If(_eq(col("i_category_id"), lit(cid)),
                             lit(1), lit(0)), f"f{cid}"))
    per_user = (clicks.group_by(col("wcs_user_sk"))
                .agg(*feats, _cnt("total_clicks")))
    buyers = (t["web_sales"]
              .join(t["item"].where(_eq(col("i_category_id"), lit(3))),
                    on=_eq(col("ws_item_sk"), col("i_item_sk")),
                    how="inner")
              .select(col("ws_bill_customer_sk").alias("buyer"))
              .distinct()
              .with_column("label", lit(1)))
    return (per_user
            .join(buyers, on=_eq(col("wcs_user_sk"), col("buyer")),
                  how="left")
            .select(col("wcs_user_sk"),
                    *[col(f"f{c}") for c in range(6)],
                    col("total_clicks"),
                    Coalesce(col("label"), lit(0)).alias("label"))
            .sort(SortOrder(col("wcs_user_sk")))
            .limit(1000))


def q06(t):
    """Q6: customers whose web spend grew faster than store spend between
    two periods (cross-channel year-over-year, official q06 shape)."""
    def period_total(fact, cust, date_col, paid, lo, hi, name):
        return (t[fact]
                .where(P.And(P.GreaterThanOrEqual(col(date_col), lit(lo)),
                             P.LessThan(col(date_col), lit(hi))))
                .group_by(col(cust))
                .agg(_sum(col(paid), name))
                .select(col(cust).alias(name + "_cust"), col(name)))

    ss1 = period_total("store_sales", "ss_customer_sk", "ss_sold_date_sk",
                       "ss_net_paid", 0, 365, "ss_p1")
    ss2 = period_total("store_sales", "ss_customer_sk", "ss_sold_date_sk",
                       "ss_net_paid", 365, 730, "ss_p2")
    ws1 = period_total("web_sales", "ws_bill_customer_sk",
                       "ws_sold_date_sk", "ws_net_paid", 0, 365, "ws_p1")
    ws2 = period_total("web_sales", "ws_bill_customer_sk",
                       "ws_sold_date_sk", "ws_net_paid", 365, 730, "ws_p2")
    return (ss1
            .join(ss2, on=_eq(col("ss_p1_cust"), col("ss_p2_cust")),
                  how="inner")
            .join(ws1, on=_eq(col("ss_p1_cust"), col("ws_p1_cust")),
                  how="inner")
            .join(ws2, on=_eq(col("ss_p1_cust"), col("ws_p2_cust")),
                  how="inner")
            .where(P.And(P.GreaterThan(col("ss_p1"), lit(0.0)),
                         P.GreaterThan(col("ws_p1"), lit(0.0))))
            .where(P.GreaterThan(Divide(col("ws_p2"), col("ws_p1")),
                                 Divide(col("ss_p2"), col("ss_p1"))))
            .select(col("ss_p1_cust").alias("customer"),
                    Divide(col("ws_p2"), col("ws_p1")).alias("web_growth"))
            .sort(SortOrder(col("web_growth"), ascending=False),
                  SortOrder(col("customer")))
            .limit(100))


def q07(t):
    """Q7: categories where >= 10 items are priced above 1.2x the
    category average (correlated avg subquery shape)."""
    cat_avg = (t["item"].group_by(col("i_category_id"))
               .agg(_avg(col("i_current_price"), "cat_avg"))
               .select(col("i_category_id").alias("ca_cat"),
                       col("cat_avg")))
    return (t["item"]
            .join(cat_avg, on=_eq(col("i_category_id"), col("ca_cat")),
                  how="inner")
            .where(P.GreaterThan(col("i_current_price"),
                                 Multiply(lit(1.2), col("cat_avg"))))
            .group_by(col("i_category"))
            .agg(_cnt("pricey_items"))
            .where(P.GreaterThanOrEqual(col("pricey_items"), lit(10)))
            .sort(SortOrder(col("pricey_items"), ascending=False),
                  SortOrder(col("i_category")))
            .limit(100))


def q08(t):
    """Q8: web sales of review-readers vs non-readers (EXISTS against
    product_reviews per buyer)."""
    readers = (t["product_reviews"]
               .select(col("pr_user_sk").alias("reader")).distinct())
    ws = t["web_sales"]
    read_sales = (ws.join(readers,
                          on=_eq(col("ws_bill_customer_sk"),
                                 col("reader")),
                          how="left_semi")
                  .group_by().agg(_sum(col("ws_net_paid"), "reader_paid"),
                                  _cnt("reader_orders")))
    nonread_sales = (ws.join(readers,
                             on=_eq(col("ws_bill_customer_sk"),
                                    col("reader")),
                             how="left_anti")
                     .group_by().agg(_sum(col("ws_net_paid"),
                                          "nonreader_paid"),
                                     _cnt("nonreader_orders")))
    return read_sales.join(nonread_sales, how="cross")


def q09(t):
    """Q9: store revenue under layered demographic/price disjunctions
    (official q09's conditional aggregate shape)."""
    joined = (t["store_sales"]
              .join(t["customer"],
                    on=_eq(col("ss_customer_sk"), col("c_customer_sk")),
                    how="inner"))
    ok = P.Or(
        P.And(P.GreaterThanOrEqual(col("c_age"), lit(40)),
              P.GreaterThan(col("c_income"), lit(1e5))),
        P.Or(P.And(P.LessThan(col("c_age"), lit(30)),
                   P.GreaterThan(col("ss_quantity"), lit(10))),
             P.GreaterThan(col("ss_net_paid"), lit(900.0))))
    return (joined.where(ok)
            .group_by()
            .agg(_sum(col("ss_net_paid"), "revenue"), _cnt("rows")))


def q10(t):
    """Q10: items whose average review rating trails their category's
    (review sentiment stand-in, grouped-vs-parent comparison)."""
    item_avg = (t["product_reviews"]
                .group_by(col("pr_item_sk"))
                .agg(_avg(col("pr_review_rating"), "item_rating"),
                     _cnt("n_reviews")))
    cat = (item_avg
           .join(t["item"], on=_eq(col("pr_item_sk"), col("i_item_sk")),
                 how="inner"))
    cat_avg = (cat.group_by(col("i_category_id"))
               .agg(_avg(col("item_rating"), "cat_rating"))
               .select(col("i_category_id").alias("ca_cat"),
                       col("cat_rating")))
    return (cat
            .join(cat_avg, on=_eq(col("i_category_id"), col("ca_cat")),
                  how="inner")
            .where(P.GreaterThanOrEqual(col("n_reviews"), lit(3)))
            .where(P.LessThan(col("item_rating"),
                              Subtract(col("cat_rating"), lit(0.5))))
            .select(col("pr_item_sk"), col("i_category"),
                    col("item_rating"), col("cat_rating"))
            .sort(SortOrder(col("item_rating")),
                  SortOrder(col("pr_item_sk")))
            .limit(100))


def q11(t):
    """Q11: per-item review count vs web sales (correlation feed — the
    official computes corr(); the shape is the two-aggregate join)."""
    reviews = (t["product_reviews"].group_by(col("pr_item_sk"))
               .agg(_cnt("n_reviews"),
                    _avg(col("pr_review_rating"), "rating")))
    sales = (t["web_sales"].group_by(col("ws_item_sk"))
             .agg(_sum(col("ws_net_paid"), "revenue")))
    return (reviews
            .join(sales, on=_eq(col("pr_item_sk"), col("ws_item_sk")),
                  how="inner")
            .select(col("pr_item_sk"),
                    Cast(col("n_reviews"), T.DOUBLE).alias("x"),
                    col("rating"), col("revenue"))
            .group_by()
            .agg(_cnt("n"), _sum(col("x"), "sum_x"),
                 _sum(col("revenue"), "sum_y"),
                 _sum(Multiply(col("x"), col("revenue")), "sum_xy"),
                 _sum(Multiply(col("x"), col("x")), "sum_xx"),
                 _sum(Multiply(col("revenue"), col("revenue")), "sum_yy")))


def q12(t):
    """Q12: click in a category then store purchase in that category
    within 90 days (cross-channel path, official q12 shape)."""
    clicks = (t["web_clickstreams"]
              .where(P.IsNotNull(col("wcs_user_sk")))
              .join(t["item"].where(P.In(col("i_category_id"), [1, 3, 5])),
                    on=_eq(col("wcs_item_sk"), col("i_item_sk")),
                    how="inner")
              .select(col("wcs_user_sk").alias("u"),
                      col("wcs_click_date_sk").alias("cd"),
                      col("i_category_id").alias("cat")))
    sales = (t["store_sales"]
             .join(t["item"].where(P.In(col("i_category_id"), [1, 3, 5])),
                   on=_eq(col("ss_item_sk"), col("i_item_sk")),
                   how="inner")
             .select(col("ss_customer_sk").alias("b"),
                     col("ss_sold_date_sk").alias("sd"),
                     col("i_category_id").alias("scat")))
    return (clicks
            .join(sales,
                  on=P.And(_eq(col("u"), col("b")),
                           P.And(_eq(col("cat"), col("scat")),
                                 P.And(P.GreaterThan(col("sd"), col("cd")),
                                       P.LessThanOrEqual(
                                           col("sd"),
                                           Add(col("cd"), lit(90)))))),
                  how="left_semi")
            .select(col("u"), col("cat")).distinct()
            .group_by(col("cat"))
            .agg(_cnt("converting_users"))
            .sort(SortOrder(col("cat")))
            .limit(100))


def q13(t):
    """Q13: customers whose web sales increase ratio across two years
    beats their store ratio (TpcxbbLikeSpark.scala Q13Like, tpc-ds
    q74-based two-view join)."""
    def channel(fact, cust, date_col, paid, name):
        y1 = If(P.LessThan(col(date_col), lit(365)), col(paid), lit(0.0))
        y2 = If(P.GreaterThanOrEqual(col(date_col), lit(365)), col(paid),
                lit(0.0))
        return (t[fact]
                .group_by(col(cust))
                .agg(_sum(y1, name + "_y1"), _sum(y2, name + "_y2"))
                .where(P.GreaterThan(col(name + "_y1"), lit(0.0)))
                .select(col(cust).alias(name + "_cust"),
                        col(name + "_y1"), col(name + "_y2")))

    store = channel("store_sales", "ss_customer_sk", "ss_sold_date_sk",
                    "ss_net_paid", "st")
    web = channel("web_sales", "ws_bill_customer_sk", "ws_sold_date_sk",
                  "ws_net_paid", "wb")
    ratio_w = Divide(col("wb_y2"), col("wb_y1"))
    ratio_s = Divide(col("st_y2"), col("st_y1"))
    return (store
            .join(web, on=_eq(col("st_cust"), col("wb_cust")),
                  how="inner")
            .join(t["customer"],
                  on=_eq(col("st_cust"), col("c_customer_sk")),
                  how="inner")
            .where(P.GreaterThan(ratio_w, ratio_s))
            .select(col("c_customer_sk"),
                    ratio_s.alias("store_ratio"),
                    ratio_w.alias("web_ratio"))
            .sort(SortOrder(col("web_ratio"), ascending=False),
                  SortOrder(col("c_customer_sk")))
            .limit(100))


def q14(t):
    """Q14: morning/evening web-sales ratio for high-content pages and a
    dependent-count slice (Q14Like, tpc-ds q90-based)."""
    joined = (t["web_sales"]
              .join(t["household_demographics"].where(
                  _eq(col("hd_dep_count"), lit(5))),
                  on=_eq(col("ws_ship_hdemo_sk"), col("hd_demo_sk")),
                  how="inner")
              .join(t["web_page"].where(_between(col("wp_char_count"),
                                                 5000, 6000)),
                    on=_eq(col("ws_web_page_sk"), col("wp_web_page_sk")),
                    how="inner")
              .join(t["time_dim"].where(P.In(col("t_hour"),
                                             [7, 8, 19, 20])),
                    on=_eq(col("ws_sold_time_sk"), col("t_time_sk")),
                    how="inner"))
    agg = (joined.group_by()
           .agg(_sum(If(P.LessThanOrEqual(col("t_hour"), lit(8)), lit(1),
                        lit(0)), "amc"),
                _sum(If(P.GreaterThanOrEqual(col("t_hour"), lit(19)),
                        lit(1), lit(0)), "pmc")))
    return agg.select(
        If(P.GreaterThan(col("pmc"), lit(0)),
           Divide(Cast(col("amc"), T.DOUBLE),
                  Cast(col("pmc"), T.DOUBLE)),
           lit(-1.0)).alias("am_pm_ratio"))


def q15(t):
    """Q15: categories with flat or declining store sales — per-category
    least-squares slope over (date, daily revenue) points, slope <= 0
    (Q15Like's inlined regression formula)."""
    daily = (t["store_sales"]
             .where(_eq(col("ss_store_sk"), lit(10)))
             .where(_between(col("ss_sold_date_sk"), 180, 545))
             .join(t["item"], on=_eq(col("ss_item_sk"), col("i_item_sk")),
                   how="inner")
             .group_by(col("i_category_id"), col("ss_sold_date_sk"))
             .agg(_sum(col("ss_net_paid"), "y")))
    x = Cast(col("ss_sold_date_sk"), T.DOUBLE)
    pts = daily.select(col("i_category_id").alias("cat"), x.alias("x"),
                       col("y"), Multiply(x, col("y")).alias("xy"),
                       Multiply(x, x).alias("xx"))
    reg = (pts.group_by(col("cat"))
           .agg(_cnt("n"), _sum(col("x"), "sx"), _sum(col("y"), "sy"),
                _sum(col("xy"), "sxy"), _sum(col("xx"), "sxx")))
    n = Cast(col("n"), T.DOUBLE)
    slope = Divide(Subtract(Multiply(n, col("sxy")),
                            Multiply(col("sx"), col("sy"))),
                   Subtract(Multiply(n, col("sxx")),
                            Multiply(col("sx"), col("sx"))))
    return (reg.with_column("slope", slope)
            .with_column("intercept",
                         Divide(Subtract(col("sy"),
                                         Multiply(col("slope"),
                                                  col("sx"))), n))
            .where(P.LessThanOrEqual(col("slope"), lit(0.0)))
            .select(col("cat"), col("slope"), col("intercept"))
            .sort(SortOrder(col("cat"))))


def q16(t):
    """Q16: web sales net of refunds in 30-day windows around a price
    change, by warehouse state and item (Q16Like, tpc-ds q40-based LEFT
    OUTER returns join)."""
    pivot = 365
    net = Subtract(col("ws_sales_price"),
                   Coalesce(col("wr_refunded_cash"), lit(0.0)))
    joined = (t["web_sales"]
              .where(_between(col("ws_sold_date_sk"), pivot - 30,
                              pivot + 30))
              .join(t["web_returns"],
                    on=P.And(_eq(col("ws_order_number"),
                                 col("wr_order_number")),
                             _eq(col("ws_item_sk"), col("wr_item_sk"))),
                    how="left")
              .join(t["item"], on=_eq(col("ws_item_sk"),
                                      col("i_item_sk")), how="inner")
              .join(t["warehouse"],
                    on=_eq(col("ws_warehouse_sk"), col("w_warehouse_sk")),
                    how="inner"))
    return (joined
            .group_by(col("w_state"), col("i_item_sk"))
            .agg(_sum(If(P.LessThan(col("ws_sold_date_sk"), lit(pivot)),
                         net, lit(0.0)), "sales_before"),
                 _sum(If(P.GreaterThanOrEqual(col("ws_sold_date_sk"),
                                              lit(pivot)),
                         net, lit(0.0)), "sales_after"))
            .sort(SortOrder(col("w_state")), SortOrder(col("i_item_sk")))
            .limit(100))


def q17(t):
    """Q17: promotional vs total sales share for categories in a period
    (Q17Like, tpc-ds q61-based; promotion channel flags fold into the
    conditional sum)."""
    ss = (t["store_sales"]
          .where(_between(col("ss_sold_date_sk"), 330, 360))
          .join(t["item"].where(P.In(col("i_category_id"), [0, 5])),
                on=_eq(col("ss_item_sk"), col("i_item_sk")),
                how="left_semi"))
    # this datagen has no promotion channel flags: even promo ids play
    # the 'channel active' role
    promo_flag = _eq(Pmod(col("ss_ticket_number"), lit(2)), lit(0))
    agg = (ss.group_by()
           .agg(_sum(If(promo_flag, col("ss_net_paid"), lit(0.0)),
                     "promotional"),
                _sum(col("ss_net_paid"), "total")))
    return agg.select(
        col("promotional"), col("total"),
        If(P.GreaterThan(col("total"), lit(0.0)),
           Divide(Multiply(lit(100.0), col("promotional")), col("total")),
           lit(0.0)).alias("promo_percent"))


def q18(t):
    """Q18: stores with declining sales correlated with negative review
    sentiment — the official runs a sentiment UDF over review text; here
    the negative-tone flag is a device LIKE over pr_review_content
    (exceeds TpcxbbLikeSpark.scala Q18Like, which throws 'uses UDF')."""
    daily = (t["store_sales"]
             .group_by(col("ss_store_sk"), col("ss_sold_date_sk"))
             .agg(_sum(col("ss_net_paid"), "y")))
    x = Cast(col("ss_sold_date_sk"), T.DOUBLE)
    reg = (daily.select(col("ss_store_sk").alias("store"), x.alias("x"),
                        col("y"), Multiply(x, col("y")).alias("xy"),
                        Multiply(x, x).alias("xx"))
           .group_by(col("store"))
           .agg(_cnt("n"), _sum(col("x"), "sx"), _sum(col("y"), "sy"),
                _sum(col("xy"), "sxy"), _sum(col("xx"), "sxx")))
    n = Cast(col("n"), T.DOUBLE)
    slope = Divide(Subtract(Multiply(n, col("sxy")),
                            Multiply(col("sx"), col("sy"))),
                   Subtract(Multiply(n, col("sxx")),
                            Multiply(col("sx"), col("sx"))))
    declining = (reg.where(P.LessThan(slope, lit(0.0)))
                 .select(col("store")))
    neg = (t["product_reviews"]
           .where(Like(col("pr_review_content"), "%terrible%"))
           .join(t["store_sales"].select(
               col("ss_item_sk").alias("sold_item"),
               col("ss_store_sk").alias("sold_store")).distinct(),
               on=_eq(col("pr_item_sk"), col("sold_item")), how="inner")
           .join(declining, on=_eq(col("sold_store"), col("store")),
                 how="left_semi"))
    return (neg.group_by(col("sold_store"))
            .agg(_cnt("negative_reviews"))
            .sort(SortOrder(col("sold_store")))
            .limit(100))


def q19(t):
    """Q19: negative-sentiment reviews of items with high return volume
    (official Q19 runs a sentiment UDF; LIKE plays that role here)."""
    returned = (t["store_returns"]
                .group_by(col("sr_item_sk"))
                .agg(_sum(col("sr_return_quantity"), "ret_qty"))
                .where(P.GreaterThanOrEqual(col("ret_qty"), lit(10)))
                .select(col("sr_item_sk").alias("ret_item")))
    return (t["product_reviews"]
            .where(P.Or(Like(col("pr_review_content"), "%terrible%"),
                        Like(col("pr_review_content"), "%awful%")))
            .join(returned, on=_eq(col("pr_item_sk"), col("ret_item")),
                  how="left_semi")
            .group_by(col("pr_item_sk"))
            .agg(_cnt("neg_reviews"),
                 _avg(col("pr_review_rating"), "avg_rating"))
            .sort(SortOrder(col("pr_item_sk")))
            .limit(100))


def q20(t):
    """Q20: customer return-behavior segmentation — order/item/money
    return ratios per customer (Q20Like; count(distinct ticket) via a
    distinct-pair pre-aggregate)."""
    orders = (t["store_sales"]
              .select(col("ss_customer_sk").alias("cust"),
                      col("ss_ticket_number").alias("tick")).distinct()
              .group_by(col("cust")).agg(_cnt("orders_count")))
    order_items = (t["store_sales"]
                   .group_by(col("ss_customer_sk"))
                   .agg(_cnt("orders_items"),
                        _sum(col("ss_net_paid"), "orders_money")))
    ret_orders = (t["store_returns"]
                  .select(col("sr_customer_sk").alias("rcust"),
                          col("sr_ticket_number").alias("rtick"))
                  .distinct()
                  .group_by(col("rcust")).agg(_cnt("returns_count")))
    ret_items = (t["store_returns"]
                 .group_by(col("sr_customer_sk"))
                 .agg(_cnt("returns_items"),
                      _sum(col("sr_return_amt"), "returns_money")))

    def ratio(a, b):
        return Coalesce(Divide(Cast(col(a), T.DOUBLE),
                               Cast(col(b), T.DOUBLE)), lit(0.0))

    return (orders
            .join(order_items, on=_eq(col("cust"),
                                      col("ss_customer_sk")),
                  how="inner")
            .join(ret_orders, on=_eq(col("cust"), col("rcust")),
                  how="left")
            .join(ret_items, on=_eq(col("cust"), col("sr_customer_sk")),
                  how="left")
            .select(col("cust").alias("user_sk"),
                    ratio("returns_count", "orders_count")
                    .alias("orderRatio"),
                    ratio("returns_items", "orders_items")
                    .alias("itemsRatio"),
                    ratio("returns_money", "orders_money")
                    .alias("monetaryRatio"),
                    Coalesce(col("returns_count"),
                             lit(0)).alias("frequency"))
            .sort(SortOrder(col("user_sk")))
            .limit(1000))


def q21(t):
    """Q21: store purchases returned then re-bought on the web by the
    same customer — quantities per item and store (Q21Like, tpc-ds
    q29-based three-way part join)."""
    part_ss = (t["store_sales"]
               .where(_between(col("ss_sold_date_sk"), 0, 90))
               .select(col("ss_item_sk"), col("ss_store_sk"),
                       col("ss_customer_sk"), col("ss_ticket_number"),
                       col("ss_quantity")))
    part_sr = (t["store_returns"]
               .where(_between(col("sr_returned_date_sk"), 0, 270))
               .select(col("sr_item_sk"), col("sr_customer_sk"),
                       col("sr_ticket_number"),
                       col("sr_return_quantity")))
    part_ws = (t["web_sales"]
               .select(col("ws_item_sk"),
                       col("ws_bill_customer_sk"), col("ws_quantity")))
    return (part_sr
            .join(part_ws,
                  on=P.And(_eq(col("sr_item_sk"), col("ws_item_sk")),
                           _eq(col("sr_customer_sk"),
                               col("ws_bill_customer_sk"))),
                  how="inner")
            .join(part_ss,
                  on=P.And(_eq(col("sr_ticket_number"),
                               col("ss_ticket_number")),
                           P.And(_eq(col("sr_item_sk"),
                                     col("ss_item_sk")),
                                 _eq(col("sr_customer_sk"),
                                     col("ss_customer_sk")))),
                  how="inner")
            .group_by(col("ss_item_sk"), col("ss_store_sk"))
            .agg(_sum(col("ss_quantity"), "store_sales_quantity"),
                 _sum(col("sr_return_quantity"),
                      "store_returns_quantity"),
                 _sum(col("ws_quantity"), "web_sales_quantity"))
            .sort(SortOrder(col("ss_item_sk")),
                  SortOrder(col("ss_store_sk")))
            .limit(100))


def q22(t):
    """Q22: inventory change around a price-change date by warehouse,
    ratio-banded (Q22Like, tpc-ds q21-based)."""
    pivot = 365
    joined = (t["inventory"]
              .where(_between(col("inv_date_sk"), pivot - 60, pivot + 60))
              .join(t["item"].where(_between(col("i_current_price"),
                                             20.0, 80.0)),
                    on=_eq(col("inv_item_sk"), col("i_item_sk")),
                    how="inner")
              .join(t["warehouse"],
                    on=_eq(col("inv_warehouse_sk"),
                           col("w_warehouse_sk")), how="inner"))
    agg = (joined.group_by(col("w_warehouse_name"), col("inv_item_sk"))
           .agg(_sum(If(P.LessThan(col("inv_date_sk"), lit(pivot)),
                        col("inv_quantity_on_hand"), lit(0)),
                     "inv_before"),
                _sum(If(P.GreaterThanOrEqual(col("inv_date_sk"),
                                             lit(pivot)),
                        col("inv_quantity_on_hand"), lit(0)),
                     "inv_after")))
    ratio = Divide(Cast(col("inv_after"), T.DOUBLE),
                   Cast(col("inv_before"), T.DOUBLE))
    return (agg.where(P.GreaterThan(col("inv_before"), lit(0)))
            .where(P.And(P.GreaterThanOrEqual(ratio, lit(2.0 / 3.0)),
                         P.LessThanOrEqual(ratio, lit(1.5))))
            .sort(SortOrder(col("w_warehouse_name")),
                  SortOrder(col("inv_item_sk")))
            .limit(100))


def q23(t):
    """Q23: items with high month-to-month inventory variability —
    per-month coefficient of variation, consecutive months self-joined
    (Q23Like, tpc-ds q39-based; stdev via sum-of-squares)."""
    # quarter buckets: at test scales monthly cells hold <1 sample
    month = IntegralDivide(col("inv_date_sk"), lit(90))
    q = Cast(col("inv_quantity_on_hand"), T.DOUBLE)
    monthly = (t["inventory"]
               .where(_between(col("inv_date_sk"), 0, 360))
               .with_column("moy", month)
               .group_by(col("inv_warehouse_sk"), col("inv_item_sk"),
                         col("moy"))
               .agg(_cnt("n"), _avg(col("inv_quantity_on_hand"), "mean"),
                    _sum(Multiply(q, q), "sumsq"), _sum(q, "s")))
    nn = Cast(col("n"), T.DOUBLE)
    var = Divide(Subtract(col("sumsq"),
                          Multiply(nn, Multiply(col("mean"),
                                                col("mean")))),
                 Subtract(nn, lit(1.0)))
    banded = (monthly.where(P.GreaterThan(col("n"), lit(1)))
              .where(P.GreaterThan(col("mean"), lit(0.0)))
              .with_column("cov", Divide(Sqrt(var), col("mean")))
              .where(P.GreaterThanOrEqual(col("cov"), lit(0.4))))
    m1 = banded.select(col("inv_warehouse_sk").alias("wh1"),
                       col("inv_item_sk").alias("it1"),
                       col("moy").alias("moy1"),
                       col("cov").alias("cov1"))
    m2 = banded.select(col("inv_warehouse_sk").alias("wh2"),
                       col("inv_item_sk").alias("it2"),
                       col("moy").alias("moy2"),
                       col("cov").alias("cov2"))
    return (m1.join(m2, on=P.And(_eq(col("wh1"), col("wh2")),
                                 P.And(_eq(col("it1"), col("it2")),
                                       _eq(Add(col("moy1"), lit(1)),
                                           col("moy2")))),
                    how="inner")
            .sort(SortOrder(col("wh1")), SortOrder(col("it1")),
                  SortOrder(col("moy1")))
            .limit(100))


def q24(t):
    """Q24: cross-price elasticity of demand — quantity change around a
    competitor price change over both channels (Q24Like)."""
    comp = (t["item_marketprices"]
            .join(t["item"], on=_eq(col("imp_item_sk"),
                                    col("i_item_sk")), how="inner")
            .where(P.LessThan(col("i_item_sk"), lit(8)))
            .select(col("i_item_sk").alias("tsk"),
                    col("imp_sk"),
                    Divide(Subtract(col("imp_competitor_price"),
                                    col("i_current_price")),
                           col("i_current_price")).alias("price_change"),
                    col("imp_start_date").alias("start"),
                    Subtract(col("imp_end_date"),
                             col("imp_start_date")).alias("ndays")))

    def quant(fact, item_col, date_col, qty, pre):
        cur = If(P.And(P.GreaterThanOrEqual(col(date_col), col("start")),
                       P.LessThan(col(date_col),
                                  Add(col("start"), col("ndays")))),
                 col(qty), lit(0))
        prev = If(P.And(P.GreaterThanOrEqual(
            col(date_col), Subtract(col("start"), col("ndays"))),
            P.LessThan(col(date_col), col("start"))),
            col(qty), lit(0))
        return (t[fact]
                .join(comp, on=_eq(col(item_col), col("tsk")),
                      how="inner")
                .group_by(col("tsk"), col("imp_sk"),
                          col("price_change"))
                .agg(_sum(cur, pre + "_cur"), _sum(prev, pre + "_prev"))
                .select(col("tsk").alias(pre + "_sk"),
                        col("imp_sk").alias(pre + "_imp"),
                        col("price_change").alias(pre + "_pc"),
                        col(pre + "_cur"), col(pre + "_prev")))

    ws = quant("web_sales", "ws_item_sk", "ws_sold_date_sk",
               "ws_quantity", "w")
    ss = quant("store_sales", "ss_item_sk", "ss_sold_date_sk",
               "ss_quantity", "s")
    num = Cast(Subtract(Add(col("s_cur"), col("w_cur")),
                        Add(col("s_prev"), col("w_prev"))), T.DOUBLE)
    den = Multiply(Cast(Add(col("s_prev"), col("w_prev")), T.DOUBLE),
                   col("w_pc"))
    return (ws.join(ss, on=P.And(_eq(col("w_sk"), col("s_sk")),
                                 _eq(col("w_imp"), col("s_imp"))),
                    how="inner")
            .where(P.GreaterThan(Add(col("s_prev"), col("w_prev")),
                                 lit(0)))
            .with_column("elasticity", Divide(num, den))
            .group_by(col("w_sk"))
            .agg(_avg(col("elasticity"), "cross_price_elasticity"))
            .sort(SortOrder(col("w_sk"))))


def q25(t):
    """Q25: RFM customer segmentation across store + web (Q25Like;
    count(distinct order) via distinct-pair pre-aggregates, the two
    INSERTs become a union)."""
    cutoff = 500

    def channel(fact, cust, order, date_col, paid):
        freq = (t[fact]
                .where(P.GreaterThan(col(date_col), lit(cutoff)))
                .select(col(cust).alias("cid"),
                        col(order).alias("ord")).distinct()
                .group_by(col("cid")).agg(_cnt("frequency")))
        stats = (t[fact]
                 .where(P.GreaterThan(col(date_col), lit(cutoff)))
                 .group_by(col(cust))
                 .agg(A.AggregateExpression(A.Max(col(date_col)),
                                            "most_recent"),
                      _sum(col(paid), "amount"))
                 .select(col(cust).alias("sid"), col("most_recent"),
                         col("amount")))
        return (freq.join(stats, on=_eq(col("cid"), col("sid")),
                          how="inner")
                .select(col("cid"), col("frequency"),
                        col("most_recent"), col("amount")))

    both = channel("store_sales", "ss_customer_sk", "ss_ticket_number",
                   "ss_sold_date_sk", "ss_net_paid") \
        .union(channel("web_sales", "ws_bill_customer_sk",
                       "ws_order_number", "ws_sold_date_sk",
                       "ws_net_paid"))
    return (both.group_by(col("cid"))
            .agg(A.AggregateExpression(A.Max(col("most_recent")),
                                       "last_date"),
                 _sum(col("frequency"), "frequency"),
                 _sum(col("amount"), "totalspend"))
            .select(col("cid"),
                    If(P.LessThan(Subtract(lit(730), col("last_date")),
                                  lit(60)), lit(1.0),
                       lit(0.0)).alias("recency"),
                    col("frequency"), col("totalspend"))
            .sort(SortOrder(col("cid")))
            .limit(1000))


def q26(t):
    """Q26: book-club clustering features — per-customer store purchase
    counts across item class ids (Q26Like's 15 conditional counts)."""
    ss = (t["store_sales"]
          .join(t["item"].where(_eq(col("i_category"), lit("Books"))),
                on=_eq(col("ss_item_sk"), col("i_item_sk")),
                how="inner"))
    feats = [_sum(If(_eq(col("i_class_id"), lit(cid)), lit(1), lit(0)),
                  f"id{cid}") for cid in range(1, 16)]
    return (ss.group_by(col("ss_customer_sk"))
            .agg(*feats, _cnt("n_items"))
            .where(P.GreaterThan(col("n_items"), lit(5)))
            .sort(SortOrder(col("ss_customer_sk")))
            .limit(1000))


def q27(t):
    """Q27: reviews mentioning competitors for given items — the
    official extracts competitor names with an NLP UDF; a device LIKE
    scan plays that role (exceeds Q27Like, which throws 'uses UDF')."""
    return (t["product_reviews"]
            .where(P.Or(Like(col("pr_review_content"), "%acme%"),
                        Like(col("pr_review_content"), "%zenith%")))
            .with_column("competitor",
                         If(Like(col("pr_review_content"), "%acme%"),
                            lit("acme"), lit("zenith")))
            .group_by(col("pr_item_sk"), col("competitor"))
            .agg(_cnt("mentions"))
            .sort(SortOrder(col("pr_item_sk")),
                  SortOrder(col("competitor")))
            .limit(200))


def q28(t):
    """Q28: sentiment-classifier train/test split of reviews with a
    label summary per split (Q28Like's pmod 10 partitioning)."""
    bucket = Pmod(col("pr_review_sk"), lit(10))
    flagged = t["product_reviews"].with_column("bucket", bucket)
    split = If(_eq(col("bucket"), lit(0)), lit("test"), lit("train"))
    return (flagged.with_column("split", split)
            .group_by(col("split"), col("pr_review_rating"))
            .agg(_cnt("n_reviews"))
            .sort(SortOrder(col("split")),
                  SortOrder(col("pr_review_rating"))))


def q29(t):
    """Q29: cross-category affinity of web orders — category pairs
    co-occurring in one order (the official's UDTF pair-expansion as a
    self-join; exceeds Q29Like, which throws 'uses UDTF')."""
    o = (t["web_sales"]
         .join(t["item"], on=_eq(col("ws_item_sk"), col("i_item_sk")),
               how="inner")
         .select(col("ws_order_number").alias("ord"),
                 col("i_category_id").alias("cat")).distinct())
    a = o.select(col("ord").alias("o1"), col("cat").alias("cat_a"))
    b = o.select(col("ord").alias("o2"), col("cat").alias("cat_b"))
    return (a.join(b, on=_eq(col("o1"), col("o2")), how="inner")
            .where(P.LessThan(col("cat_a"), col("cat_b")))
            .group_by(col("cat_a"), col("cat_b"))
            .agg(_cnt("cnt"))
            .sort(SortOrder(col("cnt"), ascending=False),
                  SortOrder(col("cat_a")), SortOrder(col("cat_b")))
            .limit(100))


def q30(t):
    """Q30: item-category affinity inside clickstream sessions — the
    official query sessionizes with a UDTF; the shared window-function
    sessionization and a self-join express it."""
    s = (_sessionized(t)
         .join(t["item"], on=_eq(col("item"), col("i_item_sk")),
               how="inner")
         .select(col("user"), col("session_id"),
                 col("i_category_id").alias("cat")).distinct())
    a = s.select(col("user").alias("u1"),
                 col("session_id").alias("s1"),
                 col("cat").alias("cat_a"))
    b = s.select(col("user").alias("u2"),
                 col("session_id").alias("s2"),
                 col("cat").alias("cat_b"))
    return (a.join(b, on=P.And(_eq(col("u1"), col("u2")),
                               _eq(col("s1"), col("s2"))),
                   how="inner")
            .where(P.LessThan(col("cat_a"), col("cat_b")))
            .group_by(col("cat_a"), col("cat_b"))
            .agg(_cnt("cnt"))
            .sort(SortOrder(col("cnt"), ascending=False),
                  SortOrder(col("cat_a")), SortOrder(col("cat_b")))
            .limit(100))


def _between(c, lo, hi):
    return P.And(P.GreaterThanOrEqual(c, lit(lo)),
                 P.LessThanOrEqual(c, lit(hi)))


QUERIES = {"q01": q01, "q02": q02, "q03": q03, "q04": q04, "q05": q05,
           "q06": q06, "q07": q07, "q08": q08, "q09": q09, "q10": q10,
           "q11": q11, "q12": q12, "q13": q13, "q14": q14, "q15": q15,
           "q16": q16, "q17": q17, "q18": q18, "q19": q19, "q20": q20,
           "q21": q21, "q22": q22, "q23": q23, "q24": q24, "q25": q25,
           "q26": q26, "q27": q27, "q28": q28, "q29": q29, "q30": q30}

