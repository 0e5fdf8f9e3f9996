"""TPCxBB-shaped tables and queries — port of
``spark_rapids_tpu/workloads/tpcxbb.py``: the generator, and the bench
suite's three TPCxBB entries, ``q01`` (basket analysis: a self-join on
the store ticket, a two-key count, a HAVING filter and a top 100),
``q05`` (the per-user click features and a left-joined buyer label)
and ``q30`` (item-category affinity inside clickstream sessions, which
the shared :func:`_sessionized` core builds with windows and a
two-key self-join). Each query is copied node for node from the
reference; :data:`QUERIES` holds them under the reference's names.

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
from ..ops.arithmetic import Add, Multiply, Subtract
from ..ops.conditional import Coalesce, If
from ..ops.expression import col, lit
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


QUERIES = {"q01": q01, "q05": q05, "q30": q30}
