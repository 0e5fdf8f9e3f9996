"""TPC-DS-shaped tables and queries — port of
``spark_rapids_tpu/workloads/tpcds.py``: the generator and all 99 of
the reference's queries. The first 33 are the reference's default-tier
set (q1, q3, q6, q36, q44, q51, q88, q98), which covers every operator
family of the suite; q5, BASELINE configuration 1's shape (three
channels joined, aggregated and unioned); the other rollups without new
expressions (q18, q22, q86); q97, the other full outer join; and the
rest of the reference's first block of star joins (q7 ... q96). The
next 33 are grouped below by what they exercise: INTERSECT and EXCEPT
as semi and anti joins over ``USING`` keys (q14, q38, q87), the
windowed ones (q12, q20, q47, q49, q53, q57, q63, q67, q70, q89), the
rollups over channels (q77, q80), year-over-year self joins of one
aggregate (q2, q4, q11, q31, q74), EXISTS and NOT EXISTS (q10, q16,
q35, q69, q94, q95), scalar thresholds (q23, q24), and q8, q58, q71,
q83 and q91. The last 33 are grouped in the same way: one-table and
scalar-ratio queries, star joins with ``If`` buckets and ``Substring``,
averages and deviations joined back (``Sqrt`` of a variance built from
sums), channel unions, and the large join graphs (q64, q72 with
``DateAdd``, q75, q78). Each query is copied node for node from the reference;
:data:`QUERIES` holds them under the reference's names. ROLLUP runs
through ``DataFrame.rollup`` (Expand + Aggregate,
:class:`~..exec.execs.ExpandExec`).

:func:`gen_tables` is a numpy-only copy of the reference generator: the
same seed draws the same values in the same order, so both packages see
identical tables, nulls included. Tables come back as
:class:`HostBatch` es: numpy values plus validity masks where the
reference builds ``pa.array(..., mask=...)`` (``ss_promo_sk`` about 5 %
null, ``cs_ship_addr_sk`` and ``ws_ship_customer_sk`` about 8 %);
``d_date`` is DATE (int32 days since the epoch), the other integers
LONG, money DOUBLE, strings numpy unicode arrays.
"""

from __future__ import annotations

import numpy as np

from .. import types as T
from ..data.batch import HostBatch
from ..ops import aggregates as A
from ..ops import predicates as P
from ..ops.arithmetic import Abs, Add, Divide, Multiply, Subtract
from ..ops.cast import Cast
from ..ops.conditional import Coalesce, If
from ..ops.datetime import DateAdd
from ..ops.expression import col, lit
from ..ops.math import Sqrt
from ..ops.strings import Substring
from ..ops.windows import Rank, RowNumber, Window, over
from ..plan.logical import SortOrder

_DAY_NAMES = np.array(["Thursday", "Friday", "Saturday", "Sunday",
                       "Monday", "Tuesday", "Wednesday"])
_CATEGORIES = np.array(["Books", "Electronics", "Home", "Jewelry", "Men",
                        "Music", "Shoes", "Sports", "Children", "Women"])
_CLASSES = np.array(["accent", "bedding", "classical", "diamonds",
                     "dresses", "fiction", "football", "pants",
                     "portable", "wallpaper"])
_CITIES = np.array(["Fairview", "Midway", "Pleasant Hill", "Centerville",
                    "Oak Grove", "Riverside", "Five Points", "Liberty",
                    "Greenville", "Bethel"])
_STATES = np.array(["AL", "CA", "GA", "KY", "MN", "NC", "OH", "SD", "TN",
                    "TX", "VA", "WA"])
_COUNTRIES = np.array(["United States"])
_GENDERS = np.array(["M", "F"])
_MARITAL = np.array(["M", "S", "D", "W", "U"])
_EDUCATION = np.array(["Primary", "Secondary", "College", "2 yr Degree",
                       "4 yr Degree", "Advanced Degree", "Unknown"])
_BUY_POTENTIAL = np.array([">10000", "5001-10000", "1001-5000", "501-1000",
                           "0-500", "Unknown"])
_FIRST = np.array(["James", "Mary", "John", "Linda", "Robert", "Barbara",
                   "Michael", "Susan", "William", "Karen"])
_LAST = np.array(["Smith", "Johnson", "Brown", "Jones", "Miller", "Davis",
                  "Wilson", "Moore", "Taylor", "Thomas"])


def _nullable(values: np.ndarray, null: np.ndarray):
    """A column whose ``null`` rows hold no value (the reference's
    ``pa.array(values, mask=null)``)."""
    return values, null


def _table(columns: dict) -> HostBatch:
    """int32 columns are DATE, int64 LONG, float64 DOUBLE, unicode
    STRING; a :func:`_nullable` column carries its validity."""
    data, validity = {}, {}
    for name, c in columns.items():
        if isinstance(c, tuple):
            c, null = c
            validity[name] = ~null
        data[name] = c
    schema = T.Schema([T.StructField(
        n, T.DATE if a.dtype == np.int32 else T.from_numpy_dtype(a.dtype))
        for n, a in data.items()])
    return HostBatch.from_numpy(data, schema, validity)


def _money(rng, lo, hi, n):
    return np.round(rng.uniform(lo, hi, n), 2)


def gen_tables(store_sales_rows: int = 1 << 20, seed: int = 42) -> dict:
    """The TPC-DS-shaped tables scaled off the store_sales row count
    (other tables keep roughly TPC-DS's relative sizes: catalog ~ 2/3,
    web ~ 1/2, returns ~ 1/10 of their channel): ``{name: HostBatch}``,
    the reference's tables value for value."""
    rng = np.random.default_rng(seed)
    n_ss = store_sales_rows
    n_cs = max(n_ss * 2 // 3, 64)
    n_ws = max(n_ss // 2, 64)
    n_sr = max(n_ss // 10, 32)
    n_cr = max(n_cs // 10, 32)
    n_wr = max(n_ws // 10, 32)
    n_item = max(n_ss // 50, 64)
    n_cust = max(n_ss // 20, 64)
    n_store = 12
    n_cd = 7 * len(_MARITAL) * len(_EDUCATION)
    n_hd = 60
    n_promo = 30
    n_site = 6
    n_cp = 40
    n_wh = 5
    n_sm = 20
    n_reason = 35
    n_cc = 6
    n_wp = 20
    n_ib = 20
    n_inv = max(n_ss // 2, 256)

    # ---- date_dim: 5 years 1998-2002, d_date_sk = day ordinal ------------
    days = np.arange(np.datetime64("1998-01-01"), np.datetime64("2003-01-01"),
                     dtype="datetime64[D]")
    n_dates = len(days)
    months = days.astype("datetime64[M]")
    years = (days.astype("datetime64[Y]").astype(np.int64) + 1970)
    moy = (months.astype(np.int64) % 12 + 1)
    dom = (days - months).astype(np.int64) + 1
    date_dim = {
        "d_date_sk": np.arange(n_dates, dtype=np.int64),
        "d_date": days.astype("datetime64[D]").astype(np.int32),
        "d_year": years,
        "d_moy": moy,
        "d_dom": dom,
        "d_qoy": (moy - 1) // 3 + 1,
        "d_week_seq": (days.astype(np.int64) // 7),
        "d_month_seq": (years - 1998) * 12 + moy - 1,
        "d_day_name": _DAY_NAMES[days.astype(np.int64) % 7],
    }

    # ---- dimensions ------------------------------------------------------
    cat_idx = rng.integers(0, len(_CATEGORIES), n_item)
    class_idx = rng.integers(0, len(_CLASSES), n_item)
    brand_id = rng.integers(1, 100, n_item).astype(np.int64)
    manufact_id = rng.integers(1, 100, n_item).astype(np.int64)
    item = {
        "i_item_sk": np.arange(n_item, dtype=np.int64),
        "i_item_id": np.char.add("ITEM", np.arange(n_item).astype(np.str_)),
        "i_brand_id": brand_id,
        "i_brand": np.char.add("Brand#", brand_id.astype(np.str_)),
        "i_class_id": class_idx.astype(np.int64),
        "i_class": _CLASSES[class_idx],
        "i_category_id": cat_idx.astype(np.int64),
        "i_category": _CATEGORIES[cat_idx],
        "i_manufact_id": manufact_id,
        "i_manufact": np.char.add("ably", manufact_id.astype(np.str_)),
        "i_manager_id": rng.integers(1, 100, n_item).astype(np.int64),
        "i_product_name": np.char.add(
            "prod", np.arange(n_item).astype(np.str_)),
        "i_current_price": _money(rng, 0.5, 100.0, n_item),
    }

    store = {
        "s_store_sk": np.arange(n_store, dtype=np.int64),
        "s_store_id": np.char.add("STORE",
                                  np.arange(n_store).astype(np.str_)),
        "s_store_name": np.char.add("able",
                                    np.arange(n_store).astype(np.str_)),
        "s_city": _CITIES[rng.integers(0, len(_CITIES), n_store)],
        "s_county": np.char.add(
            _CITIES[rng.integers(0, len(_CITIES), n_store)], " County"),
        "s_state": _STATES[rng.integers(0, len(_STATES), n_store)],
        "s_zip": (rng.integers(10000, 99999, n_store)).astype(np.str_),
        "s_company_id": rng.integers(1, 3, n_store).astype(np.int64),
        "s_number_employees": rng.integers(200, 300,
                                           n_store).astype(np.int64),
        "s_gmt_offset": rng.choice([-5.0, -6.0, -7.0, -8.0], n_store),
    }

    ca = {
        "ca_address_sk": np.arange(n_cust, dtype=np.int64),
        "ca_city": _CITIES[rng.integers(0, len(_CITIES), n_cust)],
        "ca_county": np.char.add(
            _CITIES[rng.integers(0, len(_CITIES), n_cust)], " County"),
        "ca_state": _STATES[rng.integers(0, len(_STATES), n_cust)],
        "ca_zip": (rng.integers(10000, 99999, n_cust)).astype(np.str_),
        "ca_country": _COUNTRIES[np.zeros(n_cust, dtype=np.int64)],
        "ca_location_type": np.array(["condo", "single family",
                                      "apartment"])[
            rng.integers(0, 3, n_cust)],
        "ca_gmt_offset": rng.choice([-5.0, -6.0, -7.0, -8.0], n_cust),
    }

    customer = {
        "c_customer_sk": np.arange(n_cust, dtype=np.int64),
        "c_customer_id": np.char.add("CUST",
                                     np.arange(n_cust).astype(np.str_)),
        "c_current_cdemo_sk": rng.integers(0, n_cd, n_cust).astype(np.int64),
        "c_current_hdemo_sk": rng.integers(0, n_hd, n_cust).astype(np.int64),
        "c_current_addr_sk": rng.permutation(n_cust).astype(np.int64),
        "c_first_name": _FIRST[rng.integers(0, len(_FIRST), n_cust)],
        "c_last_name": _LAST[rng.integers(0, len(_LAST), n_cust)],
        "c_preferred_cust_flag": np.array(["Y", "N"])[
            rng.integers(0, 2, n_cust)],
        "c_birth_month": rng.integers(1, 13, n_cust).astype(np.int64),
        "c_birth_year": rng.integers(1930, 1995, n_cust).astype(np.int64),
        "c_birth_country": np.array(["UNITED STATES", "CANADA", "MEXICO",
                                     "PERU", "CHILE"])[
            rng.integers(0, 5, n_cust)],
        "c_salutation": np.array(["Mr.", "Mrs.", "Ms.", "Dr."])[
            rng.integers(0, 4, n_cust)],
    }

    cd_idx = np.arange(n_cd)
    cd = {
        "cd_demo_sk": cd_idx.astype(np.int64),
        "cd_gender": _GENDERS[cd_idx % 2],
        "cd_marital_status": _MARITAL[(cd_idx // 2) % len(_MARITAL)],
        "cd_education_status":
            _EDUCATION[(cd_idx // (2 * len(_MARITAL))) % len(_EDUCATION)],
        "cd_dep_count": (cd_idx % 7).astype(np.int64),
    }

    hd_idx = np.arange(n_hd)
    hd = {
        "hd_demo_sk": hd_idx.astype(np.int64),
        "hd_income_band_sk": (hd_idx % n_ib).astype(np.int64),
        "hd_dep_count": (hd_idx % 10).astype(np.int64),
        "hd_vehicle_count": (hd_idx % 5).astype(np.int64),
        "hd_buy_potential":
            _BUY_POTENTIAL[hd_idx % len(_BUY_POTENTIAL)],
    }

    income_band = {
        "ib_income_band_sk": np.arange(n_ib, dtype=np.int64),
        "ib_lower_bound": (np.arange(n_ib) * 10000).astype(np.int64),
        "ib_upper_bound": ((np.arange(n_ib) + 1) * 10000).astype(np.int64),
    }

    warehouse = {
        "w_warehouse_sk": np.arange(n_wh, dtype=np.int64),
        "w_warehouse_name": np.char.add(
            "Warehouse", np.arange(n_wh).astype(np.str_)),
        "w_warehouse_sq_ft":
            rng.integers(50_000, 1_000_000, n_wh).astype(np.int64),
        "w_city": _CITIES[rng.integers(0, len(_CITIES), n_wh)],
        "w_county": np.char.add(
            _CITIES[rng.integers(0, len(_CITIES), n_wh)], " County"),
        "w_state": _STATES[rng.integers(0, len(_STATES), n_wh)],
        "w_country": _COUNTRIES[np.zeros(n_wh, dtype=np.int64)],
    }

    ship_mode = {
        "sm_ship_mode_sk": np.arange(n_sm, dtype=np.int64),
        "sm_type": np.array(["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR",
                             "TWO DAY"])[np.arange(n_sm) % 5],
        "sm_carrier": np.array(["UPS", "FEDEX", "AIRBORNE", "USPS",
                                "DHL"])[np.arange(n_sm) % 5],
        "sm_code": np.array(["AIR", "SURFACE", "SEA", "LIBRARY"])[
            np.arange(n_sm) % 4],
    }

    reason = {
        "r_reason_sk": np.arange(n_reason, dtype=np.int64),
        "r_reason_desc": np.char.add(
            "reason ", np.arange(n_reason).astype(np.str_)),
    }

    call_center = {
        "cc_call_center_sk": np.arange(n_cc, dtype=np.int64),
        "cc_call_center_id": np.char.add(
            "CC", np.arange(n_cc).astype(np.str_)),
        "cc_name": np.char.add("center", np.arange(n_cc).astype(np.str_)),
        "cc_manager": _FIRST[rng.integers(0, len(_FIRST), n_cc)],
        "cc_county": np.char.add(
            _CITIES[rng.integers(0, len(_CITIES), n_cc)], " County"),
    }

    web_page = {
        "wp_web_page_sk": np.arange(n_wp, dtype=np.int64),
        "wp_char_count": rng.integers(2000, 8000, n_wp).astype(np.int64),
    }

    yn = np.array(["Y", "N"])
    promotion = {
        "p_promo_sk": np.arange(n_promo, dtype=np.int64),
        "p_channel_email": yn[rng.integers(0, 2, n_promo)],
        "p_channel_event": yn[rng.integers(0, 2, n_promo)],
        "p_channel_dmail": yn[rng.integers(0, 2, n_promo)],
    }

    n_time = 24 * 60
    time_dim = {
        "t_time_sk": np.arange(n_time, dtype=np.int64),
        "t_hour": (np.arange(n_time) // 60).astype(np.int64),
        "t_minute": (np.arange(n_time) % 60).astype(np.int64),
    }

    web_site = {
        "web_site_sk": np.arange(n_site, dtype=np.int64),
        "web_site_id": np.char.add("SITE",
                                   np.arange(n_site).astype(np.str_)),
        "web_name": np.char.add("site", np.arange(n_site).astype(np.str_)),
        "web_company_name": np.array(["pri", "able", "ese", "anti", "cally",
                                      "ation"])[np.arange(n_site) % 6],
    }

    catalog_page = {
        "cp_catalog_page_sk": np.arange(n_cp, dtype=np.int64),
        "cp_catalog_page_id": np.char.add(
            "PAGE", np.arange(n_cp).astype(np.str_)),
    }

    # ---- facts -----------------------------------------------------------
    def sales_money(n):
        wholesale = _money(rng, 1.0, 70.0, n)
        list_p = np.round(wholesale * rng.uniform(1.0, 2.0, n), 2)
        sales_p = np.round(list_p * rng.uniform(0.3, 1.0, n), 2)
        qty = rng.integers(1, 100, n).astype(np.int64)
        qf = qty.astype(np.float64)
        return wholesale, list_p, sales_p, qty, qf

    wholesale, list_p, sales_p, qty, qf = sales_money(n_ss)
    coupon = np.where(rng.random(n_ss) < 0.1,
                      _money(rng, 0.0, 500.0, n_ss), 0.0)
    ext_sales = np.round(sales_p * qf, 2)
    ext_wholesale = np.round(wholesale * qf, 2)
    net_paid = np.round(ext_sales - coupon, 2)
    store_sales = {
        "ss_sold_date_sk": rng.integers(0, n_dates, n_ss).astype(np.int64),
        "ss_sold_time_sk": rng.integers(0, n_time, n_ss).astype(np.int64),
        "ss_item_sk": rng.integers(0, n_item, n_ss).astype(np.int64),
        "ss_customer_sk": rng.integers(0, n_cust, n_ss).astype(np.int64),
        "ss_cdemo_sk": rng.integers(0, n_cd, n_ss).astype(np.int64),
        "ss_hdemo_sk": rng.integers(0, n_hd, n_ss).astype(np.int64),
        "ss_addr_sk": rng.integers(0, n_cust, n_ss).astype(np.int64),
        "ss_store_sk": rng.integers(0, n_store, n_ss).astype(np.int64),
        # ~5% null promo fk: null-fk channel queries (q76 shape) need real
        # nulls; inner joins on promo simply drop them, matching dsdgen.
        "ss_promo_sk": _nullable(
            rng.integers(0, n_promo, n_ss).astype(np.int64),
            rng.random(n_ss) < 0.05),
        "ss_ticket_number":
            rng.integers(0, max(n_ss // 8, 8), n_ss).astype(np.int64),
        "ss_quantity": qty,
        "ss_wholesale_cost": wholesale,
        "ss_list_price": list_p,
        "ss_sales_price": sales_p,
        "ss_ext_discount_amt":
            np.round((list_p - sales_p) * qf, 2),
        "ss_ext_sales_price": ext_sales,
        "ss_ext_wholesale_cost": ext_wholesale,
        "ss_ext_list_price": np.round(list_p * qf, 2),
        "ss_coupon_amt": coupon,
        "ss_net_paid": net_paid,
        "ss_net_profit": np.round(net_paid - ext_wholesale, 2),
    }

    # Returns reference actual sales rows (dsdgen does the same): pick the
    # returned sale, return 1-90 days after it. This is what makes the
    # sale -> return -> re-purchase chain queries (q25/q29) join non-empty.
    ret_idx = rng.integers(0, n_ss, n_sr)
    ss_dates = store_sales["ss_sold_date_sk"]
    ss_items = store_sales["ss_item_sk"]
    ss_custs = store_sales["ss_customer_sk"]
    ss_tickets = store_sales["ss_ticket_number"]
    ss_stores = store_sales["ss_store_sk"]
    ret_amt = _money(rng, 1.0, 4000.0, n_sr)
    store_returns = {
        "sr_returned_date_sk":
            np.minimum(ss_dates[ret_idx] + rng.integers(1, 90, n_sr),
                       n_dates - 1).astype(np.int64),
        "sr_item_sk": ss_items[ret_idx].astype(np.int64),
        "sr_customer_sk": ss_custs[ret_idx].astype(np.int64),
        "sr_ticket_number": ss_tickets[ret_idx].astype(np.int64),
        "sr_store_sk": ss_stores[ret_idx].astype(np.int64),
        "sr_reason_sk": rng.integers(0, n_reason, n_sr).astype(np.int64),
        "sr_return_quantity": rng.integers(1, 50, n_sr).astype(np.int64),
        "sr_return_amt": ret_amt,
        "sr_refunded_cash":
            np.round(ret_amt * rng.uniform(0.5, 1.0, n_sr), 2),
        "sr_net_loss": np.round(ret_amt * rng.uniform(0.3, 1.0, n_sr), 2),
    }

    cw, cl, cs_p, cqty, cqf = sales_money(n_cs)
    c_coupon = np.where(rng.random(n_cs) < 0.1,
                        _money(rng, 0.0, 500.0, n_cs), 0.0)
    c_ext = np.round(cs_p * cqf, 2)
    # A slice of catalog sales are re-purchases by returning customers
    # (same customer+item, dated after the return) so q25/q29's third leg
    # matches; the rest are independent.
    cs_date = rng.integers(0, n_dates, n_cs)
    cs_item = rng.integers(0, n_item, n_cs)
    cs_cust = rng.integers(0, n_cust, n_cs)
    n_rep = min(n_cs // 4, n_sr)
    rep_idx = rng.integers(0, n_sr, n_rep)
    sr_dates = store_returns["sr_returned_date_sk"]
    sr_items = store_returns["sr_item_sk"]
    sr_custs = store_returns["sr_customer_sk"]
    cs_date[:n_rep] = np.minimum(
        sr_dates[rep_idx] + rng.integers(1, 60, n_rep), n_dates - 1)
    cs_item[:n_rep] = sr_items[rep_idx]
    cs_cust[:n_rep] = sr_custs[rep_idx]
    cs_net_paid = np.round(c_ext - c_coupon, 2)
    catalog_sales = {
        "cs_sold_date_sk": cs_date.astype(np.int64),
        "cs_sold_time_sk": rng.integers(0, n_time, n_cs).astype(np.int64),
        "cs_ship_date_sk":
            np.minimum(cs_date + rng.integers(1, 120, n_cs),
                       n_dates - 1).astype(np.int64),
        "cs_item_sk": cs_item.astype(np.int64),
        "cs_bill_customer_sk": cs_cust.astype(np.int64),
        "cs_ship_customer_sk":
            rng.integers(0, n_cust, n_cs).astype(np.int64),
        "cs_bill_cdemo_sk": rng.integers(0, n_cd, n_cs).astype(np.int64),
        "cs_bill_hdemo_sk": rng.integers(0, n_hd, n_cs).astype(np.int64),
        "cs_bill_addr_sk": rng.integers(0, n_cust, n_cs).astype(np.int64),
        # ~8% null ship-address fk (q76-family null-channel counts)
        "cs_ship_addr_sk": _nullable(
            rng.integers(0, n_cust, n_cs).astype(np.int64),
            rng.random(n_cs) < 0.08),
        "cs_call_center_sk": rng.integers(0, n_cc, n_cs).astype(np.int64),
        "cs_catalog_page_sk": rng.integers(0, n_cp, n_cs).astype(np.int64),
        "cs_ship_mode_sk": rng.integers(0, n_sm, n_cs).astype(np.int64),
        "cs_warehouse_sk": rng.integers(0, n_wh, n_cs).astype(np.int64),
        "cs_promo_sk": rng.integers(0, n_promo, n_cs).astype(np.int64),
        "cs_order_number":
            rng.integers(0, max(n_cs // 4, 8), n_cs).astype(np.int64),
        "cs_quantity": cqty,
        "cs_wholesale_cost": cw,
        "cs_list_price": cl,
        "cs_sales_price": cs_p,
        "cs_ext_discount_amt": np.round((cl - cs_p) * cqf, 2),
        "cs_ext_sales_price": c_ext,
        "cs_ext_wholesale_cost": np.round(cw * cqf, 2),
        "cs_ext_list_price": np.round(cl * cqf, 2),
        "cs_ext_ship_cost": _money(rng, 0.0, 100.0, n_cs),
        "cs_coupon_amt": c_coupon,
        "cs_net_paid": cs_net_paid,
        "cs_net_profit":
            np.round(c_ext - c_coupon - np.round(cw * cqf, 2), 2),
    }

    # Catalog returns reference actual catalog sales rows (item + order
    # line up so order-number joins match, as dsdgen guarantees).
    cret_idx = rng.integers(0, n_cs, n_cr)
    cs_dates_np = catalog_sales["cs_sold_date_sk"]
    cs_items_np = catalog_sales["cs_item_sk"]
    cs_orders_np = catalog_sales["cs_order_number"]
    cs_custs_np = catalog_sales["cs_bill_customer_sk"]
    cr_amt = _money(rng, 1.0, 4000.0, n_cr)
    catalog_returns = {
        "cr_returned_date_sk":
            np.minimum(cs_dates_np[cret_idx] + rng.integers(1, 90, n_cr),
                       n_dates - 1).astype(np.int64),
        "cr_item_sk": cs_items_np[cret_idx].astype(np.int64),
        "cr_order_number": cs_orders_np[cret_idx].astype(np.int64),
        "cr_catalog_page_sk": rng.integers(0, n_cp, n_cr).astype(np.int64),
        "cr_returning_customer_sk": cs_custs_np[cret_idx].astype(np.int64),
        "cr_returning_addr_sk":
            rng.integers(0, n_cust, n_cr).astype(np.int64),
        "cr_call_center_sk": rng.integers(0, n_cc, n_cr).astype(np.int64),
        "cr_reason_sk": rng.integers(0, n_reason, n_cr).astype(np.int64),
        "cr_return_quantity": rng.integers(1, 50, n_cr).astype(np.int64),
        "cr_return_amount": cr_amt,
        "cr_refunded_cash":
            np.round(cr_amt * rng.uniform(0.5, 1.0, n_cr), 2),
        "cr_net_loss": np.round(cr_amt * rng.uniform(0.3, 1.0, n_cr), 2),
    }

    ww, wl, ws_p, wqty, wqf = sales_money(n_ws)
    w_ext = np.round(ws_p * wqf, 2)
    ws_date = rng.integers(0, n_dates, n_ws)
    web_sales = {
        "ws_sold_date_sk": ws_date.astype(np.int64),
        "ws_sold_time_sk": rng.integers(0, n_time, n_ws).astype(np.int64),
        "ws_ship_date_sk":
            np.minimum(ws_date + rng.integers(1, 120, n_ws),
                       n_dates - 1).astype(np.int64),
        "ws_item_sk": rng.integers(0, n_item, n_ws).astype(np.int64),
        "ws_bill_customer_sk":
            rng.integers(0, n_cust, n_ws).astype(np.int64),
        # ~8% null ship-customer fk (null-channel counts, q76 shape)
        "ws_ship_customer_sk": _nullable(
            rng.integers(0, n_cust, n_ws).astype(np.int64),
            rng.random(n_ws) < 0.08),
        "ws_ship_addr_sk": rng.integers(0, n_cust, n_ws).astype(np.int64),
        "ws_bill_hdemo_sk": rng.integers(0, n_hd, n_ws).astype(np.int64),
        "ws_web_page_sk": rng.integers(0, n_wp, n_ws).astype(np.int64),
        "ws_web_site_sk": rng.integers(0, n_site, n_ws).astype(np.int64),
        "ws_ship_mode_sk": rng.integers(0, n_sm, n_ws).astype(np.int64),
        "ws_warehouse_sk": rng.integers(0, n_wh, n_ws).astype(np.int64),
        "ws_promo_sk": rng.integers(0, n_promo, n_ws).astype(np.int64),
        "ws_order_number":
            rng.integers(0, max(n_ws // 4, 8), n_ws).astype(np.int64),
        "ws_quantity": wqty,
        "ws_wholesale_cost": ww,
        "ws_list_price": wl,
        "ws_sales_price": ws_p,
        "ws_ext_discount_amt": np.round((wl - ws_p) * wqf, 2),
        "ws_ext_sales_price": w_ext,
        "ws_ext_wholesale_cost": np.round(ww * wqf, 2),
        "ws_ext_list_price": np.round(wl * wqf, 2),
        "ws_ext_ship_cost": _money(rng, 0.0, 100.0, n_ws),
        "ws_net_paid": w_ext,
        "ws_net_profit": np.round(w_ext - np.round(ww * wqf, 2), 2),
    }

    # Web returns reference actual web sales rows (order + item line up).
    wret_idx = rng.integers(0, n_ws, n_wr)
    ws_dates_np = web_sales["ws_sold_date_sk"]
    ws_items_np = web_sales["ws_item_sk"]
    ws_orders_np = web_sales["ws_order_number"]
    ws_custs_np = web_sales["ws_bill_customer_sk"]
    wr_amt = _money(rng, 1.0, 4000.0, n_wr)
    web_returns = {
        "wr_returned_date_sk":
            np.minimum(ws_dates_np[wret_idx] + rng.integers(1, 90, n_wr),
                       n_dates - 1).astype(np.int64),
        "wr_item_sk": ws_items_np[wret_idx].astype(np.int64),
        "wr_order_number": ws_orders_np[wret_idx].astype(np.int64),
        "wr_returning_customer_sk": ws_custs_np[wret_idx].astype(np.int64),
        "wr_refunded_cdemo_sk":
            rng.integers(0, n_cd, n_wr).astype(np.int64),
        "wr_refunded_addr_sk":
            rng.integers(0, n_cust, n_wr).astype(np.int64),
        "wr_returning_cdemo_sk":
            rng.integers(0, n_cd, n_wr).astype(np.int64),
        "wr_web_page_sk": rng.integers(0, n_wp, n_wr).astype(np.int64),
        "wr_web_site_sk": rng.integers(0, n_site, n_wr).astype(np.int64),
        "wr_reason_sk": rng.integers(0, n_reason, n_wr).astype(np.int64),
        "wr_return_quantity": rng.integers(1, 50, n_wr).astype(np.int64),
        "wr_return_amt": wr_amt,
        "wr_fee": _money(rng, 0.5, 100.0, n_wr),
        "wr_refunded_cash":
            np.round(wr_amt * rng.uniform(0.5, 1.0, n_wr), 2),
        "wr_net_loss": np.round(wr_amt * rng.uniform(0.3, 1.0, n_wr), 2),
    }

    inventory = {
        "inv_date_sk": (rng.integers(0, n_dates // 7, n_inv) * 7
                        ).astype(np.int64),
        "inv_item_sk": rng.integers(0, n_item, n_inv).astype(np.int64),
        "inv_warehouse_sk": rng.integers(0, n_wh, n_inv).astype(np.int64),
        # same scale as sale quantities (1..100) so short-inventory
        # predicates (q72 inv < cs_quantity) select a real subset
        "inv_quantity_on_hand":
            rng.integers(0, 150, n_inv).astype(np.int64),
    }

    tables = {"date_dim": date_dim, "item": item, "store": store,
            "customer": customer, "customer_address": ca,
            "customer_demographics": cd, "household_demographics": hd,
            "promotion": promotion, "time_dim": time_dim,
            "web_site": web_site, "catalog_page": catalog_page,
            "income_band": income_band, "warehouse": warehouse,
            "ship_mode": ship_mode, "reason": reason,
            "call_center": call_center, "web_page": web_page,
            "inventory": inventory,
            "store_sales": store_sales, "store_returns": store_returns,
            "catalog_sales": catalog_sales,
            "catalog_returns": catalog_returns,
            "web_sales": web_sales, "web_returns": web_returns}
    return {name: _table(cols) for name, cols in tables.items()}


def load(session, tables: dict) -> dict:
    """Upload every table: ``{name: DataFrame}``. An uploaded table
    already lives on the device, so the reference's ``cache()`` has no
    counterpart."""
    return {name: session.create_dataframe(hb) for name, hb in tables.items()}


def _sum(e, name):
    return A.AggregateExpression(A.Sum(e), name)


def _avg(e, name):
    return A.AggregateExpression(A.Average(e), name)


def _cnt(name):
    return A.AggregateExpression(A.Count(), name)


def _eq(a, b):
    return P.EqualTo(a, b)


def _between(c, lo, hi):
    return P.And(P.GreaterThanOrEqual(c, lo), P.LessThanOrEqual(c, hi))

# ---------------------------------------------------------------------------
# Queries. Each docstring names the official query whose SHAPE it follows.
# ---------------------------------------------------------------------------


def q3(t):
    """Q3: brand revenue for a manufacturer in November, by year."""
    return (t["store_sales"]
            .join(t["date_dim"].where(_eq(col("d_moy"), lit(11))),
                  on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["item"].where(_between(col("i_manufact_id"), lit(20),
                                           lit(45))),
                  on=_eq(col("ss_item_sk"), col("i_item_sk")), how="inner")
            .group_by(col("d_year"), col("i_brand_id"), col("i_brand"))
            .agg(_sum(col("ss_ext_sales_price"), "sum_agg"))
            .sort(SortOrder(col("d_year")),
                  SortOrder(col("sum_agg"), ascending=False),
                  SortOrder(col("i_brand_id")))
            .limit(100))


def q5(t):
    """Q5 — BASELINE config 1's shape: per-channel sales/returns/profit
    rollup over a 14-day window, three hash-join + group-by legs unioned.
    (ROLLUP is expressed as the plain channel+id GROUP BY.)"""
    d = t["date_dim"].where(_between(col("d_date_sk"), lit(400), lit(413)))

    ss = (t["store_sales"]
          .select(col("ss_store_sk").alias("page_sk"),
                  col("ss_sold_date_sk").alias("date_sk"),
                  col("ss_ext_sales_price").alias("sales_price"),
                  col("ss_net_profit").alias("profit"),
                  Multiply(col("ss_ext_sales_price"),
                           lit(0.0)).alias("return_amt"),
                  Multiply(col("ss_net_profit"),
                           lit(0.0)).alias("net_loss")))
    sr = (t["store_returns"]
          .select(col("sr_store_sk").alias("page_sk"),
                  col("sr_returned_date_sk").alias("date_sk"),
                  Multiply(col("sr_return_amt"), lit(0.0)).alias(
                      "sales_price"),
                  Multiply(col("sr_net_loss"), lit(0.0)).alias("profit"),
                  col("sr_return_amt").alias("return_amt"),
                  col("sr_net_loss").alias("net_loss")))
    store_part = (ss.union(sr)
                  .join(d, on=_eq(col("date_sk"), col("d_date_sk")),
                        how="inner")
                  .join(t["store"],
                        on=_eq(col("page_sk"), col("s_store_sk")),
                        how="inner")
                  .group_by(col("s_store_id"))
                  .agg(_sum(col("sales_price"), "sales"),
                       _sum(col("return_amt"), "returns_"),
                       _sum(Subtract(col("profit"), col("net_loss")),
                            "profit"))
                  .with_column("channel", lit("store channel"))
                  .select(col("channel"), col("s_store_id").alias("id"),
                          col("sales"), col("returns_"), col("profit")))

    cs = (t["catalog_sales"]
          .select(col("cs_catalog_page_sk").alias("page_sk"),
                  col("cs_sold_date_sk").alias("date_sk"),
                  col("cs_ext_sales_price").alias("sales_price"),
                  col("cs_net_profit").alias("profit"),
                  Multiply(col("cs_ext_sales_price"),
                           lit(0.0)).alias("return_amt"),
                  Multiply(col("cs_net_profit"),
                           lit(0.0)).alias("net_loss")))
    cr = (t["catalog_returns"]
          .select(col("cr_catalog_page_sk").alias("page_sk"),
                  col("cr_returned_date_sk").alias("date_sk"),
                  Multiply(col("cr_return_amount"), lit(0.0)).alias(
                      "sales_price"),
                  Multiply(col("cr_net_loss"), lit(0.0)).alias("profit"),
                  col("cr_return_amount").alias("return_amt"),
                  col("cr_net_loss").alias("net_loss")))
    catalog_part = (cs.union(cr)
                    .join(d, on=_eq(col("date_sk"), col("d_date_sk")),
                          how="inner")
                    .join(t["catalog_page"],
                          on=_eq(col("page_sk"),
                                 col("cp_catalog_page_sk")), how="inner")
                    .group_by(col("cp_catalog_page_id"))
                    .agg(_sum(col("sales_price"), "sales"),
                         _sum(col("return_amt"), "returns_"),
                         _sum(Subtract(col("profit"), col("net_loss")),
                              "profit"))
                    .with_column("channel", lit("catalog channel"))
                    .select(col("channel"),
                            col("cp_catalog_page_id").alias("id"),
                            col("sales"), col("returns_"), col("profit")))

    ws = (t["web_sales"]
          .select(col("ws_web_site_sk").alias("page_sk"),
                  col("ws_sold_date_sk").alias("date_sk"),
                  col("ws_ext_sales_price").alias("sales_price"),
                  col("ws_net_profit").alias("profit"),
                  Multiply(col("ws_ext_sales_price"),
                           lit(0.0)).alias("return_amt"),
                  Multiply(col("ws_net_profit"),
                           lit(0.0)).alias("net_loss")))
    wr = (t["web_returns"]
          .select(col("wr_web_site_sk").alias("page_sk"),
                  col("wr_returned_date_sk").alias("date_sk"),
                  Multiply(col("wr_return_amt"), lit(0.0)).alias(
                      "sales_price"),
                  Multiply(col("wr_net_loss"), lit(0.0)).alias("profit"),
                  col("wr_return_amt").alias("return_amt"),
                  col("wr_net_loss").alias("net_loss")))
    web_part = (ws.union(wr)
                .join(d, on=_eq(col("date_sk"), col("d_date_sk")),
                      how="inner")
                .join(t["web_site"],
                      on=_eq(col("page_sk"), col("web_site_sk")),
                      how="inner")
                .group_by(col("web_site_id"))
                .agg(_sum(col("sales_price"), "sales"),
                     _sum(col("return_amt"), "returns_"),
                     _sum(Subtract(col("profit"), col("net_loss")),
                          "profit"))
                .with_column("channel", lit("web channel"))
                .select(col("channel"), col("web_site_id").alias("id"),
                        col("sales"), col("returns_"), col("profit")))

    return (store_part.union(catalog_part).union(web_part)
            .sort(SortOrder(col("channel")), SortOrder(col("id")))
            .limit(100))


def q6(t):
    """Q6: customer states buying items priced at >1.2x their category
    average (correlated avg subquery -> per-category aggregate join)."""
    avg_cat = (t["item"]
               .group_by(col("i_category_id"))
               .agg(_avg(col("i_current_price"), "cat_avg"))
               .select(col("i_category_id").alias("ac_cat"),
                       col("cat_avg")))
    d = t["date_dim"].where(_between(col("d_month_seq"), lit(12), lit(18)))
    return (t["customer_address"]
            .join(t["customer"],
                  on=_eq(col("ca_address_sk"), col("c_current_addr_sk")),
                  how="inner")
            .join(t["store_sales"],
                  on=_eq(col("c_customer_sk"), col("ss_customer_sk")),
                  how="inner")
            .join(d, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["item"],
                  on=_eq(col("ss_item_sk"), col("i_item_sk")), how="inner")
            .join(avg_cat,
                  on=_eq(col("i_category_id"), col("ac_cat")), how="inner")
            .where(P.GreaterThan(col("i_current_price"),
                                 Multiply(lit(1.2), col("cat_avg"))))
            .group_by(col("ca_state"))
            .agg(_cnt("cnt"))
            .where(P.GreaterThanOrEqual(col("cnt"), lit(3)))
            .sort(SortOrder(col("cnt")), SortOrder(col("ca_state")))
            .limit(100))


def q7(t):
    """Q7: demographics + promotion gated averages per item."""
    cd = t["customer_demographics"].where(P.And(
        _eq(col("cd_gender"), lit("F")),
        P.And(_eq(col("cd_marital_status"), lit("W")),
              _eq(col("cd_education_status"), lit("Primary")))))
    promo = t["promotion"].where(
        P.Or(_eq(col("p_channel_email"), lit("N")),
             _eq(col("p_channel_event"), lit("N"))))
    d = t["date_dim"].where(_eq(col("d_year"), lit(1998)))
    return (t["store_sales"]
            .join(cd, on=_eq(col("ss_cdemo_sk"), col("cd_demo_sk")),
                  how="inner")
            .join(d, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["item"], on=_eq(col("ss_item_sk"), col("i_item_sk")),
                  how="inner")
            .join(promo, on=_eq(col("ss_promo_sk"), col("p_promo_sk")),
                  how="inner")
            .group_by(col("i_item_id"))
            .agg(_avg(col("ss_quantity"), "agg1"),
                 _avg(col("ss_list_price"), "agg2"),
                 _avg(col("ss_coupon_amt"), "agg3"),
                 _avg(col("ss_sales_price"), "agg4"))
            .sort(SortOrder(col("i_item_id")))
            .limit(100))


def q13(t):
    """Q13: averages under a 3-way demographic/price disjunction and a
    3-way state/profit disjunction."""
    cd_ok = P.Or(
        P.And(_eq(col("cd_marital_status"), lit("M")),
              P.And(_eq(col("cd_education_status"), lit("College")),
                    _between(col("ss_sales_price"), lit(10.0),
                             lit(60.0)))),
        P.Or(
            P.And(_eq(col("cd_marital_status"), lit("S")),
                  P.And(_eq(col("cd_education_status"), lit("Primary")),
                        _between(col("ss_sales_price"), lit(20.0),
                                 lit(80.0)))),
            P.And(_eq(col("cd_marital_status"), lit("W")),
                  P.And(_eq(col("cd_education_status"), lit("2 yr Degree")),
                        _between(col("ss_sales_price"), lit(30.0),
                                 lit(100.0))))))
    ca_ok = P.Or(
        P.And(P.In(col("ca_state"), ["CA", "GA", "TX"]),
              _between(col("ss_net_profit"), lit(0.0), lit(2000.0))),
        P.Or(
            P.And(P.In(col("ca_state"), ["AL", "KY", "MN"]),
                  _between(col("ss_net_profit"), lit(150.0), lit(3000.0))),
            P.And(P.In(col("ca_state"), ["NC", "OH", "VA"]),
                  _between(col("ss_net_profit"), lit(50.0), lit(25000.0)))))
    return (t["store_sales"]
            .join(t["store"], on=_eq(col("ss_store_sk"), col("s_store_sk")),
                  how="inner")
            .join(t["customer_demographics"],
                  on=_eq(col("ss_cdemo_sk"), col("cd_demo_sk")),
                  how="inner")
            .join(t["customer_address"],
                  on=_eq(col("ss_addr_sk"), col("ca_address_sk")),
                  how="inner")
            .join(t["date_dim"].where(_eq(col("d_year"), lit(2001))),
                  on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .where(P.And(cd_ok, ca_ok))
            .group_by()
            .agg(_avg(col("ss_quantity"), "avg_qty"),
                 _avg(col("ss_ext_sales_price"), "avg_sales"),
                 _avg(col("ss_ext_wholesale_cost"), "avg_cost"),
                 _sum(col("ss_ext_wholesale_cost"), "sum_cost")))


def q15(t):
    """Q15: catalog sales by customer zip with a zip/state/price
    disjunction."""
    zip2 = Substring(col("ca_zip"), lit(1), lit(2))
    return (t["catalog_sales"]
            .join(t["customer"],
                  on=_eq(col("cs_bill_customer_sk"), col("c_customer_sk")),
                  how="inner")
            .join(t["customer_address"],
                  on=_eq(col("c_current_addr_sk"), col("ca_address_sk")),
                  how="inner")
            .join(t["date_dim"].where(P.And(_eq(col("d_qoy"), lit(2)),
                                            _eq(col("d_year"), lit(2000)))),
                  on=_eq(col("cs_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .where(P.Or(P.In(zip2, ["85", "86", "88"]),
                        P.Or(P.In(col("ca_state"), ["CA", "WA", "GA"]),
                             P.GreaterThan(col("cs_sales_price"),
                                           lit(500.0)))))
            .group_by(col("ca_zip"))
            .agg(_sum(col("cs_sales_price"), "sum_sales"))
            .sort(SortOrder(col("ca_zip")))
            .limit(100))


def q19(t):
    """Q19: brand revenue where customer and store zips differ."""
    return (t["store_sales"]
            .join(t["date_dim"].where(P.And(_eq(col("d_moy"), lit(11)),
                                            _eq(col("d_year"), lit(1999)))),
                  on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["item"].where(_between(col("i_manager_id"), lit(1),
                                           lit(30))),
                  on=_eq(col("ss_item_sk"), col("i_item_sk")), how="inner")
            .join(t["customer"],
                  on=_eq(col("ss_customer_sk"), col("c_customer_sk")),
                  how="inner")
            .join(t["customer_address"],
                  on=_eq(col("c_current_addr_sk"), col("ca_address_sk")),
                  how="inner")
            .join(t["store"],
                  on=_eq(col("ss_store_sk"), col("s_store_sk")),
                  how="inner")
            .where(P.NotEqual(Substring(col("ca_zip"), lit(1), lit(5)),
                              Substring(col("s_zip"), lit(1), lit(5))))
            .group_by(col("i_brand_id"), col("i_brand"),
                      col("i_manufact_id"))
            .agg(_sum(col("ss_ext_sales_price"), "ext_price"))
            .sort(SortOrder(col("ext_price"), ascending=False),
                  SortOrder(col("i_brand_id")),
                  SortOrder(col("i_manufact_id")))
            .limit(100))


def q25(t):
    """Q25: store sale -> later store return -> later catalog re-purchase
    chain, profit sums per item/store."""
    d1 = (t["date_dim"].where(P.And(_eq(col("d_moy"), lit(4)),
                                    _eq(col("d_year"), lit(2000))))
          .select(col("d_date_sk").alias("d1_sk")))
    d2 = (t["date_dim"].where(P.And(_between(col("d_moy"), lit(4), lit(10)),
                                    _eq(col("d_year"), lit(2000))))
          .select(col("d_date_sk").alias("d2_sk")))
    d3 = (t["date_dim"].where(P.And(_between(col("d_moy"), lit(4), lit(10)),
                                    _eq(col("d_year"), lit(2000))))
          .select(col("d_date_sk").alias("d3_sk")))
    return (t["store_sales"]
            .join(t["store_returns"],
                  on=P.And(_eq(col("ss_customer_sk"),
                               col("sr_customer_sk")),
                           P.And(_eq(col("ss_item_sk"), col("sr_item_sk")),
                                 _eq(col("ss_ticket_number"),
                                     col("sr_ticket_number")))),
                  how="inner")
            .join(t["catalog_sales"],
                  on=P.And(_eq(col("sr_customer_sk"),
                               col("cs_bill_customer_sk")),
                           _eq(col("sr_item_sk"), col("cs_item_sk"))),
                  how="inner")
            .join(d1, on=_eq(col("ss_sold_date_sk"), col("d1_sk")),
                  how="inner")
            .join(d2, on=_eq(col("sr_returned_date_sk"), col("d2_sk")),
                  how="inner")
            .join(d3, on=_eq(col("cs_sold_date_sk"), col("d3_sk")),
                  how="inner")
            .join(t["store"], on=_eq(col("ss_store_sk"), col("s_store_sk")),
                  how="inner")
            .join(t["item"], on=_eq(col("ss_item_sk"), col("i_item_sk")),
                  how="inner")
            .group_by(col("i_item_id"), col("i_item_sk"),
                      col("s_store_id"), col("s_store_name"))
            .agg(_sum(col("ss_net_profit"), "store_sales_profit"),
                 _sum(col("sr_net_loss"), "store_returns_loss"),
                 _sum(col("cs_net_profit"), "catalog_sales_profit"))
            .sort(SortOrder(col("i_item_id")), SortOrder(col("i_item_sk")),
                  SortOrder(col("s_store_id")),
                  SortOrder(col("s_store_name")))
            .limit(100))


def q26(t):
    """Q26: catalog analog of Q7."""
    cd = t["customer_demographics"].where(P.And(
        _eq(col("cd_gender"), lit("M")),
        P.And(_eq(col("cd_marital_status"), lit("S")),
              _eq(col("cd_education_status"), lit("College")))))
    promo = t["promotion"].where(
        P.Or(_eq(col("p_channel_email"), lit("N")),
             _eq(col("p_channel_event"), lit("N"))))
    d = t["date_dim"].where(_eq(col("d_year"), lit(2000)))
    return (t["catalog_sales"]
            .join(cd, on=_eq(col("cs_bill_cdemo_sk"), col("cd_demo_sk")),
                  how="inner")
            .join(d, on=_eq(col("cs_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["item"], on=_eq(col("cs_item_sk"), col("i_item_sk")),
                  how="inner")
            .join(promo, on=_eq(col("cs_promo_sk"), col("p_promo_sk")),
                  how="inner")
            .group_by(col("i_item_id"))
            .agg(_avg(col("cs_quantity"), "agg1"),
                 _avg(col("cs_list_price"), "agg2"),
                 _avg(col("cs_coupon_amt"), "agg3"),
                 _avg(col("cs_sales_price"), "agg4"))
            .sort(SortOrder(col("i_item_id")))
            .limit(100))


def q27(t):
    """Q27: store-state averages under a demographic gate (ROLLUP as plain
    GROUP BY item/state)."""
    cd = t["customer_demographics"].where(P.And(
        _eq(col("cd_gender"), lit("F")),
        P.And(_eq(col("cd_marital_status"), lit("D")),
              _eq(col("cd_education_status"), lit("Secondary")))))
    return (t["store_sales"]
            .join(cd, on=_eq(col("ss_cdemo_sk"), col("cd_demo_sk")),
                  how="inner")
            .join(t["date_dim"].where(_eq(col("d_year"), lit(1999))),
                  on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["store"].where(P.In(col("s_state"),
                                        ["CA", "TX", "OH", "WA"])),
                  on=_eq(col("ss_store_sk"), col("s_store_sk")),
                  how="inner")
            .join(t["item"], on=_eq(col("ss_item_sk"), col("i_item_sk")),
                  how="inner")
            .group_by(col("i_item_id"), col("s_state"))
            .agg(_avg(col("ss_quantity"), "agg1"),
                 _avg(col("ss_list_price"), "agg2"),
                 _avg(col("ss_coupon_amt"), "agg3"),
                 _avg(col("ss_sales_price"), "agg4"))
            .sort(SortOrder(col("i_item_id")), SortOrder(col("s_state")))
            .limit(100))


def q29(t):
    """Q29: like Q25 but quantity sums."""
    d1 = (t["date_dim"].where(P.And(_eq(col("d_moy"), lit(9)),
                                    _eq(col("d_year"), lit(1999))))
          .select(col("d_date_sk").alias("d1_sk")))
    d2 = (t["date_dim"].where(P.And(_between(col("d_moy"), lit(9),
                                             lit(12)),
                                    _eq(col("d_year"), lit(1999))))
          .select(col("d_date_sk").alias("d2_sk")))
    d3 = (t["date_dim"].where(P.In(col("d_year"), [1999, 2000, 2001]))
          .select(col("d_date_sk").alias("d3_sk")))
    return (t["store_sales"]
            .join(t["store_returns"],
                  on=P.And(_eq(col("ss_customer_sk"),
                               col("sr_customer_sk")),
                           P.And(_eq(col("ss_item_sk"), col("sr_item_sk")),
                                 _eq(col("ss_ticket_number"),
                                     col("sr_ticket_number")))),
                  how="inner")
            .join(t["catalog_sales"],
                  on=P.And(_eq(col("sr_customer_sk"),
                               col("cs_bill_customer_sk")),
                           _eq(col("sr_item_sk"), col("cs_item_sk"))),
                  how="inner")
            .join(d1, on=_eq(col("ss_sold_date_sk"), col("d1_sk")),
                  how="inner")
            .join(d2, on=_eq(col("sr_returned_date_sk"), col("d2_sk")),
                  how="inner")
            .join(d3, on=_eq(col("cs_sold_date_sk"), col("d3_sk")),
                  how="inner")
            .join(t["store"], on=_eq(col("ss_store_sk"), col("s_store_sk")),
                  how="inner")
            .join(t["item"], on=_eq(col("ss_item_sk"), col("i_item_sk")),
                  how="inner")
            .group_by(col("i_item_id"), col("i_item_sk"),
                      col("s_store_id"), col("s_store_name"))
            .agg(_sum(col("ss_quantity"), "store_sales_quantity"),
                 _sum(col("sr_return_quantity"), "store_returns_quantity"),
                 _sum(col("cs_quantity"), "catalog_sales_quantity"))
            .sort(SortOrder(col("i_item_id")), SortOrder(col("i_item_sk")),
                  SortOrder(col("s_store_id")),
                  SortOrder(col("s_store_name")))
            .limit(100))


def q34(t):
    """Q34: tickets with a between-bound item count per customer
    (HAVING via aggregate-then-filter), joined back to customer."""
    d = t["date_dim"].where(P.And(
        P.Or(_between(col("d_dom"), lit(1), lit(3)),
             _between(col("d_dom"), lit(25), lit(28))),
        P.In(col("d_year"), [1999, 2000, 2001])))
    hd = t["household_demographics"].where(P.And(
        P.Or(_eq(col("hd_buy_potential"), lit(">10000")),
             _eq(col("hd_buy_potential"), lit("Unknown"))),
        P.GreaterThan(col("hd_vehicle_count"), lit(0))))
    tickets = (t["store_sales"]
               .join(d, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                     how="inner")
               .join(t["store"].where(P.In(col("s_state"),
                                           ["CA", "TX", "OH", "WA"])),
                     on=_eq(col("ss_store_sk"), col("s_store_sk")),
                     how="inner")
               .join(hd, on=_eq(col("ss_hdemo_sk"), col("hd_demo_sk")),
                     how="inner")
               .group_by(col("ss_ticket_number"), col("ss_customer_sk"))
               .agg(_cnt("cnt"))
               .where(_between(col("cnt"), lit(1), lit(20))))
    return (tickets
            .join(t["customer"],
                  on=_eq(col("ss_customer_sk"), col("c_customer_sk")),
                  how="inner")
            .select(col("c_last_name"), col("c_first_name"),
                    col("ss_ticket_number"), col("cnt"))
            .sort(SortOrder(col("c_last_name")),
                  SortOrder(col("c_first_name")),
                  SortOrder(col("cnt"), ascending=False),
                  SortOrder(col("ss_ticket_number")))
            .limit(100))


def q42(t):
    """Q42: category revenue for one month/year."""
    return (t["store_sales"]
            .join(t["date_dim"].where(P.And(_eq(col("d_moy"), lit(11)),
                                            _eq(col("d_year"), lit(2000)))),
                  on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["item"], on=_eq(col("ss_item_sk"), col("i_item_sk")),
                  how="inner")
            .group_by(col("d_year"), col("i_category_id"),
                      col("i_category"))
            .agg(_sum(col("ss_ext_sales_price"), "total_sales"))
            .sort(SortOrder(col("total_sales"), ascending=False),
                  SortOrder(col("d_year")), SortOrder(col("i_category_id")),
                  SortOrder(col("i_category")))
            .limit(100))


def q46(t):
    """Q46: per-ticket coupon/profit for weekend city shoppers whose
    current city differs from the bought city."""
    hd = t["household_demographics"].where(
        P.Or(_eq(col("hd_dep_count"), lit(4)),
             _eq(col("hd_vehicle_count"), lit(3))))
    d = t["date_dim"].where(P.And(
        P.In(col("d_day_name"), ["Saturday", "Sunday"]),
        P.In(col("d_year"), [1999, 2000, 2001])))
    tickets = (t["store_sales"]
               .join(d, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                     how="inner")
               .join(t["store"].where(P.In(col("s_city"),
                                           ["Fairview", "Midway"])),
                     on=_eq(col("ss_store_sk"), col("s_store_sk")),
                     how="inner")
               .join(hd, on=_eq(col("ss_hdemo_sk"), col("hd_demo_sk")),
                     how="inner")
               .join(t["customer_address"]
                     .select(col("ca_address_sk").alias("bought_addr_sk"),
                             col("ca_city").alias("bought_city")),
                     on=_eq(col("ss_addr_sk"), col("bought_addr_sk")),
                     how="inner")
               .group_by(col("ss_ticket_number"), col("ss_customer_sk"),
                         col("bought_city"))
               .agg(_sum(col("ss_coupon_amt"), "amt"),
                    _sum(col("ss_net_profit"), "profit")))
    return (tickets
            .join(t["customer"],
                  on=_eq(col("ss_customer_sk"), col("c_customer_sk")),
                  how="inner")
            .join(t["customer_address"],
                  on=_eq(col("c_current_addr_sk"), col("ca_address_sk")),
                  how="inner")
            .where(P.NotEqual(col("ca_city"), col("bought_city")))
            .select(col("c_last_name"), col("c_first_name"),
                    col("ca_city"), col("bought_city"),
                    col("ss_ticket_number"), col("amt"), col("profit"))
            .sort(SortOrder(col("c_last_name")),
                  SortOrder(col("c_first_name")),
                  SortOrder(col("ca_city")), SortOrder(col("bought_city")),
                  SortOrder(col("ss_ticket_number")))
            .limit(100))


def q48(t):
    """Q48: quantity sum under demographic/price and state/profit
    disjunctions (Q13's cousin without the store group)."""
    cd_ok = P.Or(
        P.And(_eq(col("cd_marital_status"), lit("M")),
              P.And(_eq(col("cd_education_status"), lit("4 yr Degree")),
                    _between(col("ss_sales_price"), lit(10.0),
                             lit(60.0)))),
        P.Or(
            P.And(_eq(col("cd_marital_status"), lit("D")),
                  P.And(_eq(col("cd_education_status"), lit("Secondary")),
                        _between(col("ss_sales_price"), lit(20.0),
                                 lit(80.0)))),
            P.And(_eq(col("cd_marital_status"), lit("S")),
                  P.And(_eq(col("cd_education_status"), lit("College")),
                        _between(col("ss_sales_price"), lit(30.0),
                                 lit(100.0))))))
    ca_ok = P.Or(
        P.And(P.In(col("ca_state"), ["CA", "GA", "TX"]),
              _between(col("ss_net_profit"), lit(0.0), lit(2000.0))),
        P.Or(
            P.And(P.In(col("ca_state"), ["AL", "KY", "MN"]),
                  _between(col("ss_net_profit"), lit(150.0), lit(3000.0))),
            P.And(P.In(col("ca_state"), ["NC", "OH", "VA"]),
                  _between(col("ss_net_profit"), lit(50.0),
                           lit(25000.0)))))
    return (t["store_sales"]
            .join(t["store"], on=_eq(col("ss_store_sk"), col("s_store_sk")),
                  how="inner")
            .join(t["customer_demographics"],
                  on=_eq(col("ss_cdemo_sk"), col("cd_demo_sk")),
                  how="inner")
            .join(t["customer_address"],
                  on=_eq(col("ss_addr_sk"), col("ca_address_sk")),
                  how="inner")
            .join(t["date_dim"].where(_eq(col("d_year"), lit(1999))),
                  on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .where(P.And(cd_ok, ca_ok))
            .group_by()
            .agg(_sum(col("ss_quantity"), "total_qty")))


def q52(t):
    """Q52: brand revenue for one month/year (Q42 by brand)."""
    return (t["store_sales"]
            .join(t["date_dim"].where(P.And(_eq(col("d_moy"), lit(12)),
                                            _eq(col("d_year"), lit(1998)))),
                  on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["item"], on=_eq(col("ss_item_sk"), col("i_item_sk")),
                  how="inner")
            .group_by(col("d_year"), col("i_brand_id"), col("i_brand"))
            .agg(_sum(col("ss_ext_sales_price"), "ext_price"))
            .sort(SortOrder(col("d_year")),
                  SortOrder(col("ext_price"), ascending=False),
                  SortOrder(col("i_brand_id")))
            .limit(100))


def q55(t):
    """Q55: brand revenue for one manager band in one month."""
    return (t["store_sales"]
            .join(t["date_dim"].where(P.And(_eq(col("d_moy"), lit(11)),
                                            _eq(col("d_year"), lit(1999)))),
                  on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["item"].where(_between(col("i_manager_id"), lit(28),
                                           lit(35))),
                  on=_eq(col("ss_item_sk"), col("i_item_sk")), how="inner")
            .group_by(col("i_brand_id"), col("i_brand"))
            .agg(_sum(col("ss_ext_sales_price"), "ext_price"))
            .sort(SortOrder(col("ext_price"), ascending=False),
                  SortOrder(col("i_brand_id")))
            .limit(100))


def q59(t):
    """Q59: week-over-week store sales ratios — day-name conditional sums
    per store/week, self-joined 52 weeks apart."""
    def day_sum(day, name):
        return _sum(If(_eq(col("d_day_name"), lit(day)),
                       col("ss_sales_price"), lit(0.0)), name)

    wss = (t["store_sales"]
           .join(t["date_dim"],
                 on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                 how="inner")
           .group_by(col("d_week_seq"), col("ss_store_sk"))
           .agg(day_sum("Sunday", "sun_sales"),
                day_sum("Monday", "mon_sales"),
                day_sum("Tuesday", "tue_sales"),
                day_sum("Wednesday", "wed_sales"),
                day_sum("Thursday", "thu_sales"),
                day_sum("Friday", "fri_sales"),
                day_sum("Saturday", "sat_sales")))
    y1 = (wss.where(_between(col("d_week_seq"), lit(1462), lit(1487)))
          .select(col("d_week_seq").alias("week1"),
                  col("ss_store_sk").alias("store1"),
                  col("sun_sales").alias("sun1"),
                  col("mon_sales").alias("mon1"),
                  col("tue_sales").alias("tue1"),
                  col("wed_sales").alias("wed1"),
                  col("thu_sales").alias("thu1"),
                  col("fri_sales").alias("fri1"),
                  col("sat_sales").alias("sat1")))
    y2 = (wss.where(_between(col("d_week_seq"), lit(1514), lit(1539)))
          .select(Subtract(col("d_week_seq"), lit(52)).alias("week2"),
                  col("ss_store_sk").alias("store2"),
                  col("sun_sales").alias("sun2"),
                  col("mon_sales").alias("mon2"),
                  col("tue_sales").alias("tue2"),
                  col("wed_sales").alias("wed2"),
                  col("thu_sales").alias("thu2"),
                  col("fri_sales").alias("fri2"),
                  col("sat_sales").alias("sat2")))
    return (y1.join(y2, on=P.And(_eq(col("store1"), col("store2")),
                                 _eq(col("week1"), col("week2"))),
                    how="inner")
            .join(t["store"], on=_eq(col("store1"), col("s_store_sk")),
                  how="inner")
            .select(col("s_store_name"), col("week1"),
                    Divide(col("sun1"), col("sun2")).alias("r_sun"),
                    Divide(col("mon1"), col("mon2")).alias("r_mon"),
                    Divide(col("tue1"), col("tue2")).alias("r_tue"),
                    Divide(col("wed1"), col("wed2")).alias("r_wed"),
                    Divide(col("thu1"), col("thu2")).alias("r_thu"),
                    Divide(col("fri1"), col("fri2")).alias("r_fri"),
                    Divide(col("sat1"), col("sat2")).alias("r_sat"))
            .sort(SortOrder(col("s_store_name")), SortOrder(col("week1")))
            .limit(100))


def q61(t):
    """Q61: promotional vs total revenue ratio (two scalar aggregates
    cross-joined)."""
    base = (t["store_sales"]
            .join(t["store"].where(_eq(col("s_gmt_offset"), lit(-5.0))),
                  on=_eq(col("ss_store_sk"), col("s_store_sk")),
                  how="inner")
            .join(t["date_dim"].where(P.And(_eq(col("d_year"), lit(1998)),
                                            _eq(col("d_moy"), lit(11)))),
                  on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["item"].where(_eq(col("i_category"), lit("Jewelry"))),
                  on=_eq(col("ss_item_sk"), col("i_item_sk")), how="inner")
            .join(t["customer"],
                  on=_eq(col("ss_customer_sk"), col("c_customer_sk")),
                  how="inner")
            .join(t["customer_address"].where(_eq(col("ca_gmt_offset"),
                                                  lit(-5.0))),
                  on=_eq(col("c_current_addr_sk"), col("ca_address_sk")),
                  how="inner"))
    promo = (base
             .join(t["promotion"].where(
                 P.Or(_eq(col("p_channel_dmail"), lit("Y")),
                      P.Or(_eq(col("p_channel_email"), lit("Y")),
                           _eq(col("p_channel_event"), lit("Y"))))),
                 on=_eq(col("ss_promo_sk"), col("p_promo_sk")),
                 how="inner")
             .group_by()
             .agg(_sum(col("ss_ext_sales_price"), "promotions")))
    total = base.group_by().agg(_sum(col("ss_ext_sales_price"), "total"))
    return (promo.cross_join(total)
            .select(col("promotions"), col("total"),
                    Multiply(Divide(col("promotions"), col("total")),
                             lit(100.0)).alias("pct")))


def q65(t):
    """Q65: store items whose revenue is at most 10% of the store's
    average item revenue (two-level aggregate join)."""
    sc = (t["store_sales"]
          .join(t["date_dim"].where(_between(col("d_month_seq"), lit(24),
                                             lit(35))),
                on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                how="inner")
          .group_by(col("ss_store_sk"), col("ss_item_sk"))
          .agg(_sum(col("ss_sales_price"), "revenue")))
    sb = (sc.group_by(col("ss_store_sk"))
          .agg(_avg(col("revenue"), "ave"))
          .select(col("ss_store_sk").alias("sb_store_sk"), col("ave")))
    return (sc
            .join(sb, on=_eq(col("ss_store_sk"), col("sb_store_sk")),
                  how="inner")
            .where(P.LessThanOrEqual(col("revenue"),
                                     Multiply(lit(0.1), col("ave"))))
            .join(t["store"], on=_eq(col("ss_store_sk"), col("s_store_sk")),
                  how="inner")
            .join(t["item"], on=_eq(col("ss_item_sk"), col("i_item_sk")),
                  how="inner")
            .select(col("s_store_name"), col("i_item_id"), col("revenue"),
                    col("ave"))
            .sort(SortOrder(col("s_store_name")),
                  SortOrder(col("i_item_id")))
            .limit(100))


def q68(t):
    """Q68: Q46 variant summing ext sales/list prices."""
    hd = t["household_demographics"].where(
        P.Or(_eq(col("hd_dep_count"), lit(2)),
             _eq(col("hd_vehicle_count"), lit(1))))
    d = t["date_dim"].where(P.And(
        _between(col("d_dom"), lit(1), lit(2)),
        P.In(col("d_year"), [1998, 1999, 2000])))
    tickets = (t["store_sales"]
               .join(d, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                     how="inner")
               .join(t["store"].where(P.In(col("s_city"),
                                           ["Centerville", "Oak Grove"])),
                     on=_eq(col("ss_store_sk"), col("s_store_sk")),
                     how="inner")
               .join(hd, on=_eq(col("ss_hdemo_sk"), col("hd_demo_sk")),
                     how="inner")
               .join(t["customer_address"]
                     .select(col("ca_address_sk").alias("bought_addr_sk"),
                             col("ca_city").alias("bought_city")),
                     on=_eq(col("ss_addr_sk"), col("bought_addr_sk")),
                     how="inner")
               .group_by(col("ss_ticket_number"), col("ss_customer_sk"),
                         col("bought_city"))
               .agg(_sum(col("ss_ext_sales_price"), "extended_price"),
                    _sum(col("ss_ext_list_price"), "list_price"),
                    _sum(col("ss_ext_discount_amt"), "extended_tax")))
    return (tickets
            .join(t["customer"],
                  on=_eq(col("ss_customer_sk"), col("c_customer_sk")),
                  how="inner")
            .join(t["customer_address"],
                  on=_eq(col("c_current_addr_sk"), col("ca_address_sk")),
                  how="inner")
            .where(P.NotEqual(col("ca_city"), col("bought_city")))
            .select(col("c_last_name"), col("c_first_name"),
                    col("ca_city"), col("bought_city"),
                    col("ss_ticket_number"), col("extended_price"),
                    col("extended_tax"), col("list_price"))
            .sort(SortOrder(col("c_last_name")),
                  SortOrder(col("ss_ticket_number")))
            .limit(100))


def q79(t):
    """Q79: Monday shoppers' per-ticket profit in big stores."""
    hd = t["household_demographics"].where(
        P.Or(_eq(col("hd_dep_count"), lit(6)),
             P.GreaterThan(col("hd_vehicle_count"), lit(2))))
    d = t["date_dim"].where(P.And(
        _eq(col("d_day_name"), lit("Monday")),
        P.In(col("d_year"), [1998, 1999, 2000])))
    tickets = (t["store_sales"]
               .join(d, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                     how="inner")
               .join(t["store"],
                     on=_eq(col("ss_store_sk"), col("s_store_sk")),
                     how="inner")
               .join(hd, on=_eq(col("ss_hdemo_sk"), col("hd_demo_sk")),
                     how="inner")
               .group_by(col("ss_ticket_number"), col("ss_customer_sk"),
                         col("s_city"))
               .agg(_sum(col("ss_coupon_amt"), "amt"),
                    _sum(col("ss_net_profit"), "profit")))
    return (tickets
            .join(t["customer"],
                  on=_eq(col("ss_customer_sk"), col("c_customer_sk")),
                  how="inner")
            .select(col("c_last_name"), col("c_first_name"),
                    Substring(col("s_city"), lit(1), lit(30)).alias(
                        "city30"),
                    col("ss_ticket_number"), col("amt"), col("profit"))
            .sort(SortOrder(col("c_last_name")),
                  SortOrder(col("c_first_name")),
                  SortOrder(col("city30")),
                  SortOrder(col("profit")),
                  SortOrder(col("ss_ticket_number")))
            .limit(100))


def q96(t):
    """Q96: count of evening store sales for a dep-count demographic."""
    return (t["store_sales"]
            .join(t["household_demographics"].where(
                _eq(col("hd_dep_count"), lit(7))),
                on=_eq(col("ss_hdemo_sk"), col("hd_demo_sk")), how="inner")
            .join(t["time_dim"].where(P.And(_eq(col("t_hour"), lit(20)),
                                            P.GreaterThanOrEqual(
                                                col("t_minute"), lit(30)))),
                  on=_eq(col("ss_sold_time_sk"), col("t_time_sk")),
                  how="inner")
            .join(t["store"], on=_eq(col("ss_store_sk"), col("s_store_sk")),
                  how="inner")
            .group_by()
            .agg(_cnt("cnt")))


def q98(t):
    """Q98: item revenue with its share of the class total — a window
    partition sum over the aggregate."""
    agg = (t["store_sales"]
           .join(t["date_dim"].where(_between(col("d_date_sk"), lit(760),
                                              lit(790))),
                 on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                 how="inner")
           .join(t["item"].where(P.In(col("i_category"),
                                      ["Sports", "Books", "Home"])),
                 on=_eq(col("ss_item_sk"), col("i_item_sk")), how="inner")
           .group_by(col("i_item_id"), col("i_category"), col("i_class"),
                     col("i_current_price"))
           .agg(_sum(col("ss_ext_sales_price"), "itemrevenue")))
    w = Window.partition_by("i_class")
    return (agg
            .with_column("classrevenue", over(A.Sum(col("itemrevenue")), w))
            .with_column("revenueratio",
                         Divide(Multiply(col("itemrevenue"), lit(100.0)),
                                col("classrevenue")))
            .select(col("i_item_id"), col("i_category"), col("i_class"),
                    col("i_current_price"), col("itemrevenue"),
                    col("revenueratio"))
            .sort(SortOrder(col("i_category")), SortOrder(col("i_class")),
                  SortOrder(col("i_item_id")),
                  SortOrder(col("revenueratio")))
            .limit(100))


def q1(t):
    """Q1: customers whose store returns exceed 1.2x their store's average
    (correlated avg subquery -> per-store aggregate join)."""
    d = t["date_dim"].where(_eq(col("d_year"), lit(2000)))
    ctr = (t["store_returns"]
           .join(d, on=_eq(col("sr_returned_date_sk"), col("d_date_sk")),
                 how="inner")
           .group_by(col("sr_customer_sk"), col("sr_store_sk"))
           .agg(_sum(col("sr_return_amt"), "ctr_total"))
           .select(col("sr_customer_sk").alias("ctr_customer_sk"),
                   col("sr_store_sk").alias("ctr_store_sk"),
                   col("ctr_total")))
    avg_store = (ctr.group_by(col("ctr_store_sk"))
                 .agg(_avg(col("ctr_total"), "store_avg"))
                 .select(col("ctr_store_sk").alias("as_store_sk"),
                         col("store_avg")))
    return (ctr
            .join(avg_store,
                  on=_eq(col("ctr_store_sk"), col("as_store_sk")),
                  how="inner")
            .where(P.GreaterThan(col("ctr_total"),
                                 Multiply(lit(1.2), col("store_avg"))))
            .join(t["store"].where(_eq(col("s_state"), lit("TN"))),
                  on=_eq(col("ctr_store_sk"), col("s_store_sk")),
                  how="inner")
            .join(t["customer"],
                  on=_eq(col("ctr_customer_sk"), col("c_customer_sk")),
                  how="inner")
            .select(col("c_customer_id"))
            .sort(SortOrder(col("c_customer_id")))
            .limit(100))


def q18(t):
    """Q18: catalog demographics averages with ROLLUP over
    country/state/county/item (real grouping sets through Expand)."""
    cd1 = t["customer_demographics"].where(P.And(
        _eq(col("cd_gender"), lit("F")),
        _eq(col("cd_education_status"), lit("College"))))
    c = t["customer"].where(P.In(col("c_birth_month"), [1, 3, 7, 11]))
    d = t["date_dim"].where(_eq(col("d_year"), lit(1998)))
    base = (t["catalog_sales"]
            .join(cd1, on=_eq(col("cs_bill_cdemo_sk"), col("cd_demo_sk")),
                  how="inner")
            .join(c, on=_eq(col("cs_bill_customer_sk"),
                            col("c_customer_sk")), how="inner")
            .join(t["customer_address"],
                  on=_eq(col("c_current_addr_sk"), col("ca_address_sk")),
                  how="inner")
            .join(d, on=_eq(col("cs_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["item"], on=_eq(col("cs_item_sk"), col("i_item_sk")),
                  how="inner"))
    return (base
            .rollup("i_item_id", "ca_country", "ca_state", "ca_county")
            .agg(_avg(col("cs_quantity"), "agg1"),
                 _avg(col("cs_list_price"), "agg2"),
                 _avg(col("cs_coupon_amt"), "agg3"),
                 _avg(col("cs_sales_price"), "agg4"))
            .sort(SortOrder(col("ca_country")), SortOrder(col("ca_state")),
                  SortOrder(col("ca_county")), SortOrder(col("i_item_id")))
            .limit(100))


def q22(t):
    """Q22: average inventory quantity with ROLLUP over the item
    hierarchy (product_name/brand/class/category)."""
    d = t["date_dim"].where(_between(col("d_month_seq"), lit(12), lit(23)))
    return (t["inventory"]
            .join(d, on=_eq(col("inv_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["item"], on=_eq(col("inv_item_sk"), col("i_item_sk")),
                  how="inner")
            .rollup("i_product_name", "i_brand", "i_class", "i_category")
            .agg(_avg(col("inv_quantity_on_hand"), "qoh"))
            .sort(SortOrder(col("qoh")), SortOrder(col("i_product_name")),
                  SortOrder(col("i_brand")), SortOrder(col("i_class")),
                  SortOrder(col("i_category")))
            .limit(100))


def q36(t):
    """Q36: gross-margin ROLLUP over category/class with a rank window
    partitioned by the grouping-id lochierarchy (GpuExpandExec +
    GpuWindowExec interplay)."""
    d = t["date_dim"].where(_eq(col("d_year"), lit(1998)))
    base = (t["store_sales"]
            .join(d, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["item"], on=_eq(col("ss_item_sk"), col("i_item_sk")),
                  how="inner")
            .join(t["store"].where(P.In(col("s_state"),
                                        ["TN", "CA", "TX", "OH"])),
                  on=_eq(col("ss_store_sk"), col("s_store_sk")),
                  how="inner"))
    agg = (base
           .rollup("i_category", "i_class", grouping_id="lochierarchy")
           .agg(_sum(col("ss_net_profit"), "profit"),
                _sum(col("ss_ext_sales_price"), "sales")))
    w = (Window.partition_by(col("lochierarchy"), If(
        _eq(col("lochierarchy"), lit(1)), col("i_category"), lit("")))
        .order_by(SortOrder(Divide(col("profit"), col("sales"))))
    )
    return (agg
            .with_column("gross_margin", Divide(col("profit"),
                                                col("sales")))
            .with_column("rank_within_parent", over(Rank(), w))
            .select(col("gross_margin"), col("i_category"), col("i_class"),
                    col("lochierarchy"), col("rank_within_parent"))
            .sort(SortOrder(col("lochierarchy"), ascending=False),
                  SortOrder(col("i_category")),
                  SortOrder(col("rank_within_parent")))
            .limit(100))


def q44(t):
    """Q44: best and worst performing items per store by avg net profit
    (asc + desc rank windows joined on rank)."""
    perf = (t["store_sales"]
            .where(_eq(col("ss_store_sk"), lit(4)))
            .group_by(col("ss_item_sk"))
            .agg(_avg(col("ss_net_profit"), "rank_col")))
    asc_w = Window.partition_by().order_by(SortOrder(col("rank_col")))
    desc_w = Window.partition_by().order_by(
        SortOrder(col("rank_col"), ascending=False))
    best = (perf.with_column("rnk", over(Rank(), desc_w))
            .where(P.LessThanOrEqual(col("rnk"), lit(10)))
            .select(col("rnk").alias("b_rnk"),
                    col("ss_item_sk").alias("best_item")))
    worst = (perf.with_column("rnk", over(Rank(), asc_w))
             .where(P.LessThanOrEqual(col("rnk"), lit(10)))
             .select(col("rnk").alias("w_rnk"),
                     col("ss_item_sk").alias("worst_item")))
    i1 = t["item"].select(col("i_item_sk").alias("i1_sk"),
                          col("i_product_name").alias("best_performing"))
    i2 = t["item"].select(col("i_item_sk").alias("i2_sk"),
                          col("i_product_name").alias("worst_performing"))
    return (best.join(worst, on=_eq(col("b_rnk"), col("w_rnk")),
                      how="inner")
            .join(i1, on=_eq(col("best_item"), col("i1_sk")), how="inner")
            .join(i2, on=_eq(col("worst_item"), col("i2_sk")), how="inner")
            .select(col("b_rnk").alias("rnk"), col("best_performing"),
                    col("worst_performing"))
            .sort(SortOrder(col("rnk")))
            .limit(100))


def q51(t):
    """Q51: running web vs store cumulative sales per item (full outer
    join + running-sum windows)."""
    d = t["date_dim"].where(_between(col("d_month_seq"), lit(12), lit(18)))
    run_w = (Window.partition_by("item_sk_w")
             .order_by(SortOrder(col("date_w"))))
    web = (t["web_sales"]
           .join(d, on=_eq(col("ws_sold_date_sk"), col("d_date_sk")),
                 how="inner")
           .group_by(col("ws_item_sk"), col("d_date_sk"))
           .agg(_sum(col("ws_sales_price"), "w_sales"))
           .select(col("ws_item_sk").alias("item_sk_w"),
                   col("d_date_sk").alias("date_w"), col("w_sales"))
           .with_column("web_cumulative", over(A.Sum(col("w_sales")),
                                               run_w)))
    run_s = (Window.partition_by("item_sk_s")
             .order_by(SortOrder(col("date_s"))))
    store = (t["store_sales"]
             .join(d, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                   how="inner")
             .group_by(col("ss_item_sk"), col("d_date_sk"))
             .agg(_sum(col("ss_sales_price"), "s_sales"))
             .select(col("ss_item_sk").alias("item_sk_s"),
                     col("d_date_sk").alias("date_s"), col("s_sales"))
             .with_column("store_cumulative", over(A.Sum(col("s_sales")),
                                                   run_s)))
    return (web.join(store,
                     on=P.And(_eq(col("item_sk_w"), col("item_sk_s")),
                              _eq(col("date_w"), col("date_s"))),
                     how="full")
            .select(Coalesce(col("item_sk_w"),
                             col("item_sk_s")).alias("item_sk"),
                    Coalesce(col("date_w"), col("date_s")).alias("d_date"),
                    Coalesce(col("web_cumulative"),
                             lit(0.0)).alias("web_sales"),
                    Coalesce(col("store_cumulative"),
                             lit(0.0)).alias("store_sales"))
            .where(P.GreaterThan(col("web_sales"), col("store_sales")))
            .sort(SortOrder(col("item_sk")), SortOrder(col("d_date")))
            .limit(100))


def q86(t):
    """Q86: web net-paid ROLLUP over category/class with the per-level
    rank window (q36's shape on the web channel)."""
    d = t["date_dim"].where(_between(col("d_month_seq"), lit(12), lit(23)))
    agg = (t["web_sales"]
           .join(d, on=_eq(col("ws_sold_date_sk"), col("d_date_sk")),
                 how="inner")
           .join(t["item"], on=_eq(col("ws_item_sk"), col("i_item_sk")),
                 how="inner")
           .rollup("i_category", "i_class", grouping_id="lochierarchy")
           .agg(_sum(col("ws_net_paid"), "total_sum")))
    w = (Window.partition_by(col("lochierarchy"), If(
        _eq(col("lochierarchy"), lit(1)), col("i_category"), lit("")))
        .order_by(SortOrder(col("total_sum"), ascending=False)))
    return (agg
            .with_column("rank_within_parent", over(Rank(), w))
            .sort(SortOrder(col("lochierarchy"), ascending=False),
                  SortOrder(col("i_category")),
                  SortOrder(col("rank_within_parent")))
            .limit(100))


def q88(t):
    """Q88: store traffic in eight half-hour slots (eight 1-row counts
    cross-joined)."""
    hd = t["household_demographics"].where(P.Or(
        _eq(col("hd_dep_count"), lit(3)),
        _eq(col("hd_vehicle_count"), lit(1))))
    store = t["store"].where(_eq(col("s_store_name"), lit("able0")))
    slots = [(8, 30), (9, 0), (9, 30), (10, 0), (10, 30), (11, 0),
             (11, 30), (12, 0)]
    legs = None
    for i, (h, m) in enumerate(slots, 1):
        tm = t["time_dim"].where(P.And(
            _eq(col("t_hour"), lit(h)),
            _between(col("t_minute"), lit(m), lit(m + 29))))
        leg = (t["store_sales"]
               .join(hd, on=_eq(col("ss_hdemo_sk"), col("hd_demo_sk")),
                     how="left_semi")
               .join(tm, on=_eq(col("ss_sold_time_sk"), col("t_time_sk")),
                     how="left_semi")
               .join(store, on=_eq(col("ss_store_sk"), col("s_store_sk")),
                     how="left_semi")
               .group_by().agg(_cnt(f"h{i}")))
        legs = leg if legs is None else legs.join(leg, how="cross")
    return legs


def q97(t):
    """Q97: customer/item overlap between store and catalog channels
    (full outer join on distinct month pairs)."""
    d = t["date_dim"].where(_between(col("d_month_seq"), lit(12), lit(23)))
    ss = (t["store_sales"]
          .join(d, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                how="inner")
          .select(col("ss_customer_sk").alias("ss_cust"),
                  col("ss_item_sk").alias("ss_item")).distinct())
    cs = (t["catalog_sales"]
          .join(d, on=_eq(col("cs_sold_date_sk"), col("d_date_sk")),
                how="inner")
          .select(col("cs_bill_customer_sk").alias("cs_cust"),
                  col("cs_item_sk").alias("cs_item")).distinct())
    joined = ss.join(cs, on=P.And(_eq(col("ss_cust"), col("cs_cust")),
                                  _eq(col("ss_item"), col("cs_item"))),
                     how="full")
    return (joined.group_by()
            .agg(_sum(If(P.And(P.IsNotNull(col("ss_cust")),
                               P.IsNull(col("cs_cust"))),
                         lit(1), lit(0)), "store_only"),
                 _sum(If(P.And(P.IsNull(col("ss_cust")),
                               P.IsNotNull(col("cs_cust"))),
                         lit(1), lit(0)), "catalog_only"),
                 _sum(If(P.And(P.IsNotNull(col("ss_cust")),
                               P.IsNotNull(col("cs_cust"))),
                         lit(1), lit(0)), "store_and_catalog")))


# ---------------------------------------------------------------------------
# INTERSECT and EXCEPT as semi and anti chains over USING joins
# ---------------------------------------------------------------------------

def q38(t):
    """Q38: customers active in ALL three channels in a period (INTERSECT
    -> chained left-semi joins on name+date identity), counted."""
    d = t["date_dim"].where(_between(col("d_month_seq"), lit(12), lit(23)))

    def leg(fact, date_col, cust_col):
        return (t[fact]
                .join(d, on=_eq(col(date_col), col("d_date_sk")),
                      how="inner")
                .join(t["customer"],
                      on=_eq(col(cust_col), col("c_customer_sk")),
                      how="inner")
                .select(col("c_last_name"), col("c_first_name"),
                        col("d_date"))
                .distinct())

    ss = leg("store_sales", "ss_sold_date_sk", "ss_customer_sk")
    cs = leg("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk")
    ws = leg("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk")
    key = [col("c_last_name"), col("c_first_name"), col("d_date")]
    inter = (ss.join(cs, on=[k.name for k in key], how="left_semi")
             .join(ws, on=[k.name for k in key], how="left_semi"))
    return inter.group_by().agg(_cnt("cnt"))

def q87(t):
    """Q87: customers in the store channel but NOT catalog or web
    (EXCEPT -> anti-join chain), counted."""
    d = t["date_dim"].where(_between(col("d_month_seq"), lit(12), lit(23)))

    def leg(fact, date_col, cust_col):
        return (t[fact]
                .join(d, on=_eq(col(date_col), col("d_date_sk")),
                      how="inner")
                .join(t["customer"],
                      on=_eq(col(cust_col), col("c_customer_sk")),
                      how="inner")
                .select(col("c_last_name"), col("c_first_name"),
                        col("d_date"))
                .distinct())

    ss = leg("store_sales", "ss_sold_date_sk", "ss_customer_sk")
    cs = leg("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk")
    ws = leg("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk")
    keys = ["c_last_name", "c_first_name", "d_date"]
    remaining = (ss.join(cs, on=keys, how="left_anti")
                 .join(ws, on=keys, how="left_anti"))
    return remaining.group_by().agg(_cnt("num_cool"))

def q14(t):
    """Q14 (iceberg): items sold through ALL three channels (INTERSECT on
    the brand/class/category triple -> chained semi joins), channel
    sales of those items in one month kept only above the cross-channel
    average (scalar-aggregate cross join), ROLLUP over channel/brand
    (TpcdsLikeSpark.scala q14a)."""
    years = _between(col("d_year"), lit(1998), lit(2000))

    def channel_items(fact, date_col, item_col):
        return (t[fact]
                .join(t["date_dim"].where(years),
                      on=_eq(col(date_col), col("d_date_sk")),
                      how="inner")
                .join(t["item"], on=_eq(col(item_col), col("i_item_sk")),
                      how="inner")
                .select(col("i_brand_id"), col("i_class_id"),
                        col("i_category_id"))
                .distinct())

    triple = ["i_brand_id", "i_class_id", "i_category_id"]
    cross_triples = (channel_items("store_sales", "ss_sold_date_sk",
                                   "ss_item_sk")
                     .join(channel_items("catalog_sales",
                                         "cs_sold_date_sk", "cs_item_sk"),
                           on=triple, how="left_semi")
                     .join(channel_items("web_sales", "ws_sold_date_sk",
                                         "ws_item_sk"),
                           on=triple, how="left_semi"))
    cross_items = (t["item"]
                   .join(cross_triples, on=triple, how="left_semi")
                   .select(col("i_item_sk").alias("ci_sk"),
                           col("i_brand_id").alias("ci_brand")))

    def month_sales(fact, date_col, item_col, qty, price, channel):
        d = t["date_dim"].where(P.And(_eq(col("d_year"), lit(2000)),
                                      _eq(col("d_moy"), lit(11))))
        return (t[fact]
                .join(d, on=_eq(col(date_col), col("d_date_sk")),
                      how="inner")
                .join(cross_items, on=_eq(col(item_col), col("ci_sk")),
                      how="inner")
                .with_column("_amt", Multiply(Cast(col(qty), T.DOUBLE),
                                              col(price)))
                .group_by(col("ci_brand"))
                .agg(_sum(col("_amt"), "sales"), _cnt("number_sales"))
                .select(lit(channel).alias("channel"), col("ci_brand"),
                        col("sales"), col("number_sales")))

    def avg_leg(fact, date_col, qty, price):
        return (t[fact]
                .join(t["date_dim"].where(years),
                      on=_eq(col(date_col), col("d_date_sk")),
                      how="inner")
                .select(Multiply(Cast(col(qty), T.DOUBLE),
                                 col(price)).alias("amt")))

    avg_sales = (avg_leg("store_sales", "ss_sold_date_sk", "ss_quantity",
                         "ss_list_price")
                 .union(avg_leg("catalog_sales", "cs_sold_date_sk",
                                "cs_quantity", "cs_list_price"))
                 .union(avg_leg("web_sales", "ws_sold_date_sk",
                                "ws_quantity", "ws_list_price"))
                 .group_by().agg(_avg(col("amt"), "average_sales")))
    all_ch = (month_sales("store_sales", "ss_sold_date_sk", "ss_item_sk",
                          "ss_quantity", "ss_list_price", "store")
              .union(month_sales("catalog_sales", "cs_sold_date_sk",
                                 "cs_item_sk", "cs_quantity",
                                 "cs_list_price", "catalog"))
              .union(month_sales("web_sales", "ws_sold_date_sk",
                                 "ws_item_sk", "ws_quantity",
                                 "ws_list_price", "web")))
    return (all_ch
            .join(avg_sales, how="cross")
            .where(P.GreaterThan(col("sales"), col("average_sales")))
            .rollup("channel", "ci_brand", grouping_id="lochierarchy")
            .agg(_sum(col("sales"), "sum_sales"),
                 _sum(col("number_sales"), "sum_number_sales"))
            .sort(SortOrder(col("lochierarchy"), ascending=False),
                  SortOrder(col("channel")), SortOrder(col("ci_brand")))
            .limit(100))

# ---------------------------------------------------------------------------
# Queries that are empty at the tests' scale
# ---------------------------------------------------------------------------

def q8(t):
    """Q8: store net profit for stores whose zip prefix has >10 preferred
    customers (having-filtered zip aggregate -> prefix join)."""
    zips = (t["customer_address"]
            .join(t["customer"].where(
                _eq(col("c_preferred_cust_flag"), lit("Y"))),
                on=_eq(col("ca_address_sk"), col("c_current_addr_sk")),
                how="inner")
            .group_by(Substring(col("ca_zip"), lit(1),
                                lit(5)).alias("zip5"))
            .agg(_cnt("cnt"))
            .where(P.GreaterThan(col("cnt"), lit(10)))
            .select(Substring(col("zip5"), lit(1), lit(2)).alias("zip2"))
            .distinct())
    d = t["date_dim"].where(P.And(_eq(col("d_qoy"), lit(2)),
                                  _eq(col("d_year"), lit(1998))))
    return (t["store_sales"]
            .join(d, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["store"], on=_eq(col("ss_store_sk"), col("s_store_sk")),
                  how="inner")
            .join(zips,
                  on=_eq(Substring(col("s_zip"), lit(1), lit(2)),
                         col("zip2")),
                  how="left_semi")
            .group_by(col("s_store_name"))
            .agg(_sum(col("ss_net_profit"), "profit"))
            .sort(SortOrder(col("s_store_name")))
            .limit(100))

def q58(t):
    """Q58: items whose revenue is balanced across all three channels in
    a window (three aggregate legs, mutual 0.9-1.1 band filters)."""
    d = t["date_dim"].where(_between(col("d_date_sk"), lit(740), lit(747)))

    def leg(fact, date_col, item_col, price, name):
        return (t[fact]
                .join(d, on=_eq(col(date_col), col("d_date_sk")),
                      how="inner")
                .join(t["item"], on=_eq(col(item_col), col("i_item_sk")),
                      how="inner")
                .group_by(col("i_item_id"))
                .agg(_sum(col(price), name))
                .select(col("i_item_id").alias(name + "_id"), col(name)))

    ss = leg("store_sales", "ss_sold_date_sk", "ss_item_sk",
             "ss_ext_sales_price", "ss_rev")
    cs = leg("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
             "cs_ext_sales_price", "cs_rev")
    ws = leg("web_sales", "ws_sold_date_sk", "ws_item_sk",
             "ws_ext_sales_price", "ws_rev")

    def band(a, b):
        return P.And(
            P.GreaterThanOrEqual(a, Multiply(lit(0.9), b)),
            P.LessThanOrEqual(a, Multiply(lit(1.1), b)))

    return (ss
            .join(cs, on=_eq(col("ss_rev_id"), col("cs_rev_id")),
                  how="inner")
            .join(ws, on=_eq(col("ss_rev_id"), col("ws_rev_id")),
                  how="inner")
            .where(P.And(band(col("ss_rev"), col("cs_rev")),
                         P.And(band(col("ss_rev"), col("ws_rev")),
                               P.And(band(col("cs_rev"), col("ss_rev")),
                                     band(col("ws_rev"),
                                          col("ss_rev"))))))
            .select(col("ss_rev_id").alias("item_id"), col("ss_rev"),
                    col("cs_rev"), col("ws_rev"))
            .sort(SortOrder(col("item_id")), SortOrder(col("ss_rev")))
            .limit(100))

def q71(t):
    """Q71: brand revenue during breakfast/dinner hours across all three
    channels."""
    d = t["date_dim"].where(P.And(_eq(col("d_moy"), lit(12)),
                                  _eq(col("d_year"), lit(1998))))
    tm = t["time_dim"].where(P.In(col("t_hour"), [8, 9, 17, 18]))
    item = t["item"].where(_eq(col("i_manager_id"), lit(1)))

    def leg(fact, date_col, time_col, item_col, price):
        return (t[fact]
                .join(d, on=_eq(col(date_col), col("d_date_sk")),
                      how="inner")
                .join(item, on=_eq(col(item_col), col("i_item_sk")),
                      how="inner")
                .select(col("i_brand_id"), col("i_brand"),
                        col(time_col).alias("time_sk"),
                        col(price).alias("ext_price")))

    allc = (leg("web_sales", "ws_sold_date_sk", "ws_sold_time_sk",
                "ws_item_sk", "ws_ext_sales_price")
            .union(leg("catalog_sales", "cs_sold_date_sk",
                       "cs_sold_time_sk", "cs_item_sk",
                       "cs_ext_sales_price"))
            .union(leg("store_sales", "ss_sold_date_sk",
                       "ss_sold_time_sk", "ss_item_sk",
                       "ss_ext_sales_price")))
    return (allc
            .join(tm, on=_eq(col("time_sk"), col("t_time_sk")),
                  how="inner")
            .group_by(col("i_brand_id"), col("i_brand"), col("t_hour"),
                      col("t_minute"))
            .agg(_sum(col("ext_price"), "ext_price_sum"))
            .sort(SortOrder(col("ext_price_sum"), ascending=False),
                  SortOrder(col("i_brand_id")), SortOrder(col("t_hour")),
                  SortOrder(col("t_minute")))
            .limit(100))

def q83(t):
    """Q83: matched item return quantities across the three return
    channels with mutual share ratios."""
    d = t["date_dim"].where(_between(col("d_date_sk"), lit(720), lit(750)))

    def leg(fact, date_col, item_col, qty, name):
        return (t[fact]
                .join(d, on=_eq(col(date_col), col("d_date_sk")),
                      how="inner")
                .join(t["item"], on=_eq(col(item_col), col("i_item_sk")),
                      how="inner")
                .group_by(col("i_item_id"))
                .agg(_sum(Cast(col(qty), T.DOUBLE), name))
                .select(col("i_item_id").alias(name + "_id"), col(name)))

    sr = leg("store_returns", "sr_returned_date_sk", "sr_item_sk",
             "sr_return_quantity", "sr_qty")
    cr = leg("catalog_returns", "cr_returned_date_sk", "cr_item_sk",
             "cr_return_quantity", "cr_qty")
    wr = leg("web_returns", "wr_returned_date_sk", "wr_item_sk",
             "wr_return_quantity", "wr_qty")
    total = Add(Add(col("sr_qty"), col("cr_qty")), col("wr_qty"))
    third = Divide(Cast(total, T.DOUBLE), lit(3.0))
    return (sr
            .join(cr, on=_eq(col("sr_qty_id"), col("cr_qty_id")),
                  how="inner")
            .join(wr, on=_eq(col("sr_qty_id"), col("wr_qty_id")),
                  how="inner")
            .select(col("sr_qty_id").alias("item_id"), col("sr_qty"),
                    col("cr_qty"), col("wr_qty"),
                    Multiply(Divide(col("sr_qty"), total),
                             lit(100.0)).alias("sr_dev"),
                    third.alias("average"))
            .sort(SortOrder(col("item_id")), SortOrder(col("sr_qty")))
            .limit(100))

def q91(t):
    """Q91: call-center catalog-return losses by demographic segment."""
    d = t["date_dim"].where(P.And(_eq(col("d_year"), lit(1999)),
                                  _eq(col("d_moy"), lit(11))))
    cd = t["customer_demographics"].where(P.Or(
        P.And(_eq(col("cd_marital_status"), lit("M")),
              _eq(col("cd_education_status"), lit("Unknown"))),
        P.And(_eq(col("cd_marital_status"), lit("W")),
              _eq(col("cd_education_status"), lit("Advanced Degree")))))
    hd = t["household_demographics"].where(
        _eq(col("hd_buy_potential"), lit("Unknown")))
    ca = t["customer_address"].where(_eq(col("ca_gmt_offset"), lit(-7.0)))
    return (t["catalog_returns"]
            .join(d, on=_eq(col("cr_returned_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["call_center"],
                  on=_eq(col("cr_call_center_sk"),
                         col("cc_call_center_sk")), how="inner")
            .join(t["customer"],
                  on=_eq(col("cr_returning_customer_sk"),
                         col("c_customer_sk")), how="inner")
            .join(cd, on=_eq(col("c_current_cdemo_sk"), col("cd_demo_sk")),
                  how="inner")
            .join(hd, on=_eq(col("c_current_hdemo_sk"),
                             col("hd_demo_sk")), how="left_semi")
            .join(ca, on=_eq(col("c_current_addr_sk"),
                             col("ca_address_sk")), how="left_semi")
            .group_by(col("cc_call_center_id"), col("cc_name"),
                      col("cc_manager"), col("cd_marital_status"),
                      col("cd_education_status"))
            .agg(_sum(col("cr_net_loss"), "returns_loss"))
            .sort(SortOrder(col("returns_loss"), ascending=False),
                  SortOrder(col("cc_call_center_id")))
            .limit(100))

# ---------------------------------------------------------------------------
# Windows over aggregates
# ---------------------------------------------------------------------------

def _monthly_windowed(base, part_cols, year):
    """Shared q47/q57 core: monthly sums, per-year average window,
    row-number self-joins for prev/next month."""
    monthly = (base
               .group_by(*[col(c) for c in part_cols],
                         col("d_year"), col("d_moy"))
               .agg(_sum(col("sales_price"), "sum_sales")))
    avg_w = Window.partition_by(*(part_cols + ["d_year"]))
    rn_w = (Window.partition_by(*part_cols)
            .order_by(SortOrder(col("d_year")), SortOrder(col("d_moy"))))
    v1 = (monthly
          .with_windows(avg_monthly_sales=over(A.Average(col("sum_sales")),
                                               avg_w),
                        rn=over(RowNumber(), rn_w)))
    lag = v1.select(*([col(c).alias("lag_" + c) for c in part_cols]
                      + [col("rn").alias("lag_rn"),
                         col("sum_sales").alias("psum")]))
    lead = v1.select(*([col(c).alias("lead_" + c) for c in part_cols]
                       + [col("rn").alias("lead_rn"),
                          col("sum_sales").alias("nsum")]))
    cond_lag = _eq(col(part_cols[0]), col("lag_" + part_cols[0]))
    for c in part_cols[1:]:
        cond_lag = P.And(cond_lag, _eq(col(c), col("lag_" + c)))
    cond_lag = P.And(cond_lag, _eq(col("rn"), Add(col("lag_rn"), lit(1))))
    cond_lead = _eq(col(part_cols[0]), col("lead_" + part_cols[0]))
    for c in part_cols[1:]:
        cond_lead = P.And(cond_lead, _eq(col(c), col("lead_" + c)))
    cond_lead = P.And(cond_lead,
                      _eq(col("rn"), Subtract(col("lead_rn"), lit(1))))
    dev = Divide(Abs(Subtract(col("sum_sales"),
                              col("avg_monthly_sales"))),
                 col("avg_monthly_sales"))
    return (v1.join(lag, on=cond_lag, how="inner")
            .join(lead, on=cond_lead, how="inner")
            .where(_eq(col("d_year"), lit(year)))
            .where(P.GreaterThan(col("avg_monthly_sales"), lit(0.0)))
            .where(P.GreaterThan(dev, lit(0.1)))
            .select(*([col(c) for c in part_cols]
                      + [col("d_year"), col("d_moy"), col("sum_sales"),
                         col("avg_monthly_sales"), col("psum"),
                         col("nsum")]))
            .sort(SortOrder(Subtract(col("sum_sales"),
                                     col("avg_monthly_sales"))),
                  *[SortOrder(col(c)) for c in part_cols],
                  SortOrder(col("d_moy")))
            .limit(100))

def q47(t):
    """Q47: store monthly sales vs yearly average with prev/next month
    columns (window avg + row-number self joins)."""
    d = t["date_dim"].where(P.In(col("d_year"), [1998, 1999]))
    base = (t["store_sales"]
            .join(d, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["item"], on=_eq(col("ss_item_sk"), col("i_item_sk")),
                  how="inner")
            .join(t["store"], on=_eq(col("ss_store_sk"),
                                     col("s_store_sk")), how="inner")
            .select(col("i_category"), col("i_brand"), col("s_store_name"),
                    col("d_year"), col("d_moy"),
                    col("ss_sales_price").alias("sales_price")))
    return _monthly_windowed(base, ["i_category", "i_brand",
                                    "s_store_name"], 1999)

def q57(t):
    """Q57: q47's shape on the catalog channel with call centers."""
    d = t["date_dim"].where(P.In(col("d_year"), [1998, 1999]))
    base = (t["catalog_sales"]
            .join(d, on=_eq(col("cs_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["item"], on=_eq(col("cs_item_sk"), col("i_item_sk")),
                  how="inner")
            .join(t["call_center"],
                  on=_eq(col("cs_call_center_sk"),
                         col("cc_call_center_sk")), how="inner")
            .select(col("i_category"), col("i_brand"), col("cc_name"),
                    col("d_year"), col("d_moy"),
                    col("cs_sales_price").alias("sales_price")))
    return _monthly_windowed(base, ["i_category", "i_brand", "cc_name"],
                             1999)

def q53(t):
    """Q53: quarterly manufacturer sales vs their average (window over
    aggregate, deviation filter)."""
    d = t["date_dim"].where(_between(col("d_month_seq"), lit(12), lit(23)))
    agg = (t["store_sales"]
           .join(d, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                 how="inner")
           .join(t["item"].where(_between(col("i_manufact_id"), lit(20),
                                          lit(60))),
                 on=_eq(col("ss_item_sk"), col("i_item_sk")), how="inner")
           .join(t["store"], on=_eq(col("ss_store_sk"),
                                    col("s_store_sk")), how="inner")
           .group_by(col("i_manufact_id"), col("d_qoy"))
           .agg(_sum(col("ss_sales_price"), "sum_sales")))
    w = Window.partition_by("i_manufact_id")
    dev = Divide(Abs(Subtract(col("sum_sales"), col("avg_quarterly"))),
                 col("avg_quarterly"))
    return (agg
            .with_column("avg_quarterly", over(A.Average(col("sum_sales")),
                                               w))
            .where(P.GreaterThan(col("avg_quarterly"), lit(0.0)))
            .where(P.GreaterThan(dev, lit(0.1)))
            .select(col("i_manufact_id"), col("sum_sales"),
                    col("avg_quarterly"))
            .sort(SortOrder(col("avg_quarterly")),
                  SortOrder(col("sum_sales")),
                  SortOrder(col("i_manufact_id")))
            .limit(100))

def q63(t):
    """Q63: manager monthly sales vs their average (q53's shape by
    manager)."""
    d = t["date_dim"].where(_between(col("d_month_seq"), lit(12), lit(23)))
    agg = (t["store_sales"]
           .join(d, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                 how="inner")
           .join(t["item"].where(_between(col("i_manager_id"), lit(20),
                                          lit(60))),
                 on=_eq(col("ss_item_sk"), col("i_item_sk")), how="inner")
           .join(t["store"], on=_eq(col("ss_store_sk"),
                                    col("s_store_sk")), how="inner")
           .group_by(col("i_manager_id"), col("d_moy"))
           .agg(_sum(col("ss_sales_price"), "sum_sales")))
    w = Window.partition_by("i_manager_id")
    dev = Divide(Abs(Subtract(col("sum_sales"), col("avg_monthly"))),
                 col("avg_monthly"))
    return (agg
            .with_column("avg_monthly", over(A.Average(col("sum_sales")),
                                             w))
            .where(P.GreaterThan(col("avg_monthly"), lit(0.0)))
            .where(P.GreaterThan(dev, lit(0.1)))
            .select(col("i_manager_id"), col("sum_sales"),
                    col("avg_monthly"))
            .sort(SortOrder(col("i_manager_id")),
                  SortOrder(col("avg_monthly")),
                  SortOrder(col("sum_sales")))
            .limit(100))

def q89(t):
    """Q89: monthly class sales deviation from the yearly average
    (window avg over brand/store partitions)."""
    d = t["date_dim"].where(_eq(col("d_year"), lit(1998)))
    cat_ok = P.Or(
        P.And(P.In(col("i_category"), ["Books", "Electronics", "Sports"]),
              P.In(col("i_class"), ["fiction", "portable", "football"])),
        P.And(P.In(col("i_category"), ["Men", "Jewelry", "Women"]),
              P.In(col("i_class"), ["accent", "diamonds", "dresses"])))
    agg = (t["store_sales"]
           .join(d, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                 how="inner")
           .join(t["item"].where(cat_ok),
                 on=_eq(col("ss_item_sk"), col("i_item_sk")), how="inner")
           .join(t["store"], on=_eq(col("ss_store_sk"),
                                    col("s_store_sk")), how="inner")
           .group_by(col("i_category"), col("i_class"), col("i_brand"),
                     col("s_store_name"), col("s_company_id"),
                     col("d_moy"))
           .agg(_sum(col("ss_sales_price"), "sum_sales")))
    w = Window.partition_by("i_category", "i_brand", "s_store_name",
                            "s_company_id")
    return (agg
            .with_column("avg_monthly_sales",
                         over(A.Average(col("sum_sales")), w))
            .where(P.GreaterThan(col("avg_monthly_sales"), lit(0.0)))
            .where(P.GreaterThan(
                Divide(Abs(Subtract(col("sum_sales"),
                                    col("avg_monthly_sales"))),
                       col("avg_monthly_sales")), lit(0.1)))
            .sort(SortOrder(Subtract(col("sum_sales"),
                                     col("avg_monthly_sales"))),
                  SortOrder(col("s_store_name")),
                  SortOrder(col("i_category")), SortOrder(col("i_class")),
                  SortOrder(col("i_brand")), SortOrder(col("d_moy")))
            .limit(100))

def q12(t):
    """Q12: web item revenue with class-share window over a 30-day
    window (q98's shape on the web channel)."""
    agg = (t["web_sales"]
           .join(t["date_dim"].where(_between(col("d_date_sk"), lit(730),
                                              lit(760))),
                 on=_eq(col("ws_sold_date_sk"), col("d_date_sk")),
                 how="inner")
           .join(t["item"].where(P.In(col("i_category"),
                                      ["Sports", "Books", "Home"])),
                 on=_eq(col("ws_item_sk"), col("i_item_sk")), how="inner")
           .group_by(col("i_item_id"), col("i_category"), col("i_class"),
                     col("i_current_price"))
           .agg(_sum(col("ws_ext_sales_price"), "itemrevenue")))
    w = Window.partition_by("i_class")
    return (agg
            .with_column("classrevenue", over(A.Sum(col("itemrevenue")), w))
            .with_column("revenueratio",
                         Divide(Multiply(col("itemrevenue"), lit(100.0)),
                                col("classrevenue")))
            .sort(SortOrder(col("i_category")), SortOrder(col("i_class")),
                  SortOrder(col("i_item_id")),
                  SortOrder(col("revenueratio")))
            .limit(100))

def q20(t):
    """Q20: catalog item revenue with class share (q98 shape, catalog
    channel)."""
    agg = (t["catalog_sales"]
           .join(t["date_dim"].where(_between(col("d_date_sk"), lit(730),
                                              lit(760))),
                 on=_eq(col("cs_sold_date_sk"), col("d_date_sk")),
                 how="inner")
           .join(t["item"].where(P.In(col("i_category"),
                                      ["Sports", "Books", "Home"])),
                 on=_eq(col("cs_item_sk"), col("i_item_sk")), how="inner")
           .group_by(col("i_item_id"), col("i_category"), col("i_class"),
                     col("i_current_price"))
           .agg(_sum(col("cs_ext_sales_price"), "itemrevenue")))
    w = Window.partition_by("i_class")
    return (agg
            .with_column("classrevenue", over(A.Sum(col("itemrevenue")), w))
            .with_column("revenueratio",
                         Divide(Multiply(col("itemrevenue"), lit(100.0)),
                                col("classrevenue")))
            .sort(SortOrder(col("i_category")), SortOrder(col("i_class")),
                  SortOrder(col("i_item_id")),
                  SortOrder(col("revenueratio")))
            .limit(100))

def q49(t):
    """Q49: worst return ratios per channel, rank windows unioned."""
    def channel(sales, returns, s_item, s_order, s_qty, s_price, r_item,
                r_order, r_qty, r_amt, date_col, label):
        d = t["date_dim"].where(P.And(_eq(col("d_year"), lit(1998)),
                                      _eq(col("d_moy"), lit(12))))
        r = t[returns].select(col(r_item).alias("r_item"),
                              col(r_order).alias("r_order"),
                              col(r_qty).alias("r_qty"),
                              col(r_amt).alias("r_amt"))
        joined = (t[sales]
                  .where(P.GreaterThan(col(s_price), lit(0.0)))
                  .join(d, on=_eq(col(date_col), col("d_date_sk")),
                        how="inner")
                  .join(r, on=P.And(_eq(col(s_item), col("r_item")),
                                    _eq(col(s_order), col("r_order"))),
                        how="inner"))
        agg = (joined.group_by(col(s_item))
               .agg(_sum(Cast(col("r_qty"), T.DOUBLE), "ret_qty"),
                    _sum(Cast(col(s_qty), T.DOUBLE), "sale_qty"),
                    _sum(col("r_amt"), "ret_amt"),
                    _sum(col(s_price), "sale_amt")))
        ratio_w = Window.partition_by().order_by(
            SortOrder(Divide(col("ret_qty"), col("sale_qty")),
                      ascending=False))
        curr_w = Window.partition_by().order_by(
            SortOrder(Divide(col("ret_amt"), col("sale_amt")),
                      ascending=False))
        return (agg
                .with_windows(return_rank=over(Rank(), ratio_w),
                              currency_rank=over(Rank(), curr_w))
                .where(P.Or(P.LessThanOrEqual(col("return_rank"),
                                              lit(10)),
                            P.LessThanOrEqual(col("currency_rank"),
                                              lit(10))))
                .with_column("channel", lit(label))
                .select(col("channel"), col(s_item).alias("item"),
                        Divide(col("ret_qty"),
                               col("sale_qty")).alias("return_ratio"),
                        col("return_rank"), col("currency_rank")))

    web = channel("web_sales", "web_returns", "ws_item_sk",
                  "ws_order_number", "ws_quantity", "ws_net_paid",
                  "wr_item_sk", "wr_order_number", "wr_return_quantity",
                  "wr_return_amt", "ws_sold_date_sk", "web")
    cat = channel("catalog_sales", "catalog_returns", "cs_item_sk",
                  "cs_order_number", "cs_quantity", "cs_net_paid",
                  "cr_item_sk", "cr_order_number", "cr_return_quantity",
                  "cr_return_amount", "cs_sold_date_sk", "catalog")
    sto = channel("store_sales", "store_returns", "ss_item_sk",
                  "ss_ticket_number", "ss_quantity", "ss_net_paid",
                  "sr_item_sk", "sr_ticket_number", "sr_return_quantity",
                  "sr_return_amt", "ss_sold_date_sk", "store")
    return (web.union(cat).union(sto)
            .sort(SortOrder(col("channel")), SortOrder(col("return_rank")),
                  SortOrder(col("currency_rank")), SortOrder(col("item")))
            .limit(100))

def q67(t):
    """Q67: sales ROLLUP over the full item/date/store hierarchy with a
    per-category rank window (the widest Expand in the suite)."""
    d = t["date_dim"].where(_between(col("d_month_seq"), lit(12), lit(23)))
    base = (t["store_sales"]
            .join(d, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["item"], on=_eq(col("ss_item_sk"), col("i_item_sk")),
                  how="inner")
            .join(t["store"], on=_eq(col("ss_store_sk"),
                                     col("s_store_sk")), how="inner")
            .select(col("i_category"), col("i_class"), col("i_brand"),
                    col("i_product_name"), col("d_year"), col("d_qoy"),
                    col("d_moy"), col("s_store_id"),
                    Multiply(Cast(col("ss_quantity"), T.DOUBLE),
                             col("ss_sales_price")).alias("sales_amt")))
    agg = (base
           .rollup("i_category", "i_class", "i_brand", "i_product_name",
                   "d_year", "d_qoy", "d_moy", "s_store_id")
           .agg(_sum(col("sales_amt"), "sumsales")))
    w = (Window.partition_by("i_category")
         .order_by(SortOrder(col("sumsales"), ascending=False)))
    return (agg
            .with_column("rk", over(Rank(), w))
            .where(P.LessThanOrEqual(col("rk"), lit(10)))
            .sort(SortOrder(col("i_category")), SortOrder(col("rk")),
                  SortOrder(col("sumsales"), ascending=False),
                  SortOrder(col("i_product_name")),
                  SortOrder(col("s_store_id")),
                  # full tie-break: equal (rank, sumsales) rollup rows
                  # otherwise make the LIMIT row set engine-dependent
                  SortOrder(col("i_class")), SortOrder(col("i_brand")),
                  SortOrder(col("d_year")), SortOrder(col("d_qoy")),
                  SortOrder(col("d_moy")))
            .limit(100))

def q70(t):
    """Q70: profit ROLLUP over state/county, restricted to the top-5
    profit states (rank-window subquery gate)."""
    d = t["date_dim"].where(_between(col("d_month_seq"), lit(12), lit(23)))
    state_rank_w = Window.partition_by().order_by(
        SortOrder(col("state_profit"), ascending=False))
    top_states = (t["store_sales"]
                  .join(d, on=_eq(col("ss_sold_date_sk"),
                                  col("d_date_sk")), how="inner")
                  .join(t["store"], on=_eq(col("ss_store_sk"),
                                           col("s_store_sk")),
                        how="inner")
                  .group_by(col("s_state"))
                  .agg(_sum(col("ss_net_profit"), "state_profit"))
                  .with_column("state_rank", over(Rank(), state_rank_w))
                  .where(P.LessThanOrEqual(col("state_rank"), lit(5)))
                  .select(col("s_state").alias("top_state")))
    base = (t["store_sales"]
            .join(d, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["store"], on=_eq(col("ss_store_sk"),
                                     col("s_store_sk")), how="inner")
            .join(top_states, on=_eq(col("s_state"), col("top_state")),
                  how="left_semi"))
    return (base
            .rollup("s_state", "s_county", grouping_id="lochierarchy")
            .agg(_sum(col("ss_net_profit"), "total_sum"))
            .sort(SortOrder(col("lochierarchy"), ascending=False),
                  SortOrder(col("s_state")), SortOrder(col("s_county")),
                  SortOrder(col("total_sum")))
            .limit(100))

# ---------------------------------------------------------------------------
# Rollups over channels with left joins to returns
# ---------------------------------------------------------------------------

def q77(t):
    """Q77: per-channel sales & returns profit with a channel/id ROLLUP
    grand total (Expand over a three-channel union)."""
    d = t["date_dim"].where(_between(col("d_date_sk"), lit(730), lit(760)))

    def sales_leg(fact, date_col, key, price, profit, key_out):
        return (t[fact]
                .join(d, on=_eq(col(date_col), col("d_date_sk")),
                      how="inner")
                .group_by(col(key))
                .agg(_sum(col(price), "sales"),
                     _sum(col(profit), "profit"))
                .select(col(key).alias(key_out), col("sales"),
                        col("profit")))

    def returns_leg(fact, date_col, key, amt, loss, key_out):
        return (t[fact]
                .join(d, on=_eq(col(date_col), col("d_date_sk")),
                      how="inner")
                .group_by(col(key))
                .agg(_sum(col(amt), "returns_"),
                     _sum(col(loss), "profit_loss"))
                .select(col(key).alias(key_out), col("returns_"),
                        col("profit_loss")))

    ss = sales_leg("store_sales", "ss_sold_date_sk", "ss_store_sk",
                   "ss_ext_sales_price", "ss_net_profit", "ss_key")
    sr = returns_leg("store_returns", "sr_returned_date_sk", "sr_store_sk",
                     "sr_return_amt", "sr_net_loss", "sr_key")
    store_ch = (ss.join(sr, on=_eq(col("ss_key"), col("sr_key")),
                        how="left")
                .select(lit("store channel").alias("channel"),
                        col("ss_key").alias("id"), col("sales"),
                        Coalesce(col("returns_"),
                                 lit(0.0)).alias("returns_"),
                        Subtract(col("profit"),
                                 Coalesce(col("profit_loss"),
                                          lit(0.0))).alias("profit")))
    cs = sales_leg("catalog_sales", "cs_sold_date_sk",
                   "cs_call_center_sk", "cs_ext_sales_price",
                   "cs_net_profit", "cs_key")
    cr = returns_leg("catalog_returns", "cr_returned_date_sk",
                     "cr_call_center_sk", "cr_return_amount",
                     "cr_net_loss", "cr_key")
    cat_ch = (cs.join(cr, on=_eq(col("cs_key"), col("cr_key")),
                      how="left")
              .select(lit("catalog channel").alias("channel"),
                      col("cs_key").alias("id"), col("sales"),
                      Coalesce(col("returns_"),
                               lit(0.0)).alias("returns_"),
                      Subtract(col("profit"),
                               Coalesce(col("profit_loss"),
                                        lit(0.0))).alias("profit")))
    ws = sales_leg("web_sales", "ws_sold_date_sk", "ws_web_page_sk",
                   "ws_ext_sales_price", "ws_net_profit", "ws_key")
    wr = returns_leg("web_returns", "wr_returned_date_sk",
                     "wr_web_page_sk", "wr_return_amt", "wr_net_loss",
                     "wr_key")
    web_ch = (ws.join(wr, on=_eq(col("ws_key"), col("wr_key")),
                      how="left")
              .select(lit("web channel").alias("channel"),
                      col("ws_key").alias("id"), col("sales"),
                      Coalesce(col("returns_"),
                               lit(0.0)).alias("returns_"),
                      Subtract(col("profit"),
                               Coalesce(col("profit_loss"),
                                        lit(0.0))).alias("profit")))
    return (store_ch.union(cat_ch).union(web_ch)
            .rollup("channel", "id")
            .agg(_sum(col("sales"), "sales_sum"),
                 _sum(col("returns_"), "returns_sum"),
                 _sum(col("profit"), "profit_sum"))
            .sort(SortOrder(col("channel")), SortOrder(col("id")),
                  SortOrder(col("sales_sum")))
            .limit(100))

def q80(t):
    """Q80: channel sales net of returns with promo gate and a
    channel/id ROLLUP."""
    d = t["date_dim"].where(_between(col("d_date_sk"), lit(730), lit(760)))
    promo = t["promotion"].where(_eq(col("p_channel_email"), lit("N")))

    def leg(fact, ret, date_col, key, item_col, promo_col, price, profit,
            r_key1, r_key2, s_key1, s_key2, r_amt, r_loss, label, id_col):
        r = t[ret].select(col(r_key1).alias("rk1"),
                          col(r_key2).alias("rk2"),
                          col(r_amt).alias("r_amt"),
                          col(r_loss).alias("r_loss"))
        return (t[fact]
                .join(d, on=_eq(col(date_col), col("d_date_sk")),
                      how="inner")
                .join(t["item"].where(P.GreaterThan(
                    col("i_current_price"), lit(50.0))),
                    on=_eq(col(item_col), col("i_item_sk")), how="inner")
                .join(promo, on=_eq(col(promo_col), col("p_promo_sk")),
                      how="left_semi")
                .join(r, on=P.And(_eq(col(s_key1), col("rk1")),
                                  _eq(col(s_key2), col("rk2"))),
                      how="left")
                .group_by(col(key))
                .agg(_sum(col(price), "sales"),
                     _sum(Coalesce(col("r_amt"), lit(0.0)), "returns_"),
                     _sum(Subtract(col(profit),
                                   Coalesce(col("r_loss"), lit(0.0))),
                          "profit"))
                .select(lit(label).alias("channel"),
                        col(key).alias("id"), col("sales"),
                        col("returns_"), col("profit")))

    store = leg("store_sales", "store_returns", "ss_sold_date_sk",
                "ss_store_sk", "ss_item_sk", "ss_promo_sk",
                "ss_ext_sales_price", "ss_net_profit",
                "sr_ticket_number", "sr_item_sk", "ss_ticket_number",
                "ss_item_sk", "sr_return_amt", "sr_net_loss",
                "store channel", "ss_store_sk")
    cat = leg("catalog_sales", "catalog_returns", "cs_sold_date_sk",
              "cs_catalog_page_sk", "cs_item_sk", "cs_promo_sk",
              "cs_ext_sales_price", "cs_net_profit",
              "cr_order_number", "cr_item_sk", "cs_order_number",
              "cs_item_sk", "cr_return_amount", "cr_net_loss",
              "catalog channel", "cs_catalog_page_sk")
    web = leg("web_sales", "web_returns", "ws_sold_date_sk",
              "ws_web_site_sk", "ws_item_sk", "ws_promo_sk",
              "ws_ext_sales_price", "ws_net_profit",
              "wr_order_number", "wr_item_sk", "ws_order_number",
              "ws_item_sk", "wr_return_amt", "wr_net_loss",
              "web channel", "ws_web_site_sk")
    return (store.union(cat).union(web)
            .rollup("channel", "id")
            .agg(_sum(col("sales"), "sales_sum"),
                 _sum(col("returns_"), "returns_sum"),
                 _sum(col("profit"), "profit_sum"))
            .sort(SortOrder(col("channel")), SortOrder(col("id")),
                  SortOrder(col("sales_sum")))
            .limit(100))

# ---------------------------------------------------------------------------
# Year-over-year self joins of one aggregate
# ---------------------------------------------------------------------------

def q2(t):
    """Q2: web+catalog weekly revenue by day of week, year-over-year
    ratios via a week_seq self-join."""
    wscs = (t["web_sales"]
            .select(col("ws_sold_date_sk").alias("sold_date_sk"),
                    col("ws_ext_sales_price").alias("sales_price"))
            .union(t["catalog_sales"]
                   .select(col("cs_sold_date_sk").alias("sold_date_sk"),
                           col("cs_ext_sales_price").alias("sales_price"))))

    def day_sum(day, name):
        return _sum(If(_eq(col("d_day_name"), lit(day)),
                       col("sales_price"), lit(0.0)), name)

    wswscs = (wscs
              .join(t["date_dim"],
                    on=_eq(col("sold_date_sk"), col("d_date_sk")),
                    how="inner")
              .group_by(col("d_week_seq"))
              .agg(day_sum("Sunday", "sun_sales"),
                   day_sum("Monday", "mon_sales"),
                   day_sum("Tuesday", "tue_sales"),
                   day_sum("Wednesday", "wed_sales"),
                   day_sum("Thursday", "thu_sales"),
                   day_sum("Friday", "fri_sales"),
                   day_sum("Saturday", "sat_sales")))
    weeks_y1 = (t["date_dim"].where(_eq(col("d_year"), lit(1998)))
                .select(col("d_week_seq").alias("w1")).distinct())
    weeks_y2 = (t["date_dim"].where(_eq(col("d_year"), lit(1999)))
                .select(col("d_week_seq").alias("w2")).distinct())
    y = (wswscs.join(weeks_y1, on=_eq(col("d_week_seq"), col("w1")),
                     how="inner")
         .select(col("d_week_seq").alias("wk1"),
                 col("sun_sales").alias("sun1"),
                 col("mon_sales").alias("mon1"),
                 col("tue_sales").alias("tue1"),
                 col("wed_sales").alias("wed1"),
                 col("thu_sales").alias("thu1"),
                 col("fri_sales").alias("fri1"),
                 col("sat_sales").alias("sat1")))
    z = (wswscs.join(weeks_y2, on=_eq(col("d_week_seq"), col("w2")),
                     how="inner")
         .select(col("d_week_seq").alias("wk2"),
                 col("sun_sales").alias("sun2"),
                 col("mon_sales").alias("mon2"),
                 col("tue_sales").alias("tue2"),
                 col("wed_sales").alias("wed2"),
                 col("thu_sales").alias("thu2"),
                 col("fri_sales").alias("fri2"),
                 col("sat_sales").alias("sat2")))
    return (y.join(z, on=_eq(col("wk1"),
                             Subtract(col("wk2"), lit(52))),
                   how="inner")
            .select(col("wk1"),
                    Divide(col("sun1"), col("sun2")).alias("r_sun"),
                    Divide(col("mon1"), col("mon2")).alias("r_mon"),
                    Divide(col("tue1"), col("tue2")).alias("r_tue"),
                    Divide(col("wed1"), col("wed2")).alias("r_wed"),
                    Divide(col("thu1"), col("thu2")).alias("r_thu"),
                    Divide(col("fri1"), col("fri2")).alias("r_fri"),
                    Divide(col("sat1"), col("sat2")).alias("r_sat"))
            .sort(SortOrder(col("wk1")))
            .limit(100))

def q4(t):
    """Q4: customers whose catalog yearly spend grew faster than BOTH
    store and web spend — q11's shape widened to all three channels
    (six per-customer year totals; TpcdsLikeSpark.scala q4)."""
    def net(pre):
        return Divide(
            Add(Subtract(Subtract(col(pre + "_ext_list_price"),
                                  col(pre + "_ext_wholesale_cost")),
                         col(pre + "_ext_discount_amt")),
                col(pre + "_ext_sales_price")), lit(2.0))

    def year_total(fact, pre, cust, date, year, name):
        d = t["date_dim"].where(_eq(col("d_year"), lit(year)))
        return (t[fact]
                .join(d, on=_eq(col(date), col("d_date_sk")), how="inner")
                .with_column("_net", net(pre))
                .group_by(col(cust))
                .agg(_sum(col("_net"), name))
                .select(col(cust).alias(name + "_cust"), col(name)))

    ss1 = year_total("store_sales", "ss", "ss_customer_sk",
                     "ss_sold_date_sk", 1998, "ss_y1")
    ss2 = year_total("store_sales", "ss", "ss_customer_sk",
                     "ss_sold_date_sk", 1999, "ss_y2")
    cs1 = year_total("catalog_sales", "cs", "cs_bill_customer_sk",
                     "cs_sold_date_sk", 1998, "cs_y1")
    cs2 = year_total("catalog_sales", "cs", "cs_bill_customer_sk",
                     "cs_sold_date_sk", 1999, "cs_y2")
    ws1 = year_total("web_sales", "ws", "ws_bill_customer_sk",
                     "ws_sold_date_sk", 1998, "ws_y1")
    ws2 = year_total("web_sales", "ws", "ws_bill_customer_sk",
                     "ws_sold_date_sk", 1999, "ws_y2")
    joined = ss1
    for other, key in [(ss2, "ss_y2_cust"), (cs1, "cs_y1_cust"),
                       (cs2, "cs_y2_cust"), (ws1, "ws_y1_cust"),
                       (ws2, "ws_y2_cust")]:
        joined = joined.join(other, on=_eq(col("ss_y1_cust"), col(key)),
                             how="inner")
    return (joined
            .where(P.And(P.GreaterThan(col("ss_y1"), lit(0.0)),
                         P.And(P.GreaterThan(col("cs_y1"), lit(0.0)),
                               P.GreaterThan(col("ws_y1"), lit(0.0)))))
            .where(P.And(
                P.GreaterThan(Divide(col("cs_y2"), col("cs_y1")),
                              Divide(col("ss_y2"), col("ss_y1"))),
                P.GreaterThan(Divide(col("cs_y2"), col("cs_y1")),
                              Divide(col("ws_y2"), col("ws_y1")))))
            .join(t["customer"],
                  on=_eq(col("ss_y1_cust"), col("c_customer_sk")),
                  how="inner")
            .select(col("c_customer_id"), col("c_first_name"),
                    col("c_last_name"), col("c_preferred_cust_flag"))
            .sort(SortOrder(col("c_customer_id")))
            .limit(100))

def q11(t):
    """Q11: customers whose web yearly spend grew faster than store spend
    (4 per-customer year totals joined, growth-ratio filter)."""
    def year_total(sales, cust, date, price, year, name):
        d = t["date_dim"].where(_eq(col("d_year"), lit(year)))
        return (t[sales]
                .join(d, on=_eq(col(date), col("d_date_sk")), how="inner")
                .group_by(col(cust))
                .agg(_sum(col(price), name))
                .select(col(cust).alias(name + "_cust"), col(name)))

    ss1 = year_total("store_sales", "ss_customer_sk", "ss_sold_date_sk",
                     "ss_ext_list_price", 1998, "ss_y1")
    ss2 = year_total("store_sales", "ss_customer_sk", "ss_sold_date_sk",
                     "ss_ext_list_price", 1999, "ss_y2")
    ws1 = year_total("web_sales", "ws_bill_customer_sk", "ws_sold_date_sk",
                     "ws_ext_list_price", 1998, "ws_y1")
    ws2 = year_total("web_sales", "ws_bill_customer_sk", "ws_sold_date_sk",
                     "ws_ext_list_price", 1999, "ws_y2")
    return (ss1
            .join(ss2, on=_eq(col("ss_y1_cust"), col("ss_y2_cust")),
                  how="inner")
            .join(ws1, on=_eq(col("ss_y1_cust"), col("ws_y1_cust")),
                  how="inner")
            .join(ws2, on=_eq(col("ss_y1_cust"), col("ws_y2_cust")),
                  how="inner")
            .where(P.And(P.GreaterThan(col("ss_y1"), lit(0.0)),
                         P.GreaterThan(col("ws_y1"), lit(0.0))))
            .where(P.GreaterThan(Divide(col("ws_y2"), col("ws_y1")),
                                 Divide(col("ss_y2"), col("ss_y1"))))
            .join(t["customer"],
                  on=_eq(col("ss_y1_cust"), col("c_customer_sk")),
                  how="inner")
            .select(col("c_customer_id"), col("c_first_name"),
                    col("c_last_name"))
            .sort(SortOrder(col("c_customer_id")))
            .limit(100))

def q31(t):
    """Q31: counties where web sales grew faster than store sales across
    consecutive quarters (six quarter legs joined on county)."""
    def leg(fact, date_col, cust_addr, price, qoy, name):
        d = t["date_dim"].where(P.And(_eq(col("d_qoy"), lit(qoy)),
                                      _eq(col("d_year"), lit(2000))))
        return (t[fact]
                .join(d, on=_eq(col(date_col), col("d_date_sk")),
                      how="inner")
                .join(t["customer_address"],
                      on=_eq(col(cust_addr), col("ca_address_sk")),
                      how="inner")
                .group_by(col("ca_county"))
                .agg(_sum(col(price), name))
                .select(col("ca_county").alias(name + "_cty"), col(name)))

    ss1 = leg("store_sales", "ss_sold_date_sk", "ss_addr_sk",
              "ss_ext_sales_price", 1, "ss_q1")
    ss2 = leg("store_sales", "ss_sold_date_sk", "ss_addr_sk",
              "ss_ext_sales_price", 2, "ss_q2")
    ss3 = leg("store_sales", "ss_sold_date_sk", "ss_addr_sk",
              "ss_ext_sales_price", 3, "ss_q3")
    ws1 = leg("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk",
              "ws_ext_sales_price", 1, "ws_q1")
    ws2 = leg("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk",
              "ws_ext_sales_price", 2, "ws_q2")
    ws3 = leg("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk",
              "ws_ext_sales_price", 3, "ws_q3")
    return (ss1
            .join(ss2, on=_eq(col("ss_q1_cty"), col("ss_q2_cty")),
                  how="inner")
            .join(ss3, on=_eq(col("ss_q1_cty"), col("ss_q3_cty")),
                  how="inner")
            .join(ws1, on=_eq(col("ss_q1_cty"), col("ws_q1_cty")),
                  how="inner")
            .join(ws2, on=_eq(col("ss_q1_cty"), col("ws_q2_cty")),
                  how="inner")
            .join(ws3, on=_eq(col("ss_q1_cty"), col("ws_q3_cty")),
                  how="inner")
            .where(P.And(P.GreaterThan(col("ss_q1"), lit(0.0)),
                         P.GreaterThan(col("ws_q1"), lit(0.0))))
            .where(P.And(
                P.GreaterThan(Divide(col("ws_q2"), col("ws_q1")),
                              Divide(col("ss_q2"), col("ss_q1"))),
                P.GreaterThan(Divide(col("ws_q3"), col("ws_q2")),
                              Divide(col("ss_q3"), col("ss_q2")))))
            .select(col("ss_q1_cty").alias("county"),
                    Divide(col("ws_q2"), col("ws_q1")).alias("web_g1"),
                    Divide(col("ss_q2"), col("ss_q1")).alias("store_g1"))
            .sort(SortOrder(col("county")))
            .limit(100))

def q74(t):
    """Q74: q11's year-over-year growth comparison on net paid."""
    def year_total(sales, cust, date, price, year, name):
        d = t["date_dim"].where(_eq(col("d_year"), lit(year)))
        return (t[sales]
                .join(d, on=_eq(col(date), col("d_date_sk")), how="inner")
                .group_by(col(cust))
                .agg(_sum(col(price), name))
                .select(col(cust).alias(name + "_cust"), col(name)))

    ss1 = year_total("store_sales", "ss_customer_sk", "ss_sold_date_sk",
                     "ss_net_paid", 1998, "ss_y1")
    ss2 = year_total("store_sales", "ss_customer_sk", "ss_sold_date_sk",
                     "ss_net_paid", 1999, "ss_y2")
    ws1 = year_total("web_sales", "ws_bill_customer_sk", "ws_sold_date_sk",
                     "ws_net_paid", 1998, "ws_y1")
    ws2 = year_total("web_sales", "ws_bill_customer_sk", "ws_sold_date_sk",
                     "ws_net_paid", 1999, "ws_y2")
    return (ss1
            .join(ss2, on=_eq(col("ss_y1_cust"), col("ss_y2_cust")),
                  how="inner")
            .join(ws1, on=_eq(col("ss_y1_cust"), col("ws_y1_cust")),
                  how="inner")
            .join(ws2, on=_eq(col("ss_y1_cust"), col("ws_y2_cust")),
                  how="inner")
            .where(P.And(P.GreaterThan(col("ss_y1"), lit(0.0)),
                         P.GreaterThan(col("ws_y1"), lit(0.0))))
            .where(P.GreaterThan(Divide(col("ws_y2"), col("ws_y1")),
                                 Divide(col("ss_y2"), col("ss_y1"))))
            .join(t["customer"],
                  on=_eq(col("ss_y1_cust"), col("c_customer_sk")),
                  how="inner")
            .select(col("c_customer_id"), col("c_first_name"),
                    col("c_last_name"))
            .sort(SortOrder(col("c_customer_id")))
            .limit(100))

# ---------------------------------------------------------------------------
# EXISTS and NOT EXISTS as semi and anti joins
# ---------------------------------------------------------------------------

def q10(t):
    """Q10: demographics of county residents with store sales in a
    quarter AND (web OR catalog) activity — EXISTS -> left-semi, the OR
    of two EXISTS -> semi against the union of both channels' customer
    sets (TpcdsLikeSpark.scala q10)."""
    d = t["date_dim"].where(P.And(_eq(col("d_year"), lit(1999)),
                                  P.LessThanOrEqual(col("d_moy"), lit(4))))

    def active(fact, date_col, cust_col):
        return (t[fact]
                .join(d, on=_eq(col(date_col), col("d_date_sk")),
                      how="inner")
                .select(col(cust_col).alias("act_sk")).distinct())

    either = active("web_sales", "ws_sold_date_sk",
                    "ws_bill_customer_sk").union(
        active("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk")) \
        .distinct()
    cust = (t["customer"]
            .join(t["customer_address"].where(
                P.In(col("ca_city"), ["Fairview", "Midway", "Riverside"])),
                on=_eq(col("c_current_addr_sk"), col("ca_address_sk")),
                how="inner")
            .join(active("store_sales", "ss_sold_date_sk",
                         "ss_customer_sk")
                  .select(col("act_sk").alias("ss_act")),
                  on=_eq(col("c_customer_sk"), col("ss_act")),
                  how="left_semi")
            .join(either, on=_eq(col("c_customer_sk"), col("act_sk")),
                  how="left_semi")
            .join(t["customer_demographics"],
                  on=_eq(col("c_current_cdemo_sk"), col("cd_demo_sk")),
                  how="inner"))
    return (cust
            .group_by(col("cd_gender"), col("cd_marital_status"),
                      col("cd_education_status"), col("cd_dep_count"))
            .agg(_cnt("cnt1"))
            .sort(SortOrder(col("cd_gender")),
                  SortOrder(col("cd_marital_status")),
                  SortOrder(col("cd_education_status")),
                  SortOrder(col("cd_dep_count")))
            .limit(100))

def q16(t):
    """Q16: catalog orders shipped from 2+ warehouses with no return
    (EXISTS -> left-semi on multi-warehouse orders, NOT EXISTS ->
    left-anti on returns), ship-cost / profit totals + order count."""
    base = (t["catalog_sales"]
            .join(t["date_dim"].where(_between(col("d_date_sk"), lit(750),
                                               lit(810))),
                  on=_eq(col("cs_ship_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["customer_address"].where(_eq(col("ca_state"),
                                                  lit("GA"))),
                  on=_eq(col("cs_ship_addr_sk"), col("ca_address_sk")),
                  how="inner")
            .join(t["call_center"],
                  on=_eq(col("cs_call_center_sk"),
                         col("cc_call_center_sk")),
                  how="inner"))
    multi_wh = (t["catalog_sales"]
                .select(col("cs_order_number").alias("mw_order"),
                        col("cs_warehouse_sk").alias("mw_wh"))
                .distinct()
                .group_by(col("mw_order"))
                .agg(_cnt("wh_cnt"))
                .where(P.GreaterThanOrEqual(col("wh_cnt"), lit(2))))
    filtered = (base
                .join(multi_wh,
                      on=_eq(col("cs_order_number"), col("mw_order")),
                      how="left_semi")
                .join(t["catalog_returns"],
                      on=_eq(col("cs_order_number"),
                             col("cr_order_number")),
                      how="left_anti"))
    totals = (filtered.group_by()
              .agg(_sum(col("cs_ext_ship_cost"), "total_ship"),
                   _sum(col("cs_net_profit"), "total_profit")))
    orders = (filtered.select(col("cs_order_number")).distinct()
              .group_by().agg(_cnt("order_count")))
    return orders.join(totals, how="cross")

def q35(t):
    """Q35: q10's activity gate (store AND (web OR catalog)) with
    demographic stats (count + min/max/avg of dependents) grouped by
    gender/marital/dependents (TpcdsLikeSpark.scala q35)."""
    d = t["date_dim"].where(P.And(_eq(col("d_year"), lit(1999)),
                                  P.LessThanOrEqual(col("d_qoy"), lit(3))))

    def active(fact, date_col, cust_col):
        return (t[fact]
                .join(d, on=_eq(col(date_col), col("d_date_sk")),
                      how="inner")
                .select(col(cust_col).alias("act_sk")).distinct())

    either = active("web_sales", "ws_sold_date_sk",
                    "ws_bill_customer_sk").union(
        active("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk")) \
        .distinct()
    dep = Cast(col("cd_dep_count"), T.DOUBLE)
    return (t["customer"]
            .join(active("store_sales", "ss_sold_date_sk",
                         "ss_customer_sk")
                  .select(col("act_sk").alias("ss_act")),
                  on=_eq(col("c_customer_sk"), col("ss_act")),
                  how="left_semi")
            .join(either, on=_eq(col("c_customer_sk"), col("act_sk")),
                  how="left_semi")
            .join(t["customer_address"],
                  on=_eq(col("c_current_addr_sk"), col("ca_address_sk")),
                  how="inner")
            .join(t["customer_demographics"],
                  on=_eq(col("c_current_cdemo_sk"), col("cd_demo_sk")),
                  how="inner")
            .group_by(col("ca_state"), col("cd_gender"),
                      col("cd_marital_status"), col("cd_dep_count"))
            .agg(_cnt("cnt1"),
                 A.AggregateExpression(A.Min(dep), "min_dep"),
                 A.AggregateExpression(A.Max(dep), "max_dep"),
                 _avg(dep, "avg_dep"))
            .sort(SortOrder(col("ca_state")), SortOrder(col("cd_gender")),
                  SortOrder(col("cd_marital_status")),
                  SortOrder(col("cd_dep_count")))
            .limit(100))

def q69(t):
    """Q69: demographics of store customers absent from web and catalog
    in the period (semi + double anti joins)."""
    d = t["date_dim"].where(P.And(_eq(col("d_year"), lit(1999)),
                                  P.LessThanOrEqual(col("d_qoy"),
                                                    lit(2))))
    ss_cust = (t["store_sales"]
               .join(d, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                     how="inner")
               .select(col("ss_customer_sk").alias("active_sk"))
               .distinct())
    ws_cust = (t["web_sales"]
               .join(d, on=_eq(col("ws_sold_date_sk"), col("d_date_sk")),
                     how="inner")
               .select(col("ws_bill_customer_sk").alias("web_sk"))
               .distinct())
    cs_cust = (t["catalog_sales"]
               .join(d, on=_eq(col("cs_sold_date_sk"), col("d_date_sk")),
                     how="inner")
               .select(col("cs_bill_customer_sk").alias("cat_sk"))
               .distinct())
    return (t["customer"]
            .join(t["customer_address"].where(P.In(col("ca_state"),
                                                   ["KY", "GA", "NM"])),
                  on=_eq(col("c_current_addr_sk"), col("ca_address_sk")),
                  how="inner")
            .join(ss_cust, on=_eq(col("c_customer_sk"), col("active_sk")),
                  how="left_semi")
            .join(ws_cust, on=_eq(col("c_customer_sk"), col("web_sk")),
                  how="left_anti")
            .join(cs_cust, on=_eq(col("c_customer_sk"), col("cat_sk")),
                  how="left_anti")
            .join(t["customer_demographics"],
                  on=_eq(col("c_current_cdemo_sk"), col("cd_demo_sk")),
                  how="inner")
            .group_by(col("cd_gender"), col("cd_marital_status"),
                      col("cd_education_status"))
            .agg(_cnt("cnt"))
            .sort(SortOrder(col("cd_gender")),
                  SortOrder(col("cd_marital_status")),
                  SortOrder(col("cd_education_status")))
            .limit(100))

def q94(t):
    """Q94: web orders shipped from 2+ warehouses with no return — q16's
    EXISTS/NOT-EXISTS shape on the web channel (TpcdsLikeSpark.scala
    q94)."""
    base = (t["web_sales"]
            .join(t["date_dim"].where(_between(col("d_date_sk"), lit(400),
                                               lit(460))),
                  on=_eq(col("ws_ship_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["customer_address"].where(_eq(col("ca_state"),
                                                  lit("CA"))),
                  on=_eq(col("ws_ship_addr_sk"), col("ca_address_sk")),
                  how="inner")
            .join(t["web_site"],
                  on=_eq(col("ws_web_site_sk"), col("web_site_sk")),
                  how="inner"))
    multi_wh = (t["web_sales"]
                .select(col("ws_order_number").alias("mw_order"),
                        col("ws_warehouse_sk").alias("mw_wh"))
                .distinct()
                .group_by(col("mw_order"))
                .agg(_cnt("wh_cnt"))
                .where(P.GreaterThanOrEqual(col("wh_cnt"), lit(2))))
    filtered = (base
                .join(multi_wh,
                      on=_eq(col("ws_order_number"), col("mw_order")),
                      how="left_semi")
                .join(t["web_returns"],
                      on=_eq(col("ws_order_number"),
                             col("wr_order_number")),
                      how="left_anti"))
    totals = (filtered.group_by()
              .agg(_sum(col("ws_ext_ship_cost"), "total_ship"),
                   _sum(col("ws_net_profit"), "total_profit")))
    orders = (filtered.select(col("ws_order_number")).distinct()
              .group_by().agg(_cnt("order_count")))
    return orders.join(totals, how="cross")

def q95(t):
    """Q95: q94's base but BOTH gates positive — orders in the
    multi-warehouse pair set AND with a return from that set
    (TpcdsLikeSpark.scala q95)."""
    pairs = (t["web_sales"]
             .select(col("ws_order_number").alias("p_order"),
                     col("ws_warehouse_sk").alias("p_wh"))
             .distinct()
             .group_by(col("p_order"))
             .agg(_cnt("wh_cnt"))
             .where(P.GreaterThanOrEqual(col("wh_cnt"), lit(2)))
             .select(col("p_order")))
    returned = (t["web_returns"]
                .join(pairs, on=_eq(col("wr_order_number"),
                                    col("p_order")), how="left_semi")
                .select(col("wr_order_number").alias("r_order"))
                .distinct())
    base = (t["web_sales"]
            .join(t["date_dim"].where(_between(col("d_date_sk"), lit(400),
                                               lit(460))),
                  on=_eq(col("ws_ship_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["customer_address"].where(_eq(col("ca_state"),
                                                  lit("CA"))),
                  on=_eq(col("ws_ship_addr_sk"), col("ca_address_sk")),
                  how="inner")
            .join(t["web_site"],
                  on=_eq(col("ws_web_site_sk"), col("web_site_sk")),
                  how="inner")
            .join(pairs, on=_eq(col("ws_order_number"), col("p_order")),
                  how="left_semi")
            .join(returned, on=_eq(col("ws_order_number"),
                                   col("r_order")), how="left_semi"))
    totals = (base.group_by()
              .agg(_sum(col("ws_ext_ship_cost"), "total_ship"),
                   _sum(col("ws_net_profit"), "total_profit")))
    orders = (base.select(col("ws_order_number")).distinct()
              .group_by().agg(_cnt("order_count")))
    return orders.join(totals, how="cross")

# ---------------------------------------------------------------------------
# Scalar thresholds from subqueries
# ---------------------------------------------------------------------------

def q23(t):
    """Q23 (iceberg): month catalog+web sales restricted to frequently
    sold store items AND best store customers (>95% of the max customer
    spend — max via scalar cross join), summed across both channels
    (TpcdsLikeSpark.scala q23a)."""
    years = _between(col("d_year"), lit(1998), lit(2000))
    freq_items = (t["store_sales"]
                  .join(t["date_dim"].where(years),
                        on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                        how="inner")
                  .group_by(col("ss_item_sk"), col("d_date"))
                  .agg(_cnt("day_cnt"))
                  .group_by(col("ss_item_sk"))
                  .agg(_sum(col("day_cnt"), "solddates"))
                  .where(P.GreaterThan(col("solddates"), lit(4)))
                  .select(col("ss_item_sk").alias("fi_sk")))
    spend = (t["store_sales"]
             .join(t["date_dim"].where(years),
                   on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                   how="inner")
             .with_column("_amt", Multiply(Cast(col("ss_quantity"),
                                                T.DOUBLE),
                                           col("ss_sales_price")))
             .group_by(col("ss_customer_sk"))
             .agg(_sum(col("_amt"), "csales")))
    tpcds_cmax = spend.group_by().agg(
        A.AggregateExpression(A.Max(col("csales")), "tpcds_cmax"))
    best_cust = (spend.join(tpcds_cmax, how="cross")
                 .where(P.GreaterThan(
                     col("csales"),
                     Multiply(lit(0.5), col("tpcds_cmax"))))
                 .select(col("ss_customer_sk").alias("bc_sk")))
    d = t["date_dim"].where(P.And(_eq(col("d_year"), lit(2000)),
                                  _eq(col("d_moy"), lit(3))))

    def leg(fact, date_col, cust_col, item_col, qty, price):
        return (t[fact]
                .join(d, on=_eq(col(date_col), col("d_date_sk")),
                      how="inner")
                .join(freq_items, on=_eq(col(item_col), col("fi_sk")),
                      how="left_semi")
                .join(best_cust, on=_eq(col(cust_col), col("bc_sk")),
                      how="left_semi")
                .select(Multiply(Cast(col(qty), T.DOUBLE),
                                 col(price)).alias("sales")))

    return (leg("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk",
                "cs_item_sk", "cs_quantity", "cs_list_price")
            .union(leg("web_sales", "ws_sold_date_sk",
                       "ws_bill_customer_sk", "ws_item_sk", "ws_quantity",
                       "ws_list_price"))
            .group_by().agg(_sum(col("sales"), "total")))

def q24(t):
    """Q24: returned store purchases where the customer's zip differs
    from the store's, net paid by customer/store/manufacturer, kept
    above 5% of the overall mean (correlated scalar -> aggregate cross
    join; TpcdsLikeSpark.scala q24a, i_color expressed over i_manufact
    which plays the low-cardinality attribute role in this datagen)."""
    ssales = (t["store_sales"]
              .join(t["store_returns"],
                    on=P.And(_eq(col("ss_ticket_number"),
                                 col("sr_ticket_number")),
                             _eq(col("ss_item_sk"), col("sr_item_sk"))),
                    how="inner")
              .join(t["store"], on=_eq(col("ss_store_sk"),
                                       col("s_store_sk")), how="inner")
              .join(t["item"], on=_eq(col("ss_item_sk"),
                                      col("i_item_sk")), how="inner")
              .join(t["customer"],
                    on=_eq(col("ss_customer_sk"), col("c_customer_sk")),
                    how="inner")
              .join(t["customer_address"],
                    on=_eq(col("c_current_addr_sk"),
                           col("ca_address_sk")), how="inner")
              .where(P.Not(_eq(col("ca_zip"), col("s_zip"))))
              .group_by(col("c_last_name"), col("c_first_name"),
                        col("s_store_name"), col("i_manufact"))
              .agg(_sum(col("ss_net_paid"), "netpaid")))
    avg_np = ssales.group_by().agg(_avg(col("netpaid"), "avg_netpaid"))
    return (ssales.join(avg_np, how="cross")
            .where(P.GreaterThan(col("netpaid"),
                                 Multiply(lit(0.05), col("avg_netpaid"))))
            .select(col("c_last_name"), col("c_first_name"),
                    col("s_store_name"), col("i_manufact"),
                    col("netpaid"))
            .sort(SortOrder(col("c_last_name")),
                  SortOrder(col("c_first_name")),
                  SortOrder(col("s_store_name")),
                  SortOrder(col("i_manufact"))))



# ---------------------------------------------------------------------------
# The last 33: one-table and scalar-ratio queries (q9, q28, q90, q32, q92,
# q41, q84), star joins with If buckets and Substring (q43, q50, q62, q99,
# q45, q73, q37, q82, q85), averages and deviations joined back (q30, q81,
# q17, q39, q21, q40, q93), channel unions (q33, q56, q60, q66, q76, q54)
# and the large join graphs (q78, q75, q64, q72).
# ---------------------------------------------------------------------------

def q9(t):
    """Q9: five quantity-bucket conditional averages picked by bucket
    population (scalar subqueries -> 1-row cross joins off reason)."""
    buckets = [(1, 20, 74129), (21, 40, 122840), (41, 60, 56580),
               (61, 80, 10097), (81, 100, 165306)]
    legs = None
    for i, (lo, hi, _) in enumerate(buckets, 1):
        leg = (t["store_sales"]
               .where(_between(col("ss_quantity"), lit(lo), lit(hi)))
               .group_by()
               .agg(_cnt(f"cnt{i}"),
                    _avg(col("ss_ext_discount_amt"), f"disc{i}"),
                    _avg(col("ss_net_paid"), f"paid{i}")))
        legs = leg if legs is None else legs.join(leg, how="cross")
    anchor = t["reason"].where(_eq(col("r_reason_sk"), lit(1))) \
        .select(col("r_reason_sk"))
    out = anchor.join(legs, how="cross")
    proj = [If(P.GreaterThan(col(f"cnt{i}"), lit(float(th))),
               col(f"disc{i}"), col(f"paid{i}")).alias(f"bucket{i}")
            for i, (_, _, th) in enumerate(buckets, 1)]
    return out.select(*proj)


def q28(t):
    """Q28: six list-price-bucket (avg, count, distinct-count) legs
    cross-joined (scalar subqueries -> 1-row frames)."""
    bands = [(0, 5, 11, 16), (6, 10, 91, 96), (11, 15, 66, 71),
             (16, 20, 142, 147), (21, 25, 135, 140), (26, 30, 28, 33)]
    legs = None
    for i, (qlo, qhi, plo, phi) in enumerate(bands, 1):
        filt = (t["store_sales"]
                .where(_between(col("ss_quantity"), lit(qlo), lit(qhi)))
                .where(P.Or(
                    _between(col("ss_list_price"), lit(float(plo)),
                             lit(float(phi))),
                    P.Or(_between(col("ss_coupon_amt"), lit(plo * 10.0),
                                  lit(plo * 10.0 + 1000.0)),
                         _between(col("ss_wholesale_cost"), lit(float(qlo)),
                                  lit(qlo + 20.0))))))
        stats = (filt.group_by()
                 .agg(_avg(col("ss_list_price"), f"b{i}_lp"),
                      _cnt(f"b{i}_cnt")))
        distinct = (filt.select(col("ss_list_price")).distinct()
                    .group_by().agg(_cnt(f"b{i}_cntd")))
        leg = stats.join(distinct, how="cross")
        legs = leg if legs is None else legs.join(leg, how="cross")
    return legs


def q90(t):
    """Q90: web AM/PM order ratio (two 1-row counts cross-joined)."""
    hd = t["household_demographics"].where(_eq(col("hd_dep_count"),
                                               lit(3)))
    wp = t["web_page"].where(_between(col("wp_char_count"), lit(2500),
                                      lit(5500)))

    def leg(h_lo, h_hi, name):
        tm = t["time_dim"].where(_between(col("t_hour"), lit(h_lo),
                                          lit(h_hi)))
        return (t["web_sales"]
                .join(tm, on=_eq(col("ws_sold_time_sk"),
                                 col("t_time_sk")), how="left_semi")
                .join(hd, on=_eq(col("ws_bill_hdemo_sk"),
                                 col("hd_demo_sk")), how="left_semi")
                .join(wp, on=_eq(col("ws_web_page_sk"),
                                 col("wp_web_page_sk")), how="left_semi")
                .group_by().agg(_cnt(name)))

    am = leg(8, 9, "amc")
    pm = leg(19, 20, "pmc")
    return (am.join(pm, how="cross")
            .select(Divide(Cast(col("amc"), T.DOUBLE),
                           Cast(col("pmc"), T.DOUBLE))
                    .alias("am_pm_ratio")))


def q32(t):
    """Q32: excess catalog discount — rows above 1.3x their item's
    average discount in a 90-day window (correlated avg -> join)."""
    d = t["date_dim"].where(_between(col("d_date_sk"), lit(700), lit(790)))
    base = (t["catalog_sales"]
            .join(d, on=_eq(col("cs_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["item"].where(_between(col("i_manufact_id"), lit(20),
                                           lit(40))),
                  on=_eq(col("cs_item_sk"), col("i_item_sk")),
                  how="inner"))
    item_avg = (base.group_by(col("cs_item_sk"))
                .agg(_avg(col("cs_ext_discount_amt"), "disc_avg"))
                .select(col("cs_item_sk").alias("ia_item"),
                        col("disc_avg")))
    return (base
            .join(item_avg, on=_eq(col("cs_item_sk"), col("ia_item")),
                  how="inner")
            .where(P.GreaterThan(col("cs_ext_discount_amt"),
                                 Multiply(lit(1.3), col("disc_avg"))))
            .group_by()
            .agg(_sum(col("cs_ext_discount_amt"), "excess_discount")))


def q92(t):
    """Q92: excess web discount vs 1.3x the item average (q32's shape on
    the web channel)."""
    d = t["date_dim"].where(_between(col("d_date_sk"), lit(700), lit(790)))
    base = (t["web_sales"]
            .join(d, on=_eq(col("ws_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["item"].where(_between(col("i_manufact_id"), lit(20),
                                           lit(40))),
                  on=_eq(col("ws_item_sk"), col("i_item_sk")),
                  how="inner"))
    item_avg = (base.group_by(col("ws_item_sk"))
                .agg(_avg(col("ws_ext_discount_amt"), "disc_avg"))
                .select(col("ws_item_sk").alias("ia_item"),
                        col("disc_avg")))
    return (base
            .join(item_avg, on=_eq(col("ws_item_sk"), col("ia_item")),
                  how="inner")
            .where(P.GreaterThan(col("ws_ext_discount_amt"),
                                 Multiply(lit(1.3), col("disc_avg"))))
            .group_by()
            .agg(_sum(col("ws_ext_discount_amt"), "excess_discount")))


def q41(t):
    """Q41: distinct product names in a manufact band with a sibling-item
    existence gate (correlated EXISTS -> self semi join)."""
    sibling = (t["item"]
               .where(P.In(col("i_category"), ["Women", "Men", "Shoes"]))
               .select(col("i_manufact").alias("sib_manufact"))
               .distinct())
    return (t["item"]
            .where(_between(col("i_manufact_id"), lit(40), lit(80)))
            .join(sibling, on=_eq(col("i_manufact"), col("sib_manufact")),
                  how="left_semi")
            .select(col("i_product_name")).distinct()
            .sort(SortOrder(col("i_product_name")))
            .limit(100))


def q84(t):
    """Q84: customers in one city within an income band who returned
    something — the dimension-chain join through household demographics
    to income_band (TpcdsLikeSpark.scala q84; the returns tie-in rides
    sr_customer_sk since this datagen's store_returns carries no
    cdemo)."""
    return (t["customer"]
            .join(t["customer_address"].where(_eq(col("ca_city"),
                                                  lit("Midway"))),
                  on=_eq(col("c_current_addr_sk"), col("ca_address_sk")),
                  how="inner")
            .join(t["household_demographics"],
                  on=_eq(col("c_current_hdemo_sk"), col("hd_demo_sk")),
                  how="inner")
            .join(t["income_band"].where(P.And(
                P.GreaterThanOrEqual(col("ib_lower_bound"), lit(20000)),
                P.LessThanOrEqual(col("ib_upper_bound"), lit(70000)))),
                on=_eq(col("hd_income_band_sk"),
                       col("ib_income_band_sk")), how="inner")
            .join(t["customer_demographics"],
                  on=_eq(col("c_current_cdemo_sk"), col("cd_demo_sk")),
                  how="inner")
            .join(t["store_returns"],
                  on=_eq(col("c_customer_sk"), col("sr_customer_sk")),
                  how="left_semi")
            .select(col("c_customer_id"), col("c_first_name"),
                    col("c_last_name"))
            .sort(SortOrder(col("c_customer_id")))
            .limit(100))


def q43(t):
    """Q43: store sales pivoted by day-of-week name per store."""
    d = t["date_dim"].where(_eq(col("d_year"), lit(1998)))

    def day_sum(day, name):
        return _sum(If(_eq(col("d_day_name"), lit(day)),
                       col("ss_sales_price"), lit(0.0)), name)

    return (t["store_sales"]
            .join(d, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["store"], on=_eq(col("ss_store_sk"),
                                     col("s_store_sk")), how="inner")
            .group_by(col("s_store_name"), col("s_store_id"))
            .agg(day_sum("Sunday", "sun_sales"),
                 day_sum("Monday", "mon_sales"),
                 day_sum("Tuesday", "tue_sales"),
                 day_sum("Wednesday", "wed_sales"),
                 day_sum("Thursday", "thu_sales"),
                 day_sum("Friday", "fri_sales"),
                 day_sum("Saturday", "sat_sales"))
            .sort(SortOrder(col("s_store_name")),
                  SortOrder(col("s_store_id")))
            .limit(100))


def q50(t):
    """Q50: sale-to-return latency buckets per store."""
    d2 = t["date_dim"].where(P.And(_eq(col("d_year"), lit(2000)),
                                   _eq(col("d_moy"), lit(8))))
    lat = Subtract(col("sr_returned_date_sk"), col("ss_sold_date_sk"))

    def bucket(cond, name):
        return _sum(If(cond, lit(1), lit(0)), name)

    return (t["store_sales"]
            .join(t["store_returns"],
                  on=P.And(_eq(col("ss_ticket_number"),
                               col("sr_ticket_number")),
                           P.And(_eq(col("ss_item_sk"), col("sr_item_sk")),
                                 _eq(col("ss_customer_sk"),
                                     col("sr_customer_sk")))),
                  how="inner")
            .join(d2, on=_eq(col("sr_returned_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["store"], on=_eq(col("ss_store_sk"),
                                     col("s_store_sk")), how="inner")
            .group_by(col("s_store_name"), col("s_store_id"),
                      col("s_city"), col("s_county"), col("s_state"),
                      col("s_zip"))
            .agg(bucket(P.LessThanOrEqual(lat, lit(30)), "d30"),
                 bucket(P.And(P.GreaterThan(lat, lit(30)),
                              P.LessThanOrEqual(lat, lit(60))), "d60"),
                 bucket(P.And(P.GreaterThan(lat, lit(60)),
                              P.LessThanOrEqual(lat, lit(90))), "d90"),
                 bucket(P.And(P.GreaterThan(lat, lit(90)),
                              P.LessThanOrEqual(lat, lit(120))), "d120"),
                 bucket(P.GreaterThan(lat, lit(120)), "d120plus"))
            .sort(SortOrder(col("s_store_name")),
                  SortOrder(col("s_store_id")))
            .limit(100))


def q62(t):
    """Q62: web shipping-latency buckets by warehouse / ship mode /
    site."""
    d = t["date_dim"].where(_between(col("d_month_seq"), lit(12), lit(23)))
    lat = Subtract(col("ws_ship_date_sk"), col("ws_sold_date_sk"))

    def bucket(cond, name):
        return _sum(If(cond, lit(1), lit(0)), name)

    return (t["web_sales"]
            .join(d, on=_eq(col("ws_ship_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["warehouse"],
                  on=_eq(col("ws_warehouse_sk"), col("w_warehouse_sk")),
                  how="inner")
            .join(t["ship_mode"],
                  on=_eq(col("ws_ship_mode_sk"), col("sm_ship_mode_sk")),
                  how="inner")
            .join(t["web_site"],
                  on=_eq(col("ws_web_site_sk"), col("web_site_sk")),
                  how="inner")
            .group_by(Substring(col("w_warehouse_name"), lit(1),
                                lit(20)).alias("wh"),
                      col("sm_type"), col("web_name"))
            .agg(bucket(P.LessThanOrEqual(lat, lit(30)), "d30"),
                 bucket(P.And(P.GreaterThan(lat, lit(30)),
                              P.LessThanOrEqual(lat, lit(60))), "d60"),
                 bucket(P.And(P.GreaterThan(lat, lit(60)),
                              P.LessThanOrEqual(lat, lit(90))), "d90"),
                 bucket(P.And(P.GreaterThan(lat, lit(90)),
                              P.LessThanOrEqual(lat, lit(120))), "d120"),
                 bucket(P.GreaterThan(lat, lit(120)), "d120plus"))
            .sort(SortOrder(col("wh")), SortOrder(col("sm_type")),
                  SortOrder(col("web_name")))
            .limit(100))


def q99(t):
    """Q99: catalog shipping-latency buckets by warehouse / ship mode /
    call center (q62's shape on the catalog channel)."""
    d = t["date_dim"].where(_between(col("d_month_seq"), lit(12), lit(23)))
    lat = Subtract(col("cs_ship_date_sk"), col("cs_sold_date_sk"))

    def bucket(cond, name):
        return _sum(If(cond, lit(1), lit(0)), name)

    return (t["catalog_sales"]
            .join(d, on=_eq(col("cs_ship_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["warehouse"],
                  on=_eq(col("cs_warehouse_sk"), col("w_warehouse_sk")),
                  how="inner")
            .join(t["ship_mode"],
                  on=_eq(col("cs_ship_mode_sk"), col("sm_ship_mode_sk")),
                  how="inner")
            .join(t["call_center"],
                  on=_eq(col("cs_call_center_sk"),
                         col("cc_call_center_sk")), how="inner")
            .group_by(Substring(col("w_warehouse_name"), lit(1),
                                lit(20)).alias("wh"),
                      col("sm_type"), col("cc_name"))
            .agg(bucket(P.LessThanOrEqual(lat, lit(30)), "d30"),
                 bucket(P.And(P.GreaterThan(lat, lit(30)),
                              P.LessThanOrEqual(lat, lit(60))), "d60"),
                 bucket(P.And(P.GreaterThan(lat, lit(60)),
                              P.LessThanOrEqual(lat, lit(90))), "d90"),
                 bucket(P.And(P.GreaterThan(lat, lit(90)),
                              P.LessThanOrEqual(lat, lit(120))), "d120"),
                 bucket(P.GreaterThan(lat, lit(120)), "d120plus"))
            .sort(SortOrder(col("wh")), SortOrder(col("sm_type")),
                  SortOrder(col("cc_name")))
            .limit(100))


def q45(t):
    """Q45: web revenue by zip/city for listed zip prefixes OR listed
    items (disjunctive gate across a join)."""
    d = t["date_dim"].where(P.And(_eq(col("d_qoy"), lit(2)),
                                  _eq(col("d_year"), lit(2000))))
    zip_ok = P.In(Substring(col("ca_zip"), lit(1), lit(5)),
                  ["85669", "86197", "88274", "83405", "86475"])
    item_ok = P.In(col("i_item_sk"), [2, 3, 5, 7, 11, 13, 17, 19, 23, 29])
    return (t["web_sales"]
            .join(t["customer"],
                  on=_eq(col("ws_bill_customer_sk"), col("c_customer_sk")),
                  how="inner")
            .join(t["customer_address"],
                  on=_eq(col("c_current_addr_sk"), col("ca_address_sk")),
                  how="inner")
            .join(d, on=_eq(col("ws_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["item"], on=_eq(col("ws_item_sk"), col("i_item_sk")),
                  how="inner")
            .where(P.Or(zip_ok, item_ok))
            .group_by(col("ca_zip"), col("ca_city"))
            .agg(_sum(col("ws_sales_price"), "web_sales"))
            .sort(SortOrder(col("ca_zip")), SortOrder(col("ca_city")))
            .limit(100))


def q73(t):
    """Q73: households with 1-5 tickets under demographic gates."""
    d = t["date_dim"].where(P.In(col("d_year"), [1998, 1999]))
    hd = t["household_demographics"].where(P.And(
        P.In(col("hd_buy_potential"), [">10000", "Unknown"]),
        P.GreaterThan(col("hd_vehicle_count"), lit(0))))
    tickets = (t["store_sales"]
               .join(d, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                     how="inner")
               .join(hd, on=_eq(col("ss_hdemo_sk"), col("hd_demo_sk")),
                     how="inner")
               .join(t["store"].where(P.In(col("s_county"),
                                           ["Fairview County",
                                            "Midway County",
                                            "Riverside County"])),
                     on=_eq(col("ss_store_sk"), col("s_store_sk")),
                     how="left_semi")
               .group_by(col("ss_ticket_number"), col("ss_customer_sk"))
               .agg(_cnt("cnt"))
               .where(_between(col("cnt"), lit(1), lit(5))))
    return (tickets
            .join(t["customer"],
                  on=_eq(col("ss_customer_sk"), col("c_customer_sk")),
                  how="inner")
            .select(col("c_last_name"), col("c_first_name"),
                    col("c_salutation"), col("c_preferred_cust_flag"),
                    col("ss_ticket_number"), col("cnt"))
            .sort(SortOrder(col("cnt"), ascending=False),
                  SortOrder(col("c_last_name")),
                  SortOrder(col("ss_ticket_number")))
            .limit(100))


def q37(t):
    """Q37: items with 100-500 on hand in a 60-day window that also sold
    on catalog (inventory gate + semi join)."""
    d = t["date_dim"].where(_between(col("d_date_sk"), lit(700), lit(760)))
    inv_ok = (t["inventory"]
              .where(_between(col("inv_quantity_on_hand"), lit(100),
                              lit(500)))
              .join(d, on=_eq(col("inv_date_sk"), col("d_date_sk")),
                    how="inner")
              .select(col("inv_item_sk")).distinct())
    return (t["item"]
            .where(_between(col("i_current_price"), lit(20.0), lit(50.0)))
            .where(_between(col("i_manufact_id"), lit(30), lit(70)))
            .join(inv_ok, on=_eq(col("i_item_sk"), col("inv_item_sk")),
                  how="left_semi")
            .join(t["catalog_sales"],
                  on=_eq(col("i_item_sk"), col("cs_item_sk")),
                  how="left_semi")
            .select(col("i_item_id"), col("i_item_sk"),
                    col("i_current_price"))
            .group_by(col("i_item_id"))
            .agg(A.AggregateExpression(A.Min(col("i_current_price")),
                                       "min_price"))
            .sort(SortOrder(col("i_item_id")))
            .limit(100))


def q82(t):
    """Q82: q37's inventory-gated item list for the store channel."""
    d = t["date_dim"].where(_between(col("d_date_sk"), lit(700), lit(760)))
    inv_ok = (t["inventory"]
              .where(_between(col("inv_quantity_on_hand"), lit(100),
                              lit(500)))
              .join(d, on=_eq(col("inv_date_sk"), col("d_date_sk")),
                    how="inner")
              .select(col("inv_item_sk")).distinct())
    return (t["item"]
            .where(_between(col("i_current_price"), lit(30.0), lit(60.0)))
            .where(_between(col("i_manufact_id"), lit(10), lit(50)))
            .join(inv_ok, on=_eq(col("i_item_sk"), col("inv_item_sk")),
                  how="left_semi")
            .join(t["store_sales"],
                  on=_eq(col("i_item_sk"), col("ss_item_sk")),
                  how="left_semi")
            .group_by(col("i_item_id"))
            .agg(A.AggregateExpression(A.Min(col("i_current_price")),
                                       "min_price"))
            .sort(SortOrder(col("i_item_id")))
            .limit(100))


def q85(t):
    """Q85: web-return reason stats under paired-demographics and
    address gates."""
    cd1 = (t["customer_demographics"]
           .select(col("cd_demo_sk").alias("cd1_sk"),
                   col("cd_marital_status").alias("cd1_marital"),
                   col("cd_education_status").alias("cd1_edu")))
    cd2 = (t["customer_demographics"]
           .select(col("cd_demo_sk").alias("cd2_sk"),
                   col("cd_marital_status").alias("cd2_marital"),
                   col("cd_education_status").alias("cd2_edu")))
    d = t["date_dim"].where(_eq(col("d_year"), lit(1998)))
    return (t["web_sales"]
            .join(t["web_returns"],
                  on=P.And(_eq(col("ws_order_number"),
                               col("wr_order_number")),
                           _eq(col("ws_item_sk"), col("wr_item_sk"))),
                  how="inner")
            .join(d, on=_eq(col("ws_sold_date_sk"), col("d_date_sk")),
                  how="inner")
            .join(t["web_page"],
                  on=_eq(col("ws_web_page_sk"), col("wp_web_page_sk")),
                  how="inner")
            .join(cd1, on=_eq(col("wr_refunded_cdemo_sk"), col("cd1_sk")),
                  how="inner")
            .join(cd2, on=_eq(col("wr_returning_cdemo_sk"),
                              col("cd2_sk")), how="inner")
            .join(t["customer_address"].where(P.In(col("ca_state"),
                                                   ["CA", "TX", "OH"])),
                  on=_eq(col("wr_refunded_addr_sk"), col("ca_address_sk")),
                  how="inner")
            .join(t["reason"],
                  on=_eq(col("wr_reason_sk"), col("r_reason_sk")),
                  how="inner")
            .where(P.And(_eq(col("cd1_marital"), col("cd2_marital")),
                         _eq(col("cd1_edu"), col("cd2_edu"))))
            .group_by(col("r_reason_desc"))
            .agg(_avg(col("ws_quantity"), "avg_qty"),
                 _avg(col("wr_refunded_cash"), "avg_refund"),
                 _avg(col("wr_fee"), "avg_fee"))
            .sort(SortOrder(col("r_reason_desc")))
            .limit(100))


def q30(t):
    """Q30: web-return customers above 1.2x their state's average
    (q1's shape on the web channel, with customer detail output)."""
    d = t["date_dim"].where(_eq(col("d_year"), lit(2000)))
    ctr = (t["web_returns"]
           .join(d, on=_eq(col("wr_returned_date_sk"), col("d_date_sk")),
                 how="inner")
           .join(t["customer_address"],
                 on=_eq(col("wr_refunded_addr_sk"), col("ca_address_sk")),
                 how="inner")
           .group_by(col("wr_returning_customer_sk"), col("ca_state"))
           .agg(_sum(col("wr_return_amt"), "ctr_total"))
           .select(col("wr_returning_customer_sk").alias("ctr_cust"),
                   col("ca_state").alias("ctr_state"), col("ctr_total")))
    avg_state = (ctr.group_by(col("ctr_state"))
                 .agg(_avg(col("ctr_total"), "state_avg"))
                 .select(col("ctr_state").alias("avg_state"),
                         col("state_avg")))
    return (ctr
            .join(avg_state, on=_eq(col("ctr_state"), col("avg_state")),
                  how="inner")
            .where(P.GreaterThan(col("ctr_total"),
                                 Multiply(lit(1.2), col("state_avg"))))
            .join(t["customer"],
                  on=_eq(col("ctr_cust"), col("c_customer_sk")),
                  how="inner")
            .select(col("c_customer_id"), col("c_salutation"),
                    col("c_first_name"), col("c_last_name"),
                    col("ctr_total"))
            .sort(SortOrder(col("c_customer_id")),
                  SortOrder(col("ctr_total")))
            .limit(100))


def q81(t):
    """Q81: catalog-return customers above 1.2x their state average
    (q30's shape on the catalog channel)."""
    d = t["date_dim"].where(_eq(col("d_year"), lit(2000)))
    ctr = (t["catalog_returns"]
           .join(d, on=_eq(col("cr_returned_date_sk"), col("d_date_sk")),
                 how="inner")
           .join(t["customer_address"],
                 on=_eq(col("cr_returning_addr_sk"), col("ca_address_sk")),
                 how="inner")
           .group_by(col("cr_returning_customer_sk"), col("ca_state"))
           .agg(_sum(col("cr_return_amount"), "ctr_total"))
           .select(col("cr_returning_customer_sk").alias("ctr_cust"),
                   col("ca_state").alias("ctr_state"), col("ctr_total")))
    avg_state = (ctr.group_by(col("ctr_state"))
                 .agg(_avg(col("ctr_total"), "state_avg"))
                 .select(col("ctr_state").alias("avg_state"),
                         col("state_avg")))
    return (ctr
            .join(avg_state, on=_eq(col("ctr_state"), col("avg_state")),
                  how="inner")
            .where(P.GreaterThan(col("ctr_total"),
                                 Multiply(lit(1.2), col("state_avg"))))
            .join(t["customer"],
                  on=_eq(col("ctr_cust"), col("c_customer_sk")),
                  how="inner")
            .select(col("c_customer_id"), col("c_first_name"),
                    col("c_last_name"), col("ctr_total"))
            .sort(SortOrder(col("c_customer_id")),
                  SortOrder(col("ctr_total")))
            .limit(100))


def q17(t):
    """Q17: quantity mean/stdev/cov across the sale -> return ->
    catalog re-purchase chain, by item and state (stdev via the
    sum-of-squares identity on device)."""
    d1 = t["date_dim"].where(P.And(_eq(col("d_year"), lit(1998)),
                                   _eq(col("d_qoy"), lit(1))))
    d23 = t["date_dim"].where(P.And(_eq(col("d_year"), lit(1998)),
                                    P.LessThanOrEqual(col("d_qoy"),
                                                      lit(3))))
    chain = (t["store_sales"]
             .join(d1, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                   how="inner")
             .join(t["store_returns"],
                   on=P.And(
                       _eq(col("ss_ticket_number"),
                           col("sr_ticket_number")),
                       P.And(_eq(col("ss_item_sk"), col("sr_item_sk")),
                             _eq(col("ss_customer_sk"),
                                 col("sr_customer_sk")))),
                   how="inner")
             .join(d23.select(col("d_date_sk").alias("d2_sk")),
                   on=_eq(col("sr_returned_date_sk"), col("d2_sk")),
                   how="inner")
             .join(t["catalog_sales"],
                   on=P.And(_eq(col("sr_customer_sk"),
                                col("cs_bill_customer_sk")),
                            _eq(col("sr_item_sk"), col("cs_item_sk"))),
                   how="inner")
             .join(t["item"], on=_eq(col("ss_item_sk"), col("i_item_sk")),
                   how="inner")
             .join(t["store"], on=_eq(col("ss_store_sk"),
                                      col("s_store_sk")),
                   how="inner"))

    def stats(prefix, qty):
        qd = Cast(col(qty), T.DOUBLE)
        return [_cnt(prefix + "_count"),
                _avg(col(qty), prefix + "_mean"),
                _sum(Multiply(qd, qd), prefix + "_sumsq"),
                _sum(qd, prefix + "_sum")]

    agg = (chain.group_by(col("i_item_id"), col("s_state"))
           .agg(*(stats("ss", "ss_quantity") + stats("sr",
                                                     "sr_return_quantity")
                  + stats("cs", "cs_quantity"))))

    def stdev(prefix):
        n = Cast(col(prefix + "_count"), T.DOUBLE)
        mean = col(prefix + "_mean")
        return Sqrt(Divide(
            Subtract(col(prefix + "_sumsq"),
                     Multiply(n, Multiply(mean, mean))),
            Subtract(n, lit(1.0))))

    return (agg
            .select(col("i_item_id"), col("s_state"),
                    col("ss_count"), col("ss_mean"),
                    stdev("ss").alias("ss_stdev"),
                    col("sr_count"), col("sr_mean"),
                    stdev("sr").alias("sr_stdev"),
                    col("cs_count"), col("cs_mean"),
                    stdev("cs").alias("cs_stdev"))
            .sort(SortOrder(col("i_item_id")), SortOrder(col("s_state")))
            .limit(100))


def q39(t):
    """Q39: warehouse/item monthly inventory mean + coefficient of
    variation, consecutive-month pairs with cov > 1.5 (stdev via the
    sum-of-squares identity)."""
    # months pooled across years: at test scales a single year leaves
    # <1 inventory sample per (warehouse,item,month) cell and the cov
    # pairing is vacuous
    d = t["date_dim"].where(P.LessThanOrEqual(col("d_moy"), lit(5)))
    q = Cast(col("inv_quantity_on_hand"), T.DOUBLE)
    monthly = (t["inventory"]
               .join(d, on=_eq(col("inv_date_sk"), col("d_date_sk")),
                     how="inner")
               .join(t["item"], on=_eq(col("inv_item_sk"),
                                       col("i_item_sk")), how="inner")
               .join(t["warehouse"],
                     on=_eq(col("inv_warehouse_sk"),
                            col("w_warehouse_sk")), how="inner")
               .group_by(col("w_warehouse_sk"), col("i_item_sk"),
                         col("d_moy"))
               .agg(_cnt("n"), _avg(col("inv_quantity_on_hand"), "mean"),
                    _sum(Multiply(q, q), "sumsq")))
    nn = Cast(col("n"), T.DOUBLE)
    var = Divide(Subtract(col("sumsq"),
                          Multiply(nn, Multiply(col("mean"),
                                                col("mean")))),
                 Subtract(nn, lit(1.0)))
    banded = (monthly
              .where(P.GreaterThan(col("n"), lit(1)))
              .where(P.GreaterThan(col("mean"), lit(0.0)))
              .with_column("cov", Divide(Sqrt(var), col("mean")))
              .where(P.GreaterThan(col("cov"), lit(0.5))))
    m1 = banded.select(col("w_warehouse_sk").alias("wh1"),
                       col("i_item_sk").alias("it1"),
                       col("d_moy").alias("moy1"), col("cov").alias("cov1"))
    m2 = banded.select(col("w_warehouse_sk").alias("wh2"),
                       col("i_item_sk").alias("it2"),
                       col("d_moy").alias("moy2"), col("cov").alias("cov2"))
    return (m1.join(m2,
                    on=P.And(_eq(col("wh1"), col("wh2")),
                             P.And(_eq(col("it1"), col("it2")),
                                   _eq(Add(col("moy1"), lit(1)),
                                       col("moy2")))),
                    how="inner")
            .select(col("wh1"), col("it1"), col("moy1"), col("cov1"),
                    col("moy2"), col("cov2"))
            .sort(SortOrder(col("wh1")), SortOrder(col("it1")),
                  SortOrder(col("moy1")))
            .limit(100))


def q21(t):
    """Q21: warehouse inventory before/after a date, ratio-banded."""
    d = t["date_dim"].where(_between(col("d_date_sk"), lit(550), lit(910)))
    pivot_date = 730
    base = (t["inventory"]
            .join(t["warehouse"],
                  on=_eq(col("inv_warehouse_sk"), col("w_warehouse_sk")),
                  how="inner")
            .join(t["item"].where(_between(col("i_current_price"),
                                           lit(5.0), lit(25.0))),
                  on=_eq(col("inv_item_sk"), col("i_item_sk")),
                  how="inner")
            .join(d, on=_eq(col("inv_date_sk"), col("d_date_sk")),
                  how="inner"))
    agg = (base.group_by(col("w_warehouse_name"), col("i_item_id"))
           .agg(_sum(If(P.LessThan(col("d_date_sk"),
                                   lit(pivot_date)),
                        col("inv_quantity_on_hand"), lit(0)),
                     "inv_before"),
                _sum(If(P.GreaterThanOrEqual(col("d_date_sk"),
                                             lit(pivot_date)),
                        col("inv_quantity_on_hand"), lit(0)),
                     "inv_after")))
    ratio = Divide(Cast(col("inv_after"), T.DOUBLE),
                   Cast(col("inv_before"), T.DOUBLE))
    return (agg
            .where(P.GreaterThan(col("inv_before"), lit(0)))
            .where(P.And(P.GreaterThanOrEqual(ratio, lit(2.0 / 3.0)),
                         P.LessThanOrEqual(ratio, lit(1.5))))
            .sort(SortOrder(col("w_warehouse_name")),
                  SortOrder(col("i_item_id")))
            .limit(100))


def q40(t):
    """Q40: catalog sales net of returns by warehouse state, split
    before/after a pivot date (left join to returns on order+item)."""
    pivot = 730
    d = t["date_dim"].where(_between(col("d_date_sk"), lit(700), lit(760)))
    cr = t["catalog_returns"].select(
        col("cr_order_number").alias("r_order"),
        col("cr_item_sk").alias("r_item"),
        col("cr_refunded_cash"))
    base = (t["catalog_sales"]
            .join(cr, on=P.And(_eq(col("cs_order_number"), col("r_order")),
                               _eq(col("cs_item_sk"), col("r_item"))),
                  how="left")
            .join(t["warehouse"],
                  on=_eq(col("cs_warehouse_sk"), col("w_warehouse_sk")),
                  how="inner")
            .join(t["item"].where(_between(col("i_current_price"),
                                           lit(0.99), lit(1.49))),
                  on=_eq(col("cs_item_sk"), col("i_item_sk")),
                  how="inner")
            .join(d, on=_eq(col("cs_sold_date_sk"), col("d_date_sk")),
                  how="inner"))
    net = Subtract(col("cs_sales_price"),
                   Coalesce(col("cr_refunded_cash"), lit(0.0)))
    return (base
            .group_by(col("w_state"), col("i_item_id"))
            .agg(_sum(If(P.LessThan(col("d_date_sk"), lit(pivot)), net,
                         lit(0.0)), "sales_before"),
                 _sum(If(P.GreaterThanOrEqual(col("d_date_sk"),
                                              lit(pivot)), net,
                         lit(0.0)), "sales_after"))
            .sort(SortOrder(col("w_state")), SortOrder(col("i_item_id")))
            .limit(100))


def q93(t):
    """Q93: per-customer net sales with returned quantities backed out
    (left join to returns via a reason gate)."""
    r = (t["store_returns"]
         .join(t["reason"].where(_eq(col("r_reason_desc"),
                                     lit("reason 28"))),
               on=_eq(col("sr_reason_sk"), col("r_reason_sk")),
               how="left_semi")
         .select(col("sr_ticket_number").alias("r_tick"),
                 col("sr_item_sk").alias("r_item"),
                 col("sr_return_quantity")))
    act = If(P.IsNull(col("sr_return_quantity")),
             Multiply(Cast(col("ss_quantity"), T.DOUBLE),
                      col("ss_sales_price")),
             Multiply(Cast(Subtract(col("ss_quantity"),
                                    col("sr_return_quantity")), T.DOUBLE),
                      col("ss_sales_price")))
    return (t["store_sales"]
            .join(r, on=P.And(_eq(col("ss_ticket_number"), col("r_tick")),
                              _eq(col("ss_item_sk"), col("r_item"))),
                  how="left")
            .group_by(col("ss_customer_sk"))
            .agg(_sum(act, "sumsales"))
            .sort(SortOrder(col("sumsales")),
                  SortOrder(col("ss_customer_sk")))
            .limit(100))


def q33(t):
    """Q33: manufacturer revenue across all three channels for one month
    (three union legs, agg by manufact id)."""
    def leg(fact, date_col, item_col, price):
        d = t["date_dim"].where(P.And(_eq(col("d_year"), lit(1998)),
                                      _eq(col("d_moy"), lit(5))))
        return (t[fact]
                .join(d, on=_eq(col(date_col), col("d_date_sk")),
                      how="inner")
                .join(t["item"].where(_eq(col("i_category"),
                                          lit("Books"))),
                      on=_eq(col(item_col), col("i_item_sk")),
                      how="inner")
                .group_by(col("i_manufact_id"))
                .agg(_sum(col(price), "total_sales"))
                .select(col("i_manufact_id"), col("total_sales")))

    all_legs = (leg("store_sales", "ss_sold_date_sk", "ss_item_sk",
                    "ss_ext_sales_price")
                .union(leg("catalog_sales", "cs_sold_date_sk",
                           "cs_item_sk", "cs_ext_sales_price"))
                .union(leg("web_sales", "ws_sold_date_sk", "ws_item_sk",
                           "ws_ext_sales_price")))
    return (all_legs
            .group_by(col("i_manufact_id"))
            .agg(_sum(col("total_sales"), "total"))
            .sort(SortOrder(col("total")), SortOrder(col("i_manufact_id")))
            .limit(100))


def q56(t):
    """Q56: item revenue for a class across all three channels in one
    month for east-coast addresses, summed per item id (three union
    legs; TpcdsLikeSpark.scala q56, i_color -> i_class here)."""
    d = t["date_dim"].where(P.And(_eq(col("d_year"), lit(1999)),
                                  _eq(col("d_moy"), lit(2))))
    items = (t["item"]
             .where(P.In(col("i_class"), ["bedding", "classical",
                                          "football"]))
             .select(col("i_item_id").alias("ti_id")).distinct())

    def leg(fact, date_col, item_col, addr_col, price):
        return (t[fact]
                .join(d, on=_eq(col(date_col), col("d_date_sk")),
                      how="inner")
                .join(t["customer_address"].where(
                    _eq(col("ca_gmt_offset"), lit(-5.0))),
                    on=_eq(col(addr_col), col("ca_address_sk")),
                    how="inner")
                .join(t["item"], on=_eq(col(item_col), col("i_item_sk")),
                      how="inner")
                .join(items, on=_eq(col("i_item_id"), col("ti_id")),
                      how="left_semi")
                .group_by(col("i_item_id"))
                .agg(_sum(col(price), "total_sales"))
                .select(col("i_item_id"), col("total_sales")))

    return (leg("store_sales", "ss_sold_date_sk", "ss_item_sk",
                "ss_addr_sk", "ss_ext_sales_price")
            .union(leg("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                       "cs_bill_addr_sk", "cs_ext_sales_price"))
            .union(leg("web_sales", "ws_sold_date_sk", "ws_item_sk",
                       "ws_ship_addr_sk", "ws_ext_sales_price"))
            .group_by(col("i_item_id"))
            .agg(_sum(col("total_sales"), "total"))
            .sort(SortOrder(col("total")), SortOrder(col("i_item_id")))
            .limit(100))


def q60(t):
    """Q60: item revenue across three channels for a month + timezone
    (q33's shape grouped by item id)."""
    def leg(fact, date_col, item_col, price):
        d = t["date_dim"].where(P.And(_eq(col("d_year"), lit(1998)),
                                      _eq(col("d_moy"), lit(9))))
        return (t[fact]
                .join(d, on=_eq(col(date_col), col("d_date_sk")),
                      how="inner")
                .join(t["item"].where(_eq(col("i_category"),
                                          lit("Music"))),
                      on=_eq(col(item_col), col("i_item_sk")),
                      how="inner")
                .group_by(col("i_item_id"))
                .agg(_sum(col(price), "total_sales"))
                .select(col("i_item_id"), col("total_sales")))

    return (leg("store_sales", "ss_sold_date_sk", "ss_item_sk",
                "ss_ext_sales_price")
            .union(leg("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                       "cs_ext_sales_price"))
            .union(leg("web_sales", "ws_sold_date_sk", "ws_item_sk",
                       "ws_ext_sales_price"))
            .group_by(col("i_item_id"))
            .agg(_sum(col("total_sales"), "total"))
            .sort(SortOrder(col("i_item_id")), SortOrder(col("total")))
            .limit(100))


def q66(t):
    """Q66: warehouse monthly sales pivot, web + catalog legs unioned."""
    d = t["date_dim"].where(_eq(col("d_year"), lit(1998)))
    tm = t["time_dim"].where(_between(col("t_hour"), lit(8), lit(16)))
    sm = t["ship_mode"].where(P.In(col("sm_carrier"), ["UPS", "DHL"]))

    def leg(fact, date_col, time_col, sm_col, wh_col, qty, price):
        months = [_sum(If(_eq(col("d_moy"), lit(m + 1)),
                          Multiply(Cast(col(qty), T.DOUBLE), col(price)),
                          lit(0.0)), f"m{m + 1}_sales")
                  for m in range(12)]
        return (t[fact]
                .join(d, on=_eq(col(date_col), col("d_date_sk")),
                      how="inner")
                .join(tm, on=_eq(col(time_col), col("t_time_sk")),
                      how="inner")
                .join(sm, on=_eq(col(sm_col), col("sm_ship_mode_sk")),
                      how="left_semi")
                .join(t["warehouse"],
                      on=_eq(col(wh_col), col("w_warehouse_sk")),
                      how="inner")
                .group_by(col("w_warehouse_name"),
                          col("w_warehouse_sq_ft"), col("w_city"),
                          col("w_county"), col("w_state"),
                          col("w_country"))
                .agg(*months))

    web = leg("web_sales", "ws_sold_date_sk", "ws_sold_time_sk",
              "ws_ship_mode_sk", "ws_warehouse_sk", "ws_quantity",
              "ws_ext_sales_price")
    cat = leg("catalog_sales", "cs_sold_date_sk", "cs_sold_time_sk",
              "cs_ship_mode_sk", "cs_warehouse_sk", "cs_quantity",
              "cs_ext_sales_price")
    months = [_sum(col(f"m{m + 1}_sales"), f"tot_m{m + 1}")
              for m in range(12)]
    return (web.union(cat)
            .group_by(col("w_warehouse_name"), col("w_warehouse_sq_ft"),
                      col("w_city"), col("w_county"), col("w_state"),
                      col("w_country"))
            .agg(*months)
            .sort(SortOrder(col("w_warehouse_name")))
            .limit(100))


def q76(t):
    """Q76: sales rows with NULL foreign keys counted per channel."""
    def leg(fact, null_col, date_col, item_col, price, channel):
        return (t[fact]
                .where(P.IsNull(col(null_col)))
                .join(t["item"], on=_eq(col(item_col), col("i_item_sk")),
                      how="inner")
                .join(t["date_dim"],
                      on=_eq(col(date_col), col("d_date_sk")),
                      how="inner")
                .select(lit(channel).alias("channel"),
                        lit(null_col).alias("col_name"), col("d_year"),
                        col("d_qoy"), col("i_category"),
                        col(price).alias("ext_sales_price")))

    allc = (leg("store_sales", "ss_promo_sk", "ss_sold_date_sk",
                "ss_item_sk", "ss_ext_sales_price", "store")
            .union(leg("web_sales", "ws_ship_customer_sk",
                       "ws_sold_date_sk", "ws_item_sk",
                       "ws_ext_sales_price", "web"))
            .union(leg("catalog_sales", "cs_ship_addr_sk",
                       "cs_sold_date_sk", "cs_item_sk",
                       "cs_ext_sales_price", "catalog")))
    return (allc
            .group_by(col("channel"), col("col_name"), col("d_year"),
                      col("d_qoy"), col("i_category"))
            .agg(_cnt("sales_cnt"),
                 _sum(col("ext_sales_price"), "sales_amt"))
            .sort(SortOrder(col("channel")), SortOrder(col("col_name")),
                  SortOrder(col("d_year")), SortOrder(col("d_qoy")),
                  SortOrder(col("i_category")))
            .limit(100))


def q54(t):
    """Q54: customers who bought a category's items by catalog or web in
    one month, their store revenue over the following quarter bucketed
    into $50 segments (month_seq arithmetic; TpcdsLikeSpark.scala
    q54)."""
    d_sold = t["date_dim"].where(P.And(_eq(col("d_year"), lit(1999)),
                                       _eq(col("d_moy"), lit(3))))
    target_items = t["item"].where(P.And(
        _eq(col("i_category"), lit("Women")),
        _eq(col("i_class"), lit("dresses"))))

    def leg(fact, date_col, item_col, cust_col):
        return (t[fact]
                .join(d_sold, on=_eq(col(date_col), col("d_date_sk")),
                      how="inner")
                .join(target_items, on=_eq(col(item_col),
                                           col("i_item_sk")),
                      how="left_semi")
                .select(col(cust_col).alias("mc_sk")))

    my_customers = (leg("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                        "cs_bill_customer_sk")
                    .union(leg("web_sales", "ws_sold_date_sk",
                               "ws_item_sk", "ws_bill_customer_sk"))
                    .distinct()
                    .join(t["customer"],
                          on=_eq(col("mc_sk"), col("c_customer_sk")),
                          how="inner"))
    # 1999-03 has d_month_seq = (1999-1998)*12 + 2 = 14; the revenue
    # window is the following quarter, month_seq 15..17.
    d_rev = t["date_dim"].where(_between(col("d_month_seq"), lit(15),
                                         lit(17)))
    revenue = (my_customers
               .join(t["store_sales"],
                     on=_eq(col("c_customer_sk"), col("ss_customer_sk")),
                     how="inner")
               .join(d_rev, on=_eq(col("ss_sold_date_sk"),
                                   col("d_date_sk")), how="inner")
               .join(t["customer_address"],
                     on=_eq(col("c_current_addr_sk"),
                            col("ca_address_sk")), how="inner")
               .join(t["store"], on=_eq(col("ca_state"), col("s_state")),
                     how="left_semi")
               .group_by(col("c_customer_sk"))
               .agg(_sum(col("ss_ext_sales_price"), "revenue")))
    return (revenue
            .with_column("segment",
                         Cast(Divide(col("revenue"), lit(50.0)), T.INT))
            .group_by(col("segment"))
            .agg(_cnt("num_customers"))
            .with_column("segment_base",
                         Multiply(col("segment"), lit(50)))
            .sort(SortOrder(col("segment")),
                  SortOrder(col("num_customers")))
            .limit(100))


def q78(t):
    """Q78: yearly customer/item sales excluding returned lines across
    store and web channels (anti joins + per-year aggregate join)."""
    d = t["date_dim"].where(_eq(col("d_year"), lit(1998)))
    ss = (t["store_sales"]
          .join(t["store_returns"]
                .select(col("sr_ticket_number").alias("r_tick"),
                        col("sr_item_sk").alias("r_item")),
                on=P.And(_eq(col("ss_ticket_number"), col("r_tick")),
                         _eq(col("ss_item_sk"), col("r_item"))),
                how="left_anti")
          .join(d, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                how="inner")
          .group_by(col("ss_customer_sk"), col("ss_item_sk"))
          .agg(_sum(Cast(col("ss_quantity"), T.DOUBLE), "ss_qty"),
               _sum(col("ss_wholesale_cost"), "ss_wc"),
               _sum(col("ss_sales_price"), "ss_sp"))
          .select(col("ss_customer_sk").alias("ss_cust"),
                  col("ss_item_sk").alias("ss_item"), col("ss_qty"),
                  col("ss_wc"), col("ss_sp")))
    ws = (t["web_sales"]
          .join(t["web_returns"]
                .select(col("wr_order_number").alias("r_ord"),
                        col("wr_item_sk").alias("r_item")),
                on=P.And(_eq(col("ws_order_number"), col("r_ord")),
                         _eq(col("ws_item_sk"), col("r_item"))),
                how="left_anti")
          .join(d, on=_eq(col("ws_sold_date_sk"), col("d_date_sk")),
                how="inner")
          .group_by(col("ws_bill_customer_sk"), col("ws_item_sk"))
          .agg(_sum(Cast(col("ws_quantity"), T.DOUBLE), "ws_qty"),
               _sum(col("ws_wholesale_cost"), "ws_wc"),
               _sum(col("ws_sales_price"), "ws_sp"))
          .select(col("ws_bill_customer_sk").alias("ws_cust"),
                  col("ws_item_sk").alias("ws_item"), col("ws_qty"),
                  col("ws_wc"), col("ws_sp")))
    return (ss
            .join(ws, on=P.And(_eq(col("ss_cust"), col("ws_cust")),
                               _eq(col("ss_item"), col("ws_item"))),
                  how="inner")
            .where(P.GreaterThan(col("ws_qty"), lit(0.0)))
            .select(col("ss_cust"), col("ss_item"),
                    Divide(col("ss_qty"),
                           col("ws_qty")).alias("ratio"),
                    col("ss_qty"), col("ss_wc"), col("ss_sp"))
            .sort(SortOrder(col("ss_qty"), ascending=False),
                  SortOrder(col("ss_wc")), SortOrder(col("ss_cust")),
                  SortOrder(col("ss_item")))
            .limit(100))


def q75(t):
    """Q75: year-over-year sales decline per item identity across all
    three channels with returns netted out via LEFT OUTER joins
    (TpcdsLikeSpark.scala q75)."""
    def detail(fact, date_col, item_col, qty, amt, ret, r_item, r_ord,
               s_ord, r_qty, r_amt):
        sd = (t[fact]
              .join(t["item"].where(_eq(col("i_category"), lit("Books"))),
                    on=_eq(col(item_col), col("i_item_sk")), how="inner")
              .join(t["date_dim"],
                    on=_eq(col(date_col), col("d_date_sk")), how="inner")
              .join(t[ret].select(col(r_item).alias("r_isk"),
                                  col(r_ord).alias("r_ord"),
                                  col(r_qty).alias("r_qty"),
                                  col(r_amt).alias("r_amt")),
                    on=P.And(_eq(col(item_col), col("r_isk")),
                             _eq(col(s_ord), col("r_ord"))),
                    how="left"))
        return (sd.select(
            col("d_year"), col("i_brand_id"), col("i_class_id"),
            col("i_category_id"), col("i_manufact_id"),
            Subtract(Cast(col(qty), T.DOUBLE),
                     Coalesce(Cast(col("r_qty"), T.DOUBLE),
                              lit(0.0))).alias("sales_cnt"),
            Subtract(col(amt), Coalesce(col("r_amt"),
                                        lit(0.0))).alias("sales_amt")))

    all_sales = (detail("store_sales", "ss_sold_date_sk", "ss_item_sk",
                        "ss_quantity", "ss_ext_sales_price",
                        "store_returns", "sr_item_sk", "sr_ticket_number",
                        "ss_ticket_number", "sr_return_quantity",
                        "sr_return_amt")
                 .union(detail("catalog_sales", "cs_sold_date_sk",
                               "cs_item_sk", "cs_quantity",
                               "cs_ext_sales_price", "catalog_returns",
                               "cr_item_sk", "cr_order_number",
                               "cs_order_number", "cr_return_quantity",
                               "cr_return_amount"))
                 .union(detail("web_sales", "ws_sold_date_sk",
                               "ws_item_sk", "ws_quantity",
                               "ws_ext_sales_price", "web_returns",
                               "wr_item_sk", "wr_order_number",
                               "ws_order_number", "wr_return_quantity",
                               "wr_return_amt"))
                 .group_by(col("d_year"), col("i_brand_id"),
                           col("i_class_id"), col("i_category_id"),
                           col("i_manufact_id"))
                 .agg(_sum(col("sales_cnt"), "sales_cnt"),
                      _sum(col("sales_amt"), "sales_amt")))
    attrs = ["i_brand_id", "i_class_id", "i_category_id", "i_manufact_id"]
    curr = all_sales.where(_eq(col("d_year"), lit(1999))).select(
        *([col(a) for a in attrs]
          + [col("sales_cnt").alias("curr_cnt"),
             col("sales_amt").alias("curr_amt")]))
    prev = all_sales.where(_eq(col("d_year"), lit(1998))).select(
        *([col(a).alias("p_" + a) for a in attrs]
          + [col("sales_cnt").alias("prev_cnt"),
             col("sales_amt").alias("prev_amt")]))
    on = P.And(P.And(_eq(col("i_brand_id"), col("p_i_brand_id")),
                     _eq(col("i_class_id"), col("p_i_class_id"))),
               P.And(_eq(col("i_category_id"), col("p_i_category_id")),
                     _eq(col("i_manufact_id"), col("p_i_manufact_id"))))
    return (curr.join(prev, on=on, how="inner")
            .where(P.LessThan(Divide(col("curr_cnt"), col("prev_cnt")),
                              lit(0.9)))
            .with_column("sales_cnt_diff",
                         Subtract(col("curr_cnt"), col("prev_cnt")))
            .select(col("i_brand_id"), col("i_class_id"),
                    col("i_category_id"), col("i_manufact_id"),
                    col("prev_cnt"), col("curr_cnt"),
                    col("sales_cnt_diff"))
            .sort(SortOrder(col("sales_cnt_diff")),
                  SortOrder(col("i_brand_id")))
            .limit(100))


def q64(t):
    """Q64: the cross-channel repeat-purchase monster — store sales with
    a return AND a catalog re-sale clearing the refund bar (cs_ui),
    joined through two demographic/address legs, aggregated per
    item/store/year, then the two years self-joined on item+store
    (TpcdsLikeSpark.scala q64)."""
    cs_ui = (t["catalog_sales"]
             .join(t["catalog_returns"],
                   on=P.And(_eq(col("cs_item_sk"), col("cr_item_sk")),
                            _eq(col("cs_order_number"),
                                col("cr_order_number"))),
                   how="inner")
             .group_by(col("cs_item_sk"))
             .agg(_sum(col("cs_ext_list_price"), "sale"),
                  _sum(Add(col("cr_refunded_cash"), col("cr_net_loss")),
                       "refund"))
             .where(P.GreaterThan(col("sale"), col("refund")))
             .select(col("cs_item_sk").alias("ui_sk")))

    def cross_sales(year, suffix):
        d = t["date_dim"].where(_eq(col("d_year"), lit(year)))
        base = (t["store_sales"]
                .join(t["store_returns"],
                      on=P.And(_eq(col("ss_ticket_number"),
                                   col("sr_ticket_number")),
                               _eq(col("ss_item_sk"), col("sr_item_sk"))),
                      how="inner")
                .join(cs_ui, on=_eq(col("ss_item_sk"), col("ui_sk")),
                      how="left_semi")
                .join(d, on=_eq(col("ss_sold_date_sk"), col("d_date_sk")),
                      how="inner")
                .join(t["store"], on=_eq(col("ss_store_sk"),
                                         col("s_store_sk")), how="inner")
                .join(t["customer"],
                      on=_eq(col("ss_customer_sk"), col("c_customer_sk")),
                      how="inner")
                .join(t["customer_demographics"],
                      on=_eq(col("ss_cdemo_sk"), col("cd_demo_sk")),
                      how="inner")
                .join(t["customer_demographics"].select(
                    col("cd_demo_sk").alias("cd2_sk"),
                    col("cd_marital_status").alias("cd2_marital")),
                    on=_eq(col("c_current_cdemo_sk"), col("cd2_sk")),
                    how="inner")
                .where(P.Not(_eq(col("cd_marital_status"),
                                 col("cd2_marital"))))
                .join(t["household_demographics"],
                      on=_eq(col("ss_hdemo_sk"), col("hd_demo_sk")),
                      how="inner")
                .join(t["income_band"],
                      on=_eq(col("hd_income_band_sk"),
                             col("ib_income_band_sk")), how="inner")
                .join(t["customer_address"],
                      on=_eq(col("ss_addr_sk"), col("ca_address_sk")),
                      how="inner")
                .join(t["item"].where(_between(col("i_current_price"),
                                               lit(5.0), lit(85.0))),
                      on=_eq(col("ss_item_sk"), col("i_item_sk")),
                      how="inner"))
        return (base
                .group_by(col("i_product_name"), col("i_item_sk"),
                          col("s_store_name"), col("s_zip"))
                .agg(_cnt("cnt" + suffix),
                     _sum(col("ss_wholesale_cost"), "s1" + suffix),
                     _sum(col("ss_list_price"), "s2" + suffix),
                     _sum(col("ss_coupon_amt"), "s3" + suffix))
                .select(col("i_product_name").alias("pn" + suffix),
                        col("i_item_sk").alias("isk" + suffix),
                        col("s_store_name").alias("sn" + suffix),
                        col("s_zip").alias("zip" + suffix),
                        col("cnt" + suffix), col("s1" + suffix),
                        col("s2" + suffix), col("s3" + suffix)))

    cs1 = cross_sales(1998, "_1")
    cs2 = cross_sales(1999, "_2")
    return (cs1
            .join(cs2, on=P.And(_eq(col("isk_1"), col("isk_2")),
                                P.And(_eq(col("sn_1"), col("sn_2")),
                                      _eq(col("zip_1"), col("zip_2")))),
                  how="inner")
            .where(P.LessThanOrEqual(col("cnt_2"), col("cnt_1")))
            .select(col("pn_1"), col("isk_1"), col("sn_1"), col("zip_1"),
                    col("cnt_1"), col("s1_1"), col("s2_1"), col("s3_1"),
                    col("cnt_2"), col("s1_2"), col("s2_2"), col("s3_2"))
            .sort(SortOrder(col("pn_1")), SortOrder(col("isk_1")),
                  SortOrder(col("sn_1")), SortOrder(col("cnt_2"))))


def q72(t):
    """Q72: catalog orders short on inventory in the sale week, promo
    vs no-promo counts — the inventory x catalog_sales volume join with
    three date_dim roles and two LEFT OUTER tails (TpcdsLikeSpark.scala
    q72; i_item_desc -> i_product_name here)."""
    d1 = (t["date_dim"].where(_eq(col("d_year"), lit(1999)))
          .select(col("d_date_sk").alias("d1_sk"),
                  col("d_week_seq").alias("d1_week"),
                  col("d_date").alias("d1_date")))
    d2 = t["date_dim"].select(col("d_date_sk").alias("d2_sk"),
                              col("d_week_seq").alias("d2_week"))
    d3 = t["date_dim"].select(col("d_date_sk").alias("d3_sk"),
                              col("d_date").alias("d3_date"))
    base = (t["catalog_sales"]
            .join(d1, on=_eq(col("cs_sold_date_sk"), col("d1_sk")),
                  how="inner")
            .join(d3, on=_eq(col("cs_ship_date_sk"), col("d3_sk")),
                  how="inner")
            .where(P.GreaterThan(col("d3_date"),
                                 DateAdd(col("d1_date"), lit(5))))
            .join(t["household_demographics"].where(
                _eq(col("hd_buy_potential"), lit(">10000"))),
                on=_eq(col("cs_bill_hdemo_sk"), col("hd_demo_sk")),
                how="inner")
            .join(t["customer_demographics"].where(
                _eq(col("cd_marital_status"), lit("D"))),
                on=_eq(col("cs_bill_cdemo_sk"), col("cd_demo_sk")),
                how="inner")
            .join(t["inventory"],
                  on=_eq(col("cs_item_sk"), col("inv_item_sk")),
                  how="inner")
            .join(d2, on=_eq(col("inv_date_sk"), col("d2_sk")),
                  how="inner")
            .where(P.And(_eq(col("d1_week"), col("d2_week")),
                         P.LessThan(col("inv_quantity_on_hand"),
                                    col("cs_quantity"))))
            .join(t["warehouse"],
                  on=_eq(col("inv_warehouse_sk"), col("w_warehouse_sk")),
                  how="inner")
            .join(t["item"], on=_eq(col("cs_item_sk"), col("i_item_sk")),
                  how="inner")
            .join(t["promotion"].select(col("p_promo_sk")),
                  on=_eq(col("cs_promo_sk"), col("p_promo_sk")),
                  how="left")
            .join(t["catalog_returns"].select(
                col("cr_item_sk").alias("r_isk"),
                col("cr_order_number").alias("r_ord")),
                on=P.And(_eq(col("cs_item_sk"), col("r_isk")),
                         _eq(col("cs_order_number"), col("r_ord"))),
                how="left"))
    no_promo = If(P.IsNull(col("p_promo_sk")), lit(1), lit(0))
    promo = If(P.IsNotNull(col("p_promo_sk")), lit(1), lit(0))
    return (base
            .group_by(col("i_product_name"), col("w_warehouse_name"),
                      col("d1_week"))
            .agg(_sum(no_promo, "no_promo"), _sum(promo, "promo"),
                 _cnt("total_cnt"))
            .sort(SortOrder(col("total_cnt"), ascending=False),
                  SortOrder(col("i_product_name")),
                  SortOrder(col("w_warehouse_name")),
                  SortOrder(col("d1_week")))
            .limit(100))

QUERIES = {q.__name__: q for q in (
    q1, q2, q3, q4, q5, q6, q7, q8, q9, q10, q11, q12, q13, q14, q15, q16,
    q17, q18, q19, q20, q21, q22, q23, q24, q25, q26, q27, q28, q29, q30,
    q31, q32, q33, q34, q35, q36, q37, q38, q39, q40, q41, q42, q43, q44,
    q45, q46, q47, q48, q49, q50, q51, q52, q53, q54, q55, q56, q57, q58,
    q59, q60, q61, q62, q63, q64, q65, q66, q67, q68, q69, q70, q71, q72,
    q73, q74, q75, q76, q77, q78, q79, q80, q81, q82, q83, q84, q85, q86,
    q87, q88, q89, q90, q91, q92, q93, q94, q95, q96, q97, q98, q99)}
