"""Mortgage-like ETL — port of ``spark_rapids_tpu/workloads/mortgage.py``
(the reference's ``MortgageSpark`` analog): clean the performance
records, derive per-loan delinquency features, join the acquisitions,
band the credit scores with ``CaseWhen``, and report per (seller, score
band); :func:`ml_features` is the per-loan training table of the
reference's ETL -> train -> score pipeline. ``score_report`` reads a
model's score column and waits for the port's ``ml/`` package.

:func:`gen_tables` is a numpy-only copy of the reference generator: the
same seed draws the same values in the same order. The string columns
``seller`` and ``servicer`` are dictionary columns made straight from
the integer draw (``_SELLERS`` is unique and ascending), so no host
string array of the performance table's length is ever built.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from .. import types as T
from ..data.batch import HostColumn, upload_columns
from ..ops import aggregates as A
from ..ops import predicates as P
from ..ops.cast import Cast
from ..ops.conditional import CaseWhen, If
from ..ops.expression import Alias, col, lit
from ..plan import logical as L

_SELLERS = np.array(["ACME BANK", "BIG LENDER", "CREDIT ONE", "DELTA TRUST",
                     "EVERGREEN"], dtype=object)


@dataclasses.dataclass
class Table:
    """A generated table: its schema and one :class:`HostColumn` a field
    (strings as codes into ``_SELLERS``)."""

    schema: T.Schema
    columns: List[HostColumn]

    @property
    def num_rows(self) -> int:
        return self.columns[0].num_rows

    def values(self, name: str) -> np.ndarray:
        """The column's values (a string column's decoded)."""
        c = self.columns[self.schema.index_of(name)]
        return c.dictionary[c.codes] if c.is_dict else c.data


def _table(fields, arrays: Dict[str, np.ndarray]) -> Table:
    cols = []
    for f in fields:
        a = arrays[f.name]
        valid = np.ones(len(a), dtype=bool)
        if f.data_type is T.STRING:
            cols.append(HostColumn(T.STRING, valid, codes=a.astype(np.int32),
                                   dictionary=_SELLERS, dict_sorted=True))
        else:
            cols.append(HostColumn(f.data_type, valid,
                                   data=a.astype(f.data_type.np_dtype)))
    return Table(T.Schema(fields), cols)


def gen_tables(perf_rows: int = 1 << 18, seed: int = 7) -> Dict[str, Table]:
    """``{"acquisition", "performance"}`` with about 24 performance records
    a loan: the reference's values for the same ``perf_rows`` and
    ``seed``."""
    rng = np.random.default_rng(seed)
    n_perf = perf_rows
    n_loans = max(n_perf // 24, 16)
    acquisition = {
        "loan_id": np.arange(n_loans, dtype=np.int64),
        "seller": rng.integers(0, len(_SELLERS), n_loans),
        "orig_rate": np.round(rng.uniform(2.5, 7.5, n_loans), 3),
        "orig_upb": rng.integers(50_000, 800_000, n_loans),
        "credit_score": rng.integers(300, 850, n_loans),
        "orig_date": rng.integers(14000, 17000, n_loans),
    }
    performance = {
        "loan_id": rng.integers(0, n_loans, n_perf),
        "month": rng.integers(0, 48, n_perf),
        "current_upb": rng.integers(10_000, 800_000, n_perf)
        .astype(np.float64),
        "delinq_status": np.maximum(rng.integers(-6, 7, n_perf), 0),
        "servicer": rng.integers(0, len(_SELLERS), n_perf),
    }
    F = T.StructField
    return {
        "acquisition": _table([
            F("loan_id", T.LONG), F("seller", T.STRING),
            F("orig_rate", T.DOUBLE), F("orig_upb", T.LONG),
            F("credit_score", T.LONG), F("orig_date", T.DATE)],
            acquisition),
        "performance": _table([
            F("loan_id", T.LONG), F("month", T.LONG),
            F("current_upb", T.DOUBLE), F("delinq_status", T.LONG),
            F("servicer", T.STRING)], performance),
    }


def load(session, tables: Dict[str, Table], cache: bool = True) -> dict:
    """Upload the tables to the session's device as DataFrames. The
    columns stay resident on the device, which is what the reference's
    ``cache`` buys it, so ``cache`` changes nothing here."""
    return {name: L.DataFrame(L.DeviceRelation(upload_columns(
        t.columns, t.schema, session.device)), session)
        for name, t in tables.items()}


def _clean_performance(t):
    """Stage 1: performance-record cleanup + derived delinquency flags."""
    return (t["performance"]
            .where(P.GreaterThan(col("current_upb"), lit(0.0)))
            .with_column("ever_delinq",
                         If(P.GreaterThanOrEqual(col("delinq_status"),
                                                 lit(1)), lit(1), lit(0)))
            .with_column("serious_delinq",
                         If(P.GreaterThanOrEqual(col("delinq_status"),
                                                 lit(3)), lit(1), lit(0)))
            .with_column("recent",
                         If(P.GreaterThanOrEqual(col("month"), lit(36)),
                            col("current_upb"), lit(0.0))))


def _loan_features(perf):
    """Stage 2: per-loan delinquency feature aggregation."""
    return (perf.group_by(col("loan_id"))
            .agg(A.AggregateExpression(A.Count(), "n_records"),
                 A.AggregateExpression(
                     A.Sum(col("ever_delinq")), "months_delinq"),
                 A.AggregateExpression(
                     A.Sum(col("serious_delinq")), "months_serious"),
                 A.AggregateExpression(
                     A.Max(col("delinq_status")), "worst_status"),
                 A.AggregateExpression(
                     A.Sum(col("recent")), "recent_upb")))


def _score_band():
    return CaseWhen(
        [(P.LessThan(col("credit_score"), lit(580)), lit("SUBPRIME")),
         (P.LessThan(col("credit_score"), lit(670)), lit("FAIR")),
         (P.LessThan(col("credit_score"), lit(740)), lit("GOOD"))],
        lit("EXCELLENT"))


def etl(t):
    """The full pipeline: clean -> per-loan features -> join -> report."""
    loan_features = _loan_features(_clean_performance(t))
    joined = (t["acquisition"]
              .join(loan_features, on="loan_id", how="inner")
              .with_column("score_band", _score_band())
              .with_column("risk_upb",
                           If(P.GreaterThan(col("months_serious"), lit(0)),
                              Cast(col("orig_upb"), T.DOUBLE), lit(0.0))))
    return (joined.group_by(col("seller"), col("score_band"))
            .agg(A.AggregateExpression(A.Count(), "n_loans"),
                 A.AggregateExpression(A.Sum(col("months_delinq")),
                                       "total_delinq_months"),
                 A.AggregateExpression(A.Sum(col("risk_upb")), "risk_upb"),
                 A.AggregateExpression(A.Average(col("orig_rate")),
                                       "avg_rate")))


#: Feature columns of the per-loan training table (``months_serious`` and
#: ``worst_status`` left out: the label derives from them).
ML_FEATURES = ["n_records", "months_delinq", "recent_upb", "orig_rate",
               "orig_upb", "credit_score"]
ML_LABEL = "serious_flag"


def ml_features(t):
    """The per-loan ML feature table: the cleaned per-loan aggregation
    joined with the acquisition attributes, the score band, and the
    binary label (the loan ever went seriously delinquent)."""
    lf = _loan_features(_clean_performance(t))
    # the aggregation side's key renamed: the join keeps both sides'
    # columns, and the output must stay selectable by name
    lf = lf.select(Alias(col("loan_id"), "_fl_id"),
                   *[col(c) for c in lf.columns if c != "loan_id"])
    joined = (t["acquisition"]
              .join(lf, on=P.EqualTo(col("loan_id"), col("_fl_id")),
                    how="inner")
              .with_column("score_band", _score_band())
              .with_column(ML_LABEL,
                           If(P.GreaterThan(col("months_serious"), lit(0)),
                              lit(1), lit(0))))
    keep = ["loan_id", "seller", "score_band"] + ML_FEATURES + [ML_LABEL]
    return joined.select(*[col(c) for c in keep])
