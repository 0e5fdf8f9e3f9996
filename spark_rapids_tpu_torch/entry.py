"""The engine's entry stage — port of ``__graft_entry__.py``'s ``entry()``.

``entry()`` returns the single-device forward step of a q5-shaped stage
(filter -> hash aggregate) over one device batch, and the batch it runs
on. The defaults draw the reference's inputs: 1,000 rows of int64 ``k``
(the group key, 50 values), ``q`` and ``p`` from
``np.random.default_rng(0)`` in the same order. ``forward`` keeps the
rows with ``q < 90`` (a lazy compaction) and aggregates them by ``k``
with ``sum(q)``, ``count(*)``, ``min(p)`` and ``max(p)`` in update mode,
at the default ``dense_mode=1``: the sort path, whose integer sum, min
and max lanes reduce through the ``segmented`` kernel on the card.

    from spark_rapids_tpu_torch.entry import entry
    forward, (batch,) = entry()                # on the card
    buffers, fail = forward(batch)             # keys, then the 4 buffers
"""

from __future__ import annotations

import numpy as np

from . import types as T
from .data.batch import HostBatch
from .exec.execs import aggregate_batch
from .ops import aggregates as AGG
from .ops import predicates as P
from .ops.expression import col, lit
from .ops.kernels import rowops as KR
from .session import resolve_device

#: The buffer batch's schema: the key, then sum, count, min and max.
BUFFER_SCHEMA = T.Schema([T.StructField("k", T.LONG, True),
                          T.StructField("_buf0_sum", T.LONG, True),
                          T.StructField("_buf1_count", T.LONG, True),
                          T.StructField("_buf2_min", T.LONG, True),
                          T.StructField("_buf3_max", T.LONG, True)])


def entry_columns(n: int = 1000, key_range: int = 50, seed: int = 0
                  ) -> dict:
    """The stage's input columns as numpy int64 arrays, drawn as the
    reference draws them (``k``, then ``q``, then ``p``)."""
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, key_range, n).astype(np.int64),
            "q": rng.integers(1, 100, n).astype(np.int64),
            "p": rng.integers(1, 1000, n).astype(np.int64)}


def entry_reference(cols: dict) -> dict:
    """The stage in numpy, apart from the port's operators: per key of
    the rows of ``cols`` with ``q < 90``, in key order, the key, the sum
    of ``q``, the row count and the min and max of ``p``, under the
    buffer schema's names. The card tests, the CPU tests and
    ``chip_smoke.py`` hold ``forward`` against this one copy."""
    m = cols["q"] < 90
    k, q, p = cols["k"][m], cols["q"][m], cols["p"][m]
    order = np.argsort(k, kind="stable")
    ks, qs, ps = k[order], q[order], p[order]
    start = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]]) if len(ks) \
        else np.zeros(0, np.int64)
    return {"k": ks[start], "_buf0_sum": np.add.reduceat(qs, start),
            "_buf1_count": np.diff(np.r_[start, len(ks)]),
            "_buf2_min": np.minimum.reduceat(ps, start),
            "_buf3_max": np.maximum.reduceat(ps, start)}


def entry(n: int = 1000, key_range: int = 50, seed: int = 0, device=None):
    """``(forward, (batch,))``: the stage's step and its input, uploaded
    to ``device`` (the card when None; raises without one).
    ``forward(batch)`` returns ``(buffer batch, fail)``, ``fail`` being
    None on the sort path."""
    device = resolve_device(device)
    cols = entry_columns(n, key_range, seed)
    schema = T.Schema([T.StructField(name, T.LONG) for name in cols])
    batch = HostBatch.from_numpy(cols, schema).to_device(device)

    cond = P.LessThan(col("q"), lit(90)).bind(schema)
    groupings = [col("k").bind(schema)]
    aggs = [
        AGG.AggregateExpression(AGG.Sum(col("q")).bind(schema), "sum_q"),
        AGG.AggregateExpression(AGG.Count().bind(schema), "cnt"),
        AGG.AggregateExpression(AGG.Min(col("p")).bind(schema), "min_p"),
        AGG.AggregateExpression(AGG.Max(col("p")).bind(schema), "max_p"),
    ]

    def forward(batch):
        mask = cond.eval_device(batch)
        filtered = KR.compact(batch, mask.data & mask.validity)
        return aggregate_batch(filtered, groupings, aggs, BUFFER_SCHEMA,
                               n_keys=1, update_mode=True)

    return forward, (batch,)
