"""The explode edge case that the card test and ``chip_smoke.py`` share:
a seeded table whose rows carry a flat string column and a struct with a
flat string field, exploded with ``posexplode_outer`` across the tile
boundaries of a lowered lane bound (:data:`TILE_LANES`), so the same plan
can run on the card and on the CPU and be compared bit for bit."""

from __future__ import annotations

import numpy as np

from .. import types as T
from ..data.batch import HostBatch

#: Rows of the case: 3,000 live rows at capacity 4,096, arrays bucketed
#: to width 8, so 32,768 lanes in tiles of 1,024 rows under this bound.
ROWS = 3000
TILE_LANES = 1 << 13

_WORDS = np.array(["AIR", "FOB", "MAIL", "", "REG AIR", "ÄRGER", "SHIP",
                   "a longer string than the rest"], dtype=object)


def generate_table(seed: int = 7) -> HostBatch:
    """``k`` (bigint), ``s`` (string), ``arr`` (array<bigint> of 0-8
    elements; null and empty rows, null elements) and ``st`` (struct of
    ``a`` bigint and ``b`` string; null rows and fields)."""
    rng = np.random.default_rng(seed)
    n = ROWS
    arrays = np.empty(n, dtype=object)
    structs = np.empty(n, dtype=object)
    for i in range(n):
        k = int(rng.integers(0, 9))
        arrays[i] = None if rng.random() < 0.05 else [
            None if rng.random() < 0.05 else int(v)
            for v in rng.integers(-100, 100, k)]
        structs[i] = None if rng.random() < 0.05 else {
            "a": int(rng.integers(0, 50)),
            "b": None if rng.random() < 0.1
            else str(_WORDS[rng.integers(0, len(_WORDS))])}
    schema = T.Schema([
        T.StructField("k", T.LONG, False), T.StructField("s", T.STRING),
        T.StructField("arr", T.ArrayType(T.LONG)),
        T.StructField("st", T.StructType([T.StructField("a", T.LONG),
                                          T.StructField("b", T.STRING)]))])
    s = _WORDS[rng.integers(0, len(_WORDS), n)]
    s_valid = rng.random(n) > 0.05
    return HostBatch.from_numpy(
        {"k": np.arange(n, dtype=np.int64), "s": s, "arr": arrays,
         "st": structs}, schema, {"s": s_valid})


def generate_query(session, table: HostBatch):
    """``posexplode_outer(arr)`` over ``table`` uploaded to ``session``,
    after turning ``s`` and ``st.b`` into flat strings (a substring
    builds them), so the exploded parents move with the ragged
    ``strings`` gather."""
    from ..ops import complex as CPX
    from ..ops.expression import col, lit
    from ..ops.strings import Substring
    df = session.create_dataframe(table)
    flat = df.select(
        col("k"), Substring(col("s"), lit(1), lit(64)).alias("fs"),
        col("arr"), CPX.struct(
            a=CPX.GetStructField(col("st"), "a"),
            b=Substring(CPX.GetStructField(col("st"), "b"), lit(1),
                        lit(64))).alias("st"))
    return flat.explode(col("arr"), name="x", outer=True, pos=True)
