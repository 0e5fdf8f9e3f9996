"""Writes ``lineitem_fixture.parquet`` beside this script: the parquet
layouts the port's own writer never produces, on lineitem-shaped
columns, for the scan's card check (``chip_smoke.py``,
``tests/test_torch_cuda.py``) and its CPU test
(``tests/test_torch_parquet.py``).

    python tests/data/make_lineitem_fixture.py

16,384 rows of ``spark_rapids_tpu_torch.workloads.tpch.gen_tables``'s
lineitem (seed 42) written by pyarrow with SNAPPY pages: 4 row groups of
4,096 rows and a fifth with none, 2 KiB data pages (several pages a
chunk, so dictionary bit widths grow across pages), a 4 KiB dictionary
limit (``l_orderkey``, ``l_partkey`` and ``l_extendedprice`` fall back
from dictionary to PLAIN pages part way: mixed chunks), nulls in
``l_discount`` and ``l_shipmode`` (bit-packed definition levels), an
all-null ``l_null``, empty strings in ``l_comment``, REQUIRED
``l_orderkey`` and ``l_shipdate``, and ``l_linenumber`` (INT_8) and
``l_weight`` (FLOAT).
"""

from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from spark_rapids_tpu_torch.workloads import tpch

ROWS = 1 << 14
OUT = Path(__file__).resolve().parent / "lineitem_fixture.parquet"


def fixture_table() -> pa.Table:
    li = tpch.gen_tables(ROWS, seed=42)["lineitem"].columns
    rng = np.random.default_rng(7)
    arrays, fields = {}, []
    for name, values in li.items():
        if values.dtype.kind == "U":
            arr = pa.array(values.astype(object), pa.string())
        elif name in ("l_shipdate", "l_commitdate", "l_receiptdate"):
            arr = pa.array(values, pa.int32()).cast(pa.date32())
        else:
            arr = pa.array(values)
        arrays[name] = arr
    arrays["l_discount"] = pa.array(li["l_discount"],
                                    mask=rng.random(ROWS) < 0.1)
    arrays["l_shipmode"] = pa.array(li["l_shipmode"].astype(object),
                                    pa.string(), mask=rng.random(ROWS) < 0.05)
    words = np.array(["", "carefully final", "", "ironic deposits",
                      "furiously even requests"], dtype=object)
    arrays["l_comment"] = pa.array(words[rng.integers(0, 5, ROWS)],
                                   pa.string(),
                                   mask=rng.random(ROWS) < 0.02)
    arrays["l_null"] = pa.nulls(ROWS, pa.int32())
    arrays["l_linenumber"] = pa.array(rng.integers(1, 8, ROWS)
                                      .astype(np.int8))
    arrays["l_weight"] = pa.array(rng.uniform(0, 50, ROWS)
                                  .astype(np.float32))
    required = ("l_orderkey", "l_shipdate")
    for name, arr in arrays.items():
        fields.append(pa.field(name, arr.type, nullable=name not in required))
    return pa.Table.from_arrays(list(arrays.values()),
                                schema=pa.schema(fields))


def main() -> None:
    table = fixture_table()
    with pq.ParquetWriter(OUT, table.schema, compression="snappy",
                          data_page_size=2048,
                          dictionary_pagesize_limit=4096) as w:
        for start in range(0, ROWS, 4096):
            w.write_table(table.slice(start, 4096), row_group_size=4096)
        w.write_table(table.slice(0, 0))
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
