"""Writes the I/O fixtures beside this script: files from another writer
(pyarrow) in the layouts the port's own writers never produce, and
``expected.npz`` with every column's values and validity, for the
card's ``io_fixtures`` cell (``chip_smoke.py``, whose machine has no
pyarrow) and the CPU tests (``tests/test_torch_parquet_more.py``,
``tests/test_torch_orc.py``, ``tests/test_torch_csv.py``).

    python tests/data/torch_io/make_fixtures.py

Seeded (numpy ``default_rng(22)``); 4,000 rows a table:

* ``plain.parquet``: no dictionaries (PLAIN booleans, PLAIN byte-array
  pages), SNAPPY, nulls in each column;
* ``v2_gzip.parquet``: v2 data pages, GZIP, dictionary strings;
* ``rle_zlib.orc``: ZLIB, 1,000-row stripes; a sequence (DELTA), random
  integers (DIRECT), a constant (SHORT_REPEAT and DELTA), small values
  with huge outliers (PATCHED_BASE), nulls, dates, doubles and
  DICTIONARY_V2 strings;
* ``direct_snappy.orc``: SNAPPY, DIRECT_V2 strings with empty ones and
  nulls;
* ``quoted_exp.csv``: quoted fields holding the delimiter and doubled
  quotes, and doubles in exponent notation (the device parse falls back
  to the host reader);
* ``crlf.csv``: ``\\r\\n`` line ends, no quotes (the device parse takes
  it).

``expected.npz`` keys are ``<file>/<column>`` (values: int64, float64,
bool, int32 days for dates, unicode for strings) and
``<file>/<column>/valid``.
"""

from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.orc as orc
import pyarrow.parquet as pq

OUT = Path(__file__).resolve().parent
ROWS = 4000


def _masked(rng, values, p=0.1):
    return pa.array(values, mask=rng.random(len(values)) < p)


def tables(rng) -> dict:
    n = ROWS
    words = np.array(["red", "green", "blue", "lime", "x", "", "a,b"])
    plain = pa.table({
        "flag": _masked(rng, rng.random(n) < 0.5),
        "name": _masked(rng, np.array([f"n{v}" for v in
                                       rng.integers(0, 10 ** 6, n)],
                                      dtype=object)),
        "qty": _masked(rng, rng.integers(-1000, 1000, n)),
        "price": _masked(rng, rng.normal(scale=100, size=n)),
    })
    v2 = pa.table({
        "tag": _masked(rng, words[rng.integers(0, 5, n)].astype(object)),
        "ok": rng.random(n) < 0.3,
        "id": np.arange(n, dtype=np.int64),
        "x": _masked(rng, rng.normal(size=n)),
    })
    outliers = rng.integers(0, 512, n)
    hit = rng.choice(n, 80, replace=False)
    outliers[hit] = rng.integers(2 ** 40, 2 ** 45, 80)
    rle = pa.table({
        "seq": np.arange(n, dtype=np.int64) * 3 + 11,
        "rand": rng.integers(-10 ** 12, 10 ** 12, n),
        "const": np.full(n, 7, np.int64),
        "patched": outliers,
        "ni": _masked(rng, rng.integers(0, 50, n).astype(np.int32), 0.15),
        "day": pa.array(rng.integers(8000, 11000, n).astype(np.int32),
                        pa.date32()),
        "f": _masked(rng, rng.normal(size=n), 0.07),
        "s": words[rng.integers(0, 7, n)].astype(object),
    })
    direct = pa.table({
        "s": _masked(rng, np.array([f"v{v}" if v % 9 else "" for v in
                                    rng.integers(0, 300, n)], dtype=object)),
        "k": rng.integers(0, 100, n),
    })
    return {"plain.parquet": plain, "v2_gzip.parquet": v2,
            "rle_zlib.orc": rle, "direct_snappy.orc": direct}


def _expected(name: str, table: pa.Table, out: dict) -> None:
    for field, column in zip(table.schema, table.columns):
        values = column.to_pylist()
        valid = np.array([v is not None for v in values])
        t = field.type
        if pa.types.is_string(t):
            arr = np.array(["" if v is None else v for v in values], "U")
        elif pa.types.is_date32(t):
            arr = np.array([0 if v is None else
                            (v - __import__("datetime").date(1970, 1, 1)).days
                            for v in values], np.int32)
        elif pa.types.is_boolean(t):
            arr = np.array([bool(v) for v in values])
        elif pa.types.is_floating(t):
            arr = np.array([0.0 if v is None else v for v in values])
        else:
            arr = np.array([0 if v is None else v for v in values], np.int64)
        out[f"{name}/{field.name}"] = arr
        out[f"{name}/{field.name}/valid"] = valid


def _csv(rng, out: dict) -> None:
    n = 400
    ids = np.arange(n)
    vals = rng.integers(-10 ** 6, 10 ** 6, n) / 1000.0
    texts = np.array(['plain', 'with, comma', 'say "hi"', ''])[ids % 4]
    lines = ["id,text,val"]
    for i, t, v in zip(ids, texts, vals):
        field = '"' + t.replace('"', '""') + '"' if ("," in t or '"' in t) \
            else t
        lines.append(f"{i},{field},{v:.6e}")
    (OUT / "quoted_exp.csv").write_text("\n".join(lines) + "\n")
    out["quoted_exp.csv/id"] = ids.astype(np.int64)
    out["quoted_exp.csv/text"] = texts.astype("U")
    out["quoted_exp.csv/val"] = np.array([float(f"{v:.6e}") for v in vals])
    for c in ("id", "text", "val"):
        out[f"quoted_exp.csv/{c}/valid"] = np.ones(n, bool)
    k = rng.integers(0, 10 ** 9, n)
    price = np.round(rng.uniform(0, 10 ** 5, n), 2)
    day = rng.integers(8000, 11000, n).astype(np.int32)
    body = "".join(f"{a},{p:.2f},{np.datetime64(int(d), 'D')},{'true' if a % 2 else 'false'}\r\n"
                   for a, p, d in zip(k, price, day))
    (OUT / "crlf.csv").write_bytes(("k,price,day,odd\r\n" + body).encode())
    out["crlf.csv/k"] = k.astype(np.int64)
    out["crlf.csv/price"] = price
    out["crlf.csv/day"] = day
    out["crlf.csv/odd"] = (k % 2).astype(bool)
    for c in ("k", "price", "day", "odd"):
        out[f"crlf.csv/{c}/valid"] = np.ones(n, bool)


def main() -> None:
    rng = np.random.default_rng(22)
    out: dict = {}
    t = tables(rng)
    pq.write_table(t["plain.parquet"], OUT / "plain.parquet",
                   use_dictionary=False, compression="snappy",
                   row_group_size=1500)
    pq.write_table(t["v2_gzip.parquet"], OUT / "v2_gzip.parquet",
                   data_page_version="2.0", compression="gzip",
                   row_group_size=2500, data_page_size=4096)
    orc.write_table(t["rle_zlib.orc"], OUT / "rle_zlib.orc",
                    compression="zlib", stripe_size=16 * 1024)
    orc.write_table(t["direct_snappy.orc"], OUT / "direct_snappy.orc",
                    compression="snappy", dictionary_key_size_threshold=0.0)
    for name, table in t.items():
        _expected(name, table, out)
    _csv(rng, out)
    np.savez_compressed(OUT / "expected.npz", **out)


if __name__ == "__main__":
    main()
