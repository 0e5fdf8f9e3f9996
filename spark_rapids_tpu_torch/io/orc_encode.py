"""The port's ORC encoder: what ``pyarrow.orc.write_table`` does for the
reference's writer (``spark_rapids_tpu/io/writers.py:76-78``), which the
port cannot call.

A file is the ``ORC`` magic, stripes of at most ``stripe_rows`` rows,
the footer and the postscript, all protobuf (:func:`_message`). Each
column writes:

* PRESENT, when it has a null: its validity bits, MSB first, as
  byte-RLE (literal groups of at most 128 bytes);
* integers and dates: RLEv2 of the non-null values (zigzag for the
  signed ones), as DIRECT runs of 512 values at the closest fixed bit
  width of the run's largest value, and a last run of 3-10 equal values
  as SHORT_REPEAT;
* FLOAT and DOUBLE: their little-endian bytes (PLAIN);
* BOOLEAN: the bits of the non-null values as byte-RLE; BYTE: the values
  as byte-RLE;
* strings: DICTIONARY_V2 (codes RLEv2, the entries' lengths RLEv2, the
  entries' bytes) from a dictionary (the port's dictionary columns keep
  theirs; a host column is dictionary-encoded with ``np.unique``), or
  DIRECT_V2 (lengths RLEv2, then the bytes) for a flat column.

Every stream is cut into blocks of ``block_size`` bytes, each compressed
by the file's codec (NONE, ZLIB as raw deflate, SNAPPY through
:mod:`.snappy`) and kept as it was when that does not make it smaller.
No row index is written (``rowIndexStride`` 0). Timestamps and nested
types raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from .. import types as T
from . import snappy
from .orc_device import (_E_DICT_V2, _E_DIRECT, _E_DIRECT_V2, _K_BOOL,
                         _K_BYTE, _K_DATE, _K_DOUBLE, _K_FLOAT, _K_INT,
                         _K_LONG, _K_SHORT, _K_STRING, _K_STRUCT,
                         _S_DATA, _S_DICT, _S_LENGTH, _S_PRESENT,
                         _WIDTH_TABLE, MAGIC)

_KIND = {"boolean": _K_BOOL, "tinyint": _K_BYTE, "smallint": _K_SHORT,
         "int": _K_INT, "bigint": _K_LONG, "float": _K_FLOAT,
         "double": _K_DOUBLE, "string": _K_STRING, "date": _K_DATE}
CODECS = {"none": 0, "uncompressed": 0, "zlib": 1, "snappy": 2}
RUN = 512
#: width -> its 5-bit code
_WIDTH_CODE = {w: i for i, w in enumerate(_WIDTH_TABLE)}
#: the smallest fixed width holding each bit length 0..64
_CLOSEST = np.array([next(w for w in _WIDTH_TABLE if w >= max(b, 1))
                     for b in range(65)], np.int64)


@dataclasses.dataclass
class EncColumn:
    """One column to write, on the host: ``valid`` per row; ``values`` the
    fixed-width values (any value under a null), or a string column's
    ``codes`` into ``dictionary`` (entries as ``str``), or its ``payload``
    bytes and ``offsets`` (``[n + 1]``, a flat column)."""
    name: str
    dtype: T.DataType
    valid: np.ndarray
    values: Optional[np.ndarray] = None
    dictionary: Optional[np.ndarray] = None
    codes: Optional[np.ndarray] = None
    payload: Optional[np.ndarray] = None
    offsets: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.valid)

    def slice(self, lo: int, hi: int) -> "EncColumn":
        out = dataclasses.replace(self, valid=self.valid[lo:hi])
        if self.values is not None:
            out.values = self.values[lo:hi]
        if self.codes is not None:
            out.codes = self.codes[lo:hi]
        if self.offsets is not None:
            out.offsets = self.offsets[lo:hi + 1]
        return out

    def as_dictionary(self) -> "EncColumn":
        """A string column as dictionary + codes (a flat one's distinct
        rows become the entries)."""
        if self.codes is not None:
            return self
        text = self.text()
        dictionary, codes = np.unique(
            np.where(self.valid, text, "").astype(str), return_inverse=True)
        return dataclasses.replace(self, dictionary=dictionary.astype(
            object), codes=codes.astype(np.int64), payload=None,
            offsets=None)

    def text(self) -> np.ndarray:
        """A string column's rows as ``str`` (empty under a null)."""
        if self.codes is not None:
            d = self.dictionary if len(self.dictionary) else \
                np.array([""], object)
            return np.where(self.valid, d[np.clip(self.codes, 0,
                                                  len(d) - 1)], "")
        raw = self.payload.tobytes()
        return np.array([raw[a:b].decode("utf-8", "surrogateescape")
                         for a, b in zip(self.offsets[:-1],
                                         self.offsets[1:])], dtype=object)


def columns_from_host(hb) -> List[EncColumn]:
    """A :class:`~..data.batch.HostBatch`'s columns; strings
    dictionary-encoded with a sorted ``np.unique``."""
    out = []
    for i, f in enumerate(hb.schema):
        vals, ok = hb.column_at(i)
        ok = np.asarray(ok, bool)
        if f.data_type is T.STRING:
            text = np.where(ok, np.asarray(vals, dtype=object), "")
            dictionary, codes = np.unique(text.astype(str),
                                          return_inverse=True)
            out.append(EncColumn(f.name, f.data_type, ok,
                                 dictionary=dictionary.astype(object),
                                 codes=codes.astype(np.int64)))
        else:
            out.append(EncColumn(f.name, f.data_type, ok,
                                 values=np.asarray(vals)))
    return out


# -- protobuf writer ------------------------------------------------------------


def _uvarint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _message(*fields) -> bytes:
    """A protobuf message of ``(number, value)``: an int as a varint,
    bytes as length-delimited, a list of ints packed."""
    out = bytearray()
    for number, value in fields:
        if value is None:
            continue
        if isinstance(value, (bytes, bytearray)):
            out += _uvarint(number << 3 | 2) + _uvarint(len(value)) + value
        elif isinstance(value, list):
            body = b"".join(_uvarint(v) for v in value)
            out += _uvarint(number << 3 | 2) + _uvarint(len(body)) + body
        else:
            out += _uvarint(number << 3) + _uvarint(int(value))
    return bytes(out)


# -- stream encoders ----------------------------------------------------------


def byte_rle(data: np.ndarray) -> bytes:
    """Byte-RLE of ``data`` (uint8) as literal groups of 128 bytes."""
    data = np.ascontiguousarray(data, np.uint8)
    n = len(data)
    full = n // 128
    out = np.empty(full * 129 + (n % 128 + 1 if n % 128 else 0), np.uint8)
    body = out[:full * 129].reshape(full, 129)
    body[:, 0] = 0x80
    body[:, 1:] = data[:full * 128].reshape(full, 128)
    rest = n % 128
    if rest:
        out[full * 129] = 256 - rest
        out[full * 129 + 1:] = data[full * 128:]
    return out.tobytes()


def _pack_be(u: np.ndarray, width: int) -> np.ndarray:
    """Rows of ``u`` (uint64 ``[r, c]``) as big-endian ``width``-bit
    values: uint8 ``[r, ceil(c * width / 8)]`` (each value's low
    ``width`` bits of its big-endian bytes, one byte a bit in between)."""
    r, c = u.shape
    be = np.ascontiguousarray(u.reshape(-1).astype(">u8")).view(np.uint8)
    bits = np.unpackbits(be.reshape(-1, 8), axis=1)[:, 64 - width:]
    return np.packbits(bits.reshape(r, c * width), axis=1)


def rlev2(values: np.ndarray, signed: bool) -> bytes:
    """RLEv2 of ``values`` (int64): DIRECT runs of 512, a last run of 3-10
    equal values as SHORT_REPEAT."""
    v = np.asarray(values, np.int64)
    u = ((v << 1) ^ (v >> 63)).view(np.uint64) if signed \
        else v.view(np.uint64)
    n = len(u)
    if n == 0:
        return b""
    n_runs = -(-n // RUN)
    counts = np.full(n_runs, RUN, np.int64)
    counts[-1] = n - RUN * (n_runs - 1)
    padded = np.zeros(n_runs * RUN, np.uint64)
    padded[:n] = u
    grid = padded.reshape(n_runs, RUN)
    top = grid.max(axis=1)
    bitlen = (top[:, None] >> np.arange(64, dtype=np.uint64)[None, :]
              > 0).sum(axis=1)
    widths = _CLOSEST[bitlen]
    pieces: List[Optional[bytes]] = [None] * n_runs
    last = counts[-1]
    tail = grid[-1, :last]
    if 3 <= last <= 10 and (tail == tail[0]).all():
        nbytes = max((int(tail[0]).bit_length() + 7) // 8, 1)
        pieces[-1] = bytes([((nbytes - 1) << 3) | (last - 3)]) + \
            int(tail[0]).to_bytes(nbytes, "big")
        direct = np.arange(n_runs - 1)
    else:
        direct = np.arange(n_runs)
    for w in np.unique(widths[direct]):
        rows = direct[widths[direct] == w]
        packed = _pack_be(grid[rows], int(w))
        for r, body in zip(rows.tolist(), packed):
            c = int(counts[r])
            hdr = bytes([0x40 | (_WIDTH_CODE[int(w)] << 1) | ((c - 1) >> 8),
                         (c - 1) & 0xFF])
            pieces[r] = hdr + body[:(c * int(w) + 7) // 8].tobytes()
    return b"".join(pieces)


def _compress(raw: bytes, codec: int, block: int, device) -> bytes:
    if codec == 0:
        return raw
    out = bytearray()
    for lo in range(0, len(raw), block):
        chunk = raw[lo:lo + block]
        if codec == 1:
            c = zlib.compressobj(1, zlib.DEFLATED, -15)
            body = c.compress(chunk) + c.flush()
        else:
            body = snappy.compress(chunk, device or "cpu")
        if len(body) >= len(chunk):
            out += (len(chunk) << 1 | 1).to_bytes(3, "little") + chunk
        else:
            out += (len(body) << 1).to_bytes(3, "little") + body
    return bytes(out)


def _column_streams(col: EncColumn):
    """(encoding, dictionary size, [(stream kind, raw bytes)]) of one
    column's rows."""
    dt = col.dtype
    valid = np.asarray(col.valid, bool)
    streams = []
    if not valid.all():
        streams.append((_S_PRESENT, byte_rle(np.packbits(valid))))
    if dt is T.STRING:
        if col.offsets is not None:   # flat: DIRECT_V2
            starts, ends = col.offsets[:-1][valid], col.offsets[1:][valid]
            lens = (ends - starts).astype(np.int64)
            total = int(lens.sum())
            pos = np.repeat(starts - np.concatenate(
                [[0], np.cumsum(lens)[:-1]]), lens) + np.arange(total)
            blob = col.payload[pos].tobytes() if total else b""
            streams += [(_S_DATA, blob), (_S_LENGTH, rlev2(lens, False))]
            return _E_DIRECT_V2, None, streams
        entries = [str(s).encode("utf-8", "surrogateescape")
                   for s in col.dictionary]
        lens = np.array([len(e) for e in entries], np.int64)
        streams += [(_S_DATA, rlev2(np.asarray(col.codes, np.int64)[valid],
                                    False)),
                    (_S_DICT, b"".join(entries)),
                    (_S_LENGTH, rlev2(lens, False))]
        return _E_DICT_V2, len(entries), streams
    vals = np.asarray(col.values)[valid]
    if dt in (T.FLOAT, T.DOUBLE):
        streams.append((_S_DATA, np.ascontiguousarray(
            vals, dt.np_dtype).tobytes()))
        return _E_DIRECT, None, streams
    if dt is T.BOOLEAN:
        streams.append((_S_DATA, byte_rle(np.packbits(vals.astype(bool)))))
        return _E_DIRECT, None, streams
    if dt is T.BYTE:
        streams.append((_S_DATA, byte_rle(vals.astype(np.int8).view(
            np.uint8))))
        return _E_DIRECT, None, streams
    streams.append((_S_DATA, rlev2(vals.astype(np.int64), True)))
    return _E_DIRECT_V2, None, streams


def write_orc(path: str, columns: List[EncColumn], compression="none",
              stripe_rows: int = 1 << 20, block_size: int = 1 << 18,
              device=None) -> int:
    """Write ``columns`` (one length) as an ORC file at ``path``; returns
    its size in bytes. ``compression`` is none, zlib or snappy;
    ``device`` picks the snappy routine (the C++ one for the card)."""
    key = str(compression or "none").lower()
    if key not in CODECS:
        raise NotImplementedError(f"ORC compression {compression!r} is not "
                                  "supported (none, zlib and snappy are)")
    codec = CODECS[key]
    for c in columns:
        if c.dtype.name not in _KIND:
            raise NotImplementedError(f"column {c.name!r}: type {c.dtype} "
                                      "is not supported by the ORC writer")
    n_rows = len(columns[0]) if columns else 0
    out = bytearray(MAGIC)
    stripes = []
    for lo in range(0, max(n_rows, 1), stripe_rows):
        hi = min(lo + stripe_rows, n_rows)
        if hi <= lo and n_rows:
            break
        infos, encs, body = [], [_message((1, _E_DIRECT))], bytearray()

        def encode(col):
            enc, dsize, streams = _column_streams(col.slice(lo, hi))
            return enc, dsize, [(kind, _compress(raw, codec, block_size,
                                                 device))
                                for kind, raw in streams]
        # a column a thread (zlib and numpy release the GIL), in order
        with ThreadPoolExecutor(max(1, min(len(columns), 8,
                                           os.cpu_count() or 1))) as ex:
            encoded = list(ex.map(encode, columns))
        for cid, (enc, dsize, streams) in enumerate(encoded, start=1):
            encs.append(_message((1, enc), (2, dsize)))
            for kind, data in streams:
                infos.append(_message((1, kind), (2, cid), (3, len(data))))
                body += data
        footer = _compress(_message(*[(1, s) for s in infos],
                                    *[(2, e) for e in encs]),
                           codec, block_size, device)
        stripes.append(_message((1, len(out)), (2, 0), (3, len(body)),
                                (4, len(footer)), (5, hi - lo)))
        out += body + footer
        if not n_rows:
            break
    types = [_message((1, _K_STRUCT), (2, list(range(1, len(columns) + 1))),
                      *[(3, c.name.encode()) for c in columns])]
    types += [_message((1, _KIND[c.dtype.name])) for c in columns]
    content = len(out) - len(MAGIC)
    footer = _compress(_message((1, len(MAGIC)), (2, content),
                                *[(3, s) for s in stripes],
                                *[(4, t) for t in types], (6, n_rows),
                                (8, 0)), codec, block_size, device)
    post = _message((1, len(footer)), (2, codec),
                    (3, block_size if codec else None), (4, [0, 12]),
                    (5, 0), (6, 6), (8000, MAGIC))
    out += footer + post + bytes([len(post)])
    with open(path, "wb") as f:
        f.write(out)
    return len(out)
