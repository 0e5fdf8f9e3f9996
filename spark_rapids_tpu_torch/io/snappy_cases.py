"""Edge cases of the snappy codec (numpy only), shared by the tests and
``chip_smoke.py``: raw snappy blocks written element by element, so
every tag kind appears — literals with 0 to 4 extra length bytes, copies
with 1-, 2- and 4-byte offsets, overlapping copies (offset below the
length, offset 1) — and malformed blocks that must raise.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def literal(data: bytes, extra: int = -1) -> bytes:
    """A literal element; ``extra`` forces 1-4 length bytes after the
    tag (-1: the shortest form)."""
    m = len(data) - 1
    if extra < 0:
        extra = 0 if m < 60 else (m.bit_length() + 7) // 8
    if extra == 0:
        return bytes([m << 2]) + data
    return bytes([(59 + extra) << 2]) + m.to_bytes(extra, "little") + data


def copy(offset: int, length: int, width: int) -> bytes:
    """A copy element with a ``width``-byte offset (1: length 4-11 and
    offset below 2048; 2 and 4: length 1-64)."""
    if width == 1:
        return bytes([1 | ((length - 4) << 2) | ((offset >> 8) << 5),
                      offset & 0xFF])
    kind = 2 if width == 2 else 3
    return bytes([kind | ((length - 1) << 2)]) + offset.to_bytes(width,
                                                                 "little")


def block(expected: bytes, *elements: bytes) -> bytes:
    return _varint(len(expected)) + b"".join(elements)


def valid_cases(seed: int = 0) -> Dict[str, Tuple[bytes, bytes]]:
    """name -> (raw snappy block, the bytes it decompresses to)."""
    rng = np.random.default_rng(seed)
    r = lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()  # noqa
    cases = {}
    a, b = r(60), r(300)
    cases["literal, length in the tag (60)"] = (block(a, literal(a)), a)
    cases["literal, 1 extra byte"] = (block(b[:200], literal(b[:200])),
                                      b[:200])
    big = r(70_000)
    cases["literal, 2 extra bytes"] = (block(big[:65_536],
                                             literal(big[:65_536])),
                                       big[:65_536])
    cases["literal, 3 extra bytes"] = (block(big, literal(big)), big)
    c = r(5)
    cases["literal, 4 extra bytes"] = (block(c, literal(c, extra=4)), c)
    cases["empty block"] = (b"\x00", b"")
    d = r(40)
    cases["copy, 1-byte offset"] = (
        block(d + d[8:19], literal(d), copy(32, 11, 1)), d + d[8:19])
    far = r(3000)
    cases["copy, 1-byte offset at 2047"] = (
        block(far + far[953:957], literal(far), copy(2047, 4, 1)),
        far + far[953:957])
    cases["copy, 2-byte offset"] = (
        block(far + far[:64], literal(far), copy(3000, 64, 2)),
        far + far[:64])
    cases["copy, 4-byte offset"] = (
        block(big + big[5:25], literal(big), copy(69_995, 20, 4)),
        big + big[5:25])
    cases["overlapping copy, offset 1"] = (
        block(b"x" * 65, literal(b"x"), copy(1, 64, 2)), b"x" * 65)
    cases["overlapping copy, offset 3"] = (
        block(b"abc" * 4, literal(b"abc"), copy(3, 9, 1)), b"abc" * 4)
    cases["overlapping copy, offset 7, 4-byte form"] = (
        block(d[:7] + (d[:7] * 10)[:60], literal(d[:7]), copy(7, 60, 4)),
        d[:7] + (d[:7] * 10)[:60])
    runs = bytes(np.repeat(rng.integers(0, 5, 2000, dtype=np.uint8), 9))
    elements, out, i = [], b"", 0
    while i < len(runs):  # literal, then copies of the last 8 bytes
        n = min(8, len(runs) - i)
        elements.append(literal(runs[i:i + n]))
        out += runs[i:i + n]
        i += n
        if i + 4 <= len(runs) and runs[i:i + 4] == out[-8:-4]:
            elements.append(copy(8, 4, 1))
            out += out[-8:-4]
            i += 4
    cases["many short elements"] = (block(out, *elements), out)
    return cases


def malformed_cases(seed: int = 0) -> Dict[str, bytes]:
    """name -> a raw snappy block that must raise (for the size its
    preamble states)."""
    d = np.random.default_rng(seed).integers(0, 256, 40, dtype=np.uint8
                                             ).tobytes()
    return {
        "empty input": b"",
        "preamble only, output missing": _varint(10),
        "varint never ends": b"\xff\xff\xff\xff\xff\xff",
        "literal past the input": _varint(40) + literal(d)[:-3],
        "literal length bytes missing": _varint(5) + bytes([62 << 2, 1]),
        "literal past the output": _varint(10) + literal(d[:20]),
        "copy offset 0": _varint(20) + literal(d[:10]) + copy(0, 10, 2),
        "copy offset before the start": _varint(20) + literal(d[:10])
        + copy(11, 10, 2),
        "copy past the output": _varint(12) + literal(d[:10])
        + copy(4, 8, 2),
        "copy offset bytes missing": _varint(20) + literal(d[:10])
        + bytes([3 | (9 << 2), 1, 0]),
        "input ends early": _varint(30) + literal(d[:10]),
    }


def compress_inputs(seed: int = 5) -> Dict[str, bytes]:
    """name -> a buffer to compress: empty, tiny, runs, zeros, random
    bytes, repeated int64 keys, decimal-like doubles."""
    rng = np.random.default_rng(seed)
    return {
        "empty": b"", "one byte": b"q", "short": b"abcabcabcabc",
        "zeros": bytes(70_000),
        "runs": bytes(np.repeat(rng.integers(0, 9, 30_000, dtype=np.uint8),
                                rng.integers(1, 12, 30_000))),
        "random": rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes(),
        "int64 keys": np.repeat(np.arange(5_000, dtype=np.int64),
                                4).tobytes(),
        "doubles": np.round(rng.uniform(900, 105_000, 10_000), 2).tobytes(),
    }


def page_batch(cases: Dict[str, Tuple[bytes, bytes]]
               ) -> Tuple[np.ndarray, np.ndarray, int, List[bytes]]:
    """Every valid case as one page list: (src bytes, pages int64 [n, 4]
    of src offset, src bytes, dst offset, dst bytes, the dst size, the
    expected pages), each page at an odd destination offset."""
    src, pages, wants, dst = b"", [], [], 3
    for raw, want in cases.values():
        pages.append((len(src), len(raw), dst, len(want)))
        src += raw
        wants.append(want)
        dst += len(want) + 5
    return (np.frombuffer(src, np.uint8).copy(), np.array(pages, np.int64),
            dst, wants)
