"""Raw snappy blocks — what ``pa.Codec("snappy")`` does for the
reference's parquet scan and writer (``spark_rapids_tpu/io/
parquet_device.py:254-259``, ``parquet_encode.py:266-269``).

:func:`decompress_pages` decompresses a whole column chunk's pages, each
into its own range of one host buffer; :func:`compress` compresses one
page. For a scan or a write on the card they call the host C++ routine
``ops/kernels/cuda/csrc/snappy.cpp`` (built with the kernels, bound
through ``ctypes``, which releases the GIL around the call) and raise if
it fails; on the CPU they take :func:`decompress_plain` and
:func:`compress_plain`, the plain Python versions (byte for byte the
same compressor). There is no fallback from one to the other.

``decompress_pages.launches`` and ``compress.launches`` count the C++
calls. Host routines, not device kernels: the run headers of parquet's
hybrid streams lie inside the compressed payload, so the scan parses
them on the host after decompression.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..ops.kernels.cuda import _build

#: Block size of the compressor: offsets within a block fit two bytes.
BLOCK = 1 << 16
_HASH_BITS = 14


class SnappyError(ValueError):
    """Malformed snappy input."""


def _varint(buf, pos: int):
    out = shift = 0
    while True:
        if pos >= len(buf) or shift > 35:
            raise SnappyError("snappy input ends inside the length varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def decompress_plain(data, expected: int = None) -> bytes:
    """Decompress one raw snappy block (plain Python). ``expected`` is
    the size the caller knows (a page header's); a different preamble
    raises."""
    data = memoryview(data).cast("B")
    n, p = _varint(data, 0)
    if expected is not None and n != expected:
        raise SnappyError(f"snappy length preamble {n} differs from the "
                          f"page's size {expected}")
    out = bytearray()
    end = len(data)
    w = 0  # bytes written
    while p < end:
        tag = data[p]
        p += 1
        kind = tag & 3
        if kind == 0:
            lit = tag >> 2
            if lit >= 60:
                extra = lit - 59
                if end - p < extra:
                    raise SnappyError("snappy input ends inside a literal "
                                      "length")
                lit = int.from_bytes(data[p:p + extra], "little")
                p += extra
            lit += 1
            if end - p < lit:
                raise SnappyError("snappy input ends inside a literal")
            if n - w < lit:
                raise SnappyError("snappy literal writes past the output's "
                                  "end")
            out += data[p:p + lit]
            p += lit
            w += lit
            continue
        if kind == 1:
            if end - p < 1:
                raise SnappyError("snappy input ends inside a copy")
            length = 4 + ((tag >> 2) & 7)
            offset = ((tag >> 5) << 8) | data[p]
            p += 1
        else:
            width = 2 if kind == 2 else 4
            if end - p < width:
                raise SnappyError("snappy input ends inside a copy")
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[p:p + width], "little")
            p += width
        if offset == 0 or offset > w:
            raise SnappyError(f"snappy copy offset {offset} with {w} bytes "
                              "written")
        if n - w < length:
            raise SnappyError("snappy copy writes past the output's end")
        start = w - offset
        if offset >= length:
            out += out[start:start + length]
        else:  # overlapping: the last ``offset`` bytes repeat
            out += (out[start:] * (length // offset + 1))[:length]
        w += length
    if w != n:
        raise SnappyError(f"snappy input ends after {w} of {n} bytes")
    return bytes(out)


def _put_literal(out: bytearray, src, a: int, b: int) -> None:
    n = b - a
    if n <= 0:
        return
    m = n - 1
    if m < 60:
        out.append(m << 2)
    else:
        nbytes = (m.bit_length() + 7) // 8
        out.append((59 + nbytes) << 2)
        out += m.to_bytes(nbytes, "little")
    out += src[a:b]


def _put_copy(out: bytearray, offset: int, length: int) -> None:
    while length > 0:
        n = min(length, 64)
        if 4 <= n <= 11 and offset < 2048:
            out.append(1 | ((n - 4) << 2) | ((offset >> 8) << 5))
            out.append(offset & 0xFF)
        else:
            out.append(2 | ((n - 1) << 2))
            out += offset.to_bytes(2, "little")
        length -= n


def compress_plain(data) -> bytes:
    """Compress one buffer into a raw snappy block (plain Python): a
    greedy 4-byte-hash matcher over 64 KiB blocks, byte for byte
    ``csrc/snappy.cpp``'s ``srt_snappy_compress``."""
    src = bytes(memoryview(data).cast("B"))
    n = len(src)
    out = bytearray()
    v = n
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    shift = 32 - _HASH_BITS
    for bs in range(0, n, BLOCK):
        be = min(bs + BLOCK, n)
        table = {}
        i = lit = bs
        misses = 32
        while i + 4 <= be:
            word = src[i:i + 4]
            h = ((int.from_bytes(word, "little") * 0x1E35A7BD)
                 & 0xFFFFFFFF) >> shift
            cand = table.get(h, -1)
            table[h] = i
            if cand >= 0 and src[cand:cand + 4] == word:
                m = 4
                while i + m < be and src[cand + m] == src[i + m]:
                    m += 1
                _put_literal(out, src, lit, i)
                _put_copy(out, i - cand, m)
                i += m
                lit = i
                misses = 32
            else:
                i += misses >> 5
                misses += 1
        _put_literal(out, src, lit, be)
    return bytes(out)


def _lib() -> ctypes.CDLL:
    lib = _build.load("snappy")
    if lib.srt_snappy_decompress_pages.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.srt_snappy_decompress_pages.argtypes = [p, i64, p, i64, p, i64,
                                                    p]
        lib.srt_snappy_decompress_pages.restype = ctypes.c_int
        lib.srt_snappy_compress.argtypes = [p, i64, p, i64, p]
        lib.srt_snappy_compress.restype = ctypes.c_int
        lib.srt_snappy_max_compressed_length.argtypes = [i64]
        lib.srt_snappy_max_compressed_length.restype = i64
    return lib


def _native(device) -> bool:
    """True for a ``cuda`` device (a ``torch.device`` or its name), False
    for ``cpu``. The module imports no torch, so worker processes that
    check pages with the plain version start quickly."""
    kind = getattr(device, "type", None) or str(device).split(":")[0]
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"snappy runs for CUDA or CPU scans, not {device}")
    return kind == "cuda"


def decompress_pages(src: np.ndarray, pages: np.ndarray, dst: np.ndarray,
                     device) -> None:
    """Decompress every page of a column chunk: ``src`` the chunk's bytes
    (uint8), ``pages`` int64 ``[n, 4]`` rows of (src offset, src bytes,
    dst offset, dst bytes), ``dst`` the writable uint8 host buffer the
    pages land in. ``device`` is the scan's: ``cuda`` calls the C++
    routine once for the chunk, ``cpu`` the plain version page by
    page."""
    pages = np.ascontiguousarray(pages, dtype=np.int64).reshape(-1, 4)
    if src.dtype != np.uint8 or dst.dtype != np.uint8 \
            or not dst.flags.writeable or not dst.flags.c_contiguous:
        raise ValueError("decompress_pages takes contiguous uint8 buffers "
                         "and a writable destination")
    if not _native(device):
        for so, sn, do, dn in pages.tolist():
            if so < 0 or sn < 0 or so + sn > len(src) or do < 0 or dn < 0 \
                    or do + dn > len(dst):
                raise SnappyError("page range lies outside the buffers")
            dst[do:do + dn] = np.frombuffer(
                decompress_plain(src[so:so + sn], dn), np.uint8)
        return
    src = np.ascontiguousarray(src)
    lib = _lib()
    bad = ctypes.c_int64(-1)
    rc = lib.srt_snappy_decompress_pages(
        src.ctypes.data, len(src), pages.ctypes.data, len(pages),
        dst.ctypes.data, len(dst), ctypes.byref(bad))
    if rc != 0:
        raise SnappyError(f"page {bad.value}: "
                          f"{lib.srt_error_string(rc).decode()}")
    with _COUNT_LOCK:  # the scan's pipeline calls from several threads
        _COUNTED["decompress_pages"].launches += 1


def compress(data, device) -> bytes:
    """One raw snappy block of ``data``: the C++ routine for a write
    from the card (``device`` ``cuda``), the plain version for the
    CPU."""
    if not _native(device):
        return compress_plain(data)
    src = np.ascontiguousarray(np.frombuffer(data, np.uint8))
    lib = _lib()
    cap = lib.srt_snappy_max_compressed_length(len(src))
    out = np.empty(cap, np.uint8)
    n = ctypes.c_int64(0)
    rc = lib.srt_snappy_compress(src.ctypes.data, len(src), out.ctypes.data,
                                 cap, ctypes.byref(n))
    if rc != 0:
        raise SnappyError(lib.srt_error_string(rc).decode())
    with _COUNT_LOCK:
        _COUNTED["compress"].launches += 1
    return out[:n.value].tobytes()


#: C++ calls since the last reset (CPU scans take the plain versions and
#: do not count). ``_COUNTED`` keeps the owners of the counts when a
#: caller rebinds the module attributes (a capturing wrapper).
decompress_pages.launches = 0
compress.launches = 0
_COUNTED = {"decompress_pages": decompress_pages, "compress": compress}
_COUNT_LOCK = threading.Lock()
