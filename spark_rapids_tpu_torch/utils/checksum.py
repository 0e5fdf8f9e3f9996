"""CRC32C block checksums — port of ``spark_rapids_tpu/utils/checksum.py``
(``crc32c``, ``ChecksumError``, ``verify``, ``stats``).

Every spill range (:mod:`..memory.spill`) and every shuffle block
(:mod:`..shuffle.exchange`) records a CRC32C (Castagnoli) when it is
written and verifies it on every read, so a flipped byte surfaces as a
typed :class:`ChecksumError` instead of a wrong answer.

Two implementations, chosen by the device of the data's owner, as the
snappy routine is (:mod:`..io.snappy`); neither gives way to the other:

* ``cuda``: the host C++ routine ``ops/kernels/cuda/csrc/crc32c.cpp``
  (SSE4.2 ``crc32`` instructions, slicing-by-8 tables where the host
  lacks them; a buffer of 8 MiB or more in pieces on up to 8 threads),
  built with the kernels and called through ``ctypes`` (which releases
  the GIL). A failed build raises.
* ``cpu``: :func:`crc32c_plain`, numpy only: the buffer's bytes run as
  many independent lanes in lockstep through the byte table, and the
  lanes' registers join through a table-driven shift past the bytes
  after them (CRC registers are linear over GF(2)). Up to
  :data:`_LANE_MIN` bytes take the byte table alone.

Both equal ``google_crc32c.extend(value, data)`` (the reference's
backend) bit for bit. ``crc32c_native.launches`` counts the C++ calls.
Process-wide counters (:func:`stats`) feed the query profile's
durability section.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from ..ops.kernels.cuda import _build
from . import lockdep

_POLY = 0x82F63B78


def _byte_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(_POLY), t >> 1)
    return t.astype(np.uint32)


_TABLE = _byte_table()
_TABLE_LIST = _TABLE.tolist()
#: Buffers up to this many bytes take the byte loop alone.
_LANE_MIN = 1 << 12


@functools.lru_cache(maxsize=64)
def _shift_tables(n_bytes: int) -> np.ndarray:
    """uint32 ``[4, 256]``: entry ``[k, v]`` is the register after feeding
    ``n_bytes`` zero bytes into a register holding byte ``v`` at byte
    position ``k``. The zero-byte step is linear, so the 32 basis
    registers' images, XORed by bit, give every table entry."""
    basis = np.uint32(1) << np.arange(32, dtype=np.uint32)
    for _ in range(n_bytes):
        basis = (basis >> np.uint32(8)) ^ _TABLE[basis & np.uint32(0xFF)]
    v = np.arange(256, dtype=np.uint32)
    out = np.zeros((4, 256), np.uint32)
    for k in range(4):
        for bit in range(8):
            out[k] ^= np.where((v >> np.uint32(bit)) & np.uint32(1),
                               basis[8 * k + bit], np.uint32(0))
    return out


def _bytes_update(reg: int, data) -> int:
    table = _TABLE_LIST
    for b in bytes(data):
        reg = (reg >> 8) ^ table[(reg ^ b) & 0xFF]
    return reg


def crc32c_plain(data, value: int = 0) -> int:
    """CRC32C of ``data`` (bytes-like) continuing ``value`` — the plain
    version (numpy), what the CPU path runs."""
    buf = np.frombuffer(memoryview(data).cast("B"), np.uint8)
    reg = (int(value) ^ 0xFFFFFFFF) & 0xFFFFFFFF
    n = buf.size
    if n <= _LANE_MIN:
        return _bytes_update(reg, buf) ^ 0xFFFFFFFF
    # K lanes of L bytes: L a power of two near sqrt(n) keeps both the
    # lockstep loop and the join short, and the shift tables few.
    lane = max(256, 1 << (int(np.sqrt(n)).bit_length() - 1))
    k = n // lane
    body = buf[:k * lane].reshape(k, lane).T.copy()  # [L, K], row t = byte t
    regs = np.zeros(k, np.uint32)
    regs[0] = reg
    for t in range(lane):
        regs = (regs >> np.uint32(8)) ^ \
            _TABLE[(regs ^ body[t]) & np.uint32(0xFF)]
    sh = _shift_tables(lane)
    out = int(regs[0])
    for r in regs[1:].tolist():
        out = int(sh[0, out & 0xFF] ^ sh[1, (out >> 8) & 0xFF]
                  ^ sh[2, (out >> 16) & 0xFF] ^ sh[3, out >> 24]) ^ r
    return _bytes_update(out, buf[k * lane:]) ^ 0xFFFFFFFF


def _lib() -> ctypes.CDLL:
    lib = _build.load("crc32c")
    if lib.srt_crc32c.argtypes is None:
        p, i64, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32
        for fn in (lib.srt_crc32c, lib.srt_crc32c_sw):
            fn.argtypes = [p, i64, u32]
            fn.restype = u32
        lib.srt_crc32c_hw.argtypes = []
        lib.srt_crc32c_hw.restype = ctypes.c_int
    return lib


def _native(device) -> bool:
    kind = getattr(device, "type", device) or "cpu"
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"crc32c runs for CUDA or CPU owners, not {device}")
    return kind == "cuda"


def _as_u8(data) -> np.ndarray:
    return np.ascontiguousarray(np.frombuffer(memoryview(data).cast("B"),
                                              np.uint8))


def crc32c_native(data, value: int = 0, tables_only: bool = False) -> int:
    """The C++ routine (``tables_only``: its slicing-by-8 path on one
    thread, even where the SSE4.2 one runs)."""
    buf = _as_u8(data)
    lib = _lib()
    fn = lib.srt_crc32c_sw if tables_only else lib.srt_crc32c
    out = int(fn(buf.ctypes.data, buf.size, int(value) & 0xFFFFFFFF))
    with _STATS_LOCK:
        _COUNTED.launches += 1
    return out


def hardware_path() -> bool:
    """Whether the C++ routine takes the SSE4.2 instructions here."""
    return bool(_lib().srt_crc32c_hw())


_STATS_LOCK = lockdep.lock("checksum._STATS_LOCK")
_STATS = {"computed": 0, "verified": 0, "failures": 0}


def _crc(data, value: int, device) -> int:
    if _native(device):
        return crc32c_native(data, value)
    return crc32c_plain(data, value)


def crc32c(data, value: int = 0, device="cpu") -> int:
    """CRC32C of ``data`` (bytes-like), continuing ``value``: the C++
    routine for a ``cuda`` owner, the plain version for ``cpu``."""
    with _STATS_LOCK:
        _STATS["computed"] += 1
    return _crc(data, value, device)


class ChecksumError(IOError):
    """Stored bytes do not match their recorded CRC32C. An ``IOError``
    as in the reference (its retry taxonomy reads OSErrors as
    transient); it never surfaces as data."""

    def __init__(self, context: str, expected: int, actual: int):
        super().__init__(
            f"checksum mismatch reading {context}: stored crc32c="
            f"{expected:#010x}, computed {actual:#010x} — corrupt data "
            "detected (refusing to return it)")
        self.context = context
        self.expected = expected
        self.actual = actual


def verify(data, expected: int, context: str, ctx=None,
           node: Optional[str] = None, device="cpu") -> None:
    """Raise :class:`ChecksumError` unless ``crc32c(data) == expected``;
    ``ctx``/``node`` record the failure in ``checksumFailures`` first."""
    actual = _crc(data, 0, device)
    with _STATS_LOCK:
        if actual == expected:
            _STATS["verified"] += 1
            return
        _STATS["failures"] += 1
    if ctx is not None and node is not None:
        ctx.metric(node, "checksumFailures", 1)
    raise ChecksumError(context, expected, actual)


def stats() -> dict:
    """Process-wide ``{"computed", "verified", "failures"}`` (the query
    profile takes per-query deltas)."""
    with _STATS_LOCK:
        return dict(_STATS)


#: C++ calls since the last reset (the plain version does not count).
#: ``_COUNTED`` keeps the owner of the count when a caller rebinds the
#: module attribute.
crc32c_native.launches = 0
_COUNTED = crc32c_native
