"""Spark's murmur3 row hash and hash partitioning — port of
``spark_rapids_tpu/shuffle/partitioning.py``.

Hash partitioning reproduces **Spark's Murmur3Hash** bit for bit (seed
42, per-column chaining, null columns skipped) so that a row lands in the
partition CPU Spark would give it.

torch's ``uint32`` supports few operations, so the helpers here work on
*u32 lanes*: int64 tensors holding values in ``[0, 2**32)``. Every step
masks back to 32 bits, right shifts of such values are logical, and
:func:`_mul32` multiplies through 16-bit halves of the constant so no
int64 product overflows. Hashes leave :func:`spark_hash_columns_device`
as int32 bits, as the port stores them.

String columns hash from their own layout (a dictionary's entry bytes
and codes, a flat column's payload and offsets) with the ``hash`` kernel
(:mod:`..ops.kernels.cuda.hashing`), so no char matrix is built on the
card; :func:`murmur3_string_rows` is that entry's plain version, the
column's char matrix hashed by :func:`murmur3_bytes_rows`, the matrix
entry's plain version. Fixed-width columns hash in plain torch, as the
reference leaves them to XLA.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import types as T
from ..data.column import DeviceColumn
from ..ops.strings_util import _matrix_from_offsets

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_M32 = 0xFFFFFFFF
SPARK_SEED = 42


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for a u32 lane ``x`` and a 32-bit constant,
    without an int64 product past 2**49."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    k1 = _mul32(k1, _C1)
    k1 = _rotl32(k1, 15)
    return _mul32(k1, _C2)


def _mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    h1 = h1 ^ k1
    h1 = _rotl32(h1, 13)
    return (_mul32(h1, 5) + 0xE6546B64) & _M32


def _fmix(h1: torch.Tensor, length) -> torch.Tensor:
    """Murmur3's finaliser; ``length`` is an int or an integer lane (its
    low 32 bits are folded in)."""
    if isinstance(length, torch.Tensor):
        length = length.to(torch.int64) & _M32
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul32(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul32(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def _fmix_len(h1: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """:func:`_fmix` with per-row byte lengths (the string hash's)."""
    return _fmix(h1, lengths)


def u32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit pattern of an integer lane (int32 bits, or an int64
    whose low word counts) as a u32 lane."""
    return x.to(torch.int64) & _M32


def to_int32_bits(h: torch.Tensor) -> torch.Tensor:
    """A u32 lane as int32 bits (values >= 2**31 wrap negative)."""
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


def murmur3_int32(values: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark Murmur3Hash of an int-like 4-byte value; ``seed`` and the
    result are u32 lanes."""
    h1 = _mix_h1(seed, _mix_k1(u32(values)))
    return _fmix(h1, 4)


def murmur3_int64(values: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark Murmur3Hash of an 8-byte value: low word, then high word."""
    v = values.to(torch.int64)
    lo = v & _M32
    hi = (v >> 32) & _M32
    h1 = _mix_h1(seed, _mix_k1(lo))
    h1 = _mix_h1(h1, _mix_k1(hi))
    return _fmix(h1, 8)


def _spark_normalize_float(data: torch.Tensor):
    """(bits, width): Spark hashes a float's raw IEEE bits, with NaN made
    the canonical NaN and -0.0 made 0.0."""
    if data.dtype == torch.float32:
        bits = data.contiguous().view(torch.int32)
        bits = torch.where(torch.isnan(data), 0x7FC00000, bits)
        bits = torch.where(data == 0, 0, bits)
        return bits.to(torch.int32), 32
    bits = data.to(torch.float64).contiguous().view(torch.int64)
    bits = torch.where(torch.isnan(data), 0x7FF8000000000000, bits)
    bits = torch.where(data == 0, 0, bits)
    return bits, 64


def hash_column(data: torch.Tensor, validity: torch.Tensor,
                dtype: T.DataType, seed: torch.Tensor) -> torch.Tensor:
    """One fixed-width column folded into the running u32 hash ``seed``:
    ``murmur3(value, seed)``; null rows keep the incoming seed. Booleans,
    ints and dates hash as int (Spark widens them), bigints as long,
    floats by their normalised bits (a float32 lane as int, a float64
    lane as long)."""
    if data.is_floating_point():
        bits, width = _spark_normalize_float(data)
        h = murmur3_int32(bits, seed) if width == 32 \
            else murmur3_int64(bits, seed)
    elif dtype is T.LONG:
        h = murmur3_int64(data, seed)
    else:  # boolean, int, date
        h = murmur3_int32(data.to(torch.int32), seed)
    return torch.where(validity, h, seed)


def murmur3_bytes_rows(mat: torch.Tensor, lengths: torch.Tensor,
                       seed: torch.Tensor) -> torch.Tensor:
    """Spark ``Murmur3_x86_32.hashUnsafeBytes`` of each row of an int16
    ``[n, W]`` char matrix (PAD -1 past the end), with per-row byte
    ``lengths`` and per-row ``seed`` (both int32, the seed as uint32
    bits); returns int32 bits. Each full 4-byte little-endian block while
    ``length >= i + 4``, then each tail byte as a SIGNED int through the
    full mix, then fmix with the length. The ``hash`` kernel's plain
    version."""
    n, w = mat.shape
    lengths = lengths.to(torch.int64)
    h1 = u32(seed).expand(n).clone() if seed.dim() == 0 else u32(seed)
    valid_char = mat != -1
    chars = torch.where(valid_char, mat, 0).to(torch.int64) & _M32
    for b in range(w // 4):
        i = b * 4
        k1 = (chars[:, i] | (chars[:, i + 1] << 8) | (chars[:, i + 2] << 16)
              | (chars[:, i + 3] << 24)) & _M32
        nh = _mix_h1(h1, _mix_k1(k1))
        h1 = torch.where(lengths >= i + 4, nh, h1)
    # The 0-3 tail bytes sit at positions tail_start + j; the reference
    # walks every position and masks, which selects the same ones.
    signed = torch.where(valid_char, mat, 0).to(torch.int64)
    signed = torch.where(signed > 127, signed - 256, signed)
    tail_start = torch.div(lengths, 4, rounding_mode="floor") * 4
    rows = torch.arange(n, device=mat.device)
    for j in range(3):
        pos = tail_start + j
        in_tail = (pos >= 0) & (pos < lengths) & (pos < w)
        c = signed[rows, pos.clamp(0, max(w - 1, 0))] if w else \
            torch.zeros(n, dtype=torch.int64, device=mat.device)
        nh = _mix_h1(h1, _mix_k1(c & _M32))
        h1 = torch.where(in_tail, nh, h1)
    return to_int32_bits(_fmix_len(h1, lengths))


def murmur3_string_rows(payload: torch.Tensor, offsets: torch.Tensor,
                        codes: Optional[torch.Tensor], width: int,
                        seed: torch.Tensor) -> torch.Tensor:
    """Spark murmur3 of each row of a string column given by its layout:
    ``payload`` and ``offsets`` of its entries, the ``codes`` of its rows
    for a dictionary (clamped into it) or ``None`` for a flat column. The
    ``width``-wide char matrix of the column and its byte lengths, hashed
    by :func:`murmur3_bytes_rows`: the ragged ``hash`` entry's plain
    version."""
    mat = _matrix_from_offsets(payload, offsets, width)
    lengths = offsets[1:] - offsets[:-1]
    if codes is not None:
        safe = codes.long().clamp(0, mat.shape[0] - 1)
        mat, lengths = mat[safe], lengths[safe]
    return murmur3_bytes_rows(mat, lengths, seed)


def spark_hash_columns_device(cols: Sequence[DeviceColumn],
                              seed: int = SPARK_SEED) -> torch.Tensor:
    """Spark's row hash over device columns, int32 bits ``[capacity]``:
    the running hash starts at ``seed`` and each column folds in turn; a
    null keeps the running hash. A string column hashes from its own
    layout through the ``hash`` kernel's ragged entry, as wide as its
    char matrix would be."""
    from ..ops.kernels.cuda import hashing as HK
    n = cols[0].capacity
    h = torch.full((n,), seed & _M32, dtype=torch.int64,
                   device=cols[0].device)
    for c in cols:
        if c.is_string:
            payload, offsets = c.dict_bytes if c.is_dict \
                else (c.data, c.offsets)
            nh = HK.murmur3_string_rows(payload, offsets, c.codes,
                                        max(c.max_bytes, 1),
                                        to_int32_bits(h))
            h = torch.where(c.validity, u32(nh), h)
        else:
            h = hash_column(c.data, c.validity, c.dtype, h)
    return to_int32_bits(h)


def pmod_partition(hash32: torch.Tensor, n_parts: int) -> torch.Tensor:
    """``pmod(hash, n)``, Spark's HashPartitioning: int32 ids in
    ``[0, n)``."""
    m = torch.remainder(hash32.to(torch.int64), n_parts)
    return torch.where(m < 0, m + n_parts, m).to(torch.int32)
