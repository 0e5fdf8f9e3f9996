"""Spark's murmur3 string row hash (kernel family ``hash``).

Port of ``spark_rapids_tpu/ops/kernels/pallas/hashing.py``
(``murmur3_bytes_rows``), with two entries into ``csrc/hashing.cu``:

* :func:`murmur3_bytes_rows` hashes the rows of a char matrix, the
  Pallas kernel's input;
* :func:`murmur3_string_rows` hashes a string column from its own layout
  (a dictionary's entry bytes and codes, or a flat column's payload and
  offsets), the same hash as the matrix of the column gives, without
  building that ``[n, W]`` matrix. Every hash exchange takes it.

Each launches its kernel for CUDA tensors and takes its plain version
(``shuffle/partitioning.py``'s, which shares its mix steps with the
fixed-width hashes) for CPU tensors; a CUDA tensor the kernel cannot take
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ....shuffle.partitioning import \
    murmur3_bytes_rows as murmur3_bytes_rows_plain  # noqa: F401
from ....shuffle.partitioning import \
    murmur3_string_rows as murmur3_string_rows_plain  # noqa: F401
from . import _build


def _lib() -> ctypes.CDLL:
    lib = _build.load("hashing")
    fn = lib.srt_murmur3_rows
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, i64, i64, p, p, p, p]
        fn.restype = ctypes.c_int
        fn = lib.srt_murmur3_string_rows
        fn.argtypes = [p, i64, p, i64, p, i64, i64, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def murmur3_bytes_rows(mat: torch.Tensor, lengths: torch.Tensor,
                       seed: torch.Tensor) -> torch.Tensor:
    """Spark murmur3 of each row of an int16 ``[n, W]`` char matrix (PAD
    -1 past each row's end) with int32 byte ``lengths`` ``[n]`` and int32
    ``seed`` ``[n]`` (uint32 bits); returns int32 ``[n]`` (uint32 bits)."""
    tensors = (mat, lengths, seed)
    if all(t.device.type == "cpu" for t in tensors):
        return murmur3_bytes_rows_plain(mat, lengths, seed)
    dev = mat.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("murmur3 hash runs on CUDA or CPU tensors: mat on "
                         f"{dev}, lengths on {lengths.device}, seed on "
                         f"{seed.device}")
    if mat.dtype != torch.int16 or mat.dim() != 2 \
            or not mat.is_contiguous():
        raise ValueError(f"mat must be a contiguous [n, W] int16 tensor, got "
                         f"{mat.dtype} {tuple(mat.shape)}")
    n, w = mat.shape
    if w % 4 != 0 or w == 0:
        raise ValueError(f"char-matrix width {w} is not a positive multiple "
                         "of 4")
    _build.check_lane(lengths, "lengths", (torch.int32,), n)
    _build.check_lane(seed, "seed", (torch.int32,), n)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    if mat.data_ptr() % 16:
        raise ValueError("mat is not 16-byte aligned")
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.srt_murmur3_rows(mat.data_ptr(), n, w, lengths.data_ptr(),
                                  seed.data_ptr(), out.data_ptr(), stream)
    _build.check(lib, rc, "murmur3 launch")
    _COUNTED.launches += 1
    return out


def murmur3_string_rows(payload: torch.Tensor, offsets: torch.Tensor,
                        codes: Optional[torch.Tensor], width: int,
                        seed: torch.Tensor) -> torch.Tensor:
    """Spark murmur3 of each row of a string column from its own layout:
    the uint8 ``payload`` and int32 ``offsets`` of its entries, and for a
    dictionary column the int32 ``codes`` of its rows (clamped into the
    dictionary; ``None`` for a flat column, whose rows are the entries).
    Each row hashes its first ``min(length, width)`` bytes and folds its
    full length, with the int32 ``seed`` of its row (uint32 bits);
    returns int32 ``[n]``, bit for bit ``murmur3_bytes_rows`` of the
    column's ``width``-wide char matrix."""
    tensors = (payload, offsets, seed) + ((codes,) if codes is not None
                                          else ())
    if all(t.device.type == "cpu" for t in tensors):
        return murmur3_string_rows_plain(payload, offsets, codes, width,
                                         seed)
    dev = payload.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("murmur3 string hash runs on CUDA or CPU tensors, "
                         "got " + ", ".join(str(t.device) for t in tensors))
    _build.check_lane(payload, "payload", (torch.uint8,))
    _build.check_lane(offsets, "offsets", (torch.int32,))
    entries = offsets.shape[0] - 1
    if codes is not None:
        _build.check_lane(codes, "codes", (torch.int32,))
    n = entries if codes is None else codes.shape[0]
    _build.check_lane(seed, "seed", (torch.int32,), n)
    if width < 1:
        raise ValueError(f"width must be positive, got {width}")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    if payload.shape[0] == 0 or entries < 1:
        raise ValueError("a string column needs a payload byte and an "
                         "entry: got payload of "
                         f"{payload.shape[0]} bytes, {entries} entries")
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.srt_murmur3_string_rows(
            payload.data_ptr(), payload.shape[0], offsets.data_ptr(),
            entries, None if codes is None else codes.data_ptr(), n, width,
            seed.data_ptr(), out.data_ptr(), stream)
    _build.check(lib, rc, "murmur3 string launch")
    _STRING_COUNTED.launches += 1
    return out


#: Kernel launches since the last reset, one count per entry (CPU calls
#: take the plain version and do not count). ``_COUNTED`` and
#: ``_STRING_COUNTED`` keep the owners of the counts when a caller
#: rebinds a module attribute (a capturing wrapper).
murmur3_bytes_rows.launches = 0
murmur3_string_rows.launches = 0
_COUNTED = murmur3_bytes_rows
_STRING_COUNTED = murmur3_string_rows
