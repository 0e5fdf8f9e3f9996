"""The ``strings`` kernels: two gathers of flat string rows, and the
rowwise compare of two char matrices.

Port of ``spark_rapids_tpu/ops/kernels/pallas/strings.py``, three
entries into ``csrc/strings.cu``:

* :func:`gather_strings` gathers a flat string column from its own
  layout (payload and offsets) straight into the gathered column's
  payload and offsets, with no char matrix on either side. Bit for bit it
  is the char-matrix route (:func:`ragged_gather` of the column's char
  matrix, packed back by :func:`pack_rows`); every flat-string gather of
  ``rowops.gather_column`` takes it;
* :func:`ragged_gather` gathers rows of an int16 char matrix, the Pallas
  ``ragged_gather``'s counterpart; the path no longer takes it;
* :func:`ragged_row_equal` compares two char matrices row by row (the
  Pallas ``ragged_row_equal``): the string branch of
  ``groupby._equal_adjacent`` (``group_ids``), which hands it two row
  views of one sorted char matrix.

Each wrapper launches its CUDA kernel for CUDA tensors and takes its
plain PyTorch version (:func:`gather_strings_plain`,
:func:`ragged_gather_plain`, :func:`ragged_row_equal_plain`) for CPU
tensors; a CUDA tensor the kernel cannot take raises. The Pallas
kernels' VMEM budget has no counterpart: the kernels read their inputs
from device memory.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ...strings_util import PAD, _matrix_from_offsets
from . import _build

def ragged_gather_plain(mat: torch.Tensor, idx: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: rows of ``mat`` at ``clamp(idx, 0, n - 1)``,
    PAD rows where ``valid`` is false; an empty source gives PAD rows."""
    n, w = mat.shape
    if n == 0:
        return torch.full((idx.shape[0], w), PAD, dtype=mat.dtype,
                          device=mat.device)
    rows = mat[idx.long().clamp(0, n - 1)]
    return torch.where(valid.bool()[:, None], rows,
                       torch.full((), PAD, dtype=mat.dtype, device=mat.device))


def pack_rows(mat: torch.Tensor, byte_cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(payload uint8 [byte_cap], offsets int32 [m + 1]) of an int16
    ``[m, W]`` char matrix whose rows end in PAD: the non-PAD chars in
    row-major order are the payload, zero past its end. The reference
    compacts them with one stable sort; here a cumsum gives each kept
    char its byte position and one scatter writes it, which gives the
    same offsets and bytes."""
    out_cap, w = mat.shape
    dev = mat.device
    keep = (mat != PAD).reshape(-1)
    lens = keep.reshape(out_cap, w).sum(1, dtype=torch.int32)
    offsets = torch.zeros(out_cap + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(lens, 0, dtype=torch.int32)
    pos = torch.cumsum(keep, 0) - 1
    payload = torch.zeros(byte_cap + 1, dtype=torch.uint8, device=dev)
    payload.scatter_(0, torch.where(keep, pos, byte_cap),
                     mat.reshape(-1).to(torch.uint8))
    return payload[:byte_cap], offsets


def gather_strings_plain(payload: torch.Tensor, offsets: torch.Tensor,
                         idx: torch.Tensor, valid: torch.Tensor, width: int,
                         byte_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the char-matrix route. The ``width``-wide
    char matrix of the layout, its rows gathered by
    :func:`ragged_gather_plain`, packed back by :func:`pack_rows`."""
    mat = _matrix_from_offsets(payload, offsets, width)
    return pack_rows(ragged_gather_plain(mat, idx, valid), byte_cap)


def ragged_row_equal_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``(a == b).all(1)``."""
    return (a == b).all(1)


def _lib() -> ctypes.CDLL:
    lib = _build.load("strings")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    if lib.srt_ragged_gather.argtypes is None:
        lib.srt_ragged_gather.argtypes = [p, i64, i64, p, p, i64, p, p]
        lib.srt_ragged_gather.restype = ctypes.c_int
    if lib.srt_gather_strings.argtypes is None:
        lib.srt_gather_strings.argtypes = [p, i64, p, i64, p, p, i64, i64,
                                           p, i64, p, p]
        lib.srt_gather_strings.restype = ctypes.c_int
        lib.srt_gather_strings_scratch_bytes.argtypes = [i64]
        lib.srt_gather_strings_scratch_bytes.restype = i64
    if lib.srt_row_equal.argtypes is None:
        lib.srt_row_equal.argtypes = [p, p, i64, i64, ctypes.c_int, p, p]
        lib.srt_row_equal.restype = ctypes.c_int
    return lib


def gather_strings(payload: torch.Tensor, offsets: torch.Tensor,
                   idx: torch.Tensor, valid: torch.Tensor, width: int,
                   byte_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather the rows of a flat string column, given by its uint8
    ``payload`` and int32 ``offsets`` ``[n + 1]``, at int32 ``idx``
    ``[m]`` (clamped into the column), as ``(payload uint8 [byte_cap],
    offsets int32 [m + 1])``. A row where ``valid`` (bool or int8 [m]) is
    false is empty; a valid row takes the first ``clamp(length, 0,
    width)`` bytes of its source, each read at ``clamp(start + j, 0,
    len(payload) - 1)``; the payload is zero past the last byte.
    ``byte_cap`` must hold ``m * width`` bytes. Bit for bit
    :func:`gather_strings_plain`, without building a char matrix."""
    tensors = (payload, offsets, idx, valid)
    if all(t.device.type == "cpu" for t in tensors):
        return gather_strings_plain(payload, offsets, idx, valid, width,
                                    byte_cap)
    dev = payload.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("strings gather runs on CUDA or CPU tensors, got "
                         + ", ".join(str(t.device) for t in tensors))
    _build.check_lane(payload, "payload", (torch.uint8,))
    _build.check_lane(offsets, "offsets", (torch.int32,))
    _build.check_lane(idx, "idx", (torch.int32,))
    m = idx.shape[0]
    _build.check_lane(valid, "valid", (torch.bool, torch.int8), m)
    n = offsets.shape[0] - 1
    if n < 0:
        raise ValueError("offsets needs at least one value")
    if width < 1:
        raise ValueError(f"width must be at least 1, got {width}")
    if byte_cap < m * width:
        raise ValueError(f"byte_cap {byte_cap} cannot hold {m} rows of "
                         f"{width} bytes")
    if n > 0 and payload.shape[0] == 0:
        raise ValueError(f"a column of {n} rows needs a payload byte")
    if m == 0:
        return (torch.zeros(byte_cap, dtype=torch.uint8, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev))
    lib = _lib()
    scratch_at = -(-byte_cap // 16) * 16
    buf = torch.empty(scratch_at + lib.srt_gather_strings_scratch_bytes(m),
                      dtype=torch.uint8, device=dev)
    out_offsets = torch.empty(m + 1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.srt_gather_strings(
            payload.data_ptr(), payload.shape[0], offsets.data_ptr(), n,
            idx.data_ptr(), valid.data_ptr(), m, width, buf.data_ptr(),
            byte_cap, out_offsets.data_ptr(), stream)
    _build.check(lib, rc, "strings gather launch")
    _GATHER_COUNTED.launches += 1
    return buf[:byte_cap], out_offsets


def ragged_gather(mat: torch.Tensor, idx: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Gather rows of an int16 ``[n, W]`` char matrix at ``idx``
    (int32[m]), PAD-blanking rows where ``valid`` (bool or int8 [m]) is
    false. Returns int16 ``[m, W]``."""
    if mat.device.type == "cpu" and idx.device.type == "cpu" \
            and valid.device.type == "cpu":
        return ragged_gather_plain(mat, idx, valid)
    dev = mat.device
    if dev.type != "cuda" or idx.device != dev or valid.device != dev:
        raise ValueError(f"strings gather runs on CUDA or CPU tensors: mat "
                         f"on {dev}, idx on {idx.device}, valid on "
                         f"{valid.device}")
    if mat.dtype != torch.int16 or mat.dim() != 2 \
            or not mat.is_contiguous():
        raise ValueError(f"mat must be a contiguous [n, W] int16 tensor, got "
                         f"{mat.dtype} {tuple(mat.shape)}")
    n, w = mat.shape
    m = idx.shape[0]
    if w % 8 != 0 or w == 0:
        raise ValueError(f"char-matrix width {w} is not a positive multiple "
                         "of 8")
    if idx.dtype != torch.int32 or idx.dim() != 1 \
            or not idx.is_contiguous():
        raise ValueError(f"idx must be a contiguous int32[m] tensor, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if valid.dtype not in (torch.bool, torch.int8) \
            or valid.shape != (m,) or not valid.is_contiguous():
        raise ValueError(f"valid must be a contiguous bool/int8[{m}] tensor, "
                         f"got {valid.dtype} {tuple(valid.shape)}")
    if n == 0 or m == 0:
        return torch.full((m, w), PAD, dtype=torch.int16, device=dev)
    out = torch.empty((m, w), dtype=torch.int16, device=dev)
    for t, what in ((mat, "mat"), (out, "out")):
        if t.data_ptr() % 16:
            raise ValueError(f"{what} is not 16-byte aligned")
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.srt_ragged_gather(mat.data_ptr(), n, w, idx.data_ptr(),
                                   valid.data_ptr(), m, out.data_ptr(),
                                   stream)
    _build.check(lib, rc, "strings gather launch")
    _COUNTED.launches += 1
    return out


def ragged_row_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bool[n]: row r of the int16 ``[n, W]`` char matrices ``a`` and ``b``
    is equal, bit for bit ``(a == b).all(1)``. ``a`` and ``b`` may be
    views of one buffer (``m[1:]`` and ``m[:-1]``); each needs contiguous
    rows. ``n == 0`` or ``W == 0`` gives the trivial answer without a
    launch."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ragged_row_equal_plain(a, b)
    dev = a.device
    if dev.type != "cuda" or b.device != dev:
        raise ValueError(f"strings compare runs on CUDA or CPU tensors: a on "
                         f"{dev}, b on {b.device}")
    for t, what in ((a, "a"), (b, "b")):
        if t.dtype != torch.int16 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{what} must be a contiguous [n, W] int16 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    n, w = a.shape
    if n == 0 or w == 0:
        return torch.ones(n, dtype=torch.bool, device=dev)
    # The widest load that the row pitch and both row pointers allow.
    vec = next(v for v in (16, 8, 4, 2) if (2 * w) % v == 0
               and a.data_ptr() % v == 0 and b.data_ptr() % v == 0)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.srt_row_equal(a.data_ptr(), b.data_ptr(), n, w, vec,
                               out.data_ptr(), stream)
    _build.check(lib, rc, "strings compare launch")
    _COUNTED_EQUAL.launches += 1
    return out


#: Kernel launches since the last reset, one count per entry (CPU calls
#: take the plain versions and do not count). ``_GATHER_COUNTED``,
#: ``_COUNTED`` and ``_COUNTED_EQUAL`` keep the owners of the counts when
#: a caller rebinds the module attributes (a capturing wrapper).
gather_strings.launches = 0
ragged_gather.launches = 0
ragged_row_equal.launches = 0
_GATHER_COUNTED = gather_strings
_COUNTED = ragged_gather
_COUNTED_EQUAL = ragged_row_equal
