"""The char-matrix kernels (kernel family ``strings``): the ragged gather
and the rowwise compare.

Port of ``spark_rapids_tpu/ops/kernels/pallas/strings.py``
(``ragged_gather`` and ``ragged_row_equal``). Each wrapper launches its
CUDA kernel in ``csrc/strings.cu`` for CUDA tensors and takes its plain
PyTorch version (:func:`ragged_gather_plain`,
:func:`ragged_row_equal_plain`) for CPU tensors; a CUDA tensor the
kernel cannot take raises. The Pallas kernels' VMEM budget has no
counterpart: the kernels read the matrices from device memory.

The gather serves the flat-string branch of ``rowops.gather_column``;
the compare serves the string branch of ``groupby._equal_adjacent``
(``group_ids``), which hands it two row views of one sorted char matrix.
"""

from __future__ import annotations

import ctypes

import torch

from ...strings_util import PAD
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


def ragged_row_equal_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``(a == b).all(1)``."""
    return (a == b).all(1)


def _lib() -> ctypes.CDLL:
    lib = _build.load("strings")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    if lib.srt_ragged_gather.argtypes is None:
        lib.srt_ragged_gather.argtypes = [p, i64, i64, p, p, i64, p, p]
        lib.srt_ragged_gather.restype = ctypes.c_int
    if lib.srt_row_equal.argtypes is None:
        lib.srt_row_equal.argtypes = [p, p, i64, i64, ctypes.c_int, p, p]
        lib.srt_row_equal.restype = ctypes.c_int
    return lib


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


#: Kernel launches since the last reset (CPU calls take the plain
#: versions and do not count). ``_COUNTED`` and ``_COUNTED_EQUAL`` keep
#: the owners of the counts when a caller rebinds the module attributes
#: (a capturing wrapper).
ragged_gather.launches = 0
ragged_row_equal.launches = 0
_COUNTED = ragged_gather
_COUNTED_EQUAL = ragged_row_equal
