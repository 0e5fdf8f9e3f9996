"""Ragged string gather over the char matrix (kernel family ``strings``).

Port of ``spark_rapids_tpu/ops/kernels/pallas/strings.py``
(``ragged_gather``). :func:`ragged_gather` launches the CUDA kernel
``csrc/strings.cu`` for CUDA tensors and takes :func:`ragged_gather_plain`,
the plain PyTorch version, for CPU tensors; a CUDA tensor the kernel
cannot take raises. The Pallas kernel's VMEM budget has no counterpart:
the kernel reads the source matrix from device memory.

The family's rowwise compare (``ragged_row_equal``) is reached only by
the mesh group-by and is not ported here.
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


def _lib() -> ctypes.CDLL:
    lib = _build.load("strings")
    fn = lib.srt_ragged_gather
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, i64, i64, p, p, i64, p, p]
        fn.restype = ctypes.c_int
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


#: Kernel launches since the last reset (CPU calls take the plain
#: version and do not count). ``_COUNTED`` keeps the owner of the count
#: when a caller rebinds the module attribute (a capturing wrapper).
ragged_gather.launches = 0
_COUNTED = ragged_gather
