"""Spark's murmur3 string row hash (kernel family ``hash``).

Port of ``spark_rapids_tpu/ops/kernels/pallas/hashing.py``
(``murmur3_bytes_rows``). :func:`murmur3_bytes_rows` launches the CUDA
kernel ``csrc/hashing.cu`` for CUDA tensors and takes
:func:`murmur3_bytes_rows_plain` (``shuffle/partitioning.py``'s, which
shares its mix steps with the fixed-width hashes) for CPU tensors; a CUDA
tensor the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes

import torch

from ....shuffle.partitioning import \
    murmur3_bytes_rows as murmur3_bytes_rows_plain  # noqa: F401
from . import _build


def _lib() -> ctypes.CDLL:
    lib = _build.load("hashing")
    fn = lib.srt_murmur3_rows
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, i64, i64, p, p, p, p]
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
    for t, what in ((lengths, "lengths"), (seed, "seed")):
        if t.dtype != torch.int32 or t.shape != (n,) \
                or not t.is_contiguous():
            raise ValueError(f"{what} must be a contiguous int32[{n}] tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
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


#: Kernel launches since the last reset (CPU calls take the plain
#: version and do not count). ``_COUNTED`` keeps the owner of the count
#: when a caller rebinds the module attribute (a capturing wrapper).
murmur3_bytes_rows.launches = 0
_COUNTED = murmur3_bytes_rows
