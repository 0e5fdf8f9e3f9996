"""Argsort of a packed int64 key lane (kernel family ``sortStep``).

Port of ``spark_rapids_tpu/ops/kernels/pallas/sort_steps.py``
(``packed_argsort``). :func:`packed_argsort` launches the CUDA bitonic
sort ``csrc/sort_steps.cu`` for CUDA tensors and takes
:func:`packed_argsort_plain`, the plain PyTorch version, for CPU
tensors; a CUDA tensor the kernel cannot take raises. The Pallas
kernel's VMEM budget (its fallback for large lanes) has no counterpart:
every lane up to ``2**INDEX_BITS`` rows sorts on the card.

The lane is :func:`..rowops.packed_sort_lane`'s: bit 63 clear, the row
index in the low :data:`INDEX_BITS` bits, so every lane is unique and any
correct sort gives the one permutation the reference's stable sort gives.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: Bits of the packed lane that hold the row index (the reference's).
INDEX_BITS = 27
_INDEX_MASK = (1 << INDEX_BITS) - 1


def packed_argsort_plain(lane: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.sort(lane).values`` masked to the
    row-index bits, int32."""
    return (torch.sort(lane).values & _INDEX_MASK).to(torch.int32)


def _lib() -> ctypes.CDLL:
    lib = _build.load("sort_steps")
    fn = lib.srt_packed_argsort
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, i64, p, i64, p, p]
        fn.restype = ctypes.c_int
    return lib


def packed_argsort(lane: torch.Tensor) -> torch.Tensor:
    """Sorting permutation (int32[n]) of a unique packed int64 lane[n]:
    ``lane[perm]`` is ascending."""
    if lane.device.type == "cpu":
        return packed_argsort_plain(lane)
    dev = lane.device
    if dev.type != "cuda":
        raise ValueError(f"sortStep runs on CUDA or CPU tensors, not {dev}")
    if lane.dtype != torch.int64 or lane.dim() != 1 \
            or not lane.is_contiguous():
        raise ValueError(f"lane must be a contiguous 1-D int64 tensor, got "
                         f"{lane.dtype} {tuple(lane.shape)}")
    n = lane.shape[0]
    if n > 1 << INDEX_BITS:
        raise ValueError(f"sortStep takes at most 2**{INDEX_BITS} lanes, "
                         f"got {n}")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    n2 = 1 << (n - 1).bit_length()
    scratch = torch.empty(n2, dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.srt_packed_argsort(lane.data_ptr(), n, scratch.data_ptr(),
                                    n2, out.data_ptr(), stream)
    _build.check(lib, rc, "sortStep launch")
    _COUNTED.launches += 1
    return out


#: Kernel launches since the last reset (CPU calls take the plain
#: version and do not count). ``_COUNTED`` keeps the owner of the count
#: when a caller rebinds the module attribute (a capturing wrapper).
packed_argsort.launches = 0
_COUNTED = packed_argsort
