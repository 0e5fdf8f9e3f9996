"""Argsort of a packed int64 key lane (kernel family ``sortStep``).

Port of ``spark_rapids_tpu/ops/kernels/pallas/sort_steps.py``
(``packed_argsort``). :func:`packed_argsort` launches the CUDA radix
sort ``csrc/sort_steps.cu`` for CUDA tensors and takes
:func:`packed_argsort_plain`, the plain PyTorch version, for CPU
tensors; a CUDA tensor the kernel cannot take raises. The Pallas
kernel's VMEM budget (its fallback for large lanes) has no counterpart:
every lane up to ``2**INDEX_BITS`` rows sorts on the card.

The lane is :func:`..rowops.packed_sort_lane`'s: bit 63 clear, the row
index in the low :data:`INDEX_BITS` bits, so every lane is unique and any
correct sort gives the one permutation the reference's stable sort gives.
Up to :data:`SMALL_LANES` lanes sort in one block in shared memory;
larger lanes take stable radix passes over the 8-bit digit windows that
vary, skipping the index windows when the index bits are the row
positions, as ``packed_sort_lane`` makes them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: Bits of the packed lane that hold the row index (the reference's).
INDEX_BITS = 27
_INDEX_MASK = (1 << INDEX_BITS) - 1
#: Lanes sorted by one block in shared memory, in one launch
#: (``kSmall`` in ``csrc/sort_steps.cu``).
SMALL_LANES = 4096


def packed_argsort_plain(lane: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.sort(lane).values`` masked to the
    row-index bits, int32."""
    return (torch.sort(lane).values & _INDEX_MASK).to(torch.int32)


def _lib() -> ctypes.CDLL:
    lib = _build.load("sort_steps")
    fn = lib.srt_packed_argsort
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        for aux in (lib.srt_packed_argsort_scratch_bytes,
                    lib.srt_packed_argsort_live_offset):
            aux.argtypes = [i64]
            aux.restype = i64
        fn.argtypes = [p, i64, p, i64, p, p]
        fn.restype = ctypes.c_int
    return lib


def _launch(lane: torch.Tensor):
    """Launch the kernel on a CUDA lane: (perm, scratch, lib)."""
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
        return out, None, None
    lib = _lib()
    nbytes = lib.srt_packed_argsort_scratch_bytes(n)
    scratch = torch.empty((nbytes + 7) // 8, dtype=torch.int64, device=dev) \
        if nbytes else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.srt_packed_argsort(
            lane.data_ptr(), n, None if scratch is None else
            scratch.data_ptr(), nbytes, out.data_ptr(), stream)
    _build.check(lib, rc, "sortStep launch")
    _COUNTED.launches += 1
    return out, scratch, lib


def packed_argsort(lane: torch.Tensor) -> torch.Tensor:
    """Sorting permutation (int32[n]) of a unique packed int64 lane[n]:
    ``lane[perm]`` is ascending."""
    if lane.device.type == "cpu":
        return packed_argsort_plain(lane)
    return _launch(lane)[0]


def packed_argsort_passes(lane: torch.Tensor):
    """:func:`packed_argsort` of a CUDA lane and the number of radix
    scatter passes its plan ran (0 for a lane of at most
    :data:`SMALL_LANES`, sorted in one block). Reads the plan back, so it
    synchronizes: for measurement, not for the query path."""
    perm, scratch, lib = _launch(lane)
    if scratch is None:
        return perm, 0
    off = lib.srt_packed_argsort_live_offset(lane.shape[0])
    return perm, int(scratch.view(torch.int32)[off // 4].item())


#: Kernel launches since the last reset (CPU calls take the plain
#: version and do not count). ``_COUNTED`` keeps the owner of the count
#: when a caller rebinds the module attribute (a capturing wrapper).
packed_argsort.launches = 0
_COUNTED = packed_argsort
