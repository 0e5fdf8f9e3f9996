"""Direct-address join table build + probe (kernel family ``joinProbe``).

Port of ``spark_rapids_tpu/ops/kernels/pallas/join_probe.py``
(``dense_build_probe``). :func:`dense_build_probe` launches the CUDA
kernel ``csrc/join_probe.cu`` for CUDA tensors and takes
:func:`dense_build_probe_plain`, the plain PyTorch version, for CPU
tensors. There is no fallback from one to the other: a CUDA tensor the
kernel cannot take raises. The Pallas kernel's VMEM budget has no
counterpart; the table lives in device memory.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

INT32_MAX = 2 ** 31 - 1


def dense_build_probe_plain(bslot: torch.Tensor, pslot: torch.Tensor,
                            tbl: int) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """Plain PyTorch version: the count and first-row table over
    ``bslot`` (``scatter_add_`` / ``scatter_reduce_(amin)`` into tbl + 1
    slots, the last one absorbing unusable rows), gathered at ``pslot``
    clamped into [0, tbl). Returns int32 ``(cnt_at_probe, row_at_probe,
    max_slot_count)``."""
    dev = bslot.device
    cap_b = bslot.shape[0]
    slot = bslot.long()
    slot = torch.where((slot < 0) | (slot > tbl), tbl, slot)
    cnt = torch.zeros(tbl + 1, dtype=torch.int32, device=dev).scatter_add_(
        0, slot, torch.ones(cap_b, dtype=torch.int32, device=dev))
    row = torch.full((tbl + 1,), INT32_MAX, dtype=torch.int32,
                     device=dev).scatter_reduce_(
        0, slot, torch.arange(cap_b, dtype=torch.int32, device=dev), "amin")
    ps = pslot.long().clamp(0, tbl - 1)
    return cnt[ps], row[ps], cnt[:tbl].max()


def _lib() -> ctypes.CDLL:
    lib = _build.load("join_probe")
    fn = lib.srt_dense_build_probe
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, i64, p, i64, ctypes.c_int32, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def _check_lane(t: torch.Tensor, what: str, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 1-D int32 tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")


def dense_build_probe(bslot: torch.Tensor, pslot: torch.Tensor, tbl: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Build the direct-address table over ``bslot`` (int32[cap_b], each
    build row's slot, pre-set to ``tbl`` for dead, null or out-of-range
    rows) and probe it at ``pslot`` (int32[cap_p]). Returns int32
    ``(cnt_at_probe[cap_p], row_at_probe[cap_p], max_slot_count)``;
    ``max_slot_count > 1`` is the duplicate-build-key flag."""
    if tbl < 1:
        raise ValueError(f"table size must be positive, got {tbl}")
    if bslot.device.type == "cpu" and pslot.device.type == "cpu":
        return dense_build_probe_plain(bslot, pslot, tbl)
    dev = bslot.device
    if dev.type != "cuda":
        raise ValueError(f"joinProbe runs on CUDA or CPU tensors, not {dev}")
    _check_lane(bslot, "bslot", dev)
    _check_lane(pslot, "pslot", dev)
    lib = _lib()
    cap_b, cap_p = bslot.shape[0], pslot.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    cnt_tbl = torch.empty(tbl, **i32)
    row_tbl = torch.empty(tbl, **i32)
    cnt_out = torch.empty(cap_p, **i32)
    row_out = torch.empty(cap_p, **i32)
    max_out = torch.empty((), **i32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.srt_dense_build_probe(
            bslot.data_ptr(), cap_b, pslot.data_ptr(), cap_p, tbl,
            cnt_tbl.data_ptr(), row_tbl.data_ptr(), cnt_out.data_ptr(),
            row_out.data_ptr(), max_out.data_ptr(), stream)
    _build.check(lib, rc, "joinProbe launch")
    _COUNTED.launches += 1
    return cnt_out, row_out, max_out


#: Kernel launches since the last reset (CPU calls take the plain
#: version and do not count). ``_COUNTED`` keeps the owner of the count
#: when a caller rebinds the module attribute (a capturing wrapper).
dense_build_probe.launches = 0
_COUNTED = dense_build_probe
