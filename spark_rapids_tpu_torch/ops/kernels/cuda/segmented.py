"""Sorted-order segmented reduction (kernel family ``segmented``).

Port of ``spark_rapids_tpu/ops/kernels/pallas/segmented.py``
(``segment_reduce_sorted``). :func:`segment_reduce_sorted` launches the
CUDA kernel ``csrc/segmented.cu`` for CUDA tensors and takes
:func:`segment_reduce_sorted_plain`, the plain PyTorch version, for CPU
tensors; a CUDA tensor the kernel cannot take raises. The kernel works
by tiles of consecutive rows (a reduce-by-key over each tile, then one
fix-up launch for the groups that cross tiles and the identity rows), so
a call makes one launch when ``n`` fits one tile (:data:`TILE_ROWS`) and
two otherwise; its scratch is a few words per tile, nothing of
``capacity``.

Eligibility is the reference's: sum, min or max of an integer or float
lane, except float sums (the order of the additions decides their last
bits) and bool lanes. The group-by routes those to its plain segment
sum, outside any kernel, as the reference leaves them to XLA.

Float min/max are defined on a total order (-0.0 < +0.0) with NaN
propagating, so kernel and plain version agree bit for bit whatever
order either visits the rows in. The group-by strips NaN and
canonicalizes -0.0 before it reduces (the reference's Spark float
semantics), so on its path the choice never shows.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, count_launch, launch_events

OPS = ("sum", "min", "max")
_OP_CODES = {"sum": 0, "min": 1, "max": 2}
_DTYPE_CODES = {torch.int8: 0, torch.int16: 1, torch.int32: 2,
                torch.int64: 3, torch.float32: 4, torch.float64: 5}
_KEY_MASK = {torch.float64: 0x7FFFFFFFFFFFFFFF, torch.float32: 0x7FFFFFFF}
_BITS = {torch.float64: torch.int64, torch.float32: torch.int32}
_CANON_NAN = {torch.float64: 0x7FF8000000000000, torch.float32: 0x7FC00000}
#: Rows a block reduces (``kTileRows`` in ``csrc/segmented.cu``).
TILE_ROWS = 1024


def eligible(x: torch.Tensor, op: str) -> bool:
    """Whether a lane reaches the kernel (see the module doc)."""
    return op in OPS and x.dtype in _DTYPE_CODES \
        and not (op == "sum" and x.is_floating_point())


def _float_key(x: torch.Tensor) -> torch.Tensor:
    """int64 total-order key of a float lane (its own inverse map)."""
    b = x.contiguous().view(_BITS[x.dtype])
    return torch.where(b < 0, b ^ _KEY_MASK[x.dtype], b).to(torch.int64)


def _from_key(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    k = k.to(_BITS[dtype])
    return torch.where(k < 0, k ^ _KEY_MASK[dtype], k).view(dtype)


def segment_reduce_sorted_plain(x: torch.Tensor, gid: torch.Tensor,
                                capacity: int, op: str) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` for sums and
    ``scatter_reduce_`` for min/max (on the total-order key for floats)
    into ``capacity`` + 1 rows, the last absorbing out-of-range ids."""
    if not eligible(x, op):
        raise ValueError(f"segmented: {op} over {x.dtype} is not eligible")
    squeeze = x.dim() == 1
    x2 = x.reshape(x.shape[0], 1 if squeeze else x.shape[1]).contiguous()
    n, lanes = x2.shape
    g = gid.long()
    idx = torch.where((g >= 0) & (g < capacity), g, capacity)
    idx2 = idx[:, None].expand(n, lanes)
    shape, dev = (capacity + 1, lanes), x.device
    if op == "sum":
        out = torch.zeros(shape, dtype=x.dtype, device=dev).index_add_(
            0, idx, x2)
    elif x.is_floating_point():
        inf = torch.tensor(float("inf"), dtype=x.dtype)  # host: no sync
        ident = _float_key(inf if op == "min" else -inf).item()
        nan = torch.isnan(x2)
        keys = torch.where(nan, ident, _float_key(x2))
        red = torch.full(shape, ident, dtype=torch.int64,
                         device=dev).scatter_reduce_(
            0, idx2, keys, "amin" if op == "min" else "amax")
        nan_cnt = torch.zeros(shape, dtype=torch.int64, device=dev
                              ).index_add_(0, idx, nan.to(torch.int64))
        canon = torch.tensor(_CANON_NAN[x.dtype], dtype=_BITS[x.dtype],
                             device=dev).view(x.dtype)
        out = torch.where(nan_cnt > 0, canon, _from_key(red, x.dtype))
    else:
        info = torch.iinfo(x.dtype)
        ident = info.max if op == "min" else info.min
        out = torch.full(shape, ident, dtype=x.dtype,
                         device=dev).scatter_reduce_(
            0, idx2, x2, "amin" if op == "min" else "amax")
    out = out[:capacity]
    return out[:, 0] if squeeze else out


def _lib() -> ctypes.CDLL:
    lib = _build.load("segmented")
    fn = lib.srt_segment_reduce_sorted
    if fn.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.srt_segment_scratch_bytes.argtypes = [i64, i64]
        lib.srt_segment_scratch_bytes.restype = i64
        fn.argtypes = [p, i32, i32, i64, i64, p, i64, p, i64, p, p]
        fn.restype = ctypes.c_int
    return lib


def segment_reduce_sorted(x: torch.Tensor, gid: torch.Tensor, capacity: int,
                          op: str) -> torch.Tensor:
    """``op`` of ``x`` ([n] or [n, L]) over the nondecreasing, prefix-dense
    group ids ``gid`` (int32[n]), into dense ``[capacity(, L)]`` rows;
    empty groups hold the reduction's identity."""
    if not eligible(x, op):
        raise ValueError(f"segmented: {op} over {x.dtype} is not eligible")
    if x.device.type == "cpu" and gid.device.type == "cpu":
        return segment_reduce_sorted_plain(x, gid, capacity, op)
    dev = x.device
    if dev.type != "cuda" or gid.device != dev:
        raise ValueError(f"segmented runs on CUDA or CPU tensors: x on "
                         f"{dev}, gid on {gid.device}")
    n = x.shape[0]
    if x.dim() not in (1, 2) or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [n] or [n, L] tensor, got "
                         f"{tuple(x.shape)}")
    if gid.dtype != torch.int32 or gid.shape != (n,) \
            or not gid.is_contiguous():
        raise ValueError(f"gid must be a contiguous int32[{n}] tensor, got "
                         f"{gid.dtype} {tuple(gid.shape)}")
    lanes = 1 if x.dim() == 1 else x.shape[1]
    out = torch.empty((capacity, lanes), dtype=x.dtype, device=dev)
    if capacity == 0 or lanes == 0:
        return out[:, 0] if x.dim() == 1 else out
    lib = _lib()
    nbytes = lib.srt_segment_scratch_bytes(n, lanes)
    scratch = torch.empty((nbytes + 7) // 8, dtype=torch.int64, device=dev) \
        if nbytes else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with launch_events("segmented"):
            rc = lib.srt_segment_reduce_sorted(
                x.data_ptr(), _DTYPE_CODES[x.dtype], _OP_CODES[op], n, lanes,
                gid.data_ptr(), capacity,
                None if scratch is None else scratch.data_ptr(), nbytes,
                out.data_ptr(), stream)
    _build.check(lib, rc, "segmented launch")
    count_launch(_COUNTED)
    return out[:, 0] if x.dim() == 1 else out


#: Kernel launches since the last reset (CPU calls take the plain
#: version and do not count). ``_COUNTED`` keeps the owner of the count
#: when a caller rebinds the module attribute (a capturing wrapper).
segment_reduce_sorted.launches = 0
_COUNTED = segment_reduce_sorted
