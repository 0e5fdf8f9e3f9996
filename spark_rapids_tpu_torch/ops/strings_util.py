"""Device string primitives over the padded char matrix — port of
``spark_rapids_tpu/ops/strings_util.py``.

A string column's characters become a ``[capacity, W]`` int16 matrix:
row i holds string i's bytes, and positions past its end hold ``PAD``
(-1, which orders before every byte). ``W`` is the column's
``max_bytes``. A dictionary column builds the small ``[dict_size, W]``
matrix of its entries once and gathers rows by code, so its character
work is O(dictionary), not O(capacity).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..data.column import DeviceColumn

#: Character value past a string's end; orders before every byte.
PAD = -1


def _matrix_from_offsets(payload: torch.Tensor, offsets: torch.Tensor,
                         w: int) -> torch.Tensor:
    """``[len(offsets) - 1, w]`` int16 char matrix of an offsets + bytes
    layout (``_matrix_from_offsets`` of the reference)."""
    starts = offsets[:-1].long()
    ends = offsets[1:].long()
    pos = starts[:, None] + torch.arange(w, device=payload.device)[None, :]
    in_range = pos < ends[:, None]
    chars = payload[pos.clamp(0, payload.shape[0] - 1)].to(torch.int16)
    return torch.where(in_range, chars, PAD)


def char_matrix(col: DeviceColumn, width: Optional[int] = None
                ) -> torch.Tensor:
    """``[capacity, W]`` int16: row i holds string i's bytes, PAD past its
    end (``W`` = ``width`` or the column's ``max_bytes``)."""
    assert col.is_string
    w = width or max(col.max_bytes, 1)
    if col.is_dict:
        dm = _matrix_from_offsets(*col.dict_bytes, w)
        return dm[col.codes.long().clamp(0, dm.shape[0] - 1)]
    return _matrix_from_offsets(col.data, col.offsets, w)


def lengths(col: DeviceColumn) -> torch.Tensor:
    """Byte length per row, int32[capacity]."""
    if col.is_dict:
        offsets = col.dict_bytes[1]
        per = offsets[1:] - offsets[:-1]
        return per[col.codes.long().clamp(0, per.shape[0] - 1)]
    return col.offsets[1:] - col.offsets[:-1]


def lift_dict(col: DeviceColumn,
              fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
              width: Optional[int] = None) -> torch.Tensor:
    """Apply ``fn(char_matrix, byte_lengths) -> per-row values`` through
    the dictionary: a dictionary column evaluates ``fn`` once per entry
    and gathers by code; a flat column evaluates it per row."""
    w = width or max(col.max_bytes, 1)
    if col.is_dict:
        payload, offsets = col.dict_bytes
        dm = _matrix_from_offsets(payload, offsets, w)
        vals = fn(dm, offsets[1:] - offsets[:-1])
        return vals[col.codes.long().clamp(0, dm.shape[0] - 1)]
    return fn(char_matrix(col, w), lengths(col))
