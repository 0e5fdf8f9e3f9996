"""Device string primitives over the padded char matrix — port of
``spark_rapids_tpu/ops/strings_util.py``.

A string column's characters become a ``[capacity, W]`` int16 matrix:
row i holds string i's bytes, and positions past its end hold ``PAD``
(-1, which orders before every byte). ``W`` is the column's
``max_bytes``. A dictionary column builds the small ``[dict_size, W]``
matrix of its entries once and gathers rows by code, so its character
work is O(dictionary), not O(capacity).

The rest of the module works from a column's own layout instead, with
no ``[capacity, W]`` matrix: :func:`row_layout`, :func:`byte_stream` and
:func:`flat_column` (the string functions of ``strings.py`` and
``strings2.py``, ``CaseWhen``'s flat branches, string aggregates);
:func:`rows_matrix` is a char matrix only as wide as the longest row it
holds, for the casts that parse text.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import types as T
from ..data.column import (DeviceColumn, bucket_byte_capacity,
                           dictionary_column, string_max_bytes)

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


# --------------------------------------------------------------------------
# Work over a column's own layout (no [capacity, W] char matrix): each row
# is (payload, start, length); the bytes of all rows line up one after
# another as a byte stream whose row and in-row position come from the
# lengths (repeat_interleave, cumsum), and a flat result column is built
# from its rows' lengths and a function of (row, position).
# --------------------------------------------------------------------------


def row_layout(col: DeviceColumn
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(payload, starts, lens)``: row i's bytes are ``payload[starts[i]:
    starts[i] + lens[i]]`` (int64 lanes). A dictionary row reads its
    entry in ``dict_bytes``; a null row has length 0."""
    if col.is_dict:
        payload, offsets = col.dict_bytes
        n_entries = offsets.shape[0] - 1
        code = col.codes.long().clamp(0, max(n_entries - 1, 0))
        starts = offsets[:-1].long()[code]
        lens = (offsets[1:] - offsets[:-1]).long()[code]
    else:
        payload = col.data
        starts = col.offsets[:-1].long()
        lens = (col.offsets[1:] - col.offsets[:-1]).long()
    return payload, starts, torch.where(col.validity, lens, 0)


def byte_stream(lens: torch.Tensor, total: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(row, j)`` of every byte of rows ``lens`` bytes long, row after
    row: the row it belongs to and its position in that row. ``total``
    is ``lens.sum()``, read on the host when not given."""
    dev = lens.device
    if total is None:
        total = int(lens.sum()) if lens.numel() else 0
    row = torch.repeat_interleave(torch.arange(lens.shape[0], device=dev),
                                  lens, output_size=total)
    first = torch.cumsum(lens, 0) - lens
    return row, torch.arange(total, device=dev) - first[row]


def read_bytes(payload: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``payload[pos]`` as int16, positions clamped into the payload."""
    return payload[pos.clamp(0, max(payload.shape[0] - 1, 0))].to(
        torch.int16)


def flat_column(out_len: torch.Tensor, validity: torch.Tensor,
                byte_fn: Callable[[torch.Tensor, torch.Tensor],
                                  torch.Tensor]) -> DeviceColumn:
    """A flat string column whose row i (length 0 under a null) is
    ``out_len[i]`` bytes long, byte j being ``byte_fn(i, j)`` (called once
    over every byte's row and position). The total and the longest row
    are read on the host (one sync): they size the payload and set
    ``max_bytes``."""
    dev = validity.device
    n = validity.shape[0]
    out_len = torch.where(validity, out_len.long(), 0)
    offsets = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(out_len, 0)
    total, longest = (torch.stack([out_len.sum(), out_len.max()]).tolist()
                      if n else (0, 0))
    payload = torch.zeros(bucket_byte_capacity(max(total, 1)),
                          dtype=torch.uint8, device=dev)
    if total:
        row, j = byte_stream(out_len, total)
        payload[:total] = byte_fn(row, j).to(torch.uint8)
    return DeviceColumn(payload, validity, T.STRING, offsets=offsets,
                        max_bytes=string_max_bytes(longest))


def entries_column(col: DeviceColumn) -> DeviceColumn:
    """A dictionary column's entries as a flat column, one valid row an
    entry (its device ``dict_bytes``)."""
    payload, offsets = col.dict_bytes
    n = offsets.shape[0] - 1
    return DeviceColumn(payload, torch.ones(n, dtype=torch.bool,
                                            device=payload.device),
                        T.STRING, offsets=offsets, max_bytes=col.max_bytes)


def flat_values(col: DeviceColumn) -> np.ndarray:
    """Every row of a flat column as a Python string (bytes that are not
    UTF-8 kept through ``surrogateescape``, as dictionaries keep them)."""
    offsets = col.offsets.cpu().numpy()
    raw = col.data[:int(offsets[-1])].cpu().numpy().tobytes()
    return np.array([raw[a:b].decode("utf-8", "surrogateescape")
                     for a, b in zip(offsets[:-1], offsets[1:])],
                    dtype=object)


def map_string_column(col: DeviceColumn,
                      fn: Callable[[DeviceColumn], DeviceColumn]
                      ) -> DeviceColumn:
    """A string -> string transform ``fn`` over a flat column (the
    reference's ``map_string_column``). A dictionary column transforms
    its entries once on the device and keeps its codes; the new entries
    come to the host as the column's dictionary (which may now repeat or
    be out of order: ``dict_sorted`` is checked)."""
    if not col.is_dict:
        return fn(col)
    out = fn(entries_column(col))
    return dictionary_column(col.codes, col.validity, flat_values(out))


def rows_matrix(col: DeviceColumn) -> Tuple[torch.Tensor,
                                            Optional[torch.Tensor]]:
    """``(m, codes)``: an int16 char matrix only as wide as the longest
    row it holds (one host read), PAD past each end, over a flat
    column's rows (``codes`` None; null rows empty) or a dictionary's
    entries (``codes`` the rows' codes, to gather by)."""
    if col.is_dict:
        ent = entries_column(col)
        payload, starts = ent.data, ent.offsets[:-1].long()
        lens = (ent.offsets[1:] - ent.offsets[:-1]).long()
        codes = col.codes.long().clamp(0, max(lens.shape[0] - 1, 0))
    else:
        payload, starts, lens = row_layout(col)
        codes = None
    w = max(int(lens.max()) if lens.numel() else 0, 1)
    idx = torch.arange(w, device=lens.device)[None, :]
    chars = read_bytes(payload, starts[:, None] + idx)
    return torch.where(idx < lens[:, None], chars, PAD), codes


def lift_rows(col: DeviceColumn, fn: Callable[[torch.Tensor], tuple]
              ) -> tuple:
    """``fn(m)`` of :func:`rows_matrix`'s matrix, each lane it returns
    gathered by code for a dictionary column."""
    m, codes = rows_matrix(col)
    out = fn(m)
    if codes is None:
        return out
    return tuple(o[codes] for o in out)


def rows_equal(l: DeviceColumn, r: DeviceColumn) -> torch.Tensor:
    """Per row, whether two string columns of any layouts hold the same
    bytes (equal lengths, then every byte; null rows count as empty)."""
    pl, sl, ll = row_layout(l)
    pr, sr, lr = row_layout(r)
    same = ll == lr
    row, j = byte_stream(torch.where(same, ll, 0))
    diff = read_bytes(pl, sl[row] + j) != read_bytes(pr, sr[row] + j)
    bad = torch.zeros(ll.shape[0], dtype=torch.int64, device=ll.device)
    bad.index_add_(0, row, diff.to(torch.int64))
    return same & (bad == 0)


def string_ranks(col: DeviceColumn) -> torch.Tensor:
    """int64 dense rank of each row's string in byte order (null rows
    rank as the empty string): rows compare 7 bytes a pass, each pass a
    stable sort of (rank so far, next 7 bytes packed 9 bits a byte, 0
    past the end) that splits the ties of the last. One host read of the
    longest row sets the number of passes."""
    payload, starts, lens = row_layout(col)
    n = lens.shape[0]
    dev = lens.device
    rank = torch.zeros(n, dtype=torch.int64, device=dev)
    longest = int(lens.max()) if n else 0
    for k in range(0, longest, 7):
        chunk = torch.zeros(n, dtype=torch.int64, device=dev)
        for t in range(k, k + 7):
            b = read_bytes(payload, starts + t).long() + 1
            chunk = chunk * 512 + torch.where(t < lens, b, 0)
        perm = torch.sort(chunk, stable=True).indices
        perm = perm[torch.sort(rank[perm], stable=True).indices]
        sr, sc = rank[perm], chunk[perm]
        new = torch.ones(n, dtype=torch.int64, device=dev)
        new[1:] = ((sr[1:] != sr[:-1]) | (sc[1:] != sc[:-1])).long()
        rank = torch.empty_like(rank)
        rank[perm] = torch.cumsum(new, 0) - 1
    return rank


def select_rows(cols, choice: torch.Tensor, validity: torch.Tensor
                ) -> DeviceColumn:
    """A flat column whose row i is row i of ``cols[choice[i]]`` (any
    layouts), empty under a null of ``validity``."""
    layouts = [row_layout(c) for c in cols]
    out_len = torch.zeros_like(choice, dtype=torch.int64)
    for k, (_, _, ln) in enumerate(layouts):
        out_len = torch.where(choice == k, ln, out_len)

    def byte_fn(row, j):
        pick = choice[row]
        out = torch.zeros(row.shape[0], dtype=torch.int16, device=row.device)
        for k, (p, s, _) in enumerate(layouts):
            out = torch.where(pick == k, read_bytes(p, s[row] + j), out)
        return out
    return flat_column(out_len, validity, byte_fn)
