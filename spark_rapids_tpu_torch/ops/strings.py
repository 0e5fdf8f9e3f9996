"""String expressions — port of ``spark_rapids_tpu/ops/strings.py``, cut
to ``Substring`` with literal position and length, the form TPC-H Q22's
country code takes, and ``StartsWith``, ``EndsWith`` and ``Contains``
with a literal needle (the reference's ``_FixMatch``: Q2, Q9, Q13, Q14,
Q16, Q19, Q20). Byte semantics, as the reference's device path.
"""

from __future__ import annotations

import torch

from .. import types as T
from ..data.batch import ColumnarBatch
from ..data.column import DeviceColumn, string_max_bytes
from .expression import Expression, Literal, make_column
from .kernels.rowops import strings_from_matrix
from .strings_util import PAD, char_matrix, lengths, lift_dict


class Substring(Expression):
    """substring(str, pos, len): Spark's 1-based position, 0 acts as 1, a
    negative position counts from the end; the result is a flat string
    column whatever the input's layout."""

    def __init__(self, child: Expression, pos: Expression,
                 length: Expression):
        if not (isinstance(pos, Literal) and isinstance(length, Literal)):
            raise NotImplementedError("substring takes literal pos and len")
        self.children = [child, pos, length]

    @property
    def data_type(self) -> T.DataType:
        return T.STRING

    def with_children(self, children):
        return Substring(*children)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        c = self.children[0].eval_device(batch)
        pos = self.children[1].value
        ln = max(self.children[2].value, 0)
        m = char_matrix(c)
        n, w = m.shape
        slen = lengths(c)
        if pos > 0:
            start = torch.full((n,), pos - 1, dtype=torch.int32,
                               device=m.device)
        elif pos == 0:
            start = torch.zeros(n, dtype=torch.int32, device=m.device)
        else:
            start = torch.clamp(slen + pos, min=0)
        out_w = max(min(ln, w) if ln else 1, 1)
        cols_idx = start[:, None] + torch.arange(
            out_w, dtype=torch.int32, device=m.device)[None, :]
        in_range = cols_idx < torch.minimum(start + ln, slen)[:, None]
        gathered = torch.gather(m, 1, cols_idx.clamp(0, w - 1).long())
        out_m = torch.where(in_range, gathered, PAD)
        return strings_from_matrix(out_m, c.validity,
                                   string_max_bytes(out_w))


class _FixMatch(Expression):
    """A match of a literal needle (the reference's ``_FixMatch``
    semantics): an empty needle matches every row; a needle longer than
    the column's ``max_bytes`` matches none; a null string gives null.

    A dictionary column tests each entry once (:func:`lift_dict`) and
    gathers the answers by code. A flat column is read from its offsets
    and payload (:meth:`match_flat`): no char matrix."""

    def __init__(self, child: Expression, needle: str):
        self.children = [child]
        self.needle = needle

    @property
    def data_type(self) -> T.DataType:
        return T.BOOLEAN

    def with_children(self, children):
        return type(self)(children[0], self.needle)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        c = self.children[0].eval_device(batch)
        raw = self.needle.encode()
        k = len(raw)
        dev = c.device
        if k == 0 or k > max(c.max_bytes, 1):
            data = torch.full((c.capacity,), k == 0, dtype=torch.bool,
                              device=dev)
        elif c.is_dict:
            needle = torch.tensor(list(raw), dtype=torch.int16, device=dev)
            data = lift_dict(c, lambda m, ln: self.match_matrix(m, ln,
                                                                needle))
        else:
            needle = torch.tensor(list(raw), dtype=torch.uint8, device=dev)
            data = self.match_flat(c.data, c.offsets[:-1].long(),
                                   c.offsets[1:].long(), needle)
        return make_column(data, c.validity, T.BOOLEAN)

    def match_matrix(self, m: torch.Tensor, lengths: torch.Tensor,
                     needle: torch.Tensor) -> torch.Tensor:
        """Per row of a ``[n, W]`` char matrix (``PAD`` past each end,
        ``W`` at least the needle's length)."""
        raise NotImplementedError

    def match_flat(self, payload: torch.Tensor, starts: torch.Tensor,
                   ends: torch.Tensor, needle: torch.Tensor) -> torch.Tensor:
        """Per row ``payload[starts:ends]`` of a flat layout."""
        raise NotImplementedError


def _window_equal(payload: torch.Tensor, pos: torch.Tensor,
                  needle: torch.Tensor) -> torch.Tensor:
    """Whether ``payload[pos:pos + k]`` is the needle, per position (reads
    past the payload's end compare unequal)."""
    k = needle.shape[0]
    idx = pos[:, None] + torch.arange(k, device=pos.device)[None, :]
    size = payload.shape[0]
    chars = payload[idx.clamp(0, max(size - 1, 0))]
    return ((chars == needle[None, :]) & (idx < size)).all(1)


class StartsWith(_FixMatch):
    """``startswith(str, needle)``: true where the string's first bytes
    are the needle's. A flat column reads the needle's ``k`` bytes at
    each row's offset, with the row's length at least ``k``."""

    def match_matrix(self, m, lengths, needle):
        return (m[:, :needle.shape[0]] == needle[None, :]).all(1)

    def match_flat(self, payload, starts, ends, needle):
        return (ends - starts >= needle.shape[0]) \
            & _window_equal(payload, starts, needle)


class EndsWith(_FixMatch):
    """``endswith(str, needle)``: true where the string's last bytes are
    the needle's. A flat column reads the needle's ``k`` bytes at each
    row's end minus ``k``."""

    def match_matrix(self, m, lengths, needle):
        k = needle.shape[0]
        start = lengths.long() - k
        idx = start[:, None] + torch.arange(k, device=m.device)[None, :]
        chars = torch.gather(m, 1, idx.clamp(0, m.shape[1] - 1))
        return (start >= 0) & (chars == needle[None, :]).all(1)

    def match_flat(self, payload, starts, ends, needle):
        k = needle.shape[0]
        return (ends - starts >= k) & _window_equal(payload, ends - k,
                                                    needle)


class Contains(_FixMatch):
    """``contains(str, needle)``: true where the needle occurs in the
    string. A flat column marks, in one pass of ``k`` shifted compares
    over the payload, each byte where the needle starts; a row matches
    when a mark lies in ``[start, end - k]`` (a match that runs into the
    next row's bytes does not count), which a prefix sum of the marks
    read at the offsets gives."""

    def match_matrix(self, m, lengths, needle):
        k = needle.shape[0]
        windows = m.unfold(1, k, 1)  # [n, W - k + 1, k]
        return (windows == needle[None, None, :]).all(2).any(1)

    def match_flat(self, payload, starts, ends, needle):
        k = needle.shape[0]
        size = payload.shape[0]
        dev = payload.device
        n_pos = max(size - k + 1, 0)
        marks = torch.ones(n_pos, dtype=torch.bool, device=dev)
        for j in range(k):
            marks &= payload[j:j + n_pos] == needle[j]
        # before[i]: marks at byte positions below i, for i in [0, size]
        before = torch.zeros(size + 1, dtype=torch.int64, device=dev)
        before[1:marks.shape[0] + 1] = torch.cumsum(marks, 0)
        before[marks.shape[0] + 1:] = before[marks.shape[0]]
        lo = starts.clamp(0, size)
        hi = (ends - k + 1).clamp(0, size)
        return (ends - starts >= k) & (before[hi] > before[lo])
