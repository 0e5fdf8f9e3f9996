"""String expressions — port of ``spark_rapids_tpu/ops/strings.py``:
``Substring`` with literal position and length, the form TPC-H Q22's
country code takes, ``StartsWith``, ``EndsWith`` and ``Contains`` with a
literal needle (the reference's ``_FixMatch``: Q2, Q9, Q13, Q14, Q16,
Q19, Q20), SQL ``LIKE`` (TPCxBB q18, q19, q27), ``Length``, ``Upper``,
``Lower``, ``ConcatStrings`` and the three trims. Byte semantics, as
the reference's device path: ``Length`` counts bytes, and ``Upper`` and
``Lower`` map ASCII letters only.

The last five work from the columns' own layouts
(:func:`.strings_util.row_layout`, :func:`.strings_util.flat_column`):
a dictionary column's case map and trims transform its entries once and
keep its codes (:func:`.strings_util.map_string_column`).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import types as T
from ..data.batch import ColumnarBatch
from ..data.column import DeviceColumn, device_constant, string_max_bytes
from .expression import Expression, Literal, make_column
from .kernels.rowops import strings_from_matrix
from .strings_util import (PAD, byte_stream, char_matrix, flat_column,
                           lengths, lift_dict, map_string_column,
                           read_bytes, row_layout)


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
            needle = device_constant(list(raw), dev, np.int16)
            data = lift_dict(c, lambda m, ln: self.match_matrix(m, ln,
                                                                needle))
        else:
            needle = device_constant(list(raw), dev, np.uint8)
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


#: Token kinds of a LIKE pattern (:meth:`Like.tokens`).
_LIT, _ONE, _ANY = 0, 1, 2


def _like_dp(n: int, w: int,
             byte_at: Callable[[int], Tuple[torch.Tensor, torch.Tensor]],
             toks: List[Tuple[int, int]], device) -> torch.Tensor:
    """The reference's wildcard walk (``_like_dp``) over ``n`` strings of
    at most ``w`` bytes: ``byte_at(j)`` gives every string's byte at
    position ``j`` (int) and whether the string has one there. State
    ``i`` holds "the first ``i`` tokens matched the bytes read so far";
    a string's answer is the last state after its last byte (positions
    past a string's end leave its states as they are).

    ``_`` is UTF-8-aware: it takes one lead byte, and continuation bytes
    (``10xxxxxx``) then extend the same state, so it matches one
    character. ``%`` needs no such care: the literal after it starts
    with a lead byte and never matches inside a character."""
    p = len(toks)
    dp = [torch.ones(n, dtype=torch.bool, device=device)]
    for i in range(1, p + 1):
        dp.append(dp[i - 1] & (toks[i - 1][0] == _ANY))
    for j in range(w):
        c, valid = byte_at(j)
        cont = (c & 0xC0) == 0x80
        ndp = [torch.zeros(n, dtype=torch.bool, device=device)]
        for i in range(1, p + 1):
            kind, lit = toks[i - 1]
            if kind == _ANY:
                nd = ndp[i - 1] | dp[i] | dp[i - 1]
            elif kind == _ONE:
                nd = (dp[i - 1] & ~cont) | (dp[i] & cont)
            else:
                nd = dp[i - 1] & (c == lit)
            ndp.append(nd)
        dp = [torch.where(valid, a, b) for a, b in zip(ndp, dp)]
    return dp[p]


class Like(Expression):
    """``str LIKE pattern`` with ``%`` (any run of characters) and ``_``
    (one character); ``escape`` makes the next pattern byte literal. A
    null string gives null.

    The simple forms go to the port's own matchers, as in the reference:
    ``%x%`` to :class:`Contains`, ``x%`` to :class:`StartsWith`, ``%x``
    to :class:`EndsWith` and ``x`` to ``EqualTo`` (a flat column, which
    ``EqualTo`` does not take yet, walks the pattern instead). Any other
    pattern walks :func:`_like_dp`: once over a dictionary's entries,
    the rows gathering their entry's answer by code, or over a flat
    column's own offsets and payload, one byte position at a time up to
    its longest live string (no ``[capacity, W]`` char matrix)."""

    def __init__(self, child: Expression, pattern: str, escape: str = "\\"):
        self.children = [child]
        self.pattern = pattern
        self.escape = escape

    @property
    def data_type(self) -> T.DataType:
        return T.BOOLEAN

    def with_children(self, children):
        return Like(children[0], self.pattern, self.escape)

    def simple_form(self) -> Optional[Tuple[str, str]]:
        """``(kind, literal)`` when the pattern is a simple form (kind
        ``contains``, ``prefix``, ``suffix`` or ``exact``), else None."""
        p = self.pattern
        if "_" in p or self.escape in p:
            return None
        inner = p.strip("%")
        if "%" in inner:
            return None
        if p.startswith("%") and p.endswith("%") and len(p) >= 2:
            return ("contains", inner)
        if p.endswith("%") and not p.startswith("%"):
            return ("prefix", inner)
        if p.startswith("%"):
            return ("suffix", inner)
        return ("exact", inner)

    def tokens(self) -> List[Tuple[int, int]]:
        """The pattern as byte tokens ``(kind, byte)``: a literal byte,
        ``_`` or ``%`` (runs of ``%`` collapse); the escape byte makes
        the next byte a literal (a trailing escape is a literal
        itself)."""
        pb = self.pattern.encode("utf-8")
        esc = self.escape.encode("utf-8")[0] if self.escape else None
        toks: List[Tuple[int, int]] = []
        i = 0
        while i < len(pb):
            b = pb[i]
            if esc is not None and b == esc and i + 1 < len(pb):
                toks.append((_LIT, pb[i + 1]))
                i += 2
                continue
            if b == 0x25:
                if not toks or toks[-1] != (_ANY, 0):
                    toks.append((_ANY, 0))
            elif b == 0x5F:
                toks.append((_ONE, 0))
            else:
                toks.append((_LIT, b))
            i += 1
        return toks

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        form = self.simple_form()
        child = self.children[0]
        if form is not None and form[0] != "exact":
            impl = {"contains": Contains, "prefix": StartsWith,
                    "suffix": EndsWith}[form[0]]
            return impl(child, form[1]).eval_device(batch)
        c = child.eval_device(batch)
        if form is not None and c.is_dict:
            from .predicates import EqualTo
            return EqualTo(child, Literal(form[1], T.STRING)
                           ).eval_device(batch)
        toks = self.tokens()
        if c.is_dict:
            data = lift_dict(c, lambda m, _: _like_dp(
                m.shape[0], m.shape[1], lambda j: (m[:, j], m[:, j] != PAD),
                toks, m.device))
        else:
            data = self._match_flat(c, toks)
        return make_column(data & c.validity, c.validity, T.BOOLEAN)

    @staticmethod
    def _match_flat(c: DeviceColumn, toks) -> torch.Tensor:
        starts = c.offsets[:-1].long()
        ends = c.offsets[1:].long()
        payload = c.data
        size = payload.shape[0]
        n_len = torch.where(c.validity, ends - starts, 0)
        w = int(n_len.max()) if n_len.numel() else 0

        def byte_at(j):
            pos = starts + j
            valid = pos < ends
            b = payload[pos.clamp(0, max(size - 1, 0))].to(torch.int16)
            return b, valid
        return _like_dp(c.capacity, w, byte_at, toks, c.device)


# --------------------------------------------------------------------------
# Length, case maps, concatenation, trims
# --------------------------------------------------------------------------


class _StringUnary(Expression):
    """One string child."""

    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def child(self) -> Expression:
        return self.children[0]

    @property
    def data_type(self) -> T.DataType:
        return T.STRING

    def with_children(self, children):
        return type(self)(children[0])


class Length(_StringUnary):
    """``length(str)`` in bytes, as the reference's device path counts."""

    @property
    def data_type(self) -> T.DataType:
        return T.INT

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        c = self.child.eval_device(batch)
        return make_column(lengths(c), c.validity, T.INT)


class _CaseMap(_StringUnary):
    """ASCII letters in ``[lo, hi]`` shifted by ``delta``; every other
    byte (non-ASCII ones too) kept. A flat column maps its payload in
    place and keeps its offsets."""

    lo, hi, delta = 0, 0, 0

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        def xform(col: DeviceColumn) -> DeviceColumn:
            b = col.data
            hit = (b >= self.lo) & (b <= self.hi)
            mapped = (b.to(torch.int16) + self.delta).to(torch.uint8)
            return DeviceColumn(torch.where(hit, mapped, b), col.validity,
                                T.STRING, offsets=col.offsets,
                                max_bytes=col.max_bytes)
        return map_string_column(self.child.eval_device(batch), xform)


class Upper(_CaseMap):
    lo, hi, delta = ord("a"), ord("z"), -32


class Lower(_CaseMap):
    lo, hi, delta = ord("A"), ord("Z"), 32


class ConcatStrings(Expression):
    """``concat(s1, s2, ...)``: null if any argument is null. Row i of
    the result is the arguments' rows i one after another, read from
    each argument's own layout."""

    def __init__(self, *children: Expression):
        self.children = list(children)

    @property
    def data_type(self) -> T.DataType:
        return T.STRING

    def with_children(self, children):
        return ConcatStrings(*children)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        cols = [c.eval_device(batch) for c in self.children]
        validity = cols[0].validity
        for c in cols[1:]:
            validity = validity & c.validity
        layouts = [row_layout(c) for c in cols]
        # before[k]: the bytes of the arguments ahead of argument k
        before, total = [], torch.zeros_like(layouts[0][2])
        for _, _, ln in layouts:
            before.append(total)
            total = total + ln

        def byte_fn(row, j):
            out = torch.zeros(row.shape[0], dtype=torch.int16,
                              device=row.device)
            for (p, s, ln), b in zip(layouts, before):
                rel = j - b[row]
                mine = (rel >= 0) & (rel < ln[row])
                out = torch.where(mine, read_bytes(p, s[row] + rel), out)
            return out
        return flat_column(total, validity, byte_fn)


class _Trim(_StringUnary):
    """trim / ltrim / rtrim of spaces (byte 32 only, as the reference's
    device path): a string of spaces becomes empty."""

    trim_left = True
    trim_right = True

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        def xform(col: DeviceColumn) -> DeviceColumn:
            payload, starts, lens = row_layout(col)
            n = lens.shape[0]
            row, j = byte_stream(lens)
            solid = read_bytes(payload, starts[row] + j) != 32
            first = torch.full((n,), 2 ** 62, dtype=torch.int64,
                               device=lens.device)
            last = torch.full((n,), -1, dtype=torch.int64,
                              device=lens.device)
            first.scatter_reduce_(0, row, torch.where(solid, j, 2 ** 62),
                                  "amin")
            last.scatter_reduce_(0, row, torch.where(solid, j, -1), "amax")
            has = last >= 0
            lo = first if self.trim_left else torch.zeros_like(first)
            hi = last + 1 if self.trim_right else lens
            out_len = torch.where(has, hi - lo, 0)
            lo = torch.where(has, lo, 0)
            return flat_column(out_len, col.validity, lambda r, k: read_bytes(
                payload, starts[r] + lo[r] + k))
        return map_string_column(self.child.eval_device(batch), xform)


class StringTrim(_Trim):
    pass


class StringTrimLeft(_Trim):
    trim_right = False


class StringTrimRight(_Trim):
    trim_left = False
