"""String functions, part 2 — port of ``spark_rapids_tpu/ops/strings2.py``:
``StringReplace``, ``RegExpReplace`` (literal patterns only,
lowered to a replace as in the reference), ``LPad``, ``RPad``,
``StringLocate``, ``InitCap``, ``SubstringIndex``, ``Reverse`` and
``StringRepeat``; ``StringSplit`` plans nowhere, since its ARRAY<STRING>
result has no device layout (arrays hold fixed-width elements) and the
reference evaluates it on its host path. Byte semantics, as the reference's device path
(``Reverse`` reverses bytes; ``InitCap`` maps ASCII letters).

Every function works from the column's own layout, with no char matrix:
a string's bytes form a stream (:func:`.strings_util.byte_stream`), a
literal needle matches where its ``k`` shifted compares all hold inside
one row, and the result is built from its rows' lengths
(:func:`.strings_util.flat_column`). A dictionary input transforms its
entries once and keeps its codes (:func:`.strings_util.map_string_column`,
the reference's rule).
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np
import torch

from .. import types as T
from ..data.batch import ColumnarBatch
from ..data.column import DeviceColumn, device_constant
from .expression import Expression, make_column
from .strings_util import (byte_stream, entries_column, flat_column,
                           map_string_column, read_bytes, row_layout)


def _stream(col: DeviceColumn):
    """``(payload, starts, lens, row, j, src)``: the column's layout and
    its byte stream, ``src`` each stream byte's payload position."""
    payload, starts, lens = row_layout(col)
    row, j = byte_stream(lens)
    return payload, starts, lens, row, j, starts[row] + j


def _needle_hits(payload, lens, row, j, src, needle: bytes) -> torch.Tensor:
    """bool per stream byte: the needle starts there and ends inside the
    row."""
    hit = j + len(needle) <= lens[row]
    for t, ch in enumerate(needle):
        hit = hit & (read_bytes(payload, src + t) == ch)
    return hit


def _window_count(sel: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Per stream byte b, the selected bytes in ``[b - lo, b - hi]``
    (``lo >= hi >= 0``)."""
    c = torch.zeros(sel.shape[0] + 1, dtype=torch.int64, device=sel.device)
    c[1:] = torch.cumsum(sel.long(), 0)
    b = torch.arange(sel.shape[0], device=sel.device)
    return c[(b - hi + 1).clamp(min=0)] - c[(b - lo).clamp(min=0)]


def _leftmost(hit: torch.Tensor, k: int) -> torch.Tensor:
    """The non-overlapping matches a left-to-right scan takes: a hit is
    taken unless a taken hit starts within the ``k - 1`` bytes before
    it. Solved by iterating to the fixed point, which the first ``t``
    hits of a run of overlapping hits reach after ``t`` rounds (one host
    read a round)."""
    if k <= 1 or not bool(hit.any()):
        return hit
    sel = hit
    while True:
        nxt = hit & (_window_count(sel, k - 1, 1) == 0)
        if torch.equal(nxt, sel):
            return sel
        sel = nxt


def _row_sums(row: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(n, dtype=torch.int64, device=row.device)
    out.index_add_(0, row, x.long())
    return out


def _row_min(row: torch.Tensor, x: torch.Tensor, n: int,
             none: int) -> torch.Tensor:
    out = torch.full((n,), none, dtype=torch.int64, device=row.device)
    out.scatter_reduce_(0, row, x.long(), "amin")
    return out


class _StringFn(Expression):
    """One string child and literal arguments (``args``)."""

    args: Tuple[str, ...] = ()

    def __init__(self, child: Expression, *values):
        self.children = [child]
        for name, v in zip(self.args, values):
            setattr(self, name, v)

    @property
    def data_type(self) -> T.DataType:
        return T.STRING

    def with_children(self, children):
        return type(self)(children[0], *[getattr(self, a)
                                         for a in self.args])

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        return map_string_column(self.children[0].eval_device(batch),
                                 self.xform)

    def xform(self, col: DeviceColumn) -> DeviceColumn:
        raise NotImplementedError


class StringReplace(_StringFn):
    """``replace(str, search, replace)`` with literals: every
    non-overlapping occurrence of ``search``, left to right, replaced; an
    empty ``search`` changes nothing."""

    args = ("search", "replace")

    def xform(self, col):
        search, rep = self.search.encode(), self.replace.encode()
        payload, starts, lens, row, j, src = _stream(col)
        if not search or not row.numel():
            return col
        sel = _leftmost(_needle_hits(payload, lens, row, j, src, search),
                        len(search))
        k = len(search)
        covered = (_window_count(sel, k - 1, 0) > 0) & ~sel
        contrib = torch.where(sel, len(rep), torch.where(covered, 0, 1))
        n = lens.shape[0]
        out_len = _row_sums(row, contrib, n)
        incl = torch.cumsum(contrib, 0)
        rep_t = device_constant(list(rep) or [0], payload.device, np.int16)

        def byte_fn(orow, oj):
            o = torch.arange(orow.shape[0], device=orow.device)
            b = torch.searchsorted(incl, o, right=True)
            at = o - (incl[b] - contrib[b])
            return torch.where(sel[b], rep_t[at.clamp(0, rep_t.shape[0] - 1)],
                               read_bytes(payload, src[b]))
        return flat_column(out_len, col.validity, byte_fn)


class RegExpReplace(_StringFn):
    """``regexp_replace`` with a pattern free of regex syntax: the literal
    replace above (the reference's lowering). A real regular expression
    raises ``NotImplementedError``: the reference runs it on its CPU
    path."""

    args = ("pattern", "replacement")
    _META = re.compile(r"[.^$*+?{}\[\]\\|()]")

    @property
    def is_literal_pattern(self) -> bool:
        return not self._META.search(self.pattern)

    def eval_device(self, batch):
        if not self.is_literal_pattern:
            raise NotImplementedError(
                f"regexp_replace pattern {self.pattern!r} is a regular "
                "expression, which runs only on the reference's CPU path")
        return StringReplace(self.children[0], self.pattern,
                             self.replacement).eval_device(batch)


class _Pad(_StringFn):
    """lpad / rpad to ``length`` bytes with ``pad`` repeated; a longer
    string is cut to its first ``length`` bytes; an empty pad only
    cuts."""

    args = ("length", "pad")
    left = True

    def __init__(self, child: Expression, length: int, pad: str = " "):
        super().__init__(child, int(length), pad)

    def xform(self, col):
        payload, starts, lens = row_layout(col)
        target = self.length
        pad = self.pad.encode()
        if not pad:
            return flat_column(lens.clamp(max=target).clamp(min=0),
                               col.validity, lambda r, k: read_bytes(
                                   payload, starts[r] + k))
        pad_t = device_constant(list(pad), payload.device, np.int16)
        out_len = torch.full_like(lens, max(target, 0))
        pad_n = (target - lens).clamp(min=0)

        def byte_fn(r, o):
            if self.left:
                in_pad = o < pad_n[r]
                s = read_bytes(payload, starts[r] + o - pad_n[r])
                p = pad_t[o % len(pad)]
            else:
                in_pad = o >= lens[r]
                s = read_bytes(payload, starts[r] + o)
                p = pad_t[(o - lens[r]).clamp(min=0) % len(pad)]
            return torch.where(in_pad, p, s)
        return flat_column(out_len, col.validity, byte_fn)


class LPad(_Pad):
    left = True


class RPad(_Pad):
    left = False


class StringLocate(Expression):
    """``locate(substr, str[, pos])``: the 1-based byte position of the
    first occurrence at or after ``pos``, 0 when there is none (or when
    ``pos`` < 1); an empty ``substr`` gives ``pos``."""

    def __init__(self, substr: str, child: Expression, pos: int = 1):
        self.children = [child]
        self.substr = substr
        self.pos = int(pos)

    @property
    def data_type(self) -> T.DataType:
        return T.INT

    def with_children(self, children):
        return StringLocate(self.substr, children[0], self.pos)

    def eval_device(self, batch):
        c = self.children[0].eval_device(batch)
        needle = self.substr.encode()
        if self.pos < 1 or not needle:
            value = 0 if self.pos < 1 else self.pos
            data = torch.full((c.capacity,), value, dtype=torch.int32,
                              device=c.device)
            return make_column(data, c.validity, T.INT)

        def locate(col):
            payload, starts, lens, row, j, src = _stream(col)
            hit = _needle_hits(payload, lens, row, j, src, needle) \
                & (j >= self.pos - 1)
            first = _row_min(row, torch.where(hit, j, 2 ** 62),
                             lens.shape[0], 2 ** 62)
            return torch.where(first < 2 ** 62, first + 1, 0).to(torch.int32)
        if c.is_dict:
            data = locate(entries_column(c))[c.codes.long().clamp(
                0, max(c.dict_size - 1, 0))]
        else:
            data = locate(c)
        return make_column(data, c.validity, T.INT)


class InitCap(_StringFn):
    """``initcap``: an ASCII letter after a space (or first) upper case,
    every other ASCII letter lower case."""

    def xform(self, col):
        payload, starts, lens = row_layout(col)

        def byte_fn(r, k):
            b = read_bytes(payload, starts[r] + k)
            prev = read_bytes(payload, starts[r] + k - 1)
            first = (k == 0) | (prev == 32)
            lower = (b >= 97) & (b <= 122)
            upper = (b >= 65) & (b <= 90)
            return torch.where(first & lower, b - 32,
                               torch.where(~first & upper, b + 32, b))
        return flat_column(lens, col.validity, byte_fn)


class SubstringIndex(_StringFn):
    """``substring_index(str, delim, count)``: the part before the
    ``count``-th delimiter (count > 0) or after the ``|count|``-th from
    the end (count < 0), delimiters taken left to right without overlap;
    the whole string when there are fewer; empty for an empty delimiter
    or a count of 0."""

    args = ("delim", "count")

    def __init__(self, child: Expression, delim: str, count: int):
        super().__init__(child, delim, int(count))

    def xform(self, col):
        payload, starts, lens, row, j, src = _stream(col)
        n = lens.shape[0]
        delim, count = self.delim.encode(), self.count
        if not delim or count == 0:
            return flat_column(torch.zeros_like(lens), col.validity,
                               lambda r, k: torch.zeros_like(k))
        sel = _leftmost(_needle_hits(payload, lens, row, j, src, delim),
                        len(delim))
        # occ: the 1-based index, within its row, of each delimiter taken
        seen = torch.cumsum(sel.long(), 0)
        first = (torch.cumsum(lens, 0) - lens)[row]
        occ = seen - (seen[first] - sel[first].long())
        total = _row_sums(row, sel, n)
        target = torch.full_like(lens, count) if count > 0 \
            else total + count + 1
        kth = _row_min(row, torch.where(sel & (occ == target[row]), j,
                                        2 ** 62), n, 2 ** 62)
        enough = total >= abs(count)
        if count > 0:
            start = torch.zeros_like(lens)
            out_len = torch.where(enough, kth, lens)
        else:
            start = torch.where(enough, kth + len(delim), 0)
            out_len = lens - start
        return flat_column(out_len, col.validity, lambda r, k: read_bytes(
            payload, starts[r] + start[r] + k))


class Reverse(_StringFn):
    """``reverse(str)``, byte by byte."""

    def xform(self, col):
        payload, starts, lens = row_layout(col)
        return flat_column(lens, col.validity, lambda r, k: read_bytes(
            payload, starts[r] + lens[r] - 1 - k))


class StringRepeat(_StringFn):
    """``repeat(str, n)`` with a literal ``n`` (below 1: empty)."""

    args = ("n",)

    def __init__(self, child: Expression, n: int):
        super().__init__(child, max(int(n), 0))

    def xform(self, col):
        payload, starts, lens = row_layout(col)
        return flat_column(lens * self.n, col.validity,
                           lambda r, k: read_bytes(
                               payload, starts[r] + k % lens[r].clamp(
                                   min=1)))


class StringSplit(Expression):
    """``split(str, delimiter[, limit])``: its ARRAY<STRING> result has no
    device layout, so the reference's rule sends it to the host path
    (``plan/overrides.py:164-170``). The port has no host path: the
    planner raises :attr:`REASON`, and so does evaluation."""

    REASON = ("ARRAY<STRING> has no device layout; split(str, delim) "
              "evaluates on the host path (the reference's "
              "plan/overrides.py _string_split_tag), which the port does "
              "not have")

    def __init__(self, child: Expression, delimiter: str, limit: int = -1):
        self.children = [child]
        self.delimiter = delimiter
        self.limit = limit

    def with_children(self, children):
        return StringSplit(children[0], self.delimiter, self.limit)

    @property
    def data_type(self):
        return T.ArrayType(T.STRING, contains_null=False)

    @property
    def name(self):
        return f"split({self.children[0]}, {self.delimiter!r})"

    def __str__(self):
        return self.name

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        raise NotImplementedError(self.REASON)
