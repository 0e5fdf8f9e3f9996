"""Predicates, comparisons and three-valued logic — port of
``spark_rapids_tpu/ops/predicates.py``.

Comparisons return null when either side is null. And/Or use Kleene
logic (``false AND null = false``, ``true OR null = true``) as explicit
mask algebra over (data, validity).

Strings compare through their dictionaries: the dictionaries are small
and on the host, so the comparison runs once per (left entry, right
entry) pair on the host, and each row gathers its pair's answer by codes
on the device. This is the reference's dictionary fast path
(``strings_util.device_string_compare``). A flat string on either side,
or two dictionaries whose entry pairs number more than 2^24 (TPC-DS
customer and item ids), compare row by row over their char matrices at
the wider side's width: the first byte that differs decides, and
``PAD`` past a string's end orders it before its longer extensions.
``In`` over strings matches char rows through the dictionary
(``strings_util.lift_dict``), for both layouts. ``EqualNullSafe`` over a
flat string compares bytes from the two layouts
(``strings_util.rows_equal``), with no char matrix.
"""

from __future__ import annotations

import operator
from typing import List

import numpy as np
import torch

from .. import types as T
from ..data.batch import ColumnarBatch
from ..data.column import DeviceColumn, device_constant
from .expression import BinaryExpression, Expression, make_column
from .strings_util import PAD, char_matrix, lift_dict, rows_equal

#: Entry-pair product above which a dictionary comparison is refused.
_MAX_DICT_PAIRS = 1 << 24


def dict_compare(op, l: DeviceColumn, r: DeviceColumn) -> torch.Tensor:
    """``op(l, r)`` per row for two string columns: through the
    dictionaries' entry pairs when both are dictionaries with at most
    ``_MAX_DICT_PAIRS`` pairs, else :func:`row_compare`."""
    if not (l.is_dict and r.is_dict) \
            or l.dict_size * r.dict_size > _MAX_DICT_PAIRS:
        return row_compare(op, l, r)
    if l.dict_size == 0 or r.dict_size == 0:
        return torch.zeros(l.capacity, dtype=torch.bool, device=l.device)
    mat = op(l.dictionary[:, None], r.dictionary[None, :]).astype(bool)
    mat = device_constant(mat, l.device)
    li = l.codes.long().clamp(0, l.dict_size - 1)
    ri = r.codes.long().clamp(0, r.dict_size - 1)
    return mat[li, ri]


def row_compare(op, l: DeviceColumn, r: DeviceColumn) -> torch.Tensor:
    """``op(l, r)`` per row for two string columns of any layout: the
    sign of the first byte that differs between their char matrices (0
    where none does) against 0."""
    w = max(l.max_bytes, r.max_bytes, 1)
    lm, rm = char_matrix(l, w), char_matrix(r, w)
    diff = lm != rm
    first = diff.to(torch.uint8).argmax(1, keepdim=True)
    sign = torch.sign(lm.gather(1, first).int() - rm.gather(1, first).int())
    return op(torch.where(diff.any(1), sign[:, 0], 0), 0)


class Comparison(BinaryExpression):
    """Base for =, !=, <, <=, >, >=; null if either input is null."""

    op = staticmethod(operator.eq)

    @property
    def data_type(self) -> T.DataType:
        return T.BOOLEAN

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        l = self.left.eval_device(batch)
        r = self.right.eval_device(batch)
        validity = l.validity & r.validity
        if l.is_string or r.is_string:
            data = dict_compare(self.op, l, r)
        else:
            data = self.op(l.data, r.data)
        return make_column(data, validity, T.BOOLEAN)


class EqualTo(Comparison):
    op = staticmethod(operator.eq)


class NotEqual(Comparison):
    op = staticmethod(operator.ne)


class LessThan(Comparison):
    op = staticmethod(operator.lt)


class LessThanOrEqual(Comparison):
    op = staticmethod(operator.le)


class GreaterThan(Comparison):
    op = staticmethod(operator.gt)


class GreaterThanOrEqual(Comparison):
    op = staticmethod(operator.ge)


class And(BinaryExpression):
    """Kleene AND: false wins over null."""

    @property
    def data_type(self) -> T.DataType:
        return T.BOOLEAN

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        l = self.left.eval_device(batch)
        r = self.right.eval_device(batch)
        data = l.data & r.data & l.validity & r.validity
        known_false = (l.validity & ~l.data) | (r.validity & ~r.data)
        validity = (l.validity & r.validity) | known_false
        return make_column(data, validity, T.BOOLEAN)


class Or(BinaryExpression):
    """Kleene OR: true wins over null."""

    @property
    def data_type(self) -> T.DataType:
        return T.BOOLEAN

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        l = self.left.eval_device(batch)
        r = self.right.eval_device(batch)
        known_true = (l.validity & l.data) | (r.validity & r.data)
        validity = (l.validity & r.validity) | known_true
        return make_column(known_true, validity, T.BOOLEAN)


class Not(Expression):
    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return T.BOOLEAN

    def with_children(self, children):
        return Not(children[0])

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        c = self.children[0].eval_device(batch)
        return make_column(~c.data, c.validity, T.BOOLEAN)


class IsNull(Expression):
    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return T.BOOLEAN

    @property
    def nullable(self) -> bool:
        return False

    def with_children(self, children):
        return type(self)(children[0])

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        c = self.children[0].eval_device(batch)
        live = batch.row_mask()
        return make_column(~c.validity & live, live, T.BOOLEAN)


class IsNotNull(IsNull):
    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        c = self.children[0].eval_device(batch)
        live = batch.row_mask()
        return make_column(c.validity & live, live, T.BOOLEAN)


class In(Expression):
    """value IN (literals...), Spark's null semantics: a null input gives
    null; a value not found gives null when the list holds a null."""

    def __init__(self, child: Expression, values: List):
        self.children = [child]
        self.values = list(values)

    @property
    def data_type(self) -> T.DataType:
        return T.BOOLEAN

    def with_children(self, children):
        return In(children[0], self.values)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        c = self.children[0].eval_device(batch)
        non_null = [x for x in self.values if x is not None]
        has_null = len(non_null) != len(self.values)
        if c.is_string:
            needles = [str(x).encode("utf-8") for x in non_null]
            w = max([c.max_bytes, 1] + [len(b) for b in needles])
            rows = np.full((max(len(needles), 1), w), PAD, dtype=np.int16)
            for i, b in enumerate(needles):
                rows[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)

            def match(m, _lengths):
                found = torch.zeros(m.shape[0], dtype=torch.bool,
                                    device=m.device)
                want = device_constant(rows, m.device)
                for i in range(len(needles)):
                    found = found | (m == want[i]).all(1)
                return found
            found = lift_dict(c, match, width=w)
        else:
            found = torch.zeros_like(c.validity)
            for x in non_null:
                found = found | (c.data == x)
        validity = c.validity & (found | (not has_null))
        return make_column(found, validity, T.BOOLEAN)


class EqualNullSafe(BinaryExpression):
    """``a <=> b``: equality where two nulls are equal and a null and a
    value are not; never null (on live rows)."""

    @property
    def data_type(self) -> T.DataType:
        return T.BOOLEAN

    @property
    def nullable(self) -> bool:
        return False

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        l = self.left.eval_device(batch)
        r = self.right.eval_device(batch)
        if l.is_dict and r.is_dict:
            eq = dict_compare(operator.eq, l, r)
        elif l.is_string or r.is_string:
            eq = rows_equal(l, r)
        else:
            eq = l.data == r.data
        both_valid = l.validity & r.validity
        both_null = ~l.validity & ~r.validity
        live = batch.row_mask()
        data = torch.where(both_valid, eq, both_null) & live
        return DeviceColumn(data, live, T.BOOLEAN)


class IsNaN(Expression):
    """``isnan(x)``: true for a NaN, false otherwise and for a null."""

    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return T.BOOLEAN

    @property
    def nullable(self) -> bool:
        return False

    def with_children(self, children):
        return IsNaN(children[0])

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        c = self.children[0].eval_device(batch)
        live = batch.row_mask()
        return DeviceColumn(torch.isnan(c.data) & c.validity & live, live,
                            T.BOOLEAN)


class AtLeastNNonNulls(Expression):
    """``at_least_n_non_nulls(n, e1, e2, ...)`` (``df.na.drop``): true
    where at least ``n`` of the arguments are not null. As the
    reference's device path, a NaN counts as non-null."""

    def __init__(self, n: int, *children: Expression):
        self.n = int(n)
        self.children = list(children)

    @property
    def data_type(self) -> T.DataType:
        return T.BOOLEAN

    @property
    def nullable(self) -> bool:
        return False

    def with_children(self, children):
        return AtLeastNNonNulls(self.n, *children)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        count = torch.zeros(batch.capacity, dtype=torch.int32,
                            device=batch.device)
        for c in self.children:
            count = count + c.eval_device(batch).validity.to(torch.int32)
        return make_column(count >= self.n, batch.row_mask(), T.BOOLEAN)
