"""Predicates, comparisons and three-valued logic — port of
``spark_rapids_tpu/ops/predicates.py``.

Comparisons return null when either side is null. And/Or use Kleene
logic (``false AND null = false``, ``true OR null = true``) as explicit
mask algebra over (data, validity).

Strings compare through their dictionaries: the dictionaries are small
and on the host, so the comparison runs once per (left entry, right
entry) pair on the host, and each row gathers its pair's answer by codes
on the device. This is the reference's dictionary fast path
(``strings_util.device_string_compare``); the flat-string path waits
for the strings port.
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from .. import types as T
from ..data.batch import ColumnarBatch
from ..data.column import DeviceColumn
from .expression import BinaryExpression, Expression, make_column

#: Entry-pair product above which a dictionary comparison is refused.
_MAX_DICT_PAIRS = 1 << 24


def dict_compare(op, l: DeviceColumn, r: DeviceColumn) -> torch.Tensor:
    """``op(l, r)`` per row for two dictionary-encoded string columns."""
    if l.dict_size == 0 or r.dict_size == 0:
        return torch.zeros(l.capacity, dtype=torch.bool, device=l.device)
    if l.dict_size * r.dict_size > _MAX_DICT_PAIRS:
        raise NotImplementedError(
            "string comparison of two large dictionaries needs the flat "
            "string kernels, which are not ported yet")
    mat = op(l.dictionary[:, None], r.dictionary[None, :]).astype(bool)
    mat = torch.from_numpy(np.ascontiguousarray(mat)).to(l.device)
    li = l.codes.long().clamp(0, l.dict_size - 1)
    ri = r.codes.long().clamp(0, r.dict_size - 1)
    return mat[li, ri]


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
