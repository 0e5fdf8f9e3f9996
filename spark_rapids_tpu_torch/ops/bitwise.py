"""Bitwise expressions — port of ``spark_rapids_tpu/ops/bitwise.py``:
``BitwiseAnd``, ``BitwiseOr``, ``BitwiseXor``, ``BitwiseNot``,
``ShiftLeft``, ``ShiftRight`` and ``ShiftRightUnsigned``.

Java's shift semantics, as the reference: the shift amount is masked to
the value's width (``n & 63`` for a bigint, ``n & 31`` for the narrower
integers), so 64 shifts a bigint by 0 and -1 by 63. Shifts compute in
int64 and wrap back to the value's type; the unsigned right shift of an
int (or narrower) shifts its 32-bit pattern, as the reference's
``uint32`` lane does.
"""

from __future__ import annotations

import torch

from .. import types as T
from .expression import BinaryExpression, UnaryExpression

_INT64_MIN = -0x8000000000000000


class _BitBinary(BinaryExpression):
    @property
    def data_type(self) -> T.DataType:
        return T.numeric_promote(self.left.data_type, self.right.data_type)

    def do_device(self, l, r):
        dt = self.data_type.torch_dtype
        return self.op(l.to(dt), r.to(dt)), None


class BitwiseAnd(_BitBinary):
    @staticmethod
    def op(l, r):
        return l & r


class BitwiseOr(_BitBinary):
    @staticmethod
    def op(l, r):
        return l | r


class BitwiseXor(_BitBinary):
    @staticmethod
    def op(l, r):
        return l ^ r


class BitwiseNot(UnaryExpression):
    @property
    def data_type(self) -> T.DataType:
        return self.child.data_type

    def do_device(self, data):
        return ~data, None


class _Shift(BinaryExpression):
    """Shift of the left value by the right amount, masked to the value's
    width; the result has the left side's type."""

    @property
    def data_type(self) -> T.DataType:
        return self.left.data_type

    def do_device(self, l, r):
        mask = 63 if self.data_type is T.LONG else 31
        sh = r.to(torch.int64) & mask
        return self.shift(l.to(torch.int64), sh).to(l.dtype), None


class ShiftLeft(_Shift):
    def shift(self, v, sh):
        return v << sh


class ShiftRight(_Shift):
    def shift(self, v, sh):
        return v >> sh


class ShiftRightUnsigned(_Shift):
    def shift(self, v, sh):
        if self.data_type is not T.LONG:
            return (v & 0xFFFFFFFF) >> sh
        # the arithmetic shift, then the sign bits it copied cleared: the
        # low 64 - sh bits are ~(MIN >> (sh - 1)); sh = 0 shifts nothing
        low = ~(torch.full_like(v, _INT64_MIN) >> (sh - 1).clamp(min=0))
        return torch.where(sh == 0, v, (v >> sh) & low)
