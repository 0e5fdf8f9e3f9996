"""Arithmetic — port of ``spark_rapids_tpu/ops/arithmetic.py`` (Spark
non-ANSI semantics): integral add/sub/mul wrap (two's complement, as
torch's integer ops do), floats follow IEEE, a null on either side
gives null (``BinaryExpression`` propagates validity), and a division by
zero gives null."""

from __future__ import annotations

import torch

from .. import types as T
from .expression import BinaryExpression


class BinaryArithmetic(BinaryExpression):
    @property
    def data_type(self) -> T.DataType:
        return T.numeric_promote(self.left.data_type, self.right.data_type)

    def do_device(self, l, r):
        dt = self.data_type.torch_dtype
        return self.kernel(l.to(dt), r.to(dt)), None

    def kernel(self, l, r):
        raise NotImplementedError


class Add(BinaryArithmetic):
    def kernel(self, l, r):
        return l + r


class Subtract(BinaryArithmetic):
    def kernel(self, l, r):
        return l - r


class Multiply(BinaryArithmetic):
    def kernel(self, l, r):
        return l * r


class Divide(BinaryArithmetic):
    """Double division; a zero divisor gives null."""

    @property
    def data_type(self) -> T.DataType:
        return T.DOUBLE

    def do_device(self, l, r):
        l, r = l.to(torch.float64), r.to(torch.float64)
        zero = r == 0
        return l / torch.where(zero, 1.0, r), zero
