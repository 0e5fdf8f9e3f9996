"""Arithmetic — port of ``spark_rapids_tpu/ops/arithmetic.py`` (Spark
non-ANSI semantics): integral add/sub/mul wrap (two's complement, as
torch's integer ops do), floats follow IEEE, a null on either side
gives null (``BinaryExpression`` propagates validity), and a zero
divisor gives null (``Divide``, ``IntegralDivide``, ``Remainder``,
``Pmod``): the mask is ``do_device``'s second return, which the base
class folds into the validity.

Integral division truncates toward zero, as Java's does. A divisor of
-1 never reaches the division: ``MIN / -1`` traps on a CPU and is
undefined on the card, so the quotient is the wrapped negation (Java's
``Long.MIN_VALUE / -1 == Long.MIN_VALUE``) and the remainder 0."""

from __future__ import annotations

import torch

from .. import types as T
from .expression import BinaryExpression, UnaryExpression


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


def _safe_divisor(r: torch.Tensor):
    """``(zero, minus_one, safe)``: the masks of the divisors 0 and -1,
    and the divisor with both replaced by 1 (integral operands; a float
    divisor is only guarded against 0)."""
    zero = r == 0
    if r.is_floating_point():
        return zero, None, torch.where(zero, torch.ones_like(r), r)
    minus_one = r == -1
    return zero, minus_one, torch.where(zero | minus_one,
                                        torch.ones_like(r), r)


def _java_rem(l: torch.Tensor, r: torch.Tensor):
    """``(l % r, zero, safe)`` with Java's sign (the dividend's): ``fmod``
    for floats, ``l - trunc(l / r) * r`` for integers (0 where ``r`` is
    -1); ``zero`` and ``safe`` as :func:`_safe_divisor` gives them."""
    zero, _, safe = _safe_divisor(r)
    if l.is_floating_point():
        return torch.fmod(l, safe), zero, safe
    return l - torch.div(l, safe, rounding_mode="trunc") * safe, zero, safe


class IntegralDivide(BinaryArithmetic):
    """``a div b``: LONG division truncating toward zero (both sides cast
    to LONG first); a zero divisor gives null."""

    @property
    def data_type(self) -> T.DataType:
        return T.LONG

    def do_device(self, l, r):
        l, r = l.to(torch.int64), r.to(torch.int64)
        zero, minus_one, safe = _safe_divisor(r)
        q = torch.div(l, safe, rounding_mode="trunc")
        return torch.where(minus_one, -l, q), zero


class Remainder(BinaryArithmetic):
    """``a % b``: Java's remainder, with the sign of the dividend
    (``fmod`` for floats); a zero divisor gives null."""

    def do_device(self, l, r):
        dt = self.data_type.torch_dtype
        m, zero, _ = _java_rem(l.to(dt), r.to(dt))
        return m, zero


class Pmod(BinaryArithmetic):
    """``pmod(a, b)``: the remainder moved to the divisor's sign (a
    nonzero remainder whose sign differs from the divisor's gets the
    divisor added); a zero divisor gives null."""

    def do_device(self, l, r):
        dt = self.data_type.torch_dtype
        m, zero, safe = _java_rem(l.to(dt), r.to(dt))
        flip = (m != 0) & ((m < 0) != (safe < 0))
        return torch.where(flip, m + safe, m), zero


class UnaryMinus(UnaryExpression):
    """``-x`` in the child's type: an integral minimum wraps to itself
    (non-ANSI), a float flips its sign bit (``-0.0`` from ``0.0``)."""

    @property
    def data_type(self) -> T.DataType:
        return self.child.data_type

    def do_device(self, data):
        return -data, None


class Abs(UnaryExpression):
    """``abs(x)`` in the child's type: an integral minimum wraps to
    itself (non-ANSI), ``abs(-0.0)`` is ``0.0``."""

    @property
    def data_type(self) -> T.DataType:
        return self.child.data_type

    def do_device(self, data):
        return torch.abs(data), None
