"""Math expressions — port of ``spark_rapids_tpu/ops/math.py``: the
``MathUnary`` functions (trig, hyperbolic, exp and logs, roots,
``Rint``, degrees and radians), ``Signum``, ``Floor``/``Ceil``, ``Pow``
and ``Atan2``. Spark's math functions take doubles and give doubles; a
null input gives null, and a domain error gives NaN or an infinity, as
``java.lang.Math`` does (``sqrt(-1)`` is NaN, ``log(0)`` is ``-inf``).
"""

from __future__ import annotations

import torch

from .. import types as T
from .cast import float_to_integral
from .expression import BinaryExpression, UnaryExpression


class MathUnary(UnaryExpression):
    """A double function of one child, applied elementwise by
    ``torch_fn`` to the child cast to float64."""

    torch_fn = None
    result_type = T.DOUBLE

    @property
    def data_type(self) -> T.DataType:
        return self.result_type

    def do_device(self, data: torch.Tensor):
        return type(self).torch_fn(data.to(torch.float64)), None


def _unary(name: str, torch_fn, result_type: T.DataType = T.DOUBLE):
    """A :class:`MathUnary` subclass named ``name`` (the reference's
    ``_unary``)."""
    return type(name, (MathUnary,), {"torch_fn": staticmethod(torch_fn),
                                     "result_type": result_type})


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Java's ``Math.cbrt``: the real cube root, odd in ``x``. torch has
    none, so the root of ``|x|`` by ``pow`` (a few ulp off, as ``1/3``
    is not exact) is refined by one Newton step, ``y + (a / y^2 - y) /
    3``, which leaves at most one ulp; zeros, infinities and NaN pass
    through unchanged."""
    a = x.abs()
    y = torch.pow(a, 1.0 / 3.0)
    y = y + (a / (y * y) - y) / 3.0
    keep = (a == 0) | torch.isinf(a) | torch.isnan(a)
    return torch.where(keep, x, torch.copysign(y, x))


Sin = _unary("Sin", torch.sin)
Cos = _unary("Cos", torch.cos)
Tan = _unary("Tan", torch.tan)
Asin = _unary("Asin", torch.asin)
Acos = _unary("Acos", torch.acos)
Atan = _unary("Atan", torch.atan)
Sinh = _unary("Sinh", torch.sinh)
Cosh = _unary("Cosh", torch.cosh)
Tanh = _unary("Tanh", torch.tanh)
Exp = _unary("Exp", torch.exp)
Expm1 = _unary("Expm1", torch.expm1)
Log = _unary("Log", torch.log)
Log2 = _unary("Log2", torch.log2)
Log10 = _unary("Log10", torch.log10)
Log1p = _unary("Log1p", torch.log1p)
Sqrt = _unary("Sqrt", torch.sqrt)
Cbrt = _unary("Cbrt", _cbrt)
#: Round half to even, as ``Math.rint``.
Rint = _unary("Rint", torch.round)
ToDegrees = _unary("ToDegrees", torch.rad2deg)
ToRadians = _unary("ToRadians", torch.deg2rad)


def _signum(x: torch.Tensor) -> torch.Tensor:
    """``Math.signum``: -1.0, 1.0, or ``x`` itself for a zero (its sign
    kept, as ``jnp.sign`` keeps it) or NaN (``torch.sign`` gives 0 for
    NaN)."""
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


Signum = _unary("Signum", _signum)


class _FloorCeil(UnaryExpression):
    """``floor``/``ceil``: a float child rounds and converts to LONG with
    Java's saturation (NaN gives 0, out of range clamps); an integral
    child passes through in its own type."""

    round_fn = None

    @property
    def data_type(self) -> T.DataType:
        return T.LONG if self.child.data_type.is_floating \
            else self.child.data_type

    def do_device(self, data: torch.Tensor):
        if self.child.data_type.is_floating:
            return float_to_integral(type(self).round_fn(data), T.LONG), None
        return data, None


class Floor(_FloorCeil):
    round_fn = staticmethod(torch.floor)


class Ceil(_FloorCeil):
    round_fn = staticmethod(torch.ceil)


class Pow(BinaryExpression):
    """``pow(a, b)`` in doubles, as ``Math.pow``."""

    @property
    def data_type(self) -> T.DataType:
        return T.DOUBLE

    def do_device(self, l, r):
        return torch.pow(l.to(torch.float64), r.to(torch.float64)), None


class Atan2(BinaryExpression):
    """``atan2(y, x)`` in doubles, as ``Math.atan2``."""

    @property
    def data_type(self) -> T.DataType:
        return T.DOUBLE

    def do_device(self, l, r):
        return torch.atan2(l.to(torch.float64), r.to(torch.float64)), None
