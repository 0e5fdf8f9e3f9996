"""Math expressions — port of ``spark_rapids_tpu/ops/math.py``, cut to the
``MathUnary`` base and ``Exp``, the one function the bench suite's
``xbb_score`` calls. Spark's math functions take doubles and give
doubles; a null input gives null, and a domain error gives NaN or an
infinity, as ``java.lang.Math`` does. The other unary functions of the
reference (trig, logs, roots, rounding) are not ported yet.
"""

from __future__ import annotations

import torch

from .. import types as T
from .expression import UnaryExpression


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


Exp = _unary("Exp", torch.exp)
