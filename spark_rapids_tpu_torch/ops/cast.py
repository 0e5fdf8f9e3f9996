"""Cast — port of ``spark_rapids_tpu/ops/cast.py`` for every pair of
non-string types, with Spark's non-ANSI (Java) conversions:

* integral to a narrower integral: two's-complement truncation (wraps);
* float or double to integral: truncation toward zero, NaN to 0, and
  anything at or past the type's bounds clamped to MIN/MAX (JLS 5.1.3),
  the bounds compared in float64 as the reference does;
* number to boolean: ``x != 0``; boolean to number: 1 or 0;
* date to timestamp: midnight UTC; timestamp to date: floor to the day.

A cast from or to a string is the reference's ``cast_string.py`` (queue
A4 of ``ROADMAP.md``) and raises here.
"""

from __future__ import annotations

import torch

from .. import types as T
from .expression import Expression, UnaryExpression

#: (MIN, MAX) of each integral type, by type name.
INT_BOUNDS = {
    "tinyint": (-(2 ** 7), 2 ** 7 - 1),
    "smallint": (-(2 ** 15), 2 ** 15 - 1),
    "int": (-(2 ** 31), 2 ** 31 - 1),
    "bigint": (-(2 ** 63), 2 ** 63 - 1),
}

_US_PER_DAY = 86_400_000_000


def float_to_integral(data: torch.Tensor, to: T.DataType) -> torch.Tensor:
    """Java's float-to-integral conversion: truncate, NaN to 0, clamp.
    ``MAX`` of a LONG rounds up to 2^63 in float64, so values at or above
    it take the clamp and the conversion itself only sees values in
    range."""
    lo, hi = INT_BOUNDS[to.name]
    t = torch.trunc(data.to(torch.float64))
    nan = torch.isnan(t)
    over = ~nan & (t >= float(hi))
    under = ~nan & (t <= float(lo))
    safe = torch.where(nan | over | under, torch.zeros_like(t), t)
    out = safe.to(to.torch_dtype)
    out = torch.where(over, torch.full_like(out, hi), out)
    return torch.where(under, torch.full_like(out, lo), out)


def cast_values(data: torch.Tensor, src: T.DataType,
                to: T.DataType) -> torch.Tensor:
    """The values of a non-string ``src`` lane cast to ``to`` (the
    reference's ``_jnp_cast``)."""
    if src.name == to.name:
        return data
    if to is T.BOOLEAN:
        return data != 0
    if src is T.BOOLEAN:
        return data.to(to.torch_dtype)
    if src is T.DATE and to is T.TIMESTAMP:
        return data.to(torch.int64) * _US_PER_DAY
    if src is T.TIMESTAMP and to is T.DATE:
        return torch.div(data, _US_PER_DAY,
                         rounding_mode="floor").to(torch.int32)
    if src.is_floating and to.is_integral:
        return float_to_integral(data, to)
    return data.to(to.torch_dtype)


class Cast(UnaryExpression):
    """``CAST(child AS to)`` between non-string types; also the numeric
    coercion the analyzer inserts (:func:`.expression.coerce_binary`)."""

    def __init__(self, child: Expression, to: T.DataType):
        super().__init__(child)
        self.to = to

    @property
    def data_type(self) -> T.DataType:
        return self.to

    def with_children(self, children):
        return Cast(children[0], self.to)

    def eval_device(self, batch):
        src = self.child.data_type
        if (src is T.STRING) != (self.to is T.STRING):
            raise NotImplementedError(
                f"cast {src} -> {self.to}: string casts are the "
                "reference's cast_string.py, not ported yet (ROADMAP A4)")
        return super().eval_device(batch)

    def do_device(self, data):
        return cast_values(data, self.child.data_type, self.to), None

    def __str__(self) -> str:
        return f"cast({self.child} as {self.to})"
