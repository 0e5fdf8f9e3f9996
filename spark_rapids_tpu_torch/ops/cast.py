"""Cast — port of ``spark_rapids_tpu/ops/cast.py`` for every pair of
non-string types, with Spark's non-ANSI (Java) conversions:

* integral to a narrower integral: two's-complement truncation (wraps);
* float or double to integral: truncation toward zero, NaN to 0, and
  anything at or past the type's bounds clamped to MIN/MAX (JLS 5.1.3),
  the bounds compared in float64 as the reference does;
* number to boolean: ``x != 0``; boolean to number: 1 or 0;
* date to timestamp: midnight UTC; timestamp to date: floor to the day.

Casts from and to strings are the reference's (``cast.py:155-227`` with
``cast_string.py``): text parses into long, int, short, byte, double,
float, date, timestamp and boolean (invalid text and integral overflow
give null), and integers, dates, timestamps and booleans format into
text. A float formats only on the reference's CPU path, so float to
string raises here. A dictionary column parses its entries once and
gathers the answers by code.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import types as T
from ..data.column import dictionary_column, string_max_bytes
from . import cast_string as CS
from .expression import (Expression, UnaryExpression, fixed_width,
                         host_column, make_column)
from .kernels.rowops import strings_from_matrix
from .strings_util import PAD, lift_rows

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
        if src is T.STRING and self.to is T.STRING:
            return self.child.eval_device(batch)
        if src is T.STRING:
            return self._from_string(self.child.eval_device(batch))
        if self.to is T.STRING:
            return self._to_string(self.child.eval_device(batch), src)
        return super().eval_device(batch)

    def eval_host(self, batch):
        """A float's text is the reference's host text (``ops/cast.py:
        102 _host_to_string``: Python's ``str`` of the value as a double),
        which no device kernel gives; an integer's or a boolean's text and
        every cast between fixed-width types are numpy's; the string
        parsers and the date and timestamp formats run their device path
        over CPU tensors (the base class's host route)."""
        src = self.child.data_type
        if self.to is T.STRING and src.is_floating:
            v, ok = self.child.eval_host(batch)
            text = np.empty(len(ok), dtype=object)
            text[:] = [str(float(x)) if good else None
                       for x, good in zip(v, ok)]
            return text, np.asarray(ok, dtype=bool).copy()
        if self.to is T.STRING and (src.is_integral or src is T.BOOLEAN):
            v, ok = self.child.eval_host(batch)
            text = [("true" if x else "false") if src is T.BOOLEAN
                    else str(int(x)) for x in v]
            return host_column(text, ok, T.STRING)
        if fixed_width(src) and fixed_width(self.to):
            # the element kernel (cast_values) over the host values
            v, ok = self.child.eval_host(batch)
            data, _ = self.do_device(torch.from_numpy(np.ascontiguousarray(
                np.where(ok, v, np.zeros((), src.np_dtype)).astype(
                    src.np_dtype, copy=False))))
            return host_column(data.numpy(), ok, self.to)
        return super().eval_host(batch)

    def _from_string(self, c):
        parse = _PARSERS.get(self.to.name)
        if parse is None:
            raise NotImplementedError(f"cast string -> {self.to}")
        vals, ok = lift_rows(c, parse)
        to = self.to
        if to.is_integral and to is not T.LONG:
            # parsed at the target's width: out of range is null, not the
            # numeric cast's wrap
            lo, hi = INT_BOUNDS[to.name]
            ok = ok & (vals >= lo) & (vals <= hi)
        return make_column(vals.to(to.torch_dtype), c.validity & ok, to)

    def _to_string(self, c, src):
        if src is T.BOOLEAN:
            return dictionary_column(
                torch.where(c.validity, c.data.to(torch.int32), 0),
                c.validity, np.array(["false", "true"], dtype=object),
                dict_sorted=True)
        if src.is_integral:
            m = CS.format_long_matrix(c.data.to(torch.int64))
        elif src is T.DATE:
            m = CS.format_date_matrix(c.data)
        elif src is T.TIMESTAMP:
            m = CS.format_timestamp_matrix(c.data)
        else:
            raise NotImplementedError(
                f"cast {src} -> string runs only on the reference's CPU "
                "path (castFloatToString)")
        m = torch.where(c.validity[:, None], m, PAD)
        return strings_from_matrix(m, c.validity, string_max_bytes(
            m.shape[1]))

    def do_device(self, data):
        return cast_values(data, self.child.data_type, self.to), None

    def __str__(self) -> str:
        return f"cast({self.child} as {self.to})"


#: The parser of each target type (by name) of a cast from a string.
_PARSERS = {
    "bigint": CS.parse_long_matrix, "int": CS.parse_long_matrix,
    "smallint": CS.parse_long_matrix, "tinyint": CS.parse_long_matrix,
    "float": CS.parse_double_matrix, "double": CS.parse_double_matrix,
    "date": CS.parse_date_matrix, "timestamp": CS.parse_timestamp_matrix,
    "boolean": CS.parse_bool_matrix,
}
