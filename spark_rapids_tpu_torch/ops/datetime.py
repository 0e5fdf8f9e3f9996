"""Datetime expressions — port of ``spark_rapids_tpu/ops/datetime.py``:
``Year``, ``Month``, ``DayOfMonth``, ``Quarter``, ``DayOfYear``,
``DayOfWeek``, ``WeekDay``, ``Hour``, ``Minute``, ``Second``,
``LastDay``, ``DateAdd``, ``DateSub``, ``DateDiff``, ``UnixTimestamp``
and ``FromUnixTime``.

Dates are int32 days since 1970-01-01, timestamps int64 microseconds
(UTC), both on the proleptic Gregorian calendar. The civil date of a day
number comes from Howard Hinnant's days-from-civil algorithms in int64
arithmetic; every division floors (``torch.div(..., rounding_mode=
"floor")``), so days before the epoch and years before 0 come out as
the reference's ``floor_divide`` gives them.
"""

from __future__ import annotations

import torch

from .. import types as T
from .expression import (BinaryExpression, Expression, UnaryExpression,
                         make_column)

_US_PER_DAY = 86_400_000_000


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _civil_from_days(z: torch.Tensor):
    """Days since the epoch (int64) -> (year, month, day)."""
    z = z + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(y.dtype)
    return y, m, d


def _days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor):
    """(year, month, day) -> days since the epoch (int64)."""
    y = y - (m <= 2).to(y.dtype)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = m + torch.where(m > 2, -3, 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _days_of(data: torch.Tensor, dtype: T.DataType) -> torch.Tensor:
    """Day numbers (int64) of a DATE or TIMESTAMP lane."""
    if dtype is T.DATE:
        return data.to(torch.int64)
    return _fdiv(data.to(torch.int64), _US_PER_DAY)


class DatePart(UnaryExpression):
    """An extract-style function of a date or timestamp: an INT."""

    @property
    def data_type(self) -> T.DataType:
        return T.INT

    def do_device(self, data):
        return self.part(data), None

    def civil(self, data):
        return _civil_from_days(_days_of(data, self.child.data_type))

    def part(self, data: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class Year(DatePart):
    def part(self, data):
        return self.civil(data)[0]


class Month(DatePart):
    def part(self, data):
        return self.civil(data)[1]


class DayOfMonth(DatePart):
    def part(self, data):
        return self.civil(data)[2]


class Quarter(DatePart):
    def part(self, data):
        return _fdiv(self.civil(data)[1] - 1, 3) + 1


class DayOfYear(DatePart):
    def part(self, data):
        days = _days_of(data, self.child.data_type)
        y, m, _ = _civil_from_days(days)
        one = torch.ones_like(m)
        return days - _days_from_civil(y, one, one) + 1


class DayOfWeek(DatePart):
    """Spark ``dayofweek``: 1 = Sunday ... 7 = Saturday (1970-01-01 was a
    Thursday)."""

    def part(self, data):
        return torch.remainder(_days_of(data, self.child.data_type) + 4,
                               7) + 1


class WeekDay(DatePart):
    """Spark ``weekday``: 0 = Monday ... 6 = Sunday."""

    def part(self, data):
        return torch.remainder(_days_of(data, self.child.data_type) + 3, 7)


class Hour(DatePart):
    def part(self, data):
        return _fdiv(torch.remainder(data.to(torch.int64), _US_PER_DAY),
                     3_600_000_000)


class Minute(DatePart):
    def part(self, data):
        us = torch.remainder(data.to(torch.int64), _US_PER_DAY)
        return torch.remainder(_fdiv(us, 60_000_000), 60)


class Second(DatePart):
    def part(self, data):
        us = torch.remainder(data.to(torch.int64), _US_PER_DAY)
        return torch.remainder(_fdiv(us, 1_000_000), 60)


class LastDay(UnaryExpression):
    """The last day of the input date's month: a DATE."""

    @property
    def data_type(self) -> T.DataType:
        return T.DATE

    def do_device(self, data):
        y, m, _ = _civil_from_days(_days_of(data, self.child.data_type))
        december = m == 12
        first_next = _days_from_civil(torch.where(december, y + 1, y),
                                      torch.where(december, 1, m + 1),
                                      torch.ones_like(m))
        return first_next - 1, None


class DateAdd(BinaryExpression):
    """``date_add(date, n_days)``: a DATE (int32 arithmetic wraps)."""

    @property
    def data_type(self) -> T.DataType:
        return T.DATE

    def do_device(self, l, r):
        return (l.to(torch.int64) + r.to(torch.int64)).to(torch.int32), None


class DateSub(BinaryExpression):
    """``date_sub(date, n_days)``: a DATE."""

    @property
    def data_type(self) -> T.DataType:
        return T.DATE

    def do_device(self, l, r):
        return (l.to(torch.int64) - r.to(torch.int64)).to(torch.int32), None


class DateDiff(BinaryExpression):
    """``datediff(end, start)`` in days: an INT."""

    @property
    def data_type(self) -> T.DataType:
        return T.INT

    def do_device(self, l, r):
        return (l.to(torch.int64) - r.to(torch.int64)).to(torch.int32), None


_DEFAULT_TS_FMT = "yyyy-MM-dd HH:mm:ss"


def _supported_format(fmt: str) -> bool:
    from .cast_string import compile_ts_pattern
    return fmt == _DEFAULT_TS_FMT or compile_ts_pattern(fmt) is not None


class UnixTimestamp(Expression):
    """``unix_timestamp(col[, fmt])``: seconds since the epoch, a BIGINT
    (floor of a timestamp's micros; a date's midnight). A string parses
    with the default pattern as a cast to timestamp does, or with a
    fixed-width pattern (``cast_string.compile_ts_pattern``); any other
    pattern raises ``NotImplementedError``, where the reference falls
    back to its CPU path."""

    def __init__(self, child: Expression, fmt: str = _DEFAULT_TS_FMT):
        self.children = [child]
        self.fmt = fmt

    @property
    def data_type(self) -> T.DataType:
        return T.LONG

    def with_children(self, children):
        return UnixTimestamp(children[0], self.fmt)

    def eval_device(self, batch):
        from . import cast_string as CS
        from .strings_util import lift_rows
        src = self.children[0].data_type
        c = self.children[0].eval_device(batch)
        if src is T.TIMESTAMP:
            return make_column(_fdiv(c.data, 1_000_000), c.validity, T.LONG)
        if src is T.DATE:
            return make_column(c.data.to(torch.int64) * 86400, c.validity,
                               T.LONG)
        if not _supported_format(self.fmt):
            raise NotImplementedError(
                f"unix_timestamp pattern {self.fmt!r} runs only on the "
                "reference's CPU path")
        if self.fmt == _DEFAULT_TS_FMT:
            parse = CS.parse_timestamp_matrix
        else:
            def parse(m):
                return CS.parse_timestamp_pattern(m, self.fmt)
        us, ok = lift_rows(c, parse)
        validity = c.validity & ok
        return make_column(_fdiv(us, 1_000_000), validity, T.LONG)


class FromUnixTime(Expression):
    """``from_unixtime(seconds[, fmt])``: the UTC time as text, in the
    default pattern or a fixed-width one (any other raises
    ``NotImplementedError``)."""

    def __init__(self, child: Expression, fmt: str = _DEFAULT_TS_FMT):
        self.children = [child]
        self.fmt = fmt

    @property
    def data_type(self) -> T.DataType:
        return T.STRING

    def with_children(self, children):
        return FromUnixTime(children[0], self.fmt)

    def eval_device(self, batch):
        from ..data.column import string_max_bytes
        from . import cast_string as CS
        from .kernels.rowops import strings_from_matrix
        from .strings_util import PAD
        if not _supported_format(self.fmt):
            raise NotImplementedError(
                f"from_unixtime pattern {self.fmt!r} runs only on the "
                "reference's CPU path")
        c = self.children[0].eval_device(batch)
        us = c.data.to(torch.int64) * 1_000_000
        if self.fmt == _DEFAULT_TS_FMT:
            m = CS.format_timestamp_matrix(us)
        else:
            m = CS.format_timestamp_pattern(us, self.fmt)
        m = torch.where(c.validity[:, None], m, PAD)
        return strings_from_matrix(m, c.validity, string_max_bytes(
            m.shape[1]))
