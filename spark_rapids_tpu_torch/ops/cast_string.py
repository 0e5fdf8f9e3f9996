"""String <-> number, date, timestamp and boolean casts — port of
``spark_rapids_tpu/ops/cast_string.py``.

Spark's non-ANSI rules, as the reference: text is trimmed of ASCII
whitespace (space, tab, newline, carriage return), invalid text gives
null, and an integral value out of the target's range gives null.
Parsers read an int16 char matrix only as wide as the longest row they
are handed (:func:`.strings_util.rows_matrix`: a dictionary column's
entries once, then a gather by code; a flat column's own rows), never
the column's ``max_bytes``. Formatters write at most 26 bytes a row
(20 for a long), packed back into a flat column.

The timestamp patterns of ``unix_timestamp`` / ``from_unixtime``
(:func:`compile_ts_pattern`) are the reference's fixed-width subset.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .datetime import _civil_from_days, _days_from_civil, _fdiv
from .strings_util import PAD

_I64_MAX_DIGITS = [int(c) for c in "9223372036854775807"]
_I64_MIN_DIGITS = [int(c) for c in "9223372036854775808"]
_US_PER_DAY = 86_400_000_000


def _col(m: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``m[i, pos[i]]`` with ``pos`` clamped into the row."""
    return m.gather(1, pos.long().clamp(0, m.shape[1] - 1)[:, None])[:, 0]


def _digit(m: torch.Tensor, j: int):
    c = m[:, j]
    return (c >= 48) & (c <= 57), (c - 48).to(torch.int64)


def _trimmed(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Leading and trailing ASCII whitespace dropped, the rest shifted to
    column 0: (matrix, lengths)."""
    ws = (m == 32) | (m == 9) | (m == 10) | (m == 13)
    content = (m != PAD) & ~ws
    n, w = m.shape
    idx = torch.arange(w, device=m.device)[None, :]
    first = torch.where(content, idx, w).amin(1)
    last = torch.where(content, idx, -1).amax(1)
    shifted = m.gather(1, (idx + first[:, None]).clamp(0, w - 1))
    new_len = (last - first + 1).clamp(min=0)
    keep = idx < new_len[:, None]
    return torch.where(keep, shifted, PAD), new_len.to(torch.int32)


def parse_long_matrix(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64 values, valid) of ``[+|-]digits`` rows. Overflow is decided
    exactly: up to 18 significant digits always fit, 19 compare digit by
    digit with the int64 bound of their sign, more overflow."""
    m, ln = _trimmed(m)
    n, w = m.shape
    dev = m.device
    neg = m[:, 0] == 45
    plus = m[:, 0] == 43
    start = (neg | plus).to(torch.int32)
    acc = torch.zeros(n, dtype=torch.int64, device=dev)
    all_digits = torch.ones(n, dtype=torch.bool, device=dev)
    for j in range(w):
        in_num = (j >= start) & (j < ln)
        is_d, d = _digit(m, j)
        all_digits = all_digits & (~in_num | is_d)
        acc = torch.where(in_num & is_d, acc * 10 + d, acc)
    valid = (ln - start >= 1) & all_digits & (ln > 0)
    idx = torch.arange(w, device=dev)[None, :]
    in_num_m = (idx >= start[:, None]) & (idx < ln[:, None])
    fs = torch.where(in_num_m & (m != 48), idx, w).amin(1)
    sig = torch.where(fs < w, ln - fs, 1)
    decided = torch.zeros(n, dtype=torch.bool, device=dev)
    le19 = torch.ones(n, dtype=torch.bool, device=dev)
    for k in range(19):
        ck = _col(m, fs + k).to(torch.int32) - 48
        bk = torch.where(neg, _I64_MIN_DIGITS[k], _I64_MAX_DIGITS[k])
        lt = ~decided & (ck < bk)
        gt = ~decided & (ck > bk)
        le19 = le19 & ~gt
        decided = decided | lt | gt
    valid = valid & ((sig <= 18) | ((sig == 19) & le19))
    return torch.where(neg, -acc, acc), valid


def parse_double_matrix(m: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(float64 values, valid) of ``[sign] D* [. D*] [e|E [sign] D+]`` rows
    with at least one mantissa digit (no ``Infinity`` or ``NaN`` words),
    accumulated digit by digit as the reference does."""
    m, ln = _trimmed(m)
    n, w = m.shape
    dev = m.device
    neg = m[:, 0] == 45
    plus = m[:, 0] == 43
    start = (neg | plus).to(torch.int32)
    idx = torch.arange(w, device=dev)[None, :]
    in_row = idx < ln[:, None]
    is_dot = (m == 46) & in_row
    is_e = ((m == 101) | (m == 69)) & in_row
    dot_pos = torch.where(is_dot, idx, w).amin(1)
    e_pos = torch.where(is_e, idx, w).amin(1)
    n_dots = is_dot.sum(1)
    n_es = is_e.sum(1)
    ok = (n_dots <= 1) & (n_es <= 1) & ((n_dots == 0) | (dot_pos < e_pos))
    has_e = e_pos < w
    e_sign_c = _col(m, e_pos + 1)
    e_neg = has_e & (e_sign_c == 45)
    e_plus = has_e & (e_sign_c == 43)
    exp_start = e_pos + 1 + (e_neg | e_plus).to(torch.int64)
    mant = torch.zeros(n, dtype=torch.float64, device=dev)
    frac_scale = torch.ones(n, dtype=torch.float64, device=dev)
    mant_digits = torch.zeros(n, dtype=torch.int32, device=dev)
    exp_acc = torch.zeros(n, dtype=torch.int64, device=dev)
    exp_digits = torch.zeros(n, dtype=torch.int32, device=dev)
    for j in range(w):
        in_num = (j >= start) & (j < ln)
        is_d, d = _digit(m, j)
        df = d.to(torch.float64)
        in_int = in_num & (j < dot_pos) & (j < e_pos)
        in_frac = in_num & (j > dot_pos) & (j < e_pos)
        in_exp = in_num & (j >= exp_start) & has_e
        mant = torch.where(in_int & is_d, mant * 10 + df, mant)
        frac_scale = torch.where(in_frac & is_d, frac_scale * 10, frac_scale)
        mant = torch.where(in_frac & is_d, mant + df / frac_scale, mant)
        mant_digits = mant_digits + ((in_int | in_frac) & is_d).int()
        exp_acc = torch.where(in_exp & is_d, exp_acc * 10 + d, exp_acc)
        exp_digits = exp_digits + (in_exp & is_d).int()
        legal = is_d | (dot_pos == j) | (e_pos == j) \
            | ((e_pos + 1 == j) & (e_neg | e_plus))
        ok = ok & (~in_num | legal)
    valid = ok & (mant_digits >= 1) & (~has_e | (exp_digits >= 1)) & (ln > 0)
    exp = torch.where(e_neg, -exp_acc, exp_acc).clamp(-400, 400)
    # 10^|exp| is exact up to 10^22, so a negative exponent divides by it
    # (one rounding, as the reference's power gives) instead of
    # multiplying by a rounded 10^exp
    scale = torch.pow(10.0, exp.abs().to(torch.float64))
    signed = torch.where(neg, -mant, mant)
    return torch.where(exp < 0, signed / scale, signed * scale), valid


def format_long_matrix(v: torch.Tensor) -> torch.Tensor:
    """int64 -> ``[N, 20]`` char matrix, left-aligned, PAD past the end
    (``-9223372036854775808`` written whole)."""
    n = v.shape[0]
    w = 20
    dev = v.device
    neg = v < 0
    # |v| digit by digit from the negative side, which holds INT64_MIN
    rest = torch.where(neg, v, -v)
    digits = []
    for _ in range(w - 1):
        q = torch.div(rest, 10, rounding_mode="trunc")
        digits.append((10 * q - rest).to(torch.int16))
        rest = q
    dm = torch.stack(digits[::-1], dim=1)
    idx = torch.arange(w - 1, device=dev)[None, :]
    first_nz = torch.where(dm != 0, idx, w - 1).amin(1).clamp(max=w - 2)
    ndig = (w - 1) - first_nz
    chars = dm + 48
    total = ndig + neg.to(torch.int64)
    out_idx = torch.arange(w, device=dev)[None, :]
    src = out_idx - neg.to(torch.int64)[:, None] + first_nz[:, None]
    src_c = chars.gather(1, src.clamp(0, w - 2))
    out = torch.where((out_idx == 0) & neg[:, None],
                      torch.full((), 45, dtype=torch.int16, device=dev),
                      src_c)
    return torch.where(out_idx < total[:, None], out, PAD)


def _dig(x: torch.Tensor, p: int) -> torch.Tensor:
    return (torch.remainder(_fdiv(x, p), 10) + 48).to(torch.int16)


def _lit(n: int, ch: str, dev) -> torch.Tensor:
    return torch.full((n,), ord(ch), dtype=torch.int16, device=dev)


def format_date_matrix(days: torch.Tensor) -> torch.Tensor:
    """date -> ``yyyy-MM-dd``, ``[N, 10]``."""
    y, mo, d = _civil_from_days(days.to(torch.int64))
    n, dev = days.shape[0], days.device
    return torch.stack([_dig(y, 1000), _dig(y, 100), _dig(y, 10),
                        _dig(y, 1), _lit(n, "-", dev), _dig(mo, 10),
                        _dig(mo, 1), _lit(n, "-", dev), _dig(d, 10),
                        _dig(d, 1)], dim=1)


def _parse_int_run(m: torch.Tensor, start: torch.Tensor, max_digits: int):
    """Up to ``max_digits`` digits from each row's ``start``: (value,
    digits read, next position)."""
    n, w = m.shape
    acc = torch.zeros(n, dtype=torch.int64, device=m.device)
    cnt = torch.zeros(n, dtype=torch.int64, device=m.device)
    for k in range(max_digits):
        c = _col(m, start + k)
        is_d = (c >= 48) & (c <= 57) & (start + k < w) & (cnt == k)
        acc = torch.where(is_d, acc * 10 + (c - 48).to(torch.int64), acc)
        cnt = torch.where(is_d, cnt + 1, cnt)
    return acc, cnt, start + cnt


def _expect_char(m: torch.Tensor, pos: torch.Tensor, ch: str):
    return _col(m, pos) == ord(ch)


_DAYS_IN_MONTH = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]


def _parse_ymd(m: torch.Tensor, ln: torch.Tensor):
    n = m.shape[0]
    y, yd, p = _parse_int_run(m, torch.zeros(n, dtype=torch.int64,
                                             device=m.device), 4)
    ok = (yd == 4) & _expect_char(m, p, "-")
    mo, md, p2 = _parse_int_run(m, p + 1, 2)
    ok = ok & (md >= 1) & _expect_char(m, p2, "-")
    d, dd, p3 = _parse_int_run(m, p2 + 1, 2)
    ok = ok & (dd >= 1) & (mo >= 1) & (mo <= 12) & (d >= 1)
    dim = torch.tensor(_DAYS_IN_MONTH, dtype=torch.int64, device=m.device)
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    max_d = dim[(mo - 1).clamp(0, 11)] + (leap & (mo == 2)).to(torch.int64)
    return y, mo, d, p3, ok & (d <= max_d)


def parse_date_matrix(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``yyyy-MM-dd`` / ``yyyy-M-d`` -> (int32 days, valid)."""
    m, ln = _trimmed(m)
    y, mo, d, end, ok = _parse_ymd(m, ln)
    return _days_from_civil(y, mo, d).to(torch.int32), ok & (end == ln)


def parse_timestamp_matrix(m: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``yyyy-MM-dd[( |T)HH[:mm[:ss[.f{1..6}]]]]`` -> (int64 micros,
    valid)."""
    m, ln = _trimmed(m)
    y, mo, d, p, ok = _parse_ymd(m, ln)
    days = _days_from_civil(y, mo, d)
    date_only = ok & (p == ln)
    sep_ok = _expect_char(m, p, " ") | _expect_char(m, p, "T")
    hh, hd, p1 = _parse_int_run(m, p + 1, 2)
    ok_h = ok & sep_ok & (hd >= 1) & (hh < 24)
    hour_only = ok_h & (p1 == ln)
    mi, mid, p2 = _parse_int_run(m, p1 + 1, 2)
    ok_m = ok_h & _expect_char(m, p1, ":") & (mid >= 1) & (mi < 60)
    min_only = ok_m & (p2 == ln)
    ss, sd, p3 = _parse_int_run(m, p2 + 1, 2)
    ok_s = ok_m & _expect_char(m, p2, ":") & (sd >= 1) & (ss < 60)
    has_frac = _expect_char(m, p3, ".")
    fr, fd, p4 = _parse_int_run(m, p3 + 1, 6)
    scale = torch.pow(10.0, (6 - fd).to(torch.float64)).to(torch.int64)
    micros_frac = torch.where(has_frac, fr * scale, 0)
    end = torch.where(has_frac, p4, p3)
    full_ok = ok_s & (end == ln) & (~has_frac | (fd >= 1))
    mi = torch.where(ok_m, mi, 0)
    ss = torch.where(ok_s, ss, 0)
    micros = days * _US_PER_DAY + hh * 3_600_000_000 + mi * 60_000_000 \
        + ss * 1_000_000 + torch.where(full_ok, micros_frac, 0)
    valid = date_only | hour_only | min_only | full_ok
    return torch.where(date_only, days * _US_PER_DAY, micros), valid


def _trailing_zeros6(frac: torch.Tensor) -> torch.Tensor:
    tz = torch.zeros_like(frac)
    rest = frac
    done = frac == 0
    for _ in range(6):
        is_z = (rest % 10 == 0) & ~done
        tz = tz + is_z.to(frac.dtype)
        done = done | ~is_z
        rest = torch.where(is_z, rest // 10, rest)
    return tz


def format_timestamp_matrix(us: torch.Tensor) -> torch.Tensor:
    """micros -> ``yyyy-MM-dd HH:mm:ss[.ffffff]`` with the fraction's
    trailing zeros dropped (none when it is 0), ``[N, 26]``."""
    us = us.to(torch.int64)
    n, dev = us.shape[0], us.device
    days = _fdiv(us, _US_PER_DAY)
    rem = us - days * _US_PER_DAY
    y, mo, d = _civil_from_days(days)
    hh = rem // 3_600_000_000
    mi = (rem // 60_000_000) % 60
    ss = (rem // 1_000_000) % 60
    frac = rem % 1_000_000
    m = torch.stack([
        _dig(y, 1000), _dig(y, 100), _dig(y, 10), _dig(y, 1),
        _lit(n, "-", dev), _dig(mo, 10), _dig(mo, 1), _lit(n, "-", dev),
        _dig(d, 10), _dig(d, 1), _lit(n, " ", dev), _dig(hh, 10),
        _dig(hh, 1), _lit(n, ":", dev), _dig(mi, 10), _dig(mi, 1),
        _lit(n, ":", dev), _dig(ss, 10), _dig(ss, 1), _lit(n, ".", dev),
        _dig(frac, 100000), _dig(frac, 10000), _dig(frac, 1000),
        _dig(frac, 100), _dig(frac, 10), _dig(frac, 1)], dim=1)
    idx = torch.arange(26, device=dev)[None, :]
    total = torch.where(frac == 0, 19, 26 - _trailing_zeros6(frac))
    return torch.where(idx < total[:, None], m, PAD)


_TRUE_WORDS = ("true", "t", "yes", "y", "1")
_FALSE_WORDS = ("false", "f", "no", "n", "0")


def parse_bool_matrix(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spark's boolean words, any case: (value, valid)."""
    m, _ = _trimmed(m)
    lower = torch.where((m >= 65) & (m <= 90), m + 32, m)
    n, w = m.shape

    def word_eq(word: str) -> torch.Tensor:
        if len(word) > w:
            return torch.zeros(n, dtype=torch.bool, device=m.device)
        row = torch.full((w,), PAD, dtype=torch.int16, device=m.device)
        row[:len(word)] = torch.tensor([ord(c) for c in word],
                                       dtype=torch.int16, device=m.device)
        return (lower == row[None, :]).all(1)
    is_true = torch.zeros(n, dtype=torch.bool, device=m.device)
    is_false = torch.zeros(n, dtype=torch.bool, device=m.device)
    for wd in _TRUE_WORDS:
        is_true = is_true | word_eq(wd)
    for wd in _FALSE_WORDS:
        is_false = is_false | word_eq(wd)
    return is_true, is_true | is_false


# --------------------------------------------------------------------------
# Fixed-width timestamp patterns
# --------------------------------------------------------------------------

#: Java pattern token -> (field width, strftime directive)
_TS_TOKENS = [("yyyy", 4, "%Y"), ("MM", 2, "%m"), ("dd", 2, "%d"),
              ("HH", 2, "%H"), ("mm", 2, "%M"), ("ss", 2, "%S")]


def compile_ts_pattern(fmt: str):
    """``(fields, length, strftime format)`` of a fixed-width Java time
    pattern, or None outside the subset: the ``yyyy``, ``MM``, ``dd``,
    ``HH``, ``mm`` and ``ss`` tokens, each at most once, year, month and
    day required, joined by single non-letter characters. A field is
    ``(token, position, width)`` or ``("lit", position, char)``."""
    fields, i, strf = [], 0, []
    seen = set()
    while i < len(fmt):
        for tok, width, directive in _TS_TOKENS:
            if fmt.startswith(tok, i):
                if tok in seen:
                    return None
                seen.add(tok)
                fields.append((tok, i, width))
                strf.append(directive)
                i += width
                break
        else:
            ch = fmt[i]
            if ch.isalpha():
                return None
            fields.append(("lit", i, ch))
            strf.append(ch)
            i += 1
    if not {"yyyy", "MM", "dd"} <= seen:
        return None
    return fields, len(fmt), "".join(strf)


def parse_timestamp_pattern(m: torch.Tensor, fmt: str
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Strict parse of a :func:`compile_ts_pattern` pattern -> (micros,
    valid): every field exactly its width in digits, every literal in
    place, the trimmed length the pattern's, and a real calendar day."""
    fields, total, _ = compile_ts_pattern(fmt)
    m, ln = _trimmed(m)
    n, dev = m.shape[0], m.device
    ok = ln == total
    vals = {"HH": 0, "mm": 0, "ss": 0}
    for tok, pos, width in fields:
        at = torch.full((n,), pos, dtype=torch.int64, device=dev)
        if tok == "lit":
            ok = ok & _expect_char(m, at, width)
            continue
        v, nd, _ = _parse_int_run(m, at, width)
        ok = ok & (nd == width)
        vals[tok] = v
    y, mo, d = vals["yyyy"], vals["MM"], vals["dd"]
    days = _days_from_civil(y, mo, d)
    y2, m2, d2 = _civil_from_days(days)
    ok = ok & (y2 == y) & (m2 == mo) & (d2 == d)
    for tok, hi in (("HH", 24), ("mm", 60), ("ss", 60)):
        if not isinstance(vals[tok], int):
            ok = ok & (vals[tok] >= 0) & (vals[tok] < hi)
    micros = days * _US_PER_DAY + vals["HH"] * 3_600_000_000 \
        + vals["mm"] * 60_000_000 + vals["ss"] * 1_000_000
    return torch.where(ok, micros, 0), ok


def format_timestamp_pattern(us: torch.Tensor, fmt: str) -> torch.Tensor:
    """micros -> a :func:`compile_ts_pattern` pattern, ``[N, len(fmt)]``."""
    fields, total, _ = compile_ts_pattern(fmt)
    us = us.to(torch.int64)
    n, dev = us.shape[0], us.device
    days = _fdiv(us, _US_PER_DAY)
    rem = us - days * _US_PER_DAY
    y, mo, d = _civil_from_days(days)
    parts = {"yyyy": y, "MM": mo, "dd": d, "HH": rem // 3_600_000_000,
             "mm": (rem // 60_000_000) % 60, "ss": (rem // 1_000_000) % 60}
    cols = [None] * total
    for tok, pos, width in fields:
        if tok == "lit":
            cols[pos] = _lit(n, width, dev)
            continue
        for k in range(width):
            cols[pos + k] = _dig(parts[tok], 10 ** (width - 1 - k))
    return torch.stack(cols, dim=1)
