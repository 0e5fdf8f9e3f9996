"""String expressions — port of ``spark_rapids_tpu/ops/strings.py``, cut
to ``Substring`` with literal position and length, the form TPC-H Q22's
country code takes. Byte semantics, as the reference's device path.
"""

from __future__ import annotations

import torch

from .. import types as T
from ..data.batch import ColumnarBatch
from ..data.column import DeviceColumn, string_max_bytes
from .expression import Expression, Literal
from .kernels.rowops import strings_from_matrix
from .strings_util import PAD, char_matrix, lengths


class Substring(Expression):
    """substring(str, pos, len): Spark's 1-based position, 0 acts as 1, a
    negative position counts from the end; the result is a flat string
    column whatever the input's layout."""

    def __init__(self, child: Expression, pos: Expression,
                 length: Expression):
        if not (isinstance(pos, Literal) and isinstance(length, Literal)):
            raise NotImplementedError("substring takes literal pos and len")
        self.children = [child, pos, length]

    @property
    def data_type(self) -> T.DataType:
        return T.STRING

    def with_children(self, children):
        return Substring(*children)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        c = self.children[0].eval_device(batch)
        pos = self.children[1].value
        ln = max(self.children[2].value, 0)
        m = char_matrix(c)
        n, w = m.shape
        slen = lengths(c)
        if pos > 0:
            start = torch.full((n,), pos - 1, dtype=torch.int32,
                               device=m.device)
        elif pos == 0:
            start = torch.zeros(n, dtype=torch.int32, device=m.device)
        else:
            start = torch.clamp(slen + pos, min=0)
        out_w = max(min(ln, w) if ln else 1, 1)
        cols_idx = start[:, None] + torch.arange(
            out_w, dtype=torch.int32, device=m.device)[None, :]
        in_range = cols_idx < torch.minimum(start + ln, slen)[:, None]
        gathered = torch.gather(m, 1, cols_idx.clamp(0, w - 1).long())
        out_m = torch.where(in_range, gathered, PAD)
        return strings_from_matrix(out_m, c.validity,
                                   string_max_bytes(out_w))
