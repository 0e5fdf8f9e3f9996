"""Conditional expressions — port of ``spark_rapids_tpu/ops/conditional.py``,
cut to ``If`` over fixed-width branches (numbers, dates, bools), the form
TPC-H Q12 and Q14 take. A string branch raises: the reference builds it
through the char matrix, and the port moves strings by their layout.
``CaseWhen`` and ``Coalesce`` are not ported yet.
"""

from __future__ import annotations

import torch

from .. import types as T
from ..data.batch import ColumnarBatch
from ..data.column import DeviceColumn
from .expression import Expression, make_column


class If(Expression):
    """``IF(predicate, true_value, false_value)``: SQL's three-valued
    logic sends a null predicate to the false branch. The result has the
    true branch's type, as in the reference."""

    def __init__(self, predicate: Expression, true_value: Expression,
                 false_value: Expression):
        self.children = [predicate, true_value, false_value]

    @property
    def data_type(self) -> T.DataType:
        return self.children[1].data_type

    def with_children(self, children):
        return If(*children)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        p, t, f = (c.eval_device(batch) for c in self.children)
        if t.is_string or f.is_string:
            raise NotImplementedError(
                "IF with string branches is not ported yet")
        take_true = p.data & p.validity
        data = torch.where(take_true, t.data, f.data)
        validity = torch.where(take_true, t.validity, f.validity)
        return make_column(data, validity, self.data_type)
