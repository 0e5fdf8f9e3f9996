"""Conditional expressions — port of ``spark_rapids_tpu/ops/conditional.py``,
cut to ``If`` over fixed-width branches (numbers, dates, bools: TPC-H
Q12 and Q14) or dictionary string branches (TPCxBB q27, q28), and
``Coalesce`` over fixed-width or dictionary string branches (TPCxBB
q05). A flat string branch raises: the reference builds it through the
char matrix, and the port moves strings by their layout; it comes with
``CaseWhen`` (queue A4 of ``ROADMAP.md``).
"""

from __future__ import annotations

import torch

from .. import types as T
from ..data.batch import ColumnarBatch
from ..data.column import DeviceColumn, dictionary_column
from .expression import Expression, make_column
from .kernels.rowops import merged_dictionary_codes


class If(Expression):
    """``IF(predicate, true_value, false_value)``: SQL's three-valued
    logic sends a null predicate to the false branch. The result has the
    true branch's type, as in the reference. String branches must be
    dictionary columns (a string literal is a one-entry one): their
    dictionaries merge on the host into one sorted, unique dictionary,
    as ``Coalesce``'s do, and each row takes its branch's remapped
    code."""

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
        take_true = p.data & p.validity
        if t.is_string or f.is_string:
            if not (t.is_dict and f.is_dict):
                raise NotImplementedError(
                    "IF with a flat string branch is not ported yet "
                    "(with CaseWhen, ROADMAP A4)")
            entries, (ct, cf) = merged_dictionary_codes([t, f])
            codes = torch.where(take_true, ct, cf)
            validity = torch.where(take_true, t.validity, f.validity)
            return dictionary_column(torch.where(validity, codes, 0),
                                     validity, entries, dict_sorted=True)
        data = torch.where(take_true, t.data, f.data)
        validity = torch.where(take_true, t.validity, f.validity)
        return make_column(data, validity, self.data_type)


class Coalesce(Expression):
    """``COALESCE(a, b, ...)``: each row's first non-null argument, of the
    first argument's type. String arguments must all be dictionary
    columns: their dictionaries merge on the host into one sorted,
    unique dictionary and each argument's codes remap into it on the
    device; a flat string argument raises."""

    def __init__(self, *children: Expression):
        self.children = list(children)

    @property
    def data_type(self) -> T.DataType:
        return self.children[0].data_type

    def with_children(self, children):
        return Coalesce(*children)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        cols = [c.eval_device(batch) for c in self.children]
        if self.data_type is T.STRING:
            return _coalesce_dictionaries(cols)
        data = cols[0].data
        validity = cols[0].validity
        for c in cols[1:]:
            take_next = ~validity & c.validity
            data = torch.where(take_next, c.data.to(data.dtype), data)
            validity = validity | c.validity
        return make_column(data, validity, self.data_type)


def _coalesce_dictionaries(cols) -> DeviceColumn:
    if not all(c.is_dict for c in cols):
        raise NotImplementedError(
            "COALESCE over flat strings is not ported yet")
    entries, codes_of = merged_dictionary_codes(cols)
    codes, validity = codes_of[0], cols[0].validity
    for c, mine in zip(cols[1:], codes_of[1:]):
        take_next = ~validity & c.validity
        codes = torch.where(take_next, mine, codes)
        validity = validity | c.validity
    return dictionary_column(codes, validity, entries, dict_sorted=True)
