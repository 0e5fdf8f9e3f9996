"""Conditional expressions — port of ``spark_rapids_tpu/ops/conditional.py``:
``If``, ``CaseWhen``, ``Coalesce`` and ``NaNvl``.

Fixed-width branches select lanes with ``torch.where``. String branches
keep the port's two layouts instead of the reference's char matrix:

* when every branch is a dictionary column (a string literal is a
  one-entry one), the dictionaries merge on the host into one sorted,
  unique dictionary (``merged_dictionary_codes``) and each row takes its
  branch's remapped code, so the result stays a sorted dictionary
  (Mortgage's score band groups on the dictionary path);
* otherwise the result is a flat column built from the chosen rows' own
  bytes (:func:`.strings_util.select_rows`), with no char matrix.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..data.batch import ColumnarBatch
from ..data.column import DeviceColumn, dictionary_column
from .expression import Expression, host_column, make_column
from .kernels.rowops import merged_dictionary_codes
from .strings_util import select_rows


def host_choose(pairs, choice: np.ndarray, dtype: T.DataType):
    """Row i of ``pairs[choice[i]]`` (host ``(values, validity)``; a
    choice of -1 gives null)."""
    n = len(choice)
    vals = np.empty(n, dtype=object)
    valid = np.zeros(n, dtype=bool)
    for k, (v, ok) in enumerate(pairs):
        pick = choice == k
        vals[pick] = np.asarray(v, dtype=object)[pick]
        valid[pick] = np.asarray(ok, dtype=bool)[pick]
    if dtype.np_dtype is not None and dtype.np_dtype != object:
        vals = np.where(valid, vals, 0)
    return host_column(vals, valid, dtype)


def choose_strings(cols: Sequence[DeviceColumn], choice: torch.Tensor,
                   validity: torch.Tensor) -> DeviceColumn:
    """Row i of ``cols[choice[i]]`` for every row (null where
    ``validity`` is false): one sorted dictionary when every column is a
    dictionary, else a flat column of the chosen rows' bytes."""
    if all(c.is_dict for c in cols):
        entries, codes_of = merged_dictionary_codes(cols)
        codes = torch.zeros_like(codes_of[0])
        for k, mine in enumerate(codes_of):
            codes = torch.where(choice == k, mine, codes)
        return dictionary_column(torch.where(validity, codes, 0), validity,
                                 entries, dict_sorted=True)
    return select_rows(cols, choice, validity)


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

    def eval_host(self, batch):
        (pv, pok), t, f = (c.eval_host(batch) for c in self.children)
        take_true = np.asarray(pv, bool) & pok
        return host_choose([t, f], np.where(take_true, 0, 1), self.data_type)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        p, t, f = (c.eval_device(batch) for c in self.children)
        take_true = p.data & p.validity
        validity = torch.where(take_true, t.validity, f.validity)
        if t.is_string or f.is_string:
            return choose_strings([f, t], take_true.long(), validity)
        data = torch.where(take_true, t.data, f.data)
        return make_column(data, validity, self.data_type)


class CaseWhen(Expression):
    """``CASE WHEN c1 THEN v1 ... [ELSE e] END``: each row takes the value
    of its first branch whose condition is true (a null condition is not
    true), else the ELSE value, else null. The result has the first
    branch value's type."""

    def __init__(self, branches: List[Tuple[Expression, Expression]],
                 else_value: Optional[Expression] = None):
        self.branches = list(branches)
        self.else_value = else_value
        flat: List[Expression] = []
        for c, v in self.branches:
            flat += [c, v]
        if else_value is not None:
            flat.append(else_value)
        self.children = flat

    @property
    def data_type(self) -> T.DataType:
        return self.branches[0][1].data_type

    def with_children(self, children):
        n = len(self.branches)
        branches = [(children[2 * i], children[2 * i + 1]) for i in range(n)]
        else_v = children[2 * n] if self.else_value is not None else None
        return CaseWhen(branches, else_v)

    def eval_host(self, batch):
        n = len(self.branches)
        choice = np.full(batch.num_rows, -1, dtype=np.int64)
        pairs = []
        for k, (c, v) in enumerate(self.branches):
            cv, cok = c.eval_host(batch)
            hit = (choice < 0) & np.asarray(cv, bool) & cok
            choice[hit] = k
            pairs.append(v.eval_host(batch))
        if self.else_value is not None:
            pairs.append(self.else_value.eval_host(batch))
            choice[choice < 0] = n
        return host_choose(pairs, choice, self.data_type)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        n = len(self.branches)
        conds = [c.eval_device(batch) for c, _ in self.branches]
        vals = [v.eval_device(batch) for _, v in self.branches]
        if self.else_value is not None:
            vals.append(self.else_value.eval_device(batch))
        # choice: the first true branch, else n (the ELSE value or null)
        choice = torch.full((batch.capacity,), n, dtype=torch.int64,
                            device=batch.device)
        for k in reversed(range(n)):
            choice = torch.where(conds[k].data & conds[k].validity, k,
                                 choice)
        validity = torch.zeros(batch.capacity, dtype=torch.bool,
                               device=batch.device)
        for k, v in enumerate(vals):
            validity = torch.where(choice == k, v.validity, validity)
        if self.data_type is T.STRING:
            return choose_strings(vals, choice, validity)
        data = torch.zeros(batch.capacity, dtype=self.data_type.torch_dtype,
                           device=batch.device)
        for k, v in enumerate(vals):
            data = torch.where(choice == k, v.data.to(data.dtype), data)
        return make_column(data, validity, self.data_type)


class Coalesce(Expression):
    """``COALESCE(a, b, ...)``: each row's first non-null argument, of the
    first argument's type."""

    def __init__(self, *children: Expression):
        self.children = list(children)

    @property
    def data_type(self) -> T.DataType:
        return self.children[0].data_type

    def with_children(self, children):
        return Coalesce(*children)

    def eval_host(self, batch):
        pairs = [c.eval_host(batch) for c in self.children]
        choice = np.full(batch.num_rows, -1, dtype=np.int64)
        for k, (_, ok) in enumerate(pairs):
            choice[(choice < 0) & ok] = k
        return host_choose(pairs, choice, self.data_type)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        cols = [c.eval_device(batch) for c in self.children]
        choice = torch.zeros(batch.capacity, dtype=torch.int64,
                             device=batch.device)
        validity = cols[0].validity
        for k, c in enumerate(cols[1:], 1):
            choice = torch.where(~validity & c.validity, k, choice)
            validity = validity | c.validity
        if self.data_type is T.STRING:
            return choose_strings(cols, choice, validity)
        data = cols[0].data
        for k, c in enumerate(cols[1:], 1):
            data = torch.where(choice == k, c.data.to(data.dtype), data)
        return make_column(data, validity, self.data_type)


class NaNvl(Expression):
    """``nanvl(a, b)``: ``b`` where ``a`` is NaN, else ``a``."""

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    @property
    def data_type(self) -> T.DataType:
        return self.children[0].data_type

    def with_children(self, children):
        return NaNvl(*children)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        l, r = (c.eval_device(batch) for c in self.children)
        if l.is_string or r.is_string:
            raise NotImplementedError("nanvl takes numbers, not strings")
        isnan = torch.isnan(l.data) & l.validity
        data = torch.where(isnan, r.data.to(l.data.dtype), l.data)
        validity = torch.where(isnan, r.validity, l.validity)
        return make_column(data, validity, self.data_type)

    def eval_host(self, batch):
        (lv, lok), (rv, rok) = (c.eval_host(batch) for c in self.children)
        isnan = np.isnan(np.asarray(lv, dtype=np.float64)) & lok
        return host_column(np.where(isnan, rv, lv),
                           np.where(isnan, rok, lok), self.data_type)
