"""Complex-type expressions: arrays and structs — port of
``spark_rapids_tpu/ops/complex.py``.

``CreateArray``, ``GetArrayItem`` (a literal ordinal), ``Size``,
``ArrayContains``, ``CreateNamedStruct`` and ``GetStructField`` over the
reference's layouts (``data/column.py``): an array is a padded
``[capacity, max_len]`` element matrix with an element mask and a length
lane, a struct one child column per field. Every expression is a few
whole-column torch operations; nothing runs per row.

Null semantics are Spark 3.0's without ANSI mode, the reference's:

* ``arr[i]`` is null when the array is null, ``i`` is out of range or the
  element is null;
* ``size(null)`` is -1 (``spark.sql.legacy.sizeOfNull``);
* ``array_contains`` is null for a null array or value, and null rather
  than false when the value is absent but the array holds a null.
"""

from __future__ import annotations

import numpy as np

from typing import List, Optional, Sequence

import torch

from .. import types as T
from ..data.batch import ColumnarBatch
from ..data.column import DeviceColumn, array_column, null_column
from .expression import fixed_width, host_column
from .expression import Expression, Literal, lit, make_column


def _common_type(types: Sequence[T.DataType]) -> T.DataType:
    first = types[0]
    for t in types[1:]:
        if t.name != first.name:
            raise TypeError(
                f"array elements must share one type, got {first} and {t}")
    return first


class CreateArray(Expression):
    """``array(e1, e2, ...)``: one fixed-length array a row, never null
    itself (its elements may be)."""

    def __init__(self, *elements: Expression):
        if not elements:
            raise ValueError("array() needs at least one element")
        self.children = list(elements)

    @property
    def data_type(self) -> T.DataType:
        return T.ArrayType(_common_type([c.data_type for c in self.children]),
                           any(c.nullable for c in self.children))

    @property
    def nullable(self) -> bool:
        return False

    def with_children(self, children):
        return CreateArray(*children)

    def eval_host(self, batch):
        """One list a row of the elements' host values (``None`` for a
        null element), as the reference's host path builds it."""
        cols = [c.eval_host(batch) for c in self.children]
        rows = np.empty(batch.num_rows, dtype=object)
        rows[:] = [[v[i] if ok[i] else None for v, ok in cols]
                   for i in range(batch.num_rows)]
        return rows, np.ones(batch.num_rows, dtype=bool)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        cols = [c.eval_device(batch) for c in self.children]
        live = batch.row_mask()
        data = torch.stack([c.data for c in cols], dim=1)
        ev = torch.stack([c.validity for c in cols], dim=1)
        lengths = torch.full((batch.capacity,), len(cols), dtype=torch.int32,
                             device=live.device)
        return array_column(data, ev, lengths, live, self.data_type)


class GetArrayItem(Expression):
    """``arr[ordinal]`` with a literal ordinal (the reference's device
    rule takes literal ordinals only)."""

    def __init__(self, child: Expression, ordinal):
        if not isinstance(ordinal, Expression):
            ordinal = Literal(int(ordinal), T.INT)
        self.children = [child, ordinal]

    @property
    def ordinal(self) -> Optional[int]:
        o = self.children[1]
        return int(o.value) if isinstance(o, Literal) and o.value is not None \
            else None

    @property
    def data_type(self) -> T.DataType:
        return self.children[0].data_type.element_type

    @property
    def nullable(self) -> bool:
        return True

    def with_children(self, children):
        return GetArrayItem(children[0], children[1])

    def eval_host(self, batch):
        arr, ok = self.children[0].eval_host(batch)
        i = self.ordinal
        out = [None] * batch.num_rows
        if i is not None and i >= 0:
            out = [lst[i] if good and lst is not None and i < len(lst)
                   else None for lst, good in zip(arr, ok)]
        return host_column(
            [0 if x is None and fixed_width(self.data_type) else x
             for x in out],
            np.array([x is not None for x in out], dtype=bool),
            self.data_type)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        if not isinstance(self.children[1], Literal):
            raise NotImplementedError(
                "GetArrayItem with a non-literal ordinal runs on the host "
                "path (the reference's device rule takes literal ordinals "
                "only, complexTypeExtractors.scala)")
        arr = self.children[0].eval_device(batch)
        i = self.ordinal
        if i is None or i < 0 or i >= arr.max_len:
            return null_column(self.data_type, arr.capacity, arr.device)
        validity = arr.validity & (i < arr.lengths) & arr.elem_validity[:, i]
        return make_column(arr.data[:, i], validity, self.data_type)


class Size(Expression):
    """``size(arr)``: the int32 length; -1 for a null array."""

    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return T.INT

    @property
    def nullable(self) -> bool:
        return False

    def with_children(self, children):
        return Size(children[0])

    def eval_host(self, batch):
        arr, ok = self.children[0].eval_host(batch)
        n = np.array([len(lst) if good and lst is not None else -1
                      for lst, good in zip(arr, ok)], dtype=np.int32)
        return n, np.ones(batch.num_rows, dtype=bool)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        arr = self.children[0].eval_device(batch)
        data = torch.where(arr.validity, arr.lengths, -1)
        return make_column(data, batch.row_mask(), T.INT)


class ArrayContains(Expression):
    """``array_contains(arr, value)`` with Spark's null rules (see the
    module doc)."""

    def __init__(self, array: Expression, value):
        if not isinstance(value, Expression):
            value = Literal(value)
        self.children = [array, value]

    @property
    def data_type(self) -> T.DataType:
        return T.BOOLEAN

    @property
    def nullable(self) -> bool:
        return True

    def with_children(self, children):
        return ArrayContains(children[0], children[1])

    def eval_host(self, batch):
        arr, aok = self.children[0].eval_host(batch)
        val, vok = self.children[1].eval_host(batch)
        hit = np.zeros(batch.num_rows, dtype=bool)
        valid = np.zeros(batch.num_rows, dtype=bool)
        for i, (lst, a, v) in enumerate(zip(arr, aok, vok)):
            if not (a and v) or lst is None:
                continue
            hit[i] = any(x is not None and x == val[i] for x in lst)
            valid[i] = hit[i] or all(x is not None for x in lst)
        return host_column(hit, valid, T.BOOLEAN)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        arr = self.children[0].eval_device(batch)
        val = self.children[1].eval_device(batch)
        in_len = torch.arange(arr.max_len, device=arr.device)[None, :] \
            < arr.lengths[:, None]
        hit = (arr.elem_validity & (arr.data == val.data[:, None])).any(1)
        has_null = (in_len & ~arr.elem_validity).any(1)
        validity = arr.validity & val.validity & (hit | ~has_null)
        return make_column(hit, validity, T.BOOLEAN)


class CreateNamedStruct(Expression):
    """``named_struct(n1, e1, n2, e2, ...)``: never null itself."""

    def __init__(self, names: List[str], exprs: List[Expression]):
        assert len(names) == len(exprs)
        self.names = list(names)
        self.children = list(exprs)

    @property
    def data_type(self) -> T.DataType:
        return T.StructType([T.StructField(n, e.data_type, e.nullable)
                             for n, e in zip(self.names, self.children)])

    @property
    def nullable(self) -> bool:
        return False

    def with_children(self, children):
        return CreateNamedStruct(self.names, children)

    def eval_host(self, batch):
        kids = [c.eval_host(batch) for c in self.children]
        rows = np.empty(batch.num_rows, dtype=object)
        rows[:] = [{n: (_py(v[i]) if ok[i] else None)
                    for n, (v, ok) in zip(self.names, kids)}
                   for i in range(batch.num_rows)]
        return rows, np.ones(batch.num_rows, dtype=bool)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        kids = tuple(c.eval_device(batch) for c in self.children)
        return DeviceColumn(None, batch.row_mask(), self.data_type,
                            children=kids)

    def __str__(self) -> str:
        args = ", ".join(f"{n}={c}" for n, c in zip(self.names,
                                                   self.children))
        return f"named_struct({args})"


class GetStructField(Expression):
    """``struct.field`` by name: the field's column, null where the
    struct or the field is."""

    def __init__(self, child: Expression, field_name: str):
        self.children = [child]
        self.field_name = field_name

    @property
    def data_type(self) -> T.DataType:
        st = self.children[0].data_type
        return st.fields[st.field_index(self.field_name)].data_type

    @property
    def nullable(self) -> bool:
        return True

    def with_children(self, children):
        return GetStructField(children[0], self.field_name)

    def eval_host(self, batch):
        v, ok = self.children[0].eval_host(batch)
        out = [x.get(self.field_name) if good and x is not None else None
               for x, good in zip(v, ok)]
        dt = self.data_type
        return host_column([0 if x is None and fixed_width(dt) else x
                            for x in out],
                           np.array([x is not None for x in out], bool), dt)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        s = self.children[0].eval_device(batch)
        kid = s.children[s.dtype.field_index(self.field_name)]
        validity = kid.validity & s.validity
        if kid.is_dict:
            return kid.replace_rows(validity,
                                    torch.where(validity, kid.codes, 0))
        if kid.is_flat:
            return DeviceColumn(kid.data, validity, kid.dtype,
                                offsets=kid.offsets, max_bytes=kid.max_bytes)
        return make_column(kid.data, validity, kid.dtype)

    def __str__(self) -> str:
        return f"{self.children[0]}.{self.field_name}"


def _py(x):
    """A host value as a Python one (a numpy scalar's ``item``)."""
    return x.item() if isinstance(x, np.generic) else x


def array(*elements) -> CreateArray:
    return CreateArray(*[e if isinstance(e, Expression) else lit(e)
                         for e in elements])


def struct(**fields) -> CreateNamedStruct:
    return CreateNamedStruct(list(fields), [
        v if isinstance(v, Expression) else lit(v) for v in fields.values()])
