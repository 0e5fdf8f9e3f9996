"""Expression IR with device evaluation — port of
``spark_rapids_tpu/ops/expression.py``.

``eval_device(batch)`` evaluates an expression over a
:class:`ColumnarBatch` with torch ops on the batch's device and returns
a :class:`DeviceColumn`. Null semantics follow Spark: most operators
propagate null if any input is null, and data under a null is forced to
zero so padded lanes never affect results (``make_column``).

The reference also evaluates every expression on the host with pyarrow
as its CPU oracle; the port has no pyarrow, and its tests hold it
against the reference package instead.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

from .. import types as T
from ..data.batch import ColumnarBatch
from ..data.column import DeviceColumn, scalar_column


class Expression:
    """Base class. Subclasses set ``children`` and implement evaluation."""

    children: Sequence["Expression"] = ()

    @property
    def data_type(self) -> T.DataType:
        raise NotImplementedError(type(self).__name__)

    @property
    def nullable(self) -> bool:
        return any(c.nullable for c in self.children)

    @property
    def name(self) -> str:
        return str(self)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        raise NotImplementedError(type(self).__name__)

    def transform(self, fn) -> "Expression":
        """Bottom-up rewrite; ``fn`` returns a replacement or None."""
        new_children = [c.transform(fn) for c in self.children]
        node = self.with_children(new_children) \
            if new_children != list(self.children) else self
        replaced = fn(node)
        return replaced if replaced is not None else node

    def with_children(self, children: List["Expression"]) -> "Expression":
        if not self.children:
            return self
        raise NotImplementedError(type(self).__name__)

    def references(self) -> List[str]:
        out = []
        for c in self.children:
            out.extend(c.references())
        return out

    def bind(self, schema: T.Schema) -> "Expression":
        """Resolve attribute references to ordinals."""
        def rewrite(e):
            if isinstance(e, AttributeReference):
                idx = schema.index_of(e._name)
                return BoundReference(idx, schema[idx].data_type,
                                      schema[idx].nullable)
            return None
        return self.transform(rewrite)

    def __str__(self) -> str:
        args = ", ".join(str(c) for c in self.children)
        return f"{type(self).__name__}({args})"


class AttributeReference(Expression):
    """A column-by-name reference (before binding)."""

    def __init__(self, name: str, dtype: Optional[T.DataType] = None,
                 nullable: bool = True):
        self._name = name
        self._dtype = dtype
        self._nullable = nullable

    @property
    def data_type(self) -> T.DataType:
        if self._dtype is None:
            raise RuntimeError(f"unresolved attribute {self._name}")
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self._nullable

    @property
    def name(self) -> str:
        return self._name

    def references(self) -> List[str]:
        return [self._name]

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        return batch.column(self._name)

    def __str__(self) -> str:
        return self._name


class BoundReference(Expression):
    """A column reference resolved to an ordinal."""

    def __init__(self, ordinal: int, dtype: T.DataType, nullable: bool = True):
        self.ordinal = ordinal
        self._dtype = dtype
        self._nullable = nullable

    @property
    def data_type(self) -> T.DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self._nullable

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        return batch.columns[self.ordinal]

    def __str__(self) -> str:
        return f"input[{self.ordinal}]"


class Literal(Expression):
    def __init__(self, value: Any, dtype: Optional[T.DataType] = None):
        self.value = value
        self._dtype = dtype or infer_literal_type(value)

    @property
    def data_type(self) -> T.DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self.value is None

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        return scalar_column(self.value, self._dtype, batch.capacity,
                             batch.row_mask())

    def __str__(self) -> str:
        return repr(self.value)


def infer_literal_type(value: Any) -> T.DataType:
    if isinstance(value, bool):
        return T.BOOLEAN
    if isinstance(value, int):
        return T.INT if -(2 ** 31) <= value < 2 ** 31 else T.LONG
    if isinstance(value, float):
        return T.DOUBLE
    if isinstance(value, str):
        return T.STRING
    raise TypeError(f"cannot infer literal type for {value!r}")


def lit(value: Any, dtype: Optional[T.DataType] = None) -> Literal:
    return Literal(value, dtype)


def col(name: str) -> AttributeReference:
    return AttributeReference(name)


class Alias(Expression):
    def __init__(self, child: Expression, alias: str):
        self.children = [child]
        self._alias = alias

    @property
    def child(self) -> Expression:
        return self.children[0]

    @property
    def data_type(self) -> T.DataType:
        return self.child.data_type

    @property
    def name(self) -> str:
        return self._alias

    def with_children(self, children):
        return Alias(children[0], self._alias)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        return self.child.eval_device(batch)

    def __str__(self) -> str:
        return f"{self.child} AS {self._alias}"


def combined_validity(*cols: DeviceColumn) -> torch.Tensor:
    out = cols[0].validity
    for c in cols[1:]:
        out = out & c.validity
    return out


def make_column(data: torch.Tensor, validity: torch.Tensor,
                dtype: T.DataType) -> DeviceColumn:
    """A fixed-width column with the null-data-is-zero invariant."""
    data = data.to(dtype.torch_dtype)
    data = torch.where(validity, data, torch.zeros((), dtype=data.dtype,
                                                   device=data.device))
    return DeviceColumn(data, validity, dtype)


class UnaryExpression(Expression):
    """Null-propagating unary op; subclasses implement ``do_device``."""

    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def child(self) -> Expression:
        return self.children[0]

    def with_children(self, children):
        return type(self)(children[0])

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        c = self.child.eval_device(batch)
        data, extra_null = self.do_device(c.data)
        validity = c.validity if extra_null is None \
            else c.validity & ~extra_null
        return make_column(data, validity, self.data_type)

    def do_device(self, data: torch.Tensor):
        """Return (result_data, extra_null_mask_or_None)."""
        raise NotImplementedError


class BinaryExpression(Expression):
    """Null-propagating binary op over fixed-width inputs."""

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    @property
    def left(self) -> Expression:
        return self.children[0]

    @property
    def right(self) -> Expression:
        return self.children[1]

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        l = self.left.eval_device(batch)
        r = self.right.eval_device(batch)
        data, extra_null = self.do_device(l.data, r.data)
        validity = combined_validity(l, r)
        if extra_null is not None:
            validity = validity & ~extra_null
        return make_column(data, validity, self.data_type)

    def do_device(self, l: torch.Tensor, r: torch.Tensor):
        """Return (result_data, extra_null_mask_or_None)."""
        raise NotImplementedError


class Cast(UnaryExpression):
    """Numeric widening cast (the coercion the analyzer inserts)."""

    def __init__(self, child: Expression, to: T.DataType):
        super().__init__(child)
        self.to = to

    @property
    def data_type(self) -> T.DataType:
        return self.to

    def with_children(self, children):
        return Cast(children[0], self.to)

    def do_device(self, data):
        return data.to(self.to.torch_dtype), None

    def __str__(self) -> str:
        return f"cast({self.child} as {self.to})"


def coerce_binary(l: Expression, r: Expression):
    """Cast both numeric sides to their promoted type."""
    lt, rt = l.data_type, r.data_type
    if lt is rt or not (lt.is_numeric and rt.is_numeric):
        return l, r
    common = T.numeric_promote(lt, rt)
    return (l if lt is common else Cast(l, common),
            r if rt is common else Cast(r, common))
