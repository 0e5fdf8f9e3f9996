"""Expression IR with device evaluation — port of
``spark_rapids_tpu/ops/expression.py``.

``eval_device(batch)`` evaluates an expression over a
:class:`ColumnarBatch` with torch ops on the batch's device and returns
a :class:`DeviceColumn`. Null semantics follow Spark: most operators
propagate null if any input is null, and data under a null is forced to
zero so padded lanes never affect results (``make_column``).

``eval_host(batch)`` evaluates it over a :class:`HostBatch` on the host
and returns ``(values, validity)`` as numpy arrays (strings, arrays and
structs as object arrays): the host side of the plan rewrite, which the
CPU operators (``plan/physical.py``) run for a node the device cannot
take, and the whole plan with ``spark.rapids.sql.enabled`` off. The
reference's host side is pyarrow compute (``ops/expression.py:58``); the
port's reuses the device code where it can. A fixed-width unary or binary operator (arithmetic, bitwise, date parts,
math) runs its ``do_device`` over its children's host values as CPU
tensors. The predicates, conditionals, casts, arrays, structs and most
string functions have their own ``eval_host`` (numpy, or per-row Python
over each row's UTF-8 bytes), including where no device kernel exists
(``split``, a float's text, arrays of strings, regular expressions,
``rand``). The rest (``Like``, ``Substring``, the pads, ``reverse``, the
string parsers and date formats, the time patterns) evaluate their
device path over the batch's columns uploaded to CPU tensors
(:func:`host_via_device`), so their host answers are their device
answers byte for byte (a pad or a substring may cut a character). None
of these paths touches the card.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..data.batch import ColumnarBatch, HostBatch
from ..data.column import DeviceColumn, scalar_column

#: ``(values, validity)`` of one host column
HostValues = Tuple[np.ndarray, np.ndarray]


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

    def eval_host(self, batch: HostBatch) -> HostValues:
        """``(values, validity)`` over ``batch``'s rows on the host. A
        class without a host kernel of its own runs its device path over
        CPU tensors (:func:`host_via_device`)."""
        return host_via_device(self, batch)

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

    def alias(self, name: str) -> "Alias":
        """This expression under the output name ``name``."""
        return Alias(self, name)

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

    def eval_host(self, batch: HostBatch) -> HostValues:
        return batch.columns[self._name], batch.validity[self._name]

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

    def eval_host(self, batch: HostBatch) -> HostValues:
        return batch.column_at(self.ordinal)

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

    def eval_host(self, batch: HostBatch) -> HostValues:
        return host_constant(self.value, self._dtype, batch.num_rows)

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

    def eval_host(self, batch: HostBatch) -> HostValues:
        return self.child.eval_host(batch)

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


def host_constant(value, dtype: T.DataType, n: int) -> HostValues:
    """``n`` rows of one value (``None``: null) on the host."""
    valid = np.full(n, value is not None, dtype=bool)
    if not fixed_width(dtype):
        vals = np.empty(n, dtype=object)
        vals[:] = [value] * n
        return vals, valid
    return np.full(n, 0 if value is None else value,
                   dtype=dtype.np_dtype), valid


def host_column(values, validity: np.ndarray, dtype: T.DataType
                ) -> HostValues:
    """A host column with the null-data-is-zero invariant (``None``
    under a null of an object column)."""
    validity = np.asarray(validity, dtype=bool)
    if not fixed_width(dtype):
        if isinstance(values, np.ndarray) and values.dtype == object \
                and values.ndim == 1:
            out = values.copy()
        else:
            out = np.empty(len(validity), dtype=object)
            out[:] = list(values)
        out[~validity] = None
        return out, validity
    values = np.asarray(values).astype(dtype.np_dtype, copy=False)
    return np.where(validity, values, np.zeros((), dtype.np_dtype)), \
        validity


def fixed_width(dt: T.DataType) -> bool:
    """Whether host values of ``dt`` are a numpy number or bool lane."""
    return dt.np_dtype is not None and dt.np_dtype != object \
        and not T.is_complex(dt)


def _lane(values: np.ndarray, validity: np.ndarray,
          dt: T.DataType) -> torch.Tensor:
    """Host ``values`` as a CPU tensor of ``dt``'s type, zero under a
    null (the device's null-data-is-zero invariant)."""
    return torch.from_numpy(np.ascontiguousarray(np.where(
        validity, values, np.zeros((), values.dtype)).astype(
            dt.np_dtype, copy=False)))


def _from_host(data: torch.Tensor, extra_null: Optional[torch.Tensor],
               validity: np.ndarray, dtype: T.DataType) -> HostValues:
    if extra_null is not None:
        validity = validity & ~extra_null.numpy()
    return host_column(data.to(dtype.torch_dtype).numpy(), validity, dtype)


def _cpu_batch(batch: HostBatch) -> ColumnarBatch:
    """``batch``'s columns as CPU tensors, made once a batch."""
    cached = batch.__dict__.get("_cpu_batch")
    if cached is None:
        from ..data.batch import _column_to_device
        from ..data.column import bucket_capacity
        cpu = torch.device("cpu")
        cap = bucket_capacity(max(batch.num_rows, 1))
        cols = [_column_to_device(*batch.column_at(i), f.data_type, cap, cpu)
                for i, f in enumerate(batch.schema)]
        cached = ColumnarBatch(tuple(cols), torch.tensor(
            batch.num_rows, dtype=torch.int64), batch.schema)
        batch.__dict__["_cpu_batch"] = cached
    return cached


def host_via_device(expr: "Expression", batch: HostBatch) -> HostValues:
    """``expr``'s device path over ``batch`` uploaded to CPU tensors, its
    result read back: the host kernel of a class that has none of its
    own (the plain PyTorch versions run; nothing touches the card)."""
    from ..data.batch import _host_values
    col = expr.eval_device(_cpu_batch(batch))
    vals, ok = _host_values(col, slice(0, batch.num_rows))
    return host_column(vals, ok, expr.data_type)


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

    def eval_host(self, batch: HostBatch) -> HostValues:
        """``do_device`` over the child's host values as CPU tensors, when
        both types are fixed-width and the class keeps the base
        ``eval_device``; else the device path on CPU tensors."""
        if type(self).eval_device is not UnaryExpression.eval_device or \
                not (fixed_width(self.child.data_type)
                     and fixed_width(self.data_type)):
            return host_via_device(self, batch)
        v, ok = self.child.eval_host(batch)
        data, extra = self.do_device(_lane(v, ok, self.child.data_type))
        return _from_host(data, extra, ok, self.data_type)

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

    def eval_host(self, batch: HostBatch) -> HostValues:
        """``do_device`` over both children's host values as CPU tensors,
        when every type is fixed-width and the class keeps the base
        ``eval_device``; else the device path on CPU tensors."""
        lt, rt = self.left.data_type, self.right.data_type
        if type(self).eval_device is not BinaryExpression.eval_device or \
                not (fixed_width(lt) and fixed_width(rt)
                     and fixed_width(self.data_type)):
            return host_via_device(self, batch)
        lv, lok = self.left.eval_host(batch)
        rv, rok = self.right.eval_host(batch)
        data, extra = self.do_device(_lane(lv, lok, lt), _lane(rv, rok, rt))
        return _from_host(data, extra, lok & rok, self.data_type)

    def do_device(self, l: torch.Tensor, r: torch.Tensor):
        """Return (result_data, extra_null_mask_or_None)."""
        raise NotImplementedError


def coerce_binary(l: Expression, r: Expression):
    """Cast both numeric sides to their promoted type
    (:class:`.cast.Cast`)."""
    from .cast import Cast
    lt, rt = l.data_type, r.data_type
    if lt is rt or not (lt.is_numeric and rt.is_numeric):
        return l, r
    common = T.numeric_promote(lt, rt)
    return (l if lt is common else Cast(l, common),
            r if rt is common else Cast(r, common))
