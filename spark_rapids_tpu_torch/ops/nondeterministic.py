"""Nondeterministic expressions — port of
``spark_rapids_tpu/ops/nondeterministic.py``.

``Rand``, ``SparkPartitionID`` and ``MonotonicallyIncreasingID`` read the
partition index and the running row offset within the partition from
:class:`eval_context`, which the project exec sets around evaluation
(``exec/execs.py ProjectExec``), as the reference's project execs do.

``Rand`` is the reference's hash counter: splitmix64 of (row index within
the partition, from the running offset) XOR a salt of (seed,
partition), its top 53 bits scaled into ``[0, 1)``. It is not Spark's
XORShiftRandom sequence; the reference takes the same stance. The
64-bit arithmetic runs on int64 lanes: products wrap modulo ``2**64``
as unsigned ones do, and each right shift is arithmetic, so it is
masked to the bits a logical shift keeps, which gives the reference's
bits exactly.

The ``input_file_name()`` family (``InputFileName``,
``InputFileBlockStart``, ``InputFileBlockLength``) is rewritten into
hidden scan columns before planning (``plan/input_file.py``); one that
survives evaluates to Spark's no-file constant ('' or -1).
"""

from __future__ import annotations

import threading

import numpy as np

import torch

from .. import types as T
from ..data.batch import ColumnarBatch
from ..data.column import DeviceColumn, scalar_column
from .expression import Expression, host_constant, make_column

_CTX = threading.local()
_U64 = (1 << 64) - 1


def _s64(u: int) -> int:
    """The int64 whose bits are the uint64 ``u``."""
    return u - (1 << 64) if u >= 1 << 63 else u


class eval_context:
    """The partition index and the running row offset (an int, or a 0-d
    int64 tensor on the batch's device) of the batch being projected."""

    def __init__(self, partition_id: int, row_base):
        self.partition_id = int(partition_id)
        self.row_base = row_base

    def __enter__(self):
        _CTX.current = self
        return self

    def __exit__(self, *exc):
        _CTX.current = None


def _current() -> eval_context:
    ctx = getattr(_CTX, "current", None)
    return ctx if ctx is not None else eval_context(0, 0)


def _row_index(ctx: eval_context, n: int, device) -> torch.Tensor:
    """int64 ``row_base + [0, n)``: each row's index in its partition."""
    base = ctx.row_base
    if not isinstance(base, torch.Tensor):
        base = torch.tensor(int(base), dtype=torch.int64)
    return torch.arange(n, dtype=torch.int64, device=device) \
        + base.to(device=device, dtype=torch.int64)


class Rand(Expression):
    """``rand(seed)``: a uniform double in ``[0, 1)`` a row."""

    def __init__(self, seed: int = 0):
        self.children = []
        self.seed = int(seed)

    @property
    def data_type(self):
        return T.DOUBLE

    @property
    def nullable(self):
        return False

    def with_children(self, children):
        return Rand(self.seed)

    def _salt(self, partition_id: int) -> int:
        return (self.seed * 0x9E3779B97F4A7C15
                + partition_id * 0xD1B54A32D192ED03) & _U64

    def bits_np(self, n: int) -> np.ndarray:
        """The counter's uint64 bits of ``n`` rows from the context's
        row offset, in numpy's wrapping uint64 arithmetic (the
        reference's ``_bits_np``)."""
        ctx = _current()
        x = np.arange(n, dtype=np.uint64) + np.uint64(int(ctx.row_base))
        x ^= np.uint64(self._salt(ctx.partition_id))
        with np.errstate(over="ignore"):
            x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))

    def eval_host(self, batch):
        bits = self.bits_np(batch.num_rows)
        vals = (bits >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        return vals, np.ones(batch.num_rows, dtype=bool)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        ctx = _current()
        live = batch.row_mask()
        x = _row_index(ctx, batch.capacity, live.device) \
            ^ _s64(self._salt(ctx.partition_id))
        x = (x ^ ((x >> 30) & 0x3FFFFFFFF)) * _s64(0xBF58476D1CE4E5B9)
        x = (x ^ ((x >> 27) & 0x1FFFFFFFFF)) * _s64(0x94D049BB133111EB)
        x = x ^ ((x >> 31) & 0x1FFFFFFFF)
        bits53 = (x >> 11) & ((1 << 53) - 1)
        vals = bits53.to(torch.float64) / float(1 << 53)
        return make_column(vals, live, T.DOUBLE)

    def __str__(self) -> str:
        return f"rand({self.seed})"


class SparkPartitionID(Expression):
    """``spark_partition_id()``."""

    def __init__(self):
        self.children = []

    @property
    def data_type(self):
        return T.INT

    @property
    def nullable(self):
        return False

    def with_children(self, children):
        return SparkPartitionID()

    def eval_host(self, batch):
        return np.full(batch.num_rows, _current().partition_id, np.int32), \
            np.ones(batch.num_rows, dtype=bool)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        live = batch.row_mask()
        data = torch.full((batch.capacity,), _current().partition_id,
                          dtype=torch.int32, device=live.device)
        return make_column(data, live, T.INT)

    def __str__(self) -> str:
        return "spark_partition_id()"


class MonotonicallyIncreasingID(Expression):
    """``monotonically_increasing_id()``: ``(partition << 33)`` plus the
    row's index in its partition, Spark's layout."""

    def __init__(self):
        self.children = []

    @property
    def data_type(self):
        return T.LONG

    @property
    def nullable(self):
        return False

    def with_children(self, children):
        return MonotonicallyIncreasingID()

    def eval_host(self, batch):
        ctx = _current()
        base = (ctx.partition_id << 33) + int(ctx.row_base)
        return base + np.arange(batch.num_rows, dtype=np.int64), \
            np.ones(batch.num_rows, dtype=bool)

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        ctx = _current()
        live = batch.row_mask()
        data = _row_index(ctx, batch.capacity, live.device) \
            + (ctx.partition_id << 33)
        return make_column(data, live, T.LONG)

    def __str__(self) -> str:
        return "monotonically_increasing_id()"


def has_nondeterministic(expr) -> bool:
    if isinstance(expr, (Rand, SparkPartitionID, MonotonicallyIncreasingID)):
        return True
    return any(has_nondeterministic(c) for c in expr.children)


class _InputFileExpr(Expression):
    """``input_file_name()`` and the block start and length: rewritten
    into the scan's hidden columns before planning; evaluated, the
    no-file constant, Spark's value outside a file scan."""

    NO_FILE = None

    def __init__(self):
        self.children = []

    def with_children(self, children):
        return type(self)()

    @property
    def nullable(self):
        return False

    @property
    def name(self) -> str:
        return type(self).__name__

    def eval_device(self, batch: ColumnarBatch) -> DeviceColumn:
        return scalar_column(self.NO_FILE, self.data_type, batch.capacity,
                             batch.row_mask())

    def eval_host(self, batch):
        return host_constant(self.NO_FILE, self.data_type, batch.num_rows)

    def __str__(self) -> str:
        return f"{type(self).__name__.lower()}()"


class InputFileName(_InputFileExpr):
    """``input_file_name()``: the path of the file being read; '' without
    a file scan below."""

    NO_FILE = ""

    @property
    def data_type(self):
        return T.STRING


class InputFileBlockStart(_InputFileExpr):
    """``input_file_block_start()``: the split's byte offset; -1 without
    a file scan."""

    NO_FILE = -1

    @property
    def data_type(self):
        return T.LONG


class InputFileBlockLength(_InputFileExpr):
    """``input_file_block_length()``: the split's byte length; -1 without
    a file scan."""

    NO_FILE = -1

    @property
    def data_type(self):
        return T.LONG
