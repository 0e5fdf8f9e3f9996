"""The single-key sort against the JAX package: the packed sort lane, the
``sortStep`` kernel's plain version, and ``sort_batch_by_columns``.

``packed_sort_lane`` must build the reference's lane bit for bit for
every eligible key (int, date, sorted dictionary; ascending and
descending; nulls first and last; lazy dead rows) and refuse the keys
the reference refuses. The plain argsort is held against the Pallas
``packed_argsort`` in interpret mode on the lanes ``tests/test_torch_cuda.py``
sorts on the card, and whole sorts against the reference with its
Pallas gate on and off.
"""

import numpy as np
import pyarrow as pa
import pytest

import jax.numpy as jnp
import torch

from spark_rapids_tpu.data.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.ops import strings as RS
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit
from spark_rapids_tpu.ops.kernels import pallas as PAL
from spark_rapids_tpu.ops.kernels import rowops as RKR
from spark_rapids_tpu.ops.kernels.pallas import sort_steps as RSS
from spark_rapids_tpu.plan import logical as RL

from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch.ops.kernels import rowops as KR
from spark_rapids_tpu_torch.ops.kernels.cuda import sort_steps as SS
from test_torch_cuda import SORT_CASES, sort_lane_case
from test_torch_ops import assert_column, port_schema, ref_fields
from test_torch_strings import assert_same_strings

CONF = PAL.PallasConf(enabled=True)


def sort_batches(n: int = 900, seed: int = 6):
    """(reference, port) batches, lazily filtered, with an int32 ``i``, a
    date ``d``, a dictionary string ``s``, an int64 ``a``, a float ``b``
    and a flat string ``f`` (built by the reference)."""
    rng = np.random.default_rng(seed)
    words = np.array(["MAIL", "AIR", "TRUCK", "RAIL", "SHIP", "ÄRGER", ""])
    rbt = pa.RecordBatch.from_arrays([
        pa.array(rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32),
                 pa.int32(), mask=rng.random(n) < 0.1),
        pa.array(rng.integers(8000, 8100, n).astype(np.int32), pa.date32(),
                 mask=rng.random(n) < 0.1),
        pa.array(words[rng.integers(0, len(words), n)], pa.string(),
                 mask=rng.random(n) < 0.1),
        pa.array(rng.integers(-9, 9, n), pa.int64()),
        pa.array(rng.normal(size=n), pa.float64()),
    ], names=["i", "d", "s", "a", "b"])
    rb = RBatch.from_arrow(rbt)
    rb = RKR.compact(rb, jnp.asarray(rng.random(rb.capacity) < 0.8))
    f = RL.resolve(RS.Substring(rcol("s"), rlit(1), rlit(2)),
                   rb.schema).bind(rb.schema).eval_device(rb)
    from spark_rapids_tpu import types as RT
    rb = RBatch(rb.columns + (f,), rb.n_rows,
                RT.Schema(list(rb.schema) + [RT.StructField("f", RT.STRING)]),
                live=rb.live)
    pb = carry.batch_from_reference([ref_fields(c) for c in rb.columns],
                                    port_schema(rb.schema), int(rb.n_rows),
                                    np.asarray(rb.live), device="cpu")
    return rb, pb


ORDERS = [(True, True), (True, False), (False, True), (False, False)]


@pytest.mark.parametrize("asc,nf", ORDERS)
@pytest.mark.parametrize("key", ["i", "d", "s"])
def test_packed_sort_lane_matches_reference(key, asc, nf):
    rb, pb = sort_batches()
    want = RKR.packed_sort_lane(rb, [rb.column(key)], [asc], [nf])
    got = KR.packed_sort_lane(pb, [pb.column(key)], [asc], [nf])
    assert want is not None and got is not None
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("asc,nf", ORDERS)
@pytest.mark.parametrize("key", ["i", "d", "s"])
def test_packed_sort_lane_index_bits_are_row_positions(key, asc, nf):
    """The low INDEX_BITS of every lane are its row position (dead rows
    included), the contract under which the radix sortStep skips its
    index windows."""
    _, pb = sort_batches()
    lane = KR.packed_sort_lane(pb, [pb.column(key)], [asc], [nf])
    mask = (1 << SS.INDEX_BITS) - 1
    assert lane.shape == (pb.capacity,)
    np.testing.assert_array_equal((lane & mask).numpy(),
                                  np.arange(pb.capacity))
    assert bool((lane >= 0).all())


@pytest.mark.parametrize("keys", [["a"], ["b"], ["f"], ["i", "d"]])
def test_packed_sort_lane_refuses_what_reference_refuses(keys):
    rb, pb = sort_batches()
    assert RKR.packed_sort_lane(rb, [rb.column(k) for k in keys],
                                [True] * len(keys), [True] * len(keys)) \
        is None
    assert KR.packed_sort_lane(pb, [pb.column(k) for k in keys],
                               [True] * len(keys), [True] * len(keys)) \
        is None


@pytest.mark.parametrize("name", SORT_CASES)
def test_plain_argsort_matches_pallas(name):
    lane = sort_lane_case(name)
    want = RSS.packed_argsort(jnp.asarray(lane), CONF)
    assert want is not None
    got = SS.packed_argsort(torch.as_tensor(lane))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_argsort_cpu_takes_plain_and_counts_nothing():
    lane = torch.as_tensor(sort_lane_case("random 1000"))
    before = SS.packed_argsort.launches
    assert torch.equal(SS.packed_argsort(lane),
                       SS.packed_argsort_plain(lane))
    assert SS.packed_argsort.launches == before


SORTS = {
    "i asc": (["i"], [True], [True]),
    "i desc nulls last": (["i"], [False], [False]),
    "d desc nulls first": (["d"], [False], [True]),
    "s asc nulls last": (["s"], [True], [False]),
    "s desc": (["s"], [False], [False]),
    "f asc": (["f"], [True], [True]),
    "f desc, i asc": (["f", "i"], [False, True], [False, True]),
}


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("name", list(SORTS))
def test_sort_batch_matches_reference(name, pallas):
    names, asc, nf = SORTS[name]
    rb, pb = sort_batches()
    rs = RKR.sort_batch_by_columns(rb, [rb.column(n) for n in names], asc,
                                   nf, pallas=PAL.PallasConf(enabled=pallas))
    calls = []
    argsort = SS.packed_argsort
    SS.packed_argsort = lambda lane: calls.append(lane) or argsort(lane)
    try:
        ps = KR.sort_batch_by_columns(pb, [pb.column(n) for n in names],
                                      asc, nf)
    finally:
        SS.packed_argsort = argsort
    assert len(calls) == (1 if names in (["i"], ["d"], ["s"]) else 0)
    assert int(ps.n_rows) == int(rs.n_rows)
    live = np.asarray(rs.row_mask())
    for g, w in zip(ps.columns, rs.columns):
        if g.is_flat:
            assert_same_strings(g, w, live)
        else:
            assert_column(g, w, live)
