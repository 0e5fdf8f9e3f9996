"""``group_ids``, ``segment_reduce`` and ``gather_group_keys`` against the
JAX package, and the plain rowwise compare of ``cuda/strings.py``
against the Pallas ``ragged_row_equal``.

The key columns are the cases of the reference's group-by kernel tests
(``tests/test_kernels.py:78-160``): an int key, an int key with nulls, a
dictionary string key, a flat string key and two keys, made from a
numpy seed in the reference and carried to the port. Segment ids, group
counts, first rows, integer reductions, counts and keys must be equal;
float sums are held to ``tests/harness.py``'s ``DEVICE_FLOAT_TOL``.
The reference's string branch runs with its Pallas gate off and on
(interpret mode).
"""

import numpy as np
import pyarrow as pa
import pytest

import jax.numpy as jnp
import torch

from spark_rapids_tpu.data.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.data.column import DeviceColumn as RColumn
from spark_rapids_tpu.ops import strings_util as RSU
from spark_rapids_tpu.ops.kernels import groupby as RKG
from spark_rapids_tpu.ops.kernels import pallas as PAL
from spark_rapids_tpu.ops.kernels.pallas import strings as RSTR

from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops import strings_util as SU
from spark_rapids_tpu_torch.ops.kernels import groupby as KG
from spark_rapids_tpu_torch.ops.kernels.cuda import strings as SG
from harness import DEVICE_FLOAT_TOL
from test_torch_cuda import row_equal_case
from test_torch_ops import assert_column, ref_fields

CONF = PAL.PallasConf(enabled=True)
WORDS = np.array(["AIR", "FOB", "MAIL", "", "REG AIR", "ÄRGER", "x" * 20])
KEY_CASES = ["int", "int with nulls", "dictionary string", "flat string",
             "two keys"]
OPS = ["sum", "min", "max", "count", "first", "last"]


def _flat(strings: np.ndarray, mask: np.ndarray, capacity: int) -> RColumn:
    raw = [s.encode() for s in strings]
    offsets = np.concatenate([[0], np.cumsum([len(b) for b in raw])])
    data = np.frombuffer(b"".join(raw) or b"\0", np.uint8)
    return RColumn.string_from_host(offsets.astype(np.int32), data, ~mask,
                                    capacity)


def key_case(name: str, n: int = 300, seed: int = 0):
    """(reference key columns, port key columns, reference batch) of one
    case, with int64 and float64 value columns ``v`` and ``x``."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 12, n)
    s = WORDS[rng.integers(0, len(WORDS), n)]
    smask = rng.random(n) < 0.1
    rb = RBatch.from_arrow(pa.RecordBatch.from_arrays([
        pa.array(k, pa.int64()),
        pa.array(k, pa.int64(), mask=rng.random(n) < 0.2),
        pa.array(s, pa.string(), mask=smask),
        pa.array(rng.integers(-1000, 1000, n), pa.int64(),
                 mask=rng.random(n) < 0.1),
        pa.array(np.round(rng.normal(0, 100, n), 3), pa.float64(),
                 mask=rng.random(n) < 0.1),
    ], names=["k", "kn", "s", "v", "x"]))
    flat = _flat(s, smask, rb.capacity)
    ref = {"int": [rb.column(0)], "int with nulls": [rb.column(1)],
           "dictionary string": [rb.column(2)], "flat string": [flat],
           "two keys": [rb.column(1), rb.column(2)]}[name]
    types = {"int": [T.LONG], "int with nulls": [T.LONG],
             "dictionary string": [T.STRING], "flat string": [T.STRING],
             "two keys": [T.LONG, T.STRING]}[name]
    port = [carry.column_from_reference(ref_fields(c), t, device="cpu")
            for c, t in zip(ref, types)]
    if name == "flat string":
        assert ref[0].is_string and not ref[0].is_dict and port[0].is_flat
    return ref, port, rb


def _port_col(rb, i, dtype):
    return carry.column_from_reference(ref_fields(rb.column(i)), dtype,
                                       device="cpu")


@pytest.mark.parametrize("pallas", [None, CONF], ids=["jnp", "pallas"])
@pytest.mark.parametrize("name", KEY_CASES)
def test_group_ids_match_reference(name, pallas):
    ref, port, rb = key_case(name)
    rseg, rn, rfirst = RKG.group_ids(ref, rb.n_rows, pallas=pallas)
    pseg, pn, pfirst = KG.group_ids(port, torch.tensor(int(rb.n_rows)))
    assert int(pn) == int(rn)
    np.testing.assert_array_equal(pseg.numpy(), np.asarray(rseg))
    np.testing.assert_array_equal(pfirst.numpy(), np.asarray(rfirst))
    assert pseg.dtype == torch.int32 and pfirst.dtype == torch.int32


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", KEY_CASES)
def test_segment_reduce_matches_reference(name, op):
    ref, port, rb = key_case(name, seed=1)
    rseg, _, _ = RKG.group_ids(ref, rb.n_rows)
    pseg, _, _ = KG.group_ids(port, torch.tensor(int(rb.n_rows)))
    cap = rb.capacity
    rlive = rb.row_mask()
    plive = torch.tensor(np.asarray(rlive))
    for i, dtype in ((3, T.LONG), (4, T.DOUBLE)):
        rc, pc = rb.column(i), _port_col(rb, i, dtype)
        rout, rcnt = RKG.segment_reduce(rc.data, rc.validity, rseg, cap, op,
                                        rlive)
        pout, pcnt = KG.segment_reduce(pc.data, pc.validity, pseg, cap, op,
                                       plive)
        np.testing.assert_array_equal(pcnt.numpy(), np.asarray(rcnt))
        got, want = pout.numpy(), np.asarray(rout)
        if dtype is T.DOUBLE and op == "sum":
            np.testing.assert_allclose(got, want, rtol=DEVICE_FLOAT_TOL,
                                       atol=0)
        else:
            np.testing.assert_array_equal(got, want.astype(got.dtype))


@pytest.mark.parametrize("name", KEY_CASES)
def test_gather_group_keys_match_reference(name):
    ref, port, rb = key_case(name, seed=2)
    rseg, rn, rfirst = RKG.group_ids(ref, rb.n_rows)
    pseg, pn, pfirst = KG.group_ids(port, torch.tensor(int(rb.n_rows)))
    rkeys = RKG.gather_group_keys(ref, rfirst, rn)
    pkeys = KG.gather_group_keys(port, pfirst, pn)
    live = np.arange(rb.capacity) < int(rn)
    for g, w in zip(pkeys, rkeys):
        if g.is_flat:
            np.testing.assert_array_equal(g.validity.numpy()[live],
                                          np.asarray(w.validity)[live])
            ok = live & g.validity.numpy()
            np.testing.assert_array_equal(SU.char_matrix(g).numpy()[ok],
                                          np.asarray(RSU.char_matrix(w))[ok])
        else:
            assert_column(g, w, live)


def test_group_ids_over_a_dead_tail_and_no_rows():
    """Rows past ``n_rows`` join no group, and an empty input has none."""
    ref, port, rb = key_case("two keys", n=200, seed=3)
    for n in (0, 57):
        rseg, rn, rfirst = RKG.group_ids(ref, jnp.int32(n))
        pseg, pn, pfirst = KG.group_ids(port, torch.tensor(n))
        assert int(pn) == int(rn)
        np.testing.assert_array_equal(pseg.numpy(), np.asarray(rseg))
        np.testing.assert_array_equal(pfirst.numpy(), np.asarray(rfirst))


@pytest.mark.parametrize("w", [8, 16, 128])
@pytest.mark.parametrize("n", [1, 512, 4099])
def test_row_equal_plain_matches_pallas(n, w):
    a, b = row_equal_case(n, w)
    want = np.asarray(RSTR.ragged_row_equal(jnp.asarray(a), jnp.asarray(b),
                                            CONF))
    got = SG.ragged_row_equal(torch.tensor(a), torch.tensor(b))
    np.testing.assert_array_equal(got.numpy(), want)
    assert SG.ragged_row_equal.launches == 0 or torch.cuda.is_available()


def test_row_equal_views_match_materialized_prev():
    """``_equal_adjacent``'s row views ``m[1:]`` / ``m[:-1]`` (row 0 with
    itself) against the reference's materialized ``prev`` matrix."""
    a, _ = row_equal_case(777, 16, seed=5)
    a[10:20] = a[9]  # runs of equal rows
    m = torch.tensor(a)
    got = torch.ones(len(a), dtype=torch.bool)
    got[1:] = SG.ragged_row_equal(m[1:], m[:-1])
    ma = jnp.asarray(a)
    prev = jnp.concatenate([ma[:1], ma[:-1]], axis=0)
    want = np.asarray(RSTR.ragged_row_equal(ma, prev, CONF))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[10:20].all()


def test_row_equal_empty_shapes():
    """The Pallas wrapper refuses n == 0 and W == 0; the port answers."""
    for n, w in ((0, 8), (5, 0)):
        z = torch.zeros((n, w), dtype=torch.int16)
        assert RSTR.ragged_row_equal(jnp.zeros((n, w), jnp.int16),
                                     jnp.zeros((n, w), jnp.int16),
                                     CONF) is None
        np.testing.assert_array_equal(SG.ragged_row_equal(z, z).numpy(),
                                      np.ones(n, bool))
