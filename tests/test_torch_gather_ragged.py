"""The ``strings`` family's ragged gather against the JAX package, on the
CPU.

``gather_strings`` gathers a flat string column from its own payload and
offsets into the gathered column's payload and offsets. Its plain
version must equal, bit for bit, the JAX package's flat-string
``gather_column`` (the jnp route, and the Pallas ``ragged_gather`` in
interpret mode) on the same column, indices and validity: offsets,
payload through the byte capacity, and validity, on the cases
``tests/test_torch_cuda.py`` runs on the card (lengths 0, W and past W,
negative and wrapped lengths, indices out of range, one source row,
unaligned entry starts, a payload that ends at the last entry). The
port's ``gather_column`` takes the ragged entry for every flat column
and gives the column the char-matrix route gave.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.data.column import DeviceColumn as RColumn
from spark_rapids_tpu.ops.kernels import pallas as PAL
from spark_rapids_tpu.ops.kernels import rowops as RKR

from spark_rapids_tpu_torch.data.column import bucket_byte_capacity
from spark_rapids_tpu_torch.ops import strings_util as SU
from spark_rapids_tpu_torch.ops.kernels import rowops as KR
from spark_rapids_tpu_torch.ops.kernels.cuda import strings as SG
from spark_rapids_tpu_torch.ops.kernels.cuda.strings_cases import (
    GATHER_CASES, GATHER_WIDTHS, gather_strings_case)
from test_torch_strings import batches as string_batches

GATHER_ROWS = [1, 257, 1000]


def _reference(payload, offsets, idx, valid, w, pallas):
    """The JAX package's ``gather_column`` of the layout as a column whose
    rows are all valid, with ``valid`` as the index validity."""
    n = len(offsets) - 1
    col = RColumn(data=jnp.asarray(payload),
                  validity=jnp.ones(n, jnp.bool_), dtype=RT.STRING,
                  offsets=jnp.asarray(offsets), max_bytes=w)
    return RKR.gather_column(col, jnp.asarray(idx), jnp.asarray(valid),
                             pallas=PAL.PallasConf(enabled=pallas))


def _plain(payload, offsets, idx, valid, w):
    """``gather_strings`` on CPU tensors: (payload, offsets) as numpy."""
    got = SG.gather_strings(torch.as_tensor(payload),
                            torch.as_tensor(offsets), torch.as_tensor(idx),
                            torch.as_tensor(valid), w,
                            bucket_byte_capacity(len(idx) * w))
    return tuple(t.numpy() for t in got)


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("w", GATHER_WIDTHS)
@pytest.mark.parametrize("m", GATHER_ROWS)
@pytest.mark.parametrize("name", GATHER_CASES)
def test_ragged_gather_plain_matches_reference(name, m, w, pallas):
    payload, offsets, idx, valid = gather_strings_case(name, m, w)
    want = _reference(payload, offsets, idx, valid, w, pallas)
    got_payload, got_offsets = _plain(payload, offsets, idx, valid, w)
    np.testing.assert_array_equal(got_offsets, np.asarray(want.offsets))
    np.testing.assert_array_equal(got_payload, np.asarray(want.data))
    np.testing.assert_array_equal(valid, np.asarray(want.validity))


def test_gather_cases_reach_their_edges():
    """The cases hold what the tests claim to cover."""
    payload, offsets, idx, valid = gather_strings_case("mixed", 1000, 8)
    lens = np.diff(offsets.astype(np.int64))
    assert (lens > 8).any() and (lens == 8).any() and (lens == 0).any()
    assert (offsets[:-1] % 2 == 1).any() and valid.any() and not valid.all()
    _, offsets, idx, _ = gather_strings_case("indices out of range", 257, 8)
    n = len(offsets) - 1
    assert (idx < 0).any() and (idx >= n).any()
    _, offsets, _, _ = gather_strings_case("negative lengths", 1000, 8)
    assert (np.diff(offsets.astype(np.int64)) < 0).any()
    _, offsets, _, _ = gather_strings_case("wrapped lengths", 1000, 8)
    wide = np.diff(offsets.astype(np.int64))
    wrapped = np.diff(offsets)  # int32: wraps
    assert ((wide < 0) & (wrapped > 0)).any()
    assert ((wide > 8) & (wrapped < 0)).any()
    payload, offsets, _, _ = gather_strings_case("runs to the last byte",
                                                 257, 8)
    assert offsets[-1] == len(payload)
    payload, offsets, _, valid = gather_strings_case("one source row", 257, 8)
    assert len(offsets) == 2
    assert gather_strings_case("none valid", 257, 8)[3].sum() == 0
    assert gather_strings_case("all valid", 257, 8)[3].all()


def test_ragged_gather_cpu_takes_plain_and_counts_nothing():
    payload, offsets, idx, valid = (
        torch.as_tensor(a) for a in gather_strings_case("mixed", 257, 8))
    cap = bucket_byte_capacity(257 * 8)
    before = SG.gather_strings.launches
    got = SG.gather_strings(payload, offsets, idx, valid, 8, cap)
    want = SG.gather_strings_plain(payload, offsets, idx, valid, 8, cap)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert SG.gather_strings.launches == before


def test_ragged_gather_empty_sides():
    """No source rows: every row empty; no output rows: the trivial
    layout; rows but no payload byte: the char-matrix route raises, and
    so does the plain version."""
    payload, offsets, idx, valid = (
        torch.as_tensor(a) for a in gather_strings_case("mixed", 257, 8))
    cap = bucket_byte_capacity(257 * 8)
    p, o = SG.gather_strings(payload[:0], offsets[:1], idx, valid, 8, cap)
    assert p.shape == (cap,) and not bool(p.any())
    assert o.shape == (258,) and not bool(o.any())
    p, o = SG.gather_strings(payload, offsets, idx[:0], valid[:0], 8, 128)
    assert p.shape == (128,) and not bool(p.any()) and o.tolist() == [0]
    with pytest.raises(IndexError):
        SG.gather_strings(payload[:0], offsets, idx, valid, 8, cap)


@pytest.mark.parametrize("lazy", [False, True])
def test_gather_column_takes_ragged_entry_and_keeps_the_column(
        lazy, monkeypatch):
    """The port's ``gather_column`` on a flat column: one ragged-entry
    call, neither the column's char matrix nor the matrix entry, and the
    column the char-matrix route (``char_matrix``, ``ragged_gather``,
    ``strings_from_matrix``) gives. (On the CPU the ragged entry's plain
    version is that route; the card's kernel builds no matrix.)"""
    _, pb = string_batches(lazy=lazy)
    col = pb.column("f")
    rng = np.random.default_rng(5)
    cap = col.capacity
    idx = torch.as_tensor(rng.integers(-3, cap + 3, 2 * cap).astype(np.int32))
    iv = torch.as_tensor(rng.random(2 * cap) < 0.9)
    safe = idx.clamp(0, cap - 1).long()
    validity = col.validity[safe] & iv
    before = SU.char_matrix(col)
    want = KR.strings_from_matrix(
        SG.ragged_gather(before, safe.to(torch.int32), validity), validity,
        col.max_bytes)
    calls = []
    ragged = SG.gather_strings

    def counted(*args):
        calls.append(args)
        return ragged(*args)

    def refused(*args, **kwargs):
        raise AssertionError("the flat gather built a char matrix")

    monkeypatch.setattr(SG, "gather_strings", counted)
    monkeypatch.setattr(KR, "char_matrix", refused)
    monkeypatch.setattr(SG, "ragged_gather", refused)
    got = KR.gather_column(col, idx, iv)
    assert len(calls) == 1
    assert got.is_flat and got.max_bytes == want.max_bytes
    for g, w in ((got.offsets, want.offsets), (got.data, want.data),
                 (got.validity, want.validity)):
        assert g.dtype == w.dtype and torch.equal(g, w)
