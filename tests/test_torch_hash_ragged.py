"""The ``hash`` kernel's ragged entry against the JAX package, on the CPU.

``murmur3_string_rows`` hashes a string column from its own layout (a
dictionary's entry bytes and codes, a flat column's payload and
offsets). Its plain version must equal, bit for bit, the JAX package's
murmur3 (the jnp version and the Pallas kernel in interpret mode) over
the char matrix and lengths the JAX package builds for the same column:
dictionary and flat columns, codes out of range, lengths past the
matrix's width (clipped) and negative lengths (the cases
``tests/test_torch_cuda.py`` runs on the card). ``spark_hash_columns_device``
takes the ragged entry for every string key, and its hashes and
partition ids equal the reference's.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.data.column import DeviceColumn as RColumn
from spark_rapids_tpu.ops import strings_util as RSU
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.kernels import pallas as PAL
from spark_rapids_tpu.ops.kernels.pallas import hashing as RH
from spark_rapids_tpu.shuffle import partitioners as RPR
from spark_rapids_tpu.shuffle import partitioning as RPN

from spark_rapids_tpu_torch.ops.kernels.cuda import hashing as HK
from spark_rapids_tpu_torch.shuffle import partitioning as PN
from test_torch_cuda import RAGGED_KINDS, RAGGED_WIDTHS, ragged_case
from test_torch_strings import batches as string_batches

PALLAS = PAL.PallasConf(enabled=True)


def _reference_matrix(payload, offsets, codes, w):
    """The JAX package's ``char_matrix`` and ``lengths`` of the layout,
    as a reference column."""
    n = len(offsets) - 1 if codes is None else len(codes)
    col = RColumn(data=jnp.asarray(payload),
                  validity=jnp.ones(n, jnp.bool_), dtype=RT.STRING,
                  offsets=jnp.asarray(offsets), max_bytes=w,
                  codes=None if codes is None else jnp.asarray(codes))
    return RSU.char_matrix(col, w), RSU.lengths(col)


def _plain(payload, offsets, codes, w, seed) -> np.ndarray:
    got = HK.murmur3_string_rows(
        torch.as_tensor(payload), torch.as_tensor(offsets),
        None if codes is None else torch.as_tensor(codes), w,
        torch.as_tensor(seed))
    assert got.dtype == torch.int32
    return got.numpy().view(np.uint32)


@pytest.mark.parametrize("w", RAGGED_WIDTHS)
@pytest.mark.parametrize("kind", RAGGED_KINDS)
def test_ragged_plain_matches_reference(kind, w):
    payload, offsets, codes, seed = ragged_case(kind, 300, w)
    mat, lengths = _reference_matrix(payload, offsets, codes, w)
    want = RPN.murmur3_bytes_rows(jnp, mat, lengths,
                                  jnp.asarray(seed.view(np.uint32)))
    np.testing.assert_array_equal(_plain(payload, offsets, codes, w, seed),
                                  np.asarray(want))


@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("kind", RAGGED_KINDS)
def test_ragged_plain_matches_pallas(kind, w):
    payload, offsets, codes, seed = ragged_case(kind, 300, w)
    mat, lengths = _reference_matrix(payload, offsets, codes, w)
    want = RH.murmur3_bytes_rows(mat, lengths.astype(jnp.int32),
                                 jnp.asarray(seed.view(np.uint32)))
    np.testing.assert_array_equal(_plain(payload, offsets, codes, w, seed),
                                  np.asarray(want))


def test_ragged_cases_reach_their_edges():
    """The cases hold what the tests above claim to cover."""
    payload, offsets, codes, _ = ragged_case("dictionary", 300, 8)
    lens = np.diff(offsets)
    assert (lens > 8).any() and (lens == 8).any() and (lens == 0).any()
    assert (codes < 0).any() and (codes >= len(lens)).any()
    assert (offsets[:-1] % 4 != 0).any()
    _, offsets, _, _ = ragged_case("negative lengths", 300, 8)
    assert (np.diff(offsets) < 0).any()


def test_ragged_cpu_takes_plain_and_counts_nothing():
    payload, offsets, codes, seed = (
        None if a is None else torch.as_tensor(a)
        for a in ragged_case("dictionary", 100, 8))
    before = HK.murmur3_string_rows.launches
    got = HK.murmur3_string_rows(payload, offsets, codes, 8, seed)
    assert torch.equal(got, HK.murmur3_string_rows_plain(payload, offsets,
                                                         codes, 8, seed))
    assert HK.murmur3_string_rows.launches == before


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("keys", [["s"], ["f"], ["f", "s"], ["s", "f"]],
                         ids="+".join)
def test_string_key_hashes_and_ids_match_reference(keys, lazy,
                                                   monkeypatch):
    """Dictionary ``s`` and flat ``f`` keys with nulls: every string key
    takes the ragged entry once and the matrix entry never; the hashes
    equal the reference's jnp and Pallas ones, the ids its
    partitioner's."""
    rb, pb = string_batches(lazy=lazy)
    calls = []
    ragged = HK.murmur3_string_rows

    def counted(*args):
        calls.append(args)
        return ragged(*args)

    def refused(*args):
        raise AssertionError("the hash path built a char matrix")

    monkeypatch.setattr(HK, "murmur3_string_rows", counted)
    monkeypatch.setattr(HK, "murmur3_bytes_rows", refused)
    got = PN.spark_hash_columns_device([pb.column(k) for k in keys])
    assert len(calls) == len(keys)
    rcols = [rb.column(k) for k in keys]
    for pallas in (None, PALLAS):
        want = RPN.spark_hash_columns_device(rcols, pallas=pallas)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref = RPR.HashPartitioner([rcol(k) for k in keys], 7, rb.schema)
    np.testing.assert_array_equal(PN.pmod_partition(got, 7).numpy(),
                                  np.asarray(ref.device_ids(rb)))
