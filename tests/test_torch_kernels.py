"""The port's kernel modules against the JAX package's Pallas kernels.

Each plain PyTorch version in ``spark_rapids_tpu_torch/ops/kernels/cuda``
is what a CPU tensor runs and what the CUDA kernel is held against on
the card. Here it is held against the reference's Pallas wrapper run in
interpret mode (as ``tests/test_pallas_kernels.py`` runs it), or against
the reference's own oracle (``jax.ops.segment_*``) where an input lies
outside the Pallas kernel's contract, on the edge cases ``chip_smoke.py``
uses on the card. Every result here is compared bit for bit: integer
lanes are exact, and float min/max pick one of their inputs.

The CUDA launch path itself needs the card: ``tests/test_torch_cuda.py``
holds the kernels against these plain versions there, on the same cases.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spark_rapids_tpu.ops.kernels import pallas as PAL
from spark_rapids_tpu.ops.kernels.pallas import join_probe as RJP
from spark_rapids_tpu.ops.kernels.pallas import segmented as RSEG
from spark_rapids_tpu_torch.ops.kernels.cuda import join_probe as JP
from spark_rapids_tpu_torch.ops.kernels.cuda import segmented as SEG
from test_torch_cuda import (CAP, JOINPROBE_CASES, N, SEG_GIDS,
                             joinprobe_case, segment_gids, segment_lanes)

CONF = PAL.PallasConf(enabled=True)


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype == np.float64:
        return a.view(np.int64)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a


def _same_bits(got: torch.Tensor, want) -> None:
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
    # NaN compares by value class: both canonical quiet NaNs.
    nan = np.isnan(g) if g.dtype.kind == "f" else np.zeros(g.shape, bool)
    assert np.array_equal(nan, np.isnan(w) if w.dtype.kind == "f" else nan)
    np.testing.assert_array_equal(_bits(g)[~nan], _bits(w)[~nan])


# --------------------------------------------------------------------------
# joinProbe
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", JOINPROBE_CASES)
def test_joinprobe_plain_matches_pallas(name):
    bslot, pslot, tbl = joinprobe_case(name)
    want = RJP.dense_build_probe(jnp.asarray(bslot), jnp.asarray(pslot), tbl,
                                 CONF)
    assert want is not None
    got = JP.dense_build_probe(torch.as_tensor(bslot), torch.as_tensor(pslot),
                               tbl)
    for g, w in zip(got, want):
        _same_bits(g, w)


def test_joinprobe_cpu_takes_plain_and_counts_nothing():
    bslot, pslot, tbl = joinprobe_case("unique keys")
    before = JP.dense_build_probe.launches
    got = JP.dense_build_probe(torch.as_tensor(bslot), torch.as_tensor(pslot),
                               tbl)
    want = JP.dense_build_probe_plain(torch.as_tensor(bslot),
                                      torch.as_tensor(pslot), tbl)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert JP.dense_build_probe.launches == before


def test_joinprobe_plain_with_no_build_rows():
    """Every probe finds an empty slot and the max is 0 (a shape the
    Pallas kernel does not take)."""
    _, pslot, tbl = joinprobe_case("no build rows")
    cnt, row, mx = JP.dense_build_probe(torch.zeros(0, dtype=torch.int32),
                                        torch.as_tensor(pslot), tbl)
    assert not bool(cnt.any()) and int(mx) == 0
    assert bool((row == JP.INT32_MAX).all()) and row.shape == pslot.shape


def test_joinprobe_plain_drops_out_of_range_build_slots():
    # Slots outside [0, tbl] land in the spare slot, which no probe reads.
    bslot, pslot, tbl = joinprobe_case("unique keys")
    wild = bslot.copy()
    wild[::7] = -5
    wild[1::7] = tbl + 9
    dead = np.where((wild < 0) | (wild > tbl), tbl, wild).astype(np.int32)
    got = JP.dense_build_probe_plain(torch.as_tensor(wild),
                                     torch.as_tensor(pslot), tbl)
    want = JP.dense_build_probe_plain(torch.as_tensor(dead),
                                      torch.as_tensor(pslot), tbl)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# --------------------------------------------------------------------------
# segmented
# --------------------------------------------------------------------------


#: Group ids outside the Pallas kernel's contract (ids in [0, capacity),
#: at least one row): its oracle, ``jax.ops.segment_*``, drops the rest.
_ORACLE_GIDS = ("dead tail", "negative leading ids", "all dead", "no rows")


@pytest.mark.parametrize("gname", SEG_GIDS)
@pytest.mark.parametrize("lname", list(segment_lanes(8)))
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_segmented_plain_matches_reference(gname, lname, op):
    gid = segment_gids(gname, N, CAP)
    x = segment_lanes(N)[lname][:len(gid)]
    xt = torch.as_tensor(x)
    if not SEG.eligible(xt, op):
        # float sums: the reference refuses them too (float-sum-order).
        assert op == "sum" and x.dtype.kind == "f"
        assert RSEG.segment_reduce_sorted(jnp.asarray(x), jnp.asarray(gid),
                                          CAP, op, CONF) is None
        with pytest.raises(ValueError):
            SEG.segment_reduce_sorted(xt, torch.as_tensor(gid), CAP, op)
        return
    if gname in _ORACLE_GIDS:
        f = {"sum": jax.ops.segment_sum, "min": jax.ops.segment_min,
             "max": jax.ops.segment_max}[op]
        want = f(jnp.asarray(x), jnp.asarray(gid), num_segments=CAP)
    else:
        want = RSEG.segment_reduce_sorted(jnp.asarray(x), jnp.asarray(gid),
                                          CAP, op, CONF)
    got = SEG.segment_reduce_sorted(xt, torch.as_tensor(gid), CAP, op)
    _same_bits(got, want)


def test_segmented_refuses_bool_lanes_like_reference():
    x = np.ones(256, bool)
    gid = np.arange(256, dtype=np.int32)
    assert RSEG.segment_reduce_sorted(jnp.asarray(x), jnp.asarray(gid), 256,
                                      "max", CONF) is None
    assert not SEG.eligible(torch.as_tensor(x), "max")
