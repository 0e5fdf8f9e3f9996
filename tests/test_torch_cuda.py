"""The CUDA kernels of ``spark_rapids_tpu_torch`` against their plain
PyTorch versions, on the card, and the parquet scan's host snappy and
run-table routines and card decode against their plain and CPU versions
(and the scan with its decode-ahead pipeline on against it off). Every test here needs an NVIDIA GPU and
skips without one; the module imports neither JAX nor the JAX package,
so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` skips the JAX set-up of ``tests/conftest.py``.) The
case builders here are shared with ``tests/test_torch_kernels.py``, which
holds the same plain versions against the JAX package's Pallas kernels.
"""

import threading
from pathlib import Path

import numpy as np
import pytest

import torch

from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.data.column import bucket_byte_capacity
from spark_rapids_tpu_torch.io import parquet_device as PD
from spark_rapids_tpu_torch.io import parquet_meta as M
from spark_rapids_tpu_torch.io import snappy as SN
from spark_rapids_tpu_torch.io import snappy_cases as SC
from spark_rapids_tpu_torch.ops.kernels.cuda import hashing as HK
from spark_rapids_tpu_torch.ops.kernels.cuda import join_probe as JP
from spark_rapids_tpu_torch.ops.kernels.cuda import segmented as SEG
from spark_rapids_tpu_torch.ops.kernels.cuda import sort_steps as SS
from spark_rapids_tpu_torch.ops.kernels.cuda import strings as SG
from spark_rapids_tpu_torch.ops.kernels.cuda.strings_cases import (
    GATHER_CARD_ROWS, GATHER_CASES, GATHER_WIDTHS, gather_strings_case)

JOINPROBE_CASES = ["duplicate keys", "every probed slot empty",
                   "one live row", "all rows dead", "unique keys",
                   "a table of one slot", "every build row unusable",
                   "one slot hit by every row", "only the last rows live",
                   "clustered keys"]
#: Cases outside the Pallas kernel's shapes (it needs build rows).
JOINPROBE_CARD_CASES = JOINPROBE_CASES + ["no build rows"]
SEG_GIDS = ["random groups", "one group", "one group per row", "dead tail",
            "tile boundary", "one group over many tiles", "ids above 0",
            "negative leading ids", "all dead", "no rows"]
#: Rows of the segmented cases: several of the kernel's 1024-row tiles.
N, CAP = 4500, 4800


def joinprobe_case(name: str, cap_b: int = 512, cap_p: int = 1024):
    """(bslot, pslot, tbl) of one joinProbe edge case, int32."""
    rng = np.random.default_rng(len(name))
    tbl = 4 * cap_b
    pslot = rng.integers(0, tbl, cap_p)
    if name == "a table of one slot":
        tbl = 1
        bslot = rng.integers(0, 3, cap_b)  # slot 0, and unusable rows
        pslot = rng.integers(-2, 3, cap_p)
    elif name == "no build rows":
        bslot = np.zeros(0, np.int64)
    elif name == "every build row unusable":  # the sentinel and past it
        bslot = tbl + rng.integers(0, 9, cap_b)
    elif name == "one slot hit by every row":  # the max is cap_b
        bslot = np.full(cap_b, 5)
        pslot[::3] = 5
    elif name == "only the last rows live":  # rows near cap_b - 1
        bslot = np.full(cap_b, tbl)
        bslot[-3:] = [7, 9, 7]
        pslot[:4] = [7, 9, 8, 7]
    elif name == "clustered keys":  # sorted runs of 1-7 rows, 2/5 dead
        runs = np.repeat(np.arange(cap_b), rng.integers(1, 8, cap_b))[:cap_b]
        bslot = np.where(rng.random(cap_b) < 0.4, tbl, runs)
    elif name == "duplicate keys":
        bslot = rng.integers(0, tbl // 2, cap_b)
        bslot[1] = bslot[0]
    elif name == "every probed slot empty":
        bslot = rng.integers(0, tbl // 2, cap_b)
        pslot = rng.integers(tbl // 2, tbl, cap_p)
    elif name == "one live row":
        bslot = np.full(cap_b, tbl)
        bslot[cap_b // 3] = 17
    elif name == "all rows dead":
        bslot = np.full(cap_b, tbl)
    else:  # unique keys, a third dead
        bslot = rng.permutation(tbl)[:cap_b]
        bslot[rng.random(cap_b) < 0.3] = tbl
    return bslot.astype(np.int32), pslot.astype(np.int32), tbl


def segment_gids(name: str, n: int, cap: int) -> np.ndarray:
    """Sorted int32 group ids of one segmented edge case ("no rows" is
    empty; the others have ``n`` rows)."""
    rng = np.random.default_rng(7)
    if name == "no rows":
        return np.zeros(0, np.int32)
    if name == "one group":
        return np.zeros(n, np.int32)
    if name == "one group per row":
        return np.arange(n, dtype=np.int32)
    if name == "all dead":
        return np.full(n, cap, np.int32)
    r = np.arange(n)
    if name == "tile boundary":
        # each 1024-row tile holds two whole groups, the second ending on
        # the tile's last row
        return (2 * (r // 1024) + (r % 1024 >= 1000)).astype(np.int32)
    sizes = rng.integers(1, 9, n)
    g = np.repeat(np.arange(n), sizes)[:n].astype(np.int32)
    if name == "one group over many tiles":
        g = np.where(r < 100, g, g[100])
        g[n - 50:] = g[100] + 1 + np.arange(50) // 3
    elif name == "ids above 0":
        g = g + 5
    elif name == "negative leading ids":
        g = np.where(r < 150, -3, np.where(r < 300, -1, g - g[300]))
    elif name == "dead tail":
        g[-n // 8:] = cap  # the port's sort path sends dead rows here
    return g.astype(np.int32)


def segment_lanes(n: int) -> dict:
    """The lanes each segmented case reduces, by name: 1, 3 and 8 lanes,
    int8/int16 lanes whose sums wrap, floats with +/-0.0 and NaN."""
    rng = np.random.default_rng(11)
    big = 2 ** 62
    f = rng.normal(size=(n, 2))
    f[rng.random((n, 2)) < 0.1] = 0.0
    f[rng.random((n, 2)) < 0.1] = -0.0
    f[rng.random((n, 2)) < 0.02] = np.nan
    f32 = rng.normal(size=(n, 3)).astype(np.float32)
    f32[rng.random((n, 3)) < 0.1] = 0.0
    f32[rng.random((n, 3)) < 0.1] = -0.0
    f32[rng.random((n, 3)) < 0.02] = np.nan
    return {
        "int64 [n]": rng.integers(-big, big, n, dtype=np.int64),
        "int64 [n,3]": rng.integers(-big, big, (n, 3), dtype=np.int64),
        "int64 [n,8]": rng.integers(-big, big, (n, 8), dtype=np.int64),
        "int32 [n]": rng.integers(-2 ** 31, 2 ** 31, n,
                                  dtype=np.int64).astype(np.int32),
        "int8 [n] wrapping sums": rng.integers(60, 128, n).astype(np.int8),
        "int16 [n,8] wrapping sums": rng.integers(
            -32768, -20000, (n, 8)).astype(np.int16),
        "float64 [n,2] +/-0 NaN": f,
        "float32 [n,3] +/-0 NaN": f32,
        "float64 [n] +/-0": np.where(rng.random(n) < 0.5, 0.0, -0.0),
    }


SORT_CASES = ["one lane", "power of two", "power of two plus one",
              "all lanes dead", "random 1000", "descending keys",
              "threshold minus one", "constant lane",
              "only the dead field varies", "date key", "index permutation"]
#: Live radix passes the kernel's plan must choose (the rest sort in one
#: block, or are not fixed by their data).
SORT_PASSES = {"constant lane": 0, "only the dead field varies": 1,
               "date key": 3}


def sort_lane_case(name: str) -> np.ndarray:
    """A unique packed sortStep lane (``rowops.packed_sort_lane``'s
    layout: field, key + 2**31, row index), int64. The sizes straddle
    the kernel's single-block threshold (4096 lanes)."""
    rng = np.random.default_rng(len(name))
    n = {"one lane": 1, "power of two": 4096, "power of two plus one": 4097,
         "all lanes dead": 777, "random 1000": 1000,
         "descending keys": 3000, "threshold minus one": 4095,
         "constant lane": 10_000, "only the dead field varies": 20_000,
         "date key": 50_000, "index permutation": 30_000}[name]
    field = rng.integers(1, 8, n)  # null buckets -3..3 ride as 1..7
    field[rng.random(n) < 0.2] = 8  # dead rows
    if name == "all lanes dead":
        field[:] = 8
    u = rng.integers(0, 2 ** 32, n)
    index = np.arange(n, dtype=np.int64)
    if name == "descending keys":
        field[:] = 4
        u = np.sort(u)[::-1].copy()
    elif name == "constant lane":
        field[:] = 4
        u[:] = 2 ** 31 + 9131
    elif name == "only the dead field varies":
        field = np.where(rng.random(n) < 0.2, 8, 4)
        u[:] = 2 ** 31 + 9131
    elif name == "date key":
        # ~2,500 distinct days (l_shipdate's span), a fifth dead
        field = np.where(rng.random(n) < 0.2, 8, 4)
        u = 2 ** 31 + rng.integers(8036, 10_562, n)
    elif name == "index permutation":
        index = rng.permutation(n).astype(np.int64)
    return (field.astype(np.int64) << 59) | (u.astype(np.int64) << 27) \
        | index


STRING_CASES = ["all valid", "none valid", "indices out of range",
                "more rows out than in", "fewer rows out than in"]


def gather_case(name: str, w: int):
    """(mat int16 [n, w], idx int32 [m], valid bool [m]) of one strings
    gather case: rows of bytes ending in PAD (-1)."""
    rng = np.random.default_rng(len(name) + w)
    n, m = {"more rows out than in": (300, 1000),
            "fewer rows out than in": (1000, 300)}.get(name, (512, 512))
    lens = rng.integers(0, w + 1, n)
    mat = rng.integers(0, 256, (n, w)).astype(np.int16)
    mat[np.arange(w)[None, :] >= lens[:, None]] = -1
    idx = rng.integers(0, n, m)
    if name == "indices out of range":
        idx = rng.integers(-50, n + 50, m)
    valid = rng.random(m) < 0.8
    if name == "all valid":
        valid[:] = True
    elif name == "none valid":
        valid[:] = False
    return mat, idx.astype(np.int32), valid


def row_equal_case(n: int, w: int, seed: int = 0):
    """Two int16 [n, W] char matrices of one rowwise-compare case:
    PAD-ended rows with bytes up to 255, every third row of ``b`` changed
    in one char (its last, or a PAD made a byte, or a byte made PAD),
    and every fifth row of both all PAD."""
    rng = np.random.default_rng(seed + n + w)
    lens = rng.integers(0, w + 1, n)
    lens[::5] = 0
    a = rng.integers(0, 256, (n, w)).astype(np.int16)
    a[np.arange(w)[None, :] >= lens[:, None]] = -1
    b = a.copy()
    rows = np.arange(0, n, 3)
    cols = rng.integers(0, w, len(rows))
    cols[::2] = w - 1
    b[rows, cols] = np.where(b[rows, cols] == -1, 0, -1)
    return a, b


HASH_WIDTHS = [4, 8, 128, 1024]
HASH_ROWS = [1, 255, 257, 4097]


def hash_case(n: int, w: int, seed: int = 0):
    """(mat int16 [n, w], lengths int32 [n], seed int32 [n] as uint32
    bits) of one ``hash`` case: lengths 0-5, W and random, bytes over
    0-255 (the tail's signed bytes included), every eleventh row all
    PAD."""
    rng = np.random.default_rng(seed + 31 * n + w)
    lengths = rng.integers(0, w + 1, n)
    short = rng.random(n) < 0.3
    lengths[short] = rng.integers(0, 6, int(short.sum()))
    lengths[rng.random(n) < 0.1] = w
    lengths = np.minimum(lengths, w)
    lengths[::11] = 0
    mat = rng.integers(0, 256, (n, w)).astype(np.int16)
    mat[np.arange(w)[None, :] >= lengths[:, None]] = -1
    seeds = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    return mat, lengths.astype(np.int32), seeds.view(np.int32)


RAGGED_KINDS = ["dictionary", "flat", "negative lengths"]
RAGGED_WIDTHS = [4, 6, 8, 128]


def ragged_case(kind: str, n: int, w: int, seed: int = 0):
    """(payload uint8, offsets int32, codes int32 or None, seed int32 as
    uint32 bits) of one ragged ``hash`` case: entry lengths 0-5, W and
    past W, random bytes over 0-255, entries starting at unaligned
    payload bytes. A dictionary has a few dozen entries and codes out of
    range on both sides; a flat column is one entry a row, and its
    "negative lengths" variant has offsets that step back."""
    rng = np.random.default_rng(seed + 31 * n + w + len(kind))
    m = n if kind != "dictionary" else 3 + min(n, 40)
    lens = rng.integers(0, w + 1, m)
    pick = rng.random(m)
    lens[pick < 0.3] = rng.integers(0, 6, int((pick < 0.3).sum()))
    lens[(pick >= 0.3) & (pick < 0.4)] = w
    past = (pick >= 0.4) & (pick < 0.5)
    lens[past] = w + rng.integers(1, 10, int(past.sum()))
    offsets = 3 + np.concatenate([[0], np.cumsum(lens)])
    if kind == "negative lengths":
        back = np.flatnonzero(rng.random(m) < 0.2) + 1
        offsets[back] = np.maximum(offsets[back - 1] - rng.integers(
            1, 4, len(back)), 0)
    payload = rng.integers(0, 256, int(offsets.max()) + 5).astype(np.uint8)
    codes = None
    if kind == "dictionary":
        codes = rng.integers(0, m, n)
        wild = rng.random(n) < 0.1
        codes[wild] = rng.integers(-5, m + 5, int(wild.sum()))
        codes = codes.astype(np.int32)
    seeds = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    return payload, offsets.astype(np.int32), codes, seeds.view(np.int32)


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bit for bit (floats compared as their integer bits)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if got.is_floating_point():
        width = {torch.float64: torch.int64, torch.float32: torch.int32}
        return torch.equal(got.contiguous().view(width[got.dtype]),
                           want.contiguous().view(width[want.dtype]))
    return torch.equal(got, want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", JOINPROBE_CARD_CASES)
def test_cuda_joinprobe_matches_plain(cuda_device, name):
    bslot, pslot, tbl = joinprobe_case(name, 4096, 8192)
    b = torch.as_tensor(bslot, device=cuda_device)
    p = torch.as_tensor(pslot, device=cuda_device)
    before = JP.dense_build_probe.launches
    got = JP.dense_build_probe(b, p, tbl)
    assert JP.dense_build_probe.launches == before + 1
    for g, w in zip(got, JP.dense_build_probe_plain(b, p, tbl)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("gname", SEG_GIDS)
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_cuda_segmented_matches_plain(cuda_device, gname, op):
    gid = torch.as_tensor(segment_gids(gname, N, CAP), device=cuda_device)
    for x in segment_lanes(N).values():
        xt = torch.as_tensor(x[:gid.shape[0]], device=cuda_device)
        if not SEG.eligible(xt, op):
            continue
        before = SEG.segment_reduce_sorted.launches
        got = SEG.segment_reduce_sorted(xt, gid, CAP, op)
        assert SEG.segment_reduce_sorted.launches == before + 1
        assert same_bits(got, SEG.segment_reduce_sorted_plain(xt, gid, CAP,
                                                              op))


#: The entry stage at SF1: 6,001,215 rows at capacity 8,388,608, keys from
#: ``entry()``'s 50 values and from orders' 1,500,000.
SF1_ROWS, SF1_CAP = 6_001_215, 1 << 23
KEY_RANGES = [50, 1_500_000]


def sorted_stage_gids(key_range: int, seed: int = 0) -> np.ndarray:
    """int32 group ids of the entry stage's sort path at SF1: the live
    rows' keys sorted and numbered densely, the dead tail at the spare id
    ``SF1_CAP``."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, key_range, SF1_ROWS))
    gid = np.full(SF1_CAP, SF1_CAP, np.int32)
    gid[:SF1_ROWS] = np.unique(keys, return_inverse=True)[1]
    return gid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int64", "float64"])
@pytest.mark.parametrize("key_range", KEY_RANGES)
@pytest.mark.parametrize("op", ["min", "max"])
def test_cuda_segmented_min_max_at_sf1(cuda_device, op, key_range, dtype):
    gid = torch.as_tensor(sorted_stage_gids(key_range), device=cuda_device)
    rng = np.random.default_rng(key_range)
    if dtype == "int64":
        x = rng.integers(1, 1000, SF1_CAP, dtype=np.int64)
    else:
        x = np.round(rng.normal(0, 1e3, SF1_CAP), 2)
        x[rng.random(SF1_CAP) < 0.01] = -0.0
    xt = torch.as_tensor(x, device=cuda_device)
    before = SEG.segment_reduce_sorted.launches
    got = SEG.segment_reduce_sorted(xt, gid, SF1_CAP, op)
    assert SEG.segment_reduce_sorted.launches == before + 1
    assert same_bits(got, SEG.segment_reduce_sorted_plain(xt, gid, SF1_CAP,
                                                          op))


@pytest.mark.cuda
def test_cuda_entry_matches_numpy(cuda_device):
    from spark_rapids_tpu_torch.data.batch import HostBatch
    from spark_rapids_tpu_torch.entry import (entry, entry_columns,
                                              entry_reference)
    forward, (batch,) = entry()
    assert batch.device.type == "cuda"
    before = SEG.segment_reduce_sorted.launches
    out, fail = forward(batch)
    assert fail is None
    assert SEG.segment_reduce_sorted.launches == before + 3
    host = HostBatch.from_device(out)
    want = entry_reference(entry_columns())
    for name, w in want.items():
        assert host.validity[name].all()
        np.testing.assert_array_equal(host.columns[name], w, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SORT_CASES)
def test_cuda_sort_steps_matches_plain(cuda_device, name):
    lane = torch.as_tensor(sort_lane_case(name), device=cuda_device)
    before = SS.packed_argsort.launches
    got = SS.packed_argsort(lane)
    assert SS.packed_argsort.launches == before + 1
    assert torch.equal(got, SS.packed_argsort_plain(lane))
    got, passes = SS.packed_argsort_passes(lane)
    assert torch.equal(got, SS.packed_argsort_plain(lane))
    if name in SORT_PASSES:
        assert passes == SORT_PASSES[name]
    if lane.numel() <= SS.SMALL_LANES:
        assert passes == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4095, 4096, 4097, 8193, 1 << 16, 1_000_003,
                               (1 << 23) + 1])
def test_cuda_sort_steps_random_lanes(cuda_device, n):
    """The general path: index bits a permutation, so every index window
    is sorted too."""
    rng = np.random.default_rng(n)
    lane = (rng.integers(0, 2 ** 35, n).astype(np.int64) << 27) \
        | rng.permutation(n).astype(np.int64)
    lane = torch.as_tensor(lane, device=cuda_device)
    before = SS.packed_argsort.launches
    got = SS.packed_argsort(lane)
    assert SS.packed_argsort.launches == before + 1
    assert torch.equal(got, SS.packed_argsort_plain(lane))


@pytest.mark.cuda
@pytest.mark.parametrize("w", [8, 128])
@pytest.mark.parametrize("name", STRING_CASES)
def test_cuda_strings_gather_matches_plain(cuda_device, name, w):
    mat, idx, valid = (torch.as_tensor(a, device=cuda_device)
                       for a in gather_case(name, w))
    before = SG.ragged_gather.launches
    got = SG.ragged_gather(mat, idx, valid)
    assert SG.ragged_gather.launches == before + 1
    assert torch.equal(got, SG.ragged_gather_plain(mat, idx, valid))


@pytest.mark.cuda
def test_cuda_strings_gather_empty_sides(cuda_device):
    mat = torch.full((0, 128), -1, dtype=torch.int16, device=cuda_device)
    idx = torch.zeros(5, dtype=torch.int32, device=cuda_device)
    valid = torch.ones(5, dtype=torch.bool, device=cuda_device)
    before = SG.ragged_gather.launches
    out = SG.ragged_gather(mat, idx, valid)
    assert out.shape == (5, 128) and bool((out == -1).all())
    empty = SG.ragged_gather(torch.zeros((4, 8), dtype=torch.int16,
                                         device=cuda_device), idx[:0],
                             valid[:0])
    assert empty.shape == (0, 8)
    assert SG.ragged_gather.launches == before


def _gather_args(case, w, device):
    payload, offsets, idx, valid = (torch.as_tensor(a, device=device)
                                    for a in case)
    return (payload, offsets, idx, valid, w,
            bucket_byte_capacity(idx.shape[0] * w))


@pytest.mark.cuda
@pytest.mark.parametrize("w", GATHER_WIDTHS)
@pytest.mark.parametrize("m", GATHER_CARD_ROWS)
@pytest.mark.parametrize("name", GATHER_CASES)
def test_cuda_gather_strings_matches_plain(cuda_device, name, m, w):
    args = _gather_args(gather_strings_case(name, m, w), w, cuda_device)
    before = SG.gather_strings.launches
    payload, offsets = SG.gather_strings(*args)
    assert SG.gather_strings.launches == before + 1
    want_payload, want_offsets = SG.gather_strings_plain(*args)
    assert same_bits(offsets, want_offsets)
    assert same_bits(payload, want_payload)


#: A width past 2^20 bytes: a 1,024-row tile of such rows may hold more
#: than 2^31 bytes, so the kernel sums lengths in int64.
WIDE_GATHER = 1 << 21


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mixed", "negative lengths",
                                  "wrapped lengths"])
def test_cuda_gather_strings_takes_any_width(cuda_device, name):
    args = _gather_args(gather_strings_case(name, 5, WIDE_GATHER),
                        WIDE_GATHER, cuda_device)
    before = SG.gather_strings.launches
    payload, offsets = SG.gather_strings(*args)
    assert SG.gather_strings.launches == before + 1
    want_payload, want_offsets = SG.gather_strings_plain(*args)
    assert same_bits(offsets, want_offsets)
    assert same_bits(payload, want_payload)
    assert int(offsets[-1]) > WIDE_GATHER // 2  # long rows were gathered


@pytest.mark.cuda
def test_cuda_gather_strings_empty_sides(cuda_device):
    payload, offsets, idx, valid, w, cap = _gather_args(
        gather_strings_case("mixed", 300, 8), 8, cuda_device)
    before = SG.gather_strings.launches
    # no output rows: no launch, the trivial layout
    p, o = SG.gather_strings(payload, offsets, idx[:0], valid[:0], w, 128)
    assert SG.gather_strings.launches == before
    assert p.shape == (128,) and not bool(p.any()) and o.tolist() == [0]
    # no source rows: every row empty, as the plain version gives
    empty = (payload[:0], offsets[:1], idx, valid, w, cap)
    p, o = SG.gather_strings(*empty)
    assert SG.gather_strings.launches == before + 1
    wp, wo = SG.gather_strings_plain(*empty)
    assert same_bits(p, wp) and same_bits(o, wo) and not bool(o.any())


@pytest.mark.cuda
def test_cuda_gather_strings_refuses_what_it_cannot_take(cuda_device):
    payload, offsets, idx, valid, w, cap = _gather_args(
        gather_strings_case("mixed", 300, 8), 8, cuda_device)
    before = SG.gather_strings.launches
    with pytest.raises(ValueError, match="payload"):
        SG.gather_strings(payload.to(torch.int16), offsets, idx, valid, w,
                          cap)
    with pytest.raises(ValueError, match="offsets"):
        SG.gather_strings(payload, offsets.long(), idx, valid, w, cap)
    with pytest.raises(ValueError, match="idx"):
        SG.gather_strings(payload, offsets, idx.long(), valid, w, cap)
    with pytest.raises(ValueError, match="valid"):
        SG.gather_strings(payload, offsets, idx, valid[1:], w, cap)
    with pytest.raises(ValueError, match="idx"):
        SG.gather_strings(payload, offsets, idx[::2], valid[::2], w, cap)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        SG.gather_strings(payload, offsets.cpu(), idx, valid, w, cap)
    with pytest.raises(ValueError, match="width"):
        SG.gather_strings(payload, offsets, idx, valid, 0, cap)
    with pytest.raises(ValueError, match="byte_cap"):
        SG.gather_strings(payload, offsets, idx, valid, w, 300 * w - 1)
    with pytest.raises(ValueError, match="payload byte"):
        SG.gather_strings(payload[:0], offsets, idx, valid, w, cap)
    assert SG.gather_strings.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("w", HASH_WIDTHS)
@pytest.mark.parametrize("n", HASH_ROWS)
def test_cuda_hash_matches_plain(cuda_device, n, w):
    mat, lengths, seed = (torch.as_tensor(a, device=cuda_device)
                          for a in hash_case(n, w))
    before = HK.murmur3_bytes_rows.launches
    got = HK.murmur3_bytes_rows(mat, lengths, seed)
    assert HK.murmur3_bytes_rows.launches == before + 1
    assert torch.equal(got, HK.murmur3_bytes_rows_plain(mat, lengths, seed))


@pytest.mark.cuda
def test_cuda_hash_refuses_what_it_cannot_take(cuda_device):
    mat, lengths, seed = (torch.as_tensor(a, device=cuda_device)
                          for a in hash_case(16, 8))
    with pytest.raises(ValueError, match="multiple of 4"):
        HK.murmur3_bytes_rows(mat[:, :6].contiguous(), lengths, seed)
    with pytest.raises(ValueError, match="int16"):
        HK.murmur3_bytes_rows(mat.to(torch.int32), lengths, seed)
    with pytest.raises(ValueError, match="seed"):
        HK.murmur3_bytes_rows(mat, lengths, seed.long())


@pytest.mark.cuda
@pytest.mark.parametrize("w", RAGGED_WIDTHS)
@pytest.mark.parametrize("n", [1, 255, 256, 257, 100_003])
@pytest.mark.parametrize("kind", RAGGED_KINDS)
def test_cuda_hash_string_rows_matches_plain(cuda_device, kind, n, w):
    payload, offsets, codes, seed = ragged_case(kind, n, w)
    args = [None if a is None else torch.as_tensor(a, device=cuda_device)
            for a in (payload, offsets, codes, seed)]
    before = HK.murmur3_string_rows.launches
    got = HK.murmur3_string_rows(*args[:3], w, args[3])
    assert HK.murmur3_string_rows.launches == before + 1
    assert torch.equal(got, HK.murmur3_string_rows_plain(*args[:3], w,
                                                         args[3]))


@pytest.mark.cuda
def test_cuda_hash_string_rows_refuses_what_it_cannot_take(cuda_device):
    payload, offsets, codes, seed = (
        torch.as_tensor(a, device=cuda_device)
        for a in ragged_case("dictionary", 64, 8))
    before = HK.murmur3_string_rows.launches
    assert HK.murmur3_string_rows(payload, offsets, codes[:0], 8,
                                  seed[:0]).shape == (0,)
    assert HK.murmur3_string_rows.launches == before
    with pytest.raises(ValueError, match="payload"):
        HK.murmur3_string_rows(payload.to(torch.int16), offsets, codes, 8,
                               seed)
    with pytest.raises(ValueError, match="codes"):
        HK.murmur3_string_rows(payload, offsets, codes.long(), 8, seed)
    with pytest.raises(ValueError, match="seed"):
        HK.murmur3_string_rows(payload, offsets, codes, 8, seed[1:])
    with pytest.raises(ValueError, match="width"):
        HK.murmur3_string_rows(payload, offsets, codes, 0, seed)
    with pytest.raises(ValueError, match="entry"):
        HK.murmur3_string_rows(payload, offsets[:1], codes, 8, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [8, 12, 128, 1024])
@pytest.mark.parametrize("n", [1, 7, 8191, 100_003])
def test_cuda_row_equal_matches_plain(cuda_device, n, w):
    a, b = (torch.as_tensor(x, device=cuda_device)
            for x in row_equal_case(n, w))
    before = SG.ragged_row_equal.launches
    got = SG.ragged_row_equal(a, b)
    assert SG.ragged_row_equal.launches == before + 1
    assert torch.equal(got, SG.ragged_row_equal_plain(a, b))
    assert torch.equal(SG.ragged_row_equal(a, a),
                       torch.ones(n, dtype=torch.bool, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("w", [8, 12, 128, 1024])
def test_cuda_row_equal_on_row_views(cuda_device, w):
    """``m[1:]`` and ``m[:-1]`` of one matrix, 16-byte aligned rows or
    not, with runs of equal rows."""
    a, _ = row_equal_case(4099, w, seed=1)
    a[100:140] = a[99]
    m = torch.as_tensor(a, device=cuda_device)
    got = SG.ragged_row_equal(m[1:], m[:-1])
    assert torch.equal(got, SG.ragged_row_equal_plain(m[1:], m[:-1]))
    assert bool(got[99:139].all())


@pytest.mark.cuda
def test_cuda_row_equal_empty_and_refused(cuda_device):
    z = torch.zeros((0, 128), dtype=torch.int16, device=cuda_device)
    before = SG.ragged_row_equal.launches
    assert SG.ragged_row_equal(z, z).shape == (0,)
    w0 = torch.zeros((5, 0), dtype=torch.int16, device=cuda_device)
    assert bool(SG.ragged_row_equal(w0, w0).all())
    assert SG.ragged_row_equal.launches == before
    m = torch.zeros((8, 16), dtype=torch.int16, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        SG.ragged_row_equal(m[:, :8], m[:, 8:])
    with pytest.raises(ValueError, match="int16"):
        SG.ragged_row_equal(m.int(), m.int())
    with pytest.raises(ValueError, match="shapes differ"):
        SG.ragged_row_equal(m[1:], m)


# -- the parquet scan's host snappy routine and card decode ---------------------

FIXTURE = Path(__file__).resolve().parent / "data" / "lineitem_fixture.parquet"


@pytest.mark.cuda
def test_cuda_snappy_matches_plain_on_every_tag_kind(cuda_device):
    """The C++ routine (what a scan on the card calls) against the plain
    version: one page list of every tag kind and overlapping copy."""
    src, pages, size, wants = SC.page_batch(SC.valid_cases())
    got = np.zeros(size, np.uint8)
    plain = np.zeros(size, np.uint8)
    before = SN.decompress_pages.launches
    SN.decompress_pages(src, pages, got, cuda_device)
    assert SN.decompress_pages.launches == before + 1
    SN.decompress_pages(src, pages, plain, "cpu")
    assert np.array_equal(got, plain)
    for (_, _, d, n), want in zip(pages.tolist(), wants):
        assert got[d:d + n].tobytes() == want


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SC.malformed_cases()))
def test_cuda_snappy_refuses_malformed_input(cuda_device, name):
    raw = SC.malformed_cases()[name]
    n = SN._varint(raw, 0)[0] if raw and raw[0] != 0xFF else 5
    out = np.zeros(max(n, 1), np.uint8)
    with pytest.raises(SN.SnappyError):
        SN.decompress_pages(np.frombuffer(raw, np.uint8),
                            np.array([[0, len(raw), 0, n]]), out,
                            cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SC.compress_inputs()))
def test_cuda_snappy_compress_matches_plain(cuda_device, name):
    data = SC.compress_inputs()[name]
    got = SN.compress(data, cuda_device)
    assert got == SN.compress_plain(data)
    assert SN.decompress_plain(got, len(data)) == data


@pytest.mark.cuda
def test_cuda_fixture_decode_matches_cpu(cuda_device):
    """Every row group of the committed pyarrow file decoded on the card
    equals its CPU decode."""
    path = str(FIXTURE)
    meta = M.read_footer(path)
    schema = M.schema_from_parquet(meta, path)
    for rg in range(meta.num_row_groups):
        card = HostBatch.from_device(PD.decode_row_group(
            path, rg, schema, meta, device=cuda_device))
        cpu = HostBatch.from_device(PD.decode_row_group(
            path, rg, schema, meta, device="cpu"))
        for name in cpu.columns:
            assert np.array_equal(card.validity[name], cpu.validity[name])
            valid = cpu.validity[name]
            a, b = np.asarray(card.columns[name]), np.asarray(cpu.columns[name])
            assert list(a[valid]) == list(b[valid]), name


@pytest.mark.cuda
def test_cuda_read_parquet_defaults_to_the_card(cuda_device):
    from spark_rapids_tpu_torch.session import TorchSession
    df = TorchSession().read.parquet(str(FIXTURE))
    before = SN.decompress_pages.launches
    got = df.collect()
    assert SN.decompress_pages.launches > before
    assert got.num_rows == 4 * 4096


def _host_rows(hb) -> list:
    """A collected result's rows as tuples, None under a null."""
    names = list(hb.columns)
    cols = [[v if ok else None for v, ok in zip(hb.columns[n],
                                                  hb.validity[n])]
            for n in names]
    return list(zip(*cols))


def _join_frames(session, seed: int = 5):
    """A probe side with a two-key (int64, int32) reference into a build
    side whose single key ``b`` is unique, with null and unmatched keys."""
    rng = np.random.default_rng(seed)
    n_p, n_b = 50_000, 20_000
    pk = rng.integers(0, 25_000, n_p).astype(np.int64)
    probe = HostBatch.from_numpy(
        {"pk": pk, "pk2": (pk % 7).astype(np.int32),
         "pv": rng.integers(0, 1000, n_p).astype(np.int64)},
        validity={"pk": rng.random(n_p) > 0.05})
    bk = rng.permutation(n_b).astype(np.int64)
    build = HostBatch.from_numpy(
        {"b": bk, "b2": (bk % 7).astype(np.int64),
         "bv": rng.integers(0, 1000, n_b).astype(np.int64)},
        validity={"b2": rng.random(n_b) > 0.05})
    return session.create_dataframe(probe), session.create_dataframe(build)


@pytest.mark.cuda
@pytest.mark.parametrize("keys", ["one key (dense left join)",
                                  "two keys of mixed width (exact)"])
def test_cuda_left_and_multi_key_joins_match_cpu(cuda_device, keys):
    from spark_rapids_tpu_torch.ops import predicates as P
    from spark_rapids_tpu_torch.ops.expression import col
    from spark_rapids_tpu_torch.ops.kernels import join as KJ
    from spark_rapids_tpu_torch.session import TorchSession
    on = P.EqualTo(col("pk"), col("b"))
    if keys.startswith("two"):
        on = P.And(on, P.EqualTo(col("pk2"), col("b2")))
    results, calls = {}, {"dense": 0, "general": 0}
    dense, general = KJ.dense_join, KJ.join_match

    def count(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    KJ.dense_join = count("dense", dense)
    KJ.join_match = count("general", general)
    try:
        for dev in ("cuda", "cpu"):
            p, b = _join_frames(TorchSession(device=dev))
            before = JP.dense_build_probe.launches
            for how in ("left", "inner"):
                results[dev, how] = sorted(
                    _host_rows(p.join(b, on=on, how=how).collect()),
                    key=repr)
            if dev == "cuda" and keys.startswith("one"):
                assert JP.dense_build_probe.launches > before
    finally:
        KJ.dense_join, KJ.join_match = dense, general
    for how in ("left", "inner"):
        assert results["cuda", how] == results["cpu", how], how
    assert len(results["cpu", "left"]) == 50_000
    assert calls["dense" if keys.startswith("one") else "general"] > 0


@pytest.mark.cuda
def test_cuda_window_query_matches_cpu(cuda_device):
    from spark_rapids_tpu_torch.ops import aggregates as A
    from spark_rapids_tpu_torch.ops.expression import col
    from spark_rapids_tpu_torch.ops.windows import (DenseRank, RowNumber,
                                                    Window, over)
    from spark_rapids_tpu_torch.plan.logical import SortOrder
    from spark_rapids_tpu_torch.session import TorchSession
    rng = np.random.default_rng(11)
    n = 100_000
    data = {"k": rng.integers(0, 900, n).astype(np.int64),
            "t": rng.integers(0, 5_000, n).astype(np.int64),
            "v": rng.integers(-100, 100, n).astype(np.int64)}
    valid = {"k": rng.random(n) > 0.02, "v": rng.random(n) > 0.1}
    w = Window.partition_by("k").order_by(SortOrder(col("t")))
    results = {}
    for dev in ("cuda", "cpu"):
        df = TorchSession(device=dev).create_dataframe(
            HostBatch.from_numpy(data, validity=valid))
        results[dev] = _host_rows(df.with_windows(
            rn=RowNumber().over(w), dr=DenseRank().over(w),
            run=over(A.Sum(col("v")),
                     w.rows_between(Window.unbounded_preceding,
                                    Window.current_row)),
            near=over(A.Max(col("v")), w.range_between(-50, 50)),
            cnt=over(A.Count(col("v")), w)).collect())
    assert results["cuda"] == results["cpu"]


@pytest.mark.cuda
def test_cuda_read_parquet_pipeline_on_equals_off(cuda_device):
    """The fixture's four row groups scanned on the card with the
    pipeline on (host phases on the pool, pinned staging handed to the
    consumer's stream) equal the same scan with it off, bit for bit, and
    the pool leaves no worker after ``close``."""
    from spark_rapids_tpu_torch.exec import pipeline as PL
    from spark_rapids_tpu_torch.session import TorchSession
    got = {}
    for on in (True, False):
        s = TorchSession({"spark.rapids.tpu.pipeline.enabled": on})
        got[on] = s.read.parquet(str(FIXTURE)).collect()
        assert ("ParquetScanExec.busy" in s.last_query.exec_ms) == on
        assert s.close() == []
    assert not [t for t in threading.enumerate()
                if t.name.startswith(PL.THREAD_PREFIX) and t.is_alive()]
    a, b = got[True], got[False]
    assert list(a.columns) == list(b.columns) and a.num_rows == b.num_rows
    for name in a.columns:
        assert np.array_equal(a.validity[name], b.validity[name]), name
        x, y = np.asarray(a.columns[name]), np.asarray(b.columns[name])
        if x.dtype.kind == "f":  # bit for bit
            x, y = x.view(f"i{x.itemsize}"), y.view(f"i{y.itemsize}")
        valid = a.validity[name]
        assert list(x[valid]) == list(y[valid]), name


@pytest.mark.cuda
def test_cuda_parse_hybrid_matches_plain_on_the_fixture(cuda_device):
    """Every level and index stream of the fixture sliced by the host C++
    routine equals the plain ``parse_hybrid``'s run tables."""
    path = str(FIXTURE)
    meta = M.read_footer(path)
    schema = M.schema_from_parquet(meta, path)
    before = PD.parse_hybrid_native.launches
    for rg in range(meta.num_row_groups):
        a = PD.read_row_group_host(path, rg, schema, meta, device="cuda",
                                   native_runs=False)
        b = PD.read_row_group_host(path, rg, schema, meta, device="cuda",
                                   native_runs=True)
        assert a.handles == b.handles
        assert torch.equal(a.tables, b.tables)
    assert PD.parse_hybrid_native.launches > before
