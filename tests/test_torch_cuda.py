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


@pytest.mark.cuda
def test_cuda_full_join_returns_unmatched_build_rows(cuda_device):
    """A full outer join with 300,000 build rows (far past what a
    direct-address table takes at once; a full join never takes one) on
    the card: every output batch lies on the card, no ``joinProbe``
    launches, the answer equals the CPU's row for row, and the build rows
    that matched nothing come last, null on the probe side."""
    from spark_rapids_tpu_torch.exec import execs as E
    from spark_rapids_tpu_torch.ops import predicates as P
    from spark_rapids_tpu_torch.ops.expression import col
    from spark_rapids_tpu_torch.session import TorchSession
    rng = np.random.default_rng(13)
    n_p, n_b = 100_000, 300_000
    probe = {"pk": rng.integers(0, 400_000, n_p).astype(np.int64),
             "a": np.arange(n_p, dtype=np.int64)}
    build = {"bk": rng.integers(0, 400_000, n_b).astype(np.int64),
             "b": np.arange(n_b, dtype=np.int64)}
    pvalid = {"pk": rng.random(n_p) > 0.05}
    bvalid = {"bk": rng.random(n_b) > 0.05}
    results = {}
    for dev in ("cuda", "cpu"):
        s = TorchSession(device=dev)
        df = s.create_dataframe(HostBatch.from_numpy(probe, validity=pvalid)
                                ).join(
            s.create_dataframe(HostBatch.from_numpy(build, validity=bvalid)),
            on=P.EqualTo(col("pk"), col("bk")), how="full")
        if dev == "cuda":
            before = JP.dense_build_probe.launches
            [batches] = s.plan(df._plan).execute(E.ExecContext(cuda_device))
            assert len(batches) == 2
            assert all(c.validity.device.type == "cuda"
                       for b in batches for c in b.columns)
            assert JP.dense_build_probe.launches == before
        results[dev] = _host_rows(df.collect())
    assert results["cuda"] == results["cpu"]
    rows = results["cuda"]  # (pk, a, bk, b)
    tail = [i for i, r in enumerate(rows) if r[1] is None]
    assert tail and tail == list(range(tail[0], len(rows)))
    hit = set(np.asarray(probe["pk"])[pvalid["pk"]].tolist())
    want = [int(b) for b, k, ok in zip(build["b"], build["bk"], bvalid["bk"])
            if not (ok and int(k) in hit)]
    assert [rows[i][3] for i in tail] == want


@pytest.mark.cuda
def test_cuda_using_semi_and_anti_joins_on_three_keys_match_cpu(cuda_device):
    """q38's and q87's joins on the card: ``distinct`` (last name, first
    name, date) triples of two string dictionaries (different entries on
    each side) and a DATE, left semi and left anti joined ``USING`` all
    three (``join(on=[names])``), with null names; every output column
    lies on the card and the rows equal the CPU's."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exec import execs as E
    from spark_rapids_tpu_torch.session import TorchSession
    rng = np.random.default_rng(38)
    last = np.array(["Smith", "Johnson", "Brown", "Jones", "Miller", "Davis"])
    first = np.array(["James", "Mary", "John", "Linda", "Robert"])
    schema = T.Schema([T.StructField("c_last_name", T.STRING),
                       T.StructField("c_first_name", T.STRING),
                       T.StructField("d_date", T.DATE)])

    def side(n, names):
        data = {"c_last_name": names[rng.integers(0, len(names), n)],
                "c_first_name": first[rng.integers(0, len(first), n)],
                "d_date": rng.integers(10_000, 10_365, n).astype(np.int32)}
        valid = {"c_last_name": rng.random(n) > 0.02}
        return HostBatch.from_numpy(data, schema, valid)
    left, right = side(400_000, last), side(150_000, last[2:])
    keys = ["c_last_name", "c_first_name", "d_date"]
    results = {}
    for dev in ("cuda", "cpu"):
        s = TorchSession(device=dev)
        a = s.create_dataframe(left).distinct()
        b = s.create_dataframe(right).distinct()
        for how in ("left_semi", "left_anti"):
            df = a.join(b, on=keys, how=how)
            if dev == "cuda":
                parts = s.plan(df._plan).execute(E.ExecContext(cuda_device))
                assert all(c.validity.device.type == "cuda"
                           for part in parts for batch in part
                           for c in batch.columns)
            results[dev, how] = sorted(_host_rows(df.collect()), key=repr)
    for how in ("left_semi", "left_anti"):
        assert results["cuda", how] == results["cpu", how], how
        assert results["cpu", how], how
    assert any(r[0] is None for r in results["cpu", "left_anti"])


# --------------------------------------------------------------------------
# Mortgage and the expression library: the card against the port's CPU
# path (the kernels' plain versions), the same tables on both.
# --------------------------------------------------------------------------


def _sorted_rows(hb, floats=()):
    """Rows of a collected batch, floats rounded to 9 significant
    digits (sums add in atomic order on the card), in a fixed order."""
    names = list(hb.columns)
    rows = []
    for i in range(len(hb.columns[names[0]])):
        row = []
        for n in names:
            v = hb.columns[n][i] if hb.validity[n][i] else None
            v = v.item() if hasattr(v, "item") else v
            if n in floats and v is not None:
                v = float(f"{v:.9g}")
            row.append(v)
        rows.append(tuple(row))
    return sorted(rows, key=repr)


@pytest.mark.cuda
@pytest.mark.parametrize("q", ["etl", "ml_features"])
def test_cuda_mortgage_matches_cpu(cuda_device, q):
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.workloads import mortgage
    tables = mortgage.gen_tables(1 << 16, seed=7)
    floats = ("risk_upb", "avg_rate", "recent_upb")
    got = {}
    for dev in ("cuda", "cpu"):
        dfs = mortgage.load(TorchSession(device=dev), tables)
        got[dev] = _sorted_rows(getattr(mortgage, q)(dfs).collect(), floats)
    assert got["cuda"] == got["cpu"] and got["cpu"]


def _expression_frame(session):
    from spark_rapids_tpu_torch.ops.expression import col, lit
    from spark_rapids_tpu_torch.ops.strings import Substring
    rng = np.random.default_rng(77)
    n = 20_000
    words = np.array(["  ab c ", "abc", "", "naïve café", "aaaa", "123",
                      "2020-02-29 10:11:12", " -42 ", "x.y.z"])
    data = {"s": words[rng.integers(0, len(words), n)],
            "k": rng.integers(-50, 50, n),
            "x": np.where(rng.random(n) < 0.1, np.nan, rng.normal(0, 9, n))}
    valid = {"s": rng.random(n) > 0.1, "k": rng.random(n) > 0.05}
    df = session.create_dataframe(HostBatch.from_numpy(data,
                                                       validity=valid))
    return df.with_column("f", Substring(col("s"), lit(1), lit(64)))


def _family_exprs():
    """One expression (or aggregate) of each family of the library."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.ops import aggregates as A
    from spark_rapids_tpu_torch.ops import bitwise as B
    from spark_rapids_tpu_torch.ops import cast as CA
    from spark_rapids_tpu_torch.ops import conditional as C
    from spark_rapids_tpu_torch.ops import datetime as D
    from spark_rapids_tpu_torch.ops import predicates as P
    from spark_rapids_tpu_torch.ops import strings as S
    from spark_rapids_tpu_torch.ops import strings2 as S2
    from spark_rapids_tpu_torch.ops.expression import col, lit
    return {
        "conditional": [C.CaseWhen([(P.LessThan(col("k"), lit(0)),
                                     col("f")),
                                    (P.LessThan(col("k"), lit(25)),
                                     lit("mid"))], col("s")),
                        C.NaNvl(col("x"), lit(-1.0))],
        "predicates": [P.EqualNullSafe(col("f"), col("s")),
                       P.AtLeastNNonNulls(2, col("s"), col("k"), col("x"))],
        "bitwise": [B.ShiftRightUnsigned(col("k"), lit(33)),
                    B.BitwiseXor(col("k"), lit(0x5A))],
        "strings": [S.Upper(S.ConcatStrings(col("f"), lit("-"), col("s"))),
                    S.StringTrim(col("f")), S.Length(col("s"))],
        "casts": [CA.Cast(col("f"), T.LONG), CA.Cast(col("s"), T.DOUBLE),
                  CA.Cast(col("k"), T.STRING)],
        "datetime": [D.UnixTimestamp(col("f")),
                     D.FromUnixTime(B.ShiftLeft(col("k"), lit(24)))],
        "strings2": [S2.StringReplace(col("f"), "a", "<>"),
                     S2.LPad(col("s"), 6, "xy"),
                     S2.SubstringIndex(col("f"), ".", -2)],
        "string_aggs": [A.AggregateExpression(A.Min(col("f")), "mn"),
                        A.AggregateExpression(A.Max(col("s")), "mx"),
                        A.AggregateExpression(A.First(col("f")), "fi"),
                        A.AggregateExpression(A.Last(col("f")), "la")],
    }


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["conditional", "predicates", "bitwise",
                                    "strings", "casts", "datetime",
                                    "strings2", "string_aggs"])
def test_cuda_expression_family_matches_cpu(cuda_device, family):
    from spark_rapids_tpu_torch.ops.expression import col
    from spark_rapids_tpu_torch.session import TorchSession
    got = {}
    for dev in ("cuda", "cpu"):
        df = _expression_frame(TorchSession(device=dev))
        exprs = _family_exprs()[family]
        if family == "string_aggs":
            out = df.group_by(col("k")).agg(*exprs)
        else:
            out = df.select(col("k"), *[e.alias(f"e{i}")
                                        for i, e in enumerate(exprs)])
        got[dev] = _sorted_rows(out.collect())
    assert got["cuda"] == got["cpu"] and got["cpu"]


@pytest.mark.cuda
def test_cuda_generate_matches_cpu(cuda_device, monkeypatch):
    """``posexplode_outer`` over a batch with a flat string column and a
    struct with a flat string field, across tile boundaries (the lane
    bound lowered so 3,000 rows take three tiles): on the card, bit for
    bit the same plan on the CPU, the parents through the ragged
    ``strings`` gather."""
    from spark_rapids_tpu_torch.exec import execs as E
    from spark_rapids_tpu_torch.exec import generate_cases as GC
    from spark_rapids_tpu_torch.session import TorchSession
    monkeypatch.setattr(E.GenerateExec, "TILE_LANES", GC.TILE_LANES)
    table = GC.generate_table()
    before = SG.gather_strings.launches
    got = GC.generate_query(TorchSession(device="cuda"), table).collect()
    assert SG.gather_strings.launches > before
    want = GC.generate_query(TorchSession(device="cpu"), table).collect()
    assert got.schema.names == want.schema.names
    for name in got.schema.names:
        g, w = got.columns[name], want.columns[name]
        assert np.array_equal(got.validity[name], want.validity[name])
        assert len(g) == len(w) and all(
            repr(a) == repr(b) for a, b in zip(g.tolist(), w.tolist())), name


def _ds_q3_frames(session):
    from spark_rapids_tpu_torch.workloads import tpcds
    return tpcds.load(session, tpcds.gen_tables(1 << 16, seed=11))


@pytest.mark.cuda
def test_cuda_profile_counts_joinprobe_launches_and_device_time(cuda_device):
    """TPC-DS q3 (dense dimension joins) profiled under deviceTiming: the
    profile's ``joinProbe`` launches equal the wrapper's count over the
    query, and their device time is over 0."""
    from spark_rapids_tpu_torch.ops.kernels.cuda import FAMILIES, stats
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.workloads import tpcds
    s = TorchSession({"spark.rapids.tpu.metrics.deviceTiming": True})
    dfs = _ds_q3_frames(s)
    before = stats()["launches"]
    jp = JP._COUNTED.launches
    tpcds.QUERIES["q3"](dfs).collect()
    after = stats()["launches"]
    kernels = s.last_query_profile().engine["cuda"]["kernels"]
    assert kernels["joinProbe"]["launches"] == JP._COUNTED.launches - jp > 0
    assert kernels["joinProbe"]["deviceTimeNs"] > 0
    assert {k: v["launches"] for k, v in kernels.items()} == {
        f: after[f] - before[f] for f in FAMILIES if after[f] > before[f]}


@pytest.mark.cuda
def test_cuda_traced_query_has_a_balanced_tree(cuda_device, tmp_path):
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.workloads import tpcds
    s = TorchSession({"spark.rapids.tpu.trace.enabled": True,
                      "spark.rapids.tpu.trace.dir": str(tmp_path)})
    tpcds.QUERIES["q3"](_ds_q3_frames(s)).collect()
    tr = s.last_trace()
    tr.assert_balanced()
    names = {sp["name"] for sp in tr.spans}
    assert {"session.query", "session.plan", "session.dispatch"} <= names
    assert list(tmp_path.glob("trace_*.json"))


@pytest.mark.cuda
def test_cuda_answers_equal_at_metrics_none_and_default(cuda_device):
    """TPC-DS q3 at metrics level NONE and at the default: the same rows,
    keys and strings equal, the float sums to rtol 1e-9, since the card
    adds them in atomic order, whose last bits vary from run to run at
    any level (``ROADMAP.md`` C)."""
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.workloads import tpcds
    got = {}
    for level in ("NONE", "MODERATE"):
        s = TorchSession({"spark.rapids.tpu.metrics.level": level})
        got[level] = _host_rows(tpcds.QUERIES["q3"](
            _ds_q3_frames(s)).collect())
        assert (s.last_query_profile() is None) == (level == "NONE")
    assert len(got["NONE"]) == len(got["MODERATE"]) > 0
    for a, b in zip(got["NONE"], got["MODERATE"]):
        assert a[:3] == b[:3]
        assert abs(a[3] - b[3]) <= 1e-9 * abs(b[3])


@pytest.mark.cuda
def test_cuda_crc32c_routine_matches_plain(cuda_device):
    """The C++ CRC32C (SSE4.2 where the host has it, and its
    slicing-by-8 path) against the plain version on random buffers of
    0-65,537 bytes and around the 8 MiB split into threads, with
    continuation, and the check vector."""
    from spark_rapids_tpu_torch.utils import checksum as CK
    rng = np.random.default_rng(19)
    before = CK._COUNTED.launches
    # from 8 MiB up the buffer is cut into pieces on several threads
    for n in list(rng.integers(0, 65_538, 60)) + [0, 1, 7, 8, 12_288,
                                                  12_289, 1 << 20,
                                                  (8 << 20) - 1, 8 << 20,
                                                  20_000_003]:
        buf = rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
        value = int(rng.integers(0, 1 << 32))
        want = CK.crc32c_plain(buf, value)
        assert CK.crc32c_native(buf, value) == want
        assert CK.crc32c_native(buf, value, tables_only=True) == want
    assert CK.crc32c(b"123456789", device=cuda_device) == 0xE3069283
    assert CK._COUNTED.launches > before


@pytest.mark.cuda
def test_cuda_catalog_round_trip_through_pinned_host_and_disk(cuda_device,
                                                              tmp_path):
    """A card batch (fixed, dictionary and flat strings, nulls, a lazy
    mask) through the spill catalog: device -> pinned host -> device and
    device -> host -> disk -> device, bit for bit; a flipped disk byte
    raises ChecksumError."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exec import execs as E
    from spark_rapids_tpu_torch.memory import spill as SP
    from spark_rapids_tpu_torch.ops.expression import col, lit
    from spark_rapids_tpu_torch.ops.strings import Substring
    from spark_rapids_tpu_torch.utils import checksum as CK
    rng = np.random.default_rng(3)
    n = 100_003
    d = rng.normal(size=n)
    d[:2] = [np.nan, -0.0]
    host = HostBatch.from_numpy({
        "k": rng.integers(0, 1 << 40, n), "d": d,
        "s": np.array(["w%d" % x for x in rng.integers(0, 500, n)],
                      dtype=object)})
    batch = host.to_device(cuda_device)
    sub = Substring(col("s"), lit(2), lit(2)).bind(batch.schema) \
        .eval_device(batch)
    batch = E.ColumnarBatch(
        batch.columns + (sub,), batch.n_rows,
        T.Schema(list(batch.schema) + [T.StructField("sub", T.STRING)]))
    keep = (torch.rand(batch.capacity, device=cuda_device) < 0.9) \
        & (torch.arange(batch.capacity, device=cuda_device) < n)
    batch = E.KR.compact(batch, keep)
    want = HostBatch.from_device(batch)

    def same(b):
        got = HostBatch.from_device(b)
        for name in want.columns:
            np.testing.assert_array_equal(got.validity[name],
                                          want.validity[name])
            a, w = got.columns[name], want.columns[name]
            if a.dtype.kind == "f":
                a, w = a.view(np.int64), w.view(np.int64)
            np.testing.assert_array_equal(a, w, err_msg=name)

    cat = SP.BufferCatalog(1 << 40, 1 << 40, str(tmp_path),
                           device=cuda_device)
    bid = cat.register_batch(batch)
    cat.spill_below(SP.ACTIVE_ON_DECK_PRIORITY)
    assert cat.tier_of(bid) == SP.StorageTier.HOST
    host_cols = cat._entries[bid].host_batch.columns
    # the host tier holds views of one pinned buffer
    assert torch.from_numpy(host_cols[0].data).is_pinned()
    same(cat.acquire_batch(bid))
    cat.free(bid)
    disk = SP.BufferCatalog(0, 0, str(tmp_path), device=cuda_device)
    bid = disk.register_batch(batch)
    assert disk.tier_of(bid) == SP.StorageTier.DISK
    same(disk.acquire_batch(bid))
    bid2 = disk.register_batch(batch)
    off, length = disk.disk_range_of(bid2)
    with open(disk.spill_file.path, "r+b") as f:
        f.seek(off + length // 3)
        b = f.read(1)
        f.seek(off + length // 3)
        f.write(bytes([b[0] ^ 1]))
    with pytest.raises(CK.ChecksumError):
        disk.acquire_batch(bid2)
    # freed first: a compaction relocating the corrupt range would raise
    disk.free(bid2)
    disk.free(bid)
    disk.close()
    cat.close()


# -- whole-stage fusion: CUDA graphs -----------------------------------------


def _fused_entry(cuda_device, n=20_000, key_range=50):
    from spark_rapids_tpu_torch import entry as ENTRY
    from spark_rapids_tpu_torch.compile import executables as EX
    forward, (batch,) = ENTRY.entry(n=n, key_range=key_range,
                                    device=cuda_device)
    prog = EX.FusedProgram(lambda inputs, ctx: forward(inputs[0])[0],
                           label="entry")
    return prog, batch, ENTRY.entry_reference(ENTRY.entry_columns(
        n, key_range))


@pytest.mark.cuda
def test_cuda_capture_and_replay_equal_eager_for_the_entry_stage(
        cuda_device):
    from spark_rapids_tpu_torch.compile import executables as EX
    prog, batch, want = _fused_entry(cuda_device)
    counts = []
    seen = []
    for _ in range(4):
        before = JP.dense_build_probe.launches + \
            SEG.segment_reduce_sorted.launches
        got = prog((batch,), None, lambda out: HostBatch.from_device(out))
        counts.append(JP.dense_build_probe.launches
                      + SEG.segment_reduce_sorted.launches - before)
        seen.append(prog.last["action"])
        for k, w in want.items():
            np.testing.assert_array_equal(got.columns[k], w)
    assert seen == ["eager", "capture", "replay", "replay"]
    # a replay counts the launches its capture recorded
    assert counts[2] == counts[3] == counts[1]
    assert prog.stats()["graphs"] == 1
    key = prog.key_of((batch,))[0]
    assert prog.jit_compiled(key)
    # another table of the same shapes and a new input is a copy-in
    prog2_batch = HostBatch.from_device(batch).to_device(cuda_device)
    again = prog((prog2_batch,), None, HostBatch.from_device)
    assert prog.last["action"] == "replay"
    for k, w in want.items():
        np.testing.assert_array_equal(again.columns[k], w)
    assert EX.graph_bytes() > 0


@pytest.mark.cuda
def test_cuda_flat_string_projection_is_refused_with_its_site(cuda_device):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.ops import cast as CA
    from spark_rapids_tpu_torch.ops.expression import col, lit
    from spark_rapids_tpu_torch.ops.strings import ConcatStrings
    from spark_rapids_tpu_torch.session import TorchSession
    s = TorchSession(device="cuda")
    off = TorchSession({"spark.rapids.tpu.fusion.enabled": False},
                       device="cuda")
    data = {"k": np.arange(3000)}

    def q(sess):
        # a flat string result whose payload is sized on the host
        # (ops/strings_util.py flat_column)
        df = sess.create_dataframe(data)
        return df.select(ConcatStrings(CA.Cast(col("k"), T.STRING),
                                       lit("-")).alias("t"), col("k"))
    got = q(s).collect()
    info = s.last_query.fusion
    assert info["action"] == "refused", info
    assert info["site"].startswith(
        "spark_rapids_tpu_torch/ops/strings_util.py:"), info
    assert s.last_query_profile().extras["WholeStageFusion"][
        "fusionRefusals"] == 1
    want = q(off).collect()
    assert list(got.columns["t"]) == list(want.columns["t"])
    q(s).collect()
    assert s.last_query.fusion["action"] == "refused"


@pytest.mark.cuda
def test_cuda_graphs_released_by_the_oom_drain(cuda_device):
    from spark_rapids_tpu_torch.compile import executables as EX
    from spark_rapids_tpu_torch.data import upload_cache as UC
    from spark_rapids_tpu_torch.exec import execs as E
    from spark_rapids_tpu_torch.memory import retry as R
    prog, batch, want = _fused_entry(cuda_device)
    for _ in range(2):
        prog((batch,), None, HostBatch.from_device)
    assert prog.stats()["graphs"] == 1 and EX.graph_bytes() > 0
    R.spill_device_below(E.ExecContext(cuda_device))
    assert prog.stats()["graphs"] == 0 and EX.graph_bytes() == 0
    assert UC.cache_bytes() == 0
    # the key went with its graph: it runs eagerly, then captures again
    for action in ("eager", "capture"):
        got = prog((batch,), None, HostBatch.from_device)
        assert prog.last["action"] == action
        for k, w in want.items():
            np.testing.assert_array_equal(got.columns[k], w)


@pytest.mark.cuda
def test_cuda_fresh_tables_free_their_memory(cuda_device):
    """A loop of ``create_dataframe`` and a fused query over fresh tables
    keeps none of them: a graph's key names a resident table by address
    and drops itself when the table dies."""
    import gc
    from spark_rapids_tpu_torch.compile import executables as EX
    from spark_rapids_tpu_torch.ops import aggregates as A
    from spark_rapids_tpu_torch.ops import predicates as P
    from spark_rapids_tpu_torch.ops.expression import col, lit
    from spark_rapids_tpu_torch.session import TorchSession
    s = TorchSession({"spark.rapids.tpu.uploadCache.maxBytes": 0},
                     device="cuda")
    n = 1 << 21

    def round_(seed):
        rng = np.random.default_rng(seed)
        df = s.create_dataframe({"a": rng.integers(0, 100, n)})
        acts = []
        for _ in range(3):
            got = df.where(P.GreaterThan(col("a"), lit(10))).group_by().agg(
                A.AggregateExpression(A.Sum(col("a")), "s")).collect()
            acts.append(s.last_query.fusion["action"])
        del df
        return got, acts
    round_(0)
    gc.collect()
    EX.stats()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_device)
    dead0 = EX.stats()["dead_keys"]
    seen = []
    for seed in range(1, 7):
        _, acts = round_(seed)
        seen += acts
    gc.collect()
    EX.stats()  # drains the keys whose table died
    torch.cuda.synchronize()
    table_bytes = n * (8 + 1)
    assert "capture" in seen or "replay" in seen, seen
    assert EX.stats()["dead_keys"] > dead0
    assert torch.cuda.memory_allocated(cuda_device) <= base + table_bytes, \
        (torch.cuda.memory_allocated(cuda_device), base)


@pytest.mark.cuda
def test_cuda_capture_keeps_the_constants_it_read(cuda_device):
    """A graph reads the address of every host-derived constant it used;
    the constants' cache evicting them must not free them under it."""
    from spark_rapids_tpu_torch.compile import executables as EX
    from spark_rapids_tpu_torch.data import column as C
    host = np.arange(4096, dtype=np.int64) * 3 + 7

    def fn(inputs, ctx):
        return inputs[0] + C.device_constant(host, inputs[0].device)
    prog = EX.FusedProgram(fn, label="const")
    x = torch.arange(4096, device=cuda_device)
    want = np.arange(4096) + host
    for action in ("eager", "capture", "replay"):
        got = prog((x,), None, lambda out: out.cpu().numpy())
        assert prog.last["action"] == action
        np.testing.assert_array_equal(got, want)
    key = prog.key_of((x,))[0]
    held = prog._table[key].consts
    assert held and any(np.array_equal(t.cpu().numpy(), host)
                        for t, _ in held)
    # evict it from the cache (> 64 MiB of other constants), then hand
    # its freed blocks to other tensors
    for i in range(80):
        C.device_constant(np.full(1 << 20, i % 251, np.uint8), cuda_device)
    assert not any(v[0] is held[0][0] for v in C._CONSTS.values())
    junk = [torch.full((4096,), -1, dtype=torch.int64, device=cuda_device)
            for _ in range(256)]
    got = prog((x,), None, lambda out: out.cpu().numpy())
    assert prog.last["action"] == "replay"
    np.testing.assert_array_equal(got, want)
    del junk
