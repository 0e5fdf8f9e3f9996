"""The CUDA kernels of ``spark_rapids_tpu_torch`` against their plain
PyTorch versions, on the card. Every test here needs an NVIDIA GPU and
skips without one; the module imports neither JAX nor the JAX package,
so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` skips the JAX set-up of ``tests/conftest.py``.) The
case builders here are shared with ``tests/test_torch_kernels.py``, which
holds the same plain versions against the JAX package's Pallas kernels.
"""

import numpy as np
import pytest

import torch

from spark_rapids_tpu_torch.ops.kernels.cuda import hashing as HK
from spark_rapids_tpu_torch.ops.kernels.cuda import join_probe as JP
from spark_rapids_tpu_torch.ops.kernels.cuda import segmented as SEG
from spark_rapids_tpu_torch.ops.kernels.cuda import sort_steps as SS
from spark_rapids_tpu_torch.ops.kernels.cuda import strings as SG

JOINPROBE_CASES = ["duplicate keys", "every probed slot empty",
                   "one live row", "all rows dead", "unique keys"]
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
    if name == "duplicate keys":
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
@pytest.mark.parametrize("name", JOINPROBE_CASES)
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
