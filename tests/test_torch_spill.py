"""The port's spill catalog (``spark_rapids_tpu_torch/memory/spill.py``)
and CRC32C (``utils/checksum.py``) on the CPU.

Against the JAX package: the plain CRC32C equals the reference's
``crc32c`` (google-crc32c) on random buffers, with continuation, and on
the standard check vector; the reference's ``test_memory_wiring.py``
join and sort under a 64 KiB device budget give the reference's rows
(``TpuSession`` with fusion off) and really spill.

The port alone: a batch of every column layout (ints, floats with NaN
and -0.0, dates, booleans, dictionary and flat strings, arrays, structs,
nulls, a lazy live mask) goes device -> host -> device and device ->
host -> disk -> device bit for bit; a flipped byte of its disk range
raises ``ChecksumError``; ``spill_below`` leaves pinned buffers and
buffers at or above the priority ceiling on the device and drains the
requester's own buffers first; the spill file compacts once half of it
is dead; and a spill storm of threads registering, restoring and
freeing under a tiny budget leaves the port's lockdep clean, nothing
leaked and every answer intact. The exchange's block catalog sends
blocks past its host budget to disk, reads every block back verified,
and raises ``ChecksumError`` on a corrupt block in memory or on disk;
Q1 over a repartition through the disk tier equals it in memory.
"""

import threading

import numpy as np
import pytest
import torch

from spark_rapids_tpu.utils import checksum as rchecksum
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.batch import ColumnarBatch, HostBatch
from spark_rapids_tpu_torch.exec import execs as E
from spark_rapids_tpu_torch.memory import spill as SP
from spark_rapids_tpu_torch.ops import aggregates as AGG
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.ops.strings import Substring
from spark_rapids_tpu_torch.plan.logical import SortOrder
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.utils import checksum as CK
from spark_rapids_tpu_torch.utils import lockdep

# -- CRC32C ------------------------------------------------------------------


def test_crc32c_check_vector():
    assert CK.crc32c_plain(b"123456789") == 0xE3069283 == \
        rchecksum.crc32c(b"123456789")
    assert CK.crc32c(b"") == 0


@pytest.mark.parametrize("seed", range(4))
def test_crc32c_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    for n in list(rng.integers(0, 65_538, 12)) + [4095, 4096, 4097,
                                                  1 << 17]:
        buf = rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
        value = int(rng.integers(0, 1 << 32))
        assert CK.crc32c_plain(buf) == rchecksum.crc32c(buf)
        assert CK.crc32c_plain(buf, value) == rchecksum.crc32c(buf, value)
        k = len(buf) // 3
        assert CK.crc32c_plain(buf[k:], CK.crc32c_plain(buf[:k])) == \
            CK.crc32c_plain(buf)


def test_verify_counts_and_raises():
    before = CK.stats()
    CK.verify(b"abc", CK.crc32c(b"abc"), "ok")
    with pytest.raises(CK.ChecksumError, match="bad range"):
        CK.verify(b"abd", CK.crc32c(b"abc"), "bad range")
    after = CK.stats()
    assert after["verified"] - before["verified"] == 1
    assert after["failures"] - before["failures"] == 1


# -- catalog round trips -----------------------------------------------------

STRUCT = T.StructType([T.StructField("a", T.LONG),
                       T.StructField("b", T.STRING)])
SCHEMA = T.Schema([
    T.StructField("i", T.INT), T.StructField("l", T.LONG),
    T.StructField("d", T.DOUBLE), T.StructField("dt", T.DATE),
    T.StructField("flag", T.BOOLEAN), T.StructField("s", T.STRING),
    T.StructField("arr", T.ArrayType(T.LONG)),
    T.StructField("st", STRUCT)])


def _obj(values) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def layouts_batch(n: int = 300, seed: int = 0) -> ColumnarBatch:
    """A lazy device batch with every column layout: fixed, dictionary
    and flat strings (``sub``), arrays and structs, with nulls."""
    rng = np.random.default_rng(seed)
    words = ["", "a", "tpu", "hopper", "zürich", "x" * 40]

    def maybe(v, p=0.15):
        return None if rng.random() < p else v
    d = rng.normal(size=n)
    d[:3] = [np.nan, -0.0, 0.0]
    data = {
        "i": _obj([maybe(int(x)) for x in rng.integers(-2**31, 2**31, n)]),
        "l": rng.integers(-2**62, 2**62, n),
        "d": _obj([maybe(float(x)) for x in d]),
        "dt": rng.integers(0, 20000, n).astype(np.int32),
        "flag": _obj([maybe(bool(x)) for x in rng.integers(0, 2, n)]),
        "s": _obj([maybe(words[int(x)]) for x in rng.integers(0, 6, n)]),
        "arr": _obj([maybe([maybe(int(v), 0.2) for v in
                            rng.integers(0, 9, int(k))])
                     for k in rng.integers(0, 5, n)]),
        "st": _obj([maybe({"a": maybe(int(rng.integers(0, 99))),
                           "b": maybe(words[int(rng.integers(0, 6))])})
                    for _ in range(n)]),
    }
    batch = HostBatch.from_numpy(data, SCHEMA).to_device("cpu")
    sub = Substring(col("s"), lit(2), lit(3)).bind(SCHEMA).eval_device(batch)
    schema = T.Schema(list(SCHEMA) + [T.StructField("sub", T.STRING)])
    batch = ColumnarBatch(batch.columns + (sub,), batch.n_rows, schema)
    keep = torch.from_numpy(rng.random(batch.capacity) < 0.8) \
        & (torch.arange(batch.capacity) < n)
    return E.KR.compact(batch, keep)


def _host_equal(a: HostBatch, b: HostBatch) -> None:
    assert list(a.columns) == list(b.columns)
    for name in a.columns:
        va, vb = a.columns[name], b.columns[name]
        np.testing.assert_array_equal(a.validity[name], b.validity[name],
                                      err_msg=name)
        if va.dtype.kind == "f":
            np.testing.assert_array_equal(va.view(np.int64),
                                          vb.view(np.int64), err_msg=name)
        else:
            assert repr(va.tolist()) == repr(vb.tolist()), name


def _catalog(tmp_path, device_budget=1 << 40, host_budget=1 << 40,
             io_threads=2):
    return SP.BufferCatalog(device_budget, host_budget, str(tmp_path),
                            io_threads=io_threads)


def test_every_layout_round_trips_through_host(tmp_path):
    batch = layouts_batch()
    want = HostBatch.from_device(batch)
    cat = _catalog(tmp_path)
    bid = cat.register_batch(batch)
    assert cat.tier_of(bid) == SP.StorageTier.DEVICE
    assert cat.spill_below(SP.ACTIVE_ON_DECK_PRIORITY) > 0
    assert cat.tier_of(bid) == SP.StorageTier.HOST
    back = cat.acquire_batch(bid)
    assert cat.tier_of(bid) == SP.StorageTier.DEVICE
    assert back.capacity == batch.capacity and back.live is None
    _host_equal(HostBatch.from_device(back), want)
    assert cat.metrics["reloaded_from_host"] == 1
    cat.free(bid)
    assert cat.leak_report() == [] and cat.device_bytes == 0
    cat.close()


def test_every_layout_round_trips_through_disk(tmp_path):
    batch = layouts_batch(seed=1)
    want = HostBatch.from_device(batch)
    cat = _catalog(tmp_path, device_budget=0, host_budget=0)
    bid = cat.register_batch(batch)
    assert cat.tier_of(bid) == SP.StorageTier.DISK
    assert cat.metrics["spill_bytes_to_disk"] > 0
    _host_equal(HostBatch.from_device(cat.acquire_batch(bid)), want)
    assert cat.metrics["reloaded_from_disk"] == 1
    cat.free(bid)
    cat.close()
    assert not list(tmp_path.iterdir())


def test_corrupt_disk_range_raises(tmp_path):
    cat = _catalog(tmp_path, device_budget=0, host_budget=0)
    bid = cat.register_batch(layouts_batch(seed=2))
    offset, length = cat.disk_range_of(bid)
    path = cat.spill_file.path
    with open(path, "r+b") as f:
        f.seek(offset + length // 2)
        b = f.read(1)
        f.seek(offset + length // 2)
        f.write(bytes([b[0] ^ 0x40]))
    with pytest.raises(CK.ChecksumError, match="spill range"):
        cat.acquire_batch(bid)
    # the failed restore reverted: the entry is still on disk
    assert cat.tier_of(bid) == SP.StorageTier.DISK
    cat.free(bid)
    cat.close()


def _small(v) -> ColumnarBatch:
    return HostBatch.from_numpy({"v": np.asarray(v, np.int64)}).to_device(
        "cpu")


def test_spill_below_respects_pins_and_the_ceiling(tmp_path):
    cat = _catalog(tmp_path)
    low = cat.register_batch(_small(range(100)), priority=-5)
    pinned = cat.register_batch(_small(range(200)), priority=-5)
    deck = cat.register_batch(_small(range(300)),
                              priority=SP.ACTIVE_ON_DECK_PRIORITY)
    cat.pin(pinned)
    moved = cat.spill_below(SP.ACTIVE_ON_DECK_PRIORITY)
    assert moved == SP.device_size_bytes(_small(range(100)))
    assert [cat.tier_of(b) for b in (low, pinned, deck)] == \
        [SP.StorageTier.HOST, SP.StorageTier.DEVICE, SP.StorageTier.DEVICE]
    cat.unpin(pinned)
    cat.spill_below(0)
    assert cat.tier_of(pinned) == SP.StorageTier.HOST
    assert cat.tier_of(deck) == SP.StorageTier.DEVICE
    for b in (low, pinned, deck):
        cat.free(b)
    cat.close()


def test_victims_drain_the_requesters_own_buffers_first(tmp_path):
    me, other = SP.QosTag("t"), SP.QosTag("u")
    cat = _catalog(tmp_path)
    mine = cat.register_batch(_small(range(100)), owner=me)
    theirs = cat.register_batch(_small(range(100)), owner=other)
    size = SP.device_size_bytes(_small(range(100)))
    cat.synchronous_spill(cat.device_bytes - size, requester=me)
    assert cat.tier_of(mine) == SP.StorageTier.HOST
    assert cat.tier_of(theirs) == SP.StorageTier.DEVICE
    cat.free(mine)
    cat.free(theirs)
    cat.close()


def test_spill_file_compacts_at_half_dead(tmp_path):
    f = SP.SpillFile(str(tmp_path))
    payloads = [bytes([i]) * (1000 + i) for i in range(4)]
    ranges = [f.append(p) for p in payloads]
    for r in ranges[:3]:
        f.free_range(*r)
    assert f.freed_fraction() > SP.DISK_COMPACT_FRACTION
    new = f.compact({"keep": ranges[3]})
    assert new["keep"] == (0, len(payloads[3]))
    assert bytes(f.read(*new["keep"])) == payloads[3]
    assert f.size_bytes == len(payloads[3]) and f.freed_bytes == 0
    f.close()
    # and through a catalog: freeing disk entries compacts the file
    cat = _catalog(tmp_path, device_budget=0, host_budget=0)
    ids = [cat.register_batch(_small(range(i, i + 500))) for i in range(4)]
    for b in ids[:3]:
        cat.free(b)
    assert cat.metrics["disk_spill_file_compactions"] >= 1
    got = HostBatch.from_device(cat.acquire_batch(ids[3])).columns["v"]
    assert got.tolist() == list(range(3, 503))
    cat.free(ids[3])
    cat.close()


def test_spill_storm_under_lockdep(tmp_path):
    """Threads register, restore and free under a budget of a few
    batches, with the IO lane on: every value comes back, nothing leaks,
    and the port's lockdep records no violation."""
    assert lockdep.enabled()
    lockdep.drain_violations()
    size = SP.device_size_bytes(_small(range(512)))
    cat = _catalog(tmp_path, device_budget=3 * size, host_budget=2 * size)
    errors = []

    def worker(w):
        try:
            ids = {}
            for i in range(12):
                start = 1000 * w + 37 * i
                ids[start] = cat.register_batch(_small(range(start,
                                                             start + 512)))
            for start, bid in ids.items():
                got = HostBatch.from_device(cat.acquire_batch(bid))
                assert got.columns["v"].tolist() == \
                    list(range(start, start + 512))
                cat.free(bid)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert cat.metrics["spilled_to_disk"] > 0
    assert cat.leak_report() == []
    cat.close()
    assert lockdep.violations() == []


# -- the reference's memory wiring under a 64 KiB budget ------------------------

TINY = {"spark.rapids.memory.tpu.spillBudgetBytes": 65536}


def _join_frames(port, n=20_000, m=6_000):
    """The reference's ``_join_query``: a probe and a build side of eight
    batches (a union of eight frames in the port, eight record batches
    in the reference)."""
    rng = np.random.default_rng(3)
    probe = {"k": rng.integers(0, m, n).astype(np.int64),
             "v": rng.integers(0, 100, n).astype(np.int64)}
    builds = [{"k": np.arange(i, m, 8, dtype=np.int64),
               "w": np.arange(i, m, 8, dtype=np.int64) * 10}
              for i in range(8)]
    if port is None:
        return probe, builds
    b = port.create_dataframe(builds[0])
    for x in builds[1:]:
        b = b.union(port.create_dataframe(x))
    return port.create_dataframe(probe), b


def _join_query(p, b):
    return (p.join(b, on="k", how="inner").select(col("v"), col("w"))
            .group_by()
            .agg(AGG.AggregateExpression(AGG.Count(), "c"),
                 AGG.AggregateExpression(AGG.Sum(col("w")), "sw")))


def test_join_build_spills_and_equals_the_reference(tmp_path):
    import pyarrow as pa

    from spark_rapids_tpu.ops import aggregates as RAGG
    from spark_rapids_tpu.ops.expression import col as rcol
    from spark_rapids_tpu.session import TpuSession
    # the build side registers with the catalog on the streaming path; a
    # fused region registers nothing (test_fused_join_under_a_tiny_budget)
    s = TorchSession({**TINY, "spark.rapids.memory.tpu.spillDir":
                      str(tmp_path), "spark.rapids.tpu.fusion.enabled":
                      False}, device="cpu")
    got = _join_query(*_join_frames(s)).collect()
    assert s.device_manager.catalog.metrics["spilled_to_host"] > 0
    assert s.last_query_profile().engine["spillBytes"] > 0
    probe, builds = _join_frames(None)
    ref = TpuSession({"spark.rapids.sql.enabled": True,
                      "spark.rapids.tpu.fusion.enabled": False, **TINY})
    rb = ref.create_dataframe(pa.Table.from_batches(
        [pa.RecordBatch.from_pydict(x) for x in builds]))
    want = (ref.create_dataframe(pa.RecordBatch.from_pydict(probe))
            .join(rb, on="k", how="inner").select(rcol("v"), rcol("w"))
            .group_by()
            .agg(RAGG.AggregateExpression(RAGG.Count(), "c"),
                 RAGG.AggregateExpression(RAGG.Sum(rcol("w")), "sw"))
            ).collect()
    assert got.columns["c"].tolist() == want.column("c").to_pylist()
    assert got.columns["sw"].tolist() == want.column("sw").to_pylist()


def test_fused_join_under_a_tiny_budget(tmp_path):
    """The same join on the fused path: the region holds no catalog
    entry, so nothing spills, and the answer is the streaming path's."""
    conf = {**TINY, "spark.rapids.memory.tpu.spillDir": str(tmp_path)}
    fused = TorchSession(conf, device="cpu")
    got = _join_query(*_join_frames(fused)).collect()
    assert fused.last_query.fusion["action"] == "cpu"
    assert fused.device_manager.catalog.device_bytes == 0
    off = TorchSession({**conf, "spark.rapids.tpu.fusion.enabled": False},
                       device="cpu")
    want = _join_query(*_join_frames(off)).collect()
    for name in ("c", "sw"):
        assert got.columns[name].tolist() == want.columns[name].tolist()


def test_sort_input_spills_and_equals_the_reference(tmp_path):
    import pyarrow as pa

    from spark_rapids_tpu.ops.expression import col as rcol
    from spark_rapids_tpu.plan.logical import SortOrder as RSortOrder
    from spark_rapids_tpu.session import TpuSession
    rng = np.random.default_rng(4)
    parts = [rng.integers(0, 10**6, 4000).astype(np.int64)
             for _ in range(6)]
    s = TorchSession({**TINY, "spark.rapids.memory.tpu.spillDir":
                      str(tmp_path)}, device="cpu")
    df = s.create_dataframe({"v": parts[0]})
    for p in parts[1:]:
        df = df.union(s.create_dataframe({"v": p}))
    got = df.sort(SortOrder(col("v"))).collect().columns["v"].tolist()
    assert s.last_query_profile().engine["spillBytes"] > 0
    ref = TpuSession({"spark.rapids.sql.enabled": True,
                      "spark.rapids.tpu.fusion.enabled": False, **TINY})
    want = ref.create_dataframe(pa.Table.from_batches(
        [pa.RecordBatch.from_pydict({"v": p}) for p in parts])).sort(
        RSortOrder(rcol("v"))).collect().column("v").to_pylist()
    assert got == want


# -- the exchange's block catalog -------------------------------------------


def test_shuffle_catalog_disk_tier_and_checksums(tmp_path):
    """Blocks past the host budget go to a SpillFile; every block reads
    back equal and verified; a corrupt block, in memory or on disk,
    raises ChecksumError."""
    from spark_rapids_tpu_torch.shuffle.exchange import ShuffleBufferCatalog
    rng = np.random.default_rng(6)
    blocks = [rng.integers(0, 256, int(n), dtype=np.uint8)
              for n in rng.integers(1, 5000, 12)]
    cat = ShuffleBufferCatalog(host_budget=10_000, spill_dir=str(tmp_path))
    sid = cat.new_shuffle_id()
    for m, b in enumerate(blocks):
        cat.add_block(sid, m, m % 3, b.copy())
    assert 0 < cat.metrics["disk_blocks"] < len(blocks)
    for p in range(3):
        got = [bytes(x) for x in cat.blocks_for_reduce(sid, p)]
        assert got == [bytes(b) for m, b in enumerate(blocks) if m % 3 == p]
    on_disk = [m for m in range(len(blocks))
               if isinstance(cat.block_location((sid, m, m % 3)), tuple)]
    in_memory = [m for m in range(len(blocks)) if m not in on_disk]
    cat.block_location((sid, in_memory[0], in_memory[0] % 3))[0] ^= 1
    with pytest.raises(CK.ChecksumError, match="shuffle block"):
        list(cat.blocks_for_reduce(sid, in_memory[0] % 3))
    off, length = cat.block_location((sid, on_disk[0], on_disk[0] % 3))
    with open(cat.spill_file.path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 1]))
    with pytest.raises(CK.ChecksumError, match="spill range"):
        list(cat.blocks_for_reduce(sid, on_disk[0] % 3))
    cat.unregister_shuffle(sid)
    cat.close()


def test_exchange_through_the_disk_tier_equals_memory(tmp_path):
    """Q1 over a hash repartition with a host budget that sends most
    blocks to disk gives the in-memory answer bit for bit."""
    from spark_rapids_tpu_torch.workloads import tpch
    tables = tpch.gen_tables(1 << 12, seed=5)

    def run(conf):
        s = TorchSession(conf, device="cpu")
        dfs = tpch.load(s, tables)
        dfs["lineitem"] = dfs["lineitem"].repartition(
            4, "l_returnflag", "l_linestatus")
        got = tpch.q1(dfs).collect()
        return {n: got.columns[n].tolist() for n in got.columns}
    want = run({})
    got = run({"spark.rapids.memory.host.spillStorageSize": 4096,
               "spark.rapids.memory.tpu.spillDir": str(tmp_path)})
    assert got == want
