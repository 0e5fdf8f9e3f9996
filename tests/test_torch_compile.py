"""The port's compile layer against the JAX package's: the capacity
ladder's tiers, the plan signature that keys the fused programs, and
the fused program's input key (``aval_signature``), which must name
every host value a captured graph bakes in, a dictionary above all; a
key's lifetime (dropped with the resident table it names) and the
constants a capture holds. All on the CPU; no graph is captured here
(``tests/test_torch_cuda.py`` captures on the card).
"""

import gc

import numpy as np
import pytest
import torch

from spark_rapids_tpu.compile import ladder as rladder
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.compile import executables as EX
from spark_rapids_tpu_torch.compile import ladder as pladder
from spark_rapids_tpu_torch.data import column as C
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.utils.kernel_cache import (kernel_key,
                                                      plan_signature)

#: n runs over 1 .. 2^22 on this stride (a prime, so every residue of
#: the lane and of the rungs is visited), plus every power of two and
#: its neighbours.
STRIDE = 1021
NS = sorted(set(range(1, (1 << 22) + 1, STRIDE))
            | {v + d for k in range(23) for v in [1 << k] for d in (-1, 0, 1)
               if 1 <= v + d <= 1 << 22})


@pytest.mark.parametrize("tier_growth", [2.0, 4.0, 8.0])
def test_ladder_tiers_equal_reference(tier_growth):
    ref = rladder.BucketLadder(tier_growth=tier_growth)
    port = pladder.BucketLadder(tier_growth=tier_growth)
    for n in NS:
        assert port.bucket(n) == ref.bucket(n), n
        assert port.tier(n) == ref.tier(n), n
        assert port.next_up(n) == ref.next_up(n), n
        assert port.next_down(n) == ref.next_down(n), n
        assert port.bucket_bytes(n) == ref.bucket_bytes(n), n
    for lo, hi in [(1, 1), (1, 1 << 22), (1000, 70_000), (129, 4096)]:
        assert port.rungs(lo, hi) == ref.rungs(lo, hi)
        assert port.tiers(lo, hi) == ref.tiers(lo, hi)


@pytest.mark.parametrize("kw", [{"max_capacity": 1 << 16},
                                {"enabled": False},
                                {"min_capacity": 1000, "growth": 1.5}])
def test_ladder_variants_equal_reference(kw):
    ref = rladder.BucketLadder(**kw)
    port = pladder.BucketLadder(**kw)
    for n in NS[::7]:
        assert (port.bucket(n), port.tier(n), port.next_down(n)) == \
            (ref.bucket(n), ref.tier(n), ref.next_down(n)), n
    assert port.tiers(1, 1 << 20) == ref.tiers(1, 1 << 20)


def test_tier_is_idempotent():
    port = pladder.BucketLadder(tier_growth=3.0)
    for n in NS[::13]:
        t = port.tier(n)
        assert port.tier(t) == t and t >= port.bucket(n)


def _resident_entry(prog, n=64):
    """A key naming a resident table of ``n`` rows, entered as the
    program's first call enters it."""
    table = (torch.arange(n), torch.ones(n, dtype=torch.bool))
    leaves = EX.flatten(table)[0]
    key, refs = EX.aval_signature(table, frozenset(id(t) for t in leaves))
    prog._add_entry(key, EX._Entry("eager", refs), leaves)
    return table, key


def test_key_dies_with_its_resident_table():
    prog = EX.FusedProgram(lambda inputs, ctx: inputs)
    table, key = _resident_entry(prog)
    kept, kept_key = _resident_entry(prog)
    assert prog.seen(key) and prog.seen(kept_key)
    del table
    gc.collect()
    EX.stats()  # drains the keys whose table died
    assert not prog.seen(key) and prog.seen(kept_key)
    assert EX.stats()["dead_keys"] >= 1


def test_key_holds_no_resident_table():
    prog = EX.FusedProgram(lambda inputs, ctx: inputs)
    table, key = _resident_entry(prog)
    held = prog._table[key]
    assert not any(isinstance(r, torch.Tensor) for r in held.refs)
    assert len(held.finalizers) == 2


def test_drop_detaches_the_finalizers():
    prog = EX.FusedProgram(lambda inputs, ctx: inputs)
    table, key = _resident_entry(prog)
    fins = list(prog._table[key].finalizers)
    assert prog._drop(key) is True and prog._drop(key) is False
    assert not any(f.alive for f in fins)


def test_capture_records_every_constant_handed_out():
    """Inside :func:`recording_constants` every ``device_constant`` is
    recorded, cached or not; outside it nothing is."""
    with C.recording_constants() as held:
        a = C.device_constant([1, 2, 3], "cpu", np.int32)
        b = C.device_constant([1, 2, 3], "cpu", np.int32)
        with C.recording_constants() as inner:
            c = C.device_constant([7], "cpu", np.int64)
        d = C.device_constant(np.arange(300_000), "cpu")
    C.device_constant([9], "cpu")
    assert [id(t) for t, _ in held] == [id(a), id(b), id(d)]
    assert [id(t) for t, _ in inner] == [id(c)]


def test_hashed_tuple_hashes_its_parts_once():
    class Part:
        hashes = 0

        def __hash__(self):
            Part.hashes += 1
            return 7

        def __eq__(self, other):
            return isinstance(other, Part)
    k = EX.HashedTuple((Part(), 1))
    d = {k: "x"}
    for _ in range(5):
        assert d[k] == "x"
    assert Part.hashes == 1
    assert k == (k[0], 1) and hash(k) == hash((k[0], 1))


def test_path_choice_alternates_then_keeps_the_faster():
    from spark_rapids_tpu_torch.exec.fusion import _PathChoice
    ch = _PathChoice()
    seq = []
    times = {"fused": [5, 4], "stream": [3, 6]}
    while ch.path is None:
        path = ch.next()
        seq.append(path)
        ch.note(path, times[path].pop(0))
    assert seq == ["fused", "stream", "fused", "stream"]
    assert ch.path == "stream" and ch.next() == "stream"  # 3 < 4
    ch.note("fused", 1)  # no sample once chosen
    assert ch.path == "stream"


@pytest.mark.parametrize("fused,stream,want", [
    ([2, 2], [2, 2], "fused"),  # a tie keeps the graph
    ([9, 1], [2, 2], "fused"),
    ([3, 3], [9, 2], "stream")])
def test_path_choice_by_best_time(fused, stream, want):
    from spark_rapids_tpu_torch.exec.fusion import _PathChoice
    ch = _PathChoice()
    for f, s_ in zip(fused, stream):
        ch.note("fused", f)
        ch.note("stream", s_)
    assert ch.path == want


@pytest.fixture(scope="module")
def frame():
    s = TorchSession(device="cpu")
    rng = np.random.default_rng(5)
    df = s.create_dataframe({"a": rng.integers(0, 100, 1000),
                             "b": rng.integers(0, 5, 1000)})
    return s, df


def test_plan_signature_structural(frame):
    s, df = frame

    def plan(v):
        return s.plan(df.where(P.GreaterThan(col("a"), lit(v)))._plan)
    assert plan_signature(plan(5)) == plan_signature(plan(5))
    assert plan_signature(plan(5)) != plan_signature(plan(6))
    # the source's batch is data, not structure
    other = s.create_dataframe({"a": np.arange(1000), "b": np.arange(1000)})
    assert plan_signature(s.plan(other.where(P.GreaterThan(col("a"), lit(5)))._plan)) \
        == plan_signature(plan(5))
    assert kernel_key(lit(5), [1, "x"]) == kernel_key(lit(5), [1, "x"])
    assert kernel_key(lit(5)) != kernel_key(lit(5.0))


def _dict_batch(values):
    schema = T.Schema([T.StructField("s", T.STRING),
                       T.StructField("k", T.LONG)])
    return HostBatch.from_numpy({"s": np.array(values, dtype=object),
                                 "k": np.arange(len(values))},
                                schema).to_device("cpu")


def test_dictionary_change_is_a_new_key():
    a = _dict_batch(["x", "y", "x", "y"])
    b = _dict_batch(["x", "z", "x", "z"])  # same capacities, new entries
    assert a.capacity == b.capacity
    assert a.columns[0].dictionary is not b.columns[0].dictionary
    ka, refs = EX.aval_signature(((a,),))
    kb, _ = EX.aval_signature(((b,),))
    assert ka != kb
    # the key names the dictionary by identity and keeps it alive
    assert any(r is a.columns[0].dictionary for r in refs)
    same = EX.aval_signature(((a,),))[0]
    assert same == ka
    # the shapes alone (a new capacity) also make a new key
    c = _dict_batch(["x", "y"] * 200)
    assert EX.aval_signature(((c,),))[0] != ka


def test_resident_leaves_keyed_by_address():
    a = _dict_batch(["x", "y"])
    leaves = EX.flatten(a)[0]
    resident = frozenset(id(t) for t in leaves)
    k1, refs = EX.aval_signature(a, resident)
    copy = EX.unflatten(EX.flatten(a)[1], [t.clone() for t in leaves])
    k2, _ = EX.aval_signature(copy, frozenset(
        id(t) for t in EX.flatten(copy)[0]))
    assert k1 != k2 and EX.aval_signature(a)[0] == \
        EX.aval_signature(copy)[0]
    # named by address, never kept: the key's holder drops the key when
    # the table dies (test_key_dies_with_its_resident_table)
    assert not any(r is t for r in refs for t in leaves)
    assert all(lane[3:] == ("R", t.data_ptr())
               for lane, t in zip(k1[1], leaves))


def test_flatten_round_trip():
    a = _dict_batch(["p", None, "q"])
    leaves, spec = EX.flatten({"x": [a, None], "n": 3})
    back = EX.unflatten(spec, leaves)
    assert back["n"] == 3 and back["x"][1] is None
    got = HostBatch.from_device(back["x"][0])
    want = HostBatch.from_device(a)
    assert list(got.columns["s"]) == list(want.columns["s"])
