"""The port's shuffle modules against the JAX package on the CPU.

Spark's murmur3 must agree bit for bit: each mix helper on random 32-bit
words, ``hash_column`` per type, the plain string hash against the
reference's jnp version and its Pallas kernel in interpret mode (the
cases ``tests/test_torch_cuda.py`` runs on the card; W = 1024 against
the jnp version only), and partition ids
of the hash and round-robin partitioners on the same carried batch. The
block serializer must give back the rows it was given; concatenation
and the merge-mode aggregate must give the reference's rows (float sums
to rtol 1e-12: both add in row order on the CPU, the bound leaves room
for the association of a scatter).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from spark_rapids_tpu.exec import execs as RE
from spark_rapids_tpu.ops import aggregates as RAGG
from spark_rapids_tpu.ops.expression import BoundReference as RBound
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.kernels import concat as RKC
from spark_rapids_tpu.ops.kernels import pallas as PAL
from spark_rapids_tpu.ops.kernels.pallas import hashing as RH
from spark_rapids_tpu.plan import logical as RL
from spark_rapids_tpu.shuffle import partitioners as RPR
from spark_rapids_tpu.shuffle import partitioning as RPN

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.batch import (HostBatch, download_columns,
                                               upload_columns)
from spark_rapids_tpu_torch.exec import execs as E
from spark_rapids_tpu_torch.ops import aggregates as AGG
from spark_rapids_tpu_torch.ops.expression import BoundReference, col
from spark_rapids_tpu_torch.ops.kernels import concat as KC
from spark_rapids_tpu_torch.ops.kernels import rowops as KR
from spark_rapids_tpu_torch.ops.kernels.cuda import hashing as HK
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.shuffle import codec as CODEC
from spark_rapids_tpu_torch.shuffle import partitioners as PR
from spark_rapids_tpu_torch.shuffle import partitioning as PN
from spark_rapids_tpu_torch.shuffle import serializer as SER
from test_torch_cuda import HASH_WIDTHS, hash_case
from test_torch_ops import assert_column, both_batches, to_port
from test_torch_strings import assert_same_strings
from test_torch_strings import batches as string_batches

PALLAS = PAL.PallasConf(enabled=True)


def _words(n: int = 4096) -> np.ndarray:
    """Random uint32 words with the edge values first."""
    rng = np.random.default_rng(n)
    w = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    w[:6] = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF]
    return w


def _lane(words: np.ndarray) -> torch.Tensor:
    """uint32 words as the port's u32 lane (int64)."""
    return torch.as_tensor(words.astype(np.int64))


def _as_u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


# --------------------------------------------------------------------------
# murmur3
# --------------------------------------------------------------------------

_U = _words()
_S = np.random.default_rng(1).permutation(_U)  # seeds
_I32 = _U.view(np.int32)
_I64 = np.random.default_rng(5).integers(-2 ** 63, 2 ** 63 - 1, len(_U))
_I64[:4] = [0, -1, -2 ** 63, 2 ** 63 - 1]
_LENS = np.random.default_rng(6).integers(-3, 200, len(_U)).astype(np.int32)

HELPERS = {
    "mix_k1": (lambda: PN._mix_k1(_lane(_U)),
               lambda: RPN._mix_k1(jnp, jnp.asarray(_U))),
    "mix_h1": (lambda: PN._mix_h1(_lane(_S), _lane(_U)),
               lambda: RPN._mix_h1(jnp, jnp.asarray(_S), jnp.asarray(_U))),
    "fmix": (lambda: PN._fmix(_lane(_U), 4),
             lambda: RPN._fmix(jnp, jnp.asarray(_U), 4)),
    "fmix_len": (lambda: PN._fmix_len(_lane(_U), torch.as_tensor(_LENS)),
                 lambda: RPN._fmix_len(jnp, jnp.asarray(_U),
                                       jnp.asarray(_LENS))),
    "murmur3_int32": (lambda: PN.murmur3_int32(torch.as_tensor(_I32),
                                               _lane(_S)),
                      lambda: RPN.murmur3_int32(jnp, jnp.asarray(_I32),
                                                jnp.asarray(_S))),
    "murmur3_int64": (lambda: PN.murmur3_int64(torch.as_tensor(_I64),
                                               _lane(_S)),
                      lambda: RPN.murmur3_int64(jnp, jnp.asarray(_I64),
                                                jnp.asarray(_S))),
}


@pytest.mark.parametrize("name", list(HELPERS))
def test_murmur3_helper_matches_reference(name):
    port, ref = HELPERS[name]
    got = port()
    assert got.dtype == torch.int64 and int(got.min()) >= 0
    np.testing.assert_array_equal(got.numpy(), _as_u32(ref()))


def _floats(dtype) -> np.ndarray:
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1e3, 512).astype(dtype)
    x[:6] = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf]
    return x


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spark_normalize_float_matches_reference(dtype):
    x = _floats(dtype)
    bits, width = PN._spark_normalize_float(torch.as_tensor(x))
    rbits, rwidth = RPN._spark_normalize_float(jnp, jnp.asarray(x))
    assert width == rwidth
    np.testing.assert_array_equal(bits.numpy(), np.asarray(rbits))


#: (port type, reference type, values) of each fixed-width hash case; a
#: float32 lane hashes by its 32-bit pattern whatever the port type.
def _typed_values():
    rng = np.random.default_rng(9)
    n = 512
    return {
        "boolean": (T.BOOLEAN, "boolean", rng.random(n) < 0.5),
        "int": (T.INT, "int", rng.integers(-2 ** 31, 2 ** 31, n)
                .astype(np.int32)),
        "date": (T.DATE, "date", rng.integers(-20000, 20000, n)
                 .astype(np.int32)),
        "bigint": (T.LONG, "bigint", rng.integers(-2 ** 62, 2 ** 62, n)),
        "float": (T.DOUBLE, "float", _floats(np.float32)),
        "double": (T.DOUBLE, "double", _floats(np.float64)),
    }


@pytest.mark.parametrize("tname", list(_typed_values()))
def test_hash_column_matches_reference(tname):
    from spark_rapids_tpu import types as RT
    ptype, rname, values = _typed_values()[tname]
    rtype = {"boolean": RT.BOOLEAN, "int": RT.INT, "date": RT.DATE,
             "bigint": RT.LONG, "float": RT.FLOAT,
             "double": RT.DOUBLE}[rname]
    valid = np.random.default_rng(10).random(len(values)) < 0.85
    seed = _U[:len(values)]
    got = PN.hash_column(torch.as_tensor(values), torch.as_tensor(valid),
                         ptype, _lane(seed))
    want = RPN.hash_column(jnp, jnp.asarray(values), jnp.asarray(valid),
                           rtype, jnp.asarray(seed))
    np.testing.assert_array_equal(got.numpy(), _as_u32(want))


def _plain_hash(mat, lengths, seed) -> np.ndarray:
    got = HK.murmur3_bytes_rows(torch.as_tensor(mat),
                                torch.as_tensor(lengths),
                                torch.as_tensor(seed))
    assert got.dtype == torch.int32
    return got.numpy().view(np.uint32)


@pytest.mark.parametrize("w", HASH_WIDTHS)
def test_plain_bytes_hash_matches_reference(w):
    mat, lengths, seed = hash_case(300, w)
    want = RPN.murmur3_bytes_rows(jnp, jnp.asarray(mat), jnp.asarray(lengths),
                                  jnp.asarray(seed.view(np.uint32)))
    np.testing.assert_array_equal(_plain_hash(mat, lengths, seed),
                                  np.asarray(want))


# W = 1024 takes the interpreter minutes (the kernel unrolls every
# position); the jnp reference above covers it.
@pytest.mark.parametrize("w", [4, 8, 128])
def test_plain_bytes_hash_matches_pallas(w):
    mat, lengths, seed = hash_case(300, w)
    want = RH.murmur3_bytes_rows(jnp.asarray(mat), jnp.asarray(lengths),
                                 jnp.asarray(seed.view(np.uint32)))
    np.testing.assert_array_equal(_plain_hash(mat, lengths, seed),
                                  np.asarray(want))


def test_plain_bytes_hash_past_the_matrix_and_negative_lengths():
    """Lengths beyond W hash W bytes and fold the full length; negative
    lengths hash no byte: the reference's masks, not the kernel's loop,
    define both."""
    mat, lengths, seed = hash_case(64, 8)
    lengths = lengths.copy()
    lengths[::3] = 13
    lengths[1::5] = -2
    got = HK.murmur3_bytes_rows(torch.as_tensor(mat), torch.as_tensor(lengths),
                                torch.as_tensor(seed))
    want = RPN.murmur3_bytes_rows(jnp, jnp.asarray(mat), jnp.asarray(lengths),
                                  jnp.asarray(seed.view(np.uint32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


def test_hash_cpu_takes_plain_and_counts_nothing():
    mat, lengths, seed = (torch.as_tensor(a) for a in hash_case(100, 8))
    before = HK.murmur3_bytes_rows.launches
    got = HK.murmur3_bytes_rows(mat, lengths, seed)
    assert torch.equal(got, HK.murmur3_bytes_rows_plain(mat, lengths, seed))
    assert HK.murmur3_bytes_rows.launches == before


def test_chip_smoke_numpy_murmur3_matches_reference():
    """The known-answer murmur3 that ``chip_smoke.py`` holds the kernel
    against is Spark's too."""
    import chip_smoke as CS
    mat, lengths, seed = hash_case(500, 128)
    raw = np.where(mat < 0, 0, mat).astype(np.uint8)
    got = CS.np_murmur3_bytes(raw, lengths, seed.view(np.uint32))
    want = RPN.murmur3_bytes_rows(jnp, jnp.asarray(mat), jnp.asarray(lengths),
                                  jnp.asarray(seed.view(np.uint32)))
    np.testing.assert_array_equal(got, np.asarray(want))
    v = _I64[:512]
    np.testing.assert_array_equal(
        CS.np_hash_longs(v, _S[:512]),
        np.asarray(RPN.murmur3_int64(jnp, jnp.asarray(v),
                                     jnp.asarray(_S[:512]))))


def test_pmod_partition_matches_reference():
    h = _I32
    got = PN.pmod_partition(torch.as_tensor(h), 16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(RPN.pmod_partition(jnp.asarray(h), 16)))


# --------------------------------------------------------------------------
# partitioners
# --------------------------------------------------------------------------

KEY_SETS = [["a"], ["s"], ["d"], ["b"], ["k", "s", "a"]]


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("keys", KEY_SETS, ids="+".join)
def test_hash_partitioner_ids_match_reference(keys, lazy, pallas):
    rb, pb = both_batches(lazy=lazy)
    ref = RPR.HashPartitioner([rcol(k) for k in keys], 7, rb.schema,
                              pallas=PALLAS if pallas else None)
    port = PR.HashPartitioner([col(k) for k in keys], 7, pb.schema)
    got = port.device_ids(pb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.device_ids(rb)))


@pytest.mark.parametrize("keys", [["f"], ["s", "k"], ["f", "s"]],
                         ids="+".join)
def test_hash_partitioner_on_flat_strings_matches_reference(keys):
    rb, pb = string_batches(lazy=True)
    ref = RPR.HashPartitioner([rcol(k) for k in keys], 16, rb.schema)
    port = PR.HashPartitioner([col(k) for k in keys], 16, pb.schema)
    np.testing.assert_array_equal(port.device_ids(pb).numpy(),
                                  np.asarray(ref.device_ids(rb)))


@pytest.mark.parametrize("start", [0, 5])
def test_round_robin_and_single_ids_match_reference(start):
    rb, pb = both_batches(lazy=False)
    np.testing.assert_array_equal(
        PR.RoundRobinPartitioner(4, start).device_ids(pb).numpy(),
        np.asarray(RPR.RoundRobinPartitioner(4, start).device_ids(rb)))
    np.testing.assert_array_equal(
        PR.SinglePartitioner().device_ids(pb).numpy(),
        np.asarray(RPR.SinglePartitioner().device_ids(rb)))


def test_partitioner_factory_modes():
    _, pb = both_batches(lazy=False)
    src = E.DeviceSourceExec(pb)
    assert isinstance(PR.partitioner_factory("hash", 3, keys=[col("a")])(src),
                      PR.HashPartitioner)
    assert PR.partitioner_factory("round_robin", 3)(src).n_parts == 3
    assert PR.partitioner_factory("single", 1)(src).n_parts == 1
    with pytest.raises(NotImplementedError, match="range"):
        PR.partitioner_factory("range", 3)(src)


# --------------------------------------------------------------------------
# serializer and codec
# --------------------------------------------------------------------------


def _round_trip(pb, a: int, b: int):
    """Rows [a, b) of a port batch through download, serialize,
    deserialize and upload."""
    phys = KR.physical(pb)
    cols, _ = download_columns(phys, int(phys.n_rows))
    payload = SER.serialize_block([c.slice(a, b) for c in cols], pb.schema)
    schema, back = SER.deserialize_block(payload)
    assert schema == pb.schema
    return phys, upload_columns(back, schema, "cpu")


def _host_rows(batch, a=None, b=None) -> HostBatch:
    hb = HostBatch.from_device(batch)
    if a is None:
        return hb
    return HostBatch({k: v[a:b] for k, v in hb.columns.items()}, hb.schema,
                     {k: v[a:b] for k, v in hb.validity.items()})


def _assert_host_equal(got: HostBatch, want: HostBatch) -> None:
    assert got.schema == want.schema
    for name in want.columns:
        np.testing.assert_array_equal(got.validity[name], want.validity[name],
                                      err_msg=name)
        g, w = got.columns[name], want.columns[name]
        if w.dtype == object:
            g, w = np.asarray(g, object), np.asarray(w, object)
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("source", ["nulls and dictionary", "flat strings"])
@pytest.mark.parametrize("rows", ["all", "middle", "empty"])
def test_serializer_round_trip(source, rows):
    _, pb = both_batches(lazy=True) if source == "nulls and dictionary" \
        else string_batches(lazy=True)
    n = int(pb.n_rows)
    a, b = {"all": (0, n), "middle": (17, n - 40), "empty": (5, 5)}[rows]
    phys, back = _round_trip(pb, a, b)
    assert int(back.n_rows) == b - a
    assert back.capacity == max(128, 1 << max(b - a - 1, 0).bit_length())
    _assert_host_equal(_host_rows(back), _host_rows(phys, a, b))
    for got, want in zip(back.columns, phys.columns):
        assert got.is_dict == want.is_dict and got.is_flat == want.is_flat
        if want.is_dict:  # codes and dictionary travel unchanged
            assert got.dict_sorted == want.dict_sorted
            np.testing.assert_array_equal(got.dictionary, want.dictionary)
            np.testing.assert_array_equal(got.codes.numpy()[:b - a],
                                          want.codes.numpy()[a:b])
        if want.is_flat:
            assert got.max_bytes == want.max_bytes


def test_codecs():
    assert CODEC.get_codec("none").compress(b"xy") == b"xy"
    assert CODEC.get_codec("copy").name == "none"
    with pytest.raises(NotImplementedError):
        CODEC.get_codec("zstd")
    with pytest.raises(ValueError):
        CODEC.get_codec("brotli")


def test_deserialize_refuses_a_foreign_block():
    with pytest.raises(ValueError, match="magic"):
        SER.deserialize_block(b"ARROW1" + bytes(64))


# --------------------------------------------------------------------------
# concat and the merge-mode aggregate
# --------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["fixed and dictionary", "flat strings"])
def test_concat_matches_reference(source):
    if source == "fixed and dictionary":
        (r1, p1), (r2, p2) = both_batches(seed=3), both_batches(n=300, seed=4)
    else:
        r1, p1 = string_batches(lazy=True)
        r2, p2 = string_batches(lazy=False)
    cap = 2048
    want = RKC.concat_batches([r1, r2], cap)
    got = KC.concat_batches([p1, p2], cap)
    assert int(got.n_rows) == int(want.n_rows)
    live = np.asarray(want.row_mask())
    np.testing.assert_array_equal(got.row_mask().numpy(), live)
    for g, w in zip(got.columns, want.columns):
        if w.is_string and not w.is_dict:
            assert g.is_flat
            assert_same_strings(g, w, live)
        else:
            assert_column(g, w, live)
        if w.is_dict:
            assert g.is_dict and not g.dict_sorted and not w.dict_sorted
            assert g.dict_size == int(w.offsets.shape[0]) - 1


def _agg_pair(keys):
    """(reference (groupings, aggs, buffer schema), port ...) of a grouped
    sum, count(*) and average over ``both_batches``' schema."""
    rb, pb = both_batches()
    out = []
    for lg, agg, c, schema, exec_cls, resolve in (
            (RL, RAGG, rcol, rb.schema, RE.TpuHashAggregateExec, RL.resolve),
            (L, AGG, col, pb.schema, E.HashAggregateExec, L.resolve)):
        groupings = [resolve(c(k), schema).bind(schema) for k in keys]
        aggs = [agg.AggregateExpression(resolve(f, schema).bind(schema), n)
                for f, n in ((agg.Sum(c("b")), "s"), (agg.Count(), "n"),
                             (agg.Average(c("a")), "m"))]
        buf_schema = exec_cls(None, groupings, aggs)._buffer_schema()
        out.append((groupings, aggs, buf_schema))
    return out


@pytest.mark.parametrize("dense_mode", [0, 1])
@pytest.mark.parametrize("keys", [["s"], ["a"], ["a", "s"]], ids="+".join)
def test_merge_mode_aggregate_matches_reference(keys, dense_mode):
    (rg, raggs, rbuf), (pg, paggs, pbuf) = _agg_pair(keys)
    n_keys = len(keys)
    partials = []
    for seed in (3, 4):
        rb, _ = both_batches(seed=seed)
        out, _ = RE._aggregate_batch(rb, rg, raggs, rbuf, n_keys,
                                     update_mode=True, dense_mode=1)
        partials.append(out)
    rcat = RKC.concat_batches(partials, 1024)
    pcat = to_port(rcat)
    rrefs = [RBound(i, f.data_type, f.nullable)
             for i, f in enumerate(rbuf)][:n_keys]
    prefs = [BoundReference(i, f.data_type, f.nullable)
             for i, f in enumerate(pbuf)][:n_keys]
    want, rfail = RE._aggregate_batch(rcat, rrefs, raggs, rbuf, n_keys,
                                      update_mode=False,
                                      dense_mode=dense_mode)
    got, pfail = E.aggregate_batch(pcat, prefs, paggs, pbuf, n_keys, False,
                                   dense_mode)
    assert (rfail is None) == (pfail is None)
    if pfail is not None:
        assert bool(pfail) == bool(rfail)
    assert int(got.n_rows) == int(want.n_rows) > 1
    live = np.asarray(want.row_mask())
    np.testing.assert_array_equal(got.row_mask().numpy(), live)
    for i, (g, w) in enumerate(zip(got.columns, want.columns)):
        float_sum = pbuf[i].data_type is T.DOUBLE
        assert_column(g, w, live, rtol=1e-12 if float_sum else 0.0)


def test_multi_batch_aggregate_equals_one_batch():
    """Partials per batch, merged by the stack, give the one-batch
    answer: a union of four slices of a table through a round-robin
    exchange regroups to the same sums and counts."""
    from spark_rapids_tpu_torch.session import TorchSession
    rng = np.random.default_rng(2)
    n = 5000
    data = {"k": rng.integers(0, 40, n), "v": rng.integers(-9, 9, n),
            "s": np.array(["x", "yy", "zzz"])[rng.integers(0, 3, n)]}
    s = TorchSession(device="cpu")
    df = s.create_dataframe(data)

    def q(d):
        return d.group_by(col("s"), col("k")).agg(
            AGG.AggregateExpression(AGG.Sum(col("v")), "t"),
            AGG.AggregateExpression(AGG.Count(), "c")).collect()
    one, many = q(df), q(df.repartition(5))
    assert s.last_query.site_kinds == ["aggregate"]
    assert set(s.last_query.exec_ms) >= {"HashAggregateExec",
                                         "HashAggregateExec.merge"}
    for name in ("s", "k", "t", "c"):
        np.testing.assert_array_equal(np.asarray(many.columns[name]),
                                      np.asarray(one.columns[name]))
