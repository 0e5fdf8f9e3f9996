"""The port's string layouts and string operators against the JAX package.

Flat columns cross over from the reference with ``carry`` (offsets,
payload and ``max_bytes``); dictionary columns with their decoded
entries. Char matrices, offsets and payload bytes must be equal bit for
bit, as must ``In``'s answers and validity. The plain gather of
``ops/kernels/cuda/strings.py`` is held against the Pallas
``ragged_gather`` in interpret mode on the cases ``tests/test_torch_cuda.py``
runs on the card.
"""

import numpy as np
import pyarrow as pa
import pytest

import jax.numpy as jnp
import torch

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.data.batch import ColumnarBatch as RBatch
from spark_rapids_tpu.data.column import DeviceColumn as RColumn
from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops import strings as RS
from spark_rapids_tpu.ops import strings_util as RSU
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit
from spark_rapids_tpu.ops.kernels import pallas as PAL
from spark_rapids_tpu.ops.kernels import rowops as RKR
from spark_rapids_tpu.ops.kernels.pallas import strings as RSTR
from spark_rapids_tpu.plan import logical as RL

from spark_rapids_tpu_torch import carry
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.batch import ColumnarBatch, HostBatch
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops import strings as S
from spark_rapids_tpu_torch.ops import strings_util as SU
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.ops.kernels import rowops as KR
from spark_rapids_tpu_torch.ops.kernels.cuda import strings as SG
from spark_rapids_tpu_torch.plan import logical as L
from test_torch_cuda import STRING_CASES, gather_case
from test_torch_ops import port_schema, ref_fields

CONF = PAL.PallasConf(enabled=True)
WORDS = np.array(["13-455", "31-101", "7-9", "", "ÄRGER-12", "29-99999",
                  "18-3", "phone", "23-555-0199", "x"])


def string_table(n: int = 700, seed: int = 9) -> pa.RecordBatch:
    rng = np.random.default_rng(seed)
    s = WORDS[rng.integers(0, len(WORDS), n)]
    return pa.RecordBatch.from_arrays(
        [pa.array(s, pa.string(), mask=rng.random(n) < 0.1),
         pa.array(rng.integers(0, 50, n), pa.int64())], names=["s", "k"])


def batches(lazy: bool = True):
    """(reference batch, port batch) with a dictionary column ``s`` and
    a flat column ``f`` = substring(s, 1, 4) built by the reference."""
    rb = RBatch.from_arrow(string_table())
    if lazy:
        keep = np.random.default_rng(4).random(rb.capacity) < 0.85
        rb = RKR.compact(rb, jnp.asarray(keep))
    rsch = rb.schema
    flat = rbind(RS.Substring(rcol("s"), rlit(1), rlit(4)), rsch)
    fcol = flat.eval_device(rb)
    assert fcol.is_string and not fcol.is_dict
    rb = RBatch(rb.columns + (fcol,), rb.n_rows,
                RT.Schema(list(rsch) + [RT.StructField("f", RT.STRING)]),
                live=rb.live)
    live = None if rb.live is None else np.asarray(rb.live)
    pb = carry.batch_from_reference([ref_fields(c) for c in rb.columns],
                                    port_schema(rb.schema), int(rb.n_rows),
                                    live, device="cpu")
    return rb, pb


def rbind(expr, schema):
    return RL.resolve(expr, schema).bind(schema)


def assert_same_strings(got, want, live) -> None:
    """Flat or dictionary port column vs reference column: validity and
    the bytes of every live valid row."""
    live = np.asarray(live)
    np.testing.assert_array_equal(got.validity.numpy()[live],
                                  np.asarray(want.validity)[live])
    gm = SU.char_matrix(got).numpy()
    wm = np.asarray(RSU.char_matrix(want))
    assert gm.shape == wm.shape
    ok = live & np.asarray(want.validity)
    np.testing.assert_array_equal(gm[ok], wm[ok])


def assert_same_flat_buffers(got, want) -> None:
    np.testing.assert_array_equal(got.offsets.numpy(),
                                  np.asarray(want.offsets))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert got.max_bytes == want.max_bytes


# --------------------------------------------------------------------------
# layouts
# --------------------------------------------------------------------------


def test_flat_layout_round_trip_through_carry_and_collect():
    strings = ["CA", "", "toronto", "ÄRGER", "x" * 40, "13"]
    raw = [s.encode() for s in strings]
    offsets = np.concatenate([[0], np.cumsum([len(b) for b in raw])])
    valid = np.array([1, 1, 0, 1, 1, 1], bool)
    rc = RColumn.string_from_host(offsets, np.frombuffer(b"".join(raw),
                                                         np.uint8),
                                  valid, 128)
    pc = carry.column_from_reference(ref_fields(rc), T.STRING, device="cpu")
    assert pc.is_string and pc.is_flat and not pc.is_dict
    assert pc.max_bytes == rc.max_bytes == 128
    np.testing.assert_array_equal(SU.char_matrix(pc).numpy(),
                                  np.asarray(RSU.char_matrix(rc)))
    np.testing.assert_array_equal(SU.lengths(pc).numpy(),
                                  np.asarray(RSU.lengths(rc)))
    schema = T.Schema([T.StructField("s", T.STRING)])
    n = torch.tensor(len(strings))
    host = HostBatch.from_device(ColumnarBatch((pc,), n, schema))
    want = [s if v else None for s, v in zip(strings, valid)]
    assert host.columns["s"].tolist() == want
    np.testing.assert_array_equal(host.validity["s"], valid)


def test_dictionary_char_matrix_and_lengths_match_reference():
    rb, pb = batches(lazy=False)
    rs, ps = rb.column("s"), pb.column("s")
    assert ps.is_dict and ps.dict_sorted and ps.max_bytes == rs.max_bytes
    np.testing.assert_array_equal(SU.char_matrix(ps).numpy(),
                                  np.asarray(RSU.char_matrix(rs)))
    np.testing.assert_array_equal(SU.lengths(ps).numpy(),
                                  np.asarray(RSU.lengths(rs)))


def test_upload_marks_dictionaries_sorted_with_reference_widths():
    from spark_rapids_tpu_torch.session import TorchSession
    df = TorchSession(device="cpu").create_dataframe(
        {"s": np.array(["b", "a", "ccc"])})
    c = df._plan.batch.columns[0]
    assert c.is_dict and c.dict_sorted and c.max_bytes == 128
    assert list(c.dictionary) == ["a", "b", "ccc"]


@pytest.mark.parametrize("n", [0, 2, 128, 129, 5_000, 524_288, 33_554_432])
def test_byte_ladder_matches_reference(n):
    from spark_rapids_tpu.compile.ladder import bucket_byte_capacity as ref
    from spark_rapids_tpu_torch.compile.ladder import bucket_byte_capacity
    for floor in (1, 8, 128, 300):
        assert bucket_byte_capacity(n, floor) == ref(n, floor)


@pytest.mark.parametrize("w", [2, 8, 128])
def test_strings_from_matrix_bytes_match_reference(w):
    rng = np.random.default_rng(w)
    n = 300
    lens = rng.integers(0, w + 1, n)
    m = rng.integers(0, 256, (n, w)).astype(np.int16)
    m[np.arange(w)[None, :] >= lens[:, None]] = -1
    valid = rng.random(n) < 0.9
    got = KR.strings_from_matrix(torch.as_tensor(m), torch.as_tensor(valid),
                                 128)
    want = RKR.strings_from_matrix(jnp.asarray(m), jnp.asarray(valid), 128)
    assert_same_flat_buffers(got, want)


# --------------------------------------------------------------------------
# the gather kernel's plain version, and the flat gather
# --------------------------------------------------------------------------


@pytest.mark.parametrize("w", [8, 128])
@pytest.mark.parametrize("name", STRING_CASES)
def test_plain_gather_matches_pallas(name, w):
    mat, idx, valid = gather_case(name, w)
    want = RSTR.ragged_gather(jnp.asarray(mat), jnp.asarray(idx),
                              jnp.asarray(valid), CONF)
    assert want is not None
    got = SG.ragged_gather(torch.as_tensor(mat), torch.as_tensor(idx),
                           torch.as_tensor(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_cpu_takes_plain_and_counts_nothing():
    mat, idx, valid = (torch.as_tensor(a) for a in gather_case("all valid",
                                                               8))
    before = SG.ragged_gather.launches
    assert torch.equal(SG.ragged_gather(mat, idx, valid),
                       SG.ragged_gather_plain(mat, idx, valid))
    assert SG.ragged_gather.launches == before
    empty = SG.ragged_gather_plain(mat[:0], idx, valid)
    assert empty.shape == (idx.shape[0], 8) and bool((empty == -1).all())


@pytest.mark.parametrize("pallas", [False, True])
def test_flat_gather_column_matches_reference(pallas):
    rb, pb = batches()
    rng = np.random.default_rng(2)
    cap = rb.capacity
    idx = rng.integers(-3, cap + 3, 2 * cap).astype(np.int32)
    iv = rng.random(2 * cap) < 0.9
    want = RKR.gather_column(rb.column("f"), jnp.asarray(idx),
                             jnp.asarray(iv),
                             pallas=PAL.PallasConf(enabled=pallas))
    got = KR.gather_column(pb.column("f"), torch.as_tensor(idx),
                           torch.as_tensor(iv))
    assert got.is_flat
    assert_same_flat_buffers(got, want)
    np.testing.assert_array_equal(got.validity.numpy(),
                                  np.asarray(want.validity))


# --------------------------------------------------------------------------
# Substring and In
# --------------------------------------------------------------------------

SUBSTRINGS = [(1, 2), (2, 3), (0, 2), (-3, 2), (5, 0), (1, 200), (-40, 3)]


@pytest.mark.parametrize("pos,ln", SUBSTRINGS)
@pytest.mark.parametrize("source", ["s", "f"])
def test_substring_matches_reference(source, pos, ln):
    rb, pb = batches()
    want = rbind(RS.Substring(rcol(source), rlit(pos), rlit(ln)),
                      rb.schema).eval_device(rb)
    got = L.resolve(S.Substring(col(source), lit(pos), lit(ln)),
                    pb.schema).bind(pb.schema).eval_device(pb)
    assert got.is_flat
    assert_same_flat_buffers(got, want)
    assert_same_strings(got, want, rb.row_mask())


IN_LISTS = {"codes": ["13", "31", "23"], "with null": ["13", None, "7-9"],
            "none": [], "words": ["phone", "", "ÄRGER-12"]}


@pytest.mark.parametrize("source", ["s", "f"])
@pytest.mark.parametrize("name", list(IN_LISTS))
def test_in_on_strings_matches_reference(source, name):
    rb, pb = batches()
    values = IN_LISTS[name]
    want = rbind(RP.In(rcol(source), values), rb.schema).eval_device(rb)
    got = L.resolve(P.In(col(source), values),
                    pb.schema).bind(pb.schema).eval_device(pb)
    live = np.asarray(rb.row_mask())
    np.testing.assert_array_equal(got.validity.numpy()[live],
                                  np.asarray(want.validity)[live])
    ok = live & np.asarray(want.validity)
    np.testing.assert_array_equal(got.data.numpy()[ok],
                                  np.asarray(want.data)[ok])


@pytest.mark.parametrize("values", [[3, 7, 11], [3, None], []])
def test_in_on_integers_matches_reference(values):
    rb, pb = batches()
    want = rbind(RP.In(rcol("k"), values), rb.schema).eval_device(rb)
    got = L.resolve(P.In(col("k"), values),
                    pb.schema).bind(pb.schema).eval_device(pb)
    live = np.asarray(rb.row_mask())
    np.testing.assert_array_equal(got.validity.numpy()[live],
                                  np.asarray(want.validity)[live])
    ok = live & np.asarray(want.validity)
    np.testing.assert_array_equal(got.data.numpy()[ok],
                                  np.asarray(want.data)[ok])


def test_flat_string_comparison_is_refused():
    _, pb = batches()
    e = L.resolve(P.EqualTo(col("f"), lit("13")), pb.schema).bind(pb.schema)
    with pytest.raises(NotImplementedError):
        e.eval_device(pb)
