"""``rand``, ``spark_partition_id()`` and ``monotonically_increasing_id()``
(``ops/nondeterministic.py``) through ``TorchSession`` on the CPU against
the JAX package's ``TpuSession`` device path, on the same inputs, bit
for bit.

As the reference's ``tests/test_expressions2.py:142-170``: ``rand(42)``
identical to the reference's (its hash counter, not Spark's XORShift
sequence), its distribution, partition ids and monotonic ids, ids
unique. Then what the chip cell runs: the three after a hash
repartition into 8 partitions (each partition's rows in the reference's
order, numbered from 0 in each), after a round-robin one, after a lazy
filter (the batch is made physical first, so rows are numbered as
logical rows), over a partition of several batches (the running row
offset), and ``rand`` against the reference's numpy ``_bits_np``. The
mesh refuses a nondeterministic projection.
"""

import numpy as np
import pytest

from spark_rapids_tpu.ops import nondeterministic as RND
from spark_rapids_tpu.ops import predicates as RP
from spark_rapids_tpu.ops.expression import col as rcol
from spark_rapids_tpu.ops.expression import lit as rlit

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.exec import execs as E
from spark_rapids_tpu_torch.exec import mesh as MX
from spark_rapids_tpu_torch.ops import nondeterministic as ND
from spark_rapids_tpu_torch.ops import predicates as P
from spark_rapids_tpu_torch.ops.expression import col, lit
from spark_rapids_tpu_torch.session import TorchSession

from test_torch_complex import check_same, frames

ONE_COL = T.Schema([T.StructField("a", T.LONG, False)])


def _frames(n: int):
    return frames({"a": list(range(n))}, ONE_COL)


def _nd(df, M, c):
    return df.with_column("r", M.Rand(42)).with_column(
        "p", M.SparkPartitionID()).with_column(
        "m", M.MonotonicallyIncreasingID()).select(c("a"), c("r"), c("p"),
                                                   c("m"))


def test_rand_matches_the_reference():
    pdf, rdf = _frames(500)
    check_same(pdf.with_column("r", ND.Rand(seed=42)).select(col("r")),
               rdf.with_column("r", RND.Rand(seed=42)).select(rcol("r")))


def test_rand_distribution():
    session = TorchSession(device="cpu")
    got = session.create_dataframe({"a": np.arange(20_000)}).with_column(
        "r", ND.Rand(7)).select(col("r")).collect().columns["r"]
    assert 0.0 <= got.min() and got.max() < 1.0
    assert abs(got.mean() - 0.5) < 0.02
    assert len(np.unique(got)) > 19_900


def test_partition_id_and_monotonic_id():
    pdf, rdf = _frames(100)
    check_same(_nd(pdf, ND, col), _nd(rdf, RND, rcol))


def test_monotonic_id_unique():
    session = TorchSession(device="cpu")
    got = session.create_dataframe({"a": np.arange(5000)}).with_column(
        "m", ND.MonotonicallyIncreasingID()).select(col("m")).collect()
    assert len(set(got.columns["m"].tolist())) == 5000


@pytest.mark.parametrize("seed", [0, 42, -7, 2 ** 40 + 3])
@pytest.mark.parametrize("pid", [0, 5])
def test_rand_bits_match_numpy_twin(seed, pid):
    """The torch int64 arithmetic against the reference's uint64 numpy
    ``_bits_np``, at a row base past 2^32, for negative and large
    seeds."""
    import torch
    from spark_rapids_tpu.ops.nondeterministic import eval_context as rctx
    n, base = 1000, (1 << 33) + 17
    with rctx(pid, base):
        bits = RND.Rand(seed)._bits_np(n)
    want = (bits >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    schema = T.Schema([T.StructField("a", T.LONG)])
    batch = HostBatch.from_numpy({"a": np.zeros(n, np.int64)},
                                 schema).to_device("cpu", n)
    with ND.eval_context(pid, torch.tensor(base)):
        got = ND.Rand(seed).eval_device(batch).data.numpy()
    assert got.tobytes() == want.tobytes()


def test_ids_after_hash_repartition():
    """After ``repartition(8, key)`` every partition numbers its own rows
    from 0, in the rows' order: ids, partition ids and ``rand`` equal the
    reference's row for row."""
    rng = np.random.default_rng(21)
    schema = T.Schema([T.StructField("a", T.LONG, False),
                       T.StructField("t", T.LONG)])
    pdf, rdf = frames({"a": list(range(600)),
                       "t": rng.integers(0, 50, 600).tolist()}, schema)
    check_same(_nd(pdf.repartition(8, col("t")), ND, col),
               _nd(rdf.repartition(8, rcol("t")), RND, rcol))


def test_ids_after_round_robin():
    pdf, rdf = _frames(300)
    check_same(_nd(pdf.repartition(3), ND, col),
               _nd(rdf.repartition(3), RND, rcol))


def test_ids_after_filter():
    """A lazy filter's survivors are numbered as logical rows."""
    from spark_rapids_tpu_torch.ops import arithmetic as AR
    pdf, rdf = _frames(400)
    check_same(
        _nd(pdf.where(P.EqualTo(AR.Remainder(col("a"), lit(3)), lit(0))),
            ND, col),
        _nd(rdf.where(RP.EqualTo(rcol("a") % 3, rlit(0))), RND, rcol))


def test_ids_over_a_partition_of_several_batches():
    """Two batches in one partition: the second numbers on from the
    first's rows (the running row offset), as one batch of both would."""
    session = TorchSession(device="cpu")
    batches = [session.create_dataframe({"a": np.arange(lo, hi)})._plan.batch
               for lo, hi in ((0, 200), (200, 500))]
    exprs = [ND.Rand(3).alias("r"), ND.MonotonicallyIncreasingID().alias("m")]
    got = E.collect(E.ProjectExec(_Batches(batches, batches[0].schema),
                                  exprs), E.ExecContext(session.device))
    want = session.create_dataframe({"a": np.arange(500)}).select(
        *exprs).collect()
    for name in ("r", "m"):
        assert got.columns[name].tobytes() == want.columns[name].tobytes()


class _Batches(E.TorchExec):
    """One partition of the given batches."""

    def __init__(self, batches, schema):
        self.children = []
        self.batches = batches
        self._schema = schema

    @property
    def schema(self):
        return self._schema

    def execute(self, ctx):
        return [iter(self.batches)]


def test_nondeterministic_refuses_the_mesh():
    session = TorchSession(device="cpu")
    df = session.create_dataframe({"a": np.arange(100)})
    assert MX.mesh_capable(session.plan(df.select(col("a"))._plan))
    assert not MX.mesh_capable(session.plan(
        df.with_column("r", ND.Rand(1))._plan))
