"""The upload cache (``data/upload_cache.py``) against the JAX package's:
the same sequence of inserts and lookups under the same byte budget
gives the same hits, misses and evictions. The port keys numpy arrays,
which are writable, so it caches only read-only ones: a written-to
array is never served stale. ``shrink_by``, the spill catalog's budget
and the OOM drain empty it.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.data import upload_cache as RU
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data import upload_cache as PU
from spark_rapids_tpu_torch.data.batch import HostBatch
from spark_rapids_tpu_torch.data.column import DeviceColumn
from spark_rapids_tpu_torch.exec import execs as E
from spark_rapids_tpu_torch.memory import retry as R
from spark_rapids_tpu_torch.memory.spill import BufferCatalog
from spark_rapids_tpu_torch.session import TorchSession

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def clean_caches():
    for m in (RU, PU):
        m.clear()
        for k in m.stats:
            m.stats[k] = 0
    saved = (RU._budget_bytes, PU._budget_bytes)
    yield
    for m in (RU, PU):
        m.clear()
    RU.set_budget(saved[0])
    PU.set_budget(saved[1])


class _RefCol:
    def __init__(self, nbytes):
        self.size_bytes = nbytes


def _port_col(rows: int) -> DeviceColumn:
    return DeviceColumn(torch.zeros(rows, dtype=torch.int64),
                        torch.ones(rows, dtype=torch.bool), T.LONG)


def _frozen(a):
    a = np.array(a)
    a.setflags(write=False)
    return a


def test_hit_miss_eviction_sequence_equals_reference():
    rows = [100, 300, 200, 50, 400]
    sizes = [PU.column_bytes(_port_col(r)) for r in rows]
    budget = sum(sizes[:3])
    RU.set_budget(budget)
    PU.set_budget(budget)
    ref_arrs = [pa.array(np.arange(r)) for r in rows]
    port_arrs = [(_frozen(np.arange(r)), _frozen(np.ones(r, bool)))
                 for r in rows]
    rng = np.random.default_rng(12)
    trace = []
    for step in range(120):
        i = int(rng.integers(len(rows)))
        cap = 1024
        pv, pm = port_arrs[i]
        if rng.random() < 0.5:
            got = PU.lookup(pv, pm, T.LONG, cap, CPU) is not None
            want = RU.lookup(ref_arrs[i], cap) is not None
            assert got == want, (step, i)
        else:
            PU.insert(pv, pm, T.LONG, cap, CPU, _port_col(rows[i]))
            RU.insert(ref_arrs[i], cap, _RefCol(sizes[i]))
        assert PU.stats == RU.stats, step
        assert PU.cache_bytes() == RU.cache_bytes(), step
        trace.append(dict(PU.stats))
    assert trace[-1]["hits"] and trace[-1]["misses"] \
        and trace[-1]["evictions"]


def test_writable_array_is_never_served_stale():
    s = TorchSession(device="cpu")
    data = {"a": np.arange(1000, dtype=np.int64)}
    first = s.create_dataframe(data).collect()
    data["a"][0] = 77  # the user writes to the array between uploads
    again = s.create_dataframe(data).collect()
    assert first.columns["a"][0] == 0 and again.columns["a"][0] == 77
    assert PU.stats["hits"] == 0 and PU.cache_bytes() == 0


def test_read_only_view_of_a_writable_base_is_not_cached():
    base = np.arange(1000, dtype=np.int64)
    view = base[:]
    view.setflags(write=False)
    assert not PU.frozen(view)
    s = TorchSession(device="cpu")
    s.create_dataframe(HostBatch.from_numpy({"a": view}))
    base[1] = 5
    got = s.create_dataframe(HostBatch.from_numpy({"a": view})).collect()
    assert got.columns["a"][1] == 5 and PU.stats["hits"] == 0


def test_frozen_batch_hits_and_keeps_its_answer():
    s = TorchSession(device="cpu")
    hb = HostBatch.from_numpy({"a": np.arange(500, dtype=np.int64),
                               "s": np.array(["x", "y"] * 250)},
                              T.Schema([T.StructField("a", T.LONG),
                                        T.StructField("s", T.STRING)]))
    hb.freeze()
    one = s.create_dataframe(hb)
    two = s.create_dataframe(hb)
    assert PU.stats["hits"] == 2 and PU.stats["misses"] == 2
    assert one._plan.batch.columns[0] is two._plan.batch.columns[0]
    got = two.collect()
    np.testing.assert_array_equal(got.columns["a"], np.arange(500))
    assert list(got.columns["s"][:3]) == ["x", "y", "x"]
    with pytest.raises(ValueError):
        hb.columns["a"][0] = 1


def _fill(n=4, rows=1000):
    for i in range(n):
        v, m = _frozen(np.arange(rows) + i), _frozen(np.ones(rows, bool))
        PU.insert(v, m, T.LONG, 1024, CPU, _port_col(rows))


def test_shrink_by_frees_least_recent_first():
    _fill()
    total = PU.cache_bytes()
    per = total // 4
    assert PU.shrink_by(per + 1) == 2 * per
    assert PU.cache_bytes() == total - 2 * per
    assert PU.shrink_by(10 * total) == total - 2 * per
    assert PU.cache_bytes() == 0 and PU.stats["evictions"] == 4


def test_oom_drain_empties_the_cache():
    _fill()
    assert PU.cache_bytes() > 0
    ctx = E.ExecContext(CPU)
    moved = R.spill_device_below(ctx)
    assert PU.cache_bytes() == 0 and moved > 0


def test_catalog_budget_evicts_the_cache_first():
    _fill()
    per = PU.cache_bytes() // 4
    cat = BufferCatalog(2 * per, 1 << 30, device=CPU)
    cat.enforce_budgets()
    assert PU.cache_bytes() <= 2 * per
    assert cat.device_bytes == 0


def test_zero_budget_disables():
    PU.set_budget(0)
    _fill()
    assert PU.cache_bytes() == 0 and PU.stats["misses"] == 0
