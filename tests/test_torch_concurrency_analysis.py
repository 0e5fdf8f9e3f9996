"""The port's static concurrency analyzer
(``spark_rapids_tpu_torch/analysis/concurrency.py``) against the
reference's (``spark_rapids_tpu/analysis/concurrency.py``, loaded by path
as ``tools/tpu_lint.py`` loads it): the reference's synthetic packages go
through both analyzers and give the same findings by (rule, file,
function); the port-only blocking calls (device sync, downloads, a child
process's ``communicate``) are flagged under a lock and exempt under an
``io_ok`` one; and the port's own tree passes its gate with an empty
baseline, an acyclic lock graph and its named locks found.
"""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
import threading

import pytest

from spark_rapids_tpu_torch.analysis import concurrency as PORT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_ROOT = os.path.join(REPO, "spark_rapids_tpu_torch")


def _load_reference():
    path = os.path.join(REPO, "spark_rapids_tpu", "analysis",
                        "concurrency.py")
    spec = importlib.util.spec_from_file_location("_ref_concurrency", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference()


def _write(root, files):
    for rel, source in files.items():
        full = os.path.join(root, rel)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        with open(full, "w") as f:
            f.write(textwrap.dedent(source))


def _where(model, finding):
    """(rule, file, function) of a finding: the innermost function of
    its file whose definition starts at or before its line."""
    best = None
    for fid, info in model.funcs.items():
        if info.path == finding.path and info.lineno <= finding.lineno \
                and (best is None or info.lineno >= best[0]):
            best = (info.lineno, fid.split("::", 1)[1])
    return (finding.rule, finding.path, best[1] if best else "<module>")


def _findings(mod, root):
    model = mod.analyze_tree(root)
    return sorted(_where(model, f) for f in model.findings), model


# The reference's synthetic packages (tests/test_concurrency_analysis.py),
# each with the findings per rule both analyzers must report.
CASES = {
    "nested_with_edge": ({"mod.py": """
        A = lockdep.lock("mod.A")
        B = lockdep.lock("mod.B")

        def f():
            with A:
                with B:
                    pass
        """}, {}),
    "ab_ba_cycle": ({"mod.py": """
        A = lockdep.lock("mod.A")
        B = lockdep.lock("mod.B")

        def fa():
            with A:
                with B:
                    pass

        def fb():
            with B:
                with A:
                    pass
        """}, {"lock-cycle": 1}),
    "consistent_order": ({"mod.py": """
        A = lockdep.lock("mod.A")
        B = lockdep.lock("mod.B")

        def fa():
            with A:
                with B:
                    pass

        def fb():
            with A:
                with B:
                    pass
        """}, {}),
    "cycle_through_calls": ({"mod.py": """
        A = lockdep.lock("mod.A")
        B = lockdep.lock("mod.B")

        def fa():
            with A:
                take_b()

        def take_b():
            with B:
                pass

        def fb():
            with B:
                take_a()

        def take_a():
            with A:
                pass
        """}, {"lock-cycle": 1}),
    "rlock_reentry": ({"mod.py": """
        R = lockdep.rlock("mod.R")

        def f():
            with R:
                g()

        def g():
            with R:
                pass
        """}, {}),
    "plain_lock_self_nesting": ({"mod.py": """
        L = lockdep.lock("mod.L")

        def f():
            with L:
                with L:
                    pass
        """}, {"lock-cycle": 1}),
    "sleep_under_lock": ({"mod.py": """
        import time
        L = lockdep.lock("mod.L")

        def f():
            with L:
                time.sleep(1)
        """}, {"hold-across-blocking": 1}),
    "released_before_blocking": ({"mod.py": """
        import time
        L = lockdep.lock("mod.L")

        def f():
            with L:
                pass
            time.sleep(1)
        """}, {}),
    "io_ok_exempt": ({"mod.py": """
        import time
        L = lockdep.lock("mod.L", io_ok=True)

        def f():
            with L:
                time.sleep(1)
        """}, {}),
    "transitive_blocking": ({"mod.py": """
        import time
        L = lockdep.lock("mod.L")

        def f():
            with L:
                helper()

        def helper():
            time.sleep(1)
        """}, {"hold-across-blocking": 1}),
    "lockdep_blocking_region": ({"mod.py": """
        L = lockdep.lock("mod.L")

        def f():
            with L:
                with lockdep.blocking("device.dispatch"):
                    pass
        """}, {"hold-across-blocking": 1}),
    "with_open_under_lock": ({"mod.py": """
        L = lockdep.lock("mod.L")

        def f(p):
            with L:
                with open(p) as fh:
                    return fh
        """}, {"hold-across-blocking": 1}),
    "call_in_with_context": ({"mod.py": """
        import time
        L = lockdep.lock("mod.L")

        def f():
            with L:
                with helper():
                    pass

        def helper():
            time.sleep(1)
        """}, {"hold-across-blocking": 1}),
    "str_and_path_join": ({"mod.py": """
        import os
        L = lockdep.lock("mod.L")

        def f(names, d):
            with L:
                msg = ", ".join(names)
                p = os.path.join(d, msg)
            return p
        """}, {}),
    "bare_thread_join": ({"mod.py": """
        L = lockdep.lock("mod.L")

        def f(t):
            with L:
                t.join()
        """}, {"hold-across-blocking": 1}),
    "ignore_marker": ({"mod.py": """
        import time
        L = lockdep.lock("mod.L")

        def f():
            with L:
                time.sleep(1)  # concurrency: ignore
        """}, {}),
    "submitted_global_write": ({"mod.py": """
        STATS = {"n": 0}

        def work():
            STATS["n"] += 1

        def go(pool):
            pool.submit(work)
        """}, {"unguarded-shared-write": 1}),
    "guarded_global_write": ({"mod.py": """
        STATS = {"n": 0}
        L = lockdep.lock("mod.L")

        def work():
            with L:
                STATS["n"] += 1

        def go(pool):
            pool.submit(work)
        """}, {}),
    "non_worker_global_write": ({"mod.py": """
        STATS = {"n": 0}

        def main_thread_only():
            STATS["n"] += 1
        """}, {}),
    "ordered_map_iter_callback": ({"mod.py": """
        STATS = {"rows": 0}

        def decode(unit):
            STATS["rows"] += 1
            return unit

        def scan(items, ctx):
            return ordered_map_iter(decode, items, ctx)
        """}, {"unguarded-shared-write": 1}),
    "escaping_generator_closure": ({"mod.py": """
        def outer(specs, ctx):
            drained = {"n": 0}

            def read_spec(s):
                drained["n"] += 1
                yield s
            return [prefetch_iter(read_spec(s), ctx=ctx)
                    for s in specs]
        """}, {"unguarded-shared-write": 1}),
    "inline_helper_closure": ({"mod.py": """
        def work(items):
            acc = {"n": 0}

            def bump(x):
                acc["n"] += 1
                return x
            return [bump(i) for i in items]

        def go(pool, items):
            pool.submit(work, items)
        """}, {}),
    "plain_global_rebind": ({"mod.py": """
        _CACHE = None
        _COUNT = 0

        def work(x):
            global _CACHE, _COUNT
            _CACHE = x
            _COUNT += 1

        def go(pool):
            pool.submit(work, 1)
        """}, {"unguarded-shared-write": 2}),
    "threading_local_writes": ({"mod.py": """
        import threading
        TLS = threading.local()

        def work():
            TLS.stack = []

        def go(pool):
            pool.submit(work)
        """}, {}),
    "unlocked_self_write": ({"mod.py": """
        class Catalog:
            def __init__(self):
                self._lock = lockdep.lock("Catalog._lock")
                self.n = 0

            def good(self):
                with self._lock:
                    self.n += 1

            def bad(self):
                self.n += 1

        def go(pool, c):
            pool.submit(c.bad)
            pool.submit(c.good)
        """}, {"unguarded-shared-write": 1}),
    "helper_always_under_lock": ({"mod.py": """
        class Catalog:
            def __init__(self):
                self._lock = lockdep.lock("Catalog._lock")
                self.n = 0

            def bump(self):
                with self._lock:
                    self._bump_locked()

            def _bump_locked(self):
                self.n += 1

        def go(pool, c):
            pool.submit(c.bump)
        """}, {}),
    "two_modules": ({"a.py": """
        import time
        A = lockdep.lock("a.A")

        def fa():
            with A:
                take_b()
        """, "b.py": """
        B = lockdep.lock("b.B")

        def take_b():
            with B:
                pass

        def fb():
            with B:
                hold_a()

        def hold_a():
            with A:
                time.sleep(0)
        """}, {"lock-cycle": 1, "hold-across-blocking": 2}),
}


def _counts(found):
    out = {}
    for rule, _, _ in found:
        out[rule] = out.get(rule, 0) + 1
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_synthetic_case_matches_reference(case, tmp_path):
    files, expect = CASES[case]
    root = str(tmp_path / "pkg")
    _write(root, files)
    port, port_model = _findings(PORT, root)
    ref, ref_model = _findings(REF, root)
    assert port == ref
    assert _counts(port) == expect
    assert set(port_model.locks) == set(ref_model.locks)
    assert {a: set(d) for a, d in port_model.edges.items()} == \
        {a: set(d) for a, d in ref_model.edges.items()}


def test_lock_discovery_matches_reference(tmp_path):
    root = str(tmp_path / "pkg")
    _write(root, {"mod.py": """
        import threading
        A = lockdep.lock("mod.A")
        B = lockdep.rlock("mod.B", io_ok=True)
        C = threading.Lock()

        class Cat:
            D = threading.RLock()

            def __init__(self):
                self._lock = lockdep.lock("Cat._lock")
        """})
    port = PORT.analyze_tree(root).locks
    ref = REF.analyze_tree(root).locks
    assert set(port) == {"mod.py::A", "mod.py::B", "mod.py::C",
                         "mod.py::Cat.D", "mod.py::Cat._lock"}
    for lid in port:
        p, r = port[lid], ref[lid]
        assert (p.kind, p.io_ok, p.declared, p.lineno) == \
            (r.kind, r.io_ok, r.declared, r.lineno)


# -- the port's own blocking calls --------------------------------------------

PORT_ONLY = {
    "cuda_synchronize": ("""
        import torch
        L = lockdep.lock("mod.L"{io})

        def f():
            with L:
                torch.cuda.synchronize()
        """, "device sync"),
    "item_download": ("""
        L = lockdep.lock("mod.L"{io})

        def f(t):
            with L:
                return t.sum().item()
        """, "device->host download"),
    "cpu_download": ("""
        L = lockdep.lock("mod.L"{io})

        def f(t):
            with L:
                return t.cpu()
        """, "device->host download"),
    "communicate": ("""
        import subprocess
        L = lockdep.lock("mod.L"{io})

        def build(cmd):
            with L:
                proc = subprocess.Popen(cmd)
                proc.communicate()
        """, "child process wait"),
}


@pytest.mark.parametrize("case", sorted(PORT_ONLY))
@pytest.mark.parametrize("io_ok", [False, True])
def test_port_blocking_calls(case, io_ok, tmp_path):
    source, kind = PORT_ONLY[case]
    root = str(tmp_path / "pkg")
    _write(root, {"mod.py": source.replace(
        "{io}", ", io_ok=True" if io_ok else "")})
    found = [f for f in PORT.analyze_tree(root).findings
             if f.rule == "hold-across-blocking"]
    if io_ok:
        assert found == []
    else:
        assert len(found) == 1 and kind in found[0].message


def test_tensor_method_names_do_not_resolve_to_functions(tmp_path):
    # a package function named like a tensor or str method is not what
    # `t.cpu()` or `s.encode()` calls: no chain through it
    root = str(tmp_path / "pkg")
    _write(root, {"mod.py": """
        import time
        L = lockdep.lock("mod.L")

        def encode(x):
            time.sleep(1)

        def numpy(x):
            time.sleep(1)

        def f(s, a):
            with L:
                s.encode()
                a.numpy()
        """})
    assert PORT.analyze_tree(root).findings == []


def test_threading_local_subclass_is_per_thread(tmp_path):
    root = str(tmp_path / "pkg")
    _write(root, {"mod.py": """
        import threading

        class _Sink(threading.local):
            value = None

        SINK = _Sink()

        def work():
            SINK.value = []

        def go(pool):
            pool.submit(work)
        """})
    assert PORT.analyze_tree(root).findings == []


@pytest.mark.parametrize("entry", ["submit_spill_io",
                                   "materialize_boundaries"])
def test_port_worker_entries(entry, tmp_path):
    root = str(tmp_path / "pkg")
    _write(root, {"mod.py": f"""
        STATS = {{"n": 0}}

        def work():
            STATS["n"] += 1

        def go(pool):
            {entry}(work)
        """})
    found = PORT.analyze_tree(root).findings
    assert [f.rule for f in found] == ["unguarded-shared-write"]


# -- the port's own tree ------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    return PORT.analyze_tree(PKG_ROOT)


def test_port_passes_its_gate():
    assert PORT.run(PKG_ROOT, PORT.BASELINE_PATH) == 0


def test_baseline_is_empty_and_equals_reality(model):
    with open(PORT.BASELINE_PATH) as f:
        assert json.load(f)["counts"] == {}
    assert PORT.load_baseline(PORT.BASELINE_PATH) == {}
    assert PORT.counts_of(model.findings) == {}


def test_port_lock_graph_is_acyclic(model):
    assert [f for f in model.findings if f.rule == "lock-cycle"] == []


def test_port_named_locks_discovered(model):
    for lid in ("session.py::TorchSession._profiles_lock",
                "session.py::TorchSession._state_lock",
                "memory/spill.py::BufferCatalog._lock",
                "memory/spill.py::SpillFile._lock",
                "exec/pipeline.py::PipelinePool._lock",
                "ops/kernels/cuda/_build.py::_LOCK",
                "compile/persist.py::CompileManifest._lock",
                "analysis/plan_lint.py::LintMemo._lock"):
        assert lid in model.locks, lid
    assert model.locks["ops/kernels/cuda/_build.py::_LOCK"].io_ok
    assert model.locks["compile/persist.py::_LOCK"].io_ok


def test_port_real_nesting_edges(model):
    assert "exec/pipeline.py::PipelinePool._lock" \
        in model.edges["exec/pipeline.py::_UnitScheduler._lock"]
    assert "memory/spill.py::SpillFile._lock" \
        in model.edges["memory/spill.py::BufferCatalog._lock"]


def test_inventory_lists_locks_and_edges(model):
    md = PORT.inventory_markdown(model)
    assert "TorchSession._profiles_lock" in md and "→" in md


def test_cli_module_runs_over_the_port():
    r = subprocess.run(
        [sys.executable, "-m", "spark_rapids_tpu_torch.analysis.concurrency"],
        cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "concurrency analysis clean" in r.stdout


def test_cli_custom_root_and_baseline(tmp_path):
    root = str(tmp_path / "pkg")
    body = "import time\nL = lockdep.lock(\"mod.L\")\n\n"
    _write(root, {"mod.py": body + "def f0():\n    with L:\n"
                  "        time.sleep(1)\n"})
    baseline = str(tmp_path / "baseline.json")
    assert PORT.main(["--root", root]) == 1
    assert PORT.main(["--root", root, "--baseline", baseline,
                      "--update-baseline"]) == 0
    assert PORT.main(["--root", root, "--baseline", baseline]) == 0
    _write(root, {"mod.py": body + "".join(
        f"def f{i}():\n    with L:\n        time.sleep(1)\n"
        for i in range(2))})
    assert PORT.main(["--root", root, "--baseline", baseline]) == 1
    assert PORT.main(["--root", root, "--inventory"]) == 0


# -- the faults the analyzer found in the port, fixed -------------------------


class _CountingLock:
    """A lock that counts its acquisitions."""

    def __init__(self):
        self._lock = threading.Lock()
        self.entered = 0

    def __enter__(self):
        self._lock.acquire()
        self.entered += 1
        return self

    def __exit__(self, *exc):
        self._lock.release()


def _stress(fn, n_threads=16):
    """``fn`` on more threads than the machine has cores, with a short
    switch interval, each join bounded."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=fn) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)


def test_kernel_launch_counts_are_exact_across_threads():
    # the wrappers' counts were bare `+= 1` from the query thread and the
    # pipeline's workers; count_launch takes a lock
    from spark_rapids_tpu_torch.ops.kernels import cuda as KCUDA

    def owner():
        pass
    owner.launches = 0

    def hammer():
        for _ in range(5000):
            KCUDA.count_launch(owner)
    _stress(hammer)
    assert owner.launches == 16 * 5000
    # the count is taken under the lock, not by the interpreter's luck
    counting = _CountingLock()
    real = KCUDA._COUNT_LOCK
    KCUDA._COUNT_LOCK = counting
    try:
        KCUDA.count_launch(owner)
    finally:
        KCUDA._COUNT_LOCK = real
    assert counting.entered == 1 and owner.launches == 16 * 5000 + 1


def test_capture_recording_is_per_thread():
    # a capture records only its own thread's launches, not those of a
    # query running beside a background capture
    from spark_rapids_tpu_torch.ops.kernels import cuda as KCUDA
    from spark_rapids_tpu_torch.ops.kernels.cuda import segmented as SEG
    other = threading.Event()

    def beside():
        KCUDA.count_launch(SEG._COUNTED)
        other.set()
    before = SEG._COUNTED.launches
    with KCUDA.recording_launches() as rec:
        KCUDA.count_launch(SEG._COUNTED)
        t = threading.Thread(target=beside)
        t.start()
        t.join()
    assert other.is_set()
    assert rec == {("segmented", "_COUNTED"): 1}
    SEG._COUNTED.launches = before


def test_site_numbers_unique_across_threads():
    import torch
    from spark_rapids_tpu_torch.exec.execs import ExecContext
    ctx = ExecContext(torch.device("cpu"))

    def take():
        for _ in range(1000):
            ctx.next_site("join")
    _stress(take)
    assert sorted(ctx.site_ids) == list(range(16000))
    assert ctx._site_seq == 16000 and len(ctx.site_kinds) == 16000
    ctx._lock = _CountingLock()
    assert ctx.next_site("aggregate") == 16000
    assert ctx._lock.entered == 1


def test_concurrent_queries_keep_the_session_state():
    # _learned, _join_caps and the last_* slots are written under
    # TorchSession._state_lock by concurrent queries of one session
    import numpy as np
    from spark_rapids_tpu_torch.session import TorchSession
    from spark_rapids_tpu_torch.workloads import tpch
    s = TorchSession(device="cpu")
    d = tpch.load(s, tpch.gen_tables(1 << 10, seed=7))
    serial = tpch.q3(d).collect()
    errors, outs = [], []

    def run():
        try:
            outs.append(tpch.q3(d).collect())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(outs) == 4
    for out in outs:
        for name in serial.schema.names:
            np.testing.assert_array_equal(out.columns[name],
                                          serial.columns[name])
    assert s.last_query is not None and s.last_query.attempts == 1
