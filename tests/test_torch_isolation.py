"""The port stands alone: no module of ``spark_rapids_tpu_torch``, and not
``chip_smoke.py``, imports JAX, pyarrow or the JAX package — checked by a
scan of the sources and by importing every module in a subprocess that
refuses those imports. The session needs CUDA unless the caller asks for
the CPU, and ``chip_smoke.py`` fails without a card."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.session import TorchSession

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "spark_rapids_tpu_torch"
BLOCKED = ("jax", "jaxlib", "pyarrow", "spark_rapids_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _blocked(module: str) -> bool:
    return module.split(".")[0] in BLOCKED


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) and (
                    getattr(node.func, "id", None) == "__import__"
                    or getattr(node.func, "attr", None) == "import_module"):
            yield node.args[0].value


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_nothing_of_jax_or_reference(path):
    bad = [m for m in _imports(path) if _blocked(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


_GUARD = """
import importlib.abc, pkgutil, sys
BLOCKED = {blocked!r}
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {root!r})
import spark_rapids_tpu_torch as pkg
names = [m.name for m in pkg_walk(pkg)]
for n in names:
    importlib.import_module(n)
import chip_smoke
print(len(names))
"""


def test_every_module_imports_with_jax_and_reference_blocked():
    code = _GUARD.format(blocked=BLOCKED, root=str(ROOT)).replace(
        "pkg_walk(pkg)",
        "pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


def test_session_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        assert TorchSession().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchSession()


def test_cpu_session_runs_a_query():
    from spark_rapids_tpu_torch.ops import predicates as P
    from spark_rapids_tpu_torch.ops.expression import col, lit
    s = TorchSession(device="cpu")
    df = s.create_dataframe(
        {"k": np.array([3, 1, 2, 5], np.int64),
         "d": np.array([9000, 9300, 9100, 9500], np.int32),
         "s": np.array(["b", "a", None, "a"], dtype=object)},
        T.Schema([T.StructField("k", T.LONG), T.StructField("d", T.DATE),
                  T.StructField("s", T.STRING)]))
    out = df.where(P.LessThan(col("d"), lit(9400, T.DATE))).collect()
    np.testing.assert_array_equal(out.columns["k"], [3, 1, 2])
    assert list(out.columns["s"]) == ["b", "a", None]
    np.testing.assert_array_equal(out.validity["s"], [True, True, False])


def _run_chip_smoke(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(cwd),
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_chip_smoke_fails_without_a_card():
    out = _run_chip_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_without_the_package(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_chip_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
