"""Build and load the CUDA kernels: ``nvcc`` by hand into one shared
library per source, with a plain C interface, loaded through ``ctypes``.

Sources live in ``csrc/``: the kernels (``<name>.cu``) and the host
routines (``<name>.cpp``, plain C++ that ``nvcc`` hands to the host
compiler: the parquet scan's snappy codec and run tables). Libraries go
to ``spark_rapids_tpu_torch/_build/`` (listed in ``.gitignore``), named
by a digest of the source and the flags so an edited source rebuilds. The build runs at first use, or
up front through :func:`build_all`, which starts one ``nvcc`` per source
at once. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

from ....utils import lockdep

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "_build"

#: The kernel sources (``csrc/<name>.cu``).
KERNELS = ("join_probe", "segmented", "sort_steps", "strings", "hashing")
#: The host routines (``csrc/<name>.cpp``).
HOST_ROUTINES = ("snappy", "parquet_runs", "crc32c")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Serialises the first load of each library, its build included: it
#: exists to be held across the ``nvcc`` run, so a second caller waits
#: for the build instead of starting its own.
_LOCK = lockdep.lock("_build._LOCK", io_ok=True)
_LOADED: Dict[str, ctypes.CDLL] = {}
#: Sources compiled by this process and the wall time of their builds
#: (the profile's ``engine["compile"]``).
_BUILDS = {"count": 0, "ns": 0}
_STATS_LOCK = lockdep.lock("_build._STATS_LOCK")


def build_stats() -> Dict[str, int]:
    """``{"count": sources compiled, "ns": wall time of those builds}``
    over the process."""
    with _STATS_LOCK:
        return dict(_BUILDS)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def source_path(name: str) -> Path:
    """``csrc/<name>.cu`` for a kernel, ``csrc/<name>.cpp`` for a host
    routine."""
    return CSRC / (f"{name}.cpp" if name in HOST_ROUTINES else f"{name}.cu")


def library_path(name: str) -> Path:
    src = source_path(name).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: Iterable[str] = KERNELS + HOST_ROUTINES
              ) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` process per source, all
    started together. Returns ``{name: ptxas report}`` for the sources
    compiled now; raises with the compiler output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter_ns()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{source_path(name).name}:\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if procs:
        with _STATS_LOCK:
            _BUILDS["count"] += len(reports)
            _BUILDS["ns"] += time.perf_counter_ns() - t0
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cpp``), built on
    first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.srt_error_string.argtypes = [ctypes.c_int]
            lib.srt_error_string.restype = ctypes.c_char_p
            _LOADED[name] = lib
        return lib


def check_lane(t, what: str, dtypes: tuple, n=None) -> None:
    """Raise unless ``t`` is a contiguous 1-D tensor of one of ``dtypes``
    (of length ``n`` when given): what a kernel's lane argument must be."""
    if t.dtype not in dtypes or t.dim() != 1 or not t.is_contiguous() \
            or (n is not None and t.shape[0] != n):
        want = f"[{n}]" if n is not None else "1-D"
        names = "/".join(str(d) for d in dtypes)
        raise ValueError(f"{what} must be a contiguous {want} {names} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.srt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc}: {msg}")
