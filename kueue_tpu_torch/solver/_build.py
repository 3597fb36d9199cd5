"""Build and load the hand-written CUDA kernels of the solver.

Each `csrc/<name>.cu` compiles with `nvcc` for Hopper (`sm_90a`) into a
shared library with plain `extern "C"` entries (`<name>_launch`, or for
a file with two, `<name>_<entry>_launch`; solve_preempt also has
`solve_preempt_plan`, its launch plan), loaded with ctypes: every
pointer and the stream pass as `c_void_p`, every size as `c_longlong`,
and the entry returns `cudaGetLastError()` after the launch. The libraries go to `_build/` beside this module (listed in
.gitignore), named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads as it is. All missing
libraries build at once, one `nvcc` process per source. Nothing builds
on import or on the CPU path: the first CUDA launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("avail", "phase_a", "drf_share", "order", "phase_b", "pack",
           "deltas", "arena_scatter", "arena_gather", "solve_preempt",
           "solve_fair", "cluster_cols", "mesh_combine", "global_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# nvcc's stderr per kernel (the ptxas register / shared-memory report),
# for the smoke run to print.
BUILD_LOG: dict = {}
# libraries compiled by nvcc in this process, and libraries asked for
# and found built already: the compile governor's provenance reads them
# (solver/warmgov.py)
EVENTS = {"builds": 0, "found": 0}
_entries: dict = {}
_lock = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under CUDA_HOME")


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(part.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> float:
    """Compile every kernel library that is missing, all in parallel.
    Returns the wall seconds spent (0.0 when everything was built)."""
    t0 = time.perf_counter()
    libs = [(n, library_path(n)) for n in names]
    todo = [(n, p) for n, p in libs if not p.exists()]
    EVENTS["found"] += len(libs) - len(todo)
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"tmp{os.getpid()}-{out.name}")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
    failed = []
    for name, out, tmp, proc in procs:
        _, err = proc.communicate()
        BUILD_LOG[name] = err.decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{name}:\n{BUILD_LOG[name]}")
            continue
        os.replace(tmp, out)
        EVENTS["builds"] += 1
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def entry(name: str, n_ptrs: int, n_ints: int, symbol: str = None):
    """The ctypes function `symbol` (default `<name>_launch`) of kernel
    `name`'s library, building the libraries first if needed. Arguments:
    n_ptrs pointers, n_ints sizes, the stream."""
    symbol = symbol or f"{name}_launch"
    fn = _entries.get(symbol)
    if fn is not None:
        return fn
    with _lock:
        fn = _entries.get(symbol)
        if fn is None:
            build_all()
            lib = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, symbol)
            fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                           + [ctypes.c_longlong] * n_ints + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _entries[symbol] = fn
    return fn
