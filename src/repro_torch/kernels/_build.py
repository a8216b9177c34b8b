"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own into
a shared library under ``build/repro_torch/`` at the repository root (a
directory ``.gitignore`` lists), named by a hash of its source and flags so
an edited source rebuilds. All missing libraries build in parallel: one
``nvcc`` process per source, started together. Libraries load with
``ctypes``; callers declare the argument types.
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
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"aa_match": CSRC / "aa_match.cu",
           "ripple": CSRC / "ripple.cu",
           "share_onehot": CSRC / "share_onehot.cu",
           "ss_matmul": CSRC / "ss_matmul.cu"}
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: per library: build seconds and nvcc's resource report (``-Xptxas -v``)
BUILD_INFO: Dict[str, dict] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def build_all() -> Dict[str, dict]:
    """Compile every library that is not built yet, all in parallel.
    Returns BUILD_INFO; raises RuntimeError with nvcc's output on failure."""
    todo = {n: _lib_path(n) for n in SOURCES if not _lib_path(n).exists()}
    if not todo:
        return BUILD_INFO
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        procs[name] = (subprocess.Popen(
            [nvcc, *FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        BUILD_INFO[name] = dict(seconds=time.perf_counter() - t0, log=log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return BUILD_INFO


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib
