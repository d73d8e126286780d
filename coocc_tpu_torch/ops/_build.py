"""Build and load the port's CUDA kernels (csrc/*.cu) with nvcc + ctypes.

Each source compiles on first use into its own shared library with a plain C
interface, under `coocc_tpu_torch/_build/` (listed in .gitignore), named by
the hash of the source and of the headers beside it (csrc/*.cuh), so an
edited source or header rebuilds and an unchanged one loads as is. Nothing here runs at import; a missing nvcc or a failed build
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_loaded: Dict[str, ctypes.CDLL] = {}


def kernel_names() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda/bin)")
    return path


def _library_path(name: str) -> str:
    h = hashlib.sha256()
    for f in [f"{name}.cu"] + sorted(f for f in os.listdir(CSRC)
                                     if f.endswith(".cuh")):
        with open(os.path.join(CSRC, f), "rb") as src:
            h.update(src.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _build(name: str, lib: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(rc {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)


def load_all_kernel_libraries() -> Dict[str, float]:
    """Build (where needed) and load every csrc/*.cu at once, one nvcc per
    source, all started together. Returns seconds per source, each from
    the start to its library being loaded."""
    t0 = time.perf_counter()

    def one(name):
        load_kernel_library(name)
        return name, time.perf_counter() - t0

    names = kernel_names()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(pool.map(one, names))


def load_kernel_library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    if name not in _loaded:
        lib = _library_path(name)
        if not os.path.exists(lib):
            _build(name, lib)
        _loaded[name] = ctypes.CDLL(lib)
    return _loaded[name]
