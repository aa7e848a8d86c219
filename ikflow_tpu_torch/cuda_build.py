"""Builds the port's CUDA sources with nvcc into shared libraries with a
plain C interface, and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>.so`` at the checkout root,
built on first use (or when the source or a ``csrc/*.cuh`` header it may
include is newer), for ``sm_90a``. Nothing is
built when a module is imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import os
import shutil
import subprocess
import time
from typing import Dict

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 180

_LIBS: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class BuildResult:
    path: str
    log: str  # nvcc's output, including the -Xptxas -v resource report
    seconds: float


def nvcc_path() -> str:
    for cand in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in /usr/local/cuda/bin and on PATH); the CUDA kernels need it")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu``. The library is written under a temporary
    name and renamed, so a concurrent reader never sees half a file."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    out = library_path(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S, check=True)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed on {src}:\n{e.stdout}\n{e.stderr}") from e
    os.replace(tmp, out)
    return BuildResult(out, proc.stdout + proc.stderr, time.perf_counter() - t0)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if missing or
    older than the source or any header under ``csrc/``."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        sources = [os.path.join(CSRC_DIR, f"{name}.cu")] + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
        if not os.path.exists(path) or os.path.getmtime(path) < max(map(os.path.getmtime, sources)):
            build(name)
        lib = _LIBS[name] = ctypes.CDLL(path)
    return lib
