"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by plain ``nvcc`` into a shared
library with a C interface and loaded with :mod:`ctypes` (no PyTorch
headers, so a build takes seconds). The library lands in
``sentinel_tpu_torch/_build/`` (git-ignored) under a name that carries a
hash of its source and flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing is built when a module is imported: the
first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: seconds each library took to build in this process (0.0 when an
#: earlier process's build was reused)
build_seconds: Dict[str, float] = {}
#: nvcc's -Xptxas -v report per library (registers, spills)
ptxas_report: Dict[str, str] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``/``/usr/local/cuda`` or ``$PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.isfile(cand):
                return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from "
            "sentinel_tpu_torch/csrc at first use and need the CUDA toolkit "
            "(set CUDA_HOME)")
    return found


def library_path(name: str) -> Tuple[str, str]:
    """(source path, library path) for ``csrc/<name>.cu``."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR,
                             f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists →
    its path. The output is written to a temporary name and renamed, so
    concurrent builders never load a half-written file."""
    src, lib = library_path(name)
    if os.path.isfile(lib):
        build_seconds.setdefault(name, 0.0)
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds[name] = time.perf_counter() - t0
    ptxas_report[name] = proc.stderr
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first call)."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
    return lib
