"""Build and load the port's hand-written CUDA kernels (and its host C++).

Each ``csrc/<name>.cu`` is compiled by plain ``nvcc`` into a shared
library with a C interface and loaded with :mod:`ctypes` (no PyTorch
headers, so a build takes seconds). The library lands in
``sentinel_tpu_torch/_build/`` (git-ignored) under a name that carries a
hash of its source and flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing is built when a module is imported: the
first launch builds. ``SENTINEL_COMPILE_CACHE`` moves the directory
(:func:`sentinel_tpu_torch.core.compile_cache.cache_dir`; ``0``/``off``
builds into a fresh directory for the process).
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

from sentinel_tpu_torch.core.compile_cache import cache_dir

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: flags of the host C++ libraries (``native/src``)
HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: seconds each library (CUDA by source name, host C++ by stem) took to
#: build in this process (0.0 when an earlier process's build was reused)
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


def _hashed(src: str, stem: str, flags) -> str:
    """The library path for ``src`` built with ``flags``: a hash of both
    in its name, so an edited source is rebuilt."""
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(flags).encode())
    return os.path.join(cache_dir(),
                        f"lib{stem}-{digest.hexdigest()[:12]}.so")


def library_path(name: str) -> Tuple[str, str]:
    """(source path, library path) for ``csrc/<name>.cu``."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    return src, _hashed(src, name, NVCC_FLAGS)


def _compile(argv, lib: str) -> subprocess.CompletedProcess:
    """Run ``argv + ["-o", tmp]`` and rename ``tmp`` to ``lib``: concurrent
    builders (processes too) never load a half-written file."""
    out_dir = os.path.dirname(lib)
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run([*argv, "-o", tmp], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(argv[0])} failed for "
                               f"{argv[-1]}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists →
    its path."""
    src, lib = library_path(name)
    if os.path.isfile(lib):
        build_seconds.setdefault(name, 0.0)
        return lib
    t0 = time.perf_counter()
    proc = _compile([nvcc_path(), *NVCC_FLAGS, src], lib)
    build_seconds[name] = time.perf_counter() - t0
    ptxas_report[name] = proc.stderr
    return lib


def build_host(src: str, stem: str) -> str:
    """Compile the host C++ source ``src`` (C interface) with ``g++``
    into ``_build/lib<stem>-<hash>.so`` unless it is there → its path."""
    lib = _hashed(src, stem, HOST_FLAGS)
    if os.path.isfile(lib):
        build_seconds.setdefault(stem, 0.0)
        return lib
    t0 = time.perf_counter()
    _compile(["g++", *HOST_FLAGS, src], lib)
    build_seconds[stem] = time.perf_counter() - t0
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
