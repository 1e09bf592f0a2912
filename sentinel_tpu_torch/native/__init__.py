"""Native (C++) host-path components of the PyTorch port.

The string-interning tables that turn resource, origin and context names
and hot-param keys into dense rows of the device tables are the one host
path worth native code: ``src/registry.cpp`` (the JAX package's
``sentinel_tpu/native/src/registry.cpp``, copied; host C++ with a C
interface, loaded with :mod:`ctypes`, so every call runs without the
GIL). It is compiled with ``g++`` at first use into the git-ignored
``sentinel_tpu_torch/_build/``, or ``SENTINEL_COMPILE_CACHE``
(:func:`ops._build.build_host`: a hashed
name, a temporary file renamed into place). Everything here has a
pure-Python twin with the same row assignment; ``SENTINEL_TPU_NATIVE=0``
selects it, and a failed build falls back to it after one line in the
record log.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src",
                    "registry.cpp")

_lib_handle = None
_lib_lock = threading.Lock()


def _build() -> Optional[str]:
    """The built library's path, or None (logged once) when ``g++`` is
    missing or fails."""
    from sentinel_tpu_torch.ops import _build as build_mod
    try:
        return build_mod.build_host(_SRC, "sentinel_native")
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        _log_failure(exc)
        return None


def _log_failure(exc) -> None:
    from sentinel_tpu_torch.core.logs import record_log
    first = (str(exc).splitlines() or [type(exc).__name__])[0]
    record_log().warning(
        "[native] the C++ interning table is unavailable (%s); the "
        "pure-Python registries serve instead", first)


def load_native():
    """The ctypes library, or None when disabled/unbuildable."""
    global _lib_handle
    if os.environ.get("SENTINEL_TPU_NATIVE", "1") == "0":
        return None
    with _lib_lock:
        if _lib_handle is not None:
            return None if _lib_handle is False else _lib_handle
        path = _build()
        if path is None:
            _lib_handle = False        # cache the failure: no retry storms
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as exc:
            _log_failure(exc)
            _lib_handle = False
            return None
        lib.str_new.restype = ctypes.c_void_p
        lib.str_new.argtypes = [ctypes.c_int32]
        lib.str_free.argtypes = [ctypes.c_void_p]
        for fn in (lib.str_get_or_create, lib.str_lookup, lib.str_pin):
            fn.restype = ctypes.c_int32
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32]
        lib.str_unpin.restype = None
        lib.str_unpin.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int32]
        lib.str_name_of.restype = ctypes.c_int32
        lib.str_name_of.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                    ctypes.c_char_p, ctypes.c_int32]
        lib.str_len.restype = ctypes.c_int32
        lib.str_len.argtypes = [ctypes.c_void_p]
        lib.str_drain.restype = ctypes.c_int32
        lib.str_drain.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int32),
                                  ctypes.c_int32]
        lib.str_get_or_create_batch.restype = ctypes.c_int32
        lib.str_get_or_create_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32)]
        lib.str_live_ids.restype = ctypes.c_int32
        lib.str_live_ids.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int32),
                                     ctypes.c_int32]
        lib.str_snapshot.restype = ctypes.c_int32
        lib.str_snapshot.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32]
        lib.str_get_or_create_batch2.restype = ctypes.c_int32
        lib.str_get_or_create_batch2.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8)]
        lib.i64_get_or_create_batch.restype = ctypes.c_int32
        lib.i64_get_or_create_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8)]
        for fn in (lib.str_pin_rows, lib.str_unpin_rows):
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p,
                           ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.str_pin_total.restype = ctypes.c_int64
        lib.str_pin_total.argtypes = [ctypes.c_void_p]
        _lib_handle = lib
        return lib


class NativeRegistry:
    """Drop-in for :class:`sentinel_tpu_torch.core.registry.Registry` backed by the
    C++ table. Same semantics: dense ids, LRU eviction of unpinned rows on
    overflow, pending-evicted drain, pinning."""

    def __init__(self, capacity: int, reserved=()):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native library unavailable")
        reserved = tuple(reserved)
        if capacity < 1 + len(reserved):
            raise ValueError("capacity too small")
        self._lib = lib
        self._capacity = capacity
        self._h = ctypes.c_void_p(lib.str_new(capacity))
        if not self._h:
            raise MemoryError("str_new failed")
        for name in reserved:
            self.pin(name)

    # -- lifecycle ---------------------------------------------------------
    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.str_free(h)

    @property
    def capacity(self) -> int:
        return self._capacity

    # -- core --------------------------------------------------------------
    def get_or_create(self, name: str) -> int:
        b = name.encode("utf-8")
        rid = self._lib.str_get_or_create(self._h, b, len(b))
        if rid == -2:
            raise RuntimeError("registry full and all rows pinned")
        return rid

    def get_or_create_batch(self, names) -> np.ndarray:
        """Vector path: one lock + one FFI call for the whole batch.
        Batches repeat few distinct names (per-resource serving loops often
        send ONE name 4k times), so dedup first when it pays — dict hashing
        a name is ~30× cheaper than encoding + marshalling it."""
        n = len(names)
        if n > 64:
            # all-identical batch (per-resource serving loops): ONE intern,
            # no dict pass — names.count is a C-speed scan
            first = names[0]
            if isinstance(names, list) and names.count(first) == n:
                row = self.get_or_create(first)
                return np.full(n, row, np.int32)
            pos: dict = {}
            for s in names:
                if s not in pos:
                    pos[s] = len(pos)
            if len(pos) * 2 < n:
                rows_u = self._intern_encoded(list(pos))
                return rows_u[np.fromiter((pos[s] for s in names),
                                          np.int32, count=n)]
        return self._intern_encoded(names)

    def _intern_encoded(self, names) -> np.ndarray:
        enc = [n.encode("utf-8") for n in names]
        offsets = np.zeros(len(enc) + 1, np.int32)
        np.cumsum([len(b) for b in enc], out=offsets[1:])
        data = b"".join(enc)
        out = np.empty(len(enc), np.int32)
        self._lib.str_get_or_create_batch(
            self._h, data,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(enc),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if (out == -2).any():
            raise RuntimeError("registry full and all rows pinned")
        return out

    def lookup(self, name: str) -> Optional[int]:
        b = name.encode("utf-8")
        rid = self._lib.str_lookup(self._h, b, len(b))
        return None if rid < 0 else rid

    def name_of(self, rid: int) -> Optional[str]:
        size = 4096
        while True:
            buf = ctypes.create_string_buffer(size)
            n = self._lib.str_name_of(self._h, rid, buf, size)
            if n < 0:
                return None
            if n <= size:              # full name fit (no mid-codepoint cut)
                return buf.raw[:n].decode("utf-8")
            size = n

    def pin(self, name: str) -> int:
        b = name.encode("utf-8")
        rid = self._lib.str_pin(self._h, b, len(b))
        if rid == -2:
            raise RuntimeError("registry full and all rows pinned")
        return rid

    def unpin(self, name: str) -> None:
        b = name.encode("utf-8")
        self._lib.str_unpin(self._h, b, len(b))

    def drain_evicted(self) -> List[int]:
        # the queue can exceed capacity (a row evicted repeatedly between
        # drains) — keep pulling until the C side reports it empty
        out = np.empty(max(self._capacity, 64), np.int32)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        result: List[int] = []
        while True:
            n = self._lib.str_drain(self._h, ptr, len(out))
            result.extend(int(x) for x in out[:n])
            if n < len(out):
                return result

    def items(self) -> List[Tuple[str, int]]:
        return [(name.decode("utf-8"), rid)
                for name, rid in snapshot(self._lib, self._h,
                                          self._capacity)]

    def __len__(self) -> int:
        return int(self._lib.str_len(self._h))


def snapshot(lib, handle, capacity: int) -> List[Tuple[bytes, int]]:
    """``(key bytes, id)`` of every live entry of a C++ table, least
    recently used first, read under ONE lock acquisition of the table:
    ids and keys are a consistent pair even while another thread is
    evicting or interning."""
    ids = np.empty(capacity, np.int32)
    lens = np.empty(capacity, np.int32)
    buflen = 1 << 16
    while True:
        buf = ctypes.create_string_buffer(buflen)
        n = lib.str_snapshot(
            handle, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            capacity, buf, buflen)
        if n >= 0:
            break
        buflen = -n
    raw = buf.raw
    out = []
    off = 0
    for ln, rid in zip(lens[:n].tolist(), ids[:n].tolist()):
        out.append((raw[off:off + ln], rid))
        off += ln
    return out


def native_available() -> bool:
    return load_native() is not None
