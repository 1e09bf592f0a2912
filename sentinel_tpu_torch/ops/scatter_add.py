"""Scatter-add of an event stream into a counter table: the hand-written
CUDA kernel, its plain PyTorch version, and the seam between them.

Port of ``sentinel_tpu/ops/pallas_kernels.py``. The JAX package computes
``counters[K, E] += Σ_i amounts_i · onehot(keys_i) ⊗ onehot(events_i)``
with a Pallas MXU kernel (``scatter_add_pallas``, retired behind its
``scatter_add`` seam in favour of XLA's scatter). Here the same function
is a CUDA kernel written for Hopper (``csrc/scatter_add.cu``: one thread
per stream element, an integer ``atomicAdd`` each), and the port routes
every int32 counter scatter-add of its main path through it: the window
recording (``stats/window.py``), the per-resource RT histogram and the
thread gauges (``engine/pipeline.py``), the breakers' per-rule window
counts (``rules/degrade.py``), and ``ops/sortfree.bucket_histogram``.

Semantics are those of ``scatter_add_xla``: keys and events that are
negative wrap once (``-1 → K-1``), anything still out of range is dropped
(the callers pad with ``key == K``), duplicates accumulate. ``counters``
is updated IN PLACE — the port's counterpart of the JAX package's buffer
donation — and returned. It may be a strided view (a window's bucket
slice ``counters[:, k, :]``) as long as its last dimension is contiguous.

:func:`scatter_add` is the seam: a CUDA tensor launches the kernel, a CPU
tensor takes :func:`scatter_add_reference`. There is no fallback from the
kernel to the plain version on the card.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from sentinel_tpu_torch.ops import _build

#: Kernel launches by name, counted where the wrapper launches and
#: nowhere else (``chip_smoke.py`` reads it to show the main path ran
#: through the kernel). Plain-version calls do not count.
LAUNCHES: "collections.Counter[str]" = collections.Counter()

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("scatter_add")
    for fn in (lib.sa_scatter_add_i32, lib.sa_scatter_add_f32):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(counters: torch.Tensor, keys: torch.Tensor,
           events: Optional[torch.Tensor], amounts: torch.Tensor) -> int:
    """Validate shapes and dtypes shared by both versions → lanes."""
    if counters.dim() != 2:
        raise ValueError(f"counters must be [K, E], got {tuple(counters.shape)}")
    if counters.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"counters must be int32 or float32, got {counters.dtype}")
    if keys.dim() != 1 or keys.dtype != torch.int32:
        raise TypeError("keys must be int32[N]")
    if amounts.dtype != torch.int32:
        raise TypeError(f"amounts must be int32, got {amounts.dtype}")
    n = keys.shape[0]
    if events is None:
        if tuple(amounts.shape) != (n, counters.shape[1]):
            raise ValueError("payload mode: amounts must be [N, E]")
        return counters.shape[1]
    if events.dtype != torch.int32 or tuple(events.shape) != (n,):
        raise TypeError("events must be int32[N]")
    if tuple(amounts.shape) != (n,):
        raise ValueError("amounts must be [N]")
    return 1


def scatter_add_kernel(counters: torch.Tensor, keys: torch.Tensor,
                       events: Optional[torch.Tensor],
                       amounts: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/scatter_add.cu`` on the current stream (CUDA tensors
    only) → ``counters``, updated in place. ``events=None`` is payload
    mode: ``amounts`` is ``[N, E]`` and row i adds lane-wise to
    ``counters[keys[i], :]``."""
    lanes = _check(counters, keys, events, amounts)
    tensors = [counters, keys, amounts] + ([events] if events is not None
                                            else [])
    dev = counters.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("scatter_add_kernel needs all tensors on one CUDA device")
    if counters.stride(1) != 1 or counters.stride(0) < counters.shape[1]:
        raise ValueError("counters' last dimension must be contiguous")
    if not (keys.is_contiguous() and amounts.is_contiguous()
            and (events is None or events.is_contiguous())):
        raise ValueError("keys, events and amounts must be contiguous")
    n = keys.shape[0]
    if n * lanes == 0:
        return counters
    lib = _kernel_lib()
    fn = (lib.sa_scatter_add_i32 if counters.dtype == torch.int32
          else lib.sa_scatter_add_f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(counters.data_ptr(), counters.stride(0), counters.shape[0],
                 counters.shape[1], keys.data_ptr(),
                 events.data_ptr() if events is not None else None,
                 amounts.data_ptr(), n, lanes, stream)
    LAUNCHES["scatter_add"] += 1
    if err != 0:
        raise RuntimeError(f"scatter_add kernel launch failed: CUDA error {err}")
    return counters


def scatter_add_reference(counters: torch.Tensor, keys: torch.Tensor,
                          events: Optional[torch.Tensor],
                          amounts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`scatter_add_kernel` (same
    arguments, same in-place result): wrap and drop masking, then one
    ``index_put_(..., accumulate=True)``."""
    lanes = _check(counters, keys, events, amounts)
    k_dim, e_dim = counters.shape
    if events is None:
        n = keys.shape[0]
        keys = keys[:, None].expand(n, lanes).reshape(-1)
        events = torch.arange(lanes, dtype=torch.int32,
                              device=keys.device).expand(n, lanes).reshape(-1)
        amounts = amounts.reshape(-1)
    key = torch.where(keys < 0, keys + k_dim, keys)
    ev = torch.where(events < 0, events + e_dim, events)
    ok = (key >= 0) & (key < k_dim) & (ev >= 0) & (ev < e_dim)
    counters.index_put_(
        (torch.where(ok, key, 0).long(), torch.where(ok, ev, 0).long()),
        torch.where(ok, amounts, 0).to(counters.dtype), accumulate=True)
    return counters


def scatter_add(counters: torch.Tensor, keys: torch.Tensor,
                events: Optional[torch.Tensor],
                amounts: torch.Tensor) -> torch.Tensor:
    """The dispatch seam: the kernel for a CUDA ``counters``, the plain
    version for a CPU one → ``counters`` (updated in place)."""
    if counters.device.type == "cpu":
        return scatter_add_reference(counters, keys, events, amounts)
    return scatter_add_kernel(counters, keys, events, amounts)
