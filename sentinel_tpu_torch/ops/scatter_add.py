"""Scatter-add of an event stream into a counter table: the hand-written
CUDA kernel, its launch plan, its plain PyTorch version, and the seam
between them.

Port of ``sentinel_tpu/ops/pallas_kernels.py``. The JAX package computes
``counters[K, E] += Σ_i amounts_i · onehot(keys_i) ⊗ onehot(events_i)``
with a Pallas MXU kernel (``scatter_add_pallas``, retired behind its
``scatter_add`` seam in favour of XLA's scatter). Here the same function
is a CUDA kernel written for Hopper (``csrc/scatter_add.cu``: vector
loads, warp combining, and a shared-memory copy of small tables), and the
port routes every counter scatter-add of its main path through it: the
window recording and the ``rt_sum`` add (``stats/window.py``), the
per-resource RT histogram and the thread gauges (``engine/pipeline.py``),
the breakers' per-rule window counts (``rules/degrade.py``), and
``ops/sortfree.bucket_histogram``.

Semantics are those of ``scatter_add_xla``: keys and events that are
negative wrap once (``-1 → K-1``), anything still out of range is dropped
(the callers pad with ``key == K``), duplicates accumulate, and zero
amounts are skipped. ``counters`` is updated IN PLACE — the port's
counterpart of the JAX package's buffer donation — and returned. It may be
a strided view (a window's bucket slice ``counters[:, k, :]``) as long as
its last dimension is contiguous.

:func:`plan` chooses how the kernel is launched from the shapes alone;
:func:`scatter_add` is the seam: a CUDA tensor launches the kernel, a CPU
tensor takes :func:`scatter_add_reference`. There is no fallback from the
kernel to the plain version on the card.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
from typing import Dict, Optional

import torch

from sentinel_tpu_torch.ops import _build

#: Kernel launches by name, counted where the wrapper launches and
#: nowhere else (``chip_smoke.py`` reads it to show the main path ran
#: through the kernel). Plain-version calls do not count.
LAUNCHES: "collections.Counter[str]" = collections.Counter()

#: Shared memory one block may use on sm_90 (227 KB; above 48 KB only
#: after ``cudaFuncSetAttribute``), and what an SM holds in all.
SMEM_BLOCK_MAX = 232_448
SMEM_SM_MAX = 233_472
SMEM_BLOCK_RESERVED = 1_024          # the runtime's share per resident block
THREADS_PER_SM = 2_048
GLOBAL_BLOCK = 256
SHARED_BLOCK = 1_024
SHARED_BLOCKS_PER_SM = 2
#: payload widths with their own kernel instantiation (others: generic)
PAYLOAD_WIDTHS = (1, 8, 32)
PATH_GLOBAL, PATH_SHARED = "global", "shared"
_PATH_CODE = {PATH_GLOBAL: 0, PATH_SHARED: 1}


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one scatter-add is launched (the fields the C entry points take
    after the tensors)."""

    path: str            # PATH_GLOBAL or PATH_SHARED
    e_inst: int          # compile-time payload width, 0 = generic
    index_bits: int      # 32 or 64
    grid: int
    block: int
    smem_bytes: int      # dynamic shared memory (shared path only)


def units_per_thread(payload: bool, e_inst: int) -> int:
    """Stream elements (payload: rows) a thread loads before its first
    atomic — ``units()`` in ``csrc/scatter_add.cu``."""
    if not payload:
        return 4
    return {1: 4, 8: 2}.get(e_inst, 1)


def stream_fits_32(n: int, lanes: int, grid: int, block: int, payload: bool,
                   e_inst: int) -> bool:
    """Whether 32-bit index math covers the stream walk: every position it
    forms, one grid step past the end included, times the lanes
    (``stream_fits_32`` in ``csrc/scatter_add.cu``, which refuses a plan
    that claims 32 bits otherwise)."""
    step = grid * block * units_per_thread(payload, e_inst)
    return (n + step) * lanes < 2 ** 31


def plan(k: int, e: int, row_stride: int, n: int, payload: bool,
         dtype: torch.dtype, sms: int) -> Plan:
    """Launch plan for ``counters[k, e]`` (row stride ``row_stride``,
    ``dtype`` int32 or float32) += a stream of ``n`` elements — ``n`` rows
    of ``e`` amounts in payload mode — on a card with ``sms`` SMs.

    * A table whose ``k · e`` cells fit the shared memory of one block,
      and whose private copies (one per block) hold no more cells than the
      stream has amounts, takes the shared path: up to
      ``SHARED_BLOCKS_PER_SM`` persistent blocks per SM, each zero-filling
      and flushing its own copy. With a shorter stream the copies cost
      more than the atomics they save.
    * Any other table takes the global path: ``GLOBAL_BLOCK`` threads,
      ``units_per_thread`` elements each, at most one full wave of blocks,
      grid-stride beyond it.
    * Payload widths 1, 8 and 32 get their own instantiation.
    * Index math is 32-bit when ``k · row_stride < 2^31`` and every stream
      position fits too (:func:`stream_fits_32`); the shared path always
      uses it, and is not planned where the stream does not fit."""
    if min(k, e, row_stride, sms) <= 0 or n < 0:
        raise ValueError("plan needs positive k, e, row_stride and sms")
    shared = shared_plan(k, e, n, payload, dtype, sms)
    if shared is not None and k * e * shared.grid <= n * (e if payload
                                                          else 1):
        return shared
    return global_plan(k, e, row_stride, n, payload, sms)


def shared_plan(k: int, e: int, n: int, payload: bool, dtype: torch.dtype,
                sms: int) -> Optional[Plan]:
    """The shared path's plan, or None where the table (or the stream)
    does not fit it."""
    lanes = e if payload else 1
    e_inst = e if payload and e in PAYLOAD_WIDTHS else 0
    smem = k * e * dtype.itemsize
    if smem > SMEM_BLOCK_MAX:
        return None
    per_sm = min(SHARED_BLOCKS_PER_SM,
                 SMEM_SM_MAX // (smem + SMEM_BLOCK_RESERVED))
    tiles = -(-n // (SHARED_BLOCK * units_per_thread(payload, e_inst)))
    grid = max(1, min(per_sm * sms, tiles))
    if not stream_fits_32(n, lanes, grid, SHARED_BLOCK, payload, e_inst):
        return None
    return Plan(PATH_SHARED, e_inst, 32, grid, SHARED_BLOCK, smem)


def global_plan(k: int, e: int, row_stride: int, n: int, payload: bool,
                sms: int) -> Plan:
    """The global path's plan (what :func:`plan` gives a table that does
    not fit in shared memory)."""
    lanes = e if payload else 1
    e_inst = e if payload and e in PAYLOAD_WIDTHS else 0
    tiles = -(-n // (GLOBAL_BLOCK * units_per_thread(payload, e_inst)))
    wave = sms * (THREADS_PER_SM // GLOBAL_BLOCK)
    grid = max(1, min(wave, tiles))
    narrow = (k * row_stride < 2 ** 31
              and stream_fits_32(n, lanes, grid, GLOBAL_BLOCK, payload, e_inst))
    return Plan(PATH_GLOBAL, e_inst, 32 if narrow else 64, grid,
                GLOBAL_BLOCK, 0)


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_longlong, ctypes.c_int]
             + [ctypes.c_int] * 7 + [ctypes.c_void_p])
_SMS: Dict[int, int] = {}


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("scatter_add")
    for fn in (lib.sa_scatter_add_i32, lib.sa_scatter_add_f32):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    lib.sa_sm_count.argtypes = [ctypes.c_int]
    lib.sa_sm_count.restype = ctypes.c_int
    return lib


def sm_count(device: torch.device) -> int:
    """SMs of a CUDA ``device`` (``cudaDevAttrMultiProcessorCount``)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        sms = _kernel_lib().sa_sm_count(idx)
        if sms <= 0:
            raise RuntimeError(f"cannot read the SM count of cuda:{idx}")
        _SMS[idx] = sms
    return _SMS[idx]


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


def plan_for(counters: torch.Tensor, keys: torch.Tensor,
             events: Optional[torch.Tensor]) -> Plan:
    """:func:`plan` for these tensors (CUDA ``counters``)."""
    return plan(counters.shape[0], counters.shape[1], counters.stride(0),
                keys.shape[0], events is None, counters.dtype,
                sm_count(counters.device))


def scatter_add_kernel(counters: torch.Tensor, keys: torch.Tensor,
                       events: Optional[torch.Tensor],
                       amounts: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/scatter_add.cu`` on the current stream (CUDA tensors
    only), as :func:`plan_for` plans it → ``counters``, updated in place.
    ``events=None`` is payload mode: ``amounts`` is ``[N, E]`` and row i
    adds lane-wise to ``counters[keys[i], :]``."""
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
    p = plan_for(counters, keys, events)
    vec = all(t.data_ptr() % 16 == 0 for t in tensors[1:])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(counters.data_ptr(), counters.stride(0), counters.shape[0],
                 counters.shape[1], keys.data_ptr(),
                 events.data_ptr() if events is not None else None,
                 amounts.data_ptr(), n, lanes, _PATH_CODE[p.path], p.e_inst,
                 p.index_bits, p.grid, p.block, p.smem_bytes, int(vec),
                 stream)
    LAUNCHES["scatter_add"] += 1
    if err != 0:
        raise RuntimeError(f"scatter_add kernel launch failed: CUDA error {err}")
    return counters


def scatter_add_reference(counters: torch.Tensor, keys: torch.Tensor,
                          events: Optional[torch.Tensor],
                          amounts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`scatter_add_kernel` (same
    arguments, same in-place result): wrap, drop out-of-range lanes and
    zero amounts, then one ``index_put_(..., accumulate=True)``."""
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
    ok = ((key >= 0) & (key < k_dim) & (ev >= 0) & (ev < e_dim)
          & (amounts != 0))
    counters.index_put_((key[ok].long(), ev[ok].long()),
                        amounts[ok].to(counters.dtype), accumulate=True)
    return counters


def scatter_add(counters: torch.Tensor, keys: torch.Tensor,
                events: Optional[torch.Tensor],
                amounts: torch.Tensor) -> torch.Tensor:
    """The dispatch seam: the kernel for a CUDA ``counters``, the plain
    version for a CPU one → ``counters`` (updated in place)."""
    if counters.device.type == "cpu":
        return scatter_add_reference(counters, keys, events, amounts)
    return scatter_add_kernel(counters, keys, events, amounts)
