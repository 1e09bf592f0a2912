"""Lazy result handles for dispatched-but-unread device work.

The PyTorch counterpart of ``sentinel_tpu/core/pending.py``: the device
step is enqueued on the current CUDA stream (engine state already
advanced in order) and the device→host copy of its outputs is started
right behind it, into pinned host memory with ``non_blocking=True``; a
CUDA event recorded after the copies marks them done.
:meth:`PendingResult.result` waits on that event — never on the whole
device — and materializes. Holding a handle while dispatching the next
batch overlaps the readback with the next batch's host prep.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


class PendingResult:
    """Memoizing one-shot handle: ``result()`` runs the deferred
    materialization exactly once and returns the cached value after."""

    __slots__ = ("_fn", "_res")

    def __init__(self, fn):
        self._fn = fn
        self._res = None

    def result(self):
        if self._fn is not None:
            self._res = self._fn()
            self._fn = None
        return self._res


def start_host_copy(tensors: Sequence[torch.Tensor]
                    ) -> Tuple[Tuple[torch.Tensor, ...], object]:
    """Start copying ``tensors`` to the host → ``(host_tensors, event)``.

    For CUDA tensors the copies go into pinned buffers with
    ``non_blocking=True`` on the current stream, and ``event`` is a
    :class:`torch.cuda.Event` recorded after them: ``event.synchronize()``
    waits for exactly these copies. CPU tensors are returned as they are
    with ``event`` None (nothing is in flight)."""
    if not tensors or tensors[0].device.type != "cuda":
        return tuple(tensors), None
    host = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    event = torch.cuda.Event()
    event.record()
    return tuple(host), event


def wait_host_copy(host: Tuple[torch.Tensor, ...], event) -> list:
    """Wait for a :func:`start_host_copy` → numpy arrays."""
    if event is not None:
        event.synchronize()
    return [h.numpy() for h in host]
