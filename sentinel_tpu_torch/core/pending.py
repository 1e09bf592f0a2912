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


class _Cell:
    """Shared settle state for a :class:`PendingResult`, split out of the
    handle so a GC finalizer can settle a leaked handle without
    resurrecting it (the finalizer closes over the cell)."""

    __slots__ = ("fn", "done", "res")

    def __init__(self, fn):
        self.fn = fn
        self.done = False
        self.res = None

    def settle(self):
        if not self.done:
            self.res = self.fn()
            self.done = True
            self.fn = None
        return self.res


class PendingResult:
    """Memoizing one-shot handle: ``result()`` runs the deferred
    materialization exactly once and returns the cached value after."""

    __slots__ = ("_cell", "__weakref__")

    def __init__(self, fn):
        self._cell = _Cell(fn)

    def result(self):
        return self._cell.settle()


def start_host_copy(tensors: Sequence[torch.Tensor]
                    ) -> Tuple[Tuple[torch.Tensor, ...], object]:
    """Start copying ``tensors`` to the host → ``(host_tensors, event)``.

    For CUDA tensors the copies go into pinned buffers with
    ``non_blocking=True`` on the current stream, and ``event`` is a
    :class:`torch.cuda.Event` recorded after them: ``event.synchronize()``
    waits for exactly these copies (tensors on several cards get one
    event a card, in a tuple). CPU tensors are returned as they are
    with ``event`` None (nothing is in flight)."""
    if not tensors or tensors[0].device.type != "cuda":
        return tuple(tensors), None
    host = []
    cards = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
        if t.device not in cards:
            cards.append(t.device)
    if len(cards) == 1:
        event = torch.cuda.Event()
        event.record()
        return tuple(host), event
    events = []
    for d in cards:
        with torch.cuda.device(d):
            e = torch.cuda.Event()
            e.record()
        events.append(e)
    return tuple(host), tuple(events)


def wait_host_copy(host: Tuple[torch.Tensor, ...], event) -> list:
    """Wait for a :func:`start_host_copy` → numpy arrays."""
    if isinstance(event, tuple):
        for e in event:
            e.synchronize()
    elif event is not None:
        event.synchronize()
    return [h.numpy() for h in host]
