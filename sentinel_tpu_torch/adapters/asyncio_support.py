"""Async entry helper (reference ``sentinel-reactor-adapter``
``SentinelReactorTransformer`` + ``CORE/AsyncEntry.java`` — wrap an async
operation in an entry whose pacing wait is awaited, not slept, with the
call context snapshotted for asynchronous continuation).

``async with async_entry(sph, "resource"):`` is the asyncio analog of
``try (Entry e = SphU.entry(...))``; on deny the BlockException raises out
of ``__aenter__`` before the body runs. The context (name + origin) is
captured on ``.context`` at entry time — the ``AsyncEntry`` context
snapshot — so completion work scheduled onto another task/thread can
``restore_context(ae.context)`` before making nested entries. (Plain
same-task flows don't need it: context storage is a ContextVar, private to
each asyncio task.)

The PyTorch port's own copy of ``sentinel_tpu/adapters/asyncio_support.py``.
"""

from __future__ import annotations

import asyncio
from typing import Optional, Sequence

from sentinel_tpu_torch.core.context import snapshot_context


class async_entry:
    def __init__(self, sentinel, resource: str, *,
                 origin: Optional[str] = None, acquire: int = 1,
                 entry_type: int = 1, prioritized: bool = False,
                 args: Sequence = (), resource_type: int = 0):
        self._sentinel = sentinel
        self._kw = dict(origin=origin, acquire=acquire, entry_type=entry_type,
                        prioritized=prioritized, args=args,
                        resource_type=resource_type)
        self._resource = resource
        self.entry = None
        self.context = None       # AsyncEntry context snapshot (set on enter)

    async def __aenter__(self):
        # AsyncEntry.java: snapshot the caller's context so completion code
        # running elsewhere can restore it
        self.context = snapshot_context()
        # the decide step itself is fast + non-blocking; only the pacing
        # wait must move onto the event loop
        self.entry = self._sentinel.entry(self._resource, sleep=False,
                                          **self._kw)
        if self.entry.wait_ms > 0:
            try:
                await asyncio.sleep(self.entry.wait_ms / 1000.0)
            except BaseException:
                # cancelled during the pacing wait: __aexit__ will never
                # run, so the entry must be exited here
                self.entry.exit()
                raise
        return self.entry

    async def __aexit__(self, exc_type, exc, tb) -> bool:
        if exc is not None:
            self.entry.trace(exc)
        self.entry.exit()
        return False
