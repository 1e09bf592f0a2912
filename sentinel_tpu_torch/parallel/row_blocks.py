"""Row blocks: one row-split state field held as N contiguous blocks.

The row-sharded engine (:mod:`sentinel_tpu_torch.parallel.local_shard`)
keeps every row-split field of ``SentinelState`` — the windows, the
thread gauges, the occupy ring and the RT histogram — as a
:class:`RowBlocks`: block ``i`` is a tensor of ``per`` rows on its own
device, holding exactly the global rows ``[i·per, (i+1)·per)``. The JAX
package gets the same layout from GSPMD annotations; PyTorch has no
partitioner, so every reader and writer of such a field works by owner:

* a **per-lane read** (``table[rows, ...]``, :meth:`RowBlocks.__getitem__`)
  gathers each lane from its owner's block and lands on the home device
  (``devices[0]``, where the step's replicated work runs);
* a **write** goes to each block with :meth:`RowBlocks.local_rows`: an
  owned lane's row becomes ``row − i·per`` and every other lane the index
  ``per``, one past the block, which every scatter of the port drops. A
  non-owned lane never gets a negative index, because the scatter kernel
  wraps a negative index once and would land it inside the block;
* a **whole-table pass** runs block by block (:meth:`RowBlocks.map`).

No step concatenates the blocks into one whole-row tensor; a host read of
the whole table copies the blocks to the host one by one and joins them
there (:func:`start_host_read`).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.core.pending import start_host_copy, wait_host_copy


class RowBlocks:
    """N row blocks of one field; ``home`` is the device a per-lane read
    lands on. Every block has ``per`` rows and the same trailing shape."""

    __slots__ = ("blocks", "per", "home")

    def __init__(self, blocks: Sequence[torch.Tensor], home=None):
        self.blocks = tuple(blocks)
        if not self.blocks:
            raise ValueError("row blocks need at least one block")
        self.per = int(self.blocks[0].shape[0])
        self.home = torch.device(home if home is not None
                                 else self.blocks[0].device)

    @classmethod
    def split(cls, t: torch.Tensor, devices: Sequence[torch.device],
              home=None) -> "RowBlocks":
        """Copy the row ranges of ``t`` into ``len(devices)`` blocks, each
        in storage of its own on its device."""
        n = len(devices)
        if t.shape[0] % n:
            raise ValueError(f"{t.shape[0]} rows do not divide over {n} "
                             f"blocks")
        per = t.shape[0] // n
        return cls([t[i * per:(i + 1) * per].to(d, copy=True)
                    for i, d in enumerate(devices)],
                   home if home is not None else devices[0])

    # -- tensor-like metadata ------------------------------------------
    @property
    def n(self) -> int:
        return len(self.blocks)

    @property
    def rows(self) -> int:
        return self.per * len(self.blocks)

    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.rows,) + tuple(self.blocks[0].shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        return self.home

    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(b.device for b in self.blocks)

    def __repr__(self) -> str:
        return (f"RowBlocks({self.n} x {tuple(self.blocks[0].shape)} "
                f"{self.dtype}, devices={[str(d) for d in self.devices()]})")

    # -- ownership -----------------------------------------------------
    def local_rows(self, rows: torch.Tensor, i: int) -> torch.Tensor:
        """Block ``i``'s write index for ``rows`` (on block ``i``'s
        device, ``rows``' dtype): a row wraps once when negative (the
        whole table's scatter semantics), then an owned row becomes
        ``row − i·per`` and any other lane — another block's row, a pad
        past the table, a row still negative — becomes ``per``, which the
        block's scatter drops."""
        w = torch.where(rows < 0, rows + self.rows, rows)
        lo = i * self.per
        own = (w >= lo) & (w < lo + self.per)
        return torch.where(own, w - lo, self.per).to(
            rows.dtype).to(self.blocks[i].device)

    def owned(self, rows: torch.Tensor):
        """``(i, block, local rows)`` for every block (see
        :meth:`local_rows`)."""
        for i, b in enumerate(self.blocks):
            yield i, b, self.local_rows(rows, i)

    # -- reads ---------------------------------------------------------
    def __getitem__(self, key):
        """``table[rows, ...]`` gathered from each lane's owner onto the
        home device (``rows`` in ``[-R, R)``; callers clamp as they do
        for a whole tensor), or ``table[row, ...]`` for one int row — a
        VIEW of the owner's block, so an in-place update through it lands
        in the state. A whole-table read has no form here: it goes block
        by block."""
        if not isinstance(key, tuple):
            key = (key,)
        first, rest = key[0], key[1:]
        if isinstance(first, int):
            i, loc = divmod(first % self.rows, self.per)
            return self.blocks[i][(loc,) + rest]
        if not isinstance(first, torch.Tensor):
            raise TypeError(
                "row blocks read by row index (a tensor or an int); a "
                "whole-table read goes block by block")
        idx = first.long()
        idx = torch.where(idx < 0, idx + self.rows, idx)
        owner = torch.div(idx, self.per, rounding_mode="floor")
        loc = idx - owner * self.per
        if self.n == 1:
            return self.blocks[0][(loc.to(self.blocks[0].device),) + rest
                                  ].to(self.home)
        out = None
        for i, b in enumerate(self.blocks):
            mine = owner == i
            li = torch.where(mine, loc, 0).to(b.device)
            v = b[(li,) + rest].to(self.home)
            if out is None:
                out = v
            else:
                m = mine.view(tuple(mine.shape)
                              + (1,) * (v.dim() - mine.dim()))
                out = torch.where(m, v, out)
        return out

    def sum(self) -> torch.Tensor:
        """Sum of every element → a 0-d tensor on the home device (the
        block sums added in block order)."""
        return torch.stack([b.sum().to(self.home)
                            for b in self.blocks]).sum()

    # -- block-by-block passes -----------------------------------------
    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]
            ) -> "RowBlocks":
        """``fn`` on each block → new blocks (``fn`` keeps the row axis)."""
        return RowBlocks([fn(b) for b in self.blocks], self.home)

    def clone(self) -> "RowBlocks":
        return self.map(torch.clone)

    def zero_(self) -> "RowBlocks":
        for b in self.blocks:
            b.zero_()
        return self

    def clamp_(self, min=None, max=None) -> "RowBlocks":
        for b in self.blocks:
            b.clamp_(min=min, max=max)
        return self

    def to_numpy(self) -> np.ndarray:
        """The whole table on the host, block by block."""
        return np.concatenate([b.detach().cpu().numpy()
                               for b in self.blocks])


def start_host_read(items: Sequence):
    """Start copying tensors and row-block tables to the host (a
    table's blocks one by one) → a handle for :func:`wait_host_read`."""
    parts: List[torch.Tensor] = []
    layout: List[int] = []
    for x in items:
        if isinstance(x, RowBlocks):
            layout.append(x.n)
            parts.extend(x.blocks)
        else:
            layout.append(0)
            parts.append(x)
    host, event = start_host_copy(parts)
    return host, event, layout


def wait_host_read(handle) -> list:
    """Wait for a :func:`start_host_read` → numpy arrays, each table's
    blocks joined on the host."""
    host, event, layout = handle
    arrs = wait_host_copy(host, event)
    out, i = [], 0
    for n in layout:
        if n:
            out.append(np.concatenate(arrs[i:i + n]))
            i += n
        else:
            out.append(arrs[i])
            i += 1
    return out
