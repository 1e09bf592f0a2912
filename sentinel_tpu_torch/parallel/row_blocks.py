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

**Rank-local form.** Over a ``"rows"`` mesh that spans processes, each
process holds only its own blocks: ``blocks`` are this rank's, ``first``
is the global index of its first block, ``total`` the global block count
(``rows`` stays the whole table's), and ``comm`` the mesh whose
collectives join the ranks (:class:`~sentinel_tpu_torch.multihost.mesh.
GlobalMesh`). Then

* a per-lane read gathers the lanes this rank owns, puts zero bits in
  every other lane, and sums the ranks' results with one ``all_reduce``
  over the integer bit view — exact, since one rank holds each lane (a
  float sum would turn an owner's ``-0.0`` into ``+0.0``); an int row is
  read the same way (a fresh tensor, not a view: write one row with
  :meth:`RowBlocks.add_row_`), and :func:`read_rows` packs several
  reads of one stage into one ``all_reduce``;
* a write is unchanged: each local block takes the lanes it owns, every
  other lane drops, with no communication;
* a whole-table pass touches the local blocks only; :meth:`RowBlocks.sum`
  joins the block sums with one ``all_reduce``;
* a host read of the whole table (:meth:`RowBlocks.to_numpy`,
  :func:`start_host_read`) raises :class:`RemoteRowsError`: other ranks
  hold the rest of it.

Every rank must make the same reads in the same order (the SPMD
contract of the multi-process engine), since each is a collective.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.core.pending import start_host_copy, wait_host_copy


class RemoteRowsError(RuntimeError):
    """A host read of row-split state whose rows other processes hold
    (the rank-local form): where the JAX runtime raises ``Fetching value
    for jax.Array that spans non-addressable devices``. The readers that
    raise it issue no collective: one rank's thread calls them alone."""


def remote_rows_message(what: str, processes: int) -> str:
    return (f"{what} reads row-split state that other processes hold: a "
            f"\"rows\" mesh over {processes} processes serves the SPMD "
            f"step path (rule loads, entries, batches, telemetry ticks), "
            f"and a host reader of whole tables raises as the JAX "
            f"runtime's does (ROADMAP A11; C19)")


class RowBlocks:
    """Row blocks of one field; ``home`` is the device a per-lane read
    lands on. Every block has ``per`` rows and the same trailing shape.
    ``first``/``total``/``comm`` give the rank-local form (module
    docstring); by default the blocks are the whole table."""

    __slots__ = ("blocks", "per", "home", "first", "total", "comm")

    def __init__(self, blocks: Sequence[torch.Tensor], home=None, *,
                 first: int = 0, total: Optional[int] = None, comm=None):
        self.blocks = tuple(blocks)
        if not self.blocks:
            raise ValueError("row blocks need at least one block")
        self.per = int(self.blocks[0].shape[0])
        self.home = torch.device(home if home is not None
                                 else self.blocks[0].device)
        self.first = int(first)
        self.total = len(self.blocks) if total is None else int(total)
        self.comm = comm

    @classmethod
    def split(cls, t: torch.Tensor, devices: Sequence[torch.device],
              home=None, *, first: int = 0, total: Optional[int] = None,
              comm=None) -> "RowBlocks":
        """Copy the row ranges of ``t`` into blocks on ``devices``, each
        in storage of its own: ``t`` splits into ``total`` blocks
        (``len(devices)`` by default) and the blocks kept are
        ``first, first + 1, ...``, one a device."""
        n = len(devices) if total is None else int(total)
        if t.shape[0] % n:
            raise ValueError(f"{t.shape[0]} rows do not divide over {n} "
                             f"blocks")
        per = t.shape[0] // n
        return cls([t[(first + i) * per:(first + i + 1) * per].to(
                        d, copy=True) for i, d in enumerate(devices)],
                   home if home is not None else devices[0],
                   first=first, total=n, comm=comm)

    def like(self, blocks: Sequence[torch.Tensor]) -> "RowBlocks":
        """New row blocks of this layout (home, first block, block count
        and mesh) holding ``blocks``."""
        return RowBlocks(blocks, self.home, first=self.first,
                         total=self.total, comm=self.comm)

    # -- tensor-like metadata ------------------------------------------
    @property
    def n(self) -> int:
        """Blocks held here (all of them but in the rank-local form)."""
        return len(self.blocks)

    @property
    def rows(self) -> int:
        return self.per * self.total

    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.rows,) + tuple(self.blocks[0].shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        return self.home

    @property
    def rank_local(self) -> bool:
        """True when other processes hold some of the blocks."""
        return self.comm is not None

    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(b.device for b in self.blocks)

    def __repr__(self) -> str:
        where = (f", blocks {self.first}..{self.first + self.n - 1} of "
                 f"{self.total}" if self.rank_local else "")
        return (f"RowBlocks({self.n} x {tuple(self.blocks[0].shape)} "
                f"{self.dtype}, devices={[str(d) for d in self.devices()]}"
                f"{where})")

    # -- ownership -----------------------------------------------------
    def local_rows(self, rows: torch.Tensor, i: int) -> torch.Tensor:
        """Block ``i``'s write index for ``rows`` (``i`` counts the blocks
        held here; on block ``i``'s device, ``rows``' dtype): a row wraps
        once when negative (the whole table's scatter semantics), then an
        owned row becomes ``row − (first + i)·per`` and any other lane —
        another block's row, a pad past the table, a row still negative —
        becomes ``per``, which the block's scatter drops."""
        w = torch.where(rows < 0, rows + self.rows, rows)
        lo = (self.first + i) * self.per
        own = (w >= lo) & (w < lo + self.per)
        return torch.where(own, w - lo, self.per).to(
            rows.dtype).to(self.blocks[i].device)

    def owned(self, rows: torch.Tensor):
        """``(i, block, local rows)`` for every block held here (see
        :meth:`local_rows`)."""
        for i, b in enumerate(self.blocks):
            yield i, b, self.local_rows(rows, i)

    def block_of(self, row: int) -> Tuple[Optional[int], int]:
        """``(i, local row)`` of global ``row`` (wrapped into the table):
        ``i`` counts the blocks held here, None when another rank holds
        the row."""
        g, loc = divmod(row % self.rows, self.per)
        i = g - self.first
        return (i if 0 <= i < self.n else None), loc

    # -- reads ---------------------------------------------------------
    def __getitem__(self, key):
        """``table[rows, ...]`` gathered from each lane's owner onto the
        home device (``rows`` in ``[-R, R)``; callers clamp as they do
        for a whole tensor; a lane outside reads row 0), or
        ``table[row, ...]`` for one int row — a VIEW of the owner's block,
        so an in-place update through it lands in the state (in the
        rank-local form a fresh tensor: see :meth:`add_row_`). A
        whole-table read has no form here: it goes block by block."""
        if not isinstance(key, tuple):
            key = (key,)
        if isinstance(key[0], int) and not self.rank_local:
            i, loc = divmod(key[0] % self.rows, self.per)
            return self.blocks[i][(loc,) + key[1:]]
        return read_rows([(self, key)])[0]

    def _gather(self, key: tuple):
        """This process's part of ``self[key]``: the lanes its blocks own,
        zero elsewhere (every lane, unless rank-local) → ``(tensor,
        squeeze)``; ``squeeze`` marks an int row read as one lane."""
        first, rest = key[0], key[1:]
        squeeze = isinstance(first, int)
        if squeeze:
            first = torch.full((1,), first, dtype=torch.long,
                               device=self.home)
        elif not isinstance(first, torch.Tensor):
            raise TypeError(
                "row blocks read by row index (a tensor or an int); a "
                "whole-table read goes block by block")
        idx = first.long()
        idx = torch.where(idx < 0, idx + self.rows, idx)
        if self.n == 1 and not self.rank_local:
            loc = idx - torch.div(idx, self.per,
                                  rounding_mode="floor") * self.per
            return self.blocks[0][(loc.to(self.blocks[0].device),) + rest
                                  ].to(self.home), squeeze
        inside = (idx >= 0) & (idx < self.rows)
        idx = torch.where(inside, idx, 0)
        owner = torch.div(idx, self.per, rounding_mode="floor")
        loc = idx - owner * self.per
        out = None
        for i, b in enumerate(self.blocks):
            mine = owner == self.first + i
            li = torch.where(mine, loc, 0).to(b.device)
            v = b[(li,) + rest].to(self.home)
            m = mine.view(tuple(mine.shape) + (1,) * (v.dim() - mine.dim()))
            out = torch.where(m, v, torch.zeros_like(v) if out is None
                              else out)
        return out, squeeze

    def sum(self) -> torch.Tensor:
        """Sum of every element → a 0-d tensor on the home device (the
        block sums added in block order; in the rank-local form the
        ranks' block sums meet in one ``all_reduce`` first)."""
        sums = torch.stack([b.sum().to(self.home) for b in self.blocks])
        if self.rank_local:
            full = torch.zeros((self.total,), dtype=sums.dtype,
                               device=self.home)
            full[self.first:self.first + self.n] = sums
            sums = self.comm.all_reduce_bits(full)
        return sums.sum()

    # -- writes --------------------------------------------------------
    def add_row_(self, row: int, value: torch.Tensor) -> "RowBlocks":
        """``table[row] += value`` in the owner's block (no other rank
        writes; nothing is communicated)."""
        i, loc = self.block_of(row)
        if i is not None:
            b = self.blocks[i]
            b[loc].add_(value.to(b.device))
        return self

    # -- block-by-block passes -----------------------------------------
    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]
            ) -> "RowBlocks":
        """``fn`` on each block → new blocks (``fn`` keeps the row axis)."""
        return self.like([fn(b) for b in self.blocks])

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

    def refuse_host_read(self) -> None:
        """Raise :class:`RemoteRowsError` in the rank-local form."""
        if self.rank_local:
            raise RemoteRowsError(remote_rows_message(
                f"a host read of {self!r}", self.comm.process_count))

    def to_numpy(self) -> np.ndarray:
        """The whole table on the host, block by block."""
        self.refuse_host_read()
        return np.concatenate([b.detach().cpu().numpy()
                               for b in self.blocks])


def _words(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as a flat int32 tensor (a bool as one word)."""
    if t.dtype == torch.bool:
        return t.reshape(-1).to(torch.int32)
    return t.contiguous().view(-1).view(torch.int32)


def _unwords(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bool:
        return (w != 0).view(like.shape)
    return w.view(like.dtype).view(like.shape)


def read_rows(reads: Sequence) -> list:
    """Several per-lane reads, ``[table[key] for table, key in reads]``
    (``key`` as ``RowBlocks.__getitem__`` takes it; plain tensors index
    as tensors do). In the rank-local form the reads meet in ONE
    ``all_reduce``: each rank's gathered parts (zero bits in the lanes it
    does not own) are packed as int32 words into one buffer, summed over
    the ranks — exact, one owner a lane — and unpacked; without ranks it
    issues no collective. The tables must share one mesh."""
    parts = []
    for table, key in reads:
        if not isinstance(table, RowBlocks):
            parts.append((table[key], False))
            continue
        parts.append(table._gather(key if isinstance(key, tuple)
                                   else (key,)))
    comm = next((t.comm for t, _k in reads
                 if isinstance(t, RowBlocks) and t.rank_local), None)
    if comm is not None:
        local = [t for (t, _k), (v, _s) in zip(reads, parts)
                 if isinstance(t, RowBlocks)]
        if any(t.comm is not comm for t in local):
            raise ValueError("a packed read spans two meshes")
        rows = [i for i, (t, _k) in enumerate(reads)
                if isinstance(t, RowBlocks)]
        words = [_words(parts[i][0]) for i in rows]
        summed = comm.all_reduce_bits(torch.cat(words)).split(
            [w.numel() for w in words])
        for i, w in zip(rows, summed):
            parts[i] = (_unwords(w, parts[i][0]), parts[i][1])
    return [v[0] if squeeze else v for v, squeeze in parts]


def start_host_read(items: Sequence):
    """Start copying tensors and row-block tables to the host (a
    table's blocks one by one) → a handle for :func:`wait_host_read`."""
    parts: List[torch.Tensor] = []
    layout: List[int] = []
    for x in items:
        if isinstance(x, RowBlocks):
            x.refuse_host_read()
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
