"""DONATE001 torch fixture — the staging-slot rewrite while a
non-blocking copy or a dispatch may still read the slot, with the
settle / release / blocking-copy clean twins. Torch donates nothing, so
a call that the reference would see as donating leaves its operand free.

Parsed by tests, never imported (``pad_into``, the ring and the step are
stand-ins).
"""

import torch


def tp_nonblocking_copy(ring, batch, device):
    slot = ring.acquire()
    pad_into(slot["rows"].numpy(), batch, 0)
    rows = slot["rows"].to(device, non_blocking=True)
    slot["rows"][:8] = 0               # BAD: the copy may still read it
    return rows


def tp_dispatch_then_fill(ring, batch, extra):
    slot = ring.acquire()
    view = pad_into(slot[:64], batch)
    handle = decide_step(view, extra)
    slot.fill_(0)                      # BAD: in-place rewrite in flight
    return handle


def suppressed_rewrite(ring, device):
    slot = ring.acquire()
    dev = slot.to(device, non_blocking=True)
    slot[:8] = 0  # graftlint: disable=DONATE001 -- fixture: reviewed single-slot ring drained before reuse
    return dev


def event_settle_is_clean(ring, device):
    slot = ring.acquire()
    dev = slot.to(device, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    slot[:8] = 0                       # OK: the copy has landed
    return dev


def device_sync_is_clean(ring):
    slot = ring.acquire()
    dev = slot.cuda(non_blocking=True)
    torch.cuda.synchronize()
    slot.zero_()                       # OK: the card consumed the slot
    return dev


def ring_release_is_clean(ring, device):
    slot = ring.acquire()
    dev = slot.to(device, non_blocking=True)
    ring.release(slot)                 # settlement path freed the slot
    slot[:8] = 0
    return dev


def blocking_copy_is_clean(ring, device):
    slot = ring.acquire()
    dev = slot.to(device)              # a blocking copy has finished
    slot[:8] = 0
    return dev


def no_donation_is_clean(state, batch):
    out = step(state, batch)           # torch donates no operand
    return out, state.counts
