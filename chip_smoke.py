"""Chip smoke test of the PyTorch / CUDA port (``sentinel_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU (written
for an H100)::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``sentinel_tpu_torch/csrc`` (into
the git-ignored ``sentinel_tpu_torch/_build/``), then:

1. builds every kernel, in parallel, and prints the build times;
2. holds each kernel against its plain PyTorch version on the card, exactly,
   at the shapes the main path gives it (and at a one-key stream and both
   sides of the shared-memory threshold), as its launch plan launches it:
   the scalar route's, the origin routes' alt-table records (a small alt
   table's too), their bucket histogram, and the main and alt thread
   gauges; then times each launch cold (L2
   flushed before every launch) and warm, in alternating turns with one
   PyTorch library call as a yardstick (``library_ms``; the port never
   calls it), beside the bound, the plain version's time and an empty
   interval after the same flush;
3. drives the engine at the serving headline's geometry (1M resources,
   512k-event batches, 4096 QPS rules, 1024 exception-ratio breakers, RT
   histograms on) for a run of fused decide+exit steps twice from one
   initial state — with the kernel, and with the plain scatter put in the
   seam — and requires identical verdicts and state, 6 kernel launches
   per step, and no wait on the device inside a kernel-run step (PyTorch's
   sync debug mode set to "error");
4. drives the origin routes the same way: the general route at 1M
   resources (2M alt rows, where the fast path's key does not fit) and the
   fast route at 128k resources, 512k-event batches, 4096 flow rules over
   default, specific-origin, ``other``, CHAIN and RELATE selectors, 1024
   breakers, 64 origins on half the events and 8 contexts on 1/8; each run
   with the kernel, with the plain seam and without sort-free grouping must
   give identical verdicts, claim overflow counts and state, with 14
   (general: THREAD-grade rules keep the thread gauges) or 9 (fast)
   kernel launches per step and no wait on the device;
5. drives the prioritized (occupy) steps the same way at the headline
   geometry, ``step_ms`` of virtual time apart so that bookings are made,
   land and are read: every event prioritized on the fast route's occupy
   step (7 launches a step), 1% prioritized as the runtime splits it
   (scalar step with the landed-booking fold, fast occupy step, exit step:
   8), and the general route with 1/8 prioritized (15); kernel, plain seam
   and sorted order identical, occupied admissions above zero;
6. drives the runtime through the entry points a user calls
   (``Sentinel(device="cuda")`` at 1M resources: ``entry``,
   ``entry_batch``, ``exit_batch``, full-width fused decide+exit steps
   without origins, then with origins and with a system and an authority
   rule loaded; at 16k resources ``entry(origin=...)`` in a call
   context, ``entry_batch(origins=, contexts=)`` and a batch that splits)
   with the launch counters zeroed just before and read just after, and
   checks the verdicts and routes against a CPU twin of the same runtime;
   then the default configuration (host fast path on) at 1M resources:
   FREE and LEASED resources through ``entry``/exit (renewals, a denied
   chunk, lease expiry), ``entry(prioritized=True)`` on a full window, an
   8k batch with 1% prioritized that splits and a rule reload with live
   bookings, all equal to a CPU twin of the same geometry, state included;
7. drives hot-parameter rules: the scalar fixture and the general one with
   512 param rules on 256 of their resources (QPS with bursts, durations
   and per-item overrides, RATE_LIMITER, THREAD; PK = 2^16 key rows, 4
   pairs an event, Zipf user ids), kernel == plain seam == sort-free off,
   11 and 16 launches a step, every grade admitting and denying in every
   step; then ``Sentinel(device="cuda")`` through ``entry(args=)``, a
   reload, vector and general batches, a host gate and a device slot
   against a CPU twin, and one 2^19-event batch at 1M resources (the host
   cost of pair resolution);
8. drives the runtime with its self-telemetry (obs on, the default):
   full-width fused scalar steps on ``Sentinel(device="cuda")`` at 1M
   resources (default configuration, minute ring, 4096 QPS rules, 1024
   breakers with a breaker observer) in turns with a twin built with obs
   off and one with host staging off (host ms a step, equal verdicts and
   launches, the obs counters); a stream of nowait dispatches in flight
   with the staging ring at depth 1 and 8 (equal verdicts, the ring
   grows); ``metrics_snapshot`` and ``all_node_totals`` at 1M rows; and at
   16k rows ``entry`` calls, batches with origins and a split, host-gate
   denials, a forced breaker and a geometry change against a CPU twin:
   counters, spans, histograms, callbacks, block-log and block-event
   files, metric nodes and breaker transitions equal;
9. drives the serving tier (default configuration, 1M resources, the
   scalar fixture's rules, minute ring on): the same stream of full-width
   fused steps sequentially and through ``DispatchPipeline.submit_fused``
   at depth 1, 2 and 4 on twin runtimes in turns (equal verdicts and
   state, host ms a step by depth, the staging ring's growth; with
   ``--profile`` device ms a step and the busy share at depth 1 and 4);
   32k single requests (30% prioritized, 40% with one of 64 origins)
   through ``sph.frontend(batch_max=4096, depth=2)`` against an
   ``entry_batch`` replay of its flush log, and the same drive at 16k rows
   against a CPU twin; the workload zoo (``frontend/workloads``) open-loop
   on the wall clock for 1 s each at ``batch_max`` 256 and 4096 with a
   ``CadenceScheduler`` (offered and achieved decisions/s, request→verdict
   p50/p95/p99, flushes, sheds, and the invariants: every request settles
   once, offered = settled + shed, verdicts = the ENTRY row's PASS,
   OCCUPIED_PASS and BLOCK); and ``sph.telemetry`` at 1M rows (tick and
   drain ms, the hot set and its quantiles against a host recompute with
   tied loads, the timeline ring wrapping past 64 slots);
10. drives tiered resource state, single dispatch and the overload
   controller (default configuration, the scalar fixture's rules, 1M
   rows): (a) 32 batches of 2^16 names, Zipf(1.1) over 2^20 - 4096 names,
   25% prioritized, a flow-rule reload half way, 25 ms a batch, a
   ``CadenceScheduler`` armed at 100 ms, through a tiered runtime
   (``SENTINEL_HOT_ROWS=65536``: most keys pass through the host cold tier)
   in turns with an all-resident one and one with single dispatch off:
   equal verdicts every batch, equal count-min tables, equal launches a
   batch; the same leg at 16k rows against a CPU twin (verdicts, state,
   sketch, cold tier, counters); (b) 2^18 requests, Zipf(1.1) over 16M
   keys, through ``sph.frontend(batch_max=4096, depth=2)`` with the cold
   tier bounded (hit rate, migrations, host ms a flush in intern, demote
   gather and promote restore, device ms of the sketch update, the
   decay+estimate over 1M rows and the row-slice extract/restore); (c)
   fused steps with both carries armed (one dispatch a batch, each
   service ticking once a due slot) and host ms a step armed and
   disarmed in turns; (d) the workload zoo's ``steady`` at 80k req/s with
   and without a ``ControlLoop`` in turns (actions, admitted share, sheds,
   p50/p99) and the ``Degrade`` actuator forcing a real breaker;
11. prints the card's name and power limit, one ``{"kernels": [...]}`` JSON
   line (``launches`` summed over the runs of phases 3-10), and as the last
   line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --find-syncs`` runs 3-5 steps of each engine phase
with the sync debug mode at "warn" and lists every place that waits on
the device, instead of the phases above.

``python3 chip_smoke.py --profile`` also records the engine steps with
``torch.profiler`` (device time by operator and per step, and a Chrome
trace per engine phase in ``chiprun_out/engine*_trace.json``; the origin
routes also in the sorted order alone; the obs phase's runtime steps,
trace deleted once read) and fails if ``index_add_`` still runs in the
scalar step.

Any failed phase exits non-zero before the last line is printed. Without
a CUDA device, or outside a checkout of the repository, it fails at once.
Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
REPLACES = "sentinel_tpu/ops/pallas_kernels.py:46"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sync() -> None:
    torch.cuda.synchronize()


class no_host_sync:
    """PyTorch's sync debug mode set to "error" for the body on the card:
    an engine step that waits on the device (a readback, a boolean mask
    index, an ``.item()``, a tensor made from a Python value) raises
    instead of running. ``--find-syncs`` sets ``mode`` to "warn"."""

    mode = "error"

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        if self.on:
            torch.cuda.set_sync_debug_mode(self.mode)

    def __exit__(self, *exc):
        if self.on:
            torch.cuda.set_sync_debug_mode(0)


class CudaTimer:
    """Device time of single launches, cold and warm, in turns.

    Every timed interval is preceded by a ``torch.cuda._sleep`` long enough
    for the host to enqueue the events and the launches behind it, so the
    interval holds device work only and no host dispatch gaps.

    * cold: before each launch a 256 MB scratch buffer is read (the L2
      holds 50 MB), which evicts the last launch's lines and leaves the L2
      holding clean lines only, so no write-back of the flush falls into
      the timed interval; then that one launch is timed alone. ``empty``
      times an interval with nothing in it after the same flush: the
      floor of the method;
    * warm: one untimed launch, then ``iters`` launches back to back on the
      same data, timed together (mean per launch).

    Functions are timed in alternating turns: a, b, c, then c, b, a, ...
    (with two: kernel, library, library, kernel, ...), so a drift of the
    card's clocks falls on all of them alike."""

    FLUSH_BYTES = 256 << 20
    HOST_MS_PER_LAUNCH = 0.25          # generous host cost of one launch

    def __init__(self):
        self.flush = torch.zeros(self.FLUSH_BYTES // 4, dtype=torch.int32,
                                 device="cuda")
        start, end = self._events()
        torch.cuda._sleep(1_000)
        start.record()
        torch.cuda._sleep(1_000_000)
        end.record()
        end.synchronize()
        self.cycles_per_ms = 1_000_000 / max(start.elapsed_time(end), 1e-3)

    @staticmethod
    def _events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def _hold(self, launches: int) -> None:
        torch.cuda._sleep(int(self.cycles_per_ms * (
            0.2 + launches * self.HOST_MS_PER_LAUNCH)))

    @staticmethod
    def _order(names, turn):
        return names if turn % 2 == 0 else names[::-1]

    def cold(self, fns: dict, samples: int) -> dict:
        fns = {**fns, "empty": lambda: None}
        names = list(fns)
        marks = {name: [] for name in names}
        for turn in range(samples):
            for name in self._order(names, turn):
                self.flush.amax()               # read-only L2 flush
                self._hold(1)
                start, end = self._events()
                start.record()
                fns[name]()
                end.record()
                marks[name].append((start, end))
        torch.cuda.synchronize()
        return {name: [s.elapsed_time(e) for s, e in marks[name]]
                for name in names}

    def warm(self, fns: dict, rounds: int = 6, iters: int = 20) -> dict:
        names = list(fns)
        out = {name: [] for name in names}
        for turn in range(rounds):
            for name in self._order(names, turn):
                fns[name]()
                self._hold(iters)
                start, end = self._events()
                start.record()
                for _ in range(iters):
                    fns[name]()
                end.record()
                end.synchronize()
                out[name].append(start.elapsed_time(end) / iters)
        return out


def host_time_ms(fn, iters: int) -> float:
    """Mean wall time of ``fn()`` over ``iters`` calls, synchronised (the
    plain version, whose boolean indexing synchronises anyway)."""
    fn()
    sync()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t) / iters * 1e3


def summary(times) -> dict:
    """median, min and max of a list of ms."""
    return {"median": float(np.median(times)), "min": float(min(times)),
            "max": float(max(times)), "n": len(times)}


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------

def phase_build(_build) -> dict:
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR)
                     if f.endswith(".cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(_build.build, sources)))
    wall = time.perf_counter() - t0
    for name in sources:
        _build.load(name)
        log(f"[build] {name}: {_build.build_seconds[name]:.2f} s -> "
            f"{os.path.relpath(paths[name])}")
        for line in _build.ptxas_report.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] wall {wall:.2f} s for {len(sources)} source(s)")
    return {"wall_s": wall, "per_source_s": dict(_build.build_seconds)}


# ---------------------------------------------------------------------------
# Phase 2: kernel against its plain version, main-path shapes
# ---------------------------------------------------------------------------

def _bound_ms(keys, events, amounts, k_dim, row_stride, e_dim,
              itemsize=4) -> float:
    """Least time for the scatter on this data: the stream read once plus
    one 32-byte sector read and written back per distinct sector that a
    nonzero, in-range amount touches."""
    k = keys.long()
    k = torch.where(k < 0, k + k_dim, k)
    n = k.shape[0]
    if events is None:                       # payload: each nonzero lane
        lane = torch.arange(e_dim, device=k.device).expand(n, e_dim)
        hit = (amounts != 0) & ((k >= 0) & (k < k_dim))[:, None]
        flat = (k[:, None] * row_stride + lane)[hit]
        stream = n * 4 + amounts.numel() * 4
    else:
        ev = events.long()
        ev = torch.where(ev < 0, ev + e_dim, ev)
        ok = (k >= 0) & (k < k_dim) & (ev >= 0) & (ev < e_dim)
        flat = (k * row_stride + ev)[ok & (amounts != 0)]
        stream = n * 12
    sectors = torch.unique(torch.div(flat * itemsize, 32,
                                     rounding_mode="floor")).numel()
    return (stream + 2 * 32 * sectors) / HBM_BYTES_PER_S * 1e3


def _library_call(table, view, keys, events, amounts):
    """The yardstick: ONE ``index_add_`` over the flattened table with the
    flat index precomputed and the dropped lanes removed (a call the port
    never makes)."""
    k_dim, e_dim = view.shape
    flat_t = table.view(-1)
    kk = torch.where(keys < 0, keys + k_dim, keys).long()
    if events is None:
        lane = torch.arange(e_dim, device=keys.device).expand(keys.shape[0],
                                                              e_dim)
        fi = kk[:, None] * view.stride(0) + lane
        ok = ((kk >= 0) & (kk < k_dim))[:, None].expand_as(fi)
    else:
        ev = torch.where(events < 0, events + e_dim, events).long()
        fi = kk * view.stride(0) + ev
        ok = (kk >= 0) & (kk < k_dim) & (ev >= 0) & (ev < e_dim)
    fi = (fi + view.storage_offset() - table.storage_offset())[ok]
    fi = fi.contiguous()
    amt = amounts[ok].to(table.dtype).contiguous()
    return lambda: flat_t.index_add_(0, fi, amt)


def phase_kernels(sa, hist_buckets: int, dev="cuda", R=1 << 20,
                  B=1 << 19, timer=None, samples: int = 31) -> list:
    g = torch.Generator(device=dev)
    g.manual_seed(7)

    def rint(lo, hi, shape):
        return torch.randint(lo, hi, shape, dtype=torch.int32, device=dev,
                             generator=g)

    def hot_keys(n, k_dim, hot_rows=4096):
        hot = rint(1, hot_rows + 1, (n // 4,))
        cold = rint(1, k_dim, (n - n // 4,))
        keys = torch.cat([hot, cold])[torch.randperm(n, device=dev,
                                                     generator=g)]
        keys[::97] = k_dim                   # padding lanes (dropped)
        keys[5] = -1                         # wraps once to K-1
        return keys.contiguous()

    ones = torch.ones(B, dtype=torch.int32, device=dev)
    cases = []

    def case(name, per_step, table, view_of, keys, events, amounts,
             path=None):
        cases.append(dict(name=name, per_step=per_step, table=table,
                          view_of=view_of, keys=keys, events=events,
                          amounts=amounts, path=path))

    whole = (lambda t: t)
    bucket1 = (lambda t: t[:, 1, :])
    # (a) decide step: the second window's bucket slice [R, 8] of [R, 2, 8]
    base = rint(0, 50, (R, 2, 8))
    case("decide [R,8] slice of [R,2,8], N=B", 1, base, bucket1,
         hot_keys(B, R), rint(0, 2, (B,)), ones)
    # (b) exit step: payload mode, SUCCESS/EXCEPTION lanes of [N, 8]
    payload = torch.zeros((B, 8), dtype=torch.int32, device=dev)
    payload[:, 3] = 1
    payload[:, 2] = (torch.rand(B, device=dev, generator=g) < 0.1).int()
    case("exit payload [R,8] slice, N=B", 1, base.clone(), bucket1,
         hot_keys(B, R), None, payload)
    # (c) rt_hist: [R, HB]
    case(f"rt_hist [R,{hist_buckets}], N=B", 1,
         torch.zeros((R, hist_buckets), dtype=torch.int32, device=dev),
         whole, hot_keys(B, R), rint(0, hist_buckets, (B,)), ones)
    # (d) rt_sum: f32 column [R, 1] of [R, 2] (row stride 2), payload E=1;
    # a quarter of the lanes are exit padding (row R), rt in [1, 200]
    rt_keys = hot_keys(B, R)
    rt_keys[torch.rand(B, device=dev, generator=g) < 0.25] = R
    case("rt_sum f32 [R,1] col of [R,2], N=B", 1,
         torch.randint(0, 50, (R, 2), device=dev, generator=g).float(),
         lambda t: t[:, 1:2], rt_keys, None, rint(1, 201, (B, 1)))
    # (e) breakers' per-rule counts: [1025, 1], 1024 rules + the ND row;
    # 1/16 of the lanes carry a rule and a 1, the rest sit on ND with 0
    brk = torch.full((B,), 1024, dtype=torch.int32, device=dev)
    on = torch.rand(B, device=dev, generator=g) < 1 / 16
    brk[on] = rint(0, 1024, (int(on.sum()),))
    case("breakers int32 [1025,1], N=B", 2,
         torch.zeros((1025, 1), dtype=torch.int32, device=dev), whole,
         brk, None, on.int()[:, None].contiguous(), sa.PATH_SHARED)
    # (f) every element on one cell
    case("one key: [R,8] table, all on [12345, 6], N=B", 0,
         torch.zeros((R, 8), dtype=torch.int32, device=dev), whole,
         torch.full((B,), 12345, dtype=torch.int32, device=dev),
         torch.full((B,), 6, dtype=torch.int32, device=dev), ones)
    # (g, h) the shared-memory threshold: [7264, 8] int32 is 232,448 bytes,
    # the largest table one block can privatise. The stream has 16·B
    # elements, so that the private copies (one per SM) hold fewer cells
    # than it has amounts and the plan takes the shared path where the
    # table fits.
    n_long = 16 * B
    for k_small, path in ((7264, sa.PATH_SHARED), (7265, sa.PATH_GLOBAL)):
        case(f"int32 [{k_small},8], N=16B", 0,
             rint(0, 50, (k_small, 8)), whole,
             hot_keys(n_long, k_small, 512), rint(0, 8, (n_long,)),
             rint(1, 4, (n_long,)), path)
    # (i) float32 counters [4096, 8] (sums stay far below 2^24)
    case("f32 [4096,8], N=B", 0,
         torch.randint(0, 50, (4096, 8), device=dev, generator=g).float(),
         whole, hot_keys(B, 4096, 512), rint(0, 8, (B,)), rint(1, 4, (B,)))
    # (j-n) the origin routes' launches (the general route's geometry:
    # RA = 2R alt rows; half the events carry an origin, 1/8 a context)
    RA = 2 * R

    def alt_keys(n, share, k_dim=RA):
        keys = rint(0, k_dim, (n,))
        keys[torch.rand(n, device=dev, generator=g) >= share] = k_dim
        return keys

    alt2 = torch.cat([alt_keys(B, 0.5), alt_keys(B, 0.125)])
    alt_base = rint(0, 50, (RA, 2, 8))
    case("alt decide [2R,8] slice of [2R,2,8], N=2B", 1, alt_base,
         bucket1, alt2, rint(0, 2, (2 * B,)),
         torch.ones(2 * B, dtype=torch.int32, device=dev))
    alt_payload = torch.cat([payload, payload])
    case("alt exit payload [2R,8] slice, N=2B", 1, alt_base.clone(),
         bucket1, alt2, None, alt_payload)
    case("alt rt_sum f32 [2R,1] col of [2R,2], N=2B", 1,
         torch.randint(0, 50, (RA, 2), device=dev, generator=g).float(),
         lambda t: t[:, 1:2], alt2, None, rint(1, 201, (2 * B, 1)))
    # the general route's bucket histogram: 2 rules per resource, so
    # B·K = 2B pairs; T = 2^18 claim slots, 3 rounds + the reserved
    # bucket 3T, which every inapplicable or padding pair lands on
    from sentinel_tpu_torch.ops.sortfree import table_bits
    n_pairs = 2 * B
    t_slots = 1 << table_bits(n_pairs)
    buckets = torch.full((n_pairs,), 3 * t_slots, dtype=torch.int32,
                         device=dev)
    live = torch.rand(n_pairs, device=dev, generator=g) < 0.15
    buckets[live] = rint(0, 3 * t_slots, (int(live.sum()),))
    case("bucket histogram [3T+1,1], one hot bucket, N=2B", 1,
         torch.zeros((3 * t_slots + 1, 1), dtype=torch.int32, device=dev),
         whole, buckets, torch.zeros_like(buckets),
         torch.ones_like(buckets))
    # the fast route's alt record where RA <= 4096 (the JAX package's
    # one-hot histogram branch): one uniform acquire on every lane
    small_rows = torch.cat([alt_keys(B, 0.5, 4096),
                            alt_keys(B, 0.125, 4096)])
    case("alt decide, small table [4096,8] slice of [4096,2,8], N=2B", 0,
         rint(0, 50, (4096, 2, 8)), bucket1, small_rows,
         rint(0, 2, (2 * B,)),
         torch.ones(2 * B, dtype=torch.int32, device=dev))
    # the thread gauges (on when a THREAD-grade flow rule or a system rule
    # is loaded): int32 [R] and [2R] as [K,1] payload columns; the exit's
    # -1 per valid event, its padding lanes dropped (a decide adds +1 per
    # admitted event the same way)
    dec = torch.full((B, 1), -1, dtype=torch.int32, device=dev)
    case("threads int32 [R,1], payload E=1, N=B", 2,
         rint(0, 50, (R,)), lambda t: t[:, None], hot_keys(B, R), None, dec)
    case("alt threads int32 [2R,1], payload E=1, N=2B", 2,
         rint(0, 50, (RA,)), lambda t: t[:, None], alt2, None,
         torch.cat([dec, dec]))
    # the occupy grants (prioritized steps): float32 [R, 1], one lane a
    # batch event, the admitted 1% with their acquire, the rest at the
    # padding key R (dropped)
    grant_keys = torch.full((B,), R, dtype=torch.int32, device=dev)
    booked = torch.rand(B, device=dev, generator=g) < 0.01
    grant_keys[booked] = rint(0, R, (int(booked.sum()),))
    case("occupy grants f32 [R,1], payload E=1, N=B", 1,
         torch.zeros((R, 1), dtype=torch.float32, device=dev), whole,
         grant_keys, None, torch.where(booked, rint(1, 4, (B,)), 0)[
             :, None].contiguous())
    # uncount_rows (the host fast path's expired leases): the [R·B, 8]
    # view of the second window's counters, key row·B + bucket, negative
    # PASS amounts, 1/8 of the lanes padding rows
    n_unc = 1 << 12
    unc_rows = rint(0, R, (n_unc,))
    unc_rows[::8] = R
    unc_keys = (unc_rows * 2 + rint(0, 2, (n_unc,))).contiguous()
    case("uncount int32 [2R,8] view of [R,2,8], N=4096", 0,
         rint(0, 50, (R, 2, 8)), lambda t: t.view(2 * R, 8), unc_keys,
         torch.zeros(n_unc, dtype=torch.int32, device=dev),
         -rint(1, 250, (n_unc,)))
    # the param rules' two scatters at the config's PK = 2^16 key rows, one
    # lane a (event, pair), N = B·PV: the rank-form check's token
    # consumption (float32, -acquire a consuming lane; the ~98% of lanes
    # that are no param pair, or consume nothing, at PK+1, dropped) and
    # the THREAD update (int32, ±1; a lane that does not count at the
    # sentinel row PK with amount 0). Live keys Zipf-skewed over 61,440
    n_pair = B * PARAM_PAIRS
    zipf = torch.from_numpy((np.random.default_rng(13).zipf(1.1, n_pair)
                             % 61_440).astype(np.int32)).to(dev)
    paired = torch.rand(n_pair, device=dev, generator=g) < 0.02
    consume = paired & (torch.rand(n_pair, device=dev, generator=g) < 0.6)
    case("param tokens f32 [PK+1,1], payload E=1, N=B*PV", 1,
         torch.randint(0, 8, (PARAM_KEYS + 1, 1), device=dev,
                       generator=g).float(), whole,
         torch.where(paired, zipf, PARAM_KEYS + 1).contiguous(), None,
         torch.where(consume, -1, 0).int()[:, None].contiguous())
    case("param threads int32 [PK+1,1], payload E=1, N=B*PV", 2,
         rint(0, 3, (PARAM_KEYS + 1, 1)), whole,
         torch.where(paired, zipf, PARAM_KEYS).contiguous(), None,
         torch.where(consume, 1, 0).int()[:, None].contiguous())

    results = []
    for c in cases:
        name, view_of = c["name"], c["view_of"]
        keys, events, amounts = c["keys"], c["events"], c["amounts"]
        table = c["table"]
        view = view_of(table)
        k_dim, e_dim = view.shape
        plan = sa.plan_for(view, keys, events)
        if c["path"] is not None and plan.path != c["path"]:
            fail(f"{name}: planned the {plan.path} path, want {c['path']}")
        want = table.clone()
        sa.scatter_add_reference(view_of(want), keys, events, amounts)
        got = table.clone()
        sa.scatter_add_kernel(view_of(got), keys, events, amounts)
        sync()
        err = float((got.double() - want.double()).abs().max())
        if err != 0.0 or not torch.equal(got, want):
            fail(f"kernel disagrees with its plain version on {name}: "
                 f"max |diff| = {err}")
        del got, want
        tk = table.clone()
        tv = view_of(tk)
        # turns: kernel, library, library, kernel, ...
        fns = {"kernel": lambda: sa.scatter_add_kernel(tv, keys, events,
                                                       amounts),
               "library": _library_call(tk, tv, keys, events, amounts)}
        cold = {n: summary(v) for n, v in timer.cold(fns, samples).items()}
        warm = {n: summary(v) for n, v in timer.warm(fns).items()}
        plain_ms = host_time_ms(
            lambda: sa.scatter_add_reference(tv, keys, events, amounts), 3)
        bound = _bound_ms(keys, events, amounts, k_dim, view.stride(0),
                          e_dim, table.element_size())
        share = bound / cold["kernel"]["median"]
        log(f"[kernel] {name}: plan {plan.path}/E{plan.e_inst}/"
            f"i{plan.index_bits} grid {plan.grid}x{plan.block} "
            f"smem {plan.smem_bytes}; max_abs_err={err}")
        for n in cold:
            if n not in warm:
                log(f"[kernel]   {n:12s} cold median {cold[n]['median']:.4f}"
                    f" ms [{cold[n]['min']:.4f}, {cold[n]['max']:.4f}]")
                continue
            log(f"[kernel]   {n:12s} cold median {cold[n]['median']:.4f} ms "
                f"[{cold[n]['min']:.4f}, {cold[n]['max']:.4f}]  warm "
                f"{warm[n]['median']:.4f} ms [{warm[n]['min']:.4f}, "
                f"{warm[n]['max']:.4f}]")
        log(f"[kernel]   bound {bound:.4f} ms (bytes), share of bound "
            f"(cold median) {share:.3f}, plain {plain_ms:.3f} ms")
        results.append({"case": name, "launches_per_step": c["per_step"],
                        "plan": dataclasses.asdict(plan),
                        "max_abs_err": err, "bound_ms": bound,
                        "plain_ms": plain_ms, "cold": cold, "warm": warm,
                        "share_of_bound_cold": share})
        del tk, tv, fns
    return results


# ---------------------------------------------------------------------------
# Phase 3: engine at the headline geometry, kernel vs plain seam
# ---------------------------------------------------------------------------

def _clone_state(state):
    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(clone(v) for v in x))
        return x
    return clone(state)


def _scalar_fixture(dev, R: int, B: int, prio_share: float = 0.0,
                    param: bool = False):
    """The serving headline's engine fixture (``bench.py:270-376``): 4096
    QPS rules (count 50) on rows 1..4095, 1024 exception-ratio breakers,
    four batches of B origin-free events (1/4 on ruled rows) with
    ``prio_share`` of them prioritized, RT samples and errors → (spec,
    rules, batches, rt_ms, errors, init state, param grades). With
    ``param`` the 512 param rules of :func:`_with_param` ride on it (the
    grades of its rows, else None)."""
    from sentinel_tpu_torch.core.registry import (
        OriginRegistry, Registry, ResourceRegistry,
    )
    from sentinel_tpu_torch.engine import pipeline as pl
    from sentinel_tpu_torch.rules import authority as auth_mod
    from sentinel_tpu_torch.rules import degrade as deg_mod
    from sentinel_tpu_torch.rules import flow as flow_mod
    from sentinel_tpu_torch.rules import system as sys_mod
    from sentinel_tpu_torch.stats.window import WindowSpec

    NRULES = 4096
    spec = pl.EngineSpec(rows=R, alt_rows=1024,
                         second=WindowSpec(buckets=2, win_ms=500),
                         minute=None, statistic_max_rt=5000,
                         hist_buckets=32)
    resources = ResourceRegistry(R)
    origins = OriginRegistry(64)
    contexts = Registry(64, reserved=("sentinel_default_context",))
    flow = flow_mod.compile_flow_rules(
        [flow_mod.FlowRule(resource=f"r{i}", count=50.0)
         for i in range(NRULES)],
        resource_registry=resources, context_registry=contexts,
        capacity=NRULES, k_per_resource=2, num_rows=R,
        origin_registry=origins, device=dev)
    deg_rules = [deg_mod.DegradeRule(resource=f"r{i}",
                                     grade=deg_mod.GRADE_EXCEPTION_RATIO,
                                     count=0.5, time_window=10)
                 for i in range(1024)]
    deg = deg_mod.compile_degrade_rules(
        deg_rules, resource_registry=resources, capacity=1024,
        k_per_resource=2, num_rows=R, device=dev)
    auth = auth_mod.compile_authority_rules(
        [], resource_registry=resources, origin_registry=origins,
        capacity=16, k_per_resource=2, num_rows=R, device=dev)
    rules = pl.RuleSet(
        flow_table=flow.table, flow_idx=flow.rule_idx[:, :flow.k_used],
        deg_table=deg.table, deg_idx=deg.rule_idx[:, :deg.k_used],
        auth_table=auth.table, auth_idx=auth.rule_idx,
        sys_thresholds=sys_mod.compile_system_rules([], device=dev),
    ).with_joint()

    rng = np.random.default_rng(42)
    batches = []
    for _ in range(4):
        hot = rng.integers(1, NRULES, B // 4)
        cold = rng.integers(1, R, B - B // 4)
        rows = np.concatenate([hot, cold]).astype(np.int32)
        rng.shuffle(rows)
        t = torch.from_numpy(rows).to(dev)
        # its own generator: the rest of the fixture is the same for
        # every share
        prio = np.random.default_rng(44 + len(batches)).random(B) \
            < prio_share
        batches.append(pl.EntryBatch(
            rows=t, origin_ids=torch.zeros_like(t),
            origin_rows=torch.full_like(t, spec.alt_rows),
            context_ids=torch.zeros_like(t),
            chain_rows=torch.full_like(t, spec.alt_rows),
            acquire=torch.ones_like(t),
            is_in=torch.ones(B, dtype=torch.bool, device=dev),
            prioritized=torch.from_numpy(prio).to(dev),
            valid=torch.ones(B, dtype=torch.bool, device=dev)))
    rt_ms = [torch.from_numpy(rng.integers(0, 200, B).astype(np.int32)).to(dev)
             for _ in range(4)]
    errors = [torch.from_numpy(rng.random(B) < 0.3).to(dev) for _ in range(4)]
    grades = None
    if param:
        spec, rules, batches, grades = _with_param(
            dev, spec, rules, resources, batches,
            [f"r{i}" for i in range(PARAM_RESOURCES)], 46)
    init = pl.init_state(spec, NRULES, 1024, device=dev)
    return spec, rules, batches, rt_ms, errors, init, grades


def _times_at(spec, step_ms: int):
    """The engine's time scalars of step ``i``, ``step_ms`` of virtual
    time apart."""
    t0_ms = 1_000_000_000

    def times(i):
        now = t0_ms + i * step_ms
        return (spec.second.index_of(now), 0, now - t0_ms,
                now % spec.second.win_ms)
    return times


def phase_engine(stt, sa, dev="cuda", R=1 << 20, B=1 << 19,
                 steps: int = 20, profile: bool = False) -> dict:
    from sentinel_tpu_torch import convert
    from sentinel_tpu_torch.engine import pipeline as pl

    dev = torch.device(dev)
    spec, rules, batches, rt_ms, errors, init, _ = _scalar_fixture(dev, R, B)
    flags = dict(skip_auth=True, skip_sys=True, scalar_has_rl=False,
                 skip_threads=True, scalar_flow=True, record_alt=False)
    times = _times_at(spec, 2)

    def run(state, strict=False):
        verdicts = []
        step_s = []
        prev_rows = torch.full((B,), R, dtype=torch.int32, device=dev)
        prev_valid = torch.zeros(B, dtype=torch.bool, device=dev)
        for i in range(steps):
            xb = pl.ExitBatch(
                rows=prev_rows, origin_rows=torch.full_like(prev_rows, 1024),
                chain_rows=torch.full_like(prev_rows, 1024),
                acquire=torch.ones_like(prev_rows), rt_ms=rt_ms[i % 4],
                error=errors[i % 4], is_in=torch.ones_like(prev_valid),
                valid=prev_valid)
            sync()
            t = time.perf_counter()
            with no_host_sync(strict and dev.type == "cuda"):
                state, v = pl.decide_and_record_exits(
                    spec, rules, state, batches[i % 4], xb, times(i),
                    (0.5, 0.1), **flags)
            sync()
            step_s.append(time.perf_counter() - t)
            verdicts.append(v)
            prev_rows = torch.where(v.allow, batches[i % 4].rows, R)
            prev_valid = v.allow.clone()
        return state, verdicts, step_s

    # warm-up on a throwaway copy (allocator, library handles)
    run(_clone_state(init))
    sa.LAUNCHES.clear()
    s_kernel, v_kernel, step_s = run(_clone_state(init), strict=True)
    launches = sa.LAUNCHES["scatter_add"]
    # per fused step: the decide record; the exit payload, rt_sum and
    # rt_hist adds; the breakers' two per-rule counts
    if launches != 6 * steps:
        fail(f"engine phase: {launches} kernel launches in {steps} steps, "
             f"want 6 per step")
    real = sa.scatter_add
    sa.scatter_add = sa.scatter_add_reference     # the plain seam, explicitly
    try:
        sa.LAUNCHES.clear()
        s_plain, v_plain, _ = run(_clone_state(init))
        if sa.LAUNCHES["scatter_add"]:
            fail("engine phase: the plain run launched the kernel")
    finally:
        sa.scatter_add = real
    for i, (a, b) in enumerate(zip(v_kernel, v_plain)):
        for f in ("allow", "reason", "wait_ms"):
            if not torch.equal(getattr(a, f), getattr(b, f)):
                fail(f"engine phase: verdict {f} differs at step {i}")
    bad = convert.leaf_diff(convert.to_numpy(s_plain),
                            convert.to_numpy(s_kernel))
    if bad:
        fail(f"engine phase: state leaves differ: {bad}")
    allowed = int(sum(int(v.allow.sum()) for v in v_kernel))
    med = float(np.median(step_s[1:]))
    out = {"R": R, "B": B, "steps": steps, "launches": launches,
           "launches_per_step": launches / steps,
           "step_ms_median": med * 1e3,
           "step_ms_all": [s * 1e3 for s in step_s],
           "decisions_per_s": B / med, "allowed": allowed}
    log(f"[engine] R={R} B={B} steps={steps}: verdicts and state equal "
        f"(kernel vs plain seam); step median {med * 1e3:.3f} ms, "
        f"{B / med:.0f} decisions/s, kernel launches {launches} "
        f"({launches / steps:.1f}/step), allowed {allowed}")
    if profile:
        out["profile"] = prof = _profile_steps(
            lambda: run(_clone_state(init)), steps)
        if prof["index_add"]:
            fail(f"engine phase: index_add_ still runs in the step: "
                 f"{prof['index_add']}")
        log(f"[engine] device time {prof['device_ms_per_step']:.3f} ms per "
            f"step (sum of kernel, memcpy and memset durations in the trace)")
    return out


def _state_equal(a, b, convert) -> list:
    """Leaves of two engine states that differ."""
    return convert.leaf_diff(convert.to_numpy(a), convert.to_numpy(b))


def _booked_for(state, idx) -> int:
    """Booked units in the ring for window index ``idx``."""
    return int(torch.where(state.flow_dyn.occupied_window == idx,
                           state.flow_dyn.occupied_count, 0.0).sum())


def _landed_bookings(state, spec, idx_s) -> int:
    """Bookings in the ring whose window has been reached (and is still
    in the rolling interval) at window index ``idx_s``: what the next
    step folds into its QPS base."""
    age = idx_s - state.flow_dyn.occupied_window
    live = (age >= 0) & (age < spec.second.buckets)
    return int(torch.where(live, state.flow_dyn.occupied_count, 0.0).sum())


def phase_prio_engine(stt, sa, mode: str, dev="cuda", R=1 << 20,
                      B=1 << 19, steps: int = 12, step_ms: int = 125,
                      profile: bool = False) -> dict:
    """The reference bench's prioritized modes (``general_bench.py:503-545``)
    at the headline geometry, ``step_ms`` of virtual time a step so that
    windows fill, attempts are denied, and bookings are made, land and are
    read by later steps:

    * ``prio`` — every event prioritized: fused decide+exit steps on the
      fast route's occupy-aware step (record_alt off); 7 kernel launches a
      step (the scalar fused step's 6 and the grants);
    * ``prio_mixed`` — 1% prioritized, as the runtime splits it while
      occupy is live: the scalar step (occupy_base) on the bulk, the fast
      occupy step on the prioritized slice, then the exit step; 8 launches
      a step (1 + 2 + 5).

    Kernel, plain seam and sort-free off must give identical verdicts,
    claim overflow and state (booking ring included), with no wait on the
    device inside a kernel-run step."""
    from sentinel_tpu_torch import convert
    from sentinel_tpu_torch.core.batching import pad_pow2
    from sentinel_tpu_torch.engine import pipeline as pl

    dev = torch.device(dev)
    share = 1.0 if mode == "prio" else 0.01
    spec, rules, batches, rt_ms, errors, init, _ = _scalar_fixture(
        dev, R, B, prio_share=share)
    times = _times_at(spec, step_ms)
    base = dict(skip_auth=True, skip_sys=True, scalar_has_rl=False,
                skip_threads=True, record_alt=False, enable_occupy=True)
    fast_flags = dict(base, fast_flow=True, any_prio=True)
    scalar_flags = dict(base, scalar_flow=True)
    splits = []
    if mode == "prio_mixed":
        # the runtime's host split: prioritized events on the fast side,
        # each side padded to a power of two (rows R, valid False)
        for b in batches:
            prio = b.prioritized.cpu().numpy()
            sides = []
            for idx in (np.nonzero(~prio)[0], np.nonzero(prio)[0]):
                m, n = idx.shape[0], pad_pow2(idx.shape[0])
                it = torch.from_numpy(idx).to(dev)

                def take(col, fill, it=it, m=m, n=n):
                    out = torch.full((n,), fill, dtype=col.dtype,
                                     device=dev)
                    out[:m] = col[it]
                    return out
                sides.append((it, pl.EntryBatch(
                    rows=take(b.rows, R), origin_ids=take(b.origin_ids, 0),
                    origin_rows=take(b.origin_rows, spec.alt_rows),
                    context_ids=take(b.context_ids, 0),
                    chain_rows=take(b.chain_rows, spec.alt_rows),
                    acquire=take(b.acquire, 0), is_in=take(b.is_in, False),
                    prioritized=take(b.prioritized, False),
                    valid=take(b.valid, False))))
            splits.append(sides)

    def run(state, sortfree=True, strict=False, track=False):
        out, step_s, landed = [], [], []
        prev_rows = torch.full((B,), R, dtype=torch.int32, device=dev)
        prev_valid = torch.zeros(B, dtype=torch.bool, device=dev)
        for i in range(steps):
            b = batches[i % 4]
            xb = pl.ExitBatch(
                rows=prev_rows, origin_rows=torch.full_like(prev_rows, 1024),
                chain_rows=torch.full_like(prev_rows, 1024),
                acquire=torch.ones_like(prev_rows), rt_ms=rt_ms[i % 4],
                error=errors[i % 4], is_in=torch.ones_like(prev_valid),
                valid=prev_valid)
            if track:
                landed.append(_landed_bookings(state, spec, times(i)[0]))
            sync()
            t = time.perf_counter()
            with no_host_sync(strict and dev.type == "cuda"):
                if mode == "prio":
                    state, v = pl.decide_and_record_exits(
                        spec, rules, state, b, xb, times(i), (0.5, 0.1),
                        sortfree=sortfree, **fast_flags)
                    parts = [(v, None)]
                else:
                    (i_s, bs), (i_g, bg) = splits[i % 4]
                    state, v1 = pl.decide_entries(
                        spec, rules, state, bs, times(i), (0.5, 0.1),
                        sortfree=sortfree, **scalar_flags)
                    state, v2 = pl.decide_entries(
                        spec, rules, state, bg, times(i), (0.5, 0.1),
                        sortfree=sortfree, **fast_flags)
                    state = pl.record_exits(spec, rules, state, xb,
                                            times(i), record_alt=False,
                                            skip_threads=True)
                    parts = [(v1, i_s), (v2, i_g)]
                allow = torch.zeros(B, dtype=torch.bool, device=dev)
                wait = torch.zeros(B, dtype=torch.int32, device=dev)
                ovf = torch.zeros((), dtype=torch.int32, device=dev)
                for v, idx in parts:
                    if idx is None:
                        allow, wait = v.allow, v.wait_ms
                    else:
                        allow[idx] = v.allow[:idx.shape[0]]
                        wait[idx] = v.wait_ms[:idx.shape[0]]
                    ovf = ovf + v.sf_overflow if sortfree else ovf
            sync()
            step_s.append(time.perf_counter() - t)
            out.append((allow, wait, ovf))
            prev_rows = torch.where(allow, b.rows, R)
            prev_valid = allow.clone()
        return state, out, step_s, landed

    run(_clone_state(init))                             # warm-up
    sa.LAUNCHES.clear()
    s_kernel, v_kernel, step_s, _ = run(_clone_state(init), strict=True)
    launches = sa.LAUNCHES["scatter_add"]
    per_step = 7 if mode == "prio" else 8
    if launches != per_step * steps:
        fail(f"{mode} engine phase: {launches} kernel launches in {steps} "
             f"steps, want {per_step} per step")
    real = sa.scatter_add
    sa.scatter_add = sa.scatter_add_reference     # the plain seam
    try:
        sa.LAUNCHES.clear()
        s_plain, v_plain, _, _ = run(_clone_state(init))
        if sa.LAUNCHES["scatter_add"]:
            fail(f"{mode} engine phase: the plain run launched the kernel")
    finally:
        sa.scatter_add = real
    s_sorted, v_sorted, _, landed = run(_clone_state(init), sortfree=False,
                                        strict=True, track=True)
    occupied = overflow = 0
    for i, (a, b, c) in enumerate(zip(v_kernel, v_plain, v_sorted)):
        for k, f in enumerate(("allow", "wait_ms")):
            if not (torch.equal(a[k], b[k]) and torch.equal(a[k], c[k])):
                fail(f"{mode} engine phase: verdict {f} differs at step {i}")
        if int(a[2]) != int(b[2]):
            fail(f"{mode} engine phase: sf_overflow differs at step {i}")
        overflow += int(a[2])
        occupied += int((a[0] & (a[1] > 0)).sum())
    for other, tag in ((s_plain, "plain seam"), (s_sorted, "sorted order")):
        bad = _state_equal(s_kernel, other, convert)
        if bad:
            fail(f"{mode} engine phase: state differs from the {tag} run: "
                 f"{bad}")
    if occupied == 0:
        fail(f"{mode} engine phase: no occupied admission")
    if not any(landed):
        fail(f"{mode} engine phase: no booking landed in a later step")
    med = float(np.median(step_s[1:]))
    allowed = int(sum(int(v[0].sum()) for v in v_kernel))
    out = {"mode": mode, "R": R, "B": B, "steps": steps,
           "step_ms_virtual": step_ms, "launches": launches,
           "launches_per_step": launches / steps,
           "step_ms_median": med * 1e3,
           "step_ms_all": [x * 1e3 for x in step_s],
           "decisions_per_s": B / med, "allowed": allowed,
           "occupied": occupied, "landed_per_step": landed,
           "sf_overflow": overflow}
    log(f"[{mode}] R={R} B={B} steps={steps} ({step_ms} ms apart): "
        f"verdicts, sf_overflow and state equal (kernel, plain seam, sorted "
        f"order); step median {med * 1e3:.3f} ms ({B / med:.0f} "
        f"decisions/s); kernel launches {launches} ({launches / steps:.1f}"
        f"/step); allowed {allowed}; occupied admissions {occupied}; landed "
        f"bookings read per step {landed}; claim overflow {overflow}")
    if profile:
        out["profile"] = prof = _profile_steps(
            lambda: run(_clone_state(init)), steps,
            f"engine_{mode}_trace.json")
        log(f"[{mode}] device time {prof['device_ms_per_step']:.3f} ms per "
            f"step")
    return out

# ---------------------------------------------------------------------------
# Hot-parameter rules at full width
# ---------------------------------------------------------------------------

PARAM_RESOURCES = 256        # ruled resources, two param rules each
PARAM_KEYS, PARAM_PAIRS = 1 << 16, 4   # the config's defaults (PK, PV)
PARAM_VALUES = 120           # user ids per rule, Zipf s = 1.1
PARAM_CAPACITY = 512
GRADES = ("qps", "rate_limiter", "thread")


def _param_rules(tpf, names):
    """Two rules on each resource, one on ``paramIdx`` 0 and one on 1, of
    one grade by resource: 3/4 QPS DEFAULT (some with a burst, some with
    ``durationInSec`` 2, some with a per-item override), 1/8 RATE_LIMITER
    (``maxQueueingTimeMs`` 0 or 20), 1/8 THREAD → (rules, grade code of
    each name: 1 QPS, 2 RATE_LIMITER, 3 THREAD)."""
    rules, grade = [], {}
    for i, name in enumerate(names):
        for idx in (0, 1):
            if i % 8 == 6:
                grade[name] = 2
                rules.append(tpf.ParamFlowRule(
                    resource=name, param_idx=idx, count=100.0,
                    control_behavior=tpf.BEHAVIOR_RATE_LIMITER,
                    max_queueing_time_ms=0 if i % 16 == 6 else 20))
            elif i % 8 == 7:
                grade[name] = 3
                rules.append(tpf.ParamFlowRule(
                    resource=name, param_idx=idx, count=2.0,
                    grade=tpf.GRADE_THREAD))
            else:
                grade[name] = 1
                items = ([tpf.ParamFlowItem(object=1, count=9)]
                         if i % 5 == 0 else [])
                rules.append(tpf.ParamFlowRule(
                    resource=name, param_idx=idx, count=3.0,
                    burst_count=2 if i % 3 == 1 else 0,
                    duration_in_sec=2 if i % 3 == 2 else 1,
                    param_flow_item_list=items))
    return rules, grade


def _with_param(dev, spec, rules, resources, batches, names, seed):
    """The param rules of :func:`_param_rules` on ``names`` (rows of
    ``resources``), the engine's key table at the config's defaults, and
    each batch's events on those rows given one Zipf-distributed user id
    per rule (1/16 of them a 3-element collection in the second argument:
    four pairs), resolved on the host → (spec, rules, batches, grade code
    of every row int8[R] on ``dev``)."""
    from sentinel_tpu_torch.rules import param_flow as tpf
    prules, grade = _param_rules(tpf, names)
    comp = tpf.compile_param_rules(
        prules, resource_registry=resources, capacity=PARAM_CAPACITY,
        k_per_resource=2, device=dev)
    registry = tpf.ParamKeyRegistry(PARAM_KEYS)
    spec = dataclasses.replace(spec, param_keys=PARAM_KEYS,
                               param_pairs=PARAM_PAIRS)
    rules = rules._replace(param_table=comp.table)
    grades = np.zeros(spec.rows, np.int8)
    for name, g in grade.items():
        grades[resources.lookup(name)] = g
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, PARAM_VALUES + 1) ** 1.1
    p /= p.sum()
    out = []
    for b in batches:
        rows = b.rows.cpu().numpy()
        idx = np.nonzero(grades[np.minimum(rows, spec.rows - 1)] > 0)[0]
        m = idx.shape[0]
        v = rng.choice(PARAM_VALUES, (m, 4), p=p)
        many = rng.random(m) < 1 / 16
        args = [(int(a[0]), [int(x) for x in a[1:]] if many[j]
                 else int(a[1])) for j, a in enumerate(v)]
        pr_sub, pk_sub = tpf.resolve_pairs_many(comp, registry, rows[idx],
                                                args, PARAM_PAIRS)
        n = rows.shape[0]
        pr = np.full((n, PARAM_PAIRS), PARAM_CAPACITY, np.int32)
        pk = np.full((n, PARAM_PAIRS), PARAM_KEYS, np.int32)
        pr[idx], pk[idx] = pr_sub, pk_sub
        out.append(b._replace(param_rules=torch.from_numpy(pr).to(dev),
                              param_keys=torch.from_numpy(pk).to(dev)))
    evicted, _ = registry.drain_updates()
    if evicted or len(registry) > 2 * PARAM_RESOURCES * PARAM_VALUES:
        fail(f"param fixture: {len(registry)} key rows, {len(evicted)} "
             f"evicted")
    return spec, rules, out, torch.from_numpy(grades).to(dev)


def _grade_counts(grades, batch, verdicts) -> torch.Tensor:
    """int32[3, 2] on the device: per grade, the valid events its param
    slot admitted and those it denied (``PARAM_FLOW``)."""
    from sentinel_tpu_torch.core.errors import BlockReason
    g = grades[torch.clamp(batch.rows, max=grades.shape[0] - 1).long()]
    denied = verdicts.reason == BlockReason.PARAM_FLOW
    rows = []
    for code in (1, 2, 3):
        on = batch.valid & (g == code)
        rows.append(torch.stack([(on & ~denied).sum(dtype=torch.int32),
                                 (on & denied).sum(dtype=torch.int32)]))
    return torch.stack(rows)


def _check_grades(tag: str, counts) -> list:
    """Every grade admitted and denied in every step → the counts."""
    table = torch.stack(counts).cpu().numpy()         # [steps, 3, 2]
    for i, step in enumerate(table):
        for g, (adm, den) in enumerate(step):
            if adm == 0 or den == 0:
                fail(f"{tag}: step {i}: grade {GRADES[g]} admitted {adm}, "
                     f"denied {den}")
    return table.tolist()


def phase_param_engine(stt, sa, dev="cuda", R=1 << 20, B=1 << 19,
                       steps: int = 12, profile: bool = False) -> dict:
    """The scalar route with hot-parameter rules: the headline fixture
    plus 512 param rules on 256 of its ruled resources (THREAD grade among
    them, so the thread gauges and the param THREAD update are on), fused
    decide+exit steps whose exits are the previous step's admissions with
    their pairs. Kernel, plain seam and sort-free off must give identical
    verdicts and state (``param_dyn`` included), 11 kernel launches a
    step, no wait on the device, and every grade admitting and denying in
    every step."""
    from sentinel_tpu_torch import convert
    from sentinel_tpu_torch.engine import pipeline as pl

    dev = torch.device(dev)
    spec, rules, batches, rt_ms, errors, init, grades = _scalar_fixture(
        dev, R, B, param=True)
    flags = dict(skip_auth=True, skip_sys=True, scalar_has_rl=False,
                 skip_threads=False, scalar_flow=True, record_alt=False)
    times = _times_at(spec, 2)

    def run(state, n_steps, sortfree=True, strict=False, counts=None):
        verdicts, step_s = [], []
        prev = batches[0]._replace(valid=torch.zeros(B, dtype=torch.bool,
                                                     device=dev))
        for i in range(n_steps):
            b = batches[i % 4]
            xb = pl.ExitBatch(
                rows=prev.rows, origin_rows=prev.origin_rows,
                chain_rows=prev.chain_rows, acquire=prev.acquire,
                rt_ms=rt_ms[i % 4], error=errors[i % 4], is_in=prev.is_in,
                valid=prev.valid, param_rules=prev.param_rules,
                param_keys=prev.param_keys)
            sync()
            t = time.perf_counter()
            with no_host_sync(strict and dev.type == "cuda"):
                state, v = pl.decide_and_record_exits(
                    spec, rules, state, b, xb, times(i), (0.5, 0.1),
                    sortfree=sortfree, **flags)
            sync()
            step_s.append(time.perf_counter() - t)
            verdicts.append(v)
            if counts is not None:
                counts.append(_grade_counts(grades, b, v))
            prev = b._replace(valid=v.allow & b.valid)
        return state, verdicts, step_s

    run(_clone_state(init), 2)                       # warm-up
    sa.LAUNCHES.clear()
    s_kernel, v_kernel, step_s = run(_clone_state(init), steps, strict=True)
    launches = sa.LAUNCHES["scatter_add"]
    # per fused step: the decide record, the main gauge +1, the param
    # token consumption, the param THREAD +1; the exit payload, rt_sum,
    # rt_hist, the breakers' two counts, the main gauge -1, param THREAD -1
    if launches != 11 * steps:
        fail(f"param engine phase: {launches} kernel launches in {steps} "
             f"steps, want 11 per step")
    real = sa.scatter_add
    sa.scatter_add = sa.scatter_add_reference     # the plain seam
    try:
        sa.LAUNCHES.clear()
        s_plain, v_plain, _ = run(_clone_state(init), steps)
        if sa.LAUNCHES["scatter_add"]:
            fail("param engine phase: the plain run launched the kernel")
    finally:
        sa.scatter_add = real
    counts = []
    s_sorted, v_sorted, _ = run(_clone_state(init), steps, sortfree=False,
                                strict=True, counts=counts)
    for i, (a, b, c) in enumerate(zip(v_kernel, v_plain, v_sorted)):
        for f in ("allow", "reason", "wait_ms"):
            if not (torch.equal(getattr(a, f), getattr(b, f))
                    and torch.equal(getattr(a, f), getattr(c, f))):
                fail(f"param engine phase: verdict {f} differs at step {i}")
    for other, what in ((s_plain, "plain seam"), (s_sorted, "sort-free off")):
        bad = _state_equal(s_kernel, other, convert)
        if bad:
            fail(f"param engine phase: state differs from the {what} run: "
                 f"{bad}")
    per_grade = _check_grades("param engine phase", counts)
    med = float(np.median(step_s[1:]))
    out = {"route": "scalar_param", "R": R, "B": B, "steps": steps,
           "param_keys": PARAM_KEYS, "param_rules": 2 * PARAM_RESOURCES,
           "launches": launches, "launches_per_step": launches / steps,
           "step_ms_median": med * 1e3,
           "step_ms_all": [x * 1e3 for x in step_s],
           "grade_admitted_denied_per_step": per_grade,
           "decisions_per_s": B / med}
    log(f"[scalar_param] R={R} B={B} steps={steps}, 512 param rules on "
        f"{PARAM_RESOURCES} resources, PK={PARAM_KEYS}: verdicts and state "
        f"equal (kernel, plain seam, sort-free off); step median "
        f"{med * 1e3:.3f} ms ({B / med:.0f} decisions/s); kernel launches "
        f"{launches} ({launches / steps:.1f}/step); every grade admitted "
        f"and denied in every step (step 0 [admitted, denied] by grade: "
        f"{per_grade[0]})")
    if profile:
        out["profile"] = prof = _profile_steps(
            lambda: run(_clone_state(init), steps), steps,
            "engine_scalar_param_trace.json")
        log(f"[scalar_param] device time {prof['device_ms_per_step']:.3f} "
            f"ms per step")
    return out


ORIGINS, CONTEXTS = 64, 8


def _alt_rows_np(rows, kind, key_ids, ra):
    """The runtime's alt-row hash (``runtime._alt_hash``), vectorized."""
    h = ((rows.astype(np.uint64) * np.uint64(0x9E3779B1))
         ^ ((key_ids.astype(np.uint64) * 2 + kind)
            * np.uint64(0x85EBCA6B))) & np.uint64(0xFFFFFFFF)
    return (h % np.uint64(ra)).astype(np.int32)


def _origin_rules(flow_mod, n_rules, thread_grade: bool = False):
    """``n_rules`` flow rules, two on each of ``n_rules // 2`` resources:
    a default-app rule (DIRECT, or RELATE to the previous resource; 1/8
    warm-up, 1/8 rate limiter; with ``thread_grade``, 1/8 a THREAD-grade
    limit of 24 concurrent calls instead) and one of a specific origin,
    ``other`` or CHAIN."""
    rules = []
    for i in range(n_rules // 2):
        res = f"r{i}"
        behavior = (flow_mod.BEHAVIOR_WARM_UP if i % 8 == 3 else
                    flow_mod.BEHAVIOR_RATE_LIMITER if i % 8 == 5 else
                    flow_mod.BEHAVIOR_DEFAULT)
        if i % 4 == 1 and i:
            rules.append(flow_mod.FlowRule(
                resource=res, count=80.0, strategy=flow_mod.STRATEGY_RELATE,
                ref_resource=f"r{i - 1}"))
        elif thread_grade and i % 8 == 7:
            rules.append(flow_mod.FlowRule(resource=res, count=24.0,
                                           grade=flow_mod.GRADE_THREAD))
        else:
            rules.append(flow_mod.FlowRule(resource=res, count=50.0,
                                           control_behavior=behavior))
        if i % 3 == 0:
            rules.append(flow_mod.FlowRule(resource=res, count=8.0,
                                           limit_app=f"app-{i % ORIGINS}"))
        elif i % 3 == 1:
            rules.append(flow_mod.FlowRule(resource=res, count=20.0,
                                           limit_app="other"))
        else:
            rules.append(flow_mod.FlowRule(
                resource=res, count=6.0, strategy=flow_mod.STRATEGY_CHAIN,
                ref_resource=f"ctx-{i % CONTEXTS}"))
    return rules


def phase_origin_engine(stt, sa, route: str, dev="cuda", R=1 << 20,
                        B=1 << 19, steps: int = 8, profile: bool = False,
                        prio: float = 0.0, step_ms: int = 2,
                        param: bool = False) -> dict:
    """The fast or general route at full width: fused decide+exit steps
    run twice from one state (the kernel, then the plain seam) and once
    more without sort-free grouping; verdicts, ``sf_overflow`` and state
    must agree, and the kernel must be launched the derived number of
    times per step. The general route's rules include THREAD-grade limits,
    so its steps keep the thread gauges (main and alt) as the runtime
    does when such a rule is loaded; the fast route's elide them. With
    ``prio`` that share of the events is prioritized and the steps are
    the occupy-aware ones (one more launch a step: the grants), ``step_ms``
    of virtual time apart. With ``param`` the 512 param rules of
    :func:`_with_param` ride on 256 of the ruled resources (the sorted
    param check on the general route, the rank form on the fast one; two
    more launches a step, the param THREAD update on entry and exit, and
    on the fast route the token consumption), and every grade must admit
    and deny in every step."""
    from sentinel_tpu_torch import convert
    from sentinel_tpu_torch.core.registry import (
        OriginRegistry, Registry, ResourceRegistry,
    )
    from sentinel_tpu_torch.engine import pipeline as pl
    from sentinel_tpu_torch.ops import segments as seg
    from sentinel_tpu_torch.rules import authority as auth_mod
    from sentinel_tpu_torch.rules import degrade as deg_mod
    from sentinel_tpu_torch.rules import flow as flow_mod
    from sentinel_tpu_torch.rules import system as sys_mod
    from sentinel_tpu_torch.stats.window import WindowSpec

    dev = torch.device(dev)
    NRULES, NBRK = 4096, 1024
    RA = 2 * R                                 # the runtime's alt rows
    spec = pl.EngineSpec(rows=R, alt_rows=RA,
                         second=WindowSpec(buckets=2, win_ms=500),
                         minute=None, statistic_max_rt=5000,
                         hist_buckets=32)
    resources = ResourceRegistry(R)
    origins = OriginRegistry(ORIGINS + 1)
    contexts = Registry(CONTEXTS + 1,
                        reserved=("sentinel_default_context",))
    flow = flow_mod.compile_flow_rules(
        _origin_rules(flow_mod, NRULES, thread_grade=route == "general"),
        resource_registry=resources,
        context_registry=contexts, capacity=NRULES, k_per_resource=2,
        num_rows=R, origin_registry=origins, device=dev)
    key_fits = (NRULES + 1) * (RA + 1) < 2 ** 31
    if key_fits != (route == "fast"):
        fail(f"{route} engine phase: R={R} gives key_fits={key_fits}")
    deg = deg_mod.compile_degrade_rules(
        [deg_mod.DegradeRule(resource=f"r{i}",
                             grade=deg_mod.GRADE_EXCEPTION_RATIO,
                             count=0.5, time_window=10)
         for i in range(NBRK)],
        resource_registry=resources, capacity=NBRK, k_per_resource=2,
        num_rows=R, device=dev)
    auth = auth_mod.compile_authority_rules(
        [], resource_registry=resources, origin_registry=origins,
        capacity=16, k_per_resource=2, num_rows=R, device=dev)
    rules = pl.RuleSet(
        flow_table=flow.table, flow_idx=flow.rule_idx[:, :flow.k_used],
        deg_table=deg.table, deg_idx=deg.rule_idx[:, :deg.k_used],
        auth_table=auth.table, auth_idx=auth.rule_idx,
        sys_thresholds=sys_mod.compile_system_rules([], device=dev),
    ).with_joint()
    ruled = np.array([resources.lookup(f"r{i}") for i in range(NRULES // 2)],
                     np.int32)
    origin_ids = np.array([origins.lookup(f"app-{i}") for i in
                           range(ORIGINS)], np.int32)
    ctx_ids = np.array([contexts.lookup(f"ctx-{i}") for i in
                        range(CONTEXTS)], np.int32)
    has_rl = any(r.control_behavior == flow_mod.BEHAVIOR_RATE_LIMITER
                 for r in flow.rules)
    # the runtime's rule: the gauges are kept when anything reads them
    # (a THREAD-grade param rule among them)
    skip_threads = not param and not any(r.grade == flow_mod.GRADE_THREAD
                                         for r in flow.rules)
    flags = dict(skip_auth=True, skip_sys=True, scalar_has_rl=has_rl,
                 skip_threads=skip_threads, record_alt=True,
                 fast_flow=route == "fast", enable_occupy=prio > 0)
    tag = route + ("_occupy" if prio else "") + ("_param" if param else "")

    rng = np.random.default_rng(43)
    batches, any_prio = [], []
    for _ in range(4):
        rows = np.where(rng.random(B) < 0.25,
                        ruled[rng.integers(0, ruled.shape[0], B)],
                        rng.integers(1, R, B)).astype(np.int32)
        oid = np.where(rng.random(B) < 0.5,
                       origin_ids[rng.integers(0, ORIGINS, B)], 0)
        cid = np.where(rng.random(B) < 0.125,
                       ctx_ids[rng.integers(0, CONTEXTS, B)], 0)
        orow = np.where(oid > 0, _alt_rows_np(rows, 0, oid, RA), RA)
        crow = np.where(cid > 0, _alt_rows_np(rows, 1, cid, RA), RA)
        acq = (np.ones(B, np.int32) if route == "fast"
               else rng.integers(1, 3, B).astype(np.int32))
        cols = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                for a in (rows, oid, orow, cid, crow, acq)]
        # its own generator: the rest of the fixture is the same for
        # every share
        pr = np.random.default_rng(45 + len(batches)).random(B) < prio
        any_prio.append(bool(pr.any()))
        batches.append(pl.EntryBatch(
            *cols, is_in=torch.ones(B, dtype=torch.bool, device=dev),
            prioritized=torch.from_numpy(pr).to(dev),
            valid=torch.ones(B, dtype=torch.bool, device=dev)))
    rt_ms = [torch.from_numpy(rng.integers(0, 200, B).astype(np.int32)).to(
        dev) for _ in range(4)]
    errors = [torch.from_numpy(rng.random(B) < 0.3).to(dev) for _ in range(4)]
    grades = None
    if param:
        spec, rules, batches, grades = _with_param(
            dev, spec, rules, resources, batches,
            [f"r{i}" for i in range(PARAM_RESOURCES)], 47)
    times = _times_at(spec, step_ms)
    init = pl.init_state(spec, NRULES, NBRK, device=dev)

    def run(state, n_steps, sortfree=True, strict=False, track=None,
            counts=None):
        out, step_s = [], []
        prev = batches[0]._replace(valid=torch.zeros(B, dtype=torch.bool,
                                                     device=dev))
        for i in range(n_steps):
            b = batches[i % 4]
            xb = pl.ExitBatch(
                rows=prev.rows, origin_rows=prev.origin_rows,
                chain_rows=prev.chain_rows, acquire=prev.acquire,
                rt_ms=rt_ms[i % 4], error=errors[i % 4],
                is_in=prev.is_in, valid=prev.valid,
                param_rules=prev.param_rules, param_keys=prev.param_keys)
            nxt = times(i)[0] + 1
            if track is not None:
                before = _booked_for(state, nxt)
            sync()
            t = time.perf_counter()
            with no_host_sync(strict and dev.type == "cuda"):
                state, v = pl.decide_and_record_exits(
                    spec, rules, state, b, xb, times(i), (0.5, 0.1),
                    sortfree=sortfree, any_prio=any_prio[i % 4], **flags)
            sync()
            step_s.append(time.perf_counter() - t)
            if track is not None:
                track.append(_booked_for(state, nxt) - before)
            if counts is not None:
                counts.append(_grade_counts(grades, b, v))
            out.append(v)
            prev = b._replace(valid=v.allow.clone())
        return state, out, step_s

    run(_clone_state(init), 2)                     # warm-up
    sa.LAUNCHES.clear()
    s_kernel, v_kernel, step_s = run(_clone_state(init), steps, strict=True)
    launches = sa.LAUNCHES["scatter_add"]
    # per fused step: the decide record, its alt half, (general) the
    # counting order's bucket histogram; the exit payload, rt_sum and
    # rt_hist, the alt payload and alt rt_sum; the breakers' two counts;
    # with the thread gauges, +1 and -1 on the main and the alt gauges
    # with param rules: the param THREAD update on entry and exit, and on
    # the fast route (the rank form) the token consumption
    per_step = (9 + (route == "general") + 4 * (not skip_threads)
                + (prio > 0) + param * (2 + (route == "fast")))
    if launches != per_step * steps:
        fail(f"{tag} engine phase: {launches} kernel launches in {steps} "
             f"steps, want {per_step} per step")
    real = sa.scatter_add
    sa.scatter_add = sa.scatter_add_reference     # the plain seam
    try:
        sa.LAUNCHES.clear()
        s_plain, v_plain, _ = run(_clone_state(init), steps)
        if sa.LAUNCHES["scatter_add"]:
            fail(f"{tag} engine phase: the plain run launched the kernel")
    finally:
        sa.scatter_add = real
    booked, counts = [], []
    s_sorted, v_sorted, sorted_s = run(_clone_state(init), steps,
                                       sortfree=False, strict=True,
                                       track=booked,
                                       counts=counts if param else None)
    occupied = int(sum(booked))
    overflow = 0
    for i, (a, b, c) in enumerate(zip(v_kernel, v_plain, v_sorted)):
        for f in ("allow", "reason", "wait_ms"):
            if not (torch.equal(getattr(a, f), getattr(b, f))
                    and torch.equal(getattr(a, f), getattr(c, f))):
                fail(f"{tag} engine phase: verdict {f} differs at step {i}")
        if int(a.sf_overflow) != int(b.sf_overflow):
            fail(f"{tag} engine phase: sf_overflow differs at step {i}")
        overflow += int(a.sf_overflow)
    want = convert.to_numpy(s_kernel)
    for other, what in ((s_plain, "plain seam"),
                        (s_sorted, "sorted order")):
        bad = convert.leaf_diff(want, convert.to_numpy(other))
        if bad:
            fail(f"{tag} engine phase: state differs from the {what} "
                 f"run: {bad}")
    if prio and occupied == 0:
        fail(f"{tag} engine phase: no occupied admission")
    per_grade = _check_grades(f"{tag} engine phase", counts) if param \
        else None
    allowed = int(sum(int(v.allow.sum()) for v in v_kernel))

    # what computing both orders costs (the reference's lax.cond computes
    # one): the sorted fallback alone, at this step's pair shape
    k = flow.k_used
    on = torch.rand((B, k), device=dev) < 0.3
    if route == "fast":
        sentinel = NRULES * (RA + 1)
        key = torch.full((B, k), sentinel, dtype=torch.int32, device=dev)
        key[on] = torch.randint(0, sentinel, (int(on.sum()),),
                                dtype=torch.int32, device=dev)
        fallback = lambda: seg.ranks_per_slot(key)      # noqa: E731
    else:
        rule = torch.where(on, torch.randint(
            0, NRULES, (B, k), dtype=torch.int32, device=dev),
            NRULES).reshape(-1)
        row = torch.where(on, torch.randint(
            0, R + RA, (B, k), dtype=torch.int32, device=dev),
            0).reshape(-1)
        fallback = lambda: seg.sort_by_keys(rule, row)  # noqa: E731
    fallback_ms = summary(CudaTimer().warm({"fallback": fallback},
                                           rounds=3, iters=5)["fallback"]
                          ) if dev.type == "cuda" and not (prio or param) \
        else None
    med = float(np.median(step_s[1:]))
    med_sorted = float(np.median(sorted_s[1:]))
    out = {"route": tag, "R": R, "RA": RA, "B": B, "steps": steps,
           "prioritized_share": prio, "occupied": occupied,
           "k_used": flow.k_used, "thread_gauges": not skip_threads,
           "launches": launches,
           "launches_per_step": launches / steps,
           "step_ms_median": med * 1e3,
           "step_ms_all": [x * 1e3 for x in step_s],
           "sorted_step_ms_median": med_sorted * 1e3,
           "decisions_per_s": B / med, "allowed": allowed,
           "sf_overflow": overflow, "fallback_ms": fallback_ms,
           "grade_admitted_denied_per_step": per_grade}
    log(f"[{tag}] R={R} RA={RA} B={B} K={flow.k_used} steps={steps} "
        f"prioritized {prio}, booked units {occupied}; "
        f"thread gauges {'on' if not skip_threads else 'off'}: "
        f"verdicts, sf_overflow and state equal (kernel, plain seam, sorted "
        f"order); step median {med * 1e3:.3f} ms ({B / med:.0f} "
        f"decisions/s), sorted-order run {med_sorted * 1e3:.3f} ms; kernel "
        f"launches {launches} ({launches / steps:.1f}/step); allowed "
        f"{allowed}; claim overflow {overflow}")
    if fallback_ms is not None:
        log(f"[{tag}]   the sorted fallback computed every step: "
            f"{fallback_ms['median']:.4f} ms warm (median)")
    if profile:
        out["profile"] = prof = _profile_steps(
            lambda: run(_clone_state(init), steps), steps,
            f"engine_{tag}_trace.json")
        # the same steps in the sorted order alone: what sort-free
        # grouping (claim cascade, counting order and the sorted fallback
        # computed beside it) costs the step as a whole
        out["profile_sorted"] = prof_s = _profile_steps(
            lambda: run(_clone_state(init), steps, sortfree=False), steps,
            f"engine_{tag}_sorted_trace.json", keep_trace=False)
        log(f"[{tag}] device time {prof['device_ms_per_step']:.3f} ms per "
            f"step; sorted order alone {prof_s['device_ms_per_step']:.3f} "
            f"ms per step")
    return out


def _profile_steps(run_steps, steps: int,
                   trace_name: str = "engine_trace.json",
                   keep_trace: bool = True) -> dict:
    """Device time by operator over one run of engine steps, and device
    busy time per step from the trace (``torch.profiler``; ``--profile``
    only). ``keep_trace=False`` deletes the trace once read."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_steps()
        sync()
    os.makedirs("chiprun_out", exist_ok=True)
    trace = os.path.join("chiprun_out", trace_name)
    prof.export_chrome_trace(trace)
    with open(trace) as fh:
        events = json.load(fh)
    events = events.get("traceEvents", events) if isinstance(events, dict) \
        else events
    busy_us = sum(float(e.get("dur", 0.0)) for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not keep_trace:
        os.remove(trace)
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0.0)
        rows.append({"name": e.key, "count": e.count,
                     "device_us": float(dev_us),
                     "cpu_us": float(e.cpu_time_total)})
    rows.sort(key=lambda r: -r["device_us"])
    log("[profile] top operators by device time (us, whole run):")
    for r in rows[:30]:
        log(f"[profile]   {r['device_us']:12.1f} dev  {r['cpu_us']:12.1f} "
            f"cpu  x{r['count']:<5d} {r['name'][:90]}")
    ours = [r for r in rows if "scatter_add_" in r["name"]]
    for r in ours:
        log(f"[profile]   scatter-add kernel {r['device_us'] / steps:8.1f} us "
            f"per step  x{r['count']:<4d} {r['name'][:90]}")
    return {"top": rows[:60], "scatter_add_kernels": ours,
            "index_add": [r for r in rows if "index_add" in r["name"]],
            "device_ms_per_step": busy_us / 1e3 / steps}


# ---------------------------------------------------------------------------
# Phase 4: the runtime, through the user entry points
# ---------------------------------------------------------------------------

def _drive_runtime(stt, sph, clock, hello_n: int = 25) -> dict:
    sph.load_flow_rules(
        [stt.FlowRule(resource="HelloWorld", count=20)]
        + [stt.FlowRule(resource=f"r{i}", count=50.0) for i in range(4096)])
    sph.load_degrade_rules(
        [stt.DegradeRule(resource=f"r{i}", grade=stt.GRADE_EXCEPTION_RATIO,
                         count=0.5, time_window=10) for i in range(1024)])
    passes = blocks = 0
    for _ in range(hello_n):
        try:
            with sph.entry("HelloWorld"):
                passes += 1
        except stt.FlowException:
            blocks += 1
    rng = np.random.default_rng(3)
    names = [f"r{i}" for i in rng.integers(0, 8192, 4096)]
    v = sph.entry_batch(names)
    clock.advance_ms(7)
    done = sph.intern_resources(names)[v.allow]
    m = done.shape[0]
    ra = sph.spec.alt_rows
    sph.exit_batch(rows=done, origin_rows=np.full(m, ra, np.int32),
                   chain_rows=np.full(m, ra, np.int32),
                   acquire=np.ones(m, np.int32),
                   rt_ms=rng.integers(0, 50, m).astype(np.int32),
                   error=rng.random(m) < 0.2, is_in=np.ones(m, np.bool_))
    return {"passes": passes, "blocks": blocks,
            "batch_allow": v.allow.tolist(), "batch_reason": v.reason.tolist(),
            "hello": sph.node_totals("HelloWorld"),
            "first": sph.node_totals(names[0])}


def _drive_origins(stt, sph, clock) -> dict:
    """Origin- and context-bearing calls: ``entry(origin=...)`` inside a
    call context, ``entry_batch(origins=, contexts=)`` with uniform and
    with mixed acquire, and a mixed batch that splits."""
    from sentinel_tpu_torch.core.context import ContextScope
    from sentinel_tpu_torch.rules import flow as flow_mod
    sph.load_flow_rules(_origin_rules(flow_mod, 512))
    rng = np.random.default_rng(5)
    outcomes = []
    for i in range(24):
        with ContextScope(f"ctx-{i % 3}" if i % 3 else "",
                          origin=f"app-{i % 4}" if i % 4 else ""):
            try:
                with sph.entry(f"r{i % 6}"):
                    clock.advance_ms(1)
                outcomes.append("pass")
            except stt.BlockException as exc:
                outcomes.append(type(exc).__name__)
    n = 2048
    names = [f"r{i}" for i in rng.integers(0, 300, n)]
    origins = [f"app-{i}" if i < ORIGINS else ""
               for i in rng.integers(0, 2 * ORIGINS, n)]
    contexts = [f"ctx-{i}" if i < CONTEXTS else ""
                for i in rng.integers(0, 8 * CONTEXTS, n)]
    v_fast = sph.entry_batch(names, origins=origins, contexts=contexts)
    v_gen = sph.entry_batch(names, origins=origins, contexts=contexts,
                            acquire=rng.integers(1, 3, n).tolist())
    m = 6000
    mixed = [f"r{i}" for i in rng.integers(0, 300, m)]
    mixed_origins = [""] * m
    for i in rng.integers(0, m, 100):
        mixed_origins[i] = f"app-{i % ORIGINS}"
    v_split = sph.entry_batch(mixed, origins=mixed_origins)
    return {"entries": outcomes, "fast_allow": v_fast.allow.tolist(),
            "general_allow": v_gen.allow.tolist(),
            "general_reason": v_gen.reason.tolist(),
            "split_allow": v_split.allow.tolist(),
            "routes": dict(sph.routes)}


def phase_runtime(stt, sa, dev="cuda", R=1 << 20, B=1 << 19,
                  full_steps: int = 4) -> dict:
    cfg_kw = dict(max_resources=R, minute_enabled=True,
                  host_fast_path=False, max_flow_rules=8192,
                  max_degrade_rules=2048)
    t0 = 1_800_000_000_000
    clock = stt.ManualClock(start_ms=t0)
    sph = stt.Sentinel(config=stt.load_config(**cfg_kw), clock=clock,
                       device=dev)
    sa.LAUNCHES.clear()
    got = _drive_runtime(stt, sph, clock)
    # full-width serving steps through the fused raw entry point
    rng = np.random.default_rng(11)
    names = [f"r{i}" for i in range(4096)] + [f"u{i}" for i in range(60000)]
    pool = sph.intern_resources(names)
    ra = sph.spec.alt_rows
    # every dispatch below is checked for waits on the device
    prev = np.empty(0, np.int32)
    step_s, origin_step_s = [], []
    allowed = 0
    for _ in range(full_steps):
        rows = pool[rng.integers(0, len(pool), B)]
        clock.advance_ms(2)
        t = time.perf_counter()
        with no_host_sync(dev == "cuda"):
            h = sph.decide_and_exit_raw_nowait(
                rows, np.zeros(B, np.int32), np.full(B, ra, np.int32),
                np.zeros(B, np.int32), np.full(B, ra, np.int32),
                np.ones(B, np.int32), np.ones(B, np.bool_),
                np.zeros(B, np.bool_), exit_rows=prev,
                exit_rt_ms=rng.integers(0, 100, prev.shape[0]).astype(
                    np.int32),
                exit_error=rng.random(prev.shape[0]) < 0.1)
        v = h.result()
        step_s.append(time.perf_counter() - t)
        allowed += int(v.allow.sum())
        prev = rows[v.allow]
    # origin-bearing full-width steps (alt rows hashed as the runtime
    # hashes them): at R = 2^20 the fast path's key does not fit, so they
    # take the general route. A system rule and an authority rule that
    # block nothing here make them run the system and authority slots and
    # keep the thread gauges, main and alt, too
    sph.load_system_rules([stt.SystemRule(qps=1e12)])
    sph.load_authority_rules([stt.AuthorityRule(resource="u0",
                                                limit_app="app-1")])
    if sph._skip_threads:
        fail("runtime phase: a system rule did not turn the gauges on")
    origin_route = "fast" if sph._key_fits() else "general"
    routes_before = dict(sph.routes)
    for _ in range(2):
        rows = pool[rng.integers(0, len(pool), B)]
        oid = np.where(rng.random(B) < 0.5,
                       rng.integers(1, ORIGINS + 1, B), 0).astype(np.int32)
        orow = np.where(oid > 0, _alt_rows_np(rows, 0, oid, ra), ra)
        clock.advance_ms(2)
        t = time.perf_counter()
        with no_host_sync(dev == "cuda"):
            h = sph.decide_and_exit_raw_nowait(
                rows, oid, orow.astype(np.int32), np.zeros(B, np.int32),
                np.full(B, ra, np.int32), np.ones(B, np.int32),
                np.ones(B, np.bool_), np.zeros(B, np.bool_),
                exit_rows=prev,
                exit_rt_ms=rng.integers(0, 100, prev.shape[0]).astype(
                    np.int32))
        v = h.result()
        origin_step_s.append(time.perf_counter() - t)
        prev = rows[v.allow]
    if sph.routes["fused"] != routes_before.get("fused", 0) + 2:
        fail("runtime phase: the origin steps did not take the fused path")
    launches = sa.LAUNCHES["scatter_add"]
    if launches == 0:
        fail("runtime phase: the scatter-add kernel was never launched")
    if (got["passes"], got["blocks"]) != (20, 5):
        fail(f"runtime phase: HelloWorld gave {got['passes']} passes and "
             f"{got['blocks']} FlowExceptions, want 20 and 5")

    # the same entry / entry_batch / exit stream on a CPU twin
    twin_clock = stt.ManualClock(start_ms=t0)
    twin = stt.Sentinel(config=stt.load_config(
        **{**cfg_kw, "max_resources": 1 << 14}), clock=twin_clock,
        device="cpu")
    want = _drive_runtime(stt, twin, twin_clock)
    for key in ("passes", "blocks", "batch_allow", "batch_reason", "hello",
                "first"):
        if got[key] != want[key]:
            fail(f"runtime phase: {key} differs from the CPU twin: "
                 f"{got[key]} vs {want[key]}")
    # origins and contexts, on a pair of one geometry (the alt hash and
    # the route depend on it): the card's engine and a CPU twin
    o_cfg = dict(cfg_kw, max_resources=1 << 14)
    o_got, o_want = [
        _drive_origins(stt, stt.Sentinel(config=stt.load_config(**o_cfg),
                                         clock=c, device=d), c)
        for d, c in ((dev, stt.ManualClock(start_ms=t0)),
                     ("cpu", stt.ManualClock(start_ms=t0)))]
    for key in o_want:
        if o_got[key] != o_want[key]:
            fail(f"runtime phase: origin drive {key} differs from the CPU "
                 f"twin: {o_got[key]} vs {o_want[key]}")
    if set(o_got["routes"]) != {"scalar", "fast", "general", "split"}:
        fail(f"runtime phase: origin drive routes {o_got['routes']}, want "
             f"scalar, fast, general and split")
    launches = sa.LAUNCHES["scatter_add"]
    med = float(np.median(step_s[1:]))
    log(f"[runtime] Sentinel(device={dev!r}) R={R}: HelloWorld 20 passes + "
        f"5 FlowExceptions; entry_batch(4096) and exit_batch agree with a "
        f"CPU twin; fused raw steps B={B}: median {med * 1e3:.2f} ms "
        f"({B / med:.0f} decisions/s end to end), allowed {allowed}; "
        f"origin-bearing fused steps ({origin_route} route) "
        f"{', '.join(f'{x * 1e3:.2f}' for x in origin_step_s)} ms; "
        f"entry(origin=...), entry_batch(origins=, contexts=) and a split "
        f"batch agree with a CPU twin (routes {o_got['routes']}); kernel "
        f"launches {launches}")
    return {"launches": launches, "hello": got["hello"],
            "full_step_ms": [s * 1e3 for s in step_s],
            "full_step_ms_median": med * 1e3,
            "origin_step_ms": [s * 1e3 for s in origin_step_s],
            "origin_routes": o_got["routes"],
            "decisions_per_s": B / med}


def _drive_fast_path(stt, sph, clock, free_calls: int = 4096,
                     leased_calls: int = 2048) -> tuple:
    """The default configuration's per-call tier (host fast path on)
    through ``entry``/``exit``, ``entry(prioritized=True)``,
    ``entry_batch`` and a rule reload → (observations to compare with a
    twin, host timings). FREE resources for several flushes of 1024
    events; LEASED resources through renewals, a denied chunk (hot) and
    lease expiry (its unused tokens return through ``uncount_reserved``);
    a prioritized call on a full window, which waits into the next; an
    8192-event batch with ~1% prioritized events, which splits; a reload
    with a landed and a pending booking."""
    sph._cpu.sample = lambda: (0.5, 0.25)
    flushes, expired = [0], [0]
    drain = sph._fast.drain

    def counting_drain(now_ms):
        got = drain(now_ms)
        flushes[0] += any(got)
        expired[0] += len(got[2])
        return got
    sph._fast.drain = counting_drain
    rules = ([stt.FlowRule(resource=f"lease-{i}", count=1000.0)
              for i in range(8)]
             + [stt.FlowRule(resource="hot", count=40.0),
                stt.FlowRule(resource="svc", count=2.0)]
             + [stt.FlowRule(resource=f"r{i}", count=150.0)
                for i in range(64)])
    sph.load_flow_rules(rules)
    obs, timing = {}, {}

    def modes(run):
        out = collections.Counter()
        for e in run:
            out[e] += 1
        return dict(out)

    # FREE: entry/exit pairs on 64 rule-free resources
    got, f0 = [], flushes[0]
    t = time.perf_counter()
    for i in range(free_calls):
        with sph.entry(f"free-{i % 64}") as e:
            got.append(e.fast)
        if i % 16 == 15:
            clock.advance_ms(1)
    timing["free_us_per_call"] = (time.perf_counter() - t) / free_calls * 1e6
    timing["free_flushes_per_1k"] = (flushes[0] - f0) / free_calls * 1e3
    obs["free_modes"] = modes(got)
    # LEASED: 8 resources of count 1000 (chunks of 250)
    got, f0 = [], flushes[0]
    t = time.perf_counter()
    for i in range(leased_calls):
        try:
            with sph.entry(f"lease-{i % 8}") as e:
                got.append(e.fast)
        except stt.BlockException:
            got.append("blocked")
        if i % 64 == 63:
            clock.advance_ms(1)
    timing["leased_us_per_call"] = (time.perf_counter() - t) \
        / leased_calls * 1e6
    timing["leased_flushes_per_1k"] = (flushes[0] - f0) / leased_calls * 1e3
    obs["leased_modes"] = modes(got)
    obs["renewals"] = sph._fast.lease_renewals
    # a denied chunk: the batch tier spends 35 of 40, the next renewal
    # (chunk 10) is denied and the row turns hot
    v = sph.entry_batch(["hot"] * 35)
    got = []
    for _ in range(8):
        try:
            with sph.entry("hot") as e:
                got.append(e.fast)
        except stt.BlockException:
            got.append("blocked")
    obs["hot"] = [int(v.allow.sum()), got,
                  sph._fast.is_hot(sph.resources.lookup("hot"),
                                   clock.now_ms())]
    # expiry: the bucket rotates, the next call retires the leases
    clock.advance_ms(600)
    with sph.entry("lease-0") as e:
        obs["after_expiry"] = e.fast
    sph._flush_fast()
    obs["expired_leases"] = expired[0]
    # a prioritized call on a full window waits into the next one
    for _ in range(2):
        with sph.entry("svc"):
            pass
    clock.advance_ms(500 - clock.now_ms() % 500 + 100)
    t0 = clock.now_ms()
    with sph.entry("svc", prioritized=True) as e:
        obs["prio_wait"] = clock.now_ms() - t0
    # ~1% prioritized in an 8192-event batch: the split
    rng = np.random.default_rng(12)
    names = [f"r{i}" for i in rng.integers(0, 64, 8192)]
    prio = rng.random(8192) < 0.01
    routes0 = dict(sph.routes)
    v = sph.entry_batch(names, prioritized=prio)
    obs["split"] = [v.allow.tolist(), v.wait_ms.tolist(),
                    sph.routes["split"] - routes0.get("split", 0)]
    # a landed booking (the prioritized call above) and a pending one
    v = sph.entry_batch(["svc"] * 3, prioritized=[True] * 3)
    obs["pending"] = [v.allow.tolist(), v.wait_ms.tolist()]
    sph.load_flow_rules(rules)                    # settle + carry
    obs["carried"] = float(sph._state.flow_dyn.occupied_count.sum())
    clock.advance_ms(500)
    got = []
    for _ in range(3):
        try:
            with sph.entry("svc") as e:
                got.append(e.fast)
        except stt.BlockException:
            got.append("blocked")
    obs["after_reload"] = got
    obs["totals"] = {name: sph.node_totals(name) for name in (
        "free-0", "lease-0", "hot", "svc", "r0", "__entry_node__")}
    obs["routes"] = dict(sph.routes)
    obs["flushes"] = flushes[0]
    return obs, timing


def phase_fast_path_runtime(stt, sa, dev="cuda", R=1 << 20) -> dict:
    """The default configuration (host fast path on) at 1M resources on
    the card, against a CPU twin of the same geometry under a twin
    ManualClock: the observations of :func:`_drive_fast_path`, the routes
    and the whole engine state must be equal. One flush of buffered
    events is also run with the sync debug mode at "error"."""
    from sentinel_tpu_torch import convert
    t0 = 1_800_000_000_000
    # the default configuration at R rows, with a flow-rule capacity under
    # which the fast path's key fits ((NF+1)·(2R+1) < 2^31), so that a
    # batch mixing kinds splits as the runtime splits it
    cfg = stt.load_config(max_resources=R,
                          max_flow_rules=(2 ** 31 - 1) // (2 * R + 1) - 1)
    if not cfg.host_fast_path:
        fail("fast-path runtime phase: the default config has the host "
             "fast path off")
    engines, got = {}, {}
    for d in (dev, "cpu"):
        clock = stt.ManualClock(start_ms=t0)
        sph = stt.Sentinel(config=cfg, clock=clock, device=d)
        if d == dev:
            sa.LAUNCHES.clear()
        got[d] = _drive_fast_path(stt, sph, clock)
        if d == dev:
            launches = sa.LAUNCHES["scatter_add"]
            # a flush of buffered FREE events reads nothing back
            for i in range(8):
                sph.entry(f"free-{i}").exit()
            with no_host_sync(dev == "cuda"):
                sph._flush_fast()
            sync()
        else:
            for i in range(8):
                sph.entry(f"free-{i}").exit()
            sph._flush_fast()
        engines[d] = sph
    (obs, timing), (want, _) = got[dev], got["cpu"]
    for key in want:
        if obs[key] != want[key]:
            fail(f"fast-path runtime phase: {key} differs from the CPU twin: "
                 f"{str(obs[key])[:300]} vs {str(want[key])[:300]}")
    bad = _state_equal(engines[dev]._state, engines["cpu"]._state, convert)
    if bad:
        fail(f"fast-path runtime phase: state differs from the CPU twin: "
             f"{bad}")
    if launches == 0:
        fail("fast-path runtime phase: the kernel was never launched")
    if obs["free_modes"] != {"free": 4096}:
        fail(f"fast-path runtime phase: FREE modes {obs['free_modes']}")
    if obs["prio_wait"] <= 0 or not obs["hot"][2] or obs["carried"] <= 0:
        fail(f"fast-path runtime phase: prio wait {obs['prio_wait']}, hot "
             f"{obs['hot'][2]}, carried {obs['carried']}")
    if obs["split"][2] != 1 or obs["expired_leases"] == 0:
        fail(f"fast-path runtime phase: splits {obs['split'][2]}, expired "
             f"leases {obs['expired_leases']}")
    log(f"[fast_path] Sentinel(device={dev!r}) R={R}, default config: "
        f"verdicts, Entry.fast modes, node totals, routes and state equal "
        f"to a CPU twin; FREE entry+exit {timing['free_us_per_call']:.1f} "
        f"us/call ({timing['free_flushes_per_1k']:.2f} flushes per 1k "
        f"calls), LEASED {timing['leased_us_per_call']:.1f} us/call "
        f"({timing['leased_flushes_per_1k']:.2f} flushes per 1k, "
        f"{obs['renewals']} renewals); prioritized wait "
        f"{obs['prio_wait']} ms; routes {obs['routes']}; kernel launches "
        f"{launches}")
    return {"launches": launches, "timing": timing,
            "routes": obs["routes"], "renewals": obs["renewals"],
            "flushes": obs["flushes"], "prio_wait_ms": obs["prio_wait"],
            "carried": obs["carried"]}


def _param_slots(stt):
    """A host gate that denies resources named ``blocked-*`` and calls whose
    first argument is ``"evil"``, and a device slot with a tuple state that
    denies an event whose row already passed 12 in the rolling second
    (torch only, no wait on the device)."""
    class Gate(stt.HostGate):
        name = "deny-gate"

        def check(self, resource, origin, acquire, args):
            return not (resource.startswith("blocked-")
                        or (len(args) > 0 and args[0] == "evil"))

    class PassCap(stt.DeviceSlot):
        name = "pass-cap"

        def init_state(self, spec):
            return (torch.zeros((), dtype=torch.int32),
                    torch.zeros((), dtype=torch.float32))

        def check(self, state, view):
            ok = view.pass_counts < 12.0
            denied = (view.live & ~ok).sum(dtype=torch.int32)
            top = torch.where(view.live, view.pass_counts, 0.0).amax()
            return (state[0] + denied, torch.maximum(state[1], top)), ok
    return Gate(), PassCap()


def _drive_param(stt, sph, clock, calls: int = 900) -> tuple:
    """Hot-parameter rules and the slot SPI through the user's entry
    points → (observations to compare with a twin, host timings):
    ``entry(res, args=(uid,))`` with exits on QPS (with per-item
    overrides), RATE_LIMITER and THREAD rules; a reload while THREAD
    entries are held, exited after it; an 8192-event ``entry_batch`` with
    2-D int64 args (the vector resolution) over more distinct keys than
    the table's slots (eviction); a list-of-tuples batch with str and
    collection values; a host gate on both tiers; a device slot
    registered (the fast path goes off) and unregistered (it comes
    back)."""
    sph._cpu.sample = lambda: (0.5, 0.25)
    rl = stt.PARAM_BEHAVIOR_RATE_LIMITER
    obs, timing = {}, {}
    sph.load_flow_rules([stt.FlowRule(resource="api", count=300.0)])
    sph.load_param_flow_rules([
        stt.ParamFlowRule(resource="api", param_idx=0, count=5,
                          param_flow_item_list=[
                              stt.ParamFlowItem(object="vip", count=12),
                              stt.ParamFlowItem(object="u0", count=0)]),
        stt.ParamFlowRule(resource="paced", param_idx=0, count=20,
                          control_behavior=rl, max_queueing_time_ms=120),
        stt.ParamFlowRule(resource="conc", param_idx=0,
                          grade=stt.GRADE_THREAD, count=2)])
    rng = np.random.default_rng(21)
    p = 1.0 / np.arange(1, 41) ** 1.1
    uids = rng.choice(40, calls, p=p / p.sum())
    out, held = [], []
    t = time.perf_counter()
    for i in range(calls):
        res = ("api", "paced", "conc")[i % 3]
        uid = "vip" if uids[i] == 39 else f"u{uids[i]}"
        try:
            e = sph.entry(res, args=(uid,), sleep=False)
            out.append(e.wait_ms)
            if res == "conc" and i % 2:
                held.append(e)
            else:
                e.exit()
        except stt.BlockException as exc:
            out.append(type(exc).__name__)
        if len(held) > 6:
            held.pop(0).exit()
        if i % 10 == 9:
            clock.advance_ms(7)
    timing["entry_args_us_per_call"] = (time.perf_counter() - t) \
        / calls * 1e6
    obs["entries"] = out
    # a reload while THREAD entries are held: their exits neither
    # decrement nor unpin
    sph.load_param_flow_rules([
        stt.ParamFlowRule(resource="api", param_idx=0, count=8),
        stt.ParamFlowRule(resource="conc", param_idx=0,
                          grade=stt.GRADE_THREAD, count=3),
        stt.ParamFlowRule(resource="bulk", param_idx=1, count=2)])
    for e in held:
        e.exit()
    obs["pins_after_reload"] = sph.param_key_registry.live_pin_count()
    # 8192 events, 2-D int64 args: one rule per resource, so the vector
    # resolution; ~5,000 distinct keys on a 4096-row table
    n = 8192
    names = [("bulk", "api", "conc", "free")[i] for i in
             rng.integers(0, 4, n)]
    args = rng.integers(0, 4000, (n, 2)).astype(np.int64)
    v = sph.entry_batch(names, args_list=args)
    obs["vector_batch"] = [v.allow.tolist(), v.reason.tolist()]
    obs["pins_after_vector"] = sph.param_key_registry.live_pin_count()
    clock.advance_ms(40)
    # the general resolution: str and collection values, a host gate
    gate, slot = _param_slots(stt)
    sph.register_slot(gate)
    m = 600
    names = [("api", "conc", "blocked-a", "free")[i] for i in
             rng.integers(0, 4, m)]
    vals = [f"u{x}" for x in rng.integers(0, 30, m)]
    args_list = [(["u1", vals[i]],) if i % 7 == 0 else
                 ("evil",) if i % 11 == 0 else (vals[i],)
                 for i in range(m)]
    v = sph.entry_batch(names, args_list=args_list)
    obs["general_batch"] = [v.allow.tolist(), v.reason.tolist(),
                            v.wait_ms.tolist()]
    got = []
    for res, a in (("api", ("u5",)), ("blocked-b", ("u5",)),
                   ("api", ("evil",)), ("free", ("x",))):
        try:
            with sph.entry(res, args=a) as e:
                got.append(("pass", e.fast))
        except stt.BlockException as exc:
            got.append((type(exc).__name__, getattr(exc, "slot_name", "")))
    obs["gate_entries"] = got
    # a device slot: the fast path goes off while it is registered
    obs["fast_before"] = sph._fast_enabled
    sph.register_slot(slot)
    obs["fast_with_slot"] = sph._fast_enabled
    got = []
    for i in range(30):
        try:
            with sph.entry("free", args=(i,)) as e:
                got.append(("pass", e.fast))
        except stt.BlockException as exc:
            got.append((type(exc).__name__, getattr(exc, "slot_name", "")))
    v = sph.entry_batch(["free", "api"] * 16,
                        args_list=[(f"u{i}",) for i in range(32)])
    obs["slot_calls"] = [got, v.allow.tolist(), v.reason.tolist(),
                         sph.slot_name_for_code(int(v.reason.max()))]
    obs["slot_state"] = [float(x) for x in sph._state.custom[0]]
    sph.unregister_slot(slot)
    sph.unregister_slot(gate)
    obs["fast_after"] = sph._fast_enabled
    with sph.entry("free") as e:
        obs["free_after"] = e.fast
    obs["totals"] = {name: sph.node_totals(name) for name in (
        "api", "paced", "conc", "bulk", "free", "blocked-a",
        "__entry_node__")}
    obs["routes"] = dict(sph.routes)
    return obs, timing


def phase_param_runtime(stt, sa, dev="cuda", R=1 << 20,
                        B=1 << 19) -> dict:
    """:func:`_drive_param` on ``Sentinel(device="cuda")`` with the default
    configuration (host fast path on) and 4096 param key rows, against a
    CPU twin under a twin ManualClock: observations, routes and the whole
    engine state must be equal. Then at 1M resources, on the card alone,
    one ``entry_batch`` of ``B`` events with 2-D int args (one rule per
    resource: the vector resolution), timing the pair resolution and the
    whole call on the host."""
    from sentinel_tpu_torch import convert
    from sentinel_tpu_torch import runtime as trt
    t0 = 1_800_000_000_000
    cfg = stt.load_config(max_resources=1 << 14, param_table_slots=4096)
    engines, got = {}, {}
    for d in (dev, "cpu"):
        clock = stt.ManualClock(start_ms=t0)
        sph = stt.Sentinel(config=cfg, clock=clock, device=d)
        if d == dev:
            sa.LAUNCHES.clear()
        got[d] = _drive_param(stt, sph, clock)
        if d == dev:
            launches = sa.LAUNCHES["scatter_add"]
        engines[d] = sph
    (obs, timing), (want, _) = got[dev], got["cpu"]
    for key in want:
        if obs[key] != want[key]:
            fail(f"param runtime phase: {key} differs from the CPU twin: "
                 f"{str(obs[key])[:300]} vs {str(want[key])[:300]}")
    bad = _state_equal(engines[dev]._state, engines["cpu"]._state, convert)
    if bad:
        fail(f"param runtime phase: state differs from the CPU twin: {bad}")
    if launches == 0:
        fail("param runtime phase: the kernel was never launched")
    if not (obs["fast_before"] and not obs["fast_with_slot"]
            and obs["fast_after"] and obs["free_after"] == "free"):
        fail(f"param runtime phase: the fast path did not go off and come "
             f"back: {obs['fast_before']}, {obs['fast_with_slot']}, "
             f"{obs['fast_after']}, {obs['free_after']}")
    outcomes = set(x if isinstance(x, str) else "wait" if x else "pass"
                   for x in obs["entries"])
    if not {"pass", "wait", "ParamFlowException"} <= outcomes:
        fail(f"param runtime phase: entry outcomes {outcomes}")
    codes = set(obs["general_batch"][1])
    if not {5, 96} <= codes:
        fail(f"param runtime phase: general batch reasons {codes}")
    if 16 not in obs["slot_calls"][2] or obs["pins_after_reload"] != 0:
        fail(f"param runtime phase: slot reasons {obs['slot_calls'][2]}, "
             f"pins after the reload {obs['pins_after_reload']}")

    # 1M resources on the card: one 2^19-event batch, vector resolution
    big = stt.Sentinel(config=stt.load_config(max_resources=R),
                       clock=stt.ManualClock(start_ms=t0), device=dev)
    ruled = [f"p{i}" for i in range(PARAM_RESOURCES)]
    big.load_param_flow_rules([stt.ParamFlowRule(resource=r, param_idx=0,
                                                 count=3.0) for r in ruled])
    pool = big.intern_resources(ruled + [f"u{i}" for i in range(60_000)])
    rng = np.random.default_rng(22)
    p = 1.0 / np.arange(1, PARAM_VALUES + 1) ** 1.1
    spent = []
    real = trt.pf_mod.resolve_pairs_many

    def timed(*a, **k):
        t = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            spent.append(time.perf_counter() - t)
    trt.pf_mod.resolve_pairs_many = timed
    call_s = []
    sa.LAUNCHES.clear()
    try:
        for _ in range(3):
            rows = np.where(rng.random(B) < 0.125,
                            pool[rng.integers(0, PARAM_RESOURCES, B)],
                            pool[rng.integers(0, pool.shape[0], B)])
            args = rng.choice(PARAM_VALUES, (B, 1),
                              p=p / p.sum()).astype(np.int64)
            sync()
            t = time.perf_counter()
            v = big.entry_batch(rows, args_list=args)
            call_s.append(time.perf_counter() - t)
            big.clock.advance_ms(3)
    finally:
        trt.pf_mod.resolve_pairs_many = real
    launches += sa.LAUNCHES["scatter_add"]
    denied = int((v.reason == 5).sum())
    if denied == 0 or int(v.allow.sum()) == 0:
        fail(f"param runtime phase: 1M batch allowed {int(v.allow.sum())}, "
             f"param-denied {denied}")
    timing["resolve_ms_2e19"] = [x * 1e3 for x in spent]
    timing["entry_batch_ms_2e19"] = [x * 1e3 for x in call_s]
    log(f"[param_runtime] Sentinel(device={dev!r}), default config, 4096 "
        f"key rows: entries, reload, vector and general batches, host gate, "
        f"device slot: observations, routes and state equal to a CPU twin; "
        f"entry(args=) {timing['entry_args_us_per_call']:.1f} us/call "
        f"(with its exit); routes {obs['routes']}; kernel launches "
        f"{launches}")
    log(f"[param_runtime] R={R}: entry_batch of {B} events, 2-D int args, "
        f"{PARAM_RESOURCES} one-rule resources: pair resolution "
        f"{', '.join(f'{x:.1f}' for x in timing['resolve_ms_2e19'])} ms, "
        f"whole call {', '.join(f'{x:.1f}' for x in timing['entry_batch_ms_2e19'])}"
        f" ms (host clock; the first call warms up)")
    return {"launches": launches, "timing": timing, "routes": obs["routes"]}


# ---------------------------------------------------------------------------
# Phase 8: the runtime's observability, block log, callbacks and staging
# ---------------------------------------------------------------------------

OBS_RULED = 4096                 # QPS-ruled resources (1024 with breakers)


def _evil_gate(stt):
    """A host gate that denies resources named ``evil-*``."""
    class EvilGate(stt.HostGate):
        name = "no-evil"

        def check(self, resource, origin, acquire, args):
            return not resource.startswith("evil-")
    return EvilGate()


def _obs_runtime(stt, R: int, clock, dev, obs_on: bool = True,
                 staging: bool = True):
    """``Sentinel(device=dev)`` with the default configuration at ``R``
    rows and the scalar fixture's rules: 4096 QPS rules (count 50) and
    1024 exception-ratio breakers; ``obs_on``/``staging`` set the
    ``SENTINEL_OBS_DISABLE``/``SENTINEL_HOST_STAGING`` knobs for its
    construction."""
    env = {"SENTINEL_OBS_DISABLE": "0" if obs_on else "1",
           "SENTINEL_HOST_STAGING": "1" if staging else "0"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        sph = stt.Sentinel(config=stt.load_config(max_resources=R),
                           clock=clock, device=dev)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    sph.load_flow_rules([stt.FlowRule(resource=f"r{i}", count=50.0)
                         for i in range(OBS_RULED)])
    sph.load_degrade_rules([stt.DegradeRule(
        resource=f"r{i}", grade=stt.GRADE_EXCEPTION_RATIO, count=0.5,
        time_window=10, min_request_amount=5) for i in range(1024)])
    return sph


def _scalar_stream(sph, B: int, steps: int, seed: int = 41):
    """``steps`` batches of the headline's scalar traffic as pre-interned
    rows (1/4 of the events on the ruled resources) and each step's exit
    error column generator: the exits of ``r0``..``r31`` always fail, so
    their breakers trip."""
    ruled = sph.intern_resources([f"r{i}" for i in range(OBS_RULED)])
    pool = sph.intern_resources([f"u{i}" for i in range(60_000)])
    rng = np.random.default_rng(seed)
    batches = [np.where(rng.random(B) < 0.25,
                        ruled[rng.integers(0, OBS_RULED, B)],
                        pool[rng.integers(0, pool.shape[0], B)]
                        ).astype(np.int32) for _ in range(steps)]
    return batches, set(ruled[:32].tolist())


def _fused_step(sph, rows, prev, failing):
    n = rows.shape[0]
    ra = sph.spec.alt_rows
    err = np.isin(prev, list(failing))
    return sph.decide_and_exit_raw_nowait(
        rows, np.zeros(n, np.int32), np.full(n, ra, np.int32),
        np.zeros(n, np.int32), np.full(n, ra, np.int32),
        np.ones(n, np.int32), np.ones(n, np.bool_), np.zeros(n, np.bool_),
        exit_rows=prev, exit_error=err,
        exit_rt_ms=(prev % 97).astype(np.int32))


def _drive_obs(stt, sph, clock, log_dir: str) -> dict:
    """The twin drive of (e): ``entry()`` calls that pass, block and raise
    business errors, batches with origins, one that splits, host-gate
    denials in both tiers, a forced breaker, breaker transitions and a
    geometry change; callbacks, the block log and the block-event log on.
    → the observations the GPU and CPU twins must agree on."""
    from sentinel_tpu_torch.core.logs import BlockStatLogger
    from sentinel_tpu_torch.rules.degrade import STATE_OPEN
    sph.block_log.close()
    sph.block_log = BlockStatLogger(clock, base_dir=log_dir)
    sph.obs.block_events.configure(log_dir, "obsapp")
    sph._cpu.sample = lambda: (0.5, 0.25)
    seq, arcs = [], []
    cb = sph.callbacks
    cb.add_pass_handler(lambda r, o, a, args: seq.append(("pass", r, o, a)))
    cb.add_blocked_handler(lambda r, o, a, exc: seq.append(
        ("block", r, o, a, type(exc).__name__)))
    cb.add_exit_handler(lambda r, rt, err, a: seq.append(
        ("exit", r, rt, err, a)))
    sph.add_breaker_observer(lambda r, old, new: arcs.append((r, old, new)))
    sph.register_slot(_evil_gate(stt))
    sph.load_flow_rules([stt.FlowRule(resource="hello", count=20),
                         stt.FlowRule(resource="api", count=100),
                         stt.FlowRule(resource="api", count=3,
                                      limit_app="app-a")])
    sph.load_degrade_rules([stt.DegradeRule(
        resource=r, grade=stt.GRADE_EXCEPTION_COUNT, count=1,
        time_window=1, min_request_amount=1) for r in ("osc", "ctl")])
    sph.check_breaker_transitions()
    out = {"entries": []}
    for i in range(30):
        res = ("hello", "free", "osc", "evil-1")[i % 4]
        try:
            with sph.entry(res, origin="app-a" if i % 3 else "") as e:
                if res == "osc" and i % 8 == 2:
                    e.trace(RuntimeError("business"))
                clock.advance_ms(3)
            out["entries"].append("pass")
        except stt.BlockException as exc:
            out["entries"].append(type(exc).__name__)
        if i % 10 == 9:
            clock.advance_ms(1100)
    rng = np.random.default_rng(7)
    n = 9000
    names = [("api", "free", "evil-2")[k] for k in rng.integers(0, 3, n)]
    origins = ["app-a" if x < 0.02 else "" for x in rng.random(n)]
    out["split"] = sph.entry_batch(names, origins=origins).allow.tolist()
    out["origins"] = sph.entry_batch(
        ["api"] * 64, origins=["app-a"] * 32 + ["app-b"] * 32,
        contexts=["c1"] * 64).reason.tolist()
    out["forced"] = sph.force_breaker("ctl", STATE_OPEN)
    try:
        sph.entry("ctl").exit()
        out["after_force"] = "pass"
    except stt.BlockException as exc:
        out["after_force"] = type(exc).__name__
    sph.update_window_geometry(sample_count=4)
    out["after_geometry"] = sph.entry_batch(["hello"] * 40).allow.tolist()
    clock.advance_ms(1500)
    out["metrics"] = [dataclasses.asdict(m)
                      for m in sph.metrics_snapshot(clock.now_ms() - 1500)]
    out["totals"] = sph.all_node_totals()
    out["origin_totals"] = sph.origin_totals("api")
    out["breakers"] = sph.breaker_resources()
    out["routes"] = dict(sph.routes)
    sph.obs.flush()
    sph.block_log.flush()
    out["counters"] = sph.obs.counters.snapshot()
    out["spans"] = [{k: v for k, v in s.items() if k != "thread"}
                    for s in sph.obs.spans.snapshot()]
    out["hist"] = [sph.obs.hist_entry.snapshot(),
                   sph.obs.hist_dispatch.snapshot()]
    out["callbacks"] = seq
    out["arcs"] = arcs
    files = {}
    for f in sorted(os.listdir(log_dir)):
        with open(os.path.join(log_dir, f), "rb") as fh:
            files[f] = fh.read()
    out["log_files"] = files
    return out


def phase_obs_runtime(stt, sa, dev="cuda", R=1 << 20, B=1 << 19,
                      steps: int = 32, twin_rows: int = 1 << 14,
                      profile: bool = False) -> dict:
    """The runtime with its self-telemetry, callbacks, block log, breaker
    observers and host staging, through the entry points a user calls.

    (a) full-width fused decide+exit steps on ``Sentinel(device="cuda")``
    (default config, ``R`` rows, minute ring on, the scalar fixture),
    obs on, against a twin constructed with obs off, and (b) a twin with
    host staging off, in turns, the same stream on each: host ms a step,
    equal verdicts, the obs-on counters, launches a step, and the cost of
    one ``obs.annotate``; then a stream of nowait dispatches with the
    staging ring at depth 1 and at depth 8 (equal verdicts; ``grown``);
    (c) ``metrics_snapshot`` and ``all_node_totals`` at ``R`` rows; (d)
    the breaker transitions an observer saw; (e) :func:`_drive_obs` on
    the card and on a CPU twin at ``twin_rows``: every observation equal.
    The dispatches run with the sync debug mode at "error". ``profile``
    also records four more obs-on steps with ``torch.profiler`` (device
    ms a step beside host ms a step)."""
    import tempfile
    t0 = 1_800_000_000_000
    names = ("obs_on", "obs_off", "staging_off")
    engines = {}
    for name in names:
        engines[name] = _obs_runtime(
            stt, R, stt.ManualClock(start_ms=t0), dev,
            obs_on=name != "obs_off", staging=name != "staging_off")
    if engines["obs_off"].obs.enabled or not engines["obs_on"].obs.enabled:
        fail("obs runtime phase: the obs knob did not take")
    if engines["staging_off"]._staging_on:
        fail("obs runtime phase: the staging knob did not take")
    arcs = {name: [] for name in names}
    for name, sph in engines.items():
        sph.add_breaker_observer(
            lambda r, o, n, name=name: arcs[name].append((r, o, n)))
    batches, failing = _scalar_stream(engines["obs_on"], B, steps)
    for sph in engines.values():        # same rows in every twin
        sph.intern_resources([f"r{i}" for i in range(OBS_RULED)])
        sph.intern_resources([f"u{i}" for i in range(60_000)])
    host_ms = {name: [] for name in names}
    allow = {name: [] for name in names}
    prev = {name: np.empty(0, np.int32) for name in names}
    launches = {name: 0 for name in names}
    for step in range(steps):
        order = names if step % 2 == 0 else names[::-1]
        for name in order:
            sph = engines[name]
            sph.clock.advance_ms(2)
            sync()
            sa.LAUNCHES.clear()
            t = time.perf_counter()
            with no_host_sync(dev == "cuda"):
                h = _fused_step(sph, batches[step], prev[name], failing)
            v = h.result()
            host_ms[name].append((time.perf_counter() - t) * 1e3)
            launches[name] += sa.LAUNCHES["scatter_add"]
            allow[name].append(v.allow)
            prev[name] = batches[step][v.allow]
    for name in names[1:]:
        if not all(np.array_equal(a, b) for a, b in
                   zip(allow[name], allow["obs_on"])):
            fail(f"obs runtime phase: {name} verdicts differ from obs_on")
        if arcs[name] != arcs["obs_on"]:
            fail(f"obs runtime phase: {name} breaker arcs differ")
        if launches[name] != launches["obs_on"]:
            fail(f"obs runtime phase: {name} launched {launches[name]}, "
                 f"obs_on {launches['obs_on']}")
    on = engines["obs_on"]
    counters = on.obs.counters.snapshot()
    want = {"split_route.fused_exit": steps, "pipeline.dispatches": steps,
            "split_route.sortfree": steps}
    if any(counters.get(k) != v for k, v in want.items()):
        fail(f"obs runtime phase: counters {counters}, want {want}")
    if launches["obs_on"] == 0:
        fail("obs runtime phase: the kernel was never launched")
    if not arcs["obs_on"]:
        fail("obs runtime phase: the observer saw no breaker transition")
    ring = on._staging.get(B)
    grown = None if ring is None else ring.grown
    if ring is None:
        fail("obs runtime phase: the staging ring was not used")
    prof = None
    if profile:
        last = [prev["obs_on"]]
        prof_host = []

        def run_steps():
            for step in range(4):
                on.clock.advance_ms(2)
                t = time.perf_counter()
                v = _fused_step(on, batches[step], last[0], failing).result()
                prof_host.append((time.perf_counter() - t) * 1e3)
                last[0] = batches[step][v.allow]
        prof = _profile_steps(run_steps, 4, "obs_runtime_trace.json",
                              keep_trace=False)
        prof["host_ms"] = prof_host
        log(f"[obs_runtime] profiled obs-on steps: device "
            f"{prof['device_ms_per_step']:.3f} ms a step, host "
            f"{', '.join(f'{x:.2f}' for x in prof_host)} ms")

    # the cost of one annotation, obs on and off (host us a call)
    ann = {}
    for name in ("obs_on", "obs_off"):
        obs = engines[name].obs
        t = time.perf_counter()
        for _ in range(20_000):
            with obs.annotate("sentinel_tpu.fused"):
                pass
        ann[name] = (time.perf_counter() - t) / 20_000 * 1e6

    # (b) a stream of nowait dispatches held in flight, ring depth 1 and 8
    depth_allow, depth_grown = {}, {}
    stream = 8
    for depth in (1, 8):
        sph = _obs_runtime(stt, R, stt.ManualClock(start_ms=t0), dev)
        sph._staging_depth = depth
        rows_s, failing_s = _scalar_stream(sph, B, stream, seed=43)
        handles = []
        with no_host_sync(dev == "cuda"):
            for step in range(stream):
                sph.clock.advance_ms(2)
                handles.append(_fused_step(sph, rows_s[step],
                                           np.empty(0, np.int32), failing_s))
        depth_allow[depth] = [h.result().allow for h in handles]
        depth_grown[depth] = sph._staging[B].grown
        del sph, handles
    if not all(np.array_equal(a, b)
               for a, b in zip(depth_allow[1], depth_allow[8])):
        fail("obs runtime phase: verdicts differ between ring depths 1, 8")
    if depth_grown != {1: stream - 1, 8: 0}:
        fail(f"obs runtime phase: ring growth {depth_grown}, want "
             f"{{1: {stream - 1}, 8: 0}}")

    # (c) snapshots at R rows
    on.clock.advance_ms(1000)
    snap_ms, totals_ms = [], []
    for _ in range(3):
        sync()
        t = time.perf_counter()
        nodes = on.metrics_snapshot(on.clock.now_ms() - 1000)
        snap_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        totals = on.all_node_totals()
        totals_ms.append((time.perf_counter() - t) * 1e3)
    if not nodes or len(totals) != len(on.resources.items()):
        fail(f"obs runtime phase: snapshot {len(nodes)} nodes, totals "
             f"{len(totals)}")
    for sph in engines.values():
        sph.close()
    del engines, on

    # (e) the card against a CPU twin
    with tempfile.TemporaryDirectory() as tmp:
        got = {}
        for d in (dev, "cpu"):
            clock = stt.ManualClock(start_ms=t0)
            sph = stt.Sentinel(config=stt.load_config(max_resources=twin_rows),
                               clock=clock, device=d)
            if d == dev:
                sa.LAUNCHES.clear()
            got[d] = _drive_obs(stt, sph, clock, os.path.join(tmp, d))
            if d == dev:
                twin_launches = sa.LAUNCHES["scatter_add"]
            sph.close()
    for key in got["cpu"]:
        if got[dev][key] != got["cpu"][key]:
            fail(f"obs runtime phase: {key} differs from the CPU twin: "
                 f"{str(got[dev][key])[:300]} vs {str(got['cpu'][key])[:300]}")
    obs = got[dev]
    if not (obs["arcs"] and obs["log_files"] and obs["forced"]
            and obs["after_force"] == "DegradeException"
            and "CustomSlotException" in obs["entries"]
            and obs["routes"].get("split")):
        fail(f"obs runtime phase: the twin drive missed a case: arcs "
             f"{obs['arcs']}, files {list(obs['log_files'])}, routes "
             f"{obs['routes']}, entries {obs['entries']}")

    per_step = launches["obs_on"] / steps
    res = {"launches": launches["obs_on"] + twin_launches,
           "launches_per_step": per_step,
           "host_ms": {k: summary(v[1:]) for k, v in host_ms.items()},
           "host_ms_all": host_ms, "counters_obs_on": counters,
           "annotate_us": ann, "ring_grown": grown,
           "depth_grown": depth_grown, "breaker_arcs": len(arcs["obs_on"]),
           "metrics_snapshot_ms": snap_ms, "all_node_totals_ms": totals_ms,
           "snapshot_nodes": len(nodes), "resources": len(totals),
           "twin_counters": obs["counters"], "profile": prof}
    q = {k: np.percentile(v[1:], [25, 50, 75]) for k, v in host_ms.items()}
    log(f"[obs_runtime] Sentinel(device={dev!r}) R={R}, default config, "
        f"B={B}, {steps} fused scalar steps each in turns: host ms a step "
        + "; ".join(f"{k} median {q[k][1]:.2f} (IQR {q[k][0]:.2f}-"
                    f"{q[k][2]:.2f}, min {min(host_ms[k][1:]):.2f}, max "
                    f"{max(host_ms[k][1:]):.2f})" for k in names)
        + f"; verdicts equal; {per_step:.1f} launches a step in each; "
        f"annotate {ann['obs_on']:.2f} us on, {ann['obs_off']:.3f} us off")
    log(f"[obs_runtime] counters (obs on): {counters}")
    log(f"[obs_runtime] staging ring grown {grown} over the turns; a "
        f"stream of {stream} nowait dispatches in flight: depth 1 grew "
        f"{depth_grown[1]}, depth 8 grew {depth_grown[8]}, verdicts equal")
    log(f"[obs_runtime] metrics_snapshot at R={R} "
        f"({len(nodes)} nodes of {len(totals)} resources): "
        f"{', '.join(f'{x:.1f}' for x in snap_ms)} ms; all_node_totals "
        f"{', '.join(f'{x:.1f}' for x in totals_ms)} ms")
    log(f"[obs_runtime] breaker observer saw {len(arcs['obs_on'])} "
        f"transitions; twin drive at {twin_rows} rows: counters, spans, "
        f"histograms, callbacks ({len(obs['callbacks'])}), block-log and "
        f"block-event files ({len(obs['log_files'])}), metric nodes, "
        f"totals, breaker arcs ({len(obs['arcs'])}) equal to the CPU twin; "
        f"kernel launches {res['launches']}")
    return res


# ---------------------------------------------------------------------------
# Phase 9: the serving tier (pipeline, batcher, open-loop replay, telemetry)
# ---------------------------------------------------------------------------

SERVING_LAG = 4          # exits of step N: the admissions of step N - 4
SERVING_ORIGINS = 64
#: (workload, offered req/s) of the open-loop replay, each for 1 s
OPEN_LOOP_RUNS = (("steady", 5_000), ("steady", 20_000), ("steady", 80_000),
                  ("flash_crowd", 20_000), ("zipf_hot", 20_000),
                  ("priority_mix", 20_000))


def _fused_args(sph, rows, prev, failing):
    """``decide_and_exit_raw_nowait`` arguments of one fused scalar step
    (exits ``prev``; those of ``failing`` resources raise)."""
    n = rows.shape[0]
    ra = sph.spec.alt_rows
    err = np.isin(prev, list(failing))
    return ((rows, np.zeros(n, np.int32), np.full(n, ra, np.int32),
             np.zeros(n, np.int32), np.full(n, ra, np.int32),
             np.ones(n, np.int32), np.ones(n, np.bool_),
             np.zeros(n, np.bool_)),
            dict(exit_rows=prev, exit_error=err,
                 exit_rt_ms=(prev % 97).astype(np.int32)))


def _leaves(tree, prefix=""):
    """(path, tensor) of every tensor leaf of a state tree."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or range(len(tree))
        for name, item in zip(names, tree):
            yield from _leaves(item, f"{prefix}{name}.")


def _device_state_diff(a, b) -> list:
    """Leaves of two engine states that differ, compared where they
    live (no copy of the 1M-row tables to the host)."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    return sorted(k for k in la.keys() | lb.keys()
                  if k not in la or k not in lb
                  or la[k].shape != lb[k].shape
                  or la[k].dtype != lb[k].dtype
                  or not torch.equal(la[k], lb[k]))


def _serving_pipeline(stt, sa, dev, R, B, turns, per_turn, profile):
    """(a) the same fused scalar stream four ways on twin runtimes:
    sequential ``.result()`` per step and ``DispatchPipeline.submit_fused``
    at depth 1, 2 and 4, each way ``per_turn`` steps a turn, in turns."""
    t0 = 1_800_000_000_000
    ways = {"sequential": 0, "depth1": 1, "depth2": 2, "depth4": 4}
    sph = {w: _obs_runtime(stt, R, stt.ManualClock(start_ms=t0), dev)
           for w in ways}
    steps = turns * per_turn
    batches, failing = _scalar_stream(sph["sequential"], B, steps, seed=47)
    for w in list(ways)[1:]:                   # same rows in every twin
        sph[w].intern_resources([f"r{i}" for i in range(OBS_RULED)])
        sph[w].intern_resources([f"u{i}" for i in range(60_000)])
    pipes = {w: stt.DispatchPipeline(sph[w], depth=d)
             for w, d in ways.items() if d}
    allow = {w: [] for w in ways}
    tickets = {w: [] for w in ways}
    host_ms = {w: [] for w in ways}
    submit_ms = {w: [] for w in ways}   # inside the dispatch calls alone
    launches = {w: 0 for w in ways}
    empty = np.empty(0, np.int32)

    def exits(w, step):
        if step < SERVING_LAG:
            return empty
        k = step - SERVING_LAG
        if w != "sequential" and len(allow[w]) <= k:
            allow[w].append(tickets[w][k].result().allow)
        return batches[k][allow[w][k]]

    for turn in range(turns):
        order = list(ways) if turn % 2 == 0 else list(ways)[::-1]
        for w in order:
            s = sph[w]
            sync()
            sa.LAUNCHES.clear()
            t = time.perf_counter()
            t_sub = 0.0
            for step in range(turn * per_turn, (turn + 1) * per_turn):
                s.clock.advance_ms(2)
                args, kw = _fused_args(s, batches[step], exits(w, step),
                                       failing)
                t1 = time.perf_counter()
                with no_host_sync(dev == "cuda"):
                    if w == "sequential":
                        h = s.decide_and_exit_raw_nowait(*args, **kw)
                    else:
                        tickets[w].append(pipes[w].submit_fused(*args, **kw))
                t_sub += time.perf_counter() - t1
                if w == "sequential":
                    allow[w].append(h.result().allow)
            submit_ms[w].append(t_sub * 1e3 / per_turn)
            if w != "sequential":
                pipes[w].flush()
                while len(allow[w]) < len(tickets[w]):
                    allow[w].append(tickets[w][len(allow[w])].result().allow)
            host_ms[w].append((time.perf_counter() - t) * 1e3 / per_turn)
            launches[w] += sa.LAUNCHES["scatter_add"]
    for w in list(ways)[1:]:
        if not all(np.array_equal(a, b) for a, b in
                   zip(allow[w], allow["sequential"])):
            fail(f"serving phase: {w} verdicts differ from the sequential "
                 f"loop")
        diff = _device_state_diff(sph[w]._state, sph["sequential"]._state)
        if diff:
            fail(f"serving phase: {w} state differs from the sequential "
                 f"loop: {diff}")
        if launches[w] != launches["sequential"]:
            fail(f"serving phase: {w} launched {launches[w]}, sequential "
                 f"{launches['sequential']}")
    grown = {w: (sph[w]._staging[B].grown if B in sph[w]._staging else None)
             for w in ways}
    counters = {w: {k: v for k, v in sph[w].obs.counters.snapshot().items()
                    if k.startswith("pipeline.")} for w in ways}
    prof = None
    if profile:
        prof = {}
        for w in ("depth1", "depth4"):
            s, pipe = sph[w], pipes[w]
            host = []

            def run_steps(s=s, pipe=pipe, host=host, w=w):
                t = time.perf_counter()
                out = []
                for i in range(per_turn):
                    s.clock.advance_ms(2)
                    args, kw = _fused_args(s, batches[i], empty, failing)
                    out.append(pipe.submit_fused(*args, **kw))
                pipe.flush()
                host.append((time.perf_counter() - t) * 1e3 / per_turn)

            p = _profile_steps(run_steps, per_turn, f"serving_{w}_trace.json",
                               keep_trace=False)
            p["host_ms_per_step"] = host[0]
            p["busy_share"] = p["device_ms_per_step"] / host[0]
            prof[w] = {k: p[k] for k in ("device_ms_per_step",
                                         "host_ms_per_step", "busy_share")}
            log(f"[serving] profiled {w}: device {p['device_ms_per_step']:.3f}"
                f" ms a step, host {host[0]:.2f} ms a step, busy share "
                f"{p['busy_share']:.3f}")
    for s in sph.values():
        s.close()
    per_step = launches["sequential"] / steps
    q = {w: np.percentile(v[1:], [25, 50, 75]) for w, v in host_ms.items()}
    log(f"[serving] pipeline: R={R}, B={B}, {turns} turns of {per_turn} fused "
        f"scalar steps a way (exits: admissions {SERVING_LAG} steps back): "
        f"host ms a step " + "; ".join(
            f"{w} median {q[w][1]:.2f} (IQR {q[w][0]:.2f}-{q[w][2]:.2f})"
            for w in ways)
        + "; of which inside the dispatch call " + ", ".join(
            f"{w} {np.median(submit_ms[w][1:]):.2f}" for w in ways)
        + f"; verdicts and state equal; {per_step:.1f} launches a step; "
        f"staging ring grown {grown}")
    return {"launches": sum(launches.values()), "launches_per_step": per_step,
            "host_ms": {w: summary(v[1:]) for w, v in host_ms.items()},
            "host_ms_all": host_ms, "ring_grown": grown,
            "submit_ms": {w: summary(v[1:]) for w, v in submit_ms.items()},
            "counters": counters, "profile": prof}


def _batcher_stream(n: int, seed: int = 53):
    """``n`` requests over the 4096 ruled resources, Zipf(1.1) popularity
    (so the head exceeds its QPS rule, and prioritized requests book the
    next window): 30% prioritized, 40% with one of 64 origins."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, OBS_RULED + 1) ** 1.1
    res = rng.choice(OBS_RULED, n, p=w / w.sum())
    prio = rng.random(n) < 0.3
    org = np.where(rng.random(n) < 0.4,
                   rng.integers(0, SERVING_ORIGINS, n), -1)
    return [(f"r{int(r)}", bool(p), f"app-{int(o)}" if o >= 0 else "")
            for r, p, o in zip(res, prio, org)]


def _drive_batcher(sph, stream, batch_max: int, timeout_s: float = 600):
    """``stream`` through ``sph.frontend(batch_max, depth=2,
    record_flushes=True)`` under the runtime's ManualClock → (verdict
    tuples, flush log)."""
    import asyncio

    async def run():
        b = sph.frontend(batch_max=batch_max, depth=2, deadline_ms=60_000,
                         idle_ms=60_000.0, queue_max=len(stream) + 1,
                         record_flushes=True)
        vs = await asyncio.gather(*(b.submit(r, prioritized=p, origin=o)
                                    for r, p, o in stream))
        await b.drain()
        if b.pending:
            fail(f"serving phase: {b.pending} requests still pending")
        b.close()
        return vs, b.flush_log

    vs, log_ = asyncio.run(asyncio.wait_for(run(), timeout_s))
    return [(v.allow, v.reason, v.wait_ms) for v in vs], log_


def _replay_flushes(sph, flush_log):
    out = []
    for f in flush_log:
        v = sph.entry_batch_nowait(
            f["resources"], acquire=np.asarray(f["counts"], np.int32),
            prioritized=np.asarray(f["prioritized"], np.bool_),
            origins=f["origins"] if any(f["origins"]) else None).result()
        out += list(zip(v.allow.tolist(), v.reason.tolist(),
                        v.wait_ms.tolist()))
    return out


def _serving_batcher(stt, sa, dev, R, n, twin_rows):
    """(b) ``n`` requests through the batcher at ``R`` rows, replayed
    through ``entry_batch_nowait`` on a second runtime; then the same
    drive at ``twin_rows`` on the card and on the CPU."""
    from sentinel_tpu_torch import convert
    t0 = 1_800_000_000_000
    stream = _batcher_stream(n)
    fe_s = _obs_runtime(stt, R, stt.ManualClock(start_ms=t0), dev)
    seq_s = _obs_runtime(stt, R, stt.ManualClock(start_ms=t0), dev)
    sync()
    sa.LAUNCHES.clear()
    t = time.perf_counter()
    with no_host_sync(dev == "cuda"):
        got, flush_log = _drive_batcher(fe_s, stream, 4096)
    drive_s = time.perf_counter() - t
    launches = sa.LAUNCHES["scatter_add"]
    want = _replay_flushes(seq_s, flush_log)
    if [r for f in flush_log for r in f["resources"]] != [
            r for r, _p, _o in stream]:
        fail("serving phase: the flush log does not hold the stream in order")
    if got != want:
        bad = sum(a != b for a, b in zip(got, want))
        fail(f"serving phase: batcher verdicts differ from the replay in "
             f"{bad} of {len(got)} requests")
    diff = _device_state_diff(fe_s._state, seq_s._state)
    if diff:
        fail(f"serving phase: batcher state differs from the replay: {diff}")
    if sorted(fe_s.all_node_totals()) != sorted(seq_s.all_node_totals()):
        fail("serving phase: batcher node totals differ from the replay")
    reasons = collections.Counter(f["reason"] for f in flush_log)
    granted = sum(1 for a, _r, w in got if a and w > 0)
    blocked = sum(1 for a, _r, _w in got if not a)
    routes = dict(fe_s.routes)
    for s in (fe_s, seq_s):
        s.close()
    del fe_s, seq_s

    # the same drive at twin_rows, the card against the CPU
    twin = {}
    for d in (dev, "cpu"):
        s = _obs_runtime(stt, twin_rows, stt.ManualClock(start_ms=t0), d)
        if d == dev:
            sa.LAUNCHES.clear()
        v, fl = _drive_batcher(s, stream, 4096)
        if d == dev:
            launches += sa.LAUNCHES["scatter_add"]
        twin[d] = (v, fl, sorted(s.all_node_totals()),
                   convert.to_numpy(s._state),
                   {k: c for k, c in s.obs.counters.snapshot().items()},
                   s.obs.hist_request.snapshot())
        s.close()
    for i, name in enumerate(("verdicts", "flush log", "node totals")):
        if twin[dev][i] != twin["cpu"][i]:
            fail(f"serving phase: twin {name} differ from the CPU twin")
    diff = convert.leaf_diff(twin[dev][3], twin["cpu"][3])
    if diff:
        fail(f"serving phase: twin state differs from the CPU twin: {diff}")
    if twin[dev][4] != twin["cpu"][4] or twin[dev][5] != twin["cpu"][5]:
        fail(f"serving phase: twin counters differ from the CPU twin: "
             f"{twin[dev][4]} vs {twin['cpu'][4]}")
    log(f"[serving] batcher: {n} requests (4096 resources, 30% prioritized, "
        f"40% of 64 origins) through sph.frontend(batch_max=4096, depth=2) "
        f"at R={R}: {len(flush_log)} flushes {dict(reasons)}, routes "
        f"{routes}, {blocked} blocked, {granted} occupy grants, "
        f"{drive_s:.2f} s; verdicts, node totals and state equal to the "
        f"entry_batch replay; the {twin_rows}-row drive equal to its CPU "
        f"twin (verdicts, flush log, totals, counters, state)")
    return {"launches": launches, "requests": n, "flushes": len(flush_log),
            "flush_reasons": dict(reasons), "routes": routes,
            "blocked": blocked, "granted": granted, "drive_s": drive_s}


def _entry_minute_totals(sph) -> np.ndarray:
    """The ENTRY row's live minute-window counters, summed → int64[E]."""
    from sentinel_tpu_torch.core.registry import ENTRY_NODE_ROW
    with sph._lock:
        st = sph._state.minute
        idx = sph.spec.minute.index_of(sph.clock.now_ms())
        d = idx - st.stamps[ENTRY_NODE_ROW]
        live = (d >= 0) & (d < sph.spec.minute.buckets)
        c = torch.where(live[:, None], st.counters[ENTRY_NODE_ROW], 0)
        return c.sum(0).cpu().numpy().astype(np.int64)


def _open_loop_rules(stt):
    """The scalar fixture's rules with the last 40 QPS rules given to the
    workloads (the default configuration holds 4096): generous on
    ``steady/*`` and ``flash/*``, 300 QPS on the flash crowd's hot key,
    400 QPS on the priority mix's resources (``serving_bench``'s)."""
    rules = [stt.FlowRule(resource=f"r{i}", count=50.0)
             for i in range(OBS_RULED - 40)]
    rules += [stt.FlowRule(resource=f"{p}/{i}", count=1e9)
              for p in ("steady", "flash") for i in range(16)]
    rules += [stt.FlowRule(resource="flash/hot", count=300.0)]
    rules += [stt.FlowRule(resource=f"prio/{i}", count=400.0)
              for i in range(7)]
    return rules


def _open_loop_run(stt, sph, reqs, batch_max, duration_ms, guard,
                   on_batcher=None):
    """Replay ``reqs`` open-loop (each submitted at its arrival time on
    the wall clock) through a fresh batcher → (the run's numbers, failed
    invariants). ``guard``: the replay runs with the sync debug mode at
    "error"; ``on_batcher(b)`` sees the batcher before the first request
    (phase 10 binds an overload controller to it)."""
    import asyncio
    from sentinel_tpu_torch.frontend import IngestOverload
    from sentinel_tpu_torch.obs import counters as ck
    stats = collections.Counter()
    disp = [0.0, 0]      # wall seconds inside the batcher's dispatch, calls

    async def replay():
        b = stt.AdaptiveBatcher(sph, batch_max=batch_max, deadline_ms=25,
                                depth=2)
        if on_batcher is not None:
            on_batcher(b)
        dispatch = b._dispatch

        def timed_dispatch(reqs, trace_id=0):
            t = time.perf_counter()
            try:
                return dispatch(reqs, trace_id)
            finally:
                disp[0] += time.perf_counter() - t
                disp[1] += 1
        b._dispatch = timed_dispatch
        loop = asyncio.get_running_loop()
        t_start = loop.time()

        async def fire(r):
            delay = t_start + r.t_ms / 1000.0 - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            try:
                v = await b.submit(r.resource, count=r.count,
                                   prioritized=r.prioritized, origin=r.origin)
            except IngestOverload:
                stats["shed"] += 1
                return "shed"
            key = ("granted" if v.allow and v.wait_ms > 0
                   else "allowed" if v.allow else "blocked")
            stats[key] += 1
            return key

        t = time.perf_counter()
        out = await asyncio.gather(*(fire(r) for r in reqs))
        await b.drain()
        elapsed = time.perf_counter() - t
        pending = b.pending
        b.close()
        return out, elapsed, pending

    before = _entry_minute_totals(sph)
    with no_host_sync(guard):
        statuses, elapsed, pending = asyncio.run(asyncio.wait_for(
            replay(), 120 + duration_ms / 1000.0))
    delta = _entry_minute_totals(sph) - before
    c = sph.obs.counters.snapshot()
    settled = stats["allowed"] + stats["granted"] + stats["blocked"]
    flushes = {k: c.get(f"frontend.flush_reason.{k}", 0)
               for k in ("full", "deadline", "idle")}
    h = sph.obs.hist_request
    from sentinel_tpu_torch.stats import events as ev
    res = {
        "offered": len(reqs), "offered_per_s": len(reqs) / (duration_ms / 1e3),
        "settled": settled, "shed": stats["shed"],
        "allowed": stats["allowed"], "granted": stats["granted"],
        "blocked": stats["blocked"], "elapsed_s": elapsed,
        "decisions_per_s": settled / elapsed,
        "p50_ms": h.percentile_ms(0.50), "p95_ms": h.percentile_ms(0.95),
        "p99_ms": h.percentile_ms(0.99),
        "flushes": flushes,
        "mean_batch": (c.get(ck.FE_ENQUEUE, 0) / max(1, sum(flushes.values()))),
        "dispatch_ms_per_flush": disp[0] * 1e3 / max(1, disp[1]),
        "telemetry_tick": c.get(ck.TELEMETRY_TICK, 0),
        "pipeline_stall": c.get(ck.PIPE_STALL, 0),
        "pipeline_depth_sum": c.get(ck.PIPE_DEPTH, 0),
        "entry_delta": {"pass": int(delta[ev.PASS]),
                        "block": int(delta[ev.BLOCK]),
                        "occupied_pass": int(delta[ev.OCCUPIED_PASS])},
    }
    problems = []
    if len(statuses) != len(reqs) or pending:
        problems.append(f"{len(statuses)} of {len(reqs)} settled, "
                        f"{pending} pending after drain")
    if settled + stats["shed"] != len(reqs):
        problems.append(f"settled {settled} + shed {stats['shed']} != "
                        f"offered {len(reqs)}")
    if c.get(ck.FE_ENQUEUE, 0) != settled or c.get(ck.FE_SHED, 0) != \
            stats["shed"] or h.count != settled:
        problems.append(f"enqueued {c.get(ck.FE_ENQUEUE, 0)}, shed counter "
                        f"{c.get(ck.FE_SHED, 0)}, request histogram "
                        f"{h.count}: want {settled} and {stats['shed']}")
    # admitted + blocked == the ENTRY row's PASS + BLOCK; an occupy grant's
    # pass belongs to the window it booked and counts OCCUPIED_PASS now
    if (res["entry_delta"]["pass"], res["entry_delta"]["occupied_pass"],
            res["entry_delta"]["block"]) != (
            stats["allowed"], stats["granted"], stats["blocked"]):
        problems.append(f"verdicts allowed {stats['allowed']} granted "
                        f"{stats['granted']} blocked {stats['blocked']} vs "
                        f"the engine's {res['entry_delta']}")
    return res, problems


def _serving_open_loop(stt, sa, dev, R, duration_ms, runs, batch_maxes):
    """(c) the workload zoo open-loop under the wall clock, one runtime per
    ``batch_max`` with a CadenceScheduler (1 s telemetry interval)."""
    from sentinel_tpu_torch.frontend import workloads
    out = {}
    launches = 0
    for bm in batch_maxes:
        sph = _obs_runtime(stt, R, stt.SystemClock(), dev)
        sph.load_flow_rules(_open_loop_rules(stt))
        sched = stt.CadenceScheduler(sph, telemetry_interval_sec=1.0)
        sched.start()
        # warm-up episode (first allocations of each padded size)
        _open_loop_run(stt, sph, workloads.make(
            "steady", 1, duration_ms=min(300.0, duration_ms),
            rate_rps=20_000.0), bm, min(300.0, duration_ms), False)
        for name, rate in runs:
            reqs = workloads.make(name, 7, duration_ms=float(duration_ms),
                                  rate_rps=float(rate))
            sph.obs.counters.clear()
            sph.obs.hist_request.clear()
            sa.LAUNCHES.clear()
            res, problems = _open_loop_run(stt, sph, reqs, bm, duration_ms,
                                           dev == "cuda")
            launches += sa.LAUNCHES["scatter_add"]
            if problems:
                fail(f"serving phase: open loop {name} at {rate}/s, "
                     f"batch_max {bm}: " + "; ".join(problems))
            out[f"{name}@{rate}/bm{bm}"] = res
            log(f"[serving] open loop {name} {rate}/s, batch_max {bm}: "
                f"offered {res['offered_per_s']:.0f}/s, achieved "
                f"{res['decisions_per_s']:.0f} decisions/s; request->verdict "
                f"p50 {res['p50_ms']:.2f} p95 {res['p95_ms']:.2f} p99 "
                f"{res['p99_ms']:.2f} ms; flushes {res['flushes']}, mean "
                f"batch {res['mean_batch']:.1f} ("
                f"{res['dispatch_ms_per_flush']:.2f} ms in a dispatch), "
                f"shed {res['shed']}, blocked "
                f"{res['blocked']}, granted {res['granted']}; telemetry.tick "
                f"{res['telemetry_tick']}, pipeline.stall "
                f"{res['pipeline_stall']}, pipeline.depth "
                f"{res['pipeline_depth_sum']}")
        # the scheduler's daemon self-dispatches a stale tick (1.5 s with
        # none): wait for one if the runs were too short to see it
        deadline = time.monotonic() + 5.0
        while (sph.telemetry.snapshot()["ticks"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.05)
        sched.stop()
        if sph.telemetry.snapshot()["ticks"] == 0:
            fail(f"serving phase: the CadenceScheduler never ticked the "
                 f"telemetry at batch_max {bm}")
        sph.close()
        del sph
    return out, launches


def _serving_telemetry(stt, dev, R, ticks, cycles_per_ms):
    """(d) ``Sentinel.telemetry`` at ``R`` rows: tick and drain times, the
    hot set and its quantiles against a host recompute (with ties), and
    the ring wrapping past its 64 slots."""
    from sentinel_tpu_torch.core.registry import ENTRY_NODE_ROW
    from sentinel_tpu_torch.obs import resource_hist as rh
    from sentinel_tpu_torch.obs import telemetry as tel_mod
    t0 = 1_800_000_000_000
    clock = stt.ManualClock(start_ms=t0)
    sph = _obs_runtime(stt, R, clock, dev)
    tel = sph.telemetry
    rng = np.random.default_rng(61)
    ruled = sph.intern_resources([f"r{i}" for i in range(OBS_RULED)])
    pool = sph.intern_resources([f"u{i}" for i in range(20_000)])

    def host_check(tag):
        """The drained hot set against the state copied to the host."""
        with sph._lock:
            st = sph._state
            stamps = st.second.stamps.cpu().numpy()
            counters = st.second.counters.cpu().numpy()
            hist = st.rt_hist.cpu().numpy()
            spec = sph.spec
            idx_s = spec.second.index_of(clock.now_ms())
            sec = clock.now_ms() // 1000 - 1
            outs, _ = tel_mod.telemetry_tick(
                spec.second, spec.minute, tel.k, st.second, st.minute,
                st.rt_hist, tel_mod.init_ring(device=sph.device), idx_s,
                spec.minute.index_of(sec * 1000), 0)
            q_dev = outs[8].cpu().numpy()
        d = np.int32(idx_s) - stamps
        live = (d >= 0) & (d < spec.second.buckets)
        load = np.where(live, counters[:, :, 0] + counters[:, :, 1], 0) \
            .sum(axis=1).astype(np.int64)
        load[ENTRY_NODE_ROW] = -1
        order = np.argsort(-load, kind="stable")[:tel.k]
        vals, rows = tel.last_topk
        if list(rows) != list(order) or list(vals) != list(load[order]):
            fail(f"serving phase: telemetry top-K ({tag}) differs from the "
                 f"host recompute: {list(rows)} vs {list(order)}")
        want_q = rh.np_quantiles(hist[order])
        if not np.array_equal(q_dev, want_q):
            fail(f"serving phase: telemetry quantiles ({tag}) differ from "
                 f"np_quantiles")
        for h in tel.hot_entries():
            if h["rt_hist"] != hist[h["row"]].tolist():
                fail(f"serving phase: hot entry {h['resource']} carries "
                     f"another histogram than its row")
        ties = int(np.sum(load[order] == load[order][-1]))
        return ties, int(np.sum(load == load[order][-1]))

    # traffic with RT histograms: fused steps with exits
    prev = np.empty(0, np.int32)
    for step in range(4):
        clock.advance_ms(2)
        rows = np.where(rng.random(1 << 16) < 0.25,
                        ruled[rng.integers(0, OBS_RULED, 1 << 16)],
                        pool[rng.integers(0, pool.shape[0], 1 << 16)]
                        ).astype(np.int32)
        v = _fused_step(sph, rows, prev, set()).result()
        prev = rows[v.allow]
    # timed ticks (host ms; device ms between two events behind a hold)
    host_tick, host_total, dev_ms = [], [], []
    for i in range(ticks):
        clock.advance_ms(37)
        if dev == "cuda":
            sync()
            torch.cuda._sleep(int(cycles_per_ms * 20))
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
        t = time.perf_counter()
        with no_host_sync(dev == "cuda"):
            ok = tel.tick()
        t1 = time.perf_counter()
        if dev == "cuda":
            end.record()
        tel.drain()
        t2 = time.perf_counter()
        if not ok:
            fail("serving phase: a telemetry tick was dropped")
        host_tick.append((t1 - t) * 1e3)
        host_total.append((t2 - t) * 1e3)
        if dev == "cuda":
            dev_ms.append(start.elapsed_time(end))
    ties_a = host_check("traffic")
    # every one of 3000 fresh resources entered exactly 3 times: the hot
    # set is decided by the tie-break alone
    clock.advance_ms(1000)
    tied = sph.intern_resources([f"tie{i}" for i in range(3000)])
    sph.entry_batch(np.repeat(tied, 3))
    clock.advance_ms(1)
    tel.poll()
    ties_b = host_check("ties")
    if ties_b[1] < 3000 or ties_b[0] != tel.k:
        fail(f"serving phase: the tie drive did not tie: {ties_b}")
    # fill the ring past its slots: one event and one tick a second
    clock.advance_ms(2000)
    n_sec = tel.ring_slots + 6
    cursor0 = int(tel._ring.cursor)
    for i in range(n_sec):
        sph.entry_batch(ruled[:1])
        clock.advance_ms(1000)
        tel.poll()
    ring = {k: v.cpu().numpy() for k, v in tel._ring._asdict().items()}
    sec_now = clock.now_ms() // 1000 - 1
    want = list(range(sec_now - tel.ring_slots + 1, sec_now + 1))
    if int(ring["cursor"]) != cursor0 + n_sec or sorted(
            ring["seconds"].tolist()) != want:
        fail(f"serving phase: telemetry ring did not wrap: cursor "
             f"{int(ring['cursor'])}, seconds {sorted(ring['seconds'])[:4]}...")
    tl = tel.snapshot(timeline_limit=n_sec)["timeline"]
    if [e["sec"] for e in tl[-n_sec:]] != list(
            range(sec_now - n_sec + 1, sec_now + 1)) or any(
            e["pass"] != 1 for e in tl[-n_sec:]):
        fail("serving phase: the telemetry timeline does not hold one "
             "completed second a tick")
    snap = tel.snapshot()
    sph.close()
    res = {"tick_host_ms": summary(host_tick),
           "tick_drain_host_ms": summary(host_total),
           "tick_device_ms": summary(dev_ms) if dev_ms else None,
           "k": tel.k, "ticks": snap["ticks"], "drops": snap["drops"],
           "ties_in_topk": [ties_a[0], ties_b[0]],
           "rows_at_cut_load": [ties_a[1], ties_b[1]],
           "ring_cursor": int(ring["cursor"])}
    log(f"[serving] telemetry at R={R} (k={tel.k}): tick host ms median "
        f"{res['tick_host_ms']['median']:.3f}, tick+drain "
        f"{res['tick_drain_host_ms']['median']:.3f}"
        + (f", device {res['tick_device_ms']['median']:.3f}" if dev_ms
           else "")
        + f" ms; hot set and quantiles equal the host recompute (ties at "
        f"the cut: {ties_a[0]} and {ties_b[0]} of the top {tel.k}, "
        f"{ties_b[1]} rows at the cut's load); ring wrapped to cursor "
        f"{res['ring_cursor']}")
    return res


def phase_serving(stt, sa, dev="cuda", R=1 << 20, B=1 << 19, turns=11,
                  per_turn=6, requests=1 << 15, twin_rows=1 << 14,
                  duration_ms=1000, runs=OPEN_LOOP_RUNS,
                  batch_maxes=(256, 4096), tel_ticks=21, timer=None,
                  profile: bool = False) -> dict:
    """The serving tier through the entry points a service calls, at the
    default configuration with ``R`` rows and the scalar fixture's rules:

    (a) the same stream of fused scalar steps (``B`` events; exits = the
    admissions of the step four back) sequentially and through
    ``DispatchPipeline.submit_fused`` at depth 1, 2 and 4 on twin runtimes
    under twin ManualClocks, in turns: equal verdicts and state, host ms a
    step by depth, the staging ring's growth (``profile``: device ms a step
    and the busy share at depth 1 and 4);
    (b) ``requests`` single requests through ``sph.frontend(batch_max=4096,
    depth=2)`` replayed through ``entry_batch_nowait`` on a second runtime,
    and the same drive at ``twin_rows`` against a CPU twin;
    (c) the workload zoo open-loop on the wall clock at each ``batch_max``
    with a ``CadenceScheduler``: rates, request→verdict quantiles, flushes,
    and the invariants (each request settles once, none pending,
    enqueued = settled, offered = settled + shed, verdicts = the ENTRY
    row's PASS / OCCUPIED_PASS / BLOCK);
    (d) ``Sentinel.telemetry``: tick times, the hot set against a host
    recompute with ties, the ring wrapping.
    Submits run with the sync debug mode at "error"."""
    t_phase = time.perf_counter()
    res = {}
    res["pipeline"] = _serving_pipeline(stt, sa, dev, R, B, turns, per_turn,
                                        profile)
    res["batcher"] = _serving_batcher(stt, sa, dev, R, requests, twin_rows)
    res["open_loop"], ol_launches = _serving_open_loop(
        stt, sa, dev, R, duration_ms, runs, batch_maxes)
    res["telemetry"] = _serving_telemetry(
        stt, dev, R, tel_ticks, timer.cycles_per_ms if timer else 0.0)
    res["launches"] = (res["pipeline"]["launches"]
                       + res["batcher"]["launches"] + ol_launches)
    res["launches_per_step"] = res["pipeline"]["launches_per_step"]
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[serving] phase 9 took {res['seconds']:.1f} s; kernel launches "
        f"{res['launches']}")
    return res


# ---------------------------------------------------------------------------
# Phase 10: tiered resource state, single dispatch and the controller
# ---------------------------------------------------------------------------

TIER_TICK_MS = 100       # SENTINEL_TIER_TICK_MS of the churn legs
TIER_STEP_MS = 25        # virtual time a batch
TIER_PRIO = 0.25         # prioritized share (bookings ride demote/promote)


def _tier_runtime(stt, R: int, clock, dev, **env):
    """:func:`_obs_runtime` (default configuration, the scalar fixture's
    rules) constructed with the ``SENTINEL_*`` knobs in ``env`` set."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        return _obs_runtime(stt, R, clock, dev)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _tier_stream(universe: int, B: int, batches: int, seed: int):
    """``batches`` batches of ``B`` names, Zipf(1.1) over ``universe``
    ranks (rank k <= 4096 is the ruled ``r{k-1}``, the rest ``u{k}``),
    ``TIER_PRIO`` of each prioritized."""
    from sentinel_tpu_torch.frontend.workloads import _zipf_ranks
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        ranks = _zipf_ranks(rng, B, 1.1, universe)
        names = [f"r{k - 1}" if k <= OBS_RULED else f"u{k}"
                 for k in ranks.tolist()]
        out.append((names, rng.random(B) < TIER_PRIO))
    return out


def _tier_reload_rules(stt):
    """The mid-run reload: half the ruled resources keep their rule, 2048
    unruled ones gain one (new pins on keys that may be cold)."""
    return ([stt.FlowRule(resource=f"r{i}", count=50.0)
             for i in range(OBS_RULED // 2)]
            + [stt.FlowRule(resource=f"u{k}", count=40.0)
               for k in range(OBS_RULED + 1, OBS_RULED + 2049)])


def _cold_bytes(cold) -> int:
    """Host bytes of a cold tier's numpy payloads."""
    total = 0
    with cold._lock:
        entries = list(cold._entries.values())
    for e in entries:
        for v in vars(e).values():
            if isinstance(v, np.ndarray):
                total += v.nbytes
        for alt in e.alts.values():
            total += sum(a.nbytes for a in alt[:4])
    return total


def _tier_churn(stt, sa, dev, R, B, batches, hot_rows, universe, seed,
                names=("tiered", "tiered_sd0", "resident")):
    """(a)/(c) the churn legs: the same seeded traffic through
    ``entry_batch_nowait`` on twin runtimes in turns — ``tiered``
    (``SENTINEL_HOT_ROWS=hot_rows``), ``tiered_sd0`` (the same with
    ``SENTINEL_SINGLE_DISPATCH=0``) and ``resident``
    (``SENTINEL_TIERING_DISABLE=1``; ``universe`` must fit its table) —
    a flow-rule reload half way, ``TIER_STEP_MS`` a batch, each runtime's
    ``CadenceScheduler`` armed (telemetry 1 s, tiering ``TIER_TICK_MS``)
    and polled after every batch. Verdicts equal every batch, the
    count-min tables of the two tiered twins equal after every batch,
    kernel launches a step equal → the runtimes and the numbers."""
    t0 = 1_800_000_000_000
    envs = {"tiered": dict(SENTINEL_HOT_ROWS=hot_rows),
            "tiered_sd0": dict(SENTINEL_HOT_ROWS=hot_rows,
                               SENTINEL_SINGLE_DISPATCH=0),
            "resident": dict(SENTINEL_TIERING_DISABLE=1)}
    sph, sched = {}, {}
    for n in names:
        sph[n] = _tier_runtime(stt, R, stt.ManualClock(start_ms=t0), dev,
                               **envs[n])
        sched[n] = stt.CadenceScheduler(
            sph[n], telemetry_interval_sec=1.0,
            tiering_interval_sec=TIER_TICK_MS / 1000.0)
        # armed without the wall-clock daemon: poll() runs in turn
        sph[n].telemetry.arm_carry(1000)
        sph[n].tiering.arm_carry(TIER_TICK_MS)
    stream = _tier_stream(universe, B, batches, seed)
    reload_rules = _tier_reload_rules(stt)
    host_ms = {n: [] for n in names}
    launches = {n: [] for n in names}
    polls = {n: [] for n in names}
    verdicts = []
    blocked = granted = 0
    for step, (res, prio) in enumerate(stream):
        if step == batches // 2:
            for n in names:
                sph[n].load_flow_rules(reload_rules)
        got = {}
        order = names if step % 2 == 0 else names[::-1]
        for n in order:
            s = sph[n]
            sa.LAUNCHES.clear()
            t = time.perf_counter()
            with no_host_sync(dev == "cuda"):
                h = s.entry_batch_nowait(res, prioritized=prio)
            v = h.result()
            host_ms[n].append((time.perf_counter() - t) * 1e3)
            launches[n].append(sa.LAUNCHES["scatter_add"])
            got[n] = v
            s.clock.advance_ms(TIER_STEP_MS)
            t = time.perf_counter()
            sched[n].poll()
            polls[n].append((time.perf_counter() - t) * 1e3)
        ref = got[names[0]]
        verdicts.append((ref.allow, ref.reason, ref.wait_ms))
        for n in names[1:]:
            for f in ("allow", "reason", "wait_ms"):
                if not np.array_equal(getattr(got[n], f), getattr(ref, f)):
                    fail(f"tiering phase: {n} {f} differs from {names[0]} "
                         f"at batch {step}")
            if launches[n][-1] != launches[names[0]][-1]:
                fail(f"tiering phase: {n} launched {launches[n][-1]} at "
                     f"batch {step}, {names[0]} {launches[names[0]][-1]}")
        if "tiered_sd0" in sph and not torch.equal(
                sph["tiered"].tiering._sketch,
                sph["tiered_sd0"].tiering._sketch):
            fail(f"tiering phase: the count-min tables of single dispatch "
                 f"on and off differ at batch {step}")
        blocked += int(np.count_nonzero(~ref.allow))
        granted += int(np.count_nonzero(ref.allow & (ref.wait_ms > 0)))
    return sph, sched, {"host_ms": host_ms, "launches": launches,
                        "poll_ms": polls, "blocked": blocked,
                        "granted": granted, "verdicts": verdicts}


def _tier_snapshot(sph) -> dict:
    t = sph.tiering
    snap = dict(t.snapshot())
    snap["hit_rate"] = t.hit_rate()
    snap["cold_bytes"] = _cold_bytes(t.cold)
    return snap


def _tier_fused(stt, sph, B, steps, turns, per_turn):
    """(c) full-width fused decide+exit steps over the ruled (pinned)
    rows with both carries armed (telemetry 400 ms, tiering 150 ms), 50
    ms a step: one dispatch a batch, each service ticking once per due
    slot; then host ms a step armed and disarmed in turns (no tick due in
    a timed step: the clock stands still inside a turn, and one untimed
    armed step between turns runs the epilogue)."""
    from sentinel_tpu_torch.obs import counters as ck
    rows_all = sph.intern_resources([f"r{i}" for i in range(OBS_RULED)])
    rng = np.random.default_rng(67)
    w = 1.0 / np.arange(1, OBS_RULED + 1) ** 1.1
    stream = [rows_all[rng.choice(OBS_RULED, B, p=w / w.sum())]
              for _ in range(8)]
    prev = np.empty(0, np.int32)

    def step(i):
        nonlocal prev
        rows = stream[i % len(stream)]
        v = _fused_step(sph, rows, prev, set()).result()
        prev = rows[v.allow]

    tel, tier = sph.telemetry, sph.tiering
    t_arm = int(sph.clock.now_ms())
    tel.arm_carry(400)
    tier.arm_carry(150)
    base = sph.obs.counters.get(ck.PIPE_DISPATCH)
    sd0 = sph.obs.counters.get(ck.ROUTE_SINGLE_DISPATCH)
    tel0, tier0 = tel.snapshot()["ticks"], tier.snapshot()["ticks"]
    times = []
    for i in range(steps):
        times.append(int(sph.clock.now_ms()))
        with no_host_sync(sph.device.type == "cuda"):
            step(i)
        tel.drain()             # what the scheduler's daemon does
        tier.drain()
        sph.clock.advance_ms(50)

    def claims(interval):
        last, n = t_arm, 0
        for t in times:
            if t - last >= interval:
                last, n = t, n + 1
        return n

    res = {"steps": steps,
           "dispatches": sph.obs.counters.get(ck.PIPE_DISPATCH) - base,
           "single_dispatch": (sph.obs.counters.get(ck.ROUTE_SINGLE_DISPATCH)
                               - sd0),
           "tel_ticks": tel.snapshot()["ticks"] - tel0,
           "tel_claims": claims(400),
           "tier_ticks": tier.snapshot()["ticks"] - tier0,
           "tier_claims": claims(150)}
    if (res["dispatches"] != steps or res["single_dispatch"] != steps
            or res["tel_ticks"] != res["tel_claims"]
            or res["tier_ticks"] != res["tier_claims"]
            or res["tier_claims"] < 3):
        fail(f"tiering phase: single dispatch with both carries armed: "
             f"{res}")
    # armed vs disarmed host ms a step, in turns
    host = {"armed": [], "disarmed": []}
    for turn in range(turns):
        for mode in (("armed", "disarmed") if turn % 2 == 0
                     else ("disarmed", "armed")):
            if mode == "armed":
                sph.clock.advance_ms(500)       # an untimed epilogue step
                tel.arm_carry(200)
                tier.arm_carry(200)
                sph.clock.advance_ms(250)
                step(turn)
                tel.drain()
                tier.drain()
            else:
                tel.disarm_carry()
                tier.disarm_carry()
            for i in range(per_turn):
                t = time.perf_counter()
                with no_host_sync(sph.device.type == "cuda"):
                    step(i)
                host[mode].append((time.perf_counter() - t) * 1e3)
    tel.disarm_carry()
    tier.disarm_carry()
    res["host_ms"] = {k: dict(summary(v), q1=float(np.percentile(v, 25)),
                              q3=float(np.percentile(v, 75)))
                      for k, v in host.items()}
    return res


def _tier_serving(stt, sa, dev, R, requests, hot_rows, cold_max, timer):
    """(b) the serving half of the reference's gate (l): ``requests``
    single requests, Zipf(1.1) over a 16,000,000-key universe, through
    ``sph.frontend(batch_max=4096, depth=2)`` under a ManualClock, one
    full flush at a time, ``TIER_STEP_MS`` a flush, the tiering ticker
    polled after each (``SENTINEL_HOT_ROWS=hot_rows``,
    ``SENTINEL_TIER_COLD_MAX=cold_max``); host ms a flush split into
    intern, demote gather and promote restore; device ms of the sketch
    update, the decay+estimate over every row and the row-slice
    extract/restore (CUDA events, ``timer``)."""
    import asyncio
    from sentinel_tpu_torch.frontend.workloads import _zipf_ranks
    from sentinel_tpu_torch.tiering import sketch as sk
    from sentinel_tpu_torch.engine import pipeline as pl
    t0 = 1_800_000_000_000
    sph = _tier_runtime(stt, R, stt.ManualClock(start_ms=t0), dev,
                        SENTINEL_HOT_ROWS=hot_rows,
                        SENTINEL_TIER_COLD_MAX=cold_max)
    sched = stt.CadenceScheduler(sph, telemetry_interval_sec=1.0,
                                 tiering_interval_sec=TIER_TICK_MS / 1000.0)
    sph.telemetry.arm_carry(1000)
    sph.tiering.arm_carry(TIER_TICK_MS)
    rng = np.random.default_rng(15)
    ranks = _zipf_ranks(rng, requests, 1.1, 16_000_000)
    names = [f"zipf/r{k}" for k in ranks.tolist()]
    spent = collections.defaultdict(float)

    def timed(key, fn):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[key] += time.perf_counter() - t
        return wrapper

    sph.intern_resources = timed("intern", sph.intern_resources)
    tier = sph.tiering
    tier.pre_invalidate_locked = timed("demote_gather",
                                       tier.pre_invalidate_locked)
    tier.post_invalidate_locked = timed("promote_restore",
                                        tier.post_invalidate_locked)
    tier.drain = timed("tier_drain", tier.drain)
    sa.LAUNCHES.clear()
    chunk = 4096
    settled = []
    flush_ms = []

    async def run():
        b = sph.frontend(batch_max=chunk, depth=2, deadline_ms=60_000,
                         idle_ms=60_000.0, queue_max=2 * chunk)
        for i in range(0, requests, chunk):
            t = time.perf_counter()
            vs = await asyncio.gather(*(b.submit(r)
                                        for r in names[i:i + chunk]))
            flush_ms.append((time.perf_counter() - t) * 1e3)
            settled.extend(vs)
            sph.clock.advance_ms(TIER_STEP_MS)
            sched.poll()
        await b.drain()
        pending = b.pending
        b.close()
        return pending

    t = time.perf_counter()
    with no_host_sync(dev == "cuda"):
        pending = asyncio.run(asyncio.wait_for(run(), 900))
    wall = time.perf_counter() - t
    launches = sa.LAUNCHES["scatter_add"]
    snap = _tier_snapshot(sph)
    flushes = len(flush_ms)
    res = {"requests": requests, "distinct_keys": len(set(names)),
           "settled": len(settled), "pending": pending, "wall_s": wall,
           "flush_host_ms": summary(flush_ms),
           "host_ms_per_flush": {k: v * 1e3 / flushes
                                 for k, v in spent.items()},
           "tiering": snap, "launches": launches,
           "blocked": sum(1 for v in settled if not v.allow)}
    problems = []
    if len(settled) != requests or pending:
        problems.append(f"{len(settled)} of {requests} settled, {pending} "
                        f"pending")
    if not (snap["promoted"] > 0 and snap["demoted"] > 0):
        problems.append(f"no migration: {snap}")
    if snap["resident"] > R:
        problems.append(f"resident {snap['resident']} > the table {R}")
    if problems:
        fail("tiering phase (serving): " + "; ".join(problems))
    if timer is not None:
        dev_ms = {}
        sketch = tier._sketch
        for n in (1 << 12, 1 << 16):
            items = torch.from_numpy(np.where(
                rng.random(n) < 0.75, rng.integers(1, R, n), R
            ).astype(np.int32)).to(dev)
            valid = items < R
            dev_ms[f"sketch_update_{n}"] = summary(timer.warm(
                {"f": lambda i=items, v=valid: sk.update_sketch(sketch, i,
                                                                v)},
                rounds=3, iters=10)["f"])
        dev_ms[f"decay_estimate_{R}"] = summary(timer.warm(
            {"f": lambda: sk.tick_read(sketch, R)}, rounds=3, iters=5)["f"])
        k = 4096
        rows = torch.from_numpy(np.asarray(
            [r for _n, r in sph.resources.items()][:k], np.int32)).to(dev)
        alt = torch.full((k,), sph.spec.alt_rows, dtype=torch.int32,
                         device=dev)
        with sph._lock:
            payload = pl.extract_resource_rows(sph.spec, sph._state, rows,
                                               alt)
            dev_ms[f"extract_{k}"] = summary(timer.warm(
                {"f": lambda: pl.extract_resource_rows(
                    sph.spec, sph._state, rows, alt)},
                rounds=3, iters=10)["f"])
            # restore the rows' own slices back: the state is unchanged
            dev_ms[f"restore_{k}"] = summary(timer.warm(
                {"f": lambda: pl.restore_resource_rows(
                    sph.spec, sph._state, rows, payload, alt)},
                rounds=3, iters=10)["f"])
        res["device_ms"] = dev_ms
    sph.close()
    return res


def _tier_controller(stt, sa, dev, R, duration_ms, rate, turns):
    """(d) the workload zoo's ``steady`` at ``rate`` req/s offered
    through ``AdaptiveBatcher(batch_max=4096, deadline 25 ms)`` on the
    wall clock with a ``CadenceScheduler``, with a
    ``ControlLoop(sph, batcher, interval_ms=50)`` and without, in turns
    (off, on, on, off, ...); then the ``Degrade`` actuator forces a real
    breaker (held against ``breaker_states()`` and an ``entry``)."""
    from sentinel_tpu_torch import control
    from sentinel_tpu_torch.frontend import workloads
    from sentinel_tpu_torch.obs import counters as ck
    sph = _obs_runtime(stt, R, stt.SystemClock(), dev)
    sph.load_flow_rules(_open_loop_rules(stt))
    sched = stt.CadenceScheduler(sph, telemetry_interval_sec=1.0)
    sched.start()
    _open_loop_run(stt, sph, workloads.make(
        "steady", 1, duration_ms=min(300.0, duration_ms),
        rate_rps=20_000.0), 4096, min(300.0, duration_ms), False)
    out = {"on": [], "off": []}
    launches = 0
    loops = []
    for turn in range(turns):
        mode = "on" if turn % 4 in (1, 2) else "off"
        reqs = workloads.make("steady", 7 + turn, duration_ms=float(
            duration_ms), rate_rps=float(rate))
        sph.obs.counters.clear()
        sph.obs.hist_request.clear()
        sa.LAUNCHES.clear()
        hook = None
        if mode == "on":
            def hook(b):
                loops.append(control.ControlLoop(sph, b, interval_ms=50))
        res, problems = _open_loop_run(stt, sph, reqs, 4096, duration_ms,
                                       dev == "cuda", on_batcher=hook)
        launches += sa.LAUNCHES["scatter_add"]
        if problems:
            fail(f"tiering phase (controller {mode}): " + "; ".join(problems))
        c = sph.obs.counters.snapshot()
        if mode == "on":
            ctl = loops[-1]
            kinds = collections.Counter(a["kind"] for a in ctl.action_log())
            res["actions"] = dict(kinds)
            res["admit_frac"] = ctl.policy.admit_frac
            res["controller_ticks"] = ctl.snapshot()["ticks"]
            res["admission_dropped"] = c.get(ck.CONTROL_DROPPED, 0)
            ctl.enabled = False          # detached for the next turns
            del sph.control
        res["admitted_fraction"] = res["settled"] / max(1, res["offered"])
        out[mode].append(res)
        log(f"[tiering] controller {mode}: steady {rate}/s offered, "
            f"{res['decisions_per_s']:.0f} decisions/s, admitted "
            f"{res['admitted_fraction']:.3f}, shed {res['shed']}, p50 "
            f"{res['p50_ms']:.2f} p99 {res['p99_ms']:.2f} ms"
            + (f"; actions {res['actions']}, admit_frac "
               f"{res['admit_frac']:.3f}, controller ticks "
               f"{res['controller_ticks']}" if mode == "on" else ""))
    sched.stop()
    if not any(sum(r["actions"].values()) for r in out["on"]):
        fail("tiering phase: the controller took no action under overload")
    act = control.Actuators(sph)
    slot = 5
    res_name = f"r{slot}"
    note = act.apply(control.Degrade(res_name, "open"))
    opened = sph.breaker_states()[slot]
    try:
        sph.entry(res_name).exit()
        denied = False
    except stt.DegradeException:
        denied = True
    act.apply(control.Degrade(res_name, "close"))
    closed = sph.breaker_states()[slot]
    if note != f"{res_name}->open" or opened != 1 or not denied \
            or closed != 0:
        fail(f"tiering phase: the Degrade actuator did not force the "
             f"breaker: note {note}, states {opened} -> {closed}, denied "
             f"{denied}")
    sph.close()
    return {"turns": out, "degrade": {"note": note, "opened": opened,
                                      "closed": closed, "denied": denied},
            "launches": launches}


def phase_tiering(stt, sa, dev="cuda", R=1 << 20, B=1 << 16, batches=32,
                  hot_rows=1 << 16, twin_rows=1 << 14, twin_B=1 << 12,
                  twin_hot=1 << 13, requests=1 << 18, serve_hot=1 << 15,
                  cold_max=1 << 21, fused_steps=30, turns=11, per_turn=3,
                  ctl_duration_ms=1000, ctl_rate=80_000, ctl_turns=4,
                  timer=None, profile: bool = False) -> dict:
    """Tiered resource state, single-dispatch serving and the overload
    controller through the entry points a service calls, the default
    configuration and the scalar fixture's rules at ``R`` rows:

    (a) churn parity: ``batches`` batches of ``B`` names, Zipf(1.1) over
    ``R - 4096`` names, 25% prioritized, a reload half way, 25 ms a
    batch, a ``CadenceScheduler`` armed at 100 ms — a tiered runtime
    (``SENTINEL_HOT_ROWS=hot_rows``) against an all-resident one: equal
    verdicts every batch, equal kernel launches a batch; the same leg at
    ``twin_rows`` rows on the card against a CPU twin: equal verdicts,
    state, sketch, cold tier and counters;
    (b) :func:`_tier_serving`;
    (c) the (a) traffic with ``SENTINEL_SINGLE_DISPATCH=0`` in turns with
    the tiered runtime (equal verdicts and count-min tables every batch),
    then :func:`_tier_fused`;
    (d) :func:`_tier_controller`."""
    from sentinel_tpu_torch import convert
    t_phase = time.perf_counter()
    res = {}
    launches = 0
    sph, _sched, churn = _tier_churn(stt, sa, dev, R, B, batches, hot_rows,
                                     R - OBS_RULED, seed=1501)
    launches += sum(churn["launches"]["tiered"])
    lps = sorted(set(churn["launches"]["tiered"]))
    snap = {n: _tier_snapshot(s) for n, s in sph.items()}
    t, t0_ = snap["tiered"], snap["tiered_sd0"]
    if snap["resident"]["demoted"] or not (t["demoted"] > 0
                                           and t["promoted"] > 0):
        fail(f"tiering phase: churn did not migrate (or the resident twin "
             f"did): {snap}")
    if any(t[k] != t0_[k] for k in ("hot_hit", "cold_miss", "promoted",
                                    "demoted", "cold", "resident")):
        fail(f"tiering phase: single dispatch on and off migrated "
             f"differently: {t} vs {t0_}")
    c_on = sph["tiered"].obs.counters.snapshot()
    c_off = sph["tiered_sd0"].obs.counters.snapshot()
    res["churn"] = {
        "batches": batches, "B": B, "hot_rows": hot_rows,
        "blocked": churn["blocked"], "granted": churn["granted"],
        "launches_per_step": lps, "tiering": snap,
        "host_ms": {n: summary(v) for n, v in churn["host_ms"].items()},
        "poll_ms": {n: summary(v) for n, v in churn["poll_ms"].items()},
        "dispatches": {"sd1": c_on.get("pipeline.dispatches", 0),
                       "sd0": c_off.get("pipeline.dispatches", 0)},
        "single_dispatch": {"sd1": c_on.get("split_route.single_dispatch",
                                            0),
                            "sd0": c_off.get("split_route.single_dispatch",
                                             0)}}
    log(f"[tiering] churn at R={R}: {batches} batches of {B}, Zipf(1.1) "
        f"over {R - OBS_RULED} names, 25% prioritized, reload at "
        f"{batches // 2}: tiered == resident == single dispatch off, "
        f"every batch ({churn['blocked']} blocked, {churn['granted']} "
        f"occupy grants); launches a step {lps}; promoted {t['promoted']}, "
        f"demoted {t['demoted']}, hit rate {t['hit_rate']:.4f}, migrate "
        f"p50 {t['migrate_p50_ms']} p99 {t['migrate_p99_ms']} ms; cold "
        f"{t['cold']} entries, {t['cold_bytes'] / 2**20:.1f} MiB on the "
        f"host; host ms a batch tiered "
        f"{res['churn']['host_ms']['tiered']['median']:.2f}, resident "
        f"{res['churn']['host_ms']['resident']['median']:.2f}, poll "
        f"{res['churn']['poll_ms']['tiered']['median']:.2f}; dispatches "
        f"{res['churn']['dispatches']}")
    if profile and dev == "cuda":
        s = sph["tiered"]
        prof_stream = _tier_stream(R - OBS_RULED, B, 2, seed=1601)

        def run_steps():
            for names, prio in prof_stream:
                s.entry_batch_nowait(names, prioritized=prio).result()
                s.clock.advance_ms(TIER_STEP_MS)
                _sched["tiered"].poll()
        res["churn"]["profile"] = _profile_steps(
            run_steps, 2, "tiering_trace.json", keep_trace=False)
    for s in sph.values():
        s.close()
    del sph, _sched
    # the same leg at twin_rows: the card against the CPU
    twin = {}
    for d in (dev, "cpu"):
        s2, _sc, ch = _tier_churn(stt, sa, d, twin_rows, twin_B, batches,
                                  twin_hot, 1 << 16, seed=2026,
                                  names=("tiered",))
        s = s2["tiered"]
        twin[d] = (ch["verdicts"], _tier_snapshot(s),
                   convert.engine_to_numpy(s),
                   convert.cold_tier_to_numpy(s.tiering.cold),
                   {k: v for k, v in s.obs.counters.snapshot().items()},
                   ch["blocked"], ch["granted"])
        if d == dev:
            launches += sum(ch["launches"]["tiered"])
        s.close()
    _tier_twin_equal(twin[dev], twin["cpu"])
    res["twin"] = {"rows": twin_rows, "B": twin_B, "hot_rows": twin_hot,
                   "tiering": twin[dev][1], "blocked": twin[dev][5]}
    log(f"[tiering] churn at R={twin_rows} (B={twin_B}, hot rows "
        f"{twin_hot}): the card == the CPU twin (verdicts, state, sketch, "
        f"{twin[dev][1]['cold']} cold entries, counters); promoted "
        f"{twin[dev][1]['promoted']}, demoted {twin[dev][1]['demoted']}")
    # (c) the fused path: one dispatch a batch, host ms armed / disarmed
    s = _tier_runtime(stt, R, stt.ManualClock(start_ms=1_800_000_000_000),
                      dev, SENTINEL_HOT_ROWS=hot_rows)
    sa.LAUNCHES.clear()
    res["fused"] = _tier_fused(stt, s, B, fused_steps, turns, per_turn)
    launches += sa.LAUNCHES["scatter_add"]
    s.close()
    hm = res["fused"]["host_ms"]
    log(f"[tiering] fused steps of {B} with both carries armed: "
        f"{res['fused']['dispatches']} dispatches in "
        f"{res['fused']['steps']} batches, telemetry ticks "
        f"{res['fused']['tel_ticks']} of {res['fused']['tel_claims']} due, "
        f"tiering {res['fused']['tier_ticks']} of "
        f"{res['fused']['tier_claims']}; host ms a step armed median "
        f"{hm['armed']['median']:.2f} (IQR {hm['armed']['q1']:.2f}-"
        f"{hm['armed']['q3']:.2f}), disarmed {hm['disarmed']['median']:.2f} "
        f"(IQR {hm['disarmed']['q1']:.2f}-{hm['disarmed']['q3']:.2f}), "
        f"{hm['armed']['n']} steps each")
    # (b) the serving half
    res["serving"] = _tier_serving(stt, sa, dev, R, requests, serve_hot,
                                   cold_max, timer)
    launches += res["serving"]["launches"]
    sv, st = res["serving"], res["serving"]["tiering"]
    log(f"[tiering] serving: {requests} requests, Zipf(1.1) over 16M keys "
        f"({sv['distinct_keys']} distinct) through sph.frontend("
        f"batch_max=4096, depth=2), hot rows {serve_hot}, cold max "
        f"{cold_max}: hit rate {st['hit_rate']:.4f}, promoted "
        f"{st['promoted']}, demoted {st['demoted']}, sketch_overflow "
        f"{st['sketch_overflow']}, resident {st['resident']}, cold "
        f"{st['cold']} ({st['cold_bytes'] / 2**20:.1f} MiB, dropped "
        f"{st['cold_dropped']}); host ms a flush "
        + ", ".join(f"{k} {v:.2f}"
                    for k, v in sv["host_ms_per_flush"].items())
        + f" of {sv['flush_host_ms']['median']:.2f} (median)"
        + ("; device ms " + ", ".join(
            f"{k} {v['median']:.4f}" for k, v in sv["device_ms"].items())
           if "device_ms" in sv else ""))
    # (d) the controller
    res["controller"] = _tier_controller(stt, sa, dev, R, ctl_duration_ms,
                                         ctl_rate, ctl_turns)
    launches += res["controller"]["launches"]
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[tiering] phase 10 took {res['seconds']:.1f} s; kernel launches "
        f"{launches}")
    return res


def _tier_twin_equal(a, b) -> None:
    """The card's and the CPU twin's churn leg agree: verdicts every
    batch, tiering snapshots (less the wall-clock migration times),
    state and sketch, cold tiers, counters."""
    from sentinel_tpu_torch import convert
    for i, (x, y) in enumerate(zip(a[0], b[0])):
        if not all(np.array_equal(p, q) for p, q in zip(x, y)):
            fail(f"tiering phase: twin verdicts differ at batch {i}")
    sa_, sb = dict(a[1]), dict(b[1])
    for snap in (sa_, sb):
        for k in ("migrate_p50_ms", "migrate_p99_ms"):
            snap[k] = snap[k] is not None
    if sa_ != sb:
        fail(f"tiering phase: twin tiering snapshots differ: {sa_} vs {sb}")
    diff = convert.leaf_diff(a[2], b[2])
    if diff or set(a[2]) != set(b[2]):
        fail(f"tiering phase: twin state or sketch differs: {diff}")
    if list(a[3]) != list(b[3]):
        fail("tiering phase: twin cold tiers hold other names")
    for name in a[3]:
        if sorted(a[3][name]) != sorted(b[3][name]) or any(
                not np.array_equal(a[3][name][k], b[3][name][k])
                for k in a[3][name]):
            fail(f"tiering phase: twin cold entry {name} differs")
    if a[4] != b[4] or a[5:] != b[5:]:
        fail("tiering phase: twin counters or verdict tallies differ")



def find_syncs(stt, sa) -> int:
    """``--find-syncs``: every place where a kernel-run engine step waits
    on the device, with the port's frames of its stack (the sync debug
    mode at "warn" over 3 steps of each engine phase)."""
    import traceback
    import warnings
    sites = {}

    def show(message, *_args, **_kw):
        frames = [f for f in traceback.extract_stack()
                  if "sentinel_tpu_torch" in f.filename]
        key = tuple((os.path.basename(f.filename), f.lineno)
                    for f in frames)
        if frames and key not in sites:
            sites[key] = frames
            log(f"[sync] {str(message)[:60]}")
            for f in frames[-4:]:
                log(f"[sync]   {os.path.relpath(f.filename)}:{f.lineno} "
                    f"{f.line}")

    warnings.showwarning = show
    warnings.simplefilter("always")
    no_host_sync.mode = "warn"
    phase_engine(stt, sa, steps=3)
    phase_prio_engine(stt, sa, "prio", steps=5)
    phase_prio_engine(stt, sa, "prio_mixed", steps=5)
    phase_origin_engine(stt, sa, "general", steps=3)
    phase_origin_engine(stt, sa, "general", steps=3, prio=0.125,
                        step_ms=250)
    phase_origin_engine(stt, sa, "fast", R=1 << 17, steps=3)
    phase_param_engine(stt, sa, steps=3)
    phase_origin_engine(stt, sa, "general", steps=3, param=True)
    phase_obs_runtime(stt, sa, steps=3)
    phase_serving(stt, sa, turns=2, per_turn=3, requests=1 << 12,
                  duration_ms=300, runs=(("steady", 20_000),),
                  batch_maxes=(256,), tel_ticks=3)
    phase_tiering(stt, sa, batches=8, requests=1 << 16, serve_hot=1 << 13,
                  fused_steps=12, turns=2, per_turn=2, ctl_turns=2)
    log(f"[sync] {len(sites)} place(s) wait on the device in a step")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the GPU only")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import sentinel_tpu_torch as stt
        from sentinel_tpu_torch.obs.resource_hist import DEFAULT_BUCKETS
        from sentinel_tpu_torch.ops import _build
        from sentinel_tpu_torch.ops import scatter_add as sa
    except ImportError as exc:
        fail(f"sentinel_tpu_torch not importable next to this script: {exc}")
    if not os.path.abspath(stt.__file__).startswith(here + os.sep):
        fail(f"sentinel_tpu_torch comes from {stt.__file__}, not from the "
             f"checkout that holds this script")
    if any(m == "jax" or m.startswith(("jax.", "sentinel_tpu."))
           or m == "sentinel_tpu" for m in sys.modules):
        fail("the port imported JAX or the JAX package")
    # the runtimes' block logs and record log go to a directory of this
    # run, removed at exit
    import tempfile
    log_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_logs_")
    os.environ["SENTINEL_TPU_LOG_DIR"] = log_dir.name

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "unknown"
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    if "--find-syncs" in sys.argv[1:]:
        phase_build(_build)
        return find_syncs(stt, sa)
    t_all = time.perf_counter()
    report = {"card": card, "torch": torch.__version__}
    report["build"] = phase_build(_build)
    timer = CudaTimer()
    report["kernel_cases"] = phase_kernels(sa, DEFAULT_BUCKETS, timer=timer)
    profile = "--profile" in sys.argv[1:]
    report["engine"] = phase_engine(stt, sa, profile=profile)
    report["prio"] = phase_prio_engine(stt, sa, "prio", profile=profile)
    report["prio_mixed"] = phase_prio_engine(stt, sa, "prio_mixed",
                                             profile=profile)
    report["general"] = phase_origin_engine(stt, sa, "general",
                                            profile=profile)
    report["general_occupy"] = phase_origin_engine(
        stt, sa, "general", steps=6, prio=0.125, step_ms=250,
        profile=profile)
    report["fast"] = phase_origin_engine(stt, sa, "fast", R=1 << 17,
                                         profile=profile)
    report["scalar_param"] = phase_param_engine(stt, sa, profile=profile)
    report["general_param"] = phase_origin_engine(
        stt, sa, "general", param=True, profile=profile)
    report["runtime"] = phase_runtime(stt, sa)
    report["fast_path"] = phase_fast_path_runtime(stt, sa)
    report["param_runtime"] = phase_param_runtime(stt, sa)
    report["obs_runtime"] = phase_obs_runtime(stt, sa, profile=profile)
    report["serving"] = phase_serving(stt, sa, timer=timer, profile=profile)
    report["tiering"] = phase_tiering(stt, sa, timer=timer, profile=profile)
    report["seconds"] = time.perf_counter() - t_all

    decide = report["kernel_cases"][0]
    # the main path's launches: each path's run, counted from 0
    launches = sum(report[p]["launches"] for p in (
        "engine", "prio", "prio_mixed", "general", "general_occupy", "fast",
        "scalar_param", "general_param", "runtime", "fast_path",
        "param_runtime", "obs_runtime", "serving", "tiering"))
    kernels = [{
        "name": "scatter_add", "route": "cuda",
        "source": "sentinel_tpu_torch/csrc/scatter_add.cu",
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in report["kernel_cases"]),
        "ms": decide["cold"]["kernel"]["median"],
        "plain_ms": decide["plain_ms"],
        "bound_ms": decide["bound_ms"], "bound_by": "bytes",
        "library_ms": decide["cold"]["library"]["median"],
    }]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    log(f"[done] {report['seconds']:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
