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
11. drives the cluster token tier on the card: (a) ``ClusterEngine`` at
   the JAX bench's config 5 geometry (8 logical shards, 4096 flow rows over
   4 namespaces, 2^16 hot-key rows, 4 values a param request), 16 steps of
   2^16 requests 10 ms apart (3/4 flow requests, Zipf(1.1) ids, 1/8
   prioritized; 1/4 param requests with 1–4 Zipf user ids) with the
   kernel, with the plain seam and on the CPU — equal verdicts, windows,
   ``flow_metrics`` and ``top_params``, 3 launches an engine step, a
   saturated 3e9 AVG_LOCAL threshold; pipelined at depth 8; 8 steps at
   2^18; (b) a ``ClusterTokenServer`` on loopback with 8 client threads
   (2048 single calls and 32 batches of 256 each): exactly C grants under
   a frozen clock, PING-tripled AVG_LOCAL, concurrent tokens through the
   lease sweep, round-trip p50/p99; (c) ``Sentinel(device="cuda")`` at 1M
   rows with 64 cluster flow and 16 cluster param rules served by an
   embedded ``ClusterCoordinator``: 1024 ``entry()``+exit calls and
   batches of 2^16 with origins, the service uninstalled half way, equal
   to the same drive at 16k rows on the card and on the CPU;
12. drives the command plane: ``Sentinel(device="cuda")`` at 1M rows
   (default configuration) behind ``start_transport(port=0)``; over
   loopback HTTP ``setRules`` of 4096 flow, 1024 degrade, 1 system and 64
   authority rules and ``setParamFlowRules`` of 512; 4096
   ``api.entry``+exit calls, 2048 ``@sentinel_resource`` calls and 2048
   WSGI requests; 16 fused full-width steps (2^19 events) with a second
   thread polling ``metric``, ``clusterNode`` and ``obs`` over HTTP and a
   ``setRules`` reload half way through a writable file datasource that a
   file datasource brings back; ``setClusterMode`` to the embedded token
   server, ``cluster/server/modifyFlowRules``, 1024 cluster-ruled
   ``entry()``+exit and ``cluster/server/metricList``; the same session
   at 16k rows on the card, with the plain seam and on the CPU (each in
   a process of its own, ``--cp-twin``, beside the 1M run) must give the
   same verdicts and response bodies (the twins the same state); then,
   alone, the round trips, rule loads, per-call and per-step times with
   polls on and off, in turns;
13. drives the API gateway, the Prometheus exporter and the native
   interning tables: ``Sentinel(device="cuda")`` at 1M rows (default
   configuration: the C++ tables; the scalar fixture's flow rules and a
   system rule) behind ``start_transport(port=0, gateway_manager=,
   api_definition_manager=, exporter_port=9464)``; over loopback HTTP 16
   API groups and 256 gateway rules on 64 routes and those groups (route
   QPS, client IP, header, URL param, cookie, host; intervals, bursts,
   RATE_LIMITER, THREAD); 2048 requests through
   ``SentinelGatewayASGIMiddleware`` on an asyncio loop (Zipf(1.1)
   routes and client IPs, 20% in an API group; every request inbound,
   so each entry a device decide through the param slot); one exporter
   scrape. The same session at 16k rows on the card, with the plain seam
   and on the CPU (``--gw-twin``, processes of their own) must give the
   same statuses, pacing waits, bodies and samples. Then alone: µs a
   request, the rule push, ms a scrape, and the native tables against
   the Python ones in turns (an intern of 2^16 names, ``entry_batch`` of
   2^16 fresh names, phase 7's 2^19-event pair resolution; equal rows
   and verdicts). Phases 9 and 10 run under ``SENTINEL_TPU_NATIVE=0``
   (the Python tables, as before), but for one churn turn of phase 10
   with the native tables;
14. drives the dashboard and the outbound, aiohttp and gRPC adapters:
   ``Sentinel(device="cuda")`` at 1M rows (default configuration) behind
   ``start_transport(port=0, metric_log=True, dashboard_addr=,
   gateway_manager=, api_definition_manager=)``, registered by its
   heartbeat with the port's ``DashboardServer(port=0)``, which runs with
   a password in a process of its own (``--dashboard``); over the
   dashboard's REST API, as its single-page app sends them: a login, the
   CRUD of 256 flow, 64 degrade, 1 system, 16 authority, 64 param, 64
   gateway flow and 8 API-group rules through ``/v1/{type}/rule`` (every
   change republishes the app's full set to the agent); 512
   ``entry()``+exit calls and 6 fused full-width steps (2^19 events);
   a fetch into the metric repository and every route the app reads
   (metrics, machine resources, the node tree, origins, system status,
   telemetry, the hot resources with a device tick, the controller,
   traces, cluster state, the one-click token-server assignment and its
   server config), a machine removed and re-registered by a heartbeat;
   then ``guarded_urlopen``, ``SentinelSession``, the gRPC interceptors
   and the aiohttp middleware and session on the same runtime (each
   package's legs where it is installed; the absent ones are named).
   The same session at 16k rows on the card, with the plain seam and on
   the CPU (``--db-twin``, processes of their own) must give the same
   verdicts, response bodies, repositories and adapter totals (the
   twins the same state). Then, alone: µs per route, ms per rule push
   with 4096 flow rules held, and host ms per fused step with the
   dashboard at its real cadence (the fetcher every 6 s, browsers on the
   Resources view every 3 s and on Hot Resources every 5 s, the app list
   every 10 s) and stopped, in 2 turns;
15. drives the autotuner, warm-restart snapshots, the build cache and the
   gRPC token and Envoy RLS servers (``tune_snapshot_grpc``): (a)
   ``tune.run_sweep`` at the reference's defaults (pipeline depth x
   frontend batch, the zoo's ``steady`` at 2000 req/s, SLO p99 50 ms,
   rungs 150/450 ms) writes ``TUNED.json`` under the card's fingerprint,
   then runtimes at 1M rows start on it (``tune.config_loaded``,
   ``frontend()`` and ``DispatchPipeline`` take its values), on a copy
   fingerprinted ``TPU v5 lite`` (``tune.fingerprint_fallback``, defaults)
   and with a typo'd knob (``tune.knob_rejected``), each against a CPU
   twin at 16k rows; (b) a 1M-row runtime after 8 fused steps of 512k
   events whose breakers trip is saved and restored (same rules
   ``"full"``, the next 8 steps' verdicts and state equal to the
   original's; changed rules ``"partial"``, windows equal; another
   geometry ``False``; 256k rows if the temporary disk holds less than
   twice the state), and a 16k-row snapshot written on the card restores
   on the CPU with the same following verdicts and state; (c) the
   runtime's ``compile_cache.*``, and two processes on a fresh
   ``SENTINEL_COMPILE_CACHE``: the second compiles nothing (ms to the
   first launch each); (d) phase 11's engine behind ``TokenGrpcServer``:
   64 mixed batches of 256 equal to a CPU twin engine, round trips of 1
   and 256 items from one client without a deadline, then 8 client
   threads for 5 s (round trips, decided items a second, STATUS_FAIL at
   the 20 ms deadline), and ``entry()`` through a ``Sentinel`` whose token
   service is the gRPC client; (e) ``SentinelRlsGrpcServer`` with rules
   on 16 domains: 4096 ``ShouldRateLimit`` frames, Zipf(1.1) over the
   descriptors, some with an undeclared field, every code equal to a CPU
   twin service (legs (d) and (e) are reported, not run, without
   ``grpc`` or ``google.protobuf``);
16. runs the port's analyzer and its SPI demos (``analysis_demos``): (a)
   ``python -m sentinel_tpu_torch.analysis`` over the port's lint scope
   (``sentinel_tpu_torch/``, this script, ``tests/test_torch_*.py``,
   ``demos/torch/``; ``docs/LINT_TORCH.md``) with its baseline at
   ``--jobs 1`` and ``--jobs 4``: 0 unsuppressed findings, the same
   findings from both, the wall seconds and the suppressed count by rule;
   (b) ``demos/torch/slot_spi.py``, ``command_handler_spi.py`` and
   ``plugin_spi.py`` on the card and with ``--device cpu``, each in a
   process of its own (``--demo``): equal stdout and equal device-slot
   state, the card runs' kernel launches counted;
17. drives the multi-process fabric (``multihost``) through the port's
   launcher, every child on this run's build directory (none compiles):
   (a) the parity worker (``multihost/_parity_worker.py``: the reference
   worker's rules and seeded stream through ``MultihostIngest``) in 1
   process x 8 shards on the card, 2 x 4 with both ranks on the one card
   (gloo, host-staged collectives) and 2 x 4 on the CPU — equal
   decisions, gathered flow windows and ``flow_metrics``, every status
   present, each rank's backend and device printed; (b) the cluster
   engine at the JAX bench's config 5 geometry with flow requests only (S
   = 8, 4096 flow rows, 2^16 Zipf requests a step, 20 steps), 2 x 4 on the
   card against a 1 x 8 engine in turns: verdict digests equal step by
   step, step p50/p99, grants/s, ms a step in the namespace
   ``all_reduce`` and the verdict ``all_gather``, 2 launches a step a
   rank; the kernel against its plain version at each rank's block shapes
   (flows ``[2048,8]`` of ``[2048,10,8]``, namespaces ``[16,8]``), timed
   cold and warm against ``index_add_``; (c) two processes each with
   phase 8's 1M-row runtime for 4 fused steps of its own traffic, then
   ``aggregate_counters``, ``aggregate_topk`` and
   ``aggregate_resource_hist`` against a host-side merge (ms a call);
   (d) with two cards or more, (a) and (b) on NCCL with a card a rank (on
   one card it prints why not);
18. drives the row-sharded runtime (``meshed``): ``Sentinel(mesh=
   local_mesh(devices=["cuda:0"] * 8))``, the windows, gauges, occupy ring
   and RT histograms as 8 row blocks on the card: (a) phase 8's runtime
   at full width (1M rows, 2M alt rows, thread gauges kept, fused
   decide+exit steps of 2^19) on the scalar route and on the general
   route (64 origins on half the events) against the one-block runtime
   in turns: verdicts and every state leaf equal at every step (block by
   block on the card), step p50/p99, launches a step (a meshed step that
   launches none fails), device ms a step; (b) the kernel against its
   plain version at every block shape of (a) (the window slices, the RT
   columns and histogram, the gauges, the alt rows; N = 2^19 or 2^20
   lanes, most not owned by the block), timed cold and warm against
   ``index_add_`` over the owned lanes; (c) at 16k rows, on 8 blocks on
   the card and on a CPU twin: ``DispatchPipeline`` at depth 2 and a
   ``frontend()`` run (``pipeline.meshed_dispatch``,
   ``split_route.meshed``), a telemetry tick (the top-K also equal to a
   one-block runtime's), tiered churn whose proactive demotions spread
   over the blocks, a snapshot restored into 8 blocks and into one, the
   tune fingerprint's mesh block — every observation and the state
   equal; (d) with two cards or more, 8 blocks spread over two cards
   against (a)'s verdicts (on one card it prints why not);
19. prints the card's name and power limit, one ``{"kernels": [...]}`` JSON
   line (``launches`` summed over the runs of phases 3-18), and as the last
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
    # the same two scatters on the gateway's path (phase 13): a request's
    # entry is a batch of one event, padded to 8, with PV pairs each (N =
    # 8·PV); its client IP, header, cookie or host values on three key
    # rows, every other lane at the padding row
    gw_n = 8 * PARAM_PAIRS
    gw_live = torch.zeros(gw_n, dtype=torch.bool, device=dev)
    gw_live[:3] = True
    gw_rows = torch.where(gw_live, rint(0, 61_440, (gw_n,)), PARAM_KEYS)
    case("gateway param tokens f32 [PK+1,1], payload E=1, N=8*PV", 1,
         torch.randint(0, 8, (PARAM_KEYS + 1, 1), device=dev,
                       generator=g).float(), whole,
         torch.where(gw_live, gw_rows, PARAM_KEYS + 1).int().contiguous(),
         None, torch.where(gw_live, -1, 0).int()[:, None].contiguous())
    case("gateway param threads int32 [PK+1,1], payload E=1, N=8*PV", 2,
         rint(0, 3, (PARAM_KEYS + 1, 1)), whole,
         gw_rows.int().contiguous(), None,
         gw_live.int()[:, None].contiguous())
    # the cluster token step's three window records (phase 11's geometry:
    # S = 8 shards), each one payload launch (E = 8) into the current
    # bucket slice of a 10-bucket window; the rest of the lanes at the
    # global pad (dropped). Namespace window: S·NS = 32 rows, every lane of
    # a step on it; flow window: S·L = 4096 rows, Zipf lanes; hot-key
    # window: S·PK = 2^16 rows, B·PV = 2^18 lanes, a quarter of them live
    for name, rows, n, live_share in (
            ("cluster namespace [32,8] slice of [32,10,8], N=2^16", 32,
             1 << 16, 1.0),
            ("cluster flow [4096,8] slice of [4096,10,8], N=2^16", 4096,
             1 << 16, 0.95),
            ("cluster hot-key [2^16,8] slice of [2^16,10,8], N=2^18",
             1 << 16, 1 << 18, 0.25)):
        ck = torch.from_numpy((np.random.default_rng(rows).zipf(1.1, n)
                               % rows).astype(np.int32)).to(dev)
        ck[torch.rand(n, device=dev, generator=g) >= live_share] = rows
        cpay = torch.zeros((n, 8), dtype=torch.int32, device=dev)
        cpay[:, 0] = rint(0, 3, (n,))                  # PASS (acquire)
        cpay[:, 5] = (cpay[:, 0] > 0).int()            # PASS_REQUEST
        cpay[:, 1] = torch.where(cpay[:, 0] == 0, 1, 0)  # BLOCK
        cpay[:, 6] = cpay[:, 1]                        # BLOCK_REQUEST
        case(name, 1, rint(0, 50, (rows, 10, 8)), lambda t: t[:, 7, :],
             ck.contiguous(), None, cpay)

    return [_kernel_case(sa, timer, c, samples) for c in cases]


def _kernel_case(sa, timer, c: dict, samples: int = 31,
                 timed: bool = True) -> dict:
    """One launch shape: the kernel against its plain version on the same
    inputs (exact, or the phase fails), then — ``timed`` — cold and warm
    in turns with one ``index_add_``, the plain version's time and the
    byte bound."""
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
    out = {"case": name, "launches_per_step": c["per_step"],
           "plan": dataclasses.asdict(plan), "max_abs_err": err}
    log(f"[kernel] {name}: plan {plan.path}/E{plan.e_inst}/"
        f"i{plan.index_bits} grid {plan.grid}x{plan.block} "
        f"smem {plan.smem_bytes}; max_abs_err={err}")
    if not timed:
        return out
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
    out.update({"bound_ms": bound, "plain_ms": plain_ms, "cold": cold,
                "warm": warm, "share_of_bound_cold": share})
    return out


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


def _pair_runtime(stt, R: int, dev, t0: int):
    """``Sentinel(device=dev)`` at ``R`` rows (default configuration)
    with one QPS param rule on each of p0..p255 → (runtime, the rows of
    those and of 60,000 rule-free names)."""
    big = stt.Sentinel(config=stt.load_config(max_resources=R),
                       clock=stt.ManualClock(start_ms=t0), device=dev)
    ruled = [f"p{i}" for i in range(PARAM_RESOURCES)]
    big.load_param_flow_rules([stt.ParamFlowRule(resource=r, param_idx=0,
                                                 count=3.0) for r in ruled])
    return big, big.intern_resources(ruled + [f"u{i}" for i in range(60_000)])


def _pair_batch(rng, pool, B: int):
    """``B`` rows (1/8 param-ruled) and 2-D int args, Zipf(1.1) over
    ``PARAM_VALUES`` user ids."""
    p = 1.0 / np.arange(1, PARAM_VALUES + 1) ** 1.1
    rows = np.where(rng.random(B) < 0.125,
                    pool[rng.integers(0, PARAM_RESOURCES, B)],
                    pool[rng.integers(0, pool.shape[0], B)])
    args = rng.choice(PARAM_VALUES, (B, 1), p=p / p.sum()).astype(np.int64)
    return rows, args


class _timed_resolution:
    """Within the block every ``resolve_pairs_many`` call appends its
    host seconds to ``spent``."""

    def __init__(self, trt, spent: list):
        self.trt, self.spent = trt, spent
        self.real = trt.pf_mod.resolve_pairs_many

    def __enter__(self):
        real, spent = self.real, self.spent

        def timed(*a, **k):
            t = time.perf_counter()
            try:
                return real(*a, **k)
            finally:
                spent.append(time.perf_counter() - t)
        self.trt.pf_mod.resolve_pairs_many = timed
        return self

    def __exit__(self, *exc):
        self.trt.pf_mod.resolve_pairs_many = self.real
        return False


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
    big, pool = _pair_runtime(stt, R, dev, t0)
    rng = np.random.default_rng(22)
    spent = []
    call_s = []
    sa.LAUNCHES.clear()
    with _timed_resolution(trt, spent):
        for _ in range(3):
            rows, args = _pair_batch(rng, pool, B)
            sync()
            t = time.perf_counter()
            v = big.entry_batch(rows, args_list=args)
            call_s.append(time.perf_counter() - t)
            big.clock.advance_ms(3)
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


class _knobs:
    """Within the block the ``SENTINEL_*`` knobs in ``env`` are set; they
    are restored after it."""

    def __init__(self, **env):
        self.env = {k: str(v) for k, v in env.items()}

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)
        return self

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def _obs_runtime(stt, R: int, clock, dev, obs_on: bool = True,
                 staging: bool = True):
    """``Sentinel(device=dev)`` with the default configuration at ``R``
    rows and the scalar fixture's rules: 4096 QPS rules (count 50) and
    1024 exception-ratio breakers; ``obs_on``/``staging`` set the
    ``SENTINEL_OBS_DISABLE``/``SENTINEL_HOST_STAGING`` knobs for its
    construction."""
    with _knobs(SENTINEL_OBS_DISABLE=int(not obs_on),
                SENTINEL_HOST_STAGING=int(staging)):
        sph = stt.Sentinel(config=stt.load_config(max_resources=R),
                           clock=clock, device=dev)
    sph.load_flow_rules([stt.FlowRule(resource=f"r{i}", count=50.0)
                         for i in range(OBS_RULED)])
    sph.load_degrade_rules([stt.DegradeRule(
        resource=f"r{i}", grade=stt.GRADE_EXCEPTION_RATIO, count=0.5,
        time_window=10, min_request_amount=5) for i in range(1024)])
    return sph


def _scalar_stream(sph, B: int, steps: int, seed: int = 41,
                   pool: int = 60_000):
    """``steps`` batches of the headline's scalar traffic as pre-interned
    rows (1/4 of the events on the ruled resources, the rest over
    ``pool`` rule-free names) and each step's exit error column
    generator: the exits of ``r0``..``r31`` always fail, so their
    breakers trip."""
    ruled = sph.intern_resources([f"r{i}" for i in range(OBS_RULED)])
    pool = sph.intern_resources([f"u{i}" for i in range(pool)])
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
    with _knobs(**env):
        return _obs_runtime(stt, R, clock, dev)


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
                names=("tiered", "tiered_sd0", "resident", "tiered_native")):
    """(a)/(c) the churn legs: the same seeded traffic through
    ``entry_batch_nowait`` on twin runtimes in turns — ``tiered``
    (``SENTINEL_HOT_ROWS=hot_rows``), ``tiered_sd0`` (the same with
    ``SENTINEL_SINGLE_DISPATCH=0``) and ``resident``
    (``SENTINEL_TIERING_DISABLE=1``; ``universe`` must fit its table) and
    ``tiered_native`` (``tiered`` with the native C++ tables, which have
    no targeted eviction: no proactive demotion, a run of its own, not a
    faster one; the others run the Python tables, the phase sets
    ``SENTINEL_TPU_NATIVE=0``) — a flow-rule reload half way, ``TIER_STEP_MS`` a batch, each runtime's
    ``CadenceScheduler`` armed (telemetry 1 s, tiering ``TIER_TICK_MS``)
    and polled after every batch. Verdicts equal every batch, the
    count-min tables of the two tiered twins equal after every batch,
    kernel launches a step equal → the runtimes and the numbers."""
    t0 = 1_800_000_000_000
    envs = {"tiered": dict(SENTINEL_HOT_ROWS=hot_rows),
            "tiered_sd0": dict(SENTINEL_HOT_ROWS=hot_rows,
                               SENTINEL_SINGLE_DISPATCH=0),
            "resident": dict(SENTINEL_TIERING_DISABLE=1),
            "tiered_native": dict(SENTINEL_HOT_ROWS=hot_rows,
                                  SENTINEL_TPU_NATIVE=1)}
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
    (d) :func:`_tier_controller`.

    :func:`main` runs it under ``SENTINEL_TPU_NATIVE=0`` (the Python
    interning tables, as before the C++ tables were ported, so its record
    stays comparable) but for (a)'s ``tiered_native`` turn."""
    from sentinel_tpu_torch import convert
    from sentinel_tpu_torch.native import NativeRegistry
    t_phase = time.perf_counter()
    res = {}
    launches = 0
    sph, _sched, churn = _tier_churn(stt, sa, dev, R, B, batches, hot_rows,
                                     R - OBS_RULED, seed=1501)
    launches += sum(churn["launches"]["tiered"])
    lps = sorted(set(churn["launches"]["tiered"]))
    tables = {n: type(s.resources).__name__ for n, s in sph.items()}
    if [n for n, t in tables.items()
            if (t == NativeRegistry.__name__) != (n == "tiered_native")]:
        fail(f"tiering phase: interning tables {tables}")
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
        f"{res['churn']['host_ms']['resident']['median']:.2f}, tiered "
        f"with the native tables (no proactive demotion: promoted "
        f"{snap['tiered_native']['promoted']}, demoted "
        f"{snap['tiered_native']['demoted']}) "
        f"{res['churn']['host_ms']['tiered_native']['median']:.2f}, poll "
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



# ---------------------------------------------------------------------------
# Phase 11: the cluster token tier
# ---------------------------------------------------------------------------

CLUSTER_SHARDS = 8
CLUSTER_FLOWS = 512          # L: flow rows a shard (4096 in all)
CLUSTER_PARAM_RULES = 64     # of those rows, param rules' proxy rows
CLUSTER_PK = 1 << 13         # hot-key rows a shard (2^16 in all)
CLUSTER_USERS = 1 << 20      # param values: Zipf(1.1) over these user ids
CLUSTER_STEP_MS = 10         # virtual time between steps
CLUSTER_T0 = 1_785_000_000_000
CLUSTER_BUDGET_MS = 20       # the reference client's request timeout


def _cluster_rules(tcl):
    """Flow rules over 4 namespaces and the param rules: GLOBAL and
    AVG_LOCAL, ``exceed`` 1.0–1.5, a quarter with ``max_occupy_ratio``
    0.5, and flow 1 an AVG_LOCAL rule of count 1e9 in the namespace with
    3 connected clients (a 3e9 threshold: the saturating cast)."""
    n_flow = CLUSTER_SHARDS * CLUSTER_FLOWS - CLUSTER_PARAM_RULES
    flow = {ns: [] for ns in range(4)}
    for i in range(n_flow):
        if i == 1:
            r = tcl.ClusterFlowRule(flow_id=i, count=1e9,
                                    threshold_type=tcl.THRESHOLD_AVG_LOCAL)
        else:
            r = tcl.ClusterFlowRule(
                flow_id=i, count=float(40 + (i * 37) % 400),
                threshold_type=(tcl.THRESHOLD_GLOBAL if i % 3
                                else tcl.THRESHOLD_AVG_LOCAL),
                exceed_count=1.0 + 0.125 * (i % 5),
                max_occupy_ratio=0.5 if i % 4 == 3 else 1.0)
        flow[i % 4].append(r)
    param = [tcl.ClusterParamFlowRule(
        flow_id=10_000 + j, count=float(2 + j % 20),
        threshold_type=j % 2, items={0: 500.0})
        for j in range(CLUSTER_PARAM_RULES)]
    return n_flow, flow, param


def _cluster_engine(tcl, dev, rules):
    """The phase's engine: namespace ``ns0`` keeps the default 30,000/s
    request limit, the others are at 1e9; ``ns1`` has 3 connected
    clients."""
    _, flow, param = rules
    eng = tcl.ClusterEngine(tcl.ClusterSpec(
        n_shards=CLUSTER_SHARDS, flows_per_shard=CLUSTER_FLOWS,
        namespaces=4, param_keys_per_shard=CLUSTER_PK, max_params=4),
        device=dev)
    for ns in range(4):
        eng.load_rules(f"ns{ns}", flow[ns])
        if ns:
            eng.set_namespace_qps_limit(f"ns{ns}", 1e9)
    eng.load_param_rules("ns2", param)
    eng.set_connected_count("ns1", 3)
    return eng


def _cluster_stream(n_flow, B: int, steps: int, seed: int) -> list:
    """Per step: 3B/4 flow requests (Zipf(1.1) flow ids, 16 ids past the
    rules: NO_RULE; acquire 1–2; 1/8 prioritized) and B/4 param requests
    (the 64 param rules, 1–4 values each, Zipf(1.1) over 2^20 user ids)."""
    rng = np.random.default_rng(seed)
    nf, npr = B - B // 4, B // 4
    out = []
    for _ in range(steps):
        ids = (rng.zipf(1.1, nf) - 1) % (n_flow + 16)
        acq = rng.integers(1, 3, nf)
        prio = rng.random(nf) < 0.125
        pids = (10_000 + rng.integers(0, CLUSTER_PARAM_RULES, npr)).tolist()
        k = rng.integers(1, 5, npr)
        users = ((rng.zipf(1.1, int(k.sum())) - 1) % CLUSTER_USERS).tolist()
        vals, at = [], 0
        for kk in k.tolist():
            vals.append(users[at:at + kk])
            at += kk
        out.append((ids, acq, prio, pids, [1] * npr, vals))
    return out


def _cluster_run(eng, stream, strict: bool, depth: int = 0):
    """Drive the stream: each step one ``request_tokens_nowait`` and one
    ``request_param_tokens_nowait`` (under the sync debug mode "error"
    when ``strict``), read back at once (``depth`` 0) or with ``depth``
    steps in flight → (results, host ms: dispatch, readback, step)."""
    results, disp, read, step = [], [], [], []
    inflight = collections.deque()
    for i, (ids, acq, prio, pids, pacq, vals) in enumerate(stream):
        now = CLUSTER_T0 + i * CLUSTER_STEP_MS
        t0 = time.perf_counter()
        with no_host_sync(strict and eng.device.type == "cuda"):
            hf = eng.request_tokens_nowait(ids, acq, prio, now_ms=now)
            hp = eng.request_param_tokens_nowait(pids, pacq, vals,
                                                 now_ms=now)
        t1 = time.perf_counter()
        inflight.append((hf, hp))
        if len(inflight) > depth:
            a, b = inflight.popleft()
            results.append((a.result(), b.result()))
        t2 = time.perf_counter()
        disp.append((t1 - t0) * 1e3)
        read.append((t2 - t1) * 1e3)
        step.append((t2 - t0) * 1e3)
    while inflight:
        a, b = inflight.popleft()
        results.append((a.result(), b.result()))
    return results, disp, read, step


def _cluster_counts(results) -> dict:
    counts = collections.Counter()
    for flow, param in results:
        counts.update(s for s, _, _ in flow)
        counts.update(s for s, _, _ in param)
    return dict(counts)


def _cluster_engine_leg(stt, sa, dev, B, steps, profile) -> dict:
    """(a) The engine at full width: the kernel run on the card, the plain
    seam on the card, the CPU at the same size, and the kernel run
    pipelined at depth 8 — equal verdicts and windows; 3 launches an
    engine step on the card, none in the plain run."""
    from sentinel_tpu_torch import convert
    from sentinel_tpu_torch.parallel import cluster as tcl
    rules = _cluster_rules(tcl)
    stream = _cluster_stream(rules[0], B, steps, seed=61)
    out = {"B": B, "steps": steps}
    # warm-up on a throwaway engine (allocator, library handles)
    _cluster_run(_cluster_engine(tcl, dev, rules), stream[:2], False)
    sync()
    eng = _cluster_engine(tcl, dev, rules)
    sa.LAUNCHES.clear()
    kernel, disp, read, step = _cluster_run(eng, stream, strict=True)
    launches = sa.LAUNCHES["scatter_add"]
    # flows, namespaces, hot keys: one payload launch each, two engine
    # steps (flow and param) a stream step
    if launches != 6 * steps:
        fail(f"cluster phase: {launches} kernel launches in {steps} steps, "
             f"want 6 a step (3 an engine step)")
    k_state = convert.cluster_to_numpy(eng)
    probe = [0, 1, 2, 3, 7, 4031]
    k_metrics = [eng.flow_metrics(f, now_ms=CLUSTER_T0 + steps * 10)
                 for f in probe]
    k_top = [eng.top_params(10_000 + j, now_ms=CLUSTER_T0 + steps * 10)
             for j in range(4)]
    counts = _cluster_counts(kernel)
    for st in (tcl.STATUS_OK, tcl.STATUS_BLOCKED, tcl.STATUS_SHOULD_WAIT,
               tcl.STATUS_TOO_MANY_REQUEST, tcl.STATUS_NO_RULE_EXISTS):
        if not counts.get(st):
            fail(f"cluster phase: status {st} never occurred: {counts}")
    flow1 = [rm for (flow, _), (ids, *_r) in zip(kernel, stream)
             for (s, _w, rm), fid in zip(flow, ids.tolist())
             if fid == 1 and s == tcl.STATUS_OK]
    if not flow1 or any(rm != 2 ** 31 - 1 for rm in flow1):
        fail(f"cluster phase: the 3e9 AVG_LOCAL flow's remaining did not "
             f"saturate: {sorted(set(flow1))[:5]}")
    real = sa.scatter_add
    sa.scatter_add = sa.scatter_add_reference     # the plain seam
    try:
        sa.LAUNCHES.clear()
        peng = _cluster_engine(tcl, dev, rules)
        plain = _cluster_run(peng, stream, strict=False)[0]
        if sa.LAUNCHES["scatter_add"]:
            fail("cluster phase: the plain run launched the kernel")
    finally:
        sa.scatter_add = real
    p_state = convert.cluster_to_numpy(peng)
    ceng = _cluster_engine(tcl, "cpu", rules)
    t_cpu = time.perf_counter()
    cpu = _cluster_run(ceng, stream, strict=False)[0]
    t_cpu = time.perf_counter() - t_cpu
    c_state = convert.cluster_to_numpy(ceng)
    for tag, other, st in (("plain seam", plain, p_state),
                           ("CPU", cpu, c_state)):
        if other != kernel:
            bad = next(i for i, (a, b) in enumerate(zip(kernel, other))
                       if a != b)
            fail(f"cluster phase: verdicts differ from the {tag} run at "
                 f"step {bad}")
        diff = convert.leaf_diff(st, k_state)
        if diff:
            fail(f"cluster phase: windows differ from the {tag} run: {diff}")
    if ([ceng.flow_metrics(f, now_ms=CLUSTER_T0 + steps * 10)
         for f in probe] != k_metrics
            or [ceng.top_params(10_000 + j, now_ms=CLUSTER_T0 + steps * 10)
                for j in range(4)] != k_top):
        fail("cluster phase: flow_metrics/top_params differ from the CPU")
    # pipelined at depth 8 (the JAX bench's config 5 drive)
    deng = _cluster_engine(tcl, dev, rules)
    sync()
    t_pipe = time.perf_counter()
    piped = _cluster_run(deng, stream, strict=False, depth=8)[0]
    t_pipe = time.perf_counter() - t_pipe
    if piped != kernel:
        fail("cluster phase: pipelined verdicts differ")
    # host ms of the param values' blake2s hashing, one step's batch
    ids0, _a, _p, pids, _pa, vals = stream[0]
    t_h = time.perf_counter()
    for fid, vs in zip(pids, vals):
        for v in vs:
            eng._param_key(fid, v)
    hash_ms = (time.perf_counter() - t_h) * 1e3
    grants = counts.get(tcl.STATUS_OK, 0)
    sync_s = sum(step) / 1e3
    out.update({
        "launches": launches, "launches_per_engine_step": launches
        / (2 * steps), "status_counts": {str(k): v
                                         for k, v in counts.items()},
        "step_ms": summary(step), "dispatch_ms": summary(disp),
        "readback_ms": summary(read),
        "step_ms_p99": float(np.percentile(step, 99)),
        "decisions_per_s_sync": B * steps / sync_s,
        "grants_per_s_sync": grants / sync_s,
        "decisions_per_s_depth8": B * steps / t_pipe,
        "grants_per_s_depth8": grants / t_pipe,
        "cpu_step_ms": t_cpu / steps * 1e3,
        "param_hash_ms_per_batch": hash_ms,
        "param_values_per_batch": sum(len(v) for v in vals),
        "saturated_remaining": len(flow1)})
    log(f"[cluster] (a) S={CLUSTER_SHARDS} L={CLUSTER_FLOWS} PK="
        f"{CLUSTER_PK} B={B} x {steps} steps: verdicts, windows, "
        f"flow_metrics and top_params equal (kernel, plain seam, CPU, "
        f"depth 8); launches {launches} (3 an engine step); statuses "
        f"{counts}")
    log(f"[cluster]   step p50 {out['step_ms']['median']:.2f} ms, p99 "
        f"{out['step_ms_p99']:.2f} ms (budget {CLUSTER_BUDGET_MS} ms); "
        f"dispatch {out['dispatch_ms']['median']:.2f} ms, readback "
        f"{out['readback_ms']['median']:.2f} ms; grants/s sync "
        f"{out['grants_per_s_sync']:.0f}, depth 8 "
        f"{out['grants_per_s_depth8']:.0f}; decisions/s sync "
        f"{out['decisions_per_s_sync']:.0f}, depth 8 "
        f"{out['decisions_per_s_depth8']:.0f}; CPU {out['cpu_step_ms']:.1f}"
        f" ms a step; param hashing {hash_ms:.2f} ms for "
        f"{out['param_values_per_batch']} values")
    if profile:
        out["profile"] = prof = _profile_steps(
            lambda: _cluster_run(_cluster_engine(tcl, dev, rules), stream,
                                 strict=False), steps,
            trace_name="cluster_trace.json", keep_trace=False)
        log(f"[cluster]   device time {prof['device_ms_per_step']:.3f} ms a "
            f"step of {B} requests (two engine steps)")
    return out


def _cluster_server_leg(stt, sa, dev, threads: int, singles: int,
                        batches: int, batch_n: int, log_dir: str) -> dict:
    """(b) A ``ClusterTokenServer`` on 127.0.0.1 (ephemeral port), its
    engine on the card: ``threads`` clients each make ``singles``
    ``request_token`` calls and ``batches`` pipelined batches of
    ``batch_n`` under a frozen ManualClock — a GLOBAL rule of count C
    grants exactly C; 3 PINGs triple an AVG_LOCAL threshold; concurrent
    tokens balance through acquire, release and the lease sweep."""
    import threading
    from sentinel_tpu_torch.cluster.client import ClusterTokenClient
    from sentinel_tpu_torch.cluster.server import ClusterTokenServer
    from sentinel_tpu_torch.parallel import cluster as tcl
    from sentinel_tpu_torch.parallel.concurrent import ConcurrentFlowRule
    clock = stt.ManualClock(start_ms=CLUSTER_T0)
    eng = tcl.ClusterEngine(tcl.ClusterSpec(
        n_shards=CLUSTER_SHARDS, flows_per_shard=64, namespaces=4,
        param_keys_per_shard=1024), device=dev)
    total = threads * (singles + batches * batch_n)
    C = total // 4               # a quarter of the requests get a token
    eng.load_rules("g", [tcl.ClusterFlowRule(
        flow_id=1, count=C, threshold_type=tcl.THRESHOLD_GLOBAL)])
    eng.load_rules("avg", [tcl.ClusterFlowRule(
        flow_id=2, count=5, threshold_type=tcl.THRESHOLD_AVG_LOCAL)])
    eng.set_namespace_qps_limit("g", 1e9)
    steps = []
    real_step = eng.request_tokens

    def counted(ids, *a, **kw):
        steps.append(len(ids))
        return real_step(ids, *a, **kw)

    eng.request_tokens = counted
    server = ClusterTokenServer(eng, clock=clock, host="127.0.0.1", port=0,
                                log_dir=log_dir)
    server.load_concurrent_rules("c", [ConcurrentFlowRule(
        flow_id=7, count=3, resource_timeout_ms=500)])
    server.start()                # raises if it does not come up
    clients = []
    try:
        def client(ns):
            c = ClusterTokenClient("127.0.0.1", server.port, namespace=ns,
                                   request_timeout_ms=10_000,
                                   auto_reconnect=False)
            c.start()
            clients.append(c)
            return c

        g_clients = [client("g") for _ in range(threads)]
        real_step([1], [1], now_ms=CLUSTER_T0)    # warm the step
        steps.clear()
        statuses, rt_single, rt_batch = [], [], []
        lock = threading.Lock()

        def drive(c):
            st, rs, rb = [], [], []
            for _ in range(singles):
                t = time.perf_counter_ns()
                st.append(c.request_token(1, 1).status)
                rs.append((time.perf_counter_ns() - t) / 1e3)
            for _ in range(batches):
                t = time.perf_counter_ns()
                st += [r.status for r in c.request_tokens_batch(
                    [(1, 1, False)] * batch_n)]
                rb.append((time.perf_counter_ns() - t) / 1e3)
            with lock:
                statuses.extend(st)
                rt_single.extend(rs)
                rt_batch.extend(rb)

        sa.LAUNCHES.clear()
        workers = [threading.Thread(target=drive, args=(c,), daemon=True)
                   for c in g_clients]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=600)
            if w.is_alive():
                fail("cluster phase: a token client did not finish")
        wall = time.perf_counter() - t0
        launches = sa.LAUNCHES["scatter_add"]
        n_steps = len(steps)
        sc = collections.Counter(statuses)
        # the warm-up step took one of the C tokens
        if len(statuses) != total or sc[tcl.STATUS_OK] != C - 1 \
                or sc[tcl.STATUS_BLOCKED] != total - (C - 1):
            fail(f"cluster phase: the server granted {dict(sc)} of "
                 f"{total}, want exactly {C - 1} OK and the rest BLOCKED")
        if launches != 3 * n_steps:
            fail(f"cluster phase: {launches} kernel launches for "
                 f"{n_steps} server steps, want 3 each")
        avg_clients = [client("avg") for _ in range(3)]
        if avg_clients[0].ping() != 3:
            fail("cluster phase: 3 PINGs did not register 3 clients")
        avg = [r.status for r in avg_clients[0].request_tokens_batch(
            [(2, 1, False)] * 20)]
        if avg.count(tcl.STATUS_OK) != 15:
            fail(f"cluster phase: AVG_LOCAL with 3 clients granted "
                 f"{avg.count(tcl.STATUS_OK)}, want 15")
        cc = client("c")
        got = [cc.acquire_concurrent_token(7, 1) for _ in range(4)]
        ok = [r.status for r in got] == [tcl.STATUS_OK] * 3 + [
            tcl.STATUS_BLOCKED]
        ok &= cc.release_concurrent_token(got[0].token_id).status \
            == tcl.STATUS_RELEASE_OK
        ok &= server.concurrent.now_calls(7) == 2
        clock.advance_ms(600)         # the other two leases expire
        end = time.perf_counter() + 10
        while server.concurrent.now_calls(7) and time.perf_counter() < end:
            time.sleep(0.05)
        ok &= server.concurrent.now_calls(7) == 0
        ok &= server.concurrent.lease_count() == 0
        ok &= cc.release_concurrent_token(got[1].token_id).status \
            == tcl.STATUS_ALREADY_RELEASE
        if not ok:
            fail("cluster phase: concurrent tokens did not balance")
    finally:
        for c in clients:
            c.stop()
        server.stop()
    out = {"launches": launches, "threads": threads, "requests": total,
           "wall_s": wall, "decisions_per_s": total / wall,
           "server_steps": n_steps,
           "mean_requests_per_step": float(np.mean(steps[:n_steps])),
           "rt_single_us": {"p50": float(np.percentile(rt_single, 50)),
                            "p99": float(np.percentile(rt_single, 99))},
           "rt_batch_us": {"p50": float(np.percentile(rt_batch, 50)),
                           "p99": float(np.percentile(rt_batch, 99))}}
    log(f"[cluster] (b) server on loopback, {threads} clients: exactly "
        f"{C - 1} of {total} granted, AVG_LOCAL x3 by PING, concurrent "
        f"tokens balanced; round trip single p50 "
        f"{out['rt_single_us']['p50']:.0f} us p99 "
        f"{out['rt_single_us']['p99']:.0f} us, batch of {batch_n} p50 "
        f"{out['rt_batch_us']['p50']:.0f} us p99 "
        f"{out['rt_batch_us']['p99']:.0f} us; {out['decisions_per_s']:.0f} "
        f"decisions/s; {n_steps} device steps, "
        f"{out['mean_requests_per_step']:.1f} requests a step; launches "
        f"{launches}")
    return out


def _cluster_runtime_drive(stt, sph, clock, calls: int, batch: int,
                           seed: int = 71) -> dict:
    """(c)'s drive: 64 cluster-mode flow rules (half with
    ``cluster_fallback_to_local``) and 16 cluster param rules served by
    an embedded ``ClusterCoordinator`` (its engine on the Sentinel's
    device); ``calls`` ``entry()``+exit calls and one ``entry_batch`` of
    ``batch`` events with origins, then the service is uninstalled and
    the same again (the fallback rules checked locally, the rest
    pass)."""
    from sentinel_tpu_torch.cluster import coordinator as tcoord
    from sentinel_tpu_torch.parallel import cluster as tcl
    coord = tcoord.ClusterCoordinator(
        sph, n_shards=CLUSTER_SHARDS, flows_per_shard=16,
        param_keys_per_shard=1024, clock=clock)
    coord.on_mode_change(tcoord.CLUSTER_SERVER)
    if coord.mode != tcoord.CLUSTER_SERVER or coord.server is None:
        fail("cluster phase: the embedded token server did not start")
    try:
        sph.load_flow_rules([stt.FlowRule(
            resource=f"c{i}", count=5.0, cluster_mode=True,
            cluster_flow_id=1 + i, cluster_fallback_to_local=i % 2 == 0)
            for i in range(64)] + [stt.FlowRule(resource="plain",
                                                count=1e6)])
        sph.load_param_flow_rules([stt.ParamFlowRule(
            resource=f"p{j}", param_idx=0, count=3, cluster_mode=True,
            cluster_flow_id=101 + j) for j in range(16)])
        coord.server.load_flow_rules(coord.namespace, [tcl.ClusterFlowRule(
            flow_id=1 + i, count=float(4 + i % 8),
            threshold_type=tcl.THRESHOLD_GLOBAL) for i in range(64)])
        coord.server.load_param_rules(coord.namespace, [
            tcl.ClusterParamFlowRule(flow_id=101 + j, count=2.0,
                                     threshold_type=tcl.THRESHOLD_GLOBAL)
            for j in range(16)])
        rng = np.random.default_rng(seed)
        names = [f"c{i}" for i in range(64)] + [
            f"p{j}" for j in range(16)] + ["plain"] * 16
        obs, cluster_us = [], []
        for half in range(2):
            picks = rng.integers(0, len(names), calls // 2)
            users = rng.integers(0, 4, calls // 2)
            for k, (pi, u) in enumerate(zip(picks.tolist(),
                                            users.tolist())):
                res = names[pi]
                args = (u,) if res[0] == "p" else ()
                t = time.perf_counter()
                try:
                    with sph.entry(res, args=args):
                        got = "pass"
                except stt.BlockException as exc:
                    got = type(exc).__name__
                if res[0] == "c" and half == 0:
                    cluster_us.append((time.perf_counter() - t) * 1e6)
                obs.append(got)
                if k % 8 == 7:
                    clock.advance_ms(1)
            bn = rng.integers(0, len(names), batch)
            v = sph.entry_batch(
                [names[i] for i in bn.tolist()],
                origins=[f"app-{o}" if o < 8 else ""
                         for o in rng.integers(0, 16, batch).tolist()],
                args_list=[(int(u),) for u in rng.integers(0, 4, batch)])
            obs.append((np.asarray(v.allow).tolist(),
                        np.asarray(v.reason).tolist(),
                        np.asarray(v.wait_ms).tolist()))
            clock.advance_ms(30)
            if half == 0:
                sph.set_token_service(None)       # the service goes away
        from sentinel_tpu_torch import convert
        engine_state = convert.cluster_to_numpy(coord.server.engine)
    finally:
        coord.stop()
    return {"obs": obs, "cluster_us": cluster_us,
            "engine_state": engine_state}


def _cluster_runtime_leg(stt, sa, dev, R, twin_rows, calls, batch,
                         log_dir) -> dict:
    """(c) ``Sentinel(device="cuda")`` at ``R`` rows through ``entry()``
    and ``entry_batch`` with cluster-mode rules (:func:`_cluster_runtime_
    drive`); the same drive at ``twin_rows`` on the card and on the CPU
    must agree on verdicts and exceptions, block-log lines, counters,
    engine state and the embedded engine's windows."""
    from sentinel_tpu_torch import convert
    from sentinel_tpu_torch.core.logs import BlockStatLogger
    runs = {}
    for tag, d, rows in (("card", dev, R), ("card_twin", dev, twin_rows),
                         ("cpu_twin", "cpu", twin_rows)):
        clock = stt.ManualClock(start_ms=CLUSTER_T0)
        sph = stt.Sentinel(stt.load_config(max_resources=rows), clock=clock,
                           device=d)
        sph._cpu.sample = lambda: (0.5, 0.25)
        sph.block_log.close()
        sph.block_log = BlockStatLogger(clock, base_dir=os.path.join(
            log_dir, tag))
        sa.LAUNCHES.clear()
        t0 = time.perf_counter()
        out = _cluster_runtime_drive(stt, sph, clock, calls, batch)
        out["seconds"] = time.perf_counter() - t0
        out["launches"] = sa.LAUNCHES["scatter_add"]
        sph.block_log.flush()
        path = os.path.join(log_dir, tag, sph.block_log.FILE_NAME)
        out["lines"] = (open(path).read().splitlines()
                        if os.path.exists(path) else [])
        out["counters"] = sph.obs.counters.snapshot()
        out["state"] = convert.engine_to_numpy(sph) if rows == twin_rows \
            else None
        sph.close()
        runs[tag] = out
    card, twin, cpu = runs["card"], runs["card_twin"], runs["cpu_twin"]
    if not (card["obs"] == twin["obs"] == cpu["obs"]):
        fail("cluster phase: runtime verdicts differ (1M card, 16k card, "
             "16k CPU)")
    if not (card["lines"] == twin["lines"] == cpu["lines"]) \
            or not card["lines"]:
        fail("cluster phase: runtime block-log lines differ or are empty")
    if twin["counters"] != cpu["counters"]:
        fail("cluster phase: runtime counters differ from the CPU twin")
    bad = convert.leaf_diff(cpu["state"], twin["state"])
    for a in (twin, card):
        bad += convert.leaf_diff(cpu["engine_state"], a["engine_state"])
    if bad:
        fail(f"cluster phase: runtime state differs from the CPU twin: "
             f"{bad}")
    if not card["launches"]:
        fail("cluster phase: the runtime drive launched no kernel")
    outcomes = collections.Counter(o for o in card["obs"]
                                   if isinstance(o, str))
    for want in ("pass", "FlowException", "ParamFlowException"):
        if not outcomes.get(want):
            fail(f"cluster phase: the runtime drive never saw {want}")
    us = card["cluster_us"]
    res = {"launches": card["launches"], "R": R, "calls": calls,
           "batch": batch, "outcomes": dict(outcomes),
           "block_log_lines": len(card["lines"]),
           "entry_exit_us_cluster": summary(us),
           "seconds": {k: v["seconds"] for k, v in runs.items()}}
    log(f"[cluster] (c) runtime at {R} rows: {calls} entry()+exit and 2 "
        f"batches of {batch} with origins, the service uninstalled half "
        f"way; equal to the 16k card and CPU twins (verdicts, "
        f"{len(card['lines'])} block-log lines, counters, state, the "
        f"embedded engine's windows); outcomes {dict(outcomes)}; "
        f"entry()+exit with a cluster rule {np.median(us):.0f} us "
        f"(median); launches {card['launches']}")
    return res


def phase_cluster(stt, sa, dev="cuda", B=1 << 16, steps=40,
                  big_B=1 << 18, big_steps=8, threads=8, singles=2048,
                  batches=32, batch_n=256, R=1 << 20, twin_rows=1 << 14,
                  calls=1024, rt_batch=1 << 16,
                  profile: bool = False) -> dict:
    """The cluster token tier: (a) :func:`_cluster_engine_leg` at 2^16
    requests a step and the kernel run alone at 2^18; (b)
    :func:`_cluster_server_leg`; (c) :func:`_cluster_runtime_leg` (1024
    calls: phase 12 sends 512 more cluster-ruled calls through the
    facade)."""
    import tempfile
    from sentinel_tpu_torch.parallel import cluster as tcl
    t_phase = time.perf_counter()
    res = {"engine": _cluster_engine_leg(stt, sa, dev, B, steps, profile)}
    launches = res["engine"]["launches"]
    rules = _cluster_rules(tcl)
    stream = _cluster_stream(rules[0], big_B, big_steps, seed=62)
    eng = _cluster_engine(tcl, dev, rules)
    sa.LAUNCHES.clear()
    big, disp, read, step = _cluster_run(eng, stream, strict=True)
    big_launches = sa.LAUNCHES["scatter_add"]
    if big_launches != 6 * big_steps:
        fail(f"cluster phase: {big_launches} launches at B={big_B}")
    launches += big_launches
    grants = _cluster_counts(big).get(tcl.STATUS_OK, 0)
    res["engine_big"] = {
        "B": big_B, "steps": big_steps, "launches": big_launches,
        "step_ms": summary(step), "dispatch_ms": summary(disp),
        "readback_ms": summary(read),
        "decisions_per_s": big_B * big_steps / (sum(step) / 1e3),
        "grants_per_s": grants / (sum(step) / 1e3)}
    log(f"[cluster] (a) B={big_B}: step p50 "
        f"{res['engine_big']['step_ms']['median']:.2f} ms, "
        f"{res['engine_big']['decisions_per_s']:.0f} decisions/s, "
        f"{res['engine_big']['grants_per_s']:.0f} grants/s; launches "
        f"{big_launches}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cluster_") as tmp:
        res["server"] = _cluster_server_leg(stt, sa, dev, threads, singles,
                                            batches, batch_n, tmp)
        launches += res["server"]["launches"]
        res["runtime"] = _cluster_runtime_leg(stt, sa, dev, R, twin_rows,
                                              calls, rt_batch, tmp)
        launches += res["runtime"]["launches"]
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[cluster] phase 11 took {res['seconds']:.1f} s; kernel launches "
        f"{launches}")
    return res


# ---------------------------------------------------------------------------
# Phase 12: the command plane (rule JSON codec, HTTP command center,
# datasources, cluster server commands, the api facade, the web adapters)
# ---------------------------------------------------------------------------

CP_T0 = 1_810_000_000_000
CP_APP = "chip-smoke-cp"
CP_RULED = 4096              # QPS-ruled resources r0..r4095 (the fixture's)
CP_BREAKERS = 1024           # exception-ratio breakers on r0..r1023
CP_AUTH = 64                 # authority rules: "evil" blacklisted on r0..r63
CP_HOT = 16                  # the calls' hot set r0..r15 (breakers trip)
CP_LEASED = 64               # one-QPS-rule names the calls lease
CP_POOL = 8192               # rule-free names: the universe fits 16k rows
CP_CLUSTER = 64              # cluster-mode flow rules c0..c63
CP_POLLS = ("metric", "clusterNode", "obs")
#: the command that runs one twin session in a process of its own
CP_TWIN_CMD = [sys.executable, os.path.abspath(__file__), "--cp-twin"]


def _cp_docs(stt, codec, flow_count: float = 50.0,
             cluster: bool = False) -> dict:
    """The rules an operator pushes, as the dashboard's JSON: the scalar
    fixture's 4096 QPS rules and 1024 breakers, one system rule, 64
    authority rules, rules for the decorated and one web resource, and
    512 param rules on p0..p255; ``cluster`` adds the 64 cluster-mode
    flow rules of (c)."""
    from sentinel_tpu_torch.rules import param_flow as tpf
    flow = [stt.FlowRule(resource=f"r{i}", count=flow_count)
            for i in range(CP_RULED)]
    flow += [stt.FlowRule(resource="cp-deco", count=2000.0),
             stt.FlowRule(resource="GET:/admin", count=20.0)]
    if cluster:
        flow += [stt.FlowRule(resource=f"c{i}", count=5.0, cluster_mode=True,
                              cluster_flow_id=1 + i,
                              cluster_fallback_to_local=i % 2 == 0)
                 for i in range(CP_CLUSTER)]
    param, _grades = _param_rules(tpf, [f"p{i}" for i in
                                        range(PARAM_RESOURCES)])
    return {
        "flow": codec.rules_to_json("flow", flow),
        "degrade": codec.rules_to_json("degrade", [stt.DegradeRule(
            resource=f"r{i}", grade=stt.GRADE_EXCEPTION_RATIO, count=0.5,
            time_window=10, min_request_amount=5)
            for i in range(CP_BREAKERS)]),
        "system": codec.rules_to_json("system", [stt.SystemRule(
            qps=1e12, max_thread=1e9)]),
        "authority": codec.rules_to_json("authority", [stt.AuthorityRule(
            resource=f"r{i}", limit_app="evil",
            strategy=stt.STRATEGY_BLACK) for i in range(CP_AUTH)]),
        "paramFlow": codec.rules_to_json("paramFlow", param),
    }


def _cp_http(port: int, method: str, cmd: str, params=None):
    """One command over loopback HTTP → (status, body text, µs)."""
    import urllib.error
    import urllib.parse
    import urllib.request
    url = f"http://127.0.0.1:{port}/{cmd}"
    data = None
    if params and method == "GET":
        url += "?" + urllib.parse.urlencode(params)
    elif method == "POST":
        data = urllib.parse.urlencode(params or {}).encode()
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(urllib.request.Request(
                url, data=data, method=method), timeout=120) as r:
            status, text = r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as exc:
        status, text = exc.code, exc.read().decode("utf-8")
    return status, text, (time.perf_counter() - t) * 1e6


def _cp_body(text: str):
    """A response as the twins compare it: JSON parsed, less the token
    server's ephemeral port."""
    try:
        doc = json.loads(text)
    except ValueError:
        return text

    def strip(d):
        if isinstance(d, dict):
            return {k: strip(v) for k, v in d.items()
                    if k not in ("port", "serverPort")}
        if isinstance(d, list):
            return [strip(v) for v in d]
        return d
    return strip(doc)


class _CpPoller:
    """A second thread polling ``metric``, ``clusterNode`` and ``obs``
    over HTTP, back to back, while ``on``; every answer must be a 200
    (JSON where the command answers JSON)."""

    def __init__(self, port: int):
        import threading
        self.port = port
        self.lat = {c: [] for c in CP_POLLS}
        self.bad = []
        self._go = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="chip-smoke-poller")
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            if not self._go.wait(0.05):
                continue
            for cmd in CP_POLLS:
                params = ({"startTime": str(CP_T0)} if cmd == "metric"
                          else {"spans": "16", "events": "16"}
                          if cmd == "obs" else None)
                try:
                    status, text, us = _cp_http(self.port, "GET", cmd,
                                                params)
                    if status != 200:
                        self.bad.append((cmd, status, text[:200]))
                    elif cmd != "metric":
                        json.loads(text)
                    self.lat[cmd].append(us)
                except Exception as exc:     # noqa: BLE001 — reported
                    self.bad.append((cmd, repr(exc)))

    def on(self, flag: bool) -> None:
        (self._go.set if flag else self._go.clear)()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=120)


def _cp_stream(sph, B: int, steps: int, seed: int = 83):
    """``steps`` fused-step batches over the ruled names (1/4) and the
    pool (3/4), as rows; the exits of r0..r31 fail, so breakers trip."""
    ruled = sph.intern_resources([f"r{i}" for i in range(CP_RULED)])
    pool = sph.intern_resources([f"u{i}" for i in range(CP_POOL)])
    rng = np.random.default_rng(seed)
    batches = [np.where(rng.random(B) < 0.25,
                        ruled[rng.integers(0, CP_RULED, B)],
                        pool[rng.integers(0, CP_POOL, B)]).astype(np.int32)
               for _ in range(steps)]
    return batches, set(ruled[:32].tolist())


def _cp_calls(stt, api, deco, web, clock, calls: int, deco_calls: int,
              wsgi_calls: int, seed: int, timed: dict = None) -> list:
    """Application traffic, 1 ms of virtual time every 8 calls →
    outcomes (and µs a call by kind into ``timed``):

    * ``calls`` ``api.entry``+exit: 5% inbound on a hot set of 16 ruled
      names (business errors on 3 in 5, so breakers trip; 1% from the
      blacklisted origin); outbound (``SphU.entry``'s default in the
      reference; the system rule checks inbound calls only, so these may
      take the host fast path) 3% on param-ruled names with user ids,
      32% on 64 names of one QPS rule each (leased), 60% on rule-free
      names;
    * ``deco_calls`` calls of a ``@sentinel_resource`` function (one QPS
      rule, leased);
    * ``wsgi_calls`` WSGI requests: 1 in 16 on ``/admin`` (a QPS rule),
      the rest on the rule-free ``/item/{id}``."""
    rng = np.random.default_rng(seed)
    out = []
    picks = rng.integers(0, 100, calls).tolist()
    keys = rng.integers(0, 1 << 20, calls).tolist()
    for k in range(calls):
        pick, key = picks[k], keys[k]
        t = time.perf_counter()
        try:
            if pick < 5:
                row = key % CP_HOT
                e = api.entry(f"r{row}", origin="evil" if pick < 1 else "")
                if pick % 5 < 3 or key % 5 < 3:
                    api.trace(RuntimeError("business error"))
                e.exit()
            elif pick < 8:
                with api.entry(f"p{key % 16}", args=(key % 3, key % 2),
                               entry_type=stt.ENTRY_TYPE_OUT):
                    pass
            elif pick < 40:
                with api.entry(f"r{CP_BREAKERS + key % CP_LEASED}",
                               entry_type=stt.ENTRY_TYPE_OUT):
                    pass
            else:
                with api.entry(f"u{key % CP_POOL}",
                               entry_type=stt.ENTRY_TYPE_OUT):
                    pass
            out.append("pass")
        except stt.BlockException as exc:
            out.append(type(exc).__name__)
        if timed is not None:
            timed["entry"].append((time.perf_counter() - t) * 1e6)
        if k % 8 == 7:
            clock.advance_ms(1)
    for k in range(deco_calls):
        t = time.perf_counter()
        out.append(deco(k))
        if timed is not None:
            timed["decorated"].append((time.perf_counter() - t) * 1e6)
        if k % 8 == 7:
            clock.advance_ms(1)
    for k in range(wsgi_calls):
        t = time.perf_counter()
        out.append(web("/admin" if k % 16 == 0 else f"/item/{k % 97}"))
        if timed is not None:
            timed["wsgi"].append((time.perf_counter() - t) * 1e6)
        if k % 8 == 7:
            clock.advance_ms(1)
    return out


def _cp_steps(sph, dev, batches, failing, prev, strict: bool,
              host_ms=None) -> list:
    """Fused full-width decide+exit steps, 2 ms of virtual time apart,
    each dispatched (``strict``) with the sync debug mode at "error" →
    verdicts."""
    allow = []
    for rows in batches:
        sph.clock.advance_ms(2)
        if dev == "cuda":
            sync()
        t = time.perf_counter()
        with no_host_sync(strict):
            h = _fused_step(sph, rows, prev[0], failing)
        v = h.result()
        if host_ms is not None:
            host_ms.append((time.perf_counter() - t) * 1e3)
        allow.append(np.asarray(v.allow).tolist())
        prev[0] = rows[v.allow]
    return allow


def _cp_session(stt, sa, dev, R: int, tmp: str, B: int, steps: int,
                calls: int, deco_calls: int, wsgi_calls: int,
                cluster_calls: int, timing: bool, rtt_n: int = 32,
                turns: int = 4, tag: str = "", plain: bool = False,
                before_timing=None) -> dict:
    """One operator session on ``Sentinel(device=dev)`` at ``R`` rows
    through the entry points a user calls (see :func:`phase_command_
    plane`) → its observations: every response (command, status, body),
    every verdict, the reload's round trip, the embedded engine's windows
    and the engine state. The steps run under the sync debug mode
    "error" on the card unless ``plain`` (the plain seam waits on the
    device by design). With ``timing`` it then (after
    ``before_timing()``) times the round trips, the rule loads again and
    the calls and steps with polls off and on, in turns."""
    import io
    from sentinel_tpu_torch import adapters, api, convert
    from sentinel_tpu_torch.cluster.coordinator import ClusterCoordinator
    from sentinel_tpu_torch.core.logs import BlockStatLogger
    from sentinel_tpu_torch.datasource import (
        FileRefreshableDataSource, FileWritableDataSource,
        WritableDataSourceRegistry, rule_converter, rule_encoder,
    )
    from sentinel_tpu_torch.metrics.timer import MetricTimerListener
    from sentinel_tpu_torch.rules import codec
    from sentinel_tpu_torch.transport import start_transport
    os.makedirs(tmp, exist_ok=True)
    api.reset()
    clock = stt.ManualClock(start_ms=CP_T0)
    sph = api.init(stt.load_config(
        max_resources=R, max_flow_rules=2 * CP_RULED, app_name=CP_APP,
        metric_log_dir=os.path.join(tmp, "metrics")), clock=clock,
        device=dev)
    sph._cpu.sample = lambda: (0.5, 0.25)
    sph.block_log.close()
    sph.block_log = BlockStatLogger(clock, base_dir=os.path.join(tmp, "bl"))
    registry = WritableDataSourceRegistry()
    flow_file = os.path.join(tmp, "flow-rules.json")
    registry.register("flow", FileWritableDataSource(
        flow_file, rule_encoder("flow")))
    rt = start_transport(sph, host="127.0.0.1", port=0,
                         writable_registry=registry)
    # the twins must agree: the metric timer and the cadence scheduler
    # do not tick on the wall clock here; the session ticks the timer
    rt.metric_timer.stop()
    if rt.cadence is not None:
        rt.cadence.stop()
    timer = MetricTimerListener(sph)
    coord = ClusterCoordinator(sph, n_shards=CLUSTER_SHARDS,
                               flows_per_shard=16, param_keys_per_shard=64,
                               clock=clock)
    coord.bind(rt.cluster_state, rt.center)
    reader = FileRefreshableDataSource(flow_file, rule_converter("flow"),
                                       start_thread=False)
    poller = _CpPoller(rt.port)
    strict = dev == "cuda" and not plain
    res = {"http": [], "timing": {}, "section_s": {}}
    t_sec = [time.perf_counter()]

    def section(name):
        now = time.perf_counter()
        res["section_s"][name] = now - t_sec[0]
        t_sec[0] = now
        log(f"[command_plane] {tag} {name}: {res['section_s'][name]:.1f} s")

    def call(method, cmd, params=None, record=True):
        status, text, us = _cp_http(rt.port, method, cmd, params)
        if record:
            res["http"].append((cmd, status, _cp_body(text)))
        if status != 200:
            fail(f"command plane phase: {cmd} answered {status}: "
                 f"{text[:300]}")
        return us

    @adapters.sentinel_resource("cp-deco", sentinel=sph,
                                block_handler=lambda k, exc: "deco-blocked")
    def deco(k):
        return "deco-ok"

    def shop(environ, start_response):
        start_response("200 OK", [("Content-Type", "text/plain")])
        return [b"ok"]
    wsgi = adapters.SentinelWSGIMiddleware(
        shop, sph,
        url_cleaner=lambda p: "/item/{id}" if p.startswith("/item/") else p)

    def web(path):
        seen = {}

        def start_response(status, headers):
            seen["status"] = status
        body = b"".join(wsgi({"REQUEST_METHOD": "GET", "PATH_INFO": path,
                              "wsgi.input": io.BytesIO(b"")},
                             start_response))
        return seen["status"][:3] + body.decode()

    def push_rules(docs, record=True):
        ms = {}
        for rtype in ("flow", "degrade", "system", "authority"):
            ms[rtype] = call("POST", "setRules", {
                "type": rtype, "data": docs[rtype]}, record) / 1e3
        ms["paramFlow"] = call("POST", "setParamFlowRules", {
            "data": docs["paramFlow"]}, record) / 1e3
        return ms

    try:
        sa.LAUNCHES.clear()
        # (a) the rules, over loopback HTTP only
        docs = _cp_docs(stt, codec)
        res["timing"]["rule_load_ms_first"] = push_rules(docs)
        for rtype in ("flow", "degrade", "system", "authority"):
            call("GET", "getRules", {"type": rtype})
        call("GET", "getParamFlowRules")
        section("rules")
        # (b) application traffic, then the fused steps with polls beside
        res["calls"] = _cp_calls(stt, api, deco, web, clock, calls,
                                 deco_calls, wsgi_calls, seed=87)
        section("calls")
        clock.advance_ms(1000)
        res["ticked"] = [timer.tick()]
        call("GET", "clusterNode")
        call("GET", "metric", {"startTime": str(CP_T0),
                               "endTime": str(CP_T0 + 600_000)})
        batches, failing = _cp_stream(sph, B, steps)
        prev = [np.empty(0, np.int32)]
        poller.on(True)
        res["steps"] = _cp_steps(sph, dev, batches[:steps // 2], failing,
                                 prev, strict)
        # the mid-run reload: a push persisted through the writable
        # source comes back through a file source reading that file
        reload_doc = _cp_docs(stt, codec, flow_count=40.0)["flow"]
        call("POST", "setRules", {"type": "flow", "data": reload_doc})
        reader.refresh_now()
        back = codec.rules_to_json("flow", reader.get_property().get()
                                   or [])
        res["reload_round_trip"] = back == codec.rules_to_json(
            "flow", codec.rules_from_json("flow", reload_doc))
        res["steps"] += _cp_steps(sph, dev, batches[steps // 2:], failing,
                                  prev, strict)
        poller.on(False)
        section("steps")
        # (c) the embedded token server, over HTTP
        call("POST", "setClusterMode", {"mode": "1"})
        if coord.server is None:
            fail("command plane phase: setClusterMode did not start the "
                 "embedded token server")
        call("GET", "getClusterMode")
        call("POST", "cluster/server/modifyFlowRules", {
            "namespace": coord.namespace,
            "data": json.dumps([{
                "resource": f"c{i}", "count": float(4 + i % 8),
                "clusterMode": True,
                "clusterConfig": {"flowId": 1 + i, "thresholdType": 1}}
                for i in range(CP_CLUSTER)])})
        call("POST", "setRules", {"type": "flow", "data": _cp_docs(
            stt, codec, flow_count=40.0, cluster=True)["flow"]})
        rng = np.random.default_rng(89)
        cluster_out = []
        for k, i in enumerate(rng.integers(0, CP_CLUSTER,
                                           cluster_calls).tolist()):
            try:
                with api.entry(f"c{i}"):
                    cluster_out.append("pass")
            except stt.BlockException as exc:
                cluster_out.append(type(exc).__name__)
            if k % 16 == 15:
                clock.advance_ms(5)
        res["cluster_calls"] = cluster_out
        call("GET", "cluster/server/metricList",
             {"namespace": coord.namespace})
        call("GET", "cluster/server/info")
        res["cluster_state"] = convert.cluster_to_numpy(coord.server.engine)
        call("POST", "setClusterMode", {"mode": "-1"})
        section("cluster")
        # (d) the metric lines and the node tree
        clock.advance_ms(2000)
        res["ticked"].append(timer.tick())
        for cmd, params in (("metric", {"startTime": str(CP_T0),
                                        "endTime": str(CP_T0 + 600_000)}),
                            ("clusterNode", None), ("jsonTree", None),
                            ("cnode", {"id": "r7"}),
                            ("origin", {"id": "r5"}),
                            ("systemStatus", None)):
            call("GET", cmd, params)
        res["launches"] = sa.LAUNCHES["scatter_add"]
        res["state"] = convert.engine_to_numpy(sph)
        res["polls"] = {c: len(v) for c, v in poller.lat.items()}
        res["poll_bad"] = list(poller.bad)
        section("reads")
        if timing:
            if before_timing is not None:
                before_timing()     # the measurements below run alone
            t = res["timing"]
            t["rule_load_ms"] = push_rules(
                _cp_docs(stt, codec, cluster=True), record=False)
            t["rtt_us"] = {cmd: [_cp_http(rt.port, "GET", cmd, params)[2]
                                 for _ in range(rtt_n)]
                           for cmd, params in (
                               ("version", None),
                               ("getRules", {"type": "flow"}),
                               ("metric", {"startTime": str(CP_T0)}),
                               ("clusterNode", None))}
            # polls off and on, in turns: per-call µs and fused-step ms
            per = {flag: {"entry": [], "decorated": [], "wsgi": [],
                          "step_ms": []} for flag in ("off", "on")}
            extra, _f = _cp_stream(sph, B, 2 * turns, seed=91)
            for turn in range(turns):
                flag = "on" if turn % 4 in (1, 2) else "off"
                poller.on(flag == "on")
                # a device-decided call waits ~0.5 s for the GIL with
                # the polls on: few of those a turn
                _cp_calls(stt, api, deco, web, clock, calls // 32,
                          deco_calls // 32, wsgi_calls // 128,
                          seed=100 + turn, timed=per[flag])
                _cp_steps(sph, dev, extra[2 * turn:2 * turn + 2], failing,
                          prev, strict, host_ms=per[flag]["step_ms"])
            poller.on(False)
            t["turns"] = per
            t["poll_us"] = {c: list(v) for c, v in poller.lat.items()}
            res["poll_bad"] = list(poller.bad)
            section("timing")
    finally:
        poller.close()
        coord.stop()
        rt.stop()
        reader.close()
        api.reset()
        sph.close()
    return res


def _cp_twin_main(spec_path: str, out_path: str) -> int:
    """``chip_smoke.py --cp-twin SPEC OUT``: one twin session of phase 12
    in a process of its own (the spec: device, rows, plain seam, the
    session's sizes) → its observations, pickled to OUT."""
    import pickle
    import sentinel_tpu_torch as stt
    from sentinel_tpu_torch.ops import scatter_add as sa
    with open(spec_path) as fh:
        spec = json.load(fh)
    if spec["plain"]:
        sa.scatter_add = sa.scatter_add_reference       # the plain seam
    res = _cp_session(stt, sa, timing=False, **spec)
    with open(out_path, "wb") as fh:
        pickle.dump(res, fh)
    return 0


def phase_command_plane(stt, sa, dev="cuda", R=1 << 20, B=1 << 19,
                        steps: int = 16, twin_rows: int = 1 << 14,
                        calls: int = 4096, deco_calls: int = 2048,
                        wsgi_calls: int = 2048, cluster_calls: int = 1024,
                        rtt_n: int = 32, turns: int = 4) -> dict:
    """An operator drives a live agent over HTTP while its application
    admits traffic through the facade and the adapters:
    ``Sentinel(device="cuda")`` at ``R`` rows (default configuration)
    behind ``start_transport(port=0)``; (a) ``setRules`` of 4096 flow,
    1024 degrade, 1 system and 64 authority rules and
    ``setParamFlowRules`` of 512, all over loopback HTTP; (b) ``calls``
    ``api.entry``+exit, ``deco_calls`` ``@sentinel_resource`` calls and
    ``wsgi_calls`` WSGI requests (in-process environ dicts), then
    ``steps`` fused full-width steps of ``B`` events with a second thread
    polling ``metric``, ``clusterNode`` and ``obs`` over HTTP, a
    ``setRules`` reload half way that a ``FileWritableDataSource``
    persists and a ``FileRefreshableDataSource`` brings back; (c)
    ``setClusterMode`` to the embedded token server through the bound
    ``ClusterCoordinator``, ``cluster/server/modifyFlowRules``,
    ``cluster_calls`` cluster-ruled ``entry()``+exit and
    ``cluster/server/metricList``. The same session at ``twin_rows`` on
    the card, on the card with the plain seam in the kernel's place and
    on the CPU — each in a process of its own, beside the 1M run — must
    give the same verdicts and response bodies, the twins the same
    engine state, all four the same embedded engine windows. Once the
    twins are done the 1M run times the round trips, the rule loads and
    the calls and steps with polls on and off, in turns."""
    import pickle
    import tempfile
    from sentinel_tpu_torch import convert
    t_phase = time.perf_counter()
    kw = dict(B=B, steps=steps, calls=calls, deco_calls=deco_calls,
              wsgi_calls=wsgi_calls, cluster_calls=cluster_calls)
    twins = (("card_twin", dev, False), ("plain_twin", dev, True),
             ("cpu_twin", "cpu", False))
    runs, procs = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cp_") as tmp:
        for tag, d, plain in twins:
            spec = os.path.join(tmp, f"{tag}.json")
            with open(spec, "w") as fh:
                json.dump(dict(kw, dev=d, R=twin_rows, plain=plain,
                               tmp=os.path.join(tmp, tag), tag=tag), fh)
            out = open(os.path.join(tmp, f"{tag}.log"), "w")
            procs[tag] = (subprocess.Popen(
                CP_TWIN_CMD + [spec, os.path.join(tmp, f"{tag}.pkl")],
                stdout=out, stderr=subprocess.STDOUT), out)

        def join_twins():
            for tag, (proc, out) in procs.items():
                try:
                    rc = proc.wait(timeout=900)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                    rc = "timeout"
                out.close()
                if rc != 0:
                    with open(os.path.join(tmp, f"{tag}.log")) as fh:
                        tail = fh.read()[-3000:]
                    fail(f"command plane phase: the {tag} process ended "
                         f"with {rc}:\n{tail}")
                with open(os.path.join(tmp, f"{tag}.pkl"), "rb") as fh:
                    runs[tag] = pickle.load(fh)
            log(f"[command_plane] twins done at "
                f"{time.perf_counter() - t_phase:.1f} s: " + ", ".join(
                    f"{t} {sum(r['section_s'].values()):.1f} s"
                    for t, r in runs.items()))

        try:
            runs["card"] = _cp_session(
                stt, sa, dev, R, os.path.join(tmp, "card"), timing=True,
                rtt_n=rtt_n, turns=turns, tag="card",
                before_timing=join_twins, **kw)
        finally:
            for proc, out in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                out.close()
    card = runs["card"]
    for tag, run in runs.items():
        if run["poll_bad"]:
            fail(f"command plane phase: {tag} polls failed: "
                 f"{run['poll_bad'][:3]}")
        if not all(run["polls"].values()):
            fail(f"command plane phase: {tag} polled nothing: "
                 f"{run['polls']}")
        if not run["reload_round_trip"]:
            fail(f"command plane phase: {tag} file source did not bring "
                 f"the pushed rules back")
        for key in ("calls", "steps", "cluster_calls", "ticked"):
            if run[key] != card[key]:
                fail(f"command plane phase: {tag} {key} differ from the "
                     f"1M card run")
        if [h[:2] for h in run["http"]] != [h[:2] for h in card["http"]]:
            fail(f"command plane phase: {tag} statuses differ")
        # origins live in hashed alt rows, whose count follows the rows:
        # the 1M run's origin cells may merge otherwise than the twins'
        ref = runs["cpu_twin"] if tag != "card" else card
        for a, b, c in zip(run["http"], card["http"], ref["http"]):
            if a[2] != (c[2] if a[0] == "origin" else b[2]):
                fail(f"command plane phase: {tag} {a[0]} body differs")
        bad = convert.leaf_diff(card["cluster_state"], run["cluster_state"])
        if bad:
            fail(f"command plane phase: {tag} embedded engine differs: "
                 f"{bad}")
    for tag in ("card_twin", "plain_twin"):
        bad = convert.leaf_diff(runs["cpu_twin"]["state"], runs[tag]["state"])
        if bad:
            fail(f"command plane phase: {tag} state differs from the CPU "
                 f"twin: {bad}")
    if not card["launches"] or not runs["card_twin"]["launches"]:
        fail("command plane phase: the session launched no kernel")
    if runs["plain_twin"]["launches"]:
        fail("command plane phase: the plain-seam run launched the kernel")
    outcomes = collections.Counter(card["calls"] + card["cluster_calls"])
    for want in ("pass", "FlowException", "AuthorityException",
                 "DegradeException", "ParamFlowException", "deco-ok",
                 "deco-blocked", "200ok",
                 "429Blocked by Sentinel (flow limiting)"):
        if not outcomes.get(want):
            fail(f"command plane phase: the session never saw {want}: "
                 f"{dict(outcomes)}")
    if not sum(v.count(False) for v in card["steps"]):
        fail("command plane phase: no fused step denied an event")
    t = card["timing"]
    res = {"launches": card["launches"], "R": R, "B": B, "steps": steps,
           "outcomes": dict(outcomes), "polls": card["polls"],
           "rule_load_ms": t["rule_load_ms"],
           "rule_load_ms_first": t["rule_load_ms_first"],
           "rtt_us": {c: {"p50": float(np.percentile(v, 50)),
                          "p99": float(np.percentile(v, 99)), "n": len(v)}
                      for c, v in t["rtt_us"].items()},
           "per_call_us": {flag: {k: float(np.median(v)) for k, v in
                                  per.items() if k != "step_ms"}
                           for flag, per in t["turns"].items()},
           "step_host_ms": {flag: summary(per["step_ms"])
                            for flag, per in t["turns"].items()},
           "poll_us": {c: summary(v) for c, v in t["poll_us"].items()},
           "section_s": {tag: r["section_s"] for tag, r in runs.items()}}
    res["seconds"] = time.perf_counter() - t_phase
    rtt = res["rtt_us"]
    log(f"[command_plane] round trip at {R} rows (us p50/p99): " + ", ".join(
        f"{c} {v['p50']:.0f}/{v['p99']:.0f}" for c, v in rtt.items()))
    lm = t["rule_load_ms"]
    log(f"[command_plane] setRules of {CP_RULED + 2 + CP_CLUSTER} flow rules "
        f"{lm['flow']:.1f} ms, {CP_BREAKERS} degrade {lm['degrade']:.1f} "
        f"ms, setParamFlowRules of {2 * PARAM_RESOURCES} "
        f"{lm['paramFlow']:.1f} ms (HTTP, decode, compile, upload)")
    pc = res["per_call_us"]
    log(f"[command_plane] us a call (median), polls off/on: api.entry+exit "
        f"{pc['off']['entry']:.1f}/{pc['on']['entry']:.1f}, decorated "
        f"{pc['off']['decorated']:.1f}/{pc['on']['decorated']:.1f}, WSGI "
        f"{pc['off']['wsgi']:.1f}/{pc['on']['wsgi']:.1f}")
    sm = res["step_host_ms"]
    log(f"[command_plane] host ms a fused step of {B} events, polls "
        f"off/on: {sm['off']['median']:.2f}/{sm['on']['median']:.2f}; "
        f"polls answered {card['polls']}")
    log(f"[command_plane] verdicts, {len(card['http'])} response bodies "
        f"and the embedded engine equal at {R} rows on the card, "
        f"{twin_rows} on the card, with the plain seam and on the CPU; "
        f"state equal across the twins; outcomes {dict(outcomes)}")
    log(f"[command_plane] phase 12 took {res['seconds']:.1f} s; kernel "
        f"launches {card['launches']}")
    return res


# ---------------------------------------------------------------------------
# Phase 13: the API gateway, the Prometheus exporter and the native tables
# ---------------------------------------------------------------------------

GW_T0 = 1_820_000_000_000
GW_APP = "chip-smoke-gw"
GW_ROUTES = 64
GW_GROUPS = 16
GW_RULES = 256              # 224 on the routes (3 or 4 each), 32 on groups
GW_IPS = 1 << 16
#: what a rule throttles by, in eighths: 1/4 the route's QPS ($D), 1/4
#: the client IP, 1/8 each a header (exact pattern), a URL param (regex
#: or contains), a cookie, the host
GW_KINDS = ("route", "route", "ip", "ip", "header", "url", "cookie", "host")
#: scraped samples that follow the table's geometry (see phase_gateway)
GW_GEOMETRY = ("sentinel_split_route_total",)
#: the command that runs one twin session in a process of its own
GW_TWIN_CMD = [sys.executable, os.path.abspath(__file__), "--gw-twin"]


def _gw_docs(tgw, tpf, gcodec) -> tuple:
    """(API groups JSON, gateway rules JSON) as a dashboard pushes them:
    16 groups (exact, prefix and regex predicates; the odd ones also an
    exact path shared by 4 groups) and 256 rules on 64 routes and those
    groups (every fifth rule a 2 s interval, every seventh a burst of 2,
    every ninth RATE_LIMITER at 200 ms, a few THREAD grade)."""
    g = tgw
    strategies = (g.URL_MATCH_STRATEGY_EXACT, g.URL_MATCH_STRATEGY_PREFIX,
                  g.URL_MATCH_STRATEGY_REGEX)
    defs = []
    for i in range(GW_GROUPS):
        pattern = (f"/api/g{i}/items", f"/api/g{i}/**", rf"/api/g{i}/\d+")
        items = [g.ApiPathPredicateItem(pattern[i % 3], strategies[i % 3])]
        if i % 2:
            items.append(g.ApiPathPredicateItem(f"/api/shared{i % 4}"))
        defs.append(g.ApiDefinition(f"grp{i}", tuple(items)))
    on_routes = GW_RULES - 2 * GW_GROUPS
    rules = []
    for k in range(GW_RULES):
        if k < on_routes:
            res, mode = f"route{k % GW_ROUTES}", g.RESOURCE_MODE_ROUTE_ID
            kind = GW_KINDS[(k // GW_ROUTES + k) % 8]
        else:
            res, mode = f"grp{k % GW_GROUPS}", g.RESOURCE_MODE_CUSTOM_API_NAME
            kind = GW_KINDS[k % 8]
        item = {
            "route": None,
            "ip": g.GatewayParamFlowItem(
                parse_strategy=g.PARAM_PARSE_STRATEGY_CLIENT_IP),
            "header": g.GatewayParamFlowItem(
                parse_strategy=g.PARAM_PARSE_STRATEGY_HEADER,
                field_name="X-Tenant", pattern="t1",
                match_strategy=g.PARAM_MATCH_STRATEGY_EXACT),
            "url": g.GatewayParamFlowItem(
                parse_strategy=g.PARAM_PARSE_STRATEGY_URL_PARAM,
                field_name="uid",
                pattern=r"\d{1,2}" if k % 2 == 0 else "7",
                match_strategy=(g.PARAM_MATCH_STRATEGY_REGEX if k % 2 == 0
                                else g.PARAM_MATCH_STRATEGY_CONTAINS)),
            "cookie": g.GatewayParamFlowItem(
                parse_strategy=g.PARAM_PARSE_STRATEGY_COOKIE,
                field_name="sid"),
            "host": g.GatewayParamFlowItem(
                parse_strategy=g.PARAM_PARSE_STRATEGY_HOST),
        }[kind]
        paced = k % 9 == 4
        rules.append(g.GatewayFlowRule(
            resource=res, resource_mode=mode,
            grade=(tpf.GRADE_THREAD if k % 13 == 6 and not paced
                   else tpf.GRADE_QPS),
            count={"route": 40.0, "ip": 3.0, "header": 5.0, "url": 4.0,
                   "cookie": 6.0, "host": 30.0}[kind],
            interval_sec=2 if k % 5 == 0 else 1,
            control_behavior=(tpf.BEHAVIOR_RATE_LIMITER if paced
                              else tpf.BEHAVIOR_DEFAULT),
            burst=2 if k % 7 == 0 else 0, max_queueing_timeout_ms=200,
            param_item=item))
    return gcodec.api_definitions_to_json(defs), \
        gcodec.gateway_rules_to_json(rules)


def _gw_requests(n: int, seed: int) -> list:
    """``n`` ASGI http scopes: routes Zipf(1.1) over 64 (the route id in
    the scope, as a gateway's route table resolves it), client IPs
    Zipf(1.1) over 2^16, tenants Zipf(1.1) over 16 (1 in 4 requests
    without the header), session cookies Zipf(1.1) over 1024, 4 hosts,
    ``uid`` URL params; 20% of the paths in an API group."""
    from sentinel_tpu_torch.frontend.workloads import _zipf_ranks
    rng = np.random.default_rng(seed)
    routes = _zipf_ranks(rng, n, 1.1, GW_ROUTES) - 1
    ips = _zipf_ranks(rng, n, 1.1, GW_IPS) - 1
    tenants = _zipf_ranks(rng, n, 1.1, 16) - 1
    sids = _zipf_ranks(rng, n, 1.1, 1024)
    in_group = rng.random(n) < 0.2
    groups = rng.integers(0, GW_GROUPS, n)
    uids = rng.integers(0, 200, n)
    form = rng.integers(0, 4, n)
    out = []
    for i in range(n):
        g, uid = int(groups[i]), int(uids[i])
        if in_group[i]:
            path = (f"/api/g{g}/items", f"/api/g{g}/x/{i % 7}",
                    f"/api/g{g}/{uid}")[g % 3]
            if g % 2 and form[i] == 0:
                path = f"/api/shared{g % 4}"
        else:
            path = f"/svc/route{int(routes[i])}/item{i % 50}"
        ip = int(ips[i])
        headers = [(b"host", f"h{i % 4}.example.com".encode()),
                   (b"cookie", f"theme=dark; sid=s{int(sids[i])}".encode())]
        if form[i] != 3:
            headers.append((b"x-tenant", f"t{int(tenants[i])}".encode()))
        out.append({"type": "http", "method": "GET", "path": path,
                    "query_string": f"uid={uid}&page={i % 3}".encode(),
                    "headers": headers,
                    "client": (f"10.{ip >> 8}.{ip & 255}.1", 40000 + i % 997),
                    "route": f"route{int(routes[i])}"})
    return out


def _gw_scrape(sph) -> dict:
    """One exporter scrape (``generate_latest`` on a private registry) →
    its families and samples and, timed, five more: ms, bytes and
    samples; None without ``prometheus_client``."""
    try:
        from prometheus_client import CollectorRegistry, generate_latest
    except ImportError:
        return None
    from sentinel_tpu_torch.metrics.exporter import PrometheusExporter
    reg = CollectorRegistry()
    exp = PrometheusExporter(sph, registry=reg)
    try:
        fams = list(reg.collect())
        out = {"families": sorted(f.name for f in fams),
               "samples": sorted(
                   (s.name, tuple(sorted(s.labels.items())), s.value)
                   for f in fams for s in f.samples),
               "n_samples": sum(len(f.samples) for f in fams), "ms": []}
        for _ in range(5):
            t = time.perf_counter()
            text = generate_latest(reg)
            out["ms"].append((time.perf_counter() - t) * 1e3)
        out["bytes"] = len(text)
    finally:
        exp.close()
    return out


def _gw_session(stt, sa, dev, R: int, tmp: str, requests: int,
                timing: bool, timing_requests: int = 512, tag: str = "",
                before_timing=None) -> dict:
    """One gateway session on ``Sentinel(device=dev)`` at ``R`` rows
    (default configuration) behind ``start_transport(port=0,
    gateway_manager=, api_definition_manager=, exporter_port=9464)`` (see
    :func:`phase_gateway`) → its observations: every response, every
    request's status and pacing wait, the scrape, the tables' classes
    and the engine state. With ``timing`` it then (after
    ``before_timing()``) times the rule push again and
    ``timing_requests`` more requests."""
    import asyncio
    import types
    from sentinel_tpu_torch import convert
    from sentinel_tpu_torch import gateway as tgw
    from sentinel_tpu_torch.adapters import SentinelGatewayASGIMiddleware
    from sentinel_tpu_torch.adapters import asgi_gateway
    from sentinel_tpu_torch.core.logs import BlockStatLogger
    from sentinel_tpu_torch.gateway import codec as gcodec
    from sentinel_tpu_torch.rules import codec
    from sentinel_tpu_torch.rules import param_flow as tpf
    from sentinel_tpu_torch.transport import start_transport
    os.makedirs(tmp, exist_ok=True)
    clock = stt.ManualClock(start_ms=GW_T0)
    sph = stt.Sentinel(config=stt.load_config(
        max_resources=R, max_flow_rules=2 * CP_RULED, app_name=GW_APP,
        metric_log_dir=os.path.join(tmp, "metrics")), clock=clock,
        device=dev)
    sph._cpu.sample = lambda: (0.5, 0.25)
    sph.block_log.close()
    sph.block_log = BlockStatLogger(clock, base_dir=os.path.join(tmp, "bl"))
    mgr = tgw.GatewayRuleManager(sph)
    api_mgr = tgw.GatewayApiDefinitionManager()
    rt = start_transport(sph, host="127.0.0.1", port=0,
                         gateway_manager=mgr, api_definition_manager=api_mgr,
                         exporter_port=9464)
    rt.metric_timer.stop()
    if rt.cadence is not None:
        rt.cadence.stop()
    res = {"http": [], "timing": {}, "section_s": {}}
    t_sec = [time.perf_counter()]

    def section(name):
        now = time.perf_counter()
        res["section_s"][name] = now - t_sec[0]
        t_sec[0] = now
        log(f"[gateway] {tag} {name}: {res['section_s'][name]:.1f} s")

    def call(method, cmd, params=None, record=True):
        status, text, us = _cp_http(rt.port, method, cmd, params)
        if record:
            res["http"].append((cmd, status, _cp_body(text)))
        if status != 200:
            fail(f"gateway phase: {cmd} answered {status}: {text[:300]}")
        return us

    async def app(scope, receive, send):
        await send({"type": "http.response.start", "status": 200,
                    "headers": []})
        await send({"type": "http.response.body", "body": b"ok"})
    guarded = SentinelGatewayASGIMiddleware(
        app, sph, mgr, api_mgr, route_resolver=lambda scope: scope["route"])
    waits = []

    async def virtual_sleep(seconds):
        # the run's clock is a ManualClock: a pacing wait is recorded as
        # part of the verdict, not slept on the wall clock
        waits.append(seconds)

    def drive(reqs, lat_us=None) -> list:
        out = []

        async def run():
            async def receive():
                return {"type": "http.request", "body": b"",
                        "more_body": False}
            for k, scope in enumerate(reqs):
                sent = []

                async def send(msg, sent=sent):
                    sent.append(msg)
                del waits[:]
                t = time.perf_counter()
                await guarded(scope, receive, send)
                if lat_us is not None:
                    lat_us.append((time.perf_counter() - t) * 1e6)
                out.append((sent[0]["status"], tuple(waits)))
                if k % 8 == 7:
                    clock.advance_ms(1)
        real_asyncio = asgi_gateway.asyncio
        asgi_gateway.asyncio = types.SimpleNamespace(sleep=virtual_sleep)
        try:
            asyncio.run(run())
        finally:
            asgi_gateway.asyncio = real_asyncio
        return out

    try:
        docs = _cp_docs(stt, codec)
        for rtype in ("flow", "system"):
            call("POST", "setRules", {"type": rtype, "data": docs[rtype]})
        apis_json, rules_json = _gw_docs(tgw, tpf, gcodec)
        call("POST", "gateway/updateApiDefinitions", {"data": apis_json})
        res["timing"]["update_rules_ms_first"] = call(
            "POST", "gateway/updateRules", {"data": rules_json}) / 1e3
        for cmd in ("gateway/getRules", "gateway/getApiDefinitions",
                    "getParamFlowRules"):
            call("GET", cmd)
        section("rules")
        reqs = _gw_requests(requests, seed=131)
        sa.LAUNCHES.clear()
        res["requests"] = drive(reqs)
        res["launches"] = sa.LAUNCHES["scatter_add"]
        section("requests")
        for cmd in ("gateway/getRules", "gateway/getApiDefinitions"):
            call("GET", cmd)
        info = json.loads(_cp_http(rt.port, "GET", "basicInfo")[1])
        res["exporter_port"] = info.get("exporterPort")
        res["totals"] = {n: sph.node_totals(n) for n in
                         [f"route{i}" for i in range(GW_ROUTES)]
                         + [f"grp{i}" for i in range(GW_GROUPS)]}
        res["scrape"] = _gw_scrape(sph)
        res["tables"] = {k: type(getattr(sph, k)).__name__ for k in (
            "resources", "origins", "contexts", "param_key_registry")}
        res["state"] = convert.engine_to_numpy(sph)
        section("reads")
        if timing:
            if before_timing is not None:
                before_timing()     # the measurements below run alone
            t = res["timing"]
            t["update_rules_ms"] = [call("POST", "gateway/updateRules",
                                         {"data": rules_json},
                                         record=False) / 1e3
                                    for _ in range(5)]
            lat = []
            drive(_gw_requests(timing_requests, seed=137), lat)
            t["request_us"] = lat
            t["scrape"] = _gw_scrape(sph)
            section("timing")
    finally:
        rt.stop()
        sph.close()
    return res


def _gw_twin_main(spec_path: str, out_path: str) -> int:
    """``chip_smoke.py --gw-twin SPEC OUT``: one twin session of phase 13
    in a process of its own → its observations, pickled to OUT."""
    import pickle
    import sentinel_tpu_torch as stt
    from sentinel_tpu_torch.ops import scatter_add as sa
    with open(spec_path) as fh:
        spec = json.load(fh)
    if spec.pop("plain"):
        sa.scatter_add = sa.scatter_add_reference       # the plain seam
    res = _gw_session(stt, sa, timing=False, **spec)
    with open(out_path, "wb") as fh:
        pickle.dump(res, fh)
    return 0


def _gw_native_legs(stt, sa, dev, R: int, names_B: int, pair_B: int,
                    turns: int) -> dict:
    """The native C++ interning tables against the Python ones, in turns
    (each on a table or runtime of its own, the same input each turn):
    (1) an intern of ``names_B`` fresh names into a table of ``R`` rows
    (one batch call against a Python loop); (2) ``entry_batch`` of
    ``names_B`` fresh names on ``R``-row runtimes (the scalar fixture's
    rules); (3) phase 7's ``pair_B``-event param batch (the pair
    resolution's host ms). Equal rows and verdicts in every pair."""
    from sentinel_tpu_torch import runtime as trt
    from sentinel_tpu_torch.core import registry as treg
    from sentinel_tpu_torch.native import NativeRegistry
    kinds = ("native", "python")
    out = {"intern_ms": {k: [] for k in kinds},
           "entry_batch_ms": {k: [] for k in kinds},
           "resolve_ms": {k: [] for k in kinds},
           "pair_call_ms": {k: [] for k in kinds}}

    def order(turn):
        return kinds if turn % 2 == 0 else kinds[::-1]

    for turn in range(turns):
        names = [f"i{turn}-{k}" for k in range(names_B)]
        rows = {}
        for n in order(turn):
            if n == "native":
                reg = NativeRegistry(R, reserved=(treg.ENTRY_NODE_NAME,))
                t = time.perf_counter()
                rows[n] = reg.get_or_create_batch(names)
            else:
                reg = treg.Registry(R, reserved=(treg.ENTRY_NODE_NAME,))
                t = time.perf_counter()
                rows[n] = np.fromiter((reg.get_or_create(x) for x in names),
                                      np.int32, count=names_B)
            out["intern_ms"][n].append((time.perf_counter() - t) * 1e3)
            del reg
        if not np.array_equal(rows["native"], rows["python"]):
            fail("gateway phase: the native and Python tables interned "
                 "to different rows")

    def pair_of_runtimes(build):
        """``build()`` under ``SENTINEL_TPU_NATIVE=1`` and ``=0`` → its
        two results by kind (a runtime first in each)."""
        out = {}
        for n in kinds:
            with _knobs(SENTINEL_TPU_NATIVE=int(n == "native")):
                out[n] = build()
            sph_n = out[n][0] if isinstance(out[n], tuple) else out[n]
            if isinstance(sph_n.resources, NativeRegistry) != (n == "native"):
                fail(f"gateway phase: the {n} runtime interns through "
                     f"{type(sph_n.resources).__name__}")
        return out

    def same(got, what, turn):
        a, b = got["native"], got["python"]
        for f in ("allow", "reason", "wait_ms"):
            if not np.array_equal(np.asarray(getattr(a, f)),
                                  np.asarray(getattr(b, f))):
                fail(f"gateway phase: {what} {f} differ between the native "
                     f"and the Python tables at turn {turn}")

    sph = pair_of_runtimes(lambda: _obs_runtime(
        stt, R, stt.ManualClock(start_ms=GW_T0), dev))
    for turn in range(turns):
        names = [f"f{turn}-{k}" for k in range(names_B)]
        got = {}
        for n in order(turn):
            sync()
            t = time.perf_counter()
            got[n] = sph[n].entry_batch(names)
            out["entry_batch_ms"][n].append((time.perf_counter() - t) * 1e3)
            sph[n].clock.advance_ms(25)
        same(got, "entry_batch verdicts", turn)
    for s in sph.values():
        s.close()
    del sph

    built = pair_of_runtimes(lambda: _pair_runtime(stt, R, dev, GW_T0))
    sph = {n: b[0] for n, b in built.items()}
    pool = built["native"][1]
    if not np.array_equal(pool, built["python"][1]):
        fail("gateway phase: the param runtimes' pools differ")
    rng = np.random.default_rng(22)
    spent = []
    with _timed_resolution(trt, spent):
        for turn in range(turns):
            rows, args = _pair_batch(rng, pool, pair_B)
            got = {}
            for n in order(turn):
                sync()
                t = time.perf_counter()
                got[n] = sph[n].entry_batch(rows, args_list=args)
                out["pair_call_ms"][n].append(
                    (time.perf_counter() - t) * 1e3)
                out["resolve_ms"][n].append(spent[-1] * 1e3)
                sph[n].clock.advance_ms(3)
            same(got, "param batch verdicts", turn)
    for s in sph.values():
        s.close()
    return out


def phase_gateway(stt, sa, dev="cuda", R=1 << 20, twin_rows=1 << 14,
                  requests: int = 4096, timing_requests: int = 512,
                  names_B: int = 1 << 16, pair_B: int = 1 << 19,
                  turns: int = 4) -> dict:
    """An API gateway in front of a service, driven as its users drive
    it: ``Sentinel(device="cuda")`` at ``R`` rows (default configuration,
    the scalar fixture's 4096 QPS rules and a system rule, as in phase
    12) behind ``start_transport(port=0, gateway_manager=,
    api_definition_manager=, exporter_port=9464)``; over loopback HTTP
    ``gateway/updateApiDefinitions`` with 16 API groups and
    ``gateway/updateRules`` with 256 gateway rules on 64 routes and those
    groups; ``requests`` requests through ``SentinelGatewayASGIMiddleware``
    on an asyncio loop (routes Zipf(1.1) over 64, client IPs Zipf(1.1)
    over 2^16, 20% of the paths in an API group; every request is
    inbound, so each of its entries is a device decide through the param
    slot); then one exporter scrape. The same session at ``twin_rows``
    on the card, with the plain seam and on the CPU (processes of their
    own, beside the 1M run) must give the same statuses and pacing
    waits, response bodies and scraped samples (and the twins the same
    state). Then, alone: the rule push, µs a request, ms a scrape, and
    :func:`_gw_native_legs`."""
    import pickle
    import tempfile
    from sentinel_tpu_torch import convert
    t_phase = time.perf_counter()
    kw = dict(requests=requests)
    twins = (("card_twin", dev, False), ("plain_twin", dev, True),
             ("cpu_twin", "cpu", False))
    runs, procs = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gw_") as tmp:
        for tag, d, plain in twins:
            spec = os.path.join(tmp, f"{tag}.json")
            with open(spec, "w") as fh:
                json.dump(dict(kw, dev=d, R=twin_rows, plain=plain,
                               tmp=os.path.join(tmp, tag), tag=tag), fh)
            out = open(os.path.join(tmp, f"{tag}.log"), "w")
            procs[tag] = (subprocess.Popen(
                GW_TWIN_CMD + [spec, os.path.join(tmp, f"{tag}.pkl")],
                stdout=out, stderr=subprocess.STDOUT), out)

        def join_twins():
            for tag, (proc, out) in procs.items():
                try:
                    rc = proc.wait(timeout=600)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                    rc = "timeout"
                out.close()
                if rc != 0:
                    with open(os.path.join(tmp, f"{tag}.log")) as fh:
                        tail = fh.read()[-3000:]
                    fail(f"gateway phase: the {tag} process ended with "
                         f"{rc}:\n{tail}")
                with open(os.path.join(tmp, f"{tag}.pkl"), "rb") as fh:
                    runs[tag] = pickle.load(fh)
            log(f"[gateway] twins done at "
                f"{time.perf_counter() - t_phase:.1f} s: " + ", ".join(
                    f"{t} {sum(r['section_s'].values()):.1f} s"
                    for t, r in runs.items()))

        try:
            runs["card"] = _gw_session(
                stt, sa, dev, R, os.path.join(tmp, "card"), timing=True,
                timing_requests=timing_requests, tag="card",
                before_timing=join_twins, **kw)
        finally:
            for proc, out in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                out.close()
    card = runs["card"]
    for tag, run in runs.items():
        if run["requests"] != card["requests"]:
            bad = [k for k, (a, b) in enumerate(zip(run["requests"],
                                                    card["requests"]))
                   if a != b]
            fail(f"gateway phase: {tag} statuses or waits differ from the "
                 f"1M card run at {len(bad)} requests, first {bad[:5]}")
        if run["http"] != card["http"]:
            fail(f"gateway phase: {tag} response bodies differ")
        if run["totals"] != card["totals"]:
            fail(f"gateway phase: {tag} node totals differ")
        if run["scrape"] is not None and card["scrape"] is not None:
            # the route a decide takes follows the table's geometry (the
            # fast route where the context key fits 16k rows, the general
            # one at 1M): the split_route family is held among the twins
            ref = runs["cpu_twin"] if tag != "card" else card
            for key in ("families", "samples"):
                mine = run["scrape"][key]
                want = card["scrape"][key]
                if key == "samples":
                    mine = [x for x in mine if x[0] not in GW_GEOMETRY]
                    want = [x for x in want if x[0] not in GW_GEOMETRY]
                    if run["scrape"][key] != ref["scrape"][key]:
                        fail(f"gateway phase: {tag} scraped samples differ "
                             f"from the CPU twin's")
                if mine != want:
                    a, b = set(mine), set(want)
                    fail(f"gateway phase: {tag} scraped {key} differ: "
                         f"{sorted(a - b)[:4]} vs {sorted(b - a)[:4]}")
        if run["exporter_port"] != 9464:
            fail(f"gateway phase: {tag} basicInfo exporterPort "
                 f"{run['exporter_port']}")
        natives = {"resources": "NativeRegistry", "origins": "NativeRegistry",
                   "contexts": "NativeRegistry",
                   "param_key_registry": "NativeParamKeyRegistry"}
        if run["tables"] != natives:
            fail(f"gateway phase: {tag} interning tables {run['tables']}")
    for tag in ("card_twin", "plain_twin"):
        bad = convert.leaf_diff(runs["cpu_twin"]["state"], runs[tag]["state"])
        if bad:
            fail(f"gateway phase: {tag} state differs from the CPU twin: "
                 f"{bad}")
    if not card["launches"] or not runs["card_twin"]["launches"]:
        fail("gateway phase: the requests launched no kernel")
    if runs["plain_twin"]["launches"]:
        fail("gateway phase: the plain-seam run launched the kernel")
    statuses = collections.Counter(s for s, _w in card["requests"])
    paced = sum(1 for _s, w in card["requests"] if w)
    if not statuses.get(200) or not statuses.get(429) or not paced:
        fail(f"gateway phase: statuses {dict(statuses)}, paced {paced}: "
             f"the requests must pass, block and wait")
    if card["scrape"] is None:
        log("[exporter] prometheus_client not installed: scrape leg not run")
    t = card["timing"]
    res = {"launches": card["launches"], "R": R, "requests": requests,
           "statuses": dict(statuses), "paced": paced,
           "update_rules_ms_first": t["update_rules_ms_first"],
           "update_rules_ms": t["update_rules_ms"],
           "request_us": {"p50": float(np.percentile(t["request_us"], 50)),
                          "p99": float(np.percentile(t["request_us"], 99)),
                          "n": len(t["request_us"])},
           "section_s": {tag: r["section_s"] for tag, r in runs.items()}}
    if t["scrape"] is not None:
        res["scrape"] = {"ms": t["scrape"]["ms"],
                         "samples": t["scrape"]["n_samples"],
                         "bytes": t["scrape"]["bytes"],
                         "twin_samples": runs["card_twin"]["scrape"][
                             "n_samples"]}
    log(f"[gateway] {requests} requests at {R} rows: {dict(statuses)}, "
        f"{paced} paced; statuses, waits, {len(card['http'])} response "
        f"bodies, node totals and the scrape equal at {twin_rows} rows on "
        f"the card, with the plain seam and on the CPU; state equal across "
        f"the twins; kernel launches {card['launches']}")
    log(f"[gateway] us a gateway request (alone, {len(t['request_us'])}): "
        f"p50 {res['request_us']['p50']:.1f}, p99 "
        f"{res['request_us']['p99']:.1f}; gateway/updateRules of "
        f"{GW_RULES} rules {np.median(t['update_rules_ms']):.2f} ms "
        f"(median of 5; first {t['update_rules_ms_first']:.2f})")
    if "scrape" in res:
        log(f"[exporter] scrape at {R} rows: "
            f"{np.median(res['scrape']['ms']):.2f} ms (median of 5), "
            f"{res['scrape']['samples']} samples, {res['scrape']['bytes']} "
            f"bytes; basicInfo exporterPort 9464")
    res["native"] = nat = _gw_native_legs(stt, sa, dev, R, names_B, pair_B,
                                          turns)
    med = {k: {n: float(np.median(v)) for n, v in d.items()}
           for k, d in nat.items()}
    res["native_median"] = med
    log(f"[native] tables of the 1M runtime: {card['tables']}")
    log(f"[native] ms, native / Python (medians of {turns} turns): intern "
        f"of {names_B} names {med['intern_ms']['native']:.2f} / "
        f"{med['intern_ms']['python']:.2f}; entry_batch of {names_B} fresh "
        f"names {med['entry_batch_ms']['native']:.2f} / "
        f"{med['entry_batch_ms']['python']:.2f}; pair resolution of "
        f"{pair_B} events {med['resolve_ms']['native']:.2f} / "
        f"{med['resolve_ms']['python']:.2f} (whole call "
        f"{med['pair_call_ms']['native']:.2f} / "
        f"{med['pair_call_ms']['python']:.2f}); equal rows and verdicts")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[gateway] phase 13 took {res['seconds']:.1f} s; kernel launches "
        f"{card['launches']}")
    return res


# ---------------------------------------------------------------------------
# Phase 14: the dashboard and the outbound, aiohttp and gRPC adapters
# ---------------------------------------------------------------------------

DB_T0 = 1_830_000_000_000
DB_APP = "chip-smoke-db"
DB_PASSWORD = "chip-smoke"
#: rules created one by one over the dashboard's /v1/{type}/rule, by
#: family (each family one more, updated and deleted again)
DB_RULES = (("flow", 256), ("degrade", 64), ("system", 1), ("authority", 16),
            ("paramFlow", 64), ("gatewayFlow", 64), ("gatewayApi", 8))
DB_POOL = 8192               # rule-free names of the fused steps
#: the dashboard's deadline for an agent call
#: (``SENTINEL_DASH_AGENT_TIMEOUT_S``, the reference's knob): the client's
#: 3 s default does not hold for the first rule push into a cold agent on
#: the card while the twins start beside it (the push's ms are reported)
DB_AGENT_TIMEOUT_S = 30.0
DB_HELD = 4096               # flow rules held when a rule push is timed
#: the dashboard at its real cadence: (poller, period s, first firing s)
#: — the metric fetcher every 6 s (``fetcher.FETCH_INTERVAL_S``), one
#: browser on the Resources view (3 s) and on Hot Resources (5 s), and the
#: SPA's app list (10 s)
DB_CADENCE = (("fetch", 6.0, 1.0), ("resources", 3.0, 0.5),
              ("hot", 5.0, 1.5), ("apps", 10.0, 0.2))
#: body fields that follow the wall clock, dropped by name before the
#: bodies are compared: the dashboard stamps a heartbeat when it lands
#: and the agent when its thread sends it; latency histograms and span
#: durations are host times
DB_WALL = ("lastHeartbeat", "heartbeatVersion", "hist", "spans")
#: body fields that follow the table's geometry, held among the twins
#: only: the telemetry's rows a shard, and the counters of the route a
#: decide takes (where the context key fits 16k rows it takes the fast
#: route, at 1M the general one)
DB_GEOMETRY = ("rows_per_shard", "split_route.", "sortfree.")
#: the command that runs one twin session in a process of its own
DB_TWIN_CMD = [sys.executable, os.path.abspath(__file__), "--db-twin"]
#: the command that runs a session's dashboard in a process of its own
DB_DASH_CMD = [sys.executable, os.path.abspath(__file__), "--dashboard"]


class _DbClock:
    """The dashboard process's clock: set by the session to its agent's
    ManualClock time, or, for the timed turns, running on the wall clock
    from the agent's time at the switch."""

    def __init__(self, ms: int):
        self._ms, self._follow = ms, None

    def now_ms(self) -> int:
        if self._follow is None:
            return self._ms
        base, t0 = self._follow
        return base + int((time.perf_counter() - t0) * 1e3)

    def set_ms(self, ms: int) -> None:
        self._ms, self._follow = ms, None

    def follow(self, ms: int) -> None:
        self._follow = (ms, time.perf_counter())


def _db_request(port: int, method: str, path: str, body=None, cookie=None,
                timeout: float = 120):
    """One REST call to a dashboard as the SPA sends it (JSON body, the
    session cookie) → (status, parsed body or text, µs, headers)."""
    import urllib.error
    import urllib.request
    headers = {"Content-Type": "application/json"}
    if cookie:
        headers["Cookie"] = cookie
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method, headers=headers,
        data=json.dumps(body).encode() if body is not None else None)
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, text, hdrs = r.status, r.read().decode("utf-8"), r.headers
    except urllib.error.HTTPError as exc:
        status, text, hdrs = exc.code, exc.read().decode("utf-8"), exc.headers
    us = (time.perf_counter() - t) * 1e6
    try:
        doc = json.loads(text)
    except ValueError:
        doc = text
    return status, doc, us, hdrs


class _DbCadence:
    """The dashboard's pollers at their real cadence (:data:`DB_CADENCE`),
    each a thread of the dashboard's process: the metric fetcher's loop
    body (``fetch_all_once``) and three browser views over the REST API
    (the Resources view, Hot Resources, the app list)."""

    def __init__(self, dash, port: int, cookie: str, ip: str,
                 agent_port: int):
        import threading
        self.dash, self.port, self.cookie = dash, port, cookie
        q = f"ip={ip}&port={agent_port}"
        self.paths = {"resources": f"/resource/machineResource.json?{q}",
                      "hot": f"/obs/topk.json?{q}&timeline=60",
                      "apps": "/app/names.json"}
        self.us = {name: [] for name, _p, _f in DB_CADENCE}
        self.bad = []
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, args=c,
                                          daemon=True, name=f"cadence-{c[0]}")
                         for c in DB_CADENCE]
        for t in self._threads:
            t.start()

    def _run(self, name: str, period: float, first: float) -> None:
        t0, k = time.perf_counter(), 0
        while not self._stop.wait(max(0.0, t0 + first + k * period
                                      - time.perf_counter())):
            k += 1
            t = time.perf_counter()
            try:
                if name == "fetch":
                    self.dash.fetcher.fetch_all_once()
                else:
                    status, doc, _us, _h = _db_request(
                        self.port, "GET", self.paths[name],
                        cookie=self.cookie)
                    if status != 200 or not doc.get("success"):
                        self.bad.append((name, status, str(doc)[:200]))
            except Exception as exc:        # noqa: BLE001 — reported
                self.bad.append((name, repr(exc)))
            self.us[name].append((time.perf_counter() - t) * 1e6)

    def close(self) -> dict:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=120)
        return {"us": self.us, "bad": self.bad}


def _db_repo(d) -> dict:
    """A dashboard's repositories: every rule entity by family, every
    fetched metric entity, every machine (less :data:`DB_WALL`)."""
    now = d._now_ms()
    return {
        "rules": {t: [e.to_dict() for e in sorted(repo._by_id.values(),
                                                  key=lambda e: e.id)]
                  for t, repo in d.rules.items()},
        "metrics": {app: {res: [e.to_dict() for e in ring.values()]
                          for res, ring in rings.items()}
                    for app, rings in d.metrics._data.items()},
        "machines": {app: [_db_drop(m.to_dict(now), DB_WALL)
                           for m in d.apps.machines(app)]
                     for app in d.apps.app_names()}}


def _db_drop(doc, names: tuple):
    """``doc`` less every field whose name starts with one of ``names``
    (:data:`DB_WALL`, :data:`DB_GEOMETRY`), at any depth."""
    if isinstance(doc, dict):
        return {k: _db_drop(v, names) for k, v in doc.items()
                if not k.startswith(names)}
    if isinstance(doc, (list, tuple)):
        return [_db_drop(v, names) for v in doc]
    return doc


def _db_dash_main(spec_path: str) -> int:
    """``chip_smoke.py --dashboard SPEC``: a session's dashboard in a
    process of its own — ``DashboardServer(port=0)`` with a password on
    a :class:`_DbClock` — with a control server beside it through which
    the session sets the clock, runs a fetch, reads the repositories and
    switches the real cadence on and off. Writes both ports to the spec's
    ``out`` file; ends on ``/quit`` or when its parent is gone."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from sentinel_tpu_torch.dashboard import Dashboard, DashboardServer
    with open(spec_path) as fh:
        spec = json.load(fh)
    clock = _DbClock(spec["t0"])
    server = DashboardServer(Dashboard(
        password=spec["password"], clock=clock,
        agent_timeout_s=spec["agent_timeout_s"]), host="127.0.0.1", port=0)
    port = server.start(fetch=False)
    d = server.dashboard
    state = {"cadence": None}
    done = threading.Event()

    def handle(path: str, p: dict) -> dict:
        if path == "/clock":
            clock.set_ms(p["ms"])
            return {}
        if path == "/fetch":
            clock.set_ms(p["ms"])
            return {"saved": d.fetcher.fetch_once(p["app"])}
        if path == "/repo":
            return _db_repo(d)
        if path == "/cadence/on":
            clock.follow(p["ms"])
            state["cadence"] = _DbCadence(d, port, p["cookie"], p["ip"],
                                          p["port"])
            return {}
        if path == "/cadence/off":
            out = state["cadence"].close()
            state["cadence"] = None
            clock.set_ms(clock.now_ms())
            return out
        if path == "/quit":
            done.set()
            return {}
        raise ValueError(path)

    class Ctl(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802
            n = int(self.headers.get("Content-Length") or 0)
            try:
                out, status = handle(self.path, json.loads(
                    self.rfile.read(n) or b"{}")), 200
            except Exception as exc:        # noqa: BLE001 — reported
                out, status = {"error": repr(exc)}, 500
            body = json.dumps(out).encode()
            self.send_response(status)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    ctl = ThreadingHTTPServer(("127.0.0.1", 0), Ctl)
    ctl.daemon_threads = True
    threading.Thread(target=ctl.serve_forever, daemon=True).start()
    tmp = spec["out"] + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"port": port, "ctl": ctl.server_address[1]}, fh)
    os.replace(tmp, spec["out"])
    parent = os.getppid()
    while not done.wait(0.5):
        if os.getppid() != parent:
            break
    if state["cadence"] is not None:
        state["cadence"].close()
    ctl.shutdown()
    ctl.server_close()
    server.stop()
    return 0


def _db_ctl(port: int, path: str, body=None) -> dict:
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method="POST",
        data=json.dumps(body or {}).encode())
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read().decode())


def _db_rule(family: str, k: int) -> dict:
    """Rule ``k`` of a family as the SPA's editor sends it: QPS rules on
    ``f0``.. (every ninth THREAD grade), exception-ratio breakers and
    ``evil``-blacklists on the same names, param rules on ``p0``.. (every
    fourth with a per-item override), gateway rules on 32 routes (half by
    client IP) and API groups by path prefix."""
    if family == "flow":
        return {"resource": f"f{k}", "grade": 0 if k % 9 == 4 else 1,
                "count": 4.0 if k % 9 == 4 else 20.0 + k % 7}
    if family == "degrade":
        return {"resource": f"f{k}", "grade": 1, "count": 0.5,
                "timeWindow": 10, "minRequestAmount": 5}
    if family == "system":
        return {"qps": 1e12, "maxThread": 1e9 + k}
    if family == "authority":
        return {"resource": f"f{k}", "limitApp": "evil", "strategy": 1}
    if family == "paramFlow":
        rule = {"resource": f"p{k}", "paramIdx": 0, "grade": 1,
                "count": 3.0 + k % 3, "durationInSec": 1}
        if k % 4 == 0:
            rule["paramFlowItemList"] = [{"object": "7", "count": 1,
                                          "classType": "int"}]
        return rule
    if family == "gatewayFlow":
        rule = {"resource": f"route{k % 32}", "resourceMode": 0,
                "count": 10.0 + k % 5, "intervalSec": 1}
        if k % 2:
            rule["paramItem"] = {"parseStrategy": 0}
        return rule
    return {"apiName": f"grp{k}", "predicateItems": [
        {"pattern": f"/api/g{k}/**", "matchStrategy": 1}]}


def _db_norm(obj, ports: dict):
    """``obj`` with every bound port replaced by its role."""
    if isinstance(obj, bool):
        return obj
    if isinstance(obj, int):
        return ports.get(obj, obj)
    if isinstance(obj, str):
        for port, role in ports.items():
            obj = obj.replace(f":{port}", f":{role}").replace(
                f"port={port}", f"port={role}")
        return obj
    if isinstance(obj, dict):
        return {k: _db_norm(v, ports) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_db_norm(v, ports) for v in obj]
    return obj


def _db_calls(stt, sph, clock, calls: int, seed: int) -> list:
    """``entry``+exit calls on the ruled names, 1 ms of virtual time every
    8 calls → outcomes: inbound on the hot set ``f0``..``f15`` (3% from
    the blacklisted origin; business errors on ``f0``..``f7``, so their
    breakers trip, and ``f8``..``f15`` run past their QPS), outbound on
    ``p0``..``p3`` with Zipf(1.3) user ids as the param, and inbound on
    the gateway routes as gateway resources."""
    from sentinel_tpu_torch.metrics.node import TYPE_GATEWAY
    rng = np.random.default_rng(seed)
    out = []
    picks = rng.integers(0, 100, calls).tolist()
    keys = rng.integers(0, 1 << 16, calls).tolist()
    users = (rng.zipf(1.3, calls) % 16).tolist()
    for k in range(calls):
        pick, key = picks[k], keys[k]
        try:
            if pick < 60:
                e = sph.entry(f"f{key % 16}", entry_type=stt.ENTRY_TYPE_IN,
                              origin="evil" if pick < 3 else "")
                if key % 16 < 8 and key % 5 < 3:
                    e.trace(RuntimeError("business error"))
                e.exit()
            elif pick < 85:
                with sph.entry(f"p{key % 4}", args=(int(users[k]),),
                               entry_type=stt.ENTRY_TYPE_OUT):
                    pass
            else:
                with sph.entry(f"route{key % 32}", entry_type=stt.ENTRY_TYPE_IN,
                               resource_type=TYPE_GATEWAY):
                    pass
            out.append("pass")
        except stt.BlockException as exc:
            out.append(type(exc).__name__)
        if k % 8 == 7:
            clock.advance_ms(1)
    return out


def _db_stream(sph, B: int, steps: int, seed: int = 143):
    """``steps`` fused-step batches over the flow-ruled names (1/4) and a
    rule-free pool (3/4), as rows; the exits of ``f0``..``f7`` fail."""
    ruled = sph.intern_resources([f"f{i}" for i in range(256)])
    pool = sph.intern_resources([f"u{i}" for i in range(DB_POOL)])
    rng = np.random.default_rng(seed)
    batches = [np.where(rng.random(B) < 0.25, ruled[rng.integers(0, 256, B)],
                        pool[rng.integers(0, DB_POOL, B)]).astype(np.int32)
               for _ in range(steps)]
    return batches, set(ruled[:8].tolist())


class _DbUpstream:
    """A loopback ``http.server``: ``/.../ok`` answers 200 ``hi``,
    ``/.../flaky`` 503, anything else 404."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def do_GET(self):  # noqa: N802
                status, body = ((200, b"hi") if self.path.endswith("/ok")
                                else (503, b"down")
                                if self.path.endswith("/flaky")
                                else (404, b"none"))
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass
        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.host = f"127.0.0.1:{self.server.server_address[1]}"
        self._t = threading.Thread(target=self.server.serve_forever,
                                   daemon=True)
        self._t.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self._t.join(timeout=60)


def _db_adapters(stt, sph) -> dict:
    """The outbound, aiohttp and gRPC adapters on the session's runtime:
    ``guarded_urlopen`` against a loopback ``http.server`` (pass, block
    before connecting, a 5xx and a dead port traced), ``SentinelSession``
    the same way if ``requests`` is installed, the gRPC server and client
    interceptors on a loopback grpc server if ``grpc`` is, and
    ``sentinel_middleware`` and ``SentinelAiohttpSession`` if ``aiohttp``
    is → verdicts by leg, node totals of the adapters' resources (the
    upstream's port replaced) and the absent packages."""
    import importlib
    import socket
    import urllib.request
    from sentinel_tpu_torch.adapters import SentinelSession, guarded_urlopen
    up = _DbUpstream()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    out = {"absent": [], "verdicts": {}}
    names = []
    hosts = {up.host: "<upstream>", f"127.0.0.1:{dead}": "<dead>"}

    def outcome(fn):
        try:
            r = fn()
            status = getattr(r, "status", None) or getattr(
                r, "status_code", None)
            if hasattr(r, "close"):
                r.close()
            return ("ok", status)
        except stt.BlockException as exc:
            return ("block", type(exc).__name__)
        except Exception as exc:            # noqa: BLE001 — compared
            return ("raise", type(exc).__name__)

    def rules(*extra):
        sph.load_flow_rules(sph.get_flow_rules() + [
            stt.FlowRule(resource=r, count=c) for r, c in extra])

    try:
        base = f"http://{up.host}"
        ok, gone = f"httpclient:GET:{up.host}/u/ok", "httpclient:GET:127.0.0.1:1/x"
        rules((ok, 3), (gone, 0))
        names += [ok, f"httpclient:GET:{up.host}/u/flaky", gone,
                  f"httpclient:GET:127.0.0.1:{dead}/gone"]
        out["verdicts"]["urlopen"] = [outcome(lambda: guarded_urlopen(
            sph, f"{base}/u/ok", timeout=30)) for _ in range(4)] + [
            outcome(lambda: guarded_urlopen(sph, f"{base}/u/flaky",
                                            timeout=30)),
            outcome(lambda: guarded_urlopen(sph, "http://127.0.0.1:1/x",
                                            timeout=0.2)),
            outcome(lambda: guarded_urlopen(
                sph, urllib.request.Request(
                    f"http://127.0.0.1:{dead}/gone"), timeout=5))]
        try:
            import requests  # noqa: F401
        except ImportError:
            out["absent"].append("requests")
        else:
            ok = f"httpclient:GET:{up.host}/s/ok"
            rules((ok, 2))
            names += [ok, f"httpclient:GET:{up.host}/s/flaky"]
            session = SentinelSession(sph)
            try:
                out["verdicts"]["session"] = [outcome(lambda: session.get(
                    f"{base}/s/ok", timeout=30)) for _ in range(3)] + [
                    outcome(lambda: session.get(f"{base}/s/flaky",
                                                timeout=30)),
                    outcome(lambda: session.get(
                        f"http://127.0.0.1:{dead}/gone", timeout=5))]
            finally:
                session.close()
        try:
            import grpc
        except ImportError:
            out["absent"].append("grpc")
        else:
            gi = importlib.import_module(
                "sentinel_tpu_torch.adapters.grpc_interceptor")
            out["verdicts"]["grpc"] = _db_grpc(grpc, gi, sph, rules, names)
        try:
            import aiohttp  # noqa: F401
        except ImportError:
            out["absent"].append("aiohttp")
        else:
            out["verdicts"]["aiohttp"], aio_host = _db_aiohttp(
                stt, sph, rules, names)
            hosts[aio_host] = "<aiohttp-upstream>"
    finally:
        up.close()

    def rename(n):
        for h, role in hosts.items():
            n = n.replace(h, role)
        return n
    totals = {}
    for n in names:
        t = dict(sph.node_totals(n))
        t.pop("avg_rt", None)
        totals[rename(n)] = t
    out["totals"] = totals
    return out


def _db_grpc(grpc, gi, sph, rules, names) -> list:
    """The gRPC legs: 3 calls through ``SentinelServerInterceptor`` on a
    QPS-2 method, one whose handler raises; 3 calls through
    ``SentinelClientInterceptor`` to a QPS-2 method, one answered
    INTERNAL."""
    from concurrent import futures

    def boom(request, context):
        raise RuntimeError("handler broke")

    def internal(request, context):
        context.abort(grpc.StatusCode.INTERNAL, "nope")

    def serve(interceptors, methods):
        server = grpc.server(futures.ThreadPoolExecutor(max_workers=2),
                             interceptors=interceptors)
        server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
            "smoke.Echo", {m: grpc.unary_unary_rpc_method_handler(
                fn, request_deserializer=lambda b: b,
                response_serializer=lambda b: b)
                for m, fn in methods.items()}),))
        port = server.add_insecure_port("127.0.0.1:0")
        server.start()
        return server, port

    def call(ch, method, req):
        try:
            return ("ok", ch.unary_unary(
                method, request_serializer=lambda b: b,
                response_deserializer=lambda b: b)(req, timeout=60).decode())
        except grpc.RpcError as exc:
            return ("rpc", str(exc.code()), exc.details())

    rules(("/smoke.Echo/In", 2), ("/smoke.Echo/Out", 2))
    names += ["/smoke.Echo/In", "/smoke.Echo/Boom", "/smoke.Echo/Out",
              "/smoke.Echo/Fail"]
    echo = {"In": lambda r, c: r + b"!", "Boom": boom,
            "Out": lambda r, c: r + b"?", "Fail": internal}
    inbound, iport = serve([gi.SentinelServerInterceptor(sph)], echo)
    plain, pport = serve([], echo)
    out = []
    try:
        with grpc.insecure_channel(f"127.0.0.1:{iport}") as ch:
            out += [call(ch, "/smoke.Echo/In", b"x") for _ in range(3)]
            out.append(call(ch, "/smoke.Echo/Boom", b"x")[:2])
        with grpc.insecure_channel(f"127.0.0.1:{pport}") as raw:
            ch = grpc.intercept_channel(raw,
                                        gi.SentinelClientInterceptor(sph))
            out += [call(ch, "/smoke.Echo/Out", b"y") for _ in range(3)]
            out.append(call(ch, "/smoke.Echo/Fail", b"y"))
    finally:
        inbound.stop(None).wait(60)
        plain.stop(None).wait(60)
    return out


def _db_aiohttp(stt, sph, rules, names) -> list:
    """The aiohttp legs on one event loop: 3 requests through
    ``sentinel_middleware`` on a QPS-2 route and one whose handler
    raises; 3 through ``SentinelAiohttpSession`` to a QPS-2 upstream path
    and one answered 503."""
    import asyncio
    import importlib
    import aiohttp
    from aiohttp import web
    from aiohttp.test_utils import TestServer
    from sentinel_tpu_torch.adapters import SentinelAiohttpSession
    mw = importlib.import_module("sentinel_tpu_torch.adapters.aiohttp_server")

    async def api(request):
        return web.Response(text="api")

    async def boom(request):
        raise web.HTTPInternalServerError(text="boom")

    async def flaky(request):
        return web.Response(status=503)

    async def run():
        guarded = web.Application(middlewares=[mw.sentinel_middleware(sph)])
        guarded.router.add_get("/aio/api", api)
        guarded.router.add_get("/aio/boom", boom)
        upstream = web.Application()
        upstream.router.add_get("/aio/ok", api)
        upstream.router.add_get("/aio/flaky", flaky)
        s1, s2 = TestServer(guarded), TestServer(upstream)
        await s1.start_server()
        await s2.start_server()
        host = f"{s2.host}:{s2.port}"
        ok = f"httpclient:GET:{host}/aio/ok"
        rules(("GET:/aio/api", 2), (ok, 2))
        names.extend(["GET:/aio/api", "GET:/aio/boom"])
        session = SentinelAiohttpSession(sph)
        res = []
        try:
            async with aiohttp.ClientSession() as plain:
                for path in ("/aio/api",) * 3 + ("/aio/boom",):
                    async with plain.get(
                            f"http://{s1.host}:{s1.port}{path}") as r:
                        res.append(("in", r.status, await r.text()))
            for path in ("/aio/ok",) * 3 + ("/aio/flaky",):
                try:
                    r = await session.get(f"http://{host}{path}")
                    res.append(("out", r.status, await r.text()))
                except stt.BlockException as exc:
                    res.append(("out", type(exc).__name__))
        finally:
            await session.close()
            await s1.close()
            await s2.close()
        return host, res

    host, res = asyncio.run(asyncio.wait_for(run(), 120))
    names.extend([f"httpclient:GET:{host}/aio/ok",
                  f"httpclient:GET:{host}/aio/flaky"])
    return res, host


def _db_session(stt, sa, dev, R: int, tmp: str, B: int, steps: int,
                calls: int, timing: bool, route_n: int = 16, push_n: int = 8,
                turns: int = 4, turn_s: float = 10.0, tag: str = "",
                plain: bool = False, before_timing=None) -> dict:
    """One dashboard session (see :func:`phase_dashboard`) on
    ``Sentinel(device=dev)`` at ``R`` rows → its observations: every
    dashboard response (method, path, parsed body, ports by role), every
    verdict, the dashboard's repositories, the adapters' verdicts and
    totals, the launches and the engine state. With ``timing`` it then
    (after ``before_timing()``) times every route, the rule push at
    :data:`DB_HELD` flow rules held and the fused steps with the
    dashboard at its real cadence and stopped, in turns."""
    from sentinel_tpu_torch import convert
    from sentinel_tpu_torch import gateway as tgw
    from sentinel_tpu_torch.cluster.coordinator import ClusterCoordinator
    from sentinel_tpu_torch.control import ControlLoop
    from sentinel_tpu_torch.core.logs import BlockStatLogger
    from sentinel_tpu_torch.metrics.timer import MetricTimerListener
    from sentinel_tpu_torch.transport import start_transport
    os.makedirs(tmp, exist_ok=True)
    res = {"http": [], "timing": {}, "section_s": {}}
    t_sec = [time.perf_counter()]

    def section(name):
        now = time.perf_counter()
        res["section_s"][name] = now - t_sec[0]
        t_sec[0] = now
        log(f"[dashboard] {tag} {name}: {res['section_s'][name]:.1f} s")

    # the dashboard, in a process of its own
    spec = os.path.join(tmp, "dashboard.json")
    portfile = os.path.join(tmp, "dashboard.ports")
    if os.path.exists(portfile):
        os.remove(portfile)
    with open(spec, "w") as fh:
        json.dump({"t0": DB_T0, "password": DB_PASSWORD, "out": portfile,
                   "agent_timeout_s": DB_AGENT_TIMEOUT_S}, fh)
    dlog = open(os.path.join(tmp, "dashboard.log"), "w")
    dproc = subprocess.Popen(DB_DASH_CMD + [spec], stdout=dlog,
                             stderr=subprocess.STDOUT)
    rt = coord = sph = None
    try:
        deadline = time.monotonic() + 180
        while not os.path.exists(portfile):
            if dproc.poll() is not None or time.monotonic() > deadline:
                fail(f"dashboard phase: {tag} dashboard process did not "
                     f"start (rc {dproc.poll()})")
            time.sleep(0.05)
        with open(portfile) as fh:
            dports = json.load(fh)
        dport, cport = dports["port"], dports["ctl"]
        ports = {dport: "<dashboard>"}
        clock = stt.ManualClock(start_ms=DB_T0)
        sph = stt.Sentinel(config=stt.load_config(
            max_resources=R, max_flow_rules=2 * DB_HELD, app_name=DB_APP,
            metric_log_dir=os.path.join(tmp, "metrics")), clock=clock,
            device=dev)
        sph._cpu.sample = lambda: (0.5, 0.25)
        sph.block_log.close()
        sph.block_log = BlockStatLogger(clock,
                                        base_dir=os.path.join(tmp, "bl"))
        ControlLoop(sph)            # attaches as sph.control
        mgr = tgw.GatewayRuleManager(sph)
        api_mgr = tgw.GatewayApiDefinitionManager()
        # 0.0.0.0: the heartbeat advertises the machine's interface IP and
        # the dashboard connects back to it
        rt = start_transport(sph, host="0.0.0.0", port=0, metric_log=True,
                             dashboard_addr=f"127.0.0.1:{dport}",
                             gateway_manager=mgr,
                             api_definition_manager=api_mgr)
        # the twins must agree: the metric timer and the cadence scheduler
        # do not tick on the wall clock here; the session ticks the timer
        rt.metric_timer.stop()
        if rt.cadence is not None:
            rt.cadence.stop()
        timer = MetricTimerListener(sph)
        coord = ClusterCoordinator(sph, flows_per_shard=16,
                                   param_keys_per_shard=64, clock=clock)
        coord.bind(rt.cluster_state, rt.center)
        aport = rt.port
        ports[aport] = "<agent>"
        cookie = [None]

        def api(method, path, body=None, record=True, ok=True):
            status, doc, us, hdrs = _db_request(dport, method, path, body,
                                                cookie[0])
            if record:
                res["http"].append((method, path, status,
                                    _db_drop(doc, DB_WALL)))
            if ok and (status != 200 or (isinstance(doc, dict)
                                         and not doc.get("success"))):
                fail(f"dashboard phase: {tag} {method} {path} answered "
                     f"{status}: {str(doc)[:300]}")
            return doc, us, hdrs

        # (a) log in, see the agent's heartbeat land, the rule CRUD
        api("GET", "/app/names.json", ok=False)       # the 401 envelope
        doc, _us, hdrs = api("POST", "/auth/login", {
            "username": "sentinel", "password": DB_PASSWORD})
        cookie[0] = hdrs["Set-Cookie"].split(";")[0]
        deadline = time.monotonic() + 60
        while DB_APP not in api("GET", "/app/names.json",
                                record=False)[0]["data"]:
            if time.monotonic() > deadline:
                fail(f"dashboard phase: {tag} the agent's heartbeat never "
                     f"registered it")
            time.sleep(0.05)
        machines = api("GET", f"/app/{DB_APP}/machines.json")[0]["data"]
        ip = machines[0]["ip"]
        res["agent_ip"] = ip
        q = f"ip={ip}&port={aport}"
        push_us = collections.defaultdict(list)
        for family, n in DB_RULES:
            ids = []
            for k in range(n + 1):
                doc, us, _h = api("POST", f"/v1/{family}/rule",
                                  {"app": DB_APP, **_db_rule(family, k)})
                ids.append(doc["data"]["id"])
                push_us[family].append(us)
            edit = {"count": 7.0} if family not in ("system", "gatewayApi") \
                else {"qps": 5e11} if family == "system" else {
                    "predicateItems": [{"pattern": "/api/g0/x",
                                        "matchStrategy": 0}]}
            api("PUT", f"/v1/{family}/rule/{ids[0]}", edit)
            api("DELETE", f"/v1/{family}/rule/{ids[-1]}")
        for family, _n in DB_RULES:
            api("GET", f"/v1/{family}/rules?app={DB_APP}")
        res["push_us"] = dict(push_us)
        section("rules")
        # the traffic: entry calls, then full-width fused steps
        sa.LAUNCHES.clear()
        res["calls"] = _db_calls(stt, sph, clock, calls, seed=141)
        batches, failing = _db_stream(sph, B, steps)
        prev = [np.empty(0, np.int32)]
        res["steps"] = _cp_steps(sph, dev, batches, failing, prev,
                                 dev == "cuda" and not plain)
        clock.advance_ms(4000)
        res["ticked"] = timer.tick()
        res["fetched"] = _db_ctl(cport, "/fetch", {"ms": clock.now_ms(),
                                                  "app": DB_APP})["saved"]
        section("traffic")
        # every route the SPA reads
        for path in (f"/metric/resources.json?app={DB_APP}",
                     f"/metric/queryByAppAndResource.json?app={DB_APP}"
                     f"&identity=f1&startTime={DB_T0 - 1000}"
                     f"&endTime={DB_T0 + 60_000}",
                     f"/resource/machineResource.json?{q}",
                     f"/resource/jsonTree.json?{q}",
                     f"/resource/origin.json?{q}&id=f1",
                     f"/systemStatus.json?{q}",
                     f"/obs/telemetry.json?{q}&spans=16&events=16",
                     f"/obs/topk.json?{q}&timeline=60&tick=1",
                     f"/obs/control.json?{q}&actions=32",
                     f"/obs/traces.json?{q}",
                     f"/cluster/state.json?app={DB_APP}"):
            api("GET", path)
        doc, _us, _h = api("POST", "/cluster/assign", {
            "app": DB_APP, "serverIp": ip, "serverPort": aport})
        ports[doc["data"]["tokenPort"]] = "<token>"
        if coord.server is None:
            fail(f"dashboard phase: {tag} /cluster/assign started no token "
                 f"server")
        api("GET", f"/cluster/state.json?app={DB_APP}")
        api("GET", f"/cluster/serverConfig.json?{q}")
        api("POST", "/cluster/serverConfig", {
            "ip": ip, "port": aport, "namespaces": DB_APP,
            "namespace": DB_APP, "maxAllowedQps": 5000.0})
        api("GET", f"/cluster/serverConfig.json?{q}&namespace={DB_APP}")
        api("GET", f"/cluster/metrics.json?app={DB_APP}&{q}")
        api("POST", "/cluster/mode", {"app": DB_APP, "ip": ip, "port": aport,
                                      "mode": -1})
        res["page"] = _db_request(dport, "GET", "/")[1]
        res["app_js"] = _db_request(dport, "GET", "/static/app.js")[1]
        section("routes")
        # (d) the adapters on the same runtime
        res["adapters"] = _db_adapters(stt, sph)
        section("adapters")
        res["launches"] = sa.LAUNCHES["scatter_add"]
        res["repo"] = _db_ctl(cport, "/repo")
        api("POST", f"/app/{DB_APP}/machine/remove.json",
            {"ip": ip, "port": aport})
        api("GET", "/app/names.json")
        if not rt.heartbeat.send_once():         # a real beat re-registers
            fail(f"dashboard phase: {tag} the heartbeat did not land")
        api("GET", "/app/names.json")
        res["state"] = convert.engine_to_numpy(sph)
        # the bound ports by role, the token server's known only now
        res["http"] = [_db_norm(h, ports) for h in res["http"]]
        res["repo"] = _db_norm(res["repo"], ports)
        res["totals"] = {n: sph.node_totals(n) for n in
                         [f"f{i}" for i in range(0, 256, 17)]
                         + [f"p{i}" for i in range(0, 64, 9)]
                         + [f"route{i}" for i in range(0, 32, 5)]}
        section("reads")
        if timing:
            if before_timing is not None:
                before_timing()     # the measurements below run alone
            res["timing"] = _db_timing(stt, sph, clock, timer, dev, api,
                                       cport, cookie[0], ip, aport, q, B,
                                       failing, prev, route_n, push_n,
                                       turns, turn_s)
            section("timing")
    finally:
        try:
            _db_ctl(cport, "/quit")
        except Exception:               # noqa: BLE001 — killed below
            pass
        try:
            dproc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            dproc.kill()
            dproc.wait()
        dlog.close()
        if coord is not None:
            coord.stop()
        if rt is not None:
            rt.stop()
        if sph is not None:
            sph.close()
    return res


def _db_timing(stt, sph, clock, timer, dev, api, cport, cookie, ip, aport,
               q, B, failing, prev, route_n, push_n, turns, turn_s) -> dict:
    """The 1M run's measurements, alone: µs per route (round-robin,
    ``route_n`` each); ms per rule push (``POST /v1/flow/rule``, which
    republishes the app's full set) with :data:`DB_HELD` flow rules
    held; host ms per fused step with the dashboard at its real cadence
    and stopped, in turns of ``turn_s`` seconds, the agent's clock
    following the wall clock and its metric timer ticking each second."""
    from sentinel_tpu_torch.rules import codec
    t = {}
    routes = ("/app/names.json", f"/app/{DB_APP}/machines.json",
              f"/metric/resources.json?app={DB_APP}",
              f"/metric/queryByAppAndResource.json?app={DB_APP}&identity=f1"
              f"&startTime={DB_T0 - 1000}&endTime={DB_T0 + 60_000}",
              f"/resource/machineResource.json?{q}",
              f"/resource/jsonTree.json?{q}",
              f"/resource/origin.json?{q}&id=f1", f"/systemStatus.json?{q}",
              f"/obs/telemetry.json?{q}", f"/obs/topk.json?{q}&timeline=60",
              f"/obs/topk.json?{q}&timeline=60&tick=1",
              f"/obs/control.json?{q}", f"/obs/traces.json?{q}",
              f"/cluster/state.json?app={DB_APP}",
              f"/cluster/serverConfig.json?{q}", f"/v1/flow/rules?app={DB_APP}")
    us = {p: [] for p in routes}
    for _ in range(route_n):
        for p in routes:
            us[p].append(api("GET", p, record=False)[1])
    t["route_us"] = us
    # the rule push with DB_HELD flow rules held: the agent takes them
    # over its command port, the dashboard pulls them into its repository
    held = [stt.FlowRule(resource=f"h{i}", count=50.0) for i in range(DB_HELD)]
    status, text, _us = _cp_http(aport, "POST", "setRules", {
        "type": "flow", "data": codec.rules_to_json("flow", held)})
    if status != 200:
        fail(f"dashboard phase: setRules of {DB_HELD} answered {status}")
    n_held = len(api("GET", f"/v1/flow/rules?app={DB_APP}",
                     record=False)[0]["data"])
    if n_held != DB_HELD:
        fail(f"dashboard phase: the repository holds {n_held} flow rules")
    t["push_held_ms"] = [api("POST", "/v1/flow/rule", {
        "app": DB_APP, **_db_rule("flow", k)}, record=False)[1] / 1e3
        for k in range(push_n)]
    if len(sph.get_flow_rules()) != DB_HELD + push_n:
        fail("dashboard phase: the timed pushes did not reach the agent")
    # host ms per fused step, the dashboard at its real cadence or stopped
    extra, _f = _db_stream(sph, B, 8, seed=147)
    per = {"on": [], "off": []}
    polls = {"us": {name: [] for name, _p, _f in DB_CADENCE}, "bad": []}
    k = 0
    for turn in range(turns):
        flag = "on" if turn % 4 in (1, 2) else "off"
        if flag == "on":
            _db_ctl(cport, "/cadence/on", {"ms": clock.now_ms(),
                                           "cookie": cookie, "ip": ip,
                                           "port": aport})
        t0 = last = time.perf_counter()
        tick_at = t0 + 1.0
        while time.perf_counter() - t0 < turn_s:
            now = time.perf_counter()
            clock.advance_ms(max(1, int((now - last) * 1e3)))
            last = now
            _cp_steps(sph, dev, extra[k % 8:k % 8 + 1], failing, prev,
                      False, host_ms=per[flag])
            k += 1
            if time.perf_counter() >= tick_at:
                timer.tick()
                tick_at += 1.0
        if flag == "on":
            got = _db_ctl(cport, "/cadence/off")
            for name, v in got["us"].items():
                polls["us"][name] += v
            polls["bad"] += got["bad"]
    if polls["bad"]:
        fail(f"dashboard phase: polls at the real cadence failed: "
             f"{polls['bad'][:3]}")
    t["step_ms"] = per
    t["polls"] = polls
    return t


def _db_twin_main(spec_path: str, out_path: str) -> int:
    """``chip_smoke.py --db-twin SPEC OUT``: one twin session of phase 14
    in a process of its own → its observations, pickled to OUT."""
    import pickle
    import sentinel_tpu_torch as stt
    from sentinel_tpu_torch.ops import scatter_add as sa
    with open(spec_path) as fh:
        spec = json.load(fh)
    if spec["plain"]:
        sa.scatter_add = sa.scatter_add_reference       # the plain seam
    res = _db_session(stt, sa, timing=False, **spec)
    with open(out_path, "wb") as fh:
        pickle.dump(res, fh)
    return 0


def phase_dashboard(stt, sa, dev="cuda", R=1 << 20, twin_rows=1 << 14,
                    B=1 << 19, steps: int = 6, calls: int = 512,
                    route_n: int = 16, push_n: int = 8, turns: int = 4,
                    turn_s: float = 10.0) -> dict:
    """An operator's dashboard on a live agent, as deployments run it:
    ``Sentinel(device="cuda")`` at ``R`` rows (default configuration:
    the C++ tables) behind ``start_transport(port=0, metric_log=True,
    dashboard_addr=, gateway_manager=, api_definition_manager=)``; a
    ``DashboardServer(port=0)`` with a password in a process of its own,
    which the agent registers with by its heartbeat. Over the dashboard's
    REST API, as the SPA sends them: a login; rule CRUD of all seven
    families through ``/v1/{type}/rule`` (:data:`DB_RULES`; every change
    republishes the app's full set); after ``calls`` ``entry()``+exit
    calls and ``steps`` full-width fused steps of ``B`` events, a fetch
    into the repository and every route the SPA reads, the one-click
    token-server assignment and its server config, a machine removed and
    re-registered by a heartbeat; then the outbound, aiohttp and gRPC
    adapters on the same runtime (:func:`_db_adapters`). The same session
    at ``twin_rows`` on the card, with the plain seam and on the CPU
    (``--db-twin``, processes of their own beside the 1M run) must give
    the same verdicts, bodies (less :data:`DB_WALL`), repositories and
    adapter totals, the twins the same engine state. Then, alone:
    :func:`_db_timing`."""
    import pickle
    import tempfile
    from sentinel_tpu_torch import convert
    t_phase = time.perf_counter()
    kw = dict(B=B, steps=steps, calls=calls)
    twins = (("card_twin", dev, False), ("plain_twin", dev, True),
             ("cpu_twin", "cpu", False))
    runs, procs = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_db_") as tmp:
        for tag, d, plain in twins:
            spec = os.path.join(tmp, f"{tag}.json")
            with open(spec, "w") as fh:
                json.dump(dict(kw, dev=d, R=twin_rows, plain=plain,
                               tmp=os.path.join(tmp, tag), tag=tag), fh)
            out = open(os.path.join(tmp, f"{tag}.log"), "w")
            procs[tag] = (subprocess.Popen(
                DB_TWIN_CMD + [spec, os.path.join(tmp, f"{tag}.pkl")],
                stdout=out, stderr=subprocess.STDOUT), out)

        def join_twins():
            for tag, (proc, out) in procs.items():
                try:
                    rc = proc.wait(timeout=600)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                    rc = "timeout"
                out.close()
                if rc != 0:
                    with open(os.path.join(tmp, f"{tag}.log")) as fh:
                        tail = fh.read()[-3000:]
                    fail(f"dashboard phase: the {tag} process ended with "
                         f"{rc}:\n{tail}")
                with open(os.path.join(tmp, f"{tag}.pkl"), "rb") as fh:
                    runs[tag] = pickle.load(fh)
            log(f"[dashboard] twins done at "
                f"{time.perf_counter() - t_phase:.1f} s: " + ", ".join(
                    f"{t} {sum(r['section_s'].values()):.1f} s"
                    for t, r in runs.items()))

        try:
            runs["card"] = _db_session(
                stt, sa, dev, R, os.path.join(tmp, "card"), timing=True,
                route_n=route_n, push_n=push_n, turns=turns, turn_s=turn_s,
                tag="card", before_timing=join_twins, **kw)
        finally:
            for proc, out in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                out.close()
    card = runs["card"]
    for tag, run in runs.items():
        for key in ("calls", "steps", "ticked", "fetched", "repo", "totals",
                    "page", "app_js"):
            if run[key] != card[key]:
                fail(f"dashboard phase: {tag} {key} differ from the 1M "
                     f"card run")
        if len(run["http"]) != len(card["http"]):
            fail(f"dashboard phase: {tag} made {len(run['http'])} calls")
        for a, b, c in zip(run["http"], card["http"],
                           runs["cpu_twin"]["http"]):
            if _db_drop(a, DB_GEOMETRY) != _db_drop(b, DB_GEOMETRY):
                fail(f"dashboard phase: {tag} {a[0]} {a[1]} body differs "
                     f"from the 1M card run's: {str(a[3])[:200]} vs "
                     f"{str(b[3])[:200]}")
            if tag != "card" and a != c:
                fail(f"dashboard phase: {tag} {a[0]} {a[1]} body differs "
                     f"from the CPU twin's: {str(a[3])[:200]} vs "
                     f"{str(c[3])[:200]}")
        ad, cad = run["adapters"], card["adapters"]
        if (ad["verdicts"], ad["totals"], ad["absent"]) != (
                cad["verdicts"], cad["totals"], cad["absent"]):
            fail(f"dashboard phase: {tag} adapter verdicts or totals "
                 f"differ: {ad['verdicts']} vs {cad['verdicts']}")
    for tag in ("card_twin", "plain_twin"):
        bad = convert.leaf_diff(runs["cpu_twin"]["state"], runs[tag]["state"])
        if bad:
            fail(f"dashboard phase: {tag} state differs from the CPU twin: "
                 f"{bad}")
    if not card["launches"] or not runs["card_twin"]["launches"]:
        fail("dashboard phase: the drive launched no kernel")
    if runs["plain_twin"]["launches"]:
        fail("dashboard phase: the plain-seam run launched the kernel")
    outcomes = collections.Counter(card["calls"])
    for want in ("pass", "FlowException", "AuthorityException",
                 "DegradeException", "ParamFlowException"):
        if not outcomes.get(want):
            fail(f"dashboard phase: the calls never saw {want}: "
                 f"{dict(outcomes)}")
    if not sum(v.count(False) for v in card["steps"]):
        fail("dashboard phase: no fused step denied an event")
    if not card["fetched"]:
        fail("dashboard phase: the fetch saved no metric entity")
    t = card["timing"]
    absent = card["adapters"]["absent"]
    res = {"launches": card["launches"], "R": R, "B": B, "steps": steps,
           "agent_ip": card["agent_ip"], "outcomes": dict(outcomes),
           "fetched": card["fetched"], "http_bodies": len(card["http"]),
           "absent": absent, "adapter_verdicts": card["adapters"]["verdicts"],
           "push_ms": {f: summary([u / 1e3 for u in v])
                       for f, v in card["push_us"].items()},
           "route_us": {p: {"p50": float(np.percentile(v, 50)),
                            "p99": float(np.percentile(v, 99)), "n": len(v)}
                        for p, v in t["route_us"].items()},
           "push_held_ms": t["push_held_ms"],
           "step_host_ms": {f: dict(summary(v),
                                    p99=float(np.percentile(v, 99)))
                            for f, v in t["step_ms"].items()},
           "polls_us": {n: summary(v) if v else None
                        for n, v in t["polls"]["us"].items()},
           "section_s": {tag: r["section_s"] for tag, r in runs.items()}}
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[dashboard] agent registered by heartbeat as {card['agent_ip']}; "
        f"{res['http_bodies']} dashboard bodies, {sum(n + 1 for _f, n in DB_RULES)} "
        f"rule creations, the repositories, {res['fetched']} fetched "
        f"metric entities and every verdict equal at {R} rows and at "
        f"{twin_rows} on the card, with the plain seam and on the CPU; "
        f"state equal across the twins; outcomes {dict(outcomes)}")
    log("[dashboard] us a dashboard route at {} rows, agent round trip "
        "included (p50/p99): {}".format(R, ", ".join(
            f"{p.split('?')[0]}{'+tick' if 'tick=1' in p else ''} "
            f"{v['p50']:.0f}/{v['p99']:.0f}"
            for p, v in res["route_us"].items())))
    first = {tag: r["push_us"]["flow"][0] / 1e3 for tag, r in runs.items()}
    res["first_push_ms"] = first
    log(f"[dashboard] ms of the first rule push into a cold agent (agent "
        f"deadline {DB_AGENT_TIMEOUT_S:.0f} s, the client's default 3): "
        + ", ".join(f"{t} {v:.1f}" for t, v in first.items()))
    log(f"[dashboard] ms a rule push (POST /v1/flow/rule, full republish) "
        f"with {DB_HELD} flow rules held: median "
        f"{np.median(t['push_held_ms']):.2f}, max "
        f"{max(t['push_held_ms']):.2f} ({push_n}); during the CRUD (256 "
        f"held at most) flow median {res['push_ms']['flow']['median']:.2f}")
    sm = res["step_host_ms"]
    log(f"[dashboard] host ms a fused step of {B} events, dashboard "
        f"stopped / at its real cadence (in turns of {turn_s:.0f} s): "
        f"median {sm['off']['median']:.2f} / {sm['on']['median']:.2f}, "
        f"p99 {sm['off']['p99']:.2f} / {sm['on']['p99']:.2f} "
        f"({sm['off']['n']} / {sm['on']['n']} steps); polls "
        + ", ".join(f"{n} {len(v)}" for n, v in t["polls"]["us"].items()))
    log(f"[adapters] verdicts equal to the twins: "
        + "; ".join(f"{k} {v}" for k, v in card["adapters"]["verdicts"].items()))
    log(f"[adapters] absent optional packages: "
        f"{', '.join(absent) if absent else 'none'}")
    log(f"[dashboard] phase 14 took {res['seconds']:.1f} s; kernel launches "
        f"{card['launches']}")
    return res


# ---------------------------------------------------------------------------
# Phase 15: the autotuner, warm-restart snapshots with the compile-cache
# counters, and the gRPC token and Envoy RLS servers
# ---------------------------------------------------------------------------

TS_T0 = 1_790_000_000_000
TS_STEP_MS = 40              # virtual time between the snapshot leg's steps
#: the reference sweep's defaults (``python -m sentinel_tpu.tune``)
TS_KNOBS = ("SENTINEL_PIPELINE_DEPTH", "SENTINEL_FRONTEND_BATCH")
TS_GRIDS = {"SENTINEL_PIPELINE_DEPTH": (1, 2, 4, 8),
            "SENTINEL_FRONTEND_BATCH": (64, 128, 256, 512)}
RLS_DOMAINS = 16
RLS_DESCRIPTORS = 16         # limited descriptors a domain
#: the command that times one cold start against a build directory
CC_CHILD_CMD = [sys.executable, os.path.abspath(__file__), "--cc-child"]


def _tune_view(sph) -> dict:
    """What the startup twins compare: the resolved overrides, the
    ``tune.*`` counters, the knobs a new batcher and pipeline take."""
    from sentinel_tpu_torch.serving import DispatchPipeline
    fe = sph.frontend()
    try:
        view = {"tuned": dict(sph._tuned),
                "counters": {k: v for k, v in
                             sph.obs.counters.snapshot().items()
                             if k.startswith("tune.")},
                "batch_max": fe.batch_max, "frontend_depth": fe.depth,
                "pipeline_depth": DispatchPipeline(sph).depth}
    finally:
        fe.close()
    return view


def _tune_leg(stt, sa, dev, R: int, twin_rows: int, grids: dict,
              rungs, rate: float, tmp: str) -> dict:
    """(a) ``run_sweep`` at the reference's defaults on the card, the
    artifact written, then three startups at ``R`` rows — on the
    artifact, on a copy fingerprinted ``TPU v5 lite``, with a typo'd knob
    — each against a CPU twin at ``twin_rows`` under the same
    environment (its artifact carries the CPU's fingerprint)."""
    from sentinel_tpu_torch.tune import artifact as art
    from sentinel_tpu_torch.tune.runner import run_sweep
    sa.LAUNCHES.clear()
    t = time.perf_counter()
    path = os.path.join(tmp, "TUNED.json")
    out = run_sweep(envs=TS_KNOBS, grids=grids, workload="steady", seed=11,
                    rate_rps=rate, slo_p99_ms=50.0, rung_ms=rungs, eta=2,
                    passes=1, out_path=path, device=dev)
    sweep_s = time.perf_counter() - t
    launches = sa.LAUNCHES["scatter_add"]
    res = out["result"]
    if not res.converged or out["artifact"] is None:
        fail(f"tune leg: the sweep did not converge ({out['counters']})")
    doc = out["artifact"]
    rep = {"sweep_s": sweep_s, "fingerprint": doc["fingerprint"],
           "trials": out["trials"], "parity_checks": out["parity_checks"],
           "counters": out["counters"], "best": res.best_config,
           "best_decisions_per_s": res.best_outcome.decisions_per_s,
           "best_p99_ms": res.best_outcome.p99_ms,
           "baseline_decisions_per_s": res.baseline_outcome.decisions_per_s,
           "baseline_p99_ms": res.baseline_outcome.p99_ms,
           "history": [{"config": r.config, "episode_ms": r.episode_ms,
                        "decisions_per_s": r.outcome.decisions_per_s,
                        "p99_ms": r.outcome.p99_ms, "score": r.score}
                       for r in res.history]}
    log(f"[tune] fingerprint {json.dumps(doc['fingerprint'])}")
    log(f"[tune] sweep {sweep_s:.1f} s: {out['trials']} trials, "
        f"{out['parity_checks']} parity checks; baseline "
        f"{rep['baseline_decisions_per_s']:.0f} decisions/s p99 "
        f"{rep['baseline_p99_ms']} ms; best {res.best_config} "
        f"{rep['best_decisions_per_s']:.0f} decisions/s p99 "
        f"{rep['best_p99_ms']} ms")
    cpu_doc = dict(doc, fingerprint=art.fingerprint("cpu"))
    tpu_doc = dict(doc, fingerprint=dict(doc["fingerprint"],
                                         device_kind="TPU v5 lite"))
    paths = {}
    for tag, d in (("cpu", cpu_doc), ("tpu", tpu_doc)):
        paths[tag] = os.path.join(tmp, f"TUNED_{tag}.json")
        with open(paths[tag], "w") as fh:
            json.dump(d, fh)
    starts = {}
    tuned = {k: doc["knobs"][k] for k in TS_KNOBS}
    for tag, card_env, cpu_env in (
            ("artifact", {art.TUNED_CONFIG_ENV: path},
             {art.TUNED_CONFIG_ENV: paths["cpu"]}),
            ("tpu_copy", {art.TUNED_CONFIG_ENV: paths["tpu"]},
             {art.TUNED_CONFIG_ENV: paths["tpu"]}),
            ("typo", {"SENTINEL_PIPLINE_DEPTH": "4"},
             {"SENTINEL_PIPLINE_DEPTH": "4"})):
        views = {}
        for where, rows, d, env in (("card", R, dev, card_env),
                                    ("cpu", twin_rows, "cpu", cpu_env)):
            t = time.perf_counter()
            with _knobs(**env):
                sph = stt.Sentinel(config=stt.load_config(
                    max_resources=rows), device=d)
            try:
                views[where] = _tune_view(sph)
            finally:
                sph.close()
            views[where]["start_s"] = time.perf_counter() - t
        card, cpu = views["card"], views["cpu"]
        for k in ("tuned", "counters", "batch_max", "frontend_depth",
                  "pipeline_depth"):
            if card[k] != cpu[k]:
                fail(f"tune leg ({tag}): {k} {card[k]} on the card, "
                     f"{cpu[k]} on the CPU twin")
        c = card["counters"]
        if tag == "artifact" and not (
                c.get("tune.config_loaded") == 1 and card["tuned"] == tuned
                and card["batch_max"] == tuned["SENTINEL_FRONTEND_BATCH"]
                and card["pipeline_depth"] == card["frontend_depth"]
                == tuned["SENTINEL_PIPELINE_DEPTH"]):
            fail(f"tune leg: the artifact did not apply: {card}")
        if tag == "tpu_copy" and not (
                c.get("tune.fingerprint_fallback") == 1
                and card["tuned"] == {} and card["batch_max"] == 256
                and card["pipeline_depth"] == 2):
            fail(f"tune leg: the TPU copy did not fall back: {card}")
        if tag == "typo" and c.get("tune.knob_rejected", 0) < 1:
            fail(f"tune leg: the typo'd knob was not rejected: {card}")
        starts[tag] = views
        log(f"[tune] startup {tag}: {card['counters']}, batch_max "
            f"{card['batch_max']}, depth {card['pipeline_depth']} "
            f"({card['start_s']:.1f} s at {R} rows; CPU twin equal)")
    rep["startups"] = starts
    if not launches:
        fail("tune leg: the sweep launched no kernel")
    rep["launches"] = launches
    return rep


def _state_bytes(sph) -> int:
    from sentinel_tpu_torch.core.snapshot import _leaves
    return sum(t.numel() * t.element_size() for t in _leaves(sph._state))


def _snap_runtime(stt, R: int, dev, flow_count: float = 50.0,
                  start_ms: int = TS_T0):
    """Phase 8's fixture (4096 QPS rules of ``flow_count``, 1024
    exception-ratio breakers), default configuration, under a
    ManualClock."""
    clock = stt.ManualClock(start_ms=start_ms)
    sph = _obs_runtime(stt, R, clock, dev)
    if flow_count != 50.0:
        sph.load_flow_rules([stt.FlowRule(resource=f"r{i}", count=flow_count)
                             for i in range(OBS_RULED)])
    return sph, clock


def _snap_steps(sph, clock, batches, failing, prev):
    """Fused steps over ``batches`` (exits of the step before), the clock
    ``TS_STEP_MS`` a step → (verdict arrays, the last batch)."""
    out = []
    for rows in batches:
        v = _fused_step(sph, rows, prev, failing).result()
        out.append((np.asarray(v.allow).copy(), np.asarray(v.reason).copy(),
                    np.asarray(v.wait_ms).copy()))
        prev = rows
        clock.advance_ms(TS_STEP_MS)
    return out, prev


def _verdicts_equal(a, b) -> bool:
    return len(a) == len(b) and all(
        all(np.array_equal(x, y) for x, y in zip(p, q)) for p, q in zip(a, b))


#: leaves a restore does not carry: the live thread gauges (as the
#: reference specifies) and the tiering sketch (not in the snapshot)
_NOT_RESTORED = ("threads", "alt_threads", "tiering.sketch")


def _snap_leaves(sph, keep=None) -> dict:
    from sentinel_tpu_torch import convert
    d = convert.engine_to_numpy(sph)
    return {k: v for k, v in d.items() if k not in _NOT_RESTORED
            and (keep is None or k.split(".")[0] in keep)}


def _snapshot_leg(stt, sa, dev, R: int, B: int, steps: int, twin_rows: int,
                  twin_B: int, tmp: str) -> dict:
    """(b) save a ``R``-row runtime after ``steps`` fused steps of ``B``
    events whose breakers trip, restore it (same rules: ``"full"``, the
    next ``steps`` steps equal to the original's; changed rules:
    ``"partial"``, windows equal; another geometry: ``False``), and a
    ``twin_rows`` snapshot written on the card restored in a CPU twin."""
    from sentinel_tpu_torch import convert
    from sentinel_tpu_torch.core.snapshot import load_state, save_state
    import shutil
    rep = {"R": R, "B": B, "steps": steps}
    sa.LAUNCHES.clear()
    a, ca = _snap_runtime(stt, R, dev)
    need = 2 * _state_bytes(a)
    free = shutil.disk_usage(tmp).free
    rep["free_bytes"], rep["state_bytes"] = free, need // 2
    log(f"[snapshot] {R} rows: {need // 2} state bytes, {free} bytes free "
        f"in {tmp}")
    if free < need:
        a.close()
        R = 1 << 18
        rep["cut_to_rows"] = R
        log(f"[snapshot] CUT: less than twice the state free on the "
            f"temporary disk; this leg runs at {R} rows")
        a, ca = _snap_runtime(stt, R, dev)
    batches, failing = _scalar_stream(a, B, 2 * steps, seed=151)
    before, prev = _snap_steps(a, ca, batches[:steps], failing,
                               np.zeros(0, np.int32))
    trips = sum(1 for s in a.breaker_states() if s)
    path = os.path.join(tmp, "snap")
    t = time.perf_counter()
    save_state(a, path)
    rep["save_ms"] = (time.perf_counter() - t) * 1e3
    rep["file_bytes"] = (os.path.getsize(path + ".npz")
                         + os.path.getsize(path + ".meta.json"))
    b, cb = _snap_runtime(stt, R, dev, start_ms=ca.now_ms())
    t = time.perf_counter()
    got = load_state(b, path)
    rep["restore_ms"] = (time.perf_counter() - t) * 1e3
    if got != "full":
        fail(f"snapshot leg: same-rules restore gave {got!r}")
    windows = _snap_leaves(b, keep=("second", "minute", "alt_second"))
    after_a, _ = _snap_steps(a, ca, batches[steps:], failing, prev)
    after_b, _ = _snap_steps(b, cb, batches[steps:], failing, prev)
    rep["launches"] = sa.LAUNCHES["scatter_add"]
    if not _verdicts_equal(after_a, after_b):
        fail("snapshot leg: the restored runtime's verdicts differ")
    bad = convert.leaf_diff(_snap_leaves(b), _snap_leaves(a))
    if bad:
        fail(f"snapshot leg: restored state differs in {bad[:8]}")
    rep["cache"] = {k: v for k, v in a.obs.counters.snapshot().items()
                    if k.startswith("compile_cache.")}
    a.close()
    b.close()
    c, _ = _snap_runtime(stt, R, dev, flow_count=60.0, start_ms=ca.now_ms())
    got_c = load_state(c, path)
    bad = convert.leaf_diff(_snap_leaves(c, keep=("second", "minute",
                                                  "alt_second")), windows)
    c.close()
    if got_c != "partial" or bad:
        fail(f"snapshot leg: changed-rules restore gave {got_c!r}, "
             f"windows differ in {bad[:8]}")
    d, _ = _snap_runtime(stt, 1 << 14, dev)
    got_d = load_state(d, path)
    d.close()
    if got_d is not False:
        fail(f"snapshot leg: another geometry restored {got_d!r}")
    os.unlink(path + ".npz")
    # the 2^14-row snapshot written on the card, restored on the CPU
    e, ce = _snap_runtime(stt, twin_rows, dev)
    tb, tf = _scalar_stream(e, twin_B, 2 * steps, seed=152, pool=8192)
    _, tprev = _snap_steps(e, ce, tb[:steps], tf, np.zeros(0, np.int32))
    tpath = os.path.join(tmp, "snap16k")
    save_state(e, tpath)
    twins = {}
    for tag, sph_dev in (("card", dev), ("cpu", "cpu")):
        f, cf = _snap_runtime(stt, twin_rows, sph_dev, start_ms=ce.now_ms())
        if load_state(f, tpath) != "full":
            fail(f"snapshot leg: the {tag} twin did not restore full")
        v, _ = _snap_steps(f, cf, tb[steps:], tf, tprev)
        twins[tag] = (v, _snap_leaves(f))
        f.close()
    e.close()
    rep["launches"] = sa.LAUNCHES["scatter_add"]
    if not _verdicts_equal(twins["card"][0], twins["cpu"][0]):
        fail("snapshot leg: the CPU twin's verdicts differ")
    bad = convert.leaf_diff(twins["cpu"][1], twins["card"][1])
    if bad:
        fail(f"snapshot leg: the CPU twin's state differs in {bad[:8]}")
    rep["breakers_open_at_save"] = trips
    if not trips:
        fail("snapshot leg: no breaker was open at the save")
    log(f"[snapshot] {R} rows: save {rep['save_ms']:.0f} ms, restore "
        f"{rep['restore_ms']:.0f} ms, {rep['file_bytes']} file bytes; "
        f"full / partial / False as required; next {steps} steps equal; "
        f"{twin_rows}-row card snapshot restores on the CPU equal; "
        f"compile_cache {rep['cache']}")
    return rep


def _cc_child_main(out_path: str, dev: str = "cuda") -> int:
    """One cold start on ``dev`` against ``SENTINEL_COMPILE_CACHE``: ms
    from here to the first kernel launch's verdicts, and which compilers
    ran."""
    t0 = time.perf_counter()
    from sentinel_tpu_torch.ops import _build
    calls = []
    compile_fn = _build._compile

    def counted(argv, lib):
        calls.append(os.path.basename(argv[0]))
        return compile_fn(argv, lib)

    _build._compile = counted
    import sentinel_tpu_torch as stt
    from sentinel_tpu_torch.ops import scatter_add as sa
    sph = stt.Sentinel(config=stt.load_config(max_resources=1 << 14),
                       device=dev)
    sph.load_flow_rules([stt.FlowRule(resource="x", count=5.0)])
    v = sph.entry_batch(["x"] * 1024)
    ms = (time.perf_counter() - t0) * 1e3
    out = {"first_launch_ms": ms, "compiled": calls,
           "launches": sa.LAUNCHES["scatter_add"],
           "allowed": int(np.asarray(v.allow).sum()),
           "native": type(sph.resources).__name__,
           "build_s": dict(_build.build_seconds)}
    sph.close()
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    return 0


def _cache_leg(tmp: str, dev: str) -> dict:
    """(c) two processes on ``dev``, one after the other, on a fresh
    ``SENTINEL_COMPILE_CACHE``: the first builds the kernel and the C++
    tables, the second finds both and compiles nothing."""
    cache = os.path.join(tmp, "build-cache")
    runs = []
    for i in range(2):
        out = os.path.join(tmp, f"cc{i}.json")
        env = dict(os.environ, SENTINEL_COMPILE_CACHE=cache)
        env.pop("SENTINEL_TPU_NATIVE", None)
        proc = subprocess.run(CC_CHILD_CMD + [out, dev], env=env,
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            fail(f"cache leg: start {i} ended with {proc.returncode}:\n"
                 f"{proc.stderr[-3000:]}")
        with open(out) as fh:
            runs.append(json.load(fh))
    cold, warm = runs
    want = ["g++", "nvcc"] if dev == "cuda" else ["g++"]
    if sorted(cold["compiled"]) != want or warm["compiled"]:
        fail(f"cache leg: compilers run {cold['compiled']} then "
             f"{warm['compiled']}")
    launched = dev != "cuda" or (cold["launches"] and warm["launches"])
    if not launched or cold["allowed"] != 5 or warm["allowed"] != 5:
        fail(f"cache leg: {cold} / {warm}")
    log(f"[cache] first launch {cold['first_launch_ms']:.0f} ms cold "
        f"(compiled {cold['compiled']}), {warm['first_launch_ms']:.0f} ms "
        f"warm (nothing compiled; {sorted(os.listdir(cache))})")
    return {"cold": cold, "warm": warm, "entries": sorted(os.listdir(cache))}


def _pct_us(xs, q) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def _grpc_stream(n_flow, batches: int, n: int, seed: int) -> list:
    """``batches`` mixed batches of ``n`` token requests (phase 11's
    stream: 3/4 flow, 1/4 param with 1-4 Zipf user ids) as the gRPC
    service's rows, in a seeded order."""
    rng = np.random.default_rng(seed)
    out = []
    for ids, acq, prio, pids, pacq, vals in _cluster_stream(n_flow, n,
                                                            batches, seed):
        rows = [(int(f), int(a), bool(p), ()) for f, a, p in
                zip(ids.tolist(), acq.tolist(), prio.tolist())]
        rows += [(int(f), int(a), False, [str(u) for u in v])
                 for f, a, v in zip(pids, pacq, vals)]
        out.append([rows[i] for i in rng.permutation(len(rows))])
    return out


def _grpc_leg(stt, sa, dev, batches: int, batch_n: int, threads: int,
              seconds: float, entries: int) -> dict:
    """(d) phase 11's engine behind ``TokenGrpcServer`` on loopback:
    ``batches`` mixed batches from one client against a CPU twin engine
    fed the same rows; one client alone (no deadline) for the service
    round trip of 1 and of ``batch_n`` items; then ``threads`` clients
    for ``seconds`` (half sending single requests, half batches of
    ``batch_n``) at the reference's 20 ms deadline; then
    ``entry()``+exit through a ``Sentinel`` whose token service is the
    gRPC client (its RPCs' statuses counted: a FAIL falls back to the
    local rule)."""
    import threading
    from sentinel_tpu_torch.cluster.grpc_token import (
        GrpcTokenClient, TokenGrpcServer, TokenGrpcService)
    from sentinel_tpu_torch.core.clock import Clock
    from sentinel_tpu_torch.parallel import cluster as tcl
    rules = _cluster_rules(tcl)
    eng = _cluster_engine(tcl, dev, rules)
    twin = _cluster_engine(tcl, "cpu", rules)
    clock = stt.ManualClock(start_ms=CLUSTER_T0)
    twin_clock = stt.ManualClock(start_ms=CLUSTER_T0)
    twin_svc = TokenGrpcService(twin, clock=twin_clock)
    stream = _grpc_stream(rules[0], batches, batch_n, seed=171)
    sa.LAUNCHES.clear()
    rep = {}
    srv = TokenGrpcServer(eng, host="127.0.0.1", port=0, clock=clock)
    port = srv.start()
    try:
        cli = GrpcTokenClient(f"127.0.0.1:{port}", namespace="ns0",
                              timeout_ms=60_000)
        got, want = [], []
        try:
            for rows in stream:
                got.append([(r.status, r.wait_ms, r.remaining)
                            for r in cli._batch(rows)])
                want.append(twin_svc.request_tokens(rows))
                clock.advance_ms(CLUSTER_STEP_MS)
                twin_clock.advance_ms(CLUSTER_STEP_MS)
        finally:
            cli.close()
    finally:
        srv.stop()
    if got != want:
        bad = sum(g != w for g, w in zip(got, want))
        fail(f"grpc leg: {bad} of {len(got)} batches differ from the CPU "
             f"twin")
    counts = collections.Counter(s for b in got for s, _, _ in b)
    rep["parity"] = {"batches": batches, "n": batch_n,
                     "statuses": dict(counts)}
    log(f"[grpc] {batches} batches of {batch_n} equal to the CPU twin: "
        f"{dict(counts)}")
    # timing on the wall clock: one client alone, then the reference
    # client's 20 ms deadline under ``threads`` clients
    srv = TokenGrpcServer(eng, host="127.0.0.1", port=0, clock=Clock())
    port = srv.start()
    singles = [[r] for b in stream for r in b[:64]]
    alone = {1: [], batch_n: []}
    cli = GrpcTokenClient(f"127.0.0.1:{port}", namespace="ns0",
                          timeout_ms=60_000)
    try:
        for k in range(256):
            rows = singles[k % len(singles)] if k % 4 else \
                stream[k % len(stream)]
            t = time.perf_counter_ns()
            res = cli._batch(rows)
            alone[len(rows)].append((time.perf_counter_ns() - t) / 1e3)
            if any(r.status == tcl.STATUS_FAIL for r in res):
                fail("grpc leg: a request without a deadline failed")
    finally:
        cli.close()
    rep["alone"] = {f"b{n}": {"rtt_p50_us": _pct_us(v, 50),
                              "rtt_p99_us": _pct_us(v, 99), "calls": len(v)}
                    for n, v in alone.items()}
    log(f"[grpc] one client, no deadline: batch 1 p50/p99 "
        f"{rep['alone']['b1']['rtt_p50_us']:.0f}/"
        f"{rep['alone']['b1']['rtt_p99_us']:.0f} us, batch {batch_n} "
        f"{rep['alone'][f'b{batch_n}']['rtt_p50_us']:.0f}/"
        f"{rep['alone'][f'b{batch_n}']['rtt_p99_us']:.0f} us")
    lat = {1: [], batch_n: []}
    fails = collections.Counter()
    items = collections.Counter()
    lock = threading.Lock()
    stop = time.perf_counter() + seconds

    def drive_grpc(i: int):
        n = 1 if i % 2 == 0 else batch_n
        c = GrpcTokenClient(f"127.0.0.1:{port}", namespace="ns0")
        mine, nf, ni, k = [], 0, 0, i
        try:
            while time.perf_counter() < stop:
                rows = (singles[k % len(singles)] if n == 1
                        else stream[k % len(stream)])
                k += threads
                t = time.perf_counter_ns()
                res = c._batch(rows)
                mine.append((time.perf_counter_ns() - t) / 1e3)
                ni += len(res)
                nf += sum(r.status == tcl.STATUS_FAIL for r in res)
        finally:
            c.close()
        with lock:
            lat[n].extend(mine)
            fails[n] += nf
            items[n] += ni

    try:
        workers = [threading.Thread(target=drive_grpc, args=(i,),
                                    daemon=True) for i in range(threads)]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=seconds + 120)
        wall = time.perf_counter() - t0
        if any(w.is_alive() for w in workers):
            fail("grpc leg: a client thread did not finish")
    finally:
        srv.stop()
    rep["timing"] = {
        "threads": threads, "seconds": wall,
        "items_per_s": sum(items.values()) / wall,
        "decisions_per_s": (sum(items.values()) - sum(fails.values()))
        / wall,
        **{f"b{n}": {"rtt_p50_us": _pct_us(lat[n], 50),
                     "rtt_p99_us": _pct_us(lat[n], 99), "calls": len(lat[n]),
                     "items": items[n], "fail_items": fails[n]}
           for n in lat}}
    tm = rep["timing"]
    log(f"[grpc] {threads} threads {wall:.1f} s: "
        f"{tm['items_per_s']:.0f} items/s, {tm['decisions_per_s']:.0f} "
        f"decided (not FAIL)/s; batch 1 p50/p99 "
        f"{tm['b1']['rtt_p50_us']:.0f}/{tm['b1']['rtt_p99_us']:.0f} us, "
        f"batch {batch_n} "
        f"{tm[f'b{batch_n}']['rtt_p50_us']:.0f}/"
        f"{tm[f'b{batch_n}']['rtt_p99_us']:.0f} us; STATUS_FAIL at 20 ms: "
        f"{fails[1]} + {fails[batch_n]} items")
    # entry()+exit through a Sentinel on the card whose token service is
    # the gRPC client (a cluster-mode rule on a flow of namespace ns1)
    srv = TokenGrpcServer(eng, host="127.0.0.1", port=0, clock=Clock())
    port = srv.start()
    sph = stt.Sentinel(config=stt.load_config(), device=dev)
    cli = GrpcTokenClient(f"127.0.0.1:{port}", namespace="ns1")
    try:
        sph.load_flow_rules([stt.FlowRule(
            resource="grpc-svc", count=1e6, cluster_mode=True,
            cluster_flow_id=5, cluster_fallback_to_local=True)])
        statuses = collections.Counter()
        rpc = cli._batch

        def counted_rpc(rows):
            out = rpc(rows)
            statuses.update(r.status for r in out)
            return out

        cli._batch = counted_rpc
        sph.set_token_service(cli)
        us, passed = [], 0
        for _ in range(entries):
            t = time.perf_counter_ns()
            try:
                with sph.entry("grpc-svc"):
                    passed += 1
            except stt.BlockException:
                pass
            us.append((time.perf_counter_ns() - t) / 1e3)
    finally:
        cli.close()
        sph.close()
        srv.stop()
    rep["entry"] = {"n": entries, "passed": passed,
                    "p50_us": _pct_us(us, 50), "p99_us": _pct_us(us, 99),
                    "rpc_statuses": dict(statuses)}
    if not passed or sum(statuses.values()) != entries:
        fail(f"grpc leg: {passed} entries passed, RPC statuses "
             f"{dict(statuses)}")
    rep["launches"] = sa.LAUNCHES["scatter_add"]
    log(f"[grpc] entry()+exit via the gRPC token service: p50 "
        f"{rep['entry']['p50_us']:.0f} us, p99 {rep['entry']['p99_us']:.0f}"
        f" us ({passed}/{entries} passed; RPC statuses {dict(statuses)}, "
        f"{tcl.STATUS_FAIL} = FAIL, checked locally)")
    return rep


def _rls_rules(rls):
    rules = []
    for d in range(RLS_DOMAINS):
        descs = []
        for k in range(RLS_DESCRIPTORS):
            entries = [("generic_key", f"k{k}")]
            if k % 4 == 3:
                entries.append(("dest", f"svc{k}"))
            descs.append(rls.RlsDescriptorRule(entries=entries,
                                               count=float(2 + (k * 7) % 40)))
        rules.append(rls.EnvoyRlsRule(domain=f"dom{d}", descriptors=descs))
    return rules


def _rls_requests(n: int, seed: int) -> list:
    """``n`` requests: a domain, 1-3 descriptors Zipf(1.1) over the
    limited ones (1 in 16 unknown), an addend 0-2, and whether the frame
    carries an undeclared field."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        dom = f"dom{int((rng.zipf(1.1) - 1) % RLS_DOMAINS)}"
        descs = []
        for _ in range(int(rng.integers(1, 4))):
            k = int((rng.zipf(1.1) - 1) % RLS_DESCRIPTORS)
            e = [("generic_key", f"k{k}")]
            if k % 4 == 3:
                e.append(("dest", f"svc{k}"))
            if rng.random() < 1 / 16:
                e = [("generic_key", f"unknown{k}")]
            descs.append(e)
        out.append((dom, descs, int(rng.integers(0, 3)),
                    bool(rng.random() < 0.125)))
    return out


def _rls_leg(stt, sa, dev, requests: int) -> dict:
    """(e) ``SentinelRlsGrpcServer`` over a card engine with rules on
    :data:`RLS_DOMAINS` domains: ``requests`` ``ShouldRateLimit`` frames
    over a real channel, every code equal to a CPU twin service fed the
    same requests under the same virtual clock."""
    import grpc
    from sentinel_tpu_torch.cluster import envoy_rls as rls
    from sentinel_tpu_torch.cluster.proto import envoy_rls_pb2 as pb
    from sentinel_tpu_torch.parallel import cluster as tcl
    spec = tcl.ClusterSpec(n_shards=CLUSTER_SHARDS, flows_per_shard=64,
                           namespaces=RLS_DOMAINS)
    clock = stt.ManualClock(start_ms=CLUSTER_T0)
    svc = rls.EnvoyRlsService(tcl.ClusterEngine(spec, device=dev),
                              clock=clock)
    twin_clock = stt.ManualClock(start_ms=CLUSTER_T0)
    twin = rls.EnvoyRlsService(tcl.ClusterEngine(spec, device="cpu"),
                               clock=twin_clock)
    for s in (svc, twin):
        s.rules.load_rules(_rls_rules(rls))
    reqs = _rls_requests(requests, seed=181)
    sa.LAUNCHES.clear()
    server = rls.SentinelRlsGrpcServer(svc, host="127.0.0.1", port=0)
    port = server.start()
    got, want, us = [], [], []
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            rpc = ch.unary_unary(rls.RLS_METHOD,
                                 request_serializer=lambda b: b,
                                 response_deserializer=
                                 pb.RateLimitResponse.FromString)
            for dom, descs, addend, unknown in reqs:
                req = pb.RateLimitRequest(domain=dom, hits_addend=addend)
                for e in descs:
                    d = req.descriptors.add()
                    for k, v in e:
                        ent = d.entries.add()
                        ent.key, ent.value = k, v
                raw = req.SerializeToString()
                if unknown:
                    raw += bytes([0x78, 0x2A])   # field 15: skipped
                t = time.perf_counter_ns()
                resp = rpc(raw, timeout=60)
                us.append((time.perf_counter_ns() - t) / 1e3)
                got.append((resp.overall_code,
                            [s.code for s in resp.statuses]))
                overall, st = twin.should_rate_limit(dom, descs, addend or 1)
                want.append((overall, [s.code for s in st]))
                clock.advance_ms(1)
                twin_clock.advance_ms(1)
    finally:
        server.stop()
    if got != want:
        bad = sum(g != w for g, w in zip(got, want))
        fail(f"rls leg: {bad} of {len(got)} responses differ from the CPU "
             f"twin")
    over = sum(g[0] == rls.CODE_OVER_LIMIT for g in got)
    if not (0 < over < len(got)):
        fail(f"rls leg: {over} of {len(got)} requests over the limit")
    rep = {"requests": requests, "over_limit": over,
           "p50_us": _pct_us(us, 50), "p99_us": _pct_us(us, 99),
           "launches": sa.LAUNCHES["scatter_add"]}
    log(f"[rls] {requests} ShouldRateLimit over gRPC equal to the CPU twin "
        f"({over} OVER_LIMIT): p50 {rep['p50_us']:.0f} us, p99 "
        f"{rep['p99_us']:.0f} us a request")
    return rep


def phase_tune_snapshot_grpc(stt, sa, dev="cuda", R=1 << 20,
                             twin_rows=1 << 14, grids=None,
                             rungs=(150, 450), rate: float = 2000.0,
                             B=1 << 19, steps: int = 8, twin_B=1 << 12,
                             grpc_batches: int = 64, grpc_n: int = 256,
                             grpc_threads: int = 8, grpc_s: float = 10.0,
                             grpc_entries: int = 256,
                             rls_requests: int = 4096) -> dict:
    """Phase 15 (``tune_snapshot_grpc``), all on ``Sentinel(device=dev)``:
    (a) :func:`_tune_leg`; (b) :func:`_snapshot_leg`; (c) the runtime's
    ``compile_cache.*`` after (b) and :func:`_cache_leg`; (d)
    :func:`_grpc_leg`; (e) :func:`_rls_leg`. Without ``grpc`` or
    ``google.protobuf``, (d) and (e) are reported as not run, naming the
    package."""
    import tempfile
    t_phase = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ts_") as tmp:
        res["tune"] = _tune_leg(stt, sa, dev, R, twin_rows,
                                grids or TS_GRIDS, rungs, rate, tmp)
        log(f"[phase15] (a) done at {time.perf_counter() - t_phase:.1f} s")
        res["snapshot"] = _snapshot_leg(stt, sa, dev, R, B, steps,
                                        twin_rows, twin_B, tmp)
        log(f"[phase15] (b) done at {time.perf_counter() - t_phase:.1f} s")
        res["cache"] = _cache_leg(tmp, dev)
        log(f"[phase15] (c) done at {time.perf_counter() - t_phase:.1f} s")
    missing = []
    for mod in ("grpc", "google.protobuf"):
        try:
            __import__(mod)
        except ImportError:
            missing.append(mod)
    launches = res["tune"]["launches"] + res["snapshot"]["launches"]
    if missing:
        res["grpc"] = res["rls"] = {"not_run": missing}
        log(f"[phase15] (d)-(e) not run: {', '.join(missing)} not installed")
    else:
        res["grpc"] = _grpc_leg(stt, sa, dev, grpc_batches, grpc_n,
                                grpc_threads, grpc_s, grpc_entries)
        log(f"[phase15] (d) done at {time.perf_counter() - t_phase:.1f} s")
        res["rls"] = _rls_leg(stt, sa, dev, rls_requests)
        launches += res["grpc"]["launches"] + res["rls"]["launches"]
        for leg in ("grpc", "rls"):
            if not res[leg]["launches"]:
                fail(f"phase 15: the {leg} leg launched no kernel")
    if not res["snapshot"]["launches"]:
        fail("phase 15: the snapshot leg launched no kernel")
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[phase15] took {res['seconds']:.1f} s; kernel launches {launches}")
    return res


# ---------------------------------------------------------------------------
# Phase 16: the port's analyzer and its SPI demos
# ---------------------------------------------------------------------------

HERE = os.path.dirname(os.path.abspath(__file__))
#: the port's lint scope and gate (docs/LINT_TORCH.md)
LINT_EXCLUDE = os.path.join("tests", "fixtures", "graftlint")
LINT_BASELINE = "graftlint-torch-baseline.json"
#: the port's SPI demos (each runs in a process of its own, as a user
#: runs it: the plugin demo sets the process-wide SPI state)
DEMOS = ("slot_spi", "command_handler_spi", "plugin_spi")
DEMO_CHILD_CMD = [sys.executable, os.path.abspath(__file__), "--demo"]


def _lint_scope() -> list:
    tests = sorted(os.path.join("tests", f)
                   for f in os.listdir(os.path.join(HERE, "tests"))
                   if f.startswith("test_torch_") and f.endswith(".py"))
    return (["sentinel_tpu_torch", "chip_smoke.py"] + tests
            + [os.path.join("demos", "torch")])


def _lint_leg(jobs: int, tmp: str) -> dict:
    """``python -m sentinel_tpu_torch.analysis`` over the port's scope at
    ``--jobs`` ``jobs``, with its baseline → the wall seconds, the JSON
    report (written under ``tmp``) and the summary line; fails on a
    non-zero exit or any unsuppressed finding."""
    report = os.path.join(tmp, f"graftlint_torch_j{jobs}.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sentinel_tpu_torch.analysis",
         *_lint_scope(), "--exclude", LINT_EXCLUDE, "--baseline",
         LINT_BASELINE, "--jobs", str(jobs), "--budget-s", "120",
         "--json-out", report], cwd=HERE, capture_output=True, text=True,
        timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"phase 16: graftlint at --jobs {jobs} exited "
             f"{proc.returncode}:\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    with open(report) as fh:
        doc = json.load(fh)
    if doc["unsuppressed_count"] != 0:
        fail(f"phase 16: graftlint at --jobs {jobs} reports "
             f"{doc['unsuppressed_count']} finding(s)")
    return {"wall_s": wall, "doc": doc, "summary": proc.stdout.strip()}


def _demo_child_main(name: str, dev: str, out_path: str) -> int:
    """The port's demo ``name`` on ``dev`` in this process, as a user runs
    it (``main(["--device", dev])``): its stdout, its scatter-add launches
    (counted from 0 just before it) and its device slots' state read
    back."""
    import contextlib
    import importlib.util
    import io
    from sentinel_tpu_torch.ops import scatter_add as sa
    path = os.path.join(HERE, "demos", "torch", name + ".py")
    spec = importlib.util.spec_from_file_location(f"demo_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    sa.LAUNCHES.clear()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        sph = mod.main(["--device", dev])
    if dev == "cuda":
        sync()
    out = {"stdout": buf.getvalue(), "seconds": time.perf_counter() - t0,
           "launches": sa.LAUNCHES["scatter_add"],
           "slots": [s.name for s in sph._device_slots],
           "slot_state": [t.cpu().tolist()
                          for _p, t in _leaves(sph._state.custom)]}
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    return 0


def phase_analysis_demos(stt, sa, dev="cuda") -> dict:
    """Phase 16 (``analysis_demos``): (a) the port's graftlint over the
    port's scope at ``--jobs 1`` and ``--jobs 4`` — 0 unsuppressed
    findings and the same findings from both; (b) the three port demos on
    ``dev`` and with ``--device cpu``, each run in a process of its own
    (all six at once): equal stdout, equal device-slot state, and the
    card runs' scatter-add launches counted into the kernel line."""
    import tempfile
    t_phase = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lint_") as tmp:
        for jobs in (1, 4):
            res[f"lint_j{jobs}"] = _lint_leg(jobs, tmp)
    one, four = res["lint_j1"]["doc"], res["lint_j4"]["doc"]
    if one["findings"] != four["findings"]:
        fail("phase 16: graftlint's findings at --jobs 1 and --jobs 4 "
             "differ")
    suppressed = collections.Counter(
        f["rule"] for f in one["findings"] if f["suppressed"])
    res["suppressed_by_rule"] = dict(sorted(suppressed.items()))
    res["files_scanned"] = one["files_scanned"]
    for jobs in (1, 4):
        res[f"lint_j{jobs}"] = {"wall_s": res[f"lint_j{jobs}"]["wall_s"],
                                "summary": res[f"lint_j{jobs}"]["summary"]}
    log(f"[analysis] graftlint over {one['files_scanned']} files: "
        f"{res['lint_j1']['summary']} | wall {res['lint_j1']['wall_s']:.2f} "
        f"s at --jobs 1, {res['lint_j4']['wall_s']:.2f} s at --jobs 4; "
        f"suppressed by rule {res['suppressed_by_rule']}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_demos_") as tmp:
        procs = {}
        for d in (dev, "cpu"):
            for name in DEMOS:
                out = os.path.join(tmp, f"{name}_{d}.json")
                procs[d, name] = (subprocess.Popen(
                    DEMO_CHILD_CMD + [name, d, out], cwd=tmp,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), out)
        runs = {dev: {}, "cpu": {}}
        for (d, name), (proc, out) in procs.items():
            log_text, _ = proc.communicate(timeout=300)
            if proc.returncode != 0:
                fail(f"phase 16: demo {name} on {d} exited "
                     f"{proc.returncode}:\n{log_text[-2000:]}")
            with open(out) as fh:
                runs[d][name] = json.load(fh)
    card, cpu = runs[dev], runs["cpu"]
    for name in DEMOS:
        if not card[name]["stdout"].strip():
            fail(f"phase 16: demo {name} printed nothing")
        if card[name]["stdout"] != cpu[name]["stdout"]:
            fail(f"phase 16: demo {name} on {dev} printed otherwise than on "
                 f"the CPU:\n{card[name]['stdout']}\n--\n"
                 f"{cpu[name]['stdout']}")
        if (card[name]["slots"], card[name]["slot_state"]) != \
                (cpu[name]["slots"], cpu[name]["slot_state"]):
            fail(f"phase 16: demo {name}'s device slot state differs: "
                 f"{card[name]['slot_state']} against "
                 f"{cpu[name]['slot_state']}")
        if cpu[name]["launches"]:
            fail(f"phase 16: demo {name} launched the kernel on the CPU")
    if not card["slot_spi"]["slot_state"]:
        fail("phase 16: the slot demo's device slot has no state")
    launches = sum(card[n]["launches"] for n in DEMOS)
    if not launches:
        fail("phase 16: the demos launched no kernel on the card")
    res["demos"] = {n: {k: card[n][k] for k in
                        ("launches", "seconds", "slots", "slot_state")}
                    for n in DEMOS}
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    state = card["slot_spi"]["slot_state"]
    log("[demos] " + ", ".join(
        f"{n}: {card[n]['launches']} launches, {card[n]['seconds']:.2f} s"
        for n in DEMOS) + f"; stdout and slot state {state} equal on "
        f"{dev} and the CPU")
    log(f"[phase16] took {res['seconds']:.1f} s; kernel launches {launches}")
    return res


# ---------------------------------------------------------------------------
# Phase 17: the multi-process fabric (``multihost/``) — the cluster token
# engine over several processes, and the fleet aggregates
# ---------------------------------------------------------------------------

MH_PARITY = ["-m", "sentinel_tpu_torch.multihost._parity_worker"]
MH_FLEET_ARGV = [os.path.abspath(__file__), "--mh-fleet"]
#: OK, BLOCKED, BAD_REQUEST, NO_RULE_EXISTS: the parity stream's statuses
MH_STATUSES = (0, 1, -4, 3)
MH_FLEET_T0 = 1_820_000_000_000
MH_FLEET_K = 16              # the fleet merge's top-K (both aggregates)


def _mh_lines(results, tag: str) -> list:
    return [json.loads(line.split(":", 1)[1]) for r in results
            for line in r.stdout.splitlines() if line.startswith(tag)]


def _mh_launch(argv, n: int, shards: int, platform: str, env: dict,
               timeout_s: float = 300.0, phase: str = "phase 17"):
    """The port's launcher → (worker results, wall s); a failed worker
    fails the phase with every rank's log."""
    import importlib
    mh_launch = importlib.import_module("sentinel_tpu_torch.multihost.launch")
    t0 = time.perf_counter()
    try:
        res = mh_launch.launch(argv, n, devices_per_process=shards, env=env,
                               timeout_s=timeout_s, platform=platform)
    except mh_launch.LaunchError as exc:
        fail(f"{phase}: {' '.join(argv[-3:])} in {n} process(es) on "
             f"{platform} failed:\n{str(exc)[-4000:]}")
    return res, time.perf_counter() - t0


def _mh_ranks(results, tag: str, n: int) -> list:
    ranks = sorted(_mh_lines(results, tag), key=lambda r: r["process_index"])
    if [r["process_index"] for r in ranks] != list(range(n)):
        fail(f"phase 17: {len(ranks)} {tag} line(s) from {n} rank(s):\n"
             + "\n".join(r.stdout[-1000:] + r.stderr[-1000:]
                         for r in results))
    return ranks


def _mh_parity_run(tag: str, results, n: int, backend: str,
                   devices: list) -> dict:
    """One parity launch's payload, its ranks' backends, devices and
    launches checked."""
    payloads = _mh_lines(results, "PARITY_JSON:")
    if len(payloads) != 1:
        fail(f"phase 17 (a): {tag} printed {len(payloads)} PARITY_JSON")
    ranks = _mh_ranks(results, "RANK_JSON:", n)
    got = [(r["backend"], r["device"]) for r in ranks]
    if got != [(backend, d) for d in devices]:
        fail(f"phase 17 (a): {tag} ranks ran on {got}, want {backend} on "
             f"{devices}")
    out = dict(payloads[0], ranks=ranks,
               launches=sum(r["launches"] for r in ranks))
    log(f"[multihost] (a) {tag}: " + "; ".join(
        f"rank {r['process_index']} {r['backend']} on {r['device']}, "
        f"shards {r['local_shards']}, {r['launches']} launches"
        for r in ranks))
    return out


def _mh_parity_equal(runs: dict, base: str) -> None:
    ref = runs[base]
    for tag, run in runs.items():
        for key in ("decisions", "flow_window", "flow_metrics"):
            if run[key] != ref[key]:
                fail(f"phase 17 (a): {key} of {tag} differ from {base}'s")
    statuses = {d[0] for d in ref["decisions"]}
    if not set(MH_STATUSES) <= statuses:
        fail(f"phase 17 (a): the stream's statuses {sorted(statuses)} miss "
             f"some of {MH_STATUSES}: the parity proves nothing")


def _mh_full_run(tag: str, results, steps: int, backend: str,
                 devices: list) -> dict:
    """(b): every rank's turns agree step by step with rank 0's first
    mesh turn; each engine step launched 2 kernels a rank (flows and
    namespaces) and ran one all_reduce and one all_gather → the step
    times, grants/s and the collectives' ms a step."""
    ranks = _mh_ranks(results, "FULL_JSON:", 2)
    got = [(r["backend"], r["device"]) for r in ranks]
    if got != [(backend, d) for d in devices]:
        fail(f"phase 17 (b): {tag} ranks ran on {got}")
    kinds = [[t["kind"] for t in r["turns"]] for r in ranks]
    if kinds != [["mesh", "single", "single", "mesh"], ["mesh", "mesh"]]:
        fail(f"phase 17 (b): {tag} turns {kinds}")
    ref = ranks[0]["turns"][0]
    for r in ranks:
        for t in r["turns"]:
            if t["digests"] != ref["digests"] or t["grants"] != ref["grants"]:
                bad = next((i for i, (a, b) in enumerate(
                    zip(t["digests"], ref["digests"])) if a != b), None)
                fail(f"phase 17 (b): {tag} rank {r['process_index']}'s "
                     f"{t['kind']} turn differs at step {bad}")
            if t["launches"] != 2 * steps:
                fail(f"phase 17 (b): {tag} rank {r['process_index']} "
                     f"launched {t['launches']} in {steps} steps of a "
                     f"{t['kind']} turn, want 2 a step")
            want = steps if t["kind"] == "mesh" else 0
            if (t["all_reduce_calls"], t["all_gather_calls"]) != (want,
                                                                  want):
                fail(f"phase 17 (b): {tag} {t['kind']} turn ran "
                     f"{t['all_reduce_calls']} all_reduce and "
                     f"{t['all_gather_calls']} all_gather in {steps} steps")
    batch = ranks[0]["batch"]
    out = {"batch": batch, "steps": steps, "grants_per_step":
           ref["grants"] / steps, "launches": sum(
               t["launches"] for r in ranks for t in r["turns"])}
    for kind in ("mesh", "single"):
        turns = [t for t in ranks[0]["turns"] if t["kind"] == kind]
        ms = [x for t in turns for x in t["step_ms"]]
        secs = sum(ms) / 1e3
        out[kind] = {
            "step_ms": summary(ms), "step_ms_p99": float(np.percentile(
                ms, 99)),
            "grants_per_s": ref["grants"] * len(turns) / secs,
            "decisions_per_s": batch * steps * len(turns) / secs}
    out["per_rank"] = [{
        "process_index": r["process_index"],
        "all_reduce_ms_per_step": float(np.mean(
            [t["all_reduce_ms"] / steps for t in r["turns"]
             if t["kind"] == "mesh"])),
        "all_gather_ms_per_step": float(np.mean(
            [t["all_gather_ms"] / steps for t in r["turns"]
             if t["kind"] == "mesh"])),
        "launches_per_step": 2} for r in ranks]
    m, s = out["mesh"], out["single"]
    log(f"[multihost] (b) {tag}: S=8 L=512 B={batch} x {steps} steps, "
        f"verdict digests equal step by step (2x4 mesh on both ranks, "
        f"1x8 on rank 0, in turns); 2x4 step p50 "
        f"{m['step_ms']['median']:.2f} ms p99 {m['step_ms_p99']:.2f}, "
        f"{m['grants_per_s']:.0f} grants/s; 1x8 p50 "
        f"{s['step_ms']['median']:.2f} ms p99 {s['step_ms_p99']:.2f}, "
        f"{s['grants_per_s']:.0f} grants/s; " + "; ".join(
            f"rank {p['process_index']} all_reduce "
            f"{p['all_reduce_ms_per_step']:.2f} ms, all_gather "
            f"{p['all_gather_ms_per_step']:.2f} ms a step"
            for p in out["per_rank"]) + "; 2 launches a step a rank")
    return out


def _mh_block_cases(sa, timer, cap: str) -> list:
    """(b)'s per-process block shapes: each rank's captured scatter-adds
    of one warm-up step, kernel against its plain version on the card
    (every capture), timed on rank 0's."""
    out = []
    for rank in (0, 1):
        for c in torch.load(f"{cap}.{rank}.pt"):
            shape, stride, off = c["shape"], tuple(c["stride"]), c["offset"]
            rows = c["table"].shape
            name = (f"multihost block {list(shape)} slice of {list(rows)}, "
                    f"payload E={shape[1]}, N={c['keys'].shape[0]} "
                    f"(rank {rank} of 2)")
            case = dict(
                name=name, per_step=1, table=c["table"].cuda(),
                view_of=(lambda t, shape=shape, stride=stride, off=off:
                         t.as_strided(shape, stride, off)),
                keys=c["keys"].cuda(), amounts=c["amounts"].cuda(),
                events=(None if c["events"] is None
                        else c["events"].cuda()), path=None)
            out.append(_kernel_case(sa, timer, case, timed=rank == 0))
    return out


def _mh_fleet_main(out_dir: str) -> int:
    """(c) one rank: phase 8's runtime at 1M rows on this rank's card,
    a few fused steps of this rank's own traffic (phase 8's stream under
    its own seed, with 1/32 of each batch on 8 resources hot on every rank
    and 1/64 on 8 of this rank's own), a telemetry poll, then the three
    fleet aggregates (each timed), written to ``out_dir/rank<p>.json``
    with this rank's own counter vector and hot entries."""
    import sentinel_tpu_torch as stt
    from sentinel_tpu_torch import multihost
    from sentinel_tpu_torch.multihost import obs_agg
    from sentinel_tpu_torch.ops import scatter_add as sa
    rows, batch, steps = (int(os.environ["MH_FLEET_ROWS"]),
                          int(os.environ["MH_FLEET_BATCH"]),
                          int(os.environ["MH_FLEET_STEPS"]))
    with multihost.initialize() as rt:
        p = rt.process_index
        clock = stt.ManualClock(start_ms=MH_FLEET_T0)
        sph = _obs_runtime(stt, rows, clock, rt.device)
        batches, failing = _scalar_stream(sph, batch, steps, seed=41 + p)
        ruled = sph.intern_resources([f"r{i}" for i in range(32)])
        shared, own = batch // 32, batch // 64
        for b in batches:
            b[:shared] = ruled[np.arange(shared) % 8]
            b[shared:shared + own] = ruled[8 + 8 * (p + 1)
                                           + np.arange(own) % 8]
        prev = np.empty(0, np.int32)
        sa.LAUNCHES.clear()
        for step_rows in batches:
            clock.advance_ms(2)
            v = _fused_step(sph, step_rows, prev, failing).result()
            prev = step_rows[v.allow]
        if rt.device.type == "cuda":
            sync()
        launches = sa.LAUNCHES["scatter_add"]
        clock.advance_ms(50)
        sph.telemetry.poll()
        local = {"counters": obs_agg.local_counter_vector(sph).tolist(),
                 "hot": sph.telemetry.hot_entries(MH_FLEET_K),
                 "hist_buckets": int(sph.spec.hist_buckets)}
        rt.barrier("fleet-ready")
        aggs, ms = {}, {}
        for name, fn in (
                ("counters", lambda: obs_agg.aggregate_counters(sph)),
                ("topk", lambda: obs_agg.aggregate_topk(sph, k=MH_FLEET_K)),
                ("resource_hist", lambda: obs_agg.aggregate_resource_hist(
                    sph, k=MH_FLEET_K))):
            t0 = time.perf_counter()
            aggs[name] = fn()
            ms[name] = (time.perf_counter() - t0) * 1e3
        with open(os.path.join(out_dir, f"rank{p}.json"), "w") as fh:
            json.dump({"process_index": p, "backend": rt.backend,
                       "device": str(rt.device), "rows": rows,
                       "launches": launches,
                       "local": local, "aggregates": aggs, "ms": ms}, fh)
        rt.barrier("fleet-done")
        sph.close()
    return 0


def _mh_fleet_merge(ranks: list, k: int) -> dict:
    """The host-side merge of each rank's own counter vector and hot
    entries: what the three aggregates must equal."""
    from sentinel_tpu_torch.obs import counters as ck
    from sentinel_tpu_torch.obs.resource_hist import np_quantiles
    vecs = np.asarray([r["local"]["counters"] for r in ranks], np.int64)
    load, hosts, hist = {}, {}, {}
    hb = ranks[0]["local"]["hist_buckets"]
    for r in ranks:
        for h in r["local"]["hot"][:k]:
            name = h["resource"].encode("utf-8")[:64].decode(
                "utf-8", errors="replace")
            cur = load.setdefault(name, [0, 0, 0])
            for i, key in enumerate(("load", "pass", "block")):
                cur[i] += int(h[key])
            hosts[name] = hosts.get(name, 0) + 1
            if h.get("rt_hist") is not None and len(h["rt_hist"]) == hb:
                hist[name] = hist.get(name, 0) + np.asarray(h["rt_hist"],
                                                            np.int64)
    top = sorted(load.items(), key=lambda it: (-it[1][0], it[0]))[:k]
    hot = sorted(hist.items(), key=lambda it: (-int(it[1].sum()), it[0]))[:k]
    return {
        "counters": {"process_count": len(ranks),
                     "per_process": [ck.vector_counts(v) for v in vecs],
                     "total": ck.vector_counts(vecs.sum(0))},
        "topk": [{"resource": n, "load": s[0], "pass": s[1], "block": s[2],
                  "hosts": hosts[n]} for n, s in top],
        "resource_hist": [
            {"resource": n, "total": int(v.sum()), "hosts": hosts[n],
             "rt_hist": [int(c) for c in v],
             **{f"rt_p{q}_ms": round(float(x), 3) for q, x in zip(
                 (50, 95, 99), np_quantiles(v))}} for n, v in hot]}


def _mh_fleet_check(tmp: str) -> dict:
    ranks = []
    for p in (0, 1):
        with open(os.path.join(tmp, f"rank{p}.json")) as fh:
            ranks.append(json.load(fh))
    want = _mh_fleet_merge(ranks, MH_FLEET_K)
    for r in ranks:
        a = r["aggregates"]
        got = {"counters": {k: a["counters"][k] for k in
                            ("process_count", "per_process", "total")},
               "topk": a["topk"]["hot"], "resource_hist":
               a["resource_hist"]["hot"]}
        for key in want:
            if got[key] != want[key]:
                fail(f"phase 17 (c): rank {r['process_index']}'s "
                     f"aggregate_{key} differs from the host-side merge")
        if a["counters"]["process_index"] != r["process_index"]:
            fail("phase 17 (c): aggregate_counters' process_index")
    if not want["resource_hist"] or max(h["hosts"] for h in want["topk"]) < 2:
        fail("phase 17 (c): the fleet's hot views never met on a resource")
    if any(h["total"] >= 1 << 24 for h in want["resource_hist"]):
        fail("phase 17 (c): a merged histogram row passed 2^24")
    if not all(r["launches"] for r in ranks):
        fail("phase 17 (c): a rank's fused steps launched no kernel")
    out = {"launches": sum(r["launches"] for r in ranks),
           "ms": {k: [r["ms"][k] for r in ranks] for k in ranks[0]["ms"]},
           "ranks": [(r["backend"], r["device"]) for r in ranks],
           "shared_hot": sum(1 for h in want["topk"] if h["hosts"] == 2),
           "counter_keys": len(want["counters"]["total"])}
    log(f"[multihost] (c) 2 x Sentinel({ranks[0]['rows']} rows) on "
        f"{out['ranks']}: "
        f"aggregate_counters ({out['counter_keys']} keys), aggregate_topk "
        f"(k={MH_FLEET_K}, {out['shared_hot']} resources hot on both) and "
        f"aggregate_resource_hist equal the host-side merge on both ranks; "
        f"ms a call by rank " + ", ".join(
            f"{k} {v[0]:.2f}/{v[1]:.2f}" for k, v in out["ms"].items())
        + f"; launches {out['launches']}")
    return out


def phase_multihost(stt, sa, dev="cuda", timer=None, steps: int = 40,
                    fleet_rows: int = 1 << 20, fleet_batch: int = 1 << 19,
                    fleet_steps: int = 4) -> dict:
    """Phase 17 (``multihost``), through the port's own launcher, every
    child on one build directory (none compiles): (a) the parity worker
    in 1 process x 8 shards on the card, 2 x 4 with both ranks on the one
    card (gloo) and 2 x 4 on the CPU — equal decisions, flow windows and
    ``flow_metrics``; (b) the config 5 engine at full width, 2 x 4 on the
    card against 1 x 8 in turns (:func:`_mh_full_run`), and the kernel
    against its plain version at the ranks' block shapes; (c) two 1M-row
    runtimes on the card and the three fleet aggregates against a
    host-side merge; (d) with two cards or more, (a) and (b) again with a
    card a rank on NCCL. (a) and (c) run at once, (b) and (d) alone."""
    import tempfile
    from sentinel_tpu_torch.core.compile_cache import cache_dir
    t_phase = time.perf_counter()
    built = sorted(os.listdir(cache_dir()))
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    env = {"SENTINEL_COMPILE_CACHE": cache_dir()}
    one_card = dict(env, CUDA_VISIBLE_DEVICES=first)
    res = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mh_") as tmp:
        fleet_env = dict(one_card, MH_FLEET_ROWS=str(fleet_rows),
                         MH_FLEET_BATCH=str(fleet_batch),
                         MH_FLEET_STEPS=str(fleet_steps))
        jobs = {
            "card_1x8": (MH_PARITY, 1, 8, dev, one_card),
            "card_2x4": (MH_PARITY, 2, 4, dev, one_card),
            "cpu_2x4": (MH_PARITY, 2, 4, "cpu", env),
            "fleet": (MH_FLEET_ARGV + [tmp], 2, 1, dev, fleet_env)}
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
            futs = {k: pool.submit(_mh_launch, *a) for k, a in jobs.items()}
            done = {k: f.result() for k, f in futs.items()}
        res["wall_s"] = {k: v[1] for k, v in done.items()}
        card = "cpu" if dev == "cpu" else "cuda:0"
        runs = {
            # one rank with a card of its own: the rule says nccl (no
            # process group forms for one process)
            "card_1x8": _mh_parity_run("1 x 8 on the card", done[
                "card_1x8"][0], 1, "gloo" if dev == "cpu" else "nccl",
                [card]),
            "card_2x4": _mh_parity_run("2 x 4 on one card", done[
                "card_2x4"][0], 2, "gloo", [card, card]),
            "cpu_2x4": _mh_parity_run("2 x 4 on the CPU", done[
                "cpu_2x4"][0], 2, "gloo", ["cpu", "cpu"])}
        _mh_parity_equal(runs, "card_1x8")
        if not runs["card_1x8"]["launches"] or \
                not runs["card_2x4"]["launches"]:
            fail("phase 17 (a): a card run launched no kernel")
        if runs["cpu_2x4"]["launches"]:
            fail("phase 17 (a): the CPU run launched the kernel")
        res["parity"] = {k: {"launches": v["launches"], "ranks": [
            (r["backend"], r["device"]) for r in v["ranks"]]}
            for k, v in runs.items()}
        res["parity"]["decisions"] = len(runs["card_1x8"]["decisions"])
        log(f"[multihost] (a) {res['parity']['decisions']} decisions, the "
            f"flow windows and flow_metrics equal on the card 1 x 8, the "
            f"card 2 x 4 and the CPU 2 x 4")
        res["fleet"] = _mh_fleet_check(tmp)

        cap = os.path.join(tmp, "capture")
        full, res["wall_s"]["full"] = _mh_launch(
            MH_PARITY + ["--width", "full", "--steps", str(steps),
                         "--capture", cap], 2, 4, dev, one_card)
        res["full"] = _mh_full_run("2 x 4 on one card (gloo)", full, steps,
                                   "gloo", [card, card])
        res["block_cases"] = _mh_block_cases(sa, timer, cap)

        cards = torch.cuda.device_count()
        if cards >= 2:
            nccl = _mh_parity_run("2 x 4 on two cards (NCCL)", _mh_launch(
                MH_PARITY, 2, 4, dev, env)[0], 2, "nccl",
                ["cuda:0", "cuda:1"])
            _mh_parity_equal({"card_1x8": runs["card_1x8"], "nccl": nccl},
                             "card_1x8")
            full_nccl, _ = _mh_launch(
                MH_PARITY + ["--width", "full", "--steps", str(steps)], 2,
                4, dev, env)
            res["nccl"] = {"parity_launches": nccl["launches"],
                           "full": _mh_full_run(
                               "2 x 4 on two cards (NCCL)", full_nccl,
                               steps, "nccl", ["cuda:0", "cuda:1"])}
            if res["nccl"]["full"]["mesh"]["grants_per_s"] <= 0:
                fail("phase 17 (d): no grants")
        else:
            res["nccl"] = {"ran": False, "why": (
                f"{cards} card: NCCL refuses two ranks on one GPU, so the "
                f"one-rank-a-card legs need two cards")}
            log(f"[multihost] (d) NCCL legs not run: {res['nccl']['why']}")
    if sorted(os.listdir(cache_dir())) != built:
        fail("phase 17: a child process compiled: the build directory "
             "changed")
    nccl_launches = (0 if "full" not in res["nccl"] else
                     res["nccl"]["parity_launches"]
                     + res["nccl"]["full"]["launches"])
    res["launches"] = (runs["card_1x8"]["launches"]
                       + runs["card_2x4"]["launches"]
                       + res["fleet"]["launches"] + res["full"]["launches"]
                       + nccl_launches)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[phase17] took {res['seconds']:.1f} s (launches at once "
        + ", ".join(f"{k} {v:.1f} s" for k, v in res["wall_s"].items())
        + f"); kernel launches {res['launches']}")
    return res


# ---------------------------------------------------------------------------
# Phase 18: the row-sharded runtime, Sentinel(mesh=) over N row blocks
# ---------------------------------------------------------------------------

MESH_BLOCKS = 8          # row blocks of the meshed runtimes
MESH_ORIGINS = 64        # origins on half of the general route's events


def _mesh_runtime(stt, R: int, clock, dev, mesh=None):
    """Phase 8's runtime fixture (default configuration, ``R`` rows, the
    scalar fixture's 4096 QPS rules and 1024 exception-ratio breakers,
    RT histograms on) with the thread gauges kept (their block shape
    runs), on ``mesh``'s row blocks or, without one, on ``dev``."""
    cfg = stt.load_config(max_resources=R, thread_gauge_always=True)
    where = {"mesh": mesh} if mesh is not None else {"device": dev}
    sph = stt.Sentinel(config=cfg, clock=clock, **where)
    sph.load_flow_rules([stt.FlowRule(resource=f"r{i}", count=50.0)
                         for i in range(OBS_RULED)])
    sph.load_degrade_rules([stt.DegradeRule(
        resource=f"r{i}", grade=stt.GRADE_EXCEPTION_RATIO, count=0.5,
        time_window=10, min_request_amount=5) for i in range(1024)])
    return sph


def _mesh_stream(sph, B: int, steps: int, route: str, seed: int = 61):
    """``steps`` steps of phase 8's scalar traffic (interned in the same
    order in every runtime), its rule-free names filling the table so the
    rows spread over every block → ``[(rows, origin ids, origin rows)]``
    and the failing set; ``general`` gives half the events one of 64
    origins (at 2^21 alt rows the fast route's key does not fit: the
    general route)."""
    batches, failing = _scalar_stream(
        sph, B, steps, seed=seed, pool=sph.spec.rows - 2 * OBS_RULED)
    ra = sph.spec.alt_rows
    oids = np.asarray([sph.origins.pin(f"o{i}")
                       for i in range(MESH_ORIGINS)], np.int32)
    rng = np.random.default_rng(seed + 1)
    out = []
    for rows in batches:
        if route == "scalar":
            out.append((rows, np.zeros(B, np.int32),
                        np.full(B, ra, np.int32)))
            continue
        has = rng.random(B) < 0.5
        oid = np.where(has, oids[rng.integers(0, MESH_ORIGINS, B)], 0)
        orow = np.where(has, _alt_rows_np(rows, 0, oid, ra), ra)
        out.append((rows, oid.astype(np.int32), orow.astype(np.int32)))
    return out, failing


def _mesh_step(sph, step, prev, failing):
    """One fused decide+exit step: this step's events, the previous
    step's admitted ones exiting (with their origin rows)."""
    rows, oid, orow = step
    n = rows.shape[0]
    ra = sph.spec.alt_rows
    p_rows, p_orow = prev
    return sph.decide_and_exit_raw_nowait(
        rows, oid, orow, np.zeros(n, np.int32), np.full(n, ra, np.int32),
        np.ones(n, np.int32), np.ones(n, np.bool_), np.zeros(n, np.bool_),
        exit_rows=p_rows, exit_origin_rows=p_orow,
        exit_error=np.isin(p_rows, list(failing)),
        exit_rt_ms=(p_rows % 97).astype(np.int32))


def _mesh_state_diff(ms, os_) -> list:
    """Leaves of a row-block state and a one-block state that differ,
    compared block by block where they live: block ``i`` against the
    one-block tensor's rows ``[i·per, (i+1)·per)`` (a view: nothing is
    concatenated)."""
    from sentinel_tpu_torch.parallel.row_blocks import RowBlocks
    bad = []

    def walk(a, b, path):
        if a is None or b is None:
            if (a is None) != (b is None):
                bad.append(path)
            return
        if isinstance(a, RowBlocks):
            if a.rows != b.shape[0]:
                bad.append(path)
                return
            for i, blk in enumerate(a.blocks):
                part = b[i * a.per:(i + 1) * a.per]
                if (blk.shape != part.shape or blk.dtype != part.dtype
                        or not torch.equal(blk, part.to(blk.device))):
                    bad.append(f"{path}[block {i}]")
            return
        if isinstance(a, torch.Tensor):
            if (a.shape != b.shape or a.dtype != b.dtype
                    or not torch.equal(a, b.to(a.device))):
                bad.append(path)
            return
        names = getattr(a, "_fields", None) or range(len(a))
        for name, x, y in zip(names, a, b):
            walk(x, y, f"{path}{name}.")

    walk(ms, os_, "")
    return bad


def _verdict_digest(v) -> str:
    import hashlib
    h = hashlib.sha256()
    for col in (v.allow, v.reason, v.wait_ms):
        h.update(np.ascontiguousarray(np.asarray(col)).tobytes())
    return h.hexdigest()[:16]


def _capture_blocks(sa, run, seen: dict, state, block: int = 1) -> None:
    """``run()`` with the scatter seam recording, into ``seen``, the
    first launch into each block shape of block ``block`` of ``state``'s
    row blocks not seen yet (the table it views, its view geometry, the
    lanes) for phase 2's per-shape table. Block 1 is a typical one: block
    0 also holds the ENTRY row and the ruled rows."""
    from sentinel_tpu_torch.parallel.row_blocks import RowBlocks
    real = sa.scatter_add
    blocks = set()

    def walk(x):
        if isinstance(x, RowBlocks):
            blocks.add(x.blocks[block].untyped_storage().data_ptr())
        elif isinstance(x, tuple):
            for v in x:
                walk(v)
    walk(state)

    def capture(table, keys, events, amounts):
        base = table._base if table._base is not None else table
        sig = (tuple(table.shape), tuple(table.stride()), tuple(base.shape),
               str(table.dtype), events is None, int(keys.shape[0]))
        if sig not in seen and \
                base.untyped_storage().data_ptr() in blocks:
            seen[sig] = dict(
                table=base.clone(), shape=tuple(table.shape),
                stride=tuple(table.stride()),
                offset=table.storage_offset() - base.storage_offset(),
                keys=keys.clone(),
                events=None if events is None else events.clone(),
                amounts=amounts.clone())
        return real(table, keys, events, amounts)

    sa.scatter_add = capture
    try:
        run()
    finally:
        sa.scatter_add = real


def _mesh_block_cases(sa, timer, caps) -> list:
    """(b): the kernel against its plain version at every captured block
    shape — timed cold and warm against ``index_add_`` over the owned
    lanes (``_library_call`` drops the others) when ``timer`` is given."""
    out = []
    for c in caps:
        shape, stride, off = c["shape"], c["stride"], c["offset"]
        owned = int(((c["keys"] >= 0) & (c["keys"] < shape[0])).sum())
        mode = (f"payload E={shape[1]}" if c["events"] is None
                else "event mode")
        name = (f"meshed block {list(shape)} of {list(c['table'].shape)} "
                f"{str(c['table'].dtype).split('.')[-1]}, {mode}, "
                f"N={c['keys'].shape[0]} ({owned} owned)")
        case = dict(
            name=name, per_step=1, table=c["table"],
            view_of=(lambda t, shape=shape, stride=stride, off=off:
                     t.as_strided(shape, stride, off)),
            keys=c["keys"], amounts=c["amounts"], events=c["events"],
            path=None)
        out.append(_kernel_case(sa, timer, case, timed=timer is not None))
    return out


def _mesh_run(stt, sa, dev, meshes: dict, R, B, steps, route, seen=None,
              profile_steps: int = 0) -> dict:
    """One route on runtimes built by ``meshes`` (name → mesh, None for
    one block), the same stream in turns: verdicts equal to the first's
    and — against a one-block runtime — every state leaf equal at every
    step, compared block by block on the card. ``seen`` collects the
    block shapes of the meshed step's second launch round."""
    t0 = 1_800_000_000_000
    engines = {name: _mesh_runtime(stt, R, stt.ManualClock(start_ms=t0),
                                   dev, mesh)
               for name, mesh in meshes.items()}
    names = list(engines)
    streams = {n: _mesh_stream(sph, B, steps, route)
               for n, sph in engines.items()}
    stream, failing = streams[names[0]]
    for n in names[1:]:
        if not all(np.array_equal(a[0], b[0]) and np.array_equal(a[2], b[2])
                   for a, b in zip(stream, streams[n][0])):
            fail(f"phase 18 {route}: the runtimes interned apart")
    host_ms = {n: [] for n in names}
    launches = {n: [] for n in names}
    digests = {n: [] for n in names}
    prev = {n: (np.empty(0, np.int32), np.empty(0, np.int32))
            for n in names}
    for i in range(steps):
        got = {}
        for name in (names if i % 2 == 0 else names[::-1]):
            sph = engines[name]
            sph.clock.advance_ms(2)
            sync()
            sa.LAUNCHES.clear()

            def run(sph=sph, name=name):
                got[name] = _mesh_step(sph, stream[i], prev[name],
                                       failing).result()
            t = time.perf_counter()
            with no_host_sync(dev == "cuda"):
                if (seen is not None and i == 1
                        and meshes[name] is not None):
                    _capture_blocks(sa, run, seen, sph._state)
                else:
                    run()
            sync()
            host_ms[name].append((time.perf_counter() - t) * 1e3)
            launches[name].append(sa.LAUNCHES["scatter_add"])
            keep = got[name].allow
            prev[name] = (stream[i][0][keep], stream[i][2][keep])
            digests[name].append(_verdict_digest(got[name]))
            if meshes[name] is not None and dev == "cuda" \
                    and launches[name][-1] == 0:
                fail(f"phase 18 {route}: a meshed step launched no kernel")
        for name in names[1:]:
            if digests[name][-1] != digests[names[0]][-1]:
                fail(f"phase 18 {route}: {name}'s verdicts differ from "
                     f"{names[0]}'s at step {i}")
        one = [n for n in names if meshes[n] is None]
        for name in names:
            if one and meshes[name] is not None:
                diff = _mesh_state_diff(engines[name]._state,
                                        engines[one[0]]._state)
                if diff:
                    fail(f"phase 18 {route}: {name}'s state differs at step "
                         f"{i}: {diff[:6]}")
    res = {"route": route, "steps": steps, "B": B, "R": R,
           "host_ms": {n: summary(v) for n, v in host_ms.items()},
           "p99_ms": {n: float(np.percentile(v, 99))
                      for n, v in host_ms.items()},
           "launches_per_step": {n: sorted(set(v))
                                 for n, v in launches.items()},
           "launches": sum(sum(v) for v in launches.values()),
           "digests": digests[names[0]],
           "counters": {n: {k: v for k, v in
                            sph.obs.counters.snapshot().items()
                            if k.startswith("split_route.")}
                        for n, sph in engines.items()}}
    for name, sph in engines.items():
        c = res["counters"][name]
        want = steps if meshes[name] is not None else None
        if c.get("split_route.meshed") != want:
            fail(f"phase 18 {route}: {name} counted split_route.meshed "
                 f"{c.get('split_route.meshed')}, want {want}")
        if c.get("split_route.fused_exit") != steps:
            fail(f"phase 18 {route}: {name} routes {c}")
    # a fused call counts split_route.fused_exit alone: the route is the
    # runtime's host choice (origins and a key that does not fit: general)
    first = engines[names[0]]
    res["route_taken"] = ("scalar" if route == "scalar" else
                          "fast" if first._key_fits() else "general")
    if dev == "cuda" and res["route_taken"] != route:
        fail(f"phase 18 {route}: the runtime took the "
             f"{res['route_taken']} route")
    if profile_steps:
        res["device_ms_per_step"] = {}
        for name, sph in engines.items():
            last = [prev[name]]

            def run_steps(sph=sph, last=last):
                for j in range(profile_steps):
                    sph.clock.advance_ms(2)
                    v = _mesh_step(sph, stream[j], last[0],
                                   failing).result()
                    last[0] = (stream[j][0][v.allow], stream[j][2][v.allow])
            prof = _profile_steps(run_steps, profile_steps,
                                  f"meshed_{route}_{name}_trace.json",
                                  keep_trace=False)
            res["device_ms_per_step"][name] = prof["device_ms_per_step"]
    log(f"[meshed] {route}: {steps} fused steps of {B} at {R} rows on "
        + ", ".join(names) + ": verdicts equal every step"
        + (", state equal block by block" if len(names) > 1 else "")
        + "; host ms p50/p99 " + ", ".join(
            f"{n} {res['host_ms'][n]['median']:.2f}/{res['p99_ms'][n]:.2f}"
            for n in names)
        + "; launches a step " + ", ".join(
            f"{n} {res['launches_per_step'][n]}" for n in names)
        + ("; device ms a step " + ", ".join(
            f"{n} {v:.3f}" for n, v in res["device_ms_per_step"].items())
           if "device_ms_per_step" in res else ""))
    for sph in engines.values():
        sph.close()
    del engines
    if dev == "cuda":
        torch.cuda.empty_cache()
    return res


def _mesh_serving_drive(sph) -> dict:
    """(c), serving: ``DispatchPipeline`` at depth 2 (5 mixed batches that
    split), a short ``frontend()`` run, a telemetry tick → observations."""
    import asyncio
    from sentinel_tpu_torch.obs import counters as ck
    from sentinel_tpu_torch.serving import DispatchPipeline
    out = {}
    n = 4096 + 512
    rows = sph.intern_resources([f"r{i}" for i in range(64)])
    rng = np.random.default_rng(71)
    r = rows[rng.integers(0, 64, n)].astype(np.int32)
    oid = int(sph.origins.pin("app-a"))
    ra = sph.spec.alt_rows
    has = rng.random(n) < 0.1
    orow = np.where(has, _alt_rows_np(r, 0, np.full(n, oid), ra),
                    ra).astype(np.int32)
    prio = rng.random(n) < 0.01
    pipe = DispatchPipeline(sph, depth=2)
    t0 = sph.clock.now_ms()
    tickets = [pipe.submit_raw(
        r, np.where(has, oid, 0).astype(np.int32), orow,
        np.zeros(n, np.int32), np.full(n, ra, np.int32),
        np.ones(n, np.int32), np.ones(n, np.bool_), prio,
        at_ms=t0 + i * 250) for i in range(5)]
    out["pipeline"] = [_verdict_digest(t.result()) for t in tickets]

    async def fe_run():
        b = sph.frontend(batch_max=8, deadline_ms=60_000, idle_ms=60_000.0,
                         depth=2, record_flushes=True)
        stream = [(f"r{i % 64}", i % 5 == 0, "app-a" if i % 3 else "")
                  for i in range(48)]
        vs = await asyncio.gather(*(b.submit(x, prioritized=p, origin=o)
                                    for x, p, o in stream))
        await b.drain()
        b.close()
        return [(bool(v.allow), int(v.reason), int(v.wait_ms)) for v in vs]

    out["frontend"] = asyncio.run(asyncio.wait_for(fe_run(), 300))
    out["meshed_counters"] = [sph.obs.counters.get(ck.PIPE_MESHED),
                              sph.obs.counters.get(ck.ROUTE_MESHED)]
    sph.clock.advance_ms(100)
    sph.telemetry.poll()
    loads, hot = sph.telemetry.last_topk
    out["topk"] = [np.asarray(loads).tolist(), np.asarray(hot).tolist()]
    return out


def _mesh_tier_drive(stt, sph, tmp: str) -> dict:
    """(c), the rest: a snapshot saved and restored into the mesh's blocks
    and into one block, tiered churn with proactive demotions (the
    ticker's round-robin over blocks), the tune fingerprint →
    observations."""
    from sentinel_tpu_torch import convert
    from sentinel_tpu_torch.core import snapshot as snap
    from sentinel_tpu_torch.parallel import local_shard as ls
    from sentinel_tpu_torch.tune import artifact as tart
    out = {}
    # the snapshot first: a registry with eviction holes restores cold
    snap_path = os.path.join(tmp, f"meshed_{sph.device.type}.snap")
    snap.save_state(sph, snap_path)
    out["snapshot"] = {}
    for kind in ("mesh", "one"):
        where = ({"mesh": sph.mesh} if kind == "mesh"
                 else {"device": sph.mesh.home})
        twin = stt.Sentinel(config=sph.cfg, clock=stt.ManualClock(
            start_ms=sph.clock.now_ms()), **where)
        twin.load_flow_rules(sph.get_flow_rules())
        twin.load_degrade_rules(sph.get_degrade_rules())
        got = snap.load_state(twin, snap_path)
        after = twin.entry_batch([f"r{i % 64}" for i in range(512)],
                                 acquire=[1] * 512)
        out["snapshot"][kind] = [got, _verdict_digest(after)]
        twin.close()
    if out["snapshot"]["mesh"] != out["snapshot"]["one"] or \
            out["snapshot"]["mesh"][0] != "full":
        fail(f"phase 18 (c): snapshot restores {out['snapshot']}")
    rng = np.random.default_rng(73)
    # tiered churn, then a hot-row target below the residents: the
    # ticker demotes the coldest rows of each block in turn
    names = [f"c{i}" for i in range(3000)]
    churn, demoted_rows = [], []
    reg = sph.resources
    evict = reg.evict_name

    def recorded(name):             # the row each proactive demotion frees
        row = reg.lookup(name)
        ok = evict(name)
        if ok:
            demoted_rows.append(row)
        return ok

    reg.evict_name = recorded
    for i in range(6):
        pick = [names[j] for j in rng.integers(0, len(names), 1024)]
        churn.append(_verdict_digest(sph.entry_batch(
            pick, acquire=[1] * len(pick))))
        sph.clock.advance_ms(150)
        if i >= 3:
            sph.tiering.hot_rows = len(reg.items()) - 256
        sph.tiering.poll()
        sph.entry_batch(["r0"], acquire=[1])        # the drain demotes
    del reg.evict_name
    out["churn"] = churn
    out["demoted_rows"] = demoted_rows
    tier = sph.tiering.snapshot()
    out["tier"] = {k: tier[k] for k in ("demoted", "promoted", "hot_hit",
                                        "cold_miss")}
    out["demoted_blocks"] = sorted(set(ls.shard_of_rows(
        sph.spec.rows, sph.mesh, np.asarray(demoted_rows,
                                            np.int32)).tolist()))
    if len(out["demoted_blocks"]) < 2 or not tier["promoted"]:
        fail(f"phase 18 (c): demotions in blocks {out['demoted_blocks']}, "
             f"want them spread")
    out["fingerprint_mesh"] = tart.fingerprint(mesh=sph.mesh,
                                               spec=sph.spec)["mesh"]
    out["topology"] = ls.mesh_topology(sph.spec, sph.mesh,
                                       sph._mesh_shardings[0])
    out["state"] = convert.engine_to_numpy(sph)
    return out


def _mesh_rest(stt, sa, dev, R: int, blocks: int) -> dict:
    """(c): the serving and tiering drives on a meshed runtime on the card
    and on a CPU twin (``blocks`` blocks each; the Python tables, for the
    churn's proactive demotion): every observation and the state equal;
    the serving drive (the top-K included) also equal to a one-block
    runtime's on the card."""
    import tempfile
    from sentinel_tpu_torch import convert
    from sentinel_tpu_torch.parallel import local_shard as ls
    t0 = 1_800_000_000_000
    got = {}
    card = "cpu" if dev == "cpu" else "cuda:0"
    launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp, \
            _knobs(SENTINEL_TPU_NATIVE=0):
        for name, devs in (("card", [card] * blocks),
                           ("cpu", ["cpu"] * blocks)):
            sph = _mesh_runtime(stt, R, stt.ManualClock(start_ms=t0), None,
                                ls.local_mesh(devices=devs))
            sync()
            sa.LAUNCHES.clear()
            got[name] = _mesh_serving_drive(sph)
            got[name].update(_mesh_tier_drive(stt, sph, tmp))
            if name == "card":
                launches = sa.LAUNCHES["scatter_add"]
            sph.close()
        one = _mesh_runtime(stt, R, stt.ManualClock(start_ms=t0), card)
        sa.LAUNCHES.clear()
        got["one"] = _mesh_serving_drive(one)
        launches += sa.LAUNCHES["scatter_add"]
        one.close()
    a, b = got["card"], got["cpu"]
    for key in ("pipeline", "frontend", "topk"):
        if got["one"][key] != a[key]:
            fail(f"phase 18 (c): {key} differs from the one-block runtime")
    for key in a:
        if key == "state":
            bad = convert.leaf_diff(a[key], b[key])
            if bad:
                fail(f"phase 18 (c): card and CPU states differ: {bad[:6]}")
        elif a[key] != b[key]:
            fail(f"phase 18 (c): {key} differs card {a[key]!r:.200} "
                 f"CPU {b[key]!r:.200}")
    if a["meshed_counters"][0] <= 0 or a["meshed_counters"][1] <= 0:
        fail(f"phase 18 (c): meshed counters {a['meshed_counters']}")
    if a["fingerprint_mesh"] != {"n_devices": blocks, "axis": "rows",
                                 "sharded": True}:
        fail(f"phase 18 (c): fingerprint mesh {a['fingerprint_mesh']}")
    if launches == 0 and dev == "cuda":
        fail("phase 18 (c): the card drive launched no kernel")
    log(f"[meshed] (c) {R} rows, {blocks} blocks, card == CPU twin: "
        f"pipeline.meshed_dispatch / split_route.meshed "
        f"{a['meshed_counters']}, top-K {a['topk'][1][:4]}..., "
        f"tiering {a['tier']}, demotions over blocks "
        f"{a['demoted_blocks']}, "
        f"snapshot {a['snapshot']}, fingerprint {a['fingerprint_mesh']}")
    return {k: v for k, v in a.items() if k != "state"} | {
        "launches": launches}


def phase_meshed(stt, sa, dev="cuda", R=1 << 20, B=1 << 19, steps: int = 12,
                 timer=None, twin_rows: int = 1 << 14,
                 profile_steps: int = 3, blocks: int = MESH_BLOCKS) -> dict:
    """Phase 18 (``meshed``): ``Sentinel(mesh=local_mesh(devices=[card] *
    8))``, the row-split state as 8 row blocks on the card. (a) phase 8's
    runtime at full width (``R`` rows, 2^21 alt rows, fused decide+exit
    steps of ``B``) on the scalar route and on the general route (origins)
    against the one-block runtime in turns: verdicts and every state leaf
    equal at every step (block by block on the card), step p50/p99 host
    ms, launches a step, device ms a step (``torch.profiler``, 3 steps);
    (b) the kernel against its plain version at every block shape of (a),
    into phase 2's per-shape table; (c) at ``twin_rows``:
    ``DispatchPipeline``, ``frontend()``, a telemetry tick, tiered churn
    with demotions across blocks, a snapshot into 8 blocks and into one,
    the tune fingerprint — equal to a CPU twin; (d) with two cards or
    more, (a)'s scalar stream on 8 blocks spread over two cards against
    (a)'s digests (on one card it prints why not)."""
    from sentinel_tpu_torch.parallel import local_shard as ls
    t_phase = time.perf_counter()
    card = "cpu" if dev == "cpu" else "cuda:0"
    mesh = ls.local_mesh(devices=[card] * blocks)
    res = {"blocks": blocks}
    seen: dict = {}
    for route in ("scalar", "general"):
        res[route] = _mesh_run(stt, sa, dev, {"mesh": mesh, "one": None}, R,
                               B, steps, route, seen=seen,
                               profile_steps=profile_steps)
    res["block_cases"] = _mesh_block_cases(sa, timer, list(seen.values()))
    del seen
    res["rest"] = _mesh_rest(stt, sa, dev, twin_rows, blocks)
    cards = torch.cuda.device_count() if dev == "cuda" else 0
    if cards >= 2:
        half = blocks // 2
        two = ls.local_mesh(devices=["cuda:0"] * half
                            + ["cuda:1"] * (blocks - half))
        res["two_cards"] = _mesh_run(stt, sa, dev, {"two_cards": two}, R, B,
                                     steps, "scalar")
        if res["two_cards"]["digests"] != res["scalar"]["digests"]:
            fail("phase 18 (d): two cards' verdicts differ from one's")
    else:
        res["two_cards"] = {"ran": False, "why": (
            f"{cards} card: the blocks cannot spread over two cards")}
        log(f"[meshed] (d) not run: {res['two_cards']['why']}")
    res["launches"] = (res["scalar"]["launches"] + res["general"]["launches"]
                       + res["rest"]["launches"]
                       + res["two_cards"].get("launches", 0))
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[phase18] took {res['seconds']:.1f} s; kernel launches "
        f"{res['launches']}")
    return res


# ---------------------------------------------------------------------------
# Phase 19: the row-sharded runtime over processes (a "rows" mesh that
# spans ranks)
# ---------------------------------------------------------------------------

RMP_ARGV = [os.path.abspath(__file__), "--rows-mp"]
RMP_WORKER = ["-m", "sentinel_tpu_torch.multihost._rows_worker"]
RMP_BLOCKS = 4           # row blocks a rank: 2 x 4 against 1 x 8


class _sync_census:
    """PyTorch's sync debug mode at "warn" over the body on the card:
    every wait on the device is counted — inside a collective (a frame of
    ``multihost/bootstrap.py`` on its stack: gloo copies a card's tensor
    to the host) or anywhere else, with its site."""

    def __init__(self, on: bool):
        self.on = on
        self.collective = 0
        self.other = []

    def _show(self, message, *_args, **_kw):
        import traceback
        if "called a synchronizing" not in str(message):
            return      # the mode's own notice ("... a prototype feature")
        frames = traceback.extract_stack()
        if any(f.filename.endswith(os.path.join("multihost", "bootstrap.py"))
               for f in frames):
            self.collective += 1
            return
        ours = [f"{os.path.basename(f.filename)}:{f.lineno}" for f in frames
                if "sentinel_tpu_torch" in f.filename]
        self.other.append(f"{str(message)[:60]} at {ours[-3:]}")

    def __enter__(self):
        if self.on:
            import warnings
            self._cm = warnings.catch_warnings()
            self._cm.__enter__()
            warnings.simplefilter("always")
            warnings.showwarning = self._show
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        if self.on:
            torch.cuda.set_sync_debug_mode(0)
            self._cm.__exit__(*exc)


def _rmp_state_diff(mp, ref) -> tuple:
    """This rank's row-block state against a one-process engine's state
    on all the blocks → (differing leaves, digest of the replicated
    leaves): block ``i`` against the reference's block ``first + i``,
    each replicated leaf whole (``torch.equal`` on the card)."""
    import hashlib
    from sentinel_tpu_torch.parallel.row_blocks import RowBlocks
    bad = []
    h = hashlib.sha256()

    def walk(a, b, path):
        if a is None or b is None:
            if (a is None) != (b is None):
                bad.append(path)
            return
        if isinstance(a, RowBlocks):
            for i, blk in enumerate(a.blocks):
                part = b.blocks[a.first + i]
                if (blk.shape != part.shape or blk.dtype != part.dtype
                        or not torch.equal(blk, part.to(blk.device))):
                    bad.append(f"{path}[block {a.first + i}]")
            return
        if isinstance(a, torch.Tensor):
            if (a.shape != b.shape or a.dtype != b.dtype
                    or not torch.equal(a, b.to(a.device))):
                bad.append(path)
            h.update(path.encode())
            h.update(np.ascontiguousarray(a.detach().cpu().numpy())
                     .tobytes())
            return
        names = getattr(a, "_fields", None) or range(len(a))
        for name, x, y in zip(names, a, b):
            walk(x, y, f"{path}{name}.")

    walk(mp, ref, "")
    return bad, h.hexdigest()[:16]


def _rmp_route(stt, sa, mesh, engines: dict, spec: dict,
               route: str) -> dict:
    """One route of (a) on this rank: phase 18's runtime on the spanning
    mesh (``engines["mp"]``) and — with ``engines["ref"]`` — on one
    process's 8 blocks, the same stream in turns; verdict digests equal
    every step, this rank's blocks equal the reference's same rows after
    the route; per step the host ms, the collectives (calls, bytes, ms),
    the launches and the waits on the device; then the profiled steps,
    and the kernel against its plain version at this rank's block
    shapes."""
    B, steps = spec["B"], spec["steps"]
    prof = spec["profile_steps"]
    dev = str(mesh.local_device)
    on_card = dev.startswith("cuda")
    meshed0 = engines["mp"].obs.counters.get("split_route.meshed") or 0
    streams = {n: _mesh_stream(sph, B, steps + prof, route)
               for n, sph in engines.items()}
    stream, failing = streams["mp"]
    if "ref" in streams and not all(
            np.array_equal(a[0], b[0]) and np.array_equal(a[2], b[2])
            for a, b in zip(stream, streams["ref"][0])):
        fail(f"phase 19 {route}: the runtimes interned apart")
    names = list(engines)
    host_ms = {n: [] for n in names}
    launches = {n: [] for n in names}
    digests = {n: [] for n in names}
    coll = []
    waits = []
    prev = {n: (np.empty(0, np.int32), np.empty(0, np.int32))
            for n in names}
    seen: dict = {}
    for i in range(steps):
        got = {}
        for name in (names if i % 2 == 0 else names[::-1]):
            sph = engines[name]
            sph.clock.advance_ms(2)
            if on_card:
                sync()
            sa.LAUNCHES.clear()
            c0 = mesh.stats.snapshot()

            def run(sph=sph, name=name):
                got[name] = _mesh_step(sph, stream[i], prev[name],
                                       failing).result()
            t = time.perf_counter()
            with _sync_census(on_card and name == "mp") as census:
                if i == 1 and name == "mp" and spec["capture"]:
                    _capture_blocks(sa, run, seen, sph._state)
                else:
                    run()
            if on_card:
                sync()
            host_ms[name].append((time.perf_counter() - t) * 1e3)
            launches[name].append(sa.LAUNCHES["scatter_add"])
            if name == "mp":
                c1 = mesh.stats.snapshot()
                coll.append({k: c1[k] - c0[k] for k in c1})
                waits.append(census.collective)
                if census.other:
                    fail(f"phase 19 {route}: a multi-process step waited "
                         f"on the device outside its collectives: "
                         f"{census.other[:4]}")
                if on_card and launches[name][-1] == 0:
                    fail(f"phase 19 {route}: a step launched no kernel")
            keep = got[name].allow
            prev[name] = (stream[i][0][keep], stream[i][2][keep])
            digests[name].append(_verdict_digest(got[name]))
        if "ref" in digests and digests["mp"][-1] != digests["ref"][-1]:
            fail(f"phase 19 {route}: rank {mesh.process_index}'s verdicts "
                 f"differ from the one-process engine's at step {i}")
    res = {"route": route, "steps": steps, "B": B, "R": spec["R"],
           "digests": digests["mp"],
           "host_ms": summary(host_ms["mp"]),
           "p99_ms": float(np.percentile(host_ms["mp"], 99)),
           "launches_per_step": sorted(set(launches["mp"])),
           "launches": sum(sum(v) for v in launches.values()),
           "collectives_per_step": {k: float(np.mean([c[k] for c in coll]))
                                    for k in coll[0]},
           "waits_per_step": sorted(set(waits)),
           "split_route_meshed": (engines["mp"].obs.counters.get(
               "split_route.meshed") or 0) - meshed0}
    if "ref" in engines:
        res["ref_host_ms"] = summary(host_ms["ref"])
        res["ref_p99_ms"] = float(np.percentile(host_ms["ref"], 99))
        res["ref_launches_per_step"] = sorted(set(launches["ref"]))
        bad, res["replicated_digest"] = _rmp_state_diff(
            engines["mp"]._state, engines["ref"]._state)
        if bad:
            fail(f"phase 19 {route}: rank {mesh.process_index}'s state "
                 f"differs from the one-process engine's: {bad[:6]}")
    else:
        _bad, res["replicated_digest"] = _rmp_state_diff(
            engines["mp"]._state, engines["mp"]._state)
    first = engines["mp"]
    res["route_taken"] = ("scalar" if route == "scalar" else
                          "fast" if first._key_fits() else "general")
    if on_card and res["route_taken"] != route:
        fail(f"phase 19 {route}: the runtime took the "
             f"{res['route_taken']} route")
    if prof:
        def run_steps(name):
            sph, last = engines[name], prev[name]
            for j in range(steps, steps + prof):
                sph.clock.advance_ms(2)
                v = _mesh_step(sph, stream[j], last, failing).result()
                last = (stream[j][0][v.allow], stream[j][2][v.allow])
        res["device_ms_per_step"] = _profile_steps(
            lambda: run_steps("mp"), prof,
            f"rows_mp_{route}_{mesh.process_index}.json",
            keep_trace=False)["device_ms_per_step"]
        if "ref" in engines:
            # the same steps unprofiled: the next route starts both
            # runtimes from equal states
            run_steps("ref")
    if seen:
        res["block_cases"] = _mesh_block_cases(sa, None, list(seen.values()))
    return res


def _rmp_rank_main(spec_path: str) -> int:
    """``--rows-mp SPEC``: one rank of phase 19 (a) or (d) — the JSON at
    ``SPEC`` names the geometry, the routes, whether to run the
    one-process reference and the output path; the rank writes its
    results to ``<out>.<rank>.json``."""
    from sentinel_tpu_torch import multihost
    from sentinel_tpu_torch.multihost import mesh as mh_mesh
    from sentinel_tpu_torch.ops import scatter_add as sa
    from sentinel_tpu_torch.parallel import local_shard as ls
    import sentinel_tpu_torch as stt
    with open(spec_path) as fh:
        spec = json.load(fh)
    with multihost.initialize() as rt:
        mesh = mh_mesh.global_mesh(axis="rows")
        dev = str(mesh.local_device)
        meshes = {"mp": mesh}
        if spec["reference"]:
            meshes["ref"] = ls.local_mesh(devices=[dev] * mesh.size)
        # one pair of runtimes for both routes (the general route runs on
        # the state the scalar route left)
        engines = {n: _mesh_runtime(stt, spec["R"], stt.ManualClock(
            start_ms=1_800_000_000_000), None, m) for n, m in meshes.items()}
        out = {"rank": rt.process_index, "backend": rt.backend,
               "device": dev, "blocks": mh_mesh.local_shard_indices(mesh),
               "routes": {}}
        for route in spec["routes"]:
            out["routes"][route] = _rmp_route(stt, sa, mesh, engines, spec,
                                              route)
        for sph in engines.values():
            sph.close()
        with open(f"{spec['out']}.{rt.process_index}.json", "w") as fh:
            json.dump(out, fh)
        rt.barrier("rows-mp-done")
    return 0


def _rmp_launch(tmp: str, tag: str, spec: dict, dev: str, env: dict,
                timeout_s: float = 600.0) -> list:
    """(a)/(d): two ``--rows-mp`` ranks → their results in rank order."""
    spec = dict(spec, out=os.path.join(tmp, tag))
    path = os.path.join(tmp, f"{tag}.spec.json")
    with open(path, "w") as fh:
        json.dump(spec, fh)
    _res, wall = _mh_launch(RMP_ARGV + [path], 2, RMP_BLOCKS, dev, env,
                            timeout_s=timeout_s, phase=f"phase 19 {tag}")
    ranks = []
    for r in range(2):
        with open(f"{spec['out']}.{r}.json") as fh:
            ranks.append(json.load(fh))
    ranks[0]["wall_s"] = wall
    return ranks


def _rmp_check(tag: str, ranks: list, backend: str, devices: list,
               steps: int) -> None:
    got = [(r["backend"], r["device"]) for r in ranks]
    if got != [(backend, d) for d in devices]:
        fail(f"phase 19 {tag}: ranks ran on {got}, want {backend} on "
             f"{devices}")
    if [r["blocks"] for r in ranks] != [[0, 1, 2, 3], [4, 5, 6, 7]]:
        fail(f"phase 19 {tag}: blocks {[r['blocks'] for r in ranks]}")
    for route in ranks[0]["routes"]:
        a, b = (r["routes"][route] for r in ranks)
        if a["digests"] != b["digests"]:
            fail(f"phase 19 {tag} {route}: the ranks' verdicts differ")
        if a["replicated_digest"] != b["replicated_digest"]:
            fail(f"phase 19 {tag} {route}: the replicated leaves differ "
                 f"between the ranks")
        for r in (a, b):
            if r["split_route_meshed"] != steps:
                fail(f"phase 19 {tag} {route}: split_route.meshed "
                     f"{r['split_route_meshed']}, want {steps}")
            if r["collectives_per_step"]["calls"] <= 0:
                fail(f"phase 19 {tag} {route}: no collective a step")


def _rmp_twin(tmp: str, dev: str, env: dict, rows: int) -> dict:
    """(c): ``_rows_worker``'s stream at ``rows`` rows, 2 x 4 on the card
    and 2 x 4 on the CPU (both gloo), obs on, then the refused readers;
    against the same stream on one process's 8 blocks on the card:
    observations (the telemetry top-K among them) and the ranks' joined
    state equal, every refused reader raising the named error on every
    rank, in time, with no collective."""
    import importlib

    import sentinel_tpu_torch as stt
    from sentinel_tpu_torch import convert
    from sentinel_tpu_torch.parallel import local_shard as ls
    from sentinel_tpu_torch.parallel.row_blocks import RemoteRowsError
    rw = importlib.import_module("sentinel_tpu_torch.multihost._rows_worker")
    jobs = {"card": dev, "cpu": "cpu"}
    dirs = {k: os.path.join(tmp, f"twin_{k}") for k in jobs}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {k: pool.submit(
            _mh_launch, RMP_WORKER + ["--out", dirs[k], "--refusals",
                                      "--rows", str(rows)],
            2, RMP_BLOCKS, p, env, 600.0, "phase 19 (c)")
            for k, p in jobs.items()}
        # the one-process reference on the card meanwhile
        card = "cpu" if dev == "cpu" else "cuda:0"
        ref = rw.make_sentinel(stt, mesh=ls.local_mesh(devices=[card] * 8),
                               rows=rows)
        ref_states = {}
        sa_mod = importlib.import_module("sentinel_tpu_torch.ops.scatter_add")
        sa_mod.LAUNCHES.clear()
        ref_obs = rw.stream(stt, ref, lambda tag: ref_states.__setitem__(
            tag, convert.engine_to_numpy(ref)))
        ref_launches = sa_mod.LAUNCHES["scatter_add"]
        ref.close()
        done = {k: f.result() for k, f in futs.items()}
    out = {"rows": rows, "wall_s": {k: v[1] for k, v in done.items()}}
    lines = {}
    for k, (res, _wall) in done.items():
        got = sorted(_mh_lines(res, "ROWS_JSON:"), key=lambda d: d["rank"])
        if [d["rank"] for d in got] != [0, 1]:
            fail(f"phase 19 (c) {k}: {len(got)} rank line(s)")
        lines[k] = got
        for d in got:
            if d["observations"] != ref_obs:
                bad = [s for s in ref_obs
                       if d["observations"].get(s) != ref_obs[s]]
                fail(f"phase 19 (c) {k} rank {d['rank']}: stages {bad} "
                     f"differ from one process's 8 blocks")
            for name, (kind, msg) in ((n, d["refusals"][n])
                                      for n, _c in rw.REFUSED):
                if kind != RemoteRowsError.__name__ or "C19" not in msg:
                    fail(f"phase 19 (c) {k}: {name} gave {kind}: {msg}")
            if d["collectives_after_refusals"] != d["collectives"] or \
                    d["refusal_s"] > 5.0:
                fail(f"phase 19 (c) {k}: the refusals took "
                     f"{d['refusal_s']:.2f} s or ran a collective")
        for tag in rw.CHECKPOINTS:
            dumps = [(dict(np.load(os.path.join(dirs[k],
                                                f"{tag}.{r}.npz"))),
                      got[r]["offsets"]) for r in range(2)]
            merged, unequal = convert.merge_rank_states(dumps)
            bad = convert.leaf_diff(ref_states[tag], merged)
            if bad or unequal:
                fail(f"phase 19 (c) {k} at {tag}: leaves {bad[:6]} "
                     f"differ, replicated leaves {unequal[:6]} unequal")
    card_lines = lines["card"]
    out["launches"] = sum(d["launches"] for d in card_lines)
    if dev == "cuda" and not out["launches"]:
        fail("phase 19 (c): the card ranks launched no kernel")
    if any(d["launches"] for d in lines["cpu"]):
        fail("phase 19 (c): the CPU ranks launched the kernel")
    out["ref_launches"] = ref_launches
    out["topk"] = ref_obs["topk"][1][:8]
    out["collectives"] = [d["collectives"] for d in card_lines]
    out["refusal_s"] = max(d["refusal_s"] for d in card_lines)
    log(f"[meshed_mp] (c) {rows} rows, 2 x 4 on the card == 2 x 4 on the "
        f"CPU == 1 x 8 on the card: every stage's observations (top-K "
        f"rows {out['topk']}...) and state; the collectives "
        + ", ".join(f"rank {d['rank']} {d['collectives']['calls']} calls "
                    f"{d['collectives']['ms']:.0f} ms"
                    for d in card_lines)
        + f"; {len(rw.REFUSED)} readers refused on every rank with "
        f"RemoteRowsError in <= {out['refusal_s'] * 1e3:.2f} ms")
    return out


def phase_meshed_mp(stt, sa, dev="cuda", R=1 << 20, B=1 << 19,
                    steps: int = 8, profile_steps: int = 3,
                    twin_rows: int = 1 << 14) -> dict:
    """Phase 19 (``meshed_mp``): ``Sentinel(mesh=global_mesh(axis="rows"))``
    over two processes of 4 row blocks each, both on ``cuda:0`` (gloo),
    through the port's own launcher. (a) phase 18's runtime at full width
    (``R`` rows, 2^21 alt rows, fused steps of ``B``), ``steps`` steps on
    the scalar route and on the general route, against the one-process
    engine on 8 blocks in each rank, in turns: verdict digests equal
    every step, each rank's blocks equal the reference's same rows, the
    replicated leaves equal on both ranks; per rank the step p50/p99,
    collectives, bytes and ms a step, launches a step, waits on the
    device (inside collectives only), device ms a step (``torch.profiler``,
    ``profile_steps`` steps); (b) the kernel against its plain version at
    every launch shape of each rank's second block (the shapes of phase
    18's table, timed there, so not timed again); (c) ``_rows_worker``'s stream at ``twin_rows`` rows
    against a CPU twin and one process's 8 blocks, then the refused
    readers; (d) with two cards or more, (a)'s scalar stream with a card
    a rank on NCCL (on one card it prints why not)."""
    import tempfile
    from sentinel_tpu_torch.core.compile_cache import cache_dir
    t_phase = time.perf_counter()
    built = sorted(os.listdir(cache_dir()))
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    env = {"SENTINEL_COMPILE_CACHE": cache_dir()}
    one_card = dict(env, CUDA_VISIBLE_DEVICES=first)
    card = "cpu" if dev == "cpu" else "cuda:0"
    spec = {"R": R, "B": B, "steps": steps, "profile_steps": profile_steps,
            "routes": ["scalar", "general"], "reference": True,
            "capture": True}
    res = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rmp_") as tmp:
        ranks = _rmp_launch(tmp, "a", spec, dev, one_card)
        _rmp_check("(a)", ranks, "gloo", [card, card], steps)
        res["wall_s"] = {"a": ranks[0].pop("wall_s")}
        res["a"] = {route: [r["routes"][route] for r in ranks]
                    for route in spec["routes"]}
        for route, per in res["a"].items():
            log(f"[meshed_mp] (a) {route}: {steps} fused steps of {B} at "
                f"{R} rows, 2 x 4 (gloo, one card) == 1 x 8 in each rank: "
                f"verdicts every step, each rank's blocks and the "
                f"replicated leaves after the route; " + "; ".join(
                    f"rank {k}: host ms p50/p99 "
                    f"{p['host_ms']['median']:.2f}/{p['p99_ms']:.2f} "
                    f"(1 x 8 {p['ref_host_ms']['median']:.2f}/"
                    f"{p['ref_p99_ms']:.2f}), collectives a step "
                    f"{p['collectives_per_step']['calls']:.0f} calls "
                    f"{p['collectives_per_step']['bytes'] / 2**20:.1f} MiB "
                    f"{p['collectives_per_step']['ms']:.2f} ms, waits "
                    f"{p['waits_per_step']}, launches a step "
                    f"{p['launches_per_step']} (1 x 8 "
                    f"{p['ref_launches_per_step']}), device ms a step "
                    f"{p.get('device_ms_per_step', float('nan')):.3f}"
                    for k, p in enumerate(per)))
        res["block_cases"] = [dict(c, rank=k) for route in spec["routes"]
                              for k, p in enumerate(res["a"][route])
                              for c in p.get("block_cases", [])]
        if dev == "cuda" and not res["block_cases"]:
            fail("phase 19 (b): no block shape captured")
        log(f"[meshed_mp] (b) {len(res['block_cases'])} launch shapes of "
            f"the ranks' blocks (each rank's second block, "
            f"2^{(R // 8).bit_length() - 1} rows: phase 18's block "
            f"shapes, timed there, so not timed again), kernel == plain")
        t = time.perf_counter()
        res["c"] = _rmp_twin(tmp, dev, one_card, twin_rows)
        res["wall_s"]["c"] = time.perf_counter() - t
        cards = torch.cuda.device_count() if dev == "cuda" else 0
        if cards >= 2:
            nccl = _rmp_launch(tmp, "d", dict(
                spec, routes=["scalar"], reference=False, capture=False,
                profile_steps=0), dev, env)
            _rmp_check("(d)", nccl, "nccl", ["cuda:0", "cuda:1"], steps)
            if nccl[0]["routes"]["scalar"]["digests"] != \
                    res["a"]["scalar"][0]["digests"]:
                fail("phase 19 (d): NCCL's verdicts differ from gloo's")
            res["nccl"] = {"launches": sum(
                r["routes"]["scalar"]["launches"] for r in nccl),
                "per_rank": [r["routes"]["scalar"] for r in nccl]}
        else:
            res["nccl"] = {"ran": False, "why": (
                f"{cards} card: NCCL refuses two ranks on one GPU, so a "
                f"rank a card needs two cards")}
            log(f"[meshed_mp] (d) not run: {res['nccl']['why']}")
    if sorted(os.listdir(cache_dir())) != built:
        fail("phase 19: a child process compiled: the build directory "
             "changed")
    res["launches"] = (sum(p["launches"] for per in res["a"].values()
                           for p in per)
                       + res["c"]["launches"] + res["c"]["ref_launches"]
                       + res["nccl"].get("launches", 0))
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[phase19] took {res['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in res["wall_s"].items())
        + f"); kernel launches {res['launches']}")
    return res


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
    with _knobs(SENTINEL_TPU_NATIVE=0):
        phase_serving(stt, sa, turns=2, per_turn=3, requests=1 << 12,
                      duration_ms=300, runs=(("steady", 20_000),),
                      batch_maxes=(256,), tel_ticks=3)
        phase_tiering(stt, sa, batches=8, requests=1 << 16,
                      serve_hot=1 << 13, fused_steps=12, turns=2,
                      per_turn=2, ctl_turns=2)
    # (fewer steps never reach ns0's 30,000/s limit, fewer calls see no
    # ParamFlowException: the phase requires both)
    phase_cluster(stt, sa, steps=6, big_steps=2, singles=64, batches=2,
                  calls=1024, rt_batch=1 << 12)
    # phase 12's steps are phase 8's fused scalar steps, and its HTTP
    # polls run beside them under "error" in the plain pass already;
    # phase 18's meshed steps, both routes, without the timed legs
    from sentinel_tpu_torch.parallel import local_shard
    mesh = local_shard.local_mesh(devices=["cuda:0"] * MESH_BLOCKS)
    for route in ("scalar", "general"):
        _mesh_run(stt, sa, "cuda", {"mesh": mesh}, 1 << 20, 1 << 19, 3,
                  route)
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
    if sys.argv[1:2] == ["--cp-twin"]:
        return _cp_twin_main(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--gw-twin"]:
        return _gw_twin_main(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--db-twin"]:
        return _db_twin_main(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--dashboard"]:
        return _db_dash_main(sys.argv[2])
    if sys.argv[1:2] == ["--cc-child"]:
        return _cc_child_main(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--demo"]:
        return _demo_child_main(sys.argv[2], sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--mh-fleet"]:
        return _mh_fleet_main(sys.argv[2])
    if sys.argv[1:2] == ["--rows-mp"]:
        return _rmp_rank_main(sys.argv[2])
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
    # phases 9 and 10 keep the Python interning tables (their records
    # stay comparable; phase 9's twins compare the pipeline's in-flight
    # counts, and the C++ intern, which runs without the GIL, moves the
    # dispatch threads' interleaving): phase 13 drives the C++ tables
    with _knobs(SENTINEL_TPU_NATIVE=0):
        report["serving"] = phase_serving(stt, sa, timer=timer,
                                          profile=profile)
        # (d) cut in depth for phase 19's room: 2 controller turns, off
        # and on (were 4)
        report["tiering"] = phase_tiering(stt, sa, timer=timer,
                                          profile=profile, ctl_turns=2)
    # phases 11 (a), 13, 14, 15 (d) and 17 (b) cut in depth to leave the
    # script's time limit room for phase 18: 16 steps (were 40), 2 timing
    # turns (were 4), 2 turns of 10 s at the dashboard's cadence (were 4),
    # 5 s of 8 gRPC clients (were 10), 20 steps (were 40); then for phase
    # 19's room: 11 (a) 10 steps and 4 at 2^18 (were 16 and 8), 12's
    # 2048 api calls, 1024 WSGI requests, 512 cluster calls, 8 fused steps
    # and 2 timing turns (were 4096, 2048, 1024, 16 and 4; every outcome
    # it requires still occurs), 13's 1024 requests and 256 timed ones
    # (were 2048 — 4096 before phase 16 — and 512; its requests still
    # pass, block and wait), 15 (d) 3 s (were 5) and (e) 1024 RLS requests
    # (were 4096)
    report["cluster"] = phase_cluster(stt, sa, steps=10, big_steps=4,
                                      profile=profile)
    report["command_plane"] = phase_command_plane(
        stt, sa, calls=2048, wsgi_calls=1024, cluster_calls=512, steps=8,
        turns=2)
    report["gateway"] = phase_gateway(stt, sa, requests=1024, turns=2,
                                      timing_requests=256)
    report["dashboard"] = phase_dashboard(stt, sa, turns=2)
    report["tune_snapshot_grpc"] = phase_tune_snapshot_grpc(
        stt, sa, grpc_s=3.0, rls_requests=1024)
    report["analysis_demos"] = phase_analysis_demos(stt, sa)
    report["multihost"] = phase_multihost(stt, sa, timer=timer, steps=20)
    report["meshed"] = phase_meshed(stt, sa, timer=timer, profile_steps=3)
    report["meshed_mp"] = phase_meshed_mp(stt, sa)
    report["seconds"] = time.perf_counter() - t_all

    decide = report["kernel_cases"][0]
    # the main path's launches: each path's run, counted from 0
    launches = sum(report[p]["launches"] for p in (
        "engine", "prio", "prio_mixed", "general", "general_occupy", "fast",
        "scalar_param", "general_param", "runtime", "fast_path",
        "param_runtime", "obs_runtime", "serving", "tiering", "cluster",
        "command_plane", "gateway", "dashboard", "tune_snapshot_grpc",
        "analysis_demos", "multihost", "meshed", "meshed_mp"))
    kernels = [{
        "name": "scatter_add", "route": "cuda",
        "source": "sentinel_tpu_torch/csrc/scatter_add.cu",
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in
                           report["kernel_cases"]
                           + report["multihost"]["block_cases"]
                           + report["meshed"]["block_cases"]
                           + report["meshed_mp"]["block_cases"]),
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
