"""Port parity: the row-sharded engine, ``Sentinel(mesh=...)`` over N row
blocks (``sentinel_tpu_torch.parallel.local_shard``), against
``sentinel_tpu``'s row-sharded engine on its 8-device CPU mesh and the
port's one-block engine.

Twins of the 7 tests of ``tests/test_sharded_local.py``: the state
actually split, verdict parity with rotation and origins, counter parity,
a rule reload and a geometry change, the thread gauges, the validation
errors and a breaker opening. Each runs four engines under twin
ManualClocks — the JAX engine on ``local_mesh(8)`` (the conftest's 8
virtual CPU devices) and on one device, the port on 8 row blocks on
``cpu`` and the port's one-block engine — and requires their
observations, verdicts and every state leaf to be equal, bit for bit; the
JAX and the port's meshed engine must also agree on every ``obs``
counter, span and histogram.

The range the JAX meshed engine holds (ROADMAP C18): on the virtual CPU
mesh it drifts from its own one-device engine on rows at block edges
(rows 8, 16, ... here) once a decide step carries 512 lanes or a fused
decide+exit step 64 (a shard's first row loses its record, or takes the
ENTRY row's); every entry-tier scenario of the reference stays inside
that range. Tests that drive larger batches hold both port engines to
the JAX one-device engine — verdicts, observations and state — and the
port's meshed engine to its one-block engine. Beyond the
reference's tests: the fused decide+exit on the scalar, fast and general
routes and the split route; the host fast path's leases on row blocks;
param rules and a device slot on row blocks; every row-split write fed
rows of other blocks, pads and negative rows, against the whole-table
write; the carry-over of a JAX engine's sharded state into blocks.

No f32 sum crosses rows here: every row-split write is per row (the
ENTRY row's RT sum is reduced over lanes before it lands, as on one
block), so nothing needs a stated range.
"""

import dataclasses

import numpy as np
import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.parallel import local_shard as jls
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.engine import pipeline as tpipe
from sentinel_tpu_torch.multihost.bootstrap import ShardDevice
from sentinel_tpu_torch.multihost.mesh import GlobalMesh
from sentinel_tpu_torch.parallel import local_shard as tls
from sentinel_tpu_torch.parallel.row_blocks import RowBlocks
from sentinel_tpu_torch.rules import flow as tflow
from sentinel_tpu_torch.stats import window as twin_mod

from test_torch_obs import obs_view

torch.set_num_threads(2)

T0 = 1_785_000_000_000
N_DEV = 8
PKGS = {"jax": stpu, "jax1": stpu, "mesh": stt, "one": stt}
CFG = dict(max_resources=64, max_flow_rules=16, max_degrade_rules=16,
           max_authority_rules=16, host_fast_path=False)


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("SENTINEL_TIERING_DISABLE", "1")


def port_mesh(n=N_DEV):
    """N row blocks on the CPU."""
    return tls.local_mesh(devices=[torch.device("cpu")] * n)


def make(kind, **over):
    """One engine of :func:`trio`: ``jax`` (8-device mesh), ``jax1`` (one
    device), ``mesh`` (the port on 8 row blocks) or ``one`` (the port's
    one-block engine)."""
    pkg = PKGS[kind]
    clk = pkg.ManualClock(start_ms=T0)
    cfg = pkg.load_config(**{**CFG, **over})
    if kind == "jax":
        s = stpu.Sentinel(cfg, clock=clk, mesh=jls.local_mesh(N_DEV))
    elif kind == "jax1":
        s = stpu.Sentinel(cfg, clock=clk)
    elif kind == "mesh":
        s = stt.Sentinel(cfg, clock=clk, mesh=port_mesh())
    else:
        s = stt.Sentinel(cfg, clock=clk, device="cpu")
    s._cpu.sample = lambda: (0.5, 0.25)
    return s


def state_of(s):
    return convert.engine_to_numpy(s)


def _strip_meshed(view):
    """An obs view without ``split_route.meshed`` and
    ``pipeline.meshed_dispatch`` (the counters only a meshed engine
    ticks)."""
    out = dict(view)
    out["counters"] = {k: v for k, v in view["counters"].items()
                       if k not in ("split_route.meshed",
                                    "pipeline.meshed_dispatch")}
    return out


def trio(scenario, jax_mesh=True, jax_mesh_state=True, **over):
    """Run ``scenario(pkg, sph) -> observations`` on the JAX engine on one
    device (``jax1``), the port's meshed and one-block engines and — with
    ``jax_mesh`` — the JAX engine on its 8-device mesh → the port's
    meshed engine. Observations and every state leaf must be equal across
    them (the JAX meshed engine's state only with ``jax_mesh_state``:
    C18); obs views (counters, spans, histograms) equal between the two
    meshed engines, and between the one-device engines and the meshed
    ones bar the two meshed counters."""
    kinds = (["jax"] if jax_mesh else []) + ["jax1", "mesh", "one"]
    got, views, states, engines = {}, {}, {}, {}
    for kind in kinds:
        s = make(kind, **over)
        got[kind] = scenario(PKGS[kind], s)
        views[kind] = obs_view(s)
        states[kind] = state_of(s)
        engines[kind] = s
    for kind in kinds:
        assert got[kind] == got["jax1"], kind
        if kind != "jax" or jax_mesh_state:
            assert convert.leaf_diff(states["jax1"], states[kind]) == [], \
                kind
    for key in views["jax1"]:
        if jax_mesh:
            assert views["mesh"][key] == views["jax"][key], key
        assert _strip_meshed(views["mesh"])[key] == views["one"][key], key
        assert views["one"][key] == views["jax1"][key], key
    for kind in kinds:
        if kind != "mesh":
            engines[kind].close()
    return engines["mesh"]


def _rules(pkg):
    rules = [pkg.FlowRule(resource=f"svc-{i}", count=5.0) for i in range(8)]
    deg = [pkg.DegradeRule(resource="svc-0", grade=pkg.GRADE_EXCEPTION_RATIO,
                           count=0.5, time_window=10, min_request_amount=4)]
    return rules, deg


def _load(pkg, s):
    rules, deg = _rules(pkg)
    s.load_flow_rules(rules)
    s.load_degrade_rules(deg)


def _drive(pkg, s, events, advance=0):
    out = []
    for res, origin in events:
        try:
            e = s.entry(res, origin=origin)
            e.exit()
            out.append(True)
        except pkg.BlockException:
            out.append(False)
    if advance:
        s.clock.advance_ms(advance)
    return out


def _row_leaves(tree, prefix=""):
    """Paths of the leaves of ``tree`` that are row blocks (port) or
    carry ``P("rows")`` (JAX placements)."""
    return {k for k, v in _flat(tree, prefix).items() if v}


def _flat(tree, prefix):
    out = {}
    if tree is None:
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields") \
            and not isinstance(tree, tls.Placement):
        for name in tree._fields:
            out.update(_flat(getattr(tree, name), prefix + name + "."))
        return out
    if isinstance(tree, tuple) and not isinstance(tree, tls.Placement):
        for i, item in enumerate(tree):
            out.update(_flat(item, f"{prefix}{i}."))
        return out
    if isinstance(tree, tls.Placement):
        out[prefix[:-1]] = tree.spec == (tls.MESH_AXIS,)
    elif isinstance(tree, RowBlocks):
        out[prefix[:-1]] = True
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = False
    else:       # a JAX NamedSharding
        out[prefix[:-1]] = tree.spec == jls.P(jls.MESH_AXIS)
    return out


# ---------------------------------------------------------------------------
# the reference's 7 tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("minute", [True, False])
def test_state_actually_sharded(minute):
    """Each row-split field is N blocks of R/N (or RA/N) rows, each in
    storage of its own on its block's device; the replicated fields are
    one tensor on the home device; the split is the JAX engine's field
    map, leaf for leaf."""
    sh = make("mesh", minute_enabled=minute)
    js = make("jax", minute_enabled=minute)
    st = sh._state
    R, RA = sh.spec.rows, sh.spec.alt_rows
    rows_split = {
        "second.counters": R, "second.stamps": R, "second.rt_sum": R,
        "second.min_rt": R, "alt_second.counters": RA,
        "alt_second.stamps": RA, "alt_second.rt_sum": RA,
        "alt_second.min_rt": RA, "threads": R, "alt_threads": RA,
        "flow_dyn.occupied_count": R, "flow_dyn.occupied_window": R}
    if st.rt_hist is not None:
        rows_split["rt_hist"] = R
    if minute:
        rows_split.update({f"minute.{f}": R for f in
                           ("counters", "stamps", "rt_sum", "min_rt")})
    flat = convert.to_numpy(st)
    leaves = {}
    for path in flat:
        node = st
        for part in path.split("."):
            node = (node[int(part)] if part.isdigit()
                    else getattr(node, part))
        leaves[path] = node
    ptrs = set()
    for path, leaf in leaves.items():
        if path in rows_split:
            assert isinstance(leaf, RowBlocks), path
            assert leaf.n == N_DEV and leaf.rows == rows_split[path], path
            for b, d in zip(leaf.blocks, sh.mesh.devices):
                assert b.shape[0] == rows_split[path] // N_DEV
                assert b.device == d
                assert b.untyped_storage().nbytes() == \
                    b.numel() * b.element_size(), path
                ptrs.add(b.untyped_storage().data_ptr())
        else:
            assert isinstance(leaf, torch.Tensor), path
            assert leaf.device == sh.mesh.home, path
    # every block owns its storage: none aliases another
    n_blocks = sum(1 for p in leaves if p in rows_split) * N_DEV
    assert len(ptrs) == n_blocks
    # the same field map as the JAX engine's shardings
    jsh = jls.state_shardings(js.spec, js.mesh, js._state)
    tsh = tls.state_shardings(sh.spec, sh.mesh, st)
    assert _row_leaves(jsh) == _row_leaves(tsh) == _row_leaves(st) \
        == set(rows_split)
    assert sh.mesh.shape[tls.MESH_AXIS] == N_DEV
    js.close()
    sh.close()


def test_verdict_parity_with_rotation_and_origins():
    """Verdicts equal event for event across window rotation, origins
    (alt rows) and IN/OUT traffic; then the whole state."""
    def scenario(pkg, s):
        _load(pkg, s)
        rng = np.random.default_rng(7)
        out = []
        for _step in range(6):
            events = [(f"svc-{int(i)}", ["", "up-a", "up-b"][int(o)] or None)
                      for i, o in zip(rng.integers(0, 8, 40),
                                      rng.integers(0, 3, 40))]
            out.append(_drive(pkg, s, events, advance=437))
        return out

    trio(scenario)


def test_counter_parity_after_traffic():
    def scenario(pkg, s):
        _load(pkg, s)
        events = [(f"svc-{i % 8}", "up-a" if i % 3 else None)
                  for i in range(64)]
        _drive(pkg, s, events)
        tot = [s.node_totals(r) for r in ("svc-0", "svc-3", "svc-7")]
        # origin drill-down rides the alt (hashed) table — also split
        return tot, s.origin_totals("svc-1"), [
            (n, r, t) for n, r, t in s.all_node_totals()]

    trio(scenario)


def test_sharding_survives_rule_reload_and_geometry_change():
    def scenario(pkg, s):
        s.load_flow_rules([pkg.FlowRule(resource="a", count=3.0)])
        out = [_drive(pkg, s, [("a", None)] * 4)]
        s.update_window_geometry(sample_count=4, interval_ms=1000)
        out.append(_drive(pkg, s, [("a", None)] * 4))
        got = _drive(pkg, s, [("a", None)] * 6, advance=1000)
        assert sum(got) <= 3          # rule still enforced post-reshard
        out.append(got)
        s.load_flow_rules([pkg.FlowRule(resource="a", count=2.0)])
        out.append(_drive(pkg, s, [("a", None)] * 4))
        return out

    sh = trio(scenario)
    st = sh._state
    for leaf, shape in ((st.second.counters, (8, 4, 8)),
                        (st.alt_second.stamps, (1024 // N_DEV, 4)),
                        (st.flow_dyn.occupied_count, (8, 5))):
        assert isinstance(leaf, RowBlocks) and leaf.n == N_DEV
        assert all(tuple(b.shape) == shape for b in leaf.blocks)
    sh.close()


def test_thread_gauge_parity_on_exit():
    # the gauges are elided without a reader rule: force them on
    def scenario(pkg, s):
        s.load_flow_rules([pkg.FlowRule(resource=f"svc-{i}", count=5.0)
                           for i in range(8)])
        entries = [s.entry("svc-2"), s.entry("svc-2"), s.entry("svc-61")]
        during = [s.node_totals("svc-2")["threads"],
                  s.node_totals("svc-61")["threads"]]
        assert during == [2, 1]
        for e in entries:
            e.exit()
        return during, [s.node_totals("svc-2")["threads"],
                        s.node_totals("svc-61")["threads"]]

    trio(scenario, thread_gauge_always=True)


def test_mesh_validation_errors():
    cfg = stt.load_config(**CFG)
    spec = make("one").spec
    # no "rows" axis: the reference's ValueError, as validate_mesh gives it
    bad_axis = GlobalMesh([ShardDevice(0, i, "cpu") for i in range(4)],
                          "wrong")
    with pytest.raises(ValueError, match="rows"):
        tls.validate_mesh(spec, bad_axis)
    with pytest.raises(ValueError, match="rows"):
        stt.Sentinel(cfg, clock=stt.ManualClock(start_ms=T0),
                     mesh=object())
    # 64 rows over 7 blocks: not divisible
    with pytest.raises(ValueError, match="divide"):
        stt.Sentinel(cfg, clock=stt.ManualClock(start_ms=T0),
                     mesh=port_mesh(7))
    # a "rows" mesh over two processes in a process without the process
    # group: a named RuntimeError, never a hang or a one-process fallback
    two = GlobalMesh([ShardDevice(p, 0, "cpu") for p in (0, 1)], "rows")
    with pytest.raises(RuntimeError, match="process group"):
        stt.Sentinel(cfg, clock=stt.ManualClock(start_ms=T0), mesh=two)
    # fewer devices visible than asked: the fix names repeated devices
    with pytest.raises(ValueError, match=r"devices=\[device\] \* 9"):
        tls.local_mesh(len(tls.visible_devices()) + 8)
    # the home device must be the one asked for
    with pytest.raises(ValueError, match="home device"):
        stt.Sentinel(cfg, clock=stt.ManualClock(start_ms=T0),
                     mesh=port_mesh(), device="meta")
    # a one-process GlobalMesh over "rows" is accepted as row blocks
    one_proc = GlobalMesh([ShardDevice(0, 0, "cpu")] * 4, "rows")
    s = stt.Sentinel(cfg, clock=stt.ManualClock(start_ms=T0),
                     mesh=one_proc)
    assert s.mesh == port_mesh(4)
    assert s._state.threads.n == 4
    s.close()


def test_sharded_degrade_breaker_opens_like_reference():
    """Breaker state is replicated; the arc CLOSED → OPEN must behave
    alike under the row-block step."""
    def scenario(pkg, s):
        _load(pkg, s)
        out = []
        for _ in range(8):
            try:
                e = s.entry("svc-0")
                e.trace(RuntimeError("boom"))
                e.exit()
                out.append(True)
            except pkg.BlockException:
                out.append(False)
        assert False in out           # the breaker opened
        return out

    trio(scenario)


# ---------------------------------------------------------------------------
# every route of the fused step, and the split
# ---------------------------------------------------------------------------

def _raw_cols(s, n, route, seed=5):
    """Columns for ``decide_and_exit_raw_nowait`` (drawn inside, so the
    three engines get the same batch)."""
    rng = np.random.default_rng(seed)
    names = [f"svc-{i}" for i in range(8)] + ["wide-a", "wide-b"]
    rows_of = np.asarray([s.resources.get_or_create(x) for x in names],
                         np.int32)
    rows = rows_of[rng.integers(0, len(names), n)]
    ra = s.spec.alt_rows
    oid = int(s.origins.pin("up-a"))
    if route == "scalar":
        oids = np.zeros(n, np.int32)
        orow = np.full(n, ra, np.int32)
    else:
        has = rng.random(n) < 0.3
        oids = np.where(has, oid, 0).astype(np.int32)
        alt = np.asarray([s._alt_row(int(r), 0, oid) for r in rows],
                         np.int32)
        orow = np.where(has, alt, ra).astype(np.int32)
    acq = (rng.integers(1, 3, n) if route == "general"
           else np.ones(n)).astype(np.int32)
    prio = rng.random(n) < (0.02 if route != "scalar" else 0.0)
    return dict(rows=rows, oids=oids, orow=orow,
                ctx=np.zeros(n, np.int32), chain=np.full(n, ra, np.int32),
                acq=acq, is_in=rng.random(n) < 0.8, prio=prio,
                rt=rng.integers(0, 40, n).astype(np.int32),
                err=rng.random(n) < 0.1)


def _verd(v):
    return (np.asarray(v.allow).tolist(), np.asarray(v.reason).tolist(),
            np.asarray(v.wait_ms).tolist())


@pytest.mark.parametrize("route,lanes", [
    ("scalar", 32), ("fast", 32), ("general", 32),
    ("scalar", 512), ("fast", 512), ("general", 512)])
def test_fused_decide_exit_every_route(route, lanes):
    """The fused decide+exit on each route, window rotation included;
    with a prioritized lane the fast and general routes run their
    occupy-aware steps (bookings land in the row-block ring). At 32 lanes
    the JAX meshed engine is held too; at 512 it is outside its range
    (C18) and the port is held to the JAX one-device engine."""
    def scenario(pkg, s):
        _load(pkg, s)
        s.load_flow_rules([pkg.FlowRule(resource=f"svc-{i}", count=20.0)
                           for i in range(8)]
                          + [pkg.FlowRule(resource="wide-a", count=50.0,
                                          limit_app="up-a")])
        out = []
        for i in range(5):
            c = _raw_cols(s, lanes, route, seed=i)
            h = s.decide_and_exit_raw_nowait(
                c["rows"], c["oids"], c["orow"], c["ctx"], c["chain"],
                c["acq"], c["is_in"], c["prio"], exit_rows=c["rows"],
                exit_origin_rows=c["orow"], exit_chain_rows=c["chain"],
                exit_acquire=c["acq"], exit_rt_ms=c["rt"],
                exit_error=c["err"], exit_is_in=c["is_in"],
                at_ms=T0 + i * 300)
            out.append(_verd(h.result()))
        return out

    trio(scenario, jax_mesh=lanes < 64)


def test_split_route_on_row_blocks():
    def scenario(pkg, s):
        _load(pkg, s)
        out = []
        for i in range(3):
            c = _raw_cols(s, 4096 + 1024, "fast", seed=20 + i)
            c["oids"][:4200] = 0
            c["orow"][:4200] = s.spec.alt_rows
            c["prio"][:4200] = False
            h = s.decide_raw_nowait(c["rows"], c["oids"], c["orow"],
                                    c["ctx"], c["chain"], c["acq"],
                                    c["is_in"], c["prio"],
                                    at_ms=T0 + i * 250)
            out.append(_verd(h.result()))
        return out

    sh = trio(scenario, jax_mesh=False)      # 5120 lanes (C18)
    assert sh.routes["split"] == 3
    sh.close()


# ---------------------------------------------------------------------------
# the host fast path, param rules and a device slot on row blocks
# ---------------------------------------------------------------------------

def test_host_fast_path_leases_on_row_blocks():
    """The default config's host fast path: FREE rows and LEASED rows
    (one simple QPS rule) on a meshed engine — lease pre-charges, the
    flushed batches and the expired leases' uncount all write through the
    owners."""
    def scenario(pkg, s):
        s.load_flow_rules([pkg.FlowRule(resource="leased", count=40.0)])
        out = []
        for step in range(4):
            for name in ("leased", "free-a", "svc-60", "leased"):
                for _ in range(7):
                    try:
                        with s.entry(name):
                            out.append(1)
                    except pkg.BlockException:
                        out.append(0)
            s.clock.advance_ms(600)
        s._flush_fast()
        return out, [s.node_totals(n) for n in ("leased", "free-a")]

    trio(scenario, host_fast_path=True)


def test_param_rules_on_row_blocks():
    def scenario(pkg, s):
        s.load_flow_rules([pkg.FlowRule(resource="api", count=100.0)])
        s.load_param_flow_rules([pkg.ParamFlowRule(
            resource="api", param_idx=0, count=3.0)])
        out = []
        for i in range(20):
            try:
                with s.entry("api", args=(f"user-{i % 4}",)):
                    out.append(1)
            except pkg.BlockException as e:
                out.append(type(e).__name__)
        return out

    trio(scenario)


def _slot(pkg):
    """A device slot denying every event once 5 passes sit in its row's
    window (written per package: torch for the port, jnp for JAX)."""
    if pkg is stpu:
        import jax.numpy as jnp

        class Cap(stpu.DeviceSlot):
            name = "cap"

            def init_state(self, spec):
                return jnp.zeros((), jnp.int32)

            def check(self, state, view):
                ok = view.pass_counts < 5
                return state + jnp.sum(view.live, dtype=jnp.int32), ok
        return Cap()

    class Cap(stt.DeviceSlot):
        name = "cap"

        def init_state(self, spec):
            return torch.zeros((), dtype=torch.int32)

        def check(self, state, view):
            ok = view.pass_counts < 5
            return state + view.live.sum(dtype=torch.int32), ok
    return Cap()


def test_device_slot_on_row_blocks():
    """A device slot's registration re-derives the placements (its state
    is replicated) and its view reads the PASS window by owner."""
    def scenario(pkg, s):
        s.register_slot(_slot(pkg))
        out = []
        for i in range(9):
            try:
                with s.entry(f"svc-{i % 2}"):
                    out.append(1)
            except pkg.BlockException as e:
                out.append(type(e).__name__)
        return out

    sh = trio(scenario)
    assert isinstance(sh._state.custom[0], torch.Tensor)
    assert isinstance(sh._state.threads, RowBlocks)
    sh.close()


# ---------------------------------------------------------------------------
# non-owned lanes: every row-split write, block by block
# ---------------------------------------------------------------------------

R_T, B_T, E_T = 64, 2, 8


def _whole_and_blocks(seed, n=8):
    """A random window + gauges + ring + histogram, whole and as n row
    blocks of the same values."""
    rng = np.random.default_rng(seed)
    idx = 1000
    c = rng.integers(0, 5, (R_T, B_T, E_T)).astype(np.int32)
    st = np.asarray([idx, idx - 1, idx - 2, twin_mod.NEVER], np.int32)[
        rng.integers(0, 4, (R_T, B_T))]
    rt = rng.integers(0, 50, (R_T, B_T)).astype(np.float32)
    mn = rng.integers(0, 50, (R_T, B_T)).astype(np.int32)
    thr = rng.integers(0, 4, R_T).astype(np.int32)
    occ_c = rng.integers(0, 3, (R_T, B_T + 1)).astype(np.float32)
    occ_w = np.asarray([idx, idx + 1, idx - 1], np.int32)[
        rng.integers(0, 3, (R_T, B_T + 1))]
    hist = rng.integers(0, 9, (R_T, 32)).astype(np.int32)
    arrays = dict(c=c, st=st, rt=rt, mn=mn, thr=thr, occ_c=occ_c,
                  occ_w=occ_w, hist=hist)

    def build(split):
        t = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
        if split:
            t = {k: RowBlocks.split(v, [torch.device("cpu")] * n)
                 for k, v in t.items()}
        w = twin_mod.WindowState(t["c"], t["st"], t["rt"], t["mn"])
        return w, t
    return build(False), build(True), idx


def _dump(w, t):
    def np_of(x):
        return x.to_numpy() if isinstance(x, RowBlocks) else x.numpy()
    out = {f: np_of(getattr(w, f)) for f in w._fields}
    out.update({k: np_of(v) for k, v in t.items()})
    return out


def _hostile_rows(n_lanes, seed):
    """Rows of every block (so each block sees rows of EARLIER blocks),
    pads past R, and rows in [-R, 0) (which wrap once onto the table's
    end, as the whole table's scatter does)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(-R_T, R_T + 20, n_lanes).astype(np.int32)
    rows[:16] = np.arange(0, R_T, R_T // 16)     # one per block at least
    rows[16:20] = R_T                            # the pipeline's pad
    return torch.from_numpy(rows)


WRITES = {
    "refresh_rows": lambda sp, w, t, rows, idx, rng: twin_mod.refresh_rows(
        sp, w, rows, idx),
    "add_rows_multi": lambda sp, w, t, rows, idx, rng:
        twin_mod.add_rows_multi(
            sp, w, rows, torch.from_numpy(
                rng.integers(0, E_T, rows.shape[0]).astype(np.int32)),
            torch.from_numpy(rng.integers(-2, 5, rows.shape[0])
                             .astype(np.int32)), idx),
    "add_rows_vec_rt": lambda sp, w, t, rows, idx, rng:
        twin_mod.add_rows_vec(
            sp, w, rows, torch.from_numpy(
                rng.integers(0, 3, (rows.shape[0], E_T)).astype(np.int32)),
            idx, rt_ms=torch.from_numpy(rng.integers(
                0, 90, rows.shape[0]).astype(np.int32)),
            rt_valid=torch.from_numpy(rng.random(rows.shape[0]) < 0.7)),
    "add_rows": lambda sp, w, t, rows, idx, rng: twin_mod.add_rows(
        sp, w, rows, 3, torch.ones(rows.shape[0], dtype=torch.int32), idx,
        rt_ms=torch.full((rows.shape[0],), 7, dtype=torch.int32)),
    "uncount_rows": lambda sp, w, t, rows, idx, rng: twin_mod.uncount_rows(
        sp, w, rows, torch.from_numpy(
            (idx - rng.integers(0, 3, rows.shape[0])).astype(np.int32)),
        0, torch.ones(rows.shape[0], dtype=torch.int32)),
    "invalidate_rows": lambda sp, w, t, rows, idx, rng:
        twin_mod.invalidate_rows(sp, w, rows),
    "restore_rows": lambda sp, w, t, rows, idx, rng: twin_mod.restore_rows(
        sp, w, rows, twin_mod.WindowState(
            torch.full((rows.shape[0], B_T, E_T), 9, dtype=torch.int32),
            torch.arange(rows.shape[0], dtype=torch.int32)[:, None]
            .expand(-1, B_T).contiguous(),
            torch.full((rows.shape[0], B_T), 2.5),
            torch.full((rows.shape[0], B_T), 3, dtype=torch.int32))),
    "threads": lambda sp, w, t, rows, idx, rng: tpipe._add_threads(
        t["thr"], rows, torch.ones(rows.shape[0], dtype=torch.int32)),
    "rt_hist": lambda sp, w, t, rows, idx, rng: tpipe._scatter_rows(
        t["hist"], rows, torch.from_numpy(
            rng.integers(0, 32, rows.shape[0]).astype(np.int32)),
        torch.ones(rows.shape[0], dtype=torch.int32)),
    "clear_rows": lambda sp, w, t, rows, idx, rng: tpipe._clear_rows(
        rows, [(t["thr"], 0), (t["hist"], 0), (t["occ_c"], 0.0),
               (t["occ_w"], -(2 ** 30))]),
    "book_next_window": lambda sp, w, t, rows, idx, rng:
        tflow._book_next_window(
            tflow.FlowDynState(None, None, None, t["occ_c"], t["occ_w"]),
            torch.from_numpy(rng.random(rows.shape[0]) < 0.5),
            torch.clamp(rows, min=0), torch.ones(rows.shape[0],
                                                 dtype=torch.int32), idx),
    "settle_occupied": lambda sp, w, t, rows, idx, rng:
        twin_mod.settle_occupied(sp, w, t["occ_c"], t["occ_w"], idx, 0),
}


@pytest.mark.parametrize("write", sorted(WRITES))
def test_non_owned_lanes_never_reach_a_block(write):
    """Every row-split write on 8 blocks, fed rows of every block (each
    block sees rows of earlier blocks), pads past R and negative rows,
    leaves exactly what the whole-table write leaves: no lane lands in a
    block that does not own it. The blocks' write indices are never
    negative."""
    spec = twin_mod.WindowSpec(B_T, 500)
    (w1, t1), (wn, tn), idx = _whole_and_blocks(seed=len(write))
    rows = _hostile_rows(96, seed=3)
    for i in range(N_DEV):
        lr = tn["thr"].local_rows(rows, i)
        assert int(lr.min()) >= 0 and int(lr.max()) <= R_T // N_DEV
    out1 = WRITES[write](spec, w1, t1, rows, idx, np.random.default_rng(1))
    outn = WRITES[write](spec, wn, tn, rows, idx, np.random.default_rng(1))
    a, b = _dump(w1, t1), _dump(wn, tn)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{write}: {k}")
    if write == "settle_occupied":
        for x, y in zip(out1[1:], outn[1:]):
            np.testing.assert_array_equal(x.numpy(), y.to_numpy())


def test_per_lane_reads_gather_from_owners():
    """The reads of the main path on 8 blocks equal the whole table's, at
    in-range, clamped and negative rows."""
    spec = twin_mod.WindowSpec(B_T, 500)
    (w1, t1), (wn, tn), idx = _whole_and_blocks(seed=11)
    rows = torch.clamp(_hostile_rows(64, seed=5), max=R_T - 1)
    for fn in (lambda w: twin_mod.window_sum_rows(spec, w, rows, 0, idx),
               lambda w: twin_mod.prev_window_sum_rows(spec, w, rows, 1,
                                                       idx),
               lambda w: twin_mod.min_rt_rows(spec, w, rows, idx, 4900),
               lambda w: twin_mod.rolling_totals(spec, w, idx,
                                                 torch.remainder(rows, R_T).long()),
               lambda w: twin_mod.bucket_snapshot(spec, w, idx - 1,
                                                  torch.remainder(rows, R_T).long())[0],
               lambda w: twin_mod.extract_rows(spec, w, rows).counters):
        np.testing.assert_array_equal(fn(w1).numpy(), fn(wn).numpy())
    for key in ("thr", "hist", "occ_c"):
        np.testing.assert_array_equal(t1[key][rows.long()].numpy(),
                                      tn[key][rows.long()].numpy())
    # whole-table passes run block by block: row blocks of the results
    for fn in (lambda w: twin_mod.rolling_load(spec, w, idx),
               lambda w: twin_mod.window_sum_all(spec, w, 0, idx),
               lambda w: twin_mod.rt_totals(spec, w, idx),
               lambda w: twin_mod.rolling_totals(spec, w, idx)):
        got = fn(wn)
        assert isinstance(got, RowBlocks) and got.n == N_DEV
        np.testing.assert_array_equal(fn(w1).numpy(), got.to_numpy())
    with pytest.raises(TypeError, match="block by block"):
        tn["thr"][:]


# ---------------------------------------------------------------------------
# carrying a JAX engine's sharded state into row blocks
# ---------------------------------------------------------------------------

def test_state_blocks_convert_round_trip():
    """A JAX meshed engine's state → the port's 8 blocks → the same numpy
    dict; installed in a meshed port engine, both decide alike after."""
    js, sh = make("jax"), make("mesh")
    for pkg, s in ((stpu, js), (stt, sh)):
        _load(pkg, s)
        _drive(pkg, s, [(f"svc-{i % 8}", "up-a" if i % 2 else None)
                        for i in range(50)])
    d = convert.to_numpy(js._state)
    blocks = convert.state_blocks_from_numpy(d, sh.spec, sh.mesh)
    assert isinstance(blocks.second.counters, RowBlocks)
    assert blocks.second.counters.n == N_DEV
    assert convert.leaf_diff(d, convert.state_blocks_to_numpy(blocks)) == []
    with sh._lock:
        sh._state = blocks
    for pkg, s in ((stpu, js), (stt, sh)):
        s.clock.advance_ms(300)
    ev = [(f"svc-{i % 8}", None) for i in range(30)]
    assert _drive(stpu, js, ev) == _drive(stt, sh, ev)
    assert convert.leaf_diff(convert.to_numpy(js._state),
                             convert.to_numpy(sh._state)) == []
    js.close()
    sh.close()


def test_placement_helpers_match_reference_geometry():
    """``shard_of_rows`` and ``topk_layout`` give the reference's answers
    for the same geometry."""
    sh, js = make("mesh"), make("jax")
    rows = np.arange(0, 64, 3, dtype=np.int32)
    np.testing.assert_array_equal(
        tls.shard_of_rows(64, sh.mesh, rows),
        jls.shard_of_rows(64, js.mesh, rows))
    np.testing.assert_array_equal(tls.shard_of_rows(64, None, rows),
                                  jls.shard_of_rows(64, None, rows))
    assert tls.topk_layout(sh.spec, sh.mesh) == \
        jls.topk_layout(js.spec, js.mesh) == (8, 8)
    assert tls.topk_layout(sh.spec, None) == jls.topk_layout(js.spec, None)
    assert dataclasses.asdict(sh.spec.second) == \
        dataclasses.asdict(js.spec.second)
    sh.close()
    js.close()
