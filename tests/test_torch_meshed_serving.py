"""Port parity: the row-sharded engine as the serving hot path, against
``sentinel_tpu``'s on its 8-device CPU mesh.

Twins of the 9 tests of ``tests/test_meshed_serving.py``: the layout
helpers (batch placement and its divisibility rule, ``local_mesh``'s
error, the topology block) against the reference's for the same geometry,
then the serving tiers on four engines under twin ManualClocks (the
harness of ``test_torch_sharded_local.py``) — the depth-2
``DispatchPipeline`` with the mesh-attribution counters
(``split_route.meshed``, ``pipeline.meshed_dispatch``), the fused
decide+exit, the split decision, occupy bookings carried across a rule
reload, and the ``AdaptiveBatcher`` fan-out.

These scenarios send 2048 to 8192 lanes a step, past the range the JAX
meshed engine holds against its own one-device engine (ROADMAP C18): the
JAX meshed engine's verdicts and counters are held here (the reference's
own tests hold only those), its state is not; every state leaf of both
port engines is held to the JAX one-device engine.
"""

import asyncio
import importlib

import numpy as np
import pytest
import torch

import sentinel_tpu as stpu
from sentinel_tpu.parallel import local_shard as jls
from sentinel_tpu_torch.obs import counters as ck
from sentinel_tpu_torch.parallel import local_shard as tls

from test_torch_sharded_local import N_DEV, PKGS, make, port_mesh, trio

torch.set_num_threads(2)

T0 = 1_785_000_000_000
CFG = dict(max_resources=64, max_origins=32, max_flow_rules=32,
           max_degrade_rules=16, max_authority_rules=16,
           host_fast_path=False)


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("SENTINEL_TIERING_DISABLE", "1")


def _rules(pkg, api_count=3.0):
    return [pkg.FlowRule(resource="api", count=api_count),
            pkg.FlowRule(resource="api", count=2.0, limit_app="app-a"),
            pkg.FlowRule(resource="bulk", count=1e6)]


def _raw_columns(s, n=8192, prio_frac=0.01, seed=29):
    """The reference's mixed raw batch above the 4096 split threshold
    (drawn inside, so every engine gets the same one)."""
    rng = np.random.default_rng(seed)
    row_api = s.resources.get_or_create("api")
    row_bulk = s.resources.get_or_create("bulk")
    oid = s.origins.pin("app-a")
    pad_a = s.spec.alt_rows
    rows = np.where(rng.random(n) < 0.5, row_api, row_bulk).astype(np.int32)
    has_o = rng.random(n) < 0.1
    alt = {r: s._alt_row(r, 0, int(oid)) for r in (row_api, row_bulk)}
    return dict(
        rows=rows,
        oids=np.where(has_o, oid, 0).astype(np.int32),
        orow=np.where(has_o, np.where(rows == row_api, alt[row_api],
                                      alt[row_bulk]),
                      pad_a).astype(np.int32),
        ctx0=np.zeros(n, np.int32),
        chain=np.full(n, pad_a, np.int32),
        ones=np.ones(n, np.int32),
        is_in=np.ones(n, np.bool_),
        prio=rng.random(n) < prio_frac,
        rt=np.full(n, 5, np.int32),
        err=np.zeros(n, np.bool_))


def _v(v):
    return (np.asarray(v.allow).tolist(), np.asarray(v.reason).tolist(),
            np.asarray(v.wait_ms).tolist())


def _args(c):
    return (c["rows"], c["oids"], c["orow"], c["ctx0"], c["chain"],
            c["ones"], c["is_in"], c["prio"])


def _spec_name(placement):
    """A placement's partition spec in one vocabulary: ``"rows"`` or
    ``"replicated"`` (a JAX ``NamedSharding`` or a port ``Placement``)."""
    spec = placement.spec
    if isinstance(placement, tls.Placement):
        return "rows" if spec == (tls.MESH_AXIS,) else "replicated"
    return "rows" if spec == jls.P(jls.MESH_AXIS) else "replicated"


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------

def test_batch_sharding_divisibility_rule():
    tm, jm = port_mesh(), jls.local_mesh(N_DEV)
    for shape in ((8192,), (8191,), (8192, 3), (8, 2), (7,)):
        x = np.zeros(shape, np.int32)
        assert _spec_name(tls.batch_sharding(tm, x)) == \
            _spec_name(jls.batch_sharding(jm, x)), shape
    assert _spec_name(tls.batch_sharding(tm, np.zeros(8191))) == "replicated"
    assert _spec_name(tls.batch_sharding(tm, np.zeros(8192))) == "rows"


def test_place_batch_places_every_column_and_keeps_values():
    n = 1024
    cols = dict(
        rows=np.arange(n, dtype=np.int32),
        origin_ids=np.zeros(n, np.int32),
        origin_rows=np.full(n, 7, np.int32),
        context_ids=np.zeros(n, np.int32),
        chain_rows=np.full(n, 7, np.int32),
        acquire=np.ones(n, np.int32),
        is_in=np.ones(n, np.bool_),
        prioritized=np.zeros(n, np.bool_),
        valid=np.ones(n, np.bool_))
    from sentinel_tpu.engine.pipeline import EntryBatch as JEntry
    from sentinel_tpu_torch.engine.pipeline import EntryBatch as TEntry
    tm, jm = port_mesh(), jls.local_mesh(N_DEV)
    placed = tls.place_batch(TEntry(**cols), tm)
    jplaced = jls.place_batch(JEntry(**cols), jm)
    assert placed.param_rules is None and jplaced.param_rules is None
    for name, arr in cols.items():
        leaf = getattr(placed, name)
        assert isinstance(leaf, torch.Tensor) and leaf.device == tm.home
        np.testing.assert_array_equal(leaf.numpy(), arr)
        np.testing.assert_array_equal(
            np.asarray(getattr(jplaced, name)), arr)
        assert _spec_name(tls.batch_sharding(tm, arr)) == _spec_name(
            getattr(jplaced, name).sharding) == "rows", name
    # a column already on the home device is not copied
    t = torch.arange(8, dtype=torch.int32)
    again = tls.place_batch(TEntry(*([t] * 9)), tm)
    assert again.rows.data_ptr() == t.data_ptr()


def test_local_mesh_errors_when_short_of_devices():
    import jax
    with pytest.raises(ValueError, match="host_platform_device_count"):
        jls.local_mesh(len(jax.devices()) + 1)
    n = len(tls.visible_devices()) + 1
    with pytest.raises(ValueError, match=r"pass devices=\[device\]"):
        tls.local_mesh(n)
    m = tls.local_mesh(devices=[torch.device("cpu")] * n)
    assert m.shape[tls.MESH_AXIS] == n and m.axis_names == (tls.MESH_AXIS,)


@pytest.mark.parametrize("minute", [True, False])
def test_mesh_topology_artifact_block(minute):
    js, sh = make("jax", **CFG, minute_enabled=minute), make(
        "mesh", **CFG, minute_enabled=minute)
    one = make("one", **CFG, minute_enabled=minute)
    assert tls.mesh_topology(one.spec, None) == jls.mesh_topology(
        js.spec, None) == {"n_devices": 1, "axis": None,
                           "rows_per_device": one.spec.rows,
                           "sharded": False}
    topo = tls.mesh_topology(sh.spec, sh.mesh, sh._mesh_shardings[0])
    assert topo == jls.mesh_topology(js.spec, js.mesh,
                                     js._mesh_shardings[0])
    assert topo["n_devices"] == N_DEV and topo["axis"] == tls.MESH_AXIS
    assert topo["rows_per_device"] == sh.spec.rows // N_DEV
    assert topo["sharded"] and not topo["multihost"]
    assert topo["state_leaves_sharded"] > 0
    assert topo["state_leaves_replicated"] > 0
    for s in (js, sh, one):
        s.close()


# ---------------------------------------------------------------------------
# serving-tier parity
# ---------------------------------------------------------------------------

def _pipeline_cls(pkg):
    return importlib.import_module(pkg.__name__ + ".serving").DispatchPipeline


def _counts(s, *keys):
    return [s.obs.counters.get(k) for k in keys]


def test_pipeline_parity_and_mesh_counters():
    """Depth-2 pipelined raw dispatch: verdicts equal on every engine;
    ``split_route.meshed`` and ``pipeline.meshed_dispatch`` attribute
    every meshed dispatch, as the reference's do, and stay silent on the
    one-device engines."""
    def scenario(pkg, s):
        s.load_flow_rules(_rules(pkg))
        c = _raw_columns(s, n=4096 + 512)
        pipe = _pipeline_cls(pkg)(s, depth=2)
        tickets = [pipe.submit_raw(*_args(c), at_ms=T0 + i * 250)
                   for i in range(5)]
        meshed = s.mesh is not None
        got = [_v(t.result()) for t in tickets]
        assert _counts(s, ck.ROUTE_MESHED, ck.PIPE_MESHED) == (
            [5, 5] if meshed else [0, 0])
        return got

    sh = trio(scenario, jax_mesh_state=False, **CFG)
    assert sh.obs.counters.get(ck.ROUTE_MESHED) == 5
    sh.close()


def test_fused_decide_exit_parity():
    def scenario(pkg, s):
        s.load_flow_rules(_rules(pkg))
        c = _raw_columns(s, n=2048, seed=5)
        out = []
        for i in range(4):
            h = s.decide_and_exit_raw_nowait(
                *_args(c), exit_rows=c["rows"], exit_origin_rows=c["orow"],
                exit_chain_rows=c["chain"], exit_acquire=c["ones"],
                exit_rt_ms=c["rt"], exit_error=c["err"],
                exit_is_in=c["is_in"], at_ms=T0 + i * 250)
            out.append(_v(h.result()))
        assert s.obs.counters.get(ck.ROUTE_MESHED) == (
            4 if s.mesh is not None else 0)
        return out

    trio(scenario, jax_mesh_state=False, **CFG).close()


def test_split_routing_fires_identically_on_mesh():
    """Every engine takes the SAME split decision (scalar bulk + the
    prioritized/origin slice), with verdicts equal through it."""
    calls = {}

    def scenario(pkg, s):
        s.load_flow_rules(_rules(pkg))
        c = _raw_columns(s, n=8192)
        key = (pkg.__name__, s.mesh is not None)
        calls[key] = 0
        orig = s._decide_split_nowait

        def probe(*a, **k):
            calls[key] += 1
            return orig(*a, **k)

        s._decide_split_nowait = probe
        out = [_v(s.decide_raw_nowait(*_args(c), at_ms=T0 + i * 250)
                  .result()) for i in range(3)]
        return out, calls[key]

    sh = trio(scenario, jax_mesh_state=False, **CFG)
    assert set(calls.values()) == {3}
    assert sh.obs.counters.get(ck.ROUTE_MESHED) == 3
    sh.close()


def test_occupy_bookings_carry_across_reload_on_mesh():
    """Prioritized denials book the next window; a rule reload carries
    the same live bookings on every engine (the row-block ring settles
    block by block) and keeps the verdicts equal after it."""
    def scenario(pkg, s):
        s.load_flow_rules(_rules(pkg))
        c = _raw_columns(s, n=8192, prio_frac=0.05, seed=11)
        out = [_v(s.decide_raw_nowait(*_args(c), at_ms=T0 + i * 250)
                  .result()) for i in range(3)]
        granted = s.obs.counters.get(ck.OCCUPY_GRANTED)
        assert granted > 0
        s.clock.advance_ms(500)
        s.load_flow_rules(_rules(pkg, api_count=4.0))
        carried = s.obs.counters.get(ck.OCCUPY_CARRIED)
        assert carried > 0
        out += [_v(s.decide_raw_nowait(*_args(c), at_ms=T0 + i * 250)
                   .result()) for i in range(3, 6)]
        return out, granted, carried

    sh = trio(scenario, jax_mesh_state=False, **CFG)
    assert sh._state.flow_dyn.occupied_count.n == N_DEV
    sh.close()


def test_frontend_fanout_parity_on_mesh():
    """The ``AdaptiveBatcher`` on a meshed engine: per-request verdicts
    equal a sequential replay of its recorded flush cuts on a one-block
    twin of the same package — in each package — and the port's cuts
    replayed on the JAX meshed engine give the port's verdicts too."""
    rng = np.random.default_rng(31)
    stream = [("api" if rng.random() < 0.7 else "bulk",
               bool(rng.random() < 0.3),
               "app-a" if rng.random() < 0.4 else "")
              for _ in range(42)]

    def replay(s, flush_log):
        out = []
        for f in flush_log:
            v = s.entry_batch_nowait(
                f["resources"],
                acquire=np.asarray(f["counts"], np.int32),
                prioritized=np.asarray(f["prioritized"], np.bool_),
                origins=(f["origins"] if any(f["origins"]) else None),
            ).result()
            out.extend((bool(a), int(r), int(w)) for a, r, w in zip(
                np.asarray(v.allow), np.asarray(v.reason),
                np.asarray(v.wait_ms)))
        return out

    results = {}
    for pkg_name, fe_kind, seq_kind in (("torch", "mesh", "one"),
                                        ("jax", "jax", "jax1")):
        pkg = PKGS[fe_kind]
        fe_s, seq_s = make(fe_kind, **CFG), make(seq_kind, **CFG)
        try:
            for s in (fe_s, seq_s):
                s.load_flow_rules(_rules(pkg))
            batcher = importlib.import_module(
                pkg.__name__ + ".frontend.batcher").AdaptiveBatcher

            async def run():
                b = batcher(fe_s, batch_max=8, deadline_ms=60_000,
                            idle_ms=10_000.0, depth=2, record_flushes=True)
                verdicts = await asyncio.wait_for(asyncio.gather(
                    *(b.submit(r, prioritized=p, origin=o)
                      for r, p, o in stream)), 60)
                await asyncio.wait_for(b.drain(), 60)
                return verdicts, b.flush_log

            verdicts, flush_log = asyncio.run(run())
            assert [r for f in flush_log for r in f["resources"]] == \
                [r for r, _p, _o in stream]
            got = [(bool(v.allow), int(v.reason), int(v.wait_ms))
                   for v in verdicts]
            assert got == replay(seq_s, flush_log)
            assert fe_s.obs.counters.get(ck.PIPE_MESHED) > 0
            results[pkg_name] = (got, flush_log)
        finally:
            fe_s.close()
            seq_s.close()
    jm = make("jax", **CFG)
    jm.load_flow_rules(_rules(stpu))
    assert replay(jm, results["torch"][1]) == results["torch"][0]
    jm.close()
