"""Port parity: the row-sharded engine over processes —
``Sentinel(mesh=global_mesh(axis="rows"))`` after
``multihost.initialize()``, each rank holding its row blocks — against
the port's one-process engines, the JAX one-device engine and the JAX
runtime's own multi-process rows mesh.

The launches (two at a time, one module fixture, each under a timeout;
gloo on the CPU):

* the port's ``_rows_worker`` in 2 processes × 4 blocks, obs on (the
  default config): the seeded SPMD stream of
  :func:`sentinel_tpu_torch.multihost._rows_worker.stream` — rule loads
  of all five kinds, the host fast path, ``entry(args=)``, entries under
  ``enter_context``, ``entry_batch(origins=, contexts=)``, fused steps on
  the scalar and the general route, ``exit_batch``, a reload with live
  bookings, ``DispatchPipeline.submit_fused`` at depth 2, a telemetry
  tick, ``update_window_geometry`` — then every refused reader;
  The same worker then replays the short ``twin_stream`` on a second
  engine of the same mesh;
* the JAX worker (``tests/_jax_rows_worker.py``) on the reference's
  launcher, 2 processes × 4 virtual CPU devices: ``twin_stream`` with
  ``SENTINEL_OBS_DISABLE=1`` (with obs on its first rule load raises:
  ROADMAP C19), then the host readers it cannot serve;
* ``tests/_row_blocks_worker.py``: ``RowBlocks`` in the rank-local form.

In this process the same stream runs on the port's 1 × 8 and 1 × 1
engines and on the JAX one-device engine, obs on. Verdicts and every
state leaf (the ranks' blocks joined) must be equal, bit for bit, and
every ``obs`` counter equal to the JAX one-device engine's (the two
meshed counters aside). On ``twin_stream`` the JAX 2 × 4 engine is held
to the port's 2 × 4 in full at the ``"twin_inrange"`` checkpoint, inside
the range where it agrees with its own one-device engine (C18: up to 64
lanes a fused step); past it, after the 256-lane fused steps, its
verdicts and its window counters only.
"""

import concurrent.futures
import importlib
import json
import os

import numpy as np
import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.multihost import _rows_worker as rw
from sentinel_tpu_torch.parallel import local_shard as tls
from sentinel_tpu_torch.parallel.row_blocks import RemoteRowsError, RowBlocks

import _row_blocks_worker as bw

j_launch = importlib.import_module("sentinel_tpu.multihost.launch")
t_launch = importlib.import_module("sentinel_tpu_torch.multihost.launch")

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
#: the workers' thread pools kept to one thread: the suite runs beside
#: other test workers on the same cores
_QUIET = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
#: the counters only a meshed engine ticks
MESHED = ("split_route.meshed", "pipeline.meshed_dispatch")


def _lines(results, tag):
    got = [json.loads(line.split(":", 1)[1]) for r in results
           for line in r.stdout.splitlines() if line.startswith(tag)]
    return sorted(got, key=lambda d: d["rank"])


def _merged(out_dir, lines, tag):
    dumps = [(dict(np.load(os.path.join(out_dir, f"{tag}.{r}.npz"))),
              line["offsets"]) for r, line in enumerate(lines)]
    return convert.merge_rank_states(dumps)


def _local(base):
    """The stream on the port's 1 × 8 and 1 × 1 engines and the JAX
    one-device engine, in this process, obs on."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SENTINEL_TPU_LOG_DIR", str(base / "logs"))
        for kind in ("jax1", "port8", "port1"):
            if kind == "jax1":
                s = rw.make_sentinel(stpu)
                pkg = stpu
            else:
                mesh = (tls.local_mesh(devices=[torch.device("cpu")] * 8)
                        if kind == "port8" else None)
                s = rw.make_sentinel(stt, mesh=mesh,
                                     **({} if mesh else {"device": "cpu"}))
                pkg = stt
            states = {}
            obs = rw.stream(pkg, s, lambda tag, s=s: states.__setitem__(
                tag, convert.engine_to_numpy(s)))
            out[kind] = {"obs": obs, "states": states,
                         "counters": s.obs.counters.snapshot(),
                         "routes": dict(getattr(s, "routes", {}))}
            s.close()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch, two at a time, while this process runs the
    one-process engines (:func:`_local`, under ``"local"``)."""
    base = tmp_path_factory.mktemp("rows_mp")
    env = {**_QUIET, "SENTINEL_TPU_LOG_DIR": str(base / "logs")}
    dirs = {k: str(base / k) for k in ("port", "jax")}
    jobs = {
        "jax": lambda: j_launch.launch(
            [os.path.join(HERE, "_jax_rows_worker.py"), "--out",
             dirs["jax"], "--refusals"], 2, devices_per_process=4,
            timeout_s=240, env={**env, "SENTINEL_OBS_DISABLE": "1"}),
        "port": lambda: t_launch.launch(
            ["-m", "sentinel_tpu_torch.multihost._rows_worker",
             "--out", dirs["port"], "--refusals"], 2,
            devices_per_process=4, timeout_s=240, platform="cpu", env=env),
        "blocks": lambda: t_launch.launch(
            [os.path.join(HERE, "_row_blocks_worker.py")], 2,
            devices_per_process=2, timeout_s=120, platform="cpu", env=env),
    }
    # two launches at a time: at most four worker processes at once
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {k: pool.submit(f) for k, f in jobs.items()}
        out = {"local": _local(base)}
        res = {k: f.result() for k, f in futs.items()}
    out["blocks"] = _lines(res["blocks"], "BLOCKS_JSON:")
    for k in ("port", "jax"):
        lines = _lines(res[k], "ROWS_JSON:")
        assert len(lines) == 2, "\n".join(r.stdout + r.stderr
                                          for r in res[k])
        tags = rw.TWIN_CHECKPOINTS + (rw.CHECKPOINTS if k == "port"
                                      else ())
        out[k] = {"lines": lines,
                  "states": {t: _merged(dirs[k], lines, t) for t in tags}}
    return out


@pytest.fixture(scope="module")
def local(runs):
    return runs["local"]


def _without(counters, keys=MESHED):
    return {k: v for k, v in counters.items() if k not in keys}


# ---------------------------------------------------------------------------
# RowBlocks in the rank-local form
# ---------------------------------------------------------------------------

def test_row_blocks_rank_local_reads_writes_and_sum(runs):
    """Two ranks × 2 blocks of 4 rows: per-lane reads (negative rows, a
    row past the table), int-row reads, one packed ``read_rows`` of four
    dtypes (one collective), ``sum()`` — as int bit patterns,
    so ``-0.0`` and the NaN payloads must come back as the owner holds
    them — equal one process's 4 blocks; writes with negative rows and
    pads past the table (C11) and ``add_row_`` land in the owners'
    blocks exactly as on one process; a host read of the whole table
    raises before any collective."""
    lines = runs["blocks"]
    assert [d["first"] for d in lines] == [0, 2]
    want = bw.run(lambda t: RowBlocks.split(t, [torch.device("cpu")] * 4))
    for d in lines:
        for key in ("read_f", "read_f_col", "read_i", "read_f_int",
                    "read_i_int", "sum_f", "sum_i", "packed",
                    "packed_dtypes"):
            assert d[key] == want[key], (d["rank"], key)
        blocks = slice(d["first"], d["first"] + 2)
        assert d["write_i"] == want["write_i"][blocks]
        assert d["write_f"] == want["write_f"][blocks]
        assert d["to_numpy"] == "RemoteRowsError"
        assert d["collectives_after"] == d["collectives"]
        # 5 reads + 2 sums + one packed read of five
        assert d["collectives"]["calls"] == 8
    # the bit cases are really in the reads
    f, _ = bw.tables()
    got = np.asarray(lines[0]["read_f"], np.int64).astype(
        np.int32).reshape(len(bw.READ_ROWS), 3)
    rows = np.asarray(bw.READ_ROWS) % bw.ROWS
    rows[np.asarray(bw.READ_ROWS) >= bw.ROWS] = 0
    assert np.array_equal(got, f.view(np.int32)[rows])
    assert np.int32(np.uint32(bw.NAN_BITS[0]).view(np.int32)) in got
    assert np.int32(np.uint32(0x80000000).view(np.int32)) in got


# ---------------------------------------------------------------------------
# the runtime stream
# ---------------------------------------------------------------------------

def test_stream_bit_for_bit_with_one_process_and_jax(runs, local):
    """Port 2 × 4 == port 1 × 8 == port 1 × 1 == the JAX one-device
    engine: every stage's verdicts, every state leaf at both checkpoints
    (the ranks' blocks joined; each replicated leaf equal on both ranks),
    every ``obs`` counter — the occupy reload counters included — and
    the routes."""
    port = runs["port"]
    ref = local["jax1"]
    for kind in ("port8", "port1"):
        assert local[kind]["obs"] == ref["obs"], kind
    for line in port["lines"]:
        assert line["observations"] == ref["obs"], line["rank"]
        assert line["process_count"] == 2
        assert (line["backend"], line["device"]) == ("gloo", "cpu")
        assert _without(line["counters"]) == ref["counters"]
        assert line["routes"] == local["port8"]["routes"]
        assert line["collectives"]["calls"] > 0
    assert [line["blocks"] for line in port["lines"]] == [[0, 4], [4, 4]]
    for line in port["lines"]:
        topo = line["topology"]
        assert (topo["n_devices"], topo["rows_per_device"],
                topo["multihost"], topo["process_count"],
                topo["local_blocks"]) == (8, 8, True, 2, 4)
        assert line["fingerprint_mesh"] == {
            "n_devices": 8, "axis": "rows", "sharded": True,
            "process_count": 2}
    for tag in rw.CHECKPOINTS:
        merged, unequal = port["states"][tag]
        assert unequal == [], tag
        for kind in ("jax1", "port8", "port1"):
            assert convert.leaf_diff(local[kind]["states"][tag],
                                     merged) == [], (tag, kind)
            assert convert.leaf_diff(merged,
                                     local[kind]["states"][tag]) == []
    c = ref["counters"]
    assert c.get("occupy.carried", 0) + c.get("occupy.settled", 0) > 0
    assert _without(local["port8"]["counters"]) == ref["counters"]
    # the stream reached every kind of verdict it is meant to
    seen = {x for stage in ("fast_path", "entries") for x in ref["obs"][stage]}
    assert {"pass", "FlowException", "ParamFlowException",
            "AuthorityException"} <= seen


def test_jax_rows_mesh_twin(runs):
    """The JAX runtime's own 2 × 4 rows mesh (obs off) and the port's, on
    :func:`~sentinel_tpu_torch.multihost._rows_worker.twin_stream` (rule
    loads of all five kinds, an ``entry_batch`` with origins and
    contexts, fused steps): verdicts equal everywhere; state in full at
    the in-range checkpoint; past C18's range (the 256-lane fused steps)
    the window counters only."""
    jax = runs["jax"]
    want = runs["port"]["lines"][0]["twin"]
    assert runs["port"]["lines"][1]["twin"] == want
    for line in jax["lines"]:
        assert line["observations"] == want, line["rank"]
    port_in, unequal = runs["port"]["states"]["twin_inrange"]
    assert unequal == []
    jax_in, unequal = jax["states"]["twin_inrange"]
    assert unequal == []
    assert convert.leaf_diff(jax_in, port_in) == []
    assert convert.leaf_diff(port_in, jax_in) == []
    port_end, _ = runs["port"]["states"]["twin_end"]
    jax_end, _ = jax["states"]["twin_end"]
    counters = [k for k in port_end if k.endswith(".counters")]
    assert len(counters) == 3
    assert convert.leaf_diff({k: jax_end[k] for k in counters},
                             {k: port_end[k] for k in counters}) == []
    assert {0, 1} <= {a for step in want["fused"] + want["big"]
                      for a in step[0]}


@pytest.mark.parametrize("name", [n for n, _call in rw.REFUSED])
def test_refused_readers_raise_on_every_rank(runs, name):
    """Each host reader that the JAX runtime cannot serve on a spanning
    mesh raises there (``RuntimeError``: non-addressable devices) and
    raises the port's named :class:`RemoteRowsError` on every rank,
    citing ROADMAP A11 and C19, without a collective."""
    for line in runs["jax"]["lines"]:
        kind, msg = line["refusals"][name]
        assert kind == "RuntimeError" and "non-addressable" in msg
    for line in runs["port"]["lines"]:
        kind, msg = line["refusals"][name]
        assert kind == RemoteRowsError.__name__
        assert "A11" in msg and "C19" in msg
        assert line["collectives_after_refusals"] == line["collectives"]
        assert line["refusal_s"] < 5.0
    assert issubclass(RemoteRowsError, RuntimeError)
