"""Port parity: the cold-start cache and first-dispatch accounting
(``sentinel_tpu_torch.core.compile_cache``) against
``sentinel_tpu.core.compile_cache``.

Twins of the 2 tests of ``tests/test_compile_cache.py``. The reference
caches XLA programs; the port's cache is the directory its hand-built
libraries land in (``SENTINEL_COMPILE_CACHE``), so its twins start a
fresh process twice on one directory: the first builds the C++ interning
tables with ``g++`` (the CUDA kernel needs ``nvcc`` and a card, so it is
not built here), the second finds the library, compiles nothing, writes
no new entry and reaches its first verdict sooner; ``off`` gives every
process a fresh directory, so it compiles again.

Then ``compile_cache.hit`` / ``.miss`` on twin runtimes over every
dispatch kind the reference keys (decide, the split pair, decide+exit,
with single dispatch on and off, a device slot registered, a geometry
change), and ``compile_cache.first_fetch_retry`` with the first-dispatch
guard switched on: counters equal to the reference's, verdicts equal to
a run without the guard.
"""

import itertools
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.core import compile_cache as jcc
from sentinel_tpu_torch.core import compile_cache as tcc

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_785_000_000_000
PKGS = {"jax": stpu, "torch": stt}

CHILD = """
import json, os, time
t0 = time.perf_counter()
from sentinel_tpu_torch.ops import _build
calls = []
_compile = _build._compile
def counted(argv, lib):
    calls.append(os.path.basename(argv[0]))
    return _compile(argv, lib)
_build._compile = counted
import sentinel_tpu_torch as stt
from sentinel_tpu_torch.core.clock import ManualClock
from sentinel_tpu_torch.core.compile_cache import active_cache_dir, cache_dir
cfg = stt.load_config(max_resources=256, max_flow_rules=16,
                      max_degrade_rules=16, max_authority_rules=16,
                      host_fast_path=False)
sph = stt.Sentinel(config=cfg, clock=ManualClock(start_ms=10_000_000),
                   device="cpu")
sph.load_flow_rules([stt.FlowRule(resource="x", count=5.0)])
e = sph.entry("x"); e.exit()          # first verdict
print(json.dumps({"secs": time.perf_counter() - t0,
                  "cache": active_cache_dir(), "dir": cache_dir(),
                  "native": type(sph.resources).__name__,
                  "compiled": calls,
                  "build_s": _build.build_seconds.get("sentinel_native")}))
sph.close()
"""


def _run(cache, tmp_path):
    env = dict(os.environ, SENTINEL_COMPILE_CACHE=str(cache),
               PYTHONPATH=REPO, SENTINEL_TPU_LOG_DIR=str(tmp_path / "logs"))
    env.pop("SENTINEL_TPU_NATIVE", None)
    out = subprocess.run([sys.executable, "-c", CHILD], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_second_process_starts_from_cache(tmp_path):
    cache = tmp_path / "build-cache"
    cold = _run(cache, tmp_path)
    assert cold["cache"] == cold["dir"] == str(cache)
    assert cold["native"].startswith("Native"), cold
    assert cold["compiled"] == ["g++"] and cold["build_s"] > 0
    entries = set(os.listdir(cache))
    assert entries and all(e.startswith("libsentinel_native-")
                           for e in entries), entries

    warm = _run(cache, tmp_path)
    # the library is found: nothing compiles, nothing new is written, and
    # startup-to-first-verdict beats the cold process
    assert warm["compiled"] == [] and warm["build_s"] == 0.0
    assert set(os.listdir(cache)) == entries
    assert warm["secs"] < cold["secs"], (warm, cold)


def test_cache_can_be_disabled(tmp_path):
    outs = [_run("off", tmp_path) for _ in range(2)]
    for out in outs:
        assert out["cache"] is None
        assert out["compiled"] == ["g++"]       # nothing is reused
        assert out["dir"] != tcc.default_cache_dir()
    assert outs[0]["dir"] != outs[1]["dir"]


# ------------------------------------------------- first-dispatch counters

CFG = dict(max_resources=64, max_origins=16, max_flow_rules=16,
           max_degrade_rules=8, max_authority_rules=8, host_fast_path=False)


def _make(name, **over):
    pkg = PKGS[name]
    extra = {"device": "cpu"} if name == "torch" else {}
    sph = pkg.Sentinel(config=pkg.load_config(**{**CFG, **over}),
                       clock=pkg.ManualClock(start_ms=T0), **extra)
    sph._cpu.sample = lambda: (0.5, 0.25)
    return sph


def _cache_counters(sph) -> tuple:
    c = sph.obs.counters.snapshot()
    return tuple(c.get(k, 0) for k in ("compile_cache.hit",
                                       "compile_cache.miss",
                                       "compile_cache.first_fetch_retry"))


def _slot(pkg):
    """A DeviceSlot that admits everything and counts live events (in
    ``jnp`` for the reference, in torch for the port)."""
    if pkg is stt:
        class Count(stt.DeviceSlot):
            name = "count"

            def init_state(self, spec):
                return torch.zeros((), dtype=torch.int32)

            def check(self, state, view):
                return (state + view.live.sum(dtype=torch.int32),
                        torch.ones_like(view.live))
    else:
        import jax.numpy as jnp

        class Count(stpu.DeviceSlot):
            name = "count"

            def init_state(self, spec):
                return jnp.zeros((), jnp.int32)

            def check(self, state, view):
                return (state + jnp.sum(view.live.astype(jnp.int32)),
                        jnp.ones_like(view.live))
    return Count()


def _scenario(name, pkg, sph):
    """Every dispatch kind the reference keys, counters read after each
    stage."""
    clk = sph.clock
    marks = []
    sph.load_flow_rules([pkg.FlowRule(resource="api", count=50.0),
                         pkg.FlowRule(resource="api", count=3.0,
                                      limit_app="app-a")])
    for _ in range(3):                            # scalar decide, B=8
        with sph.entry("api"):
            pass
    marks.append(_cache_counters(sph))
    with sph.entry("api", origin="app-a"):        # alt rows: another key
        pass
    sph.entry_batch(["api"] * 40, acquire=np.full(40, 2, np.int32))
    marks.append(_cache_counters(sph))
    # a batch that splits (scalar + general halves: two keys)
    names = ["api"] * 4200 + ["b"] * 10
    v = sph.entry_batch(names, origins=[None] * 4200 + ["app-a"] * 10)
    marks.append((_cache_counters(sph), int(np.asarray(v.allow).sum())))
    rows = sph.intern_resources(["api"] * 64)
    n = rows.shape[0]
    ra = sph.spec.alt_rows
    z = np.zeros(n, np.int32)
    for step in range(3):                         # fused decide+exit
        sph.decide_and_exit_raw_nowait(
            rows, z, np.full(n, ra, np.int32), z, np.full(n, ra, np.int32),
            np.ones(n, np.int32), np.ones(n, np.bool_),
            np.zeros(n, np.bool_), exit_rows=rows[:step * 8]).result()
        clk.advance_ms(400)
    marks.append(_cache_counters(sph))
    slot = _slot(pkg)                             # re-jit: fresh keys
    sph.register_slot(slot)
    with sph.entry("api"):
        pass
    sph.unregister_slot(slot)                     # back to the shared steps
    with sph.entry("api"):
        pass
    marks.append(_cache_counters(sph))
    sph.update_window_geometry(sample_count=4, interval_ms=1000)
    with sph.entry("api"):
        pass
    sph.update_window_geometry(sample_count=2, interval_ms=1000)
    with sph.entry("api"):
        pass
    marks.append(_cache_counters(sph))
    return marks


@pytest.mark.parametrize("single_dispatch", ["1", "0"])
def test_first_dispatch_hit_miss_twins(tmp_path, monkeypatch,
                                       single_dispatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("SENTINEL_SINGLE_DISPATCH", single_dispatch)
    got = {}
    for name, pkg in PKGS.items():
        sph = _make(name)
        try:
            got[name] = _scenario(name, pkg, sph)
        finally:
            sph.close()
    assert got["torch"] == got["jax"]
    hits, misses, retries = got["torch"][-1]
    assert (hits, misses, retries) == (5, 9, 0)


def _stall_first_attempt(cc_mod, monkeypatch):
    """Make the guard's first attempt of every key stall for certain:
    it waits until the guard's timeout has fired (its retry callback)
    before it runs. A short eager step can otherwise finish before the
    caller reaches its timed wait, when the caller is descheduled right
    after starting the attempt's thread, and then no retry is counted."""
    real = cc_mod.guarded_first_fetch

    def guarded(fn, what, timeout_s, retries, on_retry=None):
        if timeout_s <= 0 or retries <= 0:      # no timeout to wait for
            return real(fn, what, timeout_s, retries, on_retry)
        fired = threading.Event()
        calls = itertools.count()

        def attempt():
            if next(calls) == 0:
                fired.wait(60.0)
            return fn()

        def retry():
            fired.set()
            if on_retry is not None:
                on_retry()

        return real(attempt, what, timeout_s, retries, on_retry=retry)

    monkeypatch.setattr(cc_mod, "guarded_first_fetch", guarded)


def test_first_fetch_guard_counts_retries(tmp_path, monkeypatch):
    """With an operator timeout far below any step's time, every first
    dispatch of a key stalls once and retries once (the final attempt
    waits): one ``compile_cache.first_fetch_retry`` per miss, in both
    packages, and the throwaway executions leave the verdicts alone.
    The stall is made certain in both packages alike
    (:func:`_stall_first_attempt`)."""
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    for cc_mod in (tcc, jcc):
        _stall_first_attempt(cc_mod, monkeypatch)
    runs = {}
    for guard in (False, True):
        if guard:
            monkeypatch.setenv("SENTINEL_FIRST_LOAD_TIMEOUT_S", "0.000001")
            monkeypatch.setenv("SENTINEL_FIRST_LOAD_RETRIES", "1")
        assert tcc.first_fetch_policy() == jcc.first_fetch_policy()
        for name, pkg in PKGS.items():
            sph = _make(name)
            try:
                sph.load_flow_rules([pkg.FlowRule(resource="api", count=3.0)])
                out = []
                for _ in range(5):
                    try:
                        with sph.entry("api"):
                            out.append(True)
                    except pkg.BlockException:
                        out.append(False)
                v = sph.entry_batch(["api", "b"] * 20)
                out.append(np.asarray(v.allow).tolist())
                runs[name, guard] = (out, _cache_counters(sph))
            finally:
                sph.close()
    assert tcc.first_fetch_policy() == (1e-06, 1)
    assert runs["torch", True] == runs["jax", True]
    assert runs["torch", False] == runs["jax", False]
    out, (hits, misses, retries) = runs["torch", True]
    assert out == runs["torch", False][0]
    assert misses == 2 and retries == misses and hits == 4


def test_program_key_and_policy_defaults(monkeypatch):
    for k in ("SENTINEL_FIRST_LOAD_TIMEOUT_S", "SENTINEL_FIRST_LOAD_RETRIES",
              "SENTINEL_COMPILE_CACHE"):
        monkeypatch.delenv(k, raising=False)
    flags = {"skip_sys": True, "skip_auth": False}
    assert tcc.program_key("decide", 7, (8,), flags) == \
        jcc.program_key("decide", 7, (8,), flags)
    # off by default on every device (the reference: off on CPU only)
    assert tcc.first_fetch_policy() == (0.0, 0) == jcc.first_fetch_policy()
    assert tcc.cache_dir() == tcc.default_cache_dir()
    assert tcc.active_cache_dir() == tcc.default_cache_dir()
