"""Port parity: the call-context API (``ContextUtil`` analog) of
``sentinel_tpu_torch.core.context`` against ``sentinel_tpu.core.context``.

``enter_context`` / ``exit_context`` and the scope, snapshot and restore
functions run the same scripts in both packages — nested under asyncio
tasks that interleave and in plain threads — and the port's package
exports every name of the reference's ``__all__``. Then an ``entry``
under ``enter_context("e", origin="o")`` takes the same CHAIN and
origin-rule verdicts on twin runtimes.
"""

import asyncio
import threading

import pytest
import torch

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.core import context as j_ctx
from sentinel_tpu_torch.core import context as t_ctx

torch.set_num_threads(2)

T0 = 1_785_000_000_000
PKGS = {"jax": j_ctx, "torch": t_ctx}


def _now(c):
    cur = c.current_context()
    return (cur.name, cur.origin)


def _script_nested(c):
    """enter/exit/scope nesting on one thread → the observed contexts."""
    seen = [_now(c)]
    got = c.enter_context("outer", origin="app-a")
    seen.append((got.name, got.origin))
    seen.append(_now(c))
    with c.ContextScope("inner", origin="app-b"):
        seen.append(_now(c))
        c.enter_context("", origin="")       # an empty name: the default
        seen.append(_now(c))
    seen.append(_now(c))                     # the scope's token restores
    c.exit_context()
    seen.append(_now(c))
    c.exit_context()                         # idempotent
    seen.append(_now(c))
    return seen


def _script_tasks(c):
    """Two asyncio tasks enter their own contexts and interleave."""
    seen = {}

    async def worker(name, origin, gate_in, gate_out):
        c.enter_context(name, origin=origin)
        await gate_in.wait()
        seen[name] = _now(c)
        with c.ContextScope(name + "-in", origin=origin + "-in"):
            await asyncio.sleep(0)
            seen[name + "-scope"] = _now(c)
        seen[name + "-after"] = _now(c)
        c.exit_context()
        seen[name + "-exit"] = _now(c)
        gate_out.set()

    async def main():
        g1, g2 = asyncio.Event(), asyncio.Event()
        ta = asyncio.ensure_future(worker("a", "app-a", g1, g2))
        tb = asyncio.ensure_future(worker("b", "app-b", g2, g1))
        await asyncio.sleep(0)
        g1.set()
        await asyncio.wait_for(asyncio.gather(ta, tb), 10)
        seen["main"] = _now(c)

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(main())
    finally:
        loop.close()
    return seen


def _script_threads(c):
    """Threads see their own contexts; the caller's is untouched."""
    seen = {}
    barrier = threading.Barrier(2)
    c.enter_context("main-ctx", origin="main")

    def ctx_thread_body(i):
        seen[f"t{i}-start"] = _now(c)
        c.enter_context(f"ctx-{i}", origin=f"app-{i}")
        barrier.wait(timeout=10)
        seen[f"t{i}"] = _now(c)
        c.exit_context()
        seen[f"t{i}-exit"] = _now(c)

    ts = [threading.Thread(target=ctx_thread_body, args=(i,),
                          name=f"ctx-body-{i}")
          for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
        assert not t.is_alive()
    seen["main"] = _now(c)
    c.exit_context()
    return seen


@pytest.mark.parametrize("script", [_script_nested, _script_tasks,
                                    _script_threads],
                         ids=["nested", "asyncio_tasks", "threads"])
def test_enter_exit_twins(script):
    got = {k: script(c) for k, c in PKGS.items()}
    assert got["torch"] == got["jax"]
    assert t_ctx.current_context().name == t_ctx.DEFAULT_CONTEXT_NAME


def test_async_entry_snapshot_then_exit_context():
    """The port's counterpart of ``tests/test_async_context.py:80-102``: a
    snapshot taken at ``async_entry`` is restored elsewhere, then
    ``exit_context`` drops it."""
    from sentinel_tpu_torch.adapters.asyncio_support import async_entry
    cfg = stt.load_config(max_resources=64, max_flow_rules=16,
                          max_degrade_rules=16, max_authority_rules=16)
    sph = stt.Sentinel(config=cfg, clock=stt.ManualClock(start_ms=T0),
                       device="cpu")
    captured = {}

    async def main():
        with t_ctx.ContextScope("web", origin="app-z"):
            ae = async_entry(sph, "api2")
            async with ae:
                pass
            captured["snap"] = ae.context

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(asyncio.wait_for(main(), 30))
    finally:
        loop.close()
    assert captured["snap"].origin == "app-z"
    t_ctx.restore_context(captured["snap"])
    assert t_ctx.current_context().origin == "app-z"
    stt.exit_context()
    assert t_ctx.current_context().origin == ""
    assert t_ctx.current_context().name == t_ctx.DEFAULT_CONTEXT_NAME
    sph.close()


def test_all_covers_the_reference_exports():
    assert set(stpu.__all__) <= set(stt.__all__)
    for name in ("ContextScope", "enter_context", "exit_context",
                 "snapshot_context", "restore_context"):
        assert getattr(stt, name) is getattr(t_ctx, name)


def _run_entries(pkg, sph):
    """CHAIN and origin rules decided under ``enter_context``."""
    out = []
    for i in range(6):
        for name, origin, res in (("e", "o", "chained"),
                                  ("e", "", "chained"),
                                  ("other", "o", "chained"),
                                  ("e", "o", "by-origin"),
                                  ("e", "p", "by-origin")):
            pkg.enter_context(name, origin=origin)
            try:
                e = sph.entry(res)
                e.exit()
                out.append((i, name, origin, res, "pass"))
            except pkg.BlockException as exc:
                out.append((i, name, origin, res, type(exc).__name__))
            finally:
                pkg.exit_context()
    return out


def test_entry_under_enter_context_twins():
    rules = [
        dict(resource="chained", count=2,
             strategy=stpu.STRATEGY_CHAIN, ref_resource="e"),
        dict(resource="by-origin", count=3, limit_app="o"),
        dict(resource="by-origin", count=100, limit_app="other"),
    ]
    got = {}
    for pkg, kw in ((stpu, {}), (stt, {"device": "cpu"})):
        cfg = pkg.load_config(max_resources=64, max_origins=16,
                              max_flow_rules=16, max_degrade_rules=16,
                              max_authority_rules=16, host_fast_path=False)
        sph = pkg.Sentinel(config=cfg, clock=pkg.ManualClock(start_ms=T0),
                           **kw)
        sph.load_flow_rules([pkg.FlowRule(**r) for r in rules])
        got[pkg.__name__] = _run_entries(pkg, sph)
        sph.close()
    assert got["sentinel_tpu_torch"] == got["sentinel_tpu"]
    kinds = {r[-1] for r in got["sentinel_tpu"]}
    assert {"pass", "FlowException"} <= kinds
