"""Port parity: the SPI loader and init hooks (``sentinel_tpu_torch.core.spi``,
``core/initexec.py``) against ``sentinel_tpu.core.spi``.

The port's counterparts of ``tests/test_spi.py`` (provider order, alias,
default and singletons, plugin modules through ``SENTINEL_TPU_PLUGINS``,
ordered once-only init funcs, the auto-wired command handlers), then the
twin of the processor-slot wiring: a ``processor_slot`` provider's
``HostGate`` and ``DeviceSlot`` (the device slot written in ``jnp`` for
the reference and in torch for the port) registered in each package's
loader act in every new ``Sentinel`` of both packages with equal
verdicts, slot names, node totals and engine state.

The port's facade builds ``Sentinel()`` on ``cuda``; where a test needs
``api.instance()`` to build one here, it points the facade's constructor
at the CPU.
"""

import functools
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sentinel_tpu as stpu
import sentinel_tpu.api as japi
import sentinel_tpu_torch as stt
import sentinel_tpu_torch.api as sph_api
from sentinel_tpu.core import spi as jspi
from sentinel_tpu.core.initexec import InitExecutor as JInitExecutor
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.core import spi as spi_mod
from sentinel_tpu_torch.core.clock import ManualClock
from sentinel_tpu_torch.core.initexec import InitExecutor, init_func
from sentinel_tpu_torch.core.spi import (
    SERVICE_COMMAND_HANDLER, SERVICE_PROCESSOR_SLOT, SpiLoader, spi,
)

torch.set_num_threads(2)

T0 = 1_785_000_000_000


@pytest.fixture(autouse=True)
def _spi_hygiene(tmp_path, monkeypatch):
    monkeypatch.setenv("SENTINEL_TPU_LOG_DIR", str(tmp_path / "logs"))
    yield
    for loader, init, api in ((SpiLoader, InitExecutor, sph_api),
                              (jspi.SpiLoader, JInitExecutor, japi)):
        loader.reset_and_clear_all()
        init.reset()
        api.reset()


@pytest.fixture
def cpu_facade(monkeypatch):
    """``api.instance()`` builds its ``Sentinel()`` on the CPU."""
    monkeypatch.setattr(sph_api, "Sentinel",
                        functools.partial(stt.Sentinel, device="cpu"))


def _cfg(pkg=stt, **kw):
    return pkg.load_config(max_resources=32, max_flow_rules=8,
                           max_degrade_rules=8, max_authority_rules=8, **kw)


def test_names_and_knobs_match_the_reference():
    for name in ("SERVICE_INIT_FUNC", "SERVICE_PROCESSOR_SLOT",
                 "SERVICE_COMMAND_HANDLER", "PLUGINS_ENV",
                 "LOWEST_PRECEDENCE"):
        assert getattr(spi_mod, name) == getattr(jspi, name), name
    # the port's own entry-point group: a plugin written for the JAX
    # package would pull JAX in
    assert spi_mod.ENTRY_POINT_GROUP == "sentinel_tpu_torch.plugins"
    assert jspi.ENTRY_POINT_GROUP == "sentinel_tpu.plugins"
    assert InitExecutor.WAIT_TIMEOUT_S == JInitExecutor.WAIT_TIMEOUT_S


def test_registries_are_separate():
    """A provider registered in one package's loader is not seen by the
    other's."""
    SpiLoader.of("sep").register("torch-only")
    assert jspi.SpiLoader.of("sep").load_instance_list_sorted() == []
    jspi.SpiLoader.of("sep").register("jax-only")
    assert SpiLoader.of("sep").load_instance_list_sorted() == ["torch-only"]


# ------------------------------------------------------------------ loader

def test_sorted_alias_default_and_singletons():
    loader = SpiLoader.of("svc")

    @spi("svc", order=20)
    class B:
        pass

    @spi("svc", order=10, alias="first")
    class A:
        pass

    @spi("svc", is_default=True)          # LOWEST_PRECEDENCE order
    class D:
        pass

    insts = loader.load_instance_list_sorted()
    assert [type(i) for i in insts] == [A, B, D]
    assert loader.load_instance_list_sorted()[0] is insts[0]
    assert loader.load_new_instance_list_sorted()[0] is not insts[0]
    assert isinstance(loader.load_instance_by_alias("first"), A)
    assert isinstance(loader.load_default_instance(), D)
    assert isinstance(loader.load_highest_priority_instance(), A)
    assert loader.aliases() == ["first", "B", "D"]


def test_non_class_providers_used_as_is():
    sentinel = object()
    SpiLoader.of("svc2").register(sentinel, order=1)
    assert SpiLoader.of("svc2").load_instance_list_sorted() == [sentinel]
    SpiLoader.of("svc2").unregister(sentinel)
    assert SpiLoader.of("svc2").load_instance_list_sorted() == []


def test_equal_order_preserves_registration_sequence():
    SpiLoader.of("svc3").register("x", order=5)
    SpiLoader.of("svc3").register("y", order=5)
    assert SpiLoader.of("svc3").load_instance_list_sorted() == ["x", "y"]


def test_loader_order_matches_the_reference_on_random_providers():
    rng = np.random.default_rng(8)
    orders = rng.integers(0, 5, 40).tolist()
    defaults = (rng.random(40) < 0.1).tolist()
    for loader in (SpiLoader, jspi.SpiLoader):
        for i, (o, d) in enumerate(zip(orders, defaults)):
            loader.of("rand").register(f"p{i}", alias=f"a{i % 7}", order=o,
                                       is_default=d)
    mine, ref = SpiLoader.of("rand"), jspi.SpiLoader.of("rand")
    assert mine.load_instance_list_sorted() == \
        ref.load_instance_list_sorted()
    assert mine.aliases() == ref.aliases()
    assert mine.load_default_instance() == ref.load_default_instance()
    for a in range(8):
        assert mine.load_instance_by_alias(f"a{a}") == \
            ref.load_instance_by_alias(f"a{a}")


# ------------------------------------------------------------------ plugins

def test_plugin_module_discovery(tmp_path, monkeypatch):
    (tmp_path / "my_torch_sentinel_plugin.py").write_text(textwrap.dedent("""
        from sentinel_tpu_torch.core.spi import spi

        @spi("plugin_probe", alias="from-plugin")
        class Probe:
            pass
    """))
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv(spi_mod.PLUGINS_ENV, "my_torch_sentinel_plugin")
    assert spi_mod.load_plugins(force=True) == ["my_torch_sentinel_plugin"]
    assert SpiLoader.of("plugin_probe").load_instance_by_alias(
        "from-plugin") is not None
    # once per process unless forced
    assert spi_mod.load_plugins() == []
    sys.modules.pop("my_torch_sentinel_plugin", None)


def test_bad_plugin_module_is_logged_not_fatal(monkeypatch):
    monkeypatch.setenv(spi_mod.PLUGINS_ENV, "definitely_not_a_module_xyz")
    assert spi_mod.load_plugins(force=True) == []


# ------------------------------------------------------------------ init

def test_init_funcs_run_once_ordered_via_api_init():
    calls = []

    @init_func(order=2)
    def second(sph):
        calls.append(("second", sph))

    @init_func(order=1)
    def first(sph):
        calls.append(("first", sph))

    inst = sph_api.init(_cfg(), clock=ManualClock(start_ms=T0),
                        device="cpu")
    assert [c[0] for c in calls] == ["first", "second"]
    assert all(c[1] is inst for c in calls)
    sph_api.init(_cfg(), clock=ManualClock(start_ms=T0), device="cpu")
    assert len(calls) == 2


def test_concurrent_instance_waits_for_init_hooks(cpu_facade):
    hook_done = threading.Event()
    observed = []

    @init_func(order=1)
    def slow_hook(sph):
        time.sleep(0.3)             # the window in which a race would show
        hook_done.set()

    def racer():
        inst = sph_api.instance()
        observed.append((inst, hook_done.is_set()))

    t0 = threading.Thread(target=racer)
    t1 = threading.Thread(target=racer)
    t0.start()
    time.sleep(0.05)
    t1.start()
    t0.join(timeout=30)
    t1.join(timeout=30)
    assert len(observed) == 2
    assert all(done for _inst, done in observed)
    assert observed[0][0] is observed[1][0]


def test_init_failure_interrupts_remaining_without_raising():
    calls = []

    @init_func(order=1)
    def boom(sph):
        raise RuntimeError("nope")

    @init_func(order=2)
    def after(sph):
        calls.append("after")

    assert InitExecutor.do_init(object()) is True
    assert calls == []
    assert InitExecutor.do_init(object()) is False


@pytest.mark.parametrize("raw,want", [
    (None, 10.0), ("2.5", 2.5), ("0", 10.0), ("-1", 10.0), ("nan", 10.0),
    ("inf", 10.0), ("soon", 10.0)])
def test_init_wait_timeout_knob_matches_the_reference(monkeypatch, raw,
                                                      want):
    if raw is None:
        monkeypatch.delenv("SENTINEL_INIT_WAIT_TIMEOUT_S", raising=False)
    else:
        monkeypatch.setenv("SENTINEL_INIT_WAIT_TIMEOUT_S", raw)
    assert InitExecutor._wait_timeout_s() == want
    assert JInitExecutor._wait_timeout_s() == want


# ------------------------------------------------------------------ wiring

def test_spi_command_handler_auto_registered():
    from sentinel_tpu_torch.transport import (
        CommandCenter, CommandRequest, CommandResponse,
        register_default_handlers,
    )

    def cmd_hello(req: CommandRequest) -> CommandResponse:
        return CommandResponse.of_success("hi " + (req.param("who") or "?"))
    cmd_hello.command_name = "hello"
    cmd_hello.command_desc = "plugin-provided greeting"
    SpiLoader.of(SERVICE_COMMAND_HANDLER).register(cmd_hello)

    sph = stt.Sentinel(_cfg(), clock=ManualClock(start_ms=T0), device="cpu")
    center = CommandCenter()
    register_default_handlers(center, sph)
    resp = center.handle("hello", CommandRequest(parameters={"who": "spi"}))
    assert resp.success and resp.result == "hi spi"
    assert center.names()["hello"] == "plugin-provided greeting"
    sph.close()


def test_facade_without_a_card_raises_rather_than_using_the_cpu():
    if torch.cuda.is_available():
        assert sph_api.instance().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            sph_api.instance()


# ------------------------------------------------- processor-slot SPI twin

def _register_slots(pkg, loader):
    """A ``processor_slot`` HostGate (denies ``vip-only`` and calls whose
    first argument is 13) and DeviceSlot (denies odd acquires, counts the
    live events it saw) as class providers of ``loader``."""
    class DenyVip(pkg.HostGate):
        name = "deny-vip"

        def __init__(self):
            self.calls = 0

        def check(self, resource, origin, acquire, args):
            self.calls += 1
            return resource != "vip-only" and not (args and args[0] == 13)

    if pkg is stt:
        class OddAcquire(stt.DeviceSlot):
            name = "odd-acquire"

            def init_state(self, spec):
                return torch.zeros((), dtype=torch.int32)

            def check(self, state, view):
                seen = state + view.live.sum(dtype=torch.int32)
                return seen, (view.acquire % 2) == 0
    else:
        class OddAcquire(stpu.DeviceSlot):
            name = "odd-acquire"

            def init_state(self, spec):
                return jnp.zeros((), jnp.int32)

            def check(self, state, view):
                seen = state + jnp.sum(view.live.astype(jnp.int32))
                return seen, (view.acquire % 2) == 0

    loader.of(SERVICE_PROCESSOR_SLOT).register(OddAcquire, order=20)
    loader.of(SERVICE_PROCESSOR_SLOT).register(DenyVip, order=10)
    return DenyVip, OddAcquire


def _slot_drive(pkg, sph, clk, seed: int) -> list:
    rng = np.random.default_rng(seed)
    sph.load_flow_rules([pkg.FlowRule(resource="api", count=6.0)])
    obs = []
    names = ["api", "vip-only", "free", "api"]
    for k in range(48):
        res = names[int(rng.integers(0, len(names)))]
        acq = int(rng.integers(1, 4))
        args = (int(rng.choice([1, 13, 7])),)
        try:
            with sph.entry(res, acquire=acq, args=args):
                obs.append("pass")
        except pkg.CustomSlotException as exc:
            obs.append(("custom", exc.slot_name))
        except pkg.BlockException as exc:
            obs.append(type(exc).__name__)
        if k % 8 == 7:
            clk.advance_ms(300)
    v = sph.entry_batch(["api", "free", "vip-only", "api"] * 4,
                        acquire=[1, 2, 2, 1] * 4)
    obs.append((np.asarray(v.allow).tolist(),
                np.asarray(v.reason).tolist()))
    for name in ("api", "free", "vip-only"):
        t = sph.node_totals(name)
        t.pop("avg_rt", None)
        obs.append((name, t))
    return obs


@pytest.mark.parametrize("seed", [1, 9])
def test_processor_slot_providers_act_in_both_packages(seed):
    """The repair: ``Sentinel.__init__`` registers every
    ``processor_slot`` provider, fresh instances per Sentinel, as the
    reference runtime does."""
    got, engines, classes = {}, {}, {}
    for name, pkg, loader in (("jax", stpu, jspi.SpiLoader),
                              ("torch", stt, SpiLoader)):
        classes[name] = _register_slots(pkg, loader)
        clk = pkg.ManualClock(start_ms=T0)
        extra = {"device": "cpu"} if pkg is stt else {}
        sph = pkg.Sentinel(_cfg(pkg, host_fast_path=False), clock=clk,
                           **extra)
        gate_cls, dev_cls = classes[name]
        assert [type(g) for g in sph._host_gates] == [gate_cls]
        assert [type(d) for d in sph._device_slots] == [dev_cls]
        got[name] = _slot_drive(pkg, sph, clk, seed)
        got[name].append(sph._host_gates[0].calls)
        engines[name] = sph
    assert got["torch"] == got["jax"]
    outcomes = [o for o in got["torch"] if not isinstance(o, (tuple, int))]
    assert ("custom", "deny-vip") in got["torch"]
    assert ("custom", "odd-acquire") in got["torch"]
    assert "pass" in outcomes
    assert convert.leaf_diff(convert.to_numpy(engines["jax"]._state),
                             convert.to_numpy(engines["torch"]._state)) == []
    # fresh instances for every Sentinel of the port
    again = stt.Sentinel(_cfg(), clock=ManualClock(start_ms=T0),
                         device="cpu")
    assert again._host_gates[0] is not engines["torch"]._host_gates[0]
    assert again._device_slots[0] is not engines["torch"]._device_slots[0]
    for sph in (again, *engines.values()):
        sph.close()
