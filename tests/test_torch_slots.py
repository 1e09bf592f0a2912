"""Port parity: the processor-slot SPI (``engine/slots.py``) of
``sentinel_tpu_torch`` against ``sentinel_tpu``.

Twin runtimes (twin ManualClocks, the default configuration: host fast
path on) run the reference's scenarios (``tests/test_slots.py``): host
gates on the ``entry`` and the batch tier, a gate's own BlockException,
device slots with state, their place after the built-in slots, the fast
path turned off while one is registered, the reason-code spaces and the
registration caps. Each DeviceSlot is written twice, in ``jnp`` for the
JAX runtime and in torch for the port. Verdicts, exception types and slot
names, node totals, routes and the whole engine state (the slots' states
included) must agree exactly; every count is a small integer.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu_torch.engine import slots as tslots

from test_torch_param_flow import _twin

torch.set_num_threads(2)


def _deny_arg(pkg, bad):
    class DenyArg(pkg.HostGate):
        name = "deny-arg"

        def __init__(self):
            self.calls = 0

        def check(self, resource, origin, acquire, args):
            self.calls += 1
            return not (args and args[0] == bad)
    return DenyArg()


def _odd_acquire(pkg):
    """Denies odd acquires; counts the live events it saw."""
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
    return OddAcquire()


def _pass_cap(pkg, cap):
    """Denies an event whose row already passed ``cap`` in the rolling
    second; its state is a tuple: (denials, the largest count seen)."""
    if pkg is stt:
        class PassCap(stt.DeviceSlot):
            name = "pass-cap"

            def init_state(self, spec):
                return (torch.zeros((), dtype=torch.int32),
                        torch.zeros((), dtype=torch.float32))

            def check(self, state, view):
                ok = view.pass_counts < cap
                denied = (view.live & ~ok).sum(dtype=torch.int32)
                top = torch.where(view.live, view.pass_counts, 0.0).amax()
                return (state[0] + denied, torch.maximum(state[1], top)), ok
    else:
        class PassCap(stpu.DeviceSlot):
            name = "pass-cap"

            def init_state(self, spec):
                return (jnp.zeros((), jnp.int32), jnp.zeros((), jnp.float32))

            def check(self, state, view):
                ok = view.pass_counts < cap
                denied = jnp.sum((view.live & ~ok).astype(jnp.int32))
                top = jnp.max(jnp.where(view.live, view.pass_counts, 0.0))
                return (state[0] + denied, jnp.maximum(state[1], top)), ok
    return PassCap()


def _totals(sph, name):
    t = sph.node_totals(name)
    t.pop("avg_rt", None)
    return t


def _outcome(pkg, fn):
    try:
        fn()
        return "pass"
    except pkg.CustomSlotException as exc:
        return ("custom", exc.slot_name)
    except pkg.BlockException as exc:
        return type(exc).__name__


def _enter(sph, resource, **kw):
    def go():
        with sph.entry(resource, **kw):
            pass
    return go


# ---------------------------------------------------------------- host tier

def _sc_gate_entry(pkg, sph, clk):
    gate = _deny_arg(pkg, "bad")
    sph.register_slot(gate)
    out = [_outcome(pkg, _enter(sph, "svc", args=("ok",))),
           _outcome(pkg, _enter(sph, "svc", args=("bad",)))]
    return out + [_totals(sph, "svc"), gate.calls]


def _sc_gate_raises(pkg, sph, clk):
    class Raising(pkg.HostGate):
        name = "raising"

        def check(self, resource, origin, acquire, args):
            raise pkg.AuthorityException(resource, origin=origin)
    sph.register_slot(Raising())
    return [_outcome(pkg, _enter(sph, "svc")), _totals(sph, "svc")]


def _sc_gate_batch(pkg, sph, clk):
    sph.register_slot(_deny_arg(pkg, "bad"))
    v = sph.entry_batch(["svc"] * 3, args_list=[("ok",), ("bad",), ("ok",)])
    out = [v.allow.tolist(), v.reason.tolist()]
    # pre-interned rows: the gates get the names back
    rows = sph.intern_resources(["svc", "other"])
    v = sph.entry_batch(rows, args_list=[("bad",), ("ok",)],
                        origins=["app-a", ""])
    out += [v.allow.tolist(), v.reason.tolist()]
    return out + [_totals(sph, "svc"), _totals(sph, "other")]


def _sc_unregister_gate(pkg, sph, clk):
    gate = _deny_arg(pkg, "bad")
    sph.register_slot(gate)
    sph.unregister_slot(gate)
    return [_outcome(pkg, _enter(sph, "svc", args=("bad",))),
            _totals(sph, "svc")]


def _sc_gate_raising_in_batch(pkg, sph, clk):
    class RaisingGate(pkg.HostGate):
        name = "raising-gate"

        def check(self, resource, origin, acquire, args):
            if resource == "forbidden":
                raise pkg.AuthorityException(resource)
            return True
    sph.load_param_flow_rules([pkg.ParamFlowRule(
        resource="hot", param_idx=0, count=100)])
    sph.register_slot(RaisingGate())
    v = sph.entry_batch(["hot", "forbidden", "hot"],
                        args_list=[(1,), (2,), (3,)])
    return [v.allow.tolist(), v.reason.tolist(),
            sph.param_key_registry.live_pin_count(),
            _totals(sph, "forbidden")]


# -------------------------------------------------------------- device tier

def _sc_device_entry(pkg, sph, clk):
    sph.register_slot(_odd_acquire(pkg))
    out = [_outcome(pkg, _enter(sph, "svc", acquire=2)),
           _outcome(pkg, _enter(sph, "svc", acquire=3))]
    return out + [_totals(sph, "svc")]


def _sc_device_batch_state(pkg, sph, clk):
    sph.register_slot(_odd_acquire(pkg))
    v = sph.entry_batch(["svc"] * 4, acquire=[1, 2, 3, 4])
    return [v.allow.tolist(), v.reason.tolist(),
            int(np.asarray(sph._state.custom[0]))]


def _sc_device_after_builtin(pkg, sph, clk):
    sph.load_flow_rules([pkg.FlowRule(resource="svc", count=2.0)])
    sph.register_slot(_odd_acquire(pkg))
    v = sph.entry_batch(["svc"] * 5, acquire=[2] * 5)
    return [v.allow.tolist(), v.reason.tolist(),
            int(np.asarray(sph._state.custom[0]))]


def _sc_fast_path_off_and_back(pkg, sph, clk):
    out = [sph._fast_enabled]
    slot = _odd_acquire(pkg)
    sph.register_slot(slot)
    out.append(sph._fast_enabled)
    out.append(_outcome(pkg, _enter(sph, "free", acquire=3)))
    sph.unregister_slot(slot)
    out.append(sph._fast_enabled)
    with sph.entry("free") as e:
        out.append(e.fast)
    return out + [_totals(sph, "free")]


def _sc_code_spaces(pkg, sph, clk):
    sph.register_slot(_deny_arg(pkg, "bad"))
    sph.register_slot(_odd_acquire(pkg))
    out = [_outcome(pkg, _enter(sph, "svc", args=("bad",))),
           _outcome(pkg, _enter(sph, "svc", acquire=3))]
    return out + [sph.slot_name_for_code(int(c)) for c in (
        stpu.BlockReason.CUSTOM_GATE_BASE, stpu.BlockReason.CUSTOM_BASE,
        stpu.BlockReason.CUSTOM_BASE + 1)]


def _sc_pass_counts_slot(pkg, sph, clk):
    """A slot with a tuple state that reads the rolling PASS count,
    registered then unregistered, over several windows, beside a param
    rule and a flow rule."""
    sph.load_flow_rules([pkg.FlowRule(resource="svc", count=50.0)])
    sph.load_param_flow_rules([pkg.ParamFlowRule(resource="svc",
                                                 param_idx=0, count=3)])
    slot = _pass_cap(pkg, 4.0)
    sph.register_slot(slot)
    out = []
    rng = np.random.default_rng(8)
    for step in range(5):
        names = [("svc", "b", "c")[i] for i in rng.integers(0, 3, 24)]
        v = sph.entry_batch(names, args_list=[
            (int(k),) for k in rng.integers(0, 4, 24)])
        out.append((v.allow.tolist(), v.reason.tolist()))
        out.append(_outcome(pkg, _enter(sph, "b", args=(1,))))
        clk.advance_ms(300)
    out.append([float(np.asarray(x)) for x in sph._state.custom[0]])
    sph.unregister_slot(slot)
    out.append(_outcome(pkg, _enter(sph, "b")))
    return out + [_totals(sph, n) for n in ("svc", "b", "c")]


SCENARIOS = {
    "gate_entry": _sc_gate_entry,
    "gate_raises": _sc_gate_raises,
    "gate_batch": _sc_gate_batch,
    "unregister_gate": _sc_unregister_gate,
    "gate_raising_in_batch": _sc_gate_raising_in_batch,
    "device_entry": _sc_device_entry,
    "device_batch_state": _sc_device_batch_state,
    "device_after_builtin": _sc_device_after_builtin,
    "fast_path_off_and_back": _sc_fast_path_off_and_back,
    "code_spaces": _sc_code_spaces,
    "pass_counts_slot": _sc_pass_counts_slot,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_twin_slot_scenario(name):
    assert _twin(SCENARIOS[name], minute_enabled=True)


def test_twin_scenarios_hold_the_reference_numbers():
    gate = _twin(_sc_gate_entry)
    assert gate[:2] == ["pass", ("custom", "deny-arg")]
    assert gate[2]["pass"] == 1 and gate[2]["block"] == 1 and gate[3] == 2
    assert _twin(_sc_gate_raises)[0] == "AuthorityException"
    batch = _twin(_sc_gate_batch)
    assert batch[0] == [True, False, True]
    assert batch[1][1] == int(stt.BlockReason.CUSTOM_GATE_BASE)
    dev = _twin(_sc_device_entry)
    assert dev[:2] == ["pass", ("custom", "odd-acquire")]
    assert dev[2]["pass"] == 2 and dev[2]["block"] == 3
    st = _twin(_sc_device_batch_state)
    assert st[0] == [False, True, False, True] and st[2] == 4
    assert st[1][0] == int(stt.BlockReason.CUSTOM_BASE)
    assert _twin(_sc_device_after_builtin)[2] <= 2
    assert _twin(_sc_fast_path_off_and_back)[:5] == [
        True, False, ("custom", "odd-acquire"), True, "free"]
    assert _twin(_sc_gate_raising_in_batch)[:3] == [
        [True, False, True], [0, int(stt.BlockReason.CUSTOM_GATE_BASE), 0],
        0]


def test_slot_registration_caps_are_enforced():
    sph = stt.Sentinel(config=stt.load_config(max_resources=16),
                       clock=stt.ManualClock(), device="cpu")
    max_gates = 128 - int(stt.BlockReason.CUSTOM_GATE_BASE)
    for _ in range(max_gates):
        sph.register_slot(stt.HostGate())
    with pytest.raises(ValueError):
        sph.register_slot(stt.HostGate())
    max_dev = int(stt.BlockReason.CUSTOM_GATE_BASE) - int(
        stt.BlockReason.CUSTOM_BASE)
    for _ in range(max_dev):
        sph.register_slot(stt.DeviceSlot())
    with pytest.raises(ValueError):
        sph.register_slot(stt.DeviceSlot())
    with pytest.raises(TypeError):
        sph.register_slot(object())
    assert sph.slot_name_for_code(int(stt.BlockReason.CUSTOM_BASE)) \
        == "device-slot"


def test_run_device_slots_cascade():
    """Slots run in order on the events still live; the first denial
    names the slot's position."""
    class Deny(stt.DeviceSlot):
        def __init__(self, mask):
            self.mask = torch.tensor(mask)

        def check(self, state, view):
            return state, ~self.mask

    b = 4
    view = stt.DeviceSlotView(
        rows=torch.zeros(b, dtype=torch.int32),
        origin_ids=torch.zeros(b, dtype=torch.int32),
        acquire=torch.ones(b, dtype=torch.int32),
        is_in=torch.ones(b, dtype=torch.bool),
        prioritized=torch.zeros(b, dtype=torch.bool),
        live=torch.tensor([True, True, True, False]), now_idx_s=0,
        rel_now_ms=0, pass_counts=torch.zeros(b))
    states, ok, reason = tslots.run_device_slots(
        (Deny([True, False, False, True]), Deny([True, True, False, True])),
        ((), ()), view)
    assert ok.tolist() == [False, False, True, True]
    base = int(stt.BlockReason.CUSTOM_BASE)
    assert reason.tolist() == [base, base + 1, 0, 0]
    assert reason.dtype == torch.int8 and states == ((), ())
