"""Port parity: request-scoped tracing (``obs/spans.py`` causal links,
``obs/flight.py``, ``obs/traceexport.py``) of ``sentinel_tpu_torch``
against ``sentinel_tpu``.

The reference's scenarios of ``tests/test_tracing.py`` that need neither
the dispatch pipeline nor the serving front end (those wait for ROADMAP
A9) run on both packages' modules under twin ManualClocks; the port's
results must equal the reference's.
"""

import json

import pytest

import sentinel_tpu as stpu
import sentinel_tpu_torch as stt
from sentinel_tpu.obs import RuntimeObs as JObs
from sentinel_tpu.obs import counters as jck
from sentinel_tpu.obs import spans as jspans
from sentinel_tpu.obs import traceexport as jexport
from sentinel_tpu_torch.obs import RuntimeObs as TObs
from sentinel_tpu_torch.obs import counters as ck
from sentinel_tpu_torch.obs import spans as tspans
from sentinel_tpu_torch.obs import traceexport as texport

T0 = 1_785_000_000_000
MODS = {"jax": dict(pkg=stpu, obs=JObs, spans=jspans, export=jexport,
                    ck=jck),
        "torch": dict(pkg=stt, obs=TObs, spans=tspans, export=texport,
                      ck=ck)}


def both(fn):
    """``fn(modules, clock)`` on both packages → the port's result, which
    must equal the reference's."""
    out = {name: fn(m, m["pkg"].ManualClock(start_ms=T0))
           for name, m in MODS.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


def test_causal_closure_isolates_siblings():
    def run(m, clk):
        sp = m["spans"]
        rec = sp.SpanRecorder.for_clock(clk)
        req_a, req_b, batch = rec.mint(), rec.mint(), rec.mint()
        ns = rec.now_ns()
        rec.record(req_a, "frontend.enqueue", ns, ns)
        rec.record(req_b, "frontend.enqueue", ns, ns)
        rec.link(req_a, batch, sp.LINK_FLUSH)
        rec.link(req_b, batch, sp.LINK_FLUSH)
        rec.record(batch, "frontend.flush", ns, ns, n=2)
        rec.link(batch, req_a, sp.LINK_VERDICT)
        rec.link(batch, req_b, sp.LINK_VERDICT)
        rec.record(req_a, "frontend.settle", ns, ns)
        rec.record(req_b, "frontend.settle", ns, ns)
        out = (req_a, req_b, batch, rec.causal(req_a), rec.causal(batch))
        rec.close()
        return out

    req_a, req_b, batch, ca, cb = both(run)
    assert {s["trace"] for s in ca["spans"]} == {req_a, batch}
    assert {(ln["src"], ln["dst"]) for ln in ca["links"]} == {
        (req_a, batch), (batch, req_a)}
    assert {s["trace"] for s in cb["spans"]} == {req_a, req_b, batch}


def test_mint_bypasses_sampling_stride():
    def run(m, clk):
        rec = m["spans"].SpanRecorder.for_clock(clk, sample=0.01)
        out = [rec.maybe_trace(), rec.maybe_trace(), rec.mint()]
        rec.enabled = False
        out.append(rec.mint())
        rec.close()
        return out

    first, second, minted, off = both(run)
    assert first > 0 and second == 0 and minted > 0 and off == 0


def test_flight_rootless_trigger_pins_window_and_payload():
    def run(m, clk):
        obs = m["obs"](clock=clk)
        tr = obs.spans.mint()
        ns = obs.spans.now_ns()
        obs.spans.record(tr, "frontend.enqueue", ns, ns)
        fired = obs.flight.trigger("block_burst", note="blocks_1s>=512")
        recs = obs.flight.snapshot(full=True)
        meta = obs.payload()["flight"]
        counters = obs.counters.snapshot()
        obs.close()
        return tr, fired, recs, meta, counters

    tr, fired, recs, meta, counters = both(run)
    assert fired and recs and recs[-1]["root"] == tr
    assert meta["active"] and meta["pinned"][-1]["kind"] == "block_burst"
    assert counters[ck.FLIGHT_PINNED] == 1


def test_flight_disable_env(monkeypatch):
    monkeypatch.setenv("SENTINEL_FLIGHT_DISABLE", "1")

    def run(m, clk):
        obs = m["obs"](clock=clk)
        out = (obs.flight.active, obs.flight.trigger("deadline_miss",
                                                     root=1))
        obs.close()
        return out

    assert both(run) == (False, False)


def test_chrome_trace_export_json_roundtrip():
    def run(m, clk):
        sp = m["spans"]
        rec = sp.SpanRecorder.for_clock(clk)
        req, batch = rec.mint(), rec.mint()
        t = rec.now_ns()
        rec.record(req, "frontend.enqueue", t, t + 2_000_000)
        rec.link(req, batch, sp.LINK_FLUSH)
        clk.advance_ms(5)
        t2 = rec.now_ns()
        rec.record(batch, "frontend.flush", t2, t2 + 1_000_000, n=3)
        text = m["export"].dumps(m["export"].export_chain(rec, req))
        rec.close()
        return req, t, text

    req, t, text = both(run)
    doc = json.loads(text)
    events = doc["traceEvents"]
    assert doc["otherData"]["root"] == req
    assert doc["displayTimeUnit"] == "ms"
    x = [e for e in events if e["ph"] == "X"]
    assert {e["name"] for e in x} == {"frontend.enqueue", "frontend.flush"}
    enq = next(e for e in x if e["name"] == "frontend.enqueue")
    assert enq["ts"] == t / 1000.0 and enq["dur"] == 2000.0
    starts = [e for e in events if e["ph"] == "s"]
    finishes = [e for e in events if e["ph"] == "f"]
    assert len(starts) == len(finishes) == 1
    assert starts[0]["id"] == finishes[0]["id"]
    assert finishes[0]["bp"] == "e"
    assert starts[0]["name"] == "link." + tspans.LINK_FLUSH


def test_chrome_trace_tolerates_zero_duration_manual_spans():
    def run(m, clk):
        rec = m["spans"].SpanRecorder.for_clock(clk)
        tr = rec.mint()
        ns = rec.now_ns()
        rec.record(tr, "instant", ns, ns)
        doc = m["export"].export_chain(rec, tr)
        rec.close()
        return doc

    doc = both(run)
    assert doc["traceEvents"][0]["dur"] > 0


def test_span_ring_wrap_counter():
    def run(m, clk):
        obs = m["obs"](clock=clk)
        tr = obs.spans.mint()
        cap = obs.spans.capacity
        for _ in range(cap + 3):
            obs.spans.record(tr, "x", 0, 1)
        out = (cap, obs.counters.get(m["ck"].SPAN_RING_WRAP))
        obs.close()
        return out

    cap, wraps = both(run)
    assert wraps == 3 and cap > 0


@pytest.mark.parametrize("kind", ["deadline_miss", "shed", "p99",
                                  "block_burst"])
def test_flight_trigger_kinds_rate_limited_per_window(kind):
    """Each trigger kind pins once per window and counts under its own
    ``flight.trigger.<kind>`` key, alike in both packages."""
    def run(m, clk):
        obs = m["obs"](clock=clk)
        tr = obs.spans.mint()
        ns = obs.spans.now_ns()
        obs.spans.record(tr, "frontend.enqueue", ns, ns)
        fired = [obs.flight.trigger(kind, root=tr, worst_ms=7.0),
                 obs.flight.trigger(kind, root=tr)]
        clk.advance_ms(obs.flight.window_ms + 1)
        fired.append(obs.flight.trigger(kind, root=tr))
        out = (fired, obs.flight.snapshot(full=True),
               obs.counters.snapshot())
        obs.close()
        return out

    fired, recs, counters = both(run)
    assert fired == [True, False, True]
    assert counters[ck.FLIGHT_TRIGGER_PREFIX + kind] == 2
    assert recs[0]["kind"] == kind
