"""The workload zoo: deterministic seeded traffic for the serving tier.

A copy of ``sentinel_tpu/frontend/workloads.py`` (numpy only): the same
``(name, seed, duration_ms, rate_rps, params)`` gives the same request
list in both packages (``tests/test_torch_frontend.py`` holds it).

Every generator maps ``(seed, duration_ms, rate_rps, params)`` to the
SAME request timeline on every run — arrivals come from a seeded
``numpy.random.default_rng`` Poisson process (exponential
inter-arrivals, Lewis–Shedler thinning for the time-varying shapes) —
so benchmarks/serving_bench.py numbers are reproducible and the
ci_gate.py SLO band compares like against like, and the batcher parity
test can replay the exact stream twice.

Shapes (the traffic a flow-control deployment exists for):

* ``steady`` — constant-rate Poisson over a small uniform resource set;
  the SLO-gate baseline.
* ``diurnal`` — one sinusoidal ramp across the run (trough→peak→trough),
  the slow capacity sweep.
* ``flash_crowd`` — steady baseline with a ``spike_mult``× arrival
  burst over the middle ``spike_frac`` of the run, concentrated on one
  hot resource: the shed/queue stress the no-collapse gate probes.
* ``zipf_hot`` — Zipf(s≈1.1) resource popularity over a 1M-rank
  universe (CI-sized request counts touch only the hot head, so the
  intern cache sees realistic skew, not 1M interns).
* ``priority_mix`` — steady with a prioritized slice (exercises the
  PriorityWait occupy path through the front end).
* ``slow_consumer`` — square-wave bursts well above the sustainable
  rate with idle gaps: drives the queue to its backpressure bound so
  shed behavior is observable.
* ``overload_episode`` — the round-17 composite: steady tenant +
  flash-crowd spike + slow-consumer bursts overlapping in one
  timeline (independent per-component rngs merged by arrival time);
  the overload-controller gate's episode.

All are registered in :data:`WORKLOADS`; ``make(name, ...)`` is the
lookup used by the bench and tests.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np

ZIPF_S = 1.1
ZIPF_UNIVERSE = 1_000_000

#: Largest universe the exact inverse-CDF path materializes (one f64
#: weight per rank). Above this, :func:`_zipf_ranks` switches to the
#: hybrid head-table + continuous-tail sampler so a 64M-key universe
#: (the round-15 tiering gate) costs O(head), not O(universe), memory.
ZIPF_EXACT_MAX = 1_000_000
_ZIPF_HEAD = 1 << 16


def _zipf_ranks(rng, n: int, s: float, universe: int) -> np.ndarray:
    """``n`` Zipf(s) ranks in ``[1, universe]``.

    ``universe <= ZIPF_EXACT_MAX``: exact inverse-CDF over the full
    materialized weight vector — bit-identical to the pre-round-15
    generator, so recorded bench baselines stay comparable.

    Larger universes: the first ``_ZIPF_HEAD`` ranks keep their exact
    discrete CDF (the head is where all the probability mass and all
    the hot-tier behavior live); the tail is drawn from the continuous
    power-law surrogate on ``[head+1, universe+1)`` via closed-form
    inverse CDF ``x = (u·(b^(1-s) − a^(1-s)) + a^(1-s))^(1/(1-s))``
    and floored to a rank. Nothing of size ``universe`` is ever
    allocated, and tail ranks stay long-tailed (a CI-sized run sees
    nearly every tail draw as a first-sight key — exactly the cold
    traffic the tiering gate needs)."""
    if universe <= ZIPF_EXACT_MAX:
        weights = 1.0 / np.power(
            np.arange(1, universe + 1, dtype=np.float64), s)
        cdf = np.cumsum(weights)
        cdf /= cdf[-1]
        return np.searchsorted(cdf, rng.random(n), side="right") + 1
    head = _ZIPF_HEAD
    head_cdf = np.cumsum(
        1.0 / np.power(np.arange(1, head + 1, dtype=np.float64), s))
    head_mass = head_cdf[-1]
    a, b = float(head + 1), float(universe + 1)
    one_m_s = 1.0 - s
    tail_mass = (b ** one_m_s - a ** one_m_s) / one_m_s
    u = rng.random(n) * (head_mass + tail_mass)
    ranks = np.empty(n, np.int64)
    in_head = u < head_mass
    ranks[in_head] = np.searchsorted(
        head_cdf, u[in_head], side="right") + 1
    ut = (u[~in_head] - head_mass) / tail_mass
    x = (ut * (b ** one_m_s - a ** one_m_s)
         + a ** one_m_s) ** (1.0 / one_m_s)
    ranks[~in_head] = np.minimum(
        np.floor(x).astype(np.int64), universe)
    return ranks


class Request(NamedTuple):
    """One scheduled request: fire at ``t_ms`` after stream start."""

    t_ms: float
    resource: str
    count: int
    prioritized: bool
    origin: str


def _arrivals(rng, duration_ms: float, rate_rps: float,
              intensity: Optional[Callable[[float], float]] = None,
              peak_mult: float = 1.0) -> List[float]:
    """Poisson arrival times in ``[0, duration_ms)``.

    Homogeneous at ``rate_rps`` when ``intensity`` is None; otherwise
    Lewis–Shedler thinning: candidates are drawn at the peak rate
    ``rate_rps * peak_mult`` and kept with probability
    ``intensity(t) / peak_mult`` (``intensity`` is the rate multiplier
    at time t, in ``[0, peak_mult]``)."""
    lam = (rate_rps * peak_mult) / 1000.0       # candidates per ms
    if lam <= 0:
        return []
    out: List[float] = []
    t = rng.exponential(1.0 / lam)
    while t < duration_ms:
        if intensity is None or rng.random() * peak_mult <= intensity(t):
            out.append(t)
        t += rng.exponential(1.0 / lam)
    return out


def _uniform_resources(rng, n_arrivals: int, n_resources: int,
                       prefix: str) -> List[str]:
    picks = rng.integers(0, n_resources, size=n_arrivals)
    return [f"{prefix}{int(i)}" for i in picks]


def steady(seed: int, duration_ms: float = 1000.0,
           rate_rps: float = 2000.0, n_resources: int = 16) -> List[Request]:
    """Constant-rate Poisson, uniform over ``n_resources`` resources."""
    rng = np.random.default_rng(seed)
    ts = _arrivals(rng, duration_ms, rate_rps)
    names = _uniform_resources(rng, len(ts), n_resources, "steady/")
    return [Request(t, r, 1, False, "") for t, r in zip(ts, names)]


def diurnal(seed: int, duration_ms: float = 1000.0,
            rate_rps: float = 2000.0, n_resources: int = 16,
            trough: float = 0.2) -> List[Request]:
    """One full day compressed into the run: sinusoidal rate between
    ``trough``× and 1× the nominal rate (trough at both ends)."""
    rng = np.random.default_rng(seed)
    span = 1.0 - trough

    def intensity(t: float) -> float:
        phase = (1.0 - math.cos(2.0 * math.pi * t / duration_ms)) / 2.0
        return trough + span * phase

    ts = _arrivals(rng, duration_ms, rate_rps, intensity, peak_mult=1.0)
    names = _uniform_resources(rng, len(ts), n_resources, "diurnal/")
    return [Request(t, r, 1, False, "") for t, r in zip(ts, names)]


def flash_crowd(seed: int, duration_ms: float = 1000.0,
                rate_rps: float = 2000.0, n_resources: int = 16,
                spike_mult: float = 8.0, spike_start: float = 0.4,
                spike_end: float = 0.6,
                hot_frac: float = 0.8) -> List[Request]:
    """Steady baseline with a ``spike_mult``× burst over the middle
    ``[spike_start, spike_end)`` fraction of the run; during the spike,
    ``hot_frac`` of requests hit ONE hot resource."""
    rng = np.random.default_rng(seed)
    lo, hi = spike_start * duration_ms, spike_end * duration_ms

    def intensity(t: float) -> float:
        return spike_mult if lo <= t < hi else 1.0

    ts = _arrivals(rng, duration_ms, rate_rps, intensity,
                   peak_mult=spike_mult)
    names = _uniform_resources(rng, len(ts), n_resources, "flash/")
    hot = rng.random(len(ts))
    out = []
    for i, t in enumerate(ts):
        r = names[i]
        if lo <= t < hi and hot[i] < hot_frac:
            r = "flash/hot"
        out.append(Request(t, r, 1, False, ""))
    return out


def zipf_hot(seed: int, duration_ms: float = 1000.0,
             rate_rps: float = 2000.0, s: float = ZIPF_S,
             universe: int = ZIPF_UNIVERSE) -> List[Request]:
    """Zipf(s) popularity over ``universe`` ranks: rank k drawn with
    probability ∝ 1/k^s via inverse-CDF, so the head is hot and the
    tail is long (a CI-sized run touches only a few hundred distinct
    resources out of the default 1M universe). ``universe`` scales to
    the tens of millions without materializing a key list — see
    :func:`_zipf_ranks`."""
    rng = np.random.default_rng(seed)
    ts = _arrivals(rng, duration_ms, rate_rps)
    ranks = _zipf_ranks(rng, len(ts), s, universe)
    return [Request(t, f"zipf/r{int(k)}", 1, False, "")
            for t, k in zip(ts, ranks)]


def priority_mix(seed: int, duration_ms: float = 1000.0,
                 rate_rps: float = 2000.0, n_resources: int = 8,
                 prio_frac: float = 0.2) -> List[Request]:
    """Steady traffic where ``prio_frac`` of requests are prioritized
    (PriorityWait occupy path) and carry a distinct origin."""
    rng = np.random.default_rng(seed)
    ts = _arrivals(rng, duration_ms, rate_rps)
    names = _uniform_resources(rng, len(ts), n_resources, "prio/")
    prio = rng.random(len(ts)) < prio_frac
    return [Request(t, r, 1, bool(p), "gold" if p else "bronze")
            for t, r, p in zip(ts, names, prio)]


def slow_consumer(seed: int, duration_ms: float = 1000.0,
                  rate_rps: float = 2000.0, n_resources: int = 4,
                  burst_mult: float = 16.0, period_ms: float = 200.0,
                  duty: float = 0.25) -> List[Request]:
    """Square-wave bursts at ``burst_mult``× nominal for ``duty`` of
    each ``period_ms``, silence otherwise — offered load far above the
    sustainable rate, so the ingest queue hits ``queue_max`` and sheds
    (the backpressure probe)."""
    rng = np.random.default_rng(seed)

    def intensity(t: float) -> float:
        return burst_mult if (t % period_ms) < duty * period_ms else 0.0

    ts = _arrivals(rng, duration_ms, rate_rps, intensity,
                   peak_mult=burst_mult)
    names = _uniform_resources(rng, len(ts), n_resources, "slow/")
    return [Request(t, r, 1, False, "") for t, r in zip(ts, names)]


def overload_episode(seed: int, duration_ms: float = 1000.0,
                     rate_rps: float = 2000.0, n_resources: int = 16,
                     steady_frac: float = 0.5, spike_mult: float = 8.0,
                     spike_start: float = 0.3, spike_end: float = 0.6,
                     hot_frac: float = 0.8, burst_mult: float = 16.0,
                     burst_period_ms: float = 200.0,
                     burst_duty: float = 0.25,
                     burst_frac: float = 0.25) -> List[Request]:
    """The round-17 controller-gate composite: a steady tenant that
    must keep its SLO, PLUS a flash-crowd spike on one hot resource,
    PLUS slow-consumer square-wave bursts — all three overlapping in
    one timeline. Component streams draw from independent seeded rngs
    (``seed``, ``seed+1``, ``seed+2``) and merge sorted by arrival
    time, so each component is individually deterministic and the
    composite replays exactly. The steady slice keeps the ``steady/``
    prefix — the gate scores ITS latency under the other two's abuse."""
    parts: List[Request] = []
    parts.extend(steady(seed, duration_ms,
                        rate_rps * steady_frac, n_resources))
    parts.extend(flash_crowd(
        seed + 1, duration_ms,
        rate_rps * max(0.0, 1.0 - steady_frac - burst_frac),
        n_resources, spike_mult, spike_start, spike_end, hot_frac))
    parts.extend(slow_consumer(
        seed + 2, duration_ms, rate_rps * burst_frac,
        max(1, n_resources // 4), burst_mult, burst_period_ms,
        burst_duty))
    parts.sort(key=lambda r: (r.t_ms, r.resource))
    return parts


#: name → generator; every generator is ``f(seed, duration_ms,
#: rate_rps, **shape_params) -> List[Request]`` and fully deterministic
#: for a given argument tuple.
WORKLOADS: Dict[str, Callable[..., List[Request]]] = {
    "steady": steady,
    "diurnal": diurnal,
    "flash_crowd": flash_crowd,
    "zipf_hot": zipf_hot,
    "priority_mix": priority_mix,
    "slow_consumer": slow_consumer,
    "overload_episode": overload_episode,
}


def make(name: str, seed: int, **kwargs) -> List[Request]:
    """Generate workload ``name`` (see :data:`WORKLOADS`)."""
    try:
        fn = WORKLOADS[name]
    except KeyError:
        raise KeyError(
            f"unknown workload {name!r}; have {sorted(WORKLOADS)}") from None
    return fn(seed, **kwargs)
