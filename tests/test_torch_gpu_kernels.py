"""The port's CUDA kernels on the card, against their plain versions.

Imports only torch, numpy and ``sentinel_tpu_torch`` (no JAX, no
``sentinel_tpu``), so it runs on a machine with a card and no JAX::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu_kernels.py

Every test is marked ``gpu`` and skips, with its reason, where
``torch.cuda.is_available()`` is false (decided inside the test). The
scatter-add kernel runs every path of ``ops.scatter_add.plan`` — global
with 32- and 64-bit index math, and shared-memory privatisation, each
reached by a shape that ``plan`` itself sends there; the event mode and
the payload instantiations (E = 1, 8, 32 and the generic one) — in int32
and float32, and is compared with ``scatter_add_reference`` and with
``np.add.at``. The streams put a quarter of their keys on 8 hot rows, so
warps with duplicate addresses take the combining branch. Tolerance:
exact.
The float32 sums stay far below 2^24, where float32 addition is exact in
any order. The cluster token step's three window records run at their
phase-11 shapes, and a whole ``ClusterEngine`` step on the card equals
the CPU engine's with 3 launches an engine call.
"""

import numpy as np
import pytest
import torch

from sentinel_tpu_torch.ops import scatter_add as sa

DTYPES = {"int32": (torch.int32, np.int32), "float32": (torch.float32,
                                                        np.float32)}
# (name, payload, E): the event mode and every payload instantiation
MODES = [("event8", False, 8), ("payload1", True, 1), ("payload8", True, 8),
         ("payload32", True, 32), ("payload5", True, 5)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _stream(rng, k, e, n, payload):
    """Keys with a hot set, padding (== k) and a -1; events with a -1;
    amounts with zeros and negatives."""
    keys = np.where(rng.random(n) < 0.25, rng.integers(0, 8, n),
                    rng.integers(0, k, n)).astype(np.int32)
    keys[::29] = k
    keys[3] = -1
    if payload:
        events = None
        amounts = rng.integers(-2, 4, (n, e)).astype(np.int32)
        amounts[rng.random((n, e)) < 0.5] = 0
    else:
        events = rng.integers(0, e, n).astype(np.int32)
        events[5] = -1
        events[7] = e                      # out of range: dropped
        amounts = rng.integers(-2, 4, n).astype(np.int32)
    return keys, events, amounts


def _numpy_add_at(table, keys, events, amounts):
    """The same function in numpy (wrap once, drop the rest, add.at)."""
    k, e = table.shape
    out = table.astype(np.float64)
    if events is None:
        n = keys.shape[0]
        keys = np.repeat(keys, e)
        events = np.tile(np.arange(e, dtype=np.int32), n)
        amounts = amounts.reshape(-1)
    key = np.where(keys < 0, keys + k, keys)
    ev = np.where(events < 0, events + e, events)
    ok = (key >= 0) & (key < k) & (ev >= 0) & (ev < e)
    np.add.at(out, (key[ok], ev[ok]), amounts[ok])
    return out.astype(table.dtype)


def _run(path, dtype, payload, e, k, n=20_000, stride_pad=3, seed=1):
    """One scatter-add through the seam on a shape that ``plan`` sends to
    ``path``, against the plain version and numpy."""
    dev = _card()
    tdt, ndt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 50, (k, e + stride_pad)).astype(ndt)
    keys, events, amounts = _stream(rng, k, e, n, payload)
    want_np = base.copy()
    want_np[:, :e] = _numpy_add_at(base[:, :e], keys, events, amounts)
    tens = [None if a is None else torch.from_numpy(a).to(dev)
            for a in (keys, events, amounts)]
    want = torch.from_numpy(base).to(dev)
    got = want.clone()
    sa.scatter_add_reference(want[:, :e], *tens)
    view = got[:, :e]
    assert sa.plan_for(view, tens[0], tens[1]).path == path
    before = sa.LAUNCHES["scatter_add"]
    sa.scatter_add(view, *tens)
    torch.cuda.synchronize()
    assert sa.LAUNCHES["scatter_add"] == before + 1
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(), want_np)


@pytest.mark.gpu
@pytest.mark.parametrize("path,k", [(sa.PATH_GLOBAL, 1 << 17),
                                    (sa.PATH_SHARED, 16)])
@pytest.mark.parametrize("mode", [m[0] for m in MODES])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_every_plan_path_matches_plain_and_numpy(dtype, mode, path, k):
    """A table too large for shared memory takes the global path; a 16-row
    table under a 20k-element stream is privatised."""
    _, payload, e = next(m for m in MODES if m[0] == mode)
    _run(path, dtype, payload, e, k)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [m[0] for m in MODES])
def test_64_bit_index_path_matches_plain(mode):
    """A view of a [2^16, 2^15] int32 table (8 GiB, 2^31 cells): ``plan``
    gives 64-bit index math, and every amount lands inside the view."""
    dev = _card()
    _, payload, e = next(m for m in MODES if m[0] == mode)
    k, stride = 1 << 16, 1 << 15
    rng = np.random.default_rng(2)
    keys, events, amounts = _stream(rng, k, e, 1 << 18, payload)
    tens = [None if a is None else torch.from_numpy(a).to(dev)
            for a in (keys, events, amounts)]
    big = torch.zeros((k, stride), dtype=torch.int32, device=dev)
    view = big[:, :e]
    assert sa.plan_for(view, tens[0], tens[1]).index_bits == 64
    want = torch.zeros((k, e), dtype=torch.int32, device=dev)
    sa.scatter_add_reference(want, *tens)
    sa.scatter_add(view, *tens)
    torch.cuda.synchronize()
    assert torch.equal(view, want)
    assert not bool(big[:, e:].any())
    np.testing.assert_array_equal(
        view.cpu().numpy(),
        _numpy_add_at(np.zeros((k, e), np.int32), keys, events, amounts))


@pytest.mark.gpu
@pytest.mark.parametrize("k,path", [(7264, sa.PATH_SHARED),
                                    (7265, sa.PATH_GLOBAL)])
def test_planned_path_at_the_shared_memory_threshold(k, path):
    """[7264, 8] int32 is exactly 232,448 bytes: the largest table the
    shared path takes (given a stream long enough for it); one row more
    takes the global path."""
    _run(path, "int32", False, 8, k, n=1 << 23, stride_pad=0)


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_the_card():
    """The seam on a CUDA tensor launches the kernel with its own plan."""
    dev = _card()
    rng = np.random.default_rng(1)
    for ndt in (np.int32, np.float32):
        k = 1 << 16
        counters = rng.integers(0, 50, (k, 8)).astype(ndt)
        keys, events, amounts = _stream(rng, k, 8, 1 << 18, False)
        want = torch.from_numpy(counters).to(dev)
        got = want.clone()
        args = [torch.from_numpy(a).to(dev) for a in (keys, events, amounts)]
        sa.scatter_add_reference(want, *args)
        before = sa.LAUNCHES["scatter_add"]
        sa.scatter_add(got, *args)
        torch.cuda.synchronize()
        assert sa.LAUNCHES["scatter_add"] == before + 1
        assert torch.equal(got, want)
        np.testing.assert_array_equal(
            got.cpu().numpy(), _numpy_add_at(counters, keys, events, amounts))


@pytest.mark.gpu
def test_one_hot_key_combines_exactly():
    """Every element on one cell: warp combining sums whole warps."""
    dev = _card()
    for tdt in (torch.int32, torch.float32):
        n = 1 << 19
        table = torch.zeros((1 << 20, 8), dtype=tdt, device=dev)
        keys = torch.full((n,), 12345, dtype=torch.int32, device=dev)
        events = torch.full((n,), 6, dtype=torch.int32, device=dev)
        amounts = torch.ones(n, dtype=torch.int32, device=dev)
        sa.scatter_add(table, keys, events, amounts)
        torch.cuda.synchronize()
        assert float(table[12345, 6]) == n
        assert float(table.sum()) == n


# ---------------------------------------------------------------------------
# The origin routes' shapes (the fast and general paths)
# ---------------------------------------------------------------------------

def _seam_equals_plain(table, view_of, keys, events, amounts):
    """One launch through the seam on ``view_of(table)`` against the plain
    version on a copy → the launch's plan."""
    want = table.clone()
    sa.scatter_add_reference(view_of(want), keys, events, amounts)
    got = table.clone()
    view = view_of(got)
    plan = sa.plan_for(view, keys, events)
    before = sa.LAUNCHES["scatter_add"]
    sa.scatter_add(view, keys, events, amounts)
    torch.cuda.synchronize()
    assert sa.LAUNCHES["scatter_add"] == before + 1
    assert torch.equal(got, want)
    return plan


@pytest.mark.gpu
def test_bucket_histogram_stream_with_its_hot_reserved_bucket():
    """The general route's counting order: 2^20 pairs, 85% of them on the
    reserved bucket 3T (one hot key), the rest spread over the 3T claim
    buckets; the histogram equals numpy's, and so does the order built
    from it."""
    from sentinel_tpu_torch.ops import sortfree as sfo
    dev = _card()
    n = 1 << 20
    t = 1 << sfo.table_bits(n)
    rng = np.random.default_rng(3)
    buckets = np.where(rng.random(n) < 0.15, rng.integers(0, 3 * t, n),
                       3 * t).astype(np.int32)
    tb = torch.from_numpy(buckets).to(dev)
    plan = _seam_equals_plain(
        torch.zeros((3 * t + 1, 1), dtype=torch.int32, device=dev),
        lambda x: x, tb, torch.zeros_like(tb), torch.ones_like(tb))
    assert plan.path == sa.PATH_GLOBAL
    hist = sfo.bucket_histogram(tb, 3 * t + 1)
    np.testing.assert_array_equal(hist.cpu().numpy(),
                                  np.bincount(buckets, minlength=3 * t + 1))
    order = sfo.counting_order(tb, 3 * t + 1).cpu().numpy()
    np.testing.assert_array_equal(order, np.argsort(buckets, kind="stable"))


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["decide", "exit", "rt_sum"])
def test_alt_slice_with_half_the_lanes_padding(what):
    """The alt table's records: 2^20 lanes (the origin half, then the
    chain half) into the current bucket of [2^21, 2, 8], half the origin
    lanes and 7/8 of the chain lanes padding (row RA)."""
    dev = _card()
    ra, half = 1 << 21, 1 << 19
    rng = np.random.default_rng(4)
    keys = rng.integers(0, ra, 2 * half).astype(np.int32)
    keys[:half][rng.random(half) < 0.5] = ra
    keys[half:][rng.random(half) < 0.875] = ra
    k = torch.from_numpy(keys).to(dev)
    if what == "rt_sum":
        table = torch.from_numpy(rng.integers(0, 50, (ra, 2)).astype(
            np.float32)).to(dev)
        plan = _seam_equals_plain(
            table, lambda t: t[:, 1:2], k, None,
            torch.from_numpy(rng.integers(1, 201, (2 * half, 1)).astype(
                np.int32)).to(dev))
    else:
        table = torch.from_numpy(rng.integers(0, 50, (ra, 2, 8)).astype(
            np.int32)).to(dev)
        if what == "decide":
            events = torch.from_numpy(rng.integers(0, 2, 2 * half).astype(
                np.int32)).to(dev)
            amounts = torch.ones(2 * half, dtype=torch.int32, device=dev)
        else:
            events = None
            amounts = torch.zeros((2 * half, 8), dtype=torch.int32,
                                  device=dev)
            amounts[:, 3] = 1
            amounts[:, 2] = torch.from_numpy(
                (rng.random(2 * half) < 0.1).astype(np.int32)).to(dev)
        plan = _seam_equals_plain(table, lambda t: t[:, 1, :], k, events,
                                  amounts)
    assert plan.path == sa.PATH_GLOBAL


@pytest.mark.gpu
def test_add_rows_hist_on_the_shared_memory_path():
    """The fast route's alt record for a small alt table (RA = 1024, the
    runtime's least; the JAX package's ``add_rows_hist`` branch) under a
    2^22-lane stream with one uniform acquire: ``plan`` privatises the
    [1024, 8] bucket slice, and the record equals the one on the CPU."""
    from sentinel_tpu_torch.stats import window as tw
    dev = _card()
    ra, n = 1024, 1 << 22
    spec = tw.WindowSpec(2, 500)
    rng = np.random.default_rng(5)
    counters = rng.integers(0, 50, (ra, 2, 8)).astype(np.int32)
    rows = rng.integers(0, ra, n).astype(np.int32)
    rows[rng.random(n) < 0.6] = ra
    ev_ids = rng.integers(0, 2, n).astype(np.int32)
    states = []
    for d in ("cpu", dev):
        st = tw.init_window(spec, ra, device=d)
        st.counters.copy_(torch.from_numpy(counters))
        r, e = (torch.from_numpy(a).to(d) for a in (rows, ev_ids))
        if d == dev:
            plan = sa.plan_for(st.counters[:, 1, :], r, e)
            assert plan.path == sa.PATH_SHARED
        tw.add_rows_multi(spec, st, r, e,
                          torch.full((n,), 3, dtype=torch.int32, device=d), 1)
        states.append(st.counters.cpu())
    torch.cuda.synchronize()
    assert torch.equal(states[0], states[1])


@pytest.mark.gpu
def test_occupy_grants_shape_on_the_card():
    """The occupy grants: a float32 ``[2^20, 1]`` table, 2^19 lanes (one a
    batch event), 1% admitted with acquire 1-3 and the rest at the padding
    key R (dropped, never wrapped); then the whole booking commit of
    ``rules/flow._book_next_window`` on the card against the CPU."""
    from sentinel_tpu_torch.rules import flow as tflow
    dev = _card()
    r, n = 1 << 20, 1 << 19
    rng = np.random.default_rng(8)
    occ = rng.random(n) < 0.01
    rows = rng.integers(0, r, n).astype(np.int32)
    acq = rng.integers(1, 4, n).astype(np.int32)
    keys = torch.from_numpy(np.where(occ, rows, r).astype(np.int32)).to(dev)
    amounts = torch.from_numpy(np.where(occ, acq, 0)[:, None].astype(
        np.int32)).to(dev)
    table = torch.zeros((r, 1), dtype=torch.float32, device=dev)
    plan = _seam_equals_plain(table, lambda t: t, keys, None, amounts)
    assert plan.path == sa.PATH_GLOBAL and plan.e_inst == 1
    ring = (rng.integers(0, 3, (r, 3)).astype(np.float32),
            (1000 + rng.integers(-2, 2, (r, 3))).astype(np.int32))
    out = []
    for d in ("cpu", dev):
        # fresh copies: the commit writes the ring in place
        dyn = tflow.init_flow_dyn(4, 2, r, device=d)._replace(
            occupied_count=torch.tensor(ring[0], device=d),
            occupied_window=torch.tensor(ring[1], device=d))
        before = sa.LAUNCHES["scatter_add"]
        tflow._book_next_window(
            dyn, torch.from_numpy(occ).to(d), torch.from_numpy(rows).to(d),
            torch.from_numpy(acq).to(d), 1000)
        if d != "cpu":
            assert sa.LAUNCHES["scatter_add"] == before + 1
        out.append((dyn.occupied_count.cpu(), dyn.occupied_window.cpu()))
    torch.cuda.synchronize()
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


@pytest.mark.gpu
@pytest.mark.parametrize("buckets", [2, 60])
def test_uncount_rows_shape_on_the_card(buckets):
    """``uncount_rows`` on the card against the CPU: negative int32
    amounts into the ``[R·B, 8]`` view of the counters (R = 2^20 for the
    second window, 2^16 for the minute window), one bucket per lane, live
    and dead buckets, padding rows."""
    from sentinel_tpu_torch.stats import window as tw
    dev = _card()
    r = (1 << 20) if buckets == 2 else (1 << 16)
    n, now = 1 << 12, 5_000_000
    spec = tw.WindowSpec(buckets, 500)
    rng = np.random.default_rng(9)
    counters = rng.integers(0, 50, (r, buckets, 8)).astype(np.int32)
    k = np.arange(buckets)
    stamps = ((now - (now - k) % buckets)[None, :] - buckets * (
        rng.random((r, buckets)) < 0.3)).astype(np.int32)
    rows = rng.integers(0, r, n).astype(np.int32)
    rows[::7] = r
    idxs = (now - rng.integers(0, buckets + 1, n)).astype(np.int32)
    amounts = rng.integers(1, 9, n).astype(np.int32)
    got = []
    for d in ("cpu", dev):
        st = tw.init_window(spec, r, device=d)
        st.counters.copy_(torch.from_numpy(counters))
        st.stamps.copy_(torch.from_numpy(stamps))
        if d != "cpu":
            view = st.counters.view(r * buckets, 8)
            keys = torch.from_numpy(rows).to(d) * buckets
            assert sa.plan_for(view, keys, keys).path == sa.PATH_GLOBAL
        tw.uncount_rows(spec, st, *(torch.from_numpy(a).to(d)
                                    for a in (rows, idxs)), 0,
                        torch.from_numpy(amounts).to(d))
        got.append(st.counters.cpu())
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1])
    assert not torch.equal(got[0], torch.from_numpy(counters))


def _param_lanes(rng, pk, n):
    """Key rows of n = B·PV pair lanes: Zipf-skewed over 61,440 rows, a
    quarter of the lanes inapplicable (the sentinel row PK)."""
    keys = (rng.zipf(1.1, n) % 61_440).astype(np.int32)
    keys[rng.random(n) < 0.25] = pk
    return keys


@pytest.mark.gpu
def test_param_token_consumption_shape_on_the_card():
    """The param check's token consumption: a float32 ``[PK+1, 1]`` table
    (PK = 2^16), N = 2^21 lanes of -acquire, a lane that consumes nothing
    at PK+1 (dropped); then the whole rank-form check on the card against
    the CPU, with exactly one kernel launch."""
    from sentinel_tpu_torch.rules import param_flow as tpf
    dev = _card()
    pk, b, pv = 1 << 16, 1 << 19, 4
    n = b * pv
    rng = np.random.default_rng(10)
    keys = _param_lanes(rng, pk, n)
    live = keys < pk
    drop = live & (rng.random(n) < 0.4)
    table = torch.from_numpy(rng.integers(0, 60, (pk + 1, 1)).astype(
        np.float32)).to(dev)
    plan = _seam_equals_plain(
        table, lambda t: t,
        torch.from_numpy(np.where(live, keys, pk + 1).astype(np.int32)).to(
            dev), None,
        torch.from_numpy(np.where(live & ~drop, -2, 0)[:, None].astype(
            np.int32)).to(dev))
    assert plan.path == sa.PATH_GLOBAL and plan.e_inst == 1
    rules = [tpf.ParamFlowRule(resource=f"r{i}", param_idx=0, count=40,
                               grade=(tpf.GRADE_THREAD if i % 8 == 7
                                      else tpf.GRADE_QPS))
             for i in range(64)]

    class Reg:
        def pin(self, name):
            return int(name[1:]) + 1
    out = []
    # a key row belongs to one rule (the registry interns per rule slot)
    k2 = keys.reshape(b, pv)
    pairs = np.where(k2 < pk, k2 % 64, 512).astype(np.int32)
    for d in ("cpu", dev):
        comp = tpf.compile_param_rules(rules, resource_registry=Reg(),
                                       capacity=512, k_per_resource=4,
                                       device=d)
        dyn = tpf.init_param_dyn(pk, device=d)
        before = sa.LAUNCHES["scatter_add"]
        dyn, ok, wait = tpf.param_check_scalar(
            comp.table, dyn, torch.from_numpy(pairs).to(d),
            torch.from_numpy(keys.reshape(b, pv)).to(d),
            torch.ones(b, dtype=torch.int32, device=d),
            torch.ones(b, dtype=torch.bool, device=d), 12_345)
        if d != "cpu":
            assert sa.LAUNCHES["scatter_add"] == before + 1
        out.append([t.cpu() for t in (ok, wait) + tuple(dyn)])
    torch.cuda.synchronize()
    for a, c in zip(*out):
        assert torch.equal(a, c)
    assert 0 < int(out[0][0].sum()) < b


@pytest.mark.gpu
def test_param_thread_update_shape_on_the_card():
    """The param THREAD gauges: int32 ``[PK+1, 1]``, N = 2^21 lanes of +1
    then -1, the lanes that do not count at the sentinel row PK with
    amount 0; on the card against the CPU, one launch each."""
    from sentinel_tpu_torch.rules import param_flow as tpf
    dev = _card()
    pk, b, pv = 1 << 16, 1 << 19, 4
    rng = np.random.default_rng(11)
    keys = _param_lanes(rng, pk, b * pv).reshape(b, pv)
    rules = [tpf.ParamFlowRule(resource=f"r{i}", count=5,
                               grade=tpf.GRADE_THREAD if i % 2 else
                               tpf.GRADE_QPS) for i in range(8)]

    class Reg:
        def pin(self, name):
            return int(name[1:])
    pairs = np.where(keys < pk, rng.integers(0, 8, (b, pv)), 8).astype(
        np.int32)
    counted = rng.random(b) < 0.7
    got = []
    for d in ("cpu", dev):
        comp = tpf.compile_param_rules(rules, resource_registry=Reg(),
                                       capacity=8, k_per_resource=8,
                                       device=d)
        dyn = tpf.init_param_dyn(pk, device=d)
        args = (torch.from_numpy(pairs).to(d), torch.from_numpy(keys).to(d))
        before = sa.LAUNCHES["scatter_add"]
        tpf.param_thread_update(comp.table, dyn, *args,
                                torch.from_numpy(counted).to(d), +1)
        up = dyn.threads.cpu().clone()       # updated in place below
        tpf.param_thread_update(comp.table, dyn, *args,
                                torch.from_numpy(counted[::-1].copy()).to(d),
                                -1)
        if d != "cpu":
            assert sa.LAUNCHES["scatter_add"] == before + 2
        got.append((up, dyn.threads.cpu()))
    torch.cuda.synchronize()
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])
    assert int(got[0][0].sum()) > 0 and int(got[0][0][pk]) == 0


@pytest.mark.gpu
def test_param_check_scalar_with_shared_key_rows_on_the_card():
    """Key rows shared by two rules within one batch (a batch that interns
    more distinct keys than rows): the bucket refresh's writers carry
    different values, and the last lane wins on the card as on the CPU."""
    from sentinel_tpu_torch.rules import param_flow as tpf
    dev = _card()
    pk, b, pv = 64, 1 << 15, 2
    rng = np.random.default_rng(12)
    rules = [tpf.ParamFlowRule(resource=f"r{i}", param_idx=0,
                               count=float(5 + 3 * i),
                               burst_count=i % 3) for i in range(8)]

    class Reg:
        def pin(self, name):
            return int(name[1:])
    pairs = rng.integers(0, 8, (b, pv)).astype(np.int32)
    keys = rng.integers(0, pk, (b, pv)).astype(np.int32)
    tokens = rng.uniform(0, 9, pk + 1).astype(np.float32)
    out = []
    for d in ("cpu", dev):
        comp = tpf.compile_param_rules(rules, resource_registry=Reg(),
                                       capacity=8, k_per_resource=8,
                                       device=d)
        dyn = tpf.init_param_dyn(pk, device=d)._replace(
            tokens=torch.from_numpy(tokens).to(d),
            last_fill_ms=torch.full((pk + 1,), 0, dtype=torch.int32,
                                    device=d))
        dyn, ok, wait = tpf.param_check_scalar(
            comp.table, dyn, torch.from_numpy(pairs).to(d),
            torch.from_numpy(keys).to(d),
            torch.ones(b, dtype=torch.int32, device=d),
            torch.ones(b, dtype=torch.bool, device=d), 2_500)
        out.append([t.cpu() for t in (ok, wait) + tuple(dyn)])
    torch.cuda.synchronize()
    for a, c in zip(*out):
        assert torch.equal(a, c)


@pytest.mark.gpu
def test_telemetry_topk_ties_and_quantiles_on_the_card():
    """The telemetry tick's ranking and quantile extraction on the card
    equal the CPU's and a stable host argsort, with thousands of tied
    loads (plain PyTorch ops, no hand kernel: ``torch.topk`` on the card
    must not pick another of the equal rows)."""
    from sentinel_tpu_torch.obs import resource_hist as rh
    from sentinel_tpu_torch.obs import telemetry as tel
    dev = _card()
    rng = np.random.default_rng(71)
    load = rng.integers(0, 4, 1 << 20).astype(np.int32)
    load[0] = -1
    for k in (1, 16, 128):
        vals, rows = tel.topk_rows(torch.from_numpy(load).to(dev), k)
        order = np.argsort(-load.astype(np.int64), kind="stable")[:k]
        assert rows.cpu().numpy().tolist() == order.tolist()
        assert vals.cpu().numpy().tolist() == load[order].tolist()
    counts = rng.integers(0, 5000, (4096, 32)).astype(np.int32)
    counts[rng.random(counts.shape) < 0.4] = 0
    got = rh.quantiles_from_counts(torch.from_numpy(counts).to(dev))
    assert np.array_equal(got.cpu().numpy(), rh.np_quantiles(counts))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [12, 20])
def test_sketch_update_and_tick_read_on_the_card(bits):
    """The tiering sketch's update (2^16 lanes, a Zipf-like hot set, a
    quarter of the lanes dead on the pad row) and its decay + estimate
    over 2^20 rows on the card equal the CPU's, exactly (plain PyTorch
    ops: the hash's logical shift and the dead lanes' spare slots must
    behave alike on both)."""
    from sentinel_tpu_torch.tiering import sketch as sk
    dev = _card()
    rng = np.random.default_rng(80 + bits)
    n, r = 1 << 16, 1 << 20
    items = np.where(rng.random(n) < 0.3, rng.integers(1, 64, n),
                     rng.integers(1, r, n)).astype(np.int32)
    valid = rng.random(n) < 0.75
    items[~valid] = r
    base = rng.integers(0, 1 << 12, (4, 1 << bits)).astype(np.int32)
    cpu, gpu = torch.from_numpy(base), torch.from_numpy(base).to(dev)
    for _ in range(3):
        cpu, _ = sk.update_sketch(cpu, torch.from_numpy(items),
                                  torch.from_numpy(valid))
        gpu, over = sk.update_sketch(gpu, torch.from_numpy(items).to(dev),
                                     torch.from_numpy(valid).to(dev))
    assert not bool(over)
    assert torch.equal(gpu.cpu(), cpu)
    c_cpu, e_cpu = sk.tick_read(cpu, r)
    c_gpu, e_gpu = sk.tick_read(gpu, r)
    assert torch.equal(c_gpu.cpu(), c_cpu) and torch.equal(e_gpu.cpu(), e_cpu)


@pytest.mark.gpu
def test_row_slice_extract_restore_round_trip_on_the_card():
    """``extract_resource_rows`` then ``restore_resource_rows`` into other
    rows on the card equal the CPU's, with repeated destination rows and
    alt slots (the last lane wins) and padding that drops; the payload
    is fresh (an invalidate after the gather is not read back)."""
    from sentinel_tpu_torch import convert
    from sentinel_tpu_torch.engine import pipeline as pl
    from sentinel_tpu_torch.stats.window import MINUTE_SPEC, WindowSpec
    dev = _card()
    spec = pl.EngineSpec(rows=1 << 14, alt_rows=1 << 15,
                         second=WindowSpec(2, 500), minute=MINUTE_SPEC,
                         statistic_max_rt=5000, hist_buckets=32)
    d = convert.to_numpy(pl.init_state(spec, 16, 8))
    rng = np.random.default_rng(91)
    for key, a in d.items():
        if a.dtype == np.int32:
            d[key] = rng.integers(-50, 5000, a.shape).astype(np.int32)
        elif a.dtype == np.float32:
            d[key] = (rng.random(a.shape) * 100).astype(np.float32)
    k = 4096
    src = rng.choice(spec.rows, k, replace=False).astype(np.int32)
    src_alt = rng.choice(spec.alt_rows, 2 * k, replace=False).astype(np.int32)
    dst = rng.integers(0, spec.rows, k).astype(np.int32)
    dst[-64:] = spec.rows                                   # padding
    dst_alt = rng.integers(0, 1024, 2 * k).astype(np.int32)  # collisions
    out = []
    for device in ("cpu", dev):
        st = convert.state_from_numpy(d, device)
        t = {name: torch.from_numpy(x).to(device) for name, x in
             (("src", src), ("src_alt", src_alt), ("dst", dst),
              ("dst_alt", dst_alt))}
        payload = pl.extract_resource_rows(spec, st, t["src"], t["src_alt"])
        keep = {key: a.copy() for key, a in
                convert.to_numpy(payload).items()}
        pl.invalidate_resource_rows(spec, st, t["src"], t["src_alt"])
        assert convert.leaf_diff(keep, convert.to_numpy(payload)) == []
        pl.restore_resource_rows(spec, st, t["dst"], payload, t["dst_alt"])
        out.append(convert.to_numpy(st))
    torch.cuda.synchronize()
    assert convert.leaf_diff(out[0], out[1]) == []


# (window rows, lanes, hot rows, seed): the cluster token step's three
# window records, each one payload launch (E = 8) into the current bucket
# slice of a 10-bucket window — the namespace window (S·NS = 32 rows, every
# lane on it), the flow window (S·L = 4096 rows, Zipf), the hot-key window
# (S·PK = 2^16 rows, B·PV = 2^18 lanes)
CLUSTER_SHAPES = {"namespace": (32, 1 << 16, 32, 21),
                  "flow": (4096, 1 << 16, 64, 22),
                  "hot_key": (1 << 16, 1 << 18, 512, 23)}


@pytest.mark.gpu
@pytest.mark.parametrize("what", sorted(CLUSTER_SHAPES))
def test_cluster_window_record_shapes_on_the_card(what):
    """A cluster step's record: int32 ``[rows, 8]`` bucket slice of a
    ``[rows, 10, 8]`` window, payload mode, a share of the lanes at the
    global pad ``rows`` (dropped, never wrapped) and zero payload rows;
    exact against the plain version."""
    dev = _card()
    rows, n, hot, seed = CLUSTER_SHAPES[what]
    rng = np.random.default_rng(seed)
    keys = np.where(rng.random(n) < 0.5, rng.integers(0, hot, n),
                    rng.integers(0, rows, n)).astype(np.int32)
    keys[rng.random(n) < 0.2] = rows
    amounts = rng.integers(0, 4, (n, 8)).astype(np.int32)
    amounts[rng.random(n) < 0.3] = 0
    table = torch.from_numpy(rng.integers(0, 50, (rows, 10, 8)).astype(
        np.int32)).to(dev)
    plan = _seam_equals_plain(
        table, lambda t: t[:, 7, :], torch.from_numpy(keys).to(dev), None,
        torch.from_numpy(amounts).to(dev))
    assert plan.e_inst == 8


@pytest.mark.gpu
def test_cluster_engine_step_on_the_card_equals_the_cpu():
    """Whole token steps (flow and param, prioritized lanes, a namespace
    at its limit) on ``ClusterEngine(device="cuda")`` against the CPU
    engine: equal verdicts and windows, 3 kernel launches a step."""
    from sentinel_tpu_torch import convert
    from sentinel_tpu_torch.parallel import cluster as tc
    dev = _card()
    spec = tc.ClusterSpec(n_shards=8, flows_per_shard=64, namespaces=4,
                          param_keys_per_shard=256)
    engines = [tc.ClusterEngine(spec, device=d) for d in ("cpu", dev)]
    out = []
    for eng in engines:
        eng.load_rules("a", [tc.ClusterFlowRule(
            flow_id=i, count=float(5 + i % 17), threshold_type=i % 2,
            max_occupy_ratio=0.5 + 0.5 * (i % 2)) for i in range(400)])
        eng.load_param_rules("b", [tc.ClusterParamFlowRule(
            flow_id=1000 + i, count=3.0) for i in range(8)])
        eng.set_connected_count("a", 3)
        eng.set_namespace_qps_limit("a", 3000)
        rng = np.random.default_rng(31)
        res, launches = [], []
        for step in range(12):
            n = 4096
            ids = (rng.zipf(1.1, n) % 420).astype(np.int64)
            before = sa.LAUNCHES["scatter_add"]
            res.append(eng.request_tokens(
                ids, rng.integers(1, 3, n), rng.random(n) < 0.125,
                now_ms=10_000_000 + 40 * step))
            res.append(eng.request_param_tokens(
                [1000 + int(i) for i in rng.integers(0, 8, 512)],
                [1] * 512, [[int(v) for v in rng.integers(0, 50, 1 + j % 4)]
                            for j in range(512)],
                now_ms=10_000_000 + 40 * step + 5))
            launches.append(sa.LAUNCHES["scatter_add"] - before)
        out.append((res, launches, convert.cluster_to_numpy(eng)))
    assert out[0][0] == out[1][0]
    assert out[0][1] == [0] * 12 and out[1][1] == [6] * 12
    assert convert.leaf_diff(out[0][2], out[1][2]) == []
