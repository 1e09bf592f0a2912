"""Port parity: ``sentinel_tpu_torch.stats.window`` against
``sentinel_tpu.stats.window``.

Each ported window function gets the same numpy-seeded state and
arguments in both packages; results and the updated state must be equal
bit for bit (int32 leaves exactly; the float32 ``rt_sum`` leaves hold
integer values whose sums stay below 2^24, where float32 addition is
exact in any order). The wrapped-stamp cases pin the int32
two's-complement window arithmetic.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sentinel_tpu.stats import window as jw
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.stats import window as tw

torch.set_num_threads(2)

INT32_MAX = 2 ** 31 - 1
R = 40
# now_idx values: ordinary, near the int32 top (now+1 wraps), at the int32
# bottom (now-1 wraps), and the wrapped-stamp case against NEVER
NOWS = [1_000, INT32_MAX - 1, INT32_MAX, -(2 ** 31), -(2 ** 31) + 1]


def _spec(b, track=True):
    return jw.WindowSpec(b, 500, track), tw.WindowSpec(b, 500, track)


def _state(rng, b, now, track=True):
    """Random window state around ``now``: live, stale, future and NEVER
    stamps (all int32 differences, wrapping where ``now`` is extreme)."""
    off = rng.integers(-4, 2, (R, b))
    stamps = ((now + off + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    stamps[rng.random((R, b)) < 0.2] = np.int32(jw.NEVER)
    b_rt = b if track else 0
    return {
        "counters": rng.integers(0, 1000, (R, b, 8)).astype(np.int32),
        "stamps": stamps,
        "rt_sum": rng.integers(0, 5000, (R, b_rt)).astype(np.float32),
        "min_rt": rng.integers(0, 300, (R, b_rt)).astype(np.int32),
    }


def _jax_ws(d):
    return jw.WindowState(**{k: jnp.asarray(v) for k, v in d.items()})


def _port_ws(d):
    return tw.WindowState(**{k: torch.from_numpy(v.copy())
                             for k, v in d.items()})


def _same(jax_tree, port_tree):
    a, b = convert.to_numpy(jax_tree), convert.to_numpy(port_tree)
    assert convert.leaf_diff(a, b) == []


def _rows(rng, n=64):
    """Rows with duplicates, padding (== R) and a negative row."""
    rows = rng.integers(0, R, n).astype(np.int32)
    rows[::7] = R
    rows[3] = -1
    return rows


def test_index_of_matches():
    js, ts = _spec(2)
    for now in (0, 499, 500, 1_785_000_000_000, 2 ** 40 + 123, 2 ** 42):
        assert ts.index_of(now) == js.index_of(now)
    jm, tm = jw.MINUTE_SPEC, tw.MINUTE_SPEC
    assert (tm.buckets, tm.win_ms, tm.track_rt) == (
        jm.buckets, jm.win_ms, jm.track_rt)


@pytest.mark.parametrize("b,track", [(2, True), (60, True), (1, False)])
def test_init_window(b, track):
    js, ts = _spec(b, track)
    _same(jw.init_window(js, R), tw.init_window(ts, R))


@pytest.mark.parametrize("now", NOWS)
def test_reads(now):
    rng = np.random.default_rng(abs(now) % 1000)
    js, ts = _spec(2)
    d = _state(rng, 2, now)
    jst, tst = _jax_ws(d), _port_ws(d)
    rows = rng.integers(0, R, 50).astype(np.int32)
    jrows, trows = jnp.asarray(rows), torch.from_numpy(rows)
    jn = jnp.int32(now)
    pairs = [
        (jw.valid_mask(js, jst.stamps, jn), tw.valid_mask(ts, tst.stamps, now)),
        (jw.window_sum_rows(js, jst, jrows, 0, jn),
         tw.window_sum_rows(ts, tst, trows, 0, now)),
        (jw.prev_window_sum_rows(js, jst, jrows, 0, jn),
         tw.prev_window_sum_rows(ts, tst, trows, 0, now)),
        (jw.rolling_totals(js, jst, jn), tw.rolling_totals(ts, tst, now)),
        (jw.rt_totals(js, jst, jn), tw.rt_totals(ts, tst, now)),
        (jw.min_rt_rows(js, jst, jrows, jn, 5000),
         tw.min_rt_rows(ts, tst, trows, now, 5000)),
    ]
    for want, got in pairs:
        want = np.asarray(want)
        got = got.numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_wrapped_stamp_against_never():
    """NEVER = -2^30 read at now near 2^31-1: the int32 difference wraps
    negative, so the bucket reads as dead in both packages."""
    js, ts = _spec(2)
    now = INT32_MAX - 5
    d = {"counters": np.ones((1, 2, 8), np.int32),
         "stamps": np.array([[jw.NEVER, now]], np.int32),
         "rt_sum": np.zeros((1, 2), np.float32),
         "min_rt": np.zeros((1, 2), np.int32)}
    want = np.asarray(jw.valid_mask(js, jnp.asarray(d["stamps"]),
                                    jnp.int32(now)))
    got = tw.valid_mask(ts, torch.from_numpy(d["stamps"]), now).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.tolist() == [[False, True]]


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("now", NOWS[:3])
def test_refresh_rows(b, now):
    """Duplicates, padding rows (== R) and a negative row; B=1 is the
    configuration whose engine refresh takes this path."""
    rng = np.random.default_rng(b * 17 + now % 97)
    js, ts = _spec(b)
    d = _state(rng, b, now)
    rows = _rows(rng)
    want = jw.refresh_rows(js, _jax_ws(d), jnp.asarray(rows), jnp.int32(now))
    got = tw.refresh_rows(ts, _port_ws(d), torch.from_numpy(rows), now)
    _same(want, got)


@pytest.mark.parametrize("now", NOWS)
def test_refresh_all(now):
    rng = np.random.default_rng(5 + now % 101)
    js, ts = _spec(2)
    d = _state(rng, 2, now)
    want = jw.refresh_all(js, _jax_ws(d), jnp.int32(now))
    got = tw.refresh_all(ts, _port_ws(d), now)
    _same(want, got)


def test_refresh_all_rejects_one_bucket():
    _, ts = _spec(1)
    with pytest.raises(ValueError):
        tw.refresh_all(ts, tw.init_window(ts, 4), 10)


@pytest.mark.parametrize("now", [1_000, INT32_MAX, -(2 ** 31)])
def test_adds(now):
    rng = np.random.default_rng(now % 89)
    js, ts = _spec(2)
    d = _state(rng, 2, now)
    rows = _rows(rng)
    n = rows.shape[0]
    ev_ids = rng.integers(0, 8, n).astype(np.int32)
    amounts = rng.integers(0, 5, n).astype(np.int32)
    payload = rng.integers(0, 3, (n, 8)).astype(np.int32)
    rt = rng.integers(0, 400, n).astype(np.int32)
    rt_valid = rng.random(n) > 0.3
    vec = rng.integers(0, 9, 8).astype(np.int32)
    jn = jnp.int32(now)
    J = {k: jnp.asarray(v) for k, v in dict(
        rows=rows, ev=ev_ids, amt=amounts, pay=payload, rt=rt,
        rtv=rt_valid, vec=vec).items()}
    T = {k: torch.from_numpy(v) for k, v in dict(
        rows=rows, ev=ev_ids, amt=amounts, pay=payload, rt=rt,
        rtv=rt_valid, vec=vec).items()}

    _same(jw.add_rows_multi(js, _jax_ws(d), J["rows"], J["ev"], J["amt"], jn),
          tw.add_rows_multi(ts, _port_ws(d), T["rows"], T["ev"], T["amt"],
                            now))
    _same(jw.add_rows(js, _jax_ws(d), J["rows"], 3, J["amt"], jn,
                      rt_ms=J["rt"]),
          tw.add_rows(ts, _port_ws(d), T["rows"], 3, T["amt"], now,
                      rt_ms=T["rt"]))
    _same(jw.add_rows_vec(js, _jax_ws(d), J["rows"], J["pay"], jn,
                          rt_ms=J["rt"], rt_valid=J["rtv"]),
          tw.add_rows_vec(ts, _port_ws(d), T["rows"], T["pay"], now,
                          rt_ms=T["rt"], rt_valid=T["rtv"]))
    _same(jw.add_rows_vec(js, _jax_ws(d), J["rows"], J["pay"], jn),
          tw.add_rows_vec(ts, _port_ws(d), T["rows"], T["pay"], now))
    _same(jw.add_one_row(js, _jax_ws(d), 0, J["vec"], jn,
                         rt_add=jnp.float32(17.0), rt_min=jnp.int32(3)),
          tw.add_one_row(ts, _port_ws(d), 0, T["vec"], now,
                         rt_add=torch.tensor(17.0), rt_min=torch.tensor(3)))


@pytest.mark.parametrize("fn", ["add_rows", "add_rows_vec"])
@pytest.mark.parametrize("b", [2, 60])
def test_rt_sum_goes_through_the_kernel_seam(monkeypatch, fn, b):
    """``rt_sum[:, k] += rt`` is one call of the scatter-add seam on the
    float32 ``[R, 1]`` column view (row stride B) with int32 amounts, and
    the result equals the JAX package's bit for bit. The rows hold
    duplicates, padding (R and beyond) and a -1 (wraps to R-1); every
    bucket's sum stays below 2^24, where float32 addition is exact in any
    order. b = 60 is the minute window's geometry."""
    from sentinel_tpu_torch.ops import scatter_add as sa
    calls = []
    real = sa.scatter_add

    def spy(counters, keys, events, amounts):
        calls.append((counters.dtype, tuple(counters.shape),
                      counters.stride(), counters.data_ptr(),
                      events is None, amounts.dtype))
        return real(counters, keys, events, amounts)

    monkeypatch.setattr(sa, "scatter_add", spy)
    now = 1_000 + b
    rng = np.random.default_rng(31 + b)
    js, ts = _spec(b)
    d = _state(rng, b, now)
    rows = _rows(rng, 200)
    rows[::11] = R + 5
    rows[1] = -1
    rows[2:6] = 7
    n = rows.shape[0]
    rt = rng.integers(1, 201, n).astype(np.int32)
    rt_valid = rng.random(n) > 0.25
    pay = rng.integers(0, 3, (n, 8)).astype(np.int32)
    tst = _port_ws(d)
    if fn == "add_rows":
        want = jw.add_rows(js, _jax_ws(d), jnp.asarray(rows), 3,
                           jnp.asarray(pay[:, 0]), jnp.int32(now),
                           rt_ms=jnp.asarray(rt))
        got = tw.add_rows(ts, tst, torch.from_numpy(rows), 3,
                          torch.from_numpy(pay[:, 0]), now,
                          rt_ms=torch.from_numpy(rt))
    else:
        want = jw.add_rows_vec(js, _jax_ws(d), jnp.asarray(rows),
                               jnp.asarray(pay), jnp.int32(now),
                               rt_ms=jnp.asarray(rt),
                               rt_valid=jnp.asarray(rt_valid))
        got = tw.add_rows_vec(ts, tst, torch.from_numpy(rows),
                              torch.from_numpy(pay), now,
                              rt_ms=torch.from_numpy(rt),
                              rt_valid=torch.from_numpy(rt_valid))
    _same(want, got)
    k = now % b
    col = (torch.float32, (R, 1), (b, 1),
           tst.rt_sum[:, k].data_ptr(), True, torch.int32)
    assert calls.count(col) == 1, calls
    assert np.asarray(want.rt_sum).max() < 2 ** 24


def test_invalidate_rows():
    rng = np.random.default_rng(4)
    js, ts = _spec(2)
    d = _state(rng, 2, 1_000)
    rows = _rows(rng, 10)
    _same(jw.invalidate_rows(js, _jax_ws(d), jnp.asarray(rows)),
          tw.invalidate_rows(ts, _port_ws(d), torch.from_numpy(rows)))


def test_rt_histogram_bucket_geometry():
    from sentinel_tpu.obs import resource_hist as jh
    from sentinel_tpu_torch.obs import resource_hist as th
    rt = np.array([-5, 0, 1, 2, 3, 4, 5, 999, 1 << 29, (1 << 30) + 1,
                   INT32_MAX], np.int32)
    for hb in (8, 20, 32):
        np.testing.assert_array_equal(th.bucket_thresholds_ms(hb),
                                      jh.bucket_thresholds_ms(hb))
        np.testing.assert_array_equal(
            th.bucket_index(torch.from_numpy(rt), hb).numpy(),
            np.asarray(jh.bucket_index(jnp.asarray(rt), hb)))
    assert th.engine_hist_buckets() == jh.engine_hist_buckets()
