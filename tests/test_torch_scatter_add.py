"""Port parity: ``sentinel_tpu_torch.ops.scatter_add`` against the JAX
package's scatter-add (``scatter_add_xla`` and the Pallas MXU kernel in
interpret mode).

On the CPU the seam runs the kernel's plain PyTorch version (the CUDA
kernel itself is compared with it on the card: the ``gpu`` tests of
``tests/test_torch_gpu_kernels.py`` and ``chip_smoke.py``). The launch
plan is pure Python and is tested here. Tolerance: exact. The float32
cases keep every sum far below 2^24, where float32 accumulation is exact
in any order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sentinel_tpu.ops.pallas_kernels import scatter_add_pallas, scatter_add_xla
from sentinel_tpu_torch.ops import scatter_add as sa
from sentinel_tpu_torch.ops import sortfree as sfo

torch.set_num_threads(2)


def _random_case(rng, k=512, e=8, n=256, hot=False, dtype=np.float32):
    counters = rng.integers(0, 50, (k, e)).astype(dtype)
    if hot:
        keys = rng.choice([3, 7, k - 1], n).astype(np.int32)
    else:
        keys = rng.integers(0, k, n).astype(np.int32)
    events = rng.integers(0, e, n).astype(np.int32)
    amounts = rng.integers(1, 5, n).astype(np.int32)
    return counters, keys, events, amounts


def _port(counters, keys, events, amounts):
    t = torch.from_numpy(counters.copy())
    out = sa.scatter_add(t, torch.from_numpy(keys),
                         None if events is None else torch.from_numpy(events),
                         torch.from_numpy(amounts))
    assert out is t                      # in place
    return t.numpy()


def _xla(counters, keys, events, amounts):
    return np.asarray(scatter_add_xla(jnp.asarray(counters),
                                      jnp.asarray(keys), jnp.asarray(events),
                                      jnp.asarray(amounts)))


def _pallas(counters, keys, events, amounts):
    return np.asarray(scatter_add_pallas(
        jnp.asarray(counters), jnp.asarray(keys), jnp.asarray(events),
        jnp.asarray(amounts), interpret=True))


def _case_hot(rng, hot):
    return _random_case(rng, hot=hot)


def _case_multi_tile(rng):
    return _random_case(rng, k=2048, n=512)


def _case_padding(rng):
    counters, keys, events, amounts = _random_case(rng, n=64)
    keys[::4] = counters.shape[0]            # every 4th is padding
    return counters, keys, events, amounts


def _case_duplicates(_rng):
    counters = np.zeros((512, 4), np.float32)
    keys = np.array([5] * 100 + [6] * 28, np.int32)
    events = np.array([1] * 100 + [2] * 28, np.int32)
    return counters, keys, events, np.ones(128, np.int32)


def _case_non_tile_k(rng):
    counters = rng.integers(0, 9, (600, 4)).astype(np.float32)
    keys = rng.integers(0, 700, 256).astype(np.int32)      # some >= K
    events = rng.integers(0, 4, 256).astype(np.int32)
    return counters, keys, events, np.ones(256, np.int32)


# the six cases of tests/test_pallas_kernels.py (the dispatch case is
# test_seam_uses_plain_version_on_cpu below)
CASES = {
    "random": lambda rng: _case_hot(rng, False),
    "hot": lambda rng: _case_hot(rng, True),
    "multi_tile": _case_multi_tile,
    "padding_dropped": _case_padding,
    "duplicates": _case_duplicates,
    "non_tile_k": _case_non_tile_k,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_xla_and_pallas(name):
    rng = np.random.default_rng(7)
    case = CASES[name](rng)
    want = _xla(*case)
    np.testing.assert_array_equal(_pallas(*case), want)
    np.testing.assert_array_equal(_port(*case), want)


def test_padding_lanes_contribute_nothing():
    rng = np.random.default_rng(3)
    counters, keys, events, amounts = _case_padding(rng)
    got = _port(counters, keys, events, amounts)
    k = counters.shape[0]
    assert got.sum() == counters.sum() + amounts[keys < k].sum()


def test_int32_counters_match_xla():
    rng = np.random.default_rng(11)
    case = _random_case(rng, k=1000, e=8, n=4096, dtype=np.int32)
    got = _port(*case)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _xla(*case))


def test_int32_counters_wrap_like_xla():
    counters = np.full((4, 2), 2 ** 31 - 3, np.int32)
    keys = np.array([1, 1, 1, 2], np.int32)
    events = np.array([0, 0, 0, 1], np.int32)
    amounts = np.array([2, 2, 2, -5], np.int32)
    np.testing.assert_array_equal(_port(counters, keys, events, amounts),
                                  _xla(counters, keys, events, amounts))


def test_negative_key_wraps_once_like_xla():
    """``.at[].add(mode="drop")`` wraps one negative index once (-1 → K-1)
    and drops anything still out of range; the port follows it."""
    counters = np.zeros((16, 4), np.int32)
    keys = np.array([-1, -1, -16, -17, 16, 3], np.int32)
    events = np.array([0, 3, 1, 1, 0, -1], np.int32)
    amounts = np.array([5, 7, 11, 13, 17, 19], np.int32)
    want = _xla(counters, keys, events, amounts)
    assert want[15, 0] == 5 and want[0, 1] == 11 and want[3, 3] == 19
    assert want.sum() == 5 + 7 + 11 + 19
    np.testing.assert_array_equal(_port(counters, keys, events, amounts),
                                  want)


def test_out_of_range_events_dropped_like_xla():
    counters = np.zeros((8, 4), np.int32)
    keys = np.array([1, 2, 3], np.int32)
    events = np.array([4, 9, 2], np.int32)
    amounts = np.array([1, 1, 1], np.int32)
    np.testing.assert_array_equal(_port(counters, keys, events, amounts),
                                  _xla(counters, keys, events, amounts))


def test_payload_mode_matches_row_vector_add():
    """events=None: row i adds ``amounts[i, :]`` lane-wise — the JAX
    package's ``counters.at[rows, :].add(payload, mode="drop")``."""
    rng = np.random.default_rng(5)
    counters = rng.integers(0, 9, (64, 8)).astype(np.int32)
    keys = rng.integers(0, 70, 300).astype(np.int32)        # some padding
    payload = rng.integers(-2, 3, (300, 8)).astype(np.int32)
    want = np.asarray(jnp.asarray(counters).at[jnp.asarray(keys), :].add(
        jnp.asarray(payload), mode="drop"))
    np.testing.assert_array_equal(_port(counters, keys, None, payload), want)


def test_strided_bucket_slice_updates_in_place():
    """The window's bucket slice ``counters[:, k, :]`` is a strided view;
    the scatter lands in the parent table and nowhere else."""
    rng = np.random.default_rng(9)
    table = rng.integers(0, 5, (32, 3, 8)).astype(np.int32)
    keys = rng.integers(0, 33, 200).astype(np.int32)
    events = rng.integers(0, 8, 200).astype(np.int32)
    amounts = rng.integers(1, 4, 200).astype(np.int32)
    t = torch.from_numpy(table.copy())
    sa.scatter_add(t[:, 1, :], torch.from_numpy(keys),
                   torch.from_numpy(events), torch.from_numpy(amounts))
    want = np.asarray(jnp.asarray(table).at[jnp.asarray(keys), 1,
                                            jnp.asarray(events)].add(
        jnp.asarray(amounts), mode="drop"))
    np.testing.assert_array_equal(t.numpy(), want)


def test_seam_uses_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    case = _random_case(rng)
    before = sa.LAUNCHES["scatter_add"]
    np.testing.assert_array_equal(_port(*case), _xla(*case))
    assert sa.LAUNCHES["scatter_add"] == before


def test_seam_never_falls_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel wrapper, which
    launches or raises — it never takes the plain version."""
    c = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    k = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sa.scatter_add(c, k, k, k)


def test_wrapper_validates_arguments():
    c = torch.zeros((4, 2), dtype=torch.int64)
    k = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        sa.scatter_add(c, k, k, k)
    with pytest.raises(ValueError):
        sa.scatter_add(torch.zeros((4, 2), dtype=torch.int32), k, None, k)


def test_bucket_histogram_matches_jax():
    from sentinel_tpu.ops.sortfree import bucket_histogram as jax_hist
    rng = np.random.default_rng(2)
    bucket = rng.integers(0, 100, 5000).astype(np.int32)
    want = np.asarray(jax_hist(jnp.asarray(bucket), 100))
    got = sfo.bucket_histogram(torch.from_numpy(bucket), 100).numpy()
    np.testing.assert_array_equal(got, want)


def test_reference_skips_zero_amounts_and_drops_for_real():
    """The plain version adds nothing for a zero amount or a dropped lane:
    a ``-0.0`` float counter keeps its sign, as under the kernel."""
    counters = torch.tensor([[-0.0, 1.0], [2.0, -0.0]])
    keys = torch.tensor([0, 1, 5, -3], dtype=torch.int32)
    events = torch.tensor([0, 1, 0, 0], dtype=torch.int32)
    amounts = torch.tensor([0, 0, 4, 4], dtype=torch.int32)
    sa.scatter_add(counters, keys, events, amounts)
    assert torch.equal(torch.signbit(counters),
                       torch.tensor([[True, False], [False, True]]))


# --- the launch plan (pure Python: what the wrapper passes to the C side)

PLAN_SHAPES = [
    # (k, e, row_stride, n, payload, dtype): the main path's shapes first
    (1 << 20, 8, 16, 1 << 19, False, torch.int32),      # decide
    (1 << 20, 8, 16, 1 << 19, True, torch.int32),       # exit payload
    (1 << 20, 32, 32, 1 << 19, False, torch.int32),     # rt_hist
    (1 << 20, 1, 2, 1 << 19, True, torch.float32),      # rt_sum column
    (1025, 1, 1, 1 << 19, True, torch.int32),           # breaker counts
    (4096, 8, 8, 1 << 19, False, torch.float32),
    (7264, 8, 8, 1 << 19, False, torch.int32),          # 232,448 bytes
    (7265, 8, 8, 1 << 19, False, torch.int32),
    (58112, 1, 1, 100, True, torch.float32),            # 232,448 bytes
    (58113, 1, 1, 100, True, torch.float32),
    (58112, 1, 1, 1 << 23, True, torch.float32),
    (7264, 8, 8, 1 << 23, False, torch.int32),
    (1 << 16, 1 << 15, 1 << 15, 10, False, torch.int32),    # 2^31 cells
    (1 << 16, 8, (1 << 15) - 1, 10, False, torch.int32),
    (1 << 26, 5, 64, 1 << 20, True, torch.int32),
    (3, 2, 2, 0, False, torch.int32),
    (3, 2, 2, 1, False, torch.float32),
    (1 << 20, 8, 16, 1 << 29, True, torch.int32),       # 2^32 lanes
    # one grid step (132·8 blocks × 256 threads × 4) below 2^31 and past it
    (1 << 20, 1, 1, 2 ** 31 - 2 ** 21, False, torch.int32),
    (1 << 20, 1, 1, 2 ** 31 - 2 ** 19, False, torch.int32),
    (16, 1, 1, 2 ** 31 - 2 ** 19, True, torch.int32),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_plan_rules(shape):
    k, e, stride, n, payload, dtype = shape
    p = sa.plan(k, e, stride, n, payload, dtype, sms=132)
    table_bytes = k * e * 4
    lanes = e if payload else 1

    def span(q):
        # every stream position the walk forms, one grid step past the
        # end included, times the lanes: what 32-bit index math must hold
        units = sa.units_per_thread(payload, q.e_inst)
        return (n + q.grid * q.block * units) * lanes

    assert p.smem_bytes <= sa.SMEM_BLOCK_MAX == 232_448
    shared = sa.shared_plan(k, e, n, payload, dtype, sms=132)
    if table_bytes > sa.SMEM_BLOCK_MAX:
        assert shared is None
    elif (n + 2 * 132 * sa.SHARED_BLOCK * 4) * lanes < 2 ** 31:
        assert shared is not None            # the table fits
    if shared is not None:
        assert shared.index_bits == 32 and span(shared) < 2 ** 31
    # the shared path exactly when the table fits and its private copies
    # hold no more cells than the stream has amounts
    long_enough = shared is not None and k * e * shared.grid <= n * lanes
    assert (p.path == sa.PATH_SHARED) == long_enough
    if p.path == sa.PATH_SHARED:
        assert p == shared
        assert p.smem_bytes == table_bytes
        assert p.grid <= sa.SHARED_BLOCKS_PER_SM * 132
    else:
        assert p.smem_bytes == 0
        assert p.grid <= 132 * sa.THREADS_PER_SM // p.block
    if p.index_bits == 32:
        assert k * stride < 2 ** 31 or p.path == sa.PATH_SHARED
        assert span(p) < 2 ** 31
    else:
        assert p.index_bits == 64 and p.path == sa.PATH_GLOBAL
        assert k * stride >= 2 ** 31 or span(p) >= 2 ** 31
    assert p.grid >= 1 and p.block % 32 == 0 and p.block <= 1024
    want_e = e if payload and e in (1, 8, 32) else 0
    assert p.e_inst == want_e


def test_plan_index_width_at_the_edge_of_32_bits():
    """32-bit index math stops one grid step short of 2^31 stream
    positions (the walk forms ``t0 + step`` before it compares), not at
    2^31 itself; a 2^31-cell table needs 64 bits whatever the stream."""
    step = 132 * sa.THREADS_PER_SM // sa.GLOBAL_BLOCK * sa.GLOBAL_BLOCK * 4
    below = sa.plan(1 << 20, 1, 1, 2 ** 31 - step - 1, False, torch.int32,
                    sms=132)
    at = sa.plan(1 << 20, 1, 1, 2 ** 31 - step, False, torch.int32, sms=132)
    assert (below.index_bits, at.index_bits) == (32, 64)
    wide = sa.plan(1 << 16, 8, 1 << 15, 10, False, torch.int32, sms=132)
    narrow = sa.plan(1 << 16, 8, (1 << 15) - 1, 10, False, torch.int32,
                     sms=132)
    assert (wide.index_bits, narrow.index_bits) == (64, 32)


def test_plan_path_at_the_shared_memory_threshold():
    """[7264, 8] int32 is 232,448 bytes: with a long enough stream it is
    privatised, one row more is not; a short stream keeps even a fitting
    table on the global path."""
    long_n, short_n = 1 << 23, 1 << 19
    at = sa.plan(7264, 8, 8, long_n, False, torch.int32, sms=132)
    above = sa.plan(7265, 8, 8, long_n, False, torch.int32, sms=132)
    short = sa.plan(7264, 8, 8, short_n, False, torch.int32, sms=132)
    assert (at.path, above.path, short.path) == (
        sa.PATH_SHARED, sa.PATH_GLOBAL, sa.PATH_GLOBAL)
    assert at.smem_bytes == 232_448 and at.grid == 132
    brk = sa.plan(1025, 1, 1, short_n, True, torch.int32, sms=132)
    assert brk.path == sa.PATH_SHARED and brk.e_inst == 1


def test_plan_grid_covers_the_stream_in_one_pass_when_it_can():
    p = sa.plan(1 << 20, 8, 16, 1 << 19, False, torch.int32, sms=132)
    per_block = p.block * sa.units_per_thread(False, p.e_inst)
    assert p.grid * per_block >= 1 << 19
    small = sa.plan(1 << 20, 8, 16, 1 << 19, False, torch.int32, sms=2)
    assert small.grid == 2 * sa.THREADS_PER_SM // small.block


def test_plan_rejects_empty_tables():
    with pytest.raises(ValueError):
        sa.plan(0, 8, 8, 10, False, torch.int32, sms=132)
