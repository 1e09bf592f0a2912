"""Port parity: ``sentinel_tpu_torch.ops.scatter_add`` against the JAX
package's scatter-add (``scatter_add_xla`` and the Pallas MXU kernel in
interpret mode).

On the CPU the seam runs the kernel's plain PyTorch version (the CUDA
kernel itself is compared with it on the card: the ``gpu`` test below and
``chip_smoke.py``). Tolerance: exact. The float32 cases keep every sum
far below 2^24, where float32 accumulation is exact in any order.
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


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(1)
    for dtype in (np.int32, np.float32):
        counters, keys, events, amounts = _random_case(
            rng, k=1 << 16, e=8, n=1 << 18, dtype=dtype)
        keys[::13] = counters.shape[0]
        keys[1] = -1
        dev = "cuda"
        want = torch.from_numpy(counters).to(dev)
        got = want.clone()
        args = [torch.from_numpy(a).to(dev) for a in (keys, events, amounts)]
        sa.scatter_add_reference(want, *args)
        before = sa.LAUNCHES["scatter_add"]
        sa.scatter_add(got, *args)
        torch.cuda.synchronize()
        assert sa.LAUNCHES["scatter_add"] == before + 1
        assert torch.equal(got, want)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      _xla(counters, keys, events, amounts))
