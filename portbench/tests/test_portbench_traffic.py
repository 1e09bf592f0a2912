"""The traffic generator: the same seed gives the same inputs."""

import numpy as np

from portbench import deploy
from portbench.tests import small
from portbench.traffic import load_mix, make, seed64


def _traffic(seed, name="fused_zipf"):
    mix = load_mix(name)
    mix.update(small.FUSED_ZIPF)
    cfg = deploy.load_config("flow_1m")
    cfg.update(small.FLOW_1M)
    return make(mix, cfg, seed, "cpu")


def test_same_seed_same_inputs():
    a, b = _traffic(2 ** 31 + 11), _traffic(2 ** 31 + 11)
    for x, y in zip(a.pool, b.pool):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.rt, b.rt)
    np.testing.assert_array_equal(a.noise_err, b.noise_err)
    np.testing.assert_array_equal(a.keep_plan, b.keep_plan)


def test_other_seed_other_inputs_of_the_same_shape():
    a, b = _traffic(5), _traffic(6)
    assert not np.array_equal(a.pool[0], b.pool[0])
    assert [p.shape for p in a.pool] == [p.shape for p in b.pool]
    assert a.rt.shape == b.rt.shape


def test_draws_in_range_and_skewed():
    t = _traffic(7)
    ranks = np.concatenate(t.pool)
    assert ranks.min() >= 0 and ranks.max() < small.FLOW_1M["names"]
    # Zipf(0.99): rank 0 is drawn most
    counts = np.bincount(ranks)
    assert counts[0] == counts.max()
    assert t.rt.min() >= 0 and t.rt.max() <= load_mix("fused_zipf")[
        "rt_max_ms"]
    off = t.exit_offset(3)
    rt, noise = t.exit_columns(3, 100)
    np.testing.assert_array_equal(rt, t.rt[off:off + 100])
    assert noise.shape == (100,)


def test_seed64_takes_any_whole_number():
    for s in (0, 1, 2 ** 31 + 5, 2 ** 40, -3):
        assert 0 <= seed64(s, 1) < 2 ** 64
    assert seed64(5, 1) != seed64(5, 2)
