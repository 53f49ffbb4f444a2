"""The port's threefry-2x32 PRNG against ``jax.random``, bit for bit.

The JAX package's streams are the reference only under the PRNG flags this
environment runs (partitionable threefry, the default impl), so those are
pinned first.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blockchain_simulator_tpu.utils import prng as jprng
from blockchain_simulator_tpu_torch.utils import prng as tprng
from blockchain_simulator_tpu_torch.utils import threefry
from test_torch_pbft import release_jax_executables  # noqa: F401 (autouse fixture)

SEEDS = [0, 1, 7, 123456789, 2**32 + 5]
SHAPES = [(), (1,), (7,), (3, 5), (2, 3, 5)]


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_jax_prng_flags_pinned():
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split(seed):
    k, kp = jax.random.key(seed), threefry.key(seed)
    np.testing.assert_array_equal(kp, _kd(k))
    for data in (0, 5, 0x1217, 2**31 + 3):
        np.testing.assert_array_equal(threefry.fold_in(kp, data),
                                      _kd(jax.random.fold_in(k, data)))
    for num in (1, 2, 5):
        np.testing.assert_array_equal(threefry.split(kp, num),
                                      _kd(jax.random.split(k, num)))


def test_fold_in_over_an_array_is_elementwise():
    kp = threefry.key(3)
    data = np.arange(0, 2000, 37)
    many = threefry.fold_in(kp, data)
    for i, d in enumerate(data):
        np.testing.assert_array_equal(many[i], threefry.fold_in(kp, int(d)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bits(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.key(seed), shape, jnp.uint32))
    got = threefry.bits(threefry.key(seed), shape, "cpu").numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("span", [(3, 6), (6, 9), (0, 100), (-5, 1_000_003),
                                  (4, 4), (0, 65_537), (-2**31, 2**31 - 1)])
@pytest.mark.parametrize("shape", SHAPES)
def test_randint(shape, span):
    lo, hi = span
    for seed in SEEDS[:3]:
        want = np.asarray(jax.random.randint(jax.random.key(seed), shape, lo, hi))
        got = threefry.randint(threefry.key(seed), shape, lo, hi, "cpu").numpy()
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.5, 0.95, (1 - 0.05) ** 2, 1 - 0.013, 0.0, 1.0])
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_and_bernoulli(shape, p):
    for seed in SEEDS[:3]:
        k, kp = jax.random.key(seed), threefry.key(seed)
        np.testing.assert_array_equal(threefry.uniform(kp, shape, "cpu").numpy(),
                                      np.asarray(jax.random.uniform(k, shape)))
        np.testing.assert_array_equal(threefry.bernoulli(kp, p, shape, "cpu").numpy(),
                                      np.asarray(jax.random.bernoulli(k, p, shape)))


def test_tick_and_channel_keys():
    base, basep = jax.random.key(11), threefry.key(11)
    ticks = np.array([0, 1, 49, 50, 2499])
    many = tprng.tick_key(basep, ticks)
    for i, t in enumerate(ticks):
        tk = jprng.tick_key(base, int(t))
        np.testing.assert_array_equal(many[i], _kd(tk))
        for ch in range(10):
            np.testing.assert_array_equal(tprng.chan_key(many[i], ch),
                                          _kd(jprng.chan_key(tk, ch)))
    assert [getattr(tprng.Channel, a) for a in dir(jprng.Channel) if a.isupper()] == \
        [getattr(jprng.Channel, a) for a in dir(jprng.Channel) if a.isupper()]


def test_randint_rejects_bounds_outside_int32():
    with pytest.raises(ValueError):
        threefry.randint(threefry.key(0), (3,), 0, 2**31, "cpu")
