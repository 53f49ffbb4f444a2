"""The port's Philox stream (``rbg`` keys) against ``jax.random``, bit for bit.

``jax.random.bits`` on an ``rbg`` key is XLA's RngBitGenerator; the port
rebuilds it as textbook Philox-4x32-10 (utils/philox.py).  Held here: the
raw words over 1-D, 2-D and 3-D shapes, odd element counts and a counter
carry across 2**64; the popcount normal ``_fast_normal``; the ``"rbg"`` edge
sampler with a power-of-two and a general span.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blockchain_simulator_tpu.ops import delay as jdelay
from blockchain_simulator_tpu_torch.ops import delay as tdelay
from blockchain_simulator_tpu_torch.utils import philox, threefry
from test_torch_pbft import release_jax_executables  # noqa: F401 (autouse fixture)


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("words, shape", [
    ((1, 2, 3, 4), (7,)),
    ((0xDEADBEEF, 0x12345678, 0x9ABCDEF0, 0x0FEDCBA9), (3, 5)),
    ((5, 6, 7, 8), (2, 7, 3)),
    ((11, 12, 13, 14), (1, 1001)),
    # the low counter half wraps: the carry lands in the high half
    ((0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFF0, 0xFFFFFFFF), (101,)),
    ((3, 4, 0xFFFFFFFE, 0xFFFFFFFF), (5, 3)),
])
def test_rbg_bits_match_jax(words, shape):
    kw = np.array(words, np.uint32)
    key = jax.random.wrap_key_data(jnp.asarray(kw), impl="rbg")
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64)
    got = philox.bits(kw.astype(np.int64), shape, "cpu").numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 9])
def test_rbg_key_tiles_the_threefry_key(seed):
    k = jax.random.fold_in(jax.random.key(seed), 3)
    want = _kd(jdelay._rbg_key(k))
    np.testing.assert_array_equal(philox.rbg_key(_kd(k)), want)


@pytest.mark.parametrize("shape", [(), (1,), (5,), (4, 7), (3, 1001)])
def test_fast_normal_matches_jax(shape):
    k = jax.random.fold_in(jax.random.key(11), 8)
    want = np.asarray(jax.jit(lambda k: jdelay._fast_normal(k, shape))(k))
    got = tdelay._fast_normal(_kd(k), shape, "cpu").numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lo, hi, shape", [
    (3, 7, (9, 9)),            # span 4: two 16-bit fields a word
    (3, 7, (10,)),
    (0, 1 << 16, (5, 3)),      # the largest field span
    (3, 6, (9, 9)),            # span 3: whole words modulo the span
    (2, 100_001, (1001,)),
])
def test_rbg_edge_sampler_matches_jax(lo, hi, shape):
    k = jax.random.fold_in(jax.random.key(5), 2)
    want = np.asarray(jax.jit(
        lambda k: jdelay.sample_edge_delays(k, shape, lo, hi, "rbg"))(k))
    got = tdelay.sample_edge_delays(_kd(k), shape, lo, hi, "cpu", "rbg").numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_threefry_key_words_feed_philox_unchanged():
    """A port key is the JAX key's two words (utils/threefry.key)."""
    np.testing.assert_array_equal(threefry.key(9), _kd(jax.random.key(9)))
