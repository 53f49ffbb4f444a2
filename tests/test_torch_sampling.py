"""The port's float32 math and samplers against the JAX package, bit for bit.

XLA:CPU's ``log``/``log1p`` (Cephes polynomials with LLVM's fused
multiply-adds), its correctly rounded ``sqrt`` and its contractions of
``a*b + c`` are replayed by utils/xla_math.py; on them rest the exact
binomial (``jax.random.binomial``), the Gumbel categorical and both modes of
the multinomial bucket chain, and the stat delivery channels built on them.
Every comparison here is exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockchain_simulator_tpu.ops import delay as jdelay
from blockchain_simulator_tpu.ops import delivery as jdv
from blockchain_simulator_tpu_torch.ops import delay as tdelay
from blockchain_simulator_tpu_torch.ops import delivery as tdv
from blockchain_simulator_tpu_torch.utils import threefry, xla_math


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _key(i):
    k = jax.random.fold_in(jax.random.key(1234), i)
    return k, _kd(k)


def _assert_equal_nan(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    assert same.all(), f"{int((~same).sum())} of {got.size} differ"


def _floats():
    """1.5M float32s of every magnitude (subnormals included) and the
    special values."""
    rng = np.random.default_rng(0)
    every = rng.integers(0, 2**31, 1_000_000, dtype=np.int64).astype(np.uint32)
    special = np.array([0.0, -0.0, 1e-45, 1e-40, np.finfo(np.float32).tiny, np.inf,
                        -np.inf, np.nan, -1.0, 1.0, 2.0, 0.5], np.float32)
    return np.concatenate([every.view(np.float32), special,
                           rng.random(500_000).astype(np.float32)])


@pytest.mark.parametrize("name", ["log", "log1p", "sqrt"])
def test_xla_math_matches_jnp(name):
    x = _floats()
    if name == "log1p":  # the small-argument arm and negative arguments
        rng = np.random.default_rng(1)
        x = np.concatenate([x, (rng.random(500_000).astype(np.float32) - 0.5) * 0.9,
                            -rng.random(100_000).astype(np.float32)])
    want = np.asarray(jax.jit(getattr(jnp, name))(x))
    _assert_equal_nan(getattr(xla_math, name)(torch.from_numpy(x)).numpy(), want)


def test_fma32_matches_the_contracted_multiply_add():
    rng = np.random.default_rng(2)
    a, b, c = (rng.standard_normal(200_000).astype(np.float32) * s
               for s in (1.0, 3.0, 1e-3))
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    got = xla_math.fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    np.testing.assert_array_equal(got, want)


BINOMIAL_CASES = {
    "all_inversion": (np.arange(0, 30), 0.3),
    "all_btrs": (np.arange(200, 3000, 7), 0.37),
    "mixed": (np.arange(0, 600, 3), 0.25),
    "count_zero": (np.zeros(64, int), 0.4),
    "count_1e5": (np.full(64, 100_000), 0.2),
    "p_above_half": (np.arange(0, 400, 2), 0.8),
}


@pytest.mark.parametrize("name", sorted(BINOMIAL_CASES))
def test_binomial_matches_jax(name):
    count, p = BINOMIAL_CASES[name]
    count = count.astype(np.float32)
    for i in range(3):
        k, kd = _key(i)
        want = np.asarray(jax.jit(lambda k, n: jax.random.binomial(k, n, p))(k, count))
        got = threefry.binomial(kd, torch.from_numpy(count), p, "cpu").numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_binomial_million_draws_match_jax():
    """The draw-level check behind the exact tier: 10**6 draws of a mixed
    count array (inversion and BTRS elements) at three probabilities."""
    rng = np.random.default_rng(3)
    count = rng.integers(0, 3000, 1_000_000 // 3).astype(np.float32)
    for i, p in enumerate((1 / 3, 0.5, 0.9)):
        k, kd = _key(100 + i)
        want = np.asarray(jax.jit(lambda k, n: jax.random.binomial(k, n, p))(k, count))
        got = threefry.binomial(kd, torch.from_numpy(count), p, "cpu").numpy()
        assert int((got != want).sum()) == 0


@pytest.mark.parametrize("nb, shape", [(3, (1000,)), (5, (64, 8))])
def test_categorical_matches_jax(nb, shape):
    probs = jdelay.uniform_probs(0, nb) if nb == 3 else jdelay.roundtrip_probs(3, 6)
    k, kd = _key(7)
    want = np.asarray(jax.jit(lambda k: jax.random.categorical(
        k, jnp.log(jnp.asarray(probs) + 1e-30), shape=shape))(k))
    got = threefry.categorical(kd, tdv._delay_logits(probs, "cpu"), shape, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["exact", "normal"])
@pytest.mark.parametrize("drop", [0.0, 0.1])
def test_sample_bucket_counts_matches_jax(mode, drop):
    """The chain alone, and behind the stat broadcast (drop thinning by a
    binomial first)."""
    rng = np.random.default_rng(4)
    n = rng.integers(0, 4000 if mode == "exact" else 100_000, (3, 40)).astype(np.int32)
    is_sender = rng.random(40) < 0.3
    k, kd = _key(9)
    for probs in (jdelay.uniform_probs(3, 6), jdelay.roundtrip_probs(3, 6)):
        want = np.asarray(jax.jit(
            lambda k, n: jdelay.sample_bucket_counts(k, n, probs, mode))(k, n))
        got = tdelay.sample_bucket_counts(kd, torch.from_numpy(n), probs, mode)
        np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(jax.jit(lambda k, s: jdv.bcast_counts_stat(
            k, 31, s, probs, drop, mode=mode))(k, is_sender))
        got = tdv.bcast_counts_stat(kd, 31, torch.from_numpy(is_sender), probs, drop,
                                    mode=mode)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["exact", "normal"])
@pytest.mark.parametrize("drop", [0.0, 0.2])
def test_stat_delivery_channels_match_jax(mode, drop):
    """Every stat channel the PBFT tick engine and round path use."""
    rng = np.random.default_rng(5)
    n, w = 24, 6
    probs, rt_probs = jdelay.uniform_probs(3, 6), jdelay.roundtrip_probs(3, 6)
    slot_mat = (rng.random((n, w)) < 0.4).astype(np.int32)
    value = np.where(rng.random(n) < 0.2, rng.integers(1, 99, n), 0).astype(np.int32)
    value_mat = np.zeros((n, w), np.int32)
    value_mat[0, 2] = 17
    send = rng.random(n) < 0.5
    peers = (20 - (rng.random(n) < 0.8)).astype(np.int32)
    k, kd = _key(11)
    t = torch.from_numpy
    pairs = [
        (lambda k: jdv.bcast_slots_stat(k, slot_mat, probs, drop, mode=mode),
         lambda: tdv.bcast_slots_stat(kd, t(slot_mat), probs, drop, mode=mode)),
        (lambda k: jdv.bcast_value_max_stat(k, value, probs, drop),
         lambda: tdv.bcast_value_max_stat(kd, t(value), probs, drop)),
        (lambda k: jdv.bcast_window_value_max_stat(k, value_mat, probs, drop),
         lambda: tdv.bcast_window_value_max_stat(kd, t(value_mat), probs, drop)),
        (lambda k: jdv.roundtrip_reply_counts_stat(k, send, peers, rt_probs, drop,
                                                   mode=mode),
         lambda: tdv.roundtrip_reply_counts_stat(kd, t(send), t(peers), rt_probs, drop,
                                                 mode=mode)),
        (lambda k: jdv.bcast_slots_stat(k, slot_mat, probs, drop, mode=mode),
         lambda: tdv.push_bcast_slots_stat(kd, t(slot_mat), probs, drop, mode=mode)),
    ]
    for jf, tf in pairs:
        np.testing.assert_array_equal(tf().numpy(), np.asarray(jax.jit(jf)(k)))
