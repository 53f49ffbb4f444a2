"""Delay models (port of ``blockchain_simulator_tpu/ops/delay.py``).

A delay is an integer number of ticks.  Two families of samplers, as in the
JAX package:

- *edge* samplers draw one delay per (sender, receiver) edge: the
  ``"threefry"`` stream (``jax.random.randint``) or the ``"rbg"`` stream
  (XLA's Philox words, utils/philox.py, mapped to integers);
- *stat* samplers draw per-receiver bucket **counts** from the induced
  multinomial, as a chain of conditional binomials: ``"exact"``
  (``jax.random.binomial``, utils/threefry.binomial) or ``"normal"`` (the
  popcount-CLT Gaussian :func:`_fast_normal` on Philox words).

Every draw is bit-equal to the JAX function on the same key: float32 steps
follow XLA:CPU's arithmetic (utils/xla_math.py), and the Python floats the
JAX code multiplies by are rounded to float32 as JAX's weak typing rounds
them.
"""

from __future__ import annotations

import numpy as np
import torch

from blockchain_simulator_tpu_torch.utils import philox, threefry, xla_math

_F32 = torch.float32


def uniform_probs(lo: int, hi: int) -> np.ndarray:
    """Bucket probabilities of U{lo..hi-1}, indexed 0..hi-lo-1 (offset lo)."""
    b = hi - lo
    return np.full((b,), 1.0 / b)


def roundtrip_probs(lo: int, hi: int) -> np.ndarray:
    """Distribution of the sum of two independent U{lo..hi-1} draws
    (request delay + reply delay), indexed 0..2*(hi-lo)-2 (offset 2*lo)."""
    p = uniform_probs(lo, hi)
    return np.convolve(p, p)


def _half_words(key, shape, device):
    """Philox words for a leading axis of ``r`` draws, two 16-bit fields a
    word: ``(words & 0xFFFF, words >> 16)`` stacked and cut to ``r``, as
    the JAX samplers slice them."""
    r = shape[0]
    words = philox.bits(philox.rbg_key(key), ((r + 1) // 2,) + tuple(shape[1:]),
                        device)
    return torch.cat([words & 0xFFFF, words >> 16], dim=0)[:r]


def sample_edge_delays(key, shape, lo: int, hi: int, device,
                       impl: str = "threefry") -> torch.Tensor:
    """One delay per edge, in [lo, hi), as int32 on ``device``.
    ``"threefry"`` is ``jax.random.randint``; ``"rbg"`` maps Philox words
    to integers: 16-bit fields masked to a power-of-two span, else whole
    words modulo the span."""
    shape = tuple(int(s) for s in shape)
    if impl == "threefry":
        return threefry.randint(key, shape, lo, hi, device)
    if impl != "rbg":
        raise ValueError(f"unknown edge sampler impl {impl!r}")
    span = hi - lo
    if span & (span - 1) == 0 and span <= (1 << 16):
        if not shape:
            return sample_edge_delays(key, (1,), lo, hi, device, impl)[0]
        fields = _half_words(key, shape, device)
        return (lo + (fields & (span - 1))).to(torch.int32)
    words = philox.bits(philox.rbg_key(key), shape, device)
    return (lo + words % span).to(torch.int32)


def _popcount16(x):
    """Set bits of each 16-bit value (SWAR: torch has no popcount)."""
    x = x - ((x >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x + (x >> 4)) & 0x0F0F
    return (x + (x >> 8)) & 0x1F


def _fast_normal(key, shape, device) -> torch.Tensor:
    """CLT normal draws: ``(popcount(u16) - 8) / 2`` over the two 16-bit
    halves of each Philox word (mean 0, variance 1, float32)."""
    shape = tuple(int(s) for s in shape)
    if not shape:
        return _fast_normal(key, (1,), device)[0]
    z = _popcount16(_half_words(key, shape, device))
    return (z.to(_F32) - 8.0) * 0.5


def binom(key, n, p: float, mode: str = "exact") -> torch.Tensor:
    """Binomial(n, p) draw (float32, shape of ``n``); ``"normal"`` is the
    Gaussian approximation ``clip(round(mu + sigma*z), 0, n)``."""
    n = n.to(_F32)
    if mode == "normal":
        return _round_normal(n, p, _fast_normal(key, n.shape, n.device))
    return threefry.binomial(key, n, p, n.device)


def _round_normal(n, p: float, z):
    """``clip(round(n*p + sigma*z), 0, n)`` with ``sigma = sqrt(max(n*p*(1-p),
    0))``, where XLA:CPU fuses ``n*p + (sigma*z)`` into one multiply-add
    (``sigma*z`` rounded first).  Exact in float64 plus one rounding: ``n``
    is an integer below 2**24 and ``p`` a float32, so ``n*p`` holds at most
    48 bits, and ``sigma*z`` (``z`` a multiple of 1/2 in [-4, 4], ``sigma``
    at most a few binades from ``sqrt(n*p)``) lands inside the same 53-bit
    window."""
    mu = n * p
    sigma = xla_math.sqrt(torch.clamp(mu * (1.0 - p), min=0.0))
    f64 = torch.float64
    x = (n.to(f64) * float(np.float32(p)) + (sigma * z).to(f64)).to(_F32)
    return torch.minimum(torch.clamp(torch.round(x), min=0.0), n)


def sample_bucket_counts(key, n, probs: np.ndarray, mode: str = "exact"):
    """Split ``n`` (int tensor, any shape) into bucket counts ~
    Multinomial(n, probs): int32 of shape ``(len(probs),) + n.shape``."""
    return torch.stack(list(bucket_count_chain(key, n, probs, mode))).to(torch.int32)


def bucket_count_chain(key, n, probs: np.ndarray, mode: str = "exact"):
    """The conditional-binomial chain behind :func:`sample_bucket_counts`,
    one float32 bucket at a time.  The last bucket is the remainder and
    draws nothing.  ``"normal"``: one Philox draw for all buckets;
    ``"exact"``: bucket ``b`` draws on ``fold_in(key, b)``."""
    n = n.to(_F32)
    nb = len(probs)
    z_all = (_fast_normal(key, (max(nb - 1, 1),) + tuple(n.shape), n.device)
             if mode == "normal" else None)
    keys = (threefry.fold_in(key, np.arange(max(nb - 1, 1)))
            if mode != "normal" and nb > 1 else None)
    remaining = n
    p_left = 1.0
    for b, pb in enumerate(probs):
        frac = float(min(max(pb / max(p_left, 1e-9), 0.0), 1.0))
        if b == nb - 1 or frac >= 1.0:
            c = remaining
        elif mode == "normal":
            c = _round_normal(remaining, frac, z_all[b])
        else:
            c = binom(keys[b], remaining, frac, mode)
        yield c
        remaining = remaining - c
        p_left -= pb
