"""Threefry-2x32 random bits, bit for bit with ``jax.random``.

Reproduces the JAX package's default PRNG (``jax_default_prng_impl =
threefry2x32`` with ``jax_threefry_partitionable = True``):

- :func:`key` is ``jax.random.key(seed)`` (``prng.threefry_seed``);
- :func:`fold_in` is ``jax.random.fold_in`` (``prng.threefry_fold_in``);
- :func:`split` is ``jax.random.split`` (``prng._threefry_split_foldlike``);
- :func:`bits` is 32-bit ``jax.random.bits``
  (``prng._threefry_random_bits_partitionable``);
- :func:`randint` is ``jax.random.randint`` (``random._randint``: two
  independent 32-bit draws from a split key, folded through the
  ``2**32 % span`` multiplier);
- :func:`uniform` / :func:`bernoulli` are the float32 mantissa construction
  of ``random._uniform`` and ``uniform(key, shape) < p``;
- :func:`binomial` is ``jax.random.binomial`` (``random._binomial``:
  inversion and BTRS rejection) and :func:`categorical` is
  ``jax.random.categorical`` (Gumbel-max), their float32 steps as XLA:CPU
  computes them (utils/xla_math.py).

uint32 arithmetic is done in int64 masked with ``0xFFFFFFFF`` (torch has no
complete uint32 support).  :func:`threefry2x32` is written in plain operators,
so it runs on numpy arrays, torch tensors and Python ints alike.

Keys are tiny and depend only on (seed, tick, channel), never on simulation
state, so they live on the host as numpy ``int64`` arrays of shape
``(..., 2)``.  Only the bulk draws (:func:`bits` and what builds on it) run on
the device, with the key words passed in as Python ints.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from blockchain_simulator_tpu_torch.utils import xla_math as xm

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block function (20 rounds), elementwise over the
    broadcast of its arguments; every argument holds uint32 values in an
    int64 (or Python int) container.  Returns ``(y1, y2)``."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``: the words ``(0, seed mod 2**32)``."""
    return np.array([0, int(seed) & MASK], np.int64)


def _words(k):
    k = np.asarray(k, np.int64)
    if k.shape != (2,):
        raise ValueError(f"expected one threefry key of shape (2,), got {k.shape}")
    return int(k[0]), int(k[1])


def fold_in(k, data) -> np.ndarray:
    """``jax.random.fold_in(k, data)``; ``data`` may be an int or an integer
    array, giving one key per element (shape ``data.shape + (2,)``)."""
    k1, k2 = _words(k)
    d = np.asarray(data, np.int64) & MASK
    y1, y2 = threefry2x32(k1, k2, np.zeros_like(d), d)
    return np.stack([y1, y2], axis=-1)


def split(k, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)`` (partitionable form): ``[num, 2]``."""
    k1, k2 = _words(k)
    cnt = np.arange(num, dtype=np.int64)
    y1, y2 = threefry2x32(k1, k2, cnt >> 32, cnt & MASK)
    return np.stack([y1, y2], axis=-1)


def bits(k, shape, device) -> torch.Tensor:
    """32-bit ``jax.random.bits(k, shape)`` as an int64 tensor of uint32
    values on ``device``."""
    shape = tuple(int(s) for s in shape)
    k1, k2 = _words(k)
    cnt = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    y1, y2 = threefry2x32(k1, k2, cnt >> 32, cnt & MASK)
    return (y1 ^ y2).reshape(shape)


def randint(k, shape, minval: int, maxval: int, device) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` with int32 output."""
    minval, maxval = int(minval), int(maxval)
    if not (-(2**31) <= minval and maxval <= 2**31 - 1):
        raise ValueError("randint bounds must fit int32")
    ka, kb = split(k)
    higher, lower = bits(ka, shape, device), bits(kb, shape, device)
    span = (maxval - minval) & MASK if maxval > minval else 1
    # JAX squares 2**16 % span in uint32, which wraps to 0 once span > 2**16
    mult = (((2**16 % span) ** 2) & MASK) % span
    off = (((higher % span) * mult) & MASK) + (lower % span)
    off = (off & MASK) % span
    return (off + minval).to(torch.int32)


def uniform(k, shape, device) -> torch.Tensor:
    """float32 ``jax.random.uniform(k, shape)`` in [0, 1): 23 random mantissa
    bits under the exponent of 1.0, minus 1."""
    b = bits(k, shape, device)
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def bernoulli(k, p: float, shape, device) -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)`` for a Python float ``p``, which
    JAX compares in float32 (rounded here on the host, so the comparison
    is against an exactly representable float32 value)."""
    return uniform(k, shape, device) < float(np.float32(p))


# --------------------------------------------------------------------------- #
# binomial and categorical draws (jax 0.9.0 ``random._binomial`` and         #
# ``random.categorical``), with XLA:CPU's float32 arithmetic (xla_math)       #
# --------------------------------------------------------------------------- #

_STIRLING_TAIL = np.array([
    0.0810614667953272, 0.0413406959554092, 0.0276779256849983,
    0.02079067210376509, 0.0166446911898211, 0.0138761288230707,
    0.0118967099458917, 0.0104112652619720, 0.00925546218271273,
    0.00833056343336287], np.float32)


def _stirling_approx_tail(k):
    """``random._stirling_approx_tail``: table below 10, series beyond."""
    use_table = k <= 9
    k = torch.clamp(k, 0.0, 9.0)
    kp1 = k + 1.0
    kp1sq = kp1 * kp1
    approx = xm.div(1.0 / 12 - xm.div(1.0 / 360 - xm.div(1.0 / 1260, kp1sq), kp1sq),
                    kp1)
    table = torch.as_tensor(_STIRLING_TAIL, device=k.device)
    return torch.where(use_table, table[torch.floor(k).to(torch.int64)], approx)


def _binomial_inversion(k, count, q, shape, device):
    """``random._binomial_inversion``: count geometric gaps until their sum
    passes ``count``; the loop runs until every element is done (one host
    read an iteration)."""
    log1mq = xm.log1p(-q)
    num_geom = torch.zeros(shape, dtype=torch.float32, device=device)
    geom_sum = torch.zeros(shape, dtype=torch.float32, device=device)
    while bool((geom_sum <= count).any()):
        subkey, k = split(k)
        num_geom = torch.where(geom_sum <= count, num_geom + 1.0, num_geom)
        u = uniform(subkey, shape, device)
        geom_sum = geom_sum + torch.ceil(xm.div(xm.log(u), log1mq))
    return num_geom - 1.0


def _btrs(k, count, q, shape, device):
    """``random._btrs`` (transformed rejection, Hörmann 1993).  Every
    element draws until all have accepted, and ``k_out`` keeps each
    element's LAST accept, as the JAX loop does; one host read an
    iteration.  The fused multiply-adds are those XLA:CPU makes."""
    stddev = xm.sqrt((count * q) * (1.0 - q))
    b = xm.fma32(stddev, 2.53, 1.15)
    a = xm.fma32(q, 0.01, xm.fma32(b, 0.0248, -0.0873))
    c = xm.fma32(count, q, 0.5)
    v_r = 0.92 - xm.div(4.2, b)
    r = xm.div(q, 1.0 - q)
    alpha = (xm.div(5.1, b) + 2.83) * stddev
    m = torch.floor((count + 1.0) * q)
    two_a = a * 2.0
    ub_m = (m + 0.5) * xm.log(xm.div(m + 1.0, r * ((count - m) + 1.0)))
    k_out = torch.full(shape, -1.0, dtype=torch.float32, device=device)
    accepted = torch.zeros(shape, dtype=torch.bool, device=device)
    while not bool(accepted.all()):
        k, sk0, sk1 = split(k, 3)
        u = uniform(sk0, shape, device) - 0.5
        v = uniform(sk1, shape, device)
        us = 0.5 - u.abs()
        accept1 = (us >= 0.07) & (v <= v_r)
        kk = torch.floor(xm.fma32(xm.div(two_a, us) + b, u, c))
        reject = (kk < 0) | (kk > count)
        v = xm.log(xm.div(v * alpha, xm.div(a, us * us) + b))
        ub = xm.fma32(count + 1.0,
                      xm.log(xm.div((count - m) + 1.0, (count - kk) + 1.0)), ub_m)
        ub = xm.fma32(kk + 0.5, xm.log(xm.div(r * ((count - kk) + 1.0), kk + 1.0)), ub)
        ub = ((ub + _stirling_approx_tail(m)) + _stirling_approx_tail(count - m)
              - _stirling_approx_tail(kk) - _stirling_approx_tail(count - kk))
        accept = accept1 | (~reject & (v <= ub))
        k_out = torch.where(accept, kk, k_out)
        accepted = accepted | accept
    return k_out


def binomial(k, count, p: float, device) -> torch.Tensor:
    """``jax.random.binomial(k, count, p)`` for a float32 ``count`` tensor
    and a Python float ``p``: float32 out, bit for bit with jax 0.9.0 on
    XLA:CPU.  Inversion where ``count * q <= 10``, BTRS elsewhere; both arms
    run over the whole shape (the other arm's elements get the dummy
    arguments JAX substitutes) and one is selected, and ``q = min(p, 1-p)``
    is flipped back at the end."""
    count = count.to(torch.float32)
    shape = tuple(count.shape)
    prob = torch.full(shape, float(np.float32(p)), dtype=torch.float32, device=device)
    p_lt_half = prob < 0.5
    q = torch.where(p_lt_half, prob, 1.0 - prob)
    count_nan_or_neg = torch.isnan(count) | (count < 0.0)
    count_inf = torch.isinf(count)
    q_is_nan = torch.isnan(q)
    q_l_0 = q < 0.0
    q = torch.where(q_is_nan | q_l_0, 0.01, q)
    use_inversion = count_nan_or_neg | (count * q <= 10.0)
    count = torch.floor(count)
    count_inv = torch.where(use_inversion, count, 0.0)
    count_btrs = torch.where(use_inversion, 1e4, count)
    q_btrs = torch.where(use_inversion, 0.5, q)
    # an arm no element selects is skipped: its loop reads only its own
    # lanes, so the selected samples do not depend on it
    zeros = torch.zeros(shape, dtype=torch.float32, device=device)
    inv = (_binomial_inversion(k, count_inv, q, shape, device)
           if bool(use_inversion.any()) else zeros)
    btrs = (_btrs(k, count_btrs, q_btrs, shape, device)
            if not bool(use_inversion.all()) else zeros)
    samples = torch.where(use_inversion, inv, btrs)
    invalid = q_l_0 | q_is_nan | count_nan_or_neg
    samples = torch.where(invalid, torch.nan, samples)
    samples = torch.where(count_inf & ~invalid, torch.inf, samples)
    keep = p_lt_half | count_nan_or_neg | q_is_nan | count_inf
    return torch.where(keep, samples, count - samples)


def categorical(k, logits, shape, device) -> torch.Tensor:
    """``jax.random.categorical(k, logits, shape=shape)`` over the last axis
    of a 1-D float32 ``logits``: Gumbel-max with ``mode="low"`` noise
    ``-log(-log(u))``, ``u ~ uniform(tiny, 1)``.  Returns int64 indices."""
    logits = torch.as_tensor(logits, dtype=torch.float32, device=device)
    full = tuple(shape) + (logits.shape[-1],)
    tiny = float(np.finfo(np.float32).tiny)
    u = torch.clamp(uniform(k, full, device) + tiny, min=tiny)
    g = -xm.log(-xm.log(u))
    return torch.argmax(g + logits, dim=-1)
