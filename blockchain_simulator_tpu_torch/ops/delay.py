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

*Lane keys.*  Every sampler also takes a stack of keys ``[L, 2]`` with
tensors of a leading axis ``L``: the lanes of a tick engine stepped side
by side.  The threefry draws are per lane, and so are the exact
binomial's rejection loops.  The Philox draws (the ``"normal"`` stat
sampler and the ``"rbg"`` edge sampler) follow one of two rules, which
:func:`lane_rule` selects:

- **first-lane** (the default): ``jax.vmap`` of the sampler over the keys.
  The batching rule of ``rng_bit_generator`` draws the first lane's key at
  shape ``(L, *shape)`` and hands row ``l`` to lane ``l``
  (:func:`_fast_normal_vmapped`), so lane ``l > 0`` gets other words than
  its key alone would draw;
- **solo** (``lane_rule(1)``): ``lax.map`` of the sampler, each lane the
  words of its own key.

``lane_rule(w)`` in general lays the lanes out ``[w, G]`` (lane ``b * G +
g``): ``G`` groups, each a ``jax.vmap`` of width ``w`` whose first lane
(``b = 0``) draws for the group.  That is ``jax.vmap`` over ``w`` points
of a ``lax.map`` over ``G`` (a sweep batch of committee runs).
"""

from __future__ import annotations

import contextlib
import threading

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


def _lanes(key) -> bool:
    """Whether ``key`` is a stack of lane keys ``[L, 2]`` (one threefry key a
    lane) rather than one key ``[2]``."""
    return np.ndim(key) == 2


_RULE = threading.local()  # the vmap width of lane_rule, per thread


@contextlib.contextmanager
def lane_rule(width: int):
    """Inside, Philox draws on lane keys ``[L, 2]`` take the rule of ``L /
    width`` groups of ``width`` vmapped lanes (module docstring):
    ``lane_rule(1)`` is the solo rule of ``lax.map``.  Outside any, the
    first-lane rule of ``jax.vmap`` over all ``L`` lanes.  Per thread, so a
    server's batcher and a sweep's worker threads never see each other's."""
    prev = getattr(_RULE, "width", None)
    _RULE.width = int(width)
    try:
        yield
    finally:
        _RULE.width = prev


def _philox_lanes(keys, shape, device) -> torch.Tensor:
    """The Philox words ``[L, *shape]`` of lane keys ``[L, 2]`` under the
    current :func:`lane_rule`: lane ``b * G + g`` gets row ``b`` of group
    ``g``'s first key drawn at ``(width, *shape)``."""
    keys = np.asarray(keys, np.int64)
    n_lanes = len(keys)
    width = getattr(_RULE, "width", None) or n_lanes
    if n_lanes % width:
        raise ValueError(f"{n_lanes} lanes do not split into vmaps of {width}")
    heads = keys.reshape(width, n_lanes // width, 2)[0]  # [G, 2]
    if len(heads) == 1:
        return philox.bits(philox.rbg_key(heads[0]), (width,) + shape, device)
    words = philox.bits(philox.rbg_key(heads), (width,) + shape, device)  # [G, W, ...]
    return words.transpose(0, 1).reshape((n_lanes,) + shape)


def _half_words(key, shape, device):
    """Philox words for a leading axis of ``r`` draws, two 16-bit fields a
    word: ``(words & 0xFFFF, words >> 16)`` stacked and cut to ``r``, as
    the JAX samplers slice them.  Lane keys give ``[L, *shape]`` by the
    current :func:`lane_rule` (module docstring)."""
    r = shape[0]
    if _lanes(key):
        words = _philox_lanes(key, ((r + 1) // 2,) + tuple(shape[1:]), device)
        return torch.cat([words & 0xFFFF, words >> 16], dim=1)[:, :r]
    words = philox.bits(philox.rbg_key(key), ((r + 1) // 2,) + tuple(shape[1:]),
                        device)
    return torch.cat([words & 0xFFFF, words >> 16], dim=0)[:r]


def sample_edge_delays(key, shape, lo: int, hi: int, device,
                       impl: str = "threefry") -> torch.Tensor:
    """One delay per edge, in [lo, hi), as int32 on ``device``.
    ``"threefry"`` is ``jax.random.randint``; ``"rbg"`` maps Philox words
    to integers: 16-bit fields masked to a power-of-two span, else whole
    words modulo the span.  Lane keys ``[L, 2]`` give ``[L, *shape]``, by
    the current :func:`lane_rule`."""
    shape = tuple(int(s) for s in shape)
    if impl == "threefry":
        return threefry.randint(key, shape, lo, hi, device)
    if impl != "rbg":
        raise ValueError(f"unknown edge sampler impl {impl!r}")
    span = hi - lo
    if span & (span - 1) == 0 and span <= (1 << 16):
        if not shape:
            return sample_edge_delays(key, (1,), lo, hi, device, impl)[..., 0]
        fields = _half_words(key, shape, device)
        return (lo + (fields & (span - 1))).to(torch.int32)
    if _lanes(key):
        words = _philox_lanes(key, shape, device)
    else:
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
    halves of each Philox word (mean 0, variance 1, float32).  Lane keys
    give ``[L, *shape]`` by the first-lane rule."""
    shape = tuple(int(s) for s in shape)
    if not shape:
        return _fast_normal(key, (1,), device)[..., 0]
    z = _popcount16(_half_words(key, shape, device))
    return (z.to(_F32) - 8.0) * 0.5


def binom(key, n, p: float, mode: str = "exact") -> torch.Tensor:
    """Binomial(n, p) draw (float32, shape of ``n``); ``"normal"`` is the
    Gaussian approximation ``clip(round(mu + sigma*z), 0, n)``.  Lane keys
    ``[L, 2]`` take an ``n`` of ``[L, ...]``."""
    n = n.to(_F32)
    if mode == "normal":
        shape = n.shape[1:] if _lanes(key) else n.shape
        return _round_normal(n, p, _fast_normal(key, shape, n.device))
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


def _chain(n, probs: np.ndarray, normal_z, exact_draw):
    """The conditional-binomial chain behind the multinomial bucket counts,
    float32 ``n`` into ``len(probs)`` buckets: bucket ``b`` takes
    ``Binomial(remaining, probs[b] / p_left)``, the last one the remainder
    (it draws nothing).  ``normal_z[b]`` are the Gaussian draws of bucket
    ``b`` (``"normal"``), else ``exact_draw(b, remaining, frac)`` draws it.
    Returns int32 ``[B, *n.shape]``."""
    nb = len(probs)
    remaining = n
    p_left = 1.0
    out = []
    for b, pb in enumerate(probs):
        frac = float(min(max(pb / max(p_left, 1e-9), 0.0), 1.0))
        if b == nb - 1 or frac >= 1.0:
            c = remaining
        elif normal_z is not None:
            c = _round_normal(remaining, frac, normal_z[b])
        else:
            c = exact_draw(b, remaining, frac)
        out.append(c)
        remaining = remaining - c
        p_left -= pb
    return torch.stack(out).to(torch.int32)


def sample_bucket_counts(key, n, probs: np.ndarray, mode: str = "exact"):
    """Split ``n`` (int tensor, any shape) into bucket counts ~
    Multinomial(n, probs): int32 of shape ``(len(probs),) + n.shape``.
    ``"normal"``: one Philox draw for all buckets; ``"exact"``: bucket ``b``
    draws on ``fold_in(key, b)``.  Lane keys ``[L, 2]`` take an ``n`` of
    ``[L, ...]``: the Gaussian draws by the current :func:`lane_rule`, the
    exact chains per lane (:func:`sample_bucket_counts_vmapped`)."""
    nb = len(probs)
    if _lanes(key):
        if mode == "normal":
            n = n.to(_F32)
            z = _fast_normal(key, (max(nb - 1, 1),) + tuple(n.shape[1:]), n.device)
            return _chain(n, probs, z.movedim(1, 0), None)
        return sample_bucket_counts_vmapped(np.asarray(key)[None], n[None], probs,
                                            mode)[:, 0]
    n = n.to(_F32)
    if mode == "normal":
        z = _fast_normal(key, (max(nb - 1, 1),) + tuple(n.shape), n.device)
        return _chain(n, probs, z, None)
    keys = threefry.fold_in(key, np.arange(max(nb - 1, 1)))
    return _chain(n, probs, None, lambda b, rem, frac: binom(keys[b], rem, frac, mode))


def _fast_normal_vmapped(keys, shape, device) -> torch.Tensor:
    """``jax.vmap(_fast_normal)`` over ``W`` lanes, for ``G`` vmaps at once:
    ``keys [G, W, 2]`` → ``[G, W, *shape]``.  Under ``vmap`` the JAX draw is
    not per lane: the batching rule of ``rng_bit_generator`` draws the FIRST
    lane's key at shape ``(W, *shape)`` and hands row ``w`` to lane ``w``
    (``jax/_src/lax/control_flow/loops.py``, ``_rng_bit_generator_batching_
    rule``), so lane ``w`` gets other values than ``_fast_normal(keys[w])``
    alone whenever ``W > 1``."""
    shape = tuple(int(s) for s in shape)
    g, w = keys.shape[:2]
    r = shape[0]
    words = philox.bits(philox.rbg_key(keys[:, 0]), (w, (r + 1) // 2) + shape[1:], device)
    half = torch.cat([words & 0xFFFF, words >> 16], dim=2)[:, :, :r]
    return (_popcount16(half).to(_F32) - 8.0) * 0.5


def sample_bucket_counts_vmapped(keys, n, probs: np.ndarray, mode: str = "exact"):
    """``jax.vmap(sample_bucket_counts)`` over ``W`` lanes, ``G`` vmaps at
    once: ``keys [G, W, 2]`` (one threefry key a lane) and counts ``n [G, W,
    ...]`` → int32 ``[B, G, W, ...]``.  ``"exact"``: each lane's chain of
    binomials on its own keys, every rejection loop ending each lane where
    its own loop would (utils/threefry.binomial on lane keys); ``"normal"``:
    the Gaussian draws of each vmap come from its first lane's key
    (:func:`_fast_normal_vmapped`)."""
    keys = np.asarray(keys, np.int64)
    g, w = keys.shape[:2]
    n = n.to(_F32)
    rest = tuple(n.shape[2:])
    nb = len(probs)
    if mode == "normal":
        z = _fast_normal_vmapped(keys, (max(nb - 1, 1),) + rest, n.device)
        return _chain(n, probs, z.movedim(2, 0), None)
    lane_keys = keys.reshape(g * w, 2)

    def draw(b, rem, frac):
        return threefry.binomial(threefry.fold_in(lane_keys, b),
                                 rem.reshape((g * w,) + rest), frac, n.device).reshape(rem.shape)

    return _chain(n, probs, None, draw)
