"""XLA's Philox bit stream (``jax.random`` on an ``rbg`` key), bit for bit.

On XLA:CPU, ``jax.random.bits`` on an ``rbg`` key (4 uint32 words
``w0..w3``) is textbook Philox-4x32-10 with this layout:

- the Philox key is ``(w0, w1)``;
- block ``i`` has the 128-bit counter whose low 64 bits are
  ``(w2 | w3 << 32) + i`` and whose high 64 bits are ``(w0 | w1 << 32)``
  plus the carry out of the low half;
- each block gives four output words, in order; the words are flattened
  row-major over the requested shape and cut to its element count.

The JAX package derives its ``rbg`` keys from threefry keys by tiling the two
words (``ops/delay._rbg_key``), so :func:`rbg_key` does the same.

uint32 arithmetic is done in int64 masked with ``0xFFFFFFFF``.  The 32x32-bit
products of a Philox round are taken as int64 products that wrap modulo
2**64: the exact product is below 2**64, so its low 64 bits, which is what a
wrapping int64 multiply keeps, hold all of it, and the high word is
``(p >> 32) & MASK`` whatever the sign the wrap gave ``p``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def rbg_key(threefry_key) -> np.ndarray:
    """``delay._rbg_key``: the 4-word ``rbg`` key of a 2-word threefry key
    (``tile(words, 2)``)."""
    k = np.asarray(threefry_key, np.int64)
    if k.shape != (2,):
        raise ValueError(f"expected one threefry key of shape (2,), got {k.shape}")
    return np.concatenate([k, k]) & MASK


def _mulhilo(m: int, x):
    p = x * m  # wraps modulo 2**64; the low 64 bits are the exact product
    return (p >> 32) & MASK, p & MASK


def philox4x32(k0: int, k1: int, c0, c1, c2, c3):
    """Philox-4x32-10 over the broadcast of the counter words (int64
    tensors of uint32 values); the key words are Python ints.  Returns the
    four output words."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & MASK, (k1 + _W1) & MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits(key, shape, device) -> torch.Tensor:
    """32-bit ``jax.random.bits(key, shape)`` for a 4-word ``rbg`` key, as an
    int64 tensor of uint32 values on ``device``."""
    shape = tuple(int(s) for s in shape)
    w = [int(x) & MASK for x in np.asarray(key, np.int64).reshape(-1)]
    if len(w) != 4:
        raise ValueError("expected one rbg key of 4 words")
    count = math.prod(shape)
    nblocks = (count + 3) // 4
    base_lo = w[2] | (w[3] << 32)
    base_hi = w[0] | (w[1] << 32)
    i = torch.arange(nblocks, dtype=torch.int64, device=device)
    # low 64 bits of the counter, kept as two 32-bit halves: base + i, with
    # the carry out of bit 63 raising the high half
    lo_lo = (base_lo & MASK) + i
    lo_hi = (base_lo >> 32) + (lo_lo >> 32)
    hi_lo = (base_hi & MASK) + (lo_hi >> 32)
    hi_hi = (base_hi >> 32) + (hi_lo >> 32)
    c0, c1 = lo_lo & MASK, lo_hi & MASK
    c2, c3 = hi_lo & MASK, hi_hi & MASK
    out = torch.stack(philox4x32(w[0], w[1], c0, c1, c2, c3), dim=1)
    return out.reshape(-1)[:count].reshape(shape)
