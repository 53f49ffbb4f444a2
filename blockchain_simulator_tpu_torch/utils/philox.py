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

from blockchain_simulator_tpu_torch.utils import threefry
from blockchain_simulator_tpu_torch.utils.threefry import lane_tensor

MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def rbg_key(threefry_key) -> np.ndarray:
    """``delay._rbg_key``: the 4-word ``rbg`` key of a 2-word threefry key
    (``tile(words, 2)``); keys ``[..., 2]`` give ``[..., 4]``."""
    k = np.asarray(threefry_key, np.int64)
    if k.shape[-1:] != (2,):
        raise ValueError(f"expected threefry keys of shape (..., 2), got {k.shape}")
    return np.concatenate([k, k], axis=-1) & MASK


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
    int64 tensor of uint32 values on ``device``.  A stack of keys ``[G, 4]``
    gives ``[G, *shape]``, row ``g`` the bits of key ``g``."""
    shape = tuple(int(s) for s in shape)
    k = np.asarray(key, np.int64)
    if k.shape[-1:] != (4,) or k.ndim > 2:
        raise ValueError("expected one rbg key of 4 words, or a [G, 4] stack")
    view = threefry.view_index(shape, device)
    if view is not None:
        # a row view (threefry.row_view): each element's word of its block
        # in the full array, the block computed for that element alone
        if k.ndim != 1:
            raise ValueError("a row view draws with one key, not a key stack")
        w = [int(x) & MASK for x in k]
        blk, word = view >> 2, view & 3
        c0 = w[2] + blk
        c1 = w[3] + (c0 >> 32)
        c2 = w[0] + (c1 >> 32)
        c3 = w[1] + (c2 >> 32)
        out = torch.stack(philox4x32(w[0], w[1], c0 & MASK, c1 & MASK, c2 & MASK,
                                     c3 & MASK), dim=-1)
        return out.gather(-1, word[..., None])[..., 0]
    count = math.prod(shape)
    nblocks = (count + 3) // 4
    i = torch.arange(nblocks, dtype=torch.int64, device=device)
    if k.ndim == 1:
        w = [int(x) & MASK for x in k]
    else:  # one row of key words a key, against one column of blocks
        kw = lane_tensor(k & MASK, device)
        w = [kw[:, j:j + 1] for j in range(4)]
        i = i[None]
    # the 128-bit counter base + i, kept as four 32-bit words: the key's
    # words 2, 3 are its low half and 0, 1 its high half; carries ripple up
    c0 = w[2] + i
    c1 = w[3] + (c0 >> 32)
    c2 = w[0] + (c1 >> 32)
    c3 = w[1] + (c2 >> 32)
    out = torch.stack(philox4x32(w[0], w[1], c0 & MASK, c1 & MASK, c2 & MASK, c3 & MASK),
                      dim=-1)
    if k.ndim == 1:
        return out.reshape(-1)[:count].reshape(shape)
    return out.reshape(k.shape[0], -1)[:, :count].reshape((k.shape[0],) + shape)
