"""Future-inbox ring buffers (port of ``blockchain_simulator_tpu/ops/ring.py``).

A channel buffer has shape ``[D, N, ...]``; a message scheduled at tick ``t``
with delay ``d`` lands in slice ``(t + d) % D``; at tick ``t`` the simulator
*pops* slice ``t % D`` (read + zero).  ``D`` exceeds the maximum scheduling
horizon (``SimConfig.ring_depth``).

Unlike the JAX package (immutable arrays), the rings are updated IN PLACE:
every function returns the buffer it was given, mutated.  ``t`` is a
one-element int32 tensor on the ring's device and is never read back to the
host: pop indexes with it, and the pushes hand it to the kernel as a device
pointer (ops/ring_kernel.py).  :func:`ring_push_group` applies several
pushes, each on its own ring, in one kernel launch.
"""

from __future__ import annotations

import torch

from blockchain_simulator_tpu_torch.ops import ring_kernel


def ring_pop(buf, t):
    """Read and clear the current tick's slice. Returns (slice, buf)."""
    idx = torch.remainder(t.reshape(1).to(torch.int64), buf.shape[0])
    cur = buf.index_select(0, idx)[0]
    buf.index_fill_(0, idx, 0)
    return cur, buf


def ring_push_add(buf, t, lo: int, contrib):
    """Add ``contrib[b, ...]`` into slices ``t+lo+b``, b in [0, B)."""
    return ring_kernel.push(buf, t, lo, contrib, "add")


def ring_push_max(buf, t, lo: int, contrib):
    """Max-combine (for value channels where 0 == empty)."""
    return ring_kernel.push(buf, t, lo, contrib, "max")


def ring_push_group(items, t):
    """Apply every ``(buf, lo, contrib, op)`` of ``items`` (op "add" or
    "max", each on its own ring) at tick ``t``: one kernel launch on the
    card.  The rings are updated in place."""
    ring_kernel.push_group(items, t)
