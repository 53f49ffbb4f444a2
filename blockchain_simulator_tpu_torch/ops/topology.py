"""Gossip topology (port of ``blockchain_simulator_tpu/ops/topology.py``).

The reference builds a full mesh; for 10k+ nodes (BASELINE config 3) requests
*flood* with a hop TTL over a random k-out digraph instead.
``kregular_out_neighbors`` returns a ``[N, deg]`` table of global receiver
ids: column 0 is the successor ring edge (strong connectivity), the other
columns are independent random permutations (one out-edge per node each).
Self-loops and duplicate edges can occur in the random columns and are
harmless: gossip delivery deduplicates by value at the receiver.

The two numpy functions are copies of the JAX package's, so the same numpy
gives the same table.  :func:`neighbours` builds the table once per
``(n, deg, seed)`` and keeps it on the device, for every tick of a run.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def kregular_out_neighbors(n: int, deg: int, seed: int) -> np.ndarray:
    """[N, deg] int32 global out-neighbour table (ring + deg-1 random
    permutation columns), deterministic in ``seed``."""
    if deg < 2:
        raise ValueError(f"gossip degree must be >= 2, got {deg}")
    rng = np.random.default_rng(seed ^ 0x70B0)
    cols = [(np.arange(n) + 1) % n]
    for _ in range(deg - 1):
        cols.append(rng.permutation(n))
    return np.stack(cols, axis=1).astype(np.int32)


def flood_reach_hops(n: int, deg: int, nbrs: np.ndarray, src: int) -> int:
    """BFS hop count to reach every node from ``src`` (test/validation aid)."""
    dist = np.full(n, -1)
    dist[src] = 0
    frontier = [src]
    hops = 0
    while frontier:
        hops += 1
        nxt = []
        for u in frontier:
            for v in nbrs[u]:
                if dist[v] < 0:
                    dist[v] = hops
                    nxt.append(v)
        frontier = nxt
    if (dist < 0).any():
        raise ValueError("gossip graph not strongly connected from src")
    return int(dist.max())


@functools.lru_cache(maxsize=8)
def neighbours(n: int, deg: int, seed: int, device) -> torch.Tensor:
    """The ``[N, deg]`` int64 out-neighbour table of a config on ``device``
    (the gossip models pass ``cfg.seed``, never a run's seed, as the JAX
    package does)."""
    table = kregular_out_neighbors(n, deg, seed)
    return torch.as_tensor(table, dtype=torch.int64, device=device)
