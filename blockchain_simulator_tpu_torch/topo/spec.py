"""Topology representation and the seeded k-regular overlay tables (port of
``blockchain_simulator_tpu/topo/spec.py``).

``TopoSpec`` is the typed view of ``SimConfig``'s topology axis.  The
``kregular`` member is a *circulant* k-regular digraph: a seeded choice of
k distinct offsets from 1..N-1 (offset 1 always included, so the successor
ring makes the graph strongly connected) plus offset 0, the self slot that
delivery masks.  Node j hears ``{(j + o) % N}`` and is heard by
``{(j - o) % N}`` over the same offset set, so the graph is k-in and
k-out regular with aligned slot tables.

Rows are sorted ascending: at degree k = N-1 every row is ``[0, 1, ..,
N-1]``, the identity table, so the slot-major ``[K, N]`` delay draws of the
gather primitives (ops/gatherdeliv.py) are the very arrays the dense
``[N, N]`` path draws from the same keys, and a kregular run at k = N-1
equals the dense run.

Pure numpy, a copy of the JAX package's functions: the same numpy gives the
same tables.  One difference: the JAX function finds the ``inslot``
cross-index through an ``[N, K, K]`` intermediate, which is N³ at
k = N-1 (8 GB at N = 1000); :func:`_tables` finds the same index with one
``searchsorted`` over the flattened in-table, in O(N·K) memory.
:func:`device_tables` keeps a config's tables on a device as int64, the
index type torch's gathers take, built once per ``(n, degree, seed,
device)``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

# Topology kinds (SimConfig.topology after the "dense" -> "full" alias).
DENSE = "full"
GOSSIP = "gossip"
KREGULAR = "kregular"
COMMITTEE = "committee"


@dataclasses.dataclass(frozen=True)
class TopoSpec:
    """The structural identity of one topology: everything that changes
    the shapes a run works on."""

    kind: str
    n: int
    degree: int = 0       # kregular overlay degree k (0 for other kinds)
    committees: int = 0   # committee count (0 for other kinds)
    seed: int = 0         # overlay construction seed (kregular only)

    @classmethod
    def from_config(cls, cfg) -> "TopoSpec":
        if cfg.topology == KREGULAR:
            return cls(KREGULAR, cfg.n, degree=cfg.degree, seed=cfg.topo_seed)
        if cfg.topology == COMMITTEE:
            return cls(COMMITTEE, cfg.n, committees=cfg.committees)
        return cls(cfg.topology, cfg.n)

    @property
    def slots(self) -> int:
        """Neighbour-table slot count K = degree + 1 (the self slot rides
        along, masked at delivery; at k = N-1, K = N and the table is the
        identity)."""
        return self.degree + 1

    @property
    def committee_size(self) -> int:
        return self.n // self.committees if self.committees else self.n


@functools.lru_cache(maxsize=64)
def circulant_offsets(n: int, degree: int, seed: int) -> tuple:
    """The seeded offset set of the circulant overlay: ``degree`` distinct
    values from 1..n-1 (offset 1 always included), plus offset 0 (the self
    slot).  Deterministic in (n, degree, seed)."""
    if not 1 <= degree <= n - 1:
        raise ValueError(f"degree={degree} must be in [1, {n - 1}]")
    if degree == n - 1:
        return tuple(range(n))  # the full mesh: every offset
    rng = np.random.default_rng(np.uint64(seed) ^ np.uint64(0x70B0_C14C))
    rest = rng.choice(np.arange(2, n), size=degree - 1, replace=False)
    return tuple(sorted({0, 1, *rest.tolist()}))


@functools.lru_cache(maxsize=32)
def _tables(n: int, degree: int, seed: int):
    """(nbr_in, nbr_out, inslot_of_out) int32 tables, rows sorted.

    - ``nbr_in[j]``  = sorted ``{(j + o) % n : o in O}``, who j hears;
    - ``nbr_out[i]`` = sorted ``{(i - o) % n : o in O}``, who hears i;
    - ``inslot_of_out[i, s]`` = the slot of i inside
      ``nbr_in[nbr_out[i, s]]``, the cross-index that lets a requester
      gather its per-slot replies back.

    i sits in exactly one slot of ``nbr_in[r]`` for every receiver
    ``r = nbr_out[i, s]``.  Each row is sorted and distinct, so the keys
    ``r * n + nbr_in[r, s]`` of the flattened table are strictly increasing,
    and one ``searchsorted`` of ``r * n + i`` finds that slot."""
    offs = np.asarray(circulant_offsets(n, degree, seed), np.int64)
    k1 = len(offs)
    ids = np.arange(n, dtype=np.int64)[:, None]
    nbr_in = np.sort((ids + offs[None, :]) % n, axis=1)
    nbr_out = np.sort((ids - offs[None, :]) % n, axis=1)
    flat = (np.arange(n, dtype=np.int64)[:, None] * n + nbr_in).reshape(-1)
    pos = np.searchsorted(flat, nbr_out * n + ids)
    inslot = pos - nbr_out * k1
    assert (nbr_in.reshape(-1)[pos] == ids).all()
    return (nbr_in.astype(np.int32), nbr_out.astype(np.int32),
            inslot.astype(np.int32))


def in_table(n: int, degree: int, seed: int) -> np.ndarray:
    """[N, K] sorted in-neighbour table (K = degree + 1, self included)."""
    return _tables(n, degree, seed)[0]


def out_table(n: int, degree: int, seed: int) -> np.ndarray:
    """[N, K] sorted out-neighbour table."""
    return _tables(n, degree, seed)[1]


def inslot_table(n: int, degree: int, seed: int) -> np.ndarray:
    """[N, K]: ``inslot_table(..)[i, s]`` = slot of i in
    ``in_table(..)[out_table(..)[i, s]]`` (the reply-gather cross-index)."""
    return _tables(n, degree, seed)[2]


@functools.lru_cache(maxsize=8)
def device_tables(n: int, degree: int, seed: int, device) -> tuple:
    """``(in, out, inslot)`` as int64 tensors on ``device``: converted once
    per config and device, then read by every tick of every run."""
    return tuple(torch.as_tensor(t, dtype=torch.int64, device=device)
                 for t in _tables(n, degree, seed))


def owner_bucket_plan(table, n_shards: int, capacity: int | None = None):
    """Build-time owner-bucketed exchange plan for a ``[N_pad, K]`` neighbour
    table over ``n_shards`` node shards (row g on shard ``g // n_loc``).
    Returns ``(pos, send)``: ``send[o, d, :]`` the shard-local rows owner
    ``o`` ships to receiver ``d`` (zero-padded to the bucket capacity C),
    ``pos[i, j]`` where ``table[i, j]`` lands in the receiver's concatenated
    ``[D * C]`` exchange buffer.  A ``capacity`` below the required C raises
    ``ValueError``: overflow is checked, never a silent truncation.  The
    plan is numpy; parallel/partition.NeighborExchange ships it."""
    table = np.asarray(table)
    n_pad, _k = table.shape
    if n_shards < 1 or n_pad % n_shards:
        raise ValueError(
            f"owner_bucket_plan: N_pad={n_pad} not divisible by "
            f"n_shards={n_shards}"
        )
    n_loc = n_pad // n_shards
    if table.size and (table.min() < 0 or table.max() >= n_pad):
        raise ValueError("owner_bucket_plan: table entries outside [0, N_pad)")
    # pass 1: per receiver shard, the sorted distinct referenced rows; the
    # owner g // n_loc is monotone in g, so each owner's bucket is a
    # contiguous run of the sorted uniques
    per_recv = []
    required = 0
    shard_ids = np.arange(n_shards)
    for d in range(n_shards):
        uniq, inv = np.unique(table[d * n_loc:(d + 1) * n_loc],
                              return_inverse=True)
        starts = np.searchsorted(uniq // n_loc, shard_ids)
        counts = np.diff(np.append(starts, len(uniq)))
        required = max(required, int(counts.max()) if len(uniq) else 0)
        per_recv.append((uniq, inv, starts))
    if capacity is None:
        capacity = required
    elif capacity < required:
        raise ValueError(
            f"owner_bucket_plan: bucket capacity {capacity} < required "
            f"{required} (n_shards={n_shards}, n_loc={n_loc}) — refusing to "
            "truncate the exchange"
        )
    # pass 2: fill pos (receiver-buffer positions) and send (owner rows)
    capacity = max(capacity, 1)
    pos = np.empty_like(table, dtype=np.int32)
    send = np.zeros((n_shards, n_shards, capacity), np.int32)
    for d in range(n_shards):
        uniq, inv, starts = per_recv[d]
        own = uniq // n_loc
        rank = np.arange(len(uniq)) - starts[own]
        pos[d * n_loc:(d + 1) * n_loc] = (
            own[inv] * capacity + rank[inv]
        ).reshape(n_loc, -1).astype(np.int32)
        send[own, d, rank] = (uniq - own * n_loc).astype(np.int32)
    return pos, send


def overlay_diameter(n: int, degree: int, seed: int) -> int:
    """BFS diameter of the out-digraph from node 0 (a validation aid; the
    circulant is vertex-transitive, so one source suffices)."""
    nbr = out_table(n, degree, seed)
    dist = np.full(n, -1)
    dist[0] = 0
    frontier = [0]
    hops = 0
    while frontier:
        hops += 1
        nxt = []
        for u in frontier:
            for v in nbr[u]:
                if dist[v] < 0:
                    dist[v] = hops
                    nxt.append(v)
        frontier = nxt
    if (dist < 0).any():
        raise ValueError("overlay not strongly connected (a table construction bug)")
    return int(dist.max())
