"""Protocol backend API (port of ``blockchain_simulator_tpu/models/base.py``).

A protocol backend is a module of plain functions, selected at runtime by
name:

- ``init(cfg, key, device) -> (state, bufs)`` — the [N, ...] state and the
  future-inbox ring buffers, on ``device``.
- ``step(cfg, state, bufs, t, tkey) -> (state, bufs)`` — one 1 ms tick for
  all N nodes at once.
- ``metrics(cfg, state) -> dict`` — host-side structured metrics.
"""

from __future__ import annotations

import numpy as np
import torch


def get_protocol(name: str):
    """Runtime protocol selection.  The port runs PBFT, Raft, Paxos and
    the mixed shard sim."""
    if name == "pbft":
        from blockchain_simulator_tpu_torch.models import pbft as m

        return m
    if name == "raft":
        from blockchain_simulator_tpu_torch.models import raft as m

        return m
    if name == "paxos":
        from blockchain_simulator_tpu_torch.models import paxos as m

        return m
    if name == "mixed":
        from blockchain_simulator_tpu_torch.models import mixed as m

        return m
    raise ValueError(f"unknown protocol {name!r}")


def sim_metrics(cfg, final) -> dict:
    """Host-side metrics for ONE final state (the committee topology's
    stacked metrics come with the sparse-topology slice)."""
    if cfg.topology == "committee":
        raise NotImplementedError(
            "committee topology metrics come with slice 5 of the port "
            "(sparse topologies)"
        )
    return get_protocol(cfg.protocol).metrics(cfg, final)


def gated(pred, fn, zeros):
    """Skip a delivery computation when no sender is active this tick.

    JAX's ``lax.cond`` becomes a host branch: ``pred`` is read back to the
    host, one device sync per gate per tick.  The skipped branch would have
    produced exactly ``zeros`` (its keys are pure functions of seed, tick and
    channel, so skipping it consumes nothing), hence the same numbers as
    evaluating it; the sync costs far less than the O(N^2) edge sampling it
    saves on idle ticks (measured: 3 syncs per tick at n = 1000, PERF.md).
    Unsharded only: a sharded gate needs a global predicate (many-GPU
    slice)."""
    return fn() if bool(pred) else zeros


def fault_masks(cfg, n: int, device):
    """(alive[N], honest[N]) bool masks from the fault config.

    Crashed nodes occupy the last ``n_crashed`` ids, Byzantine the last
    ``n_byzantine`` alive ids before them."""
    f = cfg.faults
    nc = f.resolved_n_crashed(n)
    ids = np.arange(n)
    alive = ids < (n - nc)
    honest = ids < (n - nc - f.n_byzantine)
    return (torch.as_tensor(alive, device=device),
            torch.as_tensor(honest, device=device))
