"""Protocol backend API (port of ``blockchain_simulator_tpu/models/base.py``).

A protocol backend is a module of plain functions, selected at runtime by
name:

- ``init(cfg, key, device) -> (state, bufs)`` — the [N, ...] state and the
  future-inbox ring buffers, on ``device``.
- ``step(cfg, state, bufs, t, tkey) -> (state, bufs)`` — one 1 ms tick for
  all N nodes at once.
- ``metrics(cfg, state) -> dict`` — host-side structured metrics.

*Lanes.*  Every tick engine also steps ``L`` runs side by side: a state
whose fields lead with a lane axis ``[L, N, ...]`` (:func:`init_lanes`),
rings ``[D, L, N, ...]`` (D-leading, so a tick's pushes stay one grouped
launch over ``L·N`` rows) and lane keys ``[L, 2]``.  A gate the solo step
reads once a tick is read once a tick for all lanes ("any lane"), and a
lane whose own gate is shut contributes zeros, as ``jax.vmap``'s select of
the shut branch gives it.  Lane ``l`` equals JAX's vmapped row ``l`` of the
batch (the first-lane rule of ops/delay.py) or, under
``ops/delay.lane_rule(1)``, the solo run of its key (``lax.map``).
"""

from __future__ import annotations

import dataclasses

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
    """Host-side metrics for ONE final state, topology-aware: a committee
    run's final state is stacked ``[C, ...]`` and its metrics are the
    two-level aggregate (topo/committee.py); every other topology reports
    the flat protocol's own."""
    if cfg.topology == "committee":
        from blockchain_simulator_tpu_torch.topo import committee

        return committee.metrics(cfg, final)
    return get_protocol(cfg.protocol).metrics(cfg, final)


def gated(pred, fn, zeros, axis=None):
    """Skip a delivery computation when no sender is active this tick.

    JAX's ``lax.cond`` becomes a host branch: ``pred`` is read back to the
    host, one device sync per read.  The skipped branch would have
    produced exactly ``zeros`` (its keys are pure functions of seed, tick and
    channel, so skipping it consumes nothing), hence the same numbers as
    evaluating it; the sync costs far less than the O(N^2) edge sampling it
    saves on idle ticks.  A step with several gates a tick reads their
    predicates together and passes each gate a host bool (PBFT's PREPARE,
    COMMIT and block gates share one read, Raft's election and heartbeat
    gates another; PERF.md §3 counts the reads a tick).
    Sharded (``axis`` set), the branch holds collectives, so the predicate
    is MAX-reduced over the mesh first and every rank takes the same
    branch, as JAX pmax-reduces it before its ``lax.cond``."""
    from blockchain_simulator_tpu_torch.ops.delivery import agree

    return fn() if agree(pred, axis) else zeros


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


def dyn_fault_masks(n: int, n_crashed, n_byzantine, device):
    """:func:`fault_masks` with the counts as run-time operands: ints give
    ``[N]`` masks, ``[B]`` count tensors (one count a lane) give ``[B, N]``.
    Same id layout and the same int comparisons, so equal counts give the
    static masks (JAX's ``dyn_fault_masks``)."""
    ids = torch.arange(n, dtype=torch.int32, device=device)
    nc = torch.as_tensor(n_crashed, dtype=torch.int32, device=device)
    nb = torch.as_tensor(n_byzantine, dtype=torch.int32, device=device)
    nc, nb = torch.broadcast_tensors(nc, nb)
    if nc.ndim:  # one count a lane
        nc, nb = nc[:, None], nb[:, None]
    return ids < (n - nc), ids < (n - nc - nb)


def canonical_fault_cfg(cfg):
    """The one static config whose dynamic-operand program serves every
    (n_crashed, n_byzantine) point of a count sweep: the counts and the
    seed zeroed, so every sweep over the same fault *structure* (drop_prob,
    byz_forge, byz_copies) shares it.  ``byz_forge`` keeps a static
    ``n_byzantine = 1`` sentinel: ``pbft.step`` includes the forge wave only
    when the static count is positive, and the wave is driven by the
    ``alive & ~honest`` forger mask, all false at a run-time f = 0 (JAX's
    ``canonical_fault_cfg``)."""
    f = cfg.faults
    return cfg.with_(seed=0, faults=dataclasses.replace(
        f, crash_frac=0.0, n_crashed=-1, n_byzantine=1 if f.byz_forge else 0))


def apply_fault_masks(cfg, state, alive, honest):
    """Install run-time fault masks into a state freshly built at the
    canonical (fault-free) config: equal to ``init`` at the static config
    with those counts.  Raft also re-disarms the election deadlines of the
    crashed nodes (models/raft.init: a crashed node never starts an
    election).  Masks ``[B, N]`` go with a lane-stacked state."""
    state = dataclasses.replace(state, alive=alive, honest=honest)
    if cfg.protocol == "raft":
        from blockchain_simulator_tpu_torch.models.raft import DISARM

        state = dataclasses.replace(state, election_deadline=torch.where(
            alive, state.election_deadline, DISARM))
    return state


def init_lanes(cfg, keys, device):
    """``proto.init`` over lane keys ``[L, 2]``: one init a lane, every state
    field stacked on a leading lane axis (:func:`stack_lanes`) and every
    ring on the axis after its slots, ``[D, L, ...]``."""
    proto = get_protocol(cfg.protocol)
    outs = [proto.init(cfg, k, device=device) for k in np.asarray(keys, np.int64)]
    bufs = outs[0][1]
    return (stack_lanes([s for s, _ in outs]), dataclasses.replace(bufs, **{
        f.name: torch.stack([getattr(b, f.name) for _, b in outs], dim=1)
        for f in dataclasses.fields(bufs)}))


def tick_loop(cfg, state, bufs, key, start: int, stop: int, topo_tables=None, probe=None,
              exchange=None):
    """``proto.step`` over ticks ``[start, stop)`` on the state's device, the
    tick a one-element int32 tensor there and the tick keys computed on the
    host up front; lane keys ``[L, 2]`` step a lane-stacked state (module
    docstring).  ``topo_tables`` hands the kregular overlay's device
    tables to every step, and ``exchange`` the sharded overlay's neighbour
    exchange (parallel/partition.NeighborExchange).  Tick keys derive
    from the absolute tick, so loops chained end to end equal one.  Returns ``(state, bufs)``; with ``probe``
    (``state -> {name: 0-d tensor}``, utils/trace.probe) ``(state, bufs,
    ys)``, ``ys`` the samples after every tick stacked ``[stop - start]`` on
    the device (:func:`stack_samples`: no host read)."""
    from blockchain_simulator_tpu_torch.utils import prng

    proto = get_protocol(cfg.protocol)
    ticks = torch.arange(start, stop, dtype=torch.int32, device=state_device(state))
    tkeys = prng.tick_key(np.asarray(key)[None],
                          np.arange(start, stop).reshape((-1,) + (1,) * (np.ndim(key) - 1)))
    kw = {} if topo_tables is None else {"topo_tables": topo_tables}
    if exchange is not None:
        kw["exchange"] = exchange
    samples = []
    for i in range(stop - start):
        state, bufs = proto.step(cfg, state, bufs, ticks[i], tkeys[i], **kw)
        if probe is not None:
            samples.append(probe(state))
    if probe is None:
        return state, bufs
    return state, bufs, stack_samples(samples, lambda: probe(state))


def stack_samples(samples: list, template=None) -> dict:
    """Per-step probe samples (dicts of tensors) stacked on a new leading
    step axis, on their device: the ``ys`` of a ``lax.scan``.  With no
    samples, ``template()`` (one sample) gives each key's dtype and shape,
    and the stack is empty, as a scan of length 0 gives.  A dict value
    (obsim's ``{"series": {...}, "monitors": {...}}``) is stacked key by
    key."""
    if not samples:
        return {k: torch.zeros((0,) + tuple(v.shape), dtype=v.dtype, device=v.device)
                for k, v in template().items()}
    return {k: (stack_samples([s[k] for s in samples]) if isinstance(samples[0][k], dict)
                else torch.stack([s[k] for s in samples])) for k in samples[0]}


def state_device(state) -> torch.device:
    """The device of a state's tensors (a nested state's first one)."""
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        return v.device if isinstance(v, torch.Tensor) else state_device(v)
    raise ValueError("a state without fields")


def lane_state(state, i: int):
    """Lane ``i`` of a lane-stacked state (every field's leading axis),
    as views."""
    return dataclasses.replace(state, **{
        f.name: (v[i] if isinstance(v, torch.Tensor) else lane_state(v, i))
        for f in dataclasses.fields(state) for v in (getattr(state, f.name),)})


def stack_lanes(states: list):
    """One lane-stacked state from per-lane states of one shape: the form
    ``jax.vmap`` returns, every field stacked on a new leading axis."""
    first = states[0]
    return dataclasses.replace(first, **{
        f.name: (torch.stack([getattr(s, f.name) for s in states])
                 if isinstance(getattr(first, f.name), torch.Tensor)
                 else stack_lanes([getattr(s, f.name) for s in states]))
        for f in dataclasses.fields(first)})
