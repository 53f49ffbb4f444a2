"""Fault and seed sweeps on one device (port of the single-device arms of
``blockchain_simulator_tpu/parallel/sweep.py``).

The outer-axis analog of BASELINE config 4 ("Byzantine-fault sweep
f=0..n/3"): many (fault level, seed) points of one fault *structure* run as
one program with the fault COUNTS and the seeds as operands
(runner.make_dyn_sim_fn).  Structurally distinct configs (drop_prob,
byz_forge, byz_copies) form separate groups; the mixed shard sim, which has
no dynamic-fault program, takes the static per-config path.

*Lanes are not a loop.*  The JAX package runs a group as
``jit(vmap(make_dyn_sim_fn(canon)))``.  Under ``vmap`` its Philox draws (the
``"normal"`` stat sampler, the ``"rbg"`` edge sampler) follow the first
lane's key (``rng_bit_generator``'s batching rule), so a vmapped row is not
the solo run of its point whenever those samplers run.  The port therefore
runs a group's lanes side by side, as a leading axis with lane keys ``[B,
2]``, wherever its engine has one (:func:`lane_axis`): PBFT's round path
(models/pbft_round.py), Raft's heartbeat path (models/raft_hb.py, the
handoff's ``lax.cond`` a select per lane) and the Raft tick engine on the
full mesh (models/raft.py).  A round or a tick then makes one lane's
launches, not B times them.  Where the structure draws only per-lane
streams (the ``"exact"`` binomial, threefry edge delays), a vmapped row IS
the solo run, and the lanes of the other engines run one after another.
A batch of B > 1 lanes that would need a lane axis the port's engine lacks
(the PBFT tick engine, Paxos, Raft over gossip or queued links, drawing
``"normal"`` or ``"rbg"``) raises ``NotImplementedError``.

The multi-seed program (JAX's ``lax.map`` of the unvmapped dyn program) has
solo semantics: its lanes run in turn.

Sparse topologies ride the same doors: a kregular config's lanes and a
committee config's lanes run in turn (neither engine has a lane axis; a
committee run is itself a loop over committees, topo/committee.py), with
the refusal of multi-lane ``"normal"`` / ``"rbg"`` batches above.

The run log: with ``$BLOCKSIM_RUNS_JSONL`` set, every row (``{"seed": s,
**metrics}``, at the point's own config) is appended through
``utils/obs.record_run``, as the JAX package's sweeps do; the returned dicts
stay pure metrics.

The services around the dispatch are the JAX package's: the batched
programs are registry entries (utils/aotcache.py: ``"sweep-batched"``,
``"sweep-batched-dynf"``, ``"multi-seed-tick"``), the batched dispatch fires
the ``sweep.dyn_dispatch`` chaos point (chaos/inject.py) and runs inside
``telemetry.profile_region("sweep_dispatch")``, and the fault sweeps fail
fast on a fresh ``wedged`` verdict in ``$BLOCKSIM_HEALTH_JSONL``
(utils/health.require_not_wedged).

Kept out, each raising ``NotImplementedError`` naming its slice: the
node-sharded topology programs (``sharded_topo_sim_fn``,
``run_sharded_topo``) and ``mesh=``: slice 6 (many GPUs); durable and
supervised sweeps (``journal=``, ``supervise=``, ``dyn_chunk_keys``) and
obsim's ``probe=``: the durable-sweeps slice (journal, query, obsim).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from blockchain_simulator_tpu_torch import runner
from blockchain_simulator_tpu_torch.models.base import (
    canonical_fault_cfg,
    lane_state,
    sim_metrics,
    stack_lanes,
)
from blockchain_simulator_tpu_torch.runner import (
    UnbatchableConfigError,
    check_batchable,
    make_dyn_sim_fn,
    resolve_device,
    use_round_schedule,
)
from blockchain_simulator_tpu_torch.chaos import inject
from blockchain_simulator_tpu_torch.utils import aotcache, health, obs, telemetry, threefry
from blockchain_simulator_tpu_torch.utils.config import SimConfig

DURABLE_SWEEPS = ("the durable-sweeps slice of the port (journal, query, obsim; "
                  "ROADMAP.md queue A)")
MANY_GPUS = "slice 6 of the port (many GPUs)"


def _refuse(what: str, where: str):
    raise NotImplementedError(f"{what} comes with {where}")


def _refuse_arms(mesh=None, journal=None, supervise=None, probe=None):
    """The sweep arms later slices bring."""
    if mesh is not None:
        _refuse("mesh= (a sweep over a device mesh)", MANY_GPUS)
    if journal is not None or supervise is not None:
        _refuse("journal= / supervise= (durable, supervised sweeps)", DURABLE_SWEEPS)
    if probe is not None:
        _refuse("probe= (obsim's consensus probes, obsim.schema.ProbeConfig)", DURABLE_SWEEPS)


def _record(rows, cfgs, seeds):
    """Append every row to the optional run log (``$BLOCKSIM_RUNS_JSONL``)
    as ``{"seed": s, **metrics}`` at its own config, as the JAX package's
    sweeps do (utils/obs.record_run: a finalized copy; the rows stay as
    they are)."""
    for m, cfg, seed in zip(rows, cfgs, seeds):
        obs.record_run({"seed": int(seed), **m}, cfg)


def _health_gate():
    """Fail fast on a fresh ``wedged`` verdict in ``$BLOCKSIM_HEALTH_JSONL``
    (utils/health.require_not_wedged raises ``BackendWedgedError``), as the
    JAX package's sweeps do; no log, or a stale or healthy verdict, passes."""
    health.require_not_wedged()


def lane_axis(cfg: SimConfig) -> bool:
    """Does the port step this config's lanes side by side (a leading lane
    axis with lane keys)?  PBFT's round path, Raft's heartbeat path and the
    Raft tick engine on the full mesh without queued links."""
    if cfg.protocol not in ("pbft", "raft"):
        return False
    if use_round_schedule(cfg):
        return True
    return cfg.protocol == "raft" and cfg.topology == "full" and not cfg.queued_links


def philox_draws(cfg: SimConfig) -> bool:
    """Does the config draw on Philox words (the ``"normal"`` stat sampler or
    the ``"rbg"`` edge sampler), whose vmapped draws follow the first lane?"""
    if cfg.protocol == "mixed":
        from blockchain_simulator_tpu_torch.models.mixed import sub_configs

        return any(philox_draws(c) for c in sub_configs(cfg))
    return ((cfg.protocol != "paxos" and cfg.eff_stat_sampler == "normal")
            or cfg.eff_edge_sampler == "rbg")


def _in_turn(cfg: SimConfig, n_lanes: int):
    """Refuse a vmapped batch that the port can only run one lane at a time
    when its rows would differ from solo runs."""
    if n_lanes > 1 and philox_draws(cfg):
        _refuse(
            f"a batch of {n_lanes} lanes of {cfg.protocol} "
            f"({'schedule ' + cfg.schedule if cfg.protocol != 'paxos' else 'tick engine'}, "
            f"topology {cfg.topology}, stat sampler {cfg.eff_stat_sampler}, edge sampler "
            f"{cfg.eff_edge_sampler}) draws on Philox words, which the vmapped "
            "program takes from the first lane's key; a lane axis for the "
            "PBFT and Paxos tick engines and Raft over gossip or queued links",
            "a later slice of the port (ROADMAP.md queue A, tick-engine lanes); "
            "use stat_sampler='exact' and edge_sampler='threefry', or multi_seed=True")


def _keys(seeds) -> np.ndarray:
    """``jax.vmap(jax.random.key)(seeds)`` as host words ``[B, 2]``."""
    return np.stack([threefry.key(int(s)) for s in seeds]) if len(seeds) else \
        np.zeros((0, 2), np.int64)


@aotcache.cached_factory("sweep-batched-dynf")
def dyn_batched_fn(cfg: SimConfig):
    """``batched(keys [B, 2], n_crashed [B], n_byzantine [B], device) ->
    final state [B, ...]`` for a canonical config: JAX's ``jit(vmap(
    make_dyn_sim_fn(cfg)))`` (module docstring: lanes side by side where the
    engine has a lane axis, else one after another)."""
    sim = make_dyn_sim_fn(cfg)  # validates: batchable, no C++-only modes
    canon = canonical_fault_cfg(cfg)

    def batched(keys, n_crashed, n_byzantine, device):
        keys = np.asarray(keys, np.int64)
        nc = np.asarray(n_crashed, np.int64)
        nb = np.asarray(n_byzantine, np.int64)
        if lane_axis(canon):
            return runner._dyn_run(canon, keys, nc, nb, device)
        _in_turn(canon, len(keys))
        return stack_lanes([sim(k, c, b, device) for k, c, b in zip(keys, nc, nb)])

    return batched


def sharded_topo_sim_fn(cfg: SimConfig, mesh, layout: str = "exchange"):
    """The node-dim mesh-sharded topology program of a kregular or committee
    config (JAX's ``sharded_topo_sim_fn``: the overlay tables or the
    committee stack partitioned over a ``nodes`` axis).  Other topologies
    raise ``ValueError`` as in the JAX package; the mesh arms come with the
    many-GPU slice.  One card runs a kregular or committee config through
    :func:`runner.make_dyn_sim_fn` / ``make_topo_dyn_sim_fn``."""
    del layout
    if cfg.topology not in ("kregular", "committee"):
        raise ValueError(
            f"sharded_topo_sim_fn shards the sparse/hierarchical overlays; "
            f"topology={cfg.topology!r} has no node-dim topo structure "
            "(dense configs ride parallel/shard.py, gossip is unsharded)"
        )
    _refuse(f"sharded_topo_sim_fn over a mesh ({mesh!r})", MANY_GPUS)


def run_sharded_topo(cfg: SimConfig, mesh, seed: int | None = None):
    """One kregular or committee run sharded over ``mesh`` (JAX's
    ``run_sharded_topo``): refused with :func:`sharded_topo_sim_fn`; on one
    card use ``runner.run_simulation``."""
    del seed
    sharded_topo_sim_fn(canonical_fault_cfg(cfg), mesh)


@aotcache.cached_factory("multi-seed-tick")
def multi_seed_fn(cfg: SimConfig, n_seeds: int):
    """``batched(keys [B, 2], n_crashed [B], n_byzantine [B], device) ->
    final state [B, ...]``: JAX's ``lax.map`` of the unvmapped dyn program,
    whose lanes are solo runs, so they run in turn."""
    del n_seeds  # JAX keys its registry entry on it
    sim = make_dyn_sim_fn(cfg)

    def batched(keys, n_crashed, n_byzantine, device):
        return stack_lanes([sim(k, c, b, device)
                            for k, c, b in zip(np.asarray(keys, np.int64), n_crashed,
                                               n_byzantine)])

    return batched


@aotcache.cached_factory("sweep-batched")
def _batched_fn(cfg: SimConfig):
    """``batched(seeds, device) -> final state [B, ...]`` of a static config:
    JAX's ``jit(vmap(make_sim_fn(cfg)))``.  Every batchable config rides
    the dyn program at its own counts (equal to the static program); the
    mixed sim runs its lanes in turn."""
    try:
        check_batchable(cfg)
    except UnbatchableConfigError:
        sim = runner.make_sim_fn(cfg)

        def batched_static(seeds, device):
            _in_turn(cfg, len(seeds))
            return stack_lanes([sim(int(s), device) for s in seeds])

        return batched_static
    dyn = dyn_batched_fn(canonical_fault_cfg(cfg))
    nc, nb = _dyn_operands(cfg, cfg.faults)

    def batched(seeds, device):
        return dyn(_keys(seeds), [nc] * len(seeds), [nb] * len(seeds), device)

    return batched


def run_seed_sweep(cfg: SimConfig, seeds, mesh=None, device=None):
    """Run ``len(seeds)`` simulations of one config as one batched program;
    returns one metrics dict a seed, each the vmapped JAX row."""
    _refuse_arms(mesh=mesh)
    dev = resolve_device(device)
    seeds = list(seeds)
    finals = _batched_fn(cfg)(seeds, dev)
    out = [sim_metrics(cfg, lane_state(finals, i)) for i in range(len(seeds))]
    _record(out, [cfg] * len(out), seeds)
    return out


def _dyn_operands(cfg: SimConfig, fc) -> tuple[int, int]:
    """The (n_crashed, n_byzantine) operand point of a fault config."""
    return fc.resolved_n_crashed(cfg.n), fc.n_byzantine


def _dispatch_dyn_points(canon: SimConfig, points, record: bool = True,
                         n_out: int | None = None, mesh=None,
                         multi_seed: bool = False, probe=None, device=None):
    """ONE batched dispatch of a same-structure point list; one metrics dict
    a point (the first ``n_out`` when given)."""
    _refuse_arms(mesh=mesh, probe=probe)
    points = list(points)
    if not points:
        return []
    dev = resolve_device(device)
    # the batched-dispatch chaos point: drills inject raise/hang/slow here,
    # the exception path a real device fault takes through the sweeps AND
    # the server's degrade machinery (chaos/inject.py)
    inject.chaos_point("sweep.dyn_dispatch", canon=canon, n=len(points))
    batched = multi_seed_fn(canon, len(points)) if multi_seed else dyn_batched_fn(canon)
    ops = [_dyn_operands(cfg, cfg.faults) for cfg, _ in points]
    # $BLOCKSIM_PROFILE arms a torch.profiler capture around the run
    # (utils/telemetry.py; free when disarmed); a serve flush routed here
    # is already inside its own region, and the nested guard skips this one
    with telemetry.profile_region("sweep_dispatch"):
        finals = batched(_keys([s for _, s in points]), [o[0] for o in ops],
                         [o[1] for o in ops], dev)
    if n_out is not None:
        points = points[:n_out]
    out = [sim_metrics(cfg_i, lane_state(finals, i)) for i, (cfg_i, _) in enumerate(points)]
    if record:
        _record(out, [c for c, _ in points], [s for _, s in points])
    return out


def run_dyn_points(canon: SimConfig, points, record: bool = True,
                   n_out: int | None = None, mesh=None, journal=None,
                   chunk_size: int | None = None, supervise=None,
                   multi_seed: bool = False, probe=None,
                   key_suffix: str = "", with_index: bool = False, device=None):
    """THE group-dispatch primitive: one batched program over a list of
    same-structure ``(cfg, seed)`` points (configs that canonicalize to
    ``canon`` and differ only in fault counts).  Returns one metrics dict a
    point, in order (the first ``n_out`` when given); ``with_index=True``
    returns ``(rows, meta)`` with JAX's row map and dispatch accounting.
    ``multi_seed`` dispatches the solo-semantics program
    (:func:`multi_seed_fn`).  ``chunk_size`` and ``key_suffix`` only shape
    journaled sweeps, which come with a later slice."""
    del chunk_size, key_suffix
    _refuse_arms(mesh=mesh, journal=journal, supervise=supervise, probe=probe)
    points = list(points)
    rows = _dispatch_dyn_points(canon, points, record, n_out, None, multi_seed, None, device)
    if not with_index:
        return rows
    pts_out = points if n_out is None else points[:n_out]
    meta = {"rows": [{"point": i, "seed": int(s), "key": None, "cached": False}
                     for i, (_, s) in enumerate(pts_out)],
            "chunks": [], "lanes": len(points), "dispatches": int(bool(points)),
            "pad": 0}
    return rows, meta


def dyn_chunk_keys(cfg: SimConfig, fault_configs, seeds, mesh=None):
    """The journal chunk keys of a journaled sweep: journaled sweeps come
    with the durable-sweeps slice."""
    _refuse("dyn_chunk_keys (the journal's chunk keys)", DURABLE_SWEEPS)


def _run_dyn_group(cfg: SimConfig, canon: SimConfig, fcs, seeds, mesh=None,
                   journal=None, supervise=None, multi_seed=False, device=None):
    """One program for every (fault config, seed) point of a same-structure
    group; returns ``{fc: [metrics a seed]}``."""
    points = [(cfg.with_(faults=fc), seed) for fc in fcs for seed in seeds]
    rows = run_dyn_points(canon, points, mesh=mesh, journal=journal, supervise=supervise,
                          multi_seed=multi_seed, device=device)
    n_s = len(seeds)
    return {fc: rows[i * n_s:(i + 1) * n_s] for i, fc in enumerate(fcs)}


def run_fault_sweep(cfg: SimConfig, fault_configs, seeds, mesh=None,
                    journal=None, supervise=None, multi_seed=False, device=None):
    """BASELINE config 4: sweep fault configs, seeds batched inside.
    Returns ``{fault_config: [metrics a seed]}``.  Fault configs that differ
    only in their counts share one program (a structure group); the mixed
    sim takes the static :func:`run_seed_sweep` path, one program a fault
    config."""
    _refuse_arms(mesh=mesh, journal=journal, supervise=supervise)
    _health_gate()
    fault_configs = list(fault_configs)
    seeds = list(seeds)
    groups: dict[SimConfig, list] = {}
    order = {}
    for fc in fault_configs:
        try:
            check_batchable(cfg.with_(faults=fc))
        except UnbatchableConfigError:
            order[fc] = None
            continue
        canon = canonical_fault_cfg(cfg.with_(faults=fc))
        if fc not in groups.setdefault(canon, []):
            groups[canon].append(fc)
        order[fc] = canon
    done: dict = {}
    for canon, fcs in groups.items():
        done.update(_run_dyn_group(cfg, canon, fcs, seeds, multi_seed=multi_seed,
                                   device=device))
    return {fc: (run_seed_sweep(cfg.with_(faults=fc), seeds, device=device)
                 if order[fc] is None else done[fc])
            for fc in fault_configs}


def run_byzantine_sweep(cfg: SimConfig, f_values=None, seeds=(0,), forge=True,
                        mesh=None, journal=None, supervise=None,
                        multi_seed=False, device=None):
    """BASELINE config 4 end to end: sweep the Byzantine count f over
    ``f_values`` (default 0..(n-1)//3), seeds batched per f, the whole sweep
    one program over (f, seed).  Returns a list of ``{"f": f, "seed": s,
    **metrics}`` dicts (``forged_commits`` and ``agreement_ok`` are the
    safety outcomes)."""
    if forge and cfg.protocol != "pbft":
        raise ValueError(
            "the forging attack is implemented for pbft only; pass "
            "forge=False to sweep passive vote-flipping Byzantine nodes "
            f"for {cfg.protocol!r}"
        )
    if f_values is None:
        f_values = range(cfg.byz_f + 1)
    f_values = list(f_values)
    fcs = [dataclasses.replace(cfg.faults, n_byzantine=f, byz_forge=forge) for f in f_values]
    res = run_fault_sweep(cfg, list(dict.fromkeys(fcs)), seeds, mesh=mesh, journal=journal,
                          supervise=supervise, multi_seed=multi_seed, device=device)
    return [{"f": int(f), "seed": int(seed), **m}
            for f, fc in zip(f_values, fcs) for seed, m in zip(seeds, res[fc])]
