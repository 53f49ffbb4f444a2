"""Fault and seed sweeps, on one device or over a grid of ranks (port of
``blockchain_simulator_tpu/parallel/sweep.py``).

The outer-axis analog of BASELINE config 4 ("Byzantine-fault sweep
f=0..n/3"): many (fault level, seed) points of one fault *structure* run as
one program with the fault COUNTS and the seeds as operands
(runner.make_dyn_sim_fn).  Structurally distinct configs (drop_prob,
byz_forge, byz_copies) form separate groups; the mixed shard sim, which has
no dynamic-fault program, takes the static per-config path.

*Lanes are not a loop.*  The JAX package runs a group as
``jit(vmap(make_dyn_sim_fn(canon)))``.  The port runs a group's lanes side
by side, as a leading axis with lane keys ``[B, 2]`` (:func:`lane_axis`),
on every engine: PBFT's round path (models/pbft_round.py), Raft's
heartbeat path (models/raft_hb.py, the handoff's ``lax.cond`` a select per
lane), and the tick engines of PBFT, Raft and Paxos on every topology
(models/base.py; a committee batch is ``B·C`` lanes, topo/committee.py).
A round or a tick then makes one lane's launches, not B times them.  Under
``vmap`` the JAX package's Philox draws follow the first lane's key, so
every lane draws by the rule its JAX program batches by
(:func:`vmapped_rule`, ops/delay.lane_rule).

The multi-seed program (JAX's ``lax.map`` of the unvmapped dyn program) has
solo semantics: its lanes run in turn.

The run log: with ``$BLOCKSIM_RUNS_JSONL`` set, every row (``{"seed": s,
**metrics}``, at the point's own config) is appended through
``utils/obs.record_run``, as the JAX package's sweeps do; the returned dicts
stay pure metrics.

The services around the dispatch are the JAX package's: the batched
programs are registry entries (utils/aotcache.py: ``"sweep-batched"``,
``"sweep-batched-dynf"``, ``"multi-seed-tick"``, ``"partition-dyn-sweep"``,
and obsim's ``"consobs-batched"`` and ``"consobs-mesh"``), the batched dispatch fires the
``sweep.dyn_dispatch`` chaos point (chaos/inject.py) and runs inside
``telemetry.profile_region("sweep_dispatch")``, and the fault sweeps fail
fast on a fresh ``wedged`` verdict in ``$BLOCKSIM_HEALTH_JSONL``
(utils/health.require_not_wedged).

Durability: every dynamic-operand sweep accepts ``journal=`` (a
parallel/journal.SweepJournal): execution then chunks one fault level (its
seed tile) to a fsynced journal append, and a restarted identical sweep skips
completed chunks (it recomputes at most the one chunk in flight).
``supervise=`` (journal.ChunkSupervisor) adds a deadline to each chunk, with
bounded retry and a recorded degrade arm on the same device: the sweep's
own program again, or for a single tick-engine point
``runner.run_dyn_checkpointed``.  The chunk keys (:func:`dyn_chunk_keys`)
and rows are the JAX package's, so either package resumes the other's
journal.  ``probe=`` (obsim/schema.ProbeConfig) dispatches the armed twin
(obsim/build.probed_batched_fn) and adds each row's ``"probe"`` summary.

The node-sharded topology programs (:func:`sharded_topo_sim_fn`,
:func:`run_sharded_topo`) run on every rank of a node mesh
(parallel/mesh.py).

*The sweep axis* (``mesh=``, a ``(n_sweep, n_nodes)`` grid of ranks from
parallel/mesh.make_mesh; call the sweep on every rank of it).  The point
list pads to a multiple of ``n_sweep`` by repeating its last point
(partition.pad_points), sweep row ``i`` takes the ``i``-th block of the
padded lanes, as JAX's ``P(SWEEP)`` splits them, and runs its real lanes;
the rows' metrics rows (and probe summaries) are gathered to every rank
over the grid's gloo group, never the final states.  That gather carries
each rank's outcome too (parallel/mesh.NodeMesh.exchange), so the grid acts
as one where JAX's single controller decides once: a dispatch that fails on
any rank fails on every rank, and a supervised chunk retries, degrades or
fails on all of them together.  The JAX package gives its mesh paths three
contracts, and each arm keeps its own:

- **sweep-only mesh** (``n_nodes`` 1; :func:`mesh_dyn_batched_fn`): JAX
  runs each device's lanes through the unvmapped program (``lax.map``), so
  a lane is the solo run of its point: equal to the single-device row under
  the exact sampler, and under ``"normal"`` / ``"rbg"`` draws to JAX's mesh
  rows (not its vmapped ones, which follow the first lane's key);
- **nodes axis > 1**: JAX partitions the global vmapped program, so a lane
  is the single-device batched row: each lane runs over its row's nodes
  group in global view (parallel/partition.partition with explicit
  shardings; every draw is this rank's rows of the single-device draw,
  ops/delivery.draw_rows), never with the per-shard keys of run_sharded.
  A batch of more than one lane drawing on Philox words, whose vmapped
  rows follow the first lane's key, raises;
- **seed sweeps** (:func:`run_seed_sweep`, the command line's ``--shards W
  --seeds ...``): JAX vmaps its node-sharded program, so a lane is
  ``parallel/shard.run_sharded`` over the row's nodes group at that seed
  (the shard folded into the keys), not the single-device run.

A mesh of one rank is the plain path; a one-point dispatch over a larger
mesh drops the mesh (every rank answers it alone, as JAX's single-device
program does).  A journal is read on the grid's rank 0 and its answer
broadcast, so every rank dispatches the same chunks, and only rank 0 writes
it (and the run log).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

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
from blockchain_simulator_tpu_torch.parallel import journal as journal_mod
from blockchain_simulator_tpu_torch.parallel import partition
from blockchain_simulator_tpu_torch.utils import aotcache, health, obs, telemetry, threefry
from blockchain_simulator_tpu_torch.utils.config import SimConfig

from blockchain_simulator_tpu_torch.parallel.mesh import NODES_AXIS, SWEEP_AXIS


# what still runs one lane at a time, and so refuses >1 lane on Philox draws
_ALONE = ("a later slice of the port (ROADMAP.md queue A item 5b); use "
          "stat_sampler='exact' and edge_sampler='threefry'")


def _refuse(what: str, where: str):
    raise NotImplementedError(f"{what} comes with {where}")


def _mesh_arm(mesh) -> bool:
    """Does a dispatch over ``mesh`` take a mesh arm (more than one rank)?"""
    return mesh is not None and partition.mesh_size(mesh) > 1


def _sweep_lanes(mesh) -> int:
    """The number of blocks a mesh dispatch splits its padded lanes into."""
    return max(partition.sweep_axis_size(mesh), 1)


def _writer(mesh) -> bool:
    """Does this rank write the journal and the run log?  Every rank runs a
    mesh sweep (and any sweep called in every process of a group); the
    grid's rank 0 writes for all of them."""
    if mesh is not None:
        return mesh.world_rank == 0
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _device(mesh, device):
    """The device a sweep computes on: the mesh's (this rank's card, or the
    CPU of a gloo group) when given, else ``resolve_device(device)``."""
    return mesh.device if mesh is not None else resolve_device(device)


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
    axis with lane keys)?  Every engine of PBFT, Raft and Paxos: the round
    and heartbeat paths, and the tick engines on the full mesh, queued
    links, gossip, kregular and committees.  The mixed sim has no dynamic
    program (runner.check_batchable)."""
    return cfg.protocol in ("pbft", "raft", "paxos")


def philox_draws(cfg: SimConfig) -> bool:
    """Does the config draw on Philox words (the ``"normal"`` stat sampler or
    the ``"rbg"`` edge sampler)?"""
    if cfg.protocol == "mixed":
        from blockchain_simulator_tpu_torch.models.mixed import sub_configs

        return any(philox_draws(c) for c in sub_configs(cfg))
    return ((cfg.protocol != "paxos" and cfg.eff_stat_sampler == "normal")
            or cfg.eff_edge_sampler == "rbg")


def vmapped_rule(cfg: SimConfig) -> str:
    """The rule JAX's vmapped batch of this config draws by: ``"first-lane"``
    (row ``l`` of lane 0's key drawn at ``(L, *shape)``, not lane ``l``'s
    solo words) or ``"solo"`` (each row its point's solo run).

    Every arm is first-lane as soon as it draws a Philox word, and solo
    otherwise (the threefry streams and the exact binomial are per lane
    under ``vmap``).  Why, arm by arm, in the JAX sources: every Philox
    draw goes through ``ops/delay._rbg_key`` into ``jax.random.bits`` on an
    ``rbg`` key, which lowers to ``rng_bit_generator``; its batching rule
    (``jax/_src/lax/control_flow/loops.py``,
    ``_rng_bit_generator_batching_rule``) draws ``keys[0]`` at ``(L,
    *shape)`` whenever the key is batched.  Every such key is a fold of the
    tick key ``utils/prng.tick_key(key, t)``, hence of the lane's key,
    hence batched; none is drawn from an unbatched key (the gossip digraph
    comes from ``cfg.seed`` on the host, the kregular tables are
    deterministic).  The ``gated`` conds change nothing: a batched
    predicate lowers ``lax.cond`` to a select of both branches, each
    batched alike.

    - **PBFT tick engine**: edge ``"rbg"`` (``ops/delivery.bcast_slots_dense``,
      ``bcast_window_value_max_dense``, ``bcast_value_max_dense``,
      ``roundtrip_reply_counts_dense`` from ``models/pbft.step``), stat
      ``"normal"`` (``push_roundtrip_reply_counts_stat``,
      ``push_bcast_slots_stat``: ``bucket_count_chain`` → ``_fast_normal``),
      queued links (the same stat chains), gossip (``gossip_fwd``) and
      kregular (``ops/gatherdeliv``'s ``_slot_hits``, the stat chains):
      first-lane.  Over a 200 ms window PBFT's vmapped lanes still equal
      their solo runs (its state does not yet depend on those words
      there); over 450-1,500 ms lanes 1 and 2 differ from solo in
      ``prepare_vote``, ``commit_vote`` and ``slot_commit_tick``
      (``tests/test_torch_lanes.py`` pins each arm).
    - **Raft** (full mesh, queued links, gossip, kregular) and the
      heartbeat path: first-lane (the vote, heartbeat and ack chains).
    - **Paxos** (full mesh, gossip, kregular): first-lane
      (``models/paxos._req_contrib``, ``_reply_contribs``, ``gossip_fwd``).
    - **PBFT's round path**: first-lane (``pbft_round``'s chains).

    JAX's ``lax.map`` arms (the multi-seed program, committees, a
    sweep-only mesh row's lanes) are solo whatever the sampler."""
    return "first-lane" if philox_draws(cfg) else "solo"


def _keys(seeds) -> np.ndarray:
    """``jax.vmap(jax.random.key)(seeds)`` as host words ``[B, 2]``."""
    return np.stack([threefry.key(int(s)) for s in seeds]) if len(seeds) else \
        np.zeros((0, 2), np.int64)


@aotcache.cached_factory("sweep-batched-dynf")
def dyn_batched_fn(cfg: SimConfig):
    """``batched(keys [B, 2], n_crashed [B], n_byzantine [B], device) ->
    final state [B, ...]`` for a canonical config: JAX's ``jit(vmap(
    make_dyn_sim_fn(cfg)))``: the lanes side by side on every engine, each
    lane JAX's vmapped row (module docstring)."""
    make_dyn_sim_fn(cfg)  # validates: batchable, no C++-only modes
    canon = canonical_fault_cfg(cfg)

    def batched(keys, n_crashed, n_byzantine, device):
        return runner._dyn_run(canon, np.asarray(keys, np.int64),
                               np.asarray(n_crashed, np.int64),
                               np.asarray(n_byzantine, np.int64), device)

    return batched


def _nodes_refusal(canon: SimConfig, n_lanes: int):
    """Refuse a nodes-arm batch whose vmapped JAX rows follow the first
    lane's key (Philox draws, more than one lane): a lane here runs alone."""
    if n_lanes > 1 and philox_draws(canon):
        _refuse(
            f"a node-sharded sweep batch of {n_lanes} lanes of {canon.protocol} drawing on "
            "Philox words (stat sampler 'normal' or edge sampler 'rbg'; JAX's vmapped rows "
            "take those from the first lane's key)",
            _ALONE + ", or a sweep-only mesh")


def global_view_sim(cfg: SimConfig, mesh, pcfg=None):
    """``sim(key, n_crashed, n_byzantine) -> final state``: one run of the
    canonical ``cfg`` over the nodes row ``mesh`` (more than one rank) in
    global view, equal to ``runner.make_dyn_sim_fn(cfg)``'s run bit for
    bit.  Each rank builds its block of ``ceil(n / ranks)`` rows of the
    init, steps them with ``mesh_axis`` set (every draw this rank's rows of
    the single-device draw, every cross-node reduction a collective of the
    row) and gets the final state gathered.  The overlays take
    :func:`sharded_topo_sim_fn`, the same global view.

    ``pcfg`` (obsim/schema.ProbeConfig) arms the taps: ``sim`` then returns
    ``(final state, probes)``, each sample read off the state gathered over
    the row (its per-rank accumulators combined), so the probes are the
    single-device run's (obsim/build.make_probed_dyn_sim_fn)."""
    from blockchain_simulator_tpu_torch.models import base as base_model
    from blockchain_simulator_tpu_torch.models.base import get_protocol, tick_loop
    from blockchain_simulator_tpu_torch.parallel.mesh import bound
    from blockchain_simulator_tpu_torch.parallel.partition import P

    if cfg.topology in ("kregular", "committee"):
        if pcfg is not None:
            _refuse("probes on a node-sharded overlay lane",
                    "a later slice of the port (the overlays' taps in global view)")
        return sharded_topo_sim_fn(cfg, mesh)
    dev = mesh.device
    engine = ("hb" if cfg.protocol == "raft" else "round") if use_round_schedule(cfg) \
        else "tick"
    if engine == "hb":
        from blockchain_simulator_tpu_torch.models import raft, raft_hb

        init, glob, fin = raft.init, (), None
    elif engine == "round":
        from blockchain_simulator_tpu_torch.models import pbft_round

        init, glob, fin = pbft_round.init, pbft_round.GLOBAL_FIELDS, pbft_round.finalize
    else:
        proto = get_protocol(cfg.protocol)
        init, glob = proto.init, getattr(proto, "GLOBAL_FIELDS", ())
        fin = getattr(proto, "finalize", None)
    specs = partition.match_partition_rules(partition.node_dim_rules(glob),
                                            init(cfg, device="meta")[0])

    def finish(state):
        return state if fin is None else fin(state, NODES_AXIS)

    taps_of = {}  # the run's probe series, replicated on every rank of the row
    if pcfg is not None:
        from blockchain_simulator_tpu_torch.obsim import build as obsim_build
        from blockchain_simulator_tpu_torch.obsim import taps

        def full(state):
            """The state as the single-device run holds it."""
            return partition.gather(finish(state), specs, bound(NODES_AXIS))

        def sample(state):
            return taps.sample(cfg, full(state))

    def run(ids_loc, key, n_crashed, n_byzantine):
        del ids_loc  # it carries the node count into the global view
        start, n_loc = rows = bound(NODES_AXIS).rows(cfg.n)
        state, bufs = init(cfg, threefry.fold_in(key, runner._INIT_FOLD), device=dev,
                           rows=rows)
        masks = base_model.dyn_fault_masks(cfg.n, n_crashed, n_byzantine, dev)
        state = base_model.apply_fault_masks(cfg, state,
                                             *(m[start:start + n_loc] for m in masks))
        step_cfg = runner.dyn_step_cfg(cfg, n_byzantine).with_(mesh_axis=NODES_AXIS)
        if engine == "hb":
            if pcfg is None:
                return raft_hb.scan_from_init(step_cfg, state, bufs, key)
            final, taps_of["red"] = raft_hb.scan_from_init(
                step_cfg, state, bufs, key,
                probe=(sample, lambda ys, h: taps.raft_steady_sample(ys, full(h)),
                       obsim_build.hb_reduce(cfg, pcfg)))
            return final
        if engine == "round":
            out = pbft_round.scan_rounds(step_cfg, state, key,
                                         with_probe=False if pcfg is None else sample)
        else:
            out = tick_loop(step_cfg, state, bufs, key, 0, cfg.ticks,
                            probe=None if pcfg is None else sample)
            out = out[0] if pcfg is None else (out[0], out[2])
        if pcfg is None:
            return finish(out)
        taps_of["ys"] = out[1]
        return finish(out[0])

    p = partition.partition(run, mesh, in_shardings=(P(NODES_AXIS), P(), P(), P()),
                            out_shardings=specs)
    ids = torch.arange(cfg.n, device=dev)

    def sim(key, n_crashed, n_byzantine):
        final = p(ids, np.asarray(key, np.int64), int(n_crashed), int(n_byzantine))
        if pcfg is None:
            return final
        if engine == "hb":
            return final, obsim_build.hb_probes(cfg, pcfg, final, taps_of.pop("red"))
        n_samples = cfg.ticks if engine == "tick" else \
            (cfg.ticks - 1) // cfg.pbft_block_interval_ms
        return final, taps.finalize(cfg, pcfg, final, taps.time_last(taps_of.pop("ys")),
                                    n_samples)

    return sim


def mesh_lanes_fn(cfg: SimConfig, mesh, pcfg=None):
    """The program one sweep row of ``mesh`` runs on its block of lanes:
    ``batched(keys [L, 2], n_crashed [L], n_byzantine [L], device) ->
    final state [L, ...]``, or ``(finals, probes)`` with ``pcfg`` (an
    obsim/schema.ProbeConfig) arming the taps.  JAX's per-device body of
    its mesh-partitioned ``batched(keys[B], n_crashed[B], n_byzantine[B])``;
    the split into rows and the gather of the rows' metrics are
    :func:`_dispatch_dyn_points`'s.  Three arms, as JAX's (module
    docstring):

    - **mesh of one rank**: :func:`dyn_batched_fn` (armed:
      obsim/build.probed_batched_fn) itself;
    - **sweep-only** (nodes 1): each lane the solo program of its point,
      side by side where the vmapped rows are the solo ones
      (:func:`vmapped_rule`), else one after another;
    - **nodes > 1**: each lane in global view over the row's nodes group
      (:func:`global_view_sim`), equal to the single-device batched row
      (the caller refuses batches whose vmapped rows follow lane 0).

    The registry entries are :func:`mesh_dyn_batched_fn` and
    obsim/build.probed_mesh_fn."""
    from blockchain_simulator_tpu_torch.obsim import build as obsim_build

    if partition.mesh_size(mesh) == 1:
        return dyn_batched_fn(cfg) if pcfg is None else obsim_build.probed_batched_fn(cfg, pcfg)
    if int(mesh.shape[NODES_AXIS]) > 1:
        sim = global_view_sim(canonical_fault_cfg(cfg), mesh.row(), pcfg)

        def batched_nodes(keys, n_crashed, n_byzantine, device=None):
            del device  # the row's ranks compute on their own devices
            outs = [sim(k, c, b) for k, c, b in
                    zip(np.asarray(keys, np.int64), n_crashed, n_byzantine)]
            if pcfg is None:
                return stack_lanes(outs)
            from blockchain_simulator_tpu_torch.models.base import stack_samples

            return stack_lanes([o[0] for o in outs]), stack_samples([o[1] for o in outs])

        return batched_nodes
    if pcfg is not None:
        return obsim_build.probed_batched_fn(cfg, pcfg, multi_seed=philox_draws(cfg))
    return solo_lanes_fn(cfg) if vmapped_rule(cfg) == "first-lane" else dyn_batched_fn(cfg)


@aotcache.cached_factory("partition-dyn-sweep")
def mesh_dyn_batched_fn(cfg: SimConfig, mesh):
    """One registry entry a (fault structure, mesh): :func:`mesh_lanes_fn`
    disarmed."""
    return mesh_lanes_fn(cfg, mesh)


def sharded_topo_sim_fn(cfg: SimConfig, mesh, layout: str = "exchange"):
    """Node-dim mesh-sharded topology program: ``sim(key, n_crashed,
    n_byzantine) -> final_state`` for a kregular or committee config with
    the overlay partitioned over the mesh's ``nodes`` axis (JAX's
    ``sharded_topo_sim_fn``).  Call it on every rank of the mesh.  ``cfg``
    must already be fault-canonical (models/base.canonical_fault_cfg).

    Three arms, as in the JAX package:

    - **mesh of one rank**: the single-device program
      (runner.make_dyn_sim_fn) itself, so the degenerate case is
      bit-identical by construction.
    - **kregular, nodes > 1**: the tick engine with the ``[N, K]`` overlay
      tables as operands (runner.make_topo_dyn_sim_fn) through
      parallel/partition.partition's global view: each rank steps its block
      of ``ceil(n / ranks)`` rows, draws exactly its rows of the
      single-device draws, and the run equals the single-device run bit for
      bit.  Two data-movement layouts: ``"exchange"`` (the default) gives
      each rank its rows of the tables and reads the neighbours' rows
      through a parallel/partition.NeighborExchange (one owner-bucketed
      all_to_all a read; plans from topo/spec.owner_bucket_plan over the
      tables zero-padded to a multiple of the ranks, as JAX pads them);
      ``"regather"`` gives every rank the whole tables and all-gathers the
      neighbours' rows (the pre-exchange behaviour, kept as a comparator).
    - **committee, nodes > 1**: the stacked committee axis is sharded
      (``committees % ranks == 0``): each rank runs its committees
      (topo/committee.stacked_body) with the keys of their GLOBAL committee
      index, and the stacked finals are gathered."""
    from blockchain_simulator_tpu_torch.models import base as base_model
    from blockchain_simulator_tpu_torch.ops import gatherdeliv as gd
    from blockchain_simulator_tpu_torch.parallel import partition
    from blockchain_simulator_tpu_torch.parallel.partition import P

    if cfg.topology not in ("kregular", "committee"):
        raise ValueError(
            f"sharded_topo_sim_fn shards the sparse/hierarchical overlays; "
            f"topology={cfg.topology!r} has no node-dim topo structure "
            "(dense configs ride parallel/shard.py, gossip is unsharded)"
        )
    dev = mesh.device
    if partition.mesh_size(mesh) == 1:
        single = make_dyn_sim_fn(cfg)

        def sim1(key, n_crashed, n_byzantine):
            return single(key, n_crashed, n_byzantine, dev)

        return sim1
    n_shards = int(dict(mesh.shape).get(NODES_AXIS, 1))
    if n_shards <= 1:
        raise ValueError(
            "sharded_topo_sim_fn partitions the node dimension: the mesh "
            f"needs nodes > 1 (got shape {dict(mesh.shape)}); sweep-axis "
            "meshes belong to mesh_dyn_batched_fn")
    proto = base_model.get_protocol(cfg.protocol)

    if cfg.topology == "committee":
        from blockchain_simulator_tpu_torch.topo import committee

        c, m = cfg.committees, cfg.n // cfg.committees
        if c % n_shards != 0:
            raise ValueError(
                f"committees={c} not divisible by {n_shards} node shards "
                "(the committee stack shards whole committees)")
        meta = proto.init(committee.inner_cfg(cfg), device="meta")[0]
        out_specs = partition.match_partition_rules(
            partition.node_dim_rules(), base_model.stack_lanes([meta] * c))
        lane = P(NODES_AXIS)

        def body(keys, alive_cm, honest_cm):
            return committee.stacked_body(cfg, keys.numpy(), alive_cm, honest_cm)

        shmapped = partition.partition(body, mesh, in_specs=(lane, lane, lane),
                                       out_specs=out_specs)

        def sim_committee(key, n_crashed, n_byzantine):
            alive, honest = base_model.dyn_fault_masks(cfg.n, int(n_crashed),
                                                       int(n_byzantine), dev)
            keys = torch.as_tensor(committee._committee_keys(np.asarray(key, np.int64), c))
            return shmapped(keys, alive.reshape(c, m), honest.reshape(c, m))

        return sim_committee

    if layout not in ("exchange", "regather"):
        raise ValueError(
            f"sharded_topo_sim_fn layout must be 'exchange' or 'regather', "
            f"got {layout!r}")
    tables = gd.table_operands(cfg, inslot=runner.topo_tables_inslot(cfg))
    # the exchange plans need whole blocks: zero-pad the table rows to the
    # next multiple of the ranks (pad rows are never read: every read
    # indexes ids < n; each rank cuts its block to its state rows)
    pad = (-cfg.n) % n_shards
    if pad:
        tables = tuple(np.pad(t, ((0, pad),) + ((0, 0),) * (t.ndim - 1)) for t in tables)
    if layout == "exchange":
        from blockchain_simulator_tpu_torch.topo import spec as topo_spec

        xspec = partition.ExchangeSpec(mesh, cfg.n)
        plans = ()
        for tab in (tables[0], tables[1]):  # "in", "out" (xspec.kinds)
            plans += topo_spec.owner_bucket_plan(tab, n_shards)
        inner_fn = runner.make_topo_dyn_sim_fn(cfg, exchange_spec=xspec)
        table_spec = P(NODES_AXIS)
    else:
        plans = ()
        inner_fn = runner.make_topo_dyn_sim_fn(cfg, axis=NODES_AXIS)
        table_spec = P()
    operands = tuple(torch.as_tensor(np.asarray(t, np.int64), device=dev)
                     for t in tables + plans)
    meta_state, _ = proto.init(cfg, device="meta")
    out_specs = partition.match_partition_rules(
        partition.node_dim_rules(getattr(proto, "GLOBAL_FIELDS", ())), meta_state)
    # the global view needs a node-sharded operand: the node ids carry n
    ids = torch.arange(cfg.n, device=dev)

    def fn(ids_loc, key, n_crashed, n_byzantine, *ops):
        del ids_loc
        return inner_fn(key, n_crashed, n_byzantine, *ops, device=dev)

    p = partition.partition(
        fn, mesh,
        in_shardings=(P(NODES_AXIS), P(), P(), P())
        + (table_spec,) * len(tables) + (P(NODES_AXIS),) * len(plans),
        out_shardings=out_specs)

    def sim(key, n_crashed, n_byzantine):
        return p(ids, key, n_crashed, n_byzantine, *operands)

    return sim


def run_sharded_topo(cfg: SimConfig, mesh, seed: int | None = None):
    """Run one kregular or committee simulation node-dim-sharded over
    ``mesh`` (:func:`sharded_topo_sim_fn`), on every rank of it; returns
    the same metrics dict as ``runner.run_simulation``, bit-equal to it at
    any mesh size."""
    from blockchain_simulator_tpu_torch.utils.sync import force_sync

    canon = canonical_fault_cfg(cfg)
    sim = sharded_topo_sim_fn(canon, mesh)
    nc = cfg.faults.resolved_n_crashed(cfg.n)
    nb = cfg.faults.n_byzantine
    final = force_sync(sim(threefry.key(cfg.seed if seed is None else seed), nc, nb))
    return sim_metrics(cfg, final)


def solo_lanes_fn(cfg: SimConfig):
    """``batched(keys [B, 2], n_crashed [B], n_byzantine [B], device) ->
    final state [B, ...]`` with every lane the solo program of its point
    (runner.make_dyn_sim_fn), in turn."""
    sim = make_dyn_sim_fn(cfg)

    def batched(keys, n_crashed, n_byzantine, device):
        return stack_lanes([sim(k, c, b, device)
                            for k, c, b in zip(np.asarray(keys, np.int64), n_crashed,
                                               n_byzantine)])

    return batched


@aotcache.cached_factory("multi-seed-tick")
def multi_seed_fn(cfg: SimConfig, n_seeds: int):
    """JAX's ``lax.map`` of the unvmapped dyn program, whose lanes are solo
    runs: :func:`solo_lanes_fn`."""
    del n_seeds  # JAX keys its registry entry on it
    return solo_lanes_fn(cfg)


@aotcache.cached_factory("sweep-batched")
def _batched_fn(cfg: SimConfig, mesh=None):
    """``batched(seeds, device) -> final state [B, ...]`` of a static config:
    JAX's ``jit(vmap(make_sim_fn(cfg)))``.  Every batchable config rides
    the dyn program at its own counts (equal to the static program); the
    mixed sim runs its lanes in turn.  With ``mesh`` (JAX's ``vmap`` of
    ``make_sharded_sim_fn(cfg, mesh)``): the program one sweep row runs on
    its seeds, each through the node-sharded program over the row's nodes
    group (parallel/shard.py), on the row's devices."""
    if mesh is not None:
        from blockchain_simulator_tpu_torch.parallel.shard import make_sharded_sim_fn

        sharded = make_sharded_sim_fn(cfg, mesh.row())

        def batched_sharded(seeds, device=None):
            del device  # the row's ranks compute on their own devices
            return stack_lanes([sharded(threefry.key(int(s))) for s in seeds])

        return batched_sharded
    try:
        check_batchable(cfg)
    except UnbatchableConfigError:
        sim = runner.make_sim_fn(cfg)

        def batched_static(seeds, device):
            if len(seeds) > 1 and vmapped_rule(cfg) == "first-lane":
                _refuse(f"a seed batch of {len(seeds)} mixed-sim runs drawing on Philox "
                        "words (JAX's vmapped rows take those from the first lane's "
                        "key; the mixed sim has no lane axis over seeds)",
                        _ALONE)
            return stack_lanes([sim(int(s), device) for s in seeds])

        return batched_static
    dyn = dyn_batched_fn(canonical_fault_cfg(cfg))
    nc, nb = _dyn_operands(cfg, cfg.faults)

    def batched(seeds, device):
        return dyn(_keys(seeds), [nc] * len(seeds), [nb] * len(seeds), device)

    return batched


def run_seed_sweep(cfg: SimConfig, seeds, mesh=None, device=None):
    """Run ``len(seeds)`` simulations of one config as one batched program;
    returns one metrics dict a seed, each the vmapped JAX row.

    With ``mesh`` (call it on every rank of the grid) the seeds split into
    one block a sweep row (their count must divide by the sweep axis, as
    JAX requires) and each seed runs ``parallel/shard.run_sharded`` over
    its row's nodes group: JAX's ``vmap`` of its node-sharded program,
    whose lanes fold the shard into their keys.  Every rank returns every
    seed's row."""
    seeds = list(seeds)
    if mesh is None:
        dev = resolve_device(device)
        finals = _batched_fn(cfg)(seeds, dev)
        out = [sim_metrics(cfg, lane_state(finals, i)) for i in range(len(seeds))]
    else:
        out = _mesh_seed_rows(cfg, seeds, mesh)
    if _writer(mesh):
        _record(out, [cfg] * len(out), seeds)
    return out


def _mesh_seed_rows(cfg: SimConfig, seeds: list, mesh) -> list:
    """:func:`run_seed_sweep`'s rows over ``mesh``: this sweep row's block
    of the seeds through the node-sharded program on its nodes group, the
    rows' metrics gathered."""
    n_sweep = int(mesh.shape[SWEEP_AXIS])
    if len(seeds) % n_sweep != 0:
        raise ValueError(f"{len(seeds)} seeds not divisible by sweep axis size {n_sweep}")
    if len(seeds) > 1 and philox_draws(cfg):
        _refuse(
            f"a seed sweep of {len(seeds)} seeds over a mesh drawing on Philox words "
            "(JAX's vmapped node-sharded rows take those from the first lane's key)",
            _ALONE)
    per = len(seeds) // n_sweep
    mine = seeds[mesh.sweep_index * per:(mesh.sweep_index + 1) * per]

    def block():
        finals = _batched_fn(cfg, mesh)(mine)
        return [sim_metrics(cfg, lane_state(finals, i)) for i in range(per)]

    return _agreed(mesh, True, block)


def _dyn_operands(cfg: SimConfig, fc) -> tuple[int, int]:
    """The (n_crashed, n_byzantine) operand point of a fault config."""
    return fc.resolved_n_crashed(cfg.n), fc.n_byzantine


def _dispatch_dyn_points(canon: SimConfig, points, record: bool = True,
                         n_out: int | None = None, mesh=None,
                         multi_seed: bool = False, probe=None, device=None):
    """ONE batched dispatch of a same-structure point list; one metrics dict
    a point (the first ``n_out`` when given).  ``probe`` (an
    obsim/schema.ProbeConfig) swaps in the armed twin of the same program
    (obsim/build.probed_batched_fn, or probed_mesh_fn over a mesh) and adds
    each row's ``"probe"`` summary; monitor violations trip the flight
    recorder (obsim/host.note_violations).  Over a mesh of more than one
    rank, the sweep rows run their blocks of the padded lanes and exchange
    their rows and outcomes (module docstring); ``multi_seed`` is moot
    there, the mesh arms having their own lane semantics."""
    points = list(points)
    if not points:
        return []
    dev = _device(mesh, device)
    rows = _agreed(mesh, len(points) > 1, lambda: _local_rows(
        canon, points, n_out, mesh, multi_seed, probe, dev))
    return _finish_rows(points, rows, record, n_out, probe, mesh)


def _local_rows(canon: SimConfig, points: list, n_out, mesh, multi_seed, probe, dev) -> list:
    """This rank's part of one dispatch: over a mesh of more than one rank,
    its sweep row's block of the padded lanes (:func:`_mesh_block`); else
    every point's row (a 1-point list over a mesh drops it: the
    single-device program answers it on every rank, equal rows)."""
    # the batched-dispatch chaos point: drills inject raise/hang/slow here,
    # the exception path a real device fault takes through the sweeps AND
    # the server's degrade machinery (chaos/inject.py)
    inject.chaos_point("sweep.dyn_dispatch", canon=canon, n=len(points))
    if _mesh_arm(mesh) and len(points) > 1:
        return _mesh_block(canon, points, mesh, probe, dev)
    if probe is not None:
        from blockchain_simulator_tpu_torch.obsim import build as obsim_build

        batched = obsim_build.probed_batched_fn(canon, probe, multi_seed=multi_seed)
    elif multi_seed:
        batched = multi_seed_fn(canon, len(points))
    else:
        batched = dyn_batched_fn(canon)
    ops = [_dyn_operands(cfg, cfg.faults) for cfg, _ in points]
    # $BLOCKSIM_PROFILE arms a torch.profiler capture around the run
    # (utils/telemetry.py; free when disarmed); a serve flush routed here
    # is already inside its own region, and the nested guard skips this one
    with telemetry.profile_region("sweep_dispatch"):
        outs = batched(_keys([s for _, s in points]), [o[0] for o in ops],
                       [o[1] for o in ops], dev)
    return _lane_rows(outs, points, probe, 0,
                      len(points) if n_out is None else min(n_out, len(points)))


def _agreed(mesh, blocks: bool, fn) -> list:
    """``fn()``'s rows, the same decision on every rank of a mesh of more
    than one rank: its outcome goes through parallel/mesh.NodeMesh.exchange
    (raising on every rank if any rank's ``fn`` raised), and with
    ``blocks`` the result is every sweep row's block, in order.  Off a mesh
    arm, ``fn()`` itself."""
    if not _mesh_arm(mesh):
        return fn()
    err = rows = None
    try:
        rows = fn()
    except Exception as e:  # every rank learns of it in the exchange below
        err = e
    return _agree(mesh, blocks, err, rows)


def _agree(mesh, blocks: bool, err, rows) -> list:
    """One attempt's outcome exchanged over the grid (:func:`_agreed`), in
    the thread that drives the grid."""
    got = mesh.exchange(err, rows if blocks else None)
    return [m for block in got for m in block] if blocks else rows


def _finish_rows(points: list, rows: list, record: bool, n_out, probe, mesh) -> list:
    """A dispatch's rows cut to ``n_out``, their monitor violations noted
    and the rows recorded to the run log, by the writing rank."""
    if n_out is not None:
        points, rows = points[:n_out], rows[:n_out]
    writer = _writer(mesh)
    if probe is not None and writer:
        from blockchain_simulator_tpu_torch.obsim import host as obsim_host

        for m, (cfg_i, seed) in zip(rows, points):
            obsim_host.note_violations(m["probe"], cfg_i, int(seed))
    if record and writer:
        _record(rows, [c for c, _ in points], [s for _, s in points])
    return rows


def _lane_rows(outs, points, probe, first: int, count: int) -> list:
    """The metrics rows (with their ``"probe"`` summaries when armed) of
    ``count`` lanes of a batched program's output, lane ``i`` of it being
    ``points[first + i]``."""
    finals, probes = outs if probe is not None else (outs, None)
    if probes is not None:
        from blockchain_simulator_tpu_torch.obsim import host as obsim_host

        probes = obsim_host.tree_to_host(probes)  # one copy a leaf
    rows = []
    for i in range(count):
        cfg_i = points[first + i][0]
        m = sim_metrics(cfg_i, lane_state(finals, i))
        if probe is not None:
            m["probe"] = obsim_host.summarize_lane(cfg_i, probe, probes, i)
        rows.append(m)
    return rows


def _mesh_block(canon: SimConfig, points: list, mesh, probe, dev) -> list:
    """This sweep row's rows of a mesh dispatch: the points padded to a
    multiple of the sweep axis, the row's block of them (its real lanes)
    through the row's program (:func:`mesh_lanes_fn`).  No collective
    beyond the row's nodes group."""
    lanes = _sweep_lanes(mesh)
    padded, n_real = partition.pad_points(points, lanes)
    if int(mesh.shape[NODES_AXIS]) > 1:
        _nodes_refusal(canon, len(padded))
    per = len(padded) // lanes
    first = mesh.sweep_index * per
    mine = padded[first:min(first + per, n_real)]
    if not mine:
        return []
    if probe is not None:
        from blockchain_simulator_tpu_torch.obsim import build as obsim_build

        batched = obsim_build.probed_mesh_fn(canon, probe, mesh)
    else:
        batched = mesh_dyn_batched_fn(canon, mesh)
    ops = [_dyn_operands(cfg, cfg.faults) for cfg, _ in mine]
    with telemetry.profile_region("sweep_dispatch"):
        outs = batched(_keys([s for _, s in mine]), [o[0] for o in ops],
                       [o[1] for o in ops], dev)
    return _lane_rows(outs, mine, probe, 0, len(mine))


def _run_chunk(canon, tile, record, n_out, mesh, supervise, journal, key, index,
               multi_seed=False, probe=None, device=None):
    """Compute ONE chunk, optionally under the supervisor's deadline ->
    retry -> degrade state machine (parallel/journal.py).  The
    ``sweep.chunk`` chaos point fires once an ATTEMPT with the arm in its
    ctx, so a drill can wedge exactly the primary arm and watch the degrade
    arm answer.  Every arm runs on ``device`` (the mesh's, over a mesh): a
    supervised attempt runs in a worker thread, which selects the card
    first.  Over a mesh the degrade arm is JAX's mesh shrink: the
    single-device program on every rank.

    Over a mesh of more than one rank an attempt computes only this rank's
    part, and the grid exchanges the outcomes in the calling thread after
    each attempt of either arm (journal.run_supervised's ``agree``): every
    rank retries, degrades or fails when any rank's attempt failed or
    missed its deadline.  An abandoned attempt then computes on alone but
    issues no collective of the grid (the nodes-axis arm, whose lanes do,
    refuses a deadline: :func:`run_dyn_points`)."""
    dev = _device(mesh, device)
    grid = _mesh_arm(mesh)
    blocks = grid and len(tile) > 1

    def on_device(fn):
        """``fn`` with ``dev`` selected in the calling thread first (a
        deadline's worker thread starts on the process's current card)."""
        if dev.type != "cuda":
            return fn

        def run():
            import torch

            torch.cuda.set_device(dev)
            return fn()

        return run

    def primary():
        """The primary arm; over a grid, this rank's part of it."""
        inject.chaos_point("sweep.chunk", key=key, index=index,
                           n=len(tile), arm="primary", mesh=mesh is not None)
        # every chunk ATTEMPT is one span on a chunk-scoped trace
        # (utils/telemetry.py): which chunk, which arm, how long, as data
        with telemetry.span("sweep.chunk", key=key, index=index,
                            n=len(tile), arm="primary"):
            if grid:
                return _local_rows(canon, tile, n_out, mesh, multi_seed, probe, dev)
            return _dispatch_dyn_points(canon, tile, record, n_out, mesh,
                                        multi_seed, probe, dev)

    def finish(rows):
        return _finish_rows(tile, rows, record, n_out, probe, mesh)

    if supervise is None:
        return finish(_agreed(mesh, blocks, primary)) if grid else primary()

    if supervise.checkpoint_dir and len(tile) == 1 \
            and not use_round_schedule(tile[0][0]):
        # the very-long-single-sim arm: tick-level mid-chunk checkpoints
        # (utils/checkpoint.py); a re-kill resumes MID-chunk from the last
        # segment instead of restarting the whole run, on the same device
        cfg_pt, seed_pt = tile[0]

        def degrade():
            inject.chaos_point("sweep.chunk", key=key, index=index,
                               n=len(tile), arm="degrade-checkpoint",
                               mesh=False)
            with telemetry.span("sweep.chunk", key=key, index=index,
                                n=len(tile), arm="degrade-checkpoint"):
                m, _ = runner.run_dyn_checkpointed(
                    cfg_pt, supervise.checkpoint_every_ms,
                    os.path.join(supervise.checkpoint_dir, key),
                    seed=seed_pt, device=dev,
                )
            return [m]
    else:
        # JAX's mesh-shrink arm: the single-device program (over a mesh, on
        # every rank alone), on the same device, equal rows
        def degrade():
            inject.chaos_point("sweep.chunk", key=key, index=index,
                               n=len(tile), arm="degrade", mesh=False)
            with telemetry.span("sweep.chunk", key=key, index=index,
                                n=len(tile), arm="degrade"):
                return _dispatch_dyn_points(canon, tile, record, n_out,
                                            mesh=None, probe=probe, device=dev)

    def agree(arm, err, rows):
        if arm == "primary":
            return finish(_agree(mesh, blocks, err, rows))
        return _agree(mesh, False, err, rows)

    rows, _events = journal_mod.run_supervised(
        on_device(primary), on_device(degrade), supervise,
        journal=journal if _writer(mesh) else None, key=key, agree=agree if grid else None,
    )
    return rows


def run_dyn_points(canon: SimConfig, points, record: bool = True,
                   n_out: int | None = None, mesh=None, journal=None,
                   chunk_size: int | None = None, supervise=None,
                   multi_seed: bool = False, probe=None,
                   key_suffix: str = "", with_index: bool = False, device=None):
    """THE group-dispatch primitive: one batched program over a list of
    same-structure ``(cfg, seed)`` points (configs that canonicalize to
    ``canon`` and differ only in fault counts).  Returns one metrics dict a
    point, in order (the first ``n_out`` when given: the server's padded
    lanes are dropped).  ``multi_seed`` dispatches the solo-semantics
    program (:func:`multi_seed_fn`).

    **Durable execution** (``journal=``, a parallel/journal.SweepJournal),
    as in the JAX package: the point list splits into ``chunk_size``-point
    chunks (default one chunk; the fault sweeps pass one chunk a fault
    level), each chunk's rows are appended to the journal (fsynced, with
    row checksums and the registry ``cache`` block) BEFORE the next chunk
    dispatches, and a chunk whose content key (journal.chunk_key) is
    already journaled is served from the journal without a dispatch.
    Resumed rows ride a JSON round trip and are not re-recorded to the run
    log.  ``supervise=`` (journal.ChunkSupervisor) wraps every computed
    chunk in the deadline -> retry -> degrade machine, with or without a
    journal.  Under ``"normal"``/``"rbg"`` a chunk's rows are its own
    batch's (the first-lane rule), as JAX's chunked rows are.

    ``probe=`` (obsim/schema.ProbeConfig) arms the taps: every row gains a
    ``"probe"`` summary, the metrics stay the disarmed run's, and armed
    chunks journal under a ``+p<W>[m]`` key suffix, so a journal written
    disarmed never answers an armed call.  ``key_suffix`` is appended to
    every chunk key after it (the query engine's ``+q<step>`` namespace).

    ``with_index=True`` returns ``(rows, meta)``: ``meta["rows"][i]`` maps
    output row ``i`` to its point (``point``, ``seed``, ``key``, ``cached``)
    and ``meta`` carries ``dispatches``, ``lanes`` (the mesh's padded lanes
    included), ``pad`` and the per-chunk trail ``chunks``.

    ``mesh=`` (a parallel/mesh.make_mesh grid; call it on every rank) runs
    each dispatch over the grid's sweep rows (module docstring): chunks
    align up to a multiple of the sweep axis (partition.align_chunk), the
    journal's keys carry the mesh's shape, as JAX's do, and a one-point
    list takes the single-device path."""
    points = list(points)
    meta = {"rows": [], "chunks": [], "lanes": 0, "dispatches": 0, "pad": 0}
    device = _device(mesh, device)

    def _lanes(n: int) -> int:
        if n > 1 and _mesh_arm(mesh):
            axis = _sweep_lanes(mesh)
            return -(-n // axis) * axis
        return n

    def _done(rows):
        return (rows, meta) if with_index else rows

    if journal is None and supervise is None:
        rows = _dispatch_dyn_points(canon, points, record, n_out, mesh, multi_seed, probe,
                                    device)
        if points:
            meta["dispatches"] = 1
            meta["lanes"] = _lanes(len(points))
            meta["pad"] = meta["lanes"] - len(points)
        pts_out = points if n_out is None else points[:n_out]
        meta["rows"] = [{"point": i, "seed": int(s), "key": None, "cached": False}
                        for i, (_, s) in enumerate(pts_out)]
        return _done(rows)
    if not points:
        return _done([])
    if chunk_size is None or n_out is not None:
        # n_out callers (serve's bucket-padded flushes) journal the whole
        # batch as ONE chunk: pad lanes never split across chunk keys
        chunk_size = len(points)
    if _mesh_arm(mesh):
        chunk_size = partition.align_chunk(chunk_size, _sweep_lanes(mesh))
        if supervise is not None and supervise.deadline_s is not None \
                and int(mesh.shape[NODES_AXIS]) > 1:
            raise ValueError(
                "a supervised sweep over a mesh with a nodes axis > 1 takes no deadline: "
                "an abandoned attempt would go on issuing its nodes group's collectives "
                "beside the retry's; pass ChunkSupervisor(deadline_s=None) (a failing "
                "rank still fails the attempt on every rank)")
    done = {}
    if journal is not None:
        # every rank must dispatch the same chunks: rank 0 reads the journal
        # and its answer goes to every rank
        done = journal.completed() if mesh is None or mesh.world_rank == 0 else None
        done = done if mesh is None else mesh.from_rank0(done)
    out = []
    for index, start in enumerate(range(0, len(points), chunk_size)):
        tile = points[start:start + chunk_size]
        want = len(tile) if n_out is None else max(0, min(len(tile), n_out))
        t_out = None if n_out is None else want
        key = journal_mod.chunk_key(canon, index, tile, mesh, n_out=t_out)
        if probe is not None:
            # armed and disarmed calls never share a journal key: a cached
            # disarmed chunk has no "probe" summaries to serve
            key += f"+p{probe.windows}{'m' if probe.monitors else ''}"
        key += key_suffix
        cached = done.get(key)
        if cached is not None and len(cached) == want:
            meta["chunks"].append({"key": key, "index": index, "cached": True, "n": want})
            meta["rows"] += [{"point": start + j, "seed": int(tile[j][1]), "key": key,
                              "cached": True} for j in range(want)]
            out.extend(cached)
            continue
        # every dispatch ATTEMPT runs record=False: only the winning arm's
        # rows (journaled below) reach the run log, so an abandoned slow
        # attempt finishing late cannot double-record its points
        rows = _run_chunk(canon, tile, False, t_out, mesh, supervise, journal, key, index,
                          multi_seed, probe, device)
        # durable BEFORE the next chunk dispatches: the recompute-at-most-one
        # contract of a kill -9
        if journal is not None and _writer(mesh):
            journal.append_chunk(key, index, rows, cache=aotcache.registry.manifest())
        if record and _writer(mesh):
            pts_out = tile if t_out is None else tile[:t_out]
            _record(rows, [c for c, _ in pts_out], [s for _, s in pts_out])
        meta["dispatches"] += 1
        meta["lanes"] += _lanes(len(tile))
        meta["pad"] += _lanes(len(tile)) - len(tile)
        meta["chunks"].append({"key": key, "index": index, "cached": False, "n": len(rows)})
        meta["rows"] += [{"point": start + j, "seed": int(tile[j][1]), "key": key,
                          "cached": False} for j in range(len(rows))]
        out.extend(rows)
    return _done(out)


def dyn_chunk_keys(cfg: SimConfig, fault_configs, seeds, mesh=None):
    """The chunk keys a journaled ``run_fault_sweep(cfg, fault_configs,
    seeds, mesh=..., journal=...)`` uses for ONE same-structure group,
    derived from the grid alone (never from a journal's content), so a
    coverage check is independent evidence.  All ``fault_configs`` must
    share one canonical structure.  The JAX package's keys, byte for byte
    (over a mesh: its shape, as JAX's mesh of the same shape)."""
    fcs = list(fault_configs)
    canons = {canonical_fault_cfg(cfg.with_(faults=fc)) for fc in fcs}
    if len(canons) != 1:
        raise ValueError(
            f"dyn_chunk_keys covers one structure group, got {len(canons)}"
        )
    canon = next(iter(canons))
    chunk = len(seeds)
    if _mesh_arm(mesh):
        chunk = partition.align_chunk(chunk, _sweep_lanes(mesh))
    points = [(cfg.with_(faults=fc), s) for fc in fcs for s in seeds]
    return [journal_mod.chunk_key(canon, i, points[st:st + chunk], mesh)
            for i, st in enumerate(range(0, len(points), chunk))]


def _run_dyn_group(cfg: SimConfig, canon: SimConfig, fcs, seeds, mesh=None,
                   journal=None, supervise=None, multi_seed=False, device=None):
    """One program for every (fault config, seed) point of a same-structure
    group; returns ``{fc: [metrics a seed]}``.  With a journal or a
    supervisor the group chunks one fault level (its seed tile) a chunk, so
    a crash mid-grid loses at most one level's seed batch."""
    points = [(cfg.with_(faults=fc), seed) for fc in fcs for seed in seeds]
    tiled = journal is not None or supervise is not None
    rows = run_dyn_points(canon, points, mesh=mesh, journal=journal,
                          chunk_size=len(seeds) if tiled else None,
                          supervise=supervise, multi_seed=multi_seed, device=device)
    n_s = len(seeds)
    return {fc: rows[i * n_s:(i + 1) * n_s] for i, fc in enumerate(fcs)}


def run_fault_sweep(cfg: SimConfig, fault_configs, seeds, mesh=None,
                    journal=None, supervise=None, multi_seed=False, device=None):
    """BASELINE config 4: sweep fault configs, seeds batched inside.
    Returns ``{fault_config: [metrics a seed]}``.  Fault configs that differ
    only in their counts share one program (a structure group); the mixed
    sim takes the static :func:`run_seed_sweep` path, one program a fault
    config, un-journaled (it has no dynamic-operand chunk identity).
    ``journal=`` / ``supervise=`` / ``mesh=``: :func:`run_dyn_points`; the
    static path stays on one device (every rank runs it alone, as JAX's
    stays single-device)."""
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
        done.update(_run_dyn_group(cfg, canon, fcs, seeds, mesh=mesh, journal=journal,
                                   supervise=supervise, multi_seed=multi_seed,
                                   device=device))
    device = _device(mesh, device)
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
    safety outcomes).  ``mesh=``: :func:`run_dyn_points`."""
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
