"""Node-shard SPMD execution (port of ``blockchain_simulator_tpu/parallel/
shard.py``): spec declarations over the partition rules, and the sharded
sim factories.

The whole simulation runs over the mesh's ``nodes`` axis: node state
``[N, ...]`` and ring buffers ``[D, N, ...]`` are row-sharded, and the
delivery functions (ops/delivery.py) globalize sender-side quantities with
the mesh's all_gather / all_reduce.  Each rank of an initialized group
calls the same factory with its mesh (parallel/mesh.make_mesh) and gets
``sim(key) -> final state``, the full final state on every rank
(parallel/partition.partition gathers it).  With a mesh of W ranks the run
equals JAX's ``run_sharded`` over a W-device mesh bit for bit: the
per-shard keys fold in the shard index (ops/delivery._shard_key), never
the process.

The rule declarations are JAX's, with one difference the port's layout
makes: the mixed sim's Raft rings are slot-major ``[D, S, m, ...]`` here
(``[S, D, m, ...]`` in JAX's vmapped leaves), so their shard axis is dim 1
(:data:`MIXED_BUF_RULES`).
"""

from __future__ import annotations

import time

from blockchain_simulator_tpu_torch.models.base import get_protocol, tick_loop
from blockchain_simulator_tpu_torch.parallel import partition
from blockchain_simulator_tpu_torch.parallel.mesh import NODES_AXIS
from blockchain_simulator_tpu_torch.parallel.partition import P
from blockchain_simulator_tpu_torch.utils import threefry
from blockchain_simulator_tpu_torch.utils.config import SimConfig
from blockchain_simulator_tpu_torch.utils.sync import force_sync

_INIT_FOLD = 0x1217  # proto.init's key, as in the JAX package


# ----------------------------------------------------- rule declarations ---

def state_rules(global_fields=()):
    """Node state ``[N, ...]``: row-shard dim 0, except the protocol's
    ``GLOBAL_FIELDS`` (per-slot accumulators: replicated, each shard
    carrying a partial its ``finalize`` combines)."""
    return partition.node_dim_rules(global_fields)


# Ring/delivery buffers [D, N, ...]: the node axis is dim 1.
BUF_RULES = ((r".*", P(None, NODES_AXIS)),)

# Mixed shard sim (models/mixed.py): Raft leaves [S, ...] row-shard over the
# shard axis; the S-representative PBFT layer is replicated (every rank
# steps an identical copy).
MIXED_RULES = (
    (r"^raft(/|$)", P(NODES_AXIS)),
    (r"^pbft(/|$)", partition.REPLICATED),
)
# its rings: the Raft rings slot-major [D, S, m, ...], the PBFT layer's
# replicated
MIXED_BUF_RULES = (
    (r"^raft(/|$)", P(None, NODES_AXIS)),
    (r"^pbft(/|$)", partition.REPLICATED),
)


def state_specs(state, global_fields=()):
    """Specs for a state tree (rule-matched; see :func:`state_rules`)."""
    return partition.match_partition_rules(state_rules(global_fields), state)


def node_specs(state, bufs, global_fields=()):
    """(state specs, buffer specs) for a (state, bufs) pair."""
    return (state_specs(state, global_fields),
            partition.match_partition_rules(BUF_RULES, bufs))


def mixed_specs(state, bufs):
    """Specs for the mixed shard sim's (state, bufs) pair."""
    return (partition.match_partition_rules(MIXED_RULES, state),
            partition.match_partition_rules(MIXED_BUF_RULES, bufs))


def _partitioned(run, mesh, in_specs, out_specs):
    """The factories' one door to the mesh (per-shard specs)."""
    return partition.partition(run, mesh, in_specs=in_specs, out_specs=out_specs)


def _check_nodes(cfg, mesh):
    n_shards = mesh.shape[NODES_AXIS]
    if cfg.n % n_shards != 0:
        raise ValueError(f"n={cfg.n} not divisible by {n_shards} node shards")


def _check_mixed(cfg, mesh):
    n_shards = mesh.shape[NODES_AXIS]
    if cfg.mixed_shards % n_shards != 0:
        raise ValueError(
            f"mixed_shards={cfg.mixed_shards} not divisible by "
            f"{n_shards} mesh shards")


def _sim(init, shmapped, mesh, n_rows: int):
    """``sim(key)``: this rank's rows of the init on its device (its block
    of the ``n_rows`` rows: the fault masks are deterministic and the keyed
    draws are taken at the rows' global indices, so the block equals the
    global init's, and no rank holds the global rings), then the sharded
    body.  ``sim(key, timings)`` also records the seconds of the init
    (``init_s``), the body and the gather (parallel/partition.py)."""
    rows = mesh.rows(n_rows)  # the factories have checked that they divide

    def sim(key, timings=None):
        t0 = time.perf_counter()
        state, bufs = init(threefry.fold_in(key, _INIT_FOLD), mesh.device, rows)
        if timings is not None:
            force_sync((state, bufs))
            timings["init_s"] = time.perf_counter() - t0
        return shmapped(key, state, bufs, scattered=True, timings=timings)

    return sim


# ------------------------------------------------------------- factories ---


def _make_sharded_round_fn(cfg: SimConfig, mesh):
    """Node-sharded round-blocked PBFT fast path (models/pbft_round.py): the
    per-round reductions ride all-reduces over the mesh."""
    from blockchain_simulator_tpu_torch.models import pbft_round

    _check_nodes(cfg, mesh)
    cfg_local = cfg.with_(mesh_axis=NODES_AXIS)
    state0, _ = pbft_round.init(cfg, device="meta")
    state_spec = state_specs(state0, pbft_round.GLOBAL_FIELDS)

    def run(key, state, bufs):
        del bufs
        state = pbft_round.scan_rounds(cfg_local, state, key)
        return pbft_round.finalize(state, NODES_AXIS)

    shmapped = _partitioned(run, mesh, (P(), state_spec, ()), state_spec)
    return _sim(lambda k, dev, rows: pbft_round.init(cfg, k, device=dev, rows=rows),
                shmapped, mesh, cfg.n)


def _make_sharded_raft_hb_fn(cfg: SimConfig, mesh):
    """Node-sharded heartbeat-blocked Raft fast path (models/raft_hb.py):
    the election prefix runs on the sharded tick engine; the handoff's
    predicate and leader scalars are all-reduced, so every rank takes the
    same arm (the steady scan, replicated O(1) work materialized at each
    rank's rows, or the sharded tick engine continued)."""
    from blockchain_simulator_tpu_torch.models import raft as raft_tick
    from blockchain_simulator_tpu_torch.models import raft_hb

    _check_nodes(cfg, mesh)
    cfg_local = cfg.with_(mesh_axis=NODES_AXIS)
    state0, bufs0 = raft_tick.init(cfg, device="meta")
    state_spec, bufs_spec = node_specs(state0, bufs0)

    def run(key, state, bufs):
        return raft_hb.scan_from_init(cfg_local, state, bufs, key)

    shmapped = _partitioned(run, mesh, (P(), state_spec, bufs_spec), state_spec)
    return _sim(lambda k, dev, rows: raft_tick.init(cfg, k, device=dev, rows=rows),
                shmapped, mesh, cfg.n)


def _make_sharded_mixed_fast_fn(cfg: SimConfig, mesh):
    """Shard-sharded heartbeat-scheduled mixed sim (models/mixed.scan_fast):
    Raft shard rows over the mesh, the S-representative PBFT layer
    replicated, the per-shard handoff verdict summed over the ranks."""
    from blockchain_simulator_tpu_torch.models import mixed

    _check_mixed(cfg, mesh)
    cfg_local = cfg.with_(mesh_axis=NODES_AXIS)
    state0, bufs0 = mixed.init(cfg, device="meta")
    state_spec, bufs_spec = mixed_specs(state0, bufs0)

    def run(key, state, bufs):
        return mixed.scan_fast(cfg_local, state, bufs, key)

    shmapped = _partitioned(run, mesh, (P(), state_spec, bufs_spec), state_spec)
    return _sim(lambda k, dev, rows: mixed.init(cfg, k, device=dev, rows=rows),
                shmapped, mesh, cfg.mixed_shards)


def make_sharded_sim_fn(cfg: SimConfig, mesh):
    """``sim(key) -> final_state`` with node state sharded over the mesh's
    ``nodes`` axis; ``cfg.n`` must divide by the axis size (the mixed sim:
    ``cfg.mixed_shards``).  Call it on every rank of the mesh's group.

    Schedule resolution matches runner.make_sim_fn: the PBFT round-blocked
    fast path when eligible, the Raft heartbeat fast path, the
    heartbeat-scheduled mixed sim, else the per-tick engine."""
    from blockchain_simulator_tpu_torch.runner import _reject_cpp_only, use_round_schedule

    _reject_cpp_only(cfg)
    if use_round_schedule(cfg):
        if cfg.protocol == "raft":
            return _make_sharded_raft_hb_fn(cfg, mesh)
        if cfg.protocol == "mixed":
            return _make_sharded_mixed_fast_fn(cfg, mesh)
        return _make_sharded_round_fn(cfg, mesh)
    proto = get_protocol(cfg.protocol)
    cfg_local = cfg.with_(mesh_axis=NODES_AXIS)
    state0, bufs0 = proto.init(cfg, device="meta")
    if cfg.protocol == "mixed":
        # the sharded unit is the Raft SHARD row, not the node
        _check_mixed(cfg, mesh)
        state_spec, bufs_spec = mixed_specs(state0, bufs0)
    else:
        _check_nodes(cfg, mesh)
        state_spec, bufs_spec = node_specs(state0, bufs0,
                                           getattr(proto, "GLOBAL_FIELDS", ()))

    def run(key, state, bufs):
        state, _ = tick_loop(cfg_local, state, bufs, key, 0, cfg.ticks)
        if hasattr(proto, "finalize"):
            state = proto.finalize(state, NODES_AXIS)
        return state

    shmapped = _partitioned(run, mesh, (P(), state_spec, bufs_spec), state_spec)
    return _sim(lambda k, dev, rows: proto.init(cfg, k, device=dev, rows=rows), shmapped,
                mesh, cfg.mixed_shards if cfg.protocol == "mixed" else cfg.n)


def run_sharded(cfg: SimConfig, mesh, seed: int | None = None):
    """Run one node-sharded simulation on every rank of ``mesh``; returns
    the protocol metrics dict (the same on every rank)."""
    sim = make_sharded_sim_fn(cfg, mesh)
    final = force_sync(sim(threefry.key(cfg.seed if seed is None else seed)))
    return get_protocol(cfg.protocol).metrics(cfg, final)
