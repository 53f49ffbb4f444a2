"""Simulation runner (port of ``blockchain_simulator_tpu/runner.py``).

The JAX package runs the whole simulation as one ``jax.lax.scan``; here the
scan is a Python loop.  The tick engine's loop calls ``proto.step`` with the
tick as a one-element int32 tensor on the device (rings index with it without
a host read) and the tick's threefry key, precomputed on the host for all
ticks at once (utils/prng.tick_key takes an array of ticks).  PBFT configs
that ``use_round_schedule`` resolves to the round-blocked fast path loop over
block intervals instead (models/pbft_round.scan_rounds); Raft configs it
resolves to the heartbeat-blocked path run models/raft_hb.run (the election
prefix on the tick engine, then one step a heartbeat), and mixed configs
models/mixed.scan_fast (the same in every Raft shard, beside the per-tick
PBFT layer).  ``topology="kregular"`` runs the tick engine over the overlay
tables (topo/spec.py; :func:`make_topo_dyn_sim_fn` takes them as
arguments), and ``topology="committee"`` runs the flat tick engine with the
committees as lanes (topo/committee.py), whose stacked final state
models/base.sim_metrics aggregates.

Dynamic fault operands (JAX's ``make_dyn_sim_fn``): the fault COUNTS are
run-time operands of a program built once a fault *structure*
(models/base.canonical_fault_cfg), so a sweep over fault levels needs one
program (parallel/sweep.py).  Checkpoints: ``make_segment_fn`` steps the tick
engine from any tick, and ``run_checkpointed`` / ``run_dyn_checkpointed``
write the JAX package's archive (utils/checkpoint.py) every ``every_ms``;
``resume_simulation`` / ``resume_dyn_simulation`` finish a run from one.
Tick keys derive from the absolute tick, so a segmented or resumed run
equals the uninterrupted one.

Entry points run on the CUDA card unless the caller asks for another device
(``device="cpu"``, as the tests do); without CUDA they raise instead of
carrying on on the CPU.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch

from blockchain_simulator_tpu_torch.models import base as base_model
from blockchain_simulator_tpu_torch.models.base import get_protocol, sim_metrics
from blockchain_simulator_tpu_torch.utils import aotcache, threefry
from blockchain_simulator_tpu_torch.utils.config import SimConfig

_INIT_FOLD = 0x1217  # proto.init's key, as in the JAX package


class UnbatchableConfigError(NotImplementedError):
    """A config whose faults cannot become run-time operands: it has no
    dynamic-fault-operand program (:func:`make_dyn_sim_fn`), so it joins no
    sweep group (parallel/sweep.py).  A ``NotImplementedError``, as in the
    JAX package."""


def check_batchable(cfg: SimConfig) -> None:
    """Raise :class:`UnbatchableConfigError` when ``cfg`` has no
    dynamic-fault-operand program: the mixed shard sim, whose faults are
    per-shard init structure, not maskable state."""
    if cfg.protocol == "mixed":
        raise UnbatchableConfigError(
            "dynamic fault operands are not implemented for the mixed shard "
            "sim (faults live at the raft-shard level, models/mixed.py); "
            "sweep it with one static compile per fault config"
        )


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a missing card is an error."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on a CUDA device by default and torch reports none; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return dev


def use_round_schedule(cfg: SimConfig) -> bool:
    """Resolve cfg.schedule as the JAX package does: does this config run a
    phase-blocked fast path (PBFT: one step a block interval,
    models/pbft_round.py; Raft: one step a heartbeat, models/raft_hb.py;
    mixed: the heartbeat scan in every Raft shard, models/mixed.py)?"""
    if cfg.schedule == "tick":
        return False
    if cfg.topology in ("kregular", "committee"):
        if cfg.schedule == "round":
            raise ValueError(
                f"schedule='round' is a full-mesh fast path; topology="
                f"{cfg.topology!r} runs the tick engine (use schedule="
                "'tick' or 'auto')"
            )
        return False
    if cfg.protocol == "raft":
        from blockchain_simulator_tpu_torch.models import raft_hb

        ok = raft_hb.eligible(cfg)
        if cfg.schedule == "round":
            if not ok:
                raise ValueError(
                    "schedule='round' for raft requires clean fidelity + "
                    "full mesh + stat delivery with no drops/queued links, "
                    "heartbeat < election_lo, and a window longer than the "
                    "election prefix (models/raft_hb.eligible)"
                )
            return True
        return ok and cfg.n >= 4096  # "auto"
    if cfg.protocol == "mixed":
        from blockchain_simulator_tpu_torch.models import mixed

        ok = mixed.fast_eligible(cfg)
        if cfg.schedule == "round":
            if not ok:
                raise ValueError(
                    "schedule='round' for the mixed sim requires its raft "
                    "shards to be heartbeat-schedulable: clean fidelity + "
                    "stat delivery with no drops/queued links and a window "
                    "longer than the election prefix (models/raft_hb.eligible "
                    "on the shard sub-config)"
                )
            return True
        # "auto": no n threshold; a failed handoff continues the tick engine
        return ok
    if cfg.protocol != "pbft":
        return False
    from blockchain_simulator_tpu_torch.models import pbft_round

    ok = pbft_round.eligible(cfg)
    if cfg.schedule == "round":
        if not ok:
            raise ValueError(
                "schedule='round' requires pbft + full mesh + stat delivery "
                "with no byz_forge, no queued links, drops only when view "
                "changes are disabled AND the vote table is exact "
                "(pbft_window = 0 or >= pbft_max_slots), and a message "
                "horizon — including the constant block-serialization "
                "latency when modeled — inside one block interval "
                "(models/pbft_round.eligible)"
            )
        return True
    return ok and cfg.n >= 4096  # "auto"


def _reject_cpp_only(cfg: SimConfig) -> None:
    """Refuse what only the C++ engine models (as the JAX package does)."""
    if cfg.echo_back:
        raise NotImplementedError(
            "echo_back (quirk #1) is modeled by the C++ engine only: the "
            "tensorized engines design the echo away (models/pbft.py)"
        )
    if cfg.queued_links:
        if cfg.protocol == "mixed":
            raise NotImplementedError(
                "queued_links is not modeled by the mixed shard sim"
            )
        if cfg.protocol in ("pbft", "raft"):
            if cfg.topology != "full":
                raise ValueError(
                    "queued_links (tensorized) requires topology='full': the "
                    "serial-pipe registers model the leader's direct links"
                )
            if cfg.faults.drop_prob != 0.0:
                raise ValueError(
                    "queued_links (tensorized) requires drop_prob = 0: with "
                    "drops, leader beliefs can diverge and the per-destination "
                    "busy registers assume a single block sender"
                )
        if cfg.protocol == "pbft":
            from blockchain_simulator_tpu_torch.models.pbft import eff_window

            _, hi = cfg.one_way_range()
            if eff_window(cfg) < cfg.pbft_max_slots:
                raise ValueError(
                    "queued_links (tensorized) requires the exact vote table "
                    "(pbft_window = 0 or >= pbft_max_slots)"
                )
            if hi - 1 >= cfg.pbft_block_interval_ms:
                raise ValueError(
                    "queued_links (tensorized) requires the one-way delay to "
                    "fit inside one block interval"
                )


def _reject_mesh_axis(cfg: SimConfig) -> None:
    """A config with ``mesh_axis`` set is a node-sharded body's: it runs on
    every rank of a node mesh, never through the single-device runner."""
    if cfg.mesh_axis is not None:
        raise NotImplementedError(
            f"mesh_axis={cfg.mesh_axis!r} is a node-sharded config: run it on every "
            "rank of a node mesh (parallel/shard.run_sharded; kregular and committee "
            "configs: parallel/sweep.run_sharded_topo); the single-device runner "
            "takes mesh_axis=None")


@aotcache.cached_factory("sim")
def make_sim_fn(cfg: SimConfig):
    """``sim(seed, device) -> final state``: the phase-blocked fast path
    when ``use_round_schedule`` picks it, else the tick engine, ``cfg.ticks``
    ticks from ``proto.init``.  Built once a config (the ``"sim"`` registry
    entry, utils/aotcache.py)."""
    _reject_cpp_only(cfg)
    _reject_mesh_axis(cfg)
    if cfg.topology == "committee":
        from blockchain_simulator_tpu_torch.topo import committee

        use_round_schedule(cfg)  # validates schedule='round' (always the tick engine)
        # the static arm: the config's own fault counts through the dyn body,
        # as the JAX package does, so one body serves both doors
        canon = base_model.canonical_fault_cfg(cfg)
        nc = cfg.faults.resolved_n_crashed(cfg.n)
        nb = cfg.faults.n_byzantine

        def sim_committee(seed: int, device):
            return committee.run_stacked(canon, threefry.key(seed), nc, nb, device=device)

        return sim_committee
    if use_round_schedule(cfg) and cfg.protocol == "raft":
        from blockchain_simulator_tpu_torch.models import raft_hb

        def sim_hb(seed: int, device):
            return raft_hb.run(cfg, threefry.key(seed), device)

        return sim_hb
    if use_round_schedule(cfg) and cfg.protocol == "mixed":
        from blockchain_simulator_tpu_torch.models import mixed

        def sim_mixed(seed: int, device):
            key = threefry.key(seed)
            state, bufs = mixed.init(cfg, threefry.fold_in(key, _INIT_FOLD), device=device)
            return mixed.scan_fast(cfg, state, bufs, key)

        return sim_mixed
    if use_round_schedule(cfg):
        from blockchain_simulator_tpu_torch.models import pbft_round

        def sim_round(seed: int, device):
            key = threefry.key(seed)
            state, _ = pbft_round.init(cfg, threefry.fold_in(key, _INIT_FOLD),
                                       device=device)
            return pbft_round.scan_rounds(cfg, state, key)

        return sim_round
    proto = get_protocol(cfg.protocol)

    def sim(seed: int, device):
        key = threefry.key(seed)
        state, bufs = proto.init(cfg, threefry.fold_in(key, _INIT_FOLD), device=device)
        return base_model.tick_loop(cfg, state, bufs, key, 0, cfg.ticks)[0]

    return sim


def dyn_step_cfg(canon: SimConfig, n_byzantine) -> SimConfig:
    """The config a dynamic-fault run steps at: ``canon``, with a positive
    Byzantine count when some lane has Byzantine nodes.  models/raft.step
    leaves the FAILED-ack channel out when the config has none (a static
    fact there, whose draws and pushes would all be zero), and no other
    step reads the count."""
    if np.max(np.asarray(n_byzantine)) > 0 and canon.faults.n_byzantine == 0:
        return canon.with_(faults=dataclasses.replace(canon.faults, n_byzantine=1))
    return canon


def _dyn_run(canon: SimConfig, key, n_crashed, n_byzantine, device):
    """One run from the canonical config with the fault counts as operands:
    ``proto.init`` at ``canon``, the masks installed
    (models/base.apply_fault_masks), then the engine ``use_round_schedule``
    picks.  Lane keys ``[B, 2]`` with ``[B]`` counts run ``B`` lanes side by
    side on every engine (parallel/sweep.lane_axis): the rows of JAX's
    vmapped batch (the committee hierarchy: ``[B, C, ...]``)."""
    if canon.topology == "committee":
        from blockchain_simulator_tpu_torch.topo import committee

        return committee.run_stacked(canon, key, n_crashed, n_byzantine, device=device)
    masks = base_model.dyn_fault_masks(canon.n, n_crashed, n_byzantine, device)
    init_key = threefry.fold_in(key, _INIT_FOLD)
    cfg = dyn_step_cfg(canon, n_byzantine)
    if use_round_schedule(canon):
        if canon.protocol == "raft":
            from blockchain_simulator_tpu_torch.models import raft, raft_hb

            state, bufs = raft.init(canon, init_key, device=device)
            state = base_model.apply_fault_masks(canon, state, *masks)
            return raft_hb.scan_from_init(cfg, state, bufs, key)
        from blockchain_simulator_tpu_torch.models import pbft_round

        state, _ = pbft_round.init(canon, init_key, device=device)
        state = base_model.apply_fault_masks(canon, state, *masks)
        return pbft_round.scan_rounds(cfg, state, key)
    if np.ndim(key) == 2:
        state, bufs = base_model.init_lanes(canon, init_key, device)
    else:
        state, bufs = get_protocol(canon.protocol).init(canon, init_key, device=device)
    state = base_model.apply_fault_masks(canon, state, *masks)
    return base_model.tick_loop(cfg, state, bufs, key, 0, canon.ticks)[0]


def make_dyn_sim_fn(cfg: SimConfig):
    """``sim(key, n_crashed, n_byzantine, device) -> final state`` for one
    run, with the fault COUNTS as run-time operands: the program is built
    at the canonical config (models/base.canonical_fault_cfg), so one
    serves every fault level of a structure, and at equal counts it equals
    :func:`make_sim_fn` at the static config.  ``key`` is a threefry key
    (``threefry.key(seed)``).  The mixed shard sim is refused with
    :class:`UnbatchableConfigError` (JAX's ``make_dyn_sim_fn``)."""
    canon = base_model.canonical_fault_cfg(cfg)
    check_batchable(canon)
    _reject_cpp_only(canon)
    _reject_mesh_axis(canon)
    if canon.topology == "committee":
        from blockchain_simulator_tpu_torch.topo import committee

        use_round_schedule(canon)  # validates schedule='round' (always the tick engine)

        def sim_committee(key, n_crashed, n_byzantine, device):
            return committee.run_stacked(canon, np.asarray(key, np.int64), int(n_crashed),
                                         int(n_byzantine), device=device)

        return sim_committee

    def sim(key, n_crashed, n_byzantine, device):
        return _dyn_run(canon, np.asarray(key, np.int64), int(n_crashed),
                        int(n_byzantine), device)

    return sim


def topo_tables_inslot(cfg: SimConfig) -> bool:
    """Does this protocol's kregular arm read the ``inslot`` cross-index
    (three tables) or just the in/out pair (two)?"""
    return cfg.protocol == "raft"


def make_topo_dyn_sim_fn(cfg: SimConfig, exchange_spec=None, axis=None):
    """The tables-as-arguments twin of :func:`make_dyn_sim_fn` for the
    kregular overlay: ``sim(key, n_crashed, n_byzantine, *tables, device)
    -> final state``, where ``tables`` are the full ``[N, K]`` overlay
    tables (ops/gatherdeliv.table_operands: ``(in, out)``, plus ``inslot``
    for Raft, :func:`topo_tables_inslot`), numpy or tensors.  They go to the
    device once a run and every tick reads them there; at equal values the
    run equals :func:`make_dyn_sim_fn`'s.  Unsharded, lane keys ``[B, 2]``
    with ``[B]`` counts step ``B`` lanes over the same tables.

    Sharded (the body of parallel/sweep.sharded_topo_sim_fn, run inside
    parallel/partition.partition with its mesh bound in global view):
    ``axis`` names the bound mesh axis, and the sim builds only this rank's
    rows of the init (the draws at their global indices), steps them with
    ``mesh_axis=axis`` and returns this rank's final rows.  With
    ``exchange_spec`` (a parallel/partition.ExchangeSpec; it implies the
    nodes axis) the tables
    are this rank's rows and the sim takes the exchange plans after them,
    ``sim(key, nc, nb, *tables, *plans, device)``; without it every rank
    holds the whole tables and neighbour rows are all-gathered (the
    "regather" layout)."""
    from blockchain_simulator_tpu_torch.ops import gatherdeliv as gd

    canon = base_model.canonical_fault_cfg(cfg)
    check_batchable(canon)
    _reject_cpp_only(canon)
    if canon.topology != "kregular":
        raise ValueError(
            f"make_topo_dyn_sim_fn is the kregular tables-as-operands "
            f"program; topology={canon.topology!r} has no overlay tables "
            "(committee shards its stacked axis instead — parallel/sweep."
            "sharded_topo_sim_fn routes it)"
        )
    use_round_schedule(canon)  # validates schedule='round' (kregular: tick)
    inslot = topo_tables_inslot(canon)
    n_tables = 3 if inslot else 2
    n_plans = 0 if exchange_spec is None else exchange_spec.n_operands
    if exchange_spec is not None and axis is None:
        from blockchain_simulator_tpu_torch.parallel.mesh import NODES_AXIS

        axis = NODES_AXIS
    proto = get_protocol(canon.protocol)

    def sim(key, n_crashed, n_byzantine, *tables, device):
        if len(tables) != n_tables + n_plans:
            raise ValueError(f"{canon.protocol} kregular sim takes {n_tables} overlay "
                             f"tables and {n_plans} exchange plans, got {len(tables)}")
        tables, plans = tables[:n_tables], tables[n_tables:]
        dev = torch.device(device)
        key = np.asarray(key, np.int64)
        rows = None
        if axis is not None:
            from blockchain_simulator_tpu_torch.parallel.mesh import bound

            if key.ndim == 2:
                raise NotImplementedError("the kregular lanes step unsharded")
            rows = bound(axis).rows(canon.n)
        init_key = threefry.fold_in(key, _INIT_FOLD)
        state, bufs = (base_model.init_lanes(canon, init_key, dev) if key.ndim == 2 else
                       proto.init(canon, init_key, device=dev, rows=rows))
        start, n_loc = (0, canon.n) if rows is None else rows
        state = base_model.apply_fault_masks(
            canon, state, *(m[..., start:start + n_loc] for m in base_model.dyn_fault_masks(
                canon.n, np.asarray(n_crashed), np.asarray(n_byzantine), dev)))
        step_cfg = dyn_step_cfg(canon, n_byzantine)
        xg = None
        if axis is not None:
            step_cfg = step_cfg.with_(mesh_axis=axis)
            if exchange_spec is not None:
                # the tables are this rank's rows of the padded tables: cut
                # them to its rows of the state
                tables = tuple(t[:state.alive.shape[-1]] for t in tables)
                xg = exchange_spec.build(*(gd._as_index(p, dev) for p in plans))
        tabs = gd.local_tables(canon, None, inslot=inslot, tables=tables, device=dev)
        final = base_model.tick_loop(step_cfg, state, bufs, key, 0, canon.ticks,
                                     topo_tables=tabs, exchange=xg)[0]
        if axis is not None and hasattr(proto, "finalize"):
            final = proto.finalize(final, axis)
        return final

    return sim


def final_state(cfg: SimConfig, seed: int | None = None, device=None):
    """Run and return the raw final state (for tests and digests)."""
    from blockchain_simulator_tpu_torch.utils.sync import force_sync

    dev = resolve_device(device)
    return force_sync(make_sim_fn(cfg)(cfg.seed if seed is None else seed, dev))


def run_simulation(cfg: SimConfig, seed: int | None = None, with_timing: bool = False,
                   device=None) -> dict:
    """Run one simulation; returns the protocol's structured metrics dict,
    the same dict the JAX package's ``run_simulation`` returns.

    ``with_timing`` stages through ``utils/obs.timed_run``: a first run
    pays the kernel build and the warm-up, then a second run is timed
    between ``force_sync``s; the dict gains ``compile_plus_first_run_s``,
    the execution-only ``wallclock_s`` and ``ticks``, as JAX's does."""
    if not with_timing:
        return sim_metrics(cfg, final_state(cfg, seed, device))
    from blockchain_simulator_tpu_torch.utils import obs

    dev = resolve_device(device)
    sim = make_sim_fn(cfg)
    final, compile_s, wall = obs.timed_run(lambda s: sim(s, dev),
                                           cfg.seed if seed is None else seed)
    m = sim_metrics(cfg, final)
    m["wallclock_s"] = wall
    m["compile_plus_first_run_s"] = round(compile_s, 3)
    m["ticks"] = cfg.ticks
    return m


def run_multi_seed(cfg: SimConfig, seeds, record: bool = True, device=None):
    """Multi-seed Monte Carlo: one metrics dict a seed, in order, each equal
    to ``run_simulation(cfg, seed=s)``.  The JAX package maps the unvmapped
    dyn program over the seeds (``lax.map``, solo semantics), so the lanes
    run in turn (parallel/sweep.multi_seed_fn).  The mixed shard sim raises
    :class:`UnbatchableConfigError`."""
    from blockchain_simulator_tpu_torch.parallel import sweep

    canon = base_model.canonical_fault_cfg(cfg)
    points = [(cfg, int(s)) for s in seeds]
    return sweep.run_dyn_points(canon, points, record=record, multi_seed=True,
                                device=device)


@aotcache.cached_factory("segment")
def make_segment_fn(cfg: SimConfig, n_ticks: int):
    """``seg(key, state, bufs, t0) -> (state, bufs)``: the tick engine
    ``n_ticks`` ticks on from tick ``t0``, on the state's device.  Tick keys
    derive from the absolute tick, so segments chained end to end equal one
    uninterrupted run (the checkpoint substrate)."""
    _reject_cpp_only(cfg)
    _reject_mesh_axis(cfg)
    if cfg.topology == "committee":
        raise ValueError(
            "segmented/checkpointed execution steps the flat (state, bufs) "
            "pair; the committee path's stacked state has no segment form "
            "(topo/committee.py) — run it un-checkpointed"
        )

    def seg(key, state, bufs, t0: int):
        t0 = int(t0)
        return base_model.tick_loop(cfg, state, bufs, np.asarray(key, np.int64), t0,
                                    t0 + n_ticks)

    return seg


def _tick_schedule(cfg: SimConfig) -> SimConfig:
    """Pin the tick engine for checkpointed execution: the phase-blocked
    fast paths have no tick-granular segments, and ``schedule="round"``
    asks for one explicitly."""
    if use_round_schedule(cfg):
        if cfg.schedule == "round":
            raise ValueError(
                "schedule='round' does not support checkpointing (the round "
                "fast path is not tick-segmentable); use schedule='tick'"
            )
        cfg = cfg.with_(schedule="tick")
    return cfg


def _segments(cfg, seg_cfg, key, state, bufs, t: int, every_ms: int, ckpt_dir, keep_all,
              last_path, dyn_counts=None):
    """Step ``seg_cfg`` from tick ``t`` to the end, writing an archive of
    ``cfg`` every ``every_ms`` ticks (only the newest kept unless
    ``keep_all``).  Returns ``(state, last_path)``."""
    from blockchain_simulator_tpu_torch.utils.checkpoint import save_checkpoint

    while t < cfg.ticks:
        n = min(every_ms, cfg.ticks - t)
        state, bufs = make_segment_fn(seg_cfg, n)(key, state, bufs, t)
        t += n
        path = ckpt_dir / f"ckpt_{t:08d}.npz"
        save_checkpoint(path, cfg, state, bufs, t, dyn_counts=dyn_counts)
        if last_path is not None and not keep_all:
            last_path.unlink()
        last_path = path
    return state, last_path


def run_checkpointed(cfg: SimConfig, every_ms: int, ckpt_dir, seed: int | None = None,
                     keep_all: bool = False, device=None):
    """Run to completion, writing a checkpoint every ``every_ms`` virtual
    ms (``ckpt_<tick>.npz``, the JAX package's archive); only the latest
    survives unless ``keep_all``.  The effective seed is stored in the
    archive's config.  Returns ``(metrics, last_checkpoint_path)``."""
    if every_ms < 1:
        raise ValueError(f"every_ms must be >= 1, got {every_ms}")
    cfg = _tick_schedule(cfg)
    dev = resolve_device(device)
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if seed is not None:
        cfg = cfg.with_(seed=seed)
    make_segment_fn(cfg, every_ms)  # refuses the committee hierarchy before any init
    proto = get_protocol(cfg.protocol)
    key = threefry.key(cfg.seed)
    state, bufs = proto.init(cfg, threefry.fold_in(key, _INIT_FOLD), device=dev)
    state, last_path = _segments(cfg, cfg, key, state, bufs, 0, every_ms, ckpt_dir,
                                 keep_all, None)
    return proto.metrics(cfg, state), last_path


def _dyn_checkpoint_cfg(cfg: SimConfig, seed: int | None) -> SimConfig:
    """Validate and normalize a config for dynamic-fault checkpointed
    execution: batchable, no C++-only modes, the tick schedule pinned, the
    effective seed stored."""
    check_batchable(cfg)
    _reject_cpp_only(cfg)
    cfg = _tick_schedule(cfg)
    if seed is not None:
        cfg = cfg.with_(seed=seed)
    return cfg


def run_dyn_checkpointed(cfg: SimConfig, every_ms: int, ckpt_dir, seed: int | None = None,
                         keep_all: bool = False, resume: bool = True, device=None):
    """The dynamic-fault-operand form of :func:`run_checkpointed`: init at the
    canonical fault structure, the masks installed from ``cfg.faults``'
    counts, segments stepped at the canonical config, and the ``(n_crashed,
    n_byzantine)`` operands stored in every archive (``__dyn__``).  With
    ``resume`` a directory that already holds archives of the SAME config
    continues from the newest; one of another config, or a static archive,
    raises.  Equal to the un-checkpointed dyn run.  Returns ``(metrics,
    last_checkpoint_path)``."""
    from blockchain_simulator_tpu_torch.utils.checkpoint import load_checkpoint, load_dyn_counts

    if every_ms < 1:
        raise ValueError(f"every_ms must be >= 1, got {every_ms}")
    cfg = _dyn_checkpoint_cfg(cfg, seed)
    make_segment_fn(cfg, every_ms)  # refuses the committee hierarchy before any init
    dev = resolve_device(device)
    canon = base_model.canonical_fault_cfg(cfg)
    nc = cfg.faults.resolved_n_crashed(cfg.n)
    nb = cfg.faults.n_byzantine
    proto = get_protocol(cfg.protocol)
    key = threefry.key(cfg.seed)
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    existing = sorted(ckpt_dir.glob("ckpt_*.npz")) if resume else []
    if existing:
        stored_cfg, state, bufs, t = load_checkpoint(existing[-1], device=dev)
        if stored_cfg != cfg:
            raise ValueError(
                f"checkpoint {existing[-1]} belongs to a different config "
                f"(stored hash != requested); refusing to blend runs"
            )
        stored_dyn = load_dyn_counts(existing[-1])
        if stored_dyn != (nc, nb):
            raise ValueError(
                f"checkpoint {existing[-1]} stores dyn operands "
                f"{stored_dyn}, requested ({nc}, {nb})"
            )
        last_path = existing[-1]
    else:
        state, bufs = proto.init(canon, threefry.fold_in(key, _INIT_FOLD), device=dev)
        state = base_model.apply_fault_masks(
            cfg, state, *base_model.dyn_fault_masks(cfg.n, nc, nb, dev))
        t, last_path = 0, None
    state, last_path = _segments(cfg, dyn_step_cfg(canon, nb), key, state, bufs, t,
                                 every_ms, ckpt_dir, keep_all, last_path, (nc, nb))
    return proto.metrics(cfg, state), last_path


def resume_dyn_simulation(ckpt_path, device=None):
    """Load a dynamic-fault checkpoint and run the remaining ticks at the
    canonical config; returns metrics equal to the uninterrupted dyn run.
    A static archive (no stored operands) raises: use
    :func:`resume_simulation`."""
    from blockchain_simulator_tpu_torch.utils.checkpoint import load_checkpoint, load_dyn_counts

    dyn = load_dyn_counts(ckpt_path)
    if dyn is None:
        raise ValueError(
            f"{ckpt_path} is a static-path checkpoint (no __dyn__ operands);"
            " use resume_simulation"
        )
    cfg, state, bufs, t = load_checkpoint(ckpt_path, device=device)
    canon = dyn_step_cfg(base_model.canonical_fault_cfg(cfg), dyn[1])
    return _finish(cfg, canon, state, bufs, t, threefry.key(cfg.seed))


def _finish(cfg, seg_cfg, state, bufs, t: int, key) -> dict:
    """The ticks from ``t`` to the end, then the metrics."""
    if t < cfg.ticks:
        state, bufs = make_segment_fn(seg_cfg, cfg.ticks - t)(key, state, bufs, t)
    return get_protocol(cfg.protocol).metrics(cfg, state)


def resume_simulation(ckpt_path, seed: int | None = None, device=None):
    """Load a checkpoint (written by either package) and run the remaining
    ticks; returns metrics.  ``seed`` must match the original run's (it
    defaults to the seed stored in the archive's config)."""
    from blockchain_simulator_tpu_torch.utils.checkpoint import load_checkpoint

    cfg, state, bufs, t = load_checkpoint(ckpt_path, device=device)
    return _finish(cfg, cfg, state, bufs, t, threefry.key(cfg.seed if seed is None else seed))
