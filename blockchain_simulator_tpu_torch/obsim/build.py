"""Probed twins of the dynamic-fault program factories (port of
``blockchain_simulator_tpu/obsim/build.py``).

``make_probed_dyn_sim_fn(cfg, pcfg)`` mirrors ``runner.make_dyn_sim_fn`` arm
for arm (the committee stack, the Raft heartbeat path with its taps through
the handoff, the round-blocked PBFT path, the general tick engine) and
returns ``sim(key, n_crashed, n_byzantine, device) -> (final_state,
probes)`` with the probe pytree of :mod:`obsim.schema`, tensors on
``device``.  Lane keys ``[B, 2]`` with ``[B]`` counts run lanes side by
side where the taps read lanes (:func:`taps_lane_axis`), and every probe
leaf then leads with the lane axis, as JAX's vmapped probes do.

The tick-engine arm is ``models/base.tick_loop(probe=)``: every tick is
``proto.step``, so on the card it launches the ring-push kernel
(``csrc/ring_push.cu``) one grouped launch a tick, as the disarmed run
does.  The round path and the heartbeat scan push nothing.

Registry discipline (utils/aotcache.py): the probed programs are their own
``consobs-*`` entries keyed ``(cfg, pcfg, ...)`` and the disarmed entries
are untouched.  The mesh twin (``probed_mesh_fn``) is the armed program of
one sweep row, arm for arm with parallel/sweep.mesh_dyn_batched_fn.
"""

from __future__ import annotations

import functools

import numpy as np

from blockchain_simulator_tpu_torch.models import base as base_model
from blockchain_simulator_tpu_torch.obsim import schema, taps
from blockchain_simulator_tpu_torch.runner import (
    _reject_cpp_only,
    check_batchable,
    dyn_step_cfg,
    use_round_schedule,
)
from blockchain_simulator_tpu_torch.utils import aotcache, threefry

_INIT_FOLD = 0x1217  # proto.init's key, as in the runner


def _operands(key, n_crashed, n_byzantine):
    """Host operands: ``(key, nc, nb)``, ints for one run or int64 arrays
    ``[B]`` with lane keys ``[B, 2]``."""
    key = np.asarray(key, np.int64)
    if key.ndim == 2:
        return key, np.asarray(n_crashed, np.int64), np.asarray(n_byzantine, np.int64)
    return key, int(n_crashed), int(n_byzantine)


def hb_reduce(cfg, pcfg: schema.ProbeConfig):
    """The Raft heartbeat path's ``reduce_fn`` (models/raft_hb.scan_from_init
    ``probe=``): both branches reduce to one shape, the window count clamped
    to the SHORTER branch's sample count (prefix ticks + heartbeats against
    the full ticks), with the liveness lag when monitors are armed."""
    from blockchain_simulator_tpu_torch.models import raft_hb

    m_fast = raft_hb.prefix_ticks(cfg) + raft_hb.n_hb_steps(cfg)
    w_eff = max(1, min(pcfg.windows, m_fast, cfg.ticks))

    def reduce_fn(series):
        m = next(iter(series.values())).shape[-1]
        red = {"series": taps.window(series, m, w_eff)}
        if pcfg.monitors:
            red["liveness_lag"] = taps.liveness_lag(series[schema.PROGRESS_FIELD["raft"]])
        return red

    return reduce_fn


def hb_probes(cfg, pcfg: schema.ProbeConfig, final, red) -> dict:
    """The heartbeat path's probe pytree from its final state and reduced
    series."""
    probes = {"series": red["series"]}
    if pcfg.monitors:
        mon = taps.monitors(cfg, final)
        mon["liveness_lag"] = red["liveness_lag"]
        probes["monitors"] = mon
    return probes


def make_probed_dyn_sim_fn(cfg, pcfg: schema.ProbeConfig):
    """``sim(key, n_crashed, n_byzantine, device) -> (final_state, probes)``:
    ``runner.make_dyn_sim_fn`` with the taps armed.  The state trajectory is
    the disarmed program's (taps read state and draw nothing), so the
    metrics are equal, bit for bit."""
    cfg = base_model.canonical_fault_cfg(cfg)
    check_batchable(cfg)
    _reject_cpp_only(cfg)
    schema.series_fields(cfg.protocol)  # typed refusal before any run
    n = cfg.n

    if cfg.topology == "committee":
        from blockchain_simulator_tpu_torch.topo import committee

        use_round_schedule(cfg)  # validates schedule='round' (always tick)

        def finalize_fn(icfg, final, ys):
            return taps.finalize(icfg, pcfg, final, taps.time_last(ys), icfg.ticks)

        def sim_comm(key, n_crashed, n_byzantine, device):
            return committee.run_stacked(cfg, np.asarray(key, np.int64), int(n_crashed),
                                         int(n_byzantine), probe=(taps.sample, finalize_fn),
                                         device=device)

        return sim_comm

    def init(proto_init, key, nc, nb, device):
        """``proto_init`` at the canonical config with the run-time fault
        masks installed (runner._dyn_run's init)."""
        state, bufs = proto_init(cfg, threefry.fold_in(key, _INIT_FOLD), device=device)
        masks = base_model.dyn_fault_masks(n, nc, nb, device)
        return base_model.apply_fault_masks(cfg, state, *masks), bufs

    if use_round_schedule(cfg):
        if cfg.protocol == "raft":
            from blockchain_simulator_tpu_torch.models import raft as raft_tick
            from blockchain_simulator_tpu_torch.models import raft_hb

            probe = (functools.partial(taps.sample, cfg), taps.raft_steady_sample,
                     hb_reduce(cfg, pcfg))

            def sim_hb(key, n_crashed, n_byzantine, device):
                key, nc, nb = _operands(key, n_crashed, n_byzantine)
                state, bufs = init(raft_tick.init, key, nc, nb, device)
                final, red = raft_hb.scan_from_init(dyn_step_cfg(cfg, nb), state, bufs, key,
                                                    probe=probe)
                return final, hb_probes(cfg, pcfg, final, red)

            return sim_hb

        from blockchain_simulator_tpu_torch.models import pbft_round

        bt = cfg.pbft_block_interval_ms
        r_last = (cfg.ticks - 1) // bt
        if r_last < 1:
            raise ValueError(
                "cannot arm probes on a round-schedule run with zero "
                f"block rounds (ticks={cfg.ticks} <= interval={bt})"
            )

        def sim_round(key, n_crashed, n_byzantine, device):
            key, nc, nb = _operands(key, n_crashed, n_byzantine)
            state, _ = init(pbft_round.init, key, nc, nb, device)
            final, ys = pbft_round.scan_rounds(dyn_step_cfg(cfg, nb), state, key,
                                               with_probe=functools.partial(taps.sample, cfg))
            return final, taps.finalize(cfg, pcfg, final, taps.time_last(ys), r_last)

        return sim_round

    proto = base_model.get_protocol(cfg.protocol)

    def sim(key, n_crashed, n_byzantine, device):
        key, nc, nb = _operands(key, n_crashed, n_byzantine)
        state, bufs = init(proto.init, key, nc, nb, device)
        state, _, ys = base_model.tick_loop(dyn_step_cfg(cfg, nb), state, bufs, key, 0,
                                            cfg.ticks, probe=functools.partial(taps.sample, cfg))
        return state, taps.finalize(cfg, pcfg, state, taps.time_last(ys), cfg.ticks)

    return sim


# ------------------------------------------------------- registry entries ---


@aotcache.cached_factory("consobs-solo")
def probed_solo_fn(cfg, pcfg: schema.ProbeConfig):
    """One probed solo program per (fault structure, probe config): the
    armed twin of serve/dispatch._solo_fn (``runner.make_dyn_sim_fn``)."""
    return make_probed_dyn_sim_fn(cfg, pcfg)


def taps_lane_axis(cfg) -> bool:
    """Do the taps of a probed batch read lanes side by side?  The round and
    heartbeat paths, and the Raft tick engine on the full mesh without
    queued links; every other tick engine's probed batch runs its lanes in
    turn (its taps read one run)."""
    if cfg.protocol not in ("pbft", "raft"):
        return False
    if use_round_schedule(cfg):
        return True
    return cfg.protocol == "raft" and cfg.topology == "full" and not cfg.queued_links


@aotcache.cached_factory("consobs-batched")
def probed_batched_fn(cfg, pcfg: schema.ProbeConfig, multi_seed: bool = False):
    """``batched(keys [B, 2], n_crashed [B], n_byzantine [B], device) ->
    (finals [B, ...], probes)``: the armed twin of sweep.dyn_batched_fn,
    and with ``multi_seed=True`` (which also keys the entry, as JAX's does)
    of the solo-semantics multi-seed program.  Lanes side by side where the
    taps read lanes (:func:`taps_lane_axis`), else in turn, which is JAX's
    vmapped rows only where those are the solo ones (the refusal below);
    probe leaves gain the leading lane axis."""
    from blockchain_simulator_tpu_torch.parallel import sweep

    sim = make_probed_dyn_sim_fn(cfg, pcfg)
    canon = base_model.canonical_fault_cfg(cfg)

    def batched(keys, n_crashed, n_byzantine, device):
        keys = np.asarray(keys, np.int64)
        nc = np.asarray(n_crashed, np.int64)
        nb = np.asarray(n_byzantine, np.int64)
        if not multi_seed and taps_lane_axis(canon):
            return sim(keys, nc, nb, device)
        if not multi_seed and len(keys) > 1 and sweep.vmapped_rule(canon) == "first-lane":
            sweep._refuse(
                f"a probed batch of {len(keys)} lanes of the {canon.protocol} tick engine "
                f"(topology {canon.topology}) drawing on Philox words (JAX's vmapped rows "
                "take those from the first lane's key; these taps read one run)",
                sweep._ALONE + ", or multi_seed=True")
        outs = [sim(k, c, b, device) for k, c, b in zip(keys, nc, nb)]
        return (base_model.stack_lanes([o[0] for o in outs]),
                base_model.stack_samples([o[1] for o in outs]))

    return batched


@aotcache.cached_factory("consobs-mesh")
def probed_mesh_fn(cfg, pcfg: schema.ProbeConfig, mesh):
    """The armed twin of parallel/sweep.mesh_dyn_batched_fn, arm for arm
    (parallel/sweep.mesh_lanes_fn with ``pcfg``): ``batched(keys [L, 2],
    n_crashed [L], n_byzantine [L], device) -> (finals [L, ...], probes)``
    for one sweep row's lanes; on the nodes axis the taps read the state
    gathered over the row, so the probes are the single-device run's."""
    from blockchain_simulator_tpu_torch.parallel import sweep

    return sweep.mesh_lanes_fn(cfg, mesh, pcfg)
