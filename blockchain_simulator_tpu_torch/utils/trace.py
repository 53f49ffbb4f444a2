"""Tracing and observability (port of ``blockchain_simulator_tpu/utils/trace.py``).

Observability as data, at three levels, as in the JAX package:

- **Probe time series**: :func:`run_traced` runs the SAME simulator
  ``runner.run_simulation`` would (it dispatches through
  ``runner.use_round_schedule`` and ``runner._reject_cpp_only``, so an
  ineligible explicit ``schedule='round'`` raises the same ``ValueError``)
  and records :func:`probe` after every step:

  - tick engine (full mesh, gossip, kregular): one sample per 1 ms tick;
  - round-blocked PBFT (models/pbft_round): one sample per block round;
  - heartbeat Raft (models/raft_hb): one sample per heartbeat after the
    election prefix (per tick over the whole window when the checked
    handoff fell back to the tick engine);
  - heartbeat-scheduled mixed (models/mixed): per-heartbeat shard
    aggregates and the global PBFT layer sampled at the same ticks;
  - committee hierarchy: per-tick series stacked ``[C, ticks]``.

  Fast-path series carry a ``"t"`` array mapping sample index to virtual
  tick.  Series hold the JAX package's dtypes (its x32 int32 reductions;
  the ``"t"`` arrays and the mixed shard aggregates are numpy int64 in
  both).  The samples stay on the device until the run ends: one stack a
  name, then one copy to the host.
- **Event export**: :func:`events_from_series` reconstructs per-event ticks
  from monotone counters; :func:`to_chrome_trace` converts a series dict into
  a Chrome-trace / Perfetto JSON timeline (numpy only, a copy of JAX's).
- **Profiler capture**: :func:`profile_run` wraps the second (warm) run in
  ``torch.profiler`` and exports its Chrome trace, the card's kernels on
  their own timeline.

The tick arm's program is built once a config in the executable registry
(utils/aotcache.py, ``"trace-tick"``, as in the JAX package); the fast-path
arms are plain functions over the step functions.
"""

from __future__ import annotations

import functools
import json
import os
import time

import numpy as np
import torch

from blockchain_simulator_tpu_torch.models import base as base_model
from blockchain_simulator_tpu_torch.models.base import get_protocol, tick_loop
from blockchain_simulator_tpu_torch.utils import aotcache, threefry
from blockchain_simulator_tpu_torch.utils.config import SimConfig
from blockchain_simulator_tpu_torch.utils.sync import force_sync

_I32 = torch.int32
_INIT_FOLD = 0x1217  # proto.init's key, as in the runner


def probe(cfg: SimConfig, state) -> dict:
    """Per-step scalar probes for a protocol state (device-side 0-d int32
    tensors, as JAX's x32 reductions give).  Reads only the field names a
    protocol's tick state shares with its fast-path state, so one probe
    serves both engines."""
    p = cfg.protocol
    if p == "pbft":
        return {
            "blocks_committed_max": state.block_num.max(),
            "commit_events_total": state.slot_commits.sum(dtype=_I32),
            "view_max": state.v.max(),
            "rounds_sent": state.next_n.max(),
        }
    if p == "raft":
        return {
            "n_leaders": (state.is_leader & state.alive).sum(dtype=_I32),
            "blocks": state.block_num.max(),
            "elections": state.elections.sum(dtype=_I32),
        }
    if p == "paxos":
        return {
            "executes": state.is_commit.sum(dtype=_I32),
            "max_ticket": state.ticket.max(),
            "committed_proposers": (state.commit_tick >= 0).sum(dtype=_I32),
        }
    if p == "mixed":
        return {
            "shards_with_leader": (state.raft.is_leader & state.raft.alive)
            .any(dim=1).sum(dtype=_I32),
            "raft_blocks_total": state.raft.block_num.amax(dim=1).sum(dtype=_I32),
            "global_blocks": state.pbft.block_num.max(),
        }
    raise NotImplementedError(p)


def _np_series(ys: dict) -> dict:
    """Device series to numpy: one copy a name, after the run."""
    return {k: v.cpu().numpy() for k, v in ys.items()}


def _cat(pre: dict, post: dict) -> dict:
    return {k: np.concatenate([pre[k], post[k]]) for k in pre}


@aotcache.cached_factory("trace-tick")
def _tick_traced_fn(cfg: SimConfig):
    """``sim(key, dev) -> (final state, series)``: the general tick engine
    with the probe after every tick (the kregular overlay builds its tables
    inside the step, as untraced)."""
    proto = get_protocol(cfg.protocol)
    probe_fn = functools.partial(probe, cfg)

    def sim(key, dev):
        state, bufs = proto.init(cfg, threefry.fold_in(key, _INIT_FOLD), device=dev)
        state, _, ys = tick_loop(cfg, state, bufs, key, 0, cfg.ticks, probe=probe_fn)
        return state, _np_series(ys)

    return sim


def _traced_tick(cfg: SimConfig, key, dev):
    return _tick_traced_fn(cfg)(key, dev)


def _traced_pbft_round(cfg: SimConfig, key, dev):
    """Round-blocked PBFT with one sample per round: the scan is
    runner.make_sim_fn's (same init, same keys; probes only read), so the
    metrics are ``run_simulation``'s."""
    from blockchain_simulator_tpu_torch.models import pbft_round

    state, _ = pbft_round.init(cfg, threefry.fold_in(key, _INIT_FOLD), device=dev)
    state, ys = pbft_round.scan_rounds(cfg, state, key, with_probe=True)
    series = _np_series(ys)
    bt = cfg.pbft_block_interval_ms
    # sample i is the state after round r = i + 1 (block tick r * interval)
    series["t"] = (1 + np.arange(len(next(iter(series.values()))))) * bt
    return state, series


def _traced_raft_hb(cfg: SimConfig, key, dev):
    """Heartbeat-blocked Raft, probed: the election prefix on the tick engine
    (per-tick samples), the checked handoff read on the host once, then
    EITHER the heartbeat scan (per-heartbeat series) OR the tick engine
    continued from the prefix carry (per-tick series over the whole window:
    the prefix's samples and the continuation's), the two branches of
    raft_hb.scan_from_init with the same keys."""
    from blockchain_simulator_tpu_torch.models import raft, raft_hb

    t_e = raft_hb.prefix_ticks(cfg)
    tap = functools.partial(probe, cfg)
    state, bufs = raft.init(cfg, threefry.fold_in(key, _INIT_FOLD), device=dev)
    state, bufs, pre_ys = tick_loop(cfg, state, bufs, key, 0, t_e, probe=tap)
    view = raft_hb._shard_view(state)
    ok, h = raft_hb.handoff(cfg, view)  # the run's one host read
    if ok[0]:
        out, ys = raft_hb.steady_scan(cfg, np.asarray(key, np.int64)[None], h,
                                      with_probe=True)
        final = raft_hb._unshard(raft_hb.materialize(cfg, view, h, out))
        series = {k: v[0].cpu().numpy() for k, v in ys.items()}
        series["t"] = int(h.hb0[0]) + np.arange(raft_hb.n_hb_steps(cfg)) * cfg.raft_heartbeat_ms
        return final, series
    final, _, post_ys = tick_loop(cfg, state, bufs, key, t_e, max(cfg.ticks, t_e), probe=tap)
    return final, _cat(_np_series(pre_ys), _np_series(post_ys))


def _traced_mixed_fast(cfg: SimConfig, key, dev):
    """Heartbeat-scheduled mixed sim, probed: per-heartbeat SHARD AGGREGATES
    (total / min Raft blocks over shards, shards stopped) plus the global
    PBFT layer sampled at the same ticks; per-tick mixed series over the
    whole window when any shard's handoff fell back to the tick engine (the
    prefix then re-runs with probes, as JAX's fallback does)."""
    from blockchain_simulator_tpu_torch.models import mixed, raft_hb

    rcfg, _ = mixed.sub_configs(cfg)
    t_e = raft_hb.prefix_ticks(rcfg)
    init_key = threefry.fold_in(key, _INIT_FOLD)
    state, bufs = mixed.init(cfg, init_key, device=dev)
    carry, ok_all, h_s = mixed.prefix_handoff(cfg, state, bufs, key)

    if ok_all:
        state, (raft_ys, pbft_ys) = mixed.fast_finish(cfg, carry, h_s, key, with_probe=True)
        hb = rcfg.raft_heartbeat_ms
        k_steps = raft_hb.n_hb_steps(rcfg)
        # shards' heartbeat clocks differ by their election offsets; the
        # aggregate series is indexed by STEP, timestamped at the latest
        # shard's k-th heartbeat (JAX's documented approximation)
        t_hb = int(np.asarray(h_s.hb0).max()) + np.arange(k_steps) * hb
        blocks = raft_ys["blocks"].cpu().numpy()    # [S, K]
        stopped = raft_ys["stopped"].cpu().numpy()  # [S, K]
        g_blocks = pbft_ys["global_blocks"].cpu().numpy()  # [ticks - t_e]
        g_commits = pbft_ys["global_commit_events"].cpu().numpy()
        # sample the per-tick global layer at the heartbeat ticks
        gi = np.clip(t_hb - t_e, 0, max(len(g_blocks) - 1, 0))
        series = {
            "t": t_hb,
            "raft_blocks_total": blocks.sum(axis=0),
            "raft_blocks_min": blocks.min(axis=0),
            "shards_stopped": stopped.sum(axis=0),
            "global_blocks": g_blocks[gi] if len(g_blocks) else np.zeros(
                (k_steps,), np.int32),
            "global_commit_events": g_commits[gi] if len(g_commits)
            else np.zeros((k_steps,), np.int32),
        }
        return state, series

    tap = functools.partial(probe, cfg)
    state, bufs = mixed.init(cfg, init_key, device=dev)
    state, bufs, pre_ys = tick_loop(cfg, state, bufs, key, 0, t_e, probe=tap)
    state, _, post_ys = tick_loop(cfg, state, bufs, key, t_e, max(cfg.ticks, t_e), probe=tap)
    return state, _cat(_np_series(pre_ys), _np_series(post_ys))


def _full_series(icfg, final, ys):
    """The committee arm's finalize_fn: the full per-tick series."""
    del icfg, final
    return ys


def _traced_committee(cfg: SimConfig, key, dev):
    """Committee hierarchy with stacked per-committee series: leaves ``[C,
    ticks]`` (row c is committee c) and ``"t"`` the inner tick axis.  The
    static arm of runner.make_sim_fn (the config's own fault counts through
    the dyn body), so the metrics are ``run_simulation``'s."""
    from blockchain_simulator_tpu_torch.topo import committee

    canon = base_model.canonical_fault_cfg(cfg)
    finals, ys = committee.run_stacked(
        canon, key, cfg.faults.resolved_n_crashed(cfg.n), cfg.faults.n_byzantine,
        probe=(probe, _full_series), device=dev)
    series = _np_series(ys)
    series["t"] = np.arange(committee.inner_cfg(cfg).ticks)
    return finals, series


def _reject_stacked(cfg: SimConfig) -> None:
    # profile_run only: the capture wraps the flat static run; probe
    # tracing handles committee through _traced_committee
    if cfg.topology == "committee":
        raise NotImplementedError(
            "profile_run wraps the flat (state, bufs) engine; profile the "
            "inner committee config instead (probe tracing — run_traced — "
            "does support committee, with stacked [C, ticks] series)"
        )


def traced_state(cfg: SimConfig, seed: int | None = None, device=None):
    """:func:`run_traced`'s run, returning ``(final state, series)``: the
    final state is the unprobed run's (``runner.final_state``), since the
    probes only read."""
    from blockchain_simulator_tpu_torch.runner import (
        _reject_cpp_only,
        resolve_device,
        use_round_schedule,
    )

    _reject_cpp_only(cfg)
    dev = resolve_device(device)
    key = threefry.key(cfg.seed if seed is None else seed)
    if cfg.topology == "committee":
        use_round_schedule(cfg)  # validates schedule='round' (always tick)
        return _traced_committee(cfg, key, dev)
    if use_round_schedule(cfg):  # raises on ineligible explicit 'round'
        if cfg.protocol == "pbft":
            return _traced_pbft_round(cfg, key, dev)
        if cfg.protocol == "raft":
            return _traced_raft_hb(cfg, key, dev)
        return _traced_mixed_fast(cfg, key, dev)
    return _traced_tick(cfg, key, dev)


def run_traced(cfg: SimConfig, seed: int | None = None, device=None):
    """Run one simulation recording a probe series.

    Returns ``(metrics, series)``, ``series`` mapping probe names to numpy
    arrays.  Dispatches through ``runner.use_round_schedule`` exactly like
    ``run_simulation`` (and refuses the C++-only flags the same way), so the
    traced simulator is always the one the untraced run would use, and the
    metrics are its metrics:

    - tick engine: per-tick samples, length ``cfg.ticks`` (no ``"t"``; the
      sample index is the tick).  ``cfg.with_(schedule="tick")`` forces this
      arm on any config.  The kregular overlay rides it too.
    - fast paths: per-round / per-heartbeat samples with a ``"t"`` array of
      virtual ticks (the module docstring lists each protocol's keys).
    - committee hierarchy: stacked ``[C, ticks]`` series plus the inner
      ``"t"`` tick axis.

    Runs on the CUDA card unless ``device`` names another (``"cpu"``)."""
    final, series = traced_state(cfg, seed, device)
    return base_model.sim_metrics(cfg, final), series


def events_from_series(series: dict, name: str) -> np.ndarray:
    """Sample indices at which a monotone counter series increments — the
    reconstruction of the reference's per-event log timestamps from the
    recorded series.  For per-tick series the index is the tick; fast-path
    series map indices to ticks via ``series["t"]``."""
    s = np.asarray(series[name])
    prev = np.concatenate([[0], s[:-1]])
    return np.flatnonzero(s > prev)


# to_chrome_trace caps each counter track's sample count so long windows
# stay loadable in the Perfetto UI; instant events are never dropped.
MAX_COUNTER_SAMPLES = 2000


def chrome_events(series: dict, name: str = "sim", pid: int = 0) -> list[dict]:
    """The Chrome-trace event list of one probe series dict (the body of
    :func:`to_chrome_trace`); ``pid`` namespaces the process row."""
    ts_map = np.asarray(series["t"]) if "t" in series else None
    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": name}},
    ]
    tid = 0

    def emit(label: str, v: np.ndarray) -> None:
        nonlocal tid
        t_axis = (
            ts_map
            if ts_map is not None and len(ts_map) == len(v)
            else np.arange(len(v))
        )
        tid += 1
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": label},
        })
        stride = max(1, len(v) // MAX_COUNTER_SAMPLES)
        for i in range(0, len(v), stride):
            events.append({
                "name": label, "ph": "C", "pid": pid, "tid": 0,
                "ts": int(t_axis[i]) * 1000,
                "args": {label: float(v[i])},
            })
        d = np.diff(v.astype(np.int64), prepend=0)
        if np.all(d >= 0):  # monotone counter: increments are events
            for i in np.flatnonzero(d > 0):
                events.append({
                    "name": label, "ph": "i", "s": "t", "pid": pid,
                    "tid": tid, "ts": int(t_axis[i]) * 1000,
                    "args": {"value": int(v[i]), "delta": int(d[i])},
                })

    for k in sorted(series):
        if k == "t":
            continue
        v = np.asarray(series[k])
        if v.size == 0 or v.ndim not in (1, 2):
            continue
        if v.ndim == 1:
            emit(k, v)
        else:
            # stacked committee series [C, m]: one counter track and
            # per-committee instant events a lane
            for ci in range(v.shape[0]):
                emit(f"{k}/c{ci}", v[ci])
    return events


def to_chrome_trace(series: dict, path, name: str = "sim") -> dict:
    """Convert a probe series dict to a Chrome-trace JSON timeline (for
    ui.perfetto.dev / chrome://tracing): one process named ``name``; every
    1-D series a counter track (downsampled to <= MAX_COUNTER_SAMPLES
    points), and every monotone series one instant event per increment.  1
    tick (= 1 simulated ms) maps to 1000 trace-µs.  Returns ``{"events",
    "instants", "path"}``."""
    events = chrome_events(series, name=name, pid=0)
    n_instant = sum(1 for e in events if e.get("ph") == "i")
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(doc, f)
    return {"events": len(events), "instants": n_instant, "path": str(path)}


PROFILE_TRACE = "trace.json"  # the exported Chrome trace, inside logdir


def profile_run(cfg: SimConfig, logdir: str, seed: int | None = None, device=None) -> dict:
    """Capture a profiler trace of one warm run into ``logdir``.

    The first run pays the kernel build and the warm-up outside the
    capture; the second runs under ``torch.profiler`` (CPU activity, and
    the card's when the run is on CUDA), whose Chrome trace is written to
    ``logdir/trace.json`` (ui.perfetto.dev).  The trace is exported as it
    is: building the profiler's per-op tables (``key_averages``) would cost
    about ten times the run at a thousand launches a tick.  Returns the run
    metrics with ``compile_plus_first_run_s`` and ``profiled_run_s``."""
    from blockchain_simulator_tpu_torch.runner import make_sim_fn, resolve_device

    _reject_stacked(cfg)
    dev = resolve_device(device)
    proto = get_protocol(cfg.protocol)
    sim = make_sim_fn(cfg)
    s = cfg.seed if seed is None else seed
    t0 = time.perf_counter()
    force_sync(sim(s, dev))  # build + warm-up outside the capture
    compile_s = time.perf_counter() - t0
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        final = force_sync(sim(s, dev))
        run_s = time.perf_counter() - t0
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, PROFILE_TRACE))
    m = proto.metrics(cfg, final)
    m["compile_plus_first_run_s"] = compile_s
    m["profiled_run_s"] = run_s
    return m
