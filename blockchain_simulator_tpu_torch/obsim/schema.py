"""The probe schema: what a probed program returns and what it means (a
copy of ``blockchain_simulator_tpu/obsim/schema.py``, which imports no JAX;
``sample_axis`` reads the port's runner and committee modules).

A probed program returns ``(final_state, probes)`` where ``probes`` is a
plain dict pytree:

- ``probes["series"]`` — per-protocol windowed counter series, one
  ``[W]`` int32 array per field (``[C, W]`` stacked on the committee
  path, a leading batch axis on the sweep paths).  Window ``j`` holds the
  counter's value at the last sample of window ``j`` — cumulative
  counters sampled at ``W`` evenly spaced boundaries over the run, so
  adjacent-window differences are per-window event volumes.
- ``probes["monitors"]`` — on-device invariant monitors evaluated on the
  FINAL state (int32 scalars; ``[C]`` per committee): ``viol_agreement``
  (safety: conflicting/forged/unattributed commits among correct nodes),
  ``viol_quorum`` (quorum-certificate consistency), and ``liveness_lag``
  (samples since the protocol's progress counter last advanced; the
  sample axis is ticks on the tick engines, rounds/heartbeats on the
  fast paths — ``summarize`` records the unit).

The probe structure is a function of ``(cfg, ProbeConfig)`` only — both
are frozen/hashable and ride the registry key (``consobs-*`` entries,
obsim/build.py), so there is one probed program per (fault structure,
probe config), and the disarmed programs are untouched.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Monitor fields every protocol emits.
MONITOR_FIELDS = ("viol_agreement", "viol_quorum", "liveness_lag")

# Per-protocol windowed-series fields (obsim/taps.sample emits exactly
# these, in this order).  "msgs_*" are message-volume counters, "phase_*"
# / "slots_*" phase-occupancy and quorum-progress counts, the rest event
# counters; the protocol's PROGRESS field feeds the liveness monitor.
SERIES_FIELDS = {
    "pbft": (
        "msgs_rounds",      # blocks broadcast as leader (send volume)
        "commits",          # slot finalization events, summed over slots
        "blocks",           # max chain height across nodes
        "views",            # max view number across nodes
        "view_changes",     # view changes initiated, summed
        "slots_any",        # slots with >= 1 finalizer
        "slots_quorum",     # slots with >= 2n/3+1 finalizers
    ),
    "raft": (
        "msgs_rounds",      # proposal rounds broadcast (leader send volume)
        "blocks",           # max blocks committed across nodes
        "elections",        # sendVote firings, summed
        "leaders",          # alive leaders right now (occupancy)
    ),
    "paxos": (
        "msgs_tickets",     # tickets requested, summed (retry volume)
        "executes",         # acceptors that executed (latched)
        "committed",        # proposers with CLIENT COMMIT SUCCESS
        "phase_ticket",     # proposers in the ticket phase
        "phase_propose",    # proposers in the propose phase
        "phase_commit",     # proposers in the commit phase
    ),
}

# The monotone progress counter driving liveness_lag, per protocol.
PROGRESS_FIELD = {"pbft": "commits", "raft": "blocks", "paxos": "executes"}


@dataclasses.dataclass(frozen=True)
class ProbeConfig:
    """The probe configuration — frozen and hashable so it can ride an
    executable-registry key next to SimConfig (utils/aotcache.py).

    ``windows``: number of evenly spaced sample boundaries the series are
    reduced to (clipped to the run's sample count).  ``monitors``: emit
    the invariant monitors alongside the series.
    """

    windows: int = 16
    monitors: bool = True

    def __post_init__(self):
        if self.windows < 1:
            raise ValueError(f"ProbeConfig.windows must be >= 1: {self.windows}")


def series_fields(protocol: str):
    """The windowed-series field names for a protocol (KeyError = the
    protocol has no probe schema; mixed is refused by the dyn path
    already, runner.check_batchable)."""
    if protocol not in SERIES_FIELDS:
        raise KeyError(
            f"no probe schema for protocol {protocol!r} "
            f"(have {sorted(SERIES_FIELDS)})"
        )
    return SERIES_FIELDS[protocol]


def window_bounds(n_samples: int, windows: int) -> np.ndarray:
    """Static sample indices of the window boundaries: ``W`` evenly spaced
    last-sample-of-window positions over ``n_samples`` samples, the last
    always ``n_samples - 1``.  Pure numpy on the host, from static counts:
    the index the device gather takes is never read back from the device."""
    n_samples = int(n_samples)
    if n_samples < 1:
        raise ValueError(f"window_bounds needs >= 1 sample: {n_samples}")
    w = max(1, min(int(windows), n_samples))
    return (np.arange(1, w + 1) * n_samples) // w - 1


def sample_axis(cfg) -> tuple:
    """``(unit, n_samples)`` of the probe sample axis for a config: what
    one sample index means, before windowing — ticks on the tick engines,
    block rounds / election-prefix-ticks-then-heartbeats on the fast
    paths.  Mirrors runner.make_dyn_sim_fn's arm dispatch."""
    from blockchain_simulator_tpu_torch.runner import use_round_schedule

    if cfg.topology == "committee":
        from blockchain_simulator_tpu_torch.topo import committee

        return ("tick", committee.inner_cfg(cfg).ticks)
    if use_round_schedule(cfg):
        if cfg.protocol == "raft":
            return ("mixed-tick-heartbeat", -1)  # phase split: length varies
        bt = cfg.pbft_block_interval_ms
        return ("round", max((cfg.ticks - 1) // bt, 0))
    return ("tick", cfg.ticks)


def to_host(v) -> np.ndarray:
    """A probe leaf as a host array (a torch tensor on any device, or an
    array already on the host)."""
    return np.asarray(v.cpu() if hasattr(v, "cpu") else v)


def summarize(cfg, pcfg: ProbeConfig, probes) -> dict:
    """Host-side JSON-able summary of one probed run's probe pytree
    (device tensors in, plain ints/lists out).  Committee probes ([C, W]
    series, [C] monitors) summarize per committee and aggregate the
    monitors; 3-D (batched-committee) leaves are summarized per leading
    lane by the sweep layer before reaching here."""
    unit, _ = sample_axis(cfg)
    series = {k: to_host(v) for k, v in probes["series"].items()}
    any_leaf = next(iter(series.values()))
    out = {
        "protocol": cfg.protocol,
        "topology": cfg.topology,
        "windows": int(any_leaf.shape[-1]),
        "sample_unit": unit,
        "fields": sorted(series),
        "final": {
            k: v[..., -1].tolist() if v.ndim > 1 else int(v[-1])
            for k, v in series.items()
        },
    }
    mon = probes.get("monitors")
    if mon is not None:
        mon = {k: to_host(v) for k, v in mon.items()}
        out["monitors"] = {
            k: v.tolist() if v.ndim else int(v) for k, v in mon.items()
        }
        out["violations"] = int(
            sum(int(np.sum(mon[k])) for k in ("viol_agreement", "viol_quorum"))
        )
    return out
