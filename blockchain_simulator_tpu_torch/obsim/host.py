"""The host boundary of obsim: run probed programs, summarize lanes, trip
the flight recorder on monitor violations (port of
``blockchain_simulator_tpu/obsim/host.py``).

The only obsim module that imports ``utils/telemetry``: everything it does
happens after the probed run, on host copies of the probe tensors, so the
taps themselves (obsim/taps.py) stay free of host reads.
"""

from __future__ import annotations

from blockchain_simulator_tpu_torch.models import base as base_model
from blockchain_simulator_tpu_torch.models.base import sim_metrics
from blockchain_simulator_tpu_torch.obsim import build, schema
from blockchain_simulator_tpu_torch.utils import telemetry, threefry
from blockchain_simulator_tpu_torch.utils.sync import force_sync


def tree_to_host(probes) -> dict:
    """A probe pytree (nested dicts of tensors) as host numpy arrays: one
    copy a leaf."""
    return {k: tree_to_host(v) if isinstance(v, dict) else schema.to_host(v)
            for k, v in probes.items()}


def summarize_lane(cfg, pcfg: schema.ProbeConfig, probes, lane: int) -> dict:
    """Summarize ONE lane of a batched probe pytree (a leading lane axis):
    slice, then schema.summarize."""
    def pick(tree):
        return {k: pick(v) if isinstance(v, dict) else schema.to_host(v)[lane]
                for k, v in tree.items()}

    return schema.summarize(cfg, pcfg, pick(probes))


def note_violations(summary: dict, cfg, seed: int) -> str | None:
    """The violation -> post-mortem hook: when a probe summary carries
    nonzero safety-monitor counters, record the event on the flight ring and
    dump a ``consensus-violation`` post-mortem (armed by
    ``$BLOCKSIM_FLIGHT_DIR``; utils/telemetry.FlightRecorder).  Returns the
    dump path (None when clean or disarmed).  Liveness lag is a gauge, not a
    violation: it never trips this hook."""
    if not summary.get("violations"):
        return None
    from blockchain_simulator_tpu_torch.utils import obs

    telemetry.flight.note(
        "consensus-violation",
        protocol=summary.get("protocol"),
        topology=summary.get("topology"),
        seed=int(seed),
        config=obs.config_hash(cfg),
        monitors=summary.get("monitors"),
    )
    telemetry.metrics.counter("obsim_violations_total").inc(summary["violations"])
    return telemetry.flight.dump("consensus-violation")


def run_probed(cfg, seed: int = 0, pcfg: schema.ProbeConfig | None = None,
               n_crashed: int | None = None, n_byzantine: int | None = None,
               device=None) -> tuple[dict, dict]:
    """Solo probed run on ``device`` (the CUDA card when None):
    ``(metrics, probe_summary)`` for one (cfg, seed).  The armed program is
    the ``consobs-solo`` registry entry; the fault counts default to the
    config's own.  The metrics equal the disarmed run's, bit for bit."""
    from blockchain_simulator_tpu_torch.runner import resolve_device

    pcfg = pcfg or schema.ProbeConfig()
    dev = resolve_device(device)
    canon = base_model.canonical_fault_cfg(cfg)
    fc = cfg.faults
    ops = (fc.resolved_n_crashed(cfg.n) if n_crashed is None else n_crashed,
           fc.n_byzantine if n_byzantine is None else n_byzantine)
    sim = build.probed_solo_fn(canon, pcfg)
    final, probes = force_sync(sim(threefry.key(int(seed)), *map(int, ops), dev))
    m = sim_metrics(cfg, final)
    summary = schema.summarize(canon, pcfg, tree_to_host(probes))
    note_violations(summary, cfg, seed)
    return m, summary
