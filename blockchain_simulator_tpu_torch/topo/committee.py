"""Two-level committee consensus, ``topology="committee"`` (port of
``blockchain_simulator_tpu/topo/committee.py``).

N nodes split into ``cfg.committees`` equal committees of m = N/C nodes.
The flat protocol runs to quorum inside each committee (node c·m is that
committee's node 0: the PBFT initial leader, the first Paxos proposer), and
an outer aggregate over the committee representatives declares the
hierarchy's outcome once a majority of committees reports its inner
milestone.

Execution: the JAX package maps the unvmapped inner tick engine over the
stacked committee axis (``lax.map``), each committee on its own key
(``fold_in(key, c)``; at C = 1 the key as it is).  Its draws are therefore
a solo run's, committee by committee.  The port steps the C committees
**side by side**, as C lanes of the inner tick engine (models/base.py):
one step a tick for all committees, so on the card one grouped ring-push
launch a tick, with every Philox draw on its own committee's key
(``ops/delay.lane_rule(1)``, the solo rule).  The finals come out stacked
``[C, ...]``, as ``lax.map`` stacks them.  A sweep batch of B committee
runs (JAX's ``vmap`` of the ``lax.map``) is ``B·C`` lanes laid out ``[B,
C]``: each committee's draws follow the first point's key across the
batch (``lane_rule(B)``), and the finals are ``[B, C, ...]``.

Faults keep the repo's global last-ids rule: ``dyn_fault_masks`` over the
full id space, reshaped ``[C, m]``, so fault counts land in the tail
committees.  Each inner run steps at ``runner.dyn_step_cfg`` of the inner
config: a committee run whose lanes hold Byzantine nodes steps at a
positive count (the Raft step leaves out the FAILED-ack channel when the
config has none).

One-committee contract: at C = 1 the committee key is the flat run's key
and the body is the flat dyn run, so the metrics contain the flat
protocol's bit for bit, and the outer step adds no latency.  The outer
aggregate is deterministic modelling: the outer commit lands at the
outer-quorum-th inner milestone plus one worst-case representative round
trip, ``2 * (one_way_hi - 1)`` (0 at C = 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from blockchain_simulator_tpu_torch.models import base as base_model
from blockchain_simulator_tpu_torch.ops import delay
from blockchain_simulator_tpu_torch.utils import threefry

_INIT_FOLD = 0x1217  # proto.init's key, as in the flat runner


def inner_cfg(cfg):
    """The flat per-committee config: n = committee size, full mesh inside
    the committee; everything else (protocol knobs, delivery, samplers,
    fault structure) inherits."""
    return cfg.with_(n=cfg.n // cfg.committees, topology="full")


def _committee_keys(key, c: int) -> np.ndarray:
    """``[C, 2]`` per-committee base keys: C = 1 keeps the caller's key
    (the flat-protocol contract), C > 1 folds in the committee index."""
    key = np.asarray(key, np.int64)
    if c == 1:
        return key[None]
    return np.stack([threefry.fold_in(key, i) for i in range(c)])


def stacked_body(cfg, keys, alive_cm, honest_cm, probe=None, width: int = 1):
    """The committee body: the inner tick engine over the committees as
    lanes — ``keys [C', 2]``, ``alive_cm`` / ``honest_cm [C', m]`` ->
    stacked final state ``[C', ...]``, what JAX's ``lax.map`` returns.
    Every committee draws on its own key (the solo rule); ``width`` > 1
    lays the lanes out ``[width, C' / width]``, the rule of ``width``
    vmapped points (module docstring).

    ``probe`` (utils/trace.py) arms per-committee taps: a ``(sample_fn,
    finalize_fn)`` pair, ``sample_fn(icfg, state) -> {name: 0-d tensor}``
    after every inner tick (read off each lane) and ``finalize_fn(icfg,
    final, ys) -> {name: tensor}`` over a committee's series ``{name:
    [ticks]}``.  The committees' dicts are stacked ``[C', ...]`` as
    ``lax.map`` stacks them, on the device, and ``(finals, probes)`` is
    returned.  The taps only read, so the finals are the unprobed run's."""
    from blockchain_simulator_tpu_torch.runner import dyn_step_cfg

    icfg = inner_cfg(cfg)
    keys = np.asarray(keys, np.int64)
    # one host read: do the committees' lanes hold Byzantine nodes at all
    liars = int(bool((alive_cm & ~honest_cm).any()))
    step_cfg = dyn_step_cfg(icfg, liars)
    device = alive_cm.device
    lanes = range(len(keys))
    tap = None
    if probe is not None:
        sample_fn, finalize_fn = probe

        def tap(state):
            samples = [sample_fn(icfg, base_model.lane_state(state, c)) for c in lanes]
            return {k: torch.stack([s[k] for s in samples]) for k in samples[0]}

    with delay.lane_rule(width):
        state, bufs = base_model.init_lanes(icfg, threefry.fold_in(keys, _INIT_FOLD), device)
        state = base_model.apply_fault_masks(icfg, state, alive_cm, honest_cm)
        out = base_model.tick_loop(step_cfg, state, bufs, keys, 0, icfg.ticks, probe=tap)
    if probe is None:
        return out[0]
    probes = [finalize_fn(icfg, base_model.lane_state(out[0], c),
                          {k: v[:, c] for k, v in out[2].items()}) for c in lanes]
    return out[0], base_model.stack_samples(probes)


def _split_lanes(tree, b: int):
    """A ``[B·C, ...]`` lane stack (a state, or a dict of probe tensors) as
    ``[B, C, ...]``."""
    if isinstance(tree, torch.Tensor):
        return tree.reshape((b, -1) + tuple(tree.shape[1:]))
    if isinstance(tree, dict):
        return {k: _split_lanes(v, b) for k, v in tree.items()}
    return dataclasses.replace(tree, **{f.name: _split_lanes(getattr(tree, f.name), b)
                                        for f in dataclasses.fields(tree)})


def run_stacked(cfg, key, n_crashed, n_byzantine, probe=None, *, device):
    """The committee run: ``(key, n_crashed, n_byzantine) -> stacked final
    state [C, ...]`` on ``device``, the fault counts as run-time operands
    (runner.make_dyn_sim_fn's committee arm; the static arm passes the
    config's own counts).  Lane keys ``[B, 2]`` with ``[B]`` counts run a
    sweep batch of B committee runs, JAX's ``vmap`` of it: ``[B, C,
    ...]``.  ``cfg`` must be fault-canonical
    (models/base.canonical_fault_cfg), like every dyn program.  ``probe``
    goes to :func:`stacked_body` (``(finals, probes)`` when armed)."""
    c, m = cfg.committees, cfg.n // cfg.committees
    key = np.asarray(key, np.int64)
    alive, honest = base_model.dyn_fault_masks(cfg.n, n_crashed, n_byzantine,
                                               torch.device(device))
    if key.ndim == 1:
        return stacked_body(cfg, _committee_keys(key, c), alive.reshape(c, m),
                            honest.reshape(c, m), probe=probe)
    b = len(key)
    out = stacked_body(cfg, np.concatenate([_committee_keys(k, c) for k in key]),
                       alive.reshape(b * c, m), honest.reshape(b * c, m), probe=probe,
                       width=b)
    return _split_lanes(out, b) if probe is None else tuple(_split_lanes(o, b) for o in out)


def milestone_ms(protocol: str, inner_metrics: dict) -> float:
    """One committee's inner-consensus milestone: the tick its inner quorum
    completed the protocol's measured outcome, -1.0 if it never did."""
    m = inner_metrics
    if protocol == "pbft":
        return float(m["last_commit_ms"]) if m["blocks_final_all_nodes"] > 0 \
            else -1.0
    if protocol == "raft":
        return float(m["last_block_ms"]) if m["blocks"] > 0 else -1.0
    return float(m["winner_commit_ms"]) if m["n_committed_proposers"] > 0 \
        else -1.0


def metrics(cfg, finals) -> dict:
    """Host-side metrics of a stacked committee final state.  C = 1: the
    flat protocol's full metrics dict plus the ``outer_*`` keys.  C > 1:
    the outer aggregate plus the per-committee milestones
    (``outer_commit_ms`` = the outer-quorum-th smallest decided milestone +
    one representative round trip)."""
    proto = base_model.get_protocol(cfg.protocol)
    c = cfg.committees
    icfg = inner_cfg(cfg)
    inner = [proto.metrics(icfg, base_model.lane_state(finals, i)) for i in range(c)]
    miles = [milestone_ms(cfg.protocol, m) for m in inner]
    decided = sorted(t for t in miles if t >= 0)
    quorum = c // 2 + 1
    outer_round = 0.0 if c == 1 else float(2 * (cfg.one_way_range()[1] - 1))
    outer_commit = (
        decided[quorum - 1] + outer_round if len(decided) >= quorum else -1.0
    )
    outer = {
        "topology": "committee",
        "committees": c,
        "committee_size": icfg.n,
        "outer_quorum": quorum,
        "committees_decided": len(decided),
        "inner_milestones_ms": miles,
        "outer_round_ms": outer_round,
        "outer_commit_ms": float(outer_commit),
        "inner_agreement_ok": all(
            bool(m.get("agreement_ok", True)) for m in inner
        ),
    }
    if c == 1:
        return {**inner[0], **outer}
    return {
        "protocol": cfg.protocol,
        "n": cfg.n,
        "agreement_ok": outer["inner_agreement_ok"],
        **outer,
    }
