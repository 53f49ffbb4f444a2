"""Probe taps: per-sample counters, windowed reductions and final-state
invariant monitors (port of ``blockchain_simulator_tpu/obsim/taps.py``).

Everything here is torch ops on the state's device.  Two rules, as in the
JAX package:

- **No host reads**: nothing here copies a device value to the host or
  imports ``utils/telemetry``; the samples stay on the device until the
  run ends (a probed round scan makes no host sync, checked under
  ``torch.cuda.set_sync_debug_mode("error")`` on the card).  The window
  indices are host numbers from static counts (schema.window_bounds),
  moved to the card without blocking (utils/threefry.lane_tensor).
- **No draws**: taps only READ state; they never consume a key, so an armed
  run steps through the disarmed run's states, bit for bit.

A lane-stacked state (``[B, N]`` fields; the sweeps' lane axis) gives
``[B]`` samples: every reduction is over the last axis, as ``jax.vmap`` of
the JAX taps reduces each lane alone.  Series keep the sample axis LAST
(``[..., m]``), the layout of JAX's vmapped ``[B, m]``.
"""

from __future__ import annotations

import numpy as np
import torch

from blockchain_simulator_tpu_torch.obsim import schema
from blockchain_simulator_tpu_torch.utils import threefry

_I32 = torch.int32
_I32_NEVER = int(np.iinfo(np.int32).max)  # models/pbft._NEVER sentinel


def _count(mask) -> torch.Tensor:
    return mask.sum(-1, dtype=_I32)


def _sum(x) -> torch.Tensor:
    return x.sum(-1, dtype=_I32)


def _max(x) -> torch.Tensor:
    return x.amax(-1).to(_I32)


# ------------------------------------------------------------- samples ---


def sample(cfg, state) -> dict:
    """One probe sample: the protocol's schema.SERIES_FIELDS counters read
    off ``state`` (a handful of sums and maxes on its device).  ``cfg`` is
    the config the state belongs to (the INNER config on the committee
    path, so ``cfg.n`` is the committee size)."""
    p = cfg.protocol
    if p == "pbft":
        q = (2 * cfg.n) // 3 + 1
        return {
            "msgs_rounds": _sum(state.rounds_sent),
            "commits": _sum(state.slot_commits),
            "blocks": _max(state.block_num),
            "views": _max(state.v),
            "view_changes": _sum(state.view_changes),
            "slots_any": _count(state.slot_commits > 0),
            "slots_quorum": _count(state.slot_commits >= q),
        }
    if p == "raft":
        return {
            "msgs_rounds": _sum(state.round),
            "blocks": _max(state.block_num),
            "elections": _sum(state.elections),
            "leaders": _count(state.is_leader & state.alive),
        }
    if p == "paxos":
        from blockchain_simulator_tpu_torch.models import paxos as paxos_model

        ph = state.phase
        return {
            "msgs_tickets": _sum(state.ticket),
            "executes": _count(state.is_commit),
            "committed": _count(state.commit_tick >= 0),
            "phase_ticket": _count(ph == paxos_model.PH_TICKET),
            "phase_propose": _count(ph == paxos_model.PH_PROPOSE),
            "phase_commit": _count(ph == paxos_model.PH_COMMIT),
        }
    raise NotImplementedError(p)


def raft_steady_sample(ys: dict, h_state) -> dict:
    """Map the Raft heartbeat path's per-heartbeat scan samples
    (models/raft_hb.steady_scan ``with_probe=True``: ``{"blocks", "rounds",
    ...}``, ``[..., K]``) into the Raft probe schema.  Elections and
    leadership are frozen by the handoff's steady-state precondition, so
    those fields broadcast the handoff state's values (``h_state``, one a
    lane) across the heartbeat axis."""
    blocks = ys["blocks"].to(_I32)
    return {
        "msgs_rounds": ys["rounds"].to(_I32),
        "blocks": blocks,
        "elections": _sum(h_state.elections)[..., None].expand(blocks.shape),
        "leaders": _count(h_state.is_leader & h_state.alive)[..., None].expand(blocks.shape),
    }


def time_last(ys: dict) -> dict:
    """Stacked samples ``{field: [m, ...]}`` (base.stack_samples: the step
    axis first, then the lane axis when there is one) as series with the
    sample axis last, ``[..., m]``."""
    return {k: v.movedim(0, -1) for k, v in ys.items()}


# ------------------------------------------------- windowed reductions ---


def window(series: dict, n_samples: int, windows: int) -> dict:
    """Reduce per-sample series ``{field: [..., m]}`` to window-boundary
    series ``{field: [..., W]}``: a gather on the last axis at the static
    indices of schema.window_bounds."""
    idx = schema.window_bounds(n_samples, windows)
    out = {}
    for k, v in series.items():
        out[k] = v.index_select(-1, threefry.lane_tensor(idx, v.device))
    return out


def liveness_lag(progress) -> torch.Tensor:
    """Samples since the cumulative progress counter last advanced (``m`` =
    never advanced).  ``progress`` is the protocol's schema.PROGRESS_FIELD
    per-sample series ``[..., m]``: a max over a comparison against the
    shifted series."""
    prog = progress.to(_I32)
    m = prog.shape[-1]
    prev = torch.cat([torch.zeros_like(prog[..., :1]), prog[..., :-1]], dim=-1)
    inc = prog > prev
    idx = torch.arange(m, dtype=_I32, device=prog.device)
    last = torch.where(inc, idx, -1).amax(-1) if m else torch.full(
        prog.shape[:-1], -1, dtype=_I32, device=prog.device)
    return torch.where(last < 0, m, m - 1 - last).to(_I32)


# ------------------------------------------------------------ monitors ---


def monitors(cfg, state) -> dict:
    """Invariant monitors over the FINAL state: the device twins of each
    protocol's host-side ``metrics()`` agreement logic (a monitor firing and
    ``agreement_ok=False`` are the same event), plus a quorum-certificate
    consistency check.  Int32 violation counters; zero = clean.
    ``liveness_lag`` is attached by the callers that hold the per-sample
    progress series."""
    p = cfg.protocol
    if p == "pbft":
        commits = state.slot_commits
        proposed = state.slot_propose_tick < _I32_NEVER
        # forged (quorum without any proposal) + misattributed commits
        viol_agree = (_count((commits > 0) & ~proposed) + _sum(state.unattributed)).to(_I32)
        # a finalization stamped BEFORE its slot's first proposal is an
        # inconsistent quorum certificate
        viol_quorum = _count((commits > 0) & proposed & (state.slot_commit_tick >= 0)
                             & (state.slot_commit_tick < state.slot_propose_tick))
        return {"viol_agreement": viol_agree, "viol_quorum": viol_quorum}
    if p == "raft":
        cand = state.is_leader & state.alive
        lt = torch.where(cand, state.leader_tick, _I32_NEVER)
        lead = lt.argmin(-1).to(_I32)  # earliest-elected alive leader
        stored = state.alive & (state.m_value >= 0)
        # raft.metrics agreement: every alive stored value names the leader
        viol_agree = torch.where(cand.any(-1), _count(stored & (state.m_value != lead[..., None])),
                                 0).to(_I32)
        # split brain among CORRECT nodes
        viol_quorum = torch.clamp(_count(state.is_leader & state.alive & state.honest) - 1,
                                  min=0).to(_I32)
        return {"viol_agreement": viol_agree, "viol_quorum": viol_quorum}
    if p == "paxos":
        np_prop = cfg.paxos_n_proposers
        executed = state.is_commit & state.alive
        n_exec = _count(executed)
        cmd_min = torch.where(executed, state.command, _I32_NEVER).amin(-1)
        cmd_max = torch.where(executed, state.command, -1).amax(-1)
        distinct = (n_exec > 0) & (cmd_min != cmd_max)
        winners = state.commit_tick[..., :np_prop] >= 0
        # paxos.metrics agreement: one executed command, and every
        # committed proposer proposed exactly it
        wrong = winners & (state.proposal[..., :np_prop] != cmd_min[..., None])
        viol_agree = distinct.to(_I32) + torch.where(n_exec > 0, _count(wrong), 0).to(_I32)
        # a committed proposer whose quorum left zero executed acceptors
        viol_quorum = ((_count(winners) > 0) & (n_exec == 0)).to(_I32)
        return {"viol_agreement": viol_agree, "viol_quorum": viol_quorum}
    raise NotImplementedError(p)


# ------------------------------------------------------------ assembly ---


def finalize(cfg, pcfg, final_state, series, n_samples: int) -> dict:
    """Assemble the probe pytree from a run's per-sample series ``{field:
    [..., m]}`` and its final state: windowed series always, the monitor
    block when ``pcfg.monitors`` (schema docstring).  Tensors on the
    state's device."""
    out = {"series": window(series, n_samples, pcfg.windows)}
    if pcfg.monitors:
        mon = monitors(cfg, final_state)
        mon["liveness_lag"] = liveness_lag(series[schema.PROGRESS_FIELD[cfg.protocol]])
        out["monitors"] = mon
    return out
