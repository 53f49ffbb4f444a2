"""Raft heartbeat-blocked fast path: one step = one 50 ms heartbeat.

Port of ``blockchain_simulator_tpu/models/raft_hb.py`` (whose docstring holds
the design).  Two phases:

1. **Election prefix**: ``prefix_ticks(cfg)`` ticks of the tick engine
   (models/raft.py), which runs the genuinely event-driven elections.
2. **Heartbeat scan**: from the quiet window between the election settling
   and the first proposal, the leader's proposals and their ack waves are
   O(1) scalar work a heartbeat: multinomial bucket counts over the
   round-trip distribution shifted by the proposal's serialization, and the
   clean-mode ack-window bookkeeping at bin granularity with the tick
   engine's within-tick order.

JAX joins them with a ``lax.cond`` on the checked handoff.  Here the handoff
is ONE host read after the prefix (the flag and the leader's scalars in one
copy: one sync a run).  When the check fails (a split first election that
re-ran past the prefix, or setProposal already fired inside it), the tick
engine continues from the prefix's (state, bufs) through the rest of the
window: tick keys derive from the absolute tick, so that equals one
uninterrupted tick run.  The scan's carry is a handful of scalars, so it runs
on the host as Python integers; its bucket draws are the port's own samplers
on 0-d CPU tensors (the card gives the same bits, ``chip_smoke.py``'s
samplers phase).  ``materialize`` then writes the leader's row back into the
state on its device.

The prefix and the scan each add their host seconds to a module counter
(``prefix_s``, ``scan_s``), and each handoff adds one to ``handoffs_taken``
or ``handoffs_refused``; ``chip_smoke.py`` sets them to 0 before a run and
reads them after it.  The prefix's time ends at the handoff's read, which
waits for the device, so the two split a run's wall without a sync of
their own.

The documented divergence of the JAX path carries over unchanged: when
replication completes inside the window, this path ends at completion,
while the tick engine churns elections afterwards (the ``elections`` metric
then counts the consensus phase only).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from blockchain_simulator_tpu_torch.models import raft as raft_tick
from blockchain_simulator_tpu_torch.ops import delay as delay_ops
from blockchain_simulator_tpu_torch.utils import prng, threefry
from blockchain_simulator_tpu_torch.utils.prng import Channel, chan_key

DISARM = raft_tick.DISARM
_I32 = torch.int32
_INIT_FOLD = 0x1217  # proto.init's key, as in the JAX package

# run counters (see the module docstring)
handoffs_taken = 0
handoffs_refused = 0
prefix_s = 0.0
scan_s = 0.0


def prefix_ticks(cfg) -> int:
    """Election-phase length: the last possible first-attempt election fires
    by election_hi; its request+reply wave drains within 2 round trips."""
    _, rt_hi = cfg.roundtrip_range()
    return cfg.raft_election_hi_ms + 2 * rt_hi


def n_hb_steps(cfg) -> int:
    """Heartbeat-step count of the steady scan."""
    return max((cfg.ticks - prefix_ticks(cfg)) // cfg.raft_heartbeat_ms + 2, 1)


def eligible(cfg) -> bool:
    return (
        cfg.protocol == "raft"
        and cfg.fidelity == "clean"  # reference mode never re-arms timers
        and cfg.topology == "full"
        and cfg.delivery == "stat"
        and cfg.faults.drop_prob == 0.0  # a drop changes counts or un-suppresses a timer
        and not cfg.queued_links
        and cfg.raft_heartbeat_ms < cfg.raft_election_lo_ms  # timer suppression
        and cfg.sim_ms > prefix_ticks(cfg) + cfg.raft_heartbeat_ms
    )


def _ack_bins(cfg):
    """(step offset, tick-within-step) of each ack round-trip bin, shifted by
    the proposal serialization."""
    rt_lo, rt_hi = cfg.roundtrip_range()
    ser = cfg.serialization_ticks(cfg.raft_block_bytes)
    hb = cfg.raft_heartbeat_ms
    return [((ser + rt_lo + b) // hb, (ser + rt_lo + b) % hb) for b in range(rt_hi - rt_lo)]


class Handoff(NamedTuple):
    """Leader-global scalars the heartbeat scan consumes, as host values."""

    lead: int          # leader id (-1 if none)
    hb0: int           # leader's next heartbeat tick
    p_start: int       # leader's setProposal tick
    bn0: int           # leader's block_num at handoff (0 in the quiet window)
    rnd0: int          # leader's round at handoff (0 in the quiet window)
    bt0: tuple         # [B] leader's block_tick row
    ok_cnt: float      # honest alive followers (SUCCESS acks), a float32 value


def handoff(cfg, state):
    """The checked handoff on the post-prefix tick-engine state, read to the
    host in one copy.  Returns ``(ok, Handoff)``."""
    t_e = prefix_ticks(cfg)
    hb = cfg.raft_heartbeat_ms
    rt_hi = cfg.roundtrip_range()[1]
    ids = raft_tick._ids(cfg.n, state.is_leader.device)
    lead_mask = state.is_leader & state.alive
    voters = (state.alive & state.honest).to(_I32)

    def lval(x, fill):
        """Leader-row value (max over the leader set, a singleton when ok)."""
        return torch.where(lead_mask, x.to(_I32), fill).amax()

    scalars = torch.stack([
        lead_mask.sum(dtype=_I32),
        torch.where(lead_mask, ids, -1).amax(),
        lval(state.next_hb, -1),
        lval(state.proposal_tick, -1),
        lval(state.block_num, 0),
        lval(state.round, 0),
        lval(state.leader_tick, -1),
        voters.sum(dtype=_I32) - lval(voters, 0),
    ])
    bt0 = torch.where(lead_mask[:, None], state.block_tick, -1).amax(0)
    host = torch.cat([scalars, bt0]).tolist()  # the run's one host read
    n_leaders, lead, hb0, p_start, bn0, rnd0, lead_tick, ok_cnt = host[:8]
    ok = (
        n_leaders == 1
        # the election wave has fully drained
        and lead_tick + rt_hi <= t_e
        and p_start > t_e + hb  # not yet proposing
        # DISARM: setProposal already fired inside the prefix, so proposal
        # waves may be in flight in the rings the scan would discard
        and p_start != DISARM
    )
    return ok, Handoff(lead=lead, hb0=hb0, p_start=p_start, bn0=bn0, rnd0=rnd0,
                       bt0=tuple(host[8:]), ok_cnt=float(np.float32(ok_cnt)))


def steady_scan(cfg, key, h: Handoff, with_probe: bool = False):
    """The heartbeat-blocked steady state from the handoff scalars, on the
    host.  Returns ``(hs, open_, bn, rnd, add_on, stopped, bt)``."""
    if with_probe:
        raise NotImplementedError(
            "probed runs (per-heartbeat probe series) come with slice 4 of the "
            "port (fault operands, sweeps, checkpoints and traces)"
        )
    hb = cfg.raft_heartbeat_ms
    b_max = cfg.raft_max_blocks
    ticks = cfg.ticks
    need = cfg.majority_need
    bins = _ack_bins(cfg)
    b2 = len(bins)
    span = max(s for s, _ in bins) + 1
    # bin order within a step: tick-within-step ascending (ties: one update)
    order = sorted(range(b2), key=lambda i: bins[i][1])
    rt_probs = delay_ops.roundtrip_probs(*cfg.one_way_range())
    smode = cfg.eff_stat_sampler

    pend = [[0] * b2 for _ in range(span)]
    hs, open_, bn, rnd = 0, False, h.bn0, h.rnd0
    add_on, stopped, bt = True, False, list(h.bt0)

    def apply_bin(cnt, tick):
        """One ack bin through the window: count, threshold-cross, commit."""
        nonlocal hs, open_, bn
        hs += cnt
        crossed = open_ and cnt > 0 and hs + 1 >= need
        if crossed and bn < b_max:
            bt[min(max(bn, 0), b_max - 1)] = tick
        open_ = open_ and not crossed
        bn += crossed

    for k in range(n_hb_steps(cfg)):
        t_k = h.hb0 + k * hb
        arrivals = pend[0]
        # boundary-tick arrivals hit the OLD window, before the proposal
        for i in order:
            if bins[i][1] == 0:
                apply_bin(arrivals[i] if t_k < ticks else 0, t_k)
        # heartbeat boundary: proposal + clean window reset
        p = t_k < ticks and not stopped and t_k >= h.p_start and add_on and bn < b_max
        rnd += p
        add_on = add_on and not (p and rnd >= cfg.raft_max_rounds)
        if p:
            hs, open_ = 0, True
        # post-boundary arrivals fill the (possibly new) window
        for i in order:
            off = bins[i][1]
            if off != 0:
                apply_bin(arrivals[i] if t_k + off < ticks else 0, t_k + off)
        pend = pend[1:] + [[0] * b2]
        if p:  # with no proposal every count is 0: nothing to draw
            kk = threefry.fold_in(
                chan_key(prng.tick_key(key, t_k), Channel.DELAY_ROUNDTRIP), 0x4B)
            count = torch.tensor(h.ok_cnt, dtype=torch.float32)
            cnts = delay_ops.sample_bucket_counts(kk, count, rt_probs, smode).tolist()
        else:
            cnts = [0] * b2
        for i, (s_i, _) in enumerate(bins):
            if s_i > 0:  # lands s_i steps later: row s_i - 1 after the rotation
                pend[s_i - 1][i] += cnts[i]
        # bins landing later in THIS step (ser + rt < heartbeat)
        for i in order:
            s_i, off = bins[i]
            if s_i == 0:
                apply_bin(cnts[i] if t_k + off < ticks else 0, t_k + off)
        stopped = stopped or bn >= b_max  # blockNum >= max cancels the heartbeat
    return hs, open_, bn, rnd, add_on, stopped, tuple(bt)


def materialize(cfg, state, h: Handoff, scan_out):
    """Fold the steady-scan scalars back into the [N] state the metrics
    read: the leader's row, and every alive follower's stored value."""
    hs, open_, bn, rnd, add_on, stopped, bt = scan_out
    dev = state.is_leader.device
    onehot = raft_tick._ids(cfg.n, dev) == h.lead
    bt_row = torch.tensor(bt, dtype=_I32, device=dev)
    return dataclasses.replace(
        state,
        block_num=torch.where(onehot, bn, state.block_num),
        round=torch.where(onehot, rnd, state.round),
        block_tick=torch.where(onehot[:, None], bt_row[None, :], state.block_tick),
        hb_succ=torch.where(onehot, hs, state.hb_succ),
        hb_open=torch.where(onehot, open_, state.hb_open),
        add_change_value=torch.where(onehot, add_on, state.add_change_value),
        next_hb=torch.where(onehot & stopped, DISARM, state.next_hb),
        m_value=torch.where(state.alive & ~onehot & (rnd > 0), h.lead, state.m_value),
    )


def tick_range(cfg, state, bufs, key, start: int, stop: int):
    """Step the tick engine over ticks ``[start, stop)``."""
    dev = state.is_leader.device
    ticks = torch.arange(start, stop, dtype=_I32, device=dev)
    tkeys = prng.tick_key(key, range(start, stop))
    for i in range(stop - start):
        state, bufs = raft_tick.step(cfg, state, bufs, ticks[i], tkeys[i])
    return state, bufs


def scan_from_init(cfg, state, bufs, key, probe=None):
    """The heartbeat-path simulation from an initial (state, bufs): the
    election prefix on the tick engine, the checked handoff (one host read),
    then the heartbeat scan, or the tick engine continued from the prefix
    carry."""
    global handoffs_taken, handoffs_refused, prefix_s, scan_s
    if probe is not None:
        raise NotImplementedError(
            "probed runs come with slice 4 of the port (fault operands, sweeps, "
            "checkpoints and traces)"
        )
    t0 = time.perf_counter()
    t_e = prefix_ticks(cfg)
    state, bufs = tick_range(cfg, state, bufs, key, 0, t_e)
    ok, h = handoff(cfg, state)
    t1 = time.perf_counter()
    prefix_s += t1 - t0
    if ok:
        handoffs_taken += 1
        out = steady_scan(cfg, key, h)
        scan_s += time.perf_counter() - t1
        return materialize(cfg, state, h, out)
    handoffs_refused += 1
    # the prefix did not reach the quiet window: the tick engine takes over
    state, _ = tick_range(cfg, state, bufs, key, t_e, max(cfg.ticks, t_e))
    return state


def run(cfg, key, device):
    """``run(cfg, key, device) -> RaftState``: init + scan_from_init."""
    state, bufs = raft_tick.init(cfg, threefry.fold_in(key, _INIT_FOLD), device=device)
    return scan_from_init(cfg, state, bufs, key)


def metrics(cfg, state) -> dict:
    return raft_tick.metrics(cfg, state)
