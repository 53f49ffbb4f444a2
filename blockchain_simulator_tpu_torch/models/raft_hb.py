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
uninterrupted tick run.

The handoff, the scan and the write-back run on the state's device over a
leading shard axis ``[S]``: each is ``jax.vmap`` of its JAX function over
the shards (the mixed shard sim, models/mixed.py, runs S of them side by
side on ``[S, m, ...]`` states; the single Raft path calls them with
S = 1).  :func:`handoff` reads its ``[S, 8]`` check values to the host in
one copy.  The scan's carry is ``[S]`` tensors, its ack waves are drawn for
every step and shard up front (``ops/delay.sample_bucket_counts_vmapped``),
and each step's bins go through the ack window in one vectorised pass
(:func:`_cross`), so the step loop reads nothing back.  :func:`materialize`
writes each shard's leader row back into the state.

The prefix and the scan each add their host seconds to a module counter
(``prefix_s``, ``scan_s``), and each handoff (each lane's, in a lane batch)
adds one to ``handoffs_taken`` or ``handoffs_refused``; ``chip_smoke.py``
sets them to 0 before a run and reads them after it.  The prefix's time
ends at the handoff's read, which waits for the device.  The scan's ends when its calls return: on the CPU
that is its whole time, on the card the device may still be working, and
the caller's next sync (``runner.final_state``'s) waits for it.  Neither
counter adds a sync of its own.

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
from blockchain_simulator_tpu_torch.models.base import stack_samples, tick_loop
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
    """Leader-global values the heartbeat scan consumes, one per shard:
    ``[S]`` tensors on the state's device (``bt0`` is ``[S, B]``), except
    ``hb0``, a host array: the scan's tick keys are host threefry words
    derived from it (utils/threefry.py)."""

    lead: torch.Tensor     # leader id (-1 if none)
    hb0: np.ndarray        # leader's next heartbeat tick (host int64)
    p_start: torch.Tensor  # leader's setProposal tick
    bn0: torch.Tensor      # leader's block_num at handoff (0 in the quiet window)
    rnd0: torch.Tensor     # leader's round at handoff (0 in the quiet window)
    bt0: torch.Tensor      # [S, B] leader's block_tick row
    ok_cnt: torch.Tensor   # honest alive followers (SUCCESS acks), float32


def _shard_view(state):
    """A one-instance ``[N]`` state as one shard, ``[1, N]`` (views)."""
    return dataclasses.replace(state, **{f: getattr(state, f)[None]
                                         for f in raft_tick.STATE_FIELDS})


def _unshard(state):
    """The one shard of a ``[1, N]`` state, as ``[N]`` (views)."""
    return dataclasses.replace(state, **{f: getattr(state, f)[0]
                                         for f in raft_tick.STATE_FIELDS})


def handoff(cfg, state):
    """The checked handoff in every shard of a post-prefix ``[S, m]``
    tick-engine state: ``jax.vmap`` of the JAX check.  The ``[S, 8]`` check
    values are read to the host in one copy.  Returns ``(ok, Handoff)``,
    ``ok`` a host bool array ``[S]``."""
    t_e = prefix_ticks(cfg)
    hb = cfg.raft_heartbeat_ms
    rt_hi = cfg.roundtrip_range()[1]
    ids = raft_tick._ids(cfg.n, state.is_leader.device)
    lead_mask = state.is_leader & state.alive
    voters = (state.alive & state.honest).to(_I32)

    def lval(x, fill):
        """Leader-row value (max over the leader set, a singleton when ok)."""
        return torch.where(lead_mask, x.to(_I32), fill).amax(-1)

    vals = torch.stack([
        lead_mask.sum(-1, dtype=_I32),
        torch.where(lead_mask, ids, -1).amax(-1),
        lval(state.next_hb, -1),
        lval(state.proposal_tick, -1),
        lval(state.block_num, 0),
        lval(state.round, 0),
        lval(state.leader_tick, -1),
        voters.sum(-1, dtype=_I32) - lval(voters, 0),
    ], dim=1)
    host = vals.cpu().numpy().astype(np.int64)  # the run's one host read
    n_leaders, hb0, p_start, lead_tick = host[:, 0], host[:, 2], host[:, 3], host[:, 6]
    ok = (
        (n_leaders == 1)
        # the election wave has fully drained
        & (lead_tick + rt_hi <= t_e)
        & (p_start > t_e + hb)  # not yet proposing
        # DISARM: setProposal already fired inside the prefix, so proposal
        # waves may be in flight in the rings the scan would discard
        & (p_start != DISARM)
    )
    row = torch.where(lead_mask[..., None], state.block_tick, -1).amax(-2)
    return ok, Handoff(lead=vals[:, 1], hb0=hb0, p_start=vals[:, 3], bn0=vals[:, 4],
                       rnd0=vals[:, 5], bt0=row, ok_cnt=vals[:, 7].to(torch.float32))


def _cross(hs, open_, bn, bt, cnt, tick, need: int, b_max: int):
    """Ack bins ``cnt [S, m]`` (arriving at ``tick [S, m]``, in processing
    order) through each shard's window, the tick engine's per-tick rule bin
    after bin: count, threshold-cross, commit.  A window closes at its first
    crossing and stays closed, so a run of bins crosses at most once: at the
    first bin with a count whose running total reaches the threshold."""
    cum = torch.cumsum(cnt, 1, dtype=_I32)
    hit = open_[:, None] & (cnt > 0) & (hs[:, None] + cum + 1 >= need)
    crossed = hit.any(1)
    first = hit.to(torch.uint8).argmax(1, keepdim=True)
    at = tick.gather(1, first)  # [S, 1] the crossing bin's tick
    blk = torch.clamp(bn, 0, b_max - 1)
    slots = torch.arange(b_max, device=bn.device)
    write = (slots[None, :] == blk[:, None]) & (crossed & (bn < b_max))[:, None]
    return (hs + cum[:, -1], open_ & ~crossed, bn + crossed.to(_I32),
            torch.where(write, at, bt))


def steady_scan(cfg, keys, h: Handoff, with_probe: bool = False):
    """The heartbeat-blocked steady state of ``S`` shards from their handoff
    values, on the handoff tensors' device: ``jax.vmap`` of the JAX
    package's ``steady_scan`` over ``(keys [S, 2], h)``.  Returns ``(hs,
    open_, bn, rnd, add_on, stopped, bt)``, ``[S]`` tensors (``bt`` is
    ``[S, B]``).

    Every step's ack-wave draw is made up front, for all steps and shards at
    once, with the count ``ok_cnt``: a step that proposes nothing takes its
    draw masked to 0, which is what JAX's draw of a count of 0 gives in
    both samplers.  The step loop then makes no host read.

    ``with_probe=True`` (utils/trace.run_traced) also records, after every
    heartbeat step, ``{"blocks", "rounds", "acks_in_window", "stopped"}``
    (the leader-global values, int32) and returns ``(out, ys)``, each ``ys``
    value ``[S, K]`` on the device (the vmapped JAX scan's ``ys``).  The
    probe only reads the carry."""
    keys = np.asarray(keys, np.int64)
    dev = h.bt0.device
    n_sh = len(h.hb0)
    hb = cfg.raft_heartbeat_ms
    b_max = cfg.raft_max_blocks
    need = cfg.majority_need
    bins = _ack_bins(cfg)
    b2 = len(bins)
    span = max(s for s, _ in bins) + 1
    # bin order within a step: tick-within-step ascending (ties: one update)
    order = sorted(range(b2), key=lambda i: bins[i][1])
    steps = n_hb_steps(cfg)

    # the draws: [B2, K, S] on the keys of every (step, shard)
    t_host = h.hb0[None, :] + hb * np.arange(steps, dtype=np.int64)[:, None]
    kk = threefry.fold_in(
        chan_key(prng.tick_key(keys[None], t_host), Channel.DELAY_ROUNDTRIP), 0x4B)
    draws = delay_ops.sample_bucket_counts_vmapped(
        kk, h.ok_cnt[None, :].expand(steps, n_sh),
        delay_ops.roundtrip_probs(*cfg.one_way_range()), cfg.eff_stat_sampler)

    def idx(ix):
        return torch.tensor(ix, dtype=torch.int64, device=dev)

    # arrivals on the boundary tick hit the OLD window, before the proposal;
    # the rest of the step's arrivals, then the bins of this step's own wave
    # that land inside the step (ser + rt < heartbeat), fill the new one
    seg_a = [i for i in order if bins[i][1] == 0]
    seg_b = [i for i in order if bins[i][1] != 0]
    seg_0 = [i for i in order if bins[i][0] == 0]
    off_b = idx([bins[i][1] for i in seg_b + seg_0]).to(_I32)
    seg_a, seg_b, seg_0 = idx(seg_a), idx(seg_b), idx(seg_0)
    later = [i for i in range(b2) if bins[i][0] > 0]  # land bins[i][0] steps on
    later_rows = idx([bins[i][0] - 1 for i in later])  # rows after the rotation
    later = idx(later)

    t_all = threefry.lane_tensor(t_host, dev).to(_I32)  # [K, S]
    pend = torch.zeros((n_sh, span, b2), dtype=_I32, device=dev)
    hs = torch.zeros((n_sh,), dtype=_I32, device=dev)
    open_ = torch.zeros((n_sh,), dtype=torch.bool, device=dev)
    add_on = torch.ones((n_sh,), dtype=torch.bool, device=dev)
    stopped = torch.zeros((n_sh,), dtype=torch.bool, device=dev)
    bn, rnd, bt = h.bn0.to(_I32), h.rnd0.to(_I32), h.bt0.to(_I32)
    samples = []
    for k in range(steps):
        t_k = t_all[k]
        arrivals = pend[:, 0]
        live = t_k < cfg.ticks
        if len(seg_a):
            hs, open_, bn, bt = _cross(hs, open_, bn, bt,
                                       arrivals[:, seg_a] * live[:, None].to(_I32),
                                       t_k[:, None].expand(n_sh, len(seg_a)), need, b_max)
        # heartbeat boundary: proposal + clean window reset
        p = live & ~stopped & (t_k >= h.p_start) & add_on & (bn < b_max)
        rnd = rnd + p.to(_I32)
        add_on = add_on & ~(p & (rnd >= cfg.raft_max_rounds))
        hs = torch.where(p, 0, hs)
        open_ = open_ | p
        cnts = draws[:, k, :].T * p[:, None].to(_I32)  # [S, B2]
        cnt_b = torch.cat([arrivals[:, seg_b], cnts[:, seg_0]], 1)
        if cnt_b.shape[1]:
            tick_b = t_k[:, None] + off_b[None, :]
            hs, open_, bn, bt = _cross(hs, open_, bn, bt,
                                       cnt_b * (tick_b < cfg.ticks).to(_I32), tick_b,
                                       need, b_max)
        # rotate the pending ring and enqueue this step's later-landing bins
        pend = torch.cat([pend[:, 1:], torch.zeros_like(pend[:, :1])], 1)
        pend[:, later_rows, later] += cnts[:, later]
        stopped = stopped | (bn >= b_max)  # blockNum >= max cancels the heartbeat
        if with_probe:
            samples.append({"blocks": bn, "rounds": rnd, "acks_in_window": hs,
                            "stopped": stopped.to(_I32)})
    out = (hs, open_, bn, rnd, add_on, stopped, bt)
    if not with_probe:
        return out
    return out, {k: v.movedim(0, 1) for k, v in stack_samples(samples).items()}


def materialize(cfg, state, h: Handoff, scan_out):
    """Fold the steady scan's ``[S]`` values back into the ``[S, m]`` state
    the metrics read: each shard's leader row, and every alive follower's
    stored value.  Tensor ops on the state's device (no host read)."""
    hs, open_, bn, rnd, add_on, stopped, bt = (x[:, None] for x in scan_out)
    lead = h.lead[:, None]
    onehot = raft_tick._ids(cfg.n, state.is_leader.device) == lead
    return dataclasses.replace(
        state,
        block_num=torch.where(onehot, bn, state.block_num),
        round=torch.where(onehot, rnd, state.round),
        block_tick=torch.where(onehot[..., None], bt, state.block_tick),
        hb_succ=torch.where(onehot, hs, state.hb_succ),
        hb_open=torch.where(onehot, open_, state.hb_open),
        add_change_value=torch.where(onehot, add_on, state.add_change_value),
        next_hb=torch.where(onehot & stopped, DISARM, state.next_hb),
        m_value=torch.where(state.alive & ~onehot & (rnd > 0), lead, state.m_value),
    )


def _select(ok, fast, slow):
    """Per lane, ``fast``'s fields where the handoff was taken, else
    ``slow``'s: the select ``jax.vmap`` makes of the handoff's
    ``lax.cond``."""
    def pick(a, b):
        return torch.where(ok.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)

    return dataclasses.replace(fast, **{f: pick(getattr(fast, f), getattr(slow, f))
                                        for f in raft_tick.STATE_FIELDS})


def scan_from_init(cfg, state, bufs, key, probe=None):
    """The heartbeat-path simulation from an initial (state, bufs): the
    election prefix on the tick engine, the checked handoff (one host read),
    then the heartbeat scan, or the tick engine continued from the prefix
    carry.

    Lane keys ``[B, 2]`` run ``B`` lanes side by side (state ``[B, N]``,
    rings ``[D, B, N]``): ``jax.vmap`` of the JAX function, whose ``lax.cond``
    on the handoff becomes a select.  The ``[S]`` scan runs over every lane,
    and when some lane's handoff is refused the tick engine continues every
    lane from the prefix carry (its ``"normal"`` draws follow the first
    lane's key, as the vmapped branch's do); each lane then keeps the branch
    its own handoff picked.  A branch no lane picks is not run."""
    global handoffs_taken, handoffs_refused, prefix_s, scan_s
    if probe is not None:
        raise NotImplementedError(
            "probe= (obsim's (sample, steady_map, reduce) taps) comes with the "
            "durable-sweeps slice of the port (journal, query, obsim; ROADMAP.md queue A); "
            "utils/trace.run_traced records the heartbeat path's probe series"
        )
    lanes = np.ndim(key) == 2
    keys = np.asarray(key, np.int64).reshape(-1, 2)
    t0 = time.perf_counter()
    t_e = prefix_ticks(cfg)
    state, bufs = tick_loop(cfg, state, bufs, key, 0, t_e)
    view = state if lanes else _shard_view(state)
    ok, h = handoff(cfg, view)
    t1 = time.perf_counter()
    prefix_s += t1 - t0
    handoffs_taken += int(ok.sum())
    handoffs_refused += int((~ok).sum())
    fast = None
    if ok.any():
        out = steady_scan(cfg, keys, h)
        fast = materialize(cfg, view, h, out)
        if not lanes:
            fast = _unshard(fast)
        scan_s += time.perf_counter() - t1
        if ok.all():
            return fast
    # the prefix did not reach the quiet window: the tick engine takes over
    slow, _ = tick_loop(cfg, state, bufs, key, t_e, max(cfg.ticks, t_e))
    if fast is None:
        return slow
    return _select(torch.as_tensor(ok, device=slow.alive.device), fast, slow)


def run(cfg, key, device):
    """``run(cfg, key, device) -> RaftState``: init + scan_from_init."""
    state, bufs = raft_tick.init(cfg, threefry.fold_in(key, _INIT_FOLD), device=device)
    return scan_from_init(cfg, state, bufs, key)


def metrics(cfg, state) -> dict:
    return raft_tick.metrics(cfg, state)
