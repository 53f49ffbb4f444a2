"""PBFT consensus — the tensorized per-tick engine, in PyTorch.

Port of ``blockchain_simulator_tpu/models/pbft.py`` (whose docstring holds
the design: the leader broadcasts PRE_PREPARE every block interval, replicas
broadcast PREPARE, PREPARE_RES replies are short-circuited into round-trip
counts, a prepare-quorum crossing broadcasts COMMIT, a commit-quorum crossing
finalizes; one tick = 1 ms for all N nodes at once; live vote state is a
``[N, W]`` slot window).  Same state fields, same arithmetic in int32, same
threefry keys per (tick, channel): a run is bit-equal to the JAX package's.

Ported arms: full mesh with edge (exact per-edge, ``"threefry"`` or
``"rbg"`` delays) or stat (multinomial bucket counts) delivery, drops, crash
and Byzantine masks, ``byz_forge``, both fidelities, both quorum rules, and
the windowed vote table (``pbft_window < pbft_max_slots``).  Everything else
raises ``NotImplementedError`` naming the slice of the port that brings it.

PyTorch idiom: state and rings are mutable tensors.  The rings are updated in
place (ops/ring.py), and ``t`` is a one-element int32 tensor on the device.
Gates read their predicate back to the host (models/base.gated).  Each ring
is popped once at the top of a tick and pushed once; nothing reads a ring
between its push and the end of the tick, so the four pushes are collected
and applied together at the end, in one kernel launch on the card.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from blockchain_simulator_tpu_torch.models.base import fault_masks, gated
from blockchain_simulator_tpu_torch.ops import delay as delay_ops
from blockchain_simulator_tpu_torch.ops import delivery as dv
from blockchain_simulator_tpu_torch.ops.ring import ring_pop, ring_push_group
from blockchain_simulator_tpu_torch.utils import threefry
from blockchain_simulator_tpu_torch.utils.prng import Channel, chan_key

_NEVER = int(np.iinfo(np.int32).max)  # propose-tick sentinel (min-reduced)
_I32 = torch.int32

# per-slot accumulators (not node-indexed)
GLOBAL_FIELDS = ("slot_commits", "slot_commit_tick", "slot_propose_tick")


@dataclasses.dataclass
class PbftState:
    v: torch.Tensor            # [N] current view (init 1)
    leader: torch.Tensor       # [N] believed leader (init 0)
    next_n: torch.Tensor       # [N] next sequence number a leader would use
    rounds_sent: torch.Tensor  # [N] blocks broadcast as leader
    slot_id: torch.Tensor      # [N, W] tenant slot of each window, -1 unknown
    prepare_vote: torch.Tensor  # [N, W]
    commit_vote: torch.Tensor   # [N, W]
    prep_sent: torch.Tensor     # [N, W] bool — COMMIT already broadcast (clean latch)
    committed_w: torch.Tensor   # [N, W] bool — tenant finalized at this node
    block_num: torch.Tensor     # [N] commits counted
    unattributed: torch.Tensor  # [N] commits that crossed with an unknown tenant
    view_changes: torch.Tensor  # [N] view changes initiated
    alive: torch.Tensor         # [N] bool fault mask
    honest: torch.Tensor        # [N] bool fault mask
    seen_pp: torch.Tensor       # [N, W] gossip dedup state; zeros on the full mesh
    seen_vc: torch.Tensor       # [N]
    link_busy: torch.Tensor     # [N] queued-link registers; [N] zeros here
    ppq_tick: torch.Tensor      # [N, Q] queued-block arrival ticks (_NEVER free)
    ppq_val: torch.Tensor       # [N, Q] queued-block slot+1 values
    slot_commits: torch.Tensor      # [S] nodes that finalized slot s (first time)
    slot_commit_tick: torch.Tensor  # [S] last finalization tick, -1 never
    slot_propose_tick: torch.Tensor  # [S] first proposal tick, _NEVER sentinel


@dataclasses.dataclass
class PbftBufs:
    pp: torch.Tensor       # [D, N, W] PRE_PREPARE slot-id+1 values, max-combined
    prep_rt: torch.Tensor  # [D, N, W] PREPARE_RES (round-trip) reply counts
    commit: torch.Tensor   # [D, N, W] COMMIT arrival counts
    vc: torch.Tensor       # [D, N] VIEW_CHANGE, encoded v*N + leader + 1, max


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(PbftState))
BUF_FIELDS = tuple(f.name for f in dataclasses.fields(PbftBufs))


def eff_window(cfg) -> int:
    w = getattr(cfg, "pbft_window", 0)
    if w <= 0 or w >= cfg.pbft_max_slots:
        return cfg.pbft_max_slots
    return w


def queue_len(cfg) -> int:
    """Per-destination block-FIFO depth for queued-link mode (1 = dummy
    registers, the ring path carries the blocks)."""
    ser = cfg.serialization_ticks(cfg.pbft_block_bytes)
    if not cfg.queued_links or ser == 0:
        return 1
    return min(cfg.pbft_max_rounds, cfg.pbft_max_slots)


def require_ported(cfg) -> None:
    """Raise ``NotImplementedError`` for the arms later slices bring."""
    if cfg.queued_links:
        raise NotImplementedError(
            "queued_links (serial-pipe block FIFOs) comes with the next part "
            "of slice 2 of the port (the PBFT tick engine's queued links)"
        )
    if cfg.topology == "gossip":
        raise NotImplementedError(
            "topology='gossip' (flood relay) comes with slice 3 of the port"
        )
    if cfg.topology in ("kregular", "committee"):
        raise NotImplementedError(
            f"topology={cfg.topology!r} comes with slice 5 of the port "
            "(sparse topologies)"
        )
    if cfg.mesh_axis is not None:
        raise NotImplementedError(
            "mesh_axis (node-sharded runs) comes with slice 6 of the port "
            "(many GPUs)"
        )


def init(cfg, key=None, *, device):
    del key  # the fault masks are deterministic, as in the JAX package
    require_ported(cfg)
    n, s = cfg.n, cfg.pbft_max_slots
    w = eff_window(cfg)
    d = cfg.ring_depth
    if w < s:
        lo, hi = cfg.one_way_range()
        if 4 * lo <= hi:
            raise ValueError(
                f"pbft_window={w} < max_slots requires 4*delay_lo > delay_hi "
                f"(got lo={lo}, hi={hi}): a slot's PRE_PREPARE must land "
                "before its first COMMIT vote"
            )
        if w * cfg.pbft_block_interval_ms <= d + hi:
            raise ValueError(
                f"pbft_window={w} re-tenants a window every "
                f"{w * cfg.pbft_block_interval_ms} ms, inside the message "
                f"horizon (~{d + hi} ms); raise pbft_window"
            )
        if cfg.faults.byz_forge:
            raise ValueError(
                "byz_forge targets a concrete never-proposed slot; it "
                "requires exact mode (pbft_window = 0 or >= pbft_max_slots)"
            )
    alive, honest = fault_masks(cfg, n, device)

    def zi(*sh):
        return torch.zeros(sh, dtype=_I32, device=device)

    def full(sh, val):
        return torch.full(sh, val, dtype=_I32, device=device)

    def zb(*sh):
        return torch.zeros(sh, dtype=torch.bool, device=device)

    q = queue_len(cfg)
    state = PbftState(
        v=torch.ones((n,), dtype=_I32, device=device),
        leader=zi(n),
        next_n=zi(n),
        rounds_sent=zi(n),
        slot_id=full((n, w), -1),
        prepare_vote=zi(n, w),
        commit_vote=zi(n, w),
        prep_sent=zb(n, w),
        committed_w=zb(n, w),
        block_num=zi(n),
        unattributed=zi(n),
        view_changes=zi(n),
        alive=alive,
        honest=honest,
        seen_pp=zi(n, w),
        seen_vc=zi(n),
        link_busy=zi(n),
        ppq_tick=full((n, q), _NEVER),
        ppq_val=zi(n, q),
        slot_commits=zi(s),
        slot_commit_tick=full((s,), -1),
        slot_propose_tick=full((s,), _NEVER),
    )
    bufs = PbftBufs(pp=zi(d, n, w), prep_rt=zi(d, n, w), commit=zi(d, n, w), vc=zi(d, n))
    return state, bufs


def _scatter_drop(acc, idx, vals, reduce: str, ident: int):
    """``acc.at[idx].<reduce>(vals, mode="drop")``: torch's scatters raise on
    an out-of-bounds index instead of dropping it, so scatter into one extra
    identity slot at index ``len(acc)`` and cut it off."""
    s = acc.shape[0]
    ext = torch.cat([acc, acc.new_full((1,), ident)])
    ext.scatter_reduce_(0, idx, vals, reduce, include_self=True)
    return ext[:s]


def _scatter_window_events(acc_add, acc_max, acc_min, events, eff_sid, t, s):
    """Fold [N, W] first-commit / propose events into [S] accumulators via a
    per-window reduction: all nodes crossing a window this tick share its
    tenant, so per-window (count, slot-id) pairs are exact and the scatter is
    W updates, not N·W.  Invalid slot ids route to index ``s`` and drop."""
    cnt_w = events.sum(0, dtype=_I32)                          # [W]
    sid_w = torch.where(events, eff_sid, -1).amax(0)           # [W]
    valid = (sid_w >= 0) & (sid_w < s) & (cnt_w > 0)
    idx = torch.where(valid, sid_w, s).to(torch.int64)
    out = []
    if acc_add is not None:
        out.append(_scatter_drop(acc_add, idx, cnt_w, "sum", 0))
    if acc_max is not None:
        out.append(_scatter_drop(acc_max, idx, torch.where(cnt_w > 0, t, -1),
                                 "amax", -1))
    if acc_min is not None:
        out.append(_scatter_drop(acc_min, idx, torch.where(cnt_w > 0, t, _NEVER),
                                 "amin", _NEVER))
    return out


@dataclasses.dataclass(frozen=True)
class _TickConsts:
    ids: torch.Tensor       # [N] node ids
    windows: torch.Tensor   # [W] window indices
    zeros_rt: torch.Tensor  # [B2, N, W] skipped round-trip gate
    zeros_w: torch.Tensor   # [B, N, W] skipped commit / pre-prepare gates
    zeros_vc: torch.Tensor  # [B, N] skipped view-change gate


@functools.lru_cache(maxsize=8)
def _tick_consts(cfg, device) -> _TickConsts:
    """What ``step`` needs that depends only on the config and the device,
    made once per (config, device) rather than on every tick.  The zero
    tensors are the results of skipped gates: they are only ever read."""
    n, w = cfg.n, eff_window(cfg)
    lo, hi = cfg.one_way_range()
    rt_lo, rt_hi = cfg.roundtrip_range()
    return _TickConsts(
        ids=dv._global_ids(n, None, device),
        windows=torch.arange(w, dtype=_I32, device=device),
        zeros_rt=torch.zeros((rt_hi - rt_lo, n, w), dtype=_I32, device=device),
        zeros_w=torch.zeros((hi - lo, n, w), dtype=_I32, device=device),
        zeros_vc=torch.zeros((hi - lo, n), dtype=_I32, device=device),
    )


def step(cfg, state: PbftState, bufs: PbftBufs, t, tkey):
    """One tick.  ``t``: 0-d int32 tensor on the state's device; ``tkey``:
    the tick's threefry key (utils/prng.tick_key).  ``init`` has checked
    that the config is ported."""
    n, s = cfg.n, cfg.pbft_max_slots
    w = eff_window(cfg)
    exact = w == s
    lo, hi = cfg.one_way_range()
    rt_lo, _ = cfg.roundtrip_range()
    drop = cfg.faults.drop_prob
    clean = cfg.fidelity == "clean"
    stat = cfg.delivery == "stat"
    smode = cfg.eff_stat_sampler
    eimpl = cfg.eff_edge_sampler
    ow_probs = delay_ops.uniform_probs(lo, hi)
    rt_probs = delay_ops.roundtrip_probs(lo, hi)
    dev = state.v.device
    consts = _tick_consts(cfg, dev)
    ids, windows, zeros_w = consts.ids, consts.windows, consts.zeros_w
    ser = cfg.serialization_ticks(cfg.pbft_block_bytes)

    # ---- pop this tick's arrivals; crashed nodes process nothing ------------
    pp_t, pp = ring_pop(bufs.pp, t)
    prep_t, prep_rt = ring_pop(bufs.prep_rt, t)
    com_t, commit = ring_pop(bufs.commit, t)
    vc_t, vc = ring_pop(bufs.vc, t)
    am = state.alive.to(_I32)
    pp_t, prep_t, com_t = pp_t * am[:, None], prep_t * am[:, None], com_t * am[:, None]
    vc_t = vc_t * am

    # ---- VIEW_CHANGE arrivals: adopt (v, leader) ----------------------------
    has_vc = vc_t > 0
    v = torch.where(has_vc, (vc_t - 1) // n, state.v)
    leader = torch.where(has_vc, (vc_t - 1) % n, state.leader)

    # ---- PRE_PREPARE arrivals: evict stale tenant, store, broadcast PREPARE -
    got_pp = pp_t > 0  # [N, W] (any arrival re-broadcasts PREPARE, no dedup)
    arr_sid = pp_t - 1  # announced slot id
    new_tenant = got_pp & (arr_sid > state.slot_id)
    slot_id = torch.where(new_tenant, arr_sid, state.slot_id)
    if exact:
        # windows ARE slot identities: a learned tenant must not wipe counters
        prepare_vote, commit_vote = state.prepare_vote, state.commit_vote
        prep_sent, committed_w = state.prep_sent, state.committed_w
    else:
        # windowed mode: a higher slot id evicts the stale tenant's state
        prepare_vote = torch.where(new_tenant, 0, state.prepare_vote)
        commit_vote = torch.where(new_tenant, 0, state.commit_vote)
        prep_sent = state.prep_sent & ~new_tenant
        committed_w = state.committed_w & ~new_tenant
    seen_hi = torch.where(got_pp, arr_sid + 1, 0).amax(1)
    next_n = torch.maximum(state.next_n, seen_hi)

    # PREPARE broadcast → short-circuited round-trip PREPARE_RES replies from
    # honest, alive peers (Byzantine votes are FAILED, which nobody counts)
    voters = state.alive & state.honest
    prep_active = got_pp.any(1)
    got_pp_i = got_pp.to(_I32)
    k_rt = chan_key(tkey, Channel.DELAY_ROUNDTRIP)
    rt_contrib = gated(
        prep_active.any(),
        lambda: (
            dv.push_roundtrip_reply_counts_stat(
                k_rt, prep_active, voters.sum(dtype=_I32) - voters.to(_I32),
                rt_probs, drop,
                mode=smode,
                # replies are per broadcast, i.e. per active (node, window)
                expand=lambda c: c[:, None] * got_pp_i,
            ) if stat else
            dv.roundtrip_reply_counts_dense(
                k_rt, prep_active, lo, hi, drop, peer_mask=voters, impl=eimpl,
            )[:, :, None] * got_pp_i[None, :, :]
        ),
        consts.zeros_rt,
    )
    pushes = [(prep_rt, rt_lo, rt_contrib, "add")]

    # ---- PREPARE_RES arrivals → prepare_vote → COMMIT broadcast -------------
    pv = prepare_vote + prep_t
    crossed_p = (prep_t > 0) & (pv >= cfg.pbft_prepare_need)
    if clean:
        crossed_p = crossed_p & ~prep_sent
    prep_sent = prep_sent | crossed_p
    prepare_vote = torch.where(crossed_p, 0, pv)  # reset on threshold (quirk #4)

    bt = cfg.pbft_block_interval_ms
    is_block_tick = (t % bt == 0) & (t > 0)
    commit_mat = (crossed_p & voters[:, None]).to(_I32)
    if cfg.faults.byz_forge and cfg.faults.n_byzantine > 0:
        # forgers flood COMMIT votes for the never-proposed last slot; a
        # "2f1" receiver counts one vote per sender ever (a single send)
        if cfg.quorum_rule == "2f1":
            fire, copies = t == bt, 1
        else:
            fire, copies = is_block_tick, cfg.faults.byz_copies
        forgers = (state.alive & ~state.honest).to(_I32) * fire.to(_I32)
        commit_mat[:, w - 1] += forgers * copies
    k_cm = chan_key(tkey, Channel.DELAY_BCAST)
    cm_contrib = gated(
        (commit_mat > 0).any(),
        lambda: (
            dv.push_bcast_slots_stat(k_cm, commit_mat, ow_probs, drop, mode=smode)
            if stat else
            dv.bcast_slots_dense(k_cm, commit_mat, lo, hi, drop, impl=eimpl)
        ),
        zeros_w,
    )
    pushes.append((commit, lo, cm_contrib, "add"))

    # ---- COMMIT arrivals → commit_vote → finality ---------------------------
    cv = commit_vote + com_t
    crossed_c = (com_t > 0) & (cv >= cfg.pbft_commit_need)
    if clean:
        crossed_c = crossed_c & ~committed_w
    commit_vote = torch.where(crossed_c, 0, cv)
    first_commit = crossed_c & ~committed_w
    committed_w = committed_w | crossed_c
    block_num = state.block_num + crossed_c.sum(1, dtype=_I32)
    # exact mode: an unknown tenant can only be window w itself (identity map)
    eff_sid = torch.where(slot_id >= 0, slot_id, windows[None, :] if exact else -1)
    unattributed = state.unattributed + (first_commit & (eff_sid < 0)).sum(1, dtype=_I32)
    slot_commits, slot_commit_tick = _scatter_window_events(
        state.slot_commits, state.slot_commit_tick, None,
        first_commit, eff_sid, t, s,
    )

    # ---- timers: leader block broadcast every block interval ----------------
    send_block = (
        is_block_tick
        & (leader == ids)
        & (next_n < min(cfg.pbft_max_rounds, s))
        & state.alive
    )
    any_block = bool(send_block.any())  # one host read serves both gates below
    own_w = next_n % w
    own_onehot = (windows[None, :] == own_w[:, None]) & send_block[:, None]
    # the proposer learns its own window's tenant (it never hears its own
    # PRE_PREPARE); exact mode keeps the counters, as at pp arrival above
    slot_id = torch.where(own_onehot, next_n[:, None], slot_id)
    if not exact:
        prepare_vote = torch.where(own_onehot, 0, prepare_vote)
        commit_vote = torch.where(own_onehot, 0, commit_vote)
        prep_sent = prep_sent & ~own_onehot
        committed_w = committed_w & ~own_onehot
    pp_val = own_onehot.to(_I32) * (next_n[:, None] + 1)
    k_pp = chan_key(tkey, Channel.DELAY_BCAST2)
    pp_contrib = gated(
        any_block,
        lambda: (
            dv.bcast_window_value_max_stat(k_pp, pp_val, ow_probs, drop)
            if stat else
            dv.bcast_window_value_max_dense(k_pp, pp_val, lo, hi, drop, impl=eimpl)
        ),
        zeros_w,
    )
    pushes.append((pp, lo + ser, pp_contrib, "max"))
    rounds_sent = state.rounds_sent + send_block
    (slot_propose_tick,) = _scatter_window_events(
        None, None, state.slot_propose_tick,
        own_onehot, torch.where(own_onehot, next_n[:, None], -1), t, s,
    )
    next_n = next_n + send_block

    # ---- random view change (P = num/den per leader round) ------------------
    # The JAX package draws u every tick; only senders read it, so with no
    # sender this tick the draw is skipped (keys are per tick and channel, so
    # skipping consumes nothing) and trigger is all-false either way.
    if any_block:
        u = threefry.randint(chan_key(tkey, Channel.VIEW_CHANGE), (n,), 0,
                             cfg.pbft_view_change_den, dev)
        trigger = send_block & (u < cfg.pbft_view_change_num)
    else:
        trigger = torch.zeros_like(send_block)
    new_leader = (leader + 1) % n  # rotation
    new_v = v + 1
    leader = torch.where(trigger, new_leader, leader)
    v = torch.where(trigger, new_v, v)
    view_changes = state.view_changes + trigger
    enc = torch.where(trigger, new_v * n + new_leader + 1, 0)
    k_vc = chan_key(tkey, Channel.DELAY_REPLY)
    vc_contrib = gated(
        any_block and trigger.any(),
        lambda: (
            dv.bcast_value_max_stat(k_vc, enc, ow_probs, drop)
            if stat else
            dv.bcast_value_max_dense(k_vc, trigger, enc, lo, hi, drop, impl=eimpl)
        ),
        consts.zeros_vc,
    )
    pushes.append((vc, lo, vc_contrib, "max"))
    ring_push_group(pushes, t)  # in place on all four rings

    state = dataclasses.replace(
        state,
        v=v,
        leader=leader,
        next_n=next_n,
        rounds_sent=rounds_sent,
        slot_id=slot_id,
        prepare_vote=prepare_vote,
        commit_vote=commit_vote,
        prep_sent=prep_sent,
        committed_w=committed_w,
        block_num=block_num,
        unattributed=unattributed,
        view_changes=view_changes,
        slot_commits=slot_commits,
        slot_commit_tick=slot_commit_tick,
        slot_propose_tick=slot_propose_tick,
    )
    return state, PbftBufs(pp=pp, prep_rt=prep_rt, commit=commit, vc=vc)


def metrics(cfg, state: PbftState) -> dict:
    """The reference's measurement surface, recomputed on the host from the
    per-slot accumulators (same arithmetic as the JAX package)."""
    def host(x):
        return x.detach().cpu().numpy()

    alive = host(state.alive)
    n_alive = int(alive.sum())
    commits = host(state.slot_commits)
    commit_tick = host(state.slot_commit_tick)
    propose_tick = host(state.slot_propose_tick)
    proposed = propose_tick < _NEVER
    # a slot is final when every alive node finalized it
    per_slot_done = (commits >= max(n_alive, 1)) & (n_alive > 0) & proposed
    n_final = int(per_slot_done.sum())
    last = commit_tick[per_slot_done].max() if n_final else -1
    rounds = int(host(state.next_n).max())
    ttf = [
        float(commit_tick[s] - propose_tick[s])
        for s in range(min(rounds, len(commits)))
        if per_slot_done[s]
    ]
    # a slot some alive node finalized although no node proposed it can only
    # come from forged votes reaching quorum
    forged_commits = int(((commits > 0) & ~proposed).sum())
    unattributed = int(host(state.unattributed).sum())
    return {
        "protocol": "pbft",
        "n": cfg.n,
        "rounds_sent": rounds,
        "forged_commits": forged_commits,
        "unattributed_commits": unattributed,
        "leader_rounds_max": int(host(state.rounds_sent).max()),
        "blocks_final_all_nodes": n_final,
        "block_num_max": int(host(state.block_num).max()),
        "view_changes": int(host(state.view_changes).sum()),
        "last_commit_ms": float(last),
        "mean_time_to_finality_ms": float(np.mean(ttf)) if ttf else -1.0,
        "agreement_ok": bool(forged_commits == 0 and unattributed == 0),
    }
