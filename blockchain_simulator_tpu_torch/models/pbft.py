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
and Byzantine masks, ``byz_forge``, both fidelities, both quorum rules, the
windowed vote table (``pbft_window < pbft_max_slots``), queued links
(blocks ride per-destination serial-pipe FIFOs, ``ppq_*``, instead of the
pre-prepare ring) and the gossip topology (PRE_PREPARE and VIEW_CHANGE
flood over the random k-out digraph of ops/topology.py with a hop TTL,
deduplicated by the ``seen_pp`` / ``seen_vc`` registers; votes stay direct;
exact vote table only), the kregular overlay (every channel delivers direct
over the circulant in/out tables of topo/spec.py through the gather
primitives of ops/gatherdeliv.py: O(N·K) a tick, equal to the full mesh at
degree k = N-1) and the committee hierarchy's inner runs (the full mesh at
the committee's size, topo/committee.py).  Node-sharded (``mesh_axis``
set, parallel/shard.py): the state holds this rank's rows, the delivery
functions globalize sender-side quantities over the bound mesh, every gate
and host read is agreed over the ranks, and :func:`finalize` combines the
per-rank slot accumulators; the sharded overlay reads its neighbours'
rows through the exchange (``exchange``, parallel/partition.py).

*Lanes* (models/base.py): a state of ``[L, N, ...]`` fields with rings
``[D, L, N, ...]`` and lane keys ``[L, 2]`` steps ``L`` runs at once on
the full mesh, gossip, queued links and the kregular overlay (unsharded).
Every reduction the JAX step makes to a scalar is a per-lane reduction
here (``jax.vmap`` of it); the tick's host reads are the single run's,
each "any lane".  A lane whose gate is shut contributes zeros by
construction: every gated contribution is a product with its gate's
sender mask.

PyTorch idiom: state and rings are mutable tensors.  The rings are updated in
place (ops/ring.py), and ``t`` is a one-element int32 tensor on the device.
Gates read their predicate back to the host (models/base.gated).  Each ring
is popped once at the top of a tick and pushed once; nothing reads a ring
between its push and the end of the tick, so the four pushes (three with
queued links) are collected and applied together at the end, in one kernel
launch on the card.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from blockchain_simulator_tpu_torch.models.base import fault_masks, gated
from blockchain_simulator_tpu_torch.ops import delay as delay_ops
from blockchain_simulator_tpu_torch.ops import delivery as dv
from blockchain_simulator_tpu_torch.ops import gatherdeliv as gd
from blockchain_simulator_tpu_torch.ops import topology
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
    link_busy: torch.Tensor     # [N] queued links: busy-until tick per destination
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


def init(cfg, key=None, *, device, rows=None):
    """``(PbftState, PbftBufs)`` on ``device``; ``rows=(start, count)``
    builds only those node rows (a rank's block of a sharded run), the
    per-slot accumulators whole."""
    del key  # the fault masks are deterministic, as in the JAX package
    n, s = cfg.n, cfg.pbft_max_slots
    start, nl = (0, n) if rows is None else rows
    w = eff_window(cfg)
    d = cfg.ring_depth
    if cfg.topology == "gossip" and w < s:
        raise ValueError(
            "pbft gossip (topology='gossip') requires exact vote-table mode "
            "(pbft_window = 0 or >= pbft_max_slots): a multi-hop PRE_PREPARE "
            "can trail its slot's direct-unicast COMMIT votes, which exact "
            "mode attributes by window identity while a window would misfile"
        )
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
    alive, honest = (m[start:start + nl] for m in fault_masks(cfg, n, device))

    def zi(*sh):
        return torch.zeros(sh, dtype=_I32, device=device)

    def full(sh, val):
        return torch.full(sh, val, dtype=_I32, device=device)

    def zb(*sh):
        return torch.zeros(sh, dtype=torch.bool, device=device)

    q = queue_len(cfg)
    state = PbftState(
        v=torch.ones((nl,), dtype=_I32, device=device),
        leader=zi(nl),
        next_n=zi(nl),
        rounds_sent=zi(nl),
        slot_id=full((nl, w), -1),
        prepare_vote=zi(nl, w),
        commit_vote=zi(nl, w),
        prep_sent=zb(nl, w),
        committed_w=zb(nl, w),
        block_num=zi(nl),
        unattributed=zi(nl),
        view_changes=zi(nl),
        alive=alive,
        honest=honest,
        seen_pp=zi(nl, w),
        seen_vc=zi(nl),
        link_busy=zi(nl),
        ppq_tick=full((nl, q), _NEVER),
        ppq_val=zi(nl, q),
        slot_commits=zi(s),
        slot_commit_tick=full((s,), -1),
        slot_propose_tick=full((s,), _NEVER),
    )
    bufs = PbftBufs(pp=zi(d, nl, w), prep_rt=zi(d, nl, w), commit=zi(d, nl, w), vc=zi(d, nl))
    return state, bufs


def push_members(cfg) -> tuple:
    """``(ring, op, B, lo)`` of the ring pushes of one tick, in the order
    ``step`` collects them: every tick launches this group (queued links
    leave ``pp`` out, its blocks riding the FIFOs)."""
    lo, hi = cfg.one_way_range()
    rt_lo, rt_hi = cfg.roundtrip_range()
    ser = cfg.serialization_ticks(cfg.pbft_block_bytes)
    members = [("prep_rt", "add", rt_hi - rt_lo, rt_lo), ("commit", "add", hi - lo, lo),
               ("pp", "max", hi - lo, lo + ser), ("vc", "max", hi - lo, lo)]
    if cfg.queued_links and ser > 0:
        members.pop(2)
    return tuple(members)


def finalize(state: PbftState, axis) -> PbftState:
    """Combine the per-shard slot accumulators (once, after the run)."""
    if axis is None:
        return state
    return dataclasses.replace(
        state,
        slot_commits=dv._psum(state.slot_commits, axis),
        slot_commit_tick=dv._pmax(state.slot_commit_tick, axis),
        slot_propose_tick=dv._pmin(state.slot_propose_tick, axis),
    )


def _scatter_drop(acc, idx, vals, reduce: str, ident: int):
    """``acc.at[idx].<reduce>(vals, mode="drop")`` along the last axis:
    torch's scatters raise on an out-of-bounds index instead of dropping it,
    so scatter into one extra identity slot at index ``acc.shape[-1]`` and
    cut it off.  A leading lane axis scatters each lane's row on its own
    (``jax.vmap`` of the JAX update)."""
    s = acc.shape[-1]
    ext = torch.cat([acc, acc.new_full(acc.shape[:-1] + (1,), ident)], -1)
    ext.scatter_reduce_(-1, idx, vals, reduce, include_self=True)
    return ext[..., :s]


def _scatter_window_events(acc_add, acc_max, acc_min, events, eff_sid, t, s):
    """Fold [N, W] first-commit / propose events into [S] accumulators via a
    per-window reduction: all nodes crossing a window this tick share its
    tenant, so per-window (count, slot-id) pairs are exact and the scatter is
    W updates, not N·W.  Invalid slot ids route to index ``s`` and drop.
    Lanes: ``[L, N, W]`` events into ``[L, S]`` accumulators, lane by lane."""
    cnt_w = events.sum(-2, dtype=_I32)                         # [W]
    sid_w = torch.where(events, eff_sid, -1).amax(-2)          # [W]
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
    windows: torch.Tensor   # [W] window indices
    zeros_rt: torch.Tensor  # [B2, N, W] skipped round-trip gate
    zeros_w: torch.Tensor   # [B, N, W] skipped commit / pre-prepare gates
    zeros_vc: torch.Tensor  # [B, N] skipped view-change gate


@functools.lru_cache(maxsize=8)
def _tick_consts(cfg, device, lead: tuple) -> _TickConsts:
    """What ``step`` needs that depends only on the config, the device and
    the state's leading shape ``lead`` (``(N,)``, or ``(L, N)`` with lanes),
    made once per (config, device, shape) rather than on every tick.  The
    zero tensors are the results of skipped gates: they are only ever
    read."""
    w = eff_window(cfg)
    lo, hi = cfg.one_way_range()
    rt_lo, rt_hi = cfg.roundtrip_range()
    return _TickConsts(
        windows=torch.arange(w, dtype=_I32, device=device),
        zeros_rt=torch.zeros((rt_hi - rt_lo,) + lead + (w,), dtype=_I32, device=device),
        zeros_w=torch.zeros((hi - lo,) + lead + (w,), dtype=_I32, device=device),
        zeros_vc=torch.zeros((hi - lo,) + lead, dtype=_I32, device=device),
    )


def step(cfg, state: PbftState, bufs: PbftBufs, t, tkey, *, topo_tables=None,
         exchange=None):
    """One tick.  ``t``: 0-d int32 tensor on the state's device; ``tkey``:
    the tick's threefry key (utils/prng.tick_key), or lane keys ``[L, 2]``
    for a lane-stacked state (module docstring).  ``init`` has checked
    that the config is ported.  ``topo_tables``: the kregular overlay's
    ``(in, out)`` tables when the caller holds them
    (runner.make_topo_dyn_sim_fn), else the config's own; ``exchange``:
    the sharded overlay's neighbour exchange, whose tables are already
    this rank's rows."""
    n, s = cfg.n, cfg.pbft_max_slots
    w = eff_window(cfg)
    exact = w == s
    axis = cfg.mesh_axis
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
    n_loc = state.v.shape[-1]
    consts = _tick_consts(cfg, dev, tuple(state.v.shape))
    ids, windows, zeros_w = dv._global_ids(n_loc, axis, dev), consts.windows, consts.zeros_w
    ser = cfg.serialization_ticks(cfg.pbft_block_bytes)

    # ---- pop this tick's arrivals; crashed nodes process nothing ------------
    pp_t, pp = ring_pop(bufs.pp, t)
    prep_t, prep_rt = ring_pop(bufs.prep_rt, t)
    com_t, commit = ring_pop(bufs.commit, t)
    vc_t, vc = ring_pop(bufs.vc, t)
    am = state.alive.to(_I32)
    pp_t, prep_t, com_t = (pp_t * am[..., None], prep_t * am[..., None],
                           com_t * am[..., None])
    vc_t = vc_t * am

    # queued links: this tick's serial-link block deliveries.  A destination
    # can receive two blocks in one tick (a view change frees the new
    # leader's links while an old-leader block is still backlogged), so
    # every hit lands in its own window (exact mode: window == slot)
    queued = cfg.queued_links and ser > 0
    ppq_tick, ppq_val, link_busy = state.ppq_tick, state.ppq_val, state.link_busy
    if queued:
        hits = ppq_tick == t  # [N, Q]
        vals = torch.where(hits & state.alive[..., None], ppq_val, 0)
        ppq_tick = torch.where(hits, _NEVER, ppq_tick)
        oh_arr = ((((vals - 1) % w)[..., None] == windows)
                  & (vals > 0)[..., None])  # [N, Q, W]
        pp_t = torch.maximum(pp_t, torch.where(oh_arr, vals[..., None], 0).amax(-2))

    # ---- gossip decode: PRE_PREPARE and VIEW_CHANGE flood with a hop TTL
    # (value * H + hops_left, H = gossip_hops + 1); a node processes each
    # base value once (first sighting) but forwards any strictly better TTL
    # copy, so a nearly-expired first arrival cannot truncate the flood
    gossip = cfg.topology == "gossip"
    seen_pp, seen_vc = state.seen_pp, state.seen_vc
    if gossip:
        h_enc = cfg.gossip_hops + 1
        nbrs = topology.neighbours(n, cfg.degree, cfg.seed, dev)
        if axis is not None:
            nbrs = nbrs.index_select(0, ids.to(torch.int64))
        pp_base, pp_hops = pp_t // h_enc, pp_t % h_enc
        better = (pp_t > seen_pp) & state.alive[..., None]
        new_base = (pp_base > seen_pp // h_enc) & state.alive[..., None]
        seen_pp = torch.maximum(seen_pp, pp_t * better)
        pp_fwd = ((pp_base * h_enc + torch.clamp(pp_hops - 1, min=0))
                  * (better & (pp_hops > 0)))
        pp_t = pp_base * new_base  # first sighting processes (value = slot+1)
        vc_base, vc_hops = vc_t // h_enc, vc_t % h_enc
        vbetter = (vc_t > seen_vc) & state.alive
        vnew = (vc_base > seen_vc // h_enc) & state.alive
        seen_vc = torch.maximum(seen_vc, vc_t * vbetter)
        vc_fwd = ((vc_base * h_enc + torch.clamp(vc_hops - 1, min=0))
                  * (vbetter & (vc_hops > 0)))
        vc_t = vc_base * vnew

    # kregular overlay: every channel delivers direct over the in/out tables
    # (no relay, no dedup state); with k below the commit quorum a node can
    # never hear enough votes, a stalling but valid scenario
    kreg = cfg.topology == "kregular"
    if kreg:
        # unsharded, or with the exchange (whose operands ARE this rank's
        # rows), the tables pass through whole; sharded, this rank's rows
        nbr_in, nbr_out = gd.local_tables(
            cfg, None if axis is None or exchange is not None else ids,
            tables=topo_tables, device=dev)

    # ---- VIEW_CHANGE arrivals: adopt (v, leader) ----------------------------
    has_vc = vc_t > 0
    v = torch.where(has_vc, (vc_t - 1) // n, state.v)
    leader = torch.where(has_vc, (vc_t - 1) % n, state.leader)
    if queued:
        # leadership rotated: the new leader's links carry votes only, hence
        # are free; its busy registers start fresh
        link_busy = torch.where(dv._pmax(has_vc.any(-1, keepdim=True), axis), 0, link_busy)

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
    seen_hi = torch.where(got_pp, arr_sid + 1, 0).amax(-1)
    next_n = torch.maximum(state.next_n, seen_hi)

    # PREPARE broadcast → short-circuited round-trip PREPARE_RES replies from
    # honest, alive peers (Byzantine votes are FAILED, which nobody counts)
    voters = state.alive & state.honest
    prep_active = got_pp.any(-1)
    got_pp_i = got_pp.to(_I32)
    k_rt = chan_key(tkey, Channel.DELAY_ROUNDTRIP)

    def prep_replies():
        if stat:
            # the overlay swaps only the per-sender peer count: a gather
            # over the out-table instead of total-minus-self
            n_peers = (gd.out_counts(voters, nbr_out, ids, axis, exchange) if kreg
                       else dv._psum(voters.sum(-1, keepdim=True, dtype=_I32), axis)
                       - voters.to(_I32))
            return dv.push_roundtrip_reply_counts_stat(
                k_rt, prep_active, n_peers, rt_probs, drop, axis=axis, mode=smode,
                # replies are per broadcast, i.e. per active (node, window)
                expand=lambda c: c[..., None] * got_pp_i)
        rt = (gd.roundtrip_reply_counts_kreg(k_rt, prep_active, nbr_out, ids, lo, hi, drop,
                                             peer_mask=voters, axis=axis, impl=eimpl,
                                             xg=exchange)
              if kreg else
              dv.roundtrip_reply_counts_dense(k_rt, prep_active, lo, hi, drop,
                                              peer_mask=voters, axis=axis, impl=eimpl))
        return rt[..., None] * got_pp_i[None]


    # ---- PREPARE_RES arrivals → prepare_vote → COMMIT broadcast -------------
    pv = prepare_vote + prep_t
    crossed_p = (prep_t > 0) & (pv >= cfg.pbft_prepare_need)
    if clean:
        crossed_p = crossed_p & ~prep_sent
    prep_sent = prep_sent | crossed_p
    prepare_vote = torch.where(crossed_p, 0, pv)  # reset on threshold (quirk #4)

    bt = cfg.pbft_block_interval_ms
    is_block_tick = (t % bt == 0) & (t > 0)
    commit_mat = (crossed_p & voters[..., None]).to(_I32)
    if cfg.faults.byz_forge and cfg.faults.n_byzantine > 0:
        # forgers flood COMMIT votes for the never-proposed last slot; a
        # "2f1" receiver counts one vote per sender ever (a single send)
        if cfg.quorum_rule == "2f1":
            fire, copies = t == bt, 1
        else:
            fire, copies = is_block_tick, cfg.faults.byz_copies
        forgers = (state.alive & ~state.honest).to(_I32) * fire.to(_I32)
        commit_mat[..., w - 1] += forgers * copies
    k_cm = chan_key(tkey, Channel.DELAY_BCAST)

    def commits():
        if kreg:
            return (gd.push_bcast_slots_stat_kreg(k_cm, commit_mat, nbr_in, ids, ow_probs,
                                                  drop, axis=axis, mode=smode, xg=exchange)
                    if stat else
                    gd.bcast_slots_kreg(k_cm, commit_mat, nbr_in, ids, lo, hi, drop,
                                        axis=axis, impl=eimpl, xg=exchange))
        return (dv.push_bcast_slots_stat(k_cm, commit_mat, ow_probs, drop, axis=axis,
                                         mode=smode)
                if stat else
                dv.bcast_slots_dense(k_cm, commit_mat, lo, hi, drop, axis=axis,
                                     impl=eimpl))


    # ---- COMMIT arrivals → commit_vote → finality ---------------------------
    cv = commit_vote + com_t
    crossed_c = (com_t > 0) & (cv >= cfg.pbft_commit_need)
    if clean:
        crossed_c = crossed_c & ~committed_w
    commit_vote = torch.where(crossed_c, 0, cv)
    first_commit = crossed_c & ~committed_w
    committed_w = committed_w | crossed_c
    block_num = state.block_num + crossed_c.sum(-1, dtype=_I32)
    # exact mode: an unknown tenant can only be window w itself (identity map)
    eff_sid = torch.where(slot_id >= 0, slot_id, windows if exact else -1)
    unattributed = state.unattributed + (first_commit & (eff_sid < 0)).sum(-1, dtype=_I32)
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
    # the tick's one host read (agreed over the ranks) serves the PREPARE
    # and COMMIT gates and both block-tick gates below
    rt_on, cm_on, any_block = dv._pmax(torch.stack(
        [prep_active.any(), (commit_mat > 0).any(), send_block.any()]), axis).tolist()
    pushes = [(prep_rt, rt_lo, prep_replies() if rt_on else consts.zeros_rt, "add"),
              (commit, lo, commits() if cm_on else zeros_w, "add")]
    own_w = next_n % w
    own_onehot = (windows == own_w[..., None]) & send_block[..., None]
    # the proposer learns its own window's tenant (it never hears its own
    # PRE_PREPARE); exact mode keeps the counters, as at pp arrival above
    slot_id = torch.where(own_onehot, next_n[..., None], slot_id)
    if not exact:
        prepare_vote = torch.where(own_onehot, 0, prepare_vote)
        commit_vote = torch.where(own_onehot, 0, commit_vote)
        prep_sent = prep_sent & ~own_onehot
        committed_w = committed_w & ~own_onehot
    pp_val = own_onehot.to(_I32) * (next_n[..., None] + 1)
    k_pp = chan_key(tkey, Channel.DELAY_BCAST2)
    if queued:
        if any_block:  # with no sender nothing is enqueued and nothing drawn
            ppq_tick, ppq_val, link_busy = _enqueue_blocks(
                cfg, send_block, next_n, ids, ppq_tick, ppq_val, link_busy, t, k_pp,
                axis)
        # the blocks ride the serial pipes: the pp ring is not pushed
    elif gossip:
        # origin injection (TTL = gossip_hops) + this tick's relays, one
        # flood push over the out-edges; every hop re-serializes the block
        # (store-and-forward), hence the ser term on each leg.  The proposer
        # marks its own copy seen: it must never process its own
        # announcement, and the digraph has self-loops
        origin_enc = (pp_val * h_enc + cfg.gossip_hops) * (pp_val > 0)
        seen_pp = torch.maximum(seen_pp, origin_enc)
        pp_out = torch.maximum(origin_enc, pp_fwd)
    else:
        def blocks():
            if kreg:
                return (gd.bcast_window_value_max_stat_kreg(k_pp, pp_val, nbr_in, ow_probs,
                                                            drop, axis=axis, xg=exchange)
                        if stat else
                        gd.bcast_window_value_max_kreg(k_pp, pp_val, nbr_in, ids, lo, hi,
                                                       drop, axis=axis, impl=eimpl,
                                                       xg=exchange))
            return (dv.bcast_window_value_max_stat(k_pp, pp_val, ow_probs, drop, axis=axis)
                    if stat else
                    dv.bcast_window_value_max_dense(k_pp, pp_val, lo, hi, drop, axis=axis,
                                                    impl=eimpl))

        pp_contrib = gated(any_block, blocks, zeros_w)
        pushes.append((pp, lo + ser, pp_contrib, "max"))
    rounds_sent = state.rounds_sent + send_block
    (slot_propose_tick,) = _scatter_window_events(
        None, None, state.slot_propose_tick,
        own_onehot, torch.where(own_onehot, next_n[..., None], -1), t, s,
    )
    next_n = next_n + send_block

    # ---- random view change (P = num/den per leader round) ------------------
    # The JAX package draws u every tick; only senders read it, so with no
    # sender this tick the draw is skipped (keys are per tick and channel, so
    # skipping consumes nothing) and trigger is all-false either way.
    if any_block:
        with dv.draw_rows(axis):
            u = threefry.randint(dv._shard_key(chan_key(tkey, Channel.VIEW_CHANGE), axis),
                                 (n_loc,), 0, cfg.pbft_view_change_den, dev)
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
    if gossip:
        vc_origin = (enc * h_enc + cfg.gossip_hops) * (enc > 0)
        seen_vc = torch.maximum(seen_vc, vc_origin)  # self-loop guard
        vc_out = torch.maximum(vc_origin, vc_fwd)
        # both floods' gates in one host read (agreed over the ranks)
        pp_on, vc_on = dv._pmax(torch.stack([pp_out.any(), vc_out.any()]), axis).tolist()
        pp_contrib = gated(
            pp_on,
            lambda: dv.gossip_fwd(k_pp, pp_out, nbrs, n, lo, hi, drop, axis=axis,
                                  impl=eimpl),
            zeros_w,
        )
        pushes.append((pp, lo + ser, pp_contrib, "max"))
        vc_contrib = gated(
            vc_on,
            lambda: dv.gossip_fwd(k_vc, vc_out[..., None], nbrs, n, lo, hi, drop, axis=axis,
                                  impl=eimpl)[..., 0],
            consts.zeros_vc,
        )
    else:
        def view_changes_sent():
            if kreg:
                return (gd.bcast_value_max_stat_kreg(k_vc, enc, nbr_in, ow_probs, drop,
                                                     axis=axis, xg=exchange)
                        if stat else
                        gd.bcast_value_max_kreg(k_vc, trigger, enc, nbr_in, ids, lo, hi,
                                                drop, axis=axis, impl=eimpl, xg=exchange))
            return (dv.bcast_value_max_stat(k_vc, enc, ow_probs, drop, axis=axis)
                    if stat else
                    dv.bcast_value_max_dense(k_vc, trigger, enc, lo, hi, drop, axis=axis,
                                             impl=eimpl))

        # with no block sender there is no trigger: no read, on any rank
        vc_contrib = gated(any_block and dv.agree(trigger.any(), axis), view_changes_sent,
                           consts.zeros_vc)
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
        seen_pp=seen_pp,
        seen_vc=seen_vc,
        link_busy=link_busy,
        ppq_tick=ppq_tick,
        ppq_val=ppq_val,
        slot_commits=slot_commits,
        slot_commit_tick=slot_commit_tick,
        slot_propose_tick=slot_propose_tick,
    )
    return state, PbftBufs(pp=pp, prep_rt=prep_rt, commit=commit, vc=vc)


def _enqueue_blocks(cfg, send_block, next_n, ids, ppq_tick, ppq_val, link_busy, t,
                    k_pp, axis=None):
    """Serial-pipe send (the C++ engine's link_enqueue): the block reaches
    the (leader -> j) link after its scheduling delay ``d_j - prop``,
    transmits once the link is free, occupies it ``ser`` ticks, then
    propagates.  Each destination's delivery goes into the lowest free FIFO
    slot, never an occupied one (the FIFO holds ``queue_len`` entries, which
    the backlog cannot outgrow).  Returns ``(ppq_tick, ppq_val,
    link_busy)``."""
    lo, hi = cfg.one_way_range()
    ser = cfg.serialization_ticks(cfg.pbft_block_bytes)
    prop = cfg.link_delay_ms
    # one block sender (runner._reject_cpp_only): its scalars globalize
    # with a MAX over the ranks
    val_sent = dv._pmax(torch.where(send_block, next_n + 1, 0).amax(-1, keepdim=True), axis)
    sender = dv._pmax(torch.where(send_block, ids, -1).amax(-1, keepdim=True), axis)
    dest = (val_sent > 0) & (ids != sender)  # crashed peers get it and ignore it
    d_j = threefry.randint(dv._shard_key(k_pp, axis), (ids.shape[0],), lo, hi, ids.device)
    start = torch.maximum(t + d_j - prop, link_busy)
    delivery = start + ser + prop
    link_busy = torch.where(dest, start + ser, link_busy)
    free = ppq_tick == _NEVER  # [N, Q]
    first_free = free.to(torch.uint8).argmax(-1)  # lowest free slot (0 if none)
    slots = torch.arange(free.shape[-1], device=free.device)
    oh_q = (slots == first_free[..., None]) & dest[..., None] & free
    return (torch.where(oh_q, delivery[..., None], ppq_tick),
            torch.where(oh_q, val_sent[..., None], ppq_val), link_busy)


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
