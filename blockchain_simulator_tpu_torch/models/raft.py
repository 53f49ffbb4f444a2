"""Raft consensus — the tensorized per-tick engine, in PyTorch.

Port of ``blockchain_simulator_tpu/models/raft.py`` (whose docstring holds
the design: randomized election timers become per-node deadline registers,
vote requests ride an identity-preserving ``[D, N, N]`` matrix ring in edge
mode or a max-combined candidate-id ring in stat mode, the leader's 50 ms
heartbeats carry 20 KB proposals once ``setProposal`` fires, and proposal
acks are short-circuited round trips).  Same state fields, same int32
arithmetic, same threefry keys per (tick, channel): a run is bit-equal to the
JAX package's.

Ported arms: the full mesh with edge (``"threefry"`` or ``"rbg"`` delays) or
stat (``"exact"`` or ``"normal"`` bucket counts) delivery, both fidelities,
drops, crash and Byzantine masks, queued links (proposals serialize on
the leader's per-destination links; deliveries land on the rings at dynamic
offsets), and the gossip topology (clean fidelity, stat delivery: VOTE_REQ,
plain HEARTBEAT and proposal HEARTBEAT flood over the random k-out digraph
of ops/topology.py with a hop TTL and per-channel ``seen`` registers; votes
and proposal acks go direct to the decoded originator, acks generated at
flood arrival; votes go to the newest election seen, and a leader steps
down on seeing a newer election than its own, ``my_base``), and the
kregular overlay (every channel direct over the circulant tables of
topo/spec.py through ops/gatherdeliv.py: broadcasts reach out-neighbours,
replies gather back requester-side, the edge arm's ``vreq`` ring is
``[D, N, K]`` with the sender identity in the in-slot; equal to the full
mesh at degree k = N-1).  Node-sharded (``mesh_axis`` set,
parallel/shard.py): the state holds this rank's rows, sender-side
quantities are globalized over the bound mesh (ops/delivery.py), and every
host read whose branch holds a collective is agreed over the ranks; a
branch with only local work (a re-armed timer's draw) reads its own rows.

*Shards.*  ``init`` given lane keys ``[S, 2]`` builds ``S`` independent
instances side by side, ``jax.vmap(raft.init)`` over the keys (the mixed
shard sim, models/mixed.py): every state field gets a leading shard axis
``[S, N, ...]``, and the rings are laid out slot-major, ``[D, S, N]``
(``[D, S, N, N]`` for the edge ``vreq``), so each channel stays ONE ring
and the tick's push group keeps one member a channel, of length ``S·N``.
``step`` then takes the tick's lane keys ``[S, 2]`` and is ``jax.vmap`` of
the JAX step: every gate is one host read of "any shard live", and under
it a shard whose own gate is shut keeps exactly what the JAX shut branch
returns (``vmap`` lowers ``lax.cond`` to a select), by an explicit
``where``.  The host reads a tick stay the single instance's.  The same
form is the tick engine's lane axis (models/base.py): a batch of runs side
by side, on every arm (full mesh, queued links, gossip, kregular;
unsharded).

PyTorch idiom, as in models/pbft.py: state and rings are mutable tensors, the
rings are updated in place, and ``t`` is a one-element int32 tensor on the
device.  JAX's ``lax.cond`` gates become host branches; a step reads the host
four times (three in reference fidelity): heartbeat arrivals (the clean
timer re-arm), vote requests, election fires, and heartbeat sends (plain and
proposal in one read).  Over gossip the last read takes the three floods'
and the acks' gates together, and a fifth reads whether a leader steps
down.  A skipped branch would have produced exactly what its gate leaves
(zeros; the keys are pure functions of seed, tick and channel, so skipping
consumes nothing).  Each ring is popped once at the top
of the tick and pushed at most once; nothing reads a ring between its push
and the end of the tick, so the pushes are collected and applied in one
kernel launch at the end.  A member whose gate was skipped is left out of the
group: its contribution is all zeros, and adding 0 or max-combining 0 into a
ring whose values are all >= 0 changes nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from blockchain_simulator_tpu_torch.models.base import fault_masks
from blockchain_simulator_tpu_torch.ops import delay as delay_ops
from blockchain_simulator_tpu_torch.ops import delivery as dv
from blockchain_simulator_tpu_torch.ops import gatherdeliv as gd
from blockchain_simulator_tpu_torch.ops import topology
from blockchain_simulator_tpu_torch.ops.ring import ring_pop, ring_push_group
from blockchain_simulator_tpu_torch.utils import threefry
from blockchain_simulator_tpu_torch.utils.prng import Channel, chan_key

# Timer sentinel: "canceled".  Any tick comparison against it is false for
# the whole simulation horizon.
DISARM = 1 << 30
_I32 = torch.int32


@dataclasses.dataclass
class RaftState:
    is_leader: torch.Tensor      # [N] bool
    has_voted: torch.Tensor      # [N] bool — single vote latch (no terms)
    election_deadline: torch.Tensor  # [N] tick of next sendVote; DISARM = canceled
    vote_success: torch.Tensor   # [N] election SUCCESS replies received
    vote_failed: torch.Tensor    # [N] election FAILED replies received
    next_hb: torch.Tensor        # [N] next heartbeat tick (leader); DISARM = off
    proposal_tick: torch.Tensor  # [N] when setProposal fires; DISARM = unscheduled
    add_change_value: torch.Tensor  # [N] bool — heartbeats carry proposals
    m_value: torch.Tensor        # [N] last proposal value stored (-1 = unset)
    block_num: torch.Tensor      # [N] blocks committed (leader counts)
    round: torch.Tensor          # [N] proposal rounds broadcast (leader)
    hb_succ: torch.Tensor        # [N] proposal-ack SUCCESS count, current round
    hb_cnt: torch.Tensor         # [N] proposal-ack total count, current round
    hb_open: torch.Tensor        # [N] bool — current round not yet committed
    leader_tick: torch.Tensor    # [N] tick this node became leader (-1 = never)
    elections: torch.Tensor      # [N] sendVote firings (metrics)
    block_tick: torch.Tensor     # [N, B] commit tick per block at the leader (-1)
    alive: torch.Tensor          # [N] bool fault mask
    honest: torch.Tensor         # [N] bool fault mask
    seen_vreq: torch.Tensor      # [N] gossip dedup registers; zeros on the full mesh
    seen_hb: torch.Tensor        # [N]
    seen_prop: torch.Tensor      # [N]
    my_base: torch.Tensor        # [N] gossip election base; zeros on the full mesh
    link_busy: torch.Tensor      # [N] queued links: busy-until tick per destination


@dataclasses.dataclass
class RaftBufs:
    vreq: torch.Tensor      # edge [D, N_recv, N_send] sender identity (kregular
    # [D, N, K]: the sender is the in-slot); stat [D, N]
    # candidate id + 1, max-combined
    vres_ok: torch.Tensor   # [D, N] granted-vote arrivals at the candidate (add)
    vres_no: torch.Tensor   # [D, N] denial arrivals at the candidate (add)
    hb_plain: torch.Tensor  # [D, N] plain-heartbeat arrival counts (add)
    hb_prop: torch.Tensor   # [D, N] proposal value + 1, max-combined (0 = empty)
    hb_ok: torch.Tensor     # [D, N] proposal-ack SUCCESS arrivals at the leader (add)
    hb_bad: torch.Tensor    # [D, N] proposal-ack FAILED arrivals (Byzantine repliers)


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(RaftState))
BUF_FIELDS = tuple(f.name for f in dataclasses.fields(RaftBufs))


def init(cfg, key=None, *, device, rows=None):
    """``(RaftState, RaftBufs)`` on ``device``.  The initial election
    timeouts U[election_lo, election_hi) are drawn from ``key``
    (``threefry.key(cfg.seed)`` when None); crashed nodes never start one.
    Lane keys ``[S, 2]`` give ``S`` shards (module docstring): state
    ``[S, N, ...]``, rings ``[D, S, N, ...]``.  ``rows=(start, count)``
    builds only those node rows (a rank's block of a sharded run), each
    timeout the one the whole draw gives its row."""
    k = threefry.key(cfg.seed) if key is None else np.asarray(key, np.int64)
    sh = (len(k),) if k.ndim == 2 else ()
    d, b = cfg.ring_depth, cfg.raft_max_blocks
    start, n = (0, cfg.n) if rows is None else rows
    alive, honest = (m[start:start + n].expand(sh + (n,)).contiguous()
                     for m in fault_masks(cfg, cfg.n, device))

    def zi(*dims):  # every state field gets the shard axis first
        return torch.zeros(sh + dims, dtype=_I32, device=device)

    def full(dims, val):
        return torch.full(sh + dims, val, dtype=_I32, device=device)

    def zb(*dims):
        return torch.zeros(sh + dims, dtype=torch.bool, device=device)

    def ring(*dims):  # slot-major: the shard axis after the slots
        return torch.zeros((d,) + sh + dims, dtype=_I32, device=device)

    with (contextlib.nullcontext() if rows is None
          else threefry.row_view(-1, start, cfg.n)):
        deadline = threefry.randint(threefry.fold_in(k, Channel.ELECTION), (n,),
                                    cfg.raft_election_lo_ms, cfg.raft_election_hi_ms,
                                    device)
    state = RaftState(
        is_leader=zb(n),
        has_voted=zb(n),
        election_deadline=torch.where(alive, deadline, DISARM),
        vote_success=zi(n),
        vote_failed=zi(n),
        next_hb=full((n,), DISARM),
        proposal_tick=full((n,), DISARM),
        add_change_value=zb(n),
        m_value=full((n,), -1),
        block_num=zi(n),
        round=zi(n),
        hb_succ=zi(n),
        hb_cnt=zi(n),
        hb_open=zb(n),
        leader_tick=full((n,), -1),
        elections=zi(n),
        block_tick=full((n, b), -1),
        alive=alive,
        honest=honest,
        seen_vreq=zi(n),
        seen_hb=zi(n),
        seen_prop=zi(n),
        my_base=zi(n),
        link_busy=zi(n),
    )
    if cfg.delivery == "stat":
        vreq = ring(n)
    elif cfg.topology == "kregular":
        vreq = ring(n, cfg.degree + 1)  # the in-slot, not a global column
    else:
        vreq = ring(n, cfg.n)  # a column a sender
    bufs = RaftBufs(
        vreq=vreq,
        vres_ok=ring(n),
        vres_no=ring(n),
        hb_plain=ring(n),
        hb_prop=ring(n),
        hb_ok=ring(n),
        hb_bad=ring(n),
    )
    return state, bufs


def push_members(cfg) -> tuple:
    """``(ring, op, B, lo)`` of every ring push one tick can make, in the
    order ``step`` collects them: the group a tick whose gates all fire
    launches (queued links replace the four heartbeat pushes by scatters).
    ``hb_bad`` is pushed only when the config has Byzantine nodes.  Over
    gossip the plain heartbeats are a max-combined flood and the acks leave
    at flood arrival, one way."""
    lo, hi = cfg.one_way_range()
    rt_lo, rt_hi = cfg.roundtrip_range()
    ser = cfg.serialization_ticks(cfg.raft_block_bytes)
    if cfg.topology == "gossip":
        return (("vres_ok", "add", hi - lo, lo), ("vres_no", "add", hi - lo, lo),
                ("vreq", "max", hi - lo, lo), ("hb_plain", "max", hi - lo, lo),
                ("hb_prop", "max", hi - lo, lo + ser), ("hb_ok", "add", hi - lo, lo),
                ("hb_bad", "add", hi - lo, lo))
    return (("vres_ok", "add", hi - lo, lo), ("vres_no", "add", hi - lo, lo),
            ("vreq", "max", hi - lo, lo), ("hb_plain", "add", hi - lo, lo),
            ("hb_prop", "max", hi - lo, lo + ser), ("hb_ok", "add", rt_hi - rt_lo, rt_lo + ser),
            ("hb_bad", "add", rt_hi - rt_lo, rt_lo + ser))


def _rearm(cfg, tkey, channel: int, t, n_loc: int, device, axis=None):
    """``t`` + a fresh election timeout per node, U[election_lo, election_hi)
    (sharded: the rank's rows, on the shard's key)."""
    with dv.draw_rows(axis):
        return t + threefry.randint(dv._shard_key(chan_key(tkey, channel), axis), (n_loc,),
                                    cfg.raft_election_lo_ms, cfg.raft_election_hi_ms,
                                    device)


def _reply_counts(grant_to, wire, has_req, n: int, axis=None):
    """Per-candidate reply counts: ``zeros(n).at[grant_to].add(wire)``, in
    each shard.  Rows with no request carry no wire, so they scatter into
    one extra slot that is cut off.  Sharded: summed over the ranks, each
    keeping its candidates' rows."""
    idx = torch.where(has_req, grant_to, n).to(torch.int64)
    c = torch.zeros(wire.shape[:-1] + (n + 1,), dtype=_I32, device=wire.device)
    c = c.scatter_add_(-1, idx, wire.to(_I32))[..., :n]
    if axis is None:
        return c
    return dv._rank_rows(dv._psum(c, axis), wire.shape[-1], axis).contiguous()


def _shut(gate, contrib):
    """The contribution of a gated draw in a shard form: shards whose own
    gate is shut (``gate [S]`` false) push 0, which leaves their ring as
    JAX's shut branch does (adding 0, or max-combining 0 into values >= 0).
    One instance passes through: its gate was the host read."""
    if gate is None:
        return contrib
    return torch.where(gate.view((1, -1) + (1,) * (contrib.ndim - 2)), contrib, 0)


def step(cfg, state: RaftState, bufs: RaftBufs, t, tkey, *, topo_tables=None,
         exchange=None):
    """One tick.  ``t``: 0-d int32 tensor on the state's device; ``tkey``:
    the tick's threefry key (utils/prng.tick_key), or one key a shard
    ``[S, 2]`` for a state with a shard axis (module docstring).  ``init``
    has checked that the config is ported.  ``topo_tables``: the kregular
    overlay's ``(in, out, inslot)`` tables when the caller holds them, else
    the config's own; ``exchange``: the sharded overlay's neighbour
    exchange, whose tables are already this rank's rows."""
    n = cfg.n
    axis = cfg.mesh_axis
    # shard form: the per-shard gate masks of _shut (None: one instance)
    sharded = state.is_leader.ndim == 2

    def gate(mask):
        return mask.any(-1) if sharded else None

    lo, hi = cfg.one_way_range()
    rt_lo, _ = cfg.roundtrip_range()
    drop = cfg.faults.drop_prob
    clean = cfg.fidelity == "clean"
    stat = cfg.delivery == "stat"
    smode = cfg.eff_stat_sampler
    eimpl = cfg.eff_edge_sampler
    ow_probs = delay_ops.uniform_probs(lo, hi)
    rt_probs = delay_ops.roundtrip_probs(lo, hi)
    dev = state.is_leader.device
    n_loc = state.is_leader.shape[-1]
    ids = dv._global_ids(n_loc, axis, dev)
    ser = cfg.serialization_ticks(cfg.raft_block_bytes)
    # queued links: with ser == 0 the pipe is never busy and queued equals
    # constant latency, so the plain path runs
    queued = cfg.queued_links and ser > 0
    alive, honest = state.alive, state.honest
    # Byzantine repliers exist (a static fact of the config): otherwise every
    # FAILED-ack contribution is all zeros and is neither drawn nor pushed
    liars_exist = cfg.faults.n_byzantine > 0
    pushes = []

    # ---- pop arrivals; crashed nodes process nothing ------------------------
    vreq_t, vreq = ring_pop(bufs.vreq, t)
    ok_t, vres_ok = ring_pop(bufs.vres_ok, t)
    no_t, vres_no = ring_pop(bufs.vres_no, t)
    plain_t, hb_plain = ring_pop(bufs.hb_plain, t)
    prop_t, hb_prop = ring_pop(bufs.hb_prop, t)
    hbok_t, hb_ok = ring_pop(bufs.hb_ok, t)
    hbbad_t, hb_bad = ring_pop(bufs.hb_bad, t)
    am = alive.to(_I32)
    ok_t, no_t = ok_t * am, no_t * am
    plain_t, prop_t = plain_t * am, prop_t * am
    hbok_t, hbbad_t = hbok_t * am, hbbad_t * am
    hbtot_t = hbok_t + hbbad_t
    vreq_t = vreq_t * am if stat else vreq_t * am[..., None]

    # ---- gossip decode: the three broadcast channels flood with a hop TTL
    # (value * H + hops_left, H = gossip_hops + 1) over time-monotone bases:
    # vreq (t+1)*n + cand + 1, plain hb t+1, proposal (t+1)*(n+1) + leader + 1.
    # A node processes each base once (first sighting) but forwards any
    # strictly better TTL copy
    gossip = cfg.topology == "gossip"
    seen_vreq, seen_hb, seen_prop = state.seen_vreq, state.seen_hb, state.seen_prop
    if gossip:
        h_enc = cfg.gossip_hops + 1
        nbrs = topology.neighbours(n, cfg.degree, cfg.seed, dev)
        if axis is not None:
            nbrs = nbrs.index_select(0, ids.to(torch.int64))

        def _decode(arr, seen):
            base, hops = arr // h_enc, arr % h_enc
            new = (base > seen // h_enc) & alive
            better = (arr > seen) & alive
            fwd = (base * h_enc + torch.clamp(hops - 1, min=0)) * (better & (hops > 0))
            return base * new, torch.maximum(seen, arr * better), fwd

        vreq_t, seen_vreq, vreq_fwd = _decode(vreq_t, seen_vreq)
        plain_t, seen_hb, hb_fwd = _decode(plain_t, seen_hb)
        prop_t, seen_prop, prop_fwd = _decode(prop_t, seen_prop)

    # kregular overlay: broadcasts reach out-neighbours, replies gather back
    # requester-side (the inslot cross-index); a candidate only hears its
    # in-neighbours' votes, so elections need k >= majority_need - 1
    kreg = cfg.topology == "kregular"
    if kreg:
        nbr_in, nbr_out, inslot = gd.local_tables(
            cfg, None if axis is None or exchange is not None else ids, inslot=True,
            tables=topo_tables, device=dev)

    # ---- heartbeat arrivals (follower side) ---------------------------------
    got_hb = (plain_t > 0) | (prop_t > 0)
    # over gossip the proposal value (the leader id) rides the flood encoding
    m_value = torch.where(prop_t > 0, (prop_t - 1) % (n + 1) if gossip else prop_t - 1,
                          state.m_value)
    if not clean:
        # quirk #5: one heartbeat pacifies a follower forever
        election_deadline = torch.where(got_hb, DISARM, state.election_deadline)
    elif bool(got_hb.any()):
        # re-arm the election timer: real failure detection
        election_deadline = torch.where(
            got_hb, _rearm(cfg, tkey, Channel.ELECTION, t, n_loc, dev, axis),
            state.election_deadline)
    else:
        election_deadline = state.election_deadline

    # ---- gossip proposal acks: a follower acks the proposal when the flood
    # lands, direct to the decoded leader (the full mesh's short-circuited
    # round trip has no meaning over multi-hop paths); the gate is read with
    # the flood gates at the end of the tick
    if gossip:
        got_prop = prop_t > 0
        ack_to = torch.where(got_prop, (prop_t - 1) % (n + 1), n)

        def ack_pushes():
            k_ack = chan_key(tkey, Channel.DELAY_REPLY2)
            mok = _reply_counts(ack_to, got_prop & honest & alive, got_prop, n, axis)
            mbad = _reply_counts(ack_to, got_prop & ~honest & alive, got_prop, n, axis)
            if drop > 0.0:
                kd = threefry.fold_in(k_ack, 0x0D18)
                mok = dv._thinned(kd, mok, 1.0 - drop, smode)
                mbad = dv._thinned(threefry.fold_in(kd, 1), mbad, 1.0 - drop, smode)
            out = [(hb_ok, lo, dv.push_bucket_counts(
                threefry.fold_in(k_ack, 1), mok, ow_probs, smode), "add")]
            if liars_exist:
                out.append((hb_bad, lo, dv.push_bucket_counts(
                    threefry.fold_in(k_ack, 2), mbad, ow_probs, smode), "add"))
            return out

    # ---- vote requests (acceptor side) --------------------------------------
    can_grant = ~state.has_voted & alive
    has_voted = state.has_voted
    k_vr = chan_key(tkey, Channel.DELAY_REPLY)
    if stat:
        # vreq_t[i] = max candidate id + 1 seen this tick (the stat broadcast
        # reaches the sender too: drop the self-request); over gossip the
        # candidate id rides the flood encoding
        grant_to = (vreq_t - 1) % n if gossip else vreq_t - 1
        has_req = (vreq_t > 0) & (grant_to != ids)
        if dv.agree(has_req.any(), axis):
            if gossip:
                # term-style release: the dedup register admits only strictly
                # newer elections, so every processed request is a grant, and
                # granting re-arms the election timeout (standard Raft)
                grant = has_req & alive
                election_deadline = torch.where(
                    grant, _rearm(cfg, tkey, Channel.ELECTION + 300, t, n_loc, dev, axis),
                    election_deadline)
            else:
                grant = has_req & can_grant
            deny = has_req & ~grant
            has_voted = has_voted | grant
            # Byzantine receivers flip their replies (grant <-> deny on the wire)
            ok_wire = (grant & honest) | (deny & ~honest)
            no_wire = (deny & honest) | (grant & ~honest)
            if kreg:  # candidate c gathers the wires addressed to it
                mok = gd.reply_counts_by_target_kreg(ok_wire, grant_to, nbr_out, ids, axis,
                                                     exchange)
                mno = gd.reply_counts_by_target_kreg(no_wire, grant_to, nbr_out, ids, axis,
                                                     exchange)
            else:
                mok = _reply_counts(grant_to, ok_wire, has_req, n, axis)
                mno = _reply_counts(grant_to, no_wire, has_req, n, axis)
            # the JAX step draws these counts with the tick's keys as they
            # are (no rank folded in), at this rank's rows
            with dv.draw_rows(axis):
                if drop > 0.0:
                    kd = threefry.fold_in(k_vr, 0x0D17)
                    mok = dv._thinned(kd, mok, 1.0 - drop, smode)
                    mno = dv._thinned(threefry.fold_in(kd, 1), mno, 1.0 - drop, smode)
                g = gate(has_req)
                pushes.append((vres_ok, lo, _shut(g, dv.push_bucket_counts(
                    threefry.fold_in(k_vr, 7), mok, ow_probs, smode)), "add"))
                pushes.append((vres_no, lo, _shut(g, dv.push_bucket_counts(
                    threefry.fold_in(k_vr, 8), mno, ow_probs, smode)), "add"))
    else:
        # vreq_t[i, j] = 1 iff candidate j's request reaches i this tick (the
        # overlay: j is i's in-slot, rows sorted); concurrent same-tick
        # requests: the vote goes to the lowest id
        has_req = vreq_t > 0
        any_req = has_req.any(-1)
        if dv.agree(any_req.any(), axis):
            first = has_req.to(torch.uint8).argmax(-1)  # lowest j with a request
            granting = any_req & can_grant
            cols = dv._global_ids(vreq_t.shape[-1], None, dev)
            grant_mask = ((cols == first[..., None]) & granting[..., None]).to(_I32)
            deny_mask = has_req.to(_I32) - grant_mask
            has_voted = has_voted | granting
            hn = honest.to(_I32)[..., None]
            ok_wire = grant_mask * hn + deny_mask * (1 - hn)
            no_wire = deny_mask * hn + grant_mask * (1 - hn)
            g = gate(any_req)

            def unicast(kk, wire):
                if kreg:  # slot-indexed wires gather back through inslot
                    return gd.unicast_reply_counts_kreg(kk, wire, nbr_in, nbr_out, inslot,
                                                        ids, lo, hi, drop, axis=axis,
                                                        impl=eimpl, xg=exchange)
                return dv.unicast_reply_counts_dense(kk, wire, lo, hi, drop, axis=axis,
                                                     impl=eimpl)

            pushes.append((vres_ok, lo, _shut(g, unicast(threefry.fold_in(k_vr, 7),
                                                         ok_wire)), "add"))
            pushes.append((vres_no, lo, _shut(g, unicast(threefry.fold_in(k_vr, 8),
                                                         no_wire)), "add"))

    # ---- vote responses (candidate side) ------------------------------------
    follower = ~state.is_leader
    vs = state.vote_success + ok_t * follower
    vf = state.vote_failed + no_t * follower
    win = follower & (ok_t > 0) & (vs + 1 >= cfg.majority_need) & alive
    lose = ~win & (no_t > 0) & (vf >= cfg.raft_lose_need) & follower
    vote_success = torch.where(win | lose, 0, vs)
    vote_failed = torch.where(win | lose, 0, vf)
    # winner: cancel own timer, first heartbeat now, proposals in +1 s
    is_leader = state.is_leader | win
    election_deadline = torch.where(win, DISARM, election_deadline)
    next_hb = torch.where(win, t, state.next_hb)
    proposal_tick = torch.where(win, t + cfg.raft_proposal_delay_ms, state.proposal_tick)
    leader_tick = torch.where(win & (state.leader_tick < 0), t, state.leader_tick)
    # loser: majority denied — release the vote latch and retry on the timer
    has_voted = has_voted & ~lose
    link_busy = state.link_busy
    if queued:
        # leadership changed: the new leader's links carry votes only, hence
        # are free; in-flight deliveries keep their ring slots
        lead_prev = dv._pmax(torch.where(state.is_leader & alive, ids, -1)
                             .amax(-1, keepdim=True), axis)
        lead_new = dv._pmax(torch.where(is_leader & alive, ids, -1).amax(-1, keepdim=True),
                            axis)
        link_busy = torch.where(lead_new != lead_prev, 0, link_busy)

    # ---- gossip: leader step-down on a newer election (see my_base) ---------
    hb_succ_in, hb_cnt_in, hb_open_in = state.hb_succ, state.hb_cnt, state.hb_open
    resign = None  # no leader steps down this tick
    if gossip:
        newer = is_leader & (seen_vreq // h_enc > state.my_base) & alive
        if bool(newer.any()):
            resign = newer
            is_leader = is_leader & ~resign
            next_hb = torch.where(resign, DISARM, next_hb)
            proposal_tick = torch.where(resign, DISARM, proposal_tick)
            # back to follower: re-arm the election timer
            election_deadline = torch.where(
                resign, _rearm(cfg, tkey, Channel.ELECTION + 200, t, n_loc, dev, axis),
                election_deadline)
            # a resigned leader abandons its open ack window
            hb_succ_in = torch.where(resign, 0, hb_succ_in)
            hb_cnt_in = torch.where(resign, 0, hb_cnt_in)
            hb_open_in = hb_open_in & ~resign

    # ---- proposal acks (leader side) ----------------------------------------
    hs = hb_succ_in + hbok_t
    hc = hb_cnt_in + hbtot_t
    if clean:
        commit = hb_open_in & (hs + 1 >= cfg.majority_need) & is_leader
        hb_open = hb_open_in & ~commit
        hb_succ, hb_cnt = hs, hc
    else:
        # reference: the check runs only at exactly N-1 responses in
        done = (hbtot_t > 0) & (hc == n - 1)
        commit = done & (hs + 1 >= cfg.majority_need)
        hb_succ = torch.where(done, 0, hs)
        hb_cnt = torch.where(done, 0, hc)
        hb_open = hb_open_in
    b_max = cfg.raft_max_blocks
    blk = torch.clamp(state.block_num, 0, b_max - 1)
    slots = torch.arange(b_max, device=dev)
    block_tick = torch.where(
        (slots == blk[..., None]) & commit[..., None]
        & (state.block_num < b_max)[..., None],
        t, state.block_tick)
    block_num = state.block_num + commit
    # blockNum >= max cancels the heartbeat.  Gossip keeps its 4-byte control
    # heartbeat after completion (silence would start a fresh election) and
    # simply stops proposing
    if not gossip:
        next_hb = torch.where(block_num >= b_max, DISARM, next_hb)

    # ---- timer: sendHeartBeat (state first; its gates read with sendVote's) -
    hb_fire = is_leader & (t >= next_hb) & (next_hb != DISARM) & alive
    # setProposal fires exactly once; round == max clears add_change_value
    set_prop = (t >= proposal_tick) & (proposal_tick != DISARM)
    add_change_value = state.add_change_value | set_prop
    if resign is not None:
        add_change_value = add_change_value & ~resign
    proposal_tick = torch.where(set_prop, DISARM, proposal_tick)
    prop_send = hb_fire & add_change_value
    # gossip: the leader ALWAYS floods the 4-byte plain heartbeat, the
    # failure detector, beside the 20 KB proposal flood
    plain_send = hb_fire if gossip else hb_fire & ~add_change_value
    next_hb = torch.where(hb_fire, next_hb + cfg.raft_heartbeat_ms, next_hb)
    round_ = state.round + prop_send
    add_change_value = add_change_value & ~(prop_send & (round_ >= cfg.raft_max_rounds))
    if clean:  # a new proposal round opens the ack window
        hb_succ = torch.where(prop_send, 0, hb_succ)
        hb_cnt = torch.where(prop_send, 0, hb_cnt)
        hb_open = hb_open | prop_send

    # ---- timer: sendVote ----------------------------------------------------
    fire = (t >= election_deadline) & (election_deadline != DISARM) & ~is_leader & alive
    elections = state.elections
    my_base = state.my_base
    k_vq = chan_key(tkey, Channel.DELAY_BCAST)
    floods = []  # gossip: (ring, lo, key, out value) of the tick's floods
    if gossip:
        fire_on = dv.agree(fire.any(), axis)
    else:  # the election's and the heartbeats' gates in one host read (agreed)
        fire_on, any_plain, any_prop = dv._pmax(
            torch.stack([fire.any(), plain_send.any(), prop_send.any()]), axis).tolist()
    if fire_on:
        has_voted = has_voted | fire  # self-vote latch
        election_deadline = torch.where(
            fire, _rearm(cfg, tkey, Channel.ELECTION + 100, t, n_loc, dev, axis),
            election_deadline)
        elections = elections + fire
        fire_i = fire.to(_I32)
        if gossip:
            # a fresh election restarts the reply count (stale replies
            # drained long ago: reply horizon << timeout)
            vote_success = torch.where(fire, 0, vote_success)
            vote_failed = torch.where(fire, 0, vote_failed)
            # flood origin: full TTL, marked seen so the self-loop copy is
            # inert; the candidate backs its own (newest) election
            base_v = ((t + 1) * n + ids + 1) * fire_i
            origin_v = (base_v * h_enc + cfg.gossip_hops) * (base_v > 0)
            seen_vreq = torch.maximum(seen_vreq, origin_v)
            my_base = torch.maximum(my_base, base_v)
            vreq_fwd = torch.maximum(origin_v, vreq_fwd)
        elif stat:
            vq_contrib = (gd.bcast_value_max_stat_kreg(k_vq, (ids + 1) * fire_i, nbr_in,
                                                       ow_probs, drop, axis=axis, xg=exchange)
                          if kreg else
                          dv.bcast_value_max_stat(k_vq, (ids + 1) * fire_i, ow_probs, drop,
                                                  axis=axis))
        else:
            vq_contrib = (gd.bcast_matrix_kreg(k_vq, fire, fire_i, nbr_in, ids, lo, hi, drop,
                                               axis=axis, impl=eimpl, xg=exchange)
                          if kreg else
                          dv.bcast_matrix_dense(k_vq, fire, fire_i, lo, hi, drop, axis=axis,
                                                impl=eimpl))
        if not gossip:
            pushes.append((vreq, lo, _shut(gate(fire), vq_contrib), "max"))
    if gossip:
        floods.append((vreq, lo, k_vq, vreq_fwd))

    k_hb = chan_key(tkey, Channel.DELAY_BCAST2)
    k_rt = chan_key(tkey, Channel.DELAY_ROUNDTRIP)
    voters = alive & honest
    liars = alive & ~honest
    if gossip:
        # plain heartbeats flood with the tick as the monotone base; proposals
        # carry the block, re-serialized on every hop (store-and-forward)
        base_h = (t + 1) * plain_send.to(_I32)
        origin_h = (base_h * h_enc + cfg.gossip_hops) * (base_h > 0)
        seen_hb = torch.maximum(seen_hb, origin_h)
        floods.append((hb_plain, lo, threefry.fold_in(k_hb, 2),
                       torch.maximum(origin_h, hb_fwd)))
        base_p = ((t + 1) * (n + 1) + ids + 1) * prop_send.to(_I32)
        origin_p = (base_p * h_enc + cfg.gossip_hops) * (base_p > 0)
        seen_prop = torch.maximum(seen_prop, origin_p)
        floods.append((hb_prop, lo + ser, threefry.fold_in(k_hb, 3),
                       torch.maximum(origin_p, prop_fwd)))
        # the floods' and the acks' gates in one host read (agreed)
        *flood_on, any_ack = dv._pmax(torch.stack(
            [out.any() for *_, out in floods] + [got_prop.any()]), axis).tolist()
        for (ring, off, key, out), on in zip(floods, flood_on):
            if on:
                pushes.append((ring, off, dv.gossip_fwd(key, out[..., None], nbrs, n, lo,
                                                        hi, drop, axis=axis,
                                                        impl=eimpl)[..., 0],
                               "max"))
        if any_ack:
            pushes += ack_pushes()
    elif queued:
        if any_plain or any_prop:
            link_busy = _queued_sends(cfg, prop_send, plain_send, any_prop, voters, liars,
                                      ids, link_busy, hb_prop, hb_plain, hb_ok, hb_bad,
                                      t, k_hb, k_rt, axis)
    else:
        if any_plain:
            # the stat mode stays exact: this channel has O(1) senders (the leader)
            if kreg:
                plain_contrib = (
                    gd.bcast_counts_stat_kreg(k_hb, plain_send, nbr_in, ids, ow_probs, drop,
                                              axis=axis, mode="exact", xg=exchange)
                    if stat else
                    gd.bcast_counts_kreg(k_hb, plain_send, nbr_in, ids, lo, hi, drop,
                                         axis=axis, impl=eimpl, xg=exchange))
            else:
                plain_contrib = (
                    dv.bcast_counts_stat(
                        k_hb, dv._psum(plain_send.sum(-1, keepdim=True, dtype=_I32), axis),
                        plain_send, ow_probs, drop, axis=axis, mode="exact")
                    if stat else
                    dv.bcast_counts_dense(k_hb, plain_send, lo, hi, drop, axis=axis,
                                          impl=eimpl))
            pushes.append((hb_plain, lo, _shut(gate(plain_send), plain_contrib), "add"))
        if any_prop:
            g = gate(prop_send)
            k_p = threefry.fold_in(k_hb, 1)
            value = (ids + 1) * prop_send.to(_I32)
            if kreg:
                prop_contrib = (
                    gd.bcast_value_max_stat_kreg(k_p, value, nbr_in, ow_probs, drop,
                                                 axis=axis, xg=exchange)
                    if stat else
                    gd.bcast_value_max_kreg(k_p, prop_send, value, nbr_in, ids, lo, hi, drop,
                                            axis=axis, impl=eimpl, xg=exchange))
            else:
                prop_contrib = (
                    dv.bcast_value_max_stat(k_p, value, ow_probs, drop, axis=axis) if stat
                    else dv.bcast_value_max_dense(k_p, prop_send, value, lo, hi, drop,
                                                  axis=axis, impl=eimpl))
            pushes.append((hb_prop, lo + ser, _shut(g, prop_contrib), "max"))
            # proposal acks: follower state never affects the SUCCESS reply, so
            # the round trip is short-circuited; Byzantine followers flip to
            # FAILED.  The two channels cover disjoint peer sets.
            k_bad = threefry.fold_in(k_rt, 1)
            if stat:
                # the overlay swaps only the per-sender peer counts for
                # out-table gathers (equal at k = N-1, same keys and chain)
                def peer_counts(peers):
                    if kreg:
                        return gd.out_counts(peers, nbr_out, ids, axis, exchange)
                    peers_i = peers.to(_I32)
                    return dv._psum(peers_i.sum(-1, keepdim=True, dtype=_I32), axis) - peers_i

                ok_counts = dv.push_roundtrip_reply_counts_stat(
                    k_rt, prop_send, peer_counts(voters), rt_probs, drop, axis=axis,
                    mode=smode)
                bad_counts = (dv.push_roundtrip_reply_counts_stat(
                    k_bad, prop_send, peer_counts(liars), rt_probs, drop, axis=axis,
                    mode=smode)
                    if liars_exist else None)
            else:
                def acks(kk, peers):
                    if kreg:
                        return gd.roundtrip_reply_counts_kreg(
                            kk, prop_send, nbr_out, ids, lo, hi, drop, peer_mask=peers,
                            axis=axis, impl=eimpl, xg=exchange)
                    return dv.roundtrip_reply_counts_dense(
                        kk, prop_send, lo, hi, drop, peer_mask=peers, axis=axis,
                        impl=eimpl)

                ok_counts = acks(k_rt, voters)
                bad_counts = acks(k_bad, liars) if liars_exist else None
            pushes.append((hb_ok, rt_lo + ser, _shut(g, ok_counts), "add"))
            if bad_counts is not None:
                pushes.append((hb_bad, rt_lo + ser, _shut(g, bad_counts), "add"))
    ring_push_group(pushes, t)  # in place; no launch when nothing is pushed

    state = dataclasses.replace(
        state,
        is_leader=is_leader,
        has_voted=has_voted,
        election_deadline=election_deadline,
        vote_success=vote_success,
        vote_failed=vote_failed,
        next_hb=next_hb,
        proposal_tick=proposal_tick,
        add_change_value=add_change_value,
        m_value=m_value,
        block_num=block_num,
        round=round_,
        hb_succ=hb_succ,
        hb_cnt=hb_cnt,
        hb_open=hb_open,
        leader_tick=leader_tick,
        elections=elections,
        block_tick=block_tick,
        seen_vreq=seen_vreq,
        seen_hb=seen_hb,
        seen_prop=seen_prop,
        my_base=my_base,
        link_busy=link_busy,
    )
    bufs = RaftBufs(vreq=vreq, vres_ok=vres_ok, vres_no=vres_no, hb_plain=hb_plain,
                    hb_prop=hb_prop, hb_ok=hb_ok, hb_bad=hb_bad)
    return state, bufs


def _queued_sends(cfg, prop_send, plain_send, any_prop, voters, liars, ids, link_busy,
                  hb_prop, hb_plain, hb_ok, hb_bad, t, k_hb, k_rt, axis=None):
    """Serial-pipe send (the C++ engine's link_enqueue) of this tick's
    heartbeat: the packet reaches the (leader -> j) link after its scheduling
    delay ``d_j - prop``, transmits when the link frees (a proposal occupies
    it ``ser`` ticks; a 4-byte plain heartbeat queues but occupies nothing),
    then propagates.  Deliveries land on the rings at per-destination
    offsets, in place: one element per column, so a destination that gets
    nothing is pointed at row 0 with the identity value (0, which leaves a
    ring of values >= 0 unchanged under add and max).  Each follower's ack
    departs at its delivery tick over a link that is never busy and lands in
    the leader's column.  Returns the new ``link_busy``.  Sharded: the
    sender scalars are MAX-reduced, the rows are this rank's columns, and
    the leader's ack histograms are summed over the ranks into its column
    on the rank that owns it.  Lanes: every lane's sender, pipes and ring
    columns on their own (a lane with no sender this tick sends nothing)."""
    lo, hi = cfg.one_way_range()
    ser = cfg.serialization_ticks(cfg.raft_block_bytes)
    prop_ms = cfg.link_delay_ms
    dev = ids.device
    n = ids.shape[0]
    lead = link_busy.shape[:-1]  # the lane axis, when there is one
    prop_val = dv._pmax(torch.where(prop_send, ids + 1, 0).amax(-1, keepdim=True), axis)
    plain_on = dv._pmax(plain_send.to(_I32).amax(-1, keepdim=True), axis)
    sender = dv._pmax(torch.where(prop_send | plain_send, ids, -1).amax(-1, keepdim=True),
                      axis)
    # crashed peers still reserve the pipe (the reservation is sender-side)
    dest = ((prop_val > 0) | (plain_on > 0)) & (ids != sender)
    d_j = threefry.randint(dv._shard_key(threefry.fold_in(k_hb, 7), axis), (n,), lo, hi,
                           dev)
    ser_s = torch.where(prop_val > 0, ser, 0).to(_I32)
    start = torch.maximum(t + d_j - prop_ms, link_busy)
    delivery = start + ser_s + prop_ms
    link_busy = torch.where(dest, start + ser_s, link_busy)
    dd = hb_prop.shape[0]
    n_lanes = int(np.prod(lead, dtype=np.int64))
    # this rank's ring columns, lane by lane: a ring slot holds [L, n] rows
    cols = ((ids - ids[0]).to(torch.int64)
            + torch.arange(n_lanes, device=dev).reshape(lead + (1,)) * n)
    flat = (torch.where(dest, delivery % dd, 0).to(torch.int64) * (n_lanes * n) + cols)
    hb_prop.view(-1).scatter_reduce_(0, flat.reshape(-1),
                                     torch.where(dest, prop_val, 0).reshape(-1), "amax")
    hb_plain.view(-1).scatter_add_(0, flat.reshape(-1),
                                   (dest & (plain_on > 0)).to(_I32).reshape(-1))
    if any_prop:
        d2 = threefry.randint(dv._shard_key(threefry.fold_in(k_rt, 9), axis), (n,), lo, hi,
                              dev)
        ack_slot = torch.remainder(delivery + d2, dd)
        col = (sender - ids[0]).to(torch.int64)  # each lane's single leader column
        owned = bool(((col >= 0) & (col < n)).item()) if axis is not None else True
        for ring, peers in ((hb_ok, voters), (hb_bad, liars)):
            hist = torch.zeros(lead + (dd + 1,), dtype=_I32, device=dev)
            hist.scatter_add_(-1, torch.where(dest & peers & (prop_val > 0), ack_slot,
                                              dd).to(torch.int64),
                              torch.ones_like(dest, dtype=_I32))
            hist = dv._psum(hist, axis)
            if not owned:
                continue
            if lead:  # a lane without a proposal adds its zero histogram anywhere
                rows = (torch.arange(n_lanes, device=dev) * n
                        + col.reshape(-1).clamp(0, n - 1))
                ring.view(dd, -1).index_add_(1, rows, hist[:, :dd].T.contiguous())
            else:
                ring.index_add_(1, col, hist[:dd, None])
    return link_busy


def metrics(cfg, state: RaftState) -> dict:
    """The reference's measurement surface (leader-elected time, per-block
    processed time, Blocks/Rounds, election starts), recomputed on the host
    with the JAX package's arithmetic."""
    def host(x):
        return x.detach().cpu().numpy()

    alive = host(state.alive)
    is_leader = host(state.is_leader)
    leader_tick = host(state.leader_tick)
    block_num = host(state.block_num)
    block_tick = host(state.block_tick)
    m_value = host(state.m_value)
    leaders = np.flatnonzero(is_leader & alive)
    # under Byzantine double-voting a split brain is possible (no terms):
    # report the earliest-elected leader as "the" leader
    lead = int(leaders[np.argmin(leader_tick[leaders])]) if leaders.size else -1
    blocks = int(block_num[lead]) if lead >= 0 else 0
    bt = block_tick[lead][:blocks] if lead >= 0 else np.array([])
    # agreement: every alive follower that stored a value stored the leader's
    stored = m_value[alive]
    stored = stored[stored >= 0]
    return {
        "protocol": "raft",
        "n": cfg.n,
        "n_leaders": int(len(leaders)),
        "leader": lead,
        "leader_elected_ms": float(leader_tick[lead]) if lead >= 0 else -1.0,
        "blocks": blocks,
        "rounds": int(host(state.round).max()),
        "elections": int(host(state.elections).sum()),
        "last_block_ms": float(bt.max()) if bt.size else -1.0,
        "mean_block_interval_ms": float(np.diff(bt).mean()) if bt.size > 1 else -1.0,
        "agreement_ok": bool(lead < 0 or (stored.size == 0) or (stored == lead).all()),
    }
