"""Single-decree Paxos — the tensorized per-tick engine, in PyTorch.

Port of ``blockchain_simulator_tpu/models/paxos.py`` (whose docstring holds
the design: every node is an acceptor and nodes 0..P-1 propose from t = 0;
ticket / propose / commit requests ride max-combined value rings
``[D, N, P]``, replies ride count rings ``[D, N, 3]`` at the proposer rows
and a promise-payload ring ``[D, N]``; ``fidelity="reference"`` keeps the
reference's iterator bug, shared cross-phase counters and N-2 reply windows,
``"clean"`` fixes the protocol).  Same state fields, same int32 arithmetic,
same threefry keys per (tick, channel): a run is bit-equal to the JAX
package's.

Ported arms: the full mesh, the gossip topology (requests flood over the
random k-out digraph of ops/topology.py with a hop TTL; replies stay direct)
and the kregular overlay (requests reach only the receivers whose
in-table, topo/spec.py, holds the proposer: a row-local ``[N, P]`` mask on
the same draws, all true at degree k = N-1; replies stay point to point),
both fidelities, crash, Byzantine and drop faults, and the
``paxos_client_node`` hook.  ``cfg.delivery`` is ignored, as in the JAX
package: every channel is O(N·P).  Node-sharded (``mesh_axis`` set,
parallel/shard.py): each rank holds its acceptor rows, the proposers'
request values are all-gathered, the replies' counts summed and payloads
max-reduced over the ranks, and the tick's one host read is agreed.

*Lanes* (models/base.py): a state of ``[L, N, ...]`` fields with rings
``[D, L, N, ...]`` and lane keys ``[L, 2]`` steps ``L`` runs at once on
every topology (unsharded); the host read stays one a tick, "any lane".

PyTorch idiom, as in models/pbft.py: state and rings are mutable tensors,
the rings are updated in place, ``t`` is a 0-d int32 tensor on the device.
JAX's four ``lax.cond`` gates (the replies and the three request channels)
and the clean-fidelity retry jitter become host branches on ONE host read a
tick: nothing the gates guard feeds the rest of the step, so their
predicates are read together at its end.  A skipped branch would have
produced exactly zeros (its keys are pure functions of seed, tick and
channel, so skipping consumes nothing).  No ring is read between its pop at
the top of the tick and the end, so the six pushes go in one kernel launch
there, and a member whose gate was skipped is left out (every ring value is
>= 0, so adding 0 or max-combining 0 changes nothing).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from blockchain_simulator_tpu_torch.models.base import fault_masks
from blockchain_simulator_tpu_torch.ops import delay as delay_ops
from blockchain_simulator_tpu_torch.ops import delivery as dv
from blockchain_simulator_tpu_torch.ops import gatherdeliv as gd
from blockchain_simulator_tpu_torch.ops import topology
from blockchain_simulator_tpu_torch.ops.ring import ring_pop, ring_push_group
from blockchain_simulator_tpu_torch.topo import spec as topo_spec
from blockchain_simulator_tpu_torch.utils import threefry
from blockchain_simulator_tpu_torch.utils.prng import Channel, chan_key

# proposer phase register
PH_TICKET, PH_PROPOSE, PH_COMMIT, PH_DONE = 0, 1, 2, 3
PH_IDLE = -1  # non-proposer rows
_I32 = torch.int32


@dataclasses.dataclass
class PaxosState:
    # acceptor state
    t_max: torch.Tensor      # [N] highest ticket promised
    command: torch.Tensor    # [N] stored command; -1 = 'e' empty sentinel
    t_store: torch.Tensor    # [N] ticket of the stored command
    is_commit: torch.Tensor  # [N] bool — command executed (latch)
    exec_tick: torch.Tensor  # [N] first execute tick, -1 = never
    # proposer state; rows >= P are inert
    ticket: torch.Tensor        # [N] current ticket (0 until first requireTicket)
    phase: torch.Tensor         # [N] PH_*; informational in reference fidelity
    vote_success: torch.Tensor  # [N]
    vote_failed: torch.Tensor   # [N]
    proposal: torch.Tensor      # [N] command to propose (init own id, may adopt)
    adopt_val: torch.Tensor     # [N] max promise encoding seen this window
    commit_tick: torch.Tensor   # [N] CLIENT COMMIT SUCCESS tick (-1 = never)
    gave_up: torch.Tensor       # [N] bool — retry budget exhausted
    window_deadline: torch.Tensor  # [N] clean-fidelity retry timeout tick
    seen_req: torch.Tensor      # [N, 3, P] gossip dedup: highest TTL-encoded copy
    alive: torch.Tensor
    honest: torch.Tensor


@dataclasses.dataclass
class PaxosBufs:
    # requests, value-encoded and max-combined (0 = empty):
    #   req_ticket[d, i, p] = ticket
    #   req_propose/req_commit[d, i, p] = ticket*(n+1) + command + 1
    # (over gossip, each value v travels as v*(gossip_hops+1) + hops_left)
    req_ticket: torch.Tensor   # [D, N, P]
    req_propose: torch.Tensor  # [D, N, P]
    req_commit: torch.Tensor   # [D, N, P]
    # responses at proposer rows; last axis = type (0 ticket, 1 propose, 2 commit)
    resp_ok: torch.Tensor      # [D, N, 3] SUCCESS counts (add)
    resp_no: torch.Tensor      # [D, N, 3] FAILED counts (add)
    resp_cmd: torch.Tensor     # [D, N] promise payloads t_store*(n+1)+command+1, max


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(PaxosState))
BUF_FIELDS = tuple(f.name for f in dataclasses.fields(PaxosBufs))


def init(cfg, key=None, *, device, rows=None):
    """``(PaxosState, PaxosBufs)`` on ``device``; ``rows=(start, count)``
    builds only those node rows (a rank's block of a sharded run).  Clean
    fidelity checks that the retry timeout covers the longest reply horizon
    (the flood's over gossip), as the JAX package does."""
    del key  # the fault masks are deterministic, as in the JAX package
    d, p = cfg.ring_depth, cfg.paxos_n_proposers
    start, n = (0, cfg.n) if rows is None else rows
    if cfg.fidelity == "clean":
        _, rt_hi = cfg.roundtrip_range()
        horizon = rt_hi
        if cfg.topology == "gossip":
            # an origin send with TTL=gossip_hops can traverse gossip_hops+1
            # flood legs plus the direct reply leg, each up to hi-1 ms
            horizon = (cfg.gossip_hops + 2) * cfg.one_way_range()[1]
        if cfg.paxos_retry_timeout_ms < horizon:
            raise ValueError(
                f"paxos_retry_timeout_ms={cfg.paxos_retry_timeout_ms} must be "
                f">= the max reply horizon ({horizon} ms): clean-fidelity "
                "correctness relies on abandoned windows draining before retry"
            )
    alive, honest = (m[start:start + n] for m in fault_masks(cfg, cfg.n, device))
    ids = dv.row_ids(n, start, torch.device(device))

    def zi(*sh):
        return torch.zeros(sh, dtype=_I32, device=device)

    def full(sh, val):
        return torch.full(sh, val, dtype=_I32, device=device)

    def zb(*sh):
        return torch.zeros(sh, dtype=torch.bool, device=device)

    state = PaxosState(
        t_max=zi(n),
        command=full((n,), -1),
        t_store=zi(n),
        is_commit=zb(n),
        exec_tick=full((n,), -1),
        ticket=zi(n),
        phase=torch.where(ids < p, PH_TICKET, PH_IDLE).to(_I32),
        vote_success=zi(n),
        vote_failed=zi(n),
        proposal=ids.clone(),
        adopt_val=zi(n),
        commit_tick=full((n,), -1),
        gave_up=zb(n),
        window_deadline=full((n,), 1 << 30),
        seen_req=zi(n, 3, p),
        alive=alive,
        honest=honest,
    )
    bufs = PaxosBufs(req_ticket=zi(d, n, p), req_propose=zi(d, n, p),
                     req_commit=zi(d, n, p), resp_ok=zi(d, n, 3),
                     resp_no=zi(d, n, 3), resp_cmd=zi(d, n))
    return state, bufs


def push_members(cfg) -> tuple:
    """``(ring, op, B, lo)`` of every ring push one tick can make, in the
    order ``step`` collects them: the group of a tick whose gates all fire."""
    lo, hi = cfg.one_way_range()
    return tuple((name, op, hi - lo, lo) for name, op in (
        ("resp_ok", "add"), ("resp_no", "add"), ("resp_cmd", "max"),
        ("req_ticket", "max"), ("req_propose", "max"), ("req_commit", "max")))


def _req_contrib(key, val, lo, hi, drop, ids, p, ref_skip, impl="threefry",
                 inmask=None, axis=None):
    """Broadcast contribution of one request channel: per-node request
    values (nonzero only at proposer rows) → ``[B, N, P]`` values for a max
    push.  ``ref_skip`` drops the sender's first peer (the reference's
    iterator bug); ``inmask`` (``[N, P]`` bool) keeps the receivers whose
    kregular in-table holds the proposer.  Sharded, the proposers' values
    are gathered and each rank draws its receiver rows."""
    dev = val.device
    n = val.shape[-1]
    val_g = dv._gather(val, axis)[..., None, :p]  # [P] global proposer values
    key = dv._shard_key(key, axis)
    with dv.draw_rows(axis, -2):
        d = delay_ops.sample_edge_delays(key, (n, p), lo, hi, dev, impl)
    prop_ids = torch.arange(p, dtype=_I32, device=dev)
    mask = (val_g > 0) & (ids[:, None] != prop_ids[None, :])
    if inmask is not None:
        mask = mask & inmask
    if ref_skip:
        first_peer = torch.where(prop_ids == 0, 1, 0)
        mask = mask & (ids[:, None] != first_peer[None, :])
    if drop > 0.0:
        with dv.draw_rows(axis, -2):
            mask = mask & threefry.bernoulli(threefry.fold_in(key, 0x0D20), 1.0 - drop,
                                             (n, p), dev)
    hits = (d[None] == dv._bucket_iota(lo, hi, d.ndim, dev)).to(_I32)
    return hits * (mask.to(_I32) * val_g)[None]


def _reply_contribs(key, ok_wire, no_wire, cmd_wire, lo, hi, drop, ids, p,
                    impl="threefry", axis=None):
    """Unicast acceptor→proposer replies: per-(acceptor, proposer, type)
    wires → ``(ok [B, N, 3], no [B, N, 3], cmd [B, N])`` at the proposer
    rows; each reply its own packet with its own delay draw.  Sharded, the
    counts are summed and the payloads max-reduced over the ranks (the
    repliers)."""
    dev = ok_wire.device
    n = ok_wire.shape[-3]
    key = dv._shard_key(key, axis)
    with dv.draw_rows(axis, -3):
        d = delay_ops.sample_edge_delays(key, (n, p, 3), lo, hi, dev, impl)
    if drop > 0.0:
        with dv.draw_rows(axis, -3):
            keep = threefry.bernoulli(threefry.fold_in(key, 0x0D21), 1.0 - drop,
                                      (n, p, 3), dev).to(_I32)
        ok_wire = ok_wire * keep
        no_wire = no_wire * keep
        cmd_wire = cmd_wire * keep[..., 0]
    hits = (d[None] == dv._bucket_iota(lo, hi, d.ndim, dev)).to(_I32)
    ok_b = (hits * ok_wire[None]).sum(-3, dtype=_I32)  # [B, P, 3]
    no_b = (hits * no_wire[None]).sum(-3, dtype=_I32)
    cmd_b = (hits[..., 0] * cmd_wire[None]).amax(-2)  # [B, P]
    ok_b, no_b, cmd_b = dv._psum(ok_b, axis), dv._psum(no_b, axis), dv._pmax(cmd_b, axis)
    take = torch.clamp(ids, 0, p - 1).to(torch.int64)
    is_prop = (ids < p).to(_I32)
    return (ok_b.index_select(-2, take) * is_prop[:, None],
            no_b.index_select(-2, take) * is_prop[:, None],
            cmd_b.index_select(-1, take) * is_prop)


@functools.lru_cache(maxsize=8)
def _inmask(n: int, degree: int, seed: int, p: int, device) -> torch.Tensor:
    """``[N, P]`` bool: does node j's in-table hold proposer p (the config's
    tables, made once per config and device)."""
    return _inmask_of(topo_spec.device_tables(n, degree, seed, device)[0], p)


def _inmask_of(nbr_in, p: int) -> torch.Tensor:
    props = torch.arange(p, device=nbr_in.device)
    return (nbr_in[:, :, None] == props[None, None, :]).any(1)


def step(cfg, state: PaxosState, bufs: PaxosBufs, t, tkey, *, topo_tables=None,
         exchange=None):
    """One tick.  ``t``: 0-d int32 tensor on the state's device; ``tkey``:
    the tick's threefry key (utils/prng.tick_key), or lane keys ``[L, 2]``
    for a lane-stacked state (module docstring).  ``init`` has checked
    that the config is ported.  ``topo_tables``: the kregular overlay's
    ``(in, out)`` tables when the caller holds them, else the config's
    own; ``exchange``: the sharded overlay's, whose tables are already
    this rank's rows (the in-table is read row-locally)."""
    n, p = cfg.n, cfg.paxos_n_proposers
    axis = cfg.mesh_axis
    lo, hi = cfg.one_way_range()
    drop = cfg.faults.drop_prob
    clean = cfg.fidelity == "clean"
    eimpl = cfg.eff_edge_sampler
    c_enc = n + 1  # encoding base: val = ticket * c_enc + command + 1
    dev = state.t_max.device
    n_loc = state.t_max.shape[-1]
    ids = dv._global_ids(n_loc, axis, dev)
    alive, honest = state.alive, state.honest

    # ---- pop arrivals; crashed nodes process nothing ------------------------
    rt_t, req_ticket = ring_pop(bufs.req_ticket, t)
    rp_t, req_propose = ring_pop(bufs.req_propose, t)
    rc_t, req_commit = ring_pop(bufs.req_commit, t)
    ok_t, resp_ok = ring_pop(bufs.resp_ok, t)
    no_t, resp_no = ring_pop(bufs.resp_no, t)
    cmd_t, resp_cmd = ring_pop(bufs.resp_cmd, t)
    am = alive.to(_I32)[..., None]
    rt_t, rp_t, rc_t = rt_t * am, rp_t * am, rc_t * am
    ok_t, no_t = ok_t * am, no_t * am
    am = am[..., 0]
    cmd_t = cmd_t * am

    # kregular overlay: requests reach only receivers whose in-table holds
    # the proposer (a row-local [N, P] reachability mask over the same
    # O(N·P) delivery); windows that cannot reach a majority time out and
    # retry until gave_up
    inmask = None
    if cfg.topology == "kregular":
        if topo_tables is None and axis is None:
            inmask = _inmask(n, cfg.degree, cfg.topo_seed, p, dev)
        else:
            inmask = _inmask_of(gd.local_tables(
                cfg, None if axis is None or exchange is not None else ids,
                tables=topo_tables, device=dev)[0], p)

    # ---- gossip decode: TTL values → new-request dedup + forward set --------
    gossip = cfg.topology == "gossip"
    seen = [state.seen_req[..., ci, :] for ci in range(3)]
    if gossip:
        h_enc = cfg.gossip_hops + 1
        nbrs = topology.neighbours(n, cfg.degree, cfg.seed, dev)
        if axis is not None:
            nbrs = nbrs.index_select(0, ids.to(torch.int64))
        fwd_vals, proc = [], []
        for ci, arr in enumerate((rt_t, rp_t, rc_t)):
            base, hops = arr // h_enc, arr % h_enc
            # acceptors process each base value once (first sighting) ...
            new_base = (base > seen[ci] // h_enc) & alive[..., None]
            # ... but forward any strictly better TTL-encoded copy
            better = (arr > seen[ci]) & alive[..., None]
            proc.append(base * new_base)
            seen[ci] = torch.maximum(seen[ci], arr * better)
            fwd_vals.append((base * h_enc + torch.clamp(hops - 1, min=0))
                            * (better & (hops > 0)))
        rt_t, rp_t, rc_t = proc

    # ---- acceptor FSM: concurrent requests serialized in proposer order -----
    t_max, command, t_store = state.t_max, state.command, state.t_store
    is_commit, exec_tick = state.is_commit, state.exec_tick
    tk_ok, tk_no, prom = [], [], []
    for q in range(p):  # REQUEST_TICKET
        tk = rt_t[..., q]
        ok = (tk > 0) & (tk > t_max)
        prom.append(torch.where(ok & (command >= 0), t_store * c_enc + command + 1, 0))
        t_max = torch.where(ok, tk, t_max)
        tk_ok.append(ok)
        tk_no.append((tk > 0) & ~ok)
    pr_ok, pr_no = [], []
    for q in range(p):  # REQUEST_PROPOSE
        v = rp_t[..., q]
        tkt, cmd = v // c_enc, v % c_enc - 1
        ok = (v > 0) & (tkt == t_max)
        command = torch.where(ok, cmd, command)
        t_store = torch.where(ok, tkt, t_store)
        pr_ok.append(ok)
        pr_no.append((v > 0) & ~ok)
    cm_ok, cm_no = [], []
    for q in range(p):  # REQUEST_COMMIT
        v = rc_t[..., q]
        tkt, cmd = v // c_enc, v % c_enc - 1
        ok = (v > 0) & (tkt == t_store) & (cmd == command)
        exec_tick = torch.where(ok & (exec_tick < 0), t, exec_tick)
        is_commit = is_commit | ok
        cm_ok.append(ok)
        cm_no.append((v > 0) & ~ok)
    ok_wire = torch.stack([torch.stack(tk_ok, -1), torch.stack(pr_ok, -1),
                           torch.stack(cm_ok, -1)], -1).to(_I32)  # [N, P, 3]
    no_wire = torch.stack([torch.stack(tk_no, -1), torch.stack(pr_no, -1),
                           torch.stack(cm_no, -1)], -1).to(_I32)
    # Byzantine acceptors flip their votes; only honest promises carry payloads
    hn = honest[..., None, None]
    ok_w = torch.where(hn, ok_wire, no_wire)
    no_w = torch.where(hn, no_wire, ok_wire)
    cmd_wire = torch.stack(prom, -1) * honest[..., None].to(_I32)
    any_req = (rt_t > 0).any() | (rp_t > 0).any() | (rc_t > 0).any()

    # ---- proposer FSM: response counting ------------------------------------
    adopt_val = torch.maximum(state.adopt_val, cmd_t)
    vs, vf = state.vote_success, state.vote_failed
    active = (ids < p) & alive & ~state.gave_up
    if clean:
        # per-phase counters: only replies of the current phase's type count
        ph = state.phase
        waiting = active & (ph >= PH_TICKET) & (ph <= PH_COMMIT)
        sel = torch.clamp(ph, 0, 2).to(torch.int64)[..., None]
        vs = vs + torch.gather(ok_t, -1, sel)[..., 0] * waiting
        vf = vf + torch.gather(no_t, -1, sel)[..., 0] * waiting
        advance = waiting & (vs >= cfg.quorum + 1)  # a true majority of all n
        # retry only by window timeout (the timeout exceeds the reply horizon)
        want_retry = waiting & ~advance & (t >= state.window_deadline)
        adv0 = advance & (ph == PH_TICKET)
        adv1 = advance & (ph == PH_PROPOSE)
        adv2 = advance & (ph == PH_COMMIT)
    else:
        # shared counters, the window closes crossing N-2 cumulative replies,
        # the closing reply's type picks the action; intra-tick reply order
        # is ticket → propose → commit
        win = n - 2
        before = vs + vf
        arr = ok_t + no_t  # [N, 3]
        cum0 = before + arr[..., 0]
        cum1 = cum0 + arr[..., 1]
        cum2 = cum1 + arr[..., 2]
        crossed = active & (before < win) & (cum2 >= win)
        ctype = torch.where(cum0 >= win, 0, torch.where(cum1 >= win, 1, 2))
        vs_at = (vs + ok_t[..., 0] + torch.where(ctype >= 1, ok_t[..., 1], 0)
                 + torch.where(ctype >= 2, ok_t[..., 2], 0))
        success = vs_at >= cfg.quorum  # vote_success >= N/2
        adv0 = crossed & success & (ctype == 0)
        adv1 = crossed & success & (ctype == 1)
        adv2 = crossed & success & (ctype == 2)
        want_retry = crossed & ~success
        # counters reset at the crossing; replies of later types keep counting
        left_ok = torch.where(ctype == 0, ok_t[..., 1] + ok_t[..., 2],
                              torch.where(ctype == 1, ok_t[..., 2], 0))
        left_no = torch.where(ctype == 0, no_t[..., 1] + no_t[..., 2],
                              torch.where(ctype == 1, no_t[..., 2], 0))
        vs = torch.where(crossed, left_ok, vs + ok_t.sum(-1, dtype=_I32))
        vf = torch.where(crossed, left_no, vf + no_t.sum(-1, dtype=_I32))

    # adoption at ticket→propose: the highest-t_store promise wins
    adopted_cmd = adopt_val % c_enc - 1
    proposal = torch.where(adv0 & (adopt_val > 0), adopted_cmd, state.proposal)
    # CLIENT COMMIT SUCCESS — the measurement point
    commit_tick = torch.where(adv2 & (state.commit_tick < 0), t, state.commit_tick)
    # retry: requireTicket — ticket += 1, bounded
    can_retry = state.ticket < cfg.paxos_max_ticket
    retry = want_retry & can_retry
    gave_up = state.gave_up | (want_retry & ~can_retry)
    # first firing: nodes 0..P-1 at t = 0; a designated client lane fires when
    # the simulated external client sends CLIENT_PROPOSE
    fire0 = (t == 0) & (ids < p) & alive
    cn = cfg.paxos_client_node
    if cn >= 0:
        is_client = ids == cn
        fire0 = (fire0 & ~is_client) | ((t == cfg.paxos_client_ms) & is_client & alive)
    send_tk = fire0 | retry
    ticket = torch.where(send_tk, state.ticket + 1, state.ticket)

    new_window = send_tk | adv0 | adv1
    if clean:
        phase = torch.where(adv0, PH_PROPOSE, torch.where(
            adv1, PH_COMMIT, torch.where(adv2, PH_DONE, state.phase)))
        phase = torch.where(retry, PH_TICKET, phase).to(_I32)
        # the proposer is an acceptor too: it processes its own request
        # locally; the three windows are mutually exclusive per row this tick
        self_tk_ok = send_tk & (ticket > t_max)
        self_enc = torch.where(self_tk_ok & (command >= 0),
                               t_store * c_enc + command + 1, 0)
        t_max = torch.where(self_tk_ok, ticket, t_max)
        self_pp_ok = adv0 & (state.ticket == t_max)
        command = torch.where(self_pp_ok, proposal, command)
        t_store = torch.where(self_pp_ok, state.ticket, t_store)
        self_cm_ok = adv1 & (state.ticket == t_store) & (proposal == command)
        exec_tick = torch.where(self_cm_ok & (exec_tick < 0), t, exec_tick)
        is_commit = is_commit | self_cm_ok
        self_ok = self_tk_ok | self_pp_ok | self_cm_ok
        vs = torch.where(new_window, self_ok.to(_I32), vs)
        vf = torch.where(new_window, (~self_ok).to(_I32), vf)
        adopt_val = torch.where(send_tk, self_enc, adopt_val)
    else:
        # reference proposers have no phase register and no timeout
        phase = torch.where(adv2, PH_DONE, torch.where(retry, PH_TICKET, state.phase)).to(_I32)
        adopt_val = torch.where(send_tk, 0, adopt_val)

    # ---- this tick's requests -----------------------------------------------
    tk_val = ticket * send_tk
    pp_val = (state.ticket * c_enc + proposal + 1) * adv0
    cm_val = (state.ticket * c_enc + state.proposal + 1) * adv1
    chans = (Channel.DELAY_BCAST, Channel.DELAY_BCAST2, Channel.DELAY_BCAST3)
    if gossip:
        # a proposer's own send is the flood origin: full TTL, own column,
        # marked seen so no loopback copy (necessarily fewer hops) is
        # ever re-forwarded
        own = (ids[:, None] == torch.arange(p, device=dev)[None, :]).to(_I32)
        outs = []
        for ci, val in enumerate((tk_val, pp_val, cm_val)):
            init_mat = val[..., None] * own
            init_enc = (init_mat * h_enc + cfg.gossip_hops) * (init_mat > 0)
            seen[ci] = torch.maximum(seen[ci], init_enc)
            outs.append(torch.maximum(fwd_vals[ci], init_enc))
        sends = [o > 0 for o in outs]
    else:
        outs = (tk_val, pp_val, cm_val)
        sends = [v > 0 for v in outs]

    # the tick's one host read: the gates of the four deliveries and the
    # jitter (agreed over the ranks: the deliveries hold collectives)
    flags = dv._pmax(torch.stack([any_req, new_window.any()] + [s.any() for s in sends]),
                     axis).tolist()
    any_reply, any_window, req_on = flags[0], flags[1], flags[2:]
    window_deadline = state.window_deadline
    if clean and any_window:
        # jittered deadline: identical timeouts would make dueling proposers
        # retry in lockstep forever (a symmetric livelock)
        with dv.draw_rows(axis):
            jitter = threefry.randint(dv._shard_key(chan_key(tkey, Channel.ELECTION), axis),
                                      (n_loc,), 0, max(cfg.paxos_retry_timeout_ms // 2, 1),
                                      dev)
        window_deadline = torch.where(
            new_window, t + cfg.paxos_retry_timeout_ms + jitter, window_deadline)
    pushes = []
    if any_reply:
        ok_c, no_c, cmd_c = _reply_contribs(chan_key(tkey, Channel.DELAY_REPLY), ok_w,
                                            no_w, cmd_wire, lo, hi, drop, ids, p,
                                            impl=eimpl, axis=axis)
        pushes += [(resp_ok, lo, ok_c, "add"), (resp_no, lo, no_c, "add"),
                   (resp_cmd, lo, cmd_c, "max")]
    for ring, val, chan, on in zip((req_ticket, req_propose, req_commit), outs, chans,
                                   req_on):
        if not on:
            continue
        if gossip:
            contrib = dv.gossip_fwd(chan_key(tkey, chan), val, nbrs, n, lo, hi, drop,
                                    axis=axis, impl=eimpl)
        else:
            contrib = _req_contrib(chan_key(tkey, chan), val, lo, hi, drop, ids, p,
                                   not clean, impl=eimpl, inmask=inmask, axis=axis)
        pushes.append((ring, lo, contrib, "max"))
    ring_push_group(pushes, t)  # in place; no launch when nothing is pushed

    state = dataclasses.replace(
        state,
        t_max=t_max,
        command=command,
        t_store=t_store,
        is_commit=is_commit,
        exec_tick=exec_tick,
        ticket=ticket,
        phase=phase,
        vote_success=vs,
        vote_failed=vf,
        proposal=proposal,
        adopt_val=adopt_val,
        commit_tick=commit_tick,
        gave_up=gave_up,
        window_deadline=window_deadline,
        seen_req=torch.stack(seen, -2) if gossip else state.seen_req,
    )
    bufs = PaxosBufs(req_ticket=req_ticket, req_propose=req_propose,
                     req_commit=req_commit, resp_ok=resp_ok, resp_no=resp_no,
                     resp_cmd=resp_cmd)
    return state, bufs


def metrics(cfg, state: PaxosState) -> dict:
    """The reference's measurement surface (CLIENT COMMIT SUCCESS with
    ticket/id/time, ticket requests) plus the safety invariants, on the
    host (same arithmetic as the JAX package)."""
    def host(x):
        return x.detach().cpu().numpy()

    p = cfg.paxos_n_proposers
    alive = host(state.alive)
    commit_tick = host(state.commit_tick)[:p]
    ticket = host(state.ticket)[:p]
    is_commit = host(state.is_commit)
    command = host(state.command)
    exec_tick = host(state.exec_tick)
    proposal = host(state.proposal)[:p]
    winners = np.flatnonzero(commit_tick >= 0)
    winner = int(winners[np.argmin(commit_tick[winners])]) if winners.size else -1
    executed = np.flatnonzero(is_commit & alive)
    exec_cmds = np.unique(command[executed]) if executed.size else np.array([])
    if winners.size and not exec_cmds.size:
        # a committed proposer whose commit quorum left zero executed alive
        # acceptors claimed executions nobody holds — an inconsistency
        agreement = False
    else:
        agreement = len(exec_cmds) <= 1 and all(
            proposal[w] == exec_cmds[0] for w in winners
        )
    return {
        "protocol": "paxos",
        "n": cfg.n,
        "n_committed_proposers": int(winners.size),
        "winner": winner,
        "winner_commit_ms": float(commit_tick[winner]) if winner >= 0 else -1.0,
        "winner_ticket": int(ticket[winner]) if winner >= 0 else -1,
        "max_ticket": int(ticket.max()) if p else 0,
        "retries": int((ticket - 1).clip(min=0).sum()),
        "acceptor_executes": int(executed.size),
        "first_execute_ms": float(exec_tick[executed].min()) if executed.size else -1.0,
        "decided_command": int(exec_cmds[0]) if exec_cmds.size else -1,
        "gave_up": int(host(state.gave_up).sum()),
        "agreement_ok": bool(agreement),
    }
