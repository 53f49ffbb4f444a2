"""PBFT round-blocked fast path: one step = one block interval, in PyTorch.

Port of ``blockchain_simulator_tpu/models/pbft_round.py``, whose docstring
holds the design: when no message crosses a round boundary, a whole PBFT
round is a closed wave (propose at ``t0``; PRE_PREPAREs land at ``t0 + ser +
d_j``; PREPARE round-trip replies arrive as multinomial bucket counts;
counters cross their thresholds in a short loop over the buckets; COMMIT
broadcasts group by send tick and land as multinomial counts again), so a
round is a handful of ops on ``[N]`` vectors with no vote table and no
rings.  Same keys, same int32 and float32 arithmetic: a run is bit-equal to
the JAX package's (``tests/test_torch_round.py``).

*Lanes.*  ``init`` given lane keys ``[B, 2]`` builds ``B`` runs side by
side (state ``[B, N]``, slot tables ``[B, S]``), and ``step_round`` /
``scan_rounds`` given lane keys step them together: ``jax.vmap`` of the JAX
functions over the keys, as the fault sweeps run them
(parallel/sweep.py).  Every scalar of a round becomes ``[B]``, the slot
writes scatter each lane's row, the threefry draws stay per lane, and the
stat chains take lane keys (ops/delay.py): the ``"normal"`` draws follow
the first lane's key, the ``"exact"`` loops end each lane where its own
would.  A single key keeps the ``[N]`` path with its launches.

PyTorch idiom: ``scan_rounds`` is a Python loop over the rounds, with every
round's threefry key computed on the host before the loop.  Nothing in a
round reads the device back to the host under the ``"normal"`` stat sampler
(the ``"exact"`` sampler's rejection loops test their stop condition on the
host once an iteration), so a CUDA graph can capture the loop.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from blockchain_simulator_tpu_torch.models import pbft as pbft_tick
from blockchain_simulator_tpu_torch.models.base import fault_masks, stack_samples
from blockchain_simulator_tpu_torch.ops import delay as delay_ops
from blockchain_simulator_tpu_torch.ops import delivery as dv
from blockchain_simulator_tpu_torch.utils import prng, threefry
from blockchain_simulator_tpu_torch.utils.prng import Channel, chan_key

_NEVER = pbft_tick._NEVER
_I32 = torch.int32

GLOBAL_FIELDS = pbft_tick.GLOBAL_FIELDS


@dataclasses.dataclass
class PbftRoundState:
    """Cross-round state only; the field names are those of
    ``pbft.PbftState``, so ``pbft.metrics`` reads either."""

    v: torch.Tensor             # [N]
    leader: torch.Tensor        # [N]
    next_n: torch.Tensor        # [N]
    rounds_sent: torch.Tensor   # [N]
    block_num: torch.Tensor     # [N]
    unattributed: torch.Tensor  # [N] (always 0 on this path)
    view_changes: torch.Tensor  # [N]
    alive: torch.Tensor         # [N]
    honest: torch.Tensor        # [N]
    slot_commits: torch.Tensor       # [S]
    slot_commit_tick: torch.Tensor   # [S]
    slot_propose_tick: torch.Tensor  # [S]


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(PbftRoundState))


def max_arrival_offset(cfg) -> int:
    """Latest in-round event offset: commit sent at (hi-1)+rt_hi-1 arriving
    +hi-1 later."""
    _, hi = cfg.one_way_range()
    _, rt_hi = cfg.roundtrip_range()
    return (hi - 1) + (rt_hi - 1) + (hi - 1)


def eligible(cfg) -> bool:
    """Full-mesh stat PBFT whose rounds close inside one block interval,
    with drops only while the leader never changes and the vote table is
    exact (the JAX function's rule, word for word)."""
    ser = cfg.serialization_ticks(cfg.pbft_block_bytes)
    return (
        cfg.protocol == "pbft"
        and cfg.topology == "full"
        and cfg.delivery == "stat"
        and (
            cfg.faults.drop_prob == 0.0
            or (
                cfg.pbft_view_change_num == 0
                and pbft_tick.eff_window(cfg) >= cfg.pbft_max_slots
            )
        )
        and not cfg.faults.byz_forge
        and not cfg.queued_links
        and ser + max_arrival_offset(cfg) < cfg.pbft_block_interval_ms
    )


def init(cfg, key=None, *, device):
    """``(PbftRoundState, ())`` on ``device``; lane keys ``[B, 2]`` give
    ``B`` lanes (module docstring).  The fault masks are deterministic, as
    in the JAX package: the key only sets the lane count."""
    if cfg.mesh_axis is not None:
        raise NotImplementedError(
            "mesh_axis (node-sharded runs) comes with slice 6 of the port "
            "(many GPUs)"
        )
    sh = (len(key),) if key is not None and np.ndim(key) == 2 else ()
    n, s = cfg.n, cfg.pbft_max_slots
    alive, honest = (m.expand(sh + (n,)).contiguous() for m in fault_masks(cfg, n, device))

    def full(dims, val):
        return torch.full(sh + dims, val, dtype=_I32, device=device)

    state = PbftRoundState(
        v=full((n,), 1),
        leader=full((n,), 0),
        next_n=full((n,), 0),
        rounds_sent=full((n,), 0),
        block_num=full((n,), 0),
        unattributed=full((n,), 0),
        view_changes=full((n,), 0),
        alive=alive,
        honest=honest,
        slot_commits=full((s,), 0),
        slot_commit_tick=full((s,), -1),
        slot_propose_tick=full((s,), _NEVER),
    )
    return state, ()


def _col(x, ndim: int):
    """``x [K]`` shaped ``[K, 1, ..., 1]`` against a ``[K, ...]`` operand of
    ``ndim`` dims."""
    return x.reshape((-1,) + (1,) * (ndim - 1))


def _crossing_loop(buckets, need: int, clean: bool):
    """Threshold crossings of a vote counter fed bucket by bucket (``[K,
    ..., N]`` arrival counts in tick order), by the tick engine's rule:
    counter += arrivals; crossed iff arrivals > 0 and counter >= need; a
    crossing resets the counter (reference fidelity) or latches (clean,
    first crossing only).  Returns (crossed [K, ..., N] bool, n_crossings
    [..., N])."""
    b = buckets.shape[0]
    rows = _col(torch.arange(b, device=buckets.device), buckets.ndim)
    if clean:
        # latched: the counter never resets before it fires, so the running
        # sum IS the counter up to the crossing
        csum = torch.cumsum(buckets, 0, dtype=_I32)
        qual = (buckets > 0) & (csum >= need)
        any_q = qual.any(0)
        first = torch.argmax(qual.to(_I32), 0)  # the first qualifying bucket
        crossed = (rows == first[None]) & any_q[None]
        return crossed, any_q.to(_I32)
    cnt = torch.zeros_like(buckets[0])
    crossed_list = []
    for k in range(b):
        arr = buckets[k]
        cnt = cnt + arr
        hit = (arr > 0) & (cnt >= need)
        cnt = torch.where(hit, 0, cnt)
        crossed_list.append(hit)
    crossed = torch.stack(crossed_list)
    return crossed, crossed.sum(0, dtype=_I32)


@dataclasses.dataclass(frozen=True)
class _RoundConsts:
    ids: torch.Tensor         # [N] node ids
    rt_iota: torch.Tensor     # [B2, 1] round-trip bucket offsets
    arr_iota: torch.Tensor    # [W_arr] commit arrival bucket offsets
    d_iota: torch.Tensor      # [B1, 1] one-way delays lo..hi-1


@functools.lru_cache(maxsize=8)
def _round_consts(cfg, device) -> _RoundConsts:
    lo, hi = cfg.one_way_range()
    rt_lo, rt_hi = cfg.roundtrip_range()
    b1, b2 = hi - lo, rt_hi - rt_lo
    w_arr = (b1 + b2 - 1) + b1 - 1
    return _RoundConsts(
        ids=dv._global_ids(cfg.n, None, device),
        rt_iota=torch.arange(b2, dtype=_I32, device=device)[:, None],
        arr_iota=torch.arange(w_arr, dtype=_I32, device=device),
        d_iota=torch.arange(lo, hi, dtype=_I32, device=device)[:, None],
    )


def _shift_sum(rows, b1: int):
    """``sum_e pad(rows[e], ((e, b1-1-e), (0, 0), ...))``: fold a length-``b1``
    offset axis into the leading axis (the anti-diagonal pad-and-add
    convolution of the JAX function)."""
    rest = (0, 0) * (rows.ndim - 2)
    return sum(F.pad(rows[e], rest + (e, b1 - 1 - e)) for e in range(b1))


def step_round(cfg, state: PbftRoundState, r: int, tkey):
    """Advance one whole block interval starting at ``t0 = r * interval``;
    ``tkey`` is the tick key of ``t0`` (``prng.tick_key(key, t0)``), or one a
    lane (``[B, 2]``) for a lane-stacked state.  Events past the simulation
    window (``cfg.ticks``) are masked, as the tick engine truncates a final
    round's wave mid-flight."""
    n, s = cfg.n, cfg.pbft_max_slots
    bt = cfg.pbft_block_interval_ms
    lo, hi = cfg.one_way_range()
    rt_lo, rt_hi = cfg.roundtrip_range()
    b1 = hi - lo
    clean = cfg.fidelity == "clean"
    smode = cfg.eff_stat_sampler
    drop = cfg.faults.drop_prob
    ow_probs = delay_ops.uniform_probs(lo, hi)
    rt_probs = delay_ops.roundtrip_probs(lo, hi)
    ser = cfg.serialization_ticks(cfg.pbft_block_bytes)
    t0 = r * bt
    t_end = cfg.ticks  # arrivals at tick >= t_end never land
    dev = state.v.device
    consts = _round_consts(cfg, dev)
    ids = consts.ids
    lanes = np.ndim(tkey) == 2  # [B, N] state, [B] round scalars

    # ---- A. block tick: SendBlock + view-change draw ------------------------
    send = ((state.leader == ids)
            & (state.next_n < min(cfg.pbft_max_rounds, s))
            & state.alive)
    slot_p1 = torch.where(send, state.next_n + 1, 0).amax(-1)  # 0 = none
    active = slot_p1 > 0
    rounds_sent = state.rounds_sent + send
    next_n = torch.where(send, state.next_n + 1, state.next_n)
    next_n = torch.maximum(next_n, slot_p1[..., None])
    slot_idx = torch.where(active, slot_p1 - 1, s)[..., None].to(torch.int64)
    slot_propose_tick = pbft_tick._scatter_drop(
        state.slot_propose_tick, slot_idx,
        torch.where(active[..., None], torch.full((1,), t0, dtype=_I32, device=dev),
                    _NEVER),
        "amin", _NEVER)

    u = threefry.randint(chan_key(tkey, Channel.VIEW_CHANGE), (n,), 0,
                         cfg.pbft_view_change_den, dev)
    trigger = send & (u < cfg.pbft_view_change_num)
    any_trigger = trigger.any(-1)[..., None]
    new_leader = torch.where(trigger, (state.leader + 1) % n, 0).amax(-1)[..., None]
    view_changes = state.view_changes + trigger
    v = torch.where(any_trigger, state.v + 1, state.v)
    leader = torch.where(any_trigger, new_leader, state.leader)

    # ---- B. PRE_PREPARE arrivals + PREPARE round trips ----------------------
    k_pp = chan_key(tkey, Channel.DELAY_BCAST2)
    d_j = threefry.randint(k_pp, (n,), lo, hi, dev)
    recv = active[..., None] & state.alive & ~send & (t0 + ser + d_j < t_end)
    if drop > 0.0:
        recv = recv & threefry.bernoulli(threefry.fold_in(k_pp, 0x0D0D),
                                         1.0 - drop, (n,), dev)
    voters = state.alive & state.honest
    vi = voters.to(_I32)
    n_voters = vi.sum(-1, keepdim=True, dtype=_I32)
    rt_counts = dv.roundtrip_reply_counts_stat(
        chan_key(tkey, Channel.DELAY_ROUNDTRIP), recv, n_voters - vi, rt_probs,
        drop, mode=smode,
    )  # [B2, ..., N]: bucket k lands at t0 + ser + d_j + rt_lo + k
    rt_land = (t0 + ser + rt_lo + d_j[None] + _col(consts.rt_iota, d_j.ndim + 1)) < t_end
    rt_counts = rt_counts * rt_land.to(_I32)
    crossed_p, _ = _crossing_loop(rt_counts, cfg.pbft_prepare_need, clean)
    commit_send = crossed_p & voters[None]  # [B2, ..., N]

    # ---- C. COMMIT waves -> finality ----------------------------------------
    # sender j's k-th crossing is at offset ser + d_j + rt_lo + k: group the
    # sends by offset (d_j - lo) + k along a [W_send, ..., N] axis
    off_base = ser + lo + rt_lo
    oh_d = (d_j[None] == _col(consts.d_iota, d_j.ndim + 1)).to(_I32)  # [B1, ..., N]
    cs = commit_send.to(_I32)
    send_at = _shift_sum(cs[None] * oh_d[:, None], b1)  # [W_send, ..., N]
    totals = send_at.sum(-1, keepdim=True, dtype=_I32)
    k_cm = chan_key(tkey, Channel.DELAY_BCAST)
    m_all = torch.where(state.alive[None], totals - send_at, 0)
    if lanes:  # the samplers take the lane axis first
        m_all = m_all.movedim(1, 0)
    if drop > 0.0:
        m_all = torch.round(delay_ops.binom(threefry.fold_in(k_cm, 0x0D12), m_all,
                                            1.0 - drop, smode)).to(_I32)
    cnt_all = delay_ops.sample_bucket_counts(k_cm, m_all, ow_probs, smode)
    if lanes:
        cnt_all = cnt_all.movedim(1, 2)  # [B1, W_send, B, N]
    arrivals = _shift_sum(cnt_all, b1)  # [W_arr, ..., N]: bucket i lands at
    # t0 + off_base + lo + i
    arr_tick = _col(t0 + off_base + lo + consts.arr_iota, arrivals.ndim)
    arrivals = arrivals * (arr_tick < t_end).to(_I32)
    crossed_c, n_cross_c = _crossing_loop(arrivals, cfg.pbft_commit_need, clean)
    first_commit = crossed_c.any(0) & active[..., None]
    block_num = state.block_num + torch.where(active[..., None], n_cross_c, 0)
    last_tick = torch.where(crossed_c, arr_tick, -1).amax(dim=(0, -1))
    n_first = first_commit.sum(-1, dtype=_I32)
    slot_commits = pbft_tick._scatter_drop(
        state.slot_commits, slot_idx,
        torch.where(active, n_first, 0)[..., None], "sum", 0)
    slot_commit_tick = pbft_tick._scatter_drop(
        state.slot_commit_tick, slot_idx,
        torch.where(active & (n_first > 0), last_tick, -1)[..., None], "amax", -1)

    return dataclasses.replace(
        state,
        v=v,
        leader=leader,
        next_n=next_n,
        rounds_sent=rounds_sent,
        block_num=block_num,
        view_changes=view_changes,
        slot_commits=slot_commits,
        slot_commit_tick=slot_commit_tick,
        slot_propose_tick=slot_propose_tick,
    )


def round_range(cfg) -> range:
    """The rounds a run steps: r runs iff its block tick r*interval lies
    inside the window (r >= 1)."""
    return range(1, (cfg.ticks - 1) // cfg.pbft_block_interval_ms + 1)


def scan_rounds(cfg, state: PbftRoundState, key, with_probe=False):
    """Step every block interval inside the simulation window from
    ``state``; ``key`` is the run's base threefry key, or one a lane
    (``[B, 2]``) for a lane-stacked state.

    ``with_probe=True`` (utils/trace.run_traced) also records the standard
    PBFT probe (utils/trace.probe reads the field names this state shares
    with the tick engine's) after every round, and returns ``(state, ys)``:
    ``ys`` maps each probe name to a ``[rounds]`` tensor on the state's
    device, stacked once at the end (no host read in the loop).  A callable
    ``with_probe`` (``state -> {name: 0-d tensor}``) is used as the probe
    instead.  The probe only reads, so the state is the unprobed run's.
    Probed lane batches (the sweeps' ``probe=``, obsim) come with the
    services slice of the port."""
    if with_probe is True:
        from blockchain_simulator_tpu_torch.utils import trace

        probe_fn = functools.partial(trace.probe, cfg)
    else:
        probe_fn = with_probe or None
    if probe_fn is not None and np.ndim(key) == 2:
        raise NotImplementedError(
            "probed lane batches (the sweeps' probe=, obsim) come with the "
            "durable-sweeps slice of the port (journal, query, obsim; ROADMAP.md queue A)"
        )
    rounds = round_range(cfg)
    bt = cfg.pbft_block_interval_ms
    ticks = np.asarray([r * bt for r in rounds], np.int64)
    # [R, 2], or [R, B, 2] for lane keys
    tkeys = prng.tick_key(np.asarray(key)[None], ticks.reshape((-1,) + (1,) * (np.ndim(key) - 1)))
    samples = []
    for i, r in enumerate(rounds):
        state = step_round(cfg, state, r, tkeys[i])
        if probe_fn is not None:
            samples.append(probe_fn(state))
    if probe_fn is None:
        return state
    return state, stack_samples(samples, lambda: probe_fn(state))


def metrics(cfg, state) -> dict:
    """Same measurement surface as the tick engine (pbft.metrics)."""
    return pbft_tick.metrics(cfg, state)
