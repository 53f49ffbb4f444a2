"""Mixed-protocol shard sim (BASELINE config 5), in PyTorch.

Port of ``blockchain_simulator_tpu/models/mixed.py`` (whose docstring holds
the design): ``S`` Raft shards of ``m`` nodes each (``n = S·m``) elect and
replicate inside each shard, while a PBFT instance over the ``S`` shard
representatives finalizes global blocks.  A representative is alive on a
tick iff its shard has an elected, alive leader.

The JAX package ``jax.vmap``s the Raft step over the shards.  Here the Raft
state carries the shard axis itself: ``models/raft.py`` builds ``[S, m, ...]``
state and slot-major ``[D, S, m, ...]`` rings from lane keys, and its one
step takes the tick's per-shard keys.  So a tick is one Raft step over all
shards (its host reads are the single instance's, its pushes one grouped
launch with rows of ``S·m``) and one PBFT step at ``n = S``.

Two schedules, as in the JAX package: the tick engine runs :func:`step`
every tick (runner.make_sim_fn), and :func:`scan_fast` runs it over the
Raft election prefix, checks the handoff in every shard with one host read,
then either finishes with the ``[S]`` heartbeat scan (models/raft_hb.py)
and the per-tick PBFT layer with ``alive`` pinned true, or continues the
tick engine from the prefix carry.

Sharded (``mesh_axis`` set, parallel/shard.py): the Raft shards are
row-sharded over the mesh (embarrassingly parallel: each shard's keys fold
in its GLOBAL shard index, the rank's first shard plus its row), the
``[S]`` has-leader mask is all-gathered, and the S-representative PBFT
layer is replicated, every rank stepping an identical copy with identical
keys; the handoff verdict is summed over the ranks, so every rank takes the
same schedule.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from blockchain_simulator_tpu_torch.models import pbft, raft, raft_hb
from blockchain_simulator_tpu_torch.models.base import stack_samples, tick_loop
from blockchain_simulator_tpu_torch.ops import delivery as dv
from blockchain_simulator_tpu_torch.utils import prng, threefry
from blockchain_simulator_tpu_torch.utils.config import FaultConfig

_RAFT_STEP = 0x0C0C  # + shard: the shard's key within a tick
_PBFT_STEP = 0x9B9B  # the PBFT layer's key within a tick
_PBFT_INIT = 0x5AFE
_HB_SCAN = 0x4BB7    # + shard: the shard's heartbeat-scan key


@dataclasses.dataclass
class MixedState:
    raft: raft.RaftState  # fields [S, m, ...]
    pbft: pbft.PbftState  # fields [S, ...]


@dataclasses.dataclass
class MixedBufs:
    raft: raft.RaftBufs  # rings [D_raft, S, m, ...] (slot-major; JAX: [S, D, m])
    pbft: pbft.PbftBufs  # rings [D_pbft, S, ...]


@functools.lru_cache(maxsize=16)
def sub_configs(cfg):
    """``(raft_cfg for one m-node shard, pbft_cfg over S representatives)``.
    The Raft sub-config resolves ``stat_sampler`` at the parent's n (so
    config 5's shards draw ``"normal"``); the PBFT layer keeps its own
    ``"auto"``, and no faults (a representative fails by losing its
    leader)."""
    s = cfg.mixed_shards
    rcfg = cfg.with_(protocol="raft", n=cfg.n // s, mesh_axis=None,
                     stat_sampler=cfg.eff_stat_sampler)
    pcfg = cfg.with_(protocol="pbft", n=s, mesh_axis=None, faults=FaultConfig())
    return rcfg, pcfg


def _shard_keys(key, fold: int, s: int) -> np.ndarray:
    """``vmap(lambda i: fold_in(key, fold + i))(arange(s))``: ``[S, 2]``."""
    return threefry.fold_in(key, fold + np.arange(s, dtype=np.int64))


def _base(cfg, s_loc: int) -> int:
    """The global index of this rank's first Raft shard (0 unsharded)."""
    return 0 if cfg.mesh_axis is None else dv.mesh_of(cfg.mesh_axis).row_base(s_loc)


def init(cfg, key=None, *, device, rows=None):
    """``(MixedState, MixedBufs)`` on ``device``; ``rows=(start, count)``
    builds only those Raft shards (a rank's block of a sharded run), the
    PBFT layer whole."""
    s = cfg.mixed_shards
    if cfg.n % s != 0:
        raise ValueError(f"n={cfg.n} not divisible into {s} shards")
    if cfg.n // s < 3:
        raise ValueError("shard size must be >= 3 for a meaningful raft quorum")
    rcfg, pcfg = sub_configs(cfg)
    k = threefry.key(cfg.seed) if key is None else key
    start, s_loc = (0, s) if rows is None else rows
    r_state, r_bufs = raft.init(rcfg, _shard_keys(k, start, s_loc), device=device)
    p_state, p_bufs = pbft.init(pcfg, threefry.fold_in(k, _PBFT_INIT), device=device)
    # no representative is alive until its shard elects a leader
    p_state = dataclasses.replace(p_state, alive=torch.zeros((s,), dtype=torch.bool,
                                                             device=device))
    return MixedState(raft=r_state, pbft=p_state), MixedBufs(raft=r_bufs, pbft=p_bufs)


def step(cfg, state: MixedState, bufs: MixedBufs, t, tkey):
    """One tick: the Raft step over every shard, then the PBFT layer with
    ``alive`` = "the shard has an elected, alive leader"."""
    rcfg, pcfg = sub_configs(cfg)
    s_loc = state.raft.block_num.shape[0]
    r_state, r_bufs = raft.step(rcfg, state.raft, bufs.raft, t,
                                _shard_keys(tkey, _RAFT_STEP + _base(cfg, s_loc), s_loc))
    has_leader = dv._gather((r_state.is_leader & r_state.alive).any(-1), cfg.mesh_axis)
    p_state = dataclasses.replace(state.pbft, alive=has_leader)
    p_state, p_bufs = pbft.step(pcfg, p_state, bufs.pbft, t,
                                threefry.fold_in(tkey, _PBFT_STEP))
    return MixedState(raft=r_state, pbft=p_state), MixedBufs(raft=r_bufs, pbft=p_bufs)


def fast_eligible(cfg) -> bool:
    """Can the Raft shards ride the heartbeat scan: the shard sub-config's
    ``raft_hb.eligible``."""
    if cfg.protocol != "mixed":
        return False
    if cfg.n % cfg.mixed_shards != 0 or cfg.n // cfg.mixed_shards < 3:
        return False  # init rejects these with a better message
    return raft_hb.eligible(sub_configs(cfg)[0])


def prefix_handoff(cfg, state, bufs, key):
    """The per-tick engine through the Raft election prefix, then the
    checked handoff in every shard (one host read).  Returns ``((state,
    bufs), ok_all, Handoff)``."""
    rcfg, _ = sub_configs(cfg)
    carry = tick_loop(cfg, state, bufs, key, 0, raft_hb.prefix_ticks(rcfg))
    ok_s, h = raft_hb.handoff(rcfg, carry[0].raft)
    if cfg.mesh_axis is None:
        return carry, bool(ok_s.all()), h
    # the verdict summed over the ranks: every rank takes the same schedule
    bad = dv._psum(torch.tensor(int((~ok_s).sum()), dtype=torch.int32,
                                device=dv.mesh_of(cfg.mesh_axis).device), cfg.mesh_axis)
    return carry, int(bad) == 0, h


def fast_finish(cfg, carry, h, key, with_probe: bool = False):
    """The steady phase from a quiet handoff in every shard: the ``[S]``
    heartbeat scan and its write-back, then the PBFT layer every tick with
    ``alive`` pinned true.  Returns the final ``MixedState``; with
    ``with_probe`` (utils/trace.run_traced) ``(state, (raft_ys, pbft_ys))``:
    the heartbeat scan's per-shard series ``[S, K]`` and the PBFT layer's
    ``global_blocks`` / ``global_commit_events`` after every tick, ``[ticks
    - t_e]``, all int32 on the device."""
    rcfg, pcfg = sub_configs(cfg)
    t_e = raft_hb.prefix_ticks(rcfg)
    s = cfg.mixed_shards
    st, bf = carry
    s_loc = st.raft.block_num.shape[0]
    res = raft_hb.steady_scan(rcfg, _shard_keys(key, _HB_SCAN + _base(cfg, s_loc), s_loc), h,
                              with_probe=with_probe)
    if with_probe:
        res, raft_ys = res
    raft_final = raft_hb.materialize(rcfg, st.raft, h, res)
    dev = st.pbft.alive.device
    # every shard keeps its leader from here on (pbft.step leaves alive as is)
    ps = dataclasses.replace(st.pbft, alive=torch.ones((s,), dtype=torch.bool, device=dev))
    pb = bf.pbft
    stop = max(cfg.ticks, t_e)
    ticks = torch.arange(t_e, stop, dtype=torch.int32, device=dev)
    tkeys = threefry.fold_in(prng.tick_key(key, range(t_e, stop)), _PBFT_STEP)
    samples = []
    for i in range(stop - t_e):
        ps, pb = pbft.step(pcfg, ps, pb, ticks[i], tkeys[i])
        if with_probe:
            samples.append(_layer_probe(ps))
    final = MixedState(raft=raft_final, pbft=ps)
    if not with_probe:
        return final
    return final, (raft_ys, stack_samples(samples, lambda: _layer_probe(ps)))


def _layer_probe(ps) -> dict:
    """The global PBFT layer's probe sample (int32 0-d tensors)."""
    return {"global_blocks": ps.block_num.max(),
            "global_commit_events": ps.slot_commits.sum(dtype=torch.int32)}


def scan_fast(cfg, state: MixedState, bufs: MixedBufs, key):
    """The heartbeat-scheduled mixed sim: the prefix on the tick engine, the
    handoff's one host read, then :func:`fast_finish` when every shard is
    quiet, else the tick engine continued from the prefix carry (tick keys
    derive from the absolute tick, so that equals one uninterrupted tick
    run)."""
    rcfg, _ = sub_configs(cfg)
    t_e = raft_hb.prefix_ticks(rcfg)
    carry, ok_all, h = prefix_handoff(cfg, state, bufs, key)
    if ok_all:
        return fast_finish(cfg, carry, h, key)
    st, _ = tick_loop(cfg, *carry, key, t_e, max(cfg.ticks, t_e))
    return st


def metrics(cfg, state: MixedState) -> dict:
    """Per-shard Raft milestones and the global PBFT layer's, recomputed on
    the host with the JAX package's arithmetic."""
    def host(x):
        return x.detach().cpu().numpy()

    s = cfg.mixed_shards
    _, pcfg = sub_configs(cfg)
    is_leader = host(state.raft.is_leader) & host(state.raft.alive)
    has_leader = is_leader.any(axis=1)
    block_num = host(state.raft.block_num)
    leader_tick = host(state.raft.leader_tick)
    # per-shard raft blocks: the earliest-elected current leader's count
    lt = np.where(is_leader, leader_tick, np.iinfo(np.int32).max)
    lead_idx = lt.argmin(axis=1)
    shard_blocks = np.where(has_leader, block_num[np.arange(s), lead_idx], 0)
    pm = pbft.metrics(pcfg, state.pbft)
    return {
        "protocol": "mixed",
        "n": cfg.n,
        "shards": s,
        "shard_size": cfg.n // s,
        "shards_with_leader": int(has_leader.sum()),
        "raft_blocks_total": int(shard_blocks.sum()),
        "raft_blocks_min": int(shard_blocks[has_leader].min()) if has_leader.any() else 0,
        "global_blocks_final": pm["blocks_final_all_nodes"],
        "global_rounds_sent": pm["rounds_sent"],
        "global_mean_ttf_ms": pm["mean_time_to_finality_ms"],
        "agreement_ok": pm["agreement_ok"],
    }
