"""Simulation runner (port of ``blockchain_simulator_tpu/runner.py``).

The JAX package runs the whole simulation as one ``jax.lax.scan``; here the
scan is a Python loop.  The tick engine's loop calls ``proto.step`` with the
tick as a one-element int32 tensor on the device (rings index with it without
a host read) and the tick's threefry key, precomputed on the host for all
ticks at once (utils/prng.tick_key takes an array of ticks).  PBFT configs
that ``use_round_schedule`` resolves to the round-blocked fast path loop over
block intervals instead (models/pbft_round.scan_rounds); Raft configs it
resolves to the heartbeat-blocked path run models/raft_hb.run (the election
prefix on the tick engine, then one step a heartbeat), and mixed configs
models/mixed.scan_fast (the same in every Raft shard, beside the per-tick
PBFT layer).

Entry points run on the CUDA card unless the caller asks for another device
(``device="cpu"``, as the tests do); without CUDA they raise instead of
carrying on on the CPU.
"""

from __future__ import annotations

import torch

from blockchain_simulator_tpu_torch.models.base import get_protocol, sim_metrics
from blockchain_simulator_tpu_torch.utils import prng, threefry
from blockchain_simulator_tpu_torch.utils.config import SimConfig

_INIT_FOLD = 0x1217  # proto.init's key, as in the JAX package


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a missing card is an error."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on a CUDA device by default and torch reports none; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return dev


def use_round_schedule(cfg: SimConfig) -> bool:
    """Resolve cfg.schedule as the JAX package does: does this config run a
    phase-blocked fast path (PBFT: one step a block interval,
    models/pbft_round.py; Raft: one step a heartbeat, models/raft_hb.py;
    mixed: the heartbeat scan in every Raft shard, models/mixed.py)?"""
    if cfg.schedule == "tick":
        return False
    if cfg.topology in ("kregular", "committee"):
        if cfg.schedule == "round":
            raise ValueError(
                f"schedule='round' is a full-mesh fast path; topology="
                f"{cfg.topology!r} runs the tick engine (use schedule="
                "'tick' or 'auto')"
            )
        return False
    if cfg.protocol == "raft":
        from blockchain_simulator_tpu_torch.models import raft_hb

        ok = raft_hb.eligible(cfg)
        if cfg.schedule == "round":
            if not ok:
                raise ValueError(
                    "schedule='round' for raft requires clean fidelity + "
                    "full mesh + stat delivery with no drops/queued links, "
                    "heartbeat < election_lo, and a window longer than the "
                    "election prefix (models/raft_hb.eligible)"
                )
            return True
        return ok and cfg.n >= 4096  # "auto"
    if cfg.protocol == "mixed":
        from blockchain_simulator_tpu_torch.models import mixed

        ok = mixed.fast_eligible(cfg)
        if cfg.schedule == "round":
            if not ok:
                raise ValueError(
                    "schedule='round' for the mixed sim requires its raft "
                    "shards to be heartbeat-schedulable: clean fidelity + "
                    "stat delivery with no drops/queued links and a window "
                    "longer than the election prefix (models/raft_hb.eligible "
                    "on the shard sub-config)"
                )
            return True
        # "auto": no n threshold; a failed handoff continues the tick engine
        return ok
    if cfg.protocol != "pbft":
        return False
    from blockchain_simulator_tpu_torch.models import pbft_round

    ok = pbft_round.eligible(cfg)
    if cfg.schedule == "round":
        if not ok:
            raise ValueError(
                "schedule='round' requires pbft + full mesh + stat delivery "
                "with no byz_forge, no queued links, drops only when view "
                "changes are disabled AND the vote table is exact "
                "(pbft_window = 0 or >= pbft_max_slots), and a message "
                "horizon — including the constant block-serialization "
                "latency when modeled — inside one block interval "
                "(models/pbft_round.eligible)"
            )
        return True
    return ok and cfg.n >= 4096  # "auto"


def _reject_cpp_only(cfg: SimConfig) -> None:
    """Refuse what only the C++ engine models (as the JAX package does)."""
    if cfg.echo_back:
        raise NotImplementedError(
            "echo_back (quirk #1) is modeled by the C++ engine only: the "
            "tensorized engines design the echo away (models/pbft.py)"
        )
    if cfg.queued_links:
        if cfg.protocol == "mixed":
            raise NotImplementedError(
                "queued_links is not modeled by the mixed shard sim"
            )
        if cfg.protocol in ("pbft", "raft"):
            if cfg.topology != "full":
                raise ValueError(
                    "queued_links (tensorized) requires topology='full': the "
                    "serial-pipe registers model the leader's direct links"
                )
            if cfg.faults.drop_prob != 0.0:
                raise ValueError(
                    "queued_links (tensorized) requires drop_prob = 0: with "
                    "drops, leader beliefs can diverge and the per-destination "
                    "busy registers assume a single block sender"
                )
        if cfg.protocol == "pbft":
            from blockchain_simulator_tpu_torch.models.pbft import eff_window

            _, hi = cfg.one_way_range()
            if eff_window(cfg) < cfg.pbft_max_slots:
                raise ValueError(
                    "queued_links (tensorized) requires the exact vote table "
                    "(pbft_window = 0 or >= pbft_max_slots)"
                )
            if hi - 1 >= cfg.pbft_block_interval_ms:
                raise ValueError(
                    "queued_links (tensorized) requires the one-way delay to "
                    "fit inside one block interval"
                )


def make_sim_fn(cfg: SimConfig):
    """``sim(seed, device) -> final state``: the phase-blocked fast path
    when ``use_round_schedule`` picks it, else the tick engine, ``cfg.ticks``
    ticks from ``proto.init``."""
    _reject_cpp_only(cfg)
    if cfg.topology == "committee":
        raise NotImplementedError(
            "committee topology comes with slice 5 of the port (sparse "
            "topologies)"
        )
    if use_round_schedule(cfg) and cfg.protocol == "raft":
        from blockchain_simulator_tpu_torch.models import raft_hb

        def sim_hb(seed: int, device):
            return raft_hb.run(cfg, threefry.key(seed), device)

        return sim_hb
    if use_round_schedule(cfg) and cfg.protocol == "mixed":
        from blockchain_simulator_tpu_torch.models import mixed

        def sim_mixed(seed: int, device):
            key = threefry.key(seed)
            state, bufs = mixed.init(cfg, threefry.fold_in(key, _INIT_FOLD), device=device)
            return mixed.scan_fast(cfg, state, bufs, key)

        return sim_mixed
    if use_round_schedule(cfg):
        from blockchain_simulator_tpu_torch.models import pbft_round

        def sim_round(seed: int, device):
            key = threefry.key(seed)
            state, _ = pbft_round.init(cfg, threefry.fold_in(key, _INIT_FOLD),
                                       device=device)
            return pbft_round.scan_rounds(cfg, state, key)

        return sim_round
    proto = get_protocol(cfg.protocol)

    def sim(seed: int, device):
        key = threefry.key(seed)
        state, bufs = proto.init(cfg, threefry.fold_in(key, _INIT_FOLD), device=device)
        ticks = torch.arange(cfg.ticks, dtype=torch.int32, device=device)
        tkeys = prng.tick_key(key, range(cfg.ticks))
        for t in range(cfg.ticks):
            state, bufs = proto.step(cfg, state, bufs, ticks[t], tkeys[t])
        return state

    return sim


def final_state(cfg: SimConfig, seed: int | None = None, device=None):
    """Run and return the raw final state (for tests and digests)."""
    dev = resolve_device(device)
    state = make_sim_fn(cfg)(cfg.seed if seed is None else seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return state


def run_simulation(cfg: SimConfig, seed: int | None = None, device=None) -> dict:
    """Run one simulation; returns the protocol's structured metrics dict,
    the same dict the JAX package's ``run_simulation`` returns."""
    return sim_metrics(cfg, final_state(cfg, seed, device))
