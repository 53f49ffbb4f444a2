"""The command line (port of ``blockchain_simulator_tpu/cli.py``).

Every operating constant of the reference is a flag over the typed
``SimConfig`` (utils/config.py), the protocol is selected by name, and the
engine is the PyTorch port (``--engine torch``, on the CUDA card unless
``--device cpu``) or the C++ reference engine (``--engine cpp``).  The
flags, defaults, exit codes (2 for every refused combination) and output
lines are the JAX package's.

    python -m blockchain_simulator_tpu_torch --protocol pbft --n 8 --sim-ms 2500
    python -m blockchain_simulator_tpu_torch --protocol paxos --engine cpp --seeds 0 1 2
    python -m blockchain_simulator_tpu_torch --protocol pbft --n 16 --device cpu --trace s.npz

Output: one JSON metrics line per run, each with the run manifest
(utils/obs.py).  ``--shards W`` > 1 starts W rank processes of one group
(parallel/multihost.launch: NCCL, rank r on ``cuda:r``; gloo with
``--device cpu``), runs the node-sharded simulation over them and prints
rank 0's line, as the JAX package prints its sharded run's; more ranks than
cards exits 1 before any rank starts.

    python -m blockchain_simulator_tpu_torch --protocol pbft --n 64 --shards 4 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

from blockchain_simulator_tpu_torch.utils import obs
from blockchain_simulator_tpu_torch.utils.config import FaultConfig, SimConfig

def build_parser() -> argparse.ArgumentParser:
    d = SimConfig()
    p = argparse.ArgumentParser(
        prog="blockchain_simulator_tpu_torch",
        description="PyTorch / CUDA blockchain-consensus simulation framework",
    )
    p.add_argument("--protocol", choices=["pbft", "raft", "paxos", "mixed"],
                   default=d.protocol)
    p.add_argument("--n", type=int, default=d.n, help="cluster size")
    p.add_argument("--sim-ms", type=int, default=d.sim_ms,
                   help="virtual-time window in ms")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--seeds", type=int, nargs="+", default=None,
                   help="seed sweep (batched on the torch engine)")
    p.add_argument("--fidelity", choices=["reference", "clean"],
                   default=d.fidelity)
    p.add_argument("--delivery", choices=["edge", "stat"], default=d.delivery)
    p.add_argument("--schedule", choices=["tick", "round", "auto"],
                   default=d.schedule,
                   help="tick = general 1ms-tick engine; round = phase-"
                        "blocked fast path (PBFT: one step per block "
                        "interval; raft: per heartbeat behind a checked "
                        "election handoff; mixed: the heartbeat scan "
                        "inside every raft shard); auto = round when "
                        "eligible and n >= 4096 (mixed: whenever eligible)")
    p.add_argument("--stat-sampler", choices=["exact", "normal", "auto"],
                   default=d.stat_sampler,
                   help="binomial sampler for stat-delivery bucket counts: "
                        "exact = BTRS rejection; normal = Gaussian "
                        "approximation (fast at large n); auto = by n")
    p.add_argument("--engine", choices=["torch", "cpp"], default="torch",
                   help="torch = the PyTorch port (CUDA); cpp = serial "
                        "per-message C++ reference engine")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the torch engine: cuda (the default; "
                        "without a card the run fails, it never falls back) "
                        "or cpu (the kernels' plain versions)")
    p.add_argument("--shards", type=int, default=0,
                   help="shard node state over this many ranks, one a card "
                        "(gloo ranks on the CPU with --device cpu)")
    p.add_argument("--link-delay-ms", type=int, default=d.link_delay_ms)
    p.add_argument("--serialization", choices=["on", "off"],
                   default="on" if d.model_serialization else "off",
                   help="model per-message block serialization time "
                        "(bytes*8/link_rate; the reference's dominant "
                        "timing term) in addition to propagation delay")
    p.add_argument("--topology",
                   choices=["full", "dense", "gossip", "kregular", "committee"],
                   default=d.topology,
                   help="full/dense = reference full mesh; gossip = TTL "
                        "flood over a random k-out digraph; kregular = "
                        "fixed-degree circulant overlay with gather-based "
                        "direct delivery (O(N*k) memory; bit-equal to the "
                        "mesh at --degree n-1); committee = the flat "
                        "protocol inside each of --committees committees "
                        "plus an outer representative aggregate")
    p.add_argument("--degree", type=int, default=d.degree,
                   help="out-degree k (gossip flood fan-out / kregular "
                        "overlay degree)")
    p.add_argument("--gossip-hops", type=int, default=d.gossip_hops,
                   help="flood TTL (gossip)")
    p.add_argument("--committees", type=int, default=d.committees,
                   help="committee count (topology=committee; must divide n)")
    p.add_argument("--topo-seed", type=int, default=d.topo_seed,
                   help="kregular overlay construction seed (separate from the "
                        "run seed so sweeps share one overlay)")
    p.add_argument("--paxos-timeout-ms", type=int, default=d.paxos_retry_timeout_ms,
                   help="clean-fidelity retry window timeout")
    p.add_argument("--paxos-client", nargs=2, type=int, default=None,
                   metavar=("NODE", "MS"),
                   help="CLIENT_PROPOSE hook (paxos-node.cc:357-361): proposer "
                        "lane NODE fires requireTicket at MS instead of t=0")
    # C++-engine-only transport/fidelity extras
    p.add_argument("--echo-back", action="store_true",
                   help="reflect every received packet to its sender once "
                        "(bounded quirk #1; --engine cpp only)")
    p.add_argument("--queued-links", action="store_true",
                   help="ns-3-exact serial-link transport: packets queue per "
                        "directed 3 Mbps link")
    p.add_argument("--quorum-rule", choices=["n2", "2f1"], default=d.quorum_rule,
                   help="n2 = reference majority thresholds (no vote dedup); "
                        "2f1 = Byzantine-safe 2f+1 quorum with per-sender dedup")
    # faults
    p.add_argument("--crash", type=int, default=-1,
                   help="number of crashed nodes")
    p.add_argument("--byzantine", type=int, default=0,
                   help="number of vote-flipping nodes")
    p.add_argument("--byz-forge", action="store_true",
                   help="Byzantine nodes flood forged COMMIT votes for a "
                        "never-proposed slot (pbft)")
    p.add_argument("--byz-copies", type=int, default=3,
                   help="forged vote copies per sender under n2 counting")
    p.add_argument("--drop", type=float, default=0.0,
                   help="per-message drop probability")
    p.add_argument("--byz-sweep", action="store_true",
                   help="BASELINE config 4: sweep Byzantine f = 0..(n-1)//3 "
                        "with vote forging; one JSON line per (f, seed)")
    # per-protocol knobs (reference values as defaults)
    p.add_argument("--pbft-interval-ms", type=int, default=d.pbft_block_interval_ms)
    p.add_argument("--pbft-rounds", type=int, default=d.pbft_max_rounds)
    p.add_argument("--pbft-max-slots", type=int, default=d.pbft_max_slots,
                   help="vote-table slots; rounds are capped at "
                        "min(pbft_rounds, pbft_max_slots)")
    p.add_argument("--pbft-window", type=int, default=d.pbft_window,
                   help="live vote-state window W (0 = exact full table); "
                        "the O(N*W) memory lever at 100k nodes")
    p.add_argument("--pbft-tx-speed", type=int, default=d.pbft_tx_speed,
                   help="offered tx/s; with --pbft-tx-size sets the block "
                        "size (pbft-node.cc:104-105)")
    p.add_argument("--pbft-tx-size", type=int, default=d.pbft_tx_size)
    p.add_argument("--raft-heartbeat-ms", type=int, default=d.raft_heartbeat_ms)
    p.add_argument("--raft-blocks", type=int, default=d.raft_max_blocks)
    p.add_argument("--raft-tx-speed", type=int, default=d.raft_tx_speed)
    p.add_argument("--raft-tx-size", type=int, default=d.raft_tx_size)
    p.add_argument("--paxos-proposers", type=int, default=d.paxos_n_proposers)
    p.add_argument("--mixed-shards", type=int, default=d.mixed_shards,
                   help="raft shard count for --protocol mixed")
    p.add_argument("--timing", action="store_true",
                   help="include wallclock timing in the output")
    # observability (utils/trace.py)
    p.add_argument("--trace", metavar="FILE.npz",
                   help="record the probe series (committed blocks, views, "
                        "elections, ...) to an .npz next to the metrics "
                        "line — per tick on the general engine, per round/"
                        "heartbeat on the fast paths (utils/trace.py); "
                        "with --seeds, one FILE.<seed>.npz per seed")
    p.add_argument("--profile", metavar="LOGDIR",
                   help="capture a torch.profiler trace of the warm run into "
                        "LOGDIR/trace.json (view with ui.perfetto.dev)")
    return p


def config_from_args(args) -> SimConfig:
    return SimConfig(
        protocol=args.protocol,
        n=args.n,
        sim_ms=args.sim_ms,
        seed=args.seed,
        fidelity=args.fidelity,
        delivery=args.delivery,
        stat_sampler=args.stat_sampler,
        schedule=args.schedule,
        quorum_rule=args.quorum_rule,
        link_delay_ms=args.link_delay_ms,
        model_serialization=args.serialization == "on",
        topology=args.topology,
        degree=args.degree,
        gossip_hops=args.gossip_hops,
        committees=args.committees,
        topo_seed=args.topo_seed,
        paxos_retry_timeout_ms=args.paxos_timeout_ms,
        paxos_client_node=args.paxos_client[0] if args.paxos_client else -1,
        paxos_client_ms=args.paxos_client[1] if args.paxos_client else 0,
        echo_back=args.echo_back,
        queued_links=args.queued_links,
        pbft_block_interval_ms=args.pbft_interval_ms,
        pbft_max_rounds=args.pbft_rounds,
        pbft_max_slots=args.pbft_max_slots,
        pbft_window=args.pbft_window,
        pbft_tx_speed=args.pbft_tx_speed,
        pbft_tx_size=args.pbft_tx_size,
        raft_heartbeat_ms=args.raft_heartbeat_ms,
        raft_max_blocks=args.raft_blocks,
        raft_tx_speed=args.raft_tx_speed,
        raft_tx_size=args.raft_tx_size,
        paxos_n_proposers=args.paxos_proposers,
        mixed_shards=args.mixed_shards,
        faults=FaultConfig(
            n_crashed=args.crash,
            n_byzantine=args.byzantine,
            drop_prob=args.drop,
            byz_forge=args.byz_forge,
            byz_copies=args.byz_copies,
        ),
    )


def _error(msg) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def _run_cpp(args, cfg, seeds, emit) -> int:
    """The C++ reference engine: its own refusals, then one line a seed."""
    if args.shards > 1:
        return _error("--shards requires the torch engine")
    if args.protocol == "mixed":
        return _error("--protocol mixed requires the torch engine "
                      "(the C++ engine implements pbft/raft/paxos only)")
    if args.topology != "full":
        return _error(f"--topology {args.topology} requires the torch engine "
                      "(the C++ engine simulates the full mesh only)")
    if args.byz_sweep:
        return _error("--byz-sweep requires the torch engine")
    if args.trace or args.profile:
        return _error("--trace/--profile require the torch engine")
    from blockchain_simulator_tpu_torch.engine import run_cpp

    for s in seeds:
        t0 = time.perf_counter()
        try:
            m = run_cpp(cfg, seed=s)
        except ValueError as e:
            return _error(e)
        if args.timing:
            m["wallclock_s"] = time.perf_counter() - t0
        emit(m, cfg)
    return 0


def _run_observed(args, cfg, seeds, dev, emit) -> int:
    """``--trace`` (one ``.npz`` of the probe series a seed) or
    ``--profile`` (the warm run under torch.profiler)."""
    from blockchain_simulator_tpu_torch.runner import _reject_cpp_only
    from blockchain_simulator_tpu_torch.utils import trace as trace_mod

    if args.shards > 1:
        return _error("--trace/--profile apply to unsharded torch runs")
    if args.profile and len(seeds) > 1:
        return _error("--profile applies to single-seed torch runs "
                      "(--trace accepts --seeds: one FILE.<seed>.npz per seed)")
    try:
        # validate before any run: a multi-seed loop must not discover the
        # error after the first seed
        _reject_cpp_only(cfg)
        if args.profile:
            m = trace_mod.profile_run(cfg, args.profile, seed=seeds[0], device=dev)
            m["profile_dir"] = args.profile
            emit(m, cfg)
            return 0
        for s in seeds:
            m, series = trace_mod.run_traced(cfg, seed=s, device=dev)
            if len(seeds) == 1:
                path = args.trace
            else:
                root, ext = os.path.splitext(args.trace)
                path = f"{root}.{s}{ext or '.npz'}"
            np.savez(path, **series)
            m["trace_file"] = path
            m["trace_series"] = sorted(series)
            m["seed"] = s
            emit(m, cfg)
    except (ValueError, NotImplementedError) as e:
        return _error(e)
    return 0


def _run_sharded(args, cfg, seeds, emit) -> int:
    """``--shards W``: W rank processes of one group run the node-sharded
    simulation (parallel/multihost.launch); rank 0's metrics are printed.
    With ``--seeds`` the ranks run the seed sweep over a nodes mesh of W
    (parallel/sweep.run_seed_sweep ``mesh=``, as JAX's command line does),
    one line a seed; the sweep already appended each row to the run log."""
    from blockchain_simulator_tpu_torch.parallel import multihost

    try:
        if len(seeds) > 1:
            rows = multihost.launch(multihost.run_seed_sweep_multihost, args.shards,
                                    args=(cfg, seeds), device=args.device)[0]
        else:
            rows = [multihost.launch(multihost.run_sharded_multihost, args.shards,
                                     args=(cfg, None, seeds[0]), device=args.device)[0]]
    except (ValueError, NotImplementedError) as e:
        return _error(e)
    except RuntimeError as e:  # too few cards, or a rank failed
        print(f"error: {e}", file=sys.stderr)
        return 1
    for m in rows:
        emit(m, cfg, append=len(seeds) == 1)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    def emit(record, cfg=None, **kw):
        """Every result line leaves through here: one JSON line with the
        run manifest attached (and, when $BLOCKSIM_RUNS_JSONL is set, the
        same record appended there, utils/obs.py)."""
        print(json.dumps(obs.finalize(record, cfg, **kw)), flush=True)

    try:
        cfg = config_from_args(args)
    except ValueError as e:
        # SimConfig validation: message + exit code 2, like the flag checks
        return _error(e)
    seeds = args.seeds if args.seeds is not None else [args.seed]

    if args.engine != "cpp" and args.echo_back:
        return _error("--echo-back requires --engine cpp (the tensorized "
                      "backends design the echo away; see SimConfig docs)")
    if args.engine != "cpp" and args.queued_links:
        # pbft (serial-pipe registers) and paxos (ser = 0) run on the
        # tensorized engines; anything else gets the runner's message
        from blockchain_simulator_tpu_torch.runner import _reject_cpp_only

        try:
            _reject_cpp_only(cfg)
        except (ValueError, NotImplementedError) as e:
            return _error(e)

    if args.engine == "cpp":
        return _run_cpp(args, cfg, seeds, emit)

    from blockchain_simulator_tpu_torch import runner

    dev = runner.resolve_device(args.device)  # no card: raises, never the CPU

    if args.byz_sweep:
        from blockchain_simulator_tpu_torch.parallel.sweep import run_byzantine_sweep

        try:
            rows = run_byzantine_sweep(cfg, seeds=seeds, device=dev)
        except NotImplementedError as e:
            return _error(e)
        for row in rows:
            # the row ran cfg with its OWN FaultConfig (n_byzantine = f,
            # byz_forge): hash that config; the sweep already appended the
            # row to runs.jsonl (obs.record_run), so the line does not
            row_cfg = cfg.with_(faults=dataclasses.replace(
                cfg.faults, n_byzantine=row["f"], byz_forge=True))
            emit(row, row_cfg, append=False)
        return 0

    if args.trace or args.profile:
        return _run_observed(args, cfg, seeds, dev, emit)

    if args.timing and (args.shards > 1 or len(seeds) > 1):
        print("note: --timing applies to single-seed unsharded torch runs; "
              "ignoring", file=sys.stderr)

    if args.shards > 1:
        return _run_sharded(args, cfg, seeds, emit)

    if len(seeds) > 1:
        from blockchain_simulator_tpu_torch.parallel.sweep import run_seed_sweep

        try:
            rows = run_seed_sweep(cfg, seeds=seeds, device=dev)
        except NotImplementedError as e:
            return _error(e)
        for m in rows:
            # append=False: run_seed_sweep already logged each row
            emit(m, cfg, append=False)
        return 0

    try:
        m = runner.run_simulation(cfg, seed=seeds[0], with_timing=args.timing, device=dev)
    except NotImplementedError as e:
        return _error(e)
    emit(
        m, cfg,
        compile_s=m.get("compile_plus_first_run_s"),
        run_s=m.get("wallclock_s"),
        rounds=m.get("blocks_final_all_nodes", m.get("blocks")),
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
