"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. build    — compile the ring-push kernel (csrc/ring_push.cu) from the
              checkout with nvcc; print the seconds and what ptxas reports.
2. kernel   — hold the grouped kernel against its plain PyTorch version, bit
              for bit: the four pushes of one PBFT tick at n = 1000 in one
              launch, each of them alone, and on the scalar path a ragged L
              and a misaligned view, plus B = D (ticks that wrap, untouched
              slices checked); a CUDA-graph replay of a launch must equal the
              eager launch.  Time the tick group, its four pushes launched
              one by one, the plain version and four PyTorch library calls
              (index_add_ / index_reduce_ "amax"): device time per call from
              a replayed CUDA graph (rings L2-warm, and with their slots from
              HBM), and the eager per-call time that includes the host's
              launch cost.
3. main     — run the port's PBFT tick engine (n = 1000, 2500 ms, full mesh,
              edge delivery: run_simulation's default path) on the card; its
              metrics and a sha256 of every final-state field must equal the
              JAX package's golden file, and the kernel's counters must show
              exactly one launch of four pushes per tick.
4. samplers — the PRNG and sampler functions on the card against the same
              functions on the CPU, at 10^6 elements: Philox bits, the
              popcount normal, the exact binomial, the Gumbel categorical;
              mismatch counts must be 0.  Time one "normal" and one "exact"
              multinomial chain at [5, 100000].
5. round    — the bench headline (bench._cfg(2000): PBFT, n = 100,000, 2000
              rounds, stat delivery, schedule "auto"), which resolves to the
              round-blocked fast path with the "normal" sampler; the round
              loop runs under torch.cuda.set_sync_debug_mode("error"), so a
              host sync inside it fails the phase.  Metrics and every state
              digest must equal the JAX golden; prints wall, rounds/s and
              kernel launches per round (counted by torch.profiler over the
              first rounds).
6. tick-stat — the PBFT tick engine on the stat arm (n = 1000, 1000 ms,
              "exact" sampler); metrics and digests equal the JAX golden,
              and one ring-push launch of four pushes per tick.
7. raft-kernel — the grouped kernel at the Raft tick group's n = 1000 shapes
              (vreq [3, 1000, 1000] and six [B, 1000] members) against its
              plain version, bit for bit: eager, under graph replay, and with
              the members of skipped gates left out; device time against the
              bound (rings and contributions from HBM, and L2-warm) and
              against one library call per push.
8. raft-edge — the port's Raft tick engine at n = 1000, 10,000 ms, package
              defaults (edge delivery, threefry delays, clean fidelity,
              serialization modelled; "auto" resolves to the tick engine):
              metrics and digests equal the JAX golden, one ring-push launch
              per tick that pushes; wall, ticks/s, launches and pushes.  Then
              the first 1000 ticks again: host syncs a tick (sync debug mode
              "warn"), and kernel launches, device-to-host copies and the
              device's busy share a tick (torch.profiler).
9. raft-hb  — the same config on stat delivery with schedule "round": the
              heartbeat-blocked path (the election prefix on the tick engine,
              one host read at the handoff, then one step a heartbeat)
              through run_simulation's path, held to its JAX golden and to
              its handoff flag; the wall split into init, the prefix and
              the heartbeat scan over [S] shards on the card (S = 1).
10. pbft-queued — PBFT n = 8 with queued links (serial-pipe FIFOs), 10,000
              ms, held to its JAX golden; one launch of three pushes a tick.
11. paxos-kernel — the grouped kernel at the Paxos tick group's BASELINE
              config 3 shapes (n = 10,000, D = 106, six members of 50
              buckets: three max and two add of 30,000 lanes, one max of
              10,000) against its plain version, bit for bit, on the int4
              and the scalar path, at ticks that wrap around D, under graph
              replay and with skipped members left out; device time against
              the bound, the plain version and six library calls.
12. paxos-gossip — config 3 itself (tools/run_config3.py: Paxos, n = 10,000,
              3,000 ms, degree-16 gossip) through run_simulation's path:
              the neighbour table's sha256 first, then metrics and digests
              against the JAX golden; wall, ticks/s, launches and pushes,
              and over the first 300 ticks (the ticket, propose and commit
              phases) host syncs and kernel launches a tick.
13. pbft-gossip, 14. raft-gossip — PBFT (600 ms) and Raft (2,000 ms) at
              n = 1000 over degree-16 gossip, stat delivery, each held to its
              JAX golden, table first.
15. mixed-kernel — the grouped kernel at the mixed sim's Raft group for
              BASELINE config 5 (S = 256 shards of m = 1000, D = 12): its
              rings slot-major, [D, S, m], so each channel is ONE member of
              S·m = 256,000 lanes: five of 3 buckets and hb_ok's 5 (no
              Byzantine nodes, so no hb_bad).  Bit for bit against its plain
              version (the group, a heartbeat, a proposal, an election, at
              ticks that wrap D; graph replay); device time from HBM (the
              group's 134 MB exceed the 50 MB L2) and L2-warm against its
              bound, the plain version and six library calls.
16. mixed-config5 — BASELINE config 5 as tools/run_config5.py builds it
              (256 Raft shards x 1000 nodes, cross-shard PBFT, 3,000 ms,
              stat, serialization off), at seed 0 on one card (the artifact
              shards it over 8 devices), through runner.final_state: metrics
              and every state digest equal the JAX golden, all 256 handoffs
              taken, 256 shards with leaders, 40/40 global.  The counts are
              set to 0 just before the run and read just after: one launch a
              tick for the PBFT layer, one a pushing tick for the Raft
              shards.  The wall split into init, the prefix (to the
              handoff's host read), the [S] heartbeat scan at S = 256 and the
              PBFT layer, each ended by a synchronize in this script; then
              the 322 prefix ticks again for host syncs and launches a tick.

17. config4 — BASELINE config 4 as tools/run_config4.py builds it (PBFT,
              n = 100,000, 200 rounds, window 8, stat, serialization off):
              run_byzantine_sweep over f in {0, 8333, 16666, 25000, 33333,
              50001} x seeds (0, 1), forge off — ONE batch of 12 lanes on the
              round path (state [12, 100000], lane keys [12, 2]).  Its rows
              and every lane's state digests equal the JAX golden (200 of 200
              blocks for f <= 33,333, none at 50,001); then the lane loop again
              under torch.cuda.set_sync_debug_mode("error"), equal again; then
              kernel launches a round over its first rounds (raw profiler
              events), which must stay within 1.25x the headline's: the lanes
              run as one batch, not one after another.
18. drop-sweep — the drop sweep as tools/run_drop_sweep.py builds it (PBFT,
              n = 10,000, 40 rounds, view changes off, schedule "round"):
              run_fault_sweep over eight drop_prob structures at seed 0; rows
              and digests equal the JAX golden (40 blocks through p = 0.2,
              none from 0.3).
19. checkpoint — the edge tick config of phase 3 through run_checkpointed
              (every 1,250 ms, into a temporary directory): metrics equal the
              golden and the final archive's state its digests; then
              resume_simulation from the 1,250 ms archive equals the golden
              again.  One ring-push launch of four pushes a tick across the
              segment boundary, in both runs.

20. topo-kernel — the grouped kernel at the sparse paths' new member
              shapes against its plain version, eager and under graph
              replay: PBFT's four pushes at n = 1,000,000 (rings
              [8, 10^6, 8]) and Raft kregular's group at n = 10,000 (vreq
              [D, N, 17]); device time against the bound, the plain version
              and one library call a push.
21. kreg-1m — the artifact's largest kregular rung (tools/topo_bench.py:
              PBFT, n = 1,000,000, degree 8, 150 ms, edge, rbg, window 8),
              uncut: metrics and digests equal the JAX golden, one launch
              of four pushes a tick; the wall split into tables, init and
              loop, syncs and launches a tick, peak card memory.
22. committee-100k — the artifact's committee row (PBFT, n = 100,000 in
              200 committees of 500, 150 ms, stat, "normal"), uncut, the
              committees in turn: 200 of 200 decided, outer commit 116.0
              ms, every milestone and stacked digest equal the golden.
23. kreg-raft-paxos — Raft (edge) and Paxos at n = 10,000 over a degree-16
              overlay, 1,000 ms each, held to their JAX goldens.
24. kreg-equal — PBFT (edge, threefry) and Raft (stat, exact) at n = 256:
              the kregular run at k = 255 equals the dense run on the card.

25. cli-trace-round — the slice at full width: cli.main in this process
              with the headline's flags (PBFT, n = 100,000, stat,
              serialization off, window 8) cut to 500 rounds, with --trace:
              the metrics line and every series (sha256, dtype, shape, last
              value) equal the JAX golden (golden/trace_s0.json), the
              manifest names the card; the probed scan's first 100 rounds
              again under sync debug mode "error"; kernel launches a round,
              probed against unprobed.
26. cli-trace-tick — cli.main with config 2's flags and --schedule tick
              --trace: metrics equal the edge golden, series the trace
              golden, one ring-push launch of four pushes a tick; host syncs
              a tick.
27. trace-hb, 28. trace-mixed, 29. trace-committee — run_traced on the
              Raft heartbeat golden's config, on 16 Raft shards x 1,000
              (3,000 ms, stat) and on n = 5,000 in 10 committees of 500
              (150 ms, stat, "normal"), each held to the trace golden.
30. profile — cli.main --profile on PBFT n = 1000, edge, 200 ms: metrics
              equal the JAX golden, and the exported Chrome trace holds one
              ring_push kernel event a tick of the profiled run.
31. entry   — a subprocess, python -m blockchain_simulator_tpu_torch
              --protocol pbft --n 8 --sim-ms 600 --timing: exit 0, the
              manifest names the card, the metrics equal the JAX golden's.

32. serve-config4 — config 4's twelve points as requests to an in-process
              ScenarioServer(max_batch=12), submitted before start() in the
              golden's lane order: one batched flush of 12, every answer the
              golden's row; its wall beside phase config4's.
33. serve-tick — config 2 as one request, solo through serve-solo: the JAX
              server's answer, one ring-push launch of four pushes a tick.
              The processes of phases 34 and 35 start beside it.
34. health  — python -m blockchain_simulator_tpu_torch.utils.health --log
              '': verdict healthy, backend cuda, the card's name.
35. serve-http — the scenario daemon as the README starts it: python -m
              blockchain_simulator_tpu_torch.serve --port 0 --max-batch 8
              --max-wait-ms 50 --prewarm '<PBFT n = 1024, 600 ms, stat, round,
              exact>' with its own run log; a health pause 503, then resume;
              15 requests (f in {0, 1, 2, 5, 10} x seeds {0, 1, 2}) from 8
              threads, each 200 and equal to the JAX server's answer
              (golden/serve_s0.json); /stats shows a batch of more than one
              and no registry miss after the prewarm; a mixed request 422,
              n = -1 400; /metrics; /shutdown exits 0; every access-log line
              names the card and carries the cache and telemetry blocks.

Prints the card's name and power limit, one JSON line of per-kernel numbers
and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA card (or
without the rest of the repo beside it) it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time
import warnings

HERE = pathlib.Path(__file__).resolve().parent
GOLDEN = HERE / "blockchain_simulator_tpu_torch" / "golden" / "pbft_edge_s0.json"
ROUND_GOLDEN = HERE / "blockchain_simulator_tpu_torch" / "golden" / "pbft_round_n100k_s0.json"
STAT_GOLDEN = HERE / "blockchain_simulator_tpu_torch" / "golden" / "pbft_stat_n1000_1000ms_s0.json"
RAFT_EDGE_GOLDEN = HERE / "blockchain_simulator_tpu_torch" / "golden" / "raft_edge_n1000_s0.json"
RAFT_HB_GOLDEN = HERE / "blockchain_simulator_tpu_torch" / "golden" / "raft_hb_n1000_s0.json"
QUEUED_GOLDEN = HERE / "blockchain_simulator_tpu_torch" / "golden" / "pbft_queued_n8_s0.json"
PAXOS_GOSSIP_GOLDEN = HERE / "blockchain_simulator_tpu_torch" / "golden" / "paxos_gossip_n10k_s0.json"
PBFT_GOSSIP_GOLDEN = HERE / "blockchain_simulator_tpu_torch" / "golden" / "pbft_gossip_n1000_s0.json"
RAFT_GOSSIP_GOLDEN = HERE / "blockchain_simulator_tpu_torch" / "golden" / "raft_gossip_n1000_s0.json"
MIXED_GOLDEN = HERE / "blockchain_simulator_tpu_torch" / "golden" / "mixed_n256k_s0.json"
CONFIG4_GOLDEN = HERE / "blockchain_simulator_tpu_torch" / "golden" / "pbft_config4_n100k_s01.json"
DROP_GOLDEN = HERE / "blockchain_simulator_tpu_torch" / "golden" / "pbft_drop_n10k_s0.json"
KREG_1M_GOLDEN = HERE / "blockchain_simulator_tpu_torch" / "golden" / "pbft_kreg_n1m_s0.json"
COMMITTEE_GOLDEN = HERE / "blockchain_simulator_tpu_torch" / "golden" / "pbft_committee_n100k_s0.json"
KREG_RP_GOLDEN = HERE / "blockchain_simulator_tpu_torch" / "golden" / "kreg_raft_paxos_n10k_s0.json"
TRACE_GOLDEN = HERE / "blockchain_simulator_tpu_torch" / "golden" / "trace_s0.json"
SERVE_GOLDEN = HERE / "blockchain_simulator_tpu_torch" / "golden" / "serve_s0.json"
SERVE_THREADS = 8  # serve-http's client threads
# kreg-equal: the port's kregular run at k = N-1 against its dense run
KREG_EQUAL = {
    "pbft_edge": dict(protocol="pbft", n=256, sim_ms=600, fidelity="clean",
                      delivery="edge", edge_sampler="threefry", stat_sampler="exact"),
    "raft_stat": dict(protocol="raft", n=256, sim_ms=800, fidelity="clean",
                      delivery="stat", stat_sampler="exact", raft_proposal_delay_ms=300),
}
CHECKPOINT_EVERY_MS = 1250
LANE_ROUNDS_MAX = 1.25  # a lane batch's launches a round, at most, over the headline's
GOSSIP_WINDOW_TICKS = 300
SYNC_COUNT_TICKS = 1000
SAMPLER_N = 1_000_000
PROFILED_ROUNDS = 20
SYNC_CHECKED_ROUNDS = 100  # probed rounds rerun under sync debug mode "error"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
INT32_OPS_PER_S = 67e12    # H100 SXM non-tensor 32-bit rate (data sheet fp32 figure)


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_eager_ms(fn, reps: int) -> float:
    """Mean time per call of ``fn()`` issued back to back from Python (CUDA
    events): what the tick loop pays per call, host launch cost included."""
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_device_ms(fn, reps: int) -> float:
    """Mean device time per call of ``fn(i)``, i = 0 .. reps-1: ``reps`` calls
    captured in one CUDA graph and replayed, so the host's launch cost is out
    of the timing."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def _bound_ms(b: int, length: int) -> float:
    """Least time for one push: 12 bytes per element (read ring and
    contribution, write ring) over the memory rate, or one operation per
    element over the 32-bit rate, whichever is larger."""
    return max(12 * b * length / HBM_BYTES_PER_S, b * length / INT32_OPS_PER_S) * 1e3


def _library(op):
    """One PyTorch call computing the same push, given the bucket slots."""
    if op == "add":
        return lambda x, idx, contrib: x.index_add_(0, idx, contrib)
    return lambda x, idx, contrib: x.index_reduce_(0, idx, contrib, "amax")


def _check_group_run(rk, name, items, tick, dev):
    """One group launch against the plain version at tick ``tick``: every
    ring bit-equal, and the slices no bucket addresses untouched."""
    import torch

    t = torch.tensor(tick, dtype=torch.int32, device=dev)
    got = [(r.clone(), lo, c, op) for r, lo, c, op in items]
    want = [(r.clone(), lo, c, op) for r, lo, c, op in items]
    rk.fused_push_group(got, t)
    rk.push_group_plain(want, t)
    torch.cuda.synchronize()
    err = 0
    for (g, lo, c, _), (w, *_), (r0, *_) in zip(got, want, items):
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
        d = r0.shape[0]
        kept = torch.ones(d, dtype=torch.bool, device=dev)
        kept[torch.remainder(tick + lo + torch.arange(c.shape[0], device=dev), d)] = False
        if not torch.equal(g[kept], r0[kept]):
            raise AssertionError(f"ring_push {name} t={tick}: untouched slices changed")
    if err:
        raise AssertionError(f"ring_push {name} t={tick}: kernel != plain (max abs err {err})")
    return err


def phase_kernel(cfg, dev):
    """The grouped kernel vs its plain version at the main path's push
    shapes and on the scalar path; timings of the group, its four pushes
    launched one by one and the four library calls."""
    import torch

    from blockchain_simulator_tpu_torch.ops import ring_kernel as rk

    n, w, d = cfg.n, cfg.pbft_max_slots, cfg.ring_depth
    lo, hi = cfg.one_way_range()
    rt_lo, rt_hi = cfg.roundtrip_range()
    ser = cfg.serialization_ticks(cfg.pbft_block_bytes)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randint(-2**20, 2**20, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    # (name, op, B, rest, lo) of the four pushes of one models/pbft.step, in order
    pushes = [
        ("prep_rt", "add", rt_hi - rt_lo, (n, w), rt_lo),
        ("commit", "add", hi - lo, (n, w), lo),
        ("pp", "max", hi - lo, (n, w), lo + ser),
        ("vc", "max", hi - lo, (n,), lo),
    ]
    tick_items = [(rand(d, *rest), off, rand(b, *rest), op) for _, op, b, rest, off in pushes]
    misaligned = rand(3 * n * w + 1)[1:].view(3, n, w)  # 4 bytes off 16-byte alignment
    extras = {
        "ragged_L": (rand(d, 1001), 5, rand(3, 1001), "max"),
        "misaligned": (rand(d, n, w), lo, misaligned, "add"),
        "B=D": (rand(d, n), 0, rand(d, n), "add"),
    }
    vec = rk.plan_group(tick_items).vec
    if vec != (True,) * 4:
        raise AssertionError(f"the tick group should take the int4 path: {vec}")
    vec = rk.plan_group(list(extras.values())).vec
    if vec != (False, False, True):
        raise AssertionError(f"ragged_L / misaligned / B=D paths: {vec}, expected scalar, "
                             "scalar, int4")
    groups = {"tick": tick_items, "extras": list(extras.values())}
    groups.update({name: [item] for (name, *_), item in zip(pushes, tick_items)})
    groups.update({name: [item] for name, item in extras.items()})
    max_err = 0
    for name, items in groups.items():
        for tick in (0, 7, d - 1, 2499):  # 2499 + lo + b wraps past D
            max_err = max(max_err, _check_group_run(rk, name, items, tick, dev))

    # a captured launch, replayed, equals the eager launch
    t = torch.tensor(2499, dtype=torch.int32, device=dev)
    eager = [(r.clone(), off, c, op) for r, off, c, op in tick_items]
    rk.fused_push_group(eager, t)
    replayed = [(r.clone(), off, c, op) for r, off, c, op in tick_items]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rk.fused_push_group(replayed, t)
    graph.replay()
    torch.cuda.synchronize()
    if not all(torch.equal(a[0], b[0]) for a, b in zip(eager, replayed)):
        raise AssertionError("ring_push group: graph replay != eager launch")
    print(f"kernel ring_push: bit-equal to the plain version for the tick group, "
          f"each push alone, ragged L, a misaligned view, B = D and the mixed "
          f"scalar/int4 group at t in (0, 7, {d - 1}, 2499); graph replay == eager",
          flush=True)

    # timings at t = 2499 on the same buffers (L2-warm, as the PR 1 rows),
    # and with t stepping 5 slots a call so the rings' slots come from HBM
    reps = 200
    lib = [_library(op) for _, op, *_ in pushes]
    bufs = [r.clone() for r, *_ in tick_items]
    items = [(bufs[k], off, c, op) for k, (_, off, c, op) in enumerate(tick_items)]
    ticks = torch.arange(2499, 2499 + 5 * reps, 5, dtype=torch.int32, device=dev)
    t_of = [ticks[i] for i in range(reps)]

    def slots(tick):
        return [torch.remainder(tick + off + torch.arange(c.shape[0], device=dev), d)
                for _, off, c, _ in tick_items]

    idx_warm = slots(2499)
    idx_cold = [slots(2499 + 5 * i) for i in range(reps)]
    for k, (_, off, c, op) in enumerate(tick_items):
        if not torch.equal(lib[k](tick_items[k][0].clone(), idx_warm[k], c),
                           rk.push_plain(tick_items[k][0].clone(), t, off, c, op)):
            raise AssertionError(f"library call disagrees with the plain version ({pushes[k][0]})")

    def singles(tt):
        for it in items:
            rk.fused_push_group((it,), tt)

    def library(idx):
        for k, (r, _, c, _) in enumerate(items):
            lib[k](r, idx[k], c)

    fns = {
        "group": lambda i: rk.fused_push_group(items, t),
        "singles": lambda i: singles(t),
        "library": lambda i: library(idx_warm),
        "plain": lambda i: rk.push_group_plain(items, t),
    }
    dev_ms = {k: _time_device_ms(f, reps) for k, f in fns.items()}
    cold_fns = {
        "group": lambda i: rk.fused_push_group(items, t_of[i]),
        "singles": lambda i: singles(t_of[i]),
        "library": lambda i: library(idx_cold[i]),
    }
    cold_ms = {k: _time_device_ms(f, reps) for k, f in cold_fns.items()}
    eager_ms = {k: _time_eager_ms(lambda f=f: f(0), reps) for k, f in fns.items()}
    t0 = time.perf_counter()
    for _ in range(1000):  # the group's checks and launch plan alone, on the host
        rk.plan_group(items)
    eager_ms["plan_group"] = (time.perf_counter() - t0) / 1000 * 1e3  # ms per call
    bound = sum(_bound_ms(c.shape[0], c[0].numel()) for _, _, c, _ in tick_items)
    us = {k: v * 1e3 for k, v in dev_ms.items()}
    print(f"kernel ring_push tick group (4 pushes, 1 launch): device time per tick "
          f"(graph replay, L2-warm): group {us['group']:.3f} us, 4 single launches "
          f"{us['singles']:.3f} us, 4 library calls {us['library']:.3f} us, plain "
          f"{us['plain']:.3f} us; bound {bound * 1e3:.3f} us (group at "
          f"{100 * bound / dev_ms['group']:.1f}% of it)", flush=True)
    print("kernel ring_push tick group, rings' slots from HBM (t steps 5 a call): "
          + ", ".join(f"{k} {v * 1e3:.3f} us" for k, v in cold_ms.items()), flush=True)
    print("kernel ring_push tick group, eager per tick (host launch cost included): "
          + ", ".join(f"{k} {v * 1e3:.3f} us" for k, v in eager_ms.items()), flush=True)

    rows = []
    for k, (name, op, b, rest, off) in enumerate(pushes):
        item = (bufs[k], off, tick_items[k][2], op)
        c = item[2]
        one = {
            "kernel": lambda i, item=item: rk.fused_push_group((item,), t),
            "plain": lambda i, item=item: rk.push_plain(item[0], t, item[1], item[2], item[3]),
            "library": lambda i, k=k, item=item: lib[k](item[0], idx_warm[k], item[2]),
        }
        ms, plain_ms, library_ms = (_time_device_ms(f, reps) for f in one.values())
        eager = {key: _time_eager_ms(lambda f=f: f(0), reps) for key, f in one.items()}
        bound_ms = _bound_ms(b, c[0].numel())
        rows.append(dict(name=name, op=op, B=b, L=c[0].numel(), lo=off, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         eager_ms=eager))
        print(f"kernel ring_push[{name}] alone (group of one) {op} B={b} L={c[0].numel()}: "
              f"device time per call {ms * 1e3:.3f} us, bound {bound_ms * 1e3:.3f} us, "
              f"plain {plain_ms * 1e3:.2f} us, library {library_ms * 1e3:.3f} us; eager "
              f"kernel {eager['kernel'] * 1e3:.2f} us, library {eager['library'] * 1e3:.2f} us",
              flush=True)
    group = dict(ms=dev_ms["group"], singles_ms=dev_ms["singles"],
                 library_ms=dev_ms["library"], plain_ms=dev_ms["plain"], bound_ms=bound,
                 cold_rings_ms=cold_ms, eager_ms=eager_ms)
    return group, rows, max_err


def _check_golden(entry, metrics, digests, what: str):
    if metrics != entry["metrics"]:
        raise AssertionError(f"{what}: metrics differ from the JAX golden:\n{metrics}\n"
                             f"{entry['metrics']}")
    bad = sorted(k for k in entry["state_sha256"] if digests.get(k) != entry["state_sha256"][k])
    if bad or sorted(digests) != sorted(entry["state_sha256"]):
        raise AssertionError(f"{what}: final-state fields differ from the JAX golden: {bad}")


def phase_tick(dev, card: str, golden: pathlib.Path, what: str, entry_name="n1000"):
    """A PBFT tick-engine run held to its JAX golden (the slice-1 main path
    on edge delivery, the stat arm, or queued links), with the ring-push
    counters set to 0 just before it and read just after: one launch a tick
    of four pushes (three with queued links, whose blocks ride the FIFOs)."""
    import torch

    from blockchain_simulator_tpu_torch import convert, runner
    from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    entry = json.loads(golden.read_text())["entries"][entry_name]
    cfg = SimConfig(**entry["config"])
    if runner.use_round_schedule(cfg):
        raise AssertionError(f"{what}: the config should run the tick engine")
    per_tick = 3 if cfg.queued_links else 4
    rk.launches = rk.pushes = 0
    t0 = time.perf_counter()
    final = runner.final_state(cfg, seed=entry["seed"], device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, pushes = rk.launches, rk.pushes
    metrics = runner.sim_metrics(cfg, final)
    _check_golden(entry, metrics, convert.state_digests(convert.state_to_numpy(final)), what)
    if (launches, pushes) != (cfg.ticks, per_tick * cfg.ticks):
        raise AssertionError(f"{what}: ring_push made {launches} launches and {pushes} "
                             f"pushes, expected {cfg.ticks} and {per_tick * cfg.ticks} (one "
                             f"launch of {per_tick} pushes x {cfg.ticks} ticks)")
    print(f"{what}: pbft n={cfg.n} sim_ms={cfg.sim_ms} {cfg.delivery}"
          f"{' queued links' if cfg.queued_links else ''}: {metrics}", flush=True)
    print(f"{what} on {card}: wall {wall:.3f} s, {cfg.ticks / wall:.1f} ticks/s, "
          f"{metrics['rounds_sent'] / wall:.2f} rounds/s, ring_push launches {launches}, "
          f"pushes {pushes}, metrics + all state digests equal the JAX golden", flush=True)
    return launches, pushes, wall


def _tick_group(model, cfg, dev, seed=0):
    """``(name, (ring, lo, contrib, op))`` for every push of one tick whose
    gates all fire (``model.push_members``: models/raft.py or
    models/paxos.py), at the config's shapes; rings and contributions hold
    values >= 0, as on the main path."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    _, bufs = model.init(cfg, device="meta")
    out = []
    for name, op, b, lo in model.push_members(cfg):
        shape = getattr(bufs, name).shape
        ring = torch.randint(0, 1 << 20, shape, generator=gen, device=dev, dtype=torch.int32)
        contrib = torch.randint(0, 1 << 20, (b, *shape[1:]), generator=gen, device=dev,
                                dtype=torch.int32)
        out.append((name, (ring, lo, contrib, op)))
    return out


def phase_kernel_raft(dev, card: str):
    """The grouped kernel at the Raft tick group's n = 1000 shapes against
    its plain version (eager, graph replay, skipped members left out), and
    its device time against the bound and one library call per push."""
    import torch

    from blockchain_simulator_tpu_torch.models import raft
    from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    entry = json.loads(RAFT_EDGE_GOLDEN.read_text())["entries"]["n1000"]
    cfg = SimConfig(**entry["config"])
    d = cfg.ring_depth
    named = _tick_group(raft, cfg, dev)
    items = [it for _, it in named]
    vec = rk.plan_group(items).vec
    if vec != (True,) * len(items):
        raise AssertionError(f"the Raft tick group should take the int4 path: {vec}")
    # the tick shapes the main path launches most: a heartbeat (one plain
    # member), a proposal and its acks, an election's request and replies
    by_name = dict(named)
    groups = {"raft tick": items,
              "heartbeat": [by_name["hb_plain"]],
              "proposal": [by_name[k] for k in ("hb_prop", "hb_ok", "hb_bad")],
              "election": [by_name[k] for k in ("vres_ok", "vres_no", "vreq")]}
    max_err = 0
    for name, grp in groups.items():
        for tick in (0, 7, d - 1, 9999):
            max_err = max(max_err, _check_group_run(rk, name, grp, tick, dev))

    t = torch.tensor(9999, dtype=torch.int32, device=dev)
    eager = [(r.clone(), off, c, op) for r, off, c, op in items]
    rk.fused_push_group(eager, t)
    replayed = [(r.clone(), off, c, op) for r, off, c, op in items]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rk.fused_push_group(replayed, t)
    graph.replay()
    # a skipped gate's member carries zeros: leaving it out changes nothing
    zeroed = [(r.clone(), off, torch.zeros_like(c) if name in ("vreq", "hb_bad") else c, op)
              for (name, _), (r, off, c, op) in zip(named, items)]
    left_out = [(r.clone(), off, c, op) for r, off, c, op in zeroed]
    rk.fused_push_group(zeroed, t)
    rk.fused_push_group([it for (name, _), it in zip(named, left_out)
                         if name not in ("vreq", "hb_bad")], t)
    torch.cuda.synchronize()
    if not all(torch.equal(a[0], b[0]) for a, b in zip(eager, replayed)):
        raise AssertionError("Raft tick group: graph replay != eager launch")
    if not all(torch.equal(a[0], b[0]) for a, b in zip(zeroed, left_out)):
        raise AssertionError("Raft tick group: leaving out all-zero members changed a ring")
    print(f"kernel ring_push, Raft tick group at n = {cfg.n} (vreq {tuple(by_name['vreq'][2].shape)}"
          f" + 6 x [B, {cfg.n}]): bit-equal to the plain version for the whole group, a "
          f"heartbeat, a proposal and an election at t in (0, 7, {d - 1}, 9999); graph "
          f"replay == eager; members of skipped gates left out == pushed as zeros",
          flush=True)

    # L2-warm: the same t and contributions every call (12 MB of ring slots
    # and 12 MB of vreq contribution stay in the 50 MB L2).  From HBM: t
    # steps 3 slots a call, so the 22 calls before a slot comes back touch
    # all 264 MB of vreq, and the calls rotate over 8 sets of contributions
    reps, n_sets = 100, 8
    bufs = [r.clone() for r, *_ in items]
    work = [(bufs[k], off, c, op) for k, (_, off, c, op) in enumerate(items)]
    sets = [[(bufs[k], off, c if j == 0 else c.clone(), op)
             for k, (_, off, c, op) in enumerate(items)] for j in range(n_sets)]
    t_of = [torch.tensor(9999 + 3 * i, dtype=torch.int32, device=dev) for i in range(reps)]
    lib = [_library(op) for *_, op in items]

    def slots(tick):
        return [torch.remainder(tick + off + torch.arange(c.shape[0], device=dev), d)
                for _, off, c, _ in items]

    idx = slots(9999)
    idx_cold = [slots(9999 + 3 * i) for i in range(reps)]

    def library(members, where):
        for k, (r, _, c, _) in enumerate(members):
            lib[k](r, where[k], c)

    fns = {"group": lambda i: rk.fused_push_group(work, t),
           "library": lambda i: library(work, idx),
           "plain": lambda i: rk.push_group_plain(work, t),
           "vreq alone": lambda i: rk.fused_push_group(work[2:3], t),
           "six [B, N] members": lambda i: rk.fused_push_group(work[:2] + work[3:], t)}
    cold_fns = {"group": lambda i: rk.fused_push_group(sets[i % n_sets], t_of[i]),
                "library": lambda i: library(sets[i % n_sets], idx_cold[i]),
                "plain": lambda i: rk.push_group_plain(sets[i % n_sets], t_of[i]),
                "vreq alone": lambda i: rk.fused_push_group(sets[i % n_sets][2:3], t_of[i])}
    dev_ms = {k: _time_device_ms(f, reps) for k, f in fns.items()}
    cold_ms = {k: _time_device_ms(f, reps) for k, f in cold_fns.items()}
    eager_ms = {k: _time_eager_ms(lambda f=f: f(0), reps) for k, f in fns.items()}
    bound = sum(_bound_ms(c.shape[0], c[0].numel()) for _, _, c, _ in items)
    vreq_contrib = by_name["vreq"][2]
    bound_vreq = _bound_ms(vreq_contrib.shape[0], vreq_contrib[0].numel())
    print(f"kernel ring_push Raft tick group (7 pushes, 1 launch) on {card}: device time per "
          f"tick (graph replay), rings and contributions from HBM: group "
          f"{cold_ms['group'] * 1e3:.3f} us against a {bound * 1e3:.3f} us bound "
          f"({100 * bound / cold_ms['group']:.1f}% of it), vreq alone "
          f"{cold_ms['vreq alone'] * 1e3:.3f} us vs {bound_vreq * 1e3:.3f} us, 7 library calls "
          f"{cold_ms['library'] * 1e3:.3f} us, plain {cold_ms['plain'] * 1e3:.3f} us", flush=True)
    print(f"kernel ring_push Raft tick group, L2-warm (same t and contributions): group "
          f"{dev_ms['group'] * 1e3:.3f} us, vreq alone {dev_ms['vreq alone'] * 1e3:.3f} us, the "
          f"six [B, N] members {dev_ms['six [B, N] members'] * 1e3:.3f} us, 7 library calls "
          f"{dev_ms['library'] * 1e3:.3f} us, plain {dev_ms['plain'] * 1e3:.3f} us", flush=True)
    print("kernel ring_push Raft tick group, eager per tick (host launch cost included): "
          + ", ".join(f"{k} {v * 1e3:.3f} us" for k, v in eager_ms.items()), flush=True)
    return dict(ms=cold_ms["group"], library_ms=cold_ms["library"], bound_ms=bound,
                plain_ms=cold_ms["plain"], vreq_ms=cold_ms["vreq alone"],
                vreq_bound_ms=bound_vreq, warm_ms=dev_ms, eager_ms=eager_ms), max_err


class _GroupCalls:
    """Counts the tick engine's group calls that carry at least one push
    (the ticks that push) and their members, around models/raft.py's
    ``ring_push_group``."""

    def __init__(self, module):
        self.module, self.real = module, module.ring_push_group
        self.ticks = self.members = 0

    def __call__(self, items, t):
        if items:
            self.ticks += 1
            self.members += len(items)
        return self.real(items, t)

    def __enter__(self):
        self.module.ring_push_group = self
        return self

    def __exit__(self, *exc):
        self.module.ring_push_group = self.real


def _count_syncs(fn) -> int:
    """Host syncs ``fn()`` makes: torch's sync debug mode "warn" raises one
    warning per synchronizing CUDA call."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing" in str(w.message) for w in caught)


def _profile_window(fn, ticks: int) -> dict:
    """``fn()`` timed plain, then run once more under torch.profiler (CUDA
    activity): kernel launches and device-to-host copies a tick, the
    device's busy share of the plain wall, and the kernels with the most
    device time.  The profiler's raw device events are counted as they
    come: building its FunctionEvent tree (``key_averages``) would cost
    about ten times the run itself at a thousand launches a tick."""
    import collections

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_device = [e for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA]
    count, device_ns = collections.Counter(), collections.Counter()
    for e in on_device:
        count[e.name()] += 1
        device_ns[e.name()] += e.duration_ns()
    kernels = sorted((k for k in count if not k.startswith(("Memcpy", "Memset"))),
                     key=device_ns.__getitem__, reverse=True)
    return {"wall_s": wall, "ticks_per_s": ticks / wall,
            "launches_per_tick": sum(count[k] for k in kernels) / ticks,
            "d2h_copies_per_tick": sum(v for k, v in count.items() if "DtoH" in k) / ticks,
            "device_busy_share": sum(device_ns.values()) / 1e9 / wall,
            "top_kernels": [{"name": k[:80], "count": count[k], "device_ms": device_ns[k] / 1e6}
                            for k in kernels[:6]]}


def phase_raft_tick(dev, card: str):
    """The slice's main path: Raft n = 1000 on the tick engine with edge
    delivery, through run_simulation's path, held to the JAX golden, with the
    ring-push counters set to 0 just before it and read just after."""
    import torch

    from blockchain_simulator_tpu_torch import convert, runner
    from blockchain_simulator_tpu_torch.models import raft
    from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    entry = json.loads(RAFT_EDGE_GOLDEN.read_text())["entries"]["n1000"]
    cfg = SimConfig(**entry["config"])
    if runner.use_round_schedule(cfg) or cfg.delivery != "edge":
        raise AssertionError("raft edge: the config should run the tick engine on edge delivery")
    with _GroupCalls(raft) as calls:
        rk.launches = rk.pushes = 0
        t0 = time.perf_counter()
        final = runner.final_state(cfg, seed=entry["seed"], device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, pushes = rk.launches, rk.pushes
    metrics = runner.sim_metrics(cfg, final)
    _check_golden(entry, metrics, convert.state_digests(convert.state_to_numpy(final)),
                  "raft edge")
    if launches == 0 or (launches, pushes) != (calls.ticks, calls.members):
        raise AssertionError(f"raft edge: ring_push made {launches} launches and {pushes} "
                             f"pushes; the ticks that push were {calls.ticks} with "
                             f"{calls.members} members (one launch each)")
    # the same first ticks: host syncs, then launches and device time a tick
    head = cfg.with_(sim_ms=SYNC_COUNT_TICKS)
    syncs = _count_syncs(lambda: runner.final_state(head, seed=entry["seed"], device=dev))
    prof = _profile_window(lambda: runner.final_state(head, seed=entry["seed"], device=dev),
                           head.ticks)
    print(f"raft edge: raft n={cfg.n} sim_ms={cfg.sim_ms} {cfg.delivery}/{cfg.eff_edge_sampler}"
          f": {metrics}", flush=True)
    print(f"raft edge on {card}: wall {wall:.3f} s, {cfg.ticks / wall:.1f} ticks/s, "
          f"ring_push launches {launches} (the ticks that push) and pushes {pushes} over "
          f"{cfg.ticks} ticks, {syncs / head.ticks:.3f} host syncs a tick (first "
          f"{head.ticks} ticks, sync debug mode), metrics + all state digests equal the "
          f"JAX golden", flush=True)
    print(f"raft edge, first {head.ticks} ticks under torch.profiler: {json.dumps(prof)}",
          flush=True)
    return dict(wall_s=wall, ticks=cfg.ticks, ticks_per_s=cfg.ticks / wall, launches=launches,
                pushes=pushes, syncs_per_tick=syncs / head.ticks, window=prof)


def phase_raft_hb(dev, card: str):
    """Raft n = 1000 on the heartbeat-blocked path (stat delivery, schedule
    "round") through ``runner.final_state``, held to the JAX golden and to
    its handoff flag; the wall split into init (timed alone just before),
    the prefix (up to the handoff's host read, ``raft_hb.prefix_s``) and the
    heartbeat scan on the card (the rest, up to the run's closing sync)."""
    import torch

    from blockchain_simulator_tpu_torch import convert, runner
    from blockchain_simulator_tpu_torch.models import raft, raft_hb
    from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
    from blockchain_simulator_tpu_torch.utils import threefry
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    entry = json.loads(RAFT_HB_GOLDEN.read_text())["entries"]["n1000"]
    cfg = SimConfig(**entry["config"])
    if not runner.use_round_schedule(cfg):
        raise AssertionError("raft hb: the config should run the heartbeat path")
    init_key = threefry.fold_in(threefry.key(entry["seed"]), raft_hb._INIT_FOLD)
    init_s = _timed_ms(lambda: raft.init(cfg, init_key, device=dev), dev) / 1e3
    rk.launches = rk.pushes = 0
    raft_hb.handoffs_taken = raft_hb.handoffs_refused = 0
    raft_hb.prefix_s = raft_hb.scan_s = 0.0
    t0 = time.perf_counter()
    final = runner.final_state(cfg, seed=entry["seed"], device=dev)
    wall = time.perf_counter() - t0
    launches, pushes = rk.launches, rk.pushes
    taken, refused = raft_hb.handoffs_taken, raft_hb.handoffs_refused
    prefix_s, scan_s = raft_hb.prefix_s, raft_hb.scan_s
    metrics = runner.sim_metrics(cfg, final)
    _check_golden(entry, metrics, convert.state_digests(convert.state_to_numpy(final)), "raft hb")
    if taken + refused != 1:
        raise AssertionError(f"raft hb: {taken} handoffs taken, {refused} refused; want one")
    handoff_ok = taken == 1
    if handoff_ok != entry["handoff_ok"]:
        raise AssertionError(f"raft hb: handoff {handoff_ok}, JAX {entry['handoff_ok']}")
    if launches == 0:
        raise AssertionError("raft hb: the election prefix launched no ring push")
    card_scan_s = wall - prefix_s - init_s
    print(f"raft hb: raft n={cfg.n} sim_ms={cfg.sim_ms} stat/{cfg.eff_stat_sampler} schedule "
          f"round: {metrics}", flush=True)
    print(f"raft hb on {card}: wall {wall:.3f} s, handoff taken: {handoff_ok} "
          f"(prefix {raft_hb.prefix_ticks(cfg)} ticks, then {raft_hb.n_hb_steps(cfg)} heartbeat "
          f"steps): init {init_s:.3f} s (timed alone), prefix to the handoff's read "
          f"{prefix_s:.3f} s, the [S] heartbeat scan on the card to the run's closing sync "
          f"{card_scan_s:.3f} s ({card_scan_s / wall:.1%} of the wall; its calls returned "
          f"after {scan_s:.3f} s); ring_push launches {launches} and pushes {pushes} (the "
          f"prefix), metrics + all state digests equal the JAX golden", flush=True)
    return dict(wall_s=wall, handoff_ok=handoff_ok, init_s=init_s, prefix_s=prefix_s,
                scan_s=card_scan_s, scan_host_s=scan_s, launches=launches, pushes=pushes)


def phase_kernel_paxos(dev, card: str):
    """The grouped kernel at the Paxos tick group's BASELINE config 3 shapes
    (n = 10,000, D = 106, six members of 50 buckets) against its plain
    version, bit for bit: the int4 path and the scalar path (misaligned
    contributions), ticks that wrap around D, graph replay, and skipped
    members left out.  Its device time against the bound, the plain version
    and six library calls, with the rings' slots and the contributions
    L2-warm and from HBM."""
    import torch

    from blockchain_simulator_tpu_torch.models import paxos
    from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    entry = json.loads(PAXOS_GOSSIP_GOLDEN.read_text())["entries"]["n10k"]
    cfg = SimConfig(**entry["config"])
    d = cfg.ring_depth
    named = _tick_group(paxos, cfg, dev)
    items = [it for _, it in named]
    if rk.plan_group(items).vec != (True,) * len(items):
        raise AssertionError("the Paxos tick group should take the int4 path")

    def misaligned(c):  # one element off 16-byte alignment: the scalar path
        return torch.empty(c.numel() + 1, dtype=c.dtype, device=dev)[1:].view_as(c).copy_(c)

    scalar = [(r, lo, misaligned(c), op) for r, lo, c, op in items]
    if rk.plan_group(scalar).vec != (False,) * len(items):
        raise AssertionError("misaligned contributions should take the scalar path")
    by_name = dict(named)
    groups = {"paxos tick": items, "paxos tick, scalar path": scalar,
              "replies": [by_name[k] for k in ("resp_ok", "resp_no", "resp_cmd")],
              "ticket requests": [by_name["req_ticket"]]}
    max_err = 0
    for name, grp in groups.items():
        for tick in (0, 7, d - 1, 2999):  # 2999 + lo + b wraps past D
            max_err = max(max_err, _check_group_run(rk, name, grp, tick, dev))
    t = torch.tensor(2999, dtype=torch.int32, device=dev)
    eager = [(r.clone(), off, c, op) for r, off, c, op in items]
    rk.fused_push_group(eager, t)
    replayed = [(r.clone(), off, c, op) for r, off, c, op in items]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rk.fused_push_group(replayed, t)
    graph.replay()
    skipped = ("resp_ok", "resp_no", "resp_cmd", "req_commit")
    zeroed = [(r.clone(), off, torch.zeros_like(c) if name in skipped else c, op)
              for (name, _), (r, off, c, op) in zip(named, items)]
    left_out = [(r.clone(), off, c, op) for r, off, c, op in zeroed]
    rk.fused_push_group(zeroed, t)
    rk.fused_push_group([it for (name, _), it in zip(named, left_out) if name not in skipped],
                        t)
    torch.cuda.synchronize()
    if not all(torch.equal(a[0], b[0]) for a, b in zip(eager, replayed)):
        raise AssertionError("Paxos tick group: graph replay != eager launch")
    if not all(torch.equal(a[0], b[0]) for a, b in zip(zeroed, left_out)):
        raise AssertionError("Paxos tick group: leaving out all-zero members changed a ring")
    print(f"kernel ring_push, Paxos tick group at config 3 (n = {cfg.n}, D = {d}, 6 members "
          f"of B = {items[0][2].shape[0]}): bit-equal to the plain version on the int4 and "
          f"the scalar path, the replies and the ticket requests alone, at t in (0, 7, "
          f"{d - 1}, 2999); graph replay == eager; members of skipped gates left out == "
          f"pushed as zeros", flush=True)

    # L2-warm: the same t and contributions every call.  From HBM: t steps
    # 53 slots a call and the calls rotate over 4 sets of contributions
    # (the 68 MB of rings and 4 x 32 MB of contributions exceed the 50 MB L2)
    reps, n_sets = 100, 4
    bufs = [r.clone() for r, *_ in items]
    work = [(bufs[k], off, c, op) for k, (_, off, c, op) in enumerate(items)]
    sets = [[(bufs[k], off, c if j == 0 else c.clone(), op)
             for k, (_, off, c, op) in enumerate(items)] for j in range(n_sets)]
    t_of = [torch.tensor(2999 + 53 * i, dtype=torch.int32, device=dev) for i in range(reps)]
    lib = [_library(op) for *_, op in items]

    def slots(tick):
        return [torch.remainder(tick + off + torch.arange(c.shape[0], device=dev), d)
                for _, off, c, _ in items]

    idx = slots(2999)
    idx_cold = [slots(2999 + 53 * i) for i in range(reps)]
    for k, (r, off, c, op) in enumerate(items):
        if not torch.equal(lib[k](r.clone(), idx[k], c), rk.push_plain(r.clone(), t, off, c, op)):
            raise AssertionError(f"library call disagrees with the plain version ({named[k][0]})")

    def library(members, where):
        for k, (r, _, c, _) in enumerate(members):
            lib[k](r, where[k], c)

    fns = {"group": lambda i: rk.fused_push_group(work, t),
           "library": lambda i: library(work, idx),
           "plain": lambda i: rk.push_group_plain(work, t)}
    cold_fns = {"group": lambda i: rk.fused_push_group(sets[i % n_sets], t_of[i]),
                "library": lambda i: library(sets[i % n_sets], idx_cold[i]),
                "plain": lambda i: rk.push_group_plain(sets[i % n_sets], t_of[i])}
    dev_ms = {k: _time_device_ms(f, reps) for k, f in fns.items()}
    cold_ms = {k: _time_device_ms(f, reps) for k, f in cold_fns.items()}
    eager_ms = {k: _time_eager_ms(lambda f=f: f(0), reps) for k, f in fns.items()}
    bound = sum(_bound_ms(c.shape[0], c[0].numel()) for _, _, c, _ in items)
    print(f"kernel ring_push Paxos tick group (6 pushes, 1 launch) on {card}: device time per "
          f"tick (graph replay), L2-warm: group {dev_ms['group'] * 1e3:.3f} us against a "
          f"{bound * 1e3:.3f} us bound ({100 * bound / dev_ms['group']:.1f}% of it), 6 library "
          f"calls {dev_ms['library'] * 1e3:.3f} us, plain {dev_ms['plain'] * 1e3:.3f} us",
          flush=True)
    print(f"kernel ring_push Paxos tick group, rings' slots and contributions from HBM: group "
          f"{cold_ms['group'] * 1e3:.3f} us ({100 * bound / cold_ms['group']:.1f}% of the "
          f"bound), 6 library calls {cold_ms['library'] * 1e3:.3f} us, plain "
          f"{cold_ms['plain'] * 1e3:.3f} us", flush=True)
    print("kernel ring_push Paxos tick group, eager per tick (host launch cost included): "
          + ", ".join(f"{k} {v * 1e3:.3f} us" for k, v in eager_ms.items()), flush=True)
    return dict(ms=dev_ms["group"], plain_ms=dev_ms["plain"], bound_ms=bound,
                bound_by="bytes", library_ms=dev_ms["library"], cold_rings_ms=cold_ms,
                eager_ms=eager_ms), max_err


def phase_gossip(dev, card: str, golden: pathlib.Path, entry_name: str, what: str,
                 window_ticks: int = 0):
    """A gossip run through ``runner.final_state`` held to its JAX golden,
    the neighbour table's digest checked first (a numpy that permuted
    differently must be named as such, not as a protocol fault).  The
    ring-push counters are set to 0 just before the run and read just after:
    one launch per tick that pushes.  With ``window_ticks``, the first ticks
    again: host syncs a tick (sync debug mode) and kernel launches a tick
    (torch.profiler)."""
    import numpy as np
    import torch

    from blockchain_simulator_tpu_torch import convert, runner
    from blockchain_simulator_tpu_torch.models.base import get_protocol
    from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
    from blockchain_simulator_tpu_torch.ops import topology
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    entry = json.loads(golden.read_text())["entries"][entry_name]
    cfg = SimConfig(**entry["config"])
    if runner.use_round_schedule(cfg) or cfg.topology != "gossip":
        raise AssertionError(f"{what}: the config should run the tick engine over gossip")
    table = topology.kregular_out_neighbors(cfg.n, cfg.degree, cfg.seed)
    if convert.digest(table) != entry["neighbours_sha256"]:
        raise AssertionError(f"{what}: the gossip neighbour table differs from the golden's "
                             f"(numpy {np.__version__} here, {entry['numpy_version']} there): "
                             "default_rng(seed ^ 0x70B0).permutation gave another table")
    with _GroupCalls(get_protocol(cfg.protocol)) as calls:
        rk.launches = rk.pushes = 0
        t0 = time.perf_counter()
        final = runner.final_state(cfg, seed=entry["seed"], device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, pushes = rk.launches, rk.pushes
    metrics = runner.sim_metrics(cfg, final)
    _check_golden(entry, metrics, convert.state_digests(convert.state_to_numpy(final)), what)
    if launches == 0 or (launches, pushes) != (calls.ticks, calls.members):
        raise AssertionError(f"{what}: ring_push made {launches} launches and {pushes} "
                             f"pushes; the ticks that push were {calls.ticks} with "
                             f"{calls.members} members (one launch each)")
    out = dict(wall_s=wall, ticks=cfg.ticks, ticks_per_s=cfg.ticks / wall, launches=launches,
               pushes=pushes)
    print(f"{what}: {cfg.protocol} n={cfg.n} sim_ms={cfg.sim_ms} gossip degree {cfg.degree} "
          f"hops {cfg.gossip_hops} {cfg.delivery}: {metrics}", flush=True)
    print(f"{what} on {card}: wall {wall:.3f} s, {cfg.ticks / wall:.1f} ticks/s, ring_push "
          f"launches {launches} and pushes {pushes} over {cfg.ticks} ticks, neighbour table "
          f"and metrics + all state digests equal the JAX golden", flush=True)
    if window_ticks:
        head = cfg.with_(sim_ms=window_ticks)
        syncs = _count_syncs(lambda: runner.final_state(head, seed=entry["seed"], device=dev))
        prof = _profile_window(lambda: runner.final_state(head, seed=entry["seed"], device=dev),
                               head.ticks)
        out.update(syncs_per_tick=syncs / head.ticks, window=prof)
        print(f"{what}, first {head.ticks} ticks: {syncs / head.ticks:.3f} host syncs a tick "
              f"(sync debug mode); under torch.profiler: {json.dumps(prof)}", flush=True)
    return out


def _mixed_group(cfg, dev, seed=0):
    """``(name, (ring, lo, contrib, op))`` of the mixed sim's Raft group on a
    tick whose gates all fire, at ``cfg``'s slot-major ring shapes
    (``hb_bad`` only with Byzantine nodes); values >= 0."""
    import torch

    from blockchain_simulator_tpu_torch.models import mixed, raft

    gen = torch.Generator(device=dev).manual_seed(seed)
    rcfg, _ = mixed.sub_configs(cfg)
    bufs = mixed.init(cfg, device="meta")[1].raft
    out = []
    for name, op, b, lo in raft.push_members(rcfg):
        if name == "hb_bad" and rcfg.faults.n_byzantine == 0:
            continue
        shape = getattr(bufs, name).shape
        ring = torch.randint(0, 1 << 20, shape, generator=gen, device=dev, dtype=torch.int32)
        contrib = torch.randint(0, 1 << 20, (b, *shape[1:]), generator=gen, device=dev,
                                dtype=torch.int32)
        out.append((name, (ring, lo, contrib, op)))
    return out


def phase_kernel_mixed(dev, card: str):
    """The grouped kernel at config 5's Raft group (slot-major rings, one
    member a channel of S·m lanes) against its plain version, bit for bit;
    its device time from HBM and L2-warm against the bound, the plain
    version and six library calls."""
    import torch

    from blockchain_simulator_tpu_torch.models import mixed
    from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    entry = json.loads(MIXED_GOLDEN.read_text())["entries"]["config5"]
    cfg = SimConfig(**entry["config"])
    rcfg, _ = mixed.sub_configs(cfg)
    d = rcfg.ring_depth
    named = _mixed_group(cfg, dev)
    items = [it for _, it in named]
    lanes = cfg.n
    if [c[0].numel() for _, _, c, _ in items] != [lanes] * len(items):
        raise AssertionError("the mixed Raft group should be one member a channel of S*m lanes")
    if rk.plan_group(items).vec != (True,) * len(items):
        raise AssertionError("the mixed Raft group should take the int4 path")
    by_name = dict(named)
    groups = {"mixed raft group": items,
              "heartbeat": [by_name["hb_plain"]],
              "proposal": [by_name[k] for k in ("hb_prop", "hb_ok")],
              "election": [by_name[k] for k in ("vres_ok", "vres_no", "vreq")]}
    max_err = 0
    for name, grp in groups.items():
        for tick in (0, 7, d - 1, 2999):
            max_err = max(max_err, _check_group_run(rk, name, grp, tick, dev))
    t = torch.tensor(2999, dtype=torch.int32, device=dev)
    eager = [(r.clone(), off, c, op) for r, off, c, op in items]
    rk.fused_push_group(eager, t)
    replayed = [(r.clone(), off, c, op) for r, off, c, op in items]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rk.fused_push_group(replayed, t)
    graph.replay()
    torch.cuda.synchronize()
    if not all(torch.equal(a[0], b[0]) for a, b in zip(eager, replayed)):
        raise AssertionError("mixed Raft group: graph replay != eager launch")
    shapes = ", ".join(f"{k} {tuple(it[2].shape)}" for k, it in named)
    print(f"kernel ring_push, the mixed sim's Raft group at config 5 (S = {cfg.mixed_shards}, "
          f"m = {rcfg.n}, D = {d}; {shapes}): bit-equal to the plain version for the group, "
          f"a heartbeat, a proposal and an election at t in (0, 7, {d - 1}, 2999); graph "
          f"replay == eager", flush=True)

    # From HBM: t steps 5 slots a call and the calls rotate over 4 sets of
    # contributions (74 MB of rings, 4 x 61 MB of contributions, 50 MB L2).
    # L2-warm: the same t and contributions every call
    reps, n_sets = 100, 4
    bufs = [r.clone() for r, *_ in items]
    work = [(bufs[k], off, c, op) for k, (_, off, c, op) in enumerate(items)]
    sets = [[(bufs[k], off, c if j == 0 else c.clone(), op)
             for k, (_, off, c, op) in enumerate(items)] for j in range(n_sets)]
    t_of = [torch.tensor(2999 + 5 * i, dtype=torch.int32, device=dev) for i in range(reps)]
    lib = [_library(op) for *_, op in items]

    def slots(tick):
        return [torch.remainder(tick + off + torch.arange(c.shape[0], device=dev), d)
                for _, off, c, _ in items]

    idx = slots(2999)
    idx_cold = [slots(2999 + 5 * i) for i in range(reps)]
    for k, (r, off, c, op) in enumerate(items):
        if not torch.equal(lib[k](r.clone(), idx[k], c), rk.push_plain(r.clone(), t, off, c, op)):
            raise AssertionError(f"library call disagrees with the plain version ({named[k][0]})")

    def library(members, where):
        for k, (r, _, c, _) in enumerate(members):
            lib[k](r, where[k], c)

    fns = {"group": lambda i: rk.fused_push_group(work, t),
           "library": lambda i: library(work, idx),
           "plain": lambda i: rk.push_group_plain(work, t)}
    cold_fns = {"group": lambda i: rk.fused_push_group(sets[i % n_sets], t_of[i]),
                "library": lambda i: library(sets[i % n_sets], idx_cold[i]),
                "plain": lambda i: rk.push_group_plain(sets[i % n_sets], t_of[i])}
    cold_ms = {k: _time_device_ms(f, reps) for k, f in cold_fns.items()}
    warm_ms = {k: _time_device_ms(f, reps) for k, f in fns.items()}
    eager_ms = {k: _time_eager_ms(lambda f=f: f(0), reps) for k, f in fns.items()}
    bound = sum(_bound_ms(c.shape[0], c[0].numel()) for _, _, c, _ in items)
    print(f"kernel ring_push mixed Raft group ({len(items)} pushes of {lanes} lanes, 1 launch) "
          f"on {card}: device time per tick (graph replay), rings' slots and contributions "
          f"from HBM: group {cold_ms['group'] * 1e3:.3f} us against a {bound * 1e3:.3f} us "
          f"bound ({100 * bound / cold_ms['group']:.1f}% of it), {len(items)} library calls "
          f"{cold_ms['library'] * 1e3:.3f} us, plain {cold_ms['plain'] * 1e3:.3f} us",
          flush=True)
    print(f"kernel ring_push mixed Raft group, L2-warm (same t and contributions): group "
          f"{warm_ms['group'] * 1e3:.3f} us, library {warm_ms['library'] * 1e3:.3f} us, plain "
          f"{warm_ms['plain'] * 1e3:.3f} us", flush=True)
    print("kernel ring_push mixed Raft group, eager per tick (host launch cost included): "
          + ", ".join(f"{k} {v * 1e3:.3f} us" for k, v in eager_ms.items()), flush=True)
    return dict(ms=cold_ms["group"], plain_ms=cold_ms["plain"], bound_ms=bound,
                bound_by="bytes", library_ms=cold_ms["library"], warm_ms=warm_ms,
                eager_ms=eager_ms, members=len(items), lanes=lanes), max_err


class _Marks:
    """Wraps module functions so that each call ends with a synchronize and
    a time mark (``marks[name]``, the last call's); restores them on exit.
    The phase boundaries of a run are read this way, from this script: the
    models carry no timers."""

    def __init__(self, *targets):
        self.targets = targets  # (module, attribute, mark name)
        self.marks, self.results = {}, {}

    def _wrap(self, fn, name):
        import torch

        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.marks[name] = time.perf_counter()
            self.results[name] = out
            return out
        return wrapped

    def __enter__(self):
        self.real = [getattr(m, a) for m, a, _ in self.targets]
        for (m, a, name), fn in zip(self.targets, self.real):
            setattr(m, a, self._wrap(fn, name))
        return self

    def __exit__(self, *exc):
        for (m, a, _), fn in zip(self.targets, self.real):
            setattr(m, a, fn)


def phase_mixed_config5(dev, card: str):
    """BASELINE config 5 through ``runner.final_state`` on one card, held to
    its JAX golden; every handoff taken; the wall split; then the prefix's
    host syncs and launches a tick."""
    import torch

    from blockchain_simulator_tpu_torch import convert, runner
    from blockchain_simulator_tpu_torch.models import mixed, pbft, raft, raft_hb
    from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
    from blockchain_simulator_tpu_torch.utils import threefry
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    entry = json.loads(MIXED_GOLDEN.read_text())["entries"]["config5"]
    cfg = SimConfig(**entry["config"])
    seed = entry["seed"]
    if not runner.use_round_schedule(cfg):
        raise AssertionError("config 5: schedule 'auto' should resolve to mixed.scan_fast")
    rcfg, _ = mixed.sub_configs(cfg)
    t_e = raft_hb.prefix_ticks(rcfg)
    marks = _Marks((mixed, "init", "init"), (mixed, "prefix_handoff", "prefix"),
                   (raft_hb, "materialize", "scan"), (raft_hb, "handoff", "handoff"))
    with _GroupCalls(raft) as r_calls, _GroupCalls(pbft) as p_calls, marks:
        rk.launches = rk.pushes = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = runner.final_state(cfg, seed=seed, device=dev)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches, pushes = rk.launches, rk.pushes
    wall = t_end - t0
    metrics = runner.sim_metrics(cfg, final)
    _check_golden(entry, metrics, convert.state_digests(convert.state_to_numpy(final)),
                  "config 5")
    ok_s = marks.results["handoff"][0]
    if len(ok_s) != cfg.mixed_shards or not ok_s.all():
        raise AssertionError(f"config 5: {int(ok_s.sum())} of {len(ok_s)} handoffs taken")
    if "scan" not in marks.marks:
        raise AssertionError("config 5: the heartbeat scan did not run")
    want = (cfg.mixed_shards, 40, 40, True)
    got = (metrics["shards_with_leader"], metrics["global_blocks_final"],
           metrics["global_rounds_sent"], metrics["agreement_ok"])
    if got != want:
        raise AssertionError(f"config 5: (shards with leaders, global blocks, rounds, "
                             f"agreement) = {got}, want {want}")
    if (launches, pushes) != (r_calls.ticks + p_calls.ticks, r_calls.members + p_calls.members):
        raise AssertionError(f"config 5: ring_push made {launches} launches and {pushes} "
                             f"pushes; the Raft and PBFT ticks that push were "
                             f"{r_calls.ticks} + {p_calls.ticks} with {r_calls.members} + "
                             f"{p_calls.members} members (one launch each)")
    if r_calls.ticks == 0 or p_calls.ticks != cfg.ticks:
        raise AssertionError(f"config 5: {r_calls.ticks} Raft group launches, "
                             f"{p_calls.ticks} PBFT launches over {cfg.ticks} ticks")
    split = {"init_s": marks.marks["init"] - t0,
             "prefix_s": marks.marks["prefix"] - marks.marks["init"],
             "scan_s": marks.marks["scan"] - marks.marks["prefix"],
             "pbft_layer_s": t_end - marks.marks["scan"]}
    print(f"mixed config 5: mixed n={cfg.n} shards={cfg.mixed_shards} sim_ms={cfg.sim_ms} "
          f"stat/{rcfg.eff_stat_sampler} (shards) schedule auto: {metrics}", flush=True)
    print(f"mixed config 5 on {card}: wall {wall:.3f} s, {cfg.mixed_shards} of "
          f"{cfg.mixed_shards} handoffs taken (prefix {t_e} ticks, then "
          f"{raft_hb.n_hb_steps(rcfg)} heartbeat steps): "
          + ", ".join(f"{k[:-2]} {v:.3f} s ({v / wall:.1%})" for k, v in split.items())
          + f"; ring_push launches {launches} and pushes {pushes} (the Raft group "
          f"{r_calls.ticks} / {r_calls.members}, the PBFT layer {p_calls.ticks} / "
          f"{p_calls.members}); metrics + all state digests equal the JAX golden", flush=True)

    def prefix():
        key = threefry.key(seed)
        state, bufs = mixed.init(cfg, threefry.fold_in(key, 0x1217), device=dev)
        mixed.prefix_handoff(cfg, state, bufs, key)

    syncs = _count_syncs(prefix)
    prof = _profile_window(prefix, t_e)
    print(f"mixed config 5, the {t_e} prefix ticks (init and the handoff's read included): "
          f"{syncs / t_e:.3f} host syncs a tick (sync debug mode); under torch.profiler: "
          f"{json.dumps(prof)}", flush=True)
    return dict(wall_s=wall, ticks=cfg.ticks, launches=launches, pushes=pushes,
                raft_launches=r_calls.ticks, raft_pushes=r_calls.members,
                pbft_launches=p_calls.ticks, pbft_pushes=p_calls.members,
                handoffs_taken=int(ok_s.sum()), prefix_syncs_per_tick=syncs / t_e,
                prefix_window=prof, **split)


class _Recorded:
    """Digests of every lane that the sweep's batched programs return
    (``parallel/sweep.dyn_batched_fn`` wrapped while the ``with`` lasts)."""

    def __init__(self):
        from blockchain_simulator_tpu_torch.parallel import sweep

        self.sweep, self.digests = sweep, []

    def __enter__(self):
        from blockchain_simulator_tpu_torch import convert

        real = self.real = self.sweep.dyn_batched_fn

        def wrapped(cfg):
            batched = real(cfg)

            def run(*args):
                finals = batched(*args)
                leaves = convert.state_to_numpy(finals)
                self.digests += [convert.state_digests(convert.lane_leaves(leaves, i))
                                 for i in range(len(args[0]))]
                return finals
            return run

        self.sweep.dyn_batched_fn = wrapped
        return self

    def __exit__(self, *exc):
        self.sweep.dyn_batched_fn = self.real


def _check_sweep(entry, rows, digests, what: str):
    if rows != entry["rows"]:
        bad = [i for i, (a, b) in enumerate(zip(rows, entry["rows"])) if a != b]
        raise AssertionError(f"{what}: rows {bad} differ from the JAX golden:\n"
                             f"{[rows[i] for i in bad]}\n{[entry['rows'][i] for i in bad]}")
    bad = [i for i, (a, b) in enumerate(zip(digests, entry["lane_sha256"])) if a != b]
    if bad or len(digests) != len(entry["lane_sha256"]):
        raise AssertionError(f"{what}: the final states of lanes {bad} differ from the JAX "
                             f"golden ({len(digests)} lanes)")


def _lane_round_launches(cfg, state, keys, rounds) -> float:
    """Kernel launches a round of the lane loop over ``rounds`` (raw
    profiler events, as the tick windows count them)."""
    import torch

    from blockchain_simulator_tpu_torch.models import pbft_round
    from blockchain_simulator_tpu_torch.utils import prng

    import numpy as np

    bt = cfg.pbft_block_interval_ms
    tkeys = prng.tick_key(np.asarray(keys)[None],
                          np.asarray([r * bt for r in rounds], np.int64)[:, None])
    pbft_round.step_round(cfg, state, rounds[0], tkeys[0])  # warm-up
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i, r in enumerate(rounds):
            state = pbft_round.step_round(cfg, state, r, tkeys[i])
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    return sum(not n.startswith(("Memcpy", "Memset")) for n in names) / len(rounds)


def phase_config4(dev, card: str, headline_launches: float):
    """BASELINE config 4: one 12-lane run_byzantine_sweep batch on the round
    path, held to its JAX golden; the lane loop again with host syncs an
    error; launches a round against the headline's."""
    import torch

    from blockchain_simulator_tpu_torch import convert, runner
    from blockchain_simulator_tpu_torch.models import base, pbft_round
    from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
    from blockchain_simulator_tpu_torch.parallel import sweep
    from blockchain_simulator_tpu_torch.utils import threefry
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    entry = json.loads(CONFIG4_GOLDEN.read_text())["entries"]["config4"]
    cfg = SimConfig(**entry["config"])
    f_values, seeds = entry["args"]["f_values"], entry["args"]["seeds"]
    canon = base.canonical_fault_cfg(cfg)
    if not (sweep.lane_axis(canon) and runner.use_round_schedule(canon)
            and cfg.eff_stat_sampler == "normal"):
        raise AssertionError("config 4 should batch its lanes on the round path with the "
                             "'normal' sampler")
    lanes = len(f_values) * len(seeds)
    with _Recorded() as rec:
        rk.launches = rk.pushes = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = sweep.run_byzantine_sweep(cfg, f_values=f_values, seeds=seeds, forge=False,
                                         device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rk.launches
    _check_sweep(entry, rows, rec.digests, "config 4")
    if launches != 0:
        raise AssertionError(f"config 4: the round path pushed rings ({launches} launches)")
    blocks = [r["blocks_final_all_nodes"] for r in rows]
    want = [cfg.pbft_max_rounds if r["f"] <= (cfg.n - 1) // 3 else 0 for r in rows]
    if blocks != want:
        raise AssertionError(f"config 4: blocks {blocks}, want {want}")

    # the lane loop alone, any host sync inside it an error
    keys = sweep._keys([s for _ in f_values for s in seeds])
    nb = [f for f in f_values for _ in seeds]
    step_cfg = runner.dyn_step_cfg(canon, nb)

    def lane_state():
        state, _ = pbft_round.init(canon, threefry.fold_in(keys, runner._INIT_FOLD),
                                   device=dev)
        return base.apply_fault_masks(canon, state,
                                      *base.dyn_fault_masks(cfg.n, [0] * lanes, nb, dev))

    state = lane_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = pbft_round.scan_rounds(step_cfg, state, keys)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    loop_wall = time.perf_counter() - t0
    leaves = convert.state_to_numpy(state)
    if [convert.state_digests(convert.lane_leaves(leaves, i)) for i in range(lanes)] \
            != entry["lane_sha256"]:
        raise AssertionError("config 4: the sync-checked lane loop differs from the golden")
    n_rounds = len(pbft_round.round_range(cfg))
    per_round = _lane_round_launches(step_cfg, lane_state(), keys,
                                     pbft_round.round_range(cfg)[:PROFILED_ROUNDS])
    if per_round > LANE_ROUNDS_MAX * headline_launches:
        raise AssertionError(f"config 4: {per_round:.1f} launches a round, over "
                             f"{LANE_ROUNDS_MAX} x the headline's {headline_launches:.1f}")
    sent = sum(r["rounds_sent"] for r in rows)
    print(f"config 4: pbft n={cfg.n} rounds={cfg.pbft_max_rounds} window {cfg.pbft_window} "
          f"stat/{cfg.eff_stat_sampler}, run_byzantine_sweep f={f_values} x seeds={seeds}: "
          f"blocks {blocks}", flush=True)
    print(f"config 4 on {card}: wall {wall:.3f} s for one batch of {lanes} lanes x "
          f"{n_rounds} round steps (run_byzantine_sweep, metrics included; the lane loop "
          f"alone {loop_wall:.3f} s), {sent / wall:.2f} rounds/s ({sent} rounds sent), "
          f"{per_round:.1f} kernel launches a round (first {PROFILED_ROUNDS} rounds, raw "
          f"profiler events; the headline {headline_launches:.1f}), 0 host syncs in the lane "
          f"loop (sync debug mode 'error'), rows + every lane's state digests equal the JAX "
          f"golden", flush=True)
    return {"wall_s": wall, "loop_wall_s": loop_wall, "lanes": lanes,
            "round_steps": n_rounds, "rounds_sent": sent, "rounds_per_s": sent / wall,
            "launches_per_round": per_round, "headline_launches_per_round": headline_launches,
            "ring_push_launches": launches}


def phase_drop_sweep(dev, card: str):
    """The drop sweep: run_fault_sweep over eight drop structures at seed 0
    on the round path, held to its JAX golden."""
    import torch

    from blockchain_simulator_tpu_torch.models import pbft_round
    from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
    from blockchain_simulator_tpu_torch.parallel import sweep
    from blockchain_simulator_tpu_torch.utils.config import FaultConfig, SimConfig

    entry = json.loads(DROP_GOLDEN.read_text())["entries"]["drop"]
    cfg = SimConfig(**entry["config"])
    fcs = [FaultConfig(**fc) for fc in entry["args"]["fcs"]]
    seeds = entry["args"]["seeds"]
    with _Recorded() as rec:
        rk.launches = rk.pushes = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sweep.run_fault_sweep(cfg, fcs, seeds, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rk.launches
    rows = [m for fc in fcs for m in res[fc]]
    _check_sweep(entry, rows, rec.digests, "drop sweep")
    if launches != 0:
        raise AssertionError(f"drop sweep: the round path pushed rings ({launches} launches)")
    blocks = {fc.drop_prob: m["blocks_final_all_nodes"] for fc, m in zip(fcs, rows)}
    if any((b == cfg.pbft_max_rounds) != (p <= 0.2) or (p > 0.2 and b) for p, b in blocks.items()):
        raise AssertionError(f"drop sweep: blocks by drop_prob {blocks}")
    steps = len(fcs) * len(seeds) * len(pbft_round.round_range(cfg))
    sent = sum(r["rounds_sent"] for r in rows)
    print(f"drop sweep: pbft n={cfg.n} rounds={cfg.pbft_max_rounds} stat/"
          f"{cfg.eff_stat_sampler} schedule round, run_fault_sweep over drop_prob "
          f"{list(blocks)}: blocks {list(blocks.values())}", flush=True)
    print(f"drop sweep on {card}: wall {wall:.3f} s for {len(fcs)} structure groups "
          f"({steps} round steps), {sent / wall:.2f} rounds/s ({sent} rounds sent), rows + "
          f"every lane's state digests equal the JAX golden", flush=True)
    return {"wall_s": wall, "groups": len(fcs), "round_steps": steps, "rounds_sent": sent,
            "rounds_per_s": sent / wall, "ring_push_launches": launches}


def phase_checkpoint(dev, card: str):
    """The edge tick config through run_checkpointed and resume_simulation,
    each held to the edge golden, with the ring-push counters set to 0 just
    before each run and read just after."""
    import tempfile

    import torch

    from blockchain_simulator_tpu_torch import convert, runner
    from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
    from blockchain_simulator_tpu_torch.utils import checkpoint
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    entry = json.loads(GOLDEN.read_text())["entries"]["n1000"]
    cfg = SimConfig(**entry["config"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        rk.launches = rk.pushes = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics, last = runner.run_checkpointed(cfg, every_ms=CHECKPOINT_EVERY_MS, ckpt_dir=d,
                                                seed=entry["seed"], keep_all=True, device=dev)
        wall = time.perf_counter() - t0
        counts = (rk.launches, rk.pushes)
        _, state, _, tick = checkpoint.load_checkpoint(last, device=dev)
        _check_golden(entry, metrics, convert.state_digests(convert.state_to_numpy(state)),
                      "checkpointed run")
        mids = sorted(pathlib.Path(d).glob("ckpt_*.npz"))
        if tick != cfg.ticks or [int(p.stem[5:]) for p in mids] != \
                list(range(CHECKPOINT_EVERY_MS, cfg.ticks + 1, CHECKPOINT_EVERY_MS)):
            raise AssertionError(f"checkpoint: archives {[p.name for p in mids]}")
        rk.launches = rk.pushes = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed = runner.resume_simulation(mids[0], device=dev)
        resume_wall = time.perf_counter() - t0
        resume_counts = (rk.launches, rk.pushes)
    if resumed != entry["metrics"]:
        raise AssertionError(f"resumed run: metrics differ from the JAX golden:\n{resumed}")
    rest = cfg.ticks - CHECKPOINT_EVERY_MS
    if counts != (cfg.ticks, 4 * cfg.ticks) or resume_counts != (rest, 4 * rest):
        raise AssertionError(f"checkpoint: ring_push launches/pushes {counts} and "
                             f"{resume_counts}, want one launch of four pushes a tick")
    print(f"checkpoint on {card}: run_checkpointed every {CHECKPOINT_EVERY_MS} ms, wall "
          f"{wall:.3f} s ({len(mids)} archives), ring_push launches {counts[0]} and pushes "
          f"{counts[1]}; resume_simulation from {mids[0].name}: wall {resume_wall:.3f} s, "
          f"launches {resume_counts[0]} and pushes {resume_counts[1]}; metrics (and the "
          f"final archive's state digests) equal the JAX golden", flush=True)
    return {"wall_s": wall, "resume_wall_s": resume_wall, "launches": counts[0],
            "pushes": counts[1], "resume_launches": resume_counts[0],
            "resume_pushes": resume_counts[1]}


def _mismatches(got, want) -> int:
    """Elements that differ (NaN equals NaN)."""
    got, want = got.cpu(), want.cpu()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    same = got == want
    if got.is_floating_point():
        same |= got.isnan() & want.isnan()
    return int((~same).sum())


def _timed_ms(fn, dev) -> float:
    import torch

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3


def phase_samplers(dev, card: str):
    """The PRNG and sampler functions on the card against the same functions
    on the CPU (their plain versions), at 10^6 elements, and the time of one
    multinomial chain of each mode at [5, 100000]."""
    import numpy as np
    import torch

    from blockchain_simulator_tpu_torch.ops import delay
    from blockchain_simulator_tpu_torch.utils import philox, threefry

    key = threefry.fold_in(threefry.key(0), 0x5A)
    rng = np.random.default_rng(0)
    count = torch.as_tensor(rng.integers(0, 3000, SAMPLER_N).astype(np.float32))
    logits = delay.uniform_probs(3, 6)
    cases = {
        "philox_bits": lambda d: philox.bits(philox.rbg_key(key), (SAMPLER_N,), d),
        "fast_normal": lambda d: delay._fast_normal(key, (SAMPLER_N,), d),
        "binomial_exact": lambda d: threefry.binomial(key, count.to(d), 1 / 3, d),
        "categorical": lambda d: threefry.categorical(
            key, torch.log(torch.as_tensor(logits, dtype=torch.float32)), (SAMPLER_N,), d),
    }
    out = {}
    for name, fn in cases.items():
        fn(dev)  # warm-up
        ms = _timed_ms(lambda: fn(dev), dev)
        bad = _mismatches(fn(dev), fn("cpu"))
        out[name] = {"mismatches": bad, "elements": SAMPLER_N, "card_ms": ms}
        print(f"samplers {name}: {bad} mismatches of {SAMPLER_N} (card vs CPU), "
              f"{ms:.2f} ms on the card", flush=True)
    m = torch.as_tensor(rng.integers(0, 100_000, (5, 100_000)).astype(np.int32))
    probs = delay.roundtrip_probs(3, 6)
    for mode in ("normal", "exact"):
        def chain(d, mode=mode):
            return delay.sample_bucket_counts(key, m.to(d), probs, mode)

        chain(dev)
        ms = _timed_ms(lambda: chain(dev), dev)
        bad = _mismatches(chain(dev), chain("cpu"))
        out[f"chain_{mode}"] = {"mismatches": bad, "shape": [5, 100_000],
                                "buckets": len(probs), "card_ms": ms}
        print(f"samplers chain {mode} [5, 100000] x {len(probs)} buckets: {ms:.2f} ms on "
              f"{card}, {bad} mismatches (card vs CPU)", flush=True)
    bad = {k: v["mismatches"] for k, v in out.items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"samplers: the card disagrees with the CPU: {bad}")
    return out


def phase_round(dev, card: str):
    """The bench headline on the round-blocked fast path, held to the JAX
    golden, with no host sync inside the round loop."""
    import torch

    from blockchain_simulator_tpu_torch import convert, runner
    from blockchain_simulator_tpu_torch.models import pbft_round
    from blockchain_simulator_tpu_torch.profile_tick import _device_us
    from blockchain_simulator_tpu_torch.utils import prng, threefry
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    entry = json.loads(ROUND_GOLDEN.read_text())["entries"]["n100k"]
    cfg = SimConfig(**entry["config"])
    if not runner.use_round_schedule(cfg) or cfg.eff_stat_sampler != "normal":
        raise AssertionError("the headline config should resolve to the round path "
                             "with the 'normal' sampler")
    key = threefry.key(entry["seed"])
    init_key = threefry.fold_in(key, runner._INIT_FOLD)

    # kernel launches per round: the first rounds under the profiler
    state, _ = pbft_round.init(cfg, init_key, device=dev)
    rounds = pbft_round.round_range(cfg)[:PROFILED_ROUNDS]
    tkeys = prng.tick_key(key, [r * cfg.pbft_block_interval_ms for r in rounds])
    pbft_round.step_round(cfg, state, rounds[0], tkeys[0])  # warm-up
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                acc_events=True) as prof:
        for i, r in enumerate(rounds):
            state = pbft_round.step_round(cfg, state, r, tkeys[i])
        torch.cuda.synchronize(dev)
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0]
    per_round = sum(e.count for e in kernels
                    if not e.key.startswith(("Memcpy", "Memset"))) / len(rounds)
    copies_d2h = sum(e.count for e in kernels if "DtoH" in e.key) / len(rounds)

    # the entry point a user calls, timed
    t0 = time.perf_counter()
    final = runner.final_state(cfg, seed=entry["seed"], device=dev)
    wall = time.perf_counter() - t0
    metrics = runner.sim_metrics(cfg, final)
    digests = convert.state_digests(convert.state_to_numpy(final))
    _check_golden(entry, metrics, digests, "round path")

    # the same loop once more with any host sync inside it an error
    state, _ = pbft_round.init(cfg, init_key, device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = pbft_round.scan_rounds(cfg, state, key)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(dev)
    wall_loop = time.perf_counter() - t0
    if convert.state_digests(convert.state_to_numpy(state)) != digests:
        raise AssertionError("round path: the sync-checked loop and run_simulation differ")
    n_rounds = len(pbft_round.round_range(cfg))
    print(f"round path: pbft n={cfg.n} rounds={n_rounds} stat/{cfg.eff_stat_sampler}: "
          f"{metrics}", flush=True)
    print(f"round path on {card}: wall {wall:.3f} s (run_simulation's path; the round "
          f"loop alone {wall_loop:.3f} s) for {n_rounds} rounds, "
          f"{metrics['rounds_sent'] / wall:.2f} rounds/s, {per_round:.1f} kernel launches "
          f"and {copies_d2h:.2f} device-to-host copies per round (first {len(rounds)} "
          f"rounds, torch.profiler), 0 host syncs in the round loop (sync debug mode "
          f"'error'), metrics + all state digests equal the JAX golden", flush=True)
    return {"wall_s": wall, "loop_wall_s": wall_loop, "rounds": n_rounds,
            "rounds_per_s": metrics["rounds_sent"] / wall,
            "launches_per_round": per_round, "d2h_copies_per_round": copies_d2h}


def phase_kernel_topo(dev, card: str):
    """The grouped kernel at the sparse-topology paths' new member shapes
    against its plain version, bit for bit, eager and under a CUDA-graph
    replay: PBFT's four pushes at n = 1,000,000 (the kreg-1m rung: rings
    [8, 10^6, 8], L = N·W = 8,000,000) and Raft kregular's group at
    n = 10,000, degree 16 (``vreq`` [D, N, K]).  Device time per call
    (graph replay; the 1M group's ~1 GB of rings and contributions exceed
    the L2, so they come from HBM) against the bound, the plain version and
    one library call per push."""
    import torch

    from blockchain_simulator_tpu_torch.models import pbft, raft
    from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    out, max_err = {}, 0
    kreg1m = SimConfig(**json.loads(KREG_1M_GOLDEN.read_text())["entries"]["kreg1m"]["config"])
    kraft = SimConfig(**json.loads(KREG_RP_GOLDEN.read_text())["entries"]["raft"]["config"])
    for name, model, cfg, reps in (("pbft_1m_group", pbft, kreg1m, 10),
                                   ("raft_kreg_group", raft, kraft, 50)):
        named = _tick_group(model, cfg, dev)
        items = [it for _, it in named]
        d = items[0][0].shape[0]
        for tick in (0, 7, d - 1, cfg.ticks - 1):
            max_err = max(max_err, _check_group_run(rk, name, items, tick, dev))
        t = torch.tensor(cfg.ticks - 1, dtype=torch.int32, device=dev)
        eager = [(r.clone(), off, c, op) for r, off, c, op in items]
        rk.fused_push_group(eager, t)
        replayed = [(r.clone(), off, c, op) for r, off, c, op in items]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            rk.fused_push_group(replayed, t)
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(a[0], b[0]) for a, b in zip(eager, replayed)):
            raise AssertionError(f"{name}: graph replay != eager launch")
        del eager, replayed, graph
        lib = [_library(op) for *_, op in items]
        idx = [torch.remainder(cfg.ticks - 1 + off + torch.arange(c.shape[0], device=dev), d)
               for _, off, c, _ in items]
        for k, (r, off, c, op) in enumerate(items):
            if not torch.equal(lib[k](r.clone(), idx[k], c), rk.push_plain(r.clone(), t, off, c, op)):
                raise AssertionError(f"{name}: library call disagrees with the plain version "
                                     f"({named[k][0]})")

        def library():
            for k, (r, _, c, _) in enumerate(items):
                lib[k](r, idx[k], c)

        fns = {"group": lambda i: rk.fused_push_group(items, t),
               "library": lambda i: library(),
               "plain": lambda i: rk.push_group_plain(items, t)}
        ms = {k: _time_device_ms(f, reps) for k, f in fns.items()}
        bound = sum(_bound_ms(c.shape[0], c[0].numel()) for _, _, c, _ in items)
        shapes = {nm: (it[2].shape[0], it[2][0].numel()) for nm, it in named}
        out[name] = dict(ms=ms["group"], plain_ms=ms["plain"], library_ms=ms["library"],
                         bound_ms=bound, bound_by="bytes", members={k: list(v) for k, v in
                                                                    shapes.items()})
        print(f"kernel ring_push {name} on {card}: {len(items)} pushes (B, L) {shapes}: "
              f"bit-equal to the plain version at t in (0, 7, {d - 1}, {cfg.ticks - 1}), graph "
              f"replay == eager; device time per call (graph replay) {ms['group'] * 1e3:.3f} us "
              f"against a {bound * 1e3:.3f} us bound ({100 * bound / ms['group']:.1f}% of it), "
              f"{len(items)} library calls {ms['library'] * 1e3:.3f} us, plain "
              f"{ms['plain'] * 1e3:.3f} us", flush=True)
        del items, named
        torch.cuda.empty_cache()
    return out, max_err


def _golden_run(entry, dev, what: str, model=None):
    """A run through ``runner.final_state`` held to its JAX golden, the
    ring-push counters set to 0 just before it and read just after (with
    ``model``, the ticks that push and their members are counted around its
    ``ring_push_group``).  Returns ``(cfg, metrics, wall_s, launches,
    pushes, calls)``."""
    import contextlib

    import torch

    from blockchain_simulator_tpu_torch import convert, runner
    from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    cfg = SimConfig(**entry["config"])
    with (_GroupCalls(model) if model is not None else contextlib.nullcontext()) as calls:
        torch.cuda.synchronize()
        rk.launches = rk.pushes = 0
        t0 = time.perf_counter()
        final = runner.final_state(cfg, seed=entry["seed"], device=dev)
        wall = time.perf_counter() - t0
        launches, pushes = rk.launches, rk.pushes
    metrics = runner.sim_metrics(cfg, final)
    _check_golden(entry, metrics, convert.state_digests(convert.state_to_numpy(final)), what)
    return cfg, metrics, wall, launches, pushes, calls


def phase_kreg_1m(dev, card: str):
    """The artifact's largest kregular rung, PBFT at n = 1,000,000 over a
    degree-8 overlay, uncut, through ``runner.final_state``: metrics and
    every state digest equal the JAX golden, one ring-push launch of four
    pushes a tick.  Then the wall split (the overlay tables built on the
    host and moved to the card, init, the tick loop), host syncs a tick
    (sync debug mode), launches a tick (raw profiler events) and the peak
    of allocated card memory."""
    import torch

    from blockchain_simulator_tpu_torch.models import base, pbft
    from blockchain_simulator_tpu_torch.topo import spec
    from blockchain_simulator_tpu_torch.utils import threefry

    entry = json.loads(KREG_1M_GOLDEN.read_text())["entries"]["kreg1m"]
    spec._tables.cache_clear()
    spec.device_tables.cache_clear()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, metrics, wall, launches, pushes, _ = _golden_run(entry, dev, "kreg-1m")
    peak = torch.cuda.max_memory_allocated(dev)
    if (launches, pushes) != (cfg.ticks, 4 * cfg.ticks):
        raise AssertionError(f"kreg-1m: ring_push made {launches} launches and {pushes} "
                             f"pushes, want one launch of four pushes a tick ({cfg.ticks})")
    # the wall apart: tables (host build + copy to the card), init, the loop
    spec._tables.cache_clear()
    spec.device_tables.cache_clear()
    t0 = time.perf_counter()
    spec._tables(cfg.n, cfg.degree, cfg.topo_seed)
    host_s = time.perf_counter() - t0
    copy_s = _timed_ms(lambda: spec.device_tables(cfg.n, cfg.degree, cfg.topo_seed, dev),
                       dev) / 1e3
    key = threefry.key(entry["seed"])
    init_key = threefry.fold_in(key, 0x1217)
    init_s = _timed_ms(lambda: pbft.init(cfg, init_key, device=dev), dev) / 1e3

    def loop():
        state, bufs = pbft.init(cfg, init_key, device=dev)
        base.tick_loop(cfg, state, bufs, key, 0, cfg.ticks)

    loop_s = _timed_ms(loop, dev) / 1e3 - init_s
    syncs = _count_syncs(loop)
    prof = _profile_window(loop, cfg.ticks)
    tables_mb = 3 * cfg.n * (cfg.degree + 1) * 8 / 2**20
    print(f"kreg-1m: pbft n={cfg.n} kregular degree {cfg.degree} {cfg.delivery}/"
          f"{cfg.eff_edge_sampler} sim_ms={cfg.sim_ms}: {metrics}", flush=True)
    print(f"kreg-1m on {card}: wall {wall:.3f} s through runner.final_state, "
          f"{cfg.ticks / wall:.2f} ticks/s; apart: tables {host_s:.3f} s on the host + "
          f"{copy_s:.3f} s to the card ({tables_mb:.0f} MB int64), init {init_s:.3f} s, the "
          f"tick loop {loop_s:.3f} s ({cfg.ticks / loop_s:.2f} ticks/s); "
          f"{syncs / cfg.ticks:.3f} host syncs and {prof['launches_per_tick']:.1f} kernel "
          f"launches a tick, device busy {prof['device_busy_share']:.1%}; peak allocated "
          f"{peak / 2**30:.3f} GiB; ring_push launches {launches} and pushes {pushes}; "
          f"metrics + all state digests equal the JAX golden", flush=True)
    return dict(wall_s=wall, ticks=cfg.ticks, ticks_per_s=cfg.ticks / wall,
                tables_host_s=host_s, tables_copy_s=copy_s, init_s=init_s, loop_s=loop_s,
                loop_ticks_per_s=cfg.ticks / loop_s, syncs_per_tick=syncs / cfg.ticks,
                window=prof, max_memory_allocated=int(peak), launches=launches,
                pushes=pushes, rounds_sent=metrics["rounds_sent"])


def phase_committee_100k(dev, card: str):
    """The artifact's committee row, PBFT at n = 100,000 in 200 committees
    of 500, uncut, through ``runner.final_state``: the committees run in
    turn on the inner tick engine; metrics (200 of 200 decided,
    ``outer_commit_ms`` 116.0, every inner milestone) and every stacked
    state digest equal the JAX golden; one ring-push launch of four pushes
    an inner tick."""
    import torch

    entry = json.loads(COMMITTEE_GOLDEN.read_text())["entries"]["committee100k"]
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, metrics, wall, launches, pushes, _ = _golden_run(entry, dev, "committee-100k")
    peak = torch.cuda.max_memory_allocated(dev)
    c = cfg.committees
    inner_ticks = c * cfg.ticks
    if (metrics["committees_decided"], metrics["outer_commit_ms"]) != (c, 116.0):
        raise AssertionError(f"committee-100k: {metrics['committees_decided']} of {c} "
                             f"decided, outer commit {metrics['outer_commit_ms']} ms")
    if (launches, pushes) != (inner_ticks, 4 * inner_ticks):
        raise AssertionError(f"committee-100k: ring_push made {launches} launches and "
                             f"{pushes} pushes, want one launch of four pushes an inner tick "
                             f"({inner_ticks})")
    miles = metrics["inner_milestones_ms"]
    print(f"committee-100k: pbft n={cfg.n} in {c} committees of {cfg.n // c}, "
          f"{cfg.delivery}/{cfg.eff_stat_sampler} sim_ms={cfg.sim_ms}: decided "
          f"{metrics['committees_decided']}/{c}, outer commit {metrics['outer_commit_ms']} ms "
          f"(quorum {metrics['outer_quorum']}, round {metrics['outer_round_ms']} ms), inner "
          f"milestones {min(miles)}..{max(miles)} ms", flush=True)
    print(f"committee-100k on {card}: wall {wall:.3f} s, {wall / c:.4f} s a committee, "
          f"{inner_ticks / wall:.1f} inner ticks/s; peak allocated {peak / 2**20:.1f} MiB; "
          f"ring_push launches {launches} and pushes {pushes}; metrics, the {c} inner "
          f"milestones and all stacked state digests equal the JAX golden", flush=True)
    return dict(wall_s=wall, committees=c, s_per_committee=wall / c,
                inner_ticks=inner_ticks, inner_ticks_per_s=inner_ticks / wall,
                max_memory_allocated=int(peak), launches=launches, pushes=pushes,
                committees_decided=metrics["committees_decided"],
                outer_commit_ms=metrics["outer_commit_ms"])


def phase_kreg_raft_paxos(dev, card: str):
    """Raft (edge) and Paxos over a degree-16 kregular overlay at n = 10,000,
    1,000 ms each, through ``runner.final_state``, each held to its JAX
    golden; the Raft run pushes the ``vreq`` [D, N, K] member and routes its
    votes back through the inslot cross-index on the card.  One ring-push
    launch a tick that pushes."""
    from blockchain_simulator_tpu_torch.models import paxos, raft

    doc = json.loads(KREG_RP_GOLDEN.read_text())["entries"]
    out = {}
    for name, model in (("raft", raft), ("paxos", paxos)):
        what = f"kreg-{name}"
        cfg, metrics, wall, launches, pushes, calls = _golden_run(doc[name], dev, what, model)
        if launches == 0 or (launches, pushes) != (calls.ticks, calls.members):
            raise AssertionError(f"{what}: ring_push made {launches} launches and {pushes} "
                                 f"pushes; the ticks that push were {calls.ticks} with "
                                 f"{calls.members} members (one launch each)")
        print(f"{what}: {name} n={cfg.n} kregular degree {cfg.degree} {cfg.delivery} "
              f"sim_ms={cfg.sim_ms}: {metrics}", flush=True)
        print(f"{what} on {card}: wall {wall:.3f} s, {cfg.ticks / wall:.1f} ticks/s, "
              f"ring_push launches {launches} and pushes {pushes} over {cfg.ticks} ticks, "
              f"metrics + all state digests equal the JAX golden", flush=True)
        out[name] = dict(wall_s=wall, ticks=cfg.ticks, ticks_per_s=cfg.ticks / wall,
                         launches=launches, pushes=pushes)
    return out


def phase_kreg_equal(dev, card: str):
    """On the card, the port's kregular run at k = N-1 (n = 256, k = 255)
    equals its dense run bit for bit, metrics and every state digest:
    PBFT on edge delivery (threefry) and Raft on stat delivery (exact)."""
    import torch

    from blockchain_simulator_tpu_torch import convert, runner
    from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    out = {}
    for name, kw in KREG_EQUAL.items():
        res = {}
        for topo in ("full", "kregular"):
            cfg = SimConfig(**kw, topology=topo, degree=kw["n"] - 1)
            torch.cuda.synchronize()
            rk.launches = rk.pushes = 0
            t0 = time.perf_counter()
            final = runner.final_state(cfg, device=dev)
            wall = time.perf_counter() - t0
            res[topo] = (runner.sim_metrics(cfg, final),
                         convert.state_digests(convert.state_to_numpy(final)), wall,
                         rk.launches, rk.pushes)
        (dm, dd, dw, dl, dp), (km, kd, kw_, kl, kp) = res["full"], res["kregular"]
        if km != dm or kd != dd:
            bad = sorted(k for k in dd if kd.get(k) != dd[k])
            raise AssertionError(f"kreg-equal {name}: the kregular run at k = N-1 differs "
                                 f"from the dense run: metrics equal {km == dm}, fields {bad}")
        if kl == 0 or (kl, kp) != (dl, dp):
            raise AssertionError(f"kreg-equal {name}: ring_push launches/pushes kregular "
                                 f"{(kl, kp)} vs dense {(dl, dp)}")
        print(f"kreg-equal {name} on {card}: n={kw['n']} k={kw['n'] - 1} kregular == dense "
              f"(metrics and all {len(dd)} state digests): {dm}; wall dense {dw:.3f} s, "
              f"kregular {kw_:.3f} s; ring_push launches {kl}, pushes {kp} each", flush=True)
        out[name] = dict(dense_wall_s=dw, kreg_wall_s=kw_, launches=kl, pushes=kp)
    return out


# --------------------------------------------------------------------------- #
# traces, run manifests and the command line                                  #
# --------------------------------------------------------------------------- #


def _series_summary(series: dict) -> dict:
    """What the trace golden keeps of a series dict (tests/test_torch_trace.py
    ``series_summary``): each array's sha256 (convert.digest), dtype, shape
    and last value."""
    from blockchain_simulator_tpu_torch import convert

    return {k: {"sha256": convert.digest(v), "dtype": str(v.dtype), "shape": list(v.shape),
                "last": v[..., -1].tolist() if v.size else None}
            for k, v in sorted(series.items())}


def _check_trace(entry, metrics, series, what: str):
    """Metrics and every series (sha256, dtype, shape, last value) against
    the trace golden's entry."""
    if metrics != entry["metrics"]:
        raise AssertionError(f"{what}: metrics differ from the JAX golden:\n{metrics}\n"
                             f"{entry['metrics']}")
    got = _series_summary(series)
    bad = sorted(k for k in set(got) | set(entry["series"])
                 if got.get(k) != entry["series"].get(k))
    if bad:
        raise AssertionError(f"{what}: series differ from the JAX golden: {bad}")


def _cli(argv) -> dict:
    """``cli.main(argv)`` in this process; its last JSON line (exit 0 or
    the phase fails)."""
    import contextlib
    import io

    from blockchain_simulator_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)}: exit {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _check_manifest(line, what: str, config_hash=None):
    import torch

    man = line["manifest"]
    if (man.get("backend"), man.get("device")) != ("cuda", torch.cuda.get_device_name(0)):
        raise AssertionError(f"{what}: the manifest {man} does not name the card")
    if config_hash is not None and man["config_hash"] != config_hash:
        raise AssertionError(f"{what}: config hash {man['config_hash']}, the JAX CLI's "
                             f"{config_hash}")


def _cli_trace(argv, entry, dev, what: str):
    """The CLI with ``--trace`` into a temporary file: the line's metrics and
    the file's series against the golden, the manifest naming the card and
    the JAX CLI's config hash.  Returns ``(line, series, wall_s)``."""
    import tempfile

    import numpy as np
    import torch

    with tempfile.TemporaryDirectory() as d:
        path = str(pathlib.Path(d) / "series.npz")
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        line = _cli(argv + ["--trace", path])
        wall = time.perf_counter() - t0
        with np.load(path) as f:
            series = {k: f[k] for k in f.files}
    metrics = {k: v for k, v in line.items()
               if k not in ("manifest", "trace_file", "trace_series", "seed")}
    _check_trace(entry, metrics, series, what)
    _check_manifest(line, what, entry["config_hash"])
    return line, series, wall


def _round_launches(cfg, dev, probed: bool, rounds: int) -> float:
    """Kernel launches a round of the round path over its first rounds (raw
    profiler events, after one warm-up round), with or without the probe."""
    import functools

    import torch

    from blockchain_simulator_tpu_torch import runner
    from blockchain_simulator_tpu_torch.models import pbft_round
    from blockchain_simulator_tpu_torch.utils import prng, threefry, trace

    key = threefry.key(0)
    state, _ = pbft_round.init(cfg, threefry.fold_in(key, runner._INIT_FOLD), device=dev)
    rr = pbft_round.round_range(cfg)[:rounds + 1]
    tkeys = prng.tick_key(key, [r * cfg.pbft_block_interval_ms for r in rr])
    tap = functools.partial(trace.probe, cfg) if probed else (lambda st: None)
    state = pbft_round.step_round(cfg, state, rr[0], tkeys[0])  # warm-up
    tap(state)
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(1, len(rr)):
            state = pbft_round.step_round(cfg, state, rr[i], tkeys[i])
            tap(state)
        torch.cuda.synchronize(dev)
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.name().startswith(("Memcpy", "Memset"))]
    return len(kernels) / (len(rr) - 1)


def phase_cli_trace_round(dev, card: str):
    """The slice at full width: ``cli.main`` in this process with the
    headline's flags (bench._cfg: PBFT, n = 100,000, stat, serialization
    off, window 8) cut to 500 rounds, with ``--trace``: the metrics line and
    every series equal the JAX golden, the manifest names the card.  Then
    the probed scan over the first 100 rounds under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync inside it fails
    the phase), its series the CLI's; then kernel launches a round, probed
    against unprobed, over the first rounds."""
    import numpy as np
    import torch

    from blockchain_simulator_tpu_torch import cli, runner
    from blockchain_simulator_tpu_torch.models import pbft_round
    from blockchain_simulator_tpu_torch.utils import threefry

    entry = json.loads(TRACE_GOLDEN.read_text())["entries"]["cli_trace_round"]
    cfg = cli.config_from_args(cli.build_parser().parse_args(entry["argv"]))
    if not runner.use_round_schedule(cfg):
        raise AssertionError("cli-trace-round: the config should run the round path")
    line, series, wall = _cli_trace(entry["argv"], entry, dev, "cli-trace-round")
    head = cfg.with_(sim_ms=SYNC_CHECKED_ROUNDS * cfg.pbft_block_interval_ms + 1)
    key = threefry.key(0)
    state, _ = pbft_round.init(head, threefry.fold_in(key, runner._INIT_FOLD), device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, ys = pbft_round.scan_rounds(head, state, key, with_probe=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(dev)
    head_s = time.perf_counter() - t0
    # the head's last round is cut at its window's end, so it is left out
    for k, v in ys.items():
        if not np.array_equal(v.cpu().numpy()[:-1], series[k][:len(v) - 1]):
            raise AssertionError(f"cli-trace-round: the sync-checked scan's {k} differs")
    probed = _round_launches(cfg, dev, True, PROFILED_ROUNDS)
    plain = _round_launches(cfg, dev, False, PROFILED_ROUNDS)
    rounds = len(pbft_round.round_range(cfg))
    print(f"cli-trace-round: {' '.join(entry['argv'])} --trace: "
          f"{ {k: line[k] for k in entry['metrics']} }", flush=True)
    print(f"cli-trace-round on {card}: wall {wall:.3f} s (cli.main, {rounds} rounds, "
          f"{line['rounds_sent'] / wall:.2f} rounds/s), metrics + {len(series)} series equal "
          f"the JAX golden, the manifest names {line['manifest']['device']}; 0 host syncs "
          f"in the probed scan (its first {len(ys['rounds_sent'])} rounds, sync debug mode "
          f"'error', {head_s:.3f} s); {probed:.1f} kernel launches a round probed, "
          f"{plain:.1f} unprobed (first {PROFILED_ROUNDS} rounds, torch.profiler)", flush=True)
    return dict(wall_s=wall, rounds=rounds, rounds_per_s=line["rounds_sent"] / wall,
                sync_checked_rounds=len(ys["rounds_sent"]), sync_checked_s=head_s,
                launches_per_round_probed=probed, launches_per_round=plain)


def phase_cli_trace_tick(dev, card: str):
    """``cli.main`` with BASELINE config 2's flags (PBFT, n = 1000, 2,500 ms,
    edge) and ``--schedule tick --trace``, under sync debug mode "warn":
    the metrics equal the edge golden (pbft_edge_s0.json n1000), the series
    the trace golden; one ring-push launch of four pushes a tick, as
    untraced; host syncs a tick of the whole CLI run."""
    from blockchain_simulator_tpu_torch.ops import ring_kernel as rk

    entry = json.loads(TRACE_GOLDEN.read_text())["entries"]["cli_trace_tick"]
    edge = json.loads(GOLDEN.read_text())["entries"]["n1000"]
    if entry["metrics"] != edge["metrics"]:
        raise AssertionError("cli-trace-tick: the trace golden is not the edge golden's run")
    ticks = 2500
    out = {}

    def run():
        rk.launches = rk.pushes = 0
        out["line"], out["series"], out["wall"] = _cli_trace(entry["argv"], entry, dev,
                                                             "cli-trace-tick")
        out["launches"], out["pushes"] = rk.launches, rk.pushes

    syncs = _count_syncs(run)
    if (out["launches"], out["pushes"]) != (ticks, 4 * ticks):
        raise AssertionError(f"cli-trace-tick: ring_push made {out['launches']} launches and "
                             f"{out['pushes']} pushes, want {ticks} and {4 * ticks}")
    print(f"cli-trace-tick on {card}: {' '.join(entry['argv'])} --trace: wall "
          f"{out['wall']:.3f} s under sync debug mode 'warn' ({ticks / out['wall']:.1f} "
          f"ticks/s), metrics equal the edge golden, {len(out['series'])} series the trace "
          f"golden; ring_push launches {out['launches']} and pushes {out['pushes']}; "
          f"{syncs / ticks:.3f} host syncs a tick ({syncs} in the CLI run)", flush=True)
    return dict(wall_s=out["wall"], ticks=ticks, launches=out["launches"],
                pushes=out["pushes"], syncs_per_tick=syncs / ticks)


def _traced_phase(name: str, dev, card: str, check=None):
    """``run_traced`` on a trace golden entry's config, held to it; the
    ring-push counters set to 0 just before and read just after."""
    import torch

    from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
    from blockchain_simulator_tpu_torch.utils import trace
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    entry = json.loads(TRACE_GOLDEN.read_text())["entries"][name]
    cfg = SimConfig(**entry["config"])
    torch.cuda.synchronize(dev)
    rk.launches = rk.pushes = 0
    t0 = time.perf_counter()
    metrics, series = trace.run_traced(cfg, seed=entry["seed"], device=dev)
    wall = time.perf_counter() - t0
    launches, pushes = rk.launches, rk.pushes
    _check_trace(entry, metrics, series, name)
    if check is not None:
        check(cfg, metrics, series, launches, pushes)
    shapes = {k: v.shape for k, v in series.items()}
    print(f"{name} on {card}: run_traced {cfg.protocol} n={cfg.n} sim_ms={cfg.sim_ms}: wall "
          f"{wall:.3f} s, ring_push launches {launches} and pushes {pushes}, metrics + "
          f"series {shapes} equal the JAX golden", flush=True)
    return dict(wall_s=wall, launches=launches, pushes=pushes,
                samples=len(series.get("t", next(iter(series.values())))))


def phase_trace_hb(dev, card: str):
    """The Raft heartbeat golden's config (raft_hb_n1000_s0.json) through
    ``run_traced``: its metrics, the handoff taken (a ``"t"`` axis of
    heartbeats), the per-heartbeat series equal the JAX golden."""
    hb = json.loads(RAFT_HB_GOLDEN.read_text())["entries"]["n1000"]

    def check(cfg, metrics, series, launches, pushes):
        if metrics != hb["metrics"] or "t" not in series or launches == 0:
            raise AssertionError("trace-hb: not the heartbeat golden's run with the "
                                 "handoff taken and the prefix's pushes")

    return _traced_phase("trace_hb", dev, card, check)


def phase_trace_mixed(dev, card: str):
    """16 Raft shards x 1,000 nodes, 3,000 ms, stat, serialization off
    (config 5's knobs at 16 shards) through ``run_traced``: every handoff
    taken, per-heartbeat shard aggregates and the PBFT layer equal the JAX
    golden."""

    def check(cfg, metrics, series, launches, pushes):
        if "t" not in series or metrics["shards_with_leader"] != cfg.mixed_shards:
            raise AssertionError("trace-mixed: a handoff was refused")

    return _traced_phase("trace_mixed", dev, card, check)


def phase_trace_committee(dev, card: str):
    """PBFT n = 5,000 in 10 committees of 500, 150 ms, stat, "normal" (the
    committee row's knobs) through ``run_traced``: stacked ``[10, 150]``
    series equal the JAX golden; one ring-push launch of four pushes an
    inner tick."""

    def check(cfg, metrics, series, launches, pushes):
        inner = cfg.committees * cfg.ticks
        if (launches, pushes) != (inner, 4 * inner):
            raise AssertionError(f"trace-committee: ring_push made {launches} launches and "
                                 f"{pushes} pushes, want {inner} and {4 * inner}")

    return _traced_phase("trace_committee", dev, card, check)


def phase_profile(dev, card: str):
    """``cli.main`` with ``--profile DIR`` on PBFT n = 1000, edge, 200 ms:
    the metrics equal the JAX golden, and the exported Chrome trace holds
    one ``ring_push`` kernel event a tick of the profiled run."""
    import tempfile

    entry = json.loads(TRACE_GOLDEN.read_text())["entries"]["profile"]
    argv = ["--protocol", "pbft", "--n", str(entry["config"]["n"]),
            "--sim-ms", str(entry["config"]["sim_ms"])]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        line = _cli(argv + ["--profile", d])
        wall = time.perf_counter() - t0
        doc = json.loads((pathlib.Path(d) / "trace.json").read_text())
    events = doc["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ring = [e for e in kernels if "ring_push" in e.get("name", "")]
    metrics = {k: v for k, v in line.items()
               if k not in ("manifest", "profile_dir", "profiled_run_s",
                            "compile_plus_first_run_s")}
    if metrics != entry["metrics"]:
        raise AssertionError(f"profile: metrics differ from the JAX golden:\n{metrics}")
    _check_manifest(line, "profile")
    ticks = entry["config"]["sim_ms"]
    if len(ring) != ticks:
        raise AssertionError(f"profile: {len(ring)} ring_push kernel events in the trace, "
                             f"want one a tick ({ticks})")
    print(f"profile on {card}: {' '.join(argv)} --profile: wall {wall:.3f} s (the profiled "
          f"run {line['profiled_run_s']:.3f} s, the first {line['compile_plus_first_run_s']:.3f}"
          f" s); the Chrome trace holds {len(events)} events, {len(kernels)} kernels, "
          f"{len(ring)} of them ring_push ({ring[0]['name']}); metrics equal the JAX golden",
          flush=True)
    return dict(wall_s=wall, profiled_run_s=line["profiled_run_s"], events=len(events),
                kernel_events=len(kernels), ring_push_events=len(ring))


def phase_entry(card: str):
    """One subprocess, ``python -m blockchain_simulator_tpu_torch --protocol
    pbft --n 8 --sim-ms 600 --timing``: exit 0, the manifest names the card,
    the metrics equal the JAX golden's."""
    import os

    import torch

    entry = json.loads(TRACE_GOLDEN.read_text())["entries"]["entry"]
    env = dict(os.environ, PYTHONPATH=str(HERE))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "blockchain_simulator_tpu_torch",
                           *entry["argv"]], capture_output=True, text=True, cwd=HERE,
                          env=env, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"entry: exit {proc.returncode}:\n{proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    timing = ("wallclock_s", "compile_plus_first_run_s", "ticks", "manifest")
    metrics = {k: v for k, v in line.items() if k not in timing}
    if metrics != entry["metrics"] or line["ticks"] != entry["config"]["sim_ms"]:
        raise AssertionError(f"entry: metrics differ from the JAX golden:\n{metrics}")
    man = line["manifest"]
    if (man.get("backend"), man.get("device")) != ("cuda", torch.cuda.get_device_name(0)):
        raise AssertionError(f"entry: the manifest {man} does not name the card")
    print(f"entry on {card}: python -m blockchain_simulator_tpu_torch "
          f"{' '.join(entry['argv'])}: exit 0 in {wall:.3f} s (the process), the run "
          f"{line['wallclock_s']:.4f} s after a first run of "
          f"{line['compile_plus_first_run_s']:.3f} s, manifest {man['device']} x "
          f"{man['device_count']} torch {man['torch']} cuda {man['cuda']}, metrics equal "
          f"the JAX golden", flush=True)
    return dict(wall_s=wall, run_s=line["wallclock_s"],
                first_run_s=line["compile_plus_first_run_s"])


def _read_lines(stream, lines: list, ready: "threading.Event"):
    """Collect a subprocess's stdout lines; flag the READY line."""
    for line in stream:
        lines.append(line.rstrip("\n"))
        if line.startswith("READY "):
            ready.set()
    ready.set()  # the stream closed: the daemon exited


def _http(base: str, path: str, obj=None, method=None):
    """``(status, body bytes, seconds)`` of one HTTP call."""
    import urllib.error
    import urllib.request

    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read(), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read(), time.perf_counter() - t0


def start_serve_daemon(d: str) -> dict:
    """Start the README's daemon, ``python -m blockchain_simulator_tpu_torch.
    serve --port 0 --max-batch 8 --max-wait-ms 50 --prewarm <the n = 1024
    request>``, with its run log and stderr in ``d``; a thread collects its
    stdout.  Returns what :func:`phase_serve_http` drives."""
    import os
    import threading

    tpl = json.loads(SERVE_GOLDEN.read_text())["entries"]["serve_http"]["template"]
    runs = os.path.join(d, "runs.jsonl")
    env = dict(os.environ, PYTHONPATH=str(HERE), BLOCKSIM_RUNS_JSONL=runs)
    argv = [sys.executable, "-m", "blockchain_simulator_tpu_torch.serve", "--port", "0",
            "--max-batch", "8", "--max-wait-ms", "50", "--prewarm", json.dumps(tpl)]
    err = open(os.path.join(d, "stderr.txt"), "w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=err, text=True, cwd=HERE,
                            env=env)
    lines: list = []
    ready = threading.Event()
    threading.Thread(target=_read_lines, args=(proc.stdout, lines, ready), daemon=True).start()
    return {"proc": proc, "lines": lines, "ready": ready, "err": err, "runs": runs, "t0": t0}


def phase_serve_http(card: str, daemon: dict):
    """The README's daemon on the card (started by :func:`start_serve_daemon`):
    its READY line; a health pause (503), then resume; 15 requests from 8
    threads, each answer 200 and equal to the JAX server's
    (golden/serve_s0.json); /stats shows a batch of more than one and no
    registry miss after the prewarm; 422 and 400; /metrics; /shutdown exits
    0; every access-log line names the card and carries the cache and
    telemetry blocks."""
    import concurrent.futures

    import torch

    entry = json.loads(SERVE_GOLDEN.read_text())["entries"]["serve_http"]
    tpl, want = entry["template"], entry["metrics"]
    reqs = [dict(tpl, id=f"f{f}-s{s}", seed=s, faults={"n_byzantine": f})
            for f in entry["f_values"] for s in entry["seeds"]]
    if sorted(r["id"] for r in reqs) != sorted(want):
        raise AssertionError("serve-http: the golden's requests are not the phase's")
    name = torch.cuda.get_device_name(0)
    proc, lines, err, t0 = daemon["proc"], daemon["lines"], daemon["err"], daemon["t0"]
    if not daemon["ready"].wait(300) or not any(x.startswith("READY ") for x in lines):
        err.seek(0)
        raise AssertionError(f"serve-http: no READY line (exit {proc.poll()}):\n"
                             f"{lines}\n{err.read()[-3000:]}")
    t1 = time.perf_counter()
    ready_s = t1 - t0
    info = json.loads(next(x for x in lines if x.startswith("READY "))[6:])
    prewarm = next((json.loads(x)["prewarm_s"] for x in lines if '"prewarm_s"' in x), None)
    if prewarm is None:
        raise AssertionError(f"serve-http: the prewarm failed: {lines}")
    base = f"http://127.0.0.1:{info['port']}"
    st0 = json.loads(_http(base, "/stats")[1])
    _http(base, "/health", {"verdict": "sick"})
    code, body, _ = _http(base, "/scenario", dict(reqs[0], id="paused"))
    if (code, json.loads(body).get("kind")) != (503, "admission-paused"):
        raise AssertionError(f"serve-http: paused request answered {code} {body!r}")
    _http(base, "/health", {"verdict": "healthy"})
    t2 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(SERVE_THREADS) as pool:
        outs = list(pool.map(lambda r: _http(base, "/scenario", r), reqs))
    burst_s = time.perf_counter() - t2
    bodies = {}
    for r, (code, body, _) in zip(reqs, outs):
        b = json.loads(body)
        if code != 200 or b.get("status") != "ok":
            raise AssertionError(f"serve-http: {r['id']} answered {code} after the resume: {b}")
        bodies[r["id"]] = b
    bad = sorted(k for k, b in bodies.items() if b["metrics"] != want[k])
    if bad:
        raise AssertionError(f"serve-http: answers {bad} differ from the JAX golden:\n"
                             f"{bodies[bad[0]]['metrics']}\n{want[bad[0]]}")
    st1 = json.loads(_http(base, "/stats")[1])
    occupancy = st1["occupancy"]
    if not any(int(k) > 1 for k in occupancy):
        raise AssertionError(f"serve-http: no batch of more than one: {occupancy}")
    misses = st1["cache"]["misses"] - st0["cache"]["misses"]
    if misses != 0:
        raise AssertionError(f"serve-http: {misses} registry misses after the prewarm")
    code, body, _ = _http(base, "/scenario", dict(tpl, protocol="mixed", n=32, mixed_shards=4))
    if (code, json.loads(body).get("kind")) != (422, "unbatchable-config"):
        raise AssertionError(f"serve-http: mixed request answered {code} {body!r}")
    code, body, _ = _http(base, "/scenario", dict(tpl, n=-1))
    if code != 400:
        raise AssertionError(f"serve-http: n = -1 answered {code} {body!r}")
    code, text, _ = _http(base, "/metrics")
    if code != 200 or b"blocksim_serve_answered_total" not in text:
        raise AssertionError("serve-http: /metrics lacks blocksim_serve_answered_total")
    _http(base, "/shutdown", {})
    rc = proc.wait(timeout=120)
    if rc != 0:
        raise AssertionError(f"serve-http: the daemon exited {rc} after /shutdown")
    wall = time.perf_counter() - t1
    log = [json.loads(x) for x in open(daemon["runs"]) if x.strip()]
    for rec in log:
        man = rec.get("manifest", {})
        if (man.get("backend"), man.get("device")) != ("cuda", name) \
                or "cache" not in man or "telemetry" not in man:
            raise AssertionError(f"serve-http: an access-log line lacks the card or its "
                                 f"blocks: {man}")
    client_ms = sorted(1000.0 * o[2] for o in outs)
    server_ms = sorted(b["latency_ms"] for b in bodies.values())
    n = len(reqs)
    p50 = client_ms[n // 2]
    print(f"serve-http on {card}: the daemon READY {ready_s:.3f} s after its start (torch "
          f"import, CUDA init, the prewarm's registry builds {prewarm} s; started beside "
          f"serve-tick); one closed burst of {n} requests from {SERVE_THREADS} threads in "
          f"{burst_s:.3f} s ({n / burst_s:.2f} req/s), client latency over those {n}: median "
          f"{p50:.1f} ms, max {client_ms[-1]:.1f} ms, server median {server_ms[n // 2]:.1f} ms; "
          f"occupancy {occupancy}, registry misses after the prewarm {misses}; answers equal "
          f"the JAX server's; 503 while paused, 422, 400; {len(log)} access-log lines name the "
          f"card; /shutdown exit 0; wall after READY {wall:.3f} s", flush=True)
    return {"wall_s": wall, "ready_s": ready_s, "prewarm_s": prewarm, "burst_s": burst_s,
            "requests": n, "client_p50_ms": p50, "client_max_ms": client_ms[-1],
            "server_p50_ms": server_ms[n // 2], "occupancy": occupancy,
            "registry_misses_after_prewarm": misses, "access_log_lines": len(log)}


def phase_serve_config4(dev, card: str, config4_wall: float):
    """BASELINE config 4 served: ``ScenarioServer(max_batch=12)`` built with
    ``start=False``, the golden's twelve points submitted in its lane order
    (f-major, seed-minor, as run_byzantine_sweep builds them), then
    ``start()``: one batched flush of 12, every answer the golden's row."""
    import torch

    from blockchain_simulator_tpu_torch.serve import ScenarioServer

    entry = json.loads(CONFIG4_GOLDEN.read_text())["entries"]["config4"]
    f_values, seeds = entry["args"]["f_values"], entry["args"]["seeds"]
    rows = {(r["f"], r["seed"]): {k: v for k, v in r.items() if k not in ("f", "seed")}
            for r in entry["rows"]}
    reqs = [dict(entry["config"], id=f"f{f}-s{s}", seed=s,
                 faults={"n_byzantine": f, "byz_forge": entry["args"]["forge"]})
            for f in f_values for s in seeds]
    srv = ScenarioServer(max_batch=len(reqs), max_wait_ms=1.0, default_timeout_s=600.0,
                         start=False, device=dev)
    try:
        pends = [srv.submit(r) for r in reqs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.start()
        resps = [p.result(600) for p in pends]
        wall = time.perf_counter() - t0
        stats = srv.stats()
    finally:
        srv.close()
    for r, resp in zip(reqs, resps):
        if resp.get("status") != "ok" or resp["batch"]["mode"] != "batched" \
                or resp["batch"]["padded"] != len(reqs):
            raise AssertionError(f"serve-config4: {r['id']} answered {resp}")
        if resp["metrics"] != rows[(r["faults"]["n_byzantine"], r["seed"])]:
            raise AssertionError(f"serve-config4: {r['id']} differs from the golden row:\n"
                                 f"{resp['metrics']}")
    if stats["occupancy"] != {str(len(reqs)): 1} or stats["batches"] != 1:
        raise AssertionError(f"serve-config4: not one flush of {len(reqs)}: {stats['occupancy']}")
    print(f"serve-config4 on {card}: {len(reqs)} requests (config 4's points in the golden's "
          f"lane order) in one batched flush of {len(reqs)}: wall {wall:.3f} s from start() "
          f"to the last answer, against phase config4's run_byzantine_sweep {config4_wall:.3f} "
          f"s in this run (difference {wall - config4_wall:+.3f} s, one run of each: "
          f"within their run-to-run spread); occupancy "
          f"{stats['occupancy']}; every answer equals the golden row", flush=True)
    return {"wall_s": wall, "config4_wall_s": config4_wall,
            "difference_s": wall - config4_wall, "occupancy": stats["occupancy"]}


def phase_serve_tick(dev, card: str):
    """BASELINE config 2 (PBFT, n = 1000, 2,500 ms, defaults) as one request,
    solo through ``serve-solo`` on the card: its answer the JAX server's
    (golden/serve_s0.json), one ring-push launch a tick, the counts set to 0
    just before the request and read just after."""
    import torch

    from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
    from blockchain_simulator_tpu_torch.serve import ScenarioServer
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    entry = json.loads(SERVE_GOLDEN.read_text())["entries"]["serve_tick"]
    ticks = SimConfig(**entry["request"]).ticks
    with ScenarioServer(max_batch=1, max_wait_ms=1.0, default_timeout_s=600.0,
                        device=dev) as srv:
        rk.launches = rk.pushes = 0
        t0 = time.perf_counter()
        resp = srv.request(dict(entry["request"], id="config2"), wait_s=600)
        wall = time.perf_counter() - t0
        launches, pushes = rk.launches, rk.pushes
        misses = srv.stats()["cache"]["misses"]
    if resp.get("status") != "ok" or resp["batch"]["mode"] != "solo":
        raise AssertionError(f"serve-tick: answered {resp}")
    if resp["metrics"] != entry["metrics"]:
        raise AssertionError(f"serve-tick: metrics differ from the JAX server's:\n"
                             f"{resp['metrics']}")
    if (launches, pushes) != (ticks, 4 * ticks):
        raise AssertionError(f"serve-tick: ring_push made {launches} launches and {pushes} "
                             f"pushes, expected {ticks} and {4 * ticks}")
    torch.cuda.synchronize()
    print(f"serve-tick on {card}: config 2 served solo (serve-solo -> make_dyn_sim_fn -> the "
          f"tick loop): wall {wall:.3f} s, server latency {resp['latency_ms']:.1f} ms, "
          f"ring_push launches {launches}, pushes {pushes}; metrics equal the JAX server's "
          f"(registry misses so far {misses})", flush=True)
    return {"wall_s": wall, "launches": launches, "pushes": pushes,
            "latency_ms": resp["latency_ms"]}


def start_health() -> dict:
    """Start ``python -m blockchain_simulator_tpu_torch.utils.health --log ''``
    (a supervising process and its probe child)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(HERE))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "blockchain_simulator_tpu_torch.utils.health",
                             "--log", ""], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=HERE, env=env)
    return {"proc": proc, "t0": t0}


def phase_health(card: str, started: dict):
    """The health CLI started by :func:`start_health`: one JSON line, verdict
    healthy, backend cuda, the card's name."""
    import torch

    proc = started["proc"]
    out, err = proc.communicate(timeout=600)
    wall = time.perf_counter() - started["t0"]
    out = out.strip().splitlines()
    if proc.returncode != 0 or len(out) != 1:
        raise AssertionError(f"health: exit {proc.returncode}, stdout {out}:\n{err[-2000:]}")
    rec = json.loads(out[0])
    if (rec["verdict"], rec["backend"], rec.get("device")) != (
            "healthy", "cuda", torch.cuda.get_device_name(0)):
        raise AssertionError(f"health: {rec}")
    print(f"health on {card}: {rec['verdict']} ({rec['backend']}, {rec['device']} x "
          f"{rec['device_count']}), the probe {rec['probe_s']} s (init {rec['init_s']} s, "
          f"matmul and read-back {rec['compile_run_s']} s), the supervised process "
          f"{wall:.3f} s from its start (beside serve-tick)", flush=True)
    return {"wall_s": wall, "probe_s": rec["probe_s"], "init_s": rec["init_s"]}


def serving_phases(dev, card: str, config4_wall: float) -> dict:
    """serve-config4 alone; then the daemon and the health CLI start, and
    their processes' start (the interpreter, ``import torch``, the CUDA
    context) overlaps serve-tick in this process; then health and serve-http
    are read.  Both processes are stopped on any failure."""
    import tempfile

    served = {"serve_config4": phase_serve_config4(dev, card, config4_wall)}
    with tempfile.TemporaryDirectory() as d:
        daemon = start_serve_daemon(d)
        health = start_health()
        try:
            served["serve_tick"] = phase_serve_tick(dev, card)
            served["health"] = phase_health(card, health)
            served["serve_http"] = phase_serve_http(card, daemon)
        finally:
            for proc in (daemon["proc"], health["proc"]):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            daemon["err"].close()
    return served


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch reports no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    dev = torch.device("cuda", 0)
    warnings.filterwarnings("ignore", message="index_reduce")  # "beta API" notice
    warnings.filterwarnings("ignore", message="Synchronization debug mode")  # "prototype"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    card = _card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    _, log = rk.build()
    print(f"build: ring_push.cu in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in log.strip().splitlines():
        print(f"  nvcc: {line}", flush=True)
    rk.load()

    entry = json.loads(GOLDEN.read_text())["entries"]["n1000"]
    cfg = SimConfig(**entry["config"])
    group, rows, max_err = phase_kernel(cfg, dev)
    launches, pushes, _ = phase_tick(dev, card, GOLDEN, "main path")
    samplers = phase_samplers(dev, card)
    round_path = phase_round(dev, card)
    stat_launches, stat_pushes, stat_wall = phase_tick(dev, card, STAT_GOLDEN,
                                                       "tick-stat path")
    raft_group, raft_err = phase_kernel_raft(dev, card)
    raft_edge = phase_raft_tick(dev, card)
    raft_hb = phase_raft_hb(dev, card)
    q_launches, q_pushes, q_wall = phase_tick(dev, card, QUEUED_GOLDEN, "pbft queued", "n8")
    paxos_group, paxos_err = phase_kernel_paxos(dev, card)
    gossip = {
        "paxos_gossip": phase_gossip(dev, card, PAXOS_GOSSIP_GOLDEN, "n10k", "paxos gossip",
                                     GOSSIP_WINDOW_TICKS),
        "pbft_gossip": phase_gossip(dev, card, PBFT_GOSSIP_GOLDEN, "n1000", "pbft gossip"),
        "raft_gossip": phase_gossip(dev, card, RAFT_GOSSIP_GOLDEN, "n1000", "raft gossip"),
    }
    mixed_group, mixed_err = phase_kernel_mixed(dev, card)
    config5 = phase_mixed_config5(dev, card)
    t_new = time.perf_counter()
    config4 = phase_config4(dev, card, round_path["launches_per_round"])
    drop = phase_drop_sweep(dev, card)
    ckpt = phase_checkpoint(dev, card)
    print(f"sweep and checkpoint phases (config4, drop-sweep, checkpoint): "
          f"{time.perf_counter() - t_new:.3f} s", flush=True)
    t_topo = time.perf_counter()
    topo_groups, topo_err = phase_kernel_topo(dev, card)
    kreg_1m = phase_kreg_1m(dev, card)
    committee = phase_committee_100k(dev, card)
    kreg_rp = phase_kreg_raft_paxos(dev, card)
    kreg_equal = phase_kreg_equal(dev, card)
    print(f"sparse-topology phases (topo-kernel, kreg-1m, committee-100k, kreg-raft-paxos, "
          f"kreg-equal): {time.perf_counter() - t_topo:.3f} s", flush=True)
    t_trace = time.perf_counter()
    traced = {"cli_trace_round": phase_cli_trace_round(dev, card),
              "cli_trace_tick": phase_cli_trace_tick(dev, card),
              "trace_hb": phase_trace_hb(dev, card),
              "trace_mixed": phase_trace_mixed(dev, card),
              "trace_committee": phase_trace_committee(dev, card),
              "profile": phase_profile(dev, card),
              "entry": phase_entry(card)}
    print(f"trace phases on {card}: " + ", ".join(f"{k} {v['wall_s']:.3f} s"
                                                 for k, v in traced.items())
          + f"; together {time.perf_counter() - t_trace:.3f} s", flush=True)
    t_serve = time.perf_counter()
    served = serving_phases(dev, card, config4["wall_s"])
    print(f"serving phases on {card}: " + ", ".join(f"{k} {v['wall_s']:.3f} s"
                                                   for k, v in served.items())
          + f"; together {time.perf_counter() - t_serve:.3f} s", flush=True)
    kernels = [{
        "name": "ring_push",
        "route": "cuda",
        "source": "blockchain_simulator_tpu_torch/csrc/ring_push.cu",
        "replaces": "blockchain_simulator_tpu/ops/ring_kernel.py:136",
        # the keys of earlier slices keep their meaning: PBFT's edge path and
        # one PBFT tick's four pushes (prep_rt, commit, pp, vc) in one launch
        "launches": launches,  # the edge main path's run
        "pushes": pushes,
        "launches_tick_stat": stat_launches,  # the tick-stat path's run
        "pushes_tick_stat": stat_pushes,
        "max_abs_err": max(max_err, raft_err, paxos_err, mixed_err, topo_err),
        "ms": group["ms"],
        "plain_ms": group["plain_ms"],
        "bound_ms": group["bound_ms"],
        "bound_by": "bytes",
        "library_ms": group["library_ms"],  # the four library calls, summed
        "singles_ms": group["singles_ms"],  # the four pushes launched one by one
        "cold_rings_ms": group["cold_rings_ms"],
        "eager_ms": group["eager_ms"],
        "per_push": rows,
        # Raft edge at n = 1000: one Raft tick's seven pushes (vreq [3, N, N]
        # + six [B, N]) in one launch
        "raft_group": dict(raft_group, launches=raft_edge["launches"],
                           pushes=raft_edge["pushes"], bound_by="bytes"),
        # BASELINE config 3: one Paxos tick's six pushes of 50 buckets
        "paxos_group": dict(paxos_group, launches=gossip["paxos_gossip"]["launches"],
                            pushes=gossip["paxos_gossip"]["pushes"]),
        # BASELINE config 5: the Raft shards' group, one member a channel of
        # S*m lanes; its launches and pushes in the config-5 run
        "mixed_group": dict(mixed_group, launches=config5["raft_launches"],
                            pushes=config5["raft_pushes"]),
        # the kreg-1m rung: PBFT's four pushes at n = 10^6 (L = N*W = 8e6)
        "pbft_1m_group": dict(topo_groups["pbft_1m_group"], launches=kreg_1m["launches"],
                              pushes=kreg_1m["pushes"]),
        # Raft over a degree-16 overlay at n = 10^4: vreq [D, N, K]
        "raft_kreg_group": dict(topo_groups["raft_kreg_group"],
                                launches=kreg_rp["raft"]["launches"],
                                pushes=kreg_rp["raft"]["pushes"]),
        "launches_by_path": {"pbft_edge": launches, "pbft_tick_stat": stat_launches,
                             "raft_edge": raft_edge["launches"],
                             "raft_hb": raft_hb["launches"], "pbft_queued": q_launches,
                             **{k: v["launches"] for k, v in gossip.items()},
                             "mixed_config5": config5["launches"],
                             "checkpoint": ckpt["launches"],
                             "checkpoint_resume": ckpt["resume_launches"],
                             "config4": config4["ring_push_launches"],
                             "drop_sweep": drop["ring_push_launches"],
                             "kreg_1m": kreg_1m["launches"],
                             "committee_100k": committee["launches"],
                             **{f"kreg_{k}": v["launches"] for k, v in kreg_rp.items()},
                             **{f"kreg_equal_{k}": v["launches"]
                                for k, v in kreg_equal.items()},
                             "cli_trace_tick": traced["cli_trace_tick"]["launches"],
                             "trace_hb": traced["trace_hb"]["launches"],
                             "trace_mixed": traced["trace_mixed"]["launches"],
                             "trace_committee": traced["trace_committee"]["launches"],
                             "serve_tick": served["serve_tick"]["launches"]},
        "pushes_by_path": {"pbft_edge": pushes, "pbft_tick_stat": stat_pushes,
                           "raft_edge": raft_edge["pushes"], "raft_hb": raft_hb["pushes"],
                           "pbft_queued": q_pushes,
                           **{k: v["pushes"] for k, v in gossip.items()},
                           "mixed_config5": config5["pushes"],
                           "checkpoint": ckpt["pushes"],
                           "checkpoint_resume": ckpt["resume_pushes"],
                           "kreg_1m": kreg_1m["pushes"],
                           "committee_100k": committee["pushes"],
                           **{f"kreg_{k}": v["pushes"] for k, v in kreg_rp.items()},
                           **{f"kreg_equal_{k}": v["pushes"] for k, v in kreg_equal.items()},
                           "cli_trace_tick": traced["cli_trace_tick"]["pushes"],
                           "trace_hb": traced["trace_hb"]["pushes"],
                           "trace_mixed": traced["trace_mixed"]["pushes"],
                           "trace_committee": traced["trace_committee"]["pushes"],
                           "serve_tick": served["serve_tick"]["pushes"]},
    }]
    print(json.dumps({"paths": {"round": round_path, "tick_stat_wall_s": stat_wall,
                                "raft_edge": raft_edge, "raft_hb": raft_hb,
                                "pbft_queued_wall_s": q_wall, "samplers": samplers,
                                **gossip, "mixed_config5": config5, "config4": config4,
                                "drop_sweep": drop, "checkpoint": ckpt,
                                "kreg_1m": kreg_1m, "committee_100k": committee,
                                "kreg_raft_paxos": kreg_rp, "kreg_equal": kreg_equal,
                                **traced, **served}}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
