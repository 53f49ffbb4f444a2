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
6. tick-stat — the PBFT tick engine on the stat arm (n = 1000, 2500 ms,
              "exact" sampler); metrics and digests equal the JAX golden,
              and one ring-push launch of four pushes per tick.

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
STAT_GOLDEN = HERE / "blockchain_simulator_tpu_torch" / "golden" / "pbft_stat_n1000_s0.json"
SAMPLER_N = 1_000_000
PROFILED_ROUNDS = 20
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


def phase_tick(dev, card: str, golden: pathlib.Path, what: str):
    """A tick-engine run at full size (the golden's n1000 entry: the slice-1
    main path on edge delivery, or the stat arm), held to the JAX golden,
    with the ring-push counters set to 0 just before it and read just
    after."""
    import torch

    from blockchain_simulator_tpu_torch import convert, runner
    from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    entry = json.loads(golden.read_text())["entries"]["n1000"]
    cfg = SimConfig(**entry["config"])
    if runner.use_round_schedule(cfg):
        raise AssertionError(f"{what}: the config should run the tick engine")
    rk.launches = rk.pushes = 0
    t0 = time.perf_counter()
    final = runner.final_state(cfg, seed=entry["seed"], device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, pushes = rk.launches, rk.pushes
    metrics = runner.sim_metrics(cfg, final)
    _check_golden(entry, metrics, convert.state_digests(convert.state_to_numpy(final)), what)
    if (launches, pushes) != (cfg.ticks, 4 * cfg.ticks):
        raise AssertionError(f"{what}: ring_push made {launches} launches and {pushes} "
                             f"pushes, expected {cfg.ticks} and {4 * cfg.ticks} (one "
                             f"launch of 4 pushes x {cfg.ticks} ticks)")
    print(f"{what}: pbft n={cfg.n} sim_ms={cfg.sim_ms} {cfg.delivery}: {metrics}", flush=True)
    print(f"{what} on {card}: wall {wall:.3f} s, {cfg.ticks / wall:.1f} ticks/s, "
          f"{metrics['rounds_sent'] / wall:.2f} rounds/s, ring_push launches {launches}, "
          f"pushes {pushes}, metrics + all state digests equal the JAX golden", flush=True)
    return launches, pushes, wall


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

    kernels = [{
        "name": "ring_push",
        "route": "cuda",
        "source": "blockchain_simulator_tpu_torch/csrc/ring_push.cu",
        "replaces": "blockchain_simulator_tpu/ops/ring_kernel.py:136",
        "launches": launches,  # the edge main path's run
        "pushes": pushes,
        "launches_tick_stat": stat_launches,  # the tick-stat path's run
        "pushes_tick_stat": stat_pushes,
        "max_abs_err": max_err,
        # one tick's four pushes (prep_rt, commit, pp, vc) in one launch
        "ms": group["ms"],
        "plain_ms": group["plain_ms"],
        "bound_ms": group["bound_ms"],
        "bound_by": "bytes",
        "library_ms": group["library_ms"],  # the four library calls, summed
        "singles_ms": group["singles_ms"],  # the four pushes launched one by one
        "cold_rings_ms": group["cold_rings_ms"],
        "eager_ms": group["eager_ms"],
        "per_push": rows,
    }]
    print(json.dumps({"paths": {"round": round_path, "tick_stat_wall_s": stat_wall,
                                "samplers": samplers}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
