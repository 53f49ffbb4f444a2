"""The scripted chaos scenarios: one fault class each, invariants after
(port of ``blockchain_simulator_tpu/chaos/scenarios.py``).

Every scenario drives a REAL :class:`~blockchain_simulator_tpu_torch.serve.
server.ScenarioServer` (or the real durable-sweep and query layers) on
``device`` (the CUDA card unless the caller names the CPU) through one
fault class with the chaos points armed, then runs the invariant checker
(chaos/invariants.py) over the client ledger, the server's quiescent
stats, the scenario's own runs.jsonl access log and the registry
counters.  :func:`run_scenario` wraps a scenario with its seeded
controller, a private access log, and the registry bracketing — and
returns a **normalized summary**: only deterministic fields (outcome kinds
per request id, terminal counters, the fired chaos schedule, violations),
no latencies or timestamps, so a same-seed double run must give
``summary1 == summary2`` byte-for-byte, and the summary equals the JAX
package's for the same scenario and seed.

Scenario catalog:

- ``dispatch-fail``   batched dispatch raises → degrade-to-solo, breaker
  opens after the threshold, solo-only mode, half-open probe re-closes;
- ``dispatch-hang``   batched dispatch hangs/slows → queued requests
  behind the hang expire into typed 504s, slow traffic still answers;
- ``cache-corrupt``   refused in the port: it bit-flips an on-disk
  executable cache entry, and the port builds no on-disk layer
  (ROADMAP.md B-later item 1);
- ``health-flap``     a seed-driven sick/healthy verdict pattern →
  admission 503s exactly while sick, serves exactly while healthy;
- ``batcher-kill``    the batcher thread dies mid-loop → the supervisor
  restarts it (backoff), the grouped requests still answer;
- ``queue-storm``     a burst beyond ``max_queue`` → typed 429s with
  manifests for the overflow, the admitted backlog drains served;
- ``poison-request``  one request fails batched AND solo → typed
  ``dispatch-failed``, quarantined, resubmission never joins a batch;
- ``crash-restart``   admitted requests outlive a dead server via the
  WAL: replayed exactly once per pending id, answers bit-equal (exact
  sampler) to the uninterrupted reference, second restart replays zero;
- ``sweep-kill9``     a journaled fault sweep dies mid-grid → rerunning
  it resumes from the sweep journal (parallel/journal.py): completed
  chunks never recompute, rows bit-equal to the uninterrupted sweep;
- ``sweep-wedge``     a chunk's dispatch wedges → the supervisor's
  deadline fires, bounded retries, then the recorded degrade arm
  answers — the journal carries the whole transition trail;
- ``query-kill9``     a replica dies mid-adaptive-search (query/) with
  the admission WAL-durable and two generations journaled → a restart
  replays the query, serves every completed generation from the journal
  (0 recomputed steps) and re-answers bit-equal to an uninterrupted
  reference.

All scenarios run at toy scale (pbft n=8, exact sampler: :data:`TPL`, the
JAX package's template), on the tick engine that launches the ring kernel
on the card.  Two clocks are the port's own, because an n = 8 dispatch of
the port takes ~0.4 s on one CPU thread where a warm XLA executable takes
milliseconds: ``dispatch-fail``'s breaker cooldown
(:data:`BREAKER_COOLDOWN_S`, JAX 2.0 s) and ``sweep-wedge``'s supervisor
deadline and hang (:data:`WEDGE_DEADLINE_S`, :data:`WEDGE_HANG_S`, JAX 1.0
and 2.0 s).  Each keeps JAX's ordering margins against the port's
dispatch; no summary field carries them.
"""

from __future__ import annotations

import os
import tempfile
import time

from blockchain_simulator_tpu_torch.chaos import inject, invariants
from blockchain_simulator_tpu_torch.utils import aotcache, obs

# the JAX package's shared template: every scenario batches on this
# canonical structure, so one set of registry entries serves the drill
TPL = {"protocol": "pbft", "n": 8, "sim_ms": 200, "stat_sampler": "exact"}

# the port's clocks (module docstring): each dwarfs the dispatches it
# must outlast by JAX's own ratio or more
BREAKER_COOLDOWN_S = 4.0   # > pair 2's two solo runs + pair 3's arrival
WEDGE_DEADLINE_S = 3.0     # > a warm two-lane chunk (~0.9 s on the CPU)
WEDGE_HANG_S = 6.0         # = 2 x the deadline, JAX's ratio

# terminal counters that are deterministic under a scripted scenario
# (batches/occupancy are timing-shaped and deliberately excluded)
_COUNT_KEYS = ("received", "served", "errors", "timeouts", "replayed",
               "quarantined", "batcher_restarts")


def _norm(metrics: dict) -> dict:
    return {k: str(v) for k, v in metrics.items()}


def _counts(stats: dict) -> dict:
    rec = {k: stats.get(k, 0) for k in _COUNT_KEYS}
    rec["rejected"] = dict(sorted((stats.get("rejected") or {}).items()))
    return rec


def _submit(srv, ledger, obj, wait_s=300.0):
    """Submit one request, record its terminal outcome in the ledger,
    return the response body (typed rejections included)."""
    req_id = obj.get("id")
    ledger.submitted(req_id)
    resp = srv.request(obj, wait_s=wait_s)
    ledger.record(req_id, resp)
    return resp


# ------------------------------------------------------------- scenarios ---


def scenario_dispatch_fail(ctl, workdir, quick, device):
    """Batched dispatch raises N times: every request still answers (the
    degrade path), the group's breaker opens at the threshold, solo-only
    mode serves, and the half-open probe re-closes the breaker."""
    from blockchain_simulator_tpu_torch.serve import ScenarioServer

    ctl.fail_next("sweep.dyn_dispatch", n=2)
    ledger = invariants.Ledger()
    modes = []
    # the cooldown is generous vs the warm inter-pair gap (~ms) so pair 3
    # deterministically lands while the breaker is still open, and the
    # explicit sleep before pair 4 deterministically lands after it
    with ScenarioServer(max_batch=2, max_wait_ms=2000.0,
                        breaker_threshold=2,
                        breaker_cooldown_s=BREAKER_COOLDOWN_S,
                        device=device) as srv:
        for i in range(4):
            if i == 3:
                # past the cooldown: the half-open probe
                time.sleep(BREAKER_COOLDOWN_S + 0.5)
            a = srv.submit(dict(TPL, seed=10 + i, id=f"a{i}"))
            b = srv.submit(dict(TPL, seed=20 + i, id=f"b{i}",
                                faults={"n_byzantine": 1}))
            ledger.submitted(f"a{i}")
            ledger.submitted(f"b{i}")
            ra, rb = a.result(300), b.result(300)
            ledger.record(f"a{i}", ra)
            ledger.record(f"b{i}", rb)
            modes.append(ra.get("batch", {}).get("mode"))
        breaker_states = [br["state"]
                          for br in srv.stats()["breakers"].values()]
        stats = srv.stats()
    violations = []
    if modes != ["degraded-solo", "degraded-solo", "breaker-solo",
                 "batched"]:
        violations.append(f"breaker mode trajectory wrong: {modes}")
    if breaker_states != ["closed"]:
        violations.append(f"breaker did not re-close: {breaker_states}")
    return {"ledger": ledger, "stats": stats, "violations": violations,
            "extra": {"modes": modes, "breaker_states": breaker_states}}


def scenario_dispatch_hang(ctl, workdir, quick, device):
    """Batched dispatch hangs longer than the victims' timeouts: the pair
    in the hung flush still answers, the requests stuck behind it expire
    into typed 504s, and a merely-slow dispatch afterwards answers ok."""
    from blockchain_simulator_tpu_torch.serve import ScenarioServer

    hang_s = 1.2
    ctl.hang_next("sweep.dyn_dispatch", hang_s)
    ctl.slow_next("sweep.dyn_dispatch", 0.05)
    ledger = invariants.Ledger()
    with ScenarioServer(max_batch=2, max_wait_ms=2000.0,
                        device=device) as srv:
        a = srv.submit(dict(TPL, seed=1, id="hung-a"))
        b = srv.submit(dict(TPL, seed=2, id="hung-b"))
        ledger.submitted("hung-a")
        ledger.submitted("hung-b")
        time.sleep(0.4)  # the pair is now inside the hanging dispatch
        c = srv.submit(dict(TPL, seed=3, id="stuck-c", timeout_s=0.2))
        d = srv.submit(dict(TPL, seed=4, id="stuck-d", timeout_s=0.2))
        ledger.submitted("stuck-c")
        ledger.submitted("stuck-d")
        for rid, fut in (("hung-a", a), ("hung-b", b),
                         ("stuck-c", c), ("stuck-d", d)):
            ledger.record(rid, fut.result(300))
        # a merely-SLOW batched dispatch (the second armed action) still
        # answers: submit as a pair so the batched path actually runs
        e = srv.submit(dict(TPL, seed=5, id="slow-e"))
        f = srv.submit(dict(TPL, seed=6, id="slow-f"))
        ledger.submitted("slow-e")
        ledger.submitted("slow-f")
        ledger.record("slow-e", e.result(300))
        ledger.record("slow-f", f.result(300))
        stats = srv.stats()
    violations = []
    want = {"hung-a": ["ok"], "hung-b": ["ok"],
            "stuck-c": ["timeout"], "stuck-d": ["timeout"],
            "slow-e": ["ok"], "slow-f": ["ok"]}
    if ledger.kinds() != want:
        violations.append(f"hang outcomes wrong: {ledger.kinds()}")
    return {"ledger": ledger, "stats": stats, "violations": violations,
            "extra": {"hang_s": hang_s}}


def scenario_cache_corrupt(ctl, workdir, quick, device):
    """Refused: the JAX scenario bit-flips a persistent-cache entry on disk
    and checks the checksum self-heal; the port's registry keeps closures
    in memory only (utils/aotcache.py).  The name stays in SCENARIOS."""
    raise NotImplementedError(
        "the cache-corrupt scenario bit-flips an on-disk executable cache "
        "entry, and the port builds no on-disk layer: it comes with ROADMAP.md "
        "B-later item 1 (aotcache's on-disk layer, with the CUDA-graph work)")


def scenario_health_flap(ctl, workdir, quick, device):
    """A seed-driven sick/healthy flap pattern: submissions 503 exactly
    while the verdict is bad and serve exactly while it is good — the
    gate never loses a request either way."""
    from blockchain_simulator_tpu_torch.serve import ScenarioServer

    pattern = [ctl.rng.random() < 0.5 for _ in range(8)]
    ledger = invariants.Ledger()
    got = []
    with ScenarioServer(max_batch=2, max_wait_ms=5.0,
                        device=device) as srv:
        for i, sick in enumerate(pattern):
            srv.set_health("sick" if sick else "healthy")
            resp = _submit(srv, ledger, dict(TPL, seed=30 + i, id=f"h{i}"))
            got.append(resp.get("kind") if resp.get("status") == "error"
                       else "ok")
        srv.set_health("healthy")
        stats = srv.stats()
    want = ["admission-paused" if sick else "ok" for sick in pattern]
    violations = []
    if got != want:
        violations.append(f"flap outcomes {got} != verdict pattern {want}")
    return {"ledger": ledger, "stats": stats, "violations": violations,
            "extra": {"pattern": ["sick" if s else "healthy"
                                  for s in pattern]}}


def scenario_batcher_kill(ctl, workdir, quick, device):
    """The batcher thread dies mid-loop (ChaosKill escapes the flush
    guard): the supervisor restarts it with backoff and the requests the
    dead thread had already grouped still answer."""
    from blockchain_simulator_tpu_torch.serve import ScenarioServer

    ctl.kill_next("serve.batcher", n=1)
    ledger = invariants.Ledger()
    with ScenarioServer(max_batch=2, max_wait_ms=2000.0,
                        device=device) as srv:
        a = srv.submit(dict(TPL, seed=1, id="k0"))
        b = srv.submit(dict(TPL, seed=2, id="k1"))
        ledger.submitted("k0")
        ledger.submitted("k1")
        ledger.record("k0", a.result(300))
        ledger.record("k1", b.result(300))
        _submit(srv, ledger, dict(TPL, seed=3, id="k2"))
        stats = srv.stats()
    violations = []
    if stats["batcher_restarts"] != 1:
        violations.append(
            f"batcher_restarts {stats['batcher_restarts']} != 1")
    if any(k != ["ok"] for k in ledger.kinds().values()):
        violations.append(f"kill outcomes wrong: {ledger.kinds()}")
    return {"ledger": ledger, "stats": stats, "violations": violations,
            "extra": {}}


def scenario_queue_storm(ctl, workdir, quick, device):
    """A submission burst beyond ``max_queue`` with the batcher held:
    exactly ``max_queue`` admit, the overflow 429s (each with its
    manifest line), and starting the batcher drains the backlog served."""
    from blockchain_simulator_tpu_torch.serve import ScenarioServer

    max_queue = 3 if quick else 6
    burst = max_queue + (3 if quick else 5)
    ledger = invariants.Ledger()
    pendings = {}
    srv = ScenarioServer(max_batch=2, max_wait_ms=5.0,
                         max_queue=max_queue, start=False,
                         device=device)
    try:
        from blockchain_simulator_tpu_torch.serve import schema as serve_schema

        for i in range(burst):
            rid = f"s{i}"
            ledger.submitted(rid)
            try:
                pendings[rid] = srv.submit(dict(TPL, seed=40 + i, id=rid))
            except serve_schema.ServeError as e:
                ledger.record_error(rid, e)
        srv.start()  # the storm passed: drain the admitted backlog
        for rid, fut in pendings.items():
            ledger.record(rid, fut.result(300))
        stats = srv.stats()
    finally:
        srv.close()
    kinds = ledger.kinds()
    n_ok = sum(k == ["ok"] for k in kinds.values())
    n_429 = sum(k == ["queue-full"] for k in kinds.values())
    violations = []
    if n_ok != max_queue or n_429 != burst - max_queue:
        violations.append(
            f"storm split wrong: {n_ok} served / {n_429} rejected "
            f"(queue {max_queue}, burst {burst})")
    return {"ledger": ledger, "stats": stats, "violations": violations,
            "extra": {"max_queue": max_queue, "burst": burst}}


def scenario_poison_request(ctl, workdir, quick, device):
    """One request fails batched AND solo (poison): its peer still
    answers, the poison id lands in quarantine with a typed
    ``dispatch-failed``, and a resubmission of the same id never joins a
    batch again (singleton quarantined flush) while fresh peers batch."""
    from blockchain_simulator_tpu_torch.serve import ScenarioServer

    ctl.fail_next("sweep.dyn_dispatch", n=1)
    ctl.poison("serve.solo_dispatch", "poison-1")
    ledger = invariants.Ledger()
    with ScenarioServer(max_batch=2, max_wait_ms=2000.0,
                        device=device) as srv:
        p = srv.submit(dict(TPL, seed=1, id="poison-1"))
        q = srv.submit(dict(TPL, seed=2, id="peer-1"))
        ledger.submitted("poison-1")
        ledger.submitted("peer-1")
        rp, rq = p.result(300), q.result(300)
        ledger.record("poison-1", rp)
        ledger.record("peer-1", rq)
        # resubmit the poison with healthy peers in flight: the peers
        # must batch with each other, never with the quarantined id
        p2 = srv.submit(dict(TPL, seed=3, id="poison-1"))
        a = srv.submit(dict(TPL, seed=4, id="peer-2"))
        b = srv.submit(dict(TPL, seed=5, id="peer-3",
                            faults={"n_byzantine": 1}))
        for rid in ("poison-1", "peer-2", "peer-3"):
            ledger.submitted(rid)
        rp2, ra, rb = p2.result(300), a.result(300), b.result(300)
        ledger.record("poison-1", rp2)
        ledger.record("peer-2", ra)
        ledger.record("peer-3", rb)
        stats = srv.stats()
    violations = []
    if rp.get("kind") != "dispatch-failed" \
            or rp2.get("kind") != "dispatch-failed":
        violations.append("poison did not fail with dispatch-failed")
    if rq.get("batch", {}).get("mode") != "degraded-solo":
        violations.append(f"peer not degraded-solo: {rq.get('batch')}")
    if ra.get("batch", {}).get("mode") != "batched" \
            or rb.get("batch", {}).get("mode") != "batched":
        violations.append("fresh peers failed to batch around quarantine")
    if stats["quarantined"] != 1 or stats["quarantine_size"] != 1:
        violations.append(
            f"quarantine counters wrong: {stats['quarantined']}, "
            f"{stats['quarantine_size']}")
    return {"ledger": ledger, "stats": stats, "violations": violations,
            "extra": {"peer_modes": [rq["batch"]["mode"],
                                     ra["batch"]["mode"],
                                     rb["batch"]["mode"]]}}


def scenario_crash_restart(ctl, workdir, quick, device):
    """The WAL drill, in-process: a server answers some requests and dies
    (abandoned, never closed) with more admitted; a restarted server on
    the same WAL replays exactly the pending ids, each answer bit-equal
    (exact sampler) to a solo reference run; a THIRD restart replays
    nothing."""
    from blockchain_simulator_tpu_torch import runner
    from blockchain_simulator_tpu_torch.serve import ScenarioServer
    from blockchain_simulator_tpu_torch.utils.config import FaultConfig, SimConfig

    wal = os.path.join(workdir, "serve_wal.jsonl")
    ledger = invariants.Ledger()
    # phase 1: live traffic, answered and journaled done
    with ScenarioServer(max_batch=2, max_wait_ms=5.0, wal_path=wal,
                        device=device) as srv:
        _submit(srv, ledger, dict(TPL, seed=50, id="live-0"))
        _submit(srv, ledger, dict(TPL, seed=51, id="live-1"))
    # phase 2: admitted but never answered — the batcher never runs and
    # the server is abandoned without close(): a process death stand-in
    crashed = ScenarioServer(max_batch=2, max_wait_ms=5.0, wal_path=wal,
                             start=False, device=device)
    crash_points = [
        ("crash-0", dict(TPL, seed=60, id="crash-0")),
        ("crash-1", dict(TPL, seed=61, id="crash-1",
                         faults={"n_byzantine": 1})),
        ("crash-2", dict(TPL, seed=62, id="crash-2",
                         faults={"n_crashed": 1})),
    ]
    for _, obj in crash_points:
        crashed.submit(obj)
    crashed._wal.close()  # the admits are fsynced; drop the handle
    del crashed
    # phase 3: restart replays exactly the pending ids
    srv2 = ScenarioServer(max_batch=2, max_wait_ms=5.0, wal_path=wal,
                          device=device)
    t0 = time.monotonic()
    while srv2.stats()["queue_depth"] and time.monotonic() - t0 < 120:
        time.sleep(0.02)
    stats = srv2.stats()
    srv2.close()
    violations = []
    if stats["replayed"] != len(crash_points):
        violations.append(
            f"replayed {stats['replayed']} != {len(crash_points)} pending")
    # bit-equality: each replayed access-log answer vs a solo static run
    log = os.environ.get(obs.RUNS_ENV)
    recs = obs.read_jsonl(log) if log else []
    replay_recs = {r.get("id"): r for r in recs if r.get("replayed") is True}
    divergence = 0
    for rid, obj in crash_points:
        rec = replay_recs.get(rid)
        if rec is None or rec.get("status") != "ok":
            violations.append(f"replay of {rid!r} missing or failed: "
                              f"{None if rec is None else rec.get('kind')}")
            divergence += 1
            continue
        kw = {k: v for k, v in obj.items()
              if k not in ("id", "seed", "faults")}
        cfg = SimConfig(**kw, faults=FaultConfig(**obj.get("faults", {})))
        ref = runner.run_simulation(cfg, seed=obj["seed"], device=device)
        if _norm(rec["metrics"]) != _norm(ref):
            violations.append(f"replay of {rid!r} diverged from the "
                              f"uninterrupted reference")
            divergence += 1
    # phase 4: idempotence — a second restart has nothing to replay
    srv3 = ScenarioServer(max_batch=2, max_wait_ms=5.0, wal_path=wal,
                          device=device)
    replay_again = srv3.stats()["replayed"]
    srv3.close()
    if replay_again != 0:
        violations.append(
            f"second restart replayed {replay_again} ids (want 0)")
    return {"ledger": ledger, "stats": stats, "violations": violations,
            "replayed_ids": [rid for rid, _ in crash_points],
            # the crashed server died holding these admissions: the
            # telemetry conservation check (invariants.check_telemetry)
            # must see the balance off by exactly this many
            "lost_admissions": len(crash_points),
            "extra": {"replay_divergence": divergence,
                      "replayed": stats["replayed"],
                      "replay_again": replay_again}}


def _canon_rows(res) -> dict:
    """``run_fault_sweep`` result -> {fault level: [canonical-JSON rows]}:
    the bit-equality comparison for journaled sweeps.  Canonical JSON on
    BOTH sides because resumed rows ride a JSON round trip (ints/floats
    are repr-exact; container types normalize) — the honest equality for
    rows that crossed a file."""
    return {
        fc.n_byzantine: [obs.canonical_json(m) for m in rows]
        for fc, rows in res.items()
    }


def scenario_sweep_kill9(ctl, workdir, quick, device):
    """The durable-sweep crash drill, in-process: a journaled fault sweep
    dies (ChaosKill at the ``sweep.chunk`` point) with 2 of 4 level
    chunks journaled; rerunning the SAME sweep on the same journal
    resumes — completed chunks are never recomputed (their keys stay
    unique in the journal, registry misses move 0), only the missing
    levels dispatch, and every row is bit-equal to an un-journaled
    reference sweep."""
    from blockchain_simulator_tpu_torch.parallel import journal as journal_mod
    from blockchain_simulator_tpu_torch.parallel.sweep import (
        dyn_chunk_keys,
        run_fault_sweep,
    )
    from blockchain_simulator_tpu_torch.utils.config import FaultConfig, SimConfig

    cfg = SimConfig(**TPL)
    fcs = [FaultConfig(n_byzantine=f) for f in range(4)]
    seeds = (0, 1)
    jp = os.path.join(workdir, "sweep.journal")
    kill_index = 2
    ctl.fail_next("sweep.chunk", n=1, exc=inject.ChaosKill,
                  match=lambda c: c.get("index") == kill_index)
    violations = []
    killed = False
    try:
        run_fault_sweep(cfg, fcs, seeds,
                        journal=journal_mod.SweepJournal(jp), device=device)
    except inject.ChaosKill:
        killed = True
    if not killed:
        violations.append("chaos kill at chunk 2 never fired")
    pre_keys = set(journal_mod.SweepJournal(jp).completed())
    if len(pre_keys) != kill_index:
        violations.append(
            f"{len(pre_keys)} chunks survived the kill, want {kill_index}")
    # resume: the same sweep call on the same journal path
    misses_before = aotcache.registry.stats()["misses"]
    resumed = run_fault_sweep(cfg, fcs, seeds,
                              journal=journal_mod.SweepJournal(jp),
                              device=device)
    resume_misses = aotcache.registry.stats()["misses"] - misses_before
    if resume_misses != 0:
        violations.append(
            f"resume compiled {resume_misses} executables (want 0: the "
            f"sweep executable was warm)")
    post = journal_mod.SweepJournal(jp)
    post_keys = set(post.completed())
    recomputed = [k for k in pre_keys if k not in post_keys]
    if recomputed:
        violations.append(f"completed chunks vanished on resume: "
                          f"{sorted(recomputed)}")
    appended = len(post_keys) - len(pre_keys)
    if appended != len(fcs) - kill_index:
        violations.append(
            f"resume appended {appended} chunks, want "
            f"{len(fcs) - kill_index} (recompute-at-most-one broken)")
    reference = run_fault_sweep(cfg, fcs, seeds, device=device)
    rows_equal = _canon_rows(resumed) == _canon_rows(reference)
    if not rows_equal:
        violations.append("resumed rows diverge from the uninterrupted "
                          "reference sweep")
    # coverage from the GRID, not the journal's own content: a journal
    # that silently dropped a chunk must fail here
    violations += invariants.check_sweep_journal(
        post, expected_keys=dyn_chunk_keys(cfg, fcs, seeds),
        expected_rows=len(fcs) * len(seeds),
    )
    return {"ledger": None, "stats": None, "violations": violations,
            "extra": {"killed": killed,
                      "chunks_before_kill": len(pre_keys),
                      "chunks_resumed": appended,
                      "resume_misses": resume_misses,
                      "rows_bit_equal": rows_equal}}


def scenario_sweep_wedge(ctl, workdir, quick, device):
    """A chunk's primary dispatch wedges (chaos hang far beyond the
    supervisor deadline, both attempts): the supervisor records
    deadline → retry → deadline → degrade in the journal, the degrade
    arm answers, later chunks dispatch normally, and the whole grid's
    rows are bit-equal to an unsupervised reference — a hung chunk costs
    bounded wall, never the sweep."""
    from blockchain_simulator_tpu_torch.parallel import journal as journal_mod
    from blockchain_simulator_tpu_torch.parallel.sweep import (
        dyn_chunk_keys,
        run_fault_sweep,
    )
    from blockchain_simulator_tpu_torch.utils.config import FaultConfig, SimConfig

    cfg = SimConfig(**TPL)
    fcs = [FaultConfig(n_byzantine=f) for f in range(2)]
    seeds = (0, 1)
    jp = os.path.join(workdir, "sweep.journal")
    # wedge chunk 0's primary arm only: the degrade arm (and chunk 1)
    # must sail through — counted firings keep the schedule exact.  The
    # hang must dwarf the deadline, the deadline must dwarf a warm n=8
    # chunk (the port's clocks, module docstring).
    ctl.hang_next("sweep.chunk", seconds=WEDGE_HANG_S, n=2,
                  match=lambda c: c.get("arm") == "primary"
                  and c.get("index") == 0)
    sup = journal_mod.ChunkSupervisor(deadline_s=WEDGE_DEADLINE_S, retries=1,
                                      backoff_s=0.02, rng=ctl.rng.random)
    j = journal_mod.SweepJournal(jp)
    result = run_fault_sweep(cfg, fcs, seeds, journal=j, supervise=sup,
                             device=device)
    # the two abandoned primary attempts are still sleeping/dispatching:
    # drain them so neither this scenario's determinism twin nor process
    # exit races a zombie mid-dispatch
    journal_mod.drain_abandoned()
    events = [e["event"] for e in j.events()]
    violations = []
    want = ["deadline", "retry", "deadline", "degrade"]
    if events != want:
        violations.append(f"supervisor trail {events} != {want}")
    reference = run_fault_sweep(cfg, fcs, seeds, device=device)
    rows_equal = _canon_rows(result) == _canon_rows(reference)
    if not rows_equal:
        violations.append("degraded rows diverge from the reference sweep")
    post = journal_mod.SweepJournal(jp)
    violations += invariants.check_sweep_journal(
        post, expected_keys=dyn_chunk_keys(cfg, fcs, seeds),
        expected_rows=len(fcs) * len(seeds),
    )
    return {"ledger": None, "stats": None, "violations": violations,
            "extra": {"events": events, "rows_bit_equal": rows_equal}}


def scenario_query_kill9(ctl, workdir, quick, device):
    """The durable-query crash drill, in-process: a replica dies
    (ChaosKill at the ``query.step`` point, the worker's stand-in for
    process death) two refinement generations into an adaptive search,
    with the admission WAL-durable and both generations journaled.  A
    restarted replica on the same WAL + journal replays the query: every
    completed generation is served from the journal (0 recomputed steps —
    their chunk keys stay unique), 0 new executables compile (the search
    executable was warm), and the final answer is bit-equal to an
    uninterrupted reference run of the same query.  A third restart
    replays nothing."""
    from blockchain_simulator_tpu_torch.parallel import journal as journal_mod
    from blockchain_simulator_tpu_torch.query import engine as qengine
    from blockchain_simulator_tpu_torch.query import spec as qspec
    from blockchain_simulator_tpu_torch.serve import ScenarioServer
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    wal = os.path.join(workdir, "query_wal.jsonl")
    jp = os.path.join(workdir, "query.journal")
    # sim_ms=400: long enough that pbft n=8 commits below the cliff, so
    # the search takes 3 generations (endpoints, midpoints, final) — the
    # kill lands on generation 2 with 0 and 1 already durable
    qspec_obj = {"kind": "max_f_surviving", "seeds": [0, 1]}
    qobj = dict(TPL, sim_ms=400, id="q-kill", timeout_s=300.0,
                query=qspec_obj)
    kill_step = 2
    ctl.fail_next("query.step", n=1, exc=inject.ChaosKill,
                  match=lambda c: c.get("step") == kill_step)
    violations = []
    # phase 1: the worker dies mid-search; the server is abandoned
    # (never closed) — the in-process process-death stand-in
    crashed = ScenarioServer(wal_path=wal, journal_path=jp, device=device)
    crashed.submit(qobj)
    t0 = time.monotonic()
    while time.monotonic() - t0 < 120:
        with crashed._lock:
            workers = [t for _, _, t in crashed._queries]
        if workers and not any(t.is_alive() for t in workers):
            break
        time.sleep(0.02)
    else:
        violations.append("query worker never died under the chaos kill")
    crashed._wal.close()  # the admit is fsynced; drop the handles
    crashed._journal.close()
    del crashed
    pre_keys = set(journal_mod.SweepJournal(jp).completed())
    if len(pre_keys) != kill_step:
        violations.append(
            f"{len(pre_keys)} generations survived the kill, want "
            f"{kill_step}")
    # phase 2: restart on the same WAL + journal — the replay re-runs
    # the query, resuming from the journal
    misses_before = aotcache.registry.stats()["misses"]
    srv2 = ScenarioServer(wal_path=wal, journal_path=jp, device=device)
    t0 = time.monotonic()
    # the query leaves the arrivals queue the moment its worker spawns,
    # so quiescence is "the replayed request answered", not queue depth
    while not srv2.stats()["served"] and time.monotonic() - t0 < 120:
        time.sleep(0.02)
    stats = srv2.stats()
    srv2.close()
    resume_misses = aotcache.registry.stats()["misses"] - misses_before
    if resume_misses != 0:
        violations.append(
            f"resume compiled {resume_misses} executables (want 0: the "
            f"search executable was warm)")
    if stats["replayed"] != 1:
        violations.append(f"replayed {stats['replayed']} != 1 pending")
    log = os.environ.get(obs.RUNS_ENV)
    recs = obs.read_jsonl(log) if log else []
    rec = next((r for r in recs if r.get("id") == "q-kill"
                and r.get("replayed") is True), None)
    cached_steps = None
    answer_equal = False
    if rec is None or rec.get("status") != "ok":
        violations.append(
            f"replayed query missing or failed: "
            f"{None if rec is None else rec.get('kind')}")
    else:
        run = rec.get("run") or {}
        cached_steps = run.get("cached_steps")
        # 0 completed steps recomputed: every pre-kill generation served
        # from the journal, only the missing ones dispatched
        if cached_steps != kill_step:
            violations.append(
                f"resume served {cached_steps} generations from the "
                f"journal, want {kill_step}")
        if run.get("dispatches") != run.get("steps", 0) - kill_step:
            violations.append(
                f"resume dispatched {run.get('dispatches')} generations, "
                f"want {run.get('steps', 0) - kill_step} "
                f"(recompute-at-most-zero broken)")
        # bit-equality vs an uninterrupted reference run of the query —
        # journaled (to a fresh journal) so the trail's chunk keys are
        # populated on both sides; the keys are content-derived, so they
        # match across journal files by construction
        cfg = SimConfig(**dict(TPL, sim_ms=400))
        ref = qengine.run_query(
            cfg, qspec.parse_query(qspec_obj),
            journal=journal_mod.SweepJournal(
                os.path.join(workdir, "query_ref.journal")), device=device)
        answer_equal = (
            obs.canonical_json(rec.get("answer"))
            == obs.canonical_json(ref["answer"])
            and obs.canonical_json(rec.get("trail"))
            == obs.canonical_json(ref["trail"])
        )
        if not answer_equal:
            violations.append(
                "replayed answer/trail diverge from the uninterrupted "
                "reference query")
        post = journal_mod.SweepJournal(jp)
        violations += invariants.check_query_trail(rec, journal=post)
        violations += invariants.check_sweep_journal(post)
    # phase 3: idempotence — nothing left to replay
    srv3 = ScenarioServer(wal_path=wal, journal_path=jp, device=device)
    replay_again = srv3.stats()["replayed"]
    srv3.close()
    if replay_again != 0:
        violations.append(
            f"third restart replayed {replay_again} ids (want 0)")
    return {"ledger": None, "stats": stats, "violations": violations,
            "replayed_ids": ["q-kill"],
            # the crashed server died holding this admission: the
            # telemetry conservation balance must be off by exactly one
            "lost_admissions": 1,
            "extra": {"generations_before_kill": len(pre_keys),
                      "cached_steps_on_resume": cached_steps,
                      "resume_misses": resume_misses,
                      "answer_bit_equal": answer_equal,
                      "replay_again": replay_again}}


SCENARIOS = {
    "dispatch-fail": scenario_dispatch_fail,
    "dispatch-hang": scenario_dispatch_hang,
    "cache-corrupt": scenario_cache_corrupt,
    "health-flap": scenario_health_flap,
    "batcher-kill": scenario_batcher_kill,
    "queue-storm": scenario_queue_storm,
    "poison-request": scenario_poison_request,
    "crash-restart": scenario_crash_restart,
    "sweep-kill9": scenario_sweep_kill9,
    "sweep-wedge": scenario_sweep_wedge,
    "query-kill9": scenario_query_kill9,
}


def run_scenario(name: str, seed: int, workdir: str | None = None,
                 quick: bool = False, device=None) -> dict:
    """Run ONE scenario on ``device`` (the CUDA card when None) under a
    fresh seeded controller with a private access log; returns its
    normalized (deterministic) summary.

    The summary carries the outcome kinds per request id, the terminal
    counters, the fired chaos schedule and every invariant violation —
    and nothing timing-shaped, so two same-seed runs must compare equal
    (the drill's determinism gate)."""
    from blockchain_simulator_tpu_torch.utils import telemetry

    fn = SCENARIOS[name]
    workdir = workdir or tempfile.mkdtemp(prefix=f"chaos_{name}_")
    log = os.path.join(workdir, "access.jsonl")
    prev = os.environ.get(obs.RUNS_ENV)
    os.environ[obs.RUNS_ENV] = log
    reg_before = aotcache.registry.stats()
    tel_before = telemetry.metrics.snapshot()
    try:
        with inject.controller(seed) as ctl, telemetry.capture() as spans:
            rep = fn(ctl, workdir, quick, device)
            schedule = ctl.schedule()
    finally:
        if prev is None:
            os.environ.pop(obs.RUNS_ENV, None)
        else:
            os.environ[obs.RUNS_ENV] = prev
    reg_after = aotcache.registry.stats()
    tel_after = telemetry.metrics.snapshot()
    violations = list(rep.get("violations") or [])
    ledger, stats = rep.get("ledger"), rep.get("stats")
    if stats is not None:
        violations += invariants.check_server(
            ledger, stats, log_path=log,
            registry_before=reg_before, registry_after=reg_after,
            replayed_ids=rep.get("replayed_ids", ()),
        )
    else:
        violations += invariants.registry_monotone(reg_before, reg_after)
    # the telemetry cross-checks: counter deltas must conserve
    # like the Ledger, and the scenario's serving span trees — normalized
    # timing-free — ride the summary, so the drill's byte-equal
    # determinism gate now covers telemetry too
    violations += invariants.check_telemetry(
        tel_before, tel_after,
        lost_admissions=int(rep.get("lost_admissions", 0)))
    if violations:
        telemetry.flight.note("chaos.invariant_violation", scenario=name,
                              n=len(violations))
        telemetry.flight.dump("invariant-violation")
    return {
        "scenario": name,
        "seed": seed,
        "outcomes": ledger.kinds() if ledger is not None else None,
        "counts": _counts(stats) if stats is not None else None,
        "chaos_schedule": schedule,
        "span_tree": invariants.normalize_spans(spans),
        "violations": violations,
        **{k: v for k, v in (rep.get("extra") or {}).items()},
    }
