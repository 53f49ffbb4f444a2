"""Fleet chaos scenarios: the replicated serving tier under fire (port of
``blockchain_simulator_tpu/chaos/fleet_scenarios.py``).

Each scenario drives a REAL :class:`~blockchain_simulator_tpu_torch.serve.
router.FleetRouter` over live HTTP endpoints — a mix of real in-process
replicas (:class:`LocalReplica`: a ScenarioServer on ``device`` behind the
daemon's own handler) and scripted :class:`StubReplica` fault actors (real
sockets, no dispatch: a stub can admit-to-WAL-then-die, reject with 429,
or answer instantly, which keeps the drills deterministic and cheap) —
then checks the fleet invariants (chaos/invariants.check_fleet).
Summaries are normalized exactly like the single-daemon scenarios (outcome
kinds, terminal counters, the fired chaos schedule — nothing
timing-shaped), so a same-seed double run must be byte-equal, and equal to
the JAX package's summary.

Scenario catalog:

- ``fleet-replica-death``  the acceptance drill in-process: the replica
  holding admitted-but-unanswered requests (WAL-journaled, connections
  broken mid-flight) dies; the router's probes declare it dead, its WAL
  is lease-claimed and every pending id — including one whose request no
  longer validates — replays on the live peer exactly once, marked
  ``"replayed": true``, answers bit-equal (exact sampler) to
  uninterrupted references;
- ``fleet-slow-replica``   the path to one replica is chaos-slowed past
  ``hedge_ms``; the hedge answers from the peer, the slow answer arrives
  late and is dropped (counted, never delivered — no double answer);
- ``fleet-retry-storm``    every replica answers 429 queue-full; the
  router retries with backoff exactly ``retries`` times per request then
  answers the typed 429 — bounded, no amplification loop, and traffic
  serves again the moment the replicas recover;
- ``fleet-double-claim``   two routers race one dead WAL (fresh claim and
  torn-claim legs): the lease wins exactly once, the loser replays
  nothing, every pending id replays exactly once fleet-wide.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time

from blockchain_simulator_tpu_torch.chaos import inject, invariants
from blockchain_simulator_tpu_torch.chaos.scenarios import TPL, _norm
from blockchain_simulator_tpu_torch.serve import fleet as fleet_mod
from blockchain_simulator_tpu_torch.serve.wal import WriteAheadLog
from blockchain_simulator_tpu_torch.utils import aotcache, obs


# ------------------------------------------------------------ endpoints ---


class StubReplica:
    """A scripted replica endpoint: real HTTP on an ephemeral port, no
    simulation dispatch.  ``mode`` (mutable mid-scenario) scripts the
    fault behavior per POST /scenario:

    - ``"ok"``        answer 200 with a stub body immediately;
    - ``"slow"``      sleep ``slow_s`` then answer 200 (the hedged-
      failover victim);
    - ``"reject-429"``answer the typed queue-full body (retry-storm);
    - ``"admit-die"`` journal the admit into ``wal_path`` (fsynced, the
      real serve/wal.py writer) and break the connection without a
      response — a kill -9 landing between admission and answer, as the
      router sees it.

    ``/healthz`` answers 200 while the stub lives; :meth:`die` closes the
    listener so probes see connection-refused, like a dead process."""

    def __init__(self, replica_id: str, mode: str = "ok",
                 wal_path: str | None = None, slow_s: float = 0.0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.id = str(replica_id)
        self.mode = mode
        self.wal_path = wal_path
        self.slow_s = float(slow_s)
        self.wal = WriteAheadLog(wal_path, sync=True) if wal_path else None
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send(self, code, body):
                blob = (json.dumps(body) + "\n").encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

            def do_GET(self):
                self._send(200, {"ready": True, "stub": stub.id})

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                try:
                    obj = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    obj = {}
                rid = str(obj.get("id"))
                mode = stub.mode
                if mode == "admit-die":
                    if stub.wal is not None:
                        stub.wal.append_admit(rid, obj)
                    return  # no response: the connection breaks mid-flight
                if mode == "reject-429":
                    self._send(429, {
                        "id": rid, "status": "error", "code": 429,
                        "kind": "queue-full",
                        "error": f"stub {stub.id} is full",
                    })
                    return
                if mode == "slow":
                    time.sleep(stub.slow_s)
                self._send(200, {
                    "id": rid, "status": "ok", "code": 200,
                    "metrics": {"served_by": stub.id},
                    "batch": {"size": 1, "mode": "stub"},
                    "latency_ms": 0.0,
                })

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.base_url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def die(self) -> None:
        """Close the listener: probes and sends now see refused — the
        router-side signature of a dead process."""
        self.httpd.shutdown()
        self.httpd.server_close()
        if self.wal is not None:
            self.wal.close()

    def close(self) -> None:
        try:
            self.die()
        except Exception:
            pass


class LocalReplica:
    """A REAL replica in-process: a ScenarioServer on ``device`` (the CUDA
    card when None) behind the daemon's own HTTP handler
    (serve/__main__.make_httpd) on an ephemeral port — the peer that
    answers WAL replays with real, reference-comparable metrics in the
    drills."""

    def __init__(self, replica_id: str, wal_path: str | None = None,
                 device=None, **server_kw):
        from blockchain_simulator_tpu_torch.serve.__main__ import make_httpd
        from blockchain_simulator_tpu_torch.serve.server import ScenarioServer

        self.id = str(replica_id)
        self.wal_path = wal_path
        self.server = ScenarioServer(wal_path=wal_path, replica=self.id,
                                     device=device, **server_kw)
        self.httpd = make_httpd(self.server, "127.0.0.1", 0)
        self.base_url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        try:
            self.httpd.shutdown()
            self.httpd.server_close()
        finally:
            self.server.close()


def _affinity_order(obj: dict, victim, peer):
    """Order two endpoints so the request template's batch-group affinity
    lands on ``victim`` — the drills aim their traffic without touching
    router internals (serve/router.py hashes group[:8] over the replica
    list)."""
    from blockchain_simulator_tpu_torch.serve import schema

    req = schema.parse_request(dict(obj), "probe")
    idx = int(obs.config_hash(req.canon)[:8], 16) % 2
    return [victim, peer] if idx == 0 else [peer, victim]


def _queue_depth(base_url: str) -> int:
    import urllib.request

    with urllib.request.urlopen(f"{base_url}/stats", timeout=30) as r:
        return int(json.loads(r.read())["queue_depth"])


def kill9_leg(mgr, requests, post_request, owner: str = "kill9-router",
              timeout_s: float = 300.0) -> dict:
    """The subprocess kill -9 leg (the JAX package's
    ``tools/fleet_bench.kill9_leg``) over a started two-replica
    :class:`~blockchain_simulator_tpu_torch.serve.fleet.FleetManager`.

    ``requests`` (one batch group) are aimed by affinity at one replica, the
    victim; once all of them are admitted and WAL-fsynced (its ``/stats``
    ``queue_depth``) the victim takes SIGKILL.  The router's probes declare
    it dead, lease-claim its WAL and replay every pending id on the peer,
    exactly once.  Then the victim restarts on its WAL (its READY line must
    report ``replayed: 0``: the handoff done-marked its backlog) while
    ``post_request`` goes through the router.  The process's
    ``$BLOCKSIM_RUNS_JSONL`` must be the replicas' access log
    (:func:`~blockchain_simulator_tpu_torch.chaos.invariants.check_fleet`
    reads it).  Returns the answers, the post-restart answer, the READY
    record, the router's stats, the violations and the walls (``kill_s``:
    kill to the last replayed answer; ``restart_s``: the restart to READY);
    the caller holds the answers to its references."""
    from blockchain_simulator_tpu_torch.serve.router import FleetRouter

    t0 = time.monotonic()
    violations: list[str] = []
    router = FleetRouter(mgr.replicas, owner=owner, probe_interval_s=0.2,
                         dead_after=2, request_timeout_s=timeout_s)
    try:
        victim_id = router.affinity_replica(requests[0])
        if {router.affinity_replica(r) for r in requests} != {victim_id}:
            raise ValueError("kill9_leg: the requests are not one batch group")
        victim = next(r for r in mgr.replicas if r.id == victim_id)
        peer = next(r for r in mgr.replicas if r.id != victim_id)
        ledger = invariants.Ledger()
        pendings = []
        for obj in requests:
            ledger.submitted(obj["id"])
            pendings.append((obj["id"], router.submit(obj)))
        deadline = time.monotonic() + timeout_s
        while _queue_depth(victim.base_url) < len(requests):
            if time.monotonic() > deadline:
                raise TimeoutError("kill9_leg: the victim never admitted "
                                   "every request")
            time.sleep(0.02)
        t_kill = time.monotonic()
        victim.kill()
        if not router.join_handoffs(1, timeout_s=timeout_s):
            violations.append("kill9 handoff never completed")
        answers = {}
        for rid, pend in pendings:
            answers[rid] = pend.result(timeout_s)
            ledger.record(rid, answers[rid])
            if answers[rid].get("status") != "ok" \
                    or answers[rid].get("replayed") is not True:
                violations.append(
                    f"kill9 {rid!r} not answered via replay: "
                    f"{answers[rid].get('kind') or answers[rid].get('status')}")
        kill_s = max((p.answered_at for _, p in pendings if p.answered_at),
                     default=t_kill) - t_kill
        stats = router.stats()
        hand = stats["handoffs"]
        if [(h["replica"], h.get("claimed")) for h in hand] \
                != [(victim_id, True)]:
            violations.append(f"kill9 handoffs {hand} (want one claimed "
                              f"handoff of {victim_id})")
        if fleet_mod.claim_owner(victim.wal_path) is not None \
                or os.path.exists(fleet_mod.claim_path(victim.wal_path)):
            violations.append("kill9 claim not released")
        forwarded = {k: v["forwarded"] for k, v in stats["replicas"].items()}
        if forwarded != {victim_id: 0, peer.id: len(requests)}:
            violations.append(f"kill9 replays not all on the peer: {forwarded}")
        # the restart and one more request through the router, side by
        # side: the router keeps the victim dead (no manager), so the
        # request is the peer's either way
        ready: dict = {}
        restart_err: list = []

        def restart():
            t = time.monotonic()
            try:
                ready.update(mgr.restart(victim_id))
            except Exception as e:  # reported below, never swallowed
                restart_err.append(e)
            ready["restart_s"] = time.monotonic() - t

        th = threading.Thread(target=restart, name="kill9-restart")
        th.start()
        ledger.submitted(post_request["id"])
        post = router.request(post_request, wait_s=timeout_s)
        ledger.record(post_request["id"], post)
        th.join(timeout_s)
        if restart_err:
            raise restart_err[0]
        if ready.get("replayed") != 0 or ready.get("wal_claimed_by") is not None:
            violations.append(
                f"restarted victim replayed {ready.get('replayed')} (claim "
                f"{ready.get('wal_claimed_by')}; want 0, unclaimed)")
        if post.get("status") != "ok":
            violations.append(f"the fleet did not serve after the restart: "
                              f"{post.get('kind')}")
        stats = router.stats()
        violations += invariants.check_fleet(
            ledger, stats, log_path=os.environ.get(obs.RUNS_ENV),
            handoff_ids=[obj["id"] for obj in requests])
    finally:
        router.close()
    return {"victim": victim_id, "peer": peer.id, "answers": answers,
            "post": post, "ready": ready, "stats": stats,
            "violations": violations, "kill_s": kill_s,
            "restart_s": ready.get("restart_s"),
            "wall_s": time.monotonic() - t0}


# ------------------------------------------------------------ scenarios ---


def scenario_replica_death(ctl, workdir, quick, device):
    """Replica kill mid-traffic: admitted-but-unanswered ids (plus one
    pre-crash admit that no longer validates) replay on the live peer
    exactly once, marked, bit-equal to uninterrupted references."""
    from blockchain_simulator_tpu_torch import runner
    from blockchain_simulator_tpu_torch.serve.router import FleetRouter
    from blockchain_simulator_tpu_torch.utils.config import FaultConfig, SimConfig

    wal = os.path.join(workdir, "victim.wal")
    crash_points = [
        ("fcrash-0", dict(TPL, seed=300, id="fcrash-0")),
        ("fcrash-1", dict(TPL, seed=301, id="fcrash-1",
                          faults={"n_byzantine": 1})),
        ("fcrash-2", dict(TPL, seed=302, id="fcrash-2",
                          faults={"n_crashed": 1})),
    ]
    # a pre-crash admission whose request no longer parses: the replay
    # must answer its typed 400, never crash the handoff
    stale = WriteAheadLog(wal, sync=True)
    stale.append_admit("fstale-0", {"protocol": "pbft", "n": 8,
                                    "no_such_field": 1, "id": "fstale-0"})
    stale.close()

    victim = StubReplica("fvictim", mode="admit-die", wal_path=wal)
    peer = LocalReplica("fpeer", max_batch=2, max_wait_ms=5.0,
                        device=device)
    ledger = invariants.Ledger()
    violations: list[str] = []
    router = FleetRouter(
        _affinity_order(crash_points[0][1], victim, peer),
        probe_interval_s=0.1, dead_after=2, owner="drill-router",
        request_timeout_s=60.0,
    )
    try:
        pendings = []
        for i, (rid, obj) in enumerate(crash_points):
            ledger.submitted(rid)
            pendings.append((rid, router.submit(obj)))
            # serialize admissions: each submit must park (WAL-admitted,
            # connection broken) before the next, so the replay order —
            # pinned to WAL admission order below — is deterministic
            deadline = time.monotonic() + 30
            while router.stats()["parked_total"] < i + 1 \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
        victim.die()
        if not router.join_handoffs(1, timeout_s=60.0):
            violations.append("handoff never completed")
        for rid, pending in pendings:
            ledger.record(rid, pending.result(60.0))
        stats = router.stats()
    finally:
        router.close()
        peer.close()
        victim.close()
    # bit-equality: each replayed answer vs an uninterrupted reference
    log = os.environ.get(obs.RUNS_ENV)
    recs = obs.read_jsonl(log) if log else []
    replay_recs = {r.get("id"): r for r in recs
                   if r.get("replayed") is True}
    divergence = 0
    for rid, obj in crash_points:
        rec = replay_recs.get(rid)
        if rec is None or rec.get("status") != "ok":
            violations.append(f"fleet replay of {rid!r} missing/failed")
            divergence += 1
            continue
        kw = {k: v for k, v in obj.items()
              if k not in ("id", "seed", "faults")}
        cfg = SimConfig(**kw, faults=FaultConfig(**obj.get("faults", {})))
        ref = runner.run_simulation(cfg, seed=obj["seed"], device=device)
        if _norm(rec["metrics"]) != _norm(ref):
            violations.append(f"fleet replay of {rid!r} diverged from "
                              f"the uninterrupted reference")
            divergence += 1
    stale_rec = replay_recs.get("fstale-0")
    if stale_rec is None or stale_rec.get("kind") != "invalid-request":
        violations.append(
            f"stale admit did not replay as a typed rejection: "
            f"{None if stale_rec is None else stale_rec.get('kind')}")
    handoff_ids = [rid for rid, _ in crash_points] + ["fstale-0"]
    violations += invariants.check_fleet(
        ledger, stats, log_path=log, handoff_ids=handoff_ids)
    want_order = ["fstale-0"] + [rid for rid, _ in crash_points]
    got_order = stats["handoffs"][0].get("replayed") \
        if stats.get("handoffs") else []
    if got_order != want_order:
        violations.append(
            f"replay order {got_order} != WAL admission order "
            f"{want_order}")
    if any(k != ["ok"] for k in ledger.kinds().values()):
        violations.append(f"death outcomes wrong: {ledger.kinds()}")
    return {"ledger": ledger, "stats": stats, "violations": violations,
            "handoff_ids": handoff_ids,
            "extra": {"replay_divergence": divergence}}


def scenario_slow_replica(ctl, workdir, quick, device):
    """The path to one replica is chaos-slowed past ``hedge_ms``: the
    hedge answers from the peer, the slow answer lands late and is
    dropped — one answer per admission, counted duplicates only."""
    from blockchain_simulator_tpu_torch.serve.router import FleetRouter

    slow = StubReplica("fslow", mode="ok")
    fast = StubReplica("ffast", mode="ok")
    ctl.slow_next("fleet.send", 0.8,
                  match=lambda ctx: ctx.get("replica") == "fslow")
    ledger = invariants.Ledger()
    violations: list[str] = []
    router = FleetRouter(
        _affinity_order(dict(TPL, seed=1), slow, fast),
        hedge_ms=60.0, probe=False, owner="drill-router",
        request_timeout_s=30.0, validate=True,
    )
    try:
        ledger.submitted("fhedge-0")
        resp = router.request(dict(TPL, seed=1, id="fhedge-0"), wait_s=30.0)
        ledger.record("fhedge-0", resp)
        # the slow primary answers ~0.8 s in: wait for the counted drop
        deadline = time.monotonic() + 30
        while router.stats()["late_answers"] < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        stats = router.stats()
    finally:
        router.close()
        slow.close()
        fast.close()
    if resp.get("status") != "ok" or not resp.get("hedged"):
        violations.append(f"hedge did not answer: {resp}")
    if stats["hedges"] != 1:
        violations.append(f"hedges {stats['hedges']} != 1")
    if stats["late_answers"] != 1:
        violations.append(
            f"late_answers {stats['late_answers']} != 1 (the slow "
            f"primary's answer must be dropped, not delivered)")
    violations += invariants.check_fleet(ledger, stats)
    return {"ledger": ledger, "stats": stats, "violations": violations,
            "handoff_ids": [], "extra": {}}


def scenario_retry_storm(ctl, workdir, quick, device):
    """Every replica 429s: the retry budget is spent exactly (bounded,
    backoff between attempts), the terminal answer is the typed 429, and
    recovery serves immediately — no storm amplification."""
    from blockchain_simulator_tpu_torch.serve.router import FleetRouter

    a = StubReplica("fra", mode="reject-429")
    b = StubReplica("frb", mode="reject-429")
    ledger = invariants.Ledger()
    violations: list[str] = []
    n_storm = 3
    router = FleetRouter(
        [a, b], retries=2, retry_backoff_s=0.01, probe=False,
        owner="drill-router", request_timeout_s=30.0,
    )
    try:
        for i in range(n_storm):
            rid = f"fstorm-{i}"
            ledger.submitted(rid)
            ledger.record(rid, router.request(
                dict(TPL, seed=400 + i, id=rid), wait_s=30.0))
        mid_stats = router.stats()
        a.mode = b.mode = "ok"  # the storm passes
        ledger.submitted("fstorm-after")
        after = router.request(dict(TPL, seed=500, id="fstorm-after"),
                               wait_s=30.0)
        ledger.record("fstorm-after", after)
        stats = router.stats()
    finally:
        router.close()
        a.close()
        b.close()
    kinds = ledger.kinds()
    want = {f"fstorm-{i}": ["queue-full"] for i in range(n_storm)}
    want["fstorm-after"] = ["ok"]
    if kinds != want:
        violations.append(f"storm outcomes wrong: {kinds}")
    if mid_stats["retries"] != 2 * n_storm:
        violations.append(
            f"retry budget not exactly spent: {mid_stats['retries']} "
            f"retries for {n_storm} requests at retries=2")
    violations += invariants.check_fleet(ledger, stats)
    return {"ledger": ledger, "stats": stats, "violations": violations,
            "handoff_ids": [], "extra": {"storm": n_storm}}


def scenario_double_claim(ctl, workdir, quick, device):
    """Two routers race one dead WAL, twice: once over a fresh claim,
    once over a TORN claim file (a claimant that died mid-claim).  Each
    time exactly one lease wins, pendings replay exactly once fleet-wide,
    and the loser replays nothing."""
    peer = StubReplica("fclaim-peer", mode="ok")
    violations: list[str] = []
    extra: dict = {}

    def post(obj):
        import urllib.request

        data = json.dumps(obj).encode()
        req = urllib.request.Request(
            f"{peer.base_url}/scenario", data=data,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())

    try:
        for leg, torn in (("fresh", False), ("torn", True)):
            wal = os.path.join(workdir, f"dead-{leg}.wal")
            w = WriteAheadLog(wal, sync=True)
            ids = [f"fdc-{leg}-{i}" for i in range(2)]
            for rid in ids:
                w.append_admit(rid, dict(TPL, seed=600, id=rid))
            w.close()
            if torn:
                # a claimant that died between create and write: the
                # claim file exists with no parseable owner record
                with open(fleet_mod.claim_path(wal), "w"):
                    pass
            results = [None, None]

            def race(i, owner):
                results[i] = fleet_mod.handoff_wal(
                    wal, owner, post, release=False)

            threads = [threading.Thread(target=race, args=(i, f"router-{i}"))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            claims = [r for r in results if r and r["claimed"]]
            if len(claims) != 1:
                violations.append(
                    f"{leg}: {len(claims)} routers claimed the WAL "
                    f"(lease must win exactly once)")
                continue
            winner = claims[0]
            if winner["replayed"] != ids:
                violations.append(
                    f"{leg}: replayed {winner['replayed']} != {ids} "
                    f"(every pending id exactly once, in order)")
            loser = next(r for r in results if r and not r["claimed"])
            if loser["replayed"]:
                violations.append(f"{leg}: loser replayed "
                                  f"{loser['replayed']}")
            # the claim is still held: a second handoff (a replica
            # restarting, a third router) must find nothing claimable
            again = fleet_mod.handoff_wal(wal, "router-3", post)
            if again["claimed"]:
                violations.append(f"{leg}: held lease was re-claimed")
            fleet_mod.release_claim(wal)
            # post-release: the replay retired every id, nothing pends
            empty = fleet_mod.handoff_wal(wal, "router-4", post)
            if not empty["claimed"] or empty["pending"] != 0:
                violations.append(
                    f"{leg}: post-release handoff saw {empty['pending']} "
                    f"pending (want 0 — done records must retire ids)")
            fleet_mod.release_claim(wal)
            extra[leg] = {"winner_replayed": winner["replayed"]}
    finally:
        peer.close()
    return {"ledger": None, "stats": None, "violations": violations,
            "handoff_ids": [], "extra": extra}


FLEET_SCENARIOS = {
    "fleet-replica-death": scenario_replica_death,
    "fleet-slow-replica": scenario_slow_replica,
    "fleet-retry-storm": scenario_retry_storm,
    "fleet-double-claim": scenario_double_claim,
}


def _router_counts(stats: dict | None) -> dict | None:
    """The deterministic slice of router stats (timing-shaped fields —
    per-replica forwarded splits under rr, breaker cooldowns — excluded)."""
    if stats is None:
        return None
    return {
        "received": stats.get("received"),
        "answered": dict(sorted((stats.get("answered") or {}).items())),
        "retries": stats.get("retries"),
        "hedges": stats.get("hedges"),
        "late_answers": stats.get("late_answers"),
        "parked_total": stats.get("parked_total"),
        "handoff_lost": stats.get("handoff_lost"),
        "handoffs": [
            {"replica": h.get("replica"),
             "claimed": h.get("claimed"),
             "replayed": h.get("replayed"),
             "redispatched": h.get("redispatched")}
            for h in (stats.get("handoffs") or [])
        ],
    }


def run_fleet_scenario(name: str, seed: int, workdir: str | None = None,
                       quick: bool = False, device=None) -> dict:
    """Run ONE fleet scenario (its real replicas on ``device``, the CUDA
    card when None) under a fresh seeded controller with a private access
    log; returns its normalized (deterministic) summary —
    the same contract as chaos/scenarios.run_scenario, so the drill's
    same-seed double run can demand byte equality."""
    fn = FLEET_SCENARIOS[name]
    workdir = workdir or tempfile.mkdtemp(prefix=f"chaos_{name}_")
    log = os.path.join(workdir, "access.jsonl")
    prev = os.environ.get(obs.RUNS_ENV)
    os.environ[obs.RUNS_ENV] = log
    reg_before = aotcache.registry.stats()
    try:
        with inject.controller(seed) as ctl:
            rep = fn(ctl, workdir, quick, device)
            schedule = ctl.schedule()
    finally:
        if prev is None:
            os.environ.pop(obs.RUNS_ENV, None)
        else:
            os.environ[obs.RUNS_ENV] = prev
    reg_after = aotcache.registry.stats()
    violations = list(rep.get("violations") or [])
    violations += invariants.registry_monotone(reg_before, reg_after)
    ledger = rep.get("ledger")
    return {
        "scenario": name,
        "seed": seed,
        "outcomes": ledger.kinds() if ledger is not None else None,
        "counts": _router_counts(rep.get("stats")),
        "handoff_ids": list(rep.get("handoff_ids") or []),
        "chaos_schedule": schedule,
        "violations": violations,
        **{k: v for k, v in (rep.get("extra") or {}).items()},
    }
