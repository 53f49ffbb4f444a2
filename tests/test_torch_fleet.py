"""The port's fleet layer (``serve/fleet.py``, ``serve/router.py``) held to
the JAX package's on the CPU, case for case with ``tests/test_zfleet.py``.

Claims race across the two packages' ``claim_wal`` (one lease, whichever
package's writer wins); ``handoff_wal`` replays the same WAL in the same
order with the same results and access-log lines as JAX's; a replica
restarting on a WAL claimed by JAX's router skips its replay; the router's
429 retry bound, failover on a refused connection, the hedge's single
answer with its counted late loser, the parked broken send answered by the
handoff and the typed edge rejections each give JAX's router's counts and
answers over each package's stub replicas.  The fleet CLI refuses
``--mesh-sweep`` (exit 2) and, without a card, exits 1 before READY; on the
CPU it serves through its router.  The subprocess kill -9 leg
(``fleet_scenarios.kill9_leg``) runs on two CPU replicas: each handed-off
request is answered once by the peer, equal to JAX's ``run_simulation``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from blockchain_simulator_tpu import runner as jrunner
from blockchain_simulator_tpu.chaos import fleet_scenarios as jfs
from blockchain_simulator_tpu.serve import fleet as jfleet
from blockchain_simulator_tpu.serve import router as jrouter
from blockchain_simulator_tpu.serve.wal import WriteAheadLog as JWal
from blockchain_simulator_tpu.utils.config import FaultConfig as JFault
from blockchain_simulator_tpu.utils.config import SimConfig as JConfig
from blockchain_simulator_tpu_torch.chaos import fleet_scenarios as tfs
from blockchain_simulator_tpu_torch.chaos import invariants
from blockchain_simulator_tpu_torch.chaos.scenarios import TPL
from blockchain_simulator_tpu_torch.serve import ScenarioServer
from blockchain_simulator_tpu_torch.serve import fleet as tfleet
from blockchain_simulator_tpu_torch.serve import router as trouter
from blockchain_simulator_tpu_torch.serve.wal import WriteAheadLog as TWal
from blockchain_simulator_tpu_torch.utils import obs
from test_torch_pbft import REPO, release_jax_executables  # noqa: F401 (autouse fixture)
from test_torch_query import one_torch_thread  # noqa: F401 (module fixture)

# (fleet module, router module, fleet-scenarios module) per package
PKG = {"jax": (jfleet, jrouter, jfs), "torch": (tfleet, trouter, tfs)}


def _claim_fns(mode):
    """The claimant for thread ``i``: the port's, or alternately JAX's and
    the port's (both packages racing one lease)."""
    if mode == "torch":
        return lambda i: tfleet.claim_wal
    return lambda i: (jfleet, tfleet)[i % 2].claim_wal


# ------------------------------------------------------------- claims ------

@pytest.mark.parametrize("mode", ["torch", "mixed"])
def test_claim_race_exactly_one_winner(tmp_path, mode):
    wal = str(tmp_path / "r.wal")
    fn = _claim_fns(mode)
    wins = []
    ts = [threading.Thread(target=lambda i=i: wins.append(fn(i)(wal, f"o{i}")))
          for i in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert sum(wins) == 1
    assert tfleet.claim_owner(wal) is not None
    assert tfleet.claim_owner(wal) == jfleet.claim_owner(wal)
    assert tfleet.claim_wal(wal, "latecomer") is False
    assert jfleet.claim_wal(wal, "latecomer") is False


@pytest.mark.parametrize("mode", ["torch", "mixed"])
def test_torn_claim_stolen_exactly_once(tmp_path, mode):
    wal = str(tmp_path / "r.wal")
    with open(tfleet.claim_path(wal), "w"):
        pass
    assert tfleet.claim_owner(wal) is None and jfleet.claim_owner(wal) is None
    fn = _claim_fns(mode)
    wins = []
    ts = [threading.Thread(target=lambda i=i: wins.append(fn(i)(wal, f"s{i}")))
          for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert sum(wins) == 1
    owner = tfleet.claim_owner(wal)
    assert owner is not None and owner.startswith("s")
    assert tfleet.claim_wal(wal, "again") is False


def test_release_claim_reopens_the_lease_across_packages(tmp_path):
    wal = str(tmp_path / "r.wal")
    assert tfleet.claim_wal(wal, "one")
    assert jfleet.claim_owner(wal) == "one"
    tfleet.release_claim(wal)
    assert tfleet.claim_owner(wal) is None
    assert jfleet.claim_wal(wal, "two")
    assert tfleet.claim_owner(wal) == "two"
    jfleet.release_claim(wal)
    assert tfleet.claim_wal(wal, "three")


# ------------------------------------------------------------ handoff ------

def _dead_wal(path, wal_cls):
    w = wal_cls(path, sync=True)
    w.append_admit("a", {"x": 1})
    w.append_admit("b", {"x": 2})
    w.append_done("a")  # answered before the crash: must NOT replay
    w.append_admit("c", {"x": 3})
    w.close()


def _replayed_lines(log):
    return [{k: v for k, v in r.items() if k != "manifest"}
            for r in obs.read_jsonl(log) if r.get("replayed") is True]


def test_handoff_wal_replays_pending_in_order_and_retires(tmp_path, monkeypatch):
    """The port's handoff of a dead WAL equals JAX's handoff of a copy of
    it: the result, the posts and answers in admission order, the access-log
    lines; a second handoff claims and finds nothing."""
    out = {}
    for name, (fleet_mod, _, _) in PKG.items():
        d = tmp_path / name
        d.mkdir()
        wal = str(d / "dead.wal")
        _dead_wal(wal, TWal)
        log = str(d / "access.jsonl")
        monkeypatch.setenv(obs.RUNS_ENV, log)
        posted, answered = [], []

        def post(obj, posted=posted):
            posted.append(obj["id"])
            return 200, {"id": obj["id"], "status": "ok", "code": 200}

        res = fleet_mod.handoff_wal(wal, "router-A", post,
                                    on_answer=lambda rid, b, a=answered: a.append(rid))
        res2 = fleet_mod.handoff_wal(wal, "router-B", post)
        out[name] = (res, posted, answered, res2, _replayed_lines(log),
                     TWal(wal).pending(), JWal(wal).pending())
    res, posted, answered, res2, lines, tpend, jpend = out["torch"]
    assert res["claimed"] is True
    assert res["replayed"] == ["b", "c"] == posted == answered
    assert res2["claimed"] is True and res2["pending"] == 0
    assert sorted(r["id"] for r in lines) == ["b", "c"]
    assert tpend == jpend == []
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("holder", ["jax", "torch"])
def test_handoff_wal_loser_replays_nothing(tmp_path, holder):
    """The lease is held by one package's router; the other package's
    handoff loses and replays nothing."""
    wal = str(tmp_path / "dead.wal")
    w = TWal(wal, sync=True)
    w.append_admit("a", {"x": 1})
    w.close()
    loser = PKG["torch" if holder == "jax" else "jax"][0]
    assert PKG[holder][0].claim_wal(wal, "other-router")
    posted = []
    res = loser.handoff_wal(wal, "me", lambda obj: posted.append(obj))
    assert res["claimed"] is False and res["owner"] == "other-router"
    assert posted == [] and res["replayed"] == []


def _poster(base_url):
    def post(obj):
        req = urllib.request.Request(
            f"{base_url}/scenario", data=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())
    return post


def test_handoff_replay_of_invalid_answers_typed_rejection(tmp_path, monkeypatch):
    """A pending admit that no longer parses replays as its typed 400
    through a REAL peer (the port's on the CPU, JAX's) and still retires;
    both answers are the same."""
    monkeypatch.setenv(obs.RUNS_ENV, str(tmp_path / "access.jsonl"))
    answers = {}
    for name, (fleet_mod, _, fs) in PKG.items():
        wal = str(tmp_path / f"{name}.wal")
        w = TWal(wal, sync=True)
        w.append_admit("bad", {"protocol": "pbft", "n": 8, "bogus_field": 1})
        w.close()
        kw = {"device": "cpu"} if name == "torch" else {}
        peer = fs.LocalReplica(f"peer-{name}", max_batch=2, max_wait_ms=5.0, **kw)
        try:
            got = {}
            res = fleet_mod.handoff_wal(wal, "me", _poster(peer.base_url),
                                        on_answer=got.__setitem__)
        finally:
            peer.close()
        assert res["claimed"] and res["replayed"] == ["bad"]
        assert TWal(wal).pending() == []
        answers[name] = {k: v for k, v in got["bad"].items() if k != "latency_ms"}
    assert answers["torch"]["kind"] == "invalid-request"
    assert answers["torch"]["replayed"] is True
    assert answers["torch"]["handoff"] == {"wal": "torch.wal", "owner": "me"}
    answers["jax"]["handoff"]["wal"] = "torch.wal"
    assert answers["torch"] == answers["jax"]


def test_replica_restart_while_wal_claimed_skips_replay(tmp_path):
    """A port replica coming back while JAX's router holds its WAL lease
    does not replay; after the release it replays the pending id."""
    wal = str(tmp_path / "r.wal")
    w = TWal(wal, sync=True)
    w.append_admit("p1", dict(TPL, seed=1, id="p1"))
    w.close()
    assert jfleet.claim_wal(wal, "router-Z")
    srv = ScenarioServer(wal_path=wal, start=False, device="cpu")
    try:
        stats = srv.stats()
        assert stats["replayed"] == 0
        assert stats["wal"]["claimed_by"] == "router-Z"
        assert stats["wal"]["replayed_at_start"] == 0
    finally:
        srv.close(drain=False)
    jfleet.release_claim(wal)
    srv2 = ScenarioServer(wal_path=wal, start=False, device="cpu")
    try:
        assert srv2.stats()["replayed"] == 1
        assert srv2.stats()["wal"]["claimed_by"] is None
    finally:
        srv2.close(drain=False)


# ------------------------------------------------------------- router ------

def _retry_429(name):
    _, router_mod, fs = PKG[name]
    a = fs.StubReplica("a", mode="reject-429")
    b = fs.StubReplica("b", mode="reject-429")
    router = router_mod.FleetRouter([a, b], retries=2, retry_backoff_s=0.01, probe=False,
                                    validate=False, owner="t")
    try:
        first = router.request({"id": "q1"}, wait_s=30)
        st = router.stats()
        a.mode = b.mode = "ok"
        second = router.request({"id": "q2"}, wait_s=30)
        return (first["kind"], st["retries"], st["received"], second["status"],
                router.stats()["answered"])
    finally:
        router.close()
        a.close()
        b.close()


def test_router_retry_bounded_on_429():
    got = _retry_429("torch")
    assert got == ("queue-full", 2, 1, "ok", {"queue-full": 1, "ok": 1})
    assert got == _retry_429("jax")


def _failover(name):
    _, router_mod, fs = PKG[name]
    a = fs.StubReplica("a", mode="ok")
    b = fs.StubReplica("b", mode="ok")
    a.die()  # connection refused: provably never admitted, a safe retry
    router = router_mod.FleetRouter([a, b], retries=2, retry_backoff_s=0.01, probe=False,
                                    validate=False, route="rr", owner="t")
    try:
        resps = [router.request({"id": f"f{i}"}, wait_s=30) for i in range(3)]
        st = router.stats()
        return ([r["status"] for r in resps], [r["metrics"]["served_by"] for r in resps],
                st["received"], st["answered"],
                {k: v["forwarded"] for k, v in st["replicas"].items()})
    finally:
        router.close()
        b.close()


def test_router_fails_over_on_refused_connection():
    got = _failover("torch")
    assert got[0] == ["ok"] * 3 and set(got[1]) == {"b"}
    assert got == _failover("jax")


def _hedge(name):
    _, router_mod, fs = PKG[name]
    slow = fs.StubReplica("slow", mode="slow", slow_s=0.6)
    fast = fs.StubReplica("fast", mode="ok")
    router = router_mod.FleetRouter([slow, fast], hedge_ms=50, probe=False, validate=False,
                                    route="rr", owner="t")
    try:
        resp = router.request({"id": "h1"}, wait_s=30)
        deadline = time.monotonic() + 10
        while router.stats()["late_answers"] < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        st = router.stats()
        return (resp["status"], resp.get("hedged"), resp["metrics"]["served_by"],
                st["hedges"], st["late_answers"], st["answered"])
    finally:
        router.close()
        slow.close()
        fast.close()


def test_router_hedge_answers_once_and_counts_the_late_loser():
    got = _hedge("torch")
    assert got == ("ok", True, "fast", 1, 1, {"ok": 1})
    assert got == _hedge("jax")


def _parked(name, tmp_path):
    _, router_mod, fs = PKG[name]
    d = tmp_path / name
    d.mkdir()
    os.environ[obs.RUNS_ENV] = str(d / "access.jsonl")
    wal = str(d / "victim.wal")
    victim = fs.StubReplica("victim", mode="admit-die", wal_path=wal)
    peer = fs.StubReplica("peer", mode="ok")
    router = router_mod.FleetRouter([victim, peer], probe_interval_s=0.05, dead_after=2,
                                    validate=False, route="rr", owner="t",
                                    request_timeout_s=30)
    try:
        pends = [router.submit({"id": f"p{i}"}) for i in range(4)]
        deadline = time.monotonic() + 10
        while router.stats()["parked_total"] < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        victim.die()
        assert router.join_handoffs(1, timeout_s=30)
        answers = {p.req_id: p.result(30) for p in pends}
        st = router.stats()
        hand = st["handoffs"][0]
        return ({k: (a["status"], bool(a.get("replayed"))) for k, a in answers.items()},
                st["received"], st["answered"], st["parked_total"],
                (hand["claimed"], sorted(hand["replayed"]), hand["redispatched"]),
                st["replicas"]["victim"]["state"], invariants.check_fleet(None, st),
                sorted(r["id"] for r in _replayed_lines(str(d / "access.jsonl"))))
    finally:
        router.close()
        peer.close()
        victim.close()


def test_router_parks_broken_send_and_handoff_answers(tmp_path, monkeypatch):
    """The fleet death path over stubs, round robin over four requests: the
    two sent to the admit-then-die victim park, the probes declare it dead,
    the WAL handoff replays both on the peer and resolves the parked
    futures with the replayed mark — the port's router as JAX's."""
    monkeypatch.setenv(obs.RUNS_ENV, str(tmp_path / "unused.jsonl"))
    got = _parked("torch", tmp_path)
    answers, received, answered, parked, hand, state, viol, lines = got
    assert all(s == "ok" for s, _ in answers.values())
    assert sum(r for _, r in answers.values()) == 2 == parked
    assert received == 4 == sum(answered.values())
    assert hand[0] is True and len(hand[1]) == 2 and hand[2] == []
    assert state == "dead" and viol == []
    assert lines == hand[1]
    assert got == _parked("jax", tmp_path)


def _edge(name):
    _, router_mod, fs = PKG[name]
    a = fs.StubReplica("a", mode="ok")
    router = router_mod.FleetRouter([a], probe=False, owner="t")  # validate=True
    try:
        bad = router.request({"protocol": "pbft", "n": 8, "wat": 1}, wait_s=30)
        mixed = router.request(dict(TPL, protocol="mixed", n=32), wait_s=30)
        ok = router.request(dict(TPL, seed=3, id="v1"), wait_s=30)
        return ((bad["kind"], bad["code"], bad["error"]),
                (mixed["kind"], mixed["code"], mixed["error"]),
                ok["status"], router.affinity_replica(dict(TPL, seed=3)),
                router.stats()["answered"])
    finally:
        router.close()
        a.close()


def test_router_validates_at_the_edge():
    got = _edge("torch")
    assert got[0][:2] == ("invalid-request", 400)
    assert got[1][:2] == ("unbatchable-config", 422)
    assert got == _edge("jax")


# ---------------------------------------------------------- fleet CLI ------

def test_fleet_cli_refuses_a_sweep_mesh(capsys):
    assert tfleet.main(["--mesh-sweep", "2", "--device", "cpu"]) == 2
    assert "queue A item 7b" in capsys.readouterr().err


def _fleet_cli(args, env_extra=None, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(REPO), **(env_extra or {}))
    return subprocess.Popen([sys.executable, "-m", "blockchain_simulator_tpu_torch.serve.fleet",
                             "--port", "0", *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)


def test_fleet_cli_without_a_card_exits_1_before_ready(tmp_path):
    proc = _fleet_cli(["--fleet-dir", str(tmp_path / "fleet")],
                      {"CUDA_VISIBLE_DEVICES": ""})
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 1, err
    assert "READY" not in out
    assert not (tmp_path / "fleet").exists()  # no replica was started


def test_fleet_cli_serves_through_its_router_on_the_cpu(tmp_path):
    """``python -m blockchain_simulator_tpu_torch.serve.fleet --device cpu``:
    one replica, READY with the router's port, one request answered through
    the router, /stats fleet-wide, /shutdown drains the replica and exits 0."""
    proc = _fleet_cli(["--replicas", "1", "--device", "cpu", "--max-wait-ms", "5",
                       "--fleet-dir", str(tmp_path / "fleet"),
                       "--prewarm", json.dumps(TPL)])
    try:
        line = proc.stdout.readline()
        assert line.startswith("READY "), line + proc.stderr.read()
        ready = json.loads(line[6:])
        assert [(r["id"], r["replayed"], r["device"]) for r in ready["replicas"]] == \
            [("replica-0", 0, "cpu")]
        base = f"http://127.0.0.1:{ready['port']}"
        status, body = _poster(base)(dict(TPL, seed=5, id="cli-1"))
        assert status == 200 and body["status"] == "ok"
        want = jrunner.run_simulation(JConfig(**TPL), seed=5)
        assert {k: str(v) for k, v in body["metrics"].items()} == \
            {k: str(v) for k, v in want.items()}
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            st = json.loads(r.read())
        assert st["received"] == 1 and st["answered"] == {"ok": 1}
        urllib.request.urlopen(urllib.request.Request(
            f"{base}/shutdown", data=b"{}", method="POST"), timeout=30).read()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ------------------------------------------------------- kill -9 leg ------

KILL9 = [dict(TPL, seed=700, id="fk-0"),
         dict(TPL, seed=701, id="fk-1", faults={"n_byzantine": 1}),
         dict(TPL, seed=702, id="fk-2", faults={"n_crashed": 1})]


def test_kill9_leg_on_cpu_replicas(tmp_path, monkeypatch):
    """Two subprocess replicas on the CPU; the one holding three admitted
    requests takes SIGKILL; each is answered once, replayed by the peer,
    equal to JAX's run_simulation; the restarted victim replays 0; a later
    request answers."""
    log = str(tmp_path / "access.jsonl")
    monkeypatch.setenv(obs.RUNS_ENV, log)
    mgr = tfleet.FleetManager(2, str(tmp_path / "fleet"), max_batch=8, max_wait_ms=3000.0,
                              device="cpu", prewarm=TPL, env={obs.RUNS_ENV: log})
    try:
        ready = mgr.start()
        assert [r["device"] for r in ready] == ["cpu", "cpu"]
        rec = tfs.kill9_leg(mgr, KILL9, dict(TPL, seed=800, id="fk-post"), timeout_s=120)
    finally:
        mgr.kill_all()
    assert rec["violations"] == [], rec["violations"]
    assert rec["ready"]["replayed"] == 0 and rec["post"]["status"] == "ok"
    for obj in KILL9 + [dict(TPL, seed=800, id="fk-post")]:
        kw = {k: v for k, v in obj.items() if k not in ("id", "seed", "faults")}
        want = jrunner.run_simulation(JConfig(**kw, faults=JFault(**obj.get("faults", {}))),
                                      seed=obj["seed"])
        got = rec["answers"].get(obj["id"], rec["post"])
        assert {k: str(v) for k, v in got["metrics"].items()} == \
            {k: str(v) for k, v in want.items()}, obj["id"]
    marked = [r["id"] for r in obs.read_jsonl(log) if r.get("replayed") is True]
    assert sorted(marked) == ["fk-0", "fk-1", "fk-2"]
