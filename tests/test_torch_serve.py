"""The port's scenario server (``blockchain_simulator_tpu_torch/serve``), held
to the JAX package's on the CPU.

Served answers under the exact sampler — solo, a batched pair, a padded
triple (bucket 4) and a ``max_batch``-capped flush — equal each other and
JAX's ``sweep.run_dyn_points`` on the same points (PBFT, n = 64, round
path).  Under the ``"normal"`` sampler (n = 4096) a served answer equals
JAX's served answer for the same ordered lane list in one flush: the
assumption of ``chip_smoke.py``'s serve-config4 phase.  Beside them: the
schema's typed errors and batch groups against JAX's, WAL files and replay
across the two packages, the access log's ``cache`` and ``telemetry``
blocks, the operational paths (degrade to solo under a chaos fault, the
breaker, quarantine, 429, 503, 504, the batcher's supervisor, drain on
close), the HTTP daemon in-process and as ``python -m ... --self-test``,
the refusals of later slices, and the default device (CUDA; without a card
the server and the daemon refuse).  The JAX side is computed once (the
module fixture ``jax_side``).

Golden file (the card's runs, ``chip_smoke.py``):
``blockchain_simulator_tpu_torch/golden/serve_s0.json`` holds the JAX
package's ``ScenarioServer`` answers to the serve-http phase's 15 requests
(the README's n = 1024 request, f in {0, 1, 2, 5, 10} x seeds {0, 1, 2})
and to BASELINE config 2 served solo.  Rewrite it with ``PYTHONPATH=.
JAX_PLATFORMS=cpu python tests/test_torch_serve.py --write-golden`` (about a
minute).
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import pytest
import torch

from blockchain_simulator_tpu.parallel import sweep as jsweep
from blockchain_simulator_tpu.serve import ScenarioServer as JServer
from blockchain_simulator_tpu.serve import parse_request as jparse
from blockchain_simulator_tpu.serve import schema as jschema
from blockchain_simulator_tpu.serve.wal import WriteAheadLog as JWal
from blockchain_simulator_tpu.utils import obs as jobs
from blockchain_simulator_tpu_torch import runner as trunner
from blockchain_simulator_tpu_torch.chaos import inject
from blockchain_simulator_tpu_torch.serve import (
    AdmissionPausedError,
    InvalidRequestError,
    QueueFullError,
    ScenarioServer,
    UnbatchableRequestError,
    parse_request,
)
from blockchain_simulator_tpu_torch.serve import dispatch as tdispatch
from blockchain_simulator_tpu_torch.serve import schema as tschema
from blockchain_simulator_tpu_torch.serve.__main__ import main as serve_main
from blockchain_simulator_tpu_torch.serve.__main__ import make_httpd
from blockchain_simulator_tpu_torch.serve.wal import WriteAheadLog as TWal
from blockchain_simulator_tpu_torch.utils import aotcache, obs, telemetry

from test_torch_pbft import REPO, release_jax_executables  # noqa: F401 (autouse fixture)

GOLDEN = REPO / "blockchain_simulator_tpu_torch" / "golden" / "serve_s0.json"
WRITTEN_BY = "PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_serve.py --write-golden"

# the bit-equality template: PBFT n = 64 on the round path, exact sampler
TPL = {"protocol": "pbft", "n": 64, "sim_ms": 300, "delivery": "stat", "schedule": "round",
       "stat_sampler": "exact", "model_serialization": False}
POINTS = [dict(TPL, seed=0), dict(TPL, seed=1, faults={"n_byzantine": 5}),
          dict(TPL, seed=2, faults={"n_byzantine": 21}), dict(TPL, seed=3, faults={"n_crashed": 3})]
# the "normal" sampler's ordered lane list (n >= 4096), padded 3 -> 4
NORMAL_TPL = {"protocol": "pbft", "n": 4096, "sim_ms": 200, "delivery": "stat",
              "schedule": "round", "stat_sampler": "normal", "model_serialization": False}
NORMAL_POINTS = [dict(NORMAL_TPL, seed=0), dict(NORMAL_TPL, seed=1, faults={"n_byzantine": 700}),
                 dict(NORMAL_TPL, seed=2, faults={"n_byzantine": 1365})]
# the operational cases' cheap template
OPS = {"protocol": "pbft", "n": 16, "sim_ms": 150, "delivery": "stat", "schedule": "round",
       "stat_sampler": "exact", "model_serialization": False}

# serve-http (chip_smoke.py): the README's request, f levels x seeds
HTTP_TPL = {"protocol": "pbft", "n": 1024, "sim_ms": 600, "delivery": "stat",
            "schedule": "round", "model_serialization": False, "stat_sampler": "exact"}
HTTP_F = (0, 1, 2, 5, 10)
HTTP_SEEDS = (0, 1, 2)
# serve-tick: BASELINE config 2 (PBFT, n = 1000, 2,500 ms, defaults)
TICK_REQ = {"protocol": "pbft", "n": 1000, "sim_ms": 2500}


def http_requests() -> list[dict]:
    return [dict(HTTP_TPL, id=f"f{f}-s{s}", seed=s, faults={"n_byzantine": f})
            for f in HTTP_F for s in HTTP_SEEDS]


def _served(server_cls, points, max_batch, **kw):
    """Submit ``points`` in order to a fresh server (batcher started after
    the last submit, so a group is one drain), wait, close; the responses."""
    with server_cls(max_batch=max_batch, max_wait_ms=1.0, start=False, **kw) as srv:
        pends = [srv.submit(dict(p)) for p in points]
        srv.start()
        return [p.result(600) for p in pends]


def _rows(reqs):
    return jsweep.run_dyn_points(reqs[0].canon, [(r.cfg, r.seed) for r in reqs], record=False)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's answers, computed once: its sweep rows on POINTS,
    its served answers to NORMAL_POINTS in one flush, and its server's
    replay of a WAL the port wrote (with the access-log line).  Its JAX
    programs are freed when the module's tests are done, so they add no
    memory mappings to the tests a worker runs next (ROADMAP §C item 1)."""
    d = tmp_path_factory.mktemp("jax_side")
    rows = _rows([jparse(dict(p), "p") for p in POINTS])
    normal = _served(JServer, NORMAL_POINTS, max_batch=4)
    wal = d / "port.wal"
    twal = TWal(str(wal))
    twal.append_admit("v1", dict(POINTS[3]))
    twal.close()
    runs = d / "runs.jsonl"
    old = os.environ.get(obs.RUNS_ENV)
    os.environ[obs.RUNS_ENV] = str(runs)
    try:
        srv = JServer(wal_path=str(wal), max_wait_ms=1.0)
        srv.close()
        replay_stats = srv.stats()
    finally:
        if old is None:
            del os.environ[obs.RUNS_ENV]
        else:
            os.environ[obs.RUNS_ENV] = old
    (line,) = [r for r in jobs.read_jsonl(str(runs)) if r.get("id") == "v1"]
    yield {"rows": rows, "normal": normal, "replay_line": line,
           "replay_stats": replay_stats, "wal_after": JWal(str(wal)).pending()}
    jax.clear_caches()
    gc.collect()


# ------------------------------------------------------------- schema ------

INVALID = [
    (dict(TPL, bogus_field=1), "unknown request field"),
    (dict(TPL, faults={"bogus": 1}), "unknown fault field"),
    (dict(TPL, protocol="nope"), "unknown protocol"),
    (dict(TPL, faults="not-a-dict"), "faults must be"),
    (dict(TPL, faults=[]), "faults must be"),
    (dict(TPL, faults=False), "faults must be"),
    (dict(TPL, n="8"), "must be of type int"),
    (dict(TPL, faults={"drop_prob": "0.5"}), "must be of type float"),
    ("not-a-dict", "JSON object"),
    (dict(TPL, schedule="round", delivery="edge"), "schedule='round'"),
]


@pytest.mark.parametrize("obj,match", INVALID, ids=[m for _, m in INVALID])
def test_typed_errors_equal_jax(obj, match):
    """``tests/test_zserve.py``'s invalid requests: the port raises JAX's
    type with JAX's code, kind and message."""
    with pytest.raises(jschema.InvalidRequestError) as je:
        jparse(obj, "r1")
    with pytest.raises(InvalidRequestError, match=match) as te:
        parse_request(obj, "r1")
    assert (te.value.code, te.value.kind, str(te.value)) == (je.value.code, je.value.kind,
                                                             str(je.value))
    assert te.value.to_response("r1") == je.value.to_response("r1")


def test_unbatchable_and_batch_groups_equal_jax():
    """The mixed sim is a typed 422 as in JAX; a request's batch group
    (``obs.config_hash`` of its canonical structure) is JAX's, counts and
    seed normalized out, structure splitting groups."""
    obj = {"protocol": "mixed", "n": 32, "mixed_shards": 4}
    with pytest.raises(jschema.UnbatchableRequestError) as je:
        jparse(obj, "r")
    with pytest.raises(UnbatchableRequestError) as te:
        parse_request(obj, "r")
    assert (te.value.code, te.value.kind, str(te.value)) == (422, "unbatchable-config",
                                                             str(je.value))
    groups = set()
    for p in POINTS + [dict(TICK_REQ), dict(TICK_REQ, seed=4, faults={"drop_prob": 0.1})]:
        t, j = parse_request(dict(p), "x"), jparse(dict(p), "x")
        assert obs.config_hash(t.canon) == jobs.config_hash(j.canon)
        assert (t.seed, t.timeout_s) == (j.seed, j.timeout_s)
        assert tschema.scenario_template(t.cfg, t.seed) == jschema.scenario_template(j.cfg, j.seed)
        groups.add(obs.config_hash(t.canon))
    assert len(groups) == 3


@pytest.mark.parametrize("field", ["probe", "query"])
def test_probe_and_query_refused_naming_their_slice(field):
    """``probe`` and ``query`` requests are a typed 400 at admission naming
    the durable-sweeps slice; the request never reaches a batch."""
    obj = dict(OPS, **{field: True if field == "probe" else {"param": "n_crashed"}})
    with pytest.raises(InvalidRequestError, match="durable-sweeps slice") as ei:
        parse_request(obj, "r")
    assert (ei.value.code, ei.value.kind) == (400, "invalid-request")
    srv = ScenarioServer(device="cpu", start=False)
    resp = srv.request(obj)
    srv.close()
    assert resp["code"] == 400 and srv.stats()["batches"] == 0
    assert parse_request(dict(OPS, probe=False), "r").cfg.n == 16  # disarmed is fine


def test_nonpositive_n_is_a_typed_400():
    """A cluster of no nodes is refused at admission (400); the JAX server
    admits it and answers 500 once its dispatch fails, so the port refuses
    before any engine builds a negative shape."""
    with pytest.raises(InvalidRequestError, match="n must be >= 1") as ei:
        parse_request(dict(OPS, n=-1), "r")
    assert (ei.value.code, ei.value.kind) == (400, "invalid-request")
    assert jparse(dict(OPS, n=-1), "r").cfg.n == -1


# ---------------------------------------------------- served answers -------

@pytest.mark.parametrize("shape", ["solo", "pair", "padded", "capped"])
def test_served_answers_equal_jax_rows(jax_side, shape):
    """Solo, a batched pair, a padded triple (bucket 4) and a flush capped
    at ``max_batch`` = 3 (3 batched + 1 solo): each answer equals JAX's
    ``run_dyn_points`` row for its point, bit for bit (exact sampler)."""
    rows = jax_side["rows"]
    if shape == "solo":
        resps = [_served(ScenarioServer, [p], 1, device="cpu")[0] for p in POINTS]
        modes = [("solo", 1, 1)] * 4
    elif shape == "pair":
        resps = _served(ScenarioServer, POINTS[:2], 2, device="cpu")
        modes = [("batched", 2, 2)] * 2
    elif shape == "padded":
        resps = _served(ScenarioServer, POINTS[:3], 4, device="cpu")
        modes = [("batched", 3, 4)] * 3
    else:
        resps = _served(ScenarioServer, POINTS, 3, device="cpu")
        modes = [("batched", 3, 3)] * 3 + [("solo", 1, 1)]
    assert all(r["status"] == "ok" for r in resps), resps
    assert [(r["batch"]["mode"], r["batch"]["size"], r["batch"]["padded"]) for r in resps] == modes
    assert [r["metrics"] for r in resps] == rows[:len(resps)]
    assert {r["batch"]["group"] for r in resps} == {jobs.config_hash(jparse(dict(TPL), "x").canon)}


def test_normal_sampler_ordered_lanes_equal_jax_served(jax_side):
    """Under ``"normal"`` the lanes' draws follow lane 0's key, so a served
    answer is JAX's served answer for the same ordered lane list in one
    flush, padded to the same bucket (the serve-config4 phase's premise)."""
    want = jax_side["normal"]
    got = _served(ScenarioServer, NORMAL_POINTS, 4, device="cpu")
    assert [r["batch"] for r in got] == [r["batch"] for r in want]
    assert [r["metrics"] for r in got] == [r["metrics"] for r in want]


# -------------------------------------------------------------- WAL --------

def _ops(wal):
    wal.append_admit("a", dict(OPS, seed=1))
    wal.append_admit("b", dict(OPS, seed=2))
    wal.append_quarantine("b")
    wal.append_done("a", 200)
    wal.append_admit("c", dict(OPS, seed=3))
    wal.close()


def test_wal_files_equal_jax(tmp_path):
    """The same appends give the same records (up to the wall-clock ``ts``),
    the same pending set and quarantine, and byte-equal compacted files."""
    jp, tp = tmp_path / "j.wal", tmp_path / "t.wal"
    _ops(JWal(str(jp)))
    _ops(TWal(str(tp)))
    strip = lambda recs: [{k: v for k, v in r.items() if k != "ts"} for r in recs]  # noqa: E731
    assert strip(TWal(str(tp)).records()) == strip(JWal(str(jp)).records())
    assert TWal(str(tp)).pending() == JWal(str(jp)).pending() == [
        ("b", dict(OPS, seed=2)), ("c", dict(OPS, seed=3))]
    assert TWal(str(tp)).quarantined_ids() == {"b"}
    assert TWal(str(tp)).compact() == JWal(str(jp)).compact() == 2
    assert tp.read_bytes() == jp.read_bytes()


def test_wal_replay_across_packages(jax_side, tmp_path, monkeypatch):
    """A WAL written by JAX's ``WriteAheadLog`` is replayed by the port's
    server (exactly the undone admit, ``replayed: true``, JAX's answer), and
    the JAX server replayed the port's (the fixture): both answers equal
    JAX's rows, and both logs end with nothing pending."""
    path = tmp_path / "jax.wal"
    jw = JWal(str(path))
    jw.append_admit("w1", dict(POINTS[1]))
    jw.append_admit("w2", dict(POINTS[2]))
    jw.append_done("w1", 200)
    jw.close()
    runs = tmp_path / "runs.jsonl"
    monkeypatch.setenv(obs.RUNS_ENV, str(runs))
    srv = ScenarioServer(wal_path=str(path), max_wait_ms=1.0, device="cpu")
    srv.close()
    st = srv.stats()
    assert st["replayed"] == 1 and st["served"] == 1 and st["wal"]["replayed_at_start"] == 1
    (line,) = [r for r in obs.read_jsonl(str(runs)) if r.get("id") == "w2"]
    assert line["replayed"] is True and line["metrics"] == jax_side["rows"][2]
    assert JWal(str(path)).pending() == [] and TWal(str(path)).pending() == []
    jline = jax_side["replay_line"]
    assert jline["replayed"] is True and jline["metrics"] == jax_side["rows"][3]
    assert jax_side["replay_stats"]["replayed"] == 1 and jax_side["wal_after"] == []
    # the access log: JAX's record keys, with the manifest's cache and
    # telemetry blocks under JAX's keys
    assert set(line) == set(jline)
    assert set(line["manifest"]["cache"]) == set(jline["manifest"]["cache"])
    assert set(line["manifest"]["telemetry"]) == set(jline["manifest"]["telemetry"])
    assert set(jax_side["replay_stats"]) <= set(st)


# ------------------------------------------------------ operational --------

def test_degrade_poison_and_quarantine():
    """A chaos fault on the batched dispatch degrades the flush to solo
    dispatch on the same device: the healthy peer is answered (its solo
    answer), the poisoned request is the typed 500 and quarantined; resent,
    it flushes alone (``quarantined-solo``)."""
    good, bad = dict(OPS, seed=1, id="good"), dict(OPS, seed=2, id="bad")
    with inject.controller(7) as ctl:
        ctl.fail_next("sweep.dyn_dispatch")
        ctl.poison("serve.solo_dispatch", "bad")
        with ScenarioServer(max_batch=2, max_wait_ms=1.0, start=False, device="cpu") as srv:
            p1, p2 = srv.submit(good), srv.submit(bad)
            srv.start()
            r1, r2 = p1.result(120), p2.result(120)
            st = srv.stats()
            assert ctl.schedule() == ["sweep.dyn_dispatch:fail", "serve.solo_dispatch:poison"]
            ctl.uninstall()
            r3 = srv.request(dict(bad, seed=3), wait_s=120)
    assert r1["status"] == "ok" and r1["batch"]["mode"] == "degraded-solo"
    assert (r2["code"], r2["kind"]) == (500, "dispatch-failed")
    assert st["degraded_batches"] == 1 and st["quarantined"] == 1
    assert r3["status"] == "ok" and r3["batch"]["mode"] == "quarantined-solo"
    solo = _served(ScenarioServer, [dict(OPS, seed=1)], 1, device="cpu")[0]
    assert r1["metrics"] == solo["metrics"]


def test_breaker_opens_to_solo():
    """One failed batched dispatch (threshold 1) opens the group's breaker:
    the next flush of two is served ``breaker-solo``."""
    with inject.controller(0) as ctl:
        ctl.fail_next("sweep.dyn_dispatch")
        with ScenarioServer(max_batch=2, max_wait_ms=1.0, start=False, device="cpu",
                            breaker_threshold=1, breaker_cooldown_s=600.0) as srv:
            first = [srv.submit(dict(OPS, seed=s)) for s in (1, 2)]
            srv.start()
            r1 = [p.result(120) for p in first]
            second = [srv.submit(dict(OPS, seed=s)) for s in (3, 4)]
            r2 = [p.result(120) for p in second]
            st = srv.stats()
    assert [r["batch"]["mode"] for r in r1] == ["degraded-solo"] * 2
    assert [r["batch"]["mode"] for r in r2 if r["batch"]["size"] == 2] in (
        ["breaker-solo"] * 2, [])
    (br,) = st["breakers"].values()
    assert br["state"] == "open" and br["opens"] == 1


def test_backpressure_health_and_timeout(tmp_path, monkeypatch):
    """429 at a full queue, 503 while the health verdict is not healthy
    (then 200), 504 for a request that waited past ``timeout_s``: each typed
    and access-logged, as JAX's."""
    runs = tmp_path / "runs.jsonl"
    monkeypatch.setenv(obs.RUNS_ENV, str(runs))
    srv = ScenarioServer(max_batch=2, max_wait_ms=1.0, max_queue=1, start=False, device="cpu")
    late = srv.submit(dict(OPS, seed=1, timeout_s=0.01))
    with pytest.raises(QueueFullError) as ei:
        srv.submit(dict(OPS, seed=2, id="overflow"))
    assert ei.value.code == 429
    time.sleep(0.05)
    srv.start()
    resp = late.result(60)
    assert (resp["code"], resp["kind"]) == (504, "timeout")
    srv.set_health("sick")
    with pytest.raises(AdmissionPausedError) as ei:
        srv.submit(dict(OPS, seed=3))
    assert ei.value.code == 503 and srv.paused
    srv.set_health({"verdict": "healthy", "backend": "cpu"})
    assert srv.request(dict(OPS, seed=3), wait_s=120)["status"] == "ok"
    srv.close()
    st = srv.stats()
    assert st["timeouts"] == 1 and st["served"] == 1
    assert st["rejected"] == {"queue-full": 1, "admission-paused": 1}
    kinds = [r.get("kind") for r in obs.read_jsonl(str(runs))]
    assert {"queue-full", "admission-paused", "timeout"} <= set(kinds)


def test_health_log_seeds_admission(tmp_path):
    log = tmp_path / "HEALTH.jsonl"
    log.write_text(json.dumps({"verdict": "healthy"}) + "\n"
                   + json.dumps({"verdict": "wedged"}) + "\n")
    srv = ScenarioServer(health_log=str(log), start=False, device="cpu")
    assert srv.paused and srv.stats()["health"]["verdict"] == "wedged"
    srv.close()


def test_batcher_death_is_supervised_and_close_drains():
    """A ChaosKill at ``serve.batcher`` kills the loop; the supervisor
    restarts it and the queued request is served.  ``close()`` drains: two
    requests waiting on a long ``max_wait_ms`` are dispatched, not dropped."""
    with inject.controller(0) as ctl:
        ctl.kill_next("serve.batcher")
        with ScenarioServer(max_batch=2, max_wait_ms=1.0, device="cpu",
                            restart_backoff_s=0.01) as srv:
            assert srv.request(dict(OPS, seed=1), wait_s=120)["status"] == "ok"
            assert srv.stats()["batcher_restarts"] == 1
    srv = ScenarioServer(max_batch=8, max_wait_ms=600_000.0, device="cpu")
    pends = [srv.submit(dict(OPS, seed=s)) for s in (1, 2)]
    srv.close()
    resps = [p.result(1) for p in pends]
    assert [r["status"] for r in resps] == ["ok", "ok"]
    assert resps[0]["batch"]["mode"] == "batched" and srv.stats()["occupancy"] == {"2": 1}


def test_prewarm_then_warm_requests_miss_nothing(monkeypatch):
    """After ``prewarm`` every bucket's program is a registry entry, built
    without a run: warm requests, solo and batched, add no registry miss,
    and the span tree is JAX's (``serve.request`` over admit, queue_wait,
    batch_wait, dispatch, answer)."""
    with ScenarioServer(max_batch=2, max_wait_ms=1.0, device="cpu") as srv:
        with monkeypatch.context() as m:
            m.setattr(trunner, "_dyn_run", None)  # a run inside prewarm would fail
            walls = srv.prewarm(dict(OPS))
        assert sorted(walls) == ["1", "2"]
        assert {"serve-solo", "sweep-batched-dynf"} <= set(srv.stats()["cache"]["by_factory"])
        before = aotcache.registry.stats()
        with telemetry.capture() as spans:
            assert srv.request(dict(OPS, seed=9), wait_s=120)["status"] == "ok"
        pair = [srv.submit(dict(OPS, seed=s)) for s in (10, 11)]
        assert all(p.result(120)["status"] == "ok" for p in pair)
        after = srv.stats()["cache"]
    assert after["misses"] == before["misses"] and after["hits"] > before["hits"]
    assert {"serve-solo", "sweep-batched-dynf"} <= set(after["by_factory"])
    assert {s["name"] for s in spans} == {"serve.request", "serve.admit", "serve.queue_wait",
                                          "serve.batch_wait", "serve.dispatch", "serve.answer"}


# -------------------------------------------------------------- HTTP -------

def _call(base, path, obj=None):
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(base + path, data=data)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_daemon_in_process():
    """``make_httpd`` on port 0: 200, 422, 400, /stats, /healthz, the health
    push pausing and resuming admission, /metrics, 404."""
    with ScenarioServer(max_batch=2, max_wait_ms=5.0, device="cpu") as srv:
        httpd = make_httpd(srv, "127.0.0.1", 0)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        call = lambda path, obj=None: (lambda c, b: (c, json.loads(b)))(  # noqa: E731
            *_call(base, path, obj))
        code, body = call("/scenario", dict(OPS, seed=1))
        assert code == 200 and body["status"] == "ok"
        code, body = call("/scenario", {"protocol": "mixed", "n": 32, "mixed_shards": 4})
        assert code == 422 and body["kind"] == "unbatchable-config"
        assert call("/scenario", dict(OPS, bogus=1))[0] == 400
        code, body = call("/stats")
        assert code == 200 and body["served"] >= 1 and body["device"] == "cpu"
        assert call("/healthz") == (200, {"ready": True, "health": body["health"]})
        code, body = call("/health", {"verdict": "sick"})
        assert code == 200 and body["paused"]
        assert call("/healthz")[0] == 503
        assert call("/scenario", dict(OPS, seed=2))[0] == 503
        assert call("/health", {})[0] == 400
        assert not call("/health", {"verdict": "healthy"})[1]["paused"]
        code, text = _call(base, "/metrics")
        assert code == 200 and b"blocksim_serve_answered_total" in text
        assert call("/nope")[0] == 404
        httpd.shutdown()
        t.join(timeout=30)


def _env(**kw):
    return {**os.environ, "PYTHONPATH": str(REPO), **kw}


def test_daemon_self_test_on_the_cpu():
    """``python -m blockchain_simulator_tpu_torch.serve --self-test
    --device cpu`` exits 0 with every check true."""
    proc = subprocess.run(
        [sys.executable, "-m", "blockchain_simulator_tpu_torch.serve", "--self-test",
         "--device", "cpu", "--self-test-requests", "2"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=_env())
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["ok"] and all(summary["checks"].values())


def test_default_device_is_the_card(monkeypatch):
    """Without ``device`` the server is built for CUDA: without a card it
    raises at construction; the daemon without ``--device cpu`` exits
    nonzero before its READY line."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ScenarioServer(start=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdispatch.run_batch([parse_request(dict(OPS), "r")], 1)
    proc = subprocess.run(
        [sys.executable, "-m", "blockchain_simulator_tpu_torch.serve", "--port", "0"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=_env(CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and "READY" not in proc.stdout
    assert "CUDA" in proc.stderr


REFUSED = {
    "journal_path": (lambda: ScenarioServer(journal_path="j", device="cpu", start=False),
                     "durable-sweeps slice"),
    "mesh": (lambda: ScenarioServer(mesh=object(), device="cpu", start=False), "slice 6"),
    "run_batch_journal": (lambda: tdispatch.run_batch([parse_request(dict(OPS), "r")], 1,
                                                      journal=object(), device="cpu"),
                          "durable-sweeps slice"),
}


@pytest.mark.parametrize("arm", list(REFUSED))
def test_later_slices_refused(arm):
    fn, match = REFUSED[arm]
    with pytest.raises(NotImplementedError, match=match):
        fn()


@pytest.mark.parametrize("argv,match", [(["--journal", "j.jsonl"], "durable-sweeps slice"),
                                        (["--mesh-sweep", "2"], "slice 6")])
def test_daemon_refusals_exit_2(capsys, argv, match):
    assert serve_main(argv + ["--device", "cpu"]) == 2
    assert match in capsys.readouterr().err


# ------------------------------------------------------------- golden ------

def write_golden():
    """The JAX package's ScenarioServer answers the serve-http requests (one
    submit each, then one start) and config 2 solo."""
    reqs = http_requests()
    http = _served(JServer, reqs, max_batch=8)
    tick = _served(JServer, [dict(TICK_REQ, id="config2")], max_batch=1)[0]
    assert all(r["status"] == "ok" for r in http + [tick])
    doc = {"about": "JAX package (blockchain_simulator_tpu) ScenarioServer answers that the "
                    "PyTorch port's served phases must reproduce bit for bit: the serve-http "
                    "requests (the README's n = 1024 request over f levels and seeds) and "
                    f"BASELINE config 2 served solo. Written by: {WRITTEN_BY}",
           "entries": {
               "serve_http": {"template": HTTP_TPL, "f_values": list(HTTP_F),
                              "seeds": list(HTTP_SEEDS),
                              "metrics": {r["id"]: r["metrics"] for r in http}},
               "serve_tick": {"request": TICK_REQ, "metrics": tick["metrics"],
                              "batch_mode": tick["batch"]["mode"]},
           },
           "jax_version": jax.__version__}
    GOLDEN.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {GOLDEN}", flush=True)


def test_serve_golden_holds_the_phases_requests():
    """The golden chip_smoke.py holds the card to: written by the JAX
    package from the requests above; every answer decides its blocks as
    the f level says, and JAX's served config 2 equals its run
    (``pbft_edge_s0.json``)."""
    doc = json.loads(GOLDEN.read_text())
    assert WRITTEN_BY in doc["about"]
    http, tick = doc["entries"]["serve_http"], doc["entries"]["serve_tick"]
    assert http["template"] == HTTP_TPL and sorted(http["metrics"]) == sorted(
        r["id"] for r in http_requests())
    rounds = HTTP_TPL["sim_ms"] // 50
    assert all(m["blocks_final_all_nodes"] == rounds - 1 and m["agreement_ok"]
               for m in http["metrics"].values())
    edge = json.loads((GOLDEN.parent / "pbft_edge_s0.json").read_text())["entries"]["n1000"]
    assert tick["request"] == TICK_REQ == edge["config"] and tick["batch_mode"] == "solo"
    assert tick["metrics"] == edge["metrics"]


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: python tests/test_torch_serve.py --write-golden")
    jax.config.update("jax_platforms", "cpu")
    write_golden()
