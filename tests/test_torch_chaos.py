"""The port's chaos drills (``blockchain_simulator_tpu_torch/chaos``), held to
the JAX package's on the CPU.

Every ported scenario and fleet scenario runs twice under one seed at
``device="cpu"``: both normalized summaries must equal each other and the
JAX package's summary for the same scenario, seed and ``quick`` — byte for
byte as canonical JSON (the golden file below).  The fleet scenarios that
use only stub replicas (``fleet-retry-storm``, ``fleet-double-claim``,
``fleet-slow-replica``) also run live against JAX's in this process.  The
invariant checkers return JAX's violation lists on the same ledgers, stats,
access logs, journals, query results and probe summaries.
``cache-corrupt`` is refused, naming ROADMAP.md B-later item 1.  Importing
every new module of the slice leaves no JAX module in a child process.

Golden file: ``blockchain_simulator_tpu_torch/golden/chaos_fleet_s0.json``
holds the JAX package's summaries on the CPU for every scenario the port
runs, with the seed, ``quick``, the template and JAX's version.  Rewrite it
with ``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_chaos.py
--write-golden`` (about two minutes).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import pytest
import torch

from blockchain_simulator_tpu.chaos import fleet_scenarios as jfleet
from blockchain_simulator_tpu.chaos import invariants as jinv
from blockchain_simulator_tpu.chaos import scenarios as jscen
from blockchain_simulator_tpu.parallel import journal as jjournal
from blockchain_simulator_tpu_torch.chaos import fleet_scenarios as tfleet
from blockchain_simulator_tpu_torch.chaos import invariants as tinv
from blockchain_simulator_tpu_torch.chaos import scenarios as tscen
from blockchain_simulator_tpu_torch.parallel import journal as tjournal
from blockchain_simulator_tpu_torch.utils import obs
from test_torch_pbft import REPO, release_jax_executables  # noqa: F401 (autouse fixture)
from test_torch_query import one_torch_thread  # noqa: F401 (module fixture)

GOLDEN = REPO / "blockchain_simulator_tpu_torch" / "golden" / "chaos_fleet_s0.json"
WRITTEN_BY = "PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_chaos.py --write-golden"
SEED = 0
QUICK = True
# refused in the port until aotcache's on-disk layer (ROADMAP.md B-later item 1)
REFUSED = ("cache-corrupt",)
PORTED = [n for n in jscen.SCENARIOS if n not in REFUSED]
FLEET = list(jfleet.FLEET_SCENARIOS)
STUB_ONLY = ("fleet-retry-storm", "fleet-double-claim", "fleet-slow-replica")


def _dir(path) -> str:
    path.mkdir(parents=True, exist_ok=True)
    return str(path)


def _canon(summary) -> str:
    return obs.canonical_json(json.loads(json.dumps(summary)))


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def test_golden_lists_every_scenario_and_the_template(golden):
    """The golden covers JAX's catalogs minus the refusal, at JAX's template,
    and the port's catalogs carry JAX's names."""
    assert golden["seed"] == SEED and golden["quick"] is QUICK
    assert golden["template"] == jscen.TPL == tscen.TPL
    assert sorted(golden["scenarios"]) == sorted(PORTED)
    assert sorted(golden["fleet_scenarios"]) == sorted(FLEET)
    assert list(tscen.SCENARIOS) == list(jscen.SCENARIOS)
    assert list(tfleet.FLEET_SCENARIOS) == list(jfleet.FLEET_SCENARIOS)


@pytest.mark.parametrize("name", PORTED)
def test_scenario_equals_jax_and_itself(name, golden, tmp_path):
    runs = [tscen.run_scenario(name, SEED, workdir=_dir(tmp_path / f"run{i}"), quick=QUICK,
                               device="cpu") for i in range(2)]
    assert runs[0]["violations"] == [], runs[0]["violations"]
    assert _canon(runs[0]) == _canon(runs[1])
    assert _canon(runs[0]) == _canon(golden["scenarios"][name])


@pytest.mark.parametrize("name", FLEET)
def test_fleet_scenario_equals_jax_and_itself(name, golden, tmp_path):
    runs = [tfleet.run_fleet_scenario(name, SEED, workdir=_dir(tmp_path / f"run{i}"),
                                      quick=QUICK, device="cpu") for i in range(2)]
    assert runs[0]["violations"] == [], runs[0]["violations"]
    assert _canon(runs[0]) == _canon(runs[1])
    assert _canon(runs[0]) == _canon(golden["fleet_scenarios"][name])


@pytest.mark.parametrize("name", STUB_ONLY)
def test_stub_fleet_scenario_live_against_jax(name, tmp_path):
    """Stub replicas only: no dispatch, so JAX's router and the port's run
    the same scenario side by side in this process (seed 11, JAX's own
    tests' seed)."""
    want = jfleet.run_fleet_scenario(name, 11, workdir=_dir(tmp_path / "jax"))
    got = tfleet.run_fleet_scenario(name, 11, workdir=_dir(tmp_path / "port"), device="cpu")
    assert want["violations"] == []
    assert _canon(got) == _canon(want)


def test_cache_corrupt_is_refused_naming_the_roadmap_item(tmp_path):
    with pytest.raises(NotImplementedError, match="B-later item 1"):
        tscen.run_scenario("cache-corrupt", SEED, workdir=str(tmp_path), device="cpu")


# ---------------------------------------------------------- the checkers ---


def _ledger(mod, entries):
    led = mod.Ledger()
    for rid, outcomes in entries:
        led.submitted(rid)
        for kind in outcomes:
            led.record(rid, {"status": "ok"} if kind == "ok"
                       else {"status": "error", "kind": kind})
    return led


_STATS = {"received": 2, "served": 2, "errors": 0, "timeouts": 0, "replayed": 0,
          "rejected": {}, "queue_depth": 0}
SERVER_CASES = {
    "clean": ([("a", ["ok"])], dict(_STATS, received=1, served=1), None, ()),
    "lost-and-double": ([("lost", []), ("double", ["ok", "ok"])], _STATS, None, ()),
    "retry-attempts": ([("r", ["dispatch-failed"]), ("r", ["dispatch-failed"])],
                       dict(_STATS, served=0, errors=2), None, ()),
    "unbalanced": (None, dict(_STATS, received=3, served=1, queue_depth=1), None, ()),
    "missing-log-line": ([("seen", ["ok"]), ("unseen", ["ok"])], _STATS,
                         [{"id": "seen", "status": "ok"}], ()),
    "replayed-unmarked": (None, _STATS, [{"id": "seen", "status": "ok"}], ("seen",)),
    "replayed-marked": (None, dict(_STATS, received=1, replayed=1),
                        [{"id": "seen", "status": "ok", "replayed": True}], ("seen",)),
    "rejected-balance": ([("q", ["queue-full"])],
                         dict(_STATS, received=1, served=0, rejected={"queue-full": 1}),
                         [{"id": "q", "status": "error"}], ()),
}


@pytest.mark.parametrize("case", sorted(SERVER_CASES))
def test_check_server_equals_jax(case, tmp_path):
    entries, stats, log, replayed = SERVER_CASES[case]
    path = None
    if log is not None:
        path = tmp_path / "access.jsonl"
        path.write_text("".join(json.dumps(r) + "\n" for r in log))
        path = str(path)
    reg_b, reg_a = {"hits": 5, "misses": 2}, {"hits": 9, "misses": 1}
    want = jinv.check_server(None if entries is None else _ledger(jinv, entries), stats,
                             log_path=path, registry_before=reg_b, registry_after=reg_a,
                             replayed_ids=replayed)
    got = tinv.check_server(None if entries is None else _ledger(tinv, entries), stats,
                            log_path=path, registry_before=reg_b, registry_after=reg_a,
                            replayed_ids=replayed)
    assert got == want and want  # every case trips at least the registry rule
    if entries is not None:
        assert _ledger(tinv, entries).kinds() == _ledger(jinv, entries).kinds()


def _snap(**counters):
    return {"counters": counters, "spans": 0}


TELEMETRY_CASES = {
    "balanced": (_snap(), _snap(blocksim_serve_received_total=3,
                                **{'blocksim_serve_answered_total{kind="ok"}': 2},
                                **{'blocksim_serve_rejected_total{kind="queue-full"}': 1}), 0),
    "crash-allowance": (_snap(), _snap(blocksim_serve_received_total=3,
                                       blocksim_serve_replayed_total=3,
                                       **{'blocksim_serve_answered_total{kind="ok"}': 3}), 3),
    "off-by-one": (_snap(), _snap(blocksim_serve_received_total=2,
                                  **{'blocksim_serve_answered_total{kind="ok"}': 1}), 0),
    "backwards": (_snap(blocksim_serve_received_total=4), _snap(blocksim_serve_received_total=1),
                  0),
}


@pytest.mark.parametrize("case", sorted(TELEMETRY_CASES))
def test_check_telemetry_equals_jax(case):
    before, after, lost = TELEMETRY_CASES[case]
    assert tinv.check_telemetry(before, after, lost) == jinv.check_telemetry(before, after, lost)


def test_normalize_spans_equals_jax():
    spans = [
        {"kind": "span", "trace": "t1", "id": "r", "parent": None, "name": "router.request",
         "status": "ok", "attrs": {"id": "x", "outcome": "ok", "replayed": None, "ms": 3}},
        {"kind": "span", "trace": "t1", "id": "s", "parent": "r", "name": "router.send",
         "status": "ok", "attrs": {"id": "x", "hedge": True, "attempt": 0}},
        {"kind": "span", "trace": "t1", "id": "q", "parent": "s", "name": "serve.request",
         "status": "error", "attrs": {"id": "x", "outcome": "timeout"}},
        {"kind": "span", "trace": "t2", "id": "c", "parent": None, "name": "sweep.chunk",
         "status": "ok", "attrs": {"key": "k"}},
        {"kind": "event", "name": "noise"},
        {"kind": "span", "trace": "t3", "id": "l", "parent": "l", "name": "loop",
         "status": "ok", "attrs": {"replay": True}},
    ]
    assert tinv.normalize_spans(spans) == jinv.normalize_spans(spans)
    assert len(tinv.normalize_spans(spans)) == 4


FLEET_CASES = {
    "clean": ({"received": 2, "answered": {"ok": 2},
               "handoffs": [{"wal": "w", "claimed": True, "replayed": ["a"],
                             "redispatched": ["b"]}]}, ["a", "b"],
              [{"id": "a", "replayed": True}, {"id": "b", "replayed": True}]),
    "unanswered": ({"received": 3, "answered": {"ok": 2}, "handoffs": []}, [], None),
    "double-claim": ({"received": 0, "answered": {},
                      "handoffs": [{"wal": "w", "claimed": True, "replayed": ["a"]},
                                   {"wal": "w", "claimed": True, "replayed": ["a"]}]},
                     ["a", "z"], [{"id": "a", "replayed": True}]),
    "log-marks": ({"received": 0, "answered": {},
                   "handoffs": [{"wal": "w", "claimed": True, "replayed": ["a", "b"]}]},
                  ["a", "b"], [{"id": "a", "replayed": True}, {"id": "a", "replayed": True},
                               {"id": "b"}]),
}


@pytest.mark.parametrize("case", sorted(FLEET_CASES))
def test_check_fleet_equals_jax(case, tmp_path):
    stats, ids, log = FLEET_CASES[case]
    path = None
    if log is not None:
        path = tmp_path / "access.jsonl"
        path.write_text("".join(json.dumps(r) + "\n" for r in log))
        path = str(path)
    entries = [("a", ["ok"]), ("b", [])]
    want = jinv.check_fleet(_ledger(jinv, entries), stats, log_path=path, handoff_ids=ids)
    got = tinv.check_fleet(_ledger(tinv, entries), stats, log_path=path, handoff_ids=ids)
    assert got == want and want


def test_check_sweep_journal_equals_jax(tmp_path):
    """A journal with a duplicated chunk, a row that fails its checksum, a
    missing expected key and an unknown event, read through each package's
    journal class."""
    path = str(tmp_path / "j.jsonl")
    j = tjournal.SweepJournal(path)
    j.append_chunk("k0", 0, [{"x": 1}, {"x": 2}])
    j.append_chunk("k0", 0, [{"x": 1}, {"x": 2}])
    j.append_chunk("k1", 1, [{"y": 1.5}])
    j.append_event("k1", "deadline", attempt=1)
    j.append_event("k1", "nonsense")
    j.close()
    with open(path) as f:
        lines = f.read().splitlines()
    bad = json.loads(lines[2])
    bad["rows"][0]["y"] = 2.5  # bit rot that still parses
    with open(path, "a") as f:
        f.write(json.dumps(dict(bad, key="k2")) + "\n")
    for rows in (None, 3, 5):
        want = jinv.check_sweep_journal(jjournal.SweepJournal(path), ("k0", "k1", "k9"), rows)
        got = tinv.check_sweep_journal(tjournal.SweepJournal(path), ("k0", "k1", "k9"), rows)
        assert got == want and want


QUERY_CASES = {
    "clean": {"query": {"kind": "max_f_surviving", "seeds": [0]},
              "answer": {"f_max": 2, "first_failing": 3},
              "trail": [{"step": 0, "values": [0, 5], "verdicts": [[0, True], [5, False]],
                         "keys": ["a+q0"]},
                        {"step": 1, "values": [2, 3], "verdicts": [[2, True], [3, False]],
                         "keys": ["b+q1"]}],
              "points": [{"value": v, "seed": 0} for v in (0, 5, 2, 3)],
              "run": {"monotonicity_violations": 0}},
    "broken": {"query": {"kind": "cliff_locate", "seeds": [0, 1]},
               "answer": {"last_true": 5, "first_false": 9},
               "trail": [{"step": 1, "values": [0, 5], "verdicts": [[0, True]],
                          "keys": ["a+q1"]},
                         {"step": 1, "values": [9, 5], "verdicts": [[9, True], [5, False]],
                          "keys": ["b"]}],
               "points": [{"value": 0, "seed": 0}, {"value": 0, "seed": 0}],
               "run": {"monotonicity_violations": 2}},
    "min-k": {"query": {"kind": "min_k_finality", "seeds": [0]},
              "answer": {"last_failing": 4, "k_min": 5},
              "trail": [{"step": 0, "values": [4, 5], "verdicts": [[4, True], [5, False]],
                         "keys": []}],
              "run": {}},
    "empty": {"trail": []},
}


@pytest.mark.parametrize("case", sorted(QUERY_CASES))
def test_check_query_trail_equals_jax(case):
    res = QUERY_CASES[case]
    for monotone in (True, False):
        assert tinv.check_query_trail(res, expect_monotone=monotone) == \
            jinv.check_query_trail(res, expect_monotone=monotone)


def test_check_consensus_probes_equals_jax():
    summaries = [
        {"protocol": "pbft", "topology": "dense", "violations": 0,
         "monitors": {"viol_agreement": 0, "viol_quorum": 0, "liveness_lag": [[3, 9], [2]]}},
        {"probe": {"protocol": "raft", "topology": "gossip", "violations": 2,
                   "monitors": {"viol_agreement": 2, "viol_quorum": 0, "liveness_lag": 1}}},
        {"protocol": "paxos", "topology": "dense"},
        "not a dict",
    ]
    for max_lag in (None, 4):
        want = jinv.check_consensus_probes(summaries, max_lag=max_lag)
        assert tinv.check_consensus_probes(summaries, max_lag=max_lag) == want and want


def test_registry_monotone_equals_jax():
    before = {"hits": 5, "misses": 2, "corrupt_healed": 0}
    for after in (dict(before, hits=9), dict(before, misses=1), {}):
        assert tinv.registry_monotone(before, after) == jinv.registry_monotone(before, after)


def test_new_modules_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "from blockchain_simulator_tpu_torch.chaos import invariants, scenarios, "
        "fleet_scenarios\n"
        "from blockchain_simulator_tpu_torch.serve import fleet, router\n"
        "import blockchain_simulator_tpu_torch.chaos as c\n"
        "assert c.Ledger and c.check_fleet and c.check_server and c.registry_monotone\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'blockchain_simulator_tpu'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def write_golden() -> None:
    import tempfile

    torch.set_num_threads(1)
    out = {"about": "JAX package (blockchain_simulator_tpu) chaos drill summaries on the "
                    "CPU that the PyTorch port's scenarios must reproduce byte for byte "
                    "as canonical JSON. Written by: " + WRITTEN_BY,
           "jax_version": jax.__version__, "seed": SEED, "quick": QUICK,
           "template": jscen.TPL, "scenarios": {}, "fleet_scenarios": {}}
    with tempfile.TemporaryDirectory() as d:
        for name in PORTED:
            os.makedirs(os.path.join(d, name))
            rep = jscen.run_scenario(name, SEED, workdir=os.path.join(d, name), quick=QUICK)
            assert rep["violations"] == [], (name, rep["violations"])
            out["scenarios"][name] = json.loads(json.dumps(rep))
            print(name, "done", flush=True)
        for name in FLEET:
            os.makedirs(os.path.join(d, name))
            rep = jfleet.run_fleet_scenario(name, SEED, workdir=os.path.join(d, name),
                                            quick=QUICK)
            assert rep["violations"] == [], (name, rep["violations"])
            out["fleet_scenarios"][name] = json.loads(json.dumps(rep))
            print(name, "done", flush=True)
    GOLDEN.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-golden"]:
        jax.config.update("jax_platforms", "cpu")
        write_golden()
    else:
        sys.exit("usage: " + WRITTEN_BY)
