"""The port's fleet and chaos drills on the card.

The CPU runs are held to the JAX package by tests/test_torch_fleet.py and
tests/test_torch_chaos.py; here the card is held to the JAX goldens.  Every
case is marked ``cuda`` and skips without a card.  This file imports no JAX
code:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_card_fleet.py -m cuda
"""

from __future__ import annotations

import json
import pathlib

import pytest
import torch

from blockchain_simulator_tpu_torch.chaos import fleet_scenarios, scenarios
from blockchain_simulator_tpu_torch.serve.fleet import FleetManager
from blockchain_simulator_tpu_torch.utils import obs

GOLDEN_DIR = pathlib.Path(__file__).resolve().parent.parent / "blockchain_simulator_tpu_torch" \
    / "golden"


@pytest.fixture
def cuda_device():
    # decided here, never at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the H100: JAX_PLATFORMS=cpu "
                    "python -m pytest tests/test_torch_card_fleet.py -m cuda")
    return "cuda"


@pytest.mark.cuda
def test_card_fleet_kill9_leg_with_restart(cuda_device, tmp_path, monkeypatch):
    """Two replica processes on the card at the serving workload (PBFT,
    n = 1,024, the serve-http template): the victim's three admitted
    requests are each answered once, replayed by the peer, equal to
    golden/serve_s0.json; the restarted victim replays 0; a later request
    answers equal to the golden."""
    entry = json.loads((GOLDEN_DIR / "serve_s0.json").read_text())["entries"]["serve_http"]
    tpl, want = entry["template"], entry["metrics"]
    reqs = {k: dict(tpl, id=k, seed=int(k.split("-s")[1]),
                    faults={"n_byzantine": int(k[1:].split("-")[0])}) for k in want}
    log = str(tmp_path / "access.jsonl")
    monkeypatch.setenv(obs.RUNS_ENV, log)
    # the router's own lines (the replays' marks) take this process's
    # manifest: with CUDA initialized here it names the card too
    torch.cuda.init()
    mgr = FleetManager(2, str(tmp_path / "fleet"), max_batch=8, max_wait_ms=5000.0,
                       device=cuda_device, prewarm=tpl, env={obs.RUNS_ENV: log})
    try:
        mgr.start(timeout_s=600.0)
        rec = fleet_scenarios.kill9_leg(mgr, [reqs["f10-s0"], reqs["f10-s1"], reqs["f0-s2"]],
                                        reqs["f1-s0"], timeout_s=600.0)
        mgr.close()
    finally:
        mgr.kill_all()
    assert rec["violations"] == [], rec["violations"]
    assert rec["ready"]["replayed"] == 0
    got = dict(rec["answers"], **{"f1-s0": rec["post"]})
    assert {k: b["metrics"] for k, b in got.items()} == {k: want[k] for k in got}
    name = torch.cuda.get_device_name(0)
    assert {(r["manifest"].get("backend"), r["manifest"].get("device"))
            for r in obs.read_jsonl(log)} == {("cuda", name)}


@pytest.mark.cuda
def test_card_query_kill9_drill_equals_jax(cuda_device, tmp_path):
    """The query-kill9 drill on the card, twice under the golden's seed:
    both summaries equal the JAX package's (golden/chaos_fleet_s0.json)."""
    golden = json.loads((GOLDEN_DIR / "chaos_fleet_s0.json").read_text())
    want = obs.canonical_json(golden["scenarios"]["query-kill9"])
    for i in range(2):
        work = tmp_path / f"run{i}"
        work.mkdir()
        rep = scenarios.run_scenario("query-kill9", golden["seed"], workdir=str(work),
                                     quick=golden["quick"], device=cuda_device)
        assert rep["violations"] == []
        assert obs.canonical_json(json.loads(json.dumps(rep))) == want
