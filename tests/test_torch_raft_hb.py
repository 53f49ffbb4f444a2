"""The port's heartbeat-blocked Raft path, held bit for bit to the JAX package.

Each case runs the same config and seed through the JAX package's
``run_simulation`` (which resolves ``schedule="round"`` to
``models/raft_hb``) and through the port on the CPU, and compares the metrics
and every final-state field.  The cases take the fast branch (the checked
handoff holds after the election prefix) or fall back to the tick engine
(a split election, or setProposal firing inside the prefix), which must then
equal one uninterrupted tick run.  One more case holds the port's heartbeat
path to the port's own tick engine under the milestone contract that
tests/test_raft_hb.py pins for the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from blockchain_simulator_tpu import runner as jrunner
from blockchain_simulator_tpu_torch import convert
from blockchain_simulator_tpu_torch import runner as trunner
from blockchain_simulator_tpu_torch.models import raft_hb as thb
from blockchain_simulator_tpu_torch.utils import config as tconfig
from blockchain_simulator_tpu_torch.utils import threefry
from test_torch_pbft import _cfgs, release_jax_executables, REPO  # noqa: F401 (autouse fixture)

BASE = dict(protocol="raft", n=16, delivery="stat", schedule="round")

# name: (config, whether the handoff holds)
RUNS = {
    # the reference defaults: 49 of 50 blocks, acks one heartbeat behind
    "n16_default": (dict(sim_ms=10_000), True),
    # ser = 0: every ack bin lands inside its own heartbeat step, and
    # replication completes inside the window
    "no_serialization": (dict(sim_ms=4000, model_serialization=False), True),
    "normal_sampler_crashed": (dict(sim_ms=3000, stat_sampler="normal",
                                    faults=dict(n_crashed=5)), True),
    "byzantine_acks": (dict(sim_ms=3000, faults=dict(n_byzantine=4)), True),
    # setProposal fires inside the election prefix (proposal_tick = DISARM
    # at the handoff): the tick engine takes over
    "disarm_fallback": (dict(sim_ms=1500, raft_proposal_delay_ms=50), False),
}


# The JAX side of test_round_run_equals_jax runs in a child process: a test
# worker that has compiled many JAX programs before can die inside XLA:CPU's
# compiler when it compiles the heartbeat program (ROADMAP.md queue C item
# 1); a fresh process compiles only this run's programs.  The child prints
# the metrics and a sha256 of every final-state field (dtype, shape, bytes).
_JAX_CHILD = """
import dataclasses, json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import hashlib
import numpy as np
from blockchain_simulator_tpu import runner
from blockchain_simulator_tpu.utils import config
def digest(a):  # convert.digest, without importing torch here
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()
kw, tick = json.loads(sys.argv[1])
cfg = config.SimConfig(faults=config.FaultConfig(**kw.pop("faults", {})), **kw)
final = runner.final_state(cfg.with_(schedule="tick") if tick else cfg)
print(json.dumps({"metrics": runner.base_model.sim_metrics(cfg, final),
                  "digests": {f.name: digest(np.asarray(getattr(final, f.name)))
                              for f in sorted(dataclasses.fields(final), key=lambda f: f.name)}}))
"""


def _jax_in_child(kw: dict, tick: bool) -> dict:
    """The JAX package's metrics and final-state digests of one config, run
    in a fresh process (``tick``: on the tick engine)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _JAX_CHILD, json.dumps([kw, tick])],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_round_run_equals_jax(name):
    kw, handoff_ok = RUNS[name]
    kw = dict(BASE, **kw)
    jcfg, tcfg = _cfgs(faults=kw.get("faults"), **{k: v for k, v in kw.items() if k != "faults"})
    assert jrunner.use_round_schedule(jcfg) and trunner.use_round_schedule(tcfg)
    # a fallback must equal one uninterrupted run of the JAX tick engine
    want = _jax_in_child(kw, tick=not handoff_ok)
    thb.handoffs_taken = thb.handoffs_refused = 0
    tfinal = trunner.final_state(tcfg, seed=0, device="cpu")
    assert (thb.handoffs_taken, thb.handoffs_refused) == ((1, 0) if handoff_ok else (0, 1))
    assert trunner.sim_metrics(tcfg, tfinal) == want["metrics"]
    assert convert.state_digests(convert.state_to_numpy(tfinal)) == want["digests"]


CONSENSUS = ("n_leaders", "leader", "leader_elected_ms", "blocks", "rounds",
             "agreement_ok", "elections")


def test_port_heartbeat_path_keeps_the_tick_engines_milestones():
    """The raft_hb milestone contract inside the port: one leader, 49 of 50
    blocks, every consensus metric equal to the port's tick engine, the last
    commit within one tick (independent per-engine bucket draws)."""
    kw = dict(BASE, sim_ms=4000)
    hb = trunner.run_simulation(tconfig.SimConfig(**kw), device="cpu")
    tick = trunner.run_simulation(tconfig.SimConfig(**dict(kw, schedule="tick")),
                                  device="cpu")
    for k in CONSENSUS:
        assert hb[k] == tick[k], k
    assert (hb["n_leaders"], hb["blocks"]) == (1, 49)
    assert abs(hb["last_block_ms"] - tick["last_block_ms"]) <= 1


@pytest.mark.parametrize("kw", [
    dict(delivery="edge"),
    dict(fidelity="reference"),
    dict(faults=dict(drop_prob=0.01)),
    dict(queued_links=True),
])
def test_round_schedule_refusals_match_jax(kw):
    kw = dict(BASE, sim_ms=2000, **kw)
    jcfg, tcfg = _cfgs(faults=kw.pop("faults", None), **kw)
    assert not thb.eligible(tcfg)
    with pytest.raises(ValueError, match="raft"):
        jrunner.use_round_schedule(jcfg)
    with pytest.raises(ValueError, match="raft"):
        trunner.use_round_schedule(tcfg)


@pytest.mark.parametrize("n, schedule", [(16, "auto"), (4096, "auto"), (16, "tick")])
def test_schedule_resolution_matches_jax(n, schedule):
    jcfg, tcfg = _cfgs(**dict(BASE, n=n, sim_ms=2000, schedule=schedule))
    assert trunner.use_round_schedule(tcfg) == jrunner.use_round_schedule(jcfg)
    assert trunner.use_round_schedule(tcfg) == (n >= 4096 and schedule == "auto")


def test_probed_runs_raise():
    """The probed heartbeat scan is ported (utils/trace.py): it returns the
    unprobed scan's carry and one int32 sample a heartbeat and shard.
    scan_from_init's probe= (obsim's taps) is ported too: the reduced probes
    come back beside the unprobed run's final state, the prefix's tick
    samples joined to the heartbeat samples (obsim/build.py; the values
    are held to JAX's in tests/test_torch_obsim.py)."""
    from blockchain_simulator_tpu_torch.models import raft
    from blockchain_simulator_tpu_torch.models.base import tick_loop

    _, tcfg = _cfgs(**dict(BASE, sim_ms=2000))
    key = threefry.key(0)
    state0, bufs0 = raft.init(tcfg, threefry.fold_in(key, 0x1217), device="cpu")
    state, bufs = tick_loop(tcfg, state0, bufs0, key, 0, thb.prefix_ticks(tcfg))
    ok, h = thb.handoff(tcfg, thb._shard_view(state))
    assert ok.all()
    out = thb.steady_scan(tcfg, key[None], h)
    probed, ys = thb.steady_scan(tcfg, key[None], h, with_probe=True)
    for a, b in zip(probed, out):
        assert torch.equal(a, b)
    assert sorted(ys) == ["acks_in_window", "blocks", "rounds", "stopped"]
    assert all(v.dtype == torch.int32 and v.shape == (1, thb.n_hb_steps(tcfg))
               for v in ys.values())
    m = thb.prefix_ticks(tcfg) + thb.n_hb_steps(tcfg)
    final, red = thb.scan_from_init(
        tcfg, state0, bufs0, key,
        probe=(lambda st: {"blocks": st.block_num.amax(-1)},
               lambda hy, hst: {"blocks": hy["blocks"]},
               lambda series: {"n": series["blocks"].shape[-1], "last": series["blocks"][-1]}))
    assert red["n"] == m
    plain = thb.scan_from_init(tcfg, *raft.init(tcfg, threefry.fold_in(key, 0x1217),
                                                device="cpu"), key)
    assert int(red["last"]) == int(plain.block_num.max())
    assert all(torch.equal(getattr(final, f), getattr(plain, f)) for f in raft.STATE_FIELDS)
