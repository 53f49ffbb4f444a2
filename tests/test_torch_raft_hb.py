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

import pytest

from blockchain_simulator_tpu import runner as jrunner
from blockchain_simulator_tpu_torch import convert
from blockchain_simulator_tpu_torch import runner as trunner
from blockchain_simulator_tpu_torch.models import raft_hb as thb
from blockchain_simulator_tpu_torch.utils import config as tconfig
from blockchain_simulator_tpu_torch.utils import threefry
from test_torch_pbft import _assert_leaves_equal, _cfgs, _jax_leaves

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


@pytest.mark.parametrize("name", sorted(RUNS))
def test_round_run_equals_jax(name):
    kw, handoff_ok = RUNS[name]
    kw = dict(kw)
    jcfg, tcfg = _cfgs(faults=kw.pop("faults", None), **BASE, **kw)
    assert jrunner.use_round_schedule(jcfg) and trunner.use_round_schedule(tcfg)
    # a fallback must equal one uninterrupted run of the JAX tick engine
    jfinal = jrunner.final_state(jcfg if handoff_ok else jcfg.with_(schedule="tick"))
    thb.handoffs_taken = thb.handoffs_refused = 0
    tfinal = trunner.final_state(tcfg, seed=0, device="cpu")
    assert (thb.handoffs_taken, thb.handoffs_refused) == ((1, 0) if handoff_ok else (0, 1))
    assert trunner.sim_metrics(tcfg, tfinal) == jrunner.base_model.sim_metrics(jcfg, jfinal)
    _assert_leaves_equal(_jax_leaves(jfinal), convert.state_to_numpy(tfinal))


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
    _, tcfg = _cfgs(**dict(BASE, sim_ms=2000))
    with pytest.raises(NotImplementedError, match="traces slice"):
        thb.steady_scan(tcfg, threefry.key(0), None, with_probe=True)
