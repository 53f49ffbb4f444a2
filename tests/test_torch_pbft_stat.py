"""The port's PBFT tick engine on the stat arm, held bit for bit to JAX.

With ``delivery="stat"`` the tick engine's four channels draw multinomial
bucket counts (ops/delivery.py stat functions) instead of per-edge delays,
and still feed the tick's one grouped ring push.  Each case runs the same
config and seed in both packages and compares the metrics and every
final-state field, under both samplers: ``"exact"`` (``jax.random.binomial``
replayed with XLA:CPU's float32 arithmetic) and ``"normal"`` (the Philox
stream).  One more test holds the port's round path to the port's tick
engine under the contract tests/test_pbft_round.py pins for the JAX package.
"""

from __future__ import annotations

import pytest

from blockchain_simulator_tpu import runner as jrunner
from blockchain_simulator_tpu_torch import convert
from blockchain_simulator_tpu_torch import runner as trunner
from blockchain_simulator_tpu_torch.utils import config as tconfig
from test_torch_pbft import _assert_leaves_equal, _cfgs, _jax_leaves


RUNS = {
    "n8_exact": dict(n=8, sim_ms=400),
    "n16_normal_reference": dict(n=16, sim_ms=400, stat_sampler="normal",
                                 fidelity="reference"),
    "n16_exact_drops": dict(n=16, sim_ms=350, faults=dict(drop_prob=0.1)),
    "n16_windowed_drops": dict(n=16, sim_ms=800, pbft_window=8, pbft_max_slots=48,
                               model_serialization=False, stat_sampler="normal",
                               faults=dict(drop_prob=0.05)),
    "n64_normal": dict(n=64, sim_ms=300, stat_sampler="normal"),
    "n64_exact_byzantine_2f1": dict(n=64, sim_ms=300, quorum_rule="2f1",
                                    model_serialization=False,
                                    faults=dict(n_byzantine=10)),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_tick_stat_run_equals_jax(name):
    kw = dict(RUNS[name])
    jcfg, tcfg = _cfgs(protocol="pbft", delivery="stat", schedule="tick",
                       faults=kw.pop("faults", None), **kw)
    jfinal = jrunner.final_state(jcfg)
    tfinal = trunner.final_state(tcfg, device="cpu")
    assert trunner.sim_metrics(tcfg, tfinal) == jrunner.base_model.sim_metrics(jcfg, jfinal)
    _assert_leaves_equal(_jax_leaves(jfinal), convert.state_to_numpy(tfinal))


MILESTONES = ("rounds_sent", "blocks_final_all_nodes", "view_changes",
              "block_num_max", "agreement_ok")


@pytest.mark.parametrize("fidelity", ["clean", "reference"])
def test_port_round_path_keeps_the_tick_engines_milestones(fidelity):
    """Tier a: counts and milestones bit-equal between the port's two
    engines in a drop-free config; finality times within the delay
    quantization slack (tests/test_pbft_round.py's bounds)."""
    base = dict(protocol="pbft", n=64, sim_ms=1000, delivery="stat",
                model_serialization=False, fidelity=fidelity, stat_sampler="normal")
    tick = trunner.run_simulation(tconfig.SimConfig(**base, schedule="tick"), device="cpu")
    rnd = trunner.run_simulation(tconfig.SimConfig(**base, schedule="round"), device="cpu")
    for k in MILESTONES:
        assert rnd[k] == tick[k], k
    assert abs(rnd["mean_time_to_finality_ms"] - tick["mean_time_to_finality_ms"]) < 3.0
    assert abs(rnd["last_commit_ms"] - tick["last_commit_ms"]) <= 50.0
