"""The port's round-blocked PBFT fast path, held bit for bit to the JAX package.

Each case runs the same config and seed through the JAX package's
``run_simulation`` (which resolves it to ``models/pbft_round``) and through
the port on the CPU, and compares the metrics and every final-state field.
The cases mirror tests/test_pbft_round.py (which holds the JAX fast path to
the JAX tick engine); here each is held to the JAX run of the same config.
Both samplers are held bit for bit: ``"exact"`` (below n = 4096) and
``"normal"`` (the Philox stream, at n = 4096 under ``"auto"``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blockchain_simulator_tpu import runner as jrunner
from blockchain_simulator_tpu.models import pbft_round as jround
from blockchain_simulator_tpu_torch import convert
from blockchain_simulator_tpu_torch import runner as trunner
from blockchain_simulator_tpu_torch.models import pbft_round as tround
from blockchain_simulator_tpu_torch.utils import prng as tprng
from blockchain_simulator_tpu_torch.utils import threefry
from test_torch_pbft import (  # noqa: F401 (release_jax_executables: autouse)
    _assert_leaves_equal, _cfgs, _jax_leaves, release_jax_executables, ROUND_CONFIGS,
)

# serialization off: rounds must close inside one block interval
BASE = dict(protocol="pbft", delivery="stat", model_serialization=False)


RUNS = {
    "n16_clean": dict(n=16, sim_ms=600, schedule="round"),
    "n16_reference": dict(n=16, sim_ms=600, schedule="round", fidelity="reference"),
    "n64_no_view_changes": dict(n=64, sim_ms=400, schedule="round",
                                pbft_view_change_num=0),
    "n64_reference_normal": dict(n=64, sim_ms=600, schedule="round",
                                 fidelity="reference", stat_sampler="normal"),
    "n1024": dict(n=1024, sim_ms=300, schedule="round"),
    "crashed": dict(n=64, sim_ms=400, schedule="round", faults=dict(n_crashed=8)),
    "byzantine_2f1": dict(n=64, sim_ms=400, schedule="round", quorum_rule="2f1",
                          faults=dict(n_byzantine=21)),
    "byzantine_stall": dict(n=64, sim_ms=300, schedule="round",
                            faults=dict(n_byzantine=40)),
    "drops_no_view_changes": dict(n=64, sim_ms=400, schedule="round",
                                  pbft_view_change_num=0, faults=dict(drop_prob=0.1)),
    # the final wave is cut mid-flight by the window end
    "truncated_final_wave": dict(n=64, sim_ms=2465, pbft_max_rounds=60,
                                 schedule="round", stat_sampler="normal"),
    "n4096_auto": dict(n=4096, sim_ms=600),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_equals_jax(name):
    kw = dict(RUNS[name])
    jcfg, tcfg = _cfgs(faults=kw.pop("faults", None), **BASE, **kw)
    assert jrunner.use_round_schedule(jcfg) and trunner.use_round_schedule(tcfg)
    jfinal = jrunner.final_state(jcfg)
    tfinal = trunner.final_state(tcfg, device="cpu")
    assert isinstance(tfinal, tround.PbftRoundState)
    assert trunner.sim_metrics(tcfg, tfinal) == jrunner.base_model.sim_metrics(jcfg, jfinal)
    _assert_leaves_equal(_jax_leaves(jfinal), convert.state_to_numpy(tfinal))


def test_serialization_companion_equals_jax():
    """bench._cfg_ser's shape at small n: a 200 ms interval that fits the
    160-tick block serialization, so the round path stays eligible."""
    jcfg, tcfg = _cfgs(protocol="pbft", n=64, sim_ms=6 * 200 + 250, pbft_max_rounds=6,
                       pbft_max_slots=14, pbft_window=8, delivery="stat",
                       model_serialization=True, pbft_block_interval_ms=200,
                       pbft_tx_speed=300, stat_sampler="normal")
    assert tcfg.serialization_ticks(tcfg.pbft_block_bytes) == 160
    jfinal = jrunner.final_state(jcfg)
    tfinal = trunner.final_state(tcfg, device="cpu")
    assert trunner.sim_metrics(tcfg, tfinal) == jrunner.base_model.sim_metrics(jcfg, jfinal)
    _assert_leaves_equal(_jax_leaves(jfinal), convert.state_to_numpy(tfinal))


@pytest.mark.parametrize("sampler", ["exact", "normal"])
def test_step_round_from_carried_state(sampler):
    """One round from a mid-run JAX state, carried across."""
    jcfg, tcfg = _cfgs(**BASE, n=32, sim_ms=800, schedule="round", stat_sampler=sampler)
    key = jax.random.key(0)
    r = 6  # the state after rounds 1..5, then round 6 in both packages
    jstate, _ = jround.init(jcfg)
    jstate = jround.scan_rounds(jcfg.with_(sim_ms=r * jcfg.pbft_block_interval_ms),
                                jstate, key)
    tstate, _ = convert.state_from_numpy(tcfg, _jax_leaves(jstate), None, "cpu")
    js = jax.jit(lambda st: jround.step_round(jcfg, st, jnp.int32(r), key))(jstate)
    tkey = tprng.tick_key(threefry.key(0), r * tcfg.pbft_block_interval_ms)
    ts = tround.step_round(tcfg, tstate, r, tkey)
    assert int(np.asarray(js.next_n).max()) == r
    _assert_leaves_equal(_jax_leaves(js), convert.state_to_numpy(ts))


GRID_EXTRAS = ({}, dict(model_serialization=False),
               dict(model_serialization=False, faults=dict(drop_prob=0.1)),
               dict(model_serialization=False, pbft_view_change_num=0,
                    faults=dict(drop_prob=0.1)),
               dict(model_serialization=False, faults=dict(n_byzantine=1, byz_forge=True)),
               dict(model_serialization=False, topology="kregular", degree=8))


@pytest.mark.parametrize("schedule", ["auto", "round", "tick"])
def test_use_round_schedule_matches_jax(schedule):
    """The schedule resolution, ValueError cases included, over a grid of
    sizes, delivery arms, faults and topologies."""
    for n in (64, 4096):
        for delivery in ("stat", "edge"):
            for extra in GRID_EXTRAS:
                _check_schedule(dict(extra, schedule=schedule, n=n, delivery=delivery))


def _check_schedule(kw):
    jcfg, tcfg = _cfgs(protocol="pbft", sim_ms=100, faults=kw.pop("faults", None), **kw)
    try:
        want = jrunner.use_round_schedule(jcfg)
    except ValueError:
        with pytest.raises(ValueError):
            trunner.use_round_schedule(tcfg)
        return
    assert trunner.use_round_schedule(tcfg) == want, kw


def test_headline_config_resolves_to_the_round_path():
    """bench._cfg(2000): the round path with the "normal" sampler, in both
    packages."""
    jcfg, tcfg = _cfgs(**ROUND_CONFIGS["n100k"])
    assert jrunner.use_round_schedule(jcfg) and trunner.use_round_schedule(tcfg)
    assert tcfg.eff_stat_sampler == "normal"
    assert len(tround.round_range(tcfg)) == 2001  # the last round sends nothing


def test_probe_and_raft_refused():
    """Probed round runs are ported (utils/trace.py, tests/test_torch_trace.py);
    probed lane batches (the sweeps' probe=, obsim) still raise, naming the
    durable-sweeps slice.  The mixed sim resolves its schedule as JAX does."""
    _, tcfg = _cfgs(**BASE, n=16, sim_ms=200, schedule="round")
    state, _ = tround.init(tcfg, device="cpu")
    final, ys = tround.scan_rounds(tcfg, state, threefry.key(0), with_probe=True)
    assert len(ys["rounds_sent"]) == len(tround.round_range(tcfg))
    assert int(ys["rounds_sent"][-1]) == int(final.next_n.max())
    lanes = np.stack([threefry.key(0), threefry.key(1)])
    state, _ = tround.init(tcfg, lanes, device="cpu")
    with pytest.raises(NotImplementedError, match="durable-sweeps slice"):
        tround.scan_rounds(tcfg, state, lanes, with_probe=True)
    jcfg, rcfg = _cfgs(protocol="mixed", n=16, mixed_shards=2, sim_ms=200, delivery="stat")
    assert trunner.use_round_schedule(rcfg) == jrunner.use_round_schedule(jcfg)
