"""The PyTorch port's PBFT tick engine, held bit for bit to the JAX package.

Every comparison is exact: the edge arm is integer arithmetic over threefry
bits, so metrics and every final-state field must be equal.  The port runs on
the CPU here (``device="cpu"``: its plain versions); its run on the card is
held to the CPU run in tests/test_torch_ring.py (marked ``cuda``) and to the
golden file by ``chip_smoke.py``.

The golden files under ``blockchain_simulator_tpu_torch/golden/`` hold the
JAX package's metrics and per-field state digests: ``pbft_edge_s0.json`` for
the edge tick engine at n = 8 and n = 1000, ``pbft_round_n100k_s0.json`` for
the round-blocked fast path at the bench headline (``bench._cfg(2000)``,
n = 100,000) and ``pbft_stat_n1000_1000ms_s0.json`` for the tick engine's
stat arm at n = 1000.  ``chip_smoke.py`` holds the port's runs on the card to them.
Regenerate them with ``python tests/test_torch_pbft.py --write-golden``
(a few minutes of JAX on the CPU).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockchain_simulator_tpu import runner as jrunner
from blockchain_simulator_tpu.models import pbft as jpbft
from blockchain_simulator_tpu.utils import config as jconfig
from blockchain_simulator_tpu.utils import prng as jprng
from blockchain_simulator_tpu_torch import convert
from blockchain_simulator_tpu_torch import runner as trunner
from blockchain_simulator_tpu_torch.models import pbft as tpbft
from blockchain_simulator_tpu_torch.utils import config as tconfig
from blockchain_simulator_tpu_torch.utils import prng as tprng
from blockchain_simulator_tpu_torch.utils import threefry

REPO = pathlib.Path(__file__).resolve().parent.parent


# every test process collects this file: the plugin frees JAX's compiled
# programs after any of its tests once the process nears its mapping limit
pytest_plugins = ["jax_mappings"]


@pytest.fixture(autouse=True)
def release_jax_executables():
    """After each test, free the JAX programs this process has compiled once
    it nears its limit on memory mappings (tests/jax_mappings.py; every
    port test file that runs the JAX package imports this fixture, so a
    file run on its own, without this one collected, frees them too)."""
    yield
    import jax_mappings  # after pytest has imported it as a plugin

    jax_mappings.release_if_high()


GOLDEN_DIR = REPO / "blockchain_simulator_tpu_torch" / "golden"
GOLDEN = GOLDEN_DIR / "pbft_edge_s0.json"
GOLDEN_CONFIGS = {
    "n8": dict(protocol="pbft", n=8, sim_ms=2500),
    "n1000": dict(protocol="pbft", n=1000, sim_ms=2500),
}
# bench._cfg(2000): the project's headline workload, field for field
ROUND_GOLDEN = GOLDEN_DIR / "pbft_round_n100k_s0.json"
ROUND_CONFIGS = {
    "n100k": dict(protocol="pbft", n=100_000, sim_ms=100_100, pbft_max_rounds=2000,
                  pbft_max_slots=2008, pbft_window=8, delivery="stat",
                  model_serialization=False),
}
# the n = 1000 tick-engine config on the stat arm ("auto" sampler: exact),
# its window cut from 2,500 to 1,000 ms (15 blocks, the first view change)
# for chip_smoke.py's time limit
STAT_GOLDEN = GOLDEN_DIR / "pbft_stat_n1000_1000ms_s0.json"
STAT_CONFIGS = {
    "n1000": dict(protocol="pbft", n=1000, sim_ms=1000, delivery="stat",
                  schedule="tick"),
}


def _cfgs(faults=None, **kw):
    """The same config in both packages."""
    faults = faults or {}
    return (jconfig.SimConfig(faults=jconfig.FaultConfig(**faults), **kw),
            tconfig.SimConfig(faults=tconfig.FaultConfig(**faults), **kw))


def _jax_leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _assert_leaves_equal(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def golden_entry(name: str, seed: int = 0, configs=GOLDEN_CONFIGS) -> dict:
    """One golden entry, computed by the JAX package."""
    jcfg = jconfig.SimConfig(**configs[name])
    final = jrunner.final_state(jcfg, seed=seed)
    return {
        "config": configs[name],
        "seed": seed,
        "jax_version": jax.__version__,
        "metrics": jrunner.base_model.sim_metrics(jcfg, final),
        "state_sha256": convert.state_digests(_jax_leaves(final)),
    }


def write_golden():
    for path, configs in ((GOLDEN, GOLDEN_CONFIGS), (ROUND_GOLDEN, ROUND_CONFIGS),
                          (STAT_GOLDEN, STAT_CONFIGS)):
        doc = {
            "about": "JAX package (blockchain_simulator_tpu) results that the "
                     "PyTorch port must reproduce bit for bit: metrics and a "
                     "sha256 of every final-state field "
                     "(blockchain_simulator_tpu_torch/convert.state_digests). "
                     "Written by: python tests/test_torch_pbft.py --write-golden",
            "entries": {name: golden_entry(name, configs=configs) for name in configs},
        }
        path.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")


# --------------------------------------------------------------------------- #
# config copy                                                                 #
# --------------------------------------------------------------------------- #


def test_config_fields_and_defaults_match():
    for jcls, tcls in ((jconfig.SimConfig, tconfig.SimConfig),
                       (jconfig.FaultConfig, tconfig.FaultConfig)):
        jf = [(f.name, f.default) for f in dataclasses.fields(jcls)]
        tf = [(f.name, f.default) for f in dataclasses.fields(tcls)]
        assert jf == tf


@pytest.mark.parametrize("kw", [
    {}, dict(n=1000, sim_ms=2500), dict(protocol="raft", n=16),
    dict(protocol="paxos"), dict(quorum_rule="2f1", n=10),
    dict(model_serialization=False, pbft_window=8),
    dict(queued_links=True), dict(link_delay_ms=0, pbft_delay_lo=0, pbft_delay_hi=0),
])
def test_config_derived_properties_match(kw):
    jc, tc = _cfgs(**kw)
    for name in ("one_way_range", "roundtrip_range"):
        assert getattr(jc, name)() == getattr(tc, name)()
    for name in ("ring_depth", "ticks", "eff_stat_sampler", "eff_edge_sampler",
                 "quorum", "byz_f", "pbft_prepare_need", "pbft_commit_need",
                 "majority_need", "raft_lose_need", "pbft_block_bytes"):
        assert getattr(jc, name) == getattr(tc, name), name
    assert jc.serialization_ticks(50_000) == tc.serialization_ticks(50_000)


@pytest.mark.parametrize("kw, exc", [
    (dict(protocol="nope"), ValueError),
    (dict(quorum_rule="2f1", fidelity="reference"), ValueError),
    (dict(topology="gossip", protocol="mixed"), NotImplementedError),
    (dict(topology="committee", n=10, committees=3), ValueError),
])
def test_config_validation_matches(kw, exc):
    with pytest.raises(exc):
        jconfig.SimConfig(**kw)
    with pytest.raises(exc):
        tconfig.SimConfig(**kw)


# --------------------------------------------------------------------------- #
# one step from a carried-across state                                        #
# --------------------------------------------------------------------------- #


def _jax_state_at(jcfg, seed, t0):
    key = jax.random.key(seed)
    state, bufs = jpbft.init(jcfg)
    if t0:
        state, bufs = jrunner.make_segment_fn(jcfg, t0)(key, state, bufs, jnp.int32(0))
    return key, state, bufs


@pytest.mark.parametrize("t0, kind", [(250, "block"), (212, "commit")])
def test_one_step_from_carried_state(t0, kind):
    jcfg, tcfg = _cfgs(protocol="pbft", n=16, sim_ms=400)
    key, jstate, jbufs = _jax_state_at(jcfg, 0, t0)
    d = jcfg.ring_depth
    if kind == "block":
        assert t0 % jcfg.pbft_block_interval_ms == 0
    else:  # COMMIT votes land this tick, so the commit quorum path runs
        assert int(np.asarray(jbufs.commit)[t0 % d].sum()) > 0
    tstate, tbufs = convert.state_from_numpy(tcfg, _jax_leaves(jstate),
                                             _jax_leaves(jbufs), "cpu")
    jstep = jax.jit(lambda st, bf, t, k: jpbft.step(jcfg, st, bf, t, k))
    js, jb = jstep(jstate, jbufs, jnp.int32(t0), jprng.tick_key(key, t0))
    tkey = tprng.tick_key(threefry.key(0), t0)
    ts, tb = tpbft.step(tcfg, tstate, tbufs, torch.tensor(t0, dtype=torch.int32), tkey)
    got_s, got_b = convert.state_to_numpy(ts, tb)
    _assert_leaves_equal(_jax_leaves(js), got_s)
    _assert_leaves_equal(_jax_leaves(jb), got_b)


def test_convert_round_trip_and_shape_check():
    _, tcfg = _cfgs(protocol="pbft", n=8, sim_ms=100, pbft_window=8,
                    model_serialization=False)
    state, bufs = tpbft.init(tcfg, device="cpu")
    s_np, b_np = convert.state_to_numpy(state, bufs)
    s2, b2 = convert.state_from_numpy(tcfg, s_np, b_np, "cpu")
    _assert_leaves_equal(s_np, convert.state_to_numpy(s2))
    bad = dict(s_np, slot_id=np.zeros((8, 3), np.int32))
    with pytest.raises(ValueError, match="slot_id"):
        convert.state_from_numpy(tcfg, bad, None, "cpu")


# --------------------------------------------------------------------------- #
# whole runs                                                                  #
# --------------------------------------------------------------------------- #

RUNS = {
    "n64": dict(n=64, sim_ms=800),
    "reference_fidelity": dict(n=8, sim_ms=800, fidelity="reference"),
    "quorum_2f1_byzantine": dict(n=8, sim_ms=800, quorum_rule="2f1",
                                 faults=dict(n_byzantine=2)),
    "crashed": dict(n=8, sim_ms=800, faults=dict(n_crashed=2)),
    "byzantine": dict(n=8, sim_ms=800, faults=dict(n_byzantine=1)),
    "drops": dict(n=8, sim_ms=800, faults=dict(drop_prob=0.1)),
    "byz_forge_n2": dict(n=8, sim_ms=1000, pbft_max_rounds=16, pbft_max_slots=32,
                         faults=dict(n_byzantine=1, byz_forge=True, byz_copies=5)),
    "byz_forge_2f1": dict(n=8, sim_ms=1000, pbft_max_rounds=16, pbft_max_slots=32,
                          quorum_rule="2f1",
                          faults=dict(n_byzantine=1, byz_forge=True, byz_copies=5)),
    "windowed_drops_n64": dict(n=64, sim_ms=1500, pbft_window=8, pbft_max_slots=48,
                               faults=dict(drop_prob=0.05)),
    "windowed_no_serialization": dict(n=16, sim_ms=1500, pbft_window=8,
                                      pbft_max_slots=48, model_serialization=False,
                                      faults=dict(drop_prob=0.05)),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_equals_jax(name):
    kw = dict(RUNS[name])
    jcfg, tcfg = _cfgs(protocol="pbft", **kw)
    jfinal = jrunner.final_state(jcfg)
    tfinal = trunner.final_state(tcfg, device="cpu")
    assert trunner.sim_metrics(tcfg, tfinal) == jrunner.base_model.sim_metrics(jcfg, jfinal)
    _assert_leaves_equal(_jax_leaves(jfinal), convert.state_to_numpy(tfinal))


def test_forge_separates_quorum_rules():
    """The port reproduces the headline safety result, not only the bits."""
    m_n2 = trunner.run_simulation(_cfgs(protocol="pbft", **RUNS["byz_forge_n2"])[1],
                                  device="cpu")
    m_21 = trunner.run_simulation(_cfgs(protocol="pbft", **RUNS["byz_forge_2f1"])[1],
                                  device="cpu")
    assert m_n2["forged_commits"] == 1 and m_21["forged_commits"] == 0
    assert m_21["agreement_ok"]


# --------------------------------------------------------------------------- #
# golden file                                                                 #
# --------------------------------------------------------------------------- #


def _golden():
    return json.loads(GOLDEN.read_text())["entries"]


def test_golden_small_entry_matches_live_jax_and_port():
    want = _golden()["n8"]
    live = golden_entry("n8")
    assert live["metrics"] == want["metrics"]
    assert live["state_sha256"] == want["state_sha256"]
    tcfg = tconfig.SimConfig(**want["config"])
    tfinal = trunner.final_state(tcfg, seed=want["seed"], device="cpu")
    assert trunner.sim_metrics(tcfg, tfinal) == want["metrics"]
    assert convert.state_digests(convert.state_to_numpy(tfinal)) == want["state_sha256"]


def test_golden_n1000_entry_is_the_reference_milestone():
    m = _golden()["n1000"]["metrics"]
    assert (m["rounds_sent"], m["blocks_final_all_nodes"], m["view_changes"]) == (40, 40, 2)
    assert m["last_commit_ms"] == 2312.0 and m["mean_time_to_finality_ms"] == 162.0
    assert m["agreement_ok"] is True


@pytest.mark.slow
def test_golden_n1000_regenerates():
    want = _golden()["n1000"]
    live = golden_entry("n1000")
    assert live["metrics"] == want["metrics"]
    assert live["state_sha256"] == want["state_sha256"]


# --------------------------------------------------------------------------- #
# package rules                                                               #
# --------------------------------------------------------------------------- #


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, blockchain_simulator_tpu_torch as p\n"
        "from blockchain_simulator_tpu_torch import convert, runner\n"
        "from blockchain_simulator_tpu_torch.ops import ring, ring_kernel, delivery, delay\n"
        "from blockchain_simulator_tpu_torch import cli\n"
        "from blockchain_simulator_tpu_torch.utils import obs, sync, trace\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'blockchain_simulator_tpu'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("kw", [
    dict(protocol="mixed", mixed_shards=2, mesh_axis="nodes"),  # the mixed sim runs now
    # gossip, then the kregular overlay and the committee hierarchy run now
    dict(protocol="paxos", topology="kregular", degree=4, mesh_axis="nodes"),
    dict(topology="kregular", degree=4, mesh_axis="nodes"),
    dict(topology="committee", committees=2, echo_back=True),
    dict(mesh_axis="nodes"),
    dict(protocol="paxos", mesh_axis="nodes"),  # raft gossip runs now
    dict(protocol="paxos", topology="committee", committees=2, echo_back=True),
    dict(echo_back=True),
    dict(protocol="raft", topology="kregular", degree=4, mesh_axis="nodes"),
    dict(protocol="raft", mesh_axis="nodes"),
    dict(protocol="mixed", mixed_shards=2, delivery="stat", schedule="round", sim_ms=500,
         mesh_axis="nodes"),
])
def test_unported_configs_raise(kw):
    cfg = tconfig.SimConfig(**dict(dict(protocol="pbft", n=8, sim_ms=50), **kw))
    with pytest.raises(NotImplementedError):
        trunner.run_simulation(cfg, device="cpu")


def test_probed_round_run_raises():
    """Probed round runs are ported (utils/trace.py): the probed scan
    leaves the unprobed final state and records one int32 sample a round."""
    from blockchain_simulator_tpu_torch.models import pbft_round

    cfg = tconfig.SimConfig(protocol="pbft", n=8, sim_ms=200, delivery="stat",
                            schedule="round", model_serialization=False)
    plain = pbft_round.scan_rounds(cfg, pbft_round.init(cfg, device="cpu")[0],
                                   threefry.key(0))
    probed, ys = pbft_round.scan_rounds(cfg, pbft_round.init(cfg, device="cpu")[0],
                                        threefry.key(0), with_probe=True)
    assert (convert.state_digests(convert.state_to_numpy(probed))
            == convert.state_digests(convert.state_to_numpy(plain)))
    n_rounds = len(pbft_round.round_range(cfg))
    assert sorted(ys) == ["blocks_committed_max", "commit_events_total", "rounds_sent",
                          "view_max"]
    assert all(v.dtype == torch.int32 and v.shape == (n_rounds,) for v in ys.values())


@pytest.mark.parametrize("kw", [
    dict(delivery="stat"),
    dict(edge_sampler="rbg"),
    dict(delivery="stat", schedule="round", model_serialization=False),
    dict(queued_links=True),
    dict(delivery="stat", queued_links=True),
    dict(protocol="raft"),
    dict(protocol="raft", delivery="stat"),
])
def test_formerly_refused_configs_run_and_equal_jax(kw):
    """The stat arm, the rbg edge stream and the round path came with slice
    2 of the port, queued links and Raft's tick engine later: the configs
    that raised before now equal JAX."""
    jcfg, tcfg = _cfgs(**dict(dict(protocol="pbft", n=8, sim_ms=250), **kw))
    jfinal = jrunner.final_state(jcfg)
    tfinal = trunner.final_state(tcfg, device="cpu")
    assert trunner.sim_metrics(tcfg, tfinal) == jrunner.base_model.sim_metrics(jcfg, jfinal)
    _assert_leaves_equal(_jax_leaves(jfinal), convert.state_to_numpy(tfinal))


@pytest.mark.parametrize("kw", [
    dict(schedule="round"),  # edge delivery is never round-eligible
    dict(pbft_window=2, pbft_max_slots=48),  # re-tenants inside the horizon
    dict(pbft_window=8, pbft_max_slots=48, pbft_delay_lo=0, pbft_delay_hi=9),
    dict(pbft_window=8, pbft_max_slots=48, faults=dict(n_byzantine=1, byz_forge=True)),
])
def test_invalid_configs_raise_value_error_in_both(kw):
    kw = dict(kw)
    jcfg, tcfg = _cfgs(protocol="pbft", n=8, sim_ms=50, faults=kw.pop("faults", None), **kw)
    with pytest.raises(ValueError):
        jrunner.run_simulation(jcfg)
    with pytest.raises(ValueError):
        trunner.run_simulation(tcfg, device="cpu")


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trunner.run_simulation(tconfig.SimConfig(n=8, sim_ms=10))


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: python tests/test_torch_pbft.py --write-golden")
    jax.config.update("jax_platforms", "cpu")
    write_golden()
    print(f"wrote {GOLDEN}, {ROUND_GOLDEN}, {STAT_GOLDEN}")
