"""The port's wrapper of the C++ reference engine.

``blockchain_simulator_tpu_torch/engine/engine.cpp`` is a byte-for-byte copy
of the JAX package's engine (pinned here by sha256), built and called by the
port's own jax-free wrapper.  Its ``run_cpp`` must return the JAX package's
dict on every protocol, and the port's tensorized Raft must meet the C++
engine on the milestones tests/test_differential.py pins for the JAX
package.
"""

from __future__ import annotations

import hashlib
import pathlib

import pytest

from blockchain_simulator_tpu import engine as jengine
from blockchain_simulator_tpu_torch import engine as tengine
from blockchain_simulator_tpu_torch import runner as trunner
from blockchain_simulator_tpu_torch.utils import config as tconfig
from test_torch_pbft import _cfgs, release_jax_executables  # noqa: F401 (autouse fixture)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _sha256(path: pathlib.Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_engine_source_is_the_reference_copy():
    ref = REPO / "blockchain_simulator_tpu" / "engine" / "engine.cpp"
    copy = REPO / "blockchain_simulator_tpu_torch" / "engine" / "engine.cpp"
    assert _sha256(copy) == _sha256(ref)


def test_struct_layout_matches_the_reference_wrapper():
    assert ([(n, t) for n, t in tengine._CppCfg._fields_]
            == [(n, t) for n, t in jengine._CppCfg._fields_])


@pytest.mark.parametrize("kw", [
    dict(protocol="pbft", n=8, sim_ms=2500),
    dict(protocol="pbft", n=8, sim_ms=3000, queued_links=True),
    dict(protocol="raft", n=8, sim_ms=6000),
    dict(protocol="raft", n=8, sim_ms=6000, fidelity="reference",
         faults=dict(n_crashed=2)),
    dict(protocol="paxos", n=8, sim_ms=10_000),
    dict(protocol="paxos", n=8, sim_ms=8000, faults=dict(drop_prob=0.05)),
])
def test_run_cpp_returns_the_reference_dict(kw):
    kw = dict(kw)
    jcfg, tcfg = _cfgs(faults=kw.pop("faults", None), **kw)
    assert tengine.run_cpp(tcfg) == jengine.run_cpp(jcfg)
    assert tengine.run_cpp(tcfg, seed=3) == jengine.run_cpp(jcfg, seed=3)


@pytest.mark.parametrize("kw", [
    dict(topology="gossip", delivery="stat"),
    dict(quorum_rule="2f1"),
    dict(protocol="mixed", mixed_shards=2),
    dict(faults=dict(n_byzantine=1, byz_forge=True)),
])
def test_cpp_config_refuses_what_the_engine_does_not_model(kw):
    kw = dict(dict(protocol="pbft", n=8, sim_ms=100), **kw)
    jcfg, tcfg = _cfgs(faults=kw.pop("faults", None), **kw)
    with pytest.raises(ValueError):
        jengine.cpp_config(jcfg)
    with pytest.raises(ValueError):
        tengine.cpp_config(tcfg)


@pytest.mark.parametrize("fidelity", ["clean", "reference"])
def test_port_raft_meets_the_cpp_engine(fidelity):
    """tests/test_differential.py::test_raft_differential on the port: one
    leader in both engines, 49 blocks in clean fidelity (the serialized
    proposal's acks land one heartbeat late) and 50 in reference fidelity."""
    cfg = tconfig.SimConfig(protocol="raft", n=8, sim_ms=6000, fidelity=fidelity)
    mt, mc = trunner.run_simulation(cfg, device="cpu"), tengine.run_cpp(cfg)
    assert mc["n_leaders"] == mt["n_leaders"] == 1
    assert mc["blocks"] == mt["blocks"] == (49 if fidelity == "clean" else 50)
    assert mc["agreement_ok"] and mt["agreement_ok"]
    assert mc["leader_elected_ms"] < 1000 and mt["leader_elected_ms"] < 1000
    assert abs(mc["mean_block_interval_ms"] - mt["mean_block_interval_ms"]) < 5


def test_port_raft_crash_minority_meets_the_cpp_engine():
    """tests/test_differential.py::test_raft_crash_minority_differential on
    the port: a leader among the 5 alive nodes, 49 blocks in both engines."""
    cfg = tconfig.SimConfig(protocol="raft", n=8, sim_ms=6000,
                            faults=tconfig.FaultConfig(n_crashed=3))
    mt, mc = trunner.run_simulation(cfg, device="cpu"), tengine.run_cpp(cfg)
    assert mc["n_leaders"] >= 1 and mt["n_leaders"] >= 1
    assert mc["blocks"] == mt["blocks"] == 49


def test_port_wrapper_builds_into_the_build_directory():
    lib = tengine.build()
    assert lib.parent == tengine.BUILD_DIR and lib.exists()
