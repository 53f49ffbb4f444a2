"""The PyTorch port's Paxos tick engine, held bit for bit to the JAX package.

Each case runs the same config and seed through the JAX package and through
the port on the CPU (``device="cpu"``: the plain versions) and compares the
metrics and every final-state field: ``tests/test_paxos.py``'s ``CFG``
(n = 8, 4,000 ms) in both fidelities, crash, Byzantine and drop faults, the
``paxos_client_node`` hook, and n = 64.  One more case carries a mid-run JAX
state across with ``convert`` and steps both packages from it, checking that
every tick hands its pushes to one group call.  The gossip arm is held in
tests/test_torch_gossip.py.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockchain_simulator_tpu import runner as jrunner
from blockchain_simulator_tpu.models import paxos as jpaxos
from blockchain_simulator_tpu.utils import prng as jprng
from blockchain_simulator_tpu_torch import convert
from blockchain_simulator_tpu_torch import runner as trunner
from blockchain_simulator_tpu_torch.models import paxos as tpaxos
from blockchain_simulator_tpu_torch.utils import config as tconfig
from blockchain_simulator_tpu_torch.utils import prng as tprng
from blockchain_simulator_tpu_torch.utils import threefry
from test_torch_pbft import (  # noqa: F401 (release_jax_executables: autouse)
    _assert_leaves_equal, _cfgs, _jax_leaves, release_jax_executables,
)

RUNS = {
    # tests/test_paxos.py's CFG, both fidelities
    "n8_clean": dict(n=8, sim_ms=4000),
    "n8_reference": dict(n=8, sim_ms=4000, fidelity="reference"),
    "crash_minority": dict(n=8, sim_ms=1000, faults=dict(n_crashed=3)),
    # Byzantine acceptors flip their votes; proposer lane 1 is the client
    # hook's lane and fires at 200 ms instead of t = 0
    "byzantine_client": dict(n=8, sim_ms=1000, faults=dict(n_byzantine=2),
                             paxos_client_node=1, paxos_client_ms=200),
    "drops": dict(n=8, sim_ms=1200, faults=dict(drop_prob=0.2)),
    "n64_clean": dict(n=64, sim_ms=900),
    # 3-4 byte messages serialize in 0 ticks: queued links are the constant-
    # latency model, accepted as is (as the JAX package does)
    "queued_links": dict(n=8, sim_ms=600, queued_links=True),
}


@pytest.fixture(scope="module")
def runs():
    """``runs(name)``: the JAX package's and the port's results of one run
    (metrics and leaves), computed once a process and shared by the tests
    that read them."""
    memo = {}

    def get(name):
        if name not in memo:
            kw = dict(RUNS[name])
            jcfg, tcfg = _cfgs(protocol="paxos", faults=kw.pop("faults", None), **kw)
            jfinal = jrunner.final_state(jcfg)
            tfinal = trunner.final_state(tcfg, device="cpu")
            memo[name] = (jrunner.base_model.sim_metrics(jcfg, jfinal), _jax_leaves(jfinal),
                          trunner.sim_metrics(tcfg, tfinal), convert.state_to_numpy(tfinal))
        return memo[name]
    return get


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_equals_jax(runs, name):
    jm, jl, m, tl = runs(name)
    assert m == jm
    _assert_leaves_equal(jl, tl)
    assert m["agreement_ok"]
    if name.startswith("n8"):  # the reference milestone: a proposer commits
        assert m["n_committed_proposers"] >= 1


def test_ticks_from_carried_state(monkeypatch):
    """A mid-run JAX state (windows open, requests and replies in flight)
    carried into the port with ``convert``; then K ticks in both packages.
    Every tick hands its pushes to ONE group call, a subsequence of
    ``push_members`` in order."""
    t0, k = 320, 40
    jcfg, tcfg = _cfgs(protocol="paxos", n=8, sim_ms=t0 + k,
                       faults=dict(drop_prob=0.1))
    key = jax.random.key(0)
    jstep = jax.jit(lambda st, bf, t, kk: jpaxos.step(jcfg, st, bf, t, kk))
    jstate, jbufs = jpaxos.init(jcfg, jax.random.fold_in(key, 0x1217))
    for t in range(t0):  # the JAX tick loop, one compiled step
        jstate, jbufs = jstep(jstate, jbufs, jnp.int32(t), jprng.tick_key(key, t))
    assert int(np.asarray(jbufs.req_propose).max()) > 0  # proposals in flight
    tstate, tbufs = convert.state_from_numpy(tcfg, _jax_leaves(jstate),
                                             _jax_leaves(jbufs), "cpu")
    ring_of = {getattr(tbufs, f).data_ptr(): f for f in tpaxos.BUF_FIELDS}
    calls = []
    real = tpaxos.ring_push_group

    def record(items, t):
        calls.append([(ring_of[r.data_ptr()], op, c.shape[0], lo) for r, lo, c, op in items])
        return real(items, t)

    monkeypatch.setattr(tpaxos, "ring_push_group", record)
    tkey = threefry.key(0)
    for t in range(t0, t0 + k):
        jstate, jbufs = jstep(jstate, jbufs, jnp.int32(t), jprng.tick_key(key, t))
        tstate, tbufs = tpaxos.step(tcfg, tstate, tbufs, torch.tensor(t, dtype=torch.int32),
                                    tprng.tick_key(tkey, t))
    got_s, got_b = convert.state_to_numpy(tstate, tbufs)
    _assert_leaves_equal(_jax_leaves(jstate), got_s)
    _assert_leaves_equal(_jax_leaves(jbufs), got_b)
    members = tpaxos.push_members(tcfg)
    assert len(calls) == k
    for call in calls:
        assert call == [m for m in members if m in call]
    assert any(call for call in calls)


def test_state_fields_match_jax():
    assert tpaxos.STATE_FIELDS == tuple(f.name for f in dataclasses.fields(jpaxos.PaxosState))
    assert tpaxos.BUF_FIELDS == tuple(f.name for f in dataclasses.fields(jpaxos.PaxosBufs))


@pytest.mark.parametrize("kw, slice_no", [
    # node-sharded configs run on a node mesh (parallel/shard.py), never
    # through the single-device runner
    (dict(topology="kregular", degree=4, mesh_axis="nodes"), "run_sharded"),
    (dict(mesh_axis="nodes"), "run_sharded"),
])
def test_unported_paxos_arms_raise(kw, slice_no):
    cfg = tconfig.SimConfig(protocol="paxos", n=8, sim_ms=50, **kw)
    with pytest.raises(NotImplementedError, match=slice_no):
        trunner.run_simulation(cfg, device="cpu")
