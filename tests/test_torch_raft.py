"""The PyTorch port's Raft tick engine, held bit for bit to the JAX package.

Each case runs the same config and seed through the JAX package and through
the port on the CPU (``device="cpu"``: the plain versions) and compares the
metrics and every final-state field: edge delivery (threefry and rbg delays,
both fidelities, crash, Byzantine and drop faults) and stat delivery (both
samplers).  One more case carries a mid-run JAX state across with
``convert`` and steps both packages from it.

Golden files (``blockchain_simulator_tpu_torch/golden/``), written by the JAX
package: ``raft_edge_n1000_s0.json`` (the tick engine, edge delivery, at
n = 1000), ``raft_hb_n1000_s0.json`` (the heartbeat-blocked path, stat
delivery, at n = 1000) and ``pbft_queued_n8_s0.json`` (PBFT with queued
links).  ``chip_smoke.py`` holds the port's runs on the card to them.
Regenerate them with ``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_raft.py
--write-golden`` (about seven minutes of JAX on the CPU, almost all of it the
edge run).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockchain_simulator_tpu import runner as jrunner
from blockchain_simulator_tpu.models import raft as jraft
from blockchain_simulator_tpu.models import raft_hb as jraft_hb
from blockchain_simulator_tpu.utils import config as jconfig
from blockchain_simulator_tpu.utils import prng as jprng
from blockchain_simulator_tpu_torch import convert
from blockchain_simulator_tpu_torch import runner as trunner
from blockchain_simulator_tpu_torch.models import raft as traft
from blockchain_simulator_tpu_torch.utils import config as tconfig
from blockchain_simulator_tpu_torch.utils import prng as tprng
from blockchain_simulator_tpu_torch.utils import threefry
from test_torch_pbft import (  # noqa: F401 (release_jax_executables: autouse)
    _assert_leaves_equal, _cfgs, release_jax_executables,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN_DIR = REPO / "blockchain_simulator_tpu_torch" / "golden"
WRITTEN_BY = "PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_raft.py --write-golden"
GOLDENS = {
    # the 1k-node shard of BASELINE.json config 5 on the faithful tick engine
    "raft_edge_n1000_s0.json": {
        "n1000": dict(protocol="raft", n=1000, sim_ms=10_000),
    },
    # the sub-config mixed.scan_fast runs per shard: the heartbeat path
    "raft_hb_n1000_s0.json": {
        "n1000": dict(protocol="raft", n=1000, sim_ms=10_000, delivery="stat",
                      schedule="round"),
    },
    # ns-3's serial-pipe transport (queued links), PBFT at the milestone size;
    # 6,000 ms holds all 40 blocks (the last at 5,515 ms), as 10,000 ms did
    "pbft_queued_n8_s0.json": {
        "n8": dict(protocol="pbft", n=8, sim_ms=6000, queued_links=True),
    },
}


def _jax_leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def jax_handoff_ok(jcfg, seed: int) -> bool:
    """Whether the JAX heartbeat path takes its fast branch: the handoff
    check on the state after the election prefix."""
    key = jax.random.key(seed)
    state, bufs = jraft.init(jcfg, jax.random.fold_in(key, 0x1217))
    t_e = jraft_hb.prefix_ticks(jcfg)
    state, _ = jrunner.make_segment_fn(jcfg, t_e)(key, state, bufs, jax.numpy.int32(0))
    ok, _ = jraft_hb.handoff(jcfg, state)
    return bool(ok)


def golden_entry(config: dict, seed: int = 0) -> dict:
    """One golden entry, computed by the JAX package."""
    jcfg = jconfig.SimConfig(**config)
    final = jrunner.final_state(jcfg, seed=seed)
    entry = {
        "config": config,
        "seed": seed,
        "jax_version": jax.__version__,
        "metrics": jrunner.base_model.sim_metrics(jcfg, final),
        "state_sha256": convert.state_digests(_jax_leaves(final)),
    }
    if jcfg.protocol == "raft" and jrunner.use_round_schedule(jcfg):
        entry["handoff_ok"] = jax_handoff_ok(jcfg, seed)
    return entry


def write_golden(names=None):
    for fname, configs in GOLDENS.items():
        if names and fname not in names:
            continue
        doc = {
            "about": "JAX package (blockchain_simulator_tpu) results that the "
                     "PyTorch port must reproduce bit for bit: metrics and a "
                     "sha256 of every final-state field "
                     "(blockchain_simulator_tpu_torch/convert.state_digests). "
                     f"Written by: {WRITTEN_BY}",
            "entries": {name: golden_entry(cfg) for name, cfg in configs.items()},
        }
        (GOLDEN_DIR / fname).write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
        print(f"wrote {GOLDEN_DIR / fname}", flush=True)


# --------------------------------------------------------------------------- #
# whole runs                                                                  #
# --------------------------------------------------------------------------- #

# setProposal 300 ms after the election (the default is 1 s) keeps the
# windows short while every run still replicates blocks
P = dict(raft_proposal_delay_ms=300)
RUNS = {
    "n8_clean": dict(n=8, sim_ms=1000, **P),
    "n8_reference": dict(n=8, sim_ms=1000, fidelity="reference", **P),
    "n16_clean": dict(n=16, sim_ms=900, **P),
    "n16_reference": dict(n=16, sim_ms=900, fidelity="reference", **P),
    "n8_rbg": dict(n=8, sim_ms=800, edge_sampler="rbg", **P),
    "crash_minority": dict(n=8, sim_ms=900, faults=dict(n_crashed=3), **P),
    "byzantine": dict(n=8, sim_ms=900, faults=dict(n_byzantine=1), **P),
    "drops": dict(n=8, sim_ms=900, faults=dict(drop_prob=0.1), **P),
    "stat_n64_exact": dict(n=64, sim_ms=700, delivery="stat", schedule="tick",
                           stat_sampler="exact", **P),
    "stat_n64_normal": dict(n=64, sim_ms=700, delivery="stat", schedule="tick",
                            stat_sampler="normal", **P),
    "stat_byzantine_drops": dict(n=16, sim_ms=700, delivery="stat", schedule="tick",
                                 faults=dict(n_byzantine=2, drop_prob=0.05), **P),
}


def _run_both(**kw):
    jcfg, tcfg = _cfgs(protocol="raft", faults=kw.pop("faults", None), **kw)
    jfinal = jrunner.final_state(jcfg)
    tfinal = trunner.final_state(tcfg, device="cpu")
    tm = trunner.sim_metrics(tcfg, tfinal)
    assert tm == jrunner.base_model.sim_metrics(jcfg, jfinal)
    _assert_leaves_equal(_jax_leaves(jfinal), convert.state_to_numpy(tfinal))
    return tm


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_equals_jax(name):
    m = _run_both(**RUNS[name])
    assert m["n_leaders"] >= 1 and m["blocks"] > 0  # the run reached replication


# --------------------------------------------------------------------------- #
# K ticks from a carried-across state                                         #
# --------------------------------------------------------------------------- #


def test_ticks_from_carried_state():
    """A mid-run JAX state (the election decided, proposals flowing) carried
    into the port with ``convert``; then K ticks in both packages."""
    t0, k = 520, 30
    jcfg, tcfg = _cfgs(protocol="raft", n=16, sim_ms=t0 + k,
                       faults=dict(n_byzantine=1), **P)
    key = jax.random.key(0)
    jstate, jbufs = jraft.init(jcfg, jax.random.fold_in(key, 0x1217))
    jstate, jbufs = jrunner.make_segment_fn(jcfg, t0)(key, jstate, jbufs, jnp.int32(0))
    assert int(np.asarray(jstate.round).max()) > 0  # proposals under way
    tstate, tbufs = convert.state_from_numpy(tcfg, _jax_leaves(jstate),
                                             _jax_leaves(jbufs), "cpu")
    jstep = jax.jit(lambda st, bf, t, kk: jraft.step(jcfg, st, bf, t, kk))
    tkey = threefry.key(0)
    for t in range(t0, t0 + k):
        jstate, jbufs = jstep(jstate, jbufs, jnp.int32(t), jprng.tick_key(key, t))
        tstate, tbufs = traft.step(tcfg, tstate, tbufs, torch.tensor(t, dtype=torch.int32),
                                   tprng.tick_key(tkey, t))
    got_s, got_b = convert.state_to_numpy(tstate, tbufs)
    _assert_leaves_equal(_jax_leaves(jstate), got_s)
    _assert_leaves_equal(_jax_leaves(jbufs), got_b)


@pytest.mark.parametrize("delivery", ["edge", "stat"])
def test_step_pushes_one_group_of_the_members_that_fire(monkeypatch, delivery):
    """Every tick hands its pushes to ONE group call, each member on its own
    ring with the offset, bucket count and op ``push_members`` lists, in
    that order; a member whose gate was skipped is left out (most ticks
    push nothing).  Over the run every member is pushed."""
    _, cfg = _cfgs(protocol="raft", n=8, sim_ms=700, delivery=delivery, schedule="tick",
                   faults=dict(n_byzantine=1), **P)
    key = threefry.key(0)
    state, bufs = traft.init(cfg, threefry.fold_in(key, trunner._INIT_FOLD), device="cpu")
    ring_of = {getattr(bufs, f).data_ptr(): f for f in traft.BUF_FIELDS}
    calls = []
    real = traft.ring_push_group

    def record(items, t):
        calls.append([(ring_of[r.data_ptr()], op, c.shape[0], lo) for r, lo, c, op in items])
        return real(items, t)

    monkeypatch.setattr(traft, "ring_push_group", record)
    for t in range(cfg.ticks):
        state, bufs = traft.step(cfg, state, bufs, torch.tensor(t, dtype=torch.int32),
                                 tprng.tick_key(key, t))
    monkeypatch.undo()
    assert convert.state_digests(convert.state_to_numpy(state)) == convert.state_digests(
        convert.state_to_numpy(trunner.final_state(cfg, device="cpu")))
    assert len(calls) == cfg.ticks
    members = traft.push_members(cfg)
    for call in calls:
        assert call == [m for m in members if m in call]  # a subsequence, in order
    assert {m for call in calls for m in call} == set(members)
    assert sum(not call for call in calls) > cfg.ticks // 2


# --------------------------------------------------------------------------- #
# refusals and the goldens                                                    #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kw, slice_no", [
    # node-sharded configs run on a node mesh (parallel/shard.py), never
    # through the single-device runner
    (dict(protocol="mixed", mixed_shards=2, mesh_axis="nodes"), "run_sharded"),
    (dict(topology="kregular", degree=4, mesh_axis="nodes"), "run_sharded"),
    (dict(mesh_axis="nodes"), "run_sharded"),
])
def test_unported_raft_arms_raise(kw, slice_no):
    cfg = tconfig.SimConfig(**dict(dict(protocol="raft", n=8, sim_ms=50), **kw))
    with pytest.raises(NotImplementedError, match=slice_no):
        trunner.run_simulation(cfg, device="cpu")


def test_goldens_hold_the_reference_milestones():
    """The goldens chip_smoke.py holds the card to: the n = 1000 milestones
    (one leader, 49 of 50 blocks at defaults) and the queued-link PBFT run."""
    edge = json.loads((GOLDEN_DIR / "raft_edge_n1000_s0.json").read_text())["entries"]["n1000"]
    hb = json.loads((GOLDEN_DIR / "raft_hb_n1000_s0.json").read_text())["entries"]["n1000"]
    pq = json.loads((GOLDEN_DIR / "pbft_queued_n8_s0.json").read_text())["entries"]["n8"]
    for entry in (edge, hb):
        m = entry["metrics"]
        assert (m["n_leaders"], m["blocks"], m["rounds"], m["agreement_ok"]) == (1, 49, 50, True)
        assert sorted(entry["state_sha256"]) == sorted(traft.STATE_FIELDS)
    assert hb["handoff_ok"] is True
    assert pq["metrics"]["blocks_final_all_nodes"] == 40
    assert pq["metrics"]["last_commit_ms"] == 5515.0
    for fname, configs in GOLDENS.items():
        doc = json.loads((GOLDEN_DIR / fname).read_text())
        assert WRITTEN_BY in doc["about"]
        assert {k: e["config"] for k, e in doc["entries"].items()} == configs


if __name__ == "__main__":
    if not sys.argv[1:] or sys.argv[1] != "--write-golden":
        sys.exit("usage: python tests/test_torch_raft.py --write-golden [FILE ...]")
    jax.config.update("jax_platforms", "cpu")
    write_golden(sys.argv[2:])
