"""The tick engines' lane axis (models/base.py), held bit for bit to the JAX
package on the CPU.

A batch of the PBFT, Raft and Paxos tick engines runs its lanes side by
side (parallel/sweep.dyn_batched_fn → runner._dyn_run), and every lane must
be JAX's vmapped row (``jit(vmap(make_dyn_sim_fn(canon)))``): metrics and a
sha256 of every final-state field.  Under ``vmap`` the JAX package's Philox
draws (the ``"normal"`` stat sampler, the ``"rbg"`` edge sampler) follow
the first lane's key, so each arm below runs both Philox samplers over
three lanes (seeds 0, 1, 2; one crashed node in lane 2), in a window long
enough that lane 1 differs from its solo run:

- PBFT: edge, stat, queued links, gossip, kregular;
- Raft: gossip, queued links, kregular;
- Paxos: full mesh, gossip, kregular.

Each arm's pin (parallel/sweep.vmapped_rule): JAX's vmapped lane 0 is its
solo run and lane 1 is not, and the port's solo run of lane 1 is JAX's
solo run.  Beside them: committees stepped as lanes with solo draws
(ops/delay.lane_rule(1)) equal JAX's ``lax.map`` at C in {1, 4} on
``"normal"`` and exact draws, with one grouped ring push a tick for all
committees; a sweep batch of committee runs (``vmap`` over ``lax.map``)
equals JAX's rows; the lane rule's Philox words equal ``jax.random.bits``
under ``vmap`` of ``lax.map``; and a served flush of two PBFT tick requests
on ``"normal"`` draws is answered ``"batched"`` with the JAX server's
answers.

JAX's side of the runs (its vmapped programs compile for several seconds
each) is read from ``blockchain_simulator_tpu_torch/golden/tick_lanes_s0.json``,
which also holds ``chip_smoke.py``'s tick-lanes entries (config 3's Paxos
and kreg-raft at n = 10,000, a 4-lane fault sweep each).  Regenerate it with
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_lanes.py
--write-golden [ENTRY ...]`` (~5 min; the two card entries most of it).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from blockchain_simulator_tpu_torch import convert
from blockchain_simulator_tpu_torch import runner as trunner
from blockchain_simulator_tpu_torch.models import base as tbase
from blockchain_simulator_tpu_torch.ops import delay as tdelay
from blockchain_simulator_tpu_torch.ops import ring_kernel
from blockchain_simulator_tpu_torch.parallel import sweep as tsweep
from blockchain_simulator_tpu_torch.utils import config as tconfig
from blockchain_simulator_tpu_torch.utils import threefry

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "blockchain_simulator_tpu_torch" / "golden" / "tick_lanes_s0.json"
WRITTEN_BY = "PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_lanes.py --write-golden"

PHILOX = dict(stat_sampler="normal", edge_sampler="rbg", fidelity="clean")
SEEDS = (0, 1, 2)
CRASHED = (0, 0, 1)
RAFT = dict(raft_proposal_delay_ms=300)
# every arm on both Philox samplers, three lanes; windows long enough that
# lane 1 leaves its solo run (over 200 ms PBFT's lanes still equal theirs)
ARMS = {
    "pbft_edge": dict(PHILOX, protocol="pbft", n=16, sim_ms=600),
    "pbft_stat": dict(PHILOX, protocol="pbft", n=32, sim_ms=1000, delivery="stat"),
    "pbft_queued": dict(PHILOX, protocol="pbft", n=8, sim_ms=1000, pbft_max_rounds=12,
                        queued_links=True, delivery="stat"),
    "pbft_gossip": dict(PHILOX, protocol="pbft", n=32, sim_ms=700, topology="gossip",
                        degree=8, gossip_hops=8, delivery="stat"),
    "pbft_kreg": dict(PHILOX, protocol="pbft", n=12, sim_ms=450, topology="kregular",
                      degree=10),
    "raft_gossip": dict(PHILOX, **RAFT, protocol="raft", n=32, sim_ms=700,
                        topology="gossip", degree=8, gossip_hops=8, delivery="stat"),
    "raft_queued": dict(PHILOX, **RAFT, protocol="raft", n=8, sim_ms=900,
                        queued_links=True, delivery="stat"),
    "raft_kreg": dict(PHILOX, **RAFT, protocol="raft", n=12, sim_ms=700,
                      topology="kregular", degree=9),
    "paxos_full": dict(PHILOX, protocol="paxos", n=8, sim_ms=1000),
    "paxos_gossip": dict(PHILOX, protocol="paxos", n=32, sim_ms=900, topology="gossip",
                         degree=8, gossip_hops=8, paxos_retry_timeout_ms=600),
    "paxos_kreg": dict(PHILOX, protocol="paxos", n=12, sim_ms=900, topology="kregular",
                       degree=8),
}
# committees as lanes: C in {1, 4} on both stat samplers (the ladder's knobs)
COMMITTEE = dict(protocol="pbft", n=32, sim_ms=250, topology="committee", fidelity="clean",
                 delivery="stat", schedule="tick", model_serialization=False,
                 link_delay_ms=1, pbft_delay_lo=1, pbft_delay_hi=3, pbft_window=8)
COMMITTEES = {f"c{c}_{s}": dict(COMMITTEE, committees=c, stat_sampler=s)
              for c in (1, 4) for s in ("normal", "exact")}
# a sweep batch of two committee runs on "normal" draws (vmap over lax.map)
COMMITTEE_BATCH = dict(COMMITTEE, committees=4, stat_sampler="normal")
# the served flush: two PBFT tick requests on "normal" draws
FLUSH = {"protocol": "pbft", "n": 16, "sim_ms": 600, "delivery": "stat",
         "stat_sampler": "normal", "schedule": "tick"}
FLUSH_SEEDS = (0, 1)
# chip_smoke.py's tick-lanes phase: a 4-lane fault sweep (f in {0, 1000} x
# seeds {0, 1}, passive Byzantine acceptors / voters) at the auto samplers
# (edge_sampler "auto": "rbg" at n = 10,000; the package default is
# "threefry") on config 3's Paxos (tools/run_config3.py) and on kreg-raft
# (the overlay of kreg_raft_paxos_n10k_s0.json), windows cut for time
# (PERF.md §4)
CHIP = {
    "config3_paxos": dict(protocol="paxos", n=10_000, sim_ms=500, topology="gossip",
                          degree=16, delivery="stat", model_serialization=False,
                          paxos_retry_timeout_ms=600, edge_sampler="auto"),
    "kreg_raft": dict(protocol="raft", n=10_000, sim_ms=500, topology="kregular",
                      degree=16, edge_sampler="auto"),
}
CHIP_F = (0, 1000)
CHIP_SEEDS = (0, 1)


def _cfg(kw, faults=None):
    return tconfig.SimConfig(faults=tconfig.FaultConfig(**(faults or {})), **kw)


def _digests_of(leaves: dict, n_lanes: int) -> list:
    return [convert.state_digests(convert.lane_leaves(leaves, i)) for i in range(n_lanes)]


def _port_batch(kw, seeds, crashed):
    """The port's batched rows: ``dyn_batched_fn`` over the lanes, one
    metrics dict and one digest dict a lane."""
    canon = tbase.canonical_fault_cfg(_cfg(kw))
    keys = np.stack([threefry.key(s) for s in seeds])
    finals = tsweep.dyn_batched_fn(canon)(keys, list(crashed), [0] * len(seeds), "cpu")
    metrics = [tbase.sim_metrics(_cfg(kw, {"n_crashed": c}), tbase.lane_state(finals, i))
               for i, c in enumerate(crashed)]
    return metrics, _digests_of(convert.state_to_numpy(finals), len(seeds))


@pytest.fixture(scope="module")
def golden():
    doc = json.loads(GOLDEN.read_text())
    assert WRITTEN_BY in doc["about"]
    return doc["entries"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops: one torch thread runs them faster than a pool."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_batch_equals_jax_vmapped_rows(golden, arm):
    """Three lanes on Philox draws, side by side: every lane's metrics and
    field digests are JAX's vmapped row."""
    want = golden["arms"][arm]
    assert want["config"] == ARMS[arm]
    metrics, digests = _port_batch(ARMS[arm], SEEDS, CRASHED)
    assert metrics == want["batched_metrics"]
    assert digests == want["batched_sha256"]


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_vmapped_rule_pin(golden, arm):
    """The arm's rule (parallel/sweep.vmapped_rule): first-lane.  JAX's
    vmapped lane 0 is its solo run, lane 1 is not, and the port's solo run
    of lane 1 is JAX's solo run of it."""
    want = golden["arms"][arm]
    assert tsweep.vmapped_rule(_cfg(ARMS[arm])) == "first-lane"
    batched, solo = want["batched_sha256"], want["solo_sha256"]
    assert batched[0] == solo[0]
    assert batched[1] != solo[1]
    canon = tbase.canonical_fault_cfg(_cfg(ARMS[arm]))
    final = trunner.make_dyn_sim_fn(canon)(threefry.key(SEEDS[1]), CRASHED[1], 0, "cpu")
    assert convert.state_digests(convert.state_to_numpy(final)) == solo[1]


@pytest.mark.parametrize("name", sorted(COMMITTEES))
def test_committees_as_lanes_equal_jax_lax_map(golden, name):
    """The committees step as lanes with solo draws: the stacked finals and
    the two-level metrics are JAX's ``lax.map`` over the committees."""
    want = golden["committees"][name]
    kw = COMMITTEES[name]
    assert want["config"] == kw
    cfg = tbase.canonical_fault_cfg(_cfg(kw))
    final = trunner.make_dyn_sim_fn(cfg)(threefry.key(0), 0, 0, "cpu")
    assert tbase.sim_metrics(_cfg(kw), final) == want["metrics"]
    assert convert.state_digests(convert.state_to_numpy(final)) == want["sha256"]


def test_committees_make_one_grouped_push_a_tick(monkeypatch):
    """C committees make one grouped ring push a tick (the kernel's launch
    on the card), whose members hold every committee's rows."""
    calls = []
    real = ring_kernel.push_group_plain

    def counted(items, t):
        calls.append(len(items))
        return real(items, t)

    monkeypatch.setattr(ring_kernel, "push_group_plain", counted)
    kw = dict(COMMITTEES["c4_normal"], sim_ms=60)
    cfg = tbase.canonical_fault_cfg(_cfg(kw))
    final = trunner.make_dyn_sim_fn(cfg)(threefry.key(0), 0, 0, "cpu")
    assert len(calls) == cfg.ticks and set(calls) == {4}
    assert final.v.shape == (4, kw["n"] // 4)


def test_committee_batch_equals_jax_rows(golden):
    """A sweep batch of two committee runs: JAX's ``vmap`` of the ``lax.map``
    draws each committee's words on the first point's key
    (``lane_rule(2)`` over 2 x 4 lanes); every row is JAX's."""
    want = golden["committee_batch"]
    metrics, digests = _port_batch(COMMITTEE_BATCH, (0, 1), (0, 0))
    assert metrics == want["metrics"]
    assert digests == want["sha256"]


@pytest.mark.parametrize("width", [None, 1, 2])
def test_lane_rule_words_equal_jax(width):
    """The Philox words of lane keys ``[L, 2]`` under each rule:
    ``jax.vmap`` over all lanes (first-lane), ``lax.map`` (solo), and
    ``vmap`` over ``width`` points of a ``lax.map`` over the rest."""
    import jax
    import jax.numpy as jnp

    from blockchain_simulator_tpu.ops import delay as jdelay

    keys = np.stack([threefry.key(s) for s in range(6)])
    shape = (3, 5)
    jkeys = jax.vmap(jax.random.key)(jnp.arange(6, dtype=jnp.uint32))

    def draw(k):
        return jax.random.bits(jdelay._rbg_key(k), shape, jnp.uint32)

    if width is None:
        want = jax.vmap(draw)(jkeys)
        got = tdelay._philox_lanes(keys, shape, "cpu")
    else:
        want = jax.vmap(lambda ks: jax.lax.map(draw, ks))(jkeys.reshape(width, -1))
        with tdelay.lane_rule(width):
            got = tdelay._philox_lanes(keys, shape, "cpu")
    assert np.array_equal(got.numpy(), np.asarray(want).reshape(got.shape).astype(np.int64))


def test_served_normal_tick_flush_is_batched_with_jax_answers(golden):
    """Two PBFT tick requests on ``"normal"`` draws in one flush: the port's
    server answers them ``"batched"`` (no ``degraded`` flag) with the JAX
    server's answers for the same ordered lanes."""
    from blockchain_simulator_tpu_torch.serve import ScenarioServer

    want = golden["served_flush"]
    assert want["request"] == FLUSH
    with ScenarioServer(max_batch=2, max_wait_ms=1.0, start=False, device="cpu") as srv:
        pends = [srv.submit(dict(FLUSH, seed=s)) for s in FLUSH_SEEDS]
        srv.start()
        got = [p.result(600) for p in pends]
    assert all(r["status"] == "ok" for r in got), got
    assert [r["batch"] for r in got] == want["batch"]
    assert all(not r["batch"].get("degraded") and r["batch"]["mode"] == "batched"
               for r in got)
    assert [r["metrics"] for r in got] == want["metrics"]


def test_chip_golden_holds_the_tick_lanes_phase(golden):
    """The entries ``chip_smoke.py``'s tick-lanes phase holds the card to:
    four lanes a config (f x seeds), JAX's vmapped rows, on the auto
    samplers, which resolve to ``"rbg"`` at n = 10,000."""
    for name, kw in CHIP.items():
        entry = golden["chip"][name]
        assert entry["config"] == kw and entry["f_values"] == list(CHIP_F)
        assert entry["seeds"] == list(CHIP_SEEDS)
        assert len(entry["metrics"]) == len(entry["sha256"]) == 4
        cfg = _cfg(kw)
        assert cfg.eff_edge_sampler == "rbg"
        assert tsweep.vmapped_rule(cfg) == "first-lane"


# ------------------------------------------------------------- golden ------

def _jax_cfg(kw, faults=None):
    from blockchain_simulator_tpu.utils import config as jconfig

    return jconfig.SimConfig(faults=jconfig.FaultConfig(**(faults or {})), **kw)


def _jax_leaves(tree) -> dict:
    return {f.name: np.asarray(getattr(tree, f.name)) for f in dataclasses.fields(tree)}


def _jax_batch(kw, seeds, crashed, byzantine=None, solo=False):
    """JAX's vmapped rows (``dyn_batched_fn``) of one structure, and with
    ``solo`` each lane's solo run (``jit(make_dyn_sim_fn)``)."""
    import jax
    import jax.numpy as jnp

    from blockchain_simulator_tpu import runner as jrunner
    from blockchain_simulator_tpu.models import base as jbase
    from blockchain_simulator_tpu.parallel import sweep as jsweep

    byzantine = byzantine or [0] * len(seeds)
    canon = jbase.canonical_fault_cfg(_jax_cfg(kw))
    keys = jax.vmap(jax.random.key)(jnp.asarray(seeds, jnp.uint32))
    nc, nb = jnp.asarray(crashed, jnp.int32), jnp.asarray(byzantine, jnp.int32)
    finals = jax.block_until_ready(jsweep.dyn_batched_fn(canon)(keys, nc, nb))
    metrics = [jbase.sim_metrics(_jax_cfg(kw, {"n_crashed": c, "n_byzantine": b}),
                                 jax.tree.map(lambda x, i=i: x[i], finals))
               for i, (c, b) in enumerate(zip(crashed, byzantine))]
    out = {"config": kw, "batched_metrics": metrics,
           "batched_sha256": _digests_of(_jax_leaves(finals), len(seeds))}
    if solo:
        sim = jax.jit(jrunner.make_dyn_sim_fn(canon))
        out["solo_sha256"] = [convert.state_digests(_jax_leaves(sim(keys[i], nc[i], nb[i])))
                              for i in range(len(seeds))]
    jax.clear_caches()
    return out


def _jax_committee(kw):
    import jax

    from blockchain_simulator_tpu import runner as jrunner
    from blockchain_simulator_tpu.models import base as jbase

    canon = jbase.canonical_fault_cfg(_jax_cfg(kw))
    final = jax.jit(jrunner.make_dyn_sim_fn(canon))(jax.random.key(0), 0, 0)
    return {"config": kw, "metrics": jbase.sim_metrics(_jax_cfg(kw), final),
            "sha256": convert.state_digests(_jax_leaves(final))}


def _jax_served_flush():
    from blockchain_simulator_tpu.serve import ScenarioServer as JServer

    with JServer(max_batch=2, max_wait_ms=1.0, start=False) as srv:
        pends = [srv.submit(dict(FLUSH, seed=s)) for s in FLUSH_SEEDS]
        srv.start()
        got = [p.result(600) for p in pends]
    assert all(r["status"] == "ok" and r["batch"]["mode"] == "batched" for r in got), got
    return {"request": FLUSH, "batch": [r["batch"] for r in got],
            "metrics": [r["metrics"] for r in got]}


def _jax_chip(kw):
    points = [(f, s) for f in CHIP_F for s in CHIP_SEEDS]
    out = _jax_batch(kw, [s for _, s in points], [0] * 4, [f for f, _ in points])
    return {"config": kw, "f_values": list(CHIP_F), "seeds": list(CHIP_SEEDS),
            "metrics": out["batched_metrics"], "sha256": out["batched_sha256"]}


def _jax_committee_batch():
    out = _jax_batch(COMMITTEE_BATCH, (0, 1), (0, 0))
    return {"config": COMMITTEE_BATCH, "metrics": out["batched_metrics"],
            "sha256": out["batched_sha256"]}


ENTRIES = {
    "arms": lambda: {a: _jax_batch(kw, SEEDS, CRASHED, solo=True) for a, kw in ARMS.items()},
    "committees": lambda: {c: _jax_committee(kw) for c, kw in COMMITTEES.items()},
    "committee_batch": _jax_committee_batch,
    "served_flush": _jax_served_flush,
    "chip": lambda: {name: _jax_chip(kw) for name, kw in CHIP.items()},
}


def write_golden(names):
    import jax

    doc = (json.loads(GOLDEN.read_text()) if GOLDEN.exists()
           else {"entries": {}})
    for name in names or sorted(ENTRIES):
        doc["entries"][name] = ENTRIES[name]()
        print(f"entry {name} done", flush=True)
    doc["about"] = ("JAX package (blockchain_simulator_tpu) rows that the PyTorch port's "
                    "tick-engine lanes must reproduce bit for bit: vmapped batches "
                    "(metrics and convert.state_digests a lane) with each lane's solo "
                    "digests, committees under lax.map, a committee sweep batch, the JAX "
                    "ScenarioServer's answers to a two-request flush, and chip_smoke.py's "
                    f"tick-lanes entries. Written by: {WRITTEN_BY}")
    doc["jax_version"] = jax.__version__
    GOLDEN.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {GOLDEN}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] != ["--write-golden"]:
        sys.exit("usage: python tests/test_torch_lanes.py --write-golden [ENTRY ...]")
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_golden(sys.argv[2:])
