"""Node-sharded runs of the PyTorch port (parallel/shard.py) against the
JAX package's ``run_sharded``.

The port runs one process a rank: gloo groups of 2 CPU ranks and of 4
(parallel/multihost.launch, one torch thread a rank) run every arm, two
groups of a size at once, each taking every other arm (a rank process's
start, ``import torch`` most of it, costs ~3 s of CPU here); the JAX
package runs ``run_sharded`` over a mesh of as many virtual CPU devices
(tests/conftest.py gives 8).  JAX's sharded
draws fold the shard index into their keys, never the process, so the two
must agree bit for bit: the metrics dict and the sha256 of every
final-state field, on every rank.  The arms are those of
``tests/test_parallel.py``, at its node counts: the PBFT tick engine (edge
and stat), the round path (explicit, and ``auto`` at n = 8192), the Raft
tick engine (edge and stat), the Raft heartbeat path, Paxos and the mixed
sim.  The windows are test_parallel's too (the mixed sim's is
``tests/test_mixed.py``'s ``STAT``): two groups of 2 ranks at once,
each taking every other arm, run them in ~80 s here.  The groups of 4
run the Raft tick, Paxos and mixed arms at shorter windows
(:data:`ARMS_AT_4`; each still elects, commits and finalizes), since at
full windows four ranks cost more CPU than the suite's time limit holds.
A group holds its ranks' slots of :func:`test_torch_multihost.rank_slots`
while it runs, so the suite's workers never run more than eight rank
processes at once.

JAX's side of every (arm, mesh size) case is read from the golden
``blockchain_simulator_tpu_torch/golden/shard_s0.json``, which the JAX
package writes (compiling the sharded programs takes JAX up to ~50 s a
case); the cheap cases are also run live and must equal their golden
entries.  The same file holds the two runs over a 1-device mesh that
``chip_smoke.py``'s NCCL world-size-1 phase is held to.  Regenerate:
``PYTHONPATH=.:tests JAX_PLATFORMS=cpu python tests/test_torch_shard.py
--write-golden`` (~8 min).
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from blockchain_simulator_tpu.parallel import shard as jshard
from blockchain_simulator_tpu.parallel.mesh import make_mesh as jmake_mesh
from blockchain_simulator_tpu.utils import config as jconfig
from blockchain_simulator_tpu_torch import convert
from blockchain_simulator_tpu_torch.parallel import multihost
from blockchain_simulator_tpu_torch.parallel import shard as tshard
from blockchain_simulator_tpu_torch.parallel.mesh import NodeMesh
from blockchain_simulator_tpu_torch.utils import config as tconfig
from test_torch_multihost import rank_slots
from test_torch_pbft import release_jax_executables  # noqa: F401  (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "blockchain_simulator_tpu_torch" / "golden" / "shard_s0.json"

ARMS = {
    "pbft_edge": dict(protocol="pbft", n=64, sim_ms=800, pbft_max_rounds=10),
    "pbft_stat": dict(protocol="pbft", n=64, sim_ms=800, pbft_max_rounds=10,
                      delivery="stat"),
    "round": dict(protocol="pbft", n=64, sim_ms=1200, pbft_max_rounds=20, delivery="stat",
                  model_serialization=False, schedule="round"),
    "round_auto_n8192": dict(protocol="pbft", n=8192, sim_ms=400, delivery="stat",
                             model_serialization=False, pbft_max_slots=16),
    "raft_edge": dict(protocol="raft", n=16, sim_ms=2500),
    "raft_stat": dict(protocol="raft", n=16, sim_ms=2500, delivery="stat"),
    "raft_hb": dict(protocol="raft", n=16, sim_ms=2500, delivery="stat", schedule="round"),
    "paxos": dict(protocol="paxos", n=16, sim_ms=3000),
    "mixed": dict(protocol="mixed", n=48, mixed_shards=8, sim_ms=3000, delivery="stat",
                  model_serialization=False),
}

# The group of four runs the four costliest arms at shorter windows, where
# each still elects, commits and finalizes: at four ranks their windows
# above cost ~250 s more CPU than the suite's time limit holds (the group
# of two runs them in full).
ARMS_AT_4 = dict(ARMS, **{
    "raft_edge": dict(protocol="raft", n=16, sim_ms=500, raft_proposal_delay_ms=200),
    "raft_stat": dict(protocol="raft", n=16, sim_ms=500, delivery="stat",
                      raft_proposal_delay_ms=200),
    "paxos": dict(protocol="paxos", n=16, sim_ms=600),
    "mixed": dict(protocol="mixed", n=48, mixed_shards=8, sim_ms=600, delivery="stat",
                  model_serialization=False, raft_proposal_delay_ms=200),
})


def arms(n_ranks: int) -> dict:
    """The arms' configs for a group of ``n_ranks`` ranks."""
    return ARMS_AT_4 if n_ranks == 4 else ARMS

# chip_smoke.py's shard-nccl phase: config 2 and the bench headline
# (bench._cfg) cut to 200 rounds, each over a 1-device mesh
GOLDEN_CONFIGS = {
    "config2": dict(protocol="pbft", n=1000, sim_ms=2500),
    "headline_200": dict(protocol="pbft", n=100_000, sim_ms=200 * 50 + 100,
                         pbft_max_rounds=200, pbft_max_slots=208, pbft_window=8,
                         delivery="stat", model_serialization=False),
}


def _jax_leaves(state) -> dict:
    """Numpy leaves of a JAX final state keyed as convert.state_to_numpy
    keys the port's (a mixed state's ``"raft.<field>"`` / ``"pbft.<field>"``)."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{g.name}": np.asarray(getattr(v, g.name))
                        for g in dataclasses.fields(v)})
        else:
            out[f.name] = np.asarray(v)
    return out


def jax_sharded(kw: dict, n_shards: int, seed: int = 0) -> dict:
    """JAX's ``run_sharded`` over ``n_shards`` virtual devices: metrics and
    the sha256 of every final-state field."""
    jcfg = jconfig.SimConfig(**kw)
    mesh = jmake_mesh(n_node_shards=n_shards, devices=jax.devices()[:n_shards])
    final = jax.block_until_ready(jshard.make_sharded_sim_fn(jcfg, mesh)(jax.random.key(seed)))
    from blockchain_simulator_tpu.models.base import get_protocol

    return {"metrics": get_protocol(jcfg.protocol).metrics(jcfg, final),
            "state_sha256": convert.state_digests(_jax_leaves(final))}


# the extra runs of the 2-rank group: a kregular config through run_sharded
# (JAX's shard_map path) and config "pbft_edge" a second time
KREG = dict(protocol="pbft", n=12, sim_ms=400, topology="kregular", degree=10,
            fidelity="clean", stat_sampler="exact", edge_sampler="threefry")


def port_sharded(runs: list, n_ranks: int, groups: int = 2) -> list:
    """The port's sharded runs of ``runs`` (config kwargs) on ``groups``
    gloo groups of ``n_ranks`` CPU ranks at once, run ``i`` on group ``i %
    groups``, one after the other within a group (a rank spends most of a
    run waiting on its peers' collectives, so the groups share the CPUs):
    ``[run][rank]`` reports (parallel/multihost.sharded_reports)."""
    from concurrent.futures import ThreadPoolExecutor

    def group(chunk):
        with rank_slots(n_ranks):
            by_rank = multihost.launch(
                multihost.sharded_reports, n_ranks,
                args=([(tconfig.SimConfig(**kw), 0, None) for kw in chunk],),
                device="cpu", timeout_s=900)
        return [list(reps) for reps in zip(*by_rank)]

    with ThreadPoolExecutor(groups) as pool:
        done = list(pool.map(group, [runs[g::groups] for g in range(groups)]))
    return [done[i % groups][i // groups] for i in range(len(runs))]


def _golden() -> dict:
    return json.loads(GOLDEN.read_text())["entries"]


def case(arm: str, n_shards: int) -> str:
    return f"{arm}@{n_shards}"


def _assert_equal(want: dict, reports: list):
    for rank, rep in enumerate(reports):
        assert rep["metrics"] == want["metrics"], rank
        assert rep["state_sha256"] == want["state_sha256"], rank


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_sharded_runs_equal_jax(n_ranks):
    """Every arm on one group of ``n_ranks`` ranks equals JAX's run over as
    many devices (golden), on every rank; with 2 ranks also a kregular
    config through ``run_sharded`` (JAX's shard_map path: neighbour rows
    all-gathered, the rank folded into the keys) against JAX live, and the
    first arm run again in the same group, equal to its first run."""
    configs = arms(n_ranks)
    runs = list(configs.values()) + ([KREG, ARMS["pbft_edge"]] if n_ranks == 2 else [])
    results = port_sharded(runs, n_ranks)
    golden = _golden()
    for arm, reports in zip(configs, results):
        want = golden[case(arm, n_ranks)]
        assert want["config"] == configs[arm], arm
        for rank, rep in enumerate(reports):
            assert (arm, rank, rep["metrics"]) == (arm, rank, want["metrics"])
            assert (arm, rank, rep["state_sha256"]) == (arm, rank, want["state_sha256"])
        assert sum(reports[0]["collectives"].values()) > 0  # the ranks did talk
    if n_ranks == 2:
        _assert_equal(jax_sharded(KREG, 2), results[len(ARMS)])
        again, first = results[-1], results[0]
        assert [r["state_sha256"] for r in again] == [r["state_sha256"] for r in first]
        assert again[0]["metrics"] == first[0]["metrics"]


@pytest.mark.parametrize("arm, n_shards", [("pbft_edge", 4), ("round", 2),
                                           ("round_auto_n8192", 4)])
def test_golden_entries_equal_live_jax(arm, n_shards):
    want = _golden()[case(arm, n_shards)]
    got = jax_sharded(arms(n_shards)[arm], n_shards)
    assert (got["metrics"], got["state_sha256"]) == (want["metrics"], want["state_sha256"])


@pytest.mark.parametrize("kw, shards", [
    (dict(protocol="pbft", n=10, sim_ms=100), 8),
    (dict(protocol="raft", n=10, sim_ms=100, delivery="stat", schedule="round"), 4),
    (dict(protocol="pbft", n=10, sim_ms=100, delivery="stat", schedule="round"), 4),
    (dict(protocol="mixed", n=30, mixed_shards=6, sim_ms=100), 4),
    (dict(protocol="mixed", n=30, mixed_shards=6, sim_ms=100, delivery="stat",
          model_serialization=False), 4),
])
def test_indivisible_n_raises_jax_error(kw, shards):
    with pytest.raises(ValueError) as jerr:
        jshard.run_sharded(jconfig.SimConfig(**kw), jmake_mesh(n_node_shards=shards))
    # the refusal comes before any collective: a mesh object without a group
    mesh = NodeMesh(shards, 0, None, "cpu")
    with pytest.raises(ValueError) as terr:
        tshard.make_sharded_sim_fn(tconfig.SimConfig(**kw), mesh)
    assert str(terr.value) == str(jerr.value)


def test_sharded_modules_import_no_jax():
    code = (
        "import sys\n"
        "from blockchain_simulator_tpu_torch.parallel import mesh, multihost, partition, "
        "shard, sweep\n"
        "from blockchain_simulator_tpu_torch import cli, profile_shard\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'blockchain_simulator_tpu'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_golden_small_config_regenerates():
    """The golden's entries are JAX's run over a 1-device mesh: the config-2
    entry's milestones hold, and a 1-rank mesh of the port (no process
    group) equals JAX's 1-device run on a small config."""
    e = _golden()["config2"]
    assert e["config"] == GOLDEN_CONFIGS["config2"]
    m = e["metrics"]
    assert (m["rounds_sent"], m["blocks_final_all_nodes"], m["agreement_ok"]) == (40, 40, True)
    kw = dict(protocol="pbft", n=16, sim_ms=400, pbft_max_rounds=5)
    mesh = NodeMesh(1, 0, None, "cpu")
    from blockchain_simulator_tpu_torch.utils import threefry

    final = tshard.make_sharded_sim_fn(tconfig.SimConfig(**kw), mesh)(threefry.key(0))
    assert convert.state_digests(convert.state_to_numpy(final)) == \
        jax_sharded(kw, 1)["state_sha256"]


def write_golden():
    doc = {
        "about": "JAX package (blockchain_simulator_tpu) node-sharded runs "
                 "(parallel/shard.run_sharded over a mesh of mesh_nodes devices: the "
                 "shard index folded into every per-shard key) that the port's runs "
                 "over as many ranks must reproduce bit for bit: metrics and a "
                 "sha256 of every final-state field.  config2 / headline_200: a "
                 "1-device mesh, chip_smoke.py's NCCL world-size-1 phase; "
                 "<arm>@<W>: tests/test_torch_shard.py's gloo groups; the entries with a "
                 "layout: parallel/sweep.sharded_topo_sim_fn, tests/"
                 "test_torch_exchange.py's.  Written by: "
                 "python tests/test_torch_shard.py --write-golden",
        "entries": {},
    }
    from test_torch_exchange import TOPO_CASES, jax_topo

    runs = [(name, kw, 1) for name, kw in GOLDEN_CONFIGS.items()]
    runs += [(case(arm, w), kw, w) for w in (2, 4) for arm, kw in arms(w).items()]
    for name, kw, w in runs:
        res = jax_sharded(kw, w)
        doc["entries"][name] = {"config": kw, "seed": 0, "mesh_nodes": w,
                                "jax_version": jax.__version__, **res}
        print(name, res["metrics"], flush=True)
    # tests/test_torch_exchange.py's overlay cases: run_sharded_topo's program
    for name, (kw, layout, w) in TOPO_CASES.items():
        res = jax_topo(kw, layout, w)
        doc["entries"][name] = {"config": kw, "layout": layout, "seed": 0, "mesh_nodes": w,
                                "jax_version": jax.__version__, **res}
        print(name, res["metrics"], flush=True)
    GOLDEN.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    if "--write-golden" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
        write_golden()
