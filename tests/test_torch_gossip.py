"""The port's gossip topology, held bit for bit to the JAX package.

The neighbour table (``ops/topology.kregular_out_neighbors``), the TTL flood
(``ops/delivery.gossip_fwd``) and whole runs of Paxos, PBFT and Raft over the
gossip digraph go through the JAX package and through the port on the CPU
(``device="cpu"``: the plain versions), and the metrics and every
final-state field must be equal.

Golden files (``blockchain_simulator_tpu_torch/golden/``), written by the JAX
package, which ``chip_smoke.py`` holds the port's runs on the card to:
``paxos_gossip_n10k_s0.json`` (BASELINE config 3, ``tools/run_config3.py``),
``pbft_gossip_n1000_s0.json`` and ``raft_gossip_n1000_s0.json``.  Each holds
the config, the metrics, a sha256 of every final-state field and of the
neighbour table.  Regenerate one with ``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_gossip.py --write-golden FILE`` (config 3 takes minutes of
JAX on the CPU: run it in the background).
"""

from __future__ import annotations

import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockchain_simulator_tpu import runner as jrunner
from blockchain_simulator_tpu.models import paxos as jpaxos
from blockchain_simulator_tpu.models import pbft as jpbft
from blockchain_simulator_tpu.ops import delivery as jdv
from blockchain_simulator_tpu.ops import topology as jtopology
from blockchain_simulator_tpu.utils import config as jconfig
from blockchain_simulator_tpu_torch import convert
from blockchain_simulator_tpu_torch import runner as trunner
from blockchain_simulator_tpu_torch.models import paxos as tpaxos
from blockchain_simulator_tpu_torch.models import pbft as tpbft
from blockchain_simulator_tpu_torch.ops import delivery as tdv
from blockchain_simulator_tpu_torch.ops import topology as ttopology
from blockchain_simulator_tpu_torch.utils import config as tconfig
from blockchain_simulator_tpu_torch.utils import threefry
from test_torch_pbft import (  # noqa: F401 (release_jax_executables: autouse)
    _assert_leaves_equal, _cfgs, _jax_leaves, release_jax_executables,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN_DIR = REPO / "blockchain_simulator_tpu_torch" / "golden"
WRITTEN_BY = "PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_gossip.py --write-golden"
GOLDENS = {
    # BASELINE config 3 exactly as tools/run_config3.py builds it
    "paxos_gossip_n10k_s0.json": {
        "n10k": dict(protocol="paxos", n=10_000, sim_ms=3000, topology="gossip",
                     degree=16, delivery="stat", model_serialization=False,
                     paxos_retry_timeout_ms=600),
    },
    # the windows are cut to what chip_smoke.py's time limit allows: over
    # gossip every tick runs the exact sampler's rejection loops on the card
    # (PERF.md section 4).  PBFT's 600 ms holds the first view change and
    # 2 blocks (the second view change comes near 1,600 ms); Raft's
    # 2,000 ms holds the election, the step-downs and 13 blocks
    "pbft_gossip_n1000_s0.json": {
        "n1000": dict(protocol="pbft", n=1000, sim_ms=600, topology="gossip",
                      degree=16, gossip_hops=8, delivery="stat"),
    },
    "raft_gossip_n1000_s0.json": {
        "n1000": dict(protocol="raft", n=1000, sim_ms=2000, topology="gossip",
                      degree=16, gossip_hops=8, delivery="stat"),
    },
}
# ARTIFACT_config3.json's JAX results for config 3 (an older jax; its
# "single" run is a different seed): a cross-check, never held
CONFIG3_ARTIFACT = "ARTIFACT_config3.json"


def golden_entry(config: dict, seed: int = 0) -> dict:
    """One golden entry, computed by the JAX package."""
    jcfg = jconfig.SimConfig(**config)
    final = jrunner.final_state(jcfg, seed=seed)
    table = jtopology.kregular_out_neighbors(jcfg.n, jcfg.degree, jcfg.seed)
    return {
        "config": config,
        "seed": seed,
        "jax_version": jax.__version__,
        "numpy_version": np.__version__,
        "metrics": jrunner.base_model.sim_metrics(jcfg, final),
        "state_sha256": convert.state_digests(_jax_leaves(final)),
        "neighbours_sha256": convert.digest(table),
    }


def write_golden(names=None):
    for fname, configs in GOLDENS.items():
        if names and fname not in names:
            continue
        doc = {
            "about": "JAX package (blockchain_simulator_tpu) results that the "
                     "PyTorch port must reproduce bit for bit: metrics, a sha256 "
                     "of every final-state field (blockchain_simulator_tpu_torch/"
                     "convert.state_digests) and of the gossip neighbour table. "
                     f"Written by: {WRITTEN_BY}",
            "entries": {name: golden_entry(cfg) for name, cfg in configs.items()},
        }
        if fname.startswith("paxos"):
            art = json.loads((REPO / CONFIG3_ARTIFACT).read_text())
            doc["cross_check"] = {"source": CONFIG3_ARTIFACT,
                                  "single": art["single"], "sharded": art["sharded"]}
        (GOLDEN_DIR / fname).write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
        print(f"wrote {GOLDEN_DIR / fname}", flush=True)


# --------------------------------------------------------------------------- #
# the table and the flood                                                     #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n, deg, seed", [(64, 4, 0), (256, 8, 3), (10_000, 16, 0)])
def test_neighbour_table_equals_jax(n, deg, seed):
    want = jtopology.kregular_out_neighbors(n, deg, seed)
    got = ttopology.kregular_out_neighbors(n, deg, seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    dev = ttopology.neighbours(n, deg, seed, "cpu")
    assert np.array_equal(dev.numpy(), want)
    assert ttopology.neighbours(n, deg, seed, "cpu") is dev  # built once
    if n <= 256:
        assert (ttopology.flood_reach_hops(n, deg, got, 0)
                == jtopology.flood_reach_hops(n, deg, want, 0))


@pytest.mark.parametrize("drop", [0.0, 0.15])
def test_gossip_fwd_equals_jax(drop):
    """(n, deg, p) = (64, 4, 3), TTL-encoded values on a third of the rows,
    one-way delays [3, 53): duplicate receivers and self-loops included."""
    n, deg, p, lo, hi = 64, 4, 3, 3, 53
    rng = np.random.default_rng(5)
    vals = (rng.integers(1, 10_000, (n, p)) * (rng.random((n, p)) < 0.33)).astype(np.int32)
    nbrs = jtopology.kregular_out_neighbors(n, deg, 0)
    jk = jax.random.fold_in(jax.random.key(2), 0x33)
    want = jdv.gossip_fwd(jk, jnp.asarray(vals), jnp.asarray(nbrs), n, lo, hi, drop)
    got = tdv.gossip_fwd(np.asarray(jax.random.key_data(jk), np.int64),
                         torch.from_numpy(vals), ttopology.neighbours(n, deg, 0, "cpu"),
                         n, lo, hi, drop)
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got > 0).any()


# --------------------------------------------------------------------------- #
# whole runs over gossip                                                      #
# --------------------------------------------------------------------------- #

# tests/test_gossip.py's GCFG, PBFT_GCFG and RAFT_GCFG, cut to n <= 128 and
# windows <= 3,000 ms (the Raft window keeps one leader step-down, at 174 ms)
RUNS = {
    "paxos": dict(protocol="paxos", n=64, sim_ms=1200, topology="gossip", degree=8,
                  gossip_hops=8, paxos_retry_timeout_ms=600),
    "paxos_faults": dict(protocol="paxos", n=32, sim_ms=1000, topology="gossip",
                         degree=4, gossip_hops=6, paxos_retry_timeout_ms=600,
                         faults=dict(n_crashed=3, n_byzantine=2, drop_prob=0.05)),
    "pbft": dict(protocol="pbft", n=32, sim_ms=500, topology="gossip", degree=8,
                 gossip_hops=8, delivery="stat"),
    "pbft_faults_edge": dict(protocol="pbft", n=32, sim_ms=900, topology="gossip",
                             degree=4, gossip_hops=6, faults=dict(drop_prob=0.05,
                                                                  n_crashed=3)),
    "raft": dict(protocol="raft", n=128, sim_ms=800, topology="gossip", degree=8,
                 gossip_hops=8, delivery="stat", raft_proposal_delay_ms=300),
    "raft_faults": dict(protocol="raft", n=32, sim_ms=800, topology="gossip", degree=4,
                        gossip_hops=6, delivery="stat", raft_proposal_delay_ms=300,
                        faults=dict(drop_prob=0.05, n_crashed=3, n_byzantine=2)),
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
            jcfg, tcfg = _cfgs(faults=kw.pop("faults", None), **kw)
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


# --------------------------------------------------------------------------- #
# refusals: the ValueErrors of tests/test_gossip.py, in the port              #
# --------------------------------------------------------------------------- #

GCFG = dict(protocol="paxos", n=256, sim_ms=6000, topology="gossip", degree=8,
            gossip_hops=8, paxos_retry_timeout_ms=600)


def test_gossip_validation_matches_jax():
    # a retry timeout below the flood horizon
    jcfg, tcfg = _cfgs(**dict(GCFG, paxos_retry_timeout_ms=200))
    with pytest.raises(ValueError, match="reply horizon"):
        jpaxos.init(jcfg)
    with pytest.raises(ValueError, match="reply horizon"):
        tpaxos.init(tcfg, device="cpu")
    # raft gossip rides the stat channels; mixed keeps the full mesh;
    # reference fidelity has no gossip relay
    for kw, exc, match in [
        (dict(protocol="raft", topology="gossip"), ValueError, "stat"),
        (dict(protocol="mixed", topology="gossip"), NotImplementedError, "mixed"),
        (dict(protocol="paxos", topology="gossip", fidelity="reference"), ValueError,
         "full mesh"),
    ]:
        with pytest.raises(exc, match=match):
            jconfig.SimConfig(**kw)
        with pytest.raises(exc, match=match):
            tconfig.SimConfig(**kw)
    # degenerate degree
    with pytest.raises(ValueError, match="degree"):
        ttopology.kregular_out_neighbors(64, 1, seed=0)


def test_gossip_pbft_requires_exact_window():
    jcfg, tcfg = _cfgs(protocol="pbft", n=256, sim_ms=3000, topology="gossip",
                       degree=8, gossip_hops=8, delivery="stat", pbft_window=8,
                       pbft_max_slots=64)
    with pytest.raises(ValueError, match="exact vote-table mode"):
        jpbft.init(jcfg)
    with pytest.raises(ValueError, match="exact vote-table mode"):
        tpbft.init(tcfg, device="cpu")


def test_goldens_hold_their_configs_and_tables():
    """The goldens chip_smoke.py holds the card to: their configs, the
    neighbour table's digest (the card checks it first), and the reference
    milestones (every acceptor executes, 40 PBFT blocks, one Raft leader)."""
    for fname, configs in GOLDENS.items():
        doc = json.loads((GOLDEN_DIR / fname).read_text())
        assert WRITTEN_BY in doc["about"]
        assert {k: e["config"] for k, e in doc["entries"].items()} == configs
        for entry in doc["entries"].values():
            cfg = tconfig.SimConfig(**entry["config"])
            table = ttopology.kregular_out_neighbors(cfg.n, cfg.degree, cfg.seed)
            assert entry["neighbours_sha256"] == convert.digest(table)
            assert entry["metrics"]["agreement_ok"]
    px = json.loads((GOLDEN_DIR / "paxos_gossip_n10k_s0.json").read_text())
    assert px["entries"]["n10k"]["metrics"]["acceptor_executes"] == 10_000
    assert sorted(px["entries"]["n10k"]["state_sha256"]) == sorted(tpaxos.STATE_FIELDS)
    pb = json.loads((GOLDEN_DIR / "pbft_gossip_n1000_s0.json").read_text())
    assert pb["entries"]["n1000"]["metrics"]["blocks_final_all_nodes"] > 0
    assert pb["entries"]["n1000"]["metrics"]["view_changes"] == 1
    rf = json.loads((GOLDEN_DIR / "raft_gossip_n1000_s0.json").read_text())
    assert rf["entries"]["n1000"]["metrics"]["n_leaders"] == 1
    assert rf["entries"]["n1000"]["metrics"]["blocks"] > 0


if __name__ == "__main__":
    if not sys.argv[1:] or sys.argv[1] != "--write-golden":
        sys.exit("usage: python tests/test_torch_gossip.py --write-golden [FILE ...]")
    jax.config.update("jax_platforms", "cpu")
    write_golden(sys.argv[2:])
