"""The node-sharded overlay of the PyTorch port: parallel/partition.
NeighborExchange and parallel/sweep.sharded_topo_sim_fn, case for case
against ``tests/test_zzexchange.py`` and ``tests/test_zzshardtopo.py``
(their configs and windows).

- ``NeighborExchange`` (one owner-bucketed all_to_all a read, plans from
  topo/spec.owner_bucket_plan) equals the global gather ``x[table]``, rows
  and column picks, on gloo groups of 1, 2 and 4 CPU ranks, with an uneven
  node count.  One group a rank count runs that check and all of its
  overlay cases (a rank process's start costs ~3 s of CPU here).
- Sharded kregular PBFT, Raft and Paxos (``layout="exchange"`` and
  ``"regather"``, uneven n) and the committee arm equal the port's single-device run and JAX's
  ``run_sharded_topo`` over a mesh of the same size, bit for bit: metrics
  and the sha256 of every final-state field.  JAX's side is the golden
  ``blockchain_simulator_tpu_torch/golden/shard_s0.json`` (written by
  ``tests/test_torch_shard.py --write-golden``); one case also runs live.

The rank jobs live in this file, which imports JAX only inside its tests:
a rank imports the module and nothing of JAX.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest

from blockchain_simulator_tpu_torch import convert
from blockchain_simulator_tpu_torch.models.base import sim_metrics
from blockchain_simulator_tpu_torch.parallel import multihost
from blockchain_simulator_tpu_torch.utils.config import FaultConfig, SimConfig
from test_torch_multihost import rank_slots

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "blockchain_simulator_tpu_torch" / "golden" / "shard_s0.json"

BASE = dict(fidelity="clean", stat_sampler="exact", edge_sampler="threefry")


def _kreg(**kw):
    base = dict(protocol="pbft", n=12, sim_ms=400, topology="kregular", degree=10, **BASE)
    base.update(kw)
    return base


# name -> (SimConfig kwargs, layout, ranks); faults as a FaultConfig dict
TOPO_CASES = {
    "kreg_pbft_crashed_exchange@2": (_kreg(faults=dict(n_crashed=2)), "exchange", 2),
    "kreg_pbft_uneven_exchange@4": (_kreg(n=13, degree=11), "exchange", 4),
    "kreg_pbft_regather@4": (_kreg(), "regather", 4),
    "kreg_raft_exchange@4": (_kreg(protocol="raft", sim_ms=1000, degree=9, delivery="stat",
                                   raft_proposal_delay_ms=300), "exchange", 4),
    "kreg_raft_uneven_regather@2": (_kreg(protocol="raft", n=13, sim_ms=1000, degree=9,
                                          delivery="stat", raft_proposal_delay_ms=300),
                                    "regather", 2),
    "kreg_paxos_exchange@2": (_kreg(protocol="paxos", sim_ms=800, degree=8), "exchange", 2),
    "kreg_paxos_uneven_regather@4": (_kreg(protocol="paxos", n=13, sim_ms=800, degree=8),
                                     "regather", 4),
    "committee_pbft@2": (dict(protocol="pbft", n=16, sim_ms=400, topology="committee",
                              committees=4, faults=dict(n_crashed=4), **BASE), "exchange", 2),
}


def topo_cfg(kw: dict, config_cls=SimConfig, fault_cls=FaultConfig):
    """A case's config in either package."""
    kw = dict(kw)
    faults = fault_cls(**kw.pop("faults", {}))
    return config_cls(faults=faults, **kw)


@pytest.fixture(autouse=True)
def release_jax_executables():
    """Free JAX's compiled programs once the process nears its mapping
    limit (tests/jax_mappings.py), as every port test file running JAX
    does."""
    yield
    import jax_mappings

    jax_mappings.release_if_high()


# ----------------------------------------------------- rank jobs ----------


def exchange_job(n: int, degree: int, width: int) -> dict:
    """On this rank of the group: the in-table of an ``(n, degree)``
    overlay, its owner-bucket plan over the ranks, and a
    :class:`NeighborExchange` in the global view; returns whether the
    exchanged rows (and a column pick) equal this rank's rows of the
    global gather, and the all_to_all count."""
    import torch

    from blockchain_simulator_tpu_torch.parallel import partition
    from blockchain_simulator_tpu_torch.parallel.mesh import make_mesh
    from blockchain_simulator_tpu_torch.topo import spec as topo_spec

    base_mesh = make_mesh(device="cpu")
    w = base_mesh.size
    table = topo_spec.in_table(n, degree, 0)
    pad = (-n) % w
    tab_p = np.pad(table, ((0, pad), (0, 0)))
    pos, send = topo_spec.owner_bucket_plan(tab_p, w)
    rng = np.random.RandomState(7)
    x = torch.as_tensor(rng.randint(0, 1 << 20, size=(n, width)).astype(np.int32))
    col = torch.as_tensor(rng.randint(0, width, size=table.shape).astype(np.int64))
    mesh = base_mesh.global_view(n)
    start, rows = mesh.rows(n)
    b = mesh.block(n)
    xg = partition.NeighborExchange(mesh, n, {"in": (
        torch.as_tensor(pos[mesh.rank * b:(mesh.rank + 1) * b]),
        torch.as_tensor(send[mesh.rank:mesh.rank + 1]))})
    want = x[torch.as_tensor(table[start:start + rows]).long()]
    want_col = x.reshape(-1)[(torch.as_tensor(table[start:start + rows]).long() * width
                              + col[start:start + rows])]
    with mesh.bind():
        got = xg(x[start:start + rows], "in")
        got_col = xg(x[start:start + rows], "in", col=col[start:start + rows])
    return {"rows": bool(torch.equal(got, want)), "col": bool(torch.equal(got_col, want_col)),
            "all_to_all": mesh.counts["all_to_all"]}


def group_job(names: list) -> dict:
    """This rank's exchange check and its reports of the overlay cases
    ``names`` (parallel/multihost.sharded_report), in one group."""
    out = {"exchange": exchange_job(13, 5, 3)}
    for name in names:
        kw, layout, _ = TOPO_CASES[name]
        out[name] = multihost.sharded_report(topo_cfg(kw), topo_layout=layout)
    return out


def _group(ranks: int) -> list:
    names = [name for name, case in TOPO_CASES.items() if case[2] == ranks]
    with rank_slots(ranks):
        return multihost.launch(group_job, ranks, args=(names,), device="cpu",
                                timeout_s=900)


# ---------------------------------------------------------- tests --------


def _assert_exchange(reports: list):
    for rep in reports:
        assert rep["exchange"]["rows"] and rep["exchange"]["col"]
        # one all_to_all a read, through the group at every size
        assert rep["exchange"]["all_to_all"] == 2


def test_neighbor_exchange_on_one_rank_equals_global_gather():
    with rank_slots(1):
        _assert_exchange(multihost.launch(group_job, 1, args=([],), device="cpu",
                                          timeout_s=300))


def _single(kw: dict) -> dict:
    from blockchain_simulator_tpu_torch import runner

    cfg = topo_cfg(kw)
    final = runner.final_state(cfg, device="cpu")
    return {"metrics": sim_metrics(cfg, final),
            "state_sha256": convert.state_digests(convert.state_to_numpy(final))}


@pytest.mark.parametrize("ranks", [2, 4])
def test_exchange_and_sharded_topo_equal_single_and_jax(ranks):
    """On one group of ``ranks`` ranks: the exchange check, then every
    overlay case of that size, each equal to JAX's ``run_sharded_topo``
    (golden) and to the port's single-device run, on every rank."""
    by_rank = _group(ranks)
    _assert_exchange(by_rank)
    entries = json.loads(GOLDEN.read_text())["entries"]
    names = [name for name in by_rank[0] if name != "exchange"]
    assert names and all(TOPO_CASES[name][2] == ranks for name in names)
    for name in names:
        kw, layout, _ = TOPO_CASES[name]
        want = entries[name]
        assert (want["config"], want["layout"], want["mesh_nodes"]) == (kw, layout, ranks)
        single = _single(kw)
        # JAX's run_sharded_topo equals JAX's single-device run, which the
        # port's single-device run equals (tests/test_torch_topo.py)
        assert (name, single["metrics"], single["state_sha256"]) == \
            (name, want["metrics"], want["state_sha256"])
        for rep in (r[name] for r in by_rank):
            assert (name, rep["metrics"], rep["state_sha256"]) == \
                (name, want["metrics"], want["state_sha256"])
        if kw["topology"] == "kregular" and kw["protocol"] != "paxos":
            kinds = by_rank[0][name]["collectives"]
            # the exchange reads neighbours with all_to_all, regather with
            # all_gather (Paxos reads its in-table row-locally: neither)
            assert (name, kinds["all_to_all"] > 0) == (name, layout == "exchange")


def jax_topo(kw: dict, layout: str, ranks: int) -> dict:
    """JAX's ``sharded_topo_sim_fn`` over ``ranks`` virtual devices: metrics
    and final-state digests."""
    import jax

    from blockchain_simulator_tpu.models.base import canonical_fault_cfg, sim_metrics as jm
    from blockchain_simulator_tpu.parallel import sweep as jsweep
    from blockchain_simulator_tpu.parallel.mesh import make_mesh
    from blockchain_simulator_tpu.utils import config as jconfig
    from test_torch_shard import _jax_leaves

    cfg = topo_cfg(kw, jconfig.SimConfig, jconfig.FaultConfig)
    mesh = make_mesh(n_node_shards=ranks, devices=jax.devices()[:ranks])
    sim = jsweep.sharded_topo_sim_fn(canonical_fault_cfg(cfg), mesh, layout=layout)
    nc, nb = cfg.faults.resolved_n_crashed(cfg.n), cfg.faults.n_byzantine
    final = jax.block_until_ready(sim(jax.random.key(cfg.seed), np.int32(nc), np.int32(nb)))
    return {"metrics": jm(cfg, final), "state_sha256": convert.state_digests(_jax_leaves(final))}


def test_golden_topo_entry_equals_live_jax():
    name = "kreg_pbft_uneven_exchange@4"
    want = json.loads(GOLDEN.read_text())["entries"][name]
    got = jax_topo(*TOPO_CASES[name])
    assert (got["metrics"], got["state_sha256"]) == (want["metrics"], want["state_sha256"])


def test_bad_layout_and_dense_refused():
    from blockchain_simulator_tpu_torch.models.base import canonical_fault_cfg
    from blockchain_simulator_tpu_torch.parallel import sweep
    from blockchain_simulator_tpu_torch.parallel.mesh import NodeMesh

    mesh = NodeMesh(2, 0, None, "cpu")
    with pytest.raises(ValueError, match="layout must be"):
        sweep.sharded_topo_sim_fn(canonical_fault_cfg(topo_cfg(_kreg())), mesh, layout="bogus")
    with pytest.raises(ValueError, match="no node-dim topo structure"):
        sweep.sharded_topo_sim_fn(SimConfig(protocol="pbft", n=8), mesh)
    cfg = topo_cfg(dict(protocol="pbft", n=18, sim_ms=400, topology="committee",
                        committees=6, **BASE))
    with pytest.raises(ValueError, match="not divisible"):
        sweep.sharded_topo_sim_fn(canonical_fault_cfg(cfg), NodeMesh(4, 0, None, "cpu"))
