"""The PyTorch port's fault operands and sweeps, held bit for bit to the JAX
package.

Each sweep goes through the JAX package's ``parallel/sweep.py`` and through
the port's on the CPU (``device="cpu"``), and compares the metrics rows and
a sha256 of every final-state field of every lane: the JAX lanes' finals
come from ``dyn_batched_fn`` (``jit(vmap(make_dyn_sim_fn(canon)))``), the
port's from its own ``dyn_batched_fn``.  The cases:

- the round path over lanes of different seeds on both stat samplers (under
  ``"normal"`` a vmapped row is not its solo run: the first-lane rule, which
  the case also shows);
- the forge sweep on the PBFT tick engine (its lanes side by side);
- a Raft crash sweep on the heartbeat path whose lanes mix a taken and a
  refused handoff (``"normal"`` draws), and Raft sweeps on the tick engine
  (edge threefry and rbg, stat normal);
- ``run_fault_sweep`` over two drop structures;
- ``run_multi_seed`` (solo semantics) on the ``"normal"`` round path;
- the mixed sim's static fallback in ``run_fault_sweep``.

Beside them: the fault masks and canonical configs against JAX's, a
``"normal"`` PBFT tick batch against JAX's rows, the refusals (the mixed
sim, the arms later slices bring), a one-lane batch against
``final_state``, and JAX's finals
carried across with ``convert``.  The JAX side of each sweep is computed once
a process (the ``runs`` fixture), and no case reads another's.

Golden files (the card's runs, ``chip_smoke.py``):
``blockchain_simulator_tpu_torch/golden/pbft_config4_n100k_s01.json`` —
BASELINE config 4 as ``tools/run_config4.py`` builds it at n = 100,000, one
12-lane batch of ``run_byzantine_sweep`` (f in {0, 8333, 16666, 25000,
33333, 50001} x seeds (0, 1), forge off) — and
``blockchain_simulator_tpu_torch/golden/pbft_drop_n10k_s0.json`` — the drop
sweep as ``tools/run_drop_sweep.py`` builds it (eight drop structures, seed
0).  Both are written by the JAX package on the CPU with ``PYTHONPATH=.
JAX_PLATFORMS=cpu python tests/test_torch_sweep.py --write-golden`` (a few
minutes; the config-4 batch holds 12 x 100,000 nodes).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockchain_simulator_tpu import runner as jrunner
from blockchain_simulator_tpu.models import base as jbase
from blockchain_simulator_tpu.parallel import sweep as jsweep
from blockchain_simulator_tpu.utils.checkpoint import config_to_json as jconfig_to_json
from blockchain_simulator_tpu_torch import convert
from blockchain_simulator_tpu_torch import runner as trunner
from blockchain_simulator_tpu_torch.models import base as tbase
from blockchain_simulator_tpu_torch.parallel import sweep as tsweep
from blockchain_simulator_tpu_torch.utils import config as tconfig
from blockchain_simulator_tpu_torch.utils import obs
from blockchain_simulator_tpu_torch.utils.checkpoint import config_to_json as tconfig_to_json
from test_torch_pbft import _cfgs, release_jax_executables  # noqa: F401 (autouse fixture)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN_DIR = REPO / "blockchain_simulator_tpu_torch" / "golden"
CONFIG4_GOLDEN = GOLDEN_DIR / "pbft_config4_n100k_s01.json"
DROP_GOLDEN = GOLDEN_DIR / "pbft_drop_n10k_s0.json"
WRITTEN_BY = "PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_sweep.py --write-golden"

# BASELINE config 4 as tools/run_config4.py:34-50 builds it (n = 100,000,
# 200 rounds); the f values are its five points and the one past N/2
CONFIG4_ROUNDS = 200
CONFIG4 = dict(protocol="pbft", n=100_000, sim_ms=CONFIG4_ROUNDS * 50 + 100,
               pbft_max_rounds=CONFIG4_ROUNDS, pbft_max_slots=CONFIG4_ROUNDS + 8,
               pbft_window=8, delivery="stat", model_serialization=False)
CONFIG4_F = [0, 8333, 16666, 25000, 33333, 50001]
CONFIG4_SEEDS = (0, 1)
# the drop sweep as tools/run_drop_sweep.py:39-51 builds it
DROP_ROUNDS = 40
DROP = dict(protocol="pbft", n=10_000, sim_ms=DROP_ROUNDS * 50 + 100,
            pbft_max_rounds=DROP_ROUNDS, pbft_max_slots=DROP_ROUNDS + 8,
            pbft_view_change_num=0, delivery="stat", model_serialization=False,
            schedule="round")
DROP_PS = [0.0, 0.02, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5]

ROUND = dict(protocol="pbft", n=64, sim_ms=400, delivery="stat", schedule="round",
             model_serialization=False)
RAFT_HB = dict(protocol="raft", n=16, sim_ms=800, delivery="stat", schedule="round",
               raft_proposal_delay_ms=200)
# each sweep: (base config, kind, sweep arguments); "byz" is run_byzantine_sweep,
# "faults" run_fault_sweep over FaultConfig kwargs
SWEEPS = {
    # lanes of different seeds and f on the round path; "normal" shows the
    # first-lane rule, "exact" ends each lane's loops where its own would
    "round_normal": (dict(ROUND, stat_sampler="normal"), "byz",
                     dict(f_values=[0, 10, 21], seeds=(0, 1), forge=False)),
    "round_exact": (dict(ROUND, stat_sampler="exact"), "byz",
                    dict(f_values=[0, 10, 21], seeds=(0, 1), forge=False)),
    # the forging attack on the PBFT tick engine (its lanes side by side)
    "forge_tick": (dict(protocol="pbft", n=8, sim_ms=400), "byz",
                   dict(f_values=[0, 1, 2], seeds=(1,), forge=True)),
    # 9 of 16 crashed elect no leader: those lanes' handoffs are refused
    # and the tick engine continues every lane (its "normal" draws follow
    # the first lane) while the others scan
    "raft_hb_normal": (dict(RAFT_HB, stat_sampler="normal"), "faults",
                       dict(fcs=[dict(n_crashed=0), dict(n_crashed=9)], seeds=(0, 1))),
    # the Raft tick engine (edge delivery) over lanes, crashes and liars;
    # then its Philox arms, whose vmapped draws follow the first lane
    "raft_tick": (dict(protocol="raft", n=12, sim_ms=700), "faults",
                  dict(fcs=[dict(n_crashed=3), dict(n_crashed=2, n_byzantine=2)],
                       seeds=(0,))),
    "raft_tick_normal": (dict(protocol="raft", n=16, sim_ms=400, delivery="stat",
                              stat_sampler="normal", schedule="tick"), "faults",
                         dict(fcs=[dict(n_crashed=2), dict(n_byzantine=3)], seeds=(0, 1))),
    "raft_tick_rbg": (dict(protocol="raft", n=12, sim_ms=400, edge_sampler="rbg"), "faults",
                      dict(fcs=[dict(n_crashed=1), dict(n_byzantine=2)], seeds=(0, 1))),
    # two drop structures (two groups), counts varying inside each
    "drops": (dict(ROUND, pbft_view_change_num=0), "faults",
              dict(fcs=[dict(drop_prob=0.1), dict(drop_prob=0.1, n_crashed=5),
                        dict(drop_prob=0.3)], seeds=(2,))),
}


def _canon_points(cfg, kind, args, base_mod):
    """``[(canon, [(fault kwargs, seed), ...])]``: the sweep's structure
    groups, in the sweep's order, each with its lanes, by ``base_mod``'s
    ``canonical_fault_cfg`` (either package's)."""
    if kind == "byz":
        fcs = [dict(n_byzantine=f, byz_forge=args["forge"]) for f in args["f_values"]]
    else:
        fcs = args["fcs"]
    fc_cls = type(cfg.faults)
    groups: dict = {}
    for fc in fcs:
        canon = base_mod.canonical_fault_cfg(cfg.with_(faults=fc_cls(**fc)))
        groups.setdefault(canon, [])
        groups[canon] += [(fc_cls(**fc), s) for s in args["seeds"]]
    return list(groups.items())


def _jax_lane_digests(jcfg, kind, args) -> list:
    """Per-lane state digests of the JAX sweep: ``dyn_batched_fn`` of each
    structure group, lanes in the sweep's row order."""
    out = []
    for canon, lanes in _canon_points(jcfg, kind, args, jbase):
        keys = jax.vmap(jax.random.key)(jnp.asarray([s for _, s in lanes], jnp.uint32))
        nc = jnp.asarray([f.resolved_n_crashed(jcfg.n) for f, _ in lanes], jnp.int32)
        nb = jnp.asarray([f.n_byzantine for f, _ in lanes], jnp.int32)
        finals = jax.block_until_ready(jsweep.dyn_batched_fn(canon)(keys, nc, nb))
        leaves = {f.name: np.asarray(getattr(finals, f.name))
                  for f in dataclasses.fields(finals)}
        out += [convert.state_digests(convert.lane_leaves(leaves, i)) for i in range(len(lanes))]
    return out


class _Recorded:
    """Records the lane-stacked finals of every ``dyn_batched_fn`` program
    the port's sweep dispatches (``with _Recorded() as rec``), so the
    port's per-lane digests come from the sweep's own run."""

    def __enter__(self):
        self.real, self.digests = tsweep.dyn_batched_fn, []

        def wrapped(cfg):
            batched = self.real(cfg)

            def run(*args):
                finals = batched(*args)
                leaves = convert.state_to_numpy(finals)
                self.digests += [convert.state_digests(convert.lane_leaves(leaves, i))
                                 for i in range(len(args[0]))]
                return finals
            return run

        tsweep.dyn_batched_fn = wrapped
        return self

    def __exit__(self, *exc):
        tsweep.dyn_batched_fn = self.real


def _sweep(pkg, cfg, kind, args, **kw):
    """Run one sweep through ``pkg`` (either package's sweep module); rows as
    a flat list in the sweep's order."""
    if kind == "byz":
        return pkg.run_byzantine_sweep(cfg, f_values=args["f_values"], seeds=args["seeds"],
                                       forge=args["forge"], **kw)
    fc_cls = type(cfg.faults)
    fcs = [fc_cls(**fc) for fc in args["fcs"]]
    res = pkg.run_fault_sweep(cfg, fcs, args["seeds"], **kw)
    return [m for fc in fcs for m in res[fc]]


@pytest.fixture(scope="module")
def runs():
    """``runs(case)``: ``(jax rows, jax lane digests, port rows, port lane
    digests)`` of one sweep, computed once a process."""
    memo = {}

    def get(case):
        if case not in memo:
            base, kind, args = SWEEPS[case]
            jcfg, tcfg = _cfgs(**base)
            with _Recorded() as rec:
                trows = _sweep(tsweep, tcfg, kind, args, device="cpu")
            memo[case] = (_sweep(jsweep, jcfg, kind, args),
                          _jax_lane_digests(jcfg, kind, args), trows, rec.digests)
        return memo[case]
    return get


# what each sweep shows (JAX's rows): config 4's finality while the honest
# nodes reach the commit quorum; the heartbeat sweeps' lanes mix taken
# handoffs (a leader, blocks) and refused ones (no leader among 16 with 9
# crashed); the forged commits of the forge sweep
EXPECT = {
    "round_normal": lambda rows: (
        all(r["blocks_final_all_nodes"] > 0 and r["agreement_ok"] for r in rows)),
    "raft_hb_normal": lambda rows: (
        [r["n_leaders"] for r in rows] == [1, 1, 0, 0] and rows[0]["blocks"] > 0),
    "forge_tick": lambda rows: (
        [r["forged_commits"] >= 1 for r in rows] == [r["f"] >= 1 for r in rows]),
}


# --------------------------------------------------------------------------- #
# sweeps                                                                      #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", list(SWEEPS))
def test_sweep_equals_jax(runs, case):
    """Every metrics row and every lane's final-state fields equal JAX's,
    and the rows show what the sweep is for (``EXPECT``)."""
    jrows, jdig, trows, tdig = runs(case)
    assert trows == jrows
    assert len(tdig) == len(jdig) == len(jrows)
    for i, (want, got) in enumerate(zip(jdig, tdig)):
        assert got == want, (case, i, sorted(k for k in want if got.get(k) != want[k]))
    assert EXPECT.get(case, lambda rows: True)(jrows), jrows


def test_normal_lanes_are_not_solo_runs(runs):
    """Under ``"normal"`` a vmapped lane draws on the first lane's key: some
    lane's final state differs from its solo run (so the sweep case above
    holds the lane program to the rule, not to a loop of solo runs), while
    the first lane's is its own."""
    base, kind, args = SWEEPS["round_normal"]
    _, tdig = runs("round_normal")[2:]
    solo = []
    for f in args["f_values"]:
        for s in args["seeds"]:
            _, tcfg = _cfgs(**base, faults=dict(n_byzantine=f))
            final = trunner.final_state(tcfg, seed=s, device="cpu")
            solo.append(convert.state_digests(convert.state_to_numpy(final)))
    assert solo[0] == tdig[0]
    assert any(a != b for a, b in zip(solo, tdig))


def test_mixed_fault_sweep_takes_the_static_path():
    """The mixed sim has no dyn program: ``run_fault_sweep`` runs it on the
    static path (``run_seed_sweep``; exact draws, so its lanes run in turn),
    row for row JAX's."""
    jcfg, tcfg = _cfgs(protocol="mixed", n=12, mixed_shards=4, sim_ms=200)
    jres = jsweep.run_fault_sweep(jcfg, [jcfg.faults.__class__(n_crashed=1)], [0, 1])
    tres = tsweep.run_fault_sweep(tcfg, [tcfg.faults.__class__(n_crashed=1)], [0, 1],
                                  device="cpu")
    assert list(tres.values()) == list(jres.values())


def test_multi_seed_equals_jax():
    """``run_multi_seed`` has solo semantics (JAX's ``lax.map``): on the
    ``"normal"`` round path each row equals JAX's and the port's solo run."""
    jcfg, tcfg = _cfgs(**SWEEPS["round_normal"][0], faults=dict(n_byzantine=5))
    seeds = (0, 1, 2)
    jrows = jrunner.run_multi_seed(jcfg, seeds, record=False)
    trows = trunner.run_multi_seed(tcfg, seeds, record=False, device="cpu")
    assert trows == jrows
    assert trows == [trunner.run_simulation(tcfg, seed=s, device="cpu") for s in seeds]


def test_one_lane_batch_equals_final_state():
    """A batch of one lane is the solo run (the first-lane rule at one lane),
    on the round path's ``"normal"`` draws."""
    _, tcfg = _cfgs(**SWEEPS["round_normal"][0], faults=dict(n_byzantine=7))
    batch = tsweep.run_seed_sweep(tcfg, [3], device="cpu")
    assert batch == [trunner.run_simulation(tcfg, seed=3, device="cpu")]
    canon = tbase.canonical_fault_cfg(tcfg)
    finals = tsweep.dyn_batched_fn(canon)(tsweep._keys([3]), [0], [7], "cpu")
    solo = trunner.final_state(tcfg, seed=3, device="cpu")
    assert convert.state_digests(convert.lane_leaves(convert.state_to_numpy(finals), 0)) == \
        convert.state_digests(convert.state_to_numpy(solo))


def test_seed_sweep_equals_jax():
    """The static vmapped path (``run_seed_sweep``) on the ``"normal"`` round
    path equals JAX's."""
    jcfg, tcfg = _cfgs(**SWEEPS["round_normal"][0], faults=dict(n_crashed=4, n_byzantine=3))
    assert tsweep.run_seed_sweep(tcfg, [0, 1, 2], device="cpu") == \
        jsweep.run_seed_sweep(jcfg, [0, 1, 2])


def test_jax_finals_carry_across():
    """JAX's vmapped finals become a lane-stacked port state whose metrics
    and leaves equal JAX's, lane by lane."""
    base, _, _ = SWEEPS["round_exact"]
    jcfg, tcfg = _cfgs(**base)
    canon = jbase.canonical_fault_cfg(jcfg)
    keys = jax.vmap(jax.random.key)(jnp.asarray([4, 5], jnp.uint32))
    finals = jsweep.dyn_batched_fn(canon)(keys, jnp.asarray([0, 3], jnp.int32),
                                          jnp.asarray([2, 0], jnp.int32))
    leaves = {f.name: np.asarray(getattr(finals, f.name)) for f in dataclasses.fields(finals)}
    state = convert.lanes_from_numpy(tcfg, leaves, "cpu")
    for i in range(2):
        lane = tbase.lane_state(state, i)
        jlane = jax.tree.map(lambda x: x[i], finals)
        assert trunner.sim_metrics(tcfg, lane) == jrunner.base_model.sim_metrics(jcfg, jlane)
    back = convert.state_to_numpy(state)
    assert convert.state_digests(back) == convert.state_digests(leaves)


# --------------------------------------------------------------------------- #
# fault operands                                                              #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("nc,nb", [(0, 0), (2, 0), (0, 3), (2, 3), (8, 0)])
def test_dyn_fault_masks_match_static(nc, nb):
    """Equal counts give the static masks, and JAX's dyn masks; ``[B]``
    counts give ``[B, N]``, one lane a row."""
    jcfg, tcfg = _cfgs(protocol="pbft", n=8, sim_ms=100,
                       faults=dict(n_crashed=nc, n_byzantine=nb))
    static = tbase.fault_masks(tcfg, 8, "cpu")
    dyn = tbase.dyn_fault_masks(8, nc, nb, "cpu")
    jdyn = jbase.dyn_fault_masks(8, nc, nb)
    for s, d, j in zip(static, dyn, jdyn):
        assert torch.equal(s, d) and np.array_equal(d.numpy(), np.asarray(j))
    lanes = tbase.dyn_fault_masks(8, torch.tensor([0, nc]), torch.tensor([nb, 0]), "cpu")
    for m, row0, row1 in zip(lanes, tbase.dyn_fault_masks(8, 0, nb, "cpu"),
                             tbase.dyn_fault_masks(8, nc, 0, "cpu")):
        assert m.shape == (2, 8) and torch.equal(m[0], row0) and torch.equal(m[1], row1)


@pytest.mark.parametrize("faults", [
    dict(n_crashed=3), dict(n_byzantine=2), dict(crash_frac=0.25, n_byzantine=1),
    dict(drop_prob=0.1, n_crashed=3), dict(byz_forge=True, n_byzantine=2),
    dict(byz_forge=True), dict(byz_copies=2, n_byzantine=1)])
def test_canonical_fault_cfg_equals_jax(faults):
    """The canonical config is JAX's, field for field (as the JSON both
    packages store in a checkpoint), seed included."""
    jcfg, tcfg = _cfgs(protocol="pbft", n=16, sim_ms=100, seed=7, faults=faults)
    assert tconfig_to_json(tbase.canonical_fault_cfg(tcfg)) == \
        jconfig_to_json(jbase.canonical_fault_cfg(jcfg))


def test_canonical_fault_cfg_groups_by_structure():
    """Counts are operands, drop_prob is structure (as in JAX)."""
    _, cfg = _cfgs(protocol="pbft", n=8, sim_ms=100)
    a = tbase.canonical_fault_cfg(cfg.with_(faults=tconfig.FaultConfig(n_crashed=3)))
    b = tbase.canonical_fault_cfg(cfg.with_(faults=tconfig.FaultConfig(n_byzantine=2)))
    c = tbase.canonical_fault_cfg(cfg.with_(faults=tconfig.FaultConfig(drop_prob=0.1,
                                                                       n_crashed=3)))
    assert a == b and c != a


def test_apply_fault_masks_raft_disarms_crashed():
    """Raft's masks re-disarm the crashed nodes' election deadlines: equal to
    the static init."""
    _, tcfg = _cfgs(protocol="raft", n=12, sim_ms=100, faults=dict(n_crashed=3))
    from blockchain_simulator_tpu_torch.models import raft
    from blockchain_simulator_tpu_torch.utils import threefry

    key = threefry.key(4)
    static, _ = raft.init(tcfg, key, device="cpu")
    canon = tbase.canonical_fault_cfg(tcfg)
    dyn, _ = raft.init(canon, key, device="cpu")
    dyn = tbase.apply_fault_masks(canon, dyn, *tbase.dyn_fault_masks(12, 3, 0, "cpu"))
    assert convert.state_digests(convert.state_to_numpy(dyn)) == \
        convert.state_digests(convert.state_to_numpy(static))


# --------------------------------------------------------------------------- #
# refusals                                                                    #
# --------------------------------------------------------------------------- #


def test_make_dyn_sim_fn_refuses_mixed():
    _, tcfg = _cfgs(protocol="mixed", n=12, mixed_shards=4, sim_ms=1000)
    with pytest.raises(trunner.UnbatchableConfigError, match="mixed"):
        trunner.make_dyn_sim_fn(tcfg)
    with pytest.raises(trunner.UnbatchableConfigError):
        trunner.run_multi_seed(tcfg, (0, 1), device="cpu")
    assert issubclass(trunner.UnbatchableConfigError, NotImplementedError)


def test_normal_tick_batch_raises():
    """A vmapped batch of the PBFT tick engine on ``"normal"`` draws, once
    refused, runs its lanes side by side on the tick engine's lane axis:
    its rows and every lane's final-state fields are JAX's vmapped rows,
    and one lane runs as well."""
    jcfg, tcfg = _cfgs(protocol="pbft", n=16, sim_ms=120, delivery="stat",
                       stat_sampler="normal", schedule="tick")
    args = dict(f_values=[0, 1], seeds=(0,), forge=False)
    with _Recorded() as rec:
        trows = _sweep(tsweep, tcfg, "byz", args, device="cpu")
    assert trows == _sweep(jsweep, jcfg, "byz", args)
    assert rec.digests == _jax_lane_digests(jcfg, "byz", args)
    assert len(tsweep.run_byzantine_sweep(tcfg, f_values=[1], seeds=(0,), forge=False,
                                          device="cpu")) == 1


# journal=, supervise=, dyn_chunk_keys and probe= are ported
# (tests/test_torch_journal.py, test_torch_obsim.py), and since the sweep
# axis (tests/test_torch_mesh_sweep.py) each of them takes mesh=: over a
# mesh of one rank each is the plain path, and a seed sweep there is
# run_sharded over one rank (the shard folded into the keys, as JAX's)
def _mesh_arms(tmp_path):
    from blockchain_simulator_tpu.parallel.mesh import make_mesh as jmake_mesh
    from blockchain_simulator_tpu_torch.obsim import schema as tschema
    from blockchain_simulator_tpu_torch.parallel import journal as tjournal
    from blockchain_simulator_tpu_torch.parallel import shard as tshard
    from blockchain_simulator_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, 1, device="cpu")
    return {
        "journal": lambda jcfg, cfg: (
            list(tsweep.run_fault_sweep(cfg, [cfg.faults], [0], mesh=mesh, device="cpu",
                                        journal=tjournal.SweepJournal(str(tmp_path / "j")))
                 .values()),
            list(tsweep.run_fault_sweep(cfg, [cfg.faults], [0], device="cpu").values())),
        "supervise": lambda jcfg, cfg: (
            tsweep.run_byzantine_sweep(cfg, [0], mesh=mesh, device="cpu",
                                       supervise=tjournal.ChunkSupervisor(deadline_s=None)),
            tsweep.run_byzantine_sweep(cfg, [0], device="cpu")),
        "chunk_keys": lambda jcfg, cfg: (
            tsweep.dyn_chunk_keys(cfg, [cfg.faults], [0], mesh=mesh),
            jsweep.dyn_chunk_keys(jcfg, [jcfg.faults], [0], mesh=jmake_mesh(
                1, 1, devices=jax.devices()[:1]))),
        "mesh": lambda jcfg, cfg: (
            tsweep.run_seed_sweep(cfg, [0, 1], mesh=mesh),
            [tshard.run_sharded(cfg, mesh, seed=s) for s in (0, 1)]),
        "probe": lambda jcfg, cfg: (
            tsweep.run_dyn_points(cfg, [(cfg, 0)], probe=tschema.ProbeConfig(), mesh=mesh),
            tsweep.run_dyn_points(cfg, [(cfg, 0)], probe=tschema.ProbeConfig(),
                                  device="cpu")),
    }


REFUSED = ["journal", "supervise", "chunk_keys", "mesh", "probe"]


@pytest.mark.parametrize("arm", REFUSED)
def test_sweep_arms_refused(arm, tmp_path):
    """The arms once refused over a mesh run over one now (the sweep axis):
    over a mesh of one rank each answers as its plain call does (the chunk
    keys as JAX's over a 1-device mesh), never silently dropping the
    mesh's meaning."""
    jcfg, tcfg = _cfgs(protocol="pbft", n=8, sim_ms=100)
    got, want = _mesh_arms(tmp_path)[arm](jcfg, tcfg)
    assert obs.canonical_json(got) == obs.canonical_json(want)


@pytest.mark.parametrize("var", ["BLOCKSIM_RUNS_JSONL", "BLOCKSIM_HEALTH_JSONL"])
def test_sweep_env_arms_refused(monkeypatch, tmp_path, var):
    """The health gate is ported (utils/health.py): with its variable naming
    a log whose latest verdict is a fresh ``wedged`` a sweep fails fast with
    ``BackendWedgedError``, as JAX's does, and a later ``healthy`` verdict
    lets it run.  The run log is ported (utils/obs.py): with its variable set
    a sweep appends one row a point, the point's seed and metrics under its
    config's hash."""
    path = tmp_path / "log.jsonl"
    monkeypatch.setenv(var, str(path))
    _, tcfg = _cfgs(protocol="pbft", n=8, sim_ms=60)
    if var == "BLOCKSIM_RUNS_JSONL":
        (row,) = tsweep.run_fault_sweep(tcfg, [tcfg.faults], [0], device="cpu")[tcfg.faults]
        (rec,) = obs.read_jsonl(str(path))
        assert rec["seed"] == 0 and {k: rec[k] for k in row} == row
        assert rec["manifest"]["config_hash"] == obs.config_hash(tcfg)
        return
    from blockchain_simulator_tpu_torch.utils import health as thealth

    path.write_text(json.dumps({"verdict": "wedged", "ts": time.time()}) + "\n")
    with pytest.raises(thealth.BackendWedgedError):
        tsweep.run_fault_sweep(tcfg, [tcfg.faults], [0], device="cpu")
    with path.open("a") as f:
        f.write(json.dumps({"verdict": "healthy", "ts": time.time()}) + "\n")
    assert len(tsweep.run_fault_sweep(tcfg, [tcfg.faults], [0], device="cpu")[tcfg.faults]) == 1


def test_sweep_entry_points_default_to_the_card(monkeypatch):
    """Without ``device`` the entry points run on the card, and without one
    they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs(protocol="pbft", n=8, sim_ms=60)
    for fn in (lambda: tsweep.run_seed_sweep(tcfg, [0]),
               lambda: tsweep.run_fault_sweep(tcfg, [tcfg.faults], [0]),
               lambda: tsweep.run_byzantine_sweep(tcfg, [0], forge=False),
               lambda: trunner.run_multi_seed(tcfg, [0])):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()


def test_goldens_hold_the_reference_outcomes():
    """The card's goldens hold the artifacts' outcomes: config 4 keeps all
    200 blocks up to f = n/3 and none past N/2 (ARTIFACT_config4.json at
    10,000 nodes), the drop sweep survives to p = 0.2 and starves from 0.3
    (ARTIFACT_drop_sweep.json); and they are the configs named here."""
    c4 = json.loads(CONFIG4_GOLDEN.read_text())["entries"]["config4"]
    assert c4["config"] == CONFIG4 and c4["args"]["f_values"] == CONFIG4_F
    assert c4["stat_sampler"] == "normal" and len(c4["lane_sha256"]) == 12
    assert [(r["f"], r["seed"]) for r in c4["rows"]] == \
        [(f, s) for f in CONFIG4_F for s in CONFIG4_SEEDS]
    assert [r["blocks_final_all_nodes"] for r in c4["rows"]] == [200] * 10 + [0] * 2
    drop = json.loads(DROP_GOLDEN.read_text())["entries"]["drop"]
    assert drop["config"] == DROP and [fc["drop_prob"] for fc in drop["args"]["fcs"]] == DROP_PS
    assert [r["blocks_final_all_nodes"] for r in drop["rows"]] == [40] * 5 + [0] * 3


# --------------------------------------------------------------------------- #
# golden files for the card                                                   #
# --------------------------------------------------------------------------- #


def _golden_sweep(config: dict, kind: str, args: dict) -> dict:
    """A golden entry: JAX's own sweep rows and every lane's digests."""
    jcfg, _ = _cfgs(**config)
    rows = _sweep(jsweep, jcfg, kind, args)
    return {"config": config, "kind": kind,
            "args": {k: list(v) if isinstance(v, tuple) else v for k, v in args.items()},
            "jax_version": jax.__version__, "stat_sampler": jcfg.eff_stat_sampler,
            "rows": rows, "lane_sha256": _jax_lane_digests(jcfg, kind, args)}


def write_golden():
    about = ("JAX package (blockchain_simulator_tpu) results that the PyTorch port "
             "must reproduce bit for bit: the sweep's metrics rows and a sha256 of "
             "every final-state field of every lane (blockchain_simulator_tpu_torch/"
             "convert.state_digests), lanes in row order. ")
    config4 = _golden_sweep(CONFIG4, "byz", dict(f_values=CONFIG4_F, seeds=CONFIG4_SEEDS,
                                                  forge=False))
    CONFIG4_GOLDEN.write_text(json.dumps({
        "about": about + "BASELINE config 4 as tools/run_config4.py builds it, one "
                 "12-lane run_byzantine_sweep batch. Written by: " + WRITTEN_BY,
        "entries": {"config4": config4}}, indent=1, sort_keys=True) + "\n")
    print(f"wrote {CONFIG4_GOLDEN}", flush=True)
    drop = _golden_sweep(DROP, "faults", dict(fcs=[dict(drop_prob=p) for p in DROP_PS],
                                              seeds=(0,)))
    DROP_GOLDEN.write_text(json.dumps({
        "about": about + "The drop sweep as tools/run_drop_sweep.py builds it, one "
                 "run_fault_sweep of eight drop structures. Written by: " + WRITTEN_BY,
        "entries": {"drop": drop}}, indent=1, sort_keys=True) + "\n")
    print(f"wrote {DROP_GOLDEN}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: python tests/test_torch_sweep.py --write-golden")
    jax.config.update("jax_platforms", "cpu")
    write_golden()
