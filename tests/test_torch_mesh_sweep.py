"""The sweep axis of the PyTorch port (parallel/sweep.py ``mesh=`` over a
``(n_sweep, n_nodes)`` grid of gloo ranks) against the JAX package's mesh
sweeps (``tests/test_zzpartition.py``).

The JAX package gives its mesh paths three contracts, and each is held bit
for bit here:

- a **sweep-only mesh** (``(2, 1)``, ``(4, 1)``): a lane is the solo run of
  its point, so under the exact sampler the rows equal JAX's single-device
  rows, and under ``"normal"`` JAX's mesh rows of the same shape;
- a **nodes axis > 1** (``(2, 2)``): a lane is JAX's single-device batched
  row (the tick engine, the round path, the heartbeat path, and a probed
  lane);
- a **seed sweep** over a nodes mesh (``(1, 2)``, and the command line's
  ``--shards 2 --seeds 0 1``): a lane is JAX's ``run_sharded`` at its seed.

Around them: the journal's mesh keys equal JAX's, and a mesh journal of
either package resumes in the other with 0 dispatches; probed lanes and a
max-f query over a mesh equal JAX's; a supervised mesh dispatch whose chaos
point fails degrades to the single-device rows, and a fault on one rank
only (raises, a missed deadline) moves every rank to the same transition;
equal meshes count their collectives on the mesh in use; a mesh of one
rank is the plain registry entry; the serving surfaces still refuse,
naming A7b.

Each grid is one group of rank processes (parallel/multihost.launch, one
torch thread a rank) that runs all of its cases, and the groups start
together in the module fixture while JAX computes its side, holding their
slots of :func:`test_torch_multihost.rank_slots`.  JAX's mesh-side rows
(compiling a mesh program costs it several seconds a case) are read from
``blockchain_simulator_tpu_torch/golden/mesh_sweep_s0.json``; one entry is
recomputed live.  The golden also holds ``chip_smoke.py``'s mesh-sweep
entry (config 2 over a ``(2, 1)`` mesh).  Regenerate: ``PYTHONPATH=.:tests
JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8
python tests/test_torch_mesh_sweep.py --write-golden`` (~5 min).

The rank jobs live in this file, which imports JAX only inside functions.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import sys
import threading

import pytest

from blockchain_simulator_tpu_torch.parallel import multihost

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "blockchain_simulator_tpu_torch" / "golden" / "mesh_sweep_s0.json"
WRITTEN_BY = ("PYTHONPATH=.:tests JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_"
              "device_count=8 python tests/test_torch_mesh_sweep.py --write-golden")

# tests/test_zzpartition.py's CFG and PTS6: 6 points pad to 8 lanes at 4 rows
CFG = dict(protocol="pbft", n=8, sim_ms=200, stat_sampler="exact")
PTS6 = [(f, s) for f in (0, 1, 2) for s in (0, 1)]
# a "normal" structure on the tick engine: JAX's mesh lanes are solo runs
NORMAL = dict(protocol="pbft", n=8, sim_ms=200, delivery="stat", stat_sampler="normal")
# test_zzpartition.py::test_node_axis_sharding_pjit_arm's config and points
PJIT = dict(protocol="pbft", n=16, sim_ms=200, stat_sampler="exact")
PJIT_PTS = [(i % 3, i) for i in range(4)]
# the round path and the heartbeat path over a (2, 2) grid
ROUND = dict(protocol="pbft", n=16, sim_ms=400, stat_sampler="exact", delivery="stat",
             schedule="round", model_serialization=False)
ROUND_PTS = [(f, s) for f in (0, 2, 5) for s in (0, 1)]
HB = dict(protocol="raft", n=16, sim_ms=1200, stat_sampler="exact", delivery="stat",
          schedule="round")
HB_PTS = [(f, s) for f in (0, 3) for s in (0, 1)]
# the seed sweep over a nodes mesh: tests/test_torch_multihost.py's CLI case
SEED = dict(protocol="pbft", n=16, sim_ms=200, delivery="stat")
SEEDS = [0, 1]
SEED_ARGV = ["--protocol", "pbft", "--n", "16", "--sim-ms", "200", "--delivery", "stat",
             "--shards", "2", "--seeds", "0", "1"]
# the max-f query of tests/test_torch_query.py (f_max 5)
QTPL = {"protocol": "pbft", "n": 16, "sim_ms": 400, "stat_sampler": "exact",
        "delivery": "stat", "schedule": "round", "model_serialization": False}
Q_MAXF = {"kind": "max_f_surviving", "seeds": [0, 1]}
PROBE = {"windows": 4, "monitors": True}
# chip_smoke.py's mesh-sweep: config 2 at golden/pbft_edge_s0.json's window
CARD = dict(protocol="pbft", n=1000, sim_ms=2500)
CARD_F, CARD_SEEDS = (0, 333), (0, 1)


@pytest.fixture(autouse=True)
def release_jax_executables():
    """Free JAX's compiled programs once the process nears its mapping
    limit (tests/jax_mappings.py)."""
    yield
    import jax_mappings

    jax_mappings.release_if_high()


# ------------------------------------------------------------- both sides --

def _points(mod, kw: dict, pts, kind: str = "n_byzantine"):
    """``[(cfg, seed)]`` of a package (``mod`` its utils.config) at the
    given fault counts."""
    cfg = mod.SimConfig(**kw)
    return [(cfg.with_(faults=dataclasses.replace(cfg.faults, **{kind: f})), s)
            for f, s in pts]


def _canon(mod_base, points):
    return mod_base.canonical_fault_cfg(points[0][0])


def _fcs(mod, fs):
    return [mod.FaultConfig(n_crashed=f) for f in fs]


# ------------------------------------------------------------- rank jobs --

def grid_job(n_sweep: int, cases: list, workdir: str) -> dict:
    """One rank of a grid: make the ``(n_sweep, ranks / n_sweep)`` mesh and
    run every case of ``cases`` on it; every rank returns every result."""
    from blockchain_simulator_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_sweep=n_sweep)
    return {name: RANK_CASES[name](mesh, workdir) for name in cases}


def _rows(kw, pts, mesh, **kw_run):
    from blockchain_simulator_tpu_torch.models import base
    from blockchain_simulator_tpu_torch.parallel import sweep
    from blockchain_simulator_tpu_torch.utils import config

    points = _points(config, kw, pts)
    return sweep.run_dyn_points(_canon(base, points), points, record=False, mesh=mesh,
                                with_index=True, **kw_run)


def _byz(mesh, workdir):
    from blockchain_simulator_tpu_torch.parallel import sweep
    from blockchain_simulator_tpu_torch.utils import config

    return sweep.run_byzantine_sweep(config.SimConfig(**CFG), f_values=(0, 1, 2),
                                     seeds=(0, 1), forge=False, mesh=mesh)


def _journal(mesh, workdir):
    """The port writes a mesh journal (a crash-count grid, one chunk a
    level), then replays it; and it resumes JAX's mesh journal."""
    from blockchain_simulator_tpu_torch.models import base
    from blockchain_simulator_tpu_torch.parallel import journal, sweep
    from blockchain_simulator_tpu_torch.utils import config

    points = _points(config, CFG, PTS6, "n_crashed")
    canon = _canon(base, points)

    def run(path):
        return sweep.run_dyn_points(canon, points, record=False, mesh=mesh,
                                    journal=journal.SweepJournal(path), chunk_size=2,
                                    with_index=True)

    port = os.path.join(workdir, "port.journal")
    first, replay = run(port), run(port)
    return {"first": first, "replay": replay,
            "from_jax": run(os.path.join(workdir, "jax.journal"))}


def _probe(mesh, workdir, kw=CFG, pts=PTS6):
    from blockchain_simulator_tpu_torch.obsim import schema

    return _rows(kw, pts, mesh, probe=schema.ProbeConfig(**PROBE))


def _query(mesh, workdir):
    from blockchain_simulator_tpu_torch.query import parse_query, run_query
    from blockchain_simulator_tpu_torch.utils import config

    res = run_query(config.SimConfig(**QTPL), parse_query(Q_MAXF), mesh=mesh)
    return {k: res[k] for k in ("query", "answer", "trail", "points", "run")}


def _degrade(mesh, workdir):
    """A supervised mesh sweep whose batched dispatch fails on every
    primary attempt: the degrade arm answers on the single-device path."""
    from blockchain_simulator_tpu_torch.chaos import inject
    from blockchain_simulator_tpu_torch.parallel import journal

    sup = journal.ChunkSupervisor(deadline_s=None, retries=1, backoff_s=0.0)
    ctl = inject.ChaosController()
    ctl.fail_next("sweep.dyn_dispatch", n=2)  # the primary arm's two attempts
    with ctl:
        rows, meta = _rows(CFG, PTS6, mesh, supervise=sup)
    return {"rows": rows, "meta": meta, "schedule": ctl.schedule()}


def _one_rank(mesh, workdir, name, arm):
    """A supervised mesh sweep (journaled) whose chaos point fires on the
    grid's last rank only (``arm`` names the fault).  Every rank must take
    the same transitions; each returns its supervisor's trail (its flight
    recorder's ``sweep.*`` events), and rank 0 also journals it."""
    from blockchain_simulator_tpu_torch.chaos import inject
    from blockchain_simulator_tpu_torch.parallel import journal
    from blockchain_simulator_tpu_torch.utils import telemetry

    sup, site = {
        "degrade": (journal.ChunkSupervisor(deadline_s=None, retries=1, backoff_s=0.0),
                    lambda ctl: ctl.fail_next("sweep.dyn_dispatch", n=2)),
        # the slow rank misses its deadline; its abandoned attempt computes
        # on alone while the grid retries, and the retry succeeds
        "deadline": (journal.ChunkSupervisor(deadline_s=2.0, retries=1, backoff_s=0.0),
                     lambda ctl: ctl.slow_next("sweep.chunk", 6.0, n=1)),
    }[arm]
    ctl = inject.ChaosController()
    if mesh.world_rank == mesh.n_sweep * mesh.size - 1:
        site(ctl)
    path = os.path.join(workdir, f"{name}.journal")
    telemetry.flight.reset()
    with ctl:
        rows, meta = _rows(CFG, PTS6, mesh, supervise=sup,
                           journal=journal.SweepJournal(path), chunk_size=len(PTS6))
    trail = [r["event"][len("sweep."):] for r in telemetry.flight.snapshot()
             if r.get("kind") == "event" and r["event"].startswith("sweep.")]
    events = None
    if mesh.world_rank == 0:
        with open(path) as f:
            events = [r["event"] for r in map(json.loads, f) if r.get("op") == "event"]
    return {"rows": rows, "meta": meta, "schedule": ctl.schedule(), "trail": trail,
            "events": events}


def _counts(mesh, workdir):
    """A second make_mesh of the grid's shape gets the nodes-arm program
    the "pjit" case built over the first, and its collectives count on it."""
    from blockchain_simulator_tpu_torch.models import base
    from blockchain_simulator_tpu_torch.parallel import sweep
    from blockchain_simulator_tpu_torch.parallel.mesh import make_mesh
    from blockchain_simulator_tpu_torch.utils import config

    again = make_mesh(n_sweep=mesh.n_sweep)
    again.reset_counts()
    rows, _ = _rows(PJIT, PJIT_PTS[:2], again)
    canon = _canon(base, _points(config, PJIT, PJIT_PTS))
    return {"shared": sweep.mesh_dyn_batched_fn(canon, again)
            is sweep.mesh_dyn_batched_fn(canon, mesh),
            "counts": dict(again.counts), "rows": rows}


def _seed(mesh, workdir):
    from blockchain_simulator_tpu_torch.parallel import sweep
    from blockchain_simulator_tpu_torch.utils import config

    return sweep.run_seed_sweep(config.SimConfig(**SEED), SEEDS, mesh=mesh)


RANK_CASES = {
    "pts6": lambda mesh, d: _rows(CFG, PTS6, mesh),
    "pts5": lambda mesh, d: _rows(CFG, PTS6[:5], mesh),
    "byz": _byz,
    "one_point": lambda mesh, d: _rows(CFG, PTS6[:1], mesh),
    "normal": lambda mesh, d: _rows(NORMAL, PTS6, mesh),
    "journal": _journal,
    "probe": _probe,
    "query": _query,
    "degrade": _degrade,
    "degrade_one": lambda mesh, d: _one_rank(mesh, d, "degrade_one", "degrade"),
    "deadline_one": lambda mesh, d: _one_rank(mesh, d, "deadline_one", "deadline"),
    "counts": _counts,
    "pjit": lambda mesh, d: _rows(PJIT, PJIT_PTS, mesh),
    "round": lambda mesh, d: _rows(ROUND, ROUND_PTS, mesh),
    "hb": lambda mesh, d: _rows(HB, HB_PTS, mesh),
    "probe_nodes": lambda mesh, d: _probe(mesh, d, PJIT, PJIT_PTS),
    "probe_round": lambda mesh, d: _probe(mesh, d, ROUND, ROUND_PTS),
    "probe_hb": lambda mesh, d: _probe(mesh, d, HB, HB_PTS),
    "seed": _seed,
}

# the grids, their cases, and the groups' order of start (costliest first)
GRIDS = {
    (2, 2): ["pjit", "round", "hb", "probe_nodes", "probe_round", "probe_hb", "counts"],
    (2, 1): ["pts6", "pts5", "byz", "one_point", "normal", "journal", "probe", "query",
             "degrade", "degrade_one", "deadline_one"],
    (4, 1): ["pts6", "pts5", "byz"],
    (1, 2): ["seed"],
}


# ------------------------------------------------------------- fixtures ---

def _golden() -> dict:
    return json.loads(GOLDEN.read_text())["entries"]


def _run_grids(workdir: str) -> dict:
    """Every grid's group, started together (each holding its rank slots):
    ``{(n_sweep, n_nodes): [rank results]}``."""
    from concurrent.futures import ThreadPoolExecutor

    from test_torch_multihost import rank_slots

    def group(shape):
        n = shape[0] * shape[1]
        with rank_slots(n):
            return multihost.launch(grid_job, n, args=(shape[0], GRIDS[shape], workdir),
                                    device="cpu", timeout_s=600, mesh_shape=shape)

    with ThreadPoolExecutor(len(GRIDS)) as pool:
        futs = {shape: pool.submit(group, shape) for shape in GRIDS}
        return {shape: f.result() for shape, f in futs.items()}


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """The port's grids, run in a thread while the JAX side computes:
    ``grids()`` waits for them."""
    workdir = tmp_path_factory.mktemp("mesh_sweep")
    (workdir / "jax.journal").write_text("".join(_golden()["journal@2"]["journal"]))
    box = {}

    def run():
        try:
            box["out"] = _run_grids(str(workdir))
        except BaseException as e:  # re-raised in the test that reads it
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def get():
        t.join()
        if "err" in box:
            raise box["err"]
        return box["out"]

    get.workdir = workdir
    return get


# the (2, 2) cases whose JAX rows the golden holds (compiling the heartbeat
# path's batched program costs JAX ~20 s; the others ~4 s each); "pjit"
# runs live here, its entry is for tests/test_torch_card_mesh_sweep.py
NODES_GOLDEN = {"round": (ROUND, ROUND_PTS, False), "hb": (HB, HB_PTS, False),
                "probe_nodes": (PJIT, PJIT_PTS, True), "probe_round": (ROUND, ROUND_PTS, True),
                "probe_hb": (HB, HB_PTS, True), "pjit": (PJIT, PJIT_PTS, False)}


def jax_single_rows(kw, pts, probe: bool = False):
    """JAX's single-device rows (``run_dyn_points`` without a mesh)."""
    from blockchain_simulator_tpu.models import base as jbase
    from blockchain_simulator_tpu.obsim import schema as jschema
    from blockchain_simulator_tpu.parallel import sweep as jsweep
    from blockchain_simulator_tpu.utils import config as jconfig

    points = _points(jconfig, kw, pts)
    extra = {"probe": jschema.ProbeConfig(**PROBE)} if probe else {}
    return jsweep.run_dyn_points(_canon(jbase, points), points, record=False, **extra)


@pytest.fixture(scope="module")
def jax_rows():
    """``jax_rows(name)``: JAX's single-device rows of a case (live for the
    tick-engine cases, the golden's for the costlier (2, 2) cases), once a
    process."""
    memo = {}
    live = {"pts6": (CFG, PTS6), "pjit": (PJIT, PJIT_PTS)}

    def get(name):
        if name not in memo:
            memo[name] = (jax_single_rows(*live[name]) if name in live
                          else _golden()[f"{name}@2x2"]["rows"])
        return memo[name]

    return get


def _json(x) -> str:
    from blockchain_simulator_tpu_torch.utils import obs

    return obs.canonical_json(json.loads(json.dumps(x)))


def _every_rank(results: list, name: str):
    """The case's result, the same on every rank of the grid."""
    first = _json(results[0][name])
    assert all(_json(r[name]) == first for r in results[1:]), name
    return results[0][name]


# ------------------------------------------------------- sweep-only arm ---

@pytest.mark.parametrize("shape", [(2, 1), (4, 1)])
@pytest.mark.parametrize("name", ["pts6", "pts5", "byz"])
def test_sweep_only_rows_equal_jax_single_device(shape, name, grids, jax_rows):
    """A sweep-only lane is the solo run of its point: under the exact
    sampler the rows equal JAX's single-device rows (6 points pad to 8
    lanes at 4 rows, 5 to 6 and 8), with JAX's lane accounting."""
    got = _every_rank(grids()[shape], name)
    want = jax_rows("pts6")
    if name == "byz":
        assert [(r["f"], r["seed"]) for r in got] == [(f, s) for f, s in PTS6]
        got = [{k: v for k, v in r.items() if k not in ("f", "seed")} for r in got]
        assert _json(got) == _json(want)
        return
    rows, meta = got
    n = len(PTS6) if name == "pts6" else 5
    assert _json(rows) == _json(want[:n])
    lanes = -(-n // shape[0]) * shape[0]
    assert (meta["dispatches"], meta["lanes"], meta["pad"]) == (1, lanes, lanes - n)


def test_sweep_only_normal_equals_jax_mesh_rows(grids):
    """Under ``"normal"`` a sweep-only lane equals JAX's mesh rows of the
    same shape (JAX's vmapped rows follow the first lane's key instead)."""
    rows, _ = _every_rank(grids()[(2, 1)], "normal")
    assert _json(rows) == _json(_golden()["normal@2"]["rows"])


def test_one_point_drops_the_mesh(grids, jax_rows):
    """A 1-point dispatch over a mesh of more than one rank takes the
    single-device path: no padded lanes."""
    rows, meta = _every_rank(grids()[(2, 1)], "one_point")
    assert _json(rows) == _json(jax_rows("pts6")[:1])
    assert (meta["lanes"], meta["pad"]) == (1, 0)


# ----------------------------------------------------------- nodes arm ---

@pytest.mark.parametrize("name", ["pjit", "round", "hb"])
def test_nodes_arm_equals_jax_single_device_rows(name, grids, jax_rows):
    """Nodes axis > 1 at ``(2, 2)``: each lane runs in global view over its
    row's nodes group and equals JAX's single-device batched row (the tick
    engine, the round path with its global-view draws, the heartbeat
    path)."""
    rows, meta = _every_rank(grids()[(2, 2)], name)
    assert _json(rows) == _json(jax_rows(name))
    assert meta["lanes"] == len(rows) + meta["pad"]


@pytest.mark.parametrize("what", ["nodes_batch", "seed_sweep"])
def test_philox_batches_over_a_mesh_raise(what):
    """A batch whose JAX rows follow the first lane's key (Philox draws) on
    an arm whose lanes run alone raises before any collective: the nodes
    arm's batches and a mesh seed sweep (a grid cell without groups)."""
    from blockchain_simulator_tpu_torch.models import base
    from blockchain_simulator_tpu_torch.parallel import sweep
    from blockchain_simulator_tpu_torch.parallel.mesh import NodeMesh
    from blockchain_simulator_tpu_torch.utils import config

    with pytest.raises(NotImplementedError, match="first lane"):
        if what == "nodes_batch":
            points = _points(config, NORMAL, PTS6)
            sweep.run_dyn_points(_canon(base, points), points, record=False,
                                 mesh=NodeMesh(2, 0, None, "cpu", n_sweep=2))
        else:
            sweep.run_seed_sweep(config.SimConfig(**NORMAL), SEEDS,
                                 mesh=NodeMesh(2, 0, None, "cpu"))


# ---------------------------------------------------------- seed sweeps ---

def test_seed_sweep_equals_jax_run_sharded(grids):
    """``run_seed_sweep(mesh=)`` over a ``(1, 2)`` grid: each seed's row is
    JAX's ``run_sharded`` over 2 devices at that seed."""
    got = _every_rank(grids()[(1, 2)], "seed")
    assert _json(got) == _json(_golden()["seed@2"]["run_sharded"])


def test_cli_shards_with_seeds_prints_the_jax_lines(capsys):
    """``--shards 2 --seeds 0 1`` runs the seed sweep over two gloo ranks
    and prints JAX's command line's lines."""
    from blockchain_simulator_tpu_torch import cli as tcli
    from test_torch_cli import _comparable
    from test_torch_multihost import rank_slots

    with rank_slots(2):
        assert tcli.main(SEED_ARGV + ["--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    want = _golden()["seed@2"]
    assert [_comparable(m) for m in lines] == want["cli_lines"]
    assert [{k: m[k] for k in r} for m, r in zip(lines, want["run_sharded"])] == \
        want["run_sharded"]


def test_seed_divisibility_error_matches_jax():
    import jax

    from blockchain_simulator_tpu.parallel.mesh import make_mesh as jmake_mesh
    from blockchain_simulator_tpu.parallel import sweep as jsweep
    from blockchain_simulator_tpu.utils import config as jconfig
    from blockchain_simulator_tpu_torch.parallel import sweep as tsweep
    from blockchain_simulator_tpu_torch.parallel.mesh import NodeMesh
    from blockchain_simulator_tpu_torch.utils import config as tconfig

    with pytest.raises(ValueError) as jerr:
        jsweep.run_seed_sweep(jconfig.SimConfig(**SEED), [0, 1, 2],
                              mesh=jmake_mesh(1, 2, devices=jax.devices()[:2]))
    # the refusal comes before any collective: a grid cell without groups
    mesh = NodeMesh(1, 0, None, "cpu", n_sweep=2)
    with pytest.raises(ValueError) as terr:
        tsweep.run_seed_sweep(tconfig.SimConfig(**SEED), [0, 1, 2], mesh=mesh)
    assert str(terr.value) == str(jerr.value)


# -------------------------------------------------------------- journal ---

@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2), (1, 2)])
def test_mesh_chunk_keys_equal_jax(shape):
    """``dyn_chunk_keys(mesh=)`` and the journal's mesh descriptor equal
    JAX's for a mesh of the same shape, byte for byte (no compile)."""
    import jax

    from blockchain_simulator_tpu.parallel import journal as jjournal
    from blockchain_simulator_tpu.parallel import sweep as jsweep
    from blockchain_simulator_tpu.parallel.mesh import make_mesh as jmake_mesh
    from blockchain_simulator_tpu.models import base as jbase
    from blockchain_simulator_tpu.utils import config as jconfig
    from blockchain_simulator_tpu_torch.models import base as tbase
    from blockchain_simulator_tpu_torch.parallel import journal as tjournal
    from blockchain_simulator_tpu_torch.parallel import partition
    from blockchain_simulator_tpu_torch.parallel import sweep as tsweep
    from blockchain_simulator_tpu_torch.parallel.mesh import NodeMesh
    from blockchain_simulator_tpu_torch.utils import config as tconfig

    s, j = shape
    jmesh = jmake_mesh(j, s, devices=jax.devices()[:s * j])
    tmesh = NodeMesh(j, 0, None, "cpu", n_sweep=s)
    assert partition.mesh_shape_dict(tmesh) == {"sweep": s, "nodes": j}
    assert partition.mesh_tag(tmesh) == \
        __import__("blockchain_simulator_tpu.parallel.partition",
                   fromlist=["mesh_tag"]).mesh_tag(jmesh)
    jcfg, tcfg = jconfig.SimConfig(**CFG), tconfig.SimConfig(**CFG)
    assert tsweep.dyn_chunk_keys(tcfg, _fcs(tconfig, (0, 1, 2)), [0, 1, 2], mesh=tmesh) == \
        jsweep.dyn_chunk_keys(jcfg, _fcs(jconfig, (0, 1, 2)), [0, 1, 2], mesh=jmesh)
    tpts, jpts = _points(tconfig, CFG, PTS6), _points(jconfig, CFG, PTS6)
    assert tjournal.chunk_key(_canon(tbase, tpts), 1, tpts, tmesh, n_out=3) == \
        jjournal.chunk_key(_canon(jbase, jpts), 1, jpts, jmesh, n_out=3)


def test_jax_mesh_journal_resumes_in_the_port(grids):
    """JAX's mesh journal (golden) answers the port's identical mesh sweep
    with 0 dispatches and JAX's rows."""
    res = _every_rank(grids()[(2, 1)], "journal")
    rows, meta = res["from_jax"]
    assert meta["dispatches"] == 0 and all(c["cached"] for c in meta["chunks"])
    assert _json(rows) == _json(_golden()["journal@2"]["rows"])


def test_port_mesh_journal_resumes_in_jax(grids):
    """The port's mesh journal replays in the port and in JAX's identical
    mesh sweep with 0 dispatches; its keys and rows are JAX's."""
    import jax

    from blockchain_simulator_tpu.models import base as jbase
    from blockchain_simulator_tpu.parallel import journal as jjournal
    from blockchain_simulator_tpu.parallel import sweep as jsweep
    from blockchain_simulator_tpu.parallel.mesh import make_mesh as jmake_mesh
    from blockchain_simulator_tpu.utils import config as jconfig

    res = _every_rank(grids()[(2, 1)], "journal")
    (first, fmeta), (replay, rmeta) = res["first"], res["replay"]
    want = _golden()["journal@2"]
    assert _json(first) == _json(want["rows"]) and _json(replay) == _json(want["rows"])
    assert fmeta["dispatches"] == 3 and rmeta["dispatches"] == 0
    assert [c["key"] for c in fmeta["chunks"]] == want["keys"]
    points = _points(jconfig, CFG, PTS6, "n_crashed")
    path = str(grids.workdir / "port.journal")
    rows, meta = jsweep.run_dyn_points(_canon(jbase, points), points, record=False,
                                       mesh=jmake_mesh(1, 2, devices=jax.devices()[:2]),
                                       journal=jjournal.SweepJournal(path), chunk_size=2,
                                       with_index=True)
    assert meta["dispatches"] == 0
    assert _json(rows) == _json(want["rows"])


# ------------------------------------------------------ probes, queries ---

@pytest.mark.parametrize("shape, name", [((2, 1), "probe"), ((2, 2), "probe_nodes"),
                                         ((2, 2), "probe_round"), ((2, 2), "probe_hb")])
def test_probed_mesh_lanes_equal_jax(shape, name, grids, jax_rows):
    """Probed lanes over a mesh equal JAX's probe summaries over a mesh of
    the same shape (golden; JAX's equal its single-device rows there): the
    sweep-only arm, and the nodes arm on the tick engine, the round path
    and the heartbeat path (taps read the state gathered over the row)."""
    rows, _ = _every_rank(grids()[shape], name)
    want = _golden()["probe@2"]["rows"] if name == "probe" else jax_rows(name)
    assert _json(rows) == _json(want)
    assert all(r["probe"]["windows"] == PROBE["windows"] for r in rows)


def test_mesh_query_equals_jax(grids):
    """A max-f query with ``mesh=`` gives JAX's answer, trail and points,
    with JAX's lane accounting."""
    res = _every_rank(grids()[(2, 1)], "query")
    want = _golden()["query@2"]
    assert _json({k: res[k] for k in ("query", "answer", "trail", "points")}) == \
        _json(want["result"])
    assert res["answer"]["f_max"] == 5
    assert {k: res["run"][k] for k in ("lanes", "pad", "dispatches")} == want["run"]


def test_supervised_mesh_dispatch_degrades_to_single_device_rows(grids, jax_rows):
    """With the ``sweep.dyn_dispatch`` chaos point failing the primary
    arm's attempts, a supervised mesh sweep answers from its degrade arm
    (the single-device program on every rank): JAX's single-device rows."""
    res = _every_rank(grids()[(2, 1)], "degrade")
    assert _json(res["rows"]) == _json(jax_rows("pts6"))
    assert res["schedule"] == ["sweep.dyn_dispatch:fail"] * 2


TRANSITIONS = ("retry", "degrade", "failed")


@pytest.mark.parametrize("case", ["degrade_one", "deadline_one"])
def test_one_failing_rank_moves_the_whole_grid(case, grids, jax_rows):
    """The chaos point fires on one rank of the grid only (two raises, a
    deadline missed): every rank takes the same transitions (a rank whose
    own attempt succeeded records the peer's failure as its ``error``), and
    the rows still equal JAX's single-device rows."""
    results = grids()[(2, 1)]
    got = _every_rank([{case: (r[case]["rows"], r[case]["meta"])} for r in results], case)
    assert _json(got[0]) == _json(jax_rows("pts6"))
    assert got[1]["dispatches"] == 1
    trails = [r[case]["trail"] for r in results]
    moves = [[e for e in t if e in TRANSITIONS] for t in trails]
    assert all(m == moves[0] for m in moves), trails
    assert results[0][case]["events"] == trails[0]  # rank 0 journals its trail
    assert results[0][case]["schedule"] == []
    if case == "degrade_one":
        # no deadline: the trail is exact
        assert trails[0] == ["error", "retry", "error", "degrade"]
        assert trails[-1] == trails[0]
        assert results[-1][case]["schedule"] == ["sweep.dyn_dispatch:fail"] * 2
    else:
        # the slow rank missed its deadline, so every rank retried (a rank
        # slowed by the host may miss its own deadlines too: the grid then
        # degrades as one)
        assert moves[0][0] == "retry" and trails[-1][0] == "deadline"
        assert results[-1][case]["schedule"] == ["sweep.chunk:slow"]


def test_nodes_axis_sweep_refuses_a_deadline():
    """A supervised sweep over a nodes axis > 1 takes no deadline (an
    abandoned attempt would go on issuing its row's collectives), refused
    before any collective."""
    from blockchain_simulator_tpu_torch.models import base
    from blockchain_simulator_tpu_torch.parallel import journal, sweep
    from blockchain_simulator_tpu_torch.parallel.mesh import NodeMesh
    from blockchain_simulator_tpu_torch.utils import config

    points = _points(config, PJIT, PJIT_PTS)
    with pytest.raises(ValueError, match="takes no deadline"):
        sweep.run_dyn_points(_canon(base, points), points, record=False,
                             mesh=NodeMesh(2, 0, None, "cpu", n_sweep=2),
                             supervise=journal.ChunkSupervisor())


def test_equal_meshes_count_on_the_mesh_in_use(grids, jax_rows):
    """Two make_mesh calls of one shape are one registry key, and the
    collectives of the cached program count on the mesh in use."""
    for r in grids()[(2, 2)]:
        got = r["counts"]
        assert got["shared"]
        assert got["counts"]["all_reduce"] > 0 and got["counts"]["all_gather"] > 0
        assert _json(got["rows"]) == _json(jax_rows("pjit")[:2])


# ------------------------------------------------ size 1, registry, refusals

def test_mesh_of_one_rank_is_the_plain_entry():
    """A mesh of one rank is the plain path: the mesh program IS the
    ``sweep-batched-dynf`` entry (JAX's test_mesh_size_one_degenerates...),
    and a sweep over it equals the plain sweep."""
    from blockchain_simulator_tpu_torch.models import base
    from blockchain_simulator_tpu_torch.parallel import sweep
    from blockchain_simulator_tpu_torch.parallel.mesh import make_mesh
    from blockchain_simulator_tpu_torch.utils import config

    mesh1 = make_mesh(1, 1, device="cpu")
    points = _points(config, CFG, PTS6[:2])
    canon = _canon(base, points)
    assert sweep.mesh_dyn_batched_fn(canon, mesh1) is sweep.dyn_batched_fn(canon)
    assert _json(sweep.run_dyn_points(canon, points, record=False, mesh=mesh1)) == \
        _json(sweep.run_dyn_points(canon, points, record=False, device="cpu"))


def test_registry_mesh_descriptors():
    """The registry's snapshot and manifest name an entry's mesh as JAX's
    (test_zzpartition.py::test_registry_mesh_descriptors)."""
    from blockchain_simulator_tpu_torch.parallel.mesh import NodeMesh
    from blockchain_simulator_tpu_torch.utils import aotcache
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    reg = aotcache.ExecutableRegistry()
    mesh = NodeMesh(1, 0, None, "cpu", n_sweep=8)
    reg.get("plain", (SimConfig(**CFG),), {}, lambda *_: object())
    reg.get("meshed", (SimConfig(**CFG), mesh), {}, lambda *_: object())
    snap = reg.stats_snapshot()
    assert snap["mesh"]["plain"] == {"none": 1}
    assert snap["mesh"]["meshed"] == {"sweep=8,nodes=1": 1}
    assert reg.manifest()["mesh"] == "sweep=8,nodes=1"
    reg.get("plain", (SimConfig(**CFG),), {}, lambda *_: object())
    assert reg.manifest()["mesh"] is None


def _serving_refusals():
    from blockchain_simulator_tpu_torch.serve import dispatch, fleet, schema
    from blockchain_simulator_tpu_torch.serve.__main__ import main as serve_main
    from blockchain_simulator_tpu_torch.serve.server import ScenarioServer

    def run_batch():
        req = schema.parse_request({"protocol": "pbft", "n": 8, "sim_ms": 100}, "r")
        dispatch.run_batch([req], 1, mesh=object(), device="cpu")

    return {
        "run_batch": run_batch,
        "server": lambda: ScenarioServer(mesh=object(), device="cpu", start=False),
        "daemon": lambda: serve_main(["--mesh-sweep", "2", "--device", "cpu"]),
        "fleet": lambda: fleet.main(["--mesh-sweep", "2", "--device", "cpu"]),
    }


@pytest.mark.parametrize("site", ["run_batch", "server", "daemon", "fleet"])
def test_serving_surfaces_still_refused_naming_a7b(site, capsys):
    """The serving surfaces of the sweep axis wait for their own item:
    each refuses with the one string that names it."""
    from blockchain_simulator_tpu_torch.parallel.mesh import MESH_SERVING_ITEM

    assert "item 7b" in MESH_SERVING_ITEM
    fn = _serving_refusals()[site]
    if site in ("daemon", "fleet"):
        assert fn() == 2
        assert MESH_SERVING_ITEM in capsys.readouterr().err
        return
    with pytest.raises(NotImplementedError, match="item 7b") as err:
        fn()
    assert MESH_SERVING_ITEM in str(err.value)


# --------------------------------------------------------------- golden ---

def test_golden_normal_entry_equals_live_jax():
    """One golden entry recomputed live: JAX's ``"normal"`` rows over a
    ``(2, 1)`` mesh of virtual devices."""
    assert _json(jax_mesh_rows(NORMAL, PTS6, 2)) == _json(_golden()["normal@2"]["rows"])


def test_golden_card_entry_holds_config_2():
    """chip_smoke.py's mesh-sweep entry: config 2 over a (2, 1) mesh, f in
    {0, 333} x seeds {0, 1}; f = 0 finalizes every block, and its keys."""
    e = _golden()["card@2"]
    assert (e["config"], e["f_values"], e["seeds"]) == (CARD, list(CARD_F), list(CARD_SEEDS))
    assert [(r["f"], r["seed"]) for r in e["rows"]] == \
        [(f, s) for f in CARD_F for s in CARD_SEEDS]
    edge = json.loads((GOLDEN.parent / "pbft_edge_s0.json").read_text())["entries"]["n1000"]
    assert {k: v for k, v in e["rows"][0].items() if k not in ("f", "seed")} == \
        edge["metrics"]
    assert len(e["keys"]) == len(CARD_F)


def jax_mesh_rows(kw, pts, n_sweep, n_nodes=1, **extra):
    """JAX's ``run_dyn_points`` over a ``(n_sweep, n_nodes)`` mesh."""
    import jax

    from blockchain_simulator_tpu.models import base as jbase
    from blockchain_simulator_tpu.parallel import sweep as jsweep
    from blockchain_simulator_tpu.parallel.mesh import make_mesh as jmake_mesh
    from blockchain_simulator_tpu.utils import config as jconfig

    points = _points(jconfig, kw, pts, extra.pop("kind", "n_byzantine"))
    mesh = jmake_mesh(n_nodes, n_sweep, devices=jax.devices()[:n_sweep * n_nodes])
    return jsweep.run_dyn_points(_canon(jbase, points), points, record=False, mesh=mesh,
                                 **extra)


def write_golden(names=None):
    import contextlib
    import io
    import tempfile

    import jax

    from blockchain_simulator_tpu import cli as jcli
    from blockchain_simulator_tpu.obsim import schema as jschema
    from blockchain_simulator_tpu.parallel import journal as jjournal
    from blockchain_simulator_tpu.parallel import sweep as jsweep
    from blockchain_simulator_tpu.parallel.mesh import make_mesh as jmake_mesh
    from blockchain_simulator_tpu.parallel.shard import run_sharded
    from blockchain_simulator_tpu.query import parse_query, run_query
    from blockchain_simulator_tpu.utils import config as jconfig
    from test_torch_cli import _comparable

    doc = json.loads(GOLDEN.read_text()) if GOLDEN.exists() else {"entries": {}}
    doc["about"] = (
        "JAX package (blockchain_simulator_tpu) sweeps over meshes of virtual CPU devices "
        "(parallel/sweep.py mesh=) that the port's sweeps over as many gloo ranks, and "
        "chip_smoke.py's mesh-sweep phase on the card, must reproduce bit for bit: "
        "<case>@<n_sweep> over a (n_sweep, 1) mesh, <case>@2x2 over a (2, 2) mesh "
        "(equal to JAX's single-device rows), seed@2 JAX's run_sharded over 2 "
        "devices a seed and its command line's --shards 2 --seeds lines.  Written by: "
        + WRITTEN_BY)
    doc["jax_version"] = jax.__version__
    entries = doc["entries"]

    def card():
        cfg = jconfig.SimConfig(**CARD)
        mesh = jmake_mesh(1, 2, devices=jax.devices()[:2])
        rows = jsweep.run_byzantine_sweep(cfg, f_values=CARD_F, seeds=CARD_SEEDS, mesh=mesh)
        fcs = [dataclasses.replace(cfg.faults, n_byzantine=f, byz_forge=True) for f in CARD_F]
        return {"config": CARD, "f_values": list(CARD_F), "seeds": list(CARD_SEEDS),
                "forge": True, "mesh": {"sweep": 2, "nodes": 1}, "rows": rows,
                "keys": jsweep.dyn_chunk_keys(cfg, fcs, CARD_SEEDS, mesh=mesh)}

    def journal():
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "j.jsonl")
            rows, meta = jax_mesh_rows(CFG, PTS6, 2, kind="n_crashed",
                                       journal=jjournal.SweepJournal(path), chunk_size=2,
                                       with_index=True)
            with open(path) as f:
                lines = f.readlines()
        return {"config": CFG, "points": PTS6, "rows": rows,
                "keys": [c["key"] for c in meta["chunks"]], "journal": lines}

    def seed():
        cfg = jconfig.SimConfig(**SEED)
        mesh = jmake_mesh(n_node_shards=2, devices=jax.devices()[:2])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert jcli.main(SEED_ARGV) == 0
        lines = [json.loads(ln) for ln in out.getvalue().strip().splitlines()]
        return {"config": SEED, "seeds": SEEDS,
                "run_sharded": [run_sharded(cfg, mesh, seed=s) for s in SEEDS],
                "cli_lines": [_comparable(m) for m in lines]}

    def query():
        res = run_query(jconfig.SimConfig(**QTPL), parse_query(Q_MAXF),
                        mesh=jmake_mesh(1, 2, devices=jax.devices()[:2]))
        return {"config": QTPL, "query": Q_MAXF,
                "result": {k: res[k] for k in ("query", "answer", "trail", "points")},
                "run": {k: res["run"][k] for k in ("lanes", "pad", "dispatches")}}

    def nodes(name):
        kw, pts, probe = NODES_GOLDEN[name]
        extra = {"probe": jschema.ProbeConfig(**PROBE)} if probe else {}
        rows = jax_mesh_rows(kw, pts, 2, 2, **extra)
        # JAX's nodes arm is its single-device batched program partitioned
        assert json.dumps(rows, sort_keys=True) == \
            json.dumps(jax_single_rows(kw, pts, probe), sort_keys=True), name
        return {"config": kw, "points": pts, "probe": PROBE if probe else None,
                "mesh": {"sweep": 2, "nodes": 2}, "rows": rows}

    makers = {
        "normal@2": lambda: {"config": NORMAL, "points": PTS6,
                             "rows": jax_mesh_rows(NORMAL, PTS6, 2)},
        **{f"{name}@2x2": (lambda name=name: nodes(name)) for name in NODES_GOLDEN},
        "probe@2": lambda: {"config": CFG, "points": PTS6, "probe": PROBE,
                            "rows": jax_mesh_rows(CFG, PTS6, 2,
                                                  probe=jschema.ProbeConfig(**PROBE))},
        "journal@2": journal,
        "seed@2": seed,
        "query@2": query,
        "card@2": card,
    }
    for name in names or makers:
        entries[name] = json.loads(json.dumps(makers[name]()))
        print(name, "written", flush=True)
        GOLDEN.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    if "--write-golden" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
        write_golden([a for a in sys.argv[1:] if not a.startswith("--")] or None)
