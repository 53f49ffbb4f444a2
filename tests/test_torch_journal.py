"""The port's durable, supervised sweeps (``parallel/journal.py`` and the
journaled path of ``parallel/sweep.py``) held to the JAX package.

- **Keys and checksums**: ``dyn_chunk_keys``, ``chunk_key`` (with ``n_out``),
  the probe (``+p<W>[m]``) and query (``+q<step>``) namespaces and
  ``row_checksum`` equal JAX's, byte for byte; over a mesh the keys carry
  its shape, as JAX's do.
- **The file**: torn tails (read past, and repaired before the next
  append), a corrupted row checksum demoting its chunk, duplicate lines,
  compaction; the port's reader and JAX's agree on every file.
- **Resume across packages**: a journal JAX's ``run_fault_sweep`` wrote
  answers the port's identical sweep with 0 dispatches, and the reverse;
  the lines hold the same keys, checksums and rows.
- **kill -9**: a child process runs a journaled sweep with a slowed chunk
  and is killed after its first chunk lands; the resumed sweep recomputes
  only the missing chunks and equals JAX's uninterrupted rows.
- **Supervision**: the deadline -> retry -> degrade trail (a hung primary
  arm abandoned in its thread, then drained), error retries, typed
  exhaustion and the checkpoint degrade arm, each with JAX's event list.
- **Serving**: ``ScenarioServer(journal_path=)`` answers a replayed batch
  from the journal as JAX's server does; the startup compaction keeps the
  chunks a pending WAL backlog needs and empties the file otherwise.

JAX's ``chaos/invariants.check_sweep_journal`` runs on the port's
journals.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from blockchain_simulator_tpu.chaos import inject as jinject
from blockchain_simulator_tpu.chaos import invariants
from blockchain_simulator_tpu.models.base import canonical_fault_cfg as jcanon
from blockchain_simulator_tpu.parallel import journal as jjournal
from blockchain_simulator_tpu.parallel import sweep as jsweep
from blockchain_simulator_tpu.utils.config import FaultConfig as JFault
from blockchain_simulator_tpu.utils.config import SimConfig as JConfig
from blockchain_simulator_tpu_torch.chaos import inject as tinject
from blockchain_simulator_tpu_torch.models.base import canonical_fault_cfg as tcanon
from blockchain_simulator_tpu_torch.obsim.schema import ProbeConfig as TProbe
from blockchain_simulator_tpu_torch.parallel import journal as tjournal
from blockchain_simulator_tpu_torch.parallel import sweep as tsweep
from blockchain_simulator_tpu_torch.utils import obs
from blockchain_simulator_tpu_torch.utils.config import FaultConfig as TFault
from blockchain_simulator_tpu_torch.utils.config import SimConfig as TConfig
from test_torch_pbft import release_jax_executables  # noqa: F401 (autouse fixture)
from test_torch_query import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the round path (lanes side by side, exact draws): cheap chunks
ROUND = dict(protocol="pbft", n=16, sim_ms=400, stat_sampler="exact", delivery="stat",
             schedule="round", model_serialization=False)
# the tick engine at n = 8 (tests/test_zjournal.py's config): the checkpoint arm
TICK = dict(protocol="pbft", n=8, sim_ms=200, stat_sampler="exact")
LEVELS = [0, 2, 5]
SEEDS = (0, 1)


def _fcs(fc_cls, levels=LEVELS):
    return [fc_cls(n_crashed=f) for f in levels]


def _cjson(rows):
    return [obs.canonical_json(r) for r in rows]


def _lines(journal_mod, path):
    return [(r["key"], r["index"], r["sums"], obs.canonical_json(r["rows"]))
            for r in journal_mod.SweepJournal(path).chunk_lines()]


@pytest.fixture(scope="module")
def jax_round(tmp_path_factory):
    """JAX's journaled ``run_fault_sweep`` over ROUND: ``(rows by level,
    journal path)``, computed once a process."""
    path = str(tmp_path_factory.mktemp("jax_journal") / "j.jsonl")
    fcs = _fcs(JFault)
    res = jsweep.run_fault_sweep(JConfig(**ROUND), fcs, SEEDS,
                                 journal=jjournal.SweepJournal(path))
    return [res[fc] for fc in fcs], path


def test_keys_and_checksums_equal_jax():
    """Chunk keys of every namespace and row checksums equal JAX's."""
    jcfg, tcfg = JConfig(**ROUND), TConfig(**ROUND)
    assert tsweep.dyn_chunk_keys(tcfg, _fcs(TFault), SEEDS) == \
        jsweep.dyn_chunk_keys(jcfg, _fcs(JFault), SEEDS)
    jpts = [(jcfg.with_(faults=JFault(n_crashed=f)), s) for f in LEVELS for s in SEEDS]
    tpts = [(tcfg.with_(faults=TFault(n_crashed=f)), s) for f in LEVELS for s in SEEDS]
    for idx, n_out in ((0, None), (3, 2)):
        assert tjournal.chunk_key(tcanon(tcfg), idx, tpts, n_out=n_out) == \
            jjournal.chunk_key(jcanon(jcfg), idx, jpts, n_out=n_out)
    assert tjournal.query_chunk_key(tcanon(tcfg), 4, tpts[:2]) == \
        jjournal.query_chunk_key(jcanon(jcfg), 4, jpts[:2])
    for row in ({"commits": 7, "ttf": [1.0, 2.5], "ok": True, "note": None},
                {"a": -1.0, "b": 10028.0, "c": 1e-7}):
        assert tjournal.row_checksum(row) == jjournal.row_checksum(row)
        assert tjournal.row_checksum(json.loads(json.dumps(row))) == tjournal.row_checksum(row)
    # over a mesh the keys carry its shape, as JAX's do (the sweep axis;
    # tests/test_torch_mesh_sweep.py holds every grid shape)
    import jax

    from blockchain_simulator_tpu.parallel.mesh import make_mesh as jmake_mesh
    from blockchain_simulator_tpu_torch.parallel.mesh import NodeMesh

    jmesh, tmesh = jmake_mesh(1, 2, devices=jax.devices()[:2]), NodeMesh(1, 0, None, "cpu",
                                                                          n_sweep=2)
    assert tjournal.chunk_key(tcanon(tcfg), 0, tpts, mesh=tmesh) == \
        jjournal.chunk_key(jcanon(jcfg), 0, jpts, mesh=jmesh)
    assert tsweep.dyn_chunk_keys(tcfg, _fcs(TFault), SEEDS, mesh=tmesh) == \
        jsweep.dyn_chunk_keys(jcfg, _fcs(JFault), SEEDS, mesh=jmesh)


def test_probe_and_query_key_namespaces(tmp_path):
    """An armed chunk journals under ``+p<W>[m]``, a key suffix after it,
    both as JAX names them; an armed call never reads a disarmed chunk."""
    tcfg = TConfig(**ROUND)
    pts = [(tcfg, 0), (tcfg, 1)]
    path = str(tmp_path / "p.jsonl")
    j = tjournal.SweepJournal(path)
    _, m0 = tsweep.run_dyn_points(tcanon(tcfg), pts, journal=j, with_index=True, device="cpu")
    _, m1 = tsweep.run_dyn_points(tcanon(tcfg), pts, journal=j, with_index=True, device="cpu",
                                  probe=TProbe(windows=4, monitors=False), key_suffix="+q2")
    base = m0["chunks"][0]["key"]
    assert m1["chunks"][0]["key"] == base + "+p4+q2" and m1["dispatches"] == 1
    jcfg = JConfig(**ROUND)
    assert base == jjournal.chunk_key(jcanon(jcfg), 0, [(jcfg, 0), (jcfg, 1)])
    assert invariants.check_sweep_journal(jjournal.SweepJournal(path)) == []


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_package_resume(direction, jax_round, tmp_path):
    """Either package's journal answers the other's identical sweep with 0
    dispatches; the two journals hold the same lines."""
    jrows, jpath = jax_round
    if direction == "jax_to_port":
        path = jpath
    else:
        path = str(tmp_path / "t.jsonl")
        fcs = _fcs(TFault)
        res = tsweep.run_fault_sweep(TConfig(**ROUND), fcs, SEEDS,
                                     journal=tjournal.SweepJournal(path), device="cpu")
        assert [_cjson(res[fc]) for fc in fcs] == [_cjson(r) for r in jrows]
        assert _lines(tjournal, path) == _lines(jjournal, jpath)
        assert invariants.check_sweep_journal(jjournal.SweepJournal(path)) == []
    pkg, jm, canon, cfg_cls, fc_cls, kw = (
        (tsweep, tjournal, tcanon, TConfig, TFault, {"device": "cpu"})
        if direction == "jax_to_port" else (jsweep, jjournal, jcanon, JConfig, JFault, {}))
    cfg = cfg_cls(**ROUND)
    pts = [(cfg.with_(faults=fc), s) for fc in _fcs(fc_cls) for s in SEEDS]
    rows, meta = pkg.run_dyn_points(canon(cfg), pts, journal=jm.SweepJournal(path),
                                    chunk_size=len(SEEDS), with_index=True, **kw)
    assert meta["dispatches"] == 0 and all(c["cached"] for c in meta["chunks"])
    assert _cjson(rows) == [r for level in jrows for r in _cjson(level)]


def test_torn_tail_corruption_and_compaction(tmp_path):
    """The file rules, on one journal read by both packages' readers: a torn
    tail is skipped and repaired before the next append; a corrupted row
    demotes its chunk; a duplicate is flagged; compaction keeps only the
    named valid chunks and drops the events."""
    path = str(tmp_path / "j.jsonl")
    j = tjournal.SweepJournal(path)
    j.append_chunk("k1", 0, [{"x": 1}])
    j.append_chunk("k2", 1, [{"x": 2}])
    j.append_event("k2", "deadline", attempt=1)
    j.close()
    with open(path, "a") as f:
        f.write('{"sj": 1, "op": "chunk", "key": "k3", "rows": [{"x"')
    for jm in (tjournal, jjournal):
        assert set(jm.SweepJournal(path).completed()) == {"k1", "k2"}
    j2 = tjournal.SweepJournal(path)
    j2.append_chunk("k4", 2, [{"x": 4}])
    j2.close()
    for jm in (tjournal, jjournal):
        assert set(jm.SweepJournal(path).completed()) == {"k1", "k2", "k4"}
    lines = open(path).read().splitlines()
    with open(path, "w") as f:
        f.write("\n".join(ln.replace('"x":2', '"x":3') for ln in lines) + "\n")
    assert set(tjournal.SweepJournal(path).completed()) == {"k1", "k4"}
    assert any("checksum" in v for v in invariants.check_sweep_journal(jjournal.SweepJournal(path)))
    tjournal.SweepJournal(path).append_chunk("k1", 0, [{"x": 1}])
    assert any("journaled 2 times" in v
               for v in invariants.check_sweep_journal(jjournal.SweepJournal(path)))
    j3 = tjournal.SweepJournal(path)
    assert j3.compact({"k1", "k2"}) == (1, 3)  # k2 corrupt, k4 unnamed, k1 once
    assert j3.completed() == {"k1": [{"x": 1}]} and j3.events() == []
    assert jjournal.SweepJournal(path).completed() == {"k1": [{"x": 1}]}
    assert tjournal.SweepJournal(path).compact() == (0, 1)
    assert open(path).read() == ""


KILL_CHILD = """
import sys
from blockchain_simulator_tpu_torch.chaos import inject
from blockchain_simulator_tpu_torch.parallel import sweep, journal
from blockchain_simulator_tpu_torch.utils.config import SimConfig, FaultConfig
ctl = inject.ChaosController()
ctl.slow_next("sweep.chunk", 3.0, n=100, match=lambda c: c["index"] >= 1)
with ctl:
    sweep.run_fault_sweep(SimConfig(**{cfg!r}), [FaultConfig(n_crashed=f) for f in {levels!r}],
                          {seeds!r}, journal=journal.SweepJournal(sys.argv[1]), device="cpu")
"""


def test_kill9_resume_drill(tmp_path):
    """kill -9 after the first chunk lands: the resumed sweep recomputes only
    the chunks that never landed and equals JAX's uninterrupted rows."""
    path = str(tmp_path / "kill.jsonl")
    levels = [0, 1, 2, 3]
    code = KILL_CHILD.format(cfg=TICK, levels=levels, seeds=(0,))
    proc = subprocess.Popen([sys.executable, "-c", code, path], cwd=REPO,
                            env=dict(os.environ, PYTHONPATH=REPO),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 120
        while not tjournal.SweepJournal(path).completed():
            assert proc.poll() is None and time.monotonic() < deadline, proc.stderr.read()
            time.sleep(0.05)
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.wait()
    assert proc.returncode == -signal.SIGKILL
    landed = len(tjournal.SweepJournal(path).completed())
    assert 1 <= landed < len(levels)
    cfg = TConfig(**TICK)
    pts = [(cfg.with_(faults=TFault(n_crashed=f)), 0) for f in levels]
    rows, meta = tsweep.run_dyn_points(tcanon(cfg), pts, journal=tjournal.SweepJournal(path),
                                       chunk_size=1, with_index=True, device="cpu")
    assert meta["dispatches"] == len(levels) - landed
    ref = jsweep.run_fault_sweep(JConfig(**TICK), [JFault(n_crashed=f) for f in levels], (0,))
    assert _cjson(rows) == [obs.canonical_json(ref[JFault(n_crashed=f)][0]) for f in levels]
    assert invariants.check_sweep_journal(jjournal.SweepJournal(path)) == []


def _trail(jm, inject_mod, tmp, sup_kw, scenario):
    """Run one supervised scenario through a package: ``(rows, events)``."""
    j = jm.SweepJournal(str(tmp / f"{jm.__name__.split('.')[0]}.jsonl"))
    calls = {"p": 0, "d": 0}

    def primary():
        calls["p"] += 1
        if scenario == "hang":
            time.sleep(0.4)
            return ["late"]
        if scenario == "flaky" and calls["p"] > 1:
            return ["ok"]
        raise RuntimeError("boom")

    def degrade():
        calls["d"] += 1
        if scenario == "exhaust":
            raise RuntimeError("boom")
        return ["degraded"]

    sup = jm.ChunkSupervisor(rng=lambda: 0.5, **sup_kw)
    try:
        rows, events = jm.run_supervised(primary, degrade, sup, journal=j, key="k")
    except jm.ChunkFailedError as e:
        rows, events = [type(e).__name__], None
    return rows, [(e["event"], e.get("attempt")) for e in j.events()], events, calls


@pytest.mark.parametrize("scenario,sup_kw", [
    ("hang", dict(deadline_s=0.05, retries=1, backoff_s=0.01)),
    ("flaky", dict(deadline_s=None, retries=2, backoff_s=0.0)),
    ("exhaust", dict(deadline_s=None, retries=1, backoff_s=0.0)),
])
def test_supervisor_trail_equals_jax(scenario, sup_kw, tmp_path):
    """deadline -> retry -> degrade (the hung primary abandoned in its
    thread, then drained), an error retried to success, and typed
    exhaustion: rows, returned events and journal events equal JAX's."""
    t = _trail(tjournal, tinject, tmp_path, sup_kw, scenario)
    j = _trail(jjournal, jinject, tmp_path, sup_kw, scenario)
    assert t == j
    assert tjournal.drain_abandoned(5.0) == (2 if scenario == "hang" else 0)
    jjournal.drain_abandoned(5.0)
    assert tjournal._abandoned == []


def test_supervised_sweep_arms_equal_jax(tmp_path):
    """A supervised, journaled sweep whose primary arm fails: without a
    journal the degrade arm answers (the schedule JAX's); with a checkpoint
    dir a one-point tick-engine chunk takes the checkpoint arm
    (runner.run_dyn_checkpointed), and rows and journal events equal
    JAX's."""
    out = {}
    for name, jm, sw, im, cfg_cls, fc_cls, canon, kw in (
            ("port", tjournal, tsweep, tinject, TConfig, TFault, tcanon, {"device": "cpu"}),
            ("jax", jjournal, jsweep, jinject, JConfig, JFault, jcanon, {})):
        cfg = cfg_cls(**TICK)
        pt = (cfg.with_(faults=fc_cls(n_byzantine=2)), 5)
        ctl = im.ChaosController(seed=0)
        ctl.fail_next("sweep.chunk", n=3, match=lambda c: c.get("arm") == "primary")
        sup = jm.ChunkSupervisor(deadline_s=None, retries=0, backoff_s=0.0, rng=lambda: 0.5)
        ck = jm.ChunkSupervisor(deadline_s=None, retries=1, backoff_s=0.0, rng=lambda: 0.5,
                                checkpoint_dir=str(tmp_path / name / "ckpts"),
                                checkpoint_every_ms=80)
        path = str(tmp_path / name / "j.jsonl")
        with ctl:
            plain = sw.run_dyn_points(canon(cfg), [pt], supervise=sup, **kw)
            rows = sw.run_dyn_points(canon(cfg), [pt], journal=jm.SweepJournal(path),
                                     supervise=ck, **kw)
        events = [(e["event"], e.get("attempt")) for e in jm.SweepJournal(path).events()]
        out[name] = (_cjson(plain), _cjson(rows), events, ctl.schedule(),
                     len(list((tmp_path / name / "ckpts").rglob("ckpt_*.npz"))))
    assert out["port"] == out["jax"]
    assert out["port"][2] == [("error", 1), ("retry", 1), ("error", 2), ("degrade", None)]
    assert out["port"][4] == 1


def test_serve_journal_answers_replayed_batch(tmp_path):
    """A journaled server's batched flush lands one content-keyed chunk (the
    JAX server's key and rows); a fresh server on the same journal answers
    the identical batch from it; startup compaction with no WAL backlog
    empties the journal, with a backlog keeps its chunks."""
    from blockchain_simulator_tpu.serve import ScenarioServer as JServer
    from blockchain_simulator_tpu_torch.serve import ScenarioServer as TServer

    def run_pair(server_cls, jp, tag, **kw):
        with server_cls(max_batch=2, max_wait_ms=50.0, journal_path=jp, start=False,
                        **kw) as srv:
            a = srv.submit(dict(ROUND, seed=1, id=f"{tag}-a"))
            b = srv.submit(dict(ROUND, seed=2, id=f"{tag}-b"))
            srv.start()
            ra, rb = a.result(300), b.result(300)
            assert srv.stats()["knobs"]["journal"] == jp
        assert ra["batch"]["mode"] == rb["batch"]["mode"] == "batched"
        return _cjson([ra["metrics"], rb["metrics"]])

    tj, jj = str(tmp_path / "t.journal"), str(tmp_path / "j.journal")
    first = run_pair(TServer, tj, "one", device="cpu")
    assert first == run_pair(JServer, jj, "one")
    assert _lines(tjournal, tj) == _lines(jjournal, jj) and len(_lines(tjournal, tj)) == 1
    assert run_pair(TServer, tj, "two", device="cpu") == first
    assert len(_lines(tjournal, tj)) == 1  # answered from the journal
    wal = str(tmp_path / "wal.jsonl")
    with open(wal, "w") as f:  # one admitted, unanswered request
        f.write(json.dumps({"wal": 1, "op": "admit", "id": "p", "req": dict(ROUND, seed=1)}) + "\n")
    TServer(journal_path=tj, wal_path=wal, device="cpu", start=False).close()
    assert len(_lines(tjournal, tj)) == 1
    TServer(journal_path=tj, wal_path=str(tmp_path / "empty.wal"), device="cpu",
            start=False).close()
    assert _lines(tjournal, tj) == []
