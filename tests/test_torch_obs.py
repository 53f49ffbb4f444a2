"""The port's run manifests and run log (utils/obs.py, utils/sync.py),
held to the JAX package's.

The same config hashes to the same key in both packages; the sweeps append
the JAX package's rows to ``$BLOCKSIM_RUNS_JSONL`` (apart from the fields
that name the backend); the rotation under ``$BLOCKSIM_LOG_MAX_BYTES``
leaves the same files; ``run_simulation(with_timing=True)`` returns JAX's
keys.  The manifest never initializes CUDA.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from blockchain_simulator_tpu import runner as jrunner
from blockchain_simulator_tpu.parallel import sweep as jsweep
from blockchain_simulator_tpu.utils import obs as jobs
from blockchain_simulator_tpu_torch import runner as trunner
from blockchain_simulator_tpu_torch.parallel import sweep as tsweep
from blockchain_simulator_tpu_torch.utils import obs as tobs
from blockchain_simulator_tpu_torch.utils.sync import force_sync
from test_torch_pbft import _cfgs, release_jax_executables  # noqa: F401 (autouse fixture)

HASHED = {
    "defaults": dict(),
    "headline": dict(protocol="pbft", n=100_000, sim_ms=100_100, pbft_max_rounds=2000,
                     pbft_max_slots=2008, pbft_window=8, delivery="stat",
                     model_serialization=False),
    "raft_faults": dict(protocol="raft", n=64, sim_ms=3000, faults=dict(n_crashed=5,
                                                                         drop_prob=0.01)),
    "mixed": dict(protocol="mixed", n=256_000, mixed_shards=256, sim_ms=3000,
                  delivery="stat", model_serialization=False),
    "committee": dict(protocol="pbft", n=100_000, sim_ms=150, topology="committee",
                      committees=200, stat_sampler="normal"),
    "kregular": dict(protocol="paxos", n=10_000, topology="kregular", degree=16, topo_seed=3,
                     paxos_client_node=1, paxos_client_ms=200),
    "byz_forge": dict(protocol="pbft", n=1000, faults=dict(n_byzantine=100, byz_forge=True,
                                                           byz_copies=5)),
}
# manifest fields that name the backend (jax: versions, backend; the port:
# torch, CUDA, the card) or the moment
BACKEND_FIELDS = {"ts", "jax", "jaxlib", "torch", "cuda", "backend", "device",
                  "device_count", "cache", "telemetry"}


def _pair(name):
    kw = dict(HASHED[name])
    return _cfgs(faults=kw.pop("faults", None), **kw)


@pytest.mark.parametrize("name", sorted(HASHED))
def test_config_hash_equals_jax(name):
    jcfg, tcfg = _pair(name)
    assert tobs.config_hash(tcfg) == jobs.config_hash(jcfg)


def test_config_hash_separates_configs():
    assert len({tobs.config_hash(_pair(name)[1]) for name in HASHED}) == len(HASHED)


def test_manifest_never_initializes_cuda():
    """A CPU run's manifest names torch and its CUDA build but no device,
    and reading it leaves CUDA uninitialized."""
    _, tcfg = _cfgs(protocol="raft", n=16)
    before = torch.cuda.is_initialized()
    rec = tobs.manifest(tcfg)
    assert torch.cuda.is_initialized() == before
    if not before:
        assert not {"backend", "device", "device_count"} & set(rec)
    assert rec["obs_schema"] == jobs.OBS_SCHEMA == 1
    assert rec["torch"].split("+")[0] == torch.__version__.split("+")[0]
    assert rec["cuda"] == torch.version.cuda
    assert (rec["config_hash"], rec["protocol"], rec["n"]) == (tobs.config_hash(tcfg), "raft", 16)
    assert tobs.manifest(backend="cpu", device_count=1)["backend"] == "cpu"


def test_manifest_reads_the_card_once_cuda_is_initialized(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: f"card {i}")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rec = tobs.manifest()
    assert (rec["backend"], rec["device"], rec["device_count"]) == ("cuda", "card 0", 1)


def test_shared_helpers_equal_jax():
    rec = {"b": [1, 2.5, None], "a": {"z": True, "y": "s"}}
    assert tobs.canonical_json(rec) == jobs.canonical_json(rec)
    xs = [5.0, 1.0, 3.0, 9.0, 7.0, 2.0]
    for q in (0, 50, 90, 99, 100):
        assert tobs.percentile(xs, q) == jobs.percentile(xs, q)
    assert tobs.percentile([], 50) == jobs.percentile([], 50) == 0.0
    for args in ((40, 2.0), (None, 1.0), (40, 0.0), (7, 3.0)):
        assert tobs.rounds_per_s(*args) == jobs.rounds_per_s(*args)
    m = {"x": 1}
    out = tobs.finalize(m, None, compile_s=1.23456, run_s=2.0, rounds=40, append=False)
    assert out is m and m["manifest"]["compile_plus_first_run_s"] == 1.235
    assert (m["manifest"]["run_s"], m["manifest"]["rounds_per_s"]) == (2.0, 20.0)
    assert tobs.finalize(m) is m  # idempotent


def _strip(rec: dict) -> dict:
    return dict(rec, manifest={k: v for k, v in rec["manifest"].items()
                               if k not in BACKEND_FIELDS})


def test_sweep_rows_reach_the_run_log_as_jax_rows(monkeypatch, tmp_path):
    """With $BLOCKSIM_RUNS_JSONL set, run_seed_sweep appends one row a seed
    (``{"seed": s, **metrics}`` with the manifest): JAX's rows apart from the
    backend fields; the returned rows stay pure metrics."""
    jcfg, tcfg = _cfgs(protocol="pbft", n=8, sim_ms=150)
    jpath, tpath = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    monkeypatch.setenv(tobs.RUNS_ENV, str(jpath))
    jrows = jsweep.run_seed_sweep(jcfg, seeds=[0, 1])
    monkeypatch.setenv(tobs.RUNS_ENV, str(tpath))
    trows = tsweep.run_seed_sweep(tcfg, seeds=[0, 1], device="cpu")
    assert trows == jrows and all("manifest" not in r for r in trows)
    jlog, tlog = tobs.read_jsonl(str(jpath)), tobs.read_jsonl(str(tpath))
    assert len(tlog) == 2 and [r["seed"] for r in tlog] == [0, 1]
    assert [_strip(r) for r in tlog] == [_strip(r) for r in jlog]
    # the multi-seed door records through the same hook
    trunner.run_multi_seed(tcfg, (2,), device="cpu")
    tlog = tobs.read_jsonl(str(tpath))
    assert len(tlog) == 3 and tlog[-1]["seed"] == 2
    assert tlog[-1]["manifest"]["config_hash"] == tobs.config_hash(tcfg)


def test_log_rotation_equals_jax(monkeypatch, tmp_path):
    """Under a small $BLOCKSIM_LOG_MAX_BYTES the log rotates to ``.1`` as
    JAX's does (the size checked on the first append and every 16th), and
    read_jsonl reads the kept generations in order."""
    monkeypatch.setenv(tobs.LOG_MAX_ENV, "300")
    paths = {"jax": str(tmp_path / "jax.jsonl"), "torch": str(tmp_path / "torch.jsonl")}
    for i in range(50):
        rec = {"i": i, "pad": "x" * 20}
        jobs.append_jsonl(rec, paths["jax"])
        tobs.append_jsonl(rec, paths["torch"])
    for suffix in ("", ".1"):
        with open(paths["jax"] + suffix) as fj, open(paths["torch"] + suffix) as ft:
            assert ft.read() == fj.read()
    got = [r["i"] for r in tobs.read_jsonl(paths["torch"])]
    assert got == [r["i"] for r in jobs.read_jsonl(paths["jax"])]
    assert got == list(range(got[0], 50)) and got[0] > 0
    assert tobs.rotate_if_over(paths["torch"], max_bytes=0) is False
    with open(paths["torch"], "a") as f:
        f.write("{torn\n[1]\n")
    assert [r["i"] for r in tobs.read_jsonl(paths["torch"])] == got
    assert tobs.read_jsonl(str(tmp_path / "missing.jsonl")) == []


def test_run_log_unset_writes_nothing(monkeypatch, tmp_path):
    monkeypatch.delenv(tobs.RUNS_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    tobs.record_run({"x": 1})
    tobs.append_jsonl({"x": 1})
    assert os.listdir(tmp_path) == []


def test_run_simulation_with_timing_has_jax_keys():
    jcfg, tcfg = _cfgs(protocol="pbft", n=8, sim_ms=200)
    jm = jrunner.run_simulation(jcfg, with_timing=True)
    tm = trunner.run_simulation(tcfg, with_timing=True, device="cpu")
    assert sorted(tm) == sorted(jm)
    timing = ("wallclock_s", "compile_plus_first_run_s")
    assert all(tm[k] > 0 for k in timing) and tm["ticks"] == jm["ticks"] == 200
    assert ({k: v for k, v in tm.items() if k not in timing}
            == {k: v for k, v in jm.items() if k not in timing})


def test_force_sync_returns_its_tree():
    tree = {"a": (torch.zeros(3), [np.ones(2), torch.ones(1)]), "b": None}
    assert force_sync(tree) is tree
    _, tcfg = _cfgs(protocol="pbft", n=8, sim_ms=50)
    state = trunner.final_state(tcfg, device="cpu")
    assert force_sync(state) is state
    final, compile_s, run_s = tobs.timed_run(lambda s: trunner.final_state(tcfg, s, "cpu"), 0)
    assert compile_s > 0 and run_s > 0 and json.dumps(trunner.sim_metrics(tcfg, final))
