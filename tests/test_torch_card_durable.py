"""Durable, supervised and probed sweeps on the card.

The CPU runs of the same functions are held bit for bit to the JAX package
by tests/test_torch_journal.py, test_torch_obsim.py and test_torch_query.py;
here the card runs them.  Every case is marked ``cuda`` and skips without a
card.  This file imports no JAX code, so it runs where jax is installed
without flax:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_card_durable.py -m cuda
"""

from __future__ import annotations

import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from blockchain_simulator_tpu_torch import convert
from blockchain_simulator_tpu_torch.chaos import inject
from blockchain_simulator_tpu_torch.models import base
from blockchain_simulator_tpu_torch.obsim import build, host, schema
from blockchain_simulator_tpu_torch.parallel import journal, sweep
from blockchain_simulator_tpu_torch.utils import obs, threefry
from blockchain_simulator_tpu_torch.utils.config import FaultConfig, SimConfig

REPO = pathlib.Path(__file__).resolve().parent.parent
RAFT_HB_GOLDEN = REPO / "blockchain_simulator_tpu_torch" / "golden" / "raft_hb_n1000_s0.json"
ROUND = dict(protocol="pbft", n=4096, sim_ms=460, delivery="stat", model_serialization=False,
             pbft_max_rounds=8, pbft_max_slots=16)


@pytest.fixture
def cuda_device():
    # decided here, never at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the H100: JAX_PLATFORMS=cpu "
                    "python -m pytest tests/test_torch_card_durable.py -m cuda")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_card_supervisor_deadline_abandons_on_the_card(cuda_device, monkeypatch):
    """A hung primary arm misses its deadline: its thread is abandoned after
    selecting the card, the degrade arm answers on the card with the
    unsupervised rows, and the abandoned thread is drained before the test
    ends.  Nothing runs on the CPU."""
    cfg = SimConfig(**ROUND)
    pts = [(cfg.with_(faults=FaultConfig(n_crashed=f)), s) for f in (0, 1500) for s in (0, 1)]
    canon = base.canonical_fault_cfg(cfg)
    want = sweep.run_dyn_points(canon, pts, record=False, device=cuda_device)
    seen = []
    real = sweep._dispatch_dyn_points

    def spy(*args, **kw):
        seen.append((threading.current_thread().name, torch.cuda.current_device(),
                     str(kw.get("device", args[-1] if args else None))))
        return real(*args, **kw)

    monkeypatch.setattr(sweep, "_dispatch_dyn_points", spy)
    sup = journal.ChunkSupervisor(deadline_s=0.5, retries=0, backoff_s=0.0,
                                  degrade_deadline_s=None, rng=lambda: 0.5)
    with inject.ChaosController() as ctl:
        ctl.hang_next("sweep.chunk", 3.0, match=lambda c: c["arm"] == "primary")
        got = sweep.run_dyn_points(canon, pts, record=False, supervise=sup, device=cuda_device)
    assert obs.canonical_json(got) == obs.canonical_json(want)
    assert journal.drain_abandoned(120.0) == 1 and journal._abandoned == []
    assert len(seen) == 2  # the abandoned primary, late, and the degrade arm
    assert all(d == cuda_device.index and "cuda" in where for _, d, where in seen)


KILL_CHILD = """
import sys
from blockchain_simulator_tpu_torch.chaos import inject
from blockchain_simulator_tpu_torch.parallel import sweep, journal
from blockchain_simulator_tpu_torch.utils.config import SimConfig, FaultConfig
ctl = inject.ChaosController()
ctl.slow_next("sweep.chunk", 5.0, n=100, match=lambda c: c["index"] >= 1)
with ctl:
    sweep.run_fault_sweep(SimConfig(**{cfg!r}), [FaultConfig(n_crashed=f) for f in {levels!r}],
                          (0, 1), journal=journal.SweepJournal(sys.argv[1]))
"""


@pytest.mark.cuda
def test_card_kill9_resume(cuda_device, tmp_path):
    """A journaled sweep on the card in a child process, killed with SIGKILL
    after its first chunk lands: the resumed sweep recomputes only the
    missing chunks, and every row equals the uninterrupted sweep's."""
    path = str(tmp_path / "kill.jsonl")
    levels = [0, 500, 1500, 2100]
    proc = subprocess.Popen([sys.executable, "-c", KILL_CHILD.format(cfg=ROUND, levels=levels),
                             path], cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 300
        while not journal.SweepJournal(path).completed():
            assert proc.poll() is None and time.monotonic() < deadline, proc.stderr.read()
            time.sleep(0.1)
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.wait()
    landed = len(journal.SweepJournal(path).completed())
    assert proc.returncode == -signal.SIGKILL and 1 <= landed < len(levels)
    cfg = SimConfig(**ROUND)
    pts = [(cfg.with_(faults=FaultConfig(n_crashed=f)), s) for f in levels for s in (0, 1)]
    canon = base.canonical_fault_cfg(cfg)
    rows, meta = sweep.run_dyn_points(canon, pts, journal=journal.SweepJournal(path),
                                      chunk_size=2, with_index=True, device=cuda_device)
    assert meta["dispatches"] == len(levels) - landed
    want = sweep.run_dyn_points(canon, pts, chunk_size=2, supervise=journal.ChunkSupervisor(
        deadline_s=None), device=cuda_device)
    assert obs.canonical_json(rows) == obs.canonical_json(want)


@pytest.mark.cuda
def test_card_probed_raft_hb_equals_golden(cuda_device):
    """The probed Raft heartbeat run at n = 1,000 on the card: metrics and
    every state digest equal the JAX golden (armed equals disarmed), and
    the probe summary is the port's on the CPU-free path: JAX's field set,
    the heartbeat path's sample unit, no violation."""
    entry = json.loads(RAFT_HB_GOLDEN.read_text())["entries"]["n1000"]
    cfg = SimConfig(**entry["config"])
    canon = base.canonical_fault_cfg(cfg)
    pcfg = schema.ProbeConfig()
    final, probes = build.probed_solo_fn(canon, pcfg)(threefry.key(entry["seed"]), 0, 0,
                                                      cuda_device)
    assert base.sim_metrics(cfg, final) == entry["metrics"]
    assert convert.state_digests(convert.state_to_numpy(final)) == entry["state_sha256"]
    summary = schema.summarize(canon, pcfg, host.tree_to_host(probes))
    assert summary["fields"] == sorted(schema.SERIES_FIELDS["raft"])
    assert summary["sample_unit"] == "mixed-tick-heartbeat" and summary["violations"] == 0
    assert summary["final"]["blocks"] == entry["metrics"]["blocks"]
