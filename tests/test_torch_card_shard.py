"""The port's node-sharded engine on the card.

The CPU runs over gloo groups are held to the JAX package by
tests/test_torch_shard.py; here NCCL is held to the JAX golden: config 2
(PBFT, n = 1,000, 2,500 ms, edge) through parallel/multihost.main at world
size 1 (the card's machine has one GPU) equals JAX's run over a 1-device
mesh (golden/shard_s0.json), and ``--shards 2 --device cuda`` with fewer
than two cards exits non-zero before any rank starts.  Every case is
marked ``cuda`` and skips without a card.  This file imports no JAX code:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_card_shard.py -m cuda
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from blockchain_simulator_tpu_torch.parallel import multihost

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "blockchain_simulator_tpu_torch" / "golden" / "shard_s0.json"


@pytest.fixture
def cuda_device():
    # decided here, never at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the H100: JAX_PLATFORMS=cpu "
                    "python -m pytest tests/test_torch_card_shard.py -m cuda")
    return "cuda"


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO))


@pytest.mark.cuda
def test_card_nccl_world_size_1_config2_equals_golden(cuda_device):
    want = json.loads(GOLDEN.read_text())["entries"]["config2"]
    kw = want["config"]
    out = subprocess.run(
        [sys.executable, "-m", "blockchain_simulator_tpu_torch.parallel.multihost",
         "--coordinator", f"127.0.0.1:{multihost.free_port()}", "--num-processes", "1",
         "--process-id", "0", "--device", cuda_device, "--report",
         "--protocol", kw["protocol"], "--n", str(kw["n"]), "--sim-ms", str(kw["sim_ms"])],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads([ln for ln in out.stdout.splitlines() if ln.startswith("{")][-1])
    assert (line.pop("process_count"), line.pop("device_count")) == (1, 1)
    assert line.pop("state_sha256") == want["state_sha256"]
    extra = {k: line.pop(k)
             for k in ("collectives", "launches", "pushes", "wall_s", "split_s")}
    assert line == want["metrics"]
    # one ring-push launch of four pushes a tick, on the rank's local rings
    assert (extra["launches"], extra["pushes"]) == (kw["sim_ms"], 4 * kw["sim_ms"])
    assert extra["collectives"]["all_reduce"] > 0  # the gates went through NCCL


@pytest.mark.cuda
def test_card_two_ranks_on_one_card_exit_before_any_rank(cuda_device):
    if torch.cuda.device_count() >= 2:
        pytest.skip("this machine has two cards: two NCCL ranks fit")
    out = subprocess.run(
        [sys.executable, "-m", "blockchain_simulator_tpu_torch", "--protocol", "pbft",
         "--n", "16", "--sim-ms", "200", "--shards", "2", "--device", cuda_device],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "no fallback" in out.stderr
