"""The port's probe traces on the card, against the CPU.

The CPU runs are held bit for bit to the JAX package by
tests/test_torch_trace.py; here the card is held to the CPU, so the chain
reaches JAX.  The probed round scan must make no host sync (it runs under
``torch.cuda.set_sync_debug_mode("error")``).  Every case is marked
``cuda`` and skips without a card.  This file imports no JAX code:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_card_trace.py -m cuda
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from blockchain_simulator_tpu_torch.models import pbft_round
from blockchain_simulator_tpu_torch.utils import threefry, trace
from blockchain_simulator_tpu_torch.utils.config import SimConfig


@pytest.fixture
def cuda_device():
    # decided here, never at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the H100: JAX_PLATFORMS=cpu "
                    "python -m pytest tests/test_torch_card_trace.py -m cuda")
    return "cuda"


ROUND = SimConfig(protocol="pbft", n=4096, sim_ms=1000, delivery="stat",
                  model_serialization=False)


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["normal", "exact"])
def test_probed_round_scan_has_no_host_sync(cuda_device, sampler):
    """The probed round scan reads nothing back: its samples stay on the
    card until the run ends.  (The exact sampler's rejection loops read
    their stop condition, so only the "normal" arm is sync-free.)"""
    cfg = ROUND.with_(stat_sampler=sampler)
    key = threefry.key(0)
    state, _ = pbft_round.init(cfg, threefry.fold_in(key, 0x1217), device=cuda_device)
    torch.cuda.synchronize()
    if sampler == "normal":
        torch.cuda.set_sync_debug_mode("error")
    try:
        final, ys = pbft_round.scan_rounds(cfg, state, key, with_probe=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    cpu_state, _ = pbft_round.init(cfg, threefry.fold_in(key, 0x1217), device="cpu")
    _, want = pbft_round.scan_rounds(cfg, cpu_state, key, with_probe=True)
    assert sorted(ys) == sorted(want)
    for k in want:
        assert ys[k].device.type == "cuda"
        assert torch.equal(ys[k].cpu(), want[k]), k


CONFIGS = {
    "tick_pbft": SimConfig(protocol="pbft", n=64, sim_ms=300),
    "round": ROUND,
    "hb": SimConfig(protocol="raft", n=64, sim_ms=1500, delivery="stat", schedule="round"),
    "mixed": SimConfig(protocol="mixed", n=48, mixed_shards=4, sim_ms=800, delivery="stat",
                       model_serialization=False),
    "committee": SimConfig(protocol="pbft", n=64, sim_ms=150, topology="committee",
                           committees=4, stat_sampler="normal", delivery="stat"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_card_trace_equals_cpu(cuda_device, name):
    cfg = CONFIGS[name]
    got_m, got = trace.run_traced(cfg, device=cuda_device)
    want_m, want = trace.run_traced(cfg, device="cpu")
    assert got_m == want_m
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
