"""The port's samplers and round-blocked PBFT path on the card, against the CPU.

The CPU runs of the same functions are held bit for bit to the JAX package
by tests/test_torch_philox.py, test_torch_sampling.py and test_torch_round.py;
here the card is held to the CPU, so the chain reaches JAX.  Every case is
marked ``cuda`` and skips without a card.  This file imports no JAX code, so
it runs where jax is installed without flax:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_card_round.py -m cuda
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from blockchain_simulator_tpu_torch import convert, runner
from blockchain_simulator_tpu_torch.ops import delay
from blockchain_simulator_tpu_torch.utils import philox, threefry
from blockchain_simulator_tpu_torch.utils.config import SimConfig


@pytest.fixture
def cuda_device():
    # decided here, never at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the H100: JAX_PLATFORMS=cpu "
                    "python -m pytest tests/test_torch_card_round.py -m cuda")
    return "cuda"


KEY = threefry.fold_in(threefry.key(3), 17)
COUNT = np.random.default_rng(0).integers(0, 3000, 20_000).astype(np.float32)
SAMPLERS = {
    "philox_bits": lambda d: philox.bits(philox.rbg_key(KEY), (3, 1001), d),
    "fast_normal": lambda d: delay._fast_normal(KEY, (4, 999), d),
    "rbg_edges": lambda d: delay.sample_edge_delays(KEY, (101, 7), 3, 7, d, "rbg"),
    "binomial": lambda d: threefry.binomial(KEY, torch.from_numpy(COUNT).to(d), 0.3, d),
    "categorical": lambda d: threefry.categorical(
        KEY, torch.zeros(3), (5000,), d),
    "chain_normal": lambda d: delay.sample_bucket_counts(
        KEY, torch.from_numpy(COUNT.astype(np.int32)).to(d), delay.roundtrip_probs(3, 6),
        "normal"),
    "chain_exact": lambda d: delay.sample_bucket_counts(
        KEY, torch.from_numpy(COUNT[:2000].astype(np.int32)).to(d),
        delay.uniform_probs(3, 6), "exact"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_card_sampler_equals_cpu(cuda_device, name):
    got, want = SAMPLERS[name](cuda_device).cpu(), SAMPLERS[name]("cpu")
    assert got.dtype == want.dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["normal", "exact"])
def test_card_round_path_equals_cpu(cuda_device, sampler):
    cfg = SimConfig(protocol="pbft", n=4096, sim_ms=600, delivery="stat",
                    model_serialization=False, stat_sampler=sampler)
    assert runner.use_round_schedule(cfg)
    got = convert.state_to_numpy(runner.final_state(cfg, device=cuda_device))
    want = convert.state_to_numpy(runner.final_state(cfg, device="cpu"))
    assert convert.state_digests(got) == convert.state_digests(want)


@pytest.mark.cuda
def test_card_round_loop_makes_no_host_sync(cuda_device):
    from blockchain_simulator_tpu_torch.models import pbft_round

    cfg = SimConfig(protocol="pbft", n=4096, sim_ms=600, delivery="stat",
                    model_serialization=False)
    state, _ = pbft_round.init(cfg, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pbft_round.scan_rounds(cfg, state, threefry.key(0))
    finally:
        torch.cuda.set_sync_debug_mode(0)
