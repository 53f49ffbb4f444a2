"""The port's lane-batched sweeps and its checkpoints on the card, against
the CPU.

The CPU runs of the same functions are held bit for bit to the JAX package
by tests/test_torch_sweep.py and test_torch_checkpoint.py; here the card is
held to the CPU, so the chain reaches JAX.  Every case is marked ``cuda``
and skips without a card.  This file imports no JAX code, so it runs where
jax is installed without flax:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_card_sweep.py -m cuda
"""

from __future__ import annotations

import pytest
import torch

from blockchain_simulator_tpu_torch import convert, runner
from blockchain_simulator_tpu_torch.models import base
from blockchain_simulator_tpu_torch.parallel import sweep
from blockchain_simulator_tpu_torch.utils import checkpoint, threefry
from blockchain_simulator_tpu_torch.utils.config import FaultConfig, SimConfig


@pytest.fixture
def cuda_device():
    # decided here, never at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the H100: JAX_PLATFORMS=cpu "
                    "python -m pytest tests/test_torch_card_sweep.py -m cuda")
    return "cuda"


def _round_cfg(sampler: str) -> SimConfig:
    return SimConfig(protocol="pbft", n=256, sim_ms=600, delivery="stat", schedule="round",
                     stat_sampler=sampler, model_serialization=False)


def _lanes(cfg, device):
    """A 12-lane batch in config 4's form (6 f values x 2 seeds) on the round
    path: its lane-stacked finals as numpy leaves."""
    canon = base.canonical_fault_cfg(cfg)
    fs = [0, 20, 42, 63, 85, 129]
    seeds = [s for _ in fs for s in (0, 1)]
    finals = sweep.dyn_batched_fn(canon)(sweep._keys(seeds), [0] * 12,
                                         [f for f in fs for _ in (0, 1)], device)
    return convert.state_to_numpy(finals)


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["normal", "exact"])
def test_card_lane_batch_equals_cpu(cuda_device, sampler):
    """The 12-lane round batch on the card equals the port on the CPU, every
    field of every lane."""
    cfg = _round_cfg(sampler)
    got, want = _lanes(cfg, cuda_device), _lanes(cfg, "cpu")
    assert convert.state_digests(got) == convert.state_digests(want)


@pytest.mark.cuda
def test_card_one_lane_batch_equals_final_state(cuda_device):
    """A batch of one lane on the card is ``final_state`` on the card."""
    cfg = _round_cfg("normal").with_(faults=FaultConfig(n_byzantine=30))
    finals = sweep.dyn_batched_fn(base.canonical_fault_cfg(cfg))(
        sweep._keys([2]), [0], [30], cuda_device)
    solo = runner.final_state(cfg, seed=2, device=cuda_device)
    assert convert.state_digests(convert.lane_leaves(convert.state_to_numpy(finals), 0)) == \
        convert.state_digests(convert.state_to_numpy(solo))


@pytest.mark.cuda
def test_card_checkpoint_round_trips(cuda_device, tmp_path):
    """An archive of CUDA tensors loads back onto the card equal, and a run
    resumed from it on the card equals the CPU's uninterrupted metrics."""
    cfg = SimConfig(protocol="pbft", n=8, sim_ms=600, pbft_max_rounds=12)
    key = threefry.key(cfg.seed)
    proto = base.get_protocol("pbft")
    state, bufs = proto.init(cfg, threefry.fold_in(key, runner._INIT_FOLD), device=cuda_device)
    state, bufs = runner.make_segment_fn(cfg, 300)(key, state, bufs, 0)
    p = tmp_path / "ck.npz"
    checkpoint.save_checkpoint(p, cfg, state, bufs, 300)
    cfg2, s2, b2, t = checkpoint.load_checkpoint(p, device=cuda_device)
    assert cfg2 == cfg and t == 300 and s2.alive.is_cuda and b2.pp.is_cuda
    assert convert.state_digests(convert.state_to_numpy(s2, b2)[0]) == \
        convert.state_digests(convert.state_to_numpy(state, bufs)[0])
    assert runner.resume_simulation(p, device=cuda_device) == \
        runner.run_simulation(cfg, device="cpu")
