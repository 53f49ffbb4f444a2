"""The port's mixed shard sim on the card (marked ``cuda``; skips without one).

The ring-push kernel at the mixed sim's Raft group: the rings laid out
slot-major, ``[D, S, m]``, so each channel is one member of ``S·m`` lanes.
At BASELINE config 5's shapes (S = 256, m = 1000, D = 12: five members of
3 x 256,000 and ``hb_ok``'s 5 x 256,000) the group is held bit for bit to
its plain version, eagerly and under CUDA-graph replay.  Then the milestone
run (n = 48, 8 shards, 3,000 ms, stat, serialization off) on the card,
held to the same run on the CPU in every final-state field, on the fast
path and on the tick engine.  This file imports no JAX code: the card's
machine runs it with ``python -m pytest tests/test_torch_card_mixed.py -m
cuda``.
"""

from __future__ import annotations

import pytest
import torch

from blockchain_simulator_tpu_torch import convert, runner
from blockchain_simulator_tpu_torch.models import mixed, raft
from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
from blockchain_simulator_tpu_torch.utils.config import SimConfig

CONFIG5 = SimConfig(protocol="mixed", n=256_000, mixed_shards=256, sim_ms=3000,
                    delivery="stat", model_serialization=False)
MILESTONE = SimConfig(protocol="mixed", n=48, mixed_shards=8, sim_ms=3000, delivery="stat",
                      model_serialization=False)


@pytest.fixture
def cuda_device():
    # decided here, never at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the H100: python -m pytest "
                    "tests/test_torch_card_mixed.py -m cuda")
    return "cuda"


def _mixed_group(cfg, device, seed=0):
    """The Raft group of one mixed tick whose gates all fire, at ``cfg``'s
    slot-major ring shapes (``hb_bad`` only with Byzantine nodes), rings and
    contributions of values >= 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rcfg, _ = mixed.sub_configs(cfg)
    bufs = mixed.init(cfg, device="meta")[1].raft
    items = []
    for name, op, b, lo in raft.push_members(rcfg):
        if name == "hb_bad" and rcfg.faults.n_byzantine == 0:
            continue
        shape = getattr(bufs, name).shape
        ring = torch.randint(0, 1 << 20, shape, generator=gen, device=device, dtype=torch.int32)
        contrib = torch.randint(0, 1 << 20, (b, *shape[1:]), generator=gen, device=device,
                                dtype=torch.int32)
        items.append((ring, lo, contrib, op))
    return items


def _clone(items):
    return [(r.clone(), lo, c, op) for r, lo, c, op in items]


@pytest.mark.cuda
def test_config5_group_matches_plain(cuda_device):
    items = _mixed_group(CONFIG5, cuda_device)
    assert [tuple(c.shape) for _, _, c, _ in items] == (
        [(3, 256, 1000)] * 5 + [(5, 256, 1000)])
    assert rk.plan_group(items).vec == (True,) * 6  # int4 path, one member a channel
    for t in (0, 7, 11, 2999):
        tt = torch.tensor(t, dtype=torch.int32, device=cuda_device)
        got, want = _clone(items), _clone(items)
        before = rk.launches, rk.pushes
        rk.push_group(got, tt)
        assert (rk.launches, rk.pushes) == (before[0] + 1, before[1] + 6)
        rk.push_group_plain(want, tt)
        torch.cuda.synchronize()
        assert all(torch.equal(g[0], w[0]) for g, w in zip(got, want)), t


@pytest.mark.cuda
def test_config5_group_graph_replay_equals_eager(cuda_device):
    items = _mixed_group(CONFIG5, cuda_device, seed=1)
    tt = torch.tensor(2999, dtype=torch.int32, device=cuda_device)
    eager = _clone(items)
    rk.fused_push_group(eager, tt)
    replayed = _clone(items)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rk.fused_push_group(replayed, tt)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a[0], b[0]) for a, b in zip(eager, replayed))


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["auto", "tick"])
def test_milestone_on_the_card_equals_the_cpu(cuda_device, schedule):
    cfg = MILESTONE.with_(schedule=schedule)
    before = rk.launches
    on_card = runner.final_state(cfg, device=cuda_device)
    assert rk.launches > before  # the Raft and PBFT groups went through the kernel
    on_cpu = runner.final_state(cfg, device="cpu")
    assert runner.sim_metrics(cfg, on_card) == runner.sim_metrics(cfg, on_cpu)
    assert (convert.state_digests(convert.state_to_numpy(on_card))
            == convert.state_digests(convert.state_to_numpy(on_cpu)))
