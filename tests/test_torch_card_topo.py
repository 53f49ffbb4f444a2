"""The port's sparse topologies on the card (marked ``cuda``; skips without one).

The ring-push kernel at the two new member shapes of the sparse paths —
PBFT's four pushes at n = 1,000,000 over a degree-8 overlay (rings
``[8, 10^6, 8]``, L = N·W = 8,000,000) and Raft kregular's group at
n = 10,000, degree 16 (``vreq`` ``[D, N, 17]``) — held bit for bit to its
plain version, eagerly and under CUDA-graph replay.  Then small kregular
and committee runs on the card, held to the same runs on the CPU in every
final-state field.  This file imports no JAX code: the card's machine runs
it with ``python -m pytest tests/test_torch_card_topo.py -m cuda``.
"""

from __future__ import annotations

import pytest
import torch

from blockchain_simulator_tpu_torch import convert, runner
from blockchain_simulator_tpu_torch.models import pbft, raft
from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
from blockchain_simulator_tpu_torch.utils.config import SimConfig

LADDER = dict(fidelity="clean", schedule="tick", model_serialization=False,
              link_delay_ms=1, pbft_delay_lo=1, pbft_delay_hi=3, pbft_window=8)
KREG_1M = SimConfig(protocol="pbft", n=1_000_000, sim_ms=150, topology="kregular", degree=8,
                    delivery="edge", edge_sampler="rbg", stat_sampler="exact", **LADDER)
KREG_RAFT = SimConfig(protocol="raft", n=10_000, sim_ms=1000, topology="kregular", degree=16)
EXACT = dict(fidelity="clean", stat_sampler="exact", edge_sampler="threefry")
RUNS = {
    "pbft_kreg_edge": SimConfig(protocol="pbft", n=64, sim_ms=300, topology="kregular",
                                degree=8, **EXACT),
    "raft_kreg_edge": SimConfig(protocol="raft", n=32, sim_ms=700, topology="kregular",
                                degree=20, raft_proposal_delay_ms=300, **EXACT),
    "paxos_kreg": SimConfig(protocol="paxos", n=12, sim_ms=700, topology="kregular",
                            degree=8, **EXACT),
    "pbft_committee": SimConfig(protocol="pbft", n=64, sim_ms=300, topology="committee",
                                committees=4, **EXACT),
}


@pytest.fixture
def cuda_device():
    # decided here, never at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the H100: python -m pytest "
                    "tests/test_torch_card_topo.py -m cuda")
    return "cuda"


def _group(model, cfg, device, seed=0):
    """Every push of one tick whose gates all fire, at ``cfg``'s ring shapes,
    rings and contributions of values >= 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    _, bufs = model.init(cfg, device="meta")
    items = []
    for name, op, b, lo in model.push_members(cfg):
        shape = getattr(bufs, name).shape
        ring = torch.randint(0, 1 << 20, shape, generator=gen, device=device, dtype=torch.int32)
        contrib = torch.randint(0, 1 << 20, (b, *shape[1:]), generator=gen, device=device,
                                dtype=torch.int32)
        items.append((ring, lo, contrib, op))
    return items


def _clone(items):
    return [(r.clone(), lo, c, op) for r, lo, c, op in items]


GROUPS = {"pbft_1m": (pbft, KREG_1M, [(3, 1_000_000, 8), (2, 1_000_000, 8),
                                       (2, 1_000_000, 8), (2, 1_000_000)]),
          "raft_kreg": (raft, KREG_RAFT, None)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GROUPS))
def test_topo_group_matches_plain(cuda_device, name):
    model, cfg, shapes = GROUPS[name]
    items = _group(model, cfg, cuda_device)
    if shapes is not None:
        assert [tuple(c.shape) for _, _, c, _ in items] == shapes
    else:  # vreq [B, N, K] beside six [B, N] members
        assert tuple(items[2][2].shape)[1:] == (cfg.n, cfg.degree + 1)
    for t in (0, 7, cfg.ring_depth - 1, cfg.ticks - 1):
        tt = torch.tensor(t, dtype=torch.int32, device=cuda_device)
        got, want = _clone(items), _clone(items)
        before = rk.launches, rk.pushes
        rk.push_group(got, tt)
        assert (rk.launches, rk.pushes) == (before[0] + 1, before[1] + len(items))
        rk.push_group_plain(want, tt)
        torch.cuda.synchronize()
        assert all(torch.equal(g[0], w[0]) for g, w in zip(got, want)), t


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GROUPS))
def test_topo_group_graph_replay_equals_eager(cuda_device, name):
    model, cfg, _ = GROUPS[name]
    items = _group(model, cfg, cuda_device, seed=1)
    tt = torch.tensor(cfg.ticks - 1, dtype=torch.int32, device=cuda_device)
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
@pytest.mark.parametrize("name", list(RUNS))
def test_small_run_on_the_card_equals_the_cpu(cuda_device, name):
    cfg = RUNS[name]
    before = rk.launches
    on_card = runner.final_state(cfg, device=cuda_device)
    assert rk.launches > before  # the tick's pushes went through the kernel
    on_cpu = runner.final_state(cfg, device="cpu")
    assert runner.sim_metrics(cfg, on_card) == runner.sim_metrics(cfg, on_cpu)
    assert (convert.state_digests(convert.state_to_numpy(on_card))
            == convert.state_digests(convert.state_to_numpy(on_cpu)))
