"""The port's Paxos path on the card (marked ``cuda``; skips without one).

The ring-push kernel at the Paxos tick group's BASELINE config 3 shapes
(n = 10,000, P = 3, ring depth 106, 50 buckets a member: three ``max``
members of 30,000 lanes, two ``add`` members of 30,000 and one ``max``
member of 10,000), held bit for bit to its plain version: eagerly at ticks
that wrap around the ring, under CUDA-graph replay, and with the members of
skipped gates left out.  Then short Paxos runs over gossip on the card held
to the same runs on the CPU, every final-state field.  This file imports no
JAX code: on the card's machine run it with
``python -m pytest tests/test_torch_card_paxos.py -m cuda``.
"""

from __future__ import annotations

import pytest
import torch

from blockchain_simulator_tpu_torch import convert, runner
from blockchain_simulator_tpu_torch.models import paxos
from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
from blockchain_simulator_tpu_torch.utils.config import SimConfig

# BASELINE config 3, as tools/run_config3.py builds it
CFG = SimConfig(protocol="paxos", n=10_000, sim_ms=3000, topology="gossip", degree=16,
                delivery="stat", model_serialization=False, paxos_retry_timeout_ms=600)


@pytest.fixture
def cuda_device():
    # decided here, never at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the H100: python -m pytest "
                    "tests/test_torch_card_paxos.py -m cuda")
    return "cuda"


def tick_group(cfg, device, seed=0, members=None):
    """``(name, (ring, lo, contrib, op))`` for the pushes of one Paxos tick
    whose gates all fire (``paxos.push_members``) at ``cfg``'s shapes, or
    the members named in ``members``: rings and contributions of values
    >= 0, as on the main path."""
    gen = torch.Generator(device=device).manual_seed(seed)
    _, bufs = paxos.init(cfg, device="meta")
    items = []
    for name, op, b, lo in paxos.push_members(cfg):
        if members is not None and name not in members:
            continue
        shape = getattr(bufs, name).shape
        ring = torch.randint(0, 1 << 20, shape, generator=gen, device=device,
                             dtype=torch.int32)
        contrib = torch.randint(0, 1 << 20, (b, *shape[1:]), generator=gen, device=device,
                                dtype=torch.int32)
        items.append((name, (ring, lo, contrib, op)))
    return items


def _clone(items):
    return [(r.clone(), lo, c, op) for _, (r, lo, c, op) in items]


@pytest.mark.cuda
@pytest.mark.parametrize("members", [None, ("resp_ok", "resp_no", "resp_cmd"),
                                     ("req_ticket",), ("req_propose", "req_commit")])
def test_paxos_tick_group_matches_plain(cuda_device, members):
    items = tick_group(CFG, cuda_device, members=members)
    assert [it[0].shape[0] for _, it in items] == [CFG.ring_depth] * len(items)
    assert all(it[2].shape[0] == 50 for _, it in items)
    assert rk.plan_group([it for _, it in items]).vec == (True,) * len(items)  # int4
    for t in (0, 7, CFG.ring_depth - 1, 2999):  # 2999 + lo + b wraps past D
        tt = torch.tensor(t, dtype=torch.int32, device=cuda_device)
        got, want = _clone(items), _clone(items)
        before = rk.launches, rk.pushes
        rk.push_group(got, tt)
        assert (rk.launches, rk.pushes) == (before[0] + 1, before[1] + len(items))
        rk.push_group_plain(want, tt)
        torch.cuda.synchronize()
        assert all(torch.equal(g[0], w[0]) for g, w in zip(got, want)), t


@pytest.mark.cuda
def test_paxos_tick_group_graph_replay_equals_eager(cuda_device):
    items = tick_group(CFG, cuda_device, seed=1)
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
@pytest.mark.parametrize("kw", [
    dict(n=256, sim_ms=900, topology="gossip", degree=8, paxos_retry_timeout_ms=600),
    dict(n=64, sim_ms=900, fidelity="reference"),
])
def test_card_run_equals_cpu_run(cuda_device, kw):
    cfg = SimConfig(protocol="paxos", **kw)
    rk.launches = 0
    card = runner.final_state(cfg, device=cuda_device)
    assert rk.launches > 0
    cpu = runner.final_state(cfg, device="cpu")
    assert (convert.state_digests(convert.state_to_numpy(card))
            == convert.state_digests(convert.state_to_numpy(cpu)))
