"""The port's Raft path on the card (marked ``cuda``; skips without one).

The ring-push kernel at the Raft tick group's n = 1000 shapes (one ``vreq``
member of 3 x 1,000,000 lanes and six [B, 1000] members), held bit for bit
to its plain version: eagerly, under CUDA-graph replay, and with the members
whose gates were skipped left out of the group.  Then short Raft runs on the
card held to the same runs on the CPU, every final-state field.  This file
imports no JAX code: the card's machine runs it with
``python -m pytest tests/test_torch_card_raft.py -m cuda``.
"""

from __future__ import annotations

import pytest
import torch

from blockchain_simulator_tpu_torch import convert, runner
from blockchain_simulator_tpu_torch.models import raft
from blockchain_simulator_tpu_torch.ops import ring_kernel as rk
from blockchain_simulator_tpu_torch.utils.config import FaultConfig, SimConfig

CFG = SimConfig(protocol="raft", n=1000, sim_ms=10_000)


@pytest.fixture
def cuda_device():
    # decided here, never at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the H100: python -m pytest "
                    "tests/test_torch_card_raft.py -m cuda")
    return "cuda"


def _tick_group(device, seed=0, skip=()):
    """The Raft tick group at CFG's shapes: rings and contributions of values
    >= 0 (as on the main path); members named in ``skip`` get all-zero
    contributions."""
    gen = torch.Generator(device=device).manual_seed(seed)
    _, bufs = raft.init(CFG, device="meta")
    items = []
    for name, op, b, lo in raft.push_members(CFG):
        shape = getattr(bufs, name).shape
        ring = torch.randint(0, 1 << 20, shape, generator=gen, device=device, dtype=torch.int32)
        contrib = torch.randint(0, 1 << 20, (b, *shape[1:]), generator=gen, device=device,
                                dtype=torch.int32)
        if name in skip:
            contrib.zero_()
        items.append((name, (ring, lo, contrib, op)))
    return items


def _clone(items):
    return [(r.clone(), lo, c, op) for _, (r, lo, c, op) in items]


@pytest.mark.cuda
def test_raft_tick_group_matches_plain(cuda_device):
    items = _tick_group(cuda_device)
    assert rk.plan_group([it for _, it in items]).vec == (True,) * 7  # int4 path
    for t in (0, 7, CFG.ring_depth - 1, 9999):
        tt = torch.tensor(t, dtype=torch.int32, device=cuda_device)
        got, want = _clone(items), _clone(items)
        before = rk.launches, rk.pushes
        rk.push_group(got, tt)
        assert (rk.launches, rk.pushes) == (before[0] + 1, before[1] + 7)
        rk.push_group_plain(want, tt)
        torch.cuda.synchronize()
        assert all(torch.equal(g[0], w[0]) for g, w in zip(got, want)), t


@pytest.mark.cuda
def test_raft_tick_group_graph_replay_equals_eager(cuda_device):
    items = _tick_group(cuda_device, seed=1)
    tt = torch.tensor(9999, dtype=torch.int32, device=cuda_device)
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
@pytest.mark.parametrize("skip", [("vreq",), ("vres_ok", "vres_no", "vreq", "hb_bad")])
def test_leaving_out_skipped_members_changes_nothing(cuda_device, skip):
    """A skipped gate's contribution is all zeros; adding 0, or max with 0,
    into rings of values >= 0 is the identity, so the group without those
    members leaves every ring as the full group does."""
    items = _tick_group(cuda_device, seed=2, skip=skip)
    tt = torch.tensor(4321, dtype=torch.int32, device=cuda_device)
    full = _clone(items)
    rk.fused_push_group(full, tt)
    part = _clone(items)
    rk.fused_push_group([it for (name, _), it in zip(items, part) if name not in skip], tt)
    torch.cuda.synchronize()
    assert all(torch.equal(a[0], b[0]) for a, b in zip(full, part))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(n=16, sim_ms=800),
    dict(n=16, sim_ms=800, delivery="stat", schedule="tick", faults=dict(n_byzantine=1)),
    dict(n=64, sim_ms=1500, delivery="stat", schedule="round"),
    dict(n=8, sim_ms=900, queued_links=True),
], ids=["edge", "stat_byzantine", "heartbeat_path", "queued"])
def test_raft_on_the_card_equals_the_cpu(cuda_device, kw):
    kw = dict(kw, protocol="raft", raft_proposal_delay_ms=300)
    cfg = SimConfig(faults=FaultConfig(**kw.pop("faults", {})), **kw)
    on_card = convert.state_to_numpy(runner.final_state(cfg, device=cuda_device))
    on_cpu = convert.state_to_numpy(runner.final_state(cfg, device="cpu"))
    assert convert.state_digests(on_card) == convert.state_digests(on_cpu)
