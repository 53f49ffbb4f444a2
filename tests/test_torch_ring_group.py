"""The port's grouped ring push: many pushes, each on its own ring, in one
kernel launch.

On the CPU a group takes its plain version (the pushes one after another),
held here against the single pushes and the JAX package's DUS chain
(``ops/ring._push``).  The launch plan (:func:`ring_kernel.plan_group`:
block prefixes, the int4-or-scalar choice, the refusals) is plain Python and
is tested here too.  The CUDA kernel runs only on the card: its cases are
marked ``cuda`` and skip without one (this file imports no JAX model code);
``chip_smoke.py`` holds the kernel against the plain version at the PBFT tick
engine's n = 1000 shapes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockchain_simulator_tpu.ops import ring as jring
from blockchain_simulator_tpu_torch import runner
from blockchain_simulator_tpu_torch.models import pbft as tpbft
from blockchain_simulator_tpu_torch.ops import ring as tring
from blockchain_simulator_tpu_torch.ops import ring_kernel as tkernel
from blockchain_simulator_tpu_torch.utils.config import SimConfig

EPB = tkernel.ELEMS_PER_BLOCK


@pytest.fixture
def cuda_device():
    # decided here, never at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the H100: JAX_PLATFORMS=cpu "
                    "python -m pytest tests/test_torch_ring_group.py -m cuda")
    return "cuda"


def _group(seed, members):
    """numpy (ring, lo, contrib, op) members from ``(D, B, rest, lo, op)``."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(-1000, 1000, (d, *rest), dtype=np.int32), lo,
             rng.integers(-1000, 1000, (b, *rest), dtype=np.int32), op)
            for d, b, rest, lo, op in members]


def _torch_items(group, device="cpu"):
    return [(torch.from_numpy(r.copy()).to(device), lo, torch.from_numpy(c).to(device), op)
            for r, lo, c, op in group]


def _jax_push(buf, t, lo, contrib, op):
    fn = jring.ring_push_add if op == "add" else jring.ring_push_max
    return np.asarray(fn(jnp.asarray(buf), jnp.int32(t), lo, jnp.asarray(contrib)))


# (D, B, rest, lo, op) per member: the PBFT tick group at small n, a group
# that mixes add and max, B = D, an odd L, and groups of one
GROUPS = {
    "pbft_tick": [(13, 5, (8, 16), 12, "add"), (13, 3, (8, 16), 6, "add"),
                  (13, 3, (8, 16), 9, "max"), (13, 3, (8,), 6, "max")],
    "mixed_ops": [(7, 2, (33,), 1, "max"), (9, 4, (4, 4), 3, "add"),
                  (5, 1, (6,), 0, "max"), (11, 3, (2, 3, 5), 2, "add")],
    "b_eq_d": [(6, 6, (2, 128), 0, "add"), (4, 4, (9,), 2, "max")],
    "odd_l": [(9, 3, (1001,), 4, "add"), (9, 2, (7, 3), 5, "max")],
    "one_add": [(7, 3, (4, 128), 2, "add")],
    "one_max_odd": [(8, 8, (5,), 3, "max")],
}


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_plain_group_matches_single_pushes_and_jax(name):
    group = _group(len(name), GROUPS[name])
    for t in (0, 4, 12, 2499):  # incl. wraparound of t+lo+b past D
        items = _torch_items(group)
        tring.ring_push_group(items, torch.tensor(t, dtype=torch.int32))
        for (got, *_), (r, lo, c, op) in zip(items, group):
            single = torch.from_numpy(r.copy())
            tkernel.push_plain(single, torch.tensor(t, dtype=torch.int32), lo,
                               torch.from_numpy(c), op)
            np.testing.assert_array_equal(got.numpy(), single.numpy())
            np.testing.assert_array_equal(got.numpy(), _jax_push(r, t, lo, c, op))


def test_plan_block_prefixes_and_paths():
    items = _torch_items(_group(0, [(7, 3, (4, 1024), 1, "add"),  # L = 2 blocks
                                    (5, 2, (1000,), 0, "max"),    # 1 block
                                    (9, 4, (EPB + 1,), 2, "add"),  # odd L, 2 blocks
                                    (6, 0, (4, 4), 3, "add"),      # empty: no descriptor
                                    (4, 1, (EPB,), 0, "max")]))    # exactly 1 block
    plan = tkernel.plan_group(items)
    assert plan.first_block == (0, 6, 8, 16)
    assert plan.blocks == 17
    assert plan.vec == (True, True, False, True)
    ops = [d[6] for d in plan.descs]
    assert ops == [0, 1, 0, 1]
    assert [d[2] for d in plan.descs] == [4096, 1000, EPB + 1, EPB]  # L
    assert [d[8] for d in plan.descs] == [2, 1, 2, 1]                # chunks
    assert plan.descs[0][:2] == (items[0][0].data_ptr(), items[0][2].data_ptr())


def test_plan_takes_the_scalar_path_for_a_misaligned_view():
    base = torch.zeros(3 * 64 + 1, dtype=torch.int32)
    view = base[1:].view(3, 64)  # contiguous, 4 bytes past a 16-byte boundary
    ring = torch.zeros((5, 64), dtype=torch.int32)
    assert tkernel.plan_group([(ring, 0, view, "add")]).vec == (False,)
    assert tkernel.plan_group([(ring, 0, view.clone(), "add")]).vec == (True,)


def _refusal(kind):
    ring = torch.zeros((6, 32), dtype=torch.int32)
    other = torch.zeros((6, 32), dtype=torch.int32)
    c = torch.ones((2, 32), dtype=torch.int32)
    if kind == "shared_ring":
        return [(ring, 0, c, "add"), (ring, 3, c, "max")]
    if kind == "ring_view":  # two views of one ring, overlapping rows
        return [(ring[:4], 0, c, "add"), (ring[2:], 0, c, "add")]
    if kind == "contrib_in_own_ring":
        return [(ring, 0, ring[:2], "add")]
    if kind == "contrib_in_other_ring":
        return [(ring, 0, c, "add"), (other, 0, ring[1:3], "max")]
    if kind == "over_cap":
        return [(torch.zeros((3, 4), dtype=torch.int32), 0, c[:, :4], "add")
                for _ in range(tkernel.MAX_MEMBERS + 1)]
    if kind == "mixed_devices":
        return [(ring, 0, c, "add"),
                (other, 0, torch.ones((2, 32), dtype=torch.int32, device="meta"), "add")]
    raise AssertionError(kind)


REFUSALS = {"shared_ring": "share ring storage", "ring_view": "share ring storage",
            "contrib_in_own_ring": "overlap", "contrib_in_other_ring": "overlap",
            "over_cap": "at most", "mixed_devices": "one device"}


@pytest.mark.parametrize("kind", sorted(REFUSALS))
def test_group_refusals(kind):
    with pytest.raises(ValueError, match=REFUSALS[kind]):
        tkernel.plan_group(_refusal(kind))
    if kind != "mixed_devices":  # the plain path refuses the same groups
        with pytest.raises(ValueError, match=REFUSALS[kind]):
            tkernel.push_group_plain(_refusal(kind), torch.tensor(0, dtype=torch.int32))


def test_contributions_may_share_memory():
    zeros = torch.zeros((3, 4, 8), dtype=torch.int32)
    items = [(torch.ones((7, 4, 8), dtype=torch.int32), 1, zeros, "add"),
             (torch.ones((7, 4, 8), dtype=torch.int32), 2, zeros, "max")]
    assert len(tkernel.plan_group(items).descs) == 2
    tring.ring_push_group(items, torch.tensor(3, dtype=torch.int32))
    assert all(bool((r == 1).all()) for r, *_ in items)


def test_group_refuses_strided_tensors_on_both_paths():
    ring = torch.zeros((5, 4, 2), dtype=torch.int32)
    strided = torch.arange(24, dtype=torch.int32).reshape(3, 2, 4).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tkernel.plan_group([(ring, 1, strided, "add")])
    with pytest.raises(ValueError, match="contiguous"):
        tring.ring_push_group([(ring, 1, strided, "add")], torch.tensor(0, dtype=torch.int32))


def test_cpu_group_counts_nothing_and_kernel_wrapper_refuses_cpu():
    items = _torch_items(_group(3, GROUPS["pbft_tick"]))
    t = torch.tensor(5, dtype=torch.int32)
    before = (tkernel.launches, tkernel.pushes)
    tring.ring_push_group(items, t)
    assert (tkernel.launches, tkernel.pushes) == before
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.fused_push_group(items, t)


def test_pbft_step_makes_one_group_call_per_tick(monkeypatch):
    """At n = 8 every tick hands its four pushes (prep_rt, commit, pp, vc) to
    ONE group call, at the offsets and with the ops of the JAX package's four
    single pushes, and the run still equals the one without recording."""
    cfg = SimConfig(protocol="pbft", n=8, sim_ms=300)
    calls = []
    real = tpbft.ring_push_group

    def record(items, t):
        calls.append(([(tuple(r.shape), lo, tuple(c.shape), op) for r, lo, c, op in items],
                      int(t)))
        return real(items, t)

    monkeypatch.setattr(tpbft, "ring_push_group", record)
    recorded = runner.run_simulation(cfg, device="cpu")
    monkeypatch.undo()
    assert recorded == runner.run_simulation(cfg, device="cpu")
    assert [t for _, t in calls] == list(range(cfg.ticks))
    n, w, d = cfg.n, cfg.pbft_max_slots, cfg.ring_depth
    lo, hi = cfg.one_way_range()
    rt_lo, rt_hi = cfg.roundtrip_range()
    ser = cfg.serialization_ticks(cfg.pbft_block_bytes)
    want = [((d, n, w), rt_lo, (rt_hi - rt_lo, n, w), "add"),
            ((d, n, w), lo, (hi - lo, n, w), "add"),
            ((d, n, w), lo + ser, (hi - lo, n, w), "max"),
            ((d, n), lo, (hi - lo, n), "max")]
    assert all(members == want for members, _ in calls)


# ---- on the card ----------------------------------------------------------

N1000 = [(152, 5, (1000, 64), 12, "add"), (152, 3, (1000, 64), 6, "add"),
         (152, 3, (1000, 64), 26, "max"), (152, 3, (1000,), 6, "max")]


@pytest.mark.cuda
@pytest.mark.parametrize("members", [N1000, [(152, 3, (1001,), 5, "max")],
                                     [(152, 152, (1000,), 0, "add")]],
                         ids=["n1000_tick_vec", "ragged_scalar", "b_eq_d"])
def test_cuda_group_matches_plain(cuda_device, members):
    group = _group(len(members), members)
    for t in (0, 7, 151, 2499):
        tt = torch.tensor(t, dtype=torch.int32, device=cuda_device)
        got = _torch_items(group, cuda_device)
        before = (tkernel.launches, tkernel.pushes)
        tkernel.push_group(got, tt)
        assert (tkernel.launches, tkernel.pushes) == (before[0] + 1, before[1] + len(members))
        want = _torch_items(group, cuda_device)
        tkernel.push_group_plain(want, tt)
        torch.cuda.synchronize()
        assert all(torch.equal(g[0], w[0]) for g, w in zip(got, want))


@pytest.mark.cuda
def test_cuda_group_on_the_scalar_path_for_a_misaligned_view(cuda_device):
    ring = torch.randint(-99, 99, (152, 1000, 64), dtype=torch.int32, device=cuda_device)
    view = torch.randint(-99, 99, (3 * 64000 + 1,), dtype=torch.int32,
                         device=cuda_device)[1:].view(3, 1000, 64)
    assert tkernel.plan_group([(ring, 6, view, "add")]).vec == (False,)
    tt = torch.tensor(2499, dtype=torch.int32, device=cuda_device)
    got = tkernel.fused_push(ring.clone(), tt, 6, view, "add")
    want = tkernel.push_plain(ring.clone(), tt, 6, view, "add")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_graph_replay_equals_eager_launch(cuda_device):
    group = _group(1, N1000)
    tt = torch.tensor(2499, dtype=torch.int32, device=cuda_device)
    eager = _torch_items(group, cuda_device)
    tkernel.fused_push_group(eager, tt)
    replayed = _torch_items(group, cuda_device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tkernel.fused_push_group(replayed, tt)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a[0], b[0]) for a, b in zip(eager, replayed))
