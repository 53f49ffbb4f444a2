"""The port's ring buffers and ring-push kernel.

On the CPU the push takes its plain version, held here against the JAX
package's DUS chain (``ops/ring._push``) and its Pallas kernel run in
interpret mode (``ring_kernel.fused_push(..., interpret=True)``), as
tests/test_ops.py runs it.  The CUDA kernel itself runs only on the card:
its cases are marked ``cuda`` and skip without one (this file imports no JAX
model code, so it also runs where jax is installed without flax);
``chip_smoke.py`` holds the kernel against the plain version at the PBFT
tick engine's n = 1000 shapes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockchain_simulator_tpu.ops import ring as jring
from blockchain_simulator_tpu.ops import ring_kernel as jkernel
from blockchain_simulator_tpu_torch import convert, runner
from blockchain_simulator_tpu_torch.ops import ring as tring
from blockchain_simulator_tpu_torch.ops import ring_kernel as tkernel
from blockchain_simulator_tpu_torch.utils.config import FaultConfig, SimConfig


@pytest.fixture
def cuda_device():
    # decided here, never at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the H100: JAX_PLATFORMS=cpu "
                    "python -m pytest tests/test_torch_ring.py -m cuda")
    return "cuda"


def _case(seed, d, b, rest):
    rng = np.random.default_rng(seed)
    buf = rng.integers(-1000, 1000, (d, *rest), dtype=np.int32)
    contrib = rng.integers(-1000, 1000, (b, *rest), dtype=np.int32)
    return buf, contrib


def _port_push(buf, t, lo, contrib, op):
    tb = torch.from_numpy(buf.copy())
    fn = tring.ring_push_add if op == "add" else tring.ring_push_max
    out = fn(tb, torch.tensor(t, dtype=torch.int32), lo, torch.from_numpy(contrib))
    assert out is tb  # in place
    return out.numpy()


def _jax_push(buf, t, lo, contrib, op):
    fn = jring.ring_push_add if op == "add" else jring.ring_push_max
    return np.asarray(fn(jnp.asarray(buf), jnp.int32(t), lo, jnp.asarray(contrib)))


# (D, B, rest): the PBFT tick engine's pushes at small n, B = D, a ragged L
SHAPES = [(7, 3, (4, 128)), (9, 5, (8, 64)), (6, 6, (2, 128)), (11, 3, (1000,)),
          (5, 2, (3, 7, 5))]


@pytest.mark.parametrize("op", ["add", "max"])
@pytest.mark.parametrize("d, b, rest", SHAPES)
def test_plain_push_matches_jax_dus_chain(d, b, rest, op):
    buf, contrib = _case(d * 31 + b, d, b, rest)
    for t in (0, 3, d - 1, d, 4 * d + 2, 2499):  # incl. wraparound of t+lo+b
        for lo in (0, 2, d - b):
            np.testing.assert_array_equal(_port_push(buf, t, lo, contrib, op),
                                          _jax_push(buf, t, lo, contrib, op))


@pytest.mark.parametrize("op", ["add", "max"])
@pytest.mark.parametrize("d, b, rest", [s for s in SHAPES
                                        if int(np.prod(s[2])) % 128 == 0])
def test_plain_push_matches_pallas_interpret(d, b, rest, op):
    buf, contrib = _case(d * 7 + b, d, b, rest)
    assert jkernel.pushable(jnp.asarray(buf), jnp.asarray(contrib))
    for t in (0, 5, d + 3, 123):
        want = np.asarray(jkernel.fused_push(jnp.asarray(buf), jnp.int32(t), 2,
                                             jnp.asarray(contrib), op, interpret=True))
        np.testing.assert_array_equal(_port_push(buf, t, 2, contrib, op), want)


def test_untouched_slices_survive():
    buf = np.arange(6 * 256, dtype=np.int32).reshape(6, 256)
    got = _port_push(buf, 1, 1, np.ones((2, 256), np.int32), "add")
    np.testing.assert_array_equal(got[[0, 1, 4, 5]], buf[[0, 1, 4, 5]])
    np.testing.assert_array_equal(got[[2, 3]], buf[[2, 3]] + 1)


def test_int32_add_wraps_like_jax():
    buf = np.full((3, 4), 2**31 - 1, np.int32)
    contrib = np.ones((1, 4), np.int32)
    np.testing.assert_array_equal(_port_push(buf, 0, 0, contrib, "add"),
                                  _jax_push(buf, 0, 0, contrib, "add"))


@pytest.mark.parametrize("t", [0, 4, 5, 152, 2499])
def test_ring_pop_matches_jax(t):
    buf, _ = _case(t, 5, 1, (3, 4))
    want_cur, want_buf = jring.ring_pop(jnp.asarray(buf), jnp.int32(t))
    tb = torch.from_numpy(buf.copy())
    cur, out = tring.ring_pop(tb, torch.tensor(t, dtype=torch.int32))
    assert out is tb
    np.testing.assert_array_equal(cur.numpy(), np.asarray(want_cur))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_buf))


def test_cpu_push_takes_the_plain_version_and_counts_nothing():
    before = tkernel.launches
    buf, contrib = _case(0, 5, 2, (16,))
    _port_push(buf, 3, 1, contrib, "max")
    assert tkernel.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    buf = torch.zeros((5, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.fused_push(buf, torch.tensor(0, dtype=torch.int32), 1,
                           torch.zeros((2, 8), dtype=torch.int32), "add")


@pytest.mark.parametrize("bad, exc", [
    (dict(contrib=torch.zeros((2, 8), dtype=torch.int64)), TypeError),
    (dict(contrib=torch.zeros((2, 9), dtype=torch.int32)), ValueError),
    (dict(contrib=torch.zeros((6, 8), dtype=torch.int32)), ValueError),
    (dict(op="min"), ValueError),
    (dict(t=torch.zeros(2, dtype=torch.int32)), TypeError),
])
def test_push_checks_its_arguments(bad, exc):
    args = dict(buf=torch.zeros((5, 8), dtype=torch.int32),
                t=torch.tensor(0, dtype=torch.int32), lo=1,
                contrib=torch.zeros((2, 8), dtype=torch.int32), op="add")
    args.update(bad)
    with pytest.raises(exc):
        tkernel.push(**args)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["add", "max"])
def test_cuda_kernel_matches_plain(cuda_device, op):
    for d, b, rest in SHAPES + [(152, 5, (1000, 64)), (152, 152, (1000,))]:
        buf, contrib = _case(d + b, d, b, rest)
        c = torch.from_numpy(contrib).to(cuda_device)
        for t in (0, d - 1, 2499):
            tt = torch.tensor(t, dtype=torch.int32, device=cuda_device)
            before = tkernel.launches
            got = tkernel.push(torch.from_numpy(buf).to(cuda_device), tt, 3 % d, c, op)
            assert tkernel.launches == before + 1
            want = tkernel.push_plain(torch.from_numpy(buf).to(cuda_device), tt, 3 % d, c, op)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_engine_run_equals_cpu_run(cuda_device):
    """The tick engine with every push through the kernel equals the plain
    path, field for field (drops on, so every gate and channel fires)."""
    cfg = SimConfig(protocol="pbft", n=64, sim_ms=800, faults=FaultConfig(drop_prob=0.05))
    tkernel.launches = tkernel.pushes = 0
    on_card = convert.state_to_numpy(runner.final_state(cfg, device=cuda_device))
    assert (tkernel.launches, tkernel.pushes) == (cfg.ticks, 4 * cfg.ticks)
    on_cpu = convert.state_to_numpy(runner.final_state(cfg, device="cpu"))
    for k in on_cpu:
        np.testing.assert_array_equal(on_card[k], on_cpu[k], err_msg=k)
