"""Queued links in the port (ns-3's serial-pipe transport), held bit for bit
to the JAX package.

With ``queued_links=True`` a leader's block or proposal reaches each
destination through a per-destination serial pipe: it waits for the link to
free, occupies it for its serialization time, then propagates.  PBFT keeps
the in-flight blocks in per-destination FIFOs (``ppq_tick`` / ``ppq_val``)
and enqueues each into the lowest free slot; Raft lands its deliveries on
the rings at per-destination offsets.  Each case runs the same config and
seed in both packages and compares the metrics and every final-state field;
the FIFO cases end while blocks are still queued, so the slot each block
took is compared too.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from blockchain_simulator_tpu import runner as jrunner
from blockchain_simulator_tpu_torch import convert
from blockchain_simulator_tpu_torch import runner as trunner
from blockchain_simulator_tpu_torch.models import pbft as tpbft
from blockchain_simulator_tpu_torch.utils import prng as tprng
from blockchain_simulator_tpu_torch.utils import threefry
from test_torch_pbft import (  # noqa: F401 (release_jax_executables: autouse)
    _assert_leaves_equal, _cfgs, _jax_leaves, release_jax_executables,
)

RUNS = {
    "pbft_n8": dict(protocol="pbft", n=8, sim_ms=1500, pbft_max_rounds=12),
    "pbft_n8_crashed": dict(protocol="pbft", n=8, sim_ms=1200, pbft_max_rounds=8,
                            faults=dict(n_crashed=2)),
    "raft_n8": dict(protocol="raft", n=8, sim_ms=1500, raft_proposal_delay_ms=300),
    "raft_n8_byzantine_stat": dict(protocol="raft", n=8, sim_ms=1200, delivery="stat",
                                   raft_proposal_delay_ms=300, faults=dict(n_byzantine=1)),
}


def _run_both(**kw):
    jcfg, tcfg = _cfgs(queued_links=True, faults=kw.pop("faults", None), **kw)
    jfinal = jrunner.final_state(jcfg)
    tfinal = trunner.final_state(tcfg, device="cpu")
    assert trunner.sim_metrics(tcfg, tfinal) == jrunner.base_model.sim_metrics(jcfg, jfinal)
    _assert_leaves_equal(_jax_leaves(jfinal), convert.state_to_numpy(tfinal))
    return tcfg


@pytest.mark.parametrize("name", sorted(RUNS))
def test_queued_run_equals_jax(name):
    _run_both(**RUNS[name])


def _fifo_trace(tcfg):
    """The port's PBFT run, tick by tick: per tick, the occupied FIFO slots
    of every destination ([ticks, N, Q] bool)."""
    key = threefry.key(tcfg.seed)
    state, bufs = tpbft.init(tcfg, threefry.fold_in(key, trunner._INIT_FOLD), device="cpu")
    occupied = []
    for t in range(tcfg.ticks):
        state, bufs = tpbft.step(tcfg, state, bufs, torch.tensor(t, dtype=torch.int32),
                                 tprng.tick_key(key, t))
        occupied.append((state.ppq_tick != tpbft._NEVER).numpy())
    return np.stack(occupied)


def test_pbft_fifo_fills():
    """Blocks every 10 ms, 27 ms to serialize each at n = 8: the backlog
    grows until a destination holds Q = 6 blocks (every slot occupied), and
    the run ends with them still queued."""
    tcfg = _run_both(protocol="pbft", n=8, sim_ms=85, pbft_block_interval_ms=10,
                     pbft_max_rounds=6)
    q = tpbft.queue_len(tcfg)
    assert q == 6
    occ = _fifo_trace(tcfg)
    assert occ[-1].sum(1).max() == q  # some destination holds Q blocks


def test_pbft_fifo_reuses_the_lowest_free_slot():
    """A delivery frees slot 0 while later slots stay occupied; the next
    block must take slot 0 (the lowest free index), as in the JAX package."""
    tcfg = _run_both(protocol="pbft", n=8, sim_ms=260, pbft_block_interval_ms=30,
                     pbft_max_rounds=10)
    occ = _fifo_trace(tcfg)
    # some tick refills slot 0 while a higher slot is still occupied
    refill = ~occ[:-1, :, 0] & occ[1:, :, 0] & occ[:-1, :, 1:].any(2)
    assert refill.any()
