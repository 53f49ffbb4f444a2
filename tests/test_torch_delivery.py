"""The port's edge delivery and delay samplers against their JAX twins.

Each function gets the same inputs (made with numpy from a seed) and the same
threefry key in both packages; the outputs must be equal, bit for bit, at
n in {8, 33} with drops off and on.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockchain_simulator_tpu.ops import delay as jdelay
from blockchain_simulator_tpu.ops import delivery as jdv
from blockchain_simulator_tpu_torch.ops import delay as tdelay
from blockchain_simulator_tpu_torch.ops import delivery as tdv
from blockchain_simulator_tpu_torch.utils import threefry
from test_torch_pbft import release_jax_executables  # noqa: F401 (autouse fixture)

LO, HI = 6, 9  # the PBFT one-way range at the package defaults
CASES = [(n, drop) for n in (8, 33) for drop in (0.0, 0.1)]


def _keys(seed):
    return jax.random.key(seed), threefry.key(seed)


def _eq(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _mask(rng, n, p=0.4):
    m = rng.random(n) < p
    m[0] = True
    return m


def test_probs_match():
    for lo, hi in ((6, 9), (3, 4), (1, 51)):
        np.testing.assert_array_equal(tdelay.uniform_probs(lo, hi), jdelay.uniform_probs(lo, hi))
        np.testing.assert_array_equal(tdelay.roundtrip_probs(lo, hi),
                                      jdelay.roundtrip_probs(lo, hi))


@pytest.mark.parametrize("shape", [(5,), (8, 8), (33, 33)])
def test_sample_edge_delays(shape):
    jk, tk = _keys(4)
    _eq(tdelay.sample_edge_delays(tk, shape, LO, HI, "cpu"),
        jdelay.sample_edge_delays(jk, shape, LO, HI))


def test_rbg_sampler_is_a_later_slice():
    """The rbg stream came with slice 2 (utils/philox.py): it now equals
    JAX's instead of raising (tests/test_torch_philox.py holds more spans)."""
    jk, tk = _keys(0)
    for shape in ((4,), (33, 33)):
        _eq(tdelay.sample_edge_delays(tk, shape, LO, HI, "cpu", impl="rbg"),
            jax.jit(lambda k: jdelay.sample_edge_delays(k, shape, LO, HI, "rbg"))(jk))


def test_ids_and_bucket_iota():
    _eq(tdv._global_ids(9, None, "cpu"), jdv._global_ids(9, None))
    _eq(tdv._bucket_iota(LO, HI, 2, "cpu"), jdv._bucket_iota(LO, HI, 2))
    # a mesh axis is bound only inside a sharded body (parallel/partition.py)
    with pytest.raises(RuntimeError, match="not bound"):
        tdv._global_ids(9, "nodes", "cpu")


@pytest.mark.parametrize("n, drop", CASES)
def test_edge_hits(n, drop):
    rng = np.random.default_rng(n)
    send = _mask(rng, n)
    jk, tk = _keys(n + 1)
    _eq(tdv._edge_hits(tk, torch.from_numpy(send), LO, HI, drop),
        jdv._edge_hits(jk, jnp.asarray(send), LO, HI, drop))


@pytest.mark.parametrize("n, drop", CASES)
def test_bcast_value_max_dense(n, drop):
    rng = np.random.default_rng(10 + n)
    send = _mask(rng, n, 0.2)
    value = (rng.integers(1, 5000, n) * send).astype(np.int32)
    jk, tk = _keys(2)
    _eq(tdv.bcast_value_max_dense(tk, torch.from_numpy(send), torch.from_numpy(value),
                                  LO, HI, drop),
        jdv.bcast_value_max_dense(jk, jnp.asarray(send), jnp.asarray(value), LO, HI, drop))


@pytest.mark.parametrize("n, drop", CASES)
def test_bcast_slots_dense(n, drop):
    rng = np.random.default_rng(20 + n)
    s = 12
    slot_mat = (rng.random((n, s)) < 0.15).astype(np.int32)
    slot_mat[-1, s - 1] = 5  # a Byzantine flood: several copies per send
    jk, tk = _keys(3)
    _eq(tdv.bcast_slots_dense(tk, torch.from_numpy(slot_mat), LO, HI, drop),
        jdv.bcast_slots_dense(jk, jnp.asarray(slot_mat), LO, HI, drop))


@pytest.mark.parametrize("n, drop", CASES)
def test_bcast_window_value_max_dense(n, drop):
    rng = np.random.default_rng(30 + n)
    w = 9
    value_mat = np.zeros((n, w), np.int32)
    value_mat[0, 4] = 17  # the leader's block, as in PBFT
    value_mat[n // 2, rng.integers(0, w)] = rng.integers(1, 99)
    jk, tk = _keys(5)
    _eq(tdv.bcast_window_value_max_dense(tk, torch.from_numpy(value_mat), LO, HI, drop),
        jdv.bcast_window_value_max_dense(jk, jnp.asarray(value_mat), LO, HI, drop))


@pytest.mark.parametrize("n, drop", CASES)
def test_roundtrip_reply_counts_dense(n, drop):
    rng = np.random.default_rng(40 + n)
    send = _mask(rng, n, 0.5)
    peers = _mask(rng, n, 0.8)
    jk, tk = _keys(6)
    _eq(tdv.roundtrip_reply_counts_dense(tk, torch.from_numpy(send), LO, HI, drop,
                                         peer_mask=torch.from_numpy(peers)),
        jdv.roundtrip_reply_counts_dense(jk, jnp.asarray(send), LO, HI, drop,
                                         peer_mask=jnp.asarray(peers)))
    _eq(tdv.roundtrip_reply_counts_dense(tk, torch.from_numpy(send), LO, HI, drop),
        jdv.roundtrip_reply_counts_dense(jk, jnp.asarray(send), LO, HI, drop))


# Raft's edge arm: the three dense helpers it alone calls (raft one-way range)
RAFT_LO, RAFT_HI = 3, 6


@pytest.mark.parametrize("n, drop", CASES)
def test_bcast_counts_dense(n, drop):
    rng = np.random.default_rng(50 + n)
    send = _mask(rng, n, 0.1)
    jk, tk = _keys(7)
    _eq(tdv.bcast_counts_dense(tk, torch.from_numpy(send), RAFT_LO, RAFT_HI, drop),
        jdv.bcast_counts_dense(jk, jnp.asarray(send), RAFT_LO, RAFT_HI, drop))


@pytest.mark.parametrize("n, drop", CASES)
def test_unicast_reply_counts_dense(n, drop):
    rng = np.random.default_rng(60 + n)
    # one-hot grants plus a few denial rows, as Raft's vote wires carry them
    reply = np.zeros((n, n), np.int32)
    reply[np.arange(n), rng.integers(0, n, n)] = rng.random(n) < 0.6
    reply[: n // 3] += (rng.random((n // 3, n)) < 0.2).astype(np.int32)
    jk, tk = _keys(8)
    _eq(tdv.unicast_reply_counts_dense(tk, torch.from_numpy(reply), RAFT_LO, RAFT_HI, drop),
        jdv.unicast_reply_counts_dense(jk, jnp.asarray(reply), RAFT_LO, RAFT_HI, drop))


@pytest.mark.parametrize("n, drop", CASES)
def test_bcast_matrix_dense(n, drop):
    rng = np.random.default_rng(70 + n)
    send = _mask(rng, n, 0.15)
    value = send.astype(np.int32) * rng.integers(1, 9, n).astype(np.int32)
    jk, tk = _keys(9)
    got = tdv.bcast_matrix_dense(tk, torch.from_numpy(send), torch.from_numpy(value),
                                 RAFT_LO, RAFT_HI, drop)
    assert got.is_contiguous()  # the ring push takes contiguous contributions
    _eq(got, jdv.bcast_matrix_dense(jk, jnp.asarray(send), jnp.asarray(value),
                                    RAFT_LO, RAFT_HI, drop))


def test_dense_helpers_refuse_a_mesh_axis():
    """A mesh axis is bound only inside a sharded body (parallel/
    partition.partition; the sharded arms are tests/test_torch_shard.py's):
    outside one, naming it raises."""
    send = torch.ones(4, dtype=torch.bool)
    tk = threefry.key(0)
    with pytest.raises(RuntimeError, match="not bound"):
        tdv.bcast_counts_dense(tk, send, RAFT_LO, RAFT_HI, axis="nodes")
    with pytest.raises(RuntimeError, match="not bound"):
        tdv.unicast_reply_counts_dense(tk, torch.ones((4, 4), dtype=torch.int32),
                                       RAFT_LO, RAFT_HI, axis="nodes")
    with pytest.raises(RuntimeError, match="not bound"):
        tdv.bcast_matrix_dense(tk, send, send.to(torch.int32), RAFT_LO, RAFT_HI,
                               axis="nodes")
