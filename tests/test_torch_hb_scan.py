"""The port's heartbeat scan over a shard axis, held to ``jax.vmap`` of the
JAX package's ``raft_hb.steady_scan``.

Four synthetic shards (``Handoff``s at different heartbeat phases and
setProposal ticks, one that never proposes inside the window, one that
starts part-way through its blocks) go through
``jax.vmap(lambda k, h: raft_hb.steady_scan(cfg, k, h))`` and through the
port's ``steady_scan`` on the CPU, each shard on its own key; every output
must be equal.  Both stat samplers are held: under ``vmap`` the ``"normal"``
sampler draws every shard's Gaussian words from the FIRST shard's key (the
batching rule of ``rng_bit_generator``), which the ``"normal"`` cases pin;
the ``"exact"`` cases pin the per-shard rejection loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockchain_simulator_tpu.models import raft_hb as jhb
from blockchain_simulator_tpu.utils import config as jconfig
from blockchain_simulator_tpu_torch.models import raft_hb as thb
from blockchain_simulator_tpu_torch.ops import delay as tdelay
from blockchain_simulator_tpu_torch.utils import config as tconfig
from test_torch_pbft import release_jax_executables  # noqa: F401 (autouse fixture)

BASE = dict(protocol="raft", n=16, sim_ms=2000, delivery="stat", schedule="round")
B = 50  # raft_max_blocks at the defaults
# per shard: hb0, p_start, bn0, rnd0, ok_cnt; shard 2 never proposes in the
# window, shard 3 starts with 45 blocks committed and runs into the caps
SHARDS = [
    (341, 400, 0, 0, 15.0),
    (322, 655, 0, 0, 9.0),
    (360, 10_000, 0, 0, 15.0),
    (330, 330, 45, 45, 12.0),
]


@pytest.fixture(scope="module")
def shards():
    """The four shards' keys (JAX keys and their host words) and
    ``Handoff``s in both packages, built once for every case of the file."""
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(7), i))(jnp.arange(4))
    return (keys, np.asarray(jax.random.key_data(keys), np.int64)) + _handoffs()


def _handoffs():
    hb0, p_start, bn0, rnd0, ok_cnt = (np.array(c) for c in zip(*SHARDS))
    bt0 = np.full((len(SHARDS), B), -1, np.int32)
    bt0[3, :45] = np.arange(45, dtype=np.int32) * 50 + 100
    jh = jhb.Handoff(lead=jnp.arange(len(SHARDS), dtype=jnp.int32) + 3,
                     hb0=jnp.asarray(hb0, jnp.int32), p_start=jnp.asarray(p_start, jnp.int32),
                     bn0=jnp.asarray(bn0, jnp.int32), rnd0=jnp.asarray(rnd0, jnp.int32),
                     bt0=jnp.asarray(bt0), ok_cnt=jnp.asarray(ok_cnt, jnp.float32))
    th = thb.Handoff(lead=torch.arange(len(SHARDS), dtype=torch.int32) + 3,
                     hb0=hb0.astype(np.int64),
                     p_start=torch.tensor(p_start, dtype=torch.int32),
                     bn0=torch.tensor(bn0, dtype=torch.int32),
                     rnd0=torch.tensor(rnd0, dtype=torch.int32),
                     bt0=torch.tensor(bt0), ok_cnt=torch.tensor(ok_cnt, dtype=torch.float32))
    return jh, th


@pytest.mark.parametrize("serialization", [True, False])
@pytest.mark.parametrize("sampler", ["exact", "normal"])
def test_scan_over_shards_equals_jax_vmap(shards, sampler, serialization):
    kw = dict(BASE, stat_sampler=sampler, model_serialization=serialization)
    jcfg, tcfg = jconfig.SimConfig(**kw), tconfig.SimConfig(**kw)
    assert thb.eligible(tcfg) and tcfg.eff_stat_sampler == sampler
    keys, key_words, jh, th = shards
    want = jax.jit(jax.vmap(lambda k, h: jhb.steady_scan(jcfg, k, h)))(keys, jh)
    got = thb.steady_scan(tcfg, key_words, th)
    names = ("hs", "open_", "bn", "rnd", "add_on", "stopped", "bt")
    for name, w, g in zip(names, want, got):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    bn, rnd = np.asarray(want[2]), np.asarray(want[3])
    assert bn[0] > 0 and bn[2] == 0 and rnd[2] == 0  # proposing and idle shards
    # the shard that starts at 45 blocks runs into the round cap
    assert rnd[3] == tcfg.raft_max_rounds and bn[3] >= B - 1
    assert not bool(np.asarray(want[4])[3])  # add_change_value cleared


def test_vmapped_normal_draws_come_from_the_first_lane(shards):
    """What the lane-0 rule means: under vmap, lane w of the "normal"
    sampler is NOT what lane w's key gives alone (W > 1); lane 0 is."""
    probs = tdelay.roundtrip_probs(3, 53)
    kd = shards[1][:3]
    n = torch.full((1, 3), 60.0)
    got = tdelay.sample_bucket_counts_vmapped(kd[None], n, probs, "normal")[:, 0]
    alone = [tdelay.sample_bucket_counts(kd[w], torch.tensor(60.0), probs, "normal")
             for w in range(3)]
    assert torch.equal(got[:, 0], alone[0])
    assert not torch.equal(got[:, 1], alone[1])
    exact = tdelay.sample_bucket_counts_vmapped(kd[None], n, probs, "exact")[:, 0]
    for w in range(3):
        assert torch.equal(exact[:, w], tdelay.sample_bucket_counts(
            kd[w], torch.tensor(60.0), probs, "exact"))
