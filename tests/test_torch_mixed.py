"""The PyTorch port's mixed shard sim, held bit for bit to the JAX package.

Each whole-run case goes through the JAX package and through the port on
the CPU (``device="cpu"``: the plain versions), and compares the metrics and
every final-state field: the fast path (the election prefix, the handoff in
every shard, the ``[S]`` heartbeat scan and the per-tick PBFT layer), the
same config on the tick engine (whose metrics JAX's equal the fast path's),
edge delivery, a crash config in which every handoff is refused and the
tick engine continues from the prefix carry, and the ``"normal"`` sampler on
the tick engine (the first-lane rule of vmapped Philox draws, in the
per-tick step).  The JAX side of each case is computed once a process (the
``runs`` fixture), and no case reads another's.  Beside them: a
mid-run state carried across with ``convert``, the lane-key delivery
helpers against ``jax.vmap`` of the JAX helpers, the Raft step over a shard
axis against ``jax.vmap(raft.step)`` under faults, and the refusals.

Golden file ``blockchain_simulator_tpu_torch/golden/mixed_n256k_s0.json``:
BASELINE config 5 as ``tools/run_config5.py`` builds it, at seed 0, written
by the JAX package on the CPU with ``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_mixed.py --write-golden`` (a 256,000-node run: several
minutes and a few GB).  ``chip_smoke.py`` holds the card's run to it.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockchain_simulator_tpu import runner as jrunner
from blockchain_simulator_tpu.models import mixed as jmixed
from blockchain_simulator_tpu.models import raft as jraft
from blockchain_simulator_tpu.ops import delay as jdelay
from blockchain_simulator_tpu.ops import delivery as jdv
from blockchain_simulator_tpu.utils import prng as jprng
from blockchain_simulator_tpu_torch import convert
from blockchain_simulator_tpu_torch import runner as trunner
from blockchain_simulator_tpu_torch.models import mixed as tmixed
from blockchain_simulator_tpu_torch.models import pbft as tpbft
from blockchain_simulator_tpu_torch.models import raft as traft
from blockchain_simulator_tpu_torch.ops import delay as tdelay
from blockchain_simulator_tpu_torch.ops import delivery as tdv
from blockchain_simulator_tpu_torch.utils import threefry
from test_torch_pbft import (  # noqa: F401 (release_jax_executables: autouse)
    _assert_leaves_equal, _cfgs, release_jax_executables,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "blockchain_simulator_tpu_torch" / "golden" / "mixed_n256k_s0.json"
WRITTEN_BY = "PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_mixed.py --write-golden"
# BASELINE config 5, field for field as tools/run_config5.py builds it
CONFIG5 = dict(protocol="mixed", n=256_000, mixed_shards=256, sim_ms=3000,
               delivery="stat", model_serialization=False)

BASE = dict(protocol="mixed", n=48, mixed_shards=8)
STAT = dict(BASE, delivery="stat", model_serialization=False)
CASES = {
    # the verify skill's milestone: 8 shards with leaders, 40/40 global
    "fast": dict(STAT, sim_ms=3000),
    "tick": dict(STAT, sim_ms=3000, schedule="tick"),
    "edge": dict(BASE, sim_ms=1500),
    # a crashed majority in every shard: no shard elects, every handoff fails
    "crash": dict(STAT, sim_ms=1500, faults=dict(n_crashed=4)),
    # 400 ms covers the prefix's elections on the Philox draws
    "normal_tick": dict(STAT, sim_ms=400, schedule="tick", stat_sampler="normal"),
}
# the milestone (JAX's metrics at seed 0), which the fast path and the tick
# engine both reach, so (b) equals (a) without either run reading the other
MILESTONE = {"protocol": "mixed", "n": 48, "shards": 8, "shard_size": 6,
             "shards_with_leader": 8, "raft_blocks_total": 295, "raft_blocks_min": 36,
             "global_blocks_final": 40, "global_rounds_sent": 40,
             "global_mean_ttf_ms": 29.35, "agreement_ok": True}
EXPECT = {
    "fast": lambda m: m == MILESTONE,
    "tick": lambda m: m == MILESTONE,
    "crash": lambda m: (m["shards_with_leader"], m["global_blocks_final"]) == (0, 0),
}


def _leaves(state) -> dict:
    """``"raft.<field>"`` / ``"pbft.<field>"`` numpy leaves of a mixed state
    (either package's)."""
    return {f"{part}.{f.name}": np.asarray(getattr(getattr(state, part), f.name))
            for part in ("raft", "pbft")
            for f in dataclasses.fields(getattr(state, part))}


@pytest.fixture(scope="module")
def runs():
    """``runs(case)``: the JAX package's and the port's results of one case
    (metrics and leaves), computed once a process."""
    memo = {}

    def get(case):
        if case not in memo:
            kw = dict(CASES[case])
            jcfg, tcfg = _cfgs(faults=kw.pop("faults", None), **kw)
            jfinal = jrunner.final_state(jcfg)
            tfinal = trunner.final_state(tcfg, device="cpu")
            memo[case] = (jrunner.base_model.sim_metrics(jcfg, jfinal), _leaves(jfinal),
                          trunner.sim_metrics(tcfg, tfinal), convert.state_to_numpy(tfinal))
        return memo[case]
    return get


def golden_entry(config: dict, seed: int = 0) -> dict:
    """One golden entry, computed by the JAX package."""
    jcfg, _ = _cfgs(**config)
    final = jrunner.final_state(jcfg, seed=seed)
    rcfg, _ = jmixed.sub_configs(jcfg)
    return {
        "config": config,
        "seed": seed,
        "jax_version": jax.__version__,
        "raft_stat_sampler": rcfg.eff_stat_sampler,
        "metrics": jrunner.base_model.sim_metrics(jcfg, final),
        "state_sha256": convert.state_digests(_leaves(final)),
    }


def write_golden():
    doc = {
        "about": "JAX package (blockchain_simulator_tpu) results that the "
                 "PyTorch port must reproduce bit for bit: metrics and a sha256 "
                 "of every final-state field (blockchain_simulator_tpu_torch/"
                 "convert.state_digests; a mixed state's leaves are keyed "
                 "raft.<field> and pbft.<field>). BASELINE config 5 as "
                 "tools/run_config5.py builds it, unsharded. "
                 f"Written by: {WRITTEN_BY}",
        "entries": {"config5": golden_entry(CONFIG5)},
    }
    GOLDEN.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {GOLDEN}", flush=True)


# --------------------------------------------------------------------------- #
# whole runs                                                                  #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", list(CASES))
def test_mixed_run_equals_jax(runs, case):
    """Metrics and every final-state field equal JAX's; the fast path and
    the tick engine both reach the milestone, and the crash config elects
    nowhere and finalizes nothing."""
    jm, jl, tm, tl = runs(case)
    assert tm == jm
    _assert_leaves_equal(jl, tl)
    assert EXPECT.get(case, lambda m: True)(tm), tm


def test_crash_refuses_every_handoff():
    """Under the crash config no shard passes the handoff check, so
    ``scan_fast`` continues on the tick engine (whose final state the run
    case holds to JAX's)."""
    kw = dict(CASES["crash"])
    _, tcfg = _cfgs(faults=kw.pop("faults"), **kw)
    assert trunner.use_round_schedule(tcfg)
    key = threefry.key(0)
    state, bufs = tmixed.init(tcfg, threefry.fold_in(key, 0x1217), device="cpu")
    _, ok_all, h = tmixed.prefix_handoff(tcfg, state, bufs, key)
    assert not ok_all
    assert (h.lead.numpy() == -1).all()


def test_carried_state_steps_equal():
    """A mid-run JAX state carried across with ``convert`` (the Raft rings
    moved from JAX's ``[S, D, m]`` to slot-major ``[D, S, m]``) and stepped
    on in both packages."""
    kw = dict(protocol="mixed", n=24, mixed_shards=4, sim_ms=300)
    jcfg, tcfg = _cfgs(**kw)
    key = jax.random.key(0)

    def run(st, bf, t0, t1):
        def body(c, t):
            return jmixed.step(jcfg, *c, t, jprng.tick_key(key, t)), ()
        return jax.lax.scan(body, (st, bf), jnp.arange(t0, t1))[0]

    st, bf = jmixed.init(jcfg, jax.random.fold_in(key, 0x1217))
    st, bf = jax.jit(functools.partial(run, t0=0, t1=150))(st, bf)
    js, jb = _leaves(st), _leaves(bf)
    ts, tb = convert.state_from_numpy(tcfg, js, jb, "cpu")
    back = convert.state_to_numpy(ts, tb)
    _assert_leaves_equal(js, back[0])
    _assert_leaves_equal(jb, back[1])
    assert tuple(tb.raft.vres_ok.shape) == (jmixed.sub_configs(jcfg)[0].ring_depth, 4, 6)
    st, bf = jax.jit(functools.partial(run, t0=150, t1=230))(st, bf)
    tkeys = threefry.fold_in(threefry.key(0), np.arange(150, 230))
    for i, t in enumerate(range(150, 230)):
        ts, tb = tmixed.step(tcfg, ts, tb, torch.tensor(t, dtype=torch.int32), tkeys[i])
    _assert_leaves_equal(_leaves(st), convert.state_to_numpy(ts))
    _assert_leaves_equal(_leaves(bf), convert.state_to_numpy(ts, tb)[1])


# --------------------------------------------------------------------------- #
# the Raft step over a shard axis                                             #
# --------------------------------------------------------------------------- #

P = dict(raft_proposal_delay_ms=200)
SHARD_STEPS = {
    # edge delivery with drops and a Byzantine node in every shard
    "edge_faults": dict(n=8, sim_ms=500, faults=dict(drop_prob=0.1, n_byzantine=1), **P),
    # stat delivery, the Philox sampler, drops and Byzantine nodes: the
    # first-lane rule through the thinning and both reply chains
    "stat_normal_faults": dict(n=12, sim_ms=500, delivery="stat", stat_sampler="normal",
                               faults=dict(drop_prob=0.05, n_byzantine=2), **P),
    "reference_rbg": dict(n=8, sim_ms=400, fidelity="reference", edge_sampler="rbg", **P),
}


@pytest.mark.parametrize("name", list(SHARD_STEPS))
def test_raft_step_over_shards_equals_vmap(name):
    """``raft.init`` / ``raft.step`` on lane keys ``[S, 2]`` against
    ``jax.vmap`` of the JAX functions: every state field and ring (the rings
    compared in JAX's ``[S, D, ...]`` layout)."""
    kw = dict(SHARD_STEPS[name])
    jcfg, tcfg = _cfgs(protocol="raft", faults=kw.pop("faults", None), **kw)
    s = 3
    base = jax.random.key(5)
    shard = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(s))
    step = jax.vmap(functools.partial(jraft.step, jcfg), in_axes=(0, 0, None, 0))

    @jax.jit
    def run():
        st, bf = jax.vmap(functools.partial(jraft.init, jcfg))(shard)

        def body(c, t):
            tk = jax.vmap(lambda k: jprng.tick_key(k, t))(shard)
            return step(*c, t, tk), ()
        return jax.lax.scan(body, (st, bf), jnp.arange(jcfg.ticks))[0]

    jst, jbf = run()
    keys = np.asarray(jax.random.key_data(shard), np.int64)
    tst, tbf = traft.init(tcfg, keys, device="cpu")
    ticks = torch.arange(tcfg.ticks, dtype=torch.int32)
    tkeys = threefry.fold_in(keys[None], np.arange(tcfg.ticks)[:, None])
    for t in range(tcfg.ticks):
        tst, tbf = traft.step(tcfg, tst, tbf, ticks[t], tkeys[t])
    want = {f.name: np.asarray(getattr(jst, f.name)) for f in dataclasses.fields(jst)}
    _assert_leaves_equal(want, convert.state_to_numpy(tst))
    want = {f.name: np.asarray(getattr(jbf, f.name)) for f in dataclasses.fields(jbf)}
    got = {k: np.swapaxes(v, 0, 1) for k, v in convert.state_to_numpy(tbf).items()}
    _assert_leaves_equal(want, got)
    assert (np.asarray(jst.elections).sum(-1) > 0).all()  # every shard held elections


# --------------------------------------------------------------------------- #
# lane-key delivery helpers against jax.vmap of the JAX helpers              #
# --------------------------------------------------------------------------- #

LO, HI = 3, 6
OW = tdelay.uniform_probs(LO, HI)
RT = tdelay.roundtrip_probs(LO, HI)


def _lane_inputs(s=3, n=10, seed=2):
    rng = np.random.default_rng(seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(jnp.arange(s))
    send = rng.random((s, n)) < 0.3
    send[0] = False  # a lane with nothing to send
    counts = rng.integers(0, 40, (s, n)).astype(np.int32)
    return keys, np.asarray(jax.random.key_data(keys), np.int64), send, counts


@pytest.mark.parametrize("mode", ["exact", "normal"])
def test_lane_stat_helpers_equal_vmap(mode):
    jk, tk, send, counts = _lane_inputs()
    zero_ring = jnp.zeros((8, send.shape[1]), jnp.int32)
    t0 = jnp.int32(0)
    cases = [
        (jax.vmap(lambda k, m: jdv.push_bucket_counts(zero_ring, t0, 0, k, m, OW, mode)[:len(OW)])
         (jk, counts), tdv.push_bucket_counts(tk, torch.tensor(counts), OW, mode)),
        (jax.vmap(lambda k, s_, p: jdv.push_roundtrip_reply_counts_stat(
            zero_ring, t0, 0, k, s_, p, RT, 0.1, mode=mode)[:len(RT)])(jk, send, counts),
         tdv.push_roundtrip_reply_counts_stat(tk, torch.tensor(send), torch.tensor(counts), RT,
                                              0.1, mode=mode)),
        (jax.vmap(lambda k, m: jdelay.binom(k, m, 0.9, mode))(jk, counts),
         tdelay.binom(tk, torch.tensor(counts), 0.9, mode)),
        (jax.vmap(lambda k, s_: jdv.bcast_counts_stat(
            k, s_.sum(), s_, OW, 0.1, mode=mode))(jk, send),
         tdv.bcast_counts_stat(tk, torch.tensor(send).sum(-1, keepdim=True, dtype=torch.int32),
                               torch.tensor(send), OW, 0.1, mode=mode)),
    ]
    for i, (want, got) in enumerate(cases):
        want = np.moveaxis(np.asarray(want), 0, 1) if i != 2 else np.asarray(want)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(i))


@pytest.mark.parametrize("impl", ["threefry", "rbg"])
def test_lane_edge_helpers_equal_vmap(impl):
    jk, tk, send, counts = _lane_inputs()
    n = send.shape[1]
    value = (np.arange(n, dtype=np.int32) + 1) * send
    reply = (counts[:, :, None] % 3 == np.arange(n)[None, None] % 3).astype(np.int32)
    ts, tv, tr = torch.tensor(send), torch.tensor(value), torch.tensor(reply)
    moved = [
        (jax.vmap(lambda k, s_: jdv.bcast_counts_dense(k, s_, LO, HI, 0.1, impl=impl))(jk, send),
         tdv.bcast_counts_dense(tk, ts, LO, HI, 0.1, impl=impl)),
        (jax.vmap(lambda k, s_, v: jdv.bcast_value_max_dense(k, s_, v, LO, HI, 0.1, impl=impl))
         (jk, send, value), tdv.bcast_value_max_dense(tk, ts, tv, LO, HI, 0.1, impl=impl)),
        (jax.vmap(lambda k, s_: jdv.roundtrip_reply_counts_dense(
            k, s_, LO, HI, 0.1, peer_mask=~s_, impl=impl))(jk, send),
         tdv.roundtrip_reply_counts_dense(tk, ts, LO, HI, 0.1, peer_mask=~ts, impl=impl)),
        (jax.vmap(lambda k, r: jdv.unicast_reply_counts_dense(k, r, LO, HI, 0.1, impl=impl))
         (jk, reply), tdv.unicast_reply_counts_dense(tk, tr, LO, HI, 0.1, impl=impl)),
        (jax.vmap(lambda k, s_, v: jdv.bcast_matrix_dense(k, s_, v, LO, HI, 0.1, impl=impl))
         (jk, send, value), tdv.bcast_matrix_dense(tk, ts, tv, LO, HI, 0.1, impl=impl)),
        (jax.vmap(lambda k, v: jdv.bcast_value_max_stat(k, v, OW, 0.1))(jk, value),
         tdv.bcast_value_max_stat(tk, tv, OW, 0.1)),
    ]
    for i, (want, got) in enumerate(moved):
        np.testing.assert_array_equal(got.numpy(), np.moveaxis(np.asarray(want), 0, 1),
                                      err_msg=str(i))
    # the rbg words of lane l come from lane 0's key (rng_bit_generator's
    # batching rule); a power-of-two span takes 16-bit fields, any other
    # whole words
    for hi in (LO + 4, LO + 5):
        want = jax.vmap(lambda k: jdelay.sample_edge_delays(k, (4, n), LO, hi, impl=impl))(jk)
        got = tdelay.sample_edge_delays(tk, (4, n), LO, hi, "cpu", impl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------- #
# refusals and the golden                                                     #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kw, exc, match", [
    (dict(n=50), ValueError, "divisible"),
    (dict(n=16), ValueError, "shard size"),
    (dict(queued_links=True), NotImplementedError, "queued_links"),
    (dict(schedule="round"), ValueError, "mixed"),  # edge delivery
    (dict(mesh_axis="nodes"), NotImplementedError, "run_sharded"),
])
def test_refusals_match_jax(kw, exc, match):
    jcfg, tcfg = _cfgs(**dict(BASE, sim_ms=100, **kw))
    if "mesh_axis" not in kw:  # the JAX package runs sharded arms
        with pytest.raises(exc, match=match):
            jrunner.run_simulation(jcfg)
    with pytest.raises(exc, match=match):
        trunner.run_simulation(tcfg, device="cpu")


def test_probed_mixed_run_raises():
    """Probed mixed runs are ported (utils/trace.py): fast_finish with the
    probe ends in the unprobed run's state and returns the heartbeat scan's
    ``[S, K]`` series and the PBFT layer's ``[ticks - t_e]`` series."""
    _, tcfg = _cfgs(**dict(STAT, n=12, mixed_shards=4, sim_ms=800))
    key = threefry.key(0)
    state, bufs = tmixed.init(tcfg, threefry.fold_in(key, 0x1217), device="cpu")
    carry, ok_all, h = tmixed.prefix_handoff(tcfg, state, bufs, key)
    assert ok_all
    final, (raft_ys, pbft_ys) = tmixed.fast_finish(tcfg, carry, h, key, with_probe=True)
    plain = trunner.final_state(tcfg, device="cpu")
    assert (convert.state_digests(convert.state_to_numpy(final))
            == convert.state_digests(convert.state_to_numpy(plain)))
    rcfg, _ = tmixed.sub_configs(tcfg)
    t_e = tmixed.raft_hb.prefix_ticks(rcfg)
    assert sorted(raft_ys) == ["acks_in_window", "blocks", "rounds", "stopped"]
    assert all(v.shape == (4, tmixed.raft_hb.n_hb_steps(rcfg)) for v in raft_ys.values())
    assert all(v.shape == (tcfg.ticks - t_e,) for v in pbft_ys.values())


def test_golden_holds_the_config5_milestones():
    """The golden chip_smoke.py holds config 5 to: 256 shards with leaders,
    40/40 global blocks, agreement, the shards on the ``"normal"`` sampler,
    and a digest of every state field."""
    doc = json.loads(GOLDEN.read_text())
    assert WRITTEN_BY in doc["about"]
    entry = doc["entries"]["config5"]
    assert entry["config"] == CONFIG5 and entry["seed"] == 0
    assert entry["raft_stat_sampler"] == "normal"
    m = entry["metrics"]
    assert (m["shards_with_leader"], m["global_blocks_final"], m["agreement_ok"]) == (256, 40, True)
    assert sorted(entry["state_sha256"]) == sorted(
        [f"raft.{f}" for f in traft.STATE_FIELDS] + [f"pbft.{f}" for f in tpbft.STATE_FIELDS])


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: python tests/test_torch_mixed.py --write-golden")
    jax.config.update("jax_platforms", "cpu")
    write_golden()
