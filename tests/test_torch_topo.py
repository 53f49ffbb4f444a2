"""The PyTorch port's sparse topologies, held bit for bit to the JAX package.

- the overlay tables (``topo/spec.py``): in, out and inslot equal JAX's at a
  k = N-1 size and at sparse sizes, with the port's O(N·K) inslot build;
- every ``ops/gatherdeliv.py`` primitive equals its JAX twin at n = 16,
  K = 5, with drops off and on (edge primitives on both edge samplers,
  stat ones on both stat samplers);
- whole kregular runs (PBFT edge and stat, Raft edge and stat, Paxos) equal
  JAX's, metrics and every final-state field, and the port's kregular run
  at k = N-1 equals its own dense run; ``make_topo_dyn_sim_fn`` equals
  ``make_dyn_sim_fn``;
- the committee hierarchy: C = 1 contains the flat metrics verbatim, C = 4
  equals JAX's metrics and stacked fields (one case with Byzantine nodes in
  the tail committees, one Raft);
- a kregular checkpoint written by either package resumes in the other;
  one sweep over a kregular config equals JAX's rows;
- the refusals that stay (``xg=``, ``axis``, the mesh arms, committee
  checkpoints).

The JAX side of each whole run is computed once a process (``runs``).

Golden files for ``chip_smoke.py`` (written by the JAX package on the CPU):
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_topo.py
--write-golden [FILE]`` writes every file, or the one named (the 1M rung
takes about a minute and ~8 GB, the others under a minute).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockchain_simulator_tpu import runner as jrunner
from blockchain_simulator_tpu.ops import gatherdeliv as jgd
from blockchain_simulator_tpu.parallel import sweep as jsweep
from blockchain_simulator_tpu.topo import committee as jcommittee
from blockchain_simulator_tpu.topo import spec as jspec
from blockchain_simulator_tpu.utils import config as jconfig
from blockchain_simulator_tpu_torch import convert
from blockchain_simulator_tpu_torch import runner as trunner
from blockchain_simulator_tpu_torch.ops import gatherdeliv as tgd
from blockchain_simulator_tpu_torch.parallel import sweep as tsweep
from blockchain_simulator_tpu_torch.topo import committee as tcommittee
from blockchain_simulator_tpu_torch.topo import spec as tspec
from blockchain_simulator_tpu_torch.utils import config as tconfig
from blockchain_simulator_tpu_torch.utils import threefry
from test_torch_pbft import release_jax_executables  # noqa: F401 (autouse fixture)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN_DIR = REPO / "blockchain_simulator_tpu_torch" / "golden"
WRITTEN_BY = "PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_topo.py --write-golden"
# the ladder's knobs, as tools/topo_bench.py builds its rungs
LADDER = dict(fidelity="clean", schedule="tick", model_serialization=False,
              link_delay_ms=1, pbft_delay_lo=1, pbft_delay_hi=3, pbft_window=8)
# the artifact's largest kregular rung (tools/topo_bench.py:165-170), uncut
KREG_1M = dict(LADDER, protocol="pbft", n=1_000_000, sim_ms=150, topology="kregular",
               degree=8, delivery="edge", edge_sampler="rbg", stat_sampler="exact")
# the artifact's committee row (tools/topo_bench.py:191-196), uncut
COMMITTEE_100K = dict(LADDER, protocol="pbft", n=100_000, sim_ms=150, topology="committee",
                      committees=200, delivery="stat", stat_sampler="normal")
# Raft (edge) and Paxos on a degree-16 overlay at n = 10,000, package defaults
KREG_RAFT = dict(protocol="raft", n=10_000, sim_ms=1000, topology="kregular", degree=16)
KREG_PAXOS = dict(protocol="paxos", n=10_000, sim_ms=1000, topology="kregular", degree=16)
GOLDENS = {
    "pbft_kreg_n1m_s0.json": {"kreg1m": KREG_1M},
    "pbft_committee_n100k_s0.json": {"committee100k": COMMITTEE_100K},
    "kreg_raft_paxos_n10k_s0.json": {"raft": KREG_RAFT, "paxos": KREG_PAXOS},
}

EXACT = dict(fidelity="clean", stat_sampler="exact", edge_sampler="threefry")
KREG = dict(EXACT, topology="kregular")
RAFT = dict(protocol="raft", raft_proposal_delay_ms=300)
# whole runs, each against the JAX package: (config, expectation on the port's metrics)
RUNS = {
    "pbft_edge": dict(KREG, protocol="pbft", n=12, sim_ms=600, degree=10),
    "pbft_stat": dict(KREG, protocol="pbft", n=12, sim_ms=300, degree=10, delivery="stat"),
    "pbft_stall": dict(KREG, protocol="pbft", n=12, sim_ms=300, degree=3),
    "pbft_ladder": dict(LADDER, protocol="pbft", n=24, sim_ms=300, topology="kregular",
                        degree=6, delivery="edge", edge_sampler="rbg"),
    "pbft_faults": dict(KREG, protocol="pbft", n=16, sim_ms=400, degree=12, delivery="stat",
                        faults=dict(drop_prob=0.1, n_byzantine=2)),
    "raft_edge": dict(KREG, **RAFT, n=12, sim_ms=900, degree=9),
    "raft_stat": dict(KREG, **RAFT, n=12, sim_ms=700, degree=9, delivery="stat"),
    "raft_faults": dict(KREG, **RAFT, n=16, sim_ms=1000, degree=5,
                        faults=dict(drop_prob=0.1, n_byzantine=2)),
    "paxos": dict(KREG, protocol="paxos", n=12, sim_ms=550, degree=8),
    "committee_pbft": dict(EXACT, protocol="pbft", n=64, sim_ms=300, topology="committee",
                           committees=4),
    "committee_byz": dict(EXACT, protocol="pbft", n=64, sim_ms=300, topology="committee",
                          committees=4, faults=dict(n_byzantine=5, n_crashed=3)),
    "committee_raft": dict(EXACT, **RAFT, n=64, sim_ms=700, topology="committee",
                           committees=4, faults=dict(n_byzantine=5)),
}
EXPECT = {
    "pbft_edge": lambda m: m["blocks_final_all_nodes"] > 0,
    "pbft_stall": lambda m: m["blocks_final_all_nodes"] == 0 and m["rounds_sent"] > 0,
    "raft_stat": lambda m: m["leader"] >= 0 and m["blocks"] > 0,
    "paxos": lambda m: m["n_committed_proposers"] > 0 and m["agreement_ok"],
    "committee_pbft": lambda m: m["committees_decided"] == 4,
    # the Byzantine and crashed nodes sit in the tail committee
    "committee_byz": lambda m: m["inner_milestones_ms"][3] == -1.0 < m["inner_milestones_ms"][0],
}


def _cfgs(faults=None, **kw):
    """The same config in both packages."""
    faults = faults or {}
    return (jconfig.SimConfig(faults=jconfig.FaultConfig(**faults), **kw),
            tconfig.SimConfig(faults=tconfig.FaultConfig(**faults), **kw))


def _jax_cfg(kw: dict):
    return _cfgs(**kw)[0]


def _jax_leaves(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _assert_leaves_equal(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --------------------------------------------------------------------------- #
# goldens                                                                     #
# --------------------------------------------------------------------------- #


def golden_entry(config: dict, seed: int = 0) -> dict:
    """One golden entry, computed by the JAX package: metrics and a sha256
    of every final-state field (a committee run's fields are stacked
    ``[C, ...]``)."""
    jcfg = _jax_cfg(config)
    final = jrunner.final_state(jcfg, seed=seed)
    return {
        "config": config,
        "seed": seed,
        "jax_version": jax.__version__,
        "metrics": jrunner.base_model.sim_metrics(jcfg, final),
        "state_sha256": convert.state_digests(_jax_leaves(final)),
    }


def write_golden(only: str | None = None):
    for fname, configs in GOLDENS.items():
        if only is not None and fname != only:
            continue
        doc = {
            "about": "JAX package (blockchain_simulator_tpu) results that the "
                     "PyTorch port must reproduce bit for bit: metrics and a sha256 "
                     "of every final-state field (blockchain_simulator_tpu_torch/"
                     "convert.state_digests; committee fields stacked [C, ...]). "
                     f"Written by: {WRITTEN_BY}",
            "entries": {name: golden_entry(cfg) for name, cfg in configs.items()},
        }
        (GOLDEN_DIR / fname).write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
        print(f"wrote {GOLDEN_DIR / fname}", flush=True)


def test_goldens_hold_the_artifact_milestones():
    """The goldens chip_smoke.py holds the card to: the configs as
    tools/topo_bench.py builds them, the committee row's 200 of 200
    decided at 116.0 ms, the 1M rung stalled below quorum by design, and a
    digest of every state field."""
    from blockchain_simulator_tpu_torch.models import paxos, pbft, raft

    docs = {f: json.loads((GOLDEN_DIR / f).read_text()) for f in GOLDENS}
    for fname, configs in GOLDENS.items():
        assert WRITTEN_BY in docs[fname]["about"]
        for name, cfg in configs.items():
            entry = docs[fname]["entries"][name]
            assert entry["config"] == cfg and entry["seed"] == 0
            fields = {"pbft": pbft, "raft": raft, "paxos": paxos}[cfg["protocol"]].STATE_FIELDS
            assert sorted(entry["state_sha256"]) == sorted(fields)
    m = docs["pbft_committee_n100k_s0.json"]["entries"]["committee100k"]["metrics"]
    assert (m["committees_decided"], m["outer_commit_ms"], m["committee_size"]) == (200, 116.0,
                                                                                   500)
    assert len(m["inner_milestones_ms"]) == 200 and min(m["inner_milestones_ms"]) > 0
    m = docs["pbft_kreg_n1m_s0.json"]["entries"]["kreg1m"]["metrics"]
    assert m["rounds_sent"] > 0 and m["blocks_final_all_nodes"] == 0


# --------------------------------------------------------------------------- #
# the overlay tables                                                          #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n, k, seed", [(64, 63, 0), (64, 5, 0), (64, 5, 3), (7, 6, 0),
                                        (33, 16, 9)])
def test_spec_tables_equal_jax(n, k, seed):
    """in, out and inslot equal JAX's (dtype included), at k = N-1 (the
    identity) and sparse; the port builds inslot without the [N, K, K]
    intermediate."""
    assert tspec.circulant_offsets(n, k, seed) == jspec.circulant_offsets(n, k, seed)
    for fn in ("in_table", "out_table", "inslot_table"):
        got, want = getattr(tspec, fn)(n, k, seed), getattr(jspec, fn)(n, k, seed)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=fn)
    assert tspec.overlay_diameter(n, k, seed) == jspec.overlay_diameter(n, k, seed)
    if k == n - 1:
        assert (tspec.in_table(n, k, seed) == np.arange(n)[None, :]).all()
    for shards in (1, 2, 4):
        if n % shards:
            continue
        for a, b in zip(tspec.owner_bucket_plan(tspec.in_table(n, k, seed), shards),
                        jspec.owner_bucket_plan(jspec.in_table(n, k, seed), shards)):
            np.testing.assert_array_equal(a, b)


def test_spec_types_and_device_tables():
    for kw in (dict(topology="kregular", degree=5), dict(topology="committee", committees=4),
               dict(topology="full")):
        jcfg, tcfg = _cfgs(protocol="pbft", n=64, **kw)
        assert dataclasses.asdict(tspec.TopoSpec.from_config(tcfg)) == \
            dataclasses.asdict(jspec.TopoSpec.from_config(jcfg))
    s = tspec.TopoSpec.from_config(tconfig.SimConfig(n=64, topology="committee", committees=4))
    assert (s.slots, s.committee_size) == (1, 16)
    tabs = tspec.device_tables(64, 5, 0, torch.device("cpu"))
    assert all(t.dtype == torch.int64 for t in tabs)
    assert tabs is tspec.device_tables(64, 5, 0, torch.device("cpu"))  # made once
    for a, b in zip(tabs, tspec._tables(64, 5, 0)):
        np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(ValueError):
        tspec.circulant_offsets(8, 8, 0)
    with pytest.raises(ValueError):
        tspec.owner_bucket_plan(tspec.in_table(64, 5, 0), 4, capacity=1)


def test_local_tables_rows_and_operands():
    """``local_tables`` equals JAX's for global ids, shard-offset ids and the
    pass-through, with the config's tables or given operands."""
    jcfg, tcfg = _cfgs(protocol="raft", n=16, topology="kregular", degree=4)
    ops = tgd.table_operands(tcfg, inslot=True)
    for a, b in zip(ops, jgd.table_operands(jcfg, inslot=True)):
        np.testing.assert_array_equal(a, b)
    for ids, base, tables in ((np.arange(16), 0, None), (np.arange(4), 8, None),
                              (None, 0, ops), (np.arange(16), 0, ops)):
        want = jgd.local_tables(jcfg, None if ids is None else jnp.asarray(ids), inslot=True,
                                tables=tables, base=base)
        got = tgd.local_tables(tcfg, None if ids is None else torch.as_tensor(ids),
                               inslot=True, tables=tables, base=base)
        for a, b in zip(got, want):
            assert a.dtype == torch.int64
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        tgd.local_tables(tcfg, None, inslot=True, tables=ops[:2])


# --------------------------------------------------------------------------- #
# the gather primitives                                                       #
# --------------------------------------------------------------------------- #

N, DEG, LO, HI = 16, 4, 6, 9


def _tables_both(seed=0):
    j = jspec._tables(N, DEG, seed)
    t = tspec.device_tables(N, DEG, seed, torch.device("cpu"))
    return [jnp.asarray(x) for x in j], list(t)


def _inputs(seed):
    """Numpy inputs from a seed: send masks, values, slot and window
    matrices, reply wires and targets, at n = 16, K = 5."""
    rng = np.random.default_rng(seed)
    send = rng.random(N) < 0.4
    send[0] = True
    return dict(
        send=send,
        peers=rng.random(N) < 0.7,
        value=(rng.integers(1, 50, N) * send).astype(np.int32),
        slot_mat=(rng.integers(0, 3, (N, 6)) * (rng.random((N, 6)) < 0.5)).astype(np.int32),
        value_mat=(rng.integers(1, 40, (N, 6)) * (rng.random((N, 6)) < 0.3)).astype(np.int32),
        reply_slots=(rng.random((N, DEG + 1)) < 0.5).astype(np.int32),
        wire=rng.random(N) < 0.6,
        target=rng.integers(0, N, N).astype(np.int32),
    )


def _jt(x):
    return jnp.asarray(x), torch.as_tensor(x)


def _eq(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.dtype == torch.int32 and want.dtype == np.int32, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


EDGE_PRIMS = ["bcast_counts_kreg", "bcast_value_max_kreg", "bcast_slots_kreg",
              "bcast_window_value_max_kreg", "bcast_matrix_kreg",
              "roundtrip_reply_counts_kreg", "unicast_reply_counts_kreg"]


def _edge_args(name, x, tabs, ids):
    """(positional args after the key, kwargs) of one edge primitive."""
    nin, nout, ins = tabs
    args = {
        "bcast_counts_kreg": (x["send"], nin, ids),
        "bcast_value_max_kreg": (x["send"], x["value"], nin, ids),
        "bcast_slots_kreg": (x["slot_mat"], nin, ids),
        "bcast_window_value_max_kreg": (x["value_mat"], nin, ids),
        "bcast_matrix_kreg": (x["send"], x["value"], nin, ids),
        "roundtrip_reply_counts_kreg": (x["send"], nout, ids),
        "unicast_reply_counts_kreg": (x["reply_slots"], nin, nout, ins, ids),
    }[name]
    kw = {"peer_mask": x["peers"]} if name == "roundtrip_reply_counts_kreg" else {}
    return args, kw


@pytest.mark.parametrize("impl", ["threefry", "rbg"])
@pytest.mark.parametrize("drop", [0.0, 0.2])
@pytest.mark.parametrize("name", EDGE_PRIMS)
def test_edge_primitive_equals_jax(name, drop, impl):
    x = _inputs(EDGE_PRIMS.index(name))
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    tx = {k: torch.as_tensor(v) for k, v in x.items()}
    jtabs, ttabs = _tables_both()
    jargs, jkw = _edge_args(name, jx, jtabs, jnp.arange(N))
    targs, tkw = _edge_args(name, tx, ttabs, torch.arange(N, dtype=torch.int32))
    jfn = getattr(jgd, name)
    want = jax.jit(lambda k: jfn(k, *jargs, LO, HI, drop, impl=impl, **jkw))(jax.random.key(7))
    got = getattr(tgd, name)(threefry.key(7), *targs, LO, HI, drop, impl=impl, **tkw)
    _eq(got, want)


def test_count_gathers_equal_jax():
    x = _inputs(11)
    jtabs, ttabs = _tables_both(seed=2)
    jids, tids = jnp.arange(N), torch.arange(N, dtype=torch.int32)
    for fn, tab in (("in_counts", 0), ("out_counts", 1)):
        _eq(getattr(tgd, fn)(torch.as_tensor(x["send"]), ttabs[tab], tids),
            getattr(jgd, fn)(jnp.asarray(x["send"]), jtabs[tab], jids))
    _eq(tgd.reply_counts_by_target_kreg(torch.as_tensor(x["wire"]), torch.as_tensor(x["target"]),
                                        ttabs[1], tids),
        jgd.reply_counts_by_target_kreg(jnp.asarray(x["wire"]), jnp.asarray(x["target"]),
                                        jtabs[1], jids))


@pytest.mark.parametrize("drop", [0.0, 0.2])
@pytest.mark.parametrize("mode", ["exact", "normal"])
def test_stat_primitives_equal_jax(mode, drop):
    """The four stat twins (the slot push against JAX's pushed ring)."""
    from blockchain_simulator_tpu.ops import delay as jdelay

    x = _inputs(3)
    jtabs, ttabs = _tables_both(seed=1)
    jids, tids = jnp.arange(N), torch.arange(N, dtype=torch.int32)
    probs = jdelay.uniform_probs(LO, HI)
    jk, tk = jax.random.key(5), threefry.key(5)
    (js, ts), (jv, tv), (jsm, tsm), (jvm, tvm) = (
        _jt(x["send"]), _jt(x["value"]), _jt(x["slot_mat"]), _jt(x["value_mat"]))
    _eq(tgd.bcast_counts_stat_kreg(tk, ts, ttabs[0], tids, probs, drop, mode=mode),
        jax.jit(lambda k: jgd.bcast_counts_stat_kreg(k, js, jtabs[0], jids, probs, drop,
                                                     mode=mode))(jk))
    got = tgd.push_bcast_slots_stat_kreg(tk, tsm, ttabs[0], tids, probs, drop, mode=mode)
    b = len(probs)
    ring = jax.jit(lambda k: jgd.push_bcast_slots_stat_kreg(
        jnp.zeros((b + LO + 1, N, 6), jnp.int32), 0, LO, k, jsm, jtabs[0], jids, probs, drop,
        mode=mode))(jk)
    _eq(got, np.asarray(ring)[LO:LO + b])
    assert not np.asarray(ring)[:LO].any() and not np.asarray(ring)[LO + b:].any()
    _eq(tgd.bcast_value_max_stat_kreg(tk, tv, ttabs[0], probs, drop),
        jax.jit(lambda k: jgd.bcast_value_max_stat_kreg(k, jv, jtabs[0], probs, drop))(jk))
    _eq(tgd.bcast_window_value_max_stat_kreg(tk, tvm, ttabs[0], probs, drop),
        jax.jit(lambda k: jgd.bcast_window_value_max_stat_kreg(k, jvm, jtabs[0], probs,
                                                               drop))(jk))


def test_primitives_refuse_exchange_and_axis():
    """The neighbour exchange (``xg=``) and a mesh ``axis`` are the sharded
    overlay's (tests/test_torch_exchange.py runs them over ranks): a given
    exchange carries every cross-row read, with the same values as the
    gather, and an axis that no sharded body binds is refused."""
    x = _inputs(0)
    _, ttabs = _tables_both()
    send, tids = torch.as_tensor(x["send"]), torch.arange(N, dtype=torch.int32)
    reads = []

    def xg(v, kind="in", col=None):
        reads.append(kind)
        return tgd._nbr_rows(v, ttabs[0] if kind == "in" else ttabs[1], col=col)

    key = threefry.key(0)
    assert torch.equal(tgd.bcast_counts_kreg(key, send, ttabs[0], tids, LO, HI, xg=xg),
                       tgd.bcast_counts_kreg(key, send, ttabs[0], tids, LO, HI))
    assert torch.equal(tgd.in_counts(send, ttabs[0], tids, xg=xg),
                       tgd.in_counts(send, ttabs[0], tids))
    assert reads == ["in", "in"]
    with pytest.raises(RuntimeError, match="not bound"):
        tgd.bcast_counts_kreg(key, send, ttabs[0], tids, LO, HI, axis="nodes")


# --------------------------------------------------------------------------- #
# whole runs                                                                  #
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def runs():
    """``runs(case)``: the JAX package's and the port's metrics and leaves
    of one case, computed once a process."""
    memo = {}

    def get(case):
        if case not in memo:
            jcfg, tcfg = _cfgs(**RUNS[case])
            jfinal = jrunner.final_state(jcfg)
            tfinal = trunner.final_state(tcfg, device="cpu")
            memo[case] = (jrunner.base_model.sim_metrics(jcfg, jfinal), _jax_leaves(jfinal),
                          trunner.sim_metrics(tcfg, tfinal), convert.state_to_numpy(tfinal))
        return memo[case]
    return get


@pytest.mark.parametrize("case", list(RUNS))
def test_run_equals_jax(runs, case):
    """Metrics and every final-state field (stacked [C, ...] for a committee
    run) equal JAX's."""
    jm, jl, tm, tl = runs(case)
    assert tm == jm
    _assert_leaves_equal(jl, tl)
    assert EXPECT.get(case, lambda m: True)(tm), tm


@pytest.mark.parametrize("kw", [
    dict(EXACT, protocol="pbft", n=16, sim_ms=400, delivery="edge"),
    dict(EXACT, protocol="pbft", n=16, sim_ms=400, delivery="stat",
         faults=tconfig.FaultConfig(n_byzantine=2)),
    dict(EXACT, protocol="raft", n=12, sim_ms=1000, delivery="edge",
         raft_proposal_delay_ms=300),
    dict(EXACT, protocol="raft", n=12, sim_ms=1000, delivery="stat",
         raft_proposal_delay_ms=300),
    dict(EXACT, protocol="paxos", n=12, sim_ms=600),
], ids=["pbft-edge", "pbft-stat-byz", "raft-edge", "raft-stat", "paxos"])
def test_kregular_full_degree_equals_dense(kw):
    """At k = N-1 the overlay is the full mesh: the port's kregular run
    equals its dense run, metrics and every field."""
    dense = trunner.final_state(tconfig.SimConfig(**kw), device="cpu")
    kcfg = tconfig.SimConfig(topology="kregular", degree=kw["n"] - 1, **kw)
    kreg = trunner.final_state(kcfg, device="cpu")
    assert trunner.sim_metrics(kcfg, kreg) == trunner.sim_metrics(tconfig.SimConfig(**kw),
                                                                   dense)
    _assert_leaves_equal(convert.state_to_numpy(dense), convert.state_to_numpy(kreg))


def test_raft_kregular_edge_ring_is_n_by_k():
    from blockchain_simulator_tpu.models import raft as jraft
    from blockchain_simulator_tpu_torch.models import raft as traft

    jcfg, tcfg = _cfgs(protocol="raft", n=12, topology="kregular", degree=4)
    _, tb = traft.init(tcfg, device="cpu")
    _, jb = jraft.init(jcfg, jax.random.key(0))
    assert tuple(tb.vreq.shape) == jb.vreq.shape == (tcfg.ring_depth, 12, 5)
    stat = tcfg.with_(delivery="stat")
    assert tuple(traft.init(stat, device="cpu")[1].vreq.shape) == (tcfg.ring_depth, 12)
    # lane keys [2, 2] stack two lanes over the overlay: the ring [D, 2, N, K]
    _, lanes = traft.init(tcfg, np.stack([threefry.key(0), threefry.key(1)]), device="cpu")
    assert tuple(lanes.vreq.shape) == (tcfg.ring_depth, 2, 12, 5)


@pytest.mark.parametrize("protocol", ["pbft", "raft", "paxos"])
def test_topo_dyn_sim_equals_dyn_sim(protocol):
    """The tables-as-arguments program equals the dyn program, with the
    tables as numpy operands and as tensors."""
    extra = dict(raft_proposal_delay_ms=300) if protocol == "raft" else {}
    cfg = tconfig.SimConfig(**dict(KREG, protocol=protocol, n=12, sim_ms=700, degree=6,
                                   **extra), faults=tconfig.FaultConfig(n_byzantine=1))
    key = threefry.key(3)
    want = convert.state_to_numpy(trunner.make_dyn_sim_fn(cfg)(key, 1, 1, "cpu"))
    tables = tgd.table_operands(cfg, inslot=trunner.topo_tables_inslot(cfg))
    assert len(tables) == (3 if protocol == "raft" else 2)
    sim = trunner.make_topo_dyn_sim_fn(cfg)
    for tabs in (tables, [torch.as_tensor(t) for t in tables]):
        _assert_leaves_equal(want, convert.state_to_numpy(sim(key, 1, 1, *tabs, device="cpu")))
    with pytest.raises(ValueError):
        sim(key, 1, 1, *tables[:1], device="cpu")


def test_committee_of_one_contains_the_flat_run():
    for kw in (dict(EXACT, protocol="pbft", n=8, sim_ms=400),
               dict(EXACT, **RAFT, n=8, sim_ms=1400, delivery="stat"),
               dict(EXACT, protocol="paxos", n=8, sim_ms=400)):
        flat = trunner.run_simulation(tconfig.SimConfig(**kw), device="cpu")
        comm = trunner.run_simulation(
            tconfig.SimConfig(topology="committee", committees=1, **kw), device="cpu")
        assert {k: comm[k] for k in flat} == flat, kw["protocol"]
        assert comm["outer_round_ms"] == 0.0


def test_committee_keys_and_masks_equal_jax():
    """The per-committee keys (``fold_in(key, c)``; C = 1 the key itself)
    and the stacked final state's round trip through ``convert``."""
    jk = jax.random.key(9)
    for c in (1, 4):
        want = np.asarray(jax.random.key_data(jcommittee._committee_keys(jk, c)))
        np.testing.assert_array_equal(tcommittee._committee_keys(threefry.key(9), c), want)
    jcfg, tcfg = _cfgs(**RUNS["committee_byz"])
    assert dataclasses.asdict(tcommittee.inner_cfg(tcfg)) == \
        dataclasses.asdict(jcommittee.inner_cfg(jcfg))
    final = trunner.final_state(tcfg, device="cpu")
    leaves = convert.state_to_numpy(final)
    back, rings = convert.state_from_numpy(tcfg, leaves, None, "cpu")
    assert rings == ()
    _assert_leaves_equal(leaves, convert.state_to_numpy(back))
    assert trunner.sim_metrics(tcfg, back) == trunner.sim_metrics(tcfg, final)
    with pytest.raises(ValueError):
        convert.state_from_numpy(tcfg, leaves, leaves, "cpu")


# --------------------------------------------------------------------------- #
# checkpoints and sweeps                                                      #
# --------------------------------------------------------------------------- #

CKPT = dict(KREG, **RAFT, n=12, sim_ms=600, degree=5)


def test_kregular_checkpoint_crosses_packages(tmp_path):
    """The port's kregular archive (Raft edge: vreq [D, N, K]) resumes in
    JAX, and JAX's in the port, each to the uninterrupted run."""
    jcfg, tcfg = _cfgs(**CKPT)
    want = trunner.run_simulation(tcfg, device="cpu")
    assert want == jrunner.run_simulation(jcfg)
    tm, _ = trunner.run_checkpointed(tcfg, every_ms=300, ckpt_dir=tmp_path / "t",
                                     keep_all=True, device="cpu")
    assert tm == want
    assert jrunner.resume_simulation(tmp_path / "t" / "ckpt_00000300.npz") == want
    jrunner.run_checkpointed(jcfg, every_ms=300, ckpt_dir=tmp_path / "j", keep_all=True)
    assert trunner.resume_simulation(tmp_path / "j" / "ckpt_00000300.npz", device="cpu") == want


def test_kregular_sweep_equals_jax():
    """A fault sweep over a kregular config: one structure group, its lanes
    side by side, rows equal to JAX's."""
    jcfg, tcfg = _cfgs(**dict(KREG, protocol="pbft", n=12, sim_ms=250, degree=8))
    levels = [dict(n_byzantine=0), dict(n_byzantine=2), dict(n_crashed=3)]
    want = jsweep.run_fault_sweep(jcfg, [jconfig.FaultConfig(**f) for f in levels], (0, 1))
    got = tsweep.run_fault_sweep(tcfg, [tconfig.FaultConfig(**f) for f in levels], (0, 1),
                                 device="cpu")
    assert list(got.values()) == list(want.values())


# --------------------------------------------------------------------------- #
# what still refuses                                                          #
# --------------------------------------------------------------------------- #


def test_committee_checkpoints_refuse_as_jax(tmp_path):
    jcfg, tcfg = _cfgs(**RUNS["committee_pbft"])
    for fn, kw in ((trunner.run_checkpointed, {}), (trunner.run_dyn_checkpointed, {})):
        with pytest.raises(ValueError, match="committee path's stacked state"):
            fn(tcfg, every_ms=100, ckpt_dir=tmp_path, device="cpu", **kw)
    with pytest.raises(ValueError, match="committee path's stacked state"):
        jrunner.run_checkpointed(jcfg, every_ms=100, ckpt_dir=tmp_path / "j")


def test_sharded_topo_and_exchange_refuse():
    """The node-sharded topology programs and the exchange run on a node
    mesh now (tests/test_torch_exchange.py); what they still refuse: a
    dense config (a ValueError in both packages), a committee config for
    the tables-as-operands program, and a ``mesh_axis`` config through the
    single-device runner."""
    with pytest.raises(ValueError):
        tsweep.sharded_topo_sim_fn(tconfig.SimConfig(protocol="pbft", n=8), mesh="nodes:2")
    kcfg = tconfig.SimConfig(**RUNS["raft_edge"])
    with pytest.raises(ValueError):
        trunner.make_topo_dyn_sim_fn(tconfig.SimConfig(**RUNS["committee_pbft"]))
    with pytest.raises(NotImplementedError, match="run_sharded"):
        trunner.run_simulation(kcfg.with_(mesh_axis="nodes"), device="cpu")
    # committee probes are ported (utils/trace.py): the taps only read, and
    # the committees' series stack [C, ticks]
    ccfg = tconfig.SimConfig(protocol="pbft", n=8, sim_ms=60, topology="committee",
                             committees=2)
    finals, ys = tcommittee.run_stacked(
        ccfg, threefry.key(0), 0, 0, device="cpu",
        probe=(lambda icfg, st: {"views": st.v.max()}, lambda icfg, final, ys: ys))
    plain = tcommittee.run_stacked(ccfg, threefry.key(0), 0, 0, device="cpu")
    assert (convert.state_digests(convert.state_to_numpy(finals))
            == convert.state_digests(convert.state_to_numpy(plain)))
    assert list(ys) == ["views"] and ys["views"].shape == (2, 60)
    with pytest.raises(ValueError, match="schedule='round'"):
        trunner.make_sim_fn(tconfig.SimConfig(**RUNS["committee_pbft"], schedule="round"))


if __name__ == "__main__":
    args = sys.argv[1:]
    if not args or args[0] != "--write-golden" or len(args) > 2:
        sys.exit("usage: python tests/test_torch_topo.py --write-golden [FILE]")
    jax.config.update("jax_platforms", "cpu")
    write_golden(args[1] if len(args) == 2 else None)
