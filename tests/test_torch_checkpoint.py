"""The PyTorch port's checkpoints, held bit for bit to the JAX package.

Both packages write one archive layout (utils/checkpoint.py: the config as
the same JSON string, the tick, the tick engine's leaves ``s{i}`` / ``b{i}``
in JAX's order and layout, ``__dyn__`` for a dynamic-fault run), so:

- a segmented port run equals the uninterrupted one;
- the port's ``run_checkpointed`` writes, at every tick, the archive JAX's
  writes (every array equal), and its metrics are JAX's;
- an archive JAX wrote resumes in the port to JAX's uninterrupted metrics,
  and one the port wrote resumes in JAX to the same (PBFT, Raft, Paxos);
- the dynamic-fault checkpoint resumes mid-run (and after a crash) to JAX's
  dyn run;
- the guards refuse what JAX's refuse (a different config, static versus
  dyn archives, ``every_ms < 1``, ``schedule="round"``);
- the mixed sim's archive carries its Raft rings in JAX's ``[S, D, m]``
  layout both ways.

The JAX side of each protocol is computed once a process (``jax_runs``).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from blockchain_simulator_tpu import runner as jrunner
from blockchain_simulator_tpu.models import base as jbase
from blockchain_simulator_tpu.models import mixed as jmixed
from blockchain_simulator_tpu.parallel import sweep as jsweep
from blockchain_simulator_tpu.utils import checkpoint as jckpt
from blockchain_simulator_tpu_torch import convert
from blockchain_simulator_tpu_torch import runner as trunner
from blockchain_simulator_tpu_torch.models import base as tbase
from blockchain_simulator_tpu_torch.utils import checkpoint as tckpt
from blockchain_simulator_tpu_torch.utils import threefry
from test_torch_pbft import _cfgs, release_jax_executables  # noqa: F401 (autouse fixture)

# (config, every_ms): the JAX package's own checkpoint test configs
CASES = {
    "pbft": (dict(protocol="pbft", n=8, sim_ms=1000, pbft_max_rounds=12), 300),
    "raft": (dict(protocol="raft", n=8, sim_ms=600), 250),
    "paxos": (dict(protocol="paxos", n=8, sim_ms=600), 250),
    "pbft_queued": (dict(protocol="pbft", n=8, sim_ms=700, queued_links=True), 300),
}
DYN = dict(protocol="pbft", n=8, sim_ms=600, pbft_max_rounds=12, faults=dict(n_byzantine=2))


def _archive(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """``jax_runs(case)``: ``(metrics, [archive paths])`` of JAX's
    ``run_checkpointed(keep_all=True)``, computed once a process."""
    memo = {}

    def get(case):
        if case not in memo:
            config, every = CASES[case]
            jcfg, _ = _cfgs(**config)
            d = tmp_path_factory.mktemp(f"jax_{case}")
            m, _ = jrunner.run_checkpointed(jcfg, every_ms=every, ckpt_dir=d, keep_all=True)
            memo[case] = (m, sorted(d.glob("ckpt_*.npz")))
        return memo[case]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_port_archives_equal_jax(jax_runs, tmp_path, case):
    """The port's ``run_checkpointed`` writes JAX's archives, array for
    array, at every tick, and returns JAX's metrics."""
    jm, jpaths = jax_runs(case)
    config, every = CASES[case]
    _, tcfg = _cfgs(**config)
    tm, last = trunner.run_checkpointed(tcfg, every_ms=every, ckpt_dir=tmp_path,
                                        keep_all=True, device="cpu")
    assert tm == jm
    tpaths = sorted(tmp_path.glob("ckpt_*.npz"))
    assert [p.name for p in tpaths] == [p.name for p in jpaths] and last == tpaths[-1]
    for jp, tp in zip(jpaths, tpaths):
        ja, ta = _archive(jp), _archive(tp)
        assert sorted(ta) == sorted(ja)
        for k in ja:
            assert ta[k].dtype == ja[k].dtype, (tp.name, k)
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=f"{tp.name} {k}")


@pytest.mark.parametrize("case", ["pbft", "raft", "paxos"])
def test_jax_archive_resumes_in_port(jax_runs, case):
    """A mid-run archive written by JAX finishes in the port to JAX's
    uninterrupted metrics."""
    jm, jpaths = jax_runs(case)
    assert trunner.resume_simulation(jpaths[0], device="cpu") == jm


@pytest.mark.parametrize("case", ["pbft", "raft", "paxos"])
def test_port_archive_resumes_in_jax(jax_runs, tmp_path, case):
    """A mid-run archive written by the port finishes in JAX to JAX's
    uninterrupted metrics."""
    jm, jpaths = jax_runs(case)
    config, every = CASES[case]
    _, tcfg = _cfgs(**config)
    trunner.run_checkpointed(tcfg, every_ms=every, ckpt_dir=tmp_path, keep_all=True,
                             device="cpu")
    mid = sorted(tmp_path.glob("ckpt_*.npz"))[1]
    assert jrunner.resume_simulation(mid) == jm


def test_segmented_run_equals_whole():
    """Four segments equal one uninterrupted run, field for field."""
    config, _ = CASES["pbft"]
    _, tcfg = _cfgs(**config)
    whole = trunner.final_state(tcfg, device="cpu")
    proto = tbase.get_protocol("pbft")
    key = threefry.key(tcfg.seed)
    state, bufs = proto.init(tcfg, threefry.fold_in(key, trunner._INIT_FOLD), device="cpu")
    for t0 in range(0, 1000, 250):
        state, bufs = trunner.make_segment_fn(tcfg, 250)(key, state, bufs, t0)
    assert convert.state_digests(convert.state_to_numpy(state)) == \
        convert.state_digests(convert.state_to_numpy(whole))


def test_seed_override_and_latest_only(tmp_path):
    """The effective seed is stored in the archive's config, so a resumed
    run continues seed 5's stream; only the newest archive is kept."""
    config, _ = CASES["pbft"]
    _, tcfg = _cfgs(**config)
    m5 = trunner.run_simulation(tcfg, seed=5, device="cpu")
    m, last = trunner.run_checkpointed(tcfg, every_ms=400, ckpt_dir=tmp_path, seed=5,
                                       device="cpu")
    assert m == m5 and len(list(tmp_path.glob("ckpt_*.npz"))) == 1
    assert trunner.resume_simulation(last, device="cpu") == m5


@pytest.fixture(scope="module")
def dyn_ref():
    """JAX's dyn run of ``DYN`` at seed 5 (the un-checkpointed anchor)."""
    jcfg, _ = _cfgs(**DYN)
    return jsweep.run_dyn_points(jbase.canonical_fault_cfg(jcfg), [(jcfg, 5)])[0]


def test_dyn_checkpoint_resumes_mid_run(dyn_ref, tmp_path):
    """The dyn checkpointed run equals JAX's dyn run, stores its operands,
    resumes from a mid-run archive, and after a crash continues from the
    newest archive left."""
    _, tcfg = _cfgs(**DYN)
    m, last = trunner.run_dyn_checkpointed(tcfg, every_ms=200, ckpt_dir=tmp_path, seed=5,
                                           keep_all=True, device="cpu")
    assert m == dyn_ref and tckpt.load_dyn_counts(last) == (0, 2)
    mids = sorted(tmp_path.glob("ckpt_*.npz"))
    assert len(mids) == 3
    assert trunner.resume_dyn_simulation(mids[1], device="cpu") == dyn_ref
    assert jrunner.resume_dyn_simulation(mids[1]) == dyn_ref
    for p in mids[1:]:
        p.unlink()
    m2, _ = trunner.run_dyn_checkpointed(tcfg, every_ms=200, ckpt_dir=tmp_path, seed=5,
                                         device="cpu")
    assert m2 == dyn_ref


def _guard(pkg, tmp_path, which: str):
    """Exercise one guard through ``pkg`` (either package's runner); the
    archives go to ``tmp_path``."""
    ck = tckpt if pkg is trunner else jckpt
    cfgs = _cfgs(**CASES["pbft"][0])
    dcfgs = _cfgs(**DYN)
    cfg, dcfg = (cfgs[1], dcfgs[1]) if pkg is trunner else (cfgs[0], dcfgs[0])
    kw = {"device": "cpu"} if pkg is trunner else {}
    if which == "every_ms":
        pkg.run_checkpointed(cfg, every_ms=0, ckpt_dir=tmp_path, **kw)
    elif which == "round":
        pkg.run_checkpointed(cfg.with_(n=16, delivery="stat", schedule="round",
                                       model_serialization=False),
                             every_ms=300, ckpt_dir=tmp_path, **kw)
    elif which == "static":
        _, last = pkg.run_checkpointed(cfg.with_(sim_ms=300), every_ms=300,
                                       ckpt_dir=tmp_path, **kw)
        assert ck.load_dyn_counts(last) is None
        pkg.resume_dyn_simulation(last, **kw)
    elif which == "config":
        pkg.run_dyn_checkpointed(dcfg.with_(sim_ms=200), every_ms=200, ckpt_dir=tmp_path,
                                 seed=5, **kw)
        pkg.run_dyn_checkpointed(dcfg.with_(sim_ms=400), every_ms=200, ckpt_dir=tmp_path,
                                 seed=5, **kw)


@pytest.mark.parametrize("which,match", [
    ("every_ms", "every_ms"), ("round", "schedule='round'"), ("static", "static-path"),
    ("config", "different config")])
def test_checkpoint_guards_match_jax(tmp_path, which, match):
    """Each guard raises the ``ValueError`` JAX's raises."""
    for pkg in (jrunner, trunner):
        with pytest.raises(ValueError, match=match):
            _guard(pkg, tmp_path / pkg.__name__, which)


@pytest.mark.parametrize("config", [
    dict(protocol="pbft", n=8, sim_ms=100, faults=dict(n_crashed=1, drop_prob=0.1)),
    dict(protocol="raft", n=16, sim_ms=5000, delivery="stat", stat_sampler="normal",
         queued_links=True),
    dict(protocol="mixed", n=48, mixed_shards=8, sim_ms=3000, seed=3),
    dict(protocol="paxos", n=64, topology="gossip", degree=4, paxos_retry_timeout_ms=600)])
def test_config_json_equals_jax(config):
    """``__cfg__`` is one string in both packages, and reads back equal."""
    jcfg, tcfg = _cfgs(**config)
    s = tckpt.config_to_json(tcfg)
    assert s == jckpt.config_to_json(jcfg)
    assert tckpt.config_from_json(s) == tcfg


def test_mixed_archive_round_trips_ring_layout(tmp_path):
    """The mixed sim's archive holds JAX's leaves (Raft rings ``[S, D,
    m]``): JAX's archive loads in the port to the same leaves, the port's
    archive loads in JAX to the same leaves, and a port run through a
    saved and loaded mid-run state equals the uninterrupted one."""
    config = dict(protocol="mixed", n=12, mixed_shards=4, sim_ms=120, delivery="stat",
                  model_serialization=False)
    jcfg, tcfg = _cfgs(**config)
    jstate, jbufs = jmixed.init(jcfg, jax.random.key(3))
    jp = tmp_path / "jax.npz"
    jckpt.save_checkpoint(jp, jcfg, jstate, jbufs, 0)
    jleaves = [np.asarray(x) for x in jax.tree.leaves((jstate, jbufs))]
    cfg2, tstate, tbufs, tick = tckpt.load_checkpoint(jp, device="cpu")
    assert cfg2 == tcfg and tick == 0
    tleaves = convert.state_to_numpy(tstate, tbufs)
    flat = list(tleaves[0].values()) + list(tleaves[1].values())
    assert len(flat) == len(jleaves)
    for a, b in zip(flat, jleaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the port's archive of a stepped state, read by JAX
    key = threefry.key(tcfg.seed)
    st, bf = trunner.make_segment_fn(tcfg, 60)(key, tstate, tbufs, 0)
    tp = tmp_path / "port.npz"
    tckpt.save_checkpoint(tp, tcfg, st, bf, 60)
    _, js, jb, jt = jckpt.load_checkpoint(tp)
    s_np, b_np = convert.state_to_numpy(st, bf)
    assert jt == 60
    for a, b in zip(list(s_np.values()) + list(b_np.values()), jax.tree.leaves((js, jb))):
        np.testing.assert_array_equal(a, np.asarray(b))
    # save, load, continue == continue
    _, ls, lb, _ = tckpt.load_checkpoint(tp, device="cpu")
    seg = trunner.make_segment_fn(tcfg, 60)
    a = seg(key, ls, lb, 60)[0]
    b = seg(key, st, bf, 60)[0]
    assert convert.state_digests(convert.state_to_numpy(a)) == \
        convert.state_digests(convert.state_to_numpy(b))


def test_checkpoint_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without ``device`` the checkpoint entry points run on the card, and
    without one they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs(**CASES["pbft"][0])
    p = tmp_path / "ck.npz"
    state, bufs = tbase.get_protocol("pbft").init(tcfg, device="cpu")
    tckpt.save_checkpoint(p, tcfg, state, bufs, 0)
    for fn in (lambda: trunner.run_checkpointed(tcfg, 300, tmp_path / "a"),
               lambda: trunner.run_dyn_checkpointed(tcfg, 300, tmp_path / "b"),
               lambda: trunner.resume_simulation(p),
               lambda: tckpt.load_checkpoint(p)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()


def test_leaf_order_is_jax_order():
    """The port's field order (the archive's leaf order) is JAX's, per
    protocol."""
    from blockchain_simulator_tpu.models import paxos as jpaxos, pbft as jpbft, raft as jraft

    for jmod, cfg in ((jpbft, dict(protocol="pbft", n=8)), (jraft, dict(protocol="raft", n=8)),
                      (jpaxos, dict(protocol="paxos", n=8))):
        jcfg, tcfg = _cfgs(sim_ms=100, **cfg)
        js, jb = jax.eval_shape(lambda: jmod.init(jcfg, jax.random.key(0)))
        names = tckpt._leaf_names(tcfg)
        assert names == ([f.name for f in dataclasses.fields(js)],
                         [f.name for f in dataclasses.fields(jb)])
