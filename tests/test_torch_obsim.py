"""obsim on the port (``blockchain_simulator_tpu_torch/obsim``) held to the JAX
package, bit for bit.

Each case runs one lane batch through ``parallel/sweep.run_dyn_points(
probe=...)`` in both packages on the CPU and compares:

- the rows (metrics and each row's ``"probe"`` summary) as canonical JSON;
- every probe leaf (``series`` ``[B, W]``, ``[B, C, W]`` on committees;
  ``monitors`` ``[B]``) against JAX's ``probed_batched_fn`` leaves, values
  and dtypes;
- armed against disarmed: every lane's final-state digests of the armed run
  equal the port's disarmed run's (the taps draw nothing and only read).

The arms: the PBFT tick engine (lanes in turn), the round path's lane axis
on both stat samplers (under ``"normal"`` a lane's draws follow the first
lane, the series too), the Raft heartbeat path with lanes whose handoffs
differ (a per-lane select of both branches' reduced probes), the Raft tick
engine's lane axis, Paxos (the multi-seed arm), a committee hierarchy (``[C, W]`` series) and a
kregular overlay.  Beside them: the solo entry (``run_probed``), the
monitors on a forged state, ``liveness_lag`` and ``window_bounds``,
``first_divergence`` on a planted perturbation, the flight-recorder hook,
``sample_axis``, and served ``probe`` requests against the JAX server's
answers.  The JAX side of a case is computed once a process.
"""

from __future__ import annotations

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockchain_simulator_tpu.chaos import invariants
from blockchain_simulator_tpu.models import base as jbase
from blockchain_simulator_tpu.obsim import build as jbuild
from blockchain_simulator_tpu.obsim import diverge as jdiverge
from blockchain_simulator_tpu.obsim import host as jhost
from blockchain_simulator_tpu.obsim import schema as jschema
from blockchain_simulator_tpu.obsim import taps as jtaps
from blockchain_simulator_tpu.parallel import sweep as jsweep
from blockchain_simulator_tpu.utils.config import FaultConfig as JFault
from blockchain_simulator_tpu.utils.config import SimConfig as JConfig
from blockchain_simulator_tpu_torch import convert
from blockchain_simulator_tpu_torch.models import base as tbase
from blockchain_simulator_tpu_torch.obsim import build as tbuild
from blockchain_simulator_tpu_torch.obsim import diverge as tdiverge
from blockchain_simulator_tpu_torch.obsim import host as thost
from blockchain_simulator_tpu_torch.obsim import schema as tschema
from blockchain_simulator_tpu_torch.obsim import taps as ttaps
from blockchain_simulator_tpu_torch.parallel import sweep as tsweep
from blockchain_simulator_tpu_torch.utils import obs, telemetry, threefry
from blockchain_simulator_tpu_torch.utils.config import FaultConfig as TFault
from blockchain_simulator_tpu_torch.utils.config import SimConfig as TConfig
from test_torch_pbft import release_jax_executables  # noqa: F401 (autouse fixture)
from test_torch_query import one_torch_thread  # noqa: F401 (autouse fixture)

ROUND = dict(protocol="pbft", n=16, sim_ms=400, delivery="stat", schedule="round",
             model_serialization=False)
# each case: (config, [(fault kwargs, seed) a lane], probe config)
CASES = {
    "pbft_tick": (dict(protocol="pbft", n=8, sim_ms=200, stat_sampler="exact"),
                  [({}, 0), (dict(n_byzantine=1), 1), (dict(n_crashed=2), 2)],
                  dict(windows=16, monitors=True)),
    "pbft_round_exact": (dict(ROUND, stat_sampler="exact"),
                         [({}, 0), (dict(n_crashed=5), 1), (dict(n_crashed=6), 0)],
                         dict(windows=4, monitors=True)),
    "pbft_round_normal": (dict(ROUND, n=4096, sim_ms=460, pbft_max_rounds=8,
                               pbft_max_slots=16),
                          [(dict(n_crashed=1500), 1), ({}, 0)],
                          dict(windows=16, monitors=True)),
    # 9 of 16 crashed elect no leader: that lane's handoff is refused, the
    # other's taken; each keeps its own branch's reduced probes
    "raft_hb": (dict(protocol="raft", n=16, sim_ms=800, delivery="stat", schedule="round",
                     raft_proposal_delay_ms=200, stat_sampler="normal"),
                [({}, 0), (dict(n_crashed=9), 1)], dict(windows=16, monitors=True)),
    "raft_tick": (dict(protocol="raft", n=12, sim_ms=400),
                  [(dict(n_crashed=3), 0), (dict(n_byzantine=2), 1)],
                  dict(windows=8, monitors=False)),
    # the multi-seed arm (solo semantics: JAX's lax.map, the port's lanes in
    # turn); JAX's vmapped Paxos program takes ~20 s to compile here
    "paxos": (dict(protocol="paxos", n=8, sim_ms=160), [({}, 0), (dict(n_crashed=1), 1)],
              dict(windows=16, monitors=True)),
    "committee": (dict(protocol="pbft", n=16, sim_ms=200, stat_sampler="exact",
                       topology="committee", committees=2),
                  [({}, 3)], dict(windows=16, monitors=True)),
    "kregular": (dict(protocol="raft", n=8, sim_ms=200, stat_sampler="exact",
                      topology="kregular", degree=3, fidelity="clean"),
                 [({}, 3), (dict(n_crashed=1), 4)], dict(windows=16, monitors=True)),
}


MULTI_SEED = {"paxos"}


def _points(fc_cls, cfg, lanes):
    return [(cfg.with_(faults=fc_cls(**fc)), s) for fc, s in lanes]


def _leaves(tree, prefix="") -> dict:
    """``{path: numpy array}`` of a (nested) probe dict of either package."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
    return out


@pytest.fixture(scope="module")
def jax_side():
    """``jax_side(name)``: ``(rows, probe leaves)`` of the JAX package for
    one case, computed once a process."""
    memo = {}

    def get(name):
        if name not in memo:
            tpl, lanes, pkw = CASES[name]
            cfg = JConfig(**tpl)
            pcfg = jschema.ProbeConfig(**pkw)
            pts = _points(JFault, cfg, lanes)
            canon = jbase.canonical_fault_cfg(pts[0][0])
            ms = name in MULTI_SEED
            rows = jsweep.run_dyn_points(canon, pts, record=False, probe=pcfg, multi_seed=ms)
            keys = jax.vmap(jax.random.key)(jnp.asarray([s for _, s in pts], jnp.uint32))
            nc = jnp.asarray([c.faults.resolved_n_crashed(c.n) for c, _ in pts], jnp.int32)
            nb = jnp.asarray([c.faults.n_byzantine for c, _ in pts], jnp.int32)
            _, probes = jax.block_until_ready(
                jbuild.probed_batched_fn(canon, pcfg, multi_seed=ms)(keys, nc, nb))
            memo[name] = (rows, _leaves(probes))
        return memo[name]

    return get


class _Recorded:
    """Records the finals and probes of every ``probed_batched_fn`` program
    the port's sweep dispatches."""

    def __enter__(self):
        self.real, self.outs = tbuild.probed_batched_fn, []

        def wrapped(*args, **kw):
            batched = self.real(*args, **kw)

            def run(*a):
                out = batched(*a)
                self.outs.append(out)
                return out
            return run

        tbuild.probed_batched_fn = wrapped
        return self

    def __exit__(self, *exc):
        tbuild.probed_batched_fn = self.real


def _lane_digests(finals, n) -> list:
    leaves = convert.state_to_numpy(finals)
    return [convert.state_digests(convert.lane_leaves(leaves, i)) for i in range(n)]


@pytest.mark.parametrize("name", list(CASES))
def test_armed_rows_and_probes_equal_jax(name, jax_side):
    """Rows and probe leaves equal JAX's; armed finals equal disarmed."""
    jrows, jleaves = jax_side(name)
    tpl, lanes, pkw = CASES[name]
    cfg = TConfig(**tpl)
    pcfg = tschema.ProbeConfig(**pkw)
    pts = _points(TFault, cfg, lanes)
    canon = tbase.canonical_fault_cfg(pts[0][0])
    with _Recorded() as rec:
        rows = tsweep.run_dyn_points(canon, pts, record=False, probe=pcfg, device="cpu",
                                     multi_seed=name in MULTI_SEED)
    assert obs.canonical_json(rows) == obs.canonical_json(jrows)
    (finals, probes), = rec.outs
    tleaves = _leaves(probes)
    assert sorted(tleaves) == sorted(jleaves)
    for k, v in jleaves.items():
        assert tleaves[k].dtype == v.dtype and np.array_equal(tleaves[k], v), k
    disarmed = tsweep.dyn_batched_fn(canon)(
        np.stack([threefry.key(s) for _, s in pts]),
        [c.faults.resolved_n_crashed(c.n) for c, _ in pts],
        [c.faults.n_byzantine for c, _ in pts], torch.device("cpu"))
    assert _lane_digests(finals, len(pts)) == _lane_digests(disarmed, len(pts))
    plain = [tbase.sim_metrics(c, tbase.lane_state(disarmed, i)) for i, (c, _) in enumerate(pts)]
    assert [{k: v for k, v in r.items() if k != "probe"} for r in rows] == plain
    if pcfg.monitors:
        assert invariants.check_consensus_probes(rows) == []


def test_run_probed_solo_equals_jax():
    """``obsim.host.run_probed``: the consobs-solo entry, metrics and
    summary equal JAX's and the metrics the disarmed run's."""
    kw = dict(protocol="pbft", n=8, sim_ms=200, stat_sampler="exact",
              faults=dict(n_byzantine=1))
    jcfg = JConfig(**{**kw, "faults": JFault(**kw["faults"])})
    tcfg = TConfig(**{**kw, "faults": TFault(**kw["faults"])})
    pcfg = dict(windows=5, monitors=True)
    jm, js = jhost.run_probed(jcfg, 4, jschema.ProbeConfig(**pcfg))
    tm, ts = thost.run_probed(tcfg, 4, tschema.ProbeConfig(**pcfg), device="cpu")
    assert obs.canonical_json([tm, ts]) == obs.canonical_json([jm, js])
    from blockchain_simulator_tpu_torch import runner

    assert tm == runner.run_simulation(tcfg, seed=4, device="cpu")


def test_monitors_and_liveness_equal_jax(tmp_path, monkeypatch):
    """The monitors on a forged PBFT state (a quorum granted to a slot no
    leader proposed) fire as JAX's do; the flight hook dumps a
    ``consensus-violation`` post-mortem; ``liveness_lag`` and
    ``window_bounds`` equal JAX's on hand-made series."""
    from blockchain_simulator_tpu_torch import runner

    tcfg = TConfig(protocol="pbft", n=8, sim_ms=200, stat_sampler="exact")
    final = runner.final_state(tcfg, seed=7, device="cpu")
    assert int(ttaps.monitors(tcfg, final)["viol_agreement"]) == 0
    never = np.flatnonzero(final.slot_propose_tick.numpy() == np.iinfo(np.int32).max)
    assert never.size
    commits = final.slot_commits.clone()
    commits[int(never[-1])] = tcfg.n
    forged = dataclasses.replace(final, slot_commits=commits)
    mon = {k: int(v) for k, v in ttaps.monitors(tcfg, forged).items()}
    jcfg = JConfig(protocol="pbft", n=8, sim_ms=200, stat_sampler="exact")
    # JAX's PBFT monitors read four slot and node fields: the forged leaves
    jstate = types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in
                                      convert.state_to_numpy(forged).items()})
    assert mon == {k: int(v) for k, v in jtaps.monitors(jcfg, jstate).items()}
    assert mon["viol_agreement"] >= 1
    monkeypatch.setenv(telemetry.FLIGHT_ENV, str(tmp_path))
    summary = {"protocol": "pbft", "topology": "full",
               "monitors": {**mon, "liveness_lag": 0},
               "violations": mon["viol_agreement"] + mon["viol_quorum"]}
    dump = thost.note_violations(summary, tcfg, seed=7)
    assert dump and os.path.exists(dump)
    assert invariants.check_consensus_probes([summary])
    rng = np.random.default_rng(0)
    for prog in (np.array([0, 1, 1, 1, 2, 2, 2, 2], np.int32), np.zeros(6, np.int32),
                 np.cumsum(rng.integers(0, 2, (3, 9)), axis=1).astype(np.int32)):
        assert np.array_equal(ttaps.liveness_lag(torch.from_numpy(prog)).numpy(),
                              np.asarray(jtaps.liveness_lag(prog)))
    for m, w in ((1, 16), (7, 3), (200, 16), (3999, 7)):
        assert np.array_equal(tschema.window_bounds(m, w), jschema.window_bounds(m, w))


def test_first_divergence_on_planted_perturbation():
    """Identical runs do not diverge; a planted change is located at its
    sample and field, rendered as JAX renders it; a structural mismatch
    raises."""
    cfg = TConfig(protocol="pbft", n=8, sim_ms=200, stat_sampler="exact")
    pcfg = tschema.ProbeConfig(windows=8)
    sim = tbuild.probed_solo_fn(tbase.canonical_fault_cfg(cfg), pcfg)
    _, pa = sim(threefry.key(11), 0, 0, "cpu")
    _, pb = sim(threefry.key(11), 0, 0, "cpu")
    assert tdiverge.first_divergence(pa, pb) is None
    series = {k: v.numpy().copy() for k, v in pb["series"].items()}
    series["msgs_rounds"][5] += 1
    div = tdiverge.first_divergence(pa, {"series": series})
    jdiv = jdiverge.first_divergence(_leaves(pa["series"]), {"series": series})
    assert div == jdiv and div["sample"] == 5 and div["fields"] == ["msgs_rounds"]
    bounds = tschema.window_bounds(cfg.ticks, pcfg.windows)
    out = tdiverge.render(div, t_axis=bounds, unit="window")
    assert out == jdiverge.render(jdiv, t_axis=bounds, unit="window")
    assert "window 5" in out
    with pytest.raises(ValueError):
        tdiverge.first_divergence(pa, {"series": {"nope": series["msgs_rounds"]}})


@pytest.mark.parametrize("kw", [
    dict(protocol="pbft", n=8, sim_ms=200),
    dict(ROUND, n=16),
    dict(protocol="raft", n=16, sim_ms=800, delivery="stat", schedule="round"),
    dict(protocol="paxos", n=64, sim_ms=600, topology="committee", committees=4),
])
def test_sample_axis_equals_jax(kw):
    assert tschema.sample_axis(TConfig(**kw)) == jschema.sample_axis(JConfig(**kw))


def test_serve_probe_requests_equal_jax_server():
    """Served ``probe`` requests: a solo armed request and a batched flush of
    two armed requests answer JAX's ScenarioServer's metrics and summaries;
    an armed and a disarmed request never share a flush; an armed template's
    prewarm builds the consobs-* entries; a bad probe is JAX's typed 400."""
    from blockchain_simulator_tpu.serve import ScenarioServer as JServer
    from blockchain_simulator_tpu.serve import schema as jsschema
    from blockchain_simulator_tpu_torch.serve import ScenarioServer as TServer
    from blockchain_simulator_tpu_torch.serve import schema as tsschema

    base = dict(ROUND, stat_sampler="exact")
    reqs = [dict(base, id="solo", seed=9, probe={"windows": 4})]
    flush = [dict(base, id=f"b{i}", seed=i, probe=True, faults={"n_crashed": i})
             for i in range(2)] + [dict(base, id="plain", seed=1)]

    def served(server_cls, **kw):
        out = {}
        for batch, mb in ((reqs, 1), (flush, 4)):
            srv = server_cls(max_batch=mb, max_wait_ms=1.0, start=False, **kw)
            pends = [srv.submit(r) for r in batch]
            srv.start()
            out.update({r["id"]: p.result(120) for r, p in zip(batch, pends)})
            srv.close()
        return out

    jout, tout = served(JServer), served(TServer, device="cpu")
    for rid, j in jout.items():
        t = tout[rid]
        assert (t["code"], t["batch"]["mode"], t["batch"]["size"]) == \
            (j["code"], j["batch"]["mode"], j["batch"]["size"]) == \
            (200, *(("solo", 1) if rid in ("solo", "plain") else ("batched", 2)))
        assert obs.canonical_json(t["metrics"]) == obs.canonical_json(j["metrics"])
    assert "probe" not in tout["plain"]["metrics"] and "probe" in tout["b0"]["metrics"]
    from blockchain_simulator_tpu_torch.utils import aotcache

    srv = TServer(max_batch=2, start=False, device="cpu")
    assert sorted(srv.prewarm(dict(base, probe={"windows": 3}))) == ["1", "2"]
    srv.close()
    assert {"consobs-solo", "consobs-batched"} <= set(
        aotcache.registry.stats_snapshot()["by_factory"])
    obj = dict(base, probe=True)
    assert tsschema.parse_request(dict(obj, probe={"windows": 4}), "p").probe == \
        tschema.ProbeConfig(windows=4)
    assert tsschema.parse_request(dict(obj, probe=False), "p").probe is None
    for bad in ({"windows": 0}, 7, {"nope": 1}):
        with pytest.raises(tsschema.InvalidRequestError) as te:
            tsschema.parse_request(dict(obj, probe=bad), "bad")
        with pytest.raises(jsschema.InvalidRequestError) as je:
            jsschema.parse_request(dict(obj, probe=bad), "bad")
        assert (te.value.code, str(te.value)) == (je.value.code, str(je.value))
