"""The port's telemetry (``utils/telemetry.py``), executable registry
(``utils/aotcache.py``), chaos hooks (``chaos/inject.py``) and the run
manifest's ``cache`` / ``telemetry`` blocks, held to the JAX package's.

The same observations give the same Prometheus exposition text, snapshot
and percentiles; trace headers round-trip across the packages; the same
spans and probe series give the same Chrome-trace JSON; the same registry
call sequence gives the same hits, misses and evictions.  An armed
``profile_region`` writes a ``torch.profiler`` Chrome trace on the CPU.
No simulation runs here.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from blockchain_simulator_tpu.chaos import inject as jinject
from blockchain_simulator_tpu.utils import aotcache as jaot
from blockchain_simulator_tpu.utils import obs as jobs
from blockchain_simulator_tpu.utils import telemetry as jtel
from blockchain_simulator_tpu_torch.chaos import inject as tinject
from blockchain_simulator_tpu_torch.utils import aotcache as taot
from blockchain_simulator_tpu_torch.utils import obs as tobs
from blockchain_simulator_tpu_torch.utils import telemetry as ttel


def _observe(mod):
    """One fixed sequence of instrument operations on a fresh registry."""
    reg = mod.MetricsRegistry()
    reg.counter("blocksim_serve_received_total").inc()
    reg.counter("blocksim_serve_answered_total", outcome="served").inc(3)
    reg.counter("blocksim_serve_rejected_total", kind="queue-full").inc()
    reg.gauge("blocksim_serve_queue_depth").set(4)
    h = reg.histogram("blocksim_serve_request_ms")
    for v in (0.4, 1.0, 3.2, 3.2, 17.0, 260.0, 999.9, 45_000.0):
        h.observe(v)
    reg.histogram("blocksim_serve_dispatch_ms", bounds=(1.0, 10.0), replica="r1").observe(5.5)
    return reg, h


def test_exposition_snapshot_and_percentiles_equal_jax():
    (jreg, jh), (treg, th) = _observe(jtel), _observe(ttel)
    assert treg.exposition() == jreg.exposition()
    assert treg.snapshot() == jreg.snapshot()
    assert treg.manifest()["counters"] == jreg.manifest()["counters"]
    for q in (0.0, 1.0, 25.0, 50.0, 90.0, 95.0, 99.0, 100.0):
        assert th.percentile(q) == jh.percentile(q)
    assert th.percentiles() == jh.percentiles()
    assert ttel.DEFAULT_MS_BUCKETS == jtel.DEFAULT_MS_BUCKETS
    assert (ttel.TRACE_HEADER, ttel.SPANS_ENV, ttel.FLIGHT_ENV, ttel.PROFILE_ENV) == (
        jtel.TRACE_HEADER, jtel.SPANS_ENV, jtel.FLIGHT_ENV, jtel.PROFILE_ENV)
    with pytest.raises(ValueError):
        ttel.Histogram("x", {}, None, bounds=(2.0, 1.0))


@pytest.mark.parametrize("value", ["0123abcd89ef0123:89abcdef", " ab:cd ", "abc", "",
                                   "zz:12", ":12", None, 17])
def test_trace_header_round_trip_across_packages(value):
    t, j = ttel.parse_header(value), jtel.parse_header(value)
    assert (t is None) == (j is None)
    if t is not None:
        assert (t.trace_id, t.span_id) == (j.trace_id, j.span_id)
        assert ttel.parse_header(j.header()) == t
        assert jtel.parse_header(t.header()) == j


def test_spans_and_chrome_trace_equal_jax(tmp_path):
    """Spans carry JAX's record keys; the same span records and probe
    series give byte-equal Chrome-trace files."""
    with ttel.capture() as tspans, ttel.span("serve.request", id="r1"):
        with ttel.span("serve.dispatch", mode="batched"):
            pass
    with jtel.capture() as jspans, jtel.span("serve.request", id="r1"):
        with jtel.span("serve.dispatch", mode="batched"):
            pass
    assert [sorted(s) for s in tspans] == [sorted(s) for s in jspans]
    assert [(s["name"], s.get("attrs")) for s in tspans] == [(s["name"], s.get("attrs"))
                                                            for s in jspans]
    child, root = tspans
    assert child["parent"] == root["id"] and child["trace"] == root["trace"]
    series = {"rounds_sent": np.array([0, 1, 1, 2, 3], np.int32),
              "view_changes": np.array([0, 0, 1, 1, 1], np.int32),
              "t": np.arange(5) * 50}
    tp, jp = tmp_path / "t.json", tmp_path / "j.json"
    assert ttel.spans_to_chrome_trace(jspans, tp, series=series) == \
        dict(jtel.spans_to_chrome_trace(jspans, jp, series=series), path=str(tp))
    assert json.loads(tp.read_text()) == json.loads(jp.read_text())


def test_flight_recorder_dump(tmp_path, monkeypatch):
    """The flight recorder keeps a bounded ring and dumps JAX's document
    (atomically, pruned to ``$BLOCKSIM_FLIGHT_KEEP``) only when armed."""
    rec = ttel.FlightRecorder(capacity=3)
    for i in range(5):
        rec.note("tick", i=i)
    assert [r["i"] for r in rec.snapshot()] == [2, 3, 4]
    assert rec.dump("shutdown") is None
    monkeypatch.setenv(ttel.FLIGHT_ENV, str(tmp_path))
    monkeypatch.setenv(ttel.FLIGHT_KEEP_ENV, "2")
    paths = [rec.dump("shutdown") for _ in range(3)]
    kept = sorted(p.name for p in tmp_path.iterdir())
    assert len(kept) == 2 and all(p and p.endswith(".json") for p in paths)
    doc = json.loads(open(paths[-1]).read())
    jdoc = json.loads(open(jtel.FlightRecorder().dump("x", str(tmp_path / "j.json"))).read())
    assert sorted(doc) == sorted(jdoc) and doc["reason"] == "shutdown"


def test_profile_region_writes_a_chrome_trace_on_the_cpu(tmp_path, monkeypatch):
    """Disarmed, nothing is written; armed, one ``<name>-<k>/trace.json``
    a region, holding the region's CPU ops; a nested region is skipped."""
    with ttel.profile_region("off"):
        torch.ones(4).sum()
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv(ttel.PROFILE_ENV, str(tmp_path))
    with ttel.profile_region("serve_flush"):
        with ttel.profile_region("sweep_dispatch"):  # nested: skipped
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    (d,) = list(tmp_path.iterdir())
    assert d.name.startswith("serve_flush-")
    doc = json.loads((d / ttel.PROFILE_TRACE).read_text())
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])


def _registry_calls(mod):
    reg = mod.ExecutableRegistry(maxsize=2)
    built = []

    def build(*args, **kw):
        built.append((args, tuple(sorted(kw.items()))))
        return ("built", args)

    for args, kw in [((1,), {}), ((1,), {}), ((2,), {"k": 1}), ((3,), {}), ((1,), {}),
                     ((3,), {}), ((2,), {"k": 1})]:
        reg.get("fac-a" if args[0] != 3 else "fac-b", args, kw, build)
    reg.clear("fac-b")
    return reg, built


def test_registry_stats_equal_jax(monkeypatch):
    """The same call sequence on a dummy factory: the same builds, hits,
    misses, evictions, entries and snapshots as JAX's registry; the disk
    layer stays 0 and null, and its functions raise naming the CUDA-graph
    work."""
    monkeypatch.delenv(jaot.PERSIST_ENV, raising=False)
    (treg, tb), (jreg, jb) = _registry_calls(taot), _registry_calls(jaot)
    assert tb == jb
    assert treg.stats() == jreg.stats()
    assert treg.stats_snapshot() == jreg.stats_snapshot()
    assert treg.manifest() == jreg.manifest()
    assert treg.stats()["evictions"] == 3 and treg.stats()["persistent_dir"] is None
    for fn in (taot.persistent_dir, taot.enable_xla_cache, lambda: taot.cost_of(None),
               lambda: taot.aot_compile("x", None, ()), lambda: taot.aot_cached("x", None, ())):
        with pytest.raises(NotImplementedError, match="CUDA-graph"):
            fn()


def test_cached_factory_and_the_ports_factories():
    """``cached_factory`` memoizes by arguments and clears one factory at a
    time; the port registers its step-program factories under JAX's names."""
    from blockchain_simulator_tpu_torch import runner
    from blockchain_simulator_tpu_torch.parallel import sweep
    from blockchain_simulator_tpu_torch.serve import dispatch
    from blockchain_simulator_tpu_torch.utils import trace
    from blockchain_simulator_tpu_torch.utils.config import SimConfig

    calls = []

    @taot.cached_factory("test-dummy")
    def fac(x):
        calls.append(x)
        return object()

    assert fac(1) is fac(1) and fac(2) is not fac(1) and calls == [1, 2]
    fac.cache_clear()
    fac(1)
    assert calls == [1, 2, 1] and fac.__wrapped__(5) is not fac(5)
    cfg = SimConfig(protocol="pbft", n=8, sim_ms=60)
    for f, args in [(runner.make_sim_fn, (cfg,)), (runner.make_segment_fn, (cfg, 10)),
                    (trace._tick_traced_fn, (cfg,)), (sweep._batched_fn, (cfg,)),
                    (sweep.dyn_batched_fn, (cfg,)), (sweep.multi_seed_fn, (cfg, 2)),
                    (dispatch._solo_fn, (cfg,))]:
        assert f(*args) is f(*args)
    names = set(taot.registry.stats_snapshot()["by_factory"])
    assert {"sim", "segment", "trace-tick", "sweep-batched", "sweep-batched-dynf",
            "multi-seed-tick", "serve-solo"} <= names


def test_manifest_blocks_carry_jax_keys():
    """The run manifest's ``cache`` block always, and its ``telemetry``
    block once the process has counted something, with JAX's keys."""
    assert set(tobs.manifest()["cache"]) == set(jobs.manifest()["cache"])
    ttel.metrics.counter("blocksim_test_manifest_total").inc()
    jtel.metrics.counter("blocksim_test_manifest_total").inc()
    assert set(tobs.manifest()["telemetry"]) == set(jobs.manifest()["telemetry"])


def test_chaos_schedule_equals_jax():
    """The same armed actions and firings give the same fault schedule and
    the same exceptions (counted firings, poison by request id)."""
    def drive(mod):
        out = []
        with mod.controller(3) as ctl:
            ctl.fail_next("sweep.dyn_dispatch", n=2)
            ctl.poison("serve.solo_dispatch", "bad")
            ctl.slow_next("serve.batcher", 0.0)
            for site, ctx in [("sweep.dyn_dispatch", {}), ("serve.solo_dispatch",
                                                           {"req_id": "ok"}),
                              ("serve.solo_dispatch", {"req_id": "bad"}),
                              ("sweep.dyn_dispatch", {}), ("sweep.dyn_dispatch", {}),
                              ("serve.batcher", {})]:
                try:
                    mod.chaos_point(site, **ctx)
                    out.append("pass")
                except mod.ChaosFault as e:
                    out.append(type(e).__name__)
            sched = ctl.schedule()
        mod.chaos_point("sweep.dyn_dispatch")  # disarmed: free
        return out, sched

    assert drive(tinject) == drive(jinject)
