"""The port's probe traces (utils/trace.py), held bit for bit to the JAX package.

Every arm of ``run_traced`` runs the same config and seed through the JAX
package's ``run_traced`` and through the port on the CPU: the series' keys,
dtypes, shapes and values must be equal (tolerance 0), and so must the
metrics.  The probed run's final state must have the digests of the
unprobed one (``runner.final_state``): the probes only read.

Two fallbacks are held to the JAX package's tick arm (``schedule="tick"``)
instead of its traced fallback: JAX's fallback concatenates the probed
prefix and the continuation from its carry, which equals one uninterrupted
probed tick run (tick keys derive from the absolute tick), and the tick arm
compiles one program instead of three.

The goldens that ``chip_smoke.py`` holds the card's traced phases to are
written here from the JAX package on the CPU:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_trace.py --write-golden [ENTRY]
"""

from __future__ import annotations

import json
import pathlib
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

from blockchain_simulator_tpu import runner as jrunner
from blockchain_simulator_tpu.utils import trace as jtrace
from blockchain_simulator_tpu_torch import convert
from blockchain_simulator_tpu_torch import runner as trunner
from blockchain_simulator_tpu_torch.models import pbft_round as tround
from blockchain_simulator_tpu_torch.utils import threefry
from blockchain_simulator_tpu_torch.utils import trace as ttrace
from test_torch_pbft import _cfgs, release_jax_executables  # noqa: F401 (autouse fixture)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "blockchain_simulator_tpu_torch" / "golden" / "trace_s0.json"
WRITTEN_BY = "PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_trace.py --write-golden"

STAT_RAFT = dict(protocol="raft", n=8, delivery="stat", schedule="round")
MIXED = dict(protocol="mixed", n=12, mixed_shards=4, delivery="stat",
             model_serialization=False)
# name: (config, whether the JAX oracle is its tick arm)
CASES = {
    "tick_pbft": (dict(protocol="pbft", n=8, sim_ms=300), False),
    "tick_raft": (dict(protocol="raft", n=8, sim_ms=600), False),
    "tick_paxos": (dict(protocol="paxos", n=8, sim_ms=600), False),
    "kregular": (dict(protocol="pbft", n=12, sim_ms=300, topology="kregular", degree=10,
                      fidelity="clean"), False),
    "round": (dict(protocol="pbft", n=16, sim_ms=600, delivery="stat", schedule="round",
                   model_serialization=False), False),
    "hb_handoff": (dict(STAT_RAFT, sim_ms=1500), False),
    # setProposal fires inside the election prefix: the handoff is refused
    "hb_fallback": (dict(STAT_RAFT, sim_ms=800, raft_proposal_delay_ms=50), True),
    "mixed_fast": (dict(MIXED, sim_ms=800), False),
    # a crashed majority in every shard: every handoff is refused
    "mixed_fallback": (dict(MIXED, sim_ms=600, faults=dict(n_crashed=2)), True),
    "committee": (dict(protocol="pbft", n=16, sim_ms=200, topology="committee",
                       committees=2), False),
}


@pytest.fixture(scope="module")
def runs():
    """``runs(case)``: the JAX package's ``(metrics, series)`` and the
    port's ``(metrics, series, probed final digests)``, computed once a
    process."""
    memo = {}

    def get(case):
        if case not in memo:
            kw, tick_oracle = CASES[case]
            kw = dict(kw)
            jcfg, tcfg = _cfgs(faults=kw.pop("faults", None), **kw)
            jm, js = jtrace.run_traced(jcfg.with_(schedule="tick") if tick_oracle else jcfg)
            final, ts = ttrace.traced_state(tcfg, device="cpu")
            memo[case] = (jm, js, trunner.sim_metrics(tcfg, final), ts,
                          convert.state_digests(convert.state_to_numpy(final)))
        return memo[case]
    return get


def _assert_series_equal(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_traced_run_equals_jax(runs, case):
    jm, js, tm, ts, _ = runs(case)
    assert tm == jm
    _assert_series_equal(js, ts)


@pytest.mark.parametrize("case", sorted(CASES))
def test_probed_state_equals_unprobed(runs, case):
    """The probes only read: the probed run's final state has every digest
    of ``runner.final_state``'s, and ``run_traced``'s metrics are
    ``run_simulation``'s."""
    _, _, tm, ts, digests = runs(case)
    kw = dict(CASES[case][0])
    _, tcfg = _cfgs(faults=kw.pop("faults", None), **kw)
    plain = trunner.final_state(tcfg, device="cpu")
    assert convert.state_digests(convert.state_to_numpy(plain)) == digests
    assert trunner.sim_metrics(tcfg, plain) == tm
    # the arm that ran: fast paths carry a "t" axis, the tick engine none
    assert ("t" in ts) == (case in ("round", "hb_handoff", "mixed_fast", "committee"))


@pytest.mark.parametrize("case", ["round", "committee", "hb_handoff"])
def test_chrome_trace_equals_jax(runs, case, tmp_path):
    """to_chrome_trace writes JAX's event list for the same series."""
    _, js, _, ts, _ = runs(case)
    want = jtrace.to_chrome_trace(js, tmp_path / "jax.json", name=case)
    got = ttrace.to_chrome_trace(ts, tmp_path / "torch.json", name=case)
    assert (got["events"], got["instants"]) == (want["events"], want["instants"])
    assert (json.loads((tmp_path / "torch.json").read_text())
            == json.loads((tmp_path / "jax.json").read_text()))
    for name in sorted(k for k in ts if k != "t" and ts[k].ndim == 1):
        np.testing.assert_array_equal(ttrace.events_from_series(ts, name),
                                      jtrace.events_from_series(js, name))


def test_round_probe_with_no_round_equals_jax():
    """A window shorter than one block interval steps no round: empty series
    of the probe's dtypes, as JAX's zero-length scan gives."""
    jcfg, tcfg = _cfgs(protocol="pbft", n=16, sim_ms=40, delivery="stat", schedule="round",
                       model_serialization=False)
    jm, js = jtrace.run_traced(jcfg)
    tm, ts = ttrace.run_traced(tcfg, device="cpu")
    assert tm == jm
    _assert_series_equal(js, ts)
    assert all(v.shape == (0,) for v in ts.values())


def test_round_probe_callable_and_lanes():
    """A callable ``with_probe`` is the probe (obsim's form); a probed lane
    batch gives one sample a lane, stacked ``[rounds, B]``, lane 0's column
    the solo probed run's."""
    _, tcfg = _cfgs(protocol="pbft", n=16, sim_ms=300, delivery="stat", schedule="round",
                    model_serialization=False)
    key = threefry.key(0)
    state, _ = tround.init(tcfg, threefry.fold_in(key, 0x1217), device="cpu")
    final, ys = tround.scan_rounds(tcfg, state, key,
                                   with_probe=lambda st: {"views": st.view_changes.sum()})
    assert list(ys) == ["views"] and ys["views"].shape == (5,)
    assert int(ys["views"][-1]) == int(final.view_changes.sum())
    lanes = np.stack([threefry.key(0), threefry.key(1)])
    state, _ = tround.init(tcfg, lanes, device="cpu")
    _, lys = tround.scan_rounds(tcfg, state, lanes,
                                with_probe=lambda st: {"views": st.view_changes.sum(-1)})
    assert lys["views"].shape == (5, 2) and torch.equal(lys["views"][:, 0], ys["views"])


def test_run_traced_refuses_like_jax():
    """Ineligible explicit ``schedule='round'`` raises the runner's
    ValueError; C++-only flags the runner's NotImplementedError."""
    for kw, exc in ((dict(protocol="pbft", n=16, sim_ms=200, delivery="edge",
                          schedule="round"), ValueError),
                    (dict(protocol="pbft", n=8, sim_ms=200, echo_back=True),
                     NotImplementedError)):
        jcfg, tcfg = _cfgs(**kw)
        with pytest.raises(exc):
            jtrace.run_traced(jcfg)
        with pytest.raises(exc):
            ttrace.run_traced(tcfg, device="cpu")


def test_profile_run_writes_a_trace(tmp_path):
    """profile_run on the CPU: the warm run under torch.profiler, its
    Chrome trace in ``logdir``, metrics equal to run_simulation's and JAX's
    keys; the committee hierarchy is refused as JAX refuses it."""
    jcfg, tcfg = _cfgs(protocol="pbft", n=8, sim_ms=200)
    m = ttrace.profile_run(tcfg, str(tmp_path), device="cpu")
    assert m.pop("profiled_run_s") > 0 and m.pop("compile_plus_first_run_s") > 0
    assert m == jrunner.run_simulation(jcfg)
    doc = json.loads((tmp_path / ttrace.PROFILE_TRACE).read_text())
    assert doc["traceEvents"]
    _, ccfg = _cfgs(protocol="pbft", n=8, sim_ms=200, topology="committee", committees=2)
    with pytest.raises(NotImplementedError, match="committee"):
        ttrace.profile_run(ccfg, str(tmp_path), device="cpu")


def test_run_traced_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs(protocol="pbft", n=8, sim_ms=100)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrace.run_traced(tcfg)


# --------------------------------------------------------------------------- #
# goldens for chip_smoke.py's traced phases                                   #
# --------------------------------------------------------------------------- #

# the headline's flags (bench._cfg, bench.py:219-241), cut to 500 rounds
CLI_ROUND = ["--protocol", "pbft", "--n", "100000", "--delivery", "stat",
             "--serialization", "off", "--pbft-window", "8", "--sim-ms", "25100",
             "--pbft-rounds", "500", "--pbft-max-slots", "508"]
# BASELINE config 2 (golden/pbft_edge_s0.json n1000) on the tick engine
CLI_TICK = ["--protocol", "pbft", "--n", "1000", "--sim-ms", "2500", "--schedule", "tick"]
# the committee row's knobs (tools/topo_bench.py) at 10 committees of 500
COMMITTEE_KW = dict(fidelity="clean", schedule="tick", model_serialization=False,
                    link_delay_ms=1, pbft_delay_lo=1, pbft_delay_hi=3, pbft_window=8,
                    protocol="pbft", n=5000, sim_ms=150, topology="committee",
                    committees=10, delivery="stat", stat_sampler="normal")
TRACED = {
    "trace_hb": dict(protocol="raft", n=1000, sim_ms=10_000, delivery="stat",
                     schedule="round"),
    # BASELINE config 5's knobs (tools/run_config5.py) at 16 shards
    "trace_mixed": dict(protocol="mixed", n=16_000, mixed_shards=16, sim_ms=3000,
                        delivery="stat", model_serialization=False),
    "trace_committee": COMMITTEE_KW,
}
PLAIN = {
    "profile": dict(protocol="pbft", n=1000, sim_ms=200),
    "entry": dict(protocol="pbft", n=8, sim_ms=600),
}
ENTRY_ARGV = ["--protocol", "pbft", "--n", "8", "--sim-ms", "600", "--timing"]


def series_summary(series: dict) -> dict:
    """What a golden keeps of a series dict: each array's sha256
    (convert.digest: dtype, shape and bytes), dtype, shape and last value."""
    return {k: {"sha256": convert.digest(v), "dtype": str(v.dtype), "shape": list(v.shape),
                "last": v[..., -1].tolist() if v.size else None}
            for k, v in sorted(series.items())}


def _cli_entry(argv: list) -> dict:
    """The JAX package's CLI with ``--trace``: its metrics (the line without
    the trace and manifest fields) and its series."""
    import contextlib
    import io

    from blockchain_simulator_tpu import cli as jcli

    with tempfile.TemporaryDirectory() as d:
        path = str(pathlib.Path(d) / "series.npz")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert jcli.main(argv + ["--trace", path]) == 0
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        series = dict(np.load(path))
    return {"argv": argv, "config_hash": line["manifest"]["config_hash"],
            "metrics": {k: v for k, v in line.items()
                        if k not in ("manifest", "trace_file", "trace_series", "seed")},
            "series": series_summary(series)}


def golden_entry(name: str) -> dict:
    from blockchain_simulator_tpu.utils import config as jconfig

    if name == "cli_trace_round":
        entry = _cli_entry(CLI_ROUND)
    elif name == "cli_trace_tick":
        entry = _cli_entry(CLI_TICK)
    elif name in TRACED:
        kw = TRACED[name]
        m, series = jtrace.run_traced(jconfig.SimConfig(**kw))
        entry = {"config": kw, "metrics": m, "series": series_summary(series)}
    else:
        kw = PLAIN[name]
        entry = {"config": kw, "metrics": jrunner.run_simulation(jconfig.SimConfig(**kw))}
        if name == "entry":
            entry["argv"] = ENTRY_ARGV
    return dict(entry, seed=0, jax_version=jax.__version__)


ENTRIES = ("cli_trace_round", "cli_trace_tick", *TRACED, *PLAIN)


def write_golden(only: str | None = None):
    doc = (json.loads(GOLDEN.read_text()) if GOLDEN.exists()
           else {"about": "JAX package (blockchain_simulator_tpu) results that the PyTorch "
                          "port's traced phases must reproduce bit for bit: metrics, and "
                          "each probe series' sha256 (convert.digest), dtype, shape and last "
                          f"value. Written by: {WRITTEN_BY}", "entries": {}})
    for name in ENTRIES:
        if only is None or name == only:
            doc["entries"][name] = golden_entry(name)
            GOLDEN.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
            print(f"wrote {name} to {GOLDEN}", flush=True)


def test_trace_golden_holds_the_phases_configs():
    """The golden chip_smoke.py holds the card to: every entry, written by
    the JAX package from the configs above; the traced tick run reaches
    config 2's milestone and the heartbeat run its golden's."""
    doc = json.loads(GOLDEN.read_text())
    assert WRITTEN_BY in doc["about"] and sorted(doc["entries"]) == sorted(ENTRIES)
    entries = doc["entries"]
    assert entries["cli_trace_round"]["argv"] == CLI_ROUND
    assert entries["cli_trace_tick"]["argv"] == CLI_TICK
    for name, kw in {**TRACED, **PLAIN}.items():
        assert entries[name]["config"] == kw and entries[name]["seed"] == 0
    edge = json.loads((GOLDEN.parent / "pbft_edge_s0.json").read_text())["entries"]["n1000"]
    assert entries["cli_trace_tick"]["metrics"] == edge["metrics"]
    hb = json.loads((GOLDEN.parent / "raft_hb_n1000_s0.json").read_text())["entries"]["n1000"]
    assert entries["trace_hb"]["metrics"] == hb["metrics"]
    assert "t" in entries["trace_hb"]["series"]  # the handoff was taken
    rnd = entries["cli_trace_round"]
    assert rnd["metrics"]["blocks_final_all_nodes"] == 500
    assert rnd["series"]["t"]["shape"] == [501]
    assert entries["trace_committee"]["series"]["rounds_sent"]["shape"] == [10, 150]


def test_trace_golden_entry_run_equals_live_jax():
    """The entry phase's golden metrics are a live JAX run's, and the
    port's on the CPU."""
    entry = json.loads(GOLDEN.read_text())["entries"]["entry"]
    jcfg, tcfg = _cfgs(**entry["config"])
    assert jrunner.run_simulation(jcfg) == entry["metrics"]
    assert trunner.run_simulation(tcfg, device="cpu") == entry["metrics"]


if __name__ == "__main__":
    args = sys.argv[1:]
    if not args or args[0] != "--write-golden" or len(args) > 2:
        sys.exit("usage: python tests/test_torch_trace.py --write-golden [ENTRY]")
    jax.config.update("jax_platforms", "cpu")
    write_golden(args[1] if len(args) == 2 else None)
