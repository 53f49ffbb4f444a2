"""The port's command line (``python -m blockchain_simulator_tpu_torch``,
cli.py), held to the JAX package's on the cases of tests/test_cli.py and
tests/test_trace.py's CLI tests.

Each case runs the same flags through both CLIs in this process, the port
with ``--device cpu``: the exit codes must be equal, and so must the
metrics lines apart from the manifest's backend fields (the config hash
included) and the trace file's name; ``--trace`` files must hold JAX's
arrays, dtypes included.  ``--shards`` > 1 runs node-sharded over gloo
ranks on the CPU (parallel/multihost.py) and prints JAX's line; with
``--trace`` it exits 2, as JAX's does.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from blockchain_simulator_tpu import cli as jcli
from blockchain_simulator_tpu.utils import trace as jtrace
from blockchain_simulator_tpu_torch import cli as tcli
from blockchain_simulator_tpu_torch.utils import obs as tobs
from blockchain_simulator_tpu_torch.utils import trace as ttrace
from test_torch_multihost import rank_slots
from test_torch_obs import BACKEND_FIELDS
from test_torch_pbft import _cfgs, release_jax_executables, REPO  # noqa: F401 (autouse fixture)

TIMING = ("wallclock_s", "compile_plus_first_run_s", "run_s", "rounds_per_s", "trace_file")


def _lines(capsys):
    captured = capsys.readouterr()
    return [json.loads(line) for line in captured.out.strip().splitlines()], captured.err


def _comparable(line: dict) -> dict:
    """A metrics line without its timings, trace path and backend fields."""
    out = {k: v for k, v in line.items() if k not in TIMING and k != "manifest"}
    out["manifest"] = {k: v for k, v in line["manifest"].items()
                       if k not in BACKEND_FIELDS and k not in TIMING}
    return out


def run_both(capsys, *argv, device=("--device", "cpu")):
    """``(rc, jax lines, port lines, port stderr)``; the exit codes equal."""
    rc_j = jcli.main(list(argv))
    jlines, _ = _lines(capsys)
    rc_t = tcli.main(list(argv) + list(device))
    tlines, err = _lines(capsys)
    assert rc_t == rc_j, err
    return rc_t, jlines, tlines, err


def assert_same_lines(capsys, *argv):
    rc, jlines, tlines, err = run_both(capsys, *argv)
    assert rc == 0, err
    assert [_comparable(m) for m in tlines] == [_comparable(m) for m in jlines]
    return tlines


def test_defaults_match_jax():
    jargs, targs = jcli.build_parser().parse_args([]), tcli.build_parser().parse_args([])
    assert tobs.config_hash(tcli.config_from_args(targs)) == tobs.config_hash(
        jcli.config_from_args(jargs))
    assert (targs.engine, targs.device, targs.shards) == ("torch", "cuda", 0)
    cfg = tcli.config_from_args(targs)
    assert cfg.protocol == "pbft" and cfg.n == 8 and cfg.sim_ms == 10_000


CASES = {
    "torch_engine_run": ["--protocol", "pbft", "--sim-ms", "800", "--pbft-rounds", "10"],
    "cpp_engine_run": ["--protocol", "raft", "--engine", "cpp", "--sim-ms", "6000",
                       "--serialization", "off"],
    "cpp_seed_sweep": ["--protocol", "paxos", "--engine", "cpp", "--seeds", "0", "1", "2",
                       "--sim-ms", "4000"],
    "cpp_fault_flags": ["--protocol", "pbft", "--engine", "cpp", "--crash", "4",
                        "--sim-ms", "600"],
    "cpp_fidelity_flags": ["--protocol", "pbft", "--engine", "cpp", "--sim-ms", "2600",
                           "--pbft-rounds", "10", "--echo-back", "--queued-links"],
    "cpp_paxos_client": ["--protocol", "paxos", "--engine", "cpp", "--sim-ms", "6000",
                         "--paxos-client", "2", "2000"],
    "raft_gossip": ["--protocol", "raft", "--n", "64", "--sim-ms", "3000", "--topology",
                    "gossip", "--delivery", "stat", "--degree", "8"],
    "seed_sweep": ["--protocol", "pbft", "--n", "8", "--sim-ms", "300", "--seeds", "0", "1"],
    "byz_sweep": ["--protocol", "pbft", "--n", "8", "--sim-ms", "300", "--byz-sweep"],
    "timing": ["--protocol", "pbft", "--n", "8", "--sim-ms", "600", "--timing"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_lines_equal_jax(capsys, case):
    lines = assert_same_lines(capsys, *CASES[case])
    assert all(m["manifest"]["obs_schema"] == 1 for m in lines)
    if case == "timing":
        (m,) = lines
        assert m["wallclock_s"] > 0 and m["ticks"] == 600
        assert m["manifest"]["rounds_per_s"] > 0
    if case == "byz_sweep":
        assert [m["f"] for m in lines] == [0, 1, 2]


@pytest.mark.parametrize("argv, err", [
    (["--protocol", "pbft", "--echo-back"], "echo"),
    (["--protocol", "mixed", "--n", "64", "--queued-links"], "queued_links"),
    (["--protocol", "pbft", "--queued-links", "--pbft-window", "4"], "exact vote table"),
    (["--protocol", "paxos", "--paxos-client", "5", "0", "--paxos-proposers", "3"],
     "proposer lane"),
    (["--protocol", "pbft", "--echo-back", "--trace", "x.npz"], "echo"),
    (["--protocol", "pbft", "--schedule", "round", "--trace", "x.npz"], "schedule='round'"),
    (["--protocol", "pbft", "--profile", "logs", "--seeds", "0", "1"], "single-seed"),
    (["--protocol", "mixed", "--engine", "cpp"], "mixed"),
    (["--protocol", "pbft", "--engine", "cpp", "--topology", "gossip"], "full mesh"),
    (["--protocol", "pbft", "--engine", "cpp", "--byz-sweep"], "byz-sweep"),
    (["--protocol", "pbft", "--engine", "cpp", "--trace", "x.npz"], "trace"),
    (["--protocol", "pbft", "--engine", "cpp", "--shards", "2"], "shards"),
])
def test_refusals_exit_2_like_jax(capsys, argv, err):
    rc, _, tlines, msg = run_both(capsys, *argv)
    assert rc == 2 and tlines == [] and err in msg


@pytest.mark.parametrize("argv", [
    ["--protocol", "pbft", "--n", "16", "--shards", "4", "--sim-ms", "400"],
    ["--protocol", "pbft", "--n", "16", "--shards", "4", "--trace", "x.npz"],
])
def test_shards_exit_2_naming_slice_6(capsys, argv):
    """``--shards 4`` runs now (4 gloo ranks on the CPU) and prints the JAX
    command line's ``--shards 4`` line; with ``--trace`` both exit 2."""
    if "--trace" in argv:
        rc, _, tlines, msg = run_both(capsys, *argv)
        assert rc == 2 and tlines == [] and "unsharded" in msg
    else:
        with rank_slots(4):
            assert_same_lines(capsys, *argv)


def test_bad_protocol_rejected():
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(["--protocol", "pow"])


def test_no_device_flag_means_the_card(monkeypatch):
    """Without --device the torch engine runs on CUDA or raises; it never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--protocol", "pbft", "--sim-ms", "100"])


def test_cli_trace_multi_seed_writes_jax_files(capsys, tmp_path):
    """--trace with --seeds: one FILE.<seed>.npz and one line a seed, each
    file holding the JAX CLI's arrays."""
    argv = ["--protocol", "pbft", "--n", "8", "--sim-ms", "600", "--seeds", "3", "4"]
    rc_j = jcli.main(argv + ["--trace", str(tmp_path / "jax.npz")])
    jlines, _ = _lines(capsys)
    rc_t = tcli.main(argv + ["--trace", str(tmp_path / "torch.npz"), "--device", "cpu"])
    tlines, _ = _lines(capsys)
    assert rc_j == rc_t == 0
    assert [_comparable(m) for m in tlines] == [_comparable(m) for m in jlines]
    for seed, m in zip([3, 4], tlines):
        assert m["seed"] == seed and m["trace_file"] == str(tmp_path / f"torch.{seed}.npz")
        want, got = np.load(tmp_path / f"jax.{seed}.npz"), np.load(m["trace_file"])
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_cli_trace_committee_stacked(capsys, tmp_path):
    argv = ["--protocol", "pbft", "--n", "8", "--sim-ms", "300", "--topology", "committee",
            "--committees", "2"]
    assert jcli.main(argv + ["--trace", str(tmp_path / "jax.npz")]) == 0
    assert tcli.main(argv + ["--trace", str(tmp_path / "torch.npz"), "--device", "cpu"]) == 0
    jline, tline = _lines(capsys)[0]
    assert _comparable(tline) == _comparable(jline)
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "torch.npz")
    for k in want.files:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert got["rounds_sent"].shape == (2, 300)


def test_cli_profile_on_the_cpu(capsys, tmp_path):
    _, tcfg = _cfgs(protocol="pbft", n=8, sim_ms=200)
    assert tcli.main(["--protocol", "pbft", "--sim-ms", "200", "--profile", str(tmp_path),
                      "--device", "cpu"]) == 0
    (m,), _ = _lines(capsys)
    assert m["profile_dir"] == str(tmp_path) and m["profiled_run_s"] > 0
    assert (tmp_path / ttrace.PROFILE_TRACE).exists()
    plain = ttrace.run_traced(tcfg, device="cpu")[0]
    assert {k: m[k] for k in plain} == plain


def test_cli_run_log_one_record_a_run(capsys, monkeypatch, tmp_path):
    """With $BLOCKSIM_RUNS_JSONL set, a plain run appends its line once and
    a seed sweep one row a seed (the printed lines do not append again)."""
    path = tmp_path / "runs.jsonl"
    monkeypatch.setenv(tobs.RUNS_ENV, str(path))
    argv = ["--protocol", "pbft", "--n", "8", "--sim-ms", "200", "--device", "cpu"]
    assert tcli.main(argv) == 0
    assert tcli.main(argv + ["--seeds", "0", "1"]) == 0
    lines, _ = _lines(capsys)
    log = tobs.read_jsonl(str(path))
    assert len(log) == 3 and [r.get("seed") for r in log] == [None, 0, 1]
    assert log[0] == lines[0]


def test_module_entry_point_traces(tmp_path):
    """``python -m blockchain_simulator_tpu_torch ... --trace``: exit 0, the
    line names the file, and the file holds JAX's per-tick series."""
    out = tmp_path / "series.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "blockchain_simulator_tpu_torch", "--protocol", "pbft",
         "--n", "8", "--sim-ms", "1200", "--trace", str(out), "--device", "cpu"],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    m = json.loads(proc.stdout.strip().splitlines()[-1])
    assert m["trace_file"] == str(out)
    jcfg, _ = _cfgs(protocol="pbft", n=8, sim_ms=1200)
    want, got = jtrace.run_traced(jcfg)[1], np.load(out)
    assert len(got["rounds_sent"]) == 1200
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
