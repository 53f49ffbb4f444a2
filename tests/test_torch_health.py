"""The port's backend health probe and verdict log (``utils/health.py``),
held to the JAX package's.

The verdict log is shared: ``latest_verdict``, ``append_health`` and
``require_not_wedged`` read and write the same ``HEALTH.jsonl`` as JAX's and
agree on it.  ``probe_backend(device="cpu")`` is healthy with JAX's keys; a
supervised probe past its patience retries, then is ``wedged`` (the
abandon-never-kill rule, as ``tests/test_zchaos.py`` pins JAX's); the
sweeps' health gate fails fast on a fresh ``wedged`` verdict (as
``tests/test_zjournal.py`` pins JAX's).  The CUDA probe is a card test
(``tests/test_torch_card_serve.py``).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from blockchain_simulator_tpu.utils import health as jhealth
from blockchain_simulator_tpu_torch.parallel import sweep as tsweep
from blockchain_simulator_tpu_torch.utils import health as thealth
from blockchain_simulator_tpu_torch.utils.config import SimConfig

from test_torch_pbft import REPO, release_jax_executables  # noqa: F401 (autouse fixture)


def _write(path, verdict, ts=None, **kw):
    rec = {"verdict": verdict, "probe_s": 1.0, "ts": time.time() if ts is None else ts, **kw}
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def test_constants_equal_jax():
    assert (thealth.VERDICTS, thealth.HEALTH_ENV) == (jhealth.VERDICTS, jhealth.HEALTH_ENV)
    assert issubclass(thealth.BackendWedgedError, RuntimeError)


@pytest.mark.parametrize("replica", [None, "r1", "r2"])
def test_latest_verdict_agrees_with_jax(tmp_path, replica):
    """One log, written by both packages (torn lines and foreign records
    included): the same latest verdict, replica filter and all."""
    log = tmp_path / "HEALTH.jsonl"
    _write(log, "healthy")
    jhealth.append_health({"verdict": "sick", "ts": time.time(), "replica": "r1"}, str(log))
    with open(log, "a") as f:
        f.write('{"verdict": "wed\n{"metric": "other"}\n')
    thealth.append_health({"verdict": "wedged", "ts": time.time(), "replica": "r2"}, str(log))
    assert thealth.latest_verdict(str(log), replica=replica) == \
        jhealth.latest_verdict(str(log), replica=replica)
    assert thealth.latest_verdict(str(tmp_path / "missing.jsonl")) is None


def test_require_not_wedged_agrees_with_jax(tmp_path, monkeypatch):
    """Fresh ``wedged`` raises in both; stale or superseded verdicts pass;
    no log, no gate."""
    log = str(tmp_path / "HEALTH.jsonl")
    _write(log, "wedged")
    for mod in (thealth, jhealth):
        with pytest.raises(mod.BackendWedgedError) as ei:
            mod.require_not_wedged(log)
        assert ei.value.verdict["verdict"] == "wedged"
    stale = str(tmp_path / "stale.jsonl")
    _write(stale, "wedged", ts=time.time() - 7200)
    assert thealth.require_not_wedged(stale) == jhealth.require_not_wedged(stale)
    _write(log, "healthy")
    assert thealth.require_not_wedged(log) == jhealth.require_not_wedged(log)
    monkeypatch.delenv(thealth.HEALTH_ENV, raising=False)
    assert thealth.require_not_wedged() is None
    monkeypatch.setenv(thealth.HEALTH_ENV, log)
    assert thealth.require_not_wedged()["verdict"] == "healthy"


def test_append_health_needs_a_path(tmp_path, monkeypatch):
    """No explicit path and no ``$BLOCKSIM_HEALTH_JSONL``: nothing written,
    not even to the run log."""
    monkeypatch.delenv(thealth.HEALTH_ENV, raising=False)
    monkeypatch.setenv("BLOCKSIM_RUNS_JSONL", str(tmp_path / "runs.jsonl"))
    thealth.append_health({"verdict": "healthy"})
    assert not list(tmp_path.iterdir())


def test_probe_backend_on_the_cpu():
    """The in-process probe on the CPU: healthy, JAX's keys, the bf16
    matmul's sum read back (128 * 128 * 128)."""
    rec = thealth.probe_backend(device="cpu", replica="r7")
    assert rec["verdict"] == "healthy" and rec["backend"] == "cpu"
    assert rec["probe_value"] == 128.0 ** 3 and rec["replica"] == "r7"
    jrec = jhealth.probe_backend(platform="cpu")
    assert set(jrec) - {"replica"} <= set(rec)


def test_probe_backend_without_a_card_is_sick(monkeypatch):
    monkeypatch.setattr(torch.cuda, "init", lambda: (_ for _ in ()).throw(
        RuntimeError("no CUDA device")))
    rec = thealth.probe_backend()
    assert rec["verdict"] == "sick" and "no CUDA device" in rec["error"]


def test_supervised_retries_before_wedged():
    """A silent probe is retried with backoff before the wedged verdict;
    the record carries the attempt count, and each silent child is
    abandoned, never killed."""
    t0 = time.monotonic()
    rec = thealth.probe_backend_supervised(patience_s=0.05, attempts=2, backoff_s=0.05,
                                           rng=lambda: 0.5, device="cpu")
    assert rec["verdict"] == "wedged" and rec["attempts"] == 2
    assert rec["supervised"] is True and "abandoned_pid" in rec
    assert time.monotonic() - t0 >= 0.05 * 2 + 0.05


def test_health_cli_on_the_cpu(tmp_path):
    """``python -m blockchain_simulator_tpu_torch.utils.health --device
    cpu``: one JSON verdict line (supervised, healthy), appended to
    ``--log``; exit 0."""
    log = tmp_path / "HEALTH.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "blockchain_simulator_tpu_torch.utils.health", "--device",
         "cpu", "--log", str(log), "--patience", "120"],
        capture_output=True, text=True, timeout=200, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    (line,) = proc.stdout.strip().splitlines()
    rec = json.loads(line)
    assert rec["verdict"] == "healthy" and rec["backend"] == "cpu"
    assert rec["attempts"] == 1 and rec["supervised"] is True
    assert jhealth.latest_verdict(str(log)) == rec
    with pytest.raises(SystemExit):
        thealth.main(["--help"])


def test_sweep_health_gate_fails_fast(tmp_path, monkeypatch):
    """A fresh ``wedged`` verdict stops a fault sweep before any dispatch
    (``BackendWedgedError``); a stale one does not."""
    log = str(tmp_path / "HEALTH.jsonl")
    _write(log, "wedged")
    monkeypatch.setenv(thealth.HEALTH_ENV, log)
    cfg = SimConfig(protocol="pbft", n=8, sim_ms=60)
    with pytest.raises(thealth.BackendWedgedError) as ei:
        tsweep.run_fault_sweep(cfg, [cfg.faults], (0,), device="cpu")
    assert ei.value.verdict["verdict"] == "wedged"
    stale = str(tmp_path / "stale.jsonl")
    _write(stale, "wedged", ts=time.time() - 7200)
    monkeypatch.setenv(thealth.HEALTH_ENV, stale)
    assert len(tsweep.run_fault_sweep(cfg, [cfg.faults], (0,), device="cpu")[cfg.faults]) == 1
