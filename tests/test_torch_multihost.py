"""Many-rank execution of the PyTorch port (parallel/multihost.py), against
``tests/test_multihost.py``.

- Four processes started by hand through ``multihost.main`` (a TCP
  rendezvous, gloo on the CPU) equal the launcher's four-rank run and the
  JAX package's ``run_sharded`` over four virtual devices, bit for bit.
- ``--shards 4 --device cpu`` on the port's command line prints the JAX
  command line's ``--shards 4`` line.
- ``--shards 2 --device cuda`` without two cards exits non-zero before any
  rank starts, and the launcher refuses such a group without starting one.
- A rank that fails fails the run, and a rank that hangs in a collective
  fails it within the group's timeout.
- The sharded modules import nothing of JAX.

The rank jobs live in this file, which imports JAX only inside its tests.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import subprocess
import sys
import time

import pytest

from blockchain_simulator_tpu_torch.parallel import multihost
from blockchain_simulator_tpu_torch.utils.config import SimConfig

REPO = pathlib.Path(__file__).resolve().parent.parent

# tests/test_multihost.py's first case
KW = dict(protocol="pbft", n=32, sim_ms=1200, delivery="edge")

# rank processes the suite's workers run at once, over all of them: two
# groups of four (a rank mostly waits on its peers: ~1/3 of a CPU each)
RANK_SLOTS = 8


@contextlib.contextmanager
def rank_slots(n: int):
    """Hold ``n`` of the :data:`RANK_SLOTS` machine-wide slots while a
    group of ``n`` rank processes runs: all of them or none (``flock`` on
    files in the temporary directory, which every xdist worker shares),
    so concurrent workers never run more than eight ranks at once and the
    suite's deadline-bound drills keep their CPUs."""
    import fcntl
    import tempfile

    n = min(int(n), RANK_SLOTS)
    paths = [os.path.join(tempfile.gettempdir(), f"blocksim-rank-slot-{i}.lock")
             for i in range(RANK_SLOTS)]
    while True:
        held = []
        for path in paths:
            f = open(path, "a")
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except BlockingIOError:
                f.close()
                continue
            held.append(f)
            if len(held) == n:
                break
        if len(held) == n:
            break
        for f in held:
            f.close()  # closing releases the lock
        time.sleep(0.2)
    try:
        yield
    finally:
        for f in held:
            f.close()


@pytest.fixture(autouse=True)
def release_jax_executables():
    """Free JAX's compiled programs once the process nears its mapping
    limit (tests/jax_mappings.py)."""
    yield
    import jax_mappings

    jax_mappings.release_if_high()


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO))


def _jax_metrics(kw: dict, n_shards: int) -> dict:
    import jax

    from blockchain_simulator_tpu.parallel.mesh import make_mesh
    from blockchain_simulator_tpu.parallel.shard import run_sharded
    from blockchain_simulator_tpu.utils.config import SimConfig as JSimConfig

    return run_sharded(JSimConfig(**kw), make_mesh(n_node_shards=n_shards,
                                                   devices=jax.devices()[:n_shards]))


def test_four_processes_through_main_equal_launcher_and_jax():
    port = multihost.free_port()
    args = ["--protocol", KW["protocol"], "--n", str(KW["n"]), "--sim-ms", str(KW["sim_ms"]),
            "--delivery", KW["delivery"]]
    with rank_slots(4):
        procs = [subprocess.Popen(
            [sys.executable, "-m", "blockchain_simulator_tpu_torch.parallel.multihost",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "4",
             "--process-id", str(i), "--device", "cpu", "--group-timeout-s", "120", *args],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(), cwd=REPO)
            for i in range(4)]
        outs = []
        try:
            for i, p in enumerate(procs):
                out, err = p.communicate(timeout=280)
                assert p.returncode == 0, f"process {i} failed:\n{err[-3000:]}"
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        launched = multihost.launch(multihost.run_sharded_multihost, 4,
                                    args=(SimConfig(**KW),), device="cpu")
    line = json.loads([ln for ln in outs[0].splitlines() if ln.startswith("{")][-1])
    assert all(not o.strip() for o in outs[1:])  # rank 0 prints, the others do not
    assert (line.pop("process_count"), line.pop("device_count")) == (4, 4)
    assert all(m == line for m in launched)
    assert line == _jax_metrics(KW, 4)


def test_cli_shards_prints_the_jax_line(capsys):
    from blockchain_simulator_tpu import cli as jcli
    from blockchain_simulator_tpu_torch import cli as tcli
    from test_torch_cli import _comparable

    # two ranks here; tests/test_torch_cli.py runs --shards 4
    argv = ["--protocol", "pbft", "--n", "16", "--sim-ms", "200", "--delivery", "stat",
            "--shards", "2"]
    assert jcli.main(argv) == 0
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with rank_slots(2):
        assert tcli.main(argv + ["--device", "cpu"]) == 0
    tline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _comparable(tline) == _comparable(jline)


def test_cuda_shards_without_the_cards_exit_before_any_rank(monkeypatch):
    import torch

    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    out = subprocess.run(
        [sys.executable, "-m", "blockchain_simulator_tpu_torch", "--protocol", "pbft",
         "--n", "16", "--sim-ms", "200", "--shards", str(n_cards + 2), "--device", "cuda"],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=120)
    assert out.returncode != 0 and out.stdout == ""

    def no_rank(*a, **k):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(subprocess, "Popen", no_rank)
    with pytest.raises(RuntimeError, match="no fallback"):
        multihost.launch(multihost.run_sharded_multihost, n_cards + 2,
                         args=(SimConfig(**KW),), device="cuda")


# ------------------------------------------------------------ failures -----


def failing_job() -> str:
    """Rank 1 raises; rank 0 waits in a collective for it."""
    import torch
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.zeros(1))
    return "unreachable"


def hanging_job() -> str:
    """Rank 1 sleeps past the group's timeout; rank 0 waits in a
    collective for it."""
    import torch
    import torch.distributed as dist

    if dist.get_rank() == 1:
        time.sleep(60)
    dist.all_reduce(torch.zeros(1))
    return "late"


def test_a_failing_rank_fails_the_run():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        multihost.launch(failing_job, 2, device="cpu", timeout_s=120, group_timeout_s=20)
    assert time.monotonic() - t0 < 60


def test_a_hanging_rank_fails_the_run_within_the_group_timeout():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 failed"):
        multihost.launch(hanging_job, 2, device="cpu", timeout_s=120, group_timeout_s=5)
    assert time.monotonic() - t0 < 50


def test_multihost_modules_import_no_jax():
    code = (
        "import sys\n"
        "from blockchain_simulator_tpu_torch.parallel import multihost, mesh, partition\n"
        "from blockchain_simulator_tpu_torch.parallel.multihost import main\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'blockchain_simulator_tpu'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
