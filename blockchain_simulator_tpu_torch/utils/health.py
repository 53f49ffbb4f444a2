"""Backend health telemetry: structured device verdicts (port of
``blockchain_simulator_tpu/utils/health.py``).

- :func:`probe_backend` — the in-process probe: ``torch.cuda.init()``, the
  device count and name, a 128x128 bf16 matmul and one float read back to
  the host.  Returns a structured verdict dict (``healthy`` or ``sick``);
  never raises.  ``device="cpu"`` probes the CPU (the tests).
- :func:`probe_backend_supervised` — the parent-side classifier: runs the
  probe in a detached child and, when no verdict lands within
  ``patience_s``, retries with jittered exponential backoff before
  returning ``wedged``, ABANDONING each silent child without killing it
  (the JAX package's rule: a client killed inside a device init can leave
  the device worse off than a slow probe).  The verdict records the
  attempt count.
- ``python -m blockchain_simulator_tpu_torch.utils.health`` — prints
  exactly one JSON verdict line and appends it to a rolling
  ``HEALTH.jsonl`` (``--log ''`` disables the file).

The verdict records keep the JAX package's keys (``verdict``, ``probe_s``,
``backend``, ``device_count``, ``init_s``, ``compile_run_s``,
``probe_value``, ``error``, ``attempts``, ``supervised``, ``replica``,
``ts``); ``backend`` is ``"cuda"`` or ``"cpu"``, and a CUDA probe adds the
card's name as ``device``.  The rolling log is shared with the JAX package:
either reads the other's verdicts.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import tempfile
import time

VERDICTS = ("healthy", "sick", "wedged")

HEALTH_ENV = "BLOCKSIM_HEALTH_JSONL"


class BackendWedgedError(RuntimeError):
    """The rolling health log's latest verdict says the backend is wedged:
    dispatching would hang, so the caller fails fast instead.  Typed so the
    sweeps and the server classify the refusal without string-matching.
    Carries the offending verdict record as ``.verdict``."""

    def __init__(self, verdict: dict):
        self.verdict = dict(verdict)
        super().__init__(
            f"backend wedged per health log (probe_s="
            f"{verdict.get('probe_s')}, ts={verdict.get('ts')}): refusing "
            "to dispatch — a wedged device turns every dispatch into a "
            "hang; re-probe with "
            "`python -m blockchain_simulator_tpu_torch.utils.health`"
        )


def require_not_wedged(path: str | None = None, max_age_s: float = 3600.0,
                       replica: str | None = None) -> dict | None:
    """Fail fast on a fresh ``wedged`` verdict: the sweeps' admission gate,
    consulted before dispatch so a long grid never hangs on a device a probe
    already classified.

    Reads :func:`latest_verdict` (explicit path, else
    ``$BLOCKSIM_HEALTH_JSONL``; no log = no gate) and raises the typed
    :class:`BackendWedgedError` only when the latest verdict is ``wedged``
    AND younger than ``max_age_s`` (a stale verdict says nothing about the
    device now).  Returns the verdict record consulted (or None)."""
    rec = latest_verdict(path, replica=replica)
    if rec is None:
        return None
    if rec.get("verdict") == "wedged":
        ts = rec.get("ts")
        fresh = not (isinstance(ts, (int, float))
                     and time.time() - ts > max_age_s)
        if fresh:
            raise BackendWedgedError(rec)
    return rec


def probe_backend(device: str | None = None,
                  replica: str | None = None) -> dict:
    """Probe the CUDA card (or ``device``, e.g. ``"cpu"``) in-process.

    ``torch.cuda.init()`` (the call that hangs on a wedged device), the
    device count and name, then a 128x128 bf16 matmul with one float read
    back to the host, which waits for the card.

    Never raises: any failure returns a ``sick`` verdict with the error
    string.  A *hang* cannot be classified in-process — callers that need
    the ``wedged`` verdict use :func:`probe_backend_supervised`."""
    t0 = time.monotonic()
    rec: dict = {"verdict": "sick", "probe_s": None, "backend": None}
    if replica:
        # fleet identity: N replicas sharing one rolling HEALTH.jsonl label
        # their lines so they do not gate each other's admission
        rec["replica"] = str(replica)
    try:
        import torch

        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            torch.cuda.init()
            rec["backend"] = "cuda"
            rec["device_count"] = torch.cuda.device_count()
            rec["device"] = torch.cuda.get_device_name(dev)
        else:
            rec["backend"] = dev.type
            rec["device_count"] = 1
        rec["init_s"] = round(time.monotonic() - t0, 2)
        t1 = time.monotonic()
        a = torch.ones((128, 128), dtype=torch.bfloat16, device=dev)
        val = float((a @ a).sum())
        rec["compile_run_s"] = round(time.monotonic() - t1, 2)
        rec["probe_value"] = val
        rec["verdict"] = "healthy"
    except Exception as e:  # a broken backend is the datum, not a crash
        rec["error"] = f"{type(e).__name__}: {e}"[:500]
    rec["probe_s"] = round(time.monotonic() - t0, 2)
    return rec


def probe_backend_supervised(
    patience_s: float = 120.0,
    env=None,
    attempts: int = 2,
    backoff_s: float = 2.0,
    rng=None,
    replica: str | None = None,
    device: str | None = None,
) -> dict:
    """Run the probe in a detached child; classify a silent child as
    ``wedged``, but only after ``attempts`` probes separated by a jittered
    exponential backoff (``backoff_s * 2**k * uniform(0.5, 1.5)``): one
    slow probe must not flip the serving admission gate.  ``healthy`` /
    ``sick`` verdicts return immediately.  The record carries ``attempts``
    (probes actually run); ``rng`` (a ``random.random``-like callable) makes
    the jitter injectable for deterministic drills."""
    rng = rng if rng is not None else random.random
    rec: dict = {}
    for attempt in range(1, max(1, int(attempts)) + 1):
        rec = _probe_attempt(patience_s, env, device)
        rec["attempts"] = attempt
        if rec["verdict"] != "wedged" or attempt >= attempts:
            break
        time.sleep(backoff_s * (2.0 ** (attempt - 1)) * (0.5 + rng()))
    rec["supervised"] = True
    if replica:
        rec["replica"] = str(replica)
    return rec


def _probe_attempt(patience_s: float, env=None, device: str | None = None) -> dict:
    """ONE supervised probe attempt.

    The child is ``python -m blockchain_simulator_tpu_torch.utils.health
    --child`` (one JSON line on stdout).  If no line lands within
    ``patience_s`` the device is presumed wedged and the child is
    ABANDONED (left running, never signaled) with its pid reported."""
    child_env = dict(os.environ)
    if env:
        child_env.update(env)
    # the child must resolve this package even when the caller runs elsewhere
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_root, child_env.get("PYTHONPATH")) if p
    )
    fd, out_path = tempfile.mkstemp(prefix="health_", suffix=".jsonl")
    out_f = os.fdopen(fd, "w")
    t0 = time.monotonic()
    argv = [sys.executable, "-m", "blockchain_simulator_tpu_torch.utils.health", "--child"]
    if device:
        argv += ["--device", device]
    proc = subprocess.Popen(
        argv,
        stdout=out_f,
        stderr=subprocess.DEVNULL,
        env=child_env,
        start_new_session=True,
    )
    out_f.close()

    def read_verdict():
        try:
            with open(out_path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if isinstance(rec, dict) and "verdict" in rec:
                        return rec
        except OSError:
            pass
        return None

    deadline = t0 + patience_s
    while True:
        if proc.poll() is not None:
            rec = read_verdict()
            if rec is None:
                rec = {
                    "verdict": "sick",
                    "probe_s": round(time.monotonic() - t0, 2),
                    "backend": None,
                    "error": f"probe child exited rc={proc.returncode} "
                             "with no verdict line",
                }
            break
        if time.monotonic() > deadline:
            rec = {
                "verdict": "wedged",
                "probe_s": round(time.monotonic() - t0, 2),
                "backend": None,
                "error": f"no probe verdict within {patience_s:.0f}s; child "
                         "abandoned WITHOUT kill",
                "abandoned_pid": proc.pid,
            }
            break
        time.sleep(0.5)
    if proc.poll() is not None:
        try:
            os.unlink(out_path)
        except OSError:
            pass
    # an abandoned child keeps its output file: it is still writing to it
    return rec


def latest_verdict(path: str | None = None,
                   replica: str | None = None) -> dict | None:
    """Most recent verdict record from a rolling health log (explicit path,
    else ``$BLOCKSIM_HEALTH_JSONL``), or None when no log / no parseable
    verdict line exists.  Read-only and never raises: the scenario server
    consults this at startup to decide whether admission opens paused.

    ``replica`` restricts the read to that replica's own lines plus
    unlabeled lines (a global probe gates everyone)."""
    from blockchain_simulator_tpu_torch.utils import obs

    path = path or os.environ.get(HEALTH_ENV)
    if not path:
        return None
    last = None
    for rec in obs.read_jsonl(path):
        if rec.get("verdict") not in VERDICTS:
            continue
        if replica is not None and rec.get("replica") is not None \
                and str(rec.get("replica")) != str(replica):
            continue
        last = rec
    return last


def append_health(rec: dict, path: str | None = None) -> None:
    """Append one verdict line to the rolling health log.  Path precedence:
    explicit arg, $BLOCKSIM_HEALTH_JSONL, nothing (no-op, so obs's own
    $BLOCKSIM_RUNS_JSONL fallback never captures health verdicts).
    Failures are swallowed."""
    from blockchain_simulator_tpu_torch.utils import obs

    path = path or os.environ.get(HEALTH_ENV)
    if path:
        obs.append_jsonl(rec, path)


def main(argv=None) -> int:
    """CLI: print exactly ONE JSON verdict line; exit 0 healthy, 1 sick,
    2 wedged.  Default mode is supervised (the only mode that can report
    ``wedged`` instead of hanging with the device)."""
    p = argparse.ArgumentParser(prog="blockchain_simulator_tpu_torch.utils.health")
    p.add_argument("--child", action="store_true",
                   help="internal: run the in-process probe and print it")
    p.add_argument("--in-process", action="store_true",
                   help="probe this process's device directly (can hang on "
                        "a wedged device; default is a supervised child "
                        "with --patience)")
    p.add_argument("--patience", type=float, default=120.0,
                   help="supervised mode: seconds to wait for the child's "
                        "verdict before declaring the device wedged")
    p.add_argument("--attempts", type=int, default=2,
                   help="supervised mode: probes (jittered exponential "
                        "backoff between them) before a silent device is "
                        "declared wedged")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the device to probe: cuda (the default) or cpu")
    p.add_argument("--replica", default=None,
                   help="fleet replica id to label the verdict with")
    p.add_argument("--log", default="HEALTH.jsonl",
                   help="rolling verdict log to append to ('' disables)")
    args = p.parse_args(argv)

    if args.child:
        rec = probe_backend(device=args.device, replica=args.replica)
        print(json.dumps(rec), flush=True)
        return 0 if rec["verdict"] == "healthy" else 1

    if args.in_process:
        rec = probe_backend(device=args.device, replica=args.replica)
    else:
        rec = probe_backend_supervised(patience_s=args.patience,
                                       attempts=args.attempts,
                                       replica=args.replica, device=args.device)
    rec["ts"] = round(time.time(), 3)
    print(json.dumps(rec), flush=True)
    append_health(rec, args.log or None)
    return {"healthy": 0, "sick": 1}.get(rec["verdict"], 2)


if __name__ == "__main__":
    sys.exit(main())
