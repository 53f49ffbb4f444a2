"""Run manifests: one schema-versioned provenance record per JSON output line
(port of ``blockchain_simulator_tpu/utils/obs.py``).

Every entry point that prints a result line (``cli.py``; the sweeps through
:func:`record_run`) routes it through :func:`finalize`, which attaches a
``manifest`` sub-record — config hash, torch and CUDA versions, the device
and device count, the compile-vs-execution wall split, and rounds/s computed
uniformly — and appends the finalized record to an optional ``runs.jsonl``
(``$BLOCKSIM_RUNS_JSONL``).  :func:`config_hash` equals the JAX package's for
the same config (the port's ``SimConfig`` is a field-for-field copy), so one
runs log joins the records of both packages.

Design constraints, as in the JAX module:

- **Never initialize a backend.**  The device fields are read only when
  CUDA is already initialized in this process (``torch.cuda.is_initialized()``:
  the caller ran on the card), or taken from the record; a CPU run's manifest
  names no device.  Package versions come from ``importlib.metadata``,
  which imports nothing.
- **Never mutate a caller's metrics dict into inequality.**  Library code
  (sweeps, runner) returns metrics dicts that tests compare bit for bit;
  only the printing layer attaches manifests.  :func:`record_run` appends a
  finalized COPY and leaves the caller's dict untouched.

The manifest carries the JAX manifest's ``cache`` block (the executable
registry's counters, ``utils/aotcache.py``) and, once the process has
counted something, its ``telemetry`` block (``utils/telemetry.py``), with
JAX's keys; reading either touches no device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.metadata
import json
import os
import time

import torch

OBS_SCHEMA = 1

# Environment switch: when set, every finalized record is appended (one JSON
# line each) to this path.  Unset = no file I/O (the default for tests).
RUNS_ENV = "BLOCKSIM_RUNS_JSONL"

# Size cap for every rolling JSONL this writer appends to: when the file
# exceeds the cap it rotates to ``<path>.1`` (one generation kept) before
# the append.  Set the env to a small value to exercise rotation (tests
# do).  0 disables rotation.
LOG_MAX_ENV = "BLOCKSIM_LOG_MAX_BYTES"
LOG_MAX_BYTES_DEFAULT = 64 * 1024 * 1024


def _dist_version(name: str) -> str | None:
    """Installed package version without importing the package."""
    try:
        return importlib.metadata.version(name)
    except importlib.metadata.PackageNotFoundError:
        return None


def config_hash(cfg) -> str:
    """Stable 16-hex-digit digest of a SimConfig (or any dataclass): the
    join key between a result line, a trace file, and a runs.jsonl record."""
    if dataclasses.is_dataclass(cfg):
        d = dataclasses.asdict(cfg)
    else:
        d = dict(cfg)
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def manifest(cfg=None, backend=None, device_count=None) -> dict:
    """The schema-versioned provenance record.

    ``backend``/``device_count`` are taken from the arguments when given;
    otherwise the device fields (``backend`` "cuda", ``device`` the card's
    name, ``device_count``) are read only when torch has already initialized
    CUDA in this process — this function never initializes it."""
    rec: dict = {
        "obs_schema": OBS_SCHEMA,
        "ts": round(time.time(), 3),
        "torch": _dist_version("torch"),
        "cuda": torch.version.cuda,
    }
    if cfg is not None:
        rec["config_hash"] = config_hash(cfg)
        rec["protocol"] = getattr(cfg, "protocol", None)
        rec["n"] = getattr(cfg, "n", None)
    if backend is None and torch.cuda.is_initialized():
        backend = "cuda"
        rec["device"] = torch.cuda.get_device_name(torch.cuda.current_device())
        device_count = torch.cuda.device_count()
    if backend is not None:
        rec["backend"] = backend
    if device_count is not None:
        rec["device_count"] = device_count
    try:
        # executable-registry provenance: hit/miss counters, the last key
        # touched, the (null) persistent cache dir; pure counter reads
        from blockchain_simulator_tpu_torch.utils import aotcache

        rec["cache"] = aotcache.registry.manifest()
    except Exception:  # provenance, never a failure mode
        pass
    try:
        # telemetry provenance: counter totals and spans recorded, attached
        # only once the process has counted something, so a bare run's
        # manifest stays the size it was
        from blockchain_simulator_tpu_torch.utils import telemetry

        tel = telemetry.metrics.manifest()
        if tel.get("counters"):
            rec["telemetry"] = tel
    except Exception:  # provenance, never a failure mode
        pass
    return rec


def canonical_json(rec) -> str:
    """The canonical JSON encoding of content-addressed records: sorted
    keys, compact separators, no default coercion (a value json can't
    encode fails here)."""
    return json.dumps(rec, sort_keys=True, separators=(",", ":"))


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile on a sorted copy, the one percentile every
    latency surface shares.  No numpy."""
    xs = sorted(xs)
    if not xs:
        return 0.0
    idx = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[idx]


def rounds_per_s(rounds, run_s) -> float | None:
    """Completed consensus rounds over the measured execution-only wall
    (never the first run, which pays the kernel build and the warm-up)."""
    if rounds is None or not run_s or run_s <= 0:
        return None
    return round(rounds / run_s, 2)


def timed_run(sim, key, measure_key=None):
    """Build-and-warm-up vs execution wall split: ``sim(key)`` pays the
    kernel build and the warm-up, then ``sim(measure_key or key)`` is timed
    alone; each ends in ``utils/sync.force_sync``.  Returns ``(final,
    compile_plus_first_run_s, run_s)``."""
    from blockchain_simulator_tpu_torch.utils.sync import force_sync

    t0 = time.perf_counter()
    force_sync(sim(key))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    final = force_sync(sim(key if measure_key is None else measure_key))
    run_s = time.perf_counter() - t0
    return final, compile_s, run_s


def _read_jsonl_one(path: str) -> list[dict]:
    out: list[dict] = []
    try:
        f = open(path)
    except OSError:
        return out
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


def read_jsonl(path: str) -> list[dict]:
    """Every parseable dict record of a rolling JSONL log, in order.  Torn
    lines and non-dict records are skipped; a missing file reads as empty.
    The rotated generation (``<path>.1``) is read first, so a log that
    rotated reads as one history."""
    return _read_jsonl_one(path + ".1") + _read_jsonl_one(path)


# rotate_if_over's per-path size check runs on the first append to a path
# and then every _ROTATE_EVERY appends
_ROTATE_EVERY = 16
_rotate_counts: dict[str, int] = {}


def rotate_if_over(path: str, max_bytes: int | None = None) -> bool:
    """Rotate ``path`` to ``path + ".1"`` when it exceeds the size cap
    (``$BLOCKSIM_LOG_MAX_BYTES``, default 64 MiB; 0 disables).  One rotated
    generation is kept.  Returns True when a rotation happened; a failed
    rotation is swallowed like every other write in this module."""
    if max_bytes is None:
        try:
            max_bytes = int(os.environ.get(LOG_MAX_ENV, LOG_MAX_BYTES_DEFAULT))
        except ValueError:
            max_bytes = LOG_MAX_BYTES_DEFAULT
    if max_bytes <= 0:
        return False
    try:
        if os.path.getsize(path) <= max_bytes:
            return False
        os.replace(path, path + ".1")
        return True
    except OSError:
        return False


def append_jsonl(record: dict, path: str | None = None) -> None:
    """Append one JSON line; ``path`` defaults to ``$BLOCKSIM_RUNS_JSONL``
    (no-op when neither is set), rotating first when the log is over its
    cap.  A failed append is swallowed: observability must never take down
    the run it observes."""
    path = path or os.environ.get(RUNS_ENV)
    if not path:
        return
    n = _rotate_counts.get(path, 0)
    if n % _ROTATE_EVERY == 0:
        rotate_if_over(path)
    _rotate_counts[path] = n + 1
    try:
        with open(path, "a") as f:
            f.write(json.dumps(record) + "\n")
    except OSError:
        pass


def finalize(
    record: dict,
    cfg=None,
    compile_s=None,
    run_s=None,
    rounds=None,
    runs_path: str | None = None,
    append: bool = True,
) -> dict:
    """Attach the manifest to ``record`` and (``append=True``) append it to
    the optional runs.jsonl.  Idempotent: a record that already carries a
    manifest is returned untouched and not re-appended.  ``append=False``
    when a library layer (:func:`record_run`) already logged the run.
    Returns ``record``: ``print(json.dumps(obs.finalize(m, cfg)))``."""
    if "manifest" in record:
        return record
    record["manifest"] = manifest(
        cfg,
        backend=record.get("backend"),
        device_count=record.get("devices"),
    )
    if compile_s is not None:
        record["manifest"]["compile_plus_first_run_s"] = round(compile_s, 3)
    if run_s is not None:
        record["manifest"]["run_s"] = round(run_s, 3)
        rps = rounds_per_s(rounds, run_s)
        if rps is not None:
            record["manifest"]["rounds_per_s"] = rps
    if append:
        append_jsonl(record, runs_path)
    return record


def record_run(metrics: dict, cfg=None, **kw) -> None:
    """Library-side hook: append a finalized COPY of ``metrics`` to the
    optional runs.jsonl without touching the caller's dict."""
    if not (kw.get("runs_path") or os.environ.get(RUNS_ENV)):
        return
    finalize(dict(metrics), cfg, **kw)
