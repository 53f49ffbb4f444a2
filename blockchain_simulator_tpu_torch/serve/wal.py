"""Crash-durable write-ahead log of admitted scenario requests (a copy of
``blockchain_simulator_tpu/serve/wal.py``: the file format is the JAX
package's, so either package replays the other's log).

The serving gap this closes: an admitted request lives only in the
batcher's memory, so a daemon crash (kill -9, OOM, power) loses every
queued request without a trace — the client got neither an answer nor a
typed rejection.  With a WAL attached (``ScenarioServer(wal_path=...)``,
daemon ``--wal``), admission appends a durable ``admit`` record *before*
the request enters the queue, every terminal answer appends ``done``, and
a restarted server replays the difference:

- **at-least-once**: an ``admit`` whose ``done`` was lost to the crash is
  replayed; a ``done`` that reached the OS but not the client may mean
  the work ran twice.  Replay is therefore **idempotent by request id** —
  :meth:`WriteAheadLog.pending` dedups admits by id and the replayed
  response carries ``"replayed": true`` so the access log distinguishes
  replay answers from live ones.
- **exactly once per pending id per restart**: each admitted-but-undone
  id is re-admitted once, in original admission order.
- **bit-equal under the exact sampler**: a replayed request re-runs the
  same (config, seed) through the same executables, so with
  ``stat_sampler="exact"`` its metrics are bit-equal to the answer the
  crashed run would have produced (the parallel/sweep.py caveat applies
  to the ``"normal"`` CLT sampler, as everywhere).
- **quarantine persists**: a ``quarantine`` record marks an id whose solo
  dispatch failed (poison).  A still-undone quarantined admit (the crash
  landed between the mark and the answer) IS replayed — no admission may
  vanish — but the restarted server seeds its quarantine set from the
  log first, so the replay dispatches solo: poison never rides a restart
  back into a batch.

Durability: ``admit`` records are fsynced by default (``sync=True``) —
the kill -9 drill depends on it; ``done``/``quarantine`` are flushed but
not fsynced (losing one widens at-least-once, never loses a request).
The format is one JSON object per line, ``{"wal": 1, "op": ..., "id":
..., ...}``; torn trailing lines (a crash mid-append) are skipped on
read, never fatal.  :meth:`compact` rewrites the log to just its pending
admits (atomic replace) so the file stays bounded across restarts.
"""

from __future__ import annotations

import json
import os
import threading
import time

WAL_SCHEMA = 1


class WriteAheadLog:
    """Append-only request journal; thread-safe (admission and the batcher
    append concurrently).  Open lazily, hold the handle for the server's
    lifetime, :meth:`close` with it."""

    def __init__(self, path: str, sync: bool = True):
        self.path = str(path)
        self.sync = bool(sync)
        self._lock = threading.Lock()
        self._f = None

    # ------------------------------------------------------------ append ---
    def _append(self, rec: dict, fsync: bool) -> None:
        rec = {"wal": WAL_SCHEMA, "ts": round(time.time(), 3), **rec}
        with self._lock:
            if self._f is None:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._f = open(self.path, "a")
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
            if fsync:
                os.fsync(self._f.fileno())

    def append_admit(self, req_id: str, obj: dict) -> None:
        """Durable BEFORE the request enters the queue: the raw request
        JSON rides along so replay re-parses exactly what was admitted."""
        self._append({"op": "admit", "id": str(req_id), "req": obj},
                     fsync=self.sync)

    def append_done(self, req_id: str, code: int | None = None) -> None:
        self._append({"op": "done", "id": str(req_id), "code": code},
                     fsync=False)

    def append_quarantine(self, req_id: str) -> None:
        self._append({"op": "quarantine", "id": str(req_id)}, fsync=False)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    # -------------------------------------------------------------- read ---
    def records(self) -> list[dict]:
        """Every parseable WAL record in file order (torn/foreign lines
        skipped — utils/obs.read_jsonl is the shared tolerant reader; a
        crash mid-append must not poison the replay)."""
        from blockchain_simulator_tpu_torch.utils import obs

        return [
            rec for rec in obs.read_jsonl(self.path)
            if rec.get("wal") == WAL_SCHEMA and rec.get("op")
            and rec.get("id") is not None
        ]

    def pending(self) -> list[tuple[str, dict]]:
        """Admitted-but-undone ``(req_id, raw request)`` in first-admission
        order, deduped by id (idempotent replay).  Quarantined ids are
        INCLUDED when still undone — a crash between the quarantine mark
        and the answer must not strand the admission — and the server's
        quarantine set (seeded from :meth:`quarantined_ids`) keeps their
        replay solo, never batched."""
        admits: dict[str, dict] = {}
        done: set[str] = set()
        for rec in self.records():
            rid = str(rec["id"])
            if rec["op"] == "admit" and rid not in admits:
                admits[rid] = rec.get("req") or {}
            elif rec["op"] == "done":
                done.add(rid)
        return [
            (rid, obj) for rid, obj in admits.items() if rid not in done
        ]

    def quarantined_ids(self) -> set[str]:
        """Ids with a quarantine record — seeds the server's in-memory
        quarantine set across restarts."""
        return {
            str(r["id"]) for r in self.records() if r["op"] == "quarantine"
        }

    def compact(self) -> int:
        """Rewrite the log to its pending admits plus quarantine marks
        (atomic replace; the open handle is reset so later appends land in
        the new file).  Returns the number of pending admits kept.  Called
        by the server at startup BEFORE replay: a long-lived daemon's WAL
        stays proportional to its backlog, not its history."""
        pend = self.pending()
        quarantined = self.quarantined_ids()
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None
            with open(tmp, "w") as f:
                for rid in sorted(quarantined):
                    f.write(json.dumps({
                        "wal": WAL_SCHEMA, "op": "quarantine", "id": rid,
                    }) + "\n")
                for rid, obj in pend:
                    f.write(json.dumps({
                        "wal": WAL_SCHEMA, "op": "admit", "id": rid,
                        "req": obj,
                    }) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        return len(pend)
