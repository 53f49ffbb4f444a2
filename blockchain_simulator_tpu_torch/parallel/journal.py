"""Durable sweeps: a fsynced, torn-tail-tolerant journal of chunk results
(port of ``blockchain_simulator_tpu/parallel/journal.py``).

The sweep-tier analog of the serving WAL (serve/wal.py).  With a journal
attached (``run_fault_sweep(..., journal=)``, ``run_byzantine_sweep(...,
journal=)``, ``run_dyn_points(..., journal=)``) a sweep decomposes into
deterministic **chunks** (one a canonical-fault-structure group x seed/level
tile) and each completed chunk appends its rows durably *before* the next
chunk dispatches.  A restarted sweep skips completed chunks and recomputes
at most the one chunk that was in flight when the process died.

Journal-vs-WAL semantics, as in the JAX package:

- the WAL journals **intent** (admits before work, at-least-once replay);
  the sweep journal journals **results**: a chunk line exists only when
  its rows are complete, so replaying it is a read, never a re-execution;
- both share the torn-tail rule: a crash mid-append leaves an unparseable
  tail line that readers skip (utils/obs.read_jsonl), and the chunk that
  owned it is recomputed.

Chunk identity is content-addressed: :func:`chunk_key` hashes the canonical
structure's config hash (``utils/obs.config_hash``, equal to the JAX
package's), the chunk index, the mesh descriptor and the chunk's ``(config
hash, seed)`` point list, so a key, a row checksum and a row are the same
bytes in both packages, and either package resumes the other's journal
(the rows are plain ints, floats and bools: the metrics dicts of both
packages).  Row integrity is a checksum a row (:func:`row_checksum` over
``utils/obs.canonical_json``): a corrupted row demotes its chunk to
"recompute", never to wrong rows.

*The chunk rule of the ``"normal"`` sampler.*  Under ``"normal"`` (and the
``"rbg"`` edge sampler) a lane's draws follow the first lane's key in a
batch (parallel/sweep.py), so chunking a batch changes the rows of every
chunk but the first.  A journaled sweep's rows are its chunks' rows, as the
JAX package's are; the exact sampler's rows do not depend on the chunking.

Supervision (:class:`ChunkSupervisor` + :func:`run_supervised`): a chunk's
dispatch can run under a deadline.  On expiry the dispatch thread is
ABANDONED (never killed; :func:`drain_abandoned` joins such threads before
a process exits), the backend is optionally probed through
``utils/health.probe_backend_supervised``, and the chunk is retried with
jittered exponential backoff a bounded number of times before taking the
recorded **degrade** arm: the same device again without the chunk's
options, or, for a single long tick-engine run, tick-level checkpoints
through ``runner.run_dyn_checkpointed``.  No arm moves work to another
device: a chunk that fails on the card fails there, typed
(:class:`ChunkFailedError`).  Every transition lands as an ``event`` line
in the journal.

A sweep over a mesh (parallel/sweep.py ``mesh=``) keys its chunks with
the mesh's shape, JAX's ``{"sweep": S, "nodes": J}`` descriptor, so a mesh
journal of either package resumes in the other.  Every rank of the grid
runs the sweep; the grid's rank 0 writes the journal.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time

JOURNAL_SCHEMA = 1


def _canonical_json(rec) -> str:
    from blockchain_simulator_tpu_torch.utils import obs

    return obs.canonical_json(rec)


def row_checksum(row: dict) -> str:
    """sha256 (16 hex chars) of a row's canonical JSON — verified by the
    reader before a journaled chunk is trusted.  JSON-round-trip stable:
    a row read back from the journal checksums identically."""
    return hashlib.sha256(_canonical_json(row).encode()).hexdigest()[:16]


def chunk_key(canon, index: int, points, mesh=None,
              n_out: int | None = None) -> str:
    """The content-addressed identity of one sweep chunk, stable across
    processes: canonical-structure config hash + chunk index + mesh
    descriptor + the chunk's ``(config hash, seed)`` point list + the
    row-count trim (``n_out`` — the serve path journals only the real
    lanes of a padded batch, so two batches sharing a padded point list
    but trimming differently must not share a key).  Resume matches on
    this key only — file order and wall-clock never matter."""
    from blockchain_simulator_tpu_torch.utils import obs

    mesh_desc = None
    if mesh is not None:
        from blockchain_simulator_tpu_torch.parallel import partition

        mesh_desc = partition.mesh_shape_dict(mesh)
    ident = {
        "canon": obs.config_hash(canon),
        "index": int(index),
        "mesh": mesh_desc,
        "n_out": None if n_out is None else int(n_out),
        "points": [[obs.config_hash(cfg), int(seed)] for cfg, seed in points],
    }
    return hashlib.sha256(_canonical_json(ident).encode()).hexdigest()[:16]


def query_key_suffix(step: int) -> str:
    """The query-engine chunk-key namespace (query/engine.py): every
    refinement step's chunk journals under ``chunk_key(...) + "+q<step>"``
    — mirroring the obsim probe suffix (``+p<W>``, sweep.run_dyn_points)
    so an adaptive search and a grid sweep over the SAME canonical
    structure can share one journal file without ever sharing a key.
    Grid keys are pure 16-hex; probe keys end ``+p...``; query keys end
    ``+q<step>`` — three disjoint namespaces by construction."""
    return f"+q{int(step)}"


def query_chunk_key(canon, step: int, points, mesh=None,
                    n_out: int | None = None) -> str:
    """Content key of ONE query refinement chunk: the ordinary
    :func:`chunk_key` at index 0 (each refinement generation dispatches
    as one chunk) plus the ``+q<step>`` namespace suffix.  Derived from
    the search trajectory alone — a drill's coverage check recomputes
    these without reading the journal (the dyn_chunk_keys idiom)."""
    return chunk_key(canon, 0, points, mesh, n_out=n_out) \
        + query_key_suffix(step)


class SweepJournal:
    """Append-only chunk-result journal; one JSON object per line.

    ``chunk`` lines carry the rows (with per-row checksums and the
    manifest ``cache`` block for provenance), ``event`` lines carry the
    supervisor's state machine.  Appends are fsynced by default
    (``sync=True``) — the kill -9 resume drill depends on a completed
    chunk surviving the very next instruction being SIGKILL.  Thread-safe
    (the supervisor's dispatch thread and the sweep loop both append)."""

    def __init__(self, path: str, sync: bool = True):
        self.path = str(path)
        self.sync = bool(sync)
        self._lock = threading.Lock()
        self._f = None
        # completed-chunk cache: loaded from disk on the first
        # :meth:`completed` call, then folded forward by this instance's
        # own appends — a long-lived server's per-flush journal check is
        # O(1), not O(journal).  A FRESH instance re-reads the file (the
        # resume path's source of truth stays the disk).
        self._completed: dict[str, list[dict]] | None = None

    # ------------------------------------------------------------ append ---
    def _append(self, rec: dict, fsync: bool) -> None:
        rec = {"sj": JOURNAL_SCHEMA, "ts": round(time.time(), 3), **rec}
        with self._lock:
            if self._f is None:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                # torn-tail repair BEFORE the first append: a crash
                # mid-write leaves a partial line with no newline, and
                # appending straight after it would merge the new record
                # into the garbage — losing BOTH to the tolerant reader.
                # Terminate the torn line first so it parses (and is
                # skipped) alone.
                try:
                    with open(self.path, "rb") as rf:
                        rf.seek(-1, os.SEEK_END)
                        torn = rf.read(1) != b"\n"
                except (OSError, ValueError):  # missing or empty file
                    torn = False
                self._f = open(self.path, "a")
                if torn:
                    self._f.write("\n")
            self._f.write(_canonical_json(rec) + "\n")
            self._f.flush()
            if fsync:
                os.fsync(self._f.fileno())

    def append_chunk(self, key: str, index: int, rows, cache=None) -> None:
        """Durable BEFORE the next chunk dispatches: rows + per-row
        checksums + the registry ``cache`` block (compile provenance —
        which process paid the misses these rows rode on)."""
        rows = list(rows)
        self._append({
            "op": "chunk", "key": str(key), "index": int(index),
            "n": len(rows), "rows": rows,
            "sums": [row_checksum(r) for r in rows],
            "cache": cache,
        }, fsync=self.sync)
        if self._completed is not None:
            self._completed.setdefault(str(key), rows)

    def append_event(self, key: str, event: str, **fields) -> None:
        """Supervisor trail (``deadline``/``probe``/``retry``/``degrade``/
        ``failed``): flushed, not fsynced — losing one on a crash widens
        the post-mortem, never correctness."""
        self._append({"op": "event", "key": str(key), "event": str(event),
                      **fields}, fsync=False)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    # -------------------------------------------------------------- read ---
    def records(self) -> list[dict]:
        """Every parseable journal record in file order (torn tail lines
        skipped — utils/obs.read_jsonl is the shared tolerant reader)."""
        from blockchain_simulator_tpu_torch.utils import obs

        return [
            rec for rec in obs.read_jsonl(self.path)
            if rec.get("sj") == JOURNAL_SCHEMA and rec.get("op")
        ]

    def completed(self) -> dict[str, list[dict]]:
        """``{chunk key: rows}`` for every chunk line whose row checksums
        all verify.  A chunk with any bad checksum (bit rot, a hand-edited
        file) is EXCLUDED — demoted to recompute, never to wrong rows.
        First valid line per key wins (a key can legitimately appear once;
        duplicates are an invariant violation the chaos checker flags).

        Cached per instance (disk read + checksum pass once, then folded
        forward by this instance's appends); treat the returned mapping
        as read-only."""
        if self._completed is None:
            self._completed = self._read_completed()
        return self._completed

    def _read_completed(self) -> dict[str, list[dict]]:
        out: dict[str, list[dict]] = {}
        for rec in self.records():
            if rec["op"] != "chunk":
                continue
            key = str(rec.get("key"))
            if key in out:
                continue
            rows = rec.get("rows")
            sums = rec.get("sums")
            if not isinstance(rows, list) or not isinstance(sums, list) \
                    or len(rows) != len(sums):
                continue
            if all(row_checksum(r) == s for r, s in zip(rows, sums)):
                out[key] = rows
        return out

    def compact(self, keep_keys=None) -> tuple[int, int]:
        """WAL-style compaction (the KNOWN_ISSUES #0k follow-on): rewrite
        the journal to ONLY the checksum-valid chunk lines whose key is in
        ``keep_keys`` (None/empty = drop every chunk), dropping event
        lines and corrupt/duplicate chunks outright.  Atomic replace; the
        open handle and the completed-chunk cache reset so later appends
        and lookups see the compacted file.

        The serving daemon calls this at its startup compaction point
        (serve/server.py, next to ``WriteAheadLog.compact``) keyed on its
        PENDING ADMISSIONS: with a replay backlog every still-answerable
        chunk is kept — a compacted journal replays those batches with
        zero dispatches, same as before (pinned in tests) — and with no
        backlog the file empties, so a live-traffic daemon's journal stays
        proportional to its crash backlog instead of its history.

        Returns ``(kept, dropped)`` chunk-line counts."""
        keep = set() if keep_keys is None else {str(k) for k in keep_keys}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        # the WHOLE read-filter-replace runs under the append lock: a
        # concurrent append_chunk between the snapshot and os.replace
        # would otherwise be silently deleted despite its fsync (the
        # reads below take no lock of their own, so no reentrancy)
        with self._lock:
            lines = self.chunk_lines()
            kept_recs = []
            seen: set[str] = set()
            for rec in lines:
                key = str(rec.get("key"))
                if key not in keep or key in seen:
                    continue
                # verify THIS line's own checksums — a corrupt line that
                # precedes a valid duplicate must not be the one kept
                rows, sums = rec.get("rows"), rec.get("sums")
                if not isinstance(rows, list) or not isinstance(sums, list) \
                        or len(rows) != len(sums) \
                        or any(row_checksum(r) != s
                               for r, s in zip(rows, sums)):
                    continue
                kept_recs.append(rec)
                seen.add(key)
            if self._f is not None:
                self._f.close()
                self._f = None
            with open(tmp, "w") as f:
                for rec in kept_recs:
                    f.write(_canonical_json(rec) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self._completed = None
        return len(kept_recs), len(lines) - len(kept_recs)

    def events(self) -> list[dict]:
        """Every supervisor event line, in order."""
        return [r for r in self.records() if r["op"] == "event"]

    def chunk_lines(self) -> list[dict]:
        """Every parseable chunk line (checksum-verified or not) — the
        invariant checker counts duplicates and checksum failures here."""
        return [r for r in self.records() if r["op"] == "chunk"]


# ----------------------------------------------------------- supervision ---


class ChunkDeadlineError(TimeoutError):
    """A chunk dispatch missed its deadline; the dispatch thread was
    abandoned (never killed — KNOWN_ISSUES.md #3)."""


class ChunkFailedError(RuntimeError):
    """A chunk exhausted its retries AND its degrade arm — the typed
    terminal failure of the supervised state machine (the sweep caller
    sees this, never a hung process)."""


class ChunkSupervisor:
    """Policy knobs for supervised chunk dispatch.

    ``deadline_s``       per-attempt wall deadline on the PRIMARY arm
                         (None = no deadline: failures still retry,
                         hangs hang);
    ``degrade_deadline_s``  deadline on the degrade arm — default None:
                         the degrade arm is the last resort (abandoning
                         it too leaves nothing), and the checkpoint arm
                         legitimately runs long sims whose loss its own
                         per-segment checkpoints already bound;
    ``retries``          primary-arm attempts beyond the first;
    ``backoff_s``        base of the jittered exponential retry backoff;
    ``probe``            probe the backend via utils/health.
                         probe_backend_supervised after a deadline expiry
                         (``probe_patience_s`` per attempt) and record
                         the verdict as a journal event;
    ``checkpoint_dir``   enables the tick-level checkpoint degrade arm
                         for single-point chunks of tick-schedule configs
                         (runner.run_dyn_checkpointed: a re-kill resumes
                         MID-chunk from the last segment checkpoint);
    ``checkpoint_every_ms``  segment length of that arm;
    ``rng``              ``random.random``-like jitter source, injectable
                         so drills replay one backoff schedule.
    """

    def __init__(self, deadline_s: float | None = 30.0, retries: int = 2,
                 backoff_s: float = 0.5, probe: bool = False,
                 probe_patience_s: float = 60.0,
                 checkpoint_dir: str | None = None,
                 checkpoint_every_ms: int = 200, rng=None,
                 degrade_deadline_s: float | None = None):
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.degrade_deadline_s = (None if degrade_deadline_s is None
                                   else float(degrade_deadline_s))
        self.retries = max(0, int(retries))
        self.backoff_s = float(backoff_s)
        self.probe = bool(probe)
        self.probe_patience_s = float(probe_patience_s)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every_ms = int(checkpoint_every_ms)
        import random as _random

        self.rng = rng if rng is not None else _random.random


# dispatch threads abandoned by an expired deadline: still running real
# compute, never signaled.  Tracked so drills/tests can drain them before
# process exit — interpreter teardown mid-dispatch aborts the process.
_abandoned: list[threading.Thread] = []


def drain_abandoned(timeout_s: float = 60.0) -> int:
    """Join every abandoned dispatch thread (bounded by ``timeout_s``
    total); returns how many actually finished.  A thread still alive
    when the budget runs out stays TRACKED (and uncounted) — callers can
    see the shortfall and wait again; silently dropping a live thread
    would recreate the interpreter-teardown abort this helper exists to
    prevent.  Drills and tests call this before exiting — a long-lived
    sweep process never needs to."""
    n = 0
    deadline = time.monotonic() + timeout_s
    still_alive: list[threading.Thread] = []
    while _abandoned:
        t = _abandoned.pop()
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            still_alive.append(t)
        else:
            n += 1
    _abandoned.extend(still_alive)
    return n


def _with_deadline(fn, deadline_s):
    """Run ``fn()`` under a wall deadline in a worker thread.  On expiry
    the thread is ABANDONED — left running, never signaled (a Python
    thread cannot be killed, and one stopped mid-launch would leave the
    device's work in an unknown state) — and :class:`ChunkDeadlineError`
    raises in the caller.  ``deadline_s=None`` calls ``fn`` inline.  A
    ``fn`` that launches on a card selects its device first (the worker
    thread starts with the process's current device)."""
    if deadline_s is None:
        return fn()
    box: list = []

    def worker():
        try:
            box.append(("ok", fn()))
        except BaseException as e:  # delivered to the supervisor, not lost
            box.append(("err", e))

    t = threading.Thread(target=worker, daemon=True,
                         name="sweep-chunk-dispatch")
    t.start()
    t.join(deadline_s)
    if not box:
        _abandoned.append(t)
        raise ChunkDeadlineError(
            f"chunk dispatch exceeded {deadline_s:.3f}s deadline; "
            "dispatch thread abandoned (KNOWN_ISSUES.md #3)"
        )
    kind, val = box[0]
    if kind == "err":
        raise val
    return val


def run_supervised(primary, degrade, sup: ChunkSupervisor,
                   journal: SweepJournal | None = None,
                   key: str = "?", agree=None) -> tuple[list, list[str]]:
    """The deadline → retry/backoff → degrade state machine around one
    chunk.  ``primary``/``degrade`` are zero-arg callables returning the
    chunk's rows (``degrade=None`` disables the arm).  Returns
    ``(rows, events)`` where events is the ordered transition trail —
    also appended to ``journal`` as ``event`` lines as they happen.

    ``agree(arm, err, value)`` (a sweep over a grid of ranks,
    parallel/sweep.py) runs in the calling thread after every attempt of
    either arm (``arm`` ``"primary"`` or ``"degrade"``, ``err`` the
    attempt's exception or ``None``) and returns the rows, or raises when
    any rank's attempt failed: every rank then takes the same transition.

    Terminal behavior: rows from the primary arm (possibly after
    retries), rows from the degrade arm (recorded), or a typed
    :class:`ChunkFailedError` carrying the last underlying error —
    never a silently hung sweep."""
    events: list[str] = []

    def run_arm(arm: str, fn, deadline_s):
        if agree is None:
            return _with_deadline(fn, deadline_s)
        err = val = None
        try:
            val = _with_deadline(fn, deadline_s)
        except Exception as e:  # the grid hears of it before anyone acts
            err = e
        return agree(arm, err, val)

    def note(event: str, **fields):
        events.append(event)
        if journal is not None:
            journal.append_event(key, event, **fields)
        # the flight recorder (utils/telemetry.py) mirrors the trail and
        # turns a degrade/terminal-failure into an atomic post-mortem
        # dump when $BLOCKSIM_FLIGHT_DIR is armed (ring-only otherwise)
        from blockchain_simulator_tpu_torch.utils import telemetry

        telemetry.flight.note(f"sweep.{event}", key=key, **fields)
        if event in ("degrade", "failed"):
            telemetry.flight.dump(f"supervisor-{event}")

    last_err: BaseException | None = None
    for attempt in range(1, sup.retries + 2):
        try:
            return run_arm("primary", primary, sup.deadline_s), events
        except ChunkDeadlineError as e:
            last_err = e
            note("deadline", attempt=attempt,
                 deadline_s=sup.deadline_s)
            if sup.probe:
                from blockchain_simulator_tpu_torch.utils import health

                verdict = health.probe_backend_supervised(
                    patience_s=sup.probe_patience_s, rng=sup.rng,
                )
                note("probe", verdict=verdict.get("verdict"),
                     attempts=verdict.get("attempts"))
        except Exception as e:  # a raising dispatch: retryable fault
            last_err = e
            note("error", attempt=attempt,
                 error=f"{type(e).__name__}: {e}"[:200])
        if attempt <= sup.retries:
            note("retry", attempt=attempt)
            time.sleep(sup.backoff_s * (2.0 ** (attempt - 1))
                       * (0.5 + sup.rng()))
    if degrade is not None:
        note("degrade")
        try:
            return run_arm("degrade", degrade, sup.degrade_deadline_s), events
        except Exception as e:
            last_err = e
            note("failed", error=f"{type(e).__name__}: {e}"[:200])
    else:
        note("failed", error=f"{type(last_err).__name__}: {last_err}"[:200]
             if last_err else "no degrade arm")
    raise ChunkFailedError(
        f"chunk {key} failed after {sup.retries + 1} attempt(s)"
        f"{' and the degrade arm' if degrade is not None else ''}: "
        f"{type(last_err).__name__ if last_err else '?'}: {last_err}"
    ) from last_err
