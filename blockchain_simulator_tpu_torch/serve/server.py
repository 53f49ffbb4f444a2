"""ScenarioServer: the long-lived, micro-batching scenario-serving core (port
of ``blockchain_simulator_tpu/serve/server.py``).

The in-process API the daemon (serve/__main__.py), chip_smoke.py and the
tests drive:

- :meth:`ScenarioServer.submit` — admission-checked enqueue; returns a
  :class:`PendingResponse` future.  Rejections raise typed
  :class:`~blockchain_simulator_tpu_torch.serve.schema.ServeError`
  subclasses AFTER recording a rejection manifest in the access log —
  nothing is dropped silently.
- :meth:`ScenarioServer.request` — submit + wait; always returns a
  response dict (errors become 4xx/5xx bodies), the daemon's HTTP shape.
- one background **batcher** thread: pulls admitted requests, groups them
  by canonical fault structure (their batch group, schema.parse_request),
  and flushes a group when it reaches ``max_batch`` or its oldest request
  has waited ``max_wait_ms``.  Dispatch is serve/dispatch.py: one lane
  batch a flush, from the warm executable registry.  The batcher thread
  is the only thread that launches work on the card (it selects the
  server's device first); HTTP handler threads only parse and enqueue.

The server runs on ``device`` (the CUDA card when None), resolved once at
construction through ``runner.resolve_device``: without a card it raises
there, never at the first request, and it never falls back to the CPU.

Robustness layers, as in the JAX package:

- **Write-ahead log** (``wal_path=``, serve/wal.py): admission appends a
  durable record before the queue sees the request; a restarted server
  replays admitted-but-unanswered requests exactly once per pending id
  (idempotent, access-logged with ``"replayed": true``).  The log format
  is the JAX package's: either package replays the other's.
- **Supervised batcher**: a batcher-thread death is caught by the
  supervisor loop and the thread restarts with exponential backoff
  (``batcher_restarts`` on /stats); grouped-but-undispatched requests
  survive the restart because the group state lives on the server.
- **Per-group circuit breakers**: ``breaker_threshold`` consecutive
  batched-dispatch failures flip a group to solo-only dispatch; after
  ``breaker_cooldown_s`` one half-open probe batch decides re-close vs
  re-open with doubled cooldown.  States surface on /stats.
- **Quarantine**: a request whose SOLO dispatch failed (typed
  ``dispatch-failed``) is poison — its id never joins a batch again
  (singleton quarantined-solo flushes), across restarts via the WAL.
- **Shutdown flush**: ``close()`` drains and answers every admitted
  request; whatever the batcher cannot serve is answered with a typed 503
  and a rejection manifest.

Admission is gated on backend health (utils/health.py): a ``sick``/
``wedged`` verdict — seeded from the rolling HEALTH.jsonl at startup or
pushed via :meth:`set_health` — pauses admission with typed 503s until a
``healthy`` verdict resumes it.  The access log is utils/obs.py
``record_run``: one finalized manifest line per served OR rejected request
in runs.jsonl (``$BLOCKSIM_RUNS_JSONL``), cache and telemetry blocks
included.

``journal_path=`` (the daemon's ``--journal``) attaches the durable-sweep
journal (parallel/journal.py): batched flushes journal their rows, so a WAL
replay of an already-computed batch is answered from the journal, and the
journal compacts at startup keyed on the pending admissions.  ``"query"``
requests (serve/schema.py) each run the adaptive search (query/engine.py)
on a worker thread of their own, which selects the server's device first.
Not ported yet: ``mesh=`` (batches sharded over a sweep mesh), refused with
``NotImplementedError`` naming its item (parallel/mesh.MESH_SERVING_ITEM,
the serving surfaces of the sweep axis).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time

from blockchain_simulator_tpu_torch import runner
from blockchain_simulator_tpu_torch.chaos import inject
from blockchain_simulator_tpu_torch.parallel import sweep
from blockchain_simulator_tpu_torch.parallel.mesh import MESH_SERVING_ITEM
from blockchain_simulator_tpu_torch.serve import dispatch, schema
from blockchain_simulator_tpu_torch.serve.wal import WriteAheadLog
from blockchain_simulator_tpu_torch.utils import aotcache, obs, telemetry

_SHUTDOWN = object()

# Batch-group key prefix for quarantined singleton flushes: unique per
# request id, so poison can never share a group (or a vmapped dispatch)
# with a healthy peer.
_QUARANTINE_GROUP = "__quarantine__"


class PendingResponse:
    """Future for one admitted request: ``result()`` blocks until the
    batcher answers.  A ``wait_s`` elapsing returns a typed 504 body
    without un-queueing the request (the server-side ``timeout_s`` is the
    authoritative per-request timeout)."""

    __slots__ = ("_event", "_response", "req_id")

    def __init__(self, req_id: str):
        self._event = threading.Event()
        self._response = None
        self.req_id = req_id

    def _set(self, response: dict) -> None:
        self._response = response
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, wait_s: float | None = None) -> dict:
        if not self._event.wait(wait_s):
            return schema.RequestTimeoutError(
                f"no response within wait_s={wait_s}"
            ).to_response(self.req_id)
        return self._response


class CircuitBreaker:
    """Per-batch-group breaker over the BATCHED dispatch path.

    closed → (``threshold`` consecutive batched failures) → open: the
    group dispatches solo-only (``breaker-solo``) so traffic keeps
    flowing without re-paying a failing vmapped dispatch per flush.
    open → (``cooldown_s`` elapsed) → half-open: ONE probe batch runs;
    success closes, failure re-opens with the cooldown doubled (capped).
    Only the batcher thread mutates state (the server lock guards the
    stats() snapshot read)."""

    __slots__ = ("threshold", "cooldown_s", "max_cooldown_s", "state",
                 "failures", "opened_at", "cooldown", "opens")

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 max_cooldown_s: float = 300.0):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.max_cooldown_s = float(max_cooldown_s)
        self.state = "closed"
        self.failures = 0          # consecutive batched failures
        self.opened_at = 0.0
        self.cooldown = self.cooldown_s
        self.opens = 0

    def allow_batched(self, now: float) -> bool:
        """May this flush attempt a batched dispatch?  An elapsed cooldown
        converts open → half-open and admits the probe."""
        if self.state == "open":
            if now - self.opened_at >= self.cooldown:
                self.state = "half-open"
                return True
            return False
        return True  # closed, or half-open probe already admitted

    def record(self, failed: bool, now: float) -> None:
        """Outcome of one batched dispatch attempt."""
        if not failed:
            self.failures = 0
            self.state = "closed"
            self.cooldown = self.cooldown_s
            return
        self.failures += 1
        reopened = self.state == "half-open"
        if reopened or self.failures >= self.threshold:
            if reopened:
                self.cooldown = min(self.cooldown * 2.0, self.max_cooldown_s)
            self.state = "open"
            self.opened_at = now
            self.opens += 1

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "consecutive_failures": self.failures,
            "opens": self.opens,
            "cooldown_s": round(self.cooldown, 3),
        }


class ScenarioServer:
    """See the module docstring.  ``start=False`` builds the server without
    its batcher thread (the backpressure tests fill the queue that way, and
    a caller that wants a known flush submits first); call :meth:`start`
    later.  Always :meth:`close` (or use as a context manager) — it drains
    the queue, answering every admitted request."""

    def __init__(
        self,
        max_batch: int = 8,
        max_wait_ms: float = 25.0,
        max_queue: int = 64,
        default_timeout_s: float = 30.0,
        health_log: str | None = None,
        start: bool = True,
        wal_path: str | None = None,
        wal_sync: bool = True,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 30.0,
        restart_backoff_s: float = 0.05,
        mesh=None,
        replica: str | None = None,
        journal_path: str | None = None,
        device=None,
    ):
        if max_batch < 1 or max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")
        if mesh is not None:
            raise NotImplementedError(
                f"mesh= (batched flushes sharded over a device mesh) comes with "
                f"{MESH_SERVING_ITEM}")
        # durable-sweep journal (parallel/journal.py; daemon --journal):
        # batched flushes append their rows content-keyed, so a WAL replay
        # of an already-computed batch is answered from the journal
        # instead of re-executed (serve/dispatch.run_batch journal=)
        self._journal = None
        if journal_path:
            from blockchain_simulator_tpu_torch.parallel.journal import SweepJournal

            self._journal = SweepJournal(journal_path)
        # the one device every dispatch runs on: the CUDA card unless the
        # caller names another; without a card this raises HERE.  A bare
        # "cuda" is pinned to the current card, so the batcher thread can
        # select it (torch.cuda.set_device needs an index)
        self.device = runner.resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            import torch

            self.device = torch.device("cuda", torch.cuda.current_device())
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue = int(max_queue)
        self.default_timeout_s = float(default_timeout_s)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.restart_backoff_s = float(restart_backoff_s)

        # fleet identity (serve/fleet.py): labels this replica's health
        # seeding so N replicas sharing one HEALTH.jsonl read only their
        # own (or unlabeled) verdicts instead of each other's
        self.replica = str(replica) if replica else None
        self._arrivals: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._depth = 0          # admitted, not yet answered
        self._health: dict = {"verdict": "healthy", "source": "default"}
        if health_log:
            from blockchain_simulator_tpu_torch.utils import health as health_mod

            rec = health_mod.latest_verdict(health_log,
                                            replica=self.replica)
            if rec is not None:
                self._health = {"verdict": rec["verdict"],
                                "source": health_log}
        self._stats = {
            "received": 0, "served": 0, "timeouts": 0, "batches": 0,
            "degraded_batches": 0, "rejected": {}, "errors": 0,
            "replayed": 0, "quarantined": 0, "batcher_restarts": 0,
            "queries": 0,
        }
        # PRIVATE latency histograms (utils/telemetry.py) behind the
        # /stats "latency_ms" percentiles: per-server so N servers in one
        # process (tests, LocalReplica drills) don't blur each other;
        # the process-global `telemetry.metrics` registry (the /metrics
        # exposition) is fed the same observations in _answer
        self._hists = {
            seg: telemetry.Histogram(f"serve_{seg}_ms", {},
                                     threading.Lock())
            for seg in ("request", "queue_wait", "batch_wait", "dispatch")
        }
        self._occupancy: dict[int, int] = {}
        self._breakers: dict[str, CircuitBreaker] = {}
        self._quarantine: set[str] = set()
        # batch groups live on the SERVER, not the batcher thread's stack:
        # a supervised restart resumes exactly the groups the dead thread
        # left behind (the chaos batcher-kill drill pins this)
        self._pending: dict = {}  # group key -> list[(req, PendingResponse)]
        self._backoff = self.restart_backoff_s
        self._closing = False
        self._drain = True
        self._thread: threading.Thread | None = None
        # long-running query requests (schema "query"): each runs on its
        # own worker thread outside the micro-batching loop, tracked so
        # close() can wait for them and sweep any dead worker's future
        self._queries: list = []  # [(req, PendingResponse, Thread)]

        self._wal: WriteAheadLog | None = None
        self._wal_replayed_at_start = 0
        self._wal_claimed_by: str | None = None
        if wal_path:
            self._wal = WriteAheadLog(wal_path, sync=wal_sync)
            self._quarantine |= self._wal.quarantined_ids()
            from blockchain_simulator_tpu_torch.serve import fleet

            self._wal_claimed_by = fleet.claim_owner(wal_path)
            if self._wal_claimed_by is None:
                self._wal.compact()
                # the sweep journal compacts at the SAME point, keyed on the
                # pending admissions: a replay backlog keeps every valid
                # chunk line (the replayed batches still answer from the
                # journal, zero dispatches), an empty backlog empties the
                # file, so a live-traffic daemon's journal tracks its crash
                # backlog, not its flush history
                if self._journal is not None:
                    keep = (set(self._journal.completed())
                            if self._wal.pending() else ())
                    self._journal.compact(keep)
                self._replay_wal()
            # else: a router holds this WAL's lease (serve/fleet.py) — the
            # pending ids are being replayed on a peer RIGHT NOW, so a
            # restarting replica must not replay them a second time; it
            # still serves (and journals) new traffic on the same file.
            # Compaction is skipped too: the lease holder is reading it.
        if start:
            self.start()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._supervise, name="scenario-batcher", daemon=True
            )
            self._thread.start()

    def close(self, drain: bool = True) -> None:
        """Stop admitting and stop the batcher.  ``drain=True`` (default):
        the batcher dispatches every already-admitted request before
        exiting.  ``drain=False``: queued requests are flushed as typed
        503 rejections instead of dispatched (fast shutdown).  Either way
        the close-side sweep below guarantees NO admitted request is left
        unanswered or unlogged — even when the batcher thread is dead."""
        with self._lock:
            already = self._closing
            self._closing = True
            self._drain = self._drain and drain
        if not already and self._thread is not None \
                and self._thread.is_alive():
            self._arrivals.put(_SHUTDOWN)
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        self._thread = None
        # query workers answer through their own threads: wait for them, so
        # the sweep below only 503s a genuinely dead worker's future (a
        # ChaosKill'd search), never a result that was seconds away
        with self._lock:
            queries = list(self._queries)
            self._queries = []
        for _, _, t in queries:
            if t.is_alive():
                t.join()
        self._reject_shutdown(
            [(req, fut) for req, fut, _ in queries if not fut.done()])
        # the sweep: whatever the batcher could not (or was told not to)
        # serve gets its typed 503 + rejection manifest right here — the
        # invariant checker's "no request unaccounted" has no exceptions
        leftovers = []
        while True:
            try:
                item = self._arrivals.get_nowait()
            except queue.Empty:
                break
            if item is not _SHUTDOWN:
                leftovers.append(item)
        with self._lock:
            for group in self._pending.values():
                leftovers.extend(group)
            self._pending = {}
        self._reject_shutdown(leftovers)
        if self._wal is not None:
            self._wal.close()
        if self._journal is not None:
            self._journal.close()
        # flight-recorder post-mortem (utils/telemetry.py): a no-op file-
        # wise unless $BLOCKSIM_FLIGHT_DIR is armed, so every drill/test
        # shutdown stays free; the ring note is always recorded
        telemetry.flight.note("serve.shutdown", replica=self.replica,
                              drain=self._drain)
        telemetry.flight.dump("shutdown")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ admission
    def set_health(self, verdict) -> dict:
        """Push a health verdict (a ``utils/health.py`` record or a bare
        verdict string): anything but ``healthy`` pauses admission; a
        ``healthy`` verdict resumes it."""
        if isinstance(verdict, dict):
            rec = {"verdict": verdict.get("verdict"), "source": "pushed"}
        else:
            rec = {"verdict": str(verdict), "source": "pushed"}
        with self._lock:
            self._health = rec
        return rec

    @property
    def paused(self) -> bool:
        return self._health["verdict"] != "healthy"

    def _reject(self, err: schema.ServeError, req_id: str | None,
                cfg=None, t0: float | None = None) -> schema.ServeError:
        """Count + access-log a rejection BEFORE the caller sees it: the
        no-silent-drop contract — every backpressure/admission/validation
        refusal leaves a manifest line when the access log is enabled."""
        with self._lock:
            by_kind = self._stats["rejected"]
            by_kind[err.kind] = by_kind.get(err.kind, 0) + 1
        obs.record_run(err.to_response(req_id), cfg)
        try:
            # admission rejections close their (tiny) span tree here; the
            # rejected counter is the reconciliation peer of the stats
            # `rejected` map (chaos/invariants.check_telemetry)
            now = time.monotonic()
            ctx = telemetry.current()
            telemetry.emit(
                "serve.request", t0 if t0 is not None else now, now,
                trace=ctx.trace_id if ctx else None,
                parent=ctx.span_id if ctx else None, status="error",
                id=req_id, outcome=err.kind, replica=self.replica,
            )
            telemetry.metrics.counter("blocksim_serve_rejected_total",
                                      kind=err.kind).inc()
        except Exception:
            pass  # telemetry must never block the rejection
        return err

    def submit(self, obj: dict) -> PendingResponse:
        """Admission-check + enqueue one JSON scenario request.  Raises a
        typed :class:`~blockchain_simulator_tpu_torch.serve.schema.ServeError`
        (already access-logged) on rejection."""
        t_admit = time.monotonic()
        with self._lock:
            self._stats["received"] += 1
            req_id = str((obj or {}).get("id", "")
                         if isinstance(obj, dict) else "") \
                or f"r{next(self._ids)}"
            closing, health = self._closing, dict(self._health)
        telemetry.metrics.counter("blocksim_serve_received_total").inc()
        if closing:
            raise self._reject(
                schema.ShuttingDownError("server is draining"), req_id,
                t0=t_admit)
        if health["verdict"] != "healthy":
            raise self._reject(
                schema.AdmissionPausedError(
                    f"admission paused: backend health verdict is "
                    f"{health['verdict']!r} (source: {health['source']})"
                ),
                req_id, t0=t_admit,
            )
        try:
            req = schema.parse_request(
                obj, req_id, default_timeout_s=self.default_timeout_s
            )
        except schema.ServeError as e:
            raise self._reject(e, req_id, t0=t_admit)
        # trace identity: adopt the router's context (the HTTP handler
        # installed it from the X-Blocksim-Trace header) or mint a fresh
        # trace — either way the answer-time span tree has a home
        ctx = telemetry.current()
        req.trace_id = ctx.trace_id if ctx else telemetry.new_trace_id()
        req.parent_span = ctx.span_id if ctx else None
        req.t_admit = t_admit
        pending = PendingResponse(req.req_id)
        # depth check, flag re-check, WAL admit and enqueue are ONE atomic
        # step: after close() flips _closing under this lock, nothing new
        # can enter the arrivals queue, so the batcher's drain is complete
        # — and the WAL admit is durable BEFORE the batcher can answer.
        # The fsync under this lock serializes admission by design: moving
        # it outside would open a close()-vs-enqueue stranding race, and
        # the journal is opt-in (wal_sync=False / --wal-no-sync trades the
        # durability fence away when admission throughput matters more)
        with self._lock:
            full = self._depth >= self.max_queue
            closing = self._closing
            if not full and not closing:
                if self._wal is not None:
                    try:
                        self._wal.append_admit(req.req_id, obj)
                    except OSError:
                        pass  # a full disk must not take admission down
                self._depth += 1
                req.submitted = time.monotonic()
                self._arrivals.put((req, pending))
        if closing:
            raise self._reject(
                schema.ShuttingDownError("server is draining"),
                req.req_id, req.cfg, t0=t_admit)
        if full:
            raise self._reject(
                schema.QueueFullError(
                    f"queue at capacity ({self.max_queue}); retry later"
                ),
                req.req_id, req.cfg, t0=t_admit,
            )
        return pending

    def request(self, obj: dict, wait_s: float | None = None) -> dict:
        """submit + wait: always returns a response dict — typed rejections
        become their 4xx/5xx bodies (the daemon's HTTP surface)."""
        try:
            pending = self.submit(obj)
        except schema.ServeError as e:
            req_id = obj.get("id") if isinstance(obj, dict) else None
            return e.to_response(req_id)
        return pending.result(wait_s)

    # ------------------------------------------------------------ WAL layer
    def _wal_done(self, req_id: str, code=None) -> None:
        if self._wal is None:
            return
        try:
            self._wal.append_done(req_id, code)
        except OSError:
            pass  # the journal must never block the answer

    def _replay_wal(self) -> None:
        """Re-admit every admitted-but-unanswered request from the WAL —
        exactly once per pending id, bypassing the admission gates (they
        were admitted once already; a paused health verdict must not
        strand them a second time).  Requests that no longer parse are
        answered with their typed rejection, access-logged with the
        ``replayed`` mark, and retired from the journal."""
        pend = self._wal.pending()
        now = time.monotonic()
        for rid, obj in pend:
            with self._lock:
                self._stats["replayed"] += 1
            telemetry.metrics.counter("blocksim_serve_replayed_total").inc()
            try:
                req = schema.parse_request(
                    dict(obj) if isinstance(obj, dict) else obj, rid,
                    default_timeout_s=self.default_timeout_s,
                )
            except schema.ServeError as e:
                resp = e.to_response(rid)
                resp["replayed"] = True
                with self._lock:
                    by_kind = self._stats["rejected"]
                    by_kind[e.kind] = by_kind.get(e.kind, 0) + 1
                telemetry.metrics.counter("blocksim_serve_rejected_total",
                                          kind=e.kind).inc()
                obs.record_run(resp, None)
                self._wal_done(rid, e.code)
                continue
            req.replayed = True
            req.trace_id = telemetry.new_trace_id()
            req.t_admit = now
            req.submitted = now  # the original clock died with the crash
            with self._lock:
                self._depth += 1
            self._arrivals.put((req, PendingResponse(rid)))
        self._wal_replayed_at_start = len(pend)

    # -------------------------------------------------------------- batcher
    def _supervise(self) -> None:
        """The batcher's supervisor: a clean return (shutdown drain) ends
        the thread; a crash restarts the loop after an exponential backoff
        (``restart_backoff_s`` doubling, capped at 5 s, reset by the next
        successful flush) instead of wedging every future client behind a
        dead thread.  Group state lives on the server, so the restarted
        loop resumes exactly where the dead one stopped."""
        while True:
            try:
                self._batcher()
                return
            except Exception:
                with self._lock:
                    self._stats["batcher_restarts"] += 1
                    closing = self._closing
                    backoff = self._backoff
                    self._backoff = min(backoff * 2.0, 5.0)
                if closing:
                    return  # close() sweeps the leftovers into typed 503s
                time.sleep(backoff)

    def _batcher(self) -> None:
        """The micro-batching loop: accumulate per-group, flush a group at
        ``max_batch`` depth or ``max_wait_ms`` age, drain on shutdown.  The
        loop's thread selects the server's card first, so its launches go
        there whatever device the process made current elsewhere."""
        if self.device.type == "cuda":
            import torch

            torch.cuda.set_device(self.device)
        while True:
            closing = self._closing
            pending = self._pending
            max_wait = self.max_wait_ms / 1000.0
            timeout = None if not pending else max_wait / 4 if max_wait > 0 \
                else 0.001
            try:
                item = self._arrivals.get(timeout=timeout)
            except queue.Empty:
                item = None
            # drain everything already queued before deciding what is due:
            # a dispatch takes long enough that several arrivals pile up
            # behind it, and admitting them one per flush would serve a
            # saturated queue solo forever (head-of-line anti-batching)
            while item is not None:
                if item is _SHUTDOWN:
                    closing = True
                else:
                    req, fut = item
                    req.t_drained = time.monotonic()
                    if req.query is not None:
                        # adaptive queries are long-running requests: a
                        # search's refinement generations must not block
                        # the micro-batching loop, so each gets its own
                        # worker thread (it answers through _answer like
                        # every batched request)
                        self._spawn_query(req, fut)
                    else:
                        if req.req_id in self._quarantine:
                            key = (_QUARANTINE_GROUP, req.req_id)
                        else:
                            # the probe config is part of the group
                            # identity: armed and disarmed requests never
                            # share a flush (dispatch assumes
                            # probe-homogeneous batches)
                            key = req.canon if req.probe is None \
                                else (req.canon, req.probe)
                        pending.setdefault(key, []).append((req, fut))
                try:
                    item = self._arrivals.get_nowait()
                except queue.Empty:
                    item = None
            closing = closing or self._closing

            # the batcher-death injection point: a ChaosKill here escapes
            # to the supervisor with the drained groups safely in
            # self._pending (the batcher-kill drill)
            inject.chaos_point("serve.batcher", pending=len(pending))

            now = time.monotonic()
            for key in list(pending):
                group = pending[key]
                quarantined = isinstance(key, tuple) \
                    and key[0] == _QUARANTINE_GROUP
                due = (
                    closing
                    or quarantined  # poison flushes alone, immediately
                    or len(group) >= self.max_batch
                    or (now - group[0][0].submitted) * 1000.0
                    >= self.max_wait_ms
                )
                if due:
                    del pending[key]
                    if closing and not self._drain:
                        # fast shutdown: typed 503s, never a vanished line
                        self._reject_shutdown(group)
                        continue
                    # the drain above can grow a group past max_batch in
                    # one iteration — dispatch in max_batch chunks.  The
                    # guard is the daemon's second-to-last line: dispatch
                    # failures are already typed inside run_batch, so
                    # anything reaching here is a server bug — fail THIS
                    # group's futures and keep serving (the supervisor
                    # above is the last line, for the loop itself dying).
                    for i in range(0, len(group), self.max_batch):
                        chunk = group[i:i + self.max_batch]
                        try:
                            self._flush(chunk, quarantined=quarantined)
                        except Exception as e:
                            self._fail_group(chunk, e)
            if closing and not pending and self._arrivals.empty():
                return

    def _answer(self, req, fut, resp: dict, counter: str) -> None:
        """The ONE terminal door: count, mark replay provenance, journal,
        access-log, resolve the future.  Every path that answers an
        admitted request routes through here so the accounting invariant
        (received + replayed == answered) is structural, not situational."""
        if req.replayed:
            resp = dict(resp)
            resp["replayed"] = True
        with self._lock:
            self._depth -= 1
            if counter in ("served", "errors", "timeouts"):
                self._stats[counter] += 1
            else:
                by_kind = self._stats["rejected"]
                by_kind[counter] = by_kind.get(counter, 0) + 1
        # the conservation-critical counter rides OUTSIDE the best-effort
        # span synthesis: a span bug must never make check_telemetry's
        # received+replayed == answered+rejected balance report a false
        # serving violation
        telemetry.metrics.counter("blocksim_serve_answered_total",
                                  outcome=counter).inc()
        try:
            self._emit_request_spans(req, resp, counter)
        except Exception:
            pass  # telemetry must never block the answer
        try:
            # the logged copy carries the re-submittable request template
            # (non-default fields only) so --prewarm-from can replay the
            # observed group/bucket mix; the client response stays as-is
            log_rec = dict(resp)
            log_rec["scenario"] = schema.scenario_template(req.cfg,
                                                           req.seed)
            if req.trace_id:
                log_rec["trace"] = req.trace_id
            obs.record_run(log_rec, req.cfg)
        except Exception:
            pass  # the access log must never block the answer
        self._wal_done(req.req_id, resp.get("code"))
        fut._set(resp)

    def _emit_request_spans(self, req, resp: dict, counter: str) -> None:
        """Synthesize the request's span tree from its lifecycle stamps
        (utils/telemetry.py; README "Telemetry" documents the model).

        The segments tile [admit, answer] — serve.admit, serve.queue_wait
        (arrivals queue), serve.batch_wait (grouped, waiting for the
        flush), serve.dispatch (the executable; pad-bucket/mode attrs)
        and serve.answer — so a span tree accounts for the request's
        whole wall time by construction.  Built HERE, at answer time,
        because the segments straddle the submitter thread, the batcher
        and the dispatch; stamps a segment never reached (a 504 expiring
        pre-dispatch has no t_dispatch0) skip that segment."""
        t_ans = time.monotonic()
        tid = req.trace_id or telemetry.new_trace_id()
        t0 = req.t_admit or req.submitted or t_ans
        status = "ok" if resp.get("status") == "ok" else "error"
        root = telemetry.emit(
            "serve.request", t0, t_ans, trace=tid, parent=req.parent_span,
            span_id=req.root_span, status=status, id=req.req_id,
            outcome=counter, replayed=req.replayed or None,
            replica=self.replica,
        )
        # ONE segment table drives both the span emits and the latency
        # histograms (private /stats percentiles + the process-global
        # /metrics registry), so the two surfaces can never disagree
        # about a segment's boundaries: (span name, t0, t1, histogram
        # name or None, extra span attrs)
        batch = resp.get("batch") or {}
        segments = (
            ("serve.admit", req.t_admit, req.submitted, None, {}),
            ("serve.queue_wait", req.submitted, req.t_drained,
             "queue_wait", {}),
            ("serve.batch_wait", req.t_drained, req.t_flush,
             "batch_wait", {}),
            ("serve.dispatch", req.t_dispatch0, req.t_dispatch1,
             "dispatch",
             {"mode": batch.get("mode"), "size": batch.get("size"),
              "bucket": batch.get("padded"), "group": batch.get("group"),
              "mesh": batch.get("mesh")}),
            ("serve.answer", req.t_dispatch1, t_ans, None, {}),
            (None, req.submitted or t0, t_ans, "request", {}),
        )
        for name, a, b, hist, attrs in segments:
            if not (a and b and b >= a):
                continue
            if name is not None:
                telemetry.emit(name, a, b, trace=tid, parent=root,
                               id=req.req_id, **attrs)
            if hist is not None:
                ms = (b - a) * 1000.0
                self._hists[hist].observe(ms)
                telemetry.metrics.histogram(
                    f"blocksim_serve_{hist}_ms").observe(ms)

    def _reject_shutdown(self, group) -> None:
        """Flush still-unanswered requests as typed 503s with rejection
        manifests — the shutdown path of the no-silent-drop contract."""
        err = schema.ShuttingDownError(
            "server shut down before this request was dispatched"
        )
        for req, fut in group:
            if fut.done():
                continue
            self._answer(req, fut, err.to_response(req.req_id),
                         schema.ShuttingDownError.kind)

    def _fail_group(self, group, exc: Exception) -> None:
        """Answer every still-unanswered future of a group with a typed 500
        after an unexpected batcher error (never a wedged daemon)."""
        err = schema.ServeError(
            f"internal batcher error: {type(exc).__name__}: {exc}"
        )
        for req, fut in group:
            if fut.done():
                continue
            self._answer(req, fut, err.to_response(req.req_id), "errors")

    def _breaker(self, group_key: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(group_key)
            if br is None:
                br = self._breakers[group_key] = CircuitBreaker(
                    self.breaker_threshold, self.breaker_cooldown_s
                )
            return br

    def _flush(self, group, quarantined: bool = False) -> None:
        """Dispatch one due group: expire stale requests, consult the
        group's circuit breaker, run the rest as one batch
        (serve/dispatch.py), answer futures, access-log each."""
        now = time.monotonic()
        live = []
        for req, fut in group:
            if req.expired(now):
                err = schema.RequestTimeoutError(
                    f"timed out after {req.timeout_s:.3f}s in queue"
                )
                self._answer(req, fut, err.to_response(req.req_id),
                             "timeouts")
            else:
                req.t_flush = now
                live.append((req, fut))
        if not live:
            return
        reqs = [r for r, _ in live]
        group_key = obs.config_hash(reqs[0].canon)
        force_solo = False
        solo_reason = None
        breaker = None
        if quarantined:
            # force_solo matters even here: a quarantined id resubmitted
            # twice in one drain window groups with ITSELF, and a 2-deep
            # quarantine flush must still never take the batched path
            force_solo = True
            solo_reason = "quarantined-solo"
        elif len(reqs) >= 2:
            breaker = self._breaker(group_key)
            with self._lock:
                allow = breaker.allow_batched(now)
            if not allow:
                force_solo = True
                solo_reason = "breaker-solo"
        results = dispatch.run_batch(
            reqs, self.max_batch,
            force_solo=force_solo, solo_reason=solo_reason,
            journal=self._journal, device=self.device,
        )
        degraded = any(
            resp.get("batch", {}).get("degraded") for _, resp in results
        )
        if breaker is not None and not force_solo:
            with self._lock:
                breaker.record(degraded, time.monotonic())
        with self._lock:
            self._stats["batches"] += 1
            if degraded:
                self._stats["degraded_batches"] += 1
            b = len(live)
            self._occupancy[b] = self._occupancy.get(b, 0) + 1
            self._backoff = self.restart_backoff_s  # the loop is healthy
        # run_batch answers in submission order, one response per request
        for (req, fut), (_, resp) in zip(live, results):
            if resp.get("kind") == schema.DispatchFailedError.kind:
                # failed SOLO: poison.  Never into a batch again — future
                # submissions of this id flush as singleton groups, and
                # the WAL mark keeps the rule across restarts.
                with self._lock:
                    fresh = req.req_id not in self._quarantine
                    if fresh:
                        self._quarantine.add(req.req_id)
                        self._stats["quarantined"] += 1
                if fresh and self._wal is not None:
                    try:
                        self._wal.append_quarantine(req.req_id)
                    except OSError:
                        pass
            counter = "served" if resp.get("status") == "ok" else "errors"
            self._answer(req, fut, resp, counter)

    # --------------------------------------------------------------- queries
    def _spawn_query(self, req, fut) -> None:
        """Divert one admitted query request (schema ``"query"``) to its own
        worker thread: it is already past admission and WAL-durable, so the
        only fast-shutdown concern is a search not yet started (a typed 503
        here; a RUNNING search is joined by close())."""
        with self._lock:
            self._stats["queries"] += 1
            closing, drain = self._closing, self._drain
        if closing and not drain:
            err = schema.ShuttingDownError(
                "server shut down before this query was started")
            self._answer(req, fut, err.to_response(req.req_id),
                         schema.ShuttingDownError.kind)
            return
        t = threading.Thread(
            target=self._run_query_worker, args=(req, fut),
            name=f"query-{req.req_id}", daemon=True,
        )
        with self._lock:
            self._queries.append((req, fut, t))
        t.start()

    def _run_query_worker(self, req, fut) -> None:
        """One query request's whole lifetime on the server's device (the
        worker selects it first): pre-mint the request's root span so every
        ``query.step`` span the engine emits parents under the
        ``serve.request`` root the server synthesizes at answer time, run
        the deterministic search (journaled when the server has a sweep
        journal: a WAL replay after a crash then serves every completed
        generation from the journal), and answer through the one terminal
        door.  An injected ChaosKill escapes WITHOUT answering: the stand-in
        for the replica dying mid-search with the admission durable in the
        WAL."""
        from blockchain_simulator_tpu_torch.query import engine as query_engine

        if self.device.type == "cuda":
            import torch

            torch.cuda.set_device(self.device)
        now = time.monotonic()
        if req.expired(now):
            err = schema.RequestTimeoutError(
                f"timed out after {req.timeout_s:.3f}s in queue")
            self._answer(req, fut, err.to_response(req.req_id), "timeouts")
            return
        req.t_flush = req.t_dispatch0 = now
        req.root_span = telemetry.new_span_id()
        ctx = telemetry.TraceContext(
            req.trace_id or telemetry.new_trace_id(), req.root_span)
        req.trace_id = ctx.trace_id
        try:
            with telemetry.context(ctx):
                result = query_engine.run_query(
                    req.cfg, req.query, journal=self._journal, device=self.device)
        except inject.ChaosKill:
            return  # simulated replica death: unanswered, WAL-pending
        except Exception as e:
            req.t_dispatch1 = time.monotonic()
            err = schema.DispatchFailedError(
                f"query failed: {type(e).__name__}: {e}")
            self._answer(req, fut, err.to_response(req.req_id), "errors")
            return
        req.t_dispatch1 = time.monotonic()
        # the response carries the answer, the (small) step trail and the
        # run accounting; the per-point metrics rows stay in the journal
        resp = {
            "id": req.req_id, "status": "ok",
            "query": result["query"], "answer": result["answer"],
            "trail": result["trail"], "run": result["run"],
        }
        self._answer(req, fut, resp, "served")

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        """The /stats endpoint body: serving counters, batch-occupancy
        histogram, admission state, circuit-breaker states, WAL/replay
        provenance, knobs, and the executable-registry snapshot
        (utils/aotcache.stats_snapshot — the satellite contract)."""
        with self._lock:
            rec = {
                **{k: (dict(v) if isinstance(v, dict) else v)
                   for k, v in self._stats.items()},
                "queue_depth": self._depth,
                "occupancy": {str(k): v for k, v in
                              sorted(self._occupancy.items())},
                "paused": self.paused,
                "health": dict(self._health),
                "closing": self._closing,
                "quarantine_size": len(self._quarantine),
                # per-segment latency percentiles from the telemetry
                # histograms
                "latency_ms": {seg: h.percentiles()
                               for seg, h in self._hists.items()},
                "breakers": {k: br.snapshot()
                             for k, br in sorted(self._breakers.items())},
                "knobs": {
                    "max_batch": self.max_batch,
                    "max_wait_ms": self.max_wait_ms,
                    "max_queue": self.max_queue,
                    "default_timeout_s": self.default_timeout_s,
                    "breaker_threshold": self.breaker_threshold,
                    "breaker_cooldown_s": self.breaker_cooldown_s,
                    "journal": (self._journal.path
                                if self._journal is not None else None),
                },
                # the batched-dispatch mesh: single-device (None) until the
                # sweep axis of the port
                "mesh": None,
                "device": str(self.device),
            }
            if self.replica is not None:
                rec["replica"] = self.replica
            if self._wal is not None:
                rec["wal"] = {
                    "path": self._wal.path,
                    "sync": self._wal.sync,
                    "replayed_at_start": self._wal_replayed_at_start,
                    "claimed_by": self._wal_claimed_by,
                }
        rec["cache"] = aotcache.registry.stats_snapshot()
        return rec

    # -------------------------------------------------------------- prewarm
    def prewarm(self, obj: dict) -> dict:
        """Build every registry entry a request template's batch group can
        dispatch to — the solo entry plus each power-of-two bucket up to
        ``max_batch`` — so steady-state traffic is registry hits only, and
        load the ring kernel when the group runs ticks on the card.  Returns
        the per-bucket wall seconds (the daemon's ``--prewarm``)."""
        walls = {}
        sizes = [1]
        b = 2
        while b <= self.max_batch:
            sizes.append(b)
            b *= 2
        if sizes[-1] != self.max_batch:
            # non-power-of-two max_batch: bucket_size caps at max_batch,
            # so that capped bucket is dispatchable too and must be warm
            sizes.append(self.max_batch)
        for size in sizes:
            walls[str(size)] = self._prewarm_bucket(obj, size)
        return walls

    def _prewarm_bucket(self, obj: dict, size: int) -> float:
        """Build the entry serving ``size``-lane batches of this template's
        group (``"serve-solo"`` for one lane, ``"sweep-batched-dynf"`` for
        more) without running it; returns the wall seconds.  The JAX package
        runs each bucket once to compile it; the port's entries are closures
        over the step functions and compile nothing, so building them is the
        whole warm-up, and a group that runs ticks on the card (every
        protocol but PBFT's round path) loads the ring kernel here, before
        the batcher thread's first launch."""
        req = schema.parse_request(dict(obj), f"prewarm-{size}",
                                   default_timeout_s=self.default_timeout_s)
        t0 = time.monotonic()
        if req.probe is not None:  # an armed template warms the consobs-* entries
            from blockchain_simulator_tpu_torch.obsim import build as obsim_build

            if size == 1:
                obsim_build.probed_solo_fn(req.canon, req.probe)
            else:
                obsim_build.probed_batched_fn(req.canon, req.probe)
        elif size == 1:
            dispatch._solo_fn(req.canon)
        else:
            sweep.dyn_batched_fn(req.canon)
        if self.device.type == "cuda" and not (
                req.canon.protocol == "pbft" and runner.use_round_schedule(req.canon)):
            from blockchain_simulator_tpu_torch.ops import ring_kernel

            ring_kernel.load()
        return round(time.monotonic() - t0, 3)

    def prewarm_from(self, log_path: str, max_groups: int = 8) -> dict:
        """Prewarm from OBSERVED traffic instead of the fixed bucket
        ladder: read a prior access log (runs.jsonl — each served line
        carries its ``scenario`` template and its ``batch.padded`` bucket,
        serve/server._answer), and warm, for the ``max_groups`` most
        frequent batch groups, exactly the bucket sizes that group was
        actually dispatched at.  Returns ``{group_hash: {"requests": n,
        "template": {...}, "buckets": {size: wall_s}}}`` — the daemon's
        ``--prewarm-from`` (README "Fleet serving")."""
        groups: dict[str, dict] = {}
        for rec in obs.read_jsonl(log_path):
            tpl = rec.get("scenario")
            if rec.get("status") != "ok" or not isinstance(tpl, dict):
                continue
            batch = rec.get("batch") or {}
            group = batch.get("group")
            if not group:
                continue
            g = groups.setdefault(group, {"requests": 0, "template": tpl,
                                          "buckets": set()})
            g["requests"] += 1
            padded = batch.get("padded")
            if isinstance(padded, int) and padded >= 1:
                g["buckets"].add(min(padded, self.max_batch))
        ranked = sorted(groups.items(),
                        key=lambda kv: (-kv[1]["requests"], kv[0]))
        out: dict[str, dict] = {}
        for group, g in ranked[:max_groups]:
            tpl = {k: v for k, v in g["template"].items() if k != "seed"}
            walls = {}
            for size in sorted(g["buckets"] or {1}):
                walls[str(size)] = self._prewarm_bucket(dict(tpl), size)
            out[group] = {"requests": g["requests"], "template": tpl,
                          "buckets": walls}
        return out
